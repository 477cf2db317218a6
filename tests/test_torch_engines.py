'''
The PyTorch port's other engines and their helpers against the JAX
reference, on the CPU, on the same inputs (made from numpy seeds).

  * sampling.hash_uniform bit for bit (the MLT proposal streams, whose
    int32 counter product wraps in the reference); utils.mathutils
    .normaldist equal to the reference's polynomial on >= 98% of inputs,
    within 2 ulp on >= 99.8% and within 3 ulp on all (a 1-ulp difference
    of the two libraries' float32 log grows to 3 ulp, as between the
    reference's own eager and jitted forms), and exactly odd around 0.5;
  * film.film_splat and film_to_flat_rgb, and the three tone maps,
    within 1e-6;
  * engine.preview: the albedo and normal passes of render_preview at
    16x16 against the reference's, >= 98% of pixels within 1e-4 (the
    port casts with the dense-cast contract on the CPU, the reference
    with brute: a few rays may differ, tests/test_torch_render.py);
  * engine.brute: render_brute at 16x16 x 4 spp against the reference's
    at the same allowance, and the port's brute mean within 8% of its
    path mean at 8x8 x 128 spp (tests/test_engines.py);
  * intersect.dispatch: accel='dense' above MAX_DENSE_FACES takes the
    brute route at scene and at table level, against the reference's
    (the same route on the CPU): hits equal, t within 1e-5 relative.
'''

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ptina_tpu import scenes as jscenes
from ptina_tpu import tone as jtone
from ptina_tpu.engine.brute import render_brute as jrender_brute
from ptina_tpu.engine.preview import render_preview as jrender_preview
from ptina_tpu.film import (new_film as jnew_film, film_splat as jfilm_splat,
                            film_to_flat_rgb as jfilm_to_flat_rgb,
                            film_to_image as jto_image)
from ptina_tpu.intersect import dispatch as jdispatch
from ptina_tpu.sampling import hash_uniform as jhash_uniform
from ptina_tpu.utils.mathutils import normaldist as jnormaldist
from ptina_tpu.utils.vec import V3 as JV3
from ptina_tpu_torch import scenes as tscenes
from ptina_tpu_torch import tone
from ptina_tpu_torch.engine.brute import render_brute
from ptina_tpu_torch.engine.path import render
from ptina_tpu_torch.engine.preview import render_preview
from ptina_tpu_torch.film import (new_film, film_splat, film_to_flat_rgb,
                                  film_to_image, PASS_ALBEDO, PASS_NORMAL)
from ptina_tpu_torch.intersect import dense_cast, dispatch
from ptina_tpu_torch.intersect.dense_cast import MAX_DENSE_FACES
from ptina_tpu_torch.sampling import hash_uniform
from ptina_tpu_torch.scene import scene_from_numpy
from ptina_tpu_torch.utils.mathutils import normaldist
from ptina_tpu_torch.utils.vec import V3

from test_torch_scene import jax_scene_arrays

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


@pytest.mark.parametrize('step', [0, 1, 3, 7, 1000, 2 ** 20 + 5])
def test_hash_uniform_bit_for_bit(step):
    '''The MLT proposal block: hash_uniform(step * int32(-1640531527) +
    dim, chain), whose int32 product wraps in the reference.'''
    d, c = 34, 777
    dim = np.arange(d, dtype=np.int32)[:, None]
    chain = np.arange(c, dtype=np.int32)
    ref = np.asarray(jhash_uniform(
        jnp.int32(step) * jnp.int32(-1640531527) + jnp.asarray(dim),
        jnp.asarray(chain)))
    got = hash_uniform(torch.tensor(step, dtype=torch.int64) * -1640531527
                       + _t(dim).long(), _t(chain))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    # three arguments, negative and large int32 values
    rng = np.random.RandomState(step % 97)
    a, b, e = (rng.randint(-2 ** 31, 2 ** 31 - 1, 500).astype(np.int32)
               for _ in range(3))
    ref = np.asarray(jhash_uniform(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(e)))
    np.testing.assert_array_equal(hash_uniform(_t(a), _t(b), _t(e)).numpy(),
                                  ref)


def test_normaldist_matches_reference_and_is_odd():
    rng = np.random.RandomState(4)
    u = np.concatenate([
        rng.rand(20000).astype(np.float32),
        np.float32([0.0, 1e-9, 1e-7, 0.5, 0.5 - 1e-7, 1 - 1e-7, 0.9999999,
                    0.99, 0.993, 0.9966, 0.9968, 0.003, 1.0])])
    ref = np.asarray(jnormaldist(jnp.asarray(u)))
    got = normaldist(_t(u)).numpy()
    assert np.isfinite(got).all()
    ulps = np.abs(got - ref) / np.spacing(np.abs(ref).astype(np.float32))
    # torch's and XLA's float32 log differ by 1 ulp on ~18% of inputs, and
    # the polynomial's last steps can grow that to 3 ulp of the result:
    # the reference's own eager and jitted forms differ so (3 ulp on 440
    # of 200,000 inputs)
    assert (ulps == 0).mean() >= 0.98 and (ulps <= 2).mean() >= 0.998
    assert ulps.max() <= 3, ulps.max()
    # exactly odd: u and 1 - u are both exact at k / 2^20
    k = np.arange(0, 2 ** 20 + 1, 37, dtype=np.float64)
    lo = (k / 2 ** 20).astype(np.float32)
    hi = (1.0 - k / 2 ** 20).astype(np.float32)
    np.testing.assert_array_equal(normaldist(_t(lo)).numpy(),
                                  -normaldist(_t(hi)).numpy())


def test_film_splat_and_flat_export_match_reference():
    rng = np.random.RandomState(5)
    nx, ny, n = 7, 5, 400
    base = rng.rand(3, 4, nx, ny).astype(np.float32)
    base[0, 3, 0, 0] = 0.0  # an empty pixel
    xi = rng.randint(-2, nx + 2, n).astype(np.int32)  # some clipped
    yi = rng.randint(-2, ny + 2, n).astype(np.int32)
    r, g, b, w = rng.rand(4, n).astype(np.float32)
    ref = np.asarray(jfilm_splat(jnp.asarray(base), 1, jnp.asarray(xi),
                                 jnp.asarray(yi), *map(jnp.asarray,
                                                       (r, g, b, w))))
    film = _t(base.copy())
    out = film_splat(film, 1, _t(xi), _t(yi), _t(r), _t(g), _t(b), _t(w))
    assert out is film  # in place
    np.testing.assert_allclose(film.numpy(), ref, rtol=1e-6, atol=1e-6)
    assert np.array_equal(film.numpy()[[0, 2]], base[[0, 2]])
    for p in (0, 1):
        np.testing.assert_allclose(
            film_to_flat_rgb(_t(ref), p).numpy(),
            np.asarray(jfilm_to_flat_rgb(jnp.asarray(ref), p)),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('name, kw', [
    ('apply_exposure_gamma', {}), ('apply_exposure_gamma',
                                   dict(exposure=2.5, gamma=1.8)),
    ('tonemap_filmic', {}), ('tonemap_filmic', dict(exposure=0.5)),
    ('tonemap_aces', {}), ('tonemap_aces', dict(exposure=3.0))])
def test_tone_maps_match_reference(name, kw):
    rng = np.random.RandomState(6)
    rgb = (rng.randn(32, 24, 3) * 2.0 + 1.0).astype(np.float32)
    ref = np.asarray(getattr(jtone, name)(jnp.asarray(rgb), **kw))
    got = getattr(tone, name)(_t(rgb), **kw).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def _close_share(got, ref, atol):
    return (np.abs(got - ref) <= atol).all(-1).mean()


def test_preview_passes_match_reference():
    js = jscenes.cornell_box()
    ref = jrender_preview(js, jnew_film(16, 16), 0, spp=1)
    ts = scene_from_numpy(jax_scene_arrays(js), device='cpu')
    before = dict(dense_cast.LAUNCHES)
    film = render_preview(ts, new_film(16, 16, device='cpu'), 0, spp=1)
    assert dense_cast.LAUNCHES == before  # CPU: plain casts, no kernel
    assert not film[0].any()  # the combined pass is untouched
    for p in (PASS_ALBEDO, PASS_NORMAL):
        want = np.asarray(jto_image(ref, p))
        got = film_to_image(film, p).numpy()
        assert np.isfinite(got).all()
        assert _close_share(got, want, 1e-4) >= 0.98
    n = film_to_image(film, PASS_NORMAL)[8, 8, :3].numpy()
    assert 0.5 < np.linalg.norm(n) < 1.5


def test_brute_matches_reference():
    js = jscenes.cornell_box()
    ref = np.asarray(jto_image(jrender_brute(js, jnew_film(16, 16), 0,
                                             spp=4)))
    ts = scene_from_numpy(jax_scene_arrays(js), device='cpu')
    got = film_to_image(render_brute(ts, new_film(16, 16, device='cpu'), 0,
                                     spp=4)).numpy()
    assert np.isfinite(got).all() and (got[..., 3] == 1).all()
    assert _close_share(got, ref, 1e-4) >= 0.98


def test_brute_converges_toward_path():
    '''tests/test_engines.py's check on the port: brute and MIS image
    means within 8% at 8x8 x 128 spp.'''
    scene = tscenes.cornell_box(device='cpu')
    m1 = film_to_image(render(scene, new_film(8, 8, device='cpu'), 0,
                              spp=128))[..., :3].mean().item()
    m2 = film_to_image(render_brute(scene, new_film(8, 8, device='cpu'), 0,
                                    spp=128))[..., :3].mean().item()
    assert abs(m1 - m2) / max(m1, m2) < 0.08


def _camera_rays(res):
    '''Pixel-centre camera rays of a res^2 film as numpy [N, 3] pairs.'''
    from ptina_tpu_torch.camera import camera_rays
    from ptina_tpu_torch.engine.path import pixel_grid
    s = tscenes.cornell_box(device='cpu')
    ii, jj = pixel_grid(res, res, device='cpu')
    x = (ii.float() + 0.5) / res * 2.0 - 1.0
    y = (jj.float() + 0.5) / res * 2.0 - 1.0
    ro, rd = camera_rays(s.cam_v2w, x, y)
    return (torch.stack([ro.x, ro.y, ro.z], 1).numpy(),
            torch.stack([rd.x, rd.y, rd.z], 1).numpy())


def _v3s(a):
    return (JV3(*(jnp.asarray(a[:, k]) for k in range(3))),
            V3(*(_t(a[:, k]) for k in range(3))))


def _hold_hits(jh, th):
    assert np.array_equal(th.hit.numpy(), np.asarray(jh.hit))
    assert np.array_equal(th.index.numpy(), np.asarray(jh.index))
    m = np.asarray(jh.hit)
    np.testing.assert_allclose(th.t.numpy()[m], np.asarray(jh.t)[m],
                               rtol=1e-5)


def test_dense_above_limit_takes_brute_route():
    '''cornell_highpoly(nu=64, nv=65, accel='dense'): 8,238 faces, above
    MAX_DENSE_FACES, builds in face order and casts with brute in both
    packages, at scene level (cast_shaded, cast_shadow) and table level
    (cast_closest, cast_any), on 24^2 camera rays and their shadow
    rays.'''
    js = jscenes.cornell_highpoly(nu=64, nv=65, accel='dense')
    ts = scene_from_numpy(jax_scene_arrays(js), device='cpu')
    assert ts.tri_w2b.shape[0] > MAX_DENSE_FACES
    assert dispatch._route(ts) == 'brute' and ts.fused_coef.shape[0] == 0
    o, d = _camera_rays(24)
    (jro, tro), (jrd, trd) = _v3s(o), _v3s(d)
    n = o.shape[0]
    avoid = np.full(n, -1, np.int32)
    javoid, tavoid = jnp.asarray(avoid), _t(avoid)
    before = {**dense_cast.LAUNCHES}
    jhit, jn, js_, jt_, jm = jdispatch.cast_shaded(js, jro, jrd, javoid)
    thit, tn, ts_, tt_, tm = dispatch.cast_shaded(ts, tro, trd, tavoid)
    _hold_hits(jhit, thit)
    assert thit.hit.float().mean() > 0.9
    m = np.asarray(jhit.hit)
    for a, b in ((jn.x, tn.x), (jn.y, tn.y), (jn.z, tn.z), (js_, ts_),
                 (jt_, tt_)):
        np.testing.assert_allclose(b.numpy()[m], np.asarray(a)[m],
                                   atol=1e-5)
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    # shadow rays from the hits towards a point under the ceiling light
    hp = o + d * np.where(m, thit.t.numpy(), 0.0)[:, None]
    sd = np.float32([0.0, 3.8, 0.0]) - hp
    tmax = np.linalg.norm(sd, axis=1).astype(np.float32)
    sd = (sd / tmax[:, None]).astype(np.float32)
    (jso, tso), (jsd, tsd) = _v3s(hp.astype(np.float32)), _v3s(sd)
    idx = thit.index.numpy()
    jocc = np.asarray(jdispatch.cast_shadow(js, jso, jsd, jnp.asarray(idx),
                                            jnp.asarray(tmax)))
    tocc = dispatch.cast_shadow(ts, tso, tsd, _t(idx), _t(tmax)).numpy()
    assert (tocc == jocc).mean() >= 0.999 and 0 < tocc.mean() < 1
    # table level: a bare face table above MAX_DENSE_FACES
    w2b = np.asarray(js.tri_w2b)
    _hold_hits(jdispatch.cast_closest(jro, jrd, jnp.asarray(w2b), javoid),
               dispatch.cast_closest(tro, trd, _t(w2b), tavoid))
    tocc = dispatch.cast_any(tso, tsd, _t(w2b), _t(idx), _t(tmax)).numpy()
    assert (tocc == jocc).mean() >= 0.999
    assert dense_cast.LAUNCHES == before
