'''
The port's gradients (ptina_tpu_torch.diff, engine/fused.fused_trace_diff,
the detached casts of engine/path.py) held to the reference's own
gradient tests (tests/test_grad.py) and to JAX's gradients.

Each of tests/test_grad.py's seven tests has a counterpart here on the
same 8x8 films: autograd against a central finite difference at the
reference's 5%, and, on the same scene carried from the JAX package
(test_torch_scene.jax_scene_arrays), against jax.grad of the same loss:
loss within 1%, gradients allclose(rtol=0.05, atol=1e-4 * max|g_jax|) on
every entry (readings on the CPU: material and light-color gradients
agree on every entry, the largest difference 2e-5 of a largest entry
0.06).  The port casts with the key-grid contract where JAX's CPU route
casts with brute (tests/test_torch_render.py); no case here needs the
98% allowance that difference can call for.

On the CPU the pair (fused_trace_diff) runs the megakernel's twin, which
is path_trace: its gradients equal the wavefront's bit for bit.  JAX's
values are computed once a module (a JAX gradient compiles for ~12 s
here): one jax.grad of the reference's _loss in the material factors and
the light colors together, one texture_grad, one world_fac gradient.

The clamp helpers: at a bound the gradient is JAX's (1/2), and every
site's forward value is unchanged.
'''

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptina_tpu import scenes as jscenes
from ptina_tpu import diff as jdiff
from ptina_tpu.film import new_film as jnew_film, film_to_image as jto_image
from ptina_tpu.engine.path import (render_sample as jrender_sample,
                                   power_heuristic as jpower_heuristic)
from ptina_tpu.scene import make_scene as jmake_scene
from ptina_tpu.utils import mathutils as jmath
from ptina_tpu.utils import vec as jvec
from ptina_tpu.materials import choice_split as jchoice_split
from ptina_tpu.materials.microfacet import schlick_fresnel as jschlick
from ptina_tpu.materials.disney import disney_derive as jdisney_derive

from ptina_tpu_torch import diff
from ptina_tpu_torch.engine import path as tpath
from ptina_tpu_torch.engine.fused import (fused_trace_diff, FusedTraceDiff,
                                          fused_trace_uniforms)
from ptina_tpu_torch.engine.path import (render_sample, path_trace,
                                         power_heuristic, pixel_grid,
                                         PATH_DIMS)
from ptina_tpu_torch.camera import camera_rays
from ptina_tpu_torch.film import new_film, film_to_image
from ptina_tpu_torch.materials import choice_split
from ptina_tpu_torch.materials.microfacet import schlick_fresnel
from ptina_tpu_torch.materials.disney import disney_derive
from ptina_tpu_torch.sampling.sobol import sample_dims
from ptina_tpu_torch.scene import scene_from_numpy, with_tensor
from ptina_tpu_torch.utils import mathutils
from ptina_tpu_torch.utils.vec import V3, vdot_or_zero, vnormalize

from test_torch_scene import jax_scene_arrays

torch.set_num_threads(2)

RES = 8


def _carry(js):
    return scene_from_numpy(jax_scene_arrays(js), device='cpu')


def _get(scene, path):
    for name in path:
        scene = getattr(scene, name)
    return scene


def _loss(scene):
    '''tests/test_grad.py's _loss: the mean of one 8x8 sample's image.'''
    img = film_to_image(render_sample(scene, new_film(RES, RES, device='cpu'),
                                      0))[..., :3]
    return img.mean()


def _grad(scene, path, loss=_loss):
    '''(loss, d loss / d the scene tensor at path) through autograd.'''
    leaf = _get(scene, path).detach().clone().requires_grad_(True)
    val = loss(with_tensor(scene, path, leaf))
    g, = torch.autograd.grad(val, leaf)
    return val.item(), g.numpy()


def _fd(scene, path, idx, eps, loss=_loss):
    '''Central difference of loss in one entry of the tensor at path.'''
    base = _get(scene, path)
    with torch.no_grad():
        vals = []
        for e in (eps, -eps):
            t = base.clone()
            t[idx] += e
            vals.append(float(loss(with_tensor(scene, path, t))))
    return (vals[0] - vals[1]) / (2 * eps)


def _hold_to_jax(loss, g, jloss, gj):
    '''Loss within 1%; every entry allclose(rtol=0.05, atol=1e-4 max|gj|).'''
    assert abs(loss - jloss) <= 0.01 * abs(jloss), (loss, jloss)
    assert g.shape == gj.shape
    atol = 1e-4 * max(np.abs(gj).max(), 1e-6)
    close = np.isclose(g, gj, rtol=0.05, atol=atol)
    assert close.all(), (close.mean(), np.abs(g - gj).max(), atol)


@pytest.fixture(scope='module')
def cornell():
    '''cornell_box in both packages, and JAX's value and gradients of
    tests/test_grad.py's _loss in the material factors and light colors.'''
    js = jscenes.cornell_box()
    film = jnew_film(RES, RES)

    def loss(fac, color):
        sc = js.replace(materials=js.materials.replace(fac=fac),
                        lights=js.lights.replace(color=color))
        return jnp.mean(jto_image(jrender_sample(sc, film, 0))[..., :3])
    val, (gf, gc) = jax.value_and_grad(loss, argnums=(0, 1))(
        js.materials.fac, js.lights.color)
    return _carry(js), float(val), np.asarray(gf), np.asarray(gc)


@pytest.fixture(scope='module')
def matball():
    '''matball with tests/test_grad.py's 8x8 roughness texture in both
    packages, and JAX's texture_grad against a black target.'''
    js = jscenes.matball(roughness_tex=np.full((8, 8, 3), 0.5, np.float32))
    target = np.zeros((RES, RES, 3), np.float32)
    loss, g = jdiff.texture_grad(js, jnp.asarray(target))
    return _carry(js), target, float(loss), np.asarray(g)


def test_material_gradients_match_finite_difference(cornell):
    '''The white wall's basecolor red (row 0, param 0, channel 0).'''
    scene, jloss, gj, _ = cornell
    loss, g = _grad(scene, ('materials', 'fac'))
    assert np.isfinite(g).all()
    idx = (0, 0, 0)
    fd = _fd(scene, ('materials', 'fac'), idx, 1e-2)
    assert fd > 0
    assert abs(g[idx] - fd) < 0.05 * max(abs(fd), 1e-3), (g[idx], fd)
    _hold_to_jax(loss, g, jloss, gj)


def test_texture_gradients_match_finite_difference(matball):
    scene, target, jloss, gj = matball
    loss, g = diff.texture_grad(scene, target)
    g = g.numpy()
    assert np.isfinite(g).all() and float(loss) > 0
    xi, yi = np.unravel_index(np.abs(g[0, :, :, 0]).argmax(),
                              g[0, :, :, 0].shape)

    def tex_loss(sc):
        return diff.image_loss(sc, target)
    fd = _fd(scene, ('textures', 'data'), (0, xi, yi, 0), 1e-2, tex_loss)
    assert abs(g[0, xi, yi, 0] - fd) < 0.05 * max(abs(fd), 1e-4), \
        (g[0, xi, yi, 0], fd)
    _hold_to_jax(float(loss), g, jloss, gj)


def test_texture_gradient_localization(matball):
    '''Only channel 0 (the one the scalar fetch reads) carries gradient,
    and only on the texels the camera sees, as in JAX.'''
    scene, target, _, gj = matball
    _, g = diff.texture_grad(scene, target)
    g = g.numpy()
    assert np.abs(g[0, :, :, 1:]).sum() == 0
    ch0 = np.abs(g[0, :, :, 0])
    assert ch0.sum() > 0
    frac = (ch0 > 1e-3 * ch0.max()).mean()
    jch0 = np.abs(gj[0, :, :, 0])
    assert 0.02 < frac < 0.75, frac
    assert abs(frac - (jch0 > 1e-3 * jch0.max()).mean()) <= 1 / 64


def _plane_verts():
    verts = np.zeros((6, 8), np.float32)
    verts[:, 0:3] = [[-3, 0, 3], [3, 0, 3], [3, 0, -3],
                     [-3, 0, 3], [3, 0, -3], [-3, 0, -3]]
    verts[:, 4] = 1.0
    return verts


def test_world_fac_gradient_matches_fd():
    '''An open scene where most paths escape to the world color.'''
    js = jmake_scene(_plane_verts())
    film = jnew_film(RES, RES)

    def jloss(wf):
        sc = js.replace(world_fac=wf)
        return jnp.mean(jto_image(jrender_sample(sc, film, 0))[..., :3])
    jval, gj = jax.value_and_grad(jloss)(js.world_fac)
    scene = _carry(js)
    loss, g = _grad(scene, ('world_fac',))
    assert np.isfinite(g).all() and abs(g[0]) > 0
    fd = _fd(scene, ('world_fac',), 0, 1e-2)
    assert abs(g[0] - fd) < 0.05 * max(abs(fd), 1e-4), (g[0], fd)
    _hold_to_jax(loss, g, float(jval), np.asarray(gj))


def test_light_color_gradient_matches_fd(cornell):
    '''Both the direct-hit MIS term and NEE read the light color.'''
    scene, jloss, _, gj = cornell
    loss, g = _grad(scene, ('lights', 'color'))
    assert np.isfinite(g).all() and abs(g[0, 0]) > 0
    fd = _fd(scene, ('lights', 'color'), (0, 0), 1e-1)
    assert abs(g[0, 0] - fd) < 0.05 * max(abs(fd), 1e-5), (g[0, 0], fd)
    _hold_to_jax(loss, g, jloss, gj)


def test_fused_vjp_grads_match_wavefront(cornell):
    '''The pair (megakernel forward: on the CPU its twin; path_trace
    recompute backward) against autograd through the wavefront: the same
    loss and gradients bit for bit on the CPU.'''
    scene = cornell[0]
    target = np.random.RandomState(0).uniform(0, 1, (RES, RES, 3)) \
        .astype(np.float32)
    fac = ('materials', 'fac')
    lw, gw = diff._loss_and_grad(scene, target, fac, trace_diff=False)
    lf, gf = diff._loss_and_grad(scene, target, fac,
                                 trace_diff=fused_trace_diff)
    assert torch.isfinite(gf).all() and gw.abs().max() > 0
    assert float(lf) == float(lw) and torch.equal(gf, gw)


def test_pair_pulls_rays_and_not_uniforms(cornell):
    '''fused_trace_diff's backward reaches ro and rd (as path_trace's
    autograd does, bit for bit on the CPU) and leaves the uniforms
    without a gradient.'''
    scene = cornell[0]
    ii, jj = pixel_grid(RES, RES, device='cpu')
    u = sample_dims(0, ii, jj, PATH_DIMS)
    x = (ii.float() + u[0]) / RES * 2.0 - 1.0
    y = (jj.float() + u[1]) / RES * 2.0 - 1.0
    ro, rd = camera_rays(scene.cam_v2w, x, y)
    grads = []
    for trace in (fused_trace_diff, path_trace):
        rows = [r.detach().clone().requires_grad_(True)
                for r in (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z)]
        uu = u.clone().requires_grad_(True)
        rad = trace(scene, V3(*rows[:3]), V3(*rows[3:]), uu)
        (rad.x.sum() + 2.0 * rad.y.sum() + 3.0 * rad.z.sum()).backward()
        grads.append([r.grad for r in rows])
        if trace is fused_trace_diff:
            assert uu.grad is None
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert any(g.abs().max() > 0 for g in grads[0])
    assert issubclass(FusedTraceDiff, torch.autograd.Function)


@pytest.mark.parametrize('path', [('materials', 'fac'), ('lights', 'color'),
                                  ('face_coef',), ('textures', 'data')],
                         ids=lambda p: '.'.join(p))
def test_pair_backward_refuses_a_scene_changed_in_place(cornell, path):
    '''The pair's backward recomputes path_trace on the scene the forward
    rendered: a scene tensor modified in place between the two raises,
    the differentiated leaf (saved for backward) and every other tensor
    (its version counter) alike.'''
    scene = cornell[0]
    fac = scene.materials.fac.detach().clone().requires_grad_(True)
    sc = with_tensor(scene, ('materials', 'fac'), fac)
    if path != ('materials', 'fac'):
        sc = with_tensor(sc, path, _get(scene, path).clone())
    ii, jj = pixel_grid(RES, RES, device='cpu')
    u = sample_dims(0, ii, jj, PATH_DIMS)
    ro, rd = camera_rays(sc.cam_v2w, (ii.float() + u[0]) / RES * 2 - 1,
                         (jj.float() + u[1]) / RES * 2 - 1)
    rad = fused_trace_diff(sc, ro, rd, u)
    with torch.no_grad():
        _get(sc, path).mul_(2.0)
    with pytest.raises(RuntimeError, match='modified by an inplace'):
        torch.autograd.grad(rad.x.sum() + rad.y.sum() + rad.z.sum(), fac)


def test_gradient_nonzero_only_for_used_params(cornell):
    scene, _, gj, _ = cornell
    _, g = _grad(scene, ('materials', 'fac'))
    # basecolor of the white material participates
    assert np.abs(g[0, 0, :3]).sum() > 0
    # channel 3 (alpha) of basecolor is unused by shading, as in JAX
    assert np.abs(g[:, 0, 3]).sum() == 0 and np.abs(gj[:, 0, 3]).sum() == 0


@pytest.mark.parametrize('trace', [False, fused_trace_diff],
                         ids=['wavefront', 'pair'])
def test_two_samples_through_the_in_place_film(cornell, trace):
    '''spp=2 accumulates twice into the same film in place (two CopySlices
    nodes): the gradient of the 2-sample mean image is the mean of the
    two samples' gradients.'''
    scene = cornell[0]

    def grad(sample_index, spp):
        fac = scene.materials.fac.detach().clone().requires_grad_(True)
        sc = with_tensor(scene, ('materials', 'fac'), fac)
        img = diff.render_image_diff(sc, RES, RES, sample_index, spp,
                                     _trace_diff=trace)
        return torch.autograd.grad(img.mean(), fac)[0]
    g2 = grad(0, 2)
    want = (grad(0, 1) + grad(1, 1)) * 0.5
    assert torch.allclose(g2, want, rtol=1e-5, atol=1e-7 * want.abs().max())
    assert g2.abs().max() > 0


def test_hits_are_detached_on_the_cpu(cornell, monkeypatch):
    '''With rd requiring grad, the plain casts' t, barycentrics, normal
    and texcoord carry no graph; the hit point ro + rd t does.'''
    scene = cornell[0]
    seen = {}
    fetch = tpath.fetch_material

    def spy(sc, mtlid, tex_s, tex_t):
        seen['uv'] = (tex_s, tex_t)
        return fetch(sc, mtlid, tex_s, tex_t)
    monkeypatch.setattr(tpath, 'fetch_material', spy)
    ii, jj = pixel_grid(RES, RES, device='cpu')
    ro, rd = camera_rays(scene.cam_v2w, (ii.float() + 0.5) / RES * 2 - 1,
                         (jj.float() + 0.5) / RES * 2 - 1)
    rd = V3(*(r.detach().requires_grad_(True) for r in (rd.x, rd.y, rd.z)))
    avoid = torch.full((RES * RES,), -1, dtype=torch.int32)
    hit, hitpos, normal, _, _ = tpath._cast_and_shade(scene, ro, rd, avoid)
    assert bool(hit.hit.any())
    for t in (hit.t, hit.u, hit.v, normal.x, normal.y, normal.z,
              *seen['uv']):
        assert t.grad_fn is None and not t.requires_grad
    assert hitpos.x.grad_fn is not None


# ------------------------------------------------------------ clamp ties

def _v3(t):
    return V3(t[0], t[1], t[2])


def _jv3(a):
    return jvec.V3(a[0], a[1], a[2])


def _xy(n):
    return n.x + n.y


# name -> (port function of one float32 tensor, JAX function of one
# array, the inputs: at least one on the bound)
TIES = {
    'clamp_lo_hi': (lambda x: mathutils.clamp(x, 0.0, 1.0),
                    lambda x: jmath.clamp(x, 0.0, 1.0), [0.0, 1.0, 0.5, 2.0]),
    'clamp_min': (lambda x: mathutils.clamp_min(x, 1e-3),
                  lambda x: jnp.maximum(x, 1e-3), [1e-3, 0.0, 0.5]),
    'vdot_or_zero': (lambda x: vdot_or_zero(_v3(x[:3]), _v3(x[3:])),
                     lambda x: jvec.vdot_or_zero(_jv3(x[:3]), _jv3(x[3:])),
                     [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]),
    'vnormalize': (lambda x: _xy(vnormalize(_v3(x), 5.0)),
                   lambda x: _xy(jvec.vnormalize(_jv3(x), 5.0)),
                   [3.0, 4.0, 0.0]),
    'schlick_fresnel': (schlick_fresnel, jschlick, [0.0, 1.0, 0.5, -0.5]),
    'power_heuristic': (lambda x: power_heuristic(x, x * 2.0),
                        lambda x: jpower_heuristic(x, x * 2.0),
                        [1e-6, 1e6, 0.25]),
    'choice_split': (lambda x: choice_split(x * 0.5, x)[1],
                     lambda x: jchoice_split(x * 0.5, x)[1],
                     [1e-12, 0.25, 1.0]),
}


@pytest.mark.parametrize('name', sorted(TIES))
def test_clamp_gradient_at_the_bound_is_jax(name):
    '''d/dx of the sum of each output at inputs on a clamp bound: the
    port's helper against jax.grad of the reference's, to float32
    rounding (a torch.clamp there gives twice JAX's gradient: a term off
    by half); the values are torch.clamp's.'''
    port, ref, xs = TIES[name]
    x = np.asarray(xs, np.float32)
    t = torch.tensor(x, requires_grad=True)
    out = port(t)
    out.sum().backward()
    gj = np.asarray(jax.grad(lambda a: jnp.sum(ref(a)))(jnp.asarray(x)))
    np.testing.assert_allclose(t.grad.numpy(), gj, rtol=1e-5,
                               atol=1e-7 * np.abs(gj).max())
    with torch.no_grad():
        np.testing.assert_array_equal(port(torch.tensor(x)).numpy(),
                                      out.detach().numpy())


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64],
                         ids=['f32', 'f64'])
@pytest.mark.parametrize('lo,hi', [(0.0, 1.0), (mathutils.EPS, mathutils.INF),
                                   (1e-3, None), (0.0, None)],
                         ids=['unit', 'eps_inf', 'min_1e-3', 'min_0'])
def test_clamp_values_are_torch_clamps(lo, hi, dtype):
    '''clamp / clamp_min give torch.clamp's values (NaN where it gives
    NaN) in the input's dtype, on a sweep through both bounds, the
    infinities and signed zeros.'''
    x = torch.from_numpy(np.random.RandomState(1).standard_normal(4096)
                         * np.logspace(-8, 7, 4096)).to(dtype)
    x = torch.cat([x, torch.tensor([lo, -lo, 0.0, -0.0, 1.0, 1e6, np.nan,
                                    np.inf, -np.inf], dtype=dtype)])
    got = mathutils.clamp(x, lo, hi) if hi is not None \
        else mathutils.clamp_min(x, lo)
    assert got.dtype == dtype
    torch.testing.assert_close(got, torch.clamp(x, lo, hi), rtol=0, atol=0,
                               equal_nan=True)


def test_disney_alpha_has_no_float32_tie():
    '''alpha = max(0.001, roughness^2): no float32 roughness squares to
    float32(0.001) exactly, so the tie is out of reach; on either side the
    gradient is JAX's.'''
    r0 = np.float32(np.sqrt(0.001)).view(np.int32)
    near = (r0 + np.arange(-64, 65, dtype=np.int32)).view(np.float32)
    assert not (near * near == np.float32(0.001)).any()
    r = np.concatenate([near[::16], np.float32([0.0, 0.5])])
    n = r.shape[0]

    def params(rough, zero):
        p = {k: zero for k in ('metallic', 'specular', 'specularTint',
                               'subsurface', 'sheen', 'sheenTint',
                               'clearcoat', 'clearcoatGloss', 'transmission',
                               'ior')}
        p['roughness'] = rough
        return p
    t = torch.tensor(r, requires_grad=True)
    z = torch.zeros(n)
    p = params(t, z)
    p['basecolor'] = V3(z + 0.5, z + 0.5, z + 0.5)
    disney_derive(p)['alpha'].sum().backward()

    def jalpha(rough):
        zj = jnp.zeros(n)
        pj = params(rough, zj)
        pj['basecolor'] = jvec.V3(zj + 0.5, zj + 0.5, zj + 0.5)
        return jnp.sum(jdisney_derive(pj)['alpha'])
    np.testing.assert_array_equal(
        t.grad.numpy(), np.asarray(jax.grad(jalpha)(jnp.asarray(r))))


def test_pair_forward_is_the_uniforms_head(cornell):
    '''fused_trace_diff's value is fused_trace_uniforms' (on the CPU the
    twin) on the same rays and block.'''
    scene = cornell[0]
    ii, jj = pixel_grid(RES, RES, device='cpu')
    u = sample_dims(3, ii, jj, PATH_DIMS)
    ro, rd = camera_rays(scene.cam_v2w, ii.float() / RES * 2 - 1,
                         jj.float() / RES * 2 - 1)
    a, b = fused_trace_diff(scene, ro, rd, u), \
        fused_trace_uniforms(scene, ro, rd, u)
    assert all(torch.equal(p, q) for p, q in ((a.x, b.x), (a.y, b.y),
                                              (a.z, b.z)))
