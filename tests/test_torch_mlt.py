'''
The PyTorch port's Metropolis light transport (ptina_tpu_torch.engine.mlt)
against the JAX reference, on the CPU.

One step from the reference's own initial chains (jax.random, passed into
the port), and one from the chains the reference has after a step: the
proposals within 1e-6 on every chain (the counter-hashed streams are bit
for bit, normaldist within 3 ulp), the replayed radiance within
1e-3 * (1 + |ref|) on >= 98% of chains and the accept masks equal on
>= 98% (on the CPU the port casts with the dense-cast contract, the
reference with brute, so a few chains' paths differ;
tests/test_torch_render.py), the large-step count exactly.

Kelemen's estimator on the port (tests/test_mlt_quant.py's check, cut to
a 16x16 film, 1,024 chains x 300 steps and a 64 spp path render for the
CPU): brightness within 5% of the path render, and better than
mode='reference' on brightness and on 4x4-patch error.
'''

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ptina_tpu import scenes as jscenes
from ptina_tpu.engine import mlt as jmlt
from ptina_tpu.film import new_film as jnew_film
from ptina_tpu.sampling import hash_uniform as jhash_uniform
from ptina_tpu.utils.mathutils import normaldist as jnormaldist
from ptina_tpu_torch import scenes as tscenes
from ptina_tpu_torch.engine import mlt
from ptina_tpu_torch.engine.mlt import (MLTState, mlt_init, mlt_step,
                                        render_mlt, LSP, SIGMA)
from ptina_tpu_torch.engine.path import render, PATH_DIMS
from ptina_tpu_torch.film import new_film, film_to_image
from ptina_tpu_torch.intersect import dense_cast
from ptina_tpu_torch.engine import fused
from ptina_tpu_torch.scene import scene_from_numpy
from ptina_tpu_torch.utils.vec import V3

from test_torch_scene import jax_scene_arrays

torch.set_num_threads(2)

CHAINS = 1024
RES = 16


def _h(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _port_state(js):
    '''The reference's MLTState -> the port's (numpy in between).'''
    return MLTState(x=_h(js.x), l=V3(_h(js.l.x), _h(js.l.y), _h(js.l.z)),
                    b_sum=_h(js.b_sum), b_cnt=_h(js.b_cnt), step=_h(js.step))


def _ref_proposal(js):
    '''The reference's proposal block (ptina_tpu/engine/mlt.py:97-110)
    from its own functions.'''
    d, c = js.x.shape
    chain = jnp.arange(c, dtype=jnp.int32)
    dim = jnp.arange(d + 2, dtype=jnp.int32)[:, None]
    u = jhash_uniform(js.step * jnp.int32(-1640531527) + dim, chain)
    large = u[d] < LSP
    mutated = jnp.mod(js.x + SIGMA * jnormaldist(u[:d]), 1.0)
    return np.asarray(jnp.where(large[None, :], u[:d], mutated))


def _l(state):
    '''A state's cached radiance (or a radiance V3 of either package) as
    numpy [3, C].'''
    v = getattr(state, 'l', state)
    return np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)])


def _close_chains(got, ref):
    return (np.abs(got - ref) <= 1e-3 * (1.0 + np.abs(ref))).all(0).mean()


@pytest.fixture(scope='module')
def chains():
    '''The reference's chains at step 0 and after one and two steps, with
    its scene and films, and the port's copy of that scene.'''
    js = jscenes.cornell_box()
    ts = scene_from_numpy(jax_scene_arrays(js), device='cpu')
    j0 = jmlt.mlt_init(jax.random.key(3), nchains=CHAINS)
    t0 = _port_state(j0)
    j1, jf1 = jmlt.render_mlt(js, j0, jnew_film(RES, RES), steps=1)
    t1, f1 = _port_state(j1), _h(jf1)
    prop1 = _ref_proposal(j1)
    l_prop1 = _l(jmlt._replay(js, jnp.asarray(prop1)))
    j2, jf2 = jmlt.render_mlt(js, j1, jf1, steps=1)
    return dict(js=js, ts=ts, t0=t0, t1=t1, f1=f1, prop1=prop1,
                l_prop1=l_prop1, j1_l=_l(t1), j2=_port_state(j2),
                f2=np.array(jf2))


def test_mlt_step_from_reference_initial_state(chains):
    '''From the initial chains every proposal is taken (no radiance yet),
    so the state after one step holds the proposals and their radiance.'''
    t0, t1 = chains['t0'], chains['t1']
    before = {**dense_cast.LAUNCHES, **fused.LAUNCHES}
    got, film = mlt_step(chains['ts'], t0, new_film(RES, RES, device='cpu'))
    assert {**dense_cast.LAUNCHES, **fused.LAUNCHES} == before  # CPU
    assert np.abs(got.x.numpy() - t1.x.numpy()).max() <= 1e-6
    assert _close_chains(_l(got), chains['j1_l']) >= 0.98
    assert int(got.step) == 1 and int(got.b_cnt) == int(t1.b_cnt)
    assert abs(got.b_sum.item() - t1.b_sum.item()) <= 0.02 * t1.b_sum.item()
    assert torch.isfinite(film).all()
    np.testing.assert_allclose(film[0, 3].sum().item(),
                               chains['f1'][0, 3].sum().item(), rtol=0.02)


def test_mlt_step_matches_reference(chains):
    '''From the reference's chains after a step: proposals, replay and
    the accept decision of the next step.'''
    ts, t1 = chains['ts'], chains['t1']
    x_new, large, _ = mlt._propose(t1, LSP, SIGMA)
    assert np.abs(x_new.numpy() - chains['prop1']).max() <= 1e-6
    assert 0 < large.float().mean() < 1
    l_new = mlt._replay(ts, x_new)
    l_new = torch.stack([l_new.x, l_new.y, l_new.z]).numpy()
    assert _close_chains(l_new, chains['l_prop1']) >= 0.98

    film = chains['f1'].clone()
    got, film = mlt_step(ts, t1, film)
    ref = chains['j2']
    take = (got.x != t1.x).any(0).numpy()
    ref_take = (ref.x != t1.x).any(0).numpy()
    assert 0.05 < ref_take.mean() < 0.95
    assert (take == ref_take).mean() >= 0.98
    assert _close_chains(_l(got), _l(ref)) >= 0.98
    assert int(got.b_cnt) == int(ref.b_cnt)
    np.testing.assert_allclose(film.numpy()[0, 3], chains['f2'][0, 3],
                               rtol=0.02)


def test_mlt_init_and_modes():
    g = torch.Generator().manual_seed(11)
    s = mlt_init(nchains=300, generator=g, device='cpu')
    assert s.x.shape == (PATH_DIMS, 300) and s.step.dtype == torch.int32
    assert 0.0 <= s.x.min() and s.x.max() < 1.0
    again = mlt_init(nchains=300, generator=torch.Generator().manual_seed(11),
                     device='cpu')
    assert torch.equal(s.x, again.x)
    scene = tscenes.cornell_box(device='cpu')
    films = []
    for _ in range(2):  # deterministic, splats included
        st, f = render_mlt(scene, mlt_init(1024, generator=torch.Generator()
                                           .manual_seed(2), device='cpu'),
                           new_film(8, 8, device='cpu'), steps=2,
                           mode='reference')
        films.append(f)
    assert torch.equal(*films) and int(st.step) == 2
    # reference mode: one unit-weight splat a chain a step
    assert films[0][0, 3].sum().item() == 2 * 1024
    with pytest.raises(ValueError, match='mode'):
        mlt_step(scene, st, films[0], mode='other')


def _blur(img, k=4):
    h, w, c = img.shape
    return img.reshape(h // k, k, w // k, k, c).mean(axis=(1, 3))


def test_mlt_kelemen_matches_path_brightness():
    scene = tscenes.cornell_box(device='cpu')
    truth = film_to_image(render(scene, new_film(RES, RES, device='cpu'), 0,
                                 spp=64))[..., :3].numpy()
    imgs = {}
    for mode in ('kelemen', 'reference'):
        state = mlt_init(1024, generator=torch.Generator().manual_seed(7),
                         device='cpu')
        _, film = render_mlt(scene, state, new_film(RES, RES, device='cpu'),
                             steps=300, mode=mode)
        imgs[mode] = film_to_image(film)[..., :3].numpy()
    b = {k: abs(v.mean() - truth.mean()) / truth.mean()
         for k, v in imgs.items()}
    assert b['kelemen'] < 0.05, b
    assert b['kelemen'] < b['reference'], b
    tb = _blur(truth)
    e = {k: (np.abs(_blur(v) - tb) / (tb + 0.05)).mean()
         for k, v in imgs.items()}
    assert e['kelemen'] < 0.35, e
    assert e['kelemen'] < e['reference'], e
