'''
Parity of the PyTorch port's shading with the JAX reference on shared
inputs (1,024 lanes, made with numpy from a seed): Disney derive / eval /
sample, the Lambert / Mirror / Phong models, the material fetch (with a texture), lights_hit / lights_sample /
world_at (constant and equirect) and camera_rays.

Tolerance: rtol 1e-5 with atol 1e-6.  The atol covers values that cancel
to near zero (cos/sin of the sampled directions, differences of unit
vectors).  The two packages' sqrt, sin, cos and pow differ by an ulp on a
few percent of lanes (XLA's CPU sqrt included), and the sampling
formulas can amplify that: disney_sample therefore holds rtol 1e-5 on all
but 2 of the 1,024 lanes and rtol 1e-4 on every lane.
'''

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ptina_tpu import scenes as jscenes
from ptina_tpu.utils.vec import V3 as JV3
from ptina_tpu.materials import disney as jdisney
from ptina_tpu.materials import simple as jsimple
from ptina_tpu import lights as jlights
from ptina_tpu.camera import camera_rays as jcamera_rays
from ptina_tpu.mtllib import fetch_material as jfetch
from ptina_tpu.scene import make_lights as jmake_lights, LIGHT_POINT
from ptina_tpu_torch.utils.vec import V3
from ptina_tpu_torch.materials import disney as tdisney
from ptina_tpu_torch.materials import simple as tsimple
from ptina_tpu_torch import lights as tlights
from ptina_tpu_torch.camera import camera_rays as tcamera_rays
from ptina_tpu_torch.mtllib import fetch_material as tfetch
from ptina_tpu_torch.scene import (scene_from_numpy, make_lights,
                                   MATERIAL_PARAMS)

from test_torch_scene import jax_scene_arrays

torch.set_num_threads(2)

N = 1024
RTOL, ATOL = 1e-5, 1e-6


def _pair(a):
    '''numpy [N, 3] -> (JAX V3, torch V3) of the same numbers.'''
    a = np.ascontiguousarray(a, np.float32)
    return (JV3(*(jnp.asarray(a[:, k]) for k in range(3))),
            V3(*(torch.from_numpy(a[:, k].copy()) for k in range(3))))


def _row(a):
    a = np.ascontiguousarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _unit(rng, n=N):
    v = rng.randn(n, 3)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _close(ref, got, name='', outliers=0):
    '''assert_allclose at RTOL / ATOL, allowing `outliers` lanes at
    10 x RTOL.'''
    if isinstance(ref, JV3):
        for c in 'xyz':
            _close(getattr(ref, c), getattr(got, c), f'{name}.{c}', outliers)
        return
    ref, got = np.asarray(ref), got.numpy()
    np.testing.assert_allclose(got, ref, rtol=10 * RTOL, atol=ATOL,
                               err_msg=name)
    off = ~np.isclose(got, ref, rtol=RTOL, atol=ATOL, equal_nan=True)
    assert off.sum() <= outliers, (name, np.flatnonzero(off))


def _params(rng, kind):
    '''Per-lane Disney parameters (numpy) and the static zero tuple.'''
    if kind == 'cornell':
        table = jax_scene_arrays(jscenes.cornell_box())['mat_fac']
        rows = table[rng.randint(0, table.shape[0], N)]
        p = {name: rows[:, i, 0] for i, name in enumerate(MATERIAL_PARAMS)}
        p['basecolor'] = rows[:, 0, :3]
        zero = jscenes.cornell_box().materials.zero
        assert 'clearcoat' in zero and 'transmission' in zero
    elif kind == 'all_lobes':
        p = dict(metallic=0.3, roughness=0.35, specular=0.5,
                 specularTint=0.2, subsurface=0.5, sheen=0.6, sheenTint=0.5,
                 clearcoat=0.8, clearcoatGloss=0.7, transmission=0.4,
                 ior=1.5)
        p = {k: np.full(N, v) for k, v in p.items()}
        p['basecolor'] = rng.uniform(0.05, 0.95, (N, 3))
        zero = ()
    else:  # random per-lane parameters, every lobe live
        p = {name: rng.uniform(0.0, 1.0, N) for name in MATERIAL_PARAMS[1:]}
        p['ior'] = rng.uniform(1.1, 2.0, N)
        p['basecolor'] = rng.uniform(0.0, 1.0, (N, 3))
        zero = ()
    jp, tp = {}, {}
    for k, v in p.items():
        if k == 'basecolor':
            jp[k], tp[k] = _pair(v)
        else:
            jp[k], tp[k] = _row(v)
    return jdisney.disney_derive(jp), tdisney.disney_derive(tp), zero


def _geometry(rng):
    normal = _unit(rng)
    indir = _unit(rng)
    # mostly on the normal's side, a few below it (coso / cosi < 0 paths)
    flip = (np.sum(indir * normal, 1) < 0) & (rng.rand(N) < 0.8)
    indir[flip] *= -1
    outdir = _unit(rng)
    sign = np.where(rng.rand(N) < 0.85, 1.0, -1.0) \
        * np.abs(np.sum(indir * normal, 1))
    return (_pair(normal), _pair(indir), _pair(outdir), _row(sign))


KINDS = ['cornell', 'all_lobes', 'random']


@pytest.mark.parametrize('kind', KINDS)
def test_disney_derive(kind):
    jp, tp, _ = _params(np.random.RandomState(1), kind)
    assert set(jp) == set(tp)
    for k in jp:
        _close(jp[k], tp[k], k)


@pytest.mark.parametrize('kind', KINDS)
def test_disney_eval(kind):
    rng = np.random.RandomState(2)
    jp, tp, zero = _params(rng, kind)
    (jn, tn), (ji, ti), (jo, to), (js, ts) = _geometry(rng)
    ref = jdisney.disney_eval(jp, jn, js, ji, jo, zero=zero)
    got = tdisney.disney_eval(tp, tn, ts, ti, to, zero=zero)
    _close(ref, got, 'brdf')


@pytest.mark.parametrize('kind', KINDS)
def test_disney_sample(kind):
    rng = np.random.RandomState(3)
    jp, tp, zero = _params(rng, kind)
    (jn, tn), (ji, ti), _, (js, ts) = _geometry(rng)
    u = rng.uniform(0.0, 1.0, (3, N)).astype(np.float32)
    ju = [jnp.asarray(r) for r in u]
    tu = [torch.from_numpy(r.copy()) for r in u]
    rdir, rpdf, rcol = jdisney.disney_sample(jp, jn, js, ji, *ju, zero=zero)
    gdir, gpdf, gcol = tdisney.disney_sample(tp, tn, ts, ti, *tu, zero=zero)
    _close(rdir, gdir, 'outdir', outliers=2)
    _close(rpdf, gpdf, 'pdf', outliers=2)
    _close(rcol, gcol, 'color', outliers=2)


@pytest.mark.parametrize('model', ['lambert', 'mirror', 'phong'])
def test_simple_models(model):
    '''bsdf_eval / bsdf_sample of the alternate models (the reference's
    materials/simple.py) on cornell materials.'''
    rng = np.random.RandomState(13)
    jp, tp, zero = _params(rng, 'cornell')
    (jn, tn), (ji, ti), (jo, to), (js, ts) = _geometry(rng)
    _close(jsimple.bsdf_eval(model, jp, jn, js, ji, jo, zero=zero),
           tsimple.bsdf_eval(model, tp, tn, ts, ti, to, zero=zero), 'brdf')
    u = rng.uniform(0.0, 1.0, (3, N)).astype(np.float32)
    ref = jsimple.bsdf_sample(model, jp, jn, js, ji,
                              *[jnp.asarray(r) for r in u], zero=zero)
    got = tsimple.bsdf_sample(model, tp, tn, ts, ti,
                              *[torch.from_numpy(r.copy()) for r in u],
                              zero=zero)
    for name, a, b in zip(('outdir', 'pdf', 'color'), ref, got):
        _close(a, b, name, outliers=2)


def _light_pools():
    cornell = jscenes.cornell_box()
    jmixed = jmake_lights(
        [dict(color=(5, 4, 3), pos=(0.5, 2.0, -0.5), size=0.3,
              type=LIGHT_POINT),
         dict(color=(12, 12, 12), pos=(0.0, 3.98, 0.0), size=0.8, type=2,
              axes=np.stack([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]], 1))],
        max_lights=3)
    return {'cornell_area': (cornell.lights,
                             scene_from_numpy(jax_scene_arrays(cornell),
                                              device='cpu').lights),
            'point_area_empty': (jmixed, _torch_lights(jmixed))}


def _torch_lights(jl):
    tl = make_lights([], max_lights=jl.size.shape[0], default_light=False,
                     device='cpu')
    for k in ('color', 'pos', 'axes', 'size', 'type', 'count'):
        setattr(tl, k, torch.from_numpy(np.array(getattr(jl, k))))
    tl.kinds = jl.kinds
    return tl


def _rays_in_box(rng):
    o = np.stack([rng.uniform(-1.9, 1.9, N), rng.uniform(0.1, 3.9, N),
                  rng.uniform(-1.9, 1.9, N)], 1)
    d = _unit(rng)
    d[: N // 4, 1] = np.abs(d[: N // 4, 1]) + 1.0  # many toward the ceiling
    return _pair(o), _pair(d / np.linalg.norm(d, axis=1, keepdims=True))


@pytest.mark.parametrize('pool', ['cornell_area', 'point_area_empty'])
def test_lights_hit(pool):
    jl, tl = _light_pools()[pool]
    (jo, to), (jd, td) = _rays_in_box(np.random.RandomState(4))
    ref = jlights.lights_hit(jl, jo, jd)
    got = tlights.lights_hit(tl, to, td)
    assert np.asarray(ref['hit']).any()
    np.testing.assert_array_equal(got['hit'].numpy(), np.asarray(ref['hit']))
    for k in ('dis', 'pdf', 'color'):
        _close(ref[k], got[k], k)


@pytest.mark.parametrize('pool', ['cornell_area', 'point_area_empty'])
def test_lights_sample(pool):
    jl, tl = _light_pools()[pool]
    rng = np.random.RandomState(5)
    (jo, to), _ = _rays_in_box(rng)
    u = rng.uniform(0.0, 1.0, (3, N)).astype(np.float32)
    ref = jlights.lights_sample(jl, jo, *[jnp.asarray(r) for r in u])
    got = tlights.lights_sample(tl, to, *[torch.from_numpy(r.copy())
                                          for r in u])
    for k in ('dis', 'dir', 'pdf', 'color'):
        _close(ref[k], got[k], k)


@pytest.mark.parametrize('env', ['constant', 'equirect'])
def test_world_at(env):
    js = (jscenes.cornell_box() if env == 'constant'
          else jscenes.envlight_scene(env_res=(16, 32)))
    ts = scene_from_numpy(jax_scene_arrays(js), device='cpu')
    assert ts.world_textured == (env == 'equirect')
    jd, td = _pair(_unit(np.random.RandomState(6)))
    _close(jlights.world_at(js, jd), tlights.world_at(ts, td), 'world')


@pytest.mark.parametrize('textured', [False, True])
def test_fetch_material(textured):
    img = (np.random.RandomState(7).rand(5, 7, 3)).astype(np.float32)
    js = jscenes.cornell_box(textured_image=img if textured else None)
    ts = scene_from_numpy(jax_scene_arrays(js), device='cpu')
    rng = np.random.RandomState(8)
    mtl = rng.randint(-1, 4, N).astype(np.int32)
    st = rng.uniform(0.0, 1.0, (2, N)).astype(np.float32)
    ref = jfetch(js, jnp.asarray(mtl), jnp.asarray(st[0]), jnp.asarray(st[1]))
    got = tfetch(ts, torch.from_numpy(mtl), torch.from_numpy(st[0].copy()),
                 torch.from_numpy(st[1].copy()))
    assert set(ref) == set(got)
    for k in ref:
        _close(ref[k], got[k], k)


def test_camera_rays():
    js = jscenes.cornell_box()
    v2w = np.asarray(js.cam_v2w)
    xy = np.random.RandomState(9).uniform(-1.0, 1.0, (2, N)).astype(np.float32)
    jro, jrd = jcamera_rays(jnp.asarray(v2w), jnp.asarray(xy[0]),
                            jnp.asarray(xy[1]))
    tro, trd = tcamera_rays(torch.from_numpy(v2w.copy()),
                            torch.from_numpy(xy[0].copy()),
                            torch.from_numpy(xy[1].copy()))
    _close(jro, tro, 'ro')
    _close(jrd, trd, 'rd')
