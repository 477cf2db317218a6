'''
A wavefront bounce as its pieces (engine/path._bounce): the closest cast,
the material rows (mtllib.material_rows), shading segment A
(path._shade_hit), the shadow cast, shading segment B (path._shade_bsdf).
The pair's backward on the card replays A and B as CUDA graphs
(engine/fused._Graphed); on the CPU it recomputes the eager path_trace.

  * the pieces composed by hand give _bounce's carry after every bounce
    and path_trace's radiance, bit for bit, on cornell_box, cornell_monkey
    and a textured matball;
  * the graphed recompute's structure with each graph's work run eagerly
    (EagerSegment: the same static buffers, copies, chained inputs,
    segment outputs and per-segment autograd, no capture) gives the
    gradients of autograd through path_trace bit for bit, over three
    calls of one runner: the material factors, the atlas, the light
    colour, position and size, and the world factor;
  * on the CPU the pair's backward takes no graph.
'''

import numpy as np
import pytest
import torch

from ptina_tpu_torch import mtllib, scenes, texture
from ptina_tpu_torch.camera import camera_rays
from ptina_tpu_torch.engine import fused, path as tpath
from ptina_tpu_torch.engine.fused import fused_trace_diff
from ptina_tpu_torch.engine.path import PATH_DIMS, pixel_grid
from ptina_tpu_torch.intersect.dispatch import cast_shadow, cast_shaded
from ptina_tpu_torch.lights import world_at
from ptina_tpu_torch.mtllib import material_rows
from ptina_tpu_torch.sampling.sobol import sample_dims
from ptina_tpu_torch.scene import with_tensor
from ptina_tpu_torch.utils import trace
from ptina_tpu_torch.utils.mathutils import INF
from ptina_tpu_torch.utils.vec import V3, vnormalize

torch.set_num_threads(2)

RES = 8
DEPTH = 5
TEX = np.random.RandomState(1).uniform(0.1, 0.9, (16, 16, 3)) \
    .astype(np.float32)
ENV = (16, 32)  # the textured world's equirect map, rows x columns

SCENES = {
    'cornell_box': lambda: scenes.cornell_box(device='cpu'),
    'cornell_monkey': lambda: scenes.cornell_monkey(device='cpu'),
    'matball': lambda: scenes.matball(roughness_tex=TEX, device='cpu'),
    'envlight': lambda: scenes.envlight_scene(env_res=ENV, device='cpu')}


def _rays(scene, sample=0):
    ii, jj = pixel_grid(RES, RES, device='cpu')
    u = sample_dims(sample, ii, jj, PATH_DIMS)
    ro, rd = camera_rays(scene.cam_v2w, (ii.float() + u[0]) / RES * 2 - 1,
                         (jj.float() + u[1]) / RES * 2 - 1)
    return ro, rd, u


def _flat(carry):
    out = []
    for c in carry:
        out += [c.x, c.y, c.z] if isinstance(c, V3) else [c]
    return out


def _same(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y) and
               (not x.is_floating_point() or
                torch.equal(x.view(torch.int32), y.view(torch.int32)))
               for x, y in zip(_flat(a), _flat(b)))


def _by_hand(scene, carry, u, last):
    ro, rd, throughput, result, last_brdf_pdf, avoid, alive = carry
    with torch.no_grad():
        hit, normal, tex_s, tex_t, mtlid = cast_shaded(scene, ro, rd, avoid)
    params = material_rows(scene, mtlid, tex_s, tex_t)
    s = tpath._shade_hit(scene, dict(
        ro=ro, rd=rd, throughput=throughput, result=result,
        last_brdf_pdf=last_brdf_pdf, alive=alive, hit=hit.hit, t=hit.t,
        normal=normal, params=params, world=world_at(scene, rd),
        u=u[0:3]))
    with torch.no_grad():
        occ = cast_shadow(scene, s['ro_sh'], s['rd_sh'], hit.index,
                          s['tmax_sh'])
    keys = ('material', 'hitpos', 'normal', 'sign', 'result', 'live', 'li',
            'rd', 'throughput', 'last_brdf_pdf')
    c = tpath._shade_bsdf(scene, dict({k: s[k] for k in keys}, occ=occ,
                                      index=hit.index, avoid=avoid,
                                      u=u[3:6]), 'disney', last)
    return tuple(c[k] for k in ('ro', 'rd', 'throughput', 'result',
                                'last_brdf_pdf', 'avoid', 'alive'))


@pytest.mark.parametrize('name', sorted(SCENES))
def test_segments_compose_to_the_bounce_and_path_trace(name):
    scene = SCENES[name]()
    ro, rd, u = _rays(scene, 3)
    zero, one = torch.zeros_like(ro.x), torch.ones_like(ro.x)
    carry = (ro, vnormalize(rd), V3(one, one, one), V3(zero, zero, zero),
             torch.full_like(ro.x, INF),
             torch.full(ro.x.shape, -1, dtype=torch.int32),
             torch.ones_like(ro.x, dtype=torch.bool))
    for b in range(DEPTH):
        ub = u[2 + 6 * b:8 + 6 * b]
        want = tpath._bounce(scene, carry, ub, last=b == DEPTH - 1)
        carry = _by_hand(scene, carry, ub, b == DEPTH - 1)
        assert _same(carry, want), b
    assert bool(carry[6].any() | (carry[3].x > 0).any())
    assert _same([carry[3]], [tpath.path_trace(scene, ro, rd, u)])


class EagerSegment(fused._Segment):
    '''A captured segment whose graphs' work runs eagerly: the forward
    runs the segment's body on its static inputs and leaves the results
    in its first outputs' buffers, the backward is autograd.grad of that
    run from the outputs that get a gradient.'''

    def _capture(self, owner):
        with torch.enable_grad():
            self.outs = [o.detach().requires_grad_(o.requires_grad)
                         for o in self._run(self.ins)]

    def forward(self, ins):
        self._load(ins)
        with torch.enable_grad():
            self.run = self._run(self.ins)
        with torch.no_grad():
            for o, r in zip(self.outs, self.run):
                o.copy_(r)
        return tuple(o.detach() for o in self.outs)

    def _backward(self, got):
        wrt = [i for i, x in enumerate(self.ins) if x.requires_grad]
        out = [None] * len(self.ins)
        if wrt:
            roots = [r for r, l in zip(self.run, self.live) if l]
            gins = torch.autograd.grad(roots, [self.ins[i] for i in wrt],
                                       got, allow_unused=True)
            for i, g in zip(wrt, gins):
                out[i] = g
        return out


def _grads(scene, paths, sample, shade):
    leaves, sc = [], scene
    for p in paths:
        t = scene
        for name in p:
            t = getattr(t, name)
        leaves.append(t.detach().clone().requires_grad_(True))
        sc = with_tensor(sc, p, leaves[-1])
    ro, rd, u = _rays(scene, sample)
    gen = torch.Generator().manual_seed(sample)
    gout = tuple(torch.rand(RES * RES, generator=gen) for _ in range(3))
    rad = tpath._path_trace(sc, ro, rd, u, shade=shade)
    return torch.autograd.grad((rad.x, rad.y, rad.z), leaves, gout)


GRAD_CASES = {
    'cornell_light_world': ('cornell_box', [('lights', 'color'),
                                            ('world_fac',),
                                            ('materials', 'fac')]),
    'cornell_light_shape': ('cornell_box', [('lights', 'pos'),
                                            ('lights', 'size')]),
    'monkey_factors': ('cornell_monkey', [('materials', 'fac')]),
    'matball_all': ('matball', [('textures', 'data'), ('materials', 'fac'),
                                ('lights', 'color'), ('world_fac',)]),
    'envlight_world': ('envlight', [('textures', 'data'), ('world_fac',)]),
    'envlight_all': ('envlight', [('world_fac',), ('textures', 'data'),
                                  ('materials', 'fac'), ('lights', 'color')])}


@pytest.mark.parametrize('case', sorted(GRAD_CASES))
def test_segment_backward_equals_autograd_through_path_trace(case,
                                                             monkeypatch):
    '''Bit for bit, and with the gather backwards of the eager recompute:
    none where no gradient flows, from the first call.'''
    name, paths = GRAD_CASES[case]
    scene = SCENES[name]()
    calls = {'texel': 0, 'material': 0}

    def counted(key, fn):
        def call(*a):
            calls[key] += 1
            return fn(*a)
        return call
    monkeypatch.setattr(texture, 'texel_rows_backward',
                        counted('texel', texture.texel_rows_backward))
    monkeypatch.setattr(mtllib, 'material_rows_backward',
                        counted('material', mtllib.material_rows_backward))
    runner = fused._Graphed(EagerSegment)
    for sample in range(3):
        start = dict(calls)
        want = _grads(scene, paths, sample, tpath._eager)
        mid = dict(calls)
        got = _grads(scene, paths, sample, runner.start())
        assert len(runner.segments) == 2 * DEPTH
        assert {k: calls[k] - mid[k] for k in calls} == \
            {k: mid[k] - start[k] for k in calls}
        for p, g, w in zip(paths, got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)), \
                (p, sample)
            assert g.abs().max() > 0, p


def test_pair_takes_no_graph_on_the_cpu():
    scene = scenes.cornell_box(device='cpu')
    ro, rd, u = _rays(scene)
    fac = scene.materials.fac.detach().clone().requires_grad_(True)
    sc = with_tensor(scene, ('materials', 'fac'), fac)
    ins = [ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, fac]
    assert fused._graphed(sc, ins, u) is None
    keys = list(fused._GRAPHS)
    trace.enable()
    trace.reset()
    try:
        rad = fused_trace_diff(sc, ro, rd, u)
        g, = torch.autograd.grad(rad.x.sum(), fac)
        spans = trace.summary()['traced']
    finally:
        trace.disable()
    assert spans['grad.recompute']['count'] == 1
    assert 'grad.shade' not in spans and 'grad.graph_capture' not in spans
    assert list(fused._GRAPHS) == keys
    want, = torch.autograd.grad(tpath.path_trace(sc, ro, rd, u).x.sum(), fac)
    assert torch.equal(g, want)
