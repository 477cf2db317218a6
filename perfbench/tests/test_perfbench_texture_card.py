'''On the card: the texel gather's backward at the matball.inverse cell's
size (the frozen matball, 512x512, depth 5, its 64x64 map): texture_grad
bit for bit with plain indexing's autograd (the gathers' own backward,
which TexelRows keeps) and with tracing on, 116 grad.texel_rows spans a
1-spp step inside grad.inner_backward, and the cell's three texture
readers non-null after a traced step (run with `python -m pytest
perfbench/tests -m cuda` on a machine with an NVIDIA card; skips without
one).'''

import pytest
import torch

from perfbench.drivers import inverse_texture as drv
from perfbench.harness import manifest as mf

pytestmark = pytest.mark.cuda
SEED = 3605551275
READERS = ('grad.texel_rows_ms', 'texture.live_lane_share',
           'texture.lanes_per_texel', 'grad.inner_backward_ms')


@pytest.fixture(scope='module')
def cell_scene():
    '''(scene with a seeded start map, target) on the card at the
    configuration's size.'''
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (torch.cuda.is_available() is '
                    'false)')
    man = mf.manifest()
    _, cfg = mf.config(man, 'matball_textured')
    inputs = mf.scene_family(cfg['scene']).build(cfg)
    scene = drv.program_scene(inputs, 'cuda',
                              [drv.start_map(inputs, SEED)])
    res = int(cfg['res'])
    target = torch.full((res, res, 3), 0.25, device='cuda')
    return scene, target


@pytest.fixture
def rec():
    from ptina_tpu_torch.utils import trace
    trace.disable()
    trace.reset()
    yield trace
    trace.disable()
    trace.reset()


def test_texture_grad_bits_and_spans(card, cell_scene, rec, monkeypatch):
    from ptina_tpu_torch import diff, texture
    from ptina_tpu_torch.engine.fused import fused_eligible
    scene, target = cell_scene
    assert fused_eligible(scene)
    loss, g = diff.texture_grad(scene, target, 9)
    rec.enable()
    loss_on, g_on = diff.texture_grad(scene, target, 9)
    got = rec.summary()
    spans = rec.spans()
    rec.disable()
    assert got['traced']['grad.texel_rows']['count'] == 116
    lanes, live, texels = got['counts']['texel_rows']
    assert lanes == 116 * target.shape[0] * target.shape[1]
    assert 0 < live < lanes and 0 < texels
    by_id = {s['id']: s for s in spans}
    assert {by_id[s['parent']]['name'] for s in spans
            if s['name'] == 'grad.texel_rows'} == {'grad.inner_backward'}
    monkeypatch.setattr(texture.TexelRows, 'apply',
                        staticmethod(lambda d, t, x, y: d[t, x, y]))
    loss_p, g_p = diff.texture_grad(scene, target, 9)
    assert torch.equal(g, g_on) and torch.equal(g, g_p)
    assert torch.equal(loss, loss_on) and torch.equal(loss, loss_p)
    assert float(g.abs().sum()) > 0


def test_readers_after_a_traced_step(card, cell_scene, rec):
    from ptina_tpu_torch import diff
    scene, target = cell_scene
    rec.enable()
    diff.inverse_texture_step(scene, target, 4, lr=3000.0)
    rec.disable()
    for name in READERS:
        value = mf.reader(name).read({})
        assert value is not None and value > 0, name
    assert mf.reader('texture.live_lane_share').read({}) <= 100.0
