'''
Texture recovery on the CPU: the texel gather's autograd Function
(ptina_tpu_torch/texture.py: TexelRows, texel_rows_backward), the
texture step (diff.inverse_texture_step) and the benchmark's
matball.inverse cell (perfbench/drivers/inverse_texture.py, the frozen
scene perfbench/scenes/matball.py).  Here:

  * TexelRows: the gather's values bit for bit, and its backward
    autograd's own gather backward bit for bit, over atlas sizes, lane
    counts and texel patterns; with no grad mode, no graph;
  * its counters (tracing on) on a case counted by hand, and the
    gradient bit for bit with tracing on and off;
  * the invariant the card's kernel (csrc/texel_rows.cu) rests on: the
    plain backward over only the lanes with a nonzero row equals the
    full one bit for bit, with rows of -0, rows holding a NaN and all
    rows zero; and CPU tensors take the plain twin;
  * texture_grad through TexelRows bit for bit with plain indexing, its
    grad.texel_rows span count a 1-spp step at depth 5;
  * the frozen scene against the program's scenes.matball;
  * inverse_texture_step against the plain reference's autograd step;
  * a dry run of the cell at a test size comes out correct, and not
    correct with each fault planted in the program.
'''

import json

import numpy as np
import pytest
import torch

from ptina_tpu_torch import diff, texture
from ptina_tpu_torch.texture import TexelRows, texel_rows_backward
from ptina_tpu_torch.utils import trace

from perfbench import run as bench_run
from perfbench.drivers import inverse, inverse_texture as drv
from perfbench.harness import manifest as mf
from perfbench.scenes import matball as frozen

SEED = 2718281829
RES = 16
MAP = 8
DRY_RES = 8  # the dry runs' film (their targets take 16 spp on both sides)


@pytest.fixture
def one_thread():
    '''One intra-op thread: PyTorch's CPU index_put_ with accumulate may
    split its lanes over threads, so only one thread sums each texel in
    lane order, as the card's sort path does.'''
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture
def rec():
    '''A fresh recorder, tracing off before and after.'''
    trace.disable()
    trace.reset()
    yield trace
    trace.disable()
    trace.reset()


def _gather(shape, n, pattern, rng):
    '''[n] int64 texid, x, y into an atlas of `shape` [T, H, W, 4]: every
    lane on one texel ('one_texel', the ground's lanes at uv 0), uniform
    over the texels, or a few hot texels ('hot': 3 texels take most
    lanes).'''
    t_, h_, w_ = shape[:3]
    if pattern == 'one_texel':
        idx = [np.full(n, min(1, d - 1)) for d in (t_, h_, w_)]
    elif pattern == 'uniform':
        idx = [rng.integers(0, d, n) for d in (t_, h_, w_)]
    else:
        hot = rng.integers(0, 3, n)
        idx = [np.where(rng.random(n) < 0.9, hot % d, rng.integers(0, d, n))
               for d in (t_, h_, w_)]
    return [torch.from_numpy(i.astype(np.int64)) for i in idx]


SHAPES = [(1, 4, 4, 4), (2, 8, 16, 4), (1, 64, 64, 4)]
CASES = [(s, n, p) for s, n in zip(SHAPES, (1, 257, 4096))
         for p in ('one_texel', 'uniform', 'hot')]


@pytest.mark.parametrize('shape,n,pattern', CASES)
def test_texel_rows_is_the_gather_and_its_backward(one_thread, shape, n,
                                                   pattern):
    rng = np.random.default_rng([n, len(pattern)])
    data = torch.from_numpy(rng.random(shape).astype(np.float32))
    texid, x, y = _gather(shape, n, pattern, rng)
    g = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32))
    g[::3] = 0.0
    leaf = data.clone().requires_grad_(True)
    got = TexelRows.apply(leaf, texid, x, y)
    assert torch.equal(got, data[texid, x, y])
    mine, = torch.autograd.grad(got, leaf, g)
    plain = data.clone().requires_grad_(True)
    theirs, = torch.autograd.grad(plain[texid, x, y], plain, g)
    assert torch.equal(mine, theirs)
    assert torch.equal(texel_rows_backward(texid, x, y, g, data.shape),
                       theirs)
    with torch.no_grad():
        assert TexelRows.apply(leaf, texid, x, y).grad_fn is None
    assert TexelRows.apply(data, texid, x, y).grad_fn is None


def test_texel_rows_counters_on_a_known_case(rec):
    '''6 lanes, 2 of them with a zero cotangent row, onto 4 distinct
    texels of two textures: [6, 4, 4].'''
    data = torch.zeros((2, 3, 3, 4))
    texid = torch.tensor([0, 0, 1, 1, 0, 1])
    x = torch.tensor([0, 0, 2, 2, 1, 0])
    y = torch.tensor([1, 1, 2, 2, 1, 0])
    g = torch.ones((6, 4))
    g[1] = 0.0
    g[5] = 0.0
    leaf = data.requires_grad_(True)
    off, = torch.autograd.grad(TexelRows.apply(leaf, texid, x, y), leaf, g)
    assert 'texel_rows' not in trace.summary()['counts']
    trace.enable()
    on, = torch.autograd.grad(TexelRows.apply(leaf, texid, x, y), leaf, g)
    torch.autograd.grad(TexelRows.apply(leaf, texid, x, y), leaf, g)
    got = trace.summary()
    assert got['counts']['texel_rows'] == [12, 8, 8]
    assert got['traced']['grad.texel_rows']['count'] == 2
    assert torch.equal(on, off)


def _rows(pattern, n, rng):
    '''[n, 4] cotangents, about a third of the rows live: the rest all
    +0 ('sparse'), -0 or mixed signed zeros ('neg_zero'), or +0 with some
    live rows holding a NaN ('nan'); or every row +0 ('all_zero').'''
    g = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32))
    dead = torch.from_numpy(rng.random(n) < 0.65)
    g[dead] = 0.0
    if pattern == 'neg_zero':
        sign = torch.from_numpy(rng.random((n, 4)) < 0.5)
        g[dead] = torch.where(sign, -0.0, 0.0)[dead]
        g[~dead, 1] = -0.0  # a live row may hold -0 in a channel
    elif pattern == 'nan':
        g[torch.nonzero(~dead)[::7, 0], 2] = float('nan')
    elif pattern == 'all_zero':
        g.zero_()
        g[::2] = -0.0
    return g


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize('pattern', ['sparse', 'neg_zero', 'nan',
                                     'all_zero'])
@pytest.mark.parametrize('shape,n,where', [
    ((1, 4, 4, 4), 257, 'one_texel'), ((2, 8, 16, 4), 4096, 'hot'),
    ((1, 64, 64, 4), 4096, 'uniform')])
def test_skipping_zero_rows_keeps_the_bits(one_thread, pattern, shape, n,
                                           where):
    '''The invariant the card's kernel rests on: the plain backward over
    only the lanes whose row has a nonzero channel (NaN counts as
    nonzero) equals the full plain backward bit for bit.  A texel's sum
    from +0 is never -0, and adding +0 or -0 leaves it as it was.'''
    rng = np.random.default_rng([n, len(pattern), len(where)])
    texid, x, y = _gather(shape, n, where, rng)
    g = _rows(pattern, n, rng)
    full = texture.texel_rows_backward_plain(texid, x, y, g, shape)
    live = (g != 0).any(dim=1)
    assert (pattern == 'all_zero') == (not bool(live.any()))
    part = texture.texel_rows_backward_plain(texid[live], x[live], y[live],
                                             g[live], shape)
    assert torch.equal(_bits(full), _bits(part))
    assert not bool((_bits(full) == _bits(torch.tensor(-0.0))).any())
    if pattern == 'nan':
        assert bool(full.isnan().any())


def test_cpu_backward_takes_the_plain_twin(monkeypatch):
    '''On CPU tensors texel_rows_backward runs the plain twin: no launch,
    no library built, autograd's own gradient.'''
    seen = []
    plain = texture.texel_rows_backward_plain

    def record(*args):
        seen.append(args)
        return plain(*args)
    monkeypatch.setattr(texture, 'texel_rows_backward_plain', record)
    monkeypatch.setattr(texture, 'build_library', lambda: pytest.fail(
        'the CPU backward built the CUDA library'))
    before = texture.LAUNCHES['texel_rows']
    rng = np.random.default_rng(5)
    shape = (2, 8, 16, 4)
    texid, x, y = _gather(shape, 300, 'hot', rng)
    g = _rows('sparse', 300, rng)
    got = texel_rows_backward(texid, x, y, g, shape)
    assert len(seen) == 1 and texture.LAUNCHES['texel_rows'] == before
    assert torch.equal(got, plain(texid, x, y, g, shape))


def _inputs(size=MAP, square=2):
    '''The frozen scene's inputs with a size x size checker.'''
    return frozen.build(dict(nu=48, nv=24, checker=dict(
        size=size, square=square, low=0.1, high=0.8)))


@pytest.fixture(scope='module')
def small():
    '''(inputs, program scene with a seeded start map, target image)
    at RES^2 on the CPU.'''
    inputs = _inputs()
    scene = drv.program_scene(inputs, 'cpu', [drv.start_map(inputs, SEED)])
    target = torch.full((RES, RES, 3), 0.25)
    return inputs, scene, target


def test_frozen_scene_is_the_programs_matball():
    '''perfbench/scenes/matball.py builds scenes.matball with the
    reference's camera and checker, array for array.'''
    from ptina_tpu_torch.examples import matball as example
    from ptina_tpu_torch.io.matrix import lookat, perspective
    from ptina_tpu_torch.scenes import matball
    inputs = _inputs(64, 8)
    cam = perspective(fov=45) @ lookat(pos=(0, 1, 0), back=(2.5, 1.5, 2.5))
    assert np.array_equal(frozen.MATBALL_CAMERA, cam)
    assert 'lookat(pos=(0, 1, 0), back=(2.5, 1.5, 2.5))' in \
        open(example.__file__, encoding='utf-8').read()
    want = matball(roughness_tex=inputs['images'][0], cam_pers=cam,
                   device='cpu')
    got = drv.program_scene(inputs, 'cpu', inputs['images'])
    for path in (('face_coef',), ('face_attr',), ('materials', 'fac'),
                 ('materials', 'tex'), ('textures', 'data'),
                 ('lights', 'color'), ('lights', 'pos'), ('lights', 'size'),
                 ('lights', 'type'), ('world_fac',), ('cam_w2v',)):
        a, b = got, want
        for k in path:
            a, b = getattr(a, k), getattr(b, k)
        assert torch.equal(a, b), path
    assert int(got.nfaces) == 2210 and got.face_coef.shape[0] == 2216


def test_texture_grad_is_the_plain_gathers_and_the_same_traced(
        one_thread, rec, small, monkeypatch):
    '''texture_grad on the frozen matball through TexelRows: bit for bit
    with plain indexing's autograd and with tracing on; a 1-spp step at
    depth 5 runs 116 texel backwards (the gathers of the 29 of 60 fetches
    whose parameter reaches the radiance: basecolor, metallic,
    roughness, specular, specularTint and transmission at bounces 0-3,
    the first five at bounce 4), each over every lane.'''
    _, scene, target = small
    loss, g = diff.texture_grad(scene, target, 7)
    trace.enable()
    loss_on, g_on = diff.texture_grad(scene, target, 7)
    got = trace.summary()
    trace.disable()
    assert got['traced']['grad.texel_rows']['count'] == 116
    lanes, live, texels = got['counts']['texel_rows']
    assert lanes == 116 * RES * RES and 0 < live < lanes and texels > 0
    assert torch.equal(g, g_on) and torch.equal(loss, loss_on)
    monkeypatch.setattr(texture.TexelRows, 'apply',
                        staticmethod(lambda d, t, x, y: d[t, x, y]))
    loss_p, g_p = diff.texture_grad(scene, target, 7)
    assert torch.equal(g, g_p) and torch.equal(loss, loss_p)
    assert float(g.abs().sum()) > 0


def test_inverse_texture_step_against_the_reference(one_thread, small):
    '''One step of the program (the wavefront on the CPU) against the
    plain reference's autograd step from the same map.  The two trace the
    same paths with the same float32 arithmetic; the loss's mean adds the
    pixels in another order ([nx, ny, 3] against [3, N]), so the losses
    may part by float32 rounding of a 768-term mean (rel 1e-6), and the
    gradients, made from the same cotangents, within 1e-6 of their norm.'''
    from perfbench.plainref.scene import with_tensor
    inputs, scene, target = small
    lr = 3000.0
    loss_g, g = diff.texture_grad(scene, target, 11)
    new, loss = diff.inverse_texture_step(scene, target, 11, lr=lr)
    assert torch.equal(loss, loss_g)
    assert torch.equal(new.textures.data, scene.textures.data - lr * g)
    ref_scene = drv.reference_scene(inputs, 'cpu',
                                    [drv.start_map(inputs, SEED)])
    assert torch.equal(ref_scene.textures.data, scene.textures.data)
    ref_target = target.reshape(RES * RES, 3).T.contiguous()
    leaf = scene.textures.data.clone().requires_grad_(True)
    img = inverse._reference_image(with_tensor(ref_scene, drv.PATH, leaf),
                                   RES, 11, 'cpu', None)
    ref_loss = torch.mean((img - ref_target) ** 2)
    g_ref, = torch.autograd.grad(ref_loss, leaf)
    assert float(loss) == pytest.approx(float(ref_loss.detach()), rel=1e-6)
    assert drv._rel(g, g_ref) <= 1e-6
    assert float(g_ref.abs().max()) > 0


@pytest.fixture
def tiny_run(monkeypatch, capsys):
    '''run(seed) -> the parsed last line of a run of matball.inverse
    through run.main on the CPU at DRY_RES^2 with a MAP x MAP map.  The
    suite's conftest loads JAX before any test, so the run's check of
    forbidden modules counts only those the run itself loads.'''
    from perfbench.harness import host
    init = bench_run.Cell.__init__
    loaded, forbidden = set(host.forbidden_modules()), host.forbidden_modules
    monkeypatch.setattr(host, 'forbidden_modules',
                        lambda: sorted(set(forbidden()) - loaded))

    def small(self, man, name, seed):
        init(self, man, name, seed)
        self.config = dict(self.config, res=DRY_RES)
        self.inputs = _inputs()

    monkeypatch.setattr(bench_run.Cell, '__init__', small)

    def go(seed=SEED):
        bench_run.main(['--workload', 'matball.inverse', '--seed',
                        str(seed), '--seconds', '0', '--trace', '0'],
                       device='cpu')
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return go


def test_cell_dry_run_is_correct(one_thread, tiny_run):
    line = tiny_run()
    assert line['correct'] is True
    assert set(line['metrics']) == {
        m['name'] for m in mf.cell_metrics(mf.manifest(), 'matball.inverse',
                                           False)} == {'grad_step_ms',
                                                       'setup_s'}
    assert line['checks']['grad_gap']['value'] <= 1e-6


def _half_mse(img, target):
    target = torch.as_tensor(target, dtype=img.dtype)
    half = img.shape[0] // 2
    return torch.mean((img[:half] - target[:half]) ** 2)


@pytest.mark.parametrize('fault', ['unchanged', 'half', 'row',
                                   'texel_shift'])
def test_cell_fault_is_not_correct(one_thread, tiny_run, monkeypatch,
                                   fault):
    if fault == 'unchanged':  # a step that returns its map unchanged
        step = diff.inverse_texture_step

        def inverse_texture_step(scene, target, sample_index=0, spp=1,
                                 lr=0.1):
            return scene, step(scene, target, sample_index, spp, lr)[1]
        monkeypatch.setattr(diff, 'inverse_texture_step',
                            inverse_texture_step)
    elif fault == 'half':  # the loss's mean over half the pixels
        monkeypatch.setattr(diff, '_mse', _half_mse)
    elif fault == 'row':  # the image's first row altered where it is made
        render = diff.render_image_diff

        def render_image_diff(*a, **kw):
            img = render(*a, **kw)
            return torch.cat([torch.zeros_like(img[:1]), img[1:]])
        monkeypatch.setattr(diff, 'render_image_diff', render_image_diff)
    else:  # the gradient landing one texel along x from its own
        grad = diff.texture_grad

        def texture_grad(*a, **kw):
            loss, g = grad(*a, **kw)
            return loss, torch.roll(g, 1, dims=1)
        monkeypatch.setattr(diff, 'texture_grad', texture_grad)
    line = tiny_run()
    assert line['correct'] is False


def test_start_map_and_projection():
    inputs = _inputs()
    m = drv.start_map(inputs, SEED)
    assert m.shape == (MAP, MAP, 4) and m.dtype == np.float32
    assert np.array_equal(m, drv.start_map(inputs, SEED))
    assert (m[..., 0] >= 0.1).all() and (m[..., 0] < 0.8).all()
    assert np.array_equal(m[..., 0], m[..., 2]) and (m[..., 3] == 1).all()
    assert not np.array_equal(m, drv.start_map(inputs, SEED + 1))
    assert torch.equal(drv.projected(torch.tensor([-1.0, 0.5, 2.0])),
                       torch.tensor([0.05, 0.5, 1.0]))
    with pytest.raises(ValueError):
        drv.start_map({'images': None}, SEED)
