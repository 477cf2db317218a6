'''
Environment-map recovery on the CPU: the world fetch split out of
shading segment A (engine/path._world_fetch), its `world` counter
(lights.world_counts), and the benchmark's envmap.inverse cell
(perfbench/drivers/inverse_world.py, the frozen scene
perfbench/scenes/envlight.py).  Here:

  * on a seeded random 16 x 32 environment, a 32^2 film at depth 5,
    texture_grad and material_grad against the plain reference's
    (perfbench/plainref) autograd through its wavefront, whose shading
    fetches the world inside the bounce as before the split: the
    gradients bit for bit (tolerance 0: the same float32 ops on the
    same values, the loss's cotangent 2 (img - target) / n the same on
    both sides), the losses within 1e-6 relative (the program's mean
    adds the [nx, ny, 3] image, the reference's its [3, N] rows, in
    another order);
  * the untextured scenes of the other inverse cells keep their bits
    after the split: the gradients of the material factors
    (cornell_monkey), the atlas, the factors and the world factor
    (matball) equal the plain reference's bit for bit;
  * the world counter on a case counted by hand, and one world.fetch
    span a bounce, the gradient the same bits with tracing on;
  * a material table that binds no texture fetches no texel, with the
    bits of the fetch that samples every parameter and multiplies by 1;
  * the frozen scene against the program's scenes.envlight_scene;
  * inverse_world.py's start map and projection, and a dry run of the cell at
    a test size comes out correct, and not correct with each fault
    planted in the program.
'''

import json

import numpy as np
import pytest
import torch

from ptina_tpu_torch import diff, scenes
from ptina_tpu_torch.camera import camera_rays
from ptina_tpu_torch.engine import path as tpath
from ptina_tpu_torch.engine.path import PATH_DIMS, pixel_grid
from ptina_tpu_torch.lights import world_counts
from ptina_tpu_torch.sampling.sobol import sample_dims
from ptina_tpu_torch.scene import with_tensor
from ptina_tpu_torch.utils import trace
from ptina_tpu_torch.utils.vec import V3

from perfbench import run as bench_run
from perfbench.drivers import common, inverse, inverse_texture, \
    inverse_world as drv
from perfbench.harness import manifest as mf
from perfbench.plainref.camera import camera_rays as ref_camera_rays
from perfbench.plainref.path import path_trace as ref_path_trace
from perfbench.plainref.scene import with_tensor as ref_with_tensor
from perfbench.scenes import cornell_blob, envlight, matball

SEED = 1414213562
RES = 32
ENV = dict(rows=16, cols=32)
DRY_RES = 8  # the dry runs' film


@pytest.fixture
def one_thread():
    '''One intra-op thread: PyTorch's CPU index_put_ with accumulate may
    split its lanes over threads, so only one thread sums each texel in
    lane order, as the plain reference's does.'''
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture
def rec():
    trace.disable()
    trace.reset()
    yield trace
    trace.disable()
    trace.reset()


def _env_inputs():
    return envlight.build(dict(nu=48, nv=24, environment=ENV))


def _random_env(seed=SEED):
    return np.random.default_rng(seed).uniform(
        0.2, 2.0, (ENV['rows'], ENV['cols'], 3)).astype(np.float32)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _grads(prog, ref, path, res=RES, sample=3):
    '''d <cotangent, radiance> / d the tensor at path, through the
    program's path_trace and the plain reference's, on the same rays,
    uniforms and cotangent.'''
    ii, jj = pixel_grid(res, res, device='cpu')
    u = sample_dims(sample, ii, jj, PATH_DIMS)
    x = (ii.float() + u[0]) / res * 2 - 1
    y = (jj.float() + u[1]) / res * 2 - 1
    gen = torch.Generator().manual_seed(sample)
    gout = tuple(torch.rand(res * res, generator=gen) for _ in range(3))
    out = []
    for sc, trace_fn, swap, rays in (
            (prog, tpath.path_trace, with_tensor, camera_rays),
            (ref, ref_path_trace, ref_with_tensor, ref_camera_rays)):
        t = sc
        for name in path:
            t = getattr(t, name)
        leaf = t.detach().clone().requires_grad_(True)
        ro, rd = rays(sc.cam_v2w, x, y)
        rad = trace_fn(swap(sc, path, leaf), ro, rd, u)
        g, = torch.autograd.grad((rad.x, rad.y, rad.z), leaf, gout)
        out.append(g)
    return out


@pytest.mark.parametrize('which', ['texture', 'material'])
def test_grads_equal_the_plain_reference(one_thread, which):
    inputs = _env_inputs()
    images = [_random_env()]
    prog = drv.program_scene(inputs, 'cpu', images)
    ref = drv.reference_scene(inputs, 'cpu', images)
    assert prog.world_textured and prog.textures.data.shape == \
        (1, ENV['rows'], ENV['cols'], 4)
    target = torch.from_numpy(np.random.default_rng(1).uniform(
        0.0, 1.0, (RES, RES, 3)).astype(np.float32))
    grad = diff.texture_grad if which == 'texture' else diff.material_grad
    path = ('textures', 'data') if which == 'texture' \
        else ('materials', 'fac')
    loss, g = grad(prog, target, 5)
    leaf = getattr(getattr(ref, path[0]), path[1]).clone() \
        .requires_grad_(True)
    img = inverse._reference_image(ref_with_tensor(ref, path, leaf), RES, 5,
                                   'cpu', None)
    ref_target = target.reshape(RES * RES, 3).T.contiguous()
    ref_loss = torch.mean((img - ref_target) ** 2)
    g_ref, = torch.autograd.grad(ref_loss, leaf)
    assert float(loss) == pytest.approx(float(ref_loss.detach()), rel=1e-6)
    assert torch.equal(_bits(g), _bits(g_ref))
    assert float(g.abs().max()) > 0
    if which == 'texture':  # the world's gathers reach the map
        assert int((g[0, :, :, :3] != 0).sum()) > 8


UNTEXTURED = {
    'monkey_factors': ('cornell_monkey', ('materials', 'fac')),
    'matball_atlas': ('matball_textured', ('textures', 'data')),
    'matball_factors': ('matball_textured', ('materials', 'fac')),
    'matball_world_factor': ('matball_textured', ('world_fac',))}


@pytest.mark.parametrize('case', sorted(UNTEXTURED))
def test_untextured_scenes_keep_their_bits(one_thread, case):
    '''The other inverse cells' scenes, whose world is a constant: the
    program's gradients with the world fetched before segment A equal
    the plain reference's, which fetches it inside the bounce, bit for
    bit.'''
    config, path = UNTEXTURED[case]
    _, cfg = mf.config(mf.manifest(), config)
    if config == 'cornell_monkey':
        inputs = cornell_blob.build(cfg)
        prog = common.program_scene(inputs, 'cpu')
        ref = common.reference_scene(inputs, 'cpu')
    else:
        inputs = matball.build(cfg)
        prog = inverse_texture.program_scene(inputs, 'cpu', inputs['images'])
        ref = inverse_texture.reference_scene(inputs, 'cpu',
                                              inputs['images'])
    assert not prog.world_textured
    got, want = _grads(prog, ref, path, res=16)
    assert torch.equal(_bits(got), _bits(want)) and got.abs().max() > 0


def test_world_counter_on_a_known_case():
    '''Four lanes on a 4 x 8 map, the first two alive and missing: lanes
    fetched, lanes entering, the distinct texels those two lanes' four
    gathers read (texel_keys) and the map's texels; an untextured world
    counts no texels.'''
    img = np.ones((4, 8, 3), np.float32)
    scene = scenes.envlight_scene(env_res=(4, 8), images=[img],
                                  device='cpu')
    rd = V3(torch.tensor([1.0, 0.0, 0.3, 0.0]),
            torch.tensor([0.0, 1.0, 0.4, -1.0]),
            torch.tensor([0.0, 0.0, 0.866, 0.0]))
    enter = torch.tensor([True, True, False, False])
    got = world_counts(scene, rd, enter).tolist()
    from ptina_tpu_torch.lights import _world_uv
    from ptina_tpu_torch.texture import texel_keys
    keys = texel_keys(scene.textures, *_world_uv(scene, rd))
    assert keys.shape == (4, 4)
    want = len(set(keys[:, :2].reshape(-1).tolist()))
    assert got == [4, 2, want, 32] and 1 <= want <= 8
    flat = scenes.cornell_box(device='cpu')
    assert world_counts(flat, rd, enter).tolist() == [4, 2, 0, 0]


def test_world_fetch_span_and_counter_keep_the_bits(one_thread, rec):
    '''A 1-spp texture_grad: five world.fetch spans (one a bounce), the
    world counter's sums, and the same gradient with tracing on.'''
    inputs = _env_inputs()
    scene = drv.program_scene(inputs, 'cpu', [_random_env()])
    target = torch.full((16, 16, 3), 0.4)
    loss, g = diff.texture_grad(scene, target, 2)
    trace.enable()
    loss_on, g_on = diff.texture_grad(scene, target, 2)
    got = trace.summary()
    trace.disable()
    assert got['traced']['world.fetch']['count'] == 5
    lanes, live, reached, texels = got['counts']['world']
    assert lanes == 5 * 16 * 16 and 0 < live < lanes
    assert 0 < reached <= 5 * texels and texels == 5 * 16 * 32
    assert torch.equal(g, g_on) and torch.equal(loss, loss_on)


def test_unbound_material_table_fetches_no_texels(one_thread, rec):
    """A table that binds no texture (the envlight materials under their
    textured world) fetches no texel in material_rows: a 1-spp
    texture_grad at depth 5 runs the world's 20 texel backwards (4
    gathers a bounce) alone, and its loss and gradient equal, bit for
    bit, those of the fetch that samples all 12 parameters from texture
    0 and multiplies by 1 (a table claiming a binding that its ids do
    not hold), which runs more."""
    import dataclasses
    inputs = _env_inputs()
    scene = drv.program_scene(inputs, 'cpu', [_random_env()])
    assert scene.materials.textured == ()
    every = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, textured=((0, 2, 0),)))
    target = torch.full((16, 16, 3), 0.4)
    counts = []
    for sc in (scene, every):
        trace.reset()
        trace.enable()
        counts.append(diff.texture_grad(sc, target, 2))
        counts[-1] += (trace.summary()['traced']['grad.texel_rows']['count'],)
        trace.disable()
    (loss, g, n), (loss_all, g_all, n_all) = counts
    assert n == 20 and n_all > n
    assert torch.equal(loss, loss_all) and torch.equal(_bits(g), _bits(g_all))


def test_frozen_scene_is_the_programs_envlight_scene():
    from ptina_tpu_torch.io.matrix import lookat, ortho
    inputs = _env_inputs()
    assert np.array_equal(envlight.ENVLIGHT_CAMERA, ortho() @ lookat())
    want = scenes.envlight_scene(env_res=(ENV['rows'], ENV['cols']),
                                 device='cpu')
    got = drv.program_scene(inputs, 'cpu', inputs['images'])
    for path in (('face_coef',), ('face_attr',), ('materials', 'fac'),
                 ('materials', 'tex'), ('textures', 'data'),
                 ('textures', 'nx'), ('textures', 'ny'),
                 ('lights', 'color'), ('lights', 'pos'), ('lights', 'size'),
                 ('lights', 'type'), ('world_fac',), ('world_tex',),
                 ('cam_w2v',)):
        a, b = got, want
        for k in path:
            a, b = getattr(a, k), getattr(b, k)
        assert torch.equal(a, b), path
    assert got.world_tex_id == want.world_tex_id == 0
    assert int(got.nfaces) == 2210 and got.face_coef.shape[0] == 2216


def test_start_map_and_projection():
    inputs = _env_inputs()
    m = drv.start_map(inputs, SEED, 0.2, 2.0)
    assert m.shape == (ENV['rows'], ENV['cols'], 4) and m.dtype == np.float32
    assert np.array_equal(m, drv.start_map(inputs, SEED, 0.2, 2.0))
    assert (m[..., 0] >= 0.2).all() and (m[..., 0] < 2.0).all()
    assert np.array_equal(m[..., 0], m[..., 2]) and (m[..., 3] == 1).all()
    assert not np.array_equal(m, drv.start_map(inputs, SEED + 1, 0.2, 2.0))
    assert torch.equal(drv.projected(torch.tensor([-1.0, 5.0, 99.0]), 0.0,
                                     64.0), torch.tensor([0.0, 5.0, 64.0]))
    with pytest.raises(ValueError):
        drv.start_map(dict(inputs, world_tex=-1), SEED, 0.2, 2.0)


def test_cell_entries():
    '''The cell, its traffic and its configuration as BENCHMARK.json and
    the files give them.'''
    man = mf.manifest()
    cell = mf.workload(man, 'envmap.inverse')
    assert (cell['config'], cell['traffic'], cell['chips']) == \
        ('envlight_hdri2k', 'inverse_world_1spp', 1)
    _, cfg = mf.config(man, 'envlight_hdri2k')
    env = cfg['environment']
    assert (env['rows'], env['cols']) == (1024, 2048)
    assert env['rows'] * env['cols'] * 4 * 4 == env['bytes'] == 33554432
    tr = mf.traffic('inverse_world_1spp')
    assert tr['kind'] == 'inverse_world' and tr['start'] == [0.2, 2.0] \
        and tr['clip'] == [0.0, 64.0]


@pytest.fixture
def tiny_run(monkeypatch, capsys):
    '''run(seed) -> the parsed last line of a run of envmap.inverse
    through run.main on the CPU at DRY_RES^2 with the 16 x 32 map.  The
    suite's conftest loads JAX before any test, so the run's check of
    forbidden modules counts only those the run itself loads.'''
    from perfbench.harness import host
    init = bench_run.Cell.__init__
    loaded, forbidden = set(host.forbidden_modules()), host.forbidden_modules
    monkeypatch.setattr(host, 'forbidden_modules',
                        lambda: sorted(set(forbidden()) - loaded))

    def small(self, man, name, seed):
        init(self, man, name, seed)
        self.config = dict(self.config, res=DRY_RES, environment=ENV)
        self.inputs = _env_inputs()

    monkeypatch.setattr(bench_run.Cell, '__init__', small)

    def go(seed=SEED):
        bench_run.main(['--workload', 'envmap.inverse', '--seed',
                        str(seed), '--seconds', '0', '--trace', '0'],
                       device='cpu')
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return go


def test_cell_dry_run_is_correct(one_thread, tiny_run):
    line = tiny_run()
    assert line['correct'] is True
    assert set(line['metrics']) == {'grad_step_ms', 'setup_s'}
    assert line['checks']['grad_gap']['value'] == 0.0


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
