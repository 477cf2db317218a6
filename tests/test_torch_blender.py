'''
The PyTorch port's Blender integration (ptina_tpu_torch.blender) on the
CPU, against the JAX reference's (ptina_tpu.blender):

  * tests/test_blender_logic.py's ten cases on the port, each giving the
    reference's values;
  * sync_worker and viewport_pass, the engine's worker calls without bpy;
  * a stand-in `bpy` module, built here and never shipped, drives each
    package's engine class through _on_update (its full sync) and
    render(depsgraph) on a two-object scene at 16x16, the port's worker
    on the CPU (its `init` patched to device='cpu' through the module
    attribute that DaemonModule reads at call time): both engines hand
    their workers equal arrays and values, the port's passes equal its
    headless calls bit for bit, the Albedo and Normal passes meet the
    reference's at tests/test_torch_worker.py's tolerance and the
    Combined mean is within 1%; an incremental material update re-syncs
    both.
'''

import functools
import sys
import types

import numpy as np
import pytest
import torch

from ptina_tpu import blender as jblender
from ptina_tpu import worker as jworker
from ptina_tpu.film import PASS_ALBEDO, PASS_COMBINED, PASS_NORMAL
from ptina_tpu_torch import blender, worker
from ptina_tpu_torch.io.matrix import lookat, perspective

import torch_assets

torch.set_num_threads(2)

RES = 16


class FakeTexNode:
    def __init__(self, image):
        self.image = image


@pytest.mark.parametrize('mod', [blender, jblender], ids=['port', 'ref'])
def test_parse_node_value_scalar_color_texture(mod):
    assert mod.parse_node_value(0.5) == ([0.5] * 4, -1)
    assert mod.parse_node_value((0.1, 0.2, 0.3, 1.0)) == \
        ([0.1, 0.2, 0.3, 1.0], -1)
    assert mod.parse_node_value((0.1, 0.2)) == ([0.1, 0.2, 1.0, 1.0], -1)
    assert mod.parse_node_value(FakeTexNode('img'),
                                get_image_id=lambda im: 7) == ([1.0] * 4, 7)


@pytest.mark.parametrize('mod', [blender, jblender], ids=['port', 'ref'])
def test_parse_node_value_rejects_other_nodes(mod):
    class FakeShaderNode:
        bl_idname = 'ShaderNodeMixRGB'
    with pytest.raises(ValueError):
        mod.parse_node_value(FakeShaderNode())


def test_principled_to_material_layout():
    vals = {name: 0.5 for name in blender.PRINCIPLED_SOCKETS}
    vals['Base Color'] = (0.8, 0.6, 0.4, 1.0)
    vals['IOR'] = 1.45
    mat, ref = blender.principled_to_material(vals), \
        jblender.principled_to_material(vals)
    assert blender.PRINCIPLED_SOCKETS == jblender.PRINCIPLED_SOCKETS
    assert len(mat) == len(ref) == 12
    for (f, t), (jf, jt) in zip(mat, ref):
        assert f.dtype == jf.dtype and t == jt
        np.testing.assert_array_equal(f, jf)
    assert np.allclose(mat[0][0], [0.8, 0.6, 0.4, 1.0]) and mat[0][1] == -1


@pytest.mark.parametrize('args', [
    ((1, 1, 1), 100.0, 'POINT', 0.5), ((1, 0.5, 1), 40.0, 'AREA', 1.0),
    ((0.2, 0.3, 0.4), 7.0, 'AREA', 0.0)], ids=['point', 'area', 'tiny'])
def test_light_energy_to_radiance(args):
    world = np.eye(4)
    world[:3, 3] = [0.5, 3.0, -1.0]
    got = blender.light_to_pool_entry(world, *args)
    ref = jblender.light_to_pool_entry(world, *args)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[1].dtype == ref[1].dtype and got[2:] == ref[2:]
    if args[2] == 'POINT':
        assert np.allclose(got[1], 100.0 / (4 * np.pi ** 2 * 0.25), rtol=1e-6)
    with pytest.raises(ValueError):
        blender.light_to_pool_entry(world, (1, 1, 1), 1.0, 'SUN', 1.0)


def test_world_background_strength():
    for args in (((0.2, 0.4, 0.6, 1.0), 2.0, None),
                 (FakeTexNode('env'), 3.0, lambda im: 2)):
        got = blender.world_background(*args)
        assert got == jblender.world_background(*args)
    assert np.allclose(got[0], [3.0] * 4) and got[1] == 2


def test_render_pass_ids_match_film_layout():
    names = [p[0] for p in blender.RENDER_PASSES]
    assert blender.RENDER_PASSES == jblender.RENDER_PASSES
    assert names[PASS_COMBINED] == 'Combined'
    assert names[PASS_ALBEDO] == 'Albedo'
    assert names[PASS_NORMAL] == 'Normal'


def _ladder(mod, start, max_samples, steps):
    '''Every action of a refiner driven through `steps` (dims, camera,
    preview) calls.'''
    r = mod.ViewportRefiner(start_pixel_size=start, max_samples=max_samples)
    return [r.next_action(*s) for s in steps]


@pytest.mark.parametrize('start,max_samples,steps', [
    (4, 3, [((256, 128), b'cam0', False)] * 7),
    (8, 2, [((64, 64), b'cam0', False)] * 2 + [((64, 64), b'cam1', False),
                                               ((64, 64), b'cam1', True)]),
    (1, 2, [((32, 32), b'c', False)] * 3),
], ids=['ladder', 'resets_on_camera_change', 'finishes'])
def test_viewport_refiner_matches_reference(start, max_samples, steps):
    got = _ladder(blender, start, max_samples, steps)
    assert got == _ladder(jblender, start, max_samples, steps)
    if start == 4:
        assert [a['width'] for a in got[:5]] == [64, 128, 256, 256, 256]
        assert got[5] is None
    if start == 1:
        assert got[2] is None


def test_classify_updates():
    ups = [('MATERIAL', 'red'), ('OBJECT_MESH', 'Cube'),
           ('OBJECT_LIGHT', 'Lamp'), ('SCENE', 'Scene'), ('WORLD', 'World')]
    plan = blender.classify_updates(ups, {'Cube', 'Lamp'})
    assert plan == jblender.classify_updates(ups, {'Cube', 'Lamp'})
    assert plan['materials'] == ['red'] and plan['world'] and plan['prune']
    assert blender.classify_updates([], set()) == \
        {'materials': [], 'world': False, 'meshes': [], 'lights': [],
         'prune': False}


# ------------------------------------------ the engine's worker calls

# torch_assets' Blender scene (the same two objects and lamp that
# tests/test_torch_cuda_frontends.py renders on the card) with a coarser
# sphere
NU, NV = 12, 6
_CAMERA = (perspective(40, 1.0), lookat(pos=(0, 1.5, 0), back=(0, 0.5, 6.5)))


def test_sync_worker_and_viewport_pass():
    '''The engine's sync and one viewport rung on the CPU worker: the
    synced model is compose_multiple_meshes' and every rung renders at
    its size; a preview rung fills the albedo pass.'''
    from ptina_tpu_torch.io.multimesh import compose_multiple_meshes
    worker.init(device='cpu')
    args = torch_assets.blender_scene(NU, NV)
    blender.sync_worker(worker, *args)
    verts, ids = compose_multiple_meshes(args[2])
    np.testing.assert_array_equal(worker._S.vertices, verts)
    np.testing.assert_array_equal(worker._S.mtlids, ids)
    assert len(worker._S.lights) == 1 and not worker._S.default_light
    persp = _CAMERA[0] @ _CAMERA[1]
    r = blender.ViewportRefiner(start_pixel_size=4, max_samples=1)
    for preview in (False, True):
        act = r.next_action((RES, RES), persp.tobytes(), preview)
        (w, h), buf = blender.viewport_pass(worker, act, persp)
        assert (w, h) == (act['width'], act['height']) == (RES // 4,) * 2
        assert buf.shape == (w * h * 3,) and np.isfinite(buf).all()
        assert buf.max() > 0
    assert act['pass_id'] == 1


def _fake_bpy():
    '''A stand-in for the parts of bpy the engines touch.'''
    class RenderEngine:
        def __init__(self):
            self.passes = []

        def add_pass(self, name, n, channels):
            self.passes.append(name)

        def begin_result(self, x, y, w, h):
            names = ['Combined'] + self.passes
            self.result = types.SimpleNamespace(layers=[types.SimpleNamespace(
                passes={n: types.SimpleNamespace(rect=None) for n in names})])
            return self.result

        def update_result(self, result):
            pass

        def end_result(self, result):
            self.ended = True

        def test_break(self):
            return False

        def update_stats(self, *args):
            pass

        def update_progress(self, *args):
            pass

    bpy = types.ModuleType('bpy')
    bpy.types = types.SimpleNamespace(
        RenderEngine=RenderEngine, Material=type('Material', (), {}),
        World=type('World', (), {}), Scene=type('Scene', (), {}),
        Object=type('Object', (), {}))
    bpy.data = types.SimpleNamespace(materials={})
    return bpy


def _socket(value):
    return types.SimpleNamespace(is_linked=False, default_value=value)


def _linked(node):
    return types.SimpleNamespace(is_linked=True,
                                 links=[types.SimpleNamespace(from_node=node)])


def _material(bpy, name):
    socket = torch_assets.BLENDER_MATERIALS[name]
    bsdf = types.SimpleNamespace(inputs={k: _socket(v)
                                         for k, v in socket.items()})
    mat = bpy.types.Material()
    mat.name = name
    mat.node_tree = types.SimpleNamespace(nodes={
        'Material Output': types.SimpleNamespace(
            inputs={'Surface': _linked(bsdf)})})
    return mat


def _mesh_object(bpy, name, verts, world, material):
    n = len(verts) // 3
    mesh = types.SimpleNamespace(
        loop_triangles=[types.SimpleNamespace(loops=(3 * i, 3 * i + 1,
                                                     3 * i + 2))
                        for i in range(n)],
        loops=[types.SimpleNamespace(vertex_index=i,
                                     normal=tuple(verts[i, 3:6]))
               for i in range(3 * n)],
        vertices=[types.SimpleNamespace(co=tuple(verts[i, :3]))
                  for i in range(3 * n)],
        uv_layers=types.SimpleNamespace(active=types.SimpleNamespace(
            data=[types.SimpleNamespace(uv=tuple(verts[i, 6:8]))
                  for i in range(3 * n)])),
        calc_loop_triangles=lambda: None, calc_normals_split=lambda: None)
    ev = types.SimpleNamespace(to_mesh=lambda: mesh,
                               to_mesh_clear=lambda: None)
    return types.SimpleNamespace(name=name, type='MESH', matrix_world=world,
                                 active_material=material,
                                 evaluated_get=lambda dg: ev)


def _depsgraph(bpy):
    mats = {n: _material(bpy, n) for n in torch_assets.BLENDER_MATERIALS}
    bpy.data.materials.update(mats)
    objs = [_mesh_object(bpy, name, v, w, mats[m])
            for name, v, w, m in torch_assets.blender_objects(NU, NV)]
    world, color, energy, size = torch_assets._ceiling_lamp()
    objs.append(types.SimpleNamespace(
        name='Lamp', type='LIGHT', matrix_world=world,
        data=types.SimpleNamespace(type='AREA', size=size,
                                   shadow_soft_size=0.1, color=color,
                                   energy=energy)))
    bg = types.SimpleNamespace(inputs={'Color': _socket((0.05, 0.05, 0.05,
                                                         1.0)),
                                       'Strength': _socket(1.0)})
    world = types.SimpleNamespace(
        name='World', node_tree=types.SimpleNamespace(nodes={
            'World Output': types.SimpleNamespace(
                inputs={'Surface': _linked(bg)})}))
    proj, view = _CAMERA
    camera = types.SimpleNamespace(
        matrix_world=np.linalg.inv(view),
        calc_matrix_camera=lambda dg, x, y: proj)
    props = types.SimpleNamespace(render_samples=2, albedo_samples=1,
                                  update_interval=10.0)
    scene = types.SimpleNamespace(
        world=world, camera=camera, ptina_render=props,
        ptina_torch_render=props,
        objects=_Objects(objs),
        render=types.SimpleNamespace(resolution_percentage=100,
                                     resolution_x=RES, resolution_y=RES))
    return types.SimpleNamespace(scene=scene, objects=objs, updates=[]), mats


class _Objects(list):
    '''scene.objects: iterable, with get(name).'''

    def get(self, name):
        return next((o for o in self if o.name == name), None)


def _close(got, ref):
    return (np.abs(got - ref) <= 1e-3 * (1.0 + np.abs(ref))).all(-1).mean()


def _same_value(a, b):
    '''Equal nested uploads: arrays by value and dtype, the rest by ==.'''
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_value(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_value(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _uploads(w):
    '''What an engine handed its worker.'''
    s = w._S
    return dict(vertices=s.vertices, mtlids=s.mtlids, materials=s.materials,
                images=s.images, lights=s.lights,
                default_light=s.default_light, world=(s.world_fac,
                                                      s.world_tex),
                camera=s.cam_pers, size=(s.nx, s.ny),
                samples=int(s.sample_index))


def _passes(engine):
    return {n: np.asarray(p.rect, np.float32)
            for n, p in engine.result.layers[0].passes.items()}


def test_engine_classes_through_a_stand_in_bpy(monkeypatch):
    '''Each package's engine class renders the stand-in scene (its full
    sync, _on_update, inside render): both hand their workers the same
    arrays, values and calls; the port's passes equal the port worker
    driven by sync_worker directly, bit for bit; the primary-hit passes
    (Albedo, Normal) meet the reference's at tests/test_torch_worker.py's
    tolerance, and the Combined pass's mean is within 1% of the
    reference's (tests/test_torch_render.py's image-mean tolerance: its
    later bounces cast with the dense-cast contract here and with brute
    in the reference, which part some paths by design).  An edited
    material re-syncs both.'''
    bpy = _fake_bpy()
    monkeypatch.setitem(sys.modules, 'bpy', bpy)
    monkeypatch.setattr(worker, 'init',
                        functools.partial(worker.init, device='cpu'))
    uploads, rects = {}, {}
    for mod, w in ((blender, worker), (jblender, jworker)):
        cls = mod._build_engine_class()
        engine = cls()
        dg, mats = _depsgraph(bpy)
        engine.render(dg)
        assert engine.ended and engine.passes == ['Albedo', 'Normal']
        uploads[mod], rects[mod] = _uploads(w), _passes(engine)
        # an edited material re-syncs: the next upload carries it
        bsdf = mats['white'].node_tree.nodes['Material Output'] \
            .inputs['Surface'].links[0].from_node
        bsdf.inputs['Base Color'].default_value = (0.1, 0.2, 0.3, 1.0)
        dg.updates = [types.SimpleNamespace(id=mats['white'])]
        assert engine._update_scene(dg)
        np.testing.assert_array_equal(w._S.materials[0][0][0],
                                      np.float32([0.1, 0.2, 0.3, 1.0]))
    assert cls.bl_idname == 'PTINA_TPU' != blender.ENGINE_ID
    assert uploads[blender]['size'] == (RES, RES)
    assert uploads[blender]['samples'] == 2
    _same_value(uploads[blender], uploads[jblender])

    # the port's engine = the headless calls on the port worker
    worker.init()
    blender.sync_worker(worker, *torch_assets.blender_scene(NU, NV))
    worker.set_size(RES, RES)
    worker.set_camera(uploads[blender]['camera'])
    worker.render()
    worker.render_preview()
    worker.render()
    for pid, (name, channels, _) in enumerate(blender.RENDER_PASSES):
        img = np.ascontiguousarray(worker.get_image(pid).swapaxes(0, 1))
        np.testing.assert_array_equal(
            rects[blender][name], img.reshape(-1, 4)[:, :len(channels)])

    for name in ('Combined', 'Albedo', 'Normal'):
        got, ref = rects[blender][name], rects[jblender][name]
        assert got.shape == ref.shape == (RES * RES,
                                          4 if name == 'Combined' else 3)
        assert np.isfinite(got).all()
        if name == 'Combined':
            assert abs(got.mean() - ref.mean()) / ref.mean() < 0.01
        else:
            assert _close(got, ref) >= 0.98, name
