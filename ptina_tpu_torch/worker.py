'''
Flat stateful API: the reference's public surface, kept shape-compatible.

Reference: ptina_tpu/worker.py (reference ptina/worker.py:11-87).  A thin
mutable wrapper over the functional core: it holds the scene's
ingredients on the host, rebuilds the Scene (scene.make_scene, on the
worker's device) when they change, and tracks the progressive film.
init(device=...) picks the device; the card is the default, and nothing
falls back to the CPU.  set_engine selects 'path' (engine/path.render:
the megakernel on eligible scenes on the card, else the wavefront),
'brute' (engine/brute.render_brute) or 'mlt' (engine/mlt.render_mlt, one
chain step a render() call); render_preview accumulates the albedo and
normal passes (engine/preview.render_preview).

Two contract quirks of the reference are kept: render_preview does not
advance the sample index, and the MLT proposal streams do not depend on
the chains' seed (engine/mlt.py).  load_model takes arrays, an OBJ path
or a readobj dict (io/readobj.py).
'''

import numpy as np
import torch

from ptina_tpu_torch import scene as _scene_mod
from ptina_tpu_torch.config import Config
from ptina_tpu_torch.film import new_film, film_to_image, film_to_flat_rgb
from ptina_tpu_torch.io.matrix import ortho, lookat
from ptina_tpu_torch.utils.params import Params
from ptina_tpu_torch.utils.trace import log

__all__ = [
    'init', 'synchronize', 'render', 'render_preview', 'set_size', 'get_size',
    'clear', 'set_mlt_param', 'get_image', 'fast_export_image', 'clear_lights',
    'set_world_light', 'add_light', 'load_model', 'load_images',
    'load_materials', 'build_tree', 'set_camera', 'set_engine',
    'set_config', 'get_config', 'save_state', 'load_state', 'globals_params',
]


class _State:
    def __init__(self, config=None, device='cuda'):
        self.config = config or Config()
        self.device = torch.device(device)
        self.vertices = None
        self.mtlids = None
        self.materials = None
        self.images = None
        self.lights = []
        self.default_light = True
        self.world_fac = (0.1, 0.1, 0.1, 0.1)
        self.world_tex = -1
        self.cam_pers = None
        self.nx, self.ny = 512, 512
        self.film = None
        self.scene = None
        self.dirty = True
        self.engine = self.config.engine
        self.sample_index = 0
        self.mlt_state = None
        self.mlt_lsp = self.config.mlt_large_step_prob
        self.mlt_sigma = self.config.mlt_sigma
        # tunable debug params (reference Globals, ptina/tools/globals.py):
        # front-ends enumerate .items() to build sliders
        self.params = Params()


_S = _State()


def init(engine=None, config=None, device='cuda'):
    '''reference worker.init (worker.py:11-14).  All knobs come from one
    Config (config.py); `engine` overrides config.engine; scenes, films
    and chains live on `device`.'''
    global _S
    _S = _State(config, device)
    if engine is not None:
        _S.engine = engine


def set_config(**kwargs):
    '''Update config fields on the live worker (engine / material_model /
    MLT parameters take effect on the next render call).'''
    for k, v in kwargs.items():
        if not hasattr(_S.config, k):
            raise AttributeError(f'unknown config field {k!r}')
        setattr(_S.config, k, v)
    if 'engine' in kwargs:
        set_engine(kwargs['engine'])
    if 'mlt_large_step_prob' in kwargs:
        _S.mlt_lsp = _S.config.mlt_large_step_prob
    if 'mlt_sigma' in kwargs:
        _S.mlt_sigma = _S.config.mlt_sigma


def get_config():
    return _S.config


def globals_params():
    '''The worker's named tunable-parameter registry (reference Globals(),
    ptina/tools/globals.py:8-42).'''
    return _S.params


def set_engine(engine):
    '''Select 'path' | 'brute' | 'mlt' (the reference switches engines by
    editing imports, worker.py:6-7).'''
    _S.engine = engine
    _S.mlt_state = None


def _rebuild():
    if not _S.dirty and _S.scene is not None:
        return
    verts = _S.vertices
    mtlids = _S.mtlids
    if verts is None:
        # empty placeholder triangle far away
        verts = np.zeros((3, 8), np.float32)
        verts[:, 0] = 1e5
        mtlids = None
    cam = _S.cam_pers if _S.cam_pers is not None else ortho() @ lookat()
    cfg = _S.config
    _S.scene = _scene_mod.make_scene(
        verts, mtlids, materials=_S.materials, images=_S.images,
        lights=_S.lights if (_S.lights or not _S.default_light) else None,
        default_light=_S.default_light,
        world_fac=_S.world_fac, world_tex=_S.world_tex, cam_pers=cam,
        accel=cfg.accel, pad_faces_to=cfg.pad_faces_to,
        max_lights=cfg.max_lights, max_materials=cfg.max_materials,
        device=_S.device)
    _S.dirty = False
    from ptina_tpu_torch.intersect.dispatch import _route
    sc = _S.scene
    log('TinaScene',
        f'{sc.tri_w2b.shape[0]} faces padded, accel={sc.accel} -> '
        f'{_route(sc)}, {sc.lights.type.shape[0]} light slots, '
        f'{sc.materials.fac.shape[0] - 1} materials, '
        f'{sc.textures.data.shape[0]} textures, on {_S.device}')


def _ensure_film():
    if _S.film is None:
        _S.film = new_film(_S.nx, _S.ny, passes=_S.config.film_passes,
                           device=_S.device)


def synchronize():
    '''Wait for the device work queued on the film.'''
    if _S.film is not None and _S.film.is_cuda:
        torch.cuda.synchronize(_S.film.device)


def render(aa=True):
    '''One progressive sample with the selected engine (reference
    worker.render, worker.py:21-22).'''
    _rebuild()
    _ensure_film()
    cfg = _S.config
    if _S.engine == 'path':
        from ptina_tpu_torch.engine.path import render as _r
        _S.film = _r(_S.scene, _S.film, _S.sample_index, spp=1,
                     model=cfg.material_model, max_depth=cfg.max_depth)
    elif _S.engine == 'brute':
        from ptina_tpu_torch.engine.brute import render_brute as _r
        _S.film = _r(_S.scene, _S.film, _S.sample_index, spp=1,
                     max_depth=cfg.max_depth)
    elif _S.engine == 'mlt':
        from ptina_tpu_torch.engine.mlt import mlt_init, render_mlt
        if _S.mlt_state is None:
            # config.mlt_chains, defaulting to one chain per pixel (the
            # reference fixes 2^18 chains, mltpath.py:11: one per pixel at
            # 512x512); seed 0, as the reference's key(0)
            nchains = cfg.mlt_chains or _S.nx * _S.ny
            gen = torch.Generator(device=_S.device).manual_seed(0)
            _S.mlt_state = mlt_init(nchains=nchains, generator=gen,
                                    device=_S.device)
        _S.mlt_state, _S.film = render_mlt(
            _S.scene, _S.mlt_state, _S.film, steps=1,
            lsp=_S.mlt_lsp, sigma=_S.mlt_sigma)
    else:
        raise ValueError(f'unknown engine {_S.engine!r}')
    _S.sample_index += 1
    log('TinaRender', f'sample {_S.sample_index} ({_S.engine})', level=2)


def render_preview(aa=True):
    '''AOV passes (reference worker.render_preview, worker.py:25-26).  As
    in the reference, the sample index does not advance.'''
    _rebuild()
    _ensure_film()
    from ptina_tpu_torch.engine.preview import render_preview as _r
    _S.film = _r(_S.scene, _S.film, _S.sample_index, spp=1)


def set_size(nx, ny):
    _S.nx, _S.ny = int(nx), int(ny)
    _S.film = None
    _S.sample_index = 0


def get_size():
    return _S.nx, _S.ny


def clear(id=0):
    _S.film = None
    _S.sample_index = 0
    _S.mlt_state = None


def set_mlt_param(lsp, sigma):
    _S.mlt_lsp = float(lsp)
    _S.mlt_sigma = float(sigma)


def get_image(id=0):
    '''Pass `id` as a normalised [nx, ny, 4] numpy image (empty pixels
    debug pink).'''
    _ensure_film()
    return film_to_image(_S.film, id).cpu().numpy()


def fast_export_image(pixels, id=0):
    '''Flat RGB export (reference filmtable.py:65-79): pixels is a
    preallocated [ny * nx * 3] float buffer in scanline order, filled from
    film.film_to_flat_rgb (normalised and transposed on the film's device;
    one copy back to the host).'''
    _ensure_film()
    rgb = film_to_flat_rgb(_S.film, id).cpu().numpy()
    pixels[:rgb.size] = rgb


def clear_lights():
    _S.lights = []
    _S.default_light = False
    _S.dirty = True


def set_world_light(fac, tex):
    _S.world_fac = tuple(np.asarray(fac, np.float32).reshape(-1)[:4])
    _S.world_tex = int(tex)
    _S.dirty = True


def add_light(world, color, size, type):
    '''4x4 world matrix + color + size + 'POINT' | 'AREA' (reference
    LightPool.add, ptina/light/__init__.py:34-49).'''
    world = np.asarray(world, np.float64)
    pos = world @ np.array([0.0, 0.0, 0.0, 1.0])
    pos = pos[:3] / pos[3]
    tmap = {'POINT': _scene_mod.LIGHT_POINT, 'AREA': _scene_mod.LIGHT_AREA}
    _S.lights.append(dict(
        color=np.asarray(color, np.float32),
        pos=pos.astype(np.float32), size=float(size),
        type=tmap[type] if isinstance(type, str) else int(type),
        axes=world[:3, :3].astype(np.float32)))
    _S.default_light = False
    _S.dirty = True


def load_model(vertices, mtlids=None):
    '''[F * 3, 8] flat vertices (+ per-face material ids), or an OBJ path /
    readobj dict (reference ModelPool.load, ptina/model.py:62-86).'''
    if isinstance(vertices, str):
        from ptina_tpu_torch.io.readobj import readobj
        vertices = readobj(vertices)
    if isinstance(vertices, dict):
        from ptina_tpu_torch.io.readobj import obj_to_vertices
        vertices = obj_to_vertices(vertices)
    _S.vertices = np.asarray(vertices, np.float32)
    _S.mtlids = None if mtlids is None else np.asarray(mtlids, np.int32)
    _S.dirty = True


def load_images(images):
    _S.images = list(images) if images else None
    _S.dirty = True


def load_materials(materials):
    _S.materials = list(materials) if materials else None
    _S.dirty = True


def build_tree():
    '''Finalize the scene (reference worker.build_tree): make_scene builds
    the casts' tables and box trees.'''
    _rebuild()


def set_camera(pers):
    _S.cam_pers = np.asarray(pers, np.float64)
    _S.dirty = True


def save_state(path):
    '''Checkpoint the progressive render (film, sample index, MLT chains)
    so a killed render resumes bit for bit (checkpoint.py).'''
    from ptina_tpu_torch.checkpoint import save_render_state
    _ensure_film()
    save_render_state(path, _S.film, _S.sample_index, _S.mlt_state,
                      meta={'nx': _S.nx, 'ny': _S.ny, 'engine': _S.engine})


def load_state(path):
    '''Resume from save_state (of either package, for the 'path' and
    'brute' engines).  Returns True if a checkpoint was loaded.'''
    from ptina_tpu_torch.checkpoint import (load_render_state,
                                            mlt_state_from_numpy)
    state = load_render_state(path)
    if state is None:
        return False
    _S.nx = int(state['meta'].get('nx', _S.nx))
    _S.ny = int(state['meta'].get('ny', _S.ny))
    # restore the engine the checkpoint was rendered with, so a resume
    # continues bit for bit (e.g. an 'mlt' checkpoint on a 'path' worker)
    engine = state['meta'].get('engine')
    if engine is not None and engine != _S.engine:
        _S.engine = engine
        _S.config.engine = engine
    _S.film = torch.tensor(np.asarray(state['film'], np.float32),
                           device=_S.device)
    _S.sample_index = int(state['sample_index'])
    mlt = state['mlt_state']
    _S.mlt_state = None if mlt is None \
        else mlt_state_from_numpy(mlt, _S.device)
    return True
