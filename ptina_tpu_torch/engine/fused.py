'''
The path megakernel: one whole progressive sample, every bounce of every
path, in one CUDA launch.

Reference: ptina_tpu/engine/fused.py (`_path_kernel` through
`_fused_call`).  Three heads of the one kernel (csrc/fused_path.cu,
sm_90a), each with its plain twin beside it:

  * fused_trace_primary  — the production render: camera rays, lens
    jitter and the whole Sobol + wang-hash uniform stream are made in the
    kernel; twin: camera_rays + sample_dims' uniforms + path_trace.
  * fused_trace_uniforms — given rays and an explicit [2 + 6 depth, N]
    uniform block (rows 0-1, the lens dims, are not read); the entry of
    MLT replay and of the gradient pair's forward; twin: path_trace.
  * fused_trace — given rays (callers who build their own), the
    sample's Sobol point and a per-ray hash `base` (the
    sampling.wanghash2 bit pattern): the uniform stream is made in the
    kernel as the primary head makes it from the pixel's hash; twin:
    the same uniforms (sobol.hash_rotation) + path_trace.  Fed the
    primary head's camera rays and wanghash2(i, j), it equals
    fused_trace_primary bit for bit.

fused_trace_diff is the differentiable entry (reference: fused.py's
jax.custom_vjp fused_trace_diff): FusedTraceDiff, a
torch.autograd.Function whose forward is fused_trace_uniforms (the
kernel's explicit-uniform head on the card, its twin on the CPU) and
whose backward recomputes path_trace on the same uniforms under autograd
and pulls the cotangent back to the rays and to every floating scene
tensor that requires grad; the uniforms get none.  The kernel has no
backward of its own: the gradients are the wavefront's, whose casts are
detached (engine/path.py).  On the card the recompute replays its
shading as CUDA graphs between the eager casts, material rows and world
fetch (the section above FusedTraceDiff), for every scene the kernel
takes, a textured environment included; on the CPU it is path_trace
itself.

Each picks by the scene tensors' device and nothing else: CPU -> the
plain twin; CUDA -> the kernel, or an exception (an ineligible scene, a
failed build or a failed launch all raise; nothing falls back to the
wavefront).  On identical inputs the twin equals the wavefront render bit
for bit; on the card its casts are the wavefront's CUDA casts.

Eligibility (fused_eligible) is decided from the scene alone, before any
build.  The port's own limits, from its kernel's resources: the scene is
on a CUDA device and on the dense route (accel != 'blocked', at most
MAX_FUSED_FACES = 8192 faces: the packed key's face-id field), and a
textured environment has its atlas loaded.  Blocked-route scenes take the
wavefront with the blocked casts, as the reference's do (fused.py:84).  The kernel reads every table
through the L1/L2 caches from device memory, so the reference's VMEM caps
(MAX_FUSED_TEX_BYTES / MAX_FUSED_TEX_BINDINGS) have no counterpart: any
atlas, binding, material or light count fits.  The depth is at most 16
in the heads that make their uniforms (fused_trace_primary,
fused_trace): the Sobol point rides in the launch parameters and has at
most sampling/sobol.MAX_DIMS = 98 dimensions (the reference has no cap).

Tables: the kernel reads the scene's tensors as they are — the face
tables face_coef [F, 16] / face_attr [F, 18] built once per scene, the
box tree its two casts walk (fused_nodes [2P, 8] over the faces in
fused_order [F], whose rows fused_coef [F, 16] the leaves test; scene.py;
_params raises where they are missing or misaligned), the
material factors [M+1, 12, 4] with their texture ids [M+1, 12] (the
reference's _pack_materials rows), the light pool's per-slot arrays (the
fields _pack_lights stacks into [18, L]), the [T, H, W, 4] atlas and its
extents, the world factor and the camera — so a launch packs nothing and
reads no value back to the host.  The Sobol point rides in the by-value
launch parameters (_Params, mirrored by PtinaPathParams).

LAUNCHES counts kernel launches (incremented only where the kernel is
launched); fused_trace_visits launches the primary head once to read the
casts' tree-walk counters, and counts that launch too.  While tracing is
on (utils/trace.py) one launch in WALK_EVERY of every head fills the
same counters into a trace.walk_buffer('path_kernel', ...), counted on
the device.
'''

import collections
import contextlib
import ctypes
import dataclasses
import functools

import torch

from ptina_tpu_torch.camera import camera_rays
from ptina_tpu_torch.intersect.blocked import tree_leaves
from ptina_tpu_torch.intersect.dense_cast import MAX_DENSE_FACES
from ptina_tpu_torch.intersect.plucker import key_mask_for
from ptina_tpu_torch.sampling.sobol import (hash_rotation, pixel_rotation,
                                            MAX_DIMS)
from ptina_tpu_torch.scene import with_tensor
from ptina_tpu_torch.utils import trace
from ptina_tpu_torch.utils.cuda_build import (build_shared_library, ptr,
                                              raise_on, stream_ptr)
from ptina_tpu_torch.utils.vec import V3

__all__ = ['fused_eligible', 'fused_trace_primary', 'fused_trace_uniforms',
           'fused_trace', 'fused_trace_diff', 'FusedTraceDiff',
           'fused_trace_primary_plain', 'fused_trace_uniforms_plain',
           'fused_trace_plain', 'fused_trace_visits',
           'build_library', 'LAUNCHES', 'MAX_FUSED_FACES']

MAX_FUSED_FACES = MAX_DENSE_FACES

LAUNCHES = {'path': 0}

_SOURCES = ('fused_path.cu', 'vec.cuh', 'disney.cuh', 'lights.cuh',
            'plucker.cuh', 'tree.cuh')

# Materials.zero names -> the kernel's kZero* bits (csrc/disney.cuh)
_ZERO_BITS = {'metallic': 1, 'subsurface': 2, 'sheen': 4, 'clearcoat': 8,
              'transmission': 16}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# PtinaPathParams::head (csrc/fused_path.cu kHead*)
_HEAD_EXPLICIT, _HEAD_PRIMARY, _HEAD_RAYS = 0, 1, 2


class _Params(ctypes.Structure):
    '''Mirror of csrc/fused_path.cu's PtinaPathParams.'''
    _fields_ = (
        [(k, _P) for k in ('coef', 'attr', 'mat_fac', 'mat_tex', 'light_pos',
                           'light_color', 'light_axes', 'light_size',
                           'light_type', 'light_count', 'tex_data', 'tex_nx',
                           'tex_ny', 'world_fac', 'cam')]
        + [('ray_o', _P * 3), ('ray_d', _P * 3), ('uniforms', _P),
           ('base', _P), ('out', _P), ('tree_coef', _P), ('nodes', _P),
           ('order', _P), ('visits', _P)]
        + [(k, _I) for k in ('n', 'f', 'tree_p', 'fid_mask', 'mat_rows',
                             'light_slots',
                             'tex_h', 'tex_w', 'use_tex', 'env_tex', 'depth',
                             'zero', 'kinds', 'head', 'x0', 'y0',
                             'tile_ny')]
        + [('fnx', _F), ('fny', _F), ('pt', _F * MAX_DIMS)])


@functools.lru_cache(maxsize=1)
def build_library():
    '''Compile (once per source hash; utils/cuda_build.py) and load the
    megakernel library.  Returns (ctypes.CDLL, nvcc log text — empty when
    an existing build was loaded).'''
    lib, log = build_shared_library('ptina_fused_path', _SOURCES[0],
                                    _SOURCES)
    lib.ptina_path_trace.argtypes = [ctypes.POINTER(_Params), _P]
    lib.ptina_path_trace.restype = _I
    lib.ptina_path_params_size.restype = _I
    if lib.ptina_path_params_size() != ctypes.sizeof(_Params):
        raise RuntimeError('_Params does not mirror PtinaPathParams')
    return lib, log


def _no_atlas(scene):
    return scene.textures.data.shape[1] == 1 \
        and scene.textures.data.shape[2] == 1


def fused_eligible(scene):
    '''Can this scene take the megakernel?  From the scene alone.'''
    return (scene.device.type == 'cuda'
            and scene.accel != 'blocked'
            and scene.face_coef.shape[0] <= MAX_FUSED_FACES
            and not (scene.world_textured and _no_atlas(scene)))


def _addr(t, dtype, shape=None, name='kernel operand'):
    if not isinstance(t, torch.Tensor):
        raise ValueError(f'{name} is missing')
    if not t.is_cuda or t.dtype != dtype \
            or (shape is not None and tuple(t.shape) != shape):
        raise ValueError(f'{name} must be a CUDA {dtype} {shape}, '
                         f'got {t.device} {t.dtype} {tuple(t.shape)}')
    return ptr(t).value


def _params(scene, n, depth, out):
    '''The launch parameters every head shares: the scene's tables, the
    static specialisations and the output.'''
    if not fused_eligible(scene):
        raise ValueError('scene is not eligible for the megakernel '
                         '(fused_eligible): no fallback on a CUDA device')
    f = scene.face_coef.shape[0]
    mats, lights, tex = scene.materials, scene.lights, scene.textures
    m1 = mats.fac.shape[0]
    n_l = lights.size.shape[0]
    t_, h_, w_, _ = tex.data.shape
    use_tex = not _no_atlas(scene)
    env_tex = scene.world_tex_id if use_tex and scene.world_textured else -1
    if env_tex >= t_ or any(tid >= t_ for _, _, tid in mats.textured):
        raise ValueError('a texture id points past the atlas')
    f32, i32 = torch.float32, torch.int32
    p = _Params()
    # the box tree the two casts walk (scene.py: fused_order, fused_coef,
    # fused_nodes); a scene without it has no route through the kernel
    tp = tree_leaves(f)
    p.tree_coef = _addr(getattr(scene, 'fused_coef', None), f32, (f, 16),
                        'fused_coef')
    p.nodes = _addr(getattr(scene, 'fused_nodes', None), f32, (2 * tp, 8),
                    'fused_nodes')
    p.order = _addr(getattr(scene, 'fused_order', None), i32, (f,),
                    'fused_order')
    for name in ('face_coef', 'fused_coef', 'fused_nodes'):
        if getattr(scene, name).data_ptr() % 16:
            raise ValueError(f'{name} must be 16-byte aligned')
    if tex.data.data_ptr() % 16:
        raise ValueError('the texture atlas must be 16-byte aligned')
    p.coef = _addr(scene.face_coef, f32, (f, 16))
    p.attr = _addr(scene.face_attr, f32, (f, 18))
    p.mat_fac = _addr(mats.fac, f32, (m1, 12, 4))
    p.mat_tex = _addr(mats.tex, i32, (m1, 12))
    p.light_pos = _addr(lights.pos, f32, (n_l, 3))
    p.light_color = _addr(lights.color, f32, (n_l, 3))
    p.light_axes = _addr(lights.axes, f32, (n_l, 3, 3))
    p.light_size = _addr(lights.size, f32, (n_l,))
    p.light_type = _addr(lights.type, i32, (n_l,))
    p.light_count = _addr(lights.count, i32, ())
    p.tex_data = _addr(tex.data, f32)
    p.tex_nx = _addr(tex.nx, i32, (t_,))
    p.tex_ny = _addr(tex.ny, i32, (t_,))
    p.world_fac = _addr(scene.world_fac, f32, (4,))
    p.cam = _addr(scene.cam_v2w, f32, (4, 4))
    p.out = _addr(out, f32, (3, n))
    p.n, p.f, p.tree_p, p.fid_mask = n, f, tp, key_mask_for(f)
    p.mat_rows, p.light_slots, p.tex_h, p.tex_w = m1, n_l, h_, w_
    p.use_tex, p.env_tex, p.depth = int(use_tex), env_tex, depth
    p.zero = sum(_ZERO_BITS[k] for k in mats.zero)
    p.kinds = int('point' in lights.kinds) | 2 * int('area' in lights.kinds)
    return p


def _launch(p, out):
    if p.n:
        lib, _ = build_library()
        raise_on(lib.ptina_path_trace(ctypes.byref(p), stream_ptr()),
                 'path_kernel')
        LAUNCHES['path'] += 1
    return V3(out[0], out[1], out[2])


# While tracing, the kernel fills its walk counters on one launch in
# WALK_EVERY: counting a launch (its -1 fill and the sums) costs ~2% of
# the device time of a launch that takes the whole device, where the
# blocked casts' cells leave the device idle most of the time.
WALK_EVERY = 8


def _run(p, out):
    '''_launch, with the kernel's walk counters filled for the trace
    (utils/trace.walk_buffer) while tracing is on.'''
    if p.n:
        shape = (p.n, p.depth, 2, 2)
        if trace.tracing():
            with trace.walk_buffer('path_kernel', shape, -1, out.device,
                                   WALK_EVERY) as vis:
                if vis is not None:
                    p.visits = _addr(vis, torch.int32)
                return _launch(p, out)
        trace.warm_walks('path_kernel', shape, -1, out.device)
    return _launch(p, out)


def _check_device(scene):
    dev = scene.device
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'no megakernel for device {dev}')
    return dev


def fused_trace_primary_plain(scene, pt, nx, ny, x0=0, y0=0, fnx=None,
                              fny=None, lanes=None):
    '''Plain twin of the primary head: the (nx, ny) film tile at offset
    (x0, y0) of an (fnx, fny) film, uniforms remainder(pt + rotation, 1)
    exactly as sample_dims makes them, then path_trace (lanes: its
    per-bounce cast counts).'''
    from ptina_tpu_torch.engine.path import path_trace, pixel_grid
    fnx = nx if fnx is None else fnx
    fny = ny if fny is None else fny
    dev = scene.device
    pt = torch.as_tensor(pt, dtype=torch.float32).to(dev)
    ii, jj = pixel_grid(nx, ny, int(x0), int(y0), device=dev)
    u = torch.remainder(pt[:, None] + pixel_rotation(ii, jj, pt.shape[0]),
                        1.0)
    x = (ii.to(torch.float32) + u[0]) / fnx * 2.0 - 1.0
    y = (jj.to(torch.float32) + u[1]) / fny * 2.0 - 1.0
    ro, rd = camera_rays(scene.cam_v2w, x, y)
    return path_trace(scene, ro, rd, u, lanes=lanes)


def _host_point(pt):
    '''The Sobol point of the heads that make their uniforms, as a host
    float32 vector of 2 + 6 depth <= MAX_DIMS dimensions (else raises).'''
    pt = torch.as_tensor(pt, dtype=torch.float32).reshape(-1).cpu()
    dims = pt.shape[0]
    if dims > MAX_DIMS or dims < 2 or (dims - 2) % 6:
        raise ValueError(f'Sobol point of {dims} dims: the kernel takes '
                         f'2 + 6 depth <= MAX_DIMS = {MAX_DIMS}')
    return pt


def _point_params(scene, pt, n, out):
    '''_params with the Sobol point in the launch parameters.'''
    pt = _host_point(pt)
    p = _params(scene, n, (pt.shape[0] - 2) // 6, out)
    p.pt[:pt.shape[0]] = pt.tolist()
    return p


def _primary_params(scene, pt, nx, ny, x0, y0, fnx, fny):
    n = nx * ny
    out = torch.empty((3, n), dtype=torch.float32, device=scene.device)
    p = _point_params(scene, pt, n, out)
    p.head, p.x0, p.y0, p.tile_ny = _HEAD_PRIMARY, int(x0), int(y0), ny
    p.fnx = float(nx if fnx is None else fnx)
    p.fny = float(ny if fny is None else fny)
    return p, out


def fused_trace_primary(scene, pt, nx, ny, x0=0, y0=0, fnx=None, fny=None):
    '''One whole progressive sample of the (nx, ny) film tile at offset
    (x0, y0) of an (fnx, fny) film (default: the tile is the film).
    pt: the sample's [2 + 6 depth] Sobol point (sobol_block), best on the
    host: on the card it rides in the launch parameters (a CUDA pt is
    read back first).  Returns radiance V3 of [nx * ny] rows in
    pixel_grid order.'''
    if _check_device(scene).type == 'cpu':
        return fused_trace_primary_plain(scene, pt, nx, ny, x0, y0, fnx, fny)
    return _run(*_primary_params(scene, pt, nx, ny, x0, y0, fnx, fny))


def fused_trace_visits(scene, pt, nx, ny, x0=0, y0=0, fnx=None, fny=None):
    '''fused_trace_primary with the kernel's tree-walk counters read:
    (radiance V3, visits [N, depth, 2, 2] int32), where visits[i, b, c]
    holds (inner nodes visited, leaves tested) by path i's closest (c = 0)
    or shadow (c = 1) cast of bounce b, and -1 where the path made no such
    cast.  One launch, counted in LAUNCHES.  The counters live in the
    kernel only, so a CPU scene raises.'''
    if scene.device.type != 'cuda':
        raise ValueError('fused_trace_visits reads the CUDA kernel\'s '
                         'counters: it needs a CUDA scene')
    p, out = _primary_params(scene, pt, nx, ny, x0, y0, fnx, fny)
    visits = torch.full((p.n, p.depth, 2, 2), -1, dtype=torch.int32,
                        device=scene.device)
    p.visits = _addr(visits, torch.int32)
    return _launch(p, out), visits


def fused_trace_uniforms_plain(scene, ro, rd, uniforms):
    '''Plain twin of the explicit-uniform head: path_trace.'''
    from ptina_tpu_torch.engine.path import path_trace
    return path_trace(scene, ro, rd, uniforms)


def _ray_rows(ro, rd, dev):
    '''The six ray rows, each a contiguous [N] row on dev (else raises).'''
    n = ro.x.shape[0]
    rows = (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z)
    if any(r.device != dev or r.dim() != 1 or r.shape[0] != n
           or not r.is_contiguous() for r in rows):
        raise ValueError('rays must be contiguous [N] rows on the scene\'s '
                         'device')
    return rows


def _set_rays(p, rows):
    for k in range(3):
        p.ray_o[k] = _addr(rows[k], torch.float32)
        p.ray_d[k] = _addr(rows[3 + k], torch.float32)


def fused_trace_uniforms(scene, ro, rd, uniforms):
    '''Trace [N] rays through the whole path on an explicit random stream.
    ro, rd: V3 of contiguous [N] float32 rows; uniforms a contiguous
    [2 + 6 depth, N] float32 block as path_trace consumes them (rows 0-1
    are not read; MLT's chain state, engine/mlt.py).  On the card a
    misshapen, strided or misplaced operand raises.  Returns radiance
    V3.'''
    dev = _check_device(scene)
    if dev.type == 'cpu':
        return fused_trace_uniforms_plain(scene, ro, rd, uniforms)
    n = ro.x.shape[0]
    rows = _ray_rows(ro, rd, dev)
    dims = uniforms.shape[0]
    if uniforms.device != dev or uniforms.dim() != 2 \
            or uniforms.shape[1] != n or dims < 2 or (dims - 2) % 6 \
            or not uniforms.is_contiguous():
        raise ValueError('uniforms must be a contiguous [2 + 6 depth, N] '
                         'block on the scene\'s device')
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    p = _params(scene, n, (dims - 2) // 6, out)
    p.head = _HEAD_EXPLICIT
    _set_rays(p, rows)
    p.uniforms = _addr(uniforms, torch.float32)
    return _run(p, out)


def fused_trace_plain(scene, ro, rd, pt, base):
    '''Plain twin of the explicit-ray head: uniforms remainder(pt[d] +
    rotation, 1), the rotation hash_rotation(base) (the kernel's and
    sample_dims' arithmetic), then path_trace.'''
    from ptina_tpu_torch.engine.path import path_trace
    dev = scene.device
    pt = _host_point(pt).to(dev)
    rot = hash_rotation(torch.as_tensor(base).to(dev), pt.shape[0])
    return path_trace(scene, ro, rd, torch.remainder(pt[:, None] + rot, 1.0))


def fused_trace(scene, ro, rd, pt, base):
    '''Trace [N] rays through the whole path, the random stream made in
    the kernel: ro, rd V3 of contiguous [N] float32 rows; pt the sample's
    [2 + 6 depth] Sobol point (its length sets the depth; rows 0-1, the
    lens dims, are not read), best on the host: on the card it rides in
    the launch parameters; base [N] int32, the per-ray rotation hash
    (sampling.wanghash2's bit pattern for a pixel).  Uniform d of ray i
    is remainder(pt[d] + u32_to_unit(wanghash(base[i] + d * 0x9e3779b9)),
    1), as fused_trace_primary makes it from the pixel's hash.  On the
    card a misshapen, strided or misplaced operand raises.  Returns
    radiance V3.'''
    dev = _check_device(scene)
    if dev.type == 'cpu':
        return fused_trace_plain(scene, ro, rd, pt, base)
    n = ro.x.shape[0]
    rows = _ray_rows(ro, rd, dev)
    if not isinstance(base, torch.Tensor) or base.device != dev \
            or base.dtype != torch.int32 or tuple(base.shape) != (n,) \
            or not base.is_contiguous():
        raise ValueError('base must be a contiguous [N] int32 row on the '
                         'scene\'s device')
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    p = _point_params(scene, pt, n, out)
    p.head = _HEAD_RAYS
    _set_rays(p, rows)
    p.base = _addr(base, torch.int32)
    return _run(p, out)


def _scene_tensors(scene):
    '''(path, tensor) of every tensor of the scene, its materials, textures
    and lights; a path is a tuple of field names.'''
    out = []
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        if dataclasses.is_dataclass(v):
            out += [((f.name,) + p, t) for p, t in _scene_tensors(v)]
        elif isinstance(v, torch.Tensor):
            out.append(((f.name,), v))
    return out


def _grad_leaves(scene):
    '''_scene_tensors' floating tensors that require grad.'''
    return [(p, t) for p, t in _scene_tensors(scene)
            if t.is_floating_point() and t.requires_grad]


def _versions(scene):
    return [t._version for _, t in _scene_tensors(scene)]


# The recompute's shading as CUDA graphs.  A bounce of path_trace is its
# closest cast, its material rows, its world fetch, shading segment A,
# its shadow cast and shading segment B (engine/path._bounce).  The
# casts, the rows and the world fetch hold the hand-written kernels and
# their backwards (the rows' and a textured world's texel gathers); the
# segments are plain torch on fixed shapes, a few hundred small ops
# each, and on the card the pair's backward runs each segment as a CUDA
# graph pair: a forward graph captured at the segment's first call, a
# backward graph at its first backward, both replayed under autograd
# (_Shade) from then on.  The casts, the rows and the world fetch stay
# eager, each kernel with its wrapper, its spans, its counters and its
# launch count.
#
# A segment reads static input buffers: its own, which each call copies
# its inputs into, or, for an input that an earlier segment made, that
# segment's output where it lies.  The scene tensors a segment reads
# (fn.reads: the lights) are inputs too, so every step's new scene
# replays.  The gradients are autograd's bits: a graph
# replays the kernels of the eager recompute on the same values, and the
# sums autograd makes across segments keep their eager order because an
# input a later segment reads again is passed on as a copy made at the
# segment's end (its gradient arrives first, as the later consumers'
# does in the eager graph), the scene tensors that need a gradient among
# them; a backward graph starts from the outputs that get a gradient, as
# autograd's own backward of the segment does, and after the first
# backward an input that never gets one is passed without its edge.
#
# Captures are keyed on what the capture depends on (_graphed: the lanes,
# the depth, the rays' and every scene tensor's shape, dtype and
# requires_grad, the scene's other fields, a textured environment's
# texture id among them), a key's graphs sharing one memory pool,
# replayed in the order they were captured.  Spans: each segment call is
# one `grad.shade`, a replay one `grad.shade.replay` inside it, a capture
# one `grad.graph_capture`.

def _scene_layout(scene, path=()):
    '''What the recompute's graphs depend on of a scene: (path, shape,
    dtype, requires_grad) of each tensor, (path, value) of each other
    field.'''
    out = []
    for f in dataclasses.fields(scene):
        v, p = getattr(scene, f.name), path + (f.name,)
        if dataclasses.is_dataclass(v):
            out += _scene_layout(v, p)
        elif isinstance(v, torch.Tensor):
            out.append((p, v.shape, v.dtype, v.requires_grad))
        else:
            out.append((p, v))
    return tuple(out)


def _at(scene, path):
    for name in path:
        scene = getattr(scene, name)
    return scene


def _flatten(obj, leaves):
    '''Append the tensors of obj (a tensor, a V3, or a dict of them,
    nested) to leaves in a fixed order; returns obj's structure for
    _unflatten.'''
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return None
    if isinstance(obj, V3):
        return ('v3', tuple(_flatten(c, leaves)
                            for c in (obj.x, obj.y, obj.z)))
    return ('dict', tuple((k, _flatten(v, leaves)) for k, v in obj.items()))


def _unflatten(spec, it):
    if spec is None:
        return next(it)
    kind, parts = spec
    if kind == 'v3':
        return V3(*(_unflatten(p, it) for p in parts))
    return {k: _unflatten(p, it) for k, p in parts}


def _unique(leaves):
    '''(the distinct tensors of leaves, each leaf's index among them).'''
    at, uniq, index = {}, [], []
    for t in leaves:
        i = at.get(id(t))
        if i is None:
            i = at[id(t)] = len(uniq)
            uniq.append(t)
        index.append(i)
    return uniq, tuple(index)


@functools.lru_cache(maxsize=None)
def _side_stream(device):
    '''The stream the segments warm up and capture on, one a device.'''
    return torch.cuda.Stream(device)


@contextlib.contextmanager
def _capturing(graph, pool):
    '''Capture the block's work into graph, its memory from pool, on the
    side stream: as torch.cuda.graph, without its synchronize and its
    emptying of the allocator's cache at every capture.'''
    side = _side_stream(torch.cuda.current_device())
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin(pool=pool, capture_error_mode='thread_local')
        try:
            yield
        finally:
            graph.capture_end()


def _graph_copy(dst, src):
    if dst:
        with torch.no_grad():
            torch._foreach_copy_(dst, src)


class _Segment:
    '''One shading segment of the recompute as CUDA graphs: fn(scene, s,
    *static) over static input buffers (the section above).'''

    def __init__(self, owner, fn, scene, paths, spec, index, ins, static):
        self.paths, self.spec, self.index = paths, spec, index
        # an input that is an earlier segment's output is read where that
        # segment leaves it; every other input is copied into a buffer of
        # the segment's own at each call
        self.ins, self.copy, self.chained = [], [], []
        for i, t in enumerate(ins):
            own = owner.owned.get(t.data_ptr())
            if own is not None and own.shape == t.shape \
                    and own.dtype == t.dtype:
                x = own.detach()
                self.chained.append(i)
            else:
                x = torch.empty(t.shape, dtype=t.dtype, device=t.device)
                self.copy.append(i)
            self.ins.append(x.requires_grad_(t.requires_grad))
        self.copy_to = [self.ins[i] for i in self.copy]
        _graph_copy(self.copy_to, [ins[i] for i in self.copy])
        # the scene of the capture: every tensor a meta tensor, which no op
        # can read, but the segment's reads, which _run puts in
        self.scene = scene
        for p, t in _scene_tensors(scene):
            self.scene = with_tensor(self.scene, p,
                                     t.new_empty(t.shape, device='meta'))
        self.fn, self.static = fn, static
        # the scene tensors that need a gradient are passed on: the next
        # segment that reads one reads this segment's copy
        self.threaded = tuple(p for p, i in zip(paths, index)
                              if self.ins[i].requires_grad)
        self.bwd, self.live, self.dead, self.fresh = None, None, None, True
        self._capture(owner)
        for o in self.outs:
            owner.owned[o.data_ptr()] = o

    def _run(self, ins):
        '''The segment's ops on ins (its static inputs, or aliases of
        them): its outputs, the state's and then the threaded scene
        tensors', distinct, each input passed on as a copy.'''
        xs = [ins[i] for i in self.index]
        n = len(self.paths)
        sc = self.scene
        for p, x in zip(self.paths, xs[:n]):
            sc = with_tensor(sc, p, x)
        out = self.fn(sc, _unflatten(self.spec, iter(xs[n:])), *self.static)
        leaves = []
        self.out_spec = _flatten(out, leaves)
        self.n_state = len(leaves)
        outs, self.out_index = _unique(
            leaves + [x for x in xs[:n] if x.requires_grad])
        # an input passed on leaves as a copy made last, so that the
        # gradient from the later segments reaches it first, as in the
        # eager recompute
        mine = {x.untyped_storage().data_ptr() for x in ins}
        return [o.clone() if o.untyped_storage().data_ptr() in mine else o
                for o in outs]

    def _capture(self, owner):
        '''Warm up (each kernel's first launch, outside the capture, on
        aliases of the inputs: their own autograd nodes), then capture the
        forward into owner's memory pool.'''
        side = _side_stream(torch.cuda.current_device())
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), torch.enable_grad():
            alias = [x.detach().requires_grad_(x.requires_grad)
                     for x in self.ins]
            outs = self._run(alias)
            diff = [o for o in outs if o.requires_grad]
            wrt = [x for x in alias if x.requires_grad]
            if diff and wrt:
                torch.autograd.grad(diff, wrt,
                                    [torch.zeros_like(o) for o in diff],
                                    allow_unused=True)
        torch.cuda.current_stream().wait_stream(side)
        if owner.pool is None:
            owner.pool = torch.cuda.graph_pool_handle()
        self.pool, self.fwd = owner.pool, torch.cuda.CUDAGraph()
        with _capturing(self.fwd, self.pool), torch.enable_grad():
            self.outs = self._run(self.ins)

    def _load(self, ins):
        for i in self.chained:
            if ins[i].data_ptr() != self.ins[i].data_ptr():
                raise RuntimeError('fused_trace_diff: a captured shading '
                                   'segment lost its input')
        if self.fresh:  # loaded before the capture
            self.fresh = False
        else:
            _graph_copy(self.copy_to, [ins[i] for i in self.copy])

    def forward(self, ins):
        self._load(ins)
        self.fwd.replay()
        return tuple(o.detach() for o in self.outs)

    def _live(self, grads):
        '''The outputs that get a gradient, the roots of autograd's own
        backward of the segment, fixed at the first backward.'''
        live = tuple(g is not None for g in grads)
        if self.live is not None and self.live != live:
            raise RuntimeError('fused_trace_diff: a captured shading segment '
                               'got gradients for other outputs')
        self.live = live
        return [g for g in grads if g is not None]

    def backward(self, grads):
        got = self._live(grads)
        gins = self._backward(got) if got else [None] * len(self.ins)
        if self.dead is None:
            self.dead = frozenset(i for i, (x, g) in enumerate(zip(self.ins,
                                                                 gins))
                                  if x.requires_grad and g is None)
        return tuple(gins)

    def _backward(self, got):
        '''The inputs' gradients from the live outputs' (got): the
        backward graph, captured at the first call.'''
        if self.bwd is None:
            with trace.span('grad.graph_capture', always=True):
                self._capture_backward(got)
        else:
            _graph_copy(self.gouts, got)
        self.bwd.replay()
        return [None if g is None else g.detach() for g in self.gins]

    def _capture_backward(self, got):
        roots = [o for o, l in zip(self.outs, self.live) if l]
        self.gouts = [torch.empty_like(o) for o in roots]
        _graph_copy(self.gouts, got)
        wrt = [i for i, x in enumerate(self.ins) if x.requires_grad]
        self.bwd = torch.cuda.CUDAGraph()
        with _capturing(self.bwd, self.pool):
            gins = torch.autograd.grad(roots, [self.ins[i] for i in wrt],
                                       self.gouts, allow_unused=True)
        self.gins = [None] * len(self.ins)
        for i, g in zip(wrt, gins):
            self.gins[i] = g


class _Shade(torch.autograd.Function):
    '''apply(segment, *inputs) -> the segment's outputs: its graphs'
    replays under autograd.'''

    @staticmethod
    def forward(ctx, seg, *ins):
        ctx.seg = seg
        ctx.set_materialize_grads(False)
        outs = seg.forward(ins)
        ctx.mark_non_differentiable(*(o for o, s in zip(outs, seg.outs)
                                      if not s.requires_grad))
        return outs

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + ctx.seg.backward(grads)


class _Graphed:
    '''The shading runner of engine/path._bounce in the pair's recompute
    on the card: each call is one captured segment, in call order, the
    first recompute of a key capturing them.'''

    def __init__(self, segment=_Segment):
        self.segment, self.segments, self.owned, self.pool = segment, [], \
            {}, None

    def start(self):
        self.k, self.thread = 0, {}
        return self

    def __call__(self, fn, scene, s, *static):
        with trace.span('grad.shade'):
            new = self.k == len(self.segments)
            paths = tuple(p for p, _ in _scene_tensors(scene)
                          if p[0] in fn.reads) if new \
                else self.segments[self.k].paths
            leaves = [self.thread[p] if p in self.thread else _at(scene, p)
                      for p in paths]
            spec = _flatten(s, leaves)
            ins, index = _unique(leaves)
            if new:
                with trace.span('grad.graph_capture', always=True):
                    self.segments.append(self.segment(
                        self, fn, scene, paths, spec, index, ins, static))
            seg = self.segments[self.k]
            if spec != seg.spec or index != seg.index:
                raise RuntimeError('fused_trace_diff: a shading segment '
                                   'changed since its capture')
            self.k += 1
            if seg.dead:  # no gradient ever flows there: no edge either
                ins = [t.detach() if i in seg.dead else t
                       for i, t in enumerate(ins)]
            with trace.span('grad.shade.replay'):
                outs = _Shade.apply(seg, *ins)
            out = [outs[i] for i in seg.out_index]
            self.thread.update(zip(seg.threaded, out[seg.n_state:]))
            return _unflatten(seg.out_spec, iter(out[:seg.n_state]))


# captured recomputes by key, the newest _GRAPH_KEYS kept
_GRAPH_KEYS = 4
_GRAPHS = collections.OrderedDict()


def _graphed(scene, ins, uniforms):
    '''(key, its _Graphed) on the card, where the scene's shading can be
    captured; None elsewhere.'''
    if not ins[0].is_cuda or ins[0].numel() == 0:
        return None
    key = (uniforms.shape, uniforms.device,
           tuple((t.shape, t.dtype, t.requires_grad) for t in ins[:6]),
           _scene_layout(scene))
    g = _GRAPHS.get(key)
    if g is not None:
        _GRAPHS.move_to_end(key)
        return key, g
    g = _GRAPHS[key] = _Graphed()
    while len(_GRAPHS) > _GRAPH_KEYS:
        _GRAPHS.popitem(last=False)
    return key, g


class FusedTraceDiff(torch.autograd.Function):
    '''The megakernel-forward / wavefront-backward pair (module docstring).
    apply(scene, paths, uniforms, ro.x, ro.y, ro.z, rd.x, rd.y, rd.z,
    *leaves) -> radiance rows (x, y, z); leaves are the scene's tensors at
    `paths` (_grad_leaves), the inputs the gradient reaches besides the
    rays.  The scene's other tensors are read through ctx.scene: their
    version counters are kept, and the backward raises if one was modified
    in place since the forward, as autograd does for saved tensors.'''

    @staticmethod
    def forward(ctx, scene, paths, uniforms, *rows_and_leaves):
        rows = rows_and_leaves[:6]
        rad = fused_trace_uniforms(scene, V3(*rows[:3]), V3(*rows[3:]),
                                   uniforms)
        ctx.scene, ctx.paths = scene, paths
        ctx.versions = _versions(scene)
        ctx.save_for_backward(uniforms, *rows_and_leaves)
        return rad.x, rad.y, rad.z

    @staticmethod
    def backward(ctx, gx, gy, gz):
        from ptina_tpu_torch.engine.path import _eager, _path_trace
        uniforms, *ins = ctx.saved_tensors
        if _versions(ctx.scene) != ctx.versions:
            raise RuntimeError('fused_trace_diff: a scene tensor needed for '
                               'gradient computation has been modified by '
                               'an inplace operation since the forward')
        need = ctx.needs_input_grad[3:]
        ins = [t.detach().requires_grad_(n) for t, n in zip(ins, need)]
        scene = ctx.scene
        for path, t in zip(ctx.paths, ins[6:]):
            scene = with_tensor(scene, path, t)
        graphed = _graphed(scene, ins, uniforms)
        try:
            with torch.enable_grad():
                with trace.span('grad.recompute'):
                    rad = _path_trace(
                        scene, V3(*ins[:3]), V3(*ins[3:6]), uniforms,
                        shade=graphed[1].start() if graphed else _eager)
                wrt = [t for t, n in zip(ins, need) if n]
                with trace.span('grad.inner_backward'):
                    got = torch.autograd.grad(
                        (rad.x, rad.y, rad.z), wrt, (gx, gy, gz),
                        allow_unused=True)
        except BaseException:
            if graphed:  # a capture may have stopped half way
                _GRAPHS.pop(graphed[0], None)
            raise
        if graphed:  # a gradient may be a graph's own output buffer
            got = [None if g is None else g.clone() for g in got]
        got = iter(got)
        return (None, None, None) + tuple(next(got) if n else None
                                          for n in need)


def fused_trace_diff(scene, ro, rd, uniforms):
    '''fused_trace_uniforms under autograd: the same radiance V3, and a
    backward that recomputes path_trace on these uniforms (FusedTraceDiff)
    into ro, rd and every floating scene tensor that requires grad.  The
    rays and the block are made contiguous rows; a CUDA scene that is not
    fused_eligible raises, as fused_trace_uniforms does.'''
    leaves = _grad_leaves(scene)
    rows = [r.contiguous() for r in (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z)]
    x, y, z = FusedTraceDiff.apply(scene, tuple(p for p, _ in leaves),
                                   uniforms.contiguous(), *rows,
                                   *(t for _, t in leaves))
    return V3(x, y, z)
