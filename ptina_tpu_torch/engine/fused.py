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
detached (engine/path.py).

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
        from ptina_tpu_torch.engine.path import path_trace
        uniforms, *ins = ctx.saved_tensors
        if _versions(ctx.scene) != ctx.versions:
            raise RuntimeError('fused_trace_diff: a scene tensor needed for '
                               'gradient computation has been modified by '
                               'an inplace operation since the forward')
        need = ctx.needs_input_grad[3:]
        ins = [t.detach().requires_grad_(n) for t, n in zip(ins, need)]
        with torch.enable_grad():
            scene = ctx.scene
            for path, t in zip(ctx.paths, ins[6:]):
                scene = with_tensor(scene, path, t)
            with trace.span('grad.recompute'):
                rad = path_trace(scene, V3(*ins[:3]), V3(*ins[3:6]),
                                 uniforms)
            wrt = [t for t, n in zip(ins, need) if n]
            with trace.span('grad.inner_backward'):
                got = iter(torch.autograd.grad(
                    (rad.x, rad.y, rad.z), wrt, (gx, gy, gz),
                    allow_unused=True))
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
