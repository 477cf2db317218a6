'''
Film-band rendering and data-parallel gradient steps over a mesh of
devices.

Reference: ptina_tpu/parallel/sharding.py.  A mesh is an ordered tuple
of torch.devices, one film band per entry; an entry may repeat a device
(8 x cpu in the CPU tests, 4 x cuda:0 on a one-card machine).  The film
[P, 4, nx, ny] is cut into equal bands along its row axis (axis 2), and
each band is its own contiguous film on its device, rendered by
render_sample with its global offset x0 and the whole frame's full_res:
the NDC mapping and the Sobol uniforms follow global pixel ids, so a band
holds the same bits as the same rows of a one-device render.  Rendering
issues no collective.  The scene is replicated: a device that is not the
scene's gets a copy of every scene tensor.

In one process the mesh's bands are the whole film, and render_sharded
writes them back into the film it was given (in place, as render does):
the counterpart of the reference's implicit gather at readout.  Across
processes (torch.distributed initialised, parallel/distributed.py) the
film has world_size x len(mesh) bands and rank r owns bands r * len(mesh)
onward; render_sharded fills only those rows, and gather_film assembles
the whole film at readout.

train_step_sharded differentiates each band's local MSE through the
wavefront (render_sample(fused=False); its casts are detached) in the
material factors, averages the gradients and losses over the bands (the
reference's pmean) and, across processes, sums them with one all_reduce
over the process group before dividing by world_size x len(mesh).  A
gloo process group (the CPU, or ranks sharing one GPU) reduces and
gathers host copies of CUDA tensors: the all_reduce carries [M+1, 12, 4]
gradient floats and the loss, and the film is gathered once at readout.
'''

import dataclasses

import torch
import torch.distributed as dist

from ptina_tpu_torch.engine.path import _render_step, render_sample
from ptina_tpu_torch.film import film_to_image
from ptina_tpu_torch.parallel.distributed import is_distributed
from ptina_tpu_torch.scene import with_tensor

__all__ = ['make_mesh', 'render_sharded', 'train_step_sharded',
           'gather_film']

_FAC = ('materials', 'fac')


def make_mesh(devices=None):
    '''A mesh: the tuple of torch.devices of `devices` (names, indices or
    devices; repeats allowed), by default every visible CUDA device.'''
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError('no CUDA device is visible: name the mesh\'s '
                               'devices, e.g. make_mesh(["cpu"] * 8)')
        devices = range(n)
    mesh = tuple(torch.device('cuda', d) if isinstance(d, int)
                 else torch.device(d) for d in devices)
    if not mesh:
        raise ValueError('a mesh needs at least one device')
    return mesh


def _bands(mesh, nx):
    '''[(device, x0, rows)] of this process's bands of an nx-row film.'''
    world, rank = (dist.get_world_size(), dist.get_rank()) \
        if is_distributed() else (1, 0)
    total = world * len(mesh)
    if nx % total:
        raise ValueError(f'film rows {nx} must divide into {total} bands '
                         f'({world} processes x {len(mesh)} devices)')
    rows = nx // total
    first = rank * len(mesh)
    return [(dev, (first + b) * rows, rows) for b, dev in enumerate(mesh)]


def _to_device(obj, device):
    '''obj (a Scene, or a dataclass or tensor inside one) with every
    tensor on `device` (the same tensors where they lie there already).'''
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    return obj


def _replicas(scene, mesh):
    '''{device: the scene on it} for the mesh's devices.'''
    return {dev: _to_device(scene, dev) for dev in dict.fromkeys(mesh)}


def _band(film, x0, rows, device):
    '''Rows [x0, x0 + rows) of the film as a contiguous film of its own on
    `device` (a copy: film_add writes in place).'''
    return film[:, :, x0:x0 + rows].to(
        device, memory_format=torch.contiguous_format, copy=True)


def render_sharded(scene, film, sample_index, mesh, spp=1, fused=None):
    '''Render `spp` samples from sample_index into this process's bands of
    the film [P, 4, nx, ny] (nx divisible by the band count), each band on
    its mesh device through the route `fused` picks (render_sample's).
    Writes the bands back into the film and returns it: the whole frame in
    one process; across processes gather_film reads the rest.'''
    _, _, nx, ny = film.shape
    replicas = _replicas(scene, mesh)
    done = [(x0, _render_step(replicas[dev], _band(film, x0, rows, dev),
                              sample_index, spp, x0=x0, full_res=(nx, ny),
                              fused=fused))
            for dev, x0, rows in _bands(mesh, nx)]
    for x0, band in done:
        film[:, :, x0:x0 + band.shape[2]] = band
    return film


def _through_host(t):
    '''Whether a collective on t goes through a host copy: a gloo
    process group (the CPU, or ranks sharing a GPU) takes host tensors.'''
    return t.is_cuda and dist.get_backend() == 'gloo'


def gather_film(film, mesh):
    '''The whole film at readout, in place: every process's bands gathered
    with one all_gather (in one process, the film as it is).'''
    if not is_distributed():
        return film
    bands = _bands(mesh, film.shape[2])
    x0, rows = bands[0][1], bands[0][2] * len(bands)
    mine = film[:, :, x0:x0 + rows].contiguous()
    src = mine.cpu() if _through_host(mine) else mine
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src)
    film.copy_(torch.cat(parts, dim=2))
    return film


def _band_loss_grad(scene, film0, target, sample_index, x0, rows, full_res):
    '''One band's MSE against its rows of the target and its gradient in
    materials.fac, on the scene's device.'''
    dev = scene.device
    with torch.enable_grad():
        fac = scene.materials.fac.detach().requires_grad_(True)
        band = render_sample(with_tensor(scene, _FAC, fac),
                             _band(film0, x0, rows, dev), sample_index, x0,
                             full_res=full_res, fused=False)
        img = film_to_image(band)[..., :3]
        want = target[x0:x0 + rows].to(dev)
        loss = torch.mean((img - want) ** 2)
        g, = torch.autograd.grad(loss, fac)
    return loss.detach(), g


def train_step_sharded(scene, film0, target, sample_index, mesh, lr=0.05):
    '''One data-parallel differentiable render step: every band renders
    through the wavefront, takes its local MSE against its rows of the
    target [nx, ny, 3] and its gradient in the material factors; the
    gradients and losses are averaged over every band of every process,
    and the factors take one SGD step.  Returns (new_scene, loss) on the
    scene's device; the scene and film0 are unchanged.'''
    _, _, nx, ny = film0.shape
    home = scene.device
    target = torch.as_tensor(target, dtype=torch.float32)
    replicas = _replicas(scene, mesh)
    loss, g = None, None
    for dev, x0, rows in _bands(mesh, nx):
        lb, gb = _band_loss_grad(replicas[dev], film0, target, sample_index,
                                 x0, rows, (nx, ny))
        lb, gb = lb.to(home), gb.to(home)
        loss, g = (lb, gb) if g is None else (loss + lb, g + gb)
    count = len(mesh)
    if is_distributed():
        # one all_reduce of the gradient and the loss together
        buf = torch.cat([g.reshape(-1), loss.reshape(1)])
        if _through_host(buf):
            buf = buf.cpu()
        dist.all_reduce(buf)
        buf = buf.to(home)
        g, loss = buf[:-1].reshape(g.shape), buf[-1]
        count *= dist.get_world_size()
    g, loss = g / count, loss / count
    return with_tensor(scene, _FAC, scene.materials.fac - lr * g), loss
