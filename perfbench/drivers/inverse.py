'''
Inverse rendering, closed loop: optimisation steps of the program's
diff.inverse_render_step (the loss, its gradient in the material factors
and one SGD step on them) toward a target image, the sample index
advancing each step and the loss read on the host each step; after each
step the loop projects the factors onto the Disney model's box (BOX_LO,
BOX_HI), as a projected-gradient inverse renderer does.  The target
is the program's render of the published materials at the traffic's
target_spp, made in set-up; the starting materials are the published ones
perturbed from the seed (basecolor scaled, roughness shifted).

Set-up drives the optimisation's first CHECK_STEPS steps through the
window's own call, keeping each step's loss and the factors after the
first and the last of them, and hands the same scene on to the window.
The window keeps the factors before and after its own last step and that
step's loss.  The check: the plain reference (perfbench/plainref) makes
its own target and follows set-up's steps with autograd through its
wavefront; compared are each step's loss, the norm of the first gradient
as the SGD step got it ((factors before - factors after) / lr, on both
sides) and the norm of the factors' change over the steps, each as the
gap of the two norms over the reference's.  Then it takes one step of its
own from the factors the window's last step started from, at that step's
sample index, and the window's last loss and gradient are compared with
it the same way (the reference can follow the window only from the
program's own factors; set-up's steps check the start by themselves).
'''

import contextlib
import math
import time

import numpy as np
import torch

from perfbench.drivers import common


# the steps set-up drives and the reference follows; the start sample
# of the optimisation is drawn below START_STEPS, the target's samples
# start at TARGET_START, far from the steps'
CHECK_STEPS = 3
START_STEPS = 65536
TARGET_START = 1 << 20
# each factor's range, in plainref.scene.MATERIAL_PARAMS order: [0, 1],
# roughness from 0.05 as the start's draw, ior left free.  Without it
# plain SGD at lr 0.1 carries the factors of the lobes the scene dropped
# as zero (metallic, transmission) and basecolor out of range on some
# seeds, and the loss to inf within the window (after 10 to 130 steps),
# program and reference alike
BOX_LO = (0.0, 0.0, 0.05, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
          -float('inf'))
BOX_HI = (1.0,) * 11 + (float('inf'),)


def projected(fac):
    '''[M+1, 12, 4] factors clipped to [BOX_LO, BOX_HI] per parameter.'''
    lo = torch.tensor(BOX_LO, dtype=fac.dtype, device=fac.device)
    hi = torch.tensor(BOX_HI, dtype=fac.dtype, device=fac.device)
    return torch.minimum(torch.maximum(fac, lo[:, None]), hi[:, None])


class State:
    pass


def perturbed(materials, seed):
    '''The published materials with each basecolor scaled by U(0.7, 1.3)
    (clipped to [0, 1]) and each roughness shifted by U(-0.2, 0.2)
    (clipped to [0.05, 1]), drawn from the seed.'''
    rng = np.random.default_rng([seed, 2])
    out = []
    for mat in materials:
        mat = list(mat)
        base, t = mat[0]
        scale = rng.uniform(0.7, 1.3, 3).astype(np.float32)
        mat[0] = (np.clip(np.asarray(base, np.float32) * scale, 0.0, 1.0), t)
        rough, t = mat[2]
        mat[2] = (float(np.clip(rough + rng.uniform(-0.2, 0.2), 0.05, 1.0)),
                  t)
        out.append(mat)
    return out


def _image(film):
    from ptina_tpu_torch.film import film_to_image
    return film_to_image(film)[..., :3]


def setup(cell):
    from ptina_tpu_torch import diff
    from ptina_tpu_torch.engine.path import render
    from ptina_tpu_torch.film import new_film
    from ptina_tpu_torch.scene import with_tensor
    st = State()
    st.cell, st.dev = cell, cell.device
    tr = cell.traffic
    st.res, st.lr = int(cell.config['res']), float(tr['lr'])
    st.step, st.with_tensor = diff.inverse_render_step, with_tensor
    st.start = cell.seed % START_STEPS
    st.target_spp = int(tr['target_spp'])
    st.materials = perturbed(cell.inputs['materials'], cell.seed)
    published = common.program_scene(cell.inputs, st.dev)
    film = render(published, new_film(st.res, st.res, device=st.dev),
                  TARGET_START, spp=st.target_spp)
    st.target = _image(film).contiguous()
    del published, film
    st.scene = common.program_scene(cell.inputs, st.dev, st.materials)
    st.fac0 = st.scene.materials.fac.detach().cpu().clone()
    st.losses, st.k = [], 0
    for k in range(CHECK_STEPS):
        st.losses.append(_step(st))
        if k == 0:
            st.fac1 = st.scene.materials.fac.detach().cpu().clone()
    st.facn = st.scene.materials.fac.detach().cpu().clone()
    return st


def _step(st):
    '''One step of the loop: the program's step, then the projection.'''
    scene, loss = st.step(st.scene, st.target, st.start + st.k, spp=1,
                          lr=st.lr)
    st.scene = st.with_tensor(scene, ('materials', 'fac'),
                              projected(scene.materials.fac))
    st.k += 1
    return loss.item()


class _Split:
    '''The traced run's wall ms, synchronised, of each step's forward (the
    program's diff.render_image_diff) and backward (torch.autograd.grad,
    the outermost call: the program's backward calls it again inside).'''

    def __init__(self, dev):
        self.dev, self.fwd, self.bwd, self.depth = dev, [], [], 0

    def _timed(self, fn, into):
        def timed(*a, **kw):
            if self.depth:
                return fn(*a, **kw)
            self.depth += 1
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                into.append((time.perf_counter() - t0) * 1e3)
            finally:
                self.depth -= 1
            return out
        return timed

    def __enter__(self):
        from ptina_tpu_torch import diff
        self._diff, self._grad = diff.render_image_diff, torch.autograd.grad
        diff.render_image_diff = self._timed(self._diff, self.fwd)
        torch.autograd.grad = self._timed(self._grad, self.bwd)
        return self

    def __exit__(self, *exc):
        from ptina_tpu_torch import diff
        diff.render_image_diff, torch.autograd.grad = self._diff, self._grad
        return False


def window(st, seconds, traced, units=None):
    '''Steps until `seconds` have passed (or, given, `units` steps).'''
    from torch.profiler import record_function
    steps, failed = 0, 0
    split = _Split(st.dev) if traced else None
    with common.kernel_events(traced) as ev, \
            (split or contextlib.nullcontext()):
        t0 = time.perf_counter()
        while True:
            before = st.scene.materials.fac  # a step makes a new tensor
            with record_function('step'):
                loss = _step(st)
            failed += not math.isfinite(loss)
            steps += 1
            if (steps >= units if units is not None
                    else time.perf_counter() - t0 >= seconds):
                break
        elapsed = time.perf_counter() - t0
    st.last = (loss, st.start + st.k - 1, before.detach().cpu().clone(),
               st.scene.materials.fac.detach().cpu().clone())
    out = dict(attempted=steps, failed=failed, units=steps,
               steps=steps, window_s=elapsed)
    out.update(common.kernel_readings(ev))
    if split and split.fwd:
        out['forward_ms'] = float(np.mean(split.fwd))
        out['backward_ms'] = float(np.mean(split.bwd))
    return out


def unit(st):
    def one():
        _step(st)
    return one


def reference_target(inputs, res, target_spp, dev, round_to=None):
    '''[3, res * res] the reference's own target: its render of the
    published materials, target_spp samples from TARGET_START.'''
    scene = common.reference_scene(inputs, dev, round_to=round_to)
    tgt = common.reference_sums(scene, np.arange(res * res), res,
                                TARGET_START, target_spp, dev,
                                round_to=round_to)
    return (tgt[:3] / tgt[3]).to(dev)


def reference_step(scene, fac, target, res, sample, lr, dev, round_to=None,
                   fault=None):
    '''One step of the reference's loop on the scene's factors from fac:
    (loss, factors after the SGD step and the projection).  fault: None; 'half' (the loss's mean over half
    the pixels) or 'row' (the image's first row of pixels altered to 0
    where it is made).'''
    from perfbench.plainref.scene import with_tensor
    leaf = fac.detach().to(dev).requires_grad_(True)
    s = with_tensor(scene, ('materials', 'fac'), leaf)
    img = _reference_image(s, res, sample, dev, round_to)
    if fault == 'row':
        img = torch.cat([torch.zeros_like(img[:, :res]), img[:, res:]], 1)
    sq = (img - target) ** 2
    if fault == 'half':
        sq = sq[:, : sq.shape[1] // 2]
    loss = torch.mean(sq)
    g, = torch.autograd.grad(loss, leaf)
    after = projected(leaf.detach() - lr * g)
    if round_to is not None:
        after = after.to(round_to).to(torch.float32)
    return float(loss.detach()), after


def reference_steps(inputs, materials, res, start, target, steps, lr, dev,
                    round_to=None, fault=None):
    '''The plain reference's optimisation: `steps` SGD steps on its
    scene's factors toward `target` (reference_target).  Returns (losses,
    fac0, fac1, facn) on the host.'''
    scene = common.reference_scene(inputs, dev, materials, round_to)
    fac = scene.materials.fac
    facs, losses = [fac.detach().cpu().clone()], []
    for k in range(steps):
        loss, fac = reference_step(scene, fac, target, res, start + k, lr,
                                   dev, round_to, fault)
        losses.append(loss)
        facs.append(fac.cpu().clone())
    return losses, facs[0], facs[1], facs[-1]


def reference_last(inputs, materials, res, last, target, lr, dev,
                   round_to=None, fault=None):
    '''The reference's step from the factors the window's last step
    started from (last: the program's (loss, sample, before, after)):
    (loss, sample, before, after) on the host.'''
    _, sample, before, _ = last
    scene = common.reference_scene(inputs, dev, materials, round_to)
    loss, after = reference_step(scene, before, target, res, sample, lr,
                                 dev, round_to, fault)
    return loss, sample, before, after.cpu()


def _reference_image(scene, res, sample, dev, round_to):
    '''[3, res * res] one-sample image, differentiable in the scene's
    factors, in the program's pixel order (i * res + j).'''
    from perfbench.plainref.camera import camera_rays
    from perfbench.plainref.path import PATH_DIMS, path_trace
    from perfbench.plainref.sampling.sobol import sample_dims
    ii, jj = torch.meshgrid(torch.arange(res, dtype=torch.int32, device=dev),
                            torch.arange(res, dtype=torch.int32, device=dev),
                            indexing='ij')
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    u = sample_dims(sample, ii, jj, PATH_DIMS)
    x = (ii.to(torch.float32) + u[0]) / res * 2.0 - 1.0
    y = (jj.to(torch.float32) + u[1]) / res * 2.0 - 1.0
    ro, rd = camera_rays(scene.cam_v2w, x, y)
    rad = path_trace(scene, ro, rd, u, round_to=round_to)
    return torch.stack([rad.x, rad.y, rad.z])


def _norm(t):
    return float(torch.linalg.vector_norm(t.double()))


def _gap(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def step_numbers(got, ref, lr):
    '''The gaps of set-up's steps (losses, fac0, fac1, facn) against the
    reference's:
      loss_gap    the largest |loss - ref| / ref over the steps;
      grad_gap    | |g| - |g_ref| | / |g_ref|, g = (fac0 - fac1) / lr;
      change_gap  | |facn - fac0| - |ref's| | / |ref's|.'''
    lp, p0, p1, pn = got
    lr_, r0, r1, rn = ref
    return {'loss_gap': max(_gap(a, b) for a, b in zip(lp, lr_)),
            'grad_gap': _gap(_norm((p0 - p1) / lr), _norm((r0 - r1) / lr)),
            'change_gap': _gap(_norm(pn - p0), _norm(rn - r0))}


def last_numbers(got, ref, lr):
    '''The gaps of the window's last step (loss, sample, before, after)
    against the reference's step from the same factors:
      last_loss_gap  |loss - ref| / ref;
      last_grad_gap  | |g| - |g_ref| | / |g_ref|, g = (before - after) / lr
                     (one step's change is lr g, so it is not compared
                     apart).'''
    lp, _, p0, p1 = got
    lr_, _, r0, r1 = ref
    return {'last_loss_gap': _gap(lp, lr_),
            'last_grad_gap': _gap(_norm((p0 - p1) / lr),
                                  _norm((r0 - r1) / lr))}


def check(st, window, limits):
    got = (st.losses, st.fac0, st.fac1, st.facn)
    inputs, dev = st.cell.inputs, st.dev
    del st.scene, st.target
    common.free(dev)
    target = reference_target(inputs, st.res, st.target_spp, dev)
    ref = reference_steps(inputs, st.materials, st.res, st.start, target,
                          len(st.losses), st.lr, dev)
    last = reference_last(inputs, st.materials, st.res, st.last, target,
                          st.lr, dev)
    return common.judged({**step_numbers(got, ref, st.lr),
                          **last_numbers(st.last, last, st.lr)}, limits)
