'''
What the drivers share: the program's and the reference's scene builds
from the same host inputs, the reference's frame sums, the numbers a
frame is judged by, and the traced run's kernel events.
'''

import contextlib

import torch


def program_scene(inputs, dev, materials=None):
    '''The program's scene (ptina_tpu_torch.scene.make_scene) from the
    harness's host inputs.'''
    from ptina_tpu_torch.scene import make_scene
    return make_scene(inputs['vertices'], inputs['mtlids'],
                      materials=materials or inputs['materials'],
                      lights=inputs['lights'], cam_pers=inputs['cam_pers'],
                      world_fac=inputs['world_fac'], device=dev)


def reference_scene(inputs, dev, materials=None, round_to=None):
    from perfbench.plainref.scene import make_scene
    return make_scene(inputs['vertices'], inputs['mtlids'],
                      materials or inputs['materials'], inputs['lights'],
                      inputs['cam_pers'], world_fac=inputs['world_fac'],
                      device=dev, round_to=round_to)


def free(dev):
    import gc
    gc.collect()
    if dev == 'cuda':
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def reference_sums(scene, pixels, res, start, spp, dev, round_to=None,
                   base=None, batch=1 << 16):
    '''[4, K] float32: the plain reference's film sums at the pixels (flat
    ids i * res + j) of `spp` samples from `start`, added one sample after
    another in float32 onto `base` ([4, K], the film's values before the
    frame; zeros without it) as the program's film adds them; channel 3
    counts samples.'''
    px = torch.as_tensor(pixels, dtype=torch.int64)
    ii = (px // res).to(torch.int32).to(dev)
    jj = (px % res).to(torch.int32).to(dev)
    k = px.shape[0]
    acc = (torch.zeros((4, k), dtype=torch.float32, device=dev)
           if base is None else base.to(dev, torch.float32).clone())
    per = max(1, batch // k)
    with torch.no_grad():
        for s0 in range(0, spp, per):
            ss = list(range(s0, min(spp, s0 + per)))
            rad = _batched(scene, ii, jj, res, [start + s for s in ss],
                           round_to)
            for r in rad:
                acc[0] += r[0]
                acc[1] += r[1]
                acc[2] += r[2]
                acc[3] += 1.0
    return acc.cpu()


def _batched(scene, ii, jj, res, samples, round_to):
    '''Radiance [3, K] for each sample index, the samples' rays traced as
    one batch (a path's arithmetic is per ray, so batching changes no
    bit).'''
    from perfbench.plainref.camera import camera_rays
    from perfbench.plainref.path import PATH_DIMS, path_trace
    from perfbench.plainref.sampling.sobol import sample_dims
    us = [sample_dims(s, ii, jj, PATH_DIMS) for s in samples]
    u = torch.cat(us, dim=1)
    i2, j2 = ii.repeat(len(samples)), jj.repeat(len(samples))
    x = (i2.to(torch.float32) + u[0]) / res * 2.0 - 1.0
    y = (j2.to(torch.float32) + u[1]) / res * 2.0 - 1.0
    ro, rd = camera_rays(scene.cam_v2w, x, y)
    if round_to is not None:
        from perfbench.plainref.path import _rounded
        ro, rd = _rounded(ro, round_to), _rounded(rd, round_to)
    rad = path_trace(scene, ro, rd, u, round_to=round_to)
    k = ii.shape[0]
    return [torch.stack([c[n * k:(n + 1) * k] for c in (rad.x, rad.y,
                                                         rad.z)])
            for n in range(len(samples))]


def frame_numbers(got, ref, base, spp):
    '''The numbers one frame is judged by: the program's film values after
    it, got [4, K], against the reference's, ref (its sums added onto the
    same values before the frame, base, so that both round alike):
      count_err  the largest gap in the sample count (exact: 0);
      rel_l1     the summed |gap| of the radiance over the summed |ref -
                 base| (the reference's frame);
      px_off     the share of pixels whose radiance is off by more than
                 1e-3 of max(|ref - base|, 0.05 spp) in a channel.'''
    got, ref, base = got.double(), ref.double(), base.double()
    count_err = float((got[3] - ref[3]).abs().max())
    gap = (got[:3] - ref[:3]).abs()
    if not bool(torch.isfinite(got[:3]).all()):
        return {'count_err': count_err, 'rel_l1': float('inf'),
                'px_off': 1.0}
    frame = (ref[:3] - base[:3]).abs()
    rel_l1 = float(gap.sum() / max(float(frame.sum()), 1e-30))
    tol = 1e-3 * torch.clamp_min(frame, 0.05 * spp)
    px_off = float((gap > tol).any(0).double().mean())
    return {'count_err': count_err, 'rel_l1': rel_l1, 'px_off': px_off}


def judged(values, limits):
    '''{name: {value, limit}} for the numbers that have a limit; the
    others are printed on an earlier line of standard error.'''
    import sys
    shown = {k: v for k, v in values.items() if k not in limits['compare']}
    if shown:
        print(f'perfbench: not compared: {shown}', file=sys.stderr)
    return {k: {'value': values[k], 'limit': float(limits['compare'][k])}
            for k in limits['compare']}


@contextlib.contextmanager
def kernel_events(traced):
    '''The traced run's kernel events (perfbench/harness/trace.py), or
    nothing.'''
    if not traced:
        yield None
        return
    from perfbench.harness.trace import KernelEvents
    with KernelEvents() as ev:
        yield ev


def kernel_readings(ev):
    '''The window's device ms of each traced kernel family.'''
    if ev is None:
        return {}
    out = {}
    for key, kernels in (('path_ms', ('path_kernel',)),
                         ('blocked_ms', ('blocked_shade_kernel',
                                         'blocked_any_kernel'))):
        ms, n = ev.ms(kernels)
        if n:
            out[key], out[key + '_launches'] = ms, n
    return out
