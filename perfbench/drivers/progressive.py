'''
Progressive rendering, closed loop: frame after frame of `spp` samples
through the program's engine.path.render into one film, the sample index
running on from a start drawn from the seed, each frame ended by one
readback of the film's combined pass to the host (what a progressive
viewer shows).  The traffic file gives spp and the profiled segment's
length.

The check: the first and the last frame of the window, at pixels drawn
from the seed, against the plain reference's sum of the same samples
(perfbench/plainref), which builds its own scene from the same inputs.
'''

import time

import numpy as np
import torch

from perfbench.drivers import common


# the loop's start frame is drawn below START_FRAMES; the check reads
# CHECK_PIXELS pixels drawn from the seed
START_FRAMES = 4096
CHECK_PIXELS = 2048


class State:
    pass


def setup(cell):
    from ptina_tpu_torch.engine.path import render
    from ptina_tpu_torch.film import new_film
    st = State()
    st.cell, st.dev = cell, cell.device
    st.res = int(cell.config['res'])
    st.spp = int(cell.traffic['spp'])
    st.scene = common.program_scene(cell.inputs, st.dev)
    st.render = render
    st.start = st.spp * (cell.seed % START_FRAMES)
    warm = new_film(st.res, st.res, device=st.dev)
    render(st.scene, warm, st.start, spp=st.spp)  # builds the kernels
    warm[0].cpu()
    st.film = new_film(st.res, st.res, device=st.dev)
    rng = np.random.default_rng([cell.seed, 1])
    k = min(CHECK_PIXELS, st.res * st.res)
    st.pixels = np.sort(rng.choice(st.res * st.res, k, replace=False))
    return st


def _frame(st, k, film):
    st.render(st.scene, film, st.start + k * st.spp, spp=st.spp)
    return film[0].to('cpu', copy=True)


def window(st, seconds, traced, units=None):
    '''Frames until `seconds` have passed (or, given, `units` frames);
    returns the window's readings.'''
    from torch.profiler import record_function
    frames, first, prev, last = 0, None, None, None
    with common.kernel_events(traced) as ev:
        t0 = time.perf_counter()
        while True:
            with record_function('frame'):
                img = _frame(st, frames, st.film)
            frames += 1
            prev, last = last, img
            if first is None:
                first = img
            if (frames >= units if units is not None
                    else time.perf_counter() - t0 >= seconds):
                break
        elapsed = time.perf_counter() - t0
    st.frames = {0: first}
    if frames > 1:
        st.frames[frames - 1] = (prev, last)
    finite = bool(torch.isfinite(last).all())
    out = dict(attempted=frames, failed=0 if finite else frames,
               units=frames, samples=frames * st.spp, window_s=elapsed)
    out.update(common.kernel_readings(ev))
    return out


def unit(st):
    '''One more frame of the loop (the traced run's profiled segment).'''
    from ptina_tpu_torch.film import new_film
    film = new_film(st.res, st.res, device=st.dev)
    count = [0]

    def one():
        _frame(st, count[0], film)
        count[0] += 1
    return one


def at_pixels(frames, pixels, res):
    '''{frame: (before, after)}, each [4, K] float32 at the pixels, of
    {frame: readback after it, or (readback before, readback after)}.'''
    ii = torch.as_tensor(pixels // res)
    jj = torch.as_tensor(pixels % res)
    out = {}
    for f, img in frames.items():
        before, after = img if isinstance(img, tuple) else (None, img)
        after = after[:, ii, jj].to(torch.float32)
        before = torch.zeros_like(after) if before is None \
            else before[:, ii, jj].to(torch.float32)
        out[f] = (before, after)
    return out


def judge(got, ref_scene, pixels, res, start, spp, dev, round_to=None):
    '''The largest of each number over the frames of got ({frame:
    (before, after)}) against the reference (round_to: the control's).'''
    worst = {}
    for f, (before, after) in got.items():
        ref = common.reference_sums(ref_scene, pixels, res, start + f * spp,
                                    spp, dev, round_to=round_to, base=before)
        for name, v in common.frame_numbers(after, ref, before, spp).items():
            worst[name] = max(worst.get(name, 0.0), v)
    return worst


def check(st, window, limits):
    '''The numbers compared, each with its limit.'''
    got = at_pixels(st.frames, st.pixels, st.res)
    del st.scene, st.film  # the program's state, before the reference
    common.free(st.dev)
    ref_scene = common.reference_scene(st.cell.inputs, st.dev)
    return common.judged(judge(got, ref_scene, st.pixels, st.res, st.start,
                               st.spp, st.dev), limits)
