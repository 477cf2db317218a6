'''The texel gathers' backward kernel against its roofline, in percent,
in the profiled segment: the bytes any implementation moves, 16 a lane
walked (its cotangent row, read to learn whether it is zero) and 24 a
lane with a nonzero row (its texel's three int64 indices), over the
card's memory rate, against the stream time between the markers of the
program's grad.texel_rows.kernels spans, which hold the kernel's
launches and nothing else of the backward (the wrapper's allocations and
checks stay outside; where the device waits on the host, the launch call
itself still counts).  The lanes are the program's texel_rows counter
(lanes walked, lanes with a nonzero cotangent row, distinct texels
written), both read from ptina_tpu_torch.utils.trace.summary().  The
atlas written is left out, which only lowers the bound.'''

from perfbench.harness.peaks import peak


def read(window):
    try:
        from ptina_tpu_torch.utils.trace import summary
    except ImportError:  # a program without the recorder
        return None
    got = summary()
    span = got['traced'].get('grad.texel_rows.kernels')
    counts = got.get('counts', {}).get('texel_rows')
    pk = peak(window.get('device_kind', ''))
    if not span or not span['device_ns'] or not counts or pk is None:
        return None
    lanes, live = counts[0], counts[1]
    bound_s = (16 * lanes + 24 * live) / pk['hbm_bytes']
    return 100.0 * bound_s / (span['device_ns'] * 1e-9)
