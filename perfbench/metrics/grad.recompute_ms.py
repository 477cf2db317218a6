'''Device ms a step of the backward's recompute in the profiled segment:
the stream time between the markers of the program's grad.recompute
spans (FusedTraceDiff.backward's path_trace under autograd, host-bound
eager work), summed, over its grad.step spans, from
ptina_tpu_torch.utils.trace.summary().'''


def read(window):
    try:
        from ptina_tpu_torch.utils.trace import summary
    except ImportError:  # a program without the recorder
        return None
    got = summary()['traced']
    part, step = got.get('grad.recompute'), got.get('grad.step')
    if not part or not step or part['device_ns'] is None:
        return None
    return part['device_ns'] * 1e-6 / step['count']
