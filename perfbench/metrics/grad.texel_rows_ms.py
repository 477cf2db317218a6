'''Device ms a step of the texel gathers' backward in the profiled
segment: the stream time between the markers of the program's
grad.texel_rows spans (texture.texel_rows_backward, the index_put_ of
each of a textured fetch's four gathers), summed, over its grad.step
spans, from ptina_tpu_torch.utils.trace.summary().'''


def read(window):
    try:
        from ptina_tpu_torch.utils.trace import summary
    except ImportError:  # a program without the recorder
        return None
    got = summary()['traced']
    part, step = got.get('grad.texel_rows'), got.get('grad.step')
    if not part or not step or part['device_ns'] is None:
        return None
    return part['device_ns'] * 1e-6 / step['count']
