'''Host ms of the wavefront's casts a sample in the profiled segment: the
program's wavefront.cast spans (intersect/dispatch.cast_shaded and
cast_shadow), summed, over its render.sample spans, from
ptina_tpu_torch.utils.trace.summary().'''


def read(window):
    try:
        from ptina_tpu_torch.utils.trace import summary
    except ImportError:  # a program without the recorder
        return None
    got = summary()['traced']
    cast, sample = got.get('wavefront.cast'), got.get('render.sample')
    if not cast or not sample:
        return None
    return cast['host_ns'] * 1e-6 / sample['count']
