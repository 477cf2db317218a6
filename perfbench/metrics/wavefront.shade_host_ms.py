'''Host ms of the wavefront's shading a sample in the profiled segment:
the self time (host time less its casts') of the program's
wavefront.bounce spans (engine/path._bounce), summed, over its
render.sample spans, from ptina_tpu_torch.utils.trace.summary().'''


def read(window):
    try:
        from ptina_tpu_torch.utils.trace import summary
    except ImportError:  # a program without the recorder
        return None
    got = summary()['traced']
    bounce, sample = got.get('wavefront.bounce'), got.get('render.sample')
    if not bounce or not sample:
        return None
    return bounce['self_ns'] * 1e-6 / sample['count']
