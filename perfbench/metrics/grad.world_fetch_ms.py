'''Device ms a step of the world fetch in the profiled segment: the
stream time between the markers of the program's world.fetch spans
(engine/path._bounce's eager environment lookup, one a bounce of the
gradient's recompute; an inverse cell's forward is the megakernel, so
every such span lies inside grad.recompute), summed, over its grad.step
spans, from ptina_tpu_torch.utils.trace.summary().  Nothing where the
program has no world.fetch span.'''


def read(window):
    try:
        from ptina_tpu_torch.utils.trace import summary
    except ImportError:  # a program without the recorder
        return None
    got = summary()['traced']
    part, step = got.get('world.fetch'), got.get('grad.step')
    if not part or not step or part['device_ns'] is None:
        return None
    return part['device_ns'] * 1e-6 / step['count']
