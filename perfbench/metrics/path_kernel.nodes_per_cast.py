'''Inner box-tree nodes the path megakernel's walks visit a cast in the
profiled segment: the program's walk counters (ptina_tpu_torch.utils.
trace.walk_buffer('path_kernel', ...), filled by one launch in
engine/fused.WALK_EVERY while tracing is on), inner nodes over casts
made.'''


def read(window):
    try:
        from ptina_tpu_torch.utils.trace import summary
    except ImportError:  # a program without the recorder
        return None
    got = summary()['walks'].get('path_kernel')
    if not got or not got['casts']:
        return None
    return got['inner'] / got['casts']
