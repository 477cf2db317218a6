'''Inner box-tree nodes the blocked casts' walks visit a cast in the
profiled segment (a parked shadow ray is a cast): the program's walk
counters (ptina_tpu_torch.utils.trace.walk_buffer('blocked_casts', ...),
filled by each launch while tracing is on), inner nodes over casts.'''


def read(window):
    try:
        from ptina_tpu_torch.utils.trace import summary
    except ImportError:  # a program without the recorder
        return None
    got = summary()['walks'].get('blocked_casts')
    if not got or not got['casts']:
        return None
    return got['inner'] / got['casts']
