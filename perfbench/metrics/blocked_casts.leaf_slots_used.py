'''The share of a warp's leaf tests that do a lane's work, in the
profiled segment: the program's walk counters (ptina_tpu_torch.utils.
trace.walk_buffer('blocked_casts', ...), every launch), 100 x the
leaves the lanes tested over 32 x the most any lane of the warp tested,
summed over the warps and casts.'''


def read(window):
    try:
        from ptina_tpu_torch.utils.trace import summary
    except ImportError:  # a program without the recorder
        return None
    got = summary()['walks'].get('blocked_casts')
    if not got or not got['leaf_slots']:
        return None
    return 100.0 * got['leaves'] / got['leaf_slots']
