'''The share, in percent, of the lanes the world fetch looks up whose
environment radiance enters the result (alive and missing every
surface), in the profiled segment: the program's `world` counter
(ptina_tpu_torch.utils.trace.add_counts, from engine/path._bounce while
tracing is on: lanes fetched, lanes entering, distinct environment
texels those lanes read, the environment's texels), read from
summary().  Nothing where the program keeps no such counter.'''


def read(window):
    try:
        from ptina_tpu_torch.utils.trace import summary
    except ImportError:  # a program without the recorder
        return None
    got = summary().get('counts', {}).get('world')
    if not got or not got[0]:
        return None
    return 100.0 * got[1] / got[0]
