'''The share, in percent, of the lanes the texel gathers' backward walks
whose cotangent row is nonzero, in the profiled segment: the program's
texel_rows counter (ptina_tpu_torch.utils.trace.add_counts, from
texture.texel_rows_backward while tracing is on: lanes walked, lanes
with a nonzero cotangent row, distinct texels written), read from
summary().'''


def read(window):
    try:
        from ptina_tpu_torch.utils.trace import summary
    except ImportError:  # a program without the recorder
        return None
    got = summary().get('counts', {}).get('texel_rows')
    if not got or not got[0]:
        return None
    return 100.0 * got[1] / got[0]
