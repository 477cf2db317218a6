'''Lanes the texel gathers' backward walks per distinct texel it writes,
in the profiled segment (each backward's lanes over its distinct texels,
both summed over the backwards): the length of the serial walk over a
texel's lanes in PyTorch's sort path, from the program's texel_rows
counter (texture.live_lane_share's), read from summary().'''


def read(window):
    try:
        from ptina_tpu_torch.utils.trace import summary
    except ImportError:  # a program without the recorder
        return None
    got = summary().get('counts', {}).get('texel_rows')
    if not got or not got[2]:
        return None
    return got[0] / got[2]
