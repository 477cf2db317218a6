'''The share, in percent, of the environment map's texels that one world
fetch's entering lanes read through its four texel gathers, over the
fetches of the profiled segment (distinct texels a fetch, summed, over
the map's texels a fetch, summed): how much of the 33.5 MB gradient each
texel backward writes is not zero.  From the program's `world` counter
(world.miss_share's), read from summary(); nothing where the world is
untextured or the program keeps no such counter.'''


def read(window):
    try:
        from ptina_tpu_torch.utils.trace import summary
    except ImportError:  # a program without the recorder
        return None
    got = summary().get('counts', {}).get('world')
    if not got or len(got) < 4 or not got[3]:
        return None
    return 100.0 * got[2] / got[3]
