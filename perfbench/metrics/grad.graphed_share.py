'''The share, in percent, of the backward's shading segments that ran as
a CUDA graph's replay in the profiled segment: the program's
grad.shade.replay spans over its grad.shade spans (engine/fused.py: one
grad.shade a shading segment of the recompute, a grad.shade.replay
inside it where a captured graph replays), from
ptina_tpu_torch.utils.trace.summary().'''


def read(window):
    try:
        from ptina_tpu_torch.utils.trace import summary
    except ImportError:  # a program without the recorder
        return None
    got = summary()['traced']
    shade, replay = got.get('grad.shade'), got.get('grad.shade.replay')
    if not shade or not shade['count']:
        return None
    return 100.0 * (replay['count'] if replay else 0) / shade['count']
