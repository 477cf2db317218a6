'''
Material models: elementwise torch functions over ray batches.

Reference: ptina_tpu/materials/__init__.py.  `choice_split` is the
branchless stream-splitting lobe selector (reference Choice,
ptina/materials/__init__.py:21-48): one uniform drives the whole decision
tree, remapped after each test, while the discrete pdf is tracked.
'''

import torch

from perfbench.plainref.mathutils import clamp_min

__all__ = ['choice_split']


def choice_split(w, rate, tiny=1e-12):
    '''One stream-splitting decision.  w: [N] uniforms in [0, 1); rate:
    [N] branch probability.  Returns (taken mask, remapped w, pdf factor:
    rate where taken else 1 - rate).'''
    taken = w < rate
    safe_r = clamp_min(rate, tiny)
    safe_1r = clamp_min(1.0 - rate, tiny)
    w2 = torch.where(taken, w / safe_r, (w - rate) / safe_1r)
    pdf = torch.where(taken, rate, 1.0 - rate)
    return taken, w2, pdf
