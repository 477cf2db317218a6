'''
Tone mapping operators for film post-processing.

Reference: ptina_tpu/tone.py (the reference's unwired ToneMapping
experiment, ptina/wip/tonemapping.py:15-18, finished there).  Pure
functions over image tensors ([..., 3], e.g. film_to_image's rgb), applied
after film_to_image.
'''

import torch

__all__ = ['tonemap_filmic', 'tonemap_aces', 'apply_exposure_gamma']


def apply_exposure_gamma(rgb, exposure=1.0, gamma=2.2):
    '''Linear exposure scale followed by display gamma.'''
    v = torch.clamp_min(rgb * exposure, 0.0)
    return v ** (1.0 / gamma)


def tonemap_filmic(rgb, exposure=1.0):
    '''Hejl-Burgess-style filmic curve (the curve embeds an sRGB-like toe:
    no separate gamma).'''
    v = torch.clamp_min(rgb * exposure - 0.004, 0.0)
    return (v * (6.2 * v + 0.5)) / (v * (6.2 * v + 1.7) + 0.06)


def tonemap_aces(rgb, exposure=1.0):
    '''Narkowicz ACES approximation, then gamma 2.2.'''
    v = torch.clamp_min(rgb * exposure, 0.0)
    mapped = (v * (2.51 * v + 0.03)) / (v * (2.43 * v + 0.59) + 0.14)
    return torch.clamp(mapped, 0.0, 1.0) ** (1.0 / 2.2)
