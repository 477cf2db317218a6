'''
Progressive film: a [passes, 4, nx, ny] accumulator whose channel 3
counts samples.

Reference: ptina_tpu/film.py.  Same channel-major layout.  The port
accumulates IN PLACE (film_add and film_splat return the film they were
given, updated): the reference returns a new value and donates the old
buffer, which is the same memory behaviour.
'''

import torch

__all__ = ['new_film', 'film_add', 'film_splat', 'film_to_image',
           'film_to_flat_rgb', 'PASS_COMBINED', 'PASS_ALBEDO', 'PASS_NORMAL',
           'DEBUG_PINK']

PASS_COMBINED = 0
PASS_ALBEDO = 1
PASS_NORMAL = 2

DEBUG_PINK = (0.9, 0.4, 0.9, 0.0)


def new_film(nx, ny, passes=3, device='cuda'):
    return torch.zeros((passes, 4, nx, ny), dtype=torch.float32,
                       device=device)


def film_add(film, pass_id, r, g, b, w):
    '''Add per-pixel contributions into one pass, in place.  r/g/b/w:
    [nx, ny] or [nx * ny] (row-major over (x, y), the pixel_grid order).'''
    nx, ny = film.shape[2], film.shape[3]
    film[pass_id] += torch.stack([c.reshape(nx, ny) for c in (r, g, b, w)])
    return film


def film_splat(film, pass_id, xi, yi, r, g, b, w):
    '''Scatter-add arbitrary splats into one pass, in place (for MLT): xi,
    yi [N] integer pixel coordinates, clipped to the film as the reference
    clips them; r/g/b/w [N].  One index_put_(accumulate=True) of the [N, 4]
    rows into the pass seen as [nx, ny, 4].  The add order is fixed, so
    the film is the same bits on every run: on the CPU the splats add in
    index order; on the card PyTorch's accumulating index_put_ sorts the
    pixel indices (a stable radix sort) and adds each pixel's splats in a
    fixed order, with no atomics.'''
    nx, ny = film.shape[2], film.shape[3]
    xi = torch.clamp(xi, 0, nx - 1).long()
    yi = torch.clamp(yi, 0, ny - 1).long()
    rgbw = torch.stack([r, g, b, w], dim=-1)
    film[pass_id].permute(1, 2, 0).index_put_((xi, yi), rgbw,
                                              accumulate=True)
    return film


def film_to_image(film, pass_id=0):
    '''Normalize a pass to an [nx, ny, 4] image; empty pixels become the
    reference's debug pink.'''
    val = film[pass_id].permute(1, 2, 0)
    w = val[..., 3:4]
    has = w != 0.0
    rgb = torch.where(has, val[..., :3] / torch.where(has, w, 1.0), 0.0)
    out = torch.cat([rgb, has.to(val.dtype)], dim=-1)
    pink = torch.tensor(DEBUG_PINK, dtype=val.dtype, device=val.device)
    return torch.where(has, out, pink)


def film_to_flat_rgb(film, pass_id=0):
    '''The viewport export: pass `pass_id` normalised by its sample count
    as a flat [ny * nx * 3] float32 buffer in scanline (y-major) order, on
    the film's device.  Empty pixels export 0 (black, not debug pink).'''
    val = film[pass_id]  # [4, nx, ny]
    w = val[3]
    has = w != 0.0
    rgb = torch.where(has[None], val[:3] / torch.where(has, w, 1.0)[None],
                      0.0)
    return rgb.permute(2, 1, 0).reshape(-1)
