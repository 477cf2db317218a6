'''
The reference's examples (examples/*.py), ported: each is runnable as

    python -m ptina_tpu_torch.examples.<name>

and keeps its work in a main(...) whose defaults are the reference
script's sizes, on the card.  Each prints what the reference prints and
writes its PNGs (through io._png) into `out_dir`, the system's temporary
directory by default.  benchmark.py runs the port's own benchmark
harness, ptina_tpu_torch.bench (the counterpart of the JAX package's root
bench.py), and writes no PNG.
'''

import os.path
import tempfile

import numpy as np

from ptina_tpu_torch.io import _png

__all__ = ['gamma_rgb', 'out_path', 'save_png']


def gamma_rgb(img):
    '''The RGB of a film image [nx, ny, 4] clipped to [0, 1], gamma 2.2.'''
    return np.clip(img[..., :3], 0, 1) ** (1 / 2.2)


def save_png(path, rgb01):
    '''A film-axis [nx, ny, 3] image in [0, 1] as an 8-bit PNG (rows are y,
    top row first), as the reference examples save through PIL.'''
    arr = (np.clip(rgb01, 0, 1) * 255).astype(np.uint8)
    _png.write(path, arr.transpose(1, 0, 2)[::-1])


def out_path(out_dir, name):
    '''`name` in out_dir (None: the system's temporary directory).'''
    return os.path.join(out_dir or tempfile.gettempdir(), name)
