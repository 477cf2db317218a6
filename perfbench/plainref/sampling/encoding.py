'''
Reference: ptina_tpu/io/encoding.py (copied: numpy-only host code, so the port needs no
JAX to run it).

numpy <-> compressed base85 text codec for embedding binary assets
(e.g. Sobol direction tables, small textures) directly in .py files.

Counterpart of the reference's array embed codec
(ptina/tools/encoding.py:10-36).  Format: a one-line header
"dtype|shape" followed by zlib-compressed raw bytes in base85,
wrapped to 78 columns so the result is diff- and editor-friendly.
'''

import base64
import zlib

import numpy as np

__all__ = ['encode_numpy_array', 'decode_numpy_array']

_WRAP = 78


def encode_numpy_array(arr, level=9):
    '''array -> ascii text block.'''
    arr = np.ascontiguousarray(arr)
    header = f'{arr.dtype.str}|{",".join(map(str, arr.shape))}'
    payload = base64.b85encode(zlib.compress(arr.tobytes(), level)).decode('ascii')
    lines = [header] + [payload[i:i + _WRAP]
                        for i in range(0, len(payload), _WRAP)]
    return '\n'.join(lines)


def decode_numpy_array(text):
    '''ascii text block -> array.'''
    lines = text.strip().split('\n')
    # dtype.str itself may start with '|' (byte-order-free dtypes like
    # '|u1'), so split the header on the LAST separator only
    dtype_str, shape_str = lines[0].rsplit('|', 1)
    shape = tuple(int(s) for s in shape_str.split(',')) if shape_str else ()
    raw = zlib.decompress(base64.b85decode(''.join(lines[1:])))
    return np.frombuffer(raw, dtype=np.dtype(dtype_str)).reshape(shape).copy()
