'''
A small PNG codec on the standard library (zlib + struct) and numpy.

The reference reads glTF images and writes its examples' snapshots
through PIL (ptina_tpu/io/readgltf.py:105-116, examples/*.py); the port
has this module instead, so it needs no imaging package on a machine
that has none.

decode(data) gives exactly the array np.array(PIL.Image.open(f)) gives
for a non-interlaced 8-bit PNG: [H, W] uint8 for grey, [H, W, 2 / 3 / 4]
for grey+alpha, RGB and RGBA, and for a palette image its indices [H, W]
(PIL's mode 'P'), not the palette's colours.  Any other bit depth, and
interlaced images, raise ValueError naming the limit.  Filter types 0-4
are undone row by row: None, Sub and Up vectorised in numpy, Average and
Paeth byte by byte in Python (fast enough for texture sizes; a decoder
for large photographs is not the point here).

encode(img) writes an 8-bit RGB or RGBA image [H, W, 3 / 4] with filter
type 0 on every row.
'''

import struct
import zlib

import numpy as np

__all__ = ['SIGNATURE', 'decode', 'encode', 'write']

SIGNATURE = b'\x89PNG\r\n\x1a\n'
# colour type -> channels (0 grey, 2 RGB, 3 palette indices, 4 grey+alpha,
# 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data):
    '''(type, body) of every chunk, each CRC checked.'''
    off = len(SIGNATURE)
    while off + 12 <= len(data):
        length, ctype = struct.unpack('>I4s', data[off:off + 8])
        body = data[off + 8:off + 8 + length]
        (crc,) = struct.unpack('>I', data[off + 8 + length:off + 12 + length])
        if len(body) != length or zlib.crc32(ctype + body) != crc:
            raise ValueError(f'PNG chunk {ctype!r} is truncated or corrupt')
        yield ctype, body
        if ctype == b'IEND':
            return
        off += 12 + length
    raise ValueError('PNG ends without an IEND chunk')


def _average(line, prior, bpp):
    cur = bytearray(line)
    for i in range(bpp):
        cur[i] = (cur[i] + (prior[i] >> 1)) & 0xFF
    for i in range(bpp, len(cur)):
        cur[i] = (cur[i] + ((cur[i - bpp] + prior[i]) >> 1)) & 0xFF
    return cur


def _paeth(line, prior, bpp):
    cur = bytearray(line)
    for i in range(bpp):  # a = c = 0: the predictor is b
        cur[i] = (cur[i] + prior[i]) & 0xFF
    for i in range(bpp, len(cur)):
        a, b, c = cur[i - bpp], prior[i], prior[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return cur


def decode(data):
    '''PNG bytes -> the uint8 array PIL gives (module docstring).'''
    data = bytes(data)
    if data[:8] != SIGNATURE:
        raise ValueError('not a PNG file')
    header, idat = None, []
    for ctype, body in _chunks(data):
        if ctype == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif ctype == b'IDAT':
            idat.append(body)
    if header is None:
        raise ValueError('PNG has no IHDR chunk')
    w, h, depth, color, comp, filt, interlace = header
    if depth != 8 or color not in _CHANNELS:
        raise ValueError(f'PNG bit depth {depth}, colour type {color}: only '
                         f'8-bit grey, grey+alpha, RGB, RGBA and palette '
                         f'images are decoded')
    if interlace != 0:
        raise ValueError('interlaced PNG: only non-interlaced images are '
                         'decoded')
    if comp != 0 or filt != 0:
        raise ValueError(f'PNG compression {comp} / filter method {filt}')
    bpp = _CHANNELS[color]
    stride = w * bpp
    raw = zlib.decompress(b''.join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f'PNG image data holds {len(raw)} bytes, expected '
                         f'{h * (stride + 1)}')
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum of each channel, mod 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            cur = line + prior
        elif ftype == 3:
            cur = np.frombuffer(_average(line.tobytes(), prior.tobytes(),
                                         bpp), np.uint8)
        elif ftype == 4:
            cur = np.frombuffer(_paeth(line.tobytes(), prior.tobytes(),
                                       bpp), np.uint8)
        else:
            raise ValueError(f'PNG row {y} has filter type {ftype}')
        out[y] = cur
        prior = out[y]
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


def _chunk(ctype, body):
    return (struct.pack('>I', len(body)) + ctype + body
            + struct.pack('>I', zlib.crc32(ctype + body)))


def encode(img):
    '''uint8 [H, W, 3] (RGB) or [H, W, 4] (RGBA), rows top to bottom ->
    PNG bytes.'''
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f'encode takes uint8 [H, W, 3 or 4], not '
                         f'{img.dtype} {img.shape}')
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                          axis=1)
    ihdr = struct.pack('>IIBBBBB', w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (SIGNATURE + _chunk(b'IHDR', ihdr)
            + _chunk(b'IDAT', zlib.compress(rows.tobytes(), 6))
            + _chunk(b'IEND', b''))


def write(path, img):
    '''encode(img) into the file `path`.'''
    with open(path, 'wb') as f:
        f.write(encode(img))
