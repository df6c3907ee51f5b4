"""Flow rendering, PNG files and the caption font, with numpy and the
standard library alone.

The port's copy of ``dvs_of_training_framework_tpu/utils/visualization.py``
(``_hsv_to_bgr``, ``flow2img``: flow -> HSV -> BGR, angle as hue,
min-max normalised magnitude as value), and what the root ``visualize.py``
takes from Pillow, without Pillow (the card's machine may lack it):

- ``write_png`` and ``read_png``: 8-bit RGB PNG files, every row stored
  with filter 0 (none) and compressed with ``zlib``; the reader reads
  exactly that layout and refuses any other;
- ``draw_text``: a caption in a fixed 5x7 bitmap font for printable
  ASCII (``GLYPHS`` below).  The root CLI draws its banner with
  Pillow's default font, which depends on how Pillow was built, so the
  port's banner pixels are its own, and the same on every machine.
"""
import os
import struct
import zlib
from pathlib import Path

import numpy as np


def _hsv_to_bgr(h, s, v):
    """Vectorised HSV->BGR for uint8 images (h in [0,180) cv2 convention)."""
    h = h.astype(np.float32) * 2.0          # to degrees [0, 360)
    s = s.astype(np.float32) / 255.0
    v = v.astype(np.float32)
    c = v * s
    hp = h / 60.0
    x = c * (1 - np.abs(hp % 2 - 1))
    z = np.zeros_like(c)
    conds = [(0 <= hp) & (hp < 1), (1 <= hp) & (hp < 2),
             (2 <= hp) & (hp < 3), (3 <= hp) & (hp < 4),
             (4 <= hp) & (hp < 5), (5 <= hp)]
    rs = np.select(conds, [c, x, z, z, x, c])
    gs = np.select(conds, [x, c, c, x, z, z])
    bs = np.select(conds, [z, z, x, c, c, x])
    m = v - c
    bgr = np.stack([bs + m, gs + m, rs + m], axis=-1)
    return np.clip(bgr, 0, 255).astype(np.uint8)


def flow2img(flow_x, flow_y):
    """Render a flow field as a BGR uint8 image (hue=direction, val=mag)."""
    flows = np.stack((flow_x, flow_y), axis=2)
    mag = np.linalg.norm(flows, axis=2)

    ang = np.arctan2(flow_y, flow_x)
    ang += np.pi
    ang *= 180. / np.pi / 2.
    ang = ang.astype(np.uint8)
    # min-max normalisation of the magnitude (cv2.NORM_MINMAX semantics)
    mag_min, mag_max = mag.min(), mag.max()
    if mag_max > mag_min:
        val = (mag - mag_min) / (mag_max - mag_min) * 255.0
    else:
        val = np.zeros_like(mag)
    sat = np.full_like(ang, 255, dtype=np.uint8)
    return _hsv_to_bgr(ang, sat, val)


# --- PNG ----------------------------------------------------------------------

_SIGNATURE = b'\x89PNG\r\n\x1a\n'
# IHDR: bit depth 8, colour type 2 (RGB), deflate, no interlace
_RGB8 = (8, 2, 0, 0, 0)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data)))


def encode_png(image) -> bytes:
    """The bytes of an 8-bit RGB PNG of ``image`` ([H, W, 3] uint8)."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f'encode_png: a [H, W, 3] uint8 image, got '
                         f'{image.dtype} {image.shape}')
    height, width = image.shape[:2]
    rows = np.zeros((height, 1 + 3 * width), np.uint8)  # filter byte 0
    rows[:, 1:] = image.reshape(height, 3 * width)
    return (_SIGNATURE
            + _chunk(b'IHDR', struct.pack('>II5B', width, height, *_RGB8))
            + _chunk(b'IDAT', zlib.compress(rows.tobytes()))
            + _chunk(b'IEND', b''))


def write_png(path, image):
    """Write ``image`` ([H, W, 3] uint8, RGB) as a PNG file.  The file
    appears under its name whole or not at all."""
    path = Path(path)
    partial = path.with_name(path.name + '.partial')
    partial.write_bytes(encode_png(image))
    os.replace(partial, path)


def decode_png(data: bytes) -> np.ndarray:
    """The [H, W, 3] uint8 image of an 8-bit RGB PNG whose rows all use
    filter 0, as ``encode_png`` writes them."""
    if data[:8] != _SIGNATURE:
        raise ValueError('not a PNG file')
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack('>I', data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack('>I', data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or crc != zlib.crc32(kind + body):
            raise ValueError(f'PNG chunk {kind!r}: truncated or bad CRC')
        pos += 12 + length
        if kind == b'IHDR':
            header = struct.unpack('>II5B', body)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    if header is None or header[2:] != _RGB8:
        raise ValueError(f'PNG header {header}: only 8-bit RGB, not '
                         'interlaced, is read')
    width, height = header[:2]
    rows = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    rows = rows.reshape(height, 1 + 3 * width)
    if rows[:, 0].any():
        raise ValueError('PNG rows with a filter other than 0 (none)')
    return rows[:, 1:].reshape(height, width, 3).copy()


def read_png(path) -> np.ndarray:
    return decode_png(Path(path).read_bytes())


# --- caption font -------------------------------------------------------------

GLYPH_W, GLYPH_H = 5, 7
ADVANCE, LINE_HEIGHT = GLYPH_W + 1, GLYPH_H + 4
# printable ASCII from ' ' (32) to '~' (126): each glyph 7 rows of 5 bits
# (the leftmost pixel the highest bit), 2 hex digits a row
_GLYPH_HEX = (
    '00000000000000 04040404040004 0A0A0A00000000 0A0A1F0A1F0A0A '
    '040F140E051E04 18190204081303 0C12140815120D 0C040800000000 '
    '02040808080402 08040202020408 0004150E150400 0004041F040400 '
    '000000000C0408 0000001F000000 00000000000C0C 00010204081000 '
    '0E11131519110E 040C040404040E 0E11010204081F 1F02040201110E '
    '02060A121F0202 1F101E0101110E 0608101E11110E 1F010204080808 '
    '0E11110E11110E 0E11110F01020C 000C0C000C0C00 000C0C000C0408 '
    '02040810080402 00001F001F0000 08040201020408 0E110102040004 '
    '0E11010D15150E 0E1111111F1111 1E11111E11111E 0E11101010110E '
    '1C12111111121C 1F10101E10101F 1F10101E101010 0E11101711110F '
    '1111111F111111 0E04040404040E 0702020202120C 11121418141211 '
    '1010101010101F 111B1515111111 11111915131111 0E11111111110E '
    '1E11111E101010 0E11111115120D 1E11111E141211 0F10100E01011E '
    '1F040404040404 1111111111110E 11111111110A04 1111111515150A '
    '11110A040A1111 1111110A040404 1F01020408101F 0E08080808080E '
    '00100804020100 0E02020202020E 040A1100000000 0000000000001F '
    '08040200000000 00000E010F110F 1010161911111E 00000E1010110E '
    '01010D1311110F 00000E111F100E 0609081C080808 000F11110F010E '
    '10101619111111 04000C0404040E 0200060202120C 10101214181412 '
    '0C04040404040E 00001A15151111 00001619111111 00000E1111110E '
    '00001E111E1010 00000D130F0101 00001619101010 00000E100E011E '
    '08081C08080906 0000111111130D 00001111110A04 0000111115150A '
    '0000110A040A11 000011110F010E 00001F0204081F 02040408040402 '
    '04040404040404 08040402040408 00000815020000')
GLYPHS = np.array(
    [[[int(g[2 * r:2 * r + 2], 16) >> (GLYPH_W - 1 - c) & 1
       for c in range(GLYPH_W)] for r in range(GLYPH_H)]
     for g in _GLYPH_HEX.split()], dtype=bool)


def draw_text(image, text, color=(255, 255, 255)):
    """Draw ``text`` into ``image`` ([H, W, 3] uint8) in place from its
    top-left corner, a line every ``LINE_HEIGHT`` rows and a character
    every ``ADVANCE`` columns, as ``ImageDraw.text((0, 0), ...)`` places
    it; a character outside printable ASCII is drawn as '?', and what
    falls outside the image is cut off."""
    height, width = image.shape[:2]
    for row, line in enumerate(text.split('\n')):
        top = row * LINE_HEIGHT
        if top >= height:
            break
        for col, char in enumerate(line):
            left = col * ADVANCE
            if left >= width:
                break
            code = ord(char) - ord(' ')
            if not 0 <= code < len(GLYPHS):
                code = ord('?') - ord(' ')
            mask = GLYPHS[code][:height - top, :width - left]
            image[top:top + mask.shape[0],
                  left:left + mask.shape[1]][mask] = color
    return image
