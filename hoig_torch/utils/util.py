"""Image and file utilities (port of hoig_tpu/utils/util.py; reference
utils/util.py): tensor2im / tensor2maskim with grid tiling, the 16-colour
label Colorize map, pickle and json helpers, mkdirs, and a stdlib PNG
encoder and decoder (no PIL or cv2). All numpy: the model facade hands
these host arrays.
"""

from __future__ import annotations

import json
import os
import pickle
import struct
import zlib

import numpy as np


def mkdirs(paths):
    if isinstance(paths, str):
        paths = [paths]
    for p in paths:
        os.makedirs(p, exist_ok=True)


def read_pickle(path):
    with open(path, "rb") as fp:
        return pickle.load(fp)


def write_pickle(path, obj):
    with open(path, "wb") as fp:
        pickle.dump(obj, fp)


def read_json(path):
    with open(path, "r") as fp:
        return json.load(fp)


def write_json(path, obj):
    with open(path, "w") as fp:
        json.dump(obj, fp)


def _tile_grid(imgs: np.ndarray, nrow: int = 8, padding: int = 0) -> np.ndarray:
    """torchvision.utils.make_grid equivalent on (B, C, H, W) float arrays."""
    b, c, h, w = imgs.shape
    ncol = min(nrow, b)
    nrows = int(np.ceil(b / ncol))
    grid = np.zeros((c, nrows * (h + padding) + padding,
                     ncol * (w + padding) + padding), imgs.dtype)
    for i in range(b):
        r, cl = divmod(i, ncol)
        y = r * (h + padding) + padding
        x = cl * (w + padding) + padding
        grid[:, y:y + h, x:x + w] = imgs[i]
    return grid


def tensor2im(img, imtype=np.uint8, unnormalize: bool = True, idx: int = 0,
              nrows=None) -> np.ndarray:
    """(B|1, C, H, W) [-1,1] array -> HWC uint8 image (util.py:249-262).

    idx >= 0 selects one sample; idx == -1 tiles the whole batch."""
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 3:
        img = img[None]
    if idx >= 0:
        img = img[idx:idx + 1]
        im = img[0]
    else:
        # grid tiling contract: padding=0, nrow=int(sqrt(B)) row-major, so
        # eval.py can slice exact image_size crops back out
        # (reference util.py:250-252 + eval.py:70-79)
        im = _tile_grid(img, nrow=nrows or max(1, int(np.sqrt(img.shape[0]))))
    if unnormalize:
        im = (im + 1) / 2.0
    im = np.clip(im * 255.0, 0, 255)
    if im.shape[0] == 1:
        im = np.repeat(im, 3, axis=0)
    return im.transpose(1, 2, 0).astype(imtype)


def tensor2maskim(mask, imtype=np.uint8, idx: int = 0, nrows=None) -> np.ndarray:
    """(1|B, 1, H, W) [0,1] mask -> HWC uint8 (util.py:264-271)."""
    im = tensor2im(mask, imtype=imtype, idx=idx, unnormalize=False, nrows=nrows)
    return im


def _uint82bin(n, count=8):
    return "".join([str((n >> y) & 1) for y in range(count - 1, -1, -1)])


def labelcolormap(n):
    """The pix2pixHD label colormap (util.py:47-66)."""
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        r = g = b = 0
        idx = i
        for j in range(7):
            str_id = _uint82bin(idx)
            r = r ^ (np.uint8(str_id[-1]) << (7 - j))
            g = g ^ (np.uint8(str_id[-2]) << (7 - j))
            b = b ^ (np.uint8(str_id[-3]) << (7 - j))
            idx = idx >> 3
        cmap[i] = [r, g, b]
    return cmap


class Colorize:
    """Label map -> RGB in [-1, 1] (util.py:68-80)."""

    def __init__(self, n: int = 16):
        self.cmap = labelcolormap(n).astype(np.float32) / 255.0 * 2.0 - 1.0

    def label2color(self, label):
        """(1, H, W) int labels -> (3, H, W) float colors."""
        label = np.asarray(label)
        lab = label[0].astype(np.int64)
        lab = np.clip(lab, 0, self.cmap.shape[0] - 1)
        return self.cmap[lab].transpose(2, 0, 1)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> the bytes of an 8-bit RGB PNG (no filter, zlib)."""
    img = np.ascontiguousarray(image)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got {img.dtype} {img.shape}")
    h, w, _ = img.shape
    # each scanline starts with its filter type, 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel of each 8-bit color type: gray, RGB, palette, gray +
# alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter_average(line: bytes, prev: bytes, bpp: int) -> bytearray:
    cur = bytearray(line)
    for i in range(bpp):
        cur[i] = (cur[i] + (prev[i] >> 1)) & 0xFF
    for i in range(bpp, len(cur)):
        cur[i] = (cur[i] + ((cur[i - bpp] + prev[i]) >> 1)) & 0xFF
    return cur


def _unfilter_paeth(line: bytes, prev: bytes, bpp: int) -> bytearray:
    cur = bytearray(line)
    for i in range(bpp):  # no left neighbour: the predictor is the one above
        cur[i] = (cur[i] + prev[i]) & 0xFF
    for i in range(bpp, len(cur)):
        a, b, c = cur[i - bpp], prev[i], prev[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return cur


def decode_png(data: bytes) -> np.ndarray:
    """The bytes of an 8-bit, non-interlaced PNG of color type 0, 2, 3, 4 or
    6 -> (H, W, 3) uint8 RGB, as PIL's `Image.open(f).convert("RGB")`
    gives it: alpha dropped, gray replicated, a palette looked up. All five
    scanline filters are undone (PIL chooses them per line). Any other PNG,
    a bad CRC or a palette index past the palette raises ValueError."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while True:
        if pos + 8 > len(data):
            raise ValueError("PNG ends before its IEND chunk")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body, crc = data[pos + 8:pos + 8 + n], data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif not kind[0] & 0x20:  # an unknown critical chunk (ancillary ones are skipped)
            raise ValueError(f"PNG chunk {kind!r} is not supported")
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, compression, filter_method, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or compression or filter_method or interlace:
        raise ValueError(f"PNG of bit depth {depth}, color type {ctype}, interlace {interlace}: "
                         "only 8-bit, non-interlaced color types 0, 2, 3, 4 and 6 are read")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    ch = _PNG_CHANNELS[ctype]
    stride = w * ch
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, not {h * (stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    prev = bytes(stride)
    for y in range(h):
        kind, line = raw[y * (stride + 1)], raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)]
        if kind == 0:
            out[y] = np.frombuffer(line, np.uint8)
        elif kind == 1:  # sub: a running sum per channel, mod 256
            out[y] = np.cumsum(np.frombuffer(line, np.uint8).reshape(w, ch), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif kind == 2:  # up
            out[y] = np.frombuffer(line, np.uint8) + np.frombuffer(prev, np.uint8)
        elif kind == 3:
            out[y] = np.frombuffer(_unfilter_average(line, prev, ch), np.uint8)
        elif kind == 4:
            out[y] = np.frombuffer(_unfilter_paeth(line, prev, ch), np.uint8)
        else:
            raise ValueError(f"PNG scanline {y} has filter type {kind}")
        prev = out[y].tobytes()
    pixels = out.reshape(h, w, ch)
    if ctype == 3:
        if pixels.size and int(pixels.max()) >= len(palette):
            raise ValueError(f"PNG palette index {int(pixels.max())} past its {len(palette)} "
                             "entries")
        return palette[pixels[..., 0]]
    if ch <= 2:  # gray, gray + alpha
        return np.repeat(pixels[..., :1], 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])


def read_png(path: str) -> np.ndarray:
    """A PNG file -> (H, W, 3) uint8 RGB (see decode_png)."""
    with open(path, "rb") as fp:
        return decode_png(fp.read())


def save_image(image_numpy: np.ndarray, image_path: str) -> None:
    """Write an (H, W, 3) uint8 RGB image as a PNG (stdlib only: no PIL, no cv2)."""
    with open(image_path, "wb") as fp:
        fp.write(encode_png(image_numpy))
