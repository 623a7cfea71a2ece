"""Native runtime: the data pipeline's C++ kernels behind ctypes.

warp.cc is a copy of hoig_tpu/runtime's (the port imports nothing of
hoig_tpu): the same source, built with the same flags, gives the same
bits. image.cc reads images as the JAX package's cv2 calls do, bit for
bit: `imread` (cv2.imread with IMREAD_COLOR: JPEG and PNG to BGR, EXIF
orientation applied), `resize_linear_u8` (cv2.resize with INTER_LINEAR on
uint8) and the PNG scanline filters under `png_rgb`. Both sources are
built with g++ at first use into one library under
build/hoig_torch_kernels/, keyed by a hash of the sources, the flags and
the host CPU (`-march=native` makes warp.cc's code, and the FMA
contractions that set its rounding, depend on the CPU; image.cc is integer
arithmetic but for the resize coefficients, which it rounds as OpenCV
does). A failed build or decode raises: nothing falls back to cv2, PIL or
torchvision, and the port needs none of them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import struct
import subprocess
import zlib
from pathlib import Path

import numpy as np

SOURCES = tuple(Path(__file__).resolve().parent / name for name in ("warp.cc", "image.cc"))
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hoig_torch_kernels"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)


def _host_cpu() -> bytes:
    """What -march=native compiles for: the CPU's model and feature flags."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith((b"model name", b"flags"))]
        return b"\n".join(lines[:2])
    except OSError:
        return platform.processor().encode()


def library_path() -> Path:
    """The library's path, keyed by every source, the flags and the host CPU
    (an older library without image.cc's symbols is never loaded)."""
    sha = hashlib.sha256()
    for src in SOURCES:
        sha.update(src.name.encode() + b"\0" + src.read_bytes())
    sha.update(" ".join(FLAGS).encode() + _host_cpu())
    return BUILD_DIR / f"runtime-{sha.hexdigest()[:16]}.so"


@functools.cache
def get_lib() -> ctypes.CDLL:
    """Load the native library, building it first where it is missing."""
    so_path = library_path()
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *FLAGS, *map(str, SOURCES), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            names = " ".join(src.name for src in SOURCES)
            raise RuntimeError(f"g++ could not build {names} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(str(so_path))
    lib.hoig_warp_affine_u8.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _F32P,
                                        ctypes.c_int, ctypes.c_int, _F32P]
    lib.hoig_warp_affine_u8.restype = None
    lib.hoig_normalize_chw.argtypes = [_F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_float, ctypes.c_float, _F32P]
    lib.hoig_normalize_chw.restype = None
    errbuf = [ctypes.c_char_p, ctypes.c_int]
    lib.hoig_jpeg_header.argtypes = [_U8P, ctypes.c_size_t, _IP, _IP, _IP, *errbuf]
    lib.hoig_jpeg_decode_bgr.argtypes = [_U8P, ctypes.c_size_t, _U8P, ctypes.c_int,
                                         ctypes.c_int, *errbuf]
    lib.hoig_png_unfilter.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P,
                                      *errbuf]
    lib.hoig_resize_linear_u8.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P,
                                          ctypes.c_int, ctypes.c_int, *errbuf]
    for fn in (lib.hoig_jpeg_header, lib.hoig_jpeg_decode_bgr, lib.hoig_png_unfilter,
               lib.hoig_resize_linear_u8):
        fn.restype = ctypes.c_int
    return lib


def _call(fn, *args) -> None:
    """Call a native entry point that reports failure with a message."""
    err = ctypes.create_string_buffer(512)
    if fn(*args, err, len(err)) != 0:
        raise ValueError(err.value.decode(errors="replace"))


def warp_affine(src_u8: np.ndarray, trans: np.ndarray, out_hw) -> np.ndarray:
    """cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT 0) equivalent.

    src_u8: (H, W, C) or (H, W) uint8; trans: (2, 3) forward affine ->
    (oh, ow, C) or (oh, ow) float32 in [0, 255]."""
    oh, ow = (int(n) for n in out_hw)
    src = np.ascontiguousarray(src_u8, dtype=np.uint8)
    if src.ndim not in (2, 3):
        raise ValueError(f"expected an (H, W[, C]) image, got shape {src.shape}")
    h, w = src.shape[:2]
    ch = 1 if src.ndim == 2 else src.shape[2]
    t = np.ascontiguousarray(trans, dtype=np.float32)
    if t.shape != (2, 3):
        raise ValueError(f"expected a (2, 3) affine matrix, got shape {t.shape}")
    out = np.empty((oh, ow, ch), np.float32)
    get_lib().hoig_warp_affine_u8(src.ctypes.data_as(_U8P), h, w, ch, t.ctypes.data_as(_F32P),
                                  oh, ow, out.ctypes.data_as(_F32P))
    return out[:, :, 0] if src.ndim == 2 else out


def normalize_chw(patch_f32: np.ndarray, swap_rb: bool = True, scale: float = 2.0,
                  offset: float = -1.0) -> np.ndarray:
    """(H, W, C) float [0, 255] -> (C, H, W) float32, x / 255 * scale + offset,
    the channels reversed where swap_rb (BGR -> RGB)."""
    src = np.ascontiguousarray(patch_f32, dtype=np.float32)
    if src.ndim != 3:
        raise ValueError(f"expected an (H, W, C) patch, got shape {src.shape}")
    h, w, ch = src.shape
    out = np.empty((ch, h, w), np.float32)
    get_lib().hoig_normalize_chw(src.ctypes.data_as(_F32P), h, w, ch, 1 if swap_rb else 0,
                                 scale, offset, out.ctypes.data_as(_F32P))
    return out


def resize_linear_u8(img: np.ndarray, dsize) -> np.ndarray:
    """cv2.resize(img, dsize) with INTER_LINEAR on uint8, bit for bit.

    img: (H, W) or (H, W, C) uint8, C in 1..4; dsize: (width, height), as
    cv2 takes it. OpenCV's fixed-point path: coefficients scaled by 2^11,
    half-pixel centres, edges clamped; an exact 2x downscale in both axes
    is its INTER_AREA mean of 2x2 blocks, and an unchanged size a copy. As
    cv2, returns (height, width) for one channel, (height, width, C) else."""
    src = np.ascontiguousarray(img)
    if src.dtype != np.uint8 or src.ndim not in (2, 3) or (src.ndim == 3 and not
                                                            1 <= src.shape[2] <= 4):
        raise ValueError(f"expected an (H, W[, C <= 4]) uint8 image, got {src.dtype} "
                         f"{src.shape}")
    ow, oh = (int(n) for n in dsize)
    h, w = src.shape[:2]
    ch = 1 if src.ndim == 2 else src.shape[2]
    out = np.empty((oh, ow) + src.shape[2:], np.uint8)
    _call(get_lib().hoig_resize_linear_u8, src.ctypes.data_as(_U8P), h, w, ch,
          out.ctypes.data_as(_U8P), oh, ow)
    return out.reshape(oh, ow) if ch == 1 else out  # cv2 drops a single channel's axis


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel of each color type: gray, RGB, palette, gray + alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_chunk_walk(data: bytes):
    """(IHDR fields, PLTE as (N, 3) uint8 or None, the IDAT stream)."""
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
    return header, palette, b"".join(idat)


def png_rgb(data: bytes, sixteen_bit: bool = False) -> np.ndarray:
    """The bytes of a non-interlaced PNG of color type 0, 2, 3, 4 or 6 ->
    (H, W, 3) uint8 RGB: alpha dropped, gray replicated, a palette looked
    up. 8-bit samples; 16-bit ones too where sixteen_bit, keeping each
    sample's high byte (cv2.imread's png_set_strip_16). All five scanline
    filters are undone by the native runtime. Any other PNG, a bad CRC or a
    palette index past the palette raises ValueError."""
    header, palette, stream = _png_chunk_walk(data)
    w, h, depth, ctype, compression, filter_method, interlace = header
    depths = (8, 16) if sixteen_bit else (8,)
    if depth not in depths or ctype not in _PNG_CHANNELS or compression or filter_method \
            or interlace or (ctype == 3 and depth != 8):
        raise ValueError(f"PNG of bit depth {depth}, color type {ctype}, interlace {interlace}: "
                         f"only {' or '.join(map(str, depths))}-bit, non-interlaced color types "
                         "0, 2, 3, 4 and 6 are read")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    ch = _PNG_CHANNELS[ctype]
    bpp = ch * depth // 8
    stride = w * bpp
    raw = zlib.decompress(stream)
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, not {h * (stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    if h and stride:
        _call(get_lib().hoig_png_unfilter, np.frombuffer(raw, np.uint8).ctypes.data_as(_U8P), h,
              stride, bpp, out.ctypes.data_as(_U8P))
    pixels = out.reshape(h, w, ch * depth // 8)
    if depth == 16:  # big-endian samples: the high byte comes first
        pixels = pixels[..., 0::2]
    if ctype == 3:
        if pixels.size and int(pixels.max()) >= len(palette):
            raise ValueError(f"PNG palette index {int(pixels.max())} past its {len(palette)} "
                             "entries")
        return palette[pixels[..., 0]]
    if ch <= 2:  # gray, gray + alpha
        return np.repeat(pixels[..., :1], 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])


def _jpeg_bgr(data: bytes) -> np.ndarray:
    """A baseline or extended-sequential JPEG -> (H, W, 3) uint8 BGR, as
    cv2.imread gives it (a grey image replicated, EXIF orientation
    applied)."""
    lib = get_lib()
    buf = np.frombuffer(data, np.uint8)
    dims = [ctypes.c_int(0) for _ in range(3)]
    _call(lib.hoig_jpeg_header, buf.ctypes.data_as(_U8P), buf.size,
          *(ctypes.byref(d) for d in dims))
    h, w, orientation = (d.value for d in dims)
    out = np.empty((h, w, 3), np.uint8)
    _call(lib.hoig_jpeg_decode_bgr, buf.ctypes.data_as(_U8P), buf.size,
          out.ctypes.data_as(_U8P), h, w)
    # OpenCV's ApplyExifOrientation: 5-8 transpose first; values past 1-8 do nothing
    if orientation in (5, 6, 7, 8):
        out = out.transpose(1, 0, 2)
    for axis in {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ()):
        out = np.flip(out, axis)
    return np.ascontiguousarray(out)


def imread(path) -> np.ndarray:
    """cv2.imread(path) with IMREAD_COLOR, bit for bit, for the formats the
    data sets hold: JPEG (baseline or extended-sequential Huffman, 8-bit,
    grey or YCbCr, 1x or 2x chroma subsampling, restart intervals, EXIF
    orientation) and PNG (8- or 16-bit, see png_rgb) -> (H, W, 3) uint8
    BGR. Where cv2 would return None, this raises: FileNotFoundError for a
    missing file; ValueError, naming the file, for another format, an
    unsupported JPEG kind (progressive, arithmetic-coded, lossless, 12-bit,
    CMYK) and a truncated or corrupt stream (which libjpeg-turbo pads with
    zeros, so cv2 decodes it with a warning)."""
    path = os.fspath(path)
    try:
        with open(path, "rb") as fp:
            data = fp.read()
    except FileNotFoundError:
        raise FileNotFoundError(f"no image file at {path}") from None
    try:
        if data[:2] == b"\xff\xd8":
            return _jpeg_bgr(data)
        if data[:8] == _PNG_SIGNATURE:
            return np.ascontiguousarray(png_rgb(data, sixteen_bit=True)[:, :, ::-1])
    except (ValueError, zlib.error) as e:
        raise ValueError(f"cannot read the image {path}: {e}") from None
    raise ValueError(f"cannot read the image {path}: neither a JPEG nor a PNG file")
