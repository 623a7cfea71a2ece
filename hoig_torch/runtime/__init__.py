"""Native runtime: the data pipeline's C++ kernels behind ctypes.

A copy of hoig_tpu/runtime (the port imports nothing of hoig_tpu): the
same warp.cc, built with the same flags, gives the same bits. The library
is built with g++ at first use into build/hoig_torch_kernels/, keyed by a
hash of the source, the flags and the host CPU (`-march=native` makes the
code, and the FMA contractions that set its rounding, depend on the CPU).
A failed build raises: there is no cv2 fallback, so a machine without cv2
gets the compiler's message and not a later import error.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "warp.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hoig_torch_kernels"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)


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
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(FLAGS).encode() + _host_cpu()).hexdigest()[:16]
    return BUILD_DIR / f"warp-{digest}.so"


@functools.cache
def get_lib() -> ctypes.CDLL:
    """Load the native library, building it first where it is missing."""
    so_path = library_path()
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ could not build {SOURCE.name} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(str(so_path))
    lib.hoig_warp_affine_u8.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _F32P,
                                        ctypes.c_int, ctypes.c_int, _F32P]
    lib.hoig_warp_affine_u8.restype = None
    lib.hoig_normalize_chw.argtypes = [_F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_float, ctypes.c_float, _F32P]
    lib.hoig_normalize_chw.restype = None
    return lib


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
