"""Build, bind and count the hand-written CUDA kernels of the port.

Each source in `hoig_torch/csrc/` has a plain C interface (no PyTorch
headers; the tensor-core sources share `hopper.cuh`), so `nvcc` turns it
into a shared library in seconds. All sources
are compiled at once, one `nvcc` process each, the first time any kernel is
needed; the libraries are loaded with `ctypes` and cached under
`build/hoig_torch_kernels/` by a hash of source and flags, so a checkout
rebuilds only what changed. Nothing is built or imported at module import:
the CPU tests import every module of the port.

Every wrapper counts its launches here (`count_launch`), so a run can show
which kernels the main path went through.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import torch

_REPO = Path(__file__).resolve().parents[2]
CSRC = _REPO / "hoig_torch" / "csrc"
BUILD_DIR = _REPO / "build" / "hoig_torch_kernels"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMMON = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# name -> (source, extra flags). -fmad=false keeps the plane and FMA-chain
# evaluations in the plain versions' rounding order (see each source's note).
SOURCES = {
    "local_combine": ("local_combine.cu", ["-fmad=false"]),
    "rasterizer": ("rasterizer.cu", ["-fmad=false"]),
    "table_gather": ("table_gather.cu", []),
    "attn_fused": ("attn_fused.cu", ["-fmad=false"]),
}

_LAUNCHES: collections.Counter = collections.Counter()


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME): cannot build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(name: str) -> tuple[list, Path]:
    src, extra = SOURCES[name]
    flags = _ARCH + _COMMON + extra
    # the shared headers too: a change there rebuilds every source
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        (CSRC / src).read_bytes() + headers + " ".join(flags).encode()
    ).hexdigest()[:16]
    return flags, BUILD_DIR / f"{name}-{digest}.so"


def build_all() -> dict:
    """Compile every source that has no cached library, all in parallel.

    Returns {name: ptxas report or "cached"}; raises with the compiler's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs, report = {}, {}
    for name, (src, _) in SOURCES.items():
        flags, lib = _target(name)
        if lib.exists():
            report[name] = "cached"
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                [nvcc, *flags, "-o", str(tmp), str(CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp, lib,
        )
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        report[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    _, lib = _target(name)
    if not lib.exists():
        build_all()
    dll = ctypes.CDLL(str(lib))
    dll.hoig_error_string.argtypes = [ctypes.c_int]
    dll.hoig_error_string.restype = ctypes.c_char_p
    return dll


def kernel(name: str, symbol: str, argtypes: list):
    """The C entry point `symbol` of library `name`, typed for ctypes.

    Pointers and the stream are passed as `ctypes.c_void_p` so that no
    64-bit value is cut to a C int."""
    fn = getattr(_library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(library: str, err: int, name: str | None = None) -> None:
    """Raise if a launch of library `library` returned a CUDA error (refused
    or failed launch); `name` is the kernel's, when it is not the library's."""
    if err != 0:
        msg = _library(library).hoig_error_string(err).decode()
        raise RuntimeError(f"{name or library} kernel launch failed: CUDA error {err} ({msg})")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on the current CUDA device (the
    kernels launch on that device's current stream)."""
    devs = {t.device for t in tensors}
    dev = next(iter(devs))
    if len(devs) != 1 or dev.type != "cuda" or dev.index != torch.cuda.current_device():
        raise ValueError(
            f"kernel inputs must lie on the current CUDA device, got {sorted(map(str, devs))}"
        )


def resolve_device(device) -> torch.device:
    """An entry point's device: CUDA unless the caller names the CPU.

    Raises when CUDA is asked for and absent; never falls back quietly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
