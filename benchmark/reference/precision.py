"""The precision the reference computes in.

`FULL` is the reference: float32 everywhere, TF32 off. `LOWER` is the
control the benchmark's comparison has to reject: each precision one step
below what the configurations state. The networks' convolution and matrix
operands are rounded to fp8 (e4m3, one scale per tensor, as an fp8 path
would feed the tensor cores: the configurations state bf16 there), and the
conditioning's projected vertices to bf16 (it runs in float32). Products
and sums stay float32, so only the operands' rounding differs.
"""

from __future__ import annotations

import dataclasses

import torch

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 with one per-tensor scale (amax at the format's
    largest value); the gradient passes straight through."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = E4M3_MAX / amax
    q = (x.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q.to(x.dtype) - x).detach()


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    lower: bool

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """A convolution's or matrix product's operand."""
        return fp8_round(x) if self.lower else x

    def geometry(self, x: torch.Tensor) -> torch.Tensor:
        """The conditioning's projected vertices."""
        return bf16_round(x) if self.lower else x


FULL = Precision("float32", False)
LOWER = Precision("fp8 networks, bf16 conditioning", True)


def strict_float32() -> None:
    """Plain float32 products on the card: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
