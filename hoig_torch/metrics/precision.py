"""The metric networks run in f32 with TF32 off, so that their values on the
card are held to the CPU's (and to the JAX package's at "highest"
precision); the flags are restored afterwards."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def f32_exact():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
