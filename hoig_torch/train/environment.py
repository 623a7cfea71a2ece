"""Run-configuration helpers of the serving path."""

from __future__ import annotations


def resolve_corner_engine(engine: str, bf16: bool) -> str:
    """'auto' -> the attention corner engine for the precision mode: 'shift'
    under bf16, 'gather' under f32 (the JAX package's picks); explicit
    values pass through."""
    if engine == "auto":
        return "shift" if bf16 else "gather"
    return engine
