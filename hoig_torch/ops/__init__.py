"""Compute primitives: the hand-written kernels, their plain versions and torch ops."""
