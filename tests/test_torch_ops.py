"""hoig_torch ops against hoig_tpu on the CPU: the plain versions of the
three kernels (local_combine, the rasterizer's z-buffer, gather_rows) and
the torch warps. Inputs come from numpy seeds; the JAX Pallas kernels run in
interpret mode, as the JAX package's own tests run them."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hoig_tpu.ops.rasterizer_pallas as jrp
from hoig_tpu.ops.grid_sample import (
    _resize_axis_linear_ac as jax_resize_axis,
    grid_sample_nhwc as jax_grid_sample_nhwc,
    grid_sample_packed as jax_grid_sample_packed,
)
from hoig_tpu.ops.local_combine import local_combine as jax_local_combine
from hoig_tpu.ops.morph import morph as jax_morph
from hoig_tpu.ops.rasterizer import rasterize_fim_wim as jax_rasterize_fim_wim
from hoig_tpu.ops.table_gather import gather_rows_mxu
from hoig_torch.ops import grid_sample as tgs
from hoig_torch.ops.local_combine import local_combine, local_combine_reference
from hoig_torch.ops.morph import morph
from hoig_torch.ops.rasterizer import rasterize_fim_wim
from hoig_torch.ops.rasterizer_cuda import rasterize_fim_wim_auto
from hoig_torch.ops.table_gather import gather_rows

T = torch.as_tensor


@pytest.mark.parametrize("radius,d_extra", [(3, 0), (3, 128 - 49), (5, 0), (5, 128 - 121)])
def test_local_combine_reference_matches_jax(radius, d_extra):
    rng = np.random.RandomState(radius + d_extra)
    b, h, w, c = 2, 6, 8, 8
    k2 = (2 * radius + 1) ** 2
    src = rng.randn(b, h + 2 * radius, w + 2 * radius, c).astype(np.float32)
    v = rng.randn(b, h, w, k2 + d_extra).astype(np.float32)
    ref = np.asarray(jax_local_combine(jnp.asarray(src), jnp.asarray(v), radius))
    out = local_combine_reference(T(src), T(v), radius)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    # the CPU dispatch of the kernel wrapper is the plain version
    np.testing.assert_array_equal(local_combine(T(src), T(v), radius).numpy(), out.numpy())


def _random_scene(seed=0, b=2, f=300):
    """The random-scene fixture of tests/test_rasterizer.py (rng seed 0)."""
    rng = np.random.RandomState(seed)
    fv = rng.randn(b, f, 3, 3).astype(np.float32) * 0.4
    fv[:, :, :, 2] = np.abs(fv[:, :, :, 2]) + 1.5
    valid = rng.rand(b, f) > 0.1
    return fv, valid, rng


def test_rasterize_fim_wim_matches_jax():
    fv, valid, _ = _random_scene()
    s = 128
    fim_j, wim_j = jax_rasterize_fim_wim(jnp.asarray(fv), jnp.asarray(valid), image_size=s)
    fim, wim = rasterize_fim_wim(T(fv), T(valid), image_size=s)
    assert (np.asarray(fim_j) >= 0).sum() > 1000
    np.testing.assert_array_equal(fim.numpy(), np.asarray(fim_j))
    np.testing.assert_allclose(wim.numpy(), np.asarray(wim_j), atol=1e-4, rtol=0)


def test_rasterize_auto_attrs_match_jax_pallas_interpret():
    """The dispatching entry (CPU: plain z-buffer + plain gather) against the
    Pallas kernel with its fused finish gather, interpret mode patched in as
    tests/test_rasterizer.py does."""
    fv, valid, rng = _random_scene()
    s, a = 128, 16
    attrs = rng.randn(fv.shape[0], fv.shape[1] + 1, a).astype(np.float32)
    orig = jrp.pl.pallas_call
    jrp.pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        fim_j, wim_j, rows_j = jrp.rasterize_fim_wim_pallas(
            jnp.asarray(fv), jnp.asarray(valid), image_size=s, attrs=jnp.asarray(attrs))
    finally:
        jrp.pl.pallas_call = orig
    fim, wim, rows = rasterize_fim_wim_auto(T(fv), T(valid), image_size=s, attrs=T(attrs))
    np.testing.assert_array_equal(fim.numpy(), np.asarray(fim_j))
    np.testing.assert_allclose(wim.numpy(), np.asarray(wim_j), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(rows_j))


@pytest.mark.parametrize("r,a,p", [(1569, 25, 1000), (130, 6, 513)])
def test_gather_rows_matches_jax_mxu_bit_exact(r, a, p):
    rng = np.random.RandomState(1)
    table = rng.randn(2, r, a).astype(np.float32)
    idx = rng.randint(0, r, (2, p)).astype(np.int32)
    ref = np.asarray(gather_rows_mxu(jnp.asarray(table), jnp.asarray(idx)))
    out = gather_rows(T(table), T(idx))
    assert out.shape == (2, a, p)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_samples_match_jax(align_corners):
    rng = np.random.RandomState(4)
    img = (rng.rand(2, 3, 12, 20) * 2 - 1).astype(np.float32)  # images live in [-1, 1]
    # in-range, out-of-range and the conditioning's -2 fill
    grid = (rng.rand(2, 9, 11, 2) * 2.6 - 1.3).astype(np.float32)
    grid[:, 0] = -2.0
    ref = jax_grid_sample_packed(jnp.asarray(img), jnp.asarray(grid), align_corners)
    out = tgs.grid_sample_packed(T(img), T(grid), align_corners)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    nhwc = np.ascontiguousarray(img.transpose(0, 2, 3, 1))
    ref = jax_grid_sample_nhwc(jnp.asarray(nhwc), jnp.asarray(grid), align_corners)
    out = tgs.grid_sample_nhwc(T(nhwc), T(grid), align_corners)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("axis,size", [(1, 7), (2, 16), (2, 4)])
def test_resize_axis_linear_matches_jax(axis, size):
    x = np.random.RandomState(5).randn(2, 5, 9, 2).astype(np.float32)
    ref = jax_resize_axis(jnp.asarray(x), axis, size)
    out = tgs._resize_axis_linear_ac(T(x), axis, size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("ks,mode", [(3, "erode"), (15, "erode"), (3, "dilate")])
def test_morph_matches_jax(ks, mode):
    m = (np.random.RandomState(6).rand(2, 1, 24, 30) > 0.3).astype(np.float32)
    ref = jax_morph(jnp.asarray(m), ks=ks, mode=mode)
    out = morph(T(m), ks=ks, mode=mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
