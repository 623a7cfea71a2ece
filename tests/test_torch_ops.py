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
from hoig_torch.ops.local_combine import (
    local_combine,
    local_combine_backward_reference,
    local_combine_reference,
)
from hoig_torch.ops.morph import morph
from hoig_torch.ops.rasterizer import rasterize_fim_wim
from hoig_torch.ops.rasterizer_cuda import rasterize_fim_wim_auto
from hoig_torch.ops.table_gather import gather_rows

# parallel test workers each run torch's CPU kernels; one intra-op thread per
# worker keeps them from contending for the same cores
torch.set_num_threads(1)

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


def _combine_case(radius, d_extra, dtype, seed=0):
    rng = np.random.RandomState(seed + radius + d_extra)
    b, h, w, c = 2, 6, 8, 8
    k2 = (2 * radius + 1) ** 2
    src = rng.randn(b, h + 2 * radius, w + 2 * radius, c).astype(np.float32)
    v = rng.randn(b, h, w, k2 + d_extra).astype(np.float32)
    g = rng.randn(b, h, w, c).astype(np.float32)
    if dtype == "bfloat16":  # values both packages hold exactly
        src, v, g = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                     for a in (src, v, g))
    return src, v, g, k2


@pytest.mark.parametrize("radius,d_extra,dtype", [
    (2, 7, "float32"), (3, 128 - 49, "float32"), (5, 0, "float32"), (5, 7, "bfloat16"),
])
def test_local_combine_gradients_match_jax(radius, d_extra, dtype):
    """The LocalCombine Function (CPU: the plain backward loops) against
    jax.grad of the Pallas custom VJP in interpret mode, on the same values.
    f32: atol/rtol 1e-5. bf16: the port's bf16 gradients against JAX's f32
    gradients of the same bf16-exact inputs, 1e-2 (one bf16 rounding of an
    f32 sum; the TPU kernel's own bf16 run sums dsrc in bf16 and is several
    bf16 ulps off that value at R = 5)."""
    src, v, g, k2 = _combine_case(radius, d_extra, dtype)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jsrc, jv, jg = (jnp.asarray(a) for a in (src, v, g))
    ref_s, ref_v = jax.grad(
        lambda s_, v_: jnp.sum(jax_local_combine(s_, v_, radius) * jg), argnums=(0, 1))(jsrc, jv)
    ts, tv = T(src.copy()).to(tdt).requires_grad_(), T(v.copy()).to(tdt).requires_grad_()
    out = local_combine(ts, tv, radius)
    assert out.grad_fn is not None and out.dtype == tdt
    out.backward(T(g.copy()).to(tdt))
    assert ts.grad.dtype == tv.grad.dtype == tdt
    for name, got, ref in (("dsrc", ts.grad, ref_s), ("dv", tv.grad, ref_v)):
        ref = np.asarray(ref)
        got = got.float().numpy()
        assert got.shape == ref.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(got, ref, atol=1e-2 * float(np.abs(ref).max()), rtol=1e-2,
                                       err_msg=name)
    if d_extra:  # ignored columns get zero gradient
        assert not tv.grad[..., k2:].any()


def test_local_combine_backward_reference_is_the_loops_gradient():
    """The plain backward equals autograd of the plain forward loop in f32,
    and in bf16 up to dsrc's rounding (autograd rounds it at every offset)."""
    src, v, g, k2 = _combine_case(3, 5, "float32", seed=3)
    ts, tv = T(src).requires_grad_(), T(v).requires_grad_()
    local_combine_reference(ts, tv, 3).backward(T(g))
    dsrc, dv = local_combine_backward_reference(T(src), T(v), T(g), 3)
    np.testing.assert_allclose(dsrc.numpy(), ts.grad.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dv.numpy(), tv.grad[..., :k2].numpy(), atol=1e-5, rtol=1e-5)
    assert dv.shape[-1] == k2
    only_src = local_combine_backward_reference(None, T(v), T(g), 3, need_v=False)
    only_v = local_combine_backward_reference(T(src), None, T(g), 3, need_src=False)
    assert only_src[1] is None and only_v[0] is None
    assert torch.equal(only_src[0], dsrc) and torch.equal(only_v[1], dv)


def test_local_combine_gradcheck_float64():
    rng = np.random.RandomState(8)
    src = T(rng.randn(1, 3 + 4, 4 + 4, 2)).requires_grad_()
    v = T(rng.randn(1, 3, 4, 25 + 2)).requires_grad_()
    assert torch.autograd.gradcheck(lambda s_, v_: local_combine(s_, v_, 2), (src, v))


@pytest.mark.parametrize("side", ["src", "v"])
def test_local_combine_one_sided_gradient(side):
    """Only the side that requires grad gets one (the shift engine's first
    call has coefficients that come from the no-grad flow), and only its
    input is kept for the backward."""
    src, v, g, _ = _combine_case(2, 3, "float32", seed=5)
    ts, tv = T(src), T(v)
    (ts if side == "src" else tv).requires_grad_()
    out = local_combine(ts, tv, 2)
    saved = out.grad_fn.saved_tensors
    assert (saved[0] is None) == (side == "src") and (saved[1] is None) == (side == "v")
    out.backward(T(g))
    full_s, full_v = local_combine_backward_reference(T(src), T(v), T(g), 2)
    if side == "src":
        assert tv.grad is None and torch.equal(ts.grad, full_s)
    else:
        assert ts.grad is None and torch.equal(tv.grad[..., :25], full_v)
        assert not tv.grad[..., 25:].any()
    with torch.no_grad():
        assert local_combine(T(src), T(v), 2).grad_fn is None


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
