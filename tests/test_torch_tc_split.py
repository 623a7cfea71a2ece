"""The tensor-core path of the fused engine's three 5x5 products
(hoig_torch/ops/attn_fused.py, csrc/attn_fused.cu conv5_tc_kernel and
dw_tc_kernel) on the CPU: the three-way bf16 split of dG that makes the gsrc
projection's and dW's tensor-core products exact, both evaluated from the
three parts, which entry point and launch counter each dtype reaches, dG
built once per backward, and the split-K factors. Torch only: the plain
versions are held against the JAX kernels in
tests/test_torch_attn_fused.py."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F_

from hoig_torch.ops import _cuda
from hoig_torch.ops import attn_fused as af

# parallel test workers each run torch's CPU kernels; one intra-op thread per
# worker keeps them from contending for the same cores
torch.set_num_threads(1)

F32_MAX = float(np.finfo(np.float32).max)
F32_TINY = float(np.finfo(np.float32).tiny)  # 2^-126, the smallest normal


def _seeded_values(case: str) -> torch.Tensor:
    rng = np.random.RandomState(0)
    if case == "many_exponents":
        # 1e5 full-mantissa values, random sign, exponents -110..127
        bits = (rng.randint(0, 2, 10**5).astype(np.uint32) << 31) \
            | (rng.randint(127 - 110, 127 + 128, 10**5).astype(np.uint32) << 23) \
            | rng.randint(0, 2**23, 10**5).astype(np.uint32)
        return torch.from_numpy(bits.view(np.float32))
    if case == "specials":
        vals = [0.0, -0.0, F32_TINY, -F32_TINY, 2.0**-110 * (2 - 2.0**-23),
                -(2.0**-110) * (2 - 2.0**-23), 1.5 * F32_TINY, F32_MAX, -F32_MAX,
                np.nextafter(np.float32(F32_MAX), np.float32(0)), 1.0, -1.0 / 3]
        return torch.tensor(vals, dtype=torch.float32)
    # below 2^-110 a full mantissa reaches under bf16's smallest subnormal
    bits = (rng.randint(0, 2, 10**4).astype(np.uint32) << 31) \
        | (rng.randint(1, 127 - 110, 10**4).astype(np.uint32) << 23) \
        | rng.randint(0, 2**23, 10**4).astype(np.uint32)
    return torch.from_numpy(bits.view(np.float32))


@pytest.mark.parametrize("case", ["many_exponents", "specials", "below_2^-110"])
def test_split_bf16x3_is_exact(case):
    """hi + mid + lo == x exactly (summed in float64) for every f32 whose
    lowest bit is at or above 2^-133: 1e5 seeded values over exponents
    -110..127, +-0, the smallest normal, 2^-110 with a full mantissa and
    +-max (which round-to-nearest would take past the bf16 range). Each
    part is a bf16. Below 2^-110 the sum misses x by less than 2^-133."""
    x = _seeded_values(case)
    parts = af.split_bf16x3(x)
    assert all(p.dtype == torch.bfloat16 and p.shape == x.shape for p in parts)
    assert all(bool(torch.isfinite(p).all()) for p in parts)
    total = sum(p.double() for p in parts)
    if case == "below_2^-110":
        assert float((total - x.double()).abs().max()) < 2.0**-133
        assert not torch.equal(total, x.double())  # the cases do reach below 2^-133
    else:
        assert torch.equal(total, x.double())
    # hi carries x's sign and top bits: no part is larger than x
    assert bool((parts[0].double().abs() <= x.double().abs()).all())


def test_gsrc_projection_from_the_three_parts():
    """The plain gsrc projection (dG through w0s^T onto the padded frame,
    then the margin fold) in float64: from dG's three bf16 parts, projected
    one by one and added, it equals the projection of the unsplit dG to
    1e-12 of its largest entry; from dG rounded to bf16 it is more than 1e-3
    off, the error that chip_smoke.py's 1e-5 bound for this output rejects."""
    rng = np.random.RandomState(3)
    b, h, w, c = 2, 9, 7, 6
    g_acc = torch.from_numpy(rng.randn(b, h, w, af.F).astype(np.float32))
    flow = torch.from_numpy((rng.rand(b, h, w, 2) * 4.9 - 2.95).astype(np.float32))
    w0s = torch.from_numpy(rng.randn(af.K2, c, af.F).astype(np.float32)).to(torch.bfloat16)
    dg = af._dg_reference(g_acc, *af.coeff_axes(*af.flow_fields(flow)))
    weight = af._conv_weight(w0s).double()

    def project(x):
        gpad = af._nhwc(F_.conv_transpose2d(af._nchw(x.double()), weight))
        return af._fold_edges(gpad)

    want = project(dg)
    top = float(want.abs().max())
    got = sum(project(p) for p in af.split_bf16x3(dg))
    assert float((got - want).abs().max()) <= 1e-12 * top
    # dG rounded to bf16 (one pass) misses by two orders of magnitude more
    # than the card's 1e-5 bound for this output allows
    assert float((project(dg.to(torch.bfloat16)) - want).abs().max()) > 1e-3 * top
    # the fp32 plain version is the same projection, and returns the same dG
    gsrc, dg_out = af.attn_fused_bwd_a_gsrc_reference(g_acc, *af.flow_fields(flow), w0s)
    np.testing.assert_allclose(gsrc, want.float(), rtol=0, atol=1e-5 * float(want.abs().max()))
    assert torch.equal(dg_out, dg)


def test_dw_from_the_three_parts():
    """dW in float64 as the weight gradient of the 5x5 correlation G =
    conv2d(src_pad, W): from dG's three bf16 parts, one weight gradient per
    part, added, it equals the weight gradient of the unsplit dG to 1e-12 of
    its largest entry; from dG rounded to bf16 it is more than 1e-3 off, the
    error that chip_smoke.py's 1e-5 bound for dW rejects. The f32 plain dW
    is the same gradient."""
    rng = np.random.RandomState(4)
    b, h, w, c = 2, 9, 7, 6
    src = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(torch.bfloat16)
    g_acc = torch.from_numpy(rng.randn(b, h, w, af.F).astype(np.float32))
    flow = torch.from_numpy((rng.rand(b, h, w, 2) * 4.9 - 2.95).astype(np.float32))
    dg = af._dg_reference(g_acc, *af.coeff_axes(*af.flow_fields(flow)))
    x = af._nchw(af.edge_pad(src, af.PAD).double())

    def dw(d):  # (128, C, 5, 5) weight gradient in dW's (25, C, 128) layout
        grad = torch.nn.grad.conv2d_weight(x, (af.F, c, af.K, af.K), af._nchw(d.double()))
        return grad.permute(2, 3, 1, 0).reshape(af.K2, c, af.F)

    want = dw(dg)
    top = float(want.abs().max())
    got = sum(dw(p) for p in af.split_bf16x3(dg))
    assert float((got - want).abs().max()) <= 1e-12 * top
    assert float((dw(dg.to(torch.bfloat16)) - want).abs().max()) > 1e-3 * top
    np.testing.assert_allclose(af.attn_fused_bwd_a_dw_reference(src, dg), want.float(), rtol=0,
                               atol=1e-5 * top)


def _stand_in_card(monkeypatch) -> list:
    """The card stood in for: device checks pass and every entry point
    returns success (here with meta tensors: this machine has no card).
    Returns the list of (library, symbol, argument count) asked for."""
    asked = []
    monkeypatch.setattr(_cuda, "require_cuda", lambda *tensors: None)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda: 0)
    monkeypatch.setattr(_cuda, "kernel", lambda lib, symbol, argtypes: (
        asked.append((lib, symbol, len(argtypes))) or (lambda *args: 0)))
    _cuda.reset_launch_counts()
    return asked


def _meta(*shape, dt=torch.float32):
    return torch.empty(*shape, device="meta", dtype=dt)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["fwd", "bwd_a_gsrc", "bwd_a_dw"])
def test_dtype_picks_the_entry_point(kernel, dtype, monkeypatch):
    """A bf16 call on a device tensor reaches the tensor-core entry point
    and its counter (`*_tc`), an f32 one the FP32 entry point and its own."""
    asked = _stand_in_card(monkeypatch)
    b, h, w, c = 2, 5, 6, 18
    fields = [_meta(b, h, w) for _ in range(4)]
    w0s = _meta(af.K2, c, af.F, dt=dtype)
    if kernel == "fwd":
        out = af.attn_fused_fwd(_meta(b, h, w, c, dt=dtype), _meta(b, h, w, af.F), w0s,
                                _meta(af.F, af.K2), _meta(1, af.K2), *fields)
        assert [tuple(t.shape) for t in out] == [(b, h, w, c), (b, h, w, af.F), (b, h, w, af.K2)]
        args = af._FWD_TC_ARGS if dtype == torch.bfloat16 else af._FWD_ARGS
    elif kernel == "bwd_a_gsrc":
        out = af.attn_fused_bwd_a_gsrc(_meta(b, h, w, af.F), *fields, w0s)
        assert [tuple(t.shape) for t in out] == [(b, h, w, c), (b, h + 6, w + 6, af.F)]
        args = af._BWD_A_GSRC_TC_ARGS if dtype == torch.bfloat16 else af._BWD_A_GSRC_ARGS
    else:
        out = af.attn_fused_bwd_a_dw(_meta(b, h, w, c, dt=dtype), _meta(b, h + 6, w + 6, af.F))
        assert tuple(out.shape) == (af.K2, c, af.F) and out.dtype == torch.float32
        args = af._BWD_A_DW_TC_ARGS if dtype == torch.bfloat16 else af._BWD_A_DW_ARGS
    name = f"attn_fused_{kernel}" + ("_tc" if dtype == torch.bfloat16 else "")
    assert asked == [("attn_fused", "hoig_" + name, len(args))]
    assert _cuda.launch_counts() == {name: 1}


def test_fused_backward_builds_dg_once(monkeypatch):
    """A bf16 FlowAttentionFused forward and backward on device tensors
    (meta tensors stand in for the card): each of the four B4 entry points
    is launched once, on the tensor cores where bf16 has an entry point
    there, and the dW product takes the very dG that the gsrc entry point
    built, so dG is built once per backward."""
    asked = _stand_in_card(monkeypatch)
    seen = {}
    gsrc_wrapper, dw_wrapper = af.attn_fused_bwd_a_gsrc, af.attn_fused_bwd_a_dw

    def gsrc_spy(*args):
        out = gsrc_wrapper(*args)
        seen["built"] = out[1]
        return out

    def dw_spy(src, dg):
        seen["taken"] = dg
        return dw_wrapper(src, dg)

    monkeypatch.setattr(af, "attn_fused_bwd_a_gsrc", gsrc_spy)
    monkeypatch.setattr(af, "attn_fused_bwd_a_dw", dw_spy)
    b, h, w, c = 2, 5, 6, 18
    bf16 = torch.bfloat16
    leaves = [_meta(b, h, w, c, dt=bf16), _meta(b, h, w, af.F), _meta(af.K2, c, af.F, dt=bf16),
              _meta(af.F, af.K2), _meta(1, af.K2)]
    leaves = [t.requires_grad_() for t in leaves]
    out = af.flow_attention_fused(*leaves, *[_meta(b, h, w) for _ in range(4)])
    out.backward(torch.empty_like(out))
    assert [symbol for _, symbol, _ in asked] == [
        "hoig_attn_fused_fwd_tc", "hoig_attn_fused_bwd_c", "hoig_attn_fused_bwd_a_gsrc_tc",
        "hoig_attn_fused_bwd_a_dw_tc"]
    assert _cuda.launch_counts() == {"attn_fused_fwd_tc": 1, "attn_fused_bwd_c": 1,
                                     "attn_fused_bwd_a_gsrc_tc": 1, "attn_fused_bwd_a_dw_tc": 1}
    assert seen["taken"] is seen["built"]
    assert tuple(seen["built"].shape) == (b, h + 6, w + 6, af.F)
    for leaf in leaves:
        assert leaf.grad.shape == leaf.shape and leaf.grad.dtype == leaf.dtype


def test_split_k_factor():
    """The split-K factor of the tensor-core products at the main path's
    frames (256 px, batch 4): none where the frame fills the card, up to 25
    offset ranges where it has few tiles. dW's: 5 pixel ranges at all three
    layers (125, 250 and 500 blocks of one per SM, 95% of their last wave
    filled on 132 SMs), none on a frame of a few chunks."""
    assert [af._tc_splits(4, s + 6, s + 6, af.F) for s in (128, 64, 32)] == [1, 2, 6]
    assert [af._tc_splits(4, s + 10, s + 10, c) for s, c in ((128, 128), (64, 256), (32, 512))] \
        == [1, 1, 1]
    assert af._tc_splits(1, 8, 8, 8) == af.K2
    assert [af._dw_tc_splits(4, s, s, c) for s, c in ((128, 128), (64, 256), (32, 512))] \
        == [5, 5, 5]
    assert af._dw_tc_splits(1, 8, 8, 8) == 1
