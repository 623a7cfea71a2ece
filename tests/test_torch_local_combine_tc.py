"""The tensor-core backward of the weighted-shift combine
(hoig_torch/ops/local_combine.py, csrc/local_combine.cu
combine_bwd_v_tc_kernel and combine_bwd_src_tc_kernel) on the CPU: a float64
torch model of both kernels' tiling held to the plain backward, which entry
point and launch counter each dtype reaches, and bwd_v's channel splits.
Torch only: the plain backward is held against jax.grad of the Pallas
kernels in tests/test_torch_ops.py."""

import numpy as np
import pytest
import torch

from hoig_torch.ops import _cuda
from hoig_torch.ops import local_combine as lc

# parallel test workers each run torch's CPU kernels; one intra-op thread per
# worker keeps them from contending for the same cores
torch.set_num_threads(1)

TILE = lc.TILING["tile"]


def _band_index(radius: int) -> torch.Tensor:
    """n[m, d]: the window pixel that tile pixel m = (my, mx) pairs with
    through offset d = (dy, dx), for both kernels: bwd_v reads D[m, n] at
    window pixel m + (dy, dx) (window origin at the tile), bwd_src reads
    Wt[m, n] at window pixel m + (2R - dy, 2R - dx) (window origin 2R above
    and left of the tile)."""
    k, win = 2 * radius + 1, TILE + 2 * radius
    m = torch.arange(TILE * TILE)
    d = torch.arange(k * k)
    my, mx = (m // TILE)[:, None], (m % TILE)[:, None]
    dy, dx = (d // k)[None, :], (d % k)[None, :]
    return (my + dy) * win + mx + dx, (my - dy + 2 * radius) * win + mx - dx + 2 * radius


def _zero_extended(t: torch.Tensor, top: int, rows: int, cols: int) -> torch.Tensor:
    """t (B, H, W, C) placed at (top, top) of a zero frame of rows x cols."""
    out = torch.zeros((t.shape[0], rows, cols, t.shape[3]), dtype=t.dtype)
    out[:, top:top + t.shape[1], top:top + t.shape[2]] = t
    return out


def model_bwd_v(src_pad, g, radius: int, d_cols: int, splits: int) -> torch.Tensor:
    """combine_bwd_v_tc_kernel's tiling: per (image, 8x8 tile), D = g_tile .
    window^T over each split's contiguous range of 64-channel slabs, the
    band gathered from D, the splits' partial bands added in rank order,
    columns d >= K^2 zero. Frames are zero-extended to whole tiles, as the
    kernel zero-fills its staging."""
    b, h, w, c = g.shape
    k2, win = (2 * radius + 1) ** 2, TILE + 2 * radius
    th, tw = -(-h // TILE), -(-w // TILE)
    gz = _zero_extended(g, 0, th * TILE, tw * TILE)
    sz = _zero_extended(src_pad, 0, th * TILE + 2 * radius, tw * TILE + 2 * radius)
    n_v, _ = _band_index(radius)
    slab = lc.TILING["v_slab"]
    n_slabs = -(-c // slab)
    per = -(-n_slabs // splits)
    ranges = [(min(n_slabs, r * per) * slab, min(n_slabs, r * per + per) * slab)
              for r in range(splits)]
    dv = torch.zeros((b, th * TILE, tw * TILE, d_cols), dtype=g.dtype)
    for bi in range(b):
        for ty in range(0, th * TILE, TILE):
            for tx in range(0, tw * TILE, TILE):
                a = gz[bi, ty:ty + TILE, tx:tx + TILE].reshape(TILE * TILE, c)
                window = sz[bi, ty:ty + win, tx:tx + win].reshape(win * win, c)
                band = None
                for lo, hi in ranges:
                    part = torch.gather(a[:, lo:hi] @ window[:, lo:hi].T, 1, n_v)
                    band = part if band is None else band + part
                dv[bi, ty:ty + TILE, tx:tx + TILE, :k2] = band.reshape(TILE, TILE, k2)
    return dv[:, :h, :w]


def model_bwd_src(v, g, radius: int) -> torch.Tensor:
    """combine_bwd_src_tc_kernel's tiling: per (image, 8x8 tile of the
    padded frame, 128 channels), Wt built by scattering each tile pixel's
    K^2 coefficients of the window pixels it reads (zero off the band and
    outside the image), then dsrc_tile = Wt . g_window."""
    b, h, w, c = g.shape
    k2, win = (2 * radius + 1) ** 2, TILE + 2 * radius
    hp, wp = h + 2 * radius, w + 2 * radius
    th, tw = -(-hp // TILE), -(-wp // TILE)
    # image pixel (y, x) at (y + 2R, x + 2R): the window of the tile at
    # (ty, tx) of the padded frame starts at (ty, tx) here
    gz = _zero_extended(g, 2 * radius, th * TILE + 2 * radius, tw * TILE + 2 * radius)
    vz = _zero_extended(v[..., :k2], 2 * radius, th * TILE + 2 * radius, tw * TILE + 2 * radius)
    _, n_src = _band_index(radius)
    d_idx = torch.arange(k2).expand_as(n_src)
    groups = lc.TILING["src_channels"]
    dsrc = torch.zeros((b, th * TILE, tw * TILE, c), dtype=g.dtype)
    for bi in range(b):
        for ty in range(0, th * TILE, TILE):
            for tx in range(0, tw * TILE, TILE):
                vw = vz[bi, ty:ty + win, tx:tx + win].reshape(win * win, k2)
                wt = torch.zeros((TILE * TILE, win * win), dtype=g.dtype)
                wt.scatter_(1, n_src, vw[n_src, d_idx])
                gw = gz[bi, ty:ty + win, tx:tx + win].reshape(win * win, c)
                for c0 in range(0, c, groups):
                    dsrc[bi, ty:ty + TILE, tx:tx + TILE, c0:c0 + groups] = (
                        wt @ gw[:, c0:c0 + groups]).reshape(TILE, TILE, -1)
    return dsrc[:, :hp, :wp]


# (b, h, w, c, extra coefficient columns): off the tile grid, C not a
# multiple of 16, d_cols > K^2, several slabs and channel groups
SHAPES = [(2, 13, 11, 6, 15), (1, 9, 20, 70, 0), (1, 16, 8, 130, 7)]


def _case(shape, radius):
    b, h, w, c, extra = shape
    rng = np.random.RandomState(h * w + c + radius)
    t = lambda *s: torch.from_numpy(rng.randn(*s))
    k2 = (2 * radius + 1) ** 2
    return (t(b, h + 2 * radius, w + 2 * radius, c), t(b, h, w, k2 + extra), t(b, h, w, c),
            k2 + extra)


@pytest.mark.parametrize("radius", [3, 5])
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_v_tiled_model_matches_plain_version(shape, radius):
    """The model of bwd_v's tiling, with the wrapper's channel splits and
    with every split count the cluster takes, equals the plain dv in
    float64 to 1e-12 of its largest entry; the extra columns are zero."""
    src, v, g, d_cols = _case(shape, radius)
    _, ref = lc.local_combine_backward_reference(src, None, g, radius, need_src=False)
    scale = float(ref.abs().max())
    b, h, w, c, _ = shape
    slabs = -(-c // lc.TILING["v_slab"])
    for splits in sorted({lc.bwd_v_splits(b, h, w, c), *range(1, slabs + 1)}):
        dv = model_bwd_v(src, g, radius, d_cols, splits)
        k2 = (2 * radius + 1) ** 2
        assert dv.shape == (b, h, w, d_cols)
        assert not dv[..., k2:].any()
        assert float((dv[..., :k2] - ref).abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("radius", [3, 5])
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_src_tiled_model_matches_plain_version(shape, radius):
    """The model of bwd_src's tiling (tiles of the padded frame, Wt built
    from the coefficient rows, g zero outside the image) equals the plain
    dsrc in float64 to 1e-12 of its largest entry."""
    src, v, g, _ = _case(shape, radius)
    ref, _ = lc.local_combine_backward_reference(None, v, g, radius, need_v=False)
    dsrc = model_bwd_src(v, g, radius)
    assert dsrc.shape == ref.shape
    assert float((dsrc - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


def test_bwd_v_splits():
    """bwd_v's channel splits at the main path's layers (256 px, batch 4):
    none where the tiles fill the card (128x128, 64x64), a cluster of 2 at
    32x32 (64 tiles, 128 blocks); never more than the slabs or 8."""
    assert [lc.bwd_v_splits(4, s, s, c) for s, c in ((128, 128), (64, 256), (32, 512))] == [1, 1, 2]
    assert lc.bwd_v_splits(1, 8, 8, 6) == 1
    assert lc.bwd_v_splits(1, 8, 8, 2048) == lc.TILING["v_max_splits"]


def _stand_in_card(monkeypatch) -> list:
    """The card stood in for: device checks pass and every entry point
    returns success (meta tensors stand in for CUDA ones: no card needed). Returns the
    list of (symbol, argument count, arguments) launched."""
    asked = []

    def entry_point(symbol, argtypes):
        def launch(*args):
            assert len(args) == len(argtypes)
            asked.append((symbol, len(argtypes), args))
            return 0
        return launch

    monkeypatch.setattr(_cuda, "require_cuda", lambda *tensors: None)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda: 0)
    monkeypatch.setattr(_cuda, "kernel", lambda lib, symbol, argtypes: (
        entry_point(symbol, argtypes) if lib == "local_combine" else None))
    _cuda.reset_launch_counts()
    return asked


def _meta(*shape, dt):
    return torch.empty(*shape, device="meta", dtype=dt)


@pytest.mark.parametrize("extra", [0, 7])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("side", ["src", "v"])
def test_dtype_picks_the_entry_point(side, dtype, extra, monkeypatch):
    """A bf16 backward on device tensors reaches the tensor-core entry point
    and its counter (`*_tc`; bwd_src with exactly K^2 coefficient columns,
    bwd_v with the wrapper's channel splits), an f32 one the FP32 entry
    point and its own (with the bf16 flag 0) and the columns as given."""
    asked = _stand_in_card(monkeypatch)
    b, h, w, c, r = 4, 32, 32, 512, 5
    k2 = (2 * r + 1) ** 2
    d_cols = k2 + extra
    dsrc, dv = lc.local_combine_backward(
        _meta(b, h + 2 * r, w + 2 * r, c, dt=dtype), _meta(b, h, w, d_cols, dt=dtype),
        _meta(b, h, w, c, dt=dtype), r, d_cols, need_src=side == "src", need_v=side == "v")
    tc = dtype == torch.bfloat16
    name = f"local_combine_bwd_{side}" + ("_tc" if tc else "")
    assert [(s, n) for s, n, _ in asked] == [("hoig_" + name, 11 if side == "v" or not tc else 10)]
    args = asked[0][2]
    assert args[3:9] == (b, h, w, c, k2 if side == "src" and tc else d_cols, r)
    if side == "v":
        assert dsrc is None and dv.shape == (b, h, w, d_cols) and dv.dtype == dtype
        assert args[9] == (2 if tc else 0)  # bwd_v_tc: the channel splits; FP32: the bf16 flag
    else:
        assert dv is None and dsrc.shape == (b, h + 2 * r, w + 2 * r, c) and dsrc.dtype == dtype
        if not tc:
            assert args[9] == 0
    assert _cuda.launch_counts() == {name: 1}


def test_bf16_shift_backward_reaches_the_tensor_cores(monkeypatch):
    """The shift engine's two combines of one attention layer under bf16,
    forward and backward through the autograd Function (meta tensors stand
    in for the card): R = 3 over G needs dsrc only, R = 5 over the source
    both sides; every backward launch is a tensor-core one."""
    asked = _stand_in_card(monkeypatch)
    bf16 = torch.bfloat16
    b, h, w = 2, 8, 8
    g_field = _meta(b, h + 6, w + 6, 128, dt=bf16).requires_grad_()
    coef = _meta(b, h, w, 49, dt=bf16)  # the coefficient fields carry no gradient
    src = _meta(b, h + 10, w + 10, 64, dt=bf16).requires_grad_()
    v = _meta(b, h, w, 121, dt=bf16).requires_grad_()
    out = lc.local_combine(g_field, coef, 3).float().sum() + lc.local_combine(src, v, 5).float().sum()
    out.backward()
    assert sorted(s for s, _, _ in asked) == sorted([
        "hoig_local_combine_fwd", "hoig_local_combine_fwd", "hoig_local_combine_bwd_src_tc",
        "hoig_local_combine_bwd_src_tc", "hoig_local_combine_bwd_v_tc"])
    assert _cuda.launch_counts() == {"local_combine": 2, "local_combine_bwd_src_tc": 2,
                                     "local_combine_bwd_v_tc": 1}
    assert g_field.grad.shape == g_field.shape and src.grad.shape == src.shape
    assert v.grad.shape == v.shape and coef.grad is None


@pytest.mark.parametrize("case", ["radius_6", "float16", "mixed"])
def test_no_fallback(case, monkeypatch):
    """A device call that neither route takes raises before any launch:
    bf16 at a radius the tensor-core kernels are not built for, a dtype
    that has no kernel, a bf16 cotangent with f32 coefficients. Nothing
    runs the FP32 kernel or the plain version instead."""
    asked = _stand_in_card(monkeypatch)
    monkeypatch.setattr(lc, "local_combine_backward_reference", lambda *a, **k: (
        pytest.fail("the plain version ran for a device tensor")))
    r, dt, vdt = {"radius_6": (6, torch.bfloat16, torch.bfloat16),
                  "float16": (2, torch.float16, torch.float16),
                  "mixed": (2, torch.bfloat16, torch.float32)}[case]
    b, h, w, c = 1, 8, 8, 16
    k2 = (2 * r + 1) ** 2
    with pytest.raises((ValueError, TypeError)):
        lc.local_combine_backward(_meta(b, h + 2 * r, w + 2 * r, c, dt=dt),
                                  _meta(b, h, w, k2, dt=vdt), _meta(b, h, w, c, dt=dt), r, k2)
    assert asked == [] and _cuda.launch_counts() == {}
