"""hoig_torch's fused flow-attention engine (hoig_torch/ops/attn_fused.py,
the counterpart of hoig_tpu/ops/attn_pallas.py) on the CPU: each kernel's
plain version against the JAX package's Pallas kernel in interpret mode,
the autograd Function against jax.grad of the oracle of
tests/test_attn_pallas.py, ExtractorAttn("pallas") against the port's shift
engine, the small generator with the fused engine against the JAX package,
and the wrappers' device policy. Inputs come from numpy seeds, flows in the
JAX package's bound [-2.95, 1.95)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_attn_pallas import make_inputs, oracle
from test_torch_generator import _flax_params, _generator_inputs

from hoig_tpu.models import NetworksFactory as JaxFactory
from hoig_tpu.ops import attn_pallas as ap
from hoig_torch.models import NetworksFactory, convert
from hoig_torch.models.generator import ExtractorAttn
from hoig_torch.ops import attn_fused as af
from hoig_torch.train.trainer import TrainConfig

# parallel test workers each run torch's CPU kernels; one intra-op thread per
# worker keeps them from contending for the same cores
torch.set_num_threads(1)


def T(x) -> torch.Tensor:
    return torch.tensor(np.array(x))


@pytest.mark.parametrize("kernel", ["fwd", "bwd_c", "bwd_a"])
def test_plain_versions_match_jax_kernels(kernel):
    """Each plain version against the pallas_call that runs its TPU kernel
    (interpret mode), on (1, 16, 16, 8) f32: 2e-5 for the forward's outputs,
    2e-4 for the gradients (the bounds of tests/test_attn_pallas.py)."""
    rng = np.random.RandomState(0)
    b, h, w, c = 1, 16, 16, 8
    src, acc0, w0s, w1, b1, flow = make_inputs(rng, b, h, w, c)
    fields = ap._flow_fields(flow)
    tfields = af.flow_fields(T(flow))
    for got, ref in zip(tfields, fields):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if kernel == "fwd":
        ref = ap._fwd_call(src, acc0, w0s, w1, b1, *fields, interpret=True)
        got = af.attn_fused_fwd(T(src), T(acc0), T(w0s), T(w1), T(b1), *tfields)
        tol = 2e-5
    elif kernel == "bwd_c":
        attn = jax.nn.softmax(jnp.asarray(rng.randn(b, h, w, af.K2), jnp.float32), axis=-1)
        g_out = jnp.asarray(rng.randn(b, h, w, c), jnp.float32)
        ref = ap._bwd_c_call(src, *fields, attn, g_out, interpret=True)
        got = af.attn_fused_bwd_c(T(src), *tfields, T(attn), T(g_out))
        tol = 2e-4
    else:
        g_acc = jnp.asarray(rng.randn(b, h, w, af.F), jnp.float32)
        ref = ap._bwd_a_call(src, w0s, *fields, g_acc, interpret=True)
        # dW takes the dG that the gsrc step built
        gsrc_a, dg = af.attn_fused_bwd_a_gsrc(T(g_acc), *tfields, T(w0s))
        got = (gsrc_a, af.attn_fused_bwd_a_dw(T(src), dg))
        tol = 2e-4
    assert len(got) == len(ref)
    for i, (a, r) in enumerate(zip(got, ref)):
        assert tuple(a.shape) == r.shape and a.dtype == torch.float32, i
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=tol, atol=tol,
                                   err_msg=f"{kernel} output {i}")


@pytest.mark.parametrize("shape", [(1, 48, 40, 16), (1, 8, 8, 256)])
def test_fused_function_matches_oracle(shape):
    """FlowAttentionFused's output and its gradients w.r.t. src, acc0, w0s,
    w1 and b1 against the oracle (a multi-tile frame of the TPU kernels, and
    two of their 128-channel chunks); forward 2e-5, gradients 2e-4."""
    rng = np.random.RandomState(1)
    b, h, w, c = shape
    args = make_inputs(rng, b, h, w, c)
    flow = args[5]
    cot = rng.randn(b, h, w, c).astype(np.float32)

    def loss(*params):
        return jnp.sum(oracle(*params, flow) * cot)

    with jax.default_matmul_precision("highest"):
        want_out = oracle(*args)
        want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(*args[:5])
    leaves = [T(a).requires_grad_() for a in args[:5]]
    out = af.flow_attention_fused(*leaves, *af.flow_fields(T(flow)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=2e-5, atol=2e-5)
    (out * T(cot)).sum().backward()
    for name, leaf, ref in zip(("src", "acc0", "w0s", "w1", "b1"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_extractor_attn_pallas_matches_shift_engine():
    """The fused engine and the shift engine on one state dict: the output,
    and the gradients w.r.t. source, target and every weight, within 1e-5 of
    each one's largest entry (f32, other summation orders)."""
    rng = np.random.RandomState(6)
    b, h, w, c = 2, 12, 10, 8
    src, tgt, cot = (T(rng.randn(b, h, w, c).astype(np.float32)) for _ in range(3))
    flow = T((rng.rand(b, h, w, 2) * 4.9 - 2.95).astype(np.float32))
    torch.manual_seed(0)
    shift = ExtractorAttn(c, 5, "shift")
    fused = ExtractorAttn(c, 5, "pallas")
    fused.load_state_dict(shift.state_dict())
    results = []
    for m in (shift, fused):
        s_, t_ = src.clone().requires_grad_(), tgt.clone().requires_grad_()
        out = m(s_, t_, flow)
        (out * cot).sum().backward()
        results.append([out.detach(), s_.grad, t_.grad] + [p.grad for p in m.parameters()])
    names = ["out", "source", "target"] + [n for n, _ in fused.named_parameters()]
    for name, a, ref in zip(names, results[1], results[0]):
        np.testing.assert_allclose(a.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-5 * float(ref.abs().max()), err_msg=name)
    with pytest.raises(NotImplementedError):
        ExtractorAttn(c, 3, "pallas")(src, tgt, flow)


def test_generator_with_fused_engine_matches_jax():
    """generator_spade_attn (conv_dim 8, repeat 2, 32 px, batch 1) with the
    fused engine in both packages, the JAX side's kernels in interpret mode,
    on weights carried by generator_state_dict_from_flax; the bound of
    tests/test_torch_generator.py (rtol 2e-4, atol 2e-5). This holds every
    ExtractorAttn("pallas") of the generator against the JAX package's."""
    dims = dict(bg_dim=8, img_dim=3, obj_dim=3, img_cond_dim=3, obj_cond_dim=12, conv_dim=8,
                repeat_num=2)
    kw = _generator_inputs(s=32, b=1)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    g = JaxFactory.get_by_name("generator_spade_attn", **dims, remat=False, corner_engine="pallas")
    # the engines share one parameter tree; the shift engine traces faster
    params = _flax_params(JaxFactory.get_by_name("generator_spade_attn", **dims, remat=False,
                                                 corner_engine="shift"), 3, **jkw)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(g.apply)(params, **jkw)
    tg = NetworksFactory.get_by_name("generator_spade_attn", **dims, corner_engine="pallas",
                                     device="cpu")
    tg.load_state_dict(convert.generator_state_dict_from_flax(params, TrainConfig(repeat_num=2)))
    with torch.inference_mode():
        out = tg(**{k: torch.as_tensor(v) for k, v in kw.items()})
    assert len(out) == len(ref) == 10
    for i, (a, r) in enumerate(zip(out, ref)):
        assert tuple(a.shape) == r.shape, i
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=2e-4, atol=2e-5,
                                   err_msg=f"output {i}")


def _bwd_c_tiled(src, fy_rel, fx_rel, wy, wx, attn, g_out):
    """B4-bwd-c computed as csrc/attn_fused.cu's bwd_c_kernel and
    bwd_c_gattn_kernel compute it: per image, tile of TILING's bwd_c_tile
    pixels and group of bwd_c_channels channels; each pixel's 36 nonzero V_d
    on the 6 x 6 box at its relative floor, rounded to the source dtype; each
    padded pixel that folds onto an output pixel summed over its terms in
    ascending d, the margins folded in the tile (columns of a row, then
    rows), / 25; the 36 dots per group from the clamped source, the groups
    added in order, then the coefficients. Asserts that every source pixel
    it reads lies within the tile's +-PAD window, which is all that the
    kernel stages. Returns (gsrc_c, g_attn) f32."""
    tile, group = af.TILING["bwd_c_tile"], af.TILING["bwd_c_channels"]
    b, h, w, c = src.shape
    dt = src.dtype
    g = g_out.to(dt)
    ay = (1.0 - wy, wy)
    ax = (1.0 - wx, wx)
    at = attn.float().reshape(b, h, w, af.K, af.K)
    vbox = torch.zeros((b, h, w, 6, 6))
    for jy in range(6):
        for jx in range(6):
            val = torch.zeros((b, h, w))
            for cy in (0, 1):
                if 0 <= jy - cy <= 4:
                    vx = torch.zeros((b, h, w))
                    for cx in (0, 1):
                        if 0 <= jx - cx <= 4:
                            vx = vx + ax[cx] * at[..., jy - cy, jx - cx]
                    val = val + ay[cy] * vx
            vbox[..., jy, jx] = val
    vbox = vbox.to(dt)
    oy = (fy_rel + 3).long().tolist()  # the box's first d index per axis
    ox = (fx_rel + 3).long().tolist()
    gsrc = torch.zeros((b, h, w, c))
    dots = torch.zeros((b, h, w, af.BOX))
    pad = af.PAD
    for bb in range(b):
        for ty0 in range(0, h, tile):
            for tx0 in range(0, w, tile):
                def in_window(y, x):
                    return ty0 - pad <= y < ty0 + tile + pad and tx0 - pad <= x < tx0 + tile + pad

                for c0 in range(0, c, group):
                    chans = slice(c0, min(c, c0 + group))
                    for y in range(ty0, min(h, ty0 + tile)):
                        for x in range(tx0, min(w, tx0 + tile)):
                            rows = range(0 if y == 0 else y + pad,
                                         (h + 2 * pad if y == h - 1 else y + pad + 1))
                            cols = range(0 if x == 0 else x + pad,
                                         (w + 2 * pad if x == w - 1 else x + pad + 1))
                            tot = torch.zeros(chans.stop - c0)
                            for r in rows:
                                row = torch.zeros_like(tot)
                                for cc in cols:
                                    a = torch.zeros_like(tot)
                                    for d in range(af.NSHIFT ** 2):
                                        dyi, dxi = divmod(d, af.NSHIFT)
                                        qy, qx = r - dyi, cc - dxi
                                        if not (0 <= qy < h and 0 <= qx < w):
                                            continue
                                        assert in_window(qy, qx), (y, x, qy, qx)
                                        by, bx = dyi - oy[bb][qy][qx], dxi - ox[bb][qy][qx]
                                        if 0 <= by < 6 and 0 <= bx < 6:
                                            a = a + (vbox[bb, qy, qx, by, bx] * g[bb, qy, qx, chans]).float()
                                    row = row + a
                                tot = tot + row
                            gsrc[bb, y, x, chans] = af._div25(tot)
                            for j in range(af.BOX):
                                sy = min(max(y + oy[bb][y][x] - pad + j // 6, 0), h - 1)
                                sx = min(max(x + ox[bb][y][x] - pad + j % 6, 0), w - 1)
                                assert in_window(sy, sx), (y, x, sy, sx)
                                dots[bb, y, x, j] += (g[bb, y, x, chans]
                                                      * src[bb, sy, sx, chans]).float().sum()
    ga = torch.zeros((b, h, w, af.K2))
    for t in range(af.K2):
        ty, tx = divmod(t, af.K)
        val = torch.zeros((b, h, w))
        for cy in (0, 1):
            sx = torch.zeros((b, h, w))
            for cx in (0, 1):
                sx = sx + ax[cx] * dots[..., (ty + cy) * 6 + tx + cx]
            val = val + ay[cy] * sx
        ga[..., t] = af._div25(val)
    return gsrc, ga


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 1, 1, 4), (1, 1, 9, 4), (2, 7, 1, 2), (1, 5, 10, 6),
                                   (1, 17, 9, 4), (1, 11, 13, 70)])
def test_bwd_c_tiled_algorithm_matches_plain_version(shape, dtype):
    """bwd_c_kernel's algorithm (_bwd_c_tiled) against the plain version:
    gsrc_c bit-equal in f32 and bf16, g_attn within 1e-5 (f32) or 1e-4 (bf16)
    of its largest entry (the channel sums in another order). Frames with
    H or W equal to 1 (one pixel collects both margins), below 11, off the
    8 x 8 tile grid, with interior tiles, and C = 70 in two channel groups."""
    rng = np.random.RandomState(7)
    b, h, w, c = shape
    dt = getattr(torch, dtype)
    src = T(rng.randn(b, h, w, c).astype(np.float32)).to(dt)
    g_out = T(rng.randn(b, h, w, c).astype(np.float32)).to(dt)
    attn = torch.softmax(T(rng.randn(b, h, w, af.K2).astype(np.float32)), -1)
    flow = T((rng.rand(b, h, w, 2) * 4.9 - 2.95).astype(np.float32))
    args = (src, *af.flow_fields(flow), attn, g_out)
    got_gsrc, got_ga = _bwd_c_tiled(*args)
    ref_gsrc, ref_ga = af.attn_fused_bwd_c_reference(*args)
    assert torch.equal(got_gsrc, ref_gsrc)
    tol = 1e-5 if dt == torch.float32 else 1e-4
    assert float((got_ga - ref_ga).abs().max()) <= tol * float(ref_ga.abs().max())


@pytest.mark.parametrize("kernel", ["fwd", "bwd_c", "bwd_a_gsrc", "bwd_a_dw"])
def test_device_tensors_go_to_the_kernel(kernel, monkeypatch):
    """A tensor that is not on the CPU never reaches the plain version: the
    wrapper goes to its kernel, which refuses a tensor off the current CUDA
    device (here a meta tensor: this machine has no card)."""
    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran for a device tensor")

    for name in ("fwd", "bwd_c", "bwd_a_gsrc", "bwd_a_dw"):
        monkeypatch.setattr(af, f"attn_fused_{name}_reference", refuse)
    b, h, w, c = 1, 4, 4, 2
    meta = lambda *shape: torch.empty(*shape, device="meta")
    src, fields = meta(b, h, w, c), [meta(b, h, w) for _ in range(4)]
    calls = {
        "fwd": lambda: af.attn_fused_fwd(src, meta(b, h, w, af.F), meta(af.K2, c, af.F),
                                         meta(af.F, af.K2), meta(1, af.K2), *fields),
        "bwd_c": lambda: af.attn_fused_bwd_c(src, *fields, meta(b, h, w, af.K2), src),
        "bwd_a_gsrc": lambda: af.attn_fused_bwd_a_gsrc(meta(b, h, w, af.F), *fields,
                                                       meta(af.K2, c, af.F)),
        "bwd_a_dw": lambda: af.attn_fused_bwd_a_dw(src, meta(b, h + 6, w + 6, af.F)),
    }
    with pytest.raises(ValueError, match="CUDA"):
        calls[kernel]()


class _FakeLibrary:
    def hoig_error_string(self, err):
        return b"invalid argument"


@pytest.mark.parametrize("case", ["odd_channels", "failed_launch", "failed_bwd_c",
                                  "failed_combine_bwd"])
def test_refused_launch_raises(case, monkeypatch):
    """A launch the kernels cannot take, or one that returns a CUDA error,
    raises a RuntimeError or ValueError naming the kernel and counts no
    launch. The card is stood in for: device checks pass, the entry point
    returns cudaErrorInvalidValue (1), the error string comes from the
    library that holds the kernel. Each entry point gets as many arguments
    as its declared types (bwd_c: 10 pointers, then B, H, W, C, its channel
    groups and the bf16 flag, then the stream)."""
    from hoig_torch.ops import _cuda, local_combine

    asked, passed = [], []

    def entry_point(argtypes):
        def launch(*args):
            assert len(args) == len(argtypes)
            passed.append(args)
            return 1
        return launch

    monkeypatch.setattr(_cuda, "require_cuda", lambda *tensors: None)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda: 0)
    monkeypatch.setattr(_cuda, "kernel", lambda lib, symbol, argtypes: (
        asked.append(("kernel", lib)) or entry_point(argtypes)))
    monkeypatch.setattr(_cuda, "_library", lambda lib: asked.append(("error", lib)) or
                        _FakeLibrary())
    _cuda.reset_launch_counts()
    meta = lambda *shape: torch.empty(*shape, device="meta")
    b, h, w = 1, 4, 4
    fields = [meta(b, h, w) for _ in range(4)]
    if case == "odd_channels":
        with pytest.raises(ValueError, match="even channel count, got 3"):
            af.attn_fused_bwd_a_dw(meta(b, h, w, 3), meta(b, h + 6, w + 6, af.F))
        assert asked == []
    elif case == "failed_launch":
        with pytest.raises(RuntimeError, match=r"attn_fused_fwd kernel launch failed: CUDA error 1 "
                                               r"\(invalid argument\)"):
            af.attn_fused_fwd(meta(b, h, w, 2), meta(b, h, w, af.F), meta(af.K2, 2, af.F),
                              meta(af.F, af.K2), meta(1, af.K2), *fields)
        assert asked == [("kernel", "attn_fused"), ("error", "attn_fused")]
    elif case == "failed_bwd_c":
        src = meta(2, h, w, 130)
        with pytest.raises(RuntimeError, match="attn_fused_bwd_c kernel launch failed"):
            af.attn_fused_bwd_c(src, *[meta(2, h, w) for _ in range(4)], meta(2, h, w, af.K2), src)
        assert asked == [("kernel", "attn_fused"), ("error", "attn_fused")]
        assert passed[0][10:16] == (2, h, w, 130, 3, 0)  # ceil(130 / 64) channel groups, f32
    else:
        src_pad = meta(b, h + 2, w + 2, 2)
        with pytest.raises(RuntimeError, match="local_combine_bwd_src kernel launch failed"):
            local_combine._launch("hoig_local_combine_bwd_src", "local_combine_bwd_src", src_pad,
                                  meta(b, h, w, 9), meta(b, h, w, 2), (b, h, w, 2, 9), 1)
        assert asked == [("kernel", "local_combine"), ("error", "local_combine")]
    assert _cuda.launch_counts() == {}
