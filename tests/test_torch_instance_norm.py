"""InstanceNorm's hand-written route (hoig_torch/ops/instance_norm.py,
csrc/instance_norm.cu) on the CPU, torch only: `InstanceNormFn`'s plain
path (the kernels' arithmetic: f32 statistics, y and dx in f32 rounded
once) against today's `FoldedStats` plus the apply, the keep_stats contract
through it, the chunk plan the kernels sum in, and the dispatch to the
entry points on a stood-in card (meta tensors, the entry points replaced).
The kernels themselves are held to these plain versions on the card by
chip_smoke.py."""

import pytest
import torch
import torch.nn as nn

from hoig_torch.models import layers as L
from hoig_torch.models.generator import _run
from hoig_torch.ops import _cuda
from hoig_torch.ops import instance_norm as IN

torch.set_num_threads(1)

EPS = 1e-5
# (B, C, H, W): odd H x W (the discriminator's 15 x 15), a square plane, one pixel
SHAPES = [(3, 5, 7, 6), (2, 8, 15, 15), (2, 4, 1, 1)]


def _input(shape, dtype, channels_last, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = (3 * torch.randn(shape, generator=g) + 1).to(dtype)
    dy = torch.randn(shape, generator=g).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
        dy = dy.contiguous(memory_format=torch.channels_last)
    w = torch.randn(shape[1], generator=g)
    b = torch.randn(shape[1], generator=g)
    return x, dy, w, b


def _today(x, w, b, cd):
    """FoldedStats plus the apply, as InstanceNorm ran them on every device
    before the kernels (and still does on the CPU)."""
    a, o = IN.FoldedStats.apply(x, w, b, EPS, None)
    return x.to(cd) * a.to(cd) + o.to(cd)


def _close(got, want, tol):
    """Within tol of the largest entry of `want`."""
    err = float((got.detach().float() - want.detach().float()).abs().max())
    return err <= tol * float(want.float().abs().max()), err


def _ulp_bf16(r):
    e = torch.floor(torch.log2(r.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_function_matches_folded_stats(shape, channels_last, affine, dtype):
    """InstanceNormFn on CPU tensors (the kernels' plain versions) against
    FoldedStats plus the apply. f32: the forward bit-equal, dx, dweight and
    dbias within 1e-6 of their largest entry (the sums in another order).
    bf16 rounds y and dx once, where the plain version rounded a and b to
    bf16 first: its forward is bit-equal to that path run in f32 on the
    same values and rounded once, dx within one bf16 ulp of it, dweight
    and dbias within 1e-6 (f32 sums of the same values)."""
    dt = getattr(torch, dtype)
    x, dy, w, b = _input(shape, dt, channels_last)
    if not affine:
        w = b = None
    xg = x.clone().requires_grad_()
    params = [xg] + ([w.clone().requires_grad_(), b.clone().requires_grad_()] if affine else [])
    y = IN.InstanceNormFn.apply(xg, *(params[1:] if affine else (None, None)), EPS, None, None)
    assert y.dtype == dt and y.stride() == x.stride()
    got = torch.autograd.grad(y, params, dy)

    # the plain path in f32 on the same values: bf16 upcasts exactly
    xf = x.float().requires_grad_()
    ref_params = [xf] + ([p.detach().clone().requires_grad_() for p in params[1:]])
    ref = _today(xf, *(ref_params[1:] if affine else (None, None)), torch.float32)
    want = torch.autograd.grad(ref, ref_params, dy.float())
    assert torch.equal(y, ref.to(dt))
    if dt == torch.float32:
        assert torch.equal(y, _today(x, w, b, dt))
        for a, r in zip(got, want):
            ok, err = _close(a, r, 1e-6)
            assert ok, err
    else:
        dx, dxr = got[0].float(), want[0].to(dt).float()
        assert bool(((dx - dxr).abs() <= _ulp_bf16(dxr) + 1e-6 * dxr.abs().max()).all())
        for a, r in zip(got[1:], want[1:]):
            ok, err = _close(a, r, 1e-6)
            assert ok, err
        # today's bf16 path (a and b rounded to bf16 first) differs by rounding
        # only, where a pixel's x * a does not all but cancel against b
        if shape[2] * shape[3] > 1:
            ok, err = _close(y, _today(x, w, b, dt), 2.0 ** -6)
            assert ok, err


def _route_through_function(monkeypatch, outputs=None):
    """InstanceNorm on CPU tensors through InstanceNormFn (the route the card
    takes), recording each call's output."""

    def norm(x, weight, bias, eps, cd, kept=None, keep=None):
        y = IN.InstanceNormFn.apply(x.to(cd), weight, bias, eps, kept, keep)
        if outputs is not None:
            outputs.append((kept is not None, y.detach().clone()))
        return y

    monkeypatch.setattr(L, "instance_norm", norm)


def _block():
    torch.manual_seed(0)
    block = nn.Sequential(nn.Conv2d(4, 6, 3, padding=1), L.InstanceNorm(6), nn.ReLU(),
                          nn.Conv2d(6, 6, 3, padding=1), L.InstanceNorm(6, affine=False),
                          nn.ReLU())
    with torch.no_grad():
        block[1].weight.uniform_(0.5, 1.5)
        block[1].bias.uniform_(-0.5, 0.5)
    return block


@pytest.mark.parametrize("early_stop", [True, False])
def test_keep_stats_contract_through_the_function(early_stop, monkeypatch):
    """Through InstanceNormFn, a rematerialized block computes each norm's
    statistics once and keeps them for the recompute ("computed", "kept"),
    whose outputs are bit-equal to the first call's; its gradients are
    bit-equal to the block run without remat, and the stash dies with the
    graph."""
    from torch.utils.checkpoint import set_checkpoint_early_stop

    outputs = []
    _route_through_function(monkeypatch, outputs)
    block = _block()
    x = torch.randn(2, 4, 8, 8, requires_grad=True).contiguous(memory_format=torch.channels_last)
    g = torch.randn(2, 6, 8, 8)
    params = [x, *block.parameters()]
    want = torch.autograd.grad(block(x), params, g)
    outputs.clear()
    L.reset_stats_counts()
    live = L.live_stashes()
    with set_checkpoint_early_stop(early_stop):
        y = _run(block, True, x)
        assert L.stats_counts() == {"computed": 2} and L.live_stashes() == live + 1
        got = torch.autograd.grad(y, params, g)
    assert L.stats_counts() == {"computed": 2, "kept": 2}
    first = [o for kept, o in outputs if not kept]
    again = [o for kept, o in outputs if kept]
    assert len(first) == len(again) == 2
    assert all(torch.equal(a, r) for a, r in zip(first, again))
    assert all(torch.equal(a, r) for a, r in zip(got, want))
    del y
    assert L.live_stashes() == live


def test_recompute_node_is_never_differentiated():
    """A call with a kept pair keeps no statistics: differentiating its node
    raises instead of differentiating through nothing."""
    x, dy, w, b = _input((2, 3, 4, 4), torch.float32, True)
    y0, st = IN.norm_forward(x, w, b, EPS)
    xg = x.clone().requires_grad_()
    y = IN.InstanceNormFn.apply(xg, w, b, EPS, (st[0], st[1]), None)
    assert torch.equal(y, y0)
    with pytest.raises(RuntimeError, match="no statistics"):
        y.backward(dy)


@pytest.mark.parametrize("b,c,n,cl,itemsize", [
    (32, 64, 256 * 256, True, 2), (64, 64, 256 * 256, True, 2), (32, 128, 128 * 128, True, 2),
    (64, 256, 64 * 64, True, 2), (32, 512, 32 * 32, True, 2), (16, 512, 32 * 32, True, 2),
    (32, 512, 15 * 15, True, 2), (32, 512, 16 * 16, True, 4), (32, 64, 256 * 256, True, 4),
    (3, 5, 42, True, 4), (2, 8, 225, False, 2), (1, 1, 1, False, 4), (4, 64, 50000, False, 4)])
def test_plan_covers_every_pixel_once(b, c, n, cl, itemsize):
    """The chunk plan: a whole number of the block's pixel steps, at most 32
    chunks a sample, which cover the n pixels once; one wave of 8 blocks on
    each of the 132 SMs unless a chunk is one step or the chunks near their
    cap. The same shape gives the same plan."""
    chunk = IN.plan(b, c, n, cl, itemsize)
    vec = 16 // itemsize
    step = 32 if cl else 32 * vec
    q = -(-n // chunk)
    assert chunk % step == 0 and 1 <= q <= 32 and (q - 1) * chunk < n <= q * chunk
    groups = -(-c // (8 * vec)) if cl else -(-c // 8)
    assert b * groups * q >= 8 * 132 or chunk == step or q > 16
    assert chunk == IN.plan(b, c, n, cl, itemsize)


class _FakeLibrary:
    def hoig_error_string(self, err):
        return b"invalid argument"


def _stand_in_card(monkeypatch, err=0):
    """Meta tensors take the kernel route; each entry point records its
    arguments and returns err."""
    calls = []

    def kernel(lib, symbol, argtypes):
        assert lib == "instance_norm"

        def launch(*args):
            assert len(args) == len(argtypes)
            calls.append((symbol, args))
            return err

        return launch

    monkeypatch.setattr(_cuda, "require_cuda", lambda *tensors: None)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda: 0)
    monkeypatch.setattr(_cuda, "kernel", kernel)
    monkeypatch.setattr(_cuda, "_library", lambda lib: _FakeLibrary())
    for name in ("norm_stats_reference", "norm_apply_reference", "norm_backward_reference"):
        monkeypatch.setattr(IN, name, lambda *a: pytest.fail("plain version"))
    _cuda.reset_launch_counts()
    return calls


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_route_launches(channels_last, dtype, monkeypatch):
    """Off the CPU the forward is hoig_inorm_stats then hoig_inorm_apply on
    one chunk plan, a kept pair hoig_inorm_apply alone (no partials), the
    backward hoig_inorm_bwd_sums, _coef and _dx; counted as inorm_stats,
    inorm_apply and inorm_backward (three a backward)."""
    calls = _stand_in_card(monkeypatch)
    dt = getattr(torch, dtype)
    b, c, h, w = 2, 16, 9, 9
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = torch.empty(b, c, h, w, dtype=dt, device="meta").contiguous(memory_format=fmt)
    wt, bs = torch.empty(c, device="meta"), torch.empty(c, device="meta")
    y, st = IN.norm_forward(x, wt, bs, EPS)
    assert y.shape == x.shape and y.dtype == dt and st.shape == (4, b, c)
    assert y.is_contiguous(memory_format=fmt)
    chunk = IN.plan(b, c, h * w, channels_last, x.element_size())
    (s1, a1), (s2, a2) = calls
    assert (s1, s2) == ("hoig_inorm_stats", "hoig_inorm_apply")
    tail = [b, h * w, c, chunk, int(channels_last), int(dt == torch.bfloat16)]
    assert list(a1[2:8]) == tail and list(a2[10:16]) == tail and a2[5] == EPS
    IN.norm_apply(x, st[0], st[1])
    assert calls[-1][0] == "hoig_inorm_apply" and calls[-1][1][2] is None
    IN.norm_backward(x, torch.empty_like(x), wt, st[0], st[2], st[3])
    assert [s for s, _ in calls[3:]] == ["hoig_inorm_bwd_sums", "hoig_inorm_bwd_coef",
                                          "hoig_inorm_bwd_dx"]
    assert list(calls[4][1][7:11]) == [b, h * w, c, chunk]
    assert _cuda.launch_counts() == {"inorm_stats": 1, "inorm_apply": 2, "inorm_backward": 3}


def test_device_route_refuses_what_the_kernels_do_not_take(monkeypatch):
    """Half precision, a non-4D tensor, strides that are neither
    channels_last nor contiguous, a kept pair of the wrong shape, a weight
    without a bias, a gradient of another dtype, f64 parameters, and a
    launch that returns a CUDA error: each raises, and only the failed
    launch reached an entry point."""
    calls = _stand_in_card(monkeypatch)

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, dtype=dtype, device="meta")

    x = meta(2, 8, 4, 4)
    w = torch.empty(8, device="meta")
    with pytest.raises(TypeError, match="f32 or bf16"):
        IN.norm_forward(meta(2, 8, 4, 4, dtype=torch.float16), None, None, EPS)
    with pytest.raises(ValueError, match=r"\(B, C, H, W\)"):
        IN.norm_forward(meta(2, 8, 16), None, None, EPS)
    with pytest.raises(ValueError, match="channels_last or contiguous"):
        IN.norm_forward(x.transpose(2, 3), None, None, EPS)
    with pytest.raises(ValueError, match="come together"):
        IN.norm_forward(x, w, None, EPS)
    with pytest.raises(ValueError, match="contiguous f32"):
        IN.norm_forward(x, w.double(), w.double(), EPS)
    with pytest.raises(ValueError, match="kept pair"):
        IN.norm_apply(x, meta(2, 4, dtype=torch.float32), meta(2, 4, dtype=torch.float32))
    st = meta(4, 2, 8, dtype=torch.float32)
    with pytest.raises(ValueError, match="gradient"):
        IN.norm_backward(x, meta(2, 8, 4, 4, dtype=torch.float32), None, st[0], st[2], st[3])
    assert calls == [] and _cuda.launch_counts() == {}
    failing = _stand_in_card(monkeypatch, err=1)
    with pytest.raises(RuntimeError, match="inorm_stats kernel launch failed"):
        IN.norm_forward(x, None, None, EPS)
    assert len(failing) == 1 and _cuda.launch_counts() == {}


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On the CPU, InstanceNorm runs FoldedStats and the apply in the compute
    dtype (bit-equal to them), never InstanceNormFn."""
    monkeypatch.setattr(IN.InstanceNormFn, "apply", lambda *a: pytest.fail("kernel route"))
    for cd in (torch.float32, torch.bfloat16):
        norm = L.InstanceNorm(5, compute_dtype=cd)
        x, _, w, b = _input((2, 5, 6, 7), torch.float32, True)
        with torch.no_grad():
            norm.weight.copy_(w)
            norm.bias.copy_(b)
            assert torch.equal(norm(x), _today(x, w, b, cd))


@pytest.mark.parametrize("repeat", [2, 6])
def test_launch_count_follows_the_networks(repeat):
    """flops.instance_norm_launches (the walk's InstanceNorm launches, which
    chip_smoke.py holds the card's counters to) against the networks
    themselves: every InstanceNorm module of generator_spade_attn runs once
    a forward, PatchGAN-4's once a D pass (three a step); the recompute
    applies again the norms outside the residual blocks under remat, all of
    them with remat_bottleneck too; a backward is three launches."""
    import dataclasses

    from hoig_torch.train.trainer import TrainConfig, build_networks
    from hoig_torch.utils import flops

    cfg = TrainConfig(conv_dim=2, repeat_num=repeat, image_size=64, remat=False)
    g, d = build_networks(cfg, device="cpu")
    norms = lambda net: [m for m in net.modules() if isinstance(m, L.InstanceNorm)]
    n_g, n_d = len(norms(g)), len(norms(d))
    in_blocks = {id(m) for blk in g.modules()
                 if isinstance(blk, (L.ResidualBlock, L.SPADEResidualBlock)) for m in norms(blk)}
    assert flops.instance_norm_launches(cfg, "serve") == {"inorm_stats": n_g, "inorm_apply": n_g}
    stats = n_g + 3 * n_d
    for remat, bottleneck, kept in ((False, False, 0), (True, False, n_g - len(in_blocks)),
                                    (True, True, n_g)):
        c = dataclasses.replace(cfg, remat=remat, remat_bottleneck=bottleneck)
        assert flops.instance_norm_launches(c, "train") == {
            "inorm_stats": stats, "inorm_apply": stats + kept, "inorm_backward": 3 * stats}
    assert flops.instance_norm_launches(cfg, "train", d_trainable=False)["inorm_backward"] == \
        3 * (n_g + n_d)
