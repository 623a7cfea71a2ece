"""The generator's replicate pad (hoig_torch/ops/attn_fused.py `edge_pad`)
and the B4 wrappers at an odd channel count, on the CPU.

edge_pad's forward is the exact copy it always was (two index_selects);
its backward folds each border pixel's margin in a fixed order, in f32,
rounded once (`edge_pad_fold`: the plain version here, fold_kernel on the
card), where index_select's backward adds with float atomics on the card.
It is held against jax.vjp of jnp.pad(..., mode="edge") on the same seed,
against a loop model of the kernel's order, and against itself. The B4
wrappers run an odd channel count at the next even one with a zero channel
(`with_even_channels`); that is held against the plain versions at the odd
count."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_attn_pallas import make_inputs

from hoig_torch.ops import attn_fused as af

torch.set_num_threads(1)

# square and ragged frames, and frames where one pixel collects both
# margins of an axis (H or W equal to 1)
FRAMES = [(2, 6, 6, 3), (1, 5, 9, 4), (2, 1, 7, 3), (1, 6, 1, 2), (1, 1, 1, 3)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _index_select_pad(x, p):
    h, w = x.shape[1], x.shape[2]
    rows = torch.arange(-p, h + p).clamp(0, h - 1)
    cols = torch.arange(-p, w + p).clamp(0, w - 1)
    return x.index_select(1, rows).index_select(2, cols)


def _fold_loops(g: np.ndarray, p: int) -> np.ndarray:
    """fold_kernel's order, one output pixel at a time in float32: the
    columns of each margin row in ascending order from the first, then the
    rows in ascending order."""
    b, hp, wp, c = g.shape
    h, w = hp - 2 * p, wp - 2 * p
    out = np.empty((b, h, w, c), np.float32)
    for y in range(h):
        rows = range(0 if y == 0 else y + p, (hp - 1 if y == h - 1 else y + p) + 1)
        for x in range(w):
            cols = range(0 if x == 0 else x + p, (wp - 1 if x == w - 1 else x + p) + 1)
            tot = None
            for r in rows:
                row = g[:, r, cols[0]].astype(np.float32)
                for cc in cols[1:]:
                    row = np.float32(row + g[:, r, cc].astype(np.float32))
                tot = row if tot is None else np.float32(tot + row)
            out[:, y, x] = tot
    return out


@functools.cache
def _jax_pad_vjp(p: int):
    """jax.vjp of jnp.pad(mode="edge") by p over a list of frames, one jit."""
    pad = lambda v: jnp.pad(v, ((0, 0), (p, p), (p, p), (0, 0)), mode="edge")
    return jax.jit(lambda xs, gs: [jax.vjp(pad, x)[1](g)[0] for x, g in zip(xs, gs)])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("p", [2, 5])
def test_edge_pad_matches_jax_pad(p, dtype):
    """For each frame: the forward bit-equal to the index_select form; the
    backward within one bf16 ulp of each entry plus 1e-6 of the largest of
    jax.vjp of jnp.pad(mode="edge"), bit-equal to the kernel's loop order
    (f32 sums rounded once), and bit-equal on a second call. JAX's vjp runs
    in f32 on the same (for bf16: bf16-rounded) values: its bf16 transpose
    on the CPU rounds every add to bf16, several ulps off the sum."""
    tdt = DTYPES[dtype]
    rng = np.random.RandomState(p)
    xs = [torch.tensor(rng.randn(b, h, w, c), dtype=torch.float32).to(tdt).requires_grad_()
          for b, h, w, c in FRAMES]
    gs = [torch.tensor(rng.randn(b, h + 2 * p, w + 2 * p, c), dtype=torch.float32).to(tdt)
          for b, h, w, c in FRAMES]
    refs = _jax_pad_vjp(p)([x.detach().float().numpy() for x in xs],
                           [g.float().numpy() for g in gs])
    for x, g, ref in zip(xs, gs, refs):
        y = af.edge_pad(x, p)
        assert torch.equal(y, _index_select_pad(x.detach(), p))
        gx, = torch.autograd.grad(y, x, g)
        gx2, = torch.autograd.grad(af.edge_pad(x, p), x, g)
        assert gx.dtype == tdt and torch.equal(gx, gx2)
        ref = np.asarray(ref)
        got = gx.float().numpy()
        tol = 2.0 ** -7 * np.abs(ref) + 1e-6 * np.abs(ref).max()
        assert (np.abs(got - ref) <= tol).all(), tuple(x.shape)
        loops = torch.tensor(_fold_loops(g.float().numpy(), p)).to(tdt)
        assert torch.equal(gx, loops), tuple(x.shape)


@pytest.mark.parametrize("c", [1, 7])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_odd_channels_run_at_the_next_even_count(c, dtype):
    """with_even_channels (what each B4 wrapper does with an odd C on the
    card) around the plain versions, against the plain versions at C:
    the outputs that carry no channel axis within 1e-5 of their largest
    entry, the per-channel ones too (a zero channel adds exact zeros; the
    channel sums may take another order at C + 1)."""
    tdt = DTYPES[dtype]
    rng = np.random.RandomState(c)
    b, h, w = 2, 6, 9
    src, acc0, w0s, w1, b1, flow = (torch.tensor(np.asarray(a)) for a in
                                    make_inputs(rng, b, h, w, c))
    src, w0s = src.to(tdt), w0s.to(tdt)
    fields = af.flow_fields(flow)
    attn = torch.softmax(torch.tensor(rng.randn(b, h, w, af.K2), dtype=torch.float32), -1)
    g_out = torch.tensor(rng.randn(b, h, w, c), dtype=torch.float32).to(tdt)
    g_acc = torch.tensor(rng.randn(b, h, w, af.F), dtype=torch.float32)
    dg = af.attn_fused_bwd_a_gsrc_reference(g_acc, *fields, w0s)[1]
    calls = {
        "attn_fused_fwd": (af.attn_fused_fwd_reference, (src, acc0, w0s, w1, b1, *fields)),
        "attn_fused_bwd_c": (af.attn_fused_bwd_c_reference, (src, *fields, attn, g_out)),
        "attn_fused_bwd_a_gsrc": (af.attn_fused_bwd_a_gsrc_reference, (g_acc, *fields, w0s)),
        "attn_fused_bwd_a_dw": (af.attn_fused_bwd_a_dw_reference, (src, dg)),
    }
    for name, (fn, args) in calls.items():
        ref, got = fn(*args), af.with_even_channels(name, fn, *args)
        ref, got = (ref,) if torch.is_tensor(ref) else ref, (got,) if torch.is_tensor(got) else got
        assert len(got) == len(ref), name
        for i, (a, r) in enumerate(zip(got, ref)):
            assert a.shape == r.shape and a.dtype == r.dtype, (name, i)
            err = float((a.float() - r.float()).abs().max())
            top = float(r.float().abs().max())
            # out in bf16: one bf16 ulp of the largest entry
            tol = 2.0 ** -7 if a.dtype == torch.bfloat16 else 1e-5
            assert err <= tol * top, (name, i, err, top)


class _FakeLibrary:
    def hoig_error_string(self, err):
        return b"invalid argument"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("err", [0, 1])
def test_device_gradient_goes_to_the_fold_kernel(dtype, err, monkeypatch):
    """A gradient off the CPU goes to hoig_edge_pad_fold (here on a stood-in
    card: meta tensors, the entry point replaced) with B, H, W, C, the pad
    and the bf16 flag (pointers as c_void_p, the rest as c_int), and counts
    one edge_pad_fold launch; so does a frame whose C is not a multiple of
    the 16-byte vector (the kernel's scalar path); a launch that returns a
    CUDA error raises and counts none."""
    import ctypes

    from hoig_torch.ops import _cuda

    passed = []

    def launch(*args):
        passed.append(args)
        return err

    monkeypatch.setattr(af, "edge_pad_fold_reference", lambda *a: pytest.fail("plain version"))
    monkeypatch.setattr(_cuda, "require_cuda", lambda *tensors: None)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda: 0)
    monkeypatch.setattr(_cuda, "kernel", lambda lib, symbol, argtypes: (
        (lib, symbol, argtypes) == ("attn_fused", "hoig_edge_pad_fold",
                                    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        and launch))
    monkeypatch.setattr(_cuda, "_library", lambda lib: _FakeLibrary())
    _cuda.reset_launch_counts()
    for c in (6, 5):
        g = torch.empty(2, 3 + 4, 5 + 4, c, dtype=DTYPES[dtype], device="meta")
        if err:
            with pytest.raises(RuntimeError, match="edge_pad_fold kernel launch failed"):
                af.edge_pad_fold(g, 2)
            assert _cuda.launch_counts() == {}
        else:
            out = af.edge_pad_fold(g, 2)
            assert out.shape == (2, 3, 5, c) and out.dtype == g.dtype
        assert passed[-1][2:8] == (2, 3, 5, c, 2, int(dtype == "bfloat16"))
    assert _cuda.launch_counts() == ({} if err else {"edge_pad_fold": 2})


FOLD_THREADS, FOLD_BLOCKS = 256, 132 * 8 * 4  # attn_fused.cu's kThreads and kFoldBlocks


def _fold_slot_pixel(s, b, h, w):
    """fold_kernel's slot -> (image, row, column): the images' first rows,
    then their last rows, then the rest, row by row."""
    x, bb, yy = s % w, s // w % b, s // w // b
    y = np.where(yy == 0, 0, np.where(yy == 1, h - 1, yy - 1))
    return bb, y, x


@pytest.mark.parametrize("b,h,w,c,vec", [(4, 128, 128, 128, 8), (4, 32, 32, 512, 8),
                                         (4, 64, 64, 256, 4), (3, 1, 1, 130, 1),
                                         (1, 9, 20, 71, 1), (2, 13, 11, 6, 1), (1, 4, 4, 1024, 4),
                                         (64, 64, 64, 8, 8), (3, 2, 7, 16, 8)])
def test_fold_grid_covers_every_output_once(b, h, w, c, vec):
    """fold_kernel's launch: a strip of kThreads / lanes slots a block,
    `lanes` threads a slot moving VEC channels, the grid at most four waves
    of 8 blocks on 132 SMs walking the slots, a slot's pixel from the
    images' first rows, then their last rows, then the rest: every (pixel,
    channel) written by exactly one thread once, the first and last rows
    (the corners' long folds) in the first 2 B W slots; at the main path's
    bf16 widths one pass of 16 to 64 lanes."""
    lanes = 1
    while lanes < FOLD_THREADS and lanes * vec < c:
        lanes *= 2
    per = FOLD_THREADS // lanes
    n_pix = b * h * w
    grid = min(-(-n_pix // per), FOLD_BLOCKS)
    t = np.arange(FOLD_THREADS)
    first = (np.arange(grid)[:, None] * per + t[None, :] // lanes).ravel()
    sub = np.tile(t % lanes, grid)
    hits = np.zeros((b, h, w, c), np.int64)
    for k in range(-(-n_pix // (grid * per))):
        slot = first + k * grid * per
        for cb in range(0, c, lanes * vec):
            ch = cb + sub * vec
            keep = (slot < n_pix) & (ch < c)
            bb, y, x = _fold_slot_pixel(slot[keep], b, h, w)
            for i in range(vec):
                np.add.at(hits, (bb, y, x, ch[keep] + i), 1)
    assert (hits == 1).all()
    _, y, _ = _fold_slot_pixel(np.arange(min(2, h) * b * w), b, h, w)
    assert set(y.tolist()) == {0, h - 1}
    if vec == 8 and c in (128, 256, 512):
        assert lanes * vec == c
