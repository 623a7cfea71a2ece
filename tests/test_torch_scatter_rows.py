"""The fixed-order transpose of a row gather (hoig_torch/ops/table_gather.py
`scatter_rows`) and the gather that uses it (`gather_rows_nhwc`, the
`GatherRows` Function), on the CPU.

scatter_rows adds each destination row's entries in ascending entry order,
in f32 from 0, rounded once; on the card scatter_rows_kernel does the same,
where torch.gather's own backward adds with float atomics. Here the plain
version is held to a float64 sum within f32 rounding, its order is pinned,
GatherRows' forward is torch.gather's bit for bit and its backward is held
to jax.vjp of jnp.take_along_axis; the gather engine, which now fetches its
36 corners in one GatherRows per attention layer, is held to the JAX
package's engine (values and gradients) and to the per-corner gathers it
replaced (bit for bit). The card builds the order itself (count, tiled
scan, placement in whatever order its atomics give, a sort of each
segment); a numpy model of those steps is held to `scatter_order`, and
the kernels' launch shapes to covering every output once. The wrapper's
CUDA branch is exercised with meta tensors standing in for the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoig_torch.ops import _cuda
from hoig_torch.ops import table_gather as tg
from hoig_torch.ops.table_gather import gather_rows_nhwc, scatter_rows, scatter_rows_reference

torch.set_num_threads(1)
T = torch.as_tensor


def _f64_sum(val, idx, n):
    """The exact-ish sum: float64 index_add_ of the entries inside [0, n)."""
    b, e, c = val.shape
    out = torch.zeros((b, n, c), dtype=torch.float64)
    for bb in range(b):
        keep = (idx[bb] >= 0) & (idx[bb] < n)
        out[bb].index_add_(0, idx[bb][keep].long(), val[bb][keep].double())
    return out


@pytest.mark.parametrize("b,e,c,n", [(2, 60, 1, 9), (1, 200, 3, 17), (3, 40, 128, 7),
                                     (1, 5, 4, 30)])
def test_reference_is_the_float64_sum_within_f32_rounding(b, e, c, n):
    """Each row within (entries - 1) f32 ulps of its sum of magnitudes (one
    rounding per add) of the float64 sum; rows with no entry exactly 0."""
    rng = np.random.RandomState(b * 100 + c)
    val = T(rng.randn(b, e, c).astype(np.float32))
    idx = T(rng.randint(-2, n + 2, (b, e)))
    got = scatter_rows(val, idx, n)
    assert got.dtype == torch.float32 and got.shape == (b, n, c)
    assert torch.equal(got, scatter_rows_reference(val, idx, n))
    ref = _f64_sum(val, idx, n)
    mags = _f64_sum(val.abs(), idx, n)
    counts = _f64_sum(torch.ones(b, e, 1), idx, n)
    tol = counts * 2.0 ** -24 * mags
    assert bool(((got.double() - ref).abs() <= tol).all())
    assert not got[counts.expand_as(got) == 0].any()


def test_order_is_pinned():
    """One row receives [1e8, 1, -1e8] in that order: f32 gives exactly 0
    left to right (1e8 + 1 rounds to 1e8), where [1e8, -1e8, 1] gives 1."""
    val = T(np.array([[[1e8], [1.0], [-1e8]]], np.float32))
    idx = torch.zeros((1, 3), dtype=torch.long)
    assert scatter_rows(val, idx, 1).item() == 0.0
    assert scatter_rows(val[:, [0, 2, 1]], idx, 1).item() == 1.0
    # the entries of other rows interleaved do not change a row's order
    idx2 = T(np.array([[0, 1, 0, 1, 0]]))
    val2 = T(np.array([[[1e8], [5.0], [1.0], [7.0], [-1e8]]], np.float32))
    assert scatter_rows(val2, idx2, 2).flatten().tolist() == [0.0, 12.0]


def test_bf16_is_summed_in_f32_and_rounded_once():
    rng = np.random.RandomState(3)
    val = T(rng.randn(2, 300, 6).astype(np.float32)).bfloat16()
    idx = T(rng.randint(0, 4, (2, 300)))
    got = scatter_rows(val, idx, 4)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, scatter_rows(val.float(), idx, 4).bfloat16())


def test_gather_rows_forward_is_torch_gather():
    rng = np.random.RandomState(4)
    src = T(rng.randn(3, 50, 7).astype(np.float32))
    idx = T(rng.randint(0, 50, (3, 80)))
    want = torch.gather(src, 1, idx[..., None].expand(-1, -1, 7))
    assert torch.equal(gather_rows_nhwc(src, idx), want)
    assert torch.equal(gather_rows_nhwc(src.bfloat16(), idx), want.bfloat16())


def _jax_gather_vjp(src, idx, g):
    _, vjp = jax.vjp(lambda s: jnp.take_along_axis(s, jnp.asarray(idx)[..., None], axis=1),
                     jnp.asarray(src))
    return np.asarray(vjp(jnp.asarray(g))[0])


# (batch, rows, channels, entries, how the indices are made)
GATHER_CASES = {
    "duplicates": (2, 6, 3, 90, "duplicates"),
    "clamped_border": (1, 40, 128, 160, "clamped"),
    "empty_rows": (2, 50, 1, 12, "sparse"),
    "wide": (1, 33, 128, 400, "duplicates"),
}


@pytest.mark.parametrize("case", GATHER_CASES)
def test_gather_rows_backward_matches_jax(case):
    """GatherRows' source gradient against jax.vjp of jnp.take_along_axis on
    the same seed: within 2^-22 of the largest per-row sum of |g| (f32 sums
    in two orders)."""
    b, n, c, p, kind = GATHER_CASES[case]
    rng = np.random.RandomState(len(case))
    if kind == "duplicates":
        idx = rng.randint(0, n, (b, p))
    elif kind == "clamped":  # a 2-D grid's border clamp: most entries on the edge rows
        idx = np.clip(rng.randint(-20, n + 20, (b, p)), 0, n - 1)
    else:
        idx = rng.choice(n // 5, (b, p))
    src = rng.randn(b, n, c).astype(np.float32)
    g = rng.randn(b, p, c).astype(np.float32)
    s_ = T(src).requires_grad_()
    out = gather_rows_nhwc(s_, T(idx))
    out.backward(T(g))
    ref = _jax_gather_vjp(src, idx, g)
    bound = 2.0 ** -22 * float(_f64_sum(T(np.abs(g)), T(idx), n).max())
    np.testing.assert_allclose(s_.grad.numpy(), ref, rtol=0, atol=bound)
    if kind == "sparse":
        assert not s_.grad[:, n // 5:].any()


def _corner_gathers(source, flow, k=5):
    """The gather engine's 36 border-clamped corners, each fetched by its
    own torch.gather (the parent's formulation)."""
    b, h, w, c = source.shape
    r = k // 2
    fx = flow[..., 0] + torch.arange(w, dtype=torch.float32)[None, :]
    fy = flow[..., 1] + torch.arange(h, dtype=torch.float32)[:, None]
    x0, y0 = fx.floor().long(), fy.floor().long()
    flat = source.reshape(b, h * w, c)
    out = []
    for ry in range(-r, r + 2):
        for rx in range(-r, r + 2):
            idx = (y0 + ry).clamp(0, h - 1) * w + (x0 + rx).clamp(0, w - 1)
            out.append(torch.gather(flat, 1, idx.reshape(b, h * w, 1).expand(-1, -1, c)))
    return out


def _engine_with_records(monkeypatch):
    """ExtractorAttn's module with GatherRows' calls (outputs) and
    scatter_rows' calls counted."""
    import hoig_torch.models.generator as gen

    seen = {"gathers": [], "scatters": 0}

    def gather(src, idx):
        out = tg.gather_rows_nhwc(src, idx)
        seen["gathers"].append(out.detach())
        return out

    def scatter(val, idx, n):
        seen["scatters"] += 1
        return scatter_rows_reference(val, idx, n)

    monkeypatch.setattr(gen, "gather_rows_nhwc", gather)
    monkeypatch.setattr(tg, "scatter_rows", scatter)
    return seen


def test_gather_engine_fetches_once_per_layer(monkeypatch):
    """One GatherRows per attention layer, whose 36 corner blocks are the
    per-corner torch.gathers bit for bit (so the forward is unchanged), and
    one scatter_rows in its backward."""
    from hoig_torch.models.generator import ExtractorAttn

    seen = _engine_with_records(monkeypatch)
    rng = np.random.RandomState(8)
    b, h, w, c = 2, 9, 7, 6
    src = T(rng.randn(b, h, w, c).astype(np.float32)).requires_grad_()
    tgt = T(rng.randn(b, h, w, c).astype(np.float32))
    flow = T((rng.rand(b, h, w, 2) * 5.0 - 3.0).astype(np.float32))
    torch.manual_seed(0)
    out = ExtractorAttn(c, 5, "gather")(src, tgt, flow)
    assert len(seen["gathers"]) == 1
    blocks = seen["gathers"][0].reshape(36, b, h * w, c)
    for j, want in enumerate(_corner_gathers(src.detach(), flow)):
        assert torch.equal(blocks[j], want), j
    out.sum().backward()
    assert seen["scatters"] == 1


def test_gather_engine_matches_jax_with_clamped_corners():
    """The gather engine against the JAX package's, with a flow that reaches
    up to 6 pixels past the border (most corners clamped onto edge rows, so
    many entries share a row), at an odd channel count: output within 1e-5
    and the source, target and weight gradients within 1e-4 of each one's
    largest entry (the bounds of tests/test_torch_train.py's
    test_extractor_attn_gradients_match_jax)."""
    from hoig_torch.models import convert
    from hoig_torch.models.generator import ExtractorAttn
    from hoig_tpu.models.generator import ExtractorAttn as JaxExtractorAttn

    rng = np.random.RandomState(9)
    b, h, w, c = 1, 8, 7, 5
    src, tgt, cot = (rng.randn(b, h, w, c).astype(np.float32) for _ in range(3))
    flow = (rng.rand(b, h, w, 2) * 12.0 - 6.0).astype(np.float32)
    m = JaxExtractorAttn(kernel_size=5, corner_engine="gather")
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(tgt),
                            jnp.asarray(flow))
    p = jax.tree_util.tree_map(lambda s: (rng.randn(*s.shape) * 0.1).astype(np.float32), shapes)
    def value_and_vjp(p_, s_, t_):
        y, vjp = jax.vjp(lambda *a: m.apply(*a, jnp.asarray(flow)), p_, s_, t_)
        return y, vjp(jnp.asarray(cot))

    with jax.default_matmul_precision("highest"):
        y, (gp, gs, gt) = jax.jit(value_and_vjp)(p, jnp.asarray(src), jnp.asarray(tgt))
    tm = ExtractorAttn(c, 5, "gather")
    fc = tm.fully_connect_layer
    with torch.no_grad():
        fc[0].weight.copy_(T(convert._to_torch("conv", p["params"]["fc_0_kernel"])))
        fc[0].bias.copy_(T(np.asarray(p["params"]["fc_0_bias"])))
        fc[2].weight.copy_(T(convert._to_torch("conv", p["params"]["fc_1_kernel"])))
        fc[2].bias.copy_(T(np.asarray(p["params"]["fc_1_bias"])))
    s_, t_ = T(src).requires_grad_(), T(tgt).requires_grad_()
    out = tm(s_, t_, T(flow))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), rtol=0, atol=1e-5)
    (out * T(cot)).sum().backward()
    pairs = {
        "source": (s_.grad.numpy(), gs), "target": (t_.grad.numpy(), gt),
        "fc_0_kernel": (convert._from_torch("conv", fc[0].weight.grad.numpy()),
                        gp["params"]["fc_0_kernel"]),
        "fc_1_kernel": (convert._from_torch("conv", fc[2].weight.grad.numpy()),
                        gp["params"]["fc_1_kernel"]),
    }
    for name, (got, ref) in pairs.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * float(np.abs(ref).max()),
                                   err_msg=name)


def _stand_in_card(monkeypatch) -> list:
    """The card stood in for: the device check passes and the entry point
    returns success (meta tensors stand in for CUDA ones). Returns the list
    of (symbol, arguments) launched."""
    asked = []

    def entry_point(symbol, argtypes):
        def launch(*args):
            assert len(args) == len(argtypes)
            asked.append((symbol, args))
            return 0
        return launch

    monkeypatch.setattr(_cuda, "require_cuda", lambda *tensors: None)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda: 0)
    monkeypatch.setattr(_cuda, "kernel", lambda lib, symbol, argtypes: (
        entry_point(symbol, argtypes) if lib == "table_gather" else None))
    monkeypatch.setattr(tg, "scatter_rows_reference", lambda *a: pytest.fail(
        "the plain version ran for a tensor off the CPU"))
    _cuda.reset_launch_counts()
    return asked


@pytest.mark.parametrize("dtype,is_bf16", [(torch.float32, 0), (torch.bfloat16, 1)])
def test_off_the_cpu_the_kernel_launches(dtype, is_bf16, monkeypatch):
    """A tensor off the CPU goes to hoig_scatter_rows (B, E, n, the channel
    count, the dtype flag, both stages; int32 scratch of
    scatter_scratch_ints(B * n, B * E), pointers as c_void_p and its length
    as c_longlong), counted once, with no sort or search of the keys on the
    host's side; GatherRows' backward launches it; float64 is refused,
    never summed elsewhere, and so are more entries than int32 ids hold."""
    import ctypes

    asked = _stand_in_card(monkeypatch)
    for name in ("sort", "searchsorted", "argsort"):
        monkeypatch.setattr(torch, name, lambda *a, **k: pytest.fail("the order was made by torch"))
    val = torch.empty(2, 10, 3, device="meta", dtype=dtype)
    idx = torch.empty(2, 10, dtype=torch.long, device="meta")
    out = scatter_rows(val, idx, 5)
    assert out.shape == (2, 5, 3) and out.dtype == dtype
    assert [(s, a[4:11]) for s, a in asked] == [
        ("hoig_scatter_rows", (tg.scatter_scratch_ints(10, 20), 2, 10, 5, 3, is_bf16, 3))]
    assert tg._SCATTER_ARGS[:4] == [ctypes.c_void_p] * 4 and tg._SCATTER_ARGS[-1] == ctypes.c_void_p
    assert tg._SCATTER_ARGS[4] == ctypes.c_longlong and tg._SCATTER_ARGS[5:11] == [ctypes.c_int] * 6
    assert _cuda.launch_counts() == {"scatter_rows": 1}
    src = torch.empty(2, 5, 3, device="meta", dtype=dtype).requires_grad_()
    gather_rows_nhwc(src, idx).backward(torch.empty(2, 10, 3, device="meta", dtype=dtype))
    assert _cuda.launch_counts() == {"scatter_rows": 2}
    with pytest.raises(TypeError):
        scatter_rows(val.double(), idx, 5)
    big = 2**30
    with pytest.raises(ValueError, match="int32"):
        scatter_rows(torch.empty(2, big, 1, device="meta", dtype=dtype),
                     torch.empty(2, big, dtype=torch.long, device="meta"), 5)
    assert _cuda.launch_counts() == {"scatter_rows": 2}


# table_gather.cu's constants that the models below repeat
SORT_CAP, WARP_SORT, SUM_THREADS, STAGE, RANK_MAX = 8192, 256, 256, 2048, 512


def _network_step(a, n, m, lg, flip):
    """segment_sort_kernel's network_step: every comparator puts the smaller
    id first; ids past n count as +infinity and are never touched."""
    q = np.arange(m // 2)
    half = 1 << lg
    blk = (q >> lg) << (lg + 1)
    off = q & (half - 1)
    lo = blk + off
    hi = blk + 2 * half - 1 - off if flip else lo + half
    keep = hi < n
    lo, hi = lo[keep], hi[keep]
    x, y = a[lo], a[hi]
    a[lo], a[hi] = np.minimum(x, y), np.maximum(x, y)


def _log2_ceil(n):
    return max(n - 1, 0).bit_length()


def _bitonic(a):
    m = 1 << _log2_ceil(len(a))
    for lk in range(1, _log2_ceil(len(a)) + 1):
        _network_step(a, len(a), m, lk - 1, True)
        for lj in range(lk - 2, -1, -1):
            _network_step(a, len(a), m, lj, False)


def _network_sort(seg, cap):
    """segment_sort_kernel on one listed segment, with `cap` ids in shared
    memory (a power of two): the whole network there, or sort_long's chunks
    of cap and its merges' steps of cap and more over the segment."""
    a = seg.copy()
    n = len(a)
    if n <= cap:
        _bitonic(a)
        return a
    for c0 in range(0, n, cap):
        _bitonic(a[c0:c0 + cap])
    lcap = cap.bit_length() - 1
    for lk in range(lcap + 1, _log2_ceil(n) + 1):
        _network_step(a, n, 1 << _log2_ceil(n), lk - 1, True)
        for lj in range(lk - 2, lcap - 1, -1):
            _network_step(a, n, 1 << _log2_ceil(n), lj, False)
        for c0 in range(0, n, cap):
            chunk = a[c0:c0 + cap]
            for lj in range(lcap - 1, -1, -1):
                _network_step(chunk, len(chunk), cap, lj, False)
    return a


def _order_model(idx, n, rank_max, cap, tile, seed):
    """The card's order (table_gather.cu) in numpy, step by step: counts per
    row; their exclusive scan in tiles of `tile` rows plus the scanned
    tiles' totals; the rows longer than rank_max listed; each entry placed
    into its segment by a decrementing counter, the entries taken in a
    scrambled order (the atomics' order is any); the listed segments sorted
    by the network, the others by rank (the sum kernel's: the number of
    smaller ids). Returns (ids, starts) as scatter_order's (perm of the
    entries inside [0, n), starts)."""
    b, e = idx.shape
    rows = b * n
    keys = (np.arange(b)[:, None] * n + idx).ravel()
    inside = ((idx >= 0) & (idx < n)).ravel()
    counts = np.zeros(rows + 1, np.int64)
    np.add.at(counts, keys[inside], 1)
    tiles = -(-(rows + 1) // tile)
    t = np.zeros(tiles * tile, np.int64)
    t[:rows + 1] = counts
    t = t.reshape(tiles, tile)
    loc = (np.cumsum(t, 1) - t).ravel()[:rows + 1]
    tot = np.cumsum(t.sum(1)) - t.sum(1)
    starts = loc + tot[np.arange(rows + 1) // tile]
    listed = set(np.nonzero(counts > rank_max)[0].tolist())
    left = counts.copy()
    ids = np.full(int(starts[-1]), -1, np.int64)
    for j in np.random.RandomState(seed).permutation(b * e):
        if inside[j]:
            left[keys[j]] -= 1
            ids[starts[keys[j]] + left[keys[j]]] = j
    assert not left.any() and (ids >= 0).all()
    for r in range(rows):
        seg = ids[starts[r]:starts[r + 1]]
        if r in listed:
            ids[starts[r]:starts[r + 1]] = _network_sort(seg, cap)
        else:
            ranked = np.empty_like(seg)
            for v in seg:
                ranked[(seg < v).sum()] = v
            ids[starts[r]:starts[r + 1]] = ranked
    return ids, starts


def _clamped_layer(h, w, reach, rng):
    """A gather-engine layer's 36 border-clamped corners of an h x w frame
    under a flow of up to `reach` pixels: most corners of the border pixels
    clamp onto the edge rows."""
    fy = np.arange(h)[:, None] + (rng.rand(h, w) * 2 - 1) * reach
    fx = np.arange(w)[None, :] + (rng.rand(h, w) * 2 - 1) * reach
    y0, x0 = np.floor(fy).astype(np.int64), np.floor(fx).astype(np.int64)
    return np.stack([np.clip(y0 + dy, 0, h - 1) * w + np.clip(x0 + dx, 0, w - 1)
                     for dy in range(-2, 4) for dx in range(-2, 4)]).reshape(1, -1)


# (indices, rows, rank limit, shared-memory cap, scan tile)
ORDER_CASES = {
    "outside_rows": (lambda r: r.randint(-3, 43, (2, 300)), 40, 8, 16, 8),
    "empty_rows": (lambda r: r.choice(10, (3, 200)), 50, 8, 16, 16),
    "one_row": (lambda r: np.full((1, 1000), 3), 7, 128, 64, tg.SCAN_TILE),
    "clamped_layer": (lambda r: _clamped_layer(12, 12, 8.0, r), 144, 32, 32, 64),
    "main_path_constants": (lambda r: _clamped_layer(20, 20, 8.0, r), 400, RANK_MAX, WARP_SORT,
                            tg.SCAN_TILE),
}


@pytest.mark.parametrize("case", ORDER_CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_order_built_on_the_card_is_scatter_order(case, seed):
    """The card's order (modelled in numpy, with a scrambled placement) is
    scatter_order's: the same ids in the same segments; indices outside
    [0, n), empty rows, every entry on one row (the network's chunked path)
    and a clamped gather layer (long border segments) included. Summed in
    that order, in f32 from 0, it gives scatter_rows_reference's bits."""
    make, n, rank_max, cap, tile = ORDER_CASES[case]
    rng = np.random.RandomState(seed + 10 * len(case))
    idx = make(rng)
    ids, starts = _order_model(idx, n, rank_max, cap, tile, seed)
    perm, want = tg.scatter_order(T(idx), n)
    assert starts.tolist() == want.tolist()
    assert ids.tolist() == perm[:int(want[-1])].tolist()
    b, e = idx.shape
    val = rng.randn(b * e, 3).astype(np.float32)
    acc = np.zeros((b * n, 3), np.float32)
    for r in range(b * n):
        for j in ids[starts[r]:starts[r + 1]]:
            acc[r] = acc[r] + val[j]
    ref = scatter_rows_reference(T(val.reshape(b, e, 3)), T(idx), n)
    assert np.array_equal(acc.reshape(b, n, 3), ref.numpy())


def _sum_plan(c, vec):
    """table_gather.cu's sum_plan: lanes a row and the longest segment the
    sum kernel ranks itself (at most one chunk of its staging)."""
    lanes = 1
    while lanes < SUM_THREADS and lanes * vec < c:
        lanes *= 2
    chunk = STAGE // (SUM_THREADS // lanes)
    return lanes, min(chunk, RANK_MAX), chunk


@pytest.mark.parametrize("c,vec", [(128, 4), (256, 4), (512, 4), (512, 8), (1, 1), (3, 1),
                                   (9, 1), (130, 1), (1030, 1), (4096, 8)])
def test_sum_kernel_covers_every_output_once(c, vec):
    """scatter_rows_kernel's shape: `lanes` threads a row, VEC channels a
    thread, kSumThreads / lanes rows a block, the channel passes of
    lanes * VEC: every (row, channel) written by exactly one thread once,
    and the segments it ranks itself fit one chunk of its staging. The main
    path's widths (128 to 512 f32) take one pass of 32 to 128 lanes."""
    lanes, rank_max, chunk = _sum_plan(c, vec)
    rows = 37
    groups = SUM_THREADS // lanes
    hits = np.zeros((rows, c), np.int64)
    for blk in range(-(-rows // groups)):
        for t in range(SUM_THREADS):
            row, sub = blk * groups + t // lanes, t % lanes
            for cb in range(0, c, lanes * vec):
                c0 = cb + sub * vec
                if row < rows and c0 < c:
                    hits[row, c0:c0 + vec] += 1
    assert (hits == 1).all()
    assert 1 <= rank_max <= chunk and chunk * groups == STAGE
    if vec == 4 and c in (128, 256, 512):
        assert lanes * vec == c and lanes == c // 4


def test_depth_backward_on_duplicate_faces_matches_index_add():
    """backward_depth_map's per-face sums (now scatter_rows) against the
    index_add_ it replaced, on a scene whose faces appear twice and whose
    pixels pick either copy: within f32 rounding of the largest entry."""
    from hoig_torch.ops import rasterizer as tras
    from hoig_torch.ops import rasterizer_grad as tgrad
    from test_torch_renderer_api import blob_scene

    s = 20
    _, _, _, fv = blob_scene()
    fv2 = torch.cat([fv, fv], dim=1)
    f = fv.shape[1]
    fim, _ = tras.rasterize_fim_wim(fv, image_size=s)
    rng = np.random.RandomState(14)
    fim = torch.where(fim >= 0, fim + f * T(rng.randint(0, 2, fim.shape)), fim).flip(1)
    depth = T(rng.rand(*fim.shape).astype(np.float32) + 1.0)
    g = T(rng.randn(*fim.shape).astype(np.float32))
    assert int((fim >= 0).sum()) > 3 * f  # many pixels per face

    def index_add(val, idx, n):
        b = val.shape[0]
        seg = torch.where(idx >= 0, idx, n) + torch.arange(b)[:, None] * (n + 1)
        out = torch.zeros((b * (n + 1), val.shape[2]))
        out.index_add_(0, seg.reshape(-1), val.reshape(-1, val.shape[2]))
        return out.reshape(b, n + 1, -1)[:, :n]

    got = tgrad.backward_depth_map(fv2, None, fim, depth, g, s)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgrad, "scatter_rows", index_add)
        ref = tgrad.backward_depth_map(fv2, None, fim, depth, g, s)
    top = float(ref.abs().max())
    assert top > 0 and got.shape == ref.shape == (fv.shape[0], 2 * f, 3, 3)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=2.0 ** -22 * top)
