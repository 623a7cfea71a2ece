"""The tiled z-buffer's per-tile face lists (hoig_torch/csrc/rasterizer.cu:
bin_kernel and raster_kernel, dispatched by ops/rasterizer_cuda.py) on the
CPU: a torch model of the binning (each face listed at every 8x8 tile its
box meets, the tile's pixel centres padded by one pixel pitch, unless an
edge function lies below its rounding margin at the tile's four corner
pixel centres; in the f32 operations of the kernels), of the lists'
arbitrary order and their
overflow, and of the order-free winner rule, held bit-equal to the plain
z-buffer (`zbuffer_reference`) on a random scene and on scenes built with
exact ties. Torch only: the plain z-buffer is held against the JAX package
in tests/test_torch_ops.py."""

import numpy as np
import pytest
import torch

from hoig_torch.ops import rasterizer_cuda as rc
from hoig_torch.ops.rasterizer import _face_setup, _pixel_grids, zbuffer_reference

# parallel test workers each run torch's CPU kernels; one intra-op thread per
# worker keeps them from contending for the same cores
torch.set_num_threads(1)

TILE = rc.TILE
NEAR, FAR = 0.1, 100.0


def _ndc(i: torch.Tensor, s: int) -> torch.Tensor:
    """Pixel index -> NDC centre, f32, rounded as the kernels' ndc()."""
    return (2.0 * i.float() + 1.0 - s) / s


def tile_spans(s: int) -> tuple[torch.Tensor, torch.Tensor]:
    """tile_lo, tile_hi of every tile along one axis, as the kernels compute
    them: the outer pixel centres, less and plus one pixel pitch, in f32."""
    t = torch.arange(-(-s // TILE))
    pitch = torch.tensor(2.0, dtype=torch.float32) / s
    return _ndc(t * TILE, s) - pitch, _ndc(t * TILE + TILE - 1, s) + pitch


def meets(bbox: torch.Tensor, s: int) -> torch.Tensor:
    """(B, F, T, T) [ty, tx]: the face's box meets the tile (bin_kernel's
    test, and raster_kernel's when a list overflowed)."""
    lo, hi = tile_spans(s)
    mx = (bbox[..., 0, None] <= hi) & (bbox[..., 1, None] >= lo)
    my = (bbox[..., 2, None] <= hi) & (bbox[..., 3, None] >= lo)
    return my[..., :, None] & mx[..., None, :]


def edge_misses(edge: torch.Tensor, s: int) -> torch.Tensor:
    """(B, F, T, T) [ty, tx]: one of the face's edge functions, evaluated at
    the tile's four corner pixel centres as the kernels evaluate it, lies
    below -16 units in the last place of |a| X + |b| Y + |c| at all four
    (X, Y the corners' largest |x|, |y|): bin_kernel leaves the face off
    the tile's list."""
    t = torch.arange(-(-s // TILE))
    c0, c1 = _ndc(t * TILE, s), _ndc(t * TILE + TILE - 1, s)
    big = torch.maximum(c0.abs(), c1.abs())
    ax, ay = big[None, None, None, :], big[None, None, :, None]
    misses = torch.zeros(edge.shape[:2] + (len(t), len(t)), dtype=torch.bool)
    for k in range(3):
        a, b, c = (edge[..., k, j, None, None].float() for j in range(3))
        top = torch.full(misses.shape, float("-inf"))
        for cx in (c0, c1):
            for cy in (c0, c1):
                top = torch.maximum(top, (cx[None, None, None, :] * a + cy[None, None, :, None] * b) + c)
        margin = (16.0 * 5.9604645e-8) * ((a.abs() * ax + b.abs() * ay) + c.abs())
        misses |= top < -margin
    return misses


def model_lists(bbox: torch.Tensor, edge: torch.Tensor, s: int, cap: int,
                rng: np.random.RandomState):
    """The per-tile lists as bin_kernel leaves them: each tile's faces in an
    order of the atomics (here a random one), with their count; a tile whose
    count passed `cap` walks every face whose box meets it (in ascending
    order, as raster_kernel does). Returns (B, T*T, L) face ids padded with
    -1, the number of overflowed tiles, and the number of (face, tile) pairs
    that the edge test left off the lists."""
    b, f = bbox.shape[:2]
    boxed = meets(bbox, s)
    listed = (boxed & ~edge_misses(edge, s)).reshape(b, f, -1)  # (B, F, T*T)
    boxed = boxed.reshape(b, f, -1)
    lists = [[None] * listed.shape[2] for _ in range(b)]
    overflowed = 0
    for bi in range(b):
        for t in range(listed.shape[2]):
            ids = listed[bi, :, t].nonzero().flatten().numpy()
            if len(ids) > cap:
                overflowed += 1
                ids = boxed[bi, :, t].nonzero().flatten().numpy()
            else:
                ids = rng.permutation(ids)
            lists[bi][t] = ids
    width = max(1, max(len(ids) for row in lists for ids in row))
    out = torch.full((b, listed.shape[2], width), -1, dtype=torch.long)
    for bi, row in enumerate(lists):
        for t, ids in enumerate(row):
            out[bi, t, :len(ids)] = torch.from_numpy(ids.astype(np.int64))
    return out, overflowed, int((boxed & ~listed).sum())


def model_raster(setup: dict, bbox: torch.Tensor, s: int, cap: int, seed: int):
    """raster_kernel over the model's lists: each pixel walks its tile's
    list in the list's order and keeps a candidate if its inverse depth is
    larger, or equal with a lower face index; planes evaluated as
    ((a x) + (b y)) + c in f32. Returns ((B, S*S) int32 winners, overflowed
    tiles, pairs the edge test left off the lists)."""
    edge, izp = setup["edge"].float(), setup["izp"].float()
    b, f = bbox.shape[:2]
    lists, overflowed, rejected = model_lists(bbox, edge, s, cap, np.random.RandomState(seed))
    xi, yi, xp, yp = _pixel_grids(s, "cpu")
    tiles = -(-s // TILE)
    tile = (yi.long() // TILE) * tiles + xi.long() // TILE  # (S*S,)
    iz_lo = torch.tensor(1.0 / FAR, dtype=torch.float32)
    iz_hi = torch.tensor(1.0 / NEAR, dtype=torch.float32)
    best_iz = torch.full((b, s * s), -1e10, dtype=torch.float32)
    best = torch.full((b, s * s), -1, dtype=torch.long)
    bidx = torch.arange(b)[:, None]
    for j in range(lists.shape[2]):
        fid = lists[:, tile, j]  # (B, S*S)
        listed = fid >= 0
        safe = fid.clamp_min(0)
        e = edge[bidx, safe]  # (B, S*S, 3, 3)
        z = izp[bidx, safe]  # (B, S*S, 3)
        inside = ((xp[None, :, None] * e[..., 0] + yp[None, :, None] * e[..., 1]) + e[..., 2] >= 0
                  ).all(-1)
        iz = (xi * z[..., 0] + yi * z[..., 1]) + z[..., 2]
        win = (listed & inside & (iz > iz_lo) & (iz < iz_hi)
               & ((iz > best_iz) | ((iz == best_iz) & (fid < best))))
        best_iz = torch.where(win, iz, best_iz)
        best = torch.where(win, fid, best)
    return best.to(torch.int32), overflowed, rejected


def random_scene(rng, b: int, f: int):
    fv = rng.randn(b, f, 3, 3).astype(np.float32) * 0.4
    fv[..., 2] = np.abs(fv[..., 2]) + 1.5
    valid = rng.rand(b, f) > 0.1
    return torch.from_numpy(fv), torch.from_numpy(valid)


def tie_scene(rng, b: int, f: int, copies: int):
    """Faces with exact ties: `copies` copies of one large front-facing
    triangle at random indices, the rest either small random triangles or
    triangles of one fronto-parallel plane (z = 2) that overlap each other
    and the large one; some of them repeated too. Every face is valid."""
    fv, _ = random_scene(rng, b, f)
    big = torch.tensor([[-0.9, -0.8, 2.0], [0.85, -0.7, 2.0], [0.1, 0.95, 2.0]])
    for bi in range(b):
        idx = rng.permutation(f)
        fv[bi, idx[:copies]] = big
        flat = idx[copies:copies + (f - copies) // 2]
        xy = torch.from_numpy(rng.uniform(-0.8, 0.8, (len(flat), 1, 2)).astype(np.float32))
        tri = xy + torch.tensor([[0.0, 0.0], [0.5, 0.05], [0.1, 0.45]])
        fv[bi, flat, :, :2] = tri
        fv[bi, flat, :, 2] = 2.0
        # a few exact repeats of the flat triangles at other indices
        rep = idx[copies + (f - copies) // 2:][:len(flat) // 4]
        fv[bi, rep] = fv[bi, flat[:len(rep)]]
    return fv, torch.ones(b, f, dtype=torch.bool)


def _check(fv, valid, s: int, cap: int, seed: int):
    setup = _face_setup(fv, valid, s)
    bbox = rc.face_bbox(fv, setup["keep"])
    ref = zbuffer_reference(setup, s, NEAR, FAR)
    got, overflowed, rejected = model_raster(setup, bbox, s, cap, seed)
    assert torch.equal(got, ref), f"{int((got != ref).sum())} pixels differ"
    return ref, overflowed, rejected


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cap", [rc.LIST_CAP, 12])
def test_tile_lists_random_scene(seed, cap):
    """A random 100 px scene (2 x 300 faces, a tenth invalid; 13 x 13 tiles,
    the last row and column partial): the lists in a random order give the
    plain z-buffer's winners bit for bit, with lists that never overflow
    and with a capacity so small that most covered tiles walk every face."""
    fv, valid = random_scene(np.random.RandomState(seed), 2, 300)
    ref, overflowed, rejected = _check(fv, valid, 100, cap, seed)
    assert (ref >= 0).sum() > 1000 and rejected > 1000
    assert (overflowed == 0) if cap == rc.LIST_CAP else (overflowed > 50)


@pytest.mark.parametrize("cap", [rc.LIST_CAP, 24])
@pytest.mark.parametrize("copies", [3, 40])
def test_tile_lists_exact_ties(copies, cap):
    """Duplicated faces and faces of one shared plane: their inverse depths
    tie exactly at many pixels, and the lowest index must win whatever the
    list order, with lists that hold every face and with a capacity cut so
    that the covered tiles overflow (all of those under 40 copies)."""
    fv, valid = tie_scene(np.random.RandomState(copies), 2, 120, copies)
    setup = _face_setup(fv, valid, 64)
    bbox = rc.face_bbox(fv, setup["keep"])
    iz_ties = 0
    ref = zbuffer_reference(setup, 64, NEAR, FAR)
    # the scene does tie: pixels whose winner has an exact copy of lower
    # depth order at a higher index
    for bi in range(2):
        won = ref[bi][ref[bi] >= 0].long()
        twin = (fv[bi, won][:, None] == fv[bi]).flatten(2).all(-1).sum(-1) > 1
        iz_ties += int(twin.sum())
    assert iz_ties > 100
    for seed in range(3):
        got, overflowed, _ = model_raster(setup, bbox, 64, cap, seed)
        assert torch.equal(got, ref), f"{int((got != ref).sum())} pixels differ (seed {seed})"
        assert (overflowed > 0) == (cap < rc.LIST_CAP)


def test_first_come_winner_rule_depends_on_order():
    """The control: with the rule of the old kernel (strict '>' only, which
    is right for ascending order alone) the shuffled lists of the tie scene
    do pick other faces, so the tie test above can tell the two rules
    apart."""
    fv, valid = tie_scene(np.random.RandomState(3), 2, 120, 3)
    setup = _face_setup(fv, valid, 64)
    bbox = rc.face_bbox(fv, setup["keep"])
    ref = zbuffer_reference(setup, 64, NEAR, FAR)
    edge, izp = setup["edge"].float(), setup["izp"].float()
    lists, _, _ = model_lists(bbox, edge, 64, rc.LIST_CAP, np.random.RandomState(0))
    xi, yi, xp, yp = _pixel_grids(64, "cpu")
    tile = (yi.long() // TILE) * (64 // TILE) + xi.long() // TILE
    best_iz = torch.full((2, 64 * 64), -1e10)
    best = torch.full((2, 64 * 64), -1, dtype=torch.long)
    bidx = torch.arange(2)[:, None]
    for j in range(lists.shape[2]):
        fid = lists[:, tile, j]
        e, z = edge[bidx, fid.clamp_min(0)], izp[bidx, fid.clamp_min(0)]
        inside = ((xp[None, :, None] * e[..., 0] + yp[None, :, None] * e[..., 1]) + e[..., 2] >= 0
                  ).all(-1)
        iz = (xi * z[..., 0] + yi * z[..., 1]) + z[..., 2]
        win = (fid >= 0) & inside & (iz > 1.0 / FAR) & (iz < 1.0 / NEAR) & (iz > best_iz)
        best_iz = torch.where(win, iz, best_iz)
        best = torch.where(win, fid, best)
    assert int((best.to(torch.int32) != ref).sum()) > 0
