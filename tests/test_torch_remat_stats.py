"""InstanceNorm statistics kept across remat (hoig_torch/models/layers.py
`FoldedStats`, `keep_stats`; the JAX package's `save_only_these_names(
"in_stats")` policy), on the CPU, torch only: the hand-written backward
against autograd of the plain statistics, the recompute taking the
forward's statistics back in order (with and without checkpoint's early
stop), the stash dying with its graph, and regions that do not nest. The
whole training step under each remat switch is held bit-equal to the
remat-off step in tests/test_torch_train.py."""

import pytest
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from hoig_torch.models import layers as L
from hoig_torch.models.generator import _run

torch.set_num_threads(1)


def _plain_norm(x, weight, bias, eps=1e-5):
    """InstanceNorm with its statistics as plain autograd ops."""
    var, mean = torch.var_mean(x.float(), dim=(2, 3), correction=0, keepdim=True)
    a = torch.rsqrt(var + eps)
    b = -mean * a
    if weight is not None:
        a = a * weight[None, :, None, None]
        b = b * weight[None, :, None, None] + bias[None, :, None, None]
    return x * a + b


def _block():
    torch.manual_seed(0)
    block = nn.Sequential(nn.Conv2d(4, 6, 3, padding=1), L.InstanceNorm(6), nn.ReLU(),
                          nn.Conv2d(6, 6, 3, padding=1), L.InstanceNorm(6, affine=False),
                          nn.ReLU())
    with torch.no_grad():
        block[1].weight.uniform_(0.5, 1.5)
        block[1].bias.uniform_(-0.5, 0.5)
    return block


@pytest.mark.parametrize("affine", [True, False])
def test_folded_stats_backward_matches_autograd(affine):
    """Forward bit-equal to the plain ops; the gradients of x, weight and
    bias within 1e-6 of their largest entry (another order of the sums)."""
    torch.manual_seed(1)
    norm = L.InstanceNorm(5, affine=affine)
    if affine:
        with torch.no_grad():
            norm.weight.normal_()
            norm.bias.normal_()
    x = (3 * torch.randn(3, 5, 7, 6) + 1).requires_grad_()
    g = torch.randn(3, 5, 7, 6)
    params = [x] + ([norm.weight, norm.bias] if affine else [])
    y = norm(x)
    ref = _plain_norm(x, norm.weight, norm.bias)
    assert torch.equal(y, ref)
    got = torch.autograd.grad(y, params, g)
    want = torch.autograd.grad(ref, params, g)
    for a, r in zip(got, want):
        assert float((a - r).abs().max()) <= 1e-6 * float(r.abs().max())


@pytest.mark.parametrize("early_stop", [True, False])
def test_recompute_takes_the_kept_statistics(early_stop):
    """A rematerialized block's backward runs no statistics reduction: the
    recompute takes the forward's pairs back (all of them once checkpoint
    runs the recompute to its end; with early stop, those up to the last
    saved tensor), and its gradients are bit-equal to the block run without
    remat. The stash is gone with the graph."""
    block = _block()
    x = torch.randn(2, 4, 8, 8, requires_grad=True)
    g = torch.randn(2, 6, 8, 8)
    params = [x, *block.parameters()]
    want = torch.autograd.grad(block(x), params, g)
    L.reset_stats_counts()
    live = L.live_stashes()
    with set_checkpoint_early_stop(early_stop):
        y = _run(block, True, x)
        assert L.stats_counts() == {"computed": 2} and L.live_stashes() == live + 1
        got = torch.autograd.grad(y, params, g)
    assert L.stats_counts() == {"computed": 2, "kept": 2}
    assert all(torch.equal(a, r) for a, r in zip(got, want))
    del y
    assert L.live_stashes() == live


def test_stash_dies_with_an_undifferentiated_forward():
    """A remat forward that is never differentiated frees its stash with its
    outputs; without grad no region opens."""
    block = _block()
    x = torch.randn(2, 4, 8, 8, requires_grad=True)
    live = L.live_stashes()
    y = _run(block, True, x)
    assert L.live_stashes() == live + 1
    del y
    assert L.live_stashes() == live
    with torch.no_grad():
        _run(block, True, x)
    assert L.live_stashes() == live


def test_regions_do_not_nest():
    block = _block()
    inner = lambda x: checkpoint(L.keep_stats(block), x, use_reentrant=False)
    with pytest.raises(RuntimeError, match="do not nest"):
        checkpoint(L.keep_stats(inner), torch.randn(1, 4, 8, 8, requires_grad=True),
                   use_reentrant=False)
