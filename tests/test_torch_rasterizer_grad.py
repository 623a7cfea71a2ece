"""hoig_torch/ops/rasterizer_grad.py against hoig_tpu's on the CPU: the
edge-walk backward_pixel_map (alpha, RGB, both), backward_depth_map, and the
gradients of the three exact-gradient Functions against jax.vjp of the
custom VJPs. A 30-vertex blob seen twice, 16-24 px, textures of size 2.
The custom VJPs run under one jax.jit (one compile instead of one per eager
op); backward_pixel_map and backward_depth_map run as they are called.

The walk adds the same terms in another order (JAX sums both walks and the
transverse line in one reduction, the port walk by walk), so vertex
gradients agree to 7.4e-6 of their largest entry; the bound is 1e-5 of it.
Through render_rgb_exact the walk's colour differences come from RGB maps
that already differ by up to 1.3e-5 (the barycentric weights, XLA:CPU's
FMAs), and each is divided by a distance that can be near eps, so one
vertex entry in a thousand differs by up to 8.4e-5 of itself: that
gradient gets rtol 1e-3 beside the bound. The texture gradient is a
gather's scatter-add on both sides, weighted by trilinear weights built from
those barycentric weights: within 2e-6 of its largest entry, bound 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoig_tpu.ops import rasterizer as jras
from hoig_tpu.ops import rasterizer_grad as jgrad
from hoig_torch.ops import rasterizer as tras
from hoig_torch.ops import rasterizer_grad as tgrad

from test_torch_renderer_api import B, T, blob_scene

torch.set_num_threads(1)


def _grad_close(out, ref, rel=1e-5, rtol=0.0):
    ref = np.asarray(ref)
    top = float(np.abs(ref).max())
    assert top > 0, "a zero gradient tests nothing"
    out = out.detach().numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=rel * top, rtol=rtol)


@pytest.mark.parametrize("maps", ["alpha", "rgb", "both"])
def test_backward_pixel_map_matches_jax(maps):
    """On the JAX rasterizer's own (unflipped) fim and silhouette, with a
    face mask, at 24 px."""
    s = 24
    _, f, fv_j, fv_t = blob_scene()
    rng = np.random.RandomState(12)
    valid = rng.rand(B, f.shape[0]) > 0.2
    fim, _ = jras.rasterize_fim_wim(fv_j, jnp.asarray(valid), image_size=s)
    fim_u = np.asarray(fim)[:, ::-1].copy()
    alpha = (fim_u >= 0).astype(np.float32)
    rgb = rng.rand(B, s, s, 3).astype(np.float32) * alpha[..., None]
    g_a = rng.randn(B, s, s).astype(np.float32)
    g_rgb = rng.randn(B, s, s, 3).astype(np.float32)
    use_a, use_rgb = maps in ("alpha", "both"), maps in ("rgb", "both")
    args = [alpha if use_a else None, g_a if use_a else None, rgb if use_rgb else None,
            g_rgb if use_rgb else None]
    ref = jgrad.backward_pixel_map(fv_j, jnp.asarray(valid), jnp.asarray(fim_u),
                                   *[None if a is None else jnp.asarray(a) for a in args], s)
    out = tgrad.backward_pixel_map(fv_t, T(valid), T(fim_u),
                                   *[None if a is None else T(a) for a in args], s)
    assert float(out[..., 2].abs().max()) == 0.0
    _grad_close(out, ref)


def test_backward_depth_map_matches_jax():
    s = 24
    _, _, fv_j, fv_t = blob_scene()
    fim, _ = jras.rasterize_fim_wim(fv_j, image_size=s)
    depth = jras.rasterize_depth(fv_j, image_size=s)
    fim_u, d_u = (np.asarray(a)[:, ::-1].copy() for a in (fim, depth))
    g = np.random.RandomState(13).randn(B, s, s).astype(np.float32)
    ref = jgrad.backward_depth_map(fv_j, None, jnp.asarray(fim_u), jnp.asarray(d_u),
                                   jnp.asarray(g), s)
    out = tgrad.backward_depth_map(fv_t, None, T(fim_u), T(d_u), T(g), s)
    _grad_close(out, ref)


@pytest.mark.parametrize("fn", ["silhouette", "depth", "rgb"])
def test_exact_gradient_functions_match_jax_vjp(fn):
    """Forward maps and the gradients of rasterize_silhouette_exact,
    rasterize_depth_exact and render_rgb_exact (vertices; textures for RGB)
    against jax.vjp of the JAX package's custom VJPs, at 16 px; one face
    masked out through valid_f."""
    s = 16
    _, f, fv_j, fv_t = blob_scene()
    rng = np.random.RandomState(14)
    valid = np.ones((B, f.shape[0]), np.float32)
    valid[:, 3] = 0.0
    tex = rng.rand(B, f.shape[0], 2, 2, 2, 3).astype(np.float32)
    shape = (B, s, s, 3) if fn == "rgb" else (B, s, s)
    g = rng.randn(*shape).astype(np.float32)
    x = fv_t.clone().requires_grad_()
    tt = T(tex).requires_grad_()
    vj, vt = jnp.asarray(valid), T(valid)
    if fn == "silhouette":
        ref_fn = lambda v, t: jgrad.rasterize_silhouette_exact(v, vj, s)
        out = tgrad.rasterize_silhouette_exact(x, vt, s)
    elif fn == "depth":
        ref_fn = lambda v, t: jgrad.rasterize_depth_exact(v, vj, s, 0.1, 20.0)
        out = tgrad.rasterize_depth_exact(x, vt, s, 0.1, 20.0)
    else:
        ref_fn = lambda v, t: jgrad.render_rgb_exact(v, t, vj, s)
        out = tgrad.render_rgb_exact(x, tt, vt, s)

    @jax.jit
    def vjp_j(v, t, gj):
        # one compile of the forward and its custom VJP
        out_j, pull = jax.vjp(ref_fn, v, t)
        return out_j, pull(gj)

    out_j, grads_j = vjp_j(fv_j, jnp.asarray(tex), jnp.asarray(g))
    (out * T(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=1e-4 if fn == "rgb" else 1e-5, rtol=0)
    _grad_close(x.grad, grads_j[0], rtol=1e-3 if fn == "rgb" else 0.0)
    assert float(x.grad[:, 3].abs().max()) == 0.0  # the masked face
    if fn == "rgb":
        _grad_close(tt.grad, grads_j[1])
    else:
        assert tt.grad is None
