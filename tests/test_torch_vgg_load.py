"""A torchvision vgg19 state dict loaded by both packages, on the CPU: the
port's `load_vgg_weights` (hoig_torch/train/model_api.py) from a `.pth` and
from its `.npz` dump, the JAX package's `load_torch_weights`
(hoig_tpu/models/vgg.py) on `init_vgg_params`. The state dict is made from a
seed with numpy: every convolution of vgg19's `features` (the 16, though
both loaders read the first 13) and a classifier key that both must ignore.
The five slices' features and the perceptual loss agree within 1e-5
relative. No real weights are needed."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hoig_tpu.models import vgg as jvgg
from hoig_torch.models.vgg import init_vgg, vgg_perceptual_loss
from hoig_torch.train.model_api import load_vgg_weights

torch.set_num_threads(1)

# torchvision vgg19 `features`: (index, in, out) of each 3x3 convolution
_CONVS = [(0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128), (10, 128, 256), (12, 256, 256),
          (14, 256, 256), (16, 256, 256), (19, 256, 512), (21, 512, 512), (23, 512, 512),
          (25, 512, 512), (28, 512, 512), (30, 512, 512), (32, 512, 512), (34, 512, 512)]


def _vgg19_state(seed: int) -> dict:
    """He-scaled kernels (features stay of order 1 through 13 convs) and
    small biases, OIHW as torchvision stores them."""
    rng = np.random.default_rng(seed)
    normal = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    state = {}
    for i, cin, cout in _CONVS:
        state[f"features.{i}.weight"] = normal(cout, cin, 3, 3) * np.float32(np.sqrt(2 / (9 * cin)))
        state[f"features.{i}.bias"] = np.float32(0.1) * normal(cout)
    state["classifier.0.bias"] = normal(4096)
    return state


class _Pyramids:
    """A stand-in for the JAX VGG's `apply`: the x and y pyramids, in the
    order vgg_perceptual_loss asks for them."""

    def __init__(self, fx, fy):
        self.out = [fx, fy]

    def apply(self, params, image):
        return self.out.pop(0)


def test_vgg19_state_dict_loads_as_jax_loads_it(tmp_path):
    """The .pth and the .npz file, each into a port VGG19, against the JAX
    package's VGG19 loaded from the same state dict."""
    state = _vgg19_state(3)
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, tmp_path / "vgg19.pth")
    np.savez(tmp_path / "vgg19.npz", **state)
    ported = []
    for fmt in ("pth", "npz"):
        vgg = init_vgg(seed=0, device="cpu")
        load_vgg_weights(vgg, str(tmp_path / f"vgg19.{fmt}"))
        ported.append(vgg)

    # init_vgg_params' tree, by shape (its eager init compiles op by op, and
    # the loader replaces every leaf: each convolution's kernel and bias)
    model = jvgg.Vgg19Features()
    shapes = jax.eval_shape(lambda key: jvgg.init_vgg_params(key)[1], jax.random.PRNGKey(0))
    params = jvgg.load_torch_weights(
        jax.tree.map(lambda a: np.full(a.shape, np.nan, a.dtype), shapes), state)
    assert all(np.isfinite(np.asarray(leaf)).all() for leaf in jax.tree.leaves(params))
    rng = np.random.RandomState(4)
    x = np.tanh(rng.randn(2, 32, 32, 3)).astype(np.float32)
    y = np.tanh(rng.randn(2, 32, 32, 3)).astype(np.float32)

    # one compiled forward for both pyramids (x and y share a shape); the
    # loss then runs on them as its model.apply calls would return them
    forward = jax.jit(model.apply)
    with jax.default_matmul_precision("highest"):
        jfeats, jfeats_y = forward(params, jnp.asarray(x)), forward(params, jnp.asarray(y))
    jloss = jax.jit(lambda fx, fy, x, y: jvgg.vgg_perceptual_loss(
        _Pyramids(fx, fy), None, x, y))(jfeats, jfeats_y, jnp.asarray(x), jnp.asarray(y))
    for fmt, vgg in zip(("pth", "npz"), ported):
        with torch.no_grad():
            feats = vgg(torch.from_numpy(x))
            loss = vgg_perceptual_loss(vgg, torch.from_numpy(x), torch.from_numpy(y))
        assert len(feats) == len(jfeats) == 5
        for i, (a, r) in enumerate(zip(feats, jfeats)):
            r = np.asarray(r)
            assert a.shape == r.shape, (fmt, i)
            np.testing.assert_allclose(a.numpy(), r, rtol=1e-5, atol=1e-5 * np.abs(r).max(),
                                       err_msg=f"{fmt} slice {i}")
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, err_msg=fmt)
