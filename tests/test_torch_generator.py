"""hoig_torch's generator against hoig_tpu's flax generator on the CPU:
building blocks, the flow-guided attention with both engines, the full
generator_spade_attn forward on weights carried by
generator_state_dict_from_flax, and the round trip back through
hoig_tpu.models.torch_port. Weights and inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoig_tpu.models import NetworksFactory as JaxFactory
from hoig_tpu.models import layers as jlayers
from hoig_tpu.models.generator import ExtractorAttn as JaxExtractorAttn
from hoig_tpu.models.torch_port import generator_params_from_torch
from hoig_tpu.train.trainer import TrainConfig as JaxTrainConfig
from hoig_torch.models import NetworksFactory, convert, layers
from hoig_torch.models.generator import ExtractorAttn
from hoig_torch.train.trainer import TrainConfig

# parallel test workers each run torch's CPU kernels; one intra-op thread per
# worker keeps them from contending for the same cores
torch.set_num_threads(1)

T = torch.as_tensor
_DIMS = dict(bg_dim=8, img_dim=3, obj_dim=3, img_cond_dim=3, obj_cond_dim=12)


def _random_tree(shapes, seed):
    """Numpy parameters shaped like a flax tree: kernels N(0, 0.02), norm
    scales 1 + N(0, 0.1), biases N(0, 0.1)."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        if "kernel" in name:
            return (rng.randn(*leaf.shape) * 0.02).astype(np.float32)
        if name == "scale":
            return (1.0 + rng.randn(*leaf.shape) * 0.1).astype(np.float32)
        return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _flax_params(module, seed, *args, **kwargs):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args, **kwargs)
    return _random_tree(shapes, seed)


def _state_from_mapping(entries, tree, prefix):
    return {key[len(prefix) + 1:]: T(convert._to_torch(kind, _leaf(tree["params"], path)))
            for path, key, kind in entries}


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def test_instance_norm_matches_flax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, 9, 6).astype(np.float32) * 3 + 1
    m = jlayers.InstanceNorm()
    p = _flax_params(m, 1, jnp.asarray(x))
    ref = m.apply(p, jnp.asarray(x))
    tm = layers.InstanceNorm(6)
    tm.load_state_dict({"weight": T(p["params"]["scale"]), "bias": T(p["params"]["bias"])})
    out = tm(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kernel", [3, 4])
def test_conv_transpose_matches_flax(kernel):
    x = np.random.RandomState(2).randn(2, 5, 6, 4).astype(np.float32)
    m = jlayers.conv_transpose(3, kernel)
    p = _flax_params(m, 3, jnp.asarray(x))
    with jax.default_matmul_precision("highest"):
        ref = m.apply(p, jnp.asarray(x))
    tm = layers.ConvTranspose2d(4, 3, kernel)
    tm.load_state_dict({"weight": T(convert._to_torch("convt", p["params"]["kernel"]))})
    out = tm(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_spade_residual_block_matches_flax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    seg = rng.rand(2, 16, 16, 3).astype(np.float32)  # nearest-resized inside
    m = jlayers.SPADEResidualBlock(6)
    p = _flax_params(m, 5, jnp.asarray(x), jnp.asarray(seg))
    with jax.default_matmul_precision("highest"):
        ref = m.apply(p, jnp.asarray(x), jnp.asarray(seg))
    tm = layers.SPADEResidualBlock(6, 3, torch.float32)
    tm.load_state_dict(_state_from_mapping(convert._spade_residual((), "blk"), p, "blk"))
    with torch.no_grad():
        out = tm(T(x).permute(0, 3, 1, 2), T(seg).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("engine", ["shift", "gather"])
def test_extractor_attn_matches_jax(engine):
    rng = np.random.RandomState(6)
    b, h, w, c = 2, 8, 10, 6
    src = rng.randn(b, h, w, c).astype(np.float32)
    tgt = rng.randn(b, h, w, c).astype(np.float32)
    # in-contract flow: floor(flow) in [-3, 2]
    flow = (rng.rand(b, h, w, 2) * 5.0 - 3.0).astype(np.float32)
    m = JaxExtractorAttn(kernel_size=5, corner_engine=engine)
    args = (jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(flow))
    p = _flax_params(m, 7, *args)
    with jax.default_matmul_precision("highest"):
        ref = m.apply(p, *args)
    tm = ExtractorAttn(c, 5, engine)
    tm.load_state_dict(_state_from_mapping(
        [(("fc_0_kernel",), "a.fully_connect_layer.0.weight", "conv"),
         (("fc_0_bias",), "a.fully_connect_layer.0.bias", "direct"),
         (("fc_1_kernel",), "a.fully_connect_layer.2.weight", "conv"),
         (("fc_1_bias",), "a.fully_connect_layer.2.bias", "direct")], p, "a"))
    with torch.no_grad():
        out = tm(T(src), T(tgt), T(flow))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def _generator_inputs(s=32, b=2):
    """The inputs of tests/test_models.py:128-164 (rng seed 0)."""
    rng = np.random.RandomState(0)
    chans = dict(bg_inputs=4, src_obj_inputs=3, tsf_obj_inputs=3, src_hand_inputs=3,
                 tsf_hand_inputs=3)
    kw = {k: rng.rand(b, s, s, c).astype(np.float32) for k, c in chans.items()}
    kw["T"] = (rng.rand(b, s, s, 2) * 2.0 - 1.0).astype(np.float32)
    for k, c in dict(src_obj_conds=12, src_hand_conds=3, tsf_obj_conds=12,
                     tsf_hand_conds=3).items():
        kw[k] = rng.rand(b, s, s, c).astype(np.float32)
    kw["src_armask"] = np.zeros((b, s, s, 1), np.float32)
    kw["tsf_armask"] = np.zeros((b, s, s, 1), np.float32)
    return kw


@pytest.mark.parametrize("gen_name,engine", [
    ("generator_spade_attn", "shift"),
    ("generator_spade_attn", "gather"),
    ("generator_spade", "gather"),  # no attention: the plain grid_sample warp
])
def test_generator_matches_flax(gen_name, engine):
    kw = _generator_inputs()
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    g = JaxFactory.get_by_name(gen_name, **_DIMS, conv_dim=16, repeat_num=2, remat=False,
                               corner_engine=engine)
    params = _flax_params(g, 3, **jkw)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(g.apply)(params, **jkw)
    tg = NetworksFactory.get_by_name(gen_name, **_DIMS, conv_dim=16, repeat_num=2,
                                     corner_engine=engine, device="cpu")
    tg.load_state_dict(convert.generator_state_dict_from_flax(
        params, TrainConfig(gen_name=gen_name, repeat_num=2)))
    with torch.inference_mode():
        out = tg(**{k: T(v) for k, v in kw.items()})
    assert len(out) == len(ref) == 10
    for i, (a, b) in enumerate(zip(out, ref)):
        assert tuple(a.shape) == b.shape, i
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5,
                                   err_msg=f"{gen_name} {engine} output {i}")


def test_state_dict_round_trips_through_torch_port():
    """port state_dict() -> torch_port.generator_params_from_torch == the
    flax tree it came from (all 9 attention layers: repeat_num 6)."""
    kw = {k: jnp.asarray(v) for k, v in _generator_inputs(s=16, b=1).items()}
    g = JaxFactory.get_by_name("generator_spade_attn", **_DIMS, conv_dim=8, repeat_num=6,
                               remat=False)
    params = _flax_params(g, 9, **kw)
    tg = NetworksFactory.get_by_name("generator_spade_attn", **_DIMS, conv_dim=8,
                                     repeat_num=6, device="cpu")
    tg.load_state_dict(convert.generator_state_dict_from_flax(params, TrainConfig(repeat_num=6)))
    sd = {k: v.numpy() for k, v in tg.state_dict().items()}
    back = generator_params_from_torch(params, sd, JaxTrainConfig(repeat_num=6))
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf, err_msg=str(path))
