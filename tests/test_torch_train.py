"""The training slice on the CPU: hoig_torch's discriminator, VGG pyramid,
losses, train step (metrics, G gradients, D gradients), Adam, D gating, LR
decay, checkpoints and remat against hoig_tpu. 64 px (PatchGAN-4 needs it),
conv_dim 8, repeat 2, batch 2, f32, shift engine on both sides, weights from
numpy seeds carried across with hoig_torch.models.convert, JAX at matmul
precision "highest", the JAX-built tables fed to both sides."""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hoig_tpu.data import synthetic as jsyn
from hoig_tpu.geometry.conditioning import ConditioningConfig as JaxConditioningConfig
from hoig_tpu.geometry.conditioning import hand_recovery_flow as jax_hand_recovery_flow
from hoig_tpu.models.discriminator import MultiScaleDiscriminator as JaxMultiScale
from hoig_tpu.models.discriminator import PatchDiscriminator as JaxPatchDiscriminator
from hoig_tpu.models.vgg import Vgg19Features as JaxVgg
from hoig_tpu.models.vgg import vgg_perceptual_loss as jax_vgg_perceptual_loss
from hoig_tpu.train import losses as jlosses
from hoig_tpu.train import trainer as jtrainer
from hoig_torch.geometry.conditioning import ConditioningConfig
from hoig_torch.geometry.mano import MANOModel
from hoig_torch.models import NetworksFactory, convert
from hoig_torch.models.discriminator import MultiScaleDiscriminator, PatchDiscriminator
from hoig_torch.models.vgg import Vgg19Features, vgg_perceptual_loss
from hoig_torch.train import (
    TrainConfig,
    build_networks,
    decay_lr,
    init_state,
    load_checkpoint,
    load_generator_params,
    losses,
    make_train_step,
    save_checkpoint,
    scan_latest_epoch,
)
from hoig_torch.train import trainer as trainer_module
from hoig_torch.train.model_api import batch_as_torch
from hoig_torch.train.trainer import _conditioning, make_eval_metrics, make_g_grads_fn

# parallel test workers each run torch's CPU kernels; one intra-op thread per
# worker keeps them from contending for the same cores
torch.set_num_threads(1)

T = torch.as_tensor
S, B = 64, 2
_TABLE_KEYS = ("faces", "face_valid", "num_faces", "map_fn", "sem", "fim_uv", "wim_uv",
               "faces_uv_coord", "obj_tex")


def _random_tree(shapes, seed, he_kernels=False):
    """flax-shaped numpy weights: kernels N(0, 0.02) (or He-scaled, so that a
    13-conv VGG keeps its features at order 1), biases N(0, 0.1)."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        if "kernel" in name:
            std = np.sqrt(2.0 / np.prod(leaf.shape[:-1])) if he_kernels else 0.02
            return (rng.randn(*leaf.shape) * std).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + rng.randn(*leaf.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _flax_params(module, seed, *args, he_kernels=False, **kwargs):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args, **kwargs)
    return _random_tree(shapes, seed, he_kernels)


# ---------------------------------------------------------------- (a) forward


def test_patch_discriminator_matches_flax():
    x = np.random.RandomState(0).randn(B, S, S, 19).astype(np.float32)
    m = JaxPatchDiscriminator(ndf=8, n_layers=4)
    p = _flax_params(m, 1, jnp.asarray(x))
    with jax.default_matmul_precision("highest"):
        ref = m.apply(p, jnp.asarray(x))
    tm = PatchDiscriminator(19, ndf=8, n_layers=4)
    tm.load_state_dict(convert.discriminator_state_dict_from_flax(p, n_layers=4))
    with torch.no_grad():
        out = tm(T(x))
    assert tuple(out.shape) == ref.shape == (B, 2, 2, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    # the port's state dict carries the reference's keys: the JAX package's own
    # converter takes it back to the flax tree it came from
    from hoig_tpu.models.torch_port import discriminator_params_from_torch

    back = discriminator_params_from_torch(p, {k: v.numpy() for k, v in tm.state_dict().items()})
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(p):
        np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf, err_msg=str(path))


def test_multi_scale_discriminator_matches_flax():
    rng = np.random.RandomState(2)
    pyramid = [rng.randn(1, s, s, 3).astype(np.float32) for s in (48, 32)]
    m = JaxMultiScale(n_scales=2, ndf=4, n_layers=3)
    p = _flax_params(m, 3, [jnp.asarray(x) for x in pyramid])
    with jax.default_matmul_precision("highest"):
        ref = m.apply(p, [jnp.asarray(x) for x in pyramid])
    tm = MultiScaleDiscriminator(3, n_scales=2, ndf=4, n_layers=3)
    for i in range(2):
        getattr(tm, f"scale_{i}").load_state_dict(
            convert.discriminator_state_dict_from_flax(p["params"][f"scale_{i}"], n_layers=3))
    with torch.no_grad():
        out = tm([T(x) for x in pyramid])
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


def test_batchnorm_discriminator_trains_in_train_mode():
    """norm_type 'batch': no conv bias beside the norms, BatchNorm parameters
    in the state dict, and the factory hands it out in train mode."""
    d = NetworksFactory.get_by_name("discriminator_patch_gan", input_nc=5, ndf=4, n_layers=2,
                                    norm_type="batch", device="cpu")
    assert d.training
    keys = set(d.state_dict())
    assert "model.0.bias" in keys and "model.2.bias" not in keys and "model.3.weight" in keys
    out = d(torch.randn(3, 32, 32, 5))
    assert out.shape == (3, 6, 6, 1) and torch.isfinite(out).all()
    assert int(d.model[3].num_batches_tracked) == 1
    with pytest.raises(NotImplementedError):
        PatchDiscriminator(5, norm_type="layer")


@pytest.mark.parametrize("before_relu", [False, True])
def test_vgg_pyramid_and_loss_match_flax(before_relu):
    rng = np.random.RandomState(4)
    x = (rng.rand(B, S, S, 3) * 2 - 1).astype(np.float32)
    y = (rng.rand(B, S, S, 3) * 2 - 1).astype(np.float32)
    valid = np.array([1.0, 0.0], np.float32)
    m = JaxVgg(before_relu=before_relu)
    p = _flax_params(m, 5, jnp.asarray(x), he_kernels=True)
    with jax.default_matmul_precision("highest"):
        ref = m.apply(p, jnp.asarray(x))
        ref_loss = jax_vgg_perceptual_loss(m, p, jnp.asarray(x), jnp.asarray(y))
        ref_loss_w = jax_vgg_perceptual_loss(m, p, jnp.asarray(x), jnp.asarray(y),
                                             jnp.asarray(valid))
    tm = Vgg19Features(before_relu=before_relu)
    tm.load_state_dict(convert.vgg_state_dict_from_flax(p))
    assert sorted(tm.state_dict())[:2] == ["features.0.bias", "features.0.weight"]
    assert "features.28.weight" in tm.state_dict() and len(tm.state_dict()) == 26
    assert not any(q.requires_grad for q in tm.parameters())
    out = tm(T(x))
    assert [tuple(o.shape) for o in out] == [r.shape for r in ref]
    for i, (a, b) in enumerate(zip(out, ref)):
        top = float(np.abs(np.asarray(b)).max())
        assert top > 0.1, "features too small to test"
        # atol 1e-5 of the slice's largest feature: up to 13 stacked f32
        # convolutions of fan-in up to 4608, summed in other orders
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5 * max(top, 1.0), rtol=1e-5,
                                   err_msg=str(i))
    np.testing.assert_allclose(float(vgg_perceptual_loss(tm, T(x), T(y))), float(ref_loss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(vgg_perceptual_loss(tm, T(x), T(y), T(valid))),
                               float(ref_loss_w), rtol=1e-5)


def _loss_cases():
    rng = np.random.RandomState(6)
    x = rng.rand(3, 2, 5, 7).astype(np.float32)
    y = rng.rand(3, 2, 5, 7).astype(np.float32)
    p = np.clip(x, 0.0, 1.0)
    p[0, 0, 0, :2] = (0.0, 1.0)  # the clamped logs
    t = (y > 0.5).astype(np.float32)
    nhwc = rng.rand(3, 9, 8, 1).astype(np.float32)
    return {
        "wmean": ("wmean", (x,)),
        "lsgan_fake": ("lsgan_loss", (x, -1.0)),
        "lsgan_real": ("lsgan_loss", (x, 1.0)),
        "l1": ("l1_loss", (x, y)),
        "mse": ("mse_loss", (x, y)),
        "bce": ("bce_loss", (p, t)),
        "tv_nchw": ("tv_smooth_loss", (x,)),
        "tv_nhwc": ("tv_smooth_loss", (nhwc,)),
    }


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", sorted(_loss_cases()))
def test_loss_functions_match_jax(case, weighted):
    name, args = _loss_cases()[case]
    w = np.array([1.0, 0.0, 2.0], np.float32) if weighted else None
    as_j = lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a
    as_t = lambda a: T(a) if isinstance(a, np.ndarray) else a
    ref = getattr(jlosses, name)(*map(as_j, args), None if w is None else jnp.asarray(w))
    out = getattr(losses, name)(*map(as_t, args), None if w is None else T(w))
    assert np.isfinite(float(out))
    np.testing.assert_allclose(float(out), float(ref), atol=1e-5, rtol=1e-5)


def test_bce_loss_gradient_is_finite_at_saturation():
    """A bf16 sigmoid reaches exactly 0 and 1; there the clamped logs give the
    JAX package's forward value (-100) and a zero gradient where the log-then-
    clamp formula's backward is 0 * inf."""
    pred = T(np.array([[0.0, 1.0, 0.25, 1.0, 0.0]], np.float32)).requires_grad_()
    target = T(np.array([[0.0, 1.0, 1.0, 0.0, 1.0]], np.float32))
    loss = losses.bce_loss(pred, target)
    ref = jlosses.bce_loss(jnp.asarray(pred.detach().numpy()), jnp.asarray(target.numpy()))
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-6)
    loss.backward()
    assert torch.isfinite(pred.grad).all()
    # the last two are the saturated-and-wrong predictions: no gradient
    np.testing.assert_allclose(pred.grad.numpy(), [[0.2, -0.2, -0.8, 0.0, 0.0]], atol=1e-6)


def test_tv_smooth_loss_rejects_non_4d():
    with pytest.raises(ValueError):
        losses.tv_smooth_loss(torch.zeros(3, 4, 4))


@pytest.mark.parametrize("engine", ["shift", "gather"])
def test_extractor_attn_gradients_match_jax(engine):
    """Gradients of the flow-guided attention with respect to its weights, the
    source and the target, for both engines (the shift engine through the
    LocalCombine Function); rtol 1e-4 of each gradient's largest entry."""
    from hoig_tpu.models.generator import ExtractorAttn as JaxExtractorAttn
    from hoig_torch.models.generator import ExtractorAttn

    rng = np.random.RandomState(6)
    b, h, w, c = 2, 12, 10, 8
    src, tgt, cot = (rng.randn(b, h, w, c).astype(np.float32) for _ in range(3))
    flow = (rng.rand(b, h, w, 2) * 5.0 - 3.0).astype(np.float32)  # floor(flow) in [-3, 2]
    m = JaxExtractorAttn(kernel_size=5, corner_engine=engine)
    p = _flax_params(m, 7, jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(flow))
    with jax.default_matmul_precision("highest"):
        gp, gs, gt = jax.jit(jax.grad(
            lambda p_, s_, t_: jnp.sum(m.apply(p_, s_, t_, jnp.asarray(flow)) * cot),
            argnums=(0, 1, 2)))(p, jnp.asarray(src), jnp.asarray(tgt))
    tm = ExtractorAttn(c, 5, engine)
    fc = tm.fully_connect_layer
    with torch.no_grad():
        fc[0].weight.copy_(T(convert._to_torch("conv", p["params"]["fc_0_kernel"])))
        fc[0].bias.copy_(T(p["params"]["fc_0_bias"]))
        fc[2].weight.copy_(T(convert._to_torch("conv", p["params"]["fc_1_kernel"])))
        fc[2].bias.copy_(T(p["params"]["fc_1_bias"]))
    s_, t_ = T(src).requires_grad_(), T(tgt).requires_grad_()
    (tm(s_, t_, T(flow)) * T(cot)).sum().backward()
    pairs = {
        "source": (s_.grad.numpy(), gs), "target": (t_.grad.numpy(), gt),
        "fc_0_kernel": (convert._from_torch("conv", fc[0].weight.grad.numpy()),
                        gp["params"]["fc_0_kernel"]),
        "fc_0_bias": (fc[0].bias.grad.numpy(), gp["params"]["fc_0_bias"]),
        "fc_1_kernel": (convert._from_torch("conv", fc[2].weight.grad.numpy()),
                        gp["params"]["fc_1_kernel"]),
        "fc_1_bias": (fc[2].bias.grad.numpy(), gp["params"]["fc_1_bias"]),
    }
    for name, (out, ref) in pairs.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * float(np.abs(ref).max()),
                                   err_msg=name)


# ------------------------------------------------ (b) one step against JAX


# the two variants of the reference: HOv3 (the TrainConfig and
# ConditioningConfig defaults) and DexYCB (bench.py's train_bf16_dexycb leg,
# train_config_from_opt's ycb widths): fx/fy camera, PCA-45 MANO without the
# flat hand mean, 13 background channels, 9 hand-condition channels (6 hand
# segmentation channels added), a 24-channel D input, no masks, no arm mask.
#
# feed_flow: the port's step runs on JAX's conditioning outputs instead of
# its own. The DexYCB batch's renders hold z-fights: at 2 of the 2 x 2 x 64^2
# rasterized pixels two faces' f32 inverse depths tie to a few ulps and the
# packages pick different faces (ROADMAP section C; at the target pixel the
# port's f32 pick is its float64 evaluation's, at the source pixel JAX's is).
# One hand-segmentation one-hot flips there, which moves d_fake by 3% and
# g_adv by 1e-3. The step is held on the same conditioning, and the port's
# own conditioning against JAX's within that share of pixels
# (test_step_metrics_and_gradients_match_jax; tests/test_torch_conditioning.py).
VARIANTS = {
    "hov3": dict(ccfg={}, tcfg={}, camera="matrix", with_masks=True, feed_flow=False),
    "dexycb": dict(ccfg=dict(camera_model="fxfy", mano_pca_comps=45, mano_flat_hand_mean=False),
                   tcfg=dict(bg_dim=13, img_cond_dim=9, d_input_nc=24, use_armask=False),
                   camera="fxfy", with_masks=False, feed_flow=True),
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def both(request):
    """One JAX evaluation (loss scalars, G gradients, D gradients) and one
    step of the port on the same weights and batch, for each variant.

    The port runs its shift engine (the one with the kernel). The JAX side
    runs its conditioning once, jitted, for all three of its evaluations, and
    takes the loss scalars and the fake from a jitted forward with its shift
    engine, the G gradients from a jitted function with its gather engine
    (its pick under f32; the two engines compute the same function), and
    differentiates the D loss un-jitted. Under jit, XLA:CPU (jax 0.9.0) returns gradients that are off
    by 1-30% in places (the JAX shift engine's 16x16 layer, the
    discriminator's first conv) while the same functions differentiated
    un-jitted agree with the port to 1e-5 (ROADMAP section C). The shift
    engine's own gradient is held against JAX in
    test_extractor_attn_gradients_match_jax. The loss scalars come from
    `_forward_and_g_losses`, the one loss graph the JAX train step itself
    calls, and from the step's D-loss formula."""
    jtables, jmano, obj_verts = jsyn.synthetic_environment(2, S)
    # The synthetic objects are untextured: the generator's object images are
    # constant, and the object branch's InstanceNorms then divide rounding
    # noise by sqrt(eps) layer after layer, which leaves its gradients
    # ill-conditioned (the two packages' f32 gradients differ by 10% there).
    # A random texture, given to both sides, makes them well-posed.
    jtables.obj_tex = (np.random.RandomState(5).rand(*jtables.obj_tex.shape) * 2 - 1).astype(
        np.float32)
    variant = VARIANTS[request.param]
    batch = jsyn.synthetic_batch(B, obj_verts, image_size=S, camera=variant["camera"],
                                 with_masks=variant["with_masks"])
    jbatch = jax.tree.map(jnp.asarray, batch)
    jccfg = JaxConditioningConfig(image_size=S, **variant["ccfg"])
    jcfg = jtrainer.TrainConfig(image_size=S, conv_dim=8, repeat_num=2, remat=False,
                                corner_engine="gather", **variant["tcfg"])
    armask = (lambda b_, k: b_[k]) if jcfg.use_armask else (lambda b_, k: None)
    g, d = jtrainer.build_networks(jcfg)
    vgg = JaxVgg()
    tables, mano_params = jtables.as_jax(), jmano.as_jax()

    def flow_of(b_):
        return jax_hand_recovery_flow(tables, mano_params, b_["imageA"], b_["imageB"],
                                      b_["manoA"], b_["manoB"], jccfg)

    def g_losses(engine_cfg, g_model, params_g, params_d, vgg_params, flow, b_):
        fakes, total, parts, _ = jtrainer._forward_and_g_losses(
            g_model, d, lambda x, y, w=None: jax_vgg_perceptual_loss(vgg, vgg_params, x, y, w),
            engine_cfg, params_g, params_d, flow, b_)
        return total, (dict(parts, loss_G=total), fakes[1])

    def jax_g_grads(params_g, params_d, vgg_params, flow, b_):
        flow = jax.lax.stop_gradient(flow)
        return jax.grad(lambda pg: g_losses(jcfg, g, pg, params_d, vgg_params, flow, b_)[0])(
            params_g)

    # forward only, with the shift engine the port runs: the loss scalars and
    # the fake that the D loss sees
    jcfg_shift = dataclasses.replace(jcfg, corner_engine="shift")
    g_shift, _ = jtrainer.build_networks(jcfg_shift)

    def jax_g_forward(params_g, params_d, vgg_params, flow, b_):
        _, (metrics, fake_tsf) = g_losses(jcfg_shift, g_shift, params_g, params_d, vgg_params,
                                          flow, b_)
        return metrics, fake_tsf, jtrainer._d_cond(flow, armask(b_, "maskB"))

    def jax_d_side(params_d, real, fake_tsf, cond):
        def d_loss(pd):
            d_real = d.apply(pd, jnp.concatenate([real, cond], axis=-1))
            d_fake = d.apply(pd, jnp.concatenate([fake_tsf, cond], axis=-1))
            loss = (jlosses.lsgan_loss(d_real, 1.0) + jlosses.lsgan_loss(d_fake, -1.0)) \
                * jcfg.lambda_D_prob
            return loss, {"d_real": jnp.mean(d_real), "d_fake": jnp.mean(d_fake)}

        (loss_d, d_aux), d_grads = jax.value_and_grad(d_loss, has_aux=True)(params_d)
        return dict(d_aux, loss_D=loss_d), d_grads

    gkw_shapes = jax.eval_shape(
        lambda b_: jtrainer.generator_kwargs(flow_of(b_), armask(b_, "maskA"), armask(b_, "maskB"),
                                             True), jbatch)
    params_g = _random_tree(jax.eval_shape(g.init, jax.random.PRNGKey(0), **gkw_shapes), 11)
    params_d = _flax_params(d, 12, jnp.zeros((B, S, S, jcfg.d_input_nc)))
    vgg_params = _flax_params(vgg, 13, jnp.zeros((1, S, S, 3)), he_kernels=True)
    with jax.default_matmul_precision("highest"):
        j_flow = jax.jit(flow_of)(jbatch)
        j_g_grads = jax.jit(jax_g_grads)(params_g, params_d, vgg_params, j_flow, jbatch)
        g_metrics, fake_tsf, cond = jax.jit(jax_g_forward)(params_g, params_d, vgg_params, j_flow,
                                                           jbatch)
        # un-jitted: the jitted D loss returns a first-conv gradient 1.4% off
        d_metrics, j_d_grads = jax_d_side(
            params_d, jnp.transpose(jbatch["imageB"], (0, 2, 3, 1)), fake_tsf, cond)
    j_metrics = dict(g_metrics, **d_metrics)

    tcfg = TrainConfig(image_size=S, conv_dim=8, repeat_num=2, remat=False,
                       corner_engine="shift", **variant["tcfg"])
    tg, td = build_networks(tcfg, device="cpu")
    tg.load_state_dict(convert.generator_state_dict_from_flax(params_g, tcfg))
    td.load_state_dict(convert.discriminator_state_dict_from_flax(params_d))
    tvgg = Vgg19Features()
    tvgg.load_state_dict(convert.vgg_state_dict_from_flax(vgg_params))
    # the JAX-built tables for both: the port's own differ in the last bits
    # of wim_uv (tests/test_torch_conditioning.py)
    env = dict(tables={k: T(getattr(jtables, k)) for k in _TABLE_KEYS},
               mano_params=MANOModel.synthetic(0).as_torch("cpu"))
    tccfg = ConditioningConfig(image_size=S, **variant["ccfg"])
    tbatch = batch_as_torch(batch, "cpu")
    fn_args = (tvgg, env["tables"], env["mano_params"], tccfg, tcfg)
    t_flow = _conditioning(env["tables"], env["mano_params"], tbatch, tccfg)
    with pytest.MonkeyPatch.context() as mp:
        if variant["feed_flow"]:
            fed = {k: None if v is None else T(np.array(v)) for k, v in j_flow.items()}
            mp.setattr(trainer_module, "_conditioning", lambda *a: fed)
        fn_grads = make_g_grads_fn(*fn_args)(tg, td, tbatch)
        assert all(p.grad is None for p in td.parameters()), "the G loss left gradients in D"
        state = init_state(tg, td, tcfg)
        state, t_metrics = make_train_step(*fn_args)(state, tbatch, True)
    return dict(j_metrics=j_metrics, j_g_grads=j_g_grads, j_d_grads=j_d_grads,
                t_metrics=t_metrics, fn_grads=fn_grads, state=state, tcfg=tcfg,
                j_params_g=params_g, j_params_d=params_d, j_flow=j_flow, t_flow=t_flow)


def _assert_leaves_close(port_named: dict, mapping, jax_tree, what: str, rel_tree: float):
    """Leaf by leaf, two bounds on max|port - jax|:

      * 2e-4 of the leaf's largest entry + `rel_tree` of the whole tree's
        largest entry: the accuracy bound;
      * 0.15 of the leaf's largest entry + 1e-6 of the tree's: the bound that
        a missing or mis-signed gradient path breaks in any leaf, however
        small its gradient (the 1e-6 covers the leaves whose gradient is zero
        by construction, a conv bias in front of a parameter-free norm, where
        both sides hold rounding noise only).
    """
    tree = convert.flax_tree_from_torch(port_named, mapping)
    flat_j = jax.tree_util.tree_leaves_with_path(jax_tree["params"])
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(flat_j) == len(flat_t) > 0
    tree_max = max(float(np.abs(np.asarray(leaf)).max()) for _, leaf in flat_j)
    for path, leaf in flat_j:
        ref = np.asarray(leaf)
        err = float(np.abs(flat_t[path] - ref).max())
        scale = float(np.abs(ref).max())
        msg = f"{what} {jax.tree_util.keystr(path)}: {err} vs leaf max {scale}, tree max {tree_max}"
        assert err <= 2e-4 * scale + rel_tree * tree_max, msg
        assert err <= 0.15 * scale + 1e-6 * tree_max, msg


def test_step_metrics_and_gradients_match_jax(both):
    """One test for the four checks that share the costly fixture (so that
    parallel test workers build it once).

    Loss scalars: f32 on both sides, sums over 64^2 pixels in other orders;
    rtol 1e-4.

    G gradients: what the step left in G's .grad (taken before Adam moved the
    weights), leaf by leaf. The large leaves agree to 2e-5 of their largest
    entry. The two packages' outputs differ by 6e-6 (f32, other summation
    orders), and the slope of that difference shows in the leaves whose
    gradient is 1e-2 to 1e-5 of the tree's largest (the tsf branch's
    bottleneck and the attention weights, up to 11% of their own largest
    entry) and as up to 5e-3 of the tree's largest entry in the first convs
    of the background and tsf branches; the port's gradient there equals its
    float64 evaluation to 1e-5 and the attention's own gradient agrees with
    JAX to 1e-4. Hence the accuracy bound of 1e-2 of the tree's largest
    entry.

    D gradients: D's .grad after the step holds the D loss's gradients alone
    (a leak of the G loss into D would show here); measured agreement 1e-5 of
    each leaf's largest entry, bound 2e-4 (+ 1e-6 of the tree's).

    Conditioning: the port's own outputs against JAX's, within 1e-4 but on at
    most 1e-3 of the elements (the z-fights of VARIANTS; none in the HOv3
    batch, whose step runs on the port's own conditioning)."""
    for k, ref in both["j_flow"].items():
        out = both["t_flow"][k]
        if ref is None:
            assert out is None, k
            continue
        assert tuple(out.shape) == ref.shape, k
        assert np.mean(np.abs(out.numpy() - np.asarray(ref)) > 1e-4) <= 1e-3, k
    assert sorted(both["t_metrics"]) == sorted(both["j_metrics"])
    for k, ref in both["j_metrics"].items():
        out = both["t_metrics"][k]
        assert out.ndim == 0 and not out.requires_grad
        np.testing.assert_allclose(float(out), float(ref), rtol=1e-4, atol=1e-5, err_msg=k)

    named = {n: p.grad for n, p in both["state"].g.named_parameters()}
    assert all(g is not None and torch.isfinite(g).all() for g in named.values())
    mapping = convert.generator_mapping(both["tcfg"].gen_name, both["tcfg"].repeat_num)
    _assert_leaves_close(named, mapping, both["j_g_grads"], "G grad", rel_tree=1e-2)
    # make_g_grads_fn gives the same gradients as the step took
    for n, g in both["fn_grads"].items():
        np.testing.assert_allclose(g.numpy(), named[n].numpy(), rtol=1e-5, atol=1e-8, err_msg=n)

    named = {n: p.grad for n, p in both["state"].d.named_parameters()}
    assert all(g is not None and torch.isfinite(g).all() for g in named.values())
    _assert_leaves_close(named, convert.discriminator_mapping(4), both["j_d_grads"], "D grad",
                         rel_tree=1e-6)

    # state dict -> flax layout -> state dict is the identity, and tensors
    # outside the mapping are refused
    mapping = convert.discriminator_mapping(4)
    sd = convert.discriminator_state_dict_from_flax(both["j_params_d"])
    tree = convert.flax_tree_from_torch(sd, mapping)
    for path, leaf in jax.tree_util.tree_leaves_with_path(both["j_params_d"]["params"]):
        node = tree
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)
    with pytest.raises(ValueError):
        convert.flax_tree_from_torch(dict(sd, extra=torch.zeros(1)), mapping)
    with pytest.raises(KeyError):
        convert.flax_tree_from_torch({}, mapping)


# ------------------------------------------------------------ (c) Adam


def test_adam_matches_optax():
    """torch Adam as init_state builds it == optax.adam(1.0, b1, b2) with the
    LR multiplied onto the update, over 3 steps on given gradients with an LR
    decay in between; atol 1e-6."""
    rng = np.random.RandomState(7)
    shapes = {"a": (4, 3), "b": (5,)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 10.0 ** rng.randint(-4, 2)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    tcfg = TrainConfig(nepochs_decay=4)

    opt = optax.adam(1.0, b1=tcfg.adam_b1, b2=tcfg.adam_b2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate, lr = opt.init(jp), tcfg.lr_G

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = torch.nn.Parameter(T(p0["a"]).clone())
            self.b = torch.nn.Parameter(T(p0["b"]).clone())

    net = Holder()
    state = init_state(net, Holder(), tcfg)
    for i, g in enumerate(grads):
        upd, jstate = opt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: u * lr, upd))
        for k, v in g.items():
            getattr(net, k).grad = T(v).clone()
        state.opt_g.step()
        for k in shapes:
            np.testing.assert_allclose(getattr(net, k).detach().numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=0, err_msg=f"step {i} {k}")
        if i == 0:
            state = decay_lr(state, tcfg)
            lr -= (tcfg.lr_G - tcfg.final_lr) / tcfg.nepochs_decay
    exp_avg = state.opt_g.state[net.a]["exp_avg"]
    assert exp_avg.dtype == torch.float32
    np.testing.assert_allclose(exp_avg.numpy(), np.asarray(jstate[0].mu["a"]), atol=1e-6, rtol=0)


# ------------------------------------- (d) gating, schedule, checkpoints (port)


@pytest.fixture(scope="module")
def setup():
    from hoig_torch.data.synthetic import synthetic_batch, synthetic_environment
    from hoig_torch.models.vgg import init_vgg

    env = synthetic_environment(2, S, device="cpu")
    tcfg = TrainConfig(image_size=S, conv_dim=8, repeat_num=2, remat=False,
                       corner_engine="shift")
    vgg = init_vgg(seed=2, device="cpu")
    ccfg = ConditioningConfig(image_size=S)
    batch = batch_as_torch(synthetic_batch(B, env["obj_verts"], image_size=S), "cpu")
    fn_args = (vgg, env["tables"], env["mano_params"], ccfg, tcfg)

    def fresh(cfg=tcfg):
        return init_state(*build_networks(cfg, device="cpu"), cfg)

    return dict(tcfg=tcfg, fresh=fresh, step=make_train_step(*fn_args), batch=batch,
                fn_args=fn_args, env=env, ccfg=ccfg, vgg=vgg)


def _snapshot(module_or_opt):
    sd = module_or_opt.state_dict()
    if "state" in sd:  # an optimizer
        return {(i, k): v.clone() if torch.is_tensor(v) else v
                for i, st in sd["state"].items() for k, v in st.items()}
    return {k: v.clone() for k, v in sd.items()}


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] == b[k] for k in a)


def test_step_updates_and_d_gating(setup):
    state = setup["fresh"]()
    g0, d0 = _snapshot(state.g), _snapshot(state.d)
    state, m = setup["step"](state, setup["batch"], True)
    for k in ("loss_G", "loss_D", "g_rec", "g_tsf", "g_adv", "g_mask", "g_mask_smooth",
              "d_real", "d_fake"):
        assert np.isfinite(float(m[k])), k
    g1, d1, od1 = _snapshot(state.g), _snapshot(state.d), _snapshot(state.opt_d)
    # every parameter moves, except where its gradient is exactly zero (the
    # first object-branch layers on the synthetic batch's constant object
    # images, a conv bias in front of a parameter-free norm)
    zero_grad = {n for net in (state.g, state.d) for n, p in net.named_parameters()
                 if not p.grad.any()}
    still_g = {k for k in g0 if torch.equal(g0[k], g1[k])}
    still_d = {k for k in d0 if torch.equal(d0[k], d1[k])}
    assert still_g | still_d <= zero_grad, sorted((still_g | still_d) - zero_grad)
    assert len(still_g) < 0.05 * len(g0) and len(still_d) <= 4
    # gated step: D untouched, parameters AND optimizer state, bit for bit
    state, m2 = setup["step"](state, setup["batch"], False)
    assert _same(_snapshot(state.d), d1) and _same(_snapshot(state.opt_d), od1)
    assert all(np.isfinite(float(m2[k])) for k in ("loss_D", "d_real", "d_fake"))
    assert not _same(_snapshot(state.g), g1)
    assert state.step == 2


def test_losses_drop_over_steps(setup):
    state = setup["fresh"]()
    rec = []
    for _ in range(8):
        state, m = setup["step"](state, setup["batch"], True)
        rec.append(float(m["g_rec"]))
    assert rec[-1] < rec[0]  # L1 reconstruction improves on a fixed batch


def test_lr_decay_schedule(setup):
    tcfg = setup["tcfg"]
    state = setup["fresh"]()
    one = (tcfg.lr_G - tcfg.final_lr) / tcfg.nepochs_decay
    state = decay_lr(state, tcfg)
    np.testing.assert_allclose(state.lr_g, tcfg.lr_G - one, rtol=1e-6)
    for _ in range(tcfg.nepochs_decay - 1):
        state = decay_lr(state, tcfg)
    np.testing.assert_allclose(state.lr_g, tcfg.final_lr, rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(state.lr_d, tcfg.final_lr, rtol=1e-4, atol=1e-9)
    assert all(gr["lr"] == state.lr_g for gr in state.opt_g.param_groups)
    assert all(gr["lr"] == state.lr_d for gr in state.opt_d.param_groups)


def test_checkpoint_roundtrip_and_scan(setup, tmp_path):
    d = str(tmp_path)
    s1 = setup["fresh"]()
    s1, _ = setup["step"](s1, setup["batch"], True)
    s1 = decay_lr(s1, setup["tcfg"])
    save_checkpoint(d, 7, s1)
    save_checkpoint(d, 3, s1)
    assert scan_latest_epoch(d) == 7
    assert sorted(os.listdir(d))[0].startswith("net_epoch_")
    restored = load_checkpoint(d, 7, setup["fresh"]())
    assert _same(_snapshot(restored.g), _snapshot(s1.g))
    assert _same(_snapshot(restored.d), _snapshot(s1.d))
    assert _same(_snapshot(restored.opt_g), _snapshot(s1.opt_g))
    assert _same(_snapshot(restored.opt_d), _snapshot(s1.opt_d))
    assert restored.step == s1.step == 1
    assert restored.lr_g == s1.lr_g and restored.opt_d.param_groups[0]["lr"] == s1.lr_d
    # the restored state trains on exactly as the saved one does
    a, ma = setup["step"](s1, setup["batch"], True)
    b, mb = setup["step"](restored, setup["batch"], True)
    assert float(ma["loss_G"]) == float(mb["loss_G"]) and _same(_snapshot(a.g), _snapshot(b.g))
    # G-only restores
    g_only = load_checkpoint(d, 3, setup["fresh"](), load_optimizers=False)
    assert g_only.step == 0 and not g_only.opt_g.state_dict()["state"]
    g2 = load_generator_params(setup["fresh"]().g, os.path.join(d, "net_epoch_7_id_G.pth"))
    assert _same(_snapshot(g2), _snapshot(g_only.g))
    with pytest.raises(FileNotFoundError):
        load_checkpoint(d, 5, setup["fresh"]())

    # a run killed mid-save leaves a TORN epoch (net files written, opt files
    # missing); the scan falls back to the newest COMPLETE epoch
    open(os.path.join(d, "net_epoch_9_id_G.pth"), "wb").close()
    open(os.path.join(d, "net_epoch_9_id_D.pth"), "wb").close()
    assert scan_latest_epoch(d) == 7
    assert scan_latest_epoch(os.path.join(d, "absent")) == 0


def test_eval_metrics_share_the_step_loss_graph(setup):
    """make_eval_metrics reports the step's own G-side scalars on the same
    weights, and 0-weighted pad replicas do not move them."""
    state = setup["fresh"]()
    vgg, tables, mano_params, ccfg, tcfg = setup["fn_args"]
    eval_fn = make_eval_metrics(vgg, tcfg)
    batch = setup["batch"]
    flow = _conditioning(tables, mano_params, batch, ccfg)
    fakes, m0 = eval_fn(state.g, state.d, flow, batch, torch.ones(B))
    assert fakes[1].shape == (B, S, S, 3) and not fakes[1].requires_grad
    pad = lambda x: torch.cat([x, x[-1:]], dim=0)
    batch_p = {k: ({kk: pad(vv) for kk, vv in v.items()} if isinstance(v, dict) else pad(v))
               for k, v in batch.items()}
    flow_p = _conditioning(tables, mano_params, batch_p, ccfg)
    _, m1 = eval_fn(state.g, state.d, flow_p, batch_p, torch.tensor([1.0, 1.0, 0.0]))
    for k in m0:
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), rtol=2e-4, err_msg=k)
    _, m_step = setup["step"](state, batch, False)
    for k in ("g_adv", "g_rec", "g_tsf", "g_mask", "g_mask_smooth", "d_real", "d_fake"):
        np.testing.assert_allclose(float(m0[k]), float(m_step[k]), rtol=1e-5, err_msg=k)


def test_fused_engine_step_matches_shift_engine(setup):
    """One step with the fused attention engine (corner_engine "pallas")
    against the same step with the shift engine, which the JAX comparison
    above holds: same weights and batch; loss scalars rtol 1e-4, and the G
    and D gradients leaf by leaf within the bounds of
    test_step_metrics_and_gradients_match_jax."""
    vgg, _, mano_params, ccfg, tcfg = setup["fn_args"]
    # textured objects, as in `both`: untextured ones leave the object
    # branch's gradients ill-conditioned
    tables_np = copy.deepcopy(setup["env"]["tables_np"])
    tables_np.obj_tex = (np.random.RandomState(5).rand(*tables_np.obj_tex.shape) * 2 - 1).astype(
        np.float32)
    tables = tables_np.as_torch("cpu")
    runs = []
    for cfg in (tcfg, dataclasses.replace(tcfg, corner_engine="pallas")):
        state, metrics = make_train_step(vgg, tables, mano_params, ccfg, cfg)(
            setup["fresh"](cfg), setup["batch"], True)
        runs.append((metrics, state))
    (m_shift, s_shift), (m_fused, s_fused) = runs
    assert sorted(m_fused) == sorted(m_shift)
    for k, ref in m_shift.items():
        np.testing.assert_allclose(float(m_fused[k]), float(ref), rtol=1e-4, atol=1e-5, err_msg=k)
    for net, rel_tree in (("g", 1e-2), ("d", 1e-6)):
        ref = {n: p.grad for n, p in getattr(s_shift, net).named_parameters()}
        tree_max = max(float(g.abs().max()) for g in ref.values())
        for n, p in getattr(s_fused, net).named_parameters():
            err = float((p.grad - ref[n]).abs().max())
            scale = float(ref[n].abs().max())
            msg = f"{net} {n}: {err} vs leaf max {scale}, tree max {tree_max}"
            assert err <= 2e-4 * scale + rel_tree * tree_max, msg
            assert err <= 0.15 * scale + 1e-6 * tree_max, msg


# ---------------------------------------------------------------- (e) remat


@pytest.mark.parametrize("rb,ra,engine", [(True, True, "shift"), (False, True, "shift"),
                                           (False, False, "shift"), (False, True, "pallas")],
                         ids=["True-True", "False-True", "False-False", "pallas-False-True"])
def test_remat_does_not_change_gradients(setup, rb, ra, engine, monkeypatch):
    """Rematerialization (all blocks / keeping the bottleneck / keeping the
    attention too) changes neither the state-dict keys nor the gradients;
    with the fused engine, the recompute of the attention layers runs the
    autograd Function FlowAttentionFused's forward again."""
    from hoig_torch.ops import attn_fused

    fwd_calls = []
    fwd = attn_fused.attn_fused_fwd
    monkeypatch.setattr(attn_fused, "attn_fused_fwd",
                        lambda *args: fwd_calls.append(1) or fwd(*args))
    vgg, tables, mano_params, ccfg, tcfg = setup["fn_args"]
    tcfg = dataclasses.replace(tcfg, corner_engine=engine)
    base = setup["fresh"](tcfg)
    cfg = TrainConfig(image_size=S, conv_dim=8, repeat_num=2, remat=True, remat_bottleneck=rb,
                      remat_attn=ra, corner_engine=engine)
    other = setup["fresh"](cfg)
    assert _same(_snapshot(other.g), _snapshot(base.g))
    ref = make_g_grads_fn(vgg, tables, mano_params, ccfg, tcfg)(base.g, base.d, setup["batch"])
    n_base = len(fwd_calls)
    out = make_g_grads_fn(vgg, tables, mano_params, ccfg, cfg)(other.g, other.d, setup["batch"])
    n_remat = len(fwd_calls) - n_base
    # each fused layer's forward runs twice under remat_attn: once more in the recompute
    assert (n_base > 0 and n_remat == 2 * n_base) if engine == "pallas" else n_remat == 0, (
        n_base, n_remat)
    assert ref.keys() == out.keys()
    for n in ref:
        # the recomputed forward repeats the first one's arithmetic
        np.testing.assert_allclose(out[n].numpy(), ref[n].numpy(), rtol=1e-6, atol=1e-9, err_msg=n)
