"""The rest of the modules off the main path, hoig_torch against hoig_tpu on
the CPU: block_extractor and local_attn_reshape (values and gradients),
uv_image (cvt_fim_enc, create_uvsampler, compute_uv_image), textured OBJ IO,
the residual blocks' learned shortcut (parameters mapped both ways), and
utils/profiling."""

import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoig_tpu.geometry import obj_io as jobj
from hoig_tpu.geometry import uv_image as juv
from hoig_tpu.models import layers as jlayers
from hoig_tpu.utils import profiling as jprof
from hoig_torch.geometry import obj_io as tobj
from hoig_torch.geometry import uv_image as tuv
from hoig_torch.models import convert
from hoig_torch.models import layers as tlayers
from hoig_torch.utils import profiling as tprof
from hoig_torch.utils.util import read_png

from test_torch_renderer_api import blob

# hoig_tpu.ops re-exports its function block_extractor over the module's name
jbe = importlib.import_module("hoig_tpu.ops.block_extractor")
tbe = importlib.import_module("hoig_torch.ops.block_extractor")

torch.set_num_threads(1)

T = torch.as_tensor


# ------------------------------------------------------------ block extractor


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_block_extractor_values_and_gradients_match_jax(layout):
    """Flows of up to +-3 px push samples past every border (clamped corners,
    unclamped weights). Values within 1e-6; gradients of a random weighting
    with respect to the source and the flow within 1e-5 of their largest
    entry (f32 sums in another order)."""
    rng = np.random.RandomState(0)
    b, c, h, w, k = 2, 5, 6, 7, 3
    src = rng.randn(b, c, h, w).astype(np.float32)
    flow = (rng.randn(b, 2, h, w) * 1.5).astype(np.float32)
    g = rng.randn(b, c, h * k, w * k).astype(np.float32)
    attn = rng.randn(b, k * k, h, w).astype(np.float32)
    if layout == "nhwc":
        src, flow, g, attn = (a.transpose(0, 2, 3, 1).copy() for a in (src, flow, g, attn))
        jfn, tfn = jbe.block_extractor_nhwc, tbe.block_extractor_nhwc
        jre, tre = jbe.local_attn_reshape_nhwc, tbe.local_attn_reshape_nhwc
    else:
        jfn, tfn = jbe.block_extractor, tbe.block_extractor
        jre, tre = jbe.local_attn_reshape, tbe.local_attn_reshape
    ref, pull = jax.vjp(lambda s_, f_: jfn(s_, f_, k), jnp.asarray(src), jnp.asarray(flow))
    g_src, g_flow = pull(jnp.asarray(g))
    ts, tf = T(src).requires_grad_(), T(flow).requires_grad_()
    out = tfn(ts, tf, k)
    (out * T(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    for got, want in ((ts.grad, g_src), (tf.grad, g_flow)):
        top = float(np.abs(np.asarray(want)).max())
        assert top > 0.1
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5 * top, rtol=0)
    np.testing.assert_array_equal(tre(T(attn), k).numpy(), np.asarray(jre(jnp.asarray(attn), k)))
    with pytest.raises(ValueError):
        tre(T(attn)[..., :4] if layout == "nhwc" else T(attn)[:, :4], k)


# ------------------------------------------------------------ uv_image


@pytest.fixture(scope="module")
def uv_obj(tmp_path_factory):
    from hoig_tpu.data.synthetic import write_synthetic_obj

    path = str(tmp_path_factory.mktemp("uv") / "obj.obj")
    write_synthetic_obj(path, n_verts=16, seed=2)
    return path


def test_cvt_fim_enc_and_uvsampler_match_jax(uv_obj):
    rng = np.random.RandomState(1)
    for name, ch in (("uv", 2), ("seg", 1), ("ids", 1), ("uv_seg", 3), ("par", 11),
                     ("binary", 15)):
        enc = rng.rand(6, 5, ch).astype(np.float32)
        if name == "binary":
            enc = (enc > 0.5).astype(np.float32)
        np.testing.assert_array_equal(tuv.cvt_fim_enc(enc, name), juv.cvt_fim_enc(enc, name))
    with pytest.raises(ValueError):
        tuv.cvt_fim_enc(rng.rand(2, 2, 1), "depth")
    for t in (2, 3):
        np.testing.assert_array_equal(tuv.create_uvsampler(uv_obj, t),
                                      juv.create_uvsampler(uv_obj, t))


def test_compute_uv_image_matches_optax(uv_obj):
    """30 Adam steps at uv_size 16 on the blob's per-face samplers: within
    1e-5 of the JAX fit (measured 1e-6: optax and torch apply Adam's bias
    corrections in another order), and the fit lowers the loss."""
    uv = tuv.create_uvsampler(uv_obj, 2).reshape(-1, 2, 2, 2)
    tex = np.random.RandomState(3).rand(uv.shape[0], 2, 2, 3).astype(np.float32) * 1.6 - 0.8
    ref = juv.compute_uv_image(uv, tex, uv_size=16, steps=30)
    out = tuv.compute_uv_image(uv, tex, uv_size=16, steps=30, device="cpu")
    assert out.shape == ref.shape == (3, 16, 16)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=0)

    def loss(img):
        from hoig_torch.ops.grid_sample import grid_sample

        s = grid_sample(T(img)[None], T(uv.reshape(1, -1, 4, 2)))
        return float(((s.reshape(3, -1, 2, 2).permute(1, 2, 3, 0) - T(tex)) ** 2).mean())

    # 30 steps of lr 1e-2 take the loss from 0.75 to 0.54
    assert loss(out) < 0.8 * loss(np.full_like(out, np.tanh(-1.0)))


# ------------------------------------------------------------ textured OBJ IO


def test_textured_obj_written_and_read_back_by_both_packages(tmp_path):
    """save_obj_textured in each package (the port's PNG by its stdlib
    encoder, JAX's by cv2): the same OBJ and MTL bytes and the same atlas
    pixels; load_obj_with_textures of either package on either file gives the
    same cubes; the cube sampler and atlas packer agree directly."""
    v, f = blob(16)
    tex = np.random.RandomState(4).rand(f.shape[0], 3, 3, 3, 3).astype(np.float32)
    tobj.save_obj_textured(str(tmp_path / "t.obj"), v, f, tex, texture_size_out=8)
    jobj.save_obj_textured(str(tmp_path / "j.obj"), v, f, tex, texture_size_out=8)
    t_obj = (tmp_path / "t.obj").read_text().replace("t.mtl", "X.mtl")
    assert t_obj == (tmp_path / "j.obj").read_text().replace("j.mtl", "X.mtl")
    assert (tmp_path / "t.mtl").read_text().replace("t.png", "X") == \
        (tmp_path / "j.mtl").read_text().replace("j.png", "X")
    np.testing.assert_array_equal(read_png(str(tmp_path / "t.png")),
                                  read_png(str(tmp_path / "j.png")))
    img, vts = tobj.create_texture_image(tex, 8)
    img_j, vts_j = jobj.create_texture_image(tex, 8)
    np.testing.assert_array_equal(img, img_j)
    np.testing.assert_array_equal(vts, vts_j)
    for name in ("t.obj", "j.obj"):
        info_t, cubes_t = tobj.load_obj_with_textures(str(tmp_path / name), 3)
        info_j, cubes_j = jobj.load_obj_with_textures(str(tmp_path / name), 3)
        np.testing.assert_array_equal(info_t["faces_vts"], info_j["faces_vts"])
        np.testing.assert_array_equal(cubes_t, cubes_j)
        assert cubes_t.shape == (f.shape[0], 3, 3, 3, 3) and cubes_t.std() > 0.05


def test_non_png_texture_needs_cv2(tmp_path, monkeypatch):
    """A JPEG texture goes through cv2 as in the JAX package; without cv2
    the port raises and names the file instead of returning white cubes."""
    import cv2

    v, f = blob(12)
    tobj.save_obj_textured(str(tmp_path / "m.obj"), v, f,
                           np.random.RandomState(5).rand(f.shape[0], 2, 2, 2, 3), 4)
    img = cv2.imread(str(tmp_path / "m.png"))
    cv2.imwrite(str(tmp_path / "m.jpg"), img)
    (tmp_path / "m.mtl").write_text("newmtl material_1\nmap_Kd m.jpg\n")
    info, cubes = tobj.load_obj_with_textures(str(tmp_path / "m.obj"), 2)
    np.testing.assert_array_equal(cubes, jobj.load_obj_with_textures(str(tmp_path / "m.obj"),
                                                                     2)[1])
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="m.jpg"):
        tobj.load_obj_with_textures(str(tmp_path / "m.obj"), 2)


# ------------------------------------------------------------ learned shortcut


@pytest.mark.parametrize("spade", [False, True])
def test_learned_shortcut_matches_flax(spade):
    """A residual block from 4 to 6 channels: flax parameters -> the port's
    state dict through convert's block map (norm_s, conv_s included) -> back
    to the same flax tree, and the outputs within 1e-5."""
    rng = np.random.RandomState(6 + spade)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    seg = rng.rand(2, 8, 8, 3).astype(np.float32)
    jm = jlayers.SPADEResidualBlock(features=6) if spade else jlayers.ResidualBlock(features=6)
    args = (jnp.asarray(x), jnp.asarray(seg)) if spade else (jnp.asarray(x),)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)

    def fill(path, leaf):
        base = 1.0 if str(path[-1].key) == "scale" else 0.0
        return (base + rng.randn(*leaf.shape) * 0.2).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    assert {"norm_s", "conv_s"} <= set(params["params"])
    with jax.default_matmul_precision("highest"):
        ref = jm.apply(params, *args)
    holder = torch.nn.Module()
    if spade:
        holder.blk = tlayers.SPADEResidualBlock(4, 3, torch.float32, dim_out=6)
        mapping = convert._spade_residual(("blk",), "blk", learned_shortcut=True)
    else:
        holder.blk = tlayers.ResidualBlock(4, torch.float32, dim_out=6)
        mapping = convert._residual(("blk",), "blk", learned_shortcut=True)
    holder.load_state_dict(convert._state_dict_from_flax({"blk": params["params"]}, mapping))
    back = convert.flax_tree_from_torch(holder.state_dict(), mapping)["blk"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(params["params"]):
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)
    nchw = lambda a: T(a).permute(0, 3, 1, 2)
    with torch.no_grad():
        out = holder.blk(nchw(x), nchw(seg)) if spade else holder.blk(nchw(x))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    # the identity shortcut stays parameter-free
    assert not hasattr(tlayers.ResidualBlock(4, torch.float32), "conv_s")


# ------------------------------------------------------------ profiling


def test_profiling_trace_annotate_and_step_timer(tmp_path):
    """trace writes a Chrome trace holding the annotated region;
    maybe_trace_steps traces its window only; StepTimer counts every step
    and leaves the first `skip_first` out of the mean, as the JAX timer."""
    a = torch.randn(64, 64)
    with tprof.trace(str(tmp_path / "t")) as prof:
        with tprof.annotate("hoig_region"):
            (a @ a).sum()
    files = os.listdir(tmp_path / "t")
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads((tmp_path / "t" / files[0]).read_text())["traceEvents"]
    assert any(e.get("name") == "hoig_region" for e in events)
    assert any(e.key == "hoig_region" for e in prof.key_averages())

    hook = tprof.maybe_trace_steps(True, str(tmp_path / "w"), start_step=2, num_steps=2)
    off = tprof.maybe_trace_steps(False, str(tmp_path / "off"), 0, 1)
    for step in range(6):
        hook(step)
        off(step)
        (a @ a).sum()
        if step < 4:
            assert not (tmp_path / "w").exists() or not os.listdir(tmp_path / "w")
    assert len(os.listdir(tmp_path / "w")) == 1 and not (tmp_path / "off").exists()

    timers = [tprof.StepTimer(skip_first=2), jprof.StepTimer(skip_first=2)]
    for timer in timers:
        for _ in range(5):
            with timer:
                (a @ a).sum()
        assert timer.count == 5 and timer.total > 0
        assert timer.mean_s == pytest.approx(timer.total / 3)
