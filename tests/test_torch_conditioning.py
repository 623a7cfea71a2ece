"""hoig_torch's conditioning front end against hoig_tpu on the CPU: MANO,
the surface tables and hand_recovery_flow, on the synthetic environment at
64 px, from the same numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoig_tpu.data import synthetic as jsyn
from hoig_tpu.geometry import conditioning as jcond
from hoig_tpu.geometry.mano import MANOModel as JaxMANOModel
from hoig_tpu.geometry.mano import mano_forward as jax_mano_forward
from hoig_tpu.geometry.mano import pca_to_axisang as jax_pca_to_axisang
from hoig_torch.data import synthetic as tsyn
from hoig_torch.geometry import conditioning as tcond
from hoig_torch.geometry.mano import MANOModel, mano_forward, pca_to_axisang

# parallel test workers each run torch's CPU kernels; one intra-op thread per
# worker keeps them from contending for the same cores
torch.set_num_threads(1)

S = 64
_TABLE_KEYS = ("faces", "face_valid", "num_faces", "map_fn", "sem", "fim_uv", "wim_uv",
               "faces_uv_coord", "obj_tex")
# fim-derived maps must agree exactly; the rest to float tolerance
_EXACT = ("src_crop_mask_bg", "tsf_crop_mask_bg", "src_crop_mask_hand", "tsf_crop_mask_hand",
          "input_G_src_bg")


@pytest.fixture(scope="module")
def envs():
    jtables, jmano, obj_verts = jsyn.synthetic_environment(2, S)
    tenv = tsyn.synthetic_environment(2, S, device="cpu")
    return jtables, jmano, obj_verts, tenv


@pytest.mark.parametrize("pca", [0, 45])
def test_mano_forward_matches_jax(envs, pca):
    _, jmano, _, tenv = envs
    rng = np.random.RandomState(pca)
    b = 3
    root = (rng.randn(b, 3) * 0.5).astype(np.float32)
    pose = (rng.randn(b, pca or 45) * 0.4).astype(np.float32)
    betas = rng.randn(b, 10).astype(np.float32)
    transl = rng.randn(b, 3).astype(np.float32)
    jp, tp = jmano.as_jax(), tenv["mano_params"]
    with jax.default_matmul_precision("highest"):
        jpose = jax_pca_to_axisang(jnp.asarray(pose), jp) if pca else jnp.asarray(pose)
        ref = jax_mano_forward(jp, jnp.asarray(root), jpose, jnp.asarray(betas),
                               transl=jnp.asarray(transl), flat_hand_mean=bool(pca))
    tpose = pca_to_axisang(torch.as_tensor(pose), tp) if pca else torch.as_tensor(pose)
    out = mano_forward(tp, torch.as_tensor(root), tpose, torch.as_tensor(betas),
                       transl=torch.as_tensor(transl), flat_hand_mean=bool(pca))
    for k in ("vertices", "joints"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-5, rtol=0)


def test_mano_from_pickle_matches_jax(tmp_path):
    """A MANO_RIGHT.pkl-layout pickle loads to the same arrays in both."""
    import pickle

    m = MANOModel.synthetic(3)
    kintree = np.stack([np.where(m.parents < 0, 2**32 - 1, m.parents), np.arange(16)])
    path = tmp_path / "MANO_RIGHT.pkl"
    with open(path, "wb") as fp:
        pickle.dump(dict(v_template=m.v_template, shapedirs=m.shapedirs, posedirs=m.posedirs,
                         J_regressor=m.j_regressor, weights=m.lbs_weights,
                         hands_components=m.hands_components, hands_mean=m.hands_mean,
                         f=m.faces, kintree_table=kintree), fp)
    ours, ref = MANOModel.from_pickle(str(path)), JaxMANOModel.from_pickle(str(path))
    for k in ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights", "parents",
              "hands_components", "hands_mean", "faces"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(ref, k), err_msg=k)
        assert getattr(ours, k).dtype == getattr(ref, k).dtype, k


def test_build_surface_tables_matches_jax(envs):
    jtables, _, _, tenv = envs
    ttables = tenv["tables_np"]
    for k in _TABLE_KEYS + ("num_verts",):
        a, b = getattr(jtables, k), getattr(ttables, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k == "wim_uv":
            # XLA:CPU contracts the jitted rasterizer's multiply-adds into
            # FMAs; the port rounds each product. On sub-pixel atlas faces
            # the inverse barycentric planes amplify that last-bit difference
            # (ROADMAP section C).
            np.testing.assert_allclose(b, a, atol=2e-4, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)
    assert ttables.object_names == jtables.object_names


def _flows(envs, cfg_kw, batch_fn):
    """Both packages' hand_recovery_flow on the same (JAX-built) tables."""
    jtables, jmano, obj_verts, tenv = envs
    imgs, theta_a, theta_b = batch_fn(obj_verts)
    jcfg = jcond.ConditioningConfig(image_size=S, **cfg_kw)
    tcfg = tcond.ConditioningConfig(image_size=S, **cfg_kw)
    jd = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    td = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(jcond.hand_recovery_flow, static_argnames="cfg")(
            jtables.as_jax(), jmano.as_jax(), jnp.asarray(imgs[0]), jnp.asarray(imgs[1]),
            jd(theta_a), jd(theta_b), cfg=jcfg)
    tables = {k: torch.as_tensor(getattr(jtables, k)) for k in _TABLE_KEYS}
    out = tcond.hand_recovery_flow(tables, tenv["mano_params"], torch.as_tensor(imgs[0]),
                                   torch.as_tensor(imgs[1]), td(theta_a), td(theta_b), tcfg)
    return ref, out


def _assert_flow_close(ref, out, max_z_fight_share=0.0):
    """fim-derived maps exact; the rest within atol 1e-4, except on at most
    `max_z_fight_share` of the elements: pixels where two nearly coplanar
    faces' inverse depths differ by a few ulps and XLA:CPU's FMA-contracted
    planes pick the other face (ROADMAP section C)."""
    assert ref.keys() == out.keys()
    for k, v in ref.items():
        if v is None:
            assert out[k] is None, k
            continue
        assert tuple(out[k].shape) == v.shape, k
        a, b = out[k].numpy(), np.asarray(v)
        if k in _EXACT:
            np.testing.assert_array_equal(a, b, err_msg=k)
        elif max_z_fight_share:
            assert np.mean(np.abs(a - b) > 1e-4) <= max_z_fight_share, k
        else:
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=k)


def test_hand_recovery_flow_matches_jax(envs):
    def batch(obj_verts):
        bt = jsyn.synthetic_batch(2, obj_verts, image_size=S)
        return (bt["imageA"], bt["imageB"]), bt["manoA"], bt["manoB"]

    ref, out = _flows(envs, {}, batch)
    _assert_flow_close(ref, out)
    assert (out["tsf_crop_mask_hand"] == 0).sum() > 50  # the hand is in view
    assert (out["T"] > -2).any()


def test_hand_recovery_flow_dexycb_variant_matches_jax(envs):
    """fx/fy camera, PCA-45 MANO, translation folded into the pose, hand
    segmentation channels appended (tests/test_conditioning.py:178)."""
    def batch(obj_verts):
        ta = jsyn.synthetic_theta(2, obj_verts, seed=5, camera="fxfy", image_size=S)
        tb = jsyn.synthetic_theta(2, obj_verts, seed=6, camera="fxfy", image_size=S)
        for t in (ta, tb):
            t["pose"] = np.concatenate([t["pose"], t.pop("handtrans")], axis=1)
        img = (np.random.RandomState(0).rand(2, 3, S, S) * 2 - 1).astype(np.float32)
        return (img, img), ta, tb

    ref, out = _flows(envs, dict(camera_model="fxfy", mano_pca_comps=45), batch)
    # 2 of the 4 x 64^2 rasterized pixels are such z-fights here
    _assert_flow_close(ref, out, max_z_fight_share=1e-3)
    assert tuple(out["input_G_src_hand"].shape) == (2, 12, S, S)
