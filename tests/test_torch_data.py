"""The port's data pipeline and option layer against hoig_tpu on the CPU: the
options, train_config_from_opt, the native runtime, the datasets and the
loader on the fabricated HOv3 and DexYCB trees and on the synthetic mode,
build_environment with a textured object, .npz weights and the PNG
encoder."""

import dataclasses
import io
import os
import pickle

import numpy as np
import pytest
import torch

from hoig_tpu import runtime as jruntime
from hoig_tpu.data import loader as jloader
from hoig_tpu.data.dataset_base import gen_trans_from_patch_cv
from hoig_tpu.options import TestOptions as JaxTestOptions
from hoig_tpu.options import TrainOptions as JaxTrainOptions
from hoig_tpu.train import environment as jenv
from hoig_torch import runtime
from hoig_torch.data import loader
from hoig_torch.options.test_options import TestOptions as TorchTestOptions
from hoig_torch.options.train_options import TrainOptions
from hoig_torch.train import environment as tenv

# the fabricated trees of the JAX package's own dataset tests (cv2 writes them)
from test_real_datasets import env64, hov3_tree, ycb_tree  # noqa: F401  (hov3_tree needs env64)

# parallel test workers each run torch's CPU kernels; one intra-op thread per
# worker keeps them from contending for the same cores
torch.set_num_threads(1)


def _parse(cls, args, tmp_path, name="t"):
    return cls().parse(list(args) + ["--checkpoints_dir", str(tmp_path), "--name", name])


def _both(args, tmp_path, train=True):
    """The same argv through both packages' options: (JAX opt, port opt)."""
    jcls, tcls = (JaxTrainOptions, TrainOptions) if train else (JaxTestOptions, TorchTestOptions)
    return _parse(jcls, args, tmp_path / "j"), _parse(tcls, list(args) + ["--device", "cpu"],
                                                      tmp_path / "t")


_ARGVS = {
    "defaults": [],
    "synthetic": ["--dataset_mode", "synthetic", "--image_size", "64", "--batch_size", "2",
                  "--conv_dim", "8", "--repeat_num", "2", "--no_remat", "--use_spade",
                  "--use_vgg", "--mask_bce", "--synthetic_size", "6", "--lambda_rec", "5.0",
                  "--num_data_devices", "1", "--eval_pairs", "x.pkl"],
    "ycb": ["--dataset_mode", "ycb", "--bf16", "--corner_engine", "pallas", "--load_epoch",
            "-1", "--serial_batches", "--output_dir", "o", "--uv_mapping", "u.obj"],
}


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("argv", sorted(_ARGVS))
def test_options_match_jax(argv, train, tmp_path):
    jopt, topt = _both(_ARGVS[argv], tmp_path, train)
    j, t = vars(jopt), vars(topt)
    j.pop("platform"), t.pop("device")
    for opt in (j, t):
        opt.pop("checkpoints_dir")
    assert t == j
    name = "opt_train.txt" if train else "opt_test.txt"
    assert (tmp_path / "t" / "t" / name).exists()


def test_options_device_and_data_devices(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            _parse(TrainOptions, [], tmp_path)
    with pytest.raises(ValueError, match="num_data_devices"):
        _parse(TrainOptions, ["--device", "cpu", "--num_data_devices", "2"], tmp_path)


def _config_fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    out["compute_dtype"] = str(out["compute_dtype"]).split(".")[-1].split("'")[0]
    return out


@pytest.mark.parametrize("mode", ["hov3", "ycb", "synthetic"])
def test_train_config_from_opt_matches_jax(mode, tmp_path):
    for bf16 in ([], ["--bf16"]):
        for engine in ("auto", "gather", "shift", "pallas"):
            for extra in ([], ["--remat_bottleneck", "--no_remat"]):
                args = ["--dataset_mode", mode, "--corner_engine", engine, *bf16, *extra]
                if mode == "synthetic":
                    args += ["--use_spade", "--use_vgg", "--mask_bce", "--conv_dim", "16"]
                jopt, topt = _both(args, tmp_path)
                j = _config_fields(jenv.train_config_from_opt(jopt))
                t = _config_fields(tenv.train_config_from_opt(topt))
                assert t == j, args


def test_runtime_matches_jax():
    rng = np.random.RandomState(0)
    src = rng.randint(0, 256, (480, 640, 3)).astype(np.uint8)
    for k, shape in enumerate([(64, 64), (256, 256), (40, 56)]):
        trans = gen_trans_from_patch_cv(300.0 + 17 * k, 250.0 - 9 * k, 220.0 + k, 180.0, shape[1],
                                        shape[0], 1.0, 15.0 * k)
        np.testing.assert_array_equal(runtime.warp_affine(src, trans, shape),
                                      jruntime.warp_affine(src, trans, shape))
        np.testing.assert_array_equal(runtime.warp_affine(src[..., 0], trans, shape),
                                      jruntime.warp_affine(src[..., :1], trans, shape)[..., 0])
    patch = (rng.rand(64, 48, 3) * 255).astype(np.float32)
    for kw in ({}, dict(swap_rb=False, scale=1.0, offset=0.0)):
        np.testing.assert_array_equal(runtime.normalize_chw(patch, **kw),
                                      jruntime.normalize_chw(patch, **kw))


def _assert_tree_equal(a, b, path=""):
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def test_synthetic_dataset_matches_jax(tmp_path):
    from hoig_tpu.data.synthetic_dataset import SyntheticDataset as JaxSynthetic
    from hoig_torch.data.synthetic_dataset import SyntheticDataset

    jopt, topt = _both(["--dataset_mode", "synthetic", "--image_size", "16",
                        "--synthetic_size", "5"], tmp_path)
    jds, tds = JaxSynthetic(jopt), SyntheticDataset(topt)
    assert len(tds) == len(jds) == 5
    for i in (0, 3):
        _assert_tree_equal(jds[i], tds[i])
    # the host-side environment is built once per configuration
    assert tds.environment("cpu")["tables_np"] is SyntheticDataset(topt).environment(
        "cpu")["tables_np"]


def _dataset_pair(mode, tree, tmp_path, train, pairs=None):
    from hoig_tpu.data.hov3_dataset import HOv3Dataset as JaxHOv3
    from hoig_tpu.data.ycb_dataset import YCBDataset as JaxYCB
    from hoig_torch.data.hov3_dataset import HOv3Dataset
    from hoig_torch.data.ycb_dataset import YCBDataset

    args = ["--dataset_mode", mode, "--data_dir", tree["data_dir"], "--params_dir", "params",
            "--images_dir", "images", "--image_size", "64", "--num_repeats", "2",
            "--batch_size", "2", "--num_data_devices", "1"]
    if "obj_dir" in tree:
        args += ["--obj_dir", tree["obj_dir"]]
    if pairs is not None:
        args += ["--pairs_dir", pairs]
    jopt, topt = _both(args, tmp_path, train)
    jcls, tcls = (JaxHOv3, HOv3Dataset) if mode == "hov3" else (JaxYCB, YCBDataset)
    return jcls(jopt, is_for_train=train), tcls(topt, is_for_train=train)


@pytest.mark.parametrize("mode", ["hov3", "ycb"])
def test_real_datasets_and_loader_match_jax(mode, request, tmp_path):
    tree = request.getfixturevalue(f"{mode}_tree")
    jds, tds = _dataset_pair(mode, tree, tmp_path, train=True)
    assert len(tds) == len(jds) == 4
    jds.set_seed(3)
    tds.set_seed(3)
    for i in (0, 1):
        _assert_tree_equal(jds[i], tds[i])
    # loader batches: the same permutation per epoch, the same collation
    jds.set_seed(5)
    tds.set_seed(5)
    jdl = jloader.DataLoader(jds, batch_size=2, shuffle=True, num_threads=1)
    tdl = loader.DataLoader(tds, batch_size=2, shuffle=True, num_threads=1)
    for epoch in (1, 2):
        jdl.set_epoch(epoch)
        tdl.set_epoch(epoch)
        jb, tb = list(jdl), list(tdl)
        assert len(tb) == len(jb) == 2
        for a, b in zip(jb, tb):
            _assert_tree_equal(a, b)

    # the eval branch: a pickled pair list (nested DexYCB names, int frames)
    if mode == "hov3":
        pairs = [("ABF10_0/0000.jpg", "GPMF11_0/0001.jpg")]
    else:
        va = "20200709-subject-01/20200709_141754/932122060861"
        vb = "20200813-subject-02/20200813_145653/932122060861"
        pairs = [(f"{va}/0", f"{vb}/2")]
    path = str(tmp_path / "pairs.pkl")
    with open(path, "wb") as fp:
        pickle.dump(pairs, fp)
    jds, tds = _dataset_pair(mode, tree, tmp_path, train=False, pairs=path)
    assert len(tds) == len(jds) == 2
    _assert_tree_equal(jds[1], tds[1])
    assert tds[1]["nameA"] == pairs[0][0]


def test_loader_order_sharding_and_errors():
    """The sampler's permutation and shards and the loader's partial last
    batch are the JAX package's; an error in a sample reaches the caller."""
    for kw in (dict(shuffle=True, seed=4), dict(shuffle=False), dict(num_shards=3,
                                                                     shard_index=1)):
        s, js = loader.ShardedSampler(10, **kw), jloader.ShardedSampler(10, **kw)
        s.set_epoch(2), js.set_epoch(2)
        np.testing.assert_array_equal(s.indices(), js.indices())

    class Items:
        def __len__(self):
            return 5

        def __getitem__(self, i):
            if i == 4:
                raise KeyError("sample 4 is broken")
            return {"x": np.full((2,), i, np.float32), "name": str(i)}

    dl = loader.DataLoader(Items(), batch_size=2, shuffle=False, drop_last=True, prefetch=1)
    batches = list(dl)
    assert len(batches) == 2 and batches[1]["name"] == ["2", "3"]
    np.testing.assert_array_equal(batches[0]["x"], [[0, 0], [1, 1]])
    with pytest.raises(KeyError, match="broken"):
        list(loader.DataLoader(Items(), batch_size=2, shuffle=False, drop_last=False))
    it = iter(loader.DataLoader(Items(), batch_size=1, shuffle=False, prefetch=1))
    next(it)
    it.close()  # a consumer that stops early stops the producer


def _real_asset_tree(root):
    """A real-data asset layout: MANO pickle, hand UV atlas, semantics, two
    objects, the second with a texture."""
    import cv2

    from hoig_tpu.data.synthetic import synthetic_semantics, write_hand_uv_obj
    from hoig_tpu.data.synthetic import write_synthetic_obj
    from hoig_tpu.geometry.mano import MANOModel as JaxMANOModel

    m = JaxMANOModel.synthetic(0)
    kintree = np.stack([np.where(m.parents < 0, 2**32 - 1, m.parents), np.arange(16)])
    os.makedirs(root / "mano")
    with open(root / "mano" / "MANO_RIGHT.pkl", "wb") as fp:
        pickle.dump(dict(v_template=m.v_template, shapedirs=m.shapedirs, posedirs=m.posedirs,
                         J_regressor=m.j_regressor, weights=m.lbs_weights,
                         hands_components=m.hands_components, hands_mean=m.hands_mean,
                         f=m.faces, kintree_table=kintree), fp)
    write_hand_uv_obj(str(root / "hand_uv.obj"), m)
    with open(root / "sem.pkl", "wb") as fp:
        pickle.dump(synthetic_semantics(), fp)
    for i, name in enumerate(["003_cracker_box", "004_sugar_box"]):
        os.makedirs(root / "obj" / name)
        write_synthetic_obj(str(root / "obj" / name / f"{name}.obj"), seed=i)
    tex = np.random.RandomState(2).randint(0, 256, (48, 40, 3)).astype(np.uint8)
    cv2.imwrite(str(root / "obj" / "004_sugar_box" / "texture_map.png"), tex)
    os.makedirs(root / "data")
    return ["--dataset_mode", "hov3", "--mano_model", str(root / "mano"), "--uv_mapping",
            str(root / "hand_uv.obj"), "--sem_hand", str(root / "sem.pkl"), "--obj_dir",
            str(root / "obj"), "--data_dir", str(root / "data"), "--image_size", "32"]


def test_build_environment_textured_object_matches_jax(tmp_path):
    args = _real_asset_tree(tmp_path)
    jopt, topt = _both(args, tmp_path)
    j, t = jenv.build_environment(jopt), tenv.build_environment(topt, device="cpu")
    assert t["tables_np"].object_names == j["tables_np"].object_names
    for k in ("faces", "face_valid", "num_faces", "num_verts", "map_fn", "sem", "fim_uv",
              "faces_uv_coord", "obj_tex", "wim_uv"):
        a, b = getattr(j["tables_np"], k), getattr(t["tables_np"], k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k == "wim_uv":
            # XLA:CPU's FMA contractions in the jitted atlas rasterizer
            # (tests/test_torch_conditioning.py)
            np.testing.assert_allclose(b, a, atol=2e-4, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)
    tex = t["tables_np"].obj_tex
    assert not tex[0].any() and tex[1].std() > 0.1  # the untextured and the textured object
    assert t["ccfg"] == tenv.conditioning_config(topt) and not t["is_ycb"]
    for k, v in j["mano"].__dict__.items():
        np.testing.assert_array_equal(getattr(t["mano"], k), v, err_msg=k)
    # real-data training with the VGG loss refuses random VGG features
    from hoig_torch.train.model_api import HOIGModel

    topt = _parse(TrainOptions, args + ["--device", "cpu", "--use_vgg", "--conv_dim", "8",
                                        "--repeat_num", "2"], tmp_path / "v")
    with pytest.raises(RuntimeError, match="--vgg_weights"):
        HOIGModel(topt, env=t)


def test_npz_weights_load(tmp_path):
    from hoig_torch.models.vgg import init_vgg
    from hoig_torch.train.checkpoints import load_generator_params
    from hoig_torch.train.model_api import load_vgg_weights
    from hoig_torch.train.trainer import TrainConfig, build_generator

    tcfg = TrainConfig(conv_dim=8, repeat_num=2)
    src, dst = build_generator(tcfg, "cpu", seed=1), build_generator(tcfg, "cpu", seed=2)
    module_keys = {f"module.{k}": v.numpy() for k, v in src.state_dict().items()}
    np.savez(tmp_path / "g.npz", **module_keys)
    load_generator_params(dst, str(tmp_path / "g.npz"))
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k

    vgg, other = init_vgg(seed=1, device="cpu"), init_vgg(seed=2, device="cpu")
    # a torchvision vgg19 dump holds all 16 convolutions and the classifier
    state = {k: v.numpy() for k, v in vgg.state_dict().items()}
    state.update({"features.34.weight": np.zeros((512, 512, 3, 3), np.float32),
                  "classifier.0.bias": np.zeros((4096,), np.float32)})
    np.savez(tmp_path / "vgg.npz", **state)
    load_vgg_weights(other, str(tmp_path / "vgg.npz"))
    for k, v in vgg.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    del state["features.28.bias"]
    np.savez(tmp_path / "short.npz", **state)
    with pytest.raises(KeyError, match="features.28.bias"):
        load_vgg_weights(other, str(tmp_path / "short.npz"))


@pytest.mark.parametrize("shape", [(1, 1, 3), (5, 7, 3), (64, 48, 3)])
def test_png_encoder_roundtrip(shape):
    from PIL import Image

    from hoig_torch.utils.util import encode_png

    img = np.random.RandomState(shape[0]).randint(0, 256, shape).astype(np.uint8)
    back = Image.open(io.BytesIO(encode_png(img)))
    assert back.mode == "RGB" and back.size == (shape[1], shape[0])
    np.testing.assert_array_equal(np.asarray(back), img)
    with pytest.raises(ValueError):
        encode_png(img.astype(np.float32))
