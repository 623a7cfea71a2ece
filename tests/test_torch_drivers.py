"""The port's model facade and its drivers on the CPU: HOIGModel against the
functions it wraps (flow_only + forward_only, make_train_step, decay_lr,
the checkpoints), train_torch.Train and eval_torch.main, and the whole
eval slice against the JAX package's eval.py."""

import json
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import eval_torch
import train_torch
from hoig_torch.data.synthetic import synthetic_environment
from hoig_torch.geometry.conditioning import ConditioningConfig
from hoig_torch.geometry.mano import MANOModel
from hoig_torch.geometry.renderer import SurfaceTables
from hoig_torch.models.convert import generator_state_dict_from_flax
from hoig_torch.models.vgg import init_vgg
from hoig_torch.options.test_options import TestOptions as TorchTestOptions
from hoig_torch.options.train_options import TrainOptions
from hoig_torch.train import model_api
from hoig_torch.train.environment import train_config_from_opt
from hoig_torch.train.trainer import build_networks, decay_lr, init_state, make_train_step

# the fabricated DexYCB tree of the JAX package's own dataset tests
from test_real_datasets import ycb_tree  # noqa: F401

# parallel test workers each run torch's CPU kernels; one intra-op thread per
# worker keeps them from contending for the same cores
torch.set_num_threads(1)

# 64 px: the PatchGAN-4 discriminator needs it; batch 1 keeps a CPU step near 1.5 s
S, B = 64, 1
_SMALL = ["--dataset_mode", "synthetic", "--image_size", str(S), "--batch_size", str(B),
          "--conv_dim", "8", "--repeat_num", "2", "--no_remat", "--use_spade", "--use_vgg",
          "--mask_bce", "--synthetic_size", "2", "--device", "cpu", "--name", "t"]


def _opt(tmp_path, extra=(), train=True):
    cls = TrainOptions if train else TorchTestOptions
    return cls().parse(_SMALL + ["--checkpoints_dir", str(tmp_path)] + list(extra))


def _batch(seed=0):
    from hoig_torch.data.synthetic import synthetic_batch

    env = synthetic_environment(2, S, device="cpu")
    return synthetic_batch(B, env["obj_verts"], image_size=S, seed=seed)


def _params(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_facade_matches_the_functions_it_wraps(tmp_path):
    """HOIGModel against flow_only + forward_only, make_train_step, the
    checkpoints (save, auto-resume, eval load) and decay_lr; one model and
    one environment for all of it (each CPU model costs seconds)."""
    opt = _opt(tmp_path, ["--nepochs_decay", "4"])
    model = model_api.ModelsFactory.get_by_name("trainer", opt)
    tcfg = train_config_from_opt(opt)
    batch = _batch()
    tb = model_api.batch_as_torch(batch, "cpu")

    # forward without losses is flow_only + forward_only
    model.set_input(dict(batch, nameA=["a"]))
    fakes = model.forward(keep_data_for_visuals=True, compute_losses=False)
    ref = model_api.forward_only(model._state.g, model_api.flow_only(tb, model._frozen,
                                                                    model._ccfg), tb, tcfg)
    for a, b in zip(fakes, ref):
        assert torch.equal(a, b)
    vis = model.get_current_visuals()
    assert vis["15_batch_fake_img"].shape == (S, S, 3) and vis["1_real_img"].dtype == np.uint8
    # with the eval losses: the same fakes, and one float per error key
    with_losses = model.forward(compute_losses=True)
    torch.testing.assert_close(with_losses[1], fakes[1].float(), rtol=0, atol=1e-6)
    errors = model.get_current_errors()
    assert list(errors) == list(model_api._ERROR_KEYS)
    assert all(isinstance(v, float) and np.isfinite(v) for v in errors.values())
    assert errors["g_rec"] == float(model._errors["g_rec"])

    # optimize_parameters is make_train_step on the same weights
    state = init_state(*build_networks(tcfg, device="cpu", seed=model_api.SEED), tcfg)
    vgg = init_vgg(seed=model_api.SEED + 2, device="cpu")
    step = make_train_step(vgg, model._frozen["tables"], model._frozen["mano_params"],
                           model._ccfg, tcfg)
    _assert_same(_params(model._state.g), _params(state.g))
    model.optimize_parameters(trainable=True)
    state, metrics = step(state, tb, True)
    for k, v in model.get_current_errors().items():
        assert v == float(metrics[k]), k
    _assert_same(_params(model._state.g), _params(state.g))
    _assert_same(_params(model._state.d), _params(state.d))
    assert model._state.step == state.step == 1

    # save; the auto-resume scan finds the epoch and restores G, D, both
    # Adams and the schedule; an eval model loads G only
    model.save(3)
    resumed = model_api.ModelsFactory.get_by_name("trainer", _opt(tmp_path, ["--nepochs_decay",
                                                                            "4"]))
    assert resumed._opt.load_epoch == 3 and resumed._state.step == 1
    _assert_same(_params(resumed._state.g), _params(model._state.g))
    _assert_same(_params(resumed._state.d), _params(model._state.d))
    for a, b in ((resumed._state.opt_g, model._state.opt_g), (resumed._state.opt_d,
                                                                model._state.opt_d)):
        for sa, sb in zip(a.state.values(), b.state.values()):
            for k in sb:
                assert torch.equal(torch.as_tensor(sa[k]), torch.as_tensor(sb[k])), k
    evaluated = model_api.ModelsFactory.get_by_name(
        "trainer", _opt(tmp_path, ["--load_epoch", "3"], train=False))
    _assert_same(_params(evaluated._state.g), _params(model._state.g))
    assert evaluated._state.step == 0

    # update_learning_rate is decay_lr, in the state and in both optimizers
    for _ in range(2):
        model.update_learning_rate()
        decay_lr(state, tcfg)
        assert (model._state.lr_g, model._state.lr_d) == (state.lr_g, state.lr_d)
        assert model.get_current_scalars() == {"lr_G": state.lr_g, "lr_D": state.lr_d}
        for group in model._state.opt_g.param_groups + model._state.opt_d.param_groups:
            assert group["lr"] == state.lr_g

    # `trainable` reaches the step as the host bool d_trainable; no update
    # outside training
    seen = []
    model._train_step = lambda st, b, d_trainable: (seen.append(d_trainable), (st, {}))[1]
    model.optimize_parameters(trainable=0)
    model.set_eval()
    model.optimize_parameters()
    assert seen == [False]


def test_train_driver_two_steps(tmp_path, monkeypatch):
    # the card's machine has no tensorboard: the visualizer keeps its text
    # log and summary.json only
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    steps = []
    orig = model_api.HOIGModel.optimize_parameters

    def counted(self, *a, **k):
        steps.append(k.get("trainable"))
        return orig(self, *a, **k)

    model_api.HOIGModel.optimize_parameters = counted
    try:
        run = train_torch.Train(_SMALL + ["--checkpoints_dir", str(tmp_path), "--nepochs_no_decay",
                                          "1", "--nepochs_decay", "0", "--n_threads_train", "1"])
    finally:
        model_api.HOIGModel.optimize_parameters = orig
    assert steps == [True, True] and run.model._state.step == 2
    files = set(os.listdir(tmp_path / "t"))
    assert {f"{k}_epoch_1_id_{n}.pth" for k in ("net", "opt") for n in "GD"} <= files
    log = (tmp_path / "t" / "loss_log2.txt").read_text()
    assert "(Tv, epoch: 1, it: 0/2.0" in log and "(V, epoch: 1" in log
    assert not any(f.startswith("events.out") for f in files)
    summary = json.loads((tmp_path / "t" / "summary.json").read_text())
    assert {"Train/g_rec", "Train/lr_G", "Test/g_rec"} <= set(summary)


def _torch_env(jtables, ccfg) -> dict:
    """The port's environment on the JAX-built tables (tests/test_torch_slice.py)."""
    fields = {k: getattr(jtables, k) for k in SurfaceTables.__dataclass_fields__}
    tables_np = SurfaceTables(**fields)
    mano = MANOModel.synthetic(0)
    return dict(tables_np=tables_np, tables=tables_np.as_torch("cpu"), mano=mano,
                mano_params=mano.as_torch("cpu"), ccfg=ccfg, is_ycb=ccfg.camera_model == "fxfy")


def test_eval_driver_on_ycb_tree(ycb_tree, tmp_path, monkeypatch):  # noqa: F811
    """Nested DexYCB names through the untiling and the stems of eval.py
    (tests/test_real_datasets.py::test_ycb_eval_entry_to_pngs)."""
    va = "20200709-subject-01/20200709_141754/932122060861"
    vb = "20200813-subject-02/20200813_145653/932122060861"
    pairs = [(f"{va}/0", f"{vb}/2"), (f"{vb}/1", f"{va}/3"), (f"{va}/2", f"{vb}/0")]
    run_dir = tmp_path / "run"
    (run_dir / "assets").mkdir(parents=True)
    with open(run_dir / "assets" / "eval_pairs.pkl", "wb") as fp:
        pickle.dump(pairs, fp)
    monkeypatch.chdir(run_dir)
    ccfg = ConditioningConfig(image_size=S, camera_model="fxfy", mano_pca_comps=45,
                              mano_flat_hand_mean=False)
    out_dir = tmp_path / "out"
    eval_torch.main([
        "--dataset_mode", "ycb", "--data_dir", ycb_tree["data_dir"], "--params_dir", "params",
        "--images_dir", "images", "--image_size", str(S), "--batch_size", "2", "--num_repeats",
        "1", "--conv_dim", "8", "--repeat_num", "2", "--no_remat", "--use_spade", "--device",
        "cpu", "--checkpoints_dir", str(tmp_path / "ck"), "--name", "t", "--output_dir",
        str(out_dir)], env=dict(synthetic_environment(2, S, device="cpu"), ccfg=ccfg, is_ycb=True))
    stems = set()
    for src, tsf in pairs:
        sp, tp = src.split("/"), tsf.split("/")
        stems.add(f"{'_'.join(sp[:-1])}_{sp[-1]}_{tp[-1]}.png")
    for sub in ("source", "imitators", "gt"):
        assert set(os.listdir(out_dir / sub)) == stems, sub
    with Image.open(out_dir / "imitators" / f"{'_'.join(va.split('/'))}_0_2.png") as im:
        assert im.size == (S, S) and im.mode == "RGB"


def test_drivers_refuse_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    args = ["--dataset_mode", "synthetic", "--checkpoints_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA"):
        train_torch.Train(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_torch.main(args)


def test_eval_slice_matches_jax(tmp_path, monkeypatch):
    """eval.py and eval_torch.py on the synthetic dataset at 32 px: the JAX
    model's random G carried to the port through --load_path, the JAX-built
    tables on both sides; fakes within 1e-4, PNGs within one level."""
    import eval as jax_eval
    from hoig_tpu.data import synthetic as jsyn
    from hoig_tpu.geometry.conditioning import ConditioningConfig as JaxConditioningConfig
    from hoig_tpu.train import model_api as japi

    s = 32
    jtables, jmano, _ = jsyn.synthetic_environment(2, s)
    jenv = dict(tables_np=jtables, tables=jtables.as_jax(), mano=jmano,
                mano_params=jmano.as_jax(), ccfg=JaxConditioningConfig(image_size=s),
                is_ycb=False)
    args = ["--dataset_mode", "synthetic", "--image_size", str(s), "--batch_size", "2",
            "--conv_dim", "8", "--repeat_num", "2", "--use_spade", "--synthetic_size", "2",
            "--corner_engine", "shift", "--name", "t"]
    seen = {}

    def recorder(cls, tag):
        orig = cls.forward

        def forward(self, *a, **k):
            out = orig(self, *a, **k)
            seen[tag] = (self, [np.asarray(o) for o in out])
            return out
        monkeypatch.setattr(cls, "forward", forward)

    recorder(japi.HOIGModel, "jax")
    recorder(model_api.HOIGModel, "torch")
    with jax.default_matmul_precision("highest"):
        jax_eval.main(args + ["--platform", "cpu", "--checkpoints_dir", str(tmp_path / "jck"),
                              "--output_dir", str(tmp_path / "jout")], env=jenv)
    jmodel, jfakes = seen["jax"]
    g_path = tmp_path / "g.pth"
    torch.save(generator_state_dict_from_flax(jax.tree.map(np.asarray, jmodel._state.params_g),
                                              jmodel._tcfg), g_path)
    eval_torch.main(args + ["--device", "cpu", "--checkpoints_dir", str(tmp_path / "tck"),
                            "--output_dir", str(tmp_path / "tout"), "--load_path", str(g_path)],
                    env=_torch_env(jtables, ConditioningConfig(image_size=s)))
    tfakes = seen["torch"][1]
    for a, b in zip(tfakes, jfakes):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    stems = sorted(os.listdir(tmp_path / "jout" / "imitators"))
    assert len(stems) == 2
    for sub in ("source", "imitators", "gt"):
        assert sorted(os.listdir(tmp_path / "tout" / sub)) == stems
        for stem in stems:
            with Image.open(tmp_path / "jout" / sub / stem) as a, \
                    Image.open(tmp_path / "tout" / sub / stem) as b:
                diff = np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16))
            assert diff.max() <= 1, (sub, stem)
