"""JAX checkpoints in the port: hoig_torch/train/flax_ckpt.py reads what
flax writes, and hoig_torch/train/checkpoints.py maps it into G and D.

The JAX package's eval.py runs once at 32 px (random weights) and its model
saves epoch 1 through hoig_tpu.train.checkpoints (flax msgpack `.ckpt`);
the port then loads that epoch bit-equal to `*_state_dict_from_flax` of the
same parameters and evaluates it, through --load_path and through
--load_epoch, to eval.py's fakes. A later JAX epoch, whose optax Adam state
has taken steps (D fewer of them, as a gated D does), resumes training in the
port by each route, and the step after the resume matches optax's.
"""

import functools
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import eval_torch
from hoig_torch.models.convert import (
    discriminator_state_dict_from_flax,
    generator_state_dict_from_flax,
)
from hoig_torch.options.train_options import TrainOptions
from hoig_torch.train import checkpoints as ckpt
from hoig_torch.train import model_api
from hoig_torch.train.environment import train_config_from_opt
from hoig_torch.train.flax_ckpt import msgpack_restore, numpy_tree, read_flax_checkpoint
from hoig_torch.train.trainer import build_networks, init_state

torch.set_num_threads(1)

S = 32
ARGS = ["--dataset_mode", "synthetic", "--image_size", str(S), "--batch_size", "2",
        "--conv_dim", "8", "--repeat_num", "2", "--use_spade", "--synthetic_size", "2",
        "--corner_engine", "shift", "--name", "t"]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """eval.py at 32 px on the synthetic dataset (its fakes kept), then its
    model's state saved as epoch 1 of a JAX run directory."""
    import eval as jax_eval
    from hoig_tpu.data import synthetic as jsyn
    from hoig_tpu.geometry.conditioning import ConditioningConfig as JaxConditioningConfig
    from hoig_tpu.train import model_api as japi

    from test_torch_drivers import _torch_env

    tmp = tmp_path_factory.mktemp("jax_run")
    jtables, jmano, _ = jsyn.synthetic_environment(2, S)
    jenv = dict(tables_np=jtables, tables=jtables.as_jax(), mano=jmano,
                mano_params=jmano.as_jax(), ccfg=JaxConditioningConfig(image_size=S),
                is_ycb=False)
    seen = {}
    orig = japi.HOIGModel.forward

    def forward(self, *a, **k):
        out = orig(self, *a, **k)
        seen["model"], seen["fakes"] = self, [np.asarray(o) for o in out]
        return out

    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"):
        mp.setattr(japi.HOIGModel, "forward", forward)
        jax_eval.main(ARGS + ["--platform", "cpu", "--checkpoints_dir", str(tmp / "jck"),
                              "--output_dir", str(tmp / "jout")], env=jenv)
    jmodel = seen["model"]
    jmodel.save(1)  # hoig_tpu.train.checkpoints.save_checkpoint: net/opt x G/D .ckpt
    from hoig_torch.geometry.conditioning import ConditioningConfig

    return dict(dir=tmp / "jck" / "t", tmp=tmp, fakes=seen["fakes"],
                params_g=jax.tree.map(np.asarray, jmodel._state.params_g),
                params_d=jax.tree.map(np.asarray, jmodel._state.params_d), tcfg=jmodel._tcfg,
                jstate=jmodel._state, env=_torch_env(jtables, ConditioningConfig(image_size=S)))


def _port_state(tmp_path):
    opt = TrainOptions().parse(ARGS + ["--device", "cpu", "--checkpoints_dir", str(tmp_path)])
    tcfg = train_config_from_opt(opt)
    return init_state(*build_networks(tcfg, device="cpu", seed=3), tcfg), tcfg


def _equal(state_dict: dict, want: dict):
    assert state_dict.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(state_dict[k], v), k


def test_jax_epoch_loads_bit_equal(jax_run, tmp_path):
    """G through load_checkpoint (G only) and load_generator_params, D
    through load_discriminator_params: bit-equal to the mappings of the
    parameters the JAX model held."""
    d = jax_run["dir"]
    state, tcfg = _port_state(tmp_path)
    want_g = generator_state_dict_from_flax(jax_run["params_g"], tcfg)
    ckpt.load_checkpoint(str(d), 1, state, load_optimizers=False, tcfg=tcfg)
    _equal(state.g.state_dict(), want_g)
    g = build_networks(tcfg, device="cpu", seed=4)[0]
    _equal(ckpt.load_generator_params(g, str(d / "net_epoch_1_id_G.ckpt"), tcfg).state_dict(),
           want_g)
    dnet = ckpt.load_discriminator_params(state.d, str(d / "net_epoch_1_id_D.ckpt"))
    _equal(dnet.state_dict(), discriminator_state_dict_from_flax(jax_run["params_d"]))


@pytest.mark.parametrize("label", ["G", "D"])
@pytest.mark.parametrize("kind", ["net", "opt"])
def test_reader_matches_flax_on_every_file(jax_run, kind, label):
    """Every leaf of the four files (parameters, optax Adam state as
    tuple-maps, int32 step, f32 learning rate) as flax restores it."""
    path = jax_run["dir"] / f"{kind}_epoch_1_id_{label}.ckpt"
    data = path.read_bytes()
    want = flax.serialization.msgpack_restore(data)
    got = msgpack_restore(data)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(
        numpy_tree(got), is_leaf=lambda x: isinstance(x, np.ndarray)))
    assert flat_w.keys() == flat_g.keys() and flat_w
    for k, w in flat_w.items():
        np.testing.assert_array_equal(flat_g[k], w, err_msg=str(k))
        assert flat_g[k].dtype == np.asarray(w).dtype, k


@pytest.mark.parametrize("mode", ["load_path", "load_epoch"])
def test_eval_torch_on_a_jax_checkpoint_matches_eval_py(jax_run, mode, tmp_path, monkeypatch):
    """eval_torch.py on the JAX run's epoch 1 (--load_path x.ckpt, or
    --load_epoch 1 over its directory) against eval.py's fakes for the same
    weights: within 1e-4 (the bound of test_eval_slice_matches_jax), PNGs
    within one level."""
    seen = {}
    orig = model_api.HOIGModel.forward

    def forward(self, *a, **k):
        out = orig(self, *a, **k)
        seen["fakes"] = [o.detach().numpy() for o in out]
        return out

    monkeypatch.setattr(model_api.HOIGModel, "forward", forward)
    d = jax_run["dir"]
    load = (["--load_path", str(d / "net_epoch_1_id_G.ckpt"), "--checkpoints_dir",
             str(tmp_path / "ck")] if mode == "load_path"
            else ["--load_epoch", "1", "--checkpoints_dir", str(d.parent)])
    eval_torch.main(ARGS + ["--device", "cpu", "--output_dir", str(tmp_path / "out"), *load],
                    env=jax_run["env"])
    for a, b in zip(seen["fakes"], jax_run["fakes"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    jout = jax_run["tmp"] / "jout"
    for sub in ("source", "imitators", "gt"):
        stems = sorted(os.listdir(jout / sub))
        assert sorted(os.listdir(tmp_path / "out" / sub)) == stems and stems
        for stem in stems:
            with Image.open(jout / sub / stem) as a, Image.open(tmp_path / "out" / sub / stem) as b:
                diff = np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16))
            assert diff.max() <= 1, (sub, stem)


@functools.lru_cache(maxsize=None)
def _adam_step(b1: float, b2: float):
    """One optax Adam step, the update times the learning rate, as the JAX
    train step applies it (hoig_tpu/train/trainer.py:329-349); jitted once
    per (b1, b2) and tree, for every test of a worker."""
    opt = optax.adam(1.0, b1=b1, b2=b2)

    @jax.jit
    def step(grads, opt_state, params, lr):
        upd, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, jax.tree.map(lambda u: u * lr, upd)), opt_state

    return step


def _optax_steps(jstate, tcfg, n_g: int, n_d: int, seed: int):
    """The JAX state after n_g Adam steps of G and n_d of D on random
    gradients."""
    step = _adam_step(tcfg.adam_b1, tcfg.adam_b2)
    rng = np.random.RandomState(seed)

    def advance(params, opt_state, lr, n):
        for _ in range(n):
            grads = jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32) * 1e-2, params)
            params, opt_state = step(grads, opt_state, params, lr)
        return params, opt_state

    pg, og = advance(jstate.params_g, jstate.opt_g, jstate.lr_g, n_g)
    pd, od = advance(jstate.params_d, jstate.opt_d, jstate.lr_d, n_d)
    return jstate.replace(params_g=pg, opt_g=og, params_d=pd, opt_d=od,
                          step=jnp.asarray(n_g, jnp.int32), lr_g=jnp.float32(1.5e-4),
                          lr_d=jnp.float32(0.7e-4))


@pytest.fixture(scope="module", params=["d_trained", "d_gated"])
def jax_resume(jax_run, request):
    """A JAX run directory whose newest epoch (2) was saved after 3 steps: D
    took all 3 or, gated, only 1; epoch 1 (Adam untouched) stays beside it."""
    from hoig_tpu.train import checkpoints as jckpt

    n_d = 3 if request.param == "d_trained" else 1
    jstate = _optax_steps(jax_run["jstate"], jax_run["tcfg"], 3, n_d, seed=21)
    run = jax_run["tmp"] / f"resume_{request.param}"
    d = run / "t"
    d.mkdir(parents=True)
    for f in os.listdir(jax_run["dir"]):
        if "_epoch_1_" in f:
            (d / f).write_bytes((jax_run["dir"] / f).read_bytes())
    jckpt.save_checkpoint(str(d), 2, jstate)
    return dict(dir=d, jstate=jstate, n_d=n_d)


def _resumed_model(jax_run, jax_resume, how, tmp_path):
    """A HOIGModel whose state came back from the JAX epoch 2 by `how`."""
    d = jax_resume["dir"]
    args = ARGS + ["--device", "cpu", "--checkpoints_dir", str(d.parent)]
    if how == "auto_resume":
        opt = TrainOptions().parse(args)
        assert opt.load_epoch == 2  # the newest complete epoch, a JAX one
    elif how == "explicit_epoch":
        opt = TrainOptions().parse(args + ["--load_epoch", "2"])
    else:
        opt = TrainOptions().parse(ARGS + ["--device", "cpu", "--checkpoints_dir",
                                           str(tmp_path)])
        assert opt.load_epoch == 0
    model = model_api.HOIGModel(opt, env=jax_run["env"])
    if how == "load_checkpoint":
        ckpt.load_checkpoint(str(d), 2, model._state, tcfg=model._tcfg)
    return model


def _flax_close(tree, ref, atol):
    flat = dict(jax.tree_util.tree_leaves_with_path(tree))
    ref = jax.tree_util.tree_leaves_with_path(ref)
    assert len(flat) == len(ref) > 0
    for path, leaf in ref:
        np.testing.assert_allclose(flat[path], np.asarray(leaf), atol=atol, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("how", ["auto_resume", "explicit_epoch", "load_checkpoint"])
def test_training_resumes_from_jax_epochs(jax_run, jax_resume, how, tmp_path):
    """Over a directory of JAX epochs, training resumes from the newest by
    each route: G and D bit-equal to the mapped JAX parameters, the Adam
    moments bit-equal to optax's mu and nu after the layout maps, Adam's step
    = optax's count (3 for G; 3 or 1 for a gated D) as a CPU float32 scalar
    where torch keeps it, the learning rates and the step counter. Then one
    Adam step of each resumed optimizer against optax's update of the saved
    JAX state on the same gradients (random, mapped to the flax layout):
    weights and moments within 1e-6, the bound of
    tests/test_torch_train.py::test_adam_matches_optax."""
    from hoig_torch.models.convert import discriminator_mapping, generator_mapping
    from hoig_torch.train.optax_state import optax_from_adam

    model = _resumed_model(jax_run, jax_resume, how, tmp_path)
    state, tcfg, js = model._state, model._tcfg, jax_resume["jstate"]
    gmap, dmap = generator_mapping(tcfg.gen_name, tcfg.repeat_num), discriminator_mapping(4)
    _equal(state.g.state_dict(), generator_state_dict_from_flax(
        jax.tree.map(np.asarray, js.params_g), tcfg))
    _equal(state.d.state_dict(), discriminator_state_dict_from_flax(
        jax.tree.map(np.asarray, js.params_d)))
    for opt, module, mapping, jopt, count in (
            (state.opt_g, state.g, gmap, js.opt_g, 3),
            (state.opt_d, state.d, dmap, js.opt_d, jax_resume["n_d"])):
        assert int(jopt[0].count) == count
        for p in module.parameters():
            st = opt.state[p]
            assert st["step"].device.type == "cpu" and st["step"].dtype == torch.float32
            assert float(st["step"]) == count
        back = optax_from_adam(opt, module, mapping)["0"]
        assert int(back["count"]) == count
        _flax_close(back["mu"], jopt[0].mu, 0.0)
        _flax_close(back["nu"], jopt[0].nu, 0.0)
    assert state.step == 3 and model._opt.load_epoch in (0, 2)
    np.testing.assert_allclose([state.lr_g, state.lr_d], [1.5e-4, 0.7e-4], rtol=1e-6)
    assert state.opt_g.param_groups[0]["lr"] == state.lr_g

    # the step after the resume: the optimizer half of a train step (the
    # discriminator needs 64 px, this run is 32), on the same random
    # gradients in both layouts
    rng = np.random.RandomState(22)
    step_j = _adam_step(tcfg.adam_b1, tcfg.adam_b2)
    for module, mapping, params, jopt, lr, opt in (
            (state.g, gmap, js.params_g, js.opt_g, js.lr_g, state.opt_g),
            (state.d, dmap, js.params_d, js.opt_d, js.lr_d, state.opt_d)):
        for p in module.parameters():
            p.grad = torch.as_tensor(rng.randn(*p.shape).astype(np.float32) * 1e-2)
        opt.step()
        grads = {"params": convert_tree(module, mapping, grads=True)}
        new_params, new_opt = step_j(grads, jopt, params, lr)
        _flax_close({"params": convert_tree(module, mapping)}, new_params, 1e-6)
        back = optax_from_adam(opt, module, mapping)["0"]
        assert int(back["count"]) == int(new_opt[0].count)
        _flax_close(back["mu"], new_opt[0].mu, 1e-6)
        _flax_close(back["nu"], new_opt[0].nu, 1e-6)


def convert_tree(module, mapping, grads: bool = False) -> dict:
    """The module's weights (or their .grad) on the flax tree's paths."""
    from hoig_torch.models.convert import flax_tree_from_torch

    named = {n: (p.grad if grads else p.detach()) for n, p in module.named_parameters()}
    return flax_tree_from_torch(named, mapping)


class _Stop(Exception):
    pass


def test_scan_takes_the_newest_complete_epoch_of_either_kind(tmp_path, monkeypatch):
    """Port and JAX epochs in one directory: the newest complete one wins, a
    torn epoch of either kind does not count, and load_checkpoint reads the
    port's .pth set where an epoch has both, the .ckpt set where it has
    only that."""
    d = tmp_path / "run"
    d.mkdir()
    for e, suffix in ((1, ".pth"), (2, ".ckpt"), (3, ".pth"), (3, ".ckpt")):
        for kind in ("net", "opt"):
            for net in ("G", "D"):
                (d / f"{kind}_epoch_{e}_id_{net}{suffix}").write_bytes(b"")
    (d / "net_epoch_5_id_G.ckpt").write_bytes(b"")  # torn: G only
    (d / "net_epoch_4_id_G.pth").write_bytes(b"")
    assert ckpt.scan_latest_epoch(str(d)) == 3
    (d / "opt_epoch_3_id_D.pth").unlink()  # epoch 3's .pth set torn: its .ckpt set counts
    assert ckpt.scan_latest_epoch(str(d)) == 3
    (d / "opt_epoch_3_id_D.ckpt").unlink()
    assert ckpt.scan_latest_epoch(str(d)) == 2
    assert ckpt.scan_latest_epoch(str(tmp_path / "absent")) == 0

    seen = []

    def record(path, *_):
        seen.append(os.path.basename(path))
        raise _Stop

    monkeypatch.setattr(ckpt, "_load", record)
    monkeypatch.setattr(ckpt, "_flax_params", record)
    state, _ = _port_state(tmp_path)
    for epoch, want in ((1, "net_epoch_1_id_G.pth"), (2, "net_epoch_2_id_G.ckpt")):
        with pytest.raises(_Stop):
            ckpt.load_checkpoint(str(d), epoch, state, tcfg=object())
        assert seen.pop() == want
    for kind in ("net", "opt"):  # epoch 1 of both kinds: the .pth set
        for net in ("G", "D"):
            (d / f"{kind}_epoch_1_id_{net}.ckpt").write_bytes(b"")
    with pytest.raises(_Stop):
        ckpt.load_checkpoint(str(d), 1, state)
    assert seen.pop() == "net_epoch_1_id_G.pth"


_DTYPES = ["float32", "bfloat16", "float16", "float64", "int32", "int64", "int8", "uint8", "bool"]


@pytest.mark.parametrize("dtype", _DTYPES)
def test_array_leaves_bit_equal(dtype):
    rng = np.random.RandomState(0)
    a = (rng.randn(3, 5, 2) * 100).astype(jnp.dtype(dtype))
    data = flax.serialization.to_bytes({"p": {"x": a, "y": a[0].copy()}})
    got = msgpack_restore(data)["p"]
    for key, want in (("x", a), ("y", a[0])):
        t = got[key]
        assert str(t.dtype) == f"torch.{dtype}" and tuple(t.shape) == want.shape
        raw = t.view(torch.int16) if dtype == "bfloat16" else t
        ref = want.view(np.int16) if dtype == "bfloat16" else want
        np.testing.assert_array_equal(raw.numpy(), ref)


def test_scalars_containers_and_remat_prefix(tmp_path):
    """Python scalars, str, bytes, None, complex (ext 2), numpy scalars (ext
    3) and tuples (maps keyed "0", "1", ...); keys of remat-wrapped modules
    lose their 'Checkpoint' prefix in read_flax_checkpoint."""
    tree = {"i": 7, "neg": -3, "big": 2**40, "f": 0.25, "b": True, "n": None, "s": "hé",
            "raw": b"\x00\x01", "c": complex(1.5, -2.0), "np": np.float32(3.5),
            "npi": np.int32(-9), "t": (np.ones(2, np.float32), {"CheckpointConv_0": 1})}
    data = flax.serialization.to_bytes(tree)
    want = flax.serialization.msgpack_restore(data)
    got = msgpack_restore(data)
    for k in ("i", "neg", "big", "f", "b", "n", "s", "raw", "c", "np", "npi"):
        plain = want[k].item() if isinstance(want[k], np.generic) else want[k]
        assert got[k] == plain and type(got[k]) is type(plain), k
    assert set(got["t"]) == {"0", "1"} and torch.equal(got["t"]["0"], torch.ones(2))
    path = tmp_path / "x.ckpt"
    path.write_bytes(data)
    assert read_flax_checkpoint(str(path))["t"]["1"] == {"Conv_0": 1}


def test_chunked_arrays_reassemble(monkeypatch):
    """Arrays above flax's MAX_CHUNK_SIZE are written in flat chunks: here
    the limit is lowered to 256 bytes, so both arrays below are chunked."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 256)
    rng = np.random.RandomState(1)
    tree = {"w": rng.randn(10, 30).astype(np.float32),
            "h": {"k": rng.randn(7, 50).astype(jnp.bfloat16)}}
    data = flax.serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    got = msgpack_restore(data)
    np.testing.assert_array_equal(got["w"].numpy(), tree["w"])
    np.testing.assert_array_equal(got["h"]["k"].view(torch.int16).numpy(),
                                  tree["h"]["k"].view(np.int16))


@pytest.mark.parametrize("data,offset", [
    (b"\x81\xa1a\xc1", 3),                    # 0xc1, never used by msgpack
    (b"\x81\xa1a\xd4\x07\x00", 3),            # ext type 7
    (b"\x81\x01\x02", 1),                     # an int map key
    (b"\x82\xa1a\x01\xa1", 5),                # truncated
    (b"\x81\xa1a\x01\x00", 4),                # bytes after the tree
    (b"\x81\xa1a\xc7\x0d\x01\x93\x91\x01\xa6uint99\xc4\x01\x00", 3),  # unknown dtype
], ids=["c1", "ext7", "int_key", "truncated", "trailing", "dtype"])
def test_outside_the_subset_raises_with_the_offset(data, offset):
    with pytest.raises(ValueError, match=f"at byte offset {offset}$"):
        msgpack_restore(data)
