"""Data-parallel training of the port (hoig_torch/parallel) on the CPU.

Two gloo processes, each fed half of one global batch, against the port's
one-process step on the whole batch (itself held to the JAX step by
tests/test_torch_train.py, which closes the chain to JAX): G and D
gradients before Adam, the weights after it, and the logged metrics, from
fresh weights, once with D's gate on and once with it off on rank 0 and on
on rank 1 (rank 0's gate wins). The same two processes then run
train_torch.Train under torchrun's environment. The bounds are those of f32
sums taken in another order: a global-batch mean of per-sample means
against the average of two half-batch means.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hoig_torch import parallel
from hoig_torch.data.loader import DataLoader, ShardedSampler

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
S, B, WORLD = 64, 2, 2
# gradients: the two-rank average within 1e-4 of each leaf's largest entry
# plus 1e-6 of the largest gradient of the network: f32 sums in another
# order, carried through the backward (1.4e-5 of a leaf's largest entry at
# most when this was written)
GRAD_REL, GRAD_TREE = 1e-4, 1e-6
# Adam's first step moves a weight by lr * g / (|g| + eps), so two gradients
# a and b move it to within lr * min(2, 2 |a - b| / (max(|a|, |b|) + eps))
# of each other (a weight whose gradient is zero up to rounding, such as a
# conv bias before an InstanceNorm, may go either way), plus the rounding of
# the update and of the subtraction, two f32 ulps of lr and of the weight
LR, EPS = 2e-4, 1e-8
# the gates of the two cases, per rank, and the one-process step's gate
CASES = {"gate_on": ((True, True), True), "gate_split": ((False, True), False)}

_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["HOIG_REPO"])
sys.path.insert(0, os.path.join(os.environ["HOIG_REPO"], "tests"))
import torch
torch.set_num_threads(1)
import test_torch_ddp as t
t.rank_main(os.environ["HOIG_TEST_OUT"], os.environ["HOIG_TEST_CKPT"])
print("WORKER-OK", os.environ["RANK"])
"""


def _setup(seed: int):
    from hoig_torch.data.synthetic import synthetic_environment
    from hoig_torch.geometry.conditioning import ConditioningConfig
    from hoig_torch.models.vgg import init_vgg
    from hoig_torch.train.trainer import TrainConfig, build_networks, init_state

    env = synthetic_environment(2, S, device="cpu")
    tcfg = TrainConfig(image_size=S, conv_dim=8, repeat_num=2, remat=False, lr_G=LR, lr_D=LR)
    state = init_state(*build_networks(tcfg, device="cpu", seed=seed), tcfg)
    fn_args = (init_vgg(seed=2, device="cpu"), env["tables"], env["mano_params"],
               ConditioningConfig(image_size=S), tcfg)
    return env, state, fn_args


def _global_batch(env) -> dict:
    from hoig_torch.data.synthetic import synthetic_batch

    return synthetic_batch(B, env["obj_verts"], image_size=S, seed=3)


def _part(batch: dict, sl: slice) -> dict:
    from hoig_torch.train.model_api import batch_as_torch

    cut = lambda v: {k: cut(x) for k, x in v.items()} if isinstance(v, dict) else v[sl]
    return batch_as_torch(cut(batch), "cpu")


def _record(state, metrics, collectives=None) -> dict:
    grads = {f"{label}.{n}": p.grad.clone() for label, net in (("g", state.g), ("d", state.d))
             for n, p in net.named_parameters() if p.grad is not None}
    weights = {f"{label}.{n}": p.detach().clone()
               for label, net in (("g", state.g), ("d", state.d)) for n, p in net.named_parameters()}
    return dict(grads=grads, weights=weights, metrics={k: float(v) for k, v in metrics.items()},
                collectives=dict(collectives or {}))


def rank_main(out_path: str, ckpt_dir: str) -> None:
    """One rank of the two-process run (started by the `ranks` fixture with
    torchrun's environment): the data-parallel step on its half of the
    batch, then the training driver."""
    from hoig_torch.train.trainer import make_train_step

    assert parallel.init_from_env("cpu")
    r = parallel.rank()
    steps = {}
    for case, (gates, _) in CASES.items():
        # rank 1 starts from other weights: DataParallel broadcasts rank 0's
        env, state, fn_args = _setup(seed=0 if r == 0 else 5)
        dp = parallel.DataParallel(state)
        batch = _part(_global_batch(env), parallel.local_batch_slice(B))
        state, m = make_train_step(*fn_args, sync=dp)(state, batch, gates[r])
        steps[case] = _record(state, m, dp.collectives)

    refused = {}
    for n in (0, 1, 2, 3):
        try:
            parallel.num_data_devices(type("O", (), {"num_data_devices": n}))
            refused[n] = None
        except ValueError as e:
            refused[n] = str(e)
    parallel.coordination_barrier("steps_done")

    import train_torch

    run = train_torch.Train([
        "--dataset_mode", "synthetic", "--image_size", str(S), "--batch_size", "1",
        "--conv_dim", "8", "--repeat_num", "2", "--no_remat", "--use_spade",
        "--synthetic_size", "4", "--nepochs_no_decay", "1", "--nepochs_decay", "0",
        "--device", "cpu", "--checkpoints_dir", ckpt_dir, "--name", "ddp",
        "--n_threads_train", "1", "--n_threads_test", "1"])
    driver = dict(step=run.model._state.step, total_steps=run._total_steps,
                  global_batch=run._global_batch,
                  g={n: p.detach().clone() for n, p in run.model._state.g.named_parameters()})
    torch.save(dict(rank=r, world=parallel.world_size(), slice=parallel.local_batch_slice(4),
                    steps=steps, refused=refused, driver=driver), out_path)
    parallel.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two gloo ranks (run in subprocesses) and the one-process reference on
    the whole batch (run here meanwhile): (rank results, reference steps)."""
    from hoig_torch.train.trainer import make_train_step

    tmp = tmp_path_factory.mktemp("ddp")
    worker = tmp / "worker.py"
    worker.write_text(_WORKER)
    port = _free_port()
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(WORLD),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   HOIG_REPO=str(REPO), HOIG_TEST_OUT=str(tmp / f"rank{r}.pt"),
                   HOIG_TEST_CKPT=str(tmp / "ck"))
        log = open(tmp / f"rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(worker)], env=env, stdout=log,
                                       stderr=subprocess.STDOUT, cwd=tmp), log))
    try:
        ref = {}
        for case, (_, gate) in CASES.items():
            env, state, fn_args = _setup(seed=0)
            state, m = make_train_step(*fn_args)(state, _part(_global_batch(env), slice(0, B)),
                                                 gate)
            ref[case] = _record(state, m)
        for p, _ in procs:
            p.wait(timeout=600)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r, (p, _) in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{(tmp / f'rank{r}.log').read_text()[-4000:]}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)], ref, tmp


def _close(got: dict, want: dict, net: str, rel: float, tree: float):
    keys = [k for k in want if k.startswith(net + ".")]
    top = max(float(want[k].abs().max()) for k in keys)
    for k in keys:
        err = float((got[k] - want[k]).abs().max())
        assert err <= rel * float(want[k].abs().max()) + tree * top, (k, err)


@pytest.mark.parametrize("case,net", [("gate_on", "g"), ("gate_on", "d"), ("gate_split", "g")])
def test_gradients_match_one_process_step(ranks, case, net):
    """The averaged gradients of the two ranks are the whole batch's."""
    results, ref, _ = ranks
    for res in results:
        _close(res["steps"][case]["grads"], ref[case]["grads"], net, GRAD_REL, GRAD_TREE)


@pytest.mark.parametrize("case,net", [("gate_on", "g"), ("gate_on", "d"), ("gate_split", "g")])
def test_updated_weights_match_one_process_step(ranks, case, net):
    results, ref, _ = ranks
    want, want_g = ref[case]["weights"], ref[case]["grads"]
    for res in results:
        got, got_g = res["steps"][case]["weights"], res["steps"][case]["grads"]
        for k in (k for k in want if k.startswith(net + ".")):
            a, b = got_g[k], want_g[k]
            move = LR * torch.clamp(2 * (a - b).abs() / (torch.maximum(a.abs(), b.abs()) + EPS),
                                    max=2.0)
            ulps = 2 * torch.finfo(torch.float32).eps * (want[k].abs() + LR)
            assert bool(((got[k] - want[k]).abs() <= move + ulps).all()), k


@pytest.mark.parametrize("case", list(CASES))
def test_metrics_are_global_batch_means(ranks, case):
    results, ref, _ = ranks
    want = ref[case]["metrics"]
    for res in results:
        got = res["steps"][case]["metrics"]
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-7), k


def test_ranks_agree_on_rank0_gate(ranks):
    """gate_split: rank 0 passed False and rank 1 True; both skip D's update
    (D keeps rank 0's initial weights) and run the same collectives, with
    no D all-reduce."""
    results, ref, _ = ranks
    for res in results:
        on, split = res["steps"]["gate_on"], res["steps"]["gate_split"]
        assert on["collectives"] == {"broadcast_gate": 1, "all_reduce_g": 1, "all_reduce_d": 1,
                                     "all_reduce_metrics": 1}
        assert split["collectives"] == {"broadcast_gate": 1, "all_reduce_g": 1,
                                        "all_reduce_metrics": 1}
        for k, w in split["weights"].items():
            if k.startswith("d."):
                assert torch.equal(w, ref["gate_split"]["weights"][k]), k


def test_ranks_hold_the_same_weights(ranks):
    """Rank 1 was built from other weights; the broadcast and the averaged
    gradients keep both ranks bit-equal, in the step and in train_torch.Train."""
    (r0, r1), _, _ = ranks
    for case in CASES:
        for k, w in r0["steps"][case]["weights"].items():
            assert torch.equal(w, r1["steps"][case]["weights"][k]), k
    for k, w in r0["driver"]["g"].items():
        assert torch.equal(w, r1["driver"]["g"][k]), k


def test_num_data_devices_inside_the_group(ranks):
    results, _, _ = ranks
    for res in results:
        assert res["world"] == WORLD
        assert res["refused"][0] is None and res["refused"][2] is None
        assert "num_data_devices 1" in res["refused"][1]
        assert "num_data_devices 3" in res["refused"][3]


def test_local_batch_slices_split_the_global_batch(ranks):
    results, _, _ = ranks
    assert [res["slice"] for res in results] == [slice(0, 2), slice(2, 4)]


def test_train_driver_under_two_processes(ranks):
    """train_torch.Train under torchrun's environment: 4 samples, 2 shards,
    batch 1 per rank -> 2 steps per rank; the counters count the global
    batch; rank 0 alone writes the checkpoints and the logs."""
    results, _, tmp = ranks
    for res in results:
        assert res["driver"]["step"] == 2
        assert res["driver"]["global_batch"] == 2 and res["driver"]["total_steps"] == 4
    files = set(os.listdir(tmp / "ck" / "ddp"))
    assert {f"{k}_epoch_1_id_{n}.pth" for k in ("net", "opt") for n in "GD"} <= files
    assert "opt_train.txt" in files


def test_one_process_run_has_no_group():
    assert not parallel.is_distributed()
    assert parallel.world_size() == 1 and parallel.rank() == 0 and parallel.process_is_primary()
    assert parallel.local_batch_slice(4) == slice(0, 4)
    assert not parallel.init_from_env("cpu")  # no torchrun environment
    parallel.coordination_barrier("alone")  # a no-op
    with pytest.raises(RuntimeError, match="process group"):
        parallel.DataParallel(None)


@pytest.mark.parametrize("n,ok", [(0, True), (1, True), (2, False), (8, False)])
def test_num_data_devices_refused_unless_world_size(n, ok):
    opt = type("O", (), {"num_data_devices": n, "batch_size": 4, "is_train": True})
    if ok:
        assert parallel.num_data_devices(opt) == 1
        assert parallel.per_process_batch_size(opt) == 4
    else:
        with pytest.raises(ValueError, match=f"num_data_devices {n}"):
            parallel.num_data_devices(opt)


@pytest.mark.parametrize("shards", [2, 3])
def test_shards_are_disjoint(shards):
    """Each rank's loader reads its own part of every epoch's permutation."""
    data = [{"i": np.int64(i)} for i in range(13)]
    for epoch in (1, 2):
        seen = []
        for r in range(shards):
            loader = DataLoader(data, batch_size=2, num_shards=shards, shard_index=r, seed=4,
                                num_threads=1)
            loader.set_epoch(epoch)
            seen.append([int(i) for b in loader for i in b["i"]])
            want = ShardedSampler(13, shards, r, seed=4)
            want.set_epoch(epoch)
            assert seen[-1] == list(want.indices())[:len(seen[-1])]
        flat = [i for s in seen for i in s]
        assert len(flat) == len(set(flat)) == shards * (13 // shards // 2 * 2)
