"""The program's spans (hoig_torch/utils/profiling.py `annotate`) on the CPU:
off and free unless torch's profiler records; on, a `hoig/<name>` range in
the trace on the trace's own clock and a record with its parent and step;
the training step's and the serving call's spans in order, and a traced
step bit-equal to an untraced one."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hoig_torch.data.synthetic import synthetic_batch, synthetic_environment
from hoig_torch.geometry.conditioning import ConditioningConfig
from hoig_torch.models.vgg import init_vgg
from hoig_torch.train.model_api import batch_as_torch, flow_only, forward_only
from hoig_torch.train.trainer import TrainConfig, build_networks, init_state, make_train_step
from hoig_torch.utils import profiling

torch.set_num_threads(1)

S = 48  # PatchGAN-4's smallest size


def _profiled(fn):
    """fn() under a CPU profiler: (its result, the profiler's raw events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, list(prof.profiler.kineto_results.events())


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.reset_spans()
    with profiling.annotate("outer"):
        with profiling.annotate("inner"):
            torch.ones(4).sum()
    assert profiling.spans() == []


def test_spans_on_the_profilers_clock_with_parents_and_steps():
    profiling.reset_spans()

    def work():
        for _ in range(2):
            with profiling.annotate("step"):
                with profiling.annotate("a"):
                    torch.randn(32, 32) @ torch.randn(32, 32)
                with profiling.annotate("b"):
                    with profiling.annotate("c"):
                        torch.randn(32).sum()

    _, events = _profiled(work)
    recs = profiling.spans()
    assert [r["name"] for r in recs] == ["step", "a", "b", "c"] * 2
    assert [r["id"] for r in recs] == list(range(8))
    assert [r["parent"] for r in recs] == [None, 0, 0, 2, None, 4, 4, 6]
    assert [r["step"] for r in recs] == [0] * 4 + [4] * 4
    assert all(r["stream_ms"] is None for r in recs)  # no CUDA here
    ranges = [e for e in events if e.name().startswith(profiling.SPAN_PREFIX)]
    assert [e.name() for e in sorted(ranges, key=lambda e: e.start_ns())] == [
        "hoig/" + r["name"] for r in recs]
    for rec, ev in zip(recs, sorted(ranges, key=lambda e: e.start_ns())):
        assert abs(rec["host_start_ns"] - ev.start_ns()) < 1_000_000
        assert abs(rec["host_end_ns"] - ev.end_ns()) < 1_000_000
    profiling.reset_spans()
    assert profiling.spans() == []


@pytest.fixture(scope="module")
def tiny():
    """A tiny fp32 program on the CPU (full remat, the gather engine): two
    states from the same seeds, the step, a batch and its parts."""
    tcfg = TrainConfig(image_size=S, conv_dim=4, repeat_num=1)
    env = synthetic_environment(2, S, device="cpu")
    ccfg = ConditioningConfig(image_size=S)
    batch = batch_as_torch(synthetic_batch(2, env["obj_verts"], image_size=S), "cpu")
    vgg = init_vgg(seed=2, device="cpu")
    step = make_train_step(vgg, env["tables"], env["mano_params"], ccfg, tcfg)
    return dict(tcfg=tcfg, env=env, ccfg=ccfg, batch=batch, step=step,
                new_state=lambda: init_state(*build_networks(tcfg, device="cpu", seed=0), tcfg))


@pytest.mark.parametrize("d_trainable", [True, False])
def test_train_step_spans_in_order_and_bit_equal_to_untraced(tiny, d_trainable):
    profiling.reset_spans()
    plain, traced = tiny["new_state"](), tiny["new_state"]()
    _, m_plain = tiny["step"](plain, tiny["batch"], d_trainable)
    assert profiling.spans() == []  # nothing recorded with the profiler off
    (_, m_traced), events = _profiled(lambda: tiny["step"](traced, tiny["batch"], d_trainable))
    recs = profiling.spans()
    profiling.reset_spans()

    n_attn = len(traced.g.attn_layers)
    assert n_attn > 0
    d_side = ["d_losses", "d_backward", "d_adam"] if d_trainable else ["d_losses"]
    assert [r["name"] for r in recs] == (
        ["train_step", "conditioning", "generator"] + ["attention"] * n_attn
        + ["g_losses", "g_backward", "g_adam"] + d_side)
    ids = {r["name"]: r["id"] for r in recs}
    assert all(r["step"] == 0 for r in recs)
    assert all(r["parent"] == (ids["generator"] if r["name"] == "attention" else 0)
               for r in recs[1:])
    assert {e.name() for e in events} >= {"hoig/" + r["name"] for r in recs}

    assert m_plain.keys() == m_traced.keys()
    assert all(torch.equal(m_plain[k], m_traced[k]) for k in m_plain)
    for net in ("g", "d"):
        a = dict(getattr(plain, net).named_parameters())
        b = dict(getattr(traced, net).named_parameters())
        assert all(torch.equal(a[k], b[k]) for k in a), net


def test_serving_spans(tiny):
    tcfg, env, batch = tiny["tcfg"], tiny["env"], tiny["batch"]
    g = tiny["new_state"]().g
    profiling.reset_spans()
    plain = forward_only(g, flow_only(batch, env, tiny["ccfg"]), batch, tcfg)
    traced, _ = _profiled(
        lambda: forward_only(g, flow_only(batch, env, tiny["ccfg"]), batch, tcfg))
    recs = profiling.spans()
    profiling.reset_spans()
    assert [r["name"] for r in recs] == ["conditioning", "generator"] + ["attention"] * len(
        g.attn_layers)
    assert [r["parent"] for r in recs] == [None, None] + [1] * len(g.attn_layers)
    assert [r["step"] for r in recs] == [0, 1] + [1] * len(g.attn_layers)
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))
