"""The serving entry points' CUDA graphs (hoig_torch/train/call_graphs.py) on
the CPU: CPU tensors stay on the eager path; with a stand-in graph, the
signature each call is keyed by (a new shape, dtype, configuration, mode or
replaced weight is never served by an old graph), fresh outputs on every
call, in-place weights read live, launches counted where a kernel
launches (never on a replay), a failed
capture naming its operator; and the constants hoisted out of the
conditioning, bit for bit against the literals they replace."""

import dataclasses

import numpy as np
import pytest
import torch

from hoig_torch.data.synthetic import synthetic_batch, synthetic_environment
from hoig_torch.geometry import mano as mano_mod
from hoig_torch.geometry import projection, renderer
from hoig_torch.geometry.conditioning import ConditioningConfig
from hoig_torch.ops import _cuda
from hoig_torch.train import call_graphs, model_api
from hoig_torch.train.trainer import TrainConfig, build_generator

torch.set_num_threads(1)

S = 32


CAPTURING = [False]  # the stand-in card's capture state (_cuda.capturing)


class FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: a replay runs the captured body
    again on the static inputs and writes the static outputs in place, as
    though capturing, so that no launch counts (a real replay runs no
    wrapper)."""

    def __init__(self, fn, structure, inputs, outputs):
        self.fn, self.structure, self.inputs, self.outputs = fn, structure, inputs, outputs

    def replay(self):
        new: list = []
        CAPTURING[0] = True
        try:
            call_graphs.flatten(self.fn(*call_graphs.unflatten(self.structure,
                                                               iter(self.inputs))), new)
        finally:
            CAPTURING[0] = False
        for out, val in zip(self.outputs, new):
            out.copy_(val)


def fake_capture(fn, structure, inputs):
    """As call_graphs._capture: a warm-up pass, then the capture pass."""
    fn(*call_graphs.unflatten(structure, iter(inputs)))
    CAPTURING[0] = True
    try:
        outputs = fn(*call_graphs.unflatten(structure, iter(inputs)))
    finally:
        CAPTURING[0] = False
    outs: list = []
    call_graphs.flatten(outputs, outs)
    return FakeGraph(fn, structure, inputs, outs), outputs


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors take the graph path, captured by FakeGraph."""
    monkeypatch.setattr(call_graphs, "graphable", lambda leaves: bool(leaves))
    monkeypatch.setattr(call_graphs, "_capture", fake_capture)
    monkeypatch.setattr(_cuda, "capturing", lambda: CAPTURING[0])
    for graphs in (model_api.FLOW_GRAPHS, model_api.FORWARD_GRAPHS):
        graphs.clear()
    yield
    for graphs in (model_api.FLOW_GRAPHS, model_api.FORWARD_GRAPHS):
        graphs.clear()


@pytest.fixture(scope="module")
def tiny():
    """A tiny program on the CPU: environment, generator, configurations,
    three batches drawn from different seeds and each one's eager flow and
    images."""
    env = synthetic_environment(2, S, device="cpu")
    tcfg = TrainConfig(image_size=S, conv_dim=4, repeat_num=1, corner_engine="shift")
    t = dict(env=env, tcfg=tcfg, ccfg=ConditioningConfig(image_size=S),
             gen=build_generator(tcfg, device="cpu", seed=0).eval(),
             batches=[model_api.batch_as_torch(synthetic_batch(2, env["obj_verts"], image_size=S,
                                                               seed=i), "cpu") for i in range(3)])
    t["eager"] = [_eager(t, b) for b in t["batches"]]
    return t


def _eager(t, batch):
    flow = model_api.flow_eager(batch, t["env"], t["ccfg"])
    return flow, model_api.forward_eager(t["gen"], flow, batch, t["tcfg"])


def _graphed(t, batch):
    flow = model_api.flow_only(batch, t["env"], t["ccfg"])
    return flow, model_api.forward_only(t["gen"], flow, batch, t["tcfg"])


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return (a is None and b is None) or torch.equal(a, b)


def test_cpu_tensors_take_the_eager_path(tiny):
    for graphs in (model_api.FLOW_GRAPHS, model_api.FORWARD_GRAPHS):
        graphs.clear()
    for _ in range(3):
        assert _same(_graphed(tiny, tiny["batches"][0]), tiny["eager"][0])
    for graphs in (model_api.FLOW_GRAPHS, model_api.FORWARD_GRAPHS):
        assert graphs.captures == len(graphs) == 0 and not graphs._entries


def test_eager_then_capture_then_replay_with_fresh_outputs(tiny, fake_card):
    """Call 1 eager, call 2 captured, calls 3-4 replayed; every call equals
    the eager bodies on its own rows, and no output changes under a later
    call."""
    order = [0, 1, 2, 0]
    got = [_graphed(tiny, tiny["batches"][i]) for i in order]
    assert model_api.FLOW_GRAPHS.captures == model_api.FORWARD_GRAPHS.captures == 1
    for (flow, outs), i in zip(got, order):
        assert flow["input_G_tsf_bg"] is None
        assert _same((flow, outs), tiny["eager"][i])
    assert not _same(got[0][1], got[1][1])  # the rows differ, so do the images


def _forward(t, gen, i, tcfg=None):
    flow = t["eager"][i][0]
    return model_api.forward_only(gen, flow, t["batches"][i], tcfg or t["tcfg"])


def test_in_place_weights_are_read_live(tiny, fake_card):
    gen = build_generator(tiny["tcfg"], device="cpu", seed=1).eval()
    for i in (0, 1, 2):
        _forward(tiny, gen, i)
    with torch.no_grad():
        next(gen.parameters()).mul_(1.5)
    want = model_api.forward_eager(gen, tiny["eager"][0][0], tiny["batches"][0], tiny["tcfg"])
    assert _same(_forward(tiny, gen, 0), want)
    assert model_api.FORWARD_GRAPHS.captures == 1


def _variant(kind, t, gen):
    """(rows, batch, generator, tcfg) of the calls that follow the base calls."""
    batch, tcfg = t["batches"][1], t["tcfg"]
    if kind == "shape":
        batch = model_api.batch_as_torch(
            synthetic_batch(3, t["env"]["obj_verts"], image_size=S, seed=5), "cpu")
    elif kind == "dtype":
        flip = lambda x: x.int() if x.dtype == torch.int64 else x.long()
        batch = dict(batch, **{k: dict(batch[k], obj_id=flip(batch[k]["obj_id"]))
                               for k in ("manoA", "manoB")})
    elif kind == "config":
        tcfg = dataclasses.replace(tcfg, lambda_rec=5.0)
    elif kind == "training":
        gen.train()
    elif kind == "replaced":
        conv = next(m for m in gen.modules() if isinstance(m, torch.nn.Conv2d))
        conv.weight = torch.nn.Parameter(conv.weight.detach() * 2)
    return batch, gen, tcfg


# captures after the first and the second call of the variant: a new
# signature runs eagerly first, a replaced weight captures at once
@pytest.mark.parametrize("kind, want", [
    ("same", (1, 1)), ("shape", (1, 2)), ("dtype", (1, 2)), ("config", (1, 2)),
    ("training", (1, 2)), ("replaced", (2, 2))])
def test_signature(tiny, fake_card, kind, want):
    """Same inputs, same graph; another shape, dtype, configuration or mode is
    a new signature; a replaced weight captures again."""
    gen = build_generator(tiny["tcfg"], device="cpu", seed=2).eval()
    flow_kind = kind in ("same", "shape", "dtype")
    seen = []
    if flow_kind:
        for _ in range(2):
            model_api.flow_only(tiny["batches"][0], tiny["env"], tiny["ccfg"])
        batch = _variant(kind, tiny, gen)[0]
        want_flow = model_api.flow_eager(batch, tiny["env"], tiny["ccfg"])
        for _ in range(2):
            assert _same(model_api.flow_only(batch, tiny["env"], tiny["ccfg"]), want_flow)
            seen.append(model_api.FLOW_GRAPHS.captures)
    else:
        for _ in range(2):
            _forward(tiny, gen, 0)
        _, gen, tcfg = _variant(kind, tiny, gen)
        flow, batch = tiny["eager"][1][0], tiny["batches"][1]
        want_outs = model_api.forward_eager(gen, flow, batch, tcfg)
        for _ in range(2):
            assert _same(model_api.forward_only(gen, flow, batch, tcfg), want_outs)
            seen.append(model_api.FORWARD_GRAPHS.captures)
    assert tuple(seen) == want


def test_least_recently_called_signature_goes_first(fake_card):
    graphs = call_graphs.CallGraphs("toy")
    calls = lambda n: graphs(lambda x: x * 2, (torch.ones(n),), key="k", live=[])
    for n in range(1, call_graphs.KEEP + 1):
        calls(n), calls(n)
    assert graphs.captures == len(graphs) == call_graphs.KEEP
    calls(1)  # a replay: 1 is now the most recent
    calls(call_graphs.KEEP + 1)  # a new signature: 2 goes
    assert len(graphs) == call_graphs.KEEP - 1
    calls(1)
    assert graphs.captures == call_graphs.KEEP
    calls(2)
    assert graphs.captures == call_graphs.KEEP  # eager again: 2 was forgotten


def test_a_replay_counts_its_launches_once(fake_card):
    """Only a launch counts: the eager call's, and the capturing call's
    warm-up; its capture pass and every replay count nothing. A call's
    launches are read from an eager call, a replay's from the device trace."""
    graphs = call_graphs.CallGraphs("toy")

    def body(x):
        _cuda.count_launch("toy_kernel")
        return x + 1

    _cuda.reset_launch_counts()
    seen = []
    for _ in range(4):
        graphs(body, (torch.zeros(3),), key="k", live=[])
        seen.append(_cuda.launch_counts())
    assert seen == [{"toy_kernel": 1}] + [{"toy_kernel": 2}] * 3
    assert graphs.captures == 1
    _cuda.reset_launch_counts()


def test_no_capture_without_cuda():
    """On the CPU nothing is captured: every wrapper's launch counts."""
    assert not _cuda.capturing()
    _cuda.reset_launch_counts()
    _cuda.count_launch("toy_kernel")
    assert _cuda.launch_counts() == {"toy_kernel": 1}
    _cuda.reset_launch_counts()


def test_a_failed_capture_names_its_operation(monkeypatch, fake_card):
    """The message names the line that broke the capture, not the capture's
    end that failed after it."""

    def failing(fn, structure, inputs):
        try:
            raise RuntimeError("operation not permitted when stream is capturing")
        finally:
            raise RuntimeError("operation failed due to a previous error during capture")

    monkeypatch.setattr(call_graphs, "_capture", failing)
    graphs = call_graphs.CallGraphs("toy")
    graphs(lambda x: x, (torch.ones(1),), key="k", live=[])
    with pytest.raises(RuntimeError, match=r"capture of toy failed at .*test_torch_call_graphs"
                                           r"\.py:\d+ `raise RuntimeError\(\"operation not "
                                           r"permitted.*: operation not permitted"):
        graphs(lambda x: x, (torch.ones(1),), key="k", live=[])


@pytest.mark.parametrize("change", ["in place", "assigned", "data", "view", "buffer",
                                    "submodule"])
def test_live_specs_see_a_replaced_tensor(change):
    """An in-place write keeps the specs; a tensor replaced in any way moves
    them, the walk included (it is cached between registrations)."""
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    specs = call_graphs.live_specs(call_graphs.module_tensors(net))
    assert call_graphs.module_tensors(net) is call_graphs.module_tensors(net)
    with torch.no_grad():
        if change == "in place":
            net[0].weight.mul_(2)
        elif change == "assigned":
            net[0].bias = torch.nn.Parameter(torch.zeros(4))
        elif change == "data":
            net[0].weight.data = net[0].weight.data.clone()
        elif change == "view":
            net[0].weight.data = net[0].weight.data[:2]
        elif change == "buffer":
            net[1].running_mean = torch.zeros(4)
        else:
            net[0] = torch.nn.Linear(3, 4)
    moved = call_graphs.live_specs(call_graphs.module_tensors(net))
    assert (moved == specs) == (change == "in place")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_hoisted_constants_match_their_literals(dtype):
    rng = np.random.RandomState(0)
    pts = torch.as_tensor(rng.randn(2, 7, 3), dtype=dtype)
    cam = torch.as_tensor(rng.randn(2, 15), dtype=dtype)
    flipped = pts * torch.tensor([1.0, -1.0, -1.0], dtype=dtype)
    got = projection.orthographic_proj_withz_idrot(pts, cam)
    assert torch.equal(got[..., 2:], flipped[..., 2:])
    assert torch.equal(projection.constant((1.0, -1.0, -1.0), dtype, "cpu"),
                       torch.tensor([1.0, -1.0, -1.0], dtype=dtype))
    view = projection.to_view_space(pts)
    assert torch.equal(view, pts * torch.tensor([1.0, -1.0, 1.0], dtype=dtype)
                       + torch.tensor([0.0, 0.0, projection.HOGAN_EYE_Z], dtype=dtype))
    eye = (0.0, 0.0, -projection.HOGAN_EYE_Z)
    assert torch.equal(projection.look_at(pts, eye)[..., 2],
                       pts[..., 2] - torch.tensor(eye[2], dtype=dtype))
    assert torch.equal(projection.constant((0.0, 0.0, 0.0, 1.0), dtype, "cpu"),
                       torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype))
    ids = projection.constant(mano_mod.FINGERTIP_VERT_IDS, torch.long, "cpu")
    verts = torch.as_tensor(rng.randn(2, 778, 3), dtype=dtype)
    assert torch.equal(verts[:, ids, :], verts[:, list(mano_mod.FINGERTIP_VERT_IDS), :])
    cond = torch.as_tensor(rng.rand(2, 3, 5, 5) * (rng.rand(2, 3, 5, 5) > 0.3), dtype=dtype)
    uv = cond[:, :2]
    mean = torch.tensor(renderer.ATLAS_MEAN, dtype=dtype)[None, :, None, None]
    scale = torch.tensor([0.8, 2.0], dtype=dtype)[None, :, None, None]
    nonzero = (uv != 0).to(dtype)
    assert torch.equal(renderer.sample_from_texture(cond),
                       nonzero * (uv - mean) * scale + (1.0 - nonzero) * (-2.0))


def test_mano_and_coords_after_hoisting():
    """mano_forward's joints against the fingertips taken by a list, and the
    shared barycentric grid against the numpy one it replaced."""
    params = mano_mod.MANOModel.synthetic(0).as_torch("cpu")
    rng = np.random.RandomState(1)
    f = lambda *s: torch.as_tensor(rng.randn(*s) * 0.3, dtype=torch.float32)
    out = mano_mod.mano_forward(params, f(2, 3), f(2, 45), f(2, 10))
    tips = out["vertices"][:, list(mano_mod.FINGERTIP_VERT_IDS), :]
    assert torch.equal(out["joints"][:, 16:], tips)
    for t in (1, 2, 3):
        step = 1.0 if t == 1 else 1.0 / (t - 1)
        ab = np.arange(0, 1 + step, step, dtype=np.float32)
        xv, yv = np.meshgrid(ab, ab, indexing="ij")
        want = torch.as_tensor(np.stack([xv.ravel(), yv.ravel()], axis=0))
        assert torch.equal(renderer.create_coords(t, device="cpu"), want)


def test_a_constant_first_made_under_inference_mode_can_be_saved():
    with torch.inference_mode():
        c = projection.constant((3.0, -0.25), torch.float32, "cpu")
    x = torch.ones(2, requires_grad=True)
    (x * projection.constant((3.0, -0.25), torch.float32, "cpu")).sum().backward()
    assert c is projection.constant((3.0, -0.25), torch.float32, "cpu")
    assert torch.equal(x.grad, torch.tensor([3.0, -0.25]))
