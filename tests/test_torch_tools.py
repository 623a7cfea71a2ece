"""The port's measuring tools on the CPU (torch only; no JAX function runs):
the FLOP walk of hoig_torch/utils/flops.py against FlopCounterMode on the
port's own modules and against the JAX package's scripts/flops_ceiling.py
(loaded by path: it imports no JAX), the profiler aggregation of
hoig_torch/utils/profiling.py on a hand-made event list, and the three
scripts scripts/profile_step_torch.py, attn_ab_torch.py and
flops_ceiling_torch.py at small sizes."""

import contextlib
import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch

from hoig_torch.data.synthetic import synthetic_batch, synthetic_environment
from hoig_torch.geometry.conditioning import ConditioningConfig
from hoig_torch.models.generator import ExtractorAttn
from hoig_torch.models.vgg import init_vgg
from hoig_torch.ops import attn_fused as af
from hoig_torch.train import trainer
from hoig_torch.train.model_api import batch_as_torch, forward_only
from hoig_torch.train.trainer import (TrainConfig, build_generator, build_networks, init_state,
                                      make_train_step)
from hoig_torch.utils import flops, profiling

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import attn_ab_torch  # noqa: E402
import flops_ceiling_torch  # noqa: E402
import profile_step_torch  # noqa: E402

torch.set_num_threads(1)

S, CD, REPEAT = 64, 8, 2  # the small config: conv_dim 8, repeat 2, 64 px, batch 1


def _jax_walk():
    spec = importlib.util.spec_from_file_location("jax_flops_ceiling",
                                                  ROOT / "scripts" / "flops_ceiling.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def env():
    """The synthetic environment at 64 px, a batch of 1 and its conditioning
    (computed once, uncounted: the walk leaves the conditioning out)."""
    e = synthetic_environment(2, S, device="cpu")
    ccfg = ConditioningConfig(image_size=S)
    batch = batch_as_torch(synthetic_batch(1, e["obj_verts"], image_size=S), "cpu")
    flow = trainer._conditioning(e["tables"], e["mano_params"], batch, ccfg)
    return dict(env=e, ccfg=ccfg, batch=batch, flow=flow)


@contextlib.contextmanager
def stood_in_b4(calls: dict):
    """The four B4 wrappers replaced by stand-ins that return zeros of the
    right shapes with no aten product (on the card they are ctypes launches,
    which FlopCounterMode cannot see; on the CPU their plain versions would
    run convolutions), each call counted under its wrapper's name."""
    z = torch.zeros

    def count(name, fn):
        def stand_in(*a):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a)
        return stand_in

    fakes = dict(
        attn_fused_fwd=lambda src, acc0, *a: (src.clone(), acc0.float().clone(),
                                              z(*src.shape[:3], flops.K2)),
        attn_fused_bwd_c=lambda src, *a: (z(src.shape), z(*src.shape[:3], flops.K2)),
        attn_fused_bwd_a_gsrc=lambda g, *a: (z(*g.shape[:3], a[-1].shape[1]),
                                             z(g.shape[0], g.shape[1] + 6, g.shape[2] + 6, flops.FC)),
        attn_fused_bwd_a_dw=lambda src, dg: z(flops.K2, src.shape[3], flops.FC))
    saved = {k: getattr(af, k) for k in fakes}
    for k, fn in fakes.items():
        setattr(af, k, count(k, fn))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(af, k, fn)


def _launches(cfg, leg):
    return {k: len(v) for k, v in flops.kernel_launches(cfg, 1, leg).items()}


# ------------------------------------------------------- (a) walk vs counter


@pytest.mark.parametrize("engine", ["shift", "gather", "pallas"])
def test_walk_matches_flop_counter_attention(engine):
    """One ExtractorAttn layer per engine, forward and backward (gradients
    into source, target and the fc weights, as in the generator): the aten
    part the walk gives it; the fused engine's kernel calls as its
    launches."""
    b, h, c = 1, 8, 16
    layer = ExtractorAttn(c, 5, engine)
    gen = torch.Generator().manual_seed(0)
    src, tgt = (torch.randn(b, h, h, c, generator=gen).requires_grad_(True) for _ in range(2))
    flow = torch.rand(b, h, h, 2, generator=gen) * 4.99 - 3.0
    calls = {}
    with stood_in_b4(calls):
        _, fwd = flops.aten_flops(lambda: layer(src, tgt, flow))
        out = layer(src, tgt, flow)
        _, bwd = flops.aten_flops(lambda: out.sum().backward())
    ops = flops.attn_ops(b, h, c, engine, False)
    assert (fwd, bwd) == (sum(op.fwd for op in ops), sum(op.bwd for op in ops))
    if engine == "pallas":
        assert calls == {"attn_fused_fwd": 2, "attn_fused_bwd_c": 1, "attn_fused_bwd_a_gsrc": 1,
                         "attn_fused_bwd_a_dw": 1}


def test_walk_matches_flop_counter_serving(env):
    """The generator's forward (a serving call's aten part) at the small
    config counts as the walk says."""
    cfg = TrainConfig(conv_dim=CD, repeat_num=REPEAT, image_size=S, corner_engine="shift")
    g = build_generator(cfg, device="cpu", seed=0)
    _, counted = flops.aten_flops(lambda: forward_only(g, env["flow"], env["batch"], cfg))
    walk = flops.leg_flops(cfg, 1, "serve")
    assert counted == sum(v["model"] for v in walk["aten"].values())


def test_walk_matches_flop_counter_step(env, monkeypatch):
    """PatchGAN-4 and Vgg19Features forward, then one training step (D
    trained) with the fused engine and the fp32 remat defaults (full
    remat), its conditioning stood in by the fixture's outputs on the same
    batch and its kernels by shape-only fakes: the walk's executed FLOPs
    (the recompute counted, the SPADE residual blocks' conv_1 left out of
    it), and the fakes' calls equal to the walk's launches (B4-fwd twice
    per layer: once more in the recompute). The shift engine's step is held
    the same way on the card (chip_smoke.py phase 12)."""
    cfg = TrainConfig(conv_dim=CD, repeat_num=REPEAT, image_size=S, corner_engine="pallas")
    state = init_state(*build_networks(cfg, device="cpu", seed=0), cfg)
    vgg = init_vgg(seed=2, device="cpu")
    with torch.no_grad():
        _, d_count = flops.aten_flops(lambda: state.d(torch.zeros(1, S, S, cfg.d_input_nc)))
        _, v_count = flops.aten_flops(lambda: vgg(torch.zeros(1, S, S, 3)))
    assert d_count == sum(op.fwd for op in flops.patchgan_ops(1, S, cfg.d_input_nc))
    assert v_count == sum(op.fwd for op in flops.vgg19_ops(1, S, False))

    step = make_train_step(vgg, env["env"]["tables"], env["env"]["mano_params"], env["ccfg"], cfg)
    monkeypatch.setattr(trainer, "_conditioning", lambda *a: env["flow"])
    calls = {}
    with stood_in_b4(calls):
        _, counted = flops.aten_flops(lambda: step(state, env["batch"], True))
    walk = flops.leg_flops(cfg, 1, "train")
    executed = sum(v["executed"] for v in walk["aten"].values())
    assert counted == executed > sum(v["model"] for v in walk["aten"].values())
    n = 3 + REPEAT
    assert calls == _launches(cfg, "train") == {
        "attn_fused_fwd": 2 * n, "attn_fused_bwd_c": n, "attn_fused_bwd_a_gsrc": n,
        "attn_fused_bwd_a_dw": n}


# ------------------------------------------- (b) against the JAX package's walk


def _macs(ops):
    return sum(op.fwd for op in ops) / 2


def test_walk_against_jax_flops_ceiling_at_flagship_size():
    """At 256 px, conv_dim 64, repeat 6 the port's walk counts what the JAX
    script counts wherever both walk the same layers (called with the port's
    input widths: img_dim 3, obj_dim 3, bg_dim 8, where the JAX script's main
    passes 6, 15 and 9). Each difference is named and is exactly this term:
      * a stride-2 transposed 3x3 convolution: JAX counts it as a
        convolution at twice the resolution (x4, XLA's dilated input), the
        port as cuDNN runs it, over its input grid;
      * the hand branch's heads: the port runs the RGB, hand and background
        heads as one 7x7 convolution of [x, y] (2 x conv_dim in) to 5
        channels, the zero y block of the first four included;
      * VGG19: Vgg19Features stops at the 13th convolution (the loss's last
        slice); JAX's walk runs all 16;
      * PatchGAN: both packages build n_layers 4, JAX's walk counts
        n_layers 3 with its last two convolutions on S/8 grids; the port's
        fourth stride-2 convolution ends at S/16 and its two stride-1 4x4
        convolutions shrink the grid by one each;
      * attention (shift engine, hand-written kernels included): fc_0's
        source half over the (s+6)^2 halo grid, and the acc combine over the
        7 x 7 corner shifts of G (128 channels, 49 shifts), which JAX's walk
        leaves out; its output FMAs are the output combine's."""
    jw = _jax_walk()
    cm = jw.conv_macs
    s, cd, rep = 256, 64, 6
    ups = sum(cm(s >> k, s >> k, cd << k, cd << (k - 1), 3) for k in (3, 2, 1))

    assert _macs(flops.resnet_ops(1, s, 8, cd, rep, False, False)) == \
        jw.resnet_macs(s, cd, rep, 8) - 3 * ups
    assert _macs(flops.resunet_ops(1, s, 3, 12, cd, rep, True, False, False)) == \
        jw.resunet_macs(s, cd, rep, 3, cond_ch=12, on_obj=True) - 3 * ups
    assert _macs(flops.resunet_ops(1, s, 3, 3, cd, rep, False, False, False)) == \
        jw.resunet_macs(s, cd, rep, 3, cond_ch=3) - 3 * ups + s * s * cd * 5 * 49

    assert _macs(flops.vgg19_ops(1, s, False)) == \
        jw.vgg19_macs(s) - 3 * cm(s // 16, s // 16, 512, 512, 3)

    jax_tail = cm(s // 8, s // 8, 256, 512, 4) + cm(s // 8, s // 8, 512, 1, 4)
    port_tail = (cm(s // 8, s // 8, 256, 512, 4, 2) + (s // 16 - 1) ** 2 * 512 * 512 * 16
                 + (s // 16 - 2) ** 2 * 512 * 1 * 16)
    assert _macs(flops.patchgan_ops(1, s, 19)) == jw.patchgan_macs(s) - jax_tail + port_tail

    cfg = TrainConfig(conv_dim=cd, repeat_num=rep, image_size=s, corner_engine="shift",
                      compute_dtype=torch.bfloat16)
    layers = flops.attn_layers(s, cd, rep)
    port = _macs(op for h, c in layers for op in flops.attn_ops(1, h, c, "shift", False))
    port += sum(f for v in flops.kernel_launches(cfg, 1, "serve").values() for f, _ in v) / 2
    halo_and_acc = sum(((h + 6) ** 2 - h * h) * c * 128 * 25 + h * h * 128 * 49 for h, c in layers)
    assert port == jw.attn_macs(s, cd) + halo_and_acc


def test_fused_cost_is_the_b4_product():
    """B4's 5x5 product over the halo grid: 223.4 GFLOP per step's nine
    layers at batch 4, executed three times by the bf16 gsrc and dW kernels
    and once in their model FLOPs."""
    cfg = TrainConfig(conv_dim=64, repeat_num=6, image_size=256, corner_engine="pallas",
                      compute_dtype=torch.bfloat16, remat=False)
    k = flops.leg_flops(cfg, 4, "train")["kernels"]
    product = sum(2.0 * 4 * (h + 6) ** 2 * 25 * c * 128 for h, c in flops.attn_layers(256, 64, 6))
    assert round(product / 1e9, 1) == 223.4
    for name in ("attn_fused_bwd_a_gsrc_tc", "attn_fused_bwd_a_dw_tc"):
        assert k[name]["launches"] == 9
        assert k[name]["executed"] - k[name]["model"] == pytest.approx(2 * product)
    assert k["attn_fused_fwd_tc"]["executed"] == k["attn_fused_fwd_tc"]["model"] > product


# --------------------------------------------- (c) classifier and idle gaps

EVENTS = [
    ("hoig_step", 0, 200, "host"),
    ("aten::conv2d", 0, 100, "host"),
    ("cudaLaunchKernel", 10, 20, "host"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", 20, 60, "device"),
    ("void combine_fwd_tc_kernel<5>(int, int)", 70, 80, "device"),
    ("void dw_tc_kernel(float const*)", 80, 84, "device"),
    ("void dw_kernel(float const*)", 84, 90, "device"),
    ("aten::copy_", 100, 200, "host"),
    ("Memcpy DtoD (Device -> Device)", 150, 160, "device"),
    ("void at::native::reduce_kernel<512, 1, ReduceOp<float, WelfordOps<float>>>", 162, 166,
     "device"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 166, 170, "device"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3", 170, 171, "device"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>", 171, 172, "device"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>", 172,
     174, "device"),
    ("void mystery()", 174, 176, "device"),
]


def test_kernel_classes_and_hand_written_whole_words():
    assert [profiling.kernel_class(n) for n, _, _, k in EVENTS if k == "device"] == [
        "convolutions (cuDNN)", "hand-written kernels", "hand-written kernels",
        "hand-written kernels", "casts and copies", "InstanceNorm statistics (var_mean)",
        "collectives (NCCL)", "matrix products (cuBLAS)", "matrix products (cuBLAS)",
        "elementwise", "other"]
    hw = profiling.hand_written({n: [e - s, 1] for n, s, e, k in EVENTS if k == "device"}, 1)
    assert hw == {"combine_fwd_tc_kernel": dict(ms=0.01, count=1),
                  "dw_kernel": dict(ms=0.006, count=1), "dw_tc_kernel": dict(ms=0.004, count=1)}


def test_aten_gather_is_not_hand_written():
    """aten's gather kernel holds a hand-written kernel's name inside a
    longer word: it is a gather, not gather_kernel (B3) or scatter_rows."""
    name = "void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*)"
    assert profiling.kernel_class(name) == "gathers, scatters, index ops"
    assert profiling.kernel_class("void (anonymous namespace)::scatter_rows_kernel<float, 4>("
                                  "float const*)") == "hand-written kernels"
    assert profiling.hand_written({name: [5.0, 1]}, 1) == {}


def test_scatter_rows_order_kernels_are_hand_written_whole_words():
    """scatter_rows' order kernels (table_gather.cu) are hand-written, each
    counted under its own name: row_scan_kernel does not count
    row_scan_totals_kernel's launches; the memset of the counts is a copy."""
    names = {
        "void (anonymous namespace)::row_count_kernel(long long const*, int*, unsigned int, int, "
        "unsigned int)": 2,
        "(anonymous namespace)::row_scan_kernel(int const*, int*, int*, int*, int*, int, int)": 2,
        "(anonymous namespace)::row_scan_totals_kernel(int*, int)": 2,
        "(anonymous namespace)::row_place_kernel(long long const*, int*, int const*, int const*, "
        "int*, unsigned int, int, unsigned int)": 2,
        "(anonymous namespace)::segment_sort_kernel(int*, int const*, int const*, int const*, "
        "int const*)": 2,
        "void (anonymous namespace)::scatter_rows_kernel<float, 4>(float const*, int const*)": 2,
    }
    for name in names:
        assert profiling.kernel_class(name) == "hand-written kernels", name
    assert profiling.kernel_class("Memset (Device)") == "casts and copies"
    hw = profiling.hand_written({k: [3.0 * n, n] for k, n in names.items()}, 2)
    assert hw == {k: dict(ms=0.003, count=1) for k in (
        "row_count_kernel", "row_scan_kernel", "row_scan_totals_kernel", "row_place_kernel",
        "segment_sort_kernel", "scatter_rows_kernel")}


def test_idle_gaps_and_region_summary():
    gaps = profiling.idle_gaps(EVENTS, 0, 200, top=3)
    assert [(g["start"], g["ms"]) for g in gaps] == [(90, 0.06), (176, 0.024), (0, 0.02)]
    assert (gaps[0]["host"], gaps[0]["next"]) == (["hoig_step", "aten::conv2d"], "aten::copy_")
    assert (gaps[1]["host"], gaps[1]["next"]) == (["hoig_step", "aten::copy_"], None)
    assert (gaps[2]["host"], gaps[2]["next"]) == (["hoig_step", "aten::conv2d"], "cudaLaunchKernel")
    assert profiling.idle_gaps(EVENTS, 0, 200, top=10)[-1] == dict(
        start=160, ms=0.002, host=["hoig_step", "aten::copy_"], next=None)
    res = profiling.summarize_region(EVENTS, 0, 200, n=2, gaps=2)
    busy = 40 + 10 + 4 + 6 + 10 + 4 + 4 + 1 + 1 + 2 + 2
    assert res["device_ms"] == pytest.approx(busy / 2 / 1e3)
    assert res["wall_ms"] == pytest.approx(0.1)
    assert res["busy_share"] == pytest.approx(busy / 200)
    assert res["kernels_per_call"] == 5
    assert res["classes"]["hand-written kernels"] == pytest.approx(0.01)
    assert res["kernels"][0]["name"].startswith("sm90_xmma")
    assert len(res["idle_gaps"]) == 2
    assert profiling.summarize_region(EVENTS, 180, 200, n=1) is None
    # kernels that overlap count once in the busy share, fully in device_ms
    overlap = [("k1", 0, 60, "device"), ("k2", 20, 40, "device"), ("k3", 50, 80, "device")]
    res = profiling.summarize_region(overlap, 0, 100, n=1)
    assert res["busy_share"] == pytest.approx(0.8)
    assert res["device_ms"] == pytest.approx(0.11)


def test_span_classes_follow_each_kernel_to_its_launch():
    """A device op counts for every span whose host range holds the call
    that launched it (same correlation id), the enclosing span's too."""
    ranges = [("hoig/step", 0, 100), ("hoig/g", 10, 40), ("hoig/g", 60, 70), ("aten::mm", 12, 20)]
    launches = [("cudaLaunchKernel", 12, 1, 0), ("cudaLaunchKernelExC", 30, 2, 0),
                ("cudaMemsetAsync", 50, 3, 0), ("cudaLaunchKernel", 65, 4, 0),
                ("cudaLaunchKernel", 120, 5, 0), ("cudaStreamSynchronize", 66, 6, 0)]
    device = [("sm90_xmma_fprop_implicit_gemm", 20, 60, 1),
              ("void combine_fwd_tc_kernel<5>(int)", 60, 64, 2), ("Memset (Device)", 64, 66, 3),
              ("void at::native::vectorized_elementwise_kernel<4>", 70, 80, 4),
              ("void at::native::vectorized_elementwise_kernel<4>", 130, 140, 5)]
    got = profiling.span_classes(device, launches, ranges, n=2)
    assert set(got) == {"step", "g"}
    assert got["g"] == dict(device_ms=pytest.approx(0.027), ops=1.5, launches=1.5, classes={
        "convolutions (cuDNN)": pytest.approx(0.02), "hand-written kernels": pytest.approx(0.002),
        "elementwise": pytest.approx(0.005)})
    assert got["step"]["ops"] == 2 and got["step"]["launches"] == 2
    assert got["step"]["device_ms"] == pytest.approx(0.028)
    assert got["step"]["classes"]["casts and copies"] == pytest.approx(0.001)


def test_kernel_owners_name_span_node_and_op():
    """Each launch of a named kernel goes to the innermost span open then
    and to the innermost autograd node and aten op on its own thread."""
    device = [("kA", 10, 20, 1), ("kA", 30, 35, 2), ("kB", 40, 50, 3), ("kA", 60, 70, 4)]
    launches = [("cudaLaunchKernel", 5, 1, 7), ("cudaLaunchKernel", 6, 2, 7),
                ("cudaLaunchKernel", 12, 3, 9), ("cudaLaunchKernelExC", 55, 4, 9)]
    host = [("autograd::engine::evaluate_function: MulBackward0", 50, 58, 9),
            ("aten::mul", 54, 56, 9), ("aten::add", 2, 8, 7), ("aten::copy_", 4, 5.5, 7),
            ("aten::mm", 11, 13, 9)]
    ranges = [("hoig/step", 0, 100), ("hoig/g", 3, 7)]
    got = profiling.kernel_owners(device, launches, host, ranges, ["kA", "kB"], n=1)
    assert got["kA"]["ms"] == pytest.approx(0.025)
    assert got["kA"]["owners"] == [["g | - | aten::copy_", pytest.approx(0.01)],
                                   ["step | MulBackward0 | aten::mul", pytest.approx(0.01)],
                                   ["g | - | aten::add", pytest.approx(0.005)]]
    assert got["kB"] == dict(ms=pytest.approx(0.01), owners=[["step | - | aten::mm",
                                                              pytest.approx(0.01)]])


# ------------------------------------------------------ (d), (e) the scripts


def _json_lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_profile_step_torch_on_cpu(capsys):
    res = profile_step_torch.main(["--device", "cpu", "--leg", "fwd", "--image_size", "32",
                                   "--conv_dim", "4", "--repeat_num", "1", "--batch", "1",
                                   "--steps", "1", "--warmup", "1"])
    line = _json_lines(capsys.readouterr().out)[-1]
    assert tuple(line) == profile_step_torch.JSON_KEYS
    assert line == json.loads(json.dumps(res, default=str))
    assert line["device"] == "cpu" and line["engine"] == "shift" and line["wall_ms"] > 0
    # no device number from a CPU run
    assert all(line[k] is None for k in ("device_busy_ms", "busy_share", "kernels_per_step",
                                         "idle_gaps", "peak_mem_mib", "card"))


def test_attn_ab_torch_on_cpu(capsys):
    rows = attn_ab_torch.main(["--device", "cpu", "--image_size", "16", "--conv_dim", "2",
                               "--batch", "1", "--iters", "2", "--engines", "shift,pallas"])
    lines = _json_lines(capsys.readouterr().out)
    assert lines == rows and len(rows) == 6
    assert [(r["shape"], r["layers"]) for r in rows[::2]] == [
        ("(1,8,8,4)", [1]), ("(1,4,4,8)", [2]), ("(1,2,2,16)", [3, 4, 5, 6, 7, 8, 9])]
    for r in rows:
        assert tuple(r) == attn_ab_torch.JSON_KEYS
        assert r["fwd_ms"] is None and r["fwd_bwd_ms"] is None and r["fwd_host_ms"] > 0
        assert r["agree"] == "reference" if r["engine"] == "shift" else r["agree"]["against"] == "shift"


def test_flops_ceiling_torch_walk_only(capsys):
    res = flops_ceiling_torch.main(["--check", ""])
    line = _json_lines(capsys.readouterr().out)[-1]
    assert set(line["legs"]) == {"bf16-shift", "bf16-fused", "fp32-gather"}
    b4 = line["legs"]["bf16-shift"]["b4"]["train"]
    assert line["legs"]["bf16-shift"]["b8"]["train"]["executed"] == pytest.approx(2 * b4["executed"])
    assert b4["per_image"] == pytest.approx(b4["executed"] / 4)
    assert line["check"] == {} and line["card"] == res["card"]


@pytest.mark.parametrize("script", ["profile_step_torch", "attn_ab_torch", "flops_ceiling_torch"])
def test_scripts_need_a_card_unless_told_cpu(script):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sys.modules[script].main([])
