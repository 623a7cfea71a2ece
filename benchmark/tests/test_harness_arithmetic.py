"""The yardstick's arithmetic: the FLOP copy against the port's model count,
the hand-written kernels' bytes and operations against PERF.md's kernel
table at batch 4, and the trace's idle share and breakdown on made-up
events."""

import json

import pytest

from benchmark.lib import flops, roofline, trace
from benchmark.lib.harness import HERE


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["hogan_ho3dv3", "hogan_dexycb"])
@pytest.mark.parametrize("kind,batch", [("train", 32), ("serve", 16), ("train", 4), ("serve", 4)])
def test_flop_copy_is_the_ports_model_count(name, kind, batch):
    from hoig_torch.utils import flops as port_flops

    from benchmark.lib.program import train_config

    cfg = config(name)
    tcfg = train_config(cfg)
    want = port_flops.leg_flops(tcfg, batch, kind)["total"]["model"]
    assert flops.model_flops(cfg, tcfg.corner_engine, batch, kind) == want


def test_flop_walk_at_the_cells():
    assert flops.model_flops(config("hogan_ho3dv3"), "shift", 32, "train") == pytest.approx(82.78455e12, rel=1e-6)
    assert flops.model_flops(config("hogan_ho3dv3"), "shift", 16, "serve") == pytest.approx(12.87495e12, rel=1e-6)
    assert flops.model_flops(config("hogan_dexycb"), "shift", 32, "train") == pytest.approx(83.12875e12, rel=1e-6)


# PERF.md section 6: (engine, dtype, batch) -> wrapper -> launches a
# training step, bytes, FP32 and bf16 tensor-core FLOPs, bound ms
TABLE = {
    ("shift", "bfloat16", 4): {
        "local_combine": (18, 235_487_232, 0.0, 7.98e9, 0.0703),
        "local_combine_bwd_src": (18, 235_487_232, 0.0, 7.98e9, 0.0703),
        "local_combine_bwd_v": (9, 162_582_528, 0.0, 6.60e9, 0.0485),
        "edge_pad_fold": (18, None, 0.0, 0.0, 0.0761),
        "table_gather": (2, None, 0.0, 0.0, 0.0189)},
    ("pallas", "bfloat16", 4): {
        "attn_fused_fwd": (9, None, 2.8e9, 223.4e9, 0.2675),
        "attn_fused_bwd_c": (9, 241_991_680, None, 0.0, 0.0722),
        "attn_fused_bwd_a_gsrc": (9, None, 0.1e9, 670.3e9, 0.6795),
        "attn_fused_bwd_a_dw": (9, None, 0.0, 670.3e9, 0.6778)},
    ("gather", "float32", 8): {
        "scatter_rows": (9, 8_133_541_888, 0.0, 0.0, 2.4279)},
}
ROWS = [(key, w) for key, ws in TABLE.items() for w in ws]


@pytest.mark.parametrize("key,wrapper", ROWS, ids=[f"{k[0]}-{w}" for k, w in ROWS])
def test_roofline_reproduces_the_kernel_table(key, wrapper):
    # the table's scene: 2 synthetic objects, the largest with 76 faces
    engine, dtype, b = key
    cfg = dict(config("hogan_ho3dv3"), image_size=256, compute_dtype=dtype)
    got = roofline.launches(cfg, b, "train", 1538 + 76, engine)[wrapper]
    n, nbytes, f32, tc, bound_ms = TABLE[key][wrapper]
    assert len(got) == n
    if nbytes is not None:
        assert sum(x[0] for x in got) == nbytes
    if f32 is not None:
        assert sum(x[1] for x in got) == pytest.approx(f32, abs=0.05e9)  # one decimal
    assert sum(x[2] for x in got) == pytest.approx(tc, rel=5e-3)
    bound = roofline.bounds(cfg, b, "train", 1538 + 76, engine)[wrapper]
    assert bound * 1e3 == pytest.approx(bound_ms, abs=6e-5)


def test_serving_launches_no_backward_kernel():
    got = roofline.launches(config("hogan_ho3dv3"), 16, "serve", 1614)
    assert sorted(got) == ["local_combine", "table_gather"]
    assert len(got["local_combine"]) == 18
    fused = roofline.launches(config("hogan_ho3dv3"), 16, "serve", 1614, "pallas")
    assert sorted(fused) == ["attn_fused_fwd", "table_gather"]


def test_every_hand_written_kernel_but_the_rasterizer_is_bounded():
    from benchmark.lib import readings

    bounded = {k for ks in roofline.KERNELS.values() for k in ks}
    assert set(readings.KERNELS["hand_written"]) == bounded | set(roofline.UNBOUNDED)


class _Run:
    def __init__(self, kernels, engine="shift"):
        self.cfg, self.batch, self.kind, self.f_max = config("hogan_ho3dv3"), 32, "train", 1614
        self.engine, self.traced_units = engine, 1
        device = [(name, 0.0, us) for name, us in kernels.items()]
        self.events = dict(span=(0.0, 1e9), device=device, host=[])


def test_roofline_share_leaves_out_the_rasterizer_and_refuses_an_unbounded_kernel():
    from benchmark.lib import readings

    bounds = roofline.bounds(config("hogan_ho3dv3"), 32, "train", 1614)
    run = _Run({"combine_fwd_tc_kernel": 1000.0, "raster_kernel": 500.0})
    assert readings.roofline_pct(run) == pytest.approx(
        100.0 * bounds["local_combine"] * 1e6 / 1000.0)
    # a hand-written kernel that no bounded wrapper launches on this engine
    run = _Run({"combine_fwd_tc_kernel": 1000.0, "scatter_rows_kernel": 10.0})
    assert readings.roofline_pct(run) is None
    run = _Run({"conv5_tc_kernel": 1000.0, "fwd_pixel_kernel": 100.0}, engine="pallas")
    assert readings.roofline_pct(run) is not None


def test_idle_share_and_breakdown_of_a_made_up_trace():
    device = [("k1", 10, 30), ("k2", 20, 40), ("k1", 60, 70), ("k3", 95, 100)]
    host = [("step", 0, 100), ("aten::conv", 40, 58), ("aten::add", 72, 90)]
    events = dict(span=(0.0, 100.0), device=device, host=host)
    assert trace.busy_us(device, 0, 100) == 45  # [10, 40] + [60, 70] + [95, 100]
    gaps = trace.idle_gaps(device, host, 0, 100, top=3)
    assert [(g["start"], g["us"]) for g in gaps] == [(70, 25), (40, 20), (0, 10)]
    assert gaps[0]["host"] == ["step"] and gaps[0]["next"] == "aten::add"
    assert gaps[1]["host"] == ["step", "aten::conv"]
    s = trace.summary(events, top=2)
    assert s["busy_s"] == pytest.approx(45e-6) and s["window_s"] == pytest.approx(100e-6)
    assert s["breakdown"]["device_ops"] == [["k1", pytest.approx(30e-6)], ["k2", pytest.approx(20e-6)]]
    assert s["breakdown"]["idle_gaps"][0] == ["step", pytest.approx(25e-6)]
    assert s["breakdown"]["idle_gaps"][1] == ["aten::conv", pytest.approx(20e-6)]


def test_hand_written_names_are_whole_words():
    from benchmark.lib import readings

    got = readings.hand_written_us({"void at::native::vectorized_gather_kernel<4>": 5.0,
                                    "gather_kernel(float const*, int const*)": 2.0,
                                    "dw_tc_kernel<128>": 3.0, "sm90_xmma_fprop_conv": 7.0})
    assert got == {"gather_kernel": 2.0, "dw_tc_kernel": 3.0}
    assert readings.conv_us({"sm90_xmma_fprop_conv": 7.0, "conv5_tc_kernel": 1.0}) == 7.0
