#!/usr/bin/env python3
"""FLOPs of the port's serving call and training step, and the H100's
speed of light for them (the counterpart of scripts/flops_ceiling.py).

Walks the flagship geometry as the port runs it (hoig_torch/utils/flops.py:
generator_spade_attn at conv_dim 64 / repeat 6 / 256 px, PatchGAN-4, the
VGG19 loss; a transposed convolution over its input grid, as cuDNN runs it)
and prints, for each leg (bf16 shift, bf16 fused, fp32 gather; serving call
and training step; batch 4 and 8), FLOPs per call or step and per image by
subnet: the aten part (convolutions and matrix products) and the
hand-written kernels' part (per launch from their formulas, times the
launches), model FLOPs (each operation once) beside executed ones (remat's
recompute and the tensor-core kernels' extra bf16 passes added). Then the
speed of light at the H100 SXM data sheet's peaks (989 TFLOP/s dense bf16,
67 TFLOP/s FP32, 3.35 TB/s, at 700 W) beside the card's name and power
limit ("no card" without one), and one JSON line of these numbers keyed by
leg.

Then it holds the walk against the program on --device (the card unless
--device cpu): for each leg in --check, one serving call and one training
step at --batch under torch.utils.flop_counter.FlopCounterMode (the step's
count less the conditioning's, which the walk leaves out), and on the card
the launch counters against the walk's launches. --check "" skips it (no
device needed). On the CPU the fused leg is not checked: its kernels' plain
versions run there as aten products, which the card's kernels replace.

    python scripts/flops_ceiling_torch.py
    python scripts/flops_ceiling_torch.py --device cpu --image_size 64 --conv_dim 8 \\
        --repeat_num 2 --batch 1
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# leg -> (dtype, corner engine) as profile_step_torch.py names them
LEGS = {"bf16-shift": ("bf16", "shift"), "bf16-fused": ("bf16", "pallas"),
        "fp32-gather": ("fp32", "gather")}
BATCHES = (4, 8)
# the walk and FlopCounterMode count the same aten ops: they must agree to
# this share of the count (rounding of float sums only)
CHECK_REL = 1e-3


def walk(tcfg, batch: int) -> dict:
    """{"serve": ..., "train": ...} of flops.leg_flops at this batch."""
    from hoig_torch.utils import flops

    return {leg: flops.leg_flops(tcfg, batch, leg) for leg in ("serve", "train")}


def speed_of_light_ms(total: dict) -> dict:
    """ms of the executed FLOPs at the bf16 tensor-core peak and at the FP32 peak."""
    from hoig_torch.utils.flops import PEAK_BF16_TC_FLOPS, PEAK_FP32_FLOPS

    return dict(bf16_ms=total["executed"] / PEAK_BF16_TC_FLOPS * 1e3,
                fp32_ms=total["executed"] / PEAK_FP32_FLOPS * 1e3)


def check_leg(tcfg, batch_size: int, device, env=None) -> dict:
    """One serving call and one training step of the program at this batch
    under FlopCounterMode and the launch counters, against the walk. Raises
    if the aten counts differ by more than CHECK_REL of the walk's, or (on
    the card) if a hand-written kernel's launches differ from the walk's
    (with the conditioning's B2 and B3 and the training step's edge-pad
    folds)."""
    import torch
    from profile_step_torch import build_program

    from hoig_torch.ops import _cuda
    from hoig_torch.train.model_api import flow_only
    from hoig_torch.utils import flops

    prog = build_program(tcfg, batch_size, device, env)
    w = walk(tcfg, batch_size)
    on_card = device.type == "cuda"
    prog["serve"]()  # warm-up: the kernels' first build lies outside the counts
    _, cond = flops.aten_flops(lambda: flow_only(prog["batch"], prog["env"], prog["ccfg"]))
    out = {}
    for leg, fn in (("serve", prog["serve"]), ("train", prog["step"])):
        _cuda.reset_launch_counts()
        _, counted = flops.aten_flops(fn)
        if on_card:
            torch.cuda.synchronize()
        launches = _cuda.launch_counts()
        key = "executed" if leg == "train" else "model"
        want = sum(v[key] for v in w[leg]["aten"].values())
        got = counted - cond
        rel = abs(got - want) / want
        if rel > CHECK_REL:
            raise RuntimeError(f"{leg}: FlopCounterMode counts {got:.6g} aten FLOPs (less the "
                               f"conditioning's {cond:.4g}), the walk {want:.6g}")
        row = dict(aten_counted=got, aten_walk=want, rel_diff=rel, conditioning=cond)
        if on_card:
            expect = {k: v["launches"] for k, v in w[leg]["kernels"].items()}
            expect.update(rasterizer=1, table_gather=2)
            if flops.edge_pad_folds(tcfg, leg):
                expect["edge_pad_fold"] = flops.edge_pad_folds(tcfg, leg)
            if flops.scatter_rows_launches(tcfg, leg):
                expect["scatter_rows"] = flops.scatter_rows_launches(tcfg, leg)
            if launches != expect:
                raise RuntimeError(f"{leg}: launches {launches}, the walk's {expect}")
            row["launches"] = launches
            row["kernel_flops"] = sum(v["executed"] for v in w[leg]["kernels"].values())
        out[leg] = row
    del prog
    if on_card:
        torch.cuda.empty_cache()
    return out


def print_walk(name: str, batch: int, legs: dict) -> None:
    for leg, res in legs.items():
        unit = "call" if leg == "serve" else "step"
        tot, sol = res["total"], speed_of_light_ms(res["total"])
        print(f"\n== {name}, {'serving call' if leg == 'serve' else 'training step'}, batch "
              f"{batch}: {tot['model'] / 1e12:.3f} TFLOP model, {tot['executed'] / 1e12:.3f} "
              f"executed per {unit} ({tot['executed'] / batch / 1e12:.3f} per image); speed of "
              f"light {sol['bf16_ms']:.2f} ms at the bf16 peak, {sol['fp32_ms']:.2f} ms at FP32 ==")
        print(f"  {'subnet (aten)':40s} {'GFLOP model':>14s} {'executed':>12s} {'per image':>11s}")
        for sub, v in res["aten"].items():
            print(f"  {sub:40s} {v['model'] / 1e9:14.1f} {v['executed'] / 1e9:12.1f} "
                  f"{v['executed'] / batch / 1e9:11.1f}")
        for k, v in res["kernels"].items():
            print(f"  {'kernel ' + k + ' x' + str(v['launches']):40s} {v['model'] / 1e9:14.1f} "
                  f"{v['executed'] / 1e9:12.1f} {v['executed'] / batch / 1e9:11.1f}")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--conv_dim", type=int, default=64)
    p.add_argument("--repeat_num", type=int, default=6)
    p.add_argument("--batch", type=int, default=4, help="batch of the device check")
    p.add_argument("--check", default=",".join(LEGS),
                   help="legs held against FlopCounterMode on --device ('' for none)")
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from profile_step_torch import card_line, train_config

    from hoig_torch.ops import _cuda
    from hoig_torch.utils.flops import PEAK_BF16_TC_FLOPS, PEAK_BYTES_PER_S, PEAK_FP32_FLOPS

    checks = [leg for leg in args.check.split(",") if leg]
    unknown = set(checks) - set(LEGS)
    if unknown:
        raise ValueError(f"unknown legs {sorted(unknown)}; choose from {list(LEGS)}")
    device = _cuda.resolve_device(args.device) if checks else None
    card = card_line() or "no card"
    print(f"H100 SXM speed of light (NVIDIA data sheet, dense, at 700 W): "
          f"{PEAK_BF16_TC_FLOPS / 1e12:.0f} TFLOP/s bf16, {PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s "
          f"FP32, {PEAK_BYTES_PER_S / 1e12:.2f} TB/s; this machine's card: {card}")
    res = dict(tool="flops_ceiling_torch", card=card, image_size=args.image_size,
               conv_dim=args.conv_dim, repeat_num=args.repeat_num,
               peaks=dict(bf16_flops=PEAK_BF16_TC_FLOPS, fp32_flops=PEAK_FP32_FLOPS,
                          bytes_per_s=PEAK_BYTES_PER_S), legs={}, check={})
    configs = {}
    for name, (dtype, engine) in LEGS.items():
        configs[name] = tcfg = train_config(dtype, engine, args.image_size, args.conv_dim,
                                            args.repeat_num)
        for b in BATCHES:
            legs = walk(tcfg, b)
            print_walk(name, b, legs)
            res["legs"].setdefault(name, {})[f"b{b}"] = {
                leg: dict(model=v["total"]["model"], executed=v["total"]["executed"],
                          per_image=v["total"]["executed"] / b, **speed_of_light_ms(v["total"]),
                          aten={k: x["executed"] for k, x in v["aten"].items()},
                          kernels={k: x["executed"] for k, x in v["kernels"].items()})
                for leg, v in legs.items()}
    env = None
    for name in checks:
        if device.type == "cpu" and LEGS[name][1] == "pallas":
            print(f"\ncheck {name}: not made on the CPU (the fused kernels' plain versions "
                  "run aten products there)")
            continue
        if env is None:
            from hoig_torch.data.synthetic import synthetic_environment

            env = synthetic_environment(2, args.image_size, device=device)
        res["check"][name] = rows = check_leg(configs[name], args.batch, device, env)
        for leg, row in rows.items():
            print(f"\ncheck {name} {leg} at batch {args.batch} on {device}: FlopCounterMode "
                  f"{row['aten_counted'] / 1e9:.3f} GFLOP aten (less the conditioning's "
                  f"{row['conditioning'] / 1e6:.2f} MFLOP), the walk {row['aten_walk'] / 1e9:.3f} "
                  f"(relative difference {row['rel_diff']:.2g})"
                  + (f"; launches {row['launches']} as the walk's, hand-written kernels "
                     f"{row['kernel_flops'] / 1e9:.1f} GFLOP" if "launches" in row else ""))
    print(json.dumps(res, default=str), flush=True)
    return res


if __name__ == "__main__":
    main()
