#!/usr/bin/env python3
"""Kernel-level profile of the port's training step or serving call on the
card (the counterpart of scripts/profile_step.py, which reads an XLA trace).

Builds the program chip_smoke.py times: the synthetic environment, the
flagship generator_spade_attn (conv_dim 64, repeat 6, 256 px) with
PatchGAN-4 and the VGG19 loss, and `make_train_step` (--leg train) or
`flow_only` + `forward_only` (--leg fwd), with the remat the drivers pick
for the dtype (train_config_from_opt: full remat in fp32; under bf16 the
bottleneck and attention kept) unless --no_remat or --remat_bottleneck say
otherwise. After warm-up it runs --steps steps in ONE torch.profiler window
and prints device busy ms against wall ms, device kernels per step, device
ms by operator class and by hand-written kernel, the top 20 kernels, the
10 longest idle gaps of the device timeline with the host ops that were
running when each opened, the launch counters per step and the peak device
memory; then one JSON line of the same numbers.

    python scripts/profile_step_torch.py --dtype fp32 --engine gather --batch 8
    python scripts/profile_step_torch.py --dtype bf16 --engine pallas --leg fwd
    python scripts/profile_step_torch.py --time_only   # CUDA events, no profiler

--engine auto (the default) is the drivers' pick: shift under bf16, gather
under fp32; pallas is the fused engine. Everything runs on the card unless
--device cpu, which skips the profiler and times the host only (small
--image_size / --conv_dim / --repeat_num for a rehearsal): a CPU run
reports no device number.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the keys of the JSON line (tests/test_torch_tools.py holds the line to them)
JSON_KEYS = ("tool", "leg", "dtype", "engine", "batch", "image_size", "conv_dim", "repeat_num",
             "remat", "tf32", "steps", "device", "card", "step_ms", "wall_ms", "device_busy_ms",
             "busy_share", "kernels_per_step", "classes", "hand_written", "top_kernels",
             "idle_gaps", "launches_per_step", "peak_mem_mib")


def card_line() -> str | None:
    """`nvidia-smi`'s name and power limit of the first card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None


def train_config(dtype: str, engine: str, image_size: int = 256, conv_dim: int = 64,
                 repeat_num: int = 6, no_remat: bool = False, remat_bottleneck: bool = False):
    """The drivers' TrainConfig (train_config_from_opt) for the synthetic
    HOv3 setup with --use_spade --use_vgg --mask_bce."""
    from hoig_torch.train.environment import train_config_from_opt

    opt = types.SimpleNamespace(
        dataset_mode="synthetic", gen_name="generator_spade_attn", use_spade=True,
        bf16=dtype == "bf16", no_remat=no_remat, remat_bottleneck=remat_bottleneck,
        corner_engine=engine, image_size=image_size, repeat_num=repeat_num, conv_dim=conv_dim,
        norm_type="instance", use_vgg=True, mask_bce=True)
    return train_config_from_opt(opt)


def build_program(tcfg, batch_size: int, device, env=None, train: bool = True):
    """The environment, a batch and the program on `device`: dict(env, ccfg,
    batch, gen, serve, state, step), `serve()` being one serving call and
    `step()` one training step with D trained (without `train`, only the
    generator is built and state / step are None). Weights from seed 0 (G),
    1 (D) and 2 (VGG), as chip_smoke.py draws them."""
    from hoig_torch.data.synthetic import synthetic_batch, synthetic_environment
    from hoig_torch.geometry.conditioning import ConditioningConfig
    from hoig_torch.models.vgg import init_vgg
    from hoig_torch.train.model_api import batch_as_torch, flow_only, forward_only
    from hoig_torch.train.trainer import (build_generator, build_networks, init_state,
                                          make_train_step)

    s = tcfg.image_size
    env = env or synthetic_environment(2, s, device=device)
    ccfg = ConditioningConfig(image_size=s)
    batch = batch_as_torch(synthetic_batch(batch_size, env["obj_verts"], image_size=s), device)
    prog = dict(env=env, ccfg=ccfg, batch=batch, state=None, step=None)
    if train:
        state = init_state(*build_networks(tcfg, device=device, seed=0), tcfg)
        vgg = init_vgg(seed=2, compute_dtype=tcfg.compute_dtype, device=device)
        train_step = make_train_step(vgg, env["tables"], env["mano_params"], ccfg, tcfg)
        prog.update(state=state, gen=state.g, step=lambda: train_step(state, batch, True))
    else:
        prog["gen"] = build_generator(tcfg, device=device, seed=0)
    prog["serve"] = lambda: forward_only(prog["gen"], flow_only(batch, env, ccfg), batch, tcfg)
    return prog


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--engine", default="auto", choices=["auto", "shift", "gather", "pallas"],
                   help="attention corner engine; auto: shift under bf16, gather under fp32")
    p.add_argument("--leg", default="train", choices=["train", "fwd"])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--steps", type=int, default=3, help="steps in the profiler window")
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--out", default=None, help="write the profiler's table to DIR/profile.txt (parsing the trace "
                        "for it takes about a minute for the fp32 batch-8 step)")
    p.add_argument("--time_only", action="store_true",
                   help="no profiler: wall ms and CUDA-event ms of 10 steps")
    p.add_argument("--no_remat", action="store_true")
    p.add_argument("--remat_bottleneck", action="store_true",
                   help="full remat under bf16 as well")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--conv_dim", type=int, default=64)
    p.add_argument("--repeat_num", type=int, default=6)
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def _host_ms(fn, device) -> float:
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return (time.perf_counter() - t0) * 1e3


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch

    from hoig_torch.ops import _cuda
    from hoig_torch.utils.profiling import profile_window, span_ms

    device = _cuda.resolve_device(args.device)
    on_card = device.type == "cuda"
    tcfg = train_config(args.dtype, args.engine, args.image_size, args.conv_dim, args.repeat_num,
                        args.no_remat, args.remat_bottleneck)
    card = card_line() if on_card else None
    remat = dict(remat=tcfg.remat, remat_bottleneck=tcfg.remat_bottleneck,
                 remat_attn=tcfg.remat_attn)
    print(f"profile_step_torch: leg {args.leg}, {args.dtype}, engine {tcfg.corner_engine}, batch "
          f"{args.batch}, {args.image_size} px, conv_dim {args.conv_dim}, repeat "
          f"{args.repeat_num}, {remat}; device {device}"
          + (f" ({torch.cuda.get_device_name(0)}; {card})" if on_card else ""), flush=True)
    t0 = time.perf_counter()
    prog = build_program(tcfg, args.batch, device, train=args.leg == "train")
    run = prog["step"] if args.leg == "train" else prog["serve"]
    print(f"  built in {time.perf_counter() - t0:.1f} s", flush=True)
    step_ms = [_host_ms(run, device) for _ in range(args.warmup)]
    print(f"  warm-up steps (host ms, the first builds the kernels): "
          f"{', '.join(f'{t:.1f}' for t in step_ms)}", flush=True)

    res = dict(tool="profile_step_torch", leg=args.leg, dtype=args.dtype,
               engine=tcfg.corner_engine, batch=args.batch, image_size=args.image_size,
               conv_dim=args.conv_dim, repeat_num=args.repeat_num, remat=remat,
               tf32=dict(cudnn=torch.backends.cudnn.allow_tf32,
                         matmul=torch.backends.cuda.matmul.allow_tf32), steps=args.steps,
               device=torch.cuda.get_device_name(0) if on_card else "cpu",
               card=card, step_ms=step_ms)
    res.update({k: None for k in JSON_KEYS if k not in res})
    unit = "step" if args.leg == "train" else "call"
    if args.time_only or not on_card:
        wall = [_host_ms(run, device) for _ in range(10 if args.time_only else args.steps)]
        res["wall_ms"] = statistics.median(wall)
        line = f"  {unit}: wall {res['wall_ms']:.2f} ms (median of {len(wall)}, host clock)"
        if on_card:
            ev = [span_ms(run) for _ in range(10)]
            res["event_ms"] = statistics.median(ev)
            line += f", CUDA-event span {res['event_ms']:.2f} ms (median of {len(ev)})"
        else:
            line += "; device numbers not measured (no card)"
        print(line)
    else:
        if args.out:
            os.makedirs(args.out, exist_ok=True)
        region = "hoig_train" if args.leg == "train" else "hoig_serve"
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launch_counts()
        prof = profile_window({region: (run, args.steps)}, args.out, top=20).get(region)
        counts = _cuda.launch_counts()
        res["launches_per_step"] = {k: v // args.steps for k, v in sorted(counts.items())}
        res["peak_mem_mib"] = torch.cuda.max_memory_allocated() / 2**20
        if prof is None:
            print("  device numbers not measured: the profiler reported no device time")
        else:
            res.update(wall_ms=prof["wall_ms"], device_busy_ms=prof["device_ms"],
                       busy_share=prof["busy_share"], kernels_per_step=prof["kernels_per_call"],
                       classes=prof["classes"], hand_written=prof["hand_written"],
                       top_kernels=prof["kernels"][:20], idle_gaps=prof["idle_gaps"])
            print("  hand-written kernels per " + unit + ": " + "; ".join(
                f"{k} {v['ms']:.3f} ms x{v['count']}" for k, v in prof["hand_written"].items()))
            print(f"  the {len(prof['idle_gaps'])} longest idle gaps of the device (ms, the host "
                  "ops running when each opened, innermost last; the next host op to begin):")
            for g in prof["idle_gaps"]:
                print(f"    {g['ms']:8.3f}  {' > '.join(g['host'][-3:]) or '(between host ops)'}"
                      f"; next: {g['next']}")
        print(f"  launch counters per {unit}: {res['launches_per_step']}; peak device memory "
              f"{res['peak_mem_mib']:.0f} MiB")
    print(json.dumps(res, default=str), flush=True)
    return res


if __name__ == "__main__":
    main()
