#!/usr/bin/env python3
"""Per-layer flow-attention engine A/B on the card (the counterpart of
scripts/attn_ab.py).

The flagship generator runs ExtractorAttn at 9 lockstep layers, shapes
(B,128,128,128), (B,64,64,256) and 7 x (B,32,32,512) at conv_dim 64 /
256 px, through one of three corner engines: shift (B1's weighted-shift
kernels), gather (row gathers and matrix products, no hand-written
kernel) and pallas (the fused B4 kernels). For each distinct layer shape
and engine this times the forward, and forward + backward with gradients
w.r.t. source, target, flow and the fc parameters (the JAX script's set;
the generator's flow itself carries no gradient).

Iterations are chained: iteration i+1 takes iteration i's output as its
source (forward: the output times 25, undoing the window mean; backward:
the source and target gradients plus a scalar of the others, scaled to unit
RMS), so none can be skipped or overlapped. Each is timed twice: on the
device by CUDA events with the iteration queued behind a GPU sleep
(torch.cuda._sleep) that outlasts its enqueueing, so that the host's
launch gaps do not count (where an iteration launches more kernels than
the launch queue holds, as the gather engine's do, the host blocks until
the device drains it: the device time is then the stream's span around
the iteration, launch gaps included, and the row says queued: false); and
by the host clock around the iteration and a synchronize (the port is
host-bound, so both matter). Medians are reported. Before timing, the engines are held to agree on the shape in f32
(TF32 off) within chip_smoke.py's engine-comparison bounds: outputs rtol
2e-4 / atol 2e-5, each gradient but the flow's within 2e-4 of its largest
entry + 1e-2 of the largest gradient and 0.15 of its largest entry + 1e-6
of the largest.

    python scripts/attn_ab_torch.py [--batch 4] [--dtype bf16|fp32]
                                    [--engines shift,gather,pallas] [--iters 20]

Prints a markdown table and one JSON line per (shape, engine). Everything
runs on the card unless --device cpu (small --image_size / --conv_dim for
a rehearsal), which times the host only: a CPU run reports no device time.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the keys of each JSON line (tests/test_torch_tools.py holds the lines to them)
JSON_KEYS = ("shape", "layers", "engine", "dtype", "device", "iters", "fwd_ms", "fwd_bwd_ms",
             "fwd_queued", "fwd_bwd_queued", "fwd_host_ms", "fwd_bwd_host_ms",
             "x_layers_fwd_bwd_ms", "agree")


def layer_shapes(image_size: int, conv_dim: int, repeat_num: int = 6) -> list:
    """(layer ids, grid, channels) of the distinct attention layer shapes."""
    from hoig_torch.utils.flops import attn_layers

    out = []
    for i, (h, c) in enumerate(attn_layers(image_size, conv_dim, repeat_num), start=1):
        if out and out[-1][1:] == (h, c):
            out[-1][0].append(i)
        else:
            out.append(([i], h, c))
    return out


def _modules(c: int, engines, dtype, device) -> dict:
    """One ExtractorAttn per engine with the same weights (seed 0), in the
    generator's memory layout."""
    import torch

    from hoig_torch.models.generator import ExtractorAttn
    from hoig_torch.models.layers import init_weights

    mods = {}
    for e in engines:
        m = ExtractorAttn(c, 5, e, dtype)
        init_weights(m, 0)
        mods[e] = m.to(device=device, memory_format=torch.channels_last)
    return mods


def _inputs(b: int, h: int, c: int, device, seed: int = 0):
    """Source, target (B, h, h, C) and a flow in [-3, 2) (the HOGAN bound:
    T in [-2, 1] less the identity grid in [-1, 1))."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    src = torch.randn(b, h, h, c, generator=gen)
    tgt = torch.randn(b, h, h, c, generator=gen)
    flow = torch.rand(b, h, h, 2, generator=gen) * 4.99 - 3.0
    return src.to(device), tgt.to(device), flow.to(device)


def _grads(mod, src, tgt, flow, weight=None):
    """(output, {name: gradient}) of sum(output * weight) w.r.t. source,
    target, flow and the fc parameters (zeros where an engine gives none)."""
    import torch

    leaves = dict(source=src.detach().requires_grad_(True), target=tgt.detach().requires_grad_(True),
                  flow=flow.detach().requires_grad_(True), **dict(mod.named_parameters()))
    out = mod(leaves["source"], leaves["target"], leaves["flow"])
    scalar = (out.float() * weight).sum() if weight is not None else out.float().sum()
    grads = torch.autograd.grad(scalar, list(leaves.values()), allow_unused=True)
    return out, {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}


def engines_agree(mods: dict, src, tgt, flow) -> dict:
    """The engines against the first one in f32 with TF32 off: outputs rtol
    2e-4 / atol 2e-5, gradients leaf by leaf within 2e-4 of the leaf's
    largest entry + 1e-2 of the largest gradient and within 0.15 of it +
    1e-6 of the largest. The flow's gradient is left out: the fused engine
    does not differentiate the flow (nor does the generator need it).
    Raises on a disagreement; returns the worst output error and gradient
    error (of the largest gradient) per engine."""
    import copy

    import torch

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref_name, out = None, {}
        gen = torch.Generator().manual_seed(7)
        weight = torch.randn(src.shape, generator=gen).to(src.device)
        ref = None
        for name, mod in mods.items():
            m32 = copy.deepcopy(mod).float()
            m32.compute_dtype = torch.float32
            o, g = _grads(m32, src.float(), tgt.float(), flow, weight)
            o = o.detach()
            if ref is None:
                ref_name, ref = name, (o, g)
                continue
            ro, rg = ref
            rg = {k: v for k, v in rg.items() if k != "flow"}
            if not torch.allclose(o, ro, rtol=2e-4, atol=2e-5):
                raise RuntimeError(f"{name} vs {ref_name}: outputs differ by "
                                   f"{float((o - ro).abs().max())}")
            tree_max = max(float(v.abs().max()) for v in rg.values())
            worst = 0.0
            for k, r in rg.items():
                e, top = float((g[k] - r).abs().max()), float(r.abs().max())
                if not (e <= 2e-4 * top + 1e-2 * tree_max and e <= 0.15 * top + 1e-6 * tree_max):
                    raise RuntimeError(f"{name} vs {ref_name}: gradient of {k} off by {e} (its "
                                       f"largest entry {top}, the largest gradient {tree_max})")
                worst = max(worst, e / tree_max)
            out[name] = dict(against=ref_name, output_err=float((o - ro).abs().max()),
                             grad_err_of_largest=worst)
        return out
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def time_chain(advance, iters: int, on_card: bool) -> tuple:
    """(median device ms or None, whether it was queued behind the sleep,
    median host ms) of `iters` chained iterations timed each way, after one
    warm-up iteration. Device ms are queued behind a GPU sleep where an
    iteration fits the launch queue, else the stream's span (an upper bound
    that counts the host's launch gaps)."""
    import torch

    from hoig_torch.utils.profiling import queued_ms, span_ms

    def sync():
        if on_card:
            torch.cuda.synchronize()

    advance()
    sync()
    host = []
    for _ in range(iters):
        t0 = time.perf_counter()
        advance()
        sync()
        host.append((time.perf_counter() - t0) * 1e3)
    if not on_card:
        return None, None, statistics.median(host)
    dev, timer = [], queued_ms
    while len(dev) < iters:
        ms = timer(advance)
        if ms is None:  # an iteration outran the sleep: spans throughout
            dev, timer = [], span_ms
            continue
        dev.append(ms)
    return statistics.median(dev), timer is queued_ms, statistics.median(host)


def run(batch: int = 4, dtype: str = "bf16", engines=("shift", "gather", "pallas"),
        iters: int = 20, device="cuda", image_size: int = 256, conv_dim: int = 64) -> list:
    """The rows of the A/B (see the module docstring), one per (shape, engine)."""
    import torch

    from hoig_torch.ops._cuda import resolve_device

    device = resolve_device(device)
    on_card = device.type == "cuda"
    cd = torch.bfloat16 if dtype == "bf16" else torch.float32
    rows = []
    for layers, h, c in layer_shapes(image_size, conv_dim):
        src, tgt, flow = _inputs(batch, h, c, device)
        mods = _modules(c, engines, cd, device)
        agree = engines_agree(mods, src, tgt, flow)
        for name, mod in mods.items():
            state = {"s": src.to(cd)}
            t_c = tgt.to(cd)

            def fwd():
                with torch.no_grad():
                    state["s"] = mod(state["s"], t_c, flow) * 25

            def fwd_bwd():
                _, g = _grads(mod, state["s"], t_c, flow)
                scal = g["flow"].float().mean() + sum(
                    g[k].float().sum() for k, _ in mod.named_parameters())
                nxt = (g["source"] + g["target"]).float() + scal
                state["s"] = (nxt / nxt.square().mean().sqrt().clamp_min(1e-6)).to(cd)

            f_dev, f_q, f_host = time_chain(fwd, iters, on_card)
            state["s"] = src.to(cd)
            b_dev, b_q, b_host = time_chain(fwd_bwd, iters, on_card)
            if not bool(torch.isfinite(state["s"]).all()):
                raise RuntimeError(f"{name} at {(batch, h, h, c)}: the chain went non-finite")
            row = dict(shape=f"({batch},{h},{h},{c})", layers=layers, engine=name, dtype=dtype,
                       device=torch.cuda.get_device_name(0) if on_card else "cpu", iters=iters,
                       fwd_ms=f_dev, fwd_bwd_ms=b_dev, fwd_queued=f_q, fwd_bwd_queued=b_q,
                       fwd_host_ms=f_host, fwd_bwd_host_ms=b_host,
                       x_layers_fwd_bwd_ms=None if b_dev is None else b_dev * len(layers),
                       agree=agree.get(name, "reference"))
            rows.append(row)
            print(json.dumps(row), flush=True)
        del mods
    return rows


def table(rows: list) -> str:
    """Markdown; a device time marked * is the stream's span (the iteration
    did not fit the launch queue behind the sleep), an upper bound."""
    def f(x, queued=True):
        return "not measured" if x is None else f"{x:.3f}" + ("" if queued else "*")

    out = ["| shape | layers | engine | dtype | fwd ms (device) | fwd+bwd ms (device) | fwd ms "
           "(host) | fwd+bwd ms (host) | x layers fwd+bwd ms (device) |", "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(f"| {r['shape']} | {r['layers'][0]}..{r['layers'][-1]} | {r['engine']} | "
                   f"{r['dtype']} | {f(r['fwd_ms'], r['fwd_queued'])} | "
                   f"{f(r['fwd_bwd_ms'], r['fwd_bwd_queued'])} | {f(r['fwd_host_ms'])} | "
                   f"{f(r['fwd_bwd_host_ms'])} | "
                   f"{f(r['x_layers_fwd_bwd_ms'], r['fwd_bwd_queued'])} |")
    return "\n".join(out)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--engines", default="shift,gather,pallas")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--conv_dim", type=int, default=64)
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> list:
    args = parse_args(argv)
    rows = run(args.batch, args.dtype, tuple(args.engines.split(",")), args.iters, args.device,
               args.image_size, args.conv_dim)
    print("\n" + table(rows) + "\n\n(* the stream's span from the iteration's first kernel to its "
          "last, host launch gaps included: the iteration's kernels outnumber the launch queue, "
          "so it could not be queued behind the GPU sleep)")
    return rows


if __name__ == "__main__":
    main()
