"""One run of one cell: set-up, the measured window, an optional traced
stretch, the check against the plain reference, the result line.

Everything a cell is made of is found by name: the cell in BENCHMARK.json,
its configuration in `configs/<config>.json`, its traffic mix in
`traffic/<traffic>.json`, its limits in `limits/<cell>.json` and each metric
it reports in `metrics/<metric>.py` (a module with `read(run) -> float |
None`; None leaves the metric out of the line).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from benchmark.lib import compare, inputs, trace, traffic

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hoig_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as fp:
        return json.load(fp)


def find_cell(bench: dict, name: str) -> dict:
    for wl in bench["workloads"]:
        if wl["name"] == name:
            return wl
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, name: str, trace_on: bool) -> list:
    """The metric entries the cell reports in a run of this kind: the
    end-to-end ones untraced, the per-layer ones traced; an entry without a
    `workloads` key holds for every cell."""
    group = bench["per_layer"] if trace_on else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def metric_reader(name: str, root: Path = HERE):
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as fp:
            fields = fp.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        import os

        hz = os.sysconf("SC_CLK_TCK")
        with open("/proc/stat") as fp:
            btime = next(int(l.split()[1]) for l in fp if l.startswith("btime"))
        return btime + ticks / hz
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """What a run measured: what the metric readers read."""

    def __init__(self, cell, cfg, mix, device):
        self.cell, self.cfg, self.mix, self.device = cell, cfg, mix, device
        self.kind = mix["kind"]
        self.batch = mix["batch"]
        self.setup_s = None
        self.loop = None
        self.events = None  # the traced stretch's raw events
        self.traced_units = 0  # steps or calls in the traced stretch
        self.f_max = 0  # faces per scene (hand and object)
        self.engine = None  # the attention's corner engine
        self.on_card = torch.device(device).type == "cuda"


def device_info(device, count: int = 1) -> dict:
    if torch.device(device).type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=count,
                    memory_peak_bytes=int(torch.cuda.max_memory_allocated()))
    return dict(platform="cpu", kind="cpu", count=count, memory_peak_bytes=None)


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def weights_for(cfg: dict, seed: int, device) -> dict:
    """{"g", "d", "vgg"}: {name: tensor}, drawn from the seed on the device."""
    from benchmark.reference.networks import param_shapes

    shapes = param_shapes(cfg)
    seeds = dict(zip(("g", "d", "vgg"), inputs.sub_seeds(seed, 3)))
    return {k: inputs.make_weights(v, seeds[k], device) for k, v in shapes.items()}


def reference_nets(cfg: dict, weights: dict, prec, device) -> dict:
    from benchmark.reference.networks import build

    nets = build(cfg, prec, device)
    with torch.no_grad():
        for k, net in nets.items():
            for name, p in net.named_parameters():
                p.copy_(weights[k][name])
    return nets


def run_cell(cell: str, seed: int, seconds: float, trace_on: bool, device="cuda",
             root: Path = HERE, bench: dict | None = None, overrides: dict | None = None,
             started: float | None = None, control: bool = False,
             detail: bool = False) -> dict:
    """One run; returns the result line's object. `overrides` (for a run on
    the CPU at a tiny size) updates the configuration's and the mix's keys
    (one that neither has is left out).
    With `control`, the numbers of the reference one precision step down in
    the program's place (result["control"]), and with `detail`, every
    leaf's norms and the widest gaps (result["detail"]): the calibration's
    readings, never a benchmark run's."""
    from benchmark.lib.program import Program

    started = process_start() if started is None else started
    bench = bench or load_json(root.parent / "BENCHMARK.json")
    wl = find_cell(bench, cell)
    cfg = load_json(root / "configs" / f"{wl['config']}.json")
    mix = load_json(root / "traffic" / f"{wl['traffic']}.json")
    limits = load_json(root / "limits" / f"{cell}.json")
    for k, v in (overrides or {}).items():
        for d in (cfg, mix):
            if k in d:
                d[k] = v
                break
    from benchmark.reference.step import check_config

    check_config(cfg)
    traffic.check(mix)
    readers = {m["name"]: (m, metric_reader(m["name"], root))
               for m in cell_metrics(bench, cell, trace_on)}
    run = Run(cell, cfg, mix, device)
    s_assets, s_pool, s_weights, s_order, s_sample = inputs.sub_seeds(seed, 5)

    # ------------------------------------------------------------- set-up
    phases = {"imports": time.time() - started}
    mark = time.time()

    def phase(name):
        nonlocal mark
        traffic._sync(device)
        phases[name] = time.time() - mark
        mark = time.time()

    assets = inputs.make_assets(s_assets, cfg["num_objects"])
    try:
        run.f_max = inputs.NUM_HAND_FACES + max(assets.obj_faces)
        weights = weights_for(cfg, s_weights, device)
        phase("inputs")
        program = Program(cfg, assets, weights, mix["kind"], device)
        run.engine = program.tcfg.corner_engine
        del weights
        phase("program")
        pool = inputs.make_pool(mix["batch"] * mix["pool_batches"], assets, s_pool,
                                cfg["camera_model"], cfg["image_size"], cfg["with_masks"], device)
        order = inputs.RowOrder(mix["batch"] * mix["pool_batches"], mix["batch"], s_order, device)
        phase("pool")
        if mix["kind"] == "train":
            loop = traffic.TrainLoop(mix, program, pool, order, device)
            grads = {}
            first, unwatch = program.watch_generator()

            def after_first_step():
                unwatch()
                grads.update(program.first_grad_norms())
                for key, ts in first.items():  # off the card until the check
                    first[key] = tuple(None if t is None else t.cpu() for t in ts)

            losses = loop.checked(after_first_step)
            w0 = weights_for(cfg, s_weights, device)
            deltas = {k: (p.detach() - w0[k[0]][k[2:]]).norm()
                      for k, p in program.named_params().items()}
            del w0
            prog_res = dict(losses=[tuple(float(x) for x in l) for l in losses],
                            grads={k: None if v is None else float(v) for k, v in grads.items()},
                            deltas={k: float(v) for k, v in deltas.items()},
                            first=(first.get("inputs"), first.get("outputs")))
        else:
            loop = traffic.ServeLoop(mix, program, pool, order, device, s_sample)
            loop.warmup()
        phase("checked steps" if mix["kind"] == "train" else "warm-up calls")
        run.loop = loop
        run.setup_s = time.time() - started
        log("set-up s: " + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()))

        # ------------------------------------------------------------- window
        if run.on_card:
            torch.cuda.reset_peak_memory_stats()  # the window's peak, not set-up's
        if mix["kind"] == "train":
            loop.window(seconds)
        else:
            loop.window(seconds, spans=trace_on)
        dev_info = device_info(device)
        if trace_on:
            if not run.on_card:
                raise SystemExit("a traced run needs the card")
            with trace.profiled() as events:
                run.traced_units = loop.traced()
            run.events = events
            lo, hi = events["span"]
            log(f"traced: {sum(lo <= s <= hi for _, s, _ in events['device']) / run.traced_units:.0f}"
                f" kernels per {'step' if mix['kind'] == 'train' else 'call'}")
        log(f"peak device memory {dev_info['memory_peak_bytes']} B")
        seen = forbidden_modules()

        # ------------------------------------------------ check and report
        checked_rows = loop.checked_rows if mix["kind"] == "train" else [r for r, _, _ in loop.kept]
        prog_calls = None if mix["kind"] == "train" else [(f, o) for _, f, o in loop.kept]
        del program, loop.program
        _free()
        prog = prog_res if mix["kind"] == "train" else prog_calls
        from benchmark.reference.precision import FULL, LOWER

        ref = reference_results(cfg, mix, assets, pool, checked_rows, s_weights, device, FULL)
        nums = numbers(mix["kind"], prog, ref)
        if detail and mix["kind"] == "train":
            detail = dict(compare.worst_leaves(prog, ref),
                          program={k: prog[k] for k in ("grads", "deltas")},
                          reference={k: ref[k] for k in ("grads", "deltas")})
        if control:
            # the reference one precision step down, put in the program's place
            del prog
            _free()
            low = reference_results(cfg, mix, assets, pool, checked_rows, s_weights, device, LOWER)
            control_nums = numbers(mix["kind"], low, ref)
            if detail and mix["kind"] == "train":
                detail["control"] = {k: low[k] for k in ("grads", "deltas")}
    finally:
        assets.close()
    correct, checks = compare.judge(nums, limits)
    metrics = {}
    for name, (entry, read) in readers.items():
        value = read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": entry["unit"]}
    attempted = run.loop.steps if run.kind == "train" else run.loop.calls
    result = dict(correct=bool(correct), attempted=attempted,
                  failed=0 if correct else attempted, metrics=metrics, device=dev_info)
    if trace_on:
        summ = trace.summary(run.events)
        result["device"].update(busy_s=summ["busy_s"], window_s=summ["window_s"])
        result["breakdown"] = summ["breakdown"]
    result["forbidden_modules"] = seen
    result["readings"] = {k: v for k, v in nums.items() if k not in limits}
    if control:
        result["control"] = {k: {"value": v} for k, v in control_nums.items()}
    if detail and mix["kind"] == "train":
        result["detail"] = detail
    result["checks"] = checks
    return result


def reference_results(cfg, mix, assets, pool, checked_rows, s_weights, device, prec):
    """The plain reference over the checked rows, in `prec` (FULL: float32
    with TF32 off): train_steps' results, or [(conditioning, outputs)] of
    the checked calls."""
    from benchmark.reference import conditioning as rc
    from benchmark.reference import step as rs
    from benchmark.reference.precision import strict_float32

    strict_float32()
    tables = rc.build_tables(assets.hand_uv_path, assets.object_paths, assets.sem,
                             cfg["image_size"], device)
    mano = rc.mano_tensors(assets.mano, device)
    nets = reference_nets(cfg, weights_for(cfg, s_weights, device), prec, device)
    batches = [inputs.take(pool, rows) for rows in checked_rows]
    if mix["kind"] == "train":
        return rs.train_steps(nets, tables, mano, batches, cfg, mix["reference_rows"], prec)
    return [rs.serve(nets, tables, mano, b, cfg, mix["reference_rows"], prec) for b in batches]


def numbers(kind: str, prog, ref) -> dict:
    return (compare.training_numbers if kind == "train" else compare.serving_numbers)(prog, ref)


def result_line(result: dict) -> str:
    """The JSON line, `checks` last."""
    checks = result.pop("checks")
    result["checks"] = checks
    return json.dumps(result)


def print_checks(checks: dict, readings: dict | None = None) -> None:
    for k, v in (readings or {}).items():
        log(f"reading {k}: {v!r} (not compared)")
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
