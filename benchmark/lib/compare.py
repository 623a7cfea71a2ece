"""The numbers that decide `correct`, each held to a limit of its own.

Training (the first steps of the window's own step and feed, against the
plain reference's steps on the same rows and weights):
  loss_rel         the widest relative gap of loss_G or loss_D, over the steps;
  grad_norm_gap    the worst leaf's gap between the first gradient's norms
                   (the program's as Adam got it), over the larger of the
                   reference's norm of that leaf and of the median leaf;
  grad_norm_gap_median  the median leaf's gap, the same measure: steady from
                   seed to seed where the worst leaf's is not (a few one-
                   element leaves, such as D's last bias, sum gradients that
                   cancel and read the rounding);
  update_norm_gap  the same for the norm of each parameter's change over
                   the steps.
Both leave out the leaves whose reference gradient is under a thousandth of
the median leaf's: their gradient is nought but for rounding (a conv bias
that an InstanceNorm follows, as in D, gets none in exact arithmetic), so
their gradient is the rounding's and they move under Adam by it alone.
  cond_gap, image_gap  the first step's generator inputs (the conditioning's
                   outputs) and its ten raw outputs, as for serving below.
Serving (sampled calls of the window, against the reference's conditioning
and generator on the same inputs):
  cond_gap         the widest relative L2 gap over the conditioning's outputs;
  image_gap        the widest relative L2 gap over the six composite outputs.
"""

from __future__ import annotations

import statistics

import torch

QUIET_GRAD = 1e-3  # of the median leaf's gradient norm


def _gap(p: float, r: float, floor: float) -> float:
    return abs(p - r) / max(r, floor, 1e-30)


def _rel_l2(p: torch.Tensor, r: torch.Tensor) -> float:
    p, r = p.double(), r.double()
    den = float(r.norm())
    num = float((p - r).norm())
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def _widest(prog: tuple, ref: tuple) -> float:
    """The widest relative L2 gap over paired tensors (None where absent on
    both sides); a missing or misshapen one reads as infinite."""
    if prog is None or len(prog) != len(ref):
        return float("inf")
    out = 0.0
    for p, r in zip(prog, ref):
        if r is None and p is None:
            continue
        if r is None or p is None or p.shape != r.shape:
            return float("inf")
        out = max(out, _rel_l2(p.to(r.device).float(), r))
    return out


def training_numbers(prog: dict, ref: dict) -> dict:
    """prog / ref: dict(losses [(loss_G, loss_D)], grads {leaf: norm},
    deltas {leaf: norm}, first (the first step's generator inputs, raw
    outputs)); a leaf the program lacks reads as 0."""
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for ps, rs in zip(prog["losses"], ref["losses"]) for p, r in zip(ps, rs))
    if len(prog["losses"]) != len(ref["losses"]):
        loss = float("inf")
    med_g = statistics.median(ref["grads"].values())
    kept = [k for k, r in ref["grads"].items() if r >= QUIET_GRAD * med_g]
    grads = [_gap(prog["grads"].get(k) or 0.0, ref["grads"][k], med_g) for k in kept]
    med_d = statistics.median(ref["deltas"][k] for k in kept)
    upd = max(_gap(prog["deltas"].get(k) or 0.0, ref["deltas"][k], med_d) for k in kept)
    return dict(loss_rel=loss, grad_norm_gap=max(grads),
                grad_norm_gap_median=statistics.median(grads), update_norm_gap=upd,
                cond_gap=_widest(prog["first"][0], ref["first"][0]),
                image_gap=_widest(prog["first"][1], ref["first"][1]))


def serving_numbers(prog: list, ref: list) -> dict:
    """prog / ref: [(conditioning dict, composite outputs)] of the same calls."""
    cond, image = 0.0, 0.0
    keys = [k for k, v in ref[0][0].items() if v is not None]
    for (pf, po), (rf, ro) in zip(prog, ref):
        for k in keys:
            if pf.get(k) is None or pf[k].shape != rf[k].shape:
                cond = float("inf")
                continue
            cond = max(cond, _rel_l2(pf[k].float(), rf[k]))
        if len(po) != len(ro):
            image = float("inf")
        for p, r in zip(po, ro):
            image = max(image, _rel_l2(p.float(), r) if p.shape == r.shape else float("inf"))
    if len(prog) != len(ref):
        cond = image = float("inf")
    return dict(cond_gap=cond, image_gap=image)


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    limits name: every one within its limit (one that is not finite is
    not). A number the limits do not name is a reading, not compared."""
    checks = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
    ok = all(c["value"] == c["value"] and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def worst_leaves(prog: dict, ref: dict, n: int = 3) -> dict:
    """The n leaves that read the widest gaps, for the calibration's record:
    {"grads" / "deltas": [(gap, leaf, program's norm, reference's norm,
    left out)]}."""
    med_g = statistics.median(ref["grads"].values())
    quiet = {k for k, r in ref["grads"].items() if r < QUIET_GRAD * med_g}
    out = {}
    for key in ("grads", "deltas"):
        med = med_g if key == "grads" else statistics.median(
            v for k, v in ref[key].items() if k not in quiet)
        rows = [(_gap(prog[key].get(k) or 0.0, r, med), k, prog[key].get(k), r, k in quiet)
                for k, r in ref[key].items()]
        out[key] = sorted(rows, reverse=True)[:n]
    return out
