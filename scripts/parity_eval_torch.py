#!/usr/bin/env python3
"""One-command checkpoint-parity harness of the PyTorch/CUDA port (the
counterpart of scripts/parity_eval.py, same flags and report).

  1. run eval_torch.py with the checkpoint (`--load_path`: this package's
     or the reference's `net_epoch_{E}_id_G.pth`, an `.npz` dump of either,
     or the JAX package's flax `.ckpt`) -> `<output_dir>/{source,imitators,gt}`;
  2. run the metric battery over (imitators, gt): FID
     (hoig_torch/metrics/fid.py), LPIPS (metrics/lpips.py), SSIM and
     MS-SSIM (metrics/ssim.py);
  3. with `--ref_tree` (a tree the reference eval.py generated from the same
     checkpoint and pairs), run the same battery there and report each
     metric's relative delta with a within-1% PASS / FAIL verdict.

    python scripts/parity_eval_torch.py --checkpoint checkpoints/net_epoch_30_id_G.ckpt \\
        --dataset_mode hov3 --data_dir dataset/HO3D_v3 --output_dir outputs/parity \\
        --inception fid_inception.npz --alexnet alexnet.npz --lpips_weights lpips.npz

Without metric weights the battery still runs (SSIM and MS-SSIM need none)
and the report marks FID and LPIPS as not comparable (`"weights_missing"`).
Everything runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REL_TOL = 0.01  # the "within 1%" bar


def generate_tree(args) -> None:
    """eval_torch.py with the checkpoint -> the source / imitators / gt PNG trees."""
    import eval_torch

    argv = ["--dataset_mode", args.dataset_mode, "--data_dir", args.data_dir,
            "--output_dir", args.output_dir, "--load_path", args.checkpoint,
            "--image_size", str(args.image_size), "--batch_size", str(args.batch_size),
            "--gen_name", args.gen_name, "--conv_dim", str(args.conv_dim),
            "--repeat_num", str(args.repeat_num), "--checkpoints_dir", args.output_dir,
            "--name", "parity", "--device", args.device]
    if args.synthetic_size:
        argv += ["--synthetic_size", str(args.synthetic_size),
                 "--synthetic_num_objects", str(args.synthetic_num_objects)]
    eval_torch.main(argv + args.eval_extra.split())


def metric_battery(tree: str, args) -> dict:
    """FID / LPIPS / SSIM / MS-SSIM over <tree>/{imitators,gt}."""
    from hoig_torch.metrics.fid import calculate_fid_given_paths
    from hoig_torch.metrics.lpips import calculate_lpips_given_paths
    from hoig_torch.metrics.ssim import calculate_ssim_given_paths

    pair = [os.path.join(tree, "imitators"), os.path.join(tree, "gt")]
    for p in pair:
        if not os.path.isdir(p):
            raise RuntimeError(f"eval tree incomplete: missing {p}")
    out = {"tree": tree}
    out["fid"] = calculate_fid_given_paths(pair, batch_size=args.metric_batch,
                                           weights_path=args.inception, device=args.device)
    out["lpips"] = calculate_lpips_given_paths(
        pair, img_size=args.image_size, batch_size=args.metric_batch,
        alexnet_weights=args.alexnet, lpips_weights=args.lpips_weights, device=args.device)
    out["ssim"], out["ms_ssim"] = calculate_ssim_given_paths(
        pair, img_size=args.image_size, batch_size=args.metric_batch, device=args.device)
    out["weights_missing"] = [name for name, path in (
        ("inception", args.inception), ("alexnet", args.alexnet),
        ("lpips", args.lpips_weights)) if not path]
    return out


def compare(ours: dict, ref: dict) -> dict:
    """Per-metric relative deltas and within-1% verdicts."""
    rows = {}
    for key in ("fid", "lpips", "ssim", "ms_ssim"):
        a, b = ours.get(key), ref.get(key)
        if a is None or b is None:
            continue
        rel = abs(a - b) / max(abs(b), 1e-12)
        rows[key] = {"hoig_torch": a, "reference_tree": b, "rel_delta": rel,
                     "within_1pct": bool(rel <= REL_TOL)}
    rows["all_within_1pct"] = all(r["within_1pct"] for r in rows.values())
    return rows


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True,
                   help="net_epoch_{E}_id_G.{pth,npz,ckpt}")
    p.add_argument("--dataset_mode", default="hov3")
    p.add_argument("--data_dir", default="dataset/HO3D_v3")
    p.add_argument("--output_dir", default="outputs/parity_eval")
    p.add_argument("--ref_tree", default=None,
                   help="eval tree the reference generated from the same checkpoint "
                        "(dirs: imitators/ gt/)")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--gen_name", default="generator_spade_attn")
    p.add_argument("--conv_dim", type=int, default=64)
    p.add_argument("--repeat_num", type=int, default=6)
    p.add_argument("--inception", default=None, help="pt_inception state dict (.pth / .npz)")
    p.add_argument("--alexnet", default=None, help="torchvision alexnet state dict")
    p.add_argument("--lpips_weights", default=None, help="lpips_weights.ckpt state dict")
    p.add_argument("--metric_batch", type=int, default=16)
    p.add_argument("--skip_generate", action="store_true",
                   help="reuse an existing --output_dir tree")
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    p.add_argument("--synthetic_size", type=int, default=0,
                   help="synthetic dataset_mode passthrough (tests)")
    p.add_argument("--synthetic_num_objects", type=int, default=2)
    p.add_argument("--eval_extra", default="",
                   help='extra flags for eval_torch.py, one string (e.g. "--use_spade")')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    if not args.skip_generate:
        generate_tree(args)

    report = {"checkpoint": args.checkpoint, "ours": metric_battery(args.output_dir, args)}
    if args.ref_tree:
        report["reference"] = metric_battery(args.ref_tree, args)
        report["parity"] = compare(report["ours"], report["reference"])

    report_path = os.path.join(args.output_dir, "parity_report.json")
    os.makedirs(args.output_dir, exist_ok=True)
    with open(report_path, "w") as fp:
        json.dump(report, fp, indent=1)

    print("\n== parity report ==")
    for side in ("ours", "reference"):
        if side in report:
            r = report[side]
            missing = r.get("weights_missing")
            note = f"  [NOT comparable, missing weights: {missing}]" if missing else ""
            print(f"{side:9s} fid={r['fid']:.4f} lpips={r['lpips']:.4f} "
                  f"ssim={r['ssim']:.4f} ms_ssim={r['ms_ssim']:.4f}{note}")
    if "parity" in report:
        print(f"within-1% verdict: {'PASS' if report['parity']['all_within_1pct'] else 'FAIL'}")
        for k, row in report["parity"].items():
            if isinstance(row, dict):
                print(f"  {k}: rel_delta={row['rel_delta']:.4%} "
                      f"{'ok' if row['within_1pct'] else 'EXCEEDS 1%'}")
    print(f"report written to {report_path}")
    return report


if __name__ == "__main__":
    main()
