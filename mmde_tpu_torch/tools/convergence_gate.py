#!/usr/bin/env python
"""Convergence gate: the training system optimises end to end.

    python -m mmde_tpu_torch.tools.convergence_gate [--variant swin] \\
        [--config YAML] [--epochs N] [--seed S] [--log-dir DIR] \\
        [--device cuda]

Counterpart of the JAX package's tools/convergence_gate.py, both
variants: runs the real training job (`train.loop.train`: loader threads,
the poly LR schedule over the epochs, checkpoints, best-RMSE selection,
validation) on the learnable synthetic dataset of the variant's config,
then re-evaluates the best checkpoint through the eval CLI
(`python -m mmde_tpu_torch.tools.eval --flip-tta`, a process of its own)
on the held-out samples and holds it to the thresholds pinned in the JAX
tool:
  * swin (configs/convergence_gate_swin.yaml: swin_tiny_v2 + decoder_v2,
    96x128, 24 epochs): d1 >= 0.35 and rmse <= 2.0, the recorded
    from-scratch plateau of the swin path (divergence, NaNs or wrong
    kernel gradients fall through it);
  * resnet (configs/convergence_gate.yaml: resnet_only_multi_scale with a
    resnet18 trunk + decoder_v2, 64x96, 48 epochs): d1 >= 0.85 and rmse
    <= 0.75, "cue-learning" - the depth cue in the red channel learned end
    to end.
Prints one JSON line; exits 1 when a threshold is missed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the JAX tool's per-variant configs and thresholds
VARIANTS = {
    "resnet": {"config": "convergence_gate.yaml", "claim": "cue-learning",
               "d1_min": 0.85, "rmse_max": 0.75},
    "swin": {"config": "convergence_gate_swin.yaml",
             "claim": "optimization-sanity", "d1_min": 0.35,
             "rmse_max": 2.0},
}


def parse_metric_table(text: str) -> dict:
    """{name: value} of the eval CLI's `name: value` lines."""
    metrics = {}
    for line in text.splitlines():
        parts = line.strip().replace(":", " ").split()
        if len(parts) == 2:
            try:
                metrics[parts[0]] = float(parts[1])
            except ValueError:
                pass
    return metrics


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="mmde_tpu_torch convergence gate")
    p.add_argument("--variant", choices=sorted(VARIANTS), default="swin")
    p.add_argument("--config", default=None,
                   help="config path (default: the variant's)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--seed", type=int, default=None,
                   help="the run's seed (default: the config's SEED)")
    p.add_argument("--log-dir", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    variant = VARIANTS[args.variant]
    thresholds = {"d1_min": variant["d1_min"],
                  "rmse_max": variant["rmse_max"]}
    config = args.config or os.path.join(ROOT, "configs", variant["config"])

    from mmde_tpu_torch.config import load_yaml
    from mmde_tpu_torch.models.two_frame import require_device
    from mmde_tpu_torch.train.loop import train

    require_device(args.device, what="convergence_gate")
    cfg = load_yaml(config)
    over = {}
    if args.epochs:
        over["epochs"] = args.epochs
    if args.seed is not None:
        over["seed"] = args.seed
    if over:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **over))
    log_dir = args.log_dir or tempfile.mkdtemp(prefix="mmde_gate_")
    final = train(cfg, log_dir=log_dir, device=args.device)
    print(f"gate: training done, last val metrics: "
          f"d1={final.get('d1', 0):.4f} rmse={final.get('rmse', 9):.4f}",
          flush=True)

    # the best checkpoint through the public eval CLI with flip TTA
    cmd = [sys.executable, "-m", "mmde_tpu_torch.tools.eval",
           "--config", config, "--ckpt", os.path.join(log_dir, "ckpt"),
           "--flip-tta", "--device", args.device]
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                          timeout=3600)
    sys.stdout.write(proc.stdout[-3000:])
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-3000:])
        raise SystemExit(f"gate: eval CLI failed rc={proc.returncode}")
    metrics = parse_metric_table(proc.stdout)
    d1 = metrics.get("d1", final.get("d1", 0.0))
    rmse = metrics.get("rmse", final.get("rmse", 9.9))
    ok = d1 >= thresholds["d1_min"] and rmse <= thresholds["rmse_max"]
    rec = {"gate": "convergence", "variant": args.variant,
           "claim": variant["claim"], "ok": bool(ok), "d1": d1,
           "rmse": rmse, "thresholds": thresholds, "seed": cfg.train.seed,
           "epochs": cfg.train.epochs, "device": args.device,
           "restored": [ln for ln in proc.stdout.splitlines()
                        if ln.startswith("restored")],
           "final_train_loop_val": final, "log_dir": log_dir}
    print(json.dumps(rec), flush=True)
    if not ok:
        raise SystemExit(1)
    return rec


if __name__ == "__main__":
    main()
