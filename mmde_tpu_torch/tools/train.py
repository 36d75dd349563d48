#!/usr/bin/env python
"""Training CLI of the port.

    python -m mmde_tpu_torch.tools.train --config configs/flagship_synth.yaml \\
        --synthetic [--epochs N] [--batch-size B] [--max-steps S] \\
        [--log-dir DIR] [--prestage N] [--device cuda]

Runs `train.loop.train` (counterpart of the JAX package's tools/train.py):
epochs over the dataset of the config (`--synthetic`: the in-memory
synthetic dataset), validation every VALIDATION_FREQUENCY epochs, a
checkpoint every SAVE_FREQUENCY epochs under LOG_DIR/ckpt/ and the best
validation RMSE under LOG_DIR/ckpt/best/ (SAVE_MODEL), logs.txt and the
scalars in LOG_DIR. RESUME_FROM: "auto" in the config resumes from the
newest checkpoint in LOG_DIR/ckpt (the CLI has no flag of its own for it,
as the JAX CLI has none). The default device is the CUDA card: without one
the run raises; `--device cpu` runs on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Optional


def main(argv=None) -> Optional[Dict[str, float]]:
    p = argparse.ArgumentParser(description="mmde_tpu_torch trainer")
    p.add_argument("--config", type=str, default=None,
                   help="YAML config (the configs/ schema)")
    p.add_argument("--synthetic", action="store_true",
                   help="use the in-memory synthetic dataset")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--max-steps", type=int, default=None,
                   help="cap the steps of each epoch (smoke runs)")
    p.add_argument("--log-dir", type=str, default=None)
    p.add_argument("--prestage", type=int, default=0,
                   help="measurement mode: copy N batches to the device "
                        "once and cycle them (train.loop prestage_batches)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from mmde_tpu_torch.config import Config, load_yaml
    from mmde_tpu_torch.train.loop import train

    cfg = load_yaml(args.config) if args.config else Config()
    if args.epochs is not None:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, epochs=args.epochs))
    if args.batch_size is not None:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train,
                                           batch_size=args.batch_size))
    result = train(cfg, synthetic=args.synthetic, log_dir=args.log_dir,
                   max_steps_per_epoch=args.max_steps,
                   prestage_batches=args.prestage, device=args.device)
    if result:
        print("final:", {k: round(v, 5) for k, v in result.items()})
    return result


if __name__ == "__main__":
    main()
