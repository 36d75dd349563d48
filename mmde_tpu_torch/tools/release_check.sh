#!/usr/bin/env bash
# Release gate for mmde_tpu_torch, the PyTorch / CUDA port: run before
# shipping kernel or training-path changes. The CPU tests hold the port to
# the JAX package (they import it and JAX); what they cannot see - the CUDA
# kernels against their plain versions, every model path on the card, the
# port learning end to end - is the GPU half's.
#
# Usage: bash mmde_tpu_torch/tools/release_check.sh [--skip-gpu]
set -euo pipefail
cd "$(dirname "$0")/../.."

echo "== 1/4 the port's CPU tests (parity with the JAX package) =="
JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_*.py -q

if [[ "${1:-}" != "--skip-gpu" ]]; then
  echo "== 2/4 chip_smoke.py: kernels vs plain versions, every path =="
  python3 chip_smoke.py

  echo "== 3/4 convergence gate, swin (the system LEARNS end to end) =="
  python -m mmde_tpu_torch.tools.convergence_gate

  echo "== 4/4 convergence gate, resnet =="
  python -m mmde_tpu_torch.tools.convergence_gate --variant resnet
else
  echo "== 2-4/4 skipped (--skip-gpu) =="
fi

echo "release check passed"
