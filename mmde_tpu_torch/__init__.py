"""mmde_tpu_torch — PyTorch/CUDA port of mmde_tpu for NVIDIA Hopper.

Mirrors the layout of the JAX package (`ops/`, `nn/`, `models/`, `train/`,
`ckpt/`, `tools/`) so each module's counterpart is found by name. Imports
torch, numpy, yaml and the standard library only. Entry points take an
explicit `device` and default to the CUDA card; the fused kernels under
`csrc/` are compiled with nvcc at first use into `_build/`.
"""

__version__ = "0.1.0"
