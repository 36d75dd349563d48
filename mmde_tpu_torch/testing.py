"""Numpy-only helpers for parity tests and smoke runs.

`randomize_tree` fills a nested dict shaped like a flax `params` /
`batch_stats` tree from a numpy generator at scales that keep activations
O(1) through the network. Only each leaf's `.shape` is read, so the tree may
hold arrays or bare shape structs (`jax.eval_shape` of a module's `init`
gives those without compiling or running the initialisation). The packages' own initialisation (conv
std 0.001, identity BatchNorm) gives a near-constant depth map of
max_depth / 2, on which any comparison passes vacuously — a flipped
transposed convolution once hid behind exactly that.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np

# Largest log temperature drawn: exp(3) ~ 20. Beyond scale ~ 30 the JAX
# package's max-free softmax underflows in float32 (its static shift assumes
# a logit near the bound in every row), which would be the reference's
# error, not the port's.
MAX_TEST_LOGIT_SCALE = 3.0


def _leaf(path: Tuple[str, ...], shape: Tuple[int, ...],
          rng: np.random.Generator) -> np.ndarray:
    name = path[-1]

    def normal(std, mean=0.0):
        return (rng.standard_normal(shape) * std + mean).astype(np.float32)

    if name == "kernel":
        if len(shape) == 4 and any(p.startswith("deconv_") for p in path):
            kh, kw, cin, _ = shape         # each output sums cin*(k/2)^2 taps
            fan_in = cin * max((kh // 2) * (kw // 2), 1)
        else:
            fan_in = int(np.prod(shape[:-1]))
        gain = np.sqrt(2.0) if len(shape) == 4 else 1.0
        return normal(gain / np.sqrt(fan_in))
    if name == "scale":
        return normal(0.1, 1.0)
    if name == "mean":
        return normal(0.2)
    if name == "var":
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if name == "logit_scale":
        return np.minimum(normal(0.5, 1.5), MAX_TEST_LOGIT_SCALE)
    if name in ("bias", "q_bias", "v_bias"):
        return normal(0.1)
    if name == "relative_position_bias_table":
        return normal(0.5)
    if name in ("gamma_1", "gamma_2"):          # layerscale
        return normal(0.1, 0.5)
    raise KeyError(f"randomize_tree: no rule for leaf {'/'.join(path)}")


def randomize_tree(tree: Mapping, rng: np.random.Generator,
                   _path: Tuple[str, ...] = ()) -> dict:
    """A new nested dict with every leaf redrawn (see module docstring).
    Leaves are visited in sorted key order, so one seed gives one tree."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            out[k] = randomize_tree(v, rng, _path + (str(k),))
        else:
            out[k] = _leaf(_path + (str(k),), tuple(v.shape), rng)
    return out
