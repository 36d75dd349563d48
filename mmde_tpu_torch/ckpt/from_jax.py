"""Carry the JAX package's variables into the port's modules.

`load_jax_variables(model, params, batch_stats)` takes the flax `params` and
`batch_stats` trees of mmde_tpu's TwoFrameDepthPose (nested dicts of arrays;
anything np.asarray accepts) and fills the state dict of the port's model:

  Dense   kernel (in, out)        -> weight (out, in)
  Conv    kernel HWIO             -> weight OIHW
  ConvTranspose kernel (kH, kW, in, out), applied unflipped by flax
                                  -> torch weight (in, out, kH, kW): the
                                     transpose AND the spatial flip undone
  LayerNormFP32  LayerNorm_0/{scale, bias} -> {weight, bias}
  BatchNorm scale, bias + batch_stats/{mean, var}
                                  -> weight, bias, running_mean, running_var
  q_bias, v_bias, logit_scale (nH, 1, 1), rpe_fc1 / rpe_fc2 -> rpe_mlp.0 / .2

Every key is accounted for: tensors of the model that the trees do not fill
and tree leaves that no tensor takes are both reported, and either raises.

The same map runs the other way: `key_map(tree)` gives {flax path: port
key} for every leaf, and `to_jax_tree(tensors, like)` carries the port's
tensors (parameters, gradients, per-parameter flags) back into a nested dict
shaped like `like` in the JAX layout, each layout change undone.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

# flax module name -> port (reference) module path, for the decoder
_DECODER_NAMES = {
    ("pose", "conv0"): "decoder_pose.pos_layers.0",
    ("pose", "bn0"): "decoder_pose.pos_layers.1",
    ("pose", "down1_a"): "decoder_pose.pos_layer_down1.0",
    ("pose", "bn1a"): "decoder_pose.pos_layer_down1.1",
    ("pose", "down1_b"): "decoder_pose.pos_layer_down1.3",
    ("pose", "bn1b"): "decoder_pose.pos_layer_down1.4",
    ("pose", "down2_a"): "decoder_pose.pos_layer_down2.0",
    ("pose", "bn2a"): "decoder_pose.pos_layer_down2.1",
    ("pose", "down2_b"): "decoder_pose.pos_layer_down2.3",
    ("pose", "bn2b"): "decoder_pose.pos_layer_down2.4",
    ("depth", "conv"): "decoder_depth.conv_layers.0",
    ("depth", "conv_bn"): "decoder_depth.conv_layers.1",
    ("depth", "head_a"): "decoder_depth.last_layer.0",
    ("depth", "head_b"): "decoder_depth.last_layer.2",
}
_HEADS = {"rot_head": "rotat_reg_layer", "trans_head": "trans_reg_layer"}
_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}


def flatten_tree(tree: Mapping, prefix: Tuple[str, ...] = ()
                 ) -> Dict[Tuple[str, ...], np.ndarray]:
    out: Dict[Tuple[str, ...], np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _decoder_module(path: Tuple[str, ...]) -> Optional[str]:
    """('pose', 'conv0') / ('depth', 'deconv_1') / ('pose', 'rot_head',
    'fc2') -> the port's module path under `decoder.`."""
    if path in _DECODER_NAMES:
        return _DECODER_NAMES[path]
    if len(path) == 2 and path[0] == "depth":
        m = re.fullmatch(r"deconv_(\d+)", path[1])
        if m:
            return f"decoder_depth.deconv_layers.{3 * int(m.group(1))}"
        m = re.fullmatch(r"deconv_bn_(\d+)", path[1])
        if m:
            return f"decoder_depth.deconv_layers.{3 * int(m.group(1)) + 1}"
    if len(path) == 3 and path[0] == "pose" and path[1] in _HEADS:
        m = re.fullmatch(r"fc(\d)", path[2])
        if m:
            return (f"decoder_pose.{_HEADS[path[1]]}.reg_layer."
                    f"{3 * (int(m.group(1)) - 1)}")
    return None


def torch_key(path: Tuple[str, ...]) -> Optional[str]:
    """Flax variable path (without the collection) -> the port's state-dict
    key, or None when the path has no counterpart."""
    *mods, leaf = path
    if mods and mods[0] in ("decoder", "pose", "depth"):
        # the whole model's tree ("decoder/pose/...") or a bare decoder's
        prefix = "decoder." if mods[0] == "decoder" else ""
        mod = _decoder_module(tuple(mods[1:] if prefix else mods))
        if mod is None:
            return None
        name = "weight" if leaf == "kernel" else _LEAF.get(leaf)
        return None if name is None else f"{prefix}{mod}.{name}"
    parts: List[str] = []
    for m in mods:
        if m == "LayerNorm_0":
            continue                      # LayerNormFP32 nests a LayerNorm
        g = re.fullmatch(r"(layers|blocks)_(\d+)", m)
        if g:
            parts += [g.group(1), g.group(2)]
        elif m == "rpe_fc1":
            parts += ["rpe_mlp", "0"]
        elif m == "rpe_fc2":
            parts += ["rpe_mlp", "2"]
        else:
            parts.append(m)
    if leaf == "kernel":
        name = "weight"
    elif leaf in ("q_bias", "v_bias", "logit_scale", "gamma_1", "gamma_2",
                  "relative_position_bias_table"):
        name = leaf
    else:
        name = _LEAF.get(leaf)
        if name is None:
            return None
    return ".".join(parts + [name])


def convert_value(key: str, value: np.ndarray) -> np.ndarray:
    """Layout change from flax to torch for the tensor stored under `key`."""
    if not key.endswith(".weight"):
        return value
    if value.ndim == 2:                                   # Dense
        return value.T
    if value.ndim == 4:
        if ".deconv_layers." in key:
            # flax applies the stored kernel unflipped; torch's transposed
            # conv reverses the taps. (kH, kW, in, out) flipped -> unflip,
            # then -> torch's (in, out, kH, kW).
            return np.transpose(value[::-1, ::-1], (2, 3, 0, 1))
        return np.transpose(value, (3, 2, 0, 1))          # HWIO -> OIHW
    return value


def unconvert_value(key: str, value: np.ndarray) -> np.ndarray:
    """Inverse of `convert_value`: torch layout -> flax layout."""
    if not key.endswith(".weight"):
        return value
    if value.ndim == 2:
        return value.T
    if value.ndim == 4:
        if ".deconv_layers." in key:
            return np.transpose(value, (2, 3, 0, 1))[::-1, ::-1]
        return np.transpose(value, (2, 3, 1, 0))          # OIHW -> HWIO
    return value


def key_map(tree: Mapping) -> Dict[Tuple[str, ...], str]:
    """{flax path: port state-dict key} for every leaf of `tree` (a params
    or batch_stats tree, arrays or shape structs). Raises KeyError for a
    leaf without a counterpart."""
    out: Dict[Tuple[str, ...], str] = {}

    def walk(node: Mapping, prefix: Tuple[str, ...]) -> None:
        for k, v in node.items():
            path = prefix + (str(k),)
            if isinstance(v, Mapping):
                walk(v, path)
                continue
            key = torch_key(path)
            if key is None:
                raise KeyError(f"no port key for {'/'.join(path)}")
            out[path] = key

    walk(tree, ())
    return out


def to_jax_tree(tensors: Mapping[str, object], like: Mapping,
                convert: bool = True) -> dict:
    """Nested dict shaped like `like` (a flax params / batch_stats tree)
    holding, for each leaf, the value `tensors` has under the port's key, as
    a numpy array in the JAX layout (`convert=False` for values that are not
    tensors of the parameter's shape: flags, scales). `tensors` maps port
    names to torch tensors, arrays or scalars, e.g.
    dict(model.named_parameters()), {n: p.grad ...} or a scale table."""
    out: dict = {}
    for path, key in key_map(like).items():
        v = tensors[key]
        if isinstance(v, torch.Tensor):
            v = v.detach().float().cpu().numpy()
        if convert:
            v = np.ascontiguousarray(unconvert_value(key, np.asarray(v)))
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def load_jax_variables(model: torch.nn.Module, params: Mapping,
                       batch_stats: Optional[Mapping] = None) -> List[str]:
    """Fill `model` (the port's TwoFrameDepthPose, or any sub-module whose
    flax counterpart has the same tree) from the JAX trees. Raises KeyError
    on missing or unexpected keys and ValueError on a shape mismatch;
    returns the list of keys it filled."""
    flat = flatten_tree(params)
    flat.update(flatten_tree(batch_stats or {}))
    if any("blocks_scan" in p for p in flat):
        raise ValueError(
            "params are in the scanned-blocks layout; convert them with "
            "mmde_tpu.nn.swin_v2.from_scanned_layout before loading")
    state = model.state_dict()
    new: Dict[str, torch.Tensor] = {}
    unexpected: List[str] = []
    for path, value in flat.items():
        key = torch_key(path)
        if key is None or key not in state:
            unexpected.append("/".join(path) + (f" -> {key}" if key else ""))
            continue
        arr = np.ascontiguousarray(convert_value(key, value))
        if tuple(arr.shape) != tuple(state[key].shape):
            raise ValueError(f"{'/'.join(path)} -> {key}: shape "
                             f"{arr.shape} vs {tuple(state[key].shape)}")
        new[key] = torch.tensor(arr, dtype=state[key].dtype)
    # counters that flax does not keep
    missing = [k for k in state
               if k not in new and not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"load_jax_variables: missing keys {missing}; "
                       f"unexpected keys {unexpected}")
    model.load_state_dict(new, strict=False)
    return sorted(new)
