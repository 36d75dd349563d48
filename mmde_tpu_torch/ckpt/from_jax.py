"""Carry the JAX package's variables into the port's modules.

`load_jax_variables(model, params, batch_stats)` takes the flax `params` and
`batch_stats` trees of an mmde_tpu model (TwoFrameDepthPose over any of its
encoders, GLPDepth, Scale16TwoFrame, or a sub-module; nested dicts of
arrays, anything np.asarray accepts) and fills the state dict of the port's
model:

  Dense   kernel (in, out)        -> weight (out, in)
  Conv    kernel HWIO             -> weight OIHW
  ConvTranspose kernel (kH, kW, in, out), applied unflipped by flax
                                  -> torch weight (in, out, kH, kW): the
                                     transpose AND the spatial flip undone
  LayerNormFP32  LayerNorm_0/{scale, bias} -> {weight, bias}
  BatchNorm scale, bias + batch_stats/{mean, var}
                                  -> weight, bias, running_mean, running_var
  q_bias, v_bias, logit_scale (nH, 1, 1), rpe_fc1 / rpe_fc2 -> rpe_mlp.0 / .2
  absolute_pos_embed (1, H, W, C)  -> (1, C, H, W)
  the ResNet trunk (trunk/stem_conv, layer2_1/downsample_bn)
                                  -> the reference encoder's Sequential
                                     slices (backbone.feature3.0,
                                     feature3.5.1.downsample.1), or
                                     torchvision's names (conv1, layer2.1)
  MultiHeadDotProductAttention query / key / value kernel (C, nH, Dh)
    and bias (nH, Dh)             -> row blocks 0 / 1 / 2 of
                                     self_attn.in_proj_weight (3C, C) and
                                     in_proj_bias (keys "...:0" .. ":2")
  its out kernel (nH, Dh, C)      -> self_attn.out_proj.weight (C, C)
  enc_i, ffn1 / ffn2, squeeze1_a, combine_a, BatchNorm_0
                                  -> transformer_encoder.i, ffn1.0 / ffn2.0,
                                     feat_squeeze1.0, feat_combine.0 / .1

Every key is accounted for: tensors of the model that the trees do not fill
and tree leaves that no tensor takes are both reported, and either raises.
Three leaves of one attention layer fill one tensor: a port key with a
":part" suffix names that row block (`split_key`).

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


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> dict:
    """{path: leaf} of a nested dict, the leaves as they are (arrays or
    shape structs)."""
    out: dict = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_leaves(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def flatten_tree(tree: Mapping, prefix: Tuple[str, ...] = ()
                 ) -> Dict[Tuple[str, ...], np.ndarray]:
    return {p: np.asarray(v) for p, v in _leaves(tree, prefix).items()}


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


# MultiHeadDotProductAttention's projections -> torch's packed layout
_QKV_PART = {"query": 0, "key": 1, "value": 2}


def _trunk_module(m: str, single_scale: bool) -> Optional[List[str]]:
    """A ResNet trunk's flax module (stem_conv, stem_bn, layer{s}_{b}) ->
    the reference encoder's Sequential slices: multi-scale feature3 = (conv1,
    bn1, relu, maxpool, layer1, layer2), feature4 = (layer3,), feature5 =
    (layer4,); single-scale feature = (conv1, bn1, relu, maxpool, layer1 ..
    layer3)."""
    stem = {"stem_conv": 0, "stem_bn": 1}
    g = re.fullmatch(r"layer(\d)_(\d+)", m)
    if single_scale:
        if m in stem:
            return ["feature", str(stem[m])]
        return None if g is None else ["feature", str(3 + int(g.group(1))),
                                       g.group(2)]
    if m in stem:
        return ["feature3", str(stem[m])]
    if g is None:
        return None
    s = int(g.group(1))
    return ([f"feature{3 + max(s - 2, 0)}", str(4 + s - 1) if s <= 2 else "0",
             g.group(2)])


def _module_parts(mods: List[str], single_scale: bool) -> Optional[List[str]]:
    """Flax module path -> the port's dotted module path, segment by
    segment (None where a segment has no counterpart)."""
    parts: List[str] = []
    trunk = torchvision = False
    for i, m in enumerate(mods):
        if m == "LayerNorm_0":
            continue                      # LayerNormFP32 nests a LayerNorm
        if m == "trunk":
            trunk = True
            continue
        if i == 0 and (m in ("stem_conv", "stem_bn")
                       or re.fullmatch(r"layer\d_\d+", m)):
            torchvision = True            # a bare ResNetFeatures tree
        g = re.fullmatch(r"(layers|blocks)_(\d+)", m)
        if trunk and (m in ("stem_conv", "stem_bn")
                      or re.fullmatch(r"layer\d_\d+", m)):
            sub = _trunk_module(m, single_scale)
            if sub is None:
                return None
            parts += sub
            trunk = False
        elif torchvision and m in ("stem_conv", "stem_bn"):
            parts.append({"stem_conv": "conv1", "stem_bn": "bn1"}[m])
        elif torchvision and re.fullmatch(r"layer\d_\d+", m):
            parts += m.split("_")
        elif g:
            parts += [g.group(1), g.group(2)]
        elif m == "rpe_fc1":
            parts += ["rpe_mlp", "0"]
        elif m == "rpe_fc2":
            parts += ["rpe_mlp", "2"]
        elif m == "downsample" and i > 0 and re.fullmatch(
                r"layer\d_\d+", mods[i - 1]):
            parts += ["downsample", "0"]
        elif m == "downsample_bn":
            parts += ["downsample", "1"]
        elif re.fullmatch(r"enc_\d+", m):
            parts += ["transformer_encoder", m[4:]]
        elif m in ("ffn1", "ffn2"):
            parts += [m, "0"]
        elif re.fullmatch(r"squeeze\d?_[ab]", m):
            parts += ["feat_" + m[:-2], "0" if m[-1] == "a" else "1"]
        elif m in ("combine_a", "BatchNorm_0", "combine_b") and i > 0 \
                and mods[i - 1] == "feature_extractor":
            parts += ["feat_combine", {"combine_a": "0", "BatchNorm_0": "1",
                                       "combine_b": "3"}[m]]
        elif m == "out" and i > 0 and mods[i - 1] == "self_attn":
            parts.append("out_proj")
        else:
            parts.append(m)
    return parts


def torch_key(path: Tuple[str, ...], single_scale: bool = False
              ) -> Optional[str]:
    """Flax variable path (without the collection) -> the port's state-dict
    key, or None when the path has no counterpart. `single_scale`: a ResNet
    trunk under `trunk/` is the single-scale encoder's (`feature.N`), else
    the multi-scale one's (`feature3.N` ...); `trunk_single_scale` tells
    them apart from a whole tree. An attention projection's key carries
    its row block (":0" .. ":2", `split_key`)."""
    *mods, leaf = path
    if mods and mods[0] in ("decoder", "pose", "depth"):
        # the whole model's tree ("decoder/pose/...") or a bare decoder's;
        # GLPDepth's "decoder" (deconv_0, conv_bn, ...) takes the names below
        prefix = "decoder." if mods[0] == "decoder" else ""
        mod = _decoder_module(tuple(mods[1:] if prefix else mods))
        if mod is not None:
            name = "weight" if leaf == "kernel" else _LEAF.get(leaf)
            return None if name is None else f"{prefix}{mod}.{name}"
    if len(mods) >= 2 and mods[-2] == "self_attn" and mods[-1] in _QKV_PART:
        parts = _module_parts(mods[:-1], single_scale)
        if parts is None or leaf not in ("kernel", "bias"):
            return None
        name = "in_proj_weight" if leaf == "kernel" else "in_proj_bias"
        return ".".join(parts + [name]) + f":{_QKV_PART[mods[-1]]}"
    parts = _module_parts(list(mods), single_scale)
    if parts is None:
        return None
    if leaf == "kernel":
        name = "weight"
    elif leaf in ("q_bias", "v_bias", "logit_scale", "gamma_1", "gamma_2",
                  "relative_position_bias_table", "absolute_pos_embed"):
        name = leaf
    else:
        name = _LEAF.get(leaf)
        if name is None:
            return None
    return ".".join(parts + [name])


def trunk_single_scale(paths) -> bool:
    """Whether the ResNet trunk of a flax tree (its leaf paths, "/"-joined)
    is the single-scale encoder's: cut after layer3, it has no layer4."""
    paths = list(paths)
    return (any("trunk/" in p for p in paths)
            and not any("trunk/layer4_" in p for p in paths))


def split_key(key: str) -> Tuple[str, Optional[int]]:
    """"...in_proj_weight:1" -> ("...in_proj_weight", 1); other keys ->
    (key, None)."""
    name, _, part = key.partition(":")
    return name, (int(part) if part else None)


def _is_deconv(key: str) -> bool:
    return ".deconv_layers." in key or re.search(r"(^|\.)deconv_\d+\.",
                                                 key) is not None


def convert_value(key: str, value: np.ndarray) -> np.ndarray:
    """Layout change from flax to torch for the tensor stored under `key`
    (for a ":part" key, its row block)."""
    name, part = split_key(key)
    if name.endswith("absolute_pos_embed"):
        return np.transpose(value, (0, 3, 1, 2))          # NHWC -> NCHW
    if part is not None:
        if name.endswith("in_proj_weight"):               # (C, nH, Dh)
            return value.reshape(value.shape[0], -1).T
        return value.reshape(-1)                          # (nH, Dh)
    if not name.endswith(".weight"):
        return value
    if value.ndim == 3:                                   # out: (nH, Dh, C)
        return value.reshape(-1, value.shape[-1]).T
    if value.ndim == 2:                                   # Dense
        return value.T
    if value.ndim == 4:
        if _is_deconv(name):
            # flax applies the stored kernel unflipped; torch's transposed
            # conv reverses the taps. (kH, kW, in, out) flipped -> unflip,
            # then -> torch's (in, out, kH, kW).
            return np.transpose(value[::-1, ::-1], (2, 3, 0, 1))
        return np.transpose(value, (3, 2, 0, 1))          # HWIO -> OIHW
    return value


def unconvert_value(key: str, value: np.ndarray,
                    shape: Optional[Tuple[int, ...]] = None) -> np.ndarray:
    """Inverse of `convert_value`: torch layout -> flax layout. `shape`, the
    flax leaf's, is needed where the head split is not in the torch tensor
    (the attention projections)."""
    name, part = split_key(key)
    if name.endswith("absolute_pos_embed"):
        return np.transpose(value, (0, 2, 3, 1))
    if part is not None:
        return (value.T if value.ndim == 2 else value).reshape(shape)
    if not name.endswith(".weight"):
        return value
    if shape is not None and len(shape) == 3 and value.ndim == 2:
        return value.T.reshape(shape)                     # out_proj
    if value.ndim == 2:
        return value.T
    if value.ndim == 4:
        if _is_deconv(name):
            return np.transpose(value, (2, 3, 0, 1))[::-1, ::-1]
        return np.transpose(value, (2, 3, 1, 0))          # OIHW -> HWIO
    return value


def _part(v, part: Optional[int]):
    """Row block `part` of a packed (3C, ...) projection tensor; other
    values (and part None) as they are."""
    if part is None or not hasattr(v, "shape") or not len(v.shape):
        return v
    n = v.shape[0] // 3
    return v[part * n:(part + 1) * n]


def key_map(tree: Mapping) -> Dict[Tuple[str, ...], str]:
    """{flax path: port state-dict key} for every leaf of `tree` (a params
    or batch_stats tree, arrays or shape structs). Raises KeyError for a
    leaf without a counterpart."""
    leaves = _leaves(tree)
    single = trunk_single_scale("/".join(p) for p in leaves)
    out: Dict[Tuple[str, ...], str] = {}
    for path in leaves:
        key = torch_key(path, single)
        if key is None:
            raise KeyError(f"no port key for {'/'.join(path)}")
        out[path] = key
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
    leaves = _leaves(like)
    for path, key in key_map(like).items():
        name, part = split_key(key)
        v = _part(tensors[name], part)
        if isinstance(v, torch.Tensor):
            v = v.detach().float().cpu().numpy()
        if convert:
            shape = tuple(getattr(leaves[path], "shape",
                                  np.shape(leaves[path])))
            v = np.ascontiguousarray(unconvert_value(key, np.asarray(v),
                                                     shape))
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def load_jax_variables(model: torch.nn.Module, params: Mapping,
                       batch_stats: Optional[Mapping] = None) -> List[str]:
    """Fill `model` (a port model - TwoFrameDepthPose, GLPDepth,
    Scale16TwoFrame - or any sub-module whose flax counterpart has the same
    tree) from the JAX trees. Raises KeyError on missing or unexpected keys
    (an attention projection missing a row block among them) and
    ValueError on a shape mismatch; returns the list of keys it filled."""
    flat = flatten_tree(params)
    flat.update(flatten_tree(batch_stats or {}))
    if any("blocks_scan" in p for p in flat):
        raise ValueError(
            "params are in the scanned-blocks layout; convert them with "
            "mmde_tpu.nn.swin_v2.from_scanned_layout before loading")
    state = model.state_dict()
    new: Dict[str, torch.Tensor] = {}
    blocks: Dict[str, Dict[int, np.ndarray]] = {}
    unexpected: List[str] = []
    single = trunk_single_scale("/".join(p) for p in flat)
    for path, value in flat.items():
        key = torch_key(path, single)
        name, part = split_key(key) if key else (None, None)
        if key is None or name not in state:
            unexpected.append("/".join(path) + (f" -> {key}" if key else ""))
            continue
        arr = np.ascontiguousarray(convert_value(key, value))
        want = tuple(state[name].shape)
        if part is not None:
            want = (want[0] // 3,) + want[1:]
        if tuple(arr.shape) != want:
            raise ValueError(f"{'/'.join(path)} -> {key}: shape "
                             f"{arr.shape} vs {want}")
        if part is not None:
            blocks.setdefault(name, {})[part] = arr
        else:
            new[name] = torch.tensor(arr, dtype=state[name].dtype)
    for name, rows in blocks.items():
        if sorted(rows) == [0, 1, 2]:
            new[name] = torch.tensor(np.concatenate([rows[i] for i in range(3)]),
                                     dtype=state[name].dtype)
    # counters that flax does not keep
    missing = [k for k in state
               if k not in new and not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"load_jax_variables: missing keys {missing}; "
                       f"unexpected keys {unexpected}")
    model.load_state_dict(new, strict=False)
    return sorted(new)
