"""Pretrained backbone checkpoints (PyTorch state dicts) into the port.

Counterpart of mmde_tpu/ckpt/torch_convert.py. The port's modules carry the
reference PyTorch names (`layers.0.blocks.0.attn.qkv.weight`,
`attn.rpe_mlp.0.weight`, the trunks' `feature3.4.0.conv1.weight`), so a
checkpoint needs no layout change, only its keys mapped and one table
resampled:

  * `load_torch_state_dict` unpickles a .pth / .ckpt file and unwraps the
    usual 'model' / 'state_dict' / 'model_state_dict' keys;
  * `strip_prefixes` drops `module.` / `encoder.` / `backbone.`;
  * `convert_swin` keeps the SwinV2 keys the JAX converter maps (the rest
    are reported as "unmapped: name"), skips the static buffers the modules
    rebuild (`relative_position_index`, `relative_coords_table`,
    `attn_mask`) and resamples the discrete `relative_position_bias_table`
    (`rpe_table_type="none"`) to the model's window with
    `interpolate_rpe_table` (geometric or bicubic, numpy / scipy, the JAX
    function's arithmetic);
  * `convert_resnet` keeps a torchvision ResNet-18 / 50's convolutions and
    BatchNorms (running statistics included) and renames them to the
    reference encoder's Sequential slices (`feature3.0` = conv1, `feature4.0`
    = layer3, ...), the inverse of the JAX converter's `_resequence_trunk`;
  * `convert_cnn_transformer` takes a whole reference cnn_transformer /
    resnet_only checkpoint (trunk, squeeze / combine convolutions, the
    transformer layers);
  * `apply_pretrained` overlays the converted tensors onto a module's state
    dict non-strictly and returns the JAX function's report: missing keys
    (a parameter the file does not fill, or fills with another shape, with
    both shapes) and unexpected keys (a converted key the module lacks).
    BatchNorm running statistics are loaded where present and, as in the
    JAX function, left out of the report.

Keys in the reports are the port's state-dict names relative to the module
the tensors are applied to, where the JAX function gives flax paths
relative to its subtree.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]

# names of BatchNorm statistics: loaded where present, never reported
_STATISTICS = ("running_mean", "running_var", "num_batches_tracked")


def load_torch_state_dict(path: str) -> StateDict:
    """Unpickle a .pth / .ckpt file to {name: tensor on the CPU}, unwrapping
    'model', 'state_dict' or 'model_state_dict'. The file is unpickled whole
    (a training checkpoint holds configuration objects beside its tensors),
    as the JAX package does: load only files from a source you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("model", "state_dict", "model_state_dict"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
            break
    return {k: v.detach().cpu() for k, v in obj.items()
            if isinstance(v, torch.Tensor)}


def strip_prefixes(sd: Mapping[str, torch.Tensor],
                   prefixes=("module.", "encoder.", "backbone.")
                   ) -> StateDict:
    """Each key with the prefixes removed in turn (`module.encoder.x` -> x)."""
    out = {}
    for k, v in sd.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


# ---------------------------------------------------------------------------
# relative position bias table interpolation (discrete-table RPE)
# ---------------------------------------------------------------------------

def interpolate_rpe_table(table: np.ndarray, src_window: int, dst_window: int,
                          mode: str = "geo") -> np.ndarray:
    """Resample a ((2*s-1)^2, nH) bias table to ((2*d-1)^2, nH), in the
    table's type (the spline is evaluated in float64).

    mode="bicubic" resamples on the uniform grid; mode="geo" (the
    reference's default) on a geometric-progression grid of the source
    offsets, so that the outer, rarely trained offsets stretch smoothly."""
    from scipy import interpolate as si
    s = 2 * src_window - 1
    d = 2 * dst_window - 1
    nH = table.shape[1]
    t = table.reshape(s, s, nH)

    if mode == "bicubic":
        src = np.linspace(-1, 1, s)
        dst = np.linspace(-1, 1, d)
    else:
        def geo_coords(n, target_half):
            # q with 1 + q + ... + q^(n/2-1) = target_half, by bisection
            half = n // 2
            lo, hi = 1.0001, 1.5
            for _ in range(100):
                q = (lo + hi) / 2
                total = (q ** half - 1) / (q - 1)
                if total > target_half:
                    hi = q
                else:
                    lo = q
            q = (lo + hi) / 2
            pts = [0.0]
            step = 1.0
            for _ in range(half):
                pts.append(pts[-1] + step)
                step *= q
            pts = np.array(pts[1:])
            return np.concatenate([-pts[::-1], [0.0], pts])
        src = geo_coords(s - 1, (s - 1) // 2)
        src = src / src.max()
        dst_half = np.arange(1, d // 2 + 1, dtype=np.float64)
        dst = np.concatenate([-dst_half[::-1], [0.0], dst_half])
        dst = dst / dst.max()

    out = np.zeros((d, d, nH), table.dtype)
    for h in range(nH):
        f = si.RectBivariateSpline(src, src, t[:, :, h], kx=3, ky=3)
        out[:, :, h] = f(dst, dst)
    return out.reshape(d * d, nH)


# ---------------------------------------------------------------------------
# SwinV2
# ---------------------------------------------------------------------------

_LEAF = r"(weight|bias)"
# the reference SwinV2 keys the JAX converter maps, after strip_prefixes
_SWIN_KEYS = re.compile("|".join((
    rf"patch_embed\.(proj|norm)\.{_LEAF}",
    r"absolute_pos_embed",
    rf"norm\d+\.{_LEAF}",
    rf"layers\.\d+\.downsample\.(reduction|norm)\.{_LEAF}",
    rf"layers\.\d+\.blocks\.\d+\.(norm1|norm2|enorm)\.{_LEAF}",
    rf"layers\.\d+\.blocks\.\d+\.attn\.(qkv\.weight|q_bias|v_bias|"
    rf"logit_scale|proj\.{_LEAF}|rpe_mlp\.[02]\.{_LEAF}|"
    r"relative_position_bias_table)",
    rf"layers\.\d+\.blocks\.\d+\.mlp\.fc[12]\.{_LEAF}",
    r"layers\.\d+\.blocks\.\d+\.gamma_[12]",
)))
# keys the JAX converter drops without a note
_SWIN_DROPPED = re.compile(r"patch_embed\.|layers\.\d+\.downsample\.")
_BUFFERS = ("relative_position_index", "relative_coords_table", "attn_mask")


def convert_swin(sd: Mapping[str, torch.Tensor],
                 dst_windows: Optional[Dict[int, int]] = None,
                 rpe_interpolation: str = "geo") -> Tuple[StateDict,
                                                          List[str]]:
    """SwinV2 state dict -> (tensors under the port's encoder keys, report).

    dst_windows: {stage: window size} of the model; a discrete
    relative_position_bias_table from another window is resampled to it."""
    sd = strip_prefixes(sd)
    out: StateDict = {}
    report: List[str] = []
    for name, w in sd.items():
        if name.endswith(_BUFFERS):
            continue                          # static buffers, rebuilt
        if not _SWIN_KEYS.fullmatch(name):
            if not _SWIN_DROPPED.match(name):
                report.append(f"unmapped: {name}")
            continue
        if name.endswith("relative_position_bias_table"):
            stage = int(name.split(".")[1])
            src_win = int(round((np.sqrt(w.shape[0]) + 1) / 2))
            dst_win = (dst_windows or {}).get(stage, src_win)
            if dst_win != src_win:
                w = torch.from_numpy(interpolate_rpe_table(
                    w.numpy(), src_win, dst_win, rpe_interpolation))
        out[name] = w
    return out, report


# ---------------------------------------------------------------------------
# torchvision ResNet
# ---------------------------------------------------------------------------

_BN = r"(weight|bias|running_mean|running_var)"
# torchvision keys the JAX converter maps: the stem, every block's
# convolutions and BatchNorms, the projection shortcut
_RESNET_KEYS = re.compile("|".join((
    r"conv1\.weight", rf"bn1\.{_BN}",
    r"layer\d+\.\d+\.conv\d+\.weight", rf"layer\d+\.\d+\.bn\d+\.{_BN}",
    r"layer\d+\.\d+\.downsample\.0\.weight",
    rf"layer\d+\.\d+\.downsample\.1\.{_BN}",
)))
# torchvision's children -> the reference encoder's Sequential slices
# (cnn_transformer.py: multi-scale feature3 = conv1, bn1, relu, maxpool,
# layer1, layer2; feature4 = layer3; feature5 = layer4; single-scale feature
# = conv1 .. layer3)
_SLICES = {
    True: {"conv1": "feature3.0", "bn1": "feature3.1",
           "layer1": "feature3.4", "layer2": "feature3.5",
           "layer3": "feature4.0", "layer4": "feature5.0"},
    False: {"conv1": "feature.0", "bn1": "feature.1", "layer1": "feature.4",
            "layer2": "feature.5", "layer3": "feature.6",
            "layer4": "feature.7"},
}


def convert_resnet(sd: Mapping[str, torch.Tensor], multi_scale: bool = True
                   ) -> Tuple[StateDict, List[str]]:
    """torchvision resnet18 / 50 state dict -> (tensors under the trunk's
    keys - the multi-scale or single-scale encoder's slices - BatchNorm
    running statistics included, report). The classifier and the
    BatchNorms' counters are not mapped. A single-scale trunk stops at
    layer3, so a checkpoint's layer4 comes back unexpected."""
    sd = strip_prefixes(sd)
    slices = _SLICES[multi_scale]
    out: StateDict = {}
    for name, w in sd.items():
        if _RESNET_KEYS.fullmatch(name):
            head, _, rest = name.partition(".")
            out[f"{slices[head]}.{rest}"] = w
    return out, []


# ---------------------------------------------------------------------------
# cnn_transformer / resnet_only encoders
# ---------------------------------------------------------------------------

def convert_cnn_transformer(sd: Mapping[str, torch.Tensor], *,
                            multi_scale: bool = True
                            ) -> Tuple[StateDict, List[str]]:
    """A reference cnn_transformer / resnet_only state dict (the encoder's
    keys, optionally under `module.`) -> (tensors under the port encoder's
    keys, report): the ResNet trunk (through `convert_resnet`, as the JAX
    converter resequences it), the per-scale squeeze convolutions and the
    fusion (cnn_transformer.py:87-128), the nn.MultiheadAttention encoder
    layers (:192-231). A key the JAX converter reads and the file lacks
    raises KeyError, as there."""
    sd = strip_prefixes(sd, ("module.",))
    fe = "feature_extractor."
    bb = fe + "backbone."
    # the slices the trunk has (a single-scale trunk stops at layer3)
    inverse = {v: k for k, v in _SLICES[multi_scale].items()
               if multi_scale or k != "layer4"}
    trunk = {}
    for k, v in sd.items():
        if not k.startswith(bb):
            continue
        k = k[len(bb):]
        for sl, child in inverse.items():
            if k.startswith(sl + "."):
                trunk[child + k[len(sl):]] = v
                break
    resnet, report = convert_resnet(trunk, multi_scale)
    out: StateDict = {bb + k: v for k, v in resnet.items()}

    def take(*names):
        for n in names:
            out[n] = sd[n]

    def conv_bn(src):
        take(src + ".conv.weight",
             *(f"{src}.bn.{p}" for p in ("weight", "bias", "running_mean",
                                        "running_var")))

    if multi_scale:
        for i in (1, 2, 3):
            for j in (0, 1):
                conv_bn(f"{fe}feat_squeeze{i}.{j}")
        comb = fe + "feat_combine"
        take(comb + ".0.weight", comb + ".0.bias",
             *(f"{comb}.1.{p}" for p in ("weight", "bias", "running_mean",
                                        "running_var")),
             comb + ".3.weight", comb + ".3.bias")
    else:
        for j in (0, 1):
            conv_bn(f"{fe}feat_squeeze.{j}")

    layers = sorted({int(k.split(".")[1]) for k in sd
                     if k.startswith("transformer_encoder.")})
    for i in layers:
        src = f"transformer_encoder.{i}"
        take(*(f"{src}.{n}" for n in (
            "self_attn.in_proj_weight", "self_attn.in_proj_bias",
            "self_attn.out_proj.weight", "self_attn.out_proj.bias",
            "norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias",
            "ffn1.0.weight", "ffn1.0.bias", "ffn2.0.weight",
            "ffn2.0.bias")))
    return out, report


# ---------------------------------------------------------------------------
# application
# ---------------------------------------------------------------------------

def apply_pretrained(module: torch.nn.Module,
                     converted: Mapping[str, torch.Tensor]
                     ) -> Tuple[List[str], List[str]]:
    """Overlay `converted` onto `module`'s state dict non-strictly, each
    tensor cast to the module's type for it. Returns (missing, unexpected),
    the reference's load report (checkpoint.py:117-138): a parameter the
    tensors do not fill, or fill with another shape ("name (shape (file) vs
    (module))"), is missing and keeps its value; a converted key the module
    does not have is unexpected. BatchNorm running statistics are loaded
    where present and reported neither way."""
    state = module.state_dict()
    params = {k for k, _ in module.named_parameters()}
    merged: StateDict = {}
    missing: List[str] = []
    for k, v in state.items():
        pv = converted.get(k)
        if pv is not None and tuple(pv.shape) == tuple(v.shape):
            merged[k] = pv.to(v.dtype)
        elif k in params:
            missing.append(k if pv is None else
                           f"{k} (shape {tuple(pv.shape)} vs "
                           f"{tuple(v.shape)})")
    unexpected = [k for k in converted
                  if k not in state and not k.endswith(_STATISTICS)]
    module.load_state_dict(merged, strict=False)
    return missing, unexpected
