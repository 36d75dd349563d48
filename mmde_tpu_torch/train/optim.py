"""Optimizer: AdamW with Swin layer-wise LR decay and selective weight decay.

Counterpart of mmde_tpu/train/optim.py:
  * per-parameter lr scale = layer_decay ^ (num_layers - layer_id - 1), the
    layer id read off the parameter's place in the network (patch_embed -> 0,
    block j of stage i -> 1 + j + sum of the stages before it, each +1 for
    its patch merging; downsample of stage i -> the stage boundary;
    everything else - output norm, decoder, heads - -> num_layers - 1);
  * no weight decay for parameters of rank <= 1 (biases, norms, q/v bias)
    and for the RPE MLP, relative_position_bias_table and logit_scale;
  * the polynomial warm-up / decay LR schedule, 1-based in the step;
  * frozen stages: the whole update (Adam step and weight decay) zeroed.

Layer ids and the no-decay rule are computed on the port's parameter names
(`encoder.layers.0.blocks.3.attn.qkv.weight`, `encoder.layers.1.downsample.
reduction.weight`; under glpdepth_scale16 `net.encoder.layers.N`): the JAX
tree's `rpe_fc1` / `rpe_fc2` are `rpe_mlp.0` / `rpe_mlp.2` here, so the
no-decay names differ, and the cnn_transformer's packed `in_proj_bias` is
decayed as the JAX tree's per-head (nH, Dh) q / k / v biases are. The JAX package's
`blocks_scan` branch (one leaf covering all blocks of a scanned stage) has
no counterpart: the port has no scanned layout.

The update is the JAX package's one expression per parameter,

    p += -lr * comb * ((m / bc1) / (sqrt(v / bc2) + eps) + wd * p)

with float32 moments, as a `torch.optim.Optimizer` over `torch._foreach_*`
ops (parameters that share a (comb, wd) pair form one group). There it was
an XLA fusion, never a hand-written kernel; its `fused=True` and
`fused=False` forms compute the same numbers and the port keeps one.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Sequence, Tuple, Union

import torch

NO_DECAY_NAMES = ("relative_position_bias_table", "rpe_mlp", "logit_scale")
# 1-D here but (nH, Dh) leaves in the JAX tree (flax's attention keeps the
# q / k / v biases per head), where the rank rule decays them
DECAY_1D_NAMES = ("in_proj_bias",)

NamedParams = Union[torch.nn.Module, Iterable[Tuple[str, torch.Tensor]]]


def _named(params: NamedParams):
    if isinstance(params, torch.nn.Module):
        return list(params.named_parameters())
    return list(params)


def poly_lr_schedule(max_lr: float, min_lr: float, steps_per_epoch: int,
                     epochs: int, power: float = 0.9
                     ) -> Callable[[int], float]:
    """Per-step LR: polynomial warm-up over the first half of training, then
    polynomial decay floored at min_lr. `schedule(count)` takes the number
    of updates already made (0-based); the formula is 1-based in the step,
    as the reference increments its step before computing the LR."""
    half = epochs // 2
    denom = float(steps_per_epoch * half)

    def schedule(count: int) -> float:
        step = float(count) + 1.0
        # one epoch (half = 0): no warm-up, the decay from +inf floors at
        # min_lr, as the JAX package's float division gives
        frac = step / denom if denom else math.inf
        if step < denom:
            return (max_lr - min_lr) * frac ** power + min_lr
        # a negative base has no real power: clamp (frac >= 1 here anyway)
        decay_frac = max(frac - 1.0, 0.0)
        return max(min_lr, (min_lr - max_lr) * decay_frac ** power + max_lr)

    return schedule


def swin_layer_id(name: str, layers_per_stage: Sequence[int],
                  num_layers: int) -> int:
    """Depth index of the parameter called `name` (a dotted module path).
    `layers_per_stage` already includes the +1 patch-merging increment of
    every stage but the last."""
    parts = name.split(".")
    if any(p.startswith("patch_embed") for p in parts) or \
            "absolute_pos_embed" in parts:
        return 0
    for i, p in enumerate(parts[:-1]):
        if p == "layers" and parts[i + 1].isdigit():
            stage = int(parts[i + 1])
            rest = parts[i + 2:]
            if len(rest) > 1 and rest[0] == "blocks" and rest[1].isdigit():
                return 1 + int(rest[1]) + sum(layers_per_stage[:stage])
            if rest and rest[0] == "downsample":
                return sum(layers_per_stage[:stage + 1])
            break
    return num_layers - 1


def build_layer_scales(params: NamedParams, depths: Sequence[int],
                       layer_decay_rate: float) -> Dict[str, float]:
    """{parameter name: static LR scale}."""
    layers_per_stage = [d + 1 for d in depths[:-1]] + [depths[-1]]
    num_layers = sum(layers_per_stage) + 2   # + patch embed, head
    return {name: layer_decay_rate ** (
        num_layers - swin_layer_id(name, layers_per_stage, num_layers) - 1)
        for name, _ in _named(params)}


def weight_decay_mask(params: NamedParams) -> Dict[str, bool]:
    """{parameter name: True where weight decay applies}: not for rank <= 1
    (but the attention projections' packed biases, DECAY_1D_NAMES, which
    the JAX tree holds per head), not for the RPE / logit-scale
    parameters."""
    def decay(name: str, p: torch.Tensor) -> bool:
        if p.dim() <= 1 and not name.endswith(DECAY_1D_NAMES):
            return False
        return not any(nd in part for nd in NO_DECAY_NAMES
                       for part in name.split("."))

    return {name: decay(name, p) for name, p in _named(params)}


def frozen_stage_scales(params: NamedParams, frozen_stages: int
                        ) -> Dict[str, float]:
    """{parameter name: 0.0 if frozen by `frozen_stages` else 1.0}:
    frozen_stages >= 0 freezes patch_embed, >= 1 absolute_pos_embed,
    >= i + 2 stage i. Multiplies the whole update, so it zeroes the Adam
    step and the weight decay alike (the module's detach already stops
    their gradients; decay would otherwise still shrink them)."""
    def scale(name: str) -> float:
        parts = name.split(".")
        if frozen_stages >= 0 and any(p.startswith("patch_embed")
                                      for p in parts):
            return 0.0
        if frozen_stages >= 1 and "absolute_pos_embed" in parts:
            return 0.0
        for i, p in enumerate(parts[:-1]):
            if p == "layers" and parts[i + 1].isdigit():
                if frozen_stages >= int(parts[i + 1]) + 2:
                    return 0.0
        return 1.0

    return {name: scale(name) for name, _ in _named(params)}


class LayerDecayAdamW(torch.optim.Optimizer):
    """AdamW whose per-parameter update is
    p += -lr(count) * comb * ((m/bc1) / (sqrt(v/bc2) + eps) + wd * p),
    comb = layer-decay scale x frozen 0/1. Parameters are grouped by their
    (comb, wd) pair; moments are float32 tensors shaped like the parameter.
    A parameter without a gradient counts as gradient zero (its weight
    decay still applies), unless comb is 0. The number of updates made is
    kept in every group ("count"), so state_dict() carries it."""

    def __init__(self, named_params: NamedParams,
                 schedule: Callable[[int], float], *, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 scales: Dict[str, float] = None,
                 frozen: Dict[str, float] = None):
        named = _named(named_params)
        wd_on = weight_decay_mask(named)
        groups: Dict[Tuple[float, float], dict] = {}
        for name, p in named:
            comb = 1.0 if scales is None else scales[name]
            if frozen is not None:
                comb *= frozen[name]
            wd = weight_decay if wd_on[name] else 0.0
            g = groups.setdefault((comb, wd), {
                "params": [], "names": [], "comb": comb, "wd": wd})
            g["params"].append(p)
            g["names"].append(name)
        super().__init__(list(groups.values()),
                         dict(b1=b1, b2=b2, eps=eps, count=0))
        self.schedule = schedule

    @property
    def count(self) -> int:
        """Updates made so far."""
        return self.param_groups[0]["count"]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        t = self.count + 1
        lr = self.schedule(self.count)
        for group in self.param_groups:
            group["count"] = t
            comb, wd = group["comb"], group["wd"]
            if comb == 0.0:
                continue
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            bc1 = 1.0 - b1 ** t
            bc2 = 1.0 - b2 ** t
            ps, gs, ms, vs = [], [], [], []
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state["m"] = torch.zeros_like(p, dtype=torch.float32)
                    state["v"] = torch.zeros_like(p, dtype=torch.float32)
                ps.append(p)
                gs.append(p.grad if p.grad is not None
                          else torch.zeros_like(p))
                ms.append(state["m"])
                vs.append(state["v"])
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, gs, alpha=1.0 - b1)
            torch._foreach_mul_(vs, b2)
            torch._foreach_addcmul_(vs, gs, gs, value=1.0 - b2)
            denom = torch._foreach_div(vs, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_div(ms, bc1)
            torch._foreach_div_(upd, denom)
            if wd:
                torch._foreach_add_(upd, ps, alpha=wd)
            torch._foreach_add_(ps, upd, alpha=-lr * comb)
        return loss


def build_optimizer(model: torch.nn.Module, *, backbone: str,
                    depths: Sequence[int], max_lr: float, min_lr: float,
                    weight_decay: float, layer_decay: float,
                    steps_per_epoch: int, epochs: int, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8,
                    frozen_stages: int = -1,
                    device: Union[str, torch.device] = "cuda"):
    """AdamW + (for swin backbones) layer-decay scaling + poly LR schedule
    over `model`'s parameters. Returns (optimizer, schedule). For non-swin
    backbones the LR is flat across parameters. `frozen_stages` zeroes the
    whole update of frozen swin subtrees. `model` must live on `device`,
    which defaults to the CUDA card (tests pass device="cpu")."""
    from mmde_tpu_torch.models.two_frame import require_device
    require_device(device, model, "build_optimizer")
    schedule = poly_lr_schedule(max_lr, min_lr, steps_per_epoch, epochs)
    scales = frozen = None
    if "swin" in backbone:
        scales = build_layer_scales(model, depths, layer_decay)
        if frozen_stages >= 0:
            frozen = frozen_stage_scales(model, frozen_stages)
    opt = LayerDecayAdamW(model, schedule, weight_decay=weight_decay, b1=b1,
                          b2=b2, eps=eps, scales=scales, frozen=frozen)
    return opt, schedule
