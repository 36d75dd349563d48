"""SwinTransformerV2 backbone — PyTorch, NHWC at every public function.

Counterpart of mmde_tpu/nn/swin_v2.py:

  * cosine-similarity window attention with a learned log temperature clamped
    at ln(100), through mmde_tpu_torch.ops (plain PyTorch, or the CUDA
    kernels: packed where the JAX package's packed layout applies,
    head-split elsewhere, stage by stage as there; with attn_impl
    "cuda_slab", the JAX package's "pallas_slab", the slab kernels read the
    windows straight off the map wherever its `slab_plan` admits a block);
  * continuous relative position bias: 2-layer MLP over a log-spaced
    relative-coordinate table, sigmoid output x16 (applied on the table);
  * split q/v bias with an implicit zero k bias;
  * post-norm (default) and pre-norm + layerscale block variants;
  * cyclic-shift SW-MSA with the additive 0/-100 region mask, built with
    numpy on the padded map and cached per map size;
  * PatchMerging / PatchReduction1C / ConvPatchMerging downsampling,
    PatchEmbed conv-4x4 (any input channel count: 5 with sparse depth) or
    the ResNet-style `ResNetDLNPatchEmbed`;
  * the absolute position embedding (`ape`), resized to the map by
    jax.image.resize's bicubic (`resize_bicubic`, its own weights);
  * strid16 mode, per-stage window/shift flags, stochastic-depth schedule,
    fp32 LayerNorm on the outputs.

Every stage runs the map path (pad -> roll -> partition -> attention ->
reverse -> roll back -> crop, per block); a slab block (attn_impl
"cuda_slab", `slab_plan` not None) drops the partition and the reverse:
pad -> roll -> attention on the map -> roll back -> crop, as the JAX
package's slab blocks do. The JAX package's window residency on padded maps
(`resident_pad_max`) and its `scan_blocks` layout are accepted as arguments
and ignored: residency matches the map path at real token positions (and
the JAX package keeps the per-block path for "pallas_slab" anyway), scanning
only shrinks an XLA graph.

Training: gradients flow through every attention implementation (the CUDA
forward and backward kernels for "cuda" and "cuda_slab" on CUDA tensors).
Rematerialisation follows `use_checkpoint` (per stage) and `remat_policy`:
"none" keeps every activation (the flagship's setting), "full" recomputes
each block in the backward (torch.utils.checkpoint, non-reentrant; the
block's drop-path masks are drawn outside the recomputed region so both
runs see one draw), "mlp_only" recomputes the MLP alone. "attn_out" keeps
the block input and the attention's output (the JAX package's
`swin_attn_out`) and recomputes the rest; "attn_qkv" also keeps the qkv
projection (`swin_qkv`) of the blocks where the JAX package names it, the
packed and slab ones. Both split the block into checkpointed segments that
end at the kept tensors (`BasicLayer._block`), so the backward replays the
attention forward from its kept input (the forward kernel with the
log-sum-exp) before the backward kernel. Remat changes memory, never
values.

Parameter names follow the reference PyTorch implementation
(`layers.0.blocks.0.attn.qkv.weight`, `attn.rpe_mlp.0/2`, `norm3.weight`).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mmde_tpu_torch.nn.layers import (Conv2d, DropPath, LayerNormFP32, Linear,
                                      Mlp, lecun_normal_)
from mmde_tpu_torch.ops.window_attention import (cosine_window_attention,
                                                 scaled_window_attention)
from mmde_tpu_torch.ops.window_attention_headsplit import (
    cosine_window_attention_headsplit)
from mmde_tpu_torch.ops.window_attention_packed import (
    HEAD_DIM, cosine_window_attention_packed, packed_layout_ok)
from mmde_tpu_torch.ops.window_attention_slab import (
    cosine_window_attention_slab, slab_plan, window_partition,
    window_reverse)

_REMAT_POLICIES = ("full", "attn_out", "attn_qkv", "mlp_only", "none")
ATTN_IMPLS = ("torch", "cuda", "cuda_slab")


# ---------------------------------------------------------------------------
# Static window bookkeeping — numpy, shape-only.
# ---------------------------------------------------------------------------

def relative_coords_table(window_size: Tuple[int, int],
                          pretrain_window_size: int = -1,
                          table_type: str = "norm8_log_bylayer") -> np.ndarray:
    """Log-spaced relative-coordinate grid fed to the RPE MLP:
    ((2Wh-1)*(2Ww-1), 2) float32, for table types linear, linear_bylayer,
    norm8_log, norm8_log_bylayer."""
    wh, ww = window_size
    if table_type.endswith("_bylayer") and pretrain_window_size == 1:
        raise ValueError(
            f"table_type={table_type!r} with pretrain_window_size=1 divides "
            "by zero; set a real pretrain window or a non-_bylayer table "
            "type")
    ch = np.arange(-(wh - 1), wh, dtype=np.float32)
    cw = np.arange(-(ww - 1), ww, dtype=np.float32)
    table = np.stack(np.meshgrid(ch, cw, indexing="ij"), axis=-1)
    if table_type == "linear":
        table[..., 0] /= (wh - 1)
        table[..., 1] /= (ww - 1)
    elif table_type == "linear_bylayer":
        table /= (pretrain_window_size - 1)
    elif table_type in ("norm8_log", "norm8_log_bylayer"):
        if table_type == "norm8_log":
            table[..., 0] /= (wh - 1)
            table[..., 1] /= (ww - 1)
        else:
            table /= (pretrain_window_size - 1)
        table *= 8.0
        table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    else:
        raise NotImplementedError(table_type)
    return table.reshape(-1, 2).astype(np.float32)


def relative_position_index(window_size: Tuple[int, int]) -> np.ndarray:
    """(N, N) int32 index into the flattened (2Wh-1)(2Ww-1) bias table."""
    wh, ww = window_size
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing="ij"))             # (2, Wh, Ww)
    flat = coords.reshape(2, -1)                              # (2, N)
    rel = flat[:, :, None] - flat[:, None, :]                 # (2, N, N)
    rel = rel.transpose(1, 2, 0).astype(np.int64)             # (N, N, 2)
    rel[..., 0] += wh - 1
    rel[..., 1] += ww - 1
    rel[..., 0] *= 2 * ww - 1
    return rel.sum(-1).astype(np.int32)


def rpe_bias_from_table(table: torch.Tensor, Wh: int,
                        Ww: int) -> torch.Tensor:
    """Expand a ((2Wh-1)(2Ww-1), nH) relative-position table to the
    (N, N, nH) per-token-pair bias: table[relative_position_index]. (The JAX
    package builds the same values gather-free, as a block-Toeplitz
    matrix; an index gather is the PyTorch idiom.)"""
    index = torch.as_tensor(relative_position_index((Wh, Ww)),
                            dtype=torch.long, device=table.device)
    return table[index]


def shifted_window_mask(Hp: int, Wp: int, ws: int, ss: int) -> np.ndarray:
    """Additive 0/-100 mask (nW, N, N) separating the 9 cyclic-shift regions
    of the PADDED (Hp, Wp) map."""
    img = np.zeros((Hp, Wp), dtype=np.float32)
    cnt = 0
    for hs in (slice(0, Hp - ws), slice(Hp - ws, Hp - ss), slice(Hp - ss, Hp)):
        for wsl in (slice(0, Wp - ws), slice(Wp - ws, Wp - ss),
                    slice(Wp - ss, Wp)):
            img[hs, wsl] = cnt
            cnt += 1
    m = img.reshape(Hp // ws, ws, Wp // ws, ws)
    m = m.transpose(0, 2, 1, 3).reshape(-1, ws * ws)          # (nW, N)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def pad_keep_mask(H: int, W: int, Hp: int, Wp: int, ws: int,
                  ss: int = 0) -> np.ndarray:
    """(nW, N, 1) multiplicative 1/0 mask marking real (non-pad) tokens of a
    padded (Hp, Wp) map in window-partitioned layout, optionally after a
    cyclic (-ss, -ss) roll."""
    keep = np.zeros((Hp, Wp), dtype=np.float32)
    keep[:H, :W] = 1.0
    if ss:
        keep = np.roll(keep, (-ss, -ss), axis=(0, 1))
    k = keep.reshape(Hp // ws, ws, Wp // ws, ws)
    return k.transpose(0, 2, 1, 3).reshape(-1, ws * ws, 1)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class WindowAttention(nn.Module):
    """W-MSA with cosine attention + continuous RPE on (B*nW, N, C) windows,
    or on the (B, Hp, Wp, C) map for the slab kernels.

    attn_impl "cuda" sends cosine attention to a fused kernel (for CUDA
    tensors; its plain version for CPU tensors), chosen as the JAX package
    chooses for "pallas": `cosine_window_attention_packed` on qkv as the
    Linear emits it where `packed_layout_ok` (C a multiple of 128, heads in
    whole 128-lane groups), `cosine_window_attention_headsplit` on split
    heads elsewhere. "cuda_slab" routes windows exactly so, and takes a
    rank-4 map (SwinBlock hands one over where `slab_plan` admits the block)
    to `cosine_window_attention_slab`: the qkv Linear and the q/v bias run on
    the padded map (pointwise over C, so they commute with windowing), the
    kernels read each window off it, `proj` runs on the output map, and bias
    and mask stay float32 whatever the model's type, as the JAX slab path
    keeps them. "torch" splits heads and runs the plain functions of
    ops.window_attention. attn_type "normal" has no kernel in either package
    and always takes the plain function.
    """

    def __init__(self, dim: int, window_size: Tuple[int, int], num_heads: int,
                 qkv_bias: bool = True, attn_type: str = "cosine_mh",
                 rpe_table_type: str = "norm8_log_bylayer",
                 rpe_hidden_dim: int = 512, rpe_output_type: str = "sigmoid",
                 pretrain_window_size: int = -1, fp32_out: bool = False,
                 attn_impl: str = "torch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                             f"{attn_impl!r}")
        if attn_type not in ("cosine_mh", "normal"):
            raise NotImplementedError(attn_type)
        if (attn_impl != "torch" and attn_type == "cosine_mh"
                and dim // num_heads != HEAD_DIM):
            raise NotImplementedError(
                f"attn_impl={attn_impl!r} needs head_dim {HEAD_DIM}, got "
                f"{dim}/{num_heads}")
        self.dim = dim
        self.window_size = tuple(window_size)
        self.num_heads = num_heads
        self.attn_type = attn_type
        self.rpe_table_type = rpe_table_type
        self.rpe_output_type = rpe_output_type
        self.attn_impl = attn_impl
        self.dtype = dtype

        self.qkv = Linear(dim, 3 * dim, bias=False, dtype=dtype)
        if qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(dim))
            self.v_bias = nn.Parameter(torch.zeros(dim))
        else:
            self.q_bias = self.v_bias = None
        if attn_type == "cosine_mh":
            self.logit_scale = nn.Parameter(
                torch.full((num_heads, 1, 1), float(np.log(10.0))))
        else:
            self.logit_scale = None
        wh, ww = self.window_size
        if rpe_table_type == "none":
            self.relative_position_bias_table = nn.Parameter(
                torch.zeros((2 * wh - 1) * (2 * ww - 1), num_heads))
            nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        else:
            # Sequential indices 0 / 2 are the reference's names
            self.rpe_mlp = nn.Sequential(
                Linear(2, rpe_hidden_dim, bias=True),
                nn.ReLU(),
                Linear(rpe_hidden_dim, num_heads, bias=False))
            self.register_buffer(
                "relative_coords_table",
                torch.from_numpy(relative_coords_table(
                    self.window_size, pretrain_window_size, rpe_table_type)),
                persistent=False)
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(self.window_size)
                             ).long(), persistent=False)
        self.proj = Linear(dim, dim,
                           dtype=torch.float32 if fp32_out else dtype)
        for m in (self.qkv, self.proj):
            nn.init.trunc_normal_(m.weight, std=0.02)
        # eval-mode cache of the expanded bias: (key, tensor)
        self._bias_cache: Optional[Tuple[tuple, torch.Tensor]] = None

    def _rpe_table(self) -> torch.Tensor:
        """((2Wh-1)(2Ww-1), nH) float32; 16*sigmoid applied here, on the
        small table, not on the expanded bias (exact: an elementwise map
        commutes with the gather)."""
        if self.rpe_table_type == "none":
            table = self.relative_position_bias_table
        else:
            table = self.rpe_mlp(self.relative_coords_table)
        table = table.float()
        if self.rpe_output_type == "sigmoid":
            table = 16.0 * torch.sigmoid(table)
        return table

    def _expanded_bias(self) -> torch.Tensor:
        """table[relative_position_index] as (nH, N, N). index_select, not
        advanced indexing: the values are the same, but its backward is an
        index_add (atomics) where advanced indexing sorts the N*N indices
        on every step."""
        table = self._rpe_table()                              # (T, nH)
        idx = self.relative_position_index
        return torch.index_select(table.t(), 1, idx.reshape(-1)).reshape(
            (self.num_heads,) + tuple(idx.shape))

    def rpe_bias(self) -> torch.Tensor:
        """(nH, N, N) float32 bias. Cached while no gradient is recorded and
        the parameters it derives from are unchanged. The cached tensor is
        built outside inference mode even when the caller is inside it: a
        later training forward with frozen RPE parameters takes it from the
        cache and saves it for the backward, which an inference tensor
        cannot be."""
        params = ([self.relative_position_bias_table]
                  if self.rpe_table_type == "none"
                  else list(self.rpe_mlp.parameters()))
        cacheable = not (torch.is_grad_enabled()
                         and any(p.requires_grad for p in params))
        if not cacheable:
            self._bias_cache = None
            return self._expanded_bias()
        key = tuple((p.data_ptr(), p._version) for p in params)
        if self._bias_cache is None or self._bias_cache[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                self._bias_cache = (key, self._expanded_bias())
        return self._bias_cache[1]

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B*nW, N, C) windows, or - slab blocks only - the padded,
        rolled (B, Hp, Wp, C) map; returns the same layout."""
        return self.attend(self.project_qkv(x), mask)

    def project_qkv(self, x: torch.Tensor) -> torch.Tensor:
        """The qkv projection with the q / v bias, in x's layout."""
        qkv = self.qkv(x)
        if self.q_bias is not None:
            # k has no bias: concat(q_bias, 0, v_bias) after a bias-free Linear
            bias_vec = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                                  self.v_bias]).to(qkv.dtype)
            qkv = qkv + bias_vec
        return qkv

    def packed(self, N: int) -> bool:
        """Whether windows of N tokens take the packed kernels."""
        C = self.dim
        return (self.attn_type == "cosine_mh"
                and self.attn_impl in ("cuda", "cuda_slab")
                and packed_layout_ok(N, self.num_heads, C // self.num_heads,
                                     C))

    def attend(self, qkv: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Attention of a qkv projection and the output projection, in the
        layout `forward` takes."""
        nH = self.num_heads
        if qkv.dim() == 4 and not (self.attn_impl == "cuda_slab"
                                   and self.attn_type == "cosine_mh"):
            raise ValueError("a (B, Hp, Wp, C) map goes to the slab kernels "
                             "only: attn_impl='cuda_slab', cosine attention")
        bias = self.rpe_bias()
        if qkv.dim() == 4:
            # float32 bias and mask, as the JAX slab path keeps them
            return self.proj(cosine_window_attention_slab(
                qkv, self.logit_scale, bias, mask, num_heads=nH,
                window_size=self.window_size[0]))

        B_, N, C3 = qkv.shape
        C = C3 // 3
        Dh = C // nH
        fused = (self.attn_type == "cosine_mh"
                 and self.attn_impl in ("cuda", "cuda_slab"))
        if self.packed(N):
            if self.dtype == torch.bfloat16:
                # bf16 models stream bias and mask in bf16 on the packed path
                # only, as the JAX package does: the mask is exact (0 / -100),
                # the bias loses ~0.4% relative
                bias = bias.to(torch.bfloat16)
                if mask is not None:
                    mask = mask.to(torch.bfloat16)
            out = cosine_window_attention_packed(
                qkv.contiguous(), self.logit_scale, bias, mask, num_heads=nH,
                maxfree=self.rpe_output_type == "sigmoid")
        else:
            # views of qkv, read in place by the head-split kernel
            q, k, v = qkv.reshape(B_, N, 3, nH, Dh).permute(2, 0, 3, 1,
                                                            4).unbind(0)
            if fused:       # float32 bias and mask, as in the JAX package
                out = cosine_window_attention_headsplit(
                    q, k, v, self.logit_scale, bias, mask)
            elif self.attn_type == "cosine_mh":
                out = cosine_window_attention(q, k, v, self.logit_scale,
                                              bias, mask)
            else:
                out = scaled_window_attention(q, k, v, Dh ** -0.5, bias, mask)
            out = out.permute(0, 2, 1, 3).reshape(B_, N, C)
        return self.proj(out)


class SwinBlock(nn.Module):
    """One Swin block (post-norm default / pre-norm + layerscale variant) on
    an NHWC map: pad bottom/right with zeros -> roll (-ss, -ss) -> partition
    -> attention -> reverse -> roll back -> crop. A slab block (attn_impl
    "cuda_slab", cosine attention, `slab_plan` not None for its window, map
    width and heads) hands the rolled map to attention whole: no partition,
    no reverse (the JAX package's `use_slab`). Elsewhere "cuda_slab" takes
    the windows path and routes as "cuda" does, as the JAX package routes
    "pallas_slab" there."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift_size: int = 0, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.0,
                 postnorm: bool = True, init_values: Optional[float] = None,
                 use_mlp_norm: bool = False, endnorm: bool = False,
                 attn_type: str = "cosine_mh",
                 rpe_table_type: str = "norm8_log_bylayer",
                 rpe_hidden_dim: int = 512, rpe_output_type: str = "sigmoid",
                 pretrain_window_size: int = -1, mlpfp32: bool = False,
                 attn_impl: str = "torch",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 remat_mlp: bool = False):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.postnorm = postnorm
        self.remat_mlp = remat_mlp      # recompute the MLP in the backward
        self.norm1 = LayerNormFP32(dim)
        self.attn = WindowAttention(
            dim, (window_size, window_size), num_heads, qkv_bias=qkv_bias,
            attn_type=attn_type, rpe_table_type=rpe_table_type,
            rpe_hidden_dim=rpe_hidden_dim, rpe_output_type=rpe_output_type,
            pretrain_window_size=pretrain_window_size, fp32_out=mlpfp32,
            attn_impl=attn_impl, dtype=dtype)
        self.drop_path = DropPath(drop_path_rate, generator=generator)
        self.norm2 = LayerNormFP32(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype,
                       use_norm=use_mlp_norm, fp32_out=mlpfp32)
        for m in (self.mlp.fc1, self.mlp.fc2):
            nn.init.trunc_normal_(m.weight, std=0.02)
        if not postnorm and init_values is not None and init_values >= 0:
            self.gamma_1 = nn.Parameter(torch.full((dim,), float(init_values)))
            self.gamma_2 = nn.Parameter(torch.full((dim,), float(init_values)))
        else:
            self.gamma_1 = self.gamma_2 = None
        self.enorm = LayerNormFP32(dim) if endnorm else None

    def draw_drop_path(self, x: torch.Tensor):
        """The block's two drop-path keep masks, in the order forward draws
        them."""
        return self.drop_path.draw(x), self.drop_path.draw(x)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat_mlp and torch.is_grad_enabled() and x.requires_grad:
            return checkpoint(self.mlp, x, use_reentrant=False)
        return self.mlp(x)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                keeps=None) -> torch.Tensor:
        """`keeps`: drop-path masks from `draw_drop_path`, for a caller that
        runs this forward twice (remat); None draws them here."""
        keeps = keeps if keeps is not None else self.draw_drop_path(x)
        return self.residual(x, self.attention(x, mask), keeps)

    def _padded(self, x: torch.Tensor) -> Tuple[int, int]:
        ws = self.window_size
        return (-(-x.shape[1] // ws) * ws, -(-x.shape[2] // ws) * ws)

    def slab(self, x: torch.Tensor) -> bool:
        """Whether the block hands its map (block input x) to the slab
        kernels whole."""
        C, nH = x.shape[-1], self.attn.num_heads
        return (self.attn.attn_impl == "cuda_slab"
                and self.attn.attn_type == "cosine_mh"
                and slab_plan(self.window_size, self._padded(x)[1], nH,
                              C // nH, C) is not None)

    def names_qkv(self, x: torch.Tensor) -> bool:
        """Whether the JAX package names this block's qkv projection
        (`swin_qkv`, kept under remat "attn_qkv"): on the slab and packed
        paths."""
        return self.slab(x) or self.attn.packed(self.window_size ** 2)

    def attention_input(self, x: torch.Tensor) -> torch.Tensor:
        """Block input -> what the attention takes: (pre-norm) -> pad ->
        roll -> partition into (B*nW, ws*ws, C) windows, or the rolled map
        itself for a slab block."""
        ws, ss = self.window_size, self.shift_size
        slab = self.slab(x)
        if not self.postnorm:
            x = self.norm1(x)
        Hp, Wp = self._padded(x)
        if Hp != x.shape[1] or Wp != x.shape[2]:
            x = F.pad(x, (0, 0, 0, Wp - x.shape[2], 0, Hp - x.shape[1]))
        if ss > 0:
            x = torch.roll(x, (-ss, -ss), dims=(1, 2))
        return x if slab else window_partition(x, ws)

    def qkv(self, x: torch.Tensor) -> torch.Tensor:
        """Block input -> the qkv projection (`swin_qkv`)."""
        return self.attn.project_qkv(self.attention_input(x))

    def attend(self, qkv: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The qkv projection -> the attention's output (`swin_attn_out`)."""
        return self.attn.attend(qkv, mask if self.shift_size > 0 else None)

    def attention(self, x: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Block input -> the attention's output (`swin_attn_out`): windows,
        or the map for a slab block."""
        return self.attend(self.qkv(x), mask)

    def residual(self, x: torch.Tensor, attn: torch.Tensor,
                 keeps) -> torch.Tensor:
        """Block input and the attention's output -> the block's output:
        reverse the partition, roll back, crop, then the residual branches
        with their drop-path masks `keeps`."""
        H, W = x.shape[1:3]
        ws, ss = self.window_size, self.shift_size
        keep1, keep2 = keeps
        shortcut = x
        if attn.dim() == 4:
            x = attn                                     # the map, in place
        else:
            x = window_reverse(attn, ws, *self._padded(shortcut))
        if ss > 0:
            x = torch.roll(x, (ss, ss), dims=(1, 2))
        if x.shape[1] != H or x.shape[2] != W:
            x = x[:, :H, :W, :]

        if self.postnorm:
            x = shortcut + self.drop_path(self.norm1(x), keep1)
            x = x + self.drop_path(self.norm2(self._mlp(x)), keep2)
        else:
            g1 = 1.0 if self.gamma_1 is None else self.gamma_1.to(x.dtype)
            g2 = 1.0 if self.gamma_2 is None else self.gamma_2.to(x.dtype)
            x = shortcut + self.drop_path(g1 * x, keep1)
            x = x + self.drop_path(g2 * self._mlp(self.norm2(x)), keep2)
        if self.enorm is not None:
            x = self.enorm(x)
        return x


class PatchMerging(nn.Module):
    """2x downsample: 2x2 space-to-depth + linear 4C->2C. Channel order of
    the concat is (0,0), (1,0), (0,1), (1,1) in (row, col) offsets."""

    def __init__(self, dim: int, postnorm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.postnorm = postnorm
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, dtype=dtype)
        nn.init.trunc_normal_(self.reduction.weight, std=0.02)
        self.norm = LayerNormFP32(2 * dim if postnorm else 4 * dim)

    def forward(self, x):
        B, H, W, C = x.shape
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x0 = x[:, 0::2, 0::2]
        x1 = x[:, 1::2, 0::2]
        x2 = x[:, 0::2, 1::2]
        x3 = x[:, 1::2, 1::2]
        x = torch.cat([x0, x1, x2, x3], dim=-1)          # (B, H/2, W/2, 4C)
        if self.postnorm:
            return self.norm(self.reduction(x))
        return self.reduction(self.norm(x))


class PatchReduction1C(nn.Module):
    """Channel-preserving reduction used by strid16 mode: linear C->C +
    norm, no spatial change."""

    def __init__(self, dim: int, postnorm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.postnorm = postnorm
        self.reduction = Linear(dim, dim, bias=False, dtype=dtype)
        nn.init.trunc_normal_(self.reduction.weight, std=0.02)
        self.norm = LayerNormFP32(dim)

    def forward(self, x):
        if self.postnorm:
            return self.norm(self.reduction(x))
        return self.reduction(self.norm(x))


class ConvPatchMerging(nn.Module):
    """Conv 3x3 stride-2 (padding 1) downsample variant, C -> 2C."""

    def __init__(self, dim: int, postnorm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.postnorm = postnorm
        self.reduction = Conv2d(dim, 2 * dim, 3, stride=2, padding=1,
                                dtype=dtype)
        self.norm = LayerNormFP32(2 * dim if postnorm else dim)

    def _conv(self, x):
        return self.reduction(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def forward(self, x):
        if self.postnorm:
            return self.norm(self._conv(x))
        return self._conv(self.norm(x))


class PatchEmbed(nn.Module):
    """Conv 4x4 stride-4 patchify + optional norm; NHWC in, NHWC out."""

    def __init__(self, embed_dim: int = 96, patch_size: int = 4,
                 patch_norm: bool = True, in_chans: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Conv2d(in_chans, embed_dim, patch_size, stride=patch_size,
                           dtype=dtype)
        nn.init.trunc_normal_(self.proj.weight, std=0.02)
        nn.init.zeros_(self.proj.bias)
        self.norm = LayerNormFP32(embed_dim) if patch_norm else None

    def forward(self, x):
        ps = self.patch_size
        B, H, W, C = x.shape
        pad_b = (ps - H % ps) % ps
        pad_r = (ps - W % ps) % ps
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        x = self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if self.norm is not None:
            x = self.norm(x)
        return x


class ResNetDLNPatchEmbed(nn.Module):
    """ResNet-style stem patch embed, total stride 4: conv 3x3 s2 (64) ->
    LayerNorm -> GELU -> conv 3x3 (64) -> LayerNorm -> GELU -> conv 3x3
    (embed_dim) -> LayerNorm -> GELU -> max pool 3x3 s2, every stride-2 op
    padded (1, 1) as torch pads; NHWC in, NHWC out. Names mirror the JAX
    module (`conv1`, `ln1`, `conv2`, `ln2`, `conv3`, `norm`); convolutions
    bias-free with flax's initialiser."""

    def __init__(self, embed_dim: int = 96, in_chans: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()

        def conv(cin, cout, stride):
            m = Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False,
                       dtype=dtype)
            lecun_normal_(m.weight)
            return m

        self.conv1 = conv(in_chans, 64, 2)
        self.ln1 = LayerNormFP32(64)
        self.conv2 = conv(64, 64, 1)
        self.ln2 = LayerNormFP32(64)
        self.conv3 = conv(64, embed_dim, 1)
        self.norm = LayerNormFP32(embed_dim)

    def forward(self, x):
        B, H, W, C = x.shape
        pad_b, pad_r = (4 - H % 4) % 4, (4 - W % 4) % 4
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        for conv, norm in ((self.conv1, self.ln1), (self.conv2, self.ln2),
                           (self.conv3, self.norm)):
            x = conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            x = F.gelu(norm(x))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1)
        return x.permute(0, 2, 3, 1)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel at a = -0.5 of |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def bicubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of `jax.image.resize(...,
    "bicubic")` along one axis (antialias on, its default): half-pixel
    sample positions, Keys' kernel at a = -0.5 stretched by the shrink
    factor when shrinking, each column renormalised to sum 1, zero for a
    sample outside the input. `F.interpolate(mode="bicubic")` is another
    function (a = -0.75, clamped edges, no antialias)."""
    scale = np.float32(out_size / in_size)
    inv = np.float32(1.0) / scale
    kscale = max(inv, np.float32(1.0))
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv
              - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]
               ) / kscale
    w = _keys_cubic(x)
    tot = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(tot != 0, tot, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_bicubic(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, C, h, w) -> (B, C, height, width) by `bicubic_weights` along each
    axis whose size changes (jax.image.resize's function)."""
    if x.shape[2] != height:
        wh = torch.from_numpy(bicubic_weights(x.shape[2], height)).to(x)
        x = torch.einsum("bchw,hH->bcHw", x, wh)
    if x.shape[3] != width:
        ww = torch.from_numpy(bicubic_weights(x.shape[3], width)).to(x)
        x = torch.einsum("bchw,wW->bchW", x, ww)
    return x


_DOWNSAMPLE = {"merge": PatchMerging, "reduce1c": PatchReduction1C,
               "conv": ConvPatchMerging}


class BasicLayer(nn.Module):
    """One Swin stage: blocks (alternating shift) + optional downsample.
    forward(x NHWC) -> (stage output, downsampled output). Every block runs
    on the map (pad, roll and the rest per block), which is what the JAX
    package's stage does for "pallas_slab" (no window residency there): the
    slab blocks need nothing of the stage beyond the cached mask, whose rows
    are in the kernels' window order."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path_rates: Sequence[float] = (),
                 downsample: Optional[str] = None,
                 use_checkpoint: bool = False,
                 init_values: Optional[float] = 1e-5,
                 endnorm_interval: int = -1, use_mlp_norm: bool = False,
                 use_shift: bool = True, attn_type: str = "cosine_mh",
                 rpe_table_type: str = "norm8_log_bylayer",
                 rpe_hidden_dim: int = 512, rpe_output_type: str = "sigmoid",
                 mlpfp32_blocks: Sequence[int] = (-1,), postnorm: bool = True,
                 pretrain_window_size: int = -1, attn_impl: str = "torch",
                 dtype: torch.dtype = torch.float32,
                 remat_policy: str = "full", scan_blocks: bool = False,
                 resident_pad_max: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if remat_policy not in _REMAT_POLICIES:
            raise ValueError(
                f"unknown remat_policy {remat_policy!r}; expected one of "
                f"{_REMAT_POLICIES}")
        # scan_blocks / resident_pad_max: accepted for config compatibility,
        # ignored (see module docstring)
        del scan_blocks, resident_pad_max
        self.remat = remat_policy if use_checkpoint else "none"
        self.window_size = window_size
        self.shift_size = window_size // 2
        self.has_mask = bool(use_shift and depth > 1)
        self.blocks = nn.ModuleList()
        for i in range(depth):
            shift = 0 if (i % 2 == 0 or not use_shift) else self.shift_size
            endnorm = (endnorm_interval > 0
                       and (i + 1) % endnorm_interval == 0)
            self.blocks.append(SwinBlock(
                dim, num_heads, window_size, shift_size=shift,
                mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                drop_path_rate=(drop_path_rates[i]
                                if i < len(drop_path_rates) else 0.0),
                postnorm=postnorm, init_values=init_values,
                use_mlp_norm=use_mlp_norm, endnorm=endnorm,
                attn_type=attn_type, rpe_table_type=rpe_table_type,
                rpe_hidden_dim=rpe_hidden_dim,
                rpe_output_type=rpe_output_type,
                pretrain_window_size=pretrain_window_size,
                mlpfp32=(i in mlpfp32_blocks), attn_impl=attn_impl,
                dtype=dtype, generator=generator,
                remat_mlp=self.remat == "mlp_only"))
        if downsample is None:
            self.downsample = None
        else:
            self.downsample = _DOWNSAMPLE[downsample](dim, postnorm=postnorm,
                                                      dtype=dtype)
        self._mask_cache: Dict[tuple, torch.Tensor] = {}

    def _mask(self, Hp: int, Wp: int, device) -> Optional[torch.Tensor]:
        if not self.has_mask:
            return None
        key = (Hp, Wp, str(device))
        if key not in self._mask_cache:
            m = shifted_window_mask(Hp, Wp, self.window_size, self.shift_size)
            # never an inference tensor: a training forward saves it
            with torch.inference_mode(False):
                self._mask_cache[key] = torch.from_numpy(m).to(device)
        return self._mask_cache[key]

    def _block(self, blk: SwinBlock, x, mask):
        if not (self.remat in ("full", "attn_out", "attn_qkv")
                and torch.is_grad_enabled() and x.requires_grad):
            return blk(x, mask)
        keeps = blk.draw_drop_path(x)       # one draw for both runs
        if self.remat == "full":
            return checkpoint(blk, x, mask, keeps, use_reentrant=False)
        # The JAX policy save_only_these_names("swin_attn_out"[, "swin_qkv"])
        # keeps those tensors and the block input: one checkpointed segment
        # ends at each kept tensor, and each segment's backward replays it
        # from its kept input.
        if self.remat == "attn_qkv" and blk.names_qkv(x):
            qkv = checkpoint(blk.qkv, x, use_reentrant=False)
            attn = checkpoint(blk.attend, qkv, mask, use_reentrant=False)
        else:
            attn = checkpoint(blk.attention, x, mask, use_reentrant=False)
        return checkpoint(blk.residual, x, attn, keeps, use_reentrant=False)

    def forward(self, x):
        B, H, W, C = x.shape
        ws = self.window_size
        Hp = -(-H // ws) * ws
        Wp = -(-W // ws) * ws
        mask = self._mask(Hp, Wp, x.device)
        for blk in self.blocks:
            x = self._block(blk, x, mask if blk.shift_size > 0 else None)
        x_out = x
        if self.downsample is not None:
            x = self.downsample(x)
        return x_out, x


class SwinTransformerV2(nn.Module):
    """Full backbone. Input NHWC float image; returns a list of NHWC float32
    feature maps at `out_indices`, each through its fp32 output norm."""

    def __init__(self, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size=(7, 7, 7, 7), mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.1,
                 ape: bool = False, patch_norm: bool = True,
                 use_checkpoint=False, remat_policy: str = "full",
                 init_values: Optional[float] = 1e-5,
                 endnorm_interval: int = -1,
                 use_mlp_norm_layers: Sequence[int] = (),
                 rpe_table_type: str = "norm8_log_bylayer",
                 rpe_hidden_dim: int = 512, attn_type: str = "cosine_mh",
                 rpe_output_type: str = "sigmoid", postnorm: bool = True,
                 patch_embed_type: str = "normal",
                 patch_merge_type: str = "normal", strid16: bool = False,
                 mlpfp32_layer_blocks=((-1,), (-1,), (-1,), (-1,)),
                 out_indices: Sequence[int] = (3,), frozen_stages: int = -1,
                 use_shift=True,
                 pretrain_window_size: Sequence[int] = (-1, -1, -1, -1),
                 pretrain_img_size: int = 224, in_chans: int = 3,
                 attn_impl: str = "torch",
                 dtype: torch.dtype = torch.float32,
                 scan_blocks: bool = False, resident_pad_max: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        num_layers = len(depths)
        window_size = (list(window_size) if not isinstance(window_size, int)
                       else [window_size] * num_layers)
        use_shift = (list(use_shift) if not isinstance(use_shift, bool)
                     else [use_shift] * num_layers)
        use_ckpt = (list(use_checkpoint)
                    if not isinstance(use_checkpoint, bool)
                    else [use_checkpoint] * num_layers)
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.dtype = dtype

        if patch_embed_type == "normal":
            self.patch_embed = PatchEmbed(embed_dim=embed_dim,
                                          patch_norm=patch_norm,
                                          in_chans=in_chans, dtype=dtype)
        elif patch_embed_type == "resnetdln":
            self.patch_embed = ResNetDLNPatchEmbed(embed_dim, in_chans, dtype)
        else:
            raise NotImplementedError(patch_embed_type)
        self.absolute_pos_embed = None
        if ape:
            # (1, C, res, res) as the reference stores it; the JAX package
            # holds it NHWC (ckpt/from_jax.py transposes)
            res = pretrain_img_size // 4
            self.absolute_pos_embed = nn.Parameter(
                torch.empty(1, embed_dim, res, res))
            nn.init.trunc_normal_(self.absolute_pos_embed, std=0.02)
        total = sum(depths)
        dpr = list(np.linspace(0, drop_path_rate, total))
        self.layers = nn.ModuleList()
        self.num_features = []
        for i in range(num_layers):
            if i == num_layers - 1 and strid16:
                cur_dim = int(embed_dim * 2 ** (i - 1))
            else:
                cur_dim = int(embed_dim * 2 ** i)
            self.num_features.append(cur_dim)
            if i < num_layers - 2:
                ds = "conv" if patch_merge_type == "conv" else "merge"
            elif i == num_layers - 2:
                ds = "reduce1c" if strid16 else (
                    "conv" if patch_merge_type == "conv" else "merge")
            else:
                ds = None
            self.layers.append(BasicLayer(
                cur_dim, depths[i], num_heads[i], window_size[i],
                mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                drop_path_rates=dpr[sum(depths[:i]):sum(depths[:i + 1])],
                downsample=ds, use_checkpoint=use_ckpt[i],
                remat_policy=remat_policy, init_values=init_values,
                endnorm_interval=endnorm_interval,
                use_mlp_norm=(i in use_mlp_norm_layers),
                use_shift=use_shift[i], attn_type=attn_type,
                rpe_table_type=rpe_table_type, rpe_hidden_dim=rpe_hidden_dim,
                rpe_output_type=rpe_output_type,
                mlpfp32_blocks=mlpfp32_layer_blocks[i], postnorm=postnorm,
                pretrain_window_size=pretrain_window_size[i],
                attn_impl=attn_impl, dtype=dtype, scan_blocks=scan_blocks,
                resident_pad_max=resident_pad_max, generator=generator))
            if i in self.out_indices:
                # fp32 output norm, named norm{i} as in the reference
                self.add_module(f"norm{i}", LayerNormFP32(cur_dim))

    def forward(self, x):
        x = self.patch_embed(x.to(self.dtype))
        if self.frozen_stages >= 0:
            x = x.detach()
        if self.absolute_pos_embed is not None:
            ape = resize_bicubic(self.absolute_pos_embed, x.shape[1],
                                 x.shape[2]).permute(0, 2, 3, 1)
            if self.frozen_stages >= 1:
                ape = ape.detach()
            x = x + ape.to(x.dtype)
        outs = []
        for i, layer in enumerate(self.layers):
            x_out, x = layer(x)
            if self.frozen_stages >= i + 2:
                x, x_out = x.detach(), x_out.detach()
            if i in self.out_indices:
                outs.append(getattr(self, f"norm{i}")(x_out.float()))
        return outs
