"""SwinTransformerV2 backbone — PyTorch, NHWC at every public function.

Counterpart of mmde_tpu/nn/swin_v2.py:

  * cosine-similarity window attention with a learned log temperature clamped
    at ln(100), through mmde_tpu_torch.ops (plain PyTorch, or the CUDA
    kernels: packed where the JAX package's packed layout applies,
    head-split elsewhere, stage by stage as there);
  * continuous relative position bias: 2-layer MLP over a log-spaced
    relative-coordinate table, sigmoid output x16 (applied on the table);
  * split q/v bias with an implicit zero k bias;
  * post-norm (default) and pre-norm + layerscale block variants;
  * cyclic-shift SW-MSA with the additive 0/-100 region mask, built with
    numpy on the padded map and cached per map size;
  * PatchMerging / PatchReduction1C / ConvPatchMerging downsampling,
    PatchEmbed conv-4x4;
  * strid16 mode, per-stage window/shift flags, stochastic-depth schedule,
    fp32 LayerNorm on the outputs.

Every stage runs the map path (pad -> roll -> partition -> attention ->
reverse -> roll back -> crop, per block). The JAX package's window residency
on padded maps (`resident_pad_max`) and its `scan_blocks` layout are
accepted as arguments and ignored: residency matches the map path at real
token positions, scanning only shrinks an XLA graph.

Training: gradients flow through both attention implementations (the CUDA
forward and backward kernels for "cuda" on CUDA tensors). Rematerialisation
follows `use_checkpoint` (per stage) and `remat_policy`: "none" keeps every
activation (the flagship's setting), "full" recomputes each block in the
backward (torch.utils.checkpoint, non-reentrant; the block's drop-path masks
are drawn outside the recomputed region so both runs see one draw),
"mlp_only" recomputes the MLP alone. "attn_out" / "attn_qkv" save named
intermediates of a block under an XLA remat policy, which eager PyTorch has
no counterpart for: they raise when a training forward reaches them. Remat
changes memory, never values.

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
                                      Mlp)
from mmde_tpu_torch.ops.window_attention import (cosine_window_attention,
                                                 scaled_window_attention)
from mmde_tpu_torch.ops.window_attention_headsplit import (
    cosine_window_attention_headsplit)
from mmde_tpu_torch.ops.window_attention_packed import (
    HEAD_DIM, cosine_window_attention_packed, packed_layout_ok)

_REMAT_POLICIES = ("full", "attn_out", "attn_qkv", "mlp_only", "none")
ATTN_IMPLS = ("torch", "cuda")


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


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C). H, W must be multiples of ws."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(windows: torch.Tensor, ws: int, H: int,
                   W: int) -> torch.Tensor:
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    C = windows.shape[-1]
    B = windows.shape[0] // ((H // ws) * (W // ws))
    x = windows.reshape(B, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


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
    """W-MSA with cosine attention + continuous RPE on (B*nW, N, C) windows.

    attn_impl "cuda" sends cosine attention to a fused kernel (for CUDA
    tensors; its plain version for CPU tensors), chosen as the JAX package
    chooses for "pallas": `cosine_window_attention_packed` on qkv as the
    Linear emits it where `packed_layout_ok` (C a multiple of 128, heads in
    whole 128-lane groups), `cosine_window_attention_headsplit` on split
    heads elsewhere. "torch" splits heads and runs the plain functions of
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
        if (attn_impl == "cuda" and attn_type == "cosine_mh"
                and dim // num_heads != HEAD_DIM):
            raise NotImplementedError(
                f"attn_impl='cuda' needs head_dim {HEAD_DIM}, got "
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
        B_, N, C = x.shape
        nH = self.num_heads
        Dh = C // nH
        qkv = self.qkv(x)
        if self.q_bias is not None:
            # k has no bias: concat(q_bias, 0, v_bias) after a bias-free Linear
            bias_vec = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                                  self.v_bias]).to(qkv.dtype)
            qkv = qkv + bias_vec
        bias = self.rpe_bias()

        fused = self.attn_type == "cosine_mh" and self.attn_impl == "cuda"
        if fused and packed_layout_ok(N, nH, Dh, C):
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
    -> attention -> reverse -> roll back -> crop."""

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
        B, H, W, C = x.shape
        ws, ss = self.window_size, self.shift_size
        keep1, keep2 = keeps if keeps is not None else self.draw_drop_path(x)
        shortcut = x
        if not self.postnorm:
            x = self.norm1(x)
        pad_b = (ws - H % ws) % ws
        pad_r = (ws - W % ws) % ws
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        if ss > 0:
            x = torch.roll(x, (-ss, -ss), dims=(1, 2))
            attn_mask = mask
        else:
            attn_mask = None
        windows = window_partition(x, ws)                # (B*nW, ws*ws, C)
        attn = self.attn(windows, attn_mask)
        x = window_reverse(attn, ws, Hp, Wp)
        if ss > 0:
            x = torch.roll(x, (ss, ss), dims=(1, 2))
        if pad_b or pad_r:
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


_DOWNSAMPLE = {"merge": PatchMerging, "reduce1c": PatchReduction1C,
               "conv": ConvPatchMerging}


class BasicLayer(nn.Module):
    """One Swin stage: blocks (alternating shift) + optional downsample.
    forward(x NHWC) -> (stage output, downsampled output)."""

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
        if self.remat != "full":
            raise NotImplementedError(
                f"remat_policy {self.remat!r} saves named intermediates "
                "under an XLA remat policy and is not ported (ROADMAP Queue "
                "A, M2); train with 'full', 'mlp_only' or 'none'")
        keeps = blk.draw_drop_path(x)       # one draw for both runs
        return checkpoint(blk, x, mask, keeps, use_reentrant=False)

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
                 pretrain_img_size: int = 224, attn_impl: str = "torch",
                 dtype: torch.dtype = torch.float32,
                 scan_blocks: bool = False, resident_pad_max: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if ape:
            raise NotImplementedError(
                "absolute position embedding is not ported yet (ROADMAP "
                "Queue A, remaining modules)")
        if patch_embed_type != "normal":
            raise NotImplementedError(
                f"patch_embed_type {patch_embed_type!r} is not ported yet "
                "(ROADMAP Queue A, remaining modules)")
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

        self.patch_embed = PatchEmbed(embed_dim=embed_dim,
                                      patch_norm=patch_norm, dtype=dtype)
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
        outs = []
        for i, layer in enumerate(self.layers):
            x_out, x = layer(x)
            if self.frozen_stages >= i + 2:
                x, x_out = x.detach(), x_out.detach()
            if i in self.out_indices:
                outs.append(getattr(self, f"norm{i}")(x_out.float()))
        return outs
