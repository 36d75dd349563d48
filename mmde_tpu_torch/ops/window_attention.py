"""Windowed multi-head attention — plain PyTorch.

Counterpart of mmde_tpu/ops/window_attention.py: per-window
cosine-similarity attention with a learned, clamped temperature and an
additive relative-position bias, plus the additive shifted-window mask; and
the SwinV1-style scaled dot-product form. These are the functions the CPU
tests hold against the JAX package, and the form `attn_impl="torch"` runs.

Shapes:
    q, k, v:     (B, nH, N, Dh)   B = batch*num_windows, N = window tokens
    logit_scale: (nH, 1, 1)       log-temperature (cosine path only)
    bias:        (nH, N, N)       relative position bias (already activated)
    mask:        (nW, N, N) or None   additive 0/-100 shifted-window mask;
                                  B must be a multiple of nW.
"""
from __future__ import annotations

from typing import Optional

import torch

# exp(logit_scale) <= 100
MAX_LOGIT_SCALE = 4.605170185988091  # ln(100)


def _apply_mask_and_softmax(attn: torch.Tensor, mask: Optional[torch.Tensor],
                            out_dtype: torch.dtype) -> torch.Tensor:
    if mask is not None:
        nW = mask.shape[0]
        B, nH, N, _ = attn.shape
        if B % nW:
            raise ValueError(f"batch*windows {B} is not a multiple of the "
                             f"mask's {nW} windows")
        attn = attn.reshape(B // nW, nW, nH, N, N)
        attn = attn + mask[None, :, None].to(attn.dtype)
        attn = attn.reshape(B, nH, N, N)
    return torch.softmax(attn, dim=-1).to(out_dtype)


def cosine_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            logit_scale: torch.Tensor, bias: torch.Tensor,
                            mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """softmax(q_hat k_hat^T e^s + bias [+ mask]) v.

    q and k are L2-normalised along Dh as x * rsqrt(sum(x^2) + 1e-12) — not
    F.normalize, which clamps the norm instead — in float32; logits and
    softmax run in float32 whatever the input type; the probabilities are
    cast to v's type before the second product, the result back to it.
    """
    out_dtype = v.dtype
    qf = q.float()
    kf = k.float()
    qn = qf * torch.rsqrt((qf * qf).sum(-1, keepdim=True) + 1e-12)
    kn = kf * torch.rsqrt((kf * kf).sum(-1, keepdim=True) + 1e-12)
    scale = torch.exp(torch.clamp(logit_scale.float(), max=MAX_LOGIT_SCALE))
    attn = torch.matmul(qn, kn.transpose(-1, -2))
    attn = attn * scale[None]
    attn = attn + bias[None].float()
    attn = _apply_mask_and_softmax(attn, mask, out_dtype)
    return torch.matmul(attn.float(), v.float()).to(out_dtype)


def scaled_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float, bias: torch.Tensor,
                            mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """SwinV1-style attention: softmax(q k^T scale + bias [+ mask]) v, logits
    in float32 (q is scaled in its own type first, as the JAX package does)."""
    out_dtype = v.dtype
    attn = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    attn = attn + bias[None].float()
    attn = _apply_mask_and_softmax(attn, mask, out_dtype)
    return torch.matmul(attn.float(), v.float()).to(out_dtype)
