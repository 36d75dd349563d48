"""Fused cosine window attention on qkv exactly as the Linear emits it.

Counterpart of mmde_tpu/ops/window_attention_packed.py, forward and backward.
`cosine_window_attention_packed` takes qkv (B_, N, 3C), the per-head log
temperature, the relative-position bias as plain (nH, N, N) and the
shifted-window mask as plain (nW, N, N), and returns (B_, N, C). The TPU
kernel's head-group packing, 8-row padding and -1e9 bias columns are TPU
tiling and have no counterpart here: the CUDA kernels
(csrc/window_attention_{fwd,bwd}_tc.cu, csrc/window_attention_bwd_resident
[_tc].cu, csrc/window_attention_fwd.cu, csrc/window_attention_bwd.cu) mask
the ragged edge themselves.

Every packed launch, bf16 or fp32 qkv, runs the tensor-core kernels (bf16
mma.sync; `tensor_core_body`) - K1 with or without the log-sum-exp and K2's
two passes (window_attention_{fwd,bwd}_tc.cu, counted as
window_attention_fwd_tc[+lse] / window_attention_bwd_tc), K5 at W > 1 (the
same sources, window_attention_fwd_tc_w{W}[+lse] /
window_attention_bwd_tc_w{W}), K4 (window_attention_bwd_resident_tc.cu,
window_attention_bwd_resident_tc) and K3's windows-innermost dbias pass
under "split" (window_attention_bwd_tc.cu, window_attention_dbias_tc, after
the tensor-core passes at any W) - fp32 qkv with every operand as three
bf16 pieces. All compute the same function in each precision mode. The
fp32-FMA bodies of K1 / K2 / K3 / K5 / K4 stay as the private same-card A/B
partner (`_fma`). The forward hands the backward each row's log-sum-exp:
fp32 hi + lo, (2, B_, nH, N), formed in fp64 (F3), from every body but the
bf16 tensor-core one, which keeps (B_, nH, N) (`stat_pair`); a backward
rebuilds p only from the statistic of its own body's forward.

Which kernel runs follows the JAX package's process-wide settings, each read
once at import:
  MMDE_ATTN_GRID  "window_resident" (default) / "split": forward K1, backward
                  K2 (its dbias by atomics / by K3's windows-innermost pass);
                  "bias_resident": forward K1 without the log-sum-exp,
                  backward K4, the single-pass kernel.
  MMDE_ATTN_W     windows per block, "auto" or an int (default 1): where the
                  JAX rule `choose_w` gives W > 1, the forward and K2's two
                  passes run as K5, W consecutive windows per block sharing
                  one staged bias tile ("bias_resident" keeps W = 1, as JAX).
  MMDE_ATTN_MXU   the kernel body's precision for bf16 qkv, "auto" (= "fold",
                  the default) / "fp32" / "fold" / "bf16"; fp32 qkv takes
                  "fp32" unless a call passes mxu= (see
                  `cosine_window_attention_packed`). Each mode is a library
                  of its own, built from the same sources; K4's backward
                  keeps fp32 whatever the mode, as in JAX.

For CUDA tensors the wrapper launches the kernels or raises; for CPU tensors
it computes `cosine_window_attention_packed_plain` and, under autograd,
`cosine_window_attention_packed_backward_plain` - the same functions in plain
PyTorch (the head-split module's, on qkv split into heads), whatever the
grid or W, and also what the kernels are compared with on the card.
`LAUNCHES*` count kernel launches, and nothing else.

The same libraries hold the head-split entry points that
ops/window_attention_headsplit.py binds; `packed_layout_ok` says which of
the two layouts a swin stage takes, as the JAX package's `attention_plan`
does.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from mmde_tpu_torch.ops.window_attention_headsplit import (
    HEAD_DIM, cosine_window_attention_headsplit_backward_plain,
    cosine_window_attention_headsplit_dbias_plain,
    cosine_window_attention_headsplit_plain)

BWD_TILE = 64           # query rows per block of the backward's dq pass
RESIDENT_ROWS = 16      # query rows per block of K4
RESIDENT_BLOCKS = 528   # K4 splits its window sweep until ~4 blocks per SM
RESIDENT_TC_BLOCKS = 264  # the tensor-core K4: ~2 blocks per SM, one wave
LAUNCHES = 0            # incremented once per forward-kernel launch (K1, K5)
LAUNCHES_BY_SHAPE: dict = {}    # the same count, keyed by (B_, N, C, nH)
LAUNCHES_BWD = 0        # once per K2 / K5 backward launch (all its passes,
                        # K3's under "split" included)
LAUNCHES_BWD_BY_SHAPE: dict = {}
LAUNCHES_RESIDENT = 0   # once per K4 launch
LAUNCHES_RESIDENT_BY_SHAPE: dict = {}
# every launch above, keyed by (kernel, (B_, N, C, nH)); kernel names:
# window_attention_fwd_tc[+lse] / window_attention_bwd_tc (K1 / K2 on the
# tensor cores: bf16 qkv, W = 1), window_attention_fwd[+lse] /
# window_attention_bwd (K1 / K2's fp32-FMA body), window_attention_fwd_w{W}
# [+lse] / window_attention_bwd_w{W} (K5's fp32-FMA body),
# window_attention_fwd_tc_w{W}[+lse] / window_attention_bwd_tc_w{W} (K5 on
# the tensor cores), window_attention_bwd_resident[_tc] (K4's FMA body / on
# the tensor cores), window_attention_dbias_tc / window_attention_dbias (K3's
# pass under "split" on the tensor cores / its FMA body, `_fma`)
LAUNCHES_BY_KERNEL: dict = {}

# The JAX package's three grid modes. The forward is the same function
# under each; they differ in the backward, in how ds is summed over windows
# into dbias. "window_resident": fp32 atomics from the dk/dv pass (the TPU
# kernel's default grid dumps ds per window there and sums outside).
# "split": a pass of its own with windows innermost and no atomics (the TPU
# package's _pallas_dbias kernel, K3): slower, but dbias is the same bits on
# every run. "bias_resident": the TPU package's single-pass backward (its
# _pallas_backward_v4 kernel, K4): p computed once per (window, head, query
# tile), dbias summed over windows inside the block, also the same bits on
# every run. As in the TPU package the model never passes grid_mode:
# MMDE_ATTN_GRID chooses it for a whole process and is read once, here.
GRID_MODES = ("window_resident", "split", "bias_resident")
DEFAULT_GRID_MODE = os.environ.get("MMDE_ATTN_GRID", "window_resident")
if DEFAULT_GRID_MODE not in GRID_MODES:
    raise ValueError(
        f"MMDE_ATTN_GRID={DEFAULT_GRID_MODE!r} is not one of {GRID_MODES}")
_DBIAS_MODE = {"window_resident": 1, "split": 2}

# Windows per block, read once at import with the JAX package's check
# (MMDE_ATTN_W: "auto" or an int; the default 1 is K1/K2's schedule).
_w_env = os.environ.get("MMDE_ATTN_W", "1")
if _w_env != "auto":
    try:
        int(_w_env)
    except ValueError:
        raise ValueError(f"MMDE_ATTN_W={_w_env!r} must be 'auto' or an int")
WINDOWS_PER_CELL = _w_env
del _w_env

# MMDE_ATTN_SOFTMAX=max, read once at import as the JAX package does, makes
# every packed forward take the row maximum (maxfree=False); K4 always does.
SOFTMAX_MAXFREE = os.environ.get("MMDE_ATTN_SOFTMAX", "maxfree") != "max"

# The kernel body's precision (the JAX package's `mxu`): "fp32" exact;
# "fold" the logit scale folded into q^ before the q^k^T product; "bf16"
# fold plus bf16 operands for every product, fp32 accumulation. The default
# for bf16 qkv, read once at import as the JAX package reads it:
# MMDE_ATTN_MXU, "auto" meaning "fold". fp32 qkv always default to "fp32".
MXU_MODES = ("fp32", "fold", "bf16")
_m = os.environ.get("MMDE_ATTN_MXU", "auto")
MXU_BF16_DEFAULT = "fold" if _m == "auto" else _m
del _m
# the mode's code, the C entries' `mxu` argument (csrc/
# window_attention_common.cuh); "fold_pv_bf16" (fold, only p and v rounded)
# is a forward-only benchmark variant (tools/bench_attention_variants.py,
# v4) held by a library of its own (_LIB_NAME_PV), built at that tool's
# first use
_MXU_CODE = {"fp32": 0, "fold": 1, "bf16": 2, "fold_pv_bf16": 3}
# every launch of the packed kernels, keyed by (mode, (B_, N, C, nH)); K4
# (always fp32) under "fp32"
LAUNCHES_BY_MXU: dict = {}


def resolve_mxu(mxu: Optional[str], dtype: torch.dtype,
                modes=MXU_MODES) -> str:
    """The mode a call computes in: `mxu`, or for None the JAX default
    (MXU_BF16_DEFAULT for bf16 qkv, "fp32" otherwise). The JAX body folds
    for "fold" / "bf16" and rounds for "bf16" only, so any other value
    computes as "fp32" there; it does here too (no error)."""
    if mxu is None:
        mxu = MXU_BF16_DEFAULT if dtype == torch.bfloat16 else "fp32"
    return mxu if mxu in modes else "fp32"

_LIB_NAME = "window_attention_fwd"
_SOURCES = ("window_attention_fwd.cu",)
_LIB_NAME_PV = "window_attention_fwd_fold_pv"
_DEFINES_PV = ("MMDE_FOLD_PV=1",)
_LIB_NAME_BWD = "window_attention_bwd"
_SOURCES_BWD = ("window_attention_bwd.cu",)
_LIB_NAME_RESIDENT = "window_attention_bwd_resident"
_SOURCES_RESIDENT = ("window_attention_bwd_resident.cu",)
_LIB_NAME_FWD_TC = "window_attention_fwd_tc"
_SOURCES_FWD_TC = ("window_attention_fwd_tc.cu",)
_LIB_NAME_BWD_TC = "window_attention_bwd_tc"
_SOURCES_BWD_TC = ("window_attention_bwd_tc.cu",)
_LIB_NAME_RESIDENT_TC = "window_attention_bwd_resident_tc"
_SOURCES_RESIDENT_TC = ("window_attention_bwd_resident_tc.cu",)


def tensor_core_body(dtype: torch.dtype, w: int = 1,
                     resident: bool = False) -> bool:
    """Whether a packed launch of qkv's `dtype` at `w` windows per block (or
    K4's, `resident`) runs the tensor-core kernels: bf16 and fp32 qkv at
    every W (K1 / K2 at W = 1, K5 above) and in K4, in every precision mode,
    fp32 operands split into three bf16 pieces; K3's pass ("split") too.
    The head-split and slab wrappers have rules of their own
    (`headsplit_tensor_core_body`, `slab_tensor_core_body`)."""
    return dtype in (torch.bfloat16, torch.float32)


def headsplit_tensor_core_body(dtype: torch.dtype) -> bool:
    """The head-split wrapper's rule (ops/window_attention_headsplit.py):
    bf16 and fp32 q, k, v on the tensor cores, fp32 operands in three bf16
    pieces as the packed kernels take them (the same instantiation over the
    views' strides)."""
    return dtype in (torch.bfloat16, torch.float32)


def slab_tensor_core_body(dtype: torch.dtype) -> bool:
    """The slab wrapper's rule (ops/window_attention_slab.py): bf16 and fp32
    maps on the tensor cores, fp32 operands in three bf16 pieces as the
    packed kernels take them (the same kernels over the map's layout, fp32
    tiles staged through the map's tile table)."""
    return dtype in (torch.bfloat16, torch.float32)


def stat_pair(dtype: torch.dtype, tc: bool) -> bool:
    """Whether a training launch's log-sum-exp is fp32 hi + lo, (2, B_, nH,
    N), m + log(l) formed in fp64 (F3: one rounding of lse ~ 60 shifts a
    whole row of the rebuilt p): every body of every layout but the bf16
    tensor-core one (fp32 on the tensor cores or the FMA bodies, bf16 on
    the FMA bodies), which keeps (B_, nH, N) (sound at bf16 inputs,
    PERF.md)."""
    return not (tc and dtype == torch.bfloat16)

# The JAX package's packed-layout plan and windows-per-cell rule, copied
# (not imported) so that both packages send the same stages to the same
# kernel at the same W. The budgets below are the TPU's per-cell VMEM
# budgets and the estimates its cells' VMEM: they mean nothing on a GPU and
# are kept for routing parity only. `attention_plan` is None when C is not a
# multiple of 128, Dh does not divide 128, or the heads do not fill whole
# 128-lane groups - and, for windows over 456 tokens, when no q tile fits.
_BQ_CANDIDATES = (456, 384, 304, 232, 152, 120, 80, 48, 40)
_W_CANDIDATES = (8, 6, 4, 3, 2)
_VMEM_BUDGET_FWD = 16 * 1024 * 1024
_VMEM_BUDGET_BWD = 24 * 1024 * 1024
_VMEM_BUDGET_FWD_W = 40 * 1024 * 1024
_VMEM_BUDGET_BWD_W = 48 * 1024 * 1024


def _cell_vmem(bq: int, np_: int, hg: int, bwd: bool) -> int:
    """The JAX package's per-cell VMEM estimate of its packed kernels."""
    bias = bq * hg * np_ * 4 * 2
    logits = (3 if not bwd else 5) * bq * np_ * 4
    kv = 2 * np_ * 128 * 2 * 2
    mask = bq * np_ * 4 * 2
    extra = 0
    if bwd:
        extra = bq * hg * np_ * 2 * 2
        extra += 2 * np_ * 128 * 4 * 2
    return bias + logits + kv + mask + extra


def _cell_vmem_w(bq: int, np_: int, hg: int, bwd: bool, w: int,
                 masked: bool) -> int:
    """The same for a cell of w windows sharing one bias block."""
    bias = bq * hg * np_ * 4 * 2
    logits = (3 if not bwd else 5) * bq * np_ * 4
    per_w = 2 * np_ * 128 * 2 * 2
    if masked:
        per_w += bq * np_ * 4 * 2
    per_w += 3 * bq * 128 * 4
    if bwd:
        per_w += bq * hg * np_ * 2 * 2
        per_w += 2 * np_ * 128 * 4 * 2
    return bias + logits + w * per_w


def _largest_fitting_divisor(np_: int, hg: int, bwd: bool) -> int:
    """Largest 8-multiple divisor of Np whose cell fits the budget."""
    budget = _VMEM_BUDGET_BWD if bwd else _VMEM_BUDGET_FWD
    best = 8
    for d in range(8, np_ + 1, 8):
        if np_ % d == 0 and _cell_vmem(d, np_, hg, bwd) <= budget:
            best = d
    return best


def attention_plan(n: int, num_heads: int, head_dim: int, channels: int):
    """The JAX package's (BQ_fwd, Np, nQ_fwd, HG, nG, BQ_bwd), or None where
    the packed layout does not apply."""
    if channels % 128 != 0 or 128 % head_dim != 0:
        return None
    hg = 128 // head_dim
    if num_heads % hg != 0:
        return None
    ng = num_heads // hg
    if n <= max(_BQ_CANDIDATES):
        np_ = -(-n // 8) * 8
        bq = np_ if _cell_vmem(np_, np_, hg, False) <= _VMEM_BUDGET_FWD else \
            _largest_fitting_divisor(np_, hg, False)
        return bq, np_, np_ // bq, hg, ng, \
            _largest_fitting_divisor(np_, hg, True)
    best = None
    fallback = None
    for bq in _BQ_CANDIDATES:
        nq = -(-n // bq)
        np_ = nq * bq
        if _cell_vmem(bq, np_, hg, False) > _VMEM_BUDGET_FWD:
            continue
        if best is None and np_ <= int(n * 1.08):
            best = (bq, np_, nq)
        if fallback is None or np_ < fallback[1] or (
                np_ == fallback[1] and bq > fallback[0]):
            fallback = (bq, np_, nq)
    chosen = best or fallback
    if chosen is None:
        return None
    bq, np_, nq = chosen
    return bq, np_, nq, hg, ng, _largest_fitting_divisor(np_, hg, True)


def choose_w(B: int, nW: int, bq: int, np_: int, hg: int, bwd: bool,
             override=None) -> int:
    """The JAX package's windows per cell: the largest candidate dividing B
    (and nW when a mask is present, nW > 0) whose W-cell fits the W budget;
    an int setting is taken where it divides them, else 1. `override`: a
    per-call setting ("auto" / int), else WINDOWS_PER_CELL."""
    setting = WINDOWS_PER_CELL if override is None else str(override)
    if setting != "auto":
        w = int(setting)
        if w <= 1 or B % w or (nW and nW % w):
            return 1
        return w
    budget = _VMEM_BUDGET_BWD_W if bwd else _VMEM_BUDGET_FWD_W
    for w in _W_CANDIDATES:
        if B % w or (nW and nW % w):
            continue
        if _cell_vmem_w(bq, np_, hg, bwd, w, masked=nW > 0) <= budget:
            return w
    return 1


def packed_layout_ok(n: int, num_heads: int, head_dim: int,
                     channels: int) -> bool:
    """True where the JAX package's `attention_plan(n, num_heads, head_dim,
    channels)` is not None: the stage takes the packed kernel; otherwise it
    takes the head-split one."""
    return attention_plan(n, num_heads, head_dim, channels) is not None


def windows_per_block(B_: int, N: int, C: int, nH: int, nW: int, bwd: bool,
                      windows_per_cell=None) -> int:
    """W of the forward (bwd=False) or of the backward's two passes at this
    shape, by `choose_w` with the JAX plan's q tile of that direction (1
    where the plan does not apply, for a caller that sends such a shape
    here anyway)."""
    plan = attention_plan(N, nH, C // nH, C)
    if plan is None:
        return 1
    bq_f, np_, _, hg, _, bq_b = plan
    return choose_w(B_, nW, bq_b if bwd else bq_f, np_, hg, bwd,
                    override=windows_per_cell)


_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGTYPES = [_P] * 5 + [_I] * 9 + [_P]
_FWD_STATS_ARGTYPES = [_P] * 6 + [_I] * 9 + [_P]
_FWD_W_ARGTYPES = [_P] * 6 + [_I] * 10 + [_P]
_BWD_ARGTYPES = [_P] * 10 + [_I] * 9 + [_P]
_BWD_W_ARGTYPES = [_P] * 10 + [_I] * 10 + [_P]
_RESIDENT_ARGTYPES = [_P] * 9 + [_I] * 8 + [_P]
_FWD_TC_ARGTYPES = [_P] * 6 + [_I] * 9 + [_P]
_BWD_TC_ARGTYPES = [_P] * 10 + [_I] * 9 + [_P]
_FWD_TC_W_ARGTYPES = [_P] * 6 + [_I] * 10 + [_P]
_BWD_TC_W_ARGTYPES = [_P] * 10 + [_I] * 10 + [_P]
_RESIDENT_TC_ARGTYPES = [_P] * 9 + [_I] * 8 + [_P]
_DBIAS_ARGTYPES = [_P] * 8 + [_I] * 9 + [_P]


def _bind(lib, table) -> ctypes.CDLL:
    for name, types in table:
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = types
            fn.restype = ctypes.c_int
    return lib


def _library(mxu: str = "fp32") -> ctypes.CDLL:
    """The forward library (every mode of MXU_MODES, the head-split and
    slab entries), or for mode "fold_pv_bf16" the benchmark tool's own."""
    from mmde_tpu_torch.ops.cuda_build import load_library
    lib = (load_library(_LIB_NAME_PV, _SOURCES, _DEFINES_PV)
           if mxu == "fold_pv_bf16" else load_library(_LIB_NAME, _SOURCES))
    return _bind(lib, (
        ("mmde_window_attention_fwd", _FWD_ARGTYPES),
        ("mmde_window_attention_fwd_stats", _FWD_STATS_ARGTYPES),
        ("mmde_window_attention_fwd_w", _FWD_W_ARGTYPES)))


def _library_bwd() -> ctypes.CDLL:
    from mmde_tpu_torch.ops.cuda_build import load_library
    return _bind(load_library(_LIB_NAME_BWD, _SOURCES_BWD), (
        ("mmde_window_attention_bwd", _BWD_ARGTYPES),
        ("mmde_window_attention_bwd_w", _BWD_W_ARGTYPES),
        ("mmde_window_attention_dbias", _DBIAS_ARGTYPES)))


def _library_tc(backward: bool) -> ctypes.CDLL:
    """The tensor-core forward or backward library (the packed entries; the
    head-split wrapper binds its own)."""
    from mmde_tpu_torch.ops.cuda_build import load_library
    if backward:
        return _bind(load_library(_LIB_NAME_BWD_TC, _SOURCES_BWD_TC), (
            ("mmde_window_attention_bwd_tc", _BWD_TC_ARGTYPES),
            ("mmde_window_attention_bwd_tc_w", _BWD_TC_W_ARGTYPES),
            ("mmde_window_attention_dbias_tc", _DBIAS_ARGTYPES)))
    return _bind(load_library(_LIB_NAME_FWD_TC, _SOURCES_FWD_TC), (
        ("mmde_window_attention_fwd_tc", _FWD_TC_ARGTYPES),
        ("mmde_window_attention_fwd_tc_w", _FWD_TC_W_ARGTYPES)))


def _library_resident(tc: bool = False) -> ctypes.CDLL:
    """K4's library: its fp32-FMA body, or (`tc`) the tensor-core one."""
    from mmde_tpu_torch.ops.cuda_build import load_library
    if tc:
        return _bind(load_library(_LIB_NAME_RESIDENT_TC,
                                  _SOURCES_RESIDENT_TC), (
            ("mmde_window_attention_bwd_resident_tc",
             _RESIDENT_TC_ARGTYPES),))
    return _bind(load_library(_LIB_NAME_RESIDENT, _SOURCES_RESIDENT), (
        ("mmde_window_attention_bwd_resident", _RESIDENT_ARGTYPES),))


def library_specs() -> dict:
    """{library name: (sources, defines)} of every library the model's
    path binds: the tensor-core forward and backward, the fp32-FMA forward
    and backward (each with every mode of MXU_MODES) and K4's two."""
    return {_LIB_NAME_FWD_TC: (_SOURCES_FWD_TC, ()),
            _LIB_NAME_BWD_TC: (_SOURCES_BWD_TC, ()),
            _LIB_NAME: (_SOURCES, ()), _LIB_NAME_BWD: (_SOURCES_BWD, ()),
            _LIB_NAME_RESIDENT: (_SOURCES_RESIDENT, ()),
            _LIB_NAME_RESIDENT_TC: (_SOURCES_RESIDENT_TC, ())}


def build_kernels(extra: Optional[dict] = None) -> dict:
    """Compile (or find) this module's libraries and any `extra` ones
    ({name: (sources, defines)}, other modules' tools), one nvcc each, all
    side by side; returns {library name: build record}."""
    from mmde_tpu_torch.ops import cuda_build
    specs = dict(library_specs(), **(extra or {}))
    cuda_build.load_libraries(specs)
    _library()
    _library_bwd()
    _library_resident()
    _library_resident(tc=True)
    _library_tc(False)
    _library_tc(True)
    return {n: dict(cuda_build.BUILD_LOG[n]) for n in specs}


def _check(qkv, logit_scale, bias, mask, num_heads):
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B_, N, 3C), got {tuple(qkv.shape)}")
    B_, N, C3 = qkv.shape
    C = C3 // 3
    if C % num_heads or C // num_heads != HEAD_DIM:
        raise NotImplementedError(
            f"the window-attention kernel takes head_dim {HEAD_DIM} only "
            f"(C={C}, num_heads={num_heads})")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qkv must be float32 or bfloat16, got {qkv.dtype}")
    if logit_scale.dtype != torch.float32 or logit_scale.numel() != num_heads:
        raise ValueError("logit_scale must be float32 with one entry per "
                         f"head, got {logit_scale.dtype} "
                         f"{tuple(logit_scale.shape)}")
    if tuple(bias.shape) != (num_heads, N, N):
        raise ValueError(f"bias must be ({num_heads}, {N}, {N}), got "
                         f"{tuple(bias.shape)}")
    if bias.dtype not in (torch.float32, qkv.dtype):
        raise TypeError(f"bias must be float32 or qkv's type, got "
                        f"{bias.dtype} for {qkv.dtype} qkv")
    tensors = [("qkv", qkv), ("logit_scale", logit_scale), ("bias", bias)]
    if mask is not None:
        if mask.dim() != 3 or tuple(mask.shape[1:]) != (N, N):
            raise ValueError(f"mask must be (nW, {N}, {N}), got "
                             f"{tuple(mask.shape)}")
        if B_ % mask.shape[0]:
            raise ValueError(f"B_={B_} is not a multiple of the mask's "
                             f"{mask.shape[0]} windows")
        if mask.dtype != bias.dtype:
            raise TypeError(f"mask ({mask.dtype}) and bias ({bias.dtype}) "
                            "must share a type")
        tensors.append(("mask", mask))
    for name, t in tensors:
        if t.device != qkv.device:
            raise ValueError(f"{name} is on {t.device}, qkv on {qkv.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B_, N, C


def cosine_window_attention_packed_plain(qkv: torch.Tensor,
                                         logit_scale: torch.Tensor,
                                         bias: torch.Tensor,
                                         mask: Optional[torch.Tensor] = None,
                                         *, num_heads: int,
                                         compute_dtype: torch.dtype =
                                         torch.float32,
                                         mxu: Optional[str] = None,
                                         maxfree: bool = True
                                         ) -> torch.Tensor:
    """The forward kernels' function in plain PyTorch, on any device:
    normalisation, logits, softmax and accumulation in `compute_dtype`
    (float32; float64 gives the ground truth the kernels' gradients are
    checked against); output in qkv's type. mxu: the body's precision mode,
    None = the wrapper's default for qkv's type (`resolve_mxu`); maxfree:
    the wrapper's, which decides where "bf16" rounds p (see
    cosine_window_attention_headsplit_plain)."""
    B_, N, C3 = qkv.shape
    q, k, v = _split_heads(qkv, 3, num_heads)
    o = cosine_window_attention_headsplit_plain(
        q, k, v, logit_scale, bias, mask, compute_dtype=compute_dtype,
        mxu=resolve_mxu(mxu, qkv.dtype, tuple(_MXU_CODE)), maxfree=maxfree)
    return o.permute(0, 2, 1, 3).reshape(B_, N, C3 // 3)


def _split_heads(x: torch.Tensor, parts: int, nH: int) -> torch.Tensor:
    """(B_, N, parts*C) -> (parts, B_, nH, N, Dh), a view."""
    B_, N, W = x.shape
    C = W // parts
    return x.reshape(B_, N, parts, nH, C // nH).permute(2, 0, 3, 1, 4)


def cosine_window_attention_packed_backward_plain(
        qkv: torch.Tensor, logit_scale: torch.Tensor, bias: torch.Tensor,
        mask: Optional[torch.Tensor], g: torch.Tensor, *, num_heads: int,
        compute_dtype: torch.dtype = torch.float32,
        mxu: Optional[str] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function in plain PyTorch, on any device: the
    explicit formulas (no autograd) in `compute_dtype` (float32). g is the
    gradient of the output, (B_, N, C). Returns dqkv in qkv's type,
    dlogit_scale in logit_scale's shape (`compute_dtype`; zero where the
    ln(100) clamp binds) and dbias in bias's type; the mask gets no
    gradient. mxu: as for the forward (K2's and K5's modes)."""
    B_, N, C3 = qkv.shape
    q, k, v = _split_heads(qkv, 3, num_heads)
    dq, dk, dv, dls, dbias = cosine_window_attention_headsplit_backward_plain(
        q, k, v, logit_scale, bias, mask, _split_heads(g, 1, num_heads)[0],
        compute_dtype=compute_dtype, mxu=resolve_mxu(mxu, qkv.dtype))
    dqkv = torch.stack([dq, dk, dv], dim=0).permute(1, 3, 0, 2, 4)
    return dqkv.reshape(B_, N, C3), dls, dbias.to(bias.dtype)


def cosine_window_attention_packed_dbias_plain(
        qkv: torch.Tensor, logit_scale: torch.Tensor, bias: torch.Tensor,
        mask: Optional[torch.Tensor], g: torch.Tensor, *, num_heads: int,
        compute_dtype: torch.dtype = torch.float32,
        mxu: Optional[str] = None) -> torch.Tensor:
    """K3's function alone ("split": dbias, the windows' ds summed) in
    plain PyTorch, on any device: (nH, N, N) in `compute_dtype`, ds as the
    plain backward forms it in mode `mxu` (None: the default for qkv's
    type); what the card holds the tensor-core K3 to and times beside it."""
    q, k, v = _split_heads(qkv, 3, num_heads)
    return cosine_window_attention_headsplit_dbias_plain(
        q, k, v, logit_scale, bias, mask, _split_heads(g, 1, num_heads)[0],
        compute_dtype=compute_dtype, mxu=resolve_mxu(mxu, qkv.dtype))


def _count(kernel: str, qkv: torch.Tensor, num_heads: int) -> None:
    B_, N, C3 = qkv.shape
    key = (B_, N, C3 // 3, num_heads)
    LAUNCHES_BY_KERNEL[(kernel, key)] = LAUNCHES_BY_KERNEL.get(
        (kernel, key), 0) + 1
    if kernel.startswith("window_attention_dbias"):
        return      # K3 after the dq and dk/dv passes: part of one backward
    by_shape = (LAUNCHES_RESIDENT_BY_SHAPE if "resident" in kernel
                else LAUNCHES_BWD_BY_SHAPE if "_bwd" in kernel
                else LAUNCHES_BY_SHAPE)
    by_shape[key] = by_shape.get(key, 0) + 1


def _count_mxu(mxu: str, qkv: torch.Tensor, num_heads: int) -> None:
    B_, N, C3 = qkv.shape
    key = (mxu, (B_, N, C3 // 3, num_heads))
    LAUNCHES_BY_MXU[key] = LAUNCHES_BY_MXU.get(key, 0) + 1


def launch_counts() -> dict:
    """{kernel name: launches} summed over shapes, since the counters were
    last cleared."""
    out: dict = {}
    for (kernel, _), n in LAUNCHES_BY_KERNEL.items():
        out[kernel] = out.get(kernel, 0) + n
    return dict(sorted(out.items()))


def reset_launch_counts() -> None:
    global LAUNCHES, LAUNCHES_BWD, LAUNCHES_RESIDENT
    LAUNCHES = LAUNCHES_BWD = LAUNCHES_RESIDENT = 0
    for d in (LAUNCHES_BY_SHAPE, LAUNCHES_BWD_BY_SHAPE,
              LAUNCHES_RESIDENT_BY_SHAPE, LAUNCHES_BY_KERNEL,
              LAUNCHES_BY_MXU):
        d.clear()


def _body_name(tc: bool) -> str:
    return "tensor-core" if tc else "FMA"


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_forward(qkv, logit_scale, bias, mask, num_heads, maxfree,
                    want_stats, w=1, mxu=None, _fma=False):
    """Launch the forward kernel, K1 (w = 1) or K5 (w windows per block),
    in precision mode `mxu` (a key of _MXU_CODE; None = the default for
    qkv's type); returns (out, lse or None), lse (2, B_, nH, N) hi + lo
    where `stat_pair` says so, else (B_, nH, N). bf16 and fp32 qkv run the
    tensor-core kernels (`tensor_core_body`; fp32 operands in three bf16
    pieces; K5 there holds up to 8 windows, a larger w raises); `_fma`
    (private: the card tools and chip_smoke.py's same-card comparison,
    never the model) sends any launch to the FMA body."""
    global LAUNCHES
    mxu = resolve_mxu(mxu, qkv.dtype, tuple(_MXU_CODE))
    B_, N, C3 = qkv.shape
    C = C3 // 3
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned for the kernel's "
                         "vector loads")
    nW = mask.shape[0] if mask is not None else 0
    if w < 1 or B_ % w or (nW and nW % w):
        raise ValueError(f"{w} windows per block must divide B_={B_} and "
                         f"the mask's nW={nW}")
    tc = tensor_core_body(qkv.dtype, w) and not _fma
    if tc and mxu not in MXU_MODES:
        raise ValueError(f"the tensor-core forward takes mxu in {MXU_MODES}, "
                         f"got {mxu!r}")
    lib = _library_tc(False) if tc else _library(mxu)
    out = torch.empty((B_, N, C), dtype=qkv.dtype, device=qkv.device)
    stat = ((2,) if stat_pair(qkv.dtype, tc) else ()) + (B_, num_heads, N)
    lse = (torch.empty(stat, dtype=torch.float32, device=qkv.device)
           if want_stats else None)
    if lse is not None:     # which arithmetic wrote it (see _launch_backward)
        lse.written_by = _body_name(tc)
    qkv_bf16 = int(qkv.dtype == torch.bfloat16)
    shape_args = (B_, N, C, num_heads, nW, qkv_bf16,
                  int(bias.dtype == torch.bfloat16), int(bool(maxfree)))
    code = _MXU_CODE[mxu]
    mask_ptr = mask.data_ptr() if mask is not None else None
    with torch.cuda.device(qkv.device):
        stream = _stream(qkv.device)
        if tc and w > 1:
            err = lib.mmde_window_attention_fwd_tc_w(
                qkv.data_ptr(), logit_scale.data_ptr(), bias.data_ptr(),
                mask_ptr, out.data_ptr(),
                lse.data_ptr() if want_stats else None, *shape_args, w, code,
                stream)
        elif tc:
            err = lib.mmde_window_attention_fwd_tc(
                qkv.data_ptr(), logit_scale.data_ptr(), bias.data_ptr(),
                mask_ptr, out.data_ptr(),
                lse.data_ptr() if want_stats else None, *shape_args, code,
                stream)
        elif w > 1:
            err = lib.mmde_window_attention_fwd_w(
                qkv.data_ptr(), logit_scale.data_ptr(), bias.data_ptr(),
                mask_ptr, out.data_ptr(),
                lse.data_ptr() if want_stats else None, *shape_args, w,
                code, stream)
        elif want_stats:
            err = lib.mmde_window_attention_fwd_stats(
                qkv.data_ptr(), logit_scale.data_ptr(), bias.data_ptr(),
                mask_ptr, out.data_ptr(), lse.data_ptr(), *shape_args, code,
                stream)
        else:
            err = lib.mmde_window_attention_fwd(
                qkv.data_ptr(), logit_scale.data_ptr(), bias.data_ptr(),
                mask_ptr, out.data_ptr(), *shape_args, code, stream)
    name = ("window_attention_fwd" + ("_tc" if tc else "")
            + (f"_w{w}" if w > 1 else "") + ("+lse" if want_stats else ""))
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed with code {err} (B_={B_}, N={N}, C={C}, "
            f"nH={num_heads}, {qkv.dtype}, {w} windows per block, "
            f"mxu={mxu})")
    LAUNCHES += 1
    _count_mxu(mxu, qkv, num_heads)
    _count(name, qkv, num_heads)
    return out, lse


def check_statistic(lse, dtype: torch.dtype, tc: bool, rows: tuple) -> None:
    """Raise unless `lse` is the statistic the backward body `tc` reads for
    qkv of `dtype` and (B_, nH, N) `rows`: its shape (`stat_pair`) and the
    body that wrote it. The tensor cores round each sum toward zero, so fp32
    logits there lie a few ulps below the FMA body's: p is rebuilt only from
    the statistic the same arithmetic wrote (a statistic made elsewhere
    carries no tag)."""
    want = ((2,) if stat_pair(dtype, tc) else ()) + tuple(rows)
    if tuple(lse.shape) != want or lse.dtype != torch.float32:
        raise ValueError(f"the {_body_name(tc)} backward reads a float32 "
                         f"{want} log-sum-exp, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    written_by = getattr(lse, "written_by", None)
    if written_by not in (None, _body_name(tc)):
        raise ValueError(f"the {_body_name(tc)} backward was handed the "
                         f"log-sum-exp the {written_by} forward wrote")


def _launch_backward(qkv, logit_scale, bias, mask, lse, g, num_heads,
                     grid_mode, want_dbias, w=1, mxu=None, _fma=False):
    """Launch K2's passes (w = 1) or K5's (w windows per block), in
    precision mode `mxu` (one of MXU_MODES, the forward's; None = the
    default for qkv's type); returns (dqkv, dlogit_scale, dbias or None).
    bf16 and fp32 qkv run the tensor-core passes: dbias by their atomics,
    or under "split" K3's pass after them at one window (`_launch_dbias`,
    on the delta they wrote). `lse` must be the statistic the same body's
    forward writes (`check_statistic`): the other raises. Private, for
    chip_smoke.py's same-card comparisons only: `_fma` sends every launch
    to the FMA body (K3 too)."""
    mxu = resolve_mxu(mxu, qkv.dtype)
    atomics = want_dbias and _DBIAS_MODE[grid_mode] == 1
    dqkv, dls, dbias, delta = _backward_passes(
        qkv, logit_scale, bias, mask, lse, g, num_heads, atomics, w, mxu,
        _fma)
    if want_dbias and not atomics:      # K3 on the delta the passes wrote
        dbias = _launch_dbias(qkv, logit_scale, bias, mask, lse, g, delta,
                              num_heads, mxu, _fma=_fma)
    return dqkv, dls, None if dbias is None else dbias.to(bias.dtype)


def _backward_passes(qkv, logit_scale, bias, mask, lse, g, num_heads,
                     atomics, w, mxu, fma):
    """`_launch_backward`'s dq and dk/dv passes (mode `mxu` resolved, the
    FMA body for `fma`), dbias by their atomics where `atomics`; returns
    (dqkv, dlogit_scale, dbias fp32 or None, delta), delta (B_, nH, N) as
    the dq pass wrote it (K3's input; chip_smoke.py times K3 alone on
    it)."""
    global LAUNCHES_BWD
    B_, N, C3 = qkv.shape
    C = C3 // 3
    nH = num_heads
    if g.dtype != qkv.dtype or tuple(g.shape) != (B_, N, C):
        raise ValueError(f"g must be {(B_, N, C)} {qkv.dtype}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    if qkv.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("qkv and g must be 16-byte aligned for the "
                         "kernel's vector loads")
    nW = mask.shape[0] if mask is not None else 0
    if w < 1 or B_ % w or (nW and nW % w):
        raise ValueError(f"{w} windows per block must divide B_={B_} and "
                         f"the mask's nW={nW}")
    tc = tensor_core_body(qkv.dtype, w) and not fma
    check_statistic(lse, qkv.dtype, tc, (B_, nH, N))
    dev = qkv.device
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((B_, nH, N), dtype=torch.float32, device=dev)
    n_tiles = -(-N // BWD_TILE)
    # a row per (window, tile) at most: a pass of several windows a block
    # writes one a block (the fp32 tensor-core dk/dv pass may hold fewer
    # windows than w), the rest stay 0
    dls_part = torch.zeros((B_ * n_tiles, nH), dtype=torch.float64,
                           device=dev)
    # dbias by the passes' atomics, into zeros
    dbias = (torch.zeros((nH, N, N), dtype=torch.float32, device=dev)
             if atomics else None)
    args = (qkv.data_ptr(), logit_scale.data_ptr(), bias.data_ptr(),
            mask.data_ptr() if mask is not None else None, lse.data_ptr(),
            g.data_ptr(), dqkv.data_ptr(), delta.data_ptr(),
            dls_part.data_ptr(), dbias.data_ptr() if atomics else None, B_,
            N, C, nH, nW, int(qkv.dtype == torch.bfloat16),
            int(bias.dtype == torch.bfloat16), int(atomics))
    code = _MXU_CODE[mxu]
    with torch.cuda.device(dev):
        stream = _stream(dev)
        if tc:
            lib = _library_tc(True)
            if w > 1:
                err = lib.mmde_window_attention_bwd_tc_w(*args, w, code,
                                                         stream)
            else:
                err = lib.mmde_window_attention_bwd_tc(*args, code, stream)
        else:
            lib = _library_bwd()
            if w > 1:
                err = lib.mmde_window_attention_bwd_w(*args, w, code, stream)
            else:
                err = lib.mmde_window_attention_bwd(*args, code, stream)
    name = ("window_attention_bwd" + ("_tc" if tc else "")
            + (f"_w{w}" if w > 1 else ""))
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed with code {err} (B_={B_}, N={N}, C={C}, "
            f"nH={nH}, {qkv.dtype}, dbias atomics {atomics}, {w} windows "
            f"per block, mxu={mxu})")
    LAUNCHES_BWD += 1
    _count_mxu(mxu, qkv, nH)
    _count(name, qkv, nH)
    # per-block partial sums of dlogit_scale, summed here as the TPU package
    # sums its ds dump outside its kernel
    dls = dls_part.sum(dim=0).reshape(logit_scale.shape).float()
    return dqkv, dls, dbias, delta


def _launch_dbias(qkv, logit_scale, bias, mask, lse, g, delta, num_heads,
                  mxu=None, _fma=False):
    """Launch K3's pass alone ("split"), on the `delta` the dq pass of the
    same body wrote and the statistic its forward wrote; returns dbias
    (nH, N, N) fp32, every element written once, windows summed in one
    fixed order (the same bits on every run). bf16 and fp32 qkv run the
    tensor-core K3 (window_attention_bwd_tc.cu, counted as
    window_attention_dbias_tc; fp32 operands in three bf16 pieces); `_fma`
    (private: chip_smoke.py's same-card comparison, never the model) its
    FMA body (window_attention_bwd.cu, window_attention_dbias). No
    fallback: a build or launch failure raises."""
    mxu = resolve_mxu(mxu, qkv.dtype)
    B_, N, C3 = qkv.shape
    C = C3 // 3
    nH = num_heads
    tc = tensor_core_body(qkv.dtype) and not _fma
    check_statistic(lse, qkv.dtype, tc, (B_, nH, N))
    if tuple(delta.shape) != (B_, nH, N) or delta.dtype != torch.float32:
        raise ValueError(f"delta must be float32 {(B_, nH, N)}, got "
                         f"{tuple(delta.shape)} {delta.dtype}")
    dev = qkv.device
    dbias = torch.empty((nH, N, N), dtype=torch.float32, device=dev)
    nW = mask.shape[0] if mask is not None else 0
    args = (qkv.data_ptr(), logit_scale.data_ptr(), bias.data_ptr(),
            mask.data_ptr() if mask is not None else None, lse.data_ptr(),
            g.data_ptr(), delta.data_ptr(), dbias.data_ptr(), B_, N, C, nH,
            nW, int(qkv.dtype == torch.bfloat16),
            int(bias.dtype == torch.bfloat16),
            int(stat_pair(qkv.dtype, tc)), _MXU_CODE[mxu])
    name = "window_attention_dbias" + ("_tc" if tc else "")
    with torch.cuda.device(dev):
        if tc:
            err = _library_tc(True).mmde_window_attention_dbias_tc(
                *args, _stream(dev))
        else:
            err = _library_bwd().mmde_window_attention_dbias(
                *args, _stream(dev))
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed with code {err} (B_={B_}, N={N}, C={C}, "
            f"nH={nH}, {qkv.dtype}, mxu={mxu})")
    _count(name, qkv, nH)
    return dbias


def resident_splits(N: int, nH: int, B_: int, tc: bool = False) -> int:
    """Chunks K4 cuts its window sweep into, at most one chunk per window:
    the FMA body's 16-row blocks until ~4 per SM (RESIDENT_BLOCKS); the
    tensor-core kernel's 64-row blocks until ~2 per SM, one wave
    (RESIDENT_TC_BLOCKS: two of its blocks fit an SM), no chunk empty. Each
    chunk writes its own fp32 dbias partial; the partials are summed in a
    fixed order."""
    if not tc:
        blocks = -(-N // RESIDENT_ROWS) * nH
        return max(1, min(B_, -(-RESIDENT_BLOCKS // blocks)))
    blocks = -(-N // BWD_TILE) * nH
    splits = max(1, min(B_, RESIDENT_TC_BLOCKS // blocks))
    return -(-B_ // -(-B_ // splits))     # every chunk of ceil(B_ / splits)


def _launch_backward_resident(qkv, logit_scale, bias, mask, g, num_heads,
                              want_dbias=True, _fma=False):
    """Launch K4; returns (dqkv, dlogit_scale, dbias or None). bf16 and
    fp32 qkv run the tensor-core kernel (window_attention_bwd_resident_tc.cu;
    fp32 operands as three bf16 pieces); `_fma` (private: chip_smoke.py's
    same-card comparison, never the model) sends a launch to the fp32-FMA
    body. dq
    leaves the kernel complete; dk^ and dv are summed over query tiles by
    fp32 atomics into a (B_, N, 2C) scratch, and the normalise-VJP of k and
    the casts are applied here, as the TPU package applies them in XLA
    after its kernel. The FMA body holds three 16 x N fp32 rows in shared
    memory, so windows of more than 1088 tokens are refused at its launch
    (raises)."""
    global LAUNCHES_RESIDENT
    B_, N, C3 = qkv.shape
    C = C3 // 3
    nH = num_heads
    if g.dtype != qkv.dtype or tuple(g.shape) != (B_, N, C):
        raise ValueError(f"g must be {(B_, N, C)} {qkv.dtype}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    if qkv.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("qkv and g must be 16-byte aligned for the "
                         "kernel's vector loads")
    tc = tensor_core_body(qkv.dtype, resident=True) and not _fma
    lib = _library_resident(tc)
    dev = qkv.device
    splits = resident_splits(N, nH, B_, tc)
    rows = BWD_TILE if tc else RESIDENT_ROWS
    dqkv = torch.empty_like(qkv)
    dkv = torch.zeros((B_, N, 2 * C), dtype=torch.float32, device=dev)
    dbias_part = torch.empty((splits, nH, N, N), dtype=torch.float32,
                             device=dev)
    dls_part = torch.empty((splits * -(-N // rows), nH),
                           dtype=torch.float64, device=dev)
    args = (qkv.data_ptr(), logit_scale.data_ptr(), bias.data_ptr(),
            mask.data_ptr() if mask is not None else None, g.data_ptr(),
            dqkv.data_ptr(), dkv.data_ptr(), dbias_part.data_ptr(),
            dls_part.data_ptr(), B_, N, C, nH,
            mask.shape[0] if mask is not None else 0)
    bias_bf16 = int(bias.dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        if tc:
            err = lib.mmde_window_attention_bwd_resident_tc(
                *args, int(qkv.dtype == torch.bfloat16), bias_bf16, splits,
                _stream(dev))
        else:
            err = lib.mmde_window_attention_bwd_resident(
                *args, int(qkv.dtype == torch.bfloat16), bias_bf16, splits,
                _stream(dev))
    name = "window_attention_bwd_resident" + ("_tc" if tc else "")
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed with code {err} "
            f"(B_={B_}, N={N}, C={C}, nH={nH}, {qkv.dtype})")
    LAUNCHES_RESIDENT += 1
    _count_mxu("fp32", qkv, nH)
    _count(name, qkv, nH)
    # dk = rk * (dk^ - k^ <dk^, k^>), per head
    k = qkv[:, :, C:2 * C].float().reshape(B_, N, nH, HEAD_DIM)
    rk = torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-12)
    kn = k * rk
    dkn = dkv[:, :, :C].reshape(B_, N, nH, HEAD_DIM)
    dk = rk * (dkn - kn * (dkn * kn).sum(-1, keepdim=True))
    dqkv[:, :, C:2 * C] = dk.reshape(B_, N, C)
    dqkv[:, :, 2 * C:] = dkv[:, :, C:]
    dls = dls_part.sum(dim=0).reshape(logit_scale.shape).float()
    dbias = None
    if want_dbias:
        # the chunks' partials in a fixed order: the same bits on every run
        dbias = (dbias_part[0] if splits == 1 else dbias_part.sum(dim=0))
        dbias = dbias.to(bias.dtype)
    return dqkv, dls, dbias


class _PackedWindowAttention(torch.autograd.Function):
    """For CUDA tensors: K1 / K5 forward (saving each row's log-sum-exp)
    and K2 / K5 backward, or under "bias_resident" K1 without statistics and
    K4; the plain forward and the plain backward for CPU tensors. The
    forward and K2 / K5 run in precision mode `mxu`; K4 (and the plain
    backward under "bias_resident") in fp32, as the JAX package's. The
    backward runs the body its own forward ran (`ctx.fma`): the tensor-core
    kernels, or with the private last argument `fma` (chip_smoke.py's
    same-card comparison, never the model) the fp32-FMA bodies, so that p
    is rebuilt from the statistic the same arithmetic wrote."""

    @staticmethod
    def forward(ctx, qkv, logit_scale, bias, mask, num_heads, maxfree,
                grid_mode, windows_per_cell, mxu, fma=False):
        ctx.num_heads, ctx.grid_mode = num_heads, grid_mode
        ctx.windows_per_cell, ctx.mxu, ctx.fma = windows_per_cell, mxu, fma
        lse = None
        if not qkv.is_cuda:
            out = cosine_window_attention_packed_plain(
                qkv, logit_scale, bias, mask, num_heads=num_heads, mxu=mxu,
                maxfree=maxfree)
        elif grid_mode == "bias_resident":
            # K4 rebuilds the softmax from the exact row maximum itself
            out = _launch_forward(qkv, logit_scale, bias, mask, num_heads,
                                  maxfree, want_stats=False, mxu=mxu,
                                  _fma=fma)[0]
        else:
            B_, N, C3 = qkv.shape
            w = windows_per_block(
                B_, N, C3 // 3, num_heads,
                mask.shape[0] if mask is not None else 0, False,
                windows_per_cell)
            out, lse = _launch_forward(qkv, logit_scale, bias, mask,
                                       num_heads, maxfree, want_stats=True,
                                       w=w, mxu=mxu, _fma=fma)
        ctx.save_for_backward(qkv, logit_scale, bias, mask, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, logit_scale, bias, mask, lse = ctx.saved_tensors
        need_qkv, need_ls, need_bias = ctx.needs_input_grad[:3]
        g = g.contiguous()
        if not qkv.is_cuda:
            dqkv, dls, dbias = cosine_window_attention_packed_backward_plain(
                qkv, logit_scale, bias, mask, g, num_heads=ctx.num_heads,
                mxu="fp32" if ctx.grid_mode == "bias_resident" else ctx.mxu)
        elif ctx.grid_mode == "bias_resident":
            dqkv, dls, dbias = _launch_backward_resident(
                qkv, logit_scale, bias, mask, g, ctx.num_heads,
                want_dbias=need_bias, _fma=ctx.fma)
        else:
            B_, N, C3 = qkv.shape
            w = windows_per_block(
                B_, N, C3 // 3, ctx.num_heads,
                mask.shape[0] if mask is not None else 0, True,
                ctx.windows_per_cell)
            dqkv, dls, dbias = _launch_backward(
                qkv, logit_scale, bias, mask, lse, g, ctx.num_heads,
                ctx.grid_mode, want_dbias=need_bias, w=w, mxu=ctx.mxu,
                _fma=ctx.fma)
        # the mask is a constant of the window layout: no gradient
        return (dqkv if need_qkv else None, dls if need_ls else None,
                dbias if need_bias else None, None, None, None, None, None,
                None, None)


def cosine_window_attention_packed(qkv: torch.Tensor,
                                   logit_scale: torch.Tensor,
                                   bias: torch.Tensor,
                                   mask: Optional[torch.Tensor] = None,
                                   *, num_heads: int,
                                   maxfree: bool = True,
                                   grid_mode: Optional[str] = None,
                                   windows_per_cell=None,
                                   mxu: Optional[str] = None) -> torch.Tensor:
    """Fused cosine window attention, differentiable in qkv, logit_scale and
    bias.

    qkv: (B_, N, 3C) float32 or bfloat16, as the qkv Linear (+ q/v bias)
    emits it; logit_scale: (nH, 1, 1) float32; bias: (nH, N, N), float32 or
    qkv's type; mask: (nW, N, N) of bias's type or None, window b uses row
    b % nW. Returns (B_, N, C) in qkv's type.

    maxfree=True lets the forward kernel replace the softmax's row maximum
    by the static shift exp(min(logit_scale, ln 100)) + 16 - for the heads
    whose temperature is low enough (<= 30) for that shift to stay inside
    float32's range; hotter heads keep a running row maximum. The shift is
    an upper bound only while bias lies in (0, 16) - the 16*sigmoid
    continuous position bias - and mask <= 0; any other bias must pass
    maxfree=False (running row maximum for every head), as does
    MMDE_ATTN_SOFTMAX=max for the whole process. The result is the same
    function either way.

    grid_mode: one of GRID_MODES (None = DEFAULT_GRID_MODE, which the
    MMDE_ATTN_GRID environment variable sets): how the backward sums ds over
    windows into dbias - atomics, K3's pass, or K4's single pass; the values
    agree up to the order of fp32 sums.

    windows_per_cell: "auto" | int | None (= WINDOWS_PER_CELL, which
    MMDE_ATTN_W sets): windows per block of the forward and of the
    window-grid backward, by the JAX rule `choose_w`; W > 1 runs K5 (up to
    8 windows per block: more is refused for shared memory, and raises).
    "bias_resident" ignores it (W = 1), as the JAX package does.

    mxu: the kernel body's precision, "fp32" | "fold" | "bf16" (see
    MXU_MODES); None = MXU_BF16_DEFAULT (MMDE_ATTN_MXU, "fold" unless set)
    for bf16 qkv and "fp32" for fp32 qkv, as in the JAX package. Any other
    value computes as "fp32", as the JAX body does with it (no error). The
    forward and the K2 / K5 backward take the mode; K4 ("bias_resident")
    keeps its fp32 backward, as the JAX package's.

    CUDA tensors launch the kernels (or raise); CPU tensors take the plain
    versions. When a gradient is recorded the forward kernel also writes
    each row's log-sum-exp (not under "bias_resident"), which the backward
    kernel rebuilds the probabilities from; without one (serving) it writes
    the output alone.
    """
    if grid_mode is None:
        grid_mode = DEFAULT_GRID_MODE
    elif grid_mode not in GRID_MODES:
        raise ValueError(f"grid_mode={grid_mode!r} not in {GRID_MODES}")
    if windows_per_cell is not None and str(windows_per_cell) != "auto":
        int(windows_per_cell)       # "auto" or an int, as MMDE_ATTN_W
    maxfree = bool(maxfree) and SOFTMAX_MAXFREE
    _check(qkv, logit_scale, bias, mask, num_heads)
    mxu = resolve_mxu(mxu, qkv.dtype)
    if torch.is_grad_enabled() and (qkv.requires_grad
                                    or logit_scale.requires_grad
                                    or bias.requires_grad):
        return _PackedWindowAttention.apply(qkv, logit_scale, bias, mask,
                                            num_heads, maxfree, grid_mode,
                                            windows_per_cell, mxu)
    if not qkv.is_cuda:
        return cosine_window_attention_packed_plain(
            qkv, logit_scale, bias, mask, num_heads=num_heads, mxu=mxu,
            maxfree=maxfree)
    B_, N, C3 = qkv.shape
    w = 1 if grid_mode == "bias_resident" else windows_per_block(
        B_, N, C3 // 3, num_heads, mask.shape[0] if mask is not None else 0,
        False, windows_per_cell)
    return _launch_forward(qkv, logit_scale, bias, mask, num_heads, maxfree,
                           want_stats=False, w=w, mxu=mxu)[0]
