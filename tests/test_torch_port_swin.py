"""PyTorch port vs JAX package: SwinV2 bookkeeping, attention module, block,
merging and the whole backbone, on the CPU at nano widths.

Weights are drawn with numpy at O(1) scales into the JAX parameter tree and
carried across with `load_jax_variables`; inputs come from the same
generator. JAX runs un-jitted (Pallas kernels in interpret mode).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmde_tpu.nn import swin_v2 as jsw
from mmde_tpu_torch.ckpt.from_jax import load_jax_variables
from mmde_tpu_torch.nn import swin_v2 as tsw
from mmde_tpu_torch.testing import randomize_tree

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()


def _init(jmodel, *args, seed=0):
    """A `params` tree for `jmodel`, every leaf drawn with numpy at O(1)
    scale. Only the tree's shapes come from flax (eval_shape: the
    initialisation is neither compiled nor run)."""
    v = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, *args))
    return randomize_tree(v["params"], np.random.default_rng(seed))


# ------------------------------------------------------------ bookkeeping

@pytest.mark.parametrize("ws,pws,ttype", [
    ((30, 30), 12, "norm8_log_bylayer"), ((15, 15), 6, "norm8_log_bylayer"),
    ((7, 5), -1, "norm8_log"), ((6, 6), 4, "linear_bylayer"),
    ((6, 6), -1, "linear")])
def test_relative_coords_table_exact(ws, pws, ttype):
    np.testing.assert_array_equal(
        tsw.relative_coords_table(ws, pws, ttype),
        jsw.relative_coords_table(ws, pws, ttype))


def test_relative_coords_table_rejects_pretrain_window_1():
    with pytest.raises(ValueError):
        tsw.relative_coords_table((4, 4), 1, "norm8_log_bylayer")


@pytest.mark.parametrize("ws", [(30, 30), (15, 15), (7, 5)])
def test_relative_position_index_exact(ws):
    np.testing.assert_array_equal(tsw.relative_position_index(ws),
                                  jsw.relative_position_index(ws))


@pytest.mark.parametrize("wh,ww", [(6, 6), (15, 15), (5, 7)])
def test_rpe_bias_from_table_exact(wh, ww):
    """The port's index gather equals the JAX package's gather-free
    block-Toeplitz expansion, value for value."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal(((2 * wh - 1) * (2 * ww - 1), 3)
                                ).astype(np.float32)
    want = np.asarray(jsw.rpe_bias_from_table(jnp.asarray(table), wh, ww))
    got = tsw.rpe_bias_from_table(torch.from_numpy(table), wh, ww).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hp,wp,ws", [(120, 180, 30), (60, 90, 30),
                                      (12, 18, 6), (6, 6, 6)])
def test_shifted_window_mask_exact(hp, wp, ws):
    np.testing.assert_array_equal(
        tsw.shifted_window_mask(hp, wp, ws, ws // 2),
        jsw.shifted_window_mask(hp, wp, ws, ws // 2))


@pytest.mark.parametrize("ss", [0, 3])
def test_pad_keep_mask_exact(ss):
    np.testing.assert_array_equal(tsw.pad_keep_mask(10, 15, 12, 18, 6, ss),
                                  jsw.pad_keep_mask(10, 15, 12, 18, 6, ss))


def test_window_partition_reverse_exact():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 18, 5)).astype(np.float32)
    want = np.asarray(jsw.window_partition(jnp.asarray(x), 6))
    got = tsw.window_partition(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tsw.window_reverse(got, 6, 12, 18).numpy()
    np.testing.assert_array_equal(back, x)


# ---------------------------------------------------------------- modules

@pytest.mark.parametrize("jimpl,timpl", [("xla", "torch"), ("pallas", "cuda"),
                                         ("xla", "cuda")])
@pytest.mark.parametrize("with_mask", [False, True])
def test_window_attention_matches_jax(jimpl, timpl, with_mask):
    """dim 128 / 4 heads: the JAX "pallas" side takes its packed kernel
    (interpret mode), the port's "cuda" side the packed plain version."""
    rng = np.random.default_rng(2)
    ws, dim, nH, nW = 6, 128, 4, 2
    x = rng.standard_normal((4, ws * ws, dim)).astype(np.float32)
    mask = None
    if with_mask:
        mask = jsw.shifted_window_mask(ws, 2 * ws, ws, ws // 2)
        assert mask.shape[0] == nW
    jm = jsw.WindowAttention(dim=dim, window_size=(ws, ws), num_heads=nH,
                             pretrain_window_size=4, attn_impl=jimpl)
    jx = jnp.asarray(x)
    jmask = None if mask is None else jnp.asarray(mask)
    params = _init(jm, jx, jmask, seed=3)
    want = np.asarray(jm.apply({"params": params}, jx, jmask))
    tm = tsw.WindowAttention(dim, (ws, ws), nH, pretrain_window_size=4,
                             attn_impl=timpl).eval()
    load_jax_variables(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x),
                 None if mask is None else torch.from_numpy(mask)).numpy()
    assert want.std() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_window_attention_normal_type_and_table_rpe():
    """attn_type 'normal' (scaled dot product) with the discrete bias table
    and the non-sigmoid output."""
    rng = np.random.default_rng(4)
    ws, dim, nH = 5, 64, 2
    x = rng.standard_normal((3, ws * ws, dim)).astype(np.float32)
    kw = dict(attn_type="normal", rpe_table_type="none",
              rpe_output_type="normal")
    jm = jsw.WindowAttention(dim=dim, window_size=(ws, ws), num_heads=nH,
                             **kw)
    params = _init(jm, jnp.asarray(x), None, seed=5)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), None))
    tm = tsw.WindowAttention(dim, (ws, ws), nH, **kw).eval()
    load_jax_variables(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_rpe_bias_cache_follows_the_weights():
    tm = tsw.WindowAttention(32, (4, 4), 1, pretrain_window_size=4).eval()
    with torch.no_grad():
        a = tm.rpe_bias()
        assert tm.rpe_bias() is a                       # cached
        tm.rpe_mlp[2].weight.mul_(2.0)                  # in-place update
        b = tm.rpe_bias()
    assert b is not a and not torch.equal(a, b)
    tm.train()
    c = tm.rpe_bias()                                   # grads recorded
    assert c.requires_grad and tm._bias_cache is None


@pytest.mark.parametrize("postnorm,shift", [(True, 3), (True, 0), (False, 3)])
def test_swin_block_shift_nondivisible_matches_jax(postnorm, shift):
    """10x15 map, window 6: pads to 12x18, rolls by 3, masks 6 windows."""
    rng = np.random.default_rng(6)
    dim, nH, ws = 32, 1, 6
    x = rng.standard_normal((2, 10, 15, dim)).astype(np.float32)
    mask = jsw.shifted_window_mask(12, 18, ws, 3)
    kw = dict(dim=dim, num_heads=nH, window_size=ws, shift_size=shift,
              postnorm=postnorm, init_values=0.5, pretrain_window_size=4)
    jm = jsw.SwinBlock(**kw)
    jmask = jnp.asarray(mask)
    params = _init(jm, jnp.asarray(x), jmask, seed=7)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jmask))
    tm = tsw.SwinBlock(**kw).eval()
    load_jax_variables(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert got.shape == (2, 10, 15, dim)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["merge", "merge_prenorm", "reduce1c",
                                  "conv"])
def test_downsample_matches_jax(kind):
    """PatchMerging on an odd map (pads to even; concat order (0,0), (1,0),
    (0,1), (1,1)), PatchReduction1C and ConvPatchMerging."""
    rng = np.random.default_rng(8)
    dim = 16
    x = rng.standard_normal((2, 7, 9, dim)).astype(np.float32)
    postnorm = kind != "merge_prenorm"
    jcls, tcls = {
        "merge": (jsw.PatchMerging, tsw.PatchMerging),
        "merge_prenorm": (jsw.PatchMerging, tsw.PatchMerging),
        "reduce1c": (jsw.PatchReduction1C, tsw.PatchReduction1C),
        "conv": (jsw.ConvPatchMerging, tsw.ConvPatchMerging)}[kind]
    jm = jcls(postnorm=postnorm)
    params = _init(jm, jnp.asarray(x), seed=9)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = tcls(dim, postnorm=postnorm).eval()
    load_jax_variables(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_patch_embed_pads_and_matches_jax():
    rng = np.random.default_rng(10)
    x = rng.random((2, 18, 23, 3)).astype(np.float32)
    jm = jsw.PatchEmbed(embed_dim=32)
    params = _init(jm, jnp.asarray(x), seed=11)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = tsw.PatchEmbed(embed_dim=32).eval()
    load_jax_variables(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 5, 6, 32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


_NANO = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8),
             window_size=(6, 6, 6, 3), pretrain_window_size=(4, 4, 4, 2),
             use_shift=(True, True, False, False), out_indices=(0, 1, 2, 3),
             drop_path_rate=0.2)


@pytest.fixture(scope="module")
def nano_swin():
    """Input 92x116 -> stage maps 23x29 (pads to 24x30, 7.9% pad, shifted),
    12x15 (12x18, shifted), 6x8 (6x12), 3x4 (3x6)."""
    rng = np.random.default_rng(12)
    x = rng.random((2, 92, 116, 3)).astype(np.float32)
    jm = jsw.SwinTransformerV2(**_NANO)
    params = _init(jm, jnp.asarray(x), seed=13)
    tms = {}
    for impl in ("torch", "cuda"):
        tm = tsw.SwinTransformerV2(**_NANO, attn_impl=impl).eval()
        load_jax_variables(tm, params)
        with torch.no_grad():
            tms[impl] = [f.numpy() for f in tm(torch.from_numpy(x))]
    return x, params, tms


@pytest.mark.parametrize("resident_pad_max", [0.0, 0.15])
@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
def test_swin_transformer_matches_jax(nano_swin, jimpl, resident_pad_max):
    """All four stage outputs, against the JAX backbone with and without
    window residency on the padded stage-1 map (the port always runs the
    map path), and with its XLA and Pallas attention."""
    x, params, tms = nano_swin
    jm = jsw.SwinTransformerV2(**_NANO, attn_impl=jimpl,
                               resident_pad_max=resident_pad_max)
    want = jm.apply({"params": params}, jnp.asarray(x))
    shapes = [(2, 23, 29, 32), (2, 12, 15, 64), (2, 6, 8, 128),
              (2, 3, 4, 256)]
    for timpl, got in tms.items():
        for g, w, shp in zip(got, want, shapes):
            w = np.asarray(w)
            assert g.shape == shp and g.dtype == np.float32
            assert w.std() > 0.5          # fp32 output norm: O(1), not flat
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{timpl} vs {jimpl}")


def test_swin_transformer_flags_accepted_and_ignored(nano_swin):
    """scan_blocks / use_checkpoint / remat_policy / resident_pad_max do not
    change the port's forward; an unknown remat policy still raises."""
    x, params, tms = nano_swin
    tm = tsw.SwinTransformerV2(**_NANO, scan_blocks=True, use_checkpoint=True,
                               remat_policy="mlp_only",
                               resident_pad_max=0.15).eval()
    load_jax_variables(tm, params)
    with torch.no_grad():
        got = [f.numpy() for f in tm(torch.from_numpy(x))]
    for g, w in zip(got, tms["torch"]):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tsw.SwinTransformerV2(**_NANO, remat_policy="typo")


def test_swin_state_dict_uses_reference_names():
    tm = tsw.SwinTransformerV2(**_NANO)
    keys = set(tm.state_dict())
    for k in ("patch_embed.proj.weight", "patch_embed.norm.weight",
              "layers.0.blocks.0.attn.qkv.weight",
              "layers.0.blocks.0.attn.q_bias",
              "layers.0.blocks.1.attn.logit_scale",
              "layers.0.blocks.0.attn.rpe_mlp.0.bias",
              "layers.0.blocks.0.attn.rpe_mlp.2.weight",
              "layers.2.blocks.1.mlp.fc2.bias",
              "layers.1.downsample.reduction.weight",
              "layers.1.downsample.norm.bias", "norm3.weight"):
        assert k in keys, k
    assert "layers.0.blocks.0.attn.rpe_mlp.2.bias" not in keys
    assert not any("relative_position_index" in k for k in keys)


def test_cuda_attention_requires_head_dim_32():
    with pytest.raises(NotImplementedError):
        tsw.WindowAttention(96, (4, 4), 6, attn_impl="cuda")   # Dh = 16
    with pytest.raises(ValueError):
        tsw.WindowAttention(96, (4, 4), 3, attn_impl="pallas")
