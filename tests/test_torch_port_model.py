"""PyTorch port vs JAX package: the serving slice as a whole, on the CPU.

TwoFrameDepthPose with the flagship STRUCTURE (depths 2/2/18/2, windows
30/30/30/15, shift on stages 1-2, decoder_v2) at nano widths, weights drawn
with numpy at O(1) scale into the JAX trees and carried across through
`load_jax_variables`; then the entry points around it (`_image`,
`make_forward`, `flip_average`, `tools.infer.predict`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmde_tpu import config as jcfg
from mmde_tpu.models import build_model as j_build_model
from mmde_tpu.train import step as jstep
from mmde_tpu.train import tta as jtta
from mmde_tpu_torch import config as tcfg
from mmde_tpu_torch.ckpt.from_jax import load_jax_variables
from mmde_tpu_torch.models import two_frame as ttf
from mmde_tpu_torch.testing import randomize_tree
from mmde_tpu_torch.tools import infer
from mmde_tpu_torch.train import step as tstep
from mmde_tpu_torch.train import tta as ttta

_FLAGSHIP_SWIN = dict(depths=(2, 2, 18, 2), window_size=(30, 30, 30, 15),
                      pretrain_window_size=(12, 12, 12, 6),
                      use_shift=(True, True, False, False),
                      drop_path_rate=0.3)
_SMALL_SWIN = dict(depths=(2, 2, 2, 2), window_size=(6, 6, 6, 3),
                   pretrain_window_size=(4, 4, 4, 2),
                   use_shift=(True, True, False, False), drop_path_rate=0.1)
_KEYS = ("pred_d1", "pred_d2", "pred_r12", "pred_r21", "pred_t12",
         "pred_t21")


def _cfgs(swin, *, dtype="float32", decoder="decoder_v2", attn="kernel",
          j_attn=None, model_scale=32):
    """(JAX ModelConfig, port ModelConfig). attn "kernel": the port's packed
    wrapper (its plain version on the CPU) and, on the JAX side, the Pallas
    kernel in interpret mode; "plain": split-head torch and XLA. `j_attn`
    overrides the JAX side alone."""
    kw = dict(backbone="swin_nano_v2", decoder=decoder,
              model_scale=model_scale, max_depth=10.0, dtype=dtype)
    return (jcfg.ModelConfig(swin=jcfg.SwinConfig(**swin),
                             use_pallas_attention=(j_attn or attn) == "kernel",
                             **kw),
            tcfg.ModelConfig(swin=tcfg.SwinConfig(**swin),
                             use_pallas_attention=attn == "kernel", **kw))


def _pair(jc, tc, h, w, seed):
    rng = np.random.default_rng(seed)
    f1 = rng.random((1, h, w, 3)).astype(np.float32)
    f2 = rng.random((1, h, w, 3)).astype(np.float32)
    jm = j_build_model(jc)
    # shapes only: the 24-block initialisation is neither compiled nor run
    v = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                       jnp.asarray(f1), jnp.asarray(f2),
                                       False))
    g = np.random.default_rng(seed + 1)
    variables = {"params": randomize_tree(v["params"], g),
                 "batch_stats": randomize_tree(v["batch_stats"], g)}
    tm = ttf.build_model(tc, device="cpu").eval()
    load_jax_variables(tm, variables["params"], variables["batch_stats"])
    return jm, variables, tm, f1, f2


@pytest.fixture(scope="module")
def flagship_nano():
    """96x128 frames: stage 1 map 24x32 pads to 30x60 (two windows, shift
    mask), later stages pad to one window; 24 attention blocks. The port
    runs its packed attention wrapper; the JAX side its XLA attention (the
    Pallas kernel's own plain reference: interpret mode at N = 900 is slow,
    and is held to the port in the attention and backbone tests)."""
    jc, tc = _cfgs(_FLAGSHIP_SWIN, j_attn="plain")
    jm, variables, tm, f1, f2 = _pair(jc, tc, 96, 128, seed=0)
    want = jm.apply(variables, jnp.asarray(f1), jnp.asarray(f2), False)
    want = {k: np.asarray(v) for k, v in want.items()}
    return jm, variables, tm, f1, f2, want


def test_two_frame_flagship_structure_matches_jax(flagship_nano):
    jm, variables, tm, f1, f2, want = flagship_nano
    with torch.no_grad():
        got = tm(torch.from_numpy(f1), torch.from_numpy(f2))
    assert sorted(got) == sorted(_KEYS)
    for k in _KEYS:
        assert got[k].dtype == torch.float32
        assert tuple(got[k].shape) == want[k].shape, k
    assert want["pred_d1"].shape == (1, 96, 128, 1)
    # not the vacuous near-constant max_depth/2 map
    assert want["pred_d1"].std() > 0.1 and want["pred_d2"].std() > 0.1
    for k in ("pred_d1", "pred_d2"):        # depth in (0, 10): 1e-3 absolute
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-3, err_msg=k)
    for k in ("pred_r12", "pred_r21", "pred_t12", "pred_t21"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_two_frame_plain_attention_path_matches_kernel_path(flagship_nano):
    """attn_impl 'torch' (split heads) and 'cuda' (packed wrapper) agree."""
    _, variables, tm, f1, f2, want = flagship_nano
    _, tc = _cfgs(_FLAGSHIP_SWIN, attn="plain")
    assert ttf.resolve_attn_impl(tc) == "torch"
    tp = ttf.build_model(tc, device="cpu").eval()
    load_jax_variables(tp, variables["params"], variables["batch_stats"])
    with torch.no_grad():
        got = tp(torch.from_numpy(f1), torch.from_numpy(f2))
    np.testing.assert_allclose(got["pred_d1"].numpy(), want["pred_d1"],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["pred_r12"].numpy(), want["pred_r12"],
                               rtol=1e-4, atol=1e-4)


def test_two_frame_bf16_matches_jax():
    """bfloat16 activations with the fp32 islands. The two frameworks round
    to bf16 at different places (a fused bias add here, a separate one
    there), and the roundings compound through 8 blocks and the decoder.
    Measured here: depth mean |diff| 0.025, max 0.17 on a range of 0-10,
    pose 0.004. Held to mean <= 0.05, max <= 0.4, pose <= 0.02."""
    jc, tc = _cfgs(_SMALL_SWIN, dtype="bfloat16")
    jm, variables, tm, f1, f2 = _pair(jc, tc, 92, 116, seed=2)
    want = jm.apply(variables, jnp.asarray(f1), jnp.asarray(f2), False)
    with torch.no_grad():
        got = tm(torch.from_numpy(f1), torch.from_numpy(f2))
    for k in ("pred_d1", "pred_d2"):
        w = np.asarray(want[k], dtype=np.float32)
        assert w.std() > 0.1
        assert got[k].dtype == torch.float32      # sigmoid * max_depth: fp32
        d = np.abs(got[k].numpy() - w)
        assert d.mean() <= 0.05 and d.max() <= 0.4, (k, d.mean(), d.max())
    for k in ("pred_r12", "pred_r21", "pred_t12", "pred_t21"):
        assert got[k].dtype == torch.bfloat16
        w = np.asarray(want[k].astype(jnp.float32))
        assert np.abs(got[k].float().numpy() - w).max() <= 0.02, k


@pytest.mark.parametrize("decoder,scale", [("decoder_v1", 32),
                                           ("decoder_v2", 16)])
def test_two_frame_variants_match_jax(decoder, scale):
    """decoder_v1 (r21/t21 None) and model_scale 16 (three stages)."""
    jc, tc = _cfgs(_SMALL_SWIN, decoder=decoder, model_scale=scale,
                   attn="plain")
    jm, variables, tm, f1, f2 = _pair(jc, tc, 64, 80, seed=4)
    want = jm.apply(variables, jnp.asarray(f1), jnp.asarray(f2), False)
    with torch.no_grad():
        got = tm(torch.from_numpy(f1), torch.from_numpy(f2))
    for k in _KEYS:
        if want[k] is None:
            assert got[k] is None and decoder == "decoder_v1"
            continue
        tol = 1e-3 if k.startswith("pred_d") else 1e-4
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=tol, err_msg=k)


def test_image_uint8_matches_jax():
    rng = np.random.default_rng(5)
    u8 = rng.integers(0, 256, size=(2, 5, 7, 3), dtype=np.uint8)
    want = np.asarray(jstep._image(jnp.asarray(u8)))
    got = tstep._image(torch.from_numpy(u8))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-7, atol=0)
    f = torch.rand(2, 3)
    assert tstep._image(f) is f


def test_make_forward_uint8_matches_jax(flagship_nano):
    jm, variables, tm, _, _, _ = flagship_nano
    rng = np.random.default_rng(6)
    u1 = rng.integers(0, 256, size=(1, 96, 128, 3), dtype=np.uint8)
    u2 = rng.integers(0, 256, size=(1, 96, 128, 3), dtype=np.uint8)
    jf = jstep.make_forward(jm)
    want = jf(variables, jstep._image(jnp.asarray(u1)),
              jstep._image(jnp.asarray(u2)))
    tm.train()
    got = tstep.make_forward(tm)(torch.from_numpy(u1), torch.from_numpy(u2))
    assert not tm.training                   # make_forward serves in eval
    np.testing.assert_allclose(got["pred_d1"].numpy(),
                               np.asarray(want["pred_d1"]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["pred_t21"].numpy(),
                               np.asarray(want["pred_t21"]), rtol=1e-4,
                               atol=1e-4)
    assert not got["pred_d1"].requires_grad


def test_flip_average_matches_jax():
    jc, tc = _cfgs(_SMALL_SWIN, attn="plain")
    jm, variables, tm, f1, f2 = _pair(jc, tc, 64, 80, seed=7)

    def jfwd(im):
        return jm.apply(variables, im, im, False)["pred_d1"]

    tforward = tstep.make_forward(tm)
    want = np.asarray(jtta.flip_average(jfwd, jnp.asarray(f1)))
    got = ttta.flip_average(lambda im: tforward(im, im)["pred_d1"],
                            torch.from_numpy(f1)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    plain = tforward(torch.from_numpy(f1), torch.from_numpy(f1))["pred_d1"]
    assert np.abs(got - plain.numpy()).max() > 1e-3     # the flip did count

    # two-frame form: depth averaged, pose from the unflipped pass (what the
    # JAX eval step does with flip_tta=True)
    jout = jm.apply(variables, jnp.asarray(f1), jnp.asarray(f2), False)
    jflip = jm.apply(variables, jnp.asarray(f1)[:, :, ::-1],
                     jnp.asarray(f2)[:, :, ::-1], False)
    out = ttta.flip_average_two_frame(tforward, torch.from_numpy(f1),
                                      torch.from_numpy(f2))
    for k in ("pred_d1", "pred_d2"):
        w = 0.5 * (np.asarray(jout[k]) + np.asarray(jflip[k])[:, :, ::-1])
        np.testing.assert_allclose(out[k].numpy(), w, rtol=0, atol=1e-3)
    for k in ("pred_r12", "pred_t12", "pred_r21", "pred_t21"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   rtol=1e-4, atol=1e-4)


def test_infer_predict_arrays_in_arrays_out(flagship_nano):
    _, _, tm, f1, f2, want = flagship_nano
    out = infer.predict(tm, f1, f2)
    assert all(isinstance(out[k], np.ndarray) and out[k].dtype == np.float32
               for k in _KEYS)
    np.testing.assert_allclose(out["pred_d2"], want["pred_d2"], rtol=0,
                               atol=1e-3)
    u1 = (f1 * 255).astype(np.uint8)
    u2 = (f2 * 255).astype(np.uint8)
    out8 = infer.predict(tm, u1, u2, flip_tta=True)
    assert out8["pred_d1"].shape == (1, 96, 128, 1)
    assert np.isfinite(out8["pred_d1"]).all()
    np.testing.assert_allclose(out8["pred_r12"],
                               infer.predict(tm, u1, u2)["pred_r12"])


def test_infer_build_is_seeded_and_loads_weights(tmp_path):
    _, tc = _cfgs(_SMALL_SWIN, attn="plain")
    a = infer.build(tc, device="cpu", seed=3)
    b = infer.build(tc, device="cpu", seed=3)
    c = infer.build(tc, device="cpu", seed=4)
    ka = "encoder.layers.0.blocks.0.attn.qkv.weight"
    assert torch.equal(a.state_dict()[ka], b.state_dict()[ka])
    assert not torch.equal(a.state_dict()[ka], c.state_dict()[ka])
    assert not a.training
    path = tmp_path / "w.pth"
    torch.save({"model": a.state_dict()}, path)
    infer.load_weights(c, str(path))
    assert torch.equal(a.state_dict()[ka], c.state_dict()[ka])


def test_load_jax_variables_reports_missing_and_unexpected(flagship_nano):
    _, variables, tm, _, _, _ = flagship_nano
    params = {k: dict(v) for k, v in variables["params"].items()}
    enc = dict(params["encoder"])
    enc.pop("norm3")
    enc["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    params["encoder"] = enc
    with pytest.raises(KeyError) as e:
        load_jax_variables(tm, params, variables["batch_stats"])
    assert "encoder.norm3.weight" in str(e.value)
    assert "encoder/stray/kernel" in str(e.value)
    with pytest.raises(KeyError):                       # BN statistics absent
        load_jax_variables(tm, variables["params"], None)


def test_not_ported_families_raise_naming_the_roadmap():
    """The families that raised here until the other encoders and families
    were ported now build (small widths: resnet18, swin_nano, one block a
    stage); what is still not ported raises naming its ROADMAP item (the
    remat policies that save named intermediates, M2)."""
    from mmde_tpu_torch.models import glpdepth as tglp
    swin = tcfg.SwinConfig(depths=(1, 1, 1, 1), window_size=(4, 4, 4, 2),
                           pretrain_window_size=(4, 4, 4, 2))
    cnn = tcfg.CnnTransformerConfig(cnn_model="resnet18",
                                    transformer_ff_dim=64)
    for kw, cls in ((dict(backbone="cnn_transformer_multi_scale"),
                     ttf.TwoFrameDepthPose),
                    (dict(backbone="resnet_only"), ttf.TwoFrameDepthPose),
                    (dict(backbone="swin_nano_v2", family="glpdepth"),
                     tglp.GLPDepth),
                    (dict(backbone="swin_nano_v2",
                          family="glpdepth_scale16"), tglp.Scale16TwoFrame)):
        m = ttf.build_model(tcfg.ModelConfig(swin=swin, cnn=cnn, **kw),
                            device="cpu")
        assert type(m) is cls, kw
    remat = tcfg.ModelConfig(backbone="swin_nano_v2", swin=tcfg.SwinConfig(
        depths=(1, 1, 1, 1), window_size=(4, 4, 4, 2),
        pretrain_window_size=(4, 4, 4, 2), use_checkpoint=True,
        remat_policy="attn_out"), model_scale=32)
    m = ttf.build_model(remat, device="cpu").train()
    x = torch.rand(2, 64, 64, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        m(x, x)
    # the slab kernels are ported: "pallas_slab" resolves, it does not raise
    assert ttf.resolve_attn_impl(
        tcfg.ModelConfig(attn_impl="pallas_slab")) == "cuda_slab"


def test_build_plan_and_variants_match_jax():
    from mmde_tpu.models import two_frame as jtf
    assert ttf.SWIN_VARIANTS == jtf.SWIN_VARIANTS
    for backbone in ("swin_nano_v2", "swin_tiny_v2", "swin_base_v2",
                     "swin_large_v2", "swin_huge_v2", "cnn_transformer",
                     "resnet_only_multi_scale"):
        for scale in (16, 32):
            for cm in ("resnet50", "resnet18"):
                kw = dict(backbone=backbone, model_scale=scale)
                j = jtf.build_plan(jcfg.ModelConfig(
                    cnn=jcfg.CnnTransformerConfig(cnn_model=cm), **kw))
                t = ttf.build_plan(tcfg.ModelConfig(
                    cnn=tcfg.CnnTransformerConfig(cnn_model=cm), **kw))
                assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for attn, use, want in (("", True, "cuda"), ("", False, "torch"),
                            ("torch", True, "torch"), ("cuda", False, "cuda"),
                            ("xla", True, "torch"), ("pallas", False, "cuda"),
                            ("pallas_slab", False, "cuda_slab"),
                            ("cuda_slab", True, "cuda_slab")):
        cfg = tcfg.ModelConfig(attn_impl=attn, use_pallas_attention=use)
        assert ttf.resolve_attn_impl(cfg) == want
    with pytest.raises(ValueError):
        ttf.resolve_attn_impl(tcfg.ModelConfig(attn_impl="typo"))
