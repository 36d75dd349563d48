"""The remat policies that keep named intermediates, "attn_out" and
"attn_qkv", against "none" and against the JAX package at the same policy.

Two-stage swin backbones in fp32 on the CPU: swin_nano's widths (embed 32,
heads 1 / 2: the head-split path, where no block names its qkv) and embed
128, heads 4 / 8 (the packed path under "cuda", the slab kernels on the map
under "cuda_slab": the blocks that name `swin_qkv`). The port's kernels run
their plain halves here; on the card `chip_smoke.py`'s `remat` phase runs
the flagship under every policy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmde_tpu.nn import swin_v2 as jsw
from mmde_tpu_torch.ckpt.from_jax import (flatten_tree, load_jax_variables,
                                          to_jax_tree)
from mmde_tpu_torch.nn import swin_v2 as tsw
from mmde_tpu_torch.testing import randomize_tree

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()

POLICIES = ("none", "full", "mlp_only", "attn_out", "attn_qkv")
# (attn_impl, embed, heads): the head-split, packed and slab paths
PATHS = {"headsplit": ("cuda", 32, (1, 2)), "packed": ("cuda", 128, (4, 8)),
         "slab": ("cuda_slab", 128, (4, 8))}
_KW = dict(depths=(2, 2), window_size=(6, 6), out_indices=(1,),
           pretrain_window_size=(4, 4))


def _swin(policy, path, drop_path_rate=0.3, seed=3):
    impl, embed, heads = PATHS[path]
    gen = torch.Generator()
    gen.manual_seed(seed)
    torch.manual_seed(0)
    return tsw.SwinTransformerV2(
        embed_dim=embed, num_heads=heads, drop_path_rate=drop_path_rate,
        use_checkpoint=True, remat_policy=policy, attn_impl=impl,
        generator=gen, **_KW).train()


def _grads(m, x):
    m(x)[-1].square().sum().backward()
    return {n: p.grad.clone() for n, p in m.named_parameters()}


_X = torch.randn(2, 48, 48, 3, generator=torch.Generator().manual_seed(1))


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("policy", POLICIES[1:])
def test_every_policy_gives_the_gradients_of_none(policy, path):
    """Drop path 0.3, one seed: every policy's gradients equal "none"'s bit
    for bit (the kept tensors are the first run's, the replayed segments
    see the same drop-path masks)."""
    base = _grads(_swin("none", path), _X)
    got = _grads(_swin(policy, path), _X)
    assert sorted(got) == sorted(base)
    for n in base:
        torch.testing.assert_close(got[n], base[n], rtol=0, atol=0, msg=n)


def _blocks(model):
    return [b for layer in model.layers for b in layer.blocks]


class _Counts:
    """Calls of every block's qkv projection and attention, by block."""

    def __init__(self, model):
        self.qkv, self.attend = [], []
        for i, blk in enumerate(_blocks(model)):
            blk.attn.qkv.register_forward_hook(
                lambda *a, i=i: self.qkv.append(i))

            def attend(*a, i=i, orig=blk.attn.attend, **kw):
                self.attend.append(i)
                return orig(*a, **kw)
            blk.attn.attend = attend


@pytest.mark.parametrize("path", sorted(PATHS))
def test_what_each_policy_replays(path):
    """Per block and step: the attention runs once under "none" and
    "mlp_only" and twice under "full", "attn_out" and "attn_qkv" (the
    backward replays it from its kept input: on the card, the forward
    kernel with the log-sum-exp again, then the backward kernel). The qkv
    projection is replayed too, except under "attn_qkv" on the blocks that
    name it (packed and slab), where it is kept."""
    m = _swin("none", path)
    stage1 = torch.zeros(1, 12, 12, m.layers[0].blocks[0].attn.dim)
    assert all(blk.names_qkv(stage1) == (path != "headsplit")
               for blk in m.layers[0].blocks)
    assert all(blk.slab(stage1) == (path == "slab")
               for blk in m.layers[0].blocks)
    for policy in POLICIES:
        m = _swin(policy, path)
        counts = _Counts(m)
        _grads(m, _X)
        blocks = len(_blocks(m))
        twice = policy in ("full", "attn_out", "attn_qkv")
        want_attend = {i: 2 if twice else 1 for i in range(blocks)}
        keeps_qkv = policy == "attn_qkv" and path != "headsplit"
        want_qkv = {i: 2 if twice and not keeps_qkv else 1
                    for i in range(blocks)}
        assert {i: counts.attend.count(i) for i in range(blocks)} == \
            want_attend, policy
        assert {i: counts.qkv.count(i) for i in range(blocks)} == \
            want_qkv, policy


@pytest.mark.parametrize("policy", ["attn_out", "attn_qkv"])
def test_gradients_match_jax_at_the_same_policy(policy):
    """The packed-path backbone (drop path 0) under the policy against the
    JAX backbone's jax.grad under it (its XLA attention; the JAX remat
    policy keeps the same named tensors): 5e-4 of each gradient's largest
    entry, the port's limit for fp32 backbone gradients."""
    impl, embed, heads = PATHS["packed"]
    kw = dict(embed_dim=embed, num_heads=heads, drop_path_rate=0.0,
              use_checkpoint=True, remat_policy=policy, **_KW)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 48, 48, 3)).astype(np.float32)
    jm = jsw.SwinTransformerV2(attn_impl="xla", **kw)
    v = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                       jnp.asarray(x)))
    params = randomize_tree(v["params"], rng)
    out_shape = jax.eval_shape(lambda: jm.apply({"params": params},
                                                jnp.asarray(x)))[-1].shape
    w = rng.standard_normal(out_shape).astype(np.float32)

    def loss(p):
        return jnp.sum(jm.apply({"params": p}, jnp.asarray(x))[-1] * w)

    want = flatten_tree(jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(
        jax.tree.map(jnp.asarray, params))))
    tm = tsw.SwinTransformerV2(attn_impl=impl, **kw)
    load_jax_variables(tm, params)
    tm.train()
    (tm(torch.from_numpy(x))[-1] * torch.from_numpy(w)).sum().backward()
    got = flatten_tree(to_jax_tree(
        {n: p.grad for n, p in tm.named_parameters()}, params))
    assert sorted(got) == sorted(want)
    for path in want:
        scale = np.abs(want[path]).max()
        assert scale > 0, path
        np.testing.assert_allclose(got[path], want[path], rtol=0,
                                   atol=5e-4 * scale, err_msg="/".join(path))
