"""PyTorch port vs JAX package: the ResNet trunks (nn/resnet.py), on the CPU.

Weights and BatchNorm statistics drawn with numpy into the JAX trees and
carried across by `load_jax_variables`; the same NHWC input through
mmde_tpu.nn.resnet and the port, in eval mode (running statistics) and in
train mode (batch statistics, then the running statistics each module
updated, compared leaf by leaf). resnet18 at 72x72 (odd maps at every
stride-2 step: 36 -> 18 -> 9 -> 5 -> 3) and one resnet50 case at
128x128 (f5 4x4: train-mode BatchNorm sees 32 values a channel).

The last BatchNorm of every residual branch has its drawn scale (~1) cut
to a fifth, as in a trained ResNet, whose branches add little to the
identity path. With every branch at full scale the residual stream grows
block by block, and float32 alone moves resnet50's train-mode f5 by
~1e-3 on values near 10: the port and the JAX package in float32 each sit
that far from the port run in float64, while agreeing to the limit at f3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmde_tpu.nn import resnet as jres
from mmde_tpu_torch.ckpt.from_jax import (flatten_tree, key_map,
                                          load_jax_variables, to_jax_tree)
from mmde_tpu_torch.nn import resnet as tres
from mmde_tpu_torch.testing import randomize_tree

ATOL = 1e-4


def _apply(module, *args, **kw):
    """module.apply under jax.jit (eager dispatch of a swin stack costs ~10x
    its compile); keyword arguments other than arrays are static."""
    arrays = {k: v for k, v in kw.items() if hasattr(v, "shape")}
    static = {k: v for k, v in kw.items() if k not in arrays}
    train = [a for a in args if isinstance(a, bool)]
    rest = [a for a in args if not isinstance(a, bool)]
    return jax.jit(lambda r, a: module.apply(*r, *train, **a, **static))(
        rest, arrays)


def _damp_residual(tree, factor=0.2):
    """Scale the last BatchNorm of each block's residual branch (bn3 of a
    Bottleneck, bn2 of a BasicBlock) by `factor`, in place."""
    for k, v in tree.items():
        if not isinstance(v, dict):
            continue
        last = "bn3" if "bn3" in v else "bn2" if "conv2" in v else None
        if last is not None:
            v[last]["scale"] = v[last]["scale"] * np.float32(factor)
        else:
            _damp_residual(v, factor)


def _pair(jmod, tmod, x, seed):
    v = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x), False))
    g = np.random.default_rng(seed)
    variables = {"params": randomize_tree(v["params"], g),
                 "batch_stats": randomize_tree(v["batch_stats"], g)}
    _damp_residual(variables["params"])
    load_jax_variables(tmod, variables["params"], variables["batch_stats"])
    return variables


def _close(got, want, what):
    """|got - want| <= 1e-4 (relative) + 1e-4 of the map's largest value."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=ATOL * scale, err_msg=what)


CASES = {
    "multi18": (lambda: jres.ResNetMultiScale(model="resnet18"),
                lambda: tres.ResNetMultiScale("resnet18"), 72),
    "single18": (lambda: jres.ResNetSingleScale(model="resnet18"),
                 lambda: tres.ResNetSingleScale("resnet18"), 72),
    "features18": (lambda: jres.ResNetFeatures(model="resnet18",
                                               num_stages=4),
                   lambda: tres.ResNetFeatures("resnet18", 4), 72),
    "multi50": (lambda: jres.ResNetMultiScale(model="resnet50"),
                lambda: tres.ResNetMultiScale("resnet50"), 128),
}


def _outs(y):
    return list(y) if isinstance(y, (list, tuple)) else [y]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("train", [False, True])
def test_resnet_trunk_matches_jax(case, train):
    jf, tf, size = CASES[case]
    rng = np.random.default_rng(3)
    x = rng.random((2, size, size, 3)).astype(np.float32)
    jm, tm = jf(), tf()
    variables = _pair(jm, tm, x, seed=11)
    tm.train(train)
    if train:
        want, mut = _apply(jm, variables, jnp.asarray(x), True,
                             mutable=["batch_stats"])
    else:
        want = _apply(jm, variables, jnp.asarray(x), False)
    got = tm(torch.from_numpy(x))
    want, got = _outs(want), _outs(got)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, (case, i)
        assert np.asarray(w).std() > 0.1
        _close(g, w, f"{case} out {i}")
    if train:
        stats = flatten_tree(to_jax_tree(dict(tm.named_buffers()),
                                         variables["batch_stats"]))
        new = flatten_tree(jax.tree.map(np.asarray, mut["batch_stats"]))
        old = flatten_tree(variables["batch_stats"])
        assert stats.keys() == new.keys()
        for path in new:
            assert not np.allclose(new[path], old[path])   # it moved
            np.testing.assert_allclose(stats[path], new[path], rtol=1e-4,
                                       atol=1e-4, err_msg="/".join(path))


def test_trunk_names_are_the_reference_encoders():
    """The JAX trunk's leaves land on the reference PyTorch encoder's
    Sequential slices (the names mmde_tpu/ckpt/torch_convert.py reads)."""
    x = jnp.zeros((1, 64, 64, 3))
    for jm, single in ((jres.ResNetMultiScale(model="resnet50"), False),
                       (jres.ResNetSingleScale(model="resnet50"), True)):
        v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, False))
        km = key_map(v["params"])
        by_path = {"/".join(p): k for p, k in km.items()}
        if single:
            assert by_path["trunk/stem_conv/kernel"] == "feature.0.weight"
            assert by_path["trunk/layer3_0/downsample_bn/scale"] == \
                "feature.6.0.downsample.1.weight"
        else:
            assert by_path["trunk/stem_conv/kernel"] == "feature3.0.weight"
            assert by_path["trunk/layer2_3/conv3/kernel"] == \
                "feature3.5.3.conv3.weight"
            assert by_path["trunk/layer3_0/downsample/kernel"] == \
                "feature4.0.0.downsample.0.weight"
            assert by_path["trunk/layer4_2/bn2/bias"] == \
                "feature5.0.2.bn2.bias"
    tm = tres.ResNetFeatures("resnet18")
    assert "layer1.0.conv1.weight" in dict(tm.named_parameters())
    assert "conv1.weight" in dict(tm.named_parameters())
