"""The port's model zoo against ``shapley_vit_tpu.models.zoo`` (flax) with
the same numpy variables (``models.convert.flax_zoo_to_state_dict``), at
32 px, batch 4, float32 on the CPU.

* Logits within 1e-4 in eval and in train mode over ``tests/test_zoo.py``'s
  ``SMALL_VARIANTS`` (``tests/test_torch_zoo_medium.py`` takes AlexNet(BN),
  VGG11(BN), ResNet18(BN) and ResNet18_AP), and the converter's round trip
  back to flax's tree;
* ConvNetBN's batch statistics after a train-mode forward within 1e-6
  (flax's momentum 0.99 and biased variance: a stock ``BatchNorm2d`` would
  be n/(n-1) off in ``running_var``);
* the tabular MLPs, ``model_head``, the unknown-model error, the port's
  ``get_network``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapley_vit_tpu.models import zoo as jzoo
from shapley_vit_tpu_torch.models import zoo as tzoo
from shapley_vit_tpu_torch.models.convert import flax_zoo_to_state_dict, state_dict_to_flax_zoo
from test_zoo import SMALL_VARIANTS
from torch_one_thread import one_torch_thread  # noqa: F401

def _flax(name, channel, size, seed=0, num_classes=10):
    """``zoo.get_network``'s module, variables and apply_fn, with init and
    apply compiled whole (eager flax dispatches op by op, which costs the
    CPU suite seconds a model)."""
    module = jzoo.build_network(name, channel, num_classes, size)
    dummy = jnp.zeros((1, size) if isinstance(size, int) else (1, size[0], size[1], channel))
    variables = jax.device_get(jax.jit(lambda k: module.init(k, dummy, train=False))(
        jax.random.key(seed)))

    @jax.jit
    def train_apply(v, x):
        out, mut = module.apply(v, x, train=True, mutable=["batch_stats"])
        return out, mut["batch_stats"]

    eval_apply = jax.jit(lambda v, x: module.apply(v, x, train=False))

    def apply_fn(v, x, train=False):
        if train and "batch_stats" in v:
            return train_apply(v, x)
        return eval_apply(v, x) if not train else jax.jit(
            lambda v, x: module.apply(v, x, train=True))(v, x)

    return module, variables, apply_fn


def _both(name, channel=3, size=(32, 32), seed=0):
    """The flax module's variables (BatchNorm statistics moved off their
    init values) and the port's module loaded with them."""
    _, variables, apply_fn = _flax(name, channel, size, seed)
    rng = np.random.default_rng(seed)
    if "batch_stats" in variables:
        variables = dict(variables)
        variables["batch_stats"] = jax.tree.map(
            lambda a: (np.abs(a) + 0.5 + 0.2 * rng.random(a.shape)).astype(np.float32),
            variables["batch_stats"])
    net = tzoo.build_network(name, channel, 10, size)
    net.load_state_dict(flax_zoo_to_state_dict(variables), strict=True)
    return apply_fn, variables, net


def check_logits_and_stats(name):
    apply_fn, variables, net = _both(name)
    x = np.random.default_rng(1).normal(size=(4, 32, 32, 3)).astype(np.float32)
    net.eval()
    got = net(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(apply_fn(variables, x)), atol=1e-4, rtol=0)
    out = apply_fn(variables, x, train=True)
    want, new_stats = out if isinstance(out, tuple) else (out, None)
    net.train()
    got = net(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)
    back = state_dict_to_flax_zoo(net.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    if new_stats is not None:
        tol = 1e-6 if name in ("ConvNetBN", "VGG11BN") else 1e-5
        for a, b in zip(jax.tree.leaves(back["batch_stats"]),
                        jax.tree.leaves(jax.device_get(new_stats))):
            np.testing.assert_allclose(a, b, atol=tol, rtol=0)


@pytest.mark.parametrize("name", SMALL_VARIANTS)
def test_zoo_logits_match_flax_in_eval_and_train(name):
    check_logits_and_stats(name)


def test_port_batchnorm_is_not_torchs():
    """flax's update: momentum 0.99 toward the biased batch variance."""
    bn = tzoo.BatchNorm(3).train()
    x = torch.randn(2, 3, 2, 2, generator=torch.Generator().manual_seed(0))
    bn(x)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.99 + 0.01 * var, atol=1e-7, rtol=0)
    torch.testing.assert_close(bn.running_mean, 0.01 * x.mean(dim=(0, 2, 3)), atol=1e-7, rtol=0)


def test_tabular_head_and_unknown_model():
    for name in ("MLP_tabular", "MLP_linear"):
        _, variables, apply_fn = _flax(name, 1, 14, num_classes=2)
        net = tzoo.build_network(name, 1, 2, 14)
        net.load_state_dict(flax_zoo_to_state_dict(jax.device_get(variables)), strict=True)
        x = np.random.default_rng(3).normal(size=(5, 14)).astype(np.float32)
        np.testing.assert_allclose(net(torch.tensor(x)).detach().numpy(),
                                   np.asarray(apply_fn(variables, x)), atol=1e-5, rtol=0)
    module, variables, _ = _flax("AlexNet", 3, (32, 32))
    x = np.zeros((2, 32, 32, 3), np.float32)
    want = jzoo.model_head(module)(variables, x)
    net, tvars, _ = tzoo.get_network("AlexNet", 3, 10, (32, 32), device="cpu")
    tvars = flax_zoo_to_state_dict(jax.device_get(variables))
    got = tzoo.model_head(net)(tvars, torch.tensor(x))
    assert tuple(got.shape) == (2, 192 * 4 * 4)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        tzoo.model_head(tzoo.MLP(channel=3, num_classes=10))
    for bad in ("TransformerXL", "VGG12", "ResNet20", "ConvNetXX"):
        with pytest.raises(ValueError, match="unknown model"):
            tzoo.build_network(bad, 3, 10)


def test_get_network_apply_fn_returns_new_stats_and_is_seeded():
    net, variables, apply_fn = tzoo.get_network("ConvNetBN", 3, 10, (16, 16), seed=3, device="cpu")
    again = tzoo.get_network("ConvNetBN", 3, 10, (16, 16), seed=3, device="cpu")[1]
    for k in variables:
        torch.testing.assert_close(variables[k], again[k], atol=0, rtol=0)
    x = torch.randn(4, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    logits, stats = apply_fn(variables, x, train=True)
    assert tuple(logits.shape) == (4, 10)
    assert sorted(stats) == sorted(k for k in variables if "running" in k)
    assert any(not torch.equal(stats[k], variables[k]) for k in stats)
    assert tuple(apply_fn(variables, x).shape) == (4, 10)
    assert tzoo.swish(torch.tensor([0.0])).item() == 0.0
