"""The port's model zoo against ``shapley_vit_tpu.models.zoo`` (flax), the
larger models (``tests/test_torch_zoo.py`` holds the small ones and the
helpers), float32 on the CPU:

* logits within 1e-4 in eval and in train mode for AlexNet(BN), VGG11(BN),
  ResNet18(BN) and ResNet18_AP at 32 px, batch 4; VGG11BN's batch
  statistics after a train-mode forward within 1e-6;
* the grayscale quirks (first-layer paddings, ConvNet's 28 -> 32 pad);
* whole-variable FedAvg deltas of a ConvNetBN (params and BatchNorm
  statistics), 3 clients, 7 coalitions, through ``materialize_coalitions``
  and the port's evaluator backend (``coalition_chunk=2``), against JAX's
  evaluator on the same deltas and the port's serial FedAvg-apply-evaluate
  loop, within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapley_vit_tpu.fl import evaluation as jev
from shapley_vit_tpu.models import zoo as jzoo
from shapley_vit_tpu.ops import tree_math as jtm
from shapley_vit_tpu_torch.fl import evaluation as tev
from shapley_vit_tpu_torch.models import zoo as tzoo
from shapley_vit_tpu_torch.models.convert import flax_zoo_to_state_dict
from shapley_vit_tpu_torch.ops import tree_math as ttm
from shapley_vit_tpu_torch.parallel.coalition_eval import make_eval_backend
from test_torch_zoo import _both, check_logits_and_stats
from torch_one_thread import one_torch_thread  # noqa: F401

MEDIUM = ["AlexNet", "AlexNetBN", "VGG11", "VGG11BN", "ResNet18", "ResNet18BN", "ResNet18_AP"]


@pytest.mark.parametrize("name", MEDIUM)
def test_zoo_logits_match_flax_in_eval_and_train(name):
    check_logits_and_stats(name)


@pytest.mark.parametrize("name", ["ConvNet", "LeNet", "AlexNet", "VGG11"])
def test_grayscale_quirks_match_flax(name):
    size = (28, 28) if name == "ConvNet" else (32, 32)
    apply_fn, variables, net = _both(name, channel=1, size=size)
    x = np.random.default_rng(2).normal(size=(2, size[0], size[1], 1)).astype(np.float32)
    net.eval()
    np.testing.assert_allclose(net(torch.tensor(x)).detach().numpy(),
                               np.asarray(apply_fn(variables, x)), atol=1e-4, rtol=0)


def test_whole_variable_coalition_eval_matches_jax():
    net_j = jzoo.build_network("ConvNetBN", channel=3, num_classes=4, im_size=(16, 16))
    variables = jax.device_get(jax.jit(lambda k: net_j.init(k, jnp.zeros((2, 16, 16, 3)),
                                                            train=False))(jax.random.key(0)))
    leaves, treedef = jax.tree.flatten(variables)
    deltas = [treedef.unflatten([
        np.asarray(0.05 * jax.random.normal(k, l.shape, l.dtype))
        for k, l in zip(jax.random.split(jax.random.key(10 + i), len(leaves)), leaves)])
        for i in range(3)]
    sizes = [100.0, 300.0, 600.0]
    coalitions = [[0], [1], [2], [0, 1], [0, 2], [1, 2], [0, 1, 2]]
    W = jtm.coalition_weight_matrix(coalitions, sizes, 3)
    rng = np.random.default_rng(4)
    images = rng.normal(size=(10, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 4, size=10)
    data = [(images[:6], labels[:6]), (images[6:], labels[6:])]
    want = jev.make_coalition_evaluator(lambda _s, v, x: net_j.apply(v, x, train=False),
                                        coalition_chunk=2)(
        {}, jtm.materialize_coalitions(variables, jtm.tree_stack(deltas), W), data)

    net = tzoo.build_network("ConvNetBN", 3, 4, (16, 16))
    tvars = flax_zoo_to_state_dict(variables)
    tdeltas = [flax_zoo_to_state_dict(d) for d in deltas]
    fwd = tzoo.make_coalition_forward(net)
    backend = make_eval_backend(fwd, coalition_chunk=2, device="cpu")
    got = backend.evaluate({}, ttm.materialize_coalitions(tvars, ttm.tree_stack(tdeltas), W),
                           data)
    assert got.shape == (7, 2)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    # the serial oracle: FedAvg-apply one coalition at a time
    for row, members in enumerate(coalitions):
        agg = ttm.aggregate_deltas(ttm.tree_stack([tdeltas[j] for j in members]),
                                   ttm.fedavg_ratio([sizes[j] for j in members]))
        one = ttm.apply_deltas(tvars, agg)
        acc, loss = tev.evaluate_model(
            lambda v, x: fwd(None, {k: t[None] for k, t in v.items()}, x)[0], one,
            [(torch.tensor(x), torch.tensor(y)) for x, y in data])
        np.testing.assert_allclose(got[row], [acc, loss], atol=1e-5, rtol=0)
