"""The port's centralized-SGD baseline (``driver/cent_sgd.py``) against the
JAX package's, float32 on the CPU.

* The training step: a ConvNetBN (BatchNorm in train mode) and an MLP from
  the same flax variables, one step and then two more of ``cent_sgd``'s
  update (``optax.chain(add_decayed_weights(wd), sgd(lr, momentum=0.9))``
  there, ``torch.optim.SGD(momentum=0.9, weight_decay=wd)`` in the port):
  losses, parameters and BatchNorm statistics within 1e-5.
* A mini end-to-end run (MLP on synthetic MNIST, 1 experiment, 2 epochs)
  checks what ``tests/test_checkpoint_profiling_plots.py``'s checks: the
  summary, curves, best-accuracy checkpoint (with the JAX checkpoint's
  keys), the PNGs and the ``exp_seq.txt`` bookkeeping.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shapley_vit_tpu.models import zoo as jzoo
from shapley_vit_tpu_torch.driver import cent_sgd
from shapley_vit_tpu_torch.models import zoo as tzoo
from shapley_vit_tpu_torch.models.convert import flax_zoo_to_state_dict, state_dict_to_flax_zoo
from torch_one_thread import one_torch_thread  # noqa: F401


def _jax_step(module, optimizer, has_bn):
    """``shapley_vit_tpu.driver.cent_sgd``'s train step (cent_sgd.py:95-118)."""

    def loss_fn(params, rest, x, y):
        v = {**rest, "params": params}
        if has_bn:
            logits, mut = module.apply(v, x, train=True, mutable=["batch_stats"])
            new_stats = mut["batch_stats"]
        else:
            logits, new_stats = module.apply(v, x, train=True), None
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=-1)[:, 0]), new_stats

    @jax.jit
    def step(params, rest, opt_state, x, y):
        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, rest, x, y)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        if new_stats is not None:
            rest = {**rest, "batch_stats": new_stats}
        return params, rest, opt_state, loss

    return step


@pytest.mark.parametrize("name", ["ConvNetBN", "MLP"])
def test_train_steps_match_jax(name):
    lr, wd = 0.05, 1e-3
    module = jzoo.build_network(name, 3, 10, (16, 16))
    variables = jax.device_get(jax.jit(lambda k: module.init(k, jnp.zeros((1, 16, 16, 3)),
                                                             train=False))(jax.random.key(0)))
    optimizer = optax.chain(optax.add_decayed_weights(wd), optax.sgd(lr, momentum=0.9))
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}
    opt_state = optimizer.init(params)
    jstep = _jax_step(module, optimizer, "batch_stats" in rest)

    net = tzoo.build_network(name, 3, 10, (16, 16))
    net.load_state_dict(flax_zoo_to_state_dict(variables), strict=True)
    tstep = cent_sgd.make_train_step(net, cent_sgd.make_optimizer(net, lr, wd))

    rng = np.random.default_rng(0)
    for _ in range(3):
        x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
        y = rng.integers(0, 10, size=8)
        params, rest, opt_state, jloss = jstep(params, rest, opt_state, x, y)
        tloss = tstep(torch.tensor(x), torch.tensor(y))
        assert abs(float(tloss) - float(jloss)) <= 1e-5
        got = state_dict_to_flax_zoo(net.state_dict())
        want = jax.device_get({"params": params, **rest})
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_cent_sgd_end_to_end(tmp_path):
    """Mini run: MLP on synthetic MNIST, 1 experiment, 2 epochs, on the CPU."""
    args = cent_sgd.argparser().parse_args([
        "--dataset", "mnist", "--model", "MLP", "--num_exp", "1",
        "--epoch_train", "2", "--batch_train", "64", "--lr", "0.05",
        "--save_root", str(tmp_path / "result"), "--save_curves", "--device", "cpu",
    ])
    args = cent_sgd.set_path(args)
    summary = cent_sgd.main(args)
    assert 0.0 <= summary["acc_mean"] <= 1.0 and summary["train_s"] > 0
    epochs = summary["epoch_train_s"]
    assert len(epochs) == 1 and len(epochs[0]) == 2
    assert summary["train_s"] == pytest.approx(sum(epochs[0]))
    out = args.save_path
    for f in ("summary.json", "curves.npz", "checkpoint_exp0.npz", "acc.png", "loss.png",
              "auc.png", "config.json", "exp_log.log"):
        assert os.path.exists(os.path.join(out, f)), f
    ckpt = np.load(os.path.join(out, "checkpoint_exp0.npz"))
    assert {"params.Dense_0.kernel", "params.Dense_2.bias", "__epoch__"} <= set(ckpt.files)
    assert ckpt["params.Dense_0.kernel"].shape == (28 * 28, 128)  # flax's [in, out]
    curves = np.load(os.path.join(out, "curves.npz"))
    assert sorted(curves.files) == ["acc_0", "auc_0", "loss_0"] and len(curves["acc_0"]) == 2
    # exp_seq.txt bookkeeping increments (cent_sgd.py:46-63)
    with open(os.path.join(str(tmp_path / "result"), "exp_seq.txt")) as f:
        assert f.read() == "0"
    args2 = cent_sgd.set_path(cent_sgd.argparser().parse_args(
        ["--save_root", str(tmp_path / "result")]))
    assert args2.exp_seq == "1" and args2.device == "cuda"
