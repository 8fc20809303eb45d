"""The port's multi-client LoRA step, on one device and sharded over the
``(coalition, data)`` mesh, at float32 on the CPU.

* ``fl.training.make_multi_client_train_step`` against the JAX package's
  (a ``vmap`` of the single-client step) on micro with the training spec,
  2 and 4 clients, 3 steps, with ``sgd(1e-2, momentum=0.9)`` (1e-5) and
  ``adam`` (2e-4: Adam divides by the root of the second moment, which
  magnifies the float32 rounding of small gradients), and one step with
  ``ViTSpec.remat`` against JAX's ``remat=True`` (1e-5). The JAX side runs
  its Pallas attention under the interpreter, as in
  ``tests/test_torch_training.py``.
* ``parallel.client_train``'s sharded step against the single-device step
  on CPU grids of 1×1, 2×2, 1×4 and 4×1 (a device may repeat in a port
  mesh): losses and overlays within 1e-6 after 3 steps (the data-axis
  split only reorders the gradient's sums); the refusal of a client count
  or a batch that an axis does not divide; label flips that one seed makes
  the same on a grid as on one device, at a rate near ``p``.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from shapley_vit_tpu.fl import training as jtr
from shapley_vit_tpu.models import vit as jvit
from shapley_vit_tpu.ops import tree_math as jtm
from shapley_vit_tpu_torch.fl import training as ttr
from shapley_vit_tpu_torch.models import vit as tvit
from shapley_vit_tpu_torch.models.convert import tree_from_numpy, tree_to_numpy
from shapley_vit_tpu_torch.ops.tree_math import tree_leaves
from shapley_vit_tpu_torch.parallel import mesh as tmesh
from shapley_vit_tpu_torch.parallel.client_train import make_sharded_multi_client_train_step
from torch_one_thread import one_torch_thread  # noqa: F401

TRAIN = dict(attention_impl="pallas", mlp_impl="xla")


def _setup(n_clients, batch, seed=0):
    spec_j = jvit.make_spec("micro", **TRAIN)
    spec_t = tvit.make_spec("micro", **TRAIN)
    base = jax.device_get(jvit.init_vit(jax.random.key(seed), spec_j))
    lora = jax.device_get(jvit.init_lora(jax.random.key(seed + 1), spec_j, classifier_from=base))
    rng = np.random.default_rng(seed)
    loras = [jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape)
                          .astype(np.float32), lora) for _ in range(n_clients)]
    stacked = jax.device_get(jtm.tree_stack(loras))
    images = rng.normal(size=(n_clients, batch, spec_j.image, spec_j.image, 3)).astype(np.float32)
    labels = rng.integers(0, spec_j.num_classes, size=(n_clients, batch)).astype(np.int32)
    return spec_j, spec_t, base, stacked, images, labels


def _port_step(spec_t, opt, label_flip_prob=0.0):
    return ttr.make_multi_client_train_step(lambda b, lo, x: tvit.vit_forward(b, lo, x, spec_t),
                                            opt, spec_t.num_classes, label_flip_prob)


@pytest.mark.parametrize("n_clients", [2, 4])
@pytest.mark.parametrize("opt_name,atol", [("sgd", 1e-5), ("adam", 2e-4)])
def test_multi_client_steps_match_jax(n_clients, opt_name, atol, monkeypatch):
    monkeypatch.setenv("SVT_PALLAS_INTERPRET", "1")
    spec_j, spec_t, base, stacked, images, labels = _setup(n_clients, batch=4, seed=n_clients)
    jopt = optax.sgd(1e-2, momentum=0.9) if opt_name == "sgd" else optax.adam(5e-3)
    topt = ttr.sgd(1e-2, momentum=0.9) if opt_name == "sgd" else ttr.adam(5e-3)
    jstep = jtr.make_multi_client_train_step(lambda b, lo, x: jvit.vit_forward(b, lo, x, spec_j),
                                             jopt, spec_j.num_classes)
    keys = jax.random.split(jax.random.key(7), n_clients)
    jl, jstate = stacked, jax.vmap(jopt.init)(stacked)
    tstep = _port_step(spec_t, topt)
    tb = tree_from_numpy(base)
    tl = ttr.trainable(tree_from_numpy(stacked))
    tstate = topt.init(tl)
    x, y = torch.tensor(images), torch.tensor(labels)
    for _ in range(3):
        jl, jstate, jloss = jstep(base, jl, jstate, images, labels, keys)
        tl, tstate, tloss = tstep(tb, tl, tstate, x, y)
        assert tloss.shape == (n_clients,)
        np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), atol=atol, rtol=0)
    for g, w in zip(tree_leaves(tree_to_numpy(tl)), jax.tree.leaves(jl)):
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=0)


def test_multi_client_remat_step_matches_jax(monkeypatch):
    monkeypatch.setenv("SVT_PALLAS_INTERPRET", "1")
    spec_j, spec_t, base, stacked, images, labels = _setup(2, batch=4, seed=5)
    jopt = optax.sgd(1e-2, momentum=0.9)
    jstep = jtr.make_multi_client_train_step(lambda b, lo, x: jvit.vit_forward(b, lo, x, spec_j),
                                             jopt, spec_j.num_classes, remat=True)
    jl, _, jloss = jstep(base, stacked, jax.vmap(jopt.init)(stacked), images, labels,
                         jax.random.split(jax.random.key(0), 2))
    topt = ttr.sgd(1e-2, momentum=0.9)
    tl = ttr.trainable(tree_from_numpy(stacked))
    tl, _, tloss = _port_step(spec_t.replace(remat=True), topt)(
        tree_from_numpy(base), tl, topt.init(tl), torch.tensor(images), torch.tensor(labels))
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), atol=1e-5, rtol=0)
    for g, w in zip(tree_leaves(tree_to_numpy(tl)), jax.tree.leaves(jl)):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0)


def test_multi_client_step_refuses_a_non_elementwise_optimizer():
    _, spec_t, *_ = _setup(2, batch=2)
    _, dp = ttr.make_dp_train_step(lambda b, lo, x: x, 1e-2, 1.0, 1.0, seed=0)
    with pytest.raises(TypeError, match="elementwise"):
        _port_step(spec_t, dp)


def _single_and_grid(spec_t, base, stacked, images, labels, grid, opt, steps=3, p=0.0):
    """``steps`` of the single-device step and of the sharded one over
    ``grid`` (n_coalition, n_data) of the CPU, from the same overlays."""
    fwd = lambda b, lo, x: tvit.vit_forward(b, lo, x, spec_t)
    n = labels.shape[0]
    tb = tree_from_numpy(base)
    single = ttr.make_multi_client_train_step(fwd, opt, spec_t.num_classes, p)
    tl = ttr.trainable(tree_from_numpy(stacked))
    state = opt.init(tl)
    mesh = tmesh.make_mesh(grid[0], grid[1], ["cpu"] * (grid[0] * grid[1]))
    sharded = make_sharded_multi_client_train_step(fwd, opt, spec_t.num_classes, mesh, p)
    clients = sharded.init(stacked)
    gens = [[torch.Generator().manual_seed(100 + i) for i in range(n)] for _ in range(2)]
    x, y = torch.tensor(images), torch.tensor(labels)
    for _ in range(steps):
        tl, state, want = single(tb, tl, state, x, y, gens[0] if p else None)
        clients, got = sharded(tb, clients, images, labels, gens[1] if p else None)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    return tl, clients


@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (1, 4), (4, 1)])
def test_sharded_step_matches_the_single_device_step(grid):
    _, spec_t, base, stacked, images, labels = _setup(4, batch=8, seed=11)
    tl, clients = _single_and_grid(spec_t, base, stacked, images, labels, grid,
                                   ttr.sgd(1e-2, momentum=0.9))
    for g, w in zip(tree_leaves(clients.stacked()), tree_leaves(tl)):
        np.testing.assert_allclose(g.numpy(), w.detach().numpy(), atol=1e-6, rtol=0)
    # every cell of a row holds the same overlay
    for (c, d), lora in clients.lora.items():
        for a, b in zip(tree_leaves(lora), tree_leaves(clients.lora[(c, 0)])):
            torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert sum(float((a.detach() - torch.as_tensor(np.asarray(b))).abs().sum())
               for a, b in zip(tree_leaves(tl), jax.tree.leaves(stacked))) > 0


def test_sharded_adam_step_matches_the_single_device_step():
    _, spec_t, base, stacked, images, labels = _setup(2, batch=4, seed=12)
    tl, clients = _single_and_grid(spec_t, base, stacked, images, labels, (2, 2),
                                   ttr.adam(5e-3), steps=2)
    for g, w in zip(tree_leaves(clients.stacked()), tree_leaves(tl)):
        np.testing.assert_allclose(g.numpy(), w.detach().numpy(), atol=1e-6, rtol=0)


def test_sharded_step_refuses_indivisible_clients_and_batches():
    _, spec_t, base, stacked, images, labels = _setup(3, batch=6, seed=13)
    fwd = lambda b, lo, x: tvit.vit_forward(b, lo, x, spec_t)
    opt = ttr.sgd(1e-2)
    step = make_sharded_multi_client_train_step(fwd, opt, spec_t.num_classes,
                                                tmesh.make_mesh(2, 1, ["cpu"] * 2))
    with pytest.raises(ValueError, match="coalition axis of size 2"):
        step.init(stacked)
    step = make_sharded_multi_client_train_step(fwd, opt, spec_t.num_classes,
                                                tmesh.make_mesh(1, 4, ["cpu"] * 4))
    clients = step.init(stacked)
    with pytest.raises(ValueError, match="batch 6 does not split over the data axis of size 4"):
        step(tree_from_numpy(base), clients, images, labels)
    with pytest.raises(TypeError, match="elementwise"):
        make_sharded_multi_client_train_step(fwd, ttr.make_dp_train_step(fwd, 1e-2, 1.0, 1.0, 0)[1],
                                             spec_t.num_classes, tmesh.make_mesh(1, 1, ["cpu"]))


def test_label_flips_are_the_same_on_a_grid_and_near_p():
    _, spec_t, base, stacked, images, labels = _setup(2, batch=8, seed=14)
    tl, clients = _single_and_grid(spec_t, base, stacked, images, labels, (2, 2),
                                   ttr.sgd(1e-2, momentum=0.9), steps=2, p=0.5)
    for g, w in zip(tree_leaves(clients.stacked()), tree_leaves(tl)):
        np.testing.assert_allclose(g.numpy(), w.detach().numpy(), atol=1e-6, rtol=0)
    # the flip rate: a label is redrawn with probability p, uniformly over
    # the classes (so it changes with probability p (K - 1) / K)
    y = torch.zeros(20000, dtype=torch.long)
    flipped = ttr.label_flip(torch.Generator().manual_seed(3), y, 4, 0.5)
    changed = float((flipped != y).float().mean())
    assert abs(changed - 0.5 * 3 / 4) < 0.02
