"""The port's LoRA training path against ``shapley_vit_tpu.fl.training`` at
float32 on the CPU.

Weights come from the JAX package's ``init_vit``/``init_lora`` with a
non-zero LoRA B (so every leaf has a gradient) and carry over through numpy.
The JAX side trains through its Pallas ``fused_attention`` under the
interpreter (``attention_impl="pallas"``, ``SVT_PALLAS_INTERPRET=1``) with the
XLA MLP: the training spec on both sides. Tolerances: logits 2e-5 (the
house parity bar); one to three SGD steps 1e-5; Adam 2e-4 (Adam divides by
the root of the second moment, which magnifies the float32 rounding of
small gradients); the DP step at zero noise 1e-5.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from shapley_vit_tpu.data import partition as jpart
from shapley_vit_tpu.fl import training as jtr
from shapley_vit_tpu.models import vit as jvit
from shapley_vit_tpu_torch.data import partition as tpart
from shapley_vit_tpu_torch.fl import training as ttr
from shapley_vit_tpu_torch.models import vit as tvit
from shapley_vit_tpu_torch.models.convert import tree_from_numpy, tree_to_numpy
from shapley_vit_tpu_torch.ops import attention as tatt
from shapley_vit_tpu_torch.ops.tree_math import tree_leaves
from torch_one_thread import one_torch_thread  # noqa: F401

TRAIN = dict(attention_impl="pallas", mlp_impl="xla")


def _setup(seed=0, batch=6):
    spec_j = jvit.make_spec("micro", **TRAIN)
    spec_t = tvit.make_spec("micro", **TRAIN)
    base = jax.device_get(jvit.init_vit(jax.random.key(seed), spec_j))
    lora = jax.device_get(jvit.init_lora(jax.random.key(seed + 1), spec_j, classifier_from=base))
    rng = np.random.default_rng(seed)
    lora = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
                        lora)
    images = rng.normal(size=(batch, spec_j.image, spec_j.image, 3)).astype(np.float32)
    labels = rng.integers(0, spec_j.num_classes, size=batch).astype(np.int32)
    return spec_j, spec_t, base, lora, images, labels


def _assert_trees_close(got, want, atol):
    for g, w in zip(tree_leaves(tree_to_numpy(got)), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=0)


@pytest.mark.parametrize("remat", [False, True])
def test_training_spec_forward_matches_jax(remat, monkeypatch):
    monkeypatch.setenv("SVT_PALLAS_INTERPRET", "1")
    spec_j, spec_t, base, lora, images, _ = _setup()
    spec_j, spec_t = spec_j.replace(remat=remat), spec_t.replace(remat=remat)
    want = np.asarray(jvit.vit_forward(base, lora, images, spec_j))
    tl = ttr.trainable(tree_from_numpy(lora))
    got = tvit.vit_forward(tree_from_numpy(base), tl, torch.tensor(images), spec_t)
    assert got.requires_grad and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5, rtol=0)


def test_remat_recomputes_attention_in_the_backward():
    """remat runs each block's forward again in the backward: under it the
    gradients are the same and every block's attention runs twice. (Here
    the plain version runs, so the count is of calls, not launches.)"""
    _, spec_t, base, lora, images, labels = _setup(seed=2)
    calls = []
    orig = tatt._FusedAttention.forward

    def counting(ctx, q, k, v):
        calls.append(1)
        return orig(ctx, q, k, v)

    grads = []
    for remat in (False, True):
        spec = spec_t.replace(remat=remat)
        tl = ttr.trainable(tree_from_numpy(lora))
        calls.clear()
        tatt._FusedAttention.forward = staticmethod(counting)
        try:
            loss = ttr.cross_entropy(
                tvit.vit_forward(tree_from_numpy(base), tl, torch.tensor(images), spec),
                torch.tensor(labels))
            loss.backward()
        finally:
            tatt._FusedAttention.forward = staticmethod(orig)
        assert len(calls) == spec.depth * (2 if remat else 1)
        grads.append([t.grad.clone() for t in tree_leaves(tl)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0)


def test_only_the_training_spec_trains():
    """The forward-only kernels (the default spec's) refuse a forward that
    autograd would need their gradient through; the training spec gives
    every leaf a gradient. Without grad the default spec runs as before."""
    _, spec_t, base, lora, images, labels = _setup(seed=1)
    tb, x, y = tree_from_numpy(base), torch.tensor(images), torch.tensor(labels)
    for bad in (dict(), dict(mlp_impl="xla"), dict(attention_impl="pallas", mlp_impl="pallas")):
        spec = tvit.make_spec("micro", **bad)
        with pytest.raises(RuntimeError, match="forward only"):
            ttr.cross_entropy(tvit.vit_forward(tb, ttr.trainable(tree_from_numpy(lora)), x, spec),
                              y).backward()
        with torch.no_grad():
            tvit.vit_forward(tb, tree_from_numpy(lora), x, spec)
    tl = ttr.trainable(tree_from_numpy(lora))
    ttr.cross_entropy(tvit.vit_forward(tb, tl, x, spec_t), y).backward()
    for t in tree_leaves(tl):
        assert t.grad is not None and float(t.grad.abs().max()) > 0
    with pytest.raises(ValueError, match="attention_impl"):
        spec_t.replace(attention_impl="xla")
    with pytest.raises(ValueError, match="mlp_impl"):
        spec_t.replace(mlp_impl="triton")


@pytest.mark.parametrize("n_parties,beta", [(3, 0.5), (5, 1.0)])
def test_partition_labeldir_matches_jax(n_parties, beta):
    labels = np.random.default_rng(0).integers(0, 4, size=400)
    dj, mj = jpart.partition_labeldir(labels, num_classes=4, n_parties=n_parties, beta=beta, seed=42)
    dt, mt = tpart.partition_labeldir(labels, num_classes=4, n_parties=n_parties, beta=beta, seed=42)
    np.testing.assert_array_equal(dt, dj)
    assert mt == mj


@pytest.mark.parametrize("opt_name,lr,atol", [("sgd", 0.5, 1e-5), ("adam", 5e-3, 2e-4)])
def test_train_steps_match_jax(opt_name, lr, atol, monkeypatch):
    monkeypatch.setenv("SVT_PALLAS_INTERPRET", "1")
    spec_j, spec_t, base, lora, images, labels = _setup(seed=3)
    jopt = getattr(optax, opt_name)(lr)
    jstep = jtr.make_train_step(lambda b, lo, x: jvit.vit_forward(b, lo, x, spec_j), jopt,
                                spec_j.num_classes)
    tstep = ttr.make_train_step(lambda b, lo, x: tvit.vit_forward(b, lo, x, spec_t),
                                spec_t.num_classes)
    jl, jstate = lora, jopt.init(lora)
    tb = tree_from_numpy(base)
    tl = ttr.trainable(tree_from_numpy(lora))
    tstate = getattr(ttr, opt_name)(lr).init(tl)
    x, y = torch.tensor(images), torch.tensor(labels)
    for n in range(3):
        jl, jstate, jloss = jstep(base, jl, jstate, images, labels, jax.random.key(n))
        tl, tstate, tloss = tstep(tb, tl, tstate, x, y)
        assert abs(float(tloss) - float(jloss)) < atol
        if n in (0, 2):  # after one step and after three
            _assert_trees_close(tl, jl, atol)
    moved = max(float(np.abs(np.asarray(a) - b).max())
                for a, b in zip(jax.tree.leaves(jl), jax.tree.leaves(lora)))
    assert moved > 20 * atol  # the steps really moved the overlay


def test_dp_step_at_zero_noise_matches_jax():
    spec_j, spec_t, base, lora, images, labels = _setup(seed=4, batch=4)
    spec_j = spec_j.replace(attention_impl="xla")  # the same function; vmap-friendly
    # a clip below the examples' gradient norms, so the clipping is exercised
    kw = dict(learning_rate=0.5, l2_norm_clip=0.05, noise_multiplier=0.0, seed=0)
    jstep, jopt = jtr.make_dp_train_step(lambda b, lo, x: jvit.vit_forward(b, lo, x, spec_j),
                                         num_classes=4, **kw)
    tstep, topt = ttr.make_dp_train_step(lambda b, lo, x: tvit.vit_forward(b, lo, x, spec_t), **kw)
    jl, _, jloss = jstep(base, lora, jopt.init(lora), images, labels)
    tl = ttr.trainable(tree_from_numpy(lora))
    tl, _, tloss = tstep(tree_from_numpy(base), tl, topt.init(tl), torch.tensor(images),
                         torch.tensor(labels))
    assert abs(float(tloss) - float(jloss)) < 1e-5
    _assert_trees_close(tl, jl, 1e-5)


def test_dp_noise_has_the_configured_std():
    """noise_multiplier > 0 adds N(0, (clip·multiplier)²) to the clipped sum
    before the division by the batch: the difference from the noiseless
    step, rescaled, is standard normal over the overlay's ~4k entries."""
    _, spec_t, base, lora, images, labels = _setup(seed=5, batch=3)
    fwd = lambda b, lo, x: tvit.vit_forward(b, lo, x, spec_t)  # noqa: E731
    tb, x, y = tree_from_numpy(base), torch.tensor(images), torch.tensor(labels)
    lr, clip, sigma = 0.1, 0.5, 2.0
    out = []
    for mult in (0.0, sigma):
        step, opt = ttr.make_dp_train_step(fwd, lr, clip, mult, seed=7)
        tl = ttr.trainable(tree_from_numpy(lora))
        out.append(torch.cat([t.detach().flatten() for t in tree_leaves(step(tb, tl, opt.init(tl), x, y)[0])]))
    z = (out[1] - out[0]) * len(labels) / (-lr * clip * sigma)
    assert z.numel() > 4000
    assert abs(float(z.mean())) < 0.05 and abs(float(z.std()) - 1.0) < 0.05
    # a refreshed generator gives another noise stream, the same seed the same one
    step, opt = ttr.make_dp_train_step(fwd, lr, clip, sigma, seed=7)
    draws = []
    for refresh in (None, 7, 8):
        tl = ttr.trainable(tree_from_numpy(lora))
        state = opt.init(tl)
        if refresh is not None:
            state = ttr.refresh_dp_noise_key(state, refresh)
        draws.append(torch.cat([t.detach().flatten() for t in tree_leaves(step(tb, tl, state, x, y)[0])]))
    torch.testing.assert_close(draws[0], draws[1], atol=0, rtol=0)
    assert float((draws[2] - draws[0]).abs().max()) > 1e-3


def test_label_flip_semantics():
    labels = torch.arange(1000) % 4
    gen = torch.Generator().manual_seed(0)
    assert ttr.label_flip(gen, labels, 4, 0.0) is labels
    flipped = ttr.label_flip(gen, labels, 4, 1.0)
    assert flipped.dtype == labels.dtype and int(flipped.min()) >= 0 and int(flipped.max()) <= 3
    assert 0.6 < float((flipped != labels).float().mean()) < 0.9  # 3/4 land on another class
    half = [ttr.label_flip(torch.Generator().manual_seed(3), labels, 4, 0.5) for _ in range(2)]
    assert torch.equal(half[0], half[1])
    assert 0.3 < float((half[0] != labels).float().mean()) < 0.45  # ~0.5 · 3/4
    with pytest.raises(ValueError):
        ttr.label_flip(None, labels, 4, 0.5)


def test_local_training_logs_each_epoch_and_checks_its_leaves():
    _, spec_t, base, lora, images, labels = _setup(seed=6)
    step = ttr.make_train_step(lambda b, lo, x: tvit.vit_forward(b, lo, x, spec_t),
                               spec_t.num_classes, label_flip_prob=0.3)
    opt = ttr.adam(5e-3)
    with pytest.raises(ValueError, match="trainable"):
        opt.init(tree_from_numpy(lora))
    tl = ttr.trainable(tree_from_numpy(lora))
    batches = [(torch.tensor(images[:3]), torch.tensor(labels[:3])),
               (torch.tensor(images[3:]), torch.tensor(labels[3:]))]
    logged = []
    tl, _ = ttr.local_training(step, tree_from_numpy(base), tl, opt.init(tl), 2, lambda: batches,
                               torch.Generator().manual_seed(0),
                               lambda e, loss: logged.append((e, loss)))
    assert [e for e, _ in logged] == [0, 1] and all(np.isfinite(v) for _, v in logged)
    assert float((tl["lora"]["q"]["B"].detach() - torch.tensor(lora["lora"]["q"]["B"])).abs().max()) > 1e-3
