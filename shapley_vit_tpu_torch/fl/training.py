"""Local client training: the port of ``shapley_vit_tpu/fl/training.py``.

Reference ``ClientBase.local_training`` (client.py:44-76): per-epoch
optimisation of the LoRA overlay and the classifier over the client's
shard, the base frozen, with an optional label-flipping poisoning attack
(client.py:53-59, probability ``label_flip_prob``).

What changed in the port:

* The JAX step is a pure function of ``(lora, opt_state)``. Here the
  overlay's leaves are trainable leaf tensors (:func:`trainable`) and the
  optimizer state is a ``torch.optim`` optimizer over them: a step updates
  them in place and returns the same tree and state, so the training loop
  reads as the JAX one does; ``make_train_step`` takes no optimizer, since
  the state it is handed is the optimizer. :func:`adam` and :func:`sgd`
  stand for ``optax.adam`` and ``optax.sgd``; with the settings below
  ``torch.optim.Adam`` and ``torch.optim.SGD`` compute the same update
  (bias-corrected moments, eps outside the square root; momentum as a trace).
* ``jax.random`` keys become explicit ``torch.Generator``s. The two draw
  different numbers from one seed: label flips and DP noise are held to
  their distributions, not to JAX's streams.
* The DP step loops over the examples for their gradients (the JAX step
  ``vmap``s them): ``torch.func`` transforms do not pass through a kernel
  called by ``ctypes``.
* ``make_train_step`` has no ``remat`` switch: the JAX one checkpoints the
  whole forward, which ``ViTSpec.remat`` (per block, set from
  ``cfg.train.remat`` by the client) covers for the ViT.
* ``make_multi_client_train_step`` (all clients in one program) comes with
  the multi-GPU slice.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from shapley_vit_tpu_torch.ops.tree_math import tree_leaves, tree_map

Tree = Any
ForwardFn = Callable[[Tree, Tree, torch.Tensor], torch.Tensor]


def trainable(lora: Tree) -> Tree:
    """A copy of the overlay whose leaves are leaf tensors that require
    grad: what :meth:`Optimizer.init` and the steps take."""
    return tree_map(lambda a: a.detach().clone().requires_grad_(True), lora)


@dataclass(frozen=True)
class Optimizer:
    """optax-style handle: ``init(lora)`` returns the optimizer state, a
    ``torch.optim`` optimizer over the overlay's leaves."""

    make: Callable[[List[torch.Tensor]], torch.optim.Optimizer]

    def init(self, lora: Tree) -> torch.optim.Optimizer:
        leaves = tree_leaves(lora)
        if not all(t.is_leaf and t.requires_grad for t in leaves):
            raise ValueError("the overlay's leaves must be trainable leaf tensors: pass trainable(lora)")
        return self.make(leaves)


def adam(learning_rate: float) -> Optimizer:
    """``optax.adam(learning_rate)``: b1 0.9, b2 0.999, eps 1e-8."""
    return Optimizer(functools.partial(torch.optim.Adam, lr=learning_rate,
                                       betas=(0.9, 0.999), eps=1e-8))


def sgd(learning_rate: float, momentum: Optional[float] = None) -> Optimizer:
    """``optax.sgd(learning_rate, momentum)``."""
    return Optimizer(functools.partial(torch.optim.SGD, lr=learning_rate,
                                       momentum=momentum or 0.0))


def label_flip(generator: Optional[torch.Generator], labels: torch.Tensor, num_classes: int,
               flip_prob: float) -> torch.Tensor:
    """Label-flipping attack fixture (reference client.py:53-59): with
    probability ``flip_prob`` each label is replaced by a uniformly random
    class. Draws from ``generator`` (on its device)."""
    if flip_prob <= 0.0:
        return labels
    if generator is None:
        raise ValueError("label_flip with flip_prob > 0 needs a torch.Generator")
    dev = generator.device
    flip = torch.rand(labels.shape, generator=generator, device=dev) < flip_prob
    rand_labels = torch.randint(0, num_classes, labels.shape, generator=generator, device=dev)
    return torch.where(flip.to(labels.device), rand_labels.to(labels.device, labels.dtype), labels)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy on float32 logits (reference client.py:64-69)."""
    return F.cross_entropy(logits.float(), labels.long())


def make_train_step(forward_fn: ForwardFn, num_classes: int, label_flip_prob: float = 0.0):
    """The LoRA train step. ``forward_fn(base, lora, images) -> logits``.
    Returns ``step(base, lora, opt_state, images, labels, generator) ->
    (lora, opt_state, loss)``: labels flipped with ``generator``, mean
    cross-entropy, backward, one optimizer update of the overlay in place.
    Rematerialization is the model's (``ViTSpec.remat``, per block), not
    the step's."""

    def step(base, lora, opt_state, images, labels, generator=None):
        labels = label_flip(generator, labels, num_classes, label_flip_prob)
        opt_state.zero_grad(set_to_none=True)
        loss = cross_entropy(forward_fn(base, lora, images), labels)
        loss.backward()
        opt_state.step()
        return lora, opt_state, loss.detach()

    return step


@dataclass
class DPState:
    """The DP step's optimizer state: SGD over the overlay and the noise
    generator (optax's ``DifferentiallyPrivateAggregateState`` key)."""

    optimizer: torch.optim.Optimizer
    generator: torch.Generator


def _noise_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


@dataclass(frozen=True)
class DPOptimizer:
    """``init(lora)`` gives a :class:`DPState` whose noise generator, on the
    overlay's device, is seeded with ``seed``."""

    sgd: Optimizer
    seed: int

    def init(self, lora: Tree) -> DPState:
        return DPState(self.sgd.init(lora), _noise_generator(self.seed, tree_leaves(lora)[0].device))


def make_dp_train_step(forward_fn: ForwardFn, learning_rate: float, l2_norm_clip: float,
                       noise_multiplier: float, seed: int, momentum: float = 0.0):
    """Differentially-private LoRA train step (DP-SGD; the reference's
    ``--noise-multiplier`` flag, opts.py:87). optax's
    ``differentially_private_aggregate`` followed by SGD: each example's
    gradient is scaled to a global L2 norm of at most ``l2_norm_clip``, the
    scaled gradients are summed, Gaussian noise of std
    ``l2_norm_clip·noise_multiplier`` is added to each leaf of the sum, and
    the result is divided by the batch size. Returns ``(step, optimizer)``
    with ``step(base, lora, opt_state, images, labels) -> (lora, opt_state,
    mean loss)`` and ``optimizer`` a :class:`DPOptimizer`. The DP step flips
    no labels itself."""
    noise_std = l2_norm_clip * noise_multiplier

    def step(base, lora, opt_state: DPState, images, labels):
        leaves = tree_leaves(lora)
        clipped_sum = [torch.zeros_like(p) for p in leaves]
        losses = []
        for i in range(len(labels)):
            loss = cross_entropy(forward_fn(base, lora, images[i:i + 1]), labels[i:i + 1])
            grads = torch.autograd.grad(loss, leaves)
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
            mult = torch.nan_to_num(torch.clamp(l2_norm_clip / norm, max=1.0), nan=1.0)
            for acc, g in zip(clipped_sum, grads):
                acc.add_(g * mult)
            losses.append(loss.detach())
        gen = opt_state.generator
        for p, acc in zip(leaves, clipped_sum):
            noise = torch.randn(p.shape, generator=gen, device=gen.device, dtype=p.dtype)
            p.grad = (acc + noise_std * noise.to(p.device)) / len(labels)
        opt_state.optimizer.step()
        return lora, opt_state, torch.stack(losses).mean()

    return step, DPOptimizer(sgd(learning_rate, momentum=momentum or None), seed)


def refresh_dp_noise_key(opt_state: DPState, seed: int) -> DPState:
    """A DP state whose noise generator is freshly seeded with ``seed``.

    ``optimizer.init`` seeds the noise generator with the seed the step was
    built with, so a caller that re-inits the state (adopting a new global
    each FL round) would replay the same noise; an observer differencing
    two rounds' checkpoints with equal step counts would cancel it and void
    the DP guarantee. Call this after every re-init with a fresh seed."""
    return DPState(opt_state.optimizer,
                   _noise_generator(seed, opt_state.generator.device))


def local_training(step, base: Tree, lora: Tree, opt_state, epochs: int,
                   batches_fn: Callable[[], Any], generator: Optional[torch.Generator] = None,
                   log_fn: Optional[Callable[[int, float], None]] = None) -> Tuple[Tree, Any]:
    """Epoch loop (client.py:44-76): ``epochs`` passes over the client's
    batches, logging each epoch's mean loss."""
    for epoch in range(epochs):
        total, count = 0.0, 0
        for images, labels in batches_fn():
            lora, opt_state, loss = step(base, lora, opt_state, images, labels, generator)
            total += float(loss)
            count += 1
        if log_fn is not None:
            log_fn(epoch, total / max(count, 1))
    return lora, opt_state
