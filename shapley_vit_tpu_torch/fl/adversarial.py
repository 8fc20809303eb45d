"""Adversarial evaluation: the capability behind the reference's
``--epsilon`` / ``--is-defense`` / ``--use-clean-eval`` /
``--use-multi-epsilon`` flags (opts.py:74-81).

The port of ``shapley_vit_tpu/fl/adversarial.py``:

  * FGSM / PGD attack generation against any ``forward_fn(params, x)``;
  * clean vs. adversarial evaluation, optionally through a defense
    transform (the Inception ``Denoise`` front-end, ``models/inception.py``),
    with the multi-epsilon sweep.

What changed in the port: gradients are ``torch.autograd.grad`` on a leaf
copy of the images, outside inference mode (a tensor made under
``torch.inference_mode`` cannot enter a graph, so inference tensors among
the images or the parameters are cloned first). The forward must have a
gradient: for the ViT, ``spec.replace(attention_impl="pallas",
mlp_impl="xla")`` (``driver.client.TRAIN_SPEC``), whose patch embedding and
``[B, H, N, d]`` attention run the kernels forward and torch ops backward.
Where JAX takes a PRNG key, the port takes a seed or a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from shapley_vit_tpu_torch.fl.evaluation import eval_step_metrics
from shapley_vit_tpu_torch.ops.tree_math import graph_ready, tree_map

Key = Union[int, torch.Generator]


def _ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy in float32."""
    return F.cross_entropy(logits.float(), labels.long())


def _input_grad(forward_fn: Callable, params, x: torch.Tensor, labels: torch.Tensor):
    """∇ₓ of the mean cross-entropy, in x's dtype."""
    with torch.inference_mode(False), torch.enable_grad():
        x = x.detach().clone().requires_grad_(True)
        (g,) = torch.autograd.grad(_ce_loss(forward_fn(params, x), labels), x)
    return g


def fgsm(
    forward_fn: Callable, params, images: torch.Tensor, labels: torch.Tensor,
    epsilon: float, clip: Tuple[float, float] = (0.0, 1.0),
) -> torch.Tensor:
    """Fast Gradient Sign Method: x' = clip(x + ε·sign(∇ₓ CE))."""
    grad = _input_grad(forward_fn, params, images, labels)
    return torch.clamp(images + epsilon * torch.sign(grad), *clip)


def _uniform_start(images: torch.Tensor, epsilon: float, key: Key) -> torch.Tensor:
    """U(-ε, ε) noise of the images' shape, drawn from ``key``: a seed (a
    generator on the images' device) or a generator, used as it stands."""
    if isinstance(key, torch.Generator):
        gen = key
    else:
        gen = torch.Generator(device=images.device).manual_seed(int(key))
    u = torch.rand(images.shape, generator=gen, device=gen.device).to(images.device)
    return (u * (2 * epsilon) - epsilon).to(images.dtype)


def pgd(
    forward_fn: Callable, params, images: torch.Tensor, labels: torch.Tensor,
    epsilon: float, step_size: Optional[float] = None, steps: int = 10,
    clip: Tuple[float, float] = (0.0, 1.0), key: Optional[Key] = None,
) -> torch.Tensor:
    """Projected Gradient Descent within the ε-ball, from a random start in
    it when ``key`` is given (a seed or a ``torch.Generator``)."""
    step_size = step_size if step_size is not None else 2.5 * epsilon / steps
    x = images + _uniform_start(images, epsilon, key) if key is not None else images
    lo, hi = images - epsilon, images + epsilon
    for _ in range(steps):
        grad = _input_grad(forward_fn, params, x, labels)
        x = x + step_size * torch.sign(grad)
        x = torch.clamp(torch.clamp(x, lo, hi), *clip)
    return x


def adversarial_evaluation(
    forward_fn: Callable,
    params,
    batches,
    epsilon: float,
    attack: str = "fgsm",
    defense_fn: Optional[Callable] = None,
    use_clean_eval: bool = True,
    pgd_steps: int = 10,
    key: Optional[Key] = None,
) -> Dict[str, float]:
    """Evaluate clean and/or adversarial accuracy+loss, optionally through a
    defense transform (the ``is_defense`` path: x -> defense_fn(x) -> model).
    The attack and the evaluation use the same forward. ``batches`` yields
    (images, labels) as tensors on the forward's device (or numpy arrays
    for a CPU forward).

    PGD's random start (``key``) is the same noise for every batch, as in
    the JAX package, whose jitted attack captures one key: a generator's
    state is restored, or a seed's generator made anew, before each batch.

    Returns {'clean_acc','clean_loss','adv_acc','adv_loss'} (clean keys only
    when ``use_clean_eval``).
    """
    if attack not in ("fgsm", "pgd"):
        raise ValueError(f"unknown attack {attack!r}")
    params = tree_map(graph_ready, params)
    defended = (
        forward_fn if defense_fn is None
        else (lambda p, x: forward_fn(p, defense_fn(x)))
    )
    key_state = key.get_state() if isinstance(key, torch.Generator) else None

    def gen(images, labels):
        if attack == "fgsm":
            return fgsm(defended, params, images, labels, epsilon)
        if key_state is not None:
            key.set_state(key_state)
        return pgd(defended, params, images, labels, epsilon, steps=pgd_steps, key=key)

    def step(images, labels):
        with torch.inference_mode():
            c, l = eval_step_metrics(defended(params, images), labels)
        return float(c), float(l)

    clean_c = clean_l = adv_c = adv_l = 0.0
    n = 0
    for images, labels in batches:
        images = graph_ready(torch.as_tensor(images))
        labels = torch.as_tensor(labels, device=images.device)
        if use_clean_eval:
            c, l = step(images, labels)
            clean_c += c
            clean_l += l
        adv = gen(images, labels) if epsilon > 0 else images
        c, l = step(adv, labels)
        adv_c += c
        adv_l += l
        n += len(labels)
    out = {"adv_acc": adv_c / n, "adv_loss": adv_l / n}
    if use_clean_eval:
        out.update({"clean_acc": clean_c / n, "clean_loss": clean_l / n})
    return out


def multi_epsilon_evaluation(
    forward_fn: Callable, params, batches, epsilons: Sequence[float], **kw
) -> Dict[float, Dict[str, float]]:
    """The ``--use-multi-epsilon`` sweep (opts.py:81). Clean metrics are
    evaluated once (on the first epsilon): they don't depend on epsilon."""
    clean = kw.pop("use_clean_eval", True)
    results = {}
    for i, eps in enumerate(epsilons):
        results[float(eps)] = adversarial_evaluation(
            forward_fn, params, batches, eps,
            use_clean_eval=clean and i == 0, **kw,
        )
    return results
