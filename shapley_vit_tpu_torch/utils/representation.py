"""Representation-similarity metrics: CKA, sliced Wasserstein distance, IRM
KL regularizer (the port of ``shapley_vit_tpu/utils/representation.py``).

Reference: ``federated_learning/utils.py:1134-1242`` (``CKA_Torch`` with
linear and RBF-kernel HSIC, ``sliced_wasserstein_distance`` with L2-normalized
random projections, ``get_irm_loss`` symmetric-ish KL). Plain functions on
tensors, on the tensors' device.

What the port keeps of the JAX module:

* every matrix product is a full float32 one, as JAX's ``precision="highest"``
  (CKA's centred Gram matrices cancel most of their magnitude, and TF32's
  ten-bit mantissa leaves about 1e-3 of the result): each product runs under
  :func:`full_float32_products`, which turns TF32 off for
  ``torch.backends.cuda.matmul`` and gives the caller's setting back after;
* ``_rbf``'s automatic sigma is the lower middle of the nonzero squared
  distances (``torch.median``'s choice); when every distance is 0 it is NaN,
  and so is the kernel, as in JAX;
* ``kl_div_batchmean`` is the plain formula, NaN where ``p`` is 0 (as JAX;
  ``F.kl_div`` would give 0 there);
* random directions come from an explicit ``torch.Generator`` (seed 0 by
  default, as JAX's default ``key(0)``); ``projections=`` overrides the draw.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch


@contextlib.contextmanager
def full_float32_products():
    """Full float32 matrix products inside (TF32 off for
    ``torch.backends.cuda.matmul``); the caller's setting is restored on
    exit. Also a decorator."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# CKA (utils.py:1140-1180)
# ---------------------------------------------------------------------------

@full_float32_products()
def _centering(K: torch.Tensor) -> torch.Tensor:
    n = K.shape[0]
    H = torch.eye(n, dtype=K.dtype, device=K.device) - torch.ones((n, n), dtype=K.dtype,
                                                                    device=K.device) / n
    return H @ K @ H


@full_float32_products()
def _rbf(X: torch.Tensor, sigma: Optional[float] = None) -> torch.Tensor:
    GX = X @ X.T
    KX = torch.diag(GX)[:, None] - GX
    KX = KX + KX.T
    if sigma is None:
        # torch.median's choice, the LOWER of the two middle elements of the
        # nonzero entries; the zeros become NaN, which sorts last, and no
        # nonzero entry at all indexes a NaN (as JAX does)
        flat = KX.reshape(-1)
        nz = torch.where(flat != 0, flat, torch.full_like(flat, math.nan))
        idx = torch.clamp((flat != 0).sum() - 1, min=0) // 2
        mdist = torch.sort(nz).values.gather(0, idx.reshape(1))[0]
        sigma = torch.sqrt(mdist)
    return torch.exp(KX * (-0.5 / (sigma * sigma)))


@full_float32_products()
def linear_hsic(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    return torch.sum(_centering(X @ X.T) * _centering(Y @ Y.T))


def kernel_hsic(X: torch.Tensor, Y: torch.Tensor, sigma: Optional[float] = None) -> torch.Tensor:
    return torch.sum(_centering(_rbf(X, sigma)) * _centering(_rbf(Y, sigma)))


def linear_cka(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Linear CKA(X, Y) in [0, 1]; 1 iff the representations are linearly
    equivalent (utils.py:1169-1174)."""
    hsic = linear_hsic(X, Y)
    return hsic / (torch.sqrt(linear_hsic(X, X)) * torch.sqrt(linear_hsic(Y, Y)))


def kernel_cka(X: torch.Tensor, Y: torch.Tensor, sigma: Optional[float] = None) -> torch.Tensor:
    hsic = kernel_hsic(X, Y, sigma)
    return hsic / (torch.sqrt(kernel_hsic(X, X, sigma)) * torch.sqrt(kernel_hsic(Y, Y, sigma)))


# ---------------------------------------------------------------------------
# sliced Wasserstein (utils.py:1182-1242)
# ---------------------------------------------------------------------------

def rand_projections(generator: Optional[torch.Generator], embedding_dim: int,
                     num_samples: int = 50) -> torch.Tensor:
    """L2-normalized Gaussian directions ``[num_samples, embedding_dim]``,
    drawn from ``generator`` on its device (seed 0 on the CPU when None)."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    w = torch.randn((num_samples, embedding_dim), generator=generator, device=generator.device)
    return w / torch.linalg.norm(w, dim=1, keepdim=True)


@full_float32_products()
def sliced_wasserstein_distance(
    encoded_samples: torch.Tensor,
    distribution_samples: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    num_projections: int = 50,
    p: int = 2,
    projections: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean SWD between two sample sets (utils.py:1198-1242): project both on
    random directions, sort per projection, mean ``|Δ|^p``. ``projections``
    overrides the drawn directions."""
    dim = distribution_samples.shape[1]
    proj = (torch.as_tensor(projections) if projections is not None
            else rand_projections(generator, dim, num_projections))
    proj = proj.to(encoded_samples.device, encoded_samples.dtype)
    ep = torch.sort((encoded_samples @ proj.T).T, dim=1).values
    dp = torch.sort((distribution_samples @ proj.T).T, dim=1).values
    return torch.mean(torch.abs(ep - dp) ** p)


# ---------------------------------------------------------------------------
# IRM KL loss (utils.py:1134-1138)
# ---------------------------------------------------------------------------

def kl_div_batchmean(log_q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``Σ p·(log p − log q) / B``: torch's ``F.kl_div(log_q, p,
    reduction='batchmean')`` except where p is 0 (NaN here, as in JAX)."""
    return torch.sum(p * (torch.log(p) - log_q)) / p.shape[0]


def get_irm_loss(target_mat: torch.Tensor, src_mat: torch.Tensor) -> torch.Tensor:
    """Inter-client relationship matching loss (utils.py:1134-1138):
    (KL(p_target‖q_src) + KL(p_target‖q_target)) / 2 with the reference's
    exact argument wiring (the second term is 0 by construction)."""
    return (kl_div_batchmean(torch.log(src_mat), target_mat)
            + kl_div_batchmean(torch.log(target_mat), target_mat)) / 2.0
