"""The port's representation metrics (``utils/representation.py``) against
``shapley_vit_tpu.utils.representation`` on the same float32 inputs, rtol
1e-6: linear and kernel CKA (a given sigma, and the automatic one at an
even count of nonzero distances, where ``torch.median``'s lower middle
matters), the sliced Wasserstein distance with JAX's projections passed in,
the IRM loss; NaN from both where JAX gives NaN; the TF32 guard; and the
shape and norm of drawn projections."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapley_vit_tpu.utils import representation as jrep
from shapley_vit_tpu_torch.utils import representation as trep
from torch_one_thread import one_torch_thread  # noqa: F401

RTOL = 1e-6


def _pair(seed=0, n=16, d=24, e=20):
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(size=(n, d)) + 0.2, 0).astype(np.float32)
    y = (np.tanh(x @ rng.normal(size=(d, e))) + 0.1 * rng.normal(size=(n, e))).astype(np.float32)
    return x, y


def _close(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_linear_cka_matches_jax(seed):
    x, y = _pair(seed)
    _close(trep.linear_cka(torch.tensor(x), torch.tensor(y)), jrep.linear_cka(x, y))
    _close(trep.linear_cka(torch.tensor(x), torch.tensor(x)), 1.0)


@pytest.mark.parametrize("sigma", [2.0, 5.5, None])
def test_kernel_cka_matches_jax(sigma):
    x, y = _pair(2, n=8)  # 56 nonzero distances: the automatic sigma takes the lower middle
    dist = ((x[:, None] - x[None]) ** 2).sum(-1)
    assert np.count_nonzero(dist) % 2 == 0
    _close(trep.kernel_cka(torch.tensor(x), torch.tensor(y), sigma),
           jrep.kernel_cka(x, y, sigma))
    np.testing.assert_allclose(trep._rbf(torch.tensor(x), sigma).numpy(),
                               np.asarray(jrep._rbf(x, sigma)), rtol=RTOL, atol=1e-7)


def test_sliced_wasserstein_matches_jax_with_its_projections():
    x, y = _pair(3, n=32, d=16, e=16)
    proj = np.asarray(jrep.rand_projections(jax.random.key(4), 16, 50))
    want = jrep.sliced_wasserstein_distance(x, y, projections=proj)
    _close(trep.sliced_wasserstein_distance(torch.tensor(x), torch.tensor(y),
                                            projections=torch.tensor(proj)), want)
    _close(trep.sliced_wasserstein_distance(torch.tensor(x), torch.tensor(y), p=1,
                                            projections=torch.tensor(proj)),
           jrep.sliced_wasserstein_distance(x, y, p=1, projections=proj))


def test_irm_loss_matches_jax():
    rng = np.random.default_rng(5)
    t = np.asarray(jax.nn.softmax(rng.normal(size=(12, 10)).astype(np.float32)))
    s = np.asarray(jax.nn.softmax(rng.normal(size=(12, 10)).astype(np.float32)))
    _close(trep.get_irm_loss(torch.tensor(t), torch.tensor(s)), jrep.get_irm_loss(t, s))
    _close(trep.kl_div_batchmean(torch.log(torch.tensor(s)), torch.tensor(t)),
           jrep.kl_div_batchmean(jnp.log(s), t))


def test_nan_where_jax_gives_nan():
    same = np.tile(np.arange(6, dtype=np.float32), (5, 1))  # every distance 0
    assert np.isnan(float(jrep.kernel_cka(same, same)))
    assert np.isnan(float(trep.kernel_cka(torch.tensor(same), torch.tensor(same))))
    p = np.array([[0.0, 0.5, 0.5], [0.2, 0.3, 0.5]], np.float32)
    q = np.full((2, 3), 1 / 3, np.float32)
    assert np.isnan(float(jrep.kl_div_batchmean(jnp.log(q), p)))
    assert np.isnan(float(trep.kl_div_batchmean(torch.log(torch.tensor(q)), torch.tensor(p))))


def test_tf32_guard_restores_the_callers_setting(monkeypatch):
    seen = []
    real_mm = torch.Tensor.__matmul__

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real_mm(a, b)

    x, y = _pair(6)
    before = torch.backends.cuda.matmul.allow_tf32
    for caller in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = caller
        try:
            monkeypatch.setattr(torch.Tensor, "__matmul__", spy)
            trep.linear_cka(torch.tensor(x), torch.tensor(y))
            trep.kernel_cka(torch.tensor(x), torch.tensor(y))
            trep.sliced_wasserstein_distance(torch.tensor(x), torch.tensor(x))
            monkeypatch.undo()
            assert torch.backends.cuda.matmul.allow_tf32 is caller
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before
    assert seen and not any(seen)  # every product ran with TF32 off


def test_rand_projections_are_unit_rows():
    p = trep.rand_projections(torch.Generator().manual_seed(3), 40, 7)
    assert p.shape == (7, 40) and p.dtype == torch.float32
    np.testing.assert_allclose(torch.linalg.norm(p, dim=1).numpy(), 1.0, rtol=1e-6)
    again = trep.rand_projections(None, 40, 7)
    assert torch.equal(again, trep.rand_projections(torch.Generator().manual_seed(0), 40, 7))
