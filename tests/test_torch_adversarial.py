"""The port's adversarial evaluation (``fl/adversarial.py``) against
``shapley_vit_tpu.fl.adversarial`` at float32 on the CPU.

The ViT cases run a micro ViT with a LoRA overlay whose weights come from the
JAX package's initializers (carried over as numpy). The JAX side runs its
default differentiable forward (XLA attention and MLP); the port's runs the
training spec (``attention_impl="pallas"``, ``mlp_impl="xla"``), whose patch
embedding and attention differentiate through torch ops. Tolerances: the
image gradient within 1e-5 of its largest magnitude (float32 sums in
another order); adversarial images equal wherever |g| > 1e-4·max|g|, where
the sign of the gradient cannot flip on rounding, and those components at
least 99 % of all (PGD: at every step); the metrics within 1e-5. The JAX package's own linear-model cases
(tests/test_adversarial_rounds.py) run through both packages as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapley_vit_tpu.fl import adversarial as jadv
from shapley_vit_tpu.models import vit as jvit
from shapley_vit_tpu_torch.fl import adversarial as tadv
from shapley_vit_tpu_torch.models import vit as tvit
from shapley_vit_tpu_torch.models.convert import tree_from_numpy
from shapley_vit_tpu_torch.ops.tree_math import tree_map

TRAIN = dict(attention_impl="pallas", mlp_impl="xla")
EPS = 8 / 255


@pytest.fixture(scope="module")
def vit():
    spec_j = jvit.make_spec("micro")
    spec_t = tvit.make_spec("micro", **TRAIN)
    base = jax.device_get(jvit.init_vit(jax.random.key(0), spec_j))
    lora = jax.device_get(jvit.init_lora(jax.random.key(1), spec_j, classifier_from=base))
    rng = np.random.default_rng(0)
    lora = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
                        lora)
    images = rng.uniform(size=(8, spec_j.image, spec_j.image, 3)).astype(np.float32)
    labels = rng.integers(0, spec_j.num_classes, size=8).astype(np.int32)
    tbase = tree_from_numpy(base)
    return dict(
        lora=lora, tlora=tree_from_numpy(lora), images=images, labels=labels,
        jf=lambda p, x: jvit.vit_forward(base, p, x, spec_j),
        tf=lambda p, x: tvit.vit_forward(tbase, p, x, spec_t),
        batches=[(images[:4], labels[:4]), (images[4:], labels[4:])],
    )


def _jax_grad(v):
    return np.asarray(jax.grad(lambda x: jadv._ce_loss(v["jf"](v["lora"], x), v["labels"]))(
        v["images"]))


def test_fgsm_gradient_and_images_match_jax(vit):
    want = _jax_grad(vit)
    x, y = torch.tensor(vit["images"]), torch.tensor(vit["labels"])
    got = tadv._input_grad(vit["tf"], vit["tlora"], x, y).numpy()
    scale = float(np.abs(want).max())
    assert scale > 1e-6
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)

    adv_j = np.asarray(jadv.fgsm(vit["jf"], vit["lora"], vit["images"], vit["labels"], EPS))
    adv_t = tadv.fgsm(vit["tf"], vit["tlora"], x, y, EPS).numpy()
    sure = np.abs(want) > 1e-4 * scale
    np.testing.assert_array_equal(adv_t[sure], adv_j[sure])
    # the rest (2 of 6144 components here) may flip on rounding: at most a
    # hundredth of all components may be unsure or differ
    assert (~sure).sum() + (adv_t[~sure] != adv_j[~sure]).sum() <= sure.size // 100
    assert np.abs(adv_t - vit["images"]).max() <= EPS + 1e-6
    assert adv_t.min() >= 0.0 and adv_t.max() <= 1.0


def test_pgd_without_random_start_matches_jax(vit):
    steps = 4
    x, y = torch.tensor(vit["images"]), torch.tensor(vit["labels"])
    want = np.asarray(jadv.pgd(vit["jf"], vit["lora"], vit["images"], vit["labels"], EPS,
                               steps=steps))
    got = tadv.pgd(vit["tf"], vit["tlora"], x, y, EPS, steps=steps).numpy()
    # JAX's iterates again, step by step: where every step's gradient is
    # clear of rounding (|g| > 1e-4·max|g|) no sign can flip, and the two
    # packages must agree to the bit; that is nearly every component
    step = 2.5 * EPS / steps
    images = jnp.asarray(vit["images"])
    xs, clear = images, np.ones(want.shape, bool)
    for _ in range(steps):
        g = np.asarray(jax.grad(lambda z: jadv._ce_loss(vit["jf"](vit["lora"], z),
                                                         vit["labels"]))(xs))
        clear &= np.abs(g) > 1e-4 * np.abs(g).max()
        xs = jnp.clip(jnp.clip(xs + step * jnp.sign(g), images - EPS, images + EPS), 0.0, 1.0)
    np.testing.assert_array_equal(np.asarray(xs), want)
    np.testing.assert_array_equal(got[clear], want[clear])
    assert clear.mean() >= 0.99
    assert np.abs(got - vit["images"]).max() <= EPS + 1e-6
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_pgd_random_start_is_seeded_and_the_same_for_every_batch(vit):
    x, y = torch.tensor(vit["images"][:4]), torch.tensor(vit["labels"][:4])
    a = tadv.pgd(vit["tf"], vit["tlora"], x, y, EPS, steps=2, key=3)
    b = tadv.pgd(vit["tf"], vit["tlora"], x, y, EPS, steps=2, key=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert (a - x).abs().max() <= EPS + 1e-6 and a.min() >= 0 and a.max() <= 1
    # JAX captures one key for every batch: two equal batches get equal starts
    gen = torch.Generator().manual_seed(9)
    twice = [(x, y), (x, y)]
    seen = []
    wrapped = (lambda p, imgs: seen.append(imgs.detach().clone()) or vit["tf"](p, imgs))
    tadv.adversarial_evaluation(wrapped, vit["tlora"], twice, EPS, attack="pgd", pgd_steps=1,
                                use_clean_eval=False, key=gen)
    # per batch: the attack's one forward, then the evaluation's
    torch.testing.assert_close(seen[0], seen[2], atol=0, rtol=0)
    assert not torch.equal(seen[0], x)


def _defense_j(x):
    return jnp.clip(0.9 * x + 0.05, 0.0, 1.0)


def _defense_t(x):
    return torch.clamp(0.9 * x + 0.05, 0.0, 1.0)


@pytest.mark.parametrize("case", [
    dict(),
    dict(attack="pgd", pgd_steps=3),
    dict(defense=True),
    dict(use_clean_eval=False),
    dict(epsilon=0.0),
])
def test_adversarial_evaluation_matches_jax(vit, case):
    case = dict(case)
    eps = case.pop("epsilon", EPS)
    defended = case.pop("defense", False)
    want = jadv.adversarial_evaluation(vit["jf"], vit["lora"], vit["batches"], eps,
                                       defense_fn=_defense_j if defended else None, **case)
    got = tadv.adversarial_evaluation(vit["tf"], vit["tlora"], vit["batches"], eps,
                                      defense_fn=_defense_t if defended else None, **case)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
    if eps == 0.0:
        assert got["adv_acc"] == got["clean_acc"] and got["adv_loss"] == got["clean_loss"]


def test_multi_epsilon_evaluation_matches_jax(vit):
    eps = [0.0, 2 / 255, EPS]
    want = jadv.multi_epsilon_evaluation(vit["jf"], vit["lora"], vit["batches"], eps)
    got = tadv.multi_epsilon_evaluation(vit["tf"], vit["tlora"], vit["batches"], eps)
    assert list(got) == list(want) == [float(e) for e in eps]
    for e in want:
        assert set(got[e]) == set(want[e])
        assert ("clean_acc" in got[e]) == (e == 0.0)  # clean metrics at the first epsilon only
        for k in want[e]:
            assert abs(got[e][k] - want[e][k]) <= 1e-5, (e, k)


@pytest.mark.parametrize("attack", ["deepfool", "cw"])
def test_unknown_attack_raises(vit, attack):
    with pytest.raises(ValueError, match="unknown attack"):
        tadv.adversarial_evaluation(vit["tf"], vit["tlora"], vit["batches"], 0.1, attack=attack)


def test_inference_tensors_are_attacked_outside_inference_mode(vit):
    """A caller's images and parameters made under ``torch.inference_mode``
    (the port's evaluation mode) still get an attack, and the same one."""
    with torch.inference_mode():
        x, y = torch.tensor(vit["images"]), torch.tensor(vit["labels"])
        lora = tree_map(torch.clone, vit["tlora"])
    assert x.is_inference() and lora["classifier"]["kernel"].is_inference()
    want = tadv.adversarial_evaluation(vit["tf"], vit["tlora"], vit["batches"], EPS)
    got = tadv.adversarial_evaluation(vit["tf"], lora, [(x[:4], y[:4]), (x[4:], y[4:])], EPS)
    assert got == want


# -- the JAX package's linear-model cases (tests/test_adversarial_rounds.py:20-75) --

def _linear(params, x):  # jax or torch arrays alike
    return x.reshape(x.shape[0], -1) @ params["w"] + params["b"]


@pytest.fixture
def trained_linear():
    rng = np.random.default_rng(0)
    n = 200
    X = rng.normal(size=(n, 2, 2, 1)).astype(np.float32) * 0.1
    y = rng.integers(0, 2, n).astype(np.int32)
    X[:, 0, 0, 0] += y  # feature 0 carries the label
    w = np.zeros((4, 2), np.float32)
    w[0, 1], w[0, 0] = 4.0, -4.0
    b = np.array([2.0, -2.0], np.float32)
    return ({"w": jnp.asarray(w), "b": jnp.asarray(b)},
            {"w": torch.tensor(w), "b": torch.tensor(b)}, [(X, y)])


def _both(trained_linear, *args, **kw):
    pj, pt, batches = trained_linear
    return (jadv.adversarial_evaluation(_linear, pj, batches, *args, **kw),
            tadv.adversarial_evaluation(_linear, pt, batches, *args, **kw))


def _close(got, want):
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])


@pytest.mark.parametrize("case", ["fgsm_reduces_accuracy", "pgd_at_least_as_strong",
                                  "defense_hook", "multi_epsilon_sweep"])
def test_linear_model_cases_match_jax(trained_linear, case):
    if case == "fgsm_reduces_accuracy":
        want, got = _both(trained_linear, 0.5)
        _close(got, want)
        assert got["clean_acc"] > 0.8 and got["adv_acc"] < got["clean_acc"]
        assert got["adv_loss"] > got["clean_loss"]
    elif case == "pgd_at_least_as_strong":
        fj, ft = _both(trained_linear, 0.3, attack="fgsm")
        pj, pt = _both(trained_linear, 0.3, attack="pgd", pgd_steps=10)
        _close(ft, fj)
        _close(pt, pj)
        assert pt["adv_acc"] <= ft["adv_acc"] + 0.05
    elif case == "defense_hook":
        want, got = _both(trained_linear, 0.2, defense_fn=lambda x: x * 1.0)
        _close(got, want)
    else:
        pj, pt, batches = trained_linear
        want = jadv.multi_epsilon_evaluation(_linear, pj, batches, epsilons=[0.1, 0.5])
        got = tadv.multi_epsilon_evaluation(_linear, pt, batches, epsilons=[0.1, 0.5])
        assert set(got) == {0.1, 0.5}
        for e in want:
            _close(got[e], want[e])
        assert got[0.5]["adv_acc"] <= got[0.1]["adv_acc"] + 1e-9
