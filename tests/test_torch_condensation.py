"""The port's condensation suite (``data/condensation.py``) against
``shapley_vit_tpu.data.condensation`` on the CPU, float32.

* ``distance_wb`` for each rank and ``match_loss`` in its three metrics on
  the same gradients (flax layouts on the JAX side, torch layouts on the
  port's), within 1e-5;
* each DiffAugment transform from JAX's draws (replayed from JAX's keys),
  values and the gradient in x within 1e-5, per sample and siamese; the
  port's siamese draws; modes S, M and none;
* ``augment`` bit-identical from one ``default_rng`` seed, ``get_daparam``
  and every ``get_eval_pool`` key;
* ``run_epoch`` (train, eval) and ``run_epoch_data_weight`` on the MLP and a
  depth-2 ConvNet at 16 px from JAX's weights: losses, accuracies and
  parameters within 1e-5 (SGD) and 2e-4 (Adam);
* one gradient-matching step on the depth-2 ConvNet: the synthetic images'
  gradient against JAX's second-order ``jax.grad`` within 1e-4;
* ConvNetLN: the port groups LayerNorm's ``[C, H, W]`` gradient by C, as
  the reference does; JAX's ``match_loss`` on its own ``[H, W, C]`` tree
  groups by H (logged in ROADMAP §3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shapley_vit_tpu.data import condensation as jcond
from shapley_vit_tpu.data.arrays import ArrayDataset as JArrayDataset
from shapley_vit_tpu.models import zoo as jzoo
from shapley_vit_tpu_torch.data import condensation as tcond
from shapley_vit_tpu_torch.data.arrays import ArrayDataset
from shapley_vit_tpu_torch.fl import training as tr
from shapley_vit_tpu_torch.models import zoo as tzoo
from shapley_vit_tpu_torch.models.convert import flax_zoo_to_state_dict
from torch_one_thread import one_torch_thread  # noqa: F401


def _t(a):
    return torch.tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# gradient matching
# ---------------------------------------------------------------------------

# (flax leaf shape, flax -> torch permutation)
_LEAVES = {"conv": ((3, 3, 4, 6), (3, 2, 0, 1)), "ln": ((6, 5, 5), None),
           "dense": ((12, 7), (1, 0)), "bias": ((7,), None)}


def _grad_pair(seed):
    rng = np.random.default_rng(seed)
    real, syn = {}, {}
    for name, (shape, _) in _LEAVES.items():
        real[name] = rng.normal(size=shape).astype(np.float32)
        syn[name] = (0.5 * real[name] + rng.normal(size=shape)).astype(np.float32)
    return real, syn


def _torch_layout(tree):
    return {k: _t(v.transpose(_LEAVES[k][1]) if _LEAVES[k][1] else v) for k, v in tree.items()}


@pytest.mark.parametrize("name", list(_LEAVES))
def test_distance_wb_matches_jax_for_each_rank(name):
    real, syn = _grad_pair(1)
    want = float(jcond.distance_wb(real[name], syn[name]))
    got = float(tcond.distance_wb(_torch_layout(real)[name], _torch_layout(syn)[name]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (want == 0.0) == (name == "bias")


@pytest.mark.parametrize("metric", ["ours", "mse", "cos"])
def test_match_loss_matches_jax(metric):
    real, syn = _grad_pair(2)
    want = float(jcond.match_loss(syn, real, metric))
    got = float(tcond.match_loss(_torch_layout(syn), _torch_layout(real), metric))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with pytest.raises(ValueError):
        tcond.match_loss(_torch_layout(syn), _torch_layout(real), "l1")


# ---------------------------------------------------------------------------
# DiffAugment from JAX's draws
# ---------------------------------------------------------------------------

PARAM = jcond.ParamDiffAug()
TPARAM = tcond.ParamDiffAug()


def _jax_draws(name, key, B, hw):
    """The values JAX's ``rand_<name>`` draws from ``key``, before its
    siamese broadcast (condensation.py:155-243)."""
    H, W = hw
    u = lambda k, shape=(B,): jax.random.uniform(k, shape)  # noqa: E731
    if name == "scale":
        r = PARAM.ratio_scale
        k1, k2 = jax.random.split(key)
        return u(k1) * (r - 1.0 / r) + 1.0 / r, u(k2) * (r - 1.0 / r) + 1.0 / r
    if name == "rotate":
        return ((u(key) - 0.5) * 2 * PARAM.ratio_rotate / 180 * jnp.pi,)
    if name in ("flip", "brightness", "saturation", "contrast"):
        return (u(key, (B, 1, 1, 1)),)
    k1, k2 = jax.random.split(key)
    if name == "crop":
        sy, sx = int(H * PARAM.ratio_crop_pad + 0.5), int(W * PARAM.ratio_crop_pad + 0.5)
        return (jax.random.randint(k1, (B, 1, 1), -sy, sy + 1),
                jax.random.randint(k2, (B, 1, 1), -sx, sx + 1))
    ch, cw = int(H * PARAM.ratio_cutout + 0.5), int(W * PARAM.ratio_cutout + 0.5)
    return (jax.random.randint(k1, (B, 1, 1), 0, H + (1 - ch % 2)),
            jax.random.randint(k2, (B, 1, 1), 0, W + (1 - cw % 2)))


@pytest.mark.parametrize("siamese", [False, True])
@pytest.mark.parametrize("name", list(tcond.TRANSFORMS))
def test_transform_matches_jax_from_its_draws(name, siamese):
    B, H, W = 6, 12, 10
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    w = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    key = jax.random.key(11)
    jfn = getattr(jcond, f"rand_{name}")
    want = np.asarray(jfn(x, key, PARAM, siamese))
    want_g = np.asarray(jax.grad(lambda a: jnp.sum(jfn(a, key, PARAM, siamese) * w))(x))

    draws = [_t(d).reshape(-1) for d in _jax_draws(name, key, B, (H, W))]
    if siamese:
        draws = [d[:1] for d in draws]
    xt = _t(x).requires_grad_(True)
    got = tcond.TRANSFORMS[name][1](xt, *draws, TPARAM)
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", list(tcond.TRANSFORMS))
def test_siamese_draws_are_one_for_the_batch(name):
    same = np.repeat(np.random.default_rng(4).normal(size=(1, 8, 8, 3)), 5, 0).astype(np.float32)
    rand = getattr(tcond, f"rand_{name}")
    out = rand(_t(same), torch.Generator().manual_seed(9), TPARAM, siamese=True)
    assert all(torch.equal(out[0], out[i]) for i in range(1, 5))
    # a batch of another size gets the same transform from the same seed
    small = rand(_t(same[:2]), torch.Generator().manual_seed(9), TPARAM, siamese=True)
    assert torch.equal(small[0], out[0])


def test_modes_s_m_and_none():
    x = _t(np.random.default_rng(5).normal(size=(4, 8, 8, 3)).astype(np.float32))
    assert tcond.diff_augment(x, "none") is x and tcond.diff_augment(x, "") is x
    strategy = "flip_crop_color"
    m = tcond.diff_augment(x, strategy, torch.Generator().manual_seed(2),
                           tcond.ParamDiffAug(aug_mode="M"))
    g, want = torch.Generator().manual_seed(2), x
    for f in [tcond.rand_flip, tcond.rand_crop] + tcond.AUGMENT_FNS["color"]:
        want = f(want, g, TPARAM)
    assert torch.equal(m, want)
    g = torch.Generator().manual_seed(7)
    s = tcond.diff_augment(x, strategy, torch.Generator().manual_seed(7))
    part = strategy.split("_")[int(torch.randint(0, 3, (), generator=g))]
    want = x
    for f in tcond.AUGMENT_FNS[part]:
        want = f(want, g, TPARAM)
    assert torch.equal(s, want)
    with pytest.raises(ValueError):
        tcond.diff_augment(x, "flip", param=tcond.ParamDiffAug(aug_mode="Q"))


def test_augment_bit_identical_to_jax():
    x = np.random.default_rng(6).random((12, 16, 16, 3)).astype(np.float32)
    p = {"crop": 4, "scale": 0.2, "rotate": 45, "noise": 0.001,
         "strategy": "crop_scale_rotate_noise"}
    want = jcond.augment(x, p, np.random.default_rng(8))
    got = tcond.augment(x, p, np.random.default_rng(8))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert tcond.augment(x, None) is x and tcond.augment(x, {"strategy": "none"}) is x


@pytest.mark.parametrize("args", [("MNIST", "ConvNet", "ConvNet", 10),
                                  ("CIFAR10", "ConvNet", "ConvNetBN", 1),
                                  ("CIFAR10", "ConvNet", "ConvNet", 50)])
def test_get_daparam(args):
    assert tcond.get_daparam(*args) == jcond.get_daparam(*args)


@pytest.mark.parametrize("mode", ["M", "B", "W", "D", "A", "P", "N", "S", "SS", "other"])
def test_get_eval_pool(mode):
    for model in ("ConvNet", "ConvNetBN"):
        assert tcond.get_eval_pool(mode, model, "LeNet") == jcond.get_eval_pool(mode, model, "LeNet")


# ---------------------------------------------------------------------------
# train loops from JAX's weights
# ---------------------------------------------------------------------------

def _networks(name, size=16, seed=0):
    """JAX's module and variables (init compiled whole) and the port's
    apply_fn with those variables carried over."""
    module = jzoo.build_network(name, 3, 10, (size, size))
    variables = jax.device_get(jax.jit(lambda k: module.init(
        k, jnp.zeros((1, size, size, 3)), train=False))(jax.random.key(seed)))
    _, _, apply_fn = tzoo.get_network(name, 3, 10, (size, size), device="cpu")
    return module, variables, apply_fn, flax_zoo_to_state_dict(variables)


def _data(n=40, size=16, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, size, size, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32), rng.integers(0, 3, n).astype(np.int32))


def _assert_tree_close(port_sd, jax_vars, atol, skip=()):
    want = flax_zoo_to_state_dict(jax.device_get(jax_vars))
    assert set(port_sd) == set(want)
    for k in sorted(set(want) - set(skip)):
        np.testing.assert_allclose(port_sd[k].detach().numpy(), want[k].numpy(), atol=atol,
                                   rtol=0, err_msg=k)


OPTIMIZERS = {"sgd": (lambda: optax.sgd(0.01, momentum=0.9), lambda: tr.sgd(0.01, 0.9), 1e-5),
              "adam": (lambda: optax.adam(1e-3), lambda: tr.adam(1e-3), 2e-4)}


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
@pytest.mark.parametrize("name", ["MLP", "ConvNetD2"])
def test_run_epoch_matches_jax(name, opt):
    module, jvars, apply_fn, sd = _networks(name)
    x, y, _ = _data()
    japply = lambda v, a: module.apply(v, a, train=False)  # noqa: E731
    make_j, make_t, atol = OPTIMIZERS[opt]
    jopt = make_j()
    jl, ja, jv, _ = jcond.run_epoch("train", JArrayDataset(x, y), japply, jvars, jopt,
                                    jopt.init(jvars["params"]), batch_size=16)
    tv = tcond.trainable_variables(sd)
    topt = make_t()
    tl, ta, tv, _ = tcond.run_epoch("train", ArrayDataset(x, y), apply_fn, tv,
                                    topt.init(tcond.parameters(tv)), batch_size=16)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert ta == ja
    # a convolution's bias ahead of the instance norm has a gradient of 0 in
    # exact arithmetic: Adam divides both packages' rounding noise there by
    # its own root mean square, so those leaves move by ±lr on either side
    # in no common direction (SGD moves them by ~1e-9, and is held on them).
    # Left out only after JAX's gradient there is shown to be rounding noise
    skip = [k for k in sd if k.startswith("Conv_") and k.endswith("bias")] if opt == "adam" else []
    if skip:
        jgrad = flax_zoo_to_state_dict(jax.device_get({"params": jax.grad(
            lambda p: -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(
                module.apply({**jvars, "params": p}, x, train=False)), y[:, None], 1))
        )(jvars["params"])}))
        for k in skip:
            assert float(np.abs(jgrad[k].numpy()).max()) < 1e-6, k
    _assert_tree_close(tv, jv, atol, skip)
    jl, ja, _, _ = jcond.run_epoch("eval", JArrayDataset(x, y), japply, jv, batch_size=16)
    tl, ta, _, _ = tcond.run_epoch("eval", ArrayDataset(x, y), apply_fn, tv, batch_size=16)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert ta == ja


@pytest.mark.parametrize("weighted", [True, False])
def test_run_epoch_data_weight_matches_jax(weighted):
    module, jvars, apply_fn, sd = _networks("ConvNetD2")
    x, y, src = _data()
    dw = np.random.default_rng(2).random((10, 3)).astype(np.float32) if weighted else None
    japply = lambda v, a: module.apply(v, a, train=False)  # noqa: E731
    jopt = optax.sgd(0.01, momentum=0.9)
    jl, ja, jv, _ = jcond.run_epoch_data_weight(jcond.SynDataset(x, y, src), japply, jvars, jopt,
                                                jopt.init(jvars["params"]), dw, batch_size=16)
    tv = tcond.trainable_variables(sd)
    topt = tr.sgd(0.01, 0.9)
    syn = tcond.SynDataset(x, y, src)
    assert len(syn) == 40 and len(syn.as_array_dataset()) == 40
    tl, ta, tv, _ = tcond.run_epoch_data_weight(syn, apply_fn, tv,
                                                topt.init(tcond.parameters(tv)), dw, batch_size=16)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert ta == ja
    _assert_tree_close(tv, jv, 1e-5)


def test_gradient_matching_step_matches_jax_second_order():
    module, jvars, apply_fn, sd = _networks("ConvNetD2")
    rng = np.random.default_rng(3)
    classes, n_real, ipc = 2, 6, 2
    real = rng.normal(size=(classes, n_real, 16, 16, 3)).astype(np.float32)
    syn = rng.normal(size=(classes, ipc, 16, 16, 3)).astype(np.float32)
    sx = np.array([1.1], np.float32)

    def jloss(params, xb, c):
        logits = module.apply({"params": params}, xb, train=False)
        return -jnp.mean(jax.nn.log_softmax(logits)[:, c])

    def jtotal(s):
        total = 0.0
        for c in range(classes):
            aug_r = jcond._affine_sample(real[c], jnp.asarray([[[sx[0], 0, 0], [0, 0.9, 0]]]).repeat(n_real, 0))
            aug_s = jcond._affine_sample(s[c], jnp.asarray([[[sx[0], 0, 0], [0, 0.9, 0]]]).repeat(ipc, 0))
            gw_real = jax.lax.stop_gradient(jax.grad(jloss)(jvars["params"], aug_r, c))
            gw_syn = jax.grad(jloss)(jvars["params"], aug_s, c)
            total = total + jcond.match_loss(gw_syn, gw_real, "ours")
        return total

    want_loss, want_g = jax.jit(jax.value_and_grad(jtotal))(syn)

    tv = tcond.trainable_variables(sd)
    st = _t(syn).requires_grad_(True)
    total = 0.0
    for c in range(classes):
        sy = torch.tensor([0.9])
        r = tcond.scale(_t(real[c]), _t(sx), sy)
        s = tcond.scale(st[c], _t(sx), sy)
        total = total + tcond.gradient_match(apply_fn, tv, (r, torch.full((n_real,), c)),
                                             (s, torch.full((ipc,), c)))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(want_g), atol=1e-4, rtol=0)
    assert float(np.abs(np.asarray(want_g)).max()) > 1e-3


def test_convnet_ln_groups_layernorm_by_channel():
    """The port's match_loss on a real ConvNetLN gradient tree equals JAX's
    on the same gradients with LayerNorm's leaves in the reference's
    [C, H, W]; JAX on its own [H, W, C] tree groups by H, and differs."""
    module, jvars, apply_fn, sd = _networks("ConvNetLN", size=16)
    rng = np.random.default_rng(4)
    xr, xs = (rng.normal(size=(n, 16, 16, 3)).astype(np.float32) for n in (8, 2))
    yr, ys = np.full(8, 3), np.full(2, 3)

    @jax.jit
    def jgrad(xb, yb):
        def loss(p):
            logits = module.apply({"params": p}, xb, train=False)
            return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), yb[:, None], 1))
        return jax.grad(loss)(jvars["params"])

    gr, gs = jax.device_get(jgrad(xr, yr)), jax.device_get(jgrad(xs, ys))
    jax_native = float(jcond.match_loss(gs, gr, "ours"))

    def chw(tree):
        return jax.tree_util.tree_map_with_path(
            lambda path, a: a.transpose(2, 0, 1)
            if a.ndim == 3 and "LayerNorm" in jax.tree_util.keystr(path) else a, tree)

    jax_by_channel = float(jcond.match_loss(chw(gs), chw(gr), "ours"))
    tv = tcond.trainable_variables(sd)
    port = float(tcond.gradient_match(apply_fn, tv, (_t(xr), _t(yr)), (_t(xs), _t(ys))).detach())
    np.testing.assert_allclose(port, jax_by_channel, rtol=1e-5)
    assert abs(port - jax_native) > 1e-3 * abs(port)
    print(f"ConvNetLN match_loss: port (by C) {port!r}, JAX on its [H, W, C] tree {jax_native!r}")
