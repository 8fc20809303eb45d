"""The port's Inception-v3 defense (``models/inception.py``) and weight
loaders (``models/convert.py``) against the JAX package at float32 on the
CPU.

Weights reach both packages two ways: a reference-format Inception3 state
dict (``tests/test_inception._reference_style_state_dict``) through JAX's
``torch_inception3_to_flax`` and through the port's
``load_inception_state_dict``; and flax variables (random, BatchNorm
statistics away from identity) carried into the port by
``flax_inception_to_state_dict``. All in eval mode (running statistics).
Tolerances: Denoise within 1e-4; Inception3 logits and the paired
losses within 1e-4 absolute plus 1e-4 relative (17 convolution stages,
float32 sums in another order; the reference-style random weights give
logits of a few hundred, where 3e-5 relative was measured);
``hf_vit_to_base_tree``'s arrays equal, the loaded base's logits within
2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapley_vit_tpu.models import convert as jcv
from shapley_vit_tpu.models import inception as jinc
from shapley_vit_tpu.models import vit as jvit
from shapley_vit_tpu_torch.models import convert as tcv
from shapley_vit_tpu_torch.models import inception as tinc
from shapley_vit_tpu_torch.models import vit as tvit
from shapley_vit_tpu_torch.models.convert import tree_from_numpy
from tests.test_inception import _reference_style_state_dict

SMALL_DENOISE = dict(fwd_out=(8, 16), num_fwd=(1, 1), back_out=(8,), num_back=(1,))


def _tame(sd):
    """The JAX parity test's scaling: small convolutions and BatchNorm near
    identity, so 17 random stages keep finite, moderate activations."""
    for k in list(sd):
        if k.endswith("conv.weight"):
            sd[k] = (sd[k] * 0.05).astype(np.float32)
        elif k.endswith("bn.running_mean"):
            sd[k] = (sd[k] * 0.01).astype(np.float32)
        elif k.endswith("bn.weight"):
            sd[k] = np.abs(sd[k]).astype(np.float32) * 0.2 + 0.9
        elif k.endswith("bn.bias"):
            sd[k] = (sd[k] * 0.05).astype(np.float32)
    return sd


def _perturbed(variables, rng, scale=0.1):
    """flax variables as numpy: parameters moved off their init, running
    means near 0 and running variances near 1 but not equal to them."""
    def stats(tree):
        return {k: stats(v) if isinstance(v, dict) else (
            0.05 * rng.normal(size=v.shape) if k == "mean" else 0.75 + 0.5 * rng.uniform(size=v.shape)
        ).astype(np.float32) for k, v in tree.items()}

    v = jax.device_get(variables)
    out = {"params": jax.tree.map(lambda a: np.asarray(a) + scale * rng.normal(size=a.shape)
                                  .astype(np.float32), v["params"])}
    if "batch_stats" in v:
        out["batch_stats"] = stats(v["batch_stats"])
    return out


def _reference_weights(variables, rng):
    """Inception3 (or Net) variables with the inception part overlaid from a
    tamed reference-style state dict by JAX's converter, and any Denoise
    front-end perturbed as :func:`_perturbed` does, as numpy."""
    loaded = jax.device_get(jcv.torch_inception3_to_flax(
        _tame(_reference_style_state_dict(variables, rng)), variables))
    if "net" in loaded["params"]:
        den = _perturbed({k: v["net"]["denoise"] for k, v in loaded.items()}, rng)
        for k in loaded:
            loaded[k]["net"]["denoise"] = den[k]
    return loaded


def _port(model, variables):
    model.load_state_dict(tcv.flax_inception_to_state_dict(variables, model))
    return model.eval()


@pytest.mark.parametrize("wrapper", [False, True])
def test_inception_logits_from_a_reference_state_dict_match_jax(wrapper):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 299, 299, 3)).astype(np.float32)
    jmodel = jinc.inception_network() if wrapper else jinc.Inception3(num_classes=7)
    variables = jmodel.init(jax.random.key(0), jnp.asarray(x[:1]))
    inner = ({k: v["Inception3_0"] for k, v in variables.items()} if wrapper else variables)
    sd = _tame(_reference_style_state_dict(inner, rng))
    loaded = jcv.torch_inception3_to_flax(sd, inner)
    want = np.asarray(jmodel.apply({k: {"Inception3_0": v} for k, v in loaded.items()}
                                   if wrapper else loaded, jnp.asarray(x)))

    def port_model():
        return tinc.inception_network() if wrapper else tinc.Inception3(num_classes=7)

    tmodel = tcv.load_inception_state_dict(port_model(), sd).eval()
    carried = _port(port_model(), jax.device_get(loaded))
    with torch.no_grad():
        got = tmodel(torch.tensor(x)).numpy()
        via_flax = carried(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (2, 4 if wrapper else 7)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(via_flax, got)


def test_knee_pooling_matches_jax():
    rng = np.random.default_rng(12)
    x = rng.uniform(size=(3, 75, 75, 3)).astype(np.float32)
    jmodel = jinc.Inception3(num_classes=1001, knee_pooling=True)
    variables = _reference_weights(jmodel.init(jax.random.key(0), jnp.asarray(x)), rng)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    tmodel = _port(tinc.Inception3(num_classes=1001, knee_pooling=True, image_size=(75, 75)),
                   variables)
    with torch.no_grad():
        got = tmodel(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (1, 2)  # max over the batch, 2-class head
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("block,size", [("DenoiseConv", 299), ("DenoiseConv", 37),
                                        ("DenoiseBottleneck", 23)])
def test_denoise_matches_jax(block, size):
    """Both block types, the pyramid's bilinear upsampling at odd sizes
    (299 -> 150 -> 75 and back; 37 -> 19 -> 10)."""
    rng = np.random.default_rng(13)
    x = rng.uniform(size=(2, size, size, 3)).astype(np.float32)
    kw = dict(fwd_out=(8, 16, 16), num_fwd=(1, 2, 1), back_out=(8, 16), num_back=(1, 2))
    jden = jinc.Denoise(h_in=size, w_in=size, block=getattr(jinc, block), **kw)
    variables = _perturbed(jden.init(jax.random.key(1), jnp.asarray(x), False), rng)
    want = np.asarray(jden.apply(variables, jnp.asarray(x), False))
    tden = _port(tinc.Denoise(size, size, block=getattr(tinc, block), **kw), variables)
    with torch.no_grad():
        got = tden(torch.tensor(x)).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("stride", [1, 2])
def test_denoise_bottleneck_block_matches_jax(stride):
    rng = np.random.default_rng(14)
    x = rng.normal(size=(1, 15, 15, 8)).astype(np.float32)
    jblk = jinc.DenoiseBottleneck(n_out=8, stride=stride)
    variables = _perturbed(jblk.init(jax.random.key(1), jnp.asarray(x), False), rng)
    want = np.asarray(jblk.apply(variables, jnp.asarray(x), False))
    tblk = _port(tinc.DenoiseBottleneck(8, 8, stride=stride), variables)
    with torch.no_grad():
        got = tblk(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (1, 8 if stride == 2 else 15, 8 if stride == 2 else 15, 32)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("requires_control", [True, False])
def test_paired_net_outputs_and_losses_match_jax(requires_control):
    """The paired Net at 203 px (the least size whose pooled feature map is
    not empty), a small Denoise; hard mining and the loss norm on."""
    rng = np.random.default_rng(15)
    x = rng.uniform(size=(2, 203, 203, 3)).astype(np.float32)
    adv = np.clip(x + 0.03 * rng.normal(size=x.shape), 0, 1).astype(np.float32)
    kw = dict(n=2, hard_mining=0.5, loss_norm=True, num_classes=5, **SMALL_DENOISE)
    jnet = jinc.Net(input_size=(203, 203), **kw)
    variables = _reference_weights(jnet.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(adv),
                                             requires_control=False), rng)
    want = jnet.apply(variables, jnp.asarray(x), jnp.asarray(adv),
                      requires_control=requires_control)
    tnet = _port(tinc.Net(input_size=(203, 203), **kw), variables)
    with torch.no_grad():
        got = tnet(torch.tensor(x), torch.tensor(adv), requires_control=requires_control)
    assert len(got) == len(want) == (5 if requires_control else 3)
    flat_got = [got[0], got[1], *got[2]] + ([got[3], *got[4]] if requires_control else [])
    flat_want = [want[0], want[1], *want[2]] + ([want[3], *want[4]] if requires_control else [])
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
    assert not np.allclose(got[0].numpy(), got[1].numpy())  # the defense changes the logits


@pytest.mark.parametrize("n,hard_mining,norm", [(1, 0.0, False), (2, 0.0, True),
                                                (2, 1 / 3, False), (1, 0.25, True)])
def test_denoise_loss_matches_jax(n, hard_mining, norm):
    rng = np.random.default_rng(16)
    x, y = rng.normal(size=(2, 5, 7)).astype(np.float32), rng.normal(size=(2, 5, 7)).astype(np.float32)
    want = float(jinc.denoise_loss(jnp.asarray(x), jnp.asarray(y), n, hard_mining, norm))
    got = float(tinc.denoise_loss(torch.tensor(x), torch.tensor(y), n, hard_mining, norm))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    # the JAX test's semantics (tests/test_inception.py::test_denoise_loss_semantics)
    a, b = torch.tensor([1.0, 2.0, 3.0]), torch.ones(3)
    assert abs(float(tinc.denoise_loss(a, b, n=2)) - np.mean([0, 0.5, 2.0])) <= 1e-6
    assert abs(float(tinc.denoise_loss(a, b, n=2, hard_mining=1 / 3)) - 2.0) <= 1e-6
    with pytest.raises(ValueError):
        tinc.denoise_loss(a, b, n=2, hard_mining=1.5)


@pytest.fixture(scope="module")
def reference_file(tmp_path_factory):
    """A reference-format checkpoint of the paired Net's inception at 75 px,
    written by ``torch.save``, and the arrays in it."""
    net = jinc.Net(input_size=(75, 75), n=1, num_classes=1001, **SMALL_DENOISE)
    x = jnp.zeros((1, 75, 75, 3))
    variables = net.init(jax.random.key(1), x, x, requires_control=False)
    sd = _reference_style_state_dict(variables, np.random.default_rng(7))
    path = tmp_path_factory.mktemp("inception") / "inceptionv3_state.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(path))
    return str(path), sd


def _get_net(path):
    return tinc.get_net((75, 75), pretrained_path=path, **SMALL_DENOISE)


@pytest.mark.parametrize("case", ["pth", "npz", "state_dict_key", "denoise_keys_ignored"])
def test_get_net_loads_the_reference_file(reference_file, tmp_path, case):
    path, sd = reference_file
    if case == "npz":
        path = str(tmp_path / "inceptionv3_state.npz")
        np.savez(path, **sd)
    elif case == "state_dict_key":
        path = str(tmp_path / "wrapped.pth")
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    elif case == "denoise_keys_ignored":
        path = str(tmp_path / "with_denoise.pth")
        extra = {"denoise.fwd.0.0.conv.weight": np.full((8, 3, 3, 3), 7.0, np.float32)}
        torch.save({k: torch.from_numpy(v) for k, v in {**sd, **extra}.items()}, path)
    net = _get_net(path)
    fresh = tinc.get_net((75, 75), **SMALL_DENOISE)
    got = net.net.state_dict()
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    # the Denoise front-end keeps its (seeded) initialization
    for k, v in fresh.net.denoise.state_dict().items():
        torch.testing.assert_close(net.net.denoise.state_dict()[k], v, atol=0, rtol=0)


@pytest.mark.parametrize("fault,match", [
    ("unconsumed", "unconsumed"),
    ("truncated", "truncated"),
    ("classif_shape", "classif"),
    ("conv_shape", "conv shape"),
])
def test_get_net_is_as_strict_as_jax(reference_file, tmp_path, fault, match):
    _, sd = reference_file
    bad = dict(sd)
    if fault == "unconsumed":
        bad["Mixed_9z.bogus.conv.weight"] = np.zeros((1, 1, 1, 1), np.float32)
    elif fault == "truncated":
        del bad["Mixed_6b.branch1.1.bn.running_var"]
    elif fault == "classif_shape":
        bad["classif.weight"] = np.zeros((3, bad["classif.weight"].shape[1]), np.float32)
    else:
        bad["conv2d_1a.conv.weight"] = np.zeros((32, 3, 5, 5), np.float32)
    path = str(tmp_path / "bad.npz")
    np.savez(path, **bad)
    with pytest.raises(ValueError, match=match):
        _get_net(path)
    # JAX's loader refuses the same file
    jnet = jinc.Net(input_size=(75, 75), n=1, num_classes=1001, **SMALL_DENOISE)
    x = jnp.zeros((1, 75, 75, 3))
    with pytest.raises(ValueError):
        jcv.torch_inception3_to_flax(bad, jnet.init(jax.random.key(1), x, x,
                                                    requires_control=False))


def _hf_state_dict(spec, rng):
    """A synthetic HF ``ViTForImageClassification`` state dict, peft-wrapped
    (``base_model.model.`` prefix, ``base_layer`` on query/value)."""
    D, P, C, M, L = spec.hidden, spec.patch, spec.channels, spec.mlp_dim, spec.depth

    def r(*shape):
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    sd = {
        "vit.embeddings.patch_embeddings.projection.weight": r(D, C, P, P),
        "vit.embeddings.patch_embeddings.projection.bias": r(D),
        "vit.embeddings.cls_token": r(1, 1, D),
        "vit.embeddings.position_embeddings": r(1, spec.seq_len, D),
        "vit.layernorm.weight": 1 + r(D), "vit.layernorm.bias": r(D),
        "classifier.weight": r(spec.num_classes, D), "classifier.bias": r(spec.num_classes),
    }
    for i in range(L):
        stem = f"vit.encoder.layer.{i}"
        for name, (o, n_in) in {"attention.attention.query.base_layer": (D, D),
                                "attention.attention.key": (D, D),
                                "attention.attention.value.base_layer": (D, D),
                                "attention.output.dense": (D, D),
                                "intermediate.dense": (M, D), "output.dense": (D, M)}.items():
            sd[f"{stem}.{name}.weight"], sd[f"{stem}.{name}.bias"] = r(o, n_in), r(o)
        for ln in ("layernorm_before", "layernorm_after"):
            sd[f"{stem}.{ln}.weight"], sd[f"{stem}.{ln}.bias"] = 1 + r(D), r(D)
    return {f"base_model.model.{k}": torch.from_numpy(v) for k, v in sd.items()}


def test_hf_vit_to_base_tree_matches_jax():
    spec_j, spec_t = jvit.make_spec("micro"), tvit.make_spec("micro")
    sd = _hf_state_dict(spec_t, np.random.default_rng(17))
    want = jcv.hf_vit_to_base_tree(sd, spec_j)
    got = tcv.hf_vit_to_base_tree(sd, spec_t)
    leaves_w, tree_w = jax.tree.flatten(want)
    leaves_g, tree_g = jax.tree.flatten(got)
    assert tree_w == tree_g
    for g, w in zip(leaves_g, leaves_w):
        np.testing.assert_array_equal(g, w)
    images = np.random.default_rng(18).uniform(size=(2, 16, 16, 3)).astype(np.float32)
    logits_j = np.asarray(jvit.vit_forward(want, None, images, spec_j))
    logits_t = tvit.vit_forward(tree_from_numpy(got), None, torch.tensor(images), spec_t)
    np.testing.assert_allclose(logits_t.numpy(), logits_j, atol=2e-5, rtol=0)
