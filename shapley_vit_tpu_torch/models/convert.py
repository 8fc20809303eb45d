"""Weight conversion and the weight carrier.

* :func:`tree_from_numpy` / :func:`tree_to_numpy` carry parameter trees
  between numpy and this package's dict-of-tensor trees. The key names and
  layouts are the JAX package's, so a tree pulled out of ``shapley_vit_tpu``
  as numpy (``jax.device_get``) becomes the port's tree with no renaming.
* :func:`hf_vit_to_base_tree` converts an HF ``ViTForImageClassification``
  state dict into the frozen base tree; :func:`peft_lora_to_tree` /
  :func:`tree_to_peft_lora` convert between peft's LoRA state dict
  (``lora_A: [r, in]``, ``lora_B: [out, r]``) and the overlay tree
  (``A: [D, r]``, ``B: [r, D]``, so the overlay is ``x @ A @ B``) — copies
  of the functions in ``shapley_vit_tpu/models/convert.py``, on numpy state
  dicts.
* :func:`load_inception_state_dict` loads a reference-format Inception-v3
  state dict (``inceptionv3_state.pth``) into ``models.inception.Inception3``
  with the strictness of the JAX package's ``torch_inception3_to_flax``;
  :func:`flax_inception_to_state_dict` carries the JAX package's flax
  ``Net`` / ``Inception3`` / ``Denoise`` variables (numpy) into the port's
  module, so the tests run both packages on the same weights.
* :func:`flax_zoo_to_state_dict` / :func:`state_dict_to_flax_zoo` carry
  the JAX zoo's flax variables (numpy) to and from a ``models.zoo``
  module's state dict, whose keys are the flax paths.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from shapley_vit_tpu_torch.models.vit import ViTSpec
from shapley_vit_tpu_torch.ops.tree_math import tree_map
from shapley_vit_tpu_torch.utils.profiling import span

Tree = Any


def tree_from_numpy(tree: Tree, device="cpu", dtype: Optional[torch.dtype] = None) -> Tree:
    """numpy (or array-like) leaves -> tensors on ``device`` (cast to
    ``dtype`` when given). The arrays are copied, never aliased."""
    with span("tree.to_device"):
        return tree_map(
            lambda x: torch.tensor(np.array(x, copy=True), device=device, dtype=dtype), tree
        )


def tree_to_numpy(tree: Tree) -> Tree:
    """Inverse of :func:`tree_from_numpy`: tensor leaves -> host numpy."""
    return tree_map(lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                    else np.asarray(x), tree)


def torch_state_dict_to_numpy(state_dict: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Detach a torch state dict to plain numpy (host-side, no grad)."""
    out = {}
    for k, v in state_dict.items():
        out[k] = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
    return out


def _strip_prefixes(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Normalize key prefixes across the wrappers the reference stacks up:
    peft (``base_model.model.``), DataParallel (``module.``)."""
    out = {}
    for k, v in sd.items():
        k = re.sub(r"^(module\.)+", "", k)
        k = re.sub(r"^base_model\.model\.", "", k)
        k = re.sub(r"\.base_layer\.", ".", k)  # peft wraps target Linears
        # peft modules_to_save keeps the frozen copy under .original_module
        k = re.sub(r"\.original_module\.", ".", k)
        out[k] = v
    return out


def hf_vit_to_base_tree(state_dict: Mapping[str, Any], spec: ViTSpec) -> Tree:
    """HF ``ViTForImageClassification`` state dict -> the frozen base tree,
    as numpy.

    Layout transforms:
      * torch Linear ``[out, in]`` -> kernel ``[in, out]``
      * patch-embed Conv2d ``[D, C, ph, pw]`` -> ``[ph*pw*C, D]`` matching
        ``patchify``'s (ph, pw, C) flattening order
      * per-layer tensors stacked on a leading depth axis
    """
    sd = _strip_prefixes(torch_state_dict_to_numpy(state_dict))
    L = spec.depth

    def lin(prefix):
        w = sd[f"{prefix}.weight"]
        return {"kernel": w.T.copy(), "bias": sd[f"{prefix}.bias"].copy()}

    def stack_lin(fmt):
        ws = [sd[fmt.format(i) + ".weight"].T for i in range(L)]
        bs = [sd[fmt.format(i) + ".bias"] for i in range(L)]
        return {"kernel": np.stack(ws), "bias": np.stack(bs)}

    def stack_ln(fmt):
        return {
            "scale": np.stack([sd[fmt.format(i) + ".weight"] for i in range(L)]),
            "bias": np.stack([sd[fmt.format(i) + ".bias"] for i in range(L)]),
        }

    conv_w = sd["vit.embeddings.patch_embeddings.projection.weight"]  # [D,C,ph,pw]
    D = conv_w.shape[0]
    patch_kernel = conv_w.transpose(2, 3, 1, 0).reshape(-1, D).copy()
    return {
        "patch_embed": {
            "kernel": patch_kernel,
            "bias": sd["vit.embeddings.patch_embeddings.projection.bias"].copy(),
        },
        "cls_token": sd["vit.embeddings.cls_token"].copy(),
        "pos_embed": sd["vit.embeddings.position_embeddings"].copy(),
        "blocks": {
            "ln1": stack_ln("vit.encoder.layer.{}.layernorm_before"),
            "attn": {
                "q": stack_lin("vit.encoder.layer.{}.attention.attention.query"),
                "k": stack_lin("vit.encoder.layer.{}.attention.attention.key"),
                "v": stack_lin("vit.encoder.layer.{}.attention.attention.value"),
                "out": stack_lin("vit.encoder.layer.{}.attention.output.dense"),
            },
            "ln2": stack_ln("vit.encoder.layer.{}.layernorm_after"),
            "mlp": {
                "fc1": stack_lin("vit.encoder.layer.{}.intermediate.dense"),
                "fc2": stack_lin("vit.encoder.layer.{}.output.dense"),
            },
        },
        "final_ln": {
            "scale": sd["vit.layernorm.weight"].copy(),
            "bias": sd["vit.layernorm.bias"].copy(),
        },
        "classifier": lin("classifier"),
    }


_LORA_A_RE = re.compile(
    r"vit\.encoder\.layer\.(\d+)\.attention\.attention\.(query|value)\.lora_A(?:\.default)?\.weight"
)
_LORA_B_RE = re.compile(
    r"vit\.encoder\.layer\.(\d+)\.attention\.attention\.(query|value)\.lora_B(?:\.default)?\.weight"
)
_CLS_RE = re.compile(
    r"classifier(?:\.modules_to_save(?:\.default)?)?\.(weight|bias)"
)


def peft_lora_to_tree(state_dict: Mapping[str, Any], spec: ViTSpec) -> Tree:
    """peft LoRA state dict -> the overlay tree, as numpy.

    peft stores ``lora_A: [r, in]``, ``lora_B: [out, r]``; ours is
    ``A: [D, r] = lora_A.T``, ``B: [r, D] = lora_B.T``. The classifier comes
    from peft's ``modules_to_save`` copy (start.py:276)."""
    sd = _strip_prefixes(torch_state_dict_to_numpy(state_dict))
    L, D, r = spec.depth, spec.hidden, spec.lora_r
    short = {"query": "q", "value": "v"}
    A = {t: np.zeros((L, D, r), np.float32) for t in ("q", "v")}
    B = {t: np.zeros((L, r, D), np.float32) for t in ("q", "v")}
    cls_w = None
    cls_b = None
    cls_from_saved = {"weight": False, "bias": False}
    found_a = set()
    for k, v in sd.items():
        m = _LORA_A_RE.fullmatch(k)
        if m:
            A[short[m.group(2)]][int(m.group(1))] = v.T
            found_a.add((int(m.group(1)), m.group(2)))
            continue
        m = _LORA_B_RE.fullmatch(k)
        if m:
            B[short[m.group(2)]][int(m.group(1))] = v.T
            continue
        m = _CLS_RE.fullmatch(k)
        if m:
            # peft keeps TWO classifier copies: the trainable
            # ``modules_to_save`` one and the frozen ``original_module`` one
            # (stripped to a bare ``classifier.*`` key). The trainable copy
            # must win regardless of state-dict key order.
            saved = "modules_to_save" in k
            name = m.group(1)
            if cls_from_saved[name] and not saved:
                continue
            cls_from_saved[name] = saved
            if name == "weight":
                cls_w = v.T.copy()
            else:
                cls_b = v.copy()
    if len(found_a) != 2 * L:
        raise ValueError(
            f"expected LoRA A for query+value in all {L} layers, found {len(found_a)}"
        )
    if cls_w is None or cls_b is None:
        raise ValueError("classifier head missing from LoRA checkpoint")
    return {
        "lora": {t: {"A": A[t], "B": B[t]} for t in ("q", "v")},
        "classifier": {"kernel": cls_w, "bias": cls_b},
    }


def tree_to_peft_lora(lora_tree: Tree, spec: ViTSpec, prefix: str = "base_model.model.") -> Dict[str, np.ndarray]:
    """Inverse of :func:`peft_lora_to_tree`: export an overlay (numpy or
    tensor leaves) in peft's naming."""
    lora_tree = tree_to_numpy(lora_tree)
    out: Dict[str, np.ndarray] = {}
    long = {"q": "query", "v": "value"}
    for t in ("q", "v"):
        for i in range(spec.depth):
            stem = f"{prefix}vit.encoder.layer.{i}.attention.attention.{long[t]}"
            out[f"{stem}.lora_A.default.weight"] = lora_tree["lora"][t]["A"][i].T.copy()
            out[f"{stem}.lora_B.default.weight"] = lora_tree["lora"][t]["B"][i].T.copy()
    out[f"{prefix}classifier.modules_to_save.default.weight"] = (
        lora_tree["classifier"]["kernel"].T.copy()
    )
    out[f"{prefix}classifier.modules_to_save.default.bias"] = (
        lora_tree["classifier"]["bias"].copy()
    )
    return out


# ---------------------------------------------------------------------------
# Inception-v3 defense net (models/inception.py)
# ---------------------------------------------------------------------------

# the reference's names of Inception3's BasicConv2d layers, in the order the
# forward calls them (flax names them BasicConv2d_{i} in that order)
_INCEPTION_STEM = ["conv2d_1a", "conv2d_2a", "conv2d_2b", "conv2d_3b", "conv2d_4a"]
_INCEPTION_BLOCKS = [
    ("InceptionA_0", "Mixed_5b"), ("InceptionA_1", "Mixed_5c"),
    ("InceptionA_2", "Mixed_5d"), ("InceptionB_0", "Mixed_6a"),
    ("InceptionC_0", "Mixed_6b"), ("InceptionC_1", "Mixed_6c"),
    ("InceptionC_2", "Mixed_6d"), ("InceptionC_3", "Mixed_6e"),
    ("InceptionD_0", "Mixed_7a"),
    ("InceptionE_0", "Mixed_7b"), ("InceptionE_1", "Mixed_7c"),
]
_BLOCK_CONV_ORDER = {
    # reference inception.py:10-37 (branch3 Sequential: [AvgPool, BasicConv2d])
    "InceptionA": ["branch0.0", "branch1.0", "branch1.1",
                   "branch2.0", "branch2.1", "branch2.2", "branch3.1"],
    # inception.py:41-58
    "InceptionB": ["branch0.0", "branch1.0", "branch1.1", "branch1.2"],
    # inception.py:62-93
    "InceptionC": ["branch0.0", "branch1.0", "branch1.1", "branch1.2",
                   "branch2.0", "branch2.1", "branch2.2", "branch2.3",
                   "branch2.4", "branch3.1"],
    # inception.py:96-114
    "InceptionD": ["branch0.0", "branch0.1",
                   "branch1.0", "branch1.1", "branch1.2", "branch1.3"],
    # inception.py:117-155 (branch1_*/branch2_* are bare attributes)
    "InceptionE": ["branch0.0", "branch1_0", "branch1_1", "branch1_2",
                   "branch2_0", "branch2_1", "branch2_2", "branch2_3",
                   "branch3.1"],
}


def _inception_basic_convs():
    """The reference prefix of every BasicConv2d of Inception3."""
    prefixes = list(_INCEPTION_STEM)
    for flax_block, torch_block in _INCEPTION_BLOCKS:
        kind = flax_block.rsplit("_", 1)[0]
        prefixes += [f"{torch_block}.{sub}" for sub in _BLOCK_CONV_ORDER[kind]]
    return prefixes


def load_inception_state_dict(model, state_dict: Mapping[str, Any]):
    """Load a reference-format Inception3 state dict (``conv2d_1a`` /
    ``Mixed_5b.branch0.0`` / ``classif``) into the port's ``Inception3``,
    with the JAX loader's strictness (models/convert.py:212-306): an
    unconsumed key other than ``denoise.*`` raises; so does a block whose
    conv weight is there but a BatchNorm tensor missing (truncated), and a
    conv or ``classif`` shape that does not fit. A block absent from the
    file keeps its weights, as does the Denoise front-end (the reference's
    file does not carry it; ``denoise.*`` keys are ignored). Returns the
    model."""
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in
          torch_state_dict_to_numpy(state_dict).items()}
    sd.pop("_metadata", None)
    own = model.state_dict()
    consumed = set()

    def take(key: str):
        if key in sd:
            consumed.add(key)
            return sd[key]
        return None

    def take_required(key: str):
        v = take(key)
        if v is None:
            raise ValueError(
                f"truncated checkpoint: {key} missing while its sibling tensors are present"
            )
        return v

    for prefix in _inception_basic_convs():
        w = take(f"{prefix}.conv.weight")
        if w is None:
            continue  # block not in the checkpoint at all: keep init
        if w.shape != own[f"{prefix}.conv.weight"].shape:
            raise ValueError(f"{prefix}: conv shape {tuple(w.shape)} != "
                             f"{tuple(own[f'{prefix}.conv.weight'].shape)}")
        own[f"{prefix}.conv.weight"] = w
        for name in ("weight", "bias", "running_mean", "running_var"):
            own[f"{prefix}.bn.{name}"] = take_required(f"{prefix}.bn.{name}")
        take(f"{prefix}.bn.num_batches_tracked")  # consume, unused
    w = take("classif.weight")
    if w is not None:
        if w.shape != own["classif.weight"].shape:
            raise ValueError(f"classif: shape {tuple(w.shape)} != "
                             f"{tuple(own['classif.weight'].shape)} (num_classes mismatch?)")
        own["classif.weight"] = w
        own["classif.bias"] = take_required("classif.bias")
    leftovers = [k for k in sd if k not in consumed and not k.startswith("denoise.")]
    if leftovers:
        raise ValueError(f"unconsumed inception state-dict keys: {leftovers[:8]}")
    model.load_state_dict(own)
    return model


def _flax_children(module) -> list:
    """(flax scope name, port submodule) pairs of one of the inception
    modules: flax names compact submodules by class and call order."""
    from shapley_vit_tpu_torch.models import inception as inc

    if isinstance(module, inc.Net):
        return [("net", module.net)]
    if isinstance(module, inc.Inception3):
        pairs = [(f"BasicConv2d_{i}", module.get_submodule(n)) for i, n in enumerate(_INCEPTION_STEM)]
        pairs += [(f, module.get_submodule(t)) for f, t in _INCEPTION_BLOCKS]
        pairs.append(("Dense_0", module.classif))
        if module.denoise is not None:
            pairs.append(("denoise", module.denoise))
        return pairs
    kind = type(module).__name__
    if kind in _BLOCK_CONV_ORDER:
        return [(f"BasicConv2d_{i}", module.get_submodule(sub))
                for i, sub in enumerate(_BLOCK_CONV_ORDER[kind])]
    if isinstance(module, inc.Denoise):
        counts: Dict[str, int] = {}
        pairs = []
        for blk in module.blocks_in_call_order():
            name = type(blk).__name__
            pairs.append((f"{name}_{counts.get(name, 0)}", blk))
            counts[name] = counts.get(name, 0) + 1
        return pairs + [("Conv_0", module.final)]
    if isinstance(module, (inc.BasicConv2d, inc.DenoiseConv)):
        return [("Conv_0", module.conv), ("BatchNorm_0", module.bn)]
    if isinstance(module, inc.DenoiseBottleneck):
        pairs = [(f"Conv_{i}", getattr(module, f"conv{i + 1}")) for i in range(3)]
        pairs += [(f"BatchNorm_{i}", getattr(module, f"bn{i + 1}")) for i in range(3)]
        if module.shortcut is not None:
            pairs += [("Conv_3", module.shortcut[0]), ("BatchNorm_3", module.shortcut[1])]
        return pairs
    raise TypeError(f"no flax counterpart for {type(module).__name__}")


def flax_inception_to_state_dict(variables: Mapping[str, Any], model) -> Dict[str, torch.Tensor]:
    """The JAX package's flax variables (``{'params', 'batch_stats'}`` of
    ``Net``, ``Inception3``, ``Denoise`` or one of their blocks, numpy
    leaves) -> a state dict for the port's ``model`` of the same
    configuration. Conv ``[kh, kw, I, O]`` -> ``[O, I, kh, kw]``; BatchNorm
    scale/bias and mean/var -> weight/bias and running_mean/running_var;
    Dense ``[I, O]`` -> ``[O, I]``. Every parameter and running statistic
    of ``model`` is filled (``num_batches_tracked`` keeps the model's)."""
    out = dict(model.state_dict())
    filled = set()

    def put(key, value):
        out[key] = torch.as_tensor(np.array(value, dtype=np.float32))
        filled.add(key)

    def walk(module, params, stats, prefix):
        if isinstance(module, torch.nn.Conv2d):
            put(prefix + "weight", np.asarray(params["kernel"]).transpose(3, 2, 0, 1))
        elif isinstance(module, torch.nn.BatchNorm2d):
            put(prefix + "weight", params["scale"])
            put(prefix + "bias", params["bias"])
            put(prefix + "running_mean", stats["mean"])
            put(prefix + "running_var", stats["var"])
        elif isinstance(module, torch.nn.Linear):
            put(prefix + "weight", np.asarray(params["kernel"]).T)
            put(prefix + "bias", params["bias"])
        else:
            names = {id(m): n for n, m in module.named_modules()}
            for flax_name, child in _flax_children(module):
                walk(child, params[flax_name], (stats or {}).get(flax_name),
                     prefix + names[id(child)] + ".")

    walk(model, variables["params"], variables.get("batch_stats", {}), "")
    missing = [k for k in out if k not in filled and not k.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(f"no flax variable for {missing[:8]}")
    return out


# flax zoo leaf -> (state-dict leaf, layout change), by the layer's flax type
_ZOO_PARAMS = {
    "Conv": {"kernel": ("weight", (3, 2, 0, 1)), "bias": ("bias", None)},
    "Dense": {"kernel": ("weight", (1, 0)), "bias": ("bias", None)},
    "BatchNorm": {"scale": ("weight", None), "bias": ("bias", None)},
    "GroupNorm": {"scale": ("weight", None), "bias": ("bias", None)},
    "LayerNorm": {"scale": ("weight", (2, 0, 1)), "bias": ("bias", (2, 0, 1))},
}
_ZOO_STATS = {"mean": "running_mean", "var": "running_var"}


def _zoo_leaves(tree: Mapping[str, Any], path=()):
    for k in sorted(tree):
        if isinstance(tree[k], Mapping):
            yield from _zoo_leaves(tree[k], path + (k,))
        else:
            yield path, k, tree[k]


def flax_zoo_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX zoo's flax variables (``{'params', 'batch_stats'}``, numpy
    leaves) -> a state dict for the ``models.zoo`` module of the same
    configuration: Conv ``[kh, kw, I, O]`` -> ``[O, I, kh, kw]``, Dense
    ``[I, O]`` -> ``[O, I]``, LayerNorm ``[H, W, C]`` -> ``[C, H, W]``,
    scale -> weight, mean/var -> running_mean/running_var. Load it with
    ``module.load_state_dict(..., strict=True)``, which refuses a missing
    or extra key."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf, value in _zoo_leaves(variables.get("params", {})):
        name, perm = _ZOO_PARAMS[path[-1].rsplit("_", 1)[0]][leaf]
        a = np.asarray(value, np.float32)
        out[".".join(path + (name,))] = torch.tensor(a.transpose(perm) if perm else a)
    for path, leaf, value in _zoo_leaves(variables.get("batch_stats", {})):
        out[".".join(path + (_ZOO_STATS[leaf],))] = torch.tensor(np.asarray(value, np.float32))
    return out


def state_dict_to_flax_zoo(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`flax_zoo_to_state_dict`: a ``models.zoo`` state
    dict -> the JAX zoo's ``{'params'[, 'batch_stats']}`` tree of numpy
    arrays."""
    back = {kind: {name: (leaf, perm) for leaf, (name, perm) in m.items()}
            for kind, m in _ZOO_PARAMS.items()}
    stats_back = {v: k for k, v in _ZOO_STATS.items()}
    out: Dict[str, Any] = {}
    for key, value in state_dict.items():
        *path, name = key.split(".")
        a = value.detach().cpu().numpy() if hasattr(value, "detach") else np.asarray(value)
        if name in stats_back:
            col, leaf = "batch_stats", stats_back[name]
        else:
            leaf, perm = back[path[-1].rsplit("_", 1)[0]][name]
            inv = None if perm is None else tuple(np.argsort(perm))
            col, a = "params", (a.transpose(inv) if inv else a)
        node = out.setdefault(col, {})
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return out
