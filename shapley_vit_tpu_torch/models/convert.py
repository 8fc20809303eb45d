"""Weight conversion and the weight carrier.

* :func:`tree_from_numpy` / :func:`tree_to_numpy` carry parameter trees
  between numpy and this package's dict-of-tensor trees. The key names and
  layouts are the JAX package's, so a tree pulled out of ``shapley_vit_tpu``
  as numpy (``jax.device_get``) becomes the port's tree with no renaming.
* :func:`peft_lora_to_tree` / :func:`tree_to_peft_lora` convert between
  peft's LoRA state dict (``lora_A: [r, in]``, ``lora_B: [out, r]``) and the
  overlay tree (``A: [D, r]``, ``B: [r, D]``, so the overlay is
  ``x @ A @ B``) — copies of the functions in
  ``shapley_vit_tpu/models/convert.py``, on numpy state dicts.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from shapley_vit_tpu_torch.models.vit import ViTSpec
from shapley_vit_tpu_torch.ops.tree_math import tree_map

Tree = Any


def tree_from_numpy(tree: Tree, device="cpu", dtype: Optional[torch.dtype] = None) -> Tree:
    """numpy (or array-like) leaves -> tensors on ``device`` (cast to
    ``dtype`` when given). The arrays are copied, never aliased."""
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
