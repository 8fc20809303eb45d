"""Patch embedding: NHWC images -> [B, N, D] patch tokens.

The port of ``shapley_vit_tpu/ops/patch_embed.py`` (Pallas
``_patch_embed_kernel``). :func:`patch_embed` launches the hand-written
Hopper kernel (``csrc/patch_embed.cu``) for a CUDA tensor and runs
:func:`patch_embed_plain`, the same function in torch ops, for a CPU tensor.
There is no fallback between the two: a CUDA tensor gets the kernel or an
exception. The kernel has no gradient, so neither path accepts inputs that
autograd would differentiate: LoRA training needs none, since nothing
upstream of the patch embedding trains.
"""

from __future__ import annotations

import ctypes

import torch

from shapley_vit_tpu_torch.ops import _build

_FNS = {
    f"svt_patch_embed_{t}": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    for t in ("f32", "bf16")
}


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B,H,W,C] -> [B, N, patch*patch*C], patches flattened in HF (ph, pw, C)
    order over a row-major grid (``models/vit._patchify`` in the JAX package)."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


def patch_embed_plain(images: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                      patch: int) -> torch.Tensor:
    """The kernel's arithmetic in torch ops: patches in the weights' dtype,
    float32 accumulation, float32 bias, output in the image dtype."""
    x = patchify(images.to(kernel.dtype), patch)
    out = torch.matmul(x.float(), kernel.float()) + bias.float()
    return out.to(images.dtype)


def patch_embed(images: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                patch: int) -> torch.Tensor:
    """[B, H, W, C] images, [P*P*C, D] kernel, [D] bias -> [B, N, D] tokens in
    the image dtype. CPU tensors run :func:`patch_embed_plain`; CUDA tensors
    launch the kernel (float32 or bfloat16, all three of one dtype,
    contiguous, H and W multiples of ``patch``). Forward only: it raises
    when autograd would need a gradient through it (images or weights that
    require grad)."""
    _build.refuse_grad("patch_embed", images, kernel, bias)
    if not images.is_cuda:
        return patch_embed_plain(images, kernel, bias, patch)
    B, H, W, C = images.shape
    D = kernel.shape[1]
    if H % patch or W % patch:
        raise ValueError(f"image {H}x{W} is not a multiple of patch {patch}")
    if kernel.shape != (patch * patch * C, D) or bias.shape != (D,):
        raise ValueError(f"kernel {tuple(kernel.shape)} / bias {tuple(bias.shape)} do not fit "
                         f"patch {patch} and {C} channels")
    _build.check_tensors("patch_embed", images, kernel, bias)
    lib = _build.load("patch_embed", _FNS)
    out = torch.empty((B, (H // patch) * (W // patch), D), dtype=images.dtype,
                      device=images.device)
    fn = getattr(lib, f"svt_patch_embed_{_build.SUFFIX[images.dtype]}")
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(images.data_ptr(), kernel.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 B, H, W, C, patch, D, stream)
    _build.check(err, "patch_embed")
    patch_embed.launches += 1
    return out


patch_embed.launches = 0

