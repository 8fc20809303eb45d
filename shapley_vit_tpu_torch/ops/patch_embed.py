"""Patch embedding: NHWC images -> [B, N, D] patch tokens.

The port of ``shapley_vit_tpu/ops/patch_embed.py`` (Pallas
``_patch_embed_kernel``). :func:`patch_embed` launches the hand-written
Hopper kernel (``csrc/patch_embed.cu``) for a CUDA tensor and runs
:func:`patch_embed_plain`, the same function in torch ops, for a CPU tensor.
There is no fallback between the two: a CUDA tensor gets the kernel or an
exception. :func:`patch_embed` is a ``torch.autograd.Function``: its
backward, for the images, the kernel and the bias, is torch ops on either
device (the JAX package differentiates its XLA path, ``_patchify`` and a
matmul, since the Pallas kernel has no VJP). The adversarial attacks and
Grad-CAM need the image gradient; LoRA training needs none.

The route is the dtype's (``ROUTE``): bf16 runs the tensor-core kernel,
whose copy widths and W loads adapt to alignment inside it, and float32 the
FMA kernel. The wrapper keeps the route of its last launch in its ``route``
attribute, counts its launches in ``launches`` and, by kernel, in
``launches_by`` (``"<route> <dtype>"``).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from shapley_vit_tpu_torch.ops import _build

_FNS = {
    f"svt_patch_embed_{t}": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    for t in ("f32", "bf16")
}
ROUTE = {torch.bfloat16: "wgmma", torch.float32: "fma"}  # the kernel of each dtype's entry


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


def unpatchify(patches: torch.Tensor, patch: int, H: int, W: int) -> torch.Tensor:
    """Inverse of :func:`patchify`: [B, N, patch*patch*C] -> [B, H, W, C]
    (the patches do not overlap, so this is the inverse permutation)."""
    B = patches.shape[0]
    gh, gw = H // patch, W // patch
    C = patches.shape[-1] // (patch * patch)
    x = patches.reshape(B, gh, gw, patch, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def _patch_embed_kernel(images: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                        patch: int) -> torch.Tensor:
    """The Hopper kernel on CUDA tensors."""
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
    patch_embed.route = ROUTE[images.dtype]
    patch_embed.launches += 1
    patch_embed.launches_by[f"{patch_embed.route} {str(images.dtype).replace('torch.', '')}"] += 1
    return out


class _PatchEmbed(torch.autograd.Function):
    """Forward: the kernel (CUDA) or its plain version (CPU). Backward, in
    float32 torch ops, each gradient cast to its input's dtype; it launches
    no kernel: dX = unpatchify(dY·Wᵀ), dW = patchesᵀ·dY, db = Σ dY."""

    @staticmethod
    def forward(ctx, images, kernel, bias, patch):
        ctx.save_for_backward(images, kernel)
        ctx.patch, ctx.bias_dtype = patch, bias.dtype
        if not images.is_cuda:
            return patch_embed_plain(images, kernel, bias, patch)
        return _patch_embed_kernel(images, kernel, bias, patch)

    @staticmethod
    def backward(ctx, dy):
        images, kernel = ctx.saved_tensors
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        g = dy.float()
        dx = dw = db = None
        if need_x:
            dp = torch.matmul(g, kernel.float().t())
            dx = unpatchify(dp, ctx.patch, images.shape[1], images.shape[2]).to(images.dtype)
        if need_w:
            x = patchify(images.to(kernel.dtype), ctx.patch).float()
            dw = torch.matmul(x.reshape(-1, x.shape[-1]).t(),
                              g.reshape(-1, g.shape[-1])).to(kernel.dtype)
        if need_b:
            db = g.sum(dim=(0, 1)).to(ctx.bias_dtype)
        return dx, dw, db, None


def patch_embed(images: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                patch: int) -> torch.Tensor:
    """[B, H, W, C] images, [P*P*C, D] kernel, [D] bias -> [B, N, D] tokens in
    the image dtype. CPU tensors run :func:`patch_embed_plain`; CUDA tensors
    launch the kernel (float32 or bfloat16, all three of one dtype,
    contiguous, H and W multiples of ``patch``). Differentiable in all three
    inputs on either device."""
    return _PatchEmbed.apply(images, kernel, bias, patch)


patch_embed.launches = 0
patch_embed.launches_by = collections.Counter()
patch_embed.route = None
