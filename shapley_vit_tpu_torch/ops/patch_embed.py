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

The route is the dtype's (``ROUTE``), both on the tensor cores, at every
shape: bf16 runs ``"wgmma"``, whose copy widths and W loads adapt to
alignment inside it; float32 runs ``"tf32x3"`` (entry
``svt_patch_embed_tf32x3``), which first splits W into its transposed
TF32 pair in a workspace ``wt [2, D, Kpad]`` from the caching allocator
(``Kpad``: P*P*C rounded up to a multiple of 4), then takes each product
as three TF32 products, which keeps float32's accuracy. The wrapper keeps
the route of its last launch in its ``route`` attribute, counts its
launches in ``launches`` and, by kernel, in ``launches_by``
(``"<route> <dtype>"``).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from shapley_vit_tpu_torch.ops import _build

_FNS = {
    "svt_patch_embed_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "svt_patch_embed_tf32x3": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p],  # + wt
}
ROUTE = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}  # the kernel of each dtype's entry


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
    route = ROUTE[images.dtype]
    ptrs = [images.data_ptr(), kernel.data_ptr(), bias.data_ptr(), out.data_ptr()]
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "wgmma":
            err = lib.svt_patch_embed_bf16(*ptrs, B, H, W, C, patch, D, stream)
        else:
            # freed on return: the caching allocator hands its block only to
            # work queued after the kernels on this stream
            kpad = -(-patch * patch * C // 4) * 4
            wt = torch.empty((2, D, kpad), dtype=torch.float32, device=images.device)
            err = lib.svt_patch_embed_tf32x3(*ptrs, wt.data_ptr(), B, H, W, C, patch, D, stream)
    _build.check(err, "patch_embed")
    _build.count(patch_embed, route, f"{route} {str(images.dtype).replace('torch.', '')}")
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
