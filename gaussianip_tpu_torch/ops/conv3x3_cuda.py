"""Stride-1 SAME 3x3 convolution: the hand-written CUDA kernel K3
(csrc/conv3x3.cu) and its plain PyTorch version (port of
gaussianip_tpu/ops/conv_pallas.py:_conv3x3_pallas).

    x       [B, Ci, H, W]  (the kernel takes bf16 in channels_last memory)
    weight  [Co, Ci, 3, 3] OIHW; the kernel takes it packed [9 * Ci, Co]
            (`pack_weight`)
    bias    [Co] or None, added to the f32 sum before the cast
    y       [B, Co, H, W]  in x's dtype, channels_last memory

The plain version repeats the kernel's arithmetic: 9 accumulating tap
matmuls of the zero-padded input in float32, one cast at the end. Each
wrapper of the kernel counts its launches in `.launches`.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F


def conv3x3_plain(x, weight, bias=None) -> torch.Tensor:
    """Plain PyTorch stride-1 SAME 3x3 conv: sum over the 9 taps of
    shifted-input @ weight[tap] in float32, cast to x's dtype."""
    b, _, h, w = x.shape
    co = weight.shape[0]
    xp = F.pad(x.float().permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1))
    wk = weight.float().permute(2, 3, 1, 0)  # HWIO
    acc = torch.zeros((b, h, w, co), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc += xp[:, dy:dy + h, dx:dx + w, :] @ wk[dy, dx]
    if bias is not None:
        acc += bias.float()
    return acc.to(x.dtype).permute(0, 3, 1, 2)


def pack_weight(weight, dtype=torch.bfloat16) -> torch.Tensor:
    """OIHW [Co, Ci, 3, 3] -> [9 * Ci, Co] in `dtype` (HWIO flattened, row
    (dy * 3 + dx) * Ci + ci), one copy."""
    co, ci = weight.shape[:2]
    out = torch.empty((3, 3, ci, co), dtype=dtype, device=weight.device)
    out.copy_(weight.permute(2, 3, 1, 0))
    return out.view(9 * ci, co)


@functools.cache
def _lib():
    from .. import _nvcc

    lib = _nvcc.load("conv3x3")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.conv3x3_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                                ptr]
    lib.conv3x3_fwd.restype = i32
    return lib


def conv3x3_cuda(x, w_packed, bias=None) -> torch.Tensor:
    """K3 on the current stream. x: bf16 [B, Ci, H, W] in channels_last
    memory; w_packed: bf16 [9 * Ci, Co] from `pack_weight`; bias: f32 [Co]
    or None. Ci and Co must be multiples of 8."""
    if not x.is_cuda:
        raise ValueError("the CUDA 3x3 conv takes CUDA tensors")
    if x.dim() != 4 or x.dtype != torch.bfloat16 \
            or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(
            f"x: want bf16 [B, Ci, H, W] in channels_last memory, got "
            f"{x.dtype} {tuple(x.shape)} strides {x.stride()}")
    b, ci, h, w = x.shape
    if w_packed.dim() != 2 or w_packed.shape[0] != 9 * ci:
        raise ValueError(f"w_packed: want [9 * {ci}, Co], got "
                         f"{tuple(w_packed.shape)}")
    co = w_packed.shape[1]
    if ci % 8 or co % 8:
        raise ValueError(f"the CUDA 3x3 conv needs Ci and Co multiples of 8, "
                         f"got Ci={ci} Co={co}")
    if w_packed.dtype != torch.bfloat16 or w_packed.device != x.device \
            or not w_packed.is_contiguous():
        raise ValueError("w_packed: want contiguous bf16 on x's device")
    if bias is not None and (bias.dtype != torch.float32
                             or bias.device != x.device
                             or tuple(bias.shape) != (co,)
                             or not bias.is_contiguous()):
        raise ValueError(f"bias: want contiguous f32 [{co}] on x's device")
    y = torch.empty((b, co, h, w), dtype=torch.bfloat16, device=x.device,
                    memory_format=torch.channels_last)
    err = _lib().conv3x3_fwd(
        x.data_ptr(), w_packed.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(), b, h, w, ci,
        co, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_fwd launch failed: cudaError {err}")
    conv3x3_cuda.launches += 1
    return y


conv3x3_cuda.launches = 0


def conv3x3_same(x, weight, bias=None) -> torch.Tensor:
    """Stride-1 SAME 3x3 conv (no autograd): K3 for a CUDA tensor, the
    plain version for a CPU tensor. The weight is cast to x's dtype."""
    if x.is_cuda:
        return conv3x3_cuda(
            x.contiguous(memory_format=torch.channels_last),
            pack_weight(weight, x.dtype),
            None if bias is None else bias.float().contiguous())
    return conv3x3_plain(x, weight.to(x.dtype), bias)
