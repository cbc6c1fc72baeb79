"""Stride-1 SAME 3x3 convolution: the hand-written CUDA kernel K3
(csrc/conv3x3.cu) and its plain PyTorch version (port of
gaussianip_tpu/ops/conv_pallas.py:_conv3x3_pallas).

    x       [B, Ci, H, W]  (the kernel takes bf16 in channels_last memory)
    weight  [Co, Ci, 3, 3] OIHW; the kernel takes it packed by `pack_weight`
    bias    [Co] or None, added to the f32 sum before the cast
    y       [B, Co, H, W]  in x's dtype, channels_last memory

K3 has two variants, chosen by one gate, `k3_variant(ci, co)`:
  - "hopper": an implicit GEMM on wgmma fed by TMA, for Ci a multiple of
    64 (every SD1.5 conv). Weight packed K-major [Co, 9 * Ci]. Its tile
    plan per shape (`k3_plan`) is computed here.
  - "general": the first port's wmma kernel, for the other Ci (multiples
    of 8, as the tiny test stack's 32). Weight packed [9 * Ci, Co].
On a CUDA tensor `conv3x3_cuda` launches the variant the gate names or
raises; neither variant stands in for the other. Each variant counts its
launches in `.launches`; `conv3x3_cuda.launches` is their sum.

The plain version repeats the kernels' arithmetic: 9 accumulating tap
matmuls of the zero-padded input in float32, one cast at the end.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from .. import _nvcc

# the Hopper variant's tile: BM output pixels (two consumer warpgroups of
# 64 rows) x BN output channels, K-steps of one tap x 64 channels (128 B,
# one 128B-swizzle row)
K3_BM = 128
K3_BK = 64
K3_BNS = (256, 160, 128)  # the kernel's instantiations (csrc/conv3x3.cu)
# the plan's cost model: the share of the tensor cores' peak a CTA reaches
# at each tile width (wider tiles reuse more of each A tile), and the
# split-K reduction's cost (partials written and read once in f32, one
# more launch)
_BN_EFF = {256: 1.0, 160: 0.92, 128: 0.85}
_PEAK_BF16 = 989e12
_PEAK_BYTES = 3.35e12
_LAUNCH_S = 4e-6
_MAX_SPLITS = 8


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


def k3_variant(ci: int, co: int) -> str:
    """The gate: "hopper" for Ci a multiple of 64, "general" for the other
    Ci; both need Ci and Co multiples of 8 (16-byte vectors)."""
    if ci % 8 or co % 8:
        raise ValueError(f"the CUDA 3x3 conv needs Ci and Co multiples of 8, "
                         f"got Ci={ci} Co={co}")
    return "hopper" if ci % K3_BK == 0 else "general"


def pack_weight(weight, dtype=torch.bfloat16, variant=None) -> torch.Tensor:
    """OIHW [Co, Ci, 3, 3] -> the packed weight of `variant` (default: the
    gate's) in `dtype`, one copy:
      general  [9 * Ci, Co]  HWIO flattened, row (dy * 3 + dx) * Ci + ci
      hopper   [Co, 9 * Ci]  OHWI flattened, column (dy * 3 + dx) * Ci + ci
                             (K-major, the wgmma B operand)"""
    co, ci = weight.shape[:2]
    variant = variant or k3_variant(ci, co)
    if variant == "hopper":
        out = torch.empty((co, 3, 3, ci), dtype=dtype, device=weight.device)
        out.copy_(weight.permute(0, 2, 3, 1))
        return out.view(co, 9 * ci)
    out = torch.empty((3, 3, ci, co), dtype=dtype, device=weight.device)
    out.copy_(weight.permute(2, 3, 1, 0))
    return out.view(9 * ci, co)


@dataclasses.dataclass(frozen=True)
class K3Plan:
    """The Hopper variant's grid for one shape. An M tile is one TMA box
    of output pixels: `box` = (bw, bh, bb) pixels along W, H and B, at
    most K3_BM of them, whole rows where a row fits; `tiles` = how many
    boxes cover (W, H, B). An N tile is `bn` output channels. `splits`
    cuts the 9 * Ci / 64 K-steps into that many contiguous ranges, summed
    in f32 by a second pass."""
    bn: int
    splits: int
    box: tuple[int, int, int]
    tiles: tuple[int, int, int]
    n_tiles: int
    k_steps: int

    @property
    def m_tiles(self) -> int:
        return math.prod(self.tiles)

    @property
    def units(self) -> int:
        """CTAs of the launch: M tiles x N tiles x K splits."""
        return self.m_tiles * self.n_tiles * self.splits

    def k_range(self, split: int) -> tuple[int, int]:
        """K-steps [lo, hi) of one split, as the kernel cuts them."""
        return (self.k_steps * split // self.splits,
                self.k_steps * (split + 1) // self.splits)


def _box(b: int, h: int, w: int) -> tuple[int, int, int]:
    bw = min(w, K3_BM)
    bh = min(h, K3_BM // bw) if bw == w else 1
    bb = min(b, K3_BM // (bw * bh)) if bw == w and bh == h else 1
    return bw, bh, bb


@functools.lru_cache(maxsize=None)
def k3_plan(b: int, h: int, w: int, ci: int, co: int) -> K3Plan:
    """The tile plan of the Hopper variant: the tile width BN and split-K
    count that minimise the modelled time. CTAs run in waves of 132 (one
    per SM), each wave as long as its CTAs' K-steps at BN's efficiency;
    a split adds its f32 round trip. Ties go to the wider tile."""
    if k3_variant(ci, co) != "hopper":
        raise ValueError(f"Ci={ci} is not in the Hopper variant's gate")
    box = _box(b, h, w)
    tiles = (-(-w // box[0]), -(-h // box[1]), -(-b // box[2]))
    m_tiles = math.prod(tiles)
    m = b * h * w
    k_steps = 9 * ci // K3_BK
    best = None
    for bn in K3_BNS:
        n_tiles = -(-co // bn)
        for splits in range(1, min(_MAX_SPLITS, k_steps) + 1):
            waves = -(-(m_tiles * n_tiles * splits) // _nvcc.H100_SMS)
            steps = -(-k_steps // splits)
            t = waves * steps * 2 * K3_BM * bn * K3_BK / (
                _PEAK_BF16 / _nvcc.H100_SMS * _BN_EFF[bn])
            if splits > 1:
                t += (2 * splits * 4 + 2) * m * co / _PEAK_BYTES + _LAUNCH_S
            if best is None or t < best[0] * (1 - 1e-9):
                best = (t, K3Plan(bn, splits, box, tiles, n_tiles, k_steps))
    return best[1]


_LIB = _nvcc.Library("conv3x3", conv3x3_fwd="ppppiiiiip",
                     conv3x3_hopper_fwd="pppppp" + "i" * 10 + "p",
                     conv3x3_hopper_smem="i")


def hopper_smem_bytes(bn: int) -> int:
    """Dynamic shared memory of the Hopper variant's instantiation for
    `bn` (its ring of stages, barriers and alignment slack)."""
    return _LIB.conv3x3_hopper_smem(bn)


def _check_x(x, align=0):
    if not x.is_cuda:
        raise ValueError("the CUDA 3x3 conv takes CUDA tensors")
    if x.dim() != 4:
        raise ValueError(f"x: want [B, Ci, H, W], got {tuple(x.shape)}")
    _nvcc.expect("x", x, torch.bfloat16, x.shape, x.device,
                 channels_last=True, align=align)


def _check(x, w_shape, w_packed, bias, co, align=0):
    _check_x(x, align)
    _nvcc.expect("w_packed", w_packed, torch.bfloat16, w_shape, x.device,
                 align=align)
    if bias is not None:
        _nvcc.expect("bias", bias, torch.float32, (co,), x.device)


def _out(x, co):
    b, _, h, w = x.shape
    return torch.empty((b, co, h, w), dtype=torch.bfloat16, device=x.device,
                       memory_format=torch.channels_last)


@_nvcc.counts("K3_general")
def conv3x3_general(x, w_packed, bias=None) -> torch.Tensor:
    """The general variant (wmma, cp.async) on the current stream; x as
    `conv3x3_cuda`, w_packed [9 * Ci, Co]."""
    b, ci, h, w = x.shape
    co = w_packed.shape[-1]
    _check(x, (9 * ci, co), w_packed, bias, co)
    y = _out(x, co)
    _nvcc.launch(conv3x3_general, _LIB.conv3x3_fwd, x.data_ptr(),
                 w_packed.data_ptr(),
                 None if bias is None else bias.data_ptr(), y.data_ptr(), b,
                 h, w, ci, co)
    return y


@_nvcc.counts("K3_hopper")
def conv3x3_hopper(x, w_packed, bias=None) -> torch.Tensor:
    """The Hopper variant (wgmma, TMA) on the current stream; x as
    `conv3x3_cuda` with Ci a multiple of 64, w_packed [Co, 9 * Ci]."""
    b, ci, h, w = x.shape
    co = w_packed.shape[0]
    # TMA reads x and w_packed from 16-byte aligned addresses
    _check(x, (co, 9 * ci), w_packed, bias, co, align=16)
    plan = k3_plan(b, h, w, ci, co)
    if plan.m_tiles > 65535:
        raise ValueError(f"{plan.m_tiles} M tiles: the Hopper variant's grid "
                         f"takes at most 65535")
    y = _out(x, co)
    part = None
    if plan.splits > 1:
        part = torch.empty((plan.splits, b * h * w, co), dtype=torch.float32,
                           device=x.device)
    _nvcc.launch(conv3x3_hopper, _LIB.conv3x3_hopper_fwd,
                 _nvcc.tensor_map_encoder(), x.data_ptr(),
                 w_packed.data_ptr(),
                 None if bias is None else bias.data_ptr(), y.data_ptr(),
                 None if part is None else part.data_ptr(), b, h, w, ci, co,
                 plan.bn, *plan.box, plan.splits)
    return y


@_nvcc.counts("K3")
def conv3x3_cuda(x, w_packed, bias=None) -> torch.Tensor:
    """K3 on the current stream: the variant `k3_variant` names. x: bf16
    [B, Ci, H, W] in channels_last memory; w_packed: bf16 from
    `pack_weight`; bias: f32 [Co] or None."""
    _check_x(x)
    ci = x.shape[1]
    # both packings hold 9 * Ci * Co values, so Co does not depend on which
    co = w_packed.numel() // (9 * ci)
    fn = conv3x3_hopper if k3_variant(ci, co) == "hopper" else conv3x3_general
    y = fn(x, w_packed, bias)
    conv3x3_cuda.launches += 1
    return y


def conv3x3_same(x, weight, bias=None) -> torch.Tensor:
    """Stride-1 SAME 3x3 conv (no autograd): K3 for a CUDA tensor, the
    plain version for a CPU tensor. The weight is cast to x's dtype."""
    if x.is_cuda:
        return conv3x3_cuda(
            x.contiguous(memory_format=torch.channels_last),
            pack_weight(weight, x.dtype),
            None if bias is None else bias.float().contiguous())
    return conv3x3_plain(x, weight.to(x.dtype), bias)
