"""GroupNorm with an optional SiLU fused in: the hand-written CUDA kernel K4
(csrc/groupnorm.cu) behind a torch.autograd.Function, and its plain
PyTorch version. Every GroupNorm of the VAE (diffusion/vae.py) runs it.

    x       [B, C, H, W] in channels_last memory, bf16 or float32
    weight  [C], bias [C]: float32 (the wrapper casts other dtypes)
    y       silu(group_norm(x)) or group_norm(x), in x's dtype
    mean, rstd  [B, G] float32, saved for the backward

K4 replaces no TPU kernel. The JAX package's FastGroupNorm is a layout
trick for XLA; as eager PyTorch (diffusion/norm.py:group_norm, then F.silu)
it is ~10 full-size passes forward, eight in float32, and autograd keeps
float32 intermediates for a backward of ~25-35 more. The work is bound by
bytes: K4 makes two passes each way, a statistics pass and an apply pass,
so the forward reads x twice and writes y (6 B an element in bf16), the
backward reads x and dy twice and writes dx (10 B). It saves nothing
full-size: the backward recomputes from x and the [B, G] statistics.

`group_norm_silu` runs K4 on a CUDA tensor, through the Function
`GroupNormSiLU`: two kernels forward (`groupnorm_fwd_cuda`) and two
backward (`groupnorm_bwd_cuda`), or it raises; each wrapper counts its
kernels in `.launches`. On a CPU tensor it runs today's formula,
`group_norm` then `F.silu`, and autograd differentiates it. The plain
version of K4 itself is `groupnorm_fwd_plain` (that formula, with the
statistics) and `groupnorm_bwd_plain` (the closed form the kernel
computes, float32 throughout, rounding only dx to x's dtype); the
Function runs them on CPU tensors, so the tests reach K4's arithmetic.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from .. import _nvcc
from ..diffusion.norm import group_norm, group_norm_stats

K4_THREADS = 256  # a block's threads (csrc/groupnorm.cu)
K4_BLOCKS = 4 * _nvcc.H100_SMS  # the blocks a pass aims for: ~4 an SM
K4_MAX_GROUPS = 512
FWD_KERNELS = 2  # statistics pass, apply pass
BWD_KERNELS = 2
_VEC = {torch.bfloat16: 8, torch.float32: 4}  # elements in 16 bytes


@dataclasses.dataclass(frozen=True)
class K4Plan:
    """The pixel split of one shape: each batch item's H * W pixels cut
    into `blocks` contiguous ranges of `pixels` (the last one shorter),
    one block of every pass each."""
    hw: int
    blocks: int
    pixels: int

    def pixel_range(self, j: int) -> tuple[int, int]:
        """Pixels [lo, hi) of block j, as the kernels cut them."""
        return j * self.pixels, min(self.hw, (j + 1) * self.pixels)


@functools.lru_cache(maxsize=None)
def plan(b: int, c: int, h: int, w: int) -> K4Plan:
    """K4's pixel split for x [b, c, h, w]: about K4_BLOCKS blocks over the
    batch, each a whole number of the block's sweeps (a sweep: one 16-byte
    bf16 vector a thread, K4_THREADS / (c / 8) pixels), none empty."""
    hw = h * w
    sweep = max(1, K4_THREADS // max(1, c // 8))
    blocks = max(1, min(-(-K4_BLOCKS // b), -(-hw // sweep)))
    pixels = -(-hw // blocks)
    pixels = -(-pixels // sweep) * sweep
    return K4Plan(hw, -(-hw // pixels), pixels)


# ---------------------------------------------------------------- plain ---

def groupnorm_fwd_plain(x, weight, bias, groups: int, eps: float,
                        silu: bool):
    """`group_norm` (then `F.silu` when `silu`): (y, mean [B, G],
    rstd [B, G])."""
    y, mean, rstd = group_norm_stats(x, weight, bias, groups, eps)
    b = x.shape[0]
    return ((F.silu(y) if silu else y), mean.reshape(b, groups),
            rstd.reshape(b, groups))


def groupnorm_bwd_plain(dy, x, weight, bias, mean, rstd, groups: int,
                        silu: bool, need_wb: bool):
    """The backward in K4's closed form, float32 throughout:
    (dx in x's dtype, dweight [C] or None, dbias [C] or None)."""
    b, c = x.shape[:2]
    cpg = c // groups
    split = lambda t: t.float().movedim(1, -1).reshape(b, -1, groups, cpg)
    mu = mean[:, None, :, None]
    rs = rstd[:, None, :, None]
    xhat = (split(x) - mu) * rs
    wg = weight.float().reshape(groups, cpg)
    g = split(dy)
    if silu:
        a = (xhat * wg + bias.float().reshape(groups, cpg)).to(x.dtype)
        s = torch.sigmoid(a.float())
        g = g * s * (1.0 + a.float() * (1.0 - s))
    dxhat = g * wg
    n = xhat.shape[1] * cpg
    m1 = dxhat.sum(dim=(1, 3), keepdim=True) / n
    m2 = (dxhat * xhat).sum(dim=(1, 3), keepdim=True) / n
    dx = rs * (dxhat - m1 - xhat * m2)
    dx = dx.reshape(x.movedim(1, -1).shape).to(x.dtype).movedim(-1, 1)
    if not need_wb:
        return dx, None, None
    return dx, (g * xhat).sum(dim=(0, 1)).reshape(c), g.sum(
        dim=(0, 1)).reshape(c)


# ----------------------------------------------------------------- K4 ---

_LIB = _nvcc.Library("groupnorm",
                     groupnorm_fwd="ii" + "p" * 7 + "i" * 6 + "fp",
                     groupnorm_bwd="ii" + "p" * 9 + "i" * 6 + "p")


def _geometry(x, groups: int):
    """(b, c, h, w, plan) of x, or ValueError outside K4's contract."""
    if not x.is_cuda:
        raise ValueError("K4 takes CUDA tensors")
    if x.dim() != 4 or x.dtype not in _VEC:
        raise ValueError(f"x: want bf16 or float32 [B, C, H, W], got "
                         f"{x.dtype} {tuple(x.shape)}")
    b, c, h, w = x.shape
    vec = _VEC[x.dtype]
    if c % vec or c // vec > K4_THREADS or c % groups \
            or not 0 < groups <= K4_MAX_GROUPS or not 0 < b <= 65535:
        raise ValueError(f"K4 takes C a multiple of {vec} up to "
                         f"{K4_THREADS * vec}, at most {K4_MAX_GROUPS} groups "
                         f"that divide it and B up to 65535; got B={b} C={c} "
                         f"G={groups}")
    _nvcc.expect("x", x, x.dtype, x.shape, x.device, channels_last=True,
                 align=16)
    return b, c, h, w, plan(b, c, h, w)


def _check_params(x, weight, bias):
    for name, t in (("weight", weight), ("bias", bias)):
        _nvcc.expect(name, t, torch.float32, (x.shape[1],), x.device)


@_nvcc.counts("K4_fwd")
def groupnorm_fwd_cuda(x, weight, bias, groups: int, eps: float,
                       silu: bool):
    """K4's forward on the current stream: (y, mean, rstd) as
    `groupnorm_fwd_plain`. x as the module docstring; weight, bias
    contiguous float32 [C] on x's device."""
    b, c, h, w, p = _geometry(x, groups)
    _check_params(x, weight, bias)
    y = torch.empty_like(x)
    part = torch.empty((b, groups, 2, p.blocks), dtype=torch.float32,
                       device=x.device)
    mean = torch.empty((b, groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    _nvcc.launch(groupnorm_fwd_cuda, _LIB.groupnorm_fwd,
                 int(x.dtype == torch.bfloat16), int(silu), x.data_ptr(),
                 weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                 part.data_ptr(), mean.data_ptr(), rstd.data_ptr(), b, h * w,
                 c, groups, p.blocks, p.pixels, eps, count=FWD_KERNELS)
    return y, mean, rstd


@_nvcc.counts("K4_bwd")
def groupnorm_bwd_cuda(dy, x, weight, bias, mean, rstd, groups: int,
                       silu: bool, need_wb: bool):
    """K4's backward on the current stream: (dx, dweight, dbias) as
    `groupnorm_bwd_plain`; dweight and dbias sum the kernel's per-block
    partials over (batch, block) when `need_wb`."""
    b, c, h, w, p = _geometry(x, groups)
    _nvcc.expect("dy", dy, x.dtype, x.shape, x.device, channels_last=True,
                 align=16)
    _check_params(x, weight, bias)
    for name, t in (("mean", mean), ("rstd", rstd)):
        _nvcc.expect(name, t, torch.float32, (b, groups), x.device)
    dx = torch.empty_like(x)
    part = torch.empty((b, groups, 2, p.blocks), dtype=torch.float32,
                       device=x.device)
    cpart = torch.empty((b * p.blocks, 2, c), dtype=torch.float32,
                        device=x.device) if need_wb else None
    _nvcc.launch(groupnorm_bwd_cuda, _LIB.groupnorm_bwd,
                 int(x.dtype == torch.bfloat16), int(silu), x.data_ptr(),
                 dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                 weight.data_ptr(), bias.data_ptr(), dx.data_ptr(),
                 part.data_ptr(), None if cpart is None else cpart.data_ptr(),
                 b, h * w, c, groups, p.blocks, p.pixels, count=BWD_KERNELS)
    if not need_wb:
        return dx, None, None
    sums = cpart.sum(dim=0)
    return dx, sums[1], sums[0]


class GroupNormSiLU(torch.autograd.Function):
    """apply(x, weight, bias, groups, eps, silu): K4 on CUDA tensors, its
    plain version on CPU tensors."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, silu):
        fwd = groupnorm_fwd_cuda if x.is_cuda else groupnorm_fwd_plain
        y, mean, rstd = fwd(x, weight, bias, groups, eps, silu)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        ctx.cfg = (groups, silu)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        groups, silu = ctx.cfg
        need = ctx.needs_input_grad
        if x.is_cuda:
            dy = dy.contiguous(memory_format=torch.channels_last)
            bwd = groupnorm_bwd_cuda
        else:
            bwd = groupnorm_bwd_plain
        dx, dw, db = bwd(dy, x, weight, bias, mean, rstd, groups, silu,
                         need[1] or need[2])
        return (dx if need[0] else None, dw if need[1] else None,
                db if need[2] else None, None, None, None)


def group_norm_silu(x, weight, bias, groups: int, eps: float,
                    silu: bool) -> torch.Tensor:
    """silu(group_norm(x)) when `silu`, else group_norm(x); differentiable
    in x, weight and bias. K4 for a CUDA tensor, today's formula under
    autograd for a CPU one."""
    if not x.is_cuda:
        y = group_norm(x, weight, bias, groups, eps)
        return F.silu(y) if silu else y
    return GroupNormSiLU.apply(
        x.contiguous(memory_format=torch.channels_last),
        weight.float().contiguous(), bias.float().contiguous(), groups, eps,
        silu)
