"""Single-head softmax attention with a wide head: the hand-written CUDA
kernel K5 (csrc/vae_attention.cu) behind a torch.autograd.Function, and its
plain PyTorch version. The VAE's mid-block attention (diffusion/vae.py:
VAEAttention, one head of 512 channels over every latent pixel) runs it.

    q, k, v, o  [B, N, d] bf16 or float32, contiguous; d a multiple of 32
                up to 512
    lse         [B, N] float32: logsumexp over the keys of S = q k^T / sqrt(d)
    o           softmax(S) v, in q's dtype

K5 replaces no TPU kernel (gaussianip_tpu/diffusion/blocks.py:_attend
leaves this attention to XLA). SDPA takes a 512-wide head only on its
memory-efficient backend, far below the tensor cores' rate. K5 keeps the
N x N work apart from the d-deep products:
  forward   one STATS launch (lse of every view), then per view one PROBS
            launch (P = exp(S - lse), rounded to q's dtype, into an [N, ld]
            buffer) and o = P v by torch.mm;
  backward  one ROWDOT launch (delta = rowsum(dO * o), float32), then per
            view one GRADS launch (P and dS = P (dP - delta) / sqrt(d),
            dP = dO v^T, both rounded) and dV = P^T dO, dQ = dS k,
            dK = dS^T q by torch.mm (float32 accumulation).
The Function saves q, k, v, o and lse, as flash attention does; the
[N, ld] buffers live only inside one call (ld: N rounded up to 8, so that
the kernels store 16 bytes a lane).

`vae_attention` runs K5 on CUDA tensors through `VAEAttentionFn` or
raises; each wrapper counts its kernels in `.launches`. On CPU tensors the
Function runs the plain version: `attention_fwd_plain` (written-out
attention with float32 statistics, P rounded to q's dtype before P v) and
`attention_bwd_plain` (the closed form the kernels compute), so the CPU
tests reach K5's arithmetic.
"""

from __future__ import annotations

import math

import torch

from .. import _nvcc

K5_TILE = 128  # the bf16 kernel's 128 x 128 tiles of S (csrc/vae_attention.cu)
K5_MAX_D = 512
STATS, PROBS, GRADS = 0, 1, 2


def _scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


def _ld(n: int) -> int:
    """The row stride of the [N, ld] P / dS buffers: N rounded up to 8."""
    return -(-n // 8) * 8


def fwd_launches(b: int) -> int:
    """K5's kernels in a forward of b views: STATS, then PROBS per view."""
    return 1 + b


def bwd_launches(b: int) -> int:
    """K5's kernels in a backward of b views: ROWDOT, then GRADS per view."""
    return 1 + b


# ---------------------------------------------------------------- plain ---

def _scores(q, k):
    """S = q k^T / sqrt(d) in float32 [B, N, N]."""
    return torch.matmul(q.float(), k.float().transpose(1, 2)) * _scale(
        q.shape[-1])


def attention_fwd_plain(q, k, v):
    """(o in q's dtype, lse [B, N] float32): P = exp(S - lse) rounded to q's
    dtype, o = P v summed in float32."""
    s = _scores(q, k)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype), lse


def attention_bwd_plain(do, q, k, v, o, lse):
    """(dq, dk, dv) in q's dtype, the closed form K5 computes: delta =
    rowsum(do * o), P = exp(S - lse), dS = P (dP - delta) / sqrt(d) with
    dP = do v^T, all float32; P and dS rounded to q's dtype as the operands
    of dv = P^T do, dq = dS k, dk = dS^T q (float32 sums)."""
    dt = q.dtype
    delta = (do.float() * o.float()).sum(dim=-1)
    p = torch.exp(_scores(q, k) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    ds = (p * (dp - delta[..., None]) * _scale(q.shape[-1])).to(dt).float()
    p = p.to(dt).float()
    dv = torch.matmul(p.transpose(1, 2), do.float())
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(1, 2), q.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


# ----------------------------------------------------------------- K5 ---

_LIB = _nvcc.Library("vae_attention",
                     k5_scores="pii" + "p" * 8 + "liiiiffp",
                     k5_rowdot="ippplip")


def _check(*named):
    """Raise unless every (name, t) is a contiguous CUDA [B, N, d] tensor
    of the first one's dtype, device and shape, inside K5's contract."""
    q = named[0][1]
    if not q.is_cuda:
        raise ValueError("K5 takes CUDA tensors")
    if q.dim() != 3 or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q: want bf16 or float32 [B, N, d], got {q.dtype} "
                         f"{tuple(q.shape)}")
    b, n, d = q.shape
    if d % 32 or not 32 <= d <= K5_MAX_D or not 1 <= b <= 65535 or n < 1:
        raise ValueError(f"K5 takes d a multiple of 32 up to {K5_MAX_D} and "
                         f"B up to 65535; got B={b} N={n} d={d}")
    for name, t in named:
        _nvcc.expect(name, t, q.dtype, q.shape, q.device)
    return b, n, d


def _scores_launch(mode, q, k, do, v, lse, delta, p, ds, view):
    b, n, d = q.shape
    scale = _scale(d)
    _nvcc.launch(
        attention_bwd_cuda if mode == GRADS else attention_fwd_cuda,
        _LIB.k5_scores, _nvcc.tensor_map_encoder(), mode,
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
        None if do is None else do.data_ptr(),
        None if v is None else v.data_ptr(), lse.data_ptr(),
        None if delta is None else delta.data_ptr(),
        None if p is None else p.data_ptr(),
        None if ds is None else ds.data_ptr(), _ld(n), b, n, d, view,
        scale * math.log2(math.e), scale)


@_nvcc.counts("K5_fwd")
def attention_fwd_cuda(q, k, v):
    """K5's forward on the current stream: (o, lse) as
    `attention_fwd_plain`; `fwd_launches(B)` kernels."""
    b, n, d = _check(("q", q), ("k", k), ("v", v))
    lse = torch.empty((b, n), dtype=torch.float32, device=q.device)
    _scores_launch(STATS, q, k, None, None, lse, None, None, None, 0)
    o = torch.empty_like(q)
    p = torch.empty((n, _ld(n)), dtype=q.dtype, device=q.device)
    for i in range(b):
        _scores_launch(PROBS, q, k, None, None, lse, None, p, None, i)
        torch.mm(p[:, :n], v[i], out=o[i])
    return o, lse


@_nvcc.counts("K5_bwd")
def attention_bwd_cuda(do, q, k, v, o, lse):
    """K5's backward on the current stream: (dq, dk, dv) as
    `attention_bwd_plain`; `bwd_launches(B)` kernels."""
    b, n, d = _check(("q", q), ("do", do), ("k", k), ("v", v), ("o", o))
    _nvcc.expect("lse", lse, torch.float32, (b, n), q.device)
    delta = torch.empty((b, n), dtype=torch.float32, device=q.device)
    _nvcc.launch(attention_bwd_cuda, _LIB.k5_rowdot,
                 int(q.dtype == torch.bfloat16), do.data_ptr(), o.data_ptr(),
                 delta.data_ptr(), b * n, d)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    p = torch.empty((n, _ld(n)), dtype=q.dtype, device=q.device)
    ds = torch.empty_like(p)
    pn, dsn = p[:, :n], ds[:, :n]
    for i in range(b):
        _scores_launch(GRADS, q, k, do, v, lse, delta, p, ds, i)
        torch.mm(pn.t(), do[i], out=dv[i])
        torch.mm(dsn, k[i], out=dq[i])
        torch.mm(dsn.t(), q[i], out=dk[i])
    return dq, dk, dv


class VAEAttentionFn(torch.autograd.Function):
    """apply(q, k, v) -> o: K5 on CUDA tensors, its plain version on CPU
    tensors."""

    @staticmethod
    def forward(ctx, q, k, v):
        fwd = attention_fwd_cuda if q.is_cuda else attention_fwd_plain
        o, lse = fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = attention_bwd_cuda if q.is_cuda else attention_bwd_plain
        return bwd(do.contiguous(), q, k, v, o, lse)


def vae_attention(q, k, v) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over [B, N, d], one head; differentiable
    in q, k and v. K5 for CUDA tensors, its plain version for CPU ones."""
    return VAEAttentionFn.apply(q.contiguous(), k.contiguous(),
                                v.contiguous())
