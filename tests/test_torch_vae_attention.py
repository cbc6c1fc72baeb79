"""K5, the VAE's single-head attention (ops/vae_attention_cuda.py): its
plain version (the Function's CPU path) against written-out float64
attention and its autograd, a float32 emulation of the kernel's
tile-by-tile row statistics at ragged token counts, the VAE's attention
module against its former SDPA form, and which attention each module
reaches. The kernel itself runs only on the card (chip_smoke.py:check_k5
holds it against its plain version there)."""

import math

import pytest
import torch
import torch.nn.functional as F

from gaussianip_tpu_torch.diffusion import blocks
from gaussianip_tpu_torch.diffusion import vae as pvae
from gaussianip_tpu_torch.ops import vae_attention_cuda as k5

torch.set_num_threads(1)

SHAPES = [(b, n, d) for b in (1, 3) for n in (200, 1000) for d in (32, 512)]
DTYPES = [torch.float32, torch.bfloat16]
# relative L2 gaps against float64. float32: sums of up to N terms in
# float32. bf16: P (and dS) rounded to bf16 (2^-9 relative) as operands of
# the products, and each output rounded once more
FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
LSE_TOL = 1e-5  # absolute: lse ~ log N + max S in float32


def _inputs(b, n, d, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, n, d), generator=g).to(dtype) for _ in range(4)]


def _reference(q, k, v):
    """Written-out attention in float64 on the inputs' values."""
    q, k, v = (t.double() for t in (q, k, v))
    s = q @ k.transpose(1, 2) / math.sqrt(q.shape[-1])
    return torch.softmax(s, dim=-1) @ v, torch.logsumexp(s, dim=-1)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _ids(p):
    return {torch.float32: "f32", torch.bfloat16: "bf16"}.get(p, None)


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
@pytest.mark.parametrize("b,n,d", SHAPES)
def test_plain_forward_matches_written_out_attention(b, n, d, dtype):
    """o and lse of K5's plain forward against float64 attention on the
    same values: o within FWD_TOL, lse within LSE_TOL; o in q's dtype."""
    q, k, v, _ = _inputs(b, n, d, dtype, seed=b * n + d)
    o, lse = k5.attention_fwd_plain(q, k, v)
    ro, rlse = _reference(q, k, v)
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == (b, n)
    assert _rel(o, ro) <= FWD_TOL[dtype]
    assert float((lse.double() - rlse).abs().max()) <= LSE_TOL


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
@pytest.mark.parametrize("b,n,d", SHAPES)
def test_plain_backward_matches_autograd(b, n, d, dtype):
    """K5's closed-form backward (dq, dk, dv from delta = rowsum(do * o),
    P and dS) against autograd of float64 attention, within BWD_TOL."""
    q, k, v, do = _inputs(b, n, d, dtype, seed=7 * b + n + d)
    o, lse = k5.attention_fwd_plain(q, k, v)
    grads = k5.attention_bwd_plain(do, q, k, v, o, lse)
    leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
    ro, _ = _reference(*leaves)
    want = torch.autograd.grad(ro, leaves, do.double())
    for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
        assert got.dtype == dtype, name
        assert _rel(got, ref) <= BWD_TOL[dtype], (name, _rel(got, ref))


def _emulated_lse(q, k, tile=k5.K5_TILE):
    """The STATS kernel's row statistics in float32, its order: per tile of
    `tile` keys (the last one masked at N), the row's max of S, then
    m = max(m, max * c), l = l 2^(m_old - m) + sum 2^(S c - m) with
    c = log2(e) / sqrt(d); lse = (m + log2 l) ln 2."""
    b, n, d = q.shape
    c = torch.tensor(math.log2(math.e) / math.sqrt(d), dtype=torch.float32)
    s = q.float() @ k.float().transpose(1, 2)
    m = torch.full((b, n), -math.inf)
    l = torch.zeros((b, n))
    for j0 in range(0, -(-n // tile) * tile, tile):
        t = s[..., j0:j0 + tile]  # the masked columns past N are absent
        m_new = torch.maximum(m, t.amax(dim=-1) * c)
        l = l * torch.exp2(m - m_new) + torch.exp2(
            t * c - m_new[..., None]).sum(dim=-1)
        m = m_new
    return (m + torch.log2(l)) * math.log(2.0)


@pytest.mark.parametrize("n", [1, 127, 128, 129, 200, 1000])
def test_tiled_row_statistics_match_logsumexp(n):
    """The kernel's online max and sum over 128-key tiles, emulated in
    float32, give the plain version's lse within LSE_TOL at token counts
    below, at and past a tile's edge."""
    q, k, _, _ = _inputs(2, n, 512, torch.bfloat16, seed=n)
    _, lse = k5.attention_fwd_plain(q, k, k)
    assert float((_emulated_lse(q, k) - lse).abs().max()) <= LSE_TOL


@pytest.mark.parametrize("channels,groups,hw", [(64, 8, (12, 10)),
                                                (512, 32, (8, 8))])
def test_vae_attention_module_unchanged_against_sdpa(channels, groups, hw):
    """VAEAttention (float32, on K5's plain version) against the same
    module computed with its former attention, blocks.attend (SDPA): the
    output and the gradients of x and of every weight within a relative L2
    gap of 1e-5 (float32 on both sides; at the worst element the query
    weight's gradient reads ~1e-5 against float64 on either side). The key
    bias's gradient, zero in exact arithmetic, stays within 1e-5 of the key
    weight's largest on both sides."""
    torch.manual_seed(channels)
    mod = pvae.VAEAttention(channels, groups, torch.float32)
    with torch.no_grad():  # a layer's usual scale: scores of unit spread
        for p in mod.parameters():
            p.normal_(0.0, channels ** -0.5 if p.dim() > 1 else 0.05)
    x = torch.randn((2, channels, *hw)).contiguous(
        memory_format=torch.channels_last)
    dy = torch.randn_like(x)

    def former(x):
        b, c, h, w = x.shape
        y = mod.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        o = mod.to_out(blocks.attend(mod.to_q(y), mod.to_k(y), mod.to_v(y),
                                     1))
        return x + o.reshape(b, h, w, c).permute(0, 3, 1, 2)

    results = []
    for fn in (mod, former):
        xg = x.clone().requires_grad_(True)
        out = fn(xg)
        grads = torch.autograd.grad(out, [xg, *mod.parameters()], dy)
        results.append((out, *grads))
    names = ["out", "dx"] + [n for n, _ in mod.named_parameters()]
    got_all = dict(zip(names, results[0]))
    want_all = dict(zip(names, results[1]))
    for name in names:
        if name != "to_k.bias":
            gap = _rel(got_all[name].detach(), want_all[name].detach())
            assert gap <= 1e-5, (name, gap)
    # a key bias adds one constant to a whole row of scores: its gradient is
    # zero in exact arithmetic, so both sides' rounding noise is held
    # against the key weight's gradient instead
    key_scale = float(want_all["to_k.weight"].abs().max())
    for side in (got_all, want_all):
        assert float(side["to_k.bias"].abs().max()) <= 1e-5 * key_scale


def _count(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kw):
        calls.append(1)
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_vae_reaches_k5_and_the_unet_attend(monkeypatch):
    """The tiny VAE's encode and decode run their two mid attentions
    through K5's Function (its plain forward on the CPU) and never reach
    blocks.attend or SDPA; the UNet's Attention still reaches
    blocks.attend."""
    attend = _count(monkeypatch, blocks, "attend")
    sdpa = _count(monkeypatch, F, "scaled_dot_product_attention")
    plain = _count(monkeypatch, k5, "attention_fwd_plain")
    torch.manual_seed(0)
    vae = pvae.AutoencoderKL(pvae.tiny_vae_config())
    x = torch.rand((1, 3, 16, 16)) * 2 - 1
    with torch.no_grad():
        vae(x)
    assert (len(attend), len(sdpa), len(plain)) == (0, 0, 2)
    att = blocks.Attention(32, heads=2)
    att(torch.randn((1, 5, 32)))
    assert len(attend) == 1 and len(sdpa) == 1


def test_function_saves_nothing_n_by_n():
    """What the Function keeps for the backward is q, k, v, o ([B, N, d])
    and lse ([B, N]): no N x N tensor lives between the two passes."""
    q, k, v, _ = (t.requires_grad_(True)
                  for t in _inputs(2, 300, 32, torch.float32, seed=3))
    o = k5.vae_attention(q, k, v)
    saved = o.grad_fn.saved_tensors
    assert len(saved) == 5
    assert max(t.numel() for t in saved) == q.numel()


def test_cuda_wrappers_refuse_cpu_tensors():
    """K5's wrappers take CUDA tensors only: a CPU tensor raises before
    anything is built or launched."""
    q, k, v, do = _inputs(1, 64, 32, torch.bfloat16, seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        k5.attention_fwd_cuda(q, k, v)
    lse = torch.zeros((1, 64))
    with pytest.raises(ValueError, match="CUDA"):
        k5.attention_bwd_cuda(do, q, k, v, q, lse)


@pytest.mark.parametrize("b", [1, 4])
def test_launch_counts(b):
    """A forward of b views launches STATS once and PROBS per view; a
    backward ROWDOT once and GRADS per view: 5 each at the stage-1
    encode's 4 views."""
    assert k5.fwd_launches(b) == 1 + b and k5.bwd_launches(b) == 1 + b
