"""K4, the VAE's fused GroupNorm + SiLU (ops/groupnorm_cuda.py): the
Function's CPU path (K4's plain version) against diffusion/norm.py:
group_norm (+ F.silu) and its autograd, the pixel split `plan` at every
GroupNorm shape of the VAE in the benchmark's cells, and a float32
emulation of the kernel's two passes each way on that split. The kernel
itself runs only on the card (chip_smoke.py holds it against its plain
version there); the tiny VAE's encode and gradient against the JAX package
run through the VAE's GroupNorms in tests/test_torch_diffusion.py."""

import math

import pytest
import torch
import torch.nn.functional as F

from gaussianip_tpu_torch import _nvcc
from gaussianip_tpu_torch.diffusion import vae as pvae
from gaussianip_tpu_torch.diffusion.norm import GroupNorm, group_norm
from gaussianip_tpu_torch.ops import groupnorm_cuda as k4

torch.set_num_threads(1)

EPS = 1e-6
# relative L2 gaps of the gradients. float32: both sides sum the same
# terms in float32 in other orders. bf16: the reference rounds the SiLU's
# gradient to bf16 (2^-9) before the affine's backward, K4 keeps it float32
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _inputs(b, c, h, w, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, c, h, w), generator=g) * 2.0 + 0.5
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    weight = 1.0 + 0.5 * torch.randn((c,), generator=g)
    bias = 0.3 * torch.randn((c,), generator=g)
    dy = torch.randn((b, c, h, w), generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last)
    return x, weight, bias, dy


def _reference(x, weight, bias, groups, silu):
    y = group_norm(x, weight, bias, groups, EPS)
    return F.silu(y) if silu else y


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("silu", [True, False], ids=["silu", "nosilu"])
@pytest.mark.parametrize("c,groups", [(128, 32), (256, 32), (512, 32)])
def test_function_matches_group_norm_silu(c, groups, silu, dtype):
    """The Function on CPU tensors (K4's plain version). Forward: the same
    bits as group_norm (+ F.silu), channels_last kept. Gradients of x,
    weight and bias: K4's closed form against autograd of the reference,
    within GRAD_TOL. `group_norm_silu` on CPU tensors is the reference,
    bit for bit, gradients included."""
    x, weight, bias, dy = _inputs(2, c, 6, 5, dtype, seed=c + silu)
    leaves = [t.clone().requires_grad_(True) for t in (x, weight, bias)]
    ref_leaves = [t.clone().requires_grad_(True) for t in (x, weight, bias)]
    y = k4.GroupNormSiLU.apply(*leaves, groups, EPS, silu)
    ref = _reference(*ref_leaves, groups, silu)
    assert y.dtype == dtype
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, ref)
    got = torch.autograd.grad(y, leaves, dy)
    want = torch.autograd.grad(ref, ref_leaves, dy)
    for name, a, b in zip(("dx", "dweight", "dbias"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel(a, b) < GRAD_TOL[dtype], (name, _rel(a, b))
    y = k4.group_norm_silu(*leaves, groups, EPS, silu)
    assert torch.equal(y, ref)
    for a, b in zip(torch.autograd.grad(y, leaves, dy), want):
        assert torch.equal(a, b)


def test_function_gives_only_the_gradients_asked_for():
    """A frozen module (the guidance's VAE) asks for dx alone; x alone
    frozen gets weight and bias gradients."""
    x, weight, bias, dy = _inputs(1, 64, 4, 4, torch.float32, seed=3)
    xl = x.clone().requires_grad_(True)
    y = k4.GroupNormSiLU.apply(xl, weight, bias, 32, EPS, True)
    (dx,) = torch.autograd.grad(y, [xl], dy)
    wl, bl = weight.clone().requires_grad_(True), bias.clone(
        ).requires_grad_(True)
    y = k4.GroupNormSiLU.apply(x, wl, bl, 32, EPS, True)
    dw, db = torch.autograd.grad(y, [wl, bl], dy)
    assert dx.shape == x.shape and dw.shape == db.shape == (64,)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise; the CPU path is the
    Function's."""
    x, weight, bias, dy = _inputs(1, 64, 4, 4, torch.float32, seed=4)
    with pytest.raises(ValueError, match="CUDA"):
        k4.groupnorm_fwd_cuda(x, weight, bias, 32, EPS, True)
    mean = torch.zeros(1, 32)
    with pytest.raises(ValueError, match="CUDA"):
        k4.groupnorm_bwd_cuda(dy, x, weight, bias, mean, mean, 32, EPS,
                              False)


def _vae_norm_shapes(batch: int, side: int, decode: bool):
    """(B, C, H, W, silu) of every VAEGroupNorm call of the SD VAE's encode
    of `batch` side^2 images (decode: of `batch` side^2 latents), on the
    meta device."""
    with torch.device("meta"):
        vae = pvae.AutoencoderKL(pvae.VAEConfig())
    seen = []
    for m in vae.modules():
        if isinstance(m, pvae.VAEGroupNorm):
            m.register_forward_pre_hook(
                lambda mod, args: seen.append((*args[0].shape, mod.silu)))
    with torch.no_grad():
        if decode:
            vae.decode(torch.empty(batch, 4, side, side, device="meta"))
        else:
            vae.encode(torch.empty(batch, 3, side, side, device="meta"))
    return seen


# the benchmark's cells: the stage-1 step's encode of 4 views at 512^2,
# the refine's encode of VAE_CHUNK = 2 views at 1024^2 and its decode of
# 2 latents at 128^2
VAE_CALLS = {"stage1_encode": (4, 512, False),
             "refine_encode": (2, 1024, False),
             "refine_decode": (2, 128, True)}


def test_stage1_encode_norms():
    """22 GroupNorms, 21 with the SiLU, 973.1 M elements a step."""
    shapes = _vae_norm_shapes(*VAE_CALLS["stage1_encode"])
    assert len(shapes) == 22
    assert sum(s[-1] for s in shapes) == 21
    assert sum(math.prod(s[:4]) for s in shapes) == 973_078_528


@pytest.mark.parametrize("call", sorted(VAE_CALLS))
def test_plan_covers_every_vae_shape(call):
    """At every GroupNorm shape of the cell: at least 2 blocks an SM, and
    the blocks' pixel ranges tile [0, H * W) once, none empty."""
    shapes = sorted({s[:4] for s in _vae_norm_shapes(*VAE_CALLS[call])})
    assert shapes
    for b, c, h, w in shapes:
        p = k4.plan(b, c, h, w)
        assert b * p.blocks >= 2 * _nvcc.H100_SMS, (b, c, h, w, p)
        covered = 0
        for j in range(p.blocks):
            lo, hi = p.pixel_range(j)
            assert lo == covered and hi > lo, (b, c, h, w, p, j)
            covered = hi
        assert covered == h * w


def _emulate_k4(x, weight, bias, dy, groups, silu):
    """K4's passes in float32 on the plan's blocks: per-(block, group)
    partials of each statistics pass, combined in block order by the apply
    passes. Returns (y, mean, rstd, dx, dweight, dbias)."""
    b, c, h, w = x.shape
    cpg = c // groups
    p = k4.plan(b, c, h, w)
    rows = lambda t: t.float().movedim(1, -1).reshape(b, h * w, c)
    xs, dys = rows(x), rows(dy)
    blocks = [slice(*p.pixel_range(j)) for j in range(p.blocks)]
    grouped = lambda t: t.reshape(*t.shape[:-1], groups, cpg).sum(-1)
    part = torch.stack([torch.stack([grouped(xs[:, s].sum(1)),
                                     grouped((xs[:, s] ** 2).sum(1))])
                        for s in blocks])  # [NB, 2, B, G]
    tot = part.sum(0)
    n = h * w * cpg
    mean = tot[0] / n
    rstd = torch.rsqrt((tot[1] / n - mean * mean).clamp(min=0.0) + EPS)
    chan = lambda t: t.repeat_interleave(cpg, dim=-1)[:, None, :]
    xhat = (xs - chan(mean)) * chan(rstd)
    a = xhat * weight + bias
    if silu:
        a = a.to(x.dtype).float()
        s = torch.sigmoid(a)
        y, g = a * s, dys * s * (1.0 + a * (1.0 - s))
    else:
        y, g = a, dys
    cpart = torch.stack([torch.stack([g[:, s].sum(1), (g * xhat)[:, s].sum(1)])
                         for s in blocks])  # [NB, 2, B, C]
    gsum = grouped(cpart * weight).sum(0) / n  # [2, B, G]
    dx = chan(rstd) * (g * weight - chan(gsum[0]) - xhat * chan(gsum[1]))
    back = lambda t: t.reshape(b, h, w, c).to(x.dtype).permute(0, 3, 1, 2)
    return (back(y), mean, rstd, back(dx), cpart[:, 1].sum((0, 1)),
            cpart[:, 0].sum((0, 1)))


@pytest.mark.parametrize("silu", [True, False], ids=["silu", "nosilu"])
@pytest.mark.parametrize("shape,groups", [((2, 64, 24, 24), 32),
                                          ((1, 128, 20, 36), 32),
                                          ((3, 32, 16, 20), 8)])
def test_kernel_passes_on_the_plan_match_the_plain_version(shape, groups,
                                                           silu):
    """The kernel's arithmetic on its own block split (float32 partials of
    (block, group), combined over the blocks) against the plain forward
    and backward, in float32: the sums only change order (rtol 1e-5)."""
    x, weight, bias, dy = _inputs(*shape, torch.float32, seed=shape[1])
    assert k4.plan(*shape).blocks > 1
    y, mean, rstd, dx, dw, db = _emulate_k4(x, weight, bias, dy, groups, silu)
    py, pmean, prstd = k4.groupnorm_fwd_plain(x, weight, bias, groups, EPS,
                                              silu)
    pdx, pdw, pdb = k4.groupnorm_bwd_plain(dy, x, weight, bias, pmean, prstd,
                                           groups, silu, True)
    for name, a, b in (("y", y, py), ("mean", mean, pmean),
                       ("rstd", rstd, prstd), ("dx", dx, pdx),
                       ("dweight", dw, pdw), ("dbias", db, pdb)):
        assert _rel(a, b) < 1e-5, (name, _rel(a, b))


def test_vae_norms_run_k4_and_the_unet_keeps_the_plain_formula():
    """Every GroupNorm of the VAE is a VAEGroupNorm (parameters `weight`,
    `bias` as GroupNorm's); the mid attention's alone has no SiLU."""
    from gaussianip_tpu_torch.diffusion import unet as punet

    vae = pvae.AutoencoderKL(pvae.tiny_vae_config())
    norms = {n: m for n, m in vae.named_modules() if isinstance(m, GroupNorm)}
    assert norms and all(isinstance(m, pvae.VAEGroupNorm)
                         for m in norms.values())
    assert {n for n, m in norms.items() if not m.silu} == {
        "encoder.mid_attn.group_norm", "decoder.mid_attn.group_norm"}
    assert all(sorted(k for k, _ in m.named_parameters()) == ["bias", "weight"]
               for m in norms.values())
    unet = punet.UNet2DConditionModel(punet.tiny_unet_config())
    assert not any(isinstance(m, pvae.VAEGroupNorm) for m in unet.modules())
