"""The port's 3x3 conv (K3's plain version, its autograd and the Conv3x3
module) against the JAX package's Pallas kernel in interpret mode, on the
same numpy inputs. The JAX side is NHWC / HWIO, the port NCHW / OIHW."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from gaussianip_tpu.ops.conv_pallas import _conv3x3_pallas, conv3x3 as jconv

torch.set_num_threads(1)


def _inputs(rng, b, h, w, ci, co):
    x = rng.normal(0, 1, (b, h, w, ci)).astype(np.float32)
    k = rng.normal(0, 0.05, (3, 3, ci, co)).astype(np.float32)
    return x, k


def _nchw(x):
    return t(x).permute(0, 3, 1, 2)


def _oihw(k):
    return t(k).permute(3, 2, 0, 1)


@pytest.mark.parametrize("shape", [
    (2, 16, 16, 128, 128),
    (1, 13, 16, 128, 256),
    (2, 8, 24, 256, 128),
])
def test_conv3x3_plain_matches_pallas(rng, shape):
    """atol 2e-5 as tests/test_conv_pallas.py: both sum 9 * Ci f32
    products in another order."""
    from gaussianip_tpu_torch.ops.conv3x3_cuda import conv3x3_plain

    b, h, w, ci, co = shape
    x, k = _inputs(rng, b, h, w, ci, co)
    ref = _conv3x3_pallas(jnp.asarray(x), jnp.asarray(k), interpret=True)
    got = conv3x3_plain(_nchw(x), _oihw(k)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=2e-5,
                               rtol=1e-5)


def test_conv3x3_gradients_match_jax(rng):
    """dx (K3's plain version on the rotated weights), dW and dbias against
    jax.grad of conv3x3(..., interpret=True); atol 2e-3 as the JAX test
    (sums over 128 f32 terms of size ~10)."""
    from gaussianip_tpu_torch.ops.conv3x3 import conv3x3

    b, h, w, ci, co = 1, 8, 16, 128, 128
    x, k = _inputs(rng, b, h, w, ci, co)
    bias = rng.normal(0, 1, (co,)).astype(np.float32)
    jg = jax.grad(lambda x, k, bb: jnp.sum(jconv(x, k, bb, interpret=True)
                                           ** 2), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias))
    xt = _nchw(x).requires_grad_(True)
    kt = _oihw(k).requires_grad_(True)
    bt = t(bias).requires_grad_(True)
    (conv3x3(xt, kt, bt) ** 2).sum().backward()
    for got, ref in ((xt.grad.permute(0, 2, 3, 1), jg[0]),
                     (kt.grad.permute(2, 3, 1, 0), jg[1]),
                     (bt.grad, jg[2])):
        np.testing.assert_allclose(n(got), np.asarray(ref), atol=2e-3,
                                   rtol=1e-4)


def test_conv3x3_module_matches_jax(rng):
    """Conv3x3 at stride 1 and 2 against the flax module on carried-over
    params (the port's stride 2 is F.conv2d with padding 1)."""
    from gaussianip_tpu.ops.conv_pallas import Conv3x3 as JConv3x3
    from gaussianip_tpu_torch.diffusion.from_flax import from_flax
    from gaussianip_tpu_torch.ops.conv3x3 import Conv3x3

    x = rng.normal(0, 1, (2, 8, 8, 32)).astype(np.float32)
    params = {"params": {
        "kernel": rng.normal(0, 0.1, (3, 3, 32, 48)).astype(np.float32),
        "bias": rng.normal(0, 1, (48,)).astype(np.float32)}}
    for stride in (1, 2):
        ref = JConv3x3(48, stride=stride).apply(params, jnp.asarray(x))
        mod = from_flax(Conv3x3(32, 48, stride=stride), params)
        got = mod(_nchw(x)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)


def test_pack_weight_layout(rng):
    """Row (dy * 3 + dx) * Ci + ci, column co of the packed weight is
    weight[co, ci, dy, dx]."""
    from gaussianip_tpu_torch.ops.conv3x3_cuda import pack_weight

    w = t(rng.normal(0, 1, (16, 8, 3, 3)).astype(np.float32))
    p = pack_weight(w, torch.float32)
    assert p.shape == (72, 16) and p.is_contiguous()
    for dy, dx, ci, co in ((0, 0, 0, 0), (1, 2, 5, 3), (2, 1, 7, 15)):
        assert p[(dy * 3 + dx) * 8 + ci, co] == w[co, ci, dy, dx]


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """The dispatcher and each variant refuse CPU tensors before any build
    or launch (a host pointer must never reach a kernel), whichever variant
    the gate names."""
    from gaussianip_tpu_torch.ops import conv3x3_cuda as k3

    for ci, w_shape in ((8, (72, 8)), (64, (8, 576))):
        x = torch.zeros((1, ci, 4, 4), dtype=torch.bfloat16)
        w = torch.zeros(w_shape, dtype=torch.bfloat16)
        for fn in (k3.conv3x3_cuda, k3.conv3x3_general, k3.conv3x3_hopper):
            with pytest.raises(ValueError, match="CUDA tensors"):
                fn(x, w)
    assert k3.conv3x3_cuda.launches == 0
    assert k3.conv3x3_general.launches == k3.conv3x3_hopper.launches == 0


# The stride-1 Conv3x3 shapes (H = W, Ci, Co) of the SD1.5 UNet + ControlNet
# at 64^2 latents, as the guided step meets them (chip_smoke.py phase k3)
GUIDED_SHAPES = [
    (64, 320, 320), (64, 960, 320), (64, 640, 320), (64, 640, 640),
    (32, 320, 640), (32, 640, 640), (32, 1920, 640), (32, 1280, 640),
    (32, 960, 640), (32, 1280, 1280),
    (16, 640, 1280), (16, 1280, 1280), (16, 2560, 1280), (16, 1920, 1280),
    (8, 1280, 1280), (8, 2560, 1280)]
# each shape forward, and its dx (the weight's channels swapped)
PLAN_SHAPES = [(h, ci, co) for h, ci, co in GUIDED_SHAPES] + \
    [(h, co, ci) for h, ci, co in GUIDED_SHAPES]


def _tile_origins(plan):
    bw, bh, bb = plan.box
    tx, ty, _ = plan.tiles
    for m_tile in range(plan.m_tiles):
        yield ((m_tile % tx) * bw, m_tile // tx % ty * bh,
               m_tile // (tx * ty) * bb)


def _tile_rows(plan, x0, y0, b0, b, h, w):
    """(row, b, y, x) of the tile's rows that lie inside the output, in the
    order the kernel's box and epilogue use."""
    bw, bh, bb = plan.box
    for r in range(bw * bh * bb):
        bi, rem = divmod(r, bw * bh)
        yi, xi = divmod(rem, bw)
        if b0 + bi < b and y0 + yi < h and x0 + xi < w:
            yield r, b0 + bi, y0 + yi, x0 + xi


@pytest.mark.parametrize("h,ci,co", PLAN_SHAPES)
def test_k3_plan_covers_the_guided_shapes(h, ci, co):
    """Every guided shape and its dx at batch 12 is in the Hopper gate; its
    plan covers every output pixel and channel exactly once, cuts the
    K-steps into contiguous ranges, and launches at least 120 CTAs (132
    SMs; one CTA of 384 threads and ~200 KB of shared memory per SM)."""
    from gaussianip_tpu_torch.ops import conv3x3_cuda as k3

    b = 12
    assert k3.k3_variant(ci, co) == "hopper"
    plan = k3.k3_plan(b, h, h, ci, co)
    assert plan.bn in k3.K3_BNS and math.prod(plan.box) <= k3.K3_BM
    seen = np.zeros((b, h, h), np.int32)
    for x0, y0, b0 in _tile_origins(plan):
        for _, bi, yi, xi in _tile_rows(plan, x0, y0, b0, b, h, h):
            seen[bi, yi, xi] += 1
    assert (seen == 1).all()
    cols = np.zeros(co, np.int32)
    for n_tile in range(plan.n_tiles):
        cols[n_tile * plan.bn:(n_tile + 1) * plan.bn] += 1
    assert (cols == 1).all() and (plan.n_tiles - 1) * plan.bn < co
    steps = [k for s in range(plan.splits) for k in range(*plan.k_range(s))]
    assert steps == list(range(9 * ci // 64)) and plan.k_steps == len(steps)
    assert all(hi > lo for lo, hi in map(plan.k_range, range(plan.splits)))
    assert plan.units >= 120


def _emulate_hopper(x, w_packed, bias, plan):
    """numpy model of csrc/conv3x3.cu:conv3x3_wgmma_kernel on NHWC float32
    x and the [Co, 9 * Ci] packed weight: per CTA (M tile, N tile, split)
    and per K-step (one tap, 64 channels) the tap-shifted box of pixels with
    zeros outside x (TMA's fill) times the weight's 64 x BN slice, summed in
    f32; the splits summed, then the bias."""
    b, h, w, ci = x.shape
    co = w_packed.shape[0]
    cblocks = ci // 64
    part = np.zeros((plan.splits, b, h, w, co), np.float32)
    for x0, y0, b0 in _tile_origins(plan):
        rows = list(_tile_rows(plan, x0, y0, b0, b, h, w))
        for n_tile in range(plan.n_tiles):
            n0 = n_tile * plan.bn
            nn = min(plan.bn, co - n0)
            for split in range(plan.splits):
                acc = np.zeros((64 * 2, plan.bn), np.float32)
                for k in range(*plan.k_range(split)):
                    tap, cb = divmod(k, cblocks)
                    dy, dx = divmod(tap, 3)
                    a = np.zeros((64 * 2, 64), np.float32)
                    for r, bi, yi, xi in rows:
                        ys, xs = yi + dy - 1, xi + dx - 1
                        if 0 <= ys < h and 0 <= xs < w:
                            a[r] = x[bi, ys, xs, cb * 64:(cb + 1) * 64]
                    bt = np.zeros((plan.bn, 64), np.float32)
                    bt[:nn] = w_packed[n0:n0 + nn, k * 64:(k + 1) * 64]
                    acc += a @ bt.T
                for r, bi, yi, xi in rows:
                    part[split, bi, yi, xi, n0:n0 + nn] = acc[r, :nn]
    y = part.sum(0)
    return y if bias is None else y + bias


@pytest.mark.parametrize("b,h,w,ci,co,override", [
    (1, 5, 24, 64, 40, {}),                         # ragged M and N
    (1, 8, 8, 192, 40, {}),                         # W = 8, one image
    (3, 8, 8, 64, 48, {}),                          # 2 images a tile, odd B
    (2, 6, 24, 192, 40, {"splits": 3, "bn": 160}),  # split K, wide tile
    (1, 3, 8, 64, 16, {"splits": 2}),               # whole image < a box
])
def test_k3_hopper_decomposition_matches_plain(rng, b, h, w, ci, co,
                                               override):
    """The Hopper variant's tiling, K-steps, zero fill, packed layout and
    split sums, emulated in numpy, against conv3x3_plain (both float32:
    sums of 9 * Ci products in another order, atol 1e-4)."""
    from gaussianip_tpu_torch.ops import conv3x3_cuda as k3

    x, k = _inputs(rng, b, h, w, ci, co)
    bias = rng.normal(0, 1, (co,)).astype(np.float32)
    plan = dataclasses.replace(k3.k3_plan(b, h, w, ci, co), **override)
    if "bn" in override:
        plan = dataclasses.replace(plan, n_tiles=-(-co // plan.bn))
    wp = k3.pack_weight(_oihw(k), torch.float32)
    got = _emulate_hopper(x, n(wp), bias, plan)
    ref = k3.conv3x3_plain(_nchw(x), _oihw(k), t(bias)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got, n(ref), atol=1e-4, rtol=1e-5)


def test_k3_gate():
    """Every SD1.5 Ci goes to the Hopper variant, any Ci % 64 != 0 (the
    tiny stack's 32 and 96) to the general one; both refuse channels that
    are not multiples of 8."""
    from gaussianip_tpu_torch.ops.conv3x3_cuda import k3_plan, k3_variant

    for ci in (320, 640, 960, 1280, 1920, 2560):
        for co in (320, 640, 1280):
            assert k3_variant(ci, co) == "hopper"
    for ci in (8, 32, 96, 200):
        assert k3_variant(ci, 48) == "general"
        with pytest.raises(ValueError, match="gate"):
            k3_plan(12, 8, 8, ci, 48)
    for ci, co in ((4, 64), (64, 12)):
        with pytest.raises(ValueError, match="multiples of 8"):
            k3_variant(ci, co)


def test_pack_weight_hopper_layout(rng):
    """Row co, column (dy * 3 + dx) * Ci + ci of the Hopper variant's packed
    weight (K-major, [Co, 9 * Ci]) is weight[co, ci, dy, dx]; the gate's
    default packs it for Ci = 64, the general layout for Ci = 32."""
    from gaussianip_tpu_torch.ops.conv3x3_cuda import pack_weight

    w = t(rng.normal(0, 1, (16, 64, 3, 3)).astype(np.float32))
    p = pack_weight(w, torch.float32)
    assert p.shape == (16, 576) and p.is_contiguous()
    for dy, dx, ci, co in ((0, 0, 0, 0), (1, 2, 5, 3), (2, 1, 63, 15)):
        assert p[co, (dy * 3 + dx) * 64 + ci] == w[co, ci, dy, dx]
    assert torch.equal(pack_weight(w, torch.float32, "general"),
                       w.permute(2, 3, 1, 0).reshape(576, 16))
    assert pack_weight(w[:, :32], torch.float32).shape == (288, 16)
