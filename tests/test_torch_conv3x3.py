"""The port's 3x3 conv (K3's plain version, its autograd and the Conv3x3
module) against the JAX package's Pallas kernel in interpret mode, on the
same numpy inputs. The JAX side is NHWC / HWIO, the port NCHW / OIHW."""

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
    from gaussianip_tpu_torch.ops.conv3x3_cuda import conv3x3_cuda

    x = torch.zeros((1, 8, 4, 4), dtype=torch.bfloat16)
    w = torch.zeros((72, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        conv3x3_cuda(x, w)
    assert conv3x3_cuda.launches == 0
