"""The port's compositor (its plain versions, which the autograd Function
runs for CPU tensors) against the JAX Pallas compositor run with
interpret=True on the same data / starts / counts; K2's hand-written VJP of
the pack against the fused backward's plain version (autograd of the
pack); and numpy emulations of K1's and K2's decompositions
(csrc/composite.cu composite_fwd_kernel, composite_bwd_kernel).

Tolerances as tests/test_render_pallas.py: forward rgb and alpha q99 |diff|
< 3e-4, depth < 2e-3, worst case < 100x (isolated pixels may flip across
the 1/255 and T=1e-4 gates: the Pallas kernel builds T in log space through
matmuls, the port with a cumprod); dgrad against JAX's VJP with atol 5e-3,
rtol 2e-2 plus 1e-3 of the row's largest |value|: the coefficient rows of
x^2, xy and y^2 sum 256 pixel terms weighted up to 225, so f32 rounding is
relative to the row, not to the entry (on these scenes both the Pallas VJP
and the port's f32 backward sit up to 4e-4 of the row max away from the
port's backward in float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import make_cameras, make_states, n, t
from gaussianip_tpu_torch.render.composite_cuda import LOG_ALPHA_MIN

torch.set_num_threads(1)
CHUNK = 128
K1_PPT, K2_PPT = 2, 4  # pixels per thread, as csrc/composite.cu
# (opacity range, log-scale boost) of the emulated scenes
SCENES = [((-2.0, 3.0), 0.3),
          ((1.0, 5.0), 0.6)]  # opaque, wide: early stops and long segments


def _instances(rng, opacity, scale_boost, **cfg):
    from gaussianip_tpu_torch.render.render import RenderConfig, instance_data

    _, ts = make_states(rng, opacity=opacity)
    ts = ts.replace(scaling=ts.scaling + scale_boost)
    _, cams = make_cameras(2, 40, 56)
    return instance_data(ts, cams, RenderConfig(d_max=16, **cfg))


def _inputs(rng, opacity, scale_boost):
    inst = _instances(rng, opacity, scale_boost)
    return inst.data, inst.binning.starts, inst.binning.counts


def _jax_data(data):
    e = data.shape[2]
    epad = (-(-(e + CHUNK) // CHUNK)) * CHUNK + 4 * CHUNK
    return jnp.pad(jnp.asarray(n(data)), ((0, 0), (0, 0), (0, epad - e)))


def _gout(rng, out):
    gout = rng.normal(0, 1, out.shape).astype(np.float32)
    gout[:, :, 5:] = 0.0  # the render path feeds zeros to rows 5-7
    return t(gout)


def close(a, b, atol, name):
    d = np.abs(np.asarray(a) - np.asarray(b))
    assert np.quantile(d, 0.99) < atol, f"{name}: q99 {np.quantile(d, 0.99)}"
    assert d.max() < 100 * atol, f"{name}: max {d.max()}"


@pytest.mark.parametrize("opacity,scale_boost", [
    ((-2.0, 3.0), 0.0),
    ((1.0, 5.0), 0.6),  # opaque, wide: early stops and long segments
])
def test_composite_matches_pallas(rng, opacity, scale_boost):
    from gaussianip_tpu.render.composite_pallas import composite_tiles as jct
    from gaussianip_tpu_torch.render.composite_cuda import (
        composite_bwd_plain, composite_fwd_plain)

    data, starts, counts = _inputs(rng, opacity, scale_boost)
    assert int(counts.max()) > CHUNK or scale_boost == 0.0
    jdata = _jax_data(data)
    js, jc = jnp.asarray(n(starts)), jnp.asarray(n(counts))
    f = lambda d: jct(d, js, jc, 16, CHUNK, True, "highest")
    ref, vjp = jax.vjp(f, jdata)

    out = composite_fwd_plain(data, starts, counts, 16)
    close(n(out[:, :, 0:3]), ref[:, :, 0:3], 3e-4, "rgb")
    close(n(out[:, :, 4]), ref[:, :, 4], 3e-4, "alpha")
    close(n(out[:, :, 3]), ref[:, :, 3], 2e-3, "depth")

    gout = _gout(rng, out)
    dgrad = composite_bwd_plain(data, starts, counts, out, gout, 16)
    (jd,) = vjp(jnp.asarray(n(gout)))
    e = data.shape[2]
    ref_d = np.asarray(jd)[:, :, :e]
    row_max = np.abs(ref_d).max(axis=(0, 2), keepdims=True)
    excess = np.abs(n(dgrad) - ref_d) - (5e-3 + 2e-2 * np.abs(ref_d)
                                         + 1e-3 * row_max)
    assert excess.max() <= 0, np.unravel_index(excess.argmax(), excess.shape)
    assert not np.asarray(jd)[:, :, e:].any()


def test_plain_versions_shapes_and_dead_rows(rng):
    """Output rows 6-7 and dgrad rows 6-7 / 13-15 are zero, row 5 holds
    segment-relative last-contributor indices inside the segment."""
    from gaussianip_tpu_torch.render.composite_cuda import (
        composite_bwd_plain, composite_fwd_plain)

    data, starts, counts = _inputs(rng, (-2.0, 3.0), 0.0)
    out = composite_fwd_plain(data, starts, counts)
    assert out.shape == (2, starts.shape[1], 8, 256)
    assert not out[:, :, 6:].any()
    last = out[:, :, 5]
    assert (last >= -1).all()
    assert (last < counts[..., None].to(last.dtype)).all()
    gout = torch.ones_like(out)
    dg = composite_bwd_plain(data, starts, counts, out, gout)
    assert dg.shape == data.shape
    assert not dg[:, 6:8].any() and not dg[:, 13:].any()


def test_cuda_wrappers_refuse_cpu_tensors(rng):
    from gaussianip_tpu_torch.render.composite_cuda import (
        composite_bwd_gaussians_cuda, composite_fwd_cuda, heaviest_first)

    inst = _instances(rng, (-2.0, 3.0), 0.0)
    bn = inst.binning
    order = heaviest_first(bn.counts)
    with pytest.raises(ValueError):
        composite_fwd_cuda(inst.data, bn.starts, bn.counts, order)
    out = torch.zeros(2, bn.starts.shape[1], 8, 256)
    with pytest.raises(ValueError):
        composite_bwd_gaussians_cuda(inst.data, inst.packed, bn.gidx,
                                     bn.starts, bn.counts, order, out, out,
                                     inst.n_tiles_x)


def _pack_vjp(dgrad, packed, gidx, tile_of, ntx):
    """K2's epilogue in torch: the hand-written VJP of
    gaussian_power_coeffs (mean2d - the tile's origin, conic, opacity;
    colour and depth as they are) of every live instance slot, added into
    d_packed [B, N, 10] (csrc/composite.cu composite_bwd_kernel)."""
    b, n, _ = packed.shape
    bi, k = (gidx < n).nonzero(as_tuple=True)
    tl, gi = tile_of[bi, k], gidx[bi, k]
    d = dgrad[bi, :, k]  # [L, 16]
    g0, g1, g2, g3, g4, g5 = d[:, 0:6].unbind(1)
    p = packed[bi, gi]
    mx = p[:, 0] - (tl % ntx * 16).to(p.dtype)
    my = p[:, 1] - (tl // ntx * 16).to(p.dtype)
    ca, cb, cc, o = p[:, 2], p[:, 3], p[:, 4], p[:, 5]
    inv_o = torch.where(o >= 1e-12, 1.0 / o, torch.zeros_like(o))
    d_inst = torch.stack([
        g1 * ca + g2 * cb - g0 * (ca * mx + cb * my),
        g1 * cb + g2 * cc - g0 * (cc * my + cb * mx),
        -0.5 * g0 * mx * mx + g1 * mx - 0.5 * g3,
        -g0 * mx * my + g1 * my + g2 * mx - g4,
        -0.5 * g0 * my * my + g2 * my - 0.5 * g5,
        g0 * inv_o, d[:, 8], d[:, 9], d[:, 10], d[:, 11]], 1)
    d_packed = torch.zeros(b * n, 10, dtype=packed.dtype)
    d_packed.index_add_(0, bi * n + gi, d_inst)
    return d_packed.view(b, n, 10)


# pool=64 overflows (n_dropped > 0); capacity 512 > 400 points and culled
# gaussians leave dead slots
@pytest.mark.parametrize("opacity,scale_boost", [
    ((-2.0, 3.0), 0.0),
    ((1.0, 5.0), 0.6),
])
def test_fused_backward_matches_autograd_of_the_pack(rng, opacity,
                                                     scale_boost):
    """The fused backward's plain version (composite_bwd_gaussians_plain:
    composite_bwd_plain's dgrad pulled back by autograd through
    pack_instances, the gather and gaussian_power_coeffs), reached through
    the autograd Function, against K2's hand-written VJP of the pack and
    its per-gaussian sum (_pack_vjp). Worst |diff| per column within 1e-5
    of the column's largest |value| (both f32, the same terms summed in
    another order)."""
    from gaussianip_tpu_torch.render.composite_cuda import (
        composite_bwd_plain, composite_fwd_plain, composite_tiles,
        pack_instances)

    inst = _instances(rng, opacity, scale_boost, pool=64)
    bn = inst.binning
    n_g = inst.packed.shape[1]
    assert int(bn.n_dropped.sum()) > 0
    assert bool((bn.gidx == n_g).any())
    data = pack_instances(inst.packed, bn.gidx, bn.tile_of, inst.n_tiles_x,
                          inst.n_tiles_y)
    torch.testing.assert_close(data, inst.data, rtol=0, atol=0)
    out = composite_fwd_plain(inst.data, bn.starts, bn.counts)
    gout = _gout(rng, out)
    packed = inst.packed.clone().requires_grad_(True)
    out_f = composite_tiles(packed, bn.gidx, bn.tile_of, bn.starts,
                            bn.counts, inst.n_tiles_x, inst.n_tiles_y)
    torch.testing.assert_close(out_f.detach(), out, rtol=0, atol=0)
    (got,) = torch.autograd.grad(out_f, packed, gout)
    dgrad = composite_bwd_plain(inst.data, bn.starts, bn.counts, out, gout)
    ref = _pack_vjp(dgrad, inst.packed, bn.gidx, bn.tile_of, inst.n_tiles_x)
    assert got.shape == packed.shape
    scale = ref.abs().amax(dim=(0, 1))
    assert (scale > 0).all()
    err = (got - ref).abs().amax(dim=(0, 1)) / scale
    assert (err <= 1e-5).all(), err


def test_render_backward_goes_through_the_fused_function(rng, monkeypatch):
    """render()'s gradient reaches the per-gaussian attributes through
    composite_bwd_gaussians_plain on CPU tensors, with no scatter-add of
    the gather in the graph."""
    from gaussianip_tpu_torch.render import composite_cuda as cc
    from gaussianip_tpu_torch.render.render import RenderConfig, render

    _, ts = make_states(rng)
    _, cams = make_cameras(2, 40, 56)
    calls = []
    orig = cc.composite_bwd_gaussians_plain

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(cc, "composite_bwd_gaussians_plain", spy)
    xyz = ts.xyz.clone().requires_grad_(True)
    out = render(ts.replace(xyz=xyz), cams, torch.zeros(3),
                 RenderConfig(d_max=16))
    seen, stack = {}, [out.rgb.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or id(fn) in seen:
            continue
        seen[id(fn)] = type(fn).__name__
        stack += [f for f, _ in fn.next_functions]
    names = set(seen.values())
    out.rgb.sum().backward()
    assert calls == [1]
    assert "_CompositeGaussiansBackward" in names
    assert not any("Gather" in s or "Scatter" in s for s in names), names
    assert xyz.grad.abs().sum() > 0


# ----------------------------------- K1's and K2's decompositions in numpy ---

def _reduce_scatter(v):
    """csrc/composite.cu reduce_scatter / scatter_step<H> over [32 lanes,
    32 slots]: at step H a lane keeps the half its bit H selects and adds
    that half from lane ^ H. Returns each lane's v[0]."""
    lane = np.arange(32)
    v = v.copy()
    for h in (16, 8, 4, 2, 1):
        up = (lane & h) != 0
        send = np.where(up[:, None], v[:, :h], v[:, h:2 * h])
        keep = np.where(up[:, None], v[:, h:2 * h], v[:, :h])
        v[:, :h] = keep + send[lane ^ h]
    return v[:, 0]


def _reaches_rows(c, ylo, yhi):
    """csrc/composite.cu reaches_rows in float32 on the coefficients
    c[0:6]."""
    c = np.asarray(c, np.float32)
    f = np.float32
    if not c[3] < 0:
        return True
    k = f(0.25) / c[3]
    a = c[5] - c[4] * c[4] * k
    if not a < 0:
        return True
    b = c[2] - f(2) * c[1] * c[4] * k
    cc = c[0] - c[1] * c[1] * k - f(LOG_ALPHA_MIN)
    disc = b * b - f(4) * a * cc
    if disc < 0:
        return False
    yc = b / (f(-2) * a)
    h = np.sqrt(disc) / (f(-2) * a) + f(1)
    return bool(yc + h >= ylo and yc - h <= yhi)


def _live32(c, x, y):
    """The kernels' 1/255 gate: the power of c[0:6] at pixels (x, y),
    evaluated in float32 as csrc/composite.cu does (one rounding per
    operation), against ln(1/255) in float32."""
    c = np.asarray(c, np.float32)
    x, y = np.float32(x), np.float32(y)
    u = c[0] + x * (c[1] + x * c[3])
    v = c[2] + x * c[4]
    return u + y * (v + y * c[5]) >= np.float32(LOG_ALPHA_MIN)


def test_log_alpha_min_is_the_kernels():
    """The plain versions' gate constant is ln(1/255) in float32, and
    csrc/composite.cu holds the same float."""
    import math
    import os
    import re

    assert np.float32(LOG_ALPHA_MIN) == np.float32(math.log(1 / 255))
    src = open(os.path.join(os.path.dirname(__file__), "..",
                            "gaussianip_tpu_torch", "csrc",
                            "composite.cu")).read()
    lit = re.search(r"LOG_ALPHA_MIN = (-?[0-9.]+)f;", src).group(1)
    assert np.float32(float(lit)) == np.float32(LOG_ALPHA_MIN)


def _warp_pixels(ws, ppt):
    """Pixels [32 lanes, PPT] of warp ws: p = ws 32 PPT + l + 32 i, so
    x = l % 16 and the warp owns rows 2 PPT ws .. 2 PPT ws + 2 PPT - 1."""
    lane = np.arange(32)
    p = ws * 32 * ppt + lane[:, None] + 32 * np.arange(ppt)
    assert (p & 15 == lane[:, None] & 15).all()
    return p


def _emulate_k1(data, starts, counts, ppt=K1_PPT):
    """composite_fwd_kernel warp by warp in float64: the pixel map, the
    walk over the segment in batches of 32 instances culled to those that
    reach the warp's rows (reaches_rows, in float32 as the kernel), each
    pixel's front-to-back compositing with the 1/255 skip and the 1e-4
    stop, and the warp's exit once all its pixels have stopped (checked
    after every 8th staged instance). Returns (out [B, NT, 8, 256], warps
    that exited early, instances culled)."""
    b_all, _, _ = data.shape
    nt = starts.shape[1]
    out = np.zeros((b_all, nt, 8, 256))
    covered = np.zeros(256, np.int64)
    data32 = data.astype(np.float32)
    x = (np.arange(32) & 15).astype(np.float64)[:, None]
    exits = culled = 0
    for b in range(b_all):
        for t_ in range(nt):
            start, count = int(starts[b, t_]), int(counts[b, t_])
            for ws in range(8 // ppt):
                p = _warp_pixels(ws, ppt)
                if b == 0 and t_ == 0:
                    np.add.at(covered, p.ravel(), 1)
                y = (p >> 4).astype(np.float64)
                T = np.ones((32, ppt))
                acc = np.zeros((5, 32, ppt))
                last = np.full((32, ppt), -1.0)
                done = np.zeros((32, ppt), bool)
                ylo = ws * 2 * ppt
                for k0 in range(0, count, 32):
                    kept = [k for k in range(k0, min(k0 + 32, count))
                            if _reaches_rows(data32[b, 0:6, start + k], ylo,
                                             ylo + 2 * ppt - 1)]
                    culled += min(32, count - k0) - len(kept)
                    for j, k in enumerate(kept):
                        col = data[b, :, start + k]
                        c, f = col[0:6], col[8:13]
                        alpha = np.minimum(np.exp(
                            c[0] + c[1] * x + c[2] * y + c[3] * x * x
                            + c[4] * x * y + c[5] * y * y), 0.99)
                        live = ~done & _live32(c, x, y)
                        test_t = T * (1.0 - alpha)
                        stop = live & (test_t < 1e-4)
                        use = live & ~stop
                        done |= stop
                        acc += np.where(use, alpha * T, 0.0) * f[:, None,
                                                                 None]
                        T = np.where(use, test_t, T)
                        last = np.where(use, k, last)
                        if j % 8 == 7 and done.all():
                            break
                    else:
                        continue
                    exits += 1
                    break
                out[b, t_, 0:5][:, p] = acc
                out[b, t_, 5][p] = last
    assert (covered == 1).all()  # every pixel of a tile exactly once
    return out, exits, culled


@pytest.mark.parametrize("opacity,scale_boost", SCENES)
def test_k1_decomposition_matches_plain(rng, opacity, scale_boost):
    """The numpy emulation of K1's pixel map, row cull and warp exit
    against composite_fwd_plain: the tolerances of
    test_composite_matches_pallas, and the last contributor equal at all
    but isolated gate flips. The opaque scene exercises the warp exit, both
    the cull."""
    from gaussianip_tpu_torch.render.composite_cuda import composite_fwd_plain

    data, starts, counts = _inputs(rng, opacity, scale_boost)
    ref = n(composite_fwd_plain(data, starts, counts))
    got, exits, culled = _emulate_k1(n(data).astype(np.float64), n(starts),
                                     n(counts))
    close(got[:, :, 0:3], ref[:, :, 0:3], 3e-4, "rgb")
    close(got[:, :, 4], ref[:, :, 4], 3e-4, "alpha")
    close(got[:, :, 3], ref[:, :, 3], 2e-3, "depth")
    assert (got[:, :, 5] == ref[:, :, 5]).mean() > 0.99
    assert culled > 0
    assert exits > 0 or opacity[0] < 0


def _emulate_k2(data, packed, gidx, starts, out, gout, ntx,
                ppt=K2_PPT):
    """composite_bwd_kernel<PPT> warp by warp in float64: the pixel map
    (warp ws, lane l, pixel i -> p = ws 32 PPT + l + 32 i, x = l % 16,
    y = p / 16), the back-to-front walk from the warp's last contributor
    in batches of 32, each batch culled to the instances that reach the
    warp's rows (reaches_rows, in float32 as the kernel), the per-thread
    sums (dpower, dpower y, dpower y^2 -> the six coefficient terms),
    groups of 3 instances in 32 slots (slot 10 s + q), the transposed
    reduction, the lane -> (instance, term) map of the epilogue and its
    VJP of gaussian_power_coeffs, and the atomic adds into d_packed."""
    b_all, _, e = data.shape
    nt = starts.shape[1]
    w_per_tile = 8 // ppt
    lane = np.arange(32)
    x = (lane & 15).astype(np.float64)[:, None]
    slot_inst = np.minimum(lane // 10, 2)
    slot_term = lane - 10 * slot_inst
    d_packed = np.zeros(packed.shape, np.float64)
    covered = np.zeros(256, np.int64)
    data32 = data.astype(np.float32)
    for b in range(b_all):
        for t_ in range(nt):
            ox, oy = (t_ % ntx) * 16, (t_ // ntx) * 16
            start = int(starts[b, t_])
            o, g = out[b, t_], gout[b, t_]
            for ws in range(w_per_tile):
                p = _warp_pixels(ws, ppt)
                if b == 0 and t_ == 0:
                    np.add.at(covered, p.ravel(), 1)
                y = (p >> 4).astype(np.float64)
                gr = g[0:5][:, p]
                last = o[5][p].astype(np.int64)
                T = np.maximum(1.0 - o[4][p], 1e-12)
                r = np.zeros_like(T)
                max_last = int(last.max())
                ylo = ws * 2 * ppt
                for k0 in range((max_last // 32) * 32, -1, -32) \
                        if max_last >= 0 else ():
                    nb = min(32, max_last + 1 - k0)
                    kept = [k for k in range(k0, k0 + nb) if _reaches_rows(
                        data32[b, 0:6, start + k], ylo, ylo + 2 * ppt - 1)]
                    for jg in range(len(kept) - 1, -1, -3):
                        v = np.zeros((32, 32))
                        for s in range(3):
                            j = jg - s
                            if j < 0:
                                continue
                            col = data[b, :, start + kept[j]]
                            c, f = col[0:6], col[8:13]
                            raw = np.exp(c[0] + c[1] * x + c[2] * y
                                         + c[3] * x * x + c[4] * x * y
                                         + c[5] * y * y)
                            alpha = np.minimum(raw, 0.99)
                            m = (kept[j] <= last) & _live32(c, x, y)
                            om = 1.0 - alpha
                            t_ex = T / om
                            w = np.where(m, alpha * t_ex, 0.0)
                            t1 = np.tensordot(f, gr, 1)
                            dp = np.where(m, (t1 * t_ex - r / om) * raw, 0.0)
                            r = np.where(m, r + t1 * w, r)
                            T = np.where(m, t_ex, T)
                            s0, sy = dp.sum(1), (dp * y).sum(1)
                            terms = [s0, x[:, 0] * s0, sy, x[:, 0] ** 2 * s0,
                                     x[:, 0] * sy, (dp * y * y).sum(1)]
                            terms += [(gr[ch] * w).sum(1) for ch in range(4)]
                            v[:, 10 * s:10 * s + 10] = np.stack(terms, 1)
                        tot = _reduce_scatter(v)
                        # sums of the same 32 terms in another order
                        assert (np.abs(tot - v.sum(0))
                                <= 1e-12 * np.abs(v).sum(0)).all()
                        gc = tot[slot_inst[:, None] * 10 + np.arange(6)]
                        for ln in range(30):
                            j = jg - slot_inst[ln]
                            if j < 0:
                                continue
                            gi = int(gidx[b, start + kept[j]])
                            mx, my, ca, cb, cc, op = packed[b, gi, 0:6]
                            mx, my = mx - ox, my - oy
                            g0, g1, g2, g3, g4, g5 = gc[ln]
                            q = slot_term[ln]
                            d = [g1 * ca + g2 * cb - g0 * (ca * mx + cb * my),
                                 g1 * cb + g2 * cc - g0 * (cc * my + cb * mx),
                                 -0.5 * g0 * mx * mx + g1 * mx - 0.5 * g3,
                                 -g0 * mx * my + g1 * my + g2 * mx - g4,
                                 -0.5 * g0 * my * my + g2 * my - 0.5 * g5,
                                 g0 / op if op >= 1e-12 else 0.0][q] \
                                if q < 6 else tot[ln]
                            d_packed[b, gi, q] += d
    assert (covered == 1).all()  # every pixel of a tile exactly once
    return d_packed


@pytest.mark.parametrize("opacity,scale_boost", SCENES)
def test_k2_decomposition_matches_plain(rng, opacity, scale_boost):
    """The numpy emulation of K2's index maps and transposed reduction
    against composite_bwd_gaussians_plain (f32): worst |diff| per column
    within 1e-4 of the column's largest |value|. The transposed reduction
    itself is held against a direct sum over lanes in every group."""
    from gaussianip_tpu_torch.render.composite_cuda import (
        composite_bwd_gaussians_plain, composite_fwd_plain)

    inst = _instances(rng, opacity, scale_boost)
    bn = inst.binning
    out = composite_fwd_plain(inst.data, bn.starts, bn.counts)
    gout = _gout(rng, out)
    ref = n(composite_bwd_gaussians_plain(
        inst.data, inst.packed, bn.gidx, bn.tile_of, bn.starts, bn.counts,
        out, gout, inst.n_tiles_x, inst.n_tiles_y))
    f64 = lambda a: n(a).astype(np.float64)
    got = _emulate_k2(f64(inst.data), f64(inst.packed), n(bn.gidx),
                      n(bn.starts), f64(out), f64(gout), inst.n_tiles_x)
    scale = np.abs(ref).max(axis=(0, 1))
    assert (scale > 0).all()
    err = np.abs(got - ref).max(axis=(0, 1)) / scale
    assert (err <= 1e-4).all(), err
