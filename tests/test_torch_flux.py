"""The FLUX.1-dev guidance stack on the port's normal path, against the
plain reference (benchmark/reference/gip_ref/diffusion/flux.py,
vae_flux.py, guidance/ipa_flux.py) on seeded random float32 weights on
the CPU: the module trees at the published widths, the transformer, the
Union ControlNet and the IP path at a tiny FLUX (2 heads of 32, RoPE axes
8 / 12 / 12, 2 double and 3 single blocks, a ControlNet of 1 + 2 blocks
so that the sample intervals round up), one guided stage-1 step through
make_train_step, RoPE against a complex multiplication, the velocity
bridge, the spans, the graph rule and the refine's refusal.

Both sides get their weights from benchmark/stack_flux.random_weights,
one draw a parameter by name, so equal trees get equal weights.
Tolerances: the port in float32 differs from the reference by the order
of its sums (F.scaled_dot_product_attention against written-out
attention, RoPE as a complex product against BFL's rotation matrices);
each limit sits ten times or more above what float32 reads here and
below what the port at bf16 reads, which the `bf16` cases hold it to."""

import ast
import os

import pytest
import torch

from benchmark import flops_flux, inputs, run, stack, stack_flux
from benchmark.entries import stage1_step
from benchmark.tests import tiny
from gaussianip_tpu_torch.diffusion import flux as FX
from gaussianip_tpu_torch.diffusion import vae as V
from gaussianip_tpu_torch.guidance import graph
from gaussianip_tpu_torch.system import pipeline

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 33 + 23
CONFIG = run.load_json(ROOT, "benchmark", "configs", "gaussianip-flux.json")
TINY = run.load_json(ROOT, "benchmark", "configs", "gaussianip-flux.json")
tiny.shrink_config(TINY)
# the relative limits (see the module docstring): float32 reads 2e-7 to
# 3e-7 in the networks' outputs, 1.2e-6 on the IP path, 0 in the step's
# loss and 1.2e-5 in its gradient to the render (the CFG rows' difference
# of eps^ = x_t + (1 - sigma) v^ loses digits); bf16 reads 6.6e-3, 1.1e-2,
# 2.7e-2 and 2.3e-2
TOL = {"controlnet": 5e-6, "flux": 5e-6, "ip": 2e-5, "loss": 1e-5,
       "d_rgb": 2e-4}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _tree(m):
    return [(n, tuple(p.shape)) for n, p in m.named_parameters()]


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def _models(root, dtype, cfg=TINY):
    pkg = stack_flux.package(root)
    return pkg, stack_flux.diffusion_models(pkg, cfg, SEED, "cpu", dtype)


def test_trees_match_the_reference_at_published_widths():
    """flux_config's transformer (with the 4 identity tokens' projections),
    the Union ControlNet and the 16-channel VAE have the reference's names
    and shapes in its order; FLUX.1-dev's transformer has 11,901,408,320
    parameters without the IP projections, which add 478,267,392, and the
    ControlNet 3,301,956,608; the program holds them at bf16."""
    ref = stack_flux.package(stack.REFERENCE)
    port = stack_flux.models_on_meta(stack_flux.package(stack.PROGRAM),
                                     CONFIG, torch.bfloat16)
    want = stack_flux.models_on_meta(ref, CONFIG, torch.float32)
    for p, r in zip(port, want):
        assert _tree(p) == _tree(r), type(p).__name__
    count = lambda m: sum(p.numel() for p in m.parameters())
    with torch.device("meta"):
        bare = FX.FluxTransformer(pipeline.flux_config(ip_tokens=0))
        cn = FX.FluxControlNet(pipeline.flux_config(5, 10, 0))
        ip = FX.FluxTransformer(pipeline.flux_config())
        vae = V.AutoencoderKL(pipeline.flux_vae_config())
    assert count(bare) == 11_901_408_320
    assert count(ip) - count(bare) == 478_267_392 == count(port[0]) - count(
        bare)
    assert count(cn) == count(port[1]) == 3_301_956_608
    assert {p.dtype for m in (ip, cn) for p in m.parameters()} == {
        torch.bfloat16}
    assert _tree(vae) == _tree(port[2])
    assert not any("quant_conv" in n for n, _ in _tree(vae))


def test_pipeline_configs_are_the_benchmarks():
    """system/pipeline.py's FLUX configurations state what the benchmark's
    configuration file states."""
    t = dict(CONFIG["transformer"])
    t["axes_dims_rope"] = tuple(t["axes_dims_rope"])
    assert pipeline.flux_config() == FX.FluxConfig(**t)
    c = CONFIG["controlnet"]
    assert pipeline.flux_config(c["num_layers"], c["num_single_layers"],
                                0) == FX.FluxConfig(**{
                                    **t, "num_layers": 5,
                                    "num_single_layers": 10, "ip_tokens": 0})
    v = dict(CONFIG["vae"])
    v["block_out_channels"] = tuple(v["block_out_channels"])
    assert pipeline.flux_vae_config() == V.VAEConfig(
        dtype=torch.bfloat16, **v)


def test_sd_vaes_keep_their_quant_convs():
    """The VAE's new keys default to the SD VAE's: quant convs, no shift."""
    with torch.device("meta"):
        names = [n for n, _ in _tree(V.AutoencoderKL(V.VAEConfig()))]
    assert names[-4:] == ["quant_conv.weight", "quant_conv.bias",
                          "post_quant_conv.weight", "post_quant_conv.bias"]
    assert V.VAEConfig().shift_factor == 0.0


def test_rope_is_a_complex_multiplication():
    """Each pair (x[2i], x[2i+1]) of a token times exp(i angle), the angle
    the token's id on its axis times theta ** (-2k / d) for the pair's
    k-th place on an axis of width d; the reference's rotation matrices
    give the same."""
    from benchmark.reference.gip_ref.diffusion import flux as ref

    axes, theta, t, h, w = (8, 12, 12), 10000.0, 3, 4, 5
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, t + h * w, 2, 32, generator=gen, dtype=torch.float64)
    ids = [(0, 0, 0)] * t + [(0, i, j) for i in range(h) for j in range(w)]
    ang = torch.tensor([[p[a] * theta ** (-k / d) for a, d in
                         enumerate(axes) for k in range(0, d, 2)]
                        for p in ids], dtype=torch.float64)
    z = torch.complex(x[..., 0::2], x[..., 1::2]) * torch.polar(
        torch.ones_like(ang), ang)[:, None]
    want = torch.stack([z.real, z.imag], -1).flatten(-2)
    got = FX.apply_rope(x.float(), FX.rope_freqs(axes, t, h, w, "cpu"))
    assert float((got.double() - want).abs().max()) < 1e-5
    pe = ref.embed_nd(ref.ids(t, h, w, "cpu"), axes, theta)
    got_ref = ref.apply_rope(x.float().transpose(1, 2), pe).transpose(1, 2)
    assert float((got_ref.double() - want).abs().max()) < 1e-5
    assert torch.equal(got[:, :t], x[:, :t].float())  # text: id 0


def test_pack_and_unpack_are_inverse_2x2_patches():
    z = torch.arange(2 * 3 * 4 * 6, dtype=torch.float32).reshape(2, 3, 4, 6)
    p = FX.pack(z)
    assert p.shape == (2, 2, 3, 12)
    assert torch.equal(p[1, 1, 2], z[1, :, 2:4, 4:6].reshape(-1))
    assert torch.equal(FX.unpack(p), z)


def _call(models, n: int = 3, ip_scale: float = 0.5):
    """(ControlNet samples flattened, the transformer's velocity) of one
    call at the tiny shape (8 x 8 tokens), inputs from SEED."""
    gen = torch.Generator().manual_seed(SEED)
    d = lambda *s: torch.randn(*s, generator=gen)
    img, hint = d(n, 8, 8, 64), d(n, 8, 8, 64)
    sigma, g = torch.rand(n, generator=gen), torch.full((n,), 3.5)
    txt, pooled, ip = d(n, 8, 32), d(n, 16), d(n, 4, 32)
    flux, cn, _ = models
    with torch.no_grad():
        samples = cn(img, hint, sigma, g, txt, pooled)
        v = flux(img, sigma, g, txt, pooled, ip, ip_scale, samples)
    return torch.cat([s.float().flatten() for s in sum(samples, ())]), \
        v.float()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_transformer_controlnet_and_ip_match_the_reference(dtype):
    """The port at the tiny FLUX against the reference: the ControlNet's
    samples, the transformer's velocity with them, and the IP path (the
    velocity at ip_scale 0.5 less that at 0); within the limits in
    float32, outside at bf16."""
    _, port = _models(stack.PROGRAM, DTYPES[dtype])
    _, ref = _models(stack.REFERENCE, torch.float32)
    (pc, pv), (rc, rv) = _call(port), _call(ref)
    gaps = {"controlnet": _rel(pc, rc), "flux": _rel(pv, rv),
            "ip": _rel(pv - _call(port, ip_scale=0.0)[1],
                       rv - _call(ref, ip_scale=0.0)[1])}
    if dtype == "f32":
        assert all(gaps[k] < TOL[k] for k in gaps), gaps
    else:
        assert any(gaps[k] > TOL[k] for k in gaps), gaps


def test_the_controlnet_samples_land_by_rounded_up_intervals():
    """2 double blocks over 1 sample: ceil(2 / 1) = 2, double block 0 takes
    sample 0; 3 single blocks over 2 samples: ceil(3 / 2) = 2, so single
    blocks 0 and 1 take sample 0 (block 2 sample 1). What a block's
    successor receives is its output plus that sample, on the image
    tokens alone."""
    _, (flux, _, _) = _models(stack.PROGRAM, torch.float32)
    gen = torch.Generator().manual_seed(1)
    d = lambda *s: torch.randn(*s, generator=gen)
    img = d(1, 8, 8, 64)
    doubles = (torch.full((1, 64, 64), 1.0),)
    singles = (torch.full((1, 64, 64), 2.0), torch.full((1, 64, 64), 3.0))
    ins, outs = {}, {}
    hooks = []
    for kind, blocks in (("d", flux.double_blocks),
                         ("s", flux.single_blocks)):
        for i, blk in enumerate(blocks):
            hooks += [blk.register_forward_pre_hook(
                lambda m, a, k=(kind, i): ins.__setitem__(k, a[0].clone())),
                blk.register_forward_hook(
                lambda m, a, o, k=(kind, i): outs.__setitem__(
                    k, (o[0] if isinstance(o, tuple) else o).clone()))]
    with torch.no_grad():
        flux(img, torch.rand(1, generator=gen), torch.full((1,), 3.5),
             d(1, 8, 32), d(1, 16), controlnet=(doubles, singles))
    for h in hooks:
        h.remove()
    assert torch.allclose(ins["d", 1] - outs["d", 0], doubles[0])
    for j in (0, 1):
        added = ins["s", j + 1] - outs["s", j]
        assert torch.allclose(added[:, 8:], singles[0]), j
        assert float(added[:, :8].abs().max()) == 0.0


class _Tap:
    """The guidance, keeping the gradient that reaches the render."""

    def __init__(self, guid):
        self.guid, self.d_rgb = guid, []

    def sample_noise(self, *args):
        return self.guid.sample_noise(*args)

    def __call__(self, step, draws, rgb, control, aux):
        rgb.register_hook(self.d_rgb.append)
        return self.guid(step, draws, rgb, control, aux)


def _guided_step(root, dtype):
    """(loss, d loss / d rgb) of one stage-1 step through make_train_step
    on the tiny FLUX stack, 2 views at 32^2."""
    pkg, models = _models(root, dtype)
    tap = _Tap(stack_flux.guidance(pkg, TINY, models, SEED, "cpu"))
    ts = pkg.stage1.init_train_state(stack.avatar(pkg, TINY, SEED, "cpu"))
    p = {"views": 2, "resolution": 32, "d_max": 16}
    step = stage1_step._make_step(pkg, TINY, p, tap)
    _, m = step(ts, inputs.generator(SEED, "steps", "cpu"))
    return float(m["loss"]), tap.d_rgb[0]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_a_guided_step_matches_the_reference(dtype):
    """The stage-1 step's loss and its gradient to the rendered views, the
    port's AHDSGuidance on the velocity prior (the bridge, the packing,
    the pose maps' encode) against the reference's written-out step:
    within the limits in float32, outside at bf16."""
    loss, d_rgb = _guided_step(stack.PROGRAM, DTYPES[dtype])
    rloss, rd_rgb = _guided_step(stack.REFERENCE, torch.float32)
    assert float(rd_rgb.abs().max()) > 0
    gaps = {"loss": abs(loss - rloss) / abs(rloss),
            "d_rgb": _rel(d_rgb, rd_rgb)}
    if dtype == "f32":
        assert all(gaps[k] < TOL[k] for k in gaps), gaps
    else:
        assert any(gaps[k] > TOL[k] for k in gaps), gaps


def _view_aux(b: int):
    return {"elevation": torch.zeros(b), "azimuth": torch.full((b,), 90.0),
            "center": torch.zeros(b), "all_vis": torch.ones(b),
            "camera_distances": torch.full((b,), 3.0)}


def test_the_bridge_returns_eps_for_the_exact_velocity(monkeypatch):
    """With v^ = eps - z for every row, eps^ = x_t + (1 - sigma_t) v^ is
    eps, x_t = c_t add_noise(z, eps, t) = (1 - sigma_t) z + sigma_t eps;
    the transformer is handed sigma_t and x_t (packed)."""
    pkg, models = _models(stack.PROGRAM, torch.float32)
    guid = stack_flux.guidance(pkg, TINY, models, SEED, "cpu")
    gen = torch.Generator().manual_seed(3)
    b = 2
    z = torch.randn(b, 16, 16, 16, generator=gen)
    eps = torch.randn(b, 16, 16, 16, generator=gen)
    t = torch.tensor([37, 801])
    a = guid.ddim.alphas_cumprod[t].double()
    sigma = (1 - a).sqrt() / (a.sqrt() + (1 - a).sqrt())
    seen = {}

    def exact(latents, hint, sig, txt, pooled, ip):
        seen["x"], seen["sigma"] = latents, sig
        return torch.cat([eps - z] * 3)

    monkeypatch.setattr(guid, "predict_velocity", exact)
    from gaussianip_tpu_torch.diffusion.scheduler import add_noise

    with torch.no_grad():
        got = guid._velocity_as_eps(add_noise(guid.ddim, z, eps, t),
                                    torch.rand(b, 3, 32, 32, generator=gen),
                                    t, _view_aux(b), 3)
    s4 = sigma[:, None, None, None]
    assert torch.allclose(seen["sigma"].double(), torch.cat([sigma] * 3))
    assert torch.allclose(seen["x"][:b].double(), (1 - s4) * z + s4 * eps,
                          atol=1e-6)
    assert torch.allclose(got, torch.cat([eps] * 3), atol=1e-5)


def test_a_prediction_kind_is_checked(monkeypatch):
    """The denoiser declares what it predicts, and the guidance takes the
    bridge for a velocity prior from that alone."""
    from gaussianip_tpu_torch.diffusion.unet import UNet2DConditionModel

    assert FX.FluxTransformer.prediction == "velocity"
    assert UNet2DConditionModel.prediction == "epsilon"
    pkg, models = _models(stack.PROGRAM, torch.float32)
    guid = stack_flux.guidance(pkg, TINY, models, SEED, "cpu")

    class Bridged(Exception):
        pass

    def bridge(*args):
        raise Bridged

    monkeypatch.setattr(guid, "_velocity_as_eps", bridge)
    gen = torch.Generator().manual_seed(SEED)
    b = 2
    draws = guid.sample_noise(gen, (b, 32, 32, 3), "cpu")
    with pytest.raises(Bridged):
        guid(0, draws, torch.rand(b, 32, 32, 3, generator=gen),
             torch.rand(b, 32, 32, 3, generator=gen), _view_aux(b))


def test_flux_latents_stay_eager():
    """The graph rule keeps 128^2 latents (FLUX's, SDXL's) eager, so that
    their spans record; 64^2 on a card replays."""
    assert not graph.engages("cuda", (12, 16, 128, 128))
    assert graph.engages("cuda", (12, 4, 64, 64))
    assert not graph.engages("cpu", (12, 16, 64, 64))


def test_a_guided_call_records_the_flux_spans():
    """Under the profiler the denoise holds `pose_encode`, `controlnet`
    (1 double and 2 single blocks) and `flux` (2 double and 3 single)."""
    from torch.profiler import ProfilerActivity, profile

    from gaussianip_tpu_torch.utils import profiling

    pkg, models = _models(stack.PROGRAM, torch.float32)
    guid = stack_flux.guidance(pkg, TINY, models, SEED, "cpu")
    gen = torch.Generator().manual_seed(SEED)
    b = 2
    draws = guid.sample_noise(gen, (b, 32, 32, 3), "cpu")
    rgb = torch.rand(b, 32, 32, 3, generator=gen)
    profiling.spans()
    with profile(activities=[ProfilerActivity.CPU]):
        guid(0, draws, rgb, torch.rand(b, 32, 32, 3, generator=gen),
             _view_aux(b))
    got = [(r["name"], r["parent"]) for r in profiling.spans()]
    assert got == ([("vae_encode", None), ("denoise", None),
                    ("pose_encode", "denoise"), ("controlnet", "denoise")]
                   + [("double_block", "controlnet")]
                   + [("single_block", "controlnet")] * 2
                   + [("flux", "denoise")] + [("double_block", "flux")] * 2
                   + [("single_block", "flux")] * 3)


def test_refine_views_refuses_a_flux_stack():
    from gaussianip_tpu_torch.system.refine import RefineModels, refine_views

    _, models = _models(stack.PROGRAM, torch.float32)
    with pytest.raises(ValueError, match="FLUX"):
        refine_views(RefineModels(*models), torch.rand(32, 32, 32, 3),
                     torch.rand(32, 32, 32, 3), {}, torch.randn(16, 16, 16))


def test_the_counts_split_the_blocks_by_kind():
    """At the published widths one CFG row of the denoise (4,096 image +
    512 T5 tokens) is ~95 TFLOP: ~74.4 in the transformer, ~20.7 in the
    ControlNet; the 72 blocks hold over 95% of it, the 24 double-stream
    blocks ~33% and the 48 single-stream ~66%."""
    got = flops_flux.denoise_call(CONFIG, 1, 128)
    assert 94e12 < got["flops"] < 96e12, got
    blocks = got["double_flops"] + got["single_flops"]
    assert 0.95 < blocks / got["flops"] < 1.0
    assert 0.31 < got["double_flops"] / got["flops"] < 0.35
    assert 0.63 < got["single_flops"] / got["flops"] < 0.68
    tiny_call = flops_flux.denoise_call(TINY, 2, 16)
    assert 0 < tiny_call["double_flops"] + tiny_call["single_flops"] < \
        tiny_call["flops"]


@pytest.mark.parametrize("name", ["diffusion/flux.py", "diffusion/vae_flux.py",
                                  "guidance/ipa_flux.py"])
def test_the_flux_reference_imports_nothing_of_the_port(name):
    """The reference's FLUX files import only torch and the reference
    (relative imports): no JAX, no JAX package, no port."""
    path = os.path.join(ROOT, "benchmark", "reference", "gip_ref", name)
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops = [node.module.split(".")[0]]
        else:
            continue
        assert set(tops) <= {"torch", "math", "dataclasses",
                             "__future__"}, (name, tops)
