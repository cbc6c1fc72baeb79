"""The SDXL guidance stack on the port's normal path, against the plain
reference (benchmark/reference/gip_ref/diffusion/unet_xl.py,
guidance/ipa_xl.py) on seeded random float32 weights on the CPU: the
module trees at the published widths, the UNet and ControlNet at a tiny
SDXL shape, one guided stage-1 step through make_train_step, the refine on
the tiny SDXL stack, and SD1.5's tree as it was (the reference's frozen
copy of the SD1.5 UNet is the parent's module).

Both sides get their weights from benchmark/inputs.random_weights, one
normal draw laid out in named_parameters() order, so equal trees get
equal weights. Tolerances: the port in float32 differs from the reference
by the order of its sums (F.scaled_dot_product_attention against written
out attention, the 3x3 conv's plain path); each limit sits about ten
times above what float32 reads here and far below what the port at bf16
reads (1e-2 in the UNet and the ControlNet, 4.6e-2 in the gradient), which
the `bf16` cases hold it to."""

import ast
import os

import pytest
import torch

from benchmark import inputs, stack, stack_xl
from benchmark.entries import stage1_step
from gaussianip_tpu_torch.diffusion import unet as U
from gaussianip_tpu_torch.system import pipeline

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 33 + 19
# the tiny stack of benchmark/tests/configs/gaussianip-sdxl.json
TINY = {
    "precision": "bf16",
    "unet": {"in_channels": 4, "out_channels": 4,
             "block_out_channels": [16, 32, 64], "layers_per_block": 2,
             "cross_attention_dim": 32, "attention_head_dim": [2, 4, 8],
             "transformer_layers_per_block": [0, 2, 3],
             "use_linear_projection": True, "addition_time_embed_dim": 8,
             "projection_class_embeddings_input_dim": 64, "norm_groups": 8,
             "lora_rank": 0, "ip_tokens": 4},
    "controlnet": {"ip_tokens": 0, "conditioning_embed_channels": [8, 16]},
    "vae": {"block_out_channels": [16, 32], "layers_per_block": 1,
            "latent_channels": 4, "norm_groups": 8,
            "scaling_factor": 0.13025},
    "conditioning": {"text_tokens": 8, "context_dim": 32, "pooled_dim": 16,
                     "directions": 13},
    "guidance": {"guidance_scale": 7.5, "guidance_rescale": 0.75,
                 "ipa_scale": 0.5, "use_anpg": True,
                 "use_pose_controlnet": True,
                 "view_dependent_prompting": True, "grad_clip_pixel": True,
                 "grad_clip_threshold": 1.0, "image_size": 32},
    "avatar": {"points": 1500, "capacity": 2048, "sh_degree": 0},
    "init": {"zero_conv_scale": 0.1},
}
# the relative limits (see the module docstring): float32 reads 1.2e-6 in
# the UNet, 8e-7 in the ControlNet's residuals, 0 in the step's loss and
# 3e-6 in its gradient to the render
TOL = {"unet": 1e-5, "controlnet": 1e-5, "loss": 1e-5, "d_rgb": 3e-5}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _tree(m):
    return [(n, tuple(p.shape)) for n, p in m.named_parameters()]


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def _models(root, dtype, cfg=TINY):
    pkg = stack_xl.package(root)
    return pkg, stack.diffusion_models(pkg, cfg, SEED, "cpu", dtype)


@pytest.mark.parametrize("kw", [
    {}, {"ip_tokens": 4},
    {"block_out_channels": (32, 64), "layers_per_block": 1,
     "cross_attention_dim": 32, "attention_head_dim": 4, "norm_groups": 8,
     "ip_tokens": 4}], ids=["sd15", "sd15_ip", "tiny"])
def test_sd15_trees_are_unchanged(kw):
    """UNetConfig()'s UNet and ControlNet carry the names and shapes, in
    order, of the SD1.5 modules as they were (the reference's frozen
    copy), so from_flax and random_weights give them what they did."""
    from benchmark.reference.gip_ref.diffusion import unet as frozen

    with torch.device("meta"):
        for cls in ("UNet2DConditionModel", "ControlNetModel"):
            assert _tree(getattr(U, cls)(U.UNetConfig(**kw))) == _tree(
                getattr(frozen, cls)(frozen.UNetConfig(**kw))), cls


def test_sdxl_trees_match_the_reference_at_published_widths():
    """sdxl_unet_config's UNet (with the 4 identity tokens) and ControlNet
    have the reference's names and shapes in its order; without the
    identity projections the UNet has SDXL base 1.0's 2,567,463,684
    parameters; 70 transformer blocks, 16 transformer layers a call."""
    from benchmark.reference.gip_ref.diffusion import unet_xl as ref

    ucfg = pipeline.sdxl_unet_config(0, 4, torch.float32)
    ccfg = pipeline.sdxl_unet_config(0, 0, torch.float32)
    fields = {k: getattr(ucfg, k)
              for k in ref.UNetConfig.__dataclass_fields__ if k != "dtype"}
    with torch.device("meta"):
        unet = U.UNet2DConditionModel(ucfg)
        cn = U.ControlNetModel(ccfg)
        assert _tree(unet) == _tree(ref.UNet2DConditionModel(
            ref.UNetConfig(**fields)))
        assert _tree(cn) == _tree(ref.ControlNetModel(
            ref.UNetConfig(**{**fields, "ip_tokens": 0})))
        bare = U.UNet2DConditionModel(ccfg)
    assert sum(p.numel() for p in bare.parameters()) == 2_567_463_684
    count = lambda m, kind: sum(type(x).__name__ == kind
                                for x in m.modules())
    assert count(unet, "TransformerBlock") == 70
    assert (count(unet, "Transformer2D"), count(cn, "Transformer2D")) == (
        11, 5)


def test_n_vcr_layers_counts_the_up_levels_with_attention():
    assert pipeline.sdxl_unet_config().n_vcr_layers == 6
    assert pipeline.sd15_unet_config().n_vcr_layers == 9
    assert U.tiny_unet_config().n_vcr_layers == 2
    assert U.UNetConfig(**TINY["unet"]).n_vcr_layers == 6


def test_added_cond_is_required_with_the_added_embedding_only():
    gen = torch.Generator().manual_seed(0)
    lat, t = torch.randn(1, 4, 8, 8), torch.zeros(1, dtype=torch.int64)
    added = (torch.randn(1, 16), U.time_ids(32, 32, 1, "cpu"))
    for cfg, bad in ((U.UNetConfig(**TINY["unet"]), None),
                     (U.tiny_unet_config(), added)):
        unet = pipeline.init_random_(U.UNet2DConditionModel(cfg), gen)
        with pytest.raises(ValueError, match="added"):
            unet(lat, t, torch.randn(1, 5, 32), added_cond=bad)


def _denoise(models, n: int = 3):
    """One ControlNet + UNet call at the tiny shape, inputs from SEED."""
    gen = torch.Generator().manual_seed(SEED)
    lat = torch.randn(n, 4, 16, 16, generator=gen)
    t = torch.randint(20, 980, (n,), generator=gen)
    ctx = torch.randn(n, 8 + 4, 32, generator=gen)
    ctrl = torch.rand(n, 3, 32, 32, generator=gen)
    added = (torch.randn(n, 16, generator=gen), U.time_ids(32, 32, n, "cpu"))
    unet, cn, _ = models
    with torch.no_grad():
        res, mid = cn(lat, t, ctx, ctrl, added_cond=added)
        out = unet(lat, t, ctx, down_block_residuals=res,
                   mid_block_residual=mid, ip_scale=0.5, added_cond=added)
    return torch.cat([r.float().flatten() for r in res + [mid]]), out.float()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_unet_and_controlnet_match_the_reference(dtype):
    """The port at the tiny SDXL shape (3 levels, none on the first, 2 and
    3 blocks, 8-wide heads, linear projections, the added embedding, 4
    identity tokens) against the reference: within the limits in float32,
    outside at bf16."""
    _, port = _models(stack.PROGRAM, DTYPES[dtype])
    _, ref = _models(stack.REFERENCE, torch.float32)
    (pc, pu), (rc, ru) = _denoise(port), _denoise(ref)
    gaps = {"controlnet": _rel(pc, rc), "unet": _rel(pu, ru)}
    if dtype == "f32":
        assert all(gaps[k] < TOL[k] for k in gaps), gaps
    else:
        assert any(gaps[k] > TOL[k] for k in gaps), gaps


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
    on the tiny SDXL stack, 2 views at 32^2."""
    pkg, models = _models(root, dtype)
    tap = _Tap(stack_xl.guidance(pkg, TINY, models, SEED, "cpu"))
    ts = pkg.stage1.init_train_state(stack.avatar(pkg, TINY, SEED, "cpu"))
    p = {"views": 2, "resolution": 32, "d_max": 16}
    step = stage1_step._make_step(pkg, TINY, p, tap)
    _, m = step(ts, inputs.generator(SEED, "steps", "cpu"))
    return float(m["loss"]), tap.d_rgb[0]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_a_guided_step_matches_the_reference(dtype):
    """The stage-1 step's loss and its gradient to the rendered views, the
    port's AHDSGuidance (pooled rows, time ids of 32^2) against the
    reference's: within the limits in float32, outside at bf16."""
    loss, d_rgb = _guided_step(stack.PROGRAM, DTYPES[dtype])
    rloss, rd_rgb = _guided_step(stack.REFERENCE, torch.float32)
    assert float(rd_rgb.abs().max()) > 0
    gaps = {"loss": abs(loss - rloss) / abs(rloss), "d_rgb": _rel(d_rgb,
                                                                  rd_rgb)}
    if dtype == "f32":
        assert all(gaps[k] < TOL[k] for k in gaps), gaps
    else:
        assert any(gaps[k] > TOL[k] for k in gaps), gaps


def test_refine_views_runs_the_tiny_sdxl_stack():
    """Stage 2 on the tiny SDXL stack: the anchors store one state per VCR
    layer (6), and the whole refine of 32 views runs with each view's
    pooled rows."""
    from gaussianip_tpu_torch.system.refine import (RefineModels,
                                                    VIEW_NAME_ALL,
                                                    refine_views)

    _, models = _models(stack.PROGRAM, torch.float32)
    unet = models[0]
    gen = torch.Generator().manual_seed(SEED)
    lat = torch.randn(2, 4, 16, 16, generator=gen)
    added = (torch.randn(2, 16, generator=gen), U.time_ids(32, 32, 2, "cpu"))
    with torch.no_grad():
        _, cache = unet(lat, torch.zeros(2, dtype=torch.int64),
                        torch.randn(2, 12, 32, generator=gen),
                        vcr_mode="store", added_cond=added)
    assert len(cache) == unet.cfg.n_vcr_layers == 6
    images = torch.rand(32, 32, 32, 3, generator=gen)
    ctrl = torch.rand(32, 32, 32, 3, generator=gen)
    contexts = {n: torch.randn(2, 12, 32, generator=gen)
                for n in VIEW_NAME_ALL}
    pooled = {n: torch.randn(2, 16, generator=gen) for n in VIEW_NAME_ALL}
    phases = []
    out = refine_views(RefineModels(*models), images, ctrl, contexts,
                       torch.randn(4, 16, 16, generator=gen), num_steps=1,
                       on_phase=phases.append, pooled=pooled)
    assert phases == ["encode", "anchors", "keys"] + ["dense"] * 6 + [
        "decode"]
    assert out.shape == (32, 32, 32, 3) and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="added"):
        refine_views(RefineModels(*models), images, ctrl, contexts,
                     torch.randn(4, 16, 16, generator=gen), num_steps=1)


def test_a_call_records_the_controlnet_unet_and_transformer_spans():
    """Under the profiler the denoise's ControlNet and UNet calls are the
    spans `controlnet` and `unet`, holding 5 and 11 `transformer` spans."""
    from torch.profiler import ProfilerActivity, profile

    from gaussianip_tpu_torch.utils import profiling

    pkg, models = _models(stack.PROGRAM, torch.float32)
    guid = stack_xl.guidance(pkg, TINY, models, SEED, "cpu")
    gen = torch.Generator().manual_seed(SEED)
    n = 3
    lat = torch.randn(n, 4, 16, 16, generator=gen)
    ctx = torch.randn(n, 12, 32, generator=gen)
    added = (torch.randn(n, 16, generator=gen), U.time_ids(32, 32, n, "cpu"))
    profiling.spans()
    with profile(activities=[ProfilerActivity.CPU]):
        guid.predict_noise(lat, torch.rand(n, 3, 32, 32, generator=gen),
                           torch.zeros(n, dtype=torch.int64), ctx, added)
    got = profiling.spans()
    names = [(r["name"], r["parent"]) for r in got]
    assert names == ([("controlnet", None)]
                     + [("transformer", "controlnet")] * 5
                     + [("unet", None)] + [("transformer", "unet")] * 11)


@pytest.mark.parametrize("name", ["diffusion/unet_xl.py",
                                  "guidance/ipa_xl.py"])
def test_the_sdxl_reference_imports_nothing_of_the_port(name):
    """The reference's SDXL files import only torch and the reference
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
        assert set(tops) <= {"torch", "typing", "dataclasses",
                             "__future__"}, (name, tops)
