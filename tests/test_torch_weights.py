"""The port's checkpoint files and diffusers-layout converters
(gaussianip_tpu_torch/diffusion/weights.py) against the `safetensors`
package and the JAX package (gaussianip_tpu/diffusion/weights.py).

  * The native .safetensors reader and writer against the package, both
    ways, for F32 / F16 / BF16 / I64 and a __metadata__ header; .bin files
    through torch.load(weights_only=True), nested as the IP-Adapter's.
  * convert_unet (with a rank-4 IP-Adapter state), convert_vae,
    convert_controlnet: the torch mirror models of the JAX package
    (gaussianip_tpu/diffusion/torch_mirror.py) written to disk as in
    tests/test_weight_parity.py, loaded by both packages. The port's
    module is bit-equal to from_flax of the JAX converter's tree, and its
    forward equals the mirror's and the JAX forward within 3e-4 (max
    |diff|, as tests/test_weight_parity.py). convert_proj_plus has no
    mirror: a random ProjPlusModel is exported, loaded by both packages and
    its forward held against the JAX one within 3e-4.
  * fold_lora against the JAX fold_lora, exactly (float16 and float32
    kernels); export_* -> file -> load round trips, bit for bit.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import nchw, nhwc

torch.set_num_threads(1)
TOL = 3e-4
CHS = (32, 64)
CTX = 32
HEADS = 4
GROUPS = 8


def _state_equal(a: torch.nn.Module, b: torch.nn.Module):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


# ---------------------------------------------------------------- files


def _sample_tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "f32": torch.randn((3, 5), generator=g),
        "f16": torch.randn((2, 4, 3), generator=g).half(),
        "bf16": torch.randn((7,), generator=g).bfloat16(),
        "i64": torch.arange(12, dtype=torch.int64).reshape(3, 4) - 5,
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros((0, 4)),
    }


META = {"format": "pt", "note": "stand-in"}


@pytest.mark.parametrize("direction", ["port_writes", "package_writes"])
def test_safetensors_against_package(tmp_path, direction):
    from safetensors import safe_open
    from safetensors.torch import load_file, save_file

    from gaussianip_tpu_torch.diffusion.weights import read_safetensors
    from gaussianip_tpu_torch.system.standin import write_safetensors

    src = _sample_tensors()
    p = str(tmp_path / "x.safetensors")
    if direction == "port_writes":
        write_safetensors(p, src, META)
        got = load_file(p)
        with safe_open(p, framework="pt") as f:
            meta = f.metadata()
    else:
        save_file(src, p, metadata=META)
        got, meta = read_safetensors(p)
    assert meta == META
    assert got.keys() == src.keys()
    for k, v in src.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


def test_load_torch_state_dict_dtypes(tmp_path):
    """float tensors come back float32 (keep_dtype: the file's dtype),
    integer tensors keep theirs."""
    from gaussianip_tpu_torch.diffusion.weights import load_torch_state_dict
    from gaussianip_tpu_torch.system.standin import write_safetensors

    src = _sample_tensors()
    p = str(tmp_path / "x.safetensors")
    write_safetensors(p, src)
    got = load_torch_state_dict(p)
    kept = load_torch_state_dict(p, keep_dtype=True)
    for k, v in src.items():
        want = torch.float32 if v.is_floating_point() else v.dtype
        assert got[k].dtype == want and kept[k].dtype == v.dtype, k
        assert torch.equal(got[k], v.to(want)), k


def test_bin_nested_weights_only(tmp_path):
    """An IP-Adapter-shaped .bin ({"image_proj": {...}, "ip_adapter":
    {...}}, float16) loads through weights_only=True as nested float32."""
    from gaussianip_tpu.diffusion.weights import load_torch_state_dict as jload
    from gaussianip_tpu_torch.diffusion.weights import load_torch_state_dict

    g = torch.Generator().manual_seed(1)
    src = {"image_proj": {"proj.0.weight": torch.randn((8, 4), generator=g),
                          "norm.bias": torch.randn((8,), generator=g)},
           "ip_adapter": {"0.to_q_lora.down.weight":
                          torch.randn((4, 8), generator=g),
                          "1.to_k_ip.weight": torch.randn((8, 8),
                                                          generator=g)}}
    src = {k: {n: v.half() for n, v in d.items()} for k, d in src.items()}
    p = str(tmp_path / "ipa.bin")
    torch.save(src, p)
    got = load_torch_state_dict(p)
    ref = jload(p)
    for part, d in src.items():
        for n, v in d.items():
            assert got[part][n].dtype == torch.float32
            assert torch.equal(got[part][n], v.float())
            assert np.array_equal(np.asarray(ref[part][n]).astype(np.float32),
                                  got[part][n].numpy())


# ---------------------------------------------------------- converters


def _save(sd, path):
    from safetensors.torch import save_file

    save_file({k: v.contiguous() for k, v in sd.items()}, str(path))


def _both_trees(path, convert, **kw):
    """(port tree, JAX tree) of one checkpoint file."""
    from gaussianip_tpu.diffusion import weights as JW
    from gaussianip_tpu_torch.diffusion import weights as W

    return (getattr(W, convert)(W.load_torch_state_dict(path), **kw),
            getattr(JW, convert)(JW.load_torch_state_dict(path), **kw))


def _loaded_and_reference(ctor, tree, jtree):
    """The port's loaded module and from_flax(ctor(), JAX tree); asserts
    they are bit-equal."""
    from gaussianip_tpu_torch.diffusion.from_flax import from_flax
    from gaussianip_tpu_torch.system.pipeline import load_flax_tree

    m = load_flax_tree(ctor, tree, "cpu")
    _state_equal(m, from_flax(ctor(), jtree))
    return m.eval()


def _max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def test_convert_unet_with_ipa(tmp_path):
    from gaussianip_tpu.diffusion.torch_mirror import UNet2DConditionModelPT
    from gaussianip_tpu.diffusion.unet import UNet2DConditionModel as JUNet
    from gaussianip_tpu.diffusion.unet import UNetConfig as JCfg
    from gaussianip_tpu.diffusion import weights as JW
    from gaussianip_tpu_torch.diffusion import weights as W
    from gaussianip_tpu_torch.diffusion.unet import (UNet2DConditionModel,
                                                     UNetConfig)

    torch.manual_seed(0)
    pt = UNet2DConditionModelPT(CHS, 1, CTX, HEADS, GROUPS, lora_rank=4,
                                ip_tokens=2).eval()
    sd, ipa = pt.export_state_dict()
    _save(sd, tmp_path / "unet.safetensors")
    torch.save({"ip_adapter": {k: v.detach() for k, v in ipa.items()}},
               str(tmp_path / "ipa.bin"))
    ipa_port = W.load_torch_state_dict(str(tmp_path / "ipa.bin"))
    ipa_jax = JW.load_torch_state_dict(str(tmp_path / "ipa.bin"))
    tree = W.convert_unet(
        W.load_torch_state_dict(str(tmp_path / "unet.safetensors")), CHS, 1,
        ipa_state=ipa_port["ip_adapter"])
    jtree = JW.convert_unet(
        JW.load_torch_state_dict(str(tmp_path / "unet.safetensors")), CHS, 1,
        ipa_state={k: np.asarray(v) for k, v in
                   ipa_jax["ip_adapter"].items()})
    kw = dict(block_out_channels=CHS, layers_per_block=1,
              cross_attention_dim=CTX, attention_head_dim=HEADS,
              norm_groups=GROUPS, lora_rank=4, ip_tokens=2)
    m = _loaded_and_reference(lambda: UNet2DConditionModel(UNetConfig(**kw)),
                              tree, jtree)

    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 16, 16, 4)).astype(np.float32)
    ts = np.array([3, 500], np.int64)
    ctx = rng.normal(0, 1, (2, 10, CTX)).astype(np.float32)
    with torch.no_grad():
        ref = nhwc(pt(nchw(x), torch.from_numpy(ts), torch.from_numpy(ctx)))
        got = nhwc(m(nchw(x), torch.from_numpy(ts), torch.from_numpy(ctx)))
    jout, _ = JUNet(JCfg(**kw)).apply(jtree, jnp.asarray(x), jnp.asarray(ts),
                                      jnp.asarray(ctx))
    assert _max_diff(got, ref) < TOL
    assert _max_diff(got, jout) < TOL


def test_convert_vae(tmp_path):
    from gaussianip_tpu.diffusion.torch_mirror import AutoencoderKLPT
    from gaussianip_tpu.diffusion.vae import AutoencoderKL as JVAE
    from gaussianip_tpu.diffusion.vae import VAEConfig as JCfg
    from gaussianip_tpu_torch.diffusion.vae import AutoencoderKL, VAEConfig

    torch.manual_seed(1)
    pt = AutoencoderKLPT((16, 32), 1, latent_channels=4, groups=8).eval()
    p = tmp_path / "vae.safetensors"
    _save(pt.state_dict(), p)
    kw = dict(block_out_channels=(16, 32), layers_per_block=1)
    tree, jtree = _both_trees(str(p), "convert_vae", **kw)
    cfg = dict(norm_groups=8, **kw)
    m = _loaded_and_reference(lambda: AutoencoderKL(VAEConfig(**cfg)), tree,
                              jtree)

    rng = np.random.default_rng(1)
    img = rng.normal(0, 1, (2, 16, 16, 3)).astype(np.float32)
    lat = rng.normal(0, 1, (2, 8, 8, 4)).astype(np.float32)
    jv = JVAE(JCfg(**cfg))
    jm = jnp.concatenate(jv.apply(jtree, jnp.asarray(img),
                                  method=JVAE.encode_moments), axis=-1)
    with torch.no_grad():
        ref_m = nhwc(pt.encode_moments(nchw(img)))
        got_m = nhwc(torch.cat(m.encode_moments(nchw(img)), dim=1))
        # decode() takes scaled latents; the mirror decodes raw z
        ref_d = nhwc(pt.decode(nchw(lat)))
        got_d = nhwc(m.decode(nchw(lat) * m.cfg.scaling_factor))
    jd = jv.apply(jtree, jnp.asarray(lat) * m.cfg.scaling_factor,
                  method=JVAE.decode)
    for got, ref, jref in ((got_m, ref_m, jm), (got_d, ref_d, jd)):
        assert _max_diff(got, ref) < TOL
        assert _max_diff(got, jref) < TOL


def test_convert_controlnet(tmp_path):
    from gaussianip_tpu.diffusion.torch_mirror import ControlNetModelPT
    from gaussianip_tpu.diffusion.unet import ControlNetModel as JCN
    from gaussianip_tpu.diffusion.unet import UNetConfig as JCfg
    from gaussianip_tpu_torch.diffusion.unet import (ControlNetModel,
                                                     UNetConfig)

    torch.manual_seed(2)
    pt = ControlNetModelPT(CHS, 1, CTX, HEADS, GROUPS,
                           conditioning_embed_channels=(8, 16)).eval()
    p = tmp_path / "cn.safetensors"
    _save(pt.state_dict(), p)
    tree, jtree = _both_trees(str(p), "convert_controlnet",
                              block_out_channels=CHS, layers_per_block=1,
                              conditioning_embed_channels=(8, 16))
    kw = dict(block_out_channels=CHS, layers_per_block=1,
              cross_attention_dim=CTX, attention_head_dim=HEADS,
              norm_groups=GROUPS)
    m = _loaded_and_reference(lambda: ControlNetModel(
        UNetConfig(**kw), conditioning_embed_channels=(8, 16)), tree, jtree)

    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 8, 8, 4)).astype(np.float32)
    ts = np.array([7, 300], np.int64)
    ctx = rng.normal(0, 1, (2, 10, CTX)).astype(np.float32)
    cond = rng.normal(0, 1, (2, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        res_ref, mid_ref = pt(nchw(x), torch.from_numpy(ts),
                              torch.from_numpy(ctx), nchw(cond), scale=0.7)
        res, mid = m(nchw(x), torch.from_numpy(ts), torch.from_numpy(ctx),
                     nchw(cond), conditioning_scale=0.7)
    jres, jmid = JCN(JCfg(**kw), conditioning_embed_channels=(8, 16)).apply(
        jtree, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
        jnp.asarray(cond), conditioning_scale=0.7)
    assert len(res) == len(res_ref) == len(jres)
    for a, b, c in zip(res + [mid], res_ref + [mid_ref], list(jres) + [jmid]):
        assert _max_diff(nhwc(a), nhwc(b)) < TOL
        assert _max_diff(nhwc(a), c) < TOL


def test_convert_proj_plus(tmp_path):
    from gaussianip_tpu.diffusion.ip_adapter import ProjPlusModel as JProj
    from gaussianip_tpu_torch.diffusion import weights as W
    from gaussianip_tpu_torch.diffusion.ip_adapter import ProjPlusModel
    from gaussianip_tpu_torch.system.pipeline import init_random_
    from gaussianip_tpu_torch.system.standin import (export_proj_plus,
                                                     flax_tree)

    kw = dict(cross_attention_dim=64, clip_embeddings_dim=32)
    src = init_random_(ProjPlusModel(**kw), torch.Generator().manual_seed(3))
    p = str(tmp_path / "ipa.bin")
    torch.save({"image_proj": {k: torch.as_tensor(v) for k, v in
                               export_proj_plus(flax_tree(src)).items()}},
               p)
    from gaussianip_tpu.diffusion import weights as JW

    tree = W.convert_proj_plus(W.load_torch_state_dict(p)["image_proj"])
    jtree = JW.convert_proj_plus({k: np.asarray(v) for k, v in
                                  JW.load_torch_state_dict(p)[
                                      "image_proj"].items()})
    m = _loaded_and_reference(lambda: ProjPlusModel(**kw), tree, jtree)
    _state_equal(m, src)

    rng = np.random.default_rng(3)
    ide = rng.normal(0, 1, (2, 512)).astype(np.float32)
    clip = rng.normal(0, 1, (2, 257, 32)).astype(np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(ide), torch.from_numpy(clip), shortcut=True,
                scale=0.4).numpy()
    ref = JProj(**kw).apply(jtree, jnp.asarray(ide), jnp.asarray(clip),
                            shortcut=True, scale=0.4)
    assert _max_diff(got, ref) < TOL


@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_fold_lora_matches_jax(dtype):
    from gaussianip_tpu.diffusion.weights import fold_lora as jfold
    from gaussianip_tpu_torch.diffusion.weights import fold_lora

    rng = np.random.default_rng(4)
    lora = lambda i, o: {
        "main": {"kernel": rng.normal(0, 1, (i, o)).astype(dtype),
                 "bias": rng.normal(0, 1, (o,)).astype(dtype)},
        "lora_down": {"kernel": rng.normal(0, 1, (i, 4)).astype(dtype)},
        "lora_up": {"kernel": rng.normal(0, 1, (4, o)).astype(dtype)}}
    tree = {"params": {"a": {"to_q": lora(8, 16), "to_out": lora(16, 8),
                             "norm": {"scale": np.ones(8, dtype)}},
                       "b": lora(5, 3)}}
    got, ref = fold_lora(tree, 0.7), jfold(tree, 0.7)

    def walk(x, y):
        assert type(x) is type(y)
        if isinstance(x, dict):
            assert x.keys() == y.keys()
            for k in x:
                walk(x[k], y[k])
        else:
            assert x.dtype == y.dtype and np.array_equal(x, y)

    walk(got, ref)
    assert set(got["params"]["a"]["to_q"]) == {"main"}


def _roundtrip_cases():
    from gaussianip_tpu_torch.diffusion.ip_adapter import ProjPlusModel
    from gaussianip_tpu_torch.diffusion.unet import (ControlNetModel,
                                                     UNet2DConditionModel,
                                                     tiny_unet_config)
    from gaussianip_tpu_torch.diffusion.vae import (AutoencoderKL,
                                                    tiny_vae_config)

    ucfg = tiny_unet_config(ip_tokens=4, lora_rank=4)
    vcfg = tiny_vae_config()
    return {
        "unet": (lambda: UNet2DConditionModel(ucfg), "export_unet",
                 "convert_unet", dict(block_out_channels=(32, 64),
                                      layers_per_block=1)),
        "vae": (lambda: AutoencoderKL(vcfg), "export_vae", "convert_vae",
                dict(block_out_channels=(16, 32), layers_per_block=1)),
        "controlnet": (lambda: ControlNetModel(
            tiny_unet_config(), conditioning_embed_channels=(8, 16)),
            "export_controlnet", "convert_controlnet",
            dict(block_out_channels=(32, 64), layers_per_block=1,
                 conditioning_embed_channels=(8, 16))),
        "proj_plus": (functools.partial(ProjPlusModel, cross_attention_dim=64,
                                        clip_embeddings_dim=32),
                      "export_proj_plus", "convert_proj_plus", {}),
    }


@pytest.mark.parametrize("which", ["unet", "vae", "controlnet", "proj_plus"])
@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_export_load_roundtrip(tmp_path, which, fmt):
    """A random module -> export_* -> a float32 file -> load -> convert_*
    -> the module again, bit for bit (the UNet with its LoRA and IP
    projections through the IP-Adapter dict)."""
    from gaussianip_tpu_torch.diffusion import weights as W
    from gaussianip_tpu_torch.system import standin
    from gaussianip_tpu_torch.system.pipeline import (init_random_,
                                                      load_flax_tree)

    ctor, export, convert, kw = _roundtrip_cases()[which]
    src = init_random_(ctor(), torch.Generator().manual_seed(5))
    out = getattr(standin, export)(standin.flax_tree(src), **kw)
    sd, extra = out if which == "unet" else (out, None)
    as_t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}
    p = str(tmp_path / f"x.{fmt}")
    if fmt == "safetensors":
        standin.write_safetensors(p, as_t(sd))
    else:
        torch.save(as_t(sd), p)
    loaded = W.load_torch_state_dict(p)
    conv_kw = dict(kw)
    if extra is not None:
        torch.save({"ip_adapter": as_t(extra)}, str(tmp_path / "ipa.bin"))
        conv_kw["ipa_state"] = W.load_torch_state_dict(
            str(tmp_path / "ipa.bin"))["ip_adapter"]
    m = load_flax_tree(ctor, getattr(W, convert)(loaded, **conv_kw), "cpu")
    _state_equal(m, src)
