"""The port's weight-parity harness (python -m
gaussianip_tpu_torch.weight_parity compare) on a recording made as
`record` makes one, at tiny widths on the CPU.

The JAX package's torch mirrors of the diffusers models
(gaussianip_tpu/diffusion/torch_mirror.py), at the widths of
tests/test_torch_weights.py, are written to .safetensors in the released
layout and run on tiny inputs shaped as fixed_inputs()'s (same seed, NHWC;
latents 8^2, pose maps 64^2, 10 context tokens of width 32). Their outputs
go into an .npz under the script's keys. The port's compare, given the
tiny configs, passes that recording (float32, max |diff| < 5e-3); with one
UNet tensor of a copy of the file moved by 1e-1 it fails unet_out alone;
the same recording passes the JAX script's compare (scripts/weight_parity.py,
its models at the tiny widths), so that one recording serves both.
"""

import argparse
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHS = (32, 64)
CTX = 32
HEADS = 4
GROUPS = 8
VAE_CHS = (16, 32)
PLANTED = "down_blocks.1.resnets.0.conv1.weight"
# the tiny ControlNet's residuals: conv_in's, one per resnet (1 x 2
# blocks) and the one downsample's
KEYS = ["unet_out", "vae_mean", "vae_dec", *(f"cn_res_{i}" for i in range(4)),
        "cn_mid"]


def tiny_inputs():
    """fixed_inputs()'s draws at tiny shapes."""
    from gaussianip_tpu_torch.weight_parity import SEED, TS

    rng = np.random.default_rng(SEED)
    return {
        "lat": rng.normal(0, 1, (2, 8, 8, 4)).astype(np.float32),
        "img": rng.normal(0, 0.5, (1, 16, 16, 3)).astype(np.float32),
        "ctx": rng.normal(0, 1, (2, 10, CTX)).astype(np.float32),
        "cond": rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32),
        "ts": TS,
    }


def _save(sd, path):
    from safetensors.torch import save_file

    save_file({k: v.detach().contiguous() for k, v in sd.items()}, path)


def _record(unet, vae, cn, x, path):
    """What `record` stores, from the mirrors (diffusers' call
    conventions: raw latents into decode, the posterior mean)."""
    from _torch_parity import nchw, nhwc

    out = dict(x)
    with torch.no_grad():
        ts, ctx = torch.from_numpy(x["ts"]), torch.from_numpy(x["ctx"])
        out["unet_out"] = nhwc(unet(nchw(x["lat"]), ts, ctx))
        moments = vae.encode_moments(nchw(x["img"]))
        out["vae_mean"] = nhwc(moments[:, :4])
        out["vae_dec"] = nhwc(vae.decode(nchw(x["lat"][:1])))
        res, mid = cn(nchw(x["lat"]), ts, ctx, nchw(x["cond"]))
        for i, r in enumerate(res):
            out[f"cn_res_{i}"] = nhwc(r)
        out["cn_mid"] = nhwc(mid)
    np.savez(path, **out)
    return out


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """{"files": released-layout checkpoints of the mirrors, "ref": the
    recording's path}; the ControlNet keeps the released conditioning
    embedding (16, 32, 96, 256)."""
    from gaussianip_tpu.diffusion.torch_mirror import (AutoencoderKLPT,
                                                       ControlNetModelPT,
                                                       UNet2DConditionModelPT)

    d = tmp_path_factory.mktemp("weights")
    torch.manual_seed(0)
    unet = UNet2DConditionModelPT(CHS, 1, CTX, HEADS, GROUPS).eval()
    vae = AutoencoderKLPT(VAE_CHS, 1, latent_channels=4, groups=8).eval()
    cn = ControlNetModelPT(CHS, 1, CTX, HEADS, GROUPS).eval()
    files = {k: str(d / f"{k}.safetensors") for k in ("unet", "vae",
                                                       "controlnet")}
    _save(unet.export_state_dict()[0], files["unet"])
    _save(vae.state_dict(), files["vae"])
    _save(cn.state_dict(), files["controlnet"])
    ref = str(d / "ref.npz")
    _record(unet, vae, cn, tiny_inputs(), ref)
    return {"files": files, "ref": ref, "dir": d}


def _args(ref, files, ipa=None):
    from gaussianip_tpu_torch.weight_parity import parse_args

    return parse_args(["compare", "--ref", ref, "--unet", files["unet"],
                       "--vae", files["vae"], "--controlnet",
                       files["controlnet"], "--device", "cpu",
                       *(["--ipa", ipa] if ipa else [])])


def _tiny_configs(**unet_kw):
    from gaussianip_tpu_torch.diffusion.unet import tiny_unet_config
    from gaussianip_tpu_torch.diffusion.vae import tiny_vae_config

    return dict(unet_cfg=tiny_unet_config(**unet_kw),
                vae_cfg=tiny_vae_config(), cn_cfg=tiny_unet_config())


def _lines(text):
    """{output key: its check line}."""
    return {ln.split(":")[0]: ln for ln in text.strip().splitlines()
            if ":" in ln and not ln.startswith("launches")}


def test_compare_passes_faithful_recording(recorded, capsys):
    from gaussianip_tpu_torch.weight_parity import compare

    fails = compare(_args(recorded["ref"], recorded["files"]),
                    **_tiny_configs())
    lines = _lines(capsys.readouterr().out)
    assert fails == 0, lines
    assert sorted(lines) == sorted(KEYS)
    assert all(ln.endswith(" OK") for ln in lines.values())


def test_compare_fails_planted_fault(recorded, capsys):
    from safetensors.torch import load_file

    from gaussianip_tpu_torch.weight_parity import compare

    sd = load_file(recorded["files"]["unet"])
    sd[PLANTED] = sd[PLANTED] + 0.1
    files = dict(recorded["files"], unet=str(recorded["dir"]
                                           / "bad.safetensors"))
    _save(sd, files["unet"])
    fails = compare(_args(recorded["ref"], files), **_tiny_configs())
    lines = _lines(capsys.readouterr().out)
    assert fails == 1
    assert lines["unet_out"].endswith(" FAIL")
    assert all(ln.endswith(" OK") for k, ln in lines.items()
               if k != "unet_out")


def test_compare_exit_codes(recorded, monkeypatch, tmp_path):
    """main() exits 0 on the recording and 1 on a failing one (the
    recording's UNet output moved by 1e-1), through the CLI alone."""
    from gaussianip_tpu_torch import weight_parity as wp

    monkeypatch.setattr(wp, "published_configs", lambda ipa: (
        _tiny_configs()["unet_cfg"], _tiny_configs()["vae_cfg"],
        _tiny_configs()["cn_cfg"]))
    argv = ["compare", "--ref", recorded["ref"], "--unet",
            recorded["files"]["unet"], "--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        wp.main(argv)
    assert e.value.code == 0
    bad = dict(np.load(recorded["ref"]))
    bad["unet_out"] = bad["unet_out"] + 0.1
    np.savez(tmp_path / "bad.npz", **bad)
    argv[2] = str(tmp_path / "bad.npz")
    with pytest.raises(SystemExit) as e:
        wp.main(argv)
    assert e.value.code == 1


def test_compare_with_ip_adapter(tmp_path, capsys):
    """--ipa: the UNet's runtime LoRA and IP projections from the
    IP-Adapter .bin, as the JAX script loads them."""
    from gaussianip_tpu.diffusion.torch_mirror import UNet2DConditionModelPT
    from _torch_parity import nchw, nhwc

    from gaussianip_tpu_torch.weight_parity import compare, parse_args

    torch.manual_seed(1)
    pt = UNet2DConditionModelPT(CHS, 1, CTX, HEADS, GROUPS, lora_rank=4,
                                ip_tokens=2).eval()
    sd, ipa = pt.export_state_dict()
    _save(sd, str(tmp_path / "unet.safetensors"))
    torch.save({"ip_adapter": {k: v.detach() for k, v in ipa.items()}},
               str(tmp_path / "ipa.bin"))
    x = tiny_inputs()
    with torch.no_grad():
        x["unet_out"] = nhwc(pt(nchw(x["lat"]), torch.from_numpy(x["ts"]),
                                torch.from_numpy(x["ctx"])))
    np.savez(tmp_path / "ref.npz", **x)
    args = parse_args(["compare", "--ref", str(tmp_path / "ref.npz"),
                       "--unet", str(tmp_path / "unet.safetensors"),
                       "--ipa", str(tmp_path / "ipa.bin"), "--device",
                       "cpu"])
    cfgs = _tiny_configs(lora_rank=4, ip_tokens=2)
    assert compare(args, unet_cfg=cfgs["unet_cfg"]) == 0
    assert _lines(capsys.readouterr().out)["unet_out"].endswith(" OK")


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_weight_parity", os.path.join(ROOT, "scripts", "weight_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_same_recording_passes_jax_script(recorded, monkeypatch, capsys):
    """scripts/weight_parity.py's compare on the same recording, its
    configs and converters at the tiny widths."""
    from gaussianip_tpu.diffusion import unet as junet
    from gaussianip_tpu.diffusion import vae as jvae
    from gaussianip_tpu.diffusion import weights as jw

    monkeypatch.setattr(junet, "UNetConfig", functools.partial(
        junet.UNetConfig, block_out_channels=CHS, layers_per_block=1,
        cross_attention_dim=CTX, attention_head_dim=HEADS,
        norm_groups=GROUPS))
    monkeypatch.setattr(jvae, "VAEConfig", functools.partial(
        jvae.VAEConfig, block_out_channels=VAE_CHS, layers_per_block=1,
        norm_groups=8))
    for name, chs in (("convert_unet", CHS), ("convert_vae", VAE_CHS),
                      ("convert_controlnet", CHS)):
        monkeypatch.setattr(jw, name, functools.partial(
            getattr(jw, name), block_out_channels=chs, layers_per_block=1))
    f = recorded["files"]
    args = argparse.Namespace(ref=recorded["ref"], unet=f["unet"], ipa=None,
                              vae=f["vae"], controlnet=f["controlnet"])
    with pytest.raises(SystemExit) as e:
        _jax_script().compare(args)
    lines = _lines(capsys.readouterr().out)
    assert e.value.code == 0, lines
    assert sorted(lines) == sorted(KEYS)


def test_record_needs_diffusers(tmp_path):
    from gaussianip_tpu_torch.weight_parity import parse_args, record

    try:
        import diffusers  # noqa: F401
        pytest.skip("diffusers is installed: record would load models")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="diffusers"):
        record(parse_args(["record", "--out", str(tmp_path / "r.npz"),
                           "--unet", "none"]))


def test_fixed_inputs_match_jax_script():
    from gaussianip_tpu_torch.weight_parity import fixed_inputs

    got, want = fixed_inputs(), _jax_script().fixed_inputs()
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k
