"""The port's seam to its CUDA sources (gaussianip_tpu_torch/_nvcc.py) and
the registry of launch counters (gaussianip_tpu_torch/kernels.py), on the
CPU: a library is named by a hash of its source, every csrc/*.cuh header
and all the flags, so an edit to any of them builds anew; every
`extern "C"` function is bound once, as its declaration reads; a launch
passes the stream, raises on an error and counts only successes; `expect`
holds a tensor to its contract; the registry counts each call's launches.
Needs no nvcc and no card."""

import ctypes
import os
import re
import types

import pytest
import torch

from gaussianip_tpu_torch import _nvcc, kernels


def _csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n__global__ void k() {}\n')
    (csrc / "h.cuh").write_text("constexpr int A = 1;\n")
    monkeypatch.setattr(_nvcc, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_nvcc, "BUILD_DIR", str(tmp_path / "build"))
    return csrc


def test_target_changes_with_source_header_and_flags(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    first = _nvcc._target("k")
    assert first == _nvcc._target("k")
    assert os.path.dirname(first) == str(tmp_path / "build")
    seen = {first}
    for edit in (lambda: (csrc / "h.cuh").write_text("constexpr int A = 2;\n"),
                 lambda: (csrc / "g.cuh").write_text("// a new header\n"),
                 lambda: (csrc / "k.cu").write_text("// edited\n"),
                 lambda: monkeypatch.setattr(
                     _nvcc, "NVCC_FLAGS", _nvcc.NVCC_FLAGS + ("-lcuda",))):
        edit()
        seen.add(_nvcc._target("k"))
    assert len(seen) == 5


def test_build_reuses_a_built_target(tmp_path, monkeypatch):
    """A library already built under its hash is reused: no nvcc runs (this
    machine has none)."""
    _csrc(tmp_path, monkeypatch)
    path = _nvcc._target("k")
    os.makedirs(os.path.dirname(path))
    open(path, "wb").close()
    monkeypatch.setattr(_nvcc, "_nvcc", lambda: (_ for _ in ()).throw(
        AssertionError("nvcc ran for a built target")))
    assert _nvcc.build(["k"]) == {"k": path}


C_KINDS = {"int": "i", "long long": "l", "float": "f"}


def _extern_c(src: str) -> dict:
    """{name: (return type, [parameter declarations])} of every function
    a CUDA source declares `extern "C"`, alone or in a block."""
    src = re.sub(r"//[^\n]*|/\*.*?\*/", "", src, flags=re.S)
    decls = []
    for m in re.finditer(r'extern\s+"C"\s*', src):
        rest = src[m.end():]
        if not rest.startswith("{"):
            decls.append(rest[:rest.index("{")])
            continue
        depth, top = 0, []  # the block's text outside function bodies
        for ch in rest[1:]:
            if ch == "}" and depth == 0:
                break
            depth += (ch == "{") - (ch == "}")
            if depth == 0 and ch not in "{}":
                top.append(ch)
            elif ch == "{" and depth == 1:
                top.append(";")
        decls += "".join(top).split(";")
    out = {}
    for d in decls:
        m = re.fullmatch(r"\s*([\w\s\*]+?)\s*\b(\w+)\s*\(([^()]*)\)\s*", d)
        if m:
            out[m.group(2)] = (m.group(1), [p.strip() for p in
                                            m.group(3).split(",")])
    return out


def _kind(param: str) -> str:
    if "*" in param or param.startswith("cudaStream_t"):
        return "p"
    return C_KINDS[param.rsplit(" ", 1)[0].replace("const ", "").strip()]


SOURCES = sorted(f[:-3] for f in os.listdir(_nvcc.CSRC_DIR)
                 if f.endswith(".cu"))


@pytest.mark.parametrize("name", SOURCES)
def test_every_extern_c_function_has_one_binding(name):
    """Each `extern "C"` function of csrc/<name>.cu is bound once, under
    its name, with its parameters' count and kinds, returning int; the
    binding table names no function the source lacks."""
    with open(os.path.join(_nvcc.CSRC_DIR, name + ".cu")) as f:
        decls = _extern_c(f.read())
    assert decls, name
    table = _nvcc.LIBRARIES[name].signatures
    assert set(table) == set(decls)
    for fn, (ret, params) in decls.items():
        assert ret == "int", fn
        assert table[fn] == "".join(_kind(p) for p in params), fn


def test_every_binding_has_a_source():
    assert sorted(_nvcc.LIBRARIES) == SOURCES


def test_library_binds_on_first_use(monkeypatch):
    """A function's argtypes and restype come from its signature; the
    library loads once, and a bound function is a plain attribute."""
    monkeypatch.setattr(_nvcc, "LIBRARIES", {})
    loads = []
    fake = types.SimpleNamespace(f=types.SimpleNamespace(),
                                 g=types.SimpleNamespace())
    monkeypatch.setattr(_nvcc, "load", lambda n: loads.append(n) or fake)
    lib = _nvcc.Library("k", f="pilf", g="")
    assert _nvcc.LIBRARIES == {"k": lib} and not loads
    assert lib.f is fake.f and lib.g is fake.g and loads == ["k"]
    assert fake.f.argtypes == [ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_longlong, ctypes.c_float]
    assert fake.g.argtypes == [] and fake.f.restype is ctypes.c_int
    with pytest.raises(AttributeError, match="binds no h"):
        lib.h
    with pytest.raises(ValueError, match="bound twice"):
        _nvcc.Library("k")


@pytest.mark.parametrize("err", [0, 1, -1, 700])
def test_launch_appends_the_stream_and_counts_successes(err, monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=77))
    calls = []

    def k_fwd(*args):
        calls.append(args)
        return err

    counter = types.SimpleNamespace(launches=5)
    if err:
        with pytest.raises(RuntimeError, match=f"k_fwd failed: error {err}"):
            _nvcc.launch(counter, k_fwd, 1, None, count=3)
    else:
        _nvcc.launch(counter, k_fwd, 1, None, count=3)
    assert calls == [(1, None, 77)]
    assert counter.launches == (5 if err else 8)


def _nhwc(offset=0):
    """bf16 [2, 16, 4, 4] in channels_last memory, `offset` elements past
    an allocation's start."""
    flat = torch.zeros(offset + 2 * 4 * 4 * 16, dtype=torch.bfloat16)
    return flat[offset:].view(2, 4, 4, 16).permute(0, 3, 1, 2)


EXPECT_CASES = {"ok": lambda: _nhwc(), "dtype": lambda: _nhwc().float(),
                "shape": lambda: _nhwc()[:1],
                "device": lambda: _nhwc().to("meta"),
                "layout": lambda: _nhwc().contiguous(),
                "alignment": lambda: _nhwc(offset=1)}


@pytest.mark.parametrize("case", sorted(EXPECT_CASES))
def test_expect(case):
    """`expect` passes a tensor of the contract and, when one property is
    off, raises naming the tensor and the contract."""
    t = EXPECT_CASES[case]()
    args = ("x", t, torch.bfloat16, (2, 16, 4, 4), torch.device("cpu"))
    if case == "ok":
        _nvcc.expect(*args, channels_last=True, align=16)
        return
    with pytest.raises(ValueError, match=r"^x: want contiguous "
                       r"torch.bfloat16 \(2, 16, 4, 4\) on cpu in "
                       r"channels_last memory, 16-byte aligned; got"):
        _nvcc.expect(*args, channels_last=True, align=16)


COUNTING = {"K1": "composite_fwd_cuda", "K2": "composite_bwd_gaussians_cuda",
            "K3": "conv3x3_cuda", "K3_hopper": "conv3x3_hopper",
            "K3_general": "conv3x3_general", "K4_fwd": "groupnorm_fwd_cuda",
            "K4_bwd": "groupnorm_bwd_cuda", "K5_fwd": "attention_fwd_cuda",
            "K5_bwd": "attention_bwd_cuda"}


def test_registry_holds_every_counting_wrapper():
    """Every function of the four wrapper modules that counts launches is
    registered once, under its kernel's name."""
    found = {}
    for mod in (kernels.composite_cuda, kernels.conv3x3_cuda,
                kernels.groupnorm_cuda, kernels.vae_attention_cuda):
        for name, obj in vars(mod).items():
            if callable(obj) and hasattr(obj, "launches"):
                found[name] = obj
    assert {k: f.__name__ for k, f in kernels.COUNTERS.items()} == COUNTING
    assert sorted(found) == sorted(COUNTING.values())
    assert all(kernels.COUNTERS[k] is found[v] for k, v in COUNTING.items())


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_count_launches_counts_one_call(device, monkeypatch):
    """Each kernel's launches in the call alone, whatever the counters held
    before; a CUDA device is synchronised before and after the call."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda: synced.append(len(ran)))
    ran = []
    c = kernels.COUNTERS
    monkeypatch.setattr(c["K4_fwd"], "launches", 7)
    monkeypatch.setattr(c["K3"], "launches", c["K3"].launches)

    def fn():
        ran.append(1)
        c["K4_fwd"].launches += 4
        c["K3"].launches += 1
        return "out"

    out, got = kernels.count_launches(fn, device)
    assert out == "out"
    assert got == {k: {"K4_fwd": 4, "K3": 1}.get(k, 0) for k in COUNTING}
    assert synced == ([0, 1] if device == "cuda" else [])
