"""The one seam between Python and the hand-written kernels of csrc/:
build, bind, check, launch and count.

Each `csrc/<name>.cu` compiles on first use into
`gaussianip_tpu_torch/build/lib<name>-<hash>.so` (the hash covers the
source, every `csrc/*.cuh` header and all the flags, so an edited source,
header or flag rebuilds), with a plain C interface:
    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
A wrapper module declares its library's `extern "C"` functions as a
`Library` (one kind letter a parameter, every function returning int),
checks its tensors with `expect`, calls a kernel through `launch` (the
current stream appended, a nonzero return raised, the launches counted)
and registers each counting function with `counts` (the registry,
complete once `gaussianip_tpu_torch.kernels` is imported). Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

H100_SMS = 132  # the H100's streaming multiprocessors
# a parameter's kind in a signature: a pointer (a tensor's address, None for
# NULL, the stream), int, long long, float
KINDS = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong,
         "f": ctypes.c_float}

_loaded: dict[str, ctypes.CDLL] = {}
ptxas_log: dict[str, str] = {}
LIBRARIES: dict[str, "Library"] = {}  # csrc/<name>.cu -> its bindings
COUNTERS: dict = {}  # kernel name -> the wrapper counting its launches


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (PATH or {path})")
    return path


def _target(name: str) -> str:
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            h.update(b"\0" + f.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names) -> dict[str, str]:
    """Compile every named source that is not built yet, all nvcc processes
    started together. Returns {name: path to the shared library}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _target(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, n + ".cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        ptxas_log[n] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{n}.cu:\n{log}")
        os.replace(tmp, paths[n])
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build([name])[name])
        _loaded[name] = lib
    return lib


@functools.cache
def tensor_map_encoder() -> int:
    """libcuda's cuTensorMapEncodeTiled, as an address for the C side of
    the TMA kernels (libcuda is already loaded by PyTorch; nothing links
    against it)."""
    fn = ctypes.CDLL("libcuda.so.1").cuTensorMapEncodeTiled
    return ctypes.cast(fn, ctypes.c_void_p).value


class Library:
    """The `extern "C"` functions of csrc/<name>.cu, declared by signature:
    `Library("k", k_fwd="ppii")` binds k_fwd(void*, void*, int, int)
    returning int. The library is built, loaded and bound on the first
    access to one of its functions, which then is a plain attribute."""

    def __init__(self, name: str, **signatures: str):
        if name in LIBRARIES:
            raise ValueError(f"csrc/{name}.cu is bound twice")
        self.name = name
        self.signatures = signatures
        LIBRARIES[name] = self

    def __getattr__(self, fn: str):
        # reached only while `fn` is not bound yet
        if fn not in self.__dict__.get("signatures", ()):
            raise AttributeError(f"csrc/{self.name}.cu binds no {fn}")
        lib = load(self.name)
        for f, kinds in self.signatures.items():
            c = getattr(lib, f)
            c.argtypes = [KINDS[k] for k in kinds]
            c.restype = ctypes.c_int
            setattr(self, f, c)
        return self.__dict__[fn]


def launch(counter, fn, *args, count: int = 1) -> None:
    """fn(*args, the current stream's handle): a bound entry point, which
    returns 0 or an error code. Raises RuntimeError naming fn on an error;
    otherwise adds `count` kernels to `counter.launches`."""
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: error {err}")
    counter.launches += count


def counts(name: str):
    """Decorator: register the function as the launch counter of kernel
    `name`, its `.launches` starting at 0."""
    def register(fn):
        if name in COUNTERS:
            raise ValueError(f"kernel {name} already has a launch counter")
        fn.launches = 0
        COUNTERS[name] = fn
        return fn
    return register


def expect(name: str, t: torch.Tensor, dtype, shape, device,
           channels_last: bool = False, align: int = 0) -> None:
    """Raise ValueError unless `t` is a `dtype` tensor of `shape` on
    `device`, contiguous (in channels_last memory when asked), its address
    a multiple of `align` bytes when `align`."""
    # one check a launch: the cheapest comparisons first, no tuple built
    if t.dtype != dtype or t.shape != shape or t.device != device \
            or not (t.is_contiguous(memory_format=torch.channels_last)
                    if channels_last else t.is_contiguous()) \
            or (align and t.data_ptr() % align):
        where = " in channels_last memory" if channels_last else ""
        where += f", {align}-byte aligned" if align else ""
        raise ValueError(
            f"{name}: want contiguous {dtype} {tuple(shape)} on {device}"
            f"{where}; got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"strides {t.stride()}")
