"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles on first use into
`gaussianip_tpu_torch/build/lib<name>-<hash>.so` (the hash covers the
source, every `csrc/*.cuh` header and all the flags, so an edited source,
header or flag rebuilds), with a plain C interface:
    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
ptxas_log: dict[str, str] = {}


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
