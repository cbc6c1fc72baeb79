"""The port stands alone: no module of gaussianip_tpu_torch/, not
chip_smoke.py and not scripts/probe_torch_dp.py imports jax, flax or the
JAX package, nor the packages the JAX package's loaders lean on and the
card's machine does not promise (transformers, safetensors, regex,
ftfy). An AST scan (the test process itself has jax imported, so
sys.modules proves nothing)."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "gaussianip_tpu", "transformers",
             "safetensors", "regex", "ftfy")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "scripts", "probe_torch_dp.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "gaussianip_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_has_sources():
    names = [os.path.relpath(p, ROOT) for p in _sources()]
    assert "chip_smoke.py" in names
    assert os.path.join("gaussianip_tpu_torch", "system", "stage1.py") in names


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    for mod in _imported(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"
