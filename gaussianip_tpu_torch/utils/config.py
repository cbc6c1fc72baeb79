"""Config system: YAML + ${...} resolvers + C() scheduled scalars (port of
gaussianip_tpu/utils/config.py), on the standard library alone: the YAML
is read and written by utils/yamlio.py, which resolves scalars as PyYAML
does, so a config loads to the same dict in both packages.

  * load_config(path, *cli_overrides) merges a YAML file with dotted-path
    CLI overrides ("trainer.max_steps=100"), each value read as a YAML
    scalar (a value that is not valid YAML stays a string);
  * ${a.b.c} interpolation and the ${rmspace:...} resolver of `tag`
    (configs/exp.yaml);
  * C(value, step): scheduled scalars — plain numbers pass through,
    [start_step, start_val, end_val, end_step] interpolates linearly.
"""

from __future__ import annotations

import os
import re
from datetime import datetime
from typing import Any, Dict

from . import yamlio

# no braces inside the group: matches the INNERMOST interpolation first so
# nested forms like ${rmspace:${a.b},_} resolve inside-out
_INTERP = re.compile(r"\$\{([^{}]+)\}")


def _lookup(cfg: Dict, dotted: str):
    cur = cfg
    for part in dotted.split("."):
        cur = cur[part]
    return cur


def _resolve_expr(expr: str, root):
    """Resolve one ${...} body: either 'rmspace:<inner>,<char>' or a path."""
    if expr.startswith("rmspace:"):
        body, repl = expr[len("rmspace:"):].rsplit(",", 1)
        return str(_resolve_value(body.strip(), root)).replace(" ", repl)
    return _resolve_value(_lookup(root, expr), root)


def _resolve_value(v, root):
    # innermost-first so nested forms like ${rmspace:${a.b},_} resolve
    prev = None
    while isinstance(v, str) and "${" in v and v != prev:
        prev = v
        m = _INTERP.fullmatch(v.strip())
        if m:  # whole-string interpolation keeps the resolved type
            v = _resolve_expr(m.group(1), root)
        else:
            v = _INTERP.sub(lambda mm: str(_resolve_expr(mm.group(1), root)), v)
    return v


def _resolve_tree(node, root):
    if isinstance(node, dict):
        return {k: _resolve_tree(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_tree(v, root) for v in node]
    return _resolve_value(node, root)


def _parse_scalar(s: str):
    try:
        return yamlio.load(s)
    except ValueError:
        return s


def set_dotted(cfg: Dict, dotted: str, value):
    parts = dotted.split(".")
    cur = cfg
    for p in parts[:-1]:
        cur = cur.setdefault(p, {})
    cur[parts[-1]] = value


def load_config(path: str, *overrides: str) -> Dict:
    """YAML + 'a.b.c=value' CLI dot-list overrides + interpolation."""
    with open(path) as f:
        cfg = yamlio.load(f.read())
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override '{ov}' must be key=value")
        k, v = ov.split("=", 1)
        set_dotted(cfg, k.strip(), _parse_scalar(v))
    return _resolve_tree(cfg, cfg)


def save_config(cfg: Dict, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(yamlio.dump(cfg))


def C(value: Any, step: int) -> float:
    """Scheduled scalar. Numbers pass through; [start_step, start_val,
    end_val, end_step] interpolates linearly (the legacy 3-element
    [start_val, end_val, end_step] form starts at step 0)."""
    if isinstance(value, (int, float)):
        return float(value)
    value = list(value)
    if len(value) == 3:
        value = [0] + value
    if len(value) != 4:
        raise ValueError(f"bad schedule {value}")
    start_step, start_value, end_value, end_step = value
    if isinstance(end_step, int):
        t = max(min(1.0, (step - start_step) / max(end_step - start_step, 1)), 0.0)
    else:
        t = max(min(1.0, (step - start_step) / max(end_step - start_step, 1e-8)),
                0.0)
    return float(start_value + (end_value - start_value) * t)


def timestamp() -> str:
    return datetime.now().strftime("%Y%m%d-%H%M%S")
