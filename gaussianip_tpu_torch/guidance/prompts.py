"""View-dependent prompt processing (port of
gaussianip_tpu/guidance/prompts.py): the FaceID 13-direction table with its
overwrite-in-order index, the (pos, neg, null) stacked text embeddings, the
disk-cached embedding table, the deterministic fake text encoder, the
classic 4-direction table and the prompt-library lookup."""

from __future__ import annotations

import hashlib
import json
import os
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch


def _faceid_directions(head_offset: float):
    """(name, prompt template, condition(e, a, c, v, d)) in reference order;
    later entries overwrite earlier ones."""
    t = lambda suffix: (lambda s: f"{s}, {suffix}")
    return [
        ("left front", t("left front view"),
         lambda e, a, c, v, d: (v == 0) & (a > 0) & (a < 45)),
        ("left back", t("left back view"),
         lambda e, a, c, v, d: (v == 0) & (a > -45) & (a < 0)),
        ("right front", t("right front view"),
         lambda e, a, c, v, d: (v == 0) & (a > 135)),
        ("right back", t("right back view"),
         lambda e, a, c, v, d: (v == 0) & (a < -135)),
        ("front", t("front view"),
         lambda e, a, c, v, d: (v == 0) & (a > 45) & (a < 135)),
        ("back", t("back view"),
         lambda e, a, c, v, d: (v == 0) & (a > -135) & (a < -45)),
        ("left front fb", t("full body photo, left front view"),
         lambda e, a, c, v, d: (v == 1) & (a > 0) & (a < 45)),
        ("left back fb", t("full body photo, left back view"),
         lambda e, a, c, v, d: (v == 1) & (a > -45) & (a < 0)),
        ("right front fb", t("full body photo, right front view"),
         lambda e, a, c, v, d: (v == 1) & (a > 135)),
        ("right back fb", t("full body photo, right back view"),
         lambda e, a, c, v, d: (v == 1) & (a < -135)),
        ("front fb", t("full body photo, front view"),
         lambda e, a, c, v, d: (v == 1) & (a > 45) & (a < 135)),
        ("back fb", t("full body photo, back view"),
         lambda e, a, c, v, d: (v == 1) & (a > -135) & (a < -45)),
        ("overhead", t("overhead view"),
         lambda e, a, c, v, d: (c == head_offset) & (a > 0)),
    ]


def _index(table, elevation, azimuth, center_z, all_vis, camera_distances):
    idx = torch.zeros(azimuth.shape, dtype=torch.long, device=azimuth.device)
    for i, (_, _, cond) in enumerate(table):
        m = cond(elevation, azimuth, center_z, all_vis, camera_distances)
        idx = torch.where(m, torch.full_like(idx, i), idx)
    return idx


def direction_index(elevation, azimuth, center_z, all_vis, camera_distances,
                    head_offset: float = 0.65) -> torch.Tensor:
    """[B] direction index, overwrite-in-order (0 when nothing matches)."""
    return _index(_faceid_directions(head_offset), elevation, azimuth,
                  center_z, all_vis, camera_distances)


class PromptEmbeddings(NamedTuple):
    """The prompt tables: [13, ...] view-dependent positive and negative
    rows, the null and the plain prompt's row. Text rows are [S, D]; SDXL
    and FLUX add `pooled`, the same four tables of pooled text rows [P]
    (OpenCLIP bigG's 1280 for SDXL, CLIP-L's 768 for FLUX)."""
    text_vd: torch.Tensor  # [13, S, D] view-dependent positive embeddings
    uncond_vd: torch.Tensor  # [13, S, D] negative embeddings
    null: torch.Tensor  # [S, D]
    text: torch.Tensor  # [S, D] plain positive
    pooled: Optional["PromptEmbeddings"] = None

    def get_text_embeddings(self, elevation, azimuth, center_z, all_vis,
                            camera_distances, view_dependent: bool = True,
                            head_offset: float = 0.65) -> torch.Tensor:
        """-> [3B, ...] stacked (pos, neg, null) rows ([3B, S, D] text;
        [3B, P] of `pooled`)."""
        b = elevation.shape[0]
        if view_dependent:
            idx = direction_index(elevation, azimuth, center_z, all_vis,
                                  camera_distances, head_offset)
            pos = self.text_vd[idx]
            neg = self.uncond_vd[idx]
        else:
            pos = self.text[None].expand(b, *self.text.shape)
            neg = self.uncond_vd[0][None].expand(b, *self.text.shape)
        null = self.null[None].expand(b, *self.null.shape)
        return torch.cat([pos, neg, null], dim=0)


def _hash(model_name: str, prompt: str) -> str:
    return hashlib.md5(f"[{model_name}] {prompt}".encode()).hexdigest()


def make_prompt_embeddings(
    encode_fn: Callable[[List[str]], np.ndarray],
    prompt: str,
    negative_prompt: str,
    null_prompt: str = "",
    head_offset: float = 0.65,
    cache_dir: Optional[str] = None,
    model_name: str = "",
    device="cuda",
) -> PromptEmbeddings:
    """encode_fn: list of prompts -> [N, S, D] float array. Disk-cached per
    prompt (md5 of model name and prompt, one .npy each) when cache_dir is
    given."""
    dirs = _faceid_directions(head_offset)
    prompts_vd = [tmpl(prompt) for _, tmpl, _ in dirs]
    all_prompts = prompts_vd + [negative_prompt] * len(dirs) + [null_prompt,
                                                                 prompt]
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        path = lambda p: os.path.join(cache_dir, _hash(model_name, p) + ".npy")
        missing = sorted({p for p in all_prompts
                          if not os.path.exists(path(p))})
        if missing:
            for p, e in zip(missing, np.asarray(encode_fn(missing))):
                np.save(path(p), e)
        out = np.stack([np.load(path(p)) for p in all_prompts])
    else:
        out = np.asarray(encode_fn(all_prompts))
    nd = len(dirs)
    t = torch.as_tensor(np.asarray(out, np.float32), device=device)
    return PromptEmbeddings(text_vd=t[:nd], uncond_vd=t[nd:2 * nd],
                            null=t[2 * nd], text=t[2 * nd + 1])


def fake_text_encoder(seq_len: int = 77, dim: int = 768):
    """Deterministic per-prompt pseudo-embeddings N(0, 0.02) seeded by the
    prompt's md5, for tests and weight-free runs."""

    def encode(prompts: List[str]) -> np.ndarray:
        out = []
        for p in prompts:
            seed = int(hashlib.md5(p.encode()).hexdigest()[:8], 16)
            r = np.random.default_rng(seed)
            out.append(r.normal(0, 0.02, (seq_len, dim)).astype(np.float32))
        return np.stack(out)

    return encode


def _classic_directions(head_offset: float):
    """The classic 4-direction table of the non-FaceID path."""
    return [
        ("side", lambda s: f"side view of {s}",
         lambda e, a, c, v, d: ((a > -45) & (a < 60)) | (a < -135)
         | (a > 120)),
        ("front", lambda s: f"front view of {s}",
         lambda e, a, c, v, d: (a > 60) & (a < 120)),
        ("back", lambda s: f"backside view of {s}",
         lambda e, a, c, v, d: (a > -135) & (a < -45)),
        ("overhead", lambda s: f"overhead view of {s}",
         lambda e, a, c, v, d: (c == head_offset) & (a > 0)),
    ]


def classic_direction_index(elevation, azimuth, center_z, camera_distances,
                            head_offset: float = 0.65) -> torch.Tensor:
    return _index(_classic_directions(head_offset), elevation, azimuth,
                  center_z, None, camera_distances)


def preprocess_prompt(prompt: str,
                      library_path: str = "load/prompt_library.json",
                      section: str = "dreamfusion") -> str:
    """'lib:kw1_kw2' prompt-library lookup: every keyword must appear in
    exactly one prompt of the section."""
    if not prompt.startswith("lib:"):
        return prompt
    with open(library_path) as f:
        library = json.load(f)
    keywords = prompt[4:].lower().split("_")
    candidate = None
    for p in library[section]:
        if all(k in p.lower() for k in keywords):
            if candidate is not None:
                raise ValueError(
                    f"multiple prompts match keywords {keywords} in library")
            candidate = p
    if candidate is None:
        raise ValueError(f"no prompt with keywords {keywords} in library")
    return candidate
