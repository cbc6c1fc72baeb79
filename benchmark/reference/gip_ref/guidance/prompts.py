"""Frozen copy of gaussianip_tpu_torch/guidance/prompts.py, plain PyTorch.

View-dependent prompt processing (port of
gaussianip_tpu/guidance/prompts.py): the FaceID 13-direction table with its
overwrite-in-order index and the (pos, neg, null) stacked text
embeddings."""

from __future__ import annotations

from typing import NamedTuple

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
    text_vd: torch.Tensor  # [13, S, D] view-dependent positive embeddings
    uncond_vd: torch.Tensor  # [13, S, D] negative embeddings
    null: torch.Tensor  # [S, D]
    text: torch.Tensor  # [S, D] plain positive

    def get_text_embeddings(self, elevation, azimuth, center_z, all_vis,
                            camera_distances, view_dependent: bool = True,
                            head_offset: float = 0.65) -> torch.Tensor:
        """-> [3B, S, D] stacked (pos, neg, null)."""
        b = elevation.shape[0]
        if view_dependent:
            idx = direction_index(elevation, azimuth, center_z, all_vis,
                                  camera_distances, head_offset)
            pos = self.text_vd[idx]
            neg = self.uncond_vd[idx]
        else:
            pos = self.text[None].expand(b, -1, -1)
            neg = self.uncond_vd[0][None].expand(b, -1, -1)
        null = self.null[None].expand(b, -1, -1)
        return torch.cat([pos, neg, null], dim=0)
