"""Frozen copy of gaussianip_tpu_torch/ops/knn.py, plain PyTorch.

Exact k-nearest-neighbour distances by blocked brute force (port of
gaussianip_tpu/ops/knn.py): the self search is the distCUDA2 equivalent
used for the initial splat scales. Squared distances
use the |x|^2 + |y|^2 - 2 x.y expansion as the JAX package does; memory
stays O(block * N)."""

from __future__ import annotations

import torch


def knn_self_dist2(points: torch.Tensor, k: int = 3, block: int = 4096):
    """k-NN of a point set to itself, excluding each point's own index.
    Returns ([N, k] ascending squared distances, [N, k] indices)."""
    p = points.to(torch.float32)
    n = p.shape[0]
    p2 = (p * p).sum(dim=1)
    best_d, best_i = [], []
    for s in range(0, n, block):
        q = p[s:s + block]
        rows = torch.arange(q.shape[0], device=p.device)
        d2 = p2[s:s + block, None] + p2[None, :] - 2.0 * (q @ p.T)
        d2[rows, s + rows] = float("inf")
        d, i = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        best_d.append(d)
        best_i.append(i)
    # clamp expansion negatives
    return torch.clamp(torch.cat(best_d), min=0.0), torch.cat(best_i)


def mean_dist2_3nn(points: torch.Tensor, block: int = 4096) -> torch.Tensor:
    """Mean squared distance to the 3 nearest neighbours (self excluded), [N]."""
    d2, _ = knn_self_dist2(points, k=3, block=block)
    return d2.mean(dim=1)
