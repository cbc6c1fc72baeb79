"""Exact k-nearest-neighbour distances by blocked brute force (port of
gaussianip_tpu/ops/knn.py): the self search is the distCUDA2 equivalent
used for the initial splat scales; the cross-set search binds gaussians to
the SMPL-X template's vertices (human/lbs_deform.py). Squared distances
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


def knn_dist2(queries: torch.Tensor, points: torch.Tensor, k: int = 3,
              block: int = 4096):
    """Squared distances from each query to its k nearest `points`:
    ([Nq, k] ascending, clamped at 0; [Nq, k] indices).

    The indices are searched without autograd, in blocks of `block` rows
    on both axes (the JAX package scans point blocks with all queries at
    once, [Nq, block] temporaries): each point block's k nearest, then the
    k nearest of those candidates. The k selected distances are then
    computed again in the same expansion form, so that gradients flow to
    the queries and the points."""
    q = queries.to(torch.float32)
    p = points.to(torch.float32)
    q2 = (q * q).sum(dim=1)
    p2 = (p * p).sum(dim=1)
    with torch.no_grad():
        idx = []
        for s in range(0, q.shape[0], block):
            cand_d, cand_i = [], []
            for t in range(0, p.shape[0], block):
                d2 = (q2[s:s + block, None] + p2[None, t:t + block]
                      - 2.0 * (q[s:s + block] @ p[t:t + block].T))
                d, i = torch.topk(d2, min(k, d2.shape[1]), dim=1,
                                  largest=False)
                cand_d.append(d)
                cand_i.append(i + t)
            _, j = torch.topk(torch.cat(cand_d, 1), min(k, p.shape[0]),
                              dim=1, largest=False, sorted=True)
            idx.append(torch.gather(torch.cat(cand_i, 1), 1, j))
        idx = torch.cat(idx)
    d2 = q2[:, None] + p2[idx] - 2.0 * torch.einsum("qc,qkc->qk", q, p[idx])
    return torch.clamp(d2, min=0.0), idx
