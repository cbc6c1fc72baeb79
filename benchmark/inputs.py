"""Inputs made from `--seed`, on the device, and handed alike to the
program and to the plain reference: the avatar's point cloud and OpenPose
keypoints, the diffusion stack's weights and the conditioning embeddings.

Every draw comes from a torch.Generator on the run's device seeded by
`sub_seed(seed, what)`, so the same seed gives the same inputs and each
input has a stream of its own."""

from __future__ import annotations

import hashlib
import math

import torch

# A standing figure on the OpenPose-18 layout (nose, neck, right shoulder,
# elbow, wrist, left shoulder, elbow, wrist, right hip, knee, ankle, left
# hip, knee, ankle, right eye, left eye, right ear, left ear), z up, 1.56
# tall and centred at the origin as the port's Skeleton leaves a body
# (0.6 extent, then scale(-10): x 1.1 ** 10).
KEYPOINTS = (
    (0.0, -0.08, 0.62), (0.0, 0.0, 0.48),
    (-0.17, 0.0, 0.45), (-0.30, 0.0, 0.22), (-0.40, 0.0, 0.02),
    (0.17, 0.0, 0.45), (0.30, 0.0, 0.22), (0.40, 0.0, 0.02),
    (-0.09, 0.0, 0.0), (-0.10, 0.0, -0.38), (-0.10, 0.0, -0.74),
    (0.09, 0.0, 0.0), (0.10, 0.0, -0.38), (0.10, 0.0, -0.74),
    (-0.03, -0.07, 0.66), (0.03, -0.07, 0.66),
    (-0.07, 0.0, 0.64), (0.07, 0.0, 0.64),
)
# the body's capsules: (keypoint a, keypoint b, radius); the torso runs
# from the neck to the hips' midpoint, the head is a sphere on the nose
LIMBS = ((2, 3, 0.045), (3, 4, 0.04), (5, 6, 0.045), (6, 7, 0.04),
         (8, 9, 0.07), (9, 10, 0.055), (11, 12, 0.07), (12, 13, 0.055),
         (2, 5, 0.06))
TORSO_RADIUS = 0.14
HEAD_RADIUS = 0.1


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed for the input `what` of run seed `seed`."""
    h = hashlib.sha256(f"{int(seed)}:{what}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, what: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, what))


def keypoints(device) -> torch.Tensor:
    return torch.tensor(KEYPOINTS, dtype=torch.float32, device=device)


def avatar_points(n: int, seed: int, device):
    """(points [n, 3], colours [n, 3]) on the capsule body: each point on
    a limb's, the torso's or the head's surface, chosen by surface area,
    with uniform colours."""
    gen = generator(seed, "avatar", device)
    kp = keypoints(device)
    hips = 0.5 * (kp[8] + kp[11])
    a = torch.stack([kp[i] for i, _, _ in LIMBS] + [kp[1]])
    b = torch.stack([kp[j] for _, j, _ in LIMBS] + [hips])
    r = torch.tensor([w for _, _, w in LIMBS] + [TORSO_RADIUS],
                     device=device)
    length = torch.linalg.vector_norm(b - a, dim=-1)
    area = torch.cat([2 * math.pi * r * length,
                      torch.tensor([4 * math.pi * HEAD_RADIUS ** 2],
                                   device=device)])
    u = torch.rand((n, 4), generator=gen, device=device)
    part = torch.multinomial(area / area.sum(), n, replacement=True,
                             generator=gen)
    # a point on each capsule's side: along the axis, then around it
    seg = part.clamp(max=len(LIMBS))
    axis = (b - a) / length[:, None]
    ref = torch.where(axis[:, 2:3].abs() > 0.9,
                      torch.tensor([1.0, 0, 0], device=device),
                      torch.tensor([0, 0, 1.0], device=device))
    e1 = torch.linalg.cross(axis, ref)
    e1 = e1 / torch.linalg.vector_norm(e1, dim=-1, keepdim=True)
    e2 = torch.linalg.cross(axis, e1)
    th = 2 * math.pi * u[:, 1:2]
    on_limb = (a[seg] + u[:, :1] * (b - a)[seg]
               + r[seg, None] * (torch.cos(th) * e1[seg]
                                 + torch.sin(th) * e2[seg]))
    # the head: a uniform direction on the sphere
    z = 2 * u[:, 2:3] - 1
    ring = torch.sqrt(1 - z * z)
    on_head = kp[0] + HEAD_RADIUS * torch.cat(
        [ring * torch.cos(th), ring * torch.sin(th), z], -1)
    pts = torch.where((part == len(LIMBS) + 1)[:, None], on_head, on_limb)
    colours = torch.rand((n, 3), generator=gen, device=device)
    return pts.contiguous(), colours


def init_std(name: str, shape, zero_conv_scale: float) -> float:
    """The standard deviation of a kernel's normal draw: lecun normal
    (1 / sqrt(fan-in)), as the port's init_random_ and flax's default; the
    ControlNet's zero-initialised output convs get `zero_conv_scale` of it
    so that its residuals are small but not zero."""
    std = 1.0 / math.sqrt(math.prod(shape[1:]))
    if name.startswith(("zero_conv_", "cond_conv_out.")):
        std *= zero_conv_scale
    return std


def random_weights(module, seed: int, what: str, device,
                   zero_conv_scale: float = 0.0) -> dict:
    """A state dict for `module` (any device; only names and shapes are
    read): every kernel (dim >= 2) a view of one normal draw, scaled by
    `init_std`; norm scales (a 1-D `weight`) one, other 1-D parameters
    zero. float32, on `device`."""
    named = [(n, tuple(p.shape)) for n, p in module.named_parameters()]
    total = sum(math.prod(s) for _, s in named if len(s) >= 2)
    flat = torch.randn(total, generator=generator(seed, what, device),
                       device=device)
    out, off = {}, 0
    for name, shape in named:
        if len(shape) >= 2:
            k = math.prod(shape)
            out[name] = flat[off:off + k].view(shape).mul_(
                init_std(name, shape, zero_conv_scale))
            off += k
        elif name.rsplit(".", 1)[-1] == "weight":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def on_meta(ctor):
    with torch.device("meta"):
        return ctor()


def load(module, state: dict):
    """`module` (built on the meta device) holding `state`'s tensors."""
    module.load_state_dict(state, strict=True, assign=True)
    left = [n for n, t in list(module.named_parameters())
            + list(module.named_buffers()) if t.is_meta]
    if left:
        raise ValueError(f"not loaded: {left[:5]}")
    return module.requires_grad_(False).eval()


def embeddings(seed: int, tokens: int, dim: int, ip_tokens: int,
               directions: int, device) -> dict:
    """The conditioning: text embeddings [directions, tokens, dim] for the
    view-dependent positive and negative prompts, the null prompt's and
    the plain prompt's [tokens, dim], and the identity tokens (pos, null,
    neg) [1, ip_tokens, dim], N(0, 1)."""
    gen = generator(seed, "embeddings", device)
    d = lambda *s: torch.randn(s, generator=gen, device=device)
    return {"text_vd": d(directions, tokens, dim),
            "uncond_vd": d(directions, tokens, dim),
            "null": d(tokens, dim), "text": d(tokens, dim),
            "ip_pos": d(1, ip_tokens, dim), "ip_null": d(1, ip_tokens, dim),
            "ip_neg": d(1, ip_tokens, dim)}


def images(seed: int, what: str, shape, device) -> torch.Tensor:
    """Uniform [0, 1) float32 images of `shape` (the refined targets of
    stage 3, the views and pose maps of stage 2)."""
    return torch.rand(shape, generator=generator(seed, what, device),
                      device=device)
