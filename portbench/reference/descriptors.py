"""Descriptor images and best matches, plainly: the network in eval mode on
frames normalised with the ImageNet mean and deviation, and each query's
nearest pixel by Euclidean distance in float64."""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np
import torch

from portbench.reference.train_step import normalize


def descriptor_images(model, frames_u8: torch.Tensor, batch: int = 4) -> torch.Tensor:
    """``[n, H, W, 3]`` uint8 frames -> ``[n, H, W, D]`` float32
    descriptors, ``batch`` frames a forward."""
    out = []
    with torch.no_grad():
        for i in range(0, frames_u8.shape[0], batch):
            x = normalize(frames_u8[i:i + batch]).permute(0, 3, 1, 2).contiguous()
            out.append(model(x).permute(0, 2, 3, 1))
    return torch.cat(out)


def best_matches(desc: torch.Tensor, queries: torch.Tensor):
    """Each query's nearest pixel of ``desc [H, W, D]`` by float32 Euclidean
    distance (the first on a tie): ``(uv [Q, 2] int, dist [Q])``."""
    H, W, D = desc.shape
    d = torch.sqrt(((desc.reshape(1, H * W, D) - queries[:, None, :]) ** 2).sum(-1))
    dist, idx = d.min(dim=-1)
    return torch.stack([idx % W, idx // W], dim=-1), dist


def check_answers(ref: torch.Tensor, matches, served, chunk: int = 64) -> dict:
    """The compared numbers of served answers against the reference's
    descriptors ``ref [n, H, W, D]``.

    :param matches: ``[(frame, queries [Q, D], uv [Q, 2], dist [Q])]``, the
        best-match answers
    :param served: ``[(frame, descriptors [H, W, D])]``, descriptor answers
    :return: ``match_gap`` (how far the served pixel's reference distance
        lies above the reference's best), ``dist_err`` (the served distance
        against the reference's at the served pixel), both over the frame's
        descriptor RMS, and ``desc_err`` (the largest error of a served
        descriptor over the frame's largest magnitude); each the worst
        case, and only where there are such answers
    """
    n, H, W, D = ref.shape
    flat = ref.reshape(n, H * W, D).double()
    rms = flat.pow(2).mean(dim=(1, 2)).sqrt()
    out = {}
    if matches:
        by_frame = defaultdict(list)
        for frame, q, uv, dist in matches:
            by_frame[frame].append((q, uv, dist))
        gap = err = 0.0
        for frame, answers in by_frame.items():
            for i in range(0, len(answers), chunk):
                part = answers[i:i + chunk]
                q, uv, dist = (torch.as_tensor(np.stack([a[i] for a in part]), device=ref.device)
                               for i in range(3))
                q, uv, dist = q.double(), uv.long(), dist.double()
                d = torch.cdist(q.reshape(-1, D), flat[frame])              # [R*Q, HW]
                best = d.min(dim=-1).values.reshape(q.shape[:2])
                at = d.gather(1, (uv[..., 1] * W + uv[..., 0]).reshape(-1, 1)).reshape(q.shape[:2])
                gap = max(gap, float(((at - best) / rms[frame]).max()))
                err = max(err, float(((dist - at).abs() / rms[frame]).max()))
        out["match_gap"], out["dist_err"] = gap, err
    if served:
        worst = 0.0
        for frame, desc in served:
            r = ref[frame].double()
            d = torch.as_tensor(desc, device=ref.device).double()
            worst = max(worst, float((d - r).abs().max() / r.abs().max()))
        out["desc_err"] = worst
    if not math.isfinite(sum(out.values())):
        out = {k: math.inf for k in out}
    return out
