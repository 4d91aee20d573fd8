"""A train step of Dense Object Nets with the pooled (matrix) loss, written
plainly from the method's description: within-scene pairs, their
correspondences, augmentation, the forward, the pooled pixelwise
contrastive loss and Adam with a staircase learning rate.

The step draws its randomness from a ``torch.Generator`` in a fixed order,
so that the same generator seed gives the same pairs, pixels and coins as
the program's device-sampled step takes from its own generator. The order,
per step (``B`` pairs, ``N`` match attempts, ``P`` pool entries, ``S``
blind samples; float64 unless said):

  1. pairs: nine ``[B]`` uniforms (keys 0-7 and 9 of a row), then three
     ``[B, 16]`` (candidate keys 3, 8 and 10); the scene from key 1, frame
     a from key 2, frame b the first of key 3's 16 candidates whose pose
     differs from a's by more than 0.2 m or 20 degrees (else the pair is
     empty);
  2. match attempts: ``[B, N]`` over frame a's object pixels;
  3. background randomisation of image a, then of image b: a float32 coin
     ``[B]``, then kind ``[B]``, colours ``[B, 3]`` twice, orientation
     ``[B]``, noise coin ``[B]`` and two noise images ``[B, H, W, 3]``;
  4. 180-degree flips: a float32 coin ``[B]`` for a, then for b;
  5. non-match pools of image b: ``[B, P]`` on the object, ``[B, P]`` off it;
  6. blind non-matches: four ``[B, S]`` draws.

Pixels drawn "over the object" index the frame's pixels listed object
first, each part in raster order. Everything else is computed here from
the frames, poses and intrinsics.
"""

from __future__ import annotations

import math

import torch

NUM_POSE_CANDIDATES = 16
POSE_DIST_M, POSE_ANGLE_DEG = 0.2, 20.0
OCCLUSION_MARGIN_M = 0.003
IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)
BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8


def object_first_order(mask: torch.Tensor):
    """Each frame's flat pixel indices, object pixels first and each part
    in raster order, and its object pixel count: ``([F, HW], [F])``."""
    flat = mask.reshape(mask.shape[0], -1) != 0
    order = torch.argsort((~flat).to(torch.uint8), dim=-1, stable=True)
    return order, flat.sum(dim=-1)


def below(u: torch.Tensor, n) -> torch.Tensor:
    """Integers uniform in ``[0, n)`` from uniforms ``u``: ``floor(u * n)``,
    at most ``n - 1`` (``n`` at least 1)."""
    if isinstance(n, int):
        n = max(n, 1)
        return torch.clamp(torch.floor(u * float(n)).to(torch.int64), max=n - 1)
    n = torch.clamp(n.to(torch.int64), min=1)
    return torch.minimum(torch.floor(u * n.to(torch.float64)).to(torch.int64), n - 1)


def draw_from(order, lo, hi, u):
    """``order[..., lo + floor(u * (hi - lo))]``: entries uniform over the
    range ``[lo, hi)`` of each row; and whether the range is non-empty."""
    n = torch.clamp(hi - lo, min=1)
    r = lo[..., None] + torch.minimum(torch.floor(u * n[..., None].to(torch.float64))
                                      .to(torch.int64), n[..., None] - 1)
    return torch.gather(order.to(torch.int64), -1, r), hi > lo


class Frames:
    """The scenes' frames on the device, and the tables sampling reads."""

    def __init__(self, scenes):
        dev = scenes.rgb.device
        self.rgb, self.mask = scenes.rgb, scenes.mask
        self.depth_m = scenes.depth.to(torch.float32) / 1000.0
        self.poses = scenes.poses.to(torch.float32)
        self.K = scenes.K.to(torch.float32)
        self.order, self.count = object_first_order(scenes.mask)
        self.offsets = torch.as_tensor(scenes.offsets, dtype=torch.int64, device=dev)
        self.lengths = torch.as_tensor(scenes.lengths, dtype=torch.int64, device=dev)


def pose_differs(pa, pc):
    """``[B, K]``: candidate poses ``pc [B, K, 4, 4]`` farther than 0.2 m
    or 20 degrees from ``pa [B, 4, 4]``."""
    dist = torch.linalg.vector_norm(pc[..., :3, 3] - pa[..., None, :3, 3], dim=-1)
    trace = torch.einsum("...ij,...kij->...k", pa[..., :3, :3], pc[..., :3, :3])
    angle = torch.rad2deg(torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)))
    return (dist > POSE_DIST_M) | (angle > POSE_ANGLE_DEG)


def sample_pairs(fr: Frames, g: torch.Generator, B: int):
    """Step 1 of the module docstring: ``(frame_a, frame_b, match_type)``
    ``[B]``, the type 0 (within scene) or -1 (empty)."""
    def uniform(*shape):
        return torch.rand((B,) + shape, generator=g, device=g.device, dtype=torch.float64)

    u = {k: uniform() for k in (0, 1, 2, 3, 4, 5, 6, 7, 9)}
    uc = {k: uniform(NUM_POSE_CANDIDATES) for k in (3, 8, 10)}
    scene = below(u[1], fr.offsets.shape[0])
    off, length = fr.offsets[scene], fr.lengths[scene]
    fa = off + below(u[2], length)
    cand = off[:, None] + below(uc[3], length[:, None])
    ok = pose_differs(fr.poses[fa], fr.poses[cand])
    first = torch.argmax(ok.to(torch.uint8), dim=-1)
    found = ok.any(dim=-1)
    fb = torch.where(found, cand.gather(1, first[:, None])[:, 0], fa)
    return fa, fb, torch.where(found, 0, -1)


def reproject(uv_a, depth_a, pose_a, depth_b, pose_b, K):
    """Pixels ``uv_a [B, N, 2]`` of image a in image b: ``(uv_b float32,
    valid)``, valid where depth a is present, the point lands inside image
    b in front of its camera, and image b's depth there is present and no
    nearer than the point less a 3 mm margin."""
    H, W = depth_a.shape[-2:]
    B = uv_a.shape[0]
    z_a = torch.gather(depth_a.reshape(B, -1), -1, uv_a[..., 1] * W + uv_a[..., 0])
    uv1 = torch.cat([uv_a.to(torch.float32), torch.ones_like(uv_a[..., :1], dtype=torch.float32)],
                    dim=-1)
    cam_a = (uv1 @ torch.linalg.inv_ex(K)[0].transpose(-1, -2)) * z_a[..., None]
    world = cam_a @ pose_a[:, :3, :3].transpose(-1, -2) + pose_a[:, None, :3, 3]
    R_t = pose_b[:, :3, :3].transpose(-1, -2)
    to_b = torch.zeros_like(pose_b)
    to_b[:, :3, :3] = R_t
    to_b[:, :3, 3] = -(R_t @ pose_b[:, :3, 3][..., None])[..., 0]
    cam_b = world @ to_b[:, :3, :3].transpose(-1, -2) + to_b[:, None, :3, 3]
    proj = cam_b @ K.transpose(-1, -2)
    denom = proj[..., 2:3]
    denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    uv_b, z_b = proj[..., :2] / denom, cam_b[..., 2]
    valid = (z_a > 0.0) & (uv_b[..., 0] >= 0.0) & (uv_b[..., 0] <= W - 1e-3) \
        & (uv_b[..., 1] >= 0.0) & (uv_b[..., 1] <= H - 1e-3) & (z_b > 0.0)
    ub = torch.clamp(uv_b[..., 0].to(torch.int64), 0, W - 1)
    vb = torch.clamp(uv_b[..., 1].to(torch.int64), 0, H - 1)
    z_seen = torch.gather(depth_b.reshape(B, -1), -1, vb * W + ub)
    return uv_b, valid & (z_seen > 0.0) & (z_seen >= z_b - OCCLUSION_MARGIN_M)


def randomize_background(rgb, mask, g):
    """Step 3 for one image of each pair: with probability 0.5 the
    background becomes a solid colour or a horizontal or vertical gradient
    between two colours, half of the time plus and minus uint8 noise in [0,
    50) that wraps around."""
    B, H, W, _ = rgb.shape
    dev = rgb.device

    def uniform(*shape):
        return torch.rand(shape, generator=g, device=g.device, dtype=torch.float32)

    apply = uniform(B) < 0.5
    kind = uniform(B)
    c1 = torch.floor(uniform(B, 3) * 255.0).to(torch.uint8)
    c2 = torch.floor(uniform(B, 3) * 255.0).to(torch.uint8)
    vertical = uniform(B) > 0.5
    noisy = uniform(B) >= 0.5
    n1 = torch.floor(uniform(B, H, W, 3) * 50.0).to(torch.uint8)
    n2 = torch.floor(uniform(B, H, W, 3) * 50.0).to(torch.uint8)
    solid = torch.ones_like(rgb) * c1[:, None, None, :]
    pv = (torch.arange(H, dtype=torch.float32, device=dev) / max(H - 1, 1))[:, None, None]
    ph = (torch.arange(W, dtype=torch.float32, device=dev) / max(W - 1, 1))[None, :, None]
    p = torch.where(vertical[:, None, None, None], pv.expand(H, W, 1), ph.expand(H, W, 1))
    grad = (c2.to(torch.float32)[:, None, None, :] * p
            + c1.to(torch.float32)[:, None, None, :] * (1.0 - p)).to(torch.uint8)
    background = torch.where((kind < 0.5)[:, None, None, None], solid, grad)
    background = torch.where(noisy[:, None, None, None], background + n1 - n2, background)
    out = torch.where((mask != 0)[..., None], rgb, background)
    return torch.where(apply[:, None, None, None], out, rgb)


def normalize(rgb):
    mean = torch.tensor(IMAGE_MEAN, dtype=torch.float32, device=rgb.device)
    std = torch.tensor(IMAGE_STD, dtype=torch.float32, device=rgb.device)
    return (rgb.to(torch.float32) / 255.0 - mean) / std


def make_batch(fr: Frames, g: torch.Generator, B: int, t: dict):
    """Steps 1-6: normalised images ``[B, H, W, 3]`` a and b and the index
    sets of the loss."""
    H, W = fr.mask.shape[-2:]
    HW = H * W
    dev = fr.rgb.device
    fa, fb, match_type = sample_pairs(fr, g, B)

    def uniform(*shape):
        return torch.rand((B,) + shape, generator=g, device=g.device, dtype=torch.float64)

    zero = torch.zeros((B,), dtype=torch.int64, device=dev)
    count_a, count_b = fr.count[fa].to(torch.int64), fr.count[fb].to(torch.int64)
    order_a, order_b = fr.order[fa], fr.order[fb]
    flat_a, has_object = draw_from(order_a, zero, count_a, uniform(t["num_matching_attempts"]))
    uv_a = torch.stack([flat_a % W, flat_a // W], dim=-1)
    uv_b, valid = reproject(uv_a, fr.depth_m[fa], fr.poses[fa], fr.depth_m[fb], fr.poses[fb],
                            fr.K.expand(B, 3, 3).contiguous())
    valid = valid & has_object[:, None] & (match_type >= 0)[:, None]

    rgb_a, rgb_b = fr.rgb[fa], fr.rgb[fb]
    if t["domain_randomize"]:
        rgb_a = randomize_background(rgb_a, fr.mask[fa], g)
        rgb_b = randomize_background(rgb_b, fr.mask[fb], g)
    flip_a = flip_b = torch.zeros((B,), dtype=torch.bool, device=dev)
    if t["flip_augmentation"]:
        flip_a = torch.rand((B,), generator=g, device=g.device, dtype=torch.float32) < 0.5
        rgb_a = torch.where(flip_a[:, None, None, None], torch.flip(rgb_a, dims=(1, 2)), rgb_a)
        uv_a = torch.where(flip_a[:, None, None],
                           torch.stack([(W - 1) - uv_a[..., 0], (H - 1) - uv_a[..., 1]], -1), uv_a)
        flip_b = torch.rand((B,), generator=g, device=g.device, dtype=torch.float32) < 0.5
        rgb_b = torch.where(flip_b[:, None, None, None], torch.flip(rgb_b, dims=(1, 2)), rgb_b)
        uv_b = torch.where(flip_b[:, None, None],
                           torch.stack([(W - 1) - uv_b[..., 0], (H - 1) - uv_b[..., 1]], -1), uv_b)

    def pool(lo, hi, size):
        raw, ok = draw_from(order_b, lo, hi, uniform(size))
        return torch.where(flip_b[:, None], HW - 1 - raw, raw), ok[:, None].expand(B, size)

    masked_pool, masked_ok = pool(zero, count_b, t["masked_pool_size"])
    background_pool, background_ok = pool(count_b, torch.full_like(count_b, HW),
                                          t["background_pool_size"])
    # the blind non-matches enter no term of a within-scene pair's loss;
    # their draws are made all the same
    for _ in range(4):
        uniform(t["num_blind_samples"])
    return normalize(rgb_a), normalize(rgb_b), {
        "matches_a": uv_a[..., 1].to(torch.int64) * W + uv_a[..., 0].to(torch.int64),
        "matches_b": uv_b[..., 1].to(torch.int64) * W + uv_b[..., 0].to(torch.int64),
        "uv_b": uv_b.to(torch.float32), "valid": valid,
        "pools": ((masked_pool, masked_ok, "M_masked"),
                  (background_pool, background_ok, "M_background")),
        "match_type": match_type}


def rows(pred, index, valid):
    """``pred [B, HW, D]`` at ``index [B, N]``; pixel 0 where not valid."""
    B, HW, D = pred.shape
    idx = torch.where(valid, index, torch.zeros_like(index))
    return pred.reshape(B * HW, D)[idx + torch.arange(B, device=idx.device)[:, None] * HW]


def pooled_hinge(da, db, uv_b, valid, pool, pool_ok, W: int, M: float):
    """Summed ``max(M - |da_i - db_j|, 0)^2`` over every valid match row i
    and valid pool entry j whose pixel lies at least 1 px from row i's true
    match in both u and v, and the count of those terms above 0."""
    diff = [da[:, :, None, d] - db[:, None, :, d] for d in range(da.shape[-1])]
    d2 = sum(x * x for x in diff)
    hinge = torch.clamp(M - torch.sqrt(torch.clamp(d2, min=1e-24)), min=0.0)
    du = (uv_b[..., 0][:, :, None] - (pool % W).to(torch.float32)[:, None, :]).abs()
    dv = (uv_b[..., 1][:, :, None] - (pool // W).to(torch.float32)[:, None, :]).abs()
    w = (valid.to(torch.float32)[:, :, None] * pool_ok.to(torch.float32)[:, None, :]) \
        * ((du >= 1.0) & (dv >= 1.0)).to(torch.float32)
    return (w * hinge * hinge).sum(dim=(1, 2)), ((w != 0) & (hinge > 0)).sum(dim=(1, 2))


def loss_of(model, img_a, img_b, s: dict, loss_cfg: dict, batch_fraction: float = 1.0):
    """The batch's loss: one forward of the ``2B`` images in train mode, per
    pair the mean squared distance of its matches plus its pooled hinges
    over the count of hard negatives, averaged over the non-empty pairs.
    ``batch_fraction`` below 1 averages over that leading share of the
    pairs alone (a fault the benchmark must catch)."""
    B, H, W, _ = img_a.shape
    model.train()
    out = model(torch.cat([img_a, img_b]).permute(0, 3, 1, 2).contiguous())
    pred = out.permute(0, 2, 3, 1).reshape(2 * B, H * W, out.shape[1])
    pa, pb = pred[:B], pred[B:]
    valid = s["valid"]
    da, db = rows(pa, s["matches_a"], valid), rows(pb, s["matches_b"], valid)
    sq = ((da - db) ** 2).sum(dim=-1)
    match = torch.where(valid, sq, torch.zeros_like(sq)).sum(-1) / torch.clamp(valid.sum(-1), min=1)
    hinge_sum, hard = 0.0, 0
    for pool, ok, margin in s["pools"]:
        loss, n = pooled_hinge(da, rows(pb, pool, ok), s["uv_b"], valid, pool, ok, W,
                               float(loss_cfg[margin]))
        hinge_sum, hard = hinge_sum + loss, hard + n
    per_pair = float(loss_cfg["match_loss_weight"]) * match \
        + float(loss_cfg["non_match_loss_weight"]) * hinge_sum / torch.clamp(hard, min=1)
    non_empty = (s["match_type"] >= 0).to(torch.float32)
    if batch_fraction < 1.0:
        non_empty[max(1, int(B * batch_fraction)):] = 0.0
    per_pair = torch.where(s["match_type"] >= 0, per_pair, torch.zeros_like(per_pair))
    return (per_pair * non_empty).sum() / torch.clamp(non_empty.sum(), min=1.0)


class ReferenceTraining:
    """``step() -> loss``: one train step of ``model`` (a
    :class:`~portbench.reference.resnet.ResNetFCN`) on pairs of ``scenes``
    drawn from ``generator``, with Adam (betas 0.9/0.999, eps 1e-8, weight
    decay added to the gradient) at ``learning_rate * decay ** floor(step
    / steps_between_decay)``. After a step, :attr:`first_gradients` holds
    the first step's gradients as Adam took them (decay included)."""

    def __init__(self, model, scenes, config: dict, batch_size: int, generator: torch.Generator,
                 batch_fraction: float = 1.0):
        self.model, self.g, self.B = model, generator, batch_size
        self.t, self.loss_cfg = config["training"], config["loss_function"]
        self.frames = Frames(scenes)
        self.batch_fraction = batch_fraction
        self.params = dict(model.named_parameters())
        self.m = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.count = 0
        self.first_gradients = None

    def lr(self) -> float:
        t = self.t
        return float(t["learning_rate"]) * float(t["learning_rate_decay"]) ** (
            self.count // int(t["steps_between_learning_rate_decay"]))

    def step(self) -> float:
        img_a, img_b, s = make_batch(self.frames, self.g, self.B, self.t)
        for p in self.params.values():
            p.grad = None
        loss = loss_of(self.model, img_a, img_b, s, self.loss_cfg, self.batch_fraction)
        loss.backward()
        lr, wd = self.lr(), float(self.t["weight_decay"])
        self.count += 1
        c1, c2 = 1.0 - BETA1 ** self.count, 1.0 - BETA2 ** self.count
        grads = {}
        with torch.no_grad():
            for k, p in self.params.items():
                g = p.grad + wd * p
                grads[k] = g
                self.m[k].mul_(BETA1).add_((1.0 - BETA1) * g)
                self.v[k].mul_(BETA2).add_((1.0 - BETA2) * g * g)
                p.sub_(lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + ADAM_EPS))
        if self.first_gradients is None:
            self.first_gradients = grads
        return float(loss.detach())


def leaf_gaps(program: dict, reference: dict, keep=None) -> dict:
    """Each leaf's gap between the program's and the reference's norms:
    ``| |program_k| - |reference_k| | / max(|reference_k|, median_k
    |reference_k|)`` over the leaves ``keep`` (all by default)."""
    keys = [k for k in reference if keep is None or k in keep]
    ref = {k: float(torch.linalg.vector_norm(reference[k].double())) for k in keys}
    median = sorted(ref.values())[len(ref) // 2]
    return {k: abs(float(torch.linalg.vector_norm(program[k].double())) - ref[k])
            / max(ref[k], median) for k in keys}


def leaf_gap(program: dict, reference: dict, keep=None) -> float:
    """The worst leaf's gap (:func:`leaf_gaps`)."""
    gaps = leaf_gaps(program, reference, keep)
    return max(gaps.values()) if gaps else math.nan
