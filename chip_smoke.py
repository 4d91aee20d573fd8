#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pdc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each fatal on failure:
  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions; TF32 is switched off for matmuls and cuDNN, since every
     number below is compared in fp32;
  2. build: nvcc compiles ``pdc_tpu_torch/csrc/*.cu`` into
     ``build/pdc_tpu_torch_kernels/`` (first use only);
  3. the best-match kernel against its plain PyTorch version and against
     float64 distances, on random shapes (HW % 4 != 0 among them) and on
     real 640x480 descriptor images of the network, B=8 included;
  4. the pooled-hinge forward and backward kernels (K1, K2) against their
     plain version at the training shapes (B=4, Nm=10000, P=1024, D=3),
     with and without the pixel weight: random rows, rows of the network's
     640x480 descriptor images, many collisions, no valid row, a ragged
     B=3, Nm=777, P=1000, D=16 case, rows at scale 0.05, where most pairs
     count, and NaN or infinite descriptors in valid and invalid rows and
     pool entries, which must give NaN where the plain version does;
  5. the main path, serving: a ``DescriptorServer`` with ResNet-34-8s, D=3,
     640x480, seeded random weights, answering concurrent ``descriptors``
     and ``best_match`` requests from several client threads; its answers
     are checked against ``forward_on_img`` and the plain best match, and
     the best-match kernel's launch count must show that serving went
     through it;
  6. the main path, training: ``make_train_step`` with the values of
     ``configs/training.yaml`` (ResNet-34-8s, D=3, 640x480, B=4 within-scene
     pairs of a synthetic scene, seeded random weights) takes a few steps;
     the loss must stay finite, the weights must move, and K1 and K2 must
     launch twice each per step. Then one step with the kernels and one with
     the plain pooled hinge, on the same batch and weights, must agree;
  7. the main path, the training driver: ``DenseCorrespondenceTraining.run``
     on the synthetic dataset of trained_models/tpu_journey/dataset.yaml
     (DATASET_RECORD: 2 scenes, 12 frames, 640x480) with ResNet-34-8s, B=4,
     6 iterations, checkpoints at 0, 3 and 6 and the test loss at 6. It fails
     unless (a) the run took the on-device sampler route; (b) K1 launched 2
     per train step plus 2 per test-loss batch and K2 2 per train step;
     (c) every metric is finite and the weights moved; (d) the folder holds
     the configs, the checkpoints with their .opt files and the log
     histories; (e) 000006.ckpt.opt reads back bit-equal to the live Adam
     state; (f) run_from_pretrained for 2 more iterations starts at 6 and
     ends with every Adam step at 8; (g) from_model_folder gives the live
     network's forward_on_img within 1e-6, and one best-match query on it
     agrees with the plain version; (h) load_training_dataset rebuilds the
     same scenes, frame counts and poses. Then 3 timed iterations on each
     route (device sampler, cached host sampler, host streaming);
  8. the main path from disk, "on-disk training": the DATASET_RECORD scenes
     written in the pdc layout (write_scene, through the PNG codec that
     decoder "auto" chose, which is printed) with a composite config, read
     back bit-equal to the rendering (poses within 1e-9); each codec's ms
     per 640x480 frame to write and to decode; then ``python -m pdc_tpu_torch
     train`` in this process with the values of phase 7. It fails unless
     (a) K1 launched 2 per train step plus 2 per test-loss batch and K2 2 per
     train step; (b) every metric is finite and the weights moved; (c)
     dataset.yaml records the absolute data_dir and config_dir, and
     load_training_dataset("train") rebuilds the same scene names, frame ids
     and poses from disk; (d) from_model_folder gives the live network's
     forward_on_img within 1e-6, and one best-match query on it agrees with
     the plain version; (e) ``python -m pdc_tpu_torch statistics`` on the
     tree is within 1e-6 of float64 numpy over the same frames;
  9. the main path's evaluation, "evaluation": ``python -m pdc_tpu_torch
     evaluate`` in this process on phase 8's model folder, 20 pairs of 100
     matches in each split (``--no_qualitative`` unless matplotlib imports;
     one line says whether pandas, matplotlib and cv2 import). It fails
     unless (a) train/ and test/ data.csv read back (table.read_csv) with
     the 23 columns and rows; (b) K3 launched once per sweep chunk of 16
     pairs (and once per qualitative panel); (c) on 4 test pairs the fused
     route (K3) agrees with the per-pair route run with the plain best
     match: equal picks, or float64 near-ties within TIE_TOL_D2, every
     other value within 1e-5, and the rerun equals the written rows; (d)
     each stats.yaml holds PCK at 5-100 px in [0, 1] and a finite area
     above the curve; (e) descriptor_statistics.yaml is finite with
     min <= mean <= max per channel; (f) across_object/data.csv exists
     (the dataset has 2 objects). Then K3 at the sweep's shape (B=16,
     Q=100, 640x480) against float64 and its plain version;
 10. timings: every kernel's device time (time_device: the queue primed
     with a device-side wait, so the card never waits on the host), the
     wrapper's time per call from an idle queue (time_cuda), the split by
     kernel name (torch.profiler), its bound, its plain version and a
     library yardstick where one exists (device times); forward images/s;
     serving latency; the train step and its split; the driver's step on
     each route against it, and its checkpoint writes; the on-disk run's
     step against the driver's, and the PNG codecs' times; K3 at the
     evaluation sweep's shape, and the sweep's seconds split into forwards,
     correspondences and statistics.

The last lines are a JSON object with every kernel's numbers, the
nvidia-smi line, and ``{"ok": true, "device": {...}}``. Without CUDA, or when the
package is not beside this script, it exits non-zero and prints no result.
A watchdog turns a hang into a traceback and a non-zero exit.
"""

import faulthandler
import json
import os
import subprocess
import sys
import threading
import time

WATCHDOG_S = 480
SEED = 0
H, W, D = 480, 640, 3
N_FRAMES = 8
N_CLIENTS, REQUESTS_PER_CLIENT, SERVE_QUERIES = 4, 4, 16
# kernel checks: a chosen pixel may exceed the true minimum squared distance
# by 1e-5 (near-ties are not errors; bench.py's gate), and a distance may be
# 1e-4 off the float64 one. Kernel and plain version sum the same squared
# differences in the same order and differ only by the FMA's rounding.
TIE_TOL_D2, DIST_TOL, PLAIN_TOL = 1e-5, 1e-4, 1e-4
DESC_TOL = 1e-4  # served descriptors vs forward_on_img (other batch, other cuDNN algorithm)
# The training values of configs/training.yaml, stated inline because the
# card's machine has no yaml (tests/test_torch_port_train.py holds them
# against the file).
TRAINING_CONFIG = {
    "training": {
        "learning_rate": 1.0e-4, "learning_rate_decay": 0.9,
        "steps_between_learning_rate_decay": 250, "weight_decay": 1.0e-4, "batch_size": 4,
        "domain_randomize": True, "num_matching_attempts": 10000,
        "sample_matches_only_off_mask": True, "num_non_matches_per_match": 150,
        "fraction_masked_non_matches": 0.5, "fraction_background_non_matches": 0.5,
        "use_image_b_mask_inv": True, "cross_scene_num_samples": 10000,
        "data_type_probabilities": {"SINGLE_OBJECT_WITHIN_SCENE": 1,
                                    "SINGLE_OBJECT_ACROSS_SCENE": 0, "DIFFERENT_OBJECT": 0,
                                    "MULTI_OBJECT": 0, "SYNTHETIC_MULTI_OBJECT": 0},
        "use_matrix_loss": True, "masked_pool_size": 1024, "background_pool_size": 1024,
        "num_blind_samples": 5000, "cache_dataset_on_device": True, "flip_augmentation": True,
    },
    "dense_correspondence_network": {
        "descriptor_dimension": 3, "image_width": 640, "image_height": 480, "normalize": False,
        "backbone": {"model_class": "Resnet", "resnet_name": "Resnet34_8s"},
    },
    "loss_function": {
        "M_masked": 0.5, "M_background": 0.5, "M_pixel": 50, "match_loss_weight": 1.0,
        "non_match_loss_weight": 1.0, "use_l2_pixel_loss_on_masked_non_matches": False,
        "use_l2_pixel_loss_on_background_non_matches": False, "scale_by_hard_negatives": True,
        "scale_by_hard_negatives_DIFFERENT_OBJECT": True, "alpha_triplet": 0.1,
    },
}
# The synthetic record of trained_models/tpu_journey/dataset.yaml (2 scenes of
# 2 objects, 12 frames each, 640x480), stated inline because the card's copy of
# the tree may lack trained_models/ (tests/test_torch_port_dataset.py holds it
# against the file).
DATASET_RECORD = {"synthetic": {"height": 480, "num_frames": 12, "num_objects": 2,
                                "num_scenes": 2, "num_test_scenes": 0, "object_radius": 0.3,
                                "width": 640}}
# H100 SXM data-sheet peaks: HBM bytes/s and fp32 FLOP/s outside the tensor cores
PEAK_BYTES_S, PEAK_FP32_S = 3.35e12, 67e12


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name, t0):
    log(f"phase {name}: {time.perf_counter() - t0:.2f} s")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_cuda(torch, fn, iters=20, warmup=3):
    """Milliseconds per call, from CUDA events around ``iters`` calls made
    from an idle queue. Where one call's host work (checks, allocations,
    the launch itself) outlasts its device work, the card waits between
    launches and this reads the host: for a kernel it is the wrapper's cost
    per call to its caller, not the kernel's time (see time_device)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# time_device's first device-side wait (about 5 ms at 2 GHz), and how often
# it is lengthened (4x each time) before a reading counts as host-paced
SLEEP_CYCLES, SLEEP_TRIES = 10_000_000, 4


def time_device(torch, fn, iters=20, warmup=3, cycles=SLEEP_CYCLES, tries=SLEEP_TRIES):
    """Milliseconds of device time per call of ``fn``, gaps between its
    launches included. The stream first gets a long device-side wait
    (``torch.cuda._sleep``); the start event, the ``iters`` calls and the end
    event are enqueued behind it, so the card finds every launch queued when
    it reaches the start event. If the start event has already been reached
    when the enqueueing ends, the card may have waited on the host: the
    reading is dropped and the wait lengthened, and after ``tries`` such
    readings this raises. It never returns a host-paced number, and without
    a card it raises before calling ``fn``."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_device reads device time on a CUDA card, and there is none")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        drained = start.query()
        end.record()
        torch.cuda.synchronize()
        if not drained:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise RuntimeError(f"time_device: the queue drained before the enqueueing of {iters} calls "
                       f"ended, {tries} times (last wait {cycles // 4} cycles): host-paced")


def short_kernel_name(key):
    """``hinge_fwd<3>`` from the profiler's ``void (anonymous
    namespace)::hinge_fwd<3>(float const*, ...)``."""
    name = key.replace("(anonymous namespace)::", "").split("(", 1)[0]
    return name.removeprefix("void ")


def profile_split(torch, fn, iters=10):
    """Device time of each kernel that ``fn`` launches, from
    ``torch.profiler`` over ``iters`` calls: ``{short name: (launches per
    call, ms per launch)}``, or None when the profiler recorded no device
    time on this machine."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a window can come back empty; one more try
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us > 0 and e.count:
                out[short_kernel_name(e.key)] = (e.count / iters, 1e-3 * us / e.count)
        if out:
            return out
    return None


def split_text(split):
    if split is None:
        return "profiler: no device time recorded (events only)"
    return "profiler: " + ", ".join(f"{k} {n:g} x {ms:.5f} ms" for k, (n, ms) in split.items())


def bound(B, Q, D_, HW):
    """Least time for one best_match call: inputs read once, outputs written
    once, against 2*Q*HW*D + 2*Q*HW fp32 operations per image."""
    nbytes = 4 * (B * HW * D_ + B * Q * D_) + 8 * B * Q
    ops = B * (2 * Q * HW * D_ + 2 * Q * HW)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_FP32_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_matches(torch, bm, res, queries, idx, dist):
    """Tie-tolerant check of (idx, dist) against float64 distances:
    returns (bad_idx, dist_err)."""
    d2 = bm.squared_distances(res.double(), queries.double())  # [B, Q, HW]
    true_min = d2.min(dim=-1).values
    chosen = torch.gather(d2, -1, idx.long()[..., None])[..., 0]
    bad = int(((chosen - true_min) > TIE_TOL_D2).sum())
    err = float((dist.double() - true_min.sqrt()).abs().max())
    return bad, err


# -- pooled hinge (K1 forward, K2 backward) -----------------------------------

# main-path shapes: B pairs, Nm match rows, P pool rows (configs/training.yaml)
HINGE_B, HINGE_NM, HINGE_P = 4, 10000, 1024
# K1/K2 against their plain version. Every term is bit-identical (the kernels
# round each product and sum on its own, as the plain version's elementwise
# ops do), so the hard-negative count must be equal (a difference of 0) and
# only the order of the final sums differs: loss within rtol 1e-5, gradients
# within 1e-5 of the plain gradient's largest magnitude.
HINGE_LOSS_RTOL, HINGE_HARD_TOL, HINGE_GRAD_TOL = 1e-5, 0, 1e-5
# one train step with the kernels against one with the plain pooled hinge, on
# the same batch and weights: the same forward, so the loss differs only in
# the hinge's summation order (rtol 1e-5); gradients by relative L2 norm over
# all parameters, 1e-4 (hinge sums plus the atomics of index_select's and
# cuDNN's backward); after Adam's first step, which moves each parameter by
# about lr * sign(g), every element within 2 lr and 99.9% of those whose |g|
# exceeds 1e-3 of its tensor's largest within 1e-2 lr
STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_PARAM_SHARE = 1e-5, 1e-4, 0.999
TRAIN_STEPS, TRAIN_TIMED_STEPS = 5, 5
# H100 SXM special-function units: 16 per SM per clock, 132 SMs, 1.98 GHz boost
PEAK_SFU_S = 16 * 132 * 1.98e9


def hinge_inputs(torch, np, rng, dev, B, Nm, P, da=None, db=None, scale=0.3, coord_max=None,
                 valid_frac=0.9, Dd=D):
    """K1/K2 arguments: rows (given, or random at ``scale``), match and pool
    pixels on a 640x480 image (or in [0, coord_max)^2, which makes
    collisions common), validity."""
    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=dev)
    if da is None:
        da = t(rng.standard_normal((B, Nm, Dd)) * scale)
        db = t(rng.standard_normal((B, P, Dd)) * scale)
    um, vm = (coord_max, coord_max) if coord_max else (W, H)
    return [da.contiguous(), db.contiguous(),
            t(rng.integers(0, um, (B, Nm))), t(rng.integers(0, vm, (B, Nm))),
            t(rng.random((B, Nm)) < valid_frac),
            t(rng.integers(0, um, (B, P))), t(rng.integers(0, vm, (B, P))),
            t(rng.random((B, P)) < valid_frac)]


def hinge_bound(args, use_pix, backward):
    """Least time of one K1 (or K2) call on these inputs: bytes (each input
    read once, each output written once) over the memory rate against fp32
    operations over the fp32 rate, counting only the work this run's data
    needs. Every pair of a valid row and a valid pool entry needs its
    distance decided: D subtractions, D multiplies, D - 1 adds and the test
    d2 < T (K1), 1e-24 < d2 < T (K2), where d2 < T is exactly hinge > 0.
    A pair that passes adds the collision test and its weight (5). A pair
    that counts adds the sqrt, the hinge, and then the term, the loss sum
    and the count (K1: 4) or c and c * t into gda and gdb (K2: 3 + 3D);
    with use_pix, 7 more for the pixel weight. K2 scales its B (Nm + P) D
    outputs by g. Returns (ms, "bytes" or "operations", sqrt count), the
    sqrts being the counted pairs'."""
    import torch
    from pdc_tpu_torch.ops.pooled_hinge import _tables
    da, db = args[0], args[1]
    B, Nm, Dd = da.shape
    P = db.shape[1]
    mvalid, pvalid = args[4], args[7]
    with torch.no_grad():
        valid = int(((mvalid != 0).sum(1) * (pvalid != 0).sum(1)).sum())
        _, d2, _, hinge, _, _, counted = _tables(*args, 0.5, use_pix, 50.0)
        near = (mvalid[:, :, None] != 0) & (pvalid[:, None, :] != 0) & (hinge > 0)
        if backward:
            near &= d2 > 1e-24
            counted = counted & (d2 > 1e-24)
        near, counted = int(near.sum()), int(counted.sum())
    pix = 7 if use_pix else 0
    nbytes = 4 * (B * Nm * Dd + B * P * Dd + 3 * B * Nm + 3 * B * P)
    if backward:
        nbytes += 4 * B + 4 * (B * Nm * Dd + B * P * Dd)
        flops = (valid * (3 * Dd + 1) + near * 5 + counted * (2 + 3 + 3 * Dd + pix)
                 + B * (Nm + P) * Dd)
    else:
        nbytes += 12 * B
        flops = valid * 3 * Dd + near * 5 + counted * (2 + 4 + pix)
    sqrts = counted * (2 if use_pix else 1)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), sqrts


def check_pooled_hinge(torch, ph, name, args, use_pix):
    """K1 and K2 against the plain version on one case; fatal on
    disagreement. NaN and infinities must stand where the plain version has
    them (fault F5), the finite values within the bars above. Returns
    (max |loss diff|, max |grad diff|) over the finite values."""
    da = args[0].clone().requires_grad_()
    db = args[1].clone().requires_grad_()
    g = torch.linspace(0.5, 1.5, da.shape[0], device=da.device)
    loss, hard = ph.pooled_hinge(da, db, *args[2:], 0.5, use_pix, 50.0)
    (loss * g).sum().backward()
    torch.cuda.synchronize()
    with torch.no_grad():
        ploss, phard = ph.pooled_hinge_reference(*args, 0.5, use_pix, 50.0)
        pgda, pgdb = ph.pooled_hinge_backward_reference(g, *args, 0.5, use_pix, 50.0)
    loss = loss.detach()
    hard_diff = int((hard - phard).abs().max())
    same_nonfinite, errs, ok_grad = True, [], True
    for got, want in ((loss, ploss), (da.grad, pgda), (db.grad, pgdb)):
        same_nonfinite &= (torch.equal(torch.isnan(got), torch.isnan(want))
                           and torch.equal(torch.isfinite(got), torch.isfinite(want))
                           and torch.equal(got[torch.isinf(want)], want[torch.isinf(want)]))
        f = torch.isfinite(want) & torch.isfinite(got)
        errs.append(float((got[f] - want[f]).abs().max()) if f.any() else 0.0)
    f = torch.isfinite(ploss) & torch.isfinite(loss)
    ok_loss = bool(((loss[f] - ploss[f]).abs() <= HINGE_LOSS_RTOL * ploss[f].abs()).all())
    grad_max = 0.0
    for err, want in zip(errs[1:], (pgda, pgdb)):
        top = float(want[torch.isfinite(want)].abs().max()) if torch.isfinite(want).any() else 0.0
        grad_max = max(grad_max, top)
        ok_grad &= err <= HINGE_GRAD_TOL * top
    n_nan = [int(torch.isnan(x).sum()) for x in (ploss, pgda, pgdb)]
    log(f"pooled hinge {name} use_pix={use_pix}: hard {phard.tolist()} (max diff {hard_diff}), "
        f"max|loss diff| {errs[0]:.3g} of {float(ploss[torch.isfinite(ploss)].abs().max()):.6g}, "
        f"max|grad diff| {max(errs[1:]):.3g} of {grad_max:.3g}; NaN in plain loss/gda/gdb "
        f"{n_nan}, kernels' NaN and infinities where the plain version's are: {same_nonfinite}")
    if not ok_loss or hard_diff > HINGE_HARD_TOL or not ok_grad or not same_nonfinite:
        fail(f"pooled hinge kernels disagree with the plain version on {name}")
    return errs[0], max(errs[1:])


# fault F5: non-finite descriptors, placed as (tensor: 0 da or 1 db, pair,
# validity of the row or entry, channel, value); a NaN anywhere makes the
# loss NaN, as does the same infinity in one channel of a row and an entry
NAN, INF = float("nan"), float("inf")
F5_CASES = [
    ("NaN in a valid row", [(0, 0, 1.0, 1, NAN)]),
    ("NaN in an invalid row", [(0, 1, 0.0, 0, NAN)]),
    ("NaN in a valid entry", [(1, 2, 1.0, 2, NAN)]),
    ("NaN in an invalid entry", [(1, 3, 0.0, 0, NAN)]),
    ("+inf in a row", [(0, 0, 1.0, 2, INF)]),
    ("-inf in an entry", [(1, 1, 1.0, 0, -INF)]),
    ("the same inf in a row and an entry", [(0, 2, 1.0, 1, INF), (1, 2, 0.0, 1, INF)]),
]


def nonfinite_inputs(torch, args, placements):
    """A copy of K1/K2 arguments with the F5_CASES placements applied."""
    args = [a.clone() for a in args]
    for t, b, want, c, value in placements:
        valid = args[4 if t == 0 else 7][b]
        args[t][b, int(torch.nonzero(valid == want)[0, 0]), c] = value
    return args


def kernel_name(mangled):
    """``hinge_fwd<3>`` from a mangled kernel name such as
    ``_ZN<n>_GLOBAL__N__<file>9hinge_fwdILi3EEEvPKf...``: the last component
    of the nested name, with its integer template arguments."""
    import re
    m = re.match(r"_ZN?", mangled)
    if not m:
        return mangled
    i, name = m.end(), mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = re.match(r"\d+", mangled[i:]).end() + i
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    if mangled[i:i + 1] == "I":
        args = mangled[i:mangled.index("EE", i) + 1]
        name += "<" + ",".join(re.findall(r"L[ib](\d+)E", args)) + ">"
    return name


def kernel_templates(_build, source):
    """ptxas registers and spills of the kernels of ``csrc/<source>.cu``,
    by name and template arguments (``hinge_fwd<3>``, ``best_match<3,32>``),
    from nvcc's saved output."""
    report = _build.ptxas_report(_build.build_log(source))
    return dict(sorted((kernel_name(k), v) for k, v in report.items()))


def templates_text(report):
    return "; ".join(f"{k} {v['registers']} registers, spill stores {v['spill_stores']} B, "
                     f"spill loads {v['spill_loads']} B" for k, v in report.items()) \
        or "no nvcc output kept"


def device_frames(torch, np, dev, scene):
    """The scene's frames on the card, as a device cache holds them:
    rgb, depth (int32 millimetres), mask, poses, K and the valid-first
    pixel permutations of the masks."""
    from pdc_tpu_torch.ops.sampling import build_pixel_perm
    rgb, depth, mask, poses = scene.render_all()
    f = {"rgb": torch.as_tensor(rgb, device=dev),
         "depth": torch.as_tensor(depth.astype(np.int32), device=dev),
         "mask": torch.as_tensor(mask, device=dev),
         "pose": torch.as_tensor(poses, dtype=torch.float32, device=dev),
         "K": torch.as_tensor(scene.K, dtype=torch.float32, device=dev)}
    f["perm"], f["count"] = build_pixel_perm(f["mask"])
    return f


def pair_batch(torch, frames, ia, ib):
    """A within-scene batch of pairs (frames ia[k], ib[k]) from the device
    frames, with the keys assemble_batch_matrix reads."""
    ia = torch.as_tensor(ia, device=frames["rgb"].device)
    ib = torch.as_tensor(ib, device=frames["rgb"].device)
    batch = {"K": frames["K"].expand(len(ia), 3, 3),
             "match_type": torch.zeros(len(ia), dtype=torch.int64, device=ia.device)}
    for s, idx in (("a", ia), ("b", ib)):
        for key, src in (("rgb", "rgb"), ("depth", "depth"), ("mask", "mask"), ("pose", "pose"),
                         ("perm", "perm"), ("count", "count")):
            batch[f"{key}_{s}"] = frames[src][idx]
    return batch


def draw_pairs(np, rng, B, n_frames):
    """B within-scene pairs of distinct frames."""
    ia = rng.integers(0, n_frames, B)
    ib = (ia + rng.integers(1, n_frames, B)) % n_frames
    return ia, ib


# -- the training driver ---------------------------------------------------------

# DenseCorrespondenceTraining.run over TRAINING_CONFIG: 6 iterations, so that
# steps_per_dispatch 10 leaves k_eff = 6 and the on-device sampler route is
# taken; checkpoints at 0, 3 and 6; the test loss at iteration 6 over 8 // B = 2
# batches; then 2 more iterations resumed from the folder
DRIVER_OVERRIDES = {"num_iterations": 6, "save_rate": 3, "logging_rate": 3,
                    "compute_test_loss": True, "compute_test_loss_rate": 6,
                    "test_loss_num_iterations": 8, "use_tensorboard": False,
                    "steps_per_dispatch": 10, "seed": 1}
DRIVER_RESUME_ITERATIONS = 2
ROUTE_STEPS = 3  # the timed run of each route
# a reloaded network against the live one: the same weights, the same
# cuDNN algorithm on the same input
RELOAD_TOL = 1e-6


def driver_config(tmp, name, **overrides):
    import copy
    cfg = copy.deepcopy(TRAINING_CONFIG)
    cfg["training"].update(DRIVER_OVERRIDES, logging_dir=tmp, logging_dir_name=name)
    cfg["training"].update(overrides)
    return cfg


def timed_route_run(torch, ph, train_mod, dev, tmp, name, ds, **overrides):
    """ROUTE_STEPS iterations of ``run`` with a synchronising callback, so
    the host clock between two callbacks is one whole step (the sampler
    thread's wait included). Returns (route, [ms of steps 2.. ], K1/K2
    launches, the run's per-call host ms)."""
    cfg = driver_config(tmp, name, num_iterations=ROUTE_STEPS, save_rate=1000,
                        logging_rate=1000, compute_test_loss=False, **overrides)
    trainer = train_mod.DenseCorrespondenceTraining(cfg, ds, device=dev)
    marks = []

    def mark(it, metrics):
        torch.cuda.synchronize(dev)
        marks.append(time.perf_counter())

    ph.forward_launches = ph.backward_launches = 0
    trainer.run(progress_callback=mark)
    launches = (ph.forward_launches, ph.backward_launches)
    step_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    return trainer.route, step_ms, launches, [1e3 * s for s in trainer.step_seconds]


def check_training_driver(torch, np, dev, here, bm, ph):
    """The phase "training driver": checks (a)-(h) of the module docstring.
    Returns the numbers the timings phase prints and the kernels line
    reads."""
    import shutil
    import tempfile

    from pdc_tpu_torch.data.dataset import SpartanDataset
    from pdc_tpu_torch.models.checkpoint import read_checkpoint
    from pdc_tpu_torch.models.convert import adam_state_to_flax, flax_to_state_dict
    from pdc_tpu_torch.training import train as train_mod

    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_driver_", dir=os.path.join(here, "build"))
    out = {}
    try:
        t = time.perf_counter()
        ds_train = SpartanDataset.from_dataset_config(DATASET_RECORD, mode="train")
        ds_test = SpartanDataset.from_dataset_config(DATASET_RECORD, mode="test")
        log(f"training driver datasets: train {sorted(ds_train.scenes)} and test "
            f"{sorted(ds_test.scenes)}, {ds_train.num_images_total} frames "
            f"{DATASET_RECORD['synthetic']['width']}x{DATASET_RECORD['synthetic']['height']} "
            f"each, rendered in {time.perf_counter() - t:.2f} s")

        cfg = driver_config(tmp, "driver")
        trainer = train_mod.DenseCorrespondenceTraining(cfg, ds_train, dataset_test=ds_test,
                                                        device=dev)
        n_iter, batch = cfg["training"]["num_iterations"], cfg["training"]["batch_size"]
        n_eval = cfg["training"]["test_loss_num_iterations"] // batch
        ph.forward_launches = ph.backward_launches = 0
        t = time.perf_counter()
        folder = trainer.run()
        torch.cuda.synchronize(dev)
        run_s = time.perf_counter() - t
        k1, k2 = ph.forward_launches, ph.backward_launches
        # (a) the route
        log(f"training driver: route {trainer.route!r}, {n_iter} iterations in {run_s:.2f} s "
            f"(3 checkpoints and the test loss included)")
        if trainer.route != train_mod.ROUTE_DEVICE_SAMPLER:
            fail(f"the driver took the {trainer.route!r} route, not the device sampler")
        # (b) launches: 2 per train step, 2 per eval batch (K1 only)
        log(f"training driver launches: K1 {k1} (expected 2 x {n_iter} steps + 2 x {n_eval} "
            f"eval batches = {2 * n_iter + 2 * n_eval}), K2 {k2} (expected {2 * n_iter})")
        if k1 != 2 * n_iter + 2 * n_eval or k2 != 2 * n_iter:
            fail(f"K1/K2 launched {k1}/{k2} times in the driver's run")
        # (c) finite metrics, moved weights
        tl, te = trainer._logging_dict["train"], trainer._logging_dict["test"]
        log("training driver losses: " + ", ".join(f"{x:.5g}" for x in tl["loss"])
            + f"; test at {te['iteration']}: loss {te['loss']}, match {te['match_loss']}, "
            f"non-match {te['non_match_loss']}")
        values = [v for k, vs in tl.items() if k != "iteration" for v in vs]
        values += [v for k, vs in te.items() if k != "iteration" for v in vs]
        if (len(tl["loss"]) != n_iter or te["iteration"] != [n_iter]
                or not all(np.isfinite(v) for v in values)):
            fail("a driver metric is missing or not finite")
        first = flax_to_state_dict(read_checkpoint(os.path.join(folder, "000000.ckpt")))
        live = trainer.state.module.state_dict()
        still = [k for k, v in first.items() if v.dim() > 1 and torch.equal(v, live[k].cpu())]
        if still:
            fail(f"the driver left weights unchanged: {still[:5]}")
        # (d) the model folder
        want = {"training.yaml", "dataset.yaml", "identifier.yaml", "loss.yaml"}
        for it in (0, 3, 6):
            want |= {f"{it:06d}.ckpt", f"{it:06d}.ckpt.opt", f"{it:06d}_log_history.yaml"}
        files = set(os.listdir(folder))
        log(f"training driver folder: {sorted(files)}")
        if not want <= files:
            fail(f"the model folder lacks {sorted(want - files)}")
        sizes = {f: os.path.getsize(os.path.join(folder, f))
                 for f in ("000006.ckpt", "000006.ckpt.opt")}
        # (e) the step-6 optimizer file against the live Adam state
        state = trainer.state
        on_disk = read_checkpoint(os.path.join(folder, "000006.ckpt.opt"))
        live_opt = adam_state_to_flax(state.module, state.optimizer,
                                      state.step - state.schedule_start)
        flat_disk, flat_live = flatten(on_disk), flatten(live_opt)
        same = (flat_disk.keys() == flat_live.keys()
                and all(a.dtype == flat_live[k].dtype and np.array_equal(a, flat_live[k])
                        for k, a in flat_disk.items()))
        log(f"training driver 000006.ckpt.opt: {len(flat_disk)} arrays, Adam count "
            f"{int(on_disk['1']['count'])}, bit-equal to the live optimizer state: {same}")
        if not same or int(on_disk["1"]["count"]) != n_iter:
            fail("000006.ckpt.opt does not read back as the live optimizer state")
        # (f) resume for 2 more iterations
        cfg_r = driver_config(tmp, "driver_resumed", num_iterations=DRIVER_RESUME_ITERATIONS)
        resumed = train_mod.DenseCorrespondenceTraining(cfg_r, ds_train, dataset_test=ds_test,
                                                        device=dev)
        ph.forward_launches = ph.backward_launches = 0
        resumed.run_from_pretrained(folder)
        k1_r, k2_r = ph.forward_launches, ph.backward_launches
        end = n_iter + DRIVER_RESUME_ITERATIONS
        steps = {int(s["step"]) for s in resumed.state.optimizer.state.values()}
        log(f"training driver resumed at {resumed._start_iteration}: iterations "
            f"{resumed._logging_dict['train']['iteration']}, Adam steps {sorted(steps)}, "
            f"launches K1 {k1_r}, K2 {k2_r}")
        if (resumed._start_iteration != n_iter or steps != {end} or resumed.state.step != end
                or (k1_r, k2_r) != (2 * DRIVER_RESUME_ITERATIONS,) * 2):
            fail("run_from_pretrained did not resume at 6 and end with every Adam step at 8")
        # (g) the folder's network against the live one, and one K3 query on it
        reloaded, out["k3_err"] = check_reload(torch, np, bm, dev, folder, trainer,
                                               ds_train.scenes["scene_000"], "training driver")
        # (h) the dataset record
        rebuilt = reloaded.load_training_dataset()
        same_ds = (sorted(rebuilt.scenes) == sorted(ds_train.scenes) and all(
            rebuilt.scenes[n].num_frames == s.num_frames
            and np.array_equal(rebuilt.scenes[n].poses, s.poses)
            for n, s in ds_train.scenes.items()))
        log(f"training driver load_training_dataset: scenes {sorted(rebuilt.scenes)}, frames "
            f"{[s.num_frames for _, s in sorted(rebuilt.scenes.items())]}, same poses: {same_ds}")
        if not same_ds:
            fail("load_training_dataset did not rebuild the training dataset")

        # each route, timed: 3 iterations each
        routes = {}
        for name, overrides in (("device", {}), ("cached", {"steps_per_dispatch": 1}),
                                ("streaming", {"cache_dataset_on_device": False})):
            route, step_ms, launches, call_ms = timed_route_run(
                torch, ph, train_mod, dev, tmp, name, ds_train, **overrides)
            routes[route] = {"step_ms": step_ms, "call_ms": call_ms, "launches": launches}
            if launches != (2 * ROUTE_STEPS, 2 * ROUTE_STEPS):
                fail(f"the {route} route launched K1/K2 {launches} times in {ROUTE_STEPS} steps")
        if set(routes) != {train_mod.ROUTE_DEVICE_SAMPLER, train_mod.ROUTE_CACHED_HOST_SAMPLER,
                           train_mod.ROUTE_HOST_STREAMING}:
            fail(f"the timed runs took the routes {sorted(routes)}")
        out.update(k1=k1, k2=k2, run_s=run_s, step_ms=[1e3 * s for s in trainer.step_seconds],
                   save_ms=[1e3 * s for s in trainer.save_seconds], sizes=sizes, routes=routes)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# -- on-disk training ------------------------------------------------------------------

# the DATASET_RECORD scenes written in the pdc layout, one object's scene list
# each (its scene in both splits, as the record's num_test_scenes 0 means)
ONDISK_STAT_IMAGES = 24  # statistics over as many frames as the tree holds
STAT_TOL = 1e-6  # the printed statistics (6 digits) against float64 numpy


class _TrainerOf:
    """Within the block, records the DenseCorrespondenceTraining whose run()
    the command line calls, so its route, metrics and state can be read."""

    def __init__(self, train_mod):
        self._cls = train_mod.DenseCorrespondenceTraining
        self.trainer = None

    def __enter__(self):
        self._run = self._cls.run
        rec = self

        def run(trainer, *args, **kwargs):
            rec.trainer = trainer
            return rec._run(trainer, *args, **kwargs)
        self._cls.run = run
        return self

    def __exit__(self, *exc):
        self._cls.run = self._run


def write_tree(root, record):
    """The record's scenes under ``<root>/logs_proto`` (write_scene) and a
    composite config with one scene list per object under ``<root>/config``.
    Returns (composite file, {scene name: SyntheticScene})."""
    from pdc_tpu_torch.data.synthetic import SyntheticScene
    from pdc_tpu_torch.utils.yaml_io import save_yaml

    rec = dict(record["synthetic"])
    n, n_obj = rec.pop("num_scenes"), max(rec.pop("num_objects"), 1)
    rec.pop("num_test_scenes")
    offset = rec.pop("seed_offset", 0)
    scenes, lists = {}, {}
    for i in range(n):
        name, obj = f"scene_{i:03d}", i % n_obj
        scenes[name] = SyntheticScene(seed=offset + i, texture_seed=obj, **rec)
        scenes[name].write_scene(os.path.join(root, "logs_proto", name))
        lists.setdefault(f"object_{obj}", []).append(name)
    for obj, names in lists.items():
        save_yaml({"object_id": obj, "train": names, "test": names},
                  os.path.join(root, "config", "single_object", f"{obj}.yaml"))
    composite = os.path.join(root, "config", "composite", "composite.yaml")
    save_yaml({"logs_root_path": "logs_proto",
               "single_object_scenes_config_files": [f"{o}.yaml" for o in sorted(lists)]},
              composite)
    return composite, scenes


def write_paeth_png(np, path, rgb):
    """An RGB8 PNG with every row Paeth-filtered, as PIL's and libpng's
    adaptive writers choose for most rows of a camera frame (the port's
    encoder writes Up rows only)."""
    import struct
    import zlib

    h, w, _ = rgb.shape
    x = rgb.reshape(h, w * 3).astype(np.int16)
    a = np.zeros_like(x)
    a[:, 3:] = x[:, :-3]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 3:] = x[:-1, :-3]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.concatenate([np.full((h, 1), 4, np.uint8), ((x - pred) & 0xFF).astype(np.uint8)], 1)

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(
            ">I", zlib.crc32(body, zlib.crc32(t)))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def codec_times(np, nl, tmp, scene, decoders):
    """ms per 640x480 frame (its RGB, depth and mask files) to write and to
    decode with each decoder: one frame alone (median of 3 calls), and a
    whole scene in one call (the pool's threads in parallel) divided by its
    frames."""
    import statistics as stats

    frames = [scene.render(i) for i in range(scene.num_frames)]
    Hs, Ws = scene.height, scene.width
    out = {}
    for dec in decoders:
        d = os.path.join(tmp, f"codec_{dec}")
        os.makedirs(d, exist_ok=True)
        enc = [[(os.path.join(d, f"{i}_rgb.png"), nl.KIND_ENC_RGB8, f[0]),
                (os.path.join(d, f"{i}_depth.png"), nl.KIND_ENC_GRAY16, f[1]),
                (os.path.join(d, f"{i}_mask.png"), nl.KIND_ENC_GRAY8, f[2] * 255)]
               for i, f in enumerate(frames)]
        bufs = [(np.empty((Hs, Ws, 3), np.uint8), np.empty((Hs, Ws), np.uint16),
                 np.empty((Hs, Ws), np.uint8)) for _ in frames]
        kinds = (nl.KIND_RGB8, nl.KIND_GRAY16, nl.KIND_MASK8)
        dec_items = [[(p, k, b) for (p, _, _), k, b in zip(e, kinds, bb)]
                     for e, bb in zip(enc, bufs)]
        one_w, one_d = [], []
        for _ in range(3):
            t = time.perf_counter()
            nl.encode_batch(enc[0], Hs, Ws, decoder=dec)
            one_w.append(time.perf_counter() - t)
            t = time.perf_counter()
            nl.decode_batch(dec_items[0], Hs, Ws, decoder=dec)
            one_d.append(time.perf_counter() - t)
        t = time.perf_counter()
        nl.encode_batch([x for e in enc for x in e], Hs, Ws, decoder=dec)
        all_w = time.perf_counter() - t
        t = time.perf_counter()
        nl.decode_batch([x for e in dec_items for x in e], Hs, Ws, decoder=dec)
        all_d = time.perf_counter() - t
        for f, (rgb, depth, mask) in zip(frames, bufs):
            if not (np.array_equal(rgb, f[0]) and np.array_equal(depth, f[1])
                    and np.array_equal(mask, f[2])):
                fail(f"the {dec} codec did not round-trip a 640x480 frame bit for bit")
        # an RGB frame of Paeth rows, one file alone
        paeth = os.path.join(d, "paeth_rgb.png")
        write_paeth_png(np, paeth, frames[0][0])
        got, one_p = np.empty((Hs, Ws, 3), np.uint8), []
        for _ in range(3):
            t = time.perf_counter()
            nl.decode_batch([(paeth, nl.KIND_RGB8, got)], Hs, Ws, decoder=dec)
            one_p.append(time.perf_counter() - t)
        if not np.array_equal(got, frames[0][0]):
            fail(f"the {dec} codec did not decode a Paeth-filtered frame bit for bit")
        n = len(frames)
        out[dec] = {"write_ms": 1e3 * stats.median(one_w), "decode_ms": 1e3 * stats.median(one_d),
                    "write_ms_batched": 1e3 * all_w / n, "decode_ms_batched": 1e3 * all_d / n,
                    "paeth_rgb_decode_ms": 1e3 * stats.median(one_p)}
    return out


def check_on_disk_training(torch, np, dev, bm, ph, tmp):
    """The phase "on-disk training", in the directory ``tmp``: checks
    (a)-(e) of the module docstring. Returns the numbers the timings phase
    and the kernels line read, and the model folder it trained."""
    import contextlib
    import io

    from pdc_tpu_torch import __main__ as cli
    from pdc_tpu_torch.data import native_loader as nl
    from pdc_tpu_torch.data.dataset import SceneData, SpartanDataset
    from pdc_tpu_torch.data.scene import SceneStructure
    from pdc_tpu_torch.models.checkpoint import read_checkpoint
    from pdc_tpu_torch.models.convert import flax_to_state_dict
    from pdc_tpu_torch.training import train as train_mod
    from pdc_tpu_torch.utils.yaml_io import load_yaml, parse_yaml, save_yaml

    out = {}
    # the decoder auto picks, before any decode
    chosen = nl.resolve_decoder("auto")
    log(f"on-disk: PNG decoder 'auto' chose {chosen!r} ({nl.decoder_reason})")
    t = time.perf_counter()
    composite, scenes = write_tree(tmp, DATASET_RECORD)
    write_s = time.perf_counter() - t
    n_frames = sum(s.num_frames for s in scenes.values())
    log(f"on-disk: wrote {len(scenes)} scenes, {n_frames} frames "
        f"{DATASET_RECORD['synthetic']['width']}x{DATASET_RECORD['synthetic']['height']} in "
        f"the pdc layout ({chosen} encoder, PNGs, pose_data.yaml, camera_info.yaml, "
        f"fusion_mesh.ply) and a composite config in {write_s:.2f} s")

    # the frames on disk against the in-memory rendering
    t = time.perf_counter()
    for name, sc in scenes.items():
        got = SceneData.from_structure(SceneStructure(
            os.path.join(tmp, "logs_proto", name, "processed")), name)
        rgb, depth, mask, poses = sc.render_all()
        pose_err = float(np.abs(got.poses - poses).max())
        same = (np.array_equal(got.rgb, rgb) and np.array_equal(got.depth, depth)
                and np.array_equal(got.mask, mask) and np.array_equal(got.K, sc.K)
                and got.frame_ids is None)
        log(f"on-disk {name}: decoded frames bit-equal to the rendering: {same}; poses "
            f"max|diff| {pose_err:.3g} (bar 1e-9)")
        if not same or not pose_err <= 1e-9:
            fail(f"scene {name} does not read back as it was rendered")
    read_s = time.perf_counter() - t
    decoders = ["zlib"] + (["libpng"] if chosen == "libpng" else [])
    out["codec"] = codec_times(np, nl, tmp, scenes["scene_000"], decoders)
    for dec, c in out["codec"].items():
        log(f"on-disk {dec} codec, {scenes['scene_000'].width}x{scenes['scene_000'].height} "
            f"frame (RGB + depth + mask files): write "
            f"{c['write_ms']:.2f} ms, decode {c['decode_ms']:.2f} ms (one frame alone, "
            f"median of 3); a 12-frame scene in one call: write {c['write_ms_batched']:.2f}, "
            f"decode {c['decode_ms_batched']:.2f} ms per frame (host clock, {os.cpu_count()} "
            f"cores); the RGB file alone with every row Paeth-filtered: decode "
            f"{c['paeth_rgb_decode_ms']:.2f} ms")

    # python -m pdc_tpu_torch train, in this process
    cfg = driver_config(tmp, "on_disk")
    cfg_file = os.path.join(tmp, "training.yaml")
    save_yaml(cfg, cfg_file)
    argv = ["train", "--config", cfg_file, "--dataset_config", composite, "--data_dir", tmp,
            "--name", "on_disk", "--logging_dir", tmp, "--device", str(dev)]
    n_iter, batch = cfg["training"]["num_iterations"], cfg["training"]["batch_size"]
    n_eval = cfg["training"]["test_loss_num_iterations"] // batch
    ph.forward_launches = ph.backward_launches = 0
    t = time.perf_counter()
    with _TrainerOf(train_mod) as rec:
        rc = cli.main(argv)
    torch.cuda.synchronize(dev)
    run_s = time.perf_counter() - t
    k1, k2 = ph.forward_launches, ph.backward_launches
    trainer = rec.trainer
    if rc != 0 or trainer is None:
        fail(f"python -m pdc_tpu_torch train returned {rc}")
    folder = trainer.logging_dir
    log(f"on-disk: python -m pdc_tpu_torch {' '.join(argv)} -> {folder}: route "
        f"{trainer.route!r}, {n_iter} iterations in {run_s:.2f} s (the scenes' decode, 3 "
        f"checkpoints and the test loss included)")
    # (a) launches
    log(f"on-disk launches: K1 {k1} (expected 2 x {n_iter} steps + 2 x {n_eval} eval "
        f"batches = {2 * n_iter + 2 * n_eval}), K2 {k2} (expected {2 * n_iter})")
    if k1 != 2 * n_iter + 2 * n_eval or k2 != 2 * n_iter:
        fail(f"K1/K2 launched {k1}/{k2} times in the on-disk run")
    # (b) finite metrics, moved weights
    tl, te = trainer._logging_dict["train"], trainer._logging_dict["test"]
    values = [v for k, vs in tl.items() if k != "iteration" for v in vs]
    values += [v for k, vs in te.items() if k != "iteration" for v in vs]
    log("on-disk losses: " + ", ".join(f"{x:.5g}" for x in tl["loss"])
        + f"; test at {te['iteration']}: loss {te['loss']}")
    if (len(tl["loss"]) != n_iter or te["iteration"] != [n_iter]
            or not all(np.isfinite(v) for v in values)):
        fail("an on-disk metric is missing or not finite")
    first = flax_to_state_dict(read_checkpoint(os.path.join(folder, "000000.ckpt")))
    live = trainer.state.module.state_dict()
    still = [k for k, v in first.items() if v.dim() > 1 and torch.equal(v, live[k].cpu())]
    if still:
        fail(f"the on-disk run left weights unchanged: {still[:5]}")
    # (c) the dataset record, and the dataset rebuilt from it
    record = load_yaml(os.path.join(folder, "dataset.yaml"))
    want_dirs = (os.path.abspath(tmp), os.path.dirname(os.path.abspath(composite)))
    log(f"on-disk dataset.yaml: data_dir {record.get('data_dir')}, config_dir "
        f"{record.get('config_dir')}")
    if (record.get("data_dir"), record.get("config_dir")) != want_dirs:
        fail(f"dataset.yaml does not record the absolute data_dir and config_dir {want_dirs}")
    # (d) the folder's network, and one K3 query on it
    trained = trainer.dataset
    reloaded, out["k3_err"] = check_reload(torch, np, bm, dev, folder, trainer,
                                           trained.scenes["scene_000"], "on-disk")
    rebuilt = reloaded.load_training_dataset("train")
    same_ds = rebuilt.get_scene_list() == trained.get_scene_list() and all(
        rebuilt.get_scene(n).frame_ids is None and s.frame_ids is None
        and np.array_equal(rebuilt.get_scene(n).poses, s.poses)
        and rebuilt.get_scene(n).num_frames == s.num_frames
        for n, s in trained.scenes.items())
    log(f"on-disk load_training_dataset('train'): scenes {rebuilt.get_scene_list()}, "
        f"frames {[rebuilt.get_scene(n).num_frames for n in rebuilt.get_scene_list()]}, same "
        f"names, frame ids and poses as the trained dataset: {same_ds}")
    if not same_ds:
        fail("load_training_dataset did not rebuild the on-disk dataset")
    # (e) statistics on the tree against float64 numpy over the same frames
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["statistics", "--config", composite, "--data_dir", tmp,
                  "--num_images", str(ONDISK_STAT_IMAGES), "--device", str(dev)])
    block = parse_yaml(buf.getvalue())["image_normalization"]
    again = SpartanDataset(config=load_yaml(composite), data_dir=tmp,
                           config_dir=os.path.dirname(composite))
    frames = []
    for _ in range(ONDISK_STAT_IMAGES):
        name = again.get_random_scene_name()
        frames.append(again.get_rgbd_mask_pose(name, again.get_random_image_index(name))[0])
    x = np.stack(frames).reshape(-1, 3).astype(np.float64) / 255.0
    stat_err = max(float(np.abs(np.asarray(block["mean"]) - x.mean(0)).max()),
                   float(np.abs(np.asarray(block["std_dev"]) - x.std(0)).max()))
    log(f"on-disk statistics: mean {block['mean']}, std_dev {block['std_dev']}; "
        f"max|diff| to float64 numpy over the same {ONDISK_STAT_IMAGES} frames "
        f"{stat_err:.3g} (bar {STAT_TOL})")
    if not stat_err <= STAT_TOL:
        fail("the statistics command disagrees with float64 numpy")
    out.update(k1=k1, k2=k2, run_s=run_s, write_s=write_s, read_s=read_s, decoder=chosen,
               step_ms=[1e3 * s for s in trainer.step_seconds], route=trainer.route,
               folder=folder)
    return out


def check_reload(torch, np, bm, dev, folder, trainer, scene, what):
    """``from_model_folder`` on ``folder`` against the live network of
    ``trainer`` (forward_on_img within RELOAD_TOL on the scene's frame 0),
    then one K3 query of 16 descriptors of frame 1 on the reloaded
    descriptors of frame 0, against the plain best match. Returns (the
    reloaded network, K3's distance error against its plain version)."""
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork

    reloaded = DenseCorrespondenceNetwork.from_model_folder(folder, device=dev)
    live_dcn = trainer.get_dcn()
    frame = scene.rgb[0]
    res = reloaded.forward_on_img(frame)
    reload_err = float((res - live_dcn.forward_on_img(frame)).abs().max())
    Hd, Wd, Dd = res.shape
    image = res.permute(2, 0, 1).reshape(1, Dd, Hd * Wd).contiguous()
    other = reloaded.forward_on_img(scene.rgb[1])
    px = torch.as_tensor(np.random.default_rng(SEED).integers(0, Hd * Wd, 16), device=dev)
    q = other.reshape(Hd * Wd, Dd)[px][None].contiguous()
    idx, dist = bm.best_match(image, q)
    pidx, pdist = bm.best_match_reference(image, q)
    bad, err = check_matches(torch, bm, image, q, idx, dist)
    vs_plain = float((dist - pdist).abs().max())
    log(f"{what} reload: from_model_folder vs get_dcn max|diff| {reload_err:.3g} "
        f"(bar {RELOAD_TOL}); K3 on the reloaded descriptors, 16 queries: bad_idx {bad}, "
        f"dist_err {err:.3g}, vs plain {vs_plain:.3g}")
    if not reload_err <= RELOAD_TOL or bad or not err <= DIST_TOL or not vs_plain <= PLAIN_TOL:
        fail(f"{what}: the reloaded network disagrees with the live one, or K3 with its plain "
             "version")
    return reloaded, vs_plain


# -- evaluation ---------------------------------------------------------------------

# python -m pdc_tpu_torch evaluate on phase 8's model folder: 20 pairs of 100
# matches in each split (seed 1), chunks of SWEEP_PAIR_CHUNK pairs; check (c)
# reruns the first EVAL_CHECK_PAIRS test pairs both ways
EVAL_PAIRS, EVAL_MATCHES, EVAL_CHECK_PAIRS = 20, 100, 4
# the fused route (K3) against the per-pair route (plain best match): the
# same arithmetic but K3's FMAs, so 1e-5 on every value column
EVAL_COL_TOL = 1e-5
# columns that follow the unmasked pick; compared where both routes pick the
# same pixel (a differing pick must be a near-tie, TIE_TOL_D2)
PICK_COLUMNS = ("pixel_match_error_l2", "pixel_match_error_l1", "norm_diff_pred_3d",
                "is_valid", "uv_b_pred")


def _timer(torch, owner, name, totals, key, bm=None):
    """Replace ``owner.name`` by a wrapper that synchronises before and
    after each call and adds its seconds (and, given ``bm``, its K3
    launches) to ``totals[key]``. Returns the function that restores it."""
    orig = owner.__dict__[name]
    fn = orig.__func__ if isinstance(orig, staticmethod) else orig

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t, n = time.perf_counter(), bm.launches if bm else 0
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            totals[key] = totals.get(key, 0.0) + time.perf_counter() - t
            if bm:
                totals[key + "_launches"] = totals.get(key + "_launches", 0) + bm.launches - n
    setattr(owner, name, staticmethod(wrapper) if isinstance(orig, staticmethod) else wrapper)
    return lambda: setattr(owner, name, orig)


def check_eval_routes(torch, np, bm, ev, ds, pairs, images, table):
    """Check (c): the first EVAL_CHECK_PAIRS pairs of a sweep through the
    fused route (one K3 launch) against the per-pair route with the plain
    best match, and the fused rows against the sweep's table. Returns
    (differing picks, K3's distance error against the plain version)."""
    sub = pairs[:EVAL_CHECK_PAIRS]
    dev = images[sub[0][:2]].device
    res_a = torch.stack([images[(s, a)] for s, a, _, _ in sub])
    res_b = torch.stack([images[(s, b)] for s, _, b, _ in sub])
    frames = ev._chunk_frames(ds, sub, dev)
    uv_a, uv_b, gt_valid = ev._sweep_correspondences(frames, [p[3] for p in sub],
                                                     EVAL_MATCHES, 2000)
    fused = {k: v.cpu().numpy() for k, v in ev._sweep_statistics(
        frames, uv_a, uv_b, res_a, res_b).items()}
    gt_valid = gt_valid.cpu().numpy()
    saved, ev.best_match = ev.best_match, bm.best_match_reference
    try:
        plain = [ev._pair_statistics(ds, s, a, b, EVAL_MATCHES, ev.pair_generator(ps), 2000,
                                     images[(s, a)], images[(s, b)]) for s, a, b, ps in sub]
    finally:
        ev.best_match = saved
    Hd, Wd, Dd = res_a.shape[1:]
    ties, dist_err, col_err, row = 0, 0.0, 0.0, 0
    for p, (s, a, b, _) in enumerate(sub):
        keep = np.nonzero(gt_valid[p])[0]
        f = {k: v[p][keep] for k, v in fused.items()}
        q = plain[p]
        if q is None or len(keep) != len(q["is_valid"]):
            fail(f"evaluation (c): pair {p} has {len(keep)} fused rows but "
                 f"{0 if q is None else len(q['is_valid'])} per-pair rows")
        same = (f["uv_b_pred"] == q["uv_b_pred"]).all(-1)
        if not same.all():  # a differing pick must be a float64 near-tie
            qa = res_a[p].reshape(-1, Dd).double()[torch.as_tensor(
                uv_a[p][keep][:, 1] * Wd + uv_a[p][keep][:, 0], device=dev)]
            rb = res_b[p].reshape(-1, Dd).double()
            for i in np.nonzero(~same)[0]:
                d2 = [float(((rb[int(uv[i][1]) * Wd + int(uv[i][0])] - qa[i]) ** 2).sum())
                      for uv in (f["uv_b_pred"], q["uv_b_pred"])]
                if abs(d2[0] - d2[1]) > TIE_TOL_D2:
                    fail(f"evaluation (c): pair {p} match {i} picks {f['uv_b_pred'][i]} (K3) "
                         f"and {q['uv_b_pred'][i]} (plain), squared distances {d2}")
                ties += 1
        for k in q:
            mask = same if k in PICK_COLUMNS else np.ones_like(same)
            x, y = f[k][mask].astype(np.float64), q[k][mask].astype(np.float64)
            if not np.array_equal(np.isnan(x), np.isnan(y)):
                fail(f"evaluation (c): NaN pattern of {k} differs on pair {p}")
            err = float(np.abs(x - y)[~np.isnan(x)].max()) if (~np.isnan(x)).any() else 0.0
            if k == "norm_diff_descriptor":
                dist_err = max(dist_err, err)
            col_err = max(col_err, err)
        # the rerun against the sweep's own rows (the CSV the command wrote)
        for c in ("norm_diff_descriptor", "norm_diff_descriptor_masked",
                  "pixel_match_error_l2", "fraction_pixels_closer_than_ground_truth",
                  "average_l2_distance_for_false_positives_masked", "norm_diff_pred_3d"):
            x = table[c][row:row + len(keep)].astype(np.float64)
            y = f[c].astype(np.float64)
            if not np.allclose(x, y, atol=EVAL_COL_TOL, rtol=0, equal_nan=True):
                fail(f"evaluation (c): the rerun's {c} of pair {p} differs from the data.csv "
                     "the command wrote")
        row += len(keep)
    log(f"evaluation (c): {EVAL_CHECK_PAIRS} test pairs, {row} matches, fused route (K3) vs "
        f"per-pair route (plain best match): {ties} differing picks, all near-ties; max|diff| "
        f"{col_err:.3g} over the value columns (bar {EVAL_COL_TOL}); the rerun equals the "
        f"data.csv rows")
    if col_err > EVAL_COL_TOL:
        fail("evaluation (c): the fused and per-pair routes disagree")
    return ties, dist_err


def check_evaluation(torch, np, dev, here, bm, folder):
    """The phase "evaluation": checks (a)-(f) of the module docstring, and
    the numbers the timings phase and the kernels line read."""
    import importlib
    import math

    from pdc_tpu_torch import __main__ as cli
    from pdc_tpu_torch.evaluation import evaluate as ev
    from pdc_tpu_torch.evaluation.table import read_csv
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
    from pdc_tpu_torch.utils.yaml_io import load_yaml

    have = {}
    for name in ("pandas", "matplotlib", "cv2"):
        try:
            importlib.import_module(name)
            have[name] = True
        except ImportError:
            have[name] = False
    log("evaluation: optional modules on this machine: " + ", ".join(
        f"{k} {'imports' if v else 'missing'}" for k, v in have.items()))
    out_dir = os.path.join(folder, "analysis")
    argv = ["evaluate", "--model_folder", folder, "--num_image_pairs", str(EVAL_PAIRS),
            "--num_matches_per_image_pair", str(EVAL_MATCHES), "--device", str(dev)]
    if not have["matplotlib"]:
        argv.append("--no_qualitative")
    DCE = ev.DenseCorrespondenceEvaluation
    totals = {}
    restore = [_timer(torch, DCE, "evaluate_network_quantitative", totals, "sweep"),
               _timer(torch, DCE, "compute_descriptor_images_batched", totals, "forwards"),
               _timer(torch, ev, "_sweep_correspondences", totals, "correspondences"),
               _timer(torch, ev, "_sweep_statistics", totals, "statistics", bm),
               _timer(torch, DCE, "compute_descriptor_statistics_on_dataset", totals,
                      "descriptor statistics"),
               _timer(torch, DCE, "evaluate_network_across_objects", totals, "across objects")]
    bm.launches = 0
    t = time.perf_counter()
    try:
        rc = cli.main(argv)
        torch.cuda.synchronize(dev)
    finally:
        for r in restore:
            r()
    run_s = time.perf_counter() - t
    launches = bm.launches
    if rc != 0:
        fail(f"python -m pdc_tpu_torch evaluate returned {rc}")
    log(f"evaluation: python -m pdc_tpu_torch {' '.join(argv)}: {run_s:.2f} s")

    # (a) the sweeps' tables, read back
    ds = DCE.load_dataset_from_model_folder(folder)
    tables, pair_lists = {}, {}
    for mode in ("train", "test"):
        ds.set_train_mode() if mode == "train" else ds.set_test_mode()
        pair_lists[mode] = ev.image_pair_list(ds, EVAL_PAIRS, 1)
        tables[mode] = read_csv(os.path.join(out_dir, mode, "data.csv"))
        t_ = tables[mode]
        finite = np.isfinite(t_["norm_diff_descriptor"].astype(np.float64)).all()
        log(f"evaluation (a) {mode}/data.csv: {len(t_)} rows x {len(t_.columns)} columns from "
            f"{len(pair_lists[mode])} pairs; columns as EVAL_COLUMNS: "
            f"{t_.columns == ev.EVAL_COLUMNS}; descriptor distances finite: {finite}")
        if (t_.columns != ev.EVAL_COLUMNS or not 0 < len(t_) <= EVAL_MATCHES * len(
                pair_lists[mode]) or not finite):
            fail(f"evaluation (a): {mode}/data.csv is not a table of the 23 columns")
    # (b) K3 on the sweeps: one launch per chunk
    chunks = sum(math.ceil(len(v) / ev.SWEEP_PAIR_CHUNK) for v in pair_lists.values())
    qual = sum(f.endswith("_matches.png") for _, _, fs in os.walk(out_dir) for f in fs)
    sweep_launches = totals.get("statistics_launches", 0)
    log(f"evaluation (b): K3 launches {launches}: {sweep_launches} in the sweeps (expected one "
        f"per chunk of {ev.SWEEP_PAIR_CHUNK} pairs: {chunks}), {launches - sweep_launches} in "
        f"{qual} qualitative panels")
    if sweep_launches != chunks or launches != sweep_launches + qual:
        fail("evaluation (b): K3 did not launch once per sweep chunk")
    # (c) fused against per-pair, on the test split's first pairs
    dcn = DenseCorrespondenceNetwork.from_model_folder(folder, device=dev)
    pairs = pair_lists["test"]
    images = DCE.compute_descriptor_images_batched(
        dcn, ds, [(s, i) for s, a, b, _ in pairs for i in (a, b)])
    ties, k3_err = check_eval_routes(torch, np, bm, ev, ds, pairs, images, tables["test"])
    # (d) stats.yaml
    for mode in ("train", "test"):
        st = load_yaml(os.path.join(out_dir, mode, "stats.yaml"))
        pck = [st.get(f"pck_at_{k}px") for k in (5, 10, 25, 50, 100)]
        log(f"evaluation (d) {mode}/stats.yaml: PCK@5,10,25,50,100 {pck}, area above the 3D "
            f"CDF {st.get('norm_diff_3d_area_above_curve')}")
        if (not all(isinstance(x, float) and 0.0 <= x <= 1.0 for x in pck)
                or not math.isfinite(st.get("norm_diff_3d_area_above_curve", math.nan))):
            fail(f"evaluation (d): {mode}/stats.yaml is not a set of PCKs in [0, 1]")
    # (e) descriptor_statistics.yaml
    ds_stats = load_yaml(os.path.join(folder, "descriptor_statistics.yaml"))
    ok = all(len(v[k]) == D and all(math.isfinite(x) for x in v[k])
             for v in ds_stats.values() for k in ("min", "mean", "max")) and all(
        mn <= me <= mx for v in ds_stats.values()
        for mn, me, mx in zip(v["min"], v["mean"], v["max"]))
    log(f"evaluation (e) descriptor_statistics.yaml: {ds_stats}; finite, min <= mean <= max: "
        f"{ok}")
    if not ok or set(ds_stats) != {"entire_image", "mask_image"}:
        fail("evaluation (e): descriptor_statistics.yaml is not finite and ordered")
    # (f) across objects
    n_obj = ds.get_number_of_unique_single_objects()
    ao_csv = os.path.join(out_dir, "across_object", "data.csv")
    if n_obj > 1:
        ao = read_csv(ao_csv) if os.path.exists(ao_csv) else None
        log(f"evaluation (f): {n_obj} objects; across_object/data.csv "
            f"{'missing' if ao is None else f'{len(ao)} rows, columns {ao.columns}'}")
        if ao is None or ao.columns != ev.ACROSS_OBJECT_COLUMNS or not len(ao):
            fail("evaluation (f): the across-object table is missing or empty")
    files = sorted(os.path.relpath(os.path.join(d, f), folder)
                   for d, _, fs in os.walk(out_dir) for f in fs)
    log(f"evaluation files: descriptor_statistics.yaml, {files}")

    # K3 at the sweep's shape: the first chunk's pairs of the test split
    B = min(ev.SWEEP_PAIR_CHUNK, len(pairs))
    chunk = pairs[:B]
    frames = ev._chunk_frames(ds, chunk, dev)
    uv_a, _, _ = ev._sweep_correspondences(frames, [p[3] for p in chunk], EVAL_MATCHES, 2000)
    res_a = torch.stack([images[(s, a)] for s, a, _, _ in chunk])
    res_b = torch.stack([images[(s, b)] for s, _, b, _ in chunk])
    Hd, Wd, Dd = res_a.shape[1:]
    flat = (uv_a[..., 1] * Wd + uv_a[..., 0])[..., None].expand(-1, -1, Dd)
    q = torch.gather(res_a.reshape(B, -1, Dd), 1, flat).contiguous()
    res = res_b.reshape(B, -1, Dd).transpose(1, 2).contiguous()
    idx, dist = bm.best_match(res, q)
    torch.cuda.synchronize()
    bad, err = check_matches(torch, bm, res, q, idx, dist)
    vs_plain = float((dist - bm.best_match_reference(res, q)[1]).abs().max())
    log(f"K3 at the sweep's shape B={B} Q={EVAL_MATCHES} {Wd}x{Hd} D={Dd}: bad_idx {bad}, "
        f"dist_err {err:.3g}, vs plain {vs_plain:.3g}")
    if bad or not err <= DIST_TOL or not vs_plain <= PLAIN_TOL:
        fail("K3 disagrees with its plain version at the sweep's shape")
    flat_b = res_b.reshape(B, -1, Dd)

    def library():
        dmat = torch.cdist(flat_b, q)  # [B, HW, Q]
        i = dmat.argmin(dim=1)
        return i, dmat.gather(1, i[:, None])
    k3 = {"B": B, "Q": EVAL_MATCHES, "HW": Hd * Wd,
          "ms": time_device(torch, lambda: bm.best_match(res, q)),
          "wrapper_ms": time_cuda(torch, lambda: bm.best_match(res, q)),
          "plain_ms": time_device(torch, lambda: bm.best_match_reference(res, q), iters=3),
          "library_ms": time_device(torch, library, iters=3),
          "split": profile_split(torch, lambda: bm.best_match(res, q))}
    k3["bound_ms"], k3["bound_by"] = bound(B, EVAL_MATCHES, Dd, Hd * Wd)
    return {"run_s": run_s, "totals": totals, "launches": launches, "have": have,
            "k3_err": max(k3_err, vs_plain), "k3": k3, "ties": ties,
            "pairs": {m: len(v) for m, v in pair_lists.items()},
            "rows": {m: len(v) for m, v in tables.items()}}


def flatten(tree, prefix=""):
    """{'a/b': leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def main():
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    here = os.path.dirname(os.path.abspath(__file__))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke run needs an NVIDIA GPU")
    try:
        import pdc_tpu_torch
    except ImportError as e:
        fail(f"pdc_tpu_torch not importable ({e}): run from the root of a checkout")
    if os.path.dirname(os.path.dirname(os.path.abspath(pdc_tpu_torch.__file__))) != here:
        fail(f"pdc_tpu_torch imported from {pdc_tpu_torch.__file__}, not from this checkout")
    from pdc_tpu_torch.apps.serve import DescriptorClient, DescriptorServer, _Request
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
    from pdc_tpu_torch.ops import _build
    from pdc_tpu_torch.ops import best_match as bm
    from pdc_tpu_torch.ops import pooled_hinge as ph

    # 1. environment ----------------------------------------------------------
    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    log(smi)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    log(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    phase("environment", t0)

    # 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    for name, secs in _build.build_all().items():
        log(f"built {name}: {secs:.2f} s -> {_build.library_path(name).relative_to(here)}")
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  nvcc: {line.strip()}")
    bm._library()
    ph._library()
    hinge_ptxas = kernel_templates(_build, "pooled_hinge")
    log("K1 templates (ptxas): " + templates_text(
        {k: v for k, v in hinge_ptxas.items() if k.startswith("hinge_fwd")}))
    log("K2 templates (ptxas): " + templates_text(
        {k: v for k, v in hinge_ptxas.items() if k.startswith("hinge_bwd")}))
    log("K3 templates (ptxas): " + templates_text(kernel_templates(_build, "best_match")))
    phase("build", t0)

    # 3. kernel against plain version -------------------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    cfg = {"descriptor_dimension": D, "image_width": W, "image_height": H,
           "backbone": {"model_class": "Resnet", "resnet_name": "Resnet34_8s"}}
    dcn = DenseCorrespondenceNetwork.from_config(
        cfg, generator=torch.Generator().manual_seed(SEED), device="cuda")
    frames = rng.integers(0, 256, size=(N_FRAMES, H, W, 3), dtype=np.uint8)
    mean = torch.as_tensor(dcn.image_mean, dtype=torch.float32, device=dev)
    std = torch.as_tensor(dcn.image_std_dev, dtype=torch.float32, device=dev)
    with torch.inference_mode():
        x = (torch.from_numpy(frames).to(dev).float() / 255.0 - mean) / std
        x = x.permute(0, 3, 1, 2).contiguous()
        images = dcn.module(x).reshape(N_FRAMES, D, H * W)  # [8, D, HW] planar
    torch.cuda.synchronize()

    def image_queries(b_src, n_other, n_self, b_self):
        """Descriptors of frame b_src at random pixels (a match from another
        view) and of frame b_self itself (exact matches, distance 0)."""
        p1 = torch.as_tensor(rng.integers(0, H * W, n_other), device=dev)
        p2 = torch.as_tensor(rng.integers(0, H * W, n_self), device=dev)
        return torch.cat([images[b_src][:, p1].t(), images[b_self][:, p2].t()]).contiguous()

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=dev)

    cases = [
        ("random HW=3072 Q=8 D=16", randn(1, 16, 3072), randn(1, 8, 16)),
        ("random HW=5000 Q=4 D=3", randn(1, 3, 5000), randn(1, 4, 3)),
        ("640x480 D=3 Q=1", images[:1].contiguous(), image_queries(1, 1, 0, 0)[None]),
        ("640x480 D=3 Q=16", images[:1].contiguous(), image_queries(1, 8, 8, 0)[None]),
        ("640x480 D=3 Q=1024", images[:1].contiguous(), image_queries(1, 512, 512, 0)[None]),
        ("640x480 D=3 B=8 Q=16", images.contiguous(),
         torch.stack([image_queries((b + 1) % N_FRAMES, 8, 8, b) for b in range(N_FRAMES)])),
        # HW % 4 != 0: the kernel's scalar loads
        ("random HW=5001 Q=16 D=3", randn(1, 3, 5001), randn(1, 16, 3)),
        ("640x480 less one pixel D=3 B=8 Q=17", images[:, :, :H * W - 1].contiguous(),
         torch.stack([image_queries((b + 1) % N_FRAMES, 8, 9, b) for b in range(N_FRAMES)])),
    ]
    max_abs_err = 0.0
    for name, res, q in cases:
        idx_k, dist_k = bm.best_match(res, q)
        torch.cuda.synchronize()
        idx_p, dist_p = bm.best_match_reference(res, q)
        bad_k, err_k = check_matches(torch, bm, res, q, idx_k, dist_k)
        bad_p, err_p = check_matches(torch, bm, res, q, idx_p, dist_p)
        vs_plain = float((dist_k - dist_p).abs().max())
        same = float((idx_k == idx_p).float().mean())
        max_abs_err = max(max_abs_err, vs_plain)
        log(f"kernel {name}: bad_idx {bad_k} dist_err {err_k:.3g} | vs plain: "
            f"max|dist diff| {vs_plain:.3g}, same idx {same:.4f} "
            f"(plain: bad_idx {bad_p} dist_err {err_p:.3g})")
        if bad_k or not err_k <= DIST_TOL or not vs_plain <= PLAIN_TOL:
            fail(f"kernel disagrees on {name}")
    del cases
    torch.cuda.empty_cache()
    phase("kernel vs plain", t0)

    # 4. pooled hinge kernels (K1, K2) against their plain version -------------
    t0 = time.perf_counter()
    Bh, Nm, P = HINGE_B, HINGE_NM, HINGE_P

    def image_rows(n, frame_of):
        """Rows of the net's 640x480 descriptor images at random pixels."""
        px = torch.as_tensor(rng.integers(0, H * W, (Bh, n)), device=dev)
        return torch.stack([images[frame_of(b)][:, px[b]].t() for b in range(Bh)]).contiguous()

    hinge_cases = [
        ("random rows (scale 0.3) B=4 Nm=10000 P=1024 D=3",
         hinge_inputs(torch, np, rng, dev, Bh, Nm, P)),
        ("rows of 640x480 descriptor images B=4 Nm=10000 P=1024 D=3",
         hinge_inputs(torch, np, rng, dev, Bh, Nm, P, da=image_rows(Nm, lambda b: b),
                      db=image_rows(P, lambda b: b))),
        ("collision-heavy (pixels in [0, 8)^2)",
         hinge_inputs(torch, np, rng, dev, Bh, Nm, P, coord_max=8)),
        ("all rows invalid", hinge_inputs(torch, np, rng, dev, Bh, Nm, P, valid_frac=0.0)),
        ("ragged B=3 Nm=777 P=1000 D=16", hinge_inputs(torch, np, rng, dev, 3, 777, 1000, Dd=16)),
        ("most pairs count: random rows at scale 0.05, B=4 Nm=10000 P=1024 D=3",
         hinge_inputs(torch, np, rng, dev, Bh, Nm, P, scale=0.05)),
    ]
    base = hinge_inputs(torch, np, rng, dev, Bh, Nm, P)
    hinge_cases += [(f"{name} (fault F5), B=4 Nm=10000 P=1024 D=3",
                     nonfinite_inputs(torch, base, placements))
                    for name, placements in F5_CASES]
    k1_err = k2_err = 0.0
    for name, args in hinge_cases:
        for use_pix in (False, True):
            e1, e2 = check_pooled_hinge(torch, ph, name, args, use_pix)
            k1_err, k2_err = max(k1_err, e1), max(k2_err, e2)
    del hinge_cases, base
    torch.cuda.empty_cache()
    phase("pooled hinge vs plain", t0)

    # 5. the main path, serving ---------------------------------------------------
    t0 = time.perf_counter()
    n_req = N_CLIENTS * REQUESTS_PER_CLIENT
    plan = []  # (frame, queries or None)
    for r in range(n_req):
        f = r % N_FRAMES
        if r % 2:
            q = image_queries((f + 1) % N_FRAMES, SERVE_QUERIES // 2, SERVE_QUERIES // 2, f)
            plan.append((f, q.cpu().numpy()))
        else:
            plan.append((f, None))
    server = DescriptorServer(dcn, host="127.0.0.1", port=0, max_batch=8, max_wait_ms=20.0)
    results, latencies, errors = [None] * n_req, [None] * n_req, []
    try:
        server.warmup()
        server.start()
        host, port = server.address
        barrier = threading.Barrier(N_CLIENTS)

        def client(c):
            try:
                with DescriptorClient(host, port, timeout=60.0) as cl:
                    if not cl.ping():
                        raise RuntimeError("ping failed")
                    barrier.wait(timeout=60.0)
                    for r in range(c, n_req, N_CLIENTS):
                        f, q = plan[r]
                        t = time.perf_counter()
                        results[r] = (cl.descriptors(frames[f]) if q is None
                                      else cl.best_match(frames[f], q))
                        latencies[r] = time.perf_counter() - t
            except Exception as e:
                errors.append(f"client {c}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(N_CLIENTS)]
        before = dict(server.stats)
        bm.launches = 0
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        launches = bm.launches
        after = dict(server.stats)
        if any(t.is_alive() for t in threads):
            fail("a client thread did not finish")
        # one client alone, request after request: latency without queueing
        seq = {"descriptors": [], "best_match": []}
        with DescriptorClient(host, port, timeout=60.0) as cl:
            info = cl.info()
            for r in range(2 * N_FRAMES):
                f, q = plan[r]
                t = time.perf_counter()
                cl.descriptors(frames[f]) if q is None else cl.best_match(frames[f], q)
                seq["descriptors" if q is None else "best_match"].append(time.perf_counter() - t)
    finally:
        server.shutdown()
    if errors:
        fail("; ".join(errors))
    if any(r is None for r in results):
        fail("a request got no answer")
    delta = {k: after[k] - before[k] for k in after}
    log(f"serving: {n_req} requests from {N_CLIENTS} clients, all ok; stats {delta}; "
        f"info {info['height']}x{info['width']} D={info['descriptor_dimension']}; "
        f"best_match kernel launches {launches}")
    if not launches > 0 or launches != delta["match_dispatches"]:
        fail(f"best_match launches {launches} != dispatches with queries "
             f"{delta['match_dispatches']}")

    desc_err, bad_total, dist_err = 0.0, 0, 0.0
    for r, (f, q) in enumerate(plan):
        want = dcn.forward_on_img(frames[f])  # [H, W, D] on the card
        if q is None:
            got = torch.from_numpy(np.array(results[r])).to(dev)
            if got.shape != want.shape or not torch.isfinite(got).all():
                fail(f"request {r}: descriptors of shape {tuple(got.shape)} or not finite")
            desc_err = max(desc_err, float((got - want).abs().max()))
            if not torch.allclose(got, want, atol=DESC_TOL, rtol=DESC_TOL):
                fail(f"request {r}: served descriptors differ from forward_on_img")
        else:
            uv, dist = results[r]
            res = want.permute(2, 0, 1).reshape(1, D, H * W).contiguous()
            qt = torch.from_numpy(q).to(dev)[None]
            idx = torch.from_numpy(uv[:, 1] * W + uv[:, 0]).to(dev)[None]
            bad, err = check_matches(torch, bm, res, qt,
                                     idx, torch.from_numpy(np.array(dist)).to(dev)[None])
            bad_total += bad
            dist_err = max(dist_err, err)
    log(f"serving answers: descriptors max|diff| {desc_err:.3g} vs forward_on_img; "
        f"best_match bad_idx {bad_total} dist_err {dist_err:.3g} vs plain on that image")
    if bad_total or not dist_err <= DIST_TOL:
        fail("served best matches disagree with the plain version")
    lat = [x for x in latencies if x is not None]
    phase("serving", t0)

    # 6. the main path, training -------------------------------------------------
    t0 = time.perf_counter()
    from pdc_tpu_torch.data.assembler import AssemblerConfig
    from pdc_tpu_torch.data.synthetic import SyntheticScene
    from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
    from pdc_tpu_torch.models.dcn import build_backbone
    from pdc_tpu_torch.models.resnet import init_weights_
    from pdc_tpu_torch.training.train import build_loss_fn, create_train_state, make_train_step

    tc = TRAINING_CONFIG
    net_cfg = tc["dense_correspondence_network"]
    Bt = tc["training"]["batch_size"]
    loss_cfg = LossConfig.from_dict(tc["loss_function"])
    asm_cfg = AssemblerConfig.from_training_config(tc)
    Ht, Wt = net_cfg["image_height"], net_cfg["image_width"]
    scene = SyntheticScene(width=Wt, height=Ht, num_frames=N_FRAMES)
    t_render = time.perf_counter()
    frames_t = device_frames(torch, np, dev, scene)
    log(f"synthetic scene: {N_FRAMES} frames {Wt}x{Ht} rendered and on the card in "
        f"{time.perf_counter() - t_render:.2f} s; object pixels per frame "
        f"{frames_t['count'].tolist()}")

    def new_state():
        module = init_weights_(build_backbone(net_cfg), torch.Generator().manual_seed(SEED))
        return create_train_state(module, tc, device="cuda")

    state = new_state()
    initial = {k: v.detach().clone() for k, v in state.module.state_dict().items()}
    step = make_train_step(tc, loss_cfg, asm_cfg, Wt)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pair_rng = np.random.default_rng(SEED)
    batches = [pair_batch(torch, frames_t, *draw_pairs(np, pair_rng, Bt, N_FRAMES))
               for _ in range(TRAIN_STEPS)]
    ph.forward_launches = ph.backward_launches = 0
    history = [{k: float(v) for k, v in step(state, b, gen).items()} for b in batches]
    torch.cuda.synchronize()
    k1_launches, k2_launches = ph.forward_launches, ph.backward_launches
    for i, m in enumerate(history):
        log(f"train step {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in m.items()))
    if not all(np.isfinite(v) for m in history for v in m.values()):
        fail("a training metric is not finite")
    still = [k for k, v in state.module.named_parameters()
             if v.dim() > 1 and torch.equal(v.detach(), initial[k])]
    log(f"training: {net_cfg['backbone']['resnet_name']} D={net_cfg['descriptor_dimension']} "
        f"{Wt}x{Ht} B={Bt}, {TRAIN_STEPS} steps through "
        f"make_train_step; weight tensors unchanged: {len(still)}; launches K1 "
        f"{k1_launches}, K2 {k2_launches} (2 per step expected)")
    if still:
        fail(f"training left weights unchanged: {still[:5]}")
    if k1_launches != 2 * TRAIN_STEPS or k2_launches != 2 * TRAIN_STEPS:
        fail(f"K1/K2 launched {k1_launches}/{k2_launches} times in {TRAIN_STEPS} steps, "
             f"not 2 per step each")

    # one step with the kernels and one with the plain hinge, same batch and weights
    from pdc_tpu_torch.ops.pooled_hinge import pooled_hinge_reference
    assembled = step.assemble(state, pair_batch(torch, frames_t, *draw_pairs(
        np, pair_rng, Bt, N_FRAMES)), torch.Generator(device=dev).manual_seed(SEED + 1))
    s_kernel, s_plain = new_state(), new_state()
    m_kernel = step.update(s_kernel, *assembled)
    m_plain = make_train_step(tc, loss_cfg, asm_cfg, Wt,
                              hinge=pooled_hinge_reference).update(s_plain, *assembled)
    lr = tc["training"]["learning_rate"]
    num = den = 0.0
    close = total = 0
    param_max = 0.0
    plain_params = dict(s_plain.module.named_parameters())
    for name, p in s_kernel.module.named_parameters():
        q = plain_params[name]
        num += float(((p.grad - q.grad) ** 2).sum())
        den += float((q.grad ** 2).sum())
        d = (p.detach() - q.detach()).abs()
        param_max = max(param_max, float(d.max()))
        sig = q.grad.abs() > 1e-3 * float(q.grad.abs().max())
        close += int((d[sig] <= 1e-2 * lr).sum())
        total += int(sig.sum())
    grad_rel = (num / den) ** 0.5
    loss_k, loss_p = float(m_kernel["loss"]), float(m_plain["loss"])
    log(f"train step, kernels vs plain hinge: loss {loss_k:.8g} vs {loss_p:.8g}, gradient "
        f"relative L2 {grad_rel:.3g}, parameters max|diff| {param_max:.3g} (lr {lr}), "
        f"{close}/{total} significant elements within 1e-2 lr")
    if abs(loss_k - loss_p) > STEP_LOSS_RTOL * abs(loss_p) or grad_rel > STEP_GRAD_RTOL \
            or param_max > 2 * lr * (1 + 1e-3) or close < STEP_PARAM_SHARE * total:
        fail("the train step with the kernels disagrees with the plain-hinge step")
    del s_kernel, s_plain, plain_params
    torch.cuda.empty_cache()
    phase("training", t0)

    # 7. the main path, the training driver -------------------------------------
    t0 = time.perf_counter()
    driver = check_training_driver(torch, np, dev, here, bm, ph)
    torch.cuda.empty_cache()
    phase("training driver", t0)

    # 8. the main path from disk: python -m pdc_tpu_torch train --------------------
    import shutil
    import tempfile
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    tree = tempfile.mkdtemp(prefix="chip_smoke_on_disk_", dir=os.path.join(here, "build"))
    try:
        t0 = time.perf_counter()
        on_disk = check_on_disk_training(torch, np, dev, bm, ph, tree)
        on_disk["phase_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        phase("on-disk training", t0)

        # 9. the main path's evaluation: python -m pdc_tpu_torch evaluate -------------
        t0 = time.perf_counter()
        evaluation = check_evaluation(torch, np, dev, here, bm, on_disk["folder"])
        evaluation["phase_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        phase("evaluation", t0)
    finally:
        shutil.rmtree(tree, ignore_errors=True)

    # 10. timings ---------------------------------------------------------------
    t0 = time.perf_counter()
    log(smi)
    # Kernel times are device times (time_device: the queue primed before
    # the start event); "wrapper" is the host-paced time of one Python call
    # from an idle queue (time_cuda), what a caller waits for one call.
    empty_ms = time_device(torch, lambda: torch.cuda._sleep(0), iters=50)
    log(f"an empty kernel's launch (torch.cuda._sleep(0)), back to back: {empty_ms:.5f} ms "
        f"device time per launch")
    res1 = images[:1].contiguous()
    entry = None
    for B, Q in ((1, 16), (8, 16), (1, 1024)):
        res = images[:B].contiguous()
        q = torch.stack([image_queries((b + 1) % N_FRAMES, Q // 2, Q - Q // 2, b)
                         for b in range(B)])
        k_ms = time_device(torch, lambda: bm.best_match(res, q))
        w_ms = time_cuda(torch, lambda: bm.best_match(res, q))
        p_ms = time_device(torch, lambda: bm.best_match_reference(res, q), iters=5)
        split = profile_split(torch, lambda: bm.best_match(res, q))
        lib_ms = None
        if B == 1:
            flat, q0 = res1[0].t(), q[0]

            def library():
                dmat = torch.cdist(flat, q0)  # [HW, Q]
                i = dmat.argmin(dim=0)
                return i, dmat.gather(0, i[None])
            lib_ms = time_device(torch, library, iters=5)
        b_ms, b_by = bound(B, Q, D, H * W)
        slices, groups, per_group, steps = bm.plan(B, D, H * W, Q, dev)
        log(f"best_match B={B} Q={Q} grid {slices} slices of {steps} x 1024 pixels x {groups} "
            f"groups of {per_group} queries x {B} images = {slices * groups * B} blocks of 256 "
            f"threads")
        log(f"best_match B={B} Q={Q} 640x480 D=3: kernel device {k_ms:.5f} ms, wrapper "
            f"{w_ms:.5f} ms per call, plain {p_ms:.4f} ms, cdist+argmin "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} (device), bound {b_ms:.5f} ms "
            f"({b_by}), kernel at {100 * b_ms / k_ms:.1f}% of bound; {split_text(split)}")
        if (B, Q) == (1, 16):
            entry = {"name": "best_match", "route": "cuda",
                     "source": "pdc_tpu_torch/csrc/best_match.cu",
                     "replaces": "pdc_tpu/ops/pallas_kernels.py:30",
                     "launches": launches,
                     "launches_by_path": {"serving": launches,
                                          "evaluation": evaluation["launches"]},
                     "max_abs_err": max(max_abs_err, driver["k3_err"], on_disk["k3_err"],
                                        evaluation["k3_err"]),
                     "ms": k_ms, "device_ms": k_ms, "wrapper_ms": w_ms, "plain_ms": p_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                     "empty_launch_ms": empty_ms,
                     "evaluation_shape": {k: v for k, v in evaluation["k3"].items()
                                          if k != "split"}}
    with torch.inference_mode():
        for B in (1, 8):
            xb = x[:B].contiguous()
            ms = time_cuda(torch, lambda: dcn.module(xb), iters=10)
            log(f"forward ResNet-34-8s fp32 B={B} 640x480: {ms:.3f} ms, {1e3 * B / ms:.1f} images/s")
    log(f"serving request latency (client wall clock, max_wait_ms 20): {len(lat)} requests "
        f"from {N_CLIENTS} concurrent clients, mean {1e3 * sum(lat) / len(lat):.2f} ms; "
        + "; ".join(f"one client alone, {op} mean {1e3 * sum(v) / len(v):.2f} ms"
                    for op, v in seq.items()))
    # one dispatch of the server (host clock, ends in the device->host copy)
    server = DescriptorServer(dcn, host="127.0.0.1", port=0, max_batch=8)
    try:
        for n, with_q in ((1, True), (8, True), (1, False), (8, False)):
            times = []
            for _ in range(5):
                batch = [_Request(frames[i], plan[1][1] if with_q else None) for i in range(n)]
                t = time.perf_counter()
                server._run_batch(batch)
                times.append(time.perf_counter() - t)
                if any(r.error for r in batch):
                    fail(f"dispatch failed: {batch[0].error}")
            log(f"server dispatch of {n} {'best_match' if with_q else 'descriptors'} "
                f"request(s): median {1e3 * sorted(times)[2]:.2f} ms")
    finally:
        server.shutdown()

    # training step: the whole step, then its parts, each between CUDA events
    def events(n):
        return [torch.cuda.Event(enable_timing=True) for _ in range(n)]

    step_ms, wall = [], []
    for _ in range(TRAIN_TIMED_STEPS):
        batch = pair_batch(torch, frames_t, *draw_pairs(np, pair_rng, Bt, N_FRAMES))
        e = events(2)
        t = time.perf_counter()
        e[0].record()
        step(state, batch, gen)
        e[1].record()
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t))
        step_ms.append(e[0].elapsed_time(e[1]))
    parts = {"assembly": [], "forward+backward": [], "optimizer": []}
    captured = []

    def capture(*args):
        captured.append([a.detach() for a in args[:8]])
        return ph.pooled_hinge(*args)

    loss_fn = build_loss_fn(state.module, loss_cfg, Wt, hinge=capture)
    for _ in range(TRAIN_TIMED_STEPS):
        batch = pair_batch(torch, frames_t, *draw_pairs(np, pair_rng, Bt, N_FRAMES))
        e = events(4)
        e[0].record()
        assembled = step.assemble(state, batch, gen)
        e[1].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss, _ = loss_fn(*assembled)
        loss.backward()
        e[2].record()
        state.optimizer.step()
        e[3].record()
        torch.cuda.synchronize()
        for k, (a, b) in zip(parts, ((0, 1), (1, 2), (2, 3))):
            parts[k].append(e[a].elapsed_time(e[b]))
    mean_step = sum(step_ms) / len(step_ms)
    log(smi)
    log(f"train step {net_cfg['backbone']['resnet_name']} fp32 {Wt}x{Ht} B={Bt} (CUDA events, "
        f"{TRAIN_TIMED_STEPS} steps after {TRAIN_STEPS + 1} warm-up): {mean_step:.3f} ms "
        f"[{', '.join(f'{x:.3f}' for x in step_ms)}], {1e3 * Bt / mean_step:.2f} pairs/s; "
        f"host wall clock {sum(wall) / len(wall):.3f} ms")
    split = {k: sum(v) / len(v) for k, v in parts.items()}
    log("train step split (separate steps, CUDA events): " + ", ".join(
        f"{k} {v:.3f} ms ({100 * v / sum(split.values()):.1f}%)" for k, v in split.items()))
    # the driver's steps on each route, host clock, against make_train_step's
    log(f"training driver, device sampler, {len(driver['step_ms'])} iterations: host ms per "
        f"step call (no synchronisation; the queue fills) "
        f"[{', '.join(f'{x:.1f}' for x in driver['step_ms'])}], whole run {driver['run_s']:.2f} s; "
        f"checkpoint writes (.ckpt {driver['sizes']['000006.ckpt'] / 1e6:.1f} MB + .ckpt.opt "
        f"{driver['sizes']['000006.ckpt.opt'] / 1e6:.1f} MB + the yaml files) "
        f"[{', '.join(f'{x:.0f}' for x in driver['save_ms'])}] ms")
    disk_ms, drv_ms = on_disk["step_ms"], driver["step_ms"]
    log(f"on-disk training ({on_disk['route']!r}, decoder {on_disk['decoder']}): host ms per "
        f"step call [{', '.join(f'{x:.1f}' for x in disk_ms)}], steps 2-{len(disk_ms)} mean "
        f"{sum(disk_ms[1:]) / len(disk_ms[1:]):.1f} ms against the training driver's "
        f"{sum(drv_ms[1:]) / len(drv_ms[1:]):.1f} ms on the in-memory dataset; whole run "
        f"{on_disk['run_s']:.2f} s against {driver['run_s']:.2f} s; tree written in "
        f"{on_disk['write_s']:.2f} s and read back in {on_disk['read_s']:.2f} s; phase "
        f"{on_disk['phase_s']:.2f} s")
    for dec, c in on_disk["codec"].items():
        log(f"PNG codec {dec}, ms per 640x480 frame (RGB + depth + mask): write "
            f"{c['write_ms']:.2f}, decode {c['decode_ms']:.2f} (one frame alone); write "
            f"{c['write_ms_batched']:.2f}, decode {c['decode_ms_batched']:.2f} (12 frames in "
            f"one call); an RGB file of Paeth rows alone: decode {c['paeth_rgb_decode_ms']:.2f}")
    k3e, tot = evaluation["k3"], evaluation["totals"]
    log(f"best_match at the evaluation sweep's shape B={k3e['B']} Q={k3e['Q']} HW={k3e['HW']} "
        f"D=3: kernel device {k3e['ms']:.5f} ms, wrapper {k3e['wrapper_ms']:.5f} ms per call, "
        f"plain {k3e['plain_ms']:.4f} ms, cdist+argmin {k3e['library_ms']:.4f} ms (device), "
        f"bound {k3e['bound_ms']:.5f} ms ({k3e['bound_by']}), kernel at "
        f"{100 * k3e['bound_ms'] / k3e['ms']:.1f}% of bound; {split_text(k3e['split'])}")
    sweep_parts = ("forwards", "correspondences", "statistics")
    log(f"evaluation (python -m pdc_tpu_torch evaluate, {EVAL_PAIRS} pairs x {EVAL_MATCHES} "
        f"matches in each split; pairs kept {evaluation['pairs']}, rows {evaluation['rows']}): "
        f"command {evaluation['run_s']:.2f} s; the two sweeps {tot['sweep']:.3f} s, of which "
        + ", ".join(f"{k} {tot.get(k, 0.0):.3f} s" for k in sweep_parts)
        + f" (host clock, synchronised at each part), rest "
        f"{tot['sweep'] - sum(tot.get(k, 0.0) for k in sweep_parts):.3f} s; descriptor "
        f"statistics {tot.get('descriptor statistics', 0.0):.3f} s, across objects "
        f"{tot.get('across objects', 0.0):.3f} s; K3 launches {evaluation['launches']}; phase "
        f"{evaluation['phase_s']:.2f} s")
    for route, r in driver["routes"].items():
        mean_route = sum(r["step_ms"]) / len(r["step_ms"])
        log(f"training driver route {route!r}, {ROUTE_STEPS} iterations: host wall clock per "
            f"step (synchronised, steps 2-{ROUTE_STEPS}) "
            f"[{', '.join(f'{x:.2f}' for x in r['step_ms'])}] ms, mean {mean_route:.2f} ms = "
            f"{mean_route / mean_step:.3f} x make_train_step's {mean_step:.3f} ms of CUDA-event "
            f"step time; K1/K2 launches {r['launches']}")

    # K1 and K2 at the main path's shapes: the masked pool's rows of a real step
    hargs = [a.contiguous() for a in captured[0]]
    g_one = torch.ones(hargs[0].shape[0], device=dev)
    def k1():
        return ph._forward_kernel(*hargs, 0.5, False, 50.0)

    def k2():
        return ph._backward_kernel(g_one, *hargs, 0.5, False, 50.0)

    k1_ms, k1_wrapper = time_device(torch, k1), time_cuda(torch, k1)
    k2_ms, k2_wrapper = time_device(torch, k2), time_cuda(torch, k2)
    k1_split, k2_split = profile_split(torch, k1), profile_split(torch, k2)
    Bk, Nk, Dk = hargs[0].shape
    Pk = hargs[1].shape[1]
    k1_blocks = ph._library().pdc_pooled_hinge_fwd_partials(Bk, Nk, Dk)
    k2_blocks = ph._library().pdc_pooled_hinge_bwd_partials(Bk, Nk, Pk, Dk) // (Dk * Pk)
    log(f"K1 grid {k1_blocks} blocks ({k1_blocks // Bk} per pair), K2 grid {k2_blocks} blocks "
        f"({k2_blocks // Bk} per pair), 256 threads each, on "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    with torch.no_grad():
        p1_ms = time_device(torch, lambda: ph.pooled_hinge_reference(*hargs, 0.5, False, 50.0),
                            iters=5)
        p2_ms = time_device(torch, lambda: ph.pooled_hinge_backward_reference(
            g_one, *hargs, 0.5, False, 50.0), iters=5)
        cdist_ms = time_device(torch, lambda: torch.cdist(hargs[0], hargs[1]), iters=5)
    b1_ms, b1_by, sq1 = hinge_bound(hargs, False, backward=False)
    b2_ms, b2_by, sq2 = hinge_bound(hargs, False, backward=True)
    hard = int(ph.pooled_hinge_reference(*hargs, 0.5, False, 50.0)[1].sum())
    log(f"pooled hinge at the main path's shapes {tuple(hargs[0].shape)} x "
        f"{tuple(hargs[1].shape)} ({hard} hard negatives), device times: K1 {k1_ms:.5f} ms "
        f"(wrapper {k1_wrapper:.5f} ms per call), plain {p1_ms:.4f} ms, bound {b1_ms:.5f} ms "
        f"({b1_by}), at {100 * b1_ms / k1_ms:.1f}% of bound; K2 {k2_ms:.5f} ms (wrapper "
        f"{k2_wrapper:.5f} ms per call), plain {p2_ms:.4f} ms, bound {b2_ms:.5f} ms ({b2_by}), "
        f"at {100 * b2_ms / k2_ms:.1f}% of bound")
    log(f"K1 {split_text(k1_split)}")
    log(f"K2 {split_text(k2_split)}")
    # the walk without its counted path: with M = 0 no pair passes d2 < T
    k1_walk = time_device(torch, lambda: ph._forward_kernel(*hargs, 0.0, False, 50.0))
    k2_walk = time_device(torch, lambda: ph._backward_kernel(g_one, *hargs, 0.0, False, 50.0))
    log(f"the same inputs with M = 0 (no pair passes the distance test, so no counted path): "
        f"K1 {k1_walk:.5f} ms, K2 {k2_walk:.5f} ms of device time")
    log(f"pooled hinge sqrt count: K1 {sq1} ({1e3 * sq1 / PEAK_SFU_S:.5f} ms at the SFU rate), "
        f"K2 {sq2} ({1e3 * sq2 / PEAK_SFU_S:.5f} ms); no single PyTorch call computes the "
        f"pooled hinge (library: none); torch.cdist of the same rows, the distance part "
        f"alone: {cdist_ms:.4f} ms")
    log(f"K1+K2 share of a train step: 2 x ({k1_ms:.4f} + {k2_ms:.4f}) ms = "
        f"{100 * 2 * (k1_ms + k2_ms) / mean_step:.2f}% of {mean_step:.3f} ms")
    k1_entry = {"name": "pooled_hinge_fwd", "route": "cuda",
                "source": "pdc_tpu_torch/csrc/pooled_hinge.cu",
                "replaces": "pdc_tpu/ops/pallas_loss.py:42", "launches": k1_launches,
                "launches_by_path": {"training": k1_launches, "training driver": driver["k1"],
                                     "on-disk training": on_disk["k1"]},
                "max_abs_err": k1_err, "ms": k1_ms, "device_ms": k1_ms,
                "wrapper_ms": k1_wrapper, "plain_ms": p1_ms, "bound_ms": b1_ms,
                "bound_by": b1_by, "library_ms": None}
    k2_entry = {"name": "pooled_hinge_bwd", "route": "cuda",
                "source": "pdc_tpu_torch/csrc/pooled_hinge.cu",
                "replaces": "pdc_tpu/ops/pallas_loss.py:77", "launches": k2_launches,
                "launches_by_path": {"training": k2_launches, "training driver": driver["k2"],
                                     "on-disk training": on_disk["k2"]},
                "max_abs_err": k2_err, "ms": k2_ms, "device_ms": k2_ms,
                "wrapper_ms": k2_wrapper, "plain_ms": p2_ms, "bound_ms": b2_ms,
                "bound_by": b2_by, "library_ms": None}
    phase("timings", t0)

    faulthandler.cancel_dump_traceback_later()
    log(json.dumps({"kernels": [entry, k1_entry, k2_entry]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    sys.stdout.flush()
    sys.stderr.flush()
    # every thread this script started has ended; skip interpreter teardown
    # so that nothing left in CUDA or socket finalizers can hold up the exit
    os._exit(0)


if __name__ == "__main__":
    main()
