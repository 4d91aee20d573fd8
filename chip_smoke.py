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
     float64 distances, on random shapes and on real 640x480 descriptor
     images of the network;
  4. the main path: a ``DescriptorServer`` with ResNet-34-8s, D=3, 640x480,
     seeded random weights, answering concurrent ``descriptors`` and
     ``best_match`` requests from several client threads; its answers are
     checked against ``forward_on_img`` and the plain best match, and the
     kernel's launch count must show that serving went through it;
  5. timings (CUDA events, after warm-up): kernel, plain version and
     ``torch.cdist`` + ``argmin`` with the kernel's bound, forward images/s.

The last lines are a JSON object with the kernel's numbers, the nvidia-smi
line, and ``{"ok": true, "device": {...}}``. Without CUDA, or when the
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
    """Milliseconds per call, from CUDA events around ``iters`` calls."""
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

    # 4. the main path: serving -------------------------------------------------
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

    # 5. timings ---------------------------------------------------------------
    t0 = time.perf_counter()
    log(smi)
    res1 = images[:1].contiguous()
    entry = None
    for B, Q in ((1, 16), (8, 16), (1, 1024)):
        res = images[:B].contiguous()
        q = torch.stack([image_queries((b + 1) % N_FRAMES, Q // 2, Q - Q // 2, b)
                         for b in range(B)])
        k_ms = time_cuda(torch, lambda: bm.best_match(res, q))
        p_ms = time_cuda(torch, lambda: bm.best_match_reference(res, q), iters=5)
        lib_ms = None
        if B == 1:
            flat, q0 = res1[0].t(), q[0]

            def library():
                dmat = torch.cdist(flat, q0)  # [HW, Q]
                i = dmat.argmin(dim=0)
                return i, dmat.gather(0, i[None])
            lib_ms = time_cuda(torch, library, iters=5)
        b_ms, b_by = bound(B, Q, D, H * W)
        log(f"best_match B={B} Q={Q} 640x480 D=3: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"cdist+argmin {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
            f"bound {b_ms:.5f} ms ({b_by}), kernel at {100 * b_ms / k_ms:.1f}% of bound")
        if (B, Q) == (1, 16):
            entry = {"name": "best_match", "route": "cuda",
                     "source": "pdc_tpu_torch/csrc/best_match.cu",
                     "replaces": "pdc_tpu/ops/pallas_kernels.py:30",
                     "launches": launches, "max_abs_err": max_abs_err,
                     "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms}
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
    phase("timings", t0)

    faulthandler.cancel_dump_traceback_later()
    log(json.dumps({"kernels": [entry]}))
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
