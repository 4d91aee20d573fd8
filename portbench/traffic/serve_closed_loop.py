"""Traffic ``serve_closed_loop``: the port's descriptor server
(``DescriptorServer``) over TCP, driven by clients that each wait for their
reply before sending the next request.

Set-up makes the weights and ``frames`` synthetic frames from the seed on
the device, builds the network, starts the server in this process (so
the run reads its ``stats``) and the clients in one child process (a
robot is a process of its own; the clients hold no lock of the server's
interpreter). The server warms up its batch buckets when more than one
client can fill a batch; then every client sends ``warmup_requests``
requests. Then the window: for ``--seconds`` the clients send requests in
a closed loop, client ``i``'s ``j``-th request on frame ``(i + j *
clients) % frames``, a ``descriptors`` or a ``best_match`` request (with
``queries`` query descriptors drawn from the seed) as the cell's mix
says. Each request is timed in its client around ``DescriptorClient``'s
call (the frame sent, the whole reply read). A request sent in the window
is waited for, up to a minute past its end.

Correctness, after the window, the server shut down and freed: the plain
reference (:mod:`portbench.reference.descriptors`) computes each frame's
descriptors from the same weights, and every ``best_match`` answer sent in
the window, with a sample drawn from the seed of the ``descriptors``
answers, is held against them: the served pixel's distance above the best
one's (``match_gap``), the served distance against the reference's at
that pixel (``dist_err``), both over the frame's descriptor RMS, and the
served descriptors' largest error over their largest magnitude
(``desc_err``). A request that fails counts in ``failed_requests``, whose
limit is 0.
"""

from __future__ import annotations

import gc
import math
import multiprocessing
import os
import threading
import time

import numpy as np
import torch

from portbench import harness
from portbench.reference.descriptors import check_answers, descriptor_images
from portbench.reference.resnet import ResNetFCN
from portbench.scenes import make_scenes
from portbench.seeds import numpy_rng
from portbench.weights import make_weights

WAIT_AFTER_S = 60.0  # how long a request sent in the window is waited for


def inputs(ctx, weights):
    """``(frames [n, H, W, 3] uint8, queries [sets, Q, D] float32)`` on the
    host: the first ``frames`` frames of the cell's scenes (only the scenes
    that hold them are rendered), and query descriptors as a robot takes
    them from a reference view: the plain reference's descriptors at object
    pixels, drawn from the seed, of the next frame, which is not served."""
    p = ctx.params
    n = int(p["frames"])
    spec = ctx.config["scenes"]
    needed = -(-(n + 1) // int(spec["frames_per_scene"]))
    scenes = make_scenes(ctx.seed, dict(spec, num_scenes=min(needed, int(spec["num_scenes"]))),
                         ctx.device)
    net = ctx.config["dense_correspondence_network"]
    model = ResNetFCN(net["backbone"]["resnet_name"], net["descriptor_dimension"])
    model = model.to(ctx.device).eval()
    model.load_state_dict(weights)
    view = descriptor_images(model, scenes.rgb[n:n + 1])[0]
    pixels = torch.nonzero(scenes.mask[n]).cpu().numpy()
    rng = numpy_rng(ctx.seed, "queries")
    pick = pixels[rng.integers(len(pixels), size=(int(p["query_sets"]), int(p["queries"])))]
    queries = view[pick[..., 0], pick[..., 1]].cpu().numpy().astype(np.float32)
    return scenes.rgb[:n].cpu().numpy(), queries


def plan(params: dict, client: int, j: int):
    """Client ``client``'s ``j``-th request: ``(op, frame, query set)``."""
    n = int(params["clients"])
    frame = (client + j * n) % int(params["frames"])
    share = float(params["best_match_share"])
    # an even split alternates within each client; all or none is constant
    if share >= 1.0:
        op = "best_match"
    elif share <= 0.0:
        op = "descriptors"
    else:
        op = "best_match" if (client + j) % round(1.0 / share) == 0 else "descriptors"
    return op, frame, (client + j * n) % int(params["query_sets"])


# -- the client process ------------------------------------------------------------------

def client_process(conn, params: dict, seed: int):
    """The clients, in a process of their own: wait for the server's
    address, the frames and the queries, connect, warm up, report ready,
    wait for the window's start and end, run the closed loop, and send back
    every request's record and the sampled answers."""
    from pdc_tpu_torch.apps.serve import DescriptorClient

    n = int(params["clients"])
    torch.set_num_threads(1)
    address, frames, queries = conn.recv()
    clients = [DescriptorClient(*address) for _ in range(n)]
    try:
        def call(c, op, frame, qs):
            if op == "best_match":
                return c.best_match(frames[frame], queries[qs])
            return c.descriptors(frames[frame])

        for i, c in enumerate(clients):
            for j in range(int(params["warmup_requests"])):
                call(c, *plan(params, i, j))
        gc.freeze()  # the load generator's own heap stays out of its collections
        conn.send("ready")
        t0, t1 = conn.recv()
        per_client = max(1, int(params["checked_descriptors"]) // n)
        records = [[] for _ in range(n)]
        kept = [[] for _ in range(n)]

        def loop(i):
            rng = numpy_rng(seed, f"sample.{i}")
            c, j, seen = clients[i], 0, 0
            while time.monotonic() < t0:
                time.sleep(0.0005)
            while True:
                start = time.monotonic()
                if start >= t1:
                    break
                op, frame, qs = plan(params, i, j)
                try:
                    out, error = call(c, op, frame, qs), None
                except (OSError, RuntimeError, ValueError) as e:
                    out, error = None, f"{type(e).__name__}: {e}"
                stop = time.monotonic()
                rec = {"client": i, "j": j, "op": op, "frame": frame, "query_set": qs,
                       "sent": start, "done": stop, "error": error}
                if error is None and op == "best_match":
                    rec["uv"], rec["dist"] = out[0].copy(), out[1].copy()
                elif error is None:  # reservoir sample of the descriptor answers
                    seen += 1
                    slot = seen - 1 if seen <= per_client else int(rng.integers(seen))
                    if slot < per_client:
                        answer = (i, j, frame, out.copy())
                        if slot < len(kept[i]):
                            kept[i][slot] = answer
                        else:
                            kept[i].append(answer)
                records[i].append(rec)
                j += 1

        threads = [threading.Thread(target=loop, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(t1 - time.monotonic() + WAIT_AFTER_S)
        conn.send({"records": [r for rs in records for r in rs],
                   "descriptors": [a for ks in kept for a in ks],
                   "unfinished": sum(t.is_alive() for t in threads)})
    finally:
        for c in clients:
            c.close()


# -- the run -----------------------------------------------------------------------------

def receive(conn, proc, timeout: float):
    """The client process's next message, or an error once it has ended or
    ``timeout`` seconds have passed."""
    deadline = time.monotonic() + timeout
    while not conn.poll(0.2):
        if not proc.is_alive():
            raise harness.BenchmarkError(f"the client process ended (code {proc.exitcode})")
        if time.monotonic() > deadline:
            raise harness.BenchmarkError("the client process sent nothing in time")
    return conn.recv()


def build_server(ctx, weights, net):
    from pdc_tpu_torch.apps.serve import DescriptorServer
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork, build_backbone

    with torch.device(ctx.device):
        module = build_backbone(net)
    module.load_state_dict(weights)
    dcn = DenseCorrespondenceNetwork(module, net["descriptor_dimension"], net["image_width"],
                                     net["image_height"], device=ctx.device)
    s = ctx.config["serving"]
    return DescriptorServer(dcn, max_batch=int(s["max_batch"]),
                            max_wait_ms=float(s["max_wait_ms"]),
                            max_queries=int(s["max_queries"]))


def window_stats(records, t0: float, t1: float, seconds: float) -> dict:
    """The end-to-end numbers of the client records: requests answered in
    ``[t0, t1]`` over ``seconds``, the 95th percentile of the latency of
    every request sent in the window (linear between order statistics),
    and the counts."""
    sent = [r for r in records if t0 <= r["sent"] < t1]
    ok = [r for r in sent if r["error"] is None]
    answered = [r for r in ok if r["done"] <= t1]
    lat_ms = np.array([(r["done"] - r["sent"]) * 1e3 for r in ok])
    return {"serve_frames_per_s": len(answered) / seconds,
            "serve_p95_ms": float(np.percentile(lat_ms, 95)) if len(lat_ms) else math.inf,
            "attempted": len(sent), "failed": len(sent) - len(ok)}


def run(ctx) -> dict:
    net = ctx.config["dense_correspondence_network"]
    p = ctx.params
    D = int(net["descriptor_dimension"])
    # the clients' process starts first, its imports overlapping the set-up
    # here; a load generator of few threads (no intra-op pool of its own)
    mp = multiprocessing.get_context("spawn")
    parent, child = mp.Pipe()
    proc = mp.Process(target=client_process, args=(child, dict(p), ctx.seed))
    omp = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        proc.start()
    finally:
        if omp is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = omp
    server = None
    try:
        weights = make_weights(net["backbone"]["resnet_name"], D, ctx.seed, ctx.device)
        frames, queries = inputs(ctx, weights)
        ctx.phase("frames, queries and weights made")
        server = build_server(ctx, weights, net)
        del weights
        server.start()
        if int(p["clients"]) > 1:
            server.warmup()
        ctx.phase("server built and warmed up")
        parent.send((server.address, frames, queries))
        if receive(parent, proc, 600) != "ready":
            raise harness.BenchmarkError("the clients did not warm up")
        ctx.phase("clients connected and warmed up")
        before = dict(server.stats)
        ctx.open_window()
        t0 = time.monotonic() + 0.01
        t1 = t0 + ctx.seconds
        parent.send((t0, t1))
        time.sleep(max(0.0, t1 - time.monotonic()))
        after = dict(server.stats)
        ctx.close_window()
        out = receive(parent, proc, WAIT_AFTER_S + 60)
        proc.join(60)
    finally:
        if server is not None:
            server.shutdown()
        if proc.is_alive():
            proc.kill()
        proc.join(10)
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    server = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    records = out["records"]
    stats = window_stats(records, t0, t1, ctx.seconds)
    numbers = reference_numbers(ctx, frames, queries, records, out["descriptors"])
    numbers["failed_requests"] = stats["failed"] + out["unfinished"]
    checks = harness.checks_of(numbers, ctx.limits)
    delta = {k: after[k] - before[k] for k in after}
    return {
        "correct": harness.judge(checks),
        "attempted": stats["attempted"],
        "failed": stats["failed"],
        "end_to_end": {k: stats[k] for k in ("serve_frames_per_s", "serve_p95_ms")},
        "device": harness.device_facts(ctx.device, peak),
        "checks": checks,
        "server_stats": delta,
        "window_seconds": ctx.seconds,
        "queries": int(ctx.config["serving"]["max_queries"]),
        "answers": (frames, queries, records, out["descriptors"]),
    }


def reference_numbers(ctx, frames, queries, records, descriptors, tf32: bool = False) -> dict:
    """The compared numbers of the answers (see the module docstring), from
    the plain reference's descriptors of every frame."""
    net = ctx.config["dense_correspondence_network"]
    name, D = net["backbone"]["resnet_name"], int(net["descriptor_dimension"])
    model = ResNetFCN(name, D).to(ctx.device).eval()
    model.load_state_dict(make_weights(name, D, ctx.seed, ctx.device))
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        ref = descriptor_images(model, torch.as_tensor(frames, device=ctx.device))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    matches = [(r["frame"], queries[r["query_set"]], r["uv"], r["dist"]) for r in records
               if r["error"] is None and r["op"] == "best_match"]
    served = [(frame, desc) for _, _, frame, desc in descriptors]
    return check_answers(ref, matches, served)
