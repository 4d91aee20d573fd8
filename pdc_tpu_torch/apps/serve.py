"""Descriptor-serving daemon: ``python -m pdc_tpu_torch serve``.

Port of :mod:`pdc_tpu.apps.serve` (:69-718): one daemon owns the network on
the card and serves descriptor images and best-match queries to any number
of clients over TCP, with cross-request microbatching.

- One batched step per dispatch: uint8 frames -> mean/std normalize ->
  backbone -> float32 ``[B, D, H, W]`` descriptors, then ONE launch of the
  best-match kernel (:func:`pdc_tpu_torch.ops.best_match.best_match`)
  answers every request's queries in the batch, straight from the NCHW
  output (channel-planar, as the kernel takes it). Invalid query slots
  answer ``dist = inf``.
- Batches are padded to power-of-two buckets up to ``max_batch``, as in
  ``pdc_tpu``; a single batcher thread coalesces up to ``max_batch`` frames
  or ``max_wait_ms`` of arrivals into one dispatch. A connection has at
  most one request in flight, so the batcher closes a batch at once when
  nothing is queued and every open connection's frame is already in it:
  ``max_wait_ms`` bounds the wait only while another connection could
  still send.
- Like the JAX server, the served descriptors skip the network's
  ``normalize`` option (``pdc_tpu/apps/serve.py:239-242``).
- A dispatch queues all of its device work (the forward, the best match,
  the gathered descriptors made contiguous, the ``uv``/``dist``
  arithmetic), waits on one CUDA event, and only then copies the answers
  to the host, so the wait for the card is told apart from the copies.
  The descriptors arrive C-contiguous, so a reply is encoded without a
  transposition on the host.

- Tracing: ``stats`` counts requests, dispatches, frames and the
  dispatches closed early by the rule above (``closed_early``), and sums the
  seconds of the batcher's phases (``starved_s``, ``gather_s``,
  ``upload_s``, ``device_wait_s``, ``download_s``, ``batcher_host_s``:
  together its wall time) and of the handlers' work on frame requests
  (``queue_wait_s``, ``handler_s``); ``info`` returns them. Each phase is
  also a ``record_function`` range (``serve.*``) while a profiler runs,
  and nothing at all otherwise. The ranges of the batcher and handler
  threads reach a trace only from a profiler that records every thread
  (``_ExperimentalConfig(profile_all_threads=True)``), as
  ``portbench/alltrace.py`` runs a benchmark cell.

- int8 serving plugs in unchanged: ``--int8`` serves ``dcn.quantized()``
  (dynamic scales: a frame's descriptors vary slightly with the rest of its
  batch), ``--int8_static`` a clone calibrated on the first 16 frames of
  the first scene of the folder's training dataset (deterministic per
  frame; ``pdc_tpu/apps/serve.py:28-34`` recommends it for a daemon).

- Data parallelism (``devices=[...]``, ``--data_parallel``): one replica of
  the network per device; batch buckets become multiples of the replica
  count, each replica forwards (and answers the queries of) its contiguous
  block of the coalesced batch, and the answers are put back in request
  order (``pdc_tpu/apps/serve.py:177-215`` shards the batch over a mesh's
  data axis). ``--data_parallel`` takes every local card.
- Tensor parallelism (``model_parallel=N``, ``--model_parallel N``): the
  replicas become groups of N devices, each holding one network whose
  convolutions are channel-sharded over its group in this process
  (:func:`~pdc_tpu_torch.parallel.tensor_parallel.shard_channels` with
  :class:`~pdc_tpu_torch.parallel.tensor_parallel.LocalChannels`: each
  device convolves its block of output channels on its own copy of the
  input, the blocks are concatenated on the group's first device, where
  the rest of the network runs), ``pdc_tpu/apps/serve.py:177-232``'s
  ``(data, model)`` mesh. The batch is split over the groups as above.
  ``--model_parallel`` takes every local card; int8 clones shard alike.

Wire protocol (one TCP connection serves many requests), unchanged:
  request  = JSON header line ending in ``\\n``, then the payload bytes.
             Header keys: ``op`` ("ping" | "info" | "descriptors" |
             "best_match"), ``shape`` [H, W, 3] (decoded frame dims),
             ``encoding`` ("raw" uint8 RGB, default | "jpeg" | "png", with
             ``payload_len``), ``response_dtype`` ("float32" default |
             "float16"), ``queries`` [[D floats], ...] (best_match only).
  response = JSON header line (``ok``, plus ``shape``/``dtype`` when a
             payload follows), then the payload bytes (little-endian
             descriptors, or int32 uv + float32 distances).
"""

from __future__ import annotations

import copy
import json
import math
import queue
import socket
import socketserver
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

from pdc_tpu_torch.apps import add_int8_flags, first_frames, quantize_arg, serving_clone
from pdc_tpu_torch.ops.best_match import best_match
from pdc_tpu_torch.parallel.tensor_parallel import LocalChannels, shard_channels

_JOIN_TIMEOUT_S = 10.0
# the batcher's phases, ``stats`` keys in seconds: together its wall time
_BATCHER_PHASES = ("starved_s", "gather_s", "upload_s", "device_wait_s", "download_s",
                   "batcher_host_s")
# each span of the batcher, and the phase its time is summed in
_PHASE_OF = {"serve.starved": "starved_s", "serve.gather": "gather_s",
             "serve.assemble": "batcher_host_s", "serve.upload": "upload_s",
             "serve.launch": "batcher_host_s", "serve.device_wait": "device_wait_s",
             "serve.download": "download_s", "serve.fanout": "batcher_host_s"}
# the handlers' seconds on frame requests, ``stats`` keys
_HANDLER_TIMES = ("queue_wait_s", "handler_s")
_NO_SPAN = nullcontext()


def _span(name: str):
    """A ``record_function`` range ``name`` while a profiler runs, on the
    profiler's timeline beside the device's kernels and copies; otherwise
    nothing, at the cost of reading one flag. (The flag is set process-wide
    by any ``torch.profiler`` run; ``torch.autograd._profiler_enabled()``
    reads False under one, on its own thread too.)"""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


class _DesyncError(ValueError):
    """Protocol framing is unrecoverable; close the connection."""


def encode_frame(rgb_u8: np.ndarray, encoding: str, quality: int = 90) -> bytes:
    """Compress an RGB uint8 frame for the wire ("jpeg" | "png"). cv2 when
    present, PIL otherwise."""
    try:
        import cv2

        ext = ".jpg" if encoding == "jpeg" else ".png"
        params = ([int(cv2.IMWRITE_JPEG_QUALITY), int(quality)]
                  if encoding == "jpeg" else [])
        ok, buf = cv2.imencode(ext, rgb_u8[:, :, ::-1], params)  # RGB->BGR
        if not ok:
            raise ValueError(f"cv2 {encoding} encode failed")
        return buf.tobytes()
    except ImportError:
        import io

        from PIL import Image

        bio = io.BytesIO()
        Image.fromarray(rgb_u8).save(
            bio, format="JPEG" if encoding == "jpeg" else "PNG",
            quality=int(quality))
        return bio.getvalue()


def encoded_image_dims(data: bytes):
    """(height, width) parsed from a PNG/JPEG header, or None if the bytes
    are not a recognizable image. Lets the server reject a crafted small
    payload that would DECODE to a multi-GB allocation before decoding."""
    if data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) >= 24:
        # 8-byte signature, 4-byte IHDR length + type, then W/H big-endian
        w = int.from_bytes(data[16:20], "big")
        h = int.from_bytes(data[20:24], "big")
        return h, w
    if data[:2] == b"\xff\xd8":
        # JPEG: walk marker segments to the first SOFn frame header
        sof = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7,
               0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}
        i = 2
        while i + 9 < len(data) and data[i] == 0xFF:
            marker = data[i + 1]
            if marker == 0xFF:  # 0xFF fill/padding byte before a marker
                i += 1
                continue
            if marker in sof:
                h = int.from_bytes(data[i + 5:i + 7], "big")
                w = int.from_bytes(data[i + 7:i + 9], "big")
                return h, w
            if marker == 0xD9:  # EOI before any SOF: no frame header
                break
            # standalone (zero-length) markers: SOI, TEM, RSTn
            if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
                i += 2
                continue
            i += 2 + int.from_bytes(data[i + 2:i + 4], "big")
    return None


def decode_frame(data: bytes, encoding: str) -> np.ndarray:
    """Inverse of :func:`encode_frame`: compressed bytes -> RGB uint8."""
    try:
        import cv2

        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError(f"cv2 {encoding} decode failed")
        return np.ascontiguousarray(img[:, :, ::-1])  # BGR->RGB
    except ImportError:
        import io

        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one (``cuda`` means the current card)."""
    def index(d):
        return d.index if d.index is not None or d.type != "cuda" else torch.cuda.current_device()
    return a.type == b.type and index(a) == index(b)


class _Request:
    """One frame request. ``t_read``, ``t_put``, ``t_taken``, ``t_answered``
    and ``t_sent`` are the ``time.perf_counter()`` readings of the start of
    its frame's read, its put on the queue, the batcher taking it, its
    answer being set and its reply being sent."""

    __slots__ = ("rgb", "queries", "via_connection", "event", "result", "error",
                 "t_read", "t_put", "t_taken", "t_answered", "t_sent")

    def __init__(self, rgb, queries=None, t_read=None, via_connection=False):
        self.rgb = rgb
        self.queries = queries  # [Q, D] float32 or None (descriptors op)
        # sent by a connection's handler, which waits for it before reading
        # that connection's next request
        self.via_connection = via_connection
        self.event = threading.Event()
        self.result = None  # (descriptors [H, W, D] or None, uv [Qmax, 2], dist [Qmax])
        self.error: Optional[str] = None
        self.t_read = t_read
        self.t_put = self.t_taken = self.t_answered = self.t_sent = None


class _Laps:
    """The batcher's seconds by phase, adding up to its wall time: the time
    inside a :meth:`phase` goes to its span's phase (``_PHASE_OF``), the
    time between phases to ``batcher_host_s``."""

    def __init__(self):
        self.seconds = dict.fromkeys(_BATCHER_PHASES, 0.0)
        self.last = time.perf_counter()  # the end of the last lap

    def _lap(self, phase: str):
        now = time.perf_counter()
        self.seconds[phase] += now - self.last
        self.last = now

    @contextmanager
    def phase(self, span: str):
        """Time the body as ``span``'s phase, inside the span ``span``."""
        self._lap("batcher_host_s")
        with _span(span):
            yield
        self._lap(_PHASE_OF[span])

    def take(self) -> dict:
        """The seconds since the last take."""
        out, self.seconds = self.seconds, dict.fromkeys(_BATCHER_PHASES, 0.0)
        return out


class DescriptorServer:
    """TCP descriptor server with cross-request microbatching.

    :param dcn: a :class:`pdc_tpu_torch.models.dcn.DenseCorrespondenceNetwork`;
        the server runs on its device and uses its module and normalization
        stats.
    :param max_batch: largest fused batch (power-of-two buckets below it).
    :param max_wait_ms: how long the batcher waits for more requests once
        one arrives, while another open connection could still send one; it
        bounds the added latency. A batch of requests from connections
        alone closes at once when every open connection's request is in it
        and none is queued.
    :param max_queries: per-request best-match query budget.
    :param devices: one replica of the network per device (data
        parallelism); None serves on the network's device alone.
    :param model_parallel: N channel-shards each replica over N of
        ``devices`` (the network's device when None): the replicas become
        groups of N; N must divide the number of devices.
    """

    def __init__(self, dcn, host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 8, max_wait_ms: float = 5.0,
                 max_queries: int = 16, devices=None, model_parallel: Optional[int] = None):
        self._device = dcn.device
        self._module = dcn.module
        self._replicas = [(self._device, self._module)]
        if model_parallel:
            devices = [torch.device(d) for d in (devices or [dcn.device])]
            m = int(model_parallel)
            if len(devices) % m:
                raise ValueError(f"--model_parallel {m} does not divide {len(devices)} devices")
            groups = [devices[i:i + m] for i in range(0, len(devices), m)]
            self._device = devices[0]
            self._replicas = [(g[0], shard_channels(copy.deepcopy(self._module).to(g[0]),
                                                    LocalChannels(g))) for g in groups]
        elif devices is not None:
            devices = [torch.device(d) for d in devices]
            self._device = devices[0]
            self._replicas = [(d, self._module if _same_device(d, dcn.device)
                               else copy.deepcopy(self._module).to(d)) for d in devices]
        self._H, self._W = dcn.image_shape
        self._D = dcn.descriptor_dimension
        self._Q = max(1, max_queries)
        n = len(self._replicas)
        if devices is not None:
            self._buckets = tuple(n * m for m in (1, 2, 4, 8, 16, 32)
                                  if n * m <= max(n, max_batch)) or (n,)
        else:
            self._buckets = tuple(b for b in (1, 2, 4, 8, 16, 32, 64, 128, 256)
                                  if b <= max(1, max_batch)) or (1,)
        # never collect more than the largest bucket holds: a non-power-of-two
        # max_batch would otherwise overflow the padded frame array
        self._max_batch = self._buckets[-1]
        self._max_wait_s = max_wait_ms / 1000.0
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        # match_dispatches: dispatches that launched the best-match kernel;
        # the seconds: see the module docstring
        self.stats = {"requests": 0, "dispatches": 0, "frames": 0, "match_dispatches": 0,
                      "closed_early": 0, **dict.fromkeys(_BATCHER_PHASES + _HANDLER_TIMES, 0.0)}
        self._stats_lock = threading.Lock()  # handler threads race on stats
        # marks the end of a dispatch's device work
        self._done = torch.cuda.Event() if self._device.type == "cuda" else None
        self._mean = torch.as_tensor(dcn.image_mean, dtype=torch.float32, device=self._device)
        self._std = torch.as_tensor(dcn.image_std_dev, dtype=torch.float32, device=self._device)

        self._stop = threading.Event()
        self._batcher = threading.Thread(target=self._batch_loop,
                                         name="pdc-serve-batcher", daemon=True)
        self._serve_thread: Optional[threading.Thread] = None
        self._conn_lock = threading.Lock()
        self._connections = {}  # handler thread -> its socket

        server_self = self

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self):
                me = threading.current_thread()
                with server_self._conn_lock:
                    server_self._connections[me] = self.connection
                try:
                    server_self._handle_connection(self.rfile, self.wfile)
                finally:
                    with server_self._conn_lock:
                        server_self._connections.pop(me, None)

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True
            # many clients connect at once; the default backlog of 5 drops
            # concurrent connects
            request_queue_size = 256

        self._tcp = _Server((host, port), _Handler)
        self.address = self._tcp.server_address  # (host, real_port)

    # -- the batched step ------------------------------------------------------

    def _forward_one(self, device, module, frames: torch.Tensor, queries, n: int):
        """One replica's step on its uint8 frames; queries [n, Q, D] (n <= its
        frames) or None."""
        x = frames.to(torch.float32)
        x = (x / 255.0 - self._mean.to(device)) / self._std.to(device)
        # float32 whatever the compute dtype, as pdc_tpu's server returns it
        out = module(x.permute(0, 3, 1, 2).contiguous()).to(torch.float32)
        if queries is None or n == 0:
            return out, None, None
        idx, dist = best_match(out[:n].reshape(n, self._D, self._H * self._W), queries)
        return out, idx, dist

    def _forward(self, frames: np.ndarray, queries: Optional[np.ndarray], n: int, laps: _Laps):
        """frames [b, H, W, 3] uint8 (b = bucket), queries [n, Q, D] float32
        or None -> (descriptors [b, D, H, W], idx [n, Q] int32 or None,
        dist [n, Q] or None), all on the first replica's device. Each
        replica takes a contiguous block of the frames, uploaded
        (``serve.upload``) and its work queued (``serve.launch``) before the
        next replica's upload; every replica's work is queued before any
        result is collected."""
        k = frames.shape[0] // len(self._replicas)
        runs = []
        for r, (device, module) in enumerate(self._replicas):
            m = min(max(n - r * k, 0), k)  # requests in this block
            with laps.phase("serve.upload"):
                x = torch.from_numpy(frames[r * k:(r + 1) * k]).to(device)
                q = (None if queries is None or m == 0
                     else torch.from_numpy(queries[r * k:r * k + m]).to(device))
            with laps.phase("serve.launch"):
                runs.append(self._forward_one(device, module, x, q, m))
        if len(runs) == 1:
            return runs[0]
        with laps.phase("serve.launch"):
            out = torch.cat([o.to(self._device) for o, _, _ in runs])
            if queries is None:
                return out, None, None
            idx = torch.cat([i.to(self._device) for _, i, _ in runs if i is not None])
            dist = torch.cat([d.to(self._device) for _, _, d in runs if d is not None])
            return out, idx, dist

    # -- lifecycle -----------------------------------------------------------

    def warmup(self):
        """Run one step per batch bucket, best match included, so that cuDNN
        set-up and the kernel's first-use build happen before any request."""
        with torch.inference_mode():
            for b in self._buckets:
                z = np.zeros((b, self._H, self._W, 3), np.uint8)
                q = np.zeros((b, self._Q, self._D), np.float32)
                _, idx, _ = self._forward(z, q, b, _Laps())
                idx.cpu()

    def serve_forever(self):
        self._batcher.start()
        self._serve_thread = threading.current_thread()
        try:
            self._tcp.serve_forever(poll_interval=0.1)
        finally:
            self._stop.set()

    def start(self):
        """Non-blocking start (tests / embedding)."""
        self._batcher.start()
        self._serve_thread = threading.Thread(
            target=self._tcp.serve_forever, kwargs={"poll_interval": 0.05},
            name="pdc-serve-accept", daemon=True)
        self._serve_thread.start()

    def shutdown(self):
        """Stop accepting, stop the batcher, fail queued requests and close
        open connections; returns once those threads have ended."""
        self._stop.set()
        if self._serve_thread is not None:
            self._tcp.shutdown()  # returns once serve_forever has exited
        self._tcp.server_close()
        self._fail_queued()
        with self._conn_lock:
            conns = dict(self._connections)
        for conn in conns.values():
            try:
                conn.shutdown(socket.SHUT_RDWR)  # unblocks the handler's read
            except OSError:
                pass
        for t in [self._batcher, self._serve_thread, *conns]:
            if t is not None and t.is_alive() and t is not threading.current_thread():
                t.join(_JOIN_TIMEOUT_S)

    def _fail_queued(self):
        # fail requests the batcher will never drain so their handler threads
        # (and remote clients) unblock immediately
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            req.error = "server shut down"
            req.event.set()

    # -- batching core -------------------------------------------------------

    def _count(self, amounts: dict):
        """Add to ``stats`` in one update: a reader that copies it without
        the lock sees all of a dispatch's counts or none."""
        with self._stats_lock:
            self.stats.update({k: self.stats[k] + v for k, v in amounts.items()})

    def _batch_loop(self):
        """Take the first queued request, gather more up to ``max_batch`` or
        ``max_wait_ms`` after it, and dispatch them. ``max_wait_ms`` bounds the
        wait only while another open connection could still send a frame."""
        laps = _Laps()
        while not self._stop.is_set():
            with laps.phase("serve.starved"):
                try:
                    first = self._queue.get(timeout=0.1)
                except queue.Empty:
                    first = None
            if first is None:
                self._count(laps.take())  # idle time is counted as it passes
                continue
            first.t_taken = laps.last
            batch = [first]
            closed_early = False
            with laps.phase("serve.gather"):
                deadline = first.t_taken + self._max_wait_s
                while len(batch) < self._max_batch:
                    # Each connection has at most one request in flight: once
                    # every open one's is in the batch and none is queued, no
                    # frame can join before the deadline. A request from no
                    # connection (``_submit`` in-process) keeps the window, as
                    # its callers are unknown. A connection accepted but not yet
                    # registered by its handler is missed here: that costs its
                    # frame this batch, never an answer. (No lock: the size of
                    # a dict and ``empty()`` are single reads.)
                    if (len(batch) >= len(self._connections) and self._queue.empty()
                            and all(r.via_connection for r in batch)):
                        closed_early = True
                        break
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    try:
                        req = self._queue.get(timeout=remaining)
                    except queue.Empty:
                        break
                    req.t_taken = time.perf_counter()
                    batch.append(req)
            self._run_batch(batch, laps, closed_early)
        self._count(laps.take())

    def _wait_device(self):
        """Block until the device's work queued so far on the first
        replica's device has ended (the other replicas' results are
        gathered there first)."""
        if self._done is not None:
            self._done.record(torch.cuda.current_stream(self._device))
            self._done.synchronize()

    def _run_batch(self, batch, laps: _Laps, closed_early: bool = False):
        """One dispatch: assemble, upload, queue every kernel, wait for the
        device, download, answer; ``laps`` (the batcher's) times its
        phases; ``closed_early``: its gather ended before the batch was full
        and before the deadline, every open connection's frame in it."""
        try:
            n = len(batch)
            with laps.phase("serve.assemble"):
                b = _bucket(n, self._buckets)
                frames = np.zeros((b, self._H, self._W, 3), np.uint8)
                queries = np.zeros((n, self._Q, self._D), np.float32)
                valid = np.zeros((n, self._Q), bool)
                for i, req in enumerate(batch):
                    frames[i] = req.rgb
                    if req.queries is not None:
                        q = req.queries.shape[0]
                        queries[i, :q] = req.queries
                        valid[i, :q] = True
                match = bool(valid.any())
                need = [i for i, r in enumerate(batch) if r.queries is None]
            with torch.inference_mode():
                with laps.phase("serve.upload"):
                    valid_d = torch.from_numpy(valid).to(self._device) if match else None
                    sel = torch.as_tensor(need, device=self._device) if need else None
                out, idx, dist = self._forward(frames, queries if match else None, n, laps)
                with laps.phase("serve.launch"):
                    # one gathered copy for every descriptors request
                    desc = None if sel is None else out[sel].permute(0, 2, 3, 1).contiguous()
                    uv = None
                    if idx is not None:
                        idx = idx.to(torch.int64)
                        uv = torch.stack([idx % self._W, idx // self._W], dim=-1).to(torch.int32)
                        dist = torch.where(valid_d, dist, torch.full_like(dist, math.inf))
                with laps.phase("serve.device_wait"):
                    self._wait_device()
                with laps.phase("serve.download"):
                    desc_h = None if desc is None else desc.cpu().numpy()
                    uv_h = None if uv is None else uv.cpu().numpy()
                    dist_h = None if uv is None else dist.cpu().numpy()
            with laps.phase("serve.fanout"):
                desc_pos = {i: k for k, i in enumerate(need)}
                results = [(desc_h[desc_pos[i]] if i in desc_pos else None,
                            None if uv_h is None else uv_h[i],
                            None if dist_h is None else dist_h[i]) for i in range(n)]
                # counted before any answer is out; the fan-out's own time
                # is counted with the next dispatch's phases
                self._count(dict(laps.take(), dispatches=1, frames=n,
                                 match_dispatches=int(uv is not None),
                                 closed_early=int(closed_early)))
                for req, result in zip(batch, results):
                    req.result = result
                    req.t_answered = time.perf_counter()
                    req.event.set()
        except Exception as e:  # surface device errors to every waiter
            for req in batch:
                req.error = f"{type(e).__name__}: {e}"
                req.t_answered = time.perf_counter()
                req.event.set()

    def _submit(self, rgb: np.ndarray, queries=None, t_read=None,
                via_connection: bool = False) -> _Request:
        """Queue one frame request and wait for its answer; a connection's
        handler passes ``via_connection`` (see :meth:`_batch_loop`).

        :return: the answered request; its ``result`` is (descriptors
            [H, W, D] np or None, uv [Qmax, 2], dist [Qmax])
        """
        if self._stop.is_set():
            raise RuntimeError("server shut down")
        req = _Request(rgb, queries, t_read, via_connection)
        with _span("serve.wait"):
            req.t_put = time.perf_counter()
            self._queue.put(req)
            while not req.event.wait(0.1):
                if self._stop.is_set() and not self._batcher.is_alive():
                    self._fail_queued()  # enqueued after shutdown() drained the queue
        if req.error is not None:
            raise RuntimeError(req.error)
        return req

    def _count_reply(self, req: _Request):
        """The reply has been sent: add the request's handler times."""
        req.t_sent = time.perf_counter()
        self._count({"queue_wait_s": req.t_taken - req.t_put,
                     "handler_s": (req.t_put - req.t_read) + (req.t_sent - req.t_answered)})

    # -- protocol ------------------------------------------------------------

    def _handle_connection(self, rfile, wfile):
        while not self._stop.is_set():
            try:
                line = rfile.readline()
            except OSError:  # connection shut down by shutdown()
                return
            if not line:
                return
            try:
                header = json.loads(line)
            except ValueError:
                self._send(wfile, {"ok": False, "error": "bad JSON header"})
                return
            try:
                self._handle_request(header, rfile, wfile)
            except (BrokenPipeError, ConnectionResetError):
                return
            except _DesyncError as e:
                self._send(wfile, {"ok": False, "error": str(e)})
                return
            except Exception as e:
                self._send(wfile, {"ok": False,
                                   "error": f"{type(e).__name__}: {e}"})

    _MAX_PAYLOAD = 64 << 20

    def _read_frame(self, header, rfile) -> np.ndarray:
        shape = header.get("shape")
        encoding = header.get("encoding", "raw")
        # exact-width Python-int product, so a huge declared shape cannot
        # slip a wrapped length past the cap
        if (not isinstance(shape, list) or len(shape) != 3
                or not all(isinstance(x, int) and 0 < x <= self._MAX_PAYLOAD
                           for x in shape)
                or math.prod(shape) > self._MAX_PAYLOAD):
            # the declared length cannot be trusted -> the stream is desynced
            raise _DesyncError(f"bad shape: {shape!r}")
        if encoding not in ("raw", "jpeg", "png"):
            raise _DesyncError(f"bad encoding: {encoding!r}")
        if encoding == "raw":
            nbytes = math.prod(shape)
        else:
            nbytes = header.get("payload_len")
            if (not isinstance(nbytes, int)
                    or not 0 < nbytes <= self._MAX_PAYLOAD):
                raise _DesyncError(f"bad payload_len: {nbytes!r}")
        # drain the declared payload FIRST so the connection stays usable
        # even when validation below rejects the request
        payload = rfile.read(nbytes)
        if len(payload) != nbytes:
            raise _DesyncError("truncated payload")
        expect = [self._H, self._W, 3]
        if shape != expect:
            raise ValueError(f"shape {shape} != served {expect}")
        if encoding == "raw":
            return np.frombuffer(payload, np.uint8).reshape(shape)
        # bound the DECODED size before decoding (a crafted PNG can declare
        # gigapixel dims)
        dims = encoded_image_dims(payload)
        if dims != (self._H, self._W):
            raise ValueError(
                f"{encoding} header dims {dims} != served "
                f"({self._H}, {self._W})")
        rgb = decode_frame(payload, encoding)
        if list(rgb.shape) != expect:
            raise ValueError(
                f"decoded {encoding} shape {list(rgb.shape)} != {expect}")
        return rgb

    def _handle_request(self, header, rfile, wfile):
        op = header.get("op")
        self._count({"requests": 1})
        if op == "ping":
            self._send(wfile, {"ok": True})
        elif op == "info":
            with self._stats_lock:
                stats = dict(self.stats)
            self._send(wfile, {
                "ok": True, "height": self._H, "width": self._W,
                "descriptor_dimension": self._D,
                "max_batch": self._max_batch, "max_queries": self._Q,
                "stats": stats,
            })
        elif op == "descriptors":
            t_read = time.perf_counter()
            with _span("serve.read"):
                rgb = self._read_frame(header, rfile)
                rdtype = header.get("response_dtype", "float32")
                if rdtype not in ("float32", "float16"):
                    raise ValueError(f"bad response_dtype: {rdtype!r}")
            req = self._submit(rgb, None, t_read, via_connection=True)
            with _span("serve.reply"):
                res = req.result[0]
                wire = res.astype("<f2" if rdtype == "float16" else "<f4")
                self._send(wfile, {"ok": True, "shape": list(res.shape),
                                   "dtype": rdtype}, wire.tobytes())
            self._count_reply(req)
        elif op == "best_match":
            t_read = time.perf_counter()
            with _span("serve.read"):
                rgb = self._read_frame(header, rfile)  # drains payload first
                queries = np.asarray(header.get("queries", []), np.float32)
                if queries.ndim != 2 or queries.shape[1] != self._D:
                    raise ValueError(f"queries must be [Q, {self._D}]")
                q = queries.shape[0]
                if q > self._Q:
                    raise ValueError(
                        f"too many queries: {q} > max_queries {self._Q}")
            req = self._submit(rgb, queries, t_read, via_connection=True)
            with _span("serve.reply"):
                _, uv, dist = req.result
                uv, dist = uv[:q], dist[:q]
                self._send(wfile, {"ok": True, "num_queries": q,
                                   "dtype": "int32+float32"},
                           uv.astype("<i4").tobytes() + dist.astype("<f4").tobytes())
            self._count_reply(req)
        else:
            raise ValueError(f"unknown op: {op!r}")

    @staticmethod
    def _send(wfile, header: dict, payload: bytes = b""):
        wfile.write(json.dumps(header).encode() + b"\n" + payload)
        wfile.flush()


class DescriptorClient:
    """Blocking client for :class:`DescriptorServer` (one socket, reusable
    across requests; thread-safe per instance via an internal lock)."""

    def __init__(self, host: str, port: int, timeout: float = 120.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._rfile = self._sock.makefile("rb")
        self._lock = threading.Lock()

    def close(self):
        self._rfile.close()
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _roundtrip(self, header: dict, payload: bytes = b"") -> dict:
        with self._lock:
            self._sock.sendall(json.dumps(header).encode() + b"\n" + payload)
            line = self._rfile.readline()
            if not line:
                raise ConnectionError("server closed connection")
            resp = json.loads(line)
            if not resp.get("ok"):
                raise RuntimeError(resp.get("error", "server error"))
            resp["_payload"] = b""
            nbytes = self._payload_len(resp)
            if nbytes:
                data = self._rfile.read(nbytes)
                if len(data) != nbytes:
                    raise ConnectionError("truncated response")
                resp["_payload"] = data
            return resp

    @staticmethod
    def _payload_len(resp: dict) -> int:
        if "shape" in resp:
            itemsize = 2 if resp.get("dtype") == "float16" else 4
            return int(np.prod(resp["shape"])) * itemsize
        if "num_queries" in resp:
            return int(resp["num_queries"]) * (2 * 4 + 4)
        return 0

    @staticmethod
    def _frame_payload(rgb_u8, encoding, quality):
        header = {"shape": list(rgb_u8.shape)}
        if encoding in (None, "raw"):
            return header, rgb_u8.tobytes()
        payload = encode_frame(rgb_u8, encoding, quality)
        header["encoding"] = encoding
        header["payload_len"] = len(payload)
        return header, payload

    def ping(self) -> bool:
        return bool(self._roundtrip({"op": "ping"}).get("ok"))

    def info(self) -> dict:
        r = self._roundtrip({"op": "info"})
        r.pop("_payload", None)
        return r

    def descriptors(self, rgb_u8: np.ndarray, encoding: str = None,
                    quality: int = 90,
                    response_dtype: str = "float32") -> np.ndarray:
        """uint8 RGB [H, W, 3] -> descriptor image [H, W, D].

        :param encoding: None/"raw" (uint8 upload) | "jpeg" | "png"
        :param response_dtype: "float32" | "float16" (halves the downlink)
        """
        rgb_u8 = np.ascontiguousarray(rgb_u8, np.uint8)
        header, payload = self._frame_payload(rgb_u8, encoding, quality)
        header["op"] = "descriptors"
        if response_dtype != "float32":
            header["response_dtype"] = response_dtype
        r = self._roundtrip(header, payload)
        wire = "<f2" if r.get("dtype") == "float16" else "<f4"
        return np.frombuffer(r["_payload"], wire).reshape(r["shape"])

    def best_match(self, rgb_u8: np.ndarray, queries: np.ndarray,
                   encoding: str = None, quality: int = 90):
        """:return: (uv [Q, 2] int32, dist [Q] float32) best matches of each
        query descriptor in the frame's descriptor image."""
        rgb_u8 = np.ascontiguousarray(rgb_u8, np.uint8)
        queries = np.asarray(queries, np.float32)
        header, payload = self._frame_payload(rgb_u8, encoding, quality)
        header["op"] = "best_match"
        header["queries"] = queries.tolist()
        r = self._roundtrip(header, payload)
        q = r["num_queries"]
        raw = r["_payload"]
        uv = np.frombuffer(raw[:q * 8], "<i4").reshape(q, 2)
        dist = np.frombuffer(raw[q * 8:], "<f4")
        return uv, dist


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m pdc_tpu_torch serve",
        description="descriptor serving daemon (microbatched TCP server)")
    p.add_argument("--model_folder", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7863)
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="how long a batch waits for more frames while another open "
                        "connection could still send one")
    p.add_argument("--max_queries", type=int, default=16,
                   help="per-request best-match query budget")
    p.add_argument("--iteration", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda; cpu must be "
                        "asked for)")
    add_int8_flags(p)
    p.add_argument("--data_parallel", action="store_true",
                   help="one replica of the network per local card; the coalesced batch is "
                        "split over them")
    p.add_argument("--model_parallel", type=int, default=0, metavar="N",
                   help="channel-shard each replica over N local cards (N must divide the "
                        "card count); the batch is split over the replicas")
    args = p.parse_args(argv)

    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork

    # numbers served must be fp32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dcn = DenseCorrespondenceNetwork.from_model_folder(
        args.model_folder, iteration=args.iteration, device=args.device)
    dcn = serving_clone(dcn, quantize_arg(args),
                        lambda: first_frames(dcn.load_training_dataset()))
    devices = None
    if args.data_parallel or args.model_parallel:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if dcn.device.type == "cuda" else [dcn.device])
    if args.model_parallel and len(devices) % args.model_parallel:
        raise SystemExit(f"--model_parallel {args.model_parallel} does not divide "
                         f"{len(devices)} devices")
    server = DescriptorServer(dcn, host=args.host, port=args.port,
                              max_batch=args.max_batch,
                              max_wait_ms=args.max_wait_ms,
                              max_queries=args.max_queries, devices=devices,
                              model_parallel=args.model_parallel or None)
    print(f"warming up {len(server._buckets)} batch buckets...", flush=True)
    server.warmup()
    host, port = server.address
    print(f"serving {args.model_folder} on {host}:{port} (max_batch={args.max_batch}, "
          f"replicas on {[str(d) for d, _ in server._replicas]}, model_parallel="
          f"{args.model_parallel or 1})", flush=True)
    try:
        server.serve_forever()
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
