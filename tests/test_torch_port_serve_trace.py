"""The port descriptor server's spans and counters (pdc_tpu_torch.apps.serve)
on the CPU: the counters grow by what was served, one request's times are
in order, the batcher's phases add up to its wall time, no
``record_function`` is entered without a profiler and every ``serve.*``
range is recorded under one that records all threads, each phase's spans
cover the time its counter sums, replicas upload in turn with their
forwards, ``info`` returns the counters, and the answers are those of the
dispatch before the phases were split, bit for bit. The batcher closes a
gather at once when every open connection's frame is in it, and only then."""

import json
import math
import sys
import threading
import time
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from pdc_tpu_torch.apps import serve
from pdc_tpu_torch.apps.serve import DescriptorClient, DescriptorServer, _Laps, _Request
from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork

torch.set_num_threads(2)

W, H, D = 48, 32, 3
PHASES = ("starved_s", "gather_s", "upload_s", "device_wait_s", "download_s", "batcher_host_s")
HANDLER = ("queue_wait_s", "handler_s")
BATCHER_SPANS = {"serve.starved", "serve.gather", "serve.assemble", "serve.upload",
                 "serve.launch", "serve.device_wait", "serve.download", "serve.fanout"}
HANDLER_SPANS = {"serve.read", "serve.wait", "serve.reply"}


@pytest.fixture(scope="module")
def dcn():
    cfg = {"descriptor_dimension": D, "image_width": W, "image_height": H,
           "backbone": {"model_class": "Resnet", "resnet_name": "Resnet18_8s"}}
    return DenseCorrespondenceNetwork.from_config(cfg, generator=torch.Generator().manual_seed(4),
                                                  device="cpu")


@pytest.fixture
def server(dcn):
    s = DescriptorServer(dcn, port=0, max_batch=4, max_wait_ms=10.0)
    s.start()
    yield s
    s.shutdown()


def _frame(seed):
    return np.random.RandomState(seed).randint(0, 255, size=(H, W, 3), dtype=np.uint8)


def _queries(seed, q=2):
    return np.random.RandomState(seed).randn(q, D).astype(np.float32)


def _request(c, i):
    """Request ``i`` of a client: even ones descriptors, odd ones best match."""
    if i % 2 == 0:
        return c.descriptors(_frame(i))
    return c.best_match(_frame(i), _queries(i))


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def test_counters_grow_by_the_expected_counts(server):
    before = dict(server.stats)
    n = 6
    with DescriptorClient(*server.address, timeout=60.0) as c:
        for i in range(n):
            _request(c, i)
        assert c.ping()
    d = _delta(dict(server.stats), before)
    assert d["requests"] == n + 1 and d["frames"] == n
    # one closed-loop client: a dispatch a request, each closed at once, as
    # the only open connection's frame is in it: no wait for max_wait_ms
    assert d["dispatches"] == n and d["match_dispatches"] == n // 2
    assert d["closed_early"] == n
    assert d["gather_s"] < n * 0.010 / 2
    assert d["upload_s"] > 0 and d["download_s"] > 0 and d["batcher_host_s"] > 0
    assert d["device_wait_s"] >= 0 and d["starved_s"] >= 0
    assert d["queue_wait_s"] >= 0 and d["handler_s"] > 0


def test_concurrent_counting_loses_no_update(server):
    """More client threads than cores and a short switch interval: every
    request and frame is counted once."""
    before = dict(server.stats)
    threads_n, each = 12, 3
    errors = []

    def worker(t):
        try:
            with DescriptorClient(*server.address, timeout=60.0) as c:
                for i in range(each):
                    _request(c, t * each + i)
        except Exception as e:  # pragma: no cover - surfaced via errors
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    d = _delta(dict(server.stats), before)
    assert d["requests"] == d["frames"] == threads_n * each
    assert d["dispatches"] < threads_n * each, "no cross-request batching"


@contextmanager
def _serving(dcn, **kwargs):
    s = DescriptorServer(dcn, port=0, **kwargs)
    s.start()
    try:
        yield s
    finally:
        s.shutdown()


def _await_connections(s, n):
    """Until ``n`` connections' handlers have registered them."""
    deadline = time.monotonic() + 10
    while len(s._connections) < n:
        assert time.monotonic() < deadline, len(s._connections)
        time.sleep(0.005)


def test_an_open_idle_connection_keeps_the_window(dcn):
    """Two clients connected, one sends: the other could still send, so the
    dispatch waits out max_wait_ms and is not closed early."""
    with _serving(dcn, max_batch=4, max_wait_ms=50.0) as s:
        with DescriptorClient(*s.address, timeout=60.0) as c, \
                DescriptorClient(*s.address, timeout=60.0):
            _await_connections(s, 2)
            before = dict(s.stats)
            c.best_match(_frame(40), _queries(40))
            d = _delta(dict(s.stats), before)
    assert d["dispatches"] == d["frames"] == 1 and d["closed_early"] == 0
    assert d["gather_s"] >= 0.050


def test_every_connections_frame_in_the_batch_closes_it(dcn):
    """Four clients connect and each send one frame at once, with a 2 s
    max_wait_ms: one dispatch of the four, closed as the last joins."""
    frames = [_frame(70 + i) for i in range(4)]
    results, errors = [None] * 4, []
    with _serving(dcn, max_batch=8, max_wait_ms=2000.0) as s:
        barrier = threading.Barrier(5)

        def worker(i):
            try:
                with DescriptorClient(*s.address, timeout=60.0) as c:
                    barrier.wait(timeout=30)
                    results[i] = c.descriptors(frames[i])
            except Exception as e:  # pragma: no cover - surfaced via errors
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        _await_connections(s, 4)
        before = dict(s.stats)
        t0 = time.monotonic()
        barrier.wait(timeout=30)
        for t in threads:
            t.join(timeout=60)
        elapsed = time.monotonic() - t0
        d = _delta(dict(s.stats), before)
    assert not errors, errors
    assert d["dispatches"] == 1 and d["frames"] == 4 and d["closed_early"] == 1
    assert elapsed < 1.0 and d["gather_s"] < 1.0, (elapsed, d["gather_s"])
    for got, rgb in zip(results, frames):
        np.testing.assert_allclose(got, dcn.forward_on_img(rgb).numpy(), atol=1e-4, rtol=1e-4)


def test_a_request_from_no_connection_keeps_the_window(dcn):
    """``_submit`` in-process, no connection open: its callers are unknown,
    so the dispatch waits out max_wait_ms."""
    with _serving(dcn, max_batch=4, max_wait_ms=50.0) as s:
        before = dict(s.stats)
        req = s._submit(_frame(41), _queries(41))
        d = _delta(dict(s.stats), before)
    assert req.error is None and req.result[1].shape == (s._Q, 2)
    assert d["dispatches"] == d["frames"] == 1 and d["closed_early"] == 0
    assert d["gather_s"] >= 0.050


def test_one_requests_times_are_in_order(server):
    seen = []
    put = server._queue.put

    def recording(req, *args, **kwargs):
        seen.append(req)
        return put(req, *args, **kwargs)

    server._queue.put = recording
    try:
        with DescriptorClient(*server.address, timeout=60.0) as c:
            c.best_match(_frame(7), _queries(7))
            c.descriptors(_frame(8))
    finally:
        server._queue.put = put
    deadline = time.monotonic() + 10
    while any(r.t_sent is None for r in seen) and time.monotonic() < deadline:
        time.sleep(0.01)  # the reply is out before the handler reads its clock
    assert len(seen) == 2
    for r in seen:
        times = [r.t_read, r.t_put, r.t_taken, r.t_answered, r.t_sent]
        assert None not in times, times
        assert times == sorted(times), times


def test_batcher_phases_add_up_to_its_wall_time(dcn):
    s = DescriptorServer(dcn, port=0, max_batch=4, max_wait_ms=5.0)
    t0 = time.perf_counter()
    s.start()
    try:
        results = []

        def worker(t):
            with DescriptorClient(*s.address, timeout=60.0) as c:
                for i in range(4):
                    results.append(_request(c, 10 * t + i))

        threads = [threading.Thread(target=worker, args=(t,)) for t in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert len(results) == 12
        time.sleep(0.3)  # an idle stretch: starved time
    finally:
        s.shutdown()  # joins the batcher, which counts its last phases
    wall = time.perf_counter() - t0
    phases = sum(s.stats[k] for k in PHASES)
    assert s.stats["starved_s"] > 0.2 and s.stats["dispatches"] >= 3
    assert abs(phases - wall) <= 0.05 * wall, (phases, wall, {k: s.stats[k] for k in PHASES})


def test_no_record_function_without_a_profiler(server, monkeypatch):
    entered = []
    real = torch.autograd.profiler.record_function.__enter__

    def counting(self):
        entered.append(self.name)
        return real(self)

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", counting)
    with DescriptorClient(*server.address, timeout=60.0) as c:
        for i in range(4):
            _request(c, i)
        c.info()
    time.sleep(0.25)  # the batcher's idle turns
    assert entered == []


def _all_threads_config():
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        pytest.skip(f"torch {torch.__version__}'s profiler cannot record every thread")


def test_every_span_is_recorded_by_an_all_threads_profiler(server, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    config = _all_threads_config()
    prof = profile(activities=[ProfilerActivity.CPU], experimental_config=config)
    prof.start()
    try:
        with DescriptorClient(*server.address, timeout=60.0) as c:
            for i in range(4):
                _request(c, i)
        time.sleep(0.25)  # the batcher waits for work again
    finally:
        prof.stop()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and str(e.get("name")).startswith("serve.")]
    names = {e["name"] for e in events}
    assert names >= BATCHER_SPANS | HANDLER_SPANS, sorted(names)
    tids = {name: {e["tid"] for e in events if e["name"] == name} for name in names}
    batcher = set.union(*(tids[n] for n in BATCHER_SPANS))
    assert len(batcher) == 1 and not batcher & tids["serve.read"]


def test_each_phases_spans_cover_its_counted_time(server, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    config = _all_threads_config()
    prof = profile(activities=[ProfilerActivity.CPU], experimental_config=config)
    prof.start()
    try:
        before = dict(server.stats)
        with DescriptorClient(*server.address, timeout=60.0) as c:
            for i in range(4):
                _request(c, i)
        # a dispatch's phases are counted before its answers go out
        d = _delta(dict(server.stats), before)
    finally:
        prof.stop()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    span_s = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation" and "dur" in e:
            span_s[e["name"]] = span_s.get(e["name"], 0.0) + 1e-6 * float(e["dur"])
    assert d["dispatches"] == 4
    for span, phase in (("serve.gather", "gather_s"), ("serve.upload", "upload_s"),
                        ("serve.device_wait", "device_wait_s"),
                        ("serve.download", "download_s")):
        # a lap's edges lie just outside its span's: they differ by the range's own cost
        assert span_s[span] <= d[phase] <= span_s[span] + 0.002 + 0.1 * d[phase], (
            span, span_s[span], d[phase])


def test_replicas_upload_in_turn_with_their_forwards(dcn):
    """With two replicas, the second's frames are uploaded after the first's
    forward is queued, so that upload overlaps that forward."""
    class Recording(_Laps):
        def __init__(self):
            super().__init__()
            self.spans = []

        def phase(self, span):
            self.spans.append(span)
            return super().phase(span)

    s = DescriptorServer(dcn, port=0, max_batch=4, devices=["cpu", "cpu"])
    try:
        batch = [_Request(_frame(60), _queries(60)), _Request(_frame(61)), _Request(_frame(62))]
        laps = Recording()
        s._run_batch(batch, laps)
        assert all(r.error is None for r in batch), [r.error for r in batch]
        assert laps.spans == ["serve.assemble", "serve.upload", "serve.upload", "serve.launch",
                              "serve.upload", "serve.launch", "serve.launch", "serve.launch",
                              "serve.device_wait", "serve.download", "serve.fanout"]
    finally:
        s.shutdown()


def test_info_returns_the_new_counters(server):
    with DescriptorClient(*server.address, timeout=60.0) as c:
        c.best_match(_frame(3), _queries(3))
        stats = c.info()["stats"]
    for k in PHASES + HANDLER:
        assert isinstance(stats[k], float) and stats[k] >= 0, (k, stats)
    assert stats["handler_s"] > 0 and stats["frames"] >= 1


def _parent_answers(s, batch):
    """The dispatch as it was before its phases were split (each replica's
    upload, forward and best match in turn; the copies to the host waiting
    on the device), for one replica."""
    n = len(batch)
    b = serve._bucket(n, s._buckets)
    frames = np.zeros((b, H, W, 3), np.uint8)
    queries = np.zeros((n, s._Q, D), np.float32)
    valid = np.zeros((n, s._Q), bool)
    for i, req in enumerate(batch):
        frames[i] = req.rgb
        if req.queries is not None:
            q = req.queries.shape[0]
            queries[i, :q] = req.queries
            valid[i, :q] = True
    device, module = s._replicas[0]
    with torch.inference_mode():
        x = torch.from_numpy(frames).to(device).to(torch.float32)
        x = (x / 255.0 - s._mean.to(device)) / s._std.to(device)
        out = module(x.permute(0, 3, 1, 2).contiguous()).to(torch.float32)
        q = torch.from_numpy(queries).to(device)
        idx, dist = serve.best_match(out[:n].reshape(n, D, H * W), q)
        need = [i for i, r in enumerate(batch) if r.queries is None]
        sel = torch.as_tensor(need, device=device)
        desc_h = out[sel].permute(0, 2, 3, 1).cpu().numpy()
        idx = idx.to(torch.int64)
        uv = torch.stack([idx % W, idx // W], dim=-1)
        dist = torch.where(torch.from_numpy(valid).to(device), dist,
                           torch.full_like(dist, math.inf))
        uv_h = uv.to(torch.int32).cpu().numpy()
        dist_h = dist.cpu().numpy()
    pos = {i: k for k, i in enumerate(need)}
    return [(desc_h[pos[i]] if i in pos else None, uv_h[i], dist_h[i]) for i in range(n)]


def test_answers_equal_the_parent_path_bit_for_bit(dcn):
    s = DescriptorServer(dcn, port=0, max_batch=4)
    try:
        batch = [_Request(_frame(50), _queries(50, 2)), _Request(_frame(51)),
                 _Request(_frame(52), _queries(52, 5)), _Request(_frame(53))]
        expected = _parent_answers(s, batch)
        s._run_batch(batch, _Laps())
        for req, want in zip(batch, expected):
            assert req.error is None, req.error
            for got, ref in zip(req.result, want):
                if ref is None:
                    assert got is None
                else:
                    assert got.dtype == ref.dtype and got.shape == ref.shape
                    assert np.array_equal(got, ref), np.abs(got - ref).max()
        assert np.isinf(batch[0].result[2][2:]).all() and np.isfinite(batch[2].result[2][:5]).all()
    finally:
        s.shutdown()
