"""Port descriptor server (pdc_tpu_torch.apps.serve) on the CPU: the same
answers as the JAX DescriptorServer on the same weights, frames and queries,
and the port counterparts of tests/test_serve.py (protocol, error and desync
paths, microbatching, shutdown)."""

import json
import socket
import threading

import jax
import numpy as np
import pytest
import torch

from pdc_tpu.apps.serve import DescriptorClient as JaxClient
from pdc_tpu.apps.serve import DescriptorServer as JaxServer
from pdc_tpu.models.dcn import DenseCorrespondenceNetwork as JaxDCN
from pdc_tpu_torch import __main__ as cli
from pdc_tpu_torch.apps import serve
from pdc_tpu_torch.apps.serve import DescriptorClient, DescriptorServer, _Request
from pdc_tpu_torch.models.convert import flax_to_state_dict
from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
from pdc_tpu_torch.ops import best_match as bm

torch.set_num_threads(2)

W, H, D = 48, 32, 3
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def jdcn():
    cfg = {"descriptor_dimension": D, "image_width": W, "image_height": H,
           "backbone": {"model_class": "Resnet", "resnet_name": "Resnet18_8s"}}
    return JaxDCN.from_config(cfg, rng=jax.random.PRNGKey(3))


@pytest.fixture(scope="module")
def dcn(jdcn):
    d = DenseCorrespondenceNetwork.from_config(jdcn.config, device="cpu")
    d.module.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                       jdcn.variables)))
    return d


@pytest.fixture(scope="module")
def server(dcn):
    s = DescriptorServer(dcn, port=0, max_batch=4, max_wait_ms=20.0)
    s.warmup()
    s.start()
    yield s
    s.shutdown()


def _client(server):
    host, port = server.address
    return DescriptorClient(host, port, timeout=60.0)


def _frame(seed):
    return np.random.RandomState(seed).randint(0, 255, size=(H, W, 3), dtype=np.uint8)


def _expected(dcn, rgb):
    return dcn.forward_on_img(rgb).numpy()


def _d2(res, queries):
    r = res.reshape(-1, D).astype(np.float64)
    return ((r[:, None, :] - queries.astype(np.float64)[None]) ** 2).sum(-1)


def test_same_answers_as_jax_server(dcn, jdcn):
    """Both servers on the same weights, frames and queries."""
    frames = [_frame(60 + i) for i in range(3)]
    queries = np.random.RandomState(61).randn(5, D).astype(np.float32)
    js = JaxServer(jdcn, port=0, max_batch=1, max_queries=8)
    js.start()
    try:
        with JaxClient(*js.address) as c:
            jdesc = [c.descriptors(f) for f in frames]
            jbm = [c.best_match(f, queries) for f in frames]
    finally:
        js.shutdown()
    ps = DescriptorServer(dcn, port=0, max_batch=1, max_queries=8)
    ps.start()
    try:
        with DescriptorClient(*ps.address) as c:
            pdesc = [c.descriptors(f) for f in frames]
            pbm = [c.best_match(f, queries) for f in frames]
    finally:
        ps.shutdown()
    for got, want, (uv, dist), (juv, jdist) in zip(pdesc, jdesc, pbm, jbm):
        # fp32 convolutions in another order + the upsample's weights (~2e-5)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * float(np.abs(want).max()))
        # best match, tie-tolerant: the JAX server expands ||r||^2 - 2<r,q> +
        # ||q||^2 and loses up to 8 eps (||r||^2 + ||q||^2) to cancellation
        d2 = _d2(got, queries)
        tol = 8 * EPS32 * (float((got.astype(np.float64) ** 2).sum(-1).max())
                           + (queries.astype(np.float64) ** 2).sum(-1))
        for cand in (uv, juv):
            chosen = d2[cand[:, 1] * W + cand[:, 0], np.arange(len(queries))]
            assert np.all(chosen - d2.min(0) <= tol + 1e-5)
        np.testing.assert_allclose(dist.astype(np.float64) ** 2, jdist.astype(np.float64) ** 2,
                                   atol=tol.max() + 1e-5)


def test_ping_and_info(server):
    with _client(server) as c:
        assert c.ping()
        info = c.info()
        assert (info["height"], info["width"]) == (H, W)
        assert info["descriptor_dimension"] == D
        assert info["max_batch"] == 4 and info["max_queries"] == 16
        assert set(info["stats"]) >= {"requests", "dispatches", "frames"}


def test_descriptors_match_in_process_forward(server, dcn):
    rgb = _frame(0)
    with _client(server) as c:
        served = c.descriptors(rgb)
    assert served.shape == (H, W, D)
    np.testing.assert_allclose(served, _expected(dcn, rgb), atol=1e-4, rtol=1e-4)


def test_best_match_matches_library_search(server, dcn):
    rgb = _frame(1)
    res = _expected(dcn, rgb)
    pts = [(5, 7), (30, 20), (11, 3)]
    queries = np.stack([res[v, u] for u, v in pts])
    before = dict(server.stats)
    with _client(server) as c:
        uv, dist = c.best_match(rgb, queries)
    assert uv.shape == (3, 2) and dist.shape == (3,)
    assert np.all(dist < 1e-4)
    for (u, v), (bu, bv) in zip(pts, uv):
        np.testing.assert_allclose(res[bv, bu], res[v, u], atol=1e-5)
    assert server.stats["match_dispatches"] - before["match_dispatches"] == 1


def test_multiple_requests_one_connection(server):
    with _client(server) as c:
        a = c.descriptors(_frame(2))
        assert c.ping()
        b = c.descriptors(_frame(3))
    assert not np.allclose(a, b)


def test_error_paths(server):
    with _client(server) as c:
        with pytest.raises(RuntimeError, match="shape"):
            c._roundtrip({"op": "descriptors", "shape": [8, 8, 3]}, b"\0" * (8 * 8 * 3))
        with pytest.raises(RuntimeError, match="unknown op"):
            c._roundtrip({"op": "frobnicate"})
        with pytest.raises(RuntimeError, match="queries"):
            c._roundtrip({"op": "best_match", "shape": [H, W, 3], "queries": [[1.0]]},
                         _frame(4).tobytes())
        with pytest.raises(RuntimeError, match="max_queries"):
            c._roundtrip({"op": "best_match", "shape": [H, W, 3],
                          "queries": [[0.0] * D] * 99}, _frame(4).tobytes())
        with pytest.raises(RuntimeError, match="response_dtype"):
            c._roundtrip({"op": "descriptors", "shape": [H, W, 3],
                          "response_dtype": "int8"}, _frame(4).tobytes())
        # connection still serves after errors
        assert c.ping()


@pytest.mark.parametrize("header,error", [
    ({"op": "descriptors", "shape": [3, 2 ** 62, 1]}, "bad shape"),   # int64-wrapping product
    ({"op": "descriptors", "shape": [H, W]}, "bad shape"),
    ({"op": "descriptors", "shape": [H, W, 3], "encoding": "bmp"}, "encoding"),
    ({"op": "descriptors", "shape": [H, W, 3], "encoding": "png", "payload_len": -1},
     "payload_len"),
])
def test_desync_paths_close_the_connection(server, header, error):
    with socket.create_connection(server.address, timeout=30) as s:
        rf = s.makefile("rb")
        s.sendall(json.dumps(header).encode() + b"\n")
        resp = json.loads(rf.readline())
        assert not resp["ok"] and error in resp["error"]
        assert rf.readline() == b""  # the server closed the stream


def test_bad_json_header_closes(server):
    with socket.create_connection(server.address, timeout=30) as s:
        rf = s.makefile("rb")
        s.sendall(b"{not json\n")
        resp = json.loads(rf.readline())
        assert not resp["ok"] and "JSON" in resp["error"]
        assert rf.readline() == b""


def test_truncated_payload_is_desync(server):
    with socket.create_connection(server.address, timeout=30) as s:
        rf = s.makefile("rb")
        s.sendall(json.dumps({"op": "descriptors", "shape": [H, W, 3]}).encode() + b"\n"
                  + b"\0" * 10)
        s.shutdown(socket.SHUT_WR)
        resp = json.loads(rf.readline())
        assert not resp["ok"] and "truncated" in resp["error"]


def test_png_upload_exact_and_f16_response(server):
    rgb = _frame(7)
    with _client(server) as c:
        raw = c.descriptors(rgb)
        png = c.descriptors(rgb, encoding="png")
        f16 = c.descriptors(rgb, encoding="png", response_dtype="float16")
    np.testing.assert_array_equal(raw, png)
    assert f16.dtype == np.float16
    np.testing.assert_allclose(f16.astype(np.float32), raw, atol=2e-3, rtol=2e-3)


def test_jpeg_upload_and_dims_parser():
    rgb = _frame(11)
    png, jpg = serve.encode_frame(rgb, "png"), serve.encode_frame(rgb, "jpeg")
    assert len(jpg) < rgb.nbytes / 2
    assert serve.encoded_image_dims(png) == (H, W)
    assert serve.encoded_image_dims(jpg) == (H, W)
    assert serve.encoded_image_dims(b"not an image") is None
    assert serve.encoded_image_dims(jpg[:2] + b"\xff\xff\xff" + jpg[2:]) == (H, W)
    assert serve.encoded_image_dims(jpg[:2] + b"\xff\x01" + b"\xff" + jpg[2:]) == (H, W)
    assert serve.encoded_image_dims(b"\xff\xd8\xff\xd9" + b"\x00" * 16) is None
    np.testing.assert_array_equal(serve.decode_frame(png, "png"), rgb)
    assert serve.decode_frame(jpg, "jpeg").shape == (H, W, 3)


def test_decode_bomb_rejected_before_decode(server):
    bomb = (b"\x89PNG\r\n\x1a\n" + b"\x00\x00\x00\x0dIHDR"
            + (30000).to_bytes(4, "big") + (30000).to_bytes(4, "big")
            + b"\x08\x02\x00\x00\x00" + b"\x00" * 64)
    with socket.create_connection(server.address, timeout=30) as s:
        rf = s.makefile("rb")
        s.sendall(json.dumps({"op": "descriptors", "shape": [H, W, 3], "encoding": "png",
                              "payload_len": len(bomb)}).encode() + b"\n" + bomb)
        resp = json.loads(rf.readline())
        assert not resp["ok"] and "header dims" in resp["error"]
        s.sendall(json.dumps({"op": "ping"}).encode() + b"\n")
        assert json.loads(rf.readline())["ok"]  # connection still usable


def test_best_match_compressed_upload(server):
    rgb = _frame(9)
    queries = np.random.RandomState(9).randn(3, D).astype(np.float32)
    with _client(server) as c:
        uv_raw, dist_raw = c.best_match(rgb, queries)
        uv_png, dist_png = c.best_match(rgb, queries, encoding="png")
    np.testing.assert_array_equal(uv_raw, uv_png)
    np.testing.assert_allclose(dist_raw, dist_png, rtol=1e-6)


def test_non_power_of_two_max_batch(dcn):
    """max_batch=12 clamps to the 8-bucket; 16 concurrent clients must not
    wedge the batcher."""
    s = DescriptorServer(dcn, port=0, max_batch=12, max_wait_ms=50.0)
    assert s._max_batch == s._buckets[-1] == 8
    s.start()
    try:
        results, errors = [None] * 16, []

        def worker(i):
            try:
                with DescriptorClient(*s.address, timeout=60.0) as c:
                    results[i] = c.descriptors(_frame(100 + i))
            except Exception as e:  # pragma: no cover - surfaced via errors
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not errors
        assert all(r is not None for r in results)
        assert s.stats["frames"] == 16 and s.stats["dispatches"] >= 2
    finally:
        s.shutdown()


def test_concurrent_clients_microbatch(server, dcn):
    frames = [_frame(10 + i) for i in range(8)]
    expected = [_expected(dcn, f) for f in frames]
    before = dict(server.stats)
    results, errors = [None] * 8, []
    barrier = threading.Barrier(8)

    def worker(i):
        try:
            with _client(server) as c:
                barrier.wait(timeout=30)
                results[i] = c.descriptors(frames[i])
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors
    for got, want in zip(results, expected):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert server.stats["frames"] - before["frames"] == 8
    assert server.stats["dispatches"] - before["dispatches"] < 8, "no cross-request batching"


def test_mixed_descriptor_and_best_match_batch(server, dcn):
    """One coalesced batch: descriptor slices go to their own requests, and
    every request's queries are answered by one best-match call."""
    frames = [_frame(20 + i) for i in range(4)]
    queries = np.random.RandomState(1).randn(2, D).astype(np.float32)
    results = {}
    barrier = threading.Barrier(4)

    def run(i):
        with _client(server) as c:
            barrier.wait(timeout=30)
            results[i] = (c.descriptors(frames[i]) if i % 2 == 0
                          else c.best_match(frames[i], queries))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for i in (0, 2):
        np.testing.assert_allclose(results[i], _expected(dcn, frames[i]), atol=1e-4, rtol=1e-4)
    for i in (1, 3):
        uv, dist = results[i]
        d2 = _d2(_expected(dcn, frames[i]), queries)
        chosen = d2[uv[:, 1] * W + uv[:, 0], np.arange(2)]
        assert np.all(chosen - d2.min(0) <= 1e-5)
        np.testing.assert_allclose(dist, np.sqrt(d2.min(0)), rtol=1e-4, atol=1e-4)


def test_run_batch_direct_invalid_query_slots_are_inf(dcn):
    """A batch of one best_match request with 2 of 16 query slots used plus
    a descriptors request: unused slots answer dist = inf, and the kernel
    wrapper is called once for the batch."""
    s = DescriptorServer(dcn, port=0, max_batch=2)
    try:
        q = np.random.RandomState(5).randn(2, D).astype(np.float32)
        batch = [_Request(_frame(30), q), _Request(_frame(31))]
        calls = []
        real = serve.best_match

        def counting(res, queries):
            calls.append(tuple(res.shape))
            return real(res, queries)

        serve.best_match = counting
        try:
            s._run_batch(batch)
        finally:
            serve.best_match = real
        assert calls == [(2, D, H * W)]
        for r in batch:
            assert r.error is None, r.error
        desc, uv, dist = batch[0].result
        assert desc is None and uv.shape == (16, 2) and dist.shape == (16,)
        assert np.all(np.isinf(dist[2:])) and np.all(np.isfinite(dist[:2]))
        np.testing.assert_allclose(batch[1].result[0], _expected(dcn, _frame(31)),
                                   atol=1e-4, rtol=1e-4)
    finally:
        s.shutdown()


def test_device_errors_reach_every_waiter(dcn, monkeypatch):
    s = DescriptorServer(dcn, port=0, max_batch=2)
    try:
        def boom(res, queries):
            raise RuntimeError("kernel launch failed")
        monkeypatch.setattr(serve, "best_match", boom)
        batch = [_Request(_frame(1), np.zeros((1, D), np.float32)), _Request(_frame(2))]
        s._run_batch(batch)
        assert all(r.event.is_set() and "kernel launch failed" in r.error for r in batch)
    finally:
        s.shutdown()


def test_shutdown_leaves_no_thread_and_fails_queued(dcn):
    before = set(threading.enumerate())
    s = DescriptorServer(dcn, port=0, max_batch=2, max_wait_ms=5.0)
    s.start()
    c = DescriptorClient(*s.address, timeout=30.0)  # left open across shutdown
    assert c.ping()
    s.shutdown()
    left = [t for t in set(threading.enumerate()) - before if t.is_alive()]
    assert not left, left
    with pytest.raises((ConnectionError, OSError)):
        c.ping()
    c.close()
    with pytest.raises(RuntimeError, match="shut down"):
        s._submit(_frame(0))
    # a server that never started shuts down at once
    DescriptorServer(dcn, port=0).shutdown()


def test_cli_rejects_unported_options_and_commands(capsys):
    # the int8 flags are ported: they parse, and the missing folder is the error
    for flag in ("--int8", "--int8_static"):
        with pytest.raises(FileNotFoundError):
            serve.main(["--model_folder", "x", flag, "--device", "cpu"])
        assert "not ported" not in capsys.readouterr().err
    # --model_parallel is ported: it parses, and the missing folder is the error
    with pytest.raises(FileNotFoundError):
        serve.main(["--model_folder", "x", "--model_parallel", "2", "--device", "cpu"])
    assert "not ported" not in capsys.readouterr().err
    # --data_parallel is ported: it parses, and the missing folder is the error
    with pytest.raises(FileNotFoundError):
        serve.main(["--model_folder", "x", "--data_parallel", "--device", "cpu"])
    assert "not ported" not in capsys.readouterr().err
    for flag in ("--tensor_parallel", "--pipeline"):  # ported: the missing config is the error
        with pytest.raises(FileNotFoundError):
            cli.main(["train", "--dataset_config", "x.yaml", flag, "2", "--device", "cpu"])
        assert "not ported" not in capsys.readouterr().err
    for flag in ("--data_parallel", "--fsdp"):  # ported: the missing config is the error
        with pytest.raises(FileNotFoundError):
            cli.main(["train", "--dataset_config", "x.yaml", flag, "--device", "cpu"])
        assert "not ported" not in capsys.readouterr().err
    # every command of pdc_tpu is ported: a command no package has is refused
    assert cli.main(["no-such-command"]) == 2
    err = capsys.readouterr().err
    assert "unknown command 'no-such-command'" in err and "experiment" in err
    with pytest.raises(SystemExit):  # train is ported: it needs its --dataset_config
        cli.main(["train"])
    assert cli.main([]) == 2


def test_cli_serve_needs_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["serve", "--model_folder", str(tmp_path)])


def test_kernel_counter_untouched_on_cpu(server):
    before = bm.launches
    with _client(server) as c:
        c.best_match(_frame(40), np.zeros((2, D), np.float32))
    assert bm.launches == before
