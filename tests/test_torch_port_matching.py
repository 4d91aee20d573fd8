"""Port best-match search (pdc_tpu_torch.ops.matching, .best_match, ._build)
against pdc_tpu.ops.matching and the Pallas kernel in interpret mode.

On the CPU the kernel wrapper runs its plain version; the CUDA kernel itself
is checked on the card (tests/test_torch_port_cuda.py, chip_smoke.py).

Tie tolerance: the port sums the squared differences sum_d (r_d - q_d)^2,
while pdc_tpu expands ||r||^2 - 2<r,q> + ||q||^2, which loses up to a few
eps * (||r||^2 + ||q||^2) to cancellation. Which of two pixels closer than
that wins is not a property of either; the checks below ask that each
side's chosen pixel be within that bound of the true (float64) minimum, and
that distances agree to it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdc_tpu.ops import matching as jm
from pdc_tpu.ops.pallas_kernels import pallas_best_match
from pdc_tpu_torch.ops import _build
from pdc_tpu_torch.ops import best_match as bm
from pdc_tpu_torch.ops import matching as tm

torch.set_num_threads(2)

EPS32 = float(np.finfo(np.float32).eps)


def _true_d2(res_flat, queries):
    """[HW, Q] float64 squared distances."""
    r = res_flat.astype(np.float64)
    q = queries.astype(np.float64)
    return ((r[:, None, :] - q[None, :, :]) ** 2).sum(-1)


def _cancellation_bound(res_flat, queries):
    """Per-query bound on the expansion form's d2 error: 8 eps (max||r||^2 + ||q||^2)."""
    rmax = float((res_flat.astype(np.float64) ** 2).sum(-1).max())
    return 8 * EPS32 * (rmax + (queries.astype(np.float64) ** 2).sum(-1))


def _check_choice(d2, idx, tol):
    chosen = d2[np.asarray(idx), np.arange(d2.shape[1])]
    assert np.all(chosen - d2.min(0) <= tol), (chosen - d2.min(0)).max()


def _data(hw, q, d, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    res = (rng.standard_normal((hw, d)) * scale).astype(np.float32)
    queries = (rng.standard_normal((q, d)) * scale).astype(np.float32)
    return res, queries


# (H, W, Q, D): the Pallas test shapes, a ragged HW (not a multiple of the
# Pallas 2048-pixel tile nor of the CUDA kernel's 1024-pixel chunk), D up to 16
SHAPES = [(32, 64, 8, 3), (48, 64, 16, 8), (50, 100, 4, 3), (33, 65, 5, 16), (7, 9, 3, 1)]


@pytest.mark.parametrize("h,w,q,d", SHAPES)
def test_best_matches_batch_matches_jax_and_pallas(h, w, q, d):
    res, queries = _data(h * w, q, d, seed=h * w + d, scale=2.0)
    uv, dist = tm.best_matches_batch(queries, res.reshape(h, w, d))
    uv, dist = uv.numpy(), dist.numpy()
    assert uv.dtype == np.int32 and uv.shape == (q, 2) and dist.shape == (q,)
    idx = uv[:, 1] * w + uv[:, 0]

    d2 = _true_d2(res, queries)
    tol = _cancellation_bound(res, queries)
    _check_choice(d2, idx, 1e-6 * np.maximum(d2.min(0), 1.0))  # port: relative rounding only
    np.testing.assert_allclose(dist, np.sqrt(d2.min(0)), rtol=1e-6, atol=1e-6)

    juv, jdist = jm.best_matches_batch(jnp.asarray(queries), jnp.asarray(res.reshape(h, w, d)))
    jidx = np.asarray(juv)[:, 1] * w + np.asarray(juv)[:, 0]
    _check_choice(d2, jidx, tol)
    np.testing.assert_allclose(dist ** 2, np.asarray(jdist) ** 2, rtol=0, atol=tol.max())

    pidx, pdist = pallas_best_match(jnp.asarray(res), jnp.asarray(queries), interpret=True)
    _check_choice(d2, np.asarray(pidx), tol)
    np.testing.assert_allclose(dist ** 2, np.asarray(pdist) ** 2, rtol=0, atol=tol.max())


def test_exact_ties_pick_lowest_index():
    """Duplicated descriptors: the lowest flat index wins, as jnp.argmin's."""
    h, w, d = 40, 60, 3
    res = np.zeros((h * w, d), np.float32)
    res[[5, 1200, 2399]] = [1.0, 2.0, 3.0]
    res[[7, 1500]] = [-1.0, 0.5, 0.25]
    queries = np.array([[1.0, 2.0, 3.0], [-1.0, 0.5, 0.25], [0.0, 0.0, 0.0]], np.float32)
    uv, dist = tm.best_matches_batch(queries, res.reshape(h, w, d))
    idx = uv[:, 1] * w + uv[:, 0]
    np.testing.assert_array_equal(idx.numpy(), [5, 7, 0])
    np.testing.assert_array_equal(dist.numpy(), [0.0, 0.0, 0.0])
    juv, _ = jm.best_matches_batch(jnp.asarray(queries), jnp.asarray(res.reshape(h, w, d)))
    np.testing.assert_array_equal(uv.numpy(), np.asarray(juv))


def test_padding_safe():
    """Only the last pixel matches: nothing past HW may win (the Pallas
    kernel pads with sentinels, the CUDA kernel masks its ragged chunk)."""
    hw = 2048 + 77
    res = np.zeros((hw, 3), np.float32)
    res[hw - 1] = 5.0
    uv, dist = tm.best_matches_batch(np.full((1, 3), 5.0, np.float32), res.reshape(1, hw, 3))
    assert int(uv[0, 0]) == hw - 1 and int(uv[0, 1]) == 0
    assert float(dist[0]) == 0.0


def test_masked_plus_1e6_rule_matches_jax():
    h, w, d = 24, 32, 3
    res, queries = _data(h * w, 6, d, seed=3)
    rng = np.random.RandomState(4)
    mask = (rng.uniform(size=(h, w)) > 0.6).astype(np.int32)
    uv, dist = tm.best_matches_batch(queries, res.reshape(h, w, d), mask=mask)
    idx = uv[:, 1] * w + uv[:, 0]
    assert np.all(mask.reshape(-1)[idx.numpy()] == 1)
    d2 = _true_d2(res, queries) + (mask.reshape(-1) == 0)[:, None] * 1e6
    # d2 values reach 1e6 here, where one float32 ulp is 0.06
    _check_choice(d2, idx.numpy(), 1e-6)
    juv, jdist = jm.best_matches_batch(jnp.asarray(queries), jnp.asarray(res.reshape(h, w, d)),
                                       mask=jnp.asarray(mask))
    np.testing.assert_array_equal(uv.numpy(), np.asarray(juv))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=1e-5, atol=1e-5)
    # an all-blocked mask still answers, every pixel at +1e6
    uv0, dist0 = tm.best_matches_batch(queries, res.reshape(h, w, d),
                                       mask=np.zeros((h, w), np.int32))
    assert np.all((uv0[:, 0] < w).numpy() & (uv0[:, 1] < h).numpy())
    assert np.all(dist0.numpy() > 999.0)


def test_single_descriptor_helpers_match_jax():
    h, w, d = 12, 16, 3
    res, queries = _data(h * w, 1, d, seed=9)
    res = res.reshape(h, w, d)
    nd = tm.norm_diffs_for_descriptor(queries[0], res)
    jnd = jm.norm_diffs_for_descriptor(jnp.asarray(queries[0]), jnp.asarray(res))
    np.testing.assert_allclose(nd.numpy(), np.asarray(jnd), rtol=1e-6, atol=1e-6)
    uv, best, nd2 = tm.best_match_for_descriptor(queries[0], res)
    juv, jbest, _ = jm.best_match_for_descriptor(jnp.asarray(queries[0]), jnp.asarray(res))
    np.testing.assert_array_equal(uv.numpy(), np.asarray(juv))
    np.testing.assert_allclose(float(best), float(jbest), rtol=1e-6)
    hm = tm.gaussian_heatmap_from_norm_diffs(nd2, variance=0.05)
    np.testing.assert_allclose(hm.numpy(), np.asarray(
        jm.gaussian_heatmap_from_norm_diffs(jnp.asarray(nd2.numpy()), variance=0.05)),
        rtol=1e-6, atol=1e-37)  # XLA flushes denormals to zero


def test_batched_wrapper_equals_per_image_calls():
    """[B, D, HW] in one call == B single-image calls (the server's batched
    dispatch), and launches stay 0 on the CPU."""
    rng = np.random.RandomState(11)
    res = torch.from_numpy(rng.standard_normal((3, 4, 500)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((3, 7, 4)).astype(np.float32))
    before = bm.launches
    idx, dist = bm.best_match(res, q)
    assert bm.launches == before
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32
    for b in range(3):
        i1, d1 = bm.best_match(res[b:b + 1].contiguous(), q[b:b + 1].contiguous())
        assert torch.equal(i1[0], idx[b]) and torch.equal(d1[0], dist[b])


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "d17", "shape", "device", "dims"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    res = torch.zeros(1, 3, 100)
    q = torch.zeros(1, 2, 3)
    if bad == "dtype":
        res = res.double()
    elif bad == "contiguous":
        res = torch.zeros(1, 100, 3).transpose(1, 2)
    elif bad == "d17":
        res, q = torch.zeros(1, 17, 100), torch.zeros(1, 2, 17)
    elif bad == "shape":
        q = torch.zeros(2, 2, 3)
    elif bad == "device":
        res = torch.zeros(1, 3, 100, device="meta")
    elif bad == "dims":
        res = torch.zeros(3, 100)
    with pytest.raises((ValueError, TypeError)):
        bm.best_match(res, q)


def test_nvcc_lookup_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this host has /usr/local/cuda/bin/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_nvcc_lookup_order(monkeypatch, tmp_path):
    home, path = tmp_path / "home", tmp_path / "path"
    for d in (home / "bin", path):
        d.mkdir(parents=True)
        (d / "nvcc").write_text("#!/bin/sh\n")
        (d / "nvcc").chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setenv("PATH", str(path))
    assert _build.find_nvcc() == str(home / "bin" / "nvcc")
    monkeypatch.delenv("CUDA_HOME")
    assert _build.find_nvcc() == str(path / "nvcc")


def test_library_path_keyed_by_source_and_flags(monkeypatch):
    assert [p.name for p in _build.sources()] == ["best_match.cu", "flash_attention.cu",
                                                  "pooled_hinge.cu"]
    p = _build.library_path("best_match")
    assert p.parent == _build.BUILD_DIR and p.parent.name == "pdc_tpu_torch_kernels"
    assert p.parent.parent.parent == _build.SOURCE_DIR.parent.parent  # <repo>/build/
    assert "code=sm_90a" in " ".join(_build.NVCC_FLAGS)
    # a build with macros is a library of its own
    fa = _build.library_path("flash_attention", ("FLASH_MODE=0", "FLASH_DIM=64"))
    assert fa != _build.library_path("flash_attention")
    assert fa != _build.library_path("flash_attention", ("FLASH_MODE=0", "FLASH_DIM=16"))
    assert fa == _build.library_path("flash_attention", ["FLASH_MODE=0", "FLASH_DIM=64"])
    assert _build._label("flash_attention", ("FLASH_DIM=64",)) == "flash_attention[FLASH_DIM=64]"
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path("best_match") != p


def test_ptxas_report_reads_registers_and_spills(tmp_path, monkeypatch):
    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19hinge_bwdILi3EEEvPKf' "
        "for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_19hinge_bwdILi3EEEvPKf\n"
        "    0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 90 registers, used 1 barriers, 384 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115hinge_bwd_finalEPKf' "
        "for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_115hinge_bwd_finalEPKf\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 20 registers, 384 bytes cmem[0]\n")
    assert _build.ptxas_report(log) == {
        "_ZN12_GLOBAL__N_19hinge_bwdILi3EEEvPKf":
            {"registers": 90, "spill_stores": 4, "spill_loads": 8},
        "_ZN12_GLOBAL__N_115hinge_bwd_finalEPKf":
            {"registers": 20, "spill_stores": 0, "spill_loads": 0}}
    # the log kept beside a built library is read back when this process built nothing
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "build_logs", {})
    assert _build.build_log("pooled_hinge") == ""
    lib = _build.library_path("pooled_hinge")
    _build._log_path(lib).write_text(log)
    assert _build.build_log("pooled_hinge") == log
