"""chip_smoke.py's device timer (``time_device``) on the CPU: it raises
without a card before calling the timed function, and it never returns a
host-paced reading, with a stand-in for ``torch.cuda`` whose events say
whether the queue drained. Also the on-disk phase's scene tree and its
Paeth-filtered timing file, at 64x48."""

import shutil
from types import SimpleNamespace

import pytest
import torch

import chip_smoke
from pdc_tpu_torch.ops import _build


@pytest.fixture(autouse=True)
def _free_the_folders(tmp_path):
    """The on-disk check writes scene trees: remove them when the test ends, so that a whole run
    leaves no large files in the temporary directory."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_time_device_raises_without_cuda_and_never_falls_back():
    assert not torch.cuda.is_available()
    calls = []
    with pytest.raises(RuntimeError, match="device time"):
        chip_smoke.time_device(torch, lambda: calls.append(1))
    assert calls == []


def fake_torch(drained):
    """``torch.cuda`` as time_device uses it: each reading's start event
    answers ``query()`` with the next value of ``drained``, and every event
    pair reads 8 ms apart."""
    sleeps, answers = [], iter(drained)

    class Event:
        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            pass

        def query(self):
            return next(answers)

        def elapsed_time(self, end):
            return 8.0

    cuda = SimpleNamespace(is_available=lambda: True, synchronize=lambda: None,
                           _sleep=sleeps.append, Event=Event)
    return SimpleNamespace(cuda=cuda), sleeps


def test_time_device_lengthens_the_wait_then_refuses_a_host_paced_reading():
    fake, sleeps = fake_torch([True] * 3)
    calls = []
    with pytest.raises(RuntimeError, match="host-paced"):
        chip_smoke.time_device(fake, lambda: calls.append(1), iters=4, warmup=2, cycles=100,
                               tries=3)
    assert sleeps == [100, 400, 1600] and len(calls) == 2 + 3 * 4


def test_time_device_reads_the_events_once_the_queue_held():
    fake, sleeps = fake_torch([True, False])
    assert chip_smoke.time_device(fake, lambda: None, iters=4, cycles=10) == 2.0
    assert sleeps == [10, 40]


def test_kernel_templates_names_each_kernel_by_its_template():
    """The ptxas report keyed by mangled names, as nvcc gives them for
    kernels in an anonymous namespace, read back as ``name<args>``."""
    ns = "_GLOBAL__N__1a2b3c4d_15_pooled_hinge_cu"
    ns = f"_ZN{len(ns)}{ns}"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{ns}9hinge_fwdILi3EEEvPKfS2_S2_fi'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{ns}15hinge_fwd_finalEPKfPKiPfPxi'",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 30 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{ns}10best_matchILi3ELi32EEEvPKfS2_Pf'",
        "ptxas info    : Used 120 registers, used 1 barriers",
    ])
    build = SimpleNamespace(ptxas_report=_build.ptxas_report, build_log=lambda source: log)
    assert chip_smoke.kernel_templates(build, "pooled_hinge") == {
        "best_match<3,32>": {"registers": 120, "spill_stores": 0, "spill_loads": 0},
        "hinge_fwd<3>": {"registers": 64, "spill_stores": 0, "spill_loads": 0},
        "hinge_fwd_final": {"registers": 30, "spill_stores": 8, "spill_loads": 4}}


def test_on_disk_tree_and_paeth_file_read_back(tmp_path):
    import numpy as np
    from PIL import Image

    from pdc_tpu_torch.data import native_loader as nl
    from pdc_tpu_torch.data.dataset import SpartanDataset
    from pdc_tpu_torch.utils.yaml_io import load_yaml

    record = {"synthetic": dict(chip_smoke.DATASET_RECORD["synthetic"], width=64, height=48,
                                num_frames=3)}
    composite, scenes = chip_smoke.write_tree(str(tmp_path), record)
    ds = SpartanDataset(config=load_yaml(composite), data_dir=str(tmp_path),
                        config_dir=str(tmp_path / "config" / "composite"))
    assert ds.get_scene_list() == ["scene_000", "scene_001"]
    assert ds.get_list_of_objects() == ["object_0", "object_1"]
    for name, sc in scenes.items():
        rgb, depth, mask, poses = sc.render_all()
        got = ds.get_scene(name)
        np.testing.assert_array_equal(got.rgb, rgb)
        np.testing.assert_array_equal(got.depth, depth)
        np.testing.assert_allclose(got.poses, poses, rtol=0, atol=1e-12)
    frame = scenes["scene_000"].render(1)[0]
    path = str(tmp_path / "paeth.png")
    chip_smoke.write_paeth_png(np, path, frame)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), frame)
    out = np.zeros_like(frame)
    nl.decode_batch([(path, nl.KIND_RGB8, out)], 48, 64, decoder="zlib")
    np.testing.assert_array_equal(out, frame)


def test_attention_bound_is_the_products_at_the_ffma_peak():
    """K4's bound at the ViT cell's block: 6 products of 2 N^2 d operations a
    head (2 forward, 4 backward) at 67 TFLOP/s, 3.83 ms a block (91.84 ms
    for the 24 blocks of a step), bound by operations; 1.55 ms at the
    split-fp32 rate."""
    fwd_ms, fwd_by, fwd_split = chip_smoke.attention_bound(8, 16, 1615, 64, backward=False)
    bwd_ms, bwd_by, bwd_split = chip_smoke.attention_bound(8, 16, 1615, 64, backward=True)
    assert fwd_by == bwd_by == "operations"
    assert abs(bwd_ms - 2 * fwd_ms) < 1e-9
    assert abs(24 * (fwd_ms + bwd_ms) - 91.84) < 0.01
    assert abs(fwd_split + bwd_split - 1.554) < 0.001


def test_attention_entries_name_each_pass():
    k4 = {"launches": (40, 40), "err": {"o": 1e-6, "dq": 2e-6}}
    for kind in ("fwd", "bwd"):
        k4.update({f"{kind}_ms": 1.0, f"{kind}_wrapper_ms": 1.1, f"plain_{kind}_ms": 5.0,
                   f"bound_{kind}_ms": 0.5, f"bound_{kind}_by": "operations",
                   f"split_fp32_{kind}_ms": 0.2, f"library_{kind}_ms": 2.0})
    fwd, bwd = chip_smoke.attention_entries(k4)
    assert (fwd["name"], bwd["name"]) == ("flash_attention_fwd", "flash_attention_bwd")
    assert fwd["source"] == bwd["source"] == "pdc_tpu_torch/csrc/flash_attention.cu"
    assert fwd["launches"] == bwd["launches"] == 40 and fwd["max_abs_err"] == 2e-6
