"""The ``train.dinov2_vitl14_reg`` cell's own files: the frozen arithmetic of
``count/dinov2.py`` against multiply-adds counted on the tiny reference
model, the two readers on synthetic records, whole tiny runs of the
``train_vit`` driver on the CPU (sound: correct; a step that leaves its
state unchanged or averages its loss over half the batch: not correct),
and, on a card, the cell's comparison at a test size (the control and the
fault not correct) and the configuration served through
``DescriptorServer`` against the reference's descriptors."""

import copy
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import portbench.reference.dinov2 as reference
from portbench import harness
from portbench.count import dinov2 as count
from portbench.tests.cpu_run import run_cpu
from portbench.tests.test_portbench_cpu_runs import SEED, half_batch, unchanged_state
from portbench.traffic import train_vit
from portbench.weights_dinov2 import make_weights

CELL = "train.dinov2_vitl14_reg"
TINY_WIDTHS = {"embed_dim": 64, "depth": 2, "num_heads": 4, "pos_grid": 8}
PKG = harness.PKG


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def tiny_files() -> dict:
    files = harness.cell_files(CELL)
    cfg = copy.deepcopy(files["config"])
    cfg["scenes"].update(num_scenes=2, frames_per_scene=4, width=64, height=48)
    cfg["dense_correspondence_network"].update(image_width=64, image_height=48)
    cfg["dense_correspondence_network"]["backbone"].update(TINY_WIDTHS)
    cfg["training"].update(num_matching_attempts=200, masked_pool_size=64,
                           background_pool_size=64, num_blind_samples=100)
    wl = copy.deepcopy(files["workload"])
    wl["params"].update(batch_size=2, steps_per_dispatch=2, logging_rate=4)
    return dict(files, config=cfg, workload=wl)


def tiny_model():
    m = reference.Dinov2FCN(3, **TINY_WIDTHS)
    m.load_state_dict(make_weights(3, TINY_WIDTHS, 5, "cpu"))
    return m


def test_forward_count_matches_hooked_multiply_adds(monkeypatch):
    """Each linear layer and the patch embedding by a forward hook, the
    attention's two products by a wrapper of the reference's
    ``attention``: twice their multiply-adds equal the count, layer by
    layer kind."""
    m, frames, (H, W) = tiny_model(), 3, (48, 64)
    macs = {}

    def hook(name):
        def count_macs(module, args, out):
            per = module.weight[0].numel()  # multiply-adds per output element
            macs[name] = macs.get(name, 0) + out.numel() * per
        return count_macs

    for name, mod in m.named_modules():
        if isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d)):
            mod.register_forward_hook(hook(name.rsplit(".", 1)[-1] if "blocks" in name
                                           else name.split(".")[0]))
    right = reference.attention

    def attention(q, k, v, scale):
        macs["qk"] = macs.get("qk", 0) + q.shape[0] * q.shape[1] * q.shape[2] ** 2 * q.shape[3]
        macs["pv"] = macs.get("pv", 0) + q.shape[0] * q.shape[1] * q.shape[2] ** 2 * q.shape[3]
        return right(q, k, v, scale)

    monkeypatch.setattr(reference, "attention", attention)
    with torch.no_grad():
        m(torch.randn(frames, 3, H, W))
    want = {}
    for name, flops in count.layers(TINY_WIDTHS, H, W, 3):
        key = name.rsplit(".", 1)[-1]
        want[key] = want.get(key, 0) + frames * flops
    assert {k: 2 * v for k, v in macs.items()} == want
    assert sum(want.values()) == frames * count.forward_flops(TINY_WIDTHS, H, W, 3)


def test_train_step_count_matches_flop_counter(monkeypatch):
    """Forward and backward under ``FlopCounterMode`` (the blocks not
    recomputed, as the program runs them): the count of a train step."""
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda fn, x, use_reentrant: fn(x))
    m, frames = tiny_model(), 4
    with FlopCounterMode(display=False) as fc:
        (m(torch.randn(frames, 3, 48, 64)) ** 2).sum().backward()
    assert fc.get_total_flops() == count.train_step_flops(TINY_WIDTHS, 48, 64, 3, frames)


def test_cell_sized_counts():
    """At 480x640 and 8 frames: 1615 tokens, 1.234 TFLOP a frame's forward,
    29.6 TFLOP a step, and the attention bound by its FLOPs at 91.8 ms."""
    assert count.shapes({}, 480, 640)["N"] == 1615
    assert count.forward_flops({}, 480, 640, 3) == 1233774981120
    assert count.train_step_flops({}, 480, 640, 3, 8) == 29595089141760
    work = count.attention_work({}, 480, 640, 8)
    assert work == {"flops": 6153574809600, "bytes": 10160701440}
    assert count.attention_bound_s(work) == pytest.approx(0.0918444, rel=1e-6)


def test_readers_on_synthetic_records():
    mfu = harness.load_module(PKG / "metrics" / "dinov2.mfu.train.py", "r_mfu")
    roof = harness.load_module(PKG / "metrics" / "dinov2.attn_roofline.py", "r_roof")
    # 30 steps of 2 blocks in the trace, 20 of them counted in the window
    kernels = [("fmha_cutlassF_f32_aligned_64x64_rf_sm80(Params)", 0.0, 5e4, (1, 1, 1)),
               ("fmha_cutlassB_f32_aligned_64x64_k64_sm80(Params)", 0.0, 1.5e5, (1, 1, 1)),
               ("ampere_sgemm_128x64_tn", 0.0, 5e6, (1, 1, 1))] * 60
    record = {"steps": 20, "window_seconds": 10.0, "dinov2_step_flops": 3.35e13,
              "dinov2_attention_work": {"flops": 6.7e12, "bytes": 1e9},
              "config": {"dense_correspondence_network": {"backbone": {"depth": 2}}},
              "trace": {"kernels": kernels}}
    assert mfu.read(record) == pytest.approx(100.0)
    assert roof.read(record) == pytest.approx(25.0)  # 30 x 0.1 s over 60 x 0.2 s
    assert roof.read(dict(record, trace={"kernels": kernels[2::3]})) is None
    for reader in (mfu, roof):
        assert reader.read({"steps": 20, "window_seconds": 10.0}) is None


def test_sound_run_is_correct():
    res, out = run_cpu(CELL, seed=SEED, seconds=1.0, files=tiny_files(), traffic=train_vit)
    assert list(res)[-1] == "checks" and res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "train_pairs_per_s"}
    assert out["dinov2_step_flops"] == count.train_step_flops(
        dict(TINY_WIDTHS, patch_size=14), 48, 64, 3, 4)


@pytest.mark.parametrize("fault", [unchanged_state, half_batch], ids=lambda f: f.__name__)
def test_broken_run_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res, _ = run_cpu(CELL, seed=SEED, seconds=1.0, files=tiny_files(), traffic=train_vit)
    assert not res["correct"], res["checks"]


@pytest.mark.card
def test_program_correct_and_control_and_fault_not(cuda):
    from portbench import control, control_vit

    ctx = harness.Context(CELL, tiny_files(), 2**31 + 99, 2.0, False, cuda, time.perf_counter())
    readings = control_vit.readings(ctx, True)
    verdict = control.judged(readings, ctx.limits)
    assert verdict.pop("program"), readings
    assert verdict == {"control_tf32": False, "fault_half_batch": False}, readings


@pytest.mark.card
def test_served_descriptors_and_matches_are_the_reference_s(cuda):
    """The configuration at its published widths and 640x480, served by an
    in-process ``DescriptorServer`` (batches of up to 8): its descriptor
    images and best matches against the reference's descriptors of the
    same frames, by ``check_answers``' measures. Limits: the float32
    program differs from the reference by summation order only (fused
    attention, GEMM tiling), which reads under 5e-6 on an H100; 1e-4
    leaves twenty times that, and the reference's own forward in TF32
    reads above it."""
    import numpy as np

    from pdc_tpu_torch.apps.serve import DescriptorServer
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork, build_backbone
    from portbench.reference.descriptors import check_answers, descriptor_images
    from portbench.scenes import make_scenes

    cfg = harness.cell_files(CELL)["config"]
    net = cfg["dense_correspondence_network"]
    widths = train_vit.widths(net)
    weights = make_weights(3, widths, 11, cuda)
    with torch.device(cuda):
        module = build_backbone(net)
    module.load_state_dict(weights)
    dcn = DenseCorrespondenceNetwork(module, 3, net["image_width"], net["image_height"],
                                     device=cuda)
    scenes = make_scenes(11, dict(cfg["scenes"], num_scenes=1, frames_per_scene=6), cuda)
    frames = scenes.rgb.cpu().numpy()
    server = DescriptorServer(dcn, max_batch=8, max_wait_ms=5.0, max_queries=16)
    server.warmup()
    server.start()
    try:
        served = [(i, server._submit(frames[i]).result[0]) for i in range(3)]
        model = reference.Dinov2FCN(3, **widths).to(cuda).eval()
        model.load_state_dict(weights)
        ref = descriptor_images(model, torch.as_tensor(frames, device=cuda))
        g = torch.Generator().manual_seed(3)
        matches = []
        for i in range(3, 6):
            pix = torch.randint(0, 480 * 640, (16,), generator=g)
            q = ref[i - 3].reshape(-1, 3)[pix.to(cuda)].cpu().numpy().astype(np.float32)
            uv, dist = server._submit(frames[i], q).result[1:]
            matches.append((i, q, uv, dist))
    finally:
        server.shutdown()
    numbers = check_answers(ref, matches, served)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        low = descriptor_images(model, torch.as_tensor(frames[:3], device=cuda))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tf32 = check_answers(ref, [], [(i, low[i].cpu().numpy()) for i in range(3)])
    print("served against the reference:", numbers, "the reference in TF32:", tf32)
    assert tf32["desc_err"] > 1e-4
    assert numbers["desc_err"] < 1e-4 and numbers["match_gap"] < 1e-4
    assert numbers["dist_err"] < 1e-4
