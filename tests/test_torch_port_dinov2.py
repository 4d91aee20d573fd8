"""The port's DINOv2 backbone (``pdc_tpu_torch.models.dinov2``, ``backbone:
{model_class: Dinov2}``) against the benchmark's plain reference
(``portbench.reference.dinov2``) on seeded weights
(``portbench.weights_dinov2``), at a tiny size on the CPU: the backbone's
forward and gradients, the network that ``from_config`` builds, the first
scanned train step, the trainer's run and the descriptor server. A fault
planted in the reference (registers dropped, LayerScale left out,
positions resized bilinearly or without antialias, the wrong attention
scale) fails the forward comparison. The layers that cannot hold the
backbone refuse it by name.

The attention's plain version (``ops/flash_attention.py``, which the CPU
runs; the card runs its kernels) is held to a float64 softmax at the tiny
widths with a ragged token count, forward and gradient, and the port's
block to the reference's.

Tolerances: program and reference compute in float32 with different
summation orders (the attention's products on ``[B, N, 3, heads, d]``
views against ``softmax(q k^T) v`` on permuted heads, ``F.linear``
against ``nn.Linear``); their outputs and gradients part by about 1e-6 of
their largest magnitude here, so the comparisons allow 1e-4 of it, while
every fault moves them by more than 1e-3."""

import copy
import math
import shutil
import time

import numpy as np
import pytest
import torch

import portbench.reference.dinov2 as reference
from pdc_tpu_torch.apps.serve import DescriptorServer
from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork, build_backbone
from pdc_tpu_torch.models.dinov2 import DEFAULTS, Dinov2FCN
from pdc_tpu_torch.ops import flash_attention as fa
from portbench import harness
from portbench.reference.descriptors import best_matches
from portbench.reference.train_step import normalize
from portbench.weights_dinov2 import make_weights

torch.set_num_threads(2)

W, H, D = 64, 48, 3  # padded to 70x56: 5x4 patches, N = 25 tokens
TINY = dict(DEFAULTS, embed_dim=64, depth=2, num_heads=4, pos_grid=8)
NET = {"descriptor_dimension": D, "image_width": W, "image_height": H,
       "backbone": {"model_class": "Dinov2", **TINY}}
SEED = 2**31 + 7
# relative to the reference's largest magnitude; see the module docstring
TOL = 1e-4


@pytest.fixture(autouse=True)
def _free_the_folders(tmp_path):
    """The trainer's run and the checkpoint test write model folders: remove them when the test
    ends, so that a whole run leaves no files in the temporary directory."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def rel_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


@pytest.fixture(scope="module")
def weights():
    return make_weights(D, TINY, SEED, "cpu")


@pytest.fixture(scope="module")
def port(weights):
    m = build_backbone(NET)
    m.load_state_dict(weights)
    return m


def ref_model(weights):
    m = reference.Dinov2FCN(D, **TINY)
    m.load_state_dict(weights)
    return m


def images(n=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, H, W, 3), generator=g, dtype=torch.uint8)


def test_published_widths_by_default():
    with torch.device("meta"):
        m = build_backbone({"descriptor_dimension": 3, "backbone": {"model_class": "Dinov2"}})
    assert isinstance(m, Dinov2FCN) and len(m.blocks) == 24
    b = m.blocks[0]
    assert b.attn.qkv.weight.shape == (3072, 1024) and b.attn.qkv.bias is not None
    assert b.attn.num_heads == 16 and b.attn.scale == 1 / 8
    assert b.mlp.fc1.weight.shape == (4096, 1024) and b.norm1.eps == 1e-6
    assert m.patch_embed.proj.kernel_size == (14, 14) and m.patch_embed.proj.stride == (14, 14)
    assert m.register_tokens.shape == (1, 4, 1024) and m.pos_embed.shape == (1, 1 + 37 * 37, 1024)
    assert round(sum(p.numel() for p in m.parameters()) / 1e6, 2) == 304.37


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_forward_matches_reference(port, weights, mode):
    x = normalize(images()).permute(0, 3, 1, 2).contiguous()
    ref = ref_model(weights)
    getattr(port, mode)()
    with torch.no_grad():
        got, want = port(x), ref(x)
    port.eval()
    assert got.shape == want.shape == (2, D, H, W)
    assert rel_err(got, want) < TOL


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_reference(weights, remat):
    x = normalize(images(seed=1)).permute(0, 3, 1, 2).contiguous()
    port = build_backbone(dict(NET, remat=remat))
    port.load_state_dict(weights)
    ref = ref_model(weights)
    r = torch.randn((2, D, H, W), generator=torch.Generator().manual_seed(3))
    grads = {}
    for name, m in (("port", port), ("ref", ref)):
        m.zero_grad(set_to_none=True)
        m.train()
        (m(x) * r).sum().backward()
        grads[name] = {k: p.grad.clone() for k, p in m.named_parameters()}
    assert set(grads["port"]) == set(grads["ref"])
    for k, g in grads["ref"].items():
        assert g.abs().max() > 0, k  # every parameter takes part, the positions included
        assert rel_err(grads["port"][k], g) < TOL, k


def float64_attention(qkv, heads, scale):
    """``softmax(q k^T * scale) v`` in float64, each step written out."""
    B, N, C3 = qkv.shape
    q, k, v = qkv.double().reshape(B, N, 3, heads, C3 // 3 // heads).unbind(2)
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    e = torch.exp(s - s.max(-1, keepdim=True).values)
    return torch.einsum("bhnm,bmhd->bnhd", e / e.sum(-1, keepdim=True), v).reshape(B, N, -1)


# the tiny widths' 4 heads of 16 at 25 tokens (64x48), and a ragged 21
@pytest.mark.parametrize("N", [25, 21])
def test_plain_attention_matches_float64(N):
    g = torch.Generator().manual_seed(N)
    heads, d = 4, 16
    qkv = torch.randn((2, N, 3 * heads * d), generator=g, requires_grad=True)
    do = torch.randn((2, N, heads * d), generator=g)
    before = fa.forward_launches
    o = fa.flash_attention(qkv, heads, d ** -0.5)
    assert fa.forward_launches == before  # the CPU runs the plain version: no kernel
    want = float64_attention(qkv.detach(), heads, d ** -0.5)
    assert o.shape == (2, N, heads * d) and rel_err(o.detach(), want) < 1e-5
    (got_g,) = torch.autograd.grad(o, qkv, do)
    x = qkv.detach().double().requires_grad_(True)
    (want_g,) = torch.autograd.grad(float64_attention(x, heads, d ** -0.5), x, do.double())
    assert rel_err(got_g, want_g) < 1e-5


def test_plain_attention_bf16_keeps_dtype():
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn((2, 21, 3 * 64), generator=g)
    got = fa.flash_attention(qkv.bfloat16(), 4, 0.25)
    assert got.dtype == torch.bfloat16
    # bfloat16 inputs and probabilities: 8 bits of mantissa
    assert rel_err(got.float(), float64_attention(qkv, 4, 0.25)) < 2e-2


def test_block_matches_reference(weights):
    """One pre-norm block of the port against the reference's, outputs and
    every parameter's gradient, on random tokens with a ragged count."""
    port = build_backbone(NET)
    port.load_state_dict(weights)
    ref = ref_model(weights)
    x = torch.randn((2, 21, TINY["embed_dim"]), generator=torch.Generator().manual_seed(2))
    r = torch.randn_like(x)
    out, grads = {}, {}
    for name, block in (("port", port.blocks[1]), ("ref", ref.blocks[1])):
        xi = x.clone().requires_grad_(True)
        y = block(xi)
        block.zero_grad(set_to_none=True)
        (y * r).sum().backward()
        out[name] = (y.detach(), xi.grad)
        grads[name] = {k: p.grad for k, p in block.named_parameters()}
    assert rel_err(out["port"][0], out["ref"][0]) < TOL
    assert rel_err(out["port"][1], out["ref"][1]) < TOL
    assert set(grads["port"]) == set(grads["ref"])
    for k, g in grads["ref"].items():
        assert rel_err(grads["port"][k], g) < TOL, k


def test_no_library_attention_in_the_port():
    """The port's attention goes only through ops/flash_attention.py: no
    ``scaled_dot_product_attention`` call remains in the package."""
    import pathlib

    import pdc_tpu_torch

    root = pathlib.Path(pdc_tpu_torch.__file__).parent
    callers = [str(p.relative_to(root)) for p in root.rglob("*.py")
               if "scaled_dot_product_attention(" in p.read_text()]
    assert callers == []


def drop_registers(monkeypatch, model):
    monkeypatch.setattr(model, "register_tokens",
                        torch.nn.Parameter(model.register_tokens.detach()[:, :0]))


def no_layer_scale(monkeypatch, model):
    monkeypatch.setattr(reference.LayerScale, "forward", lambda self, x: x)


def resize_with(mode, antialias):
    def fault(monkeypatch, model):
        monkeypatch.setattr(reference, "resize_positions", lambda g, gh, gw: (
            torch.nn.functional.interpolate(g, size=(gh, gw), mode=mode, antialias=antialias,
                                            align_corners=False)))
    fault.__name__ = f"positions_{mode}_antialias_{antialias}"
    return fault


def wrong_scale(monkeypatch, model):
    right = reference.attention
    monkeypatch.setattr(reference, "attention", lambda q, k, v, scale: right(
        q, k, v, 1.0 / math.sqrt(q.shape[-1] * q.shape[1])))


@pytest.mark.parametrize("fault", [drop_registers, no_layer_scale,
                                   resize_with("bilinear", True), resize_with("bicubic", False),
                                   wrong_scale], ids=lambda f: f.__name__)
def test_fault_fails_the_forward_comparison(port, weights, monkeypatch, fault):
    x = normalize(images()).permute(0, 3, 1, 2).contiguous()
    ref = ref_model(weights)
    fault(monkeypatch, ref)
    with torch.no_grad():
        got, want = port(x), ref(x)
    assert rel_err(got, want) > 10 * TOL


def test_positions_kept_only_in_eval_without_gradients(weights):
    m = build_backbone(NET)
    m.load_state_dict(weights)
    x = normalize(images()).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        first = m(x)
        assert list(m._positions) == [(4, 5)]
        kept = m._positions[(4, 5)][1]
        m(x)
        assert m._positions[(4, 5)][1] is kept
        m.pos_embed.mul_(0.5)  # written in place: resized anew
        halved = m(x)
        assert m._positions[(4, 5)][1] is not kept
    m.load_state_dict(weights)
    with torch.no_grad():
        assert torch.equal(m(x), first)
        assert not torch.equal(halved, first)
    m._positions.clear()
    m.train()
    with torch.no_grad():
        m(x)
    m.eval()
    m(x)  # with gradients
    assert not m._positions


def test_from_config_seeded_and_matches_reference(weights):
    a = DenseCorrespondenceNetwork.from_config(NET, generator=torch.Generator().manual_seed(4),
                                               device="cpu")
    b = DenseCorrespondenceNetwork.from_config(NET, generator=torch.Generator().manual_seed(4),
                                               device="cpu")
    sa, sb = a.module.state_dict(), b.module.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert float(sa["pos_embed"].std()) == pytest.approx(0.02, rel=0.2)
    assert torch.all(sa["blocks.0.ls1.gamma"] == 1.0)
    a.module.load_state_dict(weights)
    frames = images(3, seed=5)
    got = a.forward_on_images(frames.numpy()).permute(0, 3, 1, 2)
    with torch.no_grad():
        want = ref_model(weights)(normalize(frames).permute(0, 3, 1, 2).contiguous())
    assert rel_err(got, want) < TOL


def test_checkpoint_round_trip(weights, tmp_path):
    dcn = DenseCorrespondenceNetwork.from_config(NET, device="cpu")
    dcn.module.load_state_dict(weights)
    path = str(tmp_path / "000001.ckpt")
    dcn.save_checkpoint(path)
    back = DenseCorrespondenceNetwork.from_config(NET, device="cpu")
    back.load_checkpoint(path)
    for k, v in back.module.state_dict().items():
        assert torch.equal(v, weights[k]), k


def tiny_cell_files():
    files = harness.cell_files("train.dinov2_vitl14_reg")
    cfg = copy.deepcopy(files["config"])
    cfg["scenes"].update(num_scenes=2, frames_per_scene=4, width=W, height=H)
    cfg["dense_correspondence_network"].update(image_width=W, image_height=H)
    cfg["dense_correspondence_network"]["backbone"].update(TINY)
    cfg["training"].update(num_matching_attempts=200, masked_pool_size=64,
                           background_pool_size=64, num_blind_samples=100)
    wl = copy.deepcopy(files["workload"])
    wl["params"].update(batch_size=2, steps_per_dispatch=2, logging_rate=4)
    return dict(files, config=cfg, workload=wl)


def test_first_scanned_train_step_matches_reference():
    """The device-sampler route's scanned step (one step a call here) against
    the reference's step from the same seed, weights and scenes: the loss,
    the gradients as Adam took them, and the change in the parameters."""
    from portbench.scenes import make_scenes
    from portbench.seeds import torch_generator
    from portbench.traffic import train as T
    from portbench.traffic import train_vit as V

    files = tiny_cell_files()
    ctx = harness.Context("train.dinov2_vitl14_reg", files, SEED, 1.0, False,
                          torch.device("cpu"), time.perf_counter())
    tc = T.training_config(ctx.config, ctx.params)
    scenes = make_scenes(ctx.seed, ctx.config["scenes"], ctx.device)
    state, step, _ = T.build_program(ctx, scenes, make_weights(D, TINY, SEED, "cpu"), tc)
    program = T.checked_steps(state, step, torch_generator(SEED, "train", ctx.device), 1)
    ref = V.reference_steps(ctx, scenes, tc, 1)
    assert math.isfinite(program["losses"][0]) and program["losses"][0] > 0
    gaps = T.compare(program, ref)
    # the gradient's and the change's gaps are taken leaf by leaf against the
    # reference's norms (portbench.traffic.train.compare); float32 round-off
    assert gaps["first_loss_gap"] < TOL and gaps["grad_gap"] < TOL, gaps
    assert gaps["change_gap"] < 1e-3, gaps
    bad = V.reference_steps(ctx, scenes, tc, 1, batch_fraction=0.5)
    assert T.compare(program, bad)["first_loss_gap"] > 100 * TOL


def test_trainer_run_and_server_answers(tmp_path, weights):
    """The trainer's run (device-sampler route, the CPU's eager K steps) on a
    Dinov2 config writes a model folder; the descriptor server then serves
    it, and its descriptors and best matches are the reference's on the
    folder's weights."""
    from pdc_tpu_torch.training.train import ROUTE_DEVICE_SAMPLER, DenseCorrespondenceTraining
    from portbench.scenes import make_scenes
    from portbench.traffic.train import program_dataset

    files = tiny_cell_files()
    cfg = {k: copy.deepcopy(files["config"][k])
           for k in ("training", "loss_function", "dense_correspondence_network")}
    cfg["training"].update(batch_size=2, steps_per_dispatch=2, num_iterations=2,
                           logging_rate=2, save_rate=2, logging_dir=str(tmp_path),
                           logging_dir_name="vit", use_tensorboard=False,
                           compute_test_loss=False)
    scenes = make_scenes(SEED, files["config"]["scenes"], torch.device("cpu"))
    trainer = DenseCorrespondenceTraining(cfg, dataset=program_dataset(scenes), device="cpu")
    folder = trainer.run()
    assert trainer.route == ROUTE_DEVICE_SAMPLER

    dcn = DenseCorrespondenceNetwork.from_model_folder(folder, device="cpu")
    assert isinstance(dcn.module, Dinov2FCN)
    trained = dcn.module.state_dict()
    ref = reference.Dinov2FCN(D, **TINY)
    ref.load_state_dict(trained)
    server = DescriptorServer(dcn, max_batch=4, max_wait_ms=20.0)
    server.warmup()
    server.start()
    try:
        frames = images(2, seed=9).numpy()
        with torch.no_grad():
            want = ref(normalize(torch.as_tensor(frames)).permute(0, 3, 1, 2).contiguous())
        want = want.permute(0, 2, 3, 1)
        desc = server._submit(frames[0]).result[0]
        assert rel_err(torch.as_tensor(desc), want[0]) < TOL
        pts = [(5, 7), (60, 40), (33, 20)]
        queries = np.stack([want[1, v, u].numpy() for u, v in pts]).astype(np.float32)
        uv, dist = server._submit(frames[1], queries).result[1:]
        ref_uv, ref_dist = best_matches(want[1], torch.as_tensor(queries))
        np.testing.assert_array_equal(uv[:3], ref_uv.numpy())
        assert np.abs(dist[:3] - ref_dist.numpy()).max() < TOL
    finally:
        server.shutdown()


def test_compute_dtype_bfloat16(port, weights):
    m = build_backbone(dict(NET, compute_dtype="bfloat16"))
    m.load_state_dict(weights)
    x = normalize(images()).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        got, want = m(x), port(x)
    assert got.dtype == torch.bfloat16
    # bfloat16 keeps 8 bits of mantissa: a few percent of the largest value
    assert rel_err(got.float(), want) < 5e-2


def _quantized(dcn):
    dcn.quantized()


def _calibrated(dcn):
    dcn.calibrate_quantization([np.zeros((H, W, 3), np.uint8)])


def _tensor_parallel(dcn):
    from pdc_tpu_torch.parallel.tensor_parallel import LocalChannels, shard_channels

    shard_channels(dcn.module, LocalChannels([torch.device("cpu")]))


def _pipeline(dcn):
    from pdc_tpu_torch.parallel.pipeline import pack_pipeline_variables

    pack_pipeline_variables(dcn.module, 2)


@pytest.mark.parametrize("refused", [_quantized, _calibrated, _tensor_parallel, _pipeline],
                         ids=lambda f: f.__name__.strip("_"))
def test_layers_without_the_backbone_refuse_it(refused):
    dcn = DenseCorrespondenceNetwork.from_config(NET, device="cpu")
    with pytest.raises(ValueError, match="Dinov2"):
        refused(dcn)


@pytest.mark.parametrize("extra", [{"quant_int8": True}, {"dilated_s2b": True},
                                   {"backbone": dict(NET["backbone"], pretrained=True)},
                                   {"backbone": dict(NET["backbone"], drop_path=0.1)}],
                         ids=["quant_int8", "dilated_s2b", "pretrained", "unknown_key"])
def test_build_backbone_refuses_what_the_vit_lacks(extra):
    with pytest.raises(ValueError, match="Dinov2"):
        build_backbone(dict(NET, **extra))
