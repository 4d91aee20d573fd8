"""The port's CUDA kernel on the card: the best-match kernel against its
plain version, its launch counter, and the server's batched best match.

Needs an NVIDIA GPU with nvcc; skips elsewhere. Imports no JAX, so it runs
on a GPU host without the JAX package's dependencies:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from pdc_tpu_torch.ops import best_match as bm

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    # every comparison below is in fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _check(res, q, idx, dist):
    """Tie-tolerant against float64: the chosen pixel's squared distance is
    within 1e-5 of the true minimum, the distance within 1e-4."""
    r = res.double()
    d2 = bm.squared_distances(r, q.double())
    true_min = d2.min(-1).values
    chosen = torch.gather(d2, -1, idx.long()[..., None])[..., 0]
    assert int(((chosen - true_min) > 1e-5).sum()) == 0
    assert float((dist.double() - true_min.sqrt()).abs().max()) <= 1e-4


# (B, D, HW, Q): ragged HW (not a multiple of the 1024-pixel chunk), one pixel,
# every D template (<=4, <=8, <=16), Q across several 16-query groups
@pytest.mark.parametrize("B,D,HW,Q", [(1, 3, 5000, 4), (1, 16, 3072, 8), (3, 1, 1, 5),
                                      (2, 8, 1025, 40), (1, 5, 70000, 17), (4, 3, 4800, 1)])
def test_kernel_matches_plain(cuda, B, D, HW, Q):
    g = np.random.default_rng(B * 1000 + D * 100 + Q)
    res = torch.as_tensor(g.standard_normal((B, D, HW), dtype=np.float32), device=cuda)
    q = torch.as_tensor(g.standard_normal((B, Q, D), dtype=np.float32), device=cuda)
    before = bm.launches
    idx, dist = bm.best_match(res, q)
    torch.cuda.synchronize()
    assert bm.launches == before + 1
    assert idx.dtype == torch.int32 and idx.shape == (B, Q) and dist.shape == (B, Q)
    _check(res, q, idx, dist)
    pidx, pdist = bm.best_match_reference(res, q)
    # same sum of squared differences in the same order; only the FMA rounds differently
    assert float((dist - pdist).abs().max()) <= 1e-4


def test_kernel_ties_and_padding(cuda):
    res = torch.zeros(1, 3, 2048 + 77, device=cuda)
    res[0, :, [5, 1200, 2100]] = 1.0
    res[0, :, 2048 + 76] = 5.0
    q = torch.tensor([[[1.0, 1.0, 1.0], [5.0, 5.0, 5.0], [0.0, 0.0, 0.0]]], device=cuda)
    idx, dist = bm.best_match(res, q)
    assert idx.tolist() == [[5, 2048 + 76, 0]]
    assert dist.tolist() == [[0.0, 0.0, 0.0]]


def test_kernel_raises_instead_of_falling_back(cuda, monkeypatch):
    with pytest.raises(ValueError):
        bm.best_match(torch.zeros(1, 17, 10, device=cuda), torch.zeros(1, 1, 17, device=cuda))

    def no_library():
        raise RuntimeError("no library")
    monkeypatch.setattr(bm, "_library", no_library)
    with pytest.raises(RuntimeError, match="no library"):
        bm.best_match(torch.zeros(1, 3, 10, device=cuda), torch.zeros(1, 1, 3, device=cuda))


def test_server_best_match_runs_the_kernel(cuda):
    from pdc_tpu_torch.apps.serve import DescriptorClient, DescriptorServer
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork

    cfg = {"descriptor_dimension": 3, "image_width": 64, "image_height": 48,
           "backbone": {"model_class": "Resnet", "resnet_name": "Resnet18_8s"}}
    dcn = DenseCorrespondenceNetwork.from_config(cfg)  # default device: cuda
    assert dcn.device.type == "cuda"
    rgb = np.random.default_rng(0).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    res = dcn.forward_on_img(rgb)
    q = res[[3, 20, 40], [5, 30, 60]].cpu().numpy()
    s = DescriptorServer(dcn, port=0, max_batch=2)
    s.start()
    try:
        before = bm.launches
        with DescriptorClient(*s.address, timeout=60.0) as c:
            uv, dist = c.best_match(rgb, q)
            desc = c.descriptors(rgb)
        assert bm.launches == before + 1
    finally:
        s.shutdown()
    np.testing.assert_allclose(desc, res.cpu().numpy(), atol=1e-4, rtol=1e-4)
    planar = res.permute(2, 0, 1).reshape(1, 3, -1).contiguous()
    idx = torch.as_tensor(uv[:, 1] * 64 + uv[:, 0], device=cuda)[None]
    _check(planar, torch.as_tensor(q, device=cuda)[None], idx,
           torch.as_tensor(np.array(dist), device=cuda)[None])
