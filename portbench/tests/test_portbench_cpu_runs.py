"""Whole runs of each traffic driver on the CPU at a tiny size (the look
for a card skipped, the program's kernels in their plain versions): a
sound run comes out correct, and a run with the timed path broken
underneath comes out not correct, once for each fault the cell can have:
a train step that leaves its state unchanged, a train step that averages
its loss over half of the batch, and a served answer altered where it is
produced. (The cells run on one card: there is no exchange between cards
to leave out.)"""

import pytest
import torch

from portbench.tests.cpu_run import run_cpu, tiny_files

SEED = 2**31 + 12345  # larger than 32 signed bits


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def check_result(res):
    assert set(res) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell", ["train.resnet34_8s", "serve.resnet34_8s.c16",
                                  "serve.resnet34_8s.c1"])
def test_sound_run_is_correct(cell):
    res, _ = run_cpu(cell, seed=SEED, seconds=1.0,
                     files=tiny_files(cell, 3 if cell.endswith("c16") else None))
    check_result(res)
    assert res["correct"], res["checks"]
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2


def unchanged_state(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def half_batch(monkeypatch):
    import pdc_tpu_torch.training.train as program

    whole = program.assemble_batch_matrix

    def half(batch, cfg, generator, device="cuda", composite_every_row=False):
        img_a, img_b, s = whole(batch, cfg, generator, device=device,
                                composite_every_row=composite_every_row)
        mt = s.match_type.clone()
        mt[mt.shape[0] // 2:] = -1  # the second half left out of the mean
        return img_a, img_b, s._replace(match_type=mt)

    monkeypatch.setattr(program, "assemble_batch_matrix", half)


def altered_match(monkeypatch):
    import pdc_tpu_torch.apps.serve as program

    right = program.best_match

    def off_by_one(res, queries):
        idx, dist = right(res, queries)
        return (idx + 1) % res.shape[-1], dist

    monkeypatch.setattr(program, "best_match", off_by_one)


def altered_descriptors(monkeypatch):
    from pdc_tpu_torch.apps.serve import DescriptorServer

    right = DescriptorServer._forward_one

    def scaled(self, *args):
        out, idx, dist = right(self, *args)
        return out * 1.01, idx, dist

    monkeypatch.setattr(DescriptorServer, "_forward_one", scaled)


@pytest.mark.parametrize("cell,fault", [
    ("train.resnet34_8s", unchanged_state), ("train.resnet34_8s", half_batch),
    ("serve.resnet34_8s.c1", altered_match), ("serve.resnet34_8s.c16", altered_descriptors)],
    ids=lambda x: getattr(x, "__name__", x))
def test_broken_run_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    res, _ = run_cpu(cell, seed=SEED, seconds=1.0,
                     files=tiny_files(cell, 3 if cell.endswith("c16") else None))
    assert not res["correct"], res["checks"]
