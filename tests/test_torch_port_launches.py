"""The kernels' launch counters (pdc_tpu_torch.ops.launches) on the CPU:
counts outside a capture, what a recording holds, replays, and the pooled
hinge's plain passes, which are recorded but are no launches. The card's
side (a captured graph's replays) is in tests/test_torch_port_cuda.py."""

import sys
import types

import torch

from pdc_tpu_torch.ops import launches
from pdc_tpu_torch.ops import pooled_hinge as ph


def _family(monkeypatch, name="pdc_test_family"):
    module = types.ModuleType(name)
    module.forward_launches = module.backward_launches = 0
    monkeypatch.setitem(sys.modules, name, module)
    return module


def test_count_adds_to_the_familys_counter_and_to_a_recording(monkeypatch):
    fam = _family(monkeypatch)
    launches.count(fam.__name__, "forward")
    assert (fam.forward_launches, fam.backward_launches) == (1, 0)
    with launches.recording() as rec:
        launches.count(fam.__name__, "forward")
        launches.count(fam.__name__, "backward")
        launches.count(fam.__name__, "backward")
    assert (fam.forward_launches, fam.backward_launches) == (2, 2)
    assert launches.passes(rec, fam.__name__) == {"forward": 1, "backward": 2}
    assert launches.passes(rec, "another") == {"forward": 0, "backward": 0}


def test_recordings_nest_and_replays_add_their_passes(monkeypatch):
    a, b = _family(monkeypatch, "pdc_test_a"), _family(monkeypatch, "pdc_test_b")
    with launches.recording() as outer:
        launches.count(a.__name__, "forward")
        with launches.recording() as inner:
            launches.count(b.__name__, "backward")
        launches.count(a.__name__, "backward")
    assert dict(inner) == {(b.__name__, "backward"): 1}
    assert dict(outer) == {(a.__name__, "forward"): 1, (a.__name__, "backward"): 1}
    launches.count_replays(outer, 3)
    launches.count_replays(inner, 2)
    assert (a.forward_launches, a.backward_launches) == (4, 4)
    assert (b.forward_launches, b.backward_launches) == (0, 3)
    launches.record(a.__name__, "forward")  # outside a recording: nothing
    assert a.forward_launches == 4


def test_plain_passes_are_recorded_but_not_launches():
    g = torch.Generator().manual_seed(0)
    B, Nm, P, D = 1, 5, 6, 3
    da = torch.randn((B, Nm, D), generator=g, requires_grad=True)
    db = torch.randn((B, P, D), generator=g)
    mu, mv, pu, pv = (torch.rand(s, generator=g) * 50 for s in ((B, Nm), (B, Nm), (B, P), (B, P)))
    args = (da, db, mu, mv, torch.ones(B, Nm), pu, pv, torch.ones(B, P))
    before = (ph.forward_launches, ph.backward_launches)
    with launches.recording() as rec:
        loss, _ = ph.pooled_hinge(*args, 0.5, False, 50.0)
        loss.sum().backward()
    assert launches.passes(rec, ph.__name__) == {"forward": 1, "backward": 1}
    assert (ph.forward_launches, ph.backward_launches) == before
