"""The port's serving export (pdc_tpu_torch.apps.export_serving, through
``torch.export``) against the live network and against pdc_tpu's
``jax.export`` program on the same weights, on the CPU at 64x48 with
ResNet-18-8s, D=3.

Tolerances: 1e-4 (relative, and absolute at the descriptors' scale) between
the program and the live network or pdc_tpu's program: the same float32
operations, traced or not, and across frameworks within 2e-5 of the scale
(tests/test_torch_port_dcn.py); 1e-6 between two loads of one artifact.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdc_tpu.apps import export_serving as j_export
from pdc_tpu.models.dcn import DenseCorrespondenceNetwork as JaxDCN
from pdc_tpu_torch import __main__ as cli
from pdc_tpu_torch.apps import export_serving as export
from pdc_tpu_torch.models.convert import flax_to_state_dict
from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
from pdc_tpu_torch.utils.yaml_io import save_yaml

torch.set_num_threads(2)

W, H, D = 64, 48, 3
NET_CFG = {"descriptor_dimension": D, "image_width": W, "image_height": H,
           "backbone": {"model_class": "Resnet", "resnet_name": "Resnet18_8s"}}
TOL = 1e-4


@pytest.fixture(scope="module")
def nets():
    jdcn = JaxDCN.from_config(NET_CFG, rng=jax.random.PRNGKey(5))
    dcn = DenseCorrespondenceNetwork.from_config(jdcn.config, device="cpu")
    dcn.module.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jdcn.variables)))
    return jdcn, dcn


@pytest.fixture(scope="module")
def artifact(nets, tmp_path_factory):
    """The port's program at B=2, saved once."""
    _, dcn = nets
    path = str(tmp_path_factory.mktemp("export") / "net_b2.pt2")
    exported = export.export_inference(dcn, batch_size=2)
    return exported, path, export.save_exported(exported, path)


def _frames(seed, n=2):
    return np.random.RandomState(seed).randint(0, 256, (n, H, W, 3), dtype=np.uint8)


def _run(program, rgb):
    with torch.inference_mode():
        return program.module()(torch.from_numpy(rgb)).numpy()


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * float(np.abs(want).max()))


def test_round_trip_matches_the_live_network(nets, artifact):
    _, dcn = nets
    exported, path, nbytes = artifact
    rgb = _frames(0)
    out = _run(exported, rgb)
    assert out.shape == (2, H, W, D) and out.dtype == np.float32
    live = np.stack([dcn.forward_on_img(f).numpy() for f in rgb])
    _close(out, live)
    assert nbytes == os.path.getsize(path) and nbytes > 1e6  # the weights are in it
    first, second = _run(export.load_exported(path), rgb), _run(export.load_exported(path), rgb)
    np.testing.assert_allclose(first, out, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(second, first, rtol=1e-6, atol=1e-6)


def test_program_equals_the_jax_exported_program(nets, artifact):
    jdcn, _ = nets
    exported, _, _ = artifact
    rgb = _frames(1)
    want = np.asarray(j_export.export_inference(jdcn, batch_size=2).call(jnp.asarray(rgb)))
    _close(_run(exported, rgb), want)


def test_export_leaves_the_callers_module_alone(nets):
    _, dcn = nets
    dcn.module.train()
    try:
        exported = export.export_inference(dcn, batch_size=1)
        assert dcn.module.training
        assert all(p.requires_grad for p in dcn.module.parameters())
    finally:
        dcn.module.eval()
    rgb = _frames(2, 1)
    # BatchNorm on its running statistics, whatever mode the caller's module is in
    _close(_run(exported, rgb), dcn.forward_on_img(rgb[0]).numpy()[None])
    out = exported.module()(torch.from_numpy(rgb))
    assert not out.requires_grad


def test_the_loaded_program_needs_only_torch(artifact):
    _, path, _ = artifact
    code = ("import sys, torch\n"
            f"p = torch.export.load({path!r}).module()\n"
            "with torch.inference_mode():\n"
            f"    out = p(torch.zeros((2, {H}, {W}, 3), dtype=torch.uint8))\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('pdc_tpu', 'pdc_tpu_torch'))\n"
            "print(tuple(out.shape), bool(torch.isfinite(out).all()), bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd="/", capture_output=True, text=True,
                       timeout=300, env={**os.environ, "PYTHONPATH": ""})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == f"({2}, {H}, {W}, {D}) True []"


@pytest.fixture(scope="module")
def folder(nets, tmp_path_factory):
    """A model folder the port wrote."""
    _, dcn = nets
    path = tmp_path_factory.mktemp("models") / "net"
    path.mkdir()
    save_yaml({"dense_correspondence_network": NET_CFG}, str(path / "training.yaml"))
    dcn.save_checkpoint(str(path / "000100.ckpt"))
    return str(path)


def test_export_model_folder_and_the_cli(nets, folder, tmp_path, capsys):
    _, dcn = nets
    out = str(tmp_path / "served.pt2")
    n = export.export_model_folder(folder, out, batch_size=1, device="cpu")
    assert n == os.path.getsize(out) > 1e6
    rgb = _frames(3, 1)
    _close(_run(export.load_exported(out), rgb), dcn.forward_on_img(rgb[0]).numpy()[None])
    cli_out = str(tmp_path / "cli.pt2")
    assert cli.main(["export-serving", "--model_folder", folder, "--output", cli_out,
                     "--batch_size", "2", "--platform", "cpu", "--iteration", "100"]) == 0
    assert f"wrote {cli_out} ({os.path.getsize(cli_out)} bytes" in capsys.readouterr().out
    _close(_run(export.load_exported(cli_out), _frames(4)),
           np.stack([dcn.forward_on_img(f).numpy() for f in _frames(4)]))
    assert cli.main(["export-serving", "--model_folder", folder, "--output", cli_out,
                     "--device", "cpu"]) == 0


@pytest.mark.parametrize("args", [["--platform", "tpu"], ["--platform", "cuda:tpu"],
                                  ["--int8"], ["--int8_static"]])
def test_cli_refuses_other_platforms_and_int8(args, folder, tmp_path, capsys):
    """Other platforms exit 2. The int8 flags did too until int8 serving was
    ported; now they export the int8 clone's program (``--int8_static``
    with scales calibrated on 16 random train frames, seed 7, frozen into
    it), which gives the clone's forward within TOL."""
    out = str(tmp_path / "x.pt2")
    if "int8" in args[0]:
        save_yaml({"synthetic": {"num_scenes": 1, "num_frames": 4, "width": W, "height": H}},
                  os.path.join(folder, "dataset.yaml"))
        assert cli.main(["export-serving", "--model_folder", folder, "--output", out,
                         "--batch_size", "2", "--platform", "cpu", *args]) == 0
        dcn = DenseCorrespondenceNetwork.from_model_folder(folder, device="cpu")
        if args[0] == "--int8_static":
            ds = dcn.load_training_dataset("train")
            ds.reset_seed(7)
            q = dcn.calibrate_quantization([ds.get_random_rgbd_mask_pose()[0]
                                            for _ in range(16)])
        else:
            q = dcn.quantized()
        rgb = _frames(11)
        _close(_run(export.load_exported(out), rgb), q.forward_on_images(rgb).numpy())
        return
    with pytest.raises(SystemExit) as e:
        cli.main(["export-serving", "--model_folder", folder, "--output", out, *args])
    assert e.value.code == 2
    assert "cuda or cpu" in capsys.readouterr().err
    assert not os.path.exists(out)


def test_cli_needs_cuda_unless_cpu_is_asked(folder, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["export-serving", "--model_folder", folder, "--output",
                  str(tmp_path / "x.pt2")])
