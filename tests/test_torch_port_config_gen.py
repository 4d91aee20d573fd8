"""The port's dataset tooling (pdc_tpu_torch.data.config_gen, migrate,
download, published_manifest) against pdc_tpu's, on the same scene trees:
the cases of tests/test_config_gen.py, each held to the JAX function's
result, the published corpus and manifest, the download's URLs and
unpacking (never fetching: ``urlretrieve`` copies a tarball written under
``tmp_path``), and the ``config-gen``, ``migrate`` and ``download``
commands.

A YAML file the port writes must load equal to the one pdc_tpu writes, both
with PyYAML and with the port's own reader (the card has no PyYAML)."""

import os
import shutil
import tarfile

import numpy as np
import pytest
import yaml

from pdc_tpu.data import config_gen as jax_cg
from pdc_tpu.data import download as jax_download
from pdc_tpu.data import migrate as jax_migrate
from pdc_tpu.data import published_manifest as jax_manifest
from pdc_tpu_torch import __main__ as cli
from pdc_tpu_torch.data import config_gen as cg
from pdc_tpu_torch.data import download
from pdc_tpu_torch.data import migrate
from pdc_tpu_torch.data import published_manifest as manifest
from pdc_tpu_torch.data.dataset import SpartanDataset
from pdc_tpu_torch.data.synthetic import SyntheticScene
from pdc_tpu_torch.utils.yaml_io import load_yaml, parse_yaml


@pytest.fixture(autouse=True)
def _free_the_folders(tmp_path):
    """These tests write scene trees and dataset configs: remove them when the test ends, so that
    a whole run leaves no large files in the temporary directory."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ["2020-01-01-caterpillar-a", "2020-01-02-caterpillar-b", "2020-01-03-caterpillar-c",
          "2020-02-01-shoe-a", "2020-02-02-shoe-b"]
OBJECTS = {"2020-01": "caterpillar", "2020-02": "shoe"}


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("pdc_data")
    for i, name in enumerate(SCENES):
        SyntheticScene(width=32, height=24, num_frames=2, seed=i).write_scene(
            str(root / "logs_proto" / name))
    # an invalid entry that must be skipped (no pose data)
    os.makedirs(root / "logs_proto" / "broken_scene" / "processed" / "images")
    yield str(root)
    shutil.rmtree(root, ignore_errors=True)


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def _assert_same_yaml_tree(port_dir, jax_dir):
    """The same file names, each port file loading (PyYAML and the port's
    reader) equal to pdc_tpu's file."""
    names = _files(port_dir)
    assert names == _files(jax_dir) and names
    for name in names:
        with open(os.path.join(port_dir, name)) as f:
            text = f.read()
        want = jax_cg.load_yaml(os.path.join(jax_dir, name))
        assert load_yaml(os.path.join(port_dir, name)) == want, name
        assert yaml.safe_load(text) == want, name
        assert parse_yaml(text) == want, name


def test_discover_scenes_validates_layout(data_root):
    scenes = cg.discover_scenes(data_root)
    assert scenes == jax_cg.discover_scenes(data_root) == sorted(SCENES)
    with pytest.raises(FileNotFoundError):
        cg.discover_scenes(data_root, logs_root="no_such_root")


@pytest.mark.parametrize("object_of", [
    None, {"a-": "caterpillar", "b-": "shoe"}, {"a-1": "exact", "a-": "prefix"}, {}],
    ids=["none", "prefixes", "exact_name_first", "empty"])
def test_group_scenes_by_object_equals_jax(object_of):
    names = ["a-1", "a-2", "b-1", "c-1"]
    got = cg.group_scenes_by_object(names, object_of)
    assert got == jax_cg.group_scenes_by_object(names, object_of)
    if object_of and "b-" in object_of:
        assert got == {"caterpillar": ["a-1", "a-2"], "shoe": ["b-1"], "object": ["c-1"]}


@pytest.mark.parametrize("n,fraction,min_test", [(10, 0.2, 1), (2, 0.0, 1), (1, 0.5, 1),
                                                  (7, 0.34, 2), (0, 0.2, 1), (5, 1.0, 1)])
def test_scene_list_split_equals_jax(n, fraction, min_test):
    names = [f"s{i}" for i in range(n)]
    got = cg.make_scene_list_config("cat", names, test_fraction=fraction, min_test=min_test,
                                    evaluation_labeled_data_path=["labels.yaml"])
    assert got == jax_cg.make_scene_list_config(
        "cat", names, test_fraction=fraction, min_test=min_test,
        evaluation_labeled_data_path=["labels.yaml"])
    assert got["train"] + got["test"] == names
    if n >= 2:
        assert got["train"] and got["test"]
    if n == 10:
        assert got["test"] == ["s8", "s9"]


def test_generate_and_load_roundtrip_equals_jax(data_root, tmp_path):
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    kw = dict(composite_name="synthetic_two_objects", object_of=OBJECTS, test_fraction=0.34)
    res = cg.generate_dataset_configs(data_root, port_out, **kw)
    want = jax_cg.generate_dataset_configs(data_root, jax_out, **kw)
    assert res["num_scenes"] == want["num_scenes"] == 5
    assert {k: os.path.relpath(v, port_out) for k, v in res["single_object"].items()} == {
        k: os.path.relpath(v, jax_out) for k, v in want["single_object"].items()}
    assert set(res["single_object"]) == {"caterpillar", "shoe"} and res["multi_object"] == {}
    assert os.path.relpath(res["composite"], port_out) == "composite/synthetic_two_objects.yaml"
    _assert_same_yaml_tree(port_out, jax_out)

    composite = load_yaml(res["composite"])
    assert len(composite["single_object_scenes_config_files"]) == 2
    assert composite["multi_object_scenes_config_files"] == []
    # the generated corpus loads through the port's dataset in both modes
    ds = SpartanDataset(config=composite, data_dir=data_root,
                        config_dir=os.path.dirname(res["composite"]))
    ds.set_train_mode()
    train = set(ds.scenes)
    ds.set_test_mode()
    test = set(ds.scenes)
    assert train and test and train.isdisjoint(test) and len(train | test) == 5
    name = next(iter(train))
    assert ds.get_scene(name).object_id in ("caterpillar", "shoe")
    with pytest.raises(ValueError, match="no valid scenes"):
        os.makedirs(tmp_path / "empty" / "logs_proto")
        cg.generate_dataset_configs(str(tmp_path / "empty"), str(tmp_path / "x"))


def test_multi_object_routing_equals_jax(data_root, tmp_path):
    kw = dict(object_of={"2020-01": "caterpillar", "2020-02": "both"}, multi_object_ids=["both"])
    res = cg.generate_dataset_configs(data_root, str(tmp_path / "port"), **kw)
    jax_cg.generate_dataset_configs(data_root, str(tmp_path / "jax"), **kw)
    composite = load_yaml(res["composite"])
    assert composite["multi_object_scenes_config_files"] == ["multi_object/both.yaml"]
    assert set(res["multi_object"]) == {"both"} and set(res["single_object"]) == {"caterpillar"}
    _assert_same_yaml_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_copy_dataset_scenes_equals_jax(data_root, tmp_path):
    out = str(tmp_path / "config")
    res = cg.generate_dataset_configs(data_root, out, object_of=OBJECTS)
    composite = load_yaml(res["composite"])
    config_dir = os.path.dirname(res["composite"])
    assert cg.scene_names_in_composite(composite, config_dir) == \
        jax_cg.scene_names_in_composite(composite, config_dir)
    target, jax_target = str(tmp_path / "subset"), str(tmp_path / "jax_subset")
    dry = cg.copy_dataset_scenes(composite, config_dir, data_root, target, dry_run=True)
    assert dry == jax_cg.copy_dataset_scenes(composite, config_dir, data_root, jax_target,
                                             dry_run=True)
    assert len(dry) == 5 and not os.path.exists(os.path.join(target, "logs_proto"))
    copied = cg.copy_dataset_scenes(composite, config_dir, data_root, target)
    assert copied == jax_cg.copy_dataset_scenes(composite, config_dir, data_root, jax_target)
    assert sorted(copied) == sorted(dry)
    assert _files(target) == _files(jax_target)
    for name in _files(target):
        with open(os.path.join(target, name), "rb") as a, \
                open(os.path.join(data_root, name), "rb") as b:
            assert a.read() == b.read(), name
    # a second run copies nothing; the copy is a data root of its own
    assert cg.copy_dataset_scenes(composite, config_dir, data_root, target) == []
    assert cg.discover_scenes(target) == sorted(SCENES)
    with pytest.raises(FileNotFoundError):
        cg.copy_dataset_scenes(composite, config_dir, str(tmp_path / "nowhere"),
                               str(tmp_path / "t2"))


def _old_layout(logs):
    old = logs / "old_scene"
    (old / "images").mkdir(parents=True)
    (old / "images" / "000000_rgb.png").write_bytes(b"png")
    (old / "fusion_mesh.ply").write_bytes(b"ply")
    (old / "fusion.bag").write_bytes(b"bag")
    (old / "camera_info.yaml").write_bytes(b"fx: 1")
    (logs / "new_scene" / "processed" / "images").mkdir(parents=True)
    (logs / "stray_file.txt").write_bytes(b"x")


def test_migrate_old_format_logs_equals_jax(tmp_path):
    port_logs, jax_logs = tmp_path / "port" / "logs_proto", tmp_path / "jax" / "logs_proto"
    for logs in (port_logs, jax_logs):
        _old_layout(logs)
    before = _files(str(port_logs))
    assert migrate.migrate_logs(str(port_logs), dry_run=True) == \
        jax_migrate.migrate_logs(str(jax_logs), dry_run=True) == ["old_scene"]
    assert _files(str(port_logs)) == before  # the dry run moved nothing
    assert migrate.migrate_logs(str(port_logs)) == jax_migrate.migrate_logs(str(jax_logs)) == \
        ["old_scene"]
    assert _files(str(port_logs)) == _files(str(jax_logs))
    old = port_logs / "old_scene"
    assert (old / "processed" / "fusion_mesh.ply").read_bytes() == b"ply"
    assert (old / "processed" / "images" / "000000_rgb.png").exists()
    assert (old / "raw" / "fusion.bag").read_bytes() == b"bag"
    assert not (old / "fusion_mesh.ply").exists()
    # idempotent; the new-layout scene is untouched
    assert migrate.migrate_logs(str(port_logs)) == []
    assert migrate.migrate_scene_to_new_format(str(port_logs / "new_scene")) is False
    assert migrate.RAW_FILES == jax_migrate.RAW_FILES


def test_manifest_equals_jax():
    for name in ("SINGLE_OBJECT_SCENE_LISTS", "MULTI_OBJECT_SCENE_LISTS", "COMPOSITES",
                 "DANGLING_REFS"):
        assert getattr(manifest, name) == getattr(jax_manifest, name), name
    assert (len(manifest.SINGLE_OBJECT_SCENE_LISTS), len(manifest.MULTI_OBJECT_SCENE_LISTS),
            len(manifest.COMPOSITES)) == (41, 4, 36)


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    port_out = str(tmp_path_factory.mktemp("published_port"))
    jax_out = str(tmp_path_factory.mktemp("published_jax"))
    res = cg.write_published_corpus(port_out)
    assert res == {**jax_cg.write_published_corpus(jax_out), "out_dir": port_out}
    yield port_out, jax_out, res
    for out in (port_out, jax_out):
        shutil.rmtree(out, ignore_errors=True)


def test_write_published_corpus_equals_jax(published):
    port_out, jax_out, res = published
    _assert_same_yaml_tree(port_out, jax_out)
    counts = {sub: len(os.listdir(os.path.join(port_out, sub)))
              for sub in ("single_object", "multi_object", "composite")}
    assert counts == {k: res[k] for k in counts} == {"single_object": 41, "multi_object": 4,
                                                     "composite": 36}
    # the committed corpus under configs/ is this corpus
    for sub in counts:
        for name in os.listdir(os.path.join(port_out, sub)):
            committed = os.path.join(ROOT, "configs", "dataset", sub, name)
            if os.path.exists(committed):
                assert load_yaml(committed) == load_yaml(os.path.join(port_out, sub, name))


def test_scene_urls_equal_jax_on_every_published_composite(published):
    port_out, _, _ = published
    comp_dir = os.path.join(port_out, "composite")
    for name in sorted(os.listdir(comp_dir)):
        config = load_yaml(os.path.join(comp_dir, name))
        urls = download.scene_urls_from_composite_config(config, comp_dir)
        assert urls == jax_download.scene_urls_from_composite_config(config, comp_dir), name
        assert urls == sorted(set(urls)) and all(
            u.startswith(download.BASE_URL + "logs_proto_compressed/") for u in urls)
    cat = load_yaml(os.path.join(comp_dir, "caterpillar_only.yaml"))
    spec = manifest.SINGLE_OBJECT_SCENE_LISTS[manifest.COMPOSITES["caterpillar_only"]
                                              ["single_object"][0]]
    assert len(download.scene_urls_from_composite_config(cat, comp_dir)) == len(
        set(spec["train"]) | set(spec["test"]))
    assert download.BASE_URL == jax_download.BASE_URL


def _tarball(tmp_path, scene):
    """A scene tarball as the dataset ships it: ``<scene>/processed/...``."""
    src = tmp_path / "src" / scene / "processed" / "images"
    src.mkdir(parents=True)
    (src / "000000_rgb.png").write_bytes(b"not a png")
    path = tmp_path / f"{scene}.tar.gz"
    with tarfile.open(path, "w:gz") as tf:
        tf.add(str(tmp_path / "src" / scene), arcname=scene)
    return path


def test_download_unpacks_with_a_local_copy_and_dry_run_creates_nothing(
        published, tmp_path, monkeypatch, capsys):
    port_out, _, _ = published
    config = os.path.join(port_out, "composite", "caterpillar_only.yaml")
    want = jax_download.scene_urls_from_composite_config(load_yaml(config),
                                                         os.path.dirname(config))
    dry_dir = tmp_path / "dry"
    assert download.download_pdc_data(config, str(dry_dir), dry_run=True) == want
    assert not dry_dir.exists()
    assert capsys.readouterr().out.count("would fetch") == len(want)

    fetched = []

    def fake_urlretrieve(url, dest):
        scene = os.path.basename(url)[: -len(".tar.gz")]
        fetched.append(url)
        shutil.copy(_tarball(tmp_path / "tars" / str(len(fetched)), scene), dest)
    monkeypatch.setattr(download.urllib.request, "urlretrieve", fake_urlretrieve)
    data = tmp_path / "data"
    assert download.download_pdc_data(config, str(data)) == want
    assert fetched == want
    scenes = sorted(os.listdir(data / "logs_proto"))
    assert scenes == sorted(os.path.basename(u)[: -len(".tar.gz")] for u in want)
    for s in scenes:
        assert (data / "logs_proto" / s / "processed" / "images" / "000000_rgb.png").exists()
    # scenes already there are not fetched again
    assert download.download_pdc_data(config, str(data)) == want and len(fetched) == len(want)


def test_cli_config_gen_migrate_and_download(data_root, published, tmp_path, capsys):
    port_out, _, _ = published
    # config-gen --published
    out = str(tmp_path / "published")
    assert cli.main(["config-gen", "--published", "--out_dir", out]) == 0
    assert "41 single-object + 4 multi-object scene lists, 36 composites" in \
        capsys.readouterr().out
    assert _files(out) == _files(port_out)
    # config-gen --data_dir with an --objects file (read by the port's reader)
    objects = str(tmp_path / "objects.yaml")
    with open(objects, "w") as f:
        f.write("2020-01: caterpillar\n2020-02: shoe\n")
    gen = str(tmp_path / "gen")
    assert cli.main(["config-gen", "--data_dir", data_root, "--out_dir", gen, "--name", "two",
                     "--objects", objects, "--multi_object_ids", "shoe",
                     "--test_fraction", "0.34"]) == 0
    printed = capsys.readouterr().out
    assert "5 scenes ->" in printed and "caterpillar:" in printed
    jax_cg.generate_dataset_configs(data_root, str(tmp_path / "jax_gen"), composite_name="two",
                                    object_of=OBJECTS, multi_object_ids=["shoe"],
                                    test_fraction=0.34)
    _assert_same_yaml_tree(gen, str(tmp_path / "jax_gen"))
    with pytest.raises(SystemExit):
        cli.main(["config-gen", "--out_dir", gen])
    assert "--data_dir is required" in capsys.readouterr().err
    # migrate
    logs = tmp_path / "old" / "logs_proto"
    _old_layout(logs)
    assert cli.main(["migrate", "--logs_dir", str(logs), "--dry_run"]) == 0
    assert capsys.readouterr().out.strip() == "would migrate old_scene"
    assert cli.main(["migrate", "--logs_dir", str(logs)]) == 0
    assert capsys.readouterr().out.strip() == "migrated old_scene"
    assert (logs / "old_scene" / "raw" / "fusion.bag").exists()
    # download --dry_run
    config = os.path.join(out, "composite", "caterpillar_only.yaml")
    assert cli.main(["download", "--config", config, "--data_dir", str(tmp_path / "dl"),
                     "--dry_run"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[-1] for ln in lines] == jax_download.scene_urls_from_composite_config(
        load_yaml(config), os.path.dirname(config))
    assert not (tmp_path / "dl").exists()
    assert np.all([ln.startswith("would fetch ") for ln in lines])
