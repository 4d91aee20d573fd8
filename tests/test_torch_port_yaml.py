"""The port's YAML emitter and reader (pdc_tpu_torch.utils.yaml_io) against
PyYAML: what the emitter writes loads with PyYAML to the same dict, floats
included, and for model-folder files byte for byte as PyYAML's own block
dump; the reader reads the repo's configs and model-folder files as PyYAML
does, and what PyYAML writes in flow or block style (flow mappings, nested
flow and block collections; fault F7); it raises on timestamps and base-60
numbers rather than read them as strings; and without PyYAML the port reads
what it writes.
"""

import glob
import math
import os
import sys

import pytest
import yaml

from pdc_tpu_torch.utils import yaml_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pyyaml_dump(data):
    return yaml.dump(data, Dumper=yaml.SafeDumper, default_flow_style=False)


SAMPLE = {
    "training": {"learning_rate": 1.0e-4, "weight_decay": 1e-5, "tiny": 2.287679245496101e-05,
                 "big": 1e16, "neg": -3e-7, "batch_size": 4, "use_matrix_loss": True,
                 "fsdp": False, "nothing": None, "logging_dir": "trained_models",
                 "data_type_probabilities": {"SINGLE_OBJECT_WITHIN_SCENE": 1, "MULTI_OBJECT": 0}},
    "dense_correspondence_network": {"backbone": {"model_class": "Resnet"}},
    "strings": {"yes_word": "yes", "number_like": "123", "float_like": "1.5", "date": "2018-04-10",
                "scene": "2018-04-10-16-02-59", "spaced": "a b: c # d", "quote": "it's \"x\"",
                "empty": "", "uuid": "824229c5d375470a8cbeeeadf6401367", "tilde": "~",
                "unicode": "caf\u00e9\n"},
    "history": {"iteration": [1, 2, 3], "loss": [0.5, 1e-05, float("inf")], "none": [],
                "names": ["scene_000", "on", "12"]},
    "empty": {},
}


def test_emitter_output_loads_with_pyyaml_to_the_same_dict():
    text = yaml_io.dump_yaml(SAMPLE)
    assert yaml.safe_load(text) == SAMPLE


def test_emitter_writes_pyyaml_bytes_for_model_folder_files():
    """A training config and a log history (plain strings, numbers, lists)
    come out byte for byte as PyYAML's block dump of them."""
    with open(os.path.join(ROOT, "configs", "training.yaml")) as f:
        config = yaml.safe_load(f)
    history = {"train": {"iteration": [1, 2], "loss": [0.5, 2.5e-05],
                         "learning_rate": [1.0e-4, 1.0e-4 * 0.9]},
               "test": {"iteration": [], "loss": []}, "id": "824229c5d375470a8cbeeeadf6401367"}
    for data in (config, history):
        assert yaml_io.dump_yaml(data) == _pyyaml_dump(data)


@pytest.mark.parametrize("value", [1.0e-4, 1e-5, 1e-4 * 0.9 ** 3, 2.5e20, 1e16, -3e-7, 1e-300,
                                   0.1, 1.0, 0.0, -0.0, 3.5e-05, float("inf"), float("-inf")])
def test_floats_read_back_as_floats_in_pyyaml(value):
    text = yaml_io.dump_yaml({"x": value})
    got = yaml.safe_load(text)["x"]
    assert isinstance(got, float) and got == value, text
    assert yaml_io.parse_yaml(text)["x"] == value
    # the form PyYAML's 1.1 resolver would read as a string is never written
    assert "e" not in text or "." in text.split("e")[0]


def test_nan_round_trips():
    text = yaml_io.dump_yaml({"x": float("nan")})
    assert math.isnan(yaml.safe_load(text)["x"]) and math.isnan(yaml_io.parse_yaml(text)["x"])


def _repo_yaml_files():
    files = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))
    files += sorted(glob.glob(os.path.join(ROOT, "trained_models", "*", "*.yaml")))
    return files


@pytest.mark.parametrize("path", _repo_yaml_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_reader_reads_repo_files_as_pyyaml_does(path):
    with open(path) as f:
        text = f.read()
    assert yaml_io.parse_yaml(text) == yaml.safe_load(text)


def test_reader_reads_flow_lists_comments_and_quotes():
    text = ("# a comment\n"
            "a: [1, 2.5, x]   # trailing\n"
            "b: 'it''s'\n"
            "c: \"tab\\t # not a comment\"\n"
            "d:\n"
            "  - 1\n"
            "  - two\n"
            "e:\n"
            "- 1.0e-05\n"
            "f:\n"
            "g: ~\n"
            "h: 1e-05\n")
    assert yaml_io.parse_yaml(text) == yaml.safe_load(text)


def test_without_pyyaml_the_port_reads_what_it_writes(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml raises ImportError
    path = str(tmp_path / "sub" / "loss.yaml")
    yaml_io.save_yaml(SAMPLE, path)
    assert yaml_io.load_yaml(path) == SAMPLE
    assert yaml_io.load_yaml(os.path.join(ROOT, "configs", "training.yaml"))["training"][
        "learning_rate"] == 1.0e-4


def test_emitter_refuses_what_it_does_not_write():
    with pytest.raises(TypeError):
        yaml_io.dump_yaml({"a": [{"nested": 1}]})
    with pytest.raises(TypeError):
        yaml_io.dump_yaml({"a": object()})
    with pytest.raises(TypeError):
        yaml_io.dump_yaml([1, 2])



@pytest.mark.parametrize("data", [
    [{"image_a": {"scene_name": "scene_000", "image_idx": 0,
                  "pixels": [{"u": 10, "v": 12}, {"u": 30, "v": 20}]},
      "image_b": {"scene_name": "scene_001", "image_idx": 1, "pixels": []}}],
    {"x": [[1, 2], [3]], "y": [{"a": [{"b": 1.5}]}], "z": [[], {}], "w": [[[1]]]},
    [],
    [1, "two", 3.0e-05, None, True],
], ids=["annotations", "nested", "empty", "scalars"])
def test_nested_emitter_writes_what_pyyaml_writes(data):
    """``nested=True`` (annotation files) writes PyYAML's bytes, and both
    readers read them back."""
    text = yaml_io.dump_yaml(data, nested=True)
    assert text == yaml.safe_dump(data, default_flow_style=False)
    assert yaml.safe_load(text) == data
    assert yaml_io.parse_yaml(text) == data

# fault F7: what PyYAML writes in its other styles, nested any way
F7_DATA = {
    "pose": {"quaternion": {"w": 0.8535533905932737, "x": -0.14644660940672624,
                            "y": 0.3535533905932737, "z": 0.3535533905932737},
             "translation": {"x": 1.0, "y": -2.5e-05, "z": 3.0}},
    "nested_lists": [[1, 2], [3, [4, 5.5]], [], [[]]],
    "list_of_maps": [{"u": 1, "v": 2, "keypoint": "toe"}, {"u": 3, "v": 4, "name": "it's"}],
    "map_of_lists": {"a": [1, {"b": [True, None, "x y"]}], "c": {}},
    "strings": {"comma": "a, b", "brace": "}{", "colon": "k: v", "quote": "say \"hi\""},
    "empty": [],
}


@pytest.mark.parametrize("style", [None, False, True], ids=["flow_leaves", "block", "flow"])
def test_reader_reads_what_pyyaml_writes_in_each_style(style):
    text = yaml.dump(F7_DATA, Dumper=yaml.SafeDumper, default_flow_style=style, width=60)
    assert yaml_io.parse_yaml(text) == yaml.safe_load(text) == F7_DATA


@pytest.mark.parametrize("text", [
    "q: {w: 1.0, x: 0.0, y: 0.0, z: 0.0}\n",
    "a: [[1, 2], [3, [4, 5]], {b: [6, {c: d}]}]\n",
    "- - b\n  - c\n- - - d\n  - e\n- f\n",
    "- a: 1\n  b: [1, 2]\n- c:\n  - x\n  - y: 2\n    z: 3\n",
    "top:\n  - name: a\n    pixels:\n    - {u: 1, v: 2}\n    - u: 3\n      v: 4\n",
    "m: {a: [1,\n    2], b: {c: 3,\n  d: 4}}\nn: 5\n",
    "[a: 1, b]\n",
    "a: {b, c: }\nd: it's # comment\ne: 'x # y'\nf: 0b101\n",
    "a: x[1\nb: y{2, 3]\nc:\n- z[\n- [1,\n   2]\n",
], ids=["flow_map", "nested_flow", "nested_block_seq", "seq_of_maps", "annotations",
        "flow_over_lines", "flow_pair", "quirks", "plain_brackets"])
def test_reader_reads_nested_flow_and_block_collections_as_pyyaml(text):
    assert yaml_io.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a: 2018-04-09\n", "a: 2001-12-14 21:59:43.10 -5\n",
                                  "a: 12:30\n", "a: [1:20.5]\n"])
def test_reader_raises_on_timestamps_and_base_60_numbers(text):
    assert not isinstance(list(yaml.safe_load(text).values())[0], str)
    with pytest.raises(ValueError, match="timestamp or a base-60"):
        yaml_io.parse_yaml(text)


def test_flow_style_pose_file_reads_without_pyyaml(tmp_path, monkeypatch):
    """A pose_data.yaml written as PyYAML wrote before 5.1
    (default_flow_style=None: each leaf mapping on one line, wrapped at 80
    columns), read by the scene loader with and without PyYAML."""
    import numpy as np

    from pdc_tpu_torch.data.scene import SceneStructure

    rng = np.random.default_rng(0)
    poses = {}
    for i in range(6):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        poses[i] = {"camera_to_world": {
            "quaternion": {k: float(v) for k, v in zip("wxyz", q)},
            "translation": {k: float(v) for k, v in zip("xyz", rng.standard_normal(3))}},
            "timestamp": 1523400000000 + i, "rgb_image_filename": "%06d_rgb.png" % i}
    processed = tmp_path / "scene" / "processed"
    (processed / "images").mkdir(parents=True)
    text = yaml.dump(poses, default_flow_style=None)
    assert "quaternion: {w:" in text and "\n      z:" in text  # flow leaves wrapped
    (processed / "images" / "pose_data.yaml").write_text(text)
    structure = SceneStructure(str(processed))
    assert structure.pose_data_filename == str(processed / "images" / "pose_data.yaml")
    with_pyyaml = structure.load_pose_data()
    monkeypatch.setitem(sys.modules, "yaml", None)
    without = structure.load_pose_data()
    assert sorted(without) == list(range(6))
    for i in range(6):
        np.testing.assert_array_equal(without[i], with_pyyaml[i])
