"""The port's YAML emitter and reader (pdc_tpu_torch.utils.yaml_io) against
PyYAML: what the emitter writes loads with PyYAML to the same dict, floats
included, and for model-folder files byte for byte as PyYAML's own block
dump; the reader reads
the repo's configs and model-folder files as PyYAML does; and without
PyYAML the port reads what it writes.
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
    files = [os.path.join(ROOT, "configs", "training.yaml")]
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
