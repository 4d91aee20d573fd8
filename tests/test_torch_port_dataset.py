"""The port's dataset layer (pdc_tpu_torch.data.dataset, native_loader's
PrefetchLoader, DenseCorrespondenceNetwork.load_training_dataset) against
pdc_tpu: on the same seed both run the same Python and numpy draws in the
same order, so sampled pairs, their types, scenes, frame indices and every
array, and the stacked host batches, must be exactly equal.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from pdc_tpu.data.dataset import SpartanDataset as JaxSpartanDataset
from pdc_tpu_torch.data.dataset import SceneData, SpartanDataset
from pdc_tpu_torch.data.native_loader import PrefetchLoader
from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
from pdc_tpu_torch.utils.yaml_io import save_yaml

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 64, 48
SYNTH = dict(num_scenes=3, num_objects=2, num_test_scenes=1, width=W, height=H, num_frames=6)
MIXES = {
    "within-across-different": {"SINGLE_OBJECT_WITHIN_SCENE": 0.5,
                                "SINGLE_OBJECT_ACROSS_SCENE": 0.25, "DIFFERENT_OBJECT": 0.25},
    "with-synthetic-multi-object": {"SINGLE_OBJECT_WITHIN_SCENE": 0.4,
                                    "SINGLE_OBJECT_ACROSS_SCENE": 0.2, "DIFFERENT_OBJECT": 0.2,
                                    "SYNTHETIC_MULTI_OBJECT": 0.2},
}


def training_config(mix):
    return {"training": {"num_matching_attempts": 256, "sample_matches_only_off_mask": True,
                         "num_non_matches_per_match": 10, "fraction_masked_non_matches": 0.5,
                         "fraction_background_non_matches": 0.5,
                         "data_type_probabilities": mix}}


def both(mix):
    port = SpartanDataset.make_synthetic(**SYNTH)
    ref = JaxSpartanDataset.make_synthetic(**SYNTH)
    for ds in (port, ref):
        ds.set_parameters_from_training_config(training_config(mix))
    return port, ref


def assert_pairs_equal(p, q):
    assert p.match_type == q.match_type
    assert p.metadata == q.metadata
    for f in ("rgb_a", "depth_a", "mask_a", "pose_a", "rgb_b", "depth_b", "mask_b", "pose_b", "K"):
        a, b = getattr(p, f), getattr(q, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (p.second is None) == (q.second is None)
    if p.second is not None:
        assert_pairs_equal(p.second, q.second)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_sample_pair_equals_jax_bit_for_bit(mix):
    port, ref = both(MIXES[mix])
    types = []
    for _ in range(200):
        p, q = port.sample_pair(), ref.sample_pair()
        assert_pairs_equal(p, q)
        types.append(p.match_type)
    # every type of the mix was drawn
    want = {0, 1, 2}
    if "SYNTHETIC_MULTI_OBJECT" in MIXES[mix]:
        want.add(4)
    assert want <= set(types)
    # the test split holds only the held-out scene, in both
    port.set_test_mode()
    ref.set_test_mode()
    assert sorted(port.scenes) == sorted(ref.scenes) == ["test_scene_000"]
    for _ in range(20):
        assert_pairs_equal(port.sample_pair(0), ref.sample_pair(0))


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_make_host_batch_equals_jax(mix):
    port, ref = both(MIXES[mix])
    for _ in range(3):
        a, b = port.make_host_batch(4), ref.make_host_batch(4)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_accessors_and_reset_seed_equal_jax():
    port, ref = both(MIXES["within-across-different"])
    assert port.get_scene_list() == ref.get_scene_list()
    assert port.get_list_of_objects() == ref.get_list_of_objects()
    assert port.num_images_total == ref.num_images_total
    assert port.config_snapshot() == ref.config_snapshot()
    for ds in (port, ref):
        ds.sample_pair()
        ds.reset_seed(5)
    assert port.get_random_object_id_and_int() == ref.get_random_object_id_and_int()
    for a, b in zip(port.get_random_rgbd_mask_pose(), ref.get_random_rgbd_mask_pose()):
        np.testing.assert_array_equal(a, b)
    k = port.get_camera_intrinsics("scene_000")
    np.testing.assert_array_equal(k.K, ref.get_camera_intrinsics("scene_000").K)
    np.testing.assert_array_equal(port.rgb_image_to_tensor(port.scenes["scene_000"].rgb[0]),
                                  ref.rgb_image_to_tensor(ref.scenes["scene_000"].rgb[0]))


def test_on_disk_datasets_wait_for_their_slice():
    composite = {"logs_root_path": "logs_proto", "single_object_scenes_config_files": ["x.yaml"]}
    with pytest.raises(NotImplementedError, match="on-disk"):
        SpartanDataset.from_dataset_config(composite)
    with pytest.raises(NotImplementedError, match="on-disk"):
        SceneData.from_structure(None, "scene")


def test_chip_smoke_dataset_record_matches_the_committed_model_folder():
    """chip_smoke.py states the synthetic record of tpu_journey's
    dataset.yaml inline (the card's copy of the tree may lack
    trained_models/)."""
    import chip_smoke

    path = os.path.join(ROOT, "trained_models", "tpu_journey", "dataset.yaml")
    with open(path) as f:
        assert chip_smoke.DATASET_RECORD == yaml.safe_load(f)


def _dcn_on(folder):
    cfg = {"descriptor_dimension": 3, "image_width": W, "image_height": H,
           "backbone": {"model_class": "Resnet", "resnet_name": "Resnet18_8s"},
           "path_to_network_params_folder": folder}
    return DenseCorrespondenceNetwork.from_config(cfg, device="cpu")


def _assert_datasets_equal(port, ref):
    assert sorted(port.scenes) == sorted(ref.scenes)
    for name, s in port.scenes.items():
        r = ref.scenes[name]
        assert s.num_frames == r.num_frames and s.object_id == r.object_id
        np.testing.assert_array_equal(s.poses, r.poses)
        np.testing.assert_array_equal(s.rgb, r.rgb)
        np.testing.assert_array_equal(s.depth, r.depth)


def test_load_training_dataset_rebuilds_a_written_record(tmp_path):
    record = {"synthetic": dict(SYNTH, seed_offset=2)}
    save_yaml(record, str(tmp_path / "dataset.yaml"))
    dcn = _dcn_on(str(tmp_path))
    for mode in ("train", "test"):
        port = dcn.load_training_dataset(mode=mode)
        ref = JaxSpartanDataset.from_dataset_config(record, mode=mode)
        assert port.mode == mode
        _assert_datasets_equal(port, ref)


@pytest.mark.slow
def test_load_training_dataset_rebuilds_tpu_journey():
    """The committed 640x480 record (24 frames rendered twice)."""
    folder = os.path.join(ROOT, "trained_models", "tpu_journey")
    if not os.path.exists(os.path.join(folder, "dataset.yaml")):
        pytest.skip("trained_models/tpu_journey is not in this checkout")
    port = _dcn_on(folder).load_training_dataset()
    with open(os.path.join(folder, "dataset.yaml")) as f:
        ref = JaxSpartanDataset.from_dataset_config(yaml.safe_load(f))
    assert sorted(port.scenes) == ["scene_000", "scene_001"]
    _assert_datasets_equal(port, ref)


def test_prefetch_loader_orders_batches_copies_to_the_device_and_forwards_errors():
    counter = iter(range(100))
    loader = PrefetchLoader(lambda: {"i": np.array([next(counter)]), "tag": "t"}, depth=2,
                            device="cpu")
    try:
        got = [loader.next() for _ in range(5)]
    finally:
        loader.stop()
    assert [int(b["i"][0]) for b in got] == [0, 1, 2, 3, 4]
    assert all(isinstance(b["i"], torch.Tensor) and b["tag"] == "t" for b in got)
    assert not loader._thread.is_alive()

    calls = []

    def failing():
        calls.append(1)
        if len(calls) == 2:
            raise KeyError("boom")
        return {"x": np.zeros(1)}

    loader = PrefetchLoader(failing, depth=1)
    assert isinstance(loader.next()["x"], np.ndarray)
    with pytest.raises(RuntimeError, match="producer") as info:
        loader.next()
    assert isinstance(info.value.__cause__, KeyError)
    loader._thread.join(timeout=5)
    assert not loader._thread.is_alive()
