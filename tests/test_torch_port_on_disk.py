"""The port's on-disk data slice against pdc_tpu, on the CPU at 64x48.

  * decoding: the zlib codec and the libpng pool of
    pdc_tpu_torch.data.native_loader give arrays bit-equal to
    pdc_tpu.data.native_loader.decode_batch (its libpng library) on the
    published-layout fixture (tests/fixtures/real_layout.py), on
    pdc_tpu's PIL-written write_scene output (adaptive filters, Paeth rows
    among them) and on gray+alpha, palette, RGBA and tRNS images written
    with PIL; missing files and wrong sizes raise under both decoders;
  * writing: the port's write_scene reads back in pdc_tpu equal to the
    port's read and to the rendering (poses within 1e-12);
  * the layout's quirks, composite configs (200 sampled pairs bit for bit),
    config_snapshot and from_dataset_config, exactly as pdc_tpu;
  * ``python -m pdc_tpu_torch train`` on a composite config writes a
    folder that pdc_tpu loads (forward within 1e-4, fp32 convolutions
    summed in another order, as in tests/test_torch_port_training_driver.py);
  * dataset statistics within 1e-12 of float64 over the same frames (exact
    integer sums), and within pdc_tpu's float32 summation error of its values;
  * reference-trained checkpoints converted exactly as pdc_tpu converts them.
"""

import os
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from pdc_tpu.data import config_gen as jax_config_gen
from pdc_tpu.data import native_loader as jax_loader
from pdc_tpu.data import statistics as jax_statistics
from pdc_tpu.data.dataset import SceneData as JaxSceneData
from pdc_tpu.data.dataset import SpartanDataset as JaxSpartanDataset
from pdc_tpu.data.labelfusion import LabelFusionScene as JaxLabelFusionScene
from pdc_tpu.data.scene import SceneStructure as JaxSceneStructure
from pdc_tpu.data.synthetic import SyntheticScene as JaxSyntheticScene
from pdc_tpu.geom import camera as jax_camera
from pdc_tpu.geom import transforms as jax_transforms
from pdc_tpu.models import torch_import as jax_torch_import
from pdc_tpu.models.dcn import DenseCorrespondenceNetwork as JaxDCN
from pdc_tpu_torch import __main__ as cli
from pdc_tpu_torch.data import config_gen, statistics
from pdc_tpu_torch.data import native_loader as nl
from pdc_tpu_torch.data.dataset import SceneData, SpartanDataset
from pdc_tpu_torch.data.labelfusion import LabelFusionScene
from pdc_tpu_torch.data.scene import SceneStructure
from pdc_tpu_torch.data.synthetic import SyntheticScene
from pdc_tpu_torch.geom import transforms
from pdc_tpu_torch.geom.camera import CameraIntrinsics
from pdc_tpu_torch.models import torch_import
from pdc_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
from pdc_tpu_torch.models.resnet import ResNet18_8s, init_weights_
from pdc_tpu_torch.ops import _build
from pdc_tpu_torch.training.train import DenseCorrespondenceTraining
from pdc_tpu_torch.utils.yaml_io import load_yaml, parse_yaml, save_yaml
from tests.fixtures.real_layout import write_miniature_scene

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _free_the_folders(tmp_path):
    """These tests write scene trees and model folders (checkpoints and Adam states): remove them
    when the test ends, so that a whole run leaves no large files in the temporary
    directory."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


W, H, D = 64, 48, 3
DECODERS = ("zlib", "libpng")
MIX = {"SINGLE_OBJECT_WITHIN_SCENE": 0.5, "SINGLE_OBJECT_ACROSS_SCENE": 0.25,
       "DIFFERENT_OBJECT": 0.25}
SHAPES = {nl.KIND_RGB8: ((H, W, 3), np.uint8), nl.KIND_GRAY16: ((H, W), np.uint16),
          nl.KIND_MASK8: ((H, W), np.uint8)}


def _need(decoder):
    if decoder == "libpng":
        ok, why = nl.probe_libpng()
        if not ok:
            pytest.skip(f"the libpng pool cannot be built here: {why}")


def _decode(fn, path, kind, fill=0):
    shape, dtype = SHAPES[kind]
    out = np.full(shape, fill, dtype)
    fn([(path, kind, out)])
    return out


def assert_decodes_like_jax(path, kind, decoder, fill=0):
    want = _decode(lambda it: jax_loader.decode_batch(it, H, W), path, kind, fill)
    got = _decode(lambda it: nl.decode_batch(it, H, W, decoder=decoder), path, kind, fill)
    np.testing.assert_array_equal(got, want, err_msg=f"{path} kind {kind}")


def _filter_types(path):
    """The filter byte of every row of a PNG written by PIL (8-bit RGB)."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, -1)
    return set(raw[:, 0].tolist())


# -- a published-layout tree and its composite config ---------------------------------


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """Three published-layout scenes (non-contiguous ids 3, 20, 37, 54;
    orphan pose keys 1 and 29; the ROS camera_info) under
    <root>/logs_proto, two objects' scene lists in config/single_object
    and a composite in config/composite that names them bare; removed with
    the module."""
    root = tmp_path_factory.mktemp("layout")
    for i in range(3):
        write_miniature_scene(str(root / "logs_proto" / f"scene_{i}" / "processed"),
                              num_frames=4, width=W, height=H, seed=i)
    cfg = root / "config"
    save_yaml({"object_id": "disc_a", "train": ["scene_0", "scene_1"], "test": ["scene_2"]},
              str(cfg / "single_object" / "disc_a.yaml"))
    save_yaml({"train": ["scene_2"], "test": ["scene_0"]},
              str(cfg / "single_object" / "disc_b.yaml"))
    composite = {"logs_root_path": "logs_proto",
                 "single_object_scenes_config_files": ["disc_a.yaml", "disc_b.yaml"]}
    save_yaml(composite, str(cfg / "composite" / "composite.yaml"))
    yield {"root": str(root), "config_dir": str(cfg / "composite"), "composite": composite,
           "composite_file": str(cfg / "composite" / "composite.yaml")}
    shutil.rmtree(root, ignore_errors=True)


def _datasets(layout, mode="train"):
    kw = dict(config=layout["composite"], mode=mode, data_dir=layout["root"],
              config_dir=layout["config_dir"])
    return SpartanDataset(**kw), JaxSpartanDataset(**kw)


# -- decoding ----------------------------------------------------------------------------


@pytest.mark.parametrize("decoder", DECODERS)
def test_decoders_equal_jax_on_the_published_layout(layout, decoder):
    _need(decoder)
    processed = os.path.join(layout["root"], "logs_proto", "scene_1", "processed")
    n = 0
    for sub, kinds in (("images", {"_rgb.png": [nl.KIND_RGB8, nl.KIND_MASK8],
                                   "_depth.png": [nl.KIND_GRAY16]}),
                       ("rendered_images", {"_depth.png": [nl.KIND_GRAY16],
                                            "_depth_cropped.png": [nl.KIND_GRAY16]}),
                       ("image_masks", {"_mask.png": [nl.KIND_MASK8, nl.KIND_RGB8],
                                        "_visible_mask.png": [nl.KIND_RGB8, nl.KIND_MASK8]})):
        for name in sorted(os.listdir(os.path.join(processed, sub))):
            for suffix, ks in kinds.items():
                if name.endswith(suffix) and name[:6].isdigit() and name[6:] == suffix:
                    for k in ks:
                        assert_decodes_like_jax(os.path.join(processed, sub, name), k, decoder)
                        n += 1
    assert n == 4 * 9
    # load_scene_frames over the scene, against pdc_tpu's
    ids = [3, 20, 37, 54]
    got = nl.load_scene_frames(SceneStructure(processed), ids, H, W, decoder=decoder)
    want = jax_loader.load_scene_frames(JaxSceneStructure(processed), ids, H, W)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("decoder", DECODERS)
def test_decoders_equal_jax_on_pil_written_scenes_with_paeth_rows(tmp_path, decoder):
    _need(decoder)
    processed = JaxSyntheticScene(width=W, height=H, num_frames=3, seed=4,
                                  occluder=(0.05, 0.25, -0.1, 0.1, 0.15)).write_scene(
                                      str(tmp_path / "s"))
    st = JaxSceneStructure(processed)
    filters = set()
    for i in range(3):
        filters |= _filter_types(st.rgb_image_filename(i))
        assert_decodes_like_jax(st.rgb_image_filename(i), nl.KIND_RGB8, decoder)
        assert_decodes_like_jax(st.depth_image_filename(i), nl.KIND_GRAY16, decoder)
        assert_decodes_like_jax(st.mask_image_filename(i), nl.KIND_MASK8, decoder)
    assert 4 in filters  # PIL's adaptive filtering chose Paeth for some rows


def _pil_images(tmp_path):
    """(path, PIL mode) of images of every colour type PIL writes, with
    alpha only 0 or 255."""
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    rgb[:8] = rng.integers(0, 3, (8, W, 3))  # dark colours: some read as mask 0
    gray = rng.integers(0, 256, (H, W), dtype=np.uint8)
    gray[:8] = rng.integers(0, 2, (8, W))
    alpha = np.where(rng.random((H, W)) < 0.5, 0, 255).astype(np.uint8)
    pal = rng.integers(0, 256, (200, 3), dtype=np.uint8)
    pal[0], pal[1] = 0, (0, 0, 1)
    out = {}

    def save(name, im, **kw):
        path = str(tmp_path / f"{name}.png")
        im.save(path, **kw)
        out[name] = path

    save("gray_alpha", Image.fromarray(np.dstack([gray, alpha]), "LA"))
    save("rgba", Image.fromarray(np.dstack([rgb, alpha]), "RGBA"))
    p8 = Image.fromarray(rng.integers(0, 200, (H, W), dtype=np.uint8), "P")
    p8.putpalette(pal.ravel().tolist())
    save("palette8", p8)
    p4 = Image.fromarray(rng.integers(0, 12, (H, W), dtype=np.uint8), "P")
    p4.putpalette(pal[:12].ravel().tolist())
    save("palette4_trns", p4, transparency=bytes([0, 255, 255, 0] * 3))
    save("gray1", Image.fromarray(gray > 127))
    save("gray_trns", Image.fromarray(gray), transparency=int(gray[9, 3]))
    save("rgb_trns", Image.fromarray(rgb), transparency=tuple(int(x) for x in rgb[9, 3]))
    return out


@pytest.mark.parametrize("decoder", DECODERS)
@pytest.mark.parametrize("image", ["gray_alpha", "rgba", "palette8", "palette4_trns", "gray1",
                                   "gray_trns", "rgb_trns"])
def test_decoders_equal_jax_on_every_colour_type(tmp_path, decoder, image):
    _need(decoder)
    path = _pil_images(tmp_path)[image]
    for kind in (nl.KIND_RGB8, nl.KIND_MASK8):
        for fill in (0, 7):  # a transparent pixel leaves the buffer as it was
            assert_decodes_like_jax(path, kind, decoder, fill)


def _filtered_png(path, rows, bpp, color, depth, filters):
    """A PNG of scanlines ``rows`` ([H, stride] uint8) with row y filtered by
    ``filters[y]``, encoded byte by byte from the PNG specification."""
    h, n = rows.shape
    raw = bytearray()
    for y in range(h):
        cur = rows[y].astype(int)
        prior = rows[y - 1].astype(int) if y else np.zeros(n, int)
        out = []
        for i in range(n):
            a = cur[i - bpp] if i >= bpp else 0
            b, c = prior[i], (prior[i - bpp] if i >= bpp else 0)
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            pred = (0, a, b, (a + b) // 2, paeth)[filters[y]]
            out.append((cur[i] - pred) & 0xFF)
        raw += bytes([filters[y]] + out)

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(
            ">I", zlib.crc32(body, zlib.crc32(t)))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", W, h, depth, color, 0, 0, 0)) + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("mix", ["none", "sub", "up", "average", "paeth", "random"])
@pytest.mark.parametrize("kind", ["rgb8", "gray16", "gray8"])
def test_zlib_decoder_undoes_every_filter_and_mix(tmp_path, mix, kind):
    rng = np.random.default_rng(len(mix) * 7 + len(kind))
    color, depth, bpp, k = {"rgb8": (2, 8, 3, nl.KIND_RGB8), "gray16": (0, 16, 2, nl.KIND_GRAY16),
                            "gray8": (0, 8, 1, nl.KIND_MASK8)}[kind]
    h = 12
    img = rng.integers(0, 256, (h, W * bpp), dtype=np.uint8)
    img[3:6] = img[2]  # runs where the predictions tie
    filters = {"none": [0] * h, "sub": [1] * h, "up": [2] * h, "average": [3] * h,
               "paeth": [4] * h, "random": rng.integers(0, 5, h).tolist()}[mix]
    path = str(tmp_path / "f.png")
    _filtered_png(path, img, bpp, color, depth, filters)
    shape, dtype = ((h, W, 3), np.uint8) if k == nl.KIND_RGB8 else ((h, W), SHAPES[k][1])
    want = img.reshape(shape) if depth == 8 else img.view(">u2").astype(np.uint16).reshape(shape)
    if k == nl.KIND_MASK8:
        want = (want > 0).astype(np.uint8)
    got, ref = np.zeros(shape, dtype), np.zeros(shape, dtype)
    nl.decode_batch([(path, k, got)], h, W, decoder="zlib")
    jax_loader.decode_batch([(path, k, ref)], h, W)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ref, want)


def test_mask_of_every_rgb_triple_equals_libpng(tmp_path):
    """libpng makes a colour pixel gray in linear light before a mask's
    nonzero test, so dark colours read as 0: all 256^3 triples, 16 values
    of red at a time."""
    v = np.arange(256, dtype=np.uint8)
    g, b = np.meshgrid(v, v, indexing="ij")
    h, w = 16 * 256, 256
    path = str(tmp_path / "rgb.png")
    zeros = 0
    for r0 in range(0, 256, 16):
        r = np.repeat(np.arange(r0, r0 + 16, dtype=np.uint8), 256 * 256).reshape(h, w)
        img = np.stack([r, np.tile(g, (16, 1)), np.tile(b, (16, 1))], -1)
        nl.encode_batch([(path, nl.KIND_ENC_RGB8, img)], h, w, decoder="zlib")
        got, want = np.zeros((h, w), np.uint8), np.zeros((h, w), np.uint8)
        nl.decode_batch([(path, nl.KIND_MASK8, got)], h, w, decoder="zlib")
        jax_loader.decode_batch([(path, nl.KIND_MASK8, want)], h, w)
        np.testing.assert_array_equal(got, want, err_msg=f"red {r0}..{r0 + 15}")
        zeros += int((want == 0).sum())
    assert 1 < zeros < 256**3  # dark colours other than black read as 0


def test_partly_transparent_pixels_raise_under_zlib_and_match_jax_under_libpng(tmp_path):
    rng = np.random.default_rng(5)
    rgba = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    path = str(tmp_path / "partial.png")
    Image.fromarray(rgba, "RGBA").save(path)
    with pytest.raises(ValueError, match="partly transparent"):
        _decode(lambda it: nl.decode_batch(it, H, W, decoder="zlib"), path, nl.KIND_RGB8)
    _need("libpng")
    assert_decodes_like_jax(path, nl.KIND_RGB8, "libpng", fill=9)


@pytest.mark.parametrize("decoder", DECODERS)
def test_missing_files_wrong_sizes_and_unread_kinds_raise(tmp_path, decoder):
    _need(decoder)
    path = str(tmp_path / "f.png")
    Image.fromarray(np.zeros((H, W, 3), np.uint8)).save(path)
    with pytest.raises(FileNotFoundError):
        nl.decode_batch([(str(tmp_path / "none.png"), nl.KIND_RGB8,
                          np.zeros((H, W, 3), np.uint8))], H, W, decoder=decoder)
    with pytest.raises(ValueError):
        nl.decode_batch([(path, nl.KIND_RGB8, np.zeros((H + 1, W, 3), np.uint8))], H + 1, W,
                        decoder=decoder)
    with pytest.raises(ValueError):  # an out array of the wrong dtype
        nl.decode_batch([(path, nl.KIND_GRAY16, np.zeros((H, W), np.uint8))], H, W,
                        decoder=decoder)
    with pytest.raises(ValueError):
        nl.encode_batch([(path, nl.KIND_ENC_RGB8, np.zeros((H, W), np.uint8))], H, W,
                        decoder=decoder)


def test_zlib_decoder_refuses_what_it_does_not_reproduce(tmp_path):
    path = str(tmp_path / "rgb.png")
    Image.fromarray(np.full((H, W, 3), 9, np.uint8)).save(path)
    with pytest.raises(ValueError, match="16-bit gray"):
        _decode(lambda it: nl.decode_batch(it, H, W, decoder="zlib"), path, nl.KIND_GRAY16)
    # an interlaced file: the same header with the interlace byte set
    with open(path, "rb") as f:
        data = bytearray(f.read())
    data[28] = 1
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        _decode(lambda it: nl.decode_batch(it, H, W, decoder="zlib"), path, nl.KIND_RGB8)
    data[data.index(b"IDAT") + 6] ^= 0xFF  # a corrupted IDAT byte fails its CRC
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        _decode(lambda it: nl.decode_batch(it, H, W, decoder="zlib"), path, nl.KIND_RGB8)


@pytest.mark.parametrize("decoder", DECODERS)
def test_port_encoder_round_trips_and_pil_reads_it(tmp_path, decoder):
    _need(decoder)
    rng = np.random.default_rng(6)
    arrays = [(nl.KIND_ENC_RGB8, nl.KIND_RGB8, rng.integers(0, 256, (H, W, 3), dtype=np.uint8)),
              (nl.KIND_ENC_GRAY16, nl.KIND_GRAY16,
               rng.integers(0, 65536, (H, W)).astype(np.uint16)),
              (nl.KIND_ENC_GRAY8, nl.KIND_MASK8,
               (rng.random((H, W)) < 0.3).astype(np.uint8) * 255)]
    items = [(str(tmp_path / f"{k}.png"), k, a) for k, _, a in arrays]
    nl.encode_batch(items, H, W, decoder=decoder)
    for (path, _, a), (_, dk, _) in zip(items, arrays):
        np.testing.assert_array_equal(np.asarray(Image.open(path)), a)
        want = a if dk != nl.KIND_MASK8 else (a > 0).astype(np.uint8)
        for d in DECODERS:
            if d == "libpng" and not nl.probe_libpng()[0]:
                continue
            np.testing.assert_array_equal(
                _decode(lambda it: nl.decode_batch(it, H, W, decoder=d), path, dk), want)
        np.testing.assert_array_equal(
            _decode(lambda it: jax_loader.decode_batch(it, H, W), path, dk), want)
    if decoder == "zlib":  # the port's own files are Up-filtered throughout
        assert _filter_types(items[0][0]) == {2}


def test_auto_picks_once_and_a_failed_libpng_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(nl, "decoder_chosen", None)
    calls = []

    def probe():
        calls.append(1)
        return False, "no png.h (test)"
    monkeypatch.setattr(nl, "probe_libpng", probe)
    assert nl.resolve_decoder("auto") == "zlib" == nl.decoder_chosen
    assert nl.resolve_decoder("auto") == "zlib" and len(calls) == 1
    assert nl.decoder_reason == "no png.h (test)"
    with pytest.raises(ValueError):
        nl.resolve_decoder("pil")

    # the chosen decoder's build fails: the decode raises, nothing is written
    path = str(tmp_path / "f.png")
    Image.fromarray(np.full((H, W, 3), 5, np.uint8)).save(path)
    monkeypatch.setattr(nl, "_lib", None)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "false")
    out = np.zeros((H, W, 3), np.uint8)
    with pytest.raises(RuntimeError, match="false failed on png_loader.cpp"):
        nl.decode_batch([(path, nl.KIND_RGB8, out)], H, W, decoder="libpng")
    assert not out.any()
    monkeypatch.setattr(nl, "decoder_chosen", "libpng")
    with pytest.raises(RuntimeError):
        nl.decode_batch([(path, nl.KIND_RGB8, out)], H, W)
    assert not out.any()


# -- writing scenes ------------------------------------------------------------------------


def test_port_write_scene_reads_back_in_pdc_tpu(tmp_path):
    kw = dict(width=W, height=H, num_frames=4, seed=3, occluder=(0.05, 0.25, -0.1, 0.1, 0.15))
    processed = SyntheticScene(**kw).write_scene(str(tmp_path / "port"))
    jax_processed = JaxSyntheticScene(**kw).write_scene(str(tmp_path / "jax"))
    ours = SceneData.from_structure(SceneStructure(processed), "s")
    theirs = JaxSceneData.from_structure(JaxSceneStructure(processed), "s")
    rgb, depth, mask, poses = SyntheticScene(**kw).render_all()
    for f, want in (("rgb", rgb), ("depth", depth), ("mask", mask)):
        np.testing.assert_array_equal(getattr(ours, f), want)
        np.testing.assert_array_equal(getattr(theirs, f), want)
    np.testing.assert_array_equal(ours.poses, theirs.poses)
    np.testing.assert_allclose(ours.poses, poses, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ours.K, theirs.K)
    assert ours.frame_ids is None and theirs.frame_ids is None
    # the same YAML values and the same mesh file as pdc_tpu writes
    for name in ("images/pose_data.yaml", "images/camera_info.yaml"):
        assert load_yaml(os.path.join(processed, name)) == load_yaml(
            os.path.join(jax_processed, name))
    with open(os.path.join(processed, "fusion_mesh.ply")) as a, \
            open(os.path.join(jax_processed, "fusion_mesh.ply")) as b:
        assert a.read() == b.read()
    sc, jsc = SyntheticScene(**kw), JaxSyntheticScene(**kw)
    np.testing.assert_array_equal(sc.fusion_points(), jsc.fusion_points())


# -- the layout's quirks, geometry ----------------------------------------------------------


def test_layout_quirks_equal_pdc_tpu(layout):
    processed = os.path.join(layout["root"], "logs_proto", "scene_2", "processed")
    st, jst = SceneStructure(processed), JaxSceneStructure(processed)
    pose, jpose = st.load_pose_data(), jst.load_pose_data()
    assert sorted(pose) == sorted(jpose) == [1, 3, 20, 29, 37, 54]
    for k in pose:
        np.testing.assert_array_equal(pose[k], jpose[k])
    assert st.frame_indices() == jst.frame_indices() == [3, 20, 37, 54]
    assert st.load_camera_intrinsics() == CameraIntrinsics(**vars(jst.load_camera_intrinsics()))
    ours = SceneData.from_structure(st, "scene_2", object_id="disc")
    theirs = JaxSceneData.from_structure(jst, "scene_2", object_id="disc")
    np.testing.assert_array_equal(ours.frame_ids, [3, 20, 37, 54])
    np.testing.assert_array_equal(ours.frame_ids, theirs.frame_ids)
    for f in ("rgb", "depth", "mask", "poses", "K"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f))
    for idx in (3, 20, 54):
        assert ours.position(idx) == theirs.position(idx)
    for bad in (1, 29, 4):  # orphan pose keys and a missing index
        with pytest.raises(KeyError):
            ours.position(bad)
    assert [ours.frame_id(p) for p in range(4)] == [theirs.frame_id(p) for p in range(4)]
    for i in (3, 54):
        assert st.mask_image_filename(i) == jst.mask_image_filename(i)
        assert st.descriptor_image_filename("n", i) == jst.descriptor_image_filename("n", i)


def test_port_yaml_reader_reads_the_layout_files_as_pyyaml(layout):
    """The card's machine has no PyYAML: there the port reads every file of
    the layout and the configs with its own reader."""
    import yaml

    files = []  # the composite, 2 scene lists and each scene's pose data and camera info
    for d, _, names in os.walk(layout["root"]):
        files += [os.path.join(d, n) for n in names if n.endswith(".yaml")]
    assert len(files) == 1 + 2 + 3 * 2
    for path in files:
        with open(path) as f:
            text = f.read()
        assert parse_yaml(text) == yaml.safe_load(text), path


def test_pose_dicts_and_quaternions_equal_pdc_tpu():
    rng = np.random.default_rng(8)
    mats = [np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]), np.diag([-1.0, -1, 1])]
    for _ in range(20):
        q = rng.standard_normal(4)
        mats.append(transforms.quaternion_matrix(q))
    for R in mats:  # every branch of Shepperd's method
        np.testing.assert_array_equal(transforms.quaternion_from_matrix(R),
                                      jax_transforms.quaternion_from_matrix(R))
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, rng.standard_normal(3)
        d = transforms.dict_from_se3(T)
        assert d == jax_transforms.dict_from_se3(T)
        np.testing.assert_allclose(transforms.se3_from_dict(d), T, atol=1e-12)
        for key in ("orientation", "rotation"):
            alt = {key: d["quaternion"], "translation": d["translation"]}
            np.testing.assert_array_equal(transforms.se3_from_dict(alt),
                                          jax_transforms.se3_from_dict(alt))
    with pytest.raises(ValueError, match="quaternion"):
        transforms.se3_from_dict({"translation": {"x": 0, "y": 0, "z": 0}})


def test_camera_info_variants_equal_pdc_tpu(layout, tmp_path):
    ros = os.path.join(layout["root"], "logs_proto", "scene_0", "processed", "images",
                       "camera_info.yaml")
    plain = str(tmp_path / "camera_info.yaml")
    save_yaml({"camera_matrix": {"data": [50.0, 0.0, 31.5, 0.0, 51.0, 23.5, 0.0, 0.0, 1.0]},
               "image_width": W, "image_height": H}, plain)
    for path in (ros, plain):
        ours = CameraIntrinsics.from_yaml_file(path)
        theirs = jax_camera.CameraIntrinsics.from_yaml_file(path)
        assert vars(ours) == vars(theirs)
        np.testing.assert_array_equal(ours.K, theirs.K)


# -- composite configs -----------------------------------------------------------------------


def test_composite_sampling_equals_pdc_tpu_for_200_pairs(layout):
    from tests.test_torch_port_dataset import assert_pairs_equal, training_config

    port, ref = _datasets(layout)
    assert port._registries == {}  # nothing decoded before the first use
    for ds in (port, ref):
        ds.set_parameters_from_training_config(training_config(MIX))
    types = set()
    for _ in range(200):
        p, q = port.sample_pair(), ref.sample_pair()
        assert_pairs_equal(p, q)
        types.add(p.match_type)
    assert types == {0, 1, 2}
    assert set(port._registries) == {"train"}  # the test split is not decoded yet
    assert port.get_scene_list() == ref.get_scene_list()
    assert port.get_list_of_objects() == ref.get_list_of_objects() == ["disc_a", "disc_b"]
    np.testing.assert_array_equal(port.make_host_batch(3)["rgb_a"], ref.make_host_batch(3)["rgb_a"])
    port.set_test_mode()
    ref.set_test_mode()
    assert port.get_scene_list() == ref.get_scene_list() == ["scene_2", "scene_0"]
    for _ in range(20):
        assert_pairs_equal(port.sample_pair(0), ref.sample_pair(0))
    name = port.get_image_filename("scene_0", 20, 0)
    assert name == ref.get_image_filename("scene_0", 20, 0) and name.endswith("000020_rgb.png")
    assert port.get_full_path_for_scene("scene_0") == ref.get_full_path_for_scene("scene_0")


def test_config_snapshot_and_from_dataset_config_equal_pdc_tpu(layout, monkeypatch, tmp_path):
    port, ref = _datasets(layout)
    snap = port.config_snapshot()
    assert snap == ref.config_snapshot()
    assert snap["data_dir"] == os.path.abspath(layout["root"])
    assert snap["config_dir"] == os.path.abspath(layout["config_dir"])
    # the record alone rebuilds the dataset, from any working directory
    monkeypatch.chdir(tmp_path)
    for mode in ("train", "test"):
        ours = SpartanDataset.from_dataset_config(dict(snap), mode=mode)
        theirs = JaxSpartanDataset.from_dataset_config(dict(snap), mode=mode)
        assert ours.get_scene_list() == theirs.get_scene_list()
        for name in ours.get_scene_list():
            a, b = ours.get_scene(name), theirs.get_scene(name)
            np.testing.assert_array_equal(a.frame_ids, b.frame_ids)
            np.testing.assert_array_equal(a.poses, b.poses)
            np.testing.assert_array_equal(a.rgb, b.rgb)
    # an in-memory dataset records no directories
    assert "data_dir" not in SpartanDataset.make_synthetic(
        num_scenes=1, width=W, height=H, num_frames=2).config_snapshot()


def test_scene_list_lookup_equals_pdc_tpu(layout, tmp_path):
    cdir = layout["config_dir"]
    (tmp_path / "composite").mkdir()
    save_yaml({"scenes": ["x"]}, str(tmp_path / "composite" / "local.yaml"))
    cases = [("disc_a.yaml", cdir), ("missing.yaml", cdir), ("/abs/list.yaml", cdir),
             ("disc_a.yaml", None), ("local.yaml", str(tmp_path / "composite"))]
    for name, d in cases:
        assert config_gen.resolve_scene_list_path(name, d) == \
            jax_config_gen.resolve_scene_list_path(name, d)
    assert config_gen.resolve_scene_list_path("disc_a.yaml", cdir).endswith(
        os.path.join("single_object", "disc_a.yaml"))
    names = config_gen.scene_names_in_composite(layout["composite"], cdir)
    assert names == jax_config_gen.scene_names_in_composite(layout["composite"], cdir)
    assert names == ["scene_0", "scene_1", "scene_2"]


# -- training from the command line ----------------------------------------------------------


def _cli_config(path):
    cfg = DenseCorrespondenceTraining.load_default_config()
    t = cfg["training"]
    t.update(batch_size=2, num_matching_attempts=256, num_non_matches_per_match=10,
             cross_scene_num_samples=128, save_rate=1000, logging_rate=1000,
             masked_pool_size=64, background_pool_size=64, num_blind_samples=100,
             use_tensorboard=False, compute_test_loss=True, compute_test_loss_rate=6,
             test_loss_num_iterations=2)
    net = cfg["dense_correspondence_network"]
    net.update(image_width=W, image_height=H)
    net["backbone"]["resnet_name"] = "Resnet18_8s"
    save_yaml(cfg, path)
    return cfg


def test_cli_train_writes_a_folder_pdc_tpu_loads(layout, tmp_path, capsys):
    cfg_path = str(tmp_path / "training.yaml")
    _cli_config(cfg_path)
    argv = ["train", "--config", cfg_path, "--dataset_config", layout["composite_file"],
            "--data_dir", layout["root"], "--name", "cli_run", "--logging_dir",
            str(tmp_path / "models"), "--num_iterations", "2", "--device", "cpu"]
    assert cli.main(argv) == 0
    folder = str(tmp_path / "models" / "cli_run")
    assert f"trained model folder: {folder}" in capsys.readouterr().out
    assert {"000000.ckpt", "000002.ckpt", "000002.ckpt.opt", "dataset.yaml"} <= set(
        os.listdir(folder))
    record = load_yaml(os.path.join(folder, "dataset.yaml"))
    assert record["data_dir"] == os.path.abspath(layout["root"])
    assert record["config_dir"] == os.path.abspath(layout["config_dir"])
    history = load_yaml(os.path.join(folder, "000002_log_history.yaml"))
    assert history["train"]["iteration"] == [1, 2]
    assert all(np.isfinite(history["train"]["loss"]))

    pdcn = DenseCorrespondenceNetwork.from_model_folder(folder, device="cpu")
    jdcn = JaxDCN.from_model_folder(folder)
    frame = SceneData.from_structure(SceneStructure(os.path.join(
        layout["root"], "logs_proto", "scene_1", "processed")), "s").rgb[2]
    want = np.asarray(jdcn.forward_on_img(frame))
    got = pdcn.forward_on_img(frame).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))
    rebuilt, jrebuilt = pdcn.load_training_dataset(), jdcn.load_training_dataset()
    assert rebuilt.get_scene_list() == jrebuilt.get_scene_list() == ["scene_0", "scene_1",
                                                                      "scene_2"]
    for name in rebuilt.get_scene_list():
        np.testing.assert_array_equal(rebuilt.get_scene(name).frame_ids,
                                      jrebuilt.get_scene(name).frame_ids)
        np.testing.assert_array_equal(rebuilt.get_scene(name).poses,
                                      jrebuilt.get_scene(name).poses)


def test_cli_train_refuses_unported_flags_and_a_missing_card(layout, monkeypatch, capsys):
    base = ["train", "--dataset_config", layout["composite_file"], "--data_dir", layout["root"]]
    # every parallel flag is ported: without a card they need it, as plain train does
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in (["--data_parallel"], ["--data_parallel", "--fsdp"], ["--tensor_parallel", "2"],
                  ["--pipeline", "2"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(base + extra)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(base)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["statistics", "--config", layout["composite_file"], "--data_dir",
                  layout["root"]])


# -- statistics, LabelFusion, reference checkpoints --------------------------------------------


def test_statistics_equal_pdc_tpu_and_float64(layout, capsys):
    port, ref = _datasets(layout)
    mean, std = statistics.compute_image_mean_and_std_dev(port, num_images=10, batch_size=4,
                                                          device="cpu")
    jmean, jstd = jax_statistics.compute_image_mean_and_std_dev(ref, num_images=10,
                                                                batch_size=4)
    # float64 over the same frames (a fresh dataset draws the same sequence):
    # the port's integer sums are exact, so only the final divisions round
    again, _ = _datasets(layout)
    frames = []
    for _ in range(10):
        name = again.get_random_scene_name()
        frames.append(again.get_rgbd_mask_pose(name, again.get_random_image_index(name))[0])
    x = np.stack(frames).reshape(-1, 3).astype(np.float64) / 255.0
    np.testing.assert_allclose(mean, x.mean(0), rtol=0, atol=1e-12)
    np.testing.assert_allclose(std, x.std(0), rtol=0, atol=1e-12)
    # pdc_tpu sums each batch of m = 4 x 48 x 64 values per channel in
    # float32; such a sum is off by about 2^-24 sqrt(m) of the batch's sum,
    # 6.6e-6 relative here (measured: 1.1e-6 on the means, fault F6 of
    # ROADMAP.md), so the port is held to it within that, and to float64
    # within 1e-12 above
    tol = 2.0**-24 * np.sqrt(4 * H * W)
    np.testing.assert_allclose(mean, jmean, rtol=tol, atol=0)
    np.testing.assert_allclose(std, jstd, rtol=tol, atol=0)
    # the command prints the block, rounded to 6 digits
    assert cli.main(["statistics", "--config", layout["composite_file"], "--data_dir",
                     layout["root"], "--num_images", "10", "--device", "cpu"]) == 0
    block = parse_yaml(capsys.readouterr().out)["image_normalization"]
    np.testing.assert_allclose(block["mean"], mean, rtol=0, atol=5e-7)
    np.testing.assert_allclose(block["std_dev"], std, rtol=0, atol=5e-7)


def test_labelfusion_log_equals_pdc_tpu(tmp_path):
    sc = SyntheticScene(width=W, height=H, num_frames=3, seed=2)
    (tmp_path / "images").mkdir()
    lines = []
    for i in range(3):
        rgb, depth, mask, pose = sc.render(i)
        utime = 1_000_000 * (i + 1)
        Image.fromarray(rgb).save(str(tmp_path / "images" / f"{utime:010d}_rgb.png"))
        Image.fromarray(depth).save(str(tmp_path / "images" / f"{utime:010d}_depth.png"))
        if i != 1:  # frame 1 has no labels image: its mask is all ones
            Image.fromarray(mask * 3).save(str(tmp_path / "images" / f"{utime:010d}_labels.png"))
        w, x, y, z = transforms.quaternion_from_matrix(pose).tolist()
        t = pose[:3, 3].tolist()
        lines.append(f"{utime} {t[0]!r} {t[1]!r} {t[2]!r} {x!r} {y!r} {z!r} {w!r}")
    (tmp_path / "posegraph.posegraph").write_text("\n".join(lines + ["short line"]) + "\n")
    ours, theirs = LabelFusionScene(str(tmp_path)), JaxLabelFusionScene(str(tmp_path))
    assert ours.num_frames == theirs.num_frames == 3
    for i in range(3):
        assert ours.rgb_path(i) == theirs.rgb_path(i)
        for a, b in zip(ours.load_frame(i), theirs.load_frame(i)):
            np.testing.assert_array_equal(a, b)
    a, b = ours.to_scene_data("lf", sc.K, "obj"), theirs.to_scene_data("lf", sc.K, "obj")
    for f in ("rgb", "depth", "mask", "poses", "K"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.mask[1].all()


def _to_torchvision(name):
    name = name.replace("stem_conv", "conv1").replace("stem_bn", "bn1").replace("head.", "fc.")
    name = name.replace("proj_conv", "downsample.0").replace("proj_bn", "downsample.1")
    if name.startswith("stage"):
        stage, rest = name.split("_block", 1)
        block, rest = rest.split(".", 1)
        name = f"layer{stage[5:]}.{block}.{rest}"
    return name


def _reference_state_dict(module, prefix):
    """A reference-trained DCN's state dict of ``module``'s shapes, with
    random values: torchvision names under ``prefix``, the head as ``fc``."""
    g = np.random.default_rng(11)
    return {prefix + _to_torchvision(k): torch.from_numpy(
        (g.random(tuple(v.shape)) + ("running_var" in k)).astype(np.float32))
        for k, v in module.state_dict().items() if not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("prefix", ["fcn.resnet18_8s.", "resnet18_8s.", "module.fcn.resnet18_8s.",
                                    "module.resnet18_8s."])
def test_reference_checkpoints_convert_exactly_as_pdc_tpu(prefix, tmp_path):
    module = init_weights_(ResNet18_8s(D), torch.Generator().manual_seed(0))
    sd = _reference_state_dict(module, prefix)
    got = torch_import.convert_reference_dcn(sd, module.state_dict())
    want = flax_to_state_dict(jax_torch_import.convert_reference_dcn(
        {k: v.numpy() for k, v in sd.items()}, state_dict_to_flax(module.state_dict())))
    assert set(got) == set(want)
    for name, value in want.items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(got[name], value), name
    assert torch.equal(got["head.weight"], sd[prefix + "fc.weight"])
    with pytest.raises(ValueError, match="reference DCN"):
        torch_import.convert_reference_dcn({"encoder.w": torch.zeros(3)}, module.state_dict())
    bad = dict(sd)
    bad[prefix + "fc.weight"] = torch.zeros(D + 1, 512, 1, 1)
    with pytest.raises(ValueError, match="fc.weight"):
        torch_import.convert_reference_dcn(bad, module.state_dict())

    # a reference model folder: training.yaml and %06d.pth files
    folder = tmp_path / "ref_net"
    folder.mkdir()
    torch.save(sd, str(folder / "000500.pth"))
    torch.save(_reference_state_dict(module, "x."), str(folder / "000100.pth"))
    save_yaml({"dense_correspondence_network": {
        "backbone": {"model_class": "Resnet", "resnet_name": "Resnet18_8s"},
        "descriptor_dimension": D, "image_width": W, "image_height": H, "normalize": False}},
        str(folder / "training.yaml"))
    dcn = DenseCorrespondenceNetwork.from_reference_model_folder(str(folder), device="cpu")
    assert dcn.config["model_param_filename_tail"] == "000500.pth"
    for name, value in dcn.module.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(value, got[name]), name
