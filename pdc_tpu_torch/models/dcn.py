"""DenseCorrespondenceNetwork — the user-facing model wrapper, in PyTorch.

Port of :class:`pdc_tpu.models.dcn.DenseCorrespondenceNetwork` with the same
public contracts: ``[B, H, W, 3]`` images in and ``[B, H, W, D]`` descriptor
images out (NHWC at the API, NCHW inside the module), flat pixel index
``n = v*W + u``, and the model-folder layout (``training.yaml`` +
``%06d.ckpt``). Checkpoints are the JAX package's flax msgpack files, read
and written by :mod:`pdc_tpu_torch.models.checkpoint`, so a folder trained by
``pdc_tpu`` serves here and the other way round.

Every constructor takes ``device`` (default ``"cuda"``), and raises without
CUDA unless ``device="cpu"`` is asked for. The wrapper's forward passes
(``forward``, ``forward_single_image_tensor``, ``forward_on_img``) always run
the module in eval mode and without gradients, as the reference applies
``train=False``: whatever mode the caller left the module in (training
switches it to train mode, :mod:`pdc_tpu_torch.training.train`), the call
neither uses nor moves BatchNorm's batch statistics, and the caller's mode is
restored afterwards.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np
import torch

from pdc_tpu_torch.models.checkpoint import read_checkpoint, write_checkpoint
from pdc_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from pdc_tpu_torch.models.resnet import (
    ResNet18_8s,
    ResNet34_8s,
    ResNet50_8s,
    ResNet101_8s,
    init_weights_,
    int8_convs,
    quantized_copy,
    set_quantization,
)
from pdc_tpu_torch.models.unet import UNet
from pdc_tpu_torch.ops.matching import (
    best_match_for_descriptor,
    best_matches_batch,
)
from pdc_tpu_torch.utils.constants import (
    DEFAULT_IMAGE_HEIGHT,
    DEFAULT_IMAGE_MEAN,
    DEFAULT_IMAGE_STD,
    DEFAULT_IMAGE_WIDTH,
)
from pdc_tpu_torch.utils.device import resolve_device
from pdc_tpu_torch.utils.yaml_io import load_yaml

_FACTORIES = {"Resnet18_8s": ResNet18_8s, "Resnet34_8s": ResNet34_8s,
              "Resnet50_8s": ResNet50_8s, "Resnet101_8s": ResNet101_8s}


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_backbone(config: dict, dtype=None):
    """The FCN for a ``dense_correspondence_network`` config block
    (``pdc_tpu/models/dcn.py:51-86``): ``backbone.model_class`` ``Resnet``
    (``resnet_name`` Resnet18/34/50/101_8s, with ``dilated_s2b`` and
    ``remat``) or ``Unet``, and ``quant_int8`` (the int8 serving
    convolutions; training runs the float ones). The compute dtype is
    ``dtype`` when given, else the config's ``compute_dtype`` (``float32``
    or ``bfloat16``); the parameters are float32 either way.
    """
    backbone = config.get("backbone", {"model_class": "Resnet", "resnet_name": "Resnet34_8s"})
    if dtype is None:
        name = config.get("compute_dtype", "float32")
        if name not in _DTYPES:
            raise ValueError(f"unsupported compute_dtype {name!r}: float32 or bfloat16")
        dtype = _DTYPES[name]
    d = config["descriptor_dimension"]
    if backbone["model_class"] == "Resnet":
        name = backbone.get("resnet_name", "Resnet34_8s")
        if name not in _FACTORIES:
            raise ValueError(f"unsupported resnet_name: {name}")
        fcn = _FACTORIES[name](d, dilated_s2b=bool(config.get("dilated_s2b", False)),
                               dtype=dtype, remat=bool(config.get("remat", False)))
    elif backbone["model_class"] == "Unet":
        fcn = UNet(d, dtype=dtype)
    else:
        raise ValueError(f"unknown backbone model_class: {backbone['model_class']}")
    if config.get("quant_int8", False):
        set_quantization(fcn, True)
    return fcn


class DenseCorrespondenceNetwork:
    def __init__(self, module, descriptor_dimension: int,
                 image_width: int = DEFAULT_IMAGE_WIDTH,
                 image_height: int = DEFAULT_IMAGE_HEIGHT,
                 normalize: bool = False, config: Optional[dict] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.module = module.to(self.device).eval()
        self._descriptor_dimension = descriptor_dimension
        self._image_width = image_width
        self._image_height = image_height
        self._normalize = normalize
        self.config = dict(config or {})
        self._image_mean = np.asarray(DEFAULT_IMAGE_MEAN)
        self._image_std_dev = np.asarray(DEFAULT_IMAGE_STD)
        self._descriptor_image_stats = None
        self.model_folder = None

    # -- properties mirroring the reference ----------------------------------

    @property
    def descriptor_dimension(self):
        return self._descriptor_dimension

    @property
    def image_shape(self):
        return [self._image_height, self._image_width]

    @property
    def image_mean(self):
        return self._image_mean

    @image_mean.setter
    def image_mean(self, value):
        self._image_mean = np.asarray(value)

    @property
    def image_std_dev(self):
        return self._image_std_dev

    @image_std_dev.setter
    def image_std_dev(self, value):
        self._image_std_dev = np.asarray(value)

    @property
    def path_to_network_params_folder(self):
        if "path_to_network_params_folder" not in self.config:
            raise ValueError("config has no path_to_network_params_folder entry")
        return self.config["path_to_network_params_folder"]

    @property
    def descriptor_image_stats(self):
        """Lazily loads descriptor_statistics.yaml from the model folder."""
        if self._descriptor_image_stats is None:
            stats_file = os.path.join(
                self.path_to_network_params_folder, "descriptor_statistics.yaml")
            self._descriptor_image_stats = load_yaml(stats_file)
        return self._descriptor_image_stats

    @property
    def fcn(self):
        """The backbone module."""
        return self.module

    @property
    def unique_identifier(self):
        """'<id>+<checkpoint tail>' for a folder with an identifier.yaml,
        else None."""
        folder = self.config.get("path_to_network_params_folder")
        if not folder:
            return None
        path = os.path.join(folder, "identifier.yaml")
        if not os.path.exists(path):
            return None
        ident = load_yaml(path).get("id")
        if ident is None:
            return None
        tail = self.config.get("model_param_filename_tail", "")
        return f"{ident}+{tail}"

    @property
    def constructed_from_model_folder(self) -> bool:
        return bool(self.config.get("path_to_network_params_folder"))

    # -- forward passes -------------------------------------------------------

    def forward(self, img_tensor):
        """Forward a batch of already-normalized images, in eval mode
        whatever the module's mode (restored afterwards, also on an error).

        :param img_tensor: [B, H, W, 3] float32 (NHWC, as in ``pdc_tpu``)
        :return: [B, H, W, D] descriptor images on ``self.device``, in the
            module's output dtype (bfloat16 from a bfloat16 ResNet, as in
            ``pdc_tpu``; consumers upcast where they accumulate)
        """
        x = torch.as_tensor(img_tensor, dtype=torch.float32, device=self.device)
        modes = [(m, m.training) for m in self.module.modules()]
        self.module.eval()
        try:
            with torch.inference_mode():
                out = self.module(x.permute(0, 3, 1, 2).contiguous())
                if self._normalize:
                    norm = torch.linalg.vector_norm(out, dim=1, keepdim=True)
                    out = out / torch.clamp(norm, min=1e-12)
                return out.permute(0, 2, 3, 1).contiguous()
        finally:
            for m, training in modes:
                m.training = training

    def forward_on_img_tensor(self, img):
        """[H, W, 3] float RGB in [0, 1] -> descriptor image, WITHOUT the
        mean/std normalisation, as the reference's deprecated method runs
        it. Deprecated (warns): use :meth:`forward_on_img` or
        :meth:`forward`."""
        import warnings

        warnings.warn("use forward/forward_on_img instead", DeprecationWarning)
        return self.forward_single_image_tensor(img)

    def forward_single_image_tensor(self, img_tensor):
        """[H, W, 3] normalized image -> [H, W, D] descriptor image."""
        x = torch.as_tensor(img_tensor, dtype=torch.float32, device=self.device)
        if x.dim() != 3:
            raise ValueError(f"need one [H, W, 3] image, got shape {tuple(x.shape)}")
        return self.forward(x[None])[0]

    def normalize_on_device(self, rgb_u8):
        """uint8 RGB ``[..., H, W, 3]`` (numpy, or a tensor on any device)
        -> float32 on ``self.device``, ``(x / 255 - mean) / std``. The
        frames cross to the device as uint8."""
        if not isinstance(rgb_u8, torch.Tensor):
            rgb_u8 = torch.from_numpy(np.ascontiguousarray(rgb_u8))
        x = rgb_u8.to(self.device).to(torch.float32) / 255.0
        mean = torch.as_tensor(self._image_mean, dtype=torch.float32, device=self.device)
        std = torch.as_tensor(self._image_std_dev, dtype=torch.float32, device=self.device)
        return (x - mean) / std

    def forward_on_img(self, img):
        """uint8 RGB [H, W, 3] -> descriptor image; applies the stored
        mean/std normalization."""
        return self.forward_single_image_tensor(self.normalize_on_device(img))

    def forward_on_images(self, imgs):
        """uint8 RGB ``[B, H, W, 3]`` -> ``[B, H, W, D]`` descriptor images on
        ``self.device``: one forward of the batch, normalised as
        :meth:`forward_on_img` normalises one frame."""
        return self.forward(self.normalize_on_device(imgs))

    def process_network_output(self, image_pred, N: int):
        """[N, H, W, D] -> [N, H*W, D]; row-major over (v, u), so flat index
        n = v*W + u."""
        D = self._descriptor_dimension
        return torch.reshape(torch.as_tensor(image_pred),
                             (N, self._image_height * self._image_width, D))

    def clip_pixel_to_image_size_and_round(self, uv):
        u = min(int(round(uv[0])), self._image_width - 1)
        v = min(int(round(uv[1])), self._image_height - 1)
        return [max(u, 0), max(v, 0)]

    # -- best match ------------------------------------------------------------

    @staticmethod
    def find_best_match(pixel_a, res_a, res_b, mask_b=None):
        """Best match in image b for the descriptor at ``pixel_a`` in image a.

        :return: (best_match_uv [2] int32, best_match_diff, norm_diffs [H, W]).
            ``mask_b`` is accepted and ignored, as in ``pdc_tpu``.
        """
        res_a = torch.as_tensor(res_a)
        d = res_a[int(pixel_a[1]), int(pixel_a[0])]
        return best_match_for_descriptor(d, torch.as_tensor(res_b, device=res_a.device))

    @staticmethod
    def find_best_match_for_descriptor(descriptor, res):
        return best_match_for_descriptor(descriptor, res)

    @staticmethod
    def find_best_matches_batch(queries, res, mask=None):
        return best_matches_batch(queries, res, mask=mask)

    def evaluate_descriptor_at_keypoints(self, res, keypoints_uv):
        """Gather descriptors at (u, v) keypoints -> [N, D] float32 numpy."""
        res = torch.as_tensor(res)
        kp = np.asarray(keypoints_uv)
        u = np.clip(np.round(kp[:, 0]).astype(int), 0, self._image_width - 1)
        v = np.clip(np.round(kp[:, 1]).astype(int), 0, self._image_height - 1)
        return res[torch.as_tensor(v), torch.as_tensor(u), :].cpu().numpy().astype(np.float32)

    def load_training_dataset(self, mode: str = "train"):
        """Rebuild the dataset this network was trained on from its model
        folder's ``dataset.yaml`` record."""
        from pdc_tpu_torch.data.dataset import SpartanDataset

        folder = self.model_folder or self.path_to_network_params_folder
        config = load_yaml(os.path.join(folder, "dataset.yaml"))
        return SpartanDataset.from_dataset_config(config, mode=mode)

    # -- constructors ----------------------------------------------------------

    @staticmethod
    def from_config(config: dict, generator: Optional[torch.Generator] = None,
                    load_stored_params: bool = False,
                    model_param_file: Optional[str] = None, device="cuda",
                    dtype=torch.float32):
        """Build (and optionally load) a network from a
        ``dense_correspondence_network`` config block, computing in
        ``dtype`` (float32 unless asked: ``pdc_tpu``'s default, which a
        config's ``compute_dtype`` does not change here; ``None`` takes the
        config's).

        Weights are drawn on the CPU from ``generator`` (default: seed 0), so
        they are the same on every device. ``backbone.pretrained`` without
        stored params loads the ImageNet backbone from a local file
        (:func:`~pdc_tpu_torch.models.torch_import.resolve_pretrained_weights`;
        ``FileNotFoundError`` when there is none, never a download).
        """
        device = resolve_device(device)
        module = build_backbone(config, dtype=dtype)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights_(module, generator)
        if (config.get("backbone") or {}).get("pretrained") and not load_stored_params:
            from pdc_tpu_torch.models.torch_import import maybe_load_pretrained_backbone

            maybe_load_pretrained_backbone(module, config)
        dcn = DenseCorrespondenceNetwork(
            module,
            descriptor_dimension=config["descriptor_dimension"],
            image_width=config.get("image_width", DEFAULT_IMAGE_WIDTH),
            image_height=config.get("image_height", DEFAULT_IMAGE_HEIGHT),
            normalize=config.get("normalize", False),
            config=config,
            device=device,
        )
        if load_stored_params:
            if model_param_file is None:
                raise ValueError("load_stored_params needs model_param_file")
            dcn.load_checkpoint(model_param_file)
        return dcn

    @staticmethod
    def from_model_folder(model_folder: str, model_param_file: Optional[str] = None,
                          iteration: Optional[int] = None, device="cuda",
                          dtype=torch.float32):
        """Reconstruct a network from a training output folder holding
        ``training.yaml`` and ``%06d.ckpt`` files. It computes in ``dtype``,
        float32 by default, as in ``pdc_tpu``: a folder trained with
        ``compute_dtype: bfloat16`` serves in float32 unless
        ``dtype=torch.bfloat16`` is asked for."""
        device = resolve_device(device)
        training_config = load_yaml(os.path.join(model_folder, "training.yaml"))
        config = dict(training_config["dense_correspondence_network"])
        config["path_to_network_params_folder"] = model_folder
        if model_param_file is None:
            model_param_file = find_latest_checkpoint(model_folder, iteration)
        config["model_param_filename_tail"] = os.path.basename(model_param_file)
        dcn = DenseCorrespondenceNetwork.from_config(
            config, load_stored_params=True, model_param_file=model_param_file,
            device=device, dtype=dtype)
        dcn.model_folder = model_folder
        return dcn

    @staticmethod
    def from_reference_model_folder(model_folder: str, model_param_file: Optional[str] = None,
                                    iteration: Optional[int] = None, device="cuda",
                                    dtype=torch.float32):
        """Reconstruct a network from a model folder written by the reference
        framework: ``training.yaml`` and torch ``%06d.pth`` checkpoints
        (:func:`~pdc_tpu_torch.models.torch_import.load_reference_checkpoint`)."""
        from pdc_tpu_torch.models.torch_import import load_reference_checkpoint

        device = resolve_device(device)
        training_config = load_yaml(os.path.join(model_folder, "training.yaml"))
        config = dict(training_config["dense_correspondence_network"])
        config["path_to_network_params_folder"] = model_folder
        if model_param_file is None:
            model_param_file = find_latest_checkpoint(model_folder, iteration, suffix=".pth")
        config["model_param_filename_tail"] = os.path.basename(model_param_file)
        dcn = DenseCorrespondenceNetwork.from_config(config, device=device, dtype=dtype)
        load_reference_checkpoint(dcn, model_param_file)
        dcn.model_folder = model_folder
        return dcn

    # -- int8 serving ------------------------------------------------------------

    def quantized(self, static: bool = False, variables=None) -> "DenseCorrespondenceNetwork":
        """A serving clone whose convolutions run the int8 path
        (:class:`~pdc_tpu_torch.models.resnet.Int8Conv`). It shares this
        network's parameters and BatchNorm statistics (the same tensors);
        this network's own forward is left as it was. Inference only.

        ``static=True`` uses calibrated per-layer activation scales instead
        of the per-call abs-max: from ``variables`` (flax's layout with a
        ``quant_scales`` collection, or ``'<conv>.act_scale'`` entries of a
        ``state_dict``), else from this network if it is a static clone
        itself. :meth:`calibrate_quantization` makes the clone directly.

        :raises ValueError: the backbone has no int8 path, or ``static``
            without calibrated scales for every convolution
        """
        from pdc_tpu_torch.models.convert import quant_scales_to_torch

        if not hasattr(self.module, "quant_int8"):
            raise ValueError(f"{type(self.module).__name__} has no int8 serving path")
        scales = None
        if variables is not None:
            scales = (quant_scales_to_torch(variables["quant_scales"])
                      if "quant_scales" in variables else dict(variables))
        elif getattr(self.module, "quant_static", False):
            scales = {f"{n}.act_scale": c.act_scale for n, c in int8_convs(self.module)}
        module = quantized_copy(self.module, static)
        if static:
            need = {f"{n}.act_scale" for n, _ in int8_convs(module)}
            if not scales or set(scales) != need:
                raise ValueError("static int8 serving needs calibrated scales for every "
                                 "convolution: use dcn.calibrate_quantization(images)")
            with torch.no_grad():
                for name, conv in int8_convs(module):
                    conv.act_scale.copy_(torch.as_tensor(scales[f"{name}.act_scale"]))
        clone = DenseCorrespondenceNetwork(
            module, self._descriptor_dimension, self._image_width, self._image_height,
            normalize=self._normalize, config={**self.config, "quant_int8": True},
            device=self.device)
        clone.image_mean = self.image_mean
        clone.image_std_dev = self.image_std_dev
        clone.model_folder = self.model_folder
        clone._descriptor_image_stats = self._descriptor_image_stats
        return clone

    def calibrate_quantization(self, images, batch_size: int = 8,
                               headroom: float = 1.0) -> "DenseCorrespondenceNetwork":
        """Calibrate static int8 activation scales and return the serving
        clone (``quantized(static=True)``), as
        ``pdc_tpu/models/dcn.py:375-427`` does.

        ``images`` is an iterable of ``[H, W, 3]`` uint8 RGB frames (such as
        training frames), normalised with this network's mean and std and
        run in batches of ``batch_size`` through the clone's int8 forward,
        each :class:`Int8Conv` max-accumulating ``max|x| / 127`` of its
        input across all batches in its own ``act_scale``. ``headroom``
        then multiplies every scale (> 1 leaves room for activations
        outside the calibration frames; beyond it they saturate at +-127).
        """
        if not hasattr(self.module, "quant_static"):
            raise ValueError(f"{type(self.module).__name__} has no static int8 path")
        module = quantized_copy(self.module, static=True)
        convs = [c for _, c in int8_convs(module)]
        module.eval()
        batch, seen = [], 0

        def flush():
            x = self.normalize_on_device(np.stack(batch)).permute(0, 3, 1, 2).contiguous()
            module(x)
            batch.clear()

        for conv in convs:
            conv.calibrating = True
        try:
            with torch.no_grad():
                for img in images:
                    batch.append(np.asarray(img, np.uint8))
                    seen += 1
                    if len(batch) == batch_size:
                        flush()
                if batch:
                    flush()
        finally:
            for conv in convs:
                conv.calibrating = False
        if not seen:
            raise ValueError("calibrate_quantization needs at least one frame")
        scales = {f"{n}.act_scale": c.act_scale * headroom for n, c in int8_convs(module)}
        return self.quantized(static=True, variables=scales)

    # -- persistence -----------------------------------------------------------

    def save_checkpoint(self, path: str):
        """Write the weights as a flax msgpack ``.ckpt`` that ``pdc_tpu``
        loads."""
        write_checkpoint(state_dict_to_flax(self.module.state_dict()), path)

    def load_checkpoint(self, path: str):
        self.module.load_state_dict(flax_to_state_dict(read_checkpoint(path)), strict=True)


def find_latest_checkpoint(model_folder: str, iteration: Optional[int] = None,
                           suffix: str = ".ckpt") -> str:
    """Find a ``%06d.ckpt`` (or ``suffix``, such as ``.pth``) in a model
    folder: the given ``iteration``, else the highest all-digit step."""
    if iteration is not None:
        path = os.path.join(model_folder, "%06d" % iteration + suffix)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return path
    # all-digit stems only (sidecars such as '000100.ckpt.opt' never match);
    # numeric sort because '%06d' grows to 7 digits past step 999999
    files = sorted(
        (f for f in glob.glob(os.path.join(model_folder, "*" + suffix))
         if os.path.basename(f)[: -len(suffix)].isdigit()),
        key=lambda f: int(os.path.basename(f)[: -len(suffix)]))
    if not files:
        raise FileNotFoundError(f"no {suffix} files in {model_folder}")
    return files[-1]
