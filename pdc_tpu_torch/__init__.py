"""pdc_tpu_torch — the PyTorch/CUDA port of :mod:`pdc_tpu`.

The JAX package stays the reference; this package mirrors its module paths so
each port module sits where its counterpart does (``models/resnet.py``,
``ops/matching.py``, ``apps/serve.py``, ...). It imports torch, numpy and the
standard library only, never ``jax``, ``flax`` or ``pdc_tpu``; optional
third-party packages (``yaml``, ``cv2``/``PIL``, ``pandas``, ``matplotlib``)
are imported inside the functions that need them.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``
and raises when CUDA is absent unless the caller asks for ``"cpu"``. The
hand-written CUDA kernels live in ``csrc/`` and are built with ``nvcc`` on
first use (:mod:`pdc_tpu_torch.ops._build`).

Ported so far: the serving path (ResNet-18/34-8s descriptor inference, best
match with the streaming argmin kernel, the microbatching TCP server), the
train step of the default config (sample assembly, train-mode BatchNorm,
the pooled matrix loss with its hinge forward and backward kernels, or the
per-pair loss, synthetic multi-object samples on both, Adam;
:func:`pdc_tpu_torch.training.train.make_train_step`) and the training
driver on in-memory datasets and scenes on disk
(:class:`pdc_tpu_torch.data.dataset.SpartanDataset`, the device cache and
sampler, the model folder;
:class:`pdc_tpu_torch.training.train.DenseCorrespondenceTraining`), and the
evaluation of a model folder (the 23-column match statistics, CDF stats,
descriptor statistics, qualitative panels, keypoints and the test loss
over a dataset; :mod:`pdc_tpu_torch.evaluation`, ``python -m pdc_tpu_torch
evaluate``), the apps, the other backbones with bf16 and int8, the
preprocessing pipeline, the dataset tooling (``config-gen``, ``migrate``,
``download``) and the experiment runner (:mod:`pdc_tpu_torch.experiments`,
``python -m pdc_tpu_torch experiment``). Not yet: the multi-device layer.
"""

__version__ = "0.1.0"
