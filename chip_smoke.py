#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pdc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each fatal on failure:
  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions; TF32 is switched off for matmuls and cuDNN, since every
     number below is compared in fp32;
  2. build: nvcc compiles ``pdc_tpu_torch/csrc/*.cu`` into
     ``build/pdc_tpu_torch_kernels/`` (first use only);
  3. the best-match kernel against its plain PyTorch version and against
     float64 distances, on random shapes (HW % 4 != 0 among them) and on
     real 640x480 descriptor images of the network, B=8 included;
  4. the pooled-hinge forward and backward kernels (K1, K2) against their
     plain version at the training shapes (B=4, Nm=10000, P=1024, D=3),
     with and without the pixel weight: random rows, rows of the network's
     640x480 descriptor images, many collisions, no valid row, a ragged
     B=3, Nm=777, P=1000, D=16 case, rows at scale 0.05, where most pairs
     count, and NaN or infinite descriptors in valid and invalid rows and
     pool entries, which must give NaN where the plain version does;
  5. the main path, serving: a ``DescriptorServer`` with ResNet-34-8s, D=3,
     640x480, seeded random weights, answering concurrent ``descriptors``
     and ``best_match`` requests from several client threads; its answers
     are checked against ``forward_on_img`` and the plain best match, and
     the best-match kernel's launch count must show that serving went
     through it;
  6. the main path, training: ``make_train_step`` with the values of
     ``configs/training.yaml`` (ResNet-34-8s, D=3, 640x480, B=4 within-scene
     pairs of a synthetic scene, seeded random weights) takes a few steps;
     the loss must stay finite, the weights must move, and K1 and K2 must
     launch twice each per step. Then one step with the kernels and one with
     the plain pooled hinge, on the same batch and weights, must agree;
  7. the main path, the training driver: ``DenseCorrespondenceTraining.run``
     on the synthetic dataset of trained_models/tpu_journey/dataset.yaml
     (DATASET_RECORD: 2 scenes, 12 frames, 640x480) with ResNet-34-8s, B=4,
     6 iterations in 2 calls of 3 steps, checkpoints at 0, 3 and 6 and the
     test loss at 6. It fails unless (a) the run took the on-device sampler
     route; (b) K1 launched 2 per train step and per warm-up step of the
     graph's capture plus 2 per test-loss batch, and K2 2 per train step and
     warm-up step;
     (c) every metric is finite and the weights moved; (d) the folder holds
     the configs, the checkpoints with their .opt files and the log
     histories; (e) 000006.ckpt.opt reads back bit-equal to the live Adam
     state; (f) run_from_pretrained for 2 more iterations starts at 6 and
     ends with every Adam step at 8; (g) from_model_folder gives the live
     network's forward_on_img within 1e-6, and one best-match query on it
     agrees with the plain version; (h) load_training_dataset rebuilds the
     same scenes, frame counts and poses. Then 3 timed iterations on each
     route (device sampler, cached host sampler, host streaming);
  8. the main path from disk, "on-disk training": the DATASET_RECORD scenes
     written in the pdc layout (write_scene, through the PNG codec that
     decoder "auto" chose, which is printed) with a composite config, read
     back bit-equal to the rendering (poses within 1e-9); each codec's ms
     per 640x480 frame to write and to decode; then ``python -m pdc_tpu_torch
     train`` in this process with the values of phase 7. It fails unless
     (a) K1 launched 2 per train step and warm-up step plus 2 per test-loss
     batch and K2 2 per train step and warm-up step; (b) every metric is finite and the weights moved; (c)
     dataset.yaml records the absolute data_dir and config_dir, and
     load_training_dataset("train") rebuilds the same scene names, frame ids
     and poses from disk; (d) from_model_folder gives the live network's
     forward_on_img within 1e-6, and one best-match query on it agrees with
     the plain version; (e) ``python -m pdc_tpu_torch statistics`` on the
     tree is within 1e-6 of float64 numpy over the same frames;
  9. the main path's evaluation, "evaluation": ``python -m pdc_tpu_torch
     evaluate`` in this process on phase 8's model folder, 20 pairs of 100
     matches in each split (``--no_qualitative`` unless matplotlib imports;
     one line says whether pandas, matplotlib and cv2 import). It fails
     unless (a) train/ and test/ data.csv read back (table.read_csv) with
     the 23 columns and rows; (b) K3 launched once per sweep chunk of 16
     pairs (and once per qualitative panel); (c) on 4 test pairs the fused
     route (K3) agrees with the per-pair route run with the plain best
     match: equal picks, or float64 near-ties within TIE_TOL_D2, every
     other value within 1e-5, and the rerun equals the written rows; (d)
     each stats.yaml holds PCK at 5-100 px in [0, 1] and a finite area
     above the curve; (e) descriptor_statistics.yaml is finite with
     min <= mean <= max per channel; (f) across_object/data.csv exists
     (the dataset has 2 objects). Then K3 at the sweep's shape (B=16,
     Q=100, 640x480) against float64 and its plain version;
 10. the per-pair loss and synthetic multi-object samples, "per-pair and
     synthetic multi-object". It fails unless (a) ``make_train_step`` with
     the values of phase 6 and ``use_matrix_loss: false`` takes 5 steps with
     finite metrics, moving weights and no K1/K2 launch, and one batch's
     ``compose_loss`` terms on the card equal the CPU's on the same
     predictions and indices (rtol 1e-5, gradients relative L2 1e-4); (b)
     ``run`` on DATASET_RECORD with the shoes experiments' mix (SHOES_MIX:
     within-scene, different-object and synthetic multi-object, 0.33 each)
     on the matrix loss, 6 iterations, takes the on-device sampler route,
     draws type-4 rows, launches K1 and K2 2 each per step, has finite
     metrics, keeps no blind entry and no match of the object behind that
     the front object covers in its composited rows, and a kernel step on
     one such batch equals the plain-hinge step (as phase 6); (c) the same
     run on the per-pair loss takes the cached host sampler route, launches
     no K1/K2 and reloads through from_model_folder (as phase 7's (g)); (d)
     ``compute_loss_on_dataset`` on phase 8's folder gives three finite
     numbers;
 11. the apps, "apps", on phase 8's model folder and scene tree (ResNet-34-8s,
     D=3, 640x480). It fails unless (a) ``python -m pdc_tpu_torch
     descriptor-images`` in this process writes one .npy per frame (24),
     named by frame id, each within 1e-4 of ``forward_on_img``; (b) a
     ``GraspPointStream`` of 16 descriptors taken at object pixels of frame
     0, over the 12 frames of scene_000, launches K3 once per frame, picks
     what the plain ``best_match_reference`` picks on the same descriptor
     image or a float64 near-tie (TIE_TOL_D2), with distances within 1e-5
     of the plain version's, and on frame 0 matches each query to its own
     pixel or a tie, at distance <= 1e-5; (c) ``HeatmapEngine`` on one pair
     and 8 query pixels gives the float64 argmin of the norm diffs (near
     ties excepted) and the [480, 640] heatmap within 1e-6 of
     ``exp(-nd / variance)`` in float64; (d) ``python -m pdc_tpu_torch
     export-serving --batch_size 8 --platform cuda`` writes a program that,
     loaded with ``torch.export.load``, gives ``forward_on_img`` on 8 frames
     within 1e-4, and a second load the first within 1e-6; (e) the
     descriptor video of one scene (``run(..., masked=True)``) writes three
     PNGs a frame that the port's decoder reads back equal to the uint8 of
     the forward, the masked one 0 off the mask (whether ffmpeg exists and
     how many videos it made is printed); (f) mesh descriptors of the
     scene's fusion mesh over its frames on the card equal the CPU's on the
     same descriptor images (observations exactly, descriptors within
     1e-5); (g) ``visualize_saved_correspondences`` of 2 annotated pairs
     writes 4 PNGs with each reticle's colour at its click (on the ring at
     10 px, and at the click itself without cv2), and ``debug_batch_panels``
     draws 5 panels where matplotlib imports, else raises an ImportError
     naming it (which case is printed);
 12. timings: every kernel's device time (time_device: the queue primed
     with a device-side wait, so the card never waits on the host), the
     wrapper's time per call from an idle queue (time_cuda), the split by
     kernel name (torch.profiler), its bound, its plain version and a
     library yardstick where one exists (device times); forward images/s;
     serving latency; the train step and its split; the driver's step on
     each route against it, and its checkpoint writes; the on-disk run's
     step against the driver's, and the PNG codecs' times; K3 at the
     evaluation sweep's shape, and the sweep's seconds split into forwards,
     correspondences and statistics; the per-pair step and its split
     against the matrix step, and a synthetic multi-object batch's assembly
     on each route; the grasp stream's ms per frame split into upload and
     normalisation, forward, K3 and fetch, a heatmap event, descriptor
     images per frame (forward and np.save), the export's seconds and the
     loaded program's B=8 forward against the live module's, and mesh
     descriptors per frame;
 13. model variants and int8, "model variants and int8" (run after phase 11,
     on phase 8's folder and tree, and before the timings), at 640x480, D=3,
     fp32, seeded random weights unless the folder's. It fails unless (a)
     the ``torch._int_mm`` route of ``ops/int8_conv.py`` equals its float64
     plain version bit for bit (int32) on every conv shape of ResNet-34-8s and
     of the UNet, B=1 and B=8 (the stem's K=147 and the head's N=3 among
     them), and on random shapes with M <= 16 and K, N not multiples of 8,
     each counted as one launch of the route (its ms against cuDNN's fp32
     convolution of the shape are printed); (b) ResNet-101-8s serves finite
     descriptors through forward_on_img and forward_on_images at B=8 (its
     forward ms beside ResNet-34-8s's and the UNet's), and dilated_s2b ResNet-101-8s equals
     the dilated model on the same weights within 2e-5 of the output's scale
     in eval mode, and after one train-mode forward its running statistics
     within 1e-5 of theirs; (c) ``make_train_step`` with TRAINING_CONFIG's
     values and ``resnet_name: Resnet101_8s`` takes 5 steps after a warm-up
     (the UNet 2), with finite metrics, moving weights and K1 and K2 launched
     twice each per step; the step's ms and its split are printed; (d)
     ``dcn.quantized()`` and ``dcn.calibrate_quantization`` (on the first 16
     frames of the first scene of the folder's dataset, as ``serve
     --int8_static`` calibrates) leave the float network's forward
     unchanged; every Int8Conv of the dynamic clone, fed the input that the
     same clone's CPU forward (the float64 plain product) gives that layer,
     gives the CPU's output bit for bit (whole-network cosines to fp32 on
     the card and on the CPU are printed); the clones' descriptors have
     cosine > 0.97 to the fp32 forward on 4 frames, and best matches of 256
     object pixels that agree with fp32's in at least 10/16 of the queries
     (the fp32 pick or a near-tie, as tests/test_quantized.py counts them;
     over 256 the share does not hang on the few picks that phase 8's
     not bit-reproducible training moves), while a
     broken quantization (the dynamic clone truncating instead of rounding)
     misses both bars (tools/torch_int8_witness.py sets them); fp32, int8
     and int8-static forward ms at B=1 and B=8 are printed; (e) a
     ``DescriptorServer`` on the static clone (max_batch 8) and one on the
     dynamic clone (max_batch 1) answer 16 concurrent requests
     each within 1e-4 of the clone's forward_on_img, with best matches the
     float64 best match or a near-tie, and K3 launched once per dispatch with
     queries; (f) ``python -m pdc_tpu_torch export-serving --int8_static
     --batch_size 8`` writes a program that, loaded, gives the live static
     clone's forward (scales from the same 16 random train frames, seed 7)
     within 1e-4, its ms beside the clone's; (g) ``GraspPointStream`` on the
     static clone launches K3 once per frame over 12 frames, picking the
     float64 best match or a near-tie.

14. compute dtype, remat and preprocessing, "compute dtype, remat and
     preprocessing" (run after phase 13, before the timings), at 640x480, D=3.
     It fails unless (a) ResNet-34-8s built with dtype=bfloat16 and the fp32
     one on the same seeded weights give, at B=1 and B=8 on the synthetic
     frames, a bfloat16 output within relative RMS 0.03 (and at least 1e-3)
     and 0.06 of the largest value of the fp32 one (the CPU reads 0.011-0.012
     and 0.018-0.022); both forward times are printed; (b) ``make_train_step``
     with TRAINING_CONFIG's values and ``compute_dtype: bfloat16`` takes 5
     steps with finite metrics, moving weights, fp32 parameters, buffers and
     Adam state, and K1 and K2 launched twice each per step; one bf16 step
     and one fp32 step on the same batch and weights agree (loss rtol 0.05,
     gradient cosine at least 0.6, relative L2 at most 1.0; the CPU reads
     0.009, 0.84, 0.59); the bf16 step's split against fp32's is printed;
     (c) ``DenseCorrespondenceTraining`` with ``compute_dtype: bfloat16`` runs
     3 iterations (K1 and K2 2 per step and warm-up step) and writes fp32
     checkpoint and Adam
     files; ``from_model_folder`` on the folder builds fp32 by default and
     bf16 on request, their descriptors within relative RMS 0.03; (d)
     ResNet-101-8s, B=4: one step with ``remat: true`` and one without, on
     the same batch and weights, agree as phase 6's kernel and plain steps
     must (loss 1e-5, gradients 1e-4 by relative L2: the backward's atomics,
     ROADMAP F4), running statistics within 1e-5 and ``num_batches_tracked``
     1 in both, and remat's peak memory above the step's start is lower
     (both and the step times are printed); (e) a synthetic 640x480 scene of
     60 frames with a fusion mesh of 392,064 faces (``write_scene``, then
     ``write_fusion_mesh(plane_step=0.004, object_step=0.002)``) goes
     through ``python -m pdc_tpu_torch preprocess`` in this process: every
     frame's mask, depth and cropped depth PNG is written; on 4 poses the
     CPU route renders the same masks and millimetres bit for bit; the
     sorted route equals the binned one on the card bit for bit; the masks'
     IoU with the scene's own masks is at least 0.8 on every frame (the CPU
     reads 0.850-0.862); seconds per scene and ms per pose split into host
     prep, device render, fetch and PNG encode are printed.

15. dataset tooling and experiments, "dataset tooling and experiments" (run
     after phase 14, on phase 8's scene tree). It fails unless (a) ``python -m
     pdc_tpu_torch config-gen --published`` in this process writes one YAML
     per manifest entry in single_object/, multi_object/ and composite/, each
     reading back equal to its entry through load_yaml and through the
     port's own parse_yaml (the reader where PyYAML is missing); (b) ``config-gen --data_dir <tree> --name caterpillar_only`` finds
     exactly phase 8's scenes, and the dataset of the generated composite has
     phase 8's scene names, frame ids and poses; (c) ``migrate`` gives back a
     copy of scene_000 flattened into the old layout (a top-level
     fusion_mesh.ply) file for file and byte for byte, and ``download
     --dry_run`` on the published caterpillar_only lists its scene URLs and
     fetches nothing; (d) ``experiment caterpillar`` at Scale.full() (640x480,
     ResNet-34-8s, D=3, B=4) on the synthetic stand-in, 12 steps (2 calls of
     6), checkpoints every 12, 8 test pairs of 100 matches a network: its 2
     runs launch K1 and K2 twice per step and per warm-up step of their
     capture, K3 once per sweep chunk, have finite metrics and moved weights,
     000000.ckpt and 000012.ckpt, and result.json has pdc_tpu's keys
     with test PCKs in [0, 1] and a finite area; comparison_test.yaml exists;
     on 4 test pairs of one network the fused sweep (K3) agrees with the
     per-pair route run with the plain best match (as phase 9 (c)); the same
     command again retrains nothing and writes the same statistics; (e)
     ``experiment caterpillar --data_dir <tree> --dataset_dir <(b)'s
     composite/> --run_filter 0.500 --steps 3`` trains 1 run from disk with
     the same K1/K2/K3 checks; (f) it prints each command's seconds, (d)'s
     train step by CUDA events and scoring seconds per network, beside the
     card's name and power limit.

16. the data axis of the parallel layer, "the data axis" (after phase 15),
     on a world of one process over NCCL (a FileStore in the scratch tree; the
     machine has one card, so no collective crosses cards) at 640x480,
     ResNet-34-8s, D=3, B=4. It fails unless (a) ``make_sharded_train_step``
     and ``make_train_step`` on one assembled batch and the same weights agree
     as phase 6's kernel and plain steps must (loss 1e-5, gradients 1e-4 by
     relative L2, parameters within 2 lr and 99.9% of the significant ones
     within 1e-6), K1 and K2 launching twice each; (b) 3 steps of the
     device-sampled route with ``mesh`` (data-parallel) and with ``mesh`` and
     ``fsdp`` from the same weights and draws as 3 steps of the single route
     differ from it by at most 4 times F4's spread (the card's step is not
     bit-reproducible, ROADMAP F4: a second run of the single route in the
     same call measures it), in the losses and in the parameters' relative
     L2 distance, K1 and K2 twice each per step; (c) ``make_pixel_sharded_best_match``
     on a 640x480 descriptor image of phase 8's network with 100 queries equals
     ``best_match`` exactly, one K3 launch; (d) ``mesh=`` evaluation of 4 pairs
     of 100 matches and the descriptor statistics of 8 images on phase 8's
     folder equal ``mesh=None``; (e) ``render_scene_products_sharded`` of
     phase 14's 4 poses equals ``render_scene_products`` bit for bit; (f) a
     ``DescriptorServer`` with ``devices=[cuda:0]`` (``serve --data_parallel``
     here) answers 4 requests as the one-card server does, one K3 launch; (g)
     it prints, beside the card's name and power limit, the NCCL all-reduce of
     ResNet-34-8s's gradients and the three routes' steps by CUDA events.

17. the model axes of the parallel layer, "the model axes" (after phase 16),
     on a world of one process over NCCL, ``(data, model)`` and ``(data,
     pipe)`` meshes of shape (1, 1), at 640x480, ResNet-34-8s, D=3, fp32
     without TF32, phase 6's batch and training values. It fails unless (a)
     ``make_tp_inference`` at B=8 equals ``forward_on_images`` within
     DESC_TOL; (b) one ``make_tp_train_step`` step equals one single step on
     the same batch and weights (loss within 1e-6 relative, gradients within
     4 times F4's spread, measured from two single steps in the same call),
     K1 and K2 launching twice each; it prints the step's collectives by kind
     and count and times 3 steps of each by CUDA events; (c)
     ``make_pp_inference`` with microbatch 1 and 2 equals the eval forward of
     the same microbatches within 2e-5 and that of the whole batch within
     DESC_TOL (cuDNN picks its algorithm by the batch size: on an H100 the
     microbatched forward reads 3.91e-5 from the whole batch's); (d) one ``make_pp_train_step`` step (one microbatch of the
     8 images) equals one ``make_frozen_bn_train_step`` step under (b)'s
     bars, K1 and K2 twice each, and a step of 2 microbatches of 4 runs with
     the same launches; both are timed against the oracle; (e) a TP and a PP
     checkpoint written by ``DenseCorrespondenceTraining.save_network`` load
     through ``from_model_folder`` and give the live network's forward within
     1e-6 (the TP folder with its ``.ckpt.opt``, the PP folder without); (f) a
     ``DescriptorServer(model_parallel=1)`` answers 2 ``descriptors`` and 2
     ``best_match`` requests as the plain server (DESC_TOL; picks equal or
     near-ties), one K3 launch.

18. K steps per dispatch, "K steps per dispatch" (after phase 17), at
     640x480, ResNet-34-8s, D=3, B=4, TRAINING_CONFIG's values, fp32 without
     TF32, on a device cache of DATASET_RECORD's scenes. It fails unless (a)
     one call of ``make_scanned_train_step`` with K=10 (one CUDA graph of the
     whole step, captured after a warm-up step it undoes, replayed 10 times)
     equals 10 eager ``DeviceSampledTrainStep`` calls from clones of the
     state and generator: the ten losses and the parameters within 4 times
     F4's spread (two eager runs in the same call measure it, as phase 16
     (b)), the generator left as the eager calls leave it, metrics of shape
     [10], and K1 and K2 launching 20 times each in the call (the graph's
     replays counted); (b) the same for a bf16 step and for a mix of
     within-scene and synthetic multi-object pairs; (c)
     ``DenseCorrespondenceTraining.run`` with ``steps_per_dispatch: 10``,
     ``num_iterations: 20`` and ``save_rate: 10`` takes the device-sampler
     route, calls back at 10 and 20, logs iterations 1-20 with host_lr's
     rates, writes checkpoints 0, 10 and 20 and no other, launches K1 and K2
     2 a step and a warm-up step, and its last folder reloads (as phase 7
     (g)); (d) the data-parallel route on a world of one over NCCL runs its
     K steps in one call, eagerly (a process group's collectives are not
     captured), and says so. It prints the eager and the graph's ms a step
     by CUDA events and the host ms a call, fp32 and bf16.

The last lines are a JSON object with every kernel's numbers, the
nvidia-smi line, and ``{"ok": true, "device": {...}}``. Without CUDA, or when the
package is not beside this script, it exits non-zero and prints no result.
A watchdog turns a hang into a traceback and a non-zero exit.
"""

import dataclasses
import faulthandler
import json
import os
import subprocess
import sys
import threading
import time

WATCHDOG_S = 1000
SEED = 0
H, W, D = 480, 640, 3
N_FRAMES = 8
N_CLIENTS, REQUESTS_PER_CLIENT, SERVE_QUERIES = 4, 4, 16
# kernel checks: a chosen pixel may exceed the true minimum squared distance
# by 1e-5 (near-ties are not errors; bench.py's gate), and a distance may be
# 1e-4 off the float64 one. Kernel and plain version sum the same squared
# differences in the same order and differ only by the FMA's rounding.
TIE_TOL_D2, DIST_TOL, PLAIN_TOL = 1e-5, 1e-4, 1e-4
DESC_TOL = 1e-4  # served descriptors vs forward_on_img (other batch, other cuDNN algorithm)
# The training values of configs/training.yaml, stated inline because the
# card's machine has no yaml (tests/test_torch_port_train.py holds them
# against the file).
TRAINING_CONFIG = {
    "training": {
        "learning_rate": 1.0e-4, "learning_rate_decay": 0.9,
        "steps_between_learning_rate_decay": 250, "weight_decay": 1.0e-4, "batch_size": 4,
        "domain_randomize": True, "num_matching_attempts": 10000,
        "sample_matches_only_off_mask": True, "num_non_matches_per_match": 150,
        "fraction_masked_non_matches": 0.5, "fraction_background_non_matches": 0.5,
        "use_image_b_mask_inv": True, "cross_scene_num_samples": 10000,
        "data_type_probabilities": {"SINGLE_OBJECT_WITHIN_SCENE": 1,
                                    "SINGLE_OBJECT_ACROSS_SCENE": 0, "DIFFERENT_OBJECT": 0,
                                    "MULTI_OBJECT": 0, "SYNTHETIC_MULTI_OBJECT": 0},
        "use_matrix_loss": True, "masked_pool_size": 1024, "background_pool_size": 1024,
        "num_blind_samples": 5000, "cache_dataset_on_device": True, "flip_augmentation": True,
    },
    "dense_correspondence_network": {
        "descriptor_dimension": 3, "image_width": 640, "image_height": 480, "normalize": False,
        "backbone": {"model_class": "Resnet", "resnet_name": "Resnet34_8s"},
    },
    "loss_function": {
        "M_masked": 0.5, "M_background": 0.5, "M_pixel": 50, "match_loss_weight": 1.0,
        "non_match_loss_weight": 1.0, "use_l2_pixel_loss_on_masked_non_matches": False,
        "use_l2_pixel_loss_on_background_non_matches": False, "scale_by_hard_negatives": True,
        "scale_by_hard_negatives_DIFFERENT_OBJECT": True, "alpha_triplet": 0.1,
    },
}
# The synthetic record of trained_models/tpu_journey/dataset.yaml (2 scenes of
# 2 objects, 12 frames each, 640x480), stated inline because the card's copy of
# the tree may lack trained_models/ (tests/test_torch_port_dataset.py holds it
# against the file).
DATASET_RECORD = {"synthetic": {"height": 480, "num_frames": 12, "num_objects": 2,
                                "num_scenes": 2, "num_test_scenes": 0, "object_radius": 0.3,
                                "width": 640}}
# H100 SXM data-sheet peaks: HBM bytes/s and fp32 FLOP/s outside the tensor cores
PEAK_BYTES_S, PEAK_FP32_S = 3.35e12, 67e12


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name, t0):
    log(f"phase {name}: {time.perf_counter() - t0:.2f} s")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_cuda(torch, fn, iters=20, warmup=3):
    """Milliseconds per call, from CUDA events around ``iters`` calls made
    from an idle queue. Where one call's host work (checks, allocations,
    the launch itself) outlasts its device work, the card waits between
    launches and this reads the host: for a kernel it is the wrapper's cost
    per call to its caller, not the kernel's time (see time_device)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# time_device's first device-side wait (about 5 ms at 2 GHz), and how often
# it is lengthened (4x each time) before a reading counts as host-paced
SLEEP_CYCLES, SLEEP_TRIES = 10_000_000, 4


def time_device(torch, fn, iters=20, warmup=3, cycles=SLEEP_CYCLES, tries=SLEEP_TRIES):
    """Milliseconds of device time per call of ``fn``, gaps between its
    launches included. The stream first gets a long device-side wait
    (``torch.cuda._sleep``); the start event, the ``iters`` calls and the end
    event are enqueued behind it, so the card finds every launch queued when
    it reaches the start event. If the start event has already been reached
    when the enqueueing ends, the card may have waited on the host: the
    reading is dropped and the wait lengthened, and after ``tries`` such
    readings this raises. It never returns a host-paced number, and without
    a card it raises before calling ``fn``."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_device reads device time on a CUDA card, and there is none")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        drained = start.query()
        end.record()
        torch.cuda.synchronize()
        if not drained:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise RuntimeError(f"time_device: the queue drained before the enqueueing of {iters} calls "
                       f"ended, {tries} times (last wait {cycles // 4} cycles): host-paced")


def short_kernel_name(key):
    """``hinge_fwd<3>`` from the profiler's ``void (anonymous
    namespace)::hinge_fwd<3>(float const*, ...)``."""
    name = key.replace("(anonymous namespace)::", "").split("(", 1)[0]
    return name.removeprefix("void ")


def profile_split(torch, fn, iters=10):
    """Device time of each kernel that ``fn`` launches, from
    ``torch.profiler`` over ``iters`` calls: ``{short name: (launches per
    call, ms per launch)}``, or None when the profiler recorded no device
    time on this machine."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a window can come back empty; one more try
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us > 0 and e.count:
                out[short_kernel_name(e.key)] = (e.count / iters, 1e-3 * us / e.count)
        if out:
            return out
    return None


def split_text(split):
    if split is None:
        return "profiler: no device time recorded (events only)"
    return "profiler: " + ", ".join(f"{k} {n:g} x {ms:.5f} ms" for k, (n, ms) in split.items())


def bound(B, Q, D_, HW):
    """Least time for one best_match call: inputs read once, outputs written
    once, against 2*Q*HW*D + 2*Q*HW fp32 operations per image."""
    nbytes = 4 * (B * HW * D_ + B * Q * D_) + 8 * B * Q
    ops = B * (2 * Q * HW * D_ + 2 * Q * HW)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_FP32_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_matches(torch, bm, res, queries, idx, dist):
    """Tie-tolerant check of (idx, dist) against float64 distances:
    returns (bad_idx, dist_err)."""
    d2 = bm.squared_distances(res.double(), queries.double())  # [B, Q, HW]
    true_min = d2.min(dim=-1).values
    chosen = torch.gather(d2, -1, idx.long()[..., None])[..., 0]
    bad = int(((chosen - true_min) > TIE_TOL_D2).sum())
    err = float((dist.double() - true_min.sqrt()).abs().max())
    return bad, err


# -- pooled hinge (K1 forward, K2 backward) -----------------------------------

# main-path shapes: B pairs, Nm match rows, P pool rows (configs/training.yaml)
HINGE_B, HINGE_NM, HINGE_P = 4, 10000, 1024
# K1/K2 against their plain version. Every term is bit-identical (the kernels
# round each product and sum on its own, as the plain version's elementwise
# ops do), so the hard-negative count must be equal (a difference of 0) and
# only the order of the final sums differs: loss within rtol 1e-5, gradients
# within 1e-5 of the plain gradient's largest magnitude.
HINGE_LOSS_RTOL, HINGE_HARD_TOL, HINGE_GRAD_TOL = 1e-5, 0, 1e-5
# one train step with the kernels against one with the plain pooled hinge, on
# the same batch and weights: the same forward, so the loss differs only in
# the hinge's summation order (rtol 1e-5); gradients by relative L2 norm over
# all parameters, 1e-4 (hinge sums plus the atomics of index_select's and
# cuDNN's backward); after Adam's first step, which moves each parameter by
# about lr * sign(g), every element within 2 lr and 99.9% of those whose |g|
# exceeds 1e-3 of its tensor's largest within 1e-2 lr
STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_PARAM_SHARE = 1e-5, 1e-4, 0.999
TRAIN_STEPS, TRAIN_TIMED_STEPS = 5, 5
# H100 SXM special-function units: 16 per SM per clock, 132 SMs, 1.98 GHz boost
PEAK_SFU_S = 16 * 132 * 1.98e9


def hinge_inputs(torch, np, rng, dev, B, Nm, P, da=None, db=None, scale=0.3, coord_max=None,
                 valid_frac=0.9, Dd=D):
    """K1/K2 arguments: rows (given, or random at ``scale``), match and pool
    pixels on a 640x480 image (or in [0, coord_max)^2, which makes
    collisions common), validity."""
    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=dev)
    if da is None:
        da = t(rng.standard_normal((B, Nm, Dd)) * scale)
        db = t(rng.standard_normal((B, P, Dd)) * scale)
    um, vm = (coord_max, coord_max) if coord_max else (W, H)
    return [da.contiguous(), db.contiguous(),
            t(rng.integers(0, um, (B, Nm))), t(rng.integers(0, vm, (B, Nm))),
            t(rng.random((B, Nm)) < valid_frac),
            t(rng.integers(0, um, (B, P))), t(rng.integers(0, vm, (B, P))),
            t(rng.random((B, P)) < valid_frac)]


def hinge_bound(args, use_pix, backward):
    """Least time of one K1 (or K2) call on these inputs: bytes (each input
    read once, each output written once) over the memory rate against fp32
    operations over the fp32 rate, counting only the work this run's data
    needs. Every pair of a valid row and a valid pool entry needs its
    distance decided: D subtractions, D multiplies, D - 1 adds and the test
    d2 < T (K1), 1e-24 < d2 < T (K2), where d2 < T is exactly hinge > 0.
    A pair that passes adds the collision test and its weight (5). A pair
    that counts adds the sqrt, the hinge, and then the term, the loss sum
    and the count (K1: 4) or c and c * t into gda and gdb (K2: 3 + 3D);
    with use_pix, 7 more for the pixel weight. K2 scales its B (Nm + P) D
    outputs by g. Returns (ms, "bytes" or "operations", sqrt count), the
    sqrts being the counted pairs'."""
    import torch
    from pdc_tpu_torch.ops.pooled_hinge import _tables
    da, db = args[0], args[1]
    B, Nm, Dd = da.shape
    P = db.shape[1]
    mvalid, pvalid = args[4], args[7]
    with torch.no_grad():
        valid = int(((mvalid != 0).sum(1) * (pvalid != 0).sum(1)).sum())
        _, d2, _, hinge, _, _, counted = _tables(*args, 0.5, use_pix, 50.0)
        near = (mvalid[:, :, None] != 0) & (pvalid[:, None, :] != 0) & (hinge > 0)
        if backward:
            near &= d2 > 1e-24
            counted = counted & (d2 > 1e-24)
        near, counted = int(near.sum()), int(counted.sum())
    pix = 7 if use_pix else 0
    nbytes = 4 * (B * Nm * Dd + B * P * Dd + 3 * B * Nm + 3 * B * P)
    if backward:
        nbytes += 4 * B + 4 * (B * Nm * Dd + B * P * Dd)
        flops = (valid * (3 * Dd + 1) + near * 5 + counted * (2 + 3 + 3 * Dd + pix)
                 + B * (Nm + P) * Dd)
    else:
        nbytes += 12 * B
        flops = valid * 3 * Dd + near * 5 + counted * (2 + 4 + pix)
    sqrts = counted * (2 if use_pix else 1)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), sqrts


def check_pooled_hinge(torch, ph, name, args, use_pix):
    """K1 and K2 against the plain version on one case; fatal on
    disagreement. NaN and infinities must stand where the plain version has
    them (fault F5), the finite values within the bars above. Returns
    (max |loss diff|, max |grad diff|) over the finite values."""
    da = args[0].clone().requires_grad_()
    db = args[1].clone().requires_grad_()
    g = torch.linspace(0.5, 1.5, da.shape[0], device=da.device)
    loss, hard = ph.pooled_hinge(da, db, *args[2:], 0.5, use_pix, 50.0)
    (loss * g).sum().backward()
    torch.cuda.synchronize()
    with torch.no_grad():
        ploss, phard = ph.pooled_hinge_reference(*args, 0.5, use_pix, 50.0)
        pgda, pgdb = ph.pooled_hinge_backward_reference(g, *args, 0.5, use_pix, 50.0)
    loss = loss.detach()
    hard_diff = int((hard - phard).abs().max())
    same_nonfinite, errs, ok_grad = True, [], True
    for got, want in ((loss, ploss), (da.grad, pgda), (db.grad, pgdb)):
        same_nonfinite &= (torch.equal(torch.isnan(got), torch.isnan(want))
                           and torch.equal(torch.isfinite(got), torch.isfinite(want))
                           and torch.equal(got[torch.isinf(want)], want[torch.isinf(want)]))
        f = torch.isfinite(want) & torch.isfinite(got)
        errs.append(float((got[f] - want[f]).abs().max()) if f.any() else 0.0)
    f = torch.isfinite(ploss) & torch.isfinite(loss)
    ok_loss = bool(((loss[f] - ploss[f]).abs() <= HINGE_LOSS_RTOL * ploss[f].abs()).all())
    grad_max = 0.0
    for err, want in zip(errs[1:], (pgda, pgdb)):
        top = float(want[torch.isfinite(want)].abs().max()) if torch.isfinite(want).any() else 0.0
        grad_max = max(grad_max, top)
        ok_grad &= err <= HINGE_GRAD_TOL * top
    n_nan = [int(torch.isnan(x).sum()) for x in (ploss, pgda, pgdb)]
    log(f"pooled hinge {name} use_pix={use_pix}: hard {phard.tolist()} (max diff {hard_diff}), "
        f"max|loss diff| {errs[0]:.3g} of {float(ploss[torch.isfinite(ploss)].abs().max()):.6g}, "
        f"max|grad diff| {max(errs[1:]):.3g} of {grad_max:.3g}; NaN in plain loss/gda/gdb "
        f"{n_nan}, kernels' NaN and infinities where the plain version's are: {same_nonfinite}")
    if not ok_loss or hard_diff > HINGE_HARD_TOL or not ok_grad or not same_nonfinite:
        fail(f"pooled hinge kernels disagree with the plain version on {name}")
    return errs[0], max(errs[1:])


# fault F5: non-finite descriptors, placed as (tensor: 0 da or 1 db, pair,
# validity of the row or entry, channel, value); a NaN anywhere makes the
# loss NaN, as does the same infinity in one channel of a row and an entry
NAN, INF = float("nan"), float("inf")
F5_CASES = [
    ("NaN in a valid row", [(0, 0, 1.0, 1, NAN)]),
    ("NaN in an invalid row", [(0, 1, 0.0, 0, NAN)]),
    ("NaN in a valid entry", [(1, 2, 1.0, 2, NAN)]),
    ("NaN in an invalid entry", [(1, 3, 0.0, 0, NAN)]),
    ("+inf in a row", [(0, 0, 1.0, 2, INF)]),
    ("-inf in an entry", [(1, 1, 1.0, 0, -INF)]),
    ("the same inf in a row and an entry", [(0, 2, 1.0, 1, INF), (1, 2, 0.0, 1, INF)]),
]


def nonfinite_inputs(torch, args, placements):
    """A copy of K1/K2 arguments with the F5_CASES placements applied."""
    args = [a.clone() for a in args]
    for t, b, want, c, value in placements:
        valid = args[4 if t == 0 else 7][b]
        args[t][b, int(torch.nonzero(valid == want)[0, 0]), c] = value
    return args


def kernel_name(mangled):
    """``hinge_fwd<3>`` from a mangled kernel name such as
    ``_ZN<n>_GLOBAL__N__<file>9hinge_fwdILi3EEEvPKf...``: the last component
    of the nested name, with its integer template arguments."""
    import re
    m = re.match(r"_ZN?", mangled)
    if not m:
        return mangled
    i, name = m.end(), mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = re.match(r"\d+", mangled[i:]).end() + i
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    if mangled[i:i + 1] == "I":
        args = mangled[i:mangled.index("EE", i) + 1]
        name += "<" + ",".join(re.findall(r"L[ib](\d+)E", args)) + ">"
    return name


def kernel_templates(_build, source):
    """ptxas registers and spills of the kernels of ``csrc/<source>.cu``,
    by name and template arguments (``hinge_fwd<3>``, ``best_match<3,32>``),
    from nvcc's saved output."""
    report = _build.ptxas_report(_build.build_log(source))
    return dict(sorted((kernel_name(k), v) for k, v in report.items()))


def templates_text(report):
    return "; ".join(f"{k} {v['registers']} registers, spill stores {v['spill_stores']} B, "
                     f"spill loads {v['spill_loads']} B" for k, v in report.items()) \
        or "no nvcc output kept"


def new_train_state(torch, tc):
    """The backbone of the training config ``tc``, initialised from SEED, on
    the card with its optimizer."""
    from pdc_tpu_torch.models.dcn import build_backbone
    from pdc_tpu_torch.models.resnet import init_weights_
    from pdc_tpu_torch.training.train import create_train_state

    module = init_weights_(build_backbone(tc["dense_correspondence_network"]),
                           torch.Generator().manual_seed(SEED))
    return create_train_state(module, tc, device="cuda")


def compare_kernel_and_plain_steps(torch, tc, assembled, what):
    """One train step with the pooled-hinge kernels and one with the plain
    pooled hinge, on the same assembled batch and fresh weights of the same
    seed: loss within STEP_LOSS_RTOL, gradients within STEP_GRAD_RTOL by
    relative L2 norm, parameters as STEP_PARAM_SHARE says. Fatal on
    disagreement."""
    from pdc_tpu_torch.data.assembler import AssemblerConfig
    from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
    from pdc_tpu_torch.ops.pooled_hinge import pooled_hinge_reference
    from pdc_tpu_torch.training.train import make_train_step

    loss_cfg = LossConfig.from_dict(tc["loss_function"])
    asm_cfg = AssemblerConfig.from_training_config(tc)
    Wt = tc["dense_correspondence_network"]["image_width"]
    s_kernel, s_plain = new_train_state(torch, tc), new_train_state(torch, tc)
    m_kernel = make_train_step(tc, loss_cfg, asm_cfg, Wt).update(s_kernel, *assembled)
    m_plain = make_train_step(tc, loss_cfg, asm_cfg, Wt,
                              hinge=pooled_hinge_reference).update(s_plain, *assembled)
    lr = tc["training"]["learning_rate"]
    num = den = 0.0
    close = total = 0
    param_max = 0.0
    plain_params = dict(s_plain.module.named_parameters())
    for name, p in s_kernel.module.named_parameters():
        q = plain_params[name]
        num += float(((p.grad - q.grad) ** 2).sum())
        den += float((q.grad ** 2).sum())
        d = (p.detach() - q.detach()).abs()
        param_max = max(param_max, float(d.max()))
        sig = q.grad.abs() > 1e-3 * float(q.grad.abs().max())
        close += int((d[sig] <= 1e-2 * lr).sum())
        total += int(sig.sum())
    grad_rel = (num / den) ** 0.5
    loss_k, loss_p = float(m_kernel["loss"]), float(m_plain["loss"])
    log(f"{what}, kernels vs plain hinge: loss {loss_k:.8g} vs {loss_p:.8g}, gradient "
        f"relative L2 {grad_rel:.3g}, parameters max|diff| {param_max:.3g} (lr {lr}), "
        f"{close}/{total} significant elements within 1e-2 lr")
    if abs(loss_k - loss_p) > STEP_LOSS_RTOL * abs(loss_p) or grad_rel > STEP_GRAD_RTOL \
            or param_max > 2 * lr * (1 + 1e-3) or close < STEP_PARAM_SHARE * total:
        fail(f"{what}: the step with the kernels disagrees with the plain-hinge step")


def device_frames(torch, np, dev, scene):
    """The scene's frames on the card, as a device cache holds them:
    rgb, depth (int32 millimetres), mask, poses, K and the valid-first
    pixel permutations of the masks."""
    from pdc_tpu_torch.ops.sampling import build_pixel_perm
    rgb, depth, mask, poses = scene.render_all()
    f = {"rgb": torch.as_tensor(rgb, device=dev),
         "depth": torch.as_tensor(depth.astype(np.int32), device=dev),
         "mask": torch.as_tensor(mask, device=dev),
         "pose": torch.as_tensor(poses, dtype=torch.float32, device=dev),
         "K": torch.as_tensor(scene.K, dtype=torch.float32, device=dev)}
    f["perm"], f["count"] = build_pixel_perm(f["mask"])
    return f


def pair_batch(torch, frames, ia, ib):
    """A within-scene batch of pairs (frames ia[k], ib[k]) from the device
    frames, with the keys assemble_batch_matrix reads."""
    ia = torch.as_tensor(ia, device=frames["rgb"].device)
    ib = torch.as_tensor(ib, device=frames["rgb"].device)
    batch = {"K": frames["K"].expand(len(ia), 3, 3),
             "match_type": torch.zeros(len(ia), dtype=torch.int64, device=ia.device)}
    for s, idx in (("a", ia), ("b", ib)):
        for key, src in (("rgb", "rgb"), ("depth", "depth"), ("mask", "mask"), ("pose", "pose"),
                         ("perm", "perm"), ("count", "count")):
            batch[f"{key}_{s}"] = frames[src][idx]
    return batch


def draw_pairs(np, rng, B, n_frames):
    """B within-scene pairs of distinct frames."""
    ia = rng.integers(0, n_frames, B)
    ib = (ia + rng.integers(1, n_frames, B)) % n_frames
    return ia, ib


# -- the training driver ---------------------------------------------------------

# DenseCorrespondenceTraining.run over TRAINING_CONFIG: 6 iterations, 3 steps a
# call (the on-device sampler route, one CUDA graph replayed 3 times a call);
# checkpoints at 0, 3 and 6; the test loss at iteration 6 over 8 // B = 2
# batches; then 2 more iterations resumed from the folder
DRIVER_OVERRIDES = {"num_iterations": 6, "save_rate": 3, "logging_rate": 3,
                    "compute_test_loss": True, "compute_test_loss_rate": 6,
                    "test_loss_num_iterations": 8, "use_tensorboard": False,
                    "steps_per_dispatch": 3, "seed": 1}
DRIVER_RESUME_ITERATIONS = 2
ROUTE_STEPS = 3  # the timed steps of each route (the device sampler's: one call)
# a reloaded network against the live one: the same weights, the same
# cuDNN algorithm on the same input
RELOAD_TOL = 1e-6


def driver_config(tmp, name, **overrides):
    import copy
    cfg = copy.deepcopy(TRAINING_CONFIG)
    cfg["training"].update(DRIVER_OVERRIDES, logging_dir=tmp, logging_dir_name=name)
    cfg["training"].update(overrides)
    return cfg


def timed_route_run(torch, ph, train_mod, dev, tmp, name, ds, iterations=ROUTE_STEPS,
                    **overrides):
    """``iterations`` of ``run`` with a synchronising callback at the end of
    every call, so the host clock between two callbacks is whole calls (the
    sampler thread's wait included). Returns (route, [ms a step of each
    call after the first], K1/K2 launches, the run's per-call host ms)."""
    cfg = driver_config(tmp, name, num_iterations=iterations, save_rate=1000,
                        logging_rate=1000, compute_test_loss=False, **overrides)
    trainer = train_mod.DenseCorrespondenceTraining(cfg, ds, device=dev)
    marks = []

    def mark(it, metrics):
        torch.cuda.synchronize(dev)
        marks.append((it, time.perf_counter()))

    ph.forward_launches = ph.backward_launches = 0
    trainer.run(progress_callback=mark)
    launches = (ph.forward_launches, ph.backward_launches)
    step_ms = [1e3 * (b - a) / (j - i) for (i, a), (j, b) in zip(marks, marks[1:])]
    return trainer.route, step_ms, launches, [1e3 * s for s in trainer.step_seconds]


def check_training_driver(torch, np, dev, here, bm, ph):
    """The phase "training driver": checks (a)-(h) of the module docstring.
    Returns the numbers the timings phase prints and the kernels line
    reads."""
    import shutil
    import tempfile

    from pdc_tpu_torch.data.dataset import SpartanDataset
    from pdc_tpu_torch.models.checkpoint import read_checkpoint
    from pdc_tpu_torch.models.convert import adam_state_to_flax, flax_to_state_dict
    from pdc_tpu_torch.training import train as train_mod

    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_driver_", dir=os.path.join(here, "build"))
    out = {}
    try:
        t = time.perf_counter()
        ds_train = SpartanDataset.from_dataset_config(DATASET_RECORD, mode="train")
        ds_test = SpartanDataset.from_dataset_config(DATASET_RECORD, mode="test")
        log(f"training driver datasets: train {sorted(ds_train.scenes)} and test "
            f"{sorted(ds_test.scenes)}, {ds_train.num_images_total} frames "
            f"{DATASET_RECORD['synthetic']['width']}x{DATASET_RECORD['synthetic']['height']} "
            f"each, rendered in {time.perf_counter() - t:.2f} s")

        cfg = driver_config(tmp, "driver")
        trainer = train_mod.DenseCorrespondenceTraining(cfg, ds_train, dataset_test=ds_test,
                                                        device=dev)
        n_iter, batch = cfg["training"]["num_iterations"], cfg["training"]["batch_size"]
        n_eval = cfg["training"]["test_loss_num_iterations"] // batch
        ph.forward_launches = ph.backward_launches = 0
        t = time.perf_counter()
        folder = trainer.run()
        torch.cuda.synchronize(dev)
        run_s = time.perf_counter() - t
        k1, k2 = ph.forward_launches, ph.backward_launches
        # (a) the route
        log(f"training driver: route {trainer.route!r}, {n_iter} iterations in {run_s:.2f} s "
            f"(3 checkpoints and the test loss included)")
        if trainer.route != train_mod.ROUTE_DEVICE_SAMPLER:
            fail(f"the driver took the {trainer.route!r} route, not the device sampler")
        # (b) launches: 2 per train step and warm-up step, 2 per eval batch (K1 only)
        want = scanned_launches(n_iter, eval_batches=n_eval)
        log(f"training driver launches: K1 {k1}, K2 {k2} (expected {want}: 2 x {n_iter} steps, "
            f"2 x the capture's warm-up steps, and K1 2 x {n_eval} eval batches)")
        if (k1, k2) != want:
            fail(f"K1/K2 launched {k1}/{k2} times in the driver's run")
        # (c) finite metrics, moved weights
        tl, te = trainer._logging_dict["train"], trainer._logging_dict["test"]
        log("training driver losses: " + ", ".join(f"{x:.5g}" for x in tl["loss"])
            + f"; test at {te['iteration']}: loss {te['loss']}, match {te['match_loss']}, "
            f"non-match {te['non_match_loss']}")
        values = [v for k, vs in tl.items() if k != "iteration" for v in vs]
        values += [v for k, vs in te.items() if k != "iteration" for v in vs]
        if (len(tl["loss"]) != n_iter or te["iteration"] != [n_iter]
                or not all(np.isfinite(v) for v in values)):
            fail("a driver metric is missing or not finite")
        first = flax_to_state_dict(read_checkpoint(os.path.join(folder, "000000.ckpt")))
        live = trainer.state.module.state_dict()
        still = [k for k, v in first.items() if v.dim() > 1 and torch.equal(v, live[k].cpu())]
        if still:
            fail(f"the driver left weights unchanged: {still[:5]}")
        # (d) the model folder
        want = {"training.yaml", "dataset.yaml", "identifier.yaml", "loss.yaml"}
        for it in (0, 3, 6):
            want |= {f"{it:06d}.ckpt", f"{it:06d}.ckpt.opt", f"{it:06d}_log_history.yaml"}
        files = set(os.listdir(folder))
        log(f"training driver folder: {sorted(files)}")
        if not want <= files:
            fail(f"the model folder lacks {sorted(want - files)}")
        sizes = {f: os.path.getsize(os.path.join(folder, f))
                 for f in ("000006.ckpt", "000006.ckpt.opt")}
        # (e) the step-6 optimizer file against the live Adam state
        state = trainer.state
        on_disk = read_checkpoint(os.path.join(folder, "000006.ckpt.opt"))
        live_opt = adam_state_to_flax(state.module, state.optimizer,
                                      state.step - state.schedule_start)
        flat_disk, flat_live = flatten(on_disk), flatten(live_opt)
        same = (flat_disk.keys() == flat_live.keys()
                and all(a.dtype == flat_live[k].dtype and np.array_equal(a, flat_live[k])
                        for k, a in flat_disk.items()))
        log(f"training driver 000006.ckpt.opt: {len(flat_disk)} arrays, Adam count "
            f"{int(on_disk['1']['count'])}, bit-equal to the live optimizer state: {same}")
        if not same or int(on_disk["1"]["count"]) != n_iter:
            fail("000006.ckpt.opt does not read back as the live optimizer state")
        # (f) resume for 2 more iterations
        cfg_r = driver_config(tmp, "driver_resumed", num_iterations=DRIVER_RESUME_ITERATIONS)
        resumed = train_mod.DenseCorrespondenceTraining(cfg_r, ds_train, dataset_test=ds_test,
                                                        device=dev)
        ph.forward_launches = ph.backward_launches = 0
        resumed.run_from_pretrained(folder)
        k1_r, k2_r = ph.forward_launches, ph.backward_launches
        end = n_iter + DRIVER_RESUME_ITERATIONS
        steps = {int(s["step"]) for s in resumed.state.optimizer.state.values()}
        log(f"training driver resumed at {resumed._start_iteration}: iterations "
            f"{resumed._logging_dict['train']['iteration']}, Adam steps {sorted(steps)}, "
            f"launches K1 {k1_r}, K2 {k2_r}")
        if (resumed._start_iteration != n_iter or steps != {end} or resumed.state.step != end
                or (k1_r, k2_r) != scanned_launches(DRIVER_RESUME_ITERATIONS)):
            fail("run_from_pretrained did not resume at 6 and end with every Adam step at 8")
        # (g) the folder's network against the live one, and one K3 query on it
        reloaded, out["k3_err"] = check_reload(torch, np, bm, dev, folder, trainer,
                                               ds_train.scenes["scene_000"], "training driver")
        # (h) the dataset record
        rebuilt = reloaded.load_training_dataset()
        same_ds = (sorted(rebuilt.scenes) == sorted(ds_train.scenes) and all(
            rebuilt.scenes[n].num_frames == s.num_frames
            and np.array_equal(rebuilt.scenes[n].poses, s.poses)
            for n, s in ds_train.scenes.items()))
        log(f"training driver load_training_dataset: scenes {sorted(rebuilt.scenes)}, frames "
            f"{[s.num_frames for _, s in sorted(rebuilt.scenes.items())]}, same poses: {same_ds}")
        if not same_ds:
            fail("load_training_dataset did not rebuild the training dataset")

        # each route, timed: ROUTE_STEPS steps after the first call (the device
        # sampler's first call of ROUTE_STEPS steps captures its graph)
        routes = {}
        for name, iterations, overrides in (
                ("device", 2 * ROUTE_STEPS, {"steps_per_dispatch": ROUTE_STEPS}),
                ("cached", ROUTE_STEPS + 1, {"steps_per_dispatch": 1}),
                ("streaming", ROUTE_STEPS + 1, {"cache_dataset_on_device": False})):
            route, step_ms, launches, call_ms = timed_route_run(
                torch, ph, train_mod, dev, tmp, name, ds_train, iterations, **overrides)
            routes[route] = {"step_ms": step_ms, "call_ms": call_ms, "launches": launches}
            want = (scanned_launches(iterations) if name == "device"
                    else (2 * iterations, 2 * iterations))
            if launches != want:
                fail(f"the {route} route launched K1/K2 {launches} times in {iterations} steps "
                     f"({want} expected)")
        if set(routes) != {train_mod.ROUTE_DEVICE_SAMPLER, train_mod.ROUTE_CACHED_HOST_SAMPLER,
                           train_mod.ROUTE_HOST_STREAMING}:
            fail(f"the timed runs took the routes {sorted(routes)}")
        out.update(k1=k1, k2=k2, run_s=run_s, step_ms=[1e3 * s for s in trainer.step_seconds],
                   save_ms=[1e3 * s for s in trainer.save_seconds], sizes=sizes, routes=routes)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# -- on-disk training ------------------------------------------------------------------

# the DATASET_RECORD scenes written in the pdc layout, one object's scene list
# each (its scene in both splits, as the record's num_test_scenes 0 means)
ONDISK_STAT_IMAGES = 24  # statistics over as many frames as the tree holds
STAT_TOL = 1e-6  # the printed statistics (6 digits) against float64 numpy


class _TrainerOf:
    """Within the block, records the DenseCorrespondenceTraining whose run()
    the command line calls, so its route, metrics and state can be read."""

    def __init__(self, train_mod):
        self._cls = train_mod.DenseCorrespondenceTraining
        self.trainer = None

    def __enter__(self):
        self._run = self._cls.run
        rec = self

        def run(trainer, *args, **kwargs):
            rec.trainer = trainer
            return rec._run(trainer, *args, **kwargs)
        self._cls.run = run
        return self

    def __exit__(self, *exc):
        self._cls.run = self._run


def write_tree(root, record):
    """The record's scenes under ``<root>/logs_proto`` (write_scene) and a
    composite config with one scene list per object under ``<root>/config``.
    Returns (composite file, {scene name: SyntheticScene})."""
    from pdc_tpu_torch.data.synthetic import SyntheticScene
    from pdc_tpu_torch.utils.yaml_io import save_yaml

    rec = dict(record["synthetic"])
    n, n_obj = rec.pop("num_scenes"), max(rec.pop("num_objects"), 1)
    rec.pop("num_test_scenes")
    offset = rec.pop("seed_offset", 0)
    scenes, lists = {}, {}
    for i in range(n):
        name, obj = f"scene_{i:03d}", i % n_obj
        scenes[name] = SyntheticScene(seed=offset + i, texture_seed=obj, **rec)
        scenes[name].write_scene(os.path.join(root, "logs_proto", name))
        lists.setdefault(f"object_{obj}", []).append(name)
    for obj, names in lists.items():
        save_yaml({"object_id": obj, "train": names, "test": names},
                  os.path.join(root, "config", "single_object", f"{obj}.yaml"))
    composite = os.path.join(root, "config", "composite", "composite.yaml")
    save_yaml({"logs_root_path": "logs_proto",
               "single_object_scenes_config_files": [f"{o}.yaml" for o in sorted(lists)]},
              composite)
    return composite, scenes


def write_paeth_png(np, path, rgb):
    """An RGB8 PNG with every row Paeth-filtered, as PIL's and libpng's
    adaptive writers choose for most rows of a camera frame (the port's
    encoder writes Up rows only)."""
    import struct
    import zlib

    h, w, _ = rgb.shape
    x = rgb.reshape(h, w * 3).astype(np.int16)
    a = np.zeros_like(x)
    a[:, 3:] = x[:, :-3]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 3:] = x[:-1, :-3]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.concatenate([np.full((h, 1), 4, np.uint8), ((x - pred) & 0xFF).astype(np.uint8)], 1)

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(
            ">I", zlib.crc32(body, zlib.crc32(t)))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def codec_times(np, nl, tmp, scene, decoders):
    """ms per 640x480 frame (its RGB, depth and mask files) to write and to
    decode with each decoder: one frame alone (median of 3 calls), and a
    whole scene in one call (the pool's threads in parallel) divided by its
    frames."""
    import statistics as stats

    frames = [scene.render(i) for i in range(scene.num_frames)]
    Hs, Ws = scene.height, scene.width
    out = {}
    for dec in decoders:
        d = os.path.join(tmp, f"codec_{dec}")
        os.makedirs(d, exist_ok=True)
        enc = [[(os.path.join(d, f"{i}_rgb.png"), nl.KIND_ENC_RGB8, f[0]),
                (os.path.join(d, f"{i}_depth.png"), nl.KIND_ENC_GRAY16, f[1]),
                (os.path.join(d, f"{i}_mask.png"), nl.KIND_ENC_GRAY8, f[2] * 255)]
               for i, f in enumerate(frames)]
        bufs = [(np.empty((Hs, Ws, 3), np.uint8), np.empty((Hs, Ws), np.uint16),
                 np.empty((Hs, Ws), np.uint8)) for _ in frames]
        kinds = (nl.KIND_RGB8, nl.KIND_GRAY16, nl.KIND_MASK8)
        dec_items = [[(p, k, b) for (p, _, _), k, b in zip(e, kinds, bb)]
                     for e, bb in zip(enc, bufs)]
        one_w, one_d = [], []
        for _ in range(3):
            t = time.perf_counter()
            nl.encode_batch(enc[0], Hs, Ws, decoder=dec)
            one_w.append(time.perf_counter() - t)
            t = time.perf_counter()
            nl.decode_batch(dec_items[0], Hs, Ws, decoder=dec)
            one_d.append(time.perf_counter() - t)
        t = time.perf_counter()
        nl.encode_batch([x for e in enc for x in e], Hs, Ws, decoder=dec)
        all_w = time.perf_counter() - t
        t = time.perf_counter()
        nl.decode_batch([x for e in dec_items for x in e], Hs, Ws, decoder=dec)
        all_d = time.perf_counter() - t
        for f, (rgb, depth, mask) in zip(frames, bufs):
            if not (np.array_equal(rgb, f[0]) and np.array_equal(depth, f[1])
                    and np.array_equal(mask, f[2])):
                fail(f"the {dec} codec did not round-trip a 640x480 frame bit for bit")
        # an RGB frame of Paeth rows, one file alone
        paeth = os.path.join(d, "paeth_rgb.png")
        write_paeth_png(np, paeth, frames[0][0])
        got, one_p = np.empty((Hs, Ws, 3), np.uint8), []
        for _ in range(3):
            t = time.perf_counter()
            nl.decode_batch([(paeth, nl.KIND_RGB8, got)], Hs, Ws, decoder=dec)
            one_p.append(time.perf_counter() - t)
        if not np.array_equal(got, frames[0][0]):
            fail(f"the {dec} codec did not decode a Paeth-filtered frame bit for bit")
        n = len(frames)
        out[dec] = {"write_ms": 1e3 * stats.median(one_w), "decode_ms": 1e3 * stats.median(one_d),
                    "write_ms_batched": 1e3 * all_w / n, "decode_ms_batched": 1e3 * all_d / n,
                    "paeth_rgb_decode_ms": 1e3 * stats.median(one_p)}
    return out


def check_on_disk_training(torch, np, dev, bm, ph, tmp):
    """The phase "on-disk training", in the directory ``tmp``: checks
    (a)-(e) of the module docstring. Returns the numbers the timings phase
    and the kernels line read, and the model folder it trained."""
    import contextlib
    import io

    from pdc_tpu_torch import __main__ as cli
    from pdc_tpu_torch.data import native_loader as nl
    from pdc_tpu_torch.data.dataset import SceneData, SpartanDataset
    from pdc_tpu_torch.data.scene import SceneStructure
    from pdc_tpu_torch.models.checkpoint import read_checkpoint
    from pdc_tpu_torch.models.convert import flax_to_state_dict
    from pdc_tpu_torch.training import train as train_mod
    from pdc_tpu_torch.utils.yaml_io import load_yaml, parse_yaml, save_yaml

    out = {}
    # the decoder auto picks, before any decode
    chosen = nl.resolve_decoder("auto")
    log(f"on-disk: PNG decoder 'auto' chose {chosen!r} ({nl.decoder_reason})")
    t = time.perf_counter()
    composite, scenes = write_tree(tmp, DATASET_RECORD)
    write_s = time.perf_counter() - t
    n_frames = sum(s.num_frames for s in scenes.values())
    log(f"on-disk: wrote {len(scenes)} scenes, {n_frames} frames "
        f"{DATASET_RECORD['synthetic']['width']}x{DATASET_RECORD['synthetic']['height']} in "
        f"the pdc layout ({chosen} encoder, PNGs, pose_data.yaml, camera_info.yaml, "
        f"fusion_mesh.ply) and a composite config in {write_s:.2f} s")

    # the frames on disk against the in-memory rendering
    t = time.perf_counter()
    for name, sc in scenes.items():
        got = SceneData.from_structure(SceneStructure(
            os.path.join(tmp, "logs_proto", name, "processed")), name)
        rgb, depth, mask, poses = sc.render_all()
        pose_err = float(np.abs(got.poses - poses).max())
        same = (np.array_equal(got.rgb, rgb) and np.array_equal(got.depth, depth)
                and np.array_equal(got.mask, mask) and np.array_equal(got.K, sc.K)
                and got.frame_ids is None)
        log(f"on-disk {name}: decoded frames bit-equal to the rendering: {same}; poses "
            f"max|diff| {pose_err:.3g} (bar 1e-9)")
        if not same or not pose_err <= 1e-9:
            fail(f"scene {name} does not read back as it was rendered")
    read_s = time.perf_counter() - t
    decoders = ["zlib"] + (["libpng"] if chosen == "libpng" else [])
    out["codec"] = codec_times(np, nl, tmp, scenes["scene_000"], decoders)
    for dec, c in out["codec"].items():
        log(f"on-disk {dec} codec, {scenes['scene_000'].width}x{scenes['scene_000'].height} "
            f"frame (RGB + depth + mask files): write "
            f"{c['write_ms']:.2f} ms, decode {c['decode_ms']:.2f} ms (one frame alone, "
            f"median of 3); a 12-frame scene in one call: write {c['write_ms_batched']:.2f}, "
            f"decode {c['decode_ms_batched']:.2f} ms per frame (host clock, {os.cpu_count()} "
            f"cores); the RGB file alone with every row Paeth-filtered: decode "
            f"{c['paeth_rgb_decode_ms']:.2f} ms")

    # python -m pdc_tpu_torch train, in this process
    cfg = driver_config(tmp, "on_disk")
    cfg_file = os.path.join(tmp, "training.yaml")
    save_yaml(cfg, cfg_file)
    argv = ["train", "--config", cfg_file, "--dataset_config", composite, "--data_dir", tmp,
            "--name", "on_disk", "--logging_dir", tmp, "--device", str(dev)]
    n_iter, batch = cfg["training"]["num_iterations"], cfg["training"]["batch_size"]
    n_eval = cfg["training"]["test_loss_num_iterations"] // batch
    ph.forward_launches = ph.backward_launches = 0
    t = time.perf_counter()
    with _TrainerOf(train_mod) as rec:
        rc = cli.main(argv)
    torch.cuda.synchronize(dev)
    run_s = time.perf_counter() - t
    k1, k2 = ph.forward_launches, ph.backward_launches
    trainer = rec.trainer
    if rc != 0 or trainer is None:
        fail(f"python -m pdc_tpu_torch train returned {rc}")
    folder = trainer.logging_dir
    log(f"on-disk: python -m pdc_tpu_torch {' '.join(argv)} -> {folder}: route "
        f"{trainer.route!r}, {n_iter} iterations in {run_s:.2f} s (the scenes' decode, 3 "
        f"checkpoints and the test loss included)")
    # (a) launches
    want = scanned_launches(n_iter, eval_batches=n_eval)
    log(f"on-disk launches: K1 {k1}, K2 {k2} (expected {want}: 2 x {n_iter} steps, 2 x the "
        f"capture's warm-up steps, and K1 2 x {n_eval} eval batches)")
    if (k1, k2) != want:
        fail(f"K1/K2 launched {k1}/{k2} times in the on-disk run")
    # (b) finite metrics, moved weights
    tl, te = trainer._logging_dict["train"], trainer._logging_dict["test"]
    values = [v for k, vs in tl.items() if k != "iteration" for v in vs]
    values += [v for k, vs in te.items() if k != "iteration" for v in vs]
    log("on-disk losses: " + ", ".join(f"{x:.5g}" for x in tl["loss"])
        + f"; test at {te['iteration']}: loss {te['loss']}")
    if (len(tl["loss"]) != n_iter or te["iteration"] != [n_iter]
            or not all(np.isfinite(v) for v in values)):
        fail("an on-disk metric is missing or not finite")
    first = flax_to_state_dict(read_checkpoint(os.path.join(folder, "000000.ckpt")))
    live = trainer.state.module.state_dict()
    still = [k for k, v in first.items() if v.dim() > 1 and torch.equal(v, live[k].cpu())]
    if still:
        fail(f"the on-disk run left weights unchanged: {still[:5]}")
    # (c) the dataset record, and the dataset rebuilt from it
    record = load_yaml(os.path.join(folder, "dataset.yaml"))
    want_dirs = (os.path.abspath(tmp), os.path.dirname(os.path.abspath(composite)))
    log(f"on-disk dataset.yaml: data_dir {record.get('data_dir')}, config_dir "
        f"{record.get('config_dir')}")
    if (record.get("data_dir"), record.get("config_dir")) != want_dirs:
        fail(f"dataset.yaml does not record the absolute data_dir and config_dir {want_dirs}")
    # (d) the folder's network, and one K3 query on it
    trained = trainer.dataset
    reloaded, out["k3_err"] = check_reload(torch, np, bm, dev, folder, trainer,
                                           trained.scenes["scene_000"], "on-disk")
    rebuilt = reloaded.load_training_dataset("train")
    same_ds = rebuilt.get_scene_list() == trained.get_scene_list() and all(
        rebuilt.get_scene(n).frame_ids is None and s.frame_ids is None
        and np.array_equal(rebuilt.get_scene(n).poses, s.poses)
        and rebuilt.get_scene(n).num_frames == s.num_frames
        for n, s in trained.scenes.items())
    log(f"on-disk load_training_dataset('train'): scenes {rebuilt.get_scene_list()}, "
        f"frames {[rebuilt.get_scene(n).num_frames for n in rebuilt.get_scene_list()]}, same "
        f"names, frame ids and poses as the trained dataset: {same_ds}")
    if not same_ds:
        fail("load_training_dataset did not rebuild the on-disk dataset")
    # (e) statistics on the tree against float64 numpy over the same frames
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["statistics", "--config", composite, "--data_dir", tmp,
                  "--num_images", str(ONDISK_STAT_IMAGES), "--device", str(dev)])
    block = parse_yaml(buf.getvalue())["image_normalization"]
    again = SpartanDataset(config=load_yaml(composite), data_dir=tmp,
                           config_dir=os.path.dirname(composite))
    frames = []
    for _ in range(ONDISK_STAT_IMAGES):
        name = again.get_random_scene_name()
        frames.append(again.get_rgbd_mask_pose(name, again.get_random_image_index(name))[0])
    x = np.stack(frames).reshape(-1, 3).astype(np.float64) / 255.0
    stat_err = max(float(np.abs(np.asarray(block["mean"]) - x.mean(0)).max()),
                   float(np.abs(np.asarray(block["std_dev"]) - x.std(0)).max()))
    log(f"on-disk statistics: mean {block['mean']}, std_dev {block['std_dev']}; "
        f"max|diff| to float64 numpy over the same {ONDISK_STAT_IMAGES} frames "
        f"{stat_err:.3g} (bar {STAT_TOL})")
    if not stat_err <= STAT_TOL:
        fail("the statistics command disagrees with float64 numpy")
    out.update(k1=k1, k2=k2, run_s=run_s, write_s=write_s, read_s=read_s, decoder=chosen,
               step_ms=[1e3 * s for s in trainer.step_seconds], route=trainer.route,
               folder=folder, composite=composite, scenes=scenes)
    return out


def check_reload(torch, np, bm, dev, folder, trainer, scene, what):
    """``from_model_folder`` on ``folder`` against the live network of
    ``trainer`` (forward_on_img within RELOAD_TOL on the scene's frame 0),
    then one K3 query of 16 descriptors of frame 1 on the reloaded
    descriptors of frame 0, against the plain best match. Returns (the
    reloaded network, K3's distance error against its plain version)."""
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork

    reloaded = DenseCorrespondenceNetwork.from_model_folder(folder, device=dev)
    live_dcn = trainer.get_dcn()
    frame = scene.rgb[0]
    res = reloaded.forward_on_img(frame)
    reload_err = float((res - live_dcn.forward_on_img(frame)).abs().max())
    Hd, Wd, Dd = res.shape
    image = res.permute(2, 0, 1).reshape(1, Dd, Hd * Wd).contiguous()
    other = reloaded.forward_on_img(scene.rgb[1])
    px = torch.as_tensor(np.random.default_rng(SEED).integers(0, Hd * Wd, 16), device=dev)
    q = other.reshape(Hd * Wd, Dd)[px][None].contiguous()
    idx, dist = bm.best_match(image, q)
    pidx, pdist = bm.best_match_reference(image, q)
    bad, err = check_matches(torch, bm, image, q, idx, dist)
    vs_plain = float((dist - pdist).abs().max())
    log(f"{what} reload: from_model_folder vs get_dcn max|diff| {reload_err:.3g} "
        f"(bar {RELOAD_TOL}); K3 on the reloaded descriptors, 16 queries: bad_idx {bad}, "
        f"dist_err {err:.3g}, vs plain {vs_plain:.3g}")
    if not reload_err <= RELOAD_TOL or bad or not err <= DIST_TOL or not vs_plain <= PLAIN_TOL:
        fail(f"{what}: the reloaded network disagrees with the live one, or K3 with its plain "
             "version")
    return reloaded, vs_plain


# -- evaluation ---------------------------------------------------------------------

# python -m pdc_tpu_torch evaluate on phase 8's model folder: 20 pairs of 100
# matches in each split (seed 1), chunks of SWEEP_PAIR_CHUNK pairs; check (c)
# reruns the first EVAL_CHECK_PAIRS test pairs both ways
EVAL_PAIRS, EVAL_MATCHES, EVAL_CHECK_PAIRS = 20, 100, 4
# the fused route (K3) against the per-pair route (plain best match): the
# same arithmetic but K3's FMAs, so 1e-5 on every value column
EVAL_COL_TOL = 1e-5
# columns that follow the unmasked pick; compared where both routes pick the
# same pixel (a differing pick must be a near-tie, TIE_TOL_D2)
PICK_COLUMNS = ("pixel_match_error_l2", "pixel_match_error_l1", "norm_diff_pred_3d",
                "is_valid", "uv_b_pred")


def _timer(torch, owner, name, totals, key, bm=None):
    """Replace ``owner.name`` by a wrapper that synchronises before and
    after each call and adds its seconds (and, given ``bm``, its K3
    launches) to ``totals[key]``. Returns the function that restores it."""
    orig = owner.__dict__[name]
    fn = orig.__func__ if isinstance(orig, staticmethod) else orig

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t, n = time.perf_counter(), bm.launches if bm else 0
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            totals[key] = totals.get(key, 0.0) + time.perf_counter() - t
            if bm:
                totals[key + "_launches"] = totals.get(key + "_launches", 0) + bm.launches - n
    setattr(owner, name, staticmethod(wrapper) if isinstance(orig, staticmethod) else wrapper)
    return lambda: setattr(owner, name, orig)


def check_eval_routes(torch, np, bm, ev, ds, pairs, images, table):
    """Check (c): the first EVAL_CHECK_PAIRS pairs of a sweep through the
    fused route (one K3 launch) against the per-pair route with the plain
    best match, and the fused rows against the sweep's table. Returns
    (differing picks, K3's distance error against the plain version)."""
    sub = pairs[:EVAL_CHECK_PAIRS]
    dev = images[sub[0][:2]].device
    res_a = torch.stack([images[(s, a)] for s, a, _, _ in sub])
    res_b = torch.stack([images[(s, b)] for s, _, b, _ in sub])
    frames = ev._chunk_frames(ds, sub, dev)
    uv_a, uv_b, gt_valid = ev._sweep_correspondences(frames, [p[3] for p in sub],
                                                     EVAL_MATCHES, 2000)
    fused = {k: v.cpu().numpy() for k, v in ev._sweep_statistics(
        frames, uv_a, uv_b, res_a, res_b).items()}
    gt_valid = gt_valid.cpu().numpy()
    saved, ev.best_match = ev.best_match, bm.best_match_reference
    try:
        plain = [ev._pair_statistics(ds, s, a, b, EVAL_MATCHES, ev.pair_generator(ps), 2000,
                                     images[(s, a)], images[(s, b)]) for s, a, b, ps in sub]
    finally:
        ev.best_match = saved
    Hd, Wd, Dd = res_a.shape[1:]
    ties, dist_err, col_err, row = 0, 0.0, 0.0, 0
    for p, (s, a, b, _) in enumerate(sub):
        keep = np.nonzero(gt_valid[p])[0]
        f = {k: v[p][keep] for k, v in fused.items()}
        q = plain[p]
        if q is None or len(keep) != len(q["is_valid"]):
            fail(f"evaluation (c): pair {p} has {len(keep)} fused rows but "
                 f"{0 if q is None else len(q['is_valid'])} per-pair rows")
        same = (f["uv_b_pred"] == q["uv_b_pred"]).all(-1)
        if not same.all():  # a differing pick must be a float64 near-tie
            qa = res_a[p].reshape(-1, Dd).double()[torch.as_tensor(
                uv_a[p][keep][:, 1] * Wd + uv_a[p][keep][:, 0], device=dev)]
            rb = res_b[p].reshape(-1, Dd).double()
            for i in np.nonzero(~same)[0]:
                d2 = [float(((rb[int(uv[i][1]) * Wd + int(uv[i][0])] - qa[i]) ** 2).sum())
                      for uv in (f["uv_b_pred"], q["uv_b_pred"])]
                if abs(d2[0] - d2[1]) > TIE_TOL_D2:
                    fail(f"evaluation (c): pair {p} match {i} picks {f['uv_b_pred'][i]} (K3) "
                         f"and {q['uv_b_pred'][i]} (plain), squared distances {d2}")
                ties += 1
        for k in q:
            mask = same if k in PICK_COLUMNS else np.ones_like(same)
            x, y = f[k][mask].astype(np.float64), q[k][mask].astype(np.float64)
            if not np.array_equal(np.isnan(x), np.isnan(y)):
                fail(f"evaluation (c): NaN pattern of {k} differs on pair {p}")
            err = float(np.abs(x - y)[~np.isnan(x)].max()) if (~np.isnan(x)).any() else 0.0
            if k == "norm_diff_descriptor":
                dist_err = max(dist_err, err)
            col_err = max(col_err, err)
        # the rerun against the sweep's own rows (the CSV the command wrote)
        for c in ("norm_diff_descriptor", "norm_diff_descriptor_masked",
                  "pixel_match_error_l2", "fraction_pixels_closer_than_ground_truth",
                  "average_l2_distance_for_false_positives_masked", "norm_diff_pred_3d"):
            x = table[c][row:row + len(keep)].astype(np.float64)
            y = f[c].astype(np.float64)
            if not np.allclose(x, y, atol=EVAL_COL_TOL, rtol=0, equal_nan=True):
                fail(f"evaluation (c): the rerun's {c} of pair {p} differs from the data.csv "
                     "the command wrote")
        row += len(keep)
    log(f"evaluation (c): {EVAL_CHECK_PAIRS} test pairs, {row} matches, fused route (K3) vs "
        f"per-pair route (plain best match): {ties} differing picks, all near-ties; max|diff| "
        f"{col_err:.3g} over the value columns (bar {EVAL_COL_TOL}); the rerun equals the "
        f"data.csv rows")
    if col_err > EVAL_COL_TOL:
        fail("evaluation (c): the fused and per-pair routes disagree")
    return ties, dist_err


def check_evaluation(torch, np, dev, here, bm, folder):
    """The phase "evaluation": checks (a)-(f) of the module docstring, and
    the numbers the timings phase and the kernels line read."""
    import importlib
    import math

    from pdc_tpu_torch import __main__ as cli
    from pdc_tpu_torch.evaluation import evaluate as ev
    from pdc_tpu_torch.evaluation.table import read_csv
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
    from pdc_tpu_torch.utils.yaml_io import load_yaml

    have = {}
    for name in ("pandas", "matplotlib", "cv2"):
        try:
            importlib.import_module(name)
            have[name] = True
        except ImportError:
            have[name] = False
    log("evaluation: optional modules on this machine: " + ", ".join(
        f"{k} {'imports' if v else 'missing'}" for k, v in have.items()))
    out_dir = os.path.join(folder, "analysis")
    argv = ["evaluate", "--model_folder", folder, "--num_image_pairs", str(EVAL_PAIRS),
            "--num_matches_per_image_pair", str(EVAL_MATCHES), "--device", str(dev)]
    if not have["matplotlib"]:
        argv.append("--no_qualitative")
    DCE = ev.DenseCorrespondenceEvaluation
    totals = {}
    restore = [_timer(torch, DCE, "evaluate_network_quantitative", totals, "sweep"),
               _timer(torch, DCE, "compute_descriptor_images_batched", totals, "forwards"),
               _timer(torch, ev, "_sweep_correspondences", totals, "correspondences"),
               _timer(torch, ev, "_sweep_statistics", totals, "statistics", bm),
               _timer(torch, DCE, "compute_descriptor_statistics_on_dataset", totals,
                      "descriptor statistics"),
               _timer(torch, DCE, "evaluate_network_across_objects", totals, "across objects")]
    bm.launches = 0
    t = time.perf_counter()
    try:
        rc = cli.main(argv)
        torch.cuda.synchronize(dev)
    finally:
        for r in restore:
            r()
    run_s = time.perf_counter() - t
    launches = bm.launches
    if rc != 0:
        fail(f"python -m pdc_tpu_torch evaluate returned {rc}")
    log(f"evaluation: python -m pdc_tpu_torch {' '.join(argv)}: {run_s:.2f} s")

    # (a) the sweeps' tables, read back
    ds = DCE.load_dataset_from_model_folder(folder)
    tables, pair_lists = {}, {}
    for mode in ("train", "test"):
        ds.set_train_mode() if mode == "train" else ds.set_test_mode()
        pair_lists[mode] = ev.image_pair_list(ds, EVAL_PAIRS, 1)
        tables[mode] = read_csv(os.path.join(out_dir, mode, "data.csv"))
        t_ = tables[mode]
        finite = np.isfinite(t_["norm_diff_descriptor"].astype(np.float64)).all()
        log(f"evaluation (a) {mode}/data.csv: {len(t_)} rows x {len(t_.columns)} columns from "
            f"{len(pair_lists[mode])} pairs; columns as EVAL_COLUMNS: "
            f"{t_.columns == ev.EVAL_COLUMNS}; descriptor distances finite: {finite}")
        if (t_.columns != ev.EVAL_COLUMNS or not 0 < len(t_) <= EVAL_MATCHES * len(
                pair_lists[mode]) or not finite):
            fail(f"evaluation (a): {mode}/data.csv is not a table of the 23 columns")
    # (b) K3 on the sweeps: one launch per chunk
    chunks = sum(math.ceil(len(v) / ev.SWEEP_PAIR_CHUNK) for v in pair_lists.values())
    qual = sum(f.endswith("_matches.png") for _, _, fs in os.walk(out_dir) for f in fs)
    sweep_launches = totals.get("statistics_launches", 0)
    log(f"evaluation (b): K3 launches {launches}: {sweep_launches} in the sweeps (expected one "
        f"per chunk of {ev.SWEEP_PAIR_CHUNK} pairs: {chunks}), {launches - sweep_launches} in "
        f"{qual} qualitative panels")
    if sweep_launches != chunks or launches != sweep_launches + qual:
        fail("evaluation (b): K3 did not launch once per sweep chunk")
    # (c) fused against per-pair, on the test split's first pairs
    dcn = DenseCorrespondenceNetwork.from_model_folder(folder, device=dev)
    pairs = pair_lists["test"]
    images = DCE.compute_descriptor_images_batched(
        dcn, ds, [(s, i) for s, a, b, _ in pairs for i in (a, b)])
    ties, k3_err = check_eval_routes(torch, np, bm, ev, ds, pairs, images, tables["test"])
    # (d) stats.yaml
    for mode in ("train", "test"):
        st = load_yaml(os.path.join(out_dir, mode, "stats.yaml"))
        pck = [st.get(f"pck_at_{k}px") for k in (5, 10, 25, 50, 100)]
        log(f"evaluation (d) {mode}/stats.yaml: PCK@5,10,25,50,100 {pck}, area above the 3D "
            f"CDF {st.get('norm_diff_3d_area_above_curve')}")
        if (not all(isinstance(x, float) and 0.0 <= x <= 1.0 for x in pck)
                or not math.isfinite(st.get("norm_diff_3d_area_above_curve", math.nan))):
            fail(f"evaluation (d): {mode}/stats.yaml is not a set of PCKs in [0, 1]")
    # (e) descriptor_statistics.yaml
    ds_stats = load_yaml(os.path.join(folder, "descriptor_statistics.yaml"))
    ok = all(len(v[k]) == D and all(math.isfinite(x) for x in v[k])
             for v in ds_stats.values() for k in ("min", "mean", "max")) and all(
        mn <= me <= mx for v in ds_stats.values()
        for mn, me, mx in zip(v["min"], v["mean"], v["max"]))
    log(f"evaluation (e) descriptor_statistics.yaml: {ds_stats}; finite, min <= mean <= max: "
        f"{ok}")
    if not ok or set(ds_stats) != {"entire_image", "mask_image"}:
        fail("evaluation (e): descriptor_statistics.yaml is not finite and ordered")
    # (f) across objects
    n_obj = ds.get_number_of_unique_single_objects()
    ao_csv = os.path.join(out_dir, "across_object", "data.csv")
    if n_obj > 1:
        ao = read_csv(ao_csv) if os.path.exists(ao_csv) else None
        log(f"evaluation (f): {n_obj} objects; across_object/data.csv "
            f"{'missing' if ao is None else f'{len(ao)} rows, columns {ao.columns}'}")
        if ao is None or ao.columns != ev.ACROSS_OBJECT_COLUMNS or not len(ao):
            fail("evaluation (f): the across-object table is missing or empty")
    files = sorted(os.path.relpath(os.path.join(d, f), folder)
                   for d, _, fs in os.walk(out_dir) for f in fs)
    log(f"evaluation files: descriptor_statistics.yaml, {files}")

    # K3 at the sweep's shape: the first chunk's pairs of the test split
    B = min(ev.SWEEP_PAIR_CHUNK, len(pairs))
    chunk = pairs[:B]
    frames = ev._chunk_frames(ds, chunk, dev)
    uv_a, _, _ = ev._sweep_correspondences(frames, [p[3] for p in chunk], EVAL_MATCHES, 2000)
    res_a = torch.stack([images[(s, a)] for s, a, _, _ in chunk])
    res_b = torch.stack([images[(s, b)] for s, _, b, _ in chunk])
    Hd, Wd, Dd = res_a.shape[1:]
    flat = (uv_a[..., 1] * Wd + uv_a[..., 0])[..., None].expand(-1, -1, Dd)
    q = torch.gather(res_a.reshape(B, -1, Dd), 1, flat).contiguous()
    res = res_b.reshape(B, -1, Dd).transpose(1, 2).contiguous()
    idx, dist = bm.best_match(res, q)
    torch.cuda.synchronize()
    bad, err = check_matches(torch, bm, res, q, idx, dist)
    vs_plain = float((dist - bm.best_match_reference(res, q)[1]).abs().max())
    log(f"K3 at the sweep's shape B={B} Q={EVAL_MATCHES} {Wd}x{Hd} D={Dd}: bad_idx {bad}, "
        f"dist_err {err:.3g}, vs plain {vs_plain:.3g}")
    if bad or not err <= DIST_TOL or not vs_plain <= PLAIN_TOL:
        fail("K3 disagrees with its plain version at the sweep's shape")
    flat_b = res_b.reshape(B, -1, Dd)

    def library():
        dmat = torch.cdist(flat_b, q)  # [B, HW, Q]
        i = dmat.argmin(dim=1)
        return i, dmat.gather(1, i[:, None])
    k3 = {"B": B, "Q": EVAL_MATCHES, "HW": Hd * Wd,
          "ms": time_device(torch, lambda: bm.best_match(res, q)),
          "wrapper_ms": time_cuda(torch, lambda: bm.best_match(res, q)),
          "plain_ms": time_device(torch, lambda: bm.best_match_reference(res, q), iters=3),
          "library_ms": time_device(torch, library, iters=3),
          "split": profile_split(torch, lambda: bm.best_match(res, q))}
    k3["bound_ms"], k3["bound_by"] = bound(B, EVAL_MATCHES, Dd, Hd * Wd)
    return {"run_s": run_s, "totals": totals, "launches": launches, "have": have,
            "k3_err": max(k3_err, vs_plain), "k3": k3, "ties": ties,
            "pairs": {m: len(v) for m, v in pair_lists.items()},
            "rows": {m: len(v) for m, v in tables.items()}}


# -- per-pair and synthetic multi-object --------------------------------------------

# the type mix of the shoes experiments (trained_models/experiments/shoes/*/training.yaml)
SHOES_MIX = {"SINGLE_OBJECT_WITHIN_SCENE": 0.33, "SINGLE_OBJECT_ACROSS_SCENE": 0,
             "DIFFERENT_OBJECT": 0.33, "MULTI_OBJECT": 0, "SYNTHETIC_MULTI_OBJECT": 0.33}
PER_PAIR_STEPS = 5
# the per-pair terms on the card against the CPU's from the same predictions and
# indices: the same float32 operations, but index_add's atomics order the
# gradient's sums differently: terms rtol 1e-5, gradients relative L2 1e-4
PAIR_TERM_RTOL, PAIR_GRAD_RTOL = 1e-5, 1e-4


def per_pair_config(**training):
    """TRAINING_CONFIG on the per-pair loss (use_matrix_loss: false)."""
    import copy
    cfg = copy.deepcopy(TRAINING_CONFIG)
    cfg["training"].update(use_matrix_loss=False, **training)
    return cfg


class _AssemblySpy:
    """Within the block, counts the rows (and the synthetic multi-object rows)
    that ``name`` of the train module assembles, and keeps the first batch
    that holds a synthetic multi-object row, with its assembly and config.
    It never waits on the card, so a CUDA graph captures it with the step:
    its counts are device tensors that every replay adds to, and a batch
    assembled in a capture is kept as the graph's buffers, which hold the
    last replay's batch when the block ends."""

    def __init__(self, train_mod, name):
        self.mod, self.name = train_mod, name
        self.counts = None  # [rows, synthetic multi-object rows], on the device
        self.batches = []

    def __enter__(self):
        self.real = real = getattr(self.mod, self.name)

        def spy(batch, cfg, generator, device="cuda", **options):
            out = real(batch, cfg, generator, device=device, **options)
            mt = out[2].match_type
            if self.counts is None:
                self.counts = mt.new_zeros(2)
            self.counts[0] += mt.numel()
            self.counts[1] += (mt == 4).sum()
            if len(self.batches) < 2:  # the first eager one and the captured one
                self.batches.append((batch, out, cfg))
            return out

        setattr(self.mod, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)
        self.rows, self.smo_rows = (0, 0) if self.counts is None else (
            int(self.counts[0]), int(self.counts[1]))
        self.kept = next((b for b in self.batches if bool((b[1][2].match_type == 4).any())),
                         None)


def smo_occlusion(torch, asm, kept):
    """Of an assembled batch's synthetic multi-object rows: (rows, matches
    of the object behind that the front object covers, those of them still
    valid, valid blind entries). The front object of each composite is read
    from the image: the composite is where(front mask, front, back), which
    equals exactly one of the two orders because the backgrounds differ."""
    batch, (img_a, img_b, s), cfg = kept
    rows = torch.nonzero(s.match_type == 4).flatten().tolist()
    half = cfg.num_matching_attempts // 2
    covered_n = bad = 0
    for r in rows:
        valid = s.matches_valid[r]
        for img, view, flat in ((img_a, "a", s.matches_a), (img_b, "b", s.matches_b)):
            norm = [asm._normalize(batch[f"rgb_{view}{x}"][r], cfg) for x in ("", "_2")]
            masks = [batch[f"mask_{view}{x}"][r] != 0 for x in ("", "_2")]
            first = torch.equal(img[r], torch.where(masks[0][..., None], norm[0], norm[1]))
            second = torch.equal(img[r], torch.where(masks[1][..., None], norm[1], norm[0]))
            if first == second:
                fail(f"synthetic multi-object row {r}: its composite {view} is neither order "
                     "of its two pairs")
            behind = slice(half, None) if first else slice(0, half)
            covered = (masks[0] if first else masks[1]).reshape(-1)[flat[r, behind]]
            covered_n += int(covered.sum())
            bad += int((covered & valid[behind]).sum())
    blind = int(s.blind_nm_valid[rows].sum()) if rows else 0
    return len(rows), covered_n, bad, blind


def check_per_pair_and_smo(torch, np, dev, here, bm, ph, frames_t, folder):
    """The phase "per-pair and synthetic multi-object": checks (a)-(d) of
    the module docstring. Returns what the timings phase reads."""
    import shutil
    import tempfile

    from pdc_tpu_torch.data import assembler as asm
    from pdc_tpu_torch.data.dataset import SpartanDataset
    from pdc_tpu_torch.evaluation.evaluate import DenseCorrespondenceEvaluation
    from pdc_tpu_torch.losses.composer import compose_loss
    from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
    from pdc_tpu_torch.training import train as train_mod

    out = {}
    # (a) the per-pair train step at full width
    tc = per_pair_config()
    net_cfg = tc["dense_correspondence_network"]
    Bt, Wt = tc["training"]["batch_size"], net_cfg["image_width"]
    HWt = Wt * net_cfg["image_height"]
    loss_cfg = LossConfig.from_dict(tc["loss_function"])
    state = new_train_state(torch, tc)
    initial = {k: v.detach().clone() for k, v in state.module.named_parameters()}
    step = train_mod.make_train_step(tc, loss_cfg, asm.AssemblerConfig.from_training_config(tc),
                                     Wt)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    pair_rng = np.random.default_rng(SEED + 2)

    def batch():
        return pair_batch(torch, frames_t, *draw_pairs(np, pair_rng, Bt, N_FRAMES))

    ph.forward_launches = ph.backward_launches = 0
    history = [{k: float(v) for k, v in step(state, batch(), gen).items()}
               for _ in range(PER_PAIR_STEPS)]
    torch.cuda.synchronize()
    launches = (ph.forward_launches, ph.backward_launches)
    for i, m in enumerate(history):
        log(f"per-pair train step {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in m.items()))
    still = [k for k, v in state.module.named_parameters()
             if v.dim() > 1 and torch.equal(v.detach(), initial[k])]
    log(f"per-pair training: {net_cfg['backbone']['resnet_name']} {Wt}x{HWt // Wt} B={Bt}, "
        f"{PER_PAIR_STEPS} steps through make_train_step (use_matrix_loss false); weight "
        f"tensors unchanged: {len(still)}; launches K1 {launches[0]}, K2 {launches[1]} "
        f"(0 expected: the per-pair loss runs no kernel)")
    if not all(np.isfinite(v) for m in history for v in m.values()) or still:
        fail("a per-pair training metric is not finite, or the weights did not move")
    if launches != (0, 0):
        fail(f"the per-pair route launched K1/K2 {launches} times")
    # one step's terms on the card against the CPU's, from the same predictions
    img_a, img_b, idx = step.assemble(state, batch(), gen)
    module = state.module
    with torch.no_grad():
        module.eval()
        o = module(torch.cat([img_a, img_b]).permute(0, 3, 1, 2).contiguous())
        module.train()
    pred = o.permute(0, 2, 3, 1).reshape(2 * Bt, HWt, o.shape[1])
    w = torch.linspace(0.5, 1.5, Bt)

    def terms_and_grads(pred, indices):
        pa = pred[:Bt].clone().requires_grad_()
        pb = pred[Bt:].clone().requires_grad_()
        terms = compose_loss(pa, pb, indices, loss_cfg, Wt)
        (terms.loss * w.to(pred.device)).sum().backward()
        return terms, pa.grad, pb.grad

    card = terms_and_grads(pred, idx)
    cpu = terms_and_grads(pred.cpu(), type(idx)(*[x.cpu() for x in idx]))
    term_err = max(float(((a.detach().cpu() - b.detach()).abs()
                          / b.detach().abs().clamp(min=1e-30)).max())
                   for a, b in zip(card[0], cpu[0]))
    grad_rel = max(float((a.cpu() - b).norm() / b.norm()) for a, b in zip(card[1:], cpu[1:]))
    log(f"per-pair compose_loss on the card vs the CPU, same predictions and indices "
        f"({int(idx.masked_nm_valid.sum())} valid masked and "
        f"{int(idx.background_nm_valid.sum())} background non-matches): loss "
        f"{card[0].loss.detach().cpu().tolist()} vs {cpu[0].loss.detach().tolist()}, largest "
        f"relative term difference {term_err:.3g} (bar {PAIR_TERM_RTOL}), gradient relative "
        f"L2 {grad_rel:.3g} (bar {PAIR_GRAD_RTOL})")
    if not term_err <= PAIR_TERM_RTOL or not grad_rel <= PAIR_GRAD_RTOL:
        fail("the per-pair terms on the card disagree with the CPU's")
    out["per_pair"] = {"state": state, "step": step, "gen": gen, "batch": batch,
                       "loss_cfg": loss_cfg}
    del card, cpu, pred, o

    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_smo_", dir=os.path.join(here, "build"))
    try:
        ds = SpartanDataset.from_dataset_config(DATASET_RECORD, mode="train")
        # (b) synthetic multi-object rows on the matrix route, through the driver
        cfg = driver_config(tmp, "smo", compute_test_loss=False, save_rate=1000,
                            data_type_probabilities=SHOES_MIX)
        n_iter = cfg["training"]["num_iterations"]
        trainer = train_mod.DenseCorrespondenceTraining(cfg, ds, device=dev)
        ph.forward_launches = ph.backward_launches = 0
        t = time.perf_counter()
        with _AssemblySpy(train_mod, "assemble_batch_matrix") as spy:
            trainer.run()
        torch.cuda.synchronize(dev)
        run_s = time.perf_counter() - t
        k = (ph.forward_launches, ph.backward_launches)
        losses = trainer._logging_dict["train"]["loss"]
        log(f"synthetic multi-object, matrix route: route {trainer.route!r}, {n_iter} "
            f"iterations in {run_s:.2f} s, {spy.smo_rows} of {spy.rows} rows of type 4 (the "
            f"capture's warm-up step's included); launches K1 {k[0]}, K2 {k[1]} (expected "
            f"{scanned_launches(n_iter)}); losses " + ", ".join(f"{x:.5g}" for x in losses))
        if trainer.route != train_mod.ROUTE_DEVICE_SAMPLER:
            fail(f"the synthetic multi-object run took the {trainer.route!r} route")
        if not spy.smo_rows or spy.kept is None:
            fail("no synthetic multi-object row was drawn, or none in a kept batch")
        if k != scanned_launches(n_iter):
            fail(f"K1/K2 launched {k} times in {n_iter} steps with synthetic multi-object rows")
        if len(losses) != n_iter or not all(np.isfinite(x) for x in losses):
            fail("a synthetic multi-object training metric is missing or not finite")
        rows, covered, bad, blind = smo_occlusion(torch, asm, spy.kept)
        log(f"synthetic multi-object batch: {rows} composited rows; matches of the object "
            f"behind covered by the front object {covered}, of them valid {bad} (0 expected); "
            f"valid blind entries {blind} (0 expected)")
        if bad or blind:
            fail("a synthetic multi-object row keeps an occluded match or a blind entry")
        compare_kernel_and_plain_steps(torch, cfg, spy.kept[1], "synthetic multi-object step")
        out["smo"] = {"launches": k, "kept": spy.kept, "run_s": run_s}

        # (c) the per-pair route through the driver, with the same mix
        cfg_pp = driver_config(tmp, "per_pair", compute_test_loss=False, save_rate=1000,
                               use_matrix_loss=False, data_type_probabilities=SHOES_MIX)
        trainer = train_mod.DenseCorrespondenceTraining(cfg_pp, ds, device=dev)
        ph.forward_launches = ph.backward_launches = 0
        t = time.perf_counter()
        with _AssemblySpy(train_mod, "assemble_batch") as spy_pp:
            folder_pp = trainer.run()
        torch.cuda.synchronize(dev)
        run_pp = time.perf_counter() - t
        k = (ph.forward_launches, ph.backward_launches)
        losses = trainer._logging_dict["train"]["loss"]
        log(f"per-pair driver: route {trainer.route!r}, {n_iter} iterations in {run_pp:.2f} s, "
            f"{spy_pp.smo_rows} of {spy_pp.rows} rows of type 4; launches K1 {k[0]}, K2 {k[1]}; "
            "losses " + ", ".join(f"{x:.5g}" for x in losses))
        if trainer.route != train_mod.ROUTE_CACHED_HOST_SAMPLER or k != (0, 0):
            fail(f"the per-pair driver took the {trainer.route!r} route or launched K1/K2")
        if len(losses) != n_iter or not all(np.isfinite(x) for x in losses):
            fail("a per-pair driver metric is missing or not finite")
        _, out["k3_err"] = check_reload(torch, np, bm, dev, folder_pp, trainer,
                                        ds.scenes["scene_000"], "per-pair driver")
        out["per_pair_run_s"] = run_pp
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (d) the test loss over phase 8's dataset, from its model folder
    dcn = DenseCorrespondenceNetwork.from_model_folder(folder, device=dev)
    t = time.perf_counter()
    values = DenseCorrespondenceEvaluation.compute_loss_on_dataset(
        dcn, dcn.load_training_dataset(), TRAINING_CONFIG["loss_function"])
    out["loss_on_dataset_s"] = time.perf_counter() - t
    log(f"compute_loss_on_dataset on phase 8's folder (50 batches of 1 pair): loss, match "
        f"loss, non-match loss {list(values)} in {out['loss_on_dataset_s']:.2f} s")
    if len(values) != 3 or not all(np.isfinite(v) for v in values):
        fail("compute_loss_on_dataset did not give three finite numbers")
    return out


def time_per_pair_and_smo(torch, pp, smo):
    """The per-pair step at full width (whole, then split between CUDA
    events into assembly, forward, the loss, the backward and Adam; and the
    loss alone on fixed predictions, forward and backward) and a synthetic
    multi-object batch's assembly on each route."""
    from pdc_tpu_torch.data import assembler as asm

    state, step, gen, batch = pp["state"], pp["step"], pp["gen"], pp["batch"]
    module, Wt = state.module, step.image_width

    def events(n):
        return [torch.cuda.Event(enable_timing=True) for _ in range(n)]

    whole = []
    for _ in range(TRAIN_TIMED_STEPS):
        b = batch()
        e = events(2)
        e[0].record()
        step(state, b, gen)
        e[1].record()
        torch.cuda.synchronize()
        whole.append(e[0].elapsed_time(e[1]))
    parts = {k: [] for k in ("assembly", "forward", "loss", "backward", "optimizer")}
    for _ in range(TRAIN_TIMED_STEPS):
        b = batch()
        e = events(6)
        e[0].record()
        img_a, img_b, idx = step.assemble(state, b, gen)
        e[1].record()
        state.optimizer.zero_grad(set_to_none=True)
        module.train()
        o = module(torch.cat([img_a, img_b]).permute(0, 3, 1, 2).contiguous())
        e[2].record()
        B = img_a.shape[0]
        pred = o.permute(0, 2, 3, 1).reshape(2 * B, -1, o.shape[1])
        loss = step.compose(pred[:B], pred[B:], idx, step.loss_cfg, Wt).loss.mean()
        e[3].record()
        loss.backward()
        e[4].record()
        state.optimizer.step()
        e[5].record()
        torch.cuda.synchronize()
        for j, k in enumerate(parts):
            parts[k].append(e[j].elapsed_time(e[j + 1]))
    fixed = pred.detach()
    alone = {"loss forward": [], "loss backward": []}
    for _ in range(TRAIN_TIMED_STEPS):
        pa = fixed[:B].clone().requires_grad_()
        pb = fixed[B:].clone().requires_grad_()
        e = events(3)
        e[0].record()
        loss = step.compose(pa, pb, idx, step.loss_cfg, Wt).loss.sum()
        e[1].record()
        loss.backward()
        e[2].record()
        torch.cuda.synchronize()
        alone["loss forward"].append(e[0].elapsed_time(e[1]))
        alone["loss backward"].append(e[1].elapsed_time(e[2]))
    rows = idx.masked_nm_a.numel() + idx.background_nm_a.numel()

    batch_smo, _, cfg_m = smo["kept"]
    all_smo = dict(batch_smo, match_type=torch.full_like(batch_smo["match_type"], 4))
    cfg_p = dataclasses.replace(cfg_m, use_matrix_loss=False)
    assembly = {}
    for name, fn, cfg in (("matrix", asm.assemble_batch_matrix, cfg_m),
                          ("per-pair", asm.assemble_batch, cfg_p)):
        for what, b in (("as drawn", batch_smo), ("every row type 4", all_smo)):
            assembly[(name, what)] = time_cuda(torch, lambda: fn(b, cfg, gen, gen.device),
                                               iters=5, warmup=1)
    return {"step_ms": whole, "parts": {k: sum(v) / len(v) for k, v in parts.items()},
            "alone": {k: sum(v) / len(v) for k, v in alone.items()}, "rows": rows,
            "smo_types": batch_smo["match_type"].tolist(), "assembly": assembly}


# the apps phase: sizes of its checks
APPS_QUERIES, APPS_HEAT_PIXELS, APPS_EXPORT_B = 16, 8, 8
N_APPS_FRAMES = DATASET_RECORD["synthetic"]["num_frames"]  # the frames of one scene
HEAT_VARIANCE = 0.25  # configs/heatmap_vis.yaml's kernel_variance
HEAT_TOL = 1e-6  # the heatmap against exp(-nd / variance) in float64
MESH_TOL = 1e-5  # mesh descriptors on the card against the CPU, same descriptor images
EXPORT_RELOAD_TOL = 1e-6
# annotation clicks (u, v), more than 25 px apart so that no reticle covers another
ANNOTATED_PAIRS = [("scene_000", 0, [(100, 120), (300, 200)], "scene_001", 3,
                    [(110, 130), (320, 210)]),
                   ("scene_001", 5, [(400, 300)], "scene_000", 7, [(200, 100)])]


def _events(torch, n):
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


def _decode_rgb(np, nl, path, height, width):
    out = np.empty((height, width, 3), np.uint8)
    nl.decode_batch([(path, nl.KIND_RGB8, out)], height, width, decoder="zlib")
    return out


def _spread(np, mask, n):
    """``n`` (v, u) object pixels of ``mask``, evenly spread."""
    obj = np.argwhere(mask > 0)
    return obj[np.linspace(0, len(obj) - 1, n).astype(int)]


def check_apps(torch, np, dev, bm, on_disk, tmp):
    """The phase "apps" on phase 8's model folder and scene tree, in the
    directory ``<tmp>/apps``: checks (a)-(g) of the module docstring.
    Returns the numbers the timings phase and the kernels line read."""
    import contextlib
    import io
    import shutil

    from pdc_tpu_torch import __main__ as cli
    from pdc_tpu_torch.apps import compute_descriptor_images as cdi
    from pdc_tpu_torch.apps import debug_visualization as dbg
    from pdc_tpu_torch.apps import export_serving as exp
    from pdc_tpu_torch.apps import make_descriptor_video as vid
    from pdc_tpu_torch.apps import mesh_descriptors as mesh
    from pdc_tpu_torch.apps.annotate_correspondences import (
        LABEL_COLORS,
        make_annotation_entry,
        save_annotations,
    )
    from pdc_tpu_torch.apps.live_heatmap_visualization import GraspPointStream, HeatmapEngine
    from pdc_tpu_torch.data import native_loader as nl
    from pdc_tpu_torch.data.dataset import SpartanDataset
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
    from pdc_tpu_torch.utils.yaml_io import load_yaml

    folder, composite = on_disk["folder"], on_disk["composite"]
    work = os.path.join(tmp, "apps")
    os.makedirs(work)
    out = {}
    dcn = DenseCorrespondenceNetwork.from_model_folder(folder, device=dev)
    ds = SpartanDataset(config=load_yaml(composite), data_dir=tmp,
                        config_dir=os.path.dirname(composite))
    scene = ds.get_scene("scene_000")
    n, Hs, Ws = scene.rgb.shape[:3]

    # (a) python -m pdc_tpu_torch descriptor-images, in this process
    buf, cwd = io.StringIO(), os.getcwd()
    os.chdir(work)  # it writes under ./descriptor_images_out
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["descriptor-images", "--model_folder", folder, "--config", composite,
                           "--data_dir", tmp, "--device", str(dev)])
    finally:
        os.chdir(cwd)
    net = os.path.basename(os.path.normpath(folder))
    n_files, desc_err, names_ok = 0, 0.0, True
    with torch.inference_mode():
        for name, s in ds.scenes.items():
            d = os.path.join(work, "descriptor_images_out", name, "descriptor_images", net)
            want = ["%06d_descriptor.npy" % s.frame_id(i) for i in range(s.num_frames)]
            names_ok &= sorted(os.listdir(d)) == want
            for i, f in enumerate(want):
                got = torch.from_numpy(np.load(os.path.join(d, f))).to(dev)
                ref = dcn.forward_on_img(s.rgb[i])
                desc_err = max(desc_err, float((got - ref).abs().max()))
                names_ok &= bool(torch.allclose(got, ref, atol=DESC_TOL, rtol=DESC_TOL))
                n_files += 1
    rec = DATASET_RECORD["synthetic"]
    log(f"apps (a): python -m pdc_tpu_torch descriptor-images -> {buf.getvalue().strip()!r}, "
        f"rc {rc}; {n_files} .npy files named by frame id, max|diff| to forward_on_img "
        f"{desc_err:.3g} (bar {DESC_TOL})")
    if rc != 0 or not names_ok or n_files != rec["num_scenes"] * rec["num_frames"]:
        fail("descriptor-images wrote other files or other descriptors than forward_on_img")
    timings = {}
    for _ in range(2):  # the second run is timed
        timings = {}
        cdi.compute_descriptor_images_for_scene(dcn, scene, os.path.join(work, "timed"), 8,
                                                timings)
    out["descriptor_images_ms"] = {k: 1e3 * v / n for k, v in timings.items()}

    # (b) the grasp stream: one K3 launch per frame
    with torch.inference_mode():
        res0 = dcn.forward_on_img(scene.rgb[0])
        own = _spread(np, scene.mask[0], APPS_QUERIES)  # (v, u)
        q = res0[torch.as_tensor(own[:, 0]), torch.as_tensor(own[:, 1])].contiguous()
    stream = GraspPointStream(dcn, q.cpu().numpy())
    bm.launches = 0
    picks = [stream.process_frame(f) for f in scene.rgb]
    launches = bm.launches
    worst_tie, dist_err, self_ok = 0.0, 0.0, True
    with torch.inference_mode():
        for f, (uv, dist) in enumerate(picks):
            res = dcn.forward_on_img(scene.rgb[f]).permute(2, 0, 1).reshape(1, D, -1).contiguous()
            pidx, pdist = bm.best_match_reference(res, q[None])
            d2 = bm.squared_distances(res.double(), q[None].double())[0]  # [Q, HW]
            idx = torch.as_tensor(uv[:, 1] * Ws + uv[:, 0], device=dev).long()[:, None]
            gap = (d2.gather(1, idx) - d2.gather(1, pidx[0].long()[:, None]))[:, 0]
            worst_tie = max(worst_tie, float(gap.abs().max()))
            dist_err = max(dist_err, float((torch.from_numpy(dist).to(dev) - pdist[0]).abs().max()))
            if f == 0:
                own_flat = torch.as_tensor(own[:, 0] * Ws + own[:, 1], device=dev)
                self_ok = bool((dist <= 1e-5).all()) and bool(
                    ((idx[:, 0] == own_flat) | (d2.gather(1, idx)[:, 0].sqrt() <= 1e-5)).all())
    log(f"apps (b): GraspPointStream, {APPS_QUERIES} descriptors at object pixels of frame 0, "
        f"{n} frames: K3 launches {launches} (1 per frame); picks against the plain best match: "
        f"largest float64 d2 gap {worst_tie:.3g} (near-tie bar {TIE_TOL_D2}); distances "
        f"max|diff| {dist_err:.3g} (bar 1e-5); frame 0 matches each query's own pixel or a tie "
        f"at distance <= 1e-5: {self_ok}")
    if launches != n or worst_tie > TIE_TOL_D2 or not dist_err <= 1e-5 or not self_ok:
        fail("the grasp stream disagrees with the plain best match or did not launch K3 once "
             "per frame")
    out.update(launches=launches, k3_err=dist_err)
    split = {"upload + normalise": [], "forward": [], "K3": [], "fetch": []}
    wall = []
    with torch.inference_mode():
        for f in scene.rgb:
            e = _events(torch, 5)
            t = time.perf_counter()
            e[0].record()
            x = stream.upload(f)
            e[1].record()
            res = stream.forward(x)
            e[2].record()
            uv, dist = stream.match(res)
            e[3].record()
            uv, dist = uv.cpu().numpy(), dist.cpu().numpy()
            e[4].record()
            wall.append(1e3 * (time.perf_counter() - t))
            torch.cuda.synchronize()
            for k, (a, b) in zip(split, ((0, 1), (1, 2), (2, 3), (3, 4))):
                split[k].append(e[a].elapsed_time(e[b]))
    out["stream"] = {"wall_ms": sum(wall) / len(wall),
                     "split": {k: sum(v) / len(v) for k, v in split.items()}}

    # (c) the heatmap engine on one pair, 8 query pixels
    eng = HeatmapEngine([dcn], variance=HEAT_VARIANCE)
    eng.set_images(scene.rgb[0], scene.rgb[3])
    res_a, res_b = eng._res_a[0].double(), eng._res_b[0].double()
    heat_err, uv_gap, diff_err = 0.0, 0.0, 0.0
    for v, u in _spread(np, scene.mask[0], APPS_HEAT_PIXELS):
        (uv, diff, heat), = eng.find_best_match(int(u), int(v))
        nd = torch.sqrt(((res_b - res_a[v, u]) ** 2).sum(-1))  # float64 [H, W]
        flat = nd.reshape(-1)
        chosen = flat[int(uv[1]) * Ws + int(uv[0])]
        uv_gap = max(uv_gap, float(chosen ** 2 - flat.min() ** 2))
        diff_err = max(diff_err, abs(diff - float(chosen)))
        heat_err = max(heat_err, float((torch.from_numpy(heat).to(dev).double()
                                        - torch.exp(-nd / HEAT_VARIANCE)).abs().max()))
        if heat.shape != (Hs, Ws):
            fail(f"heatmap of shape {heat.shape}")
    log(f"apps (c): HeatmapEngine, {APPS_HEAT_PIXELS} query pixels: best uv against the float64 "
        f"argmin, largest d2 gap {uv_gap:.3g} (near-tie bar {TIE_TOL_D2}); distance max|diff| "
        f"{diff_err:.3g}; [{Hs}, {Ws}] heatmap max|diff| to exp(-nd / {HEAT_VARIANCE}) in "
        f"float64 {heat_err:.3g} (bar {HEAT_TOL})")
    if uv_gap > TIE_TOL_D2 or not heat_err <= HEAT_TOL or not diff_err <= 1e-5:
        fail("the heatmap engine disagrees with float64")
    event_ms = []
    for _ in range(10):
        t = time.perf_counter()
        eng.find_best_match(Ws // 2, Hs // 2)
        event_ms.append(1e3 * (time.perf_counter() - t))
    out["heat_event_ms"] = sorted(event_ms)[len(event_ms) // 2]

    # (d) python -m pdc_tpu_torch export-serving, then the artifact on the card
    path = os.path.join(work, f"net_b{APPS_EXPORT_B}.pt2")
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["export-serving", "--model_folder", folder, "--output", path,
                       "--batch_size", str(APPS_EXPORT_B), "--platform", dev.type])
    out["export_s"] = time.perf_counter() - t
    x = torch.as_tensor(scene.rgb[:APPS_EXPORT_B], device=dev)
    with torch.inference_mode():
        program = exp.load_exported(path).module()
        first = program(x)
        second = exp.load_exported(path).module()(x)
        ref = torch.stack([dcn.forward_on_img(f) for f in scene.rgb[:APPS_EXPORT_B]])
    exp_err = float((first - ref).abs().max())
    reload_err = float((second - first).abs().max())
    log(f"apps (d): python -m pdc_tpu_torch export-serving -> {buf.getvalue().strip()!r}, rc "
        f"{rc}, {os.path.getsize(path)} bytes in {out['export_s']:.2f} s; loaded program on "
        f"{APPS_EXPORT_B} frames: {tuple(first.shape)} on {first.device}, max|diff| to "
        f"forward_on_img {exp_err:.3g} (bar {DESC_TOL}); a second load max|diff| {reload_err:.3g} "
        f"(bar {EXPORT_RELOAD_TOL})")
    if (rc != 0 or first.shape != ref.shape
            or not torch.allclose(first, ref, atol=DESC_TOL, rtol=DESC_TOL)
            or not reload_err <= EXPORT_RELOAD_TOL):
        fail("the exported program disagrees with the live network")
    with torch.inference_mode():
        xn = dcn.normalize_on_device(x).permute(0, 3, 1, 2).contiguous()
        out["program_ms"] = time_cuda(torch, lambda: program(x), iters=10)
        out["module_ms"] = time_cuda(torch, lambda: dcn.module(xn), iters=10)
        out["forward_on_images_ms"] = time_cuda(torch, lambda: dcn.forward_on_images(x),
                                                iters=10)
    out["export_bytes"] = os.path.getsize(path)
    del program

    # (e) the descriptor video's frames
    has_ffmpeg = shutil.which("ffmpeg") is not None
    video = vid.run(folder, ds, scene_names=["scene_000"], output_dir=os.path.join(work, "video"),
                    masked=True, device=dev)["scene_000"]
    frames_dir = os.path.join(work, "video", "scene_000", "video_images")
    try:
        stats = dcn.descriptor_image_stats
    except (FileNotFoundError, OSError, KeyError):
        stats = None
    with torch.inference_mode():
        res_all = torch.cat([dcn.forward_on_images(scene.rgb[s:s + 8])
                             for s in range(0, n, 8)]).cpu().numpy()
    video_ok = video["frames"] == n and len(os.listdir(frames_dir)) == 3 * n
    for idx in range(n):
        want = vid.descriptor_rgb(res_all[idx], stats)
        m = scene.mask[idx] > 0
        rgb = _decode_rgb(np, nl, os.path.join(frames_dir, "%06d_rgb.png" % idx), Hs, Ws)
        res_png = _decode_rgb(np, nl, os.path.join(frames_dir, "%06d_res.png" % idx), Hs, Ws)
        masked = _decode_rgb(np, nl, os.path.join(frames_dir, "%06d_res_masked.png" % idx), Hs,
                             Ws)
        video_ok &= (np.array_equal(rgb, scene.rgb[idx]) and np.array_equal(res_png, want)
                     and np.array_equal(masked, want * m[..., None]) and not masked[~m].any())
    norm = "descriptor_statistics.yaml" if stats else "per-image"
    log(f"apps (e): descriptor video of scene_000 ({norm} normalisation): {video['frames']} frames x 3 PNGs decoded equal to the forward's "
        f"uint8 and zero off the mask: {video_ok}; ffmpeg installed: {has_ffmpeg}, videos "
        f"written: {len(video['videos'])}")
    if not video_ok:
        fail("the descriptor video's frames differ from what the forward gives")

    # (f) mesh descriptors on the scene's fusion mesh, on the card and on the CPU
    verts, _ = on_disk["scenes"]["scene_000"].fusion_mesh()
    with torch.inference_mode():
        images = [dcn.forward_on_img(f) for f in scene.rgb]
        on_card = mesh.accumulate_mesh_descriptors(scene, verts, lambda i: images[i], device=dev)
        on_cpu = mesh.accumulate_mesh_descriptors(scene, verts, lambda i: images[i].cpu(),
                                                  device="cpu")
    obs_equal = np.array_equal(on_card["num_observations"], on_cpu["num_observations"])
    mesh_err = float(np.abs(on_card["descriptors"] - on_cpu["descriptors"]).max())
    seen = float((on_card["num_observations"] > 0).mean())
    log(f"apps (f): mesh descriptors of {len(verts)} fusion-mesh vertices over {n} frames: "
        f"num_observations equal to the CPU's: {obs_equal}; descriptors max|diff| {mesh_err:.3g} "
        f"(bar {MESH_TOL}); share of vertices seen {seen:.4f}, mean observations "
        f"{float(on_card['num_observations'].mean()):.2f}")
    if not obs_equal or not mesh_err <= MESH_TOL or not 0 < seen <= 1:
        fail("mesh descriptors on the card differ from the CPU's")
    for rep in range(2):  # the second run is timed
        torch.cuda.synchronize()
        t = time.perf_counter()
        mesh.compute_mesh_descriptors(dcn, scene, verts)
        out["mesh_ms"] = 1e3 * (time.perf_counter() - t) / n

    # (g) annotation replay and the assembler's debug panels
    anns = [make_annotation_entry(*a) for a in ANNOTATED_PAIRS]
    ann_file = os.path.join(work, "new_annotated_pairs.yaml")
    save_annotations(anns, ann_file)
    pngs = dbg.visualize_saved_correspondences(ds, ann_file, output_dir=os.path.join(work, "view"))
    try:
        import cv2  # noqa: F401
        with_cv2 = True
    except ImportError:
        with_cv2 = False
    colours_ok = len(pngs) == 2 * len(anns)
    for j, ann in enumerate(anns):
        for k, side in enumerate(("image_a", "image_b")):
            img = _decode_rgb(np, nl, pngs[2 * j + k], Hs, Ws)
            for i, px in enumerate(ann[side]["pixels"]):
                u, v, colour = px["u"], px["v"], LABEL_COLORS[i]
                colours_ok &= tuple(img[v, u + 10]) == colour  # on the reticle's ring
                if not with_cv2:  # the numpy cross covers the clicked pixel too
                    colours_ok &= tuple(img[v, u]) == colour
    try:
        import matplotlib  # noqa: F401
        panels = dbg.debug_batch_panels(ds, 1, os.path.join(work, "panels"), device=dev)
        panel_case = (f"matplotlib imports: {len(panels[0][1])} debug panels of type "
                      f"{panels[0][0]}")
        panels_ok = len(panels[0][1]) == 5
    except ImportError:
        try:
            dbg.debug_batch_panels(ds, 1, os.path.join(work, "panels"), device=dev)
            panels_ok, panel_case = False, "no matplotlib, and debug_batch_panels did not raise"
        except ImportError as e:
            panels_ok = "matplotlib" in str(e)
            panel_case = f"no matplotlib: debug_batch_panels raised ImportError {str(e)!r}"
    log(f"apps (g): visualize_saved_correspondences, {len(anns)} pairs -> {len(pngs)} PNGs, "
        f"each reticle's colour at its clicked pixel's ring{' and centre' if not with_cv2 else ''} "
        f"({'cv2' if with_cv2 else 'numpy'} reticles): {colours_ok}; {panel_case}")
    if not colours_ok or not panels_ok:
        fail("the annotation replay or the debug panels failed")
    return out


# -- model variants and int8 -------------------------------------------------------

# the int8 checks: every conv shape of these networks at 640x480, B=1 and B=8,
# then random shapes with M <= 16 and K, N not multiples of 8 (B, C, H, W, O,
# k, stride, padding, dilation)
INT8_RANDOM_SHAPES = [(1, 5, 3, 4, 7, 3, 1, 1, 1), (1, 13, 2, 3, 3, 1, 1, 0, 1),
                      (3, 9, 2, 2, 17, 3, 2, 1, 1), (1, 11, 5, 4, 5, 3, 1, 2, 2),
                      (1, 3, 4, 4, 64, 7, 2, 3, 1), (2, 21, 3, 3, 19, 1, 1, 0, 1)]
# dilated_s2b against the dilated model (tests/test_models.py:240-280's bars),
# relative to the largest magnitude (the random ResNet-101-8s's outputs are
# far from 1): outputs 2e-5, running statistics 1e-5
S2B_OUT_TOL, S2B_STATS_TOL = 2e-5, 1e-5
# int8 descriptors against fp32 on phase 8's folder (6 iterations from random
# weights): the least cosine over 4 frames, and the share of picks that are the
# fp32 pick or a near-tie of it under the fp32 distances (within 0.5% of the
# squared spread of the descriptor image), as tests/test_quantized.py:41-75
# counts them. tools/torch_int8_witness.py reads this folder's weights with
# both packages: the int8 semantics give a cosine of about 0.98 and 13-16 of
# 16 picks here, a quantizer that truncates 0.87 and 1-5; the bars lie between.
# Phase 8's training is not bit-reproducible on the card, so the share is read
# over INT8_QUERIES object pixels: over 16 it ranged 11-15 and fell below 10
INT8_COS_MIN, INT8_NEAR_MIN = 0.97, 10 / 16
INT8_NEAR_TIE, INT8_QUERIES = 5e-3, 256
VARIANT_STEPS = {"Resnet101_8s": (5, 3), "Unet": (2, 2)}  # (counted steps, timed steps)


def conv_shapes(torch, module, x):
    """Every distinct (C, H, W, O, k, stride, padding, dilation) of the
    module's convolutions on ``x`` (one eval forward with hooks)."""
    shapes, handles = {}, []
    for m in module.modules():
        if isinstance(m, torch.nn.Conv2d):
            def hook(mod, args):
                _, c, h, w = args[0].shape
                shapes[(c, h, w, mod.out_channels, mod.kernel_size[0], mod.stride[0],
                        mod.padding[0], mod.dilation[0])] = None
            handles.append(m.register_forward_pre_hook(hook))
    try:
        with torch.inference_mode():
            module(x)
    finally:
        for h in handles:
            h.remove()
    return list(shapes)


def check_int8_products(torch, np, dev):
    """(a): the _int_mm route against the float64 plain version, and its
    time against cuDNN's fp32 convolution of the same shape."""
    from pdc_tpu_torch.models.resnet import ResNet34_8s
    from pdc_tpu_torch.models.unet import UNet
    from pdc_tpu_torch.ops import int8_conv as ic

    g = torch.Generator(device=dev).manual_seed(SEED)
    x1 = torch.randn(1, 3, H, W, device=dev, generator=g)
    cases = []
    for name, module in (("ResNet-34-8s", ResNet34_8s(D)), ("UNet", UNet(D))):
        module = module.to(dev).eval()
        for shape in conv_shapes(torch, module, x1):
            cases += [(name, B) + shape for B in (1, 8)]
        del module
    cases += [("random",) + s for s in INT8_RANDOM_SHAPES]
    rows, bad = [], []
    for name, B, C, h, w, O, k, s, p, d in cases:
        x = torch.randint(-127, 128, (B, C, h, w), device=dev, dtype=torch.int8, generator=g)
        wq = torch.randint(-127, 128, (O, C, k, k), device=dev, dtype=torch.int8, generator=g)
        before = ic.launches
        got = ic.int8_conv2d(x, wq, s, p, d)
        want = ic.int8_conv2d_reference(x, wq, s, p, d)
        if ic.launches != before + 1 or got.dtype != torch.int32 or not torch.equal(got, want):
            bad.append((name, B, C, h, w, O, k, s, p, d))
        row = {"net": name, "B": B, "C": C, "H": h, "W": w, "O": O, "k": k, "stride": s,
               "dilation": d, "K": C * k * k, "M": int(got.shape[0] * got.shape[2] * got.shape[3])}
        if name != "random":
            xf, wf = x.float(), wq.float()
            row["int8_ms"] = time_cuda(torch, lambda: ic.int8_conv2d(x, wq, s, p, d), iters=5)
            row["fp32_ms"] = time_cuda(torch, lambda: torch.nn.functional.conv2d(
                xf, wf, None, s, p, d), iters=5)
            del xf, wf
        rows.append(row)
        del x, wq, got, want
    torch.cuda.empty_cache()
    log(f"variants (a): int8 conv, torch._int_mm route against the float64 plain version on "
        f"{len(cases)} shapes (every conv of ResNet-34-8s and of the UNet at {W}x{H}, B=1 and "
        f"B=8, and {len(INT8_RANDOM_SHAPES)} random ones with M <= 16 or K, N not multiples of "
        f"8): int32 bit for bit on {len(cases) - len(bad)}, differing on {bad}")
    if bad:
        fail("the _int_mm route of the int8 convolution differs from its plain version")
    for r in rows:
        if "int8_ms" in r:
            log(f"  int8 conv {r['net']} B={r['B']} C={r['C']} {r['H']}x{r['W']} -> O={r['O']} "
                f"{r['k']}x{r['k']}/{r['stride']} dil {r['dilation']} (M={r['M']}, K={r['K']}): "
                f"patches + _int_mm {r['int8_ms']:.3f} ms, cuDNN fp32 {r['fp32_ms']:.3f} ms, "
                f"{r['int8_ms'] / r['fp32_ms']:.2f} x")


def train_variant(torch, np, dev, ph, frames_t, backbone, steps, timed):
    """(c) for one backbone: make_train_step with TRAINING_CONFIG's values,
    one warm-up step, ``steps`` counted ones, ``timed`` ones between CUDA
    events and their split as phase 6 splits it. Returns K1's and K2's
    launches."""
    import copy

    from pdc_tpu_torch.data.assembler import AssemblerConfig
    from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
    from pdc_tpu_torch.training.train import build_loss_fn, make_train_step, pick_assembly

    tc = copy.deepcopy(TRAINING_CONFIG)
    tc["dense_correspondence_network"]["backbone"] = backbone
    loss_cfg = LossConfig.from_dict(tc["loss_function"])
    asm_cfg = AssemblerConfig.from_training_config(tc)
    Bt = tc["training"]["batch_size"]
    state = new_train_state(torch, tc)
    initial = {k: v.detach().clone() for k, v in state.module.named_parameters()}
    step = make_train_step(tc, loss_cfg, asm_cfg, W)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)

    def batch():
        return pair_batch(torch, frames_t, *draw_pairs(np, rng, Bt, N_FRAMES))

    step(state, batch(), gen)
    torch.cuda.synchronize()
    ph.forward_launches = ph.backward_launches = 0
    history = [{k: float(v) for k, v in step(state, batch(), gen).items()} for _ in range(steps)]
    torch.cuda.synchronize()
    launches = (ph.forward_launches, ph.backward_launches)
    still = [k for k, v in state.module.named_parameters()
             if v.dim() > 1 and torch.equal(v.detach(), initial[k])]
    finite = all(np.isfinite(v) for m in history for v in m.values())
    step_ms = []
    for _ in range(timed):
        e = _events(torch, 2)
        b = batch()
        e[0].record()
        step(state, b, gen)
        e[1].record()
        torch.cuda.synchronize()
        step_ms.append(e[0].elapsed_time(e[1]))
    parts = {"assembly": [], "forward+backward": [], "optimizer": []}
    loss_fn = build_loss_fn(state.module, loss_cfg, W, pick_assembly(asm_cfg)[1])
    for _ in range(timed):
        e = _events(torch, 4)
        b = batch()
        e[0].record()
        assembled = step.assemble(state, b, gen)
        e[1].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss, _ = loss_fn(*assembled)
        loss.backward()
        e[2].record()
        state.optimizer.step()
        e[3].record()
        torch.cuda.synchronize()
        for k, (a, c) in zip(parts, ((0, 1), (1, 2), (2, 3))):
            parts[k].append(e[a].elapsed_time(e[c]))
    name = backbone.get("resnet_name", backbone["model_class"])
    mean = sum(step_ms) / len(step_ms)
    split = {k: sum(v) / len(v) for k, v in parts.items()}
    log(f"variants (c): {name} D={D} {W}x{H} B={Bt}, {steps} steps after 1 warm-up through "
        f"make_train_step: losses [{', '.join(f'{m['loss']:.6g}' for m in history)}], all "
        f"metrics finite: {finite}; weight tensors unchanged: {len(still)}; launches K1 "
        f"{launches[0]}, K2 {launches[1]} (2 per step expected); step {mean:.3f} ms "
        f"[{', '.join(f'{x:.3f}' for x in step_ms)}] (CUDA events, {timed} steps), "
        f"{1e3 * Bt / mean:.2f} pairs/s; split (separate steps): " + ", ".join(
            f"{k} {v:.3f} ms ({100 * v / sum(split.values()):.1f}%)" for k, v in split.items()))
    if not finite or still or launches != (2 * steps, 2 * steps):
        fail(f"{name} training: finite {finite}, unchanged {still[:3]}, launches {launches}")
    del state, step, loss_fn, initial
    torch.cuda.empty_cache()
    return launches


def serve_clone(torch, np, dev, bm, clone, frames, max_batch, label):
    """(e): a DescriptorServer on ``clone`` answering concurrent descriptors
    and best_match requests; returns K3's launches and the worst errors."""
    from pdc_tpu_torch.apps.serve import DescriptorClient, DescriptorServer

    n_req = N_CLIENTS * REQUESTS_PER_CLIENT
    with torch.inference_mode():
        want = [clone.forward_on_img(f) for f in frames]
    plan = []
    for r in range(n_req):
        f = r % len(frames)
        if r % 2:
            q = want[(f + 1) % len(frames)].reshape(-1, D)[
                torch.as_tensor(np.random.default_rng(r).integers(0, H * W, SERVE_QUERIES),
                                device=dev)]
            plan.append((f, q.cpu().numpy()))
        else:
            plan.append((f, None))
    server = DescriptorServer(clone, host="127.0.0.1", port=0, max_batch=max_batch,
                              max_wait_ms=20.0)
    results, errors = [None] * n_req, []
    try:
        server.warmup()
        server.start()
        host, port = server.address
        barrier = threading.Barrier(N_CLIENTS)

        def client(c):
            try:
                with DescriptorClient(host, port, timeout=60.0) as cl:
                    barrier.wait(timeout=60.0)
                    for r in range(c, n_req, N_CLIENTS):
                        f, q = plan[r]
                        results[r] = (cl.descriptors(frames[f]) if q is None
                                      else cl.best_match(frames[f], q))
            except Exception as e:
                errors.append(f"client {c}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(N_CLIENTS)]
        before = dict(server.stats)
        bm.launches = 0
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        launches = bm.launches
        delta = {k: server.stats[k] - before[k] for k in before}
    finally:
        server.shutdown()
    if errors or any(r is None for r in results):
        fail(f"{label} server: {errors or 'a request got no answer'}")
    desc_err, bad_total, dist_err = 0.0, 0, 0.0
    for r, (f, q) in enumerate(plan):
        if q is None:
            got = torch.from_numpy(np.array(results[r])).to(dev)
            desc_err = max(desc_err, float((got - want[f]).abs().max()))
            if not torch.allclose(got, want[f], atol=DESC_TOL, rtol=DESC_TOL):
                fail(f"{label} server: request {r}'s descriptors differ from forward_on_img")
        else:
            uv, dist = results[r]
            res = want[f].permute(2, 0, 1).reshape(1, D, H * W).contiguous()
            idx = torch.from_numpy(uv[:, 1] * W + uv[:, 0]).to(dev)[None]
            bad, err = check_matches(torch, bm, res, torch.from_numpy(q).to(dev)[None], idx,
                                     torch.from_numpy(np.array(dist)).to(dev)[None])
            bad_total, dist_err = bad_total + bad, max(dist_err, err)
    log(f"variants (e): {label}: {n_req} requests from {N_CLIENTS} clients (max_batch "
        f"{max_batch}), stats {delta}; descriptors max|diff| to the clone's forward_on_img "
        f"{desc_err:.3g} (bar {DESC_TOL}); best_match bad_idx {bad_total}, dist_err "
        f"{dist_err:.3g} vs float64 on that image; K3 launches {launches}")
    if bad_total or not dist_err <= DIST_TOL or not launches > 0 \
            or launches != delta["match_dispatches"]:
        fail(f"{label} server: best matches wrong, or K3 launched {launches} times for "
             f"{delta['match_dispatches']} dispatches with queries")
    return launches, dist_err


def check_variants_and_int8(torch, np, dev, bm, ph, frames_t, on_disk, tmp):
    """The phase "model variants and int8": checks (a)-(g) of the module
    docstring. Returns the numbers the kernels line reads."""
    import contextlib
    import copy
    import io

    from pdc_tpu_torch import __main__ as cli
    from pdc_tpu_torch.apps import export_serving as exp
    from pdc_tpu_torch.apps import first_frames
    from pdc_tpu_torch.apps.live_heatmap_visualization import GraspPointStream
    from pdc_tpu_torch.data.dataset import SpartanDataset
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
    from pdc_tpu_torch.models.resnet import int8_convs
    from pdc_tpu_torch.ops import int8_conv as ic
    from pdc_tpu_torch.utils.yaml_io import load_yaml

    out = {}
    # (a) the integer product
    check_int8_products(torch, np, dev)

    # (b) ResNet-101-8s serves; dilated_s2b equals the dilated model
    cfg = {"descriptor_dimension": D, "image_width": W, "image_height": H,
           "backbone": {"model_class": "Resnet", "resnet_name": "Resnet101_8s"}}
    frames = np.random.default_rng(SEED + 13).integers(0, 256, (8, H, W, 3), dtype=np.uint8)
    gen = torch.Generator().manual_seed(SEED)
    r101 = DenseCorrespondenceNetwork.from_config(cfg, generator=gen, device=dev)
    r34 = DenseCorrespondenceNetwork.from_config(dict(cfg, backbone=TRAINING_CONFIG[
        "dense_correspondence_network"]["backbone"]), generator=gen, device=dev)
    unet = DenseCorrespondenceNetwork.from_config(dict(cfg, backbone={"model_class": "Unet"}),
                                                  generator=gen, device=dev)
    fwd_ms = {}
    with torch.inference_mode():
        one = r101.forward_on_img(frames[0])
        eight = r101.forward_on_images(frames)
        ok = (one.shape == (H, W, D) and eight.shape == (8, H, W, D)
              and bool(torch.isfinite(eight).all()))
        for name, net in (("ResNet-101-8s", r101), ("ResNet-34-8s", r34), ("UNet", unet)):
            for B in (1, 8):
                xb = net.normalize_on_device(frames[:B]).permute(0, 3, 1, 2).contiguous()
                fwd_ms[(name, B)] = time_cuda(torch, lambda: net.module(xb), iters=5)
    log("variants (b): ResNet-101-8s forward_on_img and forward_on_images at B=8 finite, of "
        f"shapes {tuple(one.shape)} and {tuple(eight.shape)}: {ok}; forward fp32 ms: " + ", ".join(
            f"{n} B={B} {ms:.3f} ({1e3 * B / ms:.1f} images/s)" for (n, B), ms in fwd_ms.items()))
    if not ok:
        fail("ResNet-101-8s did not serve finite descriptors")
    del r34, unet
    s2b = DenseCorrespondenceNetwork.from_config(dict(cfg, dilated_s2b=True), device=dev)
    s2b.module.load_state_dict(r101.module.state_dict())
    x2 = r101.normalize_on_device(frames[:2]).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        a, b = r101.module.eval()(x2), s2b.module.eval()(x2)
        eval_err = float((a - b).abs().max()) / float(a.abs().max())
        r101.module.train()
        s2b.module.train()
        a, b = r101.module(x2), s2b.module(x2)
        train_err = float((a - b).abs().max()) / float(a.abs().max())
        stats_err = 0.0
        for (name, ra), rb in zip(r101.module.named_buffers(), s2b.module.buffers()):
            if "running" in name:
                stats_err = max(stats_err, float((ra - rb).abs().max())
                                / max(1.0, float(ra.abs().max())))
        r101.module.eval()
        s2b.module.eval()
    log(f"variants (b): dilated_s2b ResNet-101-8s against the dilated model, same weights, "
        f"{W}x{H} B=2: eval max|diff| {eval_err:.3g} of the output's scale (bar {S2B_OUT_TOL}); "
        f"one train-mode forward: running statistics {stats_err:.3g} of their scale (bar "
        f"{S2B_STATS_TOL}), its output {train_err:.3g} of the scale (not a check: train-mode "
        f"BatchNorm's E[x^2] - E[x]^2 cancels in fp32)")
    if not eval_err <= S2B_OUT_TOL or not stats_err <= S2B_STATS_TOL:
        fail("dilated_s2b differs from the dilated model")
    del r101, s2b, a, b, x2, one, eight
    torch.cuda.empty_cache()

    # (c) training steps of ResNet-101-8s and of the UNet
    out["train"] = {}
    for name, backbone in (("Resnet101_8s", {"model_class": "Resnet",
                                             "resnet_name": "Resnet101_8s"}),
                           ("Unet", {"model_class": "Unet"})):
        steps, timed = VARIANT_STEPS[name]
        out["train"][name] = train_variant(torch, np, dev, ph, frames_t, backbone, steps, timed)

    # (d) int8 on phase 8's trained folder
    folder = on_disk["folder"]
    dcn = DenseCorrespondenceNetwork.from_model_folder(folder, device=dev)
    calib = first_frames(dcn.load_training_dataset(), 16)
    ds = SpartanDataset(config=load_yaml(on_disk["composite"]), data_dir=tmp,
                        config_dir=os.path.dirname(on_disk["composite"]))
    scene = ds.get_scene("scene_000")
    rgb = scene.rgb
    with torch.inference_mode():
        before = torch.stack([dcn.forward_on_img(f) for f in rgb[:4]])
    q_dyn = dcn.quantized()
    q_static = dcn.calibrate_quantization(calib)
    cos, exact, near, worst_gap = {}, {}, {}, {}
    with torch.inference_mode():
        after = torch.stack([dcn.forward_on_img(f) for f in rgb[:4]])
        ref_a, ref_b = dcn.forward_on_img(rgb[0]).double(), dcn.forward_on_img(rgb[3]).double()
        own = _spread(np, scene.mask[0], INT8_QUERIES)
        iv, iu = torch.as_tensor(own[:, 0]), torch.as_tensor(own[:, 1])
        spread = float((ref_b.reshape(-1, D).max(0).values - ref_b.reshape(-1, D).min(0).values)
                       .max())

        def d2(img_a, img_b):  # [Q, HW], 64 queries at a time
            return torch.cat([((img_b.reshape(1, -1, D) - img_a[iv[s], iu[s]][:, None]) ** 2)
                              .sum(-1) for s in torch.arange(INT8_QUERIES).split(64)])

        df = d2(ref_a, ref_b)
        for label, clone in (("int8", q_dyn), ("int8 static", q_static),
                             ("control (truncating)", q_dyn)):
            rounding = torch.round
            if label.startswith("control"):
                torch.round = torch.trunc  # what Int8Conv's quantizer calls
            try:
                c = [torch.nn.functional.cosine_similarity(
                    clone.forward_on_img(f).reshape(-1).double(),
                    dcn.forward_on_img(f).reshape(-1).double(), dim=0) for f in rgb[:4]]
                qa, qb = (clone.forward_on_img(rgb[0]).double(),
                          clone.forward_on_img(rgb[3]).double())
            finally:
                torch.round = rounding
            cos[label] = min(float(v) for v in c)
            dq = d2(qa, qb)
            bf, bq = df.argmin(1), dq.argmin(1)
            gap = df.gather(1, bq[:, None])[:, 0] - df.gather(1, bf[:, None])[:, 0]
            exact[label] = int((bf == bq).sum())
            worst_gap[label] = float(gap.max()) / spread ** 2
            near[label] = float((gap <= INT8_NEAR_TIE * spread ** 2).double().mean())
    unchanged = torch.equal(before, after)
    # the dynamic clone on the CPU (the float64 plain product): each Int8Conv
    # of the card's clone, fed the CPU forward's input of that layer, must
    # give the CPU's output bit for bit (the same float32 operations and an
    # exact integer product); whole-network outputs differ only where a
    # layer's input differs by an ulp and flips a rounding
    cpu, cpu_f = copy.deepcopy(q_dyn.module).cpu(), copy.deepcopy(dcn.module).cpu().eval()
    inputs = {}
    hooks = [c.register_forward_pre_hook(
        lambda m, a, n=n: inputs.__setitem__(n, a[0].detach().clone()))
        for n, c in int8_convs(cpu)]
    x0 = q_dyn.normalize_on_device(rgb[:1]).permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        out_cpu = cpu(x0.cpu())
        for h in hooks:
            h.remove()
        out_card = q_dyn.module(x0).cpu()
        cos_f = [float(torch.nn.functional.cosine_similarity(
            o.reshape(-1).double(), f.reshape(-1).double(), dim=0))
            for o, f in ((out_card, dcn.module(x0).cpu()), (out_cpu, cpu_f(x0.cpu())))]
        card_convs = dict(int8_convs(q_dyn.module))
        layers_differ = [n for n, c in int8_convs(cpu)
                         if not torch.equal(card_convs[n](inputs[n].to(dev)).cpu(),
                                            c(inputs[n]))]
    card_cpu_cos = float(torch.nn.functional.cosine_similarity(
        out_card.reshape(-1).double(), out_cpu.reshape(-1).double(), dim=0))
    log(f"variants (d): the dynamic int8 clone on the card against the same clone on the "
        f"CPU (float64 plain product), frame 0: each of the {len(inputs)} Int8Conv layers fed "
        f"the CPU's input gives the CPU's output bit for bit: {not layers_differ} (differing: "
        f"{layers_differ}); whole network cosine {card_cpu_cos:.6f}, max|diff| "
        f"{float((out_card - out_cpu).abs().max()):.3g}; cosine to the fp32 forward on the card "
        f"{cos_f[0]:.6f}, on the CPU {cos_f[1]:.6f}")
    if layers_differ:
        fail("an int8 layer on the card differs from the same layer on the CPU")
    del cpu, cpu_f, inputs
    log(f"variants (d): int8 clones of {os.path.basename(folder)} (ResNet-34-8s, phase 8), "
        f"static scales calibrated on the first {len(calib)} frames of its first scene: "
        f"least cosine to fp32 over 4 frames " + ", ".join(f"{k} {v:.6f}" for k, v in cos.items())
        + f" (bar > {INT8_COS_MIN}, the control below it); share of the best matches of "
        f"{INT8_QUERIES} object pixels of frame 0 in "
        f"frame 3 that are the fp32 pick or a near-tie of it (within {INT8_NEAR_TIE} of the "
        f"squared spread): " + ", ".join(f"{k} {v:.4f}" for k, v in near.items())
        + f" (bar: at least {INT8_NEAR_MIN}, the control less), the very same pixel: "
        + ", ".join(
            f"{k} {v}" for k, v in exact.items()) + "; the worst pick's fp32 d2 gap over the "
        "squared spread " + ", ".join(f"{k} {v:.3g}" for k, v in worst_gap.items())
        + f"; the float network's forward unchanged: {unchanged}")
    control = "control (truncating)"
    served = [k for k in cos if k != control]
    if (min(cos[k] for k in served) <= INT8_COS_MIN
            or min(near[k] for k in served) < INT8_NEAR_MIN or not unchanged):
        fail(f"the int8 clones disagree with fp32, or the float forward changed: least cosine "
             f"{cos} (bar > {INT8_COS_MIN}), near-tie share {near} (bar {INT8_NEAR_MIN}), "
             f"float forward unchanged {unchanged}")
    if cos[control] > INT8_COS_MIN or near[control] >= INT8_NEAR_MIN:
        fail(f"a truncating quantizer passes the int8 bars: they catch no broken quantization "
             f"(cosine {cos[control]}, near-tie share {near[control]})")
    int8_ms = {}
    with torch.inference_mode():
        for label, net in (("fp32", dcn), ("int8", q_dyn), ("int8 static", q_static)):
            for B in (1, 8):
                xb = net.normalize_on_device(rgb[:B]).permute(0, 3, 1, 2).contiguous()
                int8_ms[(label, B)] = time_cuda(torch, lambda: net.module(xb), iters=10)
    log("variants (d): ResNet-34-8s forward ms (CUDA events, 640x480): " + ", ".join(
        f"{k} B={B} {ms:.3f} ({1e3 * B / ms:.1f} images/s)" for (k, B), ms in int8_ms.items()))

    # (e) the server as serve --int8_static and serve --int8 start it
    k3_static, err_static = serve_clone(torch, np, dev, bm, q_static, rgb[:8], 8,
                                        "serve --int8_static")
    k3_dyn, err_dyn = serve_clone(torch, np, dev, bm, q_dyn, rgb[:8], 1,
                                  "serve --int8 (one-frame batches)")
    out["k3_server"] = k3_static + k3_dyn

    # (f) export-serving --int8_static at B=8
    path = os.path.join(tmp, f"net_int8_static_b{APPS_EXPORT_B}.pt2")
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["export-serving", "--model_folder", folder, "--output", path,
                       "--batch_size", str(APPS_EXPORT_B), "--platform", dev.type,
                       "--int8_static"])
    export_s = time.perf_counter() - t
    train_ds = dcn.load_training_dataset("train")
    train_ds.reset_seed(7)
    live = dcn.calibrate_quantization([train_ds.get_random_rgbd_mask_pose()[0]
                                       for _ in range(16)])
    x = torch.as_tensor(rgb[:APPS_EXPORT_B], device=dev)
    before_mm = ic.launches
    with torch.inference_mode():
        program = exp.load_exported(path).module()
        got = program(x)
        n_int_mm = ic.launches - before_mm
        want = live.forward_on_images(x)
        exp_err = float((got - want).abs().max())
        xn = live.normalize_on_device(x).permute(0, 3, 1, 2).contiguous()
        program_ms = time_cuda(torch, lambda: program(x), iters=5)
        live_ms = time_cuda(torch, lambda: live.module(xn), iters=5)
    log(f"variants (f): export-serving --int8_static -> {buf.getvalue().strip()!r}, rc {rc}, "
        f"{export_s:.2f} s; the loaded program on {APPS_EXPORT_B} frames max|diff| to the live "
        f"static clone's forward {exp_err:.3g} (bar {DESC_TOL}); _int_mm calls counted by the "
        f"wrapper while running the program: {n_int_mm} (the program calls _int_mm itself); "
        f"program {program_ms:.3f} ms against the live clone's {live_ms:.3f} ms")
    if rc != 0 or got.shape != want.shape or not torch.allclose(got, want, atol=DESC_TOL,
                                                                rtol=DESC_TOL):
        fail("the exported int8 program disagrees with the live static clone")
    del program, got, want

    # (g) the grasp stream on a quantized network
    with torch.inference_mode():
        res0 = q_static.forward_on_img(rgb[0])
        qd = res0[iv.to(dev), iu.to(dev)].contiguous()
    stream = GraspPointStream(q_static, qd.cpu().numpy())
    bm.launches = 0
    picks = [stream.process_frame(f) for f in rgb]
    k3_stream = bm.launches
    stream_err = 0.0
    with torch.inference_mode():
        for f, (uv, dist) in zip(rgb, picks):
            res = q_static.forward_on_img(f).permute(2, 0, 1).reshape(1, D, -1).contiguous()
            idx = torch.as_tensor(uv[:, 1] * W + uv[:, 0], device=dev)[None]
            bad, err = check_matches(torch, bm, res, qd[None], idx,
                                     torch.from_numpy(dist).to(dev)[None])
            stream_err = max(stream_err, err)
            if bad:
                fail("the int8 grasp stream's picks are not the best matches")
    log(f"variants (g): GraspPointStream on the static int8 clone, {APPS_QUERIES} descriptors, "
        f"{len(rgb)} frames: K3 launches {k3_stream} (1 per frame); picks the float64 best "
        f"match or a near-tie, distances within {stream_err:.3g}")
    if k3_stream != len(rgb) or not stream_err <= DIST_TOL:
        fail("the int8 grasp stream did not launch K3 once per frame")
    out.update(k3_stream=k3_stream, k3_err=max(err_static, err_dyn, stream_err))
    return out


# -- 14. compute dtype, remat and preprocessing ----------------------------------------------

# (a) ResNet-34-8s bf16 against fp32 on the same weights, relative to the fp32
# output's RMS and largest value; the port's CPU reading at 96x128 and 240x320
# (seeded weights, synthetic frames) is RMS 0.011-0.012, max 0.018-0.022
BF16_FWD_RMS, BF16_FWD_MAX, BF16_FWD_MIN_RMS = 0.03, 0.06, 1e-3
# (b) one bf16 step against one fp32 step, same batch and weights; the CPU reading
# (ResNet-34-8s, 96x128, B=2) is a loss 0.9% apart, gradient cosine 0.84 and
# relative L2 0.59 (bf16's own effect: the backward's roundings compound towards
# the stem)
BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_COS, BF16_STEP_GRAD_REL = 0.05, 0.6, 1.0
BF16_STEPS, BF16_TIMED_STEPS, BF16_DRIVER_ITERATIONS = 5, 3, 3
REMAT_TIMED_STEPS = 2
# (e) a TSDF-scale fusion mesh: 392,064 faces at the default object radius
PREP_FRAMES, PREP_CPU_POSES = 60, 4
PREP_MESH = {"plane_step": 0.004, "object_step": 0.002}
PREP_FACES = (350_000, 450_000)
# the preprocess masks' IoU with the scene's own (analytic) masks; the CPU
# reads 0.850-0.862 at 120x160 (4 and 60 poses) and 240x320 (4 poses)
PREP_IOU_MIN = 0.8


def _step_split(torch, state, step, loss_fn, batch, gen, timed):
    """Mean CUDA-event ms of ``timed`` whole steps, then of their parts
    (assembly, forward+backward, Adam) over ``timed`` separate steps."""
    step_ms = []
    for _ in range(timed):
        e, b = _events(torch, 2), batch()
        e[0].record()
        step(state, b, gen)
        e[1].record()
        torch.cuda.synchronize()
        step_ms.append(e[0].elapsed_time(e[1]))
    parts = {"assembly": [], "forward+backward": [], "optimizer": []}
    for _ in range(timed):
        e, b = _events(torch, 4), batch()
        e[0].record()
        assembled = step.assemble(state, b, gen)
        e[1].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss, _ = loss_fn(*assembled)
        loss.backward()
        e[2].record()
        state.optimizer.step()
        e[3].record()
        torch.cuda.synchronize()
        for k, (a, c) in zip(parts, ((0, 1), (1, 2), (2, 3))):
            parts[k].append(e[a].elapsed_time(e[c]))
    return sum(step_ms) / len(step_ms), {k: sum(v) / len(v) for k, v in parts.items()}


def _step_text(mean, split):
    return f"{mean:.3f} ms (" + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + ")"


def _grad_distance(torch, a, b):
    """(cosine, relative L2) of module ``a``'s gradients against ``b``'s."""
    ga = torch.cat([p.grad.flatten() for p in a.parameters()])
    gb = torch.cat([p.grad.flatten() for p in b.parameters()])
    cos = float(torch.nn.functional.cosine_similarity(ga, gb, dim=0))
    return cos, float((ga - gb).norm() / gb.norm())


def check_bf16_forward(torch, np, dev, frames_t):
    """(a): bf16 and fp32 ResNet-34-8s on the same seeded weights."""
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork

    cfg = {"descriptor_dimension": D, "image_width": W, "image_height": H,
           "backbone": TRAINING_CONFIG["dense_correspondence_network"]["backbone"]}
    nets = {dt: DenseCorrespondenceNetwork.from_config(
        cfg, generator=torch.Generator().manual_seed(SEED), device=dev, dtype=dt)
        for dt in (torch.float32, torch.bfloat16)}
    sd32, sd16 = (n.module.state_dict() for n in nets.values())
    if not all(torch.equal(sd32[k], sd16[k]) for k in sd32):
        fail("the bf16 and fp32 networks do not share their seeded weights")
    out = {}
    with torch.inference_mode():
        for B in (1, 8):
            x = nets[torch.float32].normalize_on_device(frames_t["rgb"][:B])
            x = x.permute(0, 3, 1, 2).contiguous()
            a = nets[torch.float32].module(x)
            b = nets[torch.bfloat16].module(x)
            d = b.float() - a
            rms = float(d.square().mean().sqrt() / a.square().mean().sqrt())
            mx = float(d.abs().max() / a.abs().max())
            ms = {str(dt).split(".")[1]: time_cuda(torch, lambda: n.module(x), iters=10)
                  for dt, n in nets.items()}
            out[B] = ms
            log(f"dtype (a): ResNet-34-8s {W}x{H} B={B}, bf16 output {b.dtype}, against fp32 "
                f"on the same weights: relative RMS {rms:.4g} (bar {BF16_FWD_RMS}, at least "
                f"{BF16_FWD_MIN_RMS}), max {mx:.4g} of the scale (bar {BF16_FWD_MAX}); forward "
                f"fp32 {ms['float32']:.3f} ms, bf16 {ms['bfloat16']:.3f} ms "
                f"({ms['float32'] / ms['bfloat16']:.2f} x)")
            if b.dtype != torch.bfloat16 or not (BF16_FWD_MIN_RMS <= rms <= BF16_FWD_RMS) \
                    or not mx <= BF16_FWD_MAX:
                fail("the bf16 forward is not bf16 or disagrees with fp32")
    del nets
    torch.cuda.empty_cache()
    return out


def check_bf16_training(torch, np, dev, ph, frames_t):
    """(b): make_train_step with compute_dtype bfloat16."""
    import copy

    from pdc_tpu_torch.data.assembler import AssemblerConfig
    from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
    from pdc_tpu_torch.training.train import build_loss_fn, make_train_step, pick_assembly

    tc16 = copy.deepcopy(TRAINING_CONFIG)
    tc16["dense_correspondence_network"]["compute_dtype"] = "bfloat16"
    loss_cfg = LossConfig.from_dict(tc16["loss_function"])
    asm_cfg = AssemblerConfig.from_training_config(tc16)
    Bt = tc16["training"]["batch_size"]
    rng = np.random.default_rng(SEED + 14)

    def batch():
        return pair_batch(torch, frames_t, *draw_pairs(np, rng, Bt, N_FRAMES))

    state = new_train_state(torch, tc16)
    if state.module.dtype != torch.bfloat16:
        fail("compute_dtype bfloat16 did not build a bf16 network")
    initial = {k: v.detach().clone() for k, v in state.module.named_parameters()}
    step = make_train_step(tc16, loss_cfg, asm_cfg, W)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batches = [batch() for _ in range(BF16_STEPS)]
    ph.forward_launches = ph.backward_launches = 0
    history = [{k: float(v) for k, v in step(state, b, gen).items()} for b in batches]
    torch.cuda.synchronize()
    launches = (ph.forward_launches, ph.backward_launches)
    finite = all(np.isfinite(v) for m in history for v in m.values())
    still = [k for k, v in state.module.named_parameters()
             if v.dim() > 1 and torch.equal(v.detach(), initial[k])]
    fp32 = all(p.dtype == torch.float32 for p in state.module.parameters()) and all(
        t.dtype == torch.float32 for s in state.optimizer.state.values()
        for t in (s["exp_avg"], s["exp_avg_sq"])) and all(
        b.dtype != torch.bfloat16 for b in state.module.buffers())
    log(f"dtype (b): ResNet-34-8s bf16 {W}x{H} B={Bt}, {BF16_STEPS} steps through "
        f"make_train_step: losses [{', '.join(f'{m['loss']:.6g}' for m in history)}], all "
        f"metrics finite {finite}; weight tensors unchanged {len(still)}; parameters, "
        f"buffers and Adam state fp32: {fp32}; launches K1 {launches[0]}, K2 {launches[1]} "
        f"(2 per step expected)")
    if not finite or still or not fp32 or launches != (2 * BF16_STEPS, 2 * BF16_STEPS):
        fail("the bf16 train step failed its checks")

    # one bf16 step and one fp32 step on the same batch and weights
    s16, s32 = new_train_state(torch, tc16), new_train_state(torch, TRAINING_CONFIG)
    assembled = step.assemble(s16, batch(), torch.Generator(device=dev).manual_seed(SEED + 3))
    m16 = step.update(s16, *assembled)
    m32 = make_train_step(TRAINING_CONFIG, loss_cfg, asm_cfg, W).update(s32, *assembled)
    l16, l32 = float(m16["loss"]), float(m32["loss"])
    cos, rel = _grad_distance(torch, s16.module, s32.module)
    log(f"dtype (b): one bf16 step against one fp32 step, same batch and weights: loss "
        f"{l16:.6g} vs {l32:.6g} (rtol {BF16_STEP_LOSS_RTOL}), gradient cosine {cos:.4f} (at "
        f"least {BF16_STEP_GRAD_COS}), relative L2 {rel:.4f} (at most {BF16_STEP_GRAD_REL})")
    if abs(l16 - l32) > BF16_STEP_LOSS_RTOL * abs(l32) or cos < BF16_STEP_GRAD_COS \
            or rel > BF16_STEP_GRAD_REL:
        fail("the bf16 step disagrees with the fp32 step")
    del s16, s32, assembled
    # the split of a step, bf16 against fp32, in this call
    timings = {}
    for name, st, tc in (("bf16", state, tc16),
                         ("fp32", new_train_state(torch, TRAINING_CONFIG), TRAINING_CONFIG)):
        stp = make_train_step(tc, loss_cfg, asm_cfg, W)
        stp(st, batch(), gen)  # warm-up
        loss_fn = build_loss_fn(st.module, loss_cfg, W, pick_assembly(asm_cfg)[1])
        timings[name] = _step_split(torch, st, stp, loss_fn, batch, gen, BF16_TIMED_STEPS)
        del st, stp, loss_fn
        torch.cuda.empty_cache()
    log(f"dtype (b): train step ResNet-34-8s {W}x{H} B={Bt} (CUDA events, "
        f"{BF16_TIMED_STEPS} steps after a warm-up): bf16 {_step_text(*timings['bf16'])}; "
        f"fp32 {_step_text(*timings['fp32'])}; bf16 {timings['fp32'][0] / timings['bf16'][0]:.2f}"
        f" x faster; {1e3 * Bt / timings['bf16'][0]:.2f} pairs/s")
    return {"launches": launches, "timings": timings}


def check_bf16_driver(torch, np, dev, ph, tmp):
    """(c): DenseCorrespondenceTraining with compute_dtype bfloat16, then the
    folder through from_model_folder in fp32 and in bf16."""
    from pdc_tpu_torch.data.dataset import SpartanDataset
    from pdc_tpu_torch.models.checkpoint import read_checkpoint
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
    from pdc_tpu_torch.training.train import DenseCorrespondenceTraining

    cfg = driver_config(tmp, "bf16_driver", num_iterations=BF16_DRIVER_ITERATIONS,
                        save_rate=BF16_DRIVER_ITERATIONS, logging_rate=BF16_DRIVER_ITERATIONS,
                        compute_test_loss=False)
    cfg["dense_correspondence_network"]["compute_dtype"] = "bfloat16"
    ds = SpartanDataset.from_dataset_config(DATASET_RECORD, mode="train")
    trainer = DenseCorrespondenceTraining(cfg, ds, device=dev)
    ph.forward_launches = ph.backward_launches = 0
    t = time.perf_counter()
    folder = trainer.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches = (ph.forward_launches, ph.backward_launches)
    losses = trainer._logging_dict["train"]["loss"]
    tag = "%06d" % BF16_DRIVER_ITERATIONS
    leaves = flatten(read_checkpoint(os.path.join(folder, tag + ".ckpt")))
    leaves.update(flatten(read_checkpoint(os.path.join(folder, tag + ".ckpt.opt"))))
    floats = [np.asarray(v) for v in leaves.values() if np.asarray(v).dtype.kind == "f"]
    ckpt_fp32 = bool(floats) and all(v.dtype == np.float32 for v in floats)
    d32 = DenseCorrespondenceNetwork.from_model_folder(folder, device=dev)
    d16 = DenseCorrespondenceNetwork.from_model_folder(folder, device=dev,
                                                       dtype=torch.bfloat16)
    rgb = ds.get_random_rgbd_mask_pose()[0]
    with torch.inference_mode():
        r32, r16 = d32.forward_on_img(rgb), d16.forward_on_img(rgb)
        rms = float((r16.float() - r32).square().mean().sqrt() / r32.square().mean().sqrt())
    log(f"dtype (c): DenseCorrespondenceTraining, compute_dtype bfloat16, route "
        f"{trainer.route!r}, {BF16_DRIVER_ITERATIONS} iterations in {run_s:.2f} s: losses "
        f"{[round(float(x), 6) for x in losses]}; K1/K2 launches {launches}; checkpoint and "
        f"Adam state fp32: {ckpt_fp32}; from_model_folder builds {d32.module.dtype} by "
        f"default and {d16.module.dtype} on request, their descriptors {rms:.4g} apart "
        f"(relative RMS, bar {BF16_FWD_RMS})")
    if (not ckpt_fp32 or d32.module.dtype != torch.float32 or d16.module.dtype != torch.bfloat16
            or r16.dtype != torch.bfloat16 or not rms <= BF16_FWD_RMS
            or not all(np.isfinite(float(x)) for x in losses)
            or launches != scanned_launches(BF16_DRIVER_ITERATIONS)):
        fail("the bf16 training driver failed its checks")
    return {"launches": launches, "run_s": run_s}


def check_remat(torch, np, dev, frames_t):
    """(d): ResNet-101-8s, one step with remat and one without."""
    import copy

    from pdc_tpu_torch.data.assembler import AssemblerConfig
    from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
    from pdc_tpu_torch.training.train import make_train_step

    tc = copy.deepcopy(TRAINING_CONFIG)
    tc["dense_correspondence_network"]["backbone"] = {"model_class": "Resnet",
                                                      "resnet_name": "Resnet101_8s"}
    loss_cfg = LossConfig.from_dict(tc["loss_function"])
    asm_cfg = AssemblerConfig.from_training_config(tc)
    Bt = tc["training"]["batch_size"]
    rng = np.random.default_rng(SEED + 15)
    step = make_train_step(tc, loss_cfg, asm_cfg, W)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    runs, assembled = {}, None
    for remat in (False, True):
        state = new_train_state(torch, dict(tc, dense_correspondence_network=dict(
            tc["dense_correspondence_network"], remat=remat)))
        if assembled is None:
            assembled = step.assemble(state, pair_batch(torch, frames_t, *draw_pairs(
                np, rng, Bt, N_FRAMES)), torch.Generator(device=dev).manual_seed(SEED + 5))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        e = _events(torch, 2)
        e[0].record()
        metrics = step.update(state, *assembled)
        e[1].record()
        torch.cuda.synchronize()
        runs[remat] = {"state": state, "loss": float(metrics["loss"]),
                       "peak": torch.cuda.max_memory_allocated(),
                       "above": torch.cuda.max_memory_allocated() - base,
                       "ms": [e[0].elapsed_time(e[1])]}
    a, b = runs[False], runs[True]
    _, rel = _grad_distance(torch, b["state"].module, a["state"].module)
    stats_err, tracked = 0.0, set()
    for (n, x), y in zip(a["state"].module.state_dict().items(),
                         b["state"].module.state_dict().values()):
        if "running" in n:
            stats_err = max(stats_err, float((x - y).abs().max()) / max(1.0, float(x.abs().max())))
        elif n.endswith("num_batches_tracked"):
            tracked |= {int(x), int(y)}
    for r in runs.values():
        for _ in range(REMAT_TIMED_STEPS):
            e = _events(torch, 2)
            bt = pair_batch(torch, frames_t, *draw_pairs(np, rng, Bt, N_FRAMES))
            e[0].record()
            step(r["state"], bt, gen)
            e[1].record()
            torch.cuda.synchronize()
            r["ms"].append(e[0].elapsed_time(e[1]))
    log(nvidia_smi_line())
    log(f"remat (d): ResNet-101-8s fp32 {W}x{H} B={Bt}, one step with remat and one without, "
        f"same batch and weights: loss {b['loss']:.8g} vs {a['loss']:.8g}, gradients relative "
        f"L2 {rel:.3g} (bar {STEP_GRAD_RTOL}), running statistics {stats_err:.3g} of their "
        f"scale (bar {STEP_LOSS_RTOL}), num_batches_tracked {sorted(tracked)} (1 expected); "
        f"peak memory (torch.cuda.max_memory_allocated) above the step's start: remat "
        f"{b['above'] / 2**30:.3f} GiB against {a['above'] / 2**30:.3f} GiB without (peaks "
        f"{b['peak'] / 2**30:.3f} and {a['peak'] / 2**30:.3f} GiB, the first state still held "
        f"in the second); step ms (CUDA events, the compared step then {REMAT_TIMED_STEPS} "
        f"more) remat [{', '.join(f'{x:.3f}' for x in b['ms'])}] against "
        f"[{', '.join(f'{x:.3f}' for x in a['ms'])}]")
    if (abs(a["loss"] - b["loss"]) > STEP_LOSS_RTOL * abs(a["loss"]) or rel > STEP_GRAD_RTOL
            or stats_err > STEP_LOSS_RTOL or tracked != {1} or not b["above"] < a["above"]):
        fail("remat disagrees with the step without it, or does not save memory")
    out = {k: {"peak": r["peak"], "above": r["above"], "ms": r["ms"]} for k, r in runs.items()}
    del runs, a, b, assembled
    torch.cuda.empty_cache()
    return out


def check_preprocess(torch, np, dev, tmp):
    """(e): python -m pdc_tpu_torch preprocess on a 640x480 scene of
    PREP_FRAMES frames with a TSDF-scale fusion mesh."""
    import contextlib
    import io
    import shutil

    from pdc_tpu_torch import __main__ as cli
    from pdc_tpu_torch.data import native_loader as nl
    from pdc_tpu_torch.data.synthetic import SyntheticScene
    from pdc_tpu_torch.pipeline import change_detection as cdm
    from pdc_tpu_torch.pipeline import renderer as pr
    from pdc_tpu_torch.utils.yaml_io import load_yaml

    root = os.path.join(tmp, "preprocess", "logs_proto")
    scene = SyntheticScene(width=W, height=H, num_frames=PREP_FRAMES)
    t = time.perf_counter()
    processed = scene.write_scene(os.path.join(root, "scene_000"))
    scene.write_fusion_mesh(processed, **PREP_MESH)
    write_s = time.perf_counter() - t
    own = np.zeros((PREP_FRAMES, H, W), np.uint8)
    nl.decode_batch([(os.path.join(processed, "image_masks", "%06d_mask.png" % i),
                      nl.KIND_MASK8, own[i]) for i in range(PREP_FRAMES)], H, W)
    for d in ("image_masks", "rendered_images"):
        shutil.rmtree(os.path.join(processed, d))

    totals = {}
    restore = [_timer(torch, pr, "prepare_sorted_render", totals, "host prep"),
               _timer(torch, pr, "_render_prepared", totals, "device render"),
               _timer(torch, pr, "_packed", totals, "device render"),
               _timer(torch, pr, "unpack_scene_products", totals, "fetch and unpack"),
               _timer(torch, nl, "encode_batch", totals, "PNG encode"),
               _timer(torch, pr, "read_ply_mesh", totals, "mesh read")]
    try:
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as said:
            cli.main(["preprocess", "--data_dir", root])
        cmd_s = time.perf_counter() - t
    finally:
        for r in restore:
            r()
    masks_dir, depth_dir = (os.path.join(processed, d) for d in ("image_masks", "rendered_images"))
    missing = [p for i in range(PREP_FRAMES) for p in (
        os.path.join(masks_dir, "%06d_mask.png" % i),
        os.path.join(depth_dir, "%06d_depth.png" % i),
        os.path.join(depth_dir, "%06d_depth_cropped.png" % i)) if not os.path.isfile(p)]
    mask = np.zeros((PREP_FRAMES, H, W), np.uint8)
    crop = np.zeros((PREP_FRAMES, H, W), np.uint16)
    full = np.zeros((PREP_FRAMES, H, W), np.uint16)
    if not missing:
        nl.decode_batch([(os.path.join(masks_dir, "%06d_mask.png" % i), nl.KIND_MASK8, mask[i])
                         for i in range(PREP_FRAMES)]
                        + [(os.path.join(depth_dir, "%06d_depth_cropped.png" % i),
                            nl.KIND_GRAY16, crop[i]) for i in range(PREP_FRAMES)]
                        + [(os.path.join(depth_dir, "%06d_depth.png" % i), nl.KIND_GRAY16,
                            full[i]) for i in range(PREP_FRAMES)], H, W)
    verts, faces = pr.read_ply_mesh(os.path.join(processed, "fusion_mesh.ply"))
    per_pose = {k: 1e3 * v / PREP_FRAMES for k, v in totals.items()}
    log(nvidia_smi_line())
    log(f"preprocess (e): a {W}x{H} scene of {PREP_FRAMES} frames, fusion mesh of {len(faces)} "
        f"faces and {len(verts)} vertices (written in {write_s:.2f} s); python -m "
        f"pdc_tpu_torch preprocess said {said.getvalue().strip()!r} in {cmd_s:.3f} s = "
        f"{1e3 * cmd_s / PREP_FRAMES:.3f} ms per pose; per pose: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in per_pose.items())
        + "; files missing: " + str(len(missing)))
    if missing or not PREP_FACES[0] <= len(faces) <= PREP_FACES[1]:
        fail(f"preprocess: {len(missing)} files missing, or the mesh has {len(faces)} faces")

    # 4 poses on the CPU route, held to the card's PNGs bit for bit
    c, structure = cdm.ChangeDetection.from_data_folder(processed, device="cpu")
    c.set_crop_box(cdm.OrientedCropBox.from_station_config(
        load_yaml(os.path.join(processed, "crop_box.yaml"))))
    poses = structure.load_pose_data()
    sel = np.linspace(0, PREP_FRAMES - 1, PREP_CPU_POSES).astype(int)
    stack = np.stack([poses[int(i)] for i in sel])
    t = time.perf_counter()
    m_cpu, crop_cpu, full_cpu = pr.render_scene_products(
        c.points, c._fg_faces, c.faces, stack, c.K, H, W, 1000.0, device="cpu")
    cpu_s = time.perf_counter() - t
    differ = {"mask": int((m_cpu != (mask[sel] > 0)).sum()),
              "depth_cropped": int((crop_cpu != crop[sel]).sum()),
              "depth": int((full_cpu != full[sel]).sum())}
    # the sorted route against the binned one, on the card
    t = time.perf_counter()
    d_sorted = pr.render_depth_from_mesh_sorted_many(verts, faces, stack, c.K, H, W, device=dev)
    torch.cuda.synchronize()
    sorted_ms = 1e3 * (time.perf_counter() - t) / len(sel)
    t = time.perf_counter()
    d_binned = pr.render_depth_from_mesh_binned_many(verts, faces, stack, c.K, H, W,
                                                     device=dev)
    torch.cuda.synchronize()
    binned_ms = 1e3 * (time.perf_counter() - t) / len(sel)
    routes_equal = torch.equal(d_sorted, d_binned)
    inter = ((mask > 0) & (own > 0)).sum(axis=(1, 2))
    union = ((mask > 0) | (own > 0)).sum(axis=(1, 2))
    iou = inter / np.maximum(union, 1)
    log(f"preprocess (e): poses {sel.tolist()} on the CPU route ({cpu_s:.2f} s) against the "
        f"card's PNGs, differing pixels {differ} (0 expected); render_depth_from_mesh_sorted_"
        f"many equals the binned route on the card bit for bit: {routes_equal} ({sorted_ms:.3f}"
        f" against {binned_ms:.3f} ms per pose, host prep included); mask IoU with the "
        f"scene's own masks: min {iou.min():.4f}, mean {iou.mean():.4f} (bar {PREP_IOU_MIN})")
    if any(differ.values()) or not routes_equal or iou.min() < PREP_IOU_MIN:
        fail("preprocess: the card's renders disagree with the CPU route or the scene")
    return {"seconds": cmd_s, "per_pose": per_pose, "faces": len(faces),
            "iou": (float(iou.min()), float(iou.mean())),
            "render_inputs": (c.points, c._fg_faces, c.faces, stack, c.K)}


def check_compute_dtype_and_preprocess(torch, np, dev, ph, frames_t, tmp):
    """The phase "compute dtype, remat and preprocessing": (a)-(e) of the
    module docstring. Returns what the kernels line and timings read."""
    out = {"forward": check_bf16_forward(torch, np, dev, frames_t)}
    out["train"] = check_bf16_training(torch, np, dev, ph, frames_t)
    torch.cuda.empty_cache()
    out["driver"] = check_bf16_driver(torch, np, dev, ph, tmp)
    torch.cuda.empty_cache()
    out["remat"] = check_remat(torch, np, dev, frames_t)
    out["preprocess"] = check_preprocess(torch, np, dev, tmp)
    torch.cuda.empty_cache()
    return out


# -- dataset tooling and experiments ------------------------------------------------------

# experiment caterpillar at Scale.full() (640x480, ResNet-34-8s, D=3, B=4) on the
# synthetic stand-in: the protocol's 2 runs of EXP_STEPS steps (2 calls of 6 steps
# at the default steps_per_dispatch), checkpoints every EXP_SAVE_RATE; each network
# scored on EXP_PAIRS test pairs of EXP_MATCHES matches (the protocol's 100 pairs
# cut to 8, one sweep chunk, to keep the phase near a minute). From disk (e): 1 run
# of EXP_DISK_STEPS steps.
EXP_STEPS, EXP_SAVE_RATE, EXP_PAIRS, EXP_MATCHES, EXP_DISK_STEPS = 12, 12, 8, EVAL_MATCHES, 3
# the keys of pdc_tpu's result.json (tests/test_torch_port_experiments.py holds the
# port's runner to pdc_tpu's on the CPU)
RESULT_KEYS = {"protocol", "reference_dir", "description", "dataset", "scale",
               "runs_truncated", "run_filter", "seeds", "networks"}
NETWORK_KEYS = {"model_folder", "overrides", "composite", "test", "test_composite"}
STAT_KEYS = ("pck_at_5px", "pck_at_10px", "norm_diff_3d_area_above_curve")


class _ExperimentSpy:
    """Within the block, records each DenseCorrespondenceTraining that run()
    starts, with a CUDA event recorded after each of its steps, and the host
    seconds and K3 launches of each network's scoring
    (``evaluate_single_network``, synchronised before and after)."""

    def __init__(self, torch, train_mod, ev, bm):
        self._torch, self._bm = torch, bm
        self._cls = train_mod.DenseCorrespondenceTraining
        self._dce = ev.DenseCorrespondenceEvaluation
        self.runs, self.scores = [], []

    def __enter__(self):
        torch, bm, spy = self._torch, self._bm, self
        self._run, self._score = self._cls.run, self._dce.evaluate_single_network

        def run(trainer, *args, **kwargs):
            events = []
            spy.runs.append((trainer, events))

            def mark(it, metrics):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                events.append((it, e))
            return spy._run(trainer, *args, progress_callback=mark, **kwargs)

        def score(dce, name, *args, **kwargs):
            torch.cuda.synchronize()
            t, n = time.perf_counter(), bm.launches
            try:
                return spy._score(dce, name, *args, **kwargs)
            finally:
                torch.cuda.synchronize()
                spy.scores.append((name, time.perf_counter() - t, bm.launches - n))
        self._cls.run, self._dce.evaluate_single_network = run, score
        return self

    def __exit__(self, *exc):
        self._cls.run, self._dce.evaluate_single_network = self._run, self._score

    def step_ms(self, save_rate):
        """ms a step between the events of consecutive calls, leaving out
        each interval that holds a checkpoint write."""
        self._torch.cuda.synchronize()
        return [a.elapsed_time(b) / (j - i) for _, events in self.runs
                for (i, a), (j, b) in zip(events, events[1:]) if i % save_rate]


def _same_scenes(np, a, b):
    """The scenes of two datasets over both splits: equal names, frame ids,
    frame counts and poses."""
    def scenes(ds):
        out = {}
        for mode in ("train", "test"):
            ds.set_train_mode() if mode == "train" else ds.set_test_mode()
            out.update(ds.scenes)
        return out
    sa, sb = scenes(a), scenes(b)
    return sorted(sa) == sorted(sb) and all(
        (x.frame_ids is None and y.frame_ids is None or np.array_equal(x.frame_ids, y.frame_ids))
        and x.num_frames == y.num_frames and np.array_equal(x.poses, y.poses)
        for x, y in ((sa[n], sb[n]) for n in sa)), sorted(sa)


def _check_experiment_run(torch, np, spy, k1, k2, n_runs, steps, what):
    """K1 and K2 launched 2 per step and per warm-up step of each run (the
    runner computes no test loss), every metric finite, every run's weights
    moved, and the folders' checkpoints. Returns the model folders."""
    from pdc_tpu_torch.models.checkpoint import read_checkpoint
    from pdc_tpu_torch.models.convert import flax_to_state_dict

    want = scanned_launches(steps * n_runs, captures=n_runs)
    log(f"{what}: {len(spy.runs)} runs trained, routes "
        f"{[tr.route for tr, _ in spy.runs]}; launches K1 {k1}, K2 {k2} (expected {want}: "
        f"2 x {steps} steps x {n_runs} runs and 2 x each capture's warm-up steps)")
    if len(spy.runs) != n_runs or (k1, k2) != want:
        fail(f"{what}: K1/K2 did not launch twice per train step")
    folders = []
    for trainer, _ in spy.runs:
        tl = trainer._logging_dict["train"]
        values = [v for k, vs in tl.items() if k != "iteration" for v in vs]
        if len(tl["loss"]) != steps or not all(np.isfinite(v) for v in values):
            fail(f"{what}: a metric of {trainer.logging_dir} is missing or not finite")
        folder = trainer.logging_dir
        first = flax_to_state_dict(read_checkpoint(os.path.join(folder, "000000.ckpt")))
        live = trainer.state.module.state_dict()
        still = [k for k, v in first.items() if v.dim() > 1 and torch.equal(v, live[k].cpu())]
        if still:
            fail(f"{what}: {folder} left weights unchanged: {still[:5]}")
        log(f"{what}: {os.path.basename(folder)} losses "
            + ", ".join(f"{x:.5g}" for x in tl["loss"]))
        folders.append(folder)
    return folders


def _check_result(np, result, n_nets, what):
    """result.json has pdc_tpu's keys, and each network's test PCKs lie in
    [0, 1] with a finite area above the curve."""
    import math

    nets = result["networks"]
    ok = set(result) == RESULT_KEYS and len(nets) == n_nets and all(
        set(info) == NETWORK_KEYS and set(info["test"]) == set(STAT_KEYS)
        and all(0.0 <= info["test"][k] <= 1.0 for k in STAT_KEYS[:2])
        and math.isfinite(info["test"][STAT_KEYS[2]]) for info in nets.values())
    log(f"{what}: result.json keys {sorted(result)}; test statistics "
        + "; ".join(f"{n}: " + ", ".join(f"{k} {v:.4f}" for k, v in info["test"].items())
                    for n, info in nets.items()))
    if not ok:
        fail(f"{what}: result.json lacks pdc_tpu's keys or holds statistics out of range")


def check_tooling_and_experiments(torch, np, dev, bm, ph, on_disk, tmp, smi):
    """The phase "dataset tooling and experiments", on phase 8's scene tree
    under ``tmp``: checks (a)-(f) of the module docstring. Returns what the
    kernels line reads."""
    import contextlib
    import filecmp
    import io
    import math
    import shutil

    from pdc_tpu_torch import __main__ as cli
    from pdc_tpu_torch.data import published_manifest as pm
    from pdc_tpu_torch.data.config_gen import discover_scenes
    from pdc_tpu_torch.data.dataset import SpartanDataset
    from pdc_tpu_torch.data.download import BASE_URL
    from pdc_tpu_torch.evaluation import evaluate as ev
    from pdc_tpu_torch.evaluation.table import read_csv
    from pdc_tpu_torch.experiments import PROTOCOLS, Scale, runner
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
    from pdc_tpu_torch.training import train as train_mod
    from pdc_tpu_torch.utils import yaml_io
    from pdc_tpu_torch.utils.yaml_io import load_yaml

    seconds = {}

    def command(label, argv):
        """python -m pdc_tpu_torch <argv> in this process; returns its stdout."""
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize(dev)
        seconds[label] = time.perf_counter() - t
        text = buf.getvalue()
        log(f"python -m pdc_tpu_torch {' '.join(argv)}: rc {rc}, {seconds[label]:.2f} s; "
            f"{len(text.splitlines())} lines of output, the last: "
            f"{text.splitlines()[-1] if text else ''}")
        if rc != 0:
            fail(f"python -m pdc_tpu_torch {argv[0]} returned {rc}")
        return text

    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)

    # (a) the published corpus, read back without PyYAML
    pub = os.path.join(tmp, "published")
    command("config-gen --published", ["config-gen", "--published", "--out_dir", pub])
    want = {}
    for sub, lists in (("single_object", pm.SINGLE_OBJECT_SCENE_LISTS),
                       ("multi_object", pm.MULTI_OBJECT_SCENE_LISTS)):
        for name, spec in lists.items():
            cfg = {k: spec[k] for k in ("logs_root_path", "object_id", "train", "test")}
            if spec.get("evaluation_labeled_data_path"):
                cfg["evaluation_labeled_data_path"] = spec["evaluation_labeled_data_path"]
            want[f"{sub}/{name}.yaml"] = cfg
    for name, spec in pm.COMPOSITES.items():
        want[f"composite/{name}.yaml"] = {
            "logs_root_path": spec["logs_root_path"],
            "single_object_scenes_config_files": [f"{e}.yaml" for e in spec["single_object"]],
            "multi_object_scenes_config_files": [f"{e}.yaml" for e in spec["multi_object"]]}
    written = files(pub)

    def read_back(name):
        """(load_yaml, the port's own parse_yaml) of a written file."""
        with open(os.path.join(pub, name)) as f:
            return load_yaml(os.path.join(pub, name)), yaml_io.parse_yaml(f.read())
    bad = [n for n in written if n not in want or read_back(n) != (want[n], want[n])]
    reader = "PyYAML" if yaml_io._pyyaml_loader() is not None else "parse_yaml (no PyYAML)"
    log(f"tooling (a): {len(written)} YAMLs ({len(pm.SINGLE_OBJECT_SCENE_LISTS)} single-object, "
        f"{len(pm.MULTI_OBJECT_SCENE_LISTS)} multi-object, {len(pm.COMPOSITES)} composites "
        f"expected), read back with load_yaml ({reader} on this machine) and with the port's "
        f"parse_yaml: {len(bad)} differ from the manifest")
    if written != sorted(want) or bad:
        fail(f"tooling (a): the published corpus differs from the manifest: {bad[:5]}")

    # (b) a corpus generated from phase 8's tree
    gen = os.path.join(tmp, "generated")
    command("config-gen --data_dir", ["config-gen", "--data_dir", tmp, "--out_dir", gen,
                                      "--name", "caterpillar_only"])
    found = discover_scenes(tmp)
    gen_composite = os.path.join(gen, "composite", "caterpillar_only.yaml")

    def dataset(composite):
        return SpartanDataset(config=load_yaml(composite), data_dir=tmp,
                              config_dir=os.path.dirname(composite))
    same, names = _same_scenes(np, dataset(on_disk["composite"]), dataset(gen_composite))
    log(f"tooling (b): config-gen found {found} (phase 8 wrote {sorted(on_disk['scenes'])}); "
        f"the generated composite's dataset has phase 8's scene names, frame ids and poses: "
        f"{same} ({names}); split {load_yaml(os.path.join(gen, 'single_object', 'object.yaml'))}")
    if found != sorted(on_disk["scenes"]) or not same:
        fail("tooling (b): the generated corpus does not hold phase 8's scenes")

    # (c) migrate a flattened copy of one scene back; download's dry run
    src = os.path.join(tmp, "logs_proto", "scene_000")
    old_logs = os.path.join(tmp, "old_layout", "logs_proto")
    shutil.copytree(os.path.join(src, "processed"), os.path.join(old_logs, "scene_000"))
    flat_mesh = os.path.isfile(os.path.join(old_logs, "scene_000", "fusion_mesh.ply"))
    text = command("migrate", ["migrate", "--logs_dir", old_logs])
    back = os.path.join(old_logs, "scene_000")
    same_tree = files(back) == files(src) and all(
        filecmp.cmp(os.path.join(back, f), os.path.join(src, f), shallow=False)
        for f in files(src))
    log(f"tooling (c): migrate on a flattened scene_000 (top-level fusion_mesh.ply: "
        f"{flat_mesh}) printed {text.strip()!r}; the tree it gave back equals the original, "
        f"{len(files(src))} files byte for byte: {same_tree}")
    if not flat_mesh or text.strip() != "migrated scene_000" or not same_tree:
        fail("tooling (c): migrate did not give back the scene's tree")
    dl = os.path.join(tmp, "download")
    cat = os.path.join(pub, "composite", "caterpillar_only.yaml")
    text = command("download --dry_run", ["download", "--config", cat, "--data_dir", dl,
                                          "--dry_run"])
    scenes = set()
    for entry in pm.COMPOSITES["caterpillar_only"]["single_object"]:
        spec = pm.SINGLE_OBJECT_SCENE_LISTS[entry]
        scenes.update(spec["train"] + spec["test"])
    urls = sorted(f"{BASE_URL}logs_proto_compressed/{s}.tar.gz" for s in scenes)
    listed = [ln.split()[-1] for ln in text.splitlines() if ln.startswith("would fetch ")]
    fetched = files(os.path.join(dl, "logs_proto")) if os.path.isdir(dl) else []
    log(f"tooling (c): download --dry_run listed {len(listed)} scene URLs of caterpillar_only "
        f"(expected {len(urls)}: {urls[0]}, ...); files under {dl}/logs_proto: {len(fetched)}")
    if listed != urls or fetched:
        fail("tooling (c): download --dry_run did not list the scenes, or fetched")

    # (d) experiment caterpillar at full width on the synthetic stand-in
    exp_dir = os.path.join(tmp, "experiment")
    argv = ["experiment", "caterpillar", "--steps", str(EXP_STEPS), "--save_rate",
            str(EXP_SAVE_RATE), "--num_eval_pairs", str(EXP_PAIRS), "--num_matches_per_pair",
            str(EXP_MATCHES), "--logging_dir", exp_dir, "--device", str(dev)]
    protocol = PROTOCOLS["caterpillar"]
    ph.forward_launches = ph.backward_launches = bm.launches = 0
    with _ExperimentSpy(torch, train_mod, ev, bm) as spy:
        command("experiment caterpillar", argv)
    k1, k2, k3 = ph.forward_launches, ph.backward_launches, bm.launches
    folders = _check_experiment_run(torch, np, spy, k1, k2, len(protocol.runs), EXP_STEPS,
                                    "experiment (d)")
    missing = [f for f in folders for c in ("000000.ckpt", f"{EXP_STEPS:06d}.ckpt")
               if not os.path.exists(os.path.join(f, c))]
    if missing:
        fail(f"experiment (d): checkpoints missing in {missing}")
    stand_in = runner._resolve_dataset(protocol, None, None, None, Scale.full(), {})
    stand_in.set_test_mode()
    pairs = ev.image_pair_list(stand_in, EXP_PAIRS, 1)
    chunks = math.ceil(len(pairs) / ev.SWEEP_PAIR_CHUNK)
    log(f"experiment (d): K3 launches {k3}, per network's scoring {[n for _, _, n in spy.scores]}"
        f" (expected one per sweep chunk: {chunks} chunk of {len(pairs)} pairs each)")
    if k3 != chunks * len(folders) or [n for _, _, n in spy.scores] != [chunks] * len(folders):
        fail("experiment (d): K3 did not launch once per sweep chunk")
    result = json.load(open(os.path.join(exp_dir, "result.json")))
    _check_result(np, result, len(protocol.runs), "experiment (d)")
    if not os.path.exists(os.path.join(exp_dir, "comparison_test.yaml")):
        fail("experiment (d): comparison_test.yaml is missing")
    net = protocol.runs[0].name
    dcn = DenseCorrespondenceNetwork.from_model_folder(os.path.join(exp_dir, net), device=dev)
    images = ev.DenseCorrespondenceEvaluation.compute_descriptor_images_batched(
        dcn, stand_in, [(s, i) for s, a, b, _ in pairs for i in (a, b)])
    ties, k3_err = check_eval_routes(torch, np, bm, ev, stand_in, pairs, images,
                                     read_csv(os.path.join(exp_dir, net, "test", "data.csv")))
    step_ms = spy.step_ms(EXP_SAVE_RATE)
    score_s = [s for _, s, _ in spy.scores]
    # the same command again: resume trains nothing, and scores the same
    ph.forward_launches = ph.backward_launches = bm.launches = 0
    with _ExperimentSpy(torch, train_mod, ev, bm) as again:
        text = command("experiment caterpillar, again", argv)
    result2 = json.load(open(os.path.join(exp_dir, "result.json")))
    same_stats = all(result2["networks"][n]["test"] == info["test"]
                     for n, info in result["networks"].items())
    log(f"experiment (d) resume: {len(again.runs)} runs trained, K1 {ph.forward_launches}, K2 "
        f"{ph.backward_launches}, K3 {bm.launches}; 'already trained' {text.count('already')} "
        f"times; the same statistics: {same_stats}")
    if again.runs or ph.forward_launches or text.count("already trained") != len(folders) \
            or not same_stats:
        fail("experiment (d): the second call retrained, or scored differently")
    torch.cuda.empty_cache()

    # (e) from disk, through (b)'s generated corpus
    disk_dir = os.path.join(tmp, "experiment_from_disk")
    argv = ["experiment", "caterpillar", "--data_dir", tmp, "--dataset_dir",
            os.path.join(gen, "composite"), "--run_filter", "0.500", "--steps",
            str(EXP_DISK_STEPS), "--num_eval_pairs", str(EXP_PAIRS), "--num_matches_per_pair",
            str(EXP_MATCHES), "--logging_dir", disk_dir, "--device", str(dev)]
    ph.forward_launches = ph.backward_launches = bm.launches = 0
    with _ExperimentSpy(torch, train_mod, ev, bm) as disk:
        command("experiment caterpillar --data_dir", argv)
    k1d, k2d, k3d = ph.forward_launches, ph.backward_launches, bm.launches
    _check_experiment_run(torch, np, disk, k1d, k2d, 1, EXP_DISK_STEPS, "experiment (e)")
    trained_ds = disk.runs[0][0].dataset
    trained_ds.set_train_mode()  # the runner scored on the same dataset, in test mode
    trained_on = trained_ds.get_scene_list()
    disk_ds = dataset(gen_composite)
    disk_ds.set_test_mode()
    disk_chunks = math.ceil(len(ev.image_pair_list(disk_ds, EXP_PAIRS, 1)) / ev.SWEEP_PAIR_CHUNK)
    result_d = json.load(open(os.path.join(disk_dir, "result.json")))
    log(f"experiment (e): trained on {trained_on}, the generated composite's train split; dataset "
        f"{result_d['dataset']!r}; K3 launches {k3d} (expected {disk_chunks})")
    if (k3d != disk_chunks or result_d["dataset"] != "published:" + tmp
            or trained_on != load_yaml(os.path.join(gen, "single_object", "object.yaml"))["train"]):
        fail("experiment (e): K3 did not launch once per sweep chunk, or the run did not read "
             "the tree")
    _check_result(np, result_d, 1, "experiment (e)")

    # (f) the numbers
    log(smi)
    log("tooling and experiments, seconds per command: " + ", ".join(
        f"{k} {v:.2f}" for k, v in seconds.items()))
    log(f"experiment (d) train step, CUDA events between consecutive calls over their steps "
        f"(checkpoint intervals left out), ResNet-34-8s 640x480 B=4: mean "
        f"{np.mean(step_ms):.3f} ms over {len(step_ms)} calls "
        f"({', '.join(f'{x:.1f}' for x in step_ms)}); host ms per call "
        f"{', '.join(f'{1e3 * s:.1f}' for tr, _ in spy.runs for s in tr.step_seconds)}"
        f" ms; scoring seconds per network (evaluate_single_network, {len(pairs)} pairs x "
        f"{EXP_MATCHES} matches): {', '.join(f'{s:.3f}' for s in score_s)}")
    return {"k1": k1, "k2": k2, "k3": k3, "k1_disk": k1d, "k2_disk": k2d, "k3_disk": k3d,
            "k3_err": k3_err, "ties": ties, "seconds": seconds, "step_ms": step_ms,
            "score_s": score_s}


# -- the data axis of the parallel layer ----------------------------------------------

# phase 16: DP_STEPS steps of each device-sampled route from the same weights and
# draws; the route's step timed over DP_TIMED calls; EVAL/STAT sizes of (d)
DP_STEPS, DP_TIMED, AXIS_PAIRS, AXIS_STAT_IMAGES = 3, 3, 4, 8
AXIS_QUERIES = 100
# (b): the card's step is not bit-reproducible (ROADMAP F4): two runs of the single
# route from the same weights and draws drift apart, and Adam turns each
# rounding-level gradient difference into up to lr a step. That spread, measured in
# the same call, is the bar: a route may differ from the single route by at most
# AXIS_SPREAD_X times it (relative L2 of the parameters, relative loss), or by the
# floors where the two single runs happen to agree
AXIS_SPREAD_X, AXIS_PARAM_FLOOR, AXIS_LOSS_FLOOR = 4.0, 1e-6, 1e-6


def _param_spread(torch, a, b):
    """(max |a - b|, relative L2 distance ||a - b|| / ||b||) over two modules'
    parameters."""
    worst, num, den = 0.0, 0.0, 0.0
    for p, q in zip(a.parameters(), b.parameters()):
        d = p.detach() - q.detach()
        worst = max(worst, float(d.abs().max()))
        num += float((d * d).sum())
        den += float((q.detach() ** 2).sum())
    return worst, (num / den) ** 0.5


def check_data_axis(torch, np, dev, bm, ph, frames_t, on_disk, render_inputs, tmp, smi):
    """The phase "the data axis": (a)-(g) of the module docstring, on a world
    of one process over NCCL. Returns the launches of each path and the
    timings."""
    from pdc_tpu_torch.apps.serve import DescriptorServer, _Laps, _Request
    from pdc_tpu_torch.data.assembler import AssemblerConfig
    from pdc_tpu_torch.data.dataset import SpartanDataset
    from pdc_tpu_torch.data.device_cache import DeviceCache
    from pdc_tpu_torch.evaluation.evaluate import EVAL_COLUMNS
    from pdc_tpu_torch.evaluation.evaluate import DenseCorrespondenceEvaluation as DCE
    from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
    from pdc_tpu_torch.parallel import distributed, make_mesh
    from pdc_tpu_torch.parallel.sharded_train import (
        make_pixel_sharded_best_match,
        make_sharded_train_step,
        rank_seed,
    )
    from pdc_tpu_torch.pipeline import renderer as pr
    from pdc_tpu_torch.training.scanned import make_device_sampled_train_step
    from pdc_tpu_torch.training.train import make_train_step

    import torch.distributed as dist

    distributed.ensure_initialized(coordinator_address="file://" + os.path.join(tmp, "store"),
                                   num_processes=1, process_id=0, device="cuda")
    out = {"launches": {}, "ms": {}}
    try:
        mesh = make_mesh()
        log(f"data axis: {mesh}, backend {dist.get_backend()}, world {dist.get_world_size()} "
            f"(the machine has one card: the collectives run over NCCL with one rank)")
        if dist.get_backend() != "nccl" or mesh.device.type != "cuda":
            fail("the data axis is not on NCCL and the card")
        tc = TRAINING_CONFIG
        loss_cfg = LossConfig.from_dict(tc["loss_function"])
        asm_cfg = AssemblerConfig.from_training_config(tc)
        Wt, Bt = tc["dense_correspondence_network"]["image_width"], tc["training"]["batch_size"]
        lr = tc["training"]["learning_rate"]

        # (a) the global-batch step against the single step, same batch and weights
        single = make_train_step(tc, loss_cfg, asm_cfg, Wt)
        s_single, s_sharded = new_train_state(torch, tc), new_train_state(torch, tc)
        assembled = single.assemble(s_single, pair_batch(torch, frames_t, *draw_pairs(
            np, np.random.default_rng(SEED + 16), Bt, N_FRAMES)),
            torch.Generator(device=dev).manual_seed(SEED + 16))
        m_single = single.update(s_single, *assembled)
        ph.forward_launches = ph.backward_launches = 0
        m_sharded = make_sharded_train_step(tc, loss_cfg, asm_cfg, Wt, mesh).update(
            s_sharded, *assembled)
        torch.cuda.synchronize()
        out["launches"]["sharded step"] = (ph.forward_launches, ph.backward_launches)
        num = den = 0.0
        close = total = 0
        for p, q in zip(s_sharded.module.parameters(), s_single.module.parameters()):
            num += float(((p.grad - q.grad) ** 2).sum())
            den += float((q.grad ** 2).sum())
            sig = q.grad.abs() > 1e-3 * float(q.grad.abs().max())
            close += int(((p.detach() - q.detach()).abs()[sig] <= 1e-2 * lr).sum())
            total += int(sig.sum())
        grad_rel = (num / den) ** 0.5
        worst = _param_spread(torch, s_sharded.module, s_single.module)[0]
        share = close / total
        loss_a, loss_s = float(m_sharded["loss"]), float(m_single["loss"])
        log(f"data axis (a): make_sharded_train_step against make_train_step on one batch: "
            f"loss {loss_a:.8g} vs {loss_s:.8g}, gradient relative L2 {grad_rel:.3g}, "
            f"parameters max|diff| {worst:.3g} (lr {lr}), {100 * share:.3f}% of the significant "
            f"ones within 1e-2 lr; K1/K2 launches {out['launches']['sharded step']} (2/2 "
            f"expected)")
        if (abs(loss_a - loss_s) > STEP_LOSS_RTOL * abs(loss_s) or grad_rel > STEP_GRAD_RTOL
                or worst > 2 * lr * (1 + 1e-3) or share < STEP_PARAM_SHARE
                or out["launches"]["sharded step"] != (2, 2)):
            fail("data axis (a): the sharded step disagrees with the single step")
        del s_single, s_sharded, assembled
        torch.cuda.empty_cache()

        # (b) the device-sampled route: single, data-parallel, data-parallel + FSDP
        t = time.perf_counter()
        ds = SpartanDataset.make_synthetic(**DATASET_RECORD["synthetic"])
        ds.set_parameters_from_training_config(tc)
        cache = DeviceCache.from_dataset(ds, device=dev)
        log(f"data axis (b): device cache of {cache.nbytes / 1e6:.1f} MB in "
            f"{time.perf_counter() - t:.2f} s")
        routes = {}
        for name, kw in (("single", {}), ("single again", {}),
                         ("data_parallel", {"mesh": mesh}),
                         ("fsdp", {"mesh": mesh, "fsdp": True})):
            state = new_train_state(torch, tc)
            step = make_device_sampled_train_step(tc, loss_cfg, asm_cfg, Wt, cache, Bt,
                                                  ((0, 1.0),), **kw)
            gen = torch.Generator(device=dev).manual_seed(rank_seed(SEED, mesh.rank))
            ph.forward_launches = ph.backward_launches = 0
            losses = [float(step(state, gen)["loss"]) for _ in range(DP_STEPS)]
            torch.cuda.synchronize()
            launches = (ph.forward_launches, ph.backward_launches)
            ms = time_cuda(torch, lambda: step(state, gen), iters=DP_TIMED, warmup=0)
            routes[name] = {"losses": losses, "state": state, "launches": launches, "ms": ms}
            if name in ("data_parallel", "fsdp"):
                out["launches"][name] = launches
            out["ms"][name + " step"] = ms

        def spread(name):
            r, s = routes[name], routes["single"]
            worst, rel = _param_spread(torch, r["state"].module, s["state"].module)
            return worst, rel, max(abs(a - b) / abs(b) for a, b in zip(r["losses"], s["losses"]))

        f4_worst, f4_rel, f4_loss = spread("single again")
        log(f"data axis (b): F4's spread, two runs of the single route, {DP_STEPS} steps: "
            f"losses {['%.6g' % x for x in routes['single']['losses']]} vs "
            f"{['%.6g' % x for x in routes['single again']['losses']]} (max relative "
            f"{f4_loss:.3g}), parameters relative L2 {f4_rel:.3g}, max|diff| {f4_worst:.3g}")
        for name in ("data_parallel", "fsdp"):
            r = routes[name]
            worst, rel, loss_rel = spread(name)
            state_mb = (r["state"].fsdp.state_bytes(r["state"].optimizer) / 1e6
                        if r["state"].fsdp is not None else None)
            log(f"data axis (b): {name} route, {DP_STEPS} steps against the single route: "
                f"losses {['%.6g' % x for x in r['losses']]} (max relative {loss_rel:.3g}, "
                f"bar {max(AXIS_SPREAD_X * f4_loss, AXIS_LOSS_FLOOR):.3g}), parameters "
                f"relative L2 {rel:.3g} (bar {max(AXIS_SPREAD_X * f4_rel, AXIS_PARAM_FLOOR):.3g}),"
                f" max|diff| {worst:.3g}; K1/K2 launches {r['launches']} ({2 * DP_STEPS} each "
                f"expected)"
                + ("" if state_mb is None else f"; ZeRO state on this rank {state_mb:.1f} MB"))
            if (loss_rel > max(AXIS_SPREAD_X * f4_loss, AXIS_LOSS_FLOOR)
                    or rel > max(AXIS_SPREAD_X * f4_rel, AXIS_PARAM_FLOOR)
                    or r["launches"] != (2 * DP_STEPS, 2 * DP_STEPS)
                    or (r["state"].fsdp is None) == (name == "fsdp")):
                fail(f"data axis (b): the {name} route disagrees with the single route")
        # (g) the all-reduce of ResNet-34-8s's gradients over NCCL
        params = [p for p in routes["single"]["state"].module.parameters()]
        flat = torch.cat([p.detach().reshape(-1) for p in params])
        out["ms"]["all_reduce"] = time_cuda(torch, lambda: mesh.all_reduce(flat), iters=10)
        out["all_reduce_mb"] = flat.numel() * 4 / 1e6
        del routes, cache, flat, params
        torch.cuda.empty_cache()

        # (c) K3 through the pixel-sharded best match, 640x480, Q=100
        dcn = DenseCorrespondenceNetwork.from_model_folder(on_disk["folder"], device="cuda")
        rgb = ds.scenes[sorted(ds.scenes)[0]].rgb[:1]
        with torch.inference_mode():
            res = dcn.forward(np.stack([ds.rgb_image_to_tensor(f) for f in rgb]))[0]
        res_flat = res.reshape(-1, res.shape[-1]).to(torch.float32).contiguous()  # [HW, D]
        rng = np.random.default_rng(SEED + 3)
        q = res_flat[torch.as_tensor(rng.integers(0, res_flat.shape[0], AXIS_QUERIES),
                                     device=dev)] + 0.01 * torch.as_tensor(
            rng.standard_normal((AXIS_QUERIES, res_flat.shape[1]), dtype=np.float32),
            device=dev)
        want_idx, want_dist = bm.best_match(res_flat.t().contiguous()[None], q[None])
        fn = make_pixel_sharded_best_match(mesh)
        bm.launches = 0
        idx, dist = fn(res_flat, q)
        torch.cuda.synchronize()
        out["launches"]["pixel-sharded best match"] = bm.launches
        same = torch.equal(idx, want_idx[0]) and torch.equal(dist, want_dist[0])
        out["k3_err"] = float((dist - want_dist[0]).abs().max())
        out["ms"]["pixel-sharded best match"] = time_cuda(torch, lambda: fn(res_flat, q))
        log(f"data axis (c): make_pixel_sharded_best_match at HW={res_flat.shape[0]} "
            f"Q={AXIS_QUERIES} equals best_match exactly: {same}; K3 launches "
            f"{out['launches']['pixel-sharded best match']} (1 expected)")
        if not same or out["launches"]["pixel-sharded best match"] != 1:
            fail("data axis (c): the pixel-sharded best match disagrees with best_match")

        # (d) mesh= evaluation and statistics on phase 8's folder against mesh=None
        eval_ds = DCE.load_dataset_from_model_folder(on_disk["folder"])
        kw = dict(num_image_pairs=AXIS_PAIRS, num_matches_per_image_pair=EVAL_MATCHES, seed=3)
        want = DCE.evaluate_network_quantitative(dcn, eval_ds, **kw)
        bm.launches = 0
        got = DCE.evaluate_network_quantitative(dcn, eval_ds, mesh=mesh, **kw)
        out["launches"]["mesh= evaluation"] = bm.launches
        rows_equal = len(got) == len(want) > 0 and all(
            np.array_equal(got[c], want[c], equal_nan=got[c].dtype.kind == "f")
            if got[c].dtype.kind == "f" else list(got[c]) == list(want[c]) for c in EVAL_COLUMNS)
        stat_kw = dict(num_images=AXIS_STAT_IMAGES, batch_size=4, save_to_file=False)
        eval_ds.reset_seed(5)
        stats_want = DCE.compute_descriptor_statistics_on_dataset(dcn, eval_ds, **stat_kw)
        eval_ds.reset_seed(5)
        stats_got = DCE.compute_descriptor_statistics_on_dataset(dcn, eval_ds, mesh=mesh,
                                                                 **stat_kw)
        log(f"data axis (d): mesh= evaluation of {AXIS_PAIRS} pairs x {EVAL_MATCHES} matches "
            f"on phase 8's folder equals mesh=None row for row: {rows_equal} ({len(got)} rows, "
            f"K3 launches {out['launches']['mesh= evaluation']}); descriptor statistics equal: "
            f"{stats_got == stats_want}")
        if not rows_equal or stats_got != stats_want or out["launches"]["mesh= evaluation"] < 1:
            fail("data axis (d): mesh= evaluation disagrees with mesh=None")

        # (e) the sharded renderer against the unsharded one, phase 14's scene
        verts, fg, faces, poses, K = render_inputs
        want = pr.render_scene_products(verts, fg, faces, poses, K, H, W, 1000.0, device=dev)
        got = pr.render_scene_products_sharded(verts, fg, faces, poses, K, H, W, 1000.0, mesh)
        render_equal = all(np.array_equal(g, w) for g, w in zip(got, want))
        log(f"data axis (e): render_scene_products_sharded of {len(poses)} poses of phase 14's "
            f"scene ({len(faces)} faces) equals render_scene_products bit for bit: "
            f"{render_equal}")
        if not render_equal:
            fail("data axis (e): the sharded renderer disagrees with the unsharded one")

        # (f) serve --data_parallel (one replica per card: one here) against without
        frames = np.stack([ds.scenes[n].rgb[i] for n in sorted(ds.scenes) for i in (0, 5)])
        queries = q[:16].cpu().numpy()
        answers = []
        for devices in (None, [dev]):
            server = DescriptorServer(dcn, port=0, max_batch=4, devices=devices)
            try:
                batch = [_Request(f, queries if i % 2 == 0 else None)
                         for i, f in enumerate(frames)]
                bm.launches = 0
                server._run_batch(batch, _Laps())
                if devices is not None:
                    out["launches"]["data-parallel server"] = bm.launches
                if any(r.error for r in batch):
                    fail(f"data axis (f): {[r.error for r in batch]}")
                answers.append([r.result for r in batch])
            finally:
                server.shutdown()
        served_equal = all(
            (a is None and b is None) or np.array_equal(a, b)
            for one, two in zip(*answers) for a, b in zip(one, two))
        log(f"data axis (f): DescriptorServer(devices=[{dev}]) (serve --data_parallel on this "
            f"machine) answers {len(frames)} requests as the one-card server: {served_equal}; "
            f"K3 launches {out['launches']['data-parallel server']} (1 expected)")
        if not served_equal or out["launches"]["data-parallel server"] != 1:
            fail("data axis (f): the data-parallel server disagrees")

        # (g) the timings
        log(smi)
        log(f"data axis (g), CUDA events: NCCL all_reduce of ResNet-34-8s's "
            f"{out['all_reduce_mb']:.1f} MB of gradients on a world of one "
            f"{out['ms']['all_reduce']:.4f} ms; device-sampler step (B={Bt}, 640x480) single "
            f"{out['ms']['single step']:.3f} ms, data-parallel {out['ms']['data_parallel step']:.3f}"
            f" ms, data-parallel + FSDP {out['ms']['fsdp step']:.3f} ms; pixel-sharded best match "
            f"{out['ms']['pixel-sharded best match']:.4f} ms per call")
    finally:
        distributed.shutdown()
    return out


# -- the model axes of the parallel layer ---------------------------------------------

# phase 17: AXES_TIMED CUDA-event timings of each step; (c)'s microbatches; the
# pipeline's step checked with one microbatch of the 2B images (the oracle's
# forward, batch for batch) and timed with AXES_PP_MICROBATCH as well
AXES_TIMED, AXES_INFER_MB, AXES_PP_MICROBATCH = 3, (1, 2), 4
AXES_PP_TOL = 2e-5  # the pipelined forward against the eval forward (JAX's bar)
AXES_RELOAD_TOL = 1e-6  # a reloaded checkpoint's forward against the live network's
COLLECTIVES = ("all_reduce", "all_gather", "broadcast", "send", "recv", "isend", "irecv",
               "all_gather_object")


class _CollectiveCounter:
    """Counts the torch.distributed calls made inside the block, by kind
    (each function is wrapped and put back on exit)."""

    def __init__(self, dist):
        self.dist, self.counts, self.saved = dist, {}, {}

    def __enter__(self):
        for name in COLLECTIVES:
            fn = getattr(self.dist, name)
            self.saved[name] = fn

            def counted(*args, _fn=fn, _name=name, **kwargs):
                self.counts[_name] = self.counts.get(_name, 0) + 1
                return _fn(*args, **kwargs)
            setattr(self.dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.dist, name, fn)


def _grad_rel(torch, a, b):
    """Relative L2 distance of two modules' gradients, parameter by name."""
    theirs = dict(b.named_parameters())
    num = den = 0.0
    for name, p in a.named_parameters():
        q = theirs[name]
        num += float(((p.grad - q.grad) ** 2).sum())
        den += float((q.grad ** 2).sum())
    return (num / den) ** 0.5


def _event_ms(torch, fn, n):
    """Mean CUDA-event milliseconds of ``n`` calls of ``fn``, each timed on
    its own between two events."""
    times = []
    for _ in range(n):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        e[0].record()
        fn()
        e[1].record()
        torch.cuda.synchronize()
        times.append(e[0].elapsed_time(e[1]))
    return sum(times) / len(times)


def check_model_axes(torch, np, dev, bm, ph, frames_t, tmp, smi):
    """The phase "the model axes": (a)-(f) of the module docstring, on a world
    of one process over NCCL. Returns the launches of each path and the
    timings."""
    import torch.distributed as dist

    from pdc_tpu_torch.apps.serve import DescriptorServer, _Laps, _Request
    from pdc_tpu_torch.data.assembler import AssemblerConfig
    from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
    from pdc_tpu_torch.parallel import (
        distributed,
        make_frozen_bn_train_step,
        make_mesh,
        make_pp_inference,
        make_pp_train_step,
        make_tp_inference,
        make_tp_train_step,
    )
    from pdc_tpu_torch.parallel.tensor_parallel import ColumnParallelConv
    from pdc_tpu_torch.training import train as train_mod
    from pdc_tpu_torch.training.train import make_train_step

    distributed.ensure_initialized(coordinator_address="file://" + os.path.join(tmp, "store17"),
                                   num_processes=1, process_id=0, device="cuda")
    out = {"launches": {}, "ms": {}}
    try:
        tm = make_mesh(("data", "model"), shape=(1, 1))
        pm = make_mesh(("data", "pipe"), shape=(1, 1))
        log(f"model axes: {tm}; {pm}; backend {dist.get_backend()}, world "
            f"{dist.get_world_size()} (one card: every collective runs over NCCL on one rank)")
        if (dist.get_backend() != "nccl" or tm.device.type != "cuda"
                or tm.group("model") is None or pm.group("pipe") is None):
            fail("the model axes are not on NCCL and the card")
        tc = TRAINING_CONFIG
        net_cfg = tc["dense_correspondence_network"]
        loss_cfg = LossConfig.from_dict(tc["loss_function"])
        asm_cfg = AssemblerConfig.from_training_config(tc)
        Ht, Wt = net_cfg["image_height"], net_cfg["image_width"]
        Bt = tc["training"]["batch_size"]

        # (a) TP inference at B=8 against the batch forward
        dcn = DenseCorrespondenceNetwork.from_config(
            net_cfg, generator=torch.Generator().manual_seed(SEED + 17), device="cuda")
        with torch.inference_mode():
            want = dcn.forward_on_images(frames_t["rgb"]).permute(0, 3, 1, 2).contiguous()
        x = dcn.normalize_on_device(frames_t["rgb"]).permute(0, 3, 1, 2).contiguous()
        fwd, sharded = make_tp_inference(dcn.module, tm)()
        n_sharded = sum(isinstance(m, ColumnParallelConv) for m in sharded.modules())
        with torch.inference_mode():
            got = fwd(sharded, x)
            tp_err = float((got - want).abs().max())
            out["ms"]["tp inference"] = time_cuda(torch, lambda: fwd(sharded, x), iters=5)
            out["ms"]["plain inference"] = time_cuda(torch, lambda: dcn.module(x), iters=5)
        log(f"model axes (a): make_tp_inference of {net_cfg['backbone']['resnet_name']} "
            f"({n_sharded} convolutions channel-sharded: each one whose output channels divide "
            f"over the model axis) at B={x.shape[0]} against "
            f"forward_on_images: max|diff| {tp_err:.3g} (bar {DESC_TOL})")
        if not tp_err <= DESC_TOL or n_sharded == 0 or tuple(got.shape) != tuple(want.shape):
            fail("model axes (a): TP inference disagrees with the batch forward")
        del got, want
        torch.cuda.empty_cache()

        # (b) one TP step against the single step; F4's spread from two single steps
        single = make_train_step(tc, loss_cfg, asm_cfg, Wt)
        s1, s2, s_tp = (new_train_state(torch, tc) for _ in range(3))
        assembled = single.assemble(s1, pair_batch(torch, frames_t, *draw_pairs(
            np, np.random.default_rng(SEED + 17), Bt, N_FRAMES)),
            torch.Generator(device=dev).manual_seed(SEED + 17))
        m1 = single.update(s1, *assembled)
        m2 = single.update(s2, *assembled)
        step, s_tp = make_tp_train_step(tc, loss_cfg, asm_cfg, Wt, tm, s_tp)
        ph.forward_launches = ph.backward_launches = 0
        with _CollectiveCounter(dist) as cc:
            m_tp = step.update(s_tp, *assembled)
        torch.cuda.synchronize()
        out["launches"]["tp step"] = (ph.forward_launches, ph.backward_launches)
        spread = _grad_rel(torch, s2.module, s1.module)
        tp_rel = _grad_rel(torch, s_tp.module, s1.module)
        l1, l_tp = float(m1["loss"]), float(m_tp["loss"])
        log(f"model axes (b): make_tp_train_step against make_train_step on one batch: loss "
            f"{l_tp:.8g} vs {l1:.8g} (second single step {float(m2['loss']):.8g}), gradient "
            f"relative L2 {tp_rel:.3g} (F4's spread, two single steps: {spread:.3g}; bar "
            f"{max(AXIS_SPREAD_X * spread, AXIS_PARAM_FLOOR):.3g}); K1/K2 launches "
            f"{out['launches']['tp step']} (2/2 expected); a step's collectives "
            f"{dict(sorted(cc.counts.items()))}")
        if (abs(l_tp - l1) > 1e-6 * abs(l1) or tp_rel > max(AXIS_SPREAD_X * spread,
                                                             AXIS_PARAM_FLOOR)
                or out["launches"]["tp step"] != (2, 2)):
            fail("model axes (b): the TP step disagrees with the single step")
        out["ms"]["single step"] = _event_ms(torch, lambda: single.update(s1, *assembled),
                                             AXES_TIMED)
        out["ms"]["tp step"] = _event_ms(torch, lambda: step.update(s_tp, *assembled),
                                         AXES_TIMED)
        del s1, s2

        # (c) PP inference on a pipe axis of 1 against the eval forward
        pp_err, batch_err = {}, {}
        with torch.inference_mode():
            want = dcn.module(x)
            for mb in AXES_INFER_MB:
                pfwd, pack = make_pp_inference(dcn.module, pm, (Ht, Wt), microbatch=mb)()
                got = pfwd(pack, x)
                # the eval forward a microbatch at a time: cuDNN picks its algorithm by
                # the batch size, so only the same microbatches round alike
                per_mb = torch.cat([dcn.module(x[i:i + mb]) for i in range(0, len(x), mb)])
                pp_err[mb] = float((got - per_mb).abs().max())
                batch_err[mb] = float((got - want).abs().max())
            out["ms"]["pp inference"] = time_cuda(torch, lambda: pfwd(pack, x), iters=5)
        log(f"model axes (c): make_pp_inference at B={x.shape[0]} against the eval forward of "
            f"the same microbatches, max|diff| " + ", ".join(
                f"microbatch {mb}: {e:.3g}" for mb, e in pp_err.items())
            + f" (bar {AXES_PP_TOL}); against the eval forward of the whole batch " + ", ".join(
                f"{batch_err[mb]:.3g}" for mb in AXES_INFER_MB)
            + f" (bar {DESC_TOL}, another batch's cuDNN algorithm; largest |descriptor| "
            f"{float(want.abs().max()):.3g})")
        if not all(e <= AXES_PP_TOL for e in pp_err.values()) or not all(
                e <= DESC_TOL for e in batch_err.values()):
            fail("model axes (c): PP inference disagrees with the eval forward")
        del want, pack, got, per_mb
        torch.cuda.empty_cache()

        # (d) one PP step against the frozen-BN oracle; F4's spread from two oracle steps
        oracle = make_frozen_bn_train_step(tc, loss_cfg, asm_cfg, Wt, (Ht, Wt))
        o1, o2, s_pp = (new_train_state(torch, tc) for _ in range(3))
        mo1 = oracle.update(o1, *assembled)
        oracle.update(o2, *assembled)
        pstep, pp_state, pp_meta = make_pp_train_step(tc, loss_cfg, asm_cfg, Wt, pm, s_pp,
                                                      (Ht, Wt), microbatch=2 * Bt)
        ph.forward_launches = ph.backward_launches = 0
        with _CollectiveCounter(dist) as pc:
            m_pp = pstep.update(pp_state, *assembled)
        torch.cuda.synchronize()
        out["launches"]["pp step"] = (ph.forward_launches, ph.backward_launches)
        o_spread = _grad_rel(torch, o2.module, o1.module)
        pp_rel = _grad_rel(torch, pp_state.stage, o1.module)
        lo, lp = float(mo1["loss"]), float(m_pp["loss"])
        log(f"model axes (d): make_pp_train_step (one microbatch of {2 * Bt} images) against "
            f"make_frozen_bn_train_step: loss {lp:.8g} vs {lo:.8g}, gradient relative L2 "
            f"{pp_rel:.3g} (F4's spread, two oracle steps: {o_spread:.3g}; bar "
            f"{max(AXIS_SPREAD_X * o_spread, AXIS_PARAM_FLOOR):.3g}); K1/K2 launches "
            f"{out['launches']['pp step']} (2/2 expected); a step's collectives "
            f"{dict(sorted(pc.counts.items()))}")
        if (abs(lp - lo) > 1e-6 * abs(lo)
                or pp_rel > max(AXIS_SPREAD_X * o_spread, AXIS_PARAM_FLOOR)
                or out["launches"]["pp step"] != (2, 2)):
            fail("model axes (d): the PP step disagrees with the frozen-BN oracle")
        out["ms"]["oracle step"] = _event_ms(torch, lambda: oracle.update(o1, *assembled),
                                             AXES_TIMED)
        out["ms"]["pp step"] = _event_ms(torch, lambda: pstep.update(pp_state, *assembled),
                                         AXES_TIMED)
        pstep_mb, pp_mb, _ = make_pp_train_step(tc, loss_cfg, asm_cfg, Wt, pm, o2, (Ht, Wt),
                                                microbatch=AXES_PP_MICROBATCH)
        ph.forward_launches = ph.backward_launches = 0
        m_mb = pstep_mb.update(pp_mb, *assembled)
        torch.cuda.synchronize()
        mb_launches = (ph.forward_launches, ph.backward_launches)
        out["ms"]["pp step microbatched"] = _event_ms(
            torch, lambda: pstep_mb.update(pp_mb, *assembled), AXES_TIMED)
        log(f"model axes (d): the PP step with {2 * Bt // AXES_PP_MICROBATCH} microbatches of "
            f"{AXES_PP_MICROBATCH}: loss {float(m_mb['loss']):.8g}, K1/K2 launches "
            f"{mb_launches}")
        if not np.isfinite(float(m_mb["loss"])) or mb_launches != (2, 2):
            fail("model axes (d): the microbatched PP step failed")
        del o1, o2, pp_mb
        torch.cuda.empty_cache()

        # (e) a TP and a PP checkpoint through the trainer's save path, reloaded
        reload_err = {}
        for name, state, mesh in (("tp", s_tp, tm), ("pp", pp_state, pm)):
            trainer = train_mod.DenseCorrespondenceTraining(
                driver_config(tmp, f"axes_{name}"), device="cuda")
            trainer.setup_logging_dir()
            trainer.save_configs()
            trainer._state, trainer._mesh, trainer._pp_meta = state, mesh, pp_meta
            trainer.save_network(1)
            files = set(os.listdir(trainer.logging_dir))
            reloaded = DenseCorrespondenceNetwork.from_model_folder(trainer.logging_dir,
                                                                    device="cuda")
            with torch.inference_mode():
                live = (state.module.eval()(x[:2]) if name == "tp"
                        else state.stage.eval()(x[:2], (Ht, Wt)))
                reload_err[name] = float((reloaded.module(x[:2]) - live).abs().max())
            opt = "000001.ckpt.opt" in files
            log(f"model axes (e): the {name.upper()} checkpoint through save_network reloads "
                f"with from_model_folder: forward max|diff| {reload_err[name]:.3g} (bar "
                f"{AXES_RELOAD_TOL}); .ckpt.opt written: {opt} ({name == 'tp'} expected)")
            if (not reload_err[name] <= AXES_RELOAD_TOL or "000001.ckpt" not in files
                    or opt != (name == "tp")):
                fail(f"model axes (e): the {name.upper()} checkpoint does not reload")
        del s_tp, pp_state, assembled
        torch.cuda.empty_cache()

        # (f) the model_parallel=1 server against the plain server
        frames = frames_t["rgb"][:4].cpu().numpy()
        queries = np.random.default_rng(SEED + 17).standard_normal(
            (SERVE_QUERIES, D)).astype(np.float32)
        answers = []
        for kw in ({}, {"model_parallel": 1}):
            server = DescriptorServer(dcn, port=0, max_batch=4, **kw)
            try:
                batch = [_Request(f, queries if i % 2 else None) for i, f in enumerate(frames)]
                bm.launches = 0
                server._run_batch(batch, _Laps())
                if kw:
                    out["launches"]["tp server"] = bm.launches
                    (_, module), = server._replicas
                    n_server = sum(isinstance(m, ColumnParallelConv) for m in module.modules())
                if any(r.error for r in batch):
                    fail(f"model axes (f): {[r.error for r in batch]}")
                answers.append([r.result for r in batch])
            finally:
                server.shutdown()
        desc_err, bad_picks = 0.0, 0
        for i, (one, two) in enumerate(zip(*answers)):
            if i % 2 == 0:  # a descriptors request
                desc_err = max(desc_err, float(np.abs(one[0] - two[0]).max()))
            else:  # a best_match request: every query slot is valid
                differ = (one[1] != two[1]).any(axis=1)
                bad_picks += int((differ & (np.abs(one[2] - two[2]) > TIE_TOL_D2)).sum())
                desc_err = max(desc_err, float(np.abs(one[2] - two[2]).max()))
        log(f"model axes (f): DescriptorServer(model_parallel=1) ({n_server} convolutions "
            f"sharded over [{dev}]) answers {len(frames)} requests as the plain server: "
            f"max|diff| {desc_err:.3g} (bar {DESC_TOL}), picks apart beyond a near-tie "
            f"{bad_picks}; K3 launches {out['launches']['tp server']} (1 expected)")
        if desc_err > DESC_TOL or bad_picks or out["launches"]["tp server"] != 1 or not n_server:
            fail("model axes (f): the model-parallel server disagrees")

        log(smi)
        ms = out["ms"]
        log(f"model axes, CUDA events ({AXES_TIMED} steps each, B={Bt}, {Wt}x{Ht}): TP step "
            f"{ms['tp step']:.3f} ms against the single step's {ms['single step']:.3f} ms "
            f"({100 * (ms['tp step'] / ms['single step'] - 1):+.1f}%); PP step (1 microbatch) "
            f"{ms['pp step']:.3f} ms, ({2 * Bt // AXES_PP_MICROBATCH} microbatches) "
            f"{ms['pp step microbatched']:.3f} ms, against the frozen-BN oracle's "
            f"{ms['oracle step']:.3f} ms ({100 * (ms['pp step'] / ms['oracle step'] - 1):+.1f}%, "
            f"{100 * (ms['pp step microbatched'] / ms['oracle step'] - 1):+.1f}%); wrapper ms a "
            f"B={x.shape[0]} forward: TP {ms['tp inference']:.3f}, PP (microbatch "
            f"{AXES_INFER_MB[-1]}) {ms['pp inference']:.3f}, plain {ms['plain inference']:.3f}")
    finally:
        distributed.shutdown()
    return out


# -- K steps per dispatch --------------------------------------------------------------

# phase 18: one call of the scanned step (SCAN_K steps: one CUDA graph replayed
# SCAN_K times) against SCAN_K eager DeviceSampledTrainStep calls from clones of the
# same state and generator. The card's step is not bit-reproducible (F4), so the bar
# is F4's spread read in the same call from two eager runs, as phase 16 (b) reads it
# (AXIS_SPREAD_X times it, or the floors)
SCAN_K = 10
SCAN_SMO_MIX = {"SINGLE_OBJECT_WITHIN_SCENE": 0.5, "SINGLE_OBJECT_ACROSS_SCENE": 0,
                "DIFFERENT_OBJECT": 0, "MULTI_OBJECT": 0, "SYNTHETIC_MULTI_OBJECT": 0.5}
# (c): the trainer at the default steps_per_dispatch over two dispatches
SCAN_DRIVER = {"num_iterations": 20, "steps_per_dispatch": 10, "save_rate": 10,
               "logging_rate": 10, "compute_test_loss": False}
SCAN_DP_K = 2  # (d): the data-parallel route's steps a call


def scanned_launches(steps, captures=1, eval_batches=0):
    """(K1, K2) launches of ``steps`` train steps on the device-sampler route:
    2 each a step, 2 each a warm-up step of every capture (the WARMUP_STEPS
    eager steps before a graph is captured, then undone), and K1 2 a
    test-loss batch."""
    from pdc_tpu_torch.training.scanned import WARMUP_STEPS

    k2 = 2 * steps + 2 * WARMUP_STEPS * captures
    return k2 + 2 * eval_batches, k2


def _clone_generator(torch, gen):
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def _scan_case(torch, np, dev, ph, tc, ds, cache, what):
    """(a)/(b) for the training config ``tc``: the graph's call against the
    eager steps. Returns the case's numbers."""
    import copy

    from pdc_tpu_torch.data.assembler import AssemblerConfig
    from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
    from pdc_tpu_torch.training.scanned import (
        make_device_sampled_train_step,
        make_scanned_train_step,
    )

    loss_cfg = LossConfig.from_dict(tc["loss_function"])
    asm_cfg = AssemblerConfig.from_training_config(tc)
    Wt, Bt = tc["dense_correspondence_network"]["image_width"], tc["training"]["batch_size"]
    ds.set_parameters_from_training_config(tc)
    probs = tuple(sorted(ds._data_type_probabilities.items()))
    state = new_train_state(torch, tc)
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    scan = make_scanned_train_step(tc, loss_cfg, asm_cfg, Wt, cache, Bt, SCAN_K,
                                   type_probs=probs)
    if not scan.graphed:
        fail(f"scanned {what}: the step on the card is not graphed")
    torch.cuda.synchronize()
    t = time.perf_counter()
    scan.capture(state, gen)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t
    clones = [(copy.deepcopy(state), _clone_generator(torch, gen)) for _ in range(2)]
    eager = make_device_sampled_train_step(tc, loss_cfg, asm_cfg, Wt, cache, Bt, probs)
    runs = []
    for s, g in clones:
        metrics, events, host = [], [], []
        for _ in range(SCAN_K):
            e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            e[0].record()
            h = time.perf_counter()
            metrics.append(eager(s, g)["loss"])
            host.append(time.perf_counter() - h)
            e[1].record()
            events.append(e)
        torch.cuda.synchronize()
        runs.append({"losses": [float(x) for x in metrics], "state": s, "gen": g,
                     "ms": [a.elapsed_time(b) for a, b in events],
                     "host_ms": [1e3 * x for x in host]})
    ph.forward_launches = ph.backward_launches = 0
    e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    e[0].record()
    h = time.perf_counter()
    m = scan(state, gen)
    host_ms = 1e3 * (time.perf_counter() - h)
    e[1].record()
    torch.cuda.synchronize()
    launches = (ph.forward_launches, ph.backward_launches)
    graph_ms = e[0].elapsed_time(e[1]) / SCAN_K
    losses = [float(x) for x in m["loss"]]

    def spread(losses_a, sa, losses_b, sb):
        worst, rel = _param_spread(torch, sa.module, sb.module)
        return worst, rel, max(abs(x - y) / abs(y) for x, y in zip(losses_a, losses_b))

    f4 = spread(runs[1]["losses"], runs[1]["state"], runs[0]["losses"], runs[0]["state"])
    got = spread(losses, state, runs[0]["losses"], runs[0]["state"])
    same_gen = torch.equal(gen.get_state(), runs[0]["gen"].get_state())
    shapes = {k: tuple(v.shape) for k, v in m.items()}
    eager_ms = float(np.mean(runs[0]["ms"][1:]))
    log(f"scanned {what}: capture {capture_s:.2f} s; one call of {SCAN_K} steps, losses "
        f"{['%.6g' % x for x in losses]}; eager {['%.6g' % x for x in runs[0]['losses']]}; "
        f"graph vs eager: parameters max|diff| {got[0]:.3g}, relative L2 {got[1]:.3g}, losses "
        f"max relative {got[2]:.3g}; F4's spread (two eager runs): {f4[0]:.3g}, {f4[1]:.3g}, "
        f"{f4[2]:.3g} (bar {AXIS_SPREAD_X} x the spread, floors {AXIS_PARAM_FLOOR} and "
        f"{AXIS_LOSS_FLOOR}); generator as the eager run leaves it: {same_gen}; steps "
        f"{state.step} and {runs[0]['state'].step}; metrics {shapes}; K1/K2 launches {launches} "
        f"({2 * SCAN_K} each expected)")
    log(f"scanned {what}: ms per step by CUDA events, eager {eager_ms:.3f} (steps 2-{SCAN_K}; "
        f"{', '.join(f'{x:.1f}' for x in runs[0]['ms'])}) against the graph's {graph_ms:.3f} "
        f"({graph_ms / eager_ms:.3f} x); host ms per call: eager "
        f"{float(np.mean(runs[0]['host_ms'][1:])):.3f} a step, the graph {host_ms:.3f} a "
        f"dispatch of {SCAN_K} steps")
    if (launches != (2 * SCAN_K, 2 * SCAN_K) or not same_gen
            or state.step != runs[0]["state"].step
            or any(v != (SCAN_K,) for v in shapes.values())
            or not all(np.isfinite(x) for x in losses)
            or got[1] > max(AXIS_SPREAD_X * f4[1], AXIS_PARAM_FLOOR)
            or got[2] > max(AXIS_SPREAD_X * f4[2], AXIS_LOSS_FLOOR)):
        fail(f"scanned {what}: the graph's {SCAN_K} steps disagree with {SCAN_K} eager steps")
    return {"capture_s": capture_s, "eager_ms": eager_ms, "graph_ms": graph_ms,
            "host_ms": host_ms, "eager_host_ms": float(np.mean(runs[0]["host_ms"][1:])),
            "launches": launches, "spread": got, "f4": f4}


def check_scanned(torch, np, dev, bm, ph, tmp, smi):
    """The phase "K steps per dispatch": (a)-(d) of the module docstring.
    Returns the launches and timings."""
    import copy

    from pdc_tpu_torch.data.assembler import AssemblerConfig
    from pdc_tpu_torch.data.dataset import SpartanDataset
    from pdc_tpu_torch.data.device_cache import DeviceCache
    from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
    from pdc_tpu_torch.parallel import distributed, make_mesh
    from pdc_tpu_torch.training import train as train_mod
    from pdc_tpu_torch.training.scanned import make_scanned_train_step
    from pdc_tpu_torch.training.schedule import host_lr

    out = {}
    ds = SpartanDataset.make_synthetic(**DATASET_RECORD["synthetic"])
    ds.set_parameters_from_training_config(TRAINING_CONFIG)
    cache = DeviceCache.from_dataset(ds, device=dev)
    # (a) fp32, (b) bf16 and a type-4 mix
    bf16 = copy.deepcopy(TRAINING_CONFIG)
    bf16["dense_correspondence_network"]["compute_dtype"] = "bfloat16"
    smo = copy.deepcopy(TRAINING_CONFIG)
    smo["training"]["data_type_probabilities"] = SCAN_SMO_MIX
    for name, tc in (("fp32", TRAINING_CONFIG), ("bf16", bf16), ("type-4 mix", smo)):
        out[name] = _scan_case(torch, np, dev, ph, tc, ds, cache, name)
        torch.cuda.empty_cache()

    # (c) the trainer on the default steps_per_dispatch: pdc_tpu's cadence
    cfg = driver_config(tmp, "scanned", **SCAN_DRIVER)
    ds.set_parameters_from_training_config(cfg)
    trainer = train_mod.DenseCorrespondenceTraining(cfg, ds, device=dev)
    called = []
    ph.forward_launches = ph.backward_launches = 0
    t = time.perf_counter()
    folder = trainer.run(progress_callback=lambda it, m: called.append(it))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches = (ph.forward_launches, ph.backward_launches)
    n_iter, k = SCAN_DRIVER["num_iterations"], SCAN_DRIVER["steps_per_dispatch"]
    tl = trainer._logging_dict["train"]
    ckpts = sorted(f for f in os.listdir(folder) if f.endswith(".ckpt"))
    want_ckpts = [f"{i:06d}.ckpt" for i in range(0, n_iter + 1, SCAN_DRIVER["save_rate"])]
    lr_ok = tl["learning_rate"] == [host_lr(cfg, i) for i in range(1, n_iter + 1)]
    log(f"scanned (c): DenseCorrespondenceTraining.run, {n_iter} iterations at "
        f"steps_per_dispatch {k}: route {trainer.route!r}, callback at {called}, iterations "
        f"logged {tl['iteration'][0]}..{tl['iteration'][-1]} ({len(tl['loss'])} losses, LRs as "
        f"host_lr: {lr_ok}), checkpoints {ckpts}, host seconds a call "
        f"{[round(x, 3) for x in trainer.step_seconds]}, whole run {run_s:.2f} s; K1/K2 "
        f"launches {launches} ({scanned_launches(n_iter)} expected)")
    if (trainer.route != train_mod.ROUTE_DEVICE_SAMPLER or called != list(range(k, n_iter + 1, k))
            or tl["iteration"] != list(range(1, n_iter + 1)) or not lr_ok
            or len(tl["loss"]) != n_iter or not all(np.isfinite(x) for x in tl["loss"])
            or ckpts != want_ckpts or len(trainer.step_seconds) != n_iter // k
            or launches != scanned_launches(n_iter)):
        fail("scanned (c): the trainer did not keep pdc_tpu's cadence on the device sampler")
    _, out["k3_err"] = check_reload(torch, np, bm, dev, folder, trainer,
                                    ds.scenes["scene_000"], "scanned (c)")
    out["driver"] = {"launches": launches, "run_s": run_s, "call_s": trainer.step_seconds}
    del trainer
    torch.cuda.empty_cache()

    # (d) the data-parallel route on a world of one over NCCL
    distributed.ensure_initialized(coordinator_address="file://" + os.path.join(tmp, "store18"),
                                   num_processes=1, process_id=0, device="cuda")
    try:
        mesh = make_mesh()
        tc = TRAINING_CONFIG
        ds.set_parameters_from_training_config(tc)
        scan = make_scanned_train_step(
            tc, LossConfig.from_dict(tc["loss_function"]),
            AssemblerConfig.from_training_config(tc),
            tc["dense_correspondence_network"]["image_width"], cache,
            tc["training"]["batch_size"], SCAN_DP_K, mesh=mesh, type_probs=((0, 1.0),))
        state = new_train_state(torch, tc)
        gen = torch.Generator(device=dev).manual_seed(SEED + 18)
        ph.forward_launches = ph.backward_launches = 0
        m = scan(state, gen)
        torch.cuda.synchronize()
        dp = (ph.forward_launches, ph.backward_launches)
        log(f"scanned (d): the data-parallel route over NCCL (world of one): "
            f"{'one CUDA graph' if scan.graphed else 'not captured: its K steps run eagerly in the one call'}"
            f"; {SCAN_DP_K} steps, losses {[round(float(x), 6) for x in m['loss']]}, K1/K2 "
            f"launches {dp}, recorded {scan.launches_per_dispatch}")
        if (scan.graphed or dp != (2 * SCAN_DP_K,) * 2 or tuple(m["loss"].shape) != (SCAN_DP_K,)
                or not bool(torch.isfinite(m["loss"]).all())):
            fail("scanned (d): the data-parallel route failed")
        out["dp"] = {"launches": dp, "graphed": scan.graphed}
    finally:
        distributed.shutdown()
    log(smi)
    for name in ("fp32", "bf16", "type-4 mix"):
        c = out[name]
        log(f"scanned {name} (ResNet-34-8s 640x480 B=4): eager {c['eager_ms']:.3f} ms a step, "
            f"graph {c['graph_ms']:.3f} ms a step (CUDA events); host {c['eager_host_ms']:.3f} "
            f"ms a step call against {c['host_ms']:.3f} ms a dispatch of {SCAN_K}; capture "
            f"{c['capture_s']:.2f} s")
    return out


def flatten(tree, prefix=""):
    """{'a/b': leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def main():
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    here = os.path.dirname(os.path.abspath(__file__))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke run needs an NVIDIA GPU")
    try:
        import pdc_tpu_torch
    except ImportError as e:
        fail(f"pdc_tpu_torch not importable ({e}): run from the root of a checkout")
    if os.path.dirname(os.path.dirname(os.path.abspath(pdc_tpu_torch.__file__))) != here:
        fail(f"pdc_tpu_torch imported from {pdc_tpu_torch.__file__}, not from this checkout")
    from pdc_tpu_torch.apps.serve import DescriptorClient, DescriptorServer, _Laps, _Request
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
    from pdc_tpu_torch.ops import _build
    from pdc_tpu_torch.ops import best_match as bm
    from pdc_tpu_torch.ops import pooled_hinge as ph

    # 1. environment ----------------------------------------------------------
    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    log(smi)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    log(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    phase("environment", t0)

    # 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    for name, secs in _build.build_all().items():
        log(f"built {name}: {secs:.2f} s -> {_build.library_path(name).relative_to(here)}")
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  nvcc: {line.strip()}")
    bm._library()
    ph._library()
    hinge_ptxas = kernel_templates(_build, "pooled_hinge")
    log("K1 templates (ptxas): " + templates_text(
        {k: v for k, v in hinge_ptxas.items() if k.startswith("hinge_fwd")}))
    log("K2 templates (ptxas): " + templates_text(
        {k: v for k, v in hinge_ptxas.items() if k.startswith("hinge_bwd")}))
    log("K3 templates (ptxas): " + templates_text(kernel_templates(_build, "best_match")))
    phase("build", t0)

    # 3. kernel against plain version -------------------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    cfg = {"descriptor_dimension": D, "image_width": W, "image_height": H,
           "backbone": {"model_class": "Resnet", "resnet_name": "Resnet34_8s"}}
    dcn = DenseCorrespondenceNetwork.from_config(
        cfg, generator=torch.Generator().manual_seed(SEED), device="cuda")
    frames = rng.integers(0, 256, size=(N_FRAMES, H, W, 3), dtype=np.uint8)
    mean = torch.as_tensor(dcn.image_mean, dtype=torch.float32, device=dev)
    std = torch.as_tensor(dcn.image_std_dev, dtype=torch.float32, device=dev)
    with torch.inference_mode():
        x = (torch.from_numpy(frames).to(dev).float() / 255.0 - mean) / std
        x = x.permute(0, 3, 1, 2).contiguous()
        images = dcn.module(x).reshape(N_FRAMES, D, H * W)  # [8, D, HW] planar
    torch.cuda.synchronize()

    def image_queries(b_src, n_other, n_self, b_self):
        """Descriptors of frame b_src at random pixels (a match from another
        view) and of frame b_self itself (exact matches, distance 0)."""
        p1 = torch.as_tensor(rng.integers(0, H * W, n_other), device=dev)
        p2 = torch.as_tensor(rng.integers(0, H * W, n_self), device=dev)
        return torch.cat([images[b_src][:, p1].t(), images[b_self][:, p2].t()]).contiguous()

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=dev)

    cases = [
        ("random HW=3072 Q=8 D=16", randn(1, 16, 3072), randn(1, 8, 16)),
        ("random HW=5000 Q=4 D=3", randn(1, 3, 5000), randn(1, 4, 3)),
        ("640x480 D=3 Q=1", images[:1].contiguous(), image_queries(1, 1, 0, 0)[None]),
        ("640x480 D=3 Q=16", images[:1].contiguous(), image_queries(1, 8, 8, 0)[None]),
        ("640x480 D=3 Q=1024", images[:1].contiguous(), image_queries(1, 512, 512, 0)[None]),
        ("640x480 D=3 B=8 Q=16", images.contiguous(),
         torch.stack([image_queries((b + 1) % N_FRAMES, 8, 8, b) for b in range(N_FRAMES)])),
        # HW % 4 != 0: the kernel's scalar loads
        ("random HW=5001 Q=16 D=3", randn(1, 3, 5001), randn(1, 16, 3)),
        ("640x480 less one pixel D=3 B=8 Q=17", images[:, :, :H * W - 1].contiguous(),
         torch.stack([image_queries((b + 1) % N_FRAMES, 8, 9, b) for b in range(N_FRAMES)])),
    ]
    max_abs_err = 0.0
    for name, res, q in cases:
        idx_k, dist_k = bm.best_match(res, q)
        torch.cuda.synchronize()
        idx_p, dist_p = bm.best_match_reference(res, q)
        bad_k, err_k = check_matches(torch, bm, res, q, idx_k, dist_k)
        bad_p, err_p = check_matches(torch, bm, res, q, idx_p, dist_p)
        vs_plain = float((dist_k - dist_p).abs().max())
        same = float((idx_k == idx_p).float().mean())
        max_abs_err = max(max_abs_err, vs_plain)
        log(f"kernel {name}: bad_idx {bad_k} dist_err {err_k:.3g} | vs plain: "
            f"max|dist diff| {vs_plain:.3g}, same idx {same:.4f} "
            f"(plain: bad_idx {bad_p} dist_err {err_p:.3g})")
        if bad_k or not err_k <= DIST_TOL or not vs_plain <= PLAIN_TOL:
            fail(f"kernel disagrees on {name}")
    del cases
    torch.cuda.empty_cache()
    phase("kernel vs plain", t0)

    # 4. pooled hinge kernels (K1, K2) against their plain version -------------
    t0 = time.perf_counter()
    Bh, Nm, P = HINGE_B, HINGE_NM, HINGE_P

    def image_rows(n, frame_of):
        """Rows of the net's 640x480 descriptor images at random pixels."""
        px = torch.as_tensor(rng.integers(0, H * W, (Bh, n)), device=dev)
        return torch.stack([images[frame_of(b)][:, px[b]].t() for b in range(Bh)]).contiguous()

    hinge_cases = [
        ("random rows (scale 0.3) B=4 Nm=10000 P=1024 D=3",
         hinge_inputs(torch, np, rng, dev, Bh, Nm, P)),
        ("rows of 640x480 descriptor images B=4 Nm=10000 P=1024 D=3",
         hinge_inputs(torch, np, rng, dev, Bh, Nm, P, da=image_rows(Nm, lambda b: b),
                      db=image_rows(P, lambda b: b))),
        ("collision-heavy (pixels in [0, 8)^2)",
         hinge_inputs(torch, np, rng, dev, Bh, Nm, P, coord_max=8)),
        ("all rows invalid", hinge_inputs(torch, np, rng, dev, Bh, Nm, P, valid_frac=0.0)),
        ("ragged B=3 Nm=777 P=1000 D=16", hinge_inputs(torch, np, rng, dev, 3, 777, 1000, Dd=16)),
        ("most pairs count: random rows at scale 0.05, B=4 Nm=10000 P=1024 D=3",
         hinge_inputs(torch, np, rng, dev, Bh, Nm, P, scale=0.05)),
    ]
    base = hinge_inputs(torch, np, rng, dev, Bh, Nm, P)
    hinge_cases += [(f"{name} (fault F5), B=4 Nm=10000 P=1024 D=3",
                     nonfinite_inputs(torch, base, placements))
                    for name, placements in F5_CASES]
    k1_err = k2_err = 0.0
    for name, args in hinge_cases:
        for use_pix in (False, True):
            e1, e2 = check_pooled_hinge(torch, ph, name, args, use_pix)
            k1_err, k2_err = max(k1_err, e1), max(k2_err, e2)
    del hinge_cases, base
    torch.cuda.empty_cache()
    phase("pooled hinge vs plain", t0)

    # 5. the main path, serving ---------------------------------------------------
    t0 = time.perf_counter()
    n_req = N_CLIENTS * REQUESTS_PER_CLIENT
    plan = []  # (frame, queries or None)
    for r in range(n_req):
        f = r % N_FRAMES
        if r % 2:
            q = image_queries((f + 1) % N_FRAMES, SERVE_QUERIES // 2, SERVE_QUERIES // 2, f)
            plan.append((f, q.cpu().numpy()))
        else:
            plan.append((f, None))
    server = DescriptorServer(dcn, host="127.0.0.1", port=0, max_batch=8, max_wait_ms=20.0)
    results, latencies, errors = [None] * n_req, [None] * n_req, []
    try:
        server.warmup()
        server.start()
        host, port = server.address
        barrier = threading.Barrier(N_CLIENTS)

        def client(c):
            try:
                with DescriptorClient(host, port, timeout=60.0) as cl:
                    if not cl.ping():
                        raise RuntimeError("ping failed")
                    barrier.wait(timeout=60.0)
                    for r in range(c, n_req, N_CLIENTS):
                        f, q = plan[r]
                        t = time.perf_counter()
                        results[r] = (cl.descriptors(frames[f]) if q is None
                                      else cl.best_match(frames[f], q))
                        latencies[r] = time.perf_counter() - t
            except Exception as e:
                errors.append(f"client {c}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(N_CLIENTS)]
        before = dict(server.stats)
        bm.launches = 0
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        launches = bm.launches
        after = dict(server.stats)
        if any(t.is_alive() for t in threads):
            fail("a client thread did not finish")
        # one client alone, request after request: latency without queueing
        seq = {"descriptors": [], "best_match": []}
        with DescriptorClient(host, port, timeout=60.0) as cl:
            info = cl.info()
            for r in range(2 * N_FRAMES):
                f, q = plan[r]
                t = time.perf_counter()
                cl.descriptors(frames[f]) if q is None else cl.best_match(frames[f], q)
                seq["descriptors" if q is None else "best_match"].append(time.perf_counter() - t)
    finally:
        server.shutdown()
    if errors:
        fail("; ".join(errors))
    if any(r is None for r in results):
        fail("a request got no answer")
    delta = {k: after[k] - before[k] for k in after}
    log(f"serving: {n_req} requests from {N_CLIENTS} clients, all ok; stats {delta}; "
        f"info {info['height']}x{info['width']} D={info['descriptor_dimension']}; "
        f"best_match kernel launches {launches}")
    if not launches > 0 or launches != delta["match_dispatches"]:
        fail(f"best_match launches {launches} != dispatches with queries "
             f"{delta['match_dispatches']}")

    desc_err, bad_total, dist_err = 0.0, 0, 0.0
    for r, (f, q) in enumerate(plan):
        want = dcn.forward_on_img(frames[f])  # [H, W, D] on the card
        if q is None:
            got = torch.from_numpy(np.array(results[r])).to(dev)
            if got.shape != want.shape or not torch.isfinite(got).all():
                fail(f"request {r}: descriptors of shape {tuple(got.shape)} or not finite")
            desc_err = max(desc_err, float((got - want).abs().max()))
            if not torch.allclose(got, want, atol=DESC_TOL, rtol=DESC_TOL):
                fail(f"request {r}: served descriptors differ from forward_on_img")
        else:
            uv, dist = results[r]
            res = want.permute(2, 0, 1).reshape(1, D, H * W).contiguous()
            qt = torch.from_numpy(q).to(dev)[None]
            idx = torch.from_numpy(uv[:, 1] * W + uv[:, 0]).to(dev)[None]
            bad, err = check_matches(torch, bm, res, qt,
                                     idx, torch.from_numpy(np.array(dist)).to(dev)[None])
            bad_total += bad
            dist_err = max(dist_err, err)
    log(f"serving answers: descriptors max|diff| {desc_err:.3g} vs forward_on_img; "
        f"best_match bad_idx {bad_total} dist_err {dist_err:.3g} vs plain on that image")
    if bad_total or not dist_err <= DIST_TOL:
        fail("served best matches disagree with the plain version")
    lat = [x for x in latencies if x is not None]
    phase("serving", t0)

    # 6. the main path, training -------------------------------------------------
    t0 = time.perf_counter()
    from pdc_tpu_torch.data.assembler import AssemblerConfig
    from pdc_tpu_torch.data.synthetic import SyntheticScene
    from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
    from pdc_tpu_torch.training.train import build_loss_fn, make_train_step, pick_assembly

    tc = TRAINING_CONFIG
    net_cfg = tc["dense_correspondence_network"]
    Bt = tc["training"]["batch_size"]
    loss_cfg = LossConfig.from_dict(tc["loss_function"])
    asm_cfg = AssemblerConfig.from_training_config(tc)
    Ht, Wt = net_cfg["image_height"], net_cfg["image_width"]
    scene = SyntheticScene(width=Wt, height=Ht, num_frames=N_FRAMES)
    t_render = time.perf_counter()
    frames_t = device_frames(torch, np, dev, scene)
    log(f"synthetic scene: {N_FRAMES} frames {Wt}x{Ht} rendered and on the card in "
        f"{time.perf_counter() - t_render:.2f} s; object pixels per frame "
        f"{frames_t['count'].tolist()}")

    state = new_train_state(torch, tc)
    initial = {k: v.detach().clone() for k, v in state.module.state_dict().items()}
    step = make_train_step(tc, loss_cfg, asm_cfg, Wt)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pair_rng = np.random.default_rng(SEED)
    batches = [pair_batch(torch, frames_t, *draw_pairs(np, pair_rng, Bt, N_FRAMES))
               for _ in range(TRAIN_STEPS)]
    ph.forward_launches = ph.backward_launches = 0
    history = [{k: float(v) for k, v in step(state, b, gen).items()} for b in batches]
    torch.cuda.synchronize()
    k1_launches, k2_launches = ph.forward_launches, ph.backward_launches
    for i, m in enumerate(history):
        log(f"train step {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in m.items()))
    if not all(np.isfinite(v) for m in history for v in m.values()):
        fail("a training metric is not finite")
    still = [k for k, v in state.module.named_parameters()
             if v.dim() > 1 and torch.equal(v.detach(), initial[k])]
    log(f"training: {net_cfg['backbone']['resnet_name']} D={net_cfg['descriptor_dimension']} "
        f"{Wt}x{Ht} B={Bt}, {TRAIN_STEPS} steps through "
        f"make_train_step; weight tensors unchanged: {len(still)}; launches K1 "
        f"{k1_launches}, K2 {k2_launches} (2 per step expected)")
    if still:
        fail(f"training left weights unchanged: {still[:5]}")
    if k1_launches != 2 * TRAIN_STEPS or k2_launches != 2 * TRAIN_STEPS:
        fail(f"K1/K2 launched {k1_launches}/{k2_launches} times in {TRAIN_STEPS} steps, "
             f"not 2 per step each")

    # one step with the kernels and one with the plain hinge, same batch and weights
    assembled = step.assemble(state, pair_batch(torch, frames_t, *draw_pairs(
        np, pair_rng, Bt, N_FRAMES)), torch.Generator(device=dev).manual_seed(SEED + 1))
    compare_kernel_and_plain_steps(torch, tc, assembled, "train step")
    torch.cuda.empty_cache()
    phase("training", t0)

    # 7. the main path, the training driver -------------------------------------
    t0 = time.perf_counter()
    driver = check_training_driver(torch, np, dev, here, bm, ph)
    torch.cuda.empty_cache()
    phase("training driver", t0)

    # 8. the main path from disk: python -m pdc_tpu_torch train --------------------
    import shutil
    import tempfile
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    tree = tempfile.mkdtemp(prefix="chip_smoke_on_disk_", dir=os.path.join(here, "build"))
    try:
        t0 = time.perf_counter()
        on_disk = check_on_disk_training(torch, np, dev, bm, ph, tree)
        on_disk["phase_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        phase("on-disk training", t0)

        # 9. the main path's evaluation: python -m pdc_tpu_torch evaluate -------------
        t0 = time.perf_counter()
        evaluation = check_evaluation(torch, np, dev, here, bm, on_disk["folder"])
        evaluation["phase_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        phase("evaluation", t0)

        # 10. the per-pair loss and synthetic multi-object samples --------------------
        t0 = time.perf_counter()
        pair_smo = check_per_pair_and_smo(torch, np, dev, here, bm, ph, frames_t,
                                          on_disk["folder"])
        pair_smo["phase_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        phase("per-pair and synthetic multi-object", t0)

        # 11. the apps on phase 8's folder and tree ----------------------------------
        t0 = time.perf_counter()
        apps = check_apps(torch, np, dev, bm, on_disk, tree)
        apps["phase_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        phase("apps", t0)

        # 13. model variants and int8 (on phase 8's folder, so before the timings)
        t0 = time.perf_counter()
        variants = check_variants_and_int8(torch, np, dev, bm, ph, frames_t, on_disk, tree)
        torch.cuda.empty_cache()
        phase("model variants and int8", t0)

        # 14. compute dtype, remat and preprocessing ------------------------------------
        t0 = time.perf_counter()
        dtype14 = check_compute_dtype_and_preprocess(torch, np, dev, ph, frames_t, tree)
        dtype14["phase_s"] = time.perf_counter() - t0
        phase("compute dtype, remat and preprocessing", t0)

        # 15. dataset tooling and experiments, on phase 8's tree -------------------------
        t0 = time.perf_counter()
        tooling = check_tooling_and_experiments(torch, np, dev, bm, ph, on_disk, tree, smi)
        torch.cuda.empty_cache()
        phase("dataset tooling and experiments", t0)

        # 16. the data axis of the parallel layer, on a world of one over NCCL ------------
        t0 = time.perf_counter()
        axis = check_data_axis(torch, np, dev, bm, ph, frames_t, on_disk,
                               dtype14["preprocess"]["render_inputs"], tree, smi)
        torch.cuda.empty_cache()
        phase("the data axis", t0)

        # 17. the model axes of the parallel layer, on a world of one over NCCL -----------
        t0 = time.perf_counter()
        axes = check_model_axes(torch, np, dev, bm, ph, frames_t, tree, smi)
        torch.cuda.empty_cache()
        phase("the model axes", t0)

        # 18. K steps per dispatch: the scanned step's CUDA graph against eager steps
        t0 = time.perf_counter()
        scan18 = check_scanned(torch, np, dev, bm, ph, tree, smi)
        torch.cuda.empty_cache()
        phase("K steps per dispatch", t0)
    finally:
        shutil.rmtree(tree, ignore_errors=True)

    # 12. timings ---------------------------------------------------------------
    t0 = time.perf_counter()
    log(smi)
    # Kernel times are device times (time_device: the queue primed before
    # the start event); "wrapper" is the host-paced time of one Python call
    # from an idle queue (time_cuda), what a caller waits for one call.
    empty_ms = time_device(torch, lambda: torch.cuda._sleep(0), iters=50)
    log(f"an empty kernel's launch (torch.cuda._sleep(0)), back to back: {empty_ms:.5f} ms "
        f"device time per launch")
    res1 = images[:1].contiguous()
    entry = None
    for B, Q in ((1, 16), (8, 16), (1, 1024)):
        res = images[:B].contiguous()
        q = torch.stack([image_queries((b + 1) % N_FRAMES, Q // 2, Q - Q // 2, b)
                         for b in range(B)])
        k_ms = time_device(torch, lambda: bm.best_match(res, q))
        w_ms = time_cuda(torch, lambda: bm.best_match(res, q))
        p_ms = time_device(torch, lambda: bm.best_match_reference(res, q), iters=5)
        split = profile_split(torch, lambda: bm.best_match(res, q))
        lib_ms = None
        if B == 1:
            flat, q0 = res1[0].t(), q[0]

            def library():
                dmat = torch.cdist(flat, q0)  # [HW, Q]
                i = dmat.argmin(dim=0)
                return i, dmat.gather(0, i[None])
            lib_ms = time_device(torch, library, iters=5)
        b_ms, b_by = bound(B, Q, D, H * W)
        slices, groups, per_group, steps = bm.plan(B, D, H * W, Q, dev)
        log(f"best_match B={B} Q={Q} grid {slices} slices of {steps} x 1024 pixels x {groups} "
            f"groups of {per_group} queries x {B} images = {slices * groups * B} blocks of 256 "
            f"threads")
        log(f"best_match B={B} Q={Q} 640x480 D=3: kernel device {k_ms:.5f} ms, wrapper "
            f"{w_ms:.5f} ms per call, plain {p_ms:.4f} ms, cdist+argmin "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} (device), bound {b_ms:.5f} ms "
            f"({b_by}), kernel at {100 * b_ms / k_ms:.1f}% of bound; {split_text(split)}")
        if (B, Q) == (1, 16):
            entry = {"name": "best_match", "route": "cuda",
                     "source": "pdc_tpu_torch/csrc/best_match.cu",
                     "replaces": "pdc_tpu/ops/pallas_kernels.py:30",
                     "launches": launches,
                     "launches_by_path": {"serving": launches,
                                          "evaluation": evaluation["launches"],
                                          "grasp stream": apps["launches"],
                                          "int8 server": variants["k3_server"],
                                          "int8 grasp stream": variants["k3_stream"],
                                          "experiment": tooling["k3"],
                                          "experiment from disk": tooling["k3_disk"],
                                          "data axis: pixel-sharded best match":
                                              axis["launches"]["pixel-sharded best match"],
                                          "data axis: mesh= evaluation":
                                              axis["launches"]["mesh= evaluation"],
                                          "data axis: data-parallel server":
                                              axis["launches"]["data-parallel server"],
                                          "model axes: tp server":
                                              axes["launches"]["tp server"]},
                     "max_abs_err": max(max_abs_err, driver["k3_err"], on_disk["k3_err"],
                                        evaluation["k3_err"], pair_smo["k3_err"],
                                        apps["k3_err"], variants["k3_err"],
                                        tooling["k3_err"], axis["k3_err"]),
                     "ms": k_ms, "device_ms": k_ms, "wrapper_ms": w_ms, "plain_ms": p_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                     "empty_launch_ms": empty_ms,
                     "evaluation_shape": {k: v for k, v in evaluation["k3"].items()
                                          if k != "split"}}
    with torch.inference_mode():
        for B in (1, 8):
            xb = x[:B].contiguous()
            ms = time_cuda(torch, lambda: dcn.module(xb), iters=10)
            log(f"forward ResNet-34-8s fp32 B={B} 640x480: {ms:.3f} ms, {1e3 * B / ms:.1f} images/s")
    log(f"serving request latency (client wall clock, max_wait_ms 20): {len(lat)} requests "
        f"from {N_CLIENTS} concurrent clients, mean {1e3 * sum(lat) / len(lat):.2f} ms; "
        + "; ".join(f"one client alone, {op} mean {1e3 * sum(v) / len(v):.2f} ms"
                    for op, v in seq.items()))
    # one dispatch of the server (host clock, ends in the device->host copy)
    server = DescriptorServer(dcn, host="127.0.0.1", port=0, max_batch=8)
    try:
        for n, with_q in ((1, True), (8, True), (1, False), (8, False)):
            times = []
            for _ in range(5):
                batch = [_Request(frames[i], plan[1][1] if with_q else None) for i in range(n)]
                t = time.perf_counter()
                server._run_batch(batch, _Laps())
                times.append(time.perf_counter() - t)
                if any(r.error for r in batch):
                    fail(f"dispatch failed: {batch[0].error}")
            log(f"server dispatch of {n} {'best_match' if with_q else 'descriptors'} "
                f"request(s): median {1e3 * sorted(times)[2]:.2f} ms")
    finally:
        server.shutdown()

    # training step: the whole step, then its parts, each between CUDA events
    def events(n):
        return [torch.cuda.Event(enable_timing=True) for _ in range(n)]

    step_ms, wall = [], []
    for _ in range(TRAIN_TIMED_STEPS):
        batch = pair_batch(torch, frames_t, *draw_pairs(np, pair_rng, Bt, N_FRAMES))
        e = events(2)
        t = time.perf_counter()
        e[0].record()
        step(state, batch, gen)
        e[1].record()
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t))
        step_ms.append(e[0].elapsed_time(e[1]))
    parts = {"assembly": [], "forward+backward": [], "optimizer": []}
    captured = []

    def capture(*args):
        captured.append([a.detach() for a in args[:8]])
        return ph.pooled_hinge(*args)

    loss_fn = build_loss_fn(state.module, loss_cfg, Wt, pick_assembly(asm_cfg, hinge=capture)[1])
    for _ in range(TRAIN_TIMED_STEPS):
        batch = pair_batch(torch, frames_t, *draw_pairs(np, pair_rng, Bt, N_FRAMES))
        e = events(4)
        e[0].record()
        assembled = step.assemble(state, batch, gen)
        e[1].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss, _ = loss_fn(*assembled)
        loss.backward()
        e[2].record()
        state.optimizer.step()
        e[3].record()
        torch.cuda.synchronize()
        for k, (a, b) in zip(parts, ((0, 1), (1, 2), (2, 3))):
            parts[k].append(e[a].elapsed_time(e[b]))
    mean_step = sum(step_ms) / len(step_ms)
    log(smi)
    log(f"train step {net_cfg['backbone']['resnet_name']} fp32 {Wt}x{Ht} B={Bt} (CUDA events, "
        f"{TRAIN_TIMED_STEPS} steps after {TRAIN_STEPS + 1} warm-up): {mean_step:.3f} ms "
        f"[{', '.join(f'{x:.3f}' for x in step_ms)}], {1e3 * Bt / mean_step:.2f} pairs/s; "
        f"host wall clock {sum(wall) / len(wall):.3f} ms")
    split = {k: sum(v) / len(v) for k, v in parts.items()}
    log("train step split (separate steps, CUDA events): " + ", ".join(
        f"{k} {v:.3f} ms ({100 * v / sum(split.values()):.1f}%)" for k, v in split.items()))
    # the driver's steps on each route, host clock, against make_train_step's
    log(f"training driver, device sampler, {len(driver['step_ms'])} calls of "
        f"{DRIVER_OVERRIDES['steps_per_dispatch']} steps: host ms per call (no "
        f"synchronisation; the first captures the graph) "
        f"[{', '.join(f'{x:.1f}' for x in driver['step_ms'])}], whole run {driver['run_s']:.2f} s; "
        f"checkpoint writes (.ckpt {driver['sizes']['000006.ckpt'] / 1e6:.1f} MB + .ckpt.opt "
        f"{driver['sizes']['000006.ckpt.opt'] / 1e6:.1f} MB + the yaml files) "
        f"[{', '.join(f'{x:.0f}' for x in driver['save_ms'])}] ms")
    disk_ms, drv_ms = on_disk["step_ms"], driver["step_ms"]
    log(f"on-disk training ({on_disk['route']!r}, decoder {on_disk['decoder']}): host ms per "
        f"call [{', '.join(f'{x:.1f}' for x in disk_ms)}], calls 2-{len(disk_ms)} mean "
        f"{sum(disk_ms[1:]) / len(disk_ms[1:]):.1f} ms against the training driver's "
        f"{sum(drv_ms[1:]) / len(drv_ms[1:]):.1f} ms on the in-memory dataset; whole run "
        f"{on_disk['run_s']:.2f} s against {driver['run_s']:.2f} s; tree written in "
        f"{on_disk['write_s']:.2f} s and read back in {on_disk['read_s']:.2f} s; phase "
        f"{on_disk['phase_s']:.2f} s")
    for dec, c in on_disk["codec"].items():
        log(f"PNG codec {dec}, ms per 640x480 frame (RGB + depth + mask): write "
            f"{c['write_ms']:.2f}, decode {c['decode_ms']:.2f} (one frame alone); write "
            f"{c['write_ms_batched']:.2f}, decode {c['decode_ms_batched']:.2f} (12 frames in "
            f"one call); an RGB file of Paeth rows alone: decode {c['paeth_rgb_decode_ms']:.2f}")
    k3e, tot = evaluation["k3"], evaluation["totals"]
    log(f"best_match at the evaluation sweep's shape B={k3e['B']} Q={k3e['Q']} HW={k3e['HW']} "
        f"D=3: kernel device {k3e['ms']:.5f} ms, wrapper {k3e['wrapper_ms']:.5f} ms per call, "
        f"plain {k3e['plain_ms']:.4f} ms, cdist+argmin {k3e['library_ms']:.4f} ms (device), "
        f"bound {k3e['bound_ms']:.5f} ms ({k3e['bound_by']}), kernel at "
        f"{100 * k3e['bound_ms'] / k3e['ms']:.1f}% of bound; {split_text(k3e['split'])}")
    sweep_parts = ("forwards", "correspondences", "statistics")
    log(f"evaluation (python -m pdc_tpu_torch evaluate, {EVAL_PAIRS} pairs x {EVAL_MATCHES} "
        f"matches in each split; pairs kept {evaluation['pairs']}, rows {evaluation['rows']}): "
        f"command {evaluation['run_s']:.2f} s; the two sweeps {tot['sweep']:.3f} s, of which "
        + ", ".join(f"{k} {tot.get(k, 0.0):.3f} s" for k in sweep_parts)
        + f" (host clock, synchronised at each part), rest "
        f"{tot['sweep'] - sum(tot.get(k, 0.0) for k in sweep_parts):.3f} s; descriptor "
        f"statistics {tot.get('descriptor statistics', 0.0):.3f} s, across objects "
        f"{tot.get('across objects', 0.0):.3f} s; K3 launches {evaluation['launches']}; phase "
        f"{evaluation['phase_s']:.2f} s")
    for route, r in driver["routes"].items():
        mean_route = sum(r["step_ms"]) / len(r["step_ms"])
        log(f"training driver route {route!r}: host wall clock per step of the calls after the "
            f"first (synchronised at each call's end; {ROUTE_STEPS} steps) "
            f"[{', '.join(f'{x:.2f}' for x in r['step_ms'])}] ms, mean {mean_route:.2f} ms = "
            f"{mean_route / mean_step:.3f} x make_train_step's {mean_step:.3f} ms of CUDA-event "
            f"step time; K1/K2 launches {r['launches']}")

    # the per-pair step and a synthetic multi-object batch's assembly
    pt = time_per_pair_and_smo(torch, pair_smo["per_pair"], pair_smo["smo"])
    pp_mean = sum(pt["step_ms"]) / len(pt["step_ms"])
    log(smi)
    log(f"per-pair train step {net_cfg['backbone']['resnet_name']} fp32 {Wt}x{Ht} B={Bt} "
        f"(CUDA events, {TRAIN_TIMED_STEPS} steps after {PER_PAIR_STEPS + 1} warm-up): "
        f"{pp_mean:.3f} ms [{', '.join(f'{x:.3f}' for x in pt['step_ms'])}], "
        f"{1e3 * Bt / pp_mean:.2f} pairs/s, {pp_mean / mean_step:.3f} x the matrix step's "
        f"{mean_step:.3f} ms")
    total = sum(pt["parts"].values())
    log("per-pair train step split (separate steps, CUDA events): " + ", ".join(
        f"{k} {v:.3f} ms ({100 * v / total:.1f}%)" for k, v in pt["parts"].items())
        + f"; forward+backward {pt['parts']['forward'] + pt['parts']['backward']:.3f} ms "
        f"(the backward includes the loss's index_add over {pt['rows']} non-match rows and "
        f"the match and blind rows)")
    log(f"per-pair loss alone on fixed predictions: forward {pt['alone']['loss forward']:.3f} "
        f"ms, backward to the predictions {pt['alone']['loss backward']:.3f} ms")
    log(f"synthetic multi-object assembly of the kept batch (types {pt['smo_types']}), B={Bt} "
        f"{Wt}x{Ht} (host clock with synchronisation; the composited rows are found on the "
        "host): " + "; ".join(f"{route} route {what}: {ms:.3f} ms"
                              for (route, what), ms in pt["assembly"].items())
        + f"; the matrix step's assembly {split['assembly']:.3f} ms")
    log(f"per-pair and synthetic multi-object phase {pair_smo['phase_s']:.2f} s; the "
        f"synthetic multi-object driver run {pair_smo['smo']['run_s']:.2f} s, the per-pair "
        f"driver run {pair_smo['per_pair_run_s']:.2f} s (6 iterations each, checkpoints "
        f"included); compute_loss_on_dataset {pair_smo['loss_on_dataset_s']:.2f} s")

    # the apps: the grasp stream, a heatmap event, descriptor images, the exported
    # program, mesh descriptors
    st = apps["stream"]
    log(smi)
    log(f"grasp stream (GraspPointStream, ResNet-34-8s fp32 {Wt}x{Ht}, {APPS_QUERIES} "
        f"descriptors, {N_APPS_FRAMES} frames after {N_APPS_FRAMES} warm-up): "
        f"{st['wall_ms']:.3f} ms per frame on the host clock, {1e3 / st['wall_ms']:.2f} "
        f"frames/s; split by CUDA events: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in st["split"].items()))
    log(f"heatmap event (HeatmapEngine.find_best_match, query to the [{Ht}, {Wt}] heatmap on "
        f"the host): median {apps['heat_event_ms']:.3f} ms of 10")
    di = apps["descriptor_images_ms"]
    log(f"descriptor images (compute_descriptor_images_for_scene, B=8, {N_APPS_FRAMES} frames, "
        f"host clock): {sum(di.values()):.3f} ms per frame, of which forward (upload, "
        f"forward, fetch) {di['forward']:.3f} ms and np.save {di['save']:.3f} ms")
    log(f"export-serving at B={APPS_EXPORT_B}: {apps['export_s']:.2f} s to export and save "
        f"{apps['export_bytes']} bytes; the loaded program {apps['program_ms']:.3f} ms per "
        f"call (uint8 in, normalisation included) against the live module's "
        f"{apps['module_ms']:.3f} ms on normalised NCHW input and "
        f"forward_on_images' {apps['forward_on_images_ms']:.3f} ms (uint8 in); "
        f"{apps['program_ms'] / apps['module_ms']:.3f} x the module")
    log(f"mesh descriptors (compute_mesh_descriptors, forward included): "
        f"{apps['mesh_ms']:.3f} ms per frame; apps phase {apps['phase_s']:.2f} s")

    # K1 and K2 at the main path's shapes: the masked pool's rows of a real step
    hargs = [a.contiguous() for a in captured[0]]
    g_one = torch.ones(hargs[0].shape[0], device=dev)
    def k1():
        return ph._forward_kernel(*hargs, 0.5, False, 50.0)

    def k2():
        return ph._backward_kernel(g_one, *hargs, 0.5, False, 50.0)

    k1_ms, k1_wrapper = time_device(torch, k1), time_cuda(torch, k1)
    k2_ms, k2_wrapper = time_device(torch, k2), time_cuda(torch, k2)
    k1_split, k2_split = profile_split(torch, k1), profile_split(torch, k2)
    Bk, Nk, Dk = hargs[0].shape
    Pk = hargs[1].shape[1]
    k1_blocks = ph._library().pdc_pooled_hinge_fwd_partials(Bk, Nk, Dk)
    k2_blocks = ph._library().pdc_pooled_hinge_bwd_partials(Bk, Nk, Pk, Dk) // (Dk * Pk)
    log(f"K1 grid {k1_blocks} blocks ({k1_blocks // Bk} per pair), K2 grid {k2_blocks} blocks "
        f"({k2_blocks // Bk} per pair), 256 threads each, on "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    with torch.no_grad():
        p1_ms = time_device(torch, lambda: ph.pooled_hinge_reference(*hargs, 0.5, False, 50.0),
                            iters=5)
        p2_ms = time_device(torch, lambda: ph.pooled_hinge_backward_reference(
            g_one, *hargs, 0.5, False, 50.0), iters=5)
        cdist_ms = time_device(torch, lambda: torch.cdist(hargs[0], hargs[1]), iters=5)
    b1_ms, b1_by, sq1 = hinge_bound(hargs, False, backward=False)
    b2_ms, b2_by, sq2 = hinge_bound(hargs, False, backward=True)
    hard = int(ph.pooled_hinge_reference(*hargs, 0.5, False, 50.0)[1].sum())
    log(f"pooled hinge at the main path's shapes {tuple(hargs[0].shape)} x "
        f"{tuple(hargs[1].shape)} ({hard} hard negatives), device times: K1 {k1_ms:.5f} ms "
        f"(wrapper {k1_wrapper:.5f} ms per call), plain {p1_ms:.4f} ms, bound {b1_ms:.5f} ms "
        f"({b1_by}), at {100 * b1_ms / k1_ms:.1f}% of bound; K2 {k2_ms:.5f} ms (wrapper "
        f"{k2_wrapper:.5f} ms per call), plain {p2_ms:.4f} ms, bound {b2_ms:.5f} ms ({b2_by}), "
        f"at {100 * b2_ms / k2_ms:.1f}% of bound")
    log(f"K1 {split_text(k1_split)}")
    log(f"K2 {split_text(k2_split)}")
    # the walk without its counted path: with M = 0 no pair passes d2 < T
    k1_walk = time_device(torch, lambda: ph._forward_kernel(*hargs, 0.0, False, 50.0))
    k2_walk = time_device(torch, lambda: ph._backward_kernel(g_one, *hargs, 0.0, False, 50.0))
    log(f"the same inputs with M = 0 (no pair passes the distance test, so no counted path): "
        f"K1 {k1_walk:.5f} ms, K2 {k2_walk:.5f} ms of device time")
    log(f"pooled hinge sqrt count: K1 {sq1} ({1e3 * sq1 / PEAK_SFU_S:.5f} ms at the SFU rate), "
        f"K2 {sq2} ({1e3 * sq2 / PEAK_SFU_S:.5f} ms); no single PyTorch call computes the "
        f"pooled hinge (library: none); torch.cdist of the same rows, the distance part "
        f"alone: {cdist_ms:.4f} ms")
    log(f"K1+K2 share of a train step: 2 x ({k1_ms:.4f} + {k2_ms:.4f}) ms = "
        f"{100 * 2 * (k1_ms + k2_ms) / mean_step:.2f}% of {mean_step:.3f} ms")
    k1_entry = {"name": "pooled_hinge_fwd", "route": "cuda",
                "source": "pdc_tpu_torch/csrc/pooled_hinge.cu",
                "replaces": "pdc_tpu/ops/pallas_loss.py:42", "launches": k1_launches,
                "launches_by_path": {"training": k1_launches, "training driver": driver["k1"],
                                     "on-disk training": on_disk["k1"],
                                     "smo matrix": pair_smo["smo"]["launches"][0],
                                     "ResNet-101-8s step": variants["train"]["Resnet101_8s"][0],
                                     "UNet step": variants["train"]["Unet"][0],
                                     "bf16 step": dtype14["train"]["launches"][0],
                                     "bf16 driver": dtype14["driver"]["launches"][0],
                                     "experiment": tooling["k1"],
                                     "experiment from disk": tooling["k1_disk"],
                                     **{f"data axis: {k}": v[0]
                                        for k, v in axis["launches"].items()
                                        if isinstance(v, tuple)},
                                     **{f"model axes: {k}": v[0]
                                        for k, v in axes["launches"].items()
                                        if isinstance(v, tuple)},
                                     "scanned": f"{scan18['fp32']['launches'][0]} in "
                                                f"{SCAN_K} steps",
                                     "scanned bf16": scan18["bf16"]["launches"][0],
                                     "scanned type-4 mix": scan18["type-4 mix"]["launches"][0],
                                     "scanned driver": scan18["driver"]["launches"][0],
                                     "scanned data-parallel": scan18["dp"]["launches"][0]},
                "max_abs_err": k1_err, "ms": k1_ms, "device_ms": k1_ms,
                "wrapper_ms": k1_wrapper, "plain_ms": p1_ms, "bound_ms": b1_ms,
                "bound_by": b1_by, "library_ms": None}
    k2_entry = {"name": "pooled_hinge_bwd", "route": "cuda",
                "source": "pdc_tpu_torch/csrc/pooled_hinge.cu",
                "replaces": "pdc_tpu/ops/pallas_loss.py:77", "launches": k2_launches,
                "launches_by_path": {"training": k2_launches, "training driver": driver["k2"],
                                     "on-disk training": on_disk["k2"],
                                     "smo matrix": pair_smo["smo"]["launches"][1],
                                     "ResNet-101-8s step": variants["train"]["Resnet101_8s"][1],
                                     "UNet step": variants["train"]["Unet"][1],
                                     "bf16 step": dtype14["train"]["launches"][1],
                                     "bf16 driver": dtype14["driver"]["launches"][1],
                                     "experiment": tooling["k2"],
                                     "experiment from disk": tooling["k2_disk"],
                                     **{f"data axis: {k}": v[1]
                                        for k, v in axis["launches"].items()
                                        if isinstance(v, tuple)},
                                     **{f"model axes: {k}": v[1]
                                        for k, v in axes["launches"].items()
                                        if isinstance(v, tuple)},
                                     "scanned": f"{scan18['fp32']['launches'][1]} in "
                                                f"{SCAN_K} steps",
                                     "scanned bf16": scan18["bf16"]["launches"][1],
                                     "scanned type-4 mix": scan18["type-4 mix"]["launches"][1],
                                     "scanned driver": scan18["driver"]["launches"][1],
                                     "scanned data-parallel": scan18["dp"]["launches"][1]},
                "max_abs_err": k2_err, "ms": k2_ms, "device_ms": k2_ms,
                "wrapper_ms": k2_wrapper, "plain_ms": p2_ms, "bound_ms": b2_ms,
                "bound_by": b2_by, "library_ms": None}
    phase("timings", t0)

    faulthandler.cancel_dump_traceback_later()
    log(json.dumps({"kernels": [entry, k1_entry, k2_entry]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    sys.stdout.flush()
    sys.stderr.flush()
    # every thread this script started has ended; skip interpreter teardown
    # so that nothing left in CUDA or socket finalizers can hold up the exit
    os._exit(0)


if __name__ == "__main__":
    main()
