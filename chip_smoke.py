#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero before the
final line):
  1. device: torch's name for the card, and nvidia-smi's name and power limit
  2. build: compile the three hand-written kernels (nvcc, sm_90a) and the two
     image decoders (JPEG/PNG and WebP; the host's C++ compiler) from csrc/,
     one compiler process per source, started together
  3. power-iteration kernel vs plain: the batched power-iteration kernel
     against its plain PyTorch version on the card (sigma, u', v and
     d sigma / dW; rtol 1e-4, float32 with TF32 off), at the CIFAR-D,
     tests/test_pallas.py, ImageNet-128 wide and ragged streamed shapes; two
     launches on the same inputs must be bit-identical (the streamed shapes'
     counters back at 0)
  4. fade-in kernel vs plain: ``fadein_blend`` against its plain version
     (rtol 1e-5, atol 1e-6) at the tests/test_pallas.py shape with alpha
     0, 0.37 and 1, at both PGGAN 1024^2 shapes in channels-last layout, and
     at a ragged, unaligned size; first gradients and a double backward;
     bit-equal at sizes either side of whole blocks, at offsets 0-3
  5. SNGAN main path: the fused SNGAN CIFAR-10 train step at full width
     (batch 64, n_critic 5, bf16 compute, EMA 0.9999, on-device fake data)
     through the port's CLI ``build`` and ``train_loop``; images/s, ms/step,
     peak memory; the power-iteration kernel must launch 6 times per step
     (5 critic D forwards + 1 in the G loss); then D and G forwards in
     float32 on the card against the CPU
  6. PGGAN main path: the ladder 4^2 -> 1024^2 at full width (Karras
     channels, z 512, Karras batch schedule, fused_scale D blocks from 128,
     bf16) on reals rendered on the card (``--data device-fake``) through the
     port's CLI parsing and ``train_pggan_ladder``, 2 steps per phase (17
     phases, 8 of them transitions); the fade-in kernel must
     launch 6 times per transition step and never in a stabilize step, every
     logged metric must be finite, and every tensor shared across a
     migration must be carried bit-exact
  7. PGGAN 1024^2 transition phase at batch 4, built by the ladder's own
     ``build_phase``, on ``device-fake`` reals: images/s, ms/step, peak
     memory; then full-width
     float32 G and D of the 64^2 transition stage on the card against the
     CPU (rtol 1e-3, atol 1e-3)
  8. kernel timing at the main paths' shapes: device time of CUDA-graph
     replays (many launches captured once, replayed between CUDA events, so
     the host's launch gaps are left out), taken in turns: each kernel, its
     plain version, the one PyTorch call that computes the same function
     where there is one, the bound of the work on this card, the host time
     of one wrapper call, the power iteration's empty-kernel floor, and
     nvidia-smi's clocks before and after
  9. checkpoint, resume, sample, eval on the card (cuDNN deterministic, in
     a temporary directory): (a) the full-width SNGAN step through
     ``train_sngan.main`` with a checkpoint every 4 steps and a fault at step
     6, re-run to resume from step 4 to 12, and every tensor of that run
     bit-equal to an uninterrupted 12-step run, the power-iteration kernel
     launched 6 times per step in each run; checkpoint bytes, save and
     restore ms; (b) ``cli.sample`` writes the 64-image grid; (c)
     ``cli.evaluate`` with the random-init InceptionV3 at 5000 samples and
     5000 reals, then again from the cached real moments, to the last digit;
     samples/s of the eval passes; InceptionV3 on the card against the CPU;
     (d) the PGGAN ladder to 64x64 at full width (``--data device-fake``)
     with per-phase checkpoints, interrupted in the 64x64 transition and re-run
     to its end, the fade-in
     kernel launched 6 times per transition step (and once per sample grid
     of a transition phase)
 10. data layer and north star (in a temporary directory): a synthetic
     CIFAR-10 pickle directory at the real layout and size (50,000 + 10,000
     images); ``train_sngan.main --data <dir>`` for 12 full-width steps
     through ``DeviceCachedStore`` (resident bytes, ms/step, 6
     power-iteration launches per step), one device batch bit-equal to the
     host gather of the same ``indices_for(pos)``; a ``--device-cache off``
     run's first batch through ``prefetch_to_device`` bit-equal to the host
     stream's, and 2 steps of it; one ``north_star.main`` call on that
     directory with an InceptionV3 npz written from the port's random-init
     net (statistics calibrated on the data): a verdict line and
     ``graded: true`` in its record (FAIL is expected: the extractor is
     random)
 11. SNGAN-projection ImageNet-128 at full width: a packed store of 3,200
     128x128 images with 1000-class labels written by the port's
     ``write_store``; ``train_sngan_imagenet.main --data <store>`` for 12
     steps across an epoch boundary (images/s, ms/step, peak memory, 6
     power-iteration launches per step, which of D's 19 weights do not fit
     in shared memory, so that all stream, and how they are dealt); the
     kernel against its plain version at D's 19 weights; full width float32
     G and D on the card against the CPU at batch 2; the 19-weight launch's
     device time beside its bound, the plain version and the empty-kernel
     floor, bit-identical across two launches, then with W cold in L2, and
     split into launches of the weights too large for shared memory, the
     others, the three largest and the largest alone
 12. (a) ACGAN CIFAR-10 at full width (batch 100, bf16, bce, aux 1.0)
     through ``train_acgan.main``: 24 steps timed (images/s, ms/step, peak
     memory), no launch of either kernel; a run faulted at step 6 and
     resumed from its step-4 checkpoint bit-equal to an uninterrupted
     12-step run, dropout draws included (cuDNN deterministic); float32 G
     and D card vs CPU at batch 2 with the same dropout masks;
     ``cli.sample`` and ``cli.evaluate --model acgan`` (1000 samples, the
     random-init InceptionV3). (b) the conditional CIFAR SNGAN
     (``train_sngan.main --num-classes 10``, batch 64, n_critic 5, bf16) for
     12 steps: 6 power-iteration launches per step, each over D's 12 weights
     (``proj_embed`` [128, 10] last); that 12-weight kernel against its plain
     version and bit-identical across two launches; float32 G and D card vs
     CPU; the 12-weight launch's device time beside the 11-weight one, its
     plain version and its bound; ``cli.sample`` and ``cli.evaluate`` with
     ``--num-classes 10``
 13. pix2pix at full width (U-Net ngf 64 at 256^2, 30x30 PatchGAN ndf 64,
     batch 1, bf16) from a 400-pair packed paired store at scale 286 held on
     the card: 28 steps through ``train_pix2pix.main`` (ms/step, peak
     memory), device batches bit-equal to the host jitter, a faulted run
     resumed bit-equal (cuDNN deterministic), float32 G and D card vs CPU with
     the same dropout masks, ``--mode test`` and ``--mode export`` (the
     reloaded bundle against the eager translator); no kernel launch
 14. PGGAN to the end (in a temporary directory): (a) 64 ``rich`` images
     rendered at 1024^2 by the host ``FakeImages``, mapped to uint8 and
     written as a 9-level pyramid store (1024 ... 4) by ``write_pyramid``;
     (b) ``train_pggan.main --data <pyramid>`` at full width, 2 steps per
     phase, a checkpoint every step: each phase reads its own member, held on
     the card, and the previous phase's store is released first; the fade-in
     kernel launches 6 times per transition step, 0 per stabilize step (and
     once per transition phase's sample grid); every metric finite; the
     1024^2 transition's ms/step and peak memory; (c) a device batch of the
     1024^2 member bit-equal to the host gather; (d) ``cli.evaluate --model
     pggan`` at 1024^2 (640 samples, 256 SWD images per side) with reals from
     the pyramid and from ``device-rich``, under torch's default TF32 flags
     and deterministic cuDNN: the reference's record keys (7 SWD levels),
     finite values, a repeat equal to the last digit; MS-SSIM pairs/s, SWD
     images/s, peak memory; (e) ``ms_ssim`` and ``sliced_wasserstein`` on the
     card against the CPU on the same images, descriptors and draws (rtol
     1e-4); (f) ``cli.sample --export-dir`` on a mid-phase 1024^2 transition
     checkpoint (alpha 0.5): G without the fade-in, 0 launches, the reloaded
     bundle bit-equal to the eager sampler; (g) one 1024^2 transition step
     with ``--remat-from 512`` and one without, from the same state and
     batch: equal losses, the peak memory of each
 15. multi-rank (in a temporary directory): the training CLIs under
     ``python -m torch.distributed.run --standalone``, each rank running
     ``chip_smoke.py --rank-run`` (each CLI's ``main`` in turn and a record
     of its launches, bytes and shard hashes; the 2-rank runs (a), (b) and
     (c) share one launcher start). (a) ``train_sngan`` on 2 gloo ranks
     sharing the card (batch 64, 32 per rank, bf16, 8 steps) against the
     one-rank run of the same command, both with plain SGD in place of Adam
     (an update linear in the gradient): every logged metric within 5e-2,
     the final G and D parameters apart by under 1% of the distance the
     updates moved them, the EMA by under 5% (relative L2; one rank's
     gradients in place of the average fail each), BN running
     stats and SN u within
     5e-2 (relative L2), 6 power-iteration launches per step on each rank,
     ms/step and images/s per card of both; (b) ``train_sngan_imagenet
     --tp-shards 2`` at full width ('data' 1 x 'model' 2, batch 16, 3
     steps): losses within 1e-6 of one rank, the full-size weights the
     network computes with (gathered over 'model') within 1e-6 of one
     rank's and equal on both ranks, each rank holding under 60% of
     the one-rank parameters, Adam slots and EMA, 6 launches per step per
     rank over 19 weights; (e) its checkpoint restored by one rank, whose
     slices equal every rank's shards bit for bit; (c) ``train_pggan`` to
     64^2 under DP 2 in fp32 (1 step per phase, 8 images per rank): 6
     fade-in launches per transition step on each rank, the 64^2
     transition step's metrics within 5e-3 relative of one rank; (d)
     ``train_sngan`` on a one-rank NCCL group (its process started with the
     launcher's environment, no launcher), as (a) with SGD: its metrics
     within 1e-6 of (a)'s run without a mesh (a 'data' axis of one rank
     makes no collective in the step), and the port's collectives (an
     autograd all-reduce and its backward, an all-gather) on CUDA tensors
     through NCCL; (f) ``--trace-steps 2``: a
     ``torch.profiler`` trace of steps 11-13 holding 18 spans of
     ``power_iteration_kernel``, and ``--debug-nans`` raising
     ``FloatingPointError`` on a NaN injected into D's SN weight (named by
     the kernel's wrapper) and into G's Dense weight (named by the
     operator); then the fade-in at the shapes one rank of a DP 2 1024^2
     rung gives it (2 images per rank)
 16. spatial partitioning (the 'sp' axis, ``--sp-shards``) and the
     space-to-depth top level (``--s2d-from``, default 512), ranks under
     ``torch.distributed.run`` sharing the card through gloo: (a) the 1024^2
     transition phase at full width in bf16 (batch 4, the S2D top level)
     built by ``build_phase`` from ``train_pggan``'s flags, on 2 'sp' ranks
     (``chip_smoke.py --sp-run``) against one process: step 1's metrics
     within 5e-2 (relative and absolute), 6 fade-in launches per step on
     each rank at the half-height shapes, ms/step, and rank 0's host ms per
     step in halo exchanges, height gathers and 'sp' sums; (b)
     ``train_pggan --sp-shards 2`` on 4 ranks (DP x SP 2 x 2), the ladder
     4^2 -> 64^2 in fp32, 1 step per phase, ``--s2d-from 32`` (the S2D top
     level at the ladder's last two rungs, as 512 puts it at a 1024^2
     ladder's), with SGD for Adam (an update linear in the gradient) against
     the one-process run: every logged metric of the 64^2 phases within
     1e-3 relative (1e-4 absolute), 24 fade-in launches per rank (rank 0's
     4 grids besides); (c) the 1024^2 transition step on one rank with
     ``--s2d-from 512`` and ``0`` from one state: step 1's metrics within
     5e-2, ms/step both ways in turns, the step's peak memory both ways; (d)
     (b)'s 64^2 stabilize checkpoint restored by a one-process
     ``cli.sample``: its grid against the 4-rank run's own writer's, within
     one level of 255 at under 0.1% of the values; then the fade-in at the
     shapes an 'sp' rank of the 1024^2 rung gives it
 17. the tools (``gan_lib_tensorflow_tpu_torch/tools/``), each run in this
     process at the reference tool's configuration with few timed steps:
     every JSON row with the reference's keys and no ``error``;
     ``bench_step`` (sngan, acgan, imagenet) with 6 power-iteration
     launches per sngan and imagenet step; ``bench_pggan`` and
     ``decompose_pggan`` at 1024^2, batch 4; ``calibrate_rungs`` (acgan,
     imagenet, pggan1024) with ``tf_per_step`` > 0 and ``mfu_nominal`` in
     (0, 1]; ``probe_cond_cost``, ``bench_eval``, ``bench_loader``,
     ``bench_kstep`` (chained and one CUDA graph of K steps); the npz
     ``prepack_dataset`` into a 128^2 pyramid; the InceptionV3 converter on
     a random torchvision-layout state dict, its npz's features on the card
     within 1e-4 (relative to the largest) of the CPU's; ``train_sngan
     --data fake|fake-rich|device-fake|device-rich`` 2 steps each (the host
     words through ``ThreadedSource``), the last with ``--curves`` (PNGs
     read back), ``--tensorboard`` (its note, and the run goes on) and
     ``--compile-cache`` (its note)
 18. image folders, read by the hand-written decoder (``csrc/imgcodec.cpp``,
     built in phase 2 with the host's C++ compiler, and ``data/codec.py``):
     (a) every committed fixture (``tests/torch_fixtures/images/``: baseline
     and progressive JPEGs, 4:2:0, 4:2:2 with restart markers, 4:4:4 of odd
     size, grey; RGBA, palette and Adam7 PNGs) decoded, center-cropped and
     resized at the loaders' sizes, each uint8 array's sha256 equal to the
     manifest that Pillow wrote (a mismatch names the file and its
     differing rows); decode images/s per format on one host thread; (b)
     pix2pix at full width (U-Net 256^2, 30x30 PatchGAN, batch 1, bf16) for
     6 steps from the folder of combined A|B JPEGs (``PairedImageFolder``,
     two host workers), ``--mode test`` over it, and 6 steps from its
     ``--paired`` store held on the card: ms/step of both; (c)
     SNGAN-projection ImageNet-128 at full width for 6 steps from a folder
     of two classes (fixture JPEGs and PNGs written here), 6 power-iteration
     launches a step, ms/step with two host workers (the CLI) and one, and
     the loader's images/s alone with each; (d) the PGGAN ladder 4^2 ->
     256^2 at full width, 1 step a phase, from a flat folder (decoded at
     256^2, box-downsampled per phase): 6 fade-in launches per transition
     step, 0 per stabilize step; then the 1024^2 transition phase
     (``build_phase``, batch 4) on a flat folder of 1024^2 PNGs against
     ``device-fake`` reals, 4 timed steps each; (e) ``cli.evaluate --model
     imagenet`` with the real moments from the class folder, and ``--model
     pggan`` at 256^2 with SWD reals from the flat folder; (f)
     ``tools/prepack_dataset`` on the fixtures (class folders, a flat
     ``--resolutions`` pyramid, ``--paired``): each store's sha256 equal to
     the reference tool's in the manifest; (g) every committed WebP fixture
     (``tests/torch_fixtures/webp/``: lossy under each loop filter and
     partition count, lossless with every transform, alpha raw and
     VP8L-compressed under each filter, animations) decoded by the
     hand-written WebP decoder (``csrc/webpdec.cpp``, built with the host's
     C++ compiler at first use): RGB and RGBA sha256 equal to what Pillow
     gave, and the parts of the format each decode met; (h) one host
     thread's decode rate (images/s, MP/s) on a lossy and a lossless 256^2
     fixture; (i) a two-class folder of the WebP fixtures packed by
     ``tools/prepack_dataset --size 128``, and ``cli.train_sngan_imagenet
     --data <store>`` at full width for 2 fused steps: 12 power-iteration
     launches, each held against the plain version on the same W and u
 19. TF1 checkpoints without TensorFlow (``tools/tf1_bundle.py``, the
     hand-written tensor-bundle reader, and ``tools/import_tf1_checkpoint``):
     (a) every committed TensorFlow-written bundle
     (``tests/torch_fixtures/tf1/``: every dtype, partitioned variables, two
     shards, a TF2 object graph) read on the card's host, each tensor's
     sha256 equal to the manifest written from ``tf.train.load_checkpoint``;
     a copy with one data byte flipped and one with an index byte flipped
     each refused with the CRC32C error; the reader's MB/s on a 64 MiB
     tensor; (b) SNGAN CIFAR-10 at full width: a tflib-named bundle (the
     igul222 NCHW boundary, Adam slots, ``beta*_power``, ``global_step``)
     written by the test scaffolding writer, imported by ``python -m
     ...tools.import_tf1_checkpoint --model sngan --nchw-boundary``: 0
     unmatched, nothing dropped kept, every imported tensor its source
     (bit-equal, after the permutation); ``cli.sample`` draws a grid from
     the imported EMA; ``cli.train_sngan`` refuses the checkpoint (no lr
     schedule in it), as the reference's refuses its tool's, so no CLI
     resumes the import; ``train_loop``'s auto-resume, called here
     directly, takes it up with the optimizer it was written with
     (Adam(2e-4, 0, 0.9), no schedule) for 3 fused steps at batch 64: 6
     power-iteration launches a step on the imported D, whose first sigma
     agrees with the plain version (rtol 1e-4); (c) SNGAN-projection
     ImageNet-128 at full width (1000 classes; 326 MB of float32): the
     bundle read alone (MB/s) and the whole tool timed, every tensor its
     source, and the first power-iteration launch on the imported D's 19
     weights against the plain version (rtol 1e-4); (a) also reads the V1
     fixtures (one table file, two shards through their pattern) and the
     V2 one of every other dtype and strings, and refuses what TensorFlow's
     V1 reader refuses; (d) SNGAN CIFAR-10 at full width written by the
     test scaffolding writer as V1 and as V2 with the same values and a
     kept string, uint8 and int16 variable: both imported by the port's
     tool, equal reports, the two step-0 checkpoints byte-equal
 20. the last tools on the card: (a) the doctor (``python -m
     ...tools.doctor``, every probe, in a subprocess): rc 0, its card name
     and power limit those of phase 1, both kernels built for sm_90a and
     launched once each within phases 3-4's tolerances; its seconds and
     each probe's; (b) ``tools.prepack_synthetic --n 64 --size 128
     --resolutions 128,64,32,16,8,4 --num-classes 0 --seed 0``: the store's
     digest equal to the reference tool's on the same flags (committed by
     the CPU test in ``tests/torch_fixtures/prepack_synthetic.json``),
     images/s; then ``train_pggan --data <that store> --final-resolution
     128`` at full width, 2 steps per phase: 6 fade-in launches per
     transition step and one per transition phase's grid; (c)
     ``cli.evaluate --model pggan --resolution 128`` on (b)'s last
     checkpoint against the store (160 samples, 64 SWD images per side),
     written as ``eval_karras_128.json``: the 4 SWD levels, their mean and
     MS-SSIM finite; (d) ``tools.plot_run`` on phase 10's ``log.jsonl``,
     ``tools.plot_ladder`` on (b)'s run and ``tools.plot_dose_response`` on
     (c)'s JSON: each PNG decoded by ``data/codec.py`` at the tool's size,
     its ``Title`` text chunk the tool's title, pixels drawn in each panel
 21. batch-norm kernels (``csrc/batch_norm.cu``, which replaces no TPU
     kernel) at the SNGAN-projection ImageNet-128 G's 11 norm shapes, bf16
     channels-last with the fused ReLU: the G update's (batch 64, forward
     and backward) and the fakes' (5 x 64 in 5 groups, forward); each
     against its HBM bound (the kernels' own bytes: 6 per element forward,
     10 backward; beside it the share of the function's least bytes, 4 and
     6: x in and y out, x and dy in and dx out), the plain version and
     ``F.batch_norm`` + ReLU as the library yardstick (per-channel affine
     only: it computes BN, not conditional BN; the port never calls it); y
     held to the plain version at every shape; at the G update's, through
     autograd with the running statistics advancing, y, the running mean
     and var, dx and the gamma/beta rows' gradients held to the plain
     version's at ``tests/test_torch_batch_norm_cuda.py``'s tolerances

The power iteration's ``launches`` in the kernels' record are those of
phase 5's SNGAN run, phase 12's conditional SNGAN run, every run of
phase 15 (each rank's and the one-rank runs'), the runs of phase 17's
tools and ``--data`` words, phase 18's ImageNet-128 runs (from the class
folder and from the WebP store) and phase 19's
loop-level resume of the imported SNGAN (``train_loop`` called directly:
no CLI resumes an import); the
fade-in's are those of phase 6's ladder, phase 14's ladder (b), the ladders
and steps of phases 15 and 16 (each rank's and the one-process runs') and
phase 18's ladder and 1024^2 steps, and phase 20's ladder (b). The
doctor's launches (one of each kernel, in its own process) are printed in
phase 20 and not counted here.

The batch norm's ``launches`` are its forward and backward calls in phase
5's SNGAN run (14 forward and 7 backward a step, checked) and phase 11's
ImageNet-128 run (22 and 11 a step, and 11 forward for the last step's
sample grid, checked). The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import gc
import io
import json
import math
import os
import pickle
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores. Both kernels' work is fp32 and not on the
# tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

WARM_STEPS, TIMED_STEPS = 3, 20
N_CRITIC, BATCH = 5, 64
PGGAN_STEPS_PER_PHASE = 2
PGGAN_WARM, PGGAN_TIMED = 3, 10

# shapes of the two fade-ins of the PGGAN 1024^2 transition step at batch 4:
# G's RGB [N, 3, 1024, 1024], D's first block output [N, 32, 512, 512]
FADEIN_MAIN_SHAPES = [(4, 3, 1024, 1024), (4, 32, 512, 512)]
FADEIN_PALLAS_SHAPE = (3, 17, 9, 4)  # tests/test_pallas.py:37
FADEIN_BLOCK_ELEMS = 1024 * 4  # one block of csrc/fadein_blend.cu: 1024 threads x float4

# (channels, spatial size) of the SNGAN-projection ImageNet-128 G's 11 norms in
# forward order (block0-4 bn1, bn2 conditional; bn_out plain BN)
BN_G_SHAPES = [(1024, 4), (1024, 8), (1024, 8), (512, 16), (512, 16), (256, 32), (256, 32),
               (128, 64), (128, 64), (64, 128), (64, 128)]
BN_G_NAMES = ["block0.bn1", "block0.bn2", "block1.bn1", "block1.bn2", "block2.bn1",
              "block2.bn2", "block3.bn1", "block3.bn2", "block4.bn1", "block4.bn2", "bn_out"]
BN_FWD_BYTES, BN_BWD_BYTES = 6, 10  # bf16: x twice and y once; x and dy twice and dx once
BN_MIN_FWD_BYTES, BN_MIN_BWD_BYTES = 4, 6  # the function's least: each tensor once

# [fan_in, out] of the 11 CIFAR-D spectral-norm weights, and of test_pallas.py
CIFAR_D_SHAPES = ([(27, 128), (1152, 128), (3, 128), (1152, 128), (1152, 128),
                   (128, 128)] + [(1152, 128)] * 4 + [(128, 1)])
PALLAS_SHAPES = [(1152, 128), (27, 64), (128, 1), (9, 256)]
# the SNGAN-projection ImageNet-128 D's widest 3x3 convs (512->1024, 1024->1024):
# slabs too large for shared memory, streamed from device memory
IMAGENET_WIDE_SHAPES = [(4608, 1024), (9216, 1024)]
# streamed weights with ragged edges: M not a multiple of 4 or of a tile, K
# not a multiple of the threads, tiles of 4, 16, 32 and 64 columns
RAGGED_STREAMED_SHAPES = [(9001, 1000), (4099, 700), (3001, 333), (13, 4096), (9216, 256)]
# the real CIFAR-10 layout: five training pickles and one test pickle of
# 10,000 images each, 3072 bytes per image
CIFAR_FILES, CIFAR_PER_FILE = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"], 10_000
CIFAR_STEPS, IMAGENET_STEPS, LOG_EVERY = 12, 12, 4
ACGAN_STEPS, ACGAN_BATCH = 24, 100
IMAGENET_STORE = 3_200  # 10 fused steps of 5 x 64 images: an epoch ends inside the run
# pix2pix: the facades layout (400 training pairs, jitter from 286 to 256),
# full width, batch 1; 4 warm-up steps, then 24 timed
PIX_PAIRS, PIX_SCALE, PIX_SIZE, PIX_WIDTH = 400, 286, 256, 64
PIX_WARM, PIX_TIMED = 4, 24
# PGGAN to the end (phase 14): a pyramid store of 64 rich images at 1024^2,
# the ladder at full width from it, and the eval at 640 samples (64 MS-SSIM
# pairs) with 256 images per side for SWD
PGE_RES, PGE_IMAGES, PGE_WIDTH = 1024, 64, 1.0
PGE_EVAL_SAMPLES, PGE_SWD_SAMPLES = 640, 256
# multi-rank (phase 15): two ranks share the one card through gloo
MR_RANKS = 2
MR_SNGAN_STEPS, MR_LOG_EVERY = 8, 4        # (a): sec_per_step of steps 5-8
MR_IMAGENET_BATCH, MR_IMAGENET_STEPS = 16, 3
MR_TRACE_STEPS = 2                           # (f): a window of 3 steps, 11-13
MR_LADDER_RES = 64                           # (c): the DP 2 ladder's last rung
# the fade-in's two blends of the 1024^2 transition step at 2 images per rank
FADEIN_HALF_SHAPES = [(2, 3, 1024, 1024), (2, 32, 512, 512)]
# spatial partitioning (phase 16): (a) the 1024^2 transition phase on 2 'sp'
# ranks, step 1 compared with one rank and steps 2-4 timed; (c) S2D against
# the composed top level on one rank, warm-up then timed steps in turns
SP_STEPS = 4
S2D_WARM, S2D_TIMED, S2D_ROUNDS = 2, 3, 2
# (b): the DP x SP ladder's last rung, with the S2D top level at its last two
SP_LADDER_RES, SP_LADDER_S2D = 64, 32
# the fade-in's blends on one 'sp' rank of the 1024^2 transition step: half
# the height at batch 4 ('sp' 2) and at 2 images per 'data' rank (DP x SP 2 x 2)
FADEIN_SP_SHAPES = [(4, 3, 512, 1024), (4, 32, 256, 512), (2, 3, 512, 1024), (2, 32, 256, 512)]
# the tools (phase 17): few timed steps each; the words of --data on train_sngan
TOOL_TIMED = 3
DATA_WORDS = ["fake", "fake-rich", "device-fake", "device-rich"]
# image folders (phase 18): the committed fixtures and their manifest, which
# tests/test_torch_image_folders.py writes with Pillow and the reference's
# prepack tool; the folders written here: ImageNet-128's two classes of 48
# files, the PGGAN ladder's 16 (its largest batch) and 8 at 1024^2
FIXTURES = os.path.join("tests", "torch_fixtures", "images")
FOLDER_STEPS, FOLDER_LOG = 6, 3
FOLDER_CLASS_FILES, FOLDER_FLAT_FILES, FOLDER_1024_FILES = 48, 16, 8
FOLDER_LADDER_RES = 256
FOLDER_1024_TIMED = 6
DEVICE_PREFETCH = 2  # prefetch_to_device's depth
DECODE_SECONDS = 0.5  # per format, for its decode rate
# WebP (phase 18 g-i): the committed fixtures and their manifest
# (tests/torch_fixtures/webp/make_fixtures.py, Pillow and libwebp), the two
# 256^2 files timed, and the ImageNet-128 run from their packed folder
WEBP_FIXTURES = os.path.join("tests", "torch_fixtures", "webp")
WEBP_RATE_FILES = ("lossy_256_q75.webp", "lossless_256.webp")
WEBP_COPIES = 5  # of every fixture in each class: 350 files, one fused step's 320
WEBP_STEPS = 2
# TF1 checkpoints (phase 19): the committed TensorFlow-written bundles and
# their manifest, and the steps of the SNGAN run resumed from an import
TF1_FIXTURES = os.path.join("tests", "torch_fixtures", "tf1")
TF1_STEPS = 3
TF1_RATE_BYTES = 64 << 20  # one tensor for the reader's rate
# the last tools (phase 20): prepack_synthetic's flags and the digest of the
# reference tool's store on them (tests/test_torch_last_tools.py writes it),
# the ladder trained from that store, and its eval
SYNTH_FIXTURE = os.path.join("tests", "torch_fixtures", "prepack_synthetic.json")
SYNTH_RES, SYNTH_STEPS = 128, 2
SYNTH_EVAL_SAMPLES, SYNTH_SWD_SAMPLES = 160, 64
DOCTOR_TIMEOUT = 300
PHASE_STARTS = {}  # phase number -> time.perf_counter() at its start


def nvidia_smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def phase(name: str) -> None:
    PHASE_STARTS[int(name.split()[0])] = time.perf_counter()
    print(f"== {name}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def device_ms(fn, iters: int, repeats: int = 5) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured once in a
    CUDA graph after a warm-up, the graph replayed ``repeats`` times between
    CUDA events; the median replay over ``iters``. The host's launch gaps are
    not in it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up where the capture will run
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def host_us(fn, calls: int) -> float:
    """Median host time of one call of ``fn`` (no synchronisation between
    calls): what a wrapper costs the host per launch."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * statistics.median(times)


def timed_in_turns(fns: dict, iters: int, rounds: int = 3) -> dict:
    """``device_ms`` of each function, taken in turns over ``rounds`` rounds
    (the order reversed every other round); the median of the rounds."""
    got = {k: [] for k in fns}
    for r in range(rounds):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            got[k].append(device_ms(fns[k], iters))
    return {k: statistics.median(v) for k, v in got.items()}


def compare_kernel(pi, torch, shapes, seed):
    """Kernel vs plain version on random weights; returns the max abs error
    of sigma, u' and v."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ws = [torch.randn(k, m, device="cuda", generator=g) for m, k in shapes]
    us = [torch.randn(1, k, device="cuda", generator=g) for _, k in shapes]
    sigma, u_out, v_out = pi.launch(ws, us)
    s_ref, u_ref, v_ref = pi.plain_power_iteration(ws, us)
    u_ref, v_ref = torch.cat(u_ref), torch.cat(v_ref)
    torch.testing.assert_close(sigma, s_ref.detach(), rtol=1e-4, atol=0.0)
    torch.testing.assert_close(u_out, u_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(v_out, v_ref, rtol=1e-4, atol=1e-5)
    err = max(float((sigma - s_ref).abs().max()), float((u_out - u_ref).abs().max()),
              float((v_out - v_ref).abs().max()))

    # gradient: autograd through the kernel's Function vs through the plain
    c = torch.randn(len(shapes), device="cuda", generator=g)
    grads = []
    for fn in (lambda w: pi.batched_power_iteration(w, us),
               lambda w: pi.plain_power_iteration(w, us)[0]):
        wg = [w.clone().requires_grad_(True) for w in ws]
        (fn(wg) * c).sum().backward()
        grads.append([w.grad for w in wg])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)

    # update flag: u' written into the u buffers only when asked
    u_copy = [u.clone() for u in us]
    pi.launch(ws, u_copy, write_u=False)
    check(all(torch.equal(a, b) for a, b in zip(u_copy, us)), "u moved without update")
    pi.launch(ws, u_copy, write_u=True)
    torch.testing.assert_close(torch.cat([u.reshape(-1) for u in u_copy]), u_out)
    return err


def compare_fadein(fd, torch):
    """The fade-in kernel vs its plain version: outputs, first gradients and
    a double backward. Returns the max abs error of the outputs."""
    g = torch.Generator(device="cuda").manual_seed(2)
    cl = torch.channels_last
    cases = [(FADEIN_PALLAS_SHAPE, a, None) for a in (0.0, 0.37, 1.0)]
    cases += [(s, 0.37, cl) for s in FADEIN_MAIN_SHAPES]
    cases.append(((1001,), 0.37, "unaligned"))  # scalar path and ragged tail
    err = 0.0
    for shape, alpha, layout in cases:
        if layout == "unaligned":
            a = torch.randn(shape[0] + 1, device="cuda", generator=g)[1:]
            b = torch.randn(shape[0] + 1, device="cuda", generator=g)[1:]
        else:
            a = torch.randn(shape, device="cuda", generator=g)
            b = torch.randn(shape, device="cuda", generator=g)
            if layout is not None:
                a, b = a.contiguous(memory_format=layout), b.contiguous(memory_format=layout)
        before = fd.launches
        out = fd.fadein_blend(a, b, alpha)
        check(fd.launches == before + 1, "fade-in launch counter did not advance")
        check(out.stride() == a.stride(), f"output strides {out.stride()} != {a.stride()}")
        ref = fd.plain_fadein_blend(a, b, alpha)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
        err = max(err, float((out - ref).abs().max()))
    # first gradients through the wrapper vs through the plain version
    a = torch.randn(FADEIN_MAIN_SHAPES[1], device="cuda", generator=g).contiguous(memory_format=cl)
    b = torch.randn_like(a)
    r = torch.randn_like(a)
    grads = []
    for fn in (fd.fadein_blend, fd.plain_fadein_blend):
        ag, bg = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        (fn(ag, bg, 0.37) * r).sum().backward()
        grads.append((ag.grad, bg.grad))
    for x, y in zip(*grads):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
    # double backward, as the gradient penalty takes it through D's blend
    x0 = torch.randn(4, 32, 16, 16, device="cuda", generator=g).contiguous(memory_format=cl)
    second = []
    for fn in (fd.fadein_blend, fd.plain_fadein_blend):
        w = torch.tensor(1.7, device="cuda", requires_grad=True)
        x = x0.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad((fn(w * x, x * x, 0.3) ** 2).sum(), x, create_graph=True)
        (gw,) = torch.autograd.grad((gx ** 2).sum(), w)
        second.append(gw)
    torch.testing.assert_close(second[0], second[1], rtol=1e-5, atol=1e-6)
    return err


def backward_against_plain(norms, x, gamma, beta, name, gen):
    """One forward through autograd with the running statistics advancing
    and its backward, kernels against the plain version on the same x, dy,
    gamma and beta: y, the running mean and var, dx and the gamma/beta
    gradients (rows, or summed over the samples for bn_out), at the
    tolerances of ``tests/test_torch_batch_norm_cuda.py``. Returns dy (zeroed
    where the plain float32 y lies within 1e-3 of the ReLU's 0, as there)."""
    import torch

    c = x.shape[1]
    sides = []
    for _ in range(2):
        sides.append([t.detach().clone().requires_grad_() for t in (x, gamma, beta)]
                     + [torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")])
    (xk, gk, bk, rmk, rvk), (xp, gp, bp, rmp, rvp) = sides
    with torch.no_grad():
        far = norms.plain_batch_norm(x, gamma, beta, rmp.clone(), rvp.clone(), torch.float32,
                                     update_stats=False).abs() > 1e-3
    dy = torch.randn(x.shape, device="cuda", generator=gen) * far
    dy = dy.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    yk = norms.batch_norm(xk, gk, bk, rmk, rvk, torch.bfloat16, update_stats=True, relu=True)
    yp = norms.plain_batch_norm(xp, gp, bp, rmp, rvp, torch.bfloat16, update_stats=True, relu=True)
    yk.backward(dy)
    yp.backward(dy)

    def close(got, want, rtol, atol, what):
        got, want = got.detach(), want.detach()
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol,
                                   msg=lambda m: f"batch norm {name}, {what}: {m}")
        return float((got.float() - want.float()).abs().max())

    errs = [close(yk, yp, 2 ** -7, 1e-5, "y"),
            close(rmk, rmp, 1e-5, 1e-6, "running mean"), close(rvk, rvp, 1e-5, 1e-6, "running var")]
    for got, want, rtol, what in ((xk.grad, xp.grad, 2 ** -7, "dx"), (gk.grad, gp.grad, 1e-4, "gamma"),
                                  (bk.grad, bp.grad, 1e-4, "beta")):
        errs.append(close(got, want, rtol, 1e-4 * float(want.abs().max()), what))
    print(f"batch_norm {name} [{', '.join(map(str, x.shape))}] through autograd, running "
          f"statistics advancing: kernels vs plain, max abs err y {errs[0]:.3e}, running mean "
          f"{errs[1]:.3e}, var {errs[2]:.3e}, dx {errs[3]:.3e}, gamma {errs[4]:.3e}, beta "
          f"{errs[5]:.3e}", flush=True)
    return dy


def batch_norm_timing(card: str) -> dict:
    """Phase 21: the batch-norm kernels at the ImageNet-128 G's shapes (see
    the module's note); returns the kernels' record (sums over the 11
    shapes of the G update's forward and backward)."""
    import torch
    import torch.nn.functional as F
    from gan_lib_tensorflow_tpu_torch.ops import norms

    cl = torch.channels_last
    rec = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(21)
    for (c, s), name in zip(BN_G_SHAPES, BN_G_NAMES):
        for batch, groups in ((64, 1), (320, 5)):
            x = torch.randn(batch, c, s, s, device="cuda", generator=gen)
            x = (x * 1.5 + 0.3).to(torch.bfloat16).contiguous(memory_format=cl)
            rm, rv = torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")
            if name == "bn_out":
                gamma = 1 + 0.2 * torch.randn(c, device="cuda", generator=gen)
                beta = 0.2 * torch.randn(c, device="cuda", generator=gen)
            else:
                gamma = 1 + 0.2 * torch.randn(batch, c, device="cuda", generator=gen)
                beta = 0.2 * torch.randn(batch, c, device="cuda", generator=gen)
            count = batch // groups * s * s
            call = norms._Call(groups, True, count, True, torch.bfloat16)
            n = x.numel()

            def plain(x=x, gamma=gamma, beta=beta, rm=rm, rv=rv, groups=groups):
                return norms.plain_batch_norm(x, gamma, beta, rm, rv, torch.bfloat16,
                                              groups=groups, update_stats=False, relu=True)

            def library(x=x, rm=rm, rv=rv, w=torch.ones(c, device="cuda"),
                        b=torch.zeros(c, device="cuda")):
                return F.relu(F.batch_norm(x, rm, rv, w, b, training=True, eps=norms.EPSILON))

            def kernel(x=x, gamma=gamma, beta=beta, rm=rm, rv=rv, call=call):
                return norms.launch_forward(x, gamma, beta, rm, rv, call, False)[0]

            y, sums = norms.launch_forward(x, gamma, beta, rm, rv, call, False)
            err = float((y.float() - plain().float()).abs().max())
            check(err <= 0.0625, f"batch norm {name} at batch {batch}: y differs by {err}")
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            fns = {"kernel": kernel, "plain": plain, "library": library}
            if groups == 1:
                dy = backward_against_plain(norms, x, gamma, beta, name, gen)
                fns["kernel_bwd"] = lambda x=x, dy=dy, g=gamma, b=beta, s_=sums, c_=call: \
                    norms.launch_backward(x, dy, g, b, s_, c_)
            t = timed_in_turns(fns, 10)
            f_bound = 1e3 * BN_FWD_BYTES * n / PEAK_BYTES_PER_S
            b_bound = 1e3 * BN_BWD_BYTES * n / PEAK_BYTES_PER_S
            line = (f"batch_norm {name} [{batch}, {c}, {s}, {s}] groups {groups}: forward "
                    f"kernel {1e3 * t['kernel']:.2f} us (bound {1e3 * f_bound:.2f} us, "
                    f"{100 * f_bound / t['kernel']:.1f}% of {PEAK_BYTES_PER_S / 1e12:.2f} TB/s; "
                    f"{100 * f_bound * BN_MIN_FWD_BYTES / BN_FWD_BYTES / t['kernel']:.1f}% on "
                    f"the function's {BN_MIN_FWD_BYTES} B), "
                    f"plain {1e3 * t['plain']:.2f} us, F.batch_norm+relu "
                    f"{1e3 * t['library']:.2f} us")
            if groups == 1:
                line += (f"; backward kernel {1e3 * t['kernel_bwd']:.2f} us (bound "
                         f"{1e3 * b_bound:.2f} us, {100 * b_bound / t['kernel_bwd']:.1f}%; "
                         f"{100 * b_bound * BN_MIN_BWD_BYTES / BN_BWD_BYTES / t['kernel_bwd']:.1f}"
                         f"% on the function's {BN_MIN_BWD_BYTES} B)")
                rec["ms"] += t["kernel"] + t["kernel_bwd"]
                rec["bound_ms"] += f_bound + b_bound
                rec["plain_ms"] += t["plain"]
                rec["library_ms"] += t["library"]
            print(f"{line}; max |y - plain| {err:.3e}  [{card}]", flush=True)
            del x, y, fns
    x = torch.randn(64, 128, 64, 64, device="cuda").to(torch.bfloat16).contiguous(memory_format=cl)
    m = norms.BatchNorm(128, compute_dtype=torch.bfloat16).cuda()
    print(f"batch_norm: host {host_us(lambda: m(x, relu=True, update_stats=False), 200):.1f} us "
          f"per forward wrapper call (no autograd)  [{card}]")
    print("batch_norm record: ms, bound_ms sum the 11 G-update shapes' forward and backward "
          "kernels; plain_ms, library_ms their forwards only (not comparable to ms)")
    return rec


def snapshot(st):
    """Every tensor of G, D and the EMA, cloned on the device."""
    return {("g", n): p.detach().clone() for n, p in st.g.named_parameters()} | {
        ("d", n): p.detach().clone() for n, p in st.d.named_parameters()} | {
        ("ema", n): t.clone() for n, t in st.ema_params.items()}


def flat_items(obj, path=()):
    """(path, leaf) of every leaf of nested dicts, lists and tuples."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from flat_items(v, path + (k,))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from flat_items(v, path + (i,))
    else:
        yield path, obj


def timed_calls(module, name: str, sink: list) -> None:
    """Wrap ``module.name`` so each call appends its synchronised seconds to
    ``sink`` (the eval passes inside ``cli.evaluate``)."""
    import torch
    inner = getattr(module, name)

    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        return out

    setattr(module, name, wrapped)


def resume_bit_equal(main_fn, args: list, tmp: str, name: str, kernels: dict) -> tuple:
    """``main_fn`` (a CLI's ``main``) faulted at step 6 with a checkpoint
    every 4, re-run to resume from step 4 to 12, and run uninterrupted for 12
    steps in another directory: every leaf of the two final states must be
    bit-equal. Returns (the uninterrupted state, its directory, the launches
    of each module of ``kernels`` in the three runs)."""
    import torch
    from gan_lib_tensorflow_tpu_torch.train import CheckpointManager, to_checkpoint
    run, straight_dir = os.path.join(tmp, name), os.path.join(tmp, name + "_straight")
    args = args + ["--steps", "12", "--ckpt-every", "4", "--log-every", "4"]
    counts = {k: [] for k in kernels}

    def counted(fn):
        for mod in kernels.values():
            mod.launches = 0
        try:
            return fn()
        finally:
            torch.cuda.synchronize()
            for k, mod in kernels.items():
                counts[k].append(mod.launches)

    def faulted():
        try:
            main_fn(args + ["--out-dir", run, "--fault-inject-step", "6"])
        except RuntimeError as e:
            check("fault injected at step 6" in str(e), f"{name}: unexpected error: {e}")
            return
        check(False, f"{name}: the injected fault did not raise")

    counted(faulted)
    check(CheckpointManager(os.path.join(run, "ckpt")).latest_step() == 4,
          f"{name}: the step-4 checkpoint is not the latest after the fault")
    resumed = counted(lambda: main_fn(args + ["--out-dir", run]))
    straight = counted(lambda: main_fn(args + ["--out-dir", straight_dir]))
    check(resumed.step == straight.step == 12, f"{name}: a run did not end at step 12")
    got = dict(flat_items(to_checkpoint(resumed)))
    want = dict(flat_items(to_checkpoint(straight)))
    check(got.keys() == want.keys(), f"{name}: the resumed and uninterrupted states differ in keys")
    differ = [k for k in want if not (torch.equal(got[k], want[k])
                                      if isinstance(want[k], torch.Tensor)
                                      else got[k] == want[k])]
    check(not differ, f"{name}: {len(differ)} of {len(want)} leaves differ after the resume, "
                      f"e.g. {differ[:5]}")
    n_tensors = sum(isinstance(v, torch.Tensor) for v in want.values())
    print(f"{name} resume: fault at step 6, resumed from step 4 to 12; all {len(want)} "
          f"leaves ({n_tensors} tensors: G, D, Adam slots, noise generators and, where the "
          f"run has them, EMA and lr schedules) bit-equal to the uninterrupted run (cuDNN "
          f"deterministic); launches in 6, 8 and 12 steps: "
          + ", ".join(f"{k} {v}" for k, v in counts.items()))
    return straight, straight_dir, counts


def sample_grid(model_args: list, ckpt: str, tmp: str, n: int, rows: int) -> None:
    """``cli.sample`` on the card: an ``n``-image grid of ``rows`` rows of
    32x32 tiles, checked by its PNG header."""
    from gan_lib_tensorflow_tpu_torch.cli import sample
    png = os.path.join(tmp, "grid.png")
    sample.main(model_args + ["--ckpt-dir", ckpt, "--out", png, "--n", str(n),
                              "--device", "cuda"])
    with open(png, "rb") as f:
        head = f.read(24)
    width, height = struct.unpack(">II", head[16:24])
    cols = -(-n // rows)
    check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR"
          and (width, height) == (cols * 32, rows * 32),
          f"sample grid header {head!r}, want a {cols * 32}x{rows * 32} PNG")
    print(f"cli.sample: a {width}x{height} PNG ({rows}x{cols} tiles of 32x32), "
          f"{os.path.getsize(png)} bytes")


def sample_and_evaluate(card: str, model_args: list, ckpt: str, tmp: str, n: int,
                        rows: int) -> dict:
    """``sample_grid``, then ``cli.evaluate`` at 1000 samples with the
    random-init InceptionV3 on the card; returns the eval record."""
    from gan_lib_tensorflow_tpu_torch.cli import evaluate
    sample_grid(model_args, ckpt, tmp, n, rows)
    t0 = time.perf_counter()
    rec = evaluate.main(model_args + ["--ckpt-dir", ckpt, "--n-samples", "1000",
                                      "--n-real", "1000", "--data", "device-fake",
                                      "--real-stats-npz", os.path.join(tmp, "real.npz"),
                                      "--device", "cuda"])
    check(all(math.isfinite(rec[k]) for k in ("inception_score", "fid"))
          and rec["samples_evaluated"] == 1000 and rec["step"] == 12, f"eval record {rec}")
    print(f"cli.evaluate: IS {rec['inception_score']!r}, FID {rec['fid']!r} at 1000 "
          f"samples, random-init InceptionV3, {time.perf_counter() - t0:.1f} s with the "
          f"host sqrtm  [{card}]")
    return rec


def checkpoint_resume_eval(card: str, tmp: str) -> None:
    """Phase 9, in the temporary directory ``tmp``."""
    import contextlib
    import io

    import torch
    from gan_lib_tensorflow_tpu_torch.cli import evaluate, train_pggan, train_sngan
    from gan_lib_tensorflow_tpu_torch.data import DeviceFakeImages
    from gan_lib_tensorflow_tpu_torch.eval import metrics
    from gan_lib_tensorflow_tpu_torch.eval.inception_v3 import InceptionV3Features
    from gan_lib_tensorflow_tpu_torch.ops import fadein as fd
    from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi
    from gan_lib_tensorflow_tpu_torch.train import CheckpointManager
    from gan_lib_tensorflow_tpu_torch.train.pggan_loop import train_pggan_ladder

    # (a) SNGAN: fault at step 6, resume from the step-4 checkpoint to 12
    sn_args = ["--data", "device-fake", "--device", "cuda", "--batch-size", str(BATCH),
               "--n-critic", str(N_CRITIC), "--ema-decay", "0.9999", "--compute-dtype",
               "bf16", "--sample-every", "6"]
    straight, run, counts = resume_bit_equal(train_sngan.main, sn_args, tmp, "SNGAN",
                                             {"power_iteration": pi})
    launches = counts["power_iteration"]
    check(launches == [6 * 6, 6 * 8, 6 * 12],
          f"power-iteration launches {launches} in 6, 8 and 12 steps, want 6 per step")

    ckpt = CheckpointManager(os.path.join(run, "ckpt"))
    n_bytes = os.path.getsize(ckpt.path(12))
    bench = CheckpointManager(os.path.join(tmp, "bench"), max_to_keep=1)
    save_ms, restore_ms = [], []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bench.save(i, straight, wait=True)
        save_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        bench.restore_latest(straight)
        torch.cuda.synchronize()
        restore_ms.append(1e3 * (time.perf_counter() - t0))
    bench.close()
    print(f"checkpoint: {n_bytes} bytes on disk ({n_bytes / 1e6:.2f} MB); save (host "
          f"copy + write, waited) {', '.join(f'{t:.1f}' for t in save_ms)} ms; restore "
          f"(read + copy to the card) {', '.join(f'{t:.1f}' for t in restore_ms)} ms  [{card}]")

    # (b) the sample grid of that checkpoint
    sample_grid(["--model", "sngan"], os.path.join(run, "ckpt"), tmp, 64, 8)

    # (c) IS/FID through the full random-init InceptionV3, then from the cache
    passes, reals, fids = [], [], []
    timed_calls(evaluate, "evaluate_generator", passes)
    timed_calls(evaluate, "compute_statistics", reals)
    timed_calls(metrics, "frechet_distance", fids)  # host sqrtm, inside each pass
    ev_args = ["--model", "sngan", "--ckpt-dir", os.path.join(run, "ckpt"),
               "--n-samples", "5000", "--n-real", "5000", "--data", "device-fake",
               "--real-stats-npz", os.path.join(tmp, "real_stats.npz"), "--device", "cuda"]
    results, logs = [], []
    for _ in range(2):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            results.append(evaluate.main(ev_args))
        logs.append(buf.getvalue())
        print(buf.getvalue(), end="")
    first, second = results
    check(all(math.isfinite(first[k]) for k in ("inception_score", "fid"))
          and first["step"] == 12 and first["samples_evaluated"] == 5000,
          f"eval result {first}")
    check("cached real moments to" in logs[0] and "loaded cached real moments" in logs[1]
          and len(reals) == 1, "the second eval did not load the cached real moments")
    check(first == second, f"the cached-moment eval differs: {first} vs {second}")
    # the device passes without the host FID (scipy sqrtm of a 2048x2048 product)
    device_s = [p - f for p, f in zip(passes, fids)]
    print(f"eval: IS {first['inception_score']!r} +- {first['inception_score_std']!r}, "
          f"FID {first['fid']!r}, step {first['step']}; the second call (cached real "
          f"moments) agrees in every digit. Real pass 5000 images {reals[0]:.2f} s "
          f"({5000 / reals[0]:.1f} images/s); generate + features + sums of 5000 "
          f"samples {device_s[0]:.2f} s and {device_s[1]:.2f} s ({5000 / device_s[0]:.1f} "
          f"and {5000 / device_s[1]:.1f} samples/s); FID on the host (scipy sqrtm) "
          f"{fids[0]:.2f} s and {fids[1]:.2f} s; whole calls {passes[0]:.2f} s and "
          f"{passes[1]:.2f} s; float32, TF32 off  [{card}]")

    nets = [InceptionV3Features(seed=0, device=d) for d in ("cuda", "cpu")]
    x = next(iter(DeviceFakeImages(batch_size=4, device="cpu")))["image"][0]
    (f_gpu, l_gpu), (f_cpu, l_cpu) = nets[0](x.cuda()), nets[1](x)
    torch.testing.assert_close(f_gpu.cpu(), f_cpu, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(l_gpu.cpu(), l_cpu, rtol=1e-3, atol=1e-3)
    inc_err = max(float((f_gpu.cpu() - f_cpu).abs().max()),
                  float((l_gpu.cpu() - l_cpu).abs().max()))
    print(f"InceptionV3 (random init, batch statistics) features and logits of 4 "
          f"images at 32x32 on the card agree with the CPU, float32 with TF32 off "
          f"(rtol 1e-3, atol 1e-3): max abs err {inc_err:.3e}  [{card}]")
    del nets

    # (d) PGGAN to 64x64: interrupted one batch into the 64x64 transition, re-run
    class Interrupted(Exception):
        pass

    class RaiseAfterOne:
        yields_stacks = True

        def __init__(self, inner):
            self.inner = inner

        def set_stream_position(self, pos):
            self.inner.set_stream_position(pos)

        def __iter__(self):
            it = iter(self.inner)
            yield next(it)
            raise Interrupted()

    pg_args = train_pggan.parse_args([
        "--data", "device-fake", "--device", "cuda", "--final-resolution", "64",
        "--steps-per-phase", str(PGGAN_STEPS_PER_PHASE), "--log-every", "1",
        "--compute-dtype", "bf16", "--out-dir", os.path.join(tmp, "pggan"),
        "--ckpt-every", "1", "--sample-every", str(PGGAN_STEPS_PER_PHASE)])
    cfg = train_pggan.ladder_config(pg_args)
    make_source = train_pggan.source_factory(pg_args)
    counts, current = [], []

    def hook(when, res, name, st):
        if when == "start":
            current[:] = [(res, name)]
            counts.append([res, name, fd.launches, pi.launches])
        else:
            torch.cuda.synchronize()
            counts[-1][2:] = [fd.launches - counts[-1][2], pi.launches - counts[-1][3], st.step]

    def interrupting(res, batch):
        src = make_source(res, batch)
        return RaiseAfterOne(src) if current[0] == (64, "transition") else src

    t0 = time.perf_counter()
    fd.launches = pi.launches = 0  # count this path's launches only
    try:
        train_pggan_ladder(cfg, interrupting, phase_hook=hook, log_fn=lambda it, m: None)
        check(False, "the interrupting source did not raise")
    except Interrupted:
        counts[-1][2:] = [fd.launches - counts[-1][2], pi.launches - counts[-1][3]]
    totals = [(fd.launches, pi.launches)]
    first_run, counts = counts, []
    fd.launches = pi.launches = 0
    resumed_pg = train_pggan_ladder(cfg, make_source, phase_hook=hook,
                                    log_fn=lambda it, m: None)
    torch.cuda.synchronize()
    totals.append((fd.launches, pi.launches))
    pg_s = time.perf_counter() - t0
    check(len(first_run) == 8 and len(counts) == 9, f"{len(first_run)} and {len(counts)} "
          "phases in the interrupted run and the re-run, want 8 and 9")
    check(resumed_pg.step == PGGAN_STEPS_PER_PHASE and resumed_pg.alpha == 1.0,
          "the re-run ladder did not end in the 64x64 stabilize phase")
    # a transition phase trained to its end launches 6 per step + 1 for its grid
    full = 6 * PGGAN_STEPS_PER_PHASE + 1
    want_first = [full if n == "transition" else 0 for _, n, *_ in first_run[:-1]] + [6]
    want_again = [0] * 7 + [6 * (PGGAN_STEPS_PER_PHASE - 1) + 1, 0]
    got_first = [rec[2] for rec in first_run]
    got_again = [rec[2] for rec in counts]
    check(got_first == want_first and got_again == want_again,
          f"fade-in launches per phase {got_first} then {got_again}, want "
          f"{want_first} then {want_again}")
    check(totals == [(sum(got_first), 0), (sum(got_again), 0)],
          f"PGGAN ladder runs launched (fade-in, power iteration) {totals}, want "
          f"{[(sum(got_first), 0), (sum(got_again), 0)]}")
    print(f"PGGAN ladder 4x4 -> 64x64 at full width, per-phase checkpoints: interrupted "
          f"after 1 step of the 64x64 transition (fade-in launches per phase "
          f"{got_first}), re-run resumed every phase (launches {got_again}: 6 per "
          f"transition step, 1 per transition sample grid), {pg_s:.1f} s for both runs")


def captured(module, name: str, sink: list) -> None:
    """Wrap ``module.name`` so each call appends its return value to
    ``sink`` (the data source a CLI builds inside its ``main``)."""
    inner = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = inner(*args, **kwargs)
        sink.append(out)
        return out

    setattr(module, name, wrapped)
    return inner


def last_sec_per_step(out_dir: str) -> float:
    """``sec_per_step`` of the last line of ``log.jsonl``: the wall time of
    the last ``LOG_EVERY`` steps, the metric read that ends them included."""
    with open(os.path.join(out_dir, "log.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    check(all(math.isfinite(v) for rec in lines for v in rec.values()),
          f"non-finite metrics in {out_dir}/log.jsonl")
    return lines[-1]["sec_per_step"]


def write_cifar(path: str, seed: int = 0) -> None:
    """A synthetic ``cifar-10-batches-py`` at the real layout and size."""
    import numpy as np
    os.makedirs(path)
    rng = np.random.default_rng(seed)
    for name in CIFAR_FILES:
        with open(os.path.join(path, name), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (CIFAR_PER_FILE, 3072), "uint8"),
                         b"labels": rng.integers(0, 10, CIFAR_PER_FILE).tolist()}, f)


def calibrated_inception_npz(path: str, images) -> None:
    """Write the port's random-init InceptionV3 in the npz layout the
    reference's converter writes, its stored BN statistics set to the batch
    statistics of ``images`` (so the stored-statistics extractor a graded
    run loads normalizes as the random-init one does)."""
    import torch
    from gan_lib_tensorflow_tpu_torch.eval.inception_v3 import (BasicConv, InceptionV3Features,
                                                                save_params_npz)
    net = InceptionV3Features(seed=0, device="cuda")  # batch statistics
    convs = [m for m in net.model.modules() if isinstance(m, BasicConv)]
    stats = {}
    hooks = [m.conv.register_forward_hook(
        lambda mod, inp, out, m=m: stats.__setitem__(
            m, (out.mean(dim=(0, 2, 3)), out.var(dim=(0, 2, 3), unbiased=False))))
        for m in convs]
    net(images)
    for h in hooks:
        h.remove()
    with torch.no_grad():
        for m in convs:
            m.moving_mean.copy_(stats[m][0])
            m.moving_variance.copy_(stats[m][1])
    save_params_npz(path, net.model)


def data_layer_and_north_star(card: str, tmp: str) -> None:
    """Phase 10, in the temporary directory ``tmp``."""
    import numpy as np
    import torch
    from gan_lib_tensorflow_tpu_torch import data
    from gan_lib_tensorflow_tpu_torch.cli import common, north_star, train_sngan
    from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi
    from gan_lib_tensorflow_tpu_torch.train.loop import device_batches

    cifar = os.path.join(tmp, "cifar-10-batches-py")
    t0 = time.perf_counter()
    write_cifar(cifar)
    host = data.Cifar10(data_dir=cifar)
    check(host.images.shape == (50_000, 32, 32, 3), f"CIFAR store {host.images.shape}")
    print(f"synthetic CIFAR-10 at the real layout: {len(CIFAR_FILES)} pickles of "
          f"{CIFAR_PER_FILE} images, written and read in {time.perf_counter() - t0:.2f} s")

    # (a) the full-width SNGAN step on the store held on the card
    sources = []
    inner = captured(common, "image_source", sources)
    run = os.path.join(tmp, "sngan_cifar")
    sn_args = ["--data", cifar, "--device", "cuda", "--batch-size", str(BATCH),
               "--n-critic", str(N_CRITIC), "--compute-dtype", "bf16",
               "--log-every", str(LOG_EVERY), "--sample-every", "1000", "--ckpt-every", "1000"]
    try:
        pi.launches = 0  # count this path's launches only
        state = train_sngan.main(sn_args + ["--steps", str(CIFAR_STEPS), "--out-dir", run])
        torch.cuda.synchronize()
        launches = pi.launches
    finally:
        common.image_source = inner
    src = sources[0]
    check(isinstance(src, data.DeviceCachedStore), f"--data <dir> gave {type(src).__name__}")
    resident = src.nbytes_resident()
    check(resident >= 153_600_000, f"{resident} bytes resident, want the whole store")
    check(state.step == CIFAR_STEPS and launches == (N_CRITIC + 1) * CIFAR_STEPS,
          f"power-iteration launches {launches} in {state.step} steps, want 6 per step")
    sps = last_sec_per_step(run)
    idx = src.indices_for(5)
    dev = src.gather(idx)
    want = data.normalize_u8(torch.from_numpy(host.images[idx]))
    check(torch.equal(dev["image"].cpu(), want)
          and np.array_equal(dev["image"].cpu().numpy(),
                             data.base.normalize_u8_np(host.images[idx]))
          and np.array_equal(dev["label"].cpu().numpy(), host.labels[idx]),
          "a device batch differs from the host gather of the same indices")
    print(f"SNGAN on CIFAR-10 held on the card: {resident} bytes resident, "
          f"{1e3 * sps:.2f} ms/step over steps {CIFAR_STEPS - LOG_EVERY + 1}-{CIFAR_STEPS} "
          f"({N_CRITIC * BATCH / sps:.1f} images/s), power-iteration launches {launches} in "
          f"{CIFAR_STEPS} steps; step 5's batch [{N_CRITIC}, {BATCH}, 32, 32, 3] gathered and "
          f"normalized on the card equals the host gather bit for bit  [{card}]")

    # (b) streamed: uint8 from one host worker, normalized on the card
    args = train_sngan.parse_args(sn_args + ["--device-cache", "off"])
    streamed = common.image_source(args, BATCH, 32, 10, n_micro=N_CRITIC)
    check(isinstance(streamed, data.ThreadedSource), "--device-cache off did not stream")
    first = next(device_batches(streamed, N_CRITIC, torch.device("cuda")))
    worker = iter(data.Cifar10(batch_size=BATCH, data_dir=cifar, seed=args.seed + 1000003))
    for i in range(N_CRITIC):
        b = next(worker)
        check(torch.equal(first["image"][i].cpu(), data.normalize_u8(torch.from_numpy(b["image"])))
              and np.array_equal(first["label"][i].cpu().numpy(), b["label"]),
              f"streamed microbatch {i} differs from the host stream")
    pi.launches = 0
    t0 = time.perf_counter()
    state = train_sngan.main(sn_args + ["--device-cache", "off", "--steps", "2",
                                        "--out-dir", os.path.join(tmp, "sngan_streamed")])
    torch.cuda.synchronize()
    check(state.step == 2 and pi.launches == 2 * (N_CRITIC + 1),
          f"streamed run: {pi.launches} launches in 2 steps")
    print(f"--device-cache off: the first stack through prefetch_to_device equals the "
          f"host worker's uint8 batches normalized on the CPU, bit for bit; 2 steps "
          f"trained ({time.perf_counter() - t0:.2f} s with the build), {pi.launches} launches")
    del state, src, sources

    # (c) the north star on that directory, graded with a random extractor
    npz = os.path.join(tmp, "inception_v3.npz")
    calibrated_inception_npz(npz, data.normalize_u8(torch.from_numpy(host.images[:64])).cuda())
    out = os.path.join(tmp, "north_star")
    t0 = time.perf_counter()
    rc = north_star.main(["--data-dir", tmp, "--inception-weights", npz, "--out-dir", out,
                          "--steps", "4", "--n-samples", "1000", "--n-real", "1000",
                          "--device", "cuda"])
    ns_s = time.perf_counter() - t0
    with open(os.path.join(out, "north_star_result.json")) as f:
        rec = json.load(f)
    check(rc in (0, 1) and rec["graded"] is True and rec["verdict"] in ("PASS", "FAIL")
          and math.isfinite(rec["fid"]) and rec["step"] == 4
          and rec["extractor"] == "inception_v3_pretrained"
          and os.path.abspath(rec["real_source"]) == os.path.abspath(cifar),
          f"north star rc {rc}, record {rec}")
    print(f"north_star: rc {rc}, verdict {rec['verdict']} (graded {rec['graded']}), FID "
          f"{rec['fid']!r}, IS {rec['inception_score']!r}, 4 steps, 1000 samples and 1000 "
          f"reals, {ns_s:.1f} s  [{card}]")


def imagenet128(card: str, tmp: str) -> int:
    """Phase 11, in the temporary directory ``tmp``; returns the batch-norm
    kernels' forward and backward calls in its run."""
    import numpy as np
    import torch
    from gan_lib_tensorflow_tpu_torch.cli import train_sngan_imagenet
    from gan_lib_tensorflow_tpu_torch.data.packed import finalize_store, write_store
    from gan_lib_tensorflow_tpu_torch.models import sngan
    from gan_lib_tensorflow_tpu_torch.ops import norms
    from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi

    store = os.path.join(tmp, "imagenet128")
    t0 = time.perf_counter()
    images, labels = write_store(store, IMAGENET_STORE, 128, 128, 3,
                                 classes=[str(c) for c in range(1000)])
    rng = np.random.default_rng(1)
    images[:] = rng.integers(0, 256, images.shape, np.uint8)
    labels[:] = rng.integers(0, 1000, IMAGENET_STORE)
    finalize_store(store, images, labels)
    del images
    print(f"packed store: {IMAGENET_STORE} images of 128x128x3 with 1000-class labels "
          f"({IMAGENET_STORE * 128 * 128 * 3} bytes), written in {time.perf_counter() - t0:.2f} s")

    run = os.path.join(tmp, "imagenet_run")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pi.launches = norms.launches = norms.backward_launches = 0  # this path's launches only
    t0 = time.perf_counter()
    state = train_sngan_imagenet.main([
        "--data", store, "--device", "cuda", "--steps", str(IMAGENET_STEPS),
        "--log-every", str(LOG_EVERY), "--sample-every", "1000", "--ckpt-every", "1000",
        "--compute-dtype", "bf16", "--out-dir", run])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = pi.launches
    peak = torch.cuda.max_memory_allocated()
    check(state.step == IMAGENET_STEPS and launches == (N_CRITIC + 1) * IMAGENET_STEPS,
          f"power-iteration launches {launches} in {state.step} steps, want 6 per step")
    # 11 norms in the fakes' forward and 11 in the G update's, 11 backward a
    # step; the last step's sample grid adds one forward of G (11)
    bn = (norms.launches - norms.backward_launches, norms.backward_launches)
    check(bn == (22 * IMAGENET_STEPS + 11, 11 * IMAGENET_STEPS),
          f"batch-norm calls (forward, backward) {bn} in {state.step} steps and a sample grid, "
          f"want 22 and 11 a step and 11 for the grid")
    d = state.d
    dims = [(m.weight[0].numel(), m.weight.shape[0]) for m in d.sn_layers]
    check(len(dims) == 19, f"{len(dims)} SN weights in the ImageNet-128 D")
    max_ctas = pi.max_ctas(torch.device("cuda"))
    plan = pi.plan_power_iteration(dims, max_ctas)  # what D's table was built from
    streamed = [i for i, (m, k) in enumerate(dims) if not pi.slab_fits(m, k)]
    names = [n for n, m in d.named_modules() if m in d.sn_layers]
    sps = last_sec_per_step(run)
    print(f"SNGAN-projection ImageNet-128, full width, 1000 classes, batch {BATCH}, n_critic "
          f"{N_CRITIC}, bf16, from the store held on the card: images/s/GPU "
          f"{N_CRITIC * BATCH / sps:.1f}  ms/step {1e3 * sps:.2f} (steps "
          f"{IMAGENET_STEPS - LOG_EVERY + 1}-{IMAGENET_STEPS})  peak memory "
          f"{peak / 2**20:.0f} MiB  kernel launches {launches} in {IMAGENET_STEPS} steps "
          f"(batch norm: {bn[0]} forward, {bn[1]} backward calls); "
          f"{run_s:.1f} s for the run with its build  [{card}]")
    stream_ctas = [c for c in plan.ctas if c.kind == pi.STREAM]
    check(len(stream_ctas) == len(plan.ctas) == max_ctas and plan.items,
          f"the ImageNet-128 D's plan: {len(stream_ctas)} streaming CTAs of {len(plan.ctas)}")
    per_cta = [sum(4 * dims[it.weight][1] * it.width for it in plan.items[c.col0:c.col0 + c.width])
               for c in stream_ctas]
    parts = {it.weight: it.parts for it in plan.items}
    print(f"power-iteration plan of D's 19 weights: the slabs of "
          + ", ".join(f"{names[i]} {list(dims[i])}" for i in streamed)
          + f" do not fit in shared memory, so all 19 stream: {len(plan.ctas)} CTAs (the card "
          f"holds {max_ctas} at once), {plan.smem_bytes} B of shared memory and "
          f"{plan.slots} chunk slots per CTA, {len(plan.items)} items, W bytes per CTA "
          f"{min(per_cta)}-{max(per_cta)} ({max(per_cta) / min(per_cta):.3f} max/min); parts "
          + ", ".join(f"{names[i]} {parts[i]}" for i in streamed))

    # the kernel at D's 19 weights against its plain version
    err = compare_kernel(pi, torch, dims, 4)
    print(f"batched_power_iteration at the ImageNet-128 D's 19 weights "
          f"({sum(m * k for m, k in dims)} values): sigma/u'/v/grad agree with the plain "
          f"version (rtol 1e-4, TF32 off), max abs err {err:.3e}")

    # full-width float32 G and D, card vs CPU, batch 2
    g32 = sngan.imagenet128_generator()
    d32 = sngan.imagenet128_discriminator()
    g32.load_state_dict(state.g.state_dict())
    d32.load_state_dict(d.state_dict())
    gen = torch.Generator().manual_seed(0)
    z = torch.randn(2, 128, generator=gen)
    lab = torch.tensor([3, 997])
    with torch.no_grad():
        imgs_cpu = g32(z, lab, train=False)
        logits_cpu = d32(imgs_cpu, lab)
        imgs = g32.cuda()(z.cuda(), lab.cuda(), train=False)
        logits = d32.cuda()(imgs, lab.cuda())
    check(tuple(imgs.shape) == (2, 128, 128, 3) and bool(torch.isfinite(imgs).all())
          and bool(torch.isfinite(logits).all()), "ImageNet-128 G/D output not finite")
    torch.testing.assert_close(imgs.cpu(), imgs_cpu, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(logits.cpu(), logits_cpu, rtol=1e-3, atol=1e-3)
    print(f"float32 ImageNet-128 G and D at full width on the card agree with the CPU "
          f"(rtol 1e-3, atol 1e-3): max abs err images "
          f"{float((imgs.cpu() - imgs_cpu).abs().max()):.3e}, logits "
          f"{float((logits.cpu() - logits_cpu).abs().max()):.3e}")
    del g32, d32, state

    # the 19-weight launch by device time
    ws = [m.weight.detach() for m in d.sn_layers]
    us = [m.u.detach().clone() for m in d.sn_layers]
    table = pi.PowerIterationTable()
    first, second = pi.launch(ws, us, table=table), pi.launch(ws, us, table=table)
    check(all(torch.equal(x, y) for x, y in zip(first, second))
          and table.counters.tolist() == [0] * len(ws),
          "two launches at the ImageNet-128 D's weights differ, or a counter is left set")
    del first, second
    t = timed_in_turns({"kernel": lambda: pi.launch(ws, us, table=table),
                        "plain": lambda: pi.plain_power_iteration(ws, us)}, 50)
    floor_ms = device_ms(lambda: pi.launch_empty(table), 200)
    # W cold in L2, as after the step's convolutions: 256 MB written between
    # launches (five times the 50 MB L2), that write's own time taken away
    flush = torch.empty(64 << 20, device="cuda")
    cold = timed_in_turns({"kernel": lambda: (flush.add_(1.0), pi.launch(ws, us, table=table)),
                           "flush": lambda: flush.add_(1.0)}, 20)
    cold_ms = cold["kernel"] - cold["flush"]
    del flush
    ms_, ks = [m for m, _ in dims], [k for _, k in dims]
    n_bytes = 4 * (sum(m * k for m, k in dims) + sum(ks) + len(ws) + sum(ks) + sum(ms_))
    n_flops = sum(4 * m * k for m, k in dims)
    bound_ms = 1e3 * max(n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_FP32_FLOPS)
    print(f"batched_power_iteration, ImageNet-128 D (19 weights): kernel "
          f"{1e3 * t['kernel']:.2f} us, plain {1e3 * t['plain']:.2f} us, empty-kernel floor "
          f"{1e3 * floor_ms:.2f} us, bound {1e3 * bound_ms:.2f} us (bytes: {n_bytes} B at "
          f"3.35 TB/s; {n_flops} flop), {n_bytes / t['kernel'] / 1e9:.3f} TB/s, "
          f"{bound_ms / t['kernel']:.3f} of the bound; {N_CRITIC + 1} launches per step "
          f"{(N_CRITIC + 1) * 1e3 * t['kernel']:.1f} us of {1e3 * sps:.2f} ms; two launches "
          f"bit-identical  [{card}]")
    print(f"  with W cold in L2 (256 MB written between launches, its {1e3 * cold['flush']:.2f} "
          f"us taken away): {1e3 * cold_ms:.2f} us, {n_bytes / cold_ms / 1e9:.3f} TB/s, "
          f"{bound_ms / cold_ms:.3f} of the bound  [{card}]")
    # where the launch's time goes: the 9 weights that need streaming, the
    # other 10 (which alone take path 1), the three largest (the 37.75 MB
    # convs) and the first of them alone, each as its own launch
    largest = sorted(range(len(dims)), key=lambda i: -dims[i][0] * dims[i][1])[:3]
    for label, sel in (("too large for shared memory", streamed),
                       ("slabs in shared memory", [i for i in range(len(dims)) if i not in streamed]),
                       ("three largest (" + ", ".join(names[i] for i in largest) + ")", largest),
                       (f"largest alone ({names[largest[0]]})", largest[:1])):
        if not sel:
            continue
        sub_w, sub_u, sub_t = [ws[i] for i in sel], [us[i] for i in sel], pi.PowerIterationTable()
        sub_ms = device_ms(lambda: pi.launch(sub_w, sub_u, table=sub_t), 50)
        w_bytes = 4 * sum(dims[i][0] * dims[i][1] for i in sel)
        print(f"  {label}: {len(sel)} weights, {w_bytes} B of W, {1e3 * sub_ms:.2f} us, "
              f"{w_bytes / sub_ms / 1e9:.3f} TB/s of W read once, bound "
              f"{1e6 * w_bytes / PEAK_BYTES_PER_S:.2f} us  [{card}]")
    return sum(bn)


def acgan_and_conditional_sngan(card: str, tmp: str) -> int:
    """Phase 12, in the temporary directory ``tmp``. Returns the
    power-iteration launches of the conditional SNGAN's timed run."""
    import torch
    from gan_lib_tensorflow_tpu_torch.cli import train_acgan, train_sngan
    from gan_lib_tensorflow_tpu_torch.models import acgan, sngan
    from gan_lib_tensorflow_tpu_torch.ops import fadein as fd
    from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi

    kernels = {"power_iteration": pi, "fadein_blend": fd}

    # (a) ACGAN at full width through its CLI: timed, then faulted and resumed
    ac_args = ["--data", "device-fake", "--device", "cuda", "--batch-size", str(ACGAN_BATCH),
               "--compute-dtype", "bf16", "--adversarial", "bce", "--aux-weight", "1.0",
               "--sample-every", "1000"]
    timed_dir = os.path.join(tmp, "acgan_timed")
    pi.launches = fd.launches = 0  # count this path's launches only
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = train_acgan.main(ac_args + ["--steps", str(ACGAN_STEPS), "--log-every", str(LOG_EVERY),
                                     "--ckpt-every", "1000", "--out-dir", timed_dir])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ac_launches = (pi.launches, fd.launches)
    check(st.step == ACGAN_STEPS and ac_launches == (0, 0),
          f"ACGAN: (power iteration, fade-in) launches {ac_launches} in {st.step} steps, want 0")
    sps = last_sec_per_step(timed_dir)
    g, d = st.g, st.d
    print(f"ACGAN CIFAR-10, full width (G base 384, z 110; D base 64, dropout 0.3), batch "
          f"{ACGAN_BATCH}, bf16, bce, aux 1.0: images/s/GPU {ACGAN_BATCH / sps:.1f}  ms/step "
          f"{1e3 * sps:.2f} (steps {ACGAN_STEPS - LOG_EVERY + 1}-{ACGAN_STEPS})  peak memory "
          f"{peak / 2**20:.0f} MiB  launches: power iteration {ac_launches[0]}, fade-in "
          f"{ac_launches[1]}; {run_s:.1f} s for the run with its build  [{card}]")
    del st

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        _, ac_dir, counts = resume_bit_equal(train_acgan.main, ac_args, tmp, "ACGAN", kernels)
    finally:
        torch.backends.cudnn.deterministic = False
    check(all(v == [0, 0, 0] for v in counts.values()), f"ACGAN launched a kernel: {counts}")

    # float32 G and D, card vs CPU, batch 2, the same dropout masks on both
    g32, d32 = acgan.ACGANGenerator(), acgan.ACGANDiscriminator()
    g32.load_state_dict(g.state_dict())
    d32.load_state_dict(d.state_dict())
    gen = torch.Generator().manual_seed(0)
    z, lab = torch.randn(2, 110, generator=gen), torch.tensor([3, 8])
    masks = d32.draw_masks(2, gen)
    with torch.no_grad():
        imgs_cpu = g32(z, lab, train=False)
        adv_cpu, cls_cpu = d32(imgs_cpu, masks)
        imgs = g32.cuda()(z.cuda(), lab.cuda(), train=False)
        adv, cls = d32.cuda()(imgs, [m.cuda() for m in masks])
    check(tuple(imgs.shape) == (2, 32, 32, 3) and bool(torch.isfinite(imgs).all())
          and bool(torch.isfinite(cls).all()), "ACGAN G/D output not finite")
    for a, b in ((imgs, imgs_cpu), (adv, adv_cpu), (cls, cls_cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-3)
    print(f"float32 ACGAN G and D (dropout masks injected) at full width on the card agree "
          f"with the CPU (rtol 1e-3, atol 1e-3): max abs err images "
          f"{float((imgs.cpu() - imgs_cpu).abs().max()):.3e}, logits "
          f"{max(float((adv.cpu() - adv_cpu).abs().max()), float((cls.cpu() - cls_cpu).abs().max())):.3e}")
    del g, d, g32, d32
    sample_and_evaluate(card, ["--model", "acgan"], os.path.join(ac_dir, "ckpt"),
                        tmp, 100, 10)

    # (b) the conditional CIFAR SNGAN at full width: 12 SN weights per launch
    sn_args = ["--data", "device-fake", "--device", "cuda", "--batch-size", str(BATCH),
               "--n-critic", str(N_CRITIC), "--compute-dtype", "bf16", "--num-classes", "10",
               "--sample-every", "1000", "--ckpt-every", "1000"]
    run = os.path.join(tmp, "sngan_cond")
    pi.launches = fd.launches = 0  # count this path's launches only
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = train_sngan.main(sn_args + ["--steps", str(CIFAR_STEPS), "--log-every", str(LOG_EVERY),
                                     "--out-dir", run])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    cond_launches = pi.launches
    d = st.d
    check(st.step == CIFAR_STEPS and cond_launches == (N_CRITIC + 1) * CIFAR_STEPS
          and fd.launches == 0,
          f"conditional SNGAN: power-iteration launches {cond_launches} in {st.step} steps, "
          f"want 6 per step")
    check(len(d.sn_layers) == 12 and len(d._sn_table.ms) == 12
          and d.sn_layers[-1] is d.proj_embed,
          f"the conditional D's kernel table holds {len(d._sn_table.ms)} weights, want 12")
    sps = last_sec_per_step(run)
    dims = [(m.weight[0].numel(), m.weight.shape[0]) for m in d.sn_layers]
    print(f"conditional SNGAN CIFAR-10 (10 classes), full width, batch {BATCH}, n_critic "
          f"{N_CRITIC}, bf16: images/s/GPU {N_CRITIC * BATCH / sps:.1f}  ms/step "
          f"{1e3 * sps:.2f} (steps {CIFAR_STEPS - LOG_EVERY + 1}-{CIFAR_STEPS})  peak memory "
          f"{peak / 2**20:.0f} MiB  power-iteration launches {cond_launches} in {CIFAR_STEPS} "
          f"steps, each over D's 12 weights (proj_embed {list(d.proj_embed.weight.shape)}); "
          f"{run_s:.1f} s "
          f"for the run  [{card}]")

    # the 12-weight kernel against its plain version, and two launches
    err = compare_kernel(pi, torch, dims, 5)
    ws = [m.weight.detach() for m in d.sn_layers]
    us = [m.u.detach().clone() for m in d.sn_layers]
    first, second = pi.launch(ws, us), pi.launch(ws, us)
    check(all(torch.equal(x, y) for x, y in zip(first, second)),
          "two 12-weight launches on the same inputs differ")
    print(f"batched_power_iteration at the conditional D's 12 weights "
          f"({sum(m * k for m, k in dims)} values): sigma/u'/v/grad agree with the plain "
          f"version (rtol 1e-4, TF32 off), max abs err {err:.3e}; two launches bit-identical")

    # float32 G and D, card vs CPU (the plain power iteration on the CPU)
    g32 = sngan.cifar_generator(num_classes=10)
    d32 = sngan.cifar_discriminator(num_classes=10)
    g32.load_state_dict(st.g.state_dict())
    d32.load_state_dict(d.state_dict())
    gen = torch.Generator().manual_seed(0)
    z, lab = torch.randn(4, 128, generator=gen), torch.tensor([0, 3, 7, 9])
    with torch.no_grad():
        imgs_cpu = g32(z, lab, train=False)
        logits_cpu = d32(imgs_cpu, lab)
        imgs = g32.cuda()(z.cuda(), lab.cuda(), train=False)
        logits = d32.cuda()(imgs, lab.cuda())
    check(bool(torch.isfinite(imgs).all()) and bool(torch.isfinite(logits).all()),
          "conditional SNGAN G/D output not finite")
    torch.testing.assert_close(imgs.cpu(), imgs_cpu, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(logits.cpu(), logits_cpu, rtol=1e-3, atol=1e-3)
    print(f"float32 conditional SNGAN G and D at full width on the card agree with the CPU "
          f"(rtol 1e-3, atol 1e-3): max abs err images "
          f"{float((imgs.cpu() - imgs_cpu).abs().max()):.3e}, logits "
          f"{float((logits.cpu() - logits_cpu).abs().max()):.3e}")
    del g32, d32

    # the 12-weight launch by device time, beside the 11-weight one and the bound
    t11, t12 = pi.PowerIterationTable(), pi.PowerIterationTable()
    t = timed_in_turns({"12": lambda: pi.launch(ws, us, table=t12),
                        "11": lambda: pi.launch(ws[:11], us[:11], table=t11),
                        "plain": lambda: pi.plain_power_iteration(ws, us)}, 200)
    ms_, ks = [m for m, _ in dims], [k for _, k in dims]
    n_bytes = 4 * (sum(m * k for m, k in dims) + sum(ks) + len(ws) + sum(ks) + sum(ms_))
    n_flops = sum(4 * m * k for m, k in dims)
    bound_ms = 1e3 * max(n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_FP32_FLOPS)
    print(f"batched_power_iteration, conditional CIFAR D (12 weights): kernel "
          f"{1e3 * t['12']:.2f} us, the first 11 alone {1e3 * t['11']:.2f} us, plain "
          f"{1e3 * t['plain']:.2f} us, bound {1e3 * bound_ms:.3f} us (bytes: {n_bytes} B at "
          f"3.35 TB/s; {n_flops} flop); {N_CRITIC + 1} launches per step "
          f"{(N_CRITIC + 1) * 1e3 * t['12']:.1f} us of {1e3 * sps:.2f} ms  [{card}]")
    del st, d, ws, us
    sample_and_evaluate(card, ["--model", "sngan", "--num-classes", "10"],
                        os.path.join(run, "ckpt"), tmp, 64, 8)
    return cond_launches


def pix2pix_full_width(card: str, tmp: str) -> None:
    """Phase 13, in the temporary directory ``tmp``."""
    import numpy as np
    import torch
    from gan_lib_tensorflow_tpu_torch.cli import train_pix2pix
    from gan_lib_tensorflow_tpu_torch.data import DeviceCachedPairedStore, PackedPairedStore
    from gan_lib_tensorflow_tpu_torch.data.base import normalize_u8_np
    from gan_lib_tensorflow_tpu_torch.data.packed import finalize_store, write_store
    from gan_lib_tensorflow_tpu_torch.models import pix2pix
    from gan_lib_tensorflow_tpu_torch.ops import fadein as fd
    from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi

    kernels = {"power_iteration": pi, "fadein_blend": fd}
    pi.launches = fd.launches = 0  # every launch of the whole phase counts
    store = os.path.join(tmp, "facades")
    t0 = time.perf_counter()
    rows, _ = write_store(store, PIX_PAIRS, PIX_SCALE, 2 * PIX_SCALE, 3, paired=True)
    rng = np.random.default_rng(13)
    for i in range(0, PIX_PAIRS, 50):
        rows[i:i + 50] = rng.integers(0, 256, rows[i:i + 50].shape, np.uint8)
    finalize_store(store, rows, None)
    n_bytes = rows.nbytes
    del rows
    print(f"packed paired store: {PIX_PAIRS} pairs of {PIX_SCALE}x{2 * PIX_SCALE}x3 "
          f"({n_bytes} bytes), written in {time.perf_counter() - t0:.2f} s")

    # (a) full width through the CLI, from the store held on the card
    sources = []
    inner = captured(train_pix2pix, "paired_source", sources)
    args = ["--data", store, "--device", "cuda", "--image-size", str(PIX_SIZE),
            "--scale-size", str(PIX_SCALE), "--ngf", str(PIX_WIDTH), "--ndf", str(PIX_WIDTH),
            "--compute-dtype", "bf16", "--sample-every", "1000"]
    run = os.path.join(tmp, "pix2pix_timed")
    n_steps = PIX_WARM + PIX_TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        st = train_pix2pix.main(args + ["--steps", str(n_steps), "--log-every", str(PIX_WARM),
                                        "--ckpt-every", "1000", "--out-dir", run])
    finally:
        train_pix2pix.paired_source = inner
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    (src,) = sources
    check(isinstance(src, DeviceCachedPairedStore) and src.nbytes_resident() == n_bytes,
          f"pix2pix did not take the device-cached route: {type(src).__name__}")
    with open(os.path.join(run, "log.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    check(len(lines) == n_steps // PIX_WARM and all(
        math.isfinite(v) for rec in lines for v in rec.values()), "pix2pix metrics not finite")
    timed = [rec["sec_per_step"] for rec in lines[1:]]  # steps PIX_WARM+1 .. n_steps
    sps = statistics.mean(timed)
    g, d = st.g, st.d
    print(f"pix2pix, full width (U-Net ngf {PIX_WIDTH}, PatchGAN ndf {PIX_WIDTH}), "
          f"{PIX_SIZE}x{PIX_SIZE}, batch 1, bf16, from the store held on the card "
          f"({src.nbytes_resident()} bytes resident): ms/step {1e3 * sps:.2f} over steps "
          f"{PIX_WARM + 1}-{n_steps} (per {PIX_WARM} steps: "
          + ", ".join(f"{1e3 * t:.2f}" for t in timed) + f"), images/s/GPU {1 / sps:.1f}  "
          f"peak memory {peak / 2**20:.0f} MiB; {run_s:.1f} s for the run with its build; "
          f"G {sum(p.numel() for p in g.parameters())} and D "
          f"{sum(p.numel() for p in d.parameters())} parameters; last metrics "
          + " ".join(f"{k} {v:.4g}" for k, v in lines[-1].items() if k != "step")
          + f"  [{card}]")

    # (b) one device batch against the host jitter of the same controls
    host = PackedPairedStore(store, batch_size=1, image_size=PIX_SIZE, seed=0)
    for pos in (0, 399, 1234):
        controls = src.controls_for(pos)
        got = {k: v.cpu().numpy()[0] for k, v in src.gather(*controls).items()}
        want = host._crops(*controls)
        (i,), (y,), (x,), (f,) = controls
        row = np.asarray(host.images[i])
        for k, x0 in (("input", 0), ("target", PIX_SCALE)):
            win = row[y:y + PIX_SIZE, x0 + x:x0 + x + PIX_SIZE]
            plain = normalize_u8_np(win[:, ::-1] if f else win)
            check(np.array_equal(got[k].view(np.uint32), want[k].view(np.uint32))
                  and np.array_equal(got[k][0].view(np.uint32), plain.view(np.uint32)),
                  f"device batch {pos} ({k}) differs from the host jitter")
    print("device batches at positions 0, 399, 1234 bit-equal to the host jitter of the "
          "same controls_for(pos) (crop, flip, normalize; and to a numpy slice)")
    del st, src, sources

    # (c) faulted and resumed, bit-equal, under deterministic cuDNN
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        _, pix_dir, counts = resume_bit_equal(train_pix2pix.main, args, tmp, "pix2pix",
                                              kernels)

        # (d) float32 G and D, card vs CPU, the same dropout masks
        g32 = pix2pix.UNetGenerator(PIX_SIZE, PIX_WIDTH)
        d32 = pix2pix.PatchGANDiscriminator(PIX_WIDTH)
        g32.load_state_dict(g.state_dict())
        d32.load_state_dict(d.state_dict())
        gen = torch.Generator().manual_seed(0)
        x = torch.rand(1, PIX_SIZE, PIX_SIZE, 3, generator=gen) * 2 - 1
        masks = g32.draw_masks(1, gen)
        with torch.no_grad():
            out_cpu = g32(x, masks, train=False)
            logits_cpu = d32(x, out_cpu, train=True, update_stats=False)
            out = g32.cuda()(x.cuda(), [m.cuda() for m in masks], train=False)
            logits = d32.cuda()(x.cuda(), out, train=True, update_stats=False)
        check(tuple(out.shape) == (1, PIX_SIZE, PIX_SIZE, 3)
              and tuple(logits.shape) == (1, PIX_SIZE // 8 - 2, PIX_SIZE // 8 - 2, 1)
              and bool(torch.isfinite(out).all())
              and bool(torch.isfinite(logits).all()), "pix2pix G/D output not finite")
        torch.testing.assert_close(out.cpu(), out_cpu, rtol=1e-3, atol=1e-3)
        torch.testing.assert_close(logits.cpu(), logits_cpu, rtol=1e-3, atol=1e-3)
        print(f"float32 pix2pix G (train=False, dropout masks injected) and D (batch "
              f"statistics) at full width on the card agree with the CPU (rtol 1e-3, atol "
              f"1e-3): max abs err images {float((out.cpu() - out_cpu).abs().max()):.3e}, "
              f"30x30 logits {float((logits.cpu() - logits_cpu).abs().max()):.3e}")
        del g, d, g32, d32

        # (e) the test pass and the export bundle of the resumed run's checkpoint
        t0 = time.perf_counter()
        metrics = train_pix2pix.main(args + ["--mode", "test", "--out-dir", pix_dir,
                                             "--max-test-images", "8"])
        check(metrics["n_examples"] == 8 and metrics["step"] == 12
              and math.isfinite(metrics["test_l1"]), f"test metrics {metrics}")
        with open(os.path.join(pix_dir, "test_metrics.json")) as f:
            check(json.load(f) == metrics, "test_metrics.json differs from the returned metrics")
        with open(os.path.join(pix_dir, "index.html")) as f:
            check(f.read().count("<tr><td>") == 8, "index.html does not list 8 examples")
        for j in range(8):
            for kind in ("input", "output", "target"):
                with open(os.path.join(pix_dir, "images", f"{j:05d}-{kind}.png"), "rb") as f:
                    head = f.read(24)
                check(head[:8] == b"\x89PNG\r\n\x1a\n" and struct.unpack(">II", head[16:24])
                      == (PIX_SIZE, PIX_SIZE), f"{j:05d}-{kind}.png header {head!r}")
        print(f"--mode test: 8 examples, test_l1 {metrics['test_l1']!r} at step "
              f"{metrics['step']}, index.html and 24 PNGs of {PIX_SIZE}x{PIX_SIZE}, "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        bundle = train_pix2pix.main(args + ["--mode", "export", "--out-dir", pix_dir])
        export_s = time.perf_counter() - t0
        g_bf16 = pix2pix.UNetGenerator(PIX_SIZE, PIX_WIDTH, compute_dtype=torch.bfloat16)
        raw = torch.load(os.path.join(pix_dir, "export", "step_000012.pt"),
                         map_location="cuda", weights_only=True)
        g_bf16.load_state_dict(raw["g"])
        g_bf16.cuda()
        served = torch.export.load(bundle).module()
        masks = g_bf16.draw_masks(1, torch.Generator(device="cuda").manual_seed(0))
        ex = next(host.eval_iter())
        x = torch.from_numpy(ex["input"]).cuda()
        with torch.no_grad():
            got = served(x)
            want = g_bf16(x, masks, train=False)
        err = float((got - want).abs().max())
        check(tuple(got.shape) == (1, PIX_SIZE, PIX_SIZE, 3) and err <= 2.0 ** -6,
              f"the reloaded bundle differs from the eager translator by {err}")
        print(f"--mode export: {bundle} ({os.path.getsize(bundle)} bytes) in {export_s:.1f} s; "
              f"torch.export.load(...).module() on the card vs the eager translator with the "
              f"same fixed masks: bit-equal {torch.equal(got, want)}, max abs err {err:.3e} "
              f"(bound 2^-6, bf16)")
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.synchronize()
    check(pi.launches == 0 and fd.launches == 0 and all(v == [0, 0, 0] for v in counts.values()),
          f"pix2pix launched a kernel: power iteration {pi.launches}, fade-in {fd.launches}")
    print(f"launches in the whole phase: power iteration {pi.launches}, fade-in {fd.launches}")


def rich_pyramid(tmp: str) -> str:
    """Phase 14 (a): ``PGE_IMAGES`` host ``rich`` images at ``PGE_RES``,
    mapped to uint8 and written as a pyramid store ``PGE_RES`` ... 4."""
    from gan_lib_tensorflow_tpu_torch.data import write_rich_pyramid
    pyr = os.path.join(tmp, "pyramid")
    t0 = time.perf_counter()
    dirs = write_rich_pyramid(pyr, PGE_IMAGES, PGE_RES)
    sizes = {r: os.path.getsize(os.path.join(d, "images.u8")) for r, d in dirs.items()}
    check(sizes[PGE_RES] == PGE_IMAGES * PGE_RES * PGE_RES * 3
          and list(sizes) == [PGE_RES >> i for i in range(int(math.log2(PGE_RES)) - 1)],
          f"pyramid members {sizes}")
    print(f"pyramid store: {PGE_IMAGES} rich images rendered by the host FakeImages at "
          f"{PGE_RES}x{PGE_RES}, mapped to uint8 and written as {len(sizes)} members "
          f"{PGE_RES} ... 4 in {time.perf_counter() - t0:.1f} s: the {PGE_RES}^2 member "
          f"{sizes[PGE_RES]} bytes, the whole pyramid {sum(sizes.values())} bytes")
    return pyr


def pggan_to_the_end(card: str, tmp: str) -> int:
    """Phase 14, in the temporary directory ``tmp``. Returns the fade-in
    launches of the ladder run (b)."""
    import gc
    import weakref

    import numpy as np
    import torch
    from gan_lib_tensorflow_tpu_torch import data
    from gan_lib_tensorflow_tpu_torch.cli import evaluate, sample, train_pggan
    from gan_lib_tensorflow_tpu_torch.eval import perceptual
    from gan_lib_tensorflow_tpu_torch.ops import fadein as fd
    from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi
    from gan_lib_tensorflow_tpu_torch.train import (CheckpointManager, make_train_step,
                                                    pggan_loop, to_checkpoint)
    from gan_lib_tensorflow_tpu_torch.train.pggan_loop import DEFAULT_BATCH_BY_RES

    pyr = rich_pyramid(tmp)

    # (b) the ladder from the pyramid store, through the CLI
    run = os.path.join(tmp, "ladder")
    per_phase, logs, alive, released = [], [], [], []
    inner_ladder, inner_sampler = train_pggan.train_pggan_ladder, pggan_loop._phase_sampler

    def hook(when, res, name, st):
        if when == "start":
            released.append(all(ref() is None for ref in alive))
            if (res, name) == (PGE_RES, "transition"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            per_phase.append({"res": res, "name": name, "fd": fd.launches, "pi": pi.launches,
                              "grid": 0, "t0": time.perf_counter()})
        else:
            torch.cuda.synchronize()
            rec = per_phase[-1]
            rec["fd"], rec["pi"] = fd.launches - rec["fd"], pi.launches - rec["pi"]
            rec["s"] = time.perf_counter() - rec.pop("t0")
            rec["peak"] = torch.cuda.max_memory_allocated()

    def ladder(cfg, factory, **kw):
        def recording(res, batch):
            src = factory(res, batch)
            per_phase[-1]["path"] = src.path
            per_phase[-1]["resident"] = (src.nbytes_resident() if isinstance(
                src, data.DeviceCachedStore) else 0)
            alive.append(weakref.ref(src))
            return src
        return inner_ladder(cfg, recording, phase_hook=hook,
                            log_fn=lambda it, m: logs.append(m))

    def counting_sampler(cfg, ph, phase_dir):
        fn = inner_sampler(cfg, ph, phase_dir)

        def grid(state, it):
            before = fd.launches
            fn(state, it)
            per_phase[-1]["grid"] += fd.launches - before
        return grid

    args = ["--data", pyr, "--device", "cuda", "--final-resolution", str(PGE_RES),
            "--width-mul", str(PGE_WIDTH), "--steps-per-phase", str(PGGAN_STEPS_PER_PHASE),
            "--log-every", "1", "--compute-dtype", "bf16", "--ckpt-every", "1",
            "--sample-every", "1000", "--out-dir", run]
    train_pggan.train_pggan_ladder, pggan_loop._phase_sampler = ladder, counting_sampler
    fd.launches = pi.launches = 0  # count this path's launches only
    t0 = time.perf_counter()
    try:
        final = train_pggan.main(args)
        torch.cuda.synchronize()
    finally:
        train_pggan.train_pggan_ladder, pggan_loop._phase_sampler = inner_ladder, inner_sampler
    ladder_s, launches = time.perf_counter() - t0, fd.launches
    check(pi.launches == 0, f"the ladder launched the power iteration {pi.launches} times")
    n_phases = 2 * int(math.log2(PGE_RES)) - 3
    check(len(per_phase) == n_phases and final.step == PGGAN_STEPS_PER_PHASE
          and final.alpha == 1.0, f"{len(per_phase)} phases, want {n_phases}")
    for rec in per_phase:
        trans = rec["name"] == "transition"
        steps_fd = rec["fd"] - rec["grid"]
        want = 6 * PGGAN_STEPS_PER_PHASE if trans else 0
        r = rec["res"]
        print(f"  {r:4d}x{r:<4d} {rec['name']:10s} read {os.path.relpath(rec['path'], tmp)} "
              + (f"held on the card ({rec['resident']} bytes resident)" if rec["resident"]
                 else "streamed")
              + f", fade-in launches {steps_fd} in the steps (want {want}) + {rec['grid']} "
              f"in the sample grid, {rec['s']:.2f} s")
        check(rec["path"] == os.path.join(pyr, f"r{r:04d}") and rec["resident"] > 0,
              f"{r}x{r} {rec['name']} read {rec['path']} ({rec['resident']} bytes resident)")
        check(steps_fd == want and rec["grid"] == (1 if trans else 0),
              f"{r}x{r} {rec['name']}: {steps_fd} fade-in launches in its steps, want {want}")
    check(all(released[1:]), f"a phase's store outlived its phase: {released}")
    step_launches = sum(rec["fd"] - rec["grid"] for rec in per_phase)
    check(step_launches == 6 * PGGAN_STEPS_PER_PHASE * (n_phases // 2),
          f"{step_launches} fade-in launches in the ladder's steps")
    check(len(logs) == n_phases * PGGAN_STEPS_PER_PHASE and all(
        math.isfinite(v) for m in logs for v in m.values()), "non-finite ladder metrics")
    top = next(rec for rec in per_phase if (rec["res"], rec["name"]) == (PGE_RES, "transition"))
    top_dir = os.path.join(run, f"{PGE_RES}x{PGE_RES}_transition")
    sps = last_sec_per_step(top_dir)
    print(f"ladder 4x4 -> {PGE_RES}x{PGE_RES} from the pyramid store (full width, bf16, "
          f"checkpoints every step): {len(per_phase)} phases in {ladder_s:.1f} s, fade-in "
          f"launches {launches} ({step_launches} in the steps: 6 per transition step, 0 per "
          f"stabilize step; {launches - step_launches} in the transition phases' sample "
          f"grids); every store released before the next phase's; the {PGE_RES}x{PGE_RES} "
          f"transition phase {1e3 * sps:.2f} ms/step (its step 2, the step-1 checkpoint's "
          f"copy to the host included), peak memory "
          f"{top['peak'] / 2**20:.0f} MiB  [{card}]")

    # (c) a device batch of the top member against the host gather
    member = os.path.join(pyr, f"r{PGE_RES:04d}")
    cache = data.DeviceCachedStore(member, batch_size=4, seed=0, device="cuda")
    host = data.PackedImageStore(member, batch_size=4)
    for pos in (0, 17):
        idx = cache.indices_for(pos)
        got = cache.gather(idx)["image"].cpu().numpy()
        want = data.base.normalize_u8_np(np.asarray(host.images[idx]))
        check(np.array_equal(got.view(np.uint32), want.view(np.uint32)),
              f"device batch {pos} of the {PGE_RES}^2 member differs from the host gather")
    print(f"device batches at positions 0 and 17 of the {PGE_RES}^2 member "
          f"({cache.nbytes_resident()} bytes resident) bit-equal to the host gather of the "
          f"same indices_for(pos)")
    del cache

    # (d) the eval, under torch's default TF32 flags and deterministic cuDNN
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    ms_times, inner_ms = [], perceptual.ms_ssim_diversity
    timed_calls(perceptual, "ms_ssim_diversity", ms_times)
    levels = [f"swd_{PGE_RES >> i}" for i in range(int(math.log2(PGE_RES // 16)) + 1)]
    keys = (["ms_ssim", "ms_ssim_std", "ms_ssim_pairs", "step", "resolution"] + levels
            + ["swd_avg", "swd_desc_dtype", "swd_images", "swd_seconds", "swd_peak_hbm_gb"])
    ckpt_dir = os.path.join(run, f"{PGE_RES}x{PGE_RES}_stabilize", "ckpt")
    try:
        for source in (pyr, "device-rich"):
            recs, held_mib = [], []
            for _ in range(2):
                # the peak the eval reports counts what this process holds
                # when it starts: collect the garbage earlier phases left in
                # reference cycles, which would otherwise be freed whenever a
                # full collection happened to run, before one call and not
                # before its repeat
                before = torch.cuda.memory_allocated()
                gc.collect()
                after = torch.cuda.memory_allocated()
                held_mib.append((round(before / 2**20, 1), round(after / 2**20, 1)))
                recs.append(evaluate.main([
                    "--model", "pggan", "--resolution", str(PGE_RES), "--width-mul",
                    str(PGE_WIDTH), "--ckpt-dir", ckpt_dir, "--data", source,
                    "--n-samples", str(PGE_EVAL_SAMPLES), "--swd-samples",
                    str(PGE_SWD_SAMPLES), "--batch-size", "16", "--device", "cuda"]))
            rec, again = recs
            check(list(rec) == keys, f"eval record keys {list(rec)}, want {keys}")
            check(rec["swd_desc_dtype"] == "float16" and 0 <= rec["ms_ssim"] <= 1
                  and rec["ms_ssim_pairs"] > 0 and rec["swd_images"] > 0
                  and all(math.isfinite(rec[k]) for k in keys if k != "swd_desc_dtype"),
                  f"eval record {rec}")
            same = {k: v for k, v in rec.items() if k != "swd_seconds"}
            check(same == {k: v for k, v in again.items() if k != "swd_seconds"},
                  f"the repeated eval differs: {rec} vs {again}")
            ms_s = ms_times[-1]
            name = "the pyramid store" if source == pyr else source
            print(f"cli.evaluate --model pggan at {PGE_RES}^2, reals from {name}: "
                  + json.dumps(rec) + f"; the repeat agrees in every digit (cuDNN "
                  f"deterministic); MS-SSIM {rec['ms_ssim_pairs'] / ms_s:.1f} pairs/s "
                  f"({ms_s:.2f} s), SWD {rec['swd_images'] / rec['swd_seconds']:.1f} images/s "
                  f"per side ({rec['swd_seconds']} s), peak {rec['swd_peak_hbm_gb']} GiB "
                  f"(MiB held before each call, before and after collecting garbage: {held_mib}); "
                  f"TF32 flags at torch's defaults  [{card}]")

        # (e) card vs CPU under the same flags: MS-SSIM on images at the top
        # resolution, SWD on the top level's descriptors, the same draws
        gen = torch.Generator().manual_seed(5)
        reals = next(iter(data.open_pyramid(pyr, 4, PGE_RES)))["image"]
        a = torch.from_numpy(reals)
        b = (a * 0.8 + 0.2 * torch.rand(a.shape, generator=gen) - 0.1).clamp(-1, 1)
        ms_gpu = perceptual.ms_ssim(a.cuda(), b.cuda()).cpu()
        ms_cpu = perceptual.ms_ssim(a, b)
        torch.testing.assert_close(ms_gpu, ms_cpu, rtol=1e-4, atol=0.0)
        draws = perceptual.SWDDraws(seed=6)
        descs = []
        for imgs in (a, b):
            lap = perceptual.laplacian_pyramid(imgs.cuda(), 2)[0]
            y0, x0 = draws.patch_origins("real", 0, *lap.shape[:3], 128, 7)
            descs.append(perceptual._normalize_descriptors(
                perceptual._patch_descriptors(lap, y0, x0, 7), 7, 3))
        normals = draws.directions(147, 512)
        sw_gpu = perceptual.sliced_wasserstein(descs[0], descs[1], normals).cpu()
        sw_cpu = perceptual.sliced_wasserstein(descs[0].cpu(), descs[1].cpu(), normals)
        torch.testing.assert_close(sw_gpu, sw_cpu, rtol=1e-4, atol=0.0)
        print(f"card vs CPU, TF32 flags at torch's defaults (cudnn True, matmul False): "
              f"ms_ssim of 4 pairs at {PGE_RES}^2 max rel err "
              f"{float(((ms_gpu - ms_cpu).abs() / ms_cpu.abs()).max()):.3e}; "
              f"sliced_wasserstein of the {PGE_RES}^2 level's {descs[0].shape[0]} float16 "
              f"descriptors per side, 512 directions, {float(sw_gpu)!r} vs {float(sw_cpu)!r} "
              f"(rel err {float((sw_gpu - sw_cpu).abs() / sw_cpu.abs()):.3e}); rtol 1e-4")
        del descs

        # (f) sample and export a mid-phase checkpoint of the top transition
        mid = os.path.join(tmp, "mid_ckpt")
        os.makedirs(mid)
        shutil.copy(os.path.join(top_dir, "ckpt", "step_000001.pt"), mid)
        alpha = float(CheckpointManager(mid).restore_latest_raw()["alpha"])
        check(alpha < 1.0, f"the mid-phase checkpoint's alpha is {alpha}")
        bundle_dir, exports, exports_inner = os.path.join(tmp, "export"), [], sample.export_generator
        timed_calls(sample, "export_generator", exports)
        before = fd.launches
        try:
            eager = sample.main(["--model", "pggan", "--resolution", str(PGE_RES),
                                 "--width-mul", str(PGE_WIDTH), "--ckpt-dir", mid,
                                 "--n", "4", "--out", os.path.join(tmp, "pg.png"),
                                 "--device", "cuda", "--export-dir", bundle_dir])
        finally:
            sample.export_generator = exports_inner
        torch.cuda.synchronize()
        check(fd.launches == before, f"sampling and export launched the fade-in "
                                     f"{fd.launches - before} times")
        z = torch.randn(4, 512, generator=torch.Generator().manual_seed(0)).cuda()
        with torch.no_grad():
            served = torch.export.load(os.path.join(bundle_dir, "generator.pt2")).module()(z)
        torch.cuda.synchronize()
        check(fd.launches == before, "the reloaded bundle launched the fade-in")
        check(tuple(served.shape) == (4, PGE_RES, PGE_RES, 3) and torch.equal(served, eager),
              f"the reloaded bundle differs from the eager sampler by "
              f"{float((served - eager).abs().max())}")
        n_bytes = sum(os.path.getsize(os.path.join(bundle_dir, f))
                      for f in os.listdir(bundle_dir))
        print(f"cli.sample --export-dir on the {PGE_RES}^2 transition checkpoint at alpha "
              f"{alpha} (G without the fade-in, as the reference samples it): 0 fade-in "
              f"launches in sampling, export and the reloaded bundle; the bundle "
              f"({n_bytes} bytes: checkpoint + generator.pt2, "
              f"{os.path.getsize(os.path.join(bundle_dir, 'generator.pt2'))} of them) "
              f"reloaded on the card bit-equal to the eager sampler; export "
              f"{exports[0]:.1f} s  [{card}]")
    finally:
        perceptual.ms_ssim_diversity = inner_ms
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved

    # (g) one top transition step with --remat-from PGE_RES // 2 and one
    # without, from the same state and batch (cuDNN still deterministic)
    try:
        top_ckpt = CheckpointManager(os.path.join(top_dir, "ckpt"))
        top_batch = DEFAULT_BATCH_BY_RES[PGE_RES]
        batch = next(iter(data.DeviceCachedStore(member, batch_size=top_batch, seed=0,
                                                 device="cuda")))
        results = {}
        for remat in (0, PGE_RES // 2):
            a_args = train_pggan.parse_args(args + ["--remat-from", str(remat)])
            ph = pggan_loop.build_phase(train_pggan.ladder_config(a_args), PGE_RES,
                                        "transition")
            check(top_ckpt.restore_latest(ph.state) is not None, "no top checkpoint")
            ph.state.alpha = 0.5
            step = make_train_step(ph.spec)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            metrics = step(ph.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            torch.cuda.synchronize()
            results[remat] = (metrics, time.perf_counter() - t0,
                              torch.cuda.max_memory_allocated() - base,
                              to_checkpoint(ph.state))
            del ph, step
        (m0, s0, p0, c0), (m1, s1, p1, c1) = results[0], results[PGE_RES // 2]
        diff = max(float((c0[k][n].float() - c1[k][n].float()).abs().max())
                   for k in ("g", "d") for n in c0[k])
        top_ckpt.close()
        check(m0 == m1, f"--remat-from {PGE_RES // 2} changed the losses: {m1} vs {m0}")
        check(p1 < p0, f"--remat-from {PGE_RES // 2} did not lower the peak: {p1} vs {p0}")
        print(f"one {PGE_RES}^2 transition step (batch {top_batch}) from the same state "
              f"and batch: losses {m0} without remat and with --remat-from {PGE_RES // 2} "
              f"bit-equal; G and D after the step differ by at most {diff!r}; peak memory "
              f"above the state {p0 / 2**20:.0f} MiB without, {p1 / 2**20:.0f} MiB with "
              f"({100 * (1 - p1 / p0):.1f}% less); {1e3 * s0:.1f} and {1e3 * s1:.1f} ms "
              f"(first steps, with their cuDNN set-up)  [{card}]")
    finally:
        torch.backends.cudnn.deterministic = False
    return launches


def state_bytes(st) -> dict:
    """Bytes the rank holds: the parameters the optimizers update (a rank's
    shards of the wide ones under 'model' sharding), both Adam slots, the
    EMA; and the full-size weights the networks compute with."""
    nbytes = lambda ts: sum(t.numel() * t.element_size()
                            for t in (ts.values() if isinstance(ts, dict) else ts))
    out = {"params": 0, "slots": 0, "weights_full": 0}
    for net in ("g", "d"):
        sh, module = getattr(st, f"{net}_shards"), getattr(st, net)
        held = sh.opt_params() if sh is not None else list(module.parameters())
        opt = getattr(st, f"{net}_opt")
        out["params"] += nbytes(held)
        out["slots"] += sum(nbytes([opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"]])
                            for p in held if "exp_avg" in opt.state.get(p, {}))
        out["weights_full"] += nbytes(list(module.parameters()))
    out["ema"] = nbytes(st.ema_params) if st.ema_params is not None else 0
    return out


def _sha(t) -> str:
    import hashlib
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def shard_hashes(st) -> dict:
    """sha256 of every 'model' shard the rank holds: value, both Adam slots,
    and G's EMA."""
    out = {}
    for net in ("g", "d"):
        sh, opt = getattr(st, f"{net}_shards"), getattr(st, f"{net}_opt")
        for n, m in (sh.masters.items() if sh is not None else []):
            out[f"{net}/{n}"] = _sha(m)
            out[f"{net}_mu/{n}"] = _sha(opt.state[m]["exp_avg"])
            out[f"{net}_nu/{n}"] = _sha(opt.state[m]["exp_avg_sq"])
            if net == "g" and st.ema_params is not None:
                out[f"ema/{n}"] = _sha(st.ema_params[n])
    return out


def sgd_for_adam():
    """Make every Adam the port builds plain SGD at the same lr (an update
    linear in the gradient); returns the undo."""
    import torch
    adam = torch.optim.Adam
    torch.optim.Adam = lambda params, lr, betas=None, eps=None: torch.optim.SGD(params, lr=lr)

    def undo():
        torch.optim.Adam = adam
    return undo


def _sha_all(module) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in module.parameters():
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def rank_run(jobs_file: str) -> None:
    """One rank of a ``torch.distributed.run`` launch (``chip_smoke.py
    --rank-run JOBS.json``): each job ``[out, module, argv, sgd]`` of the
    file in turn, over the one process group the launch made (each CLI's
    mesh is built on it), then the group is left."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(jobs_file) as f:
        jobs = json.load(f)
    # host intervals of each collective (a gloo collective's includes its
    # wait for the card to reach it)
    calls = []
    for name in ("all_reduce", "all_gather"):
        setattr(dist, name, timed_into(getattr(dist, name), calls))
    for out, module, argv, sgd in jobs:
        calls.clear()
        rank_job(out, module, argv, sgd, calls)
    if dist.is_initialized():
        dist.destroy_process_group()


def timed_into(fn, sink: list):
    """``fn``, appending each call's host interval to ``sink``."""
    def wrapper(*args, **kwargs):
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            sink.append((t, time.perf_counter()))
    return wrapper


def rank_job(out: str, module: str, argv: list, sgd: bool, calls: list) -> None:
    """One job of ``rank_run``: the CLI's ``main(argv)`` (with SGD for Adam
    under ``sgd``), then this rank's kernel launches, seconds, peak memory,
    state bytes and shard hashes to ``OUT.rank<r>.json``. Under 'model'
    sharding also the sha256 of the full-size weights the networks compute
    with, and rank 0 saves them to ``OUT.weights.pt``. On an NCCL group it
    also runs the port's collectives on CUDA tensors and checks their
    results."""
    import importlib
    import torch
    import torch.distributed as dist
    import torch.distributed.nn.functional as dist_fn
    from gan_lib_tensorflow_tpu_torch.ops import fadein as fd
    from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi
    cli = importlib.import_module(f"gan_lib_tensorflow_tpu_torch.cli.{module}")
    steps = []  # host intervals of each train step
    make = getattr(cli, "make_train_step", None)
    if make is not None:
        cli.make_train_step = lambda spec: timed_into(make(spec), steps)
    undo = sgd_for_adam() if sgd else (lambda: None)
    pi.launches = fd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        st = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        undo()
        if make is not None:
            cli.make_train_step = make
    mesh = st.mesh
    rec = {"rank": mesh.rank if mesh else 0, "backend": mesh.backend if mesh else None,
           "mesh": dict(zip(mesh.axis_names, mesh.shape)) if mesh else None,
           "n_cards": mesh.n_cards if mesh else 1, "device": str(mesh.device if mesh else ""),
           "pi": pi.launches, "fd": fd.launches, "seconds": time.perf_counter() - t0,
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
           "bytes": state_bytes(st), "hashes": shard_hashes(st), "step": st.step,
           # per step: its host seconds, and the seconds and number of the
           # collectives inside it
           "per_step": [(e - s, sum(ce - cs for cs, ce in calls if s <= cs < e),
                         sum(1 for cs, _ in calls if s <= cs < e)) for s, e in steps]}
    if st.g_shards is not None or st.d_shards is not None:
        rec["full_hashes"] = {"g": _sha_all(st.g), "d": _sha_all(st.d)}
        if rec["rank"] == 0:
            torch.save({net: {n: p.detach().cpu() for n, p in getattr(st, net).named_parameters()}
                        for net in ("g", "d")}, f"{out}.weights.pt")
    if rec["backend"] == "nccl":
        group, dev = mesh.group("data"), mesh.device
        x = torch.arange(1.0, 5.0, device=dev, requires_grad=True)
        y = dist_fn.all_reduce(x * x, group=group)
        (gx,) = torch.autograd.grad(y.sum(), x)
        parts = [torch.empty(4, device=dev) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.detach(), group=group)
        n = dist.get_world_size(group)
        rec["nccl_probe"] = bool(torch.equal(y, n * x.detach() ** 2)
                                 and torch.equal(gx, 2 * n * x.detach())
                                 and all(torch.equal(q, x.detach()) for q in parts))
    with open(f"{out}.rank{rec['rank']}.json", "w") as f:
        json.dump(rec, f)


def torchrun(n: int, jobs: list, timeout: float = 600, sp_steps: int = 0) -> list:
    """``python -m torch.distributed.run --standalone --nproc_per_node n``
    of ``chip_smoke.py``: each rank runs the ``jobs`` (``[out, module,
    argv, sgd]``: the CLI module's ``main(argv)``, SGD for Adam under
    ``sgd``) in turn through ``rank_run``, one launcher start for them all;
    or, with ``sp_steps``, the one job's ``sp_step_run`` steps of the PGGAN
    phase that its ``argv`` (``train_pggan``'s flags) gives. One rank needs
    no launcher: its process is started with the environment the launcher
    would give it (``RANK``, ``WORLD_SIZE``, ``LOCAL_*``, ``MASTER_*``).
    Every process it starts is stopped on the way out. Returns each job's
    ranks' records."""
    import signal
    import socket
    if sp_steps:
        (out, _, argv, _), = jobs
        run = ["--sp-run", out, str(sp_steps), *argv]
    else:
        with open(f"{jobs[0][0]}.jobs.json", "w") as f:
            json.dump(jobs, f)
        run = ["--rank-run", f"{jobs[0][0]}.jobs.json"]
    env = None
    if n == 1:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env = {**os.environ, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
               "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        cmd = [sys.executable, os.path.abspath(__file__), *run]
    else:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(n), os.path.abspath(__file__), *run]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            process_group=0, env=env)
    try:
        text, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    for line in text.splitlines():
        if line.startswith(("[mesh]", "[profiler]")):
            print("   ", line)
    names = " + ".join(job[1] or "train_pggan" for job in jobs)
    if proc.returncode != 0:
        print(text[-6000:])
    check(proc.returncode == 0, f"{names} on {n} ranks exited {proc.returncode}")
    recs = []
    for out, *_ in jobs:
        recs.append([])
        for r in range(n):
            with open(f"{out}.rank{r}.json") as f:
                recs[-1].append(json.load(f))
    print(f"    {names} on {n} rank(s): {time.perf_counter() - t0:.1f} s wall with the "
          "processes' start", flush=True)
    return recs


def read_log(out_dir: str) -> list:
    with open(os.path.join(out_dir, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


def losses_close(got: list, want: list, rtol: float, atol: float, what: str) -> float:
    """Every logged metric of two runs within rtol/atol (not ``sec_per_step``);
    returns the largest absolute difference."""
    check(len(got) == len(want), f"{what}: {len(got)} log lines against {len(want)}")
    worst = 0.0
    for a, b in zip(got, want):
        for k, v in b.items():
            if k in ("step", "sec_per_step"):
                continue
            diff = abs(a[k] - v)
            worst = max(worst, diff)
            check(diff <= atol + rtol * abs(v),
                  f"{what}: step {b['step']} {k} {a[k]} against {v}")
    return worst


def multi_rank(card: str, tmp: str, parts: str = "abcdf") -> tuple:
    """Phase 15: the training CLIs under ``torch.distributed.run`` on this
    card; ``parts`` picks the runs ((d) compares with (a), (e) is in (b)).
    Returns the power-iteration and fade-in launches of its runs (every
    rank's) and the fade-in's times at 2 images per rank."""
    import torch
    from gan_lib_tensorflow_tpu_torch.cli import common, train_sngan, train_sngan_imagenet
    from gan_lib_tensorflow_tpu_torch.cli import train_pggan
    from gan_lib_tensorflow_tpu_torch.ops import fadein as fd
    from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi
    from gan_lib_tensorflow_tpu_torch.train import CheckpointManager, make_train_step
    from gan_lib_tensorflow_tpu_torch.utils import debug_nans
    pi_total = fd_total = 0
    torch.cuda.empty_cache()

    def one_rank(main_fn, argv):
        pi.launches = fd.launches = 0
        t0 = time.perf_counter()
        st = main_fn(argv)
        torch.cuda.synchronize()
        return st, pi.launches, fd.launches, time.perf_counter() - t0

    # (a) SNGAN CIFAR-10, batch 64 (32 per rank), bf16, gloo, with SGD in
    # place of Adam, an update linear in the gradient, so the runs' weights
    # part in proportion to their gradients' difference
    sn_base = ["--data", "device-fake", "--batch-size", "64", "--compute-dtype", "bf16"]
    sn = sn_base + ["--steps", str(MR_SNGAN_STEPS), "--log-every", "1"]
    # (b) SNGAN-projection ImageNet-128, full width, 'data' 1 x 'model' 2
    im = ["--data", "device-fake", "--batch-size", str(MR_IMAGENET_BATCH), "--compute-dtype",
          "bf16", "--steps", str(MR_IMAGENET_STEPS), "--log-every", "1"]
    # (c) PGGAN to the MR_LADDER_RES^2 transition, DP 2 (batch 16 -> 8 per rank)
    res, n_trans = MR_LADDER_RES, int(math.log2(MR_LADDER_RES // 4))
    pg = ["--data", "device-fake", "--final-resolution", str(res), "--steps-per-phase", "1",
          "--log-every", "1", "--compute-dtype", "fp32", "--sample-every", "1000",
          "--ckpt-every", "1000"]
    # the three 2-rank runs share one launcher start, each rank running them in turn
    jobs = {"a": [os.path.join(tmp, "a"), "train_sngan",
                  sn + ["--out-dir", os.path.join(tmp, "a2")], True],
            "b": [os.path.join(tmp, "b"), "train_sngan_imagenet",
                  im + ["--tp-shards", "2", "--out-dir", os.path.join(tmp, "b2")], False],
            "c": [os.path.join(tmp, "c"), "train_pggan",
                  pg + ["--out-dir", os.path.join(tmp, "c2")], False]}
    jobs = {k: v for k, v in jobs.items() if k in parts}
    ranked = dict(zip(jobs, torchrun(MR_RANKS, list(jobs.values())))) if jobs else {}
    if "a" in parts:
        recs = ranked["a"]
        undo = sgd_for_adam()
        try:
            one, one_pi, _, _ = one_rank(train_sngan.main,
                                         sn + ["--out-dir", os.path.join(tmp, "a1")])
        finally:
            undo()
        for rec in recs:
            check(rec["backend"] == "gloo" and rec["n_cards"] == 1 and rec["mesh"] == {"data": 2},
                  f"(a) rank {rec['rank']}: {rec['backend']} over {rec['n_cards']} card(s)")
            check(rec["pi"] == 6 * MR_SNGAN_STEPS,
                  f"(a) rank {rec['rank']}: {rec['pi']} power-iteration launches, want 6 per step")
        check(one_pi == 6 * MR_SNGAN_STEPS, f"(a) one rank: {one_pi} launches")
        pi_total += sum(r["pi"] for r in recs) + one_pi
        logs2, logs1 = read_log(os.path.join(tmp, "a2")), read_log(os.path.join(tmp, "a1"))
        loss_err = losses_close(logs2, logs1, 5e-2, 5e-2, "(a) SNGAN losses, 2 ranks vs 1")
        c2 = CheckpointManager(os.path.join(tmp, "a2", "ckpt")).restore_latest_raw()
        c1 = CheckpointManager(os.path.join(tmp, "a1", "ckpt")).restore_latest_raw()
        init = train_sngan.build(train_sngan.parse_args(sn + ["--device", "cuda"]))[3]
        w0 = {"g": init.g.state_dict(), "d": init.d.state_dict()}
        buffer = lambda k: k.endswith((".u", ".running_mean", ".running_var"))
        # the runs' distance over the distance the updates moved the weights:
        # one rank's gradients of its 32 images in place of the average
        # fail every bound (a mutation check on the CPU at this batch in
        # bf16); the EMA, at decay 0.9999, moves a few float32 ulps a step,
        # so rounding is much of its distance
        bound = {"g": 1e-2, "d": 1e-2, "ema_params": 5e-2}
        w0["ema_params"] = w0["g"]
        rel, moved, buf_rel = {}, {}, 0.0
        for key in ("g", "d", "ema_params"):
            names = [k for k in c1[key] if not buffer(k)]
            apart = sum(float((c2[key][k] - c1[key][k]).double().norm() ** 2) for k in names)
            moved[key] = sum(float((c1[key][k] - w0[key][k].cpu()).double().norm() ** 2)
                             for k in names)
            check(moved[key] > 0, f"(a) the updates did not move {key}")
            rel[key] = math.sqrt(apart / moved[key])
            check(rel[key] <= bound[key], f"(a) final {key}: {rel[key]:.3e} of the distance "
                                          f"the updates moved it apart, bound {bound[key]}")
        for key in ("g", "d"):
            for k, v in c1[key].items():
                if buffer(k):
                    buf_rel = max(buf_rel, float((c2[key][k] - v).norm() / v.norm()))
        # BN running statistics and SN u vectors follow bf16 activations
        check(buf_rel <= 5e-2, f"(a) BN running stats / SN u {buf_rel:.3e} apart (relative L2)")
        del init
        ms2 = 1e3 * statistics.mean(r["sec_per_step"] for r in logs2[MR_LOG_EVERY:])
        ms1 = 1e3 * statistics.mean(r["sec_per_step"] for r in logs1[MR_LOG_EVERY:])
        window = recs[0]["per_step"][MR_LOG_EVERY:]
        step_ms = 1e3 * statistics.mean(w[0] for w in window)
        coll_ms = 1e3 * statistics.mean(w[1] for w in window)
        coll_calls = statistics.mean(w[2] for w in window)
        print(f"(a) train_sngan with SGD, 2 ranks (gloo, one card) vs 1: {MR_SNGAN_STEPS} steps, "
              f"every logged metric within 5e-2 (largest difference {loss_err:.3e}); final G, D, "
              f"EMA parameters apart by {rel['g']:.3e}, {rel['d']:.3e}, {rel['ema_params']:.3e} "
              f"of the distance the updates moved them (relative L2, bounds 1e-2, 1e-2, 5e-2; "
              f"moved {math.sqrt(moved['g']):.3e}, {math.sqrt(moved['d']):.3e}, "
              f"{math.sqrt(moved['ema_params']):.3e}), BN running stats and SN u "
              f"{buf_rel:.3e} (relative L2, bound 5e-2); power-iteration launches per rank "
              f"{[r['pi'] for r in recs]} (6 per step); ms/step (steps {MR_LOG_EVERY + 1}-"
              f"{MR_SNGAN_STEPS}) 2 ranks {ms2:.2f}, 1 rank {ms1:.2f}; images/s per card "
              f"{5 * 64 / ms2 * 1e3:.1f} vs {5 * 64 / ms1 * 1e3:.1f}; rank 0's steps "
              f"{MR_LOG_EVERY + 1}-{MR_SNGAN_STEPS}: {step_ms:.2f} ms in the step call, "
              f"{coll_ms:.2f} of them in {coll_calls:.0f} all-reduces and all-gathers "
              f"(gloo's wait for the card included), {coll_ms / step_ms:.3f} of the step; "
              f"peak per rank "
              f"{max(r['peak_mib'] for r in recs):.0f} MiB  [{card}]", flush=True)
        del one

    if "b" in parts:
        recs = ranked["b"]
        one, one_pi, _, _ = one_rank(train_sngan_imagenet.main,
                                     im + ["--out-dir", os.path.join(tmp, "b1")])
        full = state_bytes(one)
        for rec in recs:
            check(rec["mesh"] == {"data": 1, "model": 2}, f"(b) mesh {rec['mesh']}")
            check(rec["pi"] == 6 * MR_IMAGENET_STEPS, f"(b) rank {rec['rank']}: {rec['pi']} launches")
            for k in ("params", "slots", "ema"):
                check(rec["bytes"][k] < 0.6 * full[k],
                      f"(b) rank {rec['rank']} holds {rec['bytes'][k]} B of {k}, one rank {full[k]}")
        check(one_pi == 6 * MR_IMAGENET_STEPS, f"(b) one rank: {one_pi} launches")
        pi_total += sum(r["pi"] for r in recs) + one_pi
        logs2, logs1 = read_log(os.path.join(tmp, "b2")), read_log(os.path.join(tmp, "b1"))
        # one 'data' shard: both ranks and the one-rank run compute the same
        # forward from the same weights
        tp_err = losses_close(logs2, logs1, 1e-6, 1e-6, "(b) ImageNet-128 losses, TP 2 vs 1")
        check(recs[0]["full_hashes"] == recs[1]["full_hashes"],
              "(b) the ranks' full-size working weights differ")
        saved = torch.load(os.path.join(tmp, "b.weights.pt"), weights_only=True)
        w_err = 0.0
        for net in ("g", "d"):
            mine = dict(getattr(one, net).named_parameters())
            check(set(saved[net]) == set(mine), f"(b) {net} parameter names differ")
            for n, t in saved[net].items():
                w_err = max(w_err, float((t.to(mine[n].device) - mine[n].detach()).abs().max()))
        check(w_err <= 1e-6, f"(b) full-size weights {w_err:.3e} from one rank's")
        del saved
        mb = lambda b: f"{b / 1e6:.1f} MB"
        print(f"(b) train_sngan_imagenet --tp-shards 2 (full width, batch {MR_IMAGENET_BATCH}, "
              f"{MR_IMAGENET_STEPS} steps): losses within 1e-6 of one rank (largest difference "
              f"{tp_err:.3e}); full-size working weights gathered over 'model' equal on both "
              f"ranks and {w_err:.3e} from one rank's (bound 1e-6); per rank: params {mb(recs[0]['bytes']['params'])}, Adam slots "
              f"{mb(recs[0]['bytes']['slots'])}, EMA {mb(recs[0]['bytes']['ema'])}, against one "
              f"rank's {mb(full['params'])}, {mb(full['slots'])}, {mb(full['ema'])}; full-size "
              f"working weights {mb(recs[0]['bytes']['weights_full'])} per rank; launches per "
              f"rank {[r['pi'] for r in recs]} over 19 weights; ms/step 2 ranks "
              f"{1e3 * logs2[-1]['sec_per_step']:.1f}, 1 rank {1e3 * logs1[-1]['sec_per_step']:.1f}; "
              f"rank 0's steps 2-{MR_IMAGENET_STEPS}: "
              f"{1e3 * statistics.mean(w[0] for w in recs[0]['per_step'][1:]):.1f} ms in the "
              f"step call, {1e3 * statistics.mean(w[1] for w in recs[0]['per_step'][1:]):.1f} "
              f"of them in {statistics.mean(w[2] for w in recs[0]['per_step'][1:]):.0f} "
              f"collectives; "
              f"peak per rank {max(r['peak_mib'] for r in recs):.0f} MiB  [{card}]", flush=True)

        # (e) the 2-rank checkpoint restored by one rank: its slices are the
        # ranks' shards, bit for bit
        args = train_sngan_imagenet.parse_args(im + ["--device", "cuda"])
        _, _, _, restored = train_sngan_imagenet.build(args)
        check(CheckpointManager(os.path.join(tmp, "b2", "ckpt")).restore_latest(restored)
              is not None and restored.step == MR_IMAGENET_STEPS, "(e) no checkpoint restored")
        checked = 0
        for rec in recs:
            j = rec["rank"]
            for key, h in rec["hashes"].items():
                kind, name = key.split("/", 1)
                net = kind[0] if kind != "ema" else "g"
                p = dict(getattr(restored, net).named_parameters())[name]
                if kind == "ema":
                    t = restored.ema_params[name]
                elif kind.endswith("_mu") or kind.endswith("_nu"):
                    t = getattr(restored, f"{net}_opt").state[p][
                        "exp_avg" if kind.endswith("_mu") else "exp_avg_sq"]
                else:
                    t = p
                k = t.shape[0] // 2
                check(_sha(t[j * k:(j + 1) * k]) == h, f"(e) rank {j}'s {key} differs")
                checked += 1
        print(f"(e) the TP-2 checkpoint restored by one rank: {checked} shards (values, both "
              "Adam slots, EMA) equal the ranks' own, bit for bit", flush=True)
        del one, restored

    if "c" in parts:
        recs = ranked["c"]
        _, _, one_fd, _ = one_rank(train_pggan.main, pg + ["--out-dir", os.path.join(tmp, "c1")])
        # 6 per transition step (one step per transition), and one per
        # transition phase's sample grid, which rank 0 alone draws
        for rec in recs:
            want = 6 * n_trans + (n_trans if rec["rank"] == 0 else 0)
            check(rec["fd"] == want, f"(c) rank {rec['rank']}: {rec['fd']} fade-in launches, "
                                     f"want {want}")
        check(one_fd == 7 * n_trans, f"(c) one rank: {one_fd} fade-in launches, "
                                     f"want {7 * n_trans}")
        fd_total += sum(r["fd"] for r in recs) + one_fd
        phase_dir = f"{res}x{res}_transition"
        l2, l1 = (read_log(os.path.join(tmp, c, phase_dir)) for c in ("c2", "c1"))
        # the one-step phases before it each amplify, through an Adam update,
        # the summation-order noise of the sums across ranks
        pg_err = losses_close(l2, l1, 5e-3, 1e-3, f"(c) PGGAN {res}^2 transition losses")
        print(f"(c) train_pggan to {res}^2, DP 2 (8 images per rank), fp32: fade-in "
              f"launches per rank {[r['fd'] for r in recs]} (6 per transition step, and rank 0's "
              f"{n_trans} grids); the {res}^2 "
              f"transition step's metrics within 5e-3 relative of one rank (largest difference "
              f"{pg_err:.3e}: {l2[-1]} vs {l1[-1]}); ladder {max(r['seconds'] for r in recs):.1f} s "
              f"on 2 ranks; peak per rank {max(r['peak_mib'] for r in recs):.0f} MiB  [{card}]",
              flush=True)

    if "d" in parts:
        # (d) one rank on a one-rank NCCL group, through the same code path
        # (SGD, as (a)'s run without a mesh that it is compared with)
        (recs,) = torchrun(1, [[os.path.join(tmp, "d"), "train_sngan",
                                sn + ["--out-dir", os.path.join(tmp, "d1")], True]])
        check(recs[0]["backend"] == "nccl" and recs[0]["pi"] == 6 * MR_SNGAN_STEPS,
              f"(d) backend {recs[0]['backend']}, {recs[0]['pi']} launches")
        check(recs[0]["nccl_probe"], "(d) NCCL collectives on CUDA tensors gave wrong results")
        pi_total += recs[0]["pi"]
        nccl_err = losses_close(read_log(os.path.join(tmp, "d1")), read_log(os.path.join(tmp, "a1")),
                                1e-6, 1e-6, "(d) NCCL one-rank losses vs no mesh")
        print(f"(d) train_sngan on a one-rank NCCL group: backend {recs[0]['backend']}, "
              f"{recs[0]['pi']} launches, metrics within 1e-6 of the run without a mesh "
              f"(largest difference {nccl_err:.3e}); an autograd all-reduce, its backward and "
              f"an all-gather on CUDA tensors through NCCL exact", flush=True)

    if "f" in parts:
        # (f) --trace-steps 2: a window of 3 steps naming the kernel
        pi.launches = 0
        train_sngan.main(sn_base + ["--steps", "14", "--trace-steps", str(MR_TRACE_STEPS),
                                    "--log-every", "7", "--out-dir", os.path.join(tmp, "f")])
        pi_total += pi.launches
        with open(os.path.join(tmp, "f", "trace", "trace_rank0.json")) as f:
            events = json.load(f)["traceEvents"]
        steps = sorted(int(e["name"].split()[1]) for e in events
                       if str(e.get("name", "")).startswith("train_step ")
                       and e.get("cat") == "user_annotation")
        kernels = [e for e in events if "power_iteration_kernel" in str(e.get("name", ""))
                   and e.get("cat") == "kernel"]
        check(steps == list(range(11, 12 + MR_TRACE_STEPS)),
              f"(f) traced steps {steps}, want {MR_TRACE_STEPS + 1} from step 11")
        check(len(kernels) == 6 * len(steps), f"(f) {len(kernels)} power-iteration kernels "
                                              f"in the trace, want {6 * len(steps)}")
        print(f"(f) --trace-steps {MR_TRACE_STEPS}: the trace holds steps {steps} "
              f"({len(steps)} = n + 1, as the reference's window) and {len(kernels)} device "
              f"spans of power_iteration_kernel (6 per step)", flush=True)

        def nan_step(module_path: str, what: str) -> str:
            args = train_sngan.parse_args(["--data", "device-fake", "--device", "cuda", "--batch-size",
                                           "8", "--n-critic", "1", "--debug-nans"])
            _, _, spec, st = train_sngan.build(args)
            src = iter(common.image_source(args, 8, 32, 10, n_micro=1))
            net, _, name = module_path.partition(".")
            with torch.no_grad():
                getattr(st, net).get_parameter(name).view(-1)[0] = float("nan")
            common.configure(args)
            try:
                make_train_step(spec)(st, next(src))
            except FloatingPointError as e:
                return str(e)
            finally:
                debug_nans.disable()
            check(False, f"(f) --debug-nans: a NaN in {what} raised nothing")

        msgs = [nan_step("d.block1.conv1.weight", "an SN weight of D"),
                nan_step("g.dense.weight", "G's first Dense weight")]
        check("power-iteration kernel" in msgs[0], f"(f) {msgs[0]}")
        check(msgs[1].startswith("NaN in the output of aten."), f"(f) {msgs[1]}")
        print(f"(f) --debug-nans: a NaN in an SN weight of D raised FloatingPointError "
              f"'{msgs[0]}'; in G's Dense weight '{msgs[1]}'", flush=True)

    # the fade-in at the shapes one rank of a DP 2 1024^2 rung gives it
    # (2 images per rank)
    cl = torch.channels_last
    half = {}
    for shape in FADEIN_HALF_SHAPES:
        a = torch.randn(shape, device="cuda").contiguous(memory_format=cl)
        b = torch.randn(shape, device="cuda").contiguous(memory_format=cl)
        t = timed_in_turns({"kernel": lambda: fd.launch(a, b, 0.37),
                            "lerp": lambda: torch.lerp(b, a, 0.37),
                            "plain": lambda: fd.plain_fadein_blend(a, b, 0.37)}, 20)
        err = float((fd.launch(a, b, 0.37) - fd.plain_fadein_blend(a, b, 0.37)).abs().max())
        check(err <= 1e-6, f"fade-in at {list(shape)}: {err:.3e} from its plain version")
        bound = 1e3 * 12 * a.numel() / PEAK_BYTES_PER_S
        half[tuple(shape)] = t
        print(f"fadein_blend {list(shape)} channels-last (one DP 2 rank at 1024^2): kernel "
              f"{1e3 * t['kernel']:.2f} us, plain {1e3 * t['plain']:.2f} us, torch.lerp "
              f"{1e3 * t['lerp']:.2f} us, bound {1e3 * bound:.2f} us, max abs err "
              f"{err:.3e}  [{card}]", flush=True)
        del a, b
    return pi_total, fd_total, half


def sp_step_run(out, steps: int, argv: list) -> dict:
    """``steps`` steps of the ``--final-resolution`` transition phase of
    ``train_pggan``'s flags ``argv``, built by ``build_phase`` and fed by
    ``device_batches`` as the ladder builds and feeds it: one rank of a
    ``torch.distributed.run`` launch (``chip_smoke.py --sp-run OUT STEPS
    ARGV...``, which writes ``OUT.rank<r>.json``), or the one-process run
    (``out`` None). Per step: its metrics, host seconds (synchronised) and,
    on a mesh, the collectives inside it by kind ('halo': the halo
    exchanges and their adjoints; 'gather': the height gathers and their
    adjoints; 'sp_sum'; 'other': the gradient and metric averages); the
    fade-in launches and their shapes, peak memory."""
    import torch
    import torch.distributed as dist
    from gan_lib_tensorflow_tpu_torch.cli import common, train_pggan
    from gan_lib_tensorflow_tpu_torch.ops import fadein as fd
    from gan_lib_tensorflow_tpu_torch.train import make_train_step
    from gan_lib_tensorflow_tpu_torch.train.loop import device_batches
    from gan_lib_tensorflow_tpu_torch.train.pggan_loop import build_phase
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = train_pggan.parse_args(argv)
    mesh = common.maybe_mesh(args)
    calls = []
    if mesh is not None:
        sp_group = mesh.group("sp")

        def timed(name, fn):
            def wrapper(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    tensor = a[1] if name == "all_gather" else a[0]
                    if name == "all_gather":
                        kind = "halo" if tensor.dim() == 5 else "gather"
                    elif kw.get("group") is sp_group and sp_group is not None:
                        kind = "gather" if tensor.dim() == 4 else "sp_sum"
                    else:
                        kind = "other"
                    calls.append((kind, t, time.perf_counter()))
            return wrapper

        for name in ("all_reduce", "all_gather"):
            setattr(dist, name, timed(name, getattr(dist, name)))
    res = args.final_resolution
    ph = build_phase(train_pggan.ladder_config(args, mesh), res, "transition")
    dev = next(ph.state.g.parameters()).device
    batches = device_batches(train_pggan.source_factory(args, mesh)(res, ph.batch), 1, dev,
                             mesh)
    step = make_train_step(ph.spec)
    shapes = set()
    launch = fd.launch

    def counted_launch(a, b, alpha):
        shapes.add(tuple(a.shape))
        return launch(a, b, alpha)

    fd.launch = counted_launch
    fd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    per_step = []
    try:
        for i in range(steps):
            ph.state.alpha = ph.alpha_fn(i)
            torch.cuda.synchronize()
            n0, t0 = len(calls), time.perf_counter()
            metrics = {k: float(v) for k, v in step(ph.state, next(batches)).items()}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            by_kind = {}
            for kind, cs, ce in calls[n0:]:
                n, sec = by_kind.get(kind, (0, 0.0))
                by_kind[kind] = (n + 1, sec + ce - cs)
            per_step.append({"sec": t1 - t0, "metrics": {"step": i + 1, **metrics},
                             "collectives": by_kind})
    finally:
        fd.launch = launch
    rec = {"rank": mesh.rank if mesh else 0,
           "mesh": dict(zip(mesh.axis_names, mesh.shape)) if mesh else None,
           "fd": fd.launches, "shapes": sorted(shapes), "per_step": per_step,
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20}
    if out is not None:
        with open(f"{out}.rank{rec['rank']}.json", "w") as f:
            json.dump(rec, f)
        if dist.is_initialized():
            dist.destroy_process_group()
    return rec


def read_png(path: str):
    """The uint8 ``[H, W, C]`` pixels of a PNG that ``utils/images.py``
    wrote (8-bit, filter type 0 on every row)."""
    import zlib

    import numpy as np
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, w, h, c = 8, b"", 0, 0, 0
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            w, h, _, color = struct.unpack(">IIBB", body[:10])
            c = {0: 1, 2: 3, 6: 4}[color]
        elif tag == b"IDAT":
            idat += body
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    check(not rows[:, 0].any(), f"{path}: a row with a filter other than 0")
    return rows[:, 1:].reshape(h, w, c)


def spatial_partitioning(card: str, tmp: str) -> tuple:
    """Phase 16, in the temporary directory ``tmp``. Returns the fade-in
    launches of its runs (every rank's and the one-process runs') and the
    fade-in's times at the 'sp' shapes."""
    import numpy as np
    import torch
    from gan_lib_tensorflow_tpu_torch.cli import sample, train_pggan
    from gan_lib_tensorflow_tpu_torch.ops import fadein as fd
    from gan_lib_tensorflow_tpu_torch.train import make_train_step
    from gan_lib_tensorflow_tpu_torch.train.loop import device_batches
    from gan_lib_tensorflow_tpu_torch.train.pggan_loop import build_phase
    fd_total = 0
    torch.cuda.empty_cache()
    sp_shapes = sorted([list(FADEIN_SP_SHAPES[0]), list(FADEIN_SP_SHAPES[1])])

    # (a) the 1024^2 transition phase, bf16, on 2 'sp' ranks against one process
    a_argv = ["--data", "device-fake", "--device", "cuda", "--final-resolution", "1024",
              "--steps-per-phase", str(SP_STEPS), "--compute-dtype", "bf16"]
    (recs,) = torchrun(2, [[os.path.join(tmp, "a"), None, a_argv + ["--sp-shards", "2"], False]],
                       sp_steps=SP_STEPS)
    one = sp_step_run(None, SP_STEPS, a_argv)
    for rec in recs:
        check(rec["mesh"] == {"data": 1, "sp": 2}, f"(a) mesh {rec['mesh']}")
        check(rec["fd"] == 6 * SP_STEPS and rec["shapes"] == sp_shapes,
              f"(a) rank {rec['rank']}: {rec['fd']} fade-in launches at {rec['shapes']}, want "
              f"{6 * SP_STEPS} at {sp_shapes}")
    check(one["fd"] == 6 * SP_STEPS, f"(a) one process: {one['fd']} fade-in launches")
    fd_total += sum(r["fd"] for r in recs) + one["fd"]
    # bf16: the shards' convolutions sum in another order than the whole
    # image's; step 1 starts from one state on one batch with one set of draws
    a_err = losses_close([recs[0]["per_step"][0]["metrics"]], [one["per_step"][0]["metrics"]],
                         5e-2, 5e-2, "(a) step 1, 'sp' 2 vs one process")
    later = max(abs(a[k] - b[k]) for sa, sb in zip(recs[0]["per_step"], one["per_step"])
                for a, b in [(sa["metrics"], sb["metrics"])] for k in b if k != "step")
    ms2 = 1e3 * statistics.mean(st["sec"] for st in recs[0]["per_step"][1:])
    ms1 = 1e3 * statistics.mean(st["sec"] for st in one["per_step"][1:])
    kinds = {}
    for st in recs[0]["per_step"][1:]:
        for kind, (n, sec) in st["collectives"].items():
            tot = kinds.setdefault(kind, [0, 0.0])
            tot[0] += n / (SP_STEPS - 1)
            tot[1] += 1e3 * sec / (SP_STEPS - 1)
    coll = ", ".join(f"{kind} {n:.0f} calls {ms:.1f} ms" for kind, (n, ms) in sorted(kinds.items()))
    coll_ms = sum(ms for _, ms in kinds.values())
    print(f"(a) the 1024x1024 transition phase, full width, bf16, batch 4, S2D top level: 'sp' 2 "
          f"(gloo, one card) vs one process: step 1's metrics within 5e-2 (largest difference "
          f"{a_err:.3e}; over steps 1-{SP_STEPS} {later:.3e}: {recs[0]['per_step'][-1]['metrics']} "
          f"vs {one['per_step'][-1]['metrics']}); fade-in launches per rank "
          f"{[r['fd'] for r in recs]} at {sp_shapes}; ms/step (steps 2-{SP_STEPS}) 'sp' 2 "
          f"{ms2:.2f}, one process {ms1:.2f}; rank 0 per step: {coll} ({coll_ms:.1f} ms, "
          f"{coll_ms / ms2:.3f} of the step); peak per rank "
          f"{max(r['peak_mib'] for r in recs):.0f} MiB, one process {one['peak_mib']:.0f} MiB  "
          f"[{card}]", flush=True)

    # (b) the ladder under DP x SP 2 x 2, fp32, the S2D top level at its last two rungs
    res, n_trans = SP_LADDER_RES, int(math.log2(SP_LADDER_RES // 4))
    pg = ["--data", "device-fake", "--final-resolution", str(res), "--steps-per-phase", "1",
          "--log-every", "1", "--compute-dtype", "fp32", "--sample-every", "1000",
          "--ckpt-every", "1000", "--s2d-from", str(SP_LADDER_S2D)]
    (recs,) = torchrun(4, [[os.path.join(tmp, "b"), "train_pggan",
                            pg + ["--sp-shards", "2", "--out-dir", os.path.join(tmp, "b4")], True]])
    undo = sgd_for_adam()
    try:
        fd.launches = 0
        train_pggan.main(pg + ["--device", "cuda", "--out-dir", os.path.join(tmp, "b1")])
        torch.cuda.synchronize()
        one_fd = fd.launches
    finally:
        undo()
    for rec in recs:
        want = 6 * n_trans + (n_trans if rec["rank"] == 0 else 0)
        check(rec["mesh"] == {"data": 2, "sp": 2} and rec["fd"] == want,
              f"(b) rank {rec['rank']} on {rec['mesh']}: {rec['fd']} fade-in launches, want {want}")
    check(one_fd == 7 * n_trans, f"(b) one process: {one_fd} fade-in launches, "
                                 f"want {7 * n_trans}")
    fd_total += sum(r["fd"] for r in recs) + one_fd
    b_err = 0.0
    for phase_dir in (f"{res}x{res}_transition", f"{res}x{res}_stabilize"):
        l4, l1 = (read_log(os.path.join(tmp, c, phase_dir)) for c in ("b4", "b1"))
        b_err = max(b_err, losses_close(l4, l1, 1e-3, 1e-4, f"(b) {phase_dir}"))
    print(f"(b) train_pggan --sp-shards 2 on 4 ranks (DP x SP 2 x 2, gloo, one card), the ladder "
          f"4x4 -> {res}x{res} in fp32, 1 step per phase, --s2d-from {SP_LADDER_S2D}, SGD for "
          f"Adam: the {res}x{res} phases' metrics within 1e-3 of one process (largest difference "
          f"{b_err:.3e}: {l4[-1]} vs {l1[-1]}); fade-in launches per rank "
          f"{[r['fd'] for r in recs]} (6 per transition step, and rank 0's {n_trans} grids); "
          f"ladder {max(r['seconds'] for r in recs):.1f} s "
          f"on 4 ranks; peak per rank {max(r['peak_mib'] for r in recs):.0f} MiB  [{card}]",
          flush=True)

    # (d) (b)'s checkpoint, written under 'sp' 2, sampled by one process
    top = os.path.join(tmp, "b4", f"{res}x{res}_stabilize")
    png = os.path.join(tmp, "d.png")
    sample.main(["--model", "pggan", "--resolution", str(res), "--ckpt-dir",
                 os.path.join(top, "ckpt"), "--n", "16", "--seed", "99", "--out", png,
                 "--device", "cuda"])
    mine, theirs = read_png(png), read_png(os.path.join(top, "sample_000001.png"))
    check(mine.shape == theirs.shape, f"(d) grids {mine.shape} and {theirs.shape}")
    diff = np.abs(mine.astype(np.int16) - theirs.astype(np.int16))
    n_off = int((diff > 0).sum())
    check(int(diff.max()) <= 1 and n_off <= 1e-3 * diff.size,
          f"(d) the one-process grid is {int(diff.max())} levels from the writer's at {n_off} values")
    print(f"(d) the 'sp' 2 run's {res}x{res} stabilize checkpoint restored by one-process "
          f"cli.sample (16 samples, the writer's z): its grid {mine.shape} against the writer's "
          f"own: largest difference {int(diff.max())} level(s) of 255 at {n_off} of {diff.size} "
          f"values (the writer's G has the S2D top level, cli.sample's the composed one)",
          flush=True)

    # (c) S2D against the composed top level on one rank, bf16, from one state
    runs = {}
    for s2d_from in (512, 0):
        args = train_pggan.parse_args(["--data", "device-fake", "--device", "cuda",
                                       "--final-resolution", "1024", "--compute-dtype", "bf16",
                                       "--s2d-from", str(s2d_from)])
        ph = build_phase(train_pggan.ladder_config(args), 1024, "transition")
        ph.state.alpha = 0.5
        batches = device_batches(train_pggan.source_factory(args)(1024, ph.batch), 1, "cuda")
        runs[s2d_from] = {"ph": ph, "batches": batches, "step": make_train_step(ph.spec),
                          "ms": []}
    fd.launches = 0
    for s2d_from, run in runs.items():  # step 1 from one state, then the peak of step 2
        run["first"] = {k: float(v) for k, v in run["step"](run["ph"].state,
                                                              next(run["batches"])).items()}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run["step"](run["ph"].state, next(run["batches"]))
        torch.cuda.synchronize()
        run["peak"] = (torch.cuda.max_memory_allocated() - base) / 2**20
        for _ in range(S2D_WARM - 1):
            run["step"](run["ph"].state, next(run["batches"]))
    for _ in range(S2D_ROUNDS):  # in turns, so that the card's clocks treat both alike
        for run in runs.values():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(S2D_TIMED):
                run["step"](run["ph"].state, next(run["batches"]))
            torch.cuda.synchronize()
            run["ms"].append(1e3 * (time.perf_counter() - t0) / S2D_TIMED)
    n_steps = 1 + S2D_WARM + S2D_ROUNDS * S2D_TIMED
    check(fd.launches == 2 * 6 * n_steps, f"(c) {fd.launches} fade-in launches")
    fd_total += fd.launches
    c_err = losses_close([{"step": 1, **runs[512]["first"]}], [{"step": 1, **runs[0]["first"]}],
                         5e-2, 5e-2, "(c) S2D vs composed, step 1")
    print(f"(c) the 1024x1024 transition step, full width, bf16, batch 4, one rank: --s2d-from "
          f"512 vs 0 from one state: step 1's metrics within 5e-2 (largest difference "
          f"{c_err:.3e}: {runs[512]['first']} vs {runs[0]['first']}); ms/step (rounds of "
          f"{S2D_TIMED} in turns) S2D {[round(m, 2) for m in runs[512]['ms']]}, composed "
          f"{[round(m, 2) for m in runs[0]['ms']]}; the step's peak above its resident state "
          f"S2D {runs[512]['peak']:.0f} MiB, composed {runs[0]['peak']:.0f} MiB  [{card}]",
          flush=True)
    del runs

    # the fade-in at the shapes one 'sp' rank gives it
    cl = torch.channels_last
    times = {}
    for shape in FADEIN_SP_SHAPES:
        a = torch.randn(shape, device="cuda").contiguous(memory_format=cl)
        b = torch.randn(shape, device="cuda").contiguous(memory_format=cl)
        t = timed_in_turns({"kernel": lambda: fd.launch(a, b, 0.37),
                            "lerp": lambda: torch.lerp(b, a, 0.37),
                            "plain": lambda: fd.plain_fadein_blend(a, b, 0.37)}, 20)
        err = float((fd.launch(a, b, 0.37) - fd.plain_fadein_blend(a, b, 0.37)).abs().max())
        check(err <= 1e-6, f"fade-in at {list(shape)}: {err:.3e} from its plain version")
        bound = 1e3 * 12 * a.numel() / PEAK_BYTES_PER_S
        times[tuple(shape)] = t
        print(f"fadein_blend {list(shape)} channels-last (one 'sp' rank): kernel "
              f"{1e3 * t['kernel']:.2f} us, plain {1e3 * t['plain']:.2f} us, torch.lerp "
              f"{1e3 * t['lerp']:.2f} us, bound {1e3 * bound:.2f} us, max abs err "
              f"{err:.3e}  [{card}]", flush=True)
        del a, b
    return fd_total, times


def tool_rows(module, argv: list, keys: set) -> list:
    """Run a tool's ``main(argv)`` in this process; its JSON rows, each
    checked for ``keys`` and no ``error``, its return code for 0."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    out = buf.getvalue()
    print(out, end="", flush=True)
    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    name = module.__name__.rsplit(".", 1)[-1]
    check(rc == 0 and rows, f"{name} {argv}: rc {rc}, {len(rows)} rows")
    for row in rows:
        check("error" not in row and keys <= set(row), f"{name}: row {row} lacks {keys}")
    print(f"{name}: {len(rows)} rows in {time.perf_counter() - t0:.1f} s", flush=True)
    return rows


def tools_on_the_card(card: str, tmp: str) -> int:
    """Phase 17: the tools and the --data words on the card; returns the
    power-iteration launches of its runs (6 per SNGAN or ImageNet step)."""
    import numpy as np
    import torch

    from gan_lib_tensorflow_tpu_torch import data
    from gan_lib_tensorflow_tpu_torch.cli import common, train_sngan
    from gan_lib_tensorflow_tpu_torch.eval.inception_v3 import InceptionV3Features
    from gan_lib_tensorflow_tpu_torch.ops import fadein as fd
    from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi
    from gan_lib_tensorflow_tpu_torch.tools import (bench_eval, bench_kstep, bench_loader,
                                                    bench_pggan, bench_step, calibrate_rungs,
                                                    convert_inception_weights,
                                                    decompose_pggan, prepack_dataset,
                                                    probe_cond_cost)

    timed = str(TOOL_TIMED)
    pi_total, fd_before = 0, fd.launches

    def launches_per_step(expected: int, what: str) -> None:
        nonlocal pi_total
        check(pi.launches == expected, f"{what}: {pi.launches} power-iteration launches, "
              f"want {expected}")
        pi_total += pi.launches

    pi.launches = 0
    rows = tool_rows(bench_step, ["--model", "sngan", "acgan", "imagenet", "--timed-steps",
                                  timed], {"model", "batch", "n_critic", "ms_per_step",
                                           "img_per_sec"})
    check([(r["model"], r["batch"], r["n_critic"]) for r in rows]
          == [("sngan", 64, 5), ("acgan", 100, 1), ("imagenet", 64, 5)],
          f"bench_step's configurations {rows}")
    launches_per_step(2 * 6 * (3 + TOOL_TIMED), "bench_step sngan + imagenet")

    tool_rows(bench_pggan, ["--resolution", "1024", "--batch", "4", "--remat-from", "0",
                            "--fused-from", "128", "--s2d-from", "0", "512",
                            "--timed-steps", timed],
              {"resolution", "batch", "remat_from", "fused_from", "s2d_from", "ms_per_step",
               "img_per_sec"})
    (dec,) = tool_rows(decompose_pggan, ["--res", "1024", "--batch", "4", "--s2d-from", "512",
                                         "--reps", timed],
                       {"s2d_from", "res", "batch", "g_fwd_ms", "d_fwd_ms", "g_grad_ms",
                        "gp_grad_ms", "d_grad_full_ms"})
    check(0 < dec["gp_grad_ms"] < dec["d_grad_full_ms"], f"decompose_pggan: {dec}")

    pi.launches = 0
    rows = tool_rows(calibrate_rungs, ["--rungs", "acgan", "imagenet", "pggan1024",
                                       "--s2d-from", "512", "--timed-steps", timed],
                     {"rung", "batch", "ms_per_step", "img_per_sec", "tf_per_step",
                      "roofline_ms_nominal", "roofline_ms_achieved", "mfu_nominal",
                      "frac_of_achieved"})
    for row in rows:
        check(row["tf_per_step"] > 0 and 0 < row["mfu_nominal"] <= 1,
              f"calibrate_rungs {row['rung']}: tf {row['tf_per_step']}, "
              f"mfu {row['mfu_nominal']}")
    launches_per_step(6 * (2 + TOOL_TIMED), "calibrate_rungs imagenet")

    pi.launches = 0
    tool_rows(probe_cond_cost, ["--timed-steps", timed],
              {"config", "ms_per_step", "img_per_sec"})
    launches_per_step(2 * 6 * (3 + TOOL_TIMED), "probe_cond_cost cond + uncond")

    tool_rows(bench_eval, ["--n-samples", "1000", "--batch-size", "100"],
              {"mode", "n_samples", "wall_s", "samples_per_s", "is", "trace_cov"})
    tool_rows(bench_loader, ["--n", "4000", "--size", "128", "--batch", "64", "--n-batches",
                             "50", "--rss-demo", "--store-dir", os.path.join(tmp, "store")],
              set())
    rows = tool_rows(bench_kstep, ["--ks", "1", "5", "--reps", "10"],
                     {"model", "mode", "k", "ms_per_step"})
    check(sorted({(r["model"], r["mode"]) for r in rows})
          == [("acgan", "chained"), ("acgan", "fused"), ("pix2pix", "chained"),
              ("pix2pix", "fused")], f"bench_kstep's rows {rows}")

    # the npz prepack into a pyramid store, read back member by member
    rng = np.random.default_rng(0)
    src = os.path.join(tmp, "npz")
    os.makedirs(src)
    for i in range(2):
        np.savez(os.path.join(src, f"part{i}.npz"),
                 data=rng.integers(0, 256, (32, 128, 128, 3), np.uint8),
                 labels=rng.integers(0, 10, 32))
    res = [128 >> i for i in range(6)]
    tool_rows(prepack_dataset, ["--src", src, "--out", os.path.join(tmp, "pyr"), "--size",
                                "128", "--resolutions", ",".join(map(str, res))],
              {"packed", "resolutions", "bytes"})
    for r in res:
        store = data.open_pyramid(os.path.join(tmp, "pyr"), batch_size=8, resolution=r)
        check(len(store) == 64 and store.image_size == r and store.num_classes == 10,
              f"pyramid member {r}: {len(store)} images at {store.image_size}^2")

    # the InceptionV3 converter on a random torchvision-layout state dict
    pth, npz = os.path.join(tmp, "inception.pth"), os.path.join(tmp, "inception.npz")
    torch.save(convert_inception_weights.torchvision_state_dict(0), pth)
    check(convert_inception_weights.main([pth, npz, "--verify", "--device", "cuda"]) == 0,
          "convert_inception_weights --verify")
    images = torch.rand(4, 64, 64, 3, generator=torch.Generator().manual_seed(0)) * 2 - 1
    got, _ = InceptionV3Features(params_npz=npz, device="cuda")(images.cuda())
    want, _ = InceptionV3Features(params_npz=npz, device="cpu")(images)
    rel = float((got.cpu() - want).abs().max() / want.abs().max())
    check(rel <= 1e-4 and bool(torch.isfinite(got).all()),
          f"converted InceptionV3 features, card vs CPU: {rel:.3e} of the largest")
    print(f"convert_inception_weights: torchvision layout -> npz, features of 4 images "
          f"on the card vs the CPU within {rel:.3e} of the largest ({float(want.abs().max()):.4g})")

    # every --data word of the reference on train_sngan, 2 steps each
    pi.launches = 0
    for word in DATA_WORDS:
        out_dir = os.path.join(tmp, f"data_{word}")
        extra = (["--curves", "--tensorboard", "--compile-cache", os.path.join(tmp, "cc")]
                 if word == DATA_WORDS[-1] else [])
        sources, buf = [], io.StringIO()
        inner = captured(common, "image_source", sources)
        try:
            with contextlib.redirect_stdout(buf):
                train_sngan.main(["--data", word, "--device", "cuda", "--steps", "2",
                                  "--batch-size", str(BATCH),
                                  "--log-every", "1", "--sample-every", "1000",
                                  "--out-dir", out_dir] + extra)
        finally:
            common.image_source = inner
        printed = buf.getvalue()
        host = isinstance(sources[0], data.ThreadedSource)
        check(host == (not word.startswith("device-")), f"--data {word}: {sources[0]}")
        check(len(read_log(out_dir)) == 2, f"--data {word}: {read_log(out_dir)}")
        last_sec_per_step(out_dir)
        if extra:
            check("tensorboard logging unavailable" in printed
                  or os.path.isdir(os.path.join(out_dir, "tb")), "--tensorboard did nothing")
            check("--compile-cache" in printed, "--compile-cache printed no note")
            curves = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
            check({"d_loss.png", "g_loss.png"} <= set(curves), f"--curves wrote {curves}")
            shapes = {read_png(os.path.join(out_dir, f)).shape for f in curves}
            check(shapes == {(300, 600, 3)}, f"curve PNG shapes {shapes}")
            print(f"--curves: {curves}; --tensorboard: "
                  f"{[l for l in printed.splitlines() if 'tensorboard' in l]}")
        print(f"--data {word}: {type(sources[0]).__name__}, 2 steps", flush=True)
    launches_per_step(len(DATA_WORDS) * 6 * 2, "train_sngan --data words")
    check(fd.launches == fd_before, "a tool launched the fade-in")
    print(f"phase 17 power-iteration launches: {pi_total}  [{card}]", flush=True)
    return pi_total


def scene_u8(h: int, w: int, seed: int):
    """A synthetic image for the folders written here: gradients and discs,
    uint8 [h, w, 3]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([x / w * 200 + 30, y / h * 180 + 40, (x + y) / (w + h) * 120 + 60], -1)
    for _ in range(6):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(0.05, 0.3) * min(h, w)
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.uniform(0, 255, 3)
    return img.astype(np.uint8)


def image_folders(card: str, tmp: str) -> tuple:
    """Phase 18, in the temporary directory ``tmp``. Returns the
    power-iteration and fade-in launches of its runs."""
    import hashlib
    import shutil as sh

    import numpy as np
    import torch
    from gan_lib_tensorflow_tpu_torch import data
    from gan_lib_tensorflow_tpu_torch.cli import (evaluate, train_pggan, train_pix2pix,
                                                  train_sngan_imagenet)
    from gan_lib_tensorflow_tpu_torch.data import codec
    from gan_lib_tensorflow_tpu_torch.data.packed import store_digest
    from gan_lib_tensorflow_tpu_torch.ops import fadein as fd
    from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi
    from gan_lib_tensorflow_tpu_torch.tools import prepack_dataset
    from gan_lib_tensorflow_tpu_torch.train import LoopConfig, make_train_step, pggan_loop, train_loop
    from gan_lib_tensorflow_tpu_torch.train.loop import device_batches
    from gan_lib_tensorflow_tpu_torch.train.pggan_loop import build_phase
    from gan_lib_tensorflow_tpu_torch.utils.images import png_bytes

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), FIXTURES)
    with open(os.path.join(root, "manifest.json")) as f:
        manifest = json.load(f)
    host = f"{card}; host: {os.cpu_count()} CPUs"
    pi_total = fd_total = 0

    def sha(a) -> str:
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    def write_png(path: str, img) -> None:
        with open(path, "wb") as f:
            f.write(png_bytes(img))

    # (a) every fixture decoded, cropped and resized as Pillow does
    bad = []
    for rel, want in sorted(manifest["files"].items()):
        path = os.path.join(root, rel)
        rgb = codec.decode_rgb(path)
        if list(rgb.shape) != want["shape"]:
            bad.append(f"{rel}: shape {list(rgb.shape)}, Pillow's {want['shape']}")
            continue
        if sha(rgb) != want["rgb"]:
            rows = [i for i in range(rgb.shape[0])
                    if sha(rgb[i])[:8] != want["rows"][8 * i:8 * i + 8]]
            bad.append(f"{rel}: {len(rows)} of {rgb.shape[0]} rows differ from Pillow's "
                       f"decode (the first: {rows[:8]})")
        for size, digest in want["square"].items():
            if sha(codec.load_square(path, int(size))) != digest:
                bad.append(f"{rel}: the center square resized to {size}^2 differs")
        for size, digest in want.get("halves", {}).items():
            if sha(np.concatenate(codec.load_halves(path, int(size)), axis=1)) != digest:
                bad.append(f"{rel}: the halves resized to {size}^2 differ")
    for line in bad:
        print(f"MISMATCH {line}")
    check(not bad, f"{len(bad)} fixture decodes differ from the reference's")
    print(f"decoder: {len(manifest['files'])} fixtures decoded as Pillow "
          f"{manifest['pillow']} / libjpeg-turbo {manifest['libjpeg_turbo']} decodes them, "
          "with their center squares resized for the loaders and the pix2pix halves "
          "(sha256 of every uint8 array equal)")
    kinds = {}
    for rel in manifest["files"]:
        with open(os.path.join(root, rel), "rb") as f:
            head = f.read()
        kind = ("PNG" if rel.endswith(".png") else
                "JPEG progressive" if b"\xff\xc2" in head else "JPEG baseline")
        kinds.setdefault(kind, []).append(os.path.join(root, rel))
    for kind, paths in sorted(kinds.items()):
        n = pixels = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < DECODE_SECONDS:
            for p in paths:
                pixels += codec.decode_rgb(p).size // 3
                n += 1
        dt = time.perf_counter() - t0
        print(f"decode {kind} ({len(paths)} fixtures): {n / dt:.1f} images/s, "
              f"{pixels / dt / 1e6:.2f} Mpixel/s, one thread  [{host}]")

    # (b) pix2pix at full width from the folder of combined A|B JPEGs
    combined = os.path.join(root, "combined")
    run_args = ["--device", "cuda", "--compute-dtype", "bf16", "--log-every", str(FOLDER_LOG),
                "--sample-every", "1000", "--steps", str(FOLDER_STEPS)]
    pi.launches = fd.launches = 0
    folder_run = os.path.join(tmp, "pix2pix_folder")
    state = train_pix2pix.main(run_args + ["--data", combined, "--out-dir", folder_run,
                                           "--ckpt-every", str(FOLDER_STEPS)])
    folder_sps = last_sec_per_step(folder_run)
    check(state.step == FOLDER_STEPS, f"pix2pix from the folder ended at step {state.step}")
    del state
    metrics = train_pix2pix.main(["--device", "cuda", "--mode", "test", "--data", combined,
                                  "--out-dir", folder_run])
    n_files = len(os.listdir(combined))
    check(metrics["n_examples"] == n_files and math.isfinite(metrics["test_l1"])
          and len(os.listdir(os.path.join(folder_run, "images"))) == 3 * n_files,
          f"pix2pix --mode test over the folder: {metrics}")
    store = os.path.join(tmp, "pix2pix_store")
    prepack_dataset.main(["--src", combined, "--out", store, "--size", "286", "--paired"])
    store_run = os.path.join(tmp, "pix2pix_store_run")
    train_pix2pix.main(run_args + ["--data", store, "--out-dir", store_run,
                                   "--ckpt-every", "1000"])
    store_sps = last_sec_per_step(store_run)
    check(pi.launches == 0 and fd.launches == 0, "pix2pix launched a kernel")
    print(f"pix2pix at full width (U-Net 256^2, PatchGAN 30x30, batch 1, bf16) from "
          f"{n_files} combined JPEGs: {1e3 * folder_sps:.2f} ms/step from the folder "
          f"(2 host workers decoding and jittering), {1e3 * store_sps:.2f} ms/step from the "
          f"--paired store of the same images held on the card (steps "
          f"{FOLDER_STEPS - FOLDER_LOG + 1}-{FOLDER_STEPS}); --mode test over the folder: "
          f"{metrics['n_examples']} examples, test L1 {metrics['test_l1']:.4f}  [{host}]")

    # (c) SNGAN-projection ImageNet-128 at full width from a class folder
    classes = os.path.join(tmp, "imagenet_classes")
    jpegs = sorted(os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
                   if f.endswith(".jpg"))
    for c, wnid in enumerate(("n01440764", "n01443537")):
        os.makedirs(os.path.join(classes, wnid))
        for i in range(FOLDER_CLASS_FILES):
            name = os.path.join(classes, wnid, f"{wnid}_{i:04d}")
            if i % 2:
                write_png(name + ".png", scene_u8(120 + 9 * (i % 5), 160 + 7 * (i % 7), i + c))
            else:
                sh.copy(jpegs[(i // 2 + c) % len(jpegs)], name + ".JPEG")
    rates = {}
    for workers in (1, 2):
        src = iter(data.ThreadedSource(data.ImageFolderByClass(
            classes, batch_size=BATCH, image_size=128), num_workers=workers))
        next(src)
        t0 = time.perf_counter()
        for _ in range(N_CRITIC):
            next(src)
        rates[workers] = N_CRITIC * BATCH / (time.perf_counter() - t0)
        src.close()
    im_run = os.path.join(tmp, "imagenet_folder")
    pi.launches = 0
    im_args = ["--data", classes, "--device", "cuda", "--compute-dtype", "bf16",
               "--log-every", str(FOLDER_LOG), "--sample-every", "1000"]
    state = train_sngan_imagenet.main(im_args + ["--steps", str(FOLDER_STEPS), "--out-dir",
                                                 im_run, "--ckpt-every", str(FOLDER_STEPS)])
    torch.cuda.synchronize()
    check(state.step == FOLDER_STEPS and pi.launches == (N_CRITIC + 1) * FOLDER_STEPS,
          f"power-iteration launches {pi.launches} in {state.step} steps, want 6 per step")
    pi_total += pi.launches
    two_sps = last_sec_per_step(im_run)
    del state
    # the same path behind one worker, through the CLI's own build and loop
    args = train_sngan_imagenet.parse_args(im_args)
    _, _, spec, state = train_sngan_imagenet.build(args)
    one = data.ThreadedSource(data.ImageFolderByClass(classes, batch_size=BATCH,
                                                      image_size=128), num_workers=1)
    step_fn = make_train_step(spec)
    pi.launches = 0
    train_loop(state, step_fn, one, LoopConfig(1, 1), n_micro=spec.n_critic)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_loop(state, step_fn, one, LoopConfig(1 + FOLDER_LOG, FOLDER_LOG),
               n_micro=spec.n_critic)
    torch.cuda.synchronize()
    one_sps = (time.perf_counter() - t0) / FOLDER_LOG
    check(pi.launches == (N_CRITIC + 1) * (1 + FOLDER_LOG),
          f"power-iteration launches {pi.launches} behind one worker")
    pi_total += pi.launches
    del state, spec, step_fn
    print(f"SNGAN-projection ImageNet-128 at full width from a class folder (2 classes, "
          f"{2 * FOLDER_CLASS_FILES} JPEGs and PNGs, {N_CRITIC} x {BATCH} decodes a step): "
          f"{1e3 * two_sps:.2f} ms/step with 2 host workers, {1e3 * one_sps:.2f} ms/step with "
          f"1; the loader alone {rates[2]:.1f} images/s with 2 workers, {rates[1]:.1f} with 1 "
          f"(decode, center crop, resize to 128^2, normalize); 6 power-iteration launches a "
          f"step  [{host}]")

    # (d) the PGGAN ladder at full width (Karras channels) from a flat folder
    flat = os.path.join(tmp, "pggan_flat")
    os.makedirs(flat)
    singles = sorted(os.listdir(os.path.join(root, "single")))
    for i in range(FOLDER_FLAT_FILES):
        if i < len(singles):
            sh.copy(os.path.join(root, "single", singles[i]), os.path.join(flat, singles[i]))
        else:
            write_png(os.path.join(flat, f"face_{i:03d}.png"),
                      scene_u8(300 + 10 * (i % 3), 300, 100 + i))
    ladder_run = os.path.join(tmp, "pggan_folder")
    per_phase, logs = [], []
    inner_ladder, inner_sampler = train_pggan.train_pggan_ladder, pggan_loop._phase_sampler

    def hook(when, res, name, st):
        if when == "start":
            per_phase.append({"res": res, "name": name, "fd": fd.launches, "grid": 0,
                              "t0": time.perf_counter()})
        else:
            torch.cuda.synchronize()
            rec = per_phase[-1]
            rec["fd"] = fd.launches - rec["fd"]
            rec["s"] = time.perf_counter() - rec.pop("t0")

    def ladder(cfg, factory, **kw):
        def recording(res, batch):
            src = factory(res, batch)
            per_phase[-1]["source"] = src
            return src
        return inner_ladder(cfg, recording, phase_hook=hook,
                            log_fn=lambda it, m: logs.append(m))

    def counting_sampler(cfg, ph, phase_dir):
        fn = inner_sampler(cfg, ph, phase_dir)

        def grid(state, it):
            before = fd.launches
            fn(state, it)
            per_phase[-1]["grid"] += fd.launches - before
        return grid

    train_pggan.train_pggan_ladder, pggan_loop._phase_sampler = ladder, counting_sampler
    fd.launches = pi.launches = 0
    t0 = time.perf_counter()
    try:
        final = train_pggan.main([
            "--data", flat, "--device", "cuda", "--final-resolution", str(FOLDER_LADDER_RES),
            "--steps-per-phase", "1", "--log-every", "1", "--compute-dtype", "bf16",
            "--ckpt-every", "1", "--sample-every", "1000", "--out-dir", ladder_run])
        torch.cuda.synchronize()
    finally:
        train_pggan.train_pggan_ladder, pggan_loop._phase_sampler = inner_ladder, inner_sampler
    ladder_s = time.perf_counter() - t0
    n_phases = 2 * int(math.log2(FOLDER_LADDER_RES)) - 3
    check(len(per_phase) == n_phases and final.step == 1 and final.alpha == 1.0
          and pi.launches == 0, f"{len(per_phase)} phases, want {n_phases}")
    for rec in per_phase:
        trans = rec["name"] == "transition"
        steps_fd = rec["fd"] - rec["grid"]
        src = rec["source"]
        check(isinstance(src, data.ThreadedSource)
              and isinstance(src.source, data.MultiResolution)
              and src.source.base.image_size == FOLDER_LADDER_RES
              and src.source.resolution == rec["res"],
              f"{rec['res']}x{rec['res']} {rec['name']} read {src}")
        check(steps_fd == (6 if trans else 0),
              f"{rec['res']}x{rec['res']} {rec['name']}: {steps_fd} fade-in launches in its step")
    step_launches = sum(rec["fd"] - rec["grid"] for rec in per_phase)
    fd_total += fd.launches
    check(len(logs) == n_phases and all(math.isfinite(v) for m in logs for v in m.values()),
          "non-finite ladder metrics")
    print(f"PGGAN ladder 4x4 -> {FOLDER_LADDER_RES}x{FOLDER_LADDER_RES} at full width (bf16, "
          f"1 step a phase, checkpoints) from a flat folder of {FOLDER_FLAT_FILES} JPEGs and "
          f"PNGs decoded at {FOLDER_LADDER_RES}^2 and box-downsampled per phase: "
          f"{n_phases} phases in {ladder_s:.1f} s, fade-in launches {fd.launches} "
          f"({step_launches} in the steps: 6 per transition step, 0 per stabilize step; "
          f"{fd.launches - step_launches} in the sample grids)  [{host}]")
    del final

    flat1024 = os.path.join(tmp, "pggan_flat1024")
    os.makedirs(flat1024)
    for i in range(FOLDER_1024_FILES):
        write_png(os.path.join(flat1024, f"hq_{i:03d}.png"), scene_u8(1024, 1024, 200 + i))
    top = {}
    words = {"folder": flat1024, "device-fake": "device-fake"}
    cfg = train_pggan.ladder_config(train_pggan.parse_args(
        ["--data", flat1024, "--device", "cuda", "--compute-dtype", "bf16"]))
    cfg.out_dir = None
    ph = build_phase(cfg, 1024, "transition")
    pg_step = make_train_step(ph.spec)
    fd.launches = 0
    warm = None
    for word, data_arg in words.items():
        args = train_pggan.parse_args(["--data", data_arg, "--device", "cuda",
                                       "--compute-dtype", "bf16"])
        raw = train_pggan.source_factory(args)(1024, ph.batch)
        if word == "folder":
            # the loader alone, its first batch untimed; then the steps warm
            # up past every batch that the workers' queues, the batches in
            # their hands and the device prefetch can hold, so the timed
            # steps read batches decoded while the card trained
            loader = iter(raw)
            next(loader)
            t0 = time.perf_counter()
            for _ in range(FOLDER_1024_TIMED):
                next(loader)
            loader_s = (time.perf_counter() - t0) / FOLDER_1024_TIMED
            loader_rate = ph.batch / loader_s
            loader.close()
            warm = raw.depth + raw.num_workers + DEVICE_PREFETCH + 1
        source = device_batches(raw, 1, "cuda")
        for i in range(warm):
            ph.state.alpha = ph.alpha_fn(i)
            pg_step(ph.state, next(source))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(warm, warm + FOLDER_1024_TIMED):
            ph.state.alpha = ph.alpha_fn(i)
            metrics = pg_step(ph.state, next(source))
        torch.cuda.synchronize()
        top[word] = (time.perf_counter() - t0) / FOLDER_1024_TIMED
        check(all(math.isfinite(float(v)) for v in metrics.values()),
              f"non-finite 1024^2 metrics from {word}")
        del source  # its generators close, and the host workers stop
    check(fd.launches == 6 * 2 * (warm + FOLDER_1024_TIMED),
          f"{fd.launches} fade-in launches in the 1024^2 transition steps")
    fd_total += fd.launches
    del ph, pg_step
    print(f"PGGAN 1024x1024 transition phase (build_phase, batch {cfg.batch_by_res[1024]}, "
          f"bf16, {FOLDER_1024_TIMED} steps timed after {warm} warm-up steps): "
          f"{1e3 * top['folder']:.2f} ms/step from a flat folder of {FOLDER_1024_FILES} 1024^2 "
          f"PNGs (2 host workers), {1e3 * top['device-fake']:.2f} ms/step on device-fake "
          f"reals; the loader alone {1e3 * loader_s:.2f} ms/batch ({loader_rate:.1f} "
          f"images/s); 6 fade-in launches a step  [{host}]")

    # (e) cli.evaluate over the folders
    res = evaluate.main(["--model", "imagenet", "--device", "cuda", "--ckpt-dir",
                         os.path.join(im_run, "ckpt"), "--data", classes, "--n-samples",
                         "500", "--n-real", str(4 * BATCH), "--batch-size", str(BATCH)])
    check(res["real_source"] == classes and all(math.isfinite(res[k]) for k in
                                                ("fid", "inception_score")),
          f"cli.evaluate --model imagenet over the class folder: {res}")
    top_ckpt = os.path.join(ladder_run, f"{FOLDER_LADDER_RES}x{FOLDER_LADDER_RES}_stabilize",
                            "ckpt")
    pg = evaluate.main(["--model", "pggan", "--device", "cuda", "--ckpt-dir", top_ckpt,
                        "--resolution", str(FOLDER_LADDER_RES), "--data", flat,
                        "--n-samples", "160", "--swd-samples", "64", "--batch-size", "16"])
    check(pg["swd_images"] == 64 and 0 <= pg["ms_ssim"] <= 1 and all(
        math.isfinite(v) for k, v in pg.items() if k.startswith("swd_") and k != "swd_desc_dtype"),
        f"cli.evaluate --model pggan over the flat folder: {pg}")
    print(f"cli.evaluate over folders: --model imagenet FID {res['fid']:.3f} (real moments "
          f"from {4 * BATCH} class-folder images), --model pggan at {FOLDER_LADDER_RES}^2 "
          f"SWD avg {pg['swd_avg']:.3f}, MS-SSIM {pg['ms_ssim']:.4f} ({pg['swd_images']} "
          f"flat-folder reals)")

    # (f) the prepack tool on the fixtures: the reference tool's stores
    for name, spec in sorted(manifest["stores"].items()):
        out = os.path.join(tmp, f"store_{name}")
        prepack_dataset.main([a.format(root=root) for a in spec["argv"]] + ["--out", out])
        check(store_digest(out) == spec["sha256"],
              f"prepack {name}: store sha256 differs from the reference tool's")
    print(f"tools/prepack_dataset on the fixtures: {', '.join(sorted(manifest['stores']))} "
          "stores byte-equal to the reference tool's (sha256)")
    pi_total += webp_folder(host, tmp)
    return pi_total, fd_total


def webp_folder(host: str, tmp: str) -> int:
    """Phase 18 (g)-(i): the WebP decoder on the committed fixtures, its
    decode rates, and ImageNet-128 trained from a store packed from a WebP
    folder. Returns the power-iteration launches of that run."""
    import hashlib
    import shutil as sh

    import numpy as np
    import torch
    from gan_lib_tensorflow_tpu_torch.cli import train_sngan_imagenet
    from gan_lib_tensorflow_tpu_torch.data import codec
    from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi
    from gan_lib_tensorflow_tpu_torch.tools import prepack_dataset

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), WEBP_FIXTURES)
    with open(os.path.join(root, "manifest.json")) as f:
        manifest = json.load(f)
    files = manifest["files"]

    def sha(a) -> str:
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    # (g) every WebP fixture, RGB and RGBA, and what its decode met
    bad = []
    for name, want in sorted(files.items()):
        path = os.path.join(root, name)
        rgb = codec.decode_rgb(path)
        if list(rgb.shape) != want["shape"] or sha(rgb) != want["rgb_sha256"]:
            bad.append(f"{name}: RGB {list(rgb.shape)} differs from Pillow's decode")
        if sha(codec.decode_webp_rgba(path)) != want["rgba_sha256"]:
            bad.append(f"{name}: RGBA differs from Pillow's")
        if codec.webp_features(path) != want["features"]:
            bad.append(f"{name}: the decode met {codec.webp_features(path)}, want "
                       f"{want['features']}")
    for line in bad:
        print(f"MISMATCH {line}")
    check(not bad, f"{len(bad)} WebP decodes differ from the reference's")
    print(f"WebP decoder (csrc/webpdec.cpp): {len(files)} fixtures (lossy, lossless, alpha, "
          f"animations) decoded as Pillow {manifest['pillow']} / libwebp {manifest['libwebp']} "
          f"decodes them: RGB and RGBA sha256 equal  [{host}]")

    # (h) one host thread's decode rate on the two 256^2 fixtures
    for name in WEBP_RATE_FILES:
        path = os.path.join(root, name)
        with open(path, "rb") as f:
            size = len(f.read())
        n = pixels = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < DECODE_SECONDS:
            pixels += codec.decode_rgb(path).size // 3
            n += 1
        dt = time.perf_counter() - t0
        print(f"decode {name} ({size} bytes, {'x'.join(map(str, files[name]['shape'][:2]))}): "
              f"{n / dt:.1f} images/s, {pixels / dt / 1e6:.2f} MP/s, one thread  [{host}]")

    # (i) a two-class folder of the fixtures, packed, and ImageNet-128 on it
    folder = os.path.join(tmp, "webp_classes")
    for c, wnid in enumerate(("n01440764", "n01443537")):
        os.makedirs(os.path.join(folder, wnid))
        for k in range(WEBP_COPIES):
            for name in sorted(files):
                sh.copy(os.path.join(root, name),
                        os.path.join(folder, wnid, f"{k}_{name}"))
    store = os.path.join(tmp, "webp_store")
    t0 = time.perf_counter()
    prepack_dataset.main(["--src", folder, "--out", store, "--size", "128"])
    pack_s = time.perf_counter() - t0
    with open(os.path.join(store, "meta.json")) as f:
        meta = json.load(f)
    check(meta["n"] == 2 * WEBP_COPIES * len(files) and meta["num_classes"] == 2,
          f"the WebP store: {meta}")
    errs = []
    launch = pi.launch

    def held(weights, us, write_u=False, table=None):
        """The kernel, then its plain version on the same W and u."""
        u0 = [u.detach().clone() for u in us]
        out = launch(weights, us, write_u, table)
        plain, _, _ = pi.plain_power_iteration([w.detach() for w in weights], u0)
        torch.testing.assert_close(out[0], plain, rtol=1e-4, atol=0.0)
        errs.append(float((out[0] - plain).abs().max()))
        return out

    pi.launches = 0
    pi.launch = held
    try:
        state = train_sngan_imagenet.main([
            "--data", store, "--device", "cuda", "--steps", str(WEBP_STEPS), "--log-every", "1",
            "--sample-every", "1000", "--ckpt-every", "1000", "--compute-dtype", "bf16",
            "--out-dir", os.path.join(tmp, "webp_run")])
        torch.cuda.synchronize()
    finally:
        pi.launch = launch
    launches = pi.launches
    check(state.step == WEBP_STEPS and launches == (N_CRITIC + 1) * WEBP_STEPS
          and len(errs) == launches,
          f"ImageNet-128 from the WebP store: step {state.step}, {launches} launches")
    del state
    print(f"tools/prepack_dataset --size 128 on a two-class folder of {meta['n']} WebP files "
          f"(the fixtures, {WEBP_COPIES} copies a class): {pack_s:.2f} s; "
          f"cli.train_sngan_imagenet --data <that store> at full width: {WEBP_STEPS} fused steps, "
          f"{launches} power-iteration launches, each against the plain version (rtol 1e-4, "
          f"max abs err {max(errs):.3e})  [{host}]")
    return launches


def tf1_writer():
    """The test scaffolding's bundle writer (``tests/torch_fixtures/tf1/``)."""
    if os.path.abspath(TF1_FIXTURES) not in sys.path:
        sys.path.insert(0, os.path.abspath(TF1_FIXTURES))
    import bundle_writer
    return bundle_writer


def tf1_bundle_with(prefix: str, g, d, seed: int, extra: dict = None) -> tuple:
    """A tflib-named bundle of the port networks ``g`` and ``d`` (unit
    normals from ``seed``) written by the test scaffolding writer at
    ``prefix``; returns (prefix, [(tf name, flax path, value)])."""
    bundle_writer = tf1_writer()
    named = (bundle_writer.tflib_variables(g, "Generator", seed)
             + bundle_writer.tflib_variables(d, "Discriminator", seed + 1))
    bundle_writer.write_bundle(prefix, {**{n: v for n, _, v in named}, **(extra or {})})
    return prefix, named


def imported_equal_sources(ckpt_file: str, named: list, nchw: bool) -> int:
    """Every tensor of the step-0 checkpoint ``ckpt_file`` that came from
    the bundle equals its source in the port's layout (G's dense columns
    from (C, H, W) to (H, W, C) order under ``nchw``), and the EMA equals
    G; returns the tensors checked."""
    import numpy as np
    import torch
    from gan_lib_tensorflow_tpu_torch.convert import to_torch_names
    raw = torch.load(ckpt_file, map_location="cpu", weights_only=True)
    n = 0
    for tf_name, path, val in named:
        if nchw and tf_name.startswith("Generator") and path in ("params/dense/kernel",
                                                                 "params/dense/bias"):
            val = val[..., np.arange(val.shape[-1]).reshape(-1, 4, 4).transpose(1, 2, 0).ravel()]
        tree = val
        for k in reversed(path.split("/")[1:]):
            tree = {k: tree}
        ((name, want),) = to_torch_names(tree).items()
        net = raw["g" if tf_name.startswith("Generator") else "d"]
        check(np.array_equal(net[name].numpy(), want), f"imported {name} differs from {tf_name}")
        n += 1
    check(all(torch.equal(raw["ema_params"][k], raw["g"][k]) for k in raw["ema_params"]),
          "the EMA is not the imported G")
    check(raw["step"] == 0 and raw["g_sched"] is None, "not a step-0 checkpoint without schedule")
    return n


def sigma_against_plain(pi, torch, d) -> float:
    """The power iteration on D's SN weights (kernel) against its plain
    version on the same W and u; the max abs error of sigma."""
    ws = [m.weight.detach() for m in d.sn_layers]
    us = [m.u.detach().clone() for m in d.sn_layers]
    sigma, _, _ = pi.launch(ws, us)
    plain, _, _ = pi.plain_power_iteration(ws, us)
    torch.testing.assert_close(sigma, plain.detach(), rtol=1e-4, atol=0.0)
    return float((sigma - plain).abs().max())


def tf1_checkpoints(card: str, tmp: str) -> int:
    """Phase 19, in the temporary directory ``tmp``. Returns the
    power-iteration launches of its resumed SNGAN run. That resume is
    ``train_loop``'s, called here directly: the port's ``cli.train_sngan``
    refuses the imported checkpoint (it holds no lr schedule), as the
    reference's ``train_sngan`` refuses its tool's, and ``cli.sample`` and
    ``cli.evaluate``, which take the import, run no D."""
    import numpy as np
    import torch
    from gan_lib_tensorflow_tpu_torch.cli import common, sample, train_sngan
    from gan_lib_tensorflow_tpu_torch.models import sngan
    from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi
    from gan_lib_tensorflow_tpu_torch.tools import import_tf1_checkpoint as imp
    from gan_lib_tensorflow_tpu_torch.tools import tf1_bundle
    from gan_lib_tensorflow_tpu_torch.train import (CheckpointManager, LoopConfig, create_state,
                                                    make_train_step, train_loop)

    # (a) the committed TensorFlow-written checkpoints against their manifest
    with open(os.path.join(TF1_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    bundle_writer = tf1_writer()
    n_tensors, n_refused, formats = 0, 0, {}
    for key, entry in sorted(manifest["bundles"].items()):
        with tf1_bundle.open_bundle(os.path.join(TF1_FIXTURES, entry["prefix"])) as bundle:
            formats[entry["format"]] = formats.get(entry["format"], 0) + 1
            check(set(bundle.variables) == set(entry["tensors"]), f"{key}: other tensors listed")
            for name, want in entry["tensors"].items():
                dtype, shape = bundle.variables[name]
                check((dtype, list(shape)) == (want["dtype"], want["shape"]),
                      f"{key} {name}: {dtype} {shape}, the manifest's {want}")
                if "sha256" in want:
                    got = bundle_writer.digest(bundle.read(name))
                    check(got == want["sha256"], f"{key} {name}: sha256 differs from TensorFlow's")
                    n_tensors += 1
                else:  # TensorFlow's V1 reader refuses it: so does the port's
                    try:
                        bundle.read(name)
                    except tf1_bundle.BundleError as e:
                        check(want["refused"] in str(e), f"{key} {name}: refused with {e}")
                        n_refused += 1
                    else:
                        check(False, f"{key} {name}: read, where TensorFlow refuses it")
    for fault, target in (("data", ".data-00000-of-00001"), ("index", ".index")):
        copy = os.path.join(tmp, f"corrupt_{fault}")
        shutil.copytree(os.path.join(TF1_FIXTURES, "dtypes"), copy)
        path = os.path.join(copy, "model.ckpt" + target)
        with open(path, "r+b") as f:  # a byte of a tensor or of the first block
            f.seek(10)
            b = f.read(1)
            f.seek(10)
            f.write(bytes([b[0] ^ 0x40]))
        try:
            with tf1_bundle.open_bundle(os.path.join(copy, "model.ckpt")) as bundle:
                for name, (dtype, _) in bundle.variables.items():
                    if dtype != "string":
                        bundle.read(name)
        except tf1_bundle.BundleError as e:
            check("CRC32C mismatch" in str(e), f"flipped {fault} byte: {e}")
        else:
            check(False, f"a flipped {fault} byte was not refused")
    rate_prefix = os.path.join(tmp, "rate", "model.ckpt")
    bundle_writer.write_bundle(rate_prefix, {"gen/w": np.random.default_rng(0).standard_normal(
        TF1_RATE_BYTES // 4, dtype=np.float32)})
    t0 = time.perf_counter()
    tf1_bundle.read_tf_checkpoint(rate_prefix)
    rate = TF1_RATE_BYTES / (time.perf_counter() - t0) / 1e6
    print(f"(a) the committed TensorFlow 2.21 checkpoints ({formats.get('V2', 0)} V2 bundles: "
          f"every dtype, strings, partitioned variables, two shards, a TF2 object graph; "
          f"{formats.get('V1', 0)} V1 table sets: every dtype TensorFlow's V1 reader returns, two "
          f"shards through their pattern): {n_tensors} tensors equal to the manifest's sha256, "
          f"{n_refused} that TensorFlow refuses refused alike; a flipped data byte and a flipped "
          f"index byte each refused "
          f"(CRC32C); reader {rate:.1f} MB/s on one {TF1_RATE_BYTES}-byte float32 tensor (host, "
          f"numpy CRC32C, {os.cpu_count()} CPUs)", flush=True)

    # (b) SNGAN CIFAR-10 at full width, imported by the tool's entry point
    g, d = sngan.cifar_generator(), sngan.cifar_discriminator()
    slots = {"Generator.00.W/Adam": np.zeros((3, 3, 256, 256), np.float32),
             "Generator.00.W/Adam_1": np.zeros((3, 3, 256, 256), np.float32),
             "beta1_power": np.float32(0.0), "beta2_power": np.float32(0.9),
             "global_step": np.int64(100_000)}
    prefix, named = tf1_bundle_with(os.path.join(tmp, "sngan_tf1", "model.ckpt-100000"), g, d,
                                    19, slots)
    out = os.path.join(tmp, "sngan_imported")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "gan_lib_tensorflow_tpu_torch.tools."
                          "import_tf1_checkpoint", "--ckpt", prefix, "--model", "sngan",
                          "--nchw-boundary", "--out-dir", out],
                         capture_output=True, text=True, timeout=300)
    tool_s = time.perf_counter() - t0
    check(run.returncode == 0, f"import_tf1_checkpoint exited {run.returncode}: {run.stderr[-2000:]}")
    with open(os.path.join(out, "import_report.json")) as f:
        report = json.load(f)
    unmatched = sum(len(report[n][k]) for n in ("generator", "discriminator")
                    for k in ("unmatched_target", "unmatched_tf"))
    kept = json.dumps(report)
    check(unmatched == 0 and not any(k in kept for k in slots),
          f"{unmatched} unmatched, or a slot kept: {kept[:500]}")
    n_checked = imported_equal_sources(os.path.join(out, "ckpt", "step_000000.pt"), named, True)
    print(f"(b) SNGAN CIFAR-10, full width: {len(named)} tflib variables + {len(slots)} slots "
          f"dropped, imported by `python -m ...import_tf1_checkpoint --model sngan "
          f"--nchw-boundary` in {tool_s:.2f} s (its process start included): 0 unmatched, "
          f"{n_checked} tensors equal to their sources (G's dense columns permuted), EMA = G; "
          + " ".join(line for line in run.stdout.splitlines() if line.startswith("read")),
          flush=True)
    grid = os.path.join(tmp, "imported_grid.png")
    imgs = sample.main(["--model", "sngan", "--ckpt-dir", os.path.join(out, "ckpt"),
                        "--out", grid, "--n", "16"])
    check(tuple(imgs.shape) == (16, 32, 32, 3) and bool(torch.isfinite(imgs).all())
          and os.path.getsize(grid) > 0, "cli.sample on the imported checkpoint")
    argv = ["--data", "device-fake", "--batch-size", str(BATCH), "--n-critic", str(N_CRITIC),
            "--compute-dtype", "bf16", "--steps", str(TF1_STEPS), "--log-every", "1",
            "--sample-every", "1000", "--out-dir", out]
    try:
        train_sngan.main(argv)
    except ValueError as e:
        check("g_sched" in str(e), f"train_sngan refused the import for another reason: {e}")
    else:
        check(False, "train_sngan took up a checkpoint without its lr schedule")
    # the loop's auto-resume, with the optimizer the checkpoint was written with
    args = train_sngan.parse_args(argv)
    g = sngan.cifar_generator(compute_dtype=torch.bfloat16)
    d = sngan.cifar_discriminator(compute_dtype=torch.bfloat16)
    spec = sngan.make_sngan_spec(g, d, n_critic=N_CRITIC, ema_decay=imp.EMA_DECAY)
    state = create_state(g, d, lr=2e-4, beta1=0.0, beta2=0.9, ema_decay=imp.EMA_DECAY,
                         device="cuda")
    ckpt = CheckpointManager(os.path.join(out, "ckpt"))
    check(ckpt.restore_latest(state) is not None, "no imported checkpoint to resume")
    sigma_err = sigma_against_plain(pi, torch, d)  # the first launch's W and u
    source = common.image_source(args, BATCH, 32, 10, n_micro=spec.n_critic)
    logs = []
    pi.launches = 0  # count this path's launches only
    train_loop(state, make_train_step(spec), source,
               LoopConfig(total_steps=TF1_STEPS, log_every=1, sample_every=10 ** 6,
                          checkpoint_every=10 ** 6),
               lambda it, m: logs.append(m), ckpt=ckpt)
    torch.cuda.synchronize()
    launches = pi.launches
    ckpt.close()
    check(state.step == TF1_STEPS and launches == (N_CRITIC + 1) * TF1_STEPS
          and len(logs) == TF1_STEPS and all(math.isfinite(v) for m in logs for v in m.values()),
          f"resumed run: step {state.step}, {launches} launches, metrics {logs}")
    print(f"cli.sample: 16 samples of the imported EMA; cli.train_sngan refuses the checkpoint "
          f"(no lr schedule in it, as the reference's refuses its tool's); train_loop's own "
          f"auto-resume, which no CLI reaches, with Adam(2e-4, 0, 0.9): {TF1_STEPS} fused "
          f"steps at batch {BATCH}, {launches} power-iteration launches on the imported D, its first sigma against "
          f"the plain version max abs err {sigma_err:.3e} (rtol 1e-4); metrics {logs[-1]}  "
          f"[{card}]", flush=True)
    del state, g, d

    # (c) SNGAN-projection ImageNet-128 at full width: the largest bundle
    g, d = sngan.imagenet128_generator(), sngan.imagenet128_discriminator()
    t0 = time.perf_counter()
    prefix, named = tf1_bundle_with(os.path.join(tmp, "imagenet_tf1", "model.ckpt"), g, d, 23)
    write_s = time.perf_counter() - t0
    n_bytes = os.path.getsize(prefix + ".data-00000-of-00001")
    del g, d
    t0 = time.perf_counter()
    tf1_bundle.read_tf_checkpoint(prefix)
    read_s = time.perf_counter() - t0
    out = os.path.join(tmp, "imagenet_imported")
    t0 = time.perf_counter()
    check(imp.main(["--ckpt", prefix, "--model", "imagenet", "--out-dir", out]) == 0,
          "the ImageNet-128 import failed")
    tool_s = time.perf_counter() - t0
    ckpt_file = os.path.join(out, "ckpt", "step_000000.pt")
    n_checked = imported_equal_sources(ckpt_file, named, False)
    d = sngan.imagenet128_discriminator()
    d.load_state_dict(torch.load(ckpt_file, map_location="cpu", weights_only=True)["d"])
    d.cuda()
    sigma_err_in = sigma_against_plain(pi, torch, d)
    print(f"(c) SNGAN-projection ImageNet-128, full width, 1000 classes: {len(named)} "
          f"variables, {n_bytes} bytes written in {write_s:.2f} s; the reader alone "
          f"{read_s:.3f} s ({n_bytes / read_s / 1e6:.1f} MB/s); the whole tool in process "
          f"(read, match, build on the card, write the {os.path.getsize(ckpt_file)}-byte "
          f"step-0 checkpoint) {tool_s:.3f} s ({n_bytes / tool_s / 1e6:.1f} MB/s of bundle); "
          f"{n_checked} tensors equal to their sources; the first power-iteration launch on "
          f"the imported D's {len(d.sn_layers)} weights against the plain version max abs "
          f"err {sigma_err_in:.3e} (rtol 1e-4)  [{card}]", flush=True)
    del d

    # (d) SNGAN CIFAR-10 at full width as V1 and as V2, with kept variables
    # of other dtypes: the same step-0 checkpoint from both
    g, d = sngan.cifar_generator(), sngan.cifar_discriminator()
    named = (bundle_writer.tflib_variables(g, "Generator", 29)
             + bundle_writer.tflib_variables(d, "Discriminator", 30))
    shapes = {p: v.shape for _, p, v in named}
    rng = np.random.default_rng(31)
    d_dense = next(v.shape for n, _, v in named if n.startswith("Disc") and v.ndim == 2)
    g_last = max((p for p in shapes if p.startswith("params/conv")), key=imp._natkey)
    tensors = {n: v for n, _, v in named}
    tensors.update({  # 'Gen/' and 'Dis/' sort first in their (role, shape) groups
        "Gen/note": np.array(b"100000 steps on CIFAR-10"),
        "Gen/mask": rng.integers(0, 256, shapes[g_last]).astype(np.uint8),
        "Dis/counts": rng.integers(-32768, 32768, d_dense).astype(np.int16),
        "Generator.00.W/Adam": np.zeros(named[0][2].shape, np.float32),
        "global_step": np.int64(100_000)})
    t0 = time.perf_counter()
    sources = {"V1": bundle_writer.write_v1(os.path.join(tmp, "v1", "model.ckpt"), tensors),
               "V2": bundle_writer.write_bundle(os.path.join(tmp, "v2", "model.ckpt"), tensors)}
    write_s = time.perf_counter() - t0
    reports, ckpts, times = {}, {}, {}
    for fmt, prefix in sources.items():
        out = os.path.join(tmp, f"imported_{fmt}")
        t0 = time.perf_counter()
        check(imp.main(["--ckpt", prefix, "--model", "sngan", "--out-dir", out]) == 0,
              f"the {fmt} import failed")
        times[fmt] = time.perf_counter() - t0
        with open(os.path.join(out, "import_report.json")) as f:
            reports[fmt] = json.load(f)
        reports[fmt].pop("checkpoint")  # the path given
        with open(os.path.join(out, "ckpt", "step_000000.pt"), "rb") as f:
            ckpts[fmt] = f.read()
    matched = {m["tf"] for net in ("generator", "discriminator")
               for m in reports["V1"][net]["matched"]}
    check(reports["V1"] == reports["V2"] and {"Gen/mask", "Dis/counts"} <= matched
          and "Gen/note" in reports["V1"]["generator"]["unmatched_tf"],
          f"the V1 and V2 reports differ, or a kept variable is not where expected: {reports}")
    check(ckpts["V1"] == ckpts["V2"], "the step-0 checkpoints of the V1 and V2 imports differ")
    print(f"(d) SNGAN CIFAR-10 at full width written as V1 ({os.path.getsize(sources['V1'])} "
          f"bytes, one table file) and as V2 by the test scaffolding writer in {write_s:.2f} s, "
          f"with a string, a uint8 and an int16 variable beside the weights: imported in "
          f"{times['V1']:.2f} s and {times['V2']:.2f} s, reports equal (the uint8 and int16 "
          f"variables matched and cast to float32, the string listed), the two "
          f"{len(ckpts['V1'])}-byte step-0 checkpoints byte-equal  [{card}]", flush=True)
    return launches


def last_tools(card: str, kind: str, smi_line: str, tmp: str, run_log_dir: str) -> int:
    """Phase 20, in the temporary directory ``tmp``: the doctor, the
    synthetic pyramid and the ladder trained from it, its eval, and the
    three plots (``plot_run`` on ``run_log_dir``, phase 10's run). Returns
    the fade-in launches of its ladder."""
    import numpy as np
    import torch
    from gan_lib_tensorflow_tpu_torch.cli import evaluate, train_pggan
    from gan_lib_tensorflow_tpu_torch.data import codec, packed
    from gan_lib_tensorflow_tpu_torch.ops import fadein as fd
    from gan_lib_tensorflow_tpu_torch.tools import (figure, plot_dose_response, plot_ladder,
                                                    plot_run, prepack_synthetic)
    root = os.path.dirname(os.path.abspath(__file__))

    # (a) the doctor, every probe, in its own process
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "gan_lib_tensorflow_tpu_torch.tools.doctor"],
                          cwd=root, capture_output=True, text=True, timeout=DOCTOR_TIMEOUT)
    doctor_s = time.perf_counter() - t0
    try:
        report = json.loads(proc.stdout)
    except ValueError:
        report = None
    if proc.returncode != 0 or report is None:
        print(proc.stdout[-6000:], proc.stderr[-3000:])
    check(proc.returncode == 0 and report is not None,
          f"(a) the doctor exited {proc.returncode}: "
          f"{report and report.get('verdict')}")
    enum, launch = report["device_enumeration"]["result"], report["kernel_launch"]["result"]
    check(enum["devices"][0]["name"] == kind,
          f"(a) the doctor's card {enum['devices'][0]['name']!r}, phase 1's {kind!r}")
    check(report["power"]["result"]["line"] == smi_line,
          f"(a) the doctor's nvidia-smi line {report['power']['result']['line']!r}, "
          f"phase 1's {smi_line!r}")
    built = report["kernel_build"]["result"]
    check(all(not built[k].get("error") for k in ("power_iteration", "fadein_blend"))
          and "arch=compute_90a,code=sm_90a" in built["flags"],
          f"(a) the doctor's kernel build: {built}")
    for name in ("batched_power_iteration", "fadein_blend"):
        check(launch[name]["launches"] == 1 and not launch[name].get("error"),
              f"(a) the doctor's {name} launch: {launch[name]}")
    probes = ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in report.items()
                       if isinstance(v, dict) and "seconds" in v)
    print(f"(a) doctor: rc 0, {doctor_s:.2f} s wall ({report['seconds']:.2f} s of probes side by "
          f"side): {probes}; verdict {report['verdict']!r}; libraries "
          f"{[built[k].get('elf') for k in ('power_iteration', 'fadein_blend')]}; launches "
          f"(in its probe's process, not counted below): batched_power_iteration "
          f"{launch['batched_power_iteration']['launches']} (max abs err "
          f"{launch['batched_power_iteration']['max_abs_err']:.3e}), fadein_blend "
          f"{launch['fadein_blend']['launches']} (max abs err "
          f"{launch['fadein_blend']['max_abs_err']:.3e})  [{card}]", flush=True)

    # (b) the synthetic pyramid, byte-equal to the reference tool's, and the ladder on it
    with open(os.path.join(root, SYNTH_FIXTURE)) as f:
        fixture = json.load(f)
    store = os.path.join(tmp, "pyr128")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        prepack_synthetic.main(["--out", store] + fixture["flags"])
    made = json.loads(buf.getvalue().strip().splitlines()[-1])
    digest = packed.store_digest(store)
    check(digest == fixture["store_digest"],
          f"(b) prepack_synthetic's store {digest} is not the reference tool's "
          f"{fixture['store_digest']}")
    print(f"(b) prepack_synthetic {' '.join(fixture['flags'])}: {made['packed']} images at "
          f"{made['resolutions']} in {made['seconds']} s, {made['img_per_s']} images/s on the "
          f"card's host; store digest {digest[:16]} equal to the reference tool's", flush=True)
    run = os.path.join(tmp, "ladder128")
    n_trans = int(math.log2(SYNTH_RES // 4))
    fd.launches = 0
    t0 = time.perf_counter()
    train_pggan.main(["--data", store, "--device", "cuda", "--final-resolution", str(SYNTH_RES),
                      "--steps-per-phase", str(SYNTH_STEPS), "--log-every", "1",
                      "--ckpt-every", str(SYNTH_STEPS), "--sample-every", "1000",
                      "--out-dir", run])
    torch.cuda.synchronize()
    ladder_s, launches = time.perf_counter() - t0, fd.launches
    want = 6 * SYNTH_STEPS * n_trans + n_trans  # and one per transition phase's grid
    check(launches == want, f"(b) {launches} fade-in launches in the ladder, want {want}")
    logs = [r for d in os.listdir(run) if os.path.isdir(os.path.join(run, d))
            for r in read_log(os.path.join(run, d))]
    check(len(logs) == SYNTH_STEPS * (2 * n_trans + 1) and all(
        math.isfinite(v) for r in logs for v in r.values()), "(b) non-finite ladder metrics")
    print(f"(b) train_pggan --data <that pyramid> 4^2 -> {SYNTH_RES}^2 at full width, "
          f"{SYNTH_STEPS} steps per phase: {ladder_s:.1f} s, fade-in launches {launches} "
          f"({n_trans} transitions x {SYNTH_STEPS} steps x 6, and {n_trans} grids), every "
          f"metric finite  [{card}]", flush=True)

    # (c) the eval of its last checkpoint against the store, as the dose-response JSON
    out_json = os.path.join(run, "eval_karras_128.json")
    t0 = time.perf_counter()
    rec = evaluate.main(["--model", "pggan", "--resolution", str(SYNTH_RES), "--device", "cuda",
                         "--ckpt-dir", os.path.join(run, f"{SYNTH_RES}x{SYNTH_RES}_stabilize",
                                                    "ckpt"),
                         "--data", store, "--n-samples", str(SYNTH_EVAL_SAMPLES),
                         "--swd-samples", str(SYNTH_SWD_SAMPLES), "--out-json", out_json])
    eval_s = time.perf_counter() - t0
    keys = plot_dose_response.LEVEL_KEYS + ("ms_ssim",)
    check(all(math.isfinite(rec[k]) for k in keys) and os.path.isfile(out_json),
          f"(c) eval record {rec}")
    print(f"(c) cli.evaluate --model pggan --resolution {SYNTH_RES} on the last checkpoint "
          f"against the store: {eval_s:.1f} s, " + ", ".join(f"{k} {rec[k]:.4g}" for k in keys)
          + f" ({rec['swd_images']} SWD images per side)  [{card}]", flush=True)

    # (d) the three plots, each read back through the port's decoder
    budget = SYNTH_STEPS * 16  # images per phase: 2 steps of the ladder's batch 16 at 128^2
    plots = [
        (plot_run, [run_log_dir, "--out", os.path.join(tmp, "run.png")], plot_run.SIZE_LOSSES,
         None),
        (plot_ladder, [run, "--out", os.path.join(tmp, "ladder.png")], plot_ladder.SIZE, None),
        (plot_dose_response, ["--run", f"{run}={budget}", "--out", os.path.join(tmp, "dose.png")],
         plot_dose_response.SIZE, plot_dose_response.TITLE)]
    colours = np.array(list(figure.TAB10.values()) + [figure.BLACK], np.uint8)
    for module, argv, size, title in plots:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            check(module.main(argv) == 0, f"(d) {module.__name__} failed")
        path = argv[argv.index("--out") + 1]
        img, text = codec.decode_rgb(path), codec.png_text(path)
        check(img.shape == (*size, 3), f"(d) {path}: {img.shape}, want {size}")
        check(text.get("Title") and (title is None or text["Title"] == title),
              f"(d) {path}: title {text.get('Title')!r}")
        drawn = int((img.reshape(-1, 1, 3) == colours[None]).all(-1).any(-1).sum())
        check(drawn > 0, f"(d) {path}: no series drawn")
        print(f"(d) {module.__name__.rsplit('.', 1)[-1]}: {buf.getvalue().strip()}; decoded "
              f"{img.shape[1]}x{img.shape[0]}, {drawn} pixels in series colours, title "
              f"{text['Title']!r}, "
              f"{len(text.get('Description', '').splitlines())} panel line(s)", flush=True)
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke FAILED: CUDA is not available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from gan_lib_tensorflow_tpu_torch.cli import common, train_pggan, train_sngan
        from gan_lib_tensorflow_tpu_torch.data import codec
        from gan_lib_tensorflow_tpu_torch.models import pggan, sngan
        from gan_lib_tensorflow_tpu_torch.ops import fadein as fd
        from gan_lib_tensorflow_tpu_torch.ops import init_weights, norms
        from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi
        from gan_lib_tensorflow_tpu_torch.train import (LoopConfig,
                                                        make_train_step,
                                                        train_loop)
        from gan_lib_tensorflow_tpu_torch.train.pggan_loop import (build_phase,
                                                                   train_pggan_ladder)
        from gan_lib_tensorflow_tpu_torch.utils.profiler import StepTimer
    except ImportError as e:
        raise SystemExit("chip_smoke FAILED: run it from the repository root "
                         f"(the port's package is missing: {e})")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1 device")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    print(f"torch device: {kind} (count {torch.cuda.device_count()}), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print("allow_tf32: matmul False, cudnn False")
    print(f"nvidia-smi: {smi.splitlines()[0]}", flush=True)

    phase("2 build")
    t0 = time.perf_counter()
    libraries = [pi.library, fd.library, norms.library, codec.library, codec.webp_library]
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        for fut in [pool.submit(lib.load) for lib in libraries]:
            fut.result()
    build_s = time.perf_counter() - t0
    print(f"kernels and the image decoders build+load (nvcc x3 and the host C++ compiler x2, "
          f"in parallel): {build_s:.2f} s")
    for lib in libraries:
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {lib.name}:", line.strip())

    phase("3 power-iteration kernel vs plain")
    before = pi.launches
    err = max(compare_kernel(pi, torch, CIFAR_D_SHAPES, 0),
              compare_kernel(pi, torch, PALLAS_SHAPES, 1),
              compare_kernel(pi, torch, IMAGENET_WIDE_SHAPES, 2),
              compare_kernel(pi, torch, RAGGED_STREAMED_SHAPES, 5))
    check(pi.launches > before, "launch counter did not advance")
    g = torch.Generator(device="cuda").manual_seed(3)
    for shapes in (CIFAR_D_SHAPES, IMAGENET_WIDE_SHAPES, RAGGED_STREAMED_SHAPES):
        ws = [torch.randn(k, m, device="cuda", generator=g) for m, k in shapes]
        us = [torch.randn(1, k, device="cuda", generator=g) for _, k in shapes]
        table = pi.PowerIterationTable()
        first, second = pi.launch(ws, us, table=table), pi.launch(ws, us, table=table)
        check(all(torch.equal(x, y) for x, y in zip(first, second)),
              f"two launches on the same inputs differ at {shapes}")
        check(table.counters.tolist() == [0] * len(ws), "a streamed weight's counter is left set")
    print(f"batched_power_iteration: sigma/u'/v/grad agree at the CIFAR-D, test_pallas.py, "
          f"ImageNet-128 wide and ragged streamed shapes, max abs err {err:.3e}; two launches "
          f"bit-identical at the CIFAR-D, ImageNet-128 wide and ragged streamed shapes")

    phase("4 fade-in kernel vs plain")
    fade_err = compare_fadein(fd, torch)
    # either side of a whole number of blocks, aligned and off a 16-byte boundary
    per_block = FADEIN_BLOCK_ELEMS
    for n in (per_block - 1, per_block + 1, 3 * per_block - 1, 3 * per_block + 1, 5):
        for offset in range(4):
            a = torch.randn(n + offset, device="cuda")[offset:]
            b = torch.randn(n + offset, device="cuda")[offset:]
            check(torch.equal(fd.fadein_blend(a, b, 0.37), fd.plain_fadein_blend(a, b, 0.37)),
                  f"fade-in differs from its plain version at n {n}, offset {offset}")
    print(f"fadein_blend: outputs, gradients and double backward agree "
          f"(rtol 1e-5, atol 1e-6), max abs err {fade_err:.3e}; bit-equal at sizes around "
          f"the {per_block}-element block, aligned and unaligned")

    phase("5 SNGAN main path: fused CIFAR-10 step")
    args = train_sngan.parse_args([
        "--data", "device-fake", "--device", "cuda", "--batch-size", str(BATCH),
        "--n-critic", str(N_CRITIC), "--ema-decay", "0.9999",
        "--compute-dtype", "bf16", "--steps", str(WARM_STEPS + TIMED_STEPS)])
    g, d, spec, state = train_sngan.build(args)
    source = common.image_source(args, BATCH, 32, 10, n_micro=spec.n_critic)
    step_fn = make_train_step(spec)
    logs = []
    log_fn = lambda it, m: logs.append((it, m))
    pi.launches = norms.launches = norms.backward_launches = 0  # this path's launches only
    train_loop(state, step_fn, source, LoopConfig(WARM_STEPS, WARM_STEPS), log_fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timer = StepTimer(images_per_step=N_CRITIC * BATCH, device="cuda")
    timer.start()
    train_loop(state, step_fn, source,
               LoopConfig(WARM_STEPS + TIMED_STEPS, TIMED_STEPS), log_fn)
    timer.tick(TIMED_STEPS)
    timed = timer.stop()
    main_launches = pi.launches
    n_steps = WARM_STEPS + TIMED_STEPS
    check(main_launches == 6 * n_steps,
          f"kernel launched {main_launches} times in {n_steps} steps, want 6 per step")
    bn_main = (norms.launches - norms.backward_launches, norms.backward_launches)
    check(bn_main == (14 * n_steps, 7 * n_steps),
          f"batch-norm calls (forward, backward) {bn_main} in {n_steps} steps, want 14 and 7 "
          f"a step (G's 7 norms in the fakes' forward and the G update's)")
    print(f"metrics: {logs}")
    print(f"images/s/GPU: {timed['images_per_sec_per_card']:.1f}  "
          f"ms/step: {1e3 * timed['sec_per_step']:.2f}  "
          f"peak memory: {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB  "
          f"kernel launches: {main_launches} in {n_steps} steps (batch norm: {bn_main[0]} "
          f"forward, {bn_main[1]} backward calls)  [{smi.splitlines()[0]}]")

    # the trained networks in float32 on the card vs on the CPU (plain SN)
    d32, g32 = sngan.cifar_discriminator(), sngan.cifar_generator()
    d32.load_state_dict(d.state_dict())
    g32.load_state_dict(g.state_dict())
    gen = torch.Generator().manual_seed(0)
    z = torch.randn(4, 128, generator=gen)
    with torch.no_grad():
        imgs = g32.cuda()(z.cuda(), train=False)
        imgs_cpu = copy.deepcopy(g32).cpu()(z, train=False)
        check(tuple(imgs.shape) == (4, 32, 32, 3) and bool(torch.isfinite(imgs).all()),
              f"generator output {tuple(imgs.shape)} not finite")
        torch.testing.assert_close(imgs.cpu(), imgs_cpu, rtol=1e-3, atol=1e-3)
        logits = d32.cuda()(imgs)
        logits_cpu = copy.deepcopy(d32).cpu()(imgs_cpu)
        torch.testing.assert_close(logits.cpu(), logits_cpu, rtol=1e-3, atol=1e-3)
    print("float32 G and D on the card agree with the CPU (rtol 1e-3, atol 1e-3)")

    phase("6 PGGAN main path: ladder 4x4 -> 1024x1024")
    pg_args = train_pggan.parse_args([
        "--data", "device-fake", "--device", "cuda", "--final-resolution", "1024",
        "--steps-per-phase", str(PGGAN_STEPS_PER_PHASE), "--log-every", "1",
        "--compute-dtype", "bf16"])
    cfg = train_pggan.ladder_config(pg_args)
    cfg.out_dir = None  # no checkpoints or sample grids here: phase 9 drives those
    per_phase, pg_logs, carried = [], [], {}
    last = {}

    def phase_hook(when, res, name, st):
        if when == "start":
            if last:  # every tensor shared with the phase before, bit-exact
                now = snapshot(st)
                shared = [k for k in last if k in now and now[k].shape == last[k].shape]
                check(shared and all(torch.equal(last[k], now[k]) for k in shared),
                      f"trunk not carried bit-exact into {res}x{res} {name}")
                carried[(res, name)] = len(shared)
            last.clear()
            per_phase.append([res, name, fd.launches, pi.launches, time.perf_counter()])
        else:
            torch.cuda.synchronize()
            rec = per_phase[-1]
            rec[2], rec[3] = fd.launches - rec[2], pi.launches - rec[3]
            rec[4] = time.perf_counter() - rec[4]
            rec.append(pg_logs[-1])
            last.update(snapshot(st))

    fd.launches = 0  # count this path's launches only
    pi.launches = 0
    t0 = time.perf_counter()
    pg_state = train_pggan_ladder(cfg, train_pggan.source_factory(pg_args),
                                  phase_hook=phase_hook,
                                  log_fn=lambda it, m: pg_logs.append(m))
    torch.cuda.synchronize()
    ladder_s = time.perf_counter() - t0
    ladder_launches = fd.launches
    last.clear()
    n_trans = sum(1 for r in per_phase if r[1] == "transition")
    for res, name, n_fd, n_pi, secs, metrics in per_phase:
        want = 6 * PGGAN_STEPS_PER_PHASE if name == "transition" else 0
        print(f"  {res:4d}x{res:<4d} {name:10s} fade-in launches {n_fd:2d} (want {want}), "
              f"{secs:.2f} s, tensors carried {carried.get((res, name), 0)}, "
              + " ".join(f"{k} {v:.4g}" for k, v in metrics.items()))
        check(n_fd == want and n_pi == 0,
              f"{res}x{res} {name}: {n_fd} fade-in launches, want {want}")
    check(len(per_phase) == 17 and n_trans == 8, f"{len(per_phase)} phases, want 17")
    check(len(carried) == 16, "a migration was not checked")
    check(ladder_launches == 6 * PGGAN_STEPS_PER_PHASE * n_trans,
          f"{ladder_launches} fade-in launches in the ladder")
    check(len(pg_logs) == 17 * PGGAN_STEPS_PER_PHASE and all(
        math.isfinite(v) for m in pg_logs for v in m.values()), "non-finite ladder metrics")
    check(pg_state.step == PGGAN_STEPS_PER_PHASE and pg_state.alpha == 1.0,
          "ladder did not end in the 1024x1024 stabilize phase")
    print(f"ladder: {len(per_phase)} phases in {ladder_s:.1f} s, fade-in launches "
          f"{ladder_launches} ({n_trans} transitions x {PGGAN_STEPS_PER_PHASE} steps x 6)")
    del pg_state

    phase("7 PGGAN 1024x1024 transition phase, batch 4")
    ph = build_phase(cfg, 1024, "transition")
    pg_source = iter(train_pggan.source_factory(pg_args)(1024, ph.batch))
    pg_step = make_train_step(ph.spec)
    for i in range(PGGAN_WARM):
        ph.state.alpha = ph.alpha_fn(i)
        pg_step(ph.state, next(pg_source))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timer = StepTimer(images_per_step=ph.batch, device="cuda")
    timer.start()
    for i in range(PGGAN_WARM, PGGAN_WARM + PGGAN_TIMED):
        ph.state.alpha = ph.alpha_fn(i)
        pg_metrics = pg_step(ph.state, next(pg_source))
        timer.tick()
    timed = timer.stop()
    pg_dt = timed["sec_per_step"]
    check(all(math.isfinite(float(v)) for v in pg_metrics.values()), "non-finite 1024 metrics")
    print(f"PGGAN 1024x1024 transition batch {ph.batch}: images/s/GPU "
          f"{timed['images_per_sec_per_card']:.2f}  ms/step: {1e3 * pg_dt:.2f}  peak memory: "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB  "
          f"[{smi.splitlines()[0]}]")
    del ph, pg_step, pg_source

    # full-width float32 G and D of the 64x64 transition stage, card vs CPU
    g64 = pggan.PGGANGenerator(resolution=64, fade_in=True)
    d64 = pggan.PGGANDiscriminator(resolution=64, fade_in=True, fused_from=128)
    gen = torch.Generator().manual_seed(3)
    for net in (g64, d64):
        init_weights(net, gen)
    z = torch.randn(4, 512, generator=gen)
    with torch.no_grad():
        imgs_cpu = g64(z, 0.37)
        logits_cpu = d64(imgs_cpu, 0.37)
        before = fd.launches
        imgs = g64.cuda()(z.cuda(), 0.37)
        logits = d64.cuda()(imgs, 0.37)
    check(fd.launches == before + 2, "the 64x64 stage did not launch the fade-in kernel")
    check(tuple(imgs.shape) == (4, 64, 64, 3) and bool(torch.isfinite(imgs).all()),
          f"PGGAN generator output {tuple(imgs.shape)} not finite")
    torch.testing.assert_close(imgs.cpu(), imgs_cpu, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(logits.cpu(), logits_cpu, rtol=1e-3, atol=1e-3)
    print("float32 PGGAN 64x64 transition G and D on the card agree with the CPU "
          "(rtol 1e-3, atol 1e-3)")
    del g64, d64

    phase("8 kernel timing at the main paths' shapes")
    clocks = "clocks.sm,clocks.mem,power.limit"
    print(f"nvidia-smi {clocks} before: {nvidia_smi(clocks)}", flush=True)
    card = smi.splitlines()[0]
    ws = [m.weight.detach() for m in d.sn_layers]
    us = [m.u.detach().clone() for m in d.sn_layers]
    table = pi.PowerIterationTable()
    pi_times = timed_in_turns({
        "kernel": lambda: pi.launch(ws, us, table=table),
        "plain": lambda: pi.plain_power_iteration(ws, us)}, 200)
    kernel_ms, plain_ms = pi_times["kernel"], pi_times["plain"]
    # an empty kernel with the same grid, cluster and shared memory: the floor
    # of the clustered launch (the first kernel's package, which A/B runs
    # time with this script, has no such path)
    floor = (f"{1e3 * device_ms(lambda: pi.launch_empty(table), 200):.2f} us"
             if hasattr(pi, "launch_empty") else "not in this package")
    pi_host = host_us(lambda: pi.launch(ws, us, table=table), 500)
    ms_, ks = [w[0].numel() for w in ws], [w.shape[0] for w in ws]
    n_bytes = 4 * (sum(m * k for m, k in zip(ms_, ks))      # W
                   + sum(ks) + len(ws) + sum(ks) + sum(ms_))  # u in; sigma, u', v out
    n_flops = sum(4 * m * k for m, k in zip(ms_, ks))
    bound_ms = 1e3 * max(n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_FP32_FLOPS)
    bound_by = "bytes" if n_bytes / PEAK_BYTES_PER_S >= n_flops / PEAK_FP32_FLOPS else "operations"
    print(f"batched_power_iteration: kernel {1e3 * kernel_ms:.2f} us, plain "
          f"{1e3 * plain_ms:.2f} us, empty-kernel floor {floor}, bound "
          f"{1e3 * bound_ms:.3f} us ({bound_by}: {n_bytes} B, {n_flops} flop), "
          f"library_ms: none, host {pi_host:.1f} us per wrapper call  [{card}]")

    # fade-in: the step's two blends; the bound counts a and b read once and
    # out written once, 12 bytes per element; 3 flops per element are far
    # below the fp32 rate
    cl = torch.channels_last
    fade = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for shape in FADEIN_MAIN_SHAPES:
        a = torch.randn(shape, device="cuda").contiguous(memory_format=cl)
        b = torch.randn(shape, device="cuda").contiguous(memory_format=cl)
        n = a.numel()
        t = timed_in_turns({"kernel": lambda: fd.launch(a, b, 0.37),
                            "lerp": lambda: torch.lerp(b, a, 0.37),
                            "plain": lambda: fd.plain_fadein_blend(a, b, 0.37)}, 20)
        k_ms, p_ms, l_ms = t["kernel"], t["plain"], t["lerp"]
        f_host = host_us(lambda: fd.launch(a, b, 0.37), 100)
        n_bytes, n_flops = 12 * n, 3 * n
        b_ms = 1e3 * max(n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_FP32_FLOPS)
        print(f"fadein_blend {list(shape)} channels-last: kernel {1e3 * k_ms:.2f} us, plain "
              f"{1e3 * p_ms:.2f} us, torch.lerp {1e3 * l_ms:.2f} us, bound "
              f"{1e3 * b_ms:.2f} us (bytes: {n_bytes} B, {n_flops} flop), "
              f"{n_bytes / k_ms / 1e9:.3f} TB/s, host {f_host:.1f} us per wrapper call  [{card}]")
        for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms),
                       ("bound_ms", b_ms)):
            fade[key] += v / len(FADEIN_MAIN_SHAPES)
        del a, b
    print(f"fadein_blend: one 1024x1024 transition step launches it 6 times "
          f"(G 2 at {list(FADEIN_MAIN_SHAPES[0])}, D 4 at {list(FADEIN_MAIN_SHAPES[1])}); "
          f"the JSON line gives the mean of one launch at each shape")
    print(f"nvidia-smi {clocks} after: {nvidia_smi(clocks)}", flush=True)

    phase("9 checkpoint, resume, sample, eval on the card")
    t9 = time.perf_counter()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        checkpoint_resume_eval(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.backends.cudnn.deterministic = False
    print(f"phase 9: {time.perf_counter() - t9:.1f} s  [{card}]")

    phase("10 data layer and north star: CIFAR-10 held on the card")
    t10 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    kept = tempfile.mkdtemp(prefix="chip_smoke_run_")  # its SNGAN log, for phase 20's plot
    try:
        data_layer_and_north_star(card, tmp)
        shutil.copy(os.path.join(tmp, "sngan_cifar", "log.jsonl"), kept)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 10: {time.perf_counter() - t10:.1f} s  [{card}]")

    phase("11 SNGAN-projection ImageNet-128 at full width")
    t11 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        bn_imagenet = imagenet128(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 11: {time.perf_counter() - t11:.1f} s  [{card}]")

    phase("12 ACGAN and the conditional CIFAR SNGAN at full width")
    t12 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        cond_launches = acgan_and_conditional_sngan(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 12: {time.perf_counter() - t12:.1f} s  [{card}]")

    phase("13 pix2pix at full width: U-Net 256x256 + 30x30 PatchGAN, paired store on the card")
    t13 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        pix2pix_full_width(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 13: {time.perf_counter() - t13:.1f} s  [{card}]")

    phase("14 PGGAN to the end: pyramid store, ladder, SWD/MS-SSIM eval, export, remat")
    t14 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        pyramid_launches = pggan_to_the_end(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 14: {time.perf_counter() - t14:.1f} s  [{card}]")

    phase("15 multi-rank: torch.distributed.run on this card (DP, DP x TP, NCCL, trace, NaNs)")
    t15 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        mr_pi, mr_fd, _ = multi_rank(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 15: {time.perf_counter() - t15:.1f} s  [{card}]")

    phase("16 spatial partitioning and the space-to-depth top level ('sp' ranks on this card)")
    t16 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        sp_fd, _ = spatial_partitioning(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 16: {time.perf_counter() - t16:.1f} s  [{card}]")

    phase("17 the tools: benches, FLOP calibration, InceptionV3 convert, npz prepack, --data words")
    t17 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        tools_pi = tools_on_the_card(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 17: {time.perf_counter() - t17:.1f} s  [{card}]")

    phase("18 image folders: the hand-written decoder, and each family trained from a folder")
    t18 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        folder_pi, folder_fd = image_folders(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 18: {time.perf_counter() - t18:.1f} s  [{card}]")

    phase("19 TF1 checkpoints on the card without TensorFlow: the bundle reader and the importer")
    t19 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        tf1_pi = tf1_checkpoints(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 19: {time.perf_counter() - t19:.1f} s  [{card}]")

    phase("20 the last tools on the card: doctor, synthetic pyramid, its ladder and eval, plots")
    t20 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        synth_fd = last_tools(card, kind, card, tmp, kept)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(kept, ignore_errors=True)
    print(f"phase 20: {time.perf_counter() - t20:.1f} s  [{card}]")

    phase("21 batch-norm kernels at the ImageNet-128 G's shapes")
    bn_rec = batch_norm_timing(card)
    ends = sorted(PHASE_STARTS.items()) + [(None, time.perf_counter())]
    print("phase seconds: " + ", ".join(f"{n} {t1 - t0:.1f}" for (n, t0), (_, t1)
                                        in zip(ends, ends[1:]))
          + f"; total {ends[-1][1] - ends[0][1]:.1f} s  [{card}]", flush=True)

    print(json.dumps({"kernels": [{
        "name": "batched_power_iteration",
        "route": "cuda",
        "source": "gan_lib_tensorflow_tpu_torch/csrc/power_iteration.cu",
        "replaces": "gan_lib_tensorflow_tpu/ops/pallas_kernels.py:63",
        "launches": main_launches + cond_launches + mr_pi + tools_pi + folder_pi + tf1_pi,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "fadein_blend",
        "route": "cuda",
        "source": "gan_lib_tensorflow_tpu_torch/csrc/fadein_blend.cu",
        "replaces": "gan_lib_tensorflow_tpu/ops/pallas_kernels.py:122",
        "launches": ladder_launches + pyramid_launches + mr_fd + sp_fd + folder_fd + synth_fd,
        "max_abs_err": fade_err,
        "ms": fade["ms"],
        "plain_ms": fade["plain_ms"],
        "bound_ms": fade["bound_ms"],
        "bound_by": "bytes",
        "library_ms": fade["library_ms"],
    }, {
        "name": "batch_norm",
        "route": "cuda",
        "source": "gan_lib_tensorflow_tpu_torch/csrc/batch_norm.cu",
        "replaces": None,
        "launches": sum(bn_main) + bn_imagenet,
        "max_abs_err": bn_rec["max_abs_err"],
        "ms": bn_rec["ms"],
        "plain_ms": bn_rec["plain_ms"],
        "bound_ms": bn_rec["bound_ms"],
        "bound_by": "bytes",
        "library_ms": bn_rec["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sp-run"]:
        sp_step_run(sys.argv[2], int(sys.argv[3]), sys.argv[4:])
    elif sys.argv[1:2] == ["--rank-run"]:
        rank_run(sys.argv[2])
    else:
        main()
