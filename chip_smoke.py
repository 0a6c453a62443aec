#!/usr/bin/env python3
"""Drive the PyTorch port (multiple_objects_gan_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root, on a machine with a CUDA card, nvcc and the
checkpoint runs_r5/mnist_repin/netG_final.pth. Phases 1-15 drive the
Multi-MNIST paths, 16-20 the CLEVR and COCO-StackGAN-1 families at the
widths of cfg/clevr_train.yml and cfg/coco_s1_train.yml, from seeded
weights, 21-24 the host side of stage 1: data on disk, checkpoints
and resume, and sampling, and 25-29 COCO StackGAN stage 2 at the widths
of cfg/coco_s2_train.yml, from seeded weights, 30-32 serve the trained
COCO AttnGAN (runs_r5/attngan_flagship: netG_ema_final.pth and
damsm/DAMSMencoders/text_encoder29.pth), 33-36 train it at the widths
of cfg/coco_attn_train.yml from the flagship's EMA G, its DAMSM encoders
(image_encoder29.pth too) and seeded Ds, 37-39 pretrain the DAMSM
encoders at cfg/coco_damsm.yml's widths, 40 runs AttnGAN's eval modes
sample and gen_example from the flagship files, 41-43 read COCO from
disk: the JPEG codecs, both StackGAN stages, AttnGAN and DAMSM trained
from disk, and stage-2 sampling, and 44-46 evaluate: the FID encoders,
AttnGAN's sampling dump with FID and IS, the layout-fidelity tool and a
--profile trace, and 47-49 scale out: the train entry as world size 1
over NCCL, the mnist, AttnGAN and DAMSM steps as two processes of one
process group (parallel/, tools/dist_steps.py) against one process, and
AttnGAN's sampling dump sharded over two processes, 50 runs the tools:
validate_learning (whether a run learns), export_checkpoint,
check_dataset, parity_harness and the general STN, 51 the last train
and serve options: MOG_REMAT, BatchNorm groups that span ranks and the
server's --max_batch, and 52 the bench tools (bench_variants,
bench_sampling) and the MOG_COMPUTE_DTYPE / MOG_BN_GROUPS knobs. Every
COCO entry reads its JPEGs from disk (nvjpeg on the card). The train
entries' data and runs go to a temporary directory, removed at the end.
Phases, each logged with the elapsed time:

  1. device   - the card's name and power limit, torch and CUDA versions;
  2. build    - nvcc builds csrc/stn_place.cu and csrc/normconv.cu for
                sm_90a, one nvcc for each, started together; one ptxas
                line a kernel (registers, shared memory, spills);
  3. kernel   - the STN place kernel (K1) against its plain PyTorch version
                on the card, at the served generator's shape, at the G and
                D shapes of the train step and at edge cases (padded,
                off-canvas and wider-than-canvas boxes, 37 channels, sides
                32 and 64, a side of 65 refused), timed cold in turns with
                the plain version (plain, K1, K1, plain, on a rotation of
                input copies larger than twice the L2) beside the bound;
  4. model    - the full-width trained Stage1G on the card against the port
                on the CPU, batch 64, and its forward time on the card;
  5. serve    - the port's HTTP server on the card: concurrent /generate
                requests, a 64-item request, /stats, and the proof that the
                served batches went through K1 (its launch count);
  6. grad     - the place backward (K2) against its plain version on the
                card, at the G and D shapes of the train step and at edge
                cases, timed cold in turns with the plain version (as K1
                in phase 3) and warm (one set of buffers) beside the bound
                and the rate it implies;
  7. autograd - gradients through StnPlaceMulti (K3) on the card against
                the CPU, and a train-mode Stage1G's object-pathway gradient
                on the card against the CPU;
  8. step     - one full-width train step (batch 128) on the card against
                the same step on the CPU, from the reference init and from
                the weights tests/test_step_parity.py draws: losses,
                BatchNorm statistics and per-tensor gradient cosines held,
                the Adam deltas read;
  9. steptime - the train step's time on the card at batch 128, and its K1
                and K2 launches per step;
 10. train    - the port's train entry (cli/main.py) for one synthetic
                epoch on the card, and the proof that it went through K1
                and K2 (their launch counts) and not K4;
 11. normconv - K4's path, the port's spike tool (tools/spike_normconv.py:
                its check, then its bench at the three hot shapes), with
                its launches; then K4 against its plain version, twice for
                bit-identical sums, at the two check shapes, the three hot
                shapes, five edge shapes of its tiling and a zero-gamma
                channel; then K4 timed in turns with the plain chain and
                cuDNN's bf16 F.conv2d at the hot shapes (TFLOP/s, share of
                the bound);
 12. bf16     - K1 and K2 in bf16 against their plain versions at the G
                and D train shapes and the serve shape, with padded boxes,
                boxes off the canvas and wider than it, and at K1's tile
                edges (37 channels, sides 32 and 64; 65 refused), timed
                cold in turns (as in phases 3 and 6);
 13. step16   - one bf16 train step, full width, on the card against the
                same step on the CPU: losses, BatchNorm statistics and
                per-tensor gradient cosines held;
 14. time16   - the bf16 train step's time at batch 128 beside phase 9's
                float32 time, and its K1 and K2 launches per step;
 15. entry16  - the train entry for one epoch with --bf16 and one with
                --bn_groups 2, and one 64-item request served with --bf16
                against the card's float32 image of it;
 16. families - K1 and K2 against their plain versions, float32 and bf16,
                at the families' G and D shapes (clevr (128,4,192,16x16),
                (128,4,96,15x15); coco (128,3,384,16x16), (128,3,192,15x15))
                on their train boxes, with a padded fourth object (K1 equal
                bit for bit to the first three alone, K2 zeros), boxes
                off the canvas, and K1 at the service's batch of 64 with
                its boxes; their shared memory at four objects; each
                train shape timed cold in turns and on the device alone
                (time_place, time_grad);
 17. fstep    - one full-width float32 train step of each family on the
                card against the same step on the CPU (FAMILY_STEP_BATCH),
                held at phase 8's limits, kl_loss included for coco;
 18. ftime    - each family's train step at batch 128, float32 and bf16:
                median of FAMILY_TIME_RUNS CUDA-event readings, peak
                memory, K1 and K2 launches per step;
 19. fentry   - the train entry for one synthetic epoch of clevr (float32)
                and of coco-stackgan-1 (--bf16, its JPEGs from disk), with
                K1, K2 and K4 launches;
 20. fserve   - each family's Stage1G card against CPU at batch 64, and its
                service over HTTP on the card (clevr: four two-hot objects;
                coco: text embeddings), the served PNGs against the CPU
                generator's images of the same items and z, and a bad item
                answered 400;
 21. probe    - read only: whether this machine has jpeglib.h and png.h on
                the C compiler's include path, libjpeg and libpng shared
                objects (native/loader.cpp's needs) and nvjpeg under the
                CUDA toolkit, printed as one JSON line;
 22. disk     - the reader's decode times; the train entry from disk
                (--synthetic writes the set, then reads it back): clevr for
                one epoch with its flips, and its set held on the card for
                two; mnist for 2 epochs, resumed in place to 3, two
                straight 3-epoch runs, two resumes from the first straight
                run's epoch-1 checkpoint (one held against it: the first
                step of the resumed epoch, where both runs hold the same
                bits, and the parameters after it), and the same resume
                without the generator's state, and without the Adam
                states, each of which must stray; the card's drift between
                runs from one state, printed; every artifact of a run; the
                same set in memory;
                a full-width checkpoint saved and restored, timed;
 23. batch9   - K1 at the sampler's batch of 9 (one layout, 9 z) against
                its plain version, f32 and bf16, padded objects too, timed;
 24. sample   - cli/main.py with TRAIN.FLAG False: 25 grids from the
                trained mnist .pth on a synthetic test split, and 25 from
                phase 22's clevr run directory, timed; the first grid of
                each against the CPU's from the same weights;
 25. s2kernels - K1 and K2 at the stage-2 places, batch 40, float32 and
                bf16: G2's (40,3,192,64,64) onto 64x64 (channel tiles of 1)
                and D2's (40,3,192,30,30) onto 32x32 (K1's tile 4), boxes
                inside the canvas with the last object padded (K1 equal bit
                for bit to the other objects alone, K2 zeros for it), held
                against the plain versions and timed cold in turns and on
                the device alone beside the bound;
 26. s2step   - one full-width float32 stage-2 step (frozen G1, G2, D2)
                from the reference init on the card against the same step
                on the CPU at batch S2_STEP_BATCH: from fresh Adams read,
                and from warm Adams (an update linear in the gradient)
                held at phase 8's limits; the frozen G1 bit-identical
                after every one;
 27. s2time   - the stage-2 step at batch 40, float32 and bf16: median of
                CUDA events, images/s, peak memory, K1 and K2 launches a
                step (5 and 4), the frozen G1's share;
 28. s2entry  - cli/main.py --variant coco-stackgan-2 --synthetic for one
                epoch on the card from disk, STAGE1_G a reference-format
                .pth the phase writes, its artifacts, and a resume to epoch
                2 (the run is kept for phase 43);
 29. s2serve  - G1 + G2 eval card against CPU at batch 4, and
                Stage2Service over HTTP: 256px PNGs against the CPU's
                images of the same items and draws, a bboxes_s2 override,
                a length mismatch answered 400, then a 1-item request;
 30. attnkernels - K1 at AttnGAN's object pathway, (64,3,192,16,16) onto
                16x16 (the service's batch) and at batch 1, float32 and
                bf16, on service-style boxes with the third object padded
                (equal bit for bit to the other two alone), held against
                its plain version, timed cold in turns and on the device
                alone beside the bound;
 31. attnmodel - the flagship's vocabulary rebuilt by
                write_synthetic_attngan(n=2048, seed=7) (140 words, the
                encoder's rows); the trained G (GF 48, ngf 768) and text
                encoder card against CPU at batch 4 (word and sentence
                embeddings, the 64/128/256px images, both attention maps);
                GFLOP an image by stage (torch.utils.flop_counter); the
                text encoder + G forward at batch 64 in float32 and bf16
                (median of CUDA events, images/s, peak memory, K1 launches
                a forward) and its device time by kernel group
                (torch.profiler, tools/profile_step.py's groups);
 32. attnserve - cli/serve.py --variant coco-attngan on the card from a
                copy of the flagship's sampling cfg naming the two files
                and phase 31's set: 8 concurrent requests and a 64-item
                one (an OOV-mixed and an all-OOV caption among them), the
                first 8 served PNGs against the CPU nets' images of the
                same items and z, a bad label and a non-string caption
                answered 400, /stats's K1 launches, and the served images'
                in-box/out-of-box separation, printed beside the
                flagship's 0.987;
 33. attnplaces - K1 and K2 at AttnGAN's train places, batch 14, float32
                and bf16: G's object pathway (14,3,192,16,16) onto 16x16
                and D64's (14,3,192,15,15) onto 16x16, boxes inside the
                canvas with the last object padded (K1 equal bit for bit
                to the other objects alone, K2 zeros for it), held against
                the plain versions, timed cold in turns and on the device
                alone beside the bound;
 34. attnstep - image_encoder29.pth card against CPU at batch 2 from
                256px (regions, codes); one full-width AttnGAN step (G the
                flagship EMA G, seeded Ds, the flagship encoders, batch 4
                of the flagship set's test split) on the card against the
                same step on the CPU from warm Adams: losses, BatchNorm
                statistics and per-tensor gradient cosines of G and the
                three Ds held, the Adam deltas read, the EMA held to
                0.999 ema + 0.001 param;
 35. attntime - the step at batch 14, float32 and bf16: median of CUDA
                events, images/s, peak memory, K1 and K2 launches a step (4
                and 4), GFLOP a step (torch.utils.flop_counter) and the
                device's time by kernel group (torch.profiler);
 36. attnentry - cli/main.py --variant coco-attngan --synthetic (JPEGs on
                disk) from a
                copy of coco_attn_full.yml (the flagship EMA G as NET_G,
                B_NET_D False, the flagship NET_E): 3 epochs with their
                montages, grids, run_flags.json provenance and
                checkpoints; a resume from its epoch-1 checkpoint to epoch
                3 held against it (the resumed epoch's first step, then
                the parameters); one epoch with --bf16; K1/K2 launches;
 37. damsmstep - one DAMSM step (text_encoder29.pth, image_encoder29.pth,
                batch 4 of the flagship set's test split, 256px, an
                injected dropout mask) on the card against the same step
                on the CPU from warm Adams, with the clip of 0.25 biting
                and a clip of 1e6 that does not: losses and the norm
                before the clip, per-tensor update cosines, the frozen
                backbone bit-identical;
 38. damsmtime - the DAMSM step at batch 48, float32 and bf16: median of
                CUDA events, images/s, peak memory, GFLOP a step
                (torch.utils.flop_counter) and the device's busy share and
                kernel groups (torch.profiler);
 39. damsmentry - cli/main.py --variant damsm --cfg cfg/coco_damsm.yml
                --synthetic on a set of 192 items on disk (a test split of
                48, so
                the eval runs): 3 epochs with their .pth pairs, eval
                records and checkpoints; a resume from the epoch-1
                checkpoint held against it; one epoch with --bf16; no K1
                or K2 launch; the exported pair loaded as AttnGAN's NET_E
                through cli/attngan_runner.py:init_encoders and one
                full-width AttnGAN train step from it;
 40. attneval - cli/main.py --variant coco-attngan with TRAIN.FLAG False
                from a copy of coco_attn_sampling.yml naming the flagship
                files: sample (25 rows of 10 tiles, one K1 launch a row)
                and --eval_mode gen_example (8 captions, one K1 launch);
                the first row again card against CPU at its z and against
                the entry's PNG; K1 at the sampler's (9,3,192,16²) with the
                third object padded and gen_example's (8,3,192,16²) held
                against its plain version, timed cold in turns and on the
                device alone beside the bound;
 41. jpeg     - the writers' images (96x96, 268x268, gray, 4:4:4, 4:2:2,
                odd sizes): nvjpeg's decode against the numpy decoder (max
                and mean levels, and against chroma replicated), the same
                pixels on an idle card and behind a queue of work, the round
                trip through both encoders, a truncated and a progressive
                file raising on the card and the CPU, a garbled scan, and
                the decode ms an image at batch 128 of 96x96 and 14 of
                268x268 with the PIL-exact resize on the card and the host;
 42. cocodisk - both StackGAN stages, AttnGAN and DAMSM at full width, one
                epoch each from disk (nvjpeg in the Loader's thread) in
                turns with the same epoch held on the card, host clock; the
                card reader's boxes, labels, captions and embeddings equal
                to the numpy path's from the same seed, its images within
                the nvjpeg bound; K1/K2 launches an epoch;
 43. s2sample - cli/main.py --variant coco-stackgan-2 with TRAIN.FLAG False
                from phase 28's run directory: the val_captions.t7 branch
                and the test-split branch, 25 grids each, timed, two K1
                launches a grid; the first grid's fakes card against CPU
                and against the entry's PNG; K1 at the sampler's
                (9,3,384,16²) -> 16² and (9,3,192,64²) -> 64² held and
                timed cold in turns and on the device alone;
 44. fid      - the canonical FID Inception (nn/fid_inception.py, seeded
                weights) and the flagship DAMSM image encoder's 2048 pooled
                features at batch 14 of the test split's 256px images, card
                against CPU relative to their largest, and again with TF32
                turned on around the call (a --bf16 process's settings:
                still float32, the flags restored); Inception ms an image
                at batch 32 (CUDA events); scipy's version;
 45. sampling - cli/main.py --variant coco-attngan --eval_mode sampling
                --num_images 56 from the flagship's EMA G and DAMSM pair:
                56 PNGs, eval_metrics.json's seven keys and provenance
                (damsm, imported, random), one K1 a batch; the entry's
                wall time with its feature sweeps and host FID apart; FID
                and IS printed beside JAX's record; the first batch's
                features card against CPU and its first PNG against the
                card's image; K1 at the dump's (14,3,192,16²) held and
                timed;
 46. layout   - tools/eval_layout_fidelity.py at n 128 for mnist
                (runs_r5/mnist_repin/netG_final.pth) and clevr (phase 22's
                run), the score on the card equal to the CPU's on the same
                images and classifier, one K1 a batch, K1 at the tool's
                shapes held and timed; one mnist train entry with --profile
                whose trace names K1's and K2's kernels;
 47. nccl1    - cli/main.py --variant multi-mnist --synthetic for one
                epoch in a process of its own with MOG_COORDINATOR,
                MOG_NUM_PROCESSES=1 and MOG_PROCESS_ID=0 (world size 1 over
                NCCL), and the same in another without them,
                cudnn.deterministic in both: the logged losses and the
                checkpoint equal bit for bit;
 48. dist2    - two processes of one group (NCCL where the machine has
                two cards, else gloo on CUDA tensors: NCCL takes one rank
                a card), started once, run the full-width mnist step
                (GF 128 / DF 64, global batch 128), the AttnGAN step
                (GF 48 / DF 96, global batch 14) and the DAMSM step
                (global batch 48), each from warm Adams, against one
                process running the same global batch: losses, BatchNorm
                running statistics and per-tensor update cosines held, the
                replicas equal bit for bit, K1 and K2 launches a rank; the
                steps' times at both world sizes and the gradient
                all-reduce's; K1 and K2 at a rank's place shapes held and
                timed; the same start runs phase 49's dump and phase 51's
                --bn_groups 3 step;
 49. dump2    - phase 45's sampling dump (56 images) as two processes: the
                same PNG names, pixels within 1 level, FID and IS beside
                phase 45's, one K1 a batch on each rank;
 50. validate - tools/validate_learning.py at 6 epochs in 2 segments
                (its default 20; bf16, its default) for mnist (n 5120)
                and clevr (n 2560), each in a process of its own while
                the wiring runs go on here, held: the FID trend falls,
                separation >= 0.15, mnist layout-fidelity recall >= 0.2;
                mnist's final G exported
                by tools/export_checkpoint.py and loaded as a strict
                reference NET_G, its images equal bit for bit to the run's
                G's; the wiring of coco-stackgan-2 (2 epochs, n 64,
                --export_pth: the STAGE1_G-embedded .pth loads strictly)
                and coco-attngan (DAMSM 1 epoch, 2 epochs, n 64, the
                sampling dump, --export_pth; the Ds exported with --out_d
                load strictly), every number finite; K1/K2 launches of
                each train entry and generation; tools/check_dataset.py
                on the sets written (ok) and on a truncated JPEG and a
                missing pickle (both named); tools/parity_harness.py on
                the AttnGAN export (not comparable, FID finite); the
                general STN on the card against stn_separable and the
                CPU; K1 at the tool's generation places (32,3,256,16²)
                and (32,4,192,16²) -> 16², f32 and bf16, held and timed;
 51. options  - the train and serve options added last: the mnist f32
                step (batch 128, warm Adams, one z) under each MOG_REMAT
                mode (0, full, convs, dots) held against mode 0 under
                cudnn.deterministic (mode 0 twice at the default
                algorithms read for their spread) (losses
                1e-5 of the loss, running statistics 1e-6 and
                num_batches_tracked equal, per-tensor update cosines
                >= 0.99999), its ms (CUDA events, median of 5), peak
                memory and K1/K2 launches (8 and 4 under recompute, 4 and
                4 at mode 0); peak memory and ms at 0 and full of the
                stage-2 f32 step (batch 40) and the AttnGAN f32 step
                (batch 14); the mnist step at --bn_groups 3 of a global
                batch of 96 as two ranks (phase 48's; a group spans them)
                against one
                process, at phase 48's limits; the trained mnist G served
                at --max_batch 8 and 128 (/healthz, a full request in one
                device batch, one item more refused with a 400) and K1 at
                (8,3,256,16²) and (128,3,256,16²) -> 16² held and timed.
 52. bench    - the port's bench tools in this process at full width and
                the reference batches, bf16 (their default):
                tools/bench_variants.py (mnist, clevr, stackgan1 at 128,
                stage 2 at 40, AttnGAN at 14) and tools/bench_sampling.py
                (the three families at 128, attngan256 at 32), each line
                printed, with the JAX tools' keys, img_per_sec = batch /
                ms to rounding, 0 < mfu <= 1.05 and hbm_util > 0, and
                K1/K2 launches of every step (4/4, stage 2 5/4, AttnGAN
                4/4) and batch (1/0); K1 at attngan256's (32,3,192,16²)
                -> 16² held and timed; the mnist bf16 step whose config
                the train entry parses under MOG_COMPUTE_DTYPE=bfloat16
                and MOG_BN_GROUPS=2 (no flags) equal bit for bit to the
                --bf16 --bn_groups 2 step under cudnn.deterministic, the
                environment restored after.

Every phase runs under a watchdog (``timed``): past max(120 s, twice its
PHASE_BUDGET_S reading) the script prints every thread's stack to stderr,
kills the processes it started and exits 70 naming the phase.

After the phases come three lines: {"kernel_details": ...} (every
kernel reading), {"summary": ...} (under 4 KB: the step medians of every
path, decode and from-disk epoch times, the eval phases' numbers, each
phase's wall time) and
{"kernels": [...]}, the line before the last; the last is
{"ok": true, "device": {...}}. Any failed check raises, and the script
exits non-zero; without a card it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import base64
import concurrent.futures
import contextlib
import copy
import dataclasses
import faulthandler
import glob
import http.client
import io
import json
import math
import os
import shutil
import signal
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np
import torch

from multiple_objects_gan_tpu_torch import float32_pinned
from multiple_objects_gan_tpu_torch import ops as port_ops
from multiple_objects_gan_tpu_torch.cli import attngan_runner
from multiple_objects_gan_tpu_torch.cli import main as train_main
from multiple_objects_gan_tpu_torch.cli.sample import (
    _draw_white_bbox_edges, load_generator, sample_noise, sample_stage1)
from multiple_objects_gan_tpu_torch.cli.serve import (
    Stage1Service, Stage2Service, _item_boxes_s2, _item_layout, _png_b64,
    attngan_images, build_service, parse_args as serve_parse_args, serve)
from multiple_objects_gan_tpu_torch.cli.stage2_runner import stage2_images
from multiple_objects_gan_tpu_torch.config.config import (
    attngan_model_config, attngan_train_settings, cfg_from_file,
    stage1_model_config, stage2_model_config, train_settings)
from multiple_objects_gan_tpu_torch.cli.stage2_runner import (
    sample_inputs, sampling_generators)
from multiple_objects_gan_tpu_torch.data import attngan as attn_data
from multiple_objects_gan_tpu_torch.data import coco as coco_data
from multiple_objects_gan_tpu_torch.data import jpeg, nvjpeg
from multiple_objects_gan_tpu_torch.data.attngan import (
    AttnGanDataset, AttnGanTrainSet, write_synthetic_attngan)
from multiple_objects_gan_tpu_torch.data.coco import (
    CocoStackganDataset, write_synthetic_coco)
from multiple_objects_gan_tpu_torch.data.datasets import (
    ClevrDataset, Loader, MemoryLoader, MultiMnistDataset,
    write_synthetic_clevr, write_synthetic_multimnist)
from multiple_objects_gan_tpu_torch.data.png import (
    decode_png, read_png, resize_bilinear, resize_bilinear_batch,
    resize_bilinear_tensor)
from multiple_objects_gan_tpu_torch.data.synthetic import (
    synthetic_clevr, synthetic_coco, synthetic_coco_stage2,
    synthetic_multimnist)
from multiple_objects_gan_tpu_torch.io.checkpoint import CheckpointManager
from multiple_objects_gan_tpu_torch.io.weights import (
    load_image_encoder, load_reference_attngan_d, load_reference_attngan_g,
    load_reference_g, load_text_encoder, split_stage2_g)
from multiple_objects_gan_tpu_torch.models.attngan import (
    COCO_ATTN, D_NAMES, build_attngan_d, build_attngan_g)
from multiple_objects_gan_tpu_torch.models.common import MNIST
from multiple_objects_gan_tpu_torch.models.stage1 import build_stage1_g
from multiple_objects_gan_tpu_torch.models.stage2 import build_stage2_g
from multiple_objects_gan_tpu_torch.nn.encoders import (
    build_image_encoder, build_text_encoder)
from multiple_objects_gan_tpu_torch.nn.fid_inception import FIDInceptionV3
from multiple_objects_gan_tpu_torch.ops import _build
from multiple_objects_gan_tpu_torch.ops import normconv as k4
from multiple_objects_gan_tpu_torch.ops import stn_place_cuda as k1
from multiple_objects_gan_tpu_torch.ops.stn import place_weights
from multiple_objects_gan_tpu_torch.tools import profile_step, spike_normconv
from multiple_objects_gan_tpu_torch.tools import (
    bench_sampling, bench_variants)
from multiple_objects_gan_tpu_torch.tools import (
    check_dataset as check_tool, dist_steps, export_checkpoint as export_tool,
    parity_harness as parity_tool, validate_learning as vl)
from multiple_objects_gan_tpu_torch.tools import (
    eval_layout_fidelity as layout_tool)
from multiple_objects_gan_tpu_torch.train import loop as train_loop
from multiple_objects_gan_tpu_torch.train.attngan_step import (
    make_attngan_train_step)
from multiple_objects_gan_tpu_torch.train.damsm_step import (
    make_damsm_train_step)
from multiple_objects_gan_tpu_torch.train.state import (
    AttnGanTrainState, create_damsm_state, create_state, create_state_stage2,
    ema_of, make_optimizer)
from multiple_objects_gan_tpu_torch.train.step import (
    frozen_forward, make_sample_fn, make_stage2_train_step, make_train_step)
from multiple_objects_gan_tpu_torch.utils.images import (
    PNG_SIGNATURE, draw_bboxes, make_grid, png_chunk, tile_uint8, to_uint8)
from multiple_objects_gan_tpu_torch.utils.layout_fidelity import (
    clevr_layout_fidelity, layout_fidelity)
from multiple_objects_gan_tpu_torch.utils.metrics import (
    inception_activations)

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "runs_r5", "mnist_repin", "netG_final.pth")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = bench_variants.F32_OPS_PER_S  # H100 SXM, no tensor cores
KERNEL_ATOL = 1e-5
MODEL_ATOL = 5e-4
MIN_SEPARATION = 0.5
GRAD_RTOL = 1e-3            # Stage1G object-pathway gradient, card vs CPU
LOSS_ATOL = 1e-3            # train step, card vs CPU: tests/test_step_parity.py
STATS_ATOL = 5e-4
MIN_GRAD_COSINE = 0.995     # per tensor, card vs CPU (PERF.md: >= 0.9984 read)
STEP_BATCH = 128            # cfg/mnist_train.yml TRAIN.BATCH_SIZE
LR = 2e-4
KL_COEFF = 2.0              # cfg/coco_s1_train.yml TRAIN.COEFF.KL
DEVICE = "cuda"
BF16 = dataclasses.replace(MNIST, compute_dtype=torch.bfloat16)
BF16_ULPS = 1               # a bf16 kernel against its plain version: ulps
                            # of the largest |value| (the same f32 sums in
                            # another order, rounded to bf16 once)
K4_SUM_RTOL = 1e-3          # K4's sums against the plain ones, of max |sum|
STEP16_BATCH = STEP_BATCH   # the bf16 step card vs CPU (phase 13): the CPU's
                            # bf16 step at full width and batch 128 takes
                            # about 15 s, so nothing is cut
# the bf16 step card vs CPU (phase 13), from tests/test_bf16.py's rtol 0.05
# tightened to what an H100 showed at batch 128 (PERF.md): losses 2.98e-3
# relative (limit 3.4 times that), statistics 1.79e-3 (2.8 times), lowest
# gradient cosine 0.939, a layout-encoder BatchNorm bias (the limit leaves
# 1 - 0.9 = 1.6 times its 0.061 gap to 1). A cut place backward reads 0 on
# the object pathways, a mirrored one down to 0.55 (on the CPU at gf/df 8:
# tests/test_torch_port_bf16.py holds both below the limit)
BF16_LOSS_RTOL = 0.01
BF16_STATS_ATOL = 5e-3
BF16_MIN_GRAD_COSINE = 0.9
MIN_BF16_SEPARATION = MIN_SEPARATION
MAX_BF16_SERVE_MEAN_DIFF = 0.05  # bf16 served image vs float32, [-1, 1]
COLD_BYTES = 100 * 2**20    # twice the card's 50 MB L2: K1 and K2 are timed
                            # on a rotation of inputs that reads more than
                            # this before it reuses one (cold_sets)
# the CLEVR and COCO-StackGAN stage-1 families (phases 16-20), at the
# published widths of their train cfgs
FAMILY_CFGS = {"clevr": os.path.join(ROOT, "cfg", "clevr_train.yml"),
               "coco-stackgan-1": os.path.join(ROOT, "cfg",
                                               "coco_s1_train.yml")}
FAMILY_STEP_BATCH = STEP_BATCH  # the family steps card vs CPU (phase 17)
FAMILY_TIME_RUNS = 10           # CUDA-event readings a family step time


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, warmup: int = 5, runs: int = 50) -> float:
    """Median time of one call of ``fn`` by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cold_sets(args, read_bytes: int, min_bytes: int = COLD_BYTES) -> list:
    """``args``, a call's tensor arguments, and copies of them: enough sets
    that a rotation through them reads more than ``min_bytes`` (each call
    ``read_bytes``) before it comes back to a set, so that every call finds
    its inputs in device memory and not in the L2 cache. The first set is
    ``args`` itself; there are at least two."""
    n = max(2, min_bytes // max(1, read_bytes) + 1)
    return [tuple(args)] + [tuple(a.clone() for a in args)
                            for _ in range(n - 1)]


def run_ms(fn, warmup: int = 5, runs: int = 50, sets=None) -> float:
    """Time of one call of ``fn`` in a run of ``runs`` calls back to back
    between two CUDA events, over the count: the host's launch work
    overlaps the card's, as in the train step, where :func:`cuda_ms` adds
    it to every call. With ``sets`` (:func:`cold_sets`), call k, warm-up
    included, takes the arguments ``sets[k % len(sets)]``; without, ``fn``
    takes none and reads the same buffers every call."""
    sets = sets or [()]
    for k in range(warmup):
        fn(*sets[k % len(sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for k in range(warmup, warmup + runs):
        fn(*sets[k % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def graph_ms(fn, sets, runs: int = 50) -> float:
    """Device time of one call of ``fn``: ``runs`` calls, call k taking
    ``sets[k % len(sets)]``, captured in one CUDA graph and replayed
    between two CUDA events, over the count. The host's launch work, which
    :func:`run_ms` overlaps but cannot hide when a call's device work is
    shorter than its host work, is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # capture wants a warmed-up side stream
        for k in range(3):
            fn(*sets[k % len(sets)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # relaxed: a wrapper sets its kernel's shared-memory attribute per launch
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for k in range(runs):
            fn(*sets[k % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def in_turns(order, warmup: int = 5, runs: int = 50, sets=None) -> dict:
    """Time the calls of ``order``, a list of (name, fn) in the order to
    run them (plain, kernel, kernel, plain), each reading a run of ``runs``
    back-to-back calls (:func:`run_ms`, through ``sets`` when given);
    returns {name: [reading, ...]} in run order."""
    out: dict = {}
    for name, fn in order:
        out.setdefault(name, []).append(run_ms(fn, warmup, runs, sets))
    return out


def ptxas_lines(log: str) -> list[str]:
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its name (the
    readable part of the mangled one), registers, shared memory, stack
    frame and spill stores and loads."""
    out, name, frame = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = mangled
            for key in ("normconv", "stn_place"):
                at = mangled.rfind(key)
                if at >= 0:
                    name = mangled[at:].split("EEv")[0].split("Ev")[0]
                    break
            frame = ""
        elif "bytes stack frame" in line and name:
            frame = line.strip()
        elif "Used" in line and "registers" in line and name:
            used = line.split("Used", 1)[1].strip()
            out.append(f"{name}: used {used}; {frame or 'no frame line'}")
            name = None
    return out


# ------------------------------------------------------------------ phases


def phase_device():
    log("phase 1/52 device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible")
    # full float32 everywhere below: the plain versions and the model
    # comparison are numerical references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN (torch.backends.*.allow_tf32 = False)")
    return name


def phase_build():
    log("phase 2/52 build")
    names = ("stn_place", "normconv")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(_build.build, names))
    for b in built:
        log(f"build: {os.path.relpath(b.path, ROOT)} ready in "
            f"{b.seconds:.2f}s; ptxas -v, one line a kernel:")
        lines = ptxas_lines(b.log)
        for line in lines:
            print(f"  {line}", flush=True)
        check(bool(lines) or not b.log, f"no ptxas report in the build log "
              f"of {b.path}:\n{b.log}")


def _service_boxes(rs, b, o):
    """Layouts as the service draws them for items without one."""
    pairs = [_item_layout({}, o, 10, rs) for _ in range(b)]
    return np.stack([p[1] for p in pairs])


def _bound(features, bbox, out_hw):
    """Least time for this run's data: the input values with a non-zero
    weight, the boxes and the output, in the features' element size, over
    the memory rate; two flops a tap over the float32 rate (the kernel's
    arithmetic in either type). Returns (bound_ms, bound_by, dense_ms,
    read_bytes): dense_ms reads every input value, read_bytes is what the
    bound reads."""
    b, o, c, hi, wi = features.shape
    es = features.element_size()
    wy, wx = place_weights(bbox.reshape(b * o, 4), out_hw, (hi, wi))
    rows = (wy != 0).any(dim=1).sum(dim=1)
    cols = (wx != 0).any(dim=1).sum(dim=1)
    read = int((rows * cols).sum()) * c * es + bbox.numel() * 4
    out_bytes = b * c * out_hw[0] * out_hw[1] * es
    taps = int(((wy != 0).sum(2)[:, :, None]
                * (wx != 0).sum(2)[:, None, :]).sum()) * c
    bytes_ms = (read + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * taps / F32_OPS_PER_S * 1e3
    dense_ms = (features.numel() * es + bbox.numel() * 4 + out_bytes) \
        / HBM_BYTES_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations"), dense_ms, read


def phase_kernel():
    log("phase 3/52 kernel against its plain version, on the card")
    rs = np.random.RandomState(0)
    dev = torch.device(DEVICE)

    def case(b, o, c, hw, kind):
        feats = rs.randn(b, o, c, hw[0], hw[1]).astype(np.float32)
        bbox = _service_boxes(rs, b, o)
        if kind == "padded":          # every other item: all objects padded
            bbox[::2] = -1.0
        elif kind == "off-canvas":    # boxes that stick out on every side
            w = rs.uniform(0.3, 0.6, (b, o))
            h = rs.uniform(0.3, 0.6, (b, o))
            bbox = np.stack([rs.uniform(-0.4, 0.9, (b, o)),
                             rs.uniform(-0.4, 0.9, (b, o)), w, h],
                            -1).astype(np.float32)
        elif kind == "train":         # the train step's boxes
            bbox = _train_boxes(b, int(rs.randint(1 << 30)))
        elif kind == "wide":          # wider than the canvas, any place
            bbox = _grad_boxes(rs, b, o, "wide")
        return (torch.from_numpy(feats).to(dev),
                torch.from_numpy(bbox).to(dev))

    cases = [  # (label, (B, O, C, input side, boxes), output side)
        ("generator path", (64, 3, 256, (16, 16), "service"), 16),
        ("train step, G", (STEP_BATCH, 3, 256, (16, 16), "train"), 16),
        ("train step, D, 15x15", (STEP_BATCH, 3, 128, (15, 15), "train"), 16),
        ("padded objects", (64, 3, 256, (16, 16), "padded"), 16),
        ("boxes partly off the canvas", (64, 3, 256, (16, 16), "off-canvas"),
         16),
        ("odd channel count", (64, 3, 37, (16, 16), "service"), 16),
        ("batch of one", (1, 3, 256, (16, 16), "service"), 16),
        ("15x15 maps onto the 16x16 canvas", (64, 3, 128, (15, 15), "service"),
         16),
        ("boxes wider than the canvas", (STEP_BATCH, 3, 256, (16, 16), "wide"),
         16),
        ("boxes wider than the canvas, 15x15",
         (STEP_BATCH, 3, 128, (15, 15), "wide"), 16),
    ] + K1_TILE_EDGES
    worst = 0.0
    timed = {}
    for label, (b, o, c, hw, kind), side in cases:
        feats, bbox = case(b, o, c, hw, kind)
        got = k1.stn_place_multi_nchw(feats, bbox, (side, side))
        want = k1.stn_place_multi_plain(feats, bbox, (side, side))
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        log(f"  {label}: {tuple(feats.shape)} -> {(side, side)}: max |kernel "
            f"- plain| = {err:.3e} (atol {KERNEL_ATOL:g}); tile "
            f"{k1.place_tile(hw, (side, side))}")
        check(err <= KERNEL_ATOL, f"K1 disagrees with its plain version "
              f"({label}): {err:.3e} > {KERNEL_ATOL:g}")
        if kind == "padded":
            check(int(torch.count_nonzero(got[::2])) == 0,
                  "padded items must place exact zeros")
        if kind in ("service", "train") and c != 37 and b > 1 and side == 16:
            timed.setdefault(f"{kind} {hw[0]}", (feats, bbox))
    check_side_limit(dev, torch.float32)

    out = {"max_abs_err": worst}
    for path, key in (("serve", "service 16"), ("train G", "train 16"),
                      ("train D", "train 15")):
        feats, bbox = timed[key]
        out[path] = time_place(feats, bbox, (16, 16),
                               f"K1 at the {path} shape")
    return out


# K1 at the sides of Stage 2's places (label, (B, O, C, input side, boxes),
# output side), where its channel tile halves to 4 and to 1
K1_TILE_EDGES = [
    ("32x32 onto 32x32", (8, 3, 64, (32, 32), "service"), 32),
    ("64x64 onto 64x64", (4, 3, 32, (64, 64), "service"), 64),
]


def check_side_limit(dev, dtype):
    """K1 refuses a side above MAX_SIDE (64) with a ValueError before it
    launches anything."""
    before = k1.launch_count()
    for in_side, out_side in ((65, 16), (16, 65)):
        feats = torch.zeros((1, 3, 4, in_side, in_side), device=dev,
                            dtype=dtype)
        bbox = torch.full((1, 3, 4), 0.25, device=dev)
        try:
            k1.stn_place_multi_nchw(feats, bbox, (out_side, out_side))
        except ValueError as e:
            log(f"  side {max(in_side, out_side)} ({in_side} -> {out_side}), "
                f"{str(dtype)[6:]}: refused ({e})")
        else:
            check(False, f"K1 took a side of {max(in_side, out_side)}")
    check(k1.launch_count() == before, "a refused call launched K1")


def time_place(feats, bbox, out_hw, label):
    """K1 and its plain version onto an ``out_hw`` canvas, timed cold in
    turns (plain, kernel, kernel, plain), each reading a run of 50 calls
    (:func:`run_ms`) on a rotation of input copies that finds every call's
    inputs in device memory (:func:`cold_sets`), beside the bound for this
    run's boxes and the rate it implies."""
    out_hw = tuple(out_hw)
    bound_ms, bound_by, dense_ms, read = _bound(feats, bbox, out_hw)
    sets = cold_sets((feats, bbox), read)

    def kernel(f, bb):
        return k1.stn_place_multi_nchw(f, bb, out_hw)

    def plain(f, bb):
        return k1.stn_place_multi_plain(f, bb, out_hw)

    t = in_turns([("plain", plain), ("kernel", kernel), ("kernel", kernel),
                  ("plain", plain)], sets=sets)
    ms, plain_ms = statistics.mean(t["kernel"]), statistics.mean(t["plain"])
    dev_ms = graph_ms(kernel, sets)
    gbps = bound_ms / ms * HBM_BYTES_PER_S / 1e9 if bound_by == "bytes" \
        else float("nan")
    log(f"{label} {tuple(feats.shape)} -> {out_hw} {str(feats.dtype)[6:]}, "
        f"cold in turns (plain, K1, K1, plain; CUDA events around 50 calls "
        f"back to back each, rotating over {len(sets)} copies of the "
        f"inputs): K1 {t['kernel'][0]:.4f}, {t['kernel'][1]:.4f} ms; plain "
        f"{t['plain'][0]:.4f}, {t['plain'][1]:.4f} ms; bound {bound_ms:.4f} "
        f"ms ({bound_by}, this run's boxes; {dense_ms:.4f} ms if every input "
        f"value were read); {gbps:.0f} GB/s of the bytes it needs, "
        f"{bound_ms / ms:.1%} of the bound; on the device alone (the same "
        f"calls in a CUDA graph) {dev_ms:.4f} ms, {bound_ms / dev_ms:.1%} of "
        f"the bound")
    return {"ms": ms, "ms_turns": t["kernel"], "plain_ms": plain_ms,
            "plain_ms_turns": t["plain"], "graph_ms": dev_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "dense_bound_ms": dense_ms, "share_of_bound": bound_ms / ms,
            "graph_share_of_bound": bound_ms / dev_ms, "gb_per_s": gbps,
            "input_sets": len(sets)}


def phase_model():
    log("phase 4/52 model: full-width trained Stage1G, card against CPU")
    sd = load_reference_g(CKPT)
    g_gpu = build_stage1_g(MNIST, sd, device=DEVICE)
    g_cpu = build_stage1_g(MNIST, sd, device="cpu")
    n_params = sum(p.numel() for p in g_gpu.parameters())
    log(f"weights: {os.path.relpath(CKPT, ROOT)} ({len(sd)} tensors, "
        f"{n_params} parameters, ngf {MNIST.ngf})")
    rs = np.random.RandomState(1)
    z = torch.from_numpy(rs.randn(64, MNIST.z_dim).astype(np.float32))
    bbox = torch.from_numpy(_service_boxes(rs, 64, MNIST.num_objects))
    labels = torch.zeros(64, MNIST.num_objects, MNIST.label_dim)
    labels.scatter_(2, torch.from_numpy(rs.randint(0, 10, (64, 3, 1))), 1.0)
    labels[bbox[..., 2] < 0] = 0.0
    args_gpu = [t.to(DEVICE) for t in (z, bbox, labels)]
    with torch.inference_mode():
        on_gpu = g_gpu(*args_gpu).cpu()
        on_cpu = g_cpu(z, bbox, labels)
    diff = float((on_gpu - on_cpu).abs().max())
    check(bool(torch.isfinite(on_gpu).all()), "non-finite image values")
    log(f"generator card vs CPU, batch 64, float32 both (TF32 off): max "
        f"|diff| = {diff:.3e} (atol {MODEL_ATOL:g}); image mean "
        f"{float(on_gpu.mean()):.4f} std {float(on_gpu.std()):.4f}")
    check(diff <= MODEL_ATOL, f"card and CPU disagree: {diff:.3e}")
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: g_gpu(*args_gpu), warmup=3, runs=20)
    log(f"generator forward at batch 64 on the card: {fwd_ms:.3f} ms "
        f"(CUDA events, median of 20; {64e3 / fwd_ms:.0f} images/s)")
    imgs = on_gpu.permute(0, 2, 3, 1).numpy()
    encode = []
    for _ in range(5):
        t = time.perf_counter()
        for im in imgs:
            _png_b64(im)
        encode.append((time.perf_counter() - t) * 1e3)
    log(f"PNG + base64 of 64 images on the host: "
        f"{statistics.median(encode):.2f} ms (host clock, median of 5)")
    return fwd_ms


def _png_gray64(b64: str, channels: int = 1):
    """Decode a served PNG without an imaging library: signature, IHDR of
    a 64x64 8-bit grayscale (or, with 3 ``channels``, RGB) image, IDAT
    rows of filter type 0. Returns (64, 64) or (64, 64, 3) uint8."""
    raw = base64.b64decode(b64)
    check(raw[:8] == b"\x89PNG\r\n\x1a\n", "PNG signature")
    length, kind = struct.unpack(">I4s", raw[8:16])
    check(kind == b"IHDR" and length == 13, "IHDR chunk")
    color_type = 0 if channels == 1 else 2
    check(struct.unpack(">IIBBBBB", raw[16:29])
          == (64, 64, 8, color_type, 0, 0, 0),
          f"IHDR: 64x64, 8-bit, colour type {color_type}")
    pos, data = 33, b""
    while pos < len(raw):
        length, kind = struct.unpack(">I4s", raw[pos:pos + 8])
        if kind == b"IDAT":
            data += raw[pos + 8:pos + 8 + length]
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(data), np.uint8).reshape(
        64, 64 * channels + 1)
    check(not rows[:, 0].any(), "PNG row filters")
    img = rows[:, 1:]
    return img if channels == 1 else img.reshape(64, 64, 3)


def _separation(imgs, boxes) -> tuple[float, float]:
    """In-box and out-of-box mean luminance in [-1, 1] units over a batch
    of uint8 images, (N, S, S) or (N, S, S, 3), with each image's boxes
    (x, y, w, h) in [0, 1], a negative x marking a padded object: the
    measure of tools/validate_learning.py."""
    imgs = imgs.astype(np.float32) / 127.5 - 1.0
    lum = imgs.mean(axis=-1) if imgs.ndim == 4 else imgs
    size = lum.shape[1]
    inside = np.zeros(lum.shape, bool)
    for i, bb in enumerate(boxes):
        for x, y, w, h in bb:
            if x < 0:
                continue
            inside[i, int(y * size):min(int((y + h) * size), size),
                   int(x * size):min(int((x + w) * size), size)] = True
    return float(lum[inside].mean()), float(lum[~inside].mean())


def phase_serve():
    log("phase 5/52 serve: the port's main path over HTTP, on the card")
    k1.reset_launch_count()
    svc = Stage1Service(MNIST, CKPT, seed=0, device=DEVICE)
    httpd = serve(argparse.Namespace(variant="multi-mnist",
                                     host="127.0.0.1", port=0,
                                     max_wait_ms=5.0), svc)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    log(f"serving on 127.0.0.1:{port}, max_batch {svc.max_batch}, weights "
        f"{os.path.relpath(CKPT, ROOT)}")

    def request(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            conn.request(method, path,
                         body=None if body is None else json.dumps(body))
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    try:
        results = [None] * 24

        def call(i):
            # 1-3 items, every other one with a random layout
            items = [{} if (i + j) % 2 else
                     {"labels": [(i + k) % 10 for k in range(1 + j % 3)],
                      "bboxes": [[0.05 + 0.3 * k, 0.3, 0.3, 0.35]
                                 for k in range(1 + j % 3)]}
                     for j in range(1 + i % 3)]
            results[i] = (request("POST", "/generate", {"items": items}),
                          len(items))

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(results))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            check(not t.is_alive(), "a request did not finish")
        n_images = 0
        for (status, body), n in results:
            check(status == 200, f"/generate returned {status}: {body}")
            check(len(body["images"]) == n, "one image per item")
            for b64 in body["images"]:
                _png_gray64(b64)
                n_images += 1
        log(f"{len(results)} concurrent requests, {n_images} images: all "
            "200, valid 64x64 grayscale PNGs")

        rs = np.random.RandomState(2)
        items, boxes = [], []
        for _ in range(64):
            n = int(rs.randint(1, 4))
            w, h = rs.uniform(0.25, 0.4, n), rs.uniform(0.25, 0.4, n)
            bb = np.stack([rs.uniform(0, 1 - w), rs.uniform(0, 1 - h), w, h],
                          -1).round(4).tolist()
            items.append({"labels": rs.randint(0, 10, n).tolist(),
                          "bboxes": bb})
            boxes.append(bb)
        t = time.perf_counter()
        status, body = request("POST", "/generate", {"items": items})
        latency_ms = (time.perf_counter() - t) * 1e3
        check(status == 200 and len(body["images"]) == 64,
              f"64-item request: {status}")
        sep = [np.subtract(*_separation(_png_gray64(b)[None], [bb]))
               for b, bb in zip(body["images"], boxes)]
        log(f"64-item request: {latency_ms:.1f} ms end to end over HTTP "
            f"(host clock); digits in their boxes: separation mean "
            f"{np.mean(sep):.3f}, min {np.min(sep):.3f} (need mean > "
            f"{MIN_SEPARATION})")
        check(float(np.mean(sep)) > MIN_SEPARATION,
              "served images do not place content in the requested boxes")
        status, stats = request("GET", "/stats")
        check(status == 200, "/stats")
        log(f"/stats: {stats}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.batcher.close()
        thread.join(timeout=30)
    launches = (k1.launch_count(), k1.grad_launch_count())
    check(stats["device"].startswith(DEVICE), "served on the card")
    check(launches[0] == svc.device_batches == stats["batches"] + 1,
          f"K1 launches {launches[0]} != device batches "
          f"{svc.device_batches} (= {stats['batches']} served + 1 warm-up)")
    check(launches[1] == 0, f"serving launched K2 {launches[1]} times")
    log(f"K1 launches during serving: {launches[0]} for "
        f"{svc.device_batches} device batches ({stats['batches']} served + 1 "
        f"warm-up): every generator forward went through the kernel; K2 "
        f"launches {launches[1]}")
    return launches, latency_ms


def _train_boxes(b, seed):
    """Boxes as the training data draws them (the synthetic Multi-MNIST
    set: three objects, 0.2-0.33 wide, inside the canvas)."""
    return synthetic_multimnist(b, seed=seed)["bbox"]


def _grad_boxes(rs, b, o, kind):
    if kind == "wide":                # wider than the canvas, any place
        w = rs.uniform(1.0, 1.6, (b, o))
        h = rs.uniform(1.0, 1.6, (b, o))
        return np.stack([rs.uniform(-0.8, 0.5, (b, o)),
                         rs.uniform(-0.8, 0.5, (b, o)), w, h],
                        -1).astype(np.float32)
    if kind == "off-canvas":          # sticking out on every side
        w = rs.uniform(0.3, 0.6, (b, o))
        h = rs.uniform(0.3, 0.6, (b, o))
        return np.stack([rs.uniform(-0.4, 0.9, (b, o)),
                         rs.uniform(-0.4, 0.9, (b, o)), w, h],
                        -1).astype(np.float32)
    bbox = _train_boxes(b, int(rs.randint(1 << 30)))
    if kind == "padded":              # every other item: all objects padded
        bbox[::2] = -1.0
    return bbox


def _grad_bound(g, bbox, in_hw):
    """Least time of K2 for this run's data: the gradient values some
    object's weights touch, the boxes, and the whole output over the
    memory rate, in the gradient's element size; two flops a tap over the
    float32 rate. Returns (bound_ms, bound_by, dense_ms, read_bytes),
    dense_ms reading every gradient value, read_bytes what the bound
    reads."""
    b, c, ho, wo = g.shape
    o = bbox.shape[1]
    es = g.element_size()
    wy, wx = place_weights(bbox.reshape(b * o, 4), (ho, wo), in_hw)
    ry = (wy != 0).any(dim=2).reshape(b, o, ho)
    rx = (wx != 0).any(dim=2).reshape(b, o, wo)
    need = (ry[:, :, :, None] & rx[:, :, None, :]).any(dim=1)
    out_bytes = b * o * c * in_hw[0] * in_hw[1] * es
    read = int(need.sum()) * c * es + bbox.numel() * 4
    taps = int(((wy != 0).sum(dim=(1, 2)) * (wx != 0).sum(dim=(1, 2))).sum()) * c
    bytes_ms = (read + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * taps / F32_OPS_PER_S * 1e3
    dense_ms = (g.numel() * es + bbox.numel() * 4 + out_bytes) \
        / HBM_BYTES_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations"), dense_ms, read


def phase_grad_kernel():
    log("phase 6/52 grad: K2 (place backward) against its plain version, "
        "on the card")
    rs = np.random.RandomState(3)
    dev = torch.device(DEVICE)
    cases = [
        ("generator path", (STEP_BATCH, 3, 256, (16, 16), "train")),
        ("discriminator path, 15x15", (STEP_BATCH, 3, 128, (15, 15), "train")),
        ("padded objects", (STEP_BATCH, 3, 256, (16, 16), "padded")),
        ("boxes partly off the canvas",
         (STEP_BATCH, 3, 256, (16, 16), "off-canvas")),
        ("boxes wider than the canvas", (STEP_BATCH, 3, 256, (16, 16), "wide")),
        ("boxes wider than the canvas, 15x15",
         (STEP_BATCH, 3, 128, (15, 15), "wide")),
        ("odd channel count", (STEP_BATCH, 3, 37, (16, 16), "train")),
        ("batch of one", (1, 3, 256, (16, 16), "train")),
    ]
    worst = 0.0
    timed = {}
    for label, (b, o, c, hw, kind) in cases:
        g = torch.from_numpy(rs.uniform(-1.0, 1.0, (b, c, 16, 16)).astype(
            np.float32)).to(dev)
        bbox = torch.from_numpy(_grad_boxes(rs, b, o, kind)).to(dev)
        got = k1.stn_place_multi_grad_nchw(g, bbox, hw)
        want = k1.stn_place_multi_grad_plain(g, bbox, hw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        log(f"  {label}: {tuple(g.shape)} -> {(b, o, c) + hw}: max |kernel "
            f"- plain| = {err:.3e} (atol {KERNEL_ATOL:g}); max |df| "
            f"{float(want.abs().max()):.3f}")
        check(err <= KERNEL_ATOL, f"K2 disagrees with its plain version "
              f"({label}): {err:.3e} > {KERNEL_ATOL:g}")
        check(bool(torch.isfinite(got).all()), f"K2 non-finite ({label})")
        if kind == "padded":
            check(int(torch.count_nonzero(got[::2])) == 0,
                  "padded objects must get exact zeros")
        if kind == "train" and b == STEP_BATCH and c != 37:
            timed["G" if hw == (16, 16) else "D"] = (g, bbox, hw)

    out = {"max_abs_err": worst}
    for path in ("G", "D"):
        g, bbox, hw = timed[path]
        out[path] = time_grad(g, bbox, hw, f"K2 at the {path} shape")
    return out


def time_grad(g, bbox, hw, label):
    """K2 and its plain version timed cold in turns (plain, kernel, kernel,
    plain), each reading a run of 50 calls (:func:`run_ms`) on a rotation
    of gradient copies (:func:`cold_sets`); beside them the same turns on
    one set of buffers (warm, partly in L2, the method of earlier
    readings), K2 a call at a time (:func:`cuda_ms`), the bound for this
    run's boxes and the rate it implies."""
    def kernel(gg=g, bb=bbox):
        return k1.stn_place_multi_grad_nchw(gg, bb, hw)

    def plain(gg=g, bb=bbox):
        return k1.stn_place_multi_grad_plain(gg, bb, hw)

    order = [("plain", plain), ("kernel", kernel), ("kernel", kernel),
             ("plain", plain)]
    bound_ms, bound_by, dense_ms, read = _grad_bound(g, bbox, hw)
    sets = cold_sets((g, bbox), read)
    t = in_turns(order, sets=sets)
    warm = in_turns(order)
    ms, plain_ms = statistics.mean(t["kernel"]), statistics.mean(t["plain"])
    warm_ms = statistics.mean(warm["kernel"])
    dev_ms = graph_ms(kernel, sets)
    call_ms = cuda_ms(kernel)
    gbps = bound_ms / ms * HBM_BYTES_PER_S / 1e9 if bound_by == "bytes" \
        else float("nan")
    out_shape = (g.shape[0], bbox.shape[1], g.shape[1]) + tuple(hw)
    log(f"{label} {tuple(g.shape)} -> {out_shape} {str(g.dtype)[6:]}, cold "
        f"in turns (plain, K2, K2, plain; CUDA events around 50 calls back "
        f"to back each, rotating over {len(sets)} copies of the inputs): K2 "
        f"{t['kernel'][0]:.4f}, {t['kernel'][1]:.4f} ms; plain "
        f"{t['plain'][0]:.4f}, {t['plain'][1]:.4f} ms; warm (one set of "
        f"buffers): K2 {warm['kernel'][0]:.4f}, {warm['kernel'][1]:.4f} ms, "
        f"plain {warm['plain'][0]:.4f}, {warm['plain'][1]:.4f} ms; "
        f"{call_ms:.4f} ms a call timed alone (median of 50); bound "
        f"{bound_ms:.4f} ms ({bound_by}, this run's boxes; {dense_ms:.4f} ms "
        f"if every gradient value were read); {gbps:.0f} GB/s of the bytes "
        f"it needs, {bound_ms / ms:.1%} of the bound cold, "
        f"{bound_ms / warm_ms:.1%} warm; on the device alone (the cold calls "
        f"in a CUDA graph) {dev_ms:.4f} ms, {bound_ms / dev_ms:.1%} of the "
        f"bound")
    return {"ms": ms, "ms_turns": t["kernel"], "plain_ms": plain_ms,
            "plain_ms_turns": t["plain"], "graph_ms": dev_ms,
            "graph_share_of_bound": bound_ms / dev_ms, "warm_ms": warm_ms,
            "warm_ms_turns": warm["kernel"],
            "warm_plain_ms": statistics.mean(warm["plain"]),
            "call_ms": call_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "dense_bound_ms": dense_ms, "share_of_bound": bound_ms / ms,
            "gb_per_s": gbps, "input_sets": len(sets)}


def _f1_gradient(device, z, bbox, labels, weight):
    """Gradient of sum(image * weight) for local1.1.weight of a train-mode
    full-width Stage1G (reference init, seed 0) on ``device``."""
    g = build_stage1_g(MNIST, seed=0, device=device).train()
    img = g(*(t.to(device) for t in (z, bbox, labels)))
    (grad,) = torch.autograd.grad((img * weight.to(device)).sum(),
                                  g.local1[1].weight)
    return grad.cpu()


def phase_autograd():
    log("phase 7/52 autograd: K3 gradients on the card against the CPU")
    rs = np.random.RandomState(4)
    for label, (c, hw) in (("G", (256, (16, 16))), ("D", (128, (15, 15)))):
        feats = torch.from_numpy(rs.randn(STEP_BATCH, 3, c, *hw).astype(
            np.float32))
        bbox = torch.from_numpy(_train_boxes(STEP_BATCH, 11))
        cot = torch.from_numpy(rs.uniform(-1, 1, (STEP_BATCH, c, 16, 16))
                               .astype(np.float32))
        outs, grads = {}, {}
        for dev in ("cpu", DEVICE):
            f = feats.to(dev).requires_grad_(True)
            out = k1.stn_place_multi_nchw(f, bbox.to(dev), (16, 16))
            check(out.grad_fn is not None,
                  f"the place output on {dev} has no grad_fn")
            (grads[dev],) = torch.autograd.grad(out, f, cot.to(dev))
            outs[dev] = out.detach().cpu()
        out_err = float((outs[DEVICE] - outs["cpu"]).abs().max())
        err = float((grads[DEVICE].cpu() - grads["cpu"]).abs().max())
        log(f"  {label} shape {tuple(feats.shape)}: grad_fn "
            f"{type(out.grad_fn).__name__}; max |card - CPU| of the placed "
            f"output = {out_err:.3e}, of the feature gradient = {err:.3e} "
            f"(atol {KERNEL_ATOL:g})")
        check(out_err <= KERNEL_ATOL, f"K3 forward card vs CPU ({label}): "
              f"{out_err:.3e}")
        check(err <= KERNEL_ATOL, f"K3 gradient card vs CPU ({label}): "
              f"{err:.3e}")

    b = 16
    z = torch.from_numpy(rs.randn(b, MNIST.z_dim).astype(np.float32))
    data = synthetic_multimnist(b, seed=12)
    bbox = torch.from_numpy(data["bbox"])
    labels = torch.from_numpy(data["label_onehot"])
    weight = torch.from_numpy(rs.uniform(-1, 1, (b, 1, 64, 64)).astype(
        np.float32))
    on_cpu = _f1_gradient("cpu", z, bbox, labels, weight)
    on_card = _f1_gradient(DEVICE, z, bbox, labels, weight)
    scale = float(on_cpu.abs().max())
    rel = float((on_card - on_cpu).abs().max()) / scale
    cos = float(torch.nn.functional.cosine_similarity(
        on_card.flatten(), on_cpu.flatten(), dim=0))
    log(f"train-mode Stage1G (full width, batch {b}) local1.1.weight "
        f"gradient: max |CPU| {scale:.3e}, max |card - CPU| / max |CPU| = "
        f"{rel:.3e} (limit {GRAD_RTOL:g}), cosine {cos:.6f}")
    check(scale > 0 and float(on_card.abs().max()) > 0,
          "the object pathway got no gradient (F1)")
    check(rel <= GRAD_RTOL, f"object-pathway gradient card vs CPU: {rel:.3e}")


def randomize(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Overwrite ``module``'s weights as tests/test_torch_parity.py's
    ``_randomize`` does (the weights of tests/test_step_parity.py): every
    parameter N(0, 0.05), and BatchNorm statistics and affine terms away
    from their init. Drawn on the CPU, so any device gets the same."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        for m in module.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_mean.copy_(
                    torch.randn(m.running_mean.shape, generator=g) * 0.1)
                m.running_var.copy_(
                    1.0 + 0.2 * torch.rand(m.running_var.shape, generator=g))
                m.weight.copy_(
                    1.0 + 0.05 * torch.randn(m.weight.shape, generator=g))
                m.bias.copy_(0.05 * torch.randn(m.bias.shape, generator=g))
    return module


def step_once(device, data, z, cfg=MNIST, randomized=False, eps=None):
    """One train step on ``device`` from the reference init (seed 0), or
    from the weights of tests/test_step_parity.py when ``randomized``;
    ``eps`` is the CA net's noise (coco-stackgan-1), KL x ``KL_COEFF``.
    Returns its losses, the state dicts before and after, the gradients,
    and the step's host time."""
    state = create_state(cfg, seed=0, device=device)
    nets = (("G", state.g), ("D", state.d))
    if randomized:
        randomize(state.g, 3)
        randomize(state.d, 11)
    pre = {n: {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
           for n, m in nets}
    batch = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    t = time.perf_counter()
    metrics = make_train_step(cfg, KL_COEFF)(
        state, batch, None, LR, LR, z=torch.from_numpy(z).to(device),
        eps=None if eps is None else torch.from_numpy(eps).to(device))
    metrics = {k: float(v) for k, v in metrics.items()}
    seconds = time.perf_counter() - t
    post = {n: {k: v.detach().cpu() for k, v in m.state_dict().items()}
            for n, m in nets}
    grads = {n: {k: (torch.zeros(p.shape) if p.grad is None
                     else p.grad.detach().cpu())
                 for k, p in m.named_parameters()} for n, m in nets}
    return metrics, pre, post, grads, seconds


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    norm = float(a.norm() * b.norm())
    if norm == 0.0:
        return 1.0 if not (a.any() or b.any()) else 0.0
    return float(a @ b) / norm


def step_disagreements(got, want, loss_atol=LOSS_ATOL, loss_rtol=0.0,
                       stats_atol=STATS_ATOL, min_cosine=MIN_GRAD_COSINE):
    """Where two results of :func:`step_once` from the same weights
    disagree beyond the limits: losses (atol ``loss_atol`` plus
    ``loss_rtol`` of the loss), BatchNorm running statistics (atol
    ``stats_atol``) and the per-tensor gradient cosine (above
    ``min_cosine``); the float32 limits by default. Returns (failures,
    worst): a message per failed check, and the worst reading of each kind,
    the loss as |difference| and as |difference| / |loss|."""
    bad = []
    worst = {"loss": 0.0, "loss_rel": 0.0, "stats": 0.0, "grad_cosine": 1.0}
    for k in sorted(want[0]):
        err = abs(got[0][k] - want[0][k])
        worst["loss"] = max(worst["loss"], err)
        worst["loss_rel"] = max(worst["loss_rel"],
                                err / max(abs(want[0][k]), 1e-12))
        if err > loss_atol + loss_rtol * abs(want[0][k]):
            bad.append(f"loss {k}: {got[0][k]:.6f} vs {want[0][k]:.6f}")
    for net in want[2]:
        for k in want[2][net]:
            if k.endswith(("running_mean", "running_var")):
                err = float((got[2][net][k] - want[2][net][k]).abs().max())
                worst["stats"] = max(worst["stats"], err)
                if err > stats_atol:
                    bad.append(f"{net}:{k} running statistic off by {err:.3e}")
        for k in want[3][net]:
            gcos = _cosine(got[3][net][k], want[3][net][k])
            worst["grad_cosine"] = min(worst["grad_cosine"], gcos)
            if gcos <= min_cosine:
                bad.append(f"{net}:{k} gradient cosine {gcos:.6f}")
    return bad, worst


def delta_readings(got, want):
    """The Adam-delta measures of tests/test_step_parity.py for two results
    of :func:`step_once`, worst tensor of each: delta cosine, mean
    |difference| in lr, share of elements apart by more than 0.5 lr."""
    cos, mean_lr, flip = 1.0, 0.0, 0.0
    for net in want[3]:
        pre = want[1][net]
        for k in want[3][net]:
            dg = got[2][net][k] - pre[k]
            dw = want[2][net][k] - pre[k]
            diff = (dg - dw).abs() / LR
            cos = min(cos, _cosine(dg, dw))
            mean_lr = max(mean_lr, float(diff.mean()))
            flip = max(flip, float((diff > 0.5).float().mean()))
    return cos, mean_lr, flip


def phase_step():
    log(f"phase 8/52 step: one full-width train step, batch {STEP_BATCH}, "
        "card against CPU")
    data = synthetic_multimnist(STEP_BATCH, seed=5)
    z = np.random.RandomState(6).randn(STEP_BATCH, MNIST.z_dim).astype(
        np.float32)
    # A first Adam step is about lr * sign(grad): an element whose gradient
    # is within float32 noise of zero moves a full lr either way, and the
    # G update runs through the D just updated so. At full width the deltas
    # miss tests/test_step_parity.py's limits from either set of weights
    # (see PERF.md); they are printed, and the gradients are held.
    for label, randomized in (("reference init", False),
                              ("tests/test_step_parity.py weights", True)):
        cpu = step_once("cpu", data, z, randomized=randomized)
        card = step_once(DEVICE, data, z, randomized=randomized)
        bad, worst = step_disagreements(card, cpu)
        log(f"  from the {label}: step on the CPU {cpu[4]:.1f} s "
            f"({torch.get_num_threads()} threads), on the card "
            f"{card[4]:.2f} s (host clock, first call)")
        for k in sorted(cpu[0]):
            log(f"    {k}: card {card[0][k]:.6f}, CPU {cpu[0][k]:.6f}")
        log(f"    worst card vs CPU: loss {worst['loss']:.3e} (atol "
            f"{LOSS_ATOL:g}); BatchNorm running stats {worst['stats']:.3e} "
            f"(atol {STATS_ATOL:g}); per-tensor gradient cosine "
            f"{worst['grad_cosine']:.8f} (limit {MIN_GRAD_COSINE:g})")
        cos, mean_lr, flip = delta_readings(card, cpu)
        log(f"    Adam deltas, worst tensor (read, not held): cosine "
            f"{cos:.8f}, mean |difference| {mean_lr:.5f} lr, {flip:.4%} of "
            "the elements apart by more than 0.5 lr")
        for msg in bad:
            log(f"    FAILED {msg}")
        check(not bad, f"train step card vs CPU from the {label}: "
              f"{len(bad)} checks failed")


def phase_step_time(cfg=MNIST, phase="9/52 steptime", runs: int = 20,
                    data=None):
    kind = "bf16" if cfg.compute_dtype == torch.bfloat16 else (
        "float32 with TF32 off (matmul and cuDNN)")
    log(f"phase {phase}: the train step at batch {STEP_BATCH} on the card, "
        f"{kind}")
    dev = torch.device(DEVICE)
    state = create_state(cfg, seed=0, device=dev)
    if data is None:
        data = synthetic_multimnist(STEP_BATCH, seed=8)
    data = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    step = make_train_step(cfg, KL_COEFF)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(3):
        step(state, data, gen, LR, LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.reset_launch_count()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(state, data, gen, LR, LR)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    per_step = (k1.launch_count() / runs, k1.grad_launch_count() / runs)
    ms = statistics.median(times)
    check(all(bool(torch.isfinite(v)) for v in metrics.values()),
          "non-finite losses while timing")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{cfg.variant} train step at batch {STEP_BATCH}, full width, {kind}: "
        f"{ms:.2f} ms "
        f"(CUDA events, median of {runs}; min {min(times):.2f}, max "
        f"{max(times):.2f}) = {STEP_BATCH * 1e3 / ms:.0f} images/s; peak "
        f"memory {peak:.2f} GiB; launches per step: K1 {per_step[0]:g}, K2 "
        f"{per_step[1]:g}")
    check(per_step == (4, 4), f"K1/K2 launches per step {per_step} != (4, 4)")
    return {"ms": ms, "images_per_s": STEP_BATCH * 1e3 / ms,
            "peak_gib": peak, "launches_per_step": per_step}


def train_entry(flags=(), variant="multi-mnist", steps=4):
    """cli/main.py for one synthetic epoch of ``variant`` on the card with
    ``flags``, its data and output in the work directory; returns its K1,
    K2 and K4 launches, held at 4 a step and 1 for the epoch grid, 4 a
    step, and 0."""
    cfg = FAMILY_CFGS.get(variant, os.path.join(ROOT, "cfg",
                                                "mnist_train.yml"))
    out = os.path.join(WORK, "entry", variant + "".join(flags).replace(
        os.sep, "_"))
    k1.reset_launch_count()
    k4.reset_launch_count()
    hist = train_main.main(["--variant", variant, "--cfg", cfg,
                            "--synthetic", "--max_epochs", "1",
                            "--manualSeed", "7", "--device", DEVICE,
                            "--data_dir", os.path.join(WORK, "data", variant),
                            "--img_dir", os.path.join(WORK, "imgs", variant),
                            "--output_dir", out, *flags])
    torch.cuda.synchronize()
    launches = (k1.launch_count(), k1.grad_launch_count(), k4.launch_count())
    shutil.rmtree(out)
    check(len(hist) == 1 and hist[0]["steps"] == steps,
          f"one epoch of {steps} steps expected, got {hist}")
    losses = {k: v for k, v in hist[0].items()
              if k not in ("steps", "seconds")}
    check(all(np.isfinite(v) for v in losses.values()),
          f"non-finite losses {losses}")
    log(f"train entry {variant} {' '.join(flags) or '(float32)'}: "
        f"{hist[0]['steps']} "
        f"steps in {hist[0]['seconds']:.2f} s (host clock, first epoch, cuDNN "
        f"set-up included); K1 launches {launches[0]}, K2 launches "
        f"{launches[1]}, K4 launches {launches[2]}; mean losses "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(losses.items())))
    want = (4 * steps + 1, 4 * steps, 0)
    check(launches == want, f"K1/K2/K4 launches {launches} != {want} for "
          f"{steps} steps and one epoch grid")
    return launches


def phase_train_entry():
    log("phase 10/52 train: cli/main.py, one synthetic epoch on the card")
    return train_entry()


def _ulp_bf16(t: torch.Tensor) -> float:
    """One bf16 ulp at the largest |value| of ``t``."""
    m = float(t.float().abs().max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


# K4 at shapes that stress its tiling (name, B, H, W, Cin, Cout): M not a
# multiple of the 128-row tile, Cout not a multiple of the N tile, the
# smallest Cin the wrapper takes (one masked tail slice), Cin not a multiple
# of 64 with Cout below 128, and the largest Cin with two N tiles. Each has
# M of 450 or more: the plain chain sums its bf16 y, whose rounding errors
# cancel less over a few dozen pixels (a 32-pixel case read 1.3e-3 of the
# largest sum of squares against the f32 sums)
K4_EDGE_SHAPES = [("M = 455, not a multiple of 128", 13, 7, 5, 64, 64),
                  ("Cout 136, not a multiple of 256", 8, 16, 16, 128, 136),
                  ("Cin 8, the smallest", 16, 5, 6, 8, 8),
                  ("Cin 72 -> Cout 24", 16, 6, 6, 72, 24),
                  ("Cin 1024, the largest, Cout 264", 8, 8, 8, 1024, 264)]
# gamma 0 and beta 0.5 in channel 0: normalized 0.5 in the image, and the
# zero padding of the normalized tensor on the border (not relu(beta))
K4_ZERO_GAMMA_SHAPE = ("gamma 0, beta 0.5 in channel 0", 16, 6, 6, 64, 64)


def k4_inputs(shape, seed, device, zero_gamma=False):
    """The spike tool's inputs at ``shape``; with ``zero_gamma`` channel 0
    folds to scale 0, shift 0.5."""
    x, scale, shift, w = spike_normconv.make_inputs(shape, seed, device)
    if zero_gamma:
        scale[0], shift[0] = 0.0, 0.5
    return x, scale, shift, w


def check_k4(name, shape, args):
    """K4 against its plain version on ``args``, and again for the same
    sums; returns max |dy|."""
    got = k4.normconv(*args)
    want = k4.normconv_plain(*args)
    again = k4.normconv(*args)
    torch.cuda.synchronize()
    dy, scale, rs, rq = spike_normconv.disagreement(got, want)
    ulp = _ulp_bf16(want[0])
    same = bool(torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
                and torch.equal(got[0], again[0]))
    log(f"  {name} {tuple(shape)}: max |y - plain| = {dy:.4g} ({dy / ulp:g}"
        f" bf16 ulp of max |y| {scale:.4g}; limit {BF16_ULPS}); sums "
        f"{rs:.2e}, squares {rq:.2e} of their max (limit {K4_SUM_RTOL:g}); "
        f"a second run bit-identical: {same}")
    check(bool(torch.isfinite(got[0].float()).all()), f"K4 non-finite "
          f"({name})")
    check(dy <= BF16_ULPS * ulp, f"K4 y disagrees at {name}")
    check(rs <= K4_SUM_RTOL and rq <= K4_SUM_RTOL,
          f"K4 sums disagree at {name}")
    check(same, f"K4 gave another result on a second run at {name}")
    return dy


def time_k4(name, shape, args):
    """K4, its plain chain and cuDNN's bf16 ``F.conv2d`` (NCHW, the
    yardstick; the port never calls it) in turns: plain, K4, cuDNN, cuDNN,
    K4, plain, each reading a run of 50 calls (:func:`run_ms`)."""
    x, scale, shift, w = args
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    w_oihw = w.permute(3, 2, 0, 1).contiguous()

    def kernel():
        return k4.normconv(x, scale, shift, w)

    def plain():
        return k4.normconv_plain(x, scale, shift, w)

    def conv():
        return torch.nn.functional.conv2d(x_nchw, w_oihw, padding=1)

    t = in_turns([("plain", plain), ("kernel", kernel), ("library", conv),
                  ("library", conv), ("kernel", kernel), ("plain", plain)])
    ms, plain_ms, lib_ms = (statistics.mean(t[k])
                            for k in ("kernel", "plain", "library"))
    bound_ms, bound_by, flops, _ = spike_normconv.bound(shape)
    log(f"  {name} {tuple(shape)} in turns (plain, K4, cuDNN, cuDNN, K4, "
        f"plain; CUDA events around 50 calls back to back each): "
        f"K4 {t['kernel'][0]:.4f}, {t['kernel'][1]:.4f} ms = "
        f"{flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.1%} of the "
        f"{bound_ms:.4f} ms {bound_by} bound; plain chain {t['plain'][0]:.4f}"
        f", {t['plain'][1]:.4f} ms; cuDNN bf16 F.conv2d {t['library'][0]:.4f}"
        f", {t['library'][1]:.4f} ms; K4 takes {ms / lib_ms:.2f}x cuDNN's "
        f"time and {ms / plain_ms:.2f}x the plain chain's")
    return {"shape": name, "dims": list(shape), "ms": ms,
            "ms_turns": t["kernel"], "plain_ms": plain_ms,
            "plain_ms_turns": t["plain"], "library_ms": lib_ms,
            "library_ms_turns": t["library"], "bound_ms": bound_ms,
            "bound_by": bound_by, "tflops": flops / ms / 1e9,
            "share_of_bound": bound_ms / ms}


def phase_normconv():
    log("phase 11/52 normconv: K4's path (the port's spike tool), and K4 "
        "against its plain version, on the card")
    dev = torch.device(DEVICE)
    k4.reset_launch_count()
    spike_normconv.run(dev)
    torch.cuda.synchronize()
    tool_launches = k4.launch_count()
    want = len(spike_normconv.CHECK_SHAPES) + len(spike_normconv.HOT_SHAPES) \
        * (spike_normconv.WARMUP + spike_normconv.RUNS)
    check(tool_launches == want, f"the spike tool launched K4 "
          f"{tool_launches} times, {want} expected")
    log(f"tools/spike_normconv.py (check, then bench): K4 launches "
        f"{tool_launches} = {len(spike_normconv.CHECK_SHAPES)} checks + "
        f"{len(spike_normconv.HOT_SHAPES)} hot shapes x "
        f"({spike_normconv.WARMUP} warm-up + {spike_normconv.RUNS} timed)")
    worst = 0.0
    shapes = spike_normconv.CHECK_SHAPES + spike_normconv.HOT_SHAPES \
        + K4_EDGE_SHAPES
    for i, (name, *shape) in enumerate(shapes):
        args = k4_inputs(shape, 100 + i, dev)
        worst = max(worst, check_k4(name, shape, args))
    name, *shape = K4_ZERO_GAMMA_SHAPE
    args = k4_inputs(shape, 99, dev, zero_gamma=True)
    worst = max(worst, check_k4(name, shape, args))
    rows = [time_k4(name, shape, k4_inputs(shape, 1, dev))
            for name, *shape in spike_normconv.HOT_SHAPES]
    return {"max_abs_err": worst, "launches": tool_launches, "rows": rows}


def _boxes(rs, b, o, kind):
    return _service_boxes(rs, b, o) if kind == "service" else _grad_boxes(
        rs, b, o, kind)


def phase_bf16_kernels():
    log("phase 12/52 bf16: K1 and K2 in bf16 against their plain versions, "
        "on the card")
    rs = np.random.RandomState(13)
    dev = torch.device(DEVICE)
    cases = [  # (label, timed as, B, C, input side, boxes, output side)
        ("serve", "serve", 64, 256, 16, "service", 16),
        ("train G", "train G", STEP_BATCH, 256, 16, "train", 16),
        ("train D, 15x15", "train D", STEP_BATCH, 128, 15, "train", 16),
        ("padded objects", None, STEP_BATCH, 256, 16, "padded", 16),
        ("boxes partly off the canvas", None, STEP_BATCH, 256, 16,
         "off-canvas", 16),
        ("boxes wider than the canvas", None, STEP_BATCH, 256, 16, "wide", 16),
        ("boxes wider than the canvas, 15x15", None, STEP_BATCH, 128, 15,
         "wide", 16),
        ("37 channels, a tile of 16 and one of 5", None, 64, 37, 16, "train",
         16),
    ] + [(label, None, b, c, hw[0], kind, side)
         for label, (b, _, c, hw, kind), side in K1_TILE_EDGES]
    out = {"place": {"max_abs_err": 0.0}, "grad": {"max_abs_err": 0.0}}
    for label, timed, b, c, side, kind, out_side in cases:
        hw = (side, side)
        bbox = torch.from_numpy(_boxes(rs, b, 3, kind)).to(dev)
        feats = torch.from_numpy(rs.randn(b, 3, c, side, side).astype(
            np.float32)).to(dev).bfloat16()
        g = torch.from_numpy(rs.uniform(-1, 1, (b, c, out_side, out_side))
                             .astype(np.float32)).to(dev).bfloat16()
        for kernel, run, plain, arg, hw_arg in (
                ("place", k1.stn_place_multi_nchw, k1.stn_place_multi_plain,
                 feats, (out_side, out_side)),
                ("grad", k1.stn_place_multi_grad_nchw,
                 k1.stn_place_multi_grad_plain, g, hw)):
            got = run(arg, bbox, hw_arg)
            want = plain(arg, bbox, hw_arg)
            torch.cuda.synchronize()
            check(got.dtype == torch.bfloat16, f"{kernel} returned {got.dtype}")
            err = float((got.float() - want.float()).abs().max())
            ulp = _ulp_bf16(want)
            out[kernel]["max_abs_err"] = max(out[kernel]["max_abs_err"], err)
            name = "K1" if kernel == "place" else "K2"
            log(f"  {name} {label}: {tuple(arg.shape)}: max |kernel - plain| "
                f"= {err:.3e} ({err / ulp:g} bf16 ulp of the largest |value|;"
                f" limit {BF16_ULPS})")
            check(err <= BF16_ULPS * ulp,
                  f"{name} bf16 disagrees with its plain version ({label})")
            check(bool(torch.isfinite(got.float()).all()),
                  f"{name} bf16 non-finite ({label})")
            if kind == "padded":
                check(int(torch.count_nonzero(got[::2])) == 0,
                      f"{name} bf16: padded items must give exact zeros")
            if timed is None or (kernel == "grad" and timed == "serve"):
                continue
            if kernel == "grad":
                out[kernel][timed] = time_grad(arg, bbox, hw,
                                               f"K2 bf16 at the {timed} shape")
                continue
            out[kernel][timed] = time_place(arg, bbox, (16, 16),
                                            f"K1 bf16 at the {timed} shape")
    check_side_limit(dev, torch.bfloat16)
    return out


def phase_step_bf16():
    log(f"phase 13/52 step16: one full-width bf16 train step, batch "
        f"{STEP16_BATCH}, card against CPU")
    data = synthetic_multimnist(STEP16_BATCH, seed=5)
    z = np.random.RandomState(6).randn(STEP16_BATCH, BF16.z_dim).astype(
        np.float32)
    cpu = step_once("cpu", data, z, BF16, randomized=True)
    card = step_once(DEVICE, data, z, BF16, randomized=True)
    bad, worst = step_disagreements(
        card, cpu, loss_atol=0.0, loss_rtol=BF16_LOSS_RTOL,
        stats_atol=BF16_STATS_ATOL, min_cosine=BF16_MIN_GRAD_COSINE)
    log(f"  from the tests/test_step_parity.py weights: bf16 step on the CPU "
        f"{cpu[4]:.1f} s ({torch.get_num_threads()} threads), on the card "
        f"{card[4]:.2f} s (host clock, first call)")
    for k in sorted(cpu[0]):
        log(f"    {k}: card {card[0][k]:.6f}, CPU {cpu[0][k]:.6f}")
    log(f"    worst card vs CPU: loss {worst['loss_rel']:.3e} relative "
        f"(limit {BF16_LOSS_RTOL:g}); BatchNorm running stats "
        f"{worst['stats']:.3e} (atol {BF16_STATS_ATOL:g}); per-tensor "
        f"gradient cosine {worst['grad_cosine']:.8f} (limit "
        f"{BF16_MIN_GRAD_COSINE:g})")
    cosines = sorted((_cosine(card[3][n][k], cpu[3][n][k]), f"{n}:{k}")
                     for n in ("G", "D") for k in cpu[3][n])
    log("    lowest per-tensor gradient cosines: " + ", ".join(
        f"{k} {c:.6f}" for c, k in cosines[:4]))
    for msg in bad:
        log(f"    FAILED {msg}")
    check(not bad, f"bf16 train step card vs CPU: {len(bad)} checks failed")
    return worst


def _served_images(port, items):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/generate", body=json.dumps({"items": items}))
        resp = conn.getresponse()
        status, body = resp.status, json.loads(resp.read())
    finally:
        conn.close()
    check(status == 200 and len(body["images"]) == len(items),
          f"bf16 request: {status}")
    return [_png_gray64(b) for b in body["images"]]


def phase_entry_bf16():
    log("phase 15/52 entry16: cli/main.py --bf16 and --bn_groups 2, and a "
        "64-item request served with --bf16")
    launches = {"train_bf16": train_entry(["--bf16"]),
                "train_bn_groups_2": train_entry(["--bn_groups", "2"])}
    rs = np.random.RandomState(2)
    items, boxes = [], []
    for _ in range(64):
        n = int(rs.randint(1, 4))
        w, h = rs.uniform(0.25, 0.4, n), rs.uniform(0.25, 0.4, n)
        bb = np.stack([rs.uniform(0, 1 - w), rs.uniform(0, 1 - h), w, h],
                      -1).round(4).tolist()
        items.append({"labels": rs.randint(0, 10, n).tolist(), "bboxes": bb})
        boxes.append(bb)
    k1.reset_launch_count()
    args = argparse.Namespace(variant="multi-mnist", cfg="", net_g=CKPT,
                              seed=0, device=DEVICE, bf16=True,
                              host="127.0.0.1", port=0, max_wait_ms=5.0)
    httpd = serve(args, build_service(args))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        t = time.perf_counter()
        imgs16 = _served_images(httpd.server_address[1], items)
        latency_ms = (time.perf_counter() - t) * 1e3
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.batcher.close()
        thread.join(timeout=30)
    svc16 = httpd.service
    serve_launches = (k1.launch_count(), k1.grad_launch_count())
    check(svc16.mcfg.compute_dtype == torch.bfloat16, "served in bf16")
    check(serve_launches[0] == svc16.device_batches == 2,
          f"the bf16 request took {svc16.device_batches - 1} device batches "
          f"and {serve_launches[0]} K1 launches, warm-up included; one each "
          "expected")
    check(serve_launches[1] == 0,
          f"bf16 serving launched K2 {serve_launches[1]} times")
    # the float32 service draws the same z: one warm-up batch, then this one
    svc32 = Stage1Service(MNIST, CKPT, seed=0, device=DEVICE)
    imgs32 = [_png_gray64(b) for b in svc32.run(items)]
    diff = np.abs(np.stack(imgs16).astype(np.float32)
                  - np.stack(imgs32).astype(np.float32)) / 127.5
    sep = [np.subtract(*_separation(u8[None], [bb]))
           for u8, bb in zip(imgs16, boxes)]
    log(f"64-item request with --bf16: {latency_ms:.1f} ms over HTTP (host "
        f"clock); against the float32 image of the card: mean |diff| "
        f"{diff.mean():.4f}, max {diff.max():.4f} in [-1, 1] units (limit "
        f"mean {MAX_BF16_SERVE_MEAN_DIFF:g}); separation mean "
        f"{np.mean(sep):.3f} (need > {MIN_BF16_SEPARATION}); K1 launches "
        f"{serve_launches[0]} for {svc16.device_batches} device batches, K2 "
        f"launches {serve_launches[1]}")
    check(float(diff.mean()) <= MAX_BF16_SERVE_MEAN_DIFF,
          "bf16 served images stray from the float32 ones")
    check(float(np.mean(sep)) > MIN_BF16_SEPARATION,
          "bf16 served images do not place content in the requested boxes")
    launches["serve_bf16"] = serve_launches
    return launches, float(diff.mean())


# ---------------------------------------------- CLEVR and COCO-StackGAN-1


def family_cfg(variant, dtype=None):
    """The family's model config at the published widths of its train cfg
    (clevr: ngf 768, ndf 48, 4 objects; coco-stackgan-1: ngf 1536, ndf 96,
    the CA net)."""
    return stage1_model_config(cfg_from_file(FAMILY_CFGS[variant], variant),
                               variant, compute_dtype=dtype)


def family_data(variant, b, seed):
    """b items of the family's synthetic train set as the train entry
    draws them (clevr: 2-4 objects, a padded object -1 with its pad
    one-hots; coco: 1-3 objects), coco's with one caption embedding."""
    if variant == "clevr":
        return synthetic_clevr(b, seed=seed)
    data = synthetic_coco(b, seed=seed)
    data["text_embedding"] = data["text_embedding"][:, 0].copy()
    return data


def family_shapes(variant):
    """The family's place shapes on the train step: G (O, ngf // 4, 16x16)
    and D (O, 2 * ndf, 15x15), each onto 16x16."""
    mcfg = family_cfg(variant)
    return {"G": (mcfg.num_objects, mcfg.ngf // 4, (16, 16)),
            "D": (mcfg.num_objects, 2 * mcfg.df_dim, (15, 15))}


def _family_boxes(rs, variant, b, kind):
    """The family's train boxes; ``padded4``: every item's fourth object
    padded; ``off-canvas``: boxes that stick out on every side."""
    o = family_shapes(variant)["G"][0]
    if kind == "off-canvas":
        return _grad_boxes(rs, b, o, "off-canvas")
    if kind == "serve":
        return _service_boxes(rs, b, o)
    bbox = family_data(variant, b, int(rs.randint(1 << 30)))["bbox"]
    if kind == "padded4":
        bbox[:, 3] = -1.0
    return bbox


def _held(got, want, dtype, name, label):
    """A kernel against its plain version: KERNEL_ATOL in float32,
    BF16_ULPS ulps of the largest |value| in bf16. Returns the error."""
    torch.cuda.synchronize()
    check(got.dtype == dtype, f"{name} returned {got.dtype}")
    check(bool(torch.isfinite(got.float()).all()), f"{name} non-finite "
          f"({label})")
    err = float((got.float() - want.float()).abs().max())
    if dtype == torch.float32:
        limit, unit = KERNEL_ATOL, f"atol {KERNEL_ATOL:g}"
    else:
        ulp = _ulp_bf16(want)
        limit, unit = BF16_ULPS * ulp, (f"{err / ulp:g} bf16 ulp of the "
                                        f"largest |value|; limit {BF16_ULPS}")
    log(f"  {name} {label}: max |kernel - plain| = {err:.3e} ({unit})")
    check(err <= limit, f"{name} disagrees with its plain version ({label})")
    return err


def phase_family_kernels():
    log("phase 16/52 families: K1 and K2 at the CLEVR and COCO-StackGAN-1 "
        "shapes against their plain versions, f32 and bf16, and timed")
    rs = np.random.RandomState(16)
    dev = torch.device(DEVICE)
    for o in (3, 4):
        for es in (4, 2):
            for hw in ((16, 16), (15, 15)):
                smem = k1.place_smem_bytes(o, k1.place_tile(hw, (16, 16)),
                                           hw, (16, 16), es)
                gsmem = k1.grad_smem_bytes(o, k1.grad_tile(hw, (16, 16)),
                                           hw, (16, 16))
                check(smem <= k1.MAX_PLACE_SMEM and gsmem <= k1.MAX_GRAD_SMEM,
                      f"shared memory at {o} objects, {hw}: K1 {smem}, K2 "
                      f"{gsmem}")
    log(f"  shared memory at 4 objects: K1 {k1.place_smem_bytes(4, 16, (16, 16), (16, 16), 4)} "
        f"B (f32, 16x16), K2 {k1.grad_smem_bytes(4, 16, (16, 16), (16, 16))} B; "
        f"limits {k1.MAX_PLACE_SMEM}, {k1.MAX_GRAD_SMEM}")
    cases = [  # (family, path, boxes, batch)
        ("clevr", "G", "train", STEP_BATCH), ("clevr", "D", "train",
                                              STEP_BATCH),
        ("clevr", "G", "padded4", STEP_BATCH),
        ("clevr", "D", "padded4", STEP_BATCH),
        ("clevr", "G", "off-canvas", STEP_BATCH),
        ("clevr", "G", "serve", 64),
        ("coco-stackgan-1", "G", "train", STEP_BATCH),
        ("coco-stackgan-1", "D", "train", STEP_BATCH),
        ("coco-stackgan-1", "G", "off-canvas", STEP_BATCH),
        ("coco-stackgan-1", "G", "serve", 64)]
    out = {k: {"max_abs_err": 0.0, "max_abs_err_bf16": 0.0}
           for k in ("place", "grad")}
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype)[6:]
        worst = "max_abs_err" if dtype == torch.float32 else \
            "max_abs_err_bf16"
        for variant, path, kind, b in cases:
            o, c, hw = family_shapes(variant)[path]
            bbox = torch.from_numpy(_family_boxes(rs, variant, b, kind)).to(dev)
            feats = torch.from_numpy(rs.randn(b, o, c, *hw).astype(
                np.float32)).to(dev).to(dtype)
            g = torch.from_numpy(rs.uniform(-1, 1, (b, c, 16, 16)).astype(
                np.float32)).to(dev).to(dtype)
            label = f"{variant} {path} {kind}, {tname}"
            got = k1.stn_place_multi_nchw(feats, bbox, (16, 16))
            err = _held(got, k1.stn_place_multi_plain(feats, bbox, (16, 16)),
                        dtype, "K1", f"{label} {tuple(feats.shape)}")
            out["place"][worst] = max(out["place"][worst], err)
            dg = k1.stn_place_multi_grad_nchw(g, bbox, hw)
            err = _held(dg, k1.stn_place_multi_grad_plain(g, bbox, hw), dtype,
                        "K2", f"{label} {tuple(g.shape)} -> {tuple(dg.shape)}")
            out["grad"][worst] = max(out["grad"][worst], err)
            if kind == "padded4":
                three = k1.stn_place_multi_nchw(
                    feats[:, :3].contiguous(), bbox[:, :3].contiguous(),
                    (16, 16))
                dg3 = k1.stn_place_multi_grad_nchw(
                    g, bbox[:, :3].contiguous(), hw)
                torch.cuda.synchronize()
                check(torch.equal(got, three), "K1: a padded fourth object "
                      "changed the sums of the first three")
                check(int(torch.count_nonzero(dg[:, 3])) == 0
                      and torch.equal(dg[:, :3], dg3),
                      "K2: a padded fourth object must get exact zeros")
                log(f"  {label}: K1 equal bit for bit to the first three "
                    "objects alone; K2 exact zeros for the fourth")
            if kind != "train":
                continue
            key = f"{variant} {path}"
            out["place"].setdefault(tname, {})[key] = time_place(
                feats, bbox, (16, 16), f"K1 {tname} at the {key} shape")
            out["grad"].setdefault(tname, {})[key] = time_grad(
                g, bbox, hw, f"K2 {tname} at the {key} shape")
    return out


def phase_family_step():
    log(f"phase 17/52 fstep: one full-width float32 train step of each "
        f"family, batch {FAMILY_STEP_BATCH} on both sides, card against CPU")
    worst = {}
    for variant in FAMILY_CFGS:
        mcfg = family_cfg(variant)
        data = family_data(variant, FAMILY_STEP_BATCH, 5)
        rs = np.random.RandomState(6)
        z = rs.randn(FAMILY_STEP_BATCH, mcfg.z_dim).astype(np.float32)
        eps = rs.randn(FAMILY_STEP_BATCH, mcfg.condition_dim).astype(
            np.float32) if mcfg.use_ca else None
        cpu = step_once("cpu", data, z, mcfg, eps=eps)
        card = step_once(DEVICE, data, z, mcfg, eps=eps)
        bad, worst[variant] = step_disagreements(card, cpu)
        w = worst[variant]
        log(f"  {variant} (ngf {mcfg.ngf}, ndf {mcfg.df_dim}, "
            f"{mcfg.num_objects} objects), from the reference init, batch "
            f"{FAMILY_STEP_BATCH}: step on the CPU {cpu[4]:.1f} s "
            f"({torch.get_num_threads()} threads), on the card {card[4]:.2f} "
            "s (host clock, first call)")
        for k in sorted(cpu[0]):
            log(f"    {k}: card {card[0][k]:.6f}, CPU {cpu[0][k]:.6f}")
        log(f"    worst card vs CPU: loss {w['loss']:.3e} (atol "
            f"{LOSS_ATOL:g}); BatchNorm running stats {w['stats']:.3e} (atol "
            f"{STATS_ATOL:g}); per-tensor gradient cosine "
            f"{w['grad_cosine']:.8f} (limit {MIN_GRAD_COSINE:g})")
        cos, mean_lr, flip = delta_readings(card, cpu)
        log(f"    Adam deltas, worst tensor (read, not held): cosine "
            f"{cos:.8f}, mean |difference| {mean_lr:.5f} lr, {flip:.4%} of "
            "the elements apart by more than 0.5 lr")
        for msg in bad:
            log(f"    FAILED {msg}")
        check(not bad, f"{variant} train step card vs CPU: {len(bad)} checks "
              "failed")
        check(("kl_loss" in card[0]) == mcfg.use_ca, "kl_loss reported under "
              "the CA net only")
    return worst


def phase_family_step_time():
    log("phase 18/52 ftime: each family's train step at batch "
        f"{STEP_BATCH} on the card, float32 and bf16")
    out = {}
    for variant in FAMILY_CFGS:
        data = family_data(variant, STEP_BATCH, 8)
        for dtype in (None, torch.bfloat16):
            key = f"{variant} {'bf16' if dtype else 'f32'}"
            out[key] = phase_step_time(family_cfg(variant, dtype),
                                       f"18/52 ftime, {key}",
                                       FAMILY_TIME_RUNS, data)
    return out


def phase_family_entry():
    log("phase 19/52 fentry: cli/main.py --synthetic --max_epochs 1 for "
        "clevr (float32) and coco-stackgan-1 (--bf16)")
    steps = {}
    for variant in FAMILY_CFGS:
        batch = train_settings(cfg_from_file(FAMILY_CFGS[variant],
                                             variant)).batch_size
        steps[variant] = train_main.synthetic_items(variant, batch) // batch
    return {"train_clevr": train_entry((), "clevr", steps["clevr"]),
            "train_coco_bf16": train_entry(["--bf16"], "coco-stackgan-1",
                                           steps["coco-stackgan-1"])}


def _family_items(variant, rs, n):
    """n request items: clevr 4 objects as two-hot shape + colour rows,
    coco 1-3 objects with a text embedding of 1024 values."""
    items = []
    for _ in range(n):
        k = 4 if variant == "clevr" else int(rs.randint(1, 4))
        w, h = rs.uniform(0.2, 0.35, k), rs.uniform(0.2, 0.35, k)
        boxes = np.stack([rs.uniform(0, 1 - w), rs.uniform(0, 1 - h), w, h],
                         -1).round(4).tolist()
        if variant == "clevr":
            labels = []
            for _ in range(k):
                row = [0.0] * 13
                row[int(rs.randint(3))] = 1.0
                row[4 + int(rs.randint(8))] = 1.0
                labels.append(row)
            items.append({"labels": labels, "bboxes": boxes})
        else:
            items.append({"labels": rs.randint(0, 80, k).tolist(),
                          "bboxes": boxes,
                          "text_embedding": rs.randn(1024).round(5).tolist()})
    return items


def phase_family_serve():
    log("phase 20/52 fserve: each family's Stage1G card against CPU, and "
        "its service over HTTP on the card, from seeded weights")
    launches, latency = {}, {}
    for variant in FAMILY_CFGS:
        mcfg = family_cfg(variant)
        # the weights of tests/test_step_parity.py (randomize): the
        # reference init's images are near constant
        g_cpu = randomize(build_stage1_g(mcfg, seed=0, device="cpu"), 3)
        g_gpu = build_stage1_g(mcfg, g_cpu.state_dict(), device=DEVICE)
        rs = np.random.RandomState(20)
        data = family_data(variant, 64, 21)
        args = [torch.from_numpy(rs.randn(64, mcfg.z_dim).astype(np.float32)),
                torch.from_numpy(data["bbox"]),
                torch.from_numpy(data["label_onehot"])]
        if mcfg.use_ca:
            args.append(torch.from_numpy(data["text_embedding"]))
        with torch.inference_mode():
            on_gpu = g_gpu(*(a.to(DEVICE) for a in args)).cpu()
            on_cpu = g_cpu(*args)
            fwd_ms = cuda_ms(lambda: g_gpu(*(a.to(DEVICE) for a in args)),
                             warmup=3, runs=20)
        diff = float((on_gpu - on_cpu).abs().max())
        log(f"  {variant} Stage1G (ngf {mcfg.ngf}, seeded weights) card vs "
            f"CPU, batch 64, eval: max |diff| {diff:.3e} (atol "
            f"{MODEL_ATOL:g}); image std {float(on_gpu.std()):.4f}; forward "
            f"at batch 64 {fwd_ms:.3f} ms (CUDA events, median of 20)")
        check(bool(torch.isfinite(on_gpu).all()), f"{variant}: non-finite "
              "image values")
        check(diff <= MODEL_ATOL, f"{variant}: card and CPU disagree: "
              f"{diff:.3e}")

        k1.reset_launch_count()
        svc = Stage1Service(mcfg, "", seed=0, device=DEVICE)
        svc.g.load_state_dict(g_cpu.state_dict())
        httpd = serve(argparse.Namespace(variant=variant, host="127.0.0.1",
                                         port=0, max_wait_ms=5.0), svc)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        port = httpd.server_address[1]
        try:
            items = _family_items(variant, rs, 8)
            t = time.perf_counter()
            status, body = _post(port, {"items": items})
            ms = (time.perf_counter() - t) * 1e3
            check(status == 200 and len(body["images"]) == 8,
                  f"{variant} request: {status} {body.get('error')}")
            served = np.stack([_png_gray64(b, 3) for b in body["images"]])
            bad = dict(items[0])
            if variant == "clevr":
                bad["labels"] = bad["labels"] + [bad["labels"][0]]
                bad["bboxes"] = bad["bboxes"] + [bad["bboxes"][0]]
            else:
                bad["text_embedding"] = bad["text_embedding"][:1023]
            status_bad, body_bad = _post(port, {"items": [bad]})
            check(status_bad == 400, f"{variant}: a bad item got "
                  f"{status_bad}, not 400")
        finally:
            httpd.shutdown()
            httpd.server_close()
            httpd.batcher.close()
            thread.join(timeout=30)
        got = (k1.launch_count(), k1.grad_launch_count())
        # the same items through the CPU generator, with the z the service
        # drew (its second batch of its seeded generator, after the warm-up)
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        z = [torch.randn((svc.max_batch, mcfg.z_dim), generator=gen,
                         device=DEVICE) for _ in range(2)][1][:8].cpu()
        lay = [_item_layout(it, mcfg.num_objects, mcfg.label_dim, rs)
               for it in items]
        cargs = [z, torch.from_numpy(np.stack([x[1] for x in lay])),
                 torch.from_numpy(np.stack([x[0] for x in lay]))]
        if mcfg.use_ca:
            cargs.append(torch.tensor([it["text_embedding"] for it in items],
                                      dtype=torch.float32))
        with torch.inference_mode():
            want = to_uint8(g_cpu(*cargs).permute(0, 2, 3, 1).numpy())
        levels = int(np.abs(served.astype(np.int16) - want).max())
        log(f"  {variant} service: 8 items in {ms:.1f} ms over HTTP (host "
            f"clock, one request); the served PNGs against the CPU "
            f"generator's images of the same items and z: max {levels} "
            f"levels of 255 (limit 1); a bad item: 400 "
            f"({body_bad['error']}); K1 launches {got[0]} for "
            f"{svc.device_batches} device batches (warm-up included), K2 "
            f"{got[1]}")
        check(levels <= 1, f"{variant}: served images stray from the CPU's")
        check(got[0] == svc.device_batches == 2,
              f"{variant}: K1 launches {got[0]}, device batches "
              f"{svc.device_batches}; 2 each expected (warm-up + request)")
        check(got[1] == 0, f"{variant} serving launched K2")
        launches[f"serve_{variant}"] = got
        latency[variant] = ms
    return launches, latency


# ------------------------------------------ the host side of stage 1


# a resume from a run's epoch-1 checkpoint against that run's own epoch 2,
# on the card. Both runs enter the resumed epoch with the same bits, so the
# losses of its first step are held tight (an H100 read them equal). After
# the epoch's 4 steps the parameters are held by their distance over the
# norm and per-tensor cosines: cuDNN's default backward algorithms are not
# deterministic, and two 3-step runs from one state differ in 47 of 50
# tensors, in none with cudnn.deterministic (_drift_source; the train path
# leaves it off). There the held resume read 1.2e-4 of the norm and a
# cosine of 0.99996; the resume without the generator's state 2.3e-2 at
# the first step, then 4.7e-3 and 0.923; without the Adam states 5.2,
# 7.4e-3 and 0.721 (PERF.md §6). The epoch's mean losses are printed, not
# held: the drift moved the held resume's by 3.3e-5 to 5.2e-4 in five card
# runs and by more than 1e-3 in one. The CPU tests hold the resume bit for
# bit (tests/test_torch_port_checkpoint.py).
RESUME_FIRST_STEP_ATOL = 1e-4
MAX_RESUME_DIST = 1e-3
MIN_RESUME_COSINE = 0.999
SAMPLE_GRIDS = 25
SAMPLE_LEVELS = 1           # a card grid against the CPU's, levels of 255
MNIST_TRAIN = os.path.join(ROOT, "cfg", "mnist_train.yml")
EVAL_CFGS = {"multi-mnist": os.path.join(ROOT, "cfg", "mnist_eval.yml"),
             "clevr": os.path.join(ROOT, "cfg", "clevr_eval.yml")}
DECODE_ITEMS = train_main.SYNTHETIC_ITEMS["multi-mnist"]  # the entry's set
CLEVR_HW = (320, 480)       # a published CLEVR image: 480x320 RGBA
WORK = ""                   # main()'s temporary directory: data, runs


def filtered_png(pixels: np.ndarray, ctype: int, filters,
                 palette=None) -> bytes:
    """(H, W, C) uint8 samples -> an 8-bit PNG of colour type ``ctype``
    whose row y is written with row filter ``filters[y % len(filters)]``
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth); ``palette`` (n, 3) uint8
    for colour type 3."""
    h, w, c = pixels.shape
    x = pixels.reshape(h, w * c).astype(np.int32)
    up = np.vstack([np.zeros((1, w * c), np.int32), x[:-1]])
    left = np.hstack([np.zeros((h, c), np.int32), x[:, :-c]])
    upleft = np.hstack([np.zeros((h, c), np.int32), up[:, :-c]])
    pa, pb = np.abs(up - upleft), np.abs(left - upleft)
    pc = np.abs(left + up - 2 * upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    preds = (np.zeros_like(x), left, up, (left + up) >> 1, paeth)
    rows = b"".join(
        bytes([f]) + ((x[y] - preds[f][y]) % 256).astype(np.uint8).tobytes()
        for y, f in ((y, filters[y % len(filters)]) for y in range(h)))
    body = png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                          0))
    if palette is not None:
        body += png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return (PNG_SIGNATURE + body + png_chunk(b"IDAT", zlib.compress(rows))
            + png_chunk(b"IEND", b""))


def phase_probe():
    log("phase 21/52 probe: the image decoders this machine has, read only "
        "(nothing is built or installed)")
    cc = next((c for c in ("cc", "gcc", "g++") if shutil.which(c)), None)
    dirs = []
    if cc:
        err = subprocess.run([cc, "-E", "-Wp,-v", "-x", "c", os.devnull],
                             capture_output=True, text=True,
                             timeout=60).stderr
        inside = False
        for line in err.splitlines():
            if line.startswith("#include <...> search starts here"):
                inside = True
            elif line.startswith("End of search list"):
                break
            elif inside:
                dirs.append(line.strip().split(" (")[0])
    headers = {h: [os.path.join(d, h) for d in dirs
                   if os.path.isfile(os.path.join(d, h))]
               for h in ("jpeglib.h", "png.h")}
    ldconfig = shutil.which("ldconfig") or "/sbin/ldconfig"
    try:
        cache = subprocess.run([ldconfig, "-p"], capture_output=True,
                               text=True, timeout=60).stdout
    except OSError:
        cache = ""
    libs = {name: sorted({line.split("=>")[-1].strip()
                          for line in cache.splitlines()
                          if line.strip().startswith(name)})
            for name in ("libjpeg.so", "libpng", "libnvjpeg.so")}
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvjpeg = sorted(glob.glob(os.path.join(cuda_home, "lib64",
                                           "libnvjpeg.so*"))
                    + glob.glob(os.path.join(cuda_home, "targets", "*",
                                             "lib", "libnvjpeg.so*")))
    found = {"compiler": cc, "include_dirs": dirs, "headers": headers,
             "shared_objects": libs, "cuda_home": cuda_home,
             "libnvjpeg_under_cuda": nvjpeg,
             "nvjpeg_h": os.path.isfile(os.path.join(cuda_home, "include",
                                                     "nvjpeg.h"))}
    print(json.dumps({"decoder_probe": found}), flush=True)
    loader_cpp = bool(cc and all(headers.values()) and libs["libjpeg.so"]
                      and libs["libpng"])
    log(f"  native/loader.cpp (jpeglib.h, png.h, libjpeg, libpng): "
        f"{'all found' if loader_cpp else 'not all found'}; nvjpeg under "
        f"{cuda_home}: {'found' if nvjpeg else 'not found'}")
    return found


def _decode_times():
    """The port's reader on this host: 512 synthetic 64x64 Multi-MNIST
    PNGs (the port's writer, row filter 0) decoded into the reader's RAM
    cache, and one 480x320 RGBA image (a published CLEVR image's size)
    written with row filter 0 and with Paeth on every row, decoded to RGB
    and resized to 64x64."""
    d = os.path.join(WORK, "decode")
    write_synthetic_multimnist(d, n=DECODE_ITEMS, seed=7)
    t = time.perf_counter()
    ds = MultiMnistDataset(d)
    mnist_s = time.perf_counter() - t
    check(ds.get_batch(np.arange(4))["image"].shape == (4, 64, 64, 1),
          "decoded Multi-MNIST batch shape")
    rs = np.random.RandomState(21)
    yy, xx = np.mgrid[0:CLEVR_HW[0], 0:CLEVR_HW[1]]
    rgba = np.stack([(xx + yy) % 256, (2 * xx) % 256, (3 * yy) % 256,
                     np.full_like(xx, 255)], -1)
    rgba = np.clip(rgba + rs.randint(-8, 9, rgba.shape), 0, 255).astype(
        np.uint8)
    out = {"mnist_512_s": mnist_s}
    for name, filters in (("none", [0]), ("paeth", [4])):
        path = os.path.join(d, f"clevr_{name}.png")
        with open(path, "wb") as f:
            f.write(filtered_png(rgba, 6, filters))
        t = time.perf_counter()
        rgb = read_png(path, "RGB")
        out[f"clevr_{name}_s"] = time.perf_counter() - t
        check(np.array_equal(rgb, rgba[..., :3]),
              f"480x320 RGBA ({name}) decodes to its RGB samples")
    t = time.perf_counter()
    small = resize_bilinear(rgb, (64, 64))
    out["resize_s"] = time.perf_counter() - t
    check(small.shape == (64, 64, 3), "resize to 64x64")
    log(f"  decode (host clock, this machine's CPU): {DECODE_ITEMS} "
        f"Multi-MNIST 64x64 PNGs into the RAM cache {mnist_s * 1e3:.1f} ms "
        f"({mnist_s * 1e6 / DECODE_ITEMS:.1f} us an image); one 480x320 "
        f"RGBA PNG: filter 0 {out['clevr_none_s'] * 1e3:.1f} ms, Paeth on "
        f"every row {out['clevr_paeth_s'] * 1e3:.1f} ms; its resize to "
        f"64x64 {out['resize_s'] * 1e3:.1f} ms")
    return out


def _entry(name, argv):
    """cli/main.py with ``argv`` on the card: (history, (K1, K2) launches,
    host seconds), the counts set to 0 just before and read just after."""
    k1.reset_launch_count()
    t = time.perf_counter()
    hist = train_main.main([*argv, "--device", DEVICE])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = (k1.launch_count(), k1.grad_launch_count())
    log(f"  {name}: {seconds:.2f} s (host clock, the whole entry); K1 "
        f"launches {launches[0]}, K2 launches {launches[1]}")
    return hist, launches, seconds


def _artifacts(out, epochs, cfg_file):
    want = [os.path.join("logs", "metrics.jsonl"), "run_flags.json",
            os.path.basename(cfg_file),
            os.path.join("src_snapshot", "csrc", "stn_place.cu"),
            os.path.join("src_snapshot", "train", "loop.py"),
            os.path.join("images", "real_samples.png")]
    want += [os.path.join("images", f"fake_samples_epoch_{e:03d}.png")
             for e in epochs]
    want += [os.path.join("models", str(e), "state.pth") for e in epochs]
    missing = [w for w in want if not os.path.isfile(os.path.join(out, w))]
    check(not missing, f"{out}: missing {missing}")
    grid = read_png(os.path.join(out, "images",
                                 f"fake_samples_epoch_{epochs[-1]:03d}.png"),
                    "RGB")
    check(grid.shape == (8 * 66 + 2, 8 * 66 + 2, 3),
          f"epoch grid of 64 tiles: {grid.shape}")
    with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    check(all(np.isfinite(v) for r in records for k, v in r.items()
              if k not in ("step", "time")), "non-finite logged scalars")
    return records


def _logged(run, step):
    """The losses ``run`` logged at global ``step``."""
    with open(os.path.join(run, "logs", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    found = [r for r in records if r["step"] == step]
    check(len(found) == 1, f"{run}: {len(found)} records of step {step}")
    return {k: v for k, v in found[0].items() if k not in ("step", "time")}


def _gap(run, ref, hist, hist_ref, epoch=2):
    """Two runs at ``epoch``: the largest difference of the losses logged
    at the epoch's first step and of the epoch's mean losses, the lowest
    per-tensor cosine of G's and D's parameters (and its tensor), the
    parameters' distance over the reference's norm, the largest BatchNorm
    buffer difference, and both step counts."""
    a = CheckpointManager(os.path.join(run, "models")).load(epoch)[0]
    b = CheckpointManager(os.path.join(ref, "models")).load(epoch)[0]
    first = a["step"] - hist["steps"]
    la, lb = _logged(run, first), _logged(ref, first)
    cos, buf, dist, norm = {}, 0.0, 0.0, 0.0
    for net in ("g", "d"):
        for k, v in a[net].items():
            if not v.is_floating_point():
                continue
            w = b[net][k]
            if "running_" in k:
                buf = max(buf, float((v - w).abs().max()))
                continue
            cos[f"{net}.{k}"] = _cosine(v, w)
            dist += float((v.double() - w.double()).square().sum())
            norm += float(w.double().square().sum())
    worst = min(cos, key=cos.get)
    return {"first_step": max(abs(la[k] - lb[k]) for k in lb),
            "loss": max(abs(hist[k] - hist_ref[k]) for k in hist_ref
                        if k not in ("steps", "seconds")),
            "min_cosine": cos[worst], "worst_tensor": worst,
            "rel_dist": (dist / norm) ** 0.5, "buffers": buf,
            "steps": (a["step"], b["step"])}


def _fmt_gap(g):
    return (f"first step's losses max |diff| {g['first_step']:.3e}, the "
            f"epoch's mean losses {g['loss']:.3e}, lowest parameter cosine "
            f"{g['min_cosine']:.8f} ({g['worst_tensor']}), parameter "
            f"distance {g['rel_dist']:.3e} of the norm, BatchNorm buffers "
            f"max |diff| {g['buffers']:.3e}, steps {g['steps']}")


def _resume_copy(run, epoch, out):
    """``out`` holding ``run``'s checkpoint of ``epoch`` and its run
    record alone: the state of a run cut after that epoch."""
    shutil.copytree(os.path.join(run, "models", str(epoch)),
                    os.path.join(out, "models", str(epoch)))
    shutil.copy(os.path.join(run, "run_flags.json"), out)


def _drift_source(mcfg):
    """Two 3-step runs from one full-width state, once with cuDNN's
    default algorithms and once with ``cudnn.deterministic`` (in this
    probe only: the train path leaves it off): how many of G's and D's
    parameter tensors differ between the two runs. Read, not held."""
    data = {k: torch.from_numpy(v).to(DEVICE)
            for k, v in synthetic_multimnist(STEP_BATCH, seed=8).items()}
    step = make_train_step(mcfg)

    def params():
        state = create_state(mcfg, seed=0, device=DEVICE)
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        for _ in range(3):
            step(state, data, gen, LR, LR)
        return [*state.g.parameters(), *state.d.parameters()]

    differ = {}
    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        try:
            a, b = params(), params()
        finally:
            torch.backends.cudnn.deterministic = False
        differ[deterministic] = sum(int(not torch.equal(x, y))
                                    for x, y in zip(a, b))
    log(f"  drift's source: two 3-step runs from one state differ in "
        f"{differ[False]} of {len(a)} parameter tensors with cuDNN's "
        f"default algorithms, in {differ[True]} with cudnn.deterministic")
    return {"default": differ[False], "cudnn_deterministic": differ[True],
            "tensors": len(a)}


def _time_checkpoint(mcfg):
    """Save and restore of a full-width state (G, D, both Adams after one
    step, the generator) on the card: seconds, bytes, and the round trip
    held bit for bit."""
    state = create_state(mcfg, seed=3, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    data = {k: torch.from_numpy(v[:STEP_BATCH]).to(DEVICE)
            for k, v in synthetic_multimnist(STEP_BATCH, seed=3).items()}
    make_train_step(mcfg)(state, data, gen, LR, LR)
    mgr = CheckpointManager(os.path.join(WORK, "ckpt"))
    torch.cuda.synchronize()
    t = time.perf_counter()
    path = mgr.save(0, state, gen)
    save_s = time.perf_counter() - t
    back = create_state(mcfg, seed=4, device=DEVICE)
    gen2 = torch.Generator(device=DEVICE).manual_seed(4)
    t = time.perf_counter()
    mgr.restore(back, gen2)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    same = all(torch.equal(x, y) for x, y in zip(
        [*state.g.state_dict().values(), *state.d.state_dict().values()],
        [*back.g.state_dict().values(), *back.d.state_dict().values()]))
    same = same and back.step == state.step and torch.equal(
        gen.get_state(), gen2.get_state()) and all(
        torch.equal(x["exp_avg_sq"], y["exp_avg_sq"]) for x, y in zip(
            state.g_opt.state_dict()["state"].values(),
            back.g_opt.state_dict()["state"].values()))
    size = os.path.getsize(path)
    log(f"  checkpoint of the full-width mnist state: {size / 2**20:.1f} MiB; "
        f"save {save_s * 1e3:.0f} ms, restore {restore_s * 1e3:.0f} ms (host "
        f"clock, to and from this machine's disk); round trip bit for bit: "
        f"{same}")
    check(same, "checkpoint round trip differs")
    shutil.rmtree(os.path.join(WORK, "ckpt"))
    return {"save_s": save_s, "restore_s": restore_s, "bytes": size}


def phase_train_disk():
    log("phase 22/52 disk: the train entries from disk (cli/main.py "
        "--synthetic: the set written, then read back): clevr 1 epoch with "
        "flips, and its set in memory; mnist 2 epochs resumed in place to "
        "3, two straight 3-epoch runs, two resumes from the first's "
        "epoch-1 checkpoint and two controls (no generator state, no Adam "
        "states); the same set in memory; a full-width checkpoint timed")
    decode = _decode_times()
    runs = {name: os.path.join(WORK, "runs", name)
            for name in ("clevr", "clevr_memory", "mnist", "straight",
                         "straight2", "resumed", "resumed2", "control",
                         "control_adam", "memory")}
    launches = {}
    cdata = os.path.join(WORK, "disk", "clevr")
    hist_c, launches["train_clevr_disk"], _ = _entry(
        "clevr from disk, 1 epoch",
        ["--variant", "clevr", "--cfg", FAMILY_CFGS["clevr"], "--data_dir",
         cdata, "--synthetic", "--manualSeed", "7", "--max_epochs", "1",
         "--output_dir", runs["clevr"]])
    ccfg = cfg_from_file(FAMILY_CFGS["clevr"], "clevr")
    cbatch = train_settings(ccfg).batch_size
    citems = train_main.synthetic_items("clevr", cbatch)
    csteps = citems // cbatch
    check(launches["train_clevr_disk"] == (4 * csteps + 1, 4 * csteps),
          f"clevr K1/K2 launches {launches['train_clevr_disk']}")
    _artifacts(runs["clevr"], [0], FAMILY_CFGS["clevr"])
    check(all(np.isfinite(v) for v in hist_c[0].values()), "clevr losses")
    flips, plain = ClevrDataset(cdata, seed=7), ClevrDataset(cdata,
                                                             hflip=False)
    flipped = sum(int(not np.array_equal(flips[i]["image"],
                                         plain[i]["image"]))
                  for i in range(64))
    log(f"  clevr reader: {flipped} of the first 64 items flipped "
        f"(ClevrDataset(hflip=True) from RandomState(7))")
    check(0 < flipped < 64, "the clevr reader's h-flip")
    k1.reset_launch_count()
    _, hist_cm = train_loop.train(
        ccfg, stage1_model_config(ccfg, "clevr"),
        MemoryLoader(synthetic_clevr(citems, seed=7), cbatch, seed=7,
                     device=DEVICE),
        runs["clevr_memory"], device=DEVICE, seed=7, max_epochs=2)
    torch.cuda.synchronize()
    launches["train_clevr_memory"] = (k1.launch_count(),
                                      k1.grad_launch_count())
    check(launches["train_clevr_memory"]
          == (2 * (4 * csteps + 1), 2 * 4 * csteps),
          f"clevr in-memory K1/K2 launches {launches['train_clevr_memory']}")
    clevr_s = {"disk": [h["seconds"] for h in hist_c],
               "memory": [h["seconds"] for h in hist_cm]}
    log(f"  clevr epoch times (host clock, {csteps} steps of {cbatch}, "
        f"grids and checkpoints excluded): from disk (decoded every visit, "
        f"flips) {', '.join(f'{t:.3f}' for t in clevr_s['disk'])} s; the "
        f"same set held on the card, no flips "
        f"{', '.join(f'{t:.3f}' for t in clevr_s['memory'])} s")

    cfg = cfg_from_file(MNIST_TRAIN, "multi-mnist")
    mcfg = stage1_model_config(cfg, "multi-mnist")
    batch = train_settings(cfg).batch_size
    steps = DECODE_ITEMS // batch
    mdata = os.path.join(WORK, "disk", "mnist")
    mnist = ["--variant", "multi-mnist", "--cfg", MNIST_TRAIN, "--data_dir",
             mdata, "--synthetic", "--manualSeed", "7",
             "--snapshot_interval", "1"]

    def run(name, path, epochs, resume=False):
        out = runs[name]
        hist, launches[path], _ = _entry(
            name, [*mnist, "--output_dir", out, "--max_epochs", str(epochs),
                   *(["--resume", out] if resume else [])])
        done = len(hist)
        want = (done * (4 * steps + 1), done * 4 * steps)
        check(launches[path] == want, f"{path}: K1/K2 launches "
              f"{launches[path]} != {want} (4 a step each, and K1 once an "
              "epoch grid)")
        return hist

    hist_m2 = run("mnist", "train_disk", 2)
    hist_r = run("mnist", "resume", 3, resume=True)
    hist_s = run("straight", "train_disk_straight", 3)
    hist_s2 = run("straight2", "train_disk_straight2", 3)
    check(len(hist_r) == 1 and len(hist_s) == 3, "resume ran one epoch")
    records = _artifacts(runs["mnist"], [0, 1, 2], MNIST_TRAIN)
    check([r["step"] for r in records] == [0, steps, 2 * steps],
          f"logged steps {[r['step'] for r in records]}")
    _resume_copy(runs["straight"], 1, runs["resumed"])
    hist_x = run("resumed", "resume_from_straight", 3, resume=True)
    _resume_copy(runs["straight"], 1, runs["resumed2"])
    hist_x2 = run("resumed2", "resume_from_straight2", 3, resume=True)
    # the controls: the same resume with the generator's state, or both
    # Adam states, left out; each must fail the held checks
    restore = CheckpointManager.restore

    def without_adam(self, state, generator=None, epoch=None):
        fresh = state.g_opt.state_dict(), state.d_opt.state_dict()
        epoch = restore(self, state, generator, epoch)
        state.g_opt.load_state_dict(fresh[0])
        state.d_opt.load_state_dict(fresh[1])
        return epoch

    hist_ctl = {}
    for name, cut in (("control", lambda self, state, generator=None,
                       epoch=None: restore(self, state, None, epoch)),
                      ("control_adam", without_adam)):
        CheckpointManager.restore = cut
        try:
            _resume_copy(runs["straight"], 1, runs[name])
            hist_ctl[name] = run(name, f"resume_{name}", 3, resume=True)
        finally:
            CheckpointManager.restore = restore
    gaps = {"in place, 2 + 1 epochs": _gap(runs["mnist"], runs["straight"],
                                           hist_r[0], hist_s[2]),
            "from the straight run's epoch 1": _gap(
                runs["resumed"], runs["straight"], hist_x[0], hist_s[2]),
            "control, generator state left out": _gap(
                runs["control"], runs["straight"], hist_ctl["control"][0],
                hist_s[2]),
            "control, Adam states left out": _gap(
                runs["control_adam"], runs["straight"],
                hist_ctl["control_adam"][0], hist_s[2])}
    for name, g in gaps.items():
        log(f"  resumed ({name}) against the straight run after epoch 2: "
            + _fmt_gap(g))
    # the card's drift with nothing cut: the same runs from the same state
    drift = {"two uninterrupted runs after epoch 1 (8 steps)": _gap(
                 runs["mnist"], runs["straight"], hist_m2[1], hist_s[1],
                 epoch=1),
             "two uninterrupted runs after epoch 2 (12 steps)": _gap(
                 runs["straight2"], runs["straight"], hist_s2[2], hist_s[2]),
             "two resumes from one epoch-1 checkpoint (4 steps)": _gap(
                 runs["resumed2"], runs["resumed"], hist_x2[0], hist_x[0])}
    for name, g in drift.items():
        log(f"  drift, {name}: " + _fmt_gap(g))
    drift["source"] = _drift_source(mcfg)
    held = gaps["from the straight run's epoch 1"]
    log(f"  held: the resume from the straight run's epoch 1: its first "
        f"step's losses (limit {RESUME_FIRST_STEP_ATOL:g}), then parameter "
        f"distance (limit {MAX_RESUME_DIST:g} of the norm) and per-tensor "
        f"cosines (limit {MIN_RESUME_COSINE}); each control must fail all "
        f"three")
    check(held["steps"] == (3 * steps, 3 * steps), f"steps {held['steps']}")

    def strays(g):
        return (g["first_step"] > RESUME_FIRST_STEP_ATOL,
                g["rel_dist"] > MAX_RESUME_DIST,
                g["min_cosine"] <= MIN_RESUME_COSINE)

    check(strays(held) == (False, False, False),
          f"the resume strays (first step, distance, cosine): "
          f"{strays(held)}")
    for name in ("generator state", "Adam states"):
        check(all(strays(gaps[f"control, {name} left out"])),
              f"a resume with its {name} left out passes a held check "
              f"(first step, distance, cosine strayed: "
              f"{strays(gaps[f'control, {name} left out'])}): it is blind")

    k1.reset_launch_count()
    _, hist_m = train_loop.train(
        cfg, mcfg, MemoryLoader(synthetic_multimnist(DECODE_ITEMS, seed=7),
                                batch, seed=7, device=DEVICE),
        runs["memory"], device=DEVICE, seed=7, max_epochs=3)
    torch.cuda.synchronize()
    launches["train_memory"] = (k1.launch_count(), k1.grad_launch_count())
    check(launches["train_memory"] == (3 * (4 * steps + 1), 3 * 4 * steps),
          f"in-memory K1/K2 launches {launches['train_memory']}")
    epoch_s = {"disk": [h["seconds"] for h in hist_s],
               "memory": [h["seconds"] for h in hist_m]}
    log(f"  epoch times (host clock, {steps} steps of {batch}, grids and "
        f"checkpoints excluded): from disk "
        f"{', '.join(f'{t:.3f}' for t in epoch_s['disk'])} s; the same set "
        f"in memory {', '.join(f'{t:.3f}' for t in epoch_s['memory'])} s "
        f"(first epochs include cuDNN's set-up)")
    ckpt = _time_checkpoint(mcfg)
    for name in runs:
        if name != "clevr":
            shutil.rmtree(runs[name])
    return {"launches": launches, "decode": decode, "checkpoint": ckpt,
            "epoch_s": epoch_s, "clevr_epoch_s": clevr_s, "resume": gaps,
            "drift": drift, "clevr_run": runs["clevr"], "clevr_data": cdata}


def phase_k1_batch9():
    log("phase 23/52 batch9: K1 at the sampler's batch of 9 (one layout, 9 "
        "z) against its plain version, f32 and bf16, and timed")
    rs = np.random.RandomState(23)
    dev = torch.device(DEVICE)
    cases = [("multi-mnist", 3, MNIST.ngf // 4, _service_boxes(rs, 1, 3)),
             ("clevr", 4, family_shapes("clevr")["G"][1],
              family_data("clevr", 1, 23)["bbox"]),
             ("clevr padded4", 4, family_shapes("clevr")["G"][1],
              _family_boxes(rs, "clevr", 1, "padded4"))]
    out = {"max_abs_err": 0.0, "max_abs_err_bf16": 0.0, "rows": []}
    for dtype in (torch.float32, torch.bfloat16):
        worst = "max_abs_err" if dtype == torch.float32 else \
            "max_abs_err_bf16"
        for name, o, c, box in cases:
            bbox = torch.from_numpy(np.repeat(box, 9, axis=0)).to(dev)
            feats = torch.from_numpy(rs.randn(9, o, c, 16, 16).astype(
                np.float32)).to(dev).to(dtype)
            got = k1.stn_place_multi_nchw(feats, bbox, (16, 16))
            want = k1.stn_place_multi_plain(feats, bbox, (16, 16))
            label = f"{name} (9,{o},{c},16,16) {str(dtype)[6:]}"
            out[worst] = max(out[worst],
                             _held(got, want, dtype, "K1", label))
            if "padded" not in name:
                row = time_place(feats, bbox, (16, 16), f"K1 batch 9 {name}")
                out["rows"].append({"case": label, **{
                    k: row[k] for k in ("ms", "plain_ms", "graph_ms",
                                        "bound_ms", "bound_by")}})
    return out


def _eval_cfg(variant, net_g):
    """A copy of the variant's eval cfg in the work directory with NET_G
    set to ``net_g``."""
    with open(EVAL_CFGS[variant]) as f:
        lines = [f"NET_G: '{net_g}'" if line.startswith("NET_G:") else line
                 for line in f.read().splitlines()]
    path = os.path.join(WORK, f"{variant}_eval.yml")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def phase_sample(clevr_run, clevr_data):
    log(f"phase 24/52 sample: cli/main.py with TRAIN.FLAG False, "
        f"{SAMPLE_GRIDS} grids each: mnist from the trained netG_final.pth "
        f"on a synthetic test split written by the port, clevr from phase "
        f"22's output directory; a grid against the CPU's")
    data = {"multi-mnist": os.path.join(WORK, "disk", "mnist_test"),
            "clevr": clevr_data}
    write_synthetic_multimnist(data["multi-mnist"], n=64, split="test",
                               seed=7)
    write_synthetic_clevr(data["clevr"], n=64, split="test", seed=7)
    launches, seconds = {}, {}
    for variant, net_g, path in (("multi-mnist", CKPT, "sample"),
                                 ("clevr", clevr_run, "sample_clevr")):
        cfg_file = _eval_cfg(variant, net_g)
        out = os.path.join(WORK, "samples", variant)
        _, launches[path], seconds[variant] = _entry(
            f"{variant} sampling", ["--variant", variant, "--cfg", cfg_file,
                                    "--data_dir", data[variant],
                                    "--output_dir", out, "--manualSeed",
                                    "7"])
        check(launches[path] == (SAMPLE_GRIDS, 0),
              f"{variant} sampling K1/K2 launches {launches[path]}; "
              f"{SAMPLE_GRIDS} and 0 expected (one G forward a grid)")
        grids = [read_png(os.path.join(out, "samples", f"sample_{s:03d}.png"),
                          "RGB") for s in range(SAMPLE_GRIDS)]
        check(all(g.shape == (2 * 66 + 2, 10 * 66 + 2, 3) for g in grids),
              f"{variant}: {SAMPLE_GRIDS} grids of 2 x 10 tiles")
        # the first grid again on the CPU, from the same weights
        cfg = cfg_from_file(cfg_file, variant)
        cfg.DATA_DIR = data[variant]
        mcfg = stage1_model_config(cfg, variant)
        sd = (load_reference_g(net_g) if variant == "multi-mnist" else
              CheckpointManager(os.path.join(net_g, "models")).load()[0]["g"])
        ref = sample_stage1(
            argparse.Namespace(), cfg, mcfg, os.path.join(out, "cpu"),
            variant, 7, num_samples=1,
            g=build_stage1_g(mcfg, sd, device="cpu"), device="cpu")
        cpu = read_png(os.path.join(ref, "sample_000.png"), "RGB")
        row = slice(0, 66 + 2)
        levels = int(np.abs(grids[0][row].astype(np.int16)
                            - cpu[row]).max())
        fakes = grids[0][2:66, 68:].astype(np.float32)
        log(f"  {variant}: {SAMPLE_GRIDS} grids in {seconds[variant]:.2f} s "
            f"({seconds[variant] / SAMPLE_GRIDS * 1e3:.1f} ms a grid, host "
            f"clock, G load and test split included); grid 0's first row "
            f"against the CPU's: max {levels} levels of 255 (limit "
            f"{SAMPLE_LEVELS}); fake tiles' pixel std {fakes.std():.1f}")
        check(levels <= SAMPLE_LEVELS, f"{variant}: card and CPU grids "
              "disagree")
        check(fakes.std() > 1.0, f"{variant}: constant fakes")
    return {"launches": launches, "seconds": seconds}


# ------------------------------------------------------ COCO StackGAN stage 2


S2_CFG = os.path.join(ROOT, "cfg", "coco_s2_train.yml")
S2_BATCH = 40               # cfg/coco_s2_train.yml TRAIN.BATCH_SIZE
S2_STEP_BATCH = 4           # the stage-2 step card vs CPU (phase 26): the
                            # CPU's full-width step at 4 takes seconds
S2_TIME_RUNS = 5            # CUDA-event readings a stage-2 step time
S2_SERVE_BATCH = 4          # G1 + G2 eval forwards card vs CPU (phase 29)
S2_LAUNCHES = (5, 4)        # K1 (G1, G2, D x 3) and K2 (D x 3, G2) a step


def stage2_cfgs(dtype=None):
    """The frozen stage-1 G's and stage 2's configs at the published
    widths of cfg/coco_s2_train.yml (G1 ngf 1536; G2 gf 192, D2 df 96,
    R_NUM 2)."""
    return stage2_model_config(cfg_from_file(S2_CFG, "coco-stackgan-2"),
                               compute_dtype=dtype)


def stage2_data(b, seed):
    """b items of the stage-2 synthetic train set (256px, 1-3 objects,
    stage-2 boxes the stage-1 ones), each with one caption embedding."""
    data = synthetic_coco_stage2(b, seed=seed)
    data["text_embedding"] = data["text_embedding"][:, 0].copy()
    return data


def _stage2_boxes(rs, b, o):
    """Boxes inside the canvas, 0.2-0.45 a side, the last object of every
    item padded (-1)."""
    w, h = rs.uniform(0.2, 0.45, (b, o)), rs.uniform(0.2, 0.45, (b, o))
    bbox = np.stack([rs.uniform(0, 1 - w), rs.uniform(0, 1 - h), w, h],
                    -1).astype(np.float32)
    bbox[:, -1] = -1.0
    return bbox


def stage2_shapes():
    """The stage-2 places: G2's (O, gf, 64x64) onto 64x64 and D2's
    (O, 2 * df, 30x30) onto 32x32."""
    _, s2 = stage2_cfgs()
    o = s2.num_objects
    return {"G2": (o, s2.gf_dim, (64, 64), (64, 64)),
            "D2": (o, 2 * s2.df_dim, (30, 30), (32, 32))}


def held_and_timed_places(shapes, b, launches, rs):
    """K1 and K2 at each train place of ``shapes`` ({path: (O, C, input
    side, output side)}) at batch ``b``, float32 and bf16, on boxes inside
    the canvas with the last object padded: held against their plain
    versions, K1 equal bit for bit to the unpadded objects alone and K2
    exact zeros for the padded one, then timed cold in turns and on the
    device alone beside the bound (:func:`time_place`, :func:`time_grad`).
    ``launches`` is (K1, K2) a step, recorded in each row. Returns
    {"place": {...}, "grad": {...}, "under_half_of_bound": [...]}."""
    for path, (o, c, hw, out_hw) in shapes.items():
        for es in (4, 2):
            smem = k1.place_smem_bytes(o, k1.place_tile(hw, out_hw), hw,
                                       out_hw, es)
            gsmem = k1.grad_smem_bytes(o, k1.grad_tile(hw, out_hw), hw,
                                       out_hw)
            check(smem <= k1.MAX_PLACE_SMEM and gsmem <= k1.MAX_GRAD_SMEM,
                  f"shared memory at {path}: K1 {smem}, K2 {gsmem}")
        log(f"  {path} {hw} -> {out_hw}: K1 tile {k1.place_tile(hw, out_hw)}"
            f", {k1.place_smem_bytes(o, k1.place_tile(hw, out_hw), hw, out_hw, 4)}"
            f" B of shared memory (f32); K2 tile {k1.grad_tile(hw, out_hw)}, "
            f"{k1.grad_smem_bytes(o, k1.grad_tile(hw, out_hw), hw, out_hw)} B")
    dev = torch.device(DEVICE)
    out = {k: {"max_abs_err": 0.0, "max_abs_err_bf16": 0.0}
           for k in ("place", "grad")}
    under_half = []
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype)[6:]
        worst = "max_abs_err" if dtype == torch.float32 else \
            "max_abs_err_bf16"
        for path, (o, c, hw, out_hw) in shapes.items():
            bbox = torch.from_numpy(_stage2_boxes(rs, b, o)).to(dev)
            feats = torch.from_numpy(rs.randn(b, o, c, *hw).astype(
                np.float32)).to(dev).to(dtype)
            g = torch.from_numpy(rs.uniform(-1, 1, (b, c) + out_hw).astype(
                np.float32)).to(dev).to(dtype)
            label = f"{path} {tname}"
            got = k1.stn_place_multi_nchw(feats, bbox, out_hw)
            err = _held(got, k1.stn_place_multi_plain(feats, bbox, out_hw),
                        dtype, "K1", f"{label} {tuple(feats.shape)} -> "
                        f"{out_hw}")
            out["place"][worst] = max(out["place"][worst], err)
            dg = k1.stn_place_multi_grad_nchw(g, bbox, hw)
            err = _held(dg, k1.stn_place_multi_grad_plain(g, bbox, hw),
                        dtype, "K2", f"{label} {tuple(g.shape)} -> "
                        f"{tuple(dg.shape)}")
            out["grad"][worst] = max(out["grad"][worst], err)
            first = k1.stn_place_multi_nchw(
                feats[:, :o - 1].contiguous(),
                bbox[:, :o - 1].contiguous(), out_hw)
            dg_first = k1.stn_place_multi_grad_nchw(
                g, bbox[:, :o - 1].contiguous(), hw)
            torch.cuda.synchronize()
            check(torch.equal(got, first), f"K1 {label}: the padded object "
                  "changed the sums of the others")
            check(int(torch.count_nonzero(dg[:, -1])) == 0
                  and torch.equal(dg[:, :o - 1], dg_first),
                  f"K2 {label}: the padded object must get exact zeros")
            log(f"  {label}: K1 equal bit for bit to the unpadded objects "
                "alone; K2 exact zeros for the padded one")
            rows = {"place": time_place(feats, bbox, out_hw,
                                        f"K1 {tname} at the {path} shape"),
                    "grad": time_grad(g, bbox, hw,
                                      f"K2 {tname} at the {path} shape")}
            for kernel, row in rows.items():
                row["launches_per_step"] = (
                    launches[0 if kernel == "place" else 1])
                out[kernel].setdefault(tname, {})[path] = row
                if row["graph_share_of_bound"] < 0.5:
                    under_half.append(
                        f"{'K1' if kernel == 'place' else 'K2'} {label}: "
                        f"{row['graph_share_of_bound']:.1%} of the bound on "
                        f"the device alone, {row['share_of_bound']:.1%} "
                        "cold in turns")
    for line in under_half:
        log(f"  under half of its bound: {line}")
    out["under_half_of_bound"] = under_half
    return out


def phase_stage2_kernels():
    log(f"phase 25/52 s2kernels: K1 and K2 at the stage-2 shapes, batch "
        f"{S2_BATCH}, against their plain versions, f32 and bf16, and timed")
    return held_and_timed_places(stage2_shapes(), S2_BATCH, S2_LAUNCHES,
                                 np.random.RandomState(25))


ADAM_WARM_COUNT = 10        # the warm Adam state of phase 26's held step


def warm_adam(state):
    """Every Adam of ``state`` (G's, and D's or each AttnGAN D's) at step
    ADAM_WARM_COUNT with first moments 0 and second moments 1: the update
    is then about 0.05 lr * g, linear in the gradient, where a fresh Adam's
    first update is lr * sign(g)
    (tests/test_torch_port_stage2_step.py:_warm_adam)."""
    d_opts = (list(state.d_opts.values()) if hasattr(state, "d_opts")
              else [state.d_opt])
    for opt in (state.g_opt, *d_opts):
        warm_opt(opt)


def warm_opt(opt: torch.optim.Adam) -> None:
    """One Adam at :func:`warm_adam`'s state."""
    for group in opt.param_groups:
        for p in group["params"]:
            opt.state[p] = {"step": torch.tensor(float(ADAM_WARM_COUNT)),
                            "exp_avg": torch.zeros_like(p),
                            "exp_avg_sq": torch.ones_like(p)}


def he_randomize(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Activation-preserving weights drawn on the CPU from ``seed``: conv
    and linear weights N(0, 2 / fan_in), biases N(0, 0.1), BatchNorm
    weights U(0.5, 1.5), biases N(0, 0.1), running means N(0, 0.2) and
    variances U(0.5, 1.5) (tests/test_torch_port_stage2_step.py)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.weight.copy_(0.5 + torch.rand(m.weight.shape, generator=g))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
                m.running_mean.copy_(
                    0.2 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(
                    0.5 + torch.rand(m.running_var.shape, generator=g))
            elif isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               * (2.0 / fan_in) ** 0.5)
                if m.bias is not None:
                    m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
    return module


def step2_once(device, data, z, eps1, eps2, warm=False):
    """One full-width float32 stage-2 step on ``device`` from the
    reference init (G1 and G2 from seed 0, D2 from seed 1) with the noise
    given, from fresh Adams or, ``warm``, from :func:`warm_adam`. Returns its
    losses, G2's and D2's state dicts before and after, their gradients
    (float32), the step's host time, and whether the frozen G1 kept every
    parameter and buffer bit for bit without a gradient."""
    s1, s2 = stage2_cfgs()
    g1 = build_stage1_g(s1, seed=0, device=device)
    state = create_state_stage2(s2, seed=0, device=device)
    if warm:
        warm_adam(state)
    nets = (("G", state.g), ("D", state.d))
    pre = {n: {k: v.detach().float().cpu().clone()
               for k, v in m.state_dict().items()} for n, m in nets}
    g1_pre = {k: v.detach().clone() for k, v in g1.state_dict().items()}
    batch = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    for k in ("label_onehot", "text_embedding"):
        batch[k] = batch[k].float()
    batch["image"] = batch["image"].float() / 127.5 - 1.0
    t = time.perf_counter()
    metrics = make_stage2_train_step(s2, s1, g1, KL_COEFF)(
        state, batch, None, LR, LR,
        *(torch.from_numpy(a).to(device) for a in (z, eps1, eps2)))
    metrics = {k: float(v) for k, v in metrics.items()}
    seconds = time.perf_counter() - t
    post = {n: {k: v.detach().float().cpu()
                for k, v in m.state_dict().items()} for n, m in nets}
    grads = {n: {k: (torch.zeros(p.shape) if p.grad is None
                     else p.grad.detach().float().cpu())
                 for k, p in m.named_parameters()} for n, m in nets}
    g1_same = all(torch.equal(v, g1_pre[k])
                  for k, v in g1.state_dict().items()) and all(
        p.grad is None for p in g1.parameters())
    return metrics, pre, post, grads, seconds, g1_same


def _step_lines(label, card, cpu):
    """Log two results of :func:`step2_once`: losses, the worst readings
    of :func:`step_disagreements` and the Adam deltas. Returns the
    disagreements and worst readings."""
    bad, worst = step_disagreements(card[:5], cpu[:5])
    cos, mean_lr, flip = delta_readings(card[:5], cpu[:5])
    log(f"  {label}: " + "; ".join(
        f"{k} {card[0][k]:.6f} / {cpu[0][k]:.6f}" for k in sorted(cpu[0])))
    log(f"    worst: loss {worst['loss']:.3e} (atol {LOSS_ATOL:g}; "
        f"{worst['loss_rel']:.2e} of the loss); BatchNorm running stats "
        f"{worst['stats']:.3e} (atol {STATS_ATOL:g}); per-tensor gradient "
        f"cosine {worst['grad_cosine']:.8f} (limit {MIN_GRAD_COSINE:g}); "
        f"Adam deltas: cosine {cos:.8f}, mean |difference| {mean_lr:.5f} "
        f"lr, {flip:.4%} of the elements apart by more than 0.5 lr")
    return bad, worst


def phase_stage2_step():
    log(f"phase 26/52 s2step: one full-width stage-2 step, batch "
        f"{S2_STEP_BATCH} on both sides, card against CPU, from the "
        "reference init")
    s1, s2 = stage2_cfgs()
    data = stage2_data(S2_STEP_BATCH, 5)
    rs = np.random.RandomState(6)
    z = rs.randn(S2_STEP_BATCH, s1.z_dim).astype(np.float32)
    eps1 = rs.randn(S2_STEP_BATCH, s1.condition_dim).astype(np.float32)
    eps2 = rs.randn(S2_STEP_BATCH, s2.condition_dim).astype(np.float32)
    args = (data, z, eps1, eps2)
    # From fresh Adams the first update is lr * sign(g): float32 noise
    # flips the sign of D2's near-zero gradients, and the G2 gradient,
    # taken through the updated D2, carries that on; read, not held
    # (PERF.md §6: the CPU's float32 step strays as far from float64)
    fresh = {dev: step2_once(dev, *args) for dev in ("cpu", DEVICE)}
    log(f"  G2 gf {s2.gf_dim}, D2 df {s2.df_dim}, frozen G1 ngf {s1.ngf}; "
        f"step on the CPU {fresh['cpu'][4]:.1f} s ({torch.get_num_threads()}"
        f" threads), on the card {fresh[DEVICE][4]:.2f} s (host clock, "
        "first call)")
    log("  from fresh Adams, read and not held:")
    _step_lines("card f32 against CPU f32", fresh[DEVICE], fresh["cpu"])
    # held: the same step from warm Adams, whose update is linear in the
    # gradient
    cpu = step2_once("cpu", *args, warm=True)
    card = step2_once(DEVICE, *args, warm=True)
    log(f"  from warm Adams (step {ADAM_WARM_COUNT}, moments 0 and 1), "
        "held:")
    bad, worst = _step_lines("card f32 against CPU f32", card, cpu)
    runs = (*fresh.values(), cpu, card)
    log(f"    frozen G1 bit-identical after the step, no gradient: "
        f"{[r[5] for r in runs]}")
    for msg in bad:
        log(f"    FAILED {msg}")
    check(not bad, f"stage-2 step card vs CPU: {len(bad)} checks failed")
    check(all(r[5] for r in runs), "the frozen G1 changed in the step")
    check(abs(card[0]["g_loss_total"] - card[0]["g_loss"]
              - KL_COEFF * card[0]["kl_loss"]) < 1e-4,
          "the KL enters the G loss x KL_COEFF")
    return worst


def phase_stage2_step_time():
    log(f"phase 27/52 s2time: the stage-2 step at batch {S2_BATCH} on the "
        "card, float32 and bf16")
    dev = torch.device(DEVICE)
    data = {k: torch.from_numpy(v).to(dev)
            for k, v in stage2_data(S2_BATCH, 8).items()}
    out = {}
    for dtype in (None, torch.bfloat16):
        kind = "bf16" if dtype else "f32"
        s1, s2 = stage2_cfgs(dtype)
        g1 = build_stage1_g(s1, seed=0, device=dev)
        state = create_state_stage2(s2, seed=0, device=dev)
        step = make_stage2_train_step(s2, s1, g1, KL_COEFF)
        gen = torch.Generator(device=dev).manual_seed(0)
        for _ in range(3):
            step(state, data, gen, LR, LR)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1.reset_launch_count()
        times = []
        for _ in range(S2_TIME_RUNS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = step(state, data, gen, LR, LR)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        per_step = (k1.launch_count() / S2_TIME_RUNS,
                    k1.grad_launch_count() / S2_TIME_RUNS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms = statistics.median(times)
        check(all(bool(torch.isfinite(v)) for v in metrics.values()),
              "non-finite stage-2 losses while timing")
        args = (torch.randn((S2_BATCH, s1.z_dim), generator=gen, device=dev),
                data["bbox"], data["label_onehot"], data["text_embedding"],
                torch.randn((S2_BATCH, s1.condition_dim), generator=gen,
                            device=dev))
        g1_ms = cuda_ms(lambda: frozen_forward(g1, *args), warmup=2,
                        runs=S2_TIME_RUNS)
        log(f"coco-stackgan-2 step at batch {S2_BATCH}, full width, {kind}"
            f"{'' if dtype else ' (TF32 off)'}: {ms:.2f} ms (CUDA events, "
            f"median of {S2_TIME_RUNS}; min {min(times):.2f}, max "
            f"{max(times):.2f}) = {S2_BATCH * 1e3 / ms:.1f} images/s; peak "
            f"memory {peak:.2f} GiB; launches per step: K1 {per_step[0]:g}, "
            f"K2 {per_step[1]:g}; the frozen G1's forward alone {g1_ms:.2f} "
            f"ms (CUDA events, median of {S2_TIME_RUNS}), {g1_ms / ms:.1%} "
            "of the step")
        check(per_step == S2_LAUNCHES, f"stage-2 K1/K2 launches per step "
              f"{per_step} != {S2_LAUNCHES}")
        out[kind] = {"ms": ms, "images_per_s": S2_BATCH * 1e3 / ms,
                     "peak_gib": peak, "launches_per_step": per_step,
                     "g1_ms": g1_ms}
        del g1, state, step
        torch.cuda.empty_cache()
    log(f"stage-2 step bf16 {out['bf16']['ms']:.2f} ms beside float32 "
        f"{out['f32']['ms']:.2f} ms: {out['f32']['ms'] / out['bf16']['ms']:.2f}"
        "x")
    return out


def _stage2_cfg_file(stage1_g):
    """A copy of cfg/coco_s2_train.yml in the work directory with STAGE1_G
    set to ``stage1_g``."""
    with open(S2_CFG) as f:
        lines = [f"STAGE1_G: '{stage1_g}'" if line.startswith("STAGE1_G:")
                 else line for line in f.read().splitlines()]
    path = os.path.join(WORK, "coco_s2_train.yml")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def phase_stage2_entry():
    log("phase 28/52 s2entry: cli/main.py --variant coco-stackgan-2 "
        "--synthetic for one epoch on the card, float32, STAGE1_G a "
        "reference-format .pth; then a resume to epoch 2")
    s1, _ = stage2_cfgs()
    stage1_g = os.path.join(WORK, "stage1_netG.pth")
    torch.save({"netG": build_stage1_g(s1, seed=0, device="cpu")
                .state_dict()}, stage1_g)
    g1 = build_stage1_g(s1, load_reference_g(stage1_g), device="cpu")
    log(f"  {os.path.basename(stage1_g)}: a seeded Stage1G (ngf {s1.ngf}, "
        f"{sum(p.numel() for p in g1.parameters())} parameters) in "
        "{'netG': ...}, loaded back strict=True")
    cfg_file = _stage2_cfg_file(stage1_g)
    out = os.path.join(WORK, "entry", "coco-stackgan-2")
    data = os.path.join(WORK, "data", "coco-stackgan-2")
    imgs = os.path.join(WORK, "imgs", "coco-stackgan-2")
    batch = train_settings(cfg_from_file(cfg_file,
                                         "coco-stackgan-2")).batch_size
    steps = train_main.synthetic_items("coco-stackgan-2", batch) // batch
    want = (S2_LAUNCHES[0] * steps + 2, S2_LAUNCHES[1] * steps, 0)
    launches = {}
    for key, epochs, extra in (("train_coco_stage2", 1, []),
                               ("train_coco_stage2_resume", 2,
                                ["--resume", out])):
        k4.reset_launch_count()
        hist, got, _ = _entry(
            f"coco-stackgan-2, epochs to {epochs}",
            ["--variant", "coco-stackgan-2", "--cfg", cfg_file, "--synthetic",
             "--max_epochs", str(epochs), "--manualSeed", "7",
             "--data_dir", data, "--img_dir", imgs, "--output_dir", out,
             *extra])
        launches[key] = (*got, k4.launch_count())
        check(len(hist) == 1 and hist[0]["steps"] == steps,
              f"one epoch of {steps} steps expected, got {hist}")
        losses = {k: v for k, v in hist[0].items()
                  if k not in ("steps", "seconds")}
        check(all(np.isfinite(v) for v in losses.values()) and
              losses["kl_loss"] > 0, f"stage-2 losses {losses}")
        log(f"  epoch {epochs - 1}: {steps} steps in {hist[0]['seconds']:.2f}"
            " s (host clock, cuDNN set-up included in the first); mean "
            "losses " + ", ".join(f"{k} {v:.4f}"
                                  for k, v in sorted(losses.items())))
        check(launches[key] == want, f"K1/K2/K4 launches {launches[key]} != "
              f"{want} for {steps} steps and one epoch grid (G1 and G2)")
    want_files = [os.path.join("logs", "metrics.jsonl"), "run_flags.json",
                  os.path.basename(cfg_file),
                  os.path.join("src_snapshot", "cli", "stage2_runner.py"),
                  os.path.join("images", "real_samples.png")]
    for e in (0, 1):
        want_files += [os.path.join("models", str(e), "state.pth"),
                       os.path.join("images",
                                    f"fake_samples_epoch_{e:03d}.png")]
    missing = [w for w in want_files if not os.path.exists(
        os.path.join(out, w))]
    check(not missing, f"{out}: missing {missing}")
    grid = read_png(os.path.join(out, "images", "fake_samples_epoch_001.png"),
                    "RGB")
    check(grid.shape == (4 * 258 + 2, 4 * 258 + 2, 3),
          f"epoch grid of 16 256px tiles, 4 a row: {grid.shape}")
    check(CheckpointManager(os.path.join(out, "models")).load()[0]["step"]
          == 2 * steps, "the resumed run's checkpoint step")
    log(f"  artifacts: {', '.join(want_files)}; the epoch grid "
        f"{grid.shape[1]}x{grid.shape[0]} (4 x 4 tiles of 256px); the run "
        "is kept for phase 43's sampler")
    return launches, {"run": out, "stage1_g": stage1_g, "data": data,
                      "imgs": imgs}


def _png_rgb(b64):
    """A served PNG decoded without an imaging library: (H, W, 3) uint8."""
    pixels, ctype, _ = decode_png(base64.b64decode(b64))
    check(ctype == 2, f"PNG colour type {ctype}, RGB expected")
    return pixels


def phase_stage2_serve():
    log(f"phase 29/52 s2serve: G1 + G2 eval forwards at batch "
        f"{S2_SERVE_BATCH}, card against CPU, full width; Stage2Service "
        "over HTTP on the card")
    s1, s2 = stage2_cfgs()
    # He-scale weights (he_randomize): the reference init's images are
    # near constant, and tests/test_step_parity.py's N(0, 0.05) weights
    # (randomize) grow G2's eval activations layer by layer until tanh's
    # zero crossings amplify float32 rounding (a card-CPU gap of 3.6e-2)
    g1_cpu = he_randomize(build_stage1_g(s1, seed=0, device="cpu"), 3)
    g2_cpu = he_randomize(build_stage2_g(s2, seed=0, device="cpu"), 4)
    g1_gpu = build_stage1_g(s1, g1_cpu.state_dict(), device=DEVICE)
    g2_gpu = build_stage2_g(s2, g2_cpu.state_dict(), device=DEVICE)
    data = stage2_data(S2_SERVE_BATCH, 29)
    rs = np.random.RandomState(29)
    z = torch.from_numpy(rs.randn(S2_SERVE_BATCH, s1.z_dim).astype(
        np.float32))
    batch = {k: torch.from_numpy(v) for k, v in data.items()}
    on_cpu = stage2_images(g1_cpu, g2_cpu, z, batch)
    on_gpu = stage2_images(g1_gpu, g2_gpu, z.to(DEVICE), {
        k: v.to(DEVICE) for k, v in batch.items()}).cpu()
    diff = float((on_gpu - on_cpu).abs().max())
    log(f"  G1 (ngf {s1.ngf}) + G2 (gf {s2.gf_dim}), seeded weights, eval, "
        f"batch {S2_SERVE_BATCH}: {tuple(on_gpu.shape)}, max |card - CPU| "
        f"{diff:.3e} (atol {MODEL_ATOL:g}); image std "
        f"{float(on_gpu.std()):.4f}")
    check(bool(torch.isfinite(on_gpu).all()), "stage 2: non-finite images")
    check(diff <= MODEL_ATOL, f"stage 2 card and CPU disagree: {diff:.3e}")

    k1.reset_launch_count()
    svc = Stage2Service(s1, s2, seed=0, device=DEVICE)
    svc.g1.load_state_dict(g1_cpu.state_dict())
    svc.g2.load_state_dict(g2_cpu.state_dict())
    httpd = serve(argparse.Namespace(variant="coco-stackgan-2",
                                     host="127.0.0.1", port=0,
                                     max_wait_ms=5.0), svc)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    try:
        items = _family_items("coco-stackgan-1", rs, 6)
        items[1]["bboxes_s2"] = [[0.1, 0.1, 0.5, 0.5]] * len(
            items[1]["bboxes"])
        t = time.perf_counter()
        status, body = _post(port, {"items": items})
        ms = (time.perf_counter() - t) * 1e3
        check(status == 200 and len(body["images"]) == len(items),
              f"stage-2 request: {status} {body.get('error')}")
        served = np.stack([_png_rgb(b) for b in body["images"]])
        check(served.shape == (len(items), 256, 256, 3),
              f"served {served.shape}, 256px RGB expected")
        bad = dict(items[0], bboxes_s2=items[0]["bboxes"] + [[0.1, 0.1, 0.2,
                                                              0.2]])
        status_bad, body_bad = _post(port, {"items": [bad]})
        check(status_bad == 400, f"a bboxes_s2 length mismatch got "
              f"{status_bad}, not 400")
        t = time.perf_counter()
        status_one, body_one = _post(port, {"items": items[:1]})
        one_ms = (time.perf_counter() - t) * 1e3
        check(status_one == 200 and _png_rgb(body_one["images"][0]).shape
              == (256, 256, 3), f"a 1-item request: {status_one}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.batcher.close()
        thread.join(timeout=30)
    got = (k1.launch_count(), k1.grad_launch_count())
    # the same items through the CPU generators, with the z and CA eps the
    # service drew (its second batch of its seeded generator)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    draws = [(torch.randn((svc.max_batch, s1.z_dim), generator=gen,
                          device=DEVICE),
              torch.randn((svc.max_batch, s1.condition_dim), generator=gen,
                          device=DEVICE)) for _ in range(2)]
    n = len(items)
    z, eps = (t[:n].cpu() for t in draws[1])
    lay = [_item_layout(it, s1.num_objects, s1.label_dim, rs) for it in items]
    bbox = np.stack([x[1] for x in lay])
    cbatch = {"bbox": torch.from_numpy(bbox),
              "bbox_s2": torch.from_numpy(np.stack([
                  _item_boxes_s2(it, bb) for it, bb in zip(items, bbox)])),
              "label_onehot": torch.from_numpy(np.stack([x[0] for x in lay])),
              "text_embedding": torch.tensor([it["text_embedding"]
                                              for it in items],
                                             dtype=torch.float32)}
    want = to_uint8(stage2_images(g1_cpu, g2_cpu, z, cbatch, eps).permute(
        0, 2, 3, 1).numpy())
    levels = int(np.abs(served.astype(np.int16) - want).max())
    log(f"  Stage2Service: {n} items (one with its own bboxes_s2) in "
        f"{ms:.1f} ms over HTTP, 1 item in {one_ms:.1f} ms (host clock, one "
        f"request each, device batch {svc.max_batch}); 256px RGB PNGs; the "
        f"{n} items against the CPU generators' "
        f"images of the same items, z and CA eps: max {levels} levels of 255 "
        f"(limit 1); a bboxes_s2 length mismatch: 400 ({body_bad['error']});"
        f" K1 launches {got[0]} for {svc.device_batches} device batches "
        f"(warm-up included; G1 and G2 each), K2 {got[1]}")
    check(levels <= 1, "stage-2 served images stray from the CPU's")
    check(got == (2 * svc.device_batches, 0) and svc.device_batches == 3,
          f"stage-2 serving K1/K2 launches {got}, device batches "
          f"{svc.device_batches}; (6, 0) and 3 expected")
    return {"serve_coco-stackgan-2": got}, ms



# ------------------------------------------------- COCO AttnGAN, serving

ATTN_DIR = os.path.join(ROOT, "runs_r5", "attngan_flagship")
ATTN_NET_G = os.path.join(ATTN_DIR, "netG_ema_final.pth")
ATTN_NET_E = os.path.join(ATTN_DIR, "damsm", "DAMSMencoders",
                          "text_encoder29.pth")
ATTN_CFG = os.path.join(ATTN_DIR, "coco_attn_sampling.yml")
ATTN_SET = (2048, 7)        # the flagship's data: write_synthetic_attngan
ATTN_WORDS = 140            # text_encoder29.pth's embedding rows
ATTN_BATCH = 64             # the service's device batch (cli/serve.py)
ATTN_CHECK_BATCH = 4        # the flagship forward card vs CPU (phase 31)
ATTN_SERVE_CHECK = 8        # served items held against the CPU (phase 32)
ATTN_TIME_RUNS = 5          # CUDA-event readings a forward time
# the flagship card vs CPU (phase 31): the images at MODEL_ATOL, the text
# encoder's embeddings and the attention maps at ATTN_ATOL (the CPU's
# port against JAX read 4e-5 on the images, 1.2e-7 on the embeddings,
# tests/test_torch_port_attngan_model.py)
ATTN_ATOL = 1e-4
FLAGSHIP_SEPARATION = 0.987  # runs_r5/attngan_flagship/result.json


def _attn_set():
    """The flagship's synthetic set in the work directory:
    write_synthetic_attngan(n=2048, seed=7) with its JPEGs (nvjpeg's
    encoder, ``<data>_imgs``), the vocabulary held to the encoder's 140
    rows."""
    data = os.path.join(WORK, "attngan_data")
    t = time.perf_counter()
    if not os.path.isdir(data):
        write_synthetic_attngan(data, data + "_imgs", n=ATTN_SET[0],
                                seed=ATTN_SET[1], device=DEVICE)
    ds = AttnGanDataset(data, split="test", captions_per_image=5)
    rows = load_text_encoder(ATTN_NET_E)["encoder.weight"].shape[0]
    log(f"  write_synthetic_attngan(n={ATTN_SET[0]}, seed={ATTN_SET[1]}) "
        f"and its vocabulary: {ds.n_words} words, the encoder's rows "
        f"{rows}, in {time.perf_counter() - t:.1f}s (host clock)")
    check(ds.n_words == rows == ATTN_WORDS, f"vocabulary {ds.n_words} words, "
          f"encoder {rows} rows; {ATTN_WORDS} expected")
    return data, ds


def _attn_inputs(ds, b, seed):
    """b test-split items as the service batches them: the captions' ids
    (cut at 12, zero-padded), lengths, the layouts (one-hot 81, a -1 label
    in slot 80, as the reference's readers give it) and z."""
    rs = np.random.RandomState(seed)
    idx = rs.choice(len(ds), b, replace=len(ds) < b)
    caps = np.zeros((b, 12), np.int64)
    lens = np.ones((b,), np.int64)
    for i, j in enumerate(idx):
        ids = ds.captions[int(j) * 5][:12]
        caps[i, :len(ids)], lens[i] = ids, len(ids)
    lab = ds.labels[idx].reshape(b, 3)
    onehot = np.zeros((b, 3, 81), np.float32)
    onehot[np.arange(b)[:, None], np.arange(3)[None, :],
           np.where(lab < 0, 80, lab)] = 1.0
    return {"caps": caps, "lens": lens, "bbox": ds.bboxes[idx],
            "label_onehot": onehot,
            "z": rs.randn(b, 100).astype(np.float32)}


def phase_attn_kernels():
    log(f"phase 30/52 attnkernels: K1 at AttnGAN's object pathway, "
        f"(B,3,192,16,16) -> 16x16, batch {ATTN_BATCH} and 1, f32 and bf16, "
        "against its plain version, and timed")
    rs = np.random.RandomState(30)
    dev = torch.device(DEVICE)
    c, hw = COCO_ATTN.ngf // 4, (16, 16)
    smem = {es: k1.place_smem_bytes(3, k1.place_tile(hw, hw), hw, hw, es)
            for es in (4, 2)}
    log(f"  K1 tile {k1.place_tile(hw, hw)} channels, shared memory {smem[4]}"
        f" B (f32), {smem[2]} B (bf16) of {k1.MAX_PLACE_SMEM}")
    check(max(smem.values()) <= k1.MAX_PLACE_SMEM, "K1 shared memory")
    out = {"max_abs_err": 0.0, "max_abs_err_bf16": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype)[6:]
        worst = "max_abs_err" if dtype == torch.float32 else \
            "max_abs_err_bf16"
        for b in (ATTN_BATCH, 1):
            bbox = _service_boxes(rs, b, 3)
            bbox[:, 2] = -1.0                 # a padded third object
            bbox = torch.from_numpy(bbox).to(dev)
            feats = torch.from_numpy(rs.randn(b, 3, c, *hw).astype(
                np.float32)).to(dev).to(dtype)
            label = f"batch {b} {tname} {tuple(feats.shape)} -> {hw}"
            got = k1.stn_place_multi_nchw(feats, bbox, hw)
            out[worst] = max(out[worst], _held(
                got, k1.stn_place_multi_plain(feats, bbox, hw), dtype, "K1",
                label))
            first = k1.stn_place_multi_nchw(feats[:, :2].contiguous(),
                                            bbox[:, :2].contiguous(), hw)
            torch.cuda.synchronize()
            check(torch.equal(got, first), f"K1 {label}: the padded object "
                  "changed the sums of the others")
            log(f"  K1 {label}: equal bit for bit to the two unpadded "
                "objects alone")
            row = time_place(feats, bbox, hw, f"K1 AttnGAN batch {b}")
            out.setdefault(tname, {})[f"batch{b}"] = {
                k: row[k] for k in ("ms", "plain_ms", "graph_ms", "bound_ms",
                                    "bound_by", "share_of_bound",
                                    "graph_share_of_bound")}
    return out


def _flops_by_stage(g, enc, inputs):
    """GFLOP of one image by torch.utils.flop_counter (convs and matmuls:
    K1, BatchNorm and the activations are not counted) at each stage:
    h_net1 (its object pathway, local1 and local2, apart), h_net2, h_net3,
    the image heads and the text encoder."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc, torch.inference_mode():
        attngan_images(enc, g, *inputs)
    counts = fc.get_flop_counts()
    b = inputs[0].shape[0]

    def total(prefix):
        return sum(sum(v.values()) for k, v in counts.items()
                   if k == prefix) / b / 1e9

    out = {name: total(f"GNet.{name}") for name in (
        "h_net1", "h_net2", "h_net3", "img_net1", "img_net2", "img_net3")}
    out["object_pathway"] = (total("GNet.h_net1.local1")
                             + total("GNet.h_net1.local2"))
    out["text_encoder"] = total("RNNEncoder")
    out["total"] = fc.get_total_flops() / b / 1e9
    return out


PROFILE_CALLS = 1           # calls a torch.profiler trace reads


def _profile_forward(fn, n: int = PROFILE_CALLS):
    """Device ms of ``fn`` by kernel group (tools/profile_step.py's), over
    ``n`` calls traced with torch.profiler after one untraced call:
    returns (wall ms a call on the host clock, busy ms a call, {group: ms
    a call}, the top 5 kernels as (ms a call, name))."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = profile_step.kernel_times(prof)
    groups = {g: ms / n for g, ms in
              profile_step.group_times(kernels).items()}
    top = sorted(((ms / n, name) for name, ms in kernels.items()),
                 reverse=True)[:5]
    return wall, sum(kernels.values()) / n, groups, top


def phase_attn_model():
    log("phase 31/52 attnmodel: the flagship AttnGAN (netG_ema_final.pth, "
        "text_encoder29.pth) card against CPU, and its forward timed")
    data, ds = _attn_set()
    mcfg = attngan_model_config(cfg_from_file(ATTN_CFG, "coco-attngan"))
    check(mcfg.ngf == 768 and mcfg.r_num == 3 and mcfg.branch_num == 3,
          f"flagship widths {mcfg}")
    g_sd, e_sd = load_reference_attngan_g(ATTN_NET_G), \
        load_text_encoder(ATTN_NET_E)
    nets = {dev: (build_text_encoder(ds.n_words, 256, e_sd, device=dev),
                  build_attngan_g(mcfg, g_sd, device=dev))
            for dev in (DEVICE, "cpu")}
    n_params = sum(p.numel() for p in nets["cpu"][1].parameters())
    log(f"  G: GF {mcfg.gf_dim} (ngf {mcfg.ngf}), R_NUM {mcfg.r_num}, "
        f"{mcfg.branch_num} branches, {n_params} parameters; text encoder "
        f"{ds.n_words} words, bi-LSTM 2 x 128")
    x = _attn_inputs(ds, ATTN_CHECK_BATCH, 31)
    got = {}
    for dev, (enc, g) in nets.items():
        t = {k: torch.from_numpy(v).to(dev) for k, v in x.items()}
        with torch.inference_mode():
            words, sent = enc(t["caps"], t["lens"].cpu())
            o = g.outputs(t["z"], sent, words, t["caps"] == 0, t["bbox"],
                          t["label_onehot"])
        got[dev] = [words, sent, *o.imgs, *o.att_maps]
    names = ["words", "sent", "img64", "img128", "img256", "att64",
             "att128"]
    errs = {}
    for name, a, b in zip(names, got[DEVICE], got["cpu"]):
        check(bool(torch.isfinite(a).all()), f"flagship {name} non-finite")
        errs[name] = float((a.cpu() - b).abs().max())
    log(f"  card vs CPU, batch {ATTN_CHECK_BATCH}, float32 (TF32 off): "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (images: atol {MODEL_ATOL:g}; the rest {ATTN_ATOL:g}); 256px "
        f"std {float(got['cpu'][4].std()):.4f}")
    for k, v in errs.items():
        check(v <= (MODEL_ATOL if k.startswith("img") else ATTN_ATOL),
              f"flagship {k}: card and CPU disagree by {v:.3e}")

    enc, g = nets[DEVICE]
    x = _attn_inputs(ds, ATTN_BATCH, 32)
    dev_in = [torch.from_numpy(x["caps"]).to(DEVICE),
              torch.from_numpy(x["lens"]),
              torch.from_numpy(x["bbox"]).to(DEVICE),
              torch.from_numpy(x["label_onehot"]).to(DEVICE),
              torch.from_numpy(x["z"]).to(DEVICE)]
    flops = _flops_by_stage(g, enc, [t[:1] for t in dev_in])
    log("  GFLOP an image (torch.utils.flop_counter, batch 1): "
        + ", ".join(f"{k} {v:.3f}" for k, v in flops.items()))
    rows = {}
    g16 = build_attngan_g(dataclasses.replace(
        mcfg, compute_dtype=torch.bfloat16), g_sd, device=DEVICE)
    for tname, gen in (("float32", g), ("bfloat16", g16)):
        k1.reset_launch_count()
        img = attngan_images(enc, gen, *dev_in)
        torch.cuda.synchronize()
        launches = k1.launch_count()
        check(launches == 1, f"{tname} forward: {launches} K1 launches, 1 "
              "expected")
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: attngan_images(enc, gen, *dev_in), warmup=2,
                     runs=ATTN_TIME_RUNS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        tflops = flops["total"] * ATTN_BATCH / ms   # GFLOP / ms = TFLOP/s
        rows[tname] = {"ms": ms, "images_per_s": ATTN_BATCH * 1e3 / ms,
                       "peak_gib": peak, "k1_launches_per_forward": launches,
                       "tflop_per_s": tflops}
        log(f"  text encoder + G forward at batch {ATTN_BATCH}, {tname}: "
            f"{ms:.2f} ms (CUDA events, median of {ATTN_TIME_RUNS}), "
            f"{ATTN_BATCH * 1e3 / ms:.0f} images/s, {tflops:.1f} TFLOP/s of "
            f"the counted convs and matmuls, peak {peak:.2f} GiB, K1 "
            f"launches a forward {launches}")
        wall, busy, groups, top = _profile_forward(
            lambda: attngan_images(enc, gen, *dev_in))
        rows[tname].update(profiled_wall_ms=wall, busy_ms=busy,
                           groups_ms=groups)
        log(f"  {tname} forward traced (torch.profiler, {PROFILE_CALLS} "
            "forward): "
            f"{wall:.2f} ms a forward on the host clock, the device busy "
            f"{busy:.2f} ms ({busy / wall:.1%}); by kernel group: "
            + ", ".join(f"{g} {ms:.2f}" for g, ms in sorted(
                groups.items(), key=lambda kv: -kv[1]))
            + "; top kernels: " + "; ".join(
                f"{ms:.2f} ms {name[:70]}" for ms, name in top))
        if tname == "float32":
            img32 = img
    diff = (img.float() - img32).abs()
    log(f"  bf16 256px images against float32: mean |diff| "
        f"{float(diff.mean()):.4f}, max {float(diff.max()):.4f}")
    check(float(diff.mean()) <= MAX_BF16_SERVE_MEAN_DIFF,
          "bf16 AttnGAN images stray from the float32 ones")
    return {"data": data, "ds": ds, "mcfg": mcfg, "g_cpu": nets["cpu"][1],
            "enc_cpu": nets["cpu"][0], "flops": flops, "rows": rows,
            "card_vs_cpu": errs}


def _attn_items(ds, n, seed):
    """n request items from the test split: each caption as text (its
    first caption's words), each layout as class ids and boxes."""
    rs = np.random.RandomState(seed)
    items = []
    for j in rs.choice(len(ds), n, replace=len(ds) < n):
        words = [ds.ixtoword[i] for i in ds.captions[int(j) * 5]]
        keep = ds.bboxes[j][:, 0] >= 0
        items.append({"caption": " ".join(words),
                      "labels": [int(v) for v in ds.labels[j][keep, 0]],
                      "bboxes": ds.bboxes[j][keep].round(4).tolist()})
    return items


def phase_attn_serve(model):
    log("phase 32/52 attnserve: cli/serve.py --variant coco-attngan on the "
        "card from the flagship weights, over HTTP")
    ds = model["ds"]
    cfg_file = os.path.join(WORK, "coco_attn_serve.yml")
    with open(ATTN_CFG) as f:
        lines = f.read().splitlines()
    subs = {"NET_G:": ATTN_NET_G, "NET_E:": ATTN_NET_E,
            "DATA_DIR:": model["data"]}
    with open(cfg_file, "w") as f:
        for line in lines:
            key = line.strip().split(" ")[0]
            if key in subs:
                line = f"{line[:line.index(key)]}{key} '{subs[key]}'"
            f.write(line + "\n")
    k1.reset_launch_count()
    args = serve_parse_args(["--variant", "coco-attngan", "--cfg", cfg_file,
                             "--data_dir", model["data"], "--port", "0",
                             "--device", DEVICE])
    t = time.perf_counter()
    httpd = serve(args)
    build_s = time.perf_counter() - t
    svc = httpd.service
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    log(f"  serving on 127.0.0.1:{port} in {build_s:.1f}s (host clock, the "
        f"warm-up batch included); weights: {svc.weights}")
    items = _attn_items(ds, svc.max_batch, 32)
    items[1]["caption"] += " with a zebra and qwerty"     # OOV words
    items[2]["caption"] = "zebra qwerty asdfgh"            # all OOV
    try:
        results = [None] * 8

        def call(i):
            results[i] = _post(port, {"items": [
                items[(i + k) % len(items)] for k in range(1 + i % 3)]})

        threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        conc_ms = (time.perf_counter() - t) * 1e3
        for i, (status, body) in enumerate(results):
            check(status == 200 and len(body["images"]) == 1 + i % 3,
                  f"concurrent request {i}: {status} {body.get('error')}")
        before = svc.device_batches
        t = time.perf_counter()
        status, body = _post(port, {"items": items})
        full_ms = (time.perf_counter() - t) * 1e3
        check(status == 200 and len(body["images"]) == svc.max_batch,
              f"{svc.max_batch}-item request: {status} {body.get('error')}")
        check(svc.device_batches == before + 1, "the full request took "
              f"{svc.device_batches - before} device batches, 1 expected")
        served = np.stack([_png_rgb(b) for b in body["images"]])
        check(served.shape == (svc.max_batch, 256, 256, 3),
              f"served {served.shape}, 256px RGB expected")
        bad = dict(items[0], labels=[81] * len(items[0]["labels"]))
        status_bad, body_bad = _post(port, {"items": [bad]})
        check(status_bad == 400, f"a label id of 81 got {status_bad}, not 400")
        status_cap, body_cap = _post(port, {"items": [{"caption": 7}]})
        check(status_cap == 400, f"a non-string caption got {status_cap}")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.batcher.close()
        thread.join(timeout=30)
    got = (k1.launch_count(), k1.grad_launch_count())
    check(stats["k1_launches"] == got[0] == svc.device_batches
          and got[1] == 0, f"K1/K2 launches {got}, /stats "
          f"{stats['k1_launches']}, device batches {svc.device_batches}; one "
          "K1 launch a device batch and no K2 expected")
    # the first items through the CPU nets, with the z the service drew for
    # the 64-item request (draw number before + 1 of its seeded generator)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    for _ in range(before):
        torch.randn((svc.max_batch, svc.mcfg.z_dim), generator=gen,
                    device=DEVICE)
    z = torch.randn((svc.max_batch, svc.mcfg.z_dim), generator=gen,
                    device=DEVICE)[:ATTN_SERVE_CHECK].cpu()
    arr = svc.batch(items[:ATTN_SERVE_CHECK])
    n = ATTN_SERVE_CHECK
    want = attngan_images(
        model["enc_cpu"], model["g_cpu"], torch.from_numpy(arr["caps"][:n]),
        torch.from_numpy(arr["lens"][:n]), torch.from_numpy(arr["bbox"][:n]),
        torch.from_numpy(arr["label_onehot"][:n]), z)
    want = to_uint8(want.permute(0, 2, 3, 1).numpy())
    levels = int(np.abs(served[:n].astype(np.int16) - want).max())
    tokens = [svc.token_ids(items[i]["caption"]) for i in (1, 2)]
    in_box, out_box = _separation(
        served, [np.asarray(it["bboxes"]) for it in items])
    log(f"  8 concurrent requests of 1-3 items in {conc_ms:.1f} ms, a "
        f"{svc.max_batch}-item request in {full_ms:.1f} ms (host clock, over "
        f"HTTP); "
        f"256px RGB PNGs; the first {n} items against the CPU nets' images "
        f"of the same items and z: max {levels} levels of 255 (limit 1); an "
        f"OOV-mixed caption's ids {tokens[0]}, an all-OOV one's {tokens[1]} "
        f"(the largest id, {svc.max_word}); a label id of 81: 400 "
        f"({body_bad['error']}); a non-string caption: 400; /stats: "
        f"{stats['device_batches']} device batches (warm-up included), K1 "
        f"launches {stats['k1_launches']}, K2 {got[1]}")
    log(f"  separation of the {len(served)} served images (in-box minus out-of-box "
        f"mean luminance, [-1, 1]): {in_box - out_box:.3f} (in {in_box:.3f}, "
        f"out {out_box:.3f}); the flagship's result.json read "
        f"{FLAGSHIP_SEPARATION} after training. Printed, not held")
    check(levels <= 1, "AttnGAN served images stray from the CPU's")
    check(tokens[1] == [svc.max_word], "the all-OOV caption's ids")
    return {"serve_coco-attngan": got}, {
        "concurrent_ms": conc_ms, "request64_ms": full_ms,
        "separation": in_box - out_box, "levels": levels}


# --------------------------------------------------- AttnGAN training

ATTN_TRAIN_CFG = os.path.join(ATTN_DIR, "coco_attn_full.yml")
ATTN_IMAGE_E = os.path.join(ATTN_DIR, "damsm", "DAMSMencoders",
                            "image_encoder29.pth")
ATTN_TRAIN_BATCH = 14       # cfg/coco_attn_train.yml TRAIN.BATCH_SIZE
ATTN_WIDTHS = (48, 96, 3, 3, 256)  # GF, DF, R_NUM, branches, embedding
ATTN_STEP_BATCH = 4         # the step card vs CPU (phase 34)
ATTN_ENCODER_BATCH = 2      # the image encoder card vs CPU (phase 34)
ATTN_STEP_RUNS = 5          # CUDA-event readings a step time (phase 35)
# K1 a step: G's object pathway 1, D64 twice in the D update and once in
# the G update; K2 the backward of each of those places
ATTN_LAUNCHES = (4, 4)
# the step card vs CPU: the DAMSM losses are LAMBDA (50) times
# cross-entropies, hundreds in all, so the losses are held at LOSS_ATOL
# plus ATTN_LOSS_RTOL of their value
ATTN_LOSS_RTOL = 1e-5


def attn_train_shapes():
    """AttnGAN's train places: G's object pathway (O, ngf / 4, 16x16) onto
    16x16 and D64's (O, 2 * df, 15x15) onto 16x16."""
    m = attngan_model_config(cfg_from_file(ATTN_TRAIN_CFG, "coco-attngan"))
    return {"G": (m.num_objects, m.ngf // 4, (16, 16), (16, 16)),
            "D64": (m.num_objects, 2 * m.df_dim, (15, 15), (16, 16))}


def phase_attn_train_kernels():
    log(f"phase 33/52 attnplaces: K1 and K2 at AttnGAN's train places, "
        f"batch {ATTN_TRAIN_BATCH}, against their plain versions, f32 and "
        "bf16, and timed")
    return held_and_timed_places(attn_train_shapes(), ATTN_TRAIN_BATCH,
                                 ATTN_LAUNCHES, np.random.RandomState(33))


def _attn_train_batch(ds, b, seed):
    """A train batch of ``b`` items of the flagship set's test split (its
    140-word vocabulary): captions cut at 12 and their lengths, layouts and
    one-hots (``_attn_inputs``), class ids, and uint8 images at 64, 128 and
    256 drawn as the synthetic set's writer draws them (dark noise, each
    box in its label's colour)."""
    x = _attn_inputs(ds, b, seed)
    rs = np.random.RandomState(seed + 1)
    batch = {"captions": x["caps"], "cap_lens": x["lens"],
             "bbox": x["bbox"], "label_onehot": x["label_onehot"],
             "class_ids": rs.permutation(b).astype(np.int64)}
    labels = x["label_onehot"].argmax(-1)
    for side in (64, 128, 256):
        img = (rs.rand(b, side, side, 3) * 40).astype(np.uint8)
        for i in range(b):
            for j, (bx, by, bw, bh) in enumerate(x["bbox"][i]):
                if bx < 0:
                    continue
                img[i, int(by * side):int((by + bh) * side),
                    int(bx * side):int((bx + bw) * side)] = [
                        120 + 135 * ((labels[i, j] * k) % 9) // 8
                        for k in (1, 2, 3)]
        batch[f"image{side}"] = img
    return batch


def _attn_state(device, mcfg, g_sd, d_sds):
    """An AttnGAN train state on ``device`` holding ``g_sd`` and
    ``d_sds``, with fresh Adams and the EMA at G's parameters."""
    g = build_attngan_g(mcfg, g_sd, device=device).train()
    ds = {n: build_attngan_d(mcfg, 64 * 2 ** i, d_sds[n],
                             device=device).train()
          for i, n in enumerate(d_sds)}
    return AttnGanTrainState(
        g=g, ds=ds, g_opt=make_optimizer(g.parameters()),
        d_opts={n: make_optimizer(d.parameters()) for n, d in ds.items()},
        g_ema=ema_of(g))


def _attn_nets(device, mcfg, g_sd, d_sds, vocab, e_sd, i_sd):
    """:func:`_attn_state`, and the frozen text and image encoders."""
    state = _attn_state(device, mcfg, g_sd, d_sds)
    text = build_text_encoder(vocab, mcfg.embedding_dim, e_sd,
                              device=device)
    image = build_image_encoder(mcfg.embedding_dim, i_sd,
                                compute_dtype=mcfg.compute_dtype,
                                device=device)
    return state, text, image


def _flagship_attn_weights(mcfg):
    """The flagship EMA G, seeded Ds (d64 from seed 1, d128 from 2, d256
    from 3; AttnGAN's orthogonal init, its QR on the card) and the
    flagship DAMSM encoders, as state dicts on the CPU."""
    t = time.perf_counter()
    d_sds = {n: {k: v.cpu() for k, v in build_attngan_d(
                 mcfg, 64 * 2 ** i, seed=1 + i,
                 device=DEVICE).state_dict().items()}
             for i, n in enumerate(D_NAMES[:mcfg.branch_num])}
    log(f"  the Ds' orthogonal init (normal draws on the CPU, QR on the "
        f"card): {time.perf_counter() - t:.1f} s (host clock); parameters "
        + ", ".join(
            f"{n} {sum(v.numel() for k, v in sd.items() if 'running' not in k and 'num_batches' not in k)}"
            for n, sd in d_sds.items()))
    return (load_reference_attngan_g(ATTN_NET_G), d_sds,
            load_text_encoder(ATTN_NET_E), load_image_encoder(ATTN_IMAGE_E))


def attn_step_once(device, mcfg, weights, batch, z, eps):
    """One full-width AttnGAN step on ``device`` from ``weights`` and warm
    Adams (:func:`warm_adam`), with the noise given. Returns (losses, the
    state dicts before and after, the gradients (G's, and each D's of its
    update), host seconds, the EMA after) in :func:`step_disagreements`'
    form, nets keyed G, d64, d128, d256."""
    g_sd, d_sds, e_sd, i_sd = weights
    state, text, image = _attn_nets(device, mcfg, g_sd, d_sds,
                                    ATTN_WORDS, e_sd, i_sd)
    warm_adam(state)
    nets = {"G": state.g, **state.ds}
    pre = {n: {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
           for n, m in nets.items()}
    dev_batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    t = time.perf_counter()
    metrics = make_attngan_train_step(mcfg, text, image)(
        state, dev_batch, None, LR, LR, z=torch.from_numpy(z).to(device),
        eps=torch.from_numpy(eps).to(device))
    metrics = {k: float(v) for k, v in metrics.items()}
    seconds = time.perf_counter() - t
    post = {n: {k: v.detach().cpu() for k, v in m.state_dict().items()}
            for n, m in nets.items()}
    grads = {n: {k: (torch.zeros(p.shape) if p.grad is None
                     else p.grad.detach().float().cpu())
                 for k, p in m.named_parameters()} for n, m in nets.items()}
    ema = {k: v.detach().cpu() for k, v in state.g_ema.items()}
    return metrics, pre, post, grads, seconds, ema


def phase_attn_step():
    log(f"phase 34/52 attnstep: image_encoder29.pth card against CPU at "
        f"batch {ATTN_ENCODER_BATCH} from 256px; one full-width AttnGAN step "
        f"at batch {ATTN_STEP_BATCH} card against CPU from warm Adams")
    mcfg = attngan_model_config(cfg_from_file(ATTN_TRAIN_CFG, "coco-attngan"))
    check((mcfg.gf_dim, mcfg.df_dim, mcfg.r_num, mcfg.branch_num,
           mcfg.embedding_dim) == ATTN_WIDTHS,
          f"cfg/coco_attn_train.yml's widths: {mcfg}")
    weights = _flagship_attn_weights(mcfg)
    rs = np.random.RandomState(34)
    x = rs.uniform(-1, 1, (ATTN_ENCODER_BATCH, 3, 256, 256)).astype(
        np.float32)
    enc = {}
    for dev in (DEVICE, "cpu"):
        e = build_image_encoder(256, weights[3], device=dev)
        with torch.no_grad():
            enc[dev] = [t.cpu() for t in e(torch.from_numpy(x).to(dev))]
    enc_err = [float((a - b).abs().max()) for a, b in zip(enc[DEVICE],
                                                         enc["cpu"])]
    log(f"  image encoder card vs CPU (float32, TF32 off): regions "
        f"{enc_err[0]:.3e}, codes {enc_err[1]:.3e} (atol {ATTN_ATOL:g}; "
        f"|regions| up to {float(enc['cpu'][0].abs().max()):.4f}, |codes| up "
        f"to {float(enc['cpu'][1].abs().max()):.4f})")
    check(max(enc_err) <= ATTN_ATOL, "image encoder card vs CPU")
    _, ds = _attn_set()
    batch = _attn_train_batch(ds, ATTN_STEP_BATCH, 34)
    z = rs.randn(ATTN_STEP_BATCH, mcfg.z_dim).astype(np.float32)
    eps = rs.randn(ATTN_STEP_BATCH, mcfg.condition_dim).astype(np.float32)
    cpu = attn_step_once("cpu", mcfg, weights, batch, z, eps)
    card = attn_step_once(DEVICE, mcfg, weights, batch, z, eps)
    log(f"  step on the CPU {cpu[4]:.1f} s ({torch.get_num_threads()} "
        f"threads), on the card {card[4]:.2f} s (host clock, first call)")
    bad, worst = step_disagreements(card[:4], cpu[:4],
                                    loss_rtol=ATTN_LOSS_RTOL)
    cos, mean_lr, flip = delta_readings(card[:4], cpu[:4])
    log("  losses card / CPU: " + "; ".join(
        f"{k} {card[0][k]:.6f} / {cpu[0][k]:.6f}" for k in sorted(cpu[0])))
    log(f"    worst: loss {worst['loss']:.3e} ({worst['loss_rel']:.2e} of "
        f"the loss; limit {LOSS_ATOL:g} + {ATTN_LOSS_RTOL:g} of it); "
        f"BatchNorm running stats {worst['stats']:.3e} (atol "
        f"{STATS_ATOL:g}); per-tensor gradient cosine "
        f"{worst['grad_cosine']:.8f} (limit {MIN_GRAD_COSINE:g}); Adam "
        f"deltas (read): cosine {cos:.8f}, mean |difference| {mean_lr:.5f} "
        f"lr, {flip:.4%} of the elements apart by more than 0.5 lr")
    ema_err = max(float((card[5][k] - cpu[5][k]).abs().max())
                  for k in cpu[5])
    ema_want = max(float((card[5][k] - (0.999 * card[1]["G"][k] + 0.001
                                        * card[2]["G"][k])).abs().max())
                   for k in card[5])
    log(f"    EMA card vs CPU max |diff| {ema_err:.3e}; the card's EMA "
        f"against 0.999 pre + 0.001 post {ema_want:.3e}")
    for msg in bad:
        log(f"    FAILED {msg}")
    check(not bad, f"AttnGAN step card vs CPU: {len(bad)} checks failed")
    check(ema_want <= 1e-6, "the EMA is not 0.999 * ema + 0.001 * param")
    check(all(card[0][k] > 0 for k in ("w_loss", "s_loss", "kl_loss")),
          "the DAMSM and KL terms must be in the G loss")
    return {"encoder": enc_err, "worst": worst, "adam_delta_cosine": cos,
            "ema": ema_err, "weights": weights, "ds": ds}


def _flop_count(fn) -> float:
    """GFLOP of ``fn()`` by torch.utils.flop_counter: the convs and matmuls
    (K1, K2, BatchNorm, the activations and Adam are not counted)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops() / 1e9


def phase_attn_step_time(model):
    log(f"phase 35/52 attntime: the AttnGAN step at batch "
        f"{ATTN_TRAIN_BATCH} on the card, float32 and bf16: CUDA events, "
        "launches, peak memory, GFLOP and the device's kernel groups")
    g_sd, d_sds, e_sd, i_sd = model["weights"]
    dev = torch.device(DEVICE)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             _attn_train_batch(model["ds"], ATTN_TRAIN_BATCH, 35).items()}
    out = {}
    for dtype in (None, torch.bfloat16):
        kind = "bf16" if dtype else "f32"
        mcfg = attngan_model_config(cfg_from_file(ATTN_TRAIN_CFG,
                                                  "coco-attngan"),
                                    compute_dtype=dtype)
        state, text, image = _attn_nets(dev, mcfg, g_sd, d_sds, ATTN_WORDS,
                                        e_sd, i_sd)
        step = make_attngan_train_step(mcfg, text, image)
        gen = torch.Generator(device=dev).manual_seed(0)

        def one():
            return step(state, batch, gen, LR, LR)

        for _ in range(3):
            one()
        flops = _flop_count(one)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1.reset_launch_count()
        times = []
        for _ in range(ATTN_STEP_RUNS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = one()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        per_step = (k1.launch_count() / ATTN_STEP_RUNS,
                    k1.grad_launch_count() / ATTN_STEP_RUNS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms = statistics.median(times)
        check(all(bool(torch.isfinite(v)) for v in metrics.values()),
              f"non-finite AttnGAN losses while timing ({kind})")
        tflops = flops / ms                 # GFLOP / ms = TFLOP/s
        log(f"coco-attngan step at batch {ATTN_TRAIN_BATCH}, full width, "
            f"{kind}{'' if dtype else ' (TF32 off)'}: {ms:.2f} ms (CUDA "
            f"events, median of {ATTN_STEP_RUNS}; min {min(times):.2f}, max "
            f"{max(times):.2f}) = {ATTN_TRAIN_BATCH * 1e3 / ms:.1f} images/s;"
            f" peak memory {peak:.2f} GiB; launches per step: K1 "
            f"{per_step[0]:g}, K2 {per_step[1]:g}; {flops:.1f} GFLOP a step "
            f"({flops / ATTN_TRAIN_BATCH:.1f} an image; "
            "torch.utils.flop_counter, forward and backward), "
            f"{tflops:.1f} TFLOP/s of them")
        check(per_step == ATTN_LAUNCHES, f"AttnGAN K1/K2 launches per step "
              f"{per_step} != {ATTN_LAUNCHES}")
        wall, busy, groups, top = _profile_forward(one)
        log(f"  {kind} step traced (torch.profiler, {PROFILE_CALLS} step): "
            f"{wall:.2f} ms "
            f"a step on the host clock, the device busy {busy:.2f} ms "
            f"({busy / wall:.1%}); by kernel group: " + ", ".join(
                f"{g} {v:.2f}" for g, v in sorted(groups.items(),
                                                  key=lambda kv: -kv[1]))
            + "; top kernels: " + "; ".join(
                f"{v:.2f} ms {name[:70]}" for v, name in top))
        out[kind] = {"ms": ms, "images_per_s": ATTN_TRAIN_BATCH * 1e3 / ms,
                     "peak_gib": peak, "launches_per_step": per_step,
                     "gflop_per_step": flops, "tflop_per_s": tflops,
                     "profiled_wall_ms": wall, "busy_ms": busy,
                     "groups_ms": groups}
        del state, text, image, step
        torch.cuda.empty_cache()
    log(f"AttnGAN step bf16 {out['bf16']['ms']:.2f} ms beside float32 "
        f"{out['f32']['ms']:.2f} ms: {out['f32']['ms'] / out['bf16']['ms']:.2f}"
        "x")
    return out


def _attn_entry_cfg():
    """A copy of runs_r5/attngan_flagship/coco_attn_full.yml in the work
    directory: NET_G the flagship EMA G (a warm start), B_NET_D False,
    NET_E the flagship text encoder (its 140 rows cover the n = 32 set's
    vocabulary; image_encoder29.pth beside it)."""
    with open(ATTN_TRAIN_CFG) as f:
        text = f.read()
    lines = []
    for line in text.splitlines():
        key = line.strip().split(":")[0]
        if key == "NET_G":
            line = f"    NET_G: '{ATTN_NET_G}'"
        elif key == "NET_E":
            line = f"    NET_E: '{ATTN_NET_E}'"
        elif key == "B_NET_D":
            line = "    B_NET_D: False"
        lines.append(line)
    path = os.path.join(WORK, "coco_attn_full.yml")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _attn_gap(run, ref, epoch, steps):
    """``run`` against ``ref`` at ``epoch``: the largest difference of the
    losses both logged at the epoch's first step (absolute, and over the
    loss), the lowest per-tensor cosine of G's, the Ds' and the EMA's
    tensors, and their distance over the reference's norm."""
    a = CheckpointManager(os.path.join(run, "models")).load(epoch)[0]
    b = CheckpointManager(os.path.join(ref, "models")).load(epoch)[0]
    first = a["step"] - steps
    la, lb = _logged(run, first), _logged(ref, first)
    pairs = [("g", a["g"], b["g"]), ("g_ema", a["g_ema"], b["g_ema"])]
    pairs += [(n, a["d"][n], b["d"][n]) for n in b["d"]]
    cos, worst, rel_dist = _tensor_gap(pairs)
    return {"first_step": max(abs(la[k] - lb[k]) for k in lb),
            "first_step_rel": max(abs(la[k] - lb[k]) / max(abs(lb[k]), 1e-12)
                                  for k in lb),
            "first_step_held": all(
                abs(la[k] - lb[k]) <= RESUME_FIRST_STEP_ATOL
                + ATTN_LOSS_RTOL * abs(lb[k]) for k in lb),
            "min_cosine": cos, "worst_tensor": worst,
            "rel_dist": rel_dist, "steps": (a["step"], b["step"])}


def _tensor_gap(pairs):
    """Two runs' state dicts as ``(net, run's, reference's)`` pairs: the lowest
    per-tensor cosine of their floating tensors other than BatchNorm's
    running statistics, its tensor, and their distance over the second's
    norm."""
    cos, dist, norm = {}, 0.0, 0.0
    for net, sa, sb in pairs:
        for k, v in sa.items():
            if not v.is_floating_point() or "running_" in k:
                continue
            cos[f"{net}.{k}"] = _cosine(v, sb[k])
            dist += float((v.double() - sb[k].double()).square().sum())
            norm += float(sb[k].double().square().sum())
    worst = min(cos, key=cos.get)
    return cos[worst], worst, (dist / norm) ** 0.5


def phase_attn_entry():
    log("phase 36/52 attnentry: cli/main.py --variant coco-attngan "
        "--synthetic on the card from a copy of coco_attn_full.yml (NET_G "
        "the flagship EMA G, its DAMSM encoders): 3 epochs, a resume from "
        "its epoch-1 checkpoint held against it, and one epoch with --bf16")
    cfg_file = _attn_entry_cfg()
    data = os.path.join(WORK, "attngan_train")
    runs = {n: os.path.join(WORK, "runs", f"attn_{n}")
            for n in ("straight", "resumed", "bf16")}
    items = train_main.synthetic_items("coco-attngan", ATTN_TRAIN_BATCH)
    steps = items // ATTN_TRAIN_BATCH
    base = ["--variant", "coco-attngan", "--cfg", cfg_file, "--data_dir",
            data, "--img_dir", data + "_imgs", "--synthetic", "--manualSeed",
            "7"]
    launches = {}

    def entry(key, name, out, epochs, *extra):
        k4.reset_launch_count()
        hist, got, _ = _entry(name, [*base, "--output_dir", out,
                                     "--max_epochs", str(epochs), *extra])
        launches[key] = (*got, k4.launch_count())
        for h in hist:
            check(h["steps"] == steps and all(np.isfinite(v)
                                              for v in h.values())
                  and h["w_loss"] > 0 and h["s_loss"] > 0,
                  f"{name}: epoch {h}")
        return hist

    hist = entry("train_coco-attngan", "coco-attngan, 3 epochs",
                 runs["straight"], 3, "--snapshot_interval", "2")
    # K1: 4 a step, the montage after step 0 and one an epoch end; K2: 4
    # a step
    check(launches["train_coco-attngan"] == (4 * 3 * steps + 1 + 3,
                                            4 * 3 * steps, 0),
          f"K1/K2/K4 launches {launches['train_coco-attngan']}")
    _resume_copy(runs["straight"], 1, runs["resumed"])
    hist_r = entry("train_coco-attngan_resume",
                   "coco-attngan, resumed from epoch 1 to 3",
                   runs["resumed"], 3, "--resume", runs["resumed"])
    check(len(hist_r) == 1 and launches["train_coco-attngan_resume"]
          == (4 * steps + 1, 4 * steps, 0),
          f"the resume: {len(hist_r)} epochs, launches "
          f"{launches['train_coco-attngan_resume']}")
    hist_b = entry("train_coco-attngan_bf16", "coco-attngan --bf16, 1 "
                   "epoch", runs["bf16"], 1, "--bf16",
                   "--snapshot_interval", "0")
    out = runs["straight"]
    with open(os.path.join(out, "run_flags.json")) as f:
        flags = json.load(f)
    check(flags["encoders"] == {"text_encoder": "imported",
                                "image_encoder": "imported"}
          and flags["net_e"] == ATTN_NET_E, f"run_flags.json: {flags}")
    want = [os.path.join("logs", "metrics.jsonl"), "run_flags.json",
            os.path.basename(cfg_file),
            os.path.join("src_snapshot", "cli", "attngan_runner.py"),
            os.path.join("images", "real_samples.png"),
            os.path.join("images", "fake_samples_step_0000000.png"),
            os.path.join("images", "attention_maps_step_0000000.png")]
    want += [os.path.join("images", f"{kind}_epoch_{e:03d}.png")
             for kind in ("fake_samples", "attention_maps") for e in range(3)]
    want += [os.path.join("models", str(e), "state.pth") for e in (1, 2)]
    missing = [w for w in want if not os.path.isfile(os.path.join(out, w))]
    check(not missing, f"{out}: missing {missing}")
    montage = read_png(os.path.join(out, "images",
                                    "attention_maps_epoch_002.png"), "RGB")
    check(montage.shape == (8 * 64, 9 * 64, 3), f"montage {montage.shape}")
    gap = _attn_gap(runs["resumed"], runs["straight"], 2, steps)
    log(f"  resumed against the straight run after epoch 2: first step's "
        f"losses max |diff| {gap['first_step']:.3e} ({gap['first_step_rel']:.2e}"
        f" of the loss), lowest tensor cosine {gap['min_cosine']:.8f} "
        f"({gap['worst_tensor']}), parameter distance {gap['rel_dist']:.3e} "
        f"of the norm (G, EMA, Ds), steps {gap['steps']}")
    log("  epoch times (host clock, {} steps of {}): {}; resumed {}; bf16 {}"
        .format(steps, ATTN_TRAIN_BATCH,
                ", ".join(f"{h['seconds']:.2f}" for h in hist),
                f"{hist_r[0]['seconds']:.2f}", f"{hist_b[0]['seconds']:.2f}"))
    check(gap["steps"] == (3 * steps, 3 * steps), f"steps {gap['steps']}")
    check(gap["first_step_held"], f"the resumed epoch's first step strays "
          f"past {RESUME_FIRST_STEP_ATOL:g} + {ATTN_LOSS_RTOL:g} of a loss")
    check(gap["rel_dist"] <= MAX_RESUME_DIST
          and gap["min_cosine"] > MIN_RESUME_COSINE,
          "the resumed run strays from the straight one")
    for path in runs.values():
        shutil.rmtree(path, ignore_errors=True)
    return launches, {"resume": gap, "epoch_s": [h["seconds"] for h in hist],
                      "bf16_epoch_s": hist_b[0]["seconds"]}


# ------------------------------------------ DAMSM pretraining, eval modes


DAMSM_CFG = os.path.join(ROOT, "cfg", "coco_damsm.yml")
DAMSM_BATCH = 48            # cfg/coco_damsm.yml TRAIN.BATCH_SIZE
DAMSM_CHECK_BATCH = 4       # the DAMSM step card vs CPU (phase 37)
DAMSM_TIME_RUNS = 10        # CUDA-event readings a DAMSM step time
DAMSM_SET = (192, 7)        # the entry's set: a test split of 48 (phase 39)
DAMSM_EPOCHS = 3
# the DAMSM step card vs CPU: losses and the norm before the clip within
# DAMSM_RTOL of their value, and per-tensor update cosines from warm Adams
# (an update linear in the gradient) above MIN_UPDATE_COSINE
DAMSM_RTOL = 1e-4
MIN_UPDATE_COSINE = 0.999
DAMSM_CLIPS = ((0.25, True), (1e6, False))   # (clip, whether it bites)
EVAL_CAPTIONS = 8           # gen_example's captions (phase 40)


def _damsm_smooth():
    return attngan_train_settings(cfg_from_file(DAMSM_CFG, "damsm")).smooth


def _damsm_state(device, dtype=None):
    """The flagship DAMSM pair (text_encoder29.pth, image_encoder29.pth)
    in a DAMSM train state on ``device``, its Adam warm (warm_adam's
    moments)."""
    state = create_damsm_state(
        build_text_encoder(ATTN_WORDS, 256, load_text_encoder(ATTN_NET_E),
                           device=device),
        build_image_encoder(256, load_image_encoder(ATTN_IMAGE_E),
                            compute_dtype=dtype, device=device))
    warm_opt(state.opt)
    return state


def damsm_once(device, batch, keep, clip):
    """One DAMSM step on ``device`` from :func:`_damsm_state` with the
    dropout mask ``keep``: (metrics, the trained tensors before and after
    on the CPU, whether every other tensor of the image encoder is
    unchanged bit for bit, host seconds)."""
    state = _damsm_state(device)
    trained = {**{f"text.{k}": p for k, p in state.text.named_parameters()},
               **{f"image.{k}": p for k, p in state.image.named_parameters()
                  if p.requires_grad}}
    pre = {k: p.detach().cpu().clone() for k, p in trained.items()}
    frozen = {k: v.clone() for k, v in state.image.state_dict().items()
              if f"image.{k}" not in trained}
    dev_batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    t = time.perf_counter()
    metrics = make_damsm_train_step(_damsm_smooth(), clip)(
        state, dev_batch, None, LR, keep=keep.to(device))
    metrics = {k: float(v) for k, v in metrics.items()}
    seconds = time.perf_counter() - t
    post = {k: p.detach().cpu() for k, p in trained.items()}
    same = all(torch.equal(v, frozen[k])
               for k, v in state.image.state_dict().items() if k in frozen)
    return metrics, pre, post, same, seconds


def phase_damsm_step():
    log(f"phase 37/52 damsmstep: one full-width DAMSM step (the flagship "
        f"text_encoder29.pth and image_encoder29.pth, batch "
        f"{DAMSM_CHECK_BATCH}, 256px) card against CPU from warm Adams, "
        "with the clip biting and not")
    _, ds = _attn_set()
    batch = _attn_train_batch(ds, DAMSM_CHECK_BATCH, 37)
    keep = torch.from_numpy(np.random.RandomState(37).rand(
        DAMSM_CHECK_BATCH, batch["captions"].shape[1], 300) < 0.5)
    out = {}
    for clip, bites in DAMSM_CLIPS:
        cpu = damsm_once("cpu", batch, keep, clip)
        card = damsm_once(DEVICE, batch, keep, clip)
        rel = {k: abs(card[0][k] - cpu[0][k]) / max(abs(cpu[0][k]), 1e-12)
               for k in cpu[0]}
        cos = {k: _cosine(card[2][k] - card[1][k], cpu[2][k] - cpu[1][k])
               for k in cpu[1]}
        worst = min(cos, key=cos.get)
        log(f"  clip {clip:g}: card / CPU " + "; ".join(
            f"{k} {card[0][k]:.6f} / {cpu[0][k]:.6f}" for k in sorted(cpu[0]))
            + f"; worst relative gap {max(rel.values()):.2e} (limit "
            f"{DAMSM_RTOL:g}); lowest update cosine {cos[worst]:.8f} "
            f"({worst}; limit {MIN_UPDATE_COSINE:g}); the backbone "
            f"unchanged: card {card[3]}, CPU {cpu[3]}; the step {cpu[4]:.2f}"
            f" s on the CPU, {card[4]:.2f} s on the card (host clock, first "
            "call)")
        check(max(rel.values()) <= DAMSM_RTOL, f"DAMSM step card vs CPU "
              f"(clip {clip:g}): {rel}")
        check(cos[worst] > MIN_UPDATE_COSINE, f"DAMSM update {worst}")
        check(card[3] and cpu[3], "the frozen backbone changed")
        check((cpu[0]["rnn_grad_norm"] > clip) == bites,
              f"clip {clip:g}: the norm {cpu[0]['rnn_grad_norm']:.4f} should"
              f"{'' if bites else ' not'} exceed it")
        out[f"clip_{clip:g}"] = {"rel": max(rel.values()),
                                 "update_cosine": cos[worst],
                                 "rnn_grad_norm": card[0]["rnn_grad_norm"]}
    return out


def phase_damsm_step_time():
    log(f"phase 38/52 damsmtime: the DAMSM step at batch {DAMSM_BATCH} on "
        "the card, float32 and bf16: CUDA events, peak memory, GFLOP and the "
        "device's busy share")
    _, ds = _attn_set()
    dev = torch.device(DEVICE)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             _attn_train_batch(ds, DAMSM_BATCH, 38).items()
             if k not in ("image64", "image128")}
    out = {}
    for dtype in (None, torch.bfloat16):
        kind = "bf16" if dtype else "f32"
        state = _damsm_state(dev, dtype)
        step = make_damsm_train_step(_damsm_smooth(), 0.25)
        gen = torch.Generator(device=dev).manual_seed(0)

        def one():
            return step(state, batch, gen, LR)

        for _ in range(3):
            one()
        flops = _flop_count(one)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(DAMSM_TIME_RUNS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = one()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms = statistics.median(times)
        check(all(bool(torch.isfinite(v)) for v in metrics.values()),
              f"non-finite DAMSM losses while timing ({kind})")
        wall, busy, groups, top = _profile_forward(one)
        log(f"damsm step at batch {DAMSM_BATCH}, 256px -> 299, {kind}"
            f"{'' if dtype else ' (TF32 off)'}: {ms:.2f} ms (CUDA events, "
            f"median of {DAMSM_TIME_RUNS}; min {min(times):.2f}, max "
            f"{max(times):.2f}) = {DAMSM_BATCH * 1e3 / ms:.0f} images/s; peak "
            f"memory {peak:.2f} GiB; {flops:.1f} GFLOP a step "
            f"({flops / DAMSM_BATCH:.2f} an image; torch.utils.flop_counter),"
            f" {flops / ms:.1f} TFLOP/s of them; traced (torch.profiler, "
            f"{PROFILE_CALLS} step): {wall:.2f} ms a step on the host clock, "
            "the device busy"
            f" {busy:.2f} ms ({busy / wall:.1%}); by kernel group: "
            + ", ".join(f"{g} {v:.2f}" for g, v in sorted(
                groups.items(), key=lambda kv: -kv[1]))
            + "; top kernels: " + "; ".join(
                f"{v:.2f} ms {name[:70]}" for v, name in top))
        out[kind] = {"ms": ms, "min_ms": min(times), "max_ms": max(times),
                     "images_per_s": DAMSM_BATCH * 1e3 / ms,
                     "peak_gib": peak, "gflop_per_step": flops,
                     "busy_share": busy / wall, "groups_ms": groups}
        del state, step
        torch.cuda.empty_cache()
    log(f"DAMSM step bf16 {out['bf16']['ms']:.2f} ms beside float32 "
        f"{out['f32']['ms']:.2f} ms: {out['f32']['ms'] / out['bf16']['ms']:.2f}"
        "x")
    return out


def _state_gap(run, ref, epoch):
    """The DAMSM states of two runs at ``epoch``: :func:`_tensor_gap` of
    both encoders, and both step counts."""
    a = CheckpointManager(os.path.join(run, "models")).load(epoch)[0]
    b = CheckpointManager(os.path.join(ref, "models")).load(epoch)[0]
    return (*_tensor_gap([(n, a[n], b[n]) for n in ("text", "image")]),
            (a["step"], b["step"]))


def phase_damsm_entry(attn_weights):
    log(f"phase 39/52 damsmentry: cli/main.py --variant damsm --cfg "
        f"cfg/coco_damsm.yml --synthetic on the card (n = {DAMSM_SET[0]}: a "
        f"test split of {DAMSM_SET[0] // 4}, so the eval runs): "
        f"{DAMSM_EPOCHS} epochs, a resume from epoch 1, one --bf16 epoch; "
        "the exported pair as AttnGAN's NET_E for one train step")
    data = os.path.join(WORK, "damsm_data")
    t = time.perf_counter()
    write_synthetic_attngan(data, data + "_imgs", n=DAMSM_SET[0],
                            seed=DAMSM_SET[1], device=DEVICE)
    log(f"  write_synthetic_attngan(n={DAMSM_SET[0]}, seed={DAMSM_SET[1]}): "
        f"{time.perf_counter() - t:.2f} s (host clock)")
    runs = {n: os.path.join(WORK, "runs", f"damsm_{n}")
            for n in ("straight", "resumed", "bf16")}
    steps = DAMSM_SET[0] // DAMSM_BATCH
    base = ["--variant", "damsm", "--cfg", DAMSM_CFG, "--data_dir", data,
            "--img_dir", data + "_imgs", "--synthetic", "--manualSeed",
            str(DAMSM_SET[1])]
    launches, seconds = {}, {}

    def entry(key, name, out, epochs, *extra):
        hist, launches[key], seconds[key] = _entry(
            name, [*base, "--output_dir", out, "--max_epochs", str(epochs),
                   *extra])
        check(launches[key] == (0, 0), f"{name}: K1/K2 launches "
              f"{launches[key]}; DAMSM places nothing")
        for h in hist:
            check(h["steps"] == steps and all(np.isfinite(v)
                                              for v in h.values())
                  and h["rnn_grad_norm"] > 0, f"{name}: epoch {h}")
        return hist

    hist = entry("train_damsm", f"damsm, {DAMSM_EPOCHS} epochs",
                 runs["straight"], DAMSM_EPOCHS, "--snapshot_interval", "1")
    out = runs["straight"]
    want = [os.path.join("logs", "metrics.jsonl"), "run_flags.json",
            os.path.basename(DAMSM_CFG),
            os.path.join("src_snapshot", "cli", "damsm_runner.py")]
    want += [os.path.join("DAMSMencoders", f"{k}_encoder{e}.pth")
             for k in ("text", "image") for e in range(DAMSM_EPOCHS)]
    want += [os.path.join("models", str(e), "state.pth")
             for e in range(DAMSM_EPOCHS)]
    missing = [w for w in want if not os.path.isfile(os.path.join(out, w))]
    check(not missing, f"{out}: missing {missing}")
    with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    evals = [r for r in records if "eval_damsm_loss" in r]
    check([r["step"] for r in evals] == list(range(DAMSM_EPOCHS))
          and all(np.isfinite(r["eval_damsm_loss"]) for r in evals),
          f"eval records {evals}")
    log("  losses by epoch (mean, train): " + "; ".join(
        f"{h['damsm_loss']:.4f} (w {h['w_loss']:.4f}, s {h['s_loss']:.4f}, "
        f"norm {h['rnn_grad_norm']:.3f})" for h in hist)
        + "; eval: " + ", ".join(f"{r['eval_damsm_loss']:.4f}" for r in evals)
        + "; epoch times (host clock, {} steps of {}): {}".format(
            steps, DAMSM_BATCH, ", ".join(f"{h['seconds']:.2f}"
                                          for h in hist)))
    _resume_copy(out, 1, runs["resumed"])
    hist_r = entry("train_damsm_resume", "damsm, resumed from epoch 1 to "
                   f"{DAMSM_EPOCHS}", runs["resumed"], DAMSM_EPOCHS,
                   "--resume", runs["resumed"], "--snapshot_interval", "1")
    check(len(hist_r) == DAMSM_EPOCHS - 2, f"the resume ran {len(hist_r)} "
          "epochs")
    first = 2 * steps
    la, lb = _logged(runs["resumed"], first), _logged(out, first)
    gap = max(abs(la[k] - lb[k]) for k in lb)
    cos, worst, dist, done = _state_gap(runs["resumed"], out, 2)
    log(f"  resumed against the straight run after epoch 2: the first "
        f"step's losses max |diff| {gap:.3e} (limit "
        f"{RESUME_FIRST_STEP_ATOL:g}), lowest tensor cosine {cos:.8f} "
        f"({worst}), distance {dist:.3e} of the norm, steps {done}")
    check(gap <= RESUME_FIRST_STEP_ATOL, "the resumed epoch's first step "
          "strays")
    check(dist <= MAX_RESUME_DIST and cos > MIN_RESUME_COSINE
          and done == (DAMSM_EPOCHS * steps,) * 2,
          "the resumed run strays from the straight one")
    hist_b = entry("train_damsm_bf16", "damsm --bf16, 1 epoch", runs["bf16"],
                   1, "--bf16", "--snapshot_interval", "0")
    check(os.path.isfile(os.path.join(runs["bf16"], "DAMSMencoders",
                                      "image_encoder0.pth")),
          "the bf16 run exported no pair")

    # the exported pair as AttnGAN's NET_E: one full-width train step
    net_e = os.path.join(out, "DAMSMencoders",
                         f"text_encoder{DAMSM_EPOCHS - 1}.pth")
    text_ds = AttnGanDataset(data, split="test", captions_per_image=5)
    mcfg = attngan_model_config(cfg_from_file(ATTN_TRAIN_CFG,
                                              "coco-attngan"))
    text, image, prov = attngan_runner.init_encoders(
        net_e, text_ds.n_words, mcfg, seed=7, device=DEVICE)
    check(prov == {"text_encoder": "imported", "image_encoder": "imported"},
          f"NET_E provenance {prov}")
    exported = load_text_encoder(net_e)
    check(all(torch.equal(v.cpu(), exported[k])
              for k, v in text.state_dict().items()),
          "init_encoders did not load the exported text encoder")
    state = _attn_state(DEVICE, mcfg, attn_weights[0], attn_weights[1])
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in
             _attn_train_batch(text_ds, ATTN_STEP_BATCH, 39).items()}
    k1.reset_launch_count()
    metrics = make_attngan_train_step(mcfg, text, image)(
        state, batch, torch.Generator(device=DEVICE).manual_seed(7), LR, LR)
    torch.cuda.synchronize()
    metrics = {k: float(v) for k, v in metrics.items()}
    step_launches = (k1.launch_count(), k1.grad_launch_count())
    log(f"  AttnGAN step from the exported pair (NET_E {net_e}), batch "
        f"{ATTN_STEP_BATCH}: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                           sorted(metrics.items()))
        + f"; K1/K2 launches {step_launches}")
    check(all(np.isfinite(v) for v in metrics.values())
          and metrics["w_loss"] > 0 and metrics["s_loss"] > 0
          and step_launches == ATTN_LAUNCHES,
          "the AttnGAN step from the exported pair")
    del state, text, image
    torch.cuda.empty_cache()
    for path in runs.values():
        shutil.rmtree(path, ignore_errors=True)
    return launches, {"epoch_s": [h["seconds"] for h in hist],
                      "bf16_epoch_s": hist_b[0]["seconds"],
                      "resume_first_step": gap, "resume_rel_dist": dist,
                      "entry_s": seconds}


def _attn_eval_cfg(data):
    """A copy of the flagship's sampling cfg in the work directory naming
    netG_ema_final.pth, text_encoder29.pth and ``data``."""
    subs = {"NET_G": ATTN_NET_G, "NET_E": ATTN_NET_E, "DATA_DIR": data,
            "IMG_DIR": data + "_imgs"}
    with open(ATTN_CFG) as f:
        lines = f.read().splitlines()
    path = os.path.join(WORK, "coco_attn_eval.yml")
    with open(path, "w") as f:
        for line in lines:
            key = line.strip().split(":")[0]
            if key in subs:
                line = f"{line[:line.index(key)]}{key}: '{subs[key]}'"
            f.write(line + "\n")
    return path


def phase_attn_eval(model):
    log("phase 40/52 attneval: cli/main.py --variant coco-attngan with "
        "TRAIN.FLAG False from the flagship files: sample (B_VALIDATION) "
        f"and gen_example ({EVAL_CAPTIONS} captions); a sample row card "
        "against CPU; K1 at the sampler's and gen_example's shapes")
    data, ds = model["data"], model["ds"]
    cfg_file = _attn_eval_cfg(data)
    base = ["--variant", "coco-attngan", "--cfg", cfg_file, "--data_dir",
            data, "--manualSeed", str(ATTN_SET[1])]
    captions = [" ".join(ds.ixtoword[i] for i in ds.captions[5 * j])
                for j in range(EVAL_CAPTIONS)]
    with open(os.path.join(data, "example_captions.txt"), "w") as f:
        f.write("\n".join(captions) + "\n")
    out = {n: os.path.join(WORK, "attn_eval", n)
           for n in ("sample", "gen_example")}
    launches, seconds = {}, {}
    _, launches["sample_coco-attngan"], seconds["sample"] = _entry(
        "coco-attngan sample", [*base, "--output_dir", out["sample"]])
    rows = sorted(os.listdir(os.path.join(out["sample"], "samples")))
    check(len(rows) == attngan_runner.SAMPLE_ROWS, f"{len(rows)} rows")
    check(launches["sample_coco-attngan"] == (len(rows), 0),
          f"sample K1/K2 launches {launches['sample_coco-attngan']}: one K1 "
          "a row expected")
    pngs = {n: read_png(os.path.join(out["sample"], "samples", n), "RGB")
            for n in rows}
    check(all(p.shape == (260, 10 * 258 + 2, 3) for p in pngs.values()),
          "rows of 10 tiles of 256px")
    _, launches["gen_example_coco-attngan"], seconds["gen_example"] = _entry(
        "coco-attngan gen_example", [*base, "--output_dir",
                                     out["gen_example"], "--eval_mode",
                                     "gen_example"])
    check(launches["gen_example_coco-attngan"] == (1, 0),
          f"gen_example K1/K2 launches {launches['gen_example_coco-attngan']}"
          ": one K1 a caption file expected")
    caption_files = [d for d in os.listdir(out["gen_example"])
                     if os.path.isdir(os.path.join(out["gen_example"], d))]
    check(caption_files == ["example_captions"],
          f"gen_example's caption files {caption_files}")
    key_dir = os.path.join(out["gen_example"], "example_captions")
    files = sorted(os.listdir(key_dir))
    check(files == sorted(f"0_s_{j}_{k}.png" for j in range(EVAL_CAPTIONS)
                          for k in ("g0", "g1", "g2", "a0", "a1")),
          f"gen_example files {files}")
    check(read_png(os.path.join(key_dir, "0_s_0_g2.png"), "RGB").shape
          == (256, 256, 3), "gen_example's 256px image")
    log(f"  sample: {len(rows)} rows in {seconds['sample']:.2f} s, "
        f"gen_example: {EVAL_CAPTIONS} captions in "
        f"{seconds['gen_example']:.2f} s (host clock, the whole entry: G "
        "load, the test split's pixels, PNGs)")

    # the first sample row again, card against CPU, from the same z
    test = AttnGanTrainSet(data, data + "_imgs", captions_per_image=5,
                           seed=ATTN_SET[1], split="test", device=DEVICE)
    # the entry's first row's draws, its pixels decoded as the entry's were
    item = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in test.get_batch([0]).items()}
    z = torch.from_numpy(sample_noise(ATTN_SET[1], 0, 9, 100))
    card_nets = (build_text_encoder(ATTN_WORDS, 256,
                                    load_text_encoder(ATTN_NET_E),
                                    device=DEVICE),
                 build_attngan_g(model["mcfg"],
                                 load_reference_attngan_g(ATTN_NET_G),
                                 device=DEVICE))
    fakes = {}
    for dev, (enc, g) in ((DEVICE, card_nets),
                          ("cpu", (model["enc_cpu"], model["g_cpu"]))):
        b = {k: torch.from_numpy(v).to(dev) for k, v in item.items()}
        fakes[dev] = attngan_runner.sample_row(enc, g, b, z.to(dev)).cpu()
    err = float((fakes[DEVICE] - fakes["cpu"]).abs().max())
    first = [n for n in rows if n.endswith("_0.png")][0]
    tiles = np.concatenate([item["image256"][:1].astype(np.float32) / 127.5
                            - 1.0, fakes[DEVICE].permute(0, 2, 3, 1).numpy()])
    _draw_white_bbox_edges(tiles, item["bbox"][0], 256)
    levels = int(np.abs(make_grid(tiles, nrow=10).astype(np.int16)
                        - pngs[first]).max())
    log(f"  sample row 0 ({first}) card against CPU at the same z: max "
        f"|diff| {err:.3e} (atol {MODEL_ATOL:g}); the entry's PNG against "
        f"the card's row: {levels} levels of 255 (limit {SAMPLE_LEVELS}); "
        f"fake pixel std {float(fakes['cpu'].std()):.4f}")
    check(err <= MODEL_ATOL, "the sample row: card and CPU disagree")
    check(levels <= SAMPLE_LEVELS, "the entry's first row is not the "
          "card's row")

    # K1 at the sampler's and gen_example's shapes
    rs = np.random.RandomState(40)
    dev = torch.device(DEVICE)
    c, hw = model["mcfg"].ngf // 4, (16, 16)
    box = np.array(item["bbox"][0], np.float32)
    box[2] = -1.0                               # a padded third object
    shapes = {
        "sample": np.repeat(box[None], 9, axis=0),
        "gen_example": np.tile(np.array(attngan_runner.EXAMPLE_BOX,
                                        np.float32), (EVAL_CAPTIONS, 3, 1))}
    k1_rows, worst = {}, 0.0
    for name, bbox in shapes.items():
        bbox = torch.from_numpy(bbox).to(dev)
        feats = torch.from_numpy(rs.randn(bbox.shape[0], 3, c, *hw).astype(
            np.float32)).to(dev)
        label = f"{name} {tuple(feats.shape)} -> {hw}"
        worst = max(worst, _held(k1.stn_place_multi_nchw(feats, bbox, hw),
                                 k1.stn_place_multi_plain(feats, bbox, hw),
                                 torch.float32, "K1", label))
        row = time_place(feats, bbox, hw, f"K1 AttnGAN {name}")
        k1_rows[name] = {k: row[k] for k in (
            "ms", "plain_ms", "graph_ms", "bound_ms", "bound_by",
            "share_of_bound", "graph_share_of_bound")}
    with open(os.path.join(data, "example_captions.txt")) as f:
        check(len(f.read().splitlines()) == EVAL_CAPTIONS, "captions file")
    os.remove(os.path.join(data, "example_captions.txt"))
    for path in out.values():
        shutil.rmtree(path, ignore_errors=True)
    return launches, {"max_abs_err": worst, **k1_rows,
                      "k1_launches_per_row":
                          launches["sample_coco-attngan"][0] / len(rows),
                      "k1_launches_per_caption_file":
                          launches["gen_example_coco-attngan"][0]
                          / len(caption_files),
                      "sample_row_card_vs_cpu": err, "seconds": seconds}


# ------------------------------------------------------- COCO from disk

# nvjpeg against the numpy decoder (PERF.md section 6). Its IDCT rounds
# apart from libjpeg's islow: within JPEG_BOX_LEVELS of the numpy decoder
# with chroma replicated, as nvjpeg upsamples it (4 measured). At a chroma
# edge libjpeg's triangle filter and replication part by up to 7/16 of
# the chroma step, times 1.772 into blue: the synthetic boxes' steps of up
# to ~70 give up to ~54 levels, so JPEG_FANCY_LEVELS against PIL's pixels
# (25 measured on phase 41's files, 30-44 on phase 42's 268-pixel crops);
# the mean stays under a level (0.98 measured)
JPEG_BOX_LEVELS = 6
JPEG_FANCY_LEVELS = 64
JPEG_FANCY_MEAN = 1.5       # mean level difference an image
JPEG_DECODE_BATCHES = ((128, 96), (14, 268))  # (batch, side) timed
JPEG_DECODE_RUNS = 5        # host-clock readings a decode time
DISK_SEED = 7
SUMMARY: dict = {}          # the closing {"summary": ...} line's numbers


def _jpeg_cases():
    """The synthetic writers' images as PIL's encoder writes them (the
    numpy encoder): write_synthetic_coco's 96x96 (4:2:0),
    write_synthetic_attngan's 268x268, a grayscale file, 4:4:4 and 4:2:2
    files and odd sizes. Returns {name: (file bytes, source pixels)}."""
    d = os.path.join(WORK, "jpeg")
    write_synthetic_coco(d, d + "_coco", n=4, seed=41)
    write_synthetic_attngan(d, d + "_attn", n=4, seed=41)
    src96 = jpeg.read_jpeg(os.path.join(d + "_coco", "synthetic_000000.jpg"))
    src268 = jpeg.read_jpeg(os.path.join(d + "_attn", "train_00000.jpg"))
    cases = {}
    for i in range(4):
        for name, path in ((f"coco96 {i}", os.path.join(
                d + "_coco", f"synthetic_{i:06d}.jpg")),
                           (f"attngan268 {i}", os.path.join(
                d + "_attn", f"train_{i:05d}.jpg"))):
            with open(path, "rb") as f:
                data = f.read()
            cases[name] = (data, jpeg.decode_jpeg(data))
    for name, img, kw in (("gray 96", src96[..., 1], {}),
                          ("4:4:4 268", src268, {"subsampling": "4:4:4"}),
                          ("4:2:2 96", src96, {"subsampling": "4:2:2"}),
                          ("odd 131x77", src268[:131, :77], {}),
                          ("odd 33x17", src96[:33, :17], {})):
        cases[name] = (jpeg.encode_jpeg(img, **kw), img)
    return cases


def _levels(a, b):
    d = np.abs(np.asarray(a).astype(np.int16) - np.asarray(b))
    return int(d.max()), float(d.mean()), int((d > 8).sum())


def phase_jpeg():
    log("phase 41/52 jpeg: nvjpeg's decode against the numpy decoder on "
        "the writers' images, both encoders' round trips, the refusals, "
        "and decode times")
    cases = _jpeg_cases()
    rows, worst = {}, {"box": 0, "fancy": 0, "fancy_mean": 0.0}
    for name, (data, _) in cases.items():
        card = nvjpeg.decode_nvjpeg(data, name, DEVICE).cpu().numpy()
        fancy = jpeg.decode_jpeg(data, name)
        box = jpeg.decode_jpeg(data, name, fancy=False)
        f_max, f_mean, f_n8 = _levels(card, fancy)
        b_max, b_mean, _ = _levels(card, box)
        rows[name] = {"max": f_max, "mean": round(f_mean, 4),
                      "over_8": f_n8, "box_max": b_max,
                      "box_mean": round(b_mean, 4)}
        worst["box"] = max(worst["box"], b_max)
        worst["fancy"] = max(worst["fancy"], f_max)
        worst["fancy_mean"] = max(worst["fancy_mean"], f_mean)
        log(f"  {name} {fancy.shape[1]}x{fancy.shape[0]}: nvjpeg against the "
            f"numpy decoder (PIL's pixels) max {f_max} levels, mean "
            f"{f_mean:.3f}, {f_n8} values past 8 levels; against the numpy "
            f"decoder with replicated chroma max {b_max}, mean {b_mean:.3f}")
    # the same files decoded on an idle card and behind a queue of work
    # (as the Loader's thread decodes behind a train step): the same pixels
    names = [n for n in cases if n.startswith(("coco96", "attngan268"))]
    idle = [nvjpeg.decode_nvjpeg(cases[n][0], n, DEVICE) for n in names]
    a = torch.randn(4096, 4096, device=DEVICE)
    for _ in range(40):
        a = torch.tanh(a @ a)
    busy = [nvjpeg.decode_nvjpeg(cases[n][0], n, DEVICE) for n in names]
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(idle, busy)),
          "nvjpeg's pixels change when the card is busy")
    log(f"  worst: {worst['fancy']} levels against PIL's pixels (mean "
        f"{worst['fancy_mean']:.3f}), {worst['box']} against replicated "
        "chroma: the values past 8 levels sit where chroma changes, where "
        "libjpeg's triangle filter and nvjpeg's upsampling part")
    check(worst["box"] <= JPEG_BOX_LEVELS and worst["fancy"] <=
          JPEG_FANCY_LEVELS and worst["fancy_mean"] <= JPEG_FANCY_MEAN,
          f"nvjpeg against the numpy decoder: {worst}")

    trips = {}
    for name in ("coco96 0", "attngan268 0"):
        src = cases[name][1]
        by_numpy = jpeg.encode_jpeg(src)
        by_card = nvjpeg.encode_nvjpeg(torch.from_numpy(src).to(DEVICE))
        jpeg.probe_jpeg(by_card, f"{name} (nvjpeg's file)")
        trips[name] = {}
        for enc, data in (("numpy", by_numpy), ("nvjpeg", by_card)):
            np_dec = jpeg.decode_jpeg(data)
            nv_dec = nvjpeg.decode_nvjpeg(data, name, DEVICE).cpu().numpy()
            trips[name][enc] = {
                "bytes": len(data),
                "numpy_vs_source": _levels(np_dec, src)[:2],
                "nvjpeg_vs_numpy": _levels(nv_dec, np_dec)[:2]}
            check(_levels(nv_dec, np_dec)[0] <= JPEG_FANCY_LEVELS,
                  f"{name}, {enc}'s file: the decoders disagree")
        log(f"  round trip {name}: " + "; ".join(
            f"{enc}'s encoder {v['bytes']} bytes, numpy decode vs source "
            f"max/mean {v['numpy_vs_source'][0]}/"
            f"{v['numpy_vs_source'][1]:.3f}, nvjpeg vs numpy decode "
            f"{v['nvjpeg_vs_numpy'][0]}/{v['nvjpeg_vs_numpy'][1]:.3f}"
            for enc, v in trips[name].items()))

    data = cases["attngan268 0"][0]
    sof = data.index(b"\xff\xc0")
    bad = {"truncated": data[:len(data) // 2],
           "progressive": data[:sof] + b"\xff\xc2" + data[sof + 2:]}
    for name, blob in bad.items():
        path = os.path.join(WORK, "jpeg", f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(blob)
        for dev in (DEVICE, "cpu"):
            try:
                nvjpeg.decode_batch([path], dev)
            except ValueError as e:
                log(f"  {name} file on {dev}: raised {e}")
                continue
            check(False, f"the {name} file decoded on {dev}")
    garbled = data[:700] + bytes(np.random.RandomState(41).randint(
        0, 255, 4000).astype(np.uint8)).replace(b"\xff", b"\x00") + b"\xff\xd9"
    try:
        nvjpeg.decode_nvjpeg(garbled, "garbled", DEVICE)
        torch.cuda.synchronize()
        nv_garbled = "decoded (nvjpeg does not check the entropy-coded data)"
    except (ValueError, nvjpeg.NvjpegError) as e:
        nv_garbled = f"raised {e}"
    try:
        jpeg.decode_jpeg(garbled, "garbled")
        np_garbled = "decoded"
    except ValueError as e:
        np_garbled = f"raised {e}"
    log(f"  garbled scan with its markers intact: nvjpeg {nv_garbled}; the "
        f"numpy decoder {np_garbled}")
    # held, so that a change in nvjpeg or in probe_jpeg shows: this class
    # of file lies outside what the card refuses
    check(nv_garbled.startswith("decoded") and np_garbled.startswith(
        "raised"), f"garbled scan: nvjpeg {nv_garbled}, the numpy decoder "
          f"{np_garbled}; held: nvjpeg decodes it, the numpy decoder raises")

    times = {}
    d = os.path.join(WORK, "jpeg_timing")
    os.makedirs(d, exist_ok=True)
    for n, side in JPEG_DECODE_BATCHES:
        src = cases["coco96 0" if side == 96 else "attngan268 0"][0]
        paths = []
        for i in range(n):
            paths.append(os.path.join(d, f"{side}_{i}.jpg"))
            with open(paths[-1], "wb") as f:
                f.write(src)
        nvjpeg.decode_batch(paths[:4], DEVICE)
        nv = []
        for _ in range(JPEG_DECODE_RUNS):
            t = time.perf_counter()
            nvjpeg.decode_batch(paths, DEVICE)
            nv.append((time.perf_counter() - t) * 1e3 / n)
        t = time.perf_counter()
        nvjpeg.decode_batch(paths[:8], "cpu")
        cpu = (time.perf_counter() - t) * 1e3 / 8
        decoded = torch.stack(nvjpeg.decode_batch(paths, DEVICE))
        resize = {}
        for out in ((76, 268) if side == 96 else (76,)):
            resize_bilinear_tensor(decoded[:2], (out, out))
            torch.cuda.synchronize()
            t = time.perf_counter()
            on_card = resize_bilinear_tensor(decoded, (out, out))
            torch.cuda.synchronize()
            card_ms = (time.perf_counter() - t) * 1e3 / n
            t = time.perf_counter()
            on_host = torch.from_numpy(resize_bilinear_batch(
                decoded.cpu().numpy(), (out, out))).to(DEVICE)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t) * 1e3 / n
            check(torch.equal(on_card, on_host), f"resize to {out}: the "
                  "card's and the host's disagree")
            resize[out] = {"card_ms": card_ms, "host_ms": host_ms}
        times[f"{n}x{side}"] = {"nvjpeg_ms": statistics.median(nv),
                                "numpy_ms": cpu, "resize": resize}
        log(f"  decode {n} x {side}x{side}: nvjpeg {statistics.median(nv):.4f}"
            f" ms an image (host clock around decode_batch and its "
            f"synchronize, median of {JPEG_DECODE_RUNS}; min {min(nv):.4f}), "
            f"the numpy decoder {cpu:.3f} ms an image on the host; the "
            "PIL-exact bilinear resize of the decoded batch, an image: "
            + ", ".join(f"to {o}: on the card {r['card_ms']:.4f} ms, on the "
                        f"host (there and back) {r['host_ms']:.4f} ms"
                        for o, r in resize.items()))
    SUMMARY["decode_ms"] = {k: round(v["nvjpeg_ms"], 4)
                            for k, v in times.items()}
    SUMMARY["decode_numpy_ms"] = {k: round(v["numpy_ms"], 3)
                                  for k, v in times.items()}
    shutil.rmtree(d, ignore_errors=True)
    return {"levels": worst, "rows": rows, "round_trips": trips,
            "decode": times, "garbled": nv_garbled}


def _host_batch(batch):
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in batch.items()}


class _Held:
    """``decode_resized`` of the COCO readers served from decoded batches
    held on the card: an epoch with the same draws and no decode."""

    def __init__(self, paths, size):
        self.cache = dict(zip(paths, nvjpeg.decode_resized(paths, size,
                                                           DEVICE)))

    def __call__(self, paths, size, device):
        return torch.stack([self.cache[p] for p in paths])


def _disk_path(name, make_ds, bs, step, per_step, paths, size):
    """One path's epoch from disk against the same epoch held on the card:
    the card reader's batches against the CPU reader's (the numpy path)
    from the same seed, then epochs timed in turns (memory, disk, disk,
    memory; host clock around each, ended by a synchronize), the K1/K2
    launches of a disk epoch held at ``per_step`` a step, and the first
    disk epoch's batches, read behind the train steps, equal to the card
    reader's batches read on an idle card."""
    cpu = list(Loader(make_ds("cpu"), bs, seed=DISK_SEED).epoch(0))
    card = [_host_batch(b) for b in
            Loader(make_ds(DEVICE), bs, seed=DISK_SEED).epoch(0)]
    check(len(cpu) == len(card) > 0, f"{name}: {len(cpu)} and {len(card)} "
          "batches")
    img_levels = [0, 0.0]
    for a, b in zip(cpu, card):
        check(sorted(a) == sorted(b), f"{name}: keys {sorted(a)}")
        for k in a:
            if k.startswith("image"):
                mx, mean, _ = _levels(b[k], a[k])
                img_levels = [max(img_levels[0], mx),
                              max(img_levels[1], mean)]
            else:
                check(np.array_equal(a[k], b[k]), f"{name}: {k} on the card "
                      "is not what the numpy path draws")
    check(img_levels[0] <= JPEG_FANCY_LEVELS and img_levels[1] <=
          JPEG_FANCY_MEAN, f"{name}: the card's images against the numpy "
          f"path's {img_levels}")
    held = _Held(paths, size)
    mods = (coco_data, attn_data)

    def epoch(from_disk, keep=None):
        orig = [m.decode_resized for m in mods]
        if not from_disk:
            for m in mods:
                m.decode_resized = held
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            n = 0
            for batch in Loader(make_ds(DEVICE), bs,
                                seed=DISK_SEED).epoch(0):
                step(train_loop.to_device(batch, torch.device(DEVICE)))
                if keep is not None:
                    keep.append(batch)
                n += 1
            torch.cuda.synchronize()
            return time.perf_counter() - t, n
        finally:
            for m, f in zip(mods, orig):
                m.decode_resized = f

    epoch(False)                                  # warm-up
    t = {"memory": [], "disk": []}
    behind = []
    for kind in ("memory", "disk", "disk", "memory"):
        first_disk = kind == "disk" and not t["disk"]
        if first_disk:
            k1.reset_launch_count()
        sec, steps = epoch(kind == "disk", behind if first_disk else None)
        if first_disk:
            launches = (k1.launch_count(), k1.grad_launch_count())
        t[kind].append(sec)
    check(len(behind) == len(card), f"{name}: {len(behind)} batches behind "
          f"the steps, {len(card)} on an idle card")
    for a, b in zip(card, map(_host_batch, behind)):
        for k in a:
            check(np.array_equal(a[k], b[k]), f"{name}: {k} read behind the "
                  "train steps differs from the idle card's")
    want = (per_step[0] * steps, per_step[1] * steps)
    log(f"  {name}: {steps} steps of batch {bs}; numpy path = card's boxes, "
        f"labels, captions and embeddings; the first disk epoch's batches, "
        f"read behind the steps, = the idle card's; images within "
        f"{img_levels[0]} levels (mean {img_levels[1]:.3f}); epoch from disk "
        f"{t['disk'][0]:.3f}, {t['disk'][1]:.3f} s, held on the card "
        f"{t['memory'][0]:.3f}, {t['memory'][1]:.3f} s (host clock, in "
        f"turns); K1/K2 launches of a disk epoch {launches} (want {want})")
    check(launches == want, f"{name}: K1/K2 launches {launches} != {want}")
    return {"steps": steps, "batch": bs, "disk_s": t["disk"],
            "memory_s": t["memory"], "launches": launches,
            "image_levels": img_levels}


def phase_coco_disk(attn_weights):
    log("phase 42/52 cocodisk: both StackGAN stages, AttnGAN and DAMSM "
        "trained from disk at full width for one epoch each, beside the "
        "same epoch held on the card; the card's draws against the numpy "
        "path's")
    dev = torch.device(DEVICE)
    out = {}
    root = os.path.join(WORK, "cocodisk")

    def run(name, make_ds, write, n, bs, build, per_step, size):
        data, imgs = os.path.join(root, name), os.path.join(root,
                                                            name + "_imgs")
        t = time.perf_counter()
        write(data, imgs, n)
        log(f"  {name}: {n} items written (nvjpeg's encoder) in "
            f"{time.perf_counter() - t:.2f} s (host clock)")
        ds = make_ds(data, imgs, "cpu")
        paths = [ds.path(i) for i in range(len(ds))]
        step = build()
        out[name] = _disk_path(name, lambda d: make_ds(data, imgs, d), bs,
                               step, per_step, paths, size)
        del step
        torch.cuda.empty_cache()

    def coco_writer(data, imgs, n):
        write_synthetic_coco(data, imgs, n=n, seed=DISK_SEED, device=DEVICE)

    def attn_writer(data, imgs, n):
        write_synthetic_attngan(data, imgs, n=n, seed=DISK_SEED,
                                device=DEVICE)

    def stage1():
        mcfg = family_cfg("coco-stackgan-1")
        state = create_state(mcfg, seed=0, device=dev)
        step = make_train_step(mcfg, KL_COEFF)
        gen = torch.Generator(device=dev).manual_seed(0)
        return lambda b: step(state, b, gen, LR, LR)

    def stage2():
        s1, s2 = stage2_cfgs()
        g1 = build_stage1_g(s1, seed=0, device=dev)
        state = create_state_stage2(s2, seed=0, device=dev)
        step = make_stage2_train_step(s2, s1, g1, KL_COEFF)
        gen = torch.Generator(device=dev).manual_seed(0)
        return lambda b: step(state, b, gen, LR, LR)

    attn_cfg = cfg_from_file(ATTN_TRAIN_CFG, "coco-attngan")
    st = attngan_train_settings(attn_cfg)

    def attngan():
        mcfg = attngan_model_config(attn_cfg)
        g_sd, d_sds, e_sd, i_sd = attn_weights
        state, text, image = _attn_nets(dev, mcfg, g_sd, d_sds, ATTN_WORDS,
                                        e_sd, i_sd)
        step = make_attngan_train_step(mcfg, text, image)
        gen = torch.Generator(device=dev).manual_seed(0)
        return lambda b: step(state, b, gen, LR, LR)

    def damsm():
        state = _damsm_state(dev)
        step = make_damsm_train_step(_damsm_smooth(), 0.25)
        gen = torch.Generator(device=dev).manual_seed(0)
        return lambda b: step(state, b, gen, LR)

    s1_batch = train_settings(cfg_from_file(FAMILY_CFGS["coco-stackgan-1"],
                                            "coco-stackgan-1")).batch_size
    run("coco-stackgan-1", lambda d, i, dv: CocoStackganDataset(
        d, i, stage=1, imsize=64, seed=DISK_SEED, device=dv), coco_writer,
        train_main.synthetic_items("coco-stackgan-1", s1_batch), s1_batch,
        stage1, (4, 4), 76)
    run("coco-stackgan-2", lambda d, i, dv: CocoStackganDataset(
        d, i, stage=2, imsize=256, seed=DISK_SEED, device=dv), coco_writer,
        train_main.synthetic_items("coco-stackgan-2", S2_BATCH), S2_BATCH,
        stage2, S2_LAUNCHES, 268)
    run("coco-attngan", lambda d, i, dv: AttnGanTrainSet(
        d, i, base_size=st.base_size, branch_num=st.branch_num,
        captions_per_image=st.captions_per_image, words_num=st.words_num,
        seed=DISK_SEED, device=dv), attn_writer,
        train_main.synthetic_items("coco-attngan", ATTN_TRAIN_BATCH),
        ATTN_TRAIN_BATCH, attngan, ATTN_LAUNCHES, 268)
    dst = attngan_train_settings(cfg_from_file(DAMSM_CFG, "damsm"))
    run("damsm", lambda d, i, dv: AttnGanTrainSet(
        d, i, base_size=dst.base_size, branch_num=dst.branch_num,
        captions_per_image=dst.captions_per_image, words_num=dst.words_num,
        seed=DISK_SEED, device=dv), attn_writer,
        train_main.synthetic_items("damsm", DAMSM_BATCH), DAMSM_BATCH,
        damsm, (0, 0), 268)
    SUMMARY["epoch_s"] = {k: {"disk": round(min(v["disk_s"]), 3),
                              "memory": round(min(v["memory_s"]), 3),
                              "steps": v["steps"]} for k, v in out.items()}
    shutil.rmtree(root, ignore_errors=True)
    return out


S2_SAMPLE_SHAPES = {"G1": ("bbox", 384, (16, 16)),
                    "G2": ("bbox_s2", 192, (64, 64))}


def _s2_eval_cfg(run, stage1_g):
    """A copy of cfg/coco_s2_eval.yml naming phase 28's run directory as
    NET_G and its stage-1 .pth as STAGE1_G."""
    subs = {"NET_G": run, "STAGE1_G": stage1_g}
    with open(os.path.join(ROOT, "cfg", "coco_s2_eval.yml")) as f:
        lines = f.read().splitlines()
    path = os.path.join(WORK, "coco_s2_eval.yml")
    with open(path, "w") as f:
        for line in lines:
            key = line.strip().split(":")[0]
            if key in subs:
                line = f"{line[:line.index(key)]}{key}: '{subs.pop(key)}'"
            f.write(line + "\n")
        for key, value in subs.items():       # keys the cfg lacks
            f.write(f"{key}: '{value}'\n")
    return path


def phase_stage2_sample(s2_run):
    log("phase 43/52 s2sample: cli/main.py --variant coco-stackgan-2 with "
        "TRAIN.FLAG False from phase 28's run directory: the val_captions.t7 "
        "branch and the test-split branch, 25 grids each, timed; the first "
        "row's fakes card against CPU; K1 at the sampler's two batch-9 "
        "shapes")
    cfg_file = _s2_eval_cfg(s2_run["run"], s2_run["stage1_g"])
    s1, s2 = stage2_cfgs()
    data = os.path.join(WORK, "s2sample")
    imgs = data + "_imgs"
    launches, seconds = {}, {}
    for branch in ("t7", "split"):
        out = os.path.join(WORK, "s2sample_out", branch)
        argv = ["--variant", "coco-stackgan-2", "--cfg", cfg_file,
                "--data_dir", data, "--img_dir", imgs, "--synthetic",
                "--manualSeed", str(DISK_SEED), "--output_dir", out]
        if branch == "split":
            os.remove(os.path.join(data, "test", "val_captions.t7"))
        _, launches[f"sample_coco_stage2_{branch}"], seconds[branch] = _entry(
            f"coco-stackgan-2 sampling, {branch} branch", argv)
        grids = sorted(os.listdir(os.path.join(out, "samples")))
        # G1 and G2 place once a grid; the t7 branch names its grids after
        # their captions, so a caption drawn twice rewrites its file
        want = (2 * SAMPLE_GRIDS, 0)
        check(0 < len(grids) <= SAMPLE_GRIDS if branch == "t7" else
              len(grids) == SAMPLE_GRIDS, f"{branch}: {len(grids)} grids")
        check(launches[f"sample_coco_stage2_{branch}"] == want,
              f"{branch}: K1/K2 launches "
              f"{launches[f'sample_coco_stage2_{branch}']} != {want}")
        shapes = {read_png(os.path.join(out, "samples", g), "RGB").shape
                  for g in grids}
        check(shapes == {(260, 10 * 258 + 2, 3)}, f"{branch}: grid shapes "
              f"{shapes}")
    # the test-split branch's first grid again: G1 + G2 card against CPU
    cfg = cfg_from_file(cfg_file, "coco-stackgan-2")
    cfg.DATA_DIR, cfg.IMG_DIR = data, imgs
    nets = {dev: sampling_generators(cfg, s1, s2, seed=DISK_SEED,
                                     device=dev) for dev in (DEVICE, "cpu")}
    ds = CocoStackganDataset(data, imgs, split="test", stage=2, imsize=256,
                             seed=DISK_SEED, device="cpu")
    index = int(np.random.RandomState(DISK_SEED).randint(len(ds)))
    item = ds[index]
    z, eps = sample_inputs(DISK_SEED, 0, s1.z_dim, s1.condition_dim, False)
    fakes = {}
    for dev, (g1, g2) in nets.items():
        batch = {k: torch.from_numpy(np.repeat(item[k][None], 9, 0)).to(dev)
                 for k in ("bbox", "bbox_s2", "label_onehot",
                           "text_embedding")}
        fakes[dev] = stage2_images(g1, g2, torch.from_numpy(z).to(dev),
                                   batch).cpu()
    err = float((fakes[DEVICE] - fakes["cpu"]).abs().max())
    png = read_png(os.path.join(out, "samples", grids[0]), "RGB")
    tiles = [draw_bboxes(tile_uint8(f), item["bbox_s2"])
             for f in fakes[DEVICE].permute(0, 2, 3, 1).numpy()]
    levels = max(int(np.abs(png[2:258, 2 + 258 * (i + 1):258 * (i + 2)]
                            .astype(np.int16) - t).max())
                 for i, t in enumerate(tiles))
    log(f"  test-split branch grid 0 (item {index}): G1 + G2 fakes card "
        f"against CPU max |diff| {err:.3e} (atol {MODEL_ATOL:g}); the "
        f"entry's fake tiles against the card's: {levels} levels (limit "
        f"{SAMPLE_LEVELS}); fake std {float(fakes['cpu'].std()):.4f}")
    check(err <= MODEL_ATOL, "stage-2 sampling: card and CPU disagree")
    check(levels <= SAMPLE_LEVELS, "the entry's first grid is not the "
          "card's")
    rs = np.random.RandomState(43)
    dev = torch.device(DEVICE)
    k1_rows, worst = {}, 0.0
    for name, (key, c, hw) in S2_SAMPLE_SHAPES.items():
        bbox = torch.from_numpy(np.repeat(item[key][None], 9, 0)).to(dev)
        feats = torch.from_numpy(rs.randn(9, 3, c, *hw).astype(
            np.float32)).to(dev)
        label = f"stage-2 sampler {name} {tuple(feats.shape)} -> {hw}"
        worst = max(worst, _held(k1.stn_place_multi_nchw(feats, bbox, hw),
                                 k1.stn_place_multi_plain(feats, bbox, hw),
                                 torch.float32, "K1", label))
        row = time_place(feats, bbox, hw, f"K1 stage-2 sampler {name}")
        k1_rows[name] = {"shape": list(feats.shape), **{k: row[k] for k in (
            "ms", "plain_ms", "graph_ms", "bound_ms", "bound_by",
            "share_of_bound", "graph_share_of_bound")}}
    SUMMARY["s2sample_s"] = {k: round(v, 2) for k, v in seconds.items()}
    for path in (os.path.join(WORK, "s2sample_out"), s2_run["run"]):
        shutil.rmtree(path, ignore_errors=True)
    return launches, {"max_abs_err": worst, **k1_rows,
                      "first_row_card_vs_cpu": err, "seconds": seconds}



# ----------------------------------------------------- eval: FID, IS, layout

FID_BATCH = ATTN_TRAIN_BATCH  # the sampling dump's batch (BATCH_SIZE 14)
FID_REL = 2e-4              # pooled features card vs CPU, of their largest
FID_TIME_RUNS = 5           # CUDA-event readings an Inception forward
SAMPLING_IMAGES = 56        # the dump's --num_images: 4 batches of 14
# runs_r5/attngan_flagship/result.json "sampling_eval" (JAX, 504 images)
JAX_SAMPLING = {"fid": 1.8458772241006986e-07, "is_mean": 1.0, "is_std": 0.0}
LAYOUT_N = 128
# runs_r5/mnist_repin/result.json "layout_fidelity" (JAX tool, another
# seed and n: 62 objects)
JAX_LAYOUT = {"recall": 0.677, "loc_iou": 0.489}
LAYOUT_BATCH = 64           # the layout tool's batch


def _he_init(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Random weights for the canonical FID Inception (its pt_inception
    file is not in the repository): convs N(0, 2 / fan_in), BatchNorm at
    its defaults, so that the features keep their scale through the 94
    layers."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                std = float(np.sqrt(2.0 / m.weight[0].numel()))
                m.weight.normal_(0.0, std, generator=gen)
    return model.eval().requires_grad_(False)


def _rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| over max |want|."""
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _scale(acts: np.ndarray) -> dict:
    return {"abs_max": float(np.abs(acts).max()),
            "mean_dim_std": float(acts.std(0).mean()),
            "zero_share": float((acts == 0).mean())}


def _test_batch(data: str, device) -> dict:
    """The first FID_BATCH items of the flagship set's test split, drawn
    as the sampling entry's reader draws them (seed ATTN_SET[1])."""
    return AttnGanTrainSet(data, data + "_imgs", captions_per_image=5,
                           seed=ATTN_SET[1], split="test",
                           device=device).get_batch(np.arange(FID_BATCH))


def phase_fid(model):
    log("phase 44/52 fid: the canonical FID Inception (seeded weights) and "
        "the flagship DAMSM image encoder's pool (image_encoder29.pth) at "
        f"batch {FID_BATCH} of the test split's 256px images, card against "
        "CPU; the same forward under a --bf16 process's TF32 settings; "
        "Inception ms an image (CUDA events); scipy's version")
    import scipy
    reals = torch.from_numpy(_test_batch(model["data"], "cpu")["image256"]
                             ).float() / 127.5 - 1.0           # NHWC
    fid_cpu = _he_init(FIDInceptionV3(), 44)
    nets = {"fid_inception": {"cpu": fid_cpu,
                              DEVICE: copy.deepcopy(fid_cpu).to(DEVICE)},
            "damsm_pool": {dev: build_image_encoder(
                256, load_image_encoder(ATTN_IMAGE_E), device=dev)
                for dev in ("cpu", DEVICE)}}
    rows = {}
    for name, by_dev in nets.items():
        acts = {dev: inception_activations(enc, reals, FID_BATCH)
                for dev, enc in by_dev.items()}
        err = _rel_err(acts[DEVICE], acts["cpu"])
        scale = _scale(acts["cpu"])
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        try:        # what float32_policy leaves on in a --bf16 process
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            tf32_on = inception_activations(by_dev[DEVICE], reals,
                                            FID_BATCH)
            after = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev
        bf16_err = _rel_err(tf32_on, acts[DEVICE])
        x32 = reals.repeat(3, 1, 1, 1)[:32].permute(0, 3, 1, 2).to(DEVICE)
        enc = by_dev[DEVICE]

        def forward():
            with torch.no_grad(), float32_pinned():
                enc(x32, return_pool=True)

        ms = cuda_ms(forward, warmup=2, runs=FID_TIME_RUNS)
        gflop = _flop_count(forward) / 32
        rows[name] = {"card_vs_cpu_rel": err, "tf32_settings_rel": bf16_err,
                      "tf32_bit_identical": bool(np.array_equal(
                          tf32_on, acts[DEVICE])),
                      "ms_per_image": ms / 32, "gflop_per_image": gflop,
                      "tflop_per_s": gflop * 32 / ms, **scale}
        log(f"  {name}: card vs CPU max |diff| {err:.3e} of the features' "
            f"largest (limit {FID_REL:g}); features: abs max "
            f"{scale['abs_max']:.4g}, mean per-dimension std "
            f"{scale['mean_dim_std']:.3g}, {scale['zero_share']:.1%} exactly "
            f"zero; with TF32 on around it {bf16_err:.3e} "
            f"(bit-identical {rows[name]['tf32_bit_identical']}), the "
            f"caller's flags back {after == (True, True)}; batch 32 "
            f"{ms:.3f} ms, {ms / 32:.3f} ms an image, {gflop:.2f} GFLOP an "
            f"image, {gflop * 32 / ms:.1f} TFLOP/s")
        check(err <= FID_REL, f"{name}: card and CPU features disagree")
        check(bf16_err <= 1e-6, f"{name}: the forward follows the caller's "
              "TF32 settings")
        check(after == (True, True), f"{name}: the caller's TF32 settings "
              "were not restored")
    log(f"  scipy {scipy.__version__}, numpy {np.__version__} (the host "
        "FID's matrix root)")
    SUMMARY["fid"] = {k: {"rel": v["card_vs_cpu_rel"],
                          "ms_img": v["ms_per_image"],
                          "abs_max": v["abs_max"]} for k, v in rows.items()}
    return {"image_enc_cpu": nets["damsm_pool"]["cpu"],
            "image_enc_card": nets["damsm_pool"][DEVICE], "rows": rows,
            "scipy": scipy.__version__}


def phase_sampling(model, fid):
    log("phase 45/52 sampling: cli/main.py --variant coco-attngan "
        f"--eval_mode sampling --num_images {SAMPLING_IMAGES} from the "
        "flagship's EMA G and DAMSM pair on the synthetic test split; the "
        "first batch's features card against CPU; K1 at the dump's shape")
    data = model["data"]
    cfg_file = _attn_eval_cfg(data)
    out = os.path.join(WORK, "attn_sampling")
    host = {"fid_s": [], "features_s": []}
    fid_fn, acts_fn = (attngan_runner.fid_from_activations,
                       attngan_runner.inception_activations)

    def fid_timed(*args):
        t = time.perf_counter()
        try:
            return fid_fn(*args)
        finally:
            host["fid_s"].append(time.perf_counter() - t)

    def acts_timed(*args):
        t = time.perf_counter()
        try:
            return acts_fn(*args)           # numpy: the device is done
        finally:
            host["features_s"].append(time.perf_counter() - t)

    attngan_runner.fid_from_activations = fid_timed
    attngan_runner.inception_activations = acts_timed
    argv = ["--variant", "coco-attngan", "--cfg", cfg_file, "--data_dir",
            data, "--manualSeed", str(ATTN_SET[1]), "--eval_mode",
            "sampling", "--num_images", str(SAMPLING_IMAGES)]
    try:
        _, launches, seconds = _entry("coco-attngan sampling",
                                      [*argv, "--output_dir", out])
    finally:
        attngan_runner.fid_from_activations = fid_fn
        attngan_runner.inception_activations = acts_fn
    batches = -(-SAMPLING_IMAGES // FID_BATCH)
    names = sorted(os.listdir(os.path.join(out, "single_samples")))
    check(names == [f"s_{i:06d}.png" for i in range(SAMPLING_IMAGES)],
          f"{len(names)} single images")
    with open(os.path.join(out, "eval_metrics.json")) as f:
        m = json.load(f)
    check(set(m) == {"fid", "inception_score_mean", "inception_score_std",
                     "n_images", "is_head", "is_backbone", "fid_encoder"},
          f"eval_metrics.json keys {sorted(m)}")
    check((m["fid_encoder"], m["is_backbone"], m["is_head"]) == (
        "damsm", "imported", "random"), f"provenance {m}")
    check(m["n_images"] == SAMPLING_IMAGES and np.isfinite(m["fid"]),
          f"metrics {m}")
    check(launches == (batches, 0), f"sampling K1/K2 launches {launches}; "
          f"one K1 a batch ({batches}) expected")
    log(f"  {SAMPLING_IMAGES} images in {batches} batches of {FID_BATCH}: "
        f"the entry {seconds:.2f} s (host clock: G and encoders loaded, the "
        f"split's JPEGs, PNGs), of it the features "
        f"{sum(host['features_s']):.2f} s ({len(host['features_s'])} "
        f"sweeps) and the host FID "
        f"{sum(host['fid_s']):.2f} s; FID {m['fid']:.4g} (JAX's record "
        f"{JAX_SAMPLING['fid']:.4g} at 504 images), IS "
        f"{m['inception_score_mean']:.4f} +/- {m['inception_score_std']:.4f} "
        f"(JAX's {JAX_SAMPLING['is_mean']:.3f} +/- "
        f"{JAX_SAMPLING['is_std']:.3f}); printed, not held")

    # the first batch again on the card, its features against the CPU's
    batch = {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v).to(DEVICE)
        for k, v in _test_batch(data, DEVICE).items()}
    text = build_text_encoder(ATTN_WORDS, 256, load_text_encoder(ATTN_NET_E),
                              device=DEVICE)
    g = build_attngan_g(model["mcfg"], load_reference_attngan_g(ATTN_NET_G),
                        device=DEVICE)
    z = torch.from_numpy(sample_noise(ATTN_SET[1], 0, FID_BATCH,
                                      100)).to(DEVICE)
    with torch.inference_mode():
        words, sent = text(batch["captions"], batch["cap_lens"])
        fakes = g(z, sent, words, batch["captions"] == 0, batch["bbox"],
                  batch["label_onehot"]).float().permute(0, 2, 3, 1)
    reals = batch["image256"].float() / 127.5 - 1.0
    errs, scales = {}, {}
    for side, x in (("fake", fakes), ("real", reals)):
        card = inception_activations(fid["image_enc_card"], x, FID_BATCH)
        cpu = inception_activations(fid["image_enc_cpu"], x.cpu(),
                                    FID_BATCH)
        errs[side], scales[side] = _rel_err(card, cpu), _scale(cpu)
    levels = int(np.abs(read_png(os.path.join(out, "single_samples",
                                              names[0]), "RGB")
                        .astype(np.int16)
                        - tile_uint8(fakes[0].cpu().numpy())).max())
    log(f"  batch 0 features card vs CPU: fakes {errs['fake']:.3e}, reals "
        f"{errs['real']:.3e} of their largest (limit {FID_REL:g}); their "
        f"abs max {scales['fake']['abs_max']:.4g} and "
        f"{scales['real']['abs_max']:.4g}, mean per-dimension std "
        f"{scales['fake']['mean_dim_std']:.3g} and "
        f"{scales['real']['mean_dim_std']:.3g}; s_000000.png against the "
        f"card's image {levels} levels (limit {SAMPLE_LEVELS})")
    check(max(errs.values()) <= FID_REL, "the dump's features: card and CPU "
          "disagree")
    check(levels <= SAMPLE_LEVELS, "the dump's first PNG is not the card's "
          "image")

    # K1 at the dump's shape: the batch's boxes, the third object padded
    bbox = batch["bbox"].float().contiguous()
    c, hw = model["mcfg"].ngf // 4, (16, 16)
    feats = torch.from_numpy(np.random.RandomState(45).randn(
        FID_BATCH, 3, c, *hw).astype(np.float32)).to(DEVICE)
    label = f"sampling {tuple(feats.shape)} -> {hw}"
    worst = _held(k1.stn_place_multi_nchw(feats, bbox, hw),
                  k1.stn_place_multi_plain(feats, bbox, hw), torch.float32,
                  "K1", label)
    row = time_place(feats, bbox, hw, "K1 AttnGAN sampling")
    SUMMARY["sampling"] = {"s": seconds, "fid_s": sum(host["fid_s"]),
                           "features_s": sum(host["features_s"]),
                           "fid": m["fid"],
                           "is": m["inception_score_mean"]}
    return {"sampling_coco-attngan": launches}, {
        "max_abs_err": worst, "shape": list(feats.shape),
        **{k: row[k] for k in ("ms", "plain_ms", "graph_ms", "bound_ms",
                               "bound_by", "share_of_bound",
                               "graph_share_of_bound")},
        "metrics": m, "seconds": seconds, "host": host,
        "features_card_vs_cpu": errs, "feature_scale": scales,
        "out": out, "argv": argv}


def phase_layout(clevr_run):
    log(f"phase 46/52 layout: the port's layout tool at n {LAYOUT_N}, mnist "
        "from runs_r5/mnist_repin/netG_final.pth and clevr from phase 22's "
        "run; the score card against CPU on the same images and classifier; "
        "a --profile train entry's trace")
    launches, rows, k1_rows, worst = {}, {}, {}, 0.0
    for variant, ckpt in (("mnist", CKPT), ("clevr", clevr_run)):
        k1.reset_launch_count()
        t = time.perf_counter()
        out, det = layout_tool.main(["--ckpt", ckpt, "--variant", variant,
                                     "--n", str(LAYOUT_N), "--device",
                                     DEVICE], details=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        path = f"layout_{variant}"
        launches[path] = (k1.launch_count(), k1.grad_launch_count())
        batches = -(-LAYOUT_N // LAYOUT_BATCH)
        check(launches[path] == (batches, 0), f"{variant} layout K1/K2 "
              f"launches {launches[path]}; one K1 a batch expected")
        clf = det["clf"]
        cpu_clf = type(clf)({k: v.cpu() for k, v in clf.params.items()},
                            clf.crop)
        score = (layout_fidelity if variant == "mnist"
                 else clevr_layout_fidelity)
        cpu = score(det["images"], det["bbox"], det["labels"], cpu_clf)
        n_obj = det["bbox"].shape[1]
        check(out == cpu, f"{variant}: the card's score {out} != the CPU's "
              f"{cpu}")
        check(out["n_objects"] == LAYOUT_N * n_obj, f"{variant}: "
              f"{out['n_objects']} objects")
        rows[variant] = {**out, "seconds": seconds}
        recall = out.get("recall", out.get("recall_both"))
        ref = (f" (JAX's record {JAX_LAYOUT['recall']} and "
               f"{JAX_LAYOUT['loc_iou']}, another seed and n; not held)"
               if variant == "mnist" else "")
        log(f"  {variant}: recall {recall}, loc_iou {out['loc_iou']}{ref}; "
            f"{out['n_objects']} objects in {seconds:.2f} s (host clock: "
            f"classifier trained on the card, G, scores); K1 "
            f"{launches[path][0]}; the CPU's score on the same images and "
            "classifier equal")
        # K1 at the tool's shape and boxes
        ncfg = stage1_model_config(cfg_from_file(
            os.path.join(ROOT, "cfg", f"{variant}_train.yml"),
            layout_tool.VARIANTS[variant]), layout_tool.VARIANTS[variant])
        bbox = torch.from_numpy(det["bbox"][:LAYOUT_BATCH]).to(DEVICE)
        c, hw = ncfg.ngf // 4, (16, 16)
        feats = torch.from_numpy(np.random.RandomState(46).randn(
            LAYOUT_BATCH, n_obj, c, *hw).astype(np.float32)).to(DEVICE)
        worst = max(worst, _held(k1.stn_place_multi_nchw(feats, bbox, hw),
                                 k1.stn_place_multi_plain(feats, bbox, hw),
                                 torch.float32, "K1",
                                 f"layout {variant} {tuple(feats.shape)}"))
        row = time_place(feats, bbox, hw, f"K1 layout tool {variant}")
        k1_rows[variant] = {"shape": list(feats.shape), **{k: row[k] for k in (
            "ms", "plain_ms", "graph_ms", "bound_ms", "bound_by",
            "share_of_bound", "graph_share_of_bound")}}

    # --profile: one mnist train epoch traced at steps 2-3 (4 steps)
    prof = os.path.join(WORK, "profile")
    launches["train_profile"] = train_entry(("--profile", prof))[:2]
    files = glob.glob(os.path.join(prof, "*.json"))
    check(len(files) == 1, f"profile traces {files}")
    with open(files[0]) as f:
        names = [str(e.get("name", "")) for e in json.load(f)["traceEvents"]]
    named = {k: sum(k in n for n in names) for k in (
        "stn_place_multi_kernel", "stn_place_multi_grad_kernel")}
    log(f"  --profile: {os.path.basename(files[0])}, "
        f"{os.path.getsize(files[0]) / 2**20:.1f} MiB, {len(names)} events; "
        f"K1 kernel events {named['stn_place_multi_kernel']}, K2 "
        f"{named['stn_place_multi_grad_kernel']}")
    check(all(named.values()), f"the trace names no K1/K2 kernel: {named}")
    shutil.rmtree(prof, ignore_errors=True)
    SUMMARY["layout"] = {k: {"recall": v.get("recall", v.get("recall_both")),
                             "loc_iou": v["loc_iou"], "s": v["seconds"]}
                         for k, v in rows.items()}
    return launches, {"max_abs_err": worst, **k1_rows, "scores": rows,
                      "trace_kernel_events": named}


# ------------------------------------------------------------ scale-out

DIST_WORLD = 2              # the ranks of phases 48 and 49
DIST_STEP_RUNS = 1          # timed steps a case, at world 1 and world 2
DIST_LOSS_ATOL = 1e-3       # world 2 against world 1 on the card: losses
DIST_LOSS_RTOL = 1e-4       # (atol plus rtol of the loss)
# per parameter tensor, world 2 against world 1, from warm Adams (the
# update linear in the gradient): the card-vs-CPU steps' gradient limit
# (phases 8, 34), since cuDNN's backward differs run to run on the card;
# a second one-process run's own lowest cosine is printed beside it
DIST_MIN_UPDATE_COSINE = MIN_GRAD_COSINE
DIST_TIMEOUT = 600          # seconds for one spawn of the ranks
DUMP_FID_ATOL = 1e-6        # the world-2 dump's FID against world 1's
DUMP_IS_RTOL = 1e-4         # (features 7 images a G forward against 14)
DIST_LAUNCHES = {"mnist": (4, 4), "attngan": ATTN_LAUNCHES,
                 "damsm": (0, 0)}


def _rank_env() -> dict:
    """The environment of a process this script starts: the checkout on
    its path, no process group of its own."""
    env = {k: v for k, v in os.environ.items()
           if k not in dist_steps.ENV_KEYS}
    env["PYTHONPATH"] = os.pathsep.join([ROOT, env.get("PYTHONPATH", "")])
    return env


def phase_dist_entry():
    log("phase 47/52 nccl1: cli/main.py --variant multi-mnist --synthetic "
        "for one epoch as world size 1 over NCCL (MOG_COORDINATOR ...), "
        "against the same run without the environment, bit for bit "
        "(cudnn.deterministic in both, each in a process of its own, the "
        "two at once)")
    code = ("import sys, torch; torch.backends.cudnn.deterministic = True; "
            "from multiple_objects_gan_tpu_torch.cli.main import main; "
            "main(sys.argv[1:])")
    data = os.path.join(WORK, "data", "dist1")
    # the set the entries' --synthetic would write (DECODE_ITEMS, seed 7),
    # written once here so that the two entries only read it
    write_synthetic_multimnist(data, n=DECODE_ITEMS, split="train", seed=7)
    group = {"MOG_COORDINATOR": f"localhost:{dist_steps.free_port()}",
             "MOG_NUM_PROCESSES": "1", "MOG_PROCESS_ID": "0"}
    runs, seconds, procs = {}, {}, {}
    # each in a process of its own (this process's cached memory could
    # steer cuDNN's choice of algorithm), both started together
    t = time.perf_counter()
    try:
        for name in ("plain", "nccl"):
            out = os.path.join(WORK, "dist1", name)
            argv = ["--variant", "multi-mnist", "--cfg", MNIST_TRAIN,
                    "--synthetic", "--max_epochs", "1", "--manualSeed", "7",
                    "--device", DEVICE, "--data_dir", data, "--output_dir",
                    out]
            procs[name] = (out, subprocess.Popen(
                [sys.executable, "-c", code, *argv],
                env={**_rank_env(), **(group if name == "nccl" else {})},
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        for name, (out, proc) in procs.items():
            stdout, stderr = proc.communicate(timeout=DIST_TIMEOUT)
            seconds[name] = time.perf_counter() - t
            check(proc.returncode == 0, f"the {name} entry failed:\n"
                  f"{stdout[-3000:]}\n{stderr[-3000:]}")
            runs[name] = {"out": stdout,
                          "ckpt": CheckpointManager(os.path.join(
                              out, "models")).load(0)[0],
                          "log": open(os.path.join(out, "logs",
                                                   "metrics.jsonl")).read()}
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    banner = [ln for ln in runs["nccl"]["out"].splitlines()
              if ln.startswith("torch.distributed:")]
    log(f"  {banner[0] if banner else 'no process-group line'}; entries "
        f"{seconds['plain']:.1f} s without the environment, "
        f"{seconds['nccl']:.1f} s with it (host clock from their common "
        "start, processes included)")
    check(not any(ln.startswith("torch.distributed:")
                  for ln in runs["plain"]["out"].splitlines()),
          "the run without the environment started a process group")
    losses = [{k: v for k, v in json.loads(line).items() if k != "time"}
              for run in (runs["plain"], runs["nccl"])
              for line in run["log"].splitlines()[:1]]
    check(losses[0] == losses[1], f"logged losses differ: {losses}")
    differ = []

    def walk(a, b, where):
        if isinstance(a, dict):
            check(sorted(a, key=str) == sorted(b, key=str), where)
            for k in a:
                walk(a[k], b[k], f"{where}.{k}")
        elif isinstance(a, torch.Tensor):
            if not torch.equal(a, b):
                differ.append(where)
        elif isinstance(a, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{where}[{i}]")
        elif a != b:
            differ.append(where)

    walk(runs["plain"]["ckpt"], runs["nccl"]["ckpt"], "ckpt")
    log(f"  step 0's logged losses equal ({len(losses[0]) - 1} scalars); "
        f"checkpoint tensors differing: {len(differ)}")
    check(not differ, f"world size 1 over NCCL strays: {differ[:5]}")
    check(bool(banner) and "backend nccl" in banner[0]
          and "rank 0 of 1" in banner[0], "world size 1 did not start NCCL")
    shutil.rmtree(os.path.join(WORK, "dist1"), ignore_errors=True)
    return {"s": seconds, "banner": banner[0]}


def _dist_cases(attn_weights, ds) -> list:
    """Phase 48's step cases on the CPU: mnist at full width (GF 128,
    DF 64, global batch 128, tests/test_step_parity.py's weights), AttnGAN
    at GF 48 / DF 96 (the flagship's EMA G, seeded Ds and DAMSM pair,
    global batch 14) and DAMSM (the flagship pair, global batch 48), each
    from warm Adams."""
    mnist = create_state(MNIST, seed=0, device="cpu")
    randomize(mnist.g, 3)
    randomize(mnist.d, 11)
    warm_adam(mnist)
    mcfg = attngan_model_config(cfg_from_file(ATTN_TRAIN_CFG, "coco-attngan"))
    g_sd, d_sds, e_sd, i_sd = attn_weights
    attn, text, image = _attn_nets("cpu", mcfg, g_sd, d_sds, ATTN_WORDS,
                                   e_sd, i_sd)
    warm_adam(attn)
    damsm = _damsm_state("cpu")
    tensors = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
    st = attngan_train_settings(cfg_from_file(DAMSM_CFG, "damsm"))
    return [
        {"name": "mnist", "kind": "stage1", "config": MNIST, "state": mnist,
         "batch": tensors(synthetic_multimnist(STEP_BATCH, seed=48)),
         "seed": 48, "lr": LR, "time_runs": DIST_STEP_RUNS},
        {"name": "attngan", "kind": "attngan", "config": mcfg, "state": attn,
         "encoders": (text, image),
         "batch": tensors(_attn_train_batch(ds, ATTN_TRAIN_BATCH, 48)),
         "seed": 48, "lr": LR, "time_runs": DIST_STEP_RUNS},
        {"name": "damsm", "kind": "damsm", "state": damsm,
         "smooth": _damsm_smooth(), "grad_clip": st.rnn_grad_clip,
         "batch": tensors(_attn_train_batch(ds, DAMSM_BATCH, 48)),
         "seed": 48, "lr": LR, "time_runs": DIST_STEP_RUNS}]


def _dist_modules(ckpt: dict) -> dict:
    """{module name: state dict} of a train state's checkpoint contents."""
    out = {k: ckpt[k] for k in ("g", "text", "image") if k in ckpt}
    if "g_ema" in ckpt:
        out.update({f"d.{n}": sd for n, sd in ckpt["d"].items()})
    elif "d" in ckpt:
        out["d"] = ckpt["d"]
    return out


def _same_bits(a, b) -> bool:
    if isinstance(a, dict):
        return sorted(a, key=str) == sorted(b, key=str) and all(
            _same_bits(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same_bits, a, b))
    return a == b


def dist_local_places() -> dict:
    """K1 and K2 at the place shapes of a rank of phase 48, float32: the
    mnist step's G (64,3,256,16x16) and D (64,3,128,15x15) onto 16x16 and
    AttnGAN's G (7,3,192,16x16) and D64 (7,3,192,15x15) onto 16x16, on
    boxes inside the canvas with the last object padded, held against
    their plain versions and timed cold in turns and on the device alone
    (:func:`time_place`, :func:`time_grad`)."""
    rs = np.random.RandomState(48)
    dev = torch.device(DEVICE)
    shapes = {"mnist": (STEP_BATCH // DIST_WORLD, {
        "G": (3, 256, (16, 16), (16, 16)),
        "D": (3, 128, (15, 15), (16, 16))}),
        "attngan": (ATTN_TRAIN_BATCH // DIST_WORLD, attn_train_shapes())}
    out = {"place": {}, "grad": {}, "max_abs_err": {"place": 0.0,
                                                    "grad": 0.0}}
    for name, (b, paths) in shapes.items():
        for path, (o, c, hw, out_hw) in paths.items():
            bbox = torch.from_numpy(_stage2_boxes(rs, b, o)).to(dev)
            feats = torch.from_numpy(rs.randn(b, o, c, *hw).astype(
                np.float32)).to(dev)
            g = torch.from_numpy(rs.uniform(-1, 1, (b, c) + out_hw).astype(
                np.float32)).to(dev)
            key = f"dist2_{name}_{path}"
            out["max_abs_err"]["place"] = max(out["max_abs_err"]["place"],
                                              _held(
                k1.stn_place_multi_nchw(feats, bbox, out_hw),
                k1.stn_place_multi_plain(feats, bbox, out_hw), torch.float32,
                "K1", f"{key} {tuple(feats.shape)} -> {out_hw}"))
            out["max_abs_err"]["grad"] = max(out["max_abs_err"]["grad"],
                                             _held(
                k1.stn_place_multi_grad_nchw(g, bbox, hw),
                k1.stn_place_multi_grad_plain(g, bbox, hw), torch.float32,
                "K2", f"{key} {tuple(g.shape)} -> {hw}"))
            out["place"][key] = time_place(feats, bbox, out_hw,
                                           f"K1 at a rank's {name} {path}")
            out["grad"][key] = time_grad(g, bbox, hw,
                                         f"K2 at a rank's {name} {path}")
    return out


def _state_gaps(pre: dict, got: dict, want: dict) -> tuple:
    """Two train states after one step from ``pre`` (checkpoint contents):
    the largest running-statistic gap, and the lowest per-tensor cosine of
    the two updates with its tensor's name."""
    stats, cos, worst = 0.0, 1.0, ""
    gmods, pmods = _dist_modules(got), _dist_modules(pre)
    for part, sd in _dist_modules(want).items():
        for k, w in sd.items():
            g = gmods[part][k]
            if k.endswith(("running_mean", "running_var")):
                stats = max(stats, float((g - w).abs().max()))
            elif w.is_floating_point() and not k.endswith(
                    "num_batches_tracked"):
                c = _cosine(g - pmods[part][k], w - pmods[part][k])
                if c < cos:
                    cos, worst = c, f"{part}.{k}"
    return stats, cos, worst


def phase_dist_steps(attn_weights, sampling):
    log(f"phase 48/52 dist2: the mnist, AttnGAN and DAMSM steps as "
        f"{DIST_WORLD} processes on the card (tools/dist_steps.py), against "
        "one process on the same global batch, from warm Adams; the same "
        "start runs phase 49's dump and phase 51's --bn_groups 3 step")
    _, ds = _attn_set()
    cases = _dist_cases(attn_weights, ds)
    pre = {c["name"]: copy.deepcopy(c["state"].checkpoint_dict())
           for c in cases}
    path = os.path.join(WORK, "dist_cases.pth")
    dump = os.path.join(WORK, "attn_sampling2")
    torch.save(cases, path)
    # phase 51's --bn_groups case runs on the same two ranks: one start
    span, span_pre = _span_case()
    span_path = os.path.join(WORK, "span_cases.pth")
    torch.save([span], span_path)
    torch.save([*cases, span, {"name": "dump", "call":
                         "multiple_objects_gan_tpu_torch.cli.main:main",
                         "kwargs": {"argv": [*sampling["argv"],
                                             "--output_dir", dump,
                                             "--device", DEVICE]}}],
               path + ".ranks")
    del cases, span
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = dist_steps.spawn(path + ".ranks", os.path.join(WORK, "dist_out"),
                             world=DIST_WORLD, device=DEVICE,
                             timeout=DIST_TIMEOUT, env=_rank_env())
    spawn_s = time.perf_counter() - t
    os.remove(path + ".ranks")
    one = dist_steps.run_cases(torch.load(path, weights_only=False), DEVICE)
    again = dist_steps.run_cases(
        [dict(c, time_runs=0) for c in torch.load(path, weights_only=False)],
        DEVICE)
    backend = ranks[0]["backend"]
    log(f"  {DIST_WORLD} ranks over {backend} on "
        f"{', '.join(r['device'] for r in ranks)} "
        f"({torch.cuda.device_count()} card(s)); the spawn "
        f"{spawn_s:.1f} s (host clock: start, steps, timing, dump)")
    check(backend == ("nccl" if torch.cuda.device_count() >= DIST_WORLD
                      else "gloo"), f"backend {backend}")
    rows, launches, failed = {}, {}, []
    for name in one:                # the step cases; "dump" is phase 49's
        want = one[name]
        got = [r["results"][name] for r in ranks]
        bad = [k for k, v in want["metrics"].items()
               if abs(got[0]["metrics"][k] - v)
               > DIST_LOSS_ATOL + DIST_LOSS_RTOL * abs(v)]
        loss_rel = max(abs(got[0]["metrics"][k] - v) / max(abs(v), 1e-12)
                       for k, v in want["metrics"].items())
        stats, cos, worst = _state_gaps(pre[name], got[0]["state"],
                                        want["state"])
        _, floor, floor_at = _state_gaps(pre[name], again[name]["state"],
                                         want["state"])
        ms = [statistics.median(r["step_ms"]) for r in got]
        rows[name] = {"world2_ms": max(ms), "world1_ms":
                      statistics.median(want["step_ms"]),
                      "allreduce_ms": got[0]["allreduce_ms"],
                      "allreduce_calls": got[0]["allreduce_calls"],
                      "loss_rel": loss_rel, "stats": stats,
                      "update_cosine": cos}
        launches.update({f"dist2_{name}_rank{r}": got[r]["launches"]
                         for r in range(DIST_WORLD)})
        log(f"  {name}: losses world 2 / world 1 " + "; ".join(
            f"{k} {got[0]['metrics'][k]:.6f} / {v:.6f}"
            for k, v in sorted(want["metrics"].items())))
        log(f"    worst loss gap {loss_rel:.2e} of the loss (limit "
            f"{DIST_LOSS_ATOL:g} + {DIST_LOSS_RTOL:g} of it); running "
            f"statistics {stats:.3e} (atol {STATS_ATOL:g}); lowest update "
            f"cosine {cos:.8f} ({worst}; limit {DIST_MIN_UPDATE_COSINE:g}; "
            f"one process run again: {floor:.8f}, {floor_at}); the "
            f"replicas equal bit for bit: "
            f"{_same_bits(got[0]['state'], got[1]['state'])}; K1/K2 "
            f"launches a rank {[r['launches'] for r in got]} (one process "
            f"{want['launches']})")
        log(f"    step {rows[name]['world2_ms']:.2f} ms at world 2 "
            f"(median of {DIST_STEP_RUNS}, the slower rank; of it the "
            f"gradient all-reduce {rows[name]['allreduce_ms']:.2f} ms in "
            f"{rows[name]['allreduce_calls']:g} calls, over {backend}) "
            f"against {rows[name]['world1_ms']:.2f} ms in one process "
            "(host clock around synchronised steps)")
        rows[name]["update_cosine_one_process_again"] = floor
        for ok, msg in (
                (_same_bits(got[0]["state"], got[1]["state"]),
                 "the replicas differ after the step"),
                (not bad, f"losses world 2 vs world 1 {bad}"),
                (stats <= STATS_ATOL, f"running statistics {stats}"),
                (cos > DIST_MIN_UPDATE_COSINE, f"update {worst} {cos}"),
                (all(r["launches"] == DIST_LAUNCHES[name] for r in got),
                 f"launches a rank {[r['launches'] for r in got]}")):
            if not ok:
                failed.append(f"{name}: {msg}")
    check(not failed, "; ".join(failed))
    shutil.rmtree(os.path.join(WORK, "dist_out"), ignore_errors=True)
    os.remove(path)
    SUMMARY["dist2"] = {"backend": backend, **{
        k: {"ms": v["world2_ms"], "ms1": v["world1_ms"],
            "ar_ms": v["allreduce_ms"]} for k, v in rows.items()}}
    return launches, {"backend": backend, "rows": rows,
                      "places": dist_local_places(), "dump_dir": dump,
                      "dump": [r["results"]["dump"] for r in ranks],
                      "span": {"pre": span_pre, "backend": backend,
                               "cases": span_path,
                               "ranks": [r["results"]["span"]
                                         for r in ranks]}}


def phase_dist_sampling(sampling, dist2):
    log(f"phase 49/52 dump2: AttnGAN's --eval_mode sampling dump of "
        f"{SAMPLING_IMAGES} images as {DIST_WORLD} processes on the card "
        "(phase 48's start), against phase 45's one-process dump")
    out, one = dist2["dump_dir"], sampling["out"]
    names = sorted(os.listdir(os.path.join(one, "single_samples")))
    check(sorted(os.listdir(os.path.join(out, "single_samples"))) == names,
          "the world-2 dump's files differ from world 1's")
    levels = max(int(np.abs(
        read_png(os.path.join(out, "single_samples", n), "RGB")
        .astype(np.int16) - read_png(os.path.join(
            one, "single_samples", n), "RGB").astype(np.int16)).max())
        for n in names)
    with open(os.path.join(out, "eval_metrics.json")) as f:
        m2 = json.load(f)
    m1 = sampling["metrics"]
    launches = {f"sampling_world2_rank{r}": d["launches"]
                for r, d in enumerate(dist2["dump"])}
    seconds = max(d["seconds"] for d in dist2["dump"])
    batches = -(-SAMPLING_IMAGES // FID_BATCH)
    log(f"  {len(names)} PNGs, the same names as world 1's, pixels within "
        f"{levels} levels (limit {SAMPLE_LEVELS}); FID {m2['fid']:.4g} "
        f"against {m1['fid']:.4g} (atol {DUMP_FID_ATOL:g}), IS "
        f"{m2['inception_score_mean']:.6f} against "
        f"{m1['inception_score_mean']:.6f} (rtol {DUMP_IS_RTOL:g}); the "
        f"entry {seconds:.1f} s on the slower rank (host clock) against "
        f"phase 45's {sampling['seconds']:.1f} s; K1/K2 launches a rank "
        f"{list(launches.values())}")
    check(levels <= SAMPLE_LEVELS, "the world-2 dump's pixels")
    check(m2["n_images"] == m1["n_images"] == SAMPLING_IMAGES, f"{m2}")
    check(abs(m2["fid"] - m1["fid"]) <= DUMP_FID_ATOL, "FID world 2 vs 1")
    check(abs(m2["inception_score_mean"] - m1["inception_score_mean"])
          <= DUMP_IS_RTOL * abs(m1["inception_score_mean"]), "IS")
    check(all(v == (batches, 0) for v in launches.values()),
          f"one K1 a batch on each rank expected: {launches}")
    for d in (out, one):
        shutil.rmtree(d, ignore_errors=True)
    SUMMARY["dump2"] = {"s": seconds, "levels": levels}
    return launches, {"seconds": seconds, "levels": levels,
                      "metrics": m2}


# ------------------------------------------------------------ the tools

# the limits of the learning runs, set in PERF.md §6 before their first
# card run; a miss is a finding, not a limit to lower
VALIDATE_MIN_SEPARATION = 0.15  # final in-box minus out-of-box luminance
VALIDATE_MIN_RECALL = 0.2       # mnist layout-fidelity recall (chance 0.1)
VALIDATE_WIRING = ("--epochs", "2", "--n", "64", "--segments", "1")
VALIDATE_SAMPLING = 28          # the AttnGAN dump's and the harness's cap
VALIDATE_SEED = 7               # the tool's default --seed
# the learning runs' --epochs (the tool's default 20: 800 mnist steps, 400
# clevr steps in 2 segments)
VALIDATE_EPOCHS = {"mnist": 6, "clevr": 6}
STN_ATOL = 1e-5                 # the general STN, card vs separable and CPU
# the tool's generation places (batch 32, on 16x16), not on a path before
VALIDATE_GEN = {"mnist": ("multi-mnist", 10, False),
                "clevr": ("clevr", 0, True)}


def _entry_label(argv) -> str:
    """A train or eval entry's argv -> 'variant mode -> output dir'."""
    def arg(k):
        return argv[argv.index(k) + 1] if k in argv else ""
    mode = arg("--eval_mode") or ("resume" if "--resume" in argv
                                  else "train")
    return (f"{arg('--variant')} {mode} -> "
            f"{os.path.basename(arg('--output_dir'))}")


def run_validate(argv):
    """``tools/validate_learning.py`` on ``argv``: its JSON, the K1 and K2
    launches of each train entry and each generation it made (in order),
    the launches of the whole run, and its seconds (host clock)."""
    calls, saved = [], {n: getattr(vl, n) for n in (
        "cli_main", "_generate_stage1", "_generate_stage2",
        "_generate_attngan")}

    def counted(name, fn):
        def wrapped(*args, **kwargs):
            k0, g0 = k1.launch_count(), k1.grad_launch_count()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                calls.append({
                    "call": (_entry_label(args[0]) if name == "cli_main"
                             else f"generate #{len(calls)}"),
                    "launches": (k1.launch_count() - k0,
                                 k1.grad_launch_count() - g0)})
        return wrapped

    k1.reset_launch_count()
    t = time.perf_counter()
    try:
        for name, fn in saved.items():
            setattr(vl, name, counted(name, fn))
        out = vl.main([*argv, "--device", DEVICE])
    finally:
        for name, fn in saved.items():
            setattr(vl, name, fn)
    torch.cuda.synchronize()
    return (out, calls, (k1.launch_count(), k1.grad_launch_count()),
            time.perf_counter() - t)


def _numbers(x):
    """Every int and float of a JSON value (booleans left out)."""
    if isinstance(x, bool):
        return []
    if isinstance(x, (int, float)):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [v for item in x for v in _numbers(item)]
    return []


def _check_calls(name, calls, entries, generations):
    """The launches of each train entry (``entries``: label substring ->
    expected (K1, K2)) and of each generation (``generations``: expected
    (K1, K2) each)."""
    for c in calls:
        want = (generations if c["call"].startswith("generate") else next(
            (v for k, v in entries.items() if k in c["call"]), None))
        log(f"    {c['call']}: K1/K2 {c['launches']}"
            + ("" if want is None else f" (expected {want})"))
        check(want is None or tuple(c["launches"]) == tuple(want),
              f"{name}: {c['call']} launched K1/K2 {c['launches']}, "
              f"expected {want}")


# a learning run in a process of its own: run_validate's result as JSON
VALIDATE_CHILD = (
    "import json, sys; import chip_smoke as cs; cs.DEVICE = sys.argv[3]; "
    "out, calls, total, s = cs.run_validate(json.loads(sys.argv[1])); "
    "json.dump({'json': out, 'calls': calls, 'launches': total, "
    "'seconds': s}, open(sys.argv[2], 'w'))")


def _learning_argv(variant):
    work = os.path.join(WORK, f"validate_{variant}")
    return [variant, "--workdir", work, "--epochs",
            str(VALIDATE_EPOCHS[variant])], work


def _start_learning(variant):
    """Start a learning run (VALIDATE_EPOCHS) in a process of its own
    (the runs are host-bound: two at once share the card); returns what
    :func:`_join_learning` takes."""
    argv, work = _learning_argv(variant)
    result = os.path.join(WORK, f"validate_{variant}.json")
    out = open(os.path.join(WORK, f"validate_{variant}.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", VALIDATE_CHILD, json.dumps(argv), result,
         DEVICE], env=_rank_env(), cwd=ROOT, stdout=out,
        stderr=subprocess.STDOUT)
    return {"variant": variant, "proc": proc, "result": result,
            "log": out, "work": work, "t": time.perf_counter()}


def _join_learning(child):
    """Wait for a run :func:`_start_learning` started; its result."""
    proc = child["proc"]
    try:
        proc.wait(timeout=DIST_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        child["log"].close()
    if proc.returncode != 0:
        with open(child["log"].name) as f:
            tail = f.read()[-3000:]
        check(False, f"the {child['variant']} run failed:\n{tail}")
    with open(child["result"]) as f:
        run = json.load(f)
    run["launches"] = tuple(run["launches"])
    run["calls"] = [{**c, "launches": tuple(c["launches"])}
                    for c in run["calls"]]
    joined = time.perf_counter() - child["t"]
    log(f"  {child['variant']} ran in a process of its own beside the "
        f"phase's other work on the card (joined {joined:.1f} s after its "
        "start, host clock)")
    return {**run, "work": child["work"]}


def _held_learning(variant, run):
    """A learning run's launches and its limits."""
    out, calls, total, seconds = (run["json"], run["calls"],
                                  run["launches"], run["seconds"])
    vcfg = vl.CFG_FILES[vl.VARIANTS[variant]]
    cfg = cfg_from_file(vcfg, vl.VARIANTS[variant])
    batch, n = int(cfg.TRAIN.BATCH_SIZE), vl.SET_SIZES[variant]
    args = vl.parse_args(_learning_argv(variant)[0])
    seg = args.epochs // args.segments   # epochs a segment
    steps = seg * (n // batch)
    _check_calls(variant, calls, {"train": (4 * steps + seg, 4 * steps),
                                  "resume": (4 * steps + seg, 4 * steps)},
                 (1, 0))
    lfid = out["layout_fidelity"]
    recall = lfid.get("recall", lfid.get("recall_both"))
    log(f"  {variant}: separation {out['separation']} (in {out['in_box']}, "
        f"out {out['out_box']}; trend {out['separation_trend']}; limit >= "
        f"{VALIDATE_MIN_SEPARATION}); FID trend {out['fid_trend']}, "
        f"decreasing {out['fid_decreasing']}; layout fidelity "
        f"{'recall' if variant == 'mnist' else 'recall_both'} {recall}, "
        f"loc_iou {lfid['loc_iou']} over {lfid['n_objects']} objects "
        f"(trend {out['layout_fidelity_trend']}"
        + (f"; limit >= {VALIDATE_MIN_RECALL})" if variant == "mnist"
           else "; chance 1/24, printed)")
        + f"; {seconds:.1f} s (host clock, the set's writing included); "
        f"K1/K2 {total}")
    check(out["fid_decreasing"], f"{variant}: the FID trend "
          f"{out['fid_trend']} does not fall")
    check(out["separation"] >= VALIDATE_MIN_SEPARATION,
          f"{variant}: separation {out['separation']}")
    if variant == "mnist":
        check(recall >= VALIDATE_MIN_RECALL, f"mnist: recall {recall}")
    return run


def _same_images(pth, run_dir, mcfg):
    """The G of a reference NET_G .pth (``cli/sample.py:load_generator``,
    a strict load) and the run checkpoint's G on one batch of the tool's
    layouts, on the card: whether the images are equal bit for bit."""
    bbox, labels, _ = vl._random_layouts(vl.GEN_BATCH, mcfg.num_objects,
                                         mcfg.label_dim, VALIDATE_SEED + 1,
                                         n_classes=mcfg.label_dim)
    z = torch.from_numpy(sample_noise(VALIDATE_SEED, 0, vl.GEN_BATCH,
                                      mcfg.z_dim)).to(DEVICE)
    sample = make_sample_fn(mcfg)
    imgs = [sample(load_generator(mcfg, src, VALIDATE_SEED, DEVICE), z,
                   torch.from_numpy(bbox).to(DEVICE),
                   torch.from_numpy(labels).to(DEVICE))
            for src in (pth, run_dir)]
    return torch.equal(*imgs), float((imgs[0] - imgs[1]).abs().max())


def _gen_places():
    """K1 at the tool's generation places, its layouts and random
    features, f32 and bf16, held against its plain version and timed."""
    rows, worst = {}, 0.0
    for name, (variant, n_classes, clevr) in VALIDATE_GEN.items():
        mcfg = stage1_model_config(cfg_from_file(
            vl.CFG_FILES[variant], variant), variant)
        bbox, _, _ = vl._random_layouts(vl.GEN_BATCH, mcfg.num_objects,
                                        mcfg.label_dim, VALIDATE_SEED + 1,
                                        n_classes=n_classes, clevr=clevr)
        bbox = torch.from_numpy(bbox).to(DEVICE)
        hw = (16, 16)
        feats = torch.from_numpy(np.random.RandomState(50).randn(
            vl.GEN_BATCH, mcfg.num_objects, mcfg.ngf // 4, *hw).astype(
                np.float32)).to(DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            f = feats.to(dtype)
            label = f"validate {name} {tuple(f.shape)} {str(dtype)[6:]}"
            err = _held(k1.stn_place_multi_nchw(f, bbox, hw),
                        k1.stn_place_multi_plain(f, bbox, hw), dtype, "K1",
                        label)
            if dtype == torch.float32:
                worst = max(worst, err)
            row = time_place(f, bbox, hw, f"K1 {label}")
            rows[f"{name}_{str(dtype)[6:]}"] = {
                "shape": list(f.shape), **{k: row[k] for k in (
                    "ms", "plain_ms", "graph_ms", "bound_ms", "bound_by",
                    "share_of_bound", "graph_share_of_bound")}}
    return rows, worst


def _general_stn():
    """The general STN (affine_grid + grid_sample) on the card: equal to
    stn_separable at axis-aligned thetas and to the CPU's result at random
    thetas, within STN_ATOL."""
    rs = np.random.RandomState(50)
    img = torch.from_numpy(rs.uniform(-1, 1, (8, 16, 16, 192)).astype(
        np.float32))
    boxes = np.concatenate([rs.uniform(0.0, 0.6, (8, 2)),
                            rs.uniform(0.2, 0.5, (8, 2))], -1)
    boxes[0] = -1.0                                  # a padded object
    aligned = port_ops.transformation_matrix_inverse(
        torch.from_numpy(boxes.astype(np.float32)))
    general = torch.from_numpy(rs.uniform(-1.5, 1.5, (8, 2, 3)).astype(
        np.float32))
    errs = {}
    dimg, dal = img.to(DEVICE), aligned.to(DEVICE)
    with float32_pinned():
        errs["card general vs separable, axis-aligned"] = float((
            port_ops.stn(dimg, dal, (16, 16))
            - port_ops.stn_separable(dimg, dal, (16, 16))).abs().max())
        errs["card vs CPU, random thetas"] = float((
            port_ops.stn(dimg, general.to(DEVICE), (16, 16)).cpu()
            - port_ops.stn(img, general, (16, 16))).abs().max())
    for k, v in errs.items():
        log(f"  general stn {k} (8, 16, 16, 192) -> 16x16: max |diff| "
            f"{v:.3e} (atol {STN_ATOL:g})")
        check(v <= STN_ATOL, f"general stn: {k}")
    return errs


def _check_dataset(argv):
    """``tools/check_dataset.py`` on the card: its JSON and exit code."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = check_tool.main([*argv, "--device", DEVICE])
    return json.loads(buf.getvalue().strip().splitlines()[-1]), rc


def phase_validate():
    log("phase 50/52 validate: the port's tools on the card: "
        "validate_learning for mnist and clevr at 6 epochs "
        "(held: the FID trend falls, separation, mnist recall), the "
        "exporter (the exported G's images bit for bit), the stage-2 and "
        "AttnGAN wiring runs, check_dataset, parity_harness, the general "
        "STN, and K1 at the tool's generation places")
    launches, detail = {}, {}
    # the learning runs each in a process of its own while the wiring runs
    # go on here (all are host-bound)
    clevr = _start_learning("clevr")
    mnist = _start_learning("mnist")
    try:
        detail["mnist"], wiring, ck_rows, result, harness_s = _tool_runs(
            mnist, launches)
    except BaseException:
        for child in (clevr, mnist):
            child["proc"].kill()
            child["proc"].wait()
            child["log"].close()
        raise
    run = _join_learning(clevr)
    detail["clevr"] = _held_learning("clevr", run)
    launches["validate_clevr"] = run["launches"]
    errs = _general_stn()
    places, worst = _gen_places()
    SUMMARY["validate"] = {
        v: {"sep": detail[v]["json"]["separation"],
            "fid": [f for _, f in detail[v]["json"]["fid_trend"]],
            "recall": detail[v]["json"]["layout_fidelity"].get(
                "recall", detail[v]["json"]["layout_fidelity"].get(
                    "recall_both")),
            "iou": detail[v]["json"]["layout_fidelity"]["loc_iou"],
            "s": detail[v]["seconds"]} for v in ("mnist", "clevr")}
    SUMMARY["validate"]["wiring_s"] = {k: v["seconds"]
                                       for k, v in wiring.items()}
    SUMMARY["validate"]["harness"] = {"fid": result["fid"],
                                      "s": harness_s}
    return launches, {"max_abs_err": worst, **places, "general_stn": errs,
                      "runs": {k: {"json": v["json"], "calls": v["calls"],
                                   "seconds": v["seconds"]}
                               for k, v in {**detail, **wiring}.items()},
                      "check_dataset": ck_rows, "harness": result}


def _tool_runs(mnist_child, launches):
    """Phase 50's wiring runs while mnist's learning run goes on in its own
    process, then that run joined and held, the exporter check on its G,
    check_dataset and parity_harness; adds their launches to
    ``launches``."""
    # wiring at small n, no learning limit
    wiring = {}
    for variant, extra in (("coco-stackgan-2", ()), (
            "coco-attngan", ("--damsm_epochs", "1", "--sampling_images",
                             str(VALIDATE_SAMPLING)))):
        work = os.path.join(WORK, f"validate_{variant}")
        pth = os.path.join(work, "netG_export.pth")
        out, calls, total, seconds = run_validate(
            [variant, *VALIDATE_WIRING, *extra, "--export_pth", pth,
             "--workdir", work])
        cfg_file = (vl.CFG_FILES[variant] if variant == "coco-stackgan-2"
                    else os.path.join(work, "coco_attn_full.yml"))
        cfg = cfg_from_file(cfg_file, variant)
        steps = 2 * (64 // int(cfg.TRAIN.BATCH_SIZE))
        if variant == "coco-stackgan-2":
            entries, gen = {"train": (5 * steps + 2 * 2, 4 * steps)}, (2, 0)
        else:
            entries = {"damsm": (0, 0),
                       "coco-attngan train": (4 * steps + 1 + 2, 4 * steps),
                       "sampling": (1, 0)}
            gen = (1, 0)
        _check_calls(variant, calls, entries, gen)
        shown = {k: v for k, v in out.items()
                 if k not in ("workdir", "exported_pth")}
        log(f"  {variant}: {json.dumps(shown)}; {seconds:.1f} s (host "
            f"clock); K1/K2 {total}")
        check(all(math.isfinite(v) for v in _numbers(out)),
              f"{variant}: a number of the JSON line is not finite")
        if variant == "coco-stackgan-2":
            s1_cfg, s2_cfg = stage2_model_config(cfg)
            s1_sd, s2_sd = split_stage2_g(load_reference_g(pth))
            check(s1_sd is not None, "the stage-2 export embeds no STAGE1_G")
            build_stage1_g(s1_cfg, s1_sd, device=DEVICE)
            build_stage2_g(s2_cfg, s2_sd, device=DEVICE)
            log(f"  the stage-2 .pth: STAGE1_G ({len(s1_sd)} tensors) and "
                f"G2 ({len(s2_sd)}) load strictly into the port's G1 and G2")
        else:
            check(out["damsm_word_sent"].get("all_finite") is True,
                  f"damsm_word_sent {out['damsm_word_sent']}")
            acfg = attngan_model_config(cfg)
            build_attngan_g(acfg, load_reference_attngan_g(pth),
                            device=DEVICE)
            d_dir = os.path.join(work, "netD_export")
            export_tool.main(["attngan", "--cfg", cfg_file, "--ckpt",
                              os.path.join(work, "out_e2"), "--out",
                              os.path.join(work, "netG_raw.pth"), "--raw",
                              "--out_d", d_dir, "--device", DEVICE])
            names = sorted(os.listdir(d_dir))
            check(names == [f"netD{i}.pth" for i in range(3)],
                  f"the attngan D export wrote {names}")
            for i, name in enumerate(names):
                build_attngan_d(acfg, 64 * 2 ** i, load_reference_attngan_d(
                    os.path.join(d_dir, name)), device=DEVICE)
            log(f"  the EMA G .pth and {names} load strictly into the "
                "port's GNet and Ds")
        wiring[variant] = {"json": out, "calls": calls, "seconds": seconds,
                           "work": work, "cfg": cfg_file}
        launches[f"validate_{variant}"] = total

    mnist = _held_learning("mnist", _join_learning(mnist_child))
    launches["validate_mnist"] = mnist["launches"]
    # the exporter: mnist's final G as a reference NET_G .pth
    run_dir = os.path.join(mnist["work"],
                           f"out_e{VALIDATE_EPOCHS['mnist']}")
    pth = os.path.join(mnist["work"], "netG_export.pth")
    export_tool.main(["stage1", "--variant", "multi-mnist", "--cfg",
                      vl.CFG_FILES["multi-mnist"], "--ckpt", run_dir,
                      "--out", pth, "--device", DEVICE])
    mcfg = stage1_model_config(cfg_from_file(
        vl.CFG_FILES["multi-mnist"], "multi-mnist"), "multi-mnist")
    same, diff = _same_images(pth, run_dir, mcfg)
    log(f"  export stage1 {os.path.getsize(pth) / 2**20:.1f} MiB: the "
        f"exported NET_G's images against the run checkpoint's G, batch "
        f"{vl.GEN_BATCH} on the card: bit for bit {same} (max |diff| "
        f"{diff:.3e})")
    check(same, "the exported G's images differ from the run's G's")

    # check_dataset over the sets the phase wrote, then two faults
    s2w, aw = (wiring["coco-stackgan-2"]["work"],
               wiring["coco-attngan"]["work"])
    sets = {"mnist": [os.path.join(mnist["work"], "data")],
            "coco-stackgan": [os.path.join(s2w, "data"), "--img_dir",
                              os.path.join(s2w, "imgs")],
            "coco-attngan": [os.path.join(aw, "data"), "--img_dir",
                             os.path.join(aw, "imgs")]}
    ck_rows = {}
    for variant, argv in sets.items():
        out, rc = _check_dataset([variant, *argv])
        ck_rows[variant] = {"ok": out["ok"], "rc": rc,
                            "modes": out["report"].get("image_modes_sampled")}
        log(f"  check_dataset {variant}: ok {out['ok']} (exit {rc}), "
            f"{out['report'].get('n_items')} items, modes "
            f"{out['report'].get('image_modes_sampled')}, warnings "
            f"{out['warnings']}")
        check(out["ok"] and rc == 0, f"check_dataset {variant}: "
              f"{out['errors']}")
    bad = os.path.join(WORK, "check_bad")
    shutil.copytree(os.path.join(s2w, "data"), os.path.join(bad, "data"))
    shutil.copytree(os.path.join(s2w, "imgs"), os.path.join(bad, "imgs"))
    victim = os.path.join(bad, "imgs", sorted(os.listdir(
        os.path.join(bad, "imgs")))[0])
    with open(victim, "rb") as f:
        head = f.read()
    with open(victim, "wb") as f:
        f.write(head[:len(head) // 2])
    os.remove(os.path.join(bad, "data", "train", "labels.pickle"))
    out, rc = _check_dataset(["coco-stackgan", os.path.join(bad, "data"),
                              "--img_dir", os.path.join(bad, "imgs")])
    log(f"  check_dataset on a truncated JPEG and a missing pickle: ok "
        f"{out['ok']} (exit {rc}); errors {out['errors']}")
    check(not out["ok"] and rc == 1, "check_dataset passed a broken set")
    check(any(victim in e for e in out["errors"]),
          "check_dataset did not name the truncated JPEG")
    check(any("labels" in e and "missing file" in e for e in out["errors"]),
          "check_dataset did not name the missing pickle")
    shutil.rmtree(bad, ignore_errors=True)

    # parity_harness on the attngan run's exported .pth
    attn = wiring["coco-attngan"]
    k1.reset_launch_count()
    t = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = parity_tool.main([
            "--net_g", os.path.join(aw, "netG_export.pth"),
            "--data_dir", os.path.join(aw, "data"),
            "--img_dir", os.path.join(aw, "imgs"),
            "--net_e", attn["json"]["net_e"], "--cfg", attn["cfg"],
            "--out", os.path.join(WORK, "parity"), "--num_images",
            str(VALIDATE_SAMPLING), "--seed", str(VALIDATE_SEED),
            "--device", DEVICE])
    torch.cuda.synchronize()
    harness_s = time.perf_counter() - t
    launches["parity_harness"] = (k1.launch_count(),
                                  k1.grad_launch_count())
    log(f"  parity_harness: FID {result['fid']!r}, IS "
        f"{result['inception_score_mean']!r}, {result['n_images']} images, "
        f"provenance fid_encoder {result['fid_encoder']}, is_backbone "
        f"{result['is_backbone']}, is_head {result['is_head']}; "
        f"comparable_to_published {result['comparable_to_published']}; "
        f"{harness_s:.1f} s (host clock); K1/K2 {launches['parity_harness']}")
    check(result["comparable_to_published"] is False,
          "the harness called seeded weights comparable")
    check(math.isfinite(result["fid"]), "the harness's FID")
    check(launches["parity_harness"] == (1, 0), "the harness's dump: one "
          f"K1 a batch of {result['n_images']} expected")
    return mnist, wiring, ck_rows, result, harness_s


# ------------------------------------------- phase 51: the last options

REMAT_MODES = ("0", "full", "convs", "dots")
REMAT_TIME_RUNS = 5         # CUDA-event readings a mode's step time
# every mode against mode 0 on the card, both under cudnn.deterministic
# (cuDNN's default backward differs run to run: mode 0 against itself
# reads update cosines down to 0.99992, PERF.md): losses, per-tensor
# updates from warm Adams, BatchNorm running statistics
REMAT_LOSS_RTOL = 1e-5
REMAT_MIN_UPDATE_COSINE = 0.99999
REMAT_STATS_ATOL = 1e-6
REMAT_LAUNCHES = {"0": (4, 4), "full": (8, 4), "convs": (8, 4),
                  "dots": (8, 4)}   # K1, K2 a step: the recompute places
SPAN_GROUPS = 3             # BatchNorm groups over DIST_WORLD ranks
SPAN_BATCH = 96             # the global batch they split: 32 rows a group
SERVE_MAX_BATCHES = (8, 128)


@contextlib.contextmanager
def _cudnn_deterministic():
    """cuDNN's deterministic algorithms inside the block."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


@contextlib.contextmanager
def _scoped_env(values: dict):
    """The environment variables ``values`` set inside the block, each
    restored (or removed) after it."""
    prev = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _timed_steps(step, runs):
    """``runs`` calls of ``step`` after two warm-ups: the median ms (CUDA
    events), the peak device memory (GiB) and K1/K2 launches a step."""
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.reset_launch_count()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    check(all(bool(torch.isfinite(v)) for v in metrics.values()),
          "non-finite losses while timing")
    return (statistics.median(times),
            torch.cuda.max_memory_allocated() / 2**30,
            (k1.launch_count() / runs, k1.grad_launch_count() / runs))


def _remat_mnist():
    """The mnist f32 step at batch STEP_BATCH under every MOG_REMAT mode
    from one state (tests/test_step_parity.py's weights, warm Adams) and
    one z, held against mode 0 with cuDNN's deterministic algorithms; step
    ms, peak memory and launches a mode at the default algorithms."""
    dev = torch.device(DEVICE)
    state0 = create_state(MNIST, seed=0, device="cpu")
    randomize(state0.g, 3)
    randomize(state0.d, 11)
    warm_adam(state0)
    pre = copy.deepcopy(state0.checkpoint_dict())
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in synthetic_multimnist(STEP_BATCH, seed=51).items()}
    z = torch.from_numpy(np.random.RandomState(51).randn(
        STEP_BATCH, MNIST.z_dim).astype(np.float32)).to(dev)
    rows, launches, runs = {}, {}, {}
    # each mode once, then mode 0 again under cudnn.deterministic (the
    # floor of the held comparison) and twice at the default algorithms
    # (their run-to-run spread, read, not held)
    plan = ([(m, m, True) for m in REMAT_MODES]
            + [("again", "0", True), ("default", "0", False),
               ("default_again", "0", False)])
    for key, mode, deterministic in plan:
        state = copy.deepcopy(state0)
        dist_steps._to_device_(state, dev)
        with _scoped_env({"MOG_REMAT": mode}):
            step = make_train_step(MNIST, KL_COEFF)
        k1.reset_launch_count()
        with (_cudnn_deterministic() if deterministic
              else contextlib.nullcontext()):
            metrics = step(state, batch, None, LR, LR, z=z)
            torch.cuda.synchronize()
        got = (k1.launch_count(), k1.grad_launch_count())
        runs[key] = {"metrics": {k: float(v) for k, v in metrics.items()},
                     "state": {k: {n: t.detach().cpu().clone()
                                   for n, t in v.items()}
                               for k, v in state.checkpoint_dict().items()
                               if k in ("g", "d")}}
        if key in REMAT_MODES:
            launches[f"remat_{mode}"] = got
            gen = torch.Generator(device=dev).manual_seed(51)
            ms, peak, per_step = _timed_steps(
                lambda: step(state, batch, gen, LR, LR), REMAT_TIME_RUNS)
            rows[mode] = {"ms": ms, "peak_gib": peak, "launches": got,
                          "timed_launches_per_step": per_step}
        del state, step
        torch.cuda.empty_cache()
    _, spread, spread_at = _state_gaps(pre, runs["default_again"]["state"],
                                       runs["default"]["state"])
    log(f"  at cuDNN's default algorithms mode 0 against itself: lowest "
        f"update cosine {spread:.8f} ({spread_at}; read, not held)")
    want = runs["0"]
    _, floor, floor_at = _state_gaps(pre, runs["again"]["state"],
                                     want["state"])
    failed = []
    for mode in REMAT_MODES[1:]:
        got = runs[mode]
        same = _same_bits(got["state"], want["state"])
        loss_rel = max(abs(got["metrics"][k] - v) / max(abs(v), 1e-12)
                       for k, v in want["metrics"].items())
        stats, cos, worst = _state_gaps(pre, got["state"], want["state"])
        tracked = all(torch.equal(got["state"][p][k], t)
                      for p in ("g", "d")
                      for k, t in want["state"][p].items()
                      if k.endswith("num_batches_tracked"))
        rows[mode].update(loss_rel=loss_rel, stats=stats,
                          update_cosine=cos, bit_for_bit=same)
        log(f"  MOG_REMAT={mode} against mode 0: worst loss gap "
            f"{loss_rel:.2e} of the loss (limit {REMAT_LOSS_RTOL:g}); "
            f"running statistics {stats:.3e} (atol {REMAT_STATS_ATOL:g}); "
            f"num_batches_tracked equal: {tracked}; lowest update cosine "
            f"{cos:.8f} ({worst}; limit {REMAT_MIN_UPDATE_COSINE:g}; mode 0 "
            f"run again: {floor:.8f}, {floor_at}); G and D equal mode 0's "
            f"bit for bit: {same}")
        for ok, msg in ((loss_rel <= REMAT_LOSS_RTOL, f"losses {loss_rel}"),
                        (stats <= REMAT_STATS_ATOL, f"statistics {stats}"),
                        (tracked, "num_batches_tracked differs"),
                        (cos >= REMAT_MIN_UPDATE_COSINE,
                         f"update {worst} {cos}")):
            if not ok:
                failed.append(f"{mode}: {msg}")
    for mode, row in rows.items():
        log(f"  mnist f32 step at batch {STEP_BATCH}, MOG_REMAT={mode}: "
            f"{row['ms']:.2f} ms (CUDA events, median of {REMAT_TIME_RUNS}),"
            f" {STEP_BATCH * 1e3 / row['ms']:.0f} images/s; peak memory "
            f"{row['peak_gib']:.2f} GiB; K1/K2 launches in the held step "
            f"{row['launches']}, a timed step "
            f"{row['timed_launches_per_step']}")
        if row["launches"] != REMAT_LAUNCHES[mode]:
            failed.append(f"{mode}: K1/K2 launches {row['launches']} != "
                          f"{REMAT_LAUNCHES[mode]}")
    check(not failed, "; ".join(failed))
    rows["floor_cosine"], rows["default_cosine"] = floor, spread
    return rows, launches


def _remat_peaks(attn_weights, ds):
    """Peak device memory and step ms at mode 0 and ``full`` of the
    stage-2 f32 step at batch S2_BATCH and the AttnGAN f32 step at batch
    ATTN_TRAIN_BATCH (one timed step after two)."""
    dev = torch.device(DEVICE)
    out = {}
    s2_data = {k: torch.from_numpy(v).to(dev)
               for k, v in stage2_data(S2_BATCH, 51).items()}
    attn_batch = {k: torch.from_numpy(v).to(dev) for k, v in
                  _attn_train_batch(ds, ATTN_TRAIN_BATCH, 51).items()}
    g_sd, d_sds, e_sd, i_sd = attn_weights
    mcfg = attngan_model_config(cfg_from_file(ATTN_TRAIN_CFG,
                                              "coco-attngan"))
    for mode in ("0", "full"):
        s1, s2 = stage2_cfgs()
        g1 = build_stage1_g(s1, seed=0, device=dev)
        state = create_state_stage2(s2, seed=0, device=dev)
        with _scoped_env({"MOG_REMAT": mode}):
            step = make_stage2_train_step(s2, s1, g1, KL_COEFF)
        gen = torch.Generator(device=dev).manual_seed(0)
        ms, peak, per_step = _timed_steps(
            lambda: step(state, s2_data, gen, LR, LR), 1)
        out[f"stage2_{mode}"] = {"ms": ms, "peak_gib": peak,
                                 "launches_per_step": per_step}
        del g1, state, step
        torch.cuda.empty_cache()
        state, text, image = _attn_nets(dev, mcfg, g_sd, d_sds, ATTN_WORDS,
                                        e_sd, i_sd)
        with _scoped_env({"MOG_REMAT": mode}):
            step = make_attngan_train_step(mcfg, text, image)
        ms, peak, per_step = _timed_steps(
            lambda: step(state, attn_batch, gen, LR, LR), 1)
        out[f"attngan_{mode}"] = {"ms": ms, "peak_gib": peak,
                                  "launches_per_step": per_step}
        del state, text, image, step
        torch.cuda.empty_cache()
    for name, row in out.items():
        log(f"  {name.replace('_', ' step, MOG_REMAT=')} f32: {row['ms']:.2f}"
            f" ms (CUDA events, one step after two), peak memory "
            f"{row['peak_gib']:.2f} GiB, K1/K2 a step "
            f"{row['launches_per_step']}")
    return out


def _span_case():
    """The mnist step case at SPAN_GROUPS BatchNorm groups of a global
    batch of SPAN_BATCH, from warm Adams, and its state before the step.
    Phase 48's ranks run it (one start for both phases)."""
    cfg = dataclasses.replace(MNIST, bn_groups=SPAN_GROUPS)
    state = create_state(cfg, seed=0, device="cpu")
    randomize(state.g, 3)
    randomize(state.d, 11)
    warm_adam(state)
    pre = copy.deepcopy(state.checkpoint_dict())
    return ({"name": "span", "kind": "stage1", "config": cfg,
             "state": state,
             "batch": {k: torch.from_numpy(v) for k, v in
                       synthetic_multimnist(SPAN_BATCH, seed=51).items()},
             "seed": 51, "lr": LR}, pre)


def _span_groups(span):
    """The world-2 mnist step at SPAN_GROUPS BatchNorm groups of a global
    batch of SPAN_BATCH (a group spans the two ranks; phase 48's ranks ran
    it, ``span``) against one process at the same groups, from warm Adams,
    held at phase 48's limits."""
    pre, ranks = span["pre"], span["ranks"]
    want = dist_steps.run_cases(
        torch.load(span["cases"], weights_only=False), DEVICE)["span"]
    os.remove(span["cases"])
    got = ranks
    bad = [k for k, v in want["metrics"].items()
           if abs(got[0]["metrics"][k] - v)
           > DIST_LOSS_ATOL + DIST_LOSS_RTOL * abs(v)]
    loss_rel = max(abs(got[0]["metrics"][k] - v) / max(abs(v), 1e-12)
                   for k, v in want["metrics"].items())
    stats, cos, worst = _state_gaps(pre, got[0]["state"], want["state"])
    same = _same_bits(got[0]["state"], got[1]["state"])
    log(f"  --bn_groups {SPAN_GROUPS} over {DIST_WORLD} ranks "
        f"({span['backend']}; phase 48's ranks), global batch {SPAN_BATCH}: "
        "worst loss "
        f"gap {loss_rel:.2e} of the loss (limit {DIST_LOSS_ATOL:g} + "
        f"{DIST_LOSS_RTOL:g} of it); running statistics {stats:.3e} (atol "
        f"{STATS_ATOL:g}); lowest update cosine {cos:.8f} ({worst}; limit "
        f"{DIST_MIN_UPDATE_COSINE:g}); replicas equal bit for bit: {same}; "
        f"K1/K2 a rank {[r['launches'] for r in got]} (one process "
        f"{want['launches']})")
    failed = [msg for ok, msg in (
        (same, "the replicas differ after the step"),
        (not bad, f"losses world 2 vs world 1 {bad}"),
        (stats <= STATS_ATOL, f"running statistics {stats}"),
        (cos > DIST_MIN_UPDATE_COSINE, f"update {worst} {cos}"),
        (all(r["launches"] == (4, 4) for r in got),
         f"launches a rank {[r['launches'] for r in got]}")) if not ok]
    check(not failed, "; ".join(failed))
    return ({f"span_g{SPAN_GROUPS}_rank{r}": got[r]["launches"]
             for r in range(DIST_WORLD)},
            {"loss_rel": loss_rel, "stats": stats, "update_cosine": cos})


def _serve_max_batch():
    """The trained mnist G served at each ``--max_batch`` of
    SERVE_MAX_BATCHES: /healthz, a request of max_batch items in one
    device batch (content in its boxes), one more item refused with a
    400; K1 at the device batch's shape held and timed."""
    rs = np.random.RandomState(51)
    launches, rows, worst = {}, {}, 0.0
    dev = torch.device(DEVICE)
    for mb in SERVE_MAX_BATCHES:
        httpd = serve(serve_parse_args(
            ["--variant", "multi-mnist", "--net_g", CKPT, "--device", DEVICE,
             "--port", "0", "--max_batch", str(mb)]))
        k1.reset_launch_count()
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        port = httpd.server_address[1]
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("GET", "/healthz")
            health = json.loads(conn.getresponse().read())
            conn.close()
            items, boxes = [], []
            for _ in range(mb):
                n = int(rs.randint(1, 4))
                w, h = rs.uniform(0.25, 0.4, n), rs.uniform(0.25, 0.4, n)
                bb = np.stack([rs.uniform(0, 1 - w), rs.uniform(0, 1 - h),
                               w, h], -1).round(4).tolist()
                items.append({"labels": rs.randint(0, 10, n).tolist(),
                              "bboxes": bb})
                boxes.append(bb)
            t = time.perf_counter()
            status, body = _post(port, {"items": items})
            latency_ms = (time.perf_counter() - t) * 1e3
            over, refused = _post(port, {"items": items + [{}]})
            fill = httpd.batcher.snapshot()["avg_batch_fill"]
        finally:
            httpd.shutdown()
            httpd.server_close()
            httpd.batcher.close()
            thread.join(timeout=30)
        launches[f"serve_max_batch_{mb}"] = (k1.launch_count(),
                                             k1.grad_launch_count())
        check(health["max_batch"] == mb, f"/healthz {health}")
        check(status == 200 and len(body["images"]) == mb,
              f"{mb}-item request: {status}")
        sep = [np.subtract(*_separation(_png_gray64(b)[None], [bb]))
               for b, bb in zip(body["images"], boxes)]
        check(float(np.mean(sep)) > MIN_SEPARATION,
              f"max_batch {mb}: content not in the boxes")
        check(over == 400 and refused["error"]
              == f"at most {mb} items per request", f"{mb + 1} items: "
              f"{over} {refused}")
        check(fill == mb, f"avg_batch_fill {fill} != {mb}")
        check(launches[f"serve_max_batch_{mb}"] == (1, 0),
              f"K1/K2 launches {launches[f'serve_max_batch_{mb}']} for one "
              "device batch")
        feats = torch.from_numpy(rs.randn(mb, 3, 256, 16, 16).astype(
            np.float32)).to(dev)
        bbox = torch.from_numpy(_service_boxes(rs, mb, 3)).to(dev)
        worst = max(worst, _held(
            k1.stn_place_multi_nchw(feats, bbox, (16, 16)),
            k1.stn_place_multi_plain(feats, bbox, (16, 16)), torch.float32,
            "K1", f"serve_b{mb} {tuple(feats.shape)} -> (16, 16)"))
        rows[f"serve_b{mb}"] = time_place(feats, bbox, (16, 16),
                                          f"K1 at --max_batch {mb}")
        rows[f"serve_b{mb}"]["latency_ms"] = latency_ms
        log(f"  --max_batch {mb}: /healthz {health['max_batch']}; a "
            f"{mb}-item request {latency_ms:.1f} ms end to end (host clock)"
            f", one device batch (avg_batch_fill {fill:g}), separation mean "
            f"{np.mean(sep):.3f}; {mb + 1} items: {over} "
            f"({refused['error']!r}); K1/K2 launches "
            f"{launches[f'serve_max_batch_{mb}']}")
    return launches, rows, worst


def phase_options(attn_weights, dist2):
    log("phase 51/52 options: MOG_REMAT's four modes in the mnist f32 step "
        "(each against mode 0) and peak memory at 0 and full for stage 2 "
        "and AttnGAN; --bn_groups 3 over two ranks against one process; "
        "serving at --max_batch 8 and 128 with K1 at both batches")
    with float32_pinned():
        remat_rows, launches = _remat_mnist()
        _, ds = _attn_set()
        peaks = _remat_peaks(attn_weights, ds)
        span_launches, span = _span_groups(dist2["span"])
        serve_launches, places, worst = _serve_max_batch()
    launches.update(span_launches)
    launches.update(serve_launches)
    SUMMARY["remat"] = {m: {"ms": remat_rows[m]["ms"],
                            "gib": remat_rows[m]["peak_gib"]}
                        for m in REMAT_MODES}
    SUMMARY["remat"].update({k: {"ms": v["ms"], "gib": v["peak_gib"]}
                             for k, v in peaks.items()})
    SUMMARY["span"] = {"loss_rel": span["loss_rel"],
                       "cos": span["update_cosine"]}
    SUMMARY["serve_mb"] = {k: {"ms": v["ms"], "graph_ms": v["graph_ms"],
                               "lat_ms": v["latency_ms"]}
                           for k, v in places.items()}
    return launches, {"max_abs_err": worst, **places, "remat": remat_rows,
                      "remat_peaks": peaks, "span": span}


# ------------------------------------------------------------ the bench tools

# the tools' timed calls here (half their defaults: 20 steps, 40 and 20
# batches)
BENCH_STEPS = 10
BENCH_BATCHES = 20
BENCH_ATTN_BATCHES = 10
BENCH_MAX_MFU = 1.05        # mfu above the dense peak by more is a fault
BENCH_VARIANT_KEYS = {"variant", "batch", "step_ms", "img_per_sec",
                      "tflops_per_step", "gbytes_per_step", "mfu",
                      "hbm_util", "bound"}   # JAX tools/bench_variants.py
BENCH_SAMPLING_KEYS = {"variant", "batch", "bf16", "ms_per_batch",
                       "img_per_sec"}        # JAX tools/bench_sampling.py
# K1/K2 launches a step (bench_variants) or a batch (bench_sampling)
BENCH_LAUNCHES = {"mnist": (4, 4), "clevr": (4, 4), "stackgan1": (4, 4),
                  "stage2": S2_LAUNCHES, "attngan": ATTN_LAUNCHES,
                  "sampling": (1, 0)}
BENCH_ATTN_SHAPE = (bench_sampling.ATTN_BATCH, 3, 192, 16, 16)
ENV_KNOBS = {"MOG_COMPUTE_DTYPE": "bfloat16", "MOG_BN_GROUPS": "2"}


def _rounding_ok(line, ms_key):
    """img_per_sec equals batch / ms to their rounding (0.1 and 0.01)."""
    b, ms = line["batch"], line[ms_key]
    return abs(line["img_per_sec"] - b * 1e3 / ms) <= (
        0.05 + b * 1e3 * 0.005 / ms ** 2 + 1e-9)


def _bench_run(label, fn, calls, per_call):
    """``fn()`` with the launch counts reset before; checks that K1 and
    K2 launched ``per_call`` times each of its ``calls`` calls; returns
    (its JSON line, the launches)."""
    k1.reset_launch_count()
    line = fn()
    torch.cuda.synchronize()
    got = (k1.launch_count(), k1.grad_launch_count())
    want = tuple(calls * n for n in per_call)
    print(json.dumps(line), flush=True)
    log(f"  {label}: K1/K2 {got} over {calls} calls (expected {want})")
    check(got == want, f"{label}: K1/K2 launched {got}, expected {want}")
    return line, got


def _bench_places():
    """K1 at attngan256's place, (32,3,192,16²) -> 16² with the tool's
    boxes, bf16 (its dtype) and f32, held against its plain version and
    timed."""
    rs = np.random.RandomState(52)
    bbox = torch.from_numpy(np.tile(bench_variants.BOX, (
        BENCH_ATTN_SHAPE[0], BENCH_ATTN_SHAPE[1], 1)).astype(
            np.float32)).to(DEVICE)
    feats = torch.from_numpy(rs.randn(*BENCH_ATTN_SHAPE).astype(
        np.float32)).to(DEVICE)
    rows, worst = {}, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        f = feats.to(dtype)
        label = f"bench attngan256 {tuple(f.shape)} {str(dtype)[6:]}"
        err = _held(k1.stn_place_multi_nchw(f, bbox, (16, 16)),
                    k1.stn_place_multi_plain(f, bbox, (16, 16)), dtype, "K1",
                    label)
        if dtype == torch.float32:
            worst = err
        row = time_place(f, bbox, (16, 16), f"K1 {label}")
        rows[f"attngan256_{str(dtype)[6:]}"] = {
            "shape": list(f.shape), **{k: row[k] for k in (
                "ms", "plain_ms", "graph_ms", "bound_ms", "bound_by",
                "share_of_bound", "graph_share_of_bound")}}
    return rows, worst


def _env_knob_step():
    """The mnist step whose config the train entry's argument parsing
    gives under MOG_COMPUTE_DTYPE=bfloat16 and MOG_BN_GROUPS=2 without
    flags, against the step under --bf16 --bn_groups 2: one state, one
    batch, one noise draw, cudnn.deterministic; bit for bit. Returns the
    launches of the two steps."""
    argv = ["--variant", "multi-mnist", "--cfg", MNIST_TRAIN]
    flagged = train_main.parse_args([*argv, "--bf16", "--bn_groups", "2"])
    before = {k: os.environ.get(k) for k in ENV_KNOBS}
    with _scoped_env(ENV_KNOBS):
        from_env = train_main.parse_args(argv)
    check({k: os.environ.get(k) for k in ENV_KNOBS} == before,
          "the environment was not restored")
    knobs = [train_main.model_knobs(a) for a in (flagged, from_env)]
    log(f"  the entry's knobs: flags {knobs[0]}, env {knobs[1]}")
    check(knobs[0] == knobs[1] == {"compute_dtype": torch.bfloat16,
                                   "bn_groups": 2},
          f"the env knobs parse to {knobs[1]}, the flags to {knobs[0]}")
    cfg = cfg_from_file(MNIST_TRAIN, "multi-mnist")
    data = {k: torch.from_numpy(v).to(DEVICE) for k, v in
            synthetic_multimnist(STEP_BATCH, seed=52).items()}
    start, results = None, []
    k1.reset_launch_count()
    with _cudnn_deterministic():
        for k in knobs:
            mcfg = stage1_model_config(cfg, "multi-mnist", **k)
            if start is None:
                state = create_state(mcfg, seed=52, device=DEVICE)
                start = ({n: v.clone() for n, v in
                          state.g.state_dict().items()},
                         {n: v.clone() for n, v in
                          state.d.state_dict().items()})
            else:
                state = create_state(mcfg, device=DEVICE,
                                     g_state_dict=start[0],
                                     d_state_dict=start[1])
            gen = torch.Generator(device=DEVICE).manual_seed(52)
            metrics = make_train_step(mcfg)(state, data, gen, LR, LR)
            results.append((metrics, {**state.g.state_dict(),
                                      **state.d.state_dict()}))
    torch.cuda.synchronize()
    launches = (k1.launch_count(), k1.grad_launch_count())
    (m0, s0), (m1, s1) = results
    differ = [k for k in m0 if not torch.equal(m0[k], m1[k])] + [
        k for k in s0 if not torch.equal(s0[k], s1[k])]
    log(f"  mnist bf16 step at batch {STEP_BATCH}, 2 groups, from the env "
        f"against the flags (cudnn.deterministic): {len(m0)} losses and "
        f"{len(s0)} state tensors, {len(differ)} differing; K1/K2 "
        f"{launches}")
    check(not differ, f"the env step differs from the flag step: "
          f"{differ[:5]}")
    check(launches == (8, 8), f"the two steps launched K1/K2 {launches}")
    return launches


def phase_bench():
    log("phase 52/52 bench: the port's bench tools in-process at full "
        "width, bf16: bench_variants (mnist, clevr, stackgan1 at 128, "
        "stage 2 at 40, AttnGAN at 14; the H100's roofline) and "
        "bench_sampling (mnist, clevr, stackgan1 at 128, attngan256 at "
        "32), their keys, rounding, mfu and K1/K2 launches; K1 at "
        "attngan256's place held and timed; an mnist step under "
        "MOG_COMPUTE_DTYPE/MOG_BN_GROUPS against the flags' step")
    launches, lines = {}, {"variants": {}, "sampling": {}}
    for name, fn in bench_variants.BENCHES.items():
        line, launches[f"bench_variants_{name}"] = _bench_run(
            f"bench_variants {name}", lambda: fn(device=DEVICE,
                                                 n=BENCH_STEPS),
            BENCH_STEPS + bench_variants.WARMUP + 1, BENCH_LAUNCHES[name])
        check(set(line) == BENCH_VARIANT_KEYS, f"{name}: keys {sorted(line)}")
        check(_rounding_ok(line, "step_ms"), f"{name}: img_per_sec "
              f"{line['img_per_sec']} is not batch / step_ms")
        check(None not in (line["mfu"], line["hbm_util"])
              and 0 < line["mfu"] <= BENCH_MAX_MFU and line["hbm_util"] > 0,
              f"{name}: mfu {line['mfu']}, hbm_util {line['hbm_util']}")
        lines["variants"][name] = line
    for name in (*bench_sampling.VARIANTS, "attngan"):
        if name == "attngan":
            n = BENCH_ATTN_BATCHES

            def fn():
                return bench_sampling.bench_attngan(True, device=DEVICE,
                                                    n=BENCH_ATTN_BATCHES)
        else:
            n = BENCH_BATCHES

            def fn(name=name):
                return bench_sampling.bench_variant(name, True,
                                                    device=DEVICE,
                                                    n=BENCH_BATCHES)
        line, got = _bench_run(f"bench_sampling {name}", fn,
                               n + bench_variants.WARMUP,
                               BENCH_LAUNCHES["sampling"])
        launches[f"bench_sampling_{line['variant']}"] = got
        check(set(line) == BENCH_SAMPLING_KEYS and line["bf16"] is True,
              f"sampling {name}: {line}")
        check(_rounding_ok(line, "ms_per_batch"), f"sampling {name}: "
              f"img_per_sec {line['img_per_sec']} is not batch / ms")
        lines["sampling"][line["variant"]] = line
    places, worst = _bench_places()
    launches["bench_env_knobs"] = _env_knob_step()
    SUMMARY["bench"] = {
        "step": {k: {"ms": v["step_ms"], "mfu": v["mfu"]}
                 for k, v in lines["variants"].items()},
        "sample_ms": {k: v["ms_per_batch"]
                      for k, v in lines["sampling"].items()}}
    return launches, {"max_abs_err": worst, **places, "lines": lines}


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/generate", body=json.dumps(body))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    global WORK
    WORK = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run_phases()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


PHASE_S: dict = {}          # each phase's wall time, host clock
# each phase's phase_s in a full run on the card (PERF.md §6), the base of
# its watchdog deadline: max(PHASE_MIN_DEADLINE_S, 2 x this)
PHASE_BUDGET_S = {
    "device": 0.1, "build": 7.8, "kernel": 6.5, "model": 2.9, "serve": 2,
    "grad": 1.6, "autograd": 11.9, "step": 28.8, "steptime": 2.2,
    "train": 2.4, "normconv": 0.9, "bf16": 6.6, "step16": 21.4, "time16": 1.7,
    "entry16": 3.2, "families": 19.4, "fstep": 23.5, "ftime": 6.9,
    "fentry": 4.4, "fserve": 6.7, "probe": 0.2, "disk": 24.2, "batch9": 1,
    "sample": 2.4, "s2kernels": 13.7, "s2step": 37.9, "s2time": 14,
    "s2entry": 18.2, "s2serve": 7, "attnkernels": 2.1, "attnmodel": 25,
    "attnserve": 5.1, "attnplaces": 2.7, "attnstep": 31.1, "attntime": 26.8,
    "attnentry": 48.9, "damsmstep": 2.8, "damsmtime": 5.8, "damsmentry": 13.1,
    "attneval": 11.3, "jpeg": 4.2, "cocodisk": 33.2, "s2sample": 51.3,
    "fid": 4.8, "sampling": 28.2, "layout": 16.8, "nccl1": 23.5,
    "dist2": 114.3, "dump2": 0.5, "validate": 156.6, "options": 31.6,
    "bench": 29
}
PHASE_MIN_DEADLINE_S = 120
PHASE_OVERRUN_RC = 70       # the exit code of a phase past its deadline
# faulthandler's own dump and exit this long after the deadline, should
# the watchdog thread not get the interpreter lock
BACKSTOP_S = 60


def _descendants(pid: int) -> list:
    """The pids of every living descendant of ``pid`` (from /proc)."""
    children: dict = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        children.setdefault(ppid, []).append(int(entry))
    found, todo = [], [pid]
    while todo:
        for child in children.get(todo.pop(), []):
            found.append(child)
            todo.append(child)
    return found


def _overrun(name: str, deadline: float) -> None:
    """A phase ran past its deadline: every thread's stack to stderr, the
    processes this script started killed, exit PHASE_OVERRUN_RC."""
    print(f"chip_smoke: phase {name} overran its deadline of "
          f"{deadline:.0f} s; every thread's stack follows", file=sys.stderr,
          flush=True)
    faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
    for pid in _descendants(os.getpid()):
        with contextlib.suppress(OSError):
            os.kill(pid, signal.SIGKILL)
    print(f"chip_smoke: FAILED: phase {name} overran its deadline",
          file=sys.stderr, flush=True)
    if WORK:
        shutil.rmtree(WORK, ignore_errors=True)
    os._exit(PHASE_OVERRUN_RC)


def timed(name, fn, *args):
    """``fn(*args)``, its wall time kept under ``name`` for the summary,
    under a watchdog: past max(PHASE_MIN_DEADLINE_S, 2 x its
    PHASE_BUDGET_S) the script dumps every thread's stack and exits
    non-zero naming the phase (:func:`_overrun`)."""
    deadline = max(PHASE_MIN_DEADLINE_S, 2 * PHASE_BUDGET_S[name])
    watchdog = threading.Timer(deadline, _overrun, (name, deadline))
    watchdog.daemon = True
    t = time.perf_counter()
    watchdog.start()
    faulthandler.dump_traceback_later(deadline + BACKSTOP_S, exit=True)
    try:
        return fn(*args)
    finally:
        faulthandler.cancel_dump_traceback_later()
        watchdog.cancel()
        PHASE_S[name] = round(time.perf_counter() - t, 1)


def _rounded(x):
    """``x`` with every float rounded to 4 decimals (the summary line)."""
    if isinstance(x, float):
        return round(x, 4)
    if isinstance(x, dict):
        return {k: _rounded(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_rounded(v) for v in x]
    return x


def _ms(rows):
    return {k: round(v["ms"], 3) for k, v in rows.items()}


def _compact(row):
    """A timed row's numbers for the kernels line."""
    return {k: row[k] for k in ("ms", "plain_ms", "graph_ms", "bound_ms",
                                "bound_by") if k in row}


def _nested(rows, prefix):
    """{dtype: {path: row}} -> {prefix_path_dtype: compact row}."""
    return {f"{prefix}_{path}_{dtype}": _compact(row)
            for dtype, by_path in rows.items() if isinstance(by_path, dict)
            for path, row in by_path.items()}


def run_phases() -> int:
    name = timed("device", phase_device)
    timed("build", phase_build)
    place = timed("kernel", phase_kernel)
    timed("model", phase_model)
    serve_launches, _ = timed("serve", phase_serve)
    grad = timed("grad", phase_grad_kernel)
    timed("autograd", phase_autograd)
    timed("step", phase_step)
    step32 = timed("steptime", phase_step_time)
    train_launches = timed("train", phase_train_entry)
    normconv = timed("normconv", phase_normconv)
    bf16 = timed("bf16", phase_bf16_kernels)
    timed("step16", phase_step_bf16)
    step16 = timed("time16", phase_step_time, BF16, "14/52 time16")
    log(f"bf16 step {step16['ms']:.2f} ms ({step16['images_per_s']:.0f} "
        f"images/s, peak {step16['peak_gib']:.2f} GiB) beside float32 "
        f"{step32['ms']:.2f} ms ({step32['images_per_s']:.0f} images/s, peak "
        f"{step32['peak_gib']:.2f} GiB): {step32['ms'] / step16['ms']:.2f}x")
    entry16, _ = timed("entry16", phase_entry_bf16)
    families = timed("families", phase_family_kernels)
    timed("fstep", phase_family_step)
    f_time = timed("ftime", phase_family_step_time)
    fentry = timed("fentry", phase_family_entry)
    fserve, _ = timed("fserve", phase_family_serve)
    timed("probe", phase_probe)
    disk = timed("disk", phase_train_disk)
    batch9 = timed("batch9", phase_k1_batch9)
    sampled = timed("sample", phase_sample, disk["clevr_run"],
                    disk["clevr_data"])
    s2_kernels = timed("s2kernels", phase_stage2_kernels)
    timed("s2step", phase_stage2_step)
    s2_time = timed("s2time", phase_stage2_step_time)
    s2_entry, s2_run = timed("s2entry", phase_stage2_entry)
    s2_serve, _ = timed("s2serve", phase_stage2_serve)
    attn_kernels = timed("attnkernels", phase_attn_kernels)
    attn_model = timed("attnmodel", phase_attn_model)
    attn_serve, attn_latency = timed("attnserve", phase_attn_serve,
                                     attn_model)
    attn_places = timed("attnplaces", phase_attn_train_kernels)
    attn_step = timed("attnstep", phase_attn_step)
    attn_time = timed("attntime", phase_attn_step_time, attn_step)
    attn_entry, attn_run = timed("attnentry", phase_attn_entry)
    timed("damsmstep", phase_damsm_step)
    damsm_time = timed("damsmtime", phase_damsm_step_time)
    damsm_entry, _ = timed("damsmentry", phase_damsm_entry,
                           attn_step["weights"])
    attn_eval_paths, attn_eval = timed("attneval", phase_attn_eval,
                                       attn_model)
    jpeg_result = timed("jpeg", phase_jpeg)
    coco_disk = timed("cocodisk", phase_coco_disk, attn_step["weights"])
    s2_sample_paths, s2_sample = timed("s2sample", phase_stage2_sample,
                                       s2_run)
    fid = timed("fid", phase_fid, attn_model)
    sampling_paths, sampling = timed("sampling", phase_sampling, attn_model,
                                     fid)
    layout_paths, layout = timed("layout", phase_layout, disk["clevr_run"])
    timed("nccl1", phase_dist_entry)
    dist_paths, dist2 = timed("dist2", phase_dist_steps, attn_step["weights"],
                              sampling)
    dump_paths, dump2 = timed("dump2", phase_dist_sampling, sampling, dist2)
    validate_paths, validate = timed("validate", phase_validate)
    options_paths, options = timed("options", phase_options,
                                   attn_step["weights"], dist2)
    bench_paths, bench = timed("bench", phase_bench)
    log("all phases passed")
    by_path = {"serve": serve_launches, "train": train_launches, **entry16,
               **fentry, **fserve, **disk["launches"],
               **sampled["launches"], **s2_entry, **s2_serve, **attn_serve,
               **attn_entry, **damsm_entry, **attn_eval_paths,
               **s2_sample_paths, **sampling_paths, **layout_paths,
               **dist_paths, **dump_paths, **validate_paths,
               **options_paths, **bench_paths}
    f32_paths = ("serve", "train", "train_bn_groups_2", "train_clevr",
                 "serve_clevr", "serve_coco-stackgan-1", *disk["launches"],
                 *sampled["launches"], *s2_entry, *s2_serve, *attn_serve,
                 "train_coco-attngan", "train_coco-attngan_resume",
                 "train_damsm", "train_damsm_resume", *attn_eval_paths,
                 *s2_sample_paths, *sampling_paths, *layout_paths,
                 *dist_paths, *dump_paths, "parity_harness",
                 *options_paths)
    # the validate tool's runs are --bf16, its default; the bench tools'
    # and the env-knob steps bf16
    bf16_paths = ("serve_bf16", "train_bf16", "train_coco_bf16",
                  "train_coco-attngan_bf16", "train_damsm_bf16",
                  *(p for p in validate_paths if p.startswith("validate_")),
                  *bench_paths)

    def launches(i):
        return {"launches": sum(v[i] for v in by_path.values()),
                "launches_f32": sum(by_path[p][i] for p in f32_paths),
                "launches_bf16": sum(by_path[p][i] for p in bf16_paths),
                "launches_by_path": {p: v[i] for p, v in by_path.items()}}

    hot = normconv["rows"][0]
    k4_paths = {"spike_tool": normconv["launches"],
                **{p: v[2] for p, v in by_path.items() if len(v) > 2}}
    # the kernels' full readings, beside the compact kernels line below
    print(json.dumps({"kernel_details": {
        "stn_place_multi": {
            **place, "bf16": bf16["place"], "families": families["place"],
            "batch9": batch9, "stage2": s2_kernels["place"],
            "attngan": {**attn_kernels, "forward_b64": attn_model["rows"],
                        "gflop_per_image": attn_model["flops"],
                        "serve": attn_latency},
            "attngan_train": {**attn_places["place"], "entry": attn_run},
            "attngan_eval": attn_eval, "stage2_sample": s2_sample,
            "attngan_sampling": sampling, "layout_tool": layout,
            "validate_tool": validate, "options": options,
            "bench_tools": bench,
            "world2": {"steps": dist2["rows"], "backend": dist2["backend"],
                       "places": dist2["places"]["place"],
                       "dump": dump2}},
        "stn_place_multi_grad": {
            **grad, "bf16": bf16["grad"], "families": families["grad"],
            "stage2": s2_kernels["grad"],
            "attngan_train": attn_places["grad"],
            "world2": dist2["places"]["grad"]},
        "normconv_bf16": normconv["rows"],
        "jpeg": jpeg_result, "cocodisk": coco_disk,
        "fid": fid["rows"]}}, default=str),
        flush=True)
    steps = {"mnist": {"f32": step32["ms"], "bf16": step16["ms"]},
             **{k.replace(" ", "_"): v["ms"] for k, v in f_time.items()},
             "stage2": _ms(s2_time), "attngan": _ms(attn_time),
             "damsm": _ms(damsm_time)}
    summary = {"summary": {
        "device": name, "step_ms": steps, **SUMMARY, "phase_s": PHASE_S,
        "total_s": round(time.perf_counter() - T0, 1)}}
    line = json.dumps(_rounded(summary), separators=(",", ":"))
    check(len(line) < 4096, f"the summary line is {len(line)} bytes")
    print(line, flush=True)
    cuda = {"route": "cuda",
            "source": "multiple_objects_gan_tpu_torch/csrc/stn_place.cu",
            "library_ms": None}
    print(json.dumps({"kernels": [{
        "name": "stn_place_multi", **cuda,
        "replaces": "multiple_objects_gan_tpu/ops/stn_pallas.py:79",
        "redesigned": "PR 9",
        **launches(0),
        "max_abs_err": max(place["max_abs_err"],
                           families["place"]["max_abs_err"],
                           batch9["max_abs_err"],
                           s2_kernels["place"]["max_abs_err"],
                           attn_kernels["max_abs_err"],
                           attn_places["place"]["max_abs_err"],
                           attn_eval["max_abs_err"],
                           s2_sample["max_abs_err"],
                           sampling["max_abs_err"], layout["max_abs_err"],
                           dist2["places"]["max_abs_err"]["place"],
                           validate["max_abs_err"], options["max_abs_err"],
                           bench["max_abs_err"]),
        **_compact(place["serve"]),
        "shapes": {"train_g": _compact(place["train G"]),
                   "train_d": _compact(place["train D"]),
                   **_nested(s2_kernels["place"], "stage2"),
                   **{f"stage2_sample_{k}": _compact(s2_sample[k])
                      for k in S2_SAMPLE_SHAPES},
                   **{f"attngan_eval_{k}": _compact(attn_eval[k])
                      for k in ("sample", "gen_example")},
                   "attngan_sampling": _compact(sampling),
                   **{f"layout_{k}": _compact(layout[k])
                      for k in ("mnist", "clevr")},
                   **{k: _compact(v)
                      for k, v in dist2["places"]["place"].items()},
                   **{f"validate_gen_{k}": _compact(validate[k])
                      for k in ("mnist_float32", "mnist_bfloat16",
                                "clevr_float32", "clevr_bfloat16")},
                   **{k: _compact(options[k])
                      for k in (f"serve_b{b}" for b in SERVE_MAX_BATCHES)},
                   **{f"bench_{k}": _compact(bench[k])
                      for k in ("attngan256_float32",
                                "attngan256_bfloat16")}},
    }, {
        "name": "stn_place_multi_grad", **cuda,
        "replaces": "multiple_objects_gan_tpu/ops/stn_pallas.py:137",
        "redesigned": "PR 8",
        **launches(1),
        "max_abs_err": max(grad["max_abs_err"],
                           families["grad"]["max_abs_err"],
                           s2_kernels["grad"]["max_abs_err"],
                           attn_places["grad"]["max_abs_err"],
                           dist2["places"]["max_abs_err"]["grad"]),
        **_compact(grad["G"]),
        "shapes": {"train_d": _compact(grad["D"]),
                   **_nested(s2_kernels["grad"], "stage2"),
                   **{k: _compact(v)
                      for k, v in dist2["places"]["grad"].items()}},
    }, {
        "name": "normconv_bf16", "route": "cuda",
        "source": "multiple_objects_gan_tpu_torch/csrc/normconv.cu",
        "replaces": "tools/spike_normconv.py:90",
        "redesigned": "PR 8",
        "launches": sum(k4_paths.values()),
        "launches_by_path": k4_paths,
        "max_abs_err": normconv["max_abs_err"],
        "shape": hot["dims"], "ms": hot["ms"], "plain_ms": hot["plain_ms"],
        "bound_ms": hot["bound_ms"], "bound_by": hot["bound_by"],
        "library_ms": hot["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
