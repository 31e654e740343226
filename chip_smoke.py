#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cpcsv_tpu_torch) on the NVIDIA GPUs of one host (one is enough).

    python3 chip_smoke.py [--seed N]

Phases, each of which exits non-zero on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from the sources in this checkout with nvcc
     into build/kernels/ (one nvcc per source, all started together), with
     their register lines;
  3. the DFN kernels, forward and backward, against their plain PyTorch
     versions on the card, in float32 and in bfloat16: every instantiation,
     B in KERNEL_BATCHES, rows aligned and one element off, the backward on
     a row-strided dout, two launches giving the same bits;
  4. story generation at full width, configs final.yml (v1) and cascade.yml,
     through the serving entry point `Infer` with random weights from --seed:
     shapes, finite values in [-1, 1], the kernels' launch counts, the same
     frames through the plain DFN (run eagerly), float32 inside the entry
     point while TF32 is allowed globally (on the eager calls and the
     captures), and a `generate_story` PNG walk; the sampler
     (`evaluation/sampling.py`): each size's first call eager and captured
     as a CUDA graph, every later call a replay, bit for bit eager
     `sample_videos` from the same generator state, a rewound generator
     reaching the replay, one DFN kernel node a graph (cuGraphGetNodes);
  5. serving timings: ms a call replayed against eager `sample_videos`,
     frames/s, device busy time and idle share from a torch.profiler
     trace of each; the card's launch floor (an empty kernel in one CUDA graph); the
     DFN forward kernel at B = 90 and 360, the main paths' batches, in one
     CUDA graph and from a trace, over the floor, beside its bound, its plain
     version and a library call;
  6. training at full width, final.yml (v1) then cascade.yml, each at
     IM_BATCH 90 / ST_BATCH 18, from `create_train_state` through
     `make_train_steps`: 2 warm-up and 5 timed D+G steps with finite metrics
     (the cascade's three G terms among them), every parameter, BN running
     statistic and SN u moved, each kernel's launches equal to the per-step
     count derived from the code times the steps, the BN calls of one step
     counted by shape, the DFN backward handed the row-strided dout of
     zmc_all's gradient with no copy, float32 inside the steps; ms per step,
     steps/s, device busy time and idle share from a trace, peak memory;
  7. for each config, from one saved state and the same noise, one D+G step
     with the kernels against one with their plain versions swapped in:
     losses, gradients and BN running statistics, within the float32
     tolerances or three times the spread of plain steps summed in other
     orders (phase 17);
  8. the BN kernels against their plain versions at every (N, C, S) either
     step gave them, at N=7 and at edge shapes, each aligned and unaligned;
     then on bfloat16 x and dy at every shape of the bfloat16 steps
     (phase 16);
  9. the BN kernels at every shape of both steps, one CUDA graph each with
     L2-cold inputs, beside their bounds, summed over each config's step by
     launches; their library calls, the plain versions and a trace at the
     largest shape; the DFN backward at B = 90 and 7 (and the op the step
     runs, on its strided dout) over the floor, and the DFN pair's time a
     step; the same at bfloat16 for the bfloat16 steps, the DFN pair at
     B = 360;
 10. the port's training CLI in this process at full width: cascade.yml
     --synthetic 36 for one epoch, then --continue_ckpt auto for a second
     under a trace, in build/chip_smoke_cli/: the auto-resume, the
     checkpoints, last_epoch.txt, metrics.jsonl (finite, the JAX package's
     cascade tags), the sample grids, the launches against the steps run;
     frames/s, the idle share of the traced epoch's steps, checkpoint write
     seconds;
 11. a procedural Pororo tree of DISK_EPISODES (16) episodes written by the
     port's writer into a temporary directory under build/, and cascade.yml
     --data_dir on it through the CLI for one epoch of 11 steps: the launches, finite
     metrics under the cascade tags, the snapshots of epochs 0 and 1; the
     epoch's frames/s, the ms a pair against phase 6's step (at the
     shipped SCAN_STEPS the epoch is one chunk of 11 pairs: an eager pair,
     the capture, then replays), the first-batch wait, the loader's host
     time a batch, the idle share of the traced chunk;
 12. --eval_fid 1, --eval_ssim 1 and --load_ckpt 1 through the CLI on that
     run's final snapshot (the epoch-0 one, of the same state, removed): a
     CSV row a snapshot, finite and tagged random-init;
     the numbered PNGs; the DFN launches, the sampler's replays among the
     calls (as in 13, 14 and 28); TF32 off inside the extractors;
     each backbone on the card against the CPU; seconds a checkpoint by part
     (generation and PNG writing, PNG reading, Inception, R(2+1)D, the host
     statistics and Frechet); the walk's Frechet distances again by the
     eigenvalues of C1 C2 (`frechet_by_eigenvalues`, as phases 14 and 34
     take theirs), within 1e-6 of the covariances' traces;
 13. --eval_fvd 1 twice and --eval_is 1 through the CLI on that run: FVD
     first with no I3D weights (the R(2+1)D fallback), then with a seeded
     random I3D state_dict written as i3d_kinetics400.pth where
     $CPCSV_METRIC_WEIGHTS_DIR points (I3D at 224 x 224 x 10 through the
     file loader): a CSV row a snapshot, newest first, the backbone and the
     tags, the warnings, the DFN launches, TF32 off; I3D and the IS
     classifier on the card against the CPU; seconds a checkpoint by part;
 14. rehearsal.yml (cascade.yml's widths, the in-training FID/FSD every
     epoch, its Frechet distances by the eigenvalues of C1 C2, which phase 12
     holds against the product's sqrtm) --synthetic 36 --max_epoch 2 through
     the CLI in a temporary working directory: finite Evaluation/fid and Evaluation/vfid each
     epoch, the extractors built once, the real side's .cache/ statistics
     written in epoch 0 and read in epoch 1, a snapshot every epoch, the
     launches, epoch 1's grid and hook replaying epoch 0's sampler graphs;
     the hook's seconds and share of the epoch, the host Frechet apart;
 15. (after 5) story generation at COMPUTE_DTYPE bfloat16, throughput.yml
     (v1) and procedural.yml (cascade), through `Infer` at 18 and 72
     stories: float32 numpy frames finite in [-1, 1], the DFN launches, the
     replays bit for bit eager as phase 4's, timed as phase 5's; a
     call of 72 stories under each FUSED_UPSAMPLE, whose frames' spread is
     the yardstick of the relative L2 to the float32 frames of the same
     weights and noise and to the plain DFN's; frames/s, device busy time
     and idle share;
 16. (after 7) training at bfloat16, throughput.yml at IM_BATCH 360 /
     ST_BATCH 72 and procedural.yml at 90 / 18, as phase 6 (2 warm-up and 5
     timed D+G steps, every check of it) with frames/s; then a D+G step under
     each FUSED_UPSAMPLE;
 17. phase 7 for each bfloat16 config, against a yardstick: the plain step
     and four whose BN sums run in a seeded random order over the batch,
     the map or both, or in float64, the largest spread of any two (also
     for the VideoEncoder's and clevr.yml's float32 steps);
 18. the four lowerings side by side: ms of a serving call and of a step;
 19. (after 10) throughput.yml --synthetic 144 through the CLI, one epoch:
     the launches, finite metrics under the v1 tags, float32 checkpoints,
     frames/s;
 20. (after 14) procedural.yml --data_dir on phase 11's tree through the
     CLI, one epoch: the same under the cascade tags.
 21. the training objectives no shipped config turns on, each written as a
     YAML into a temporary directory (`VARIANTS`): final.yml with
     USE_SEQ_CONSISTENCY (the VideoEncoder, the host shuffle), USE_INFONCE
     (the B² pair head) and SEGMENT_LEARNING false, each as phases 6 and 7
     at IM_BATCH 90 / ST_BATCH 18, with frames/s;
 22. throughput.yml with USE_SEQ_CONSISTENCY at bfloat16, 360 / 72, as
     phases 16 and 17;
 23. the BN kernels at the variants' new largest maps (`NEW_BN_MAPS`)
     against their plain versions, then L2-cold in one CUDA graph beside the
     plain version, the library call and the bound;
 24. the seq-consistency variant through the CLI, 2 epochs straight, and 1
     plus an auto-resumed one whose host shuffles and metrics equal the
     straight run's; the SEGMENT_LEARNING false variant for one epoch (no
     netD_se file) and its snapshot served by `Infer`;
 25. (after 7, on final.yml's state) REMAT: one D+G step with the up blocks
     recomputed in the backward against one without, from one state and
     noise: metrics and gradients at the float32 tolerances, BN running
     statistics and num_batches_tracked bit for bit, the recompute's extra
     bn_stats launches as counted from the code, one kernel node a BN call;
     ms a step and peak memory of each;
 26. (after 25) ADAM_MU_DTYPE bfloat16: ms a step and the Adam state's bytes
     against float32, the moments' dtypes, and a bfloat16 save restored into
     float32 optimizers, cast back with the same values;
 27. clevr.yml (4-frame stories of 18-d codes and 8 labels, IM 64 / ST 16,
     gf_dim 2048) as phases 6-7 with frames/s, the BN kernels against their
     plain versions and timed at its shapes, the DFN pair at B = 64, and 16
     stories of 4 frames served through `Infer`;
 28. the CLEVR CLI (`cli/main_clevr.py`) at full width, --synthetic 64: 2
     epochs straight with CPCSV_PROFILE_DIR set (the trainer's trace of
     the second chunk at SCAN_STEPS CLEVR_SCAN, the BN and DFN kernels of
     its graph replays in it), 1 plus an auto-resumed epoch whose state and
     metrics equal the straight run's bit for bit, and its final snapshot
     walked with --eval_ssim 1;
 29. data parallelism (`cpcsv_tpu_torch/parallel/`): two gloo ranks, each a
     process of this script sharing the card, at full final.yml width and
     IM_BATCH 90 / ST_BATCH 18 a rank (180 / 36 global): one D+G step from
     one state, global batch and noise against one process on the global
     batch with the kernels, within the float32 tolerances or three times
     the reordering yardstick (phase 7's, forced on); the ranks' parameters,
     BN running statistics, SN u, Adam moments, gradients and metrics bit
     for bit; each rank's launches a step as phase 6's; its ms (gloo stages
     through the host: no speed figure);
 30. one rank in an NCCL group of one, its data group the whole world
     (the default group, as every mesh of one data group keeps): the
     collectives run, and its step equals one process's bit for bit; then
     timed as phase 6's, the difference the price of the collectives;
 31. the Pororo CLI with two gloo ranks (CPCSV_COORDINATOR,
     CPCSV_NUM_PROCESSES, CPCSV_PROCESS_ID, --backend gloo), final.yml
     --synthetic 36: 2 epochs straight, and 1 plus an auto-resumed one equal
     to them bit for bit; both ranks' metrics equal; rank 1 writes no file;
     then --eval_ssim 1 walks on rank 0 while rank 1 waits (--eval_fid
     until PR 14);
 32. a mesh with a model axis (MESH_SHAPE's other axes replicate): phase
     29's two ranks, after their step, run the same global batch and noise
     under data:1,model:2 at 90 / 18 a device, each rank the whole 180 / 36,
     bit for bit phase 29's one process (metrics, state checksums,
     gradients); then four gloo ranks under data:2,model:2 at 45 / 9 a
     device, each the data shard of phase 29's rank, bit for bit phase 29's
     two ranks; the replicas bit for bit, 95 / 64 BN launches a rank a step;
 33. (in phase 31's launch) the Pororo CLI on the two ranks under
     data:1,model:2, one epoch, against a one-process CLI run at the doubled
     batches in a process beside them: every step's metrics and the state
     bit for bit; rank 1 writes no file;
 34. the paths the CPU tests held alone before: REMAT on cascade.yml (after
     7) and at bfloat16 on throughput.yml (after 17, against phase 17's
     yardstick), as phase 25 without its timing; ADAM_MU_DTYPE bfloat16 on
     throughput.yml, one step of each and the Adam state's bytes; the CLEVR
     CLI --data_dir on a CLEVR-layout tree written into a temporary
     directory (CLEVR_DISK stories, the loaders' fixed id ranges cut to
     them), one epoch, then --eval_fid 1 on its snapshot (its Frechet
     distances by eigenvalues, as phase 14's);
 35. SCAN_STEPS, the JAX trainer's default path, which the shipped configs
     take (20; the CLI phases above run their epochs in chunks, replayed as
     CUDA graphs, the gloo ranks' eagerly): (a) final.yml, cascade.yml and
     bf16 procedural.yml through GANTrainer, 2 epochs of SCAN_PAIRS steps
     at SCAN_STEPS SCAN_PAIRS against 1, every update's metrics, every
     state tensor and the launches bit for bit; (b) the same final.yml run
     on one NCCL rank (in phase 30's launch), bit for bit (a)'s; (c) a warm
     chunk of 20 against 20 single pairs of final.yml and procedural.yml:
     ms a step, busy ms and idle share from a trace, the graph's nodes and
     the memory its capture took;
 36. (after 15) generation split over the eval mesh (`parallel/mesh.py`)
     through `Infer`: final.yml at float32 and procedural.yml at bfloat16,
     18 and 72 stories, over every local card, or cuda:0 listed twice on a
     host of one card: each block bit for bit an eager one-device call on
     its rows and noise slice, the gathered frames within 1e-4 of the
     unsplit call (bfloat16: relative L2 within three times its spread
     under another lowering), the generator left alike, DFN launches
     equal to blocks x calls, one DFN kernel node a replica's graph; ms a
     call split and unsplit, and with several cards at 1, 2 and 4 of them;
 37. training across the cards of the host, one NCCL rank a card (after
     35, the ranks spawned before it; on a host of several cards the phases
     before it but 36 run on card 0 alone, MESH_SHAPE "" read as "data:1"
     and the ranks of 29-33 shown card 0 alone, and the CLI runs among them
     start no ranks): on a host of one card, "" trains in one process and
     data:2 raises naming the visible cards; on several, final.yml at 90 /
     18 a rank on every card: (c) one D+G step against one process at the
     global batch within the float32 tolerances or three times the
     reordering yardstick, the ranks bit for bit alike; (b) a chunk of 3
     pairs replayed as a CUDA graph bit for bit the same pairs run eagerly
     on each rank (cuDNN deterministic), one NCCL kernel node in the graph
     a pair's all-reduce; (a) after warm chunks of 20, every state tensor
     bit for bit alike on every rank; (g) each rank's launches as the code
     implies; (d) with 4 cards, data:2,model:2 (two-rank NCCL data groups)
     bit for bit data:2 on 2 cards; (e) `python -m
     cpcsv_tpu_torch.cli.main_pororo --cfg cascade.yml` with no process
     group in its environment starts a rank a card, writes one run
     directory and resumes with --continue_ckpt bit for bit; (f) a rank
     killed mid-epoch ends the command non-zero within 30 s, no rank left;
     ms a step of a warm chunk of 20 of final.yml and procedural.yml on 1,
     2 and every card, frames/s, weak-scaling efficiency, all-reduces a
     step, NCCL's share of rank 0's busy time, `nvidia-smi topo -m`;
 38. training across hosts (folded into 37): on a host of one card only the
     launch rules (a host of one card runs its rank in its own process, a
     named mesh must take every card of every host, the hosts' rendezvous
     refuses unequal cards) and the host-side cost of the seq-consistency
     story shuffle over a host's stories; on an even count of 4 or more
     cards, the cards as two hosts of half of them each
     (CUDA_VISIBLE_DEVICES): NCCL ranks spawned so, rank r on physical card
     r by UUID, a D+G step bit for bit phase 37's one host, a warm chunk of
     20 of final.yml timed beside it; then 37 (e)'s one command is the
     reference of two host commands of the CLI (CPCSV_COORDINATOR at
     127.0.0.1, CPCSV_NUM_PROCESSES 2, CPCSV_PROCESS_ID 0 and 1): 1 epoch
     and an auto-resumed one whose checkpoint equals the one command's bit
     for bit (NCCL_ALGO / NCCL_PROTO pinned in both, NCCL's choice
     printed), and (f) a rank of host 1 killed mid-epoch, which ends both
     commands within 30 s; on 2-3 cards two hosts of one card each.
The line before the last is a JSON object of the kernels, with bfloat16
times, bounds, library calls and launches (`bf16_*`) beside float32's; the last is
{"ok": true, "device": {...}}. Without a CUDA device, or run outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import copy
import csv
import io
import itertools
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types
import warnings
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
STORY_SIZES = (18, 72)  # stories per call; 5 frames each
KERNEL_BATCHES = (1, 7, 90, 360, 1440)
# (K, pad): the generator's taps and K=7 (the compile-time instantiations
# of csrc/dfn.cu, with C=3), K=5 (its runtime-K kernel), and L_out != L
TAPS = ((21, 10), (7, 3), (5, 2), (21, 0))
DFN_SHAPE = (3, 124, 21, 10)  # (C, L, K, pad) of the generator's DFN
DFN_STEP_LAUNCHES = {"dfn_forward": 4, "dfn_backward": 2}  # per D+G step
# the columns of the generator's zmc_all (zm_code, c_mu, DFN output): the G
# step's DFN dout is its last 124 columns, rows ZMC_WIDTH floats apart
ZMC_WIDTH = 613
LR_D, LR_G = 4e-4, 1e-4  # final.yml's DISCRIMINATOR_LR, GENERATOR_LR (cascade.yml's too)
TRAIN_CONFIGS = ("final.yml", "cascade.yml")  # phases 6-7, in this order
BF16_CONFIGS = ("throughput.yml", "procedural.yml")  # COMPUTE_DTYPE bfloat16, phases 15-20
# phase 36: generation split over the eval mesh, a float32 and a bfloat16
# config; the bounds of the gathered frames against the unsplit call's:
# float32 in max |difference|; bfloat16 in relative L2, where a block's
# batch size picks other kernels than the whole batch's, whose other
# roundings the trunk carries as far as 8.9e-2, while a replica one Adam
# step stale (SHARD_STALE_STEP a parameter, the generator's learning rate)
# reads 0.139-0.144 and a block given another block's noise 1.06-1.14
# (PERF.md §6)
SHARD_CONFIGS = ("final.yml", "procedural.yml")
SHARD_F32_BOUND, SHARD_BF16_BOUND, SHARD_STALE_STEP = 1e-4, 0.11, 1e-4
THROUGHPUT_SYNTHETIC = 144  # phase 19's --synthetic: 2 story steps at ST_BATCH 72
CLI_SYNTHETIC = 36  # phase 10's --synthetic: 2 story steps an epoch, one image batch
SEQ_SYNTHETIC = 18  # phase 24's seq CLI: one story step an epoch
# phase 11's tree: 204 train clips (11 steps of 18 stories), 36 test stories,
# the fewest that give phase 13's FVD its 16 clips of FVD_FRAMES frames (a
# third of the writer's default 48 episodes, to keep the run short)
DISK_EPISODES = 16
DISK_TRACED = (5, 5)  # phase 11: the first of its steps under the profiler, and how many
# phase 11's one epoch leaves netG_epoch_0 and netG_epoch_1 (the final save)
# of one state; phases 12-13 walk the latter alone
WALKED = [1]
LOADER_ALONE = 4  # phase 11: batches of each loader timed with nothing else running
FVD_FRAMES = 10  # calculate_fvd's frames a clip (phase 13)
# the cascade G step's own metrics, and every tag the JAX package's trainer
# logs for cascade.yml (cpcsv_tpu/train/steps.py, trainer.py)
CASCADE_G_TAGS = ("G/image_vae_loss", "G/video_vae_loss", "G/reconstruct_loss")
CASCADE_TAGS = (
    "seg_D/loss", "seg_D/real", "seg_D/fake", "Accuracy/se_D", "img_D/loss", "img_D/real",
    "img_D/fake", "Accuracy/im_D", "st_D/loss", "st_D/real", "st_D/fake", "st_D/order",
    "G/im_KL", "G/st_KL", "G/KL", "G/consistency", "Accuracy/im_G", "Accuracy/se_G",
    "Accuracy/st_G", "G/gan_loss", "G/loss", *CASCADE_G_TAGS, "learning/generator",
    "learning/st_discriminator", "learning/im_discriminator", "perf/frames_per_sec",
    "perf/epoch_seconds")
WARMUP_STEPS, TIMED_STEPS = 2, 5
GRAPH_KERNEL_NODE = 0  # CU_GRAPH_NODE_TYPE_KERNEL
# phases 21-24: the training objectives no shipped config turns on, each a
# shipped config with the keys flipped, written as a YAML into a temporary
# directory: (file, base config, keys)
VARIANTS = (
    ("final_seq.yml", "final.yml", {"USE_SEQ_CONSISTENCY": True}),
    ("final_infonce.yml", "final.yml", {"USE_INFONCE": True}),
    ("final_noseg.yml", "final.yml", {"SEGMENT_LEARNING": False}),
    ("throughput_seq.yml", "throughput.yml", {"USE_SEQ_CONSISTENCY": True}),
)
# phase 23: the BN kernels at the largest maps the variants give them, the
# InfoNCE head's B² rows and the VideoEncoder's stem, (N, C, S) and dtype
NEW_BN_MAPS = (((8100, 992, 16), "float32"), ((18, 64, 7168), "float32"),
               ((18, 64, 7168), "bfloat16"))
# phase 7's yardstick (twin_step): the plain steps whose BN sums run in a
# seeded random order over these dimensions of (N, C, S), or in float64;
# held at bfloat16, with the VideoEncoder, and for these float32 configs
REORDERINGS = ((0,), (2,), (0, 2), "float64")
F32_YARDSTICK = ("clevr.yml",)
# phases 27-28: clevr.yml (4-frame stories, IM 64 / ST 16), its DFN batch,
# the serving call's stories, and the CLI's --synthetic: 4 story steps an
# epoch at ST_BATCH 16
# phase 35: (a) configs trained 2 epochs of SCAN_PAIRS steps at SCAN_STEPS
# SCAN_PAIRS and 1 (SCAN_SYNTHETIC stories: SCAN_PAIRS steps at ST_BATCH
# 18); (c) configs timed at the shipped SCAN_STEPS
SCAN_CONFIGS = ("final.yml", "cascade.yml", "procedural.yml")
SCAN_PAIRS, SCAN_SYNTHETIC = 2, 36
SCAN_TIMED_CONFIGS, SCAN_TIMED_K, SCAN_TIMED_CHUNKS = ("final.yml", "procedural.yml"), 20, 1
SCAN_TIMED_PAIRS = 5  # (c)'s single pairs traced, each read back
CLEVR_CONFIG, CLEVR_DFN_B, CLEVR_STORIES, CLEVR_SYNTHETIC = "clevr.yml", 64, 16, 64
CLEVR_SCAN = 2  # phase 28's SCAN_STEPS: 2 chunks an epoch, CPCSV_PROFILE_DIR traces the second
COLD_BYTES = 2**26  # 67 MB, more than the H100's 50 MB L2
GRAPH_REPLAYS = 5  # graph_ms' replays, of which it takes the median
# (N, C, S) beside the step's BN shapes: one row, one channel, S not a
# multiple of 4, short odd maps, and the dense heads' widths (S = 1)
# phases 29-31: data parallelism over DP_WORLD processes sharing the card,
# at DP_CONFIG's batches a rank; DP_SYNTHETIC stories give the CLI one step
# an epoch at the global batch; a rank gets DP_TIMEOUT seconds
DP_CONFIG, DP_WORLD, DP_SYNTHETIC, DP_TIMEOUT = "final.yml", 2, 36, 300
SPAWN_WAIT = 900  # seconds a rank spawned ahead of its phase waits for its job
# phases 32-33: the meshes with a model axis, on DP_WORLD and twice as many
# ranks: the same global batch as phase 29's
DP_MODEL, DP_FOUR = "data:1,model:2", "data:2,model:2"
# phase 37: training across the cards of the host, one NCCL rank a card:
# MULTI_CONFIG at its batches a rank; (b) a chunk of MULTI_PAIRS pairs (one
# eager, the capture, the rest replayed) against as many eager pairs; the
# CLI on MULTI_CLI, one story step an epoch at the global batch; a rank
# killed MULTI_KILL_AFTER seconds into the CLI's first epoch, which must end
# the command within MULTI_KILL_BOUND seconds
MULTI_CONFIG, MULTI_PAIRS, MULTI_CLI = "final.yml", 3, "cascade.yml"
MULTI_KILL_AFTER, MULTI_KILL_BOUND = 2.0, 30.0
GROUP_VARIABLES = ("CPCSV_COORDINATOR", "CPCSV_NUM_PROCESSES", "CPCSV_PROCESS_ID",
                   "CPCSV_DISTRIBUTED", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "CPCSV_LAUNCHED")
# phases 37 (e)-(f) and 38: NCCL's algorithm and protocol pinned in the CLI
# commands whose checkpoints are held bit for bit against one another (never
# in the package), NCCL saying what it chose
HOST_NCCL = {"NCCL_ALGO": "Ring", "NCCL_PROTO": "Simple", "NCCL_DEBUG": "INFO"}
# phase 34: the CLEVR tree's train and test stories (4 story steps and one
# image batch of clevr.yml an epoch; 2 test batches)
CLEVR_DISK = (64, 32)
EDGE_BN_SHAPES = ((1, 64, 4096), (90, 1, 1024), (7, 37, 5), (3, 5, 18), (2, 3, 2),
                  (90, 32768, 1), (18, 16384, 1), (90, 9, 1), (1, 1, 1))


# a sitecustomize that holds cuDNN deterministic in every Python process
# started with its directory first on PYTHONPATH (the ranks a CLI command
# starts come up fresh, beyond this script's reach), after running the
# sitecustomize it shadows, if there is one
DETERMINISTIC_SITE = """import importlib.machinery, importlib.util, os, sys
_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path if os.path.abspath(p or ".") != _here])
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
import torch
torch.backends.cudnn.deterministic = True
"""


def deterministic_site(directory: Path) -> str:
    """Writes DETERMINISTIC_SITE into `directory`; returns the directory,
    for the front of PYTHONPATH."""
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "sitecustomize.py").write_text(DETERMINISTIC_SITE)
    return str(directory)


T0 = time.perf_counter()


def phase(title: str) -> None:
    print(f"== {title} [t={time.perf_counter() - T0:.1f} s]", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def _reps(fn, budget_s: float = 0.25, most: int = 200) -> int:
    """How many calls of `fn` fit in `budget_s`, from one synchronised call,
    between 3 and `most`: some library calls cost milliseconds of host time."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return max(3, min(most, int(budget_s / max(time.perf_counter() - t, 1e-6))))


def event_ms(fn) -> float:
    """Mean milliseconds per call of back-to-back calls, CUDA events."""
    import torch

    reps = _reps(fn)
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMalloc", "cudaFree", "cudaMemcpy")  # runtime calls that stall the host


def trace(fn, reps: int):
    """(device events, host runtime events) of `reps` calls of `fn` under
    torch.profiler. Device events are the card's kernels, copies and sets,
    with their CUDA durations; host gaps between them are not in them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):  # now and then a trace records no device event at all
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        dev = device_events(events)
        if dev:
            break
    check(bool(dev), "torch.profiler recorded no device activity in 3 traces")
    host = [e for e in events if e.device_type == DeviceType.CPU and e.name.startswith("cuda")]
    return dev, host


def device_events(events) -> list:
    """The card's kernels, copies and sets among a trace's events; not the
    device-side copies of record_function ranges, which span kernels."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def by_name(events, reps: int) -> dict[str, float]:
    """Microseconds per call by event name, largest first."""
    sums: dict[str, float] = {}
    for e in events:
        sums[e.name] = sums.get(e.name, 0.0) + e.time_range.elapsed_us() / reps
    return dict(sorted(sums.items(), key=lambda kv: -kv[1]))


def device_ms(fn, label: str) -> float:
    """Mean device milliseconds per call from a torch.profiler trace: the
    summed durations of the card's work, so host overhead and host waits
    between launches are excluded. Prints what the card ran per call and the
    host runtime calls that wait or allocate."""
    reps = _reps(fn, most=50)
    for _ in range(3):
        fn()
    dev, host = trace(fn, reps)
    names = by_name(dev, reps)
    waits = {k: sum(1 for e in host if e.name == k) / reps for k in HOST_WAITS}
    span = (max(e.time_range.end for e in dev) - min(e.time_range.start for e in dev)) / reps
    print(f"  {label}: per call {len(dev) / reps:.1f} device ops in a span of {span:.2f} us "
          + ", ".join(f"{k[:60]} {v:.2f} us" for k, v in list(names.items())[:3])
          + "; host waits/allocs per call "
          + (", ".join(f"{k} {v:g}" for k, v in waits.items() if v) or "none"))
    return sum(names.values()) / 1e3


def graph_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds per call of `reps` calls captured in one CUDA graph,
    the median of GRAPH_REPLAYS replays (one replay now and then runs several
    times slower): no host work between launches and no profiler. The DFN's
    library call, a grouped cuDNN conv1d, is timed so at B=90 only: it hung
    in capture at B >= 360."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    times = []
    for _ in range(GRAPH_REPLAYS):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[GRAPH_REPLAYS // 2] / reps


# one BN kernel at one (N, C, S) of the step: launches a step, and ms per
# call of the kernel and its library call in one CUDA graph, beside the bound
BnTime = collections.namedtuple("BnTime", "shape calls kernel_ms library_ms bound_ms")


def cold_graph_ms(fn, inputs: list) -> float:
    """Mean milliseconds per call of fn(*inputs[i % len(inputs)]), i = 0, 1,
    ..., in one CUDA graph (`graph_ms`), at least 20 calls and a whole
    number of rounds. The caller passes enough copies that together they
    exceed COLD_BYTES, so every call reads inputs that left the L2 since
    their last use, as a step's BN input that a large conv wrote long ago."""
    i = [0]

    def call():
        args = inputs[i[0] % len(inputs)]
        i[0] += 1
        return fn(*args)

    return graph_ms(call, len(inputs) * -(-20 // len(inputs)))


def cold_copies(gen, N: int, C: int, S: int, count: int, offset: int = 0, dtype=None) -> list:
    """`count` distinct (N, C, S) tensors of `dtype` (float32 by default)
    from one allocation, each starting 256-byte aligned plus `offset`
    elements."""
    import torch

    numel = N * C * S
    row = -(-(numel + offset) // 128) * 128
    buf = torch.randn(count, row, generator=gen, device="cuda").to(dtype or torch.float32)
    return [buf[k, offset:offset + numel].view(N, C, S) for k in range(count)]


def bn_cold_inputs(gen, name: str, N: int, C: int, S: int, dtype=None) -> list:
    """Argument tuples of BN kernel `name` at (N, C, S), x and dy of `dtype`
    (float32 by default), for `cold_graph_ms`: at least 2 distinct copies,
    together more than COLD_BYTES; the copies of bn_grad_reduce share one
    float32 mean and invstd ([C], a few KB)."""
    import torch

    tensors = 1 if name == "bn_stats" else 2
    itemsize = torch.empty(0, dtype=dtype or torch.float32).element_size()
    copies = max(2, -(-COLD_BYTES // (itemsize * N * C * S * tensors)))
    views = cold_copies(gen, N, C, S, copies * tensors, dtype=dtype)
    if name == "bn_stats":
        return [(v,) for v in views]
    mean = views[0].float().mean(dim=(0, 2))
    inv = torch.rsqrt(views[0].float().var(dim=(0, 2), correction=0) + 1e-5)
    return [(views[2 * k], views[2 * k + 1], mean, inv) for k in range(copies)]


def bn_graph_nodes(step_calls: dict, dtype) -> dict:
    """{(kernel, (N, C, S)): Counter of CUgraphNodeType} of one call of each BN
    wrapper at each shape of `step_calls`, on inputs of `dtype`, captured in a
    CUDA graph and read with CUDA's cuGraphGetNodes: what one call runs
    on the card, without a profiler."""
    import torch

    from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda

    out = {}
    for kernel, calls in step_calls.items():
        for N, C, S in calls:
            x, dy = (torch.randn(N, C, S, device="cuda").to(dtype) for _ in range(2))
            mean, inv = torch.zeros(C, device="cuda"), torch.ones(C, device="cuda")
            args = (x,) if kernel == "bn_stats" else (x, dy, mean, inv)
            fn = getattr(bn_cuda, kernel)
            fn(*args)  # outside the capture: the allocator then holds the blocks
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph):
                fn(*args)
            out[kernel, (N, C, S)] = graph_node_types(graph)
            del graph
    return out


@contextlib.contextmanager
def counting_bn_calls():
    """While open, the BN wrappers count their calls by shape, passing each
    on: yields {kernel: {(N, C, S): calls}}."""
    from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda

    calls = {"bn_stats": {}, "bn_grad_reduce": {}}

    def counting(name: str):
        wrapped = getattr(bn_cuda, name)

        def call(x, *rest):
            shape = tuple(x.shape)
            calls[name][shape] = calls[name].get(shape, 0) + 1
            return wrapped(x, *rest)

        return mock.patch.object(bn_cuda, name, call)

    with counting("bn_stats"), counting("bn_grad_reduce"):
        yield calls


def dfn_bound(B: int, C: int, L: int, K: int, pad: int, itemsize: int):
    """(bound_ms, bound_by): the least time for the DFN's work on an H100,
    each input read once and the output written once, against the
    float32 multiply-adds over the non-tensor-core peak."""
    L_out = L + 2 * pad - K + 1
    nbytes = B * (C * L + C * K + L_out) * itemsize
    flops = 2 * B * L_out * C * K
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dfn_backward_bound(B: int, C: int, L: int, K: int, pad: int, itemsize: int = 4):
    """(bound_ms, bound_by) of the DFN backward: image, filters and dout read
    once, d image and d filters written once, against its multiply-adds."""
    L_out = L + 2 * pad - K + 1
    nbytes = B * (2 * C * L + 2 * C * K + L_out) * itemsize
    flops = 2 * B * C * K * (L_out + L)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def launch_floor_ms() -> float:
    """The card's cost of one launch: `graph_ms` of torch.cuda._sleep(0),
    PyTorch's spin kernel (one thread) told to spin for 0 cycles, an empty
    kernel."""
    import torch

    return graph_ms(lambda: torch.cuda._sleep(0))


# one DFN kernel at one batch: µs per call in one CUDA graph and traced, the
# plain version's and the library call's, the bound
DfnTime = collections.namedtuple("DfnTime", "graph_ms traced_ms plain_ms library_ms bound_ms bound_by")


def dfn_line(name: str, B: int, t: DfnTime, floor: float, library: str, extra: str = "") -> None:
    print(f"  {name} B={B}: kernel {t.graph_ms * 1e3:.2f} in a graph ({(t.graph_ms - floor) * 1e3:.2f} "
          f"over the floor, share {t.bound_ms / t.graph_ms:.4f}), traced {t.traced_ms * 1e3:.2f}; "
          f"plain {t.plain_ms * 1e3:.2f}; {library} {t.library_ms * 1e3:.2f}; bound "
          f"{t.bound_ms * 1e3:.3f} ({t.bound_by}){extra}")


def dfn_forward_times(gen, card: str, floor: float, dtype=None,
                      batches=(90, 360)) -> dict:
    """{B: DfnTime} of the DFN forward of the package on sys.path at the
    generator's shape, B = 90 (a training call, 18 stories) and 360 (72),
    float32 (or `dtype`), inputs warm in the L2 (on the main path
    image_net and filter_net write them just before). The library call,
    grouped F.conv1d, is one cuDNN kernel per group and is timed in a graph
    at B=90 only (it hung in capture at B >= 360); above, back to back with
    CUDA events."""
    import torch
    import torch.nn.functional as F

    from cpcsv_tpu_torch.device import float32_math
    from cpcsv_tpu_torch.ops.cuda import dfn as dfn_cuda
    from cpcsv_tpu_torch.ops.dynamic_filter import dynamic_filter_conv1d_plain

    dtype = dtype or torch.float32
    C, L, K, pad = DFN_SHAPE
    # float32: sums in other orders; bfloat16: one rounding of each output
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    print(f"dfn_forward {dtype} [{card}]: us per call, inputs warm in L2; launch floor "
          f"{floor * 1e3:.2f} us in a graph (torch.cuda._sleep(0)); share = bound / kernel")
    times = {}
    for B in batches:
        img = torch.randn(B, C, L, generator=gen, device="cuda").to(dtype)
        filt = torch.randn(B, 1, C, K, generator=gen, device="cuda").to(dtype)
        fns = {
            "kernel": lambda: dfn_cuda.dfn_forward(img, filt, pad),
            "plain": lambda: dynamic_filter_conv1d_plain(img, filt, pad),
            "library": lambda: F.conv1d(img.reshape(1, B * C, L), filt.reshape(B, C, K),
                                        padding=pad, groups=B),
        }
        with float32_math():  # the plain einsum and the library conv in float32
            check(torch.allclose(fns["library"]().reshape(B, 1, -1).float(),
                                 fns["kernel"]().float(), rtol=tol, atol=tol),
                  "grouped conv1d disagrees with the kernel")
            traced = {k: device_ms(f, f"dfn_forward {k} B={B}") for k, f in fns.items()}
            graphed = {k: graph_ms(f) for k, f in fns.items() if k != "library" or B == 90}
            library = graphed.get("library") or event_ms(fns["library"])
        times[B] = DfnTime(graphed["kernel"], traced["kernel"], graphed["plain"], library,
                           *dfn_bound(B, C, L, K, pad, img.element_size()))
        dfn_line("dfn_forward", B, times[B], floor,
                 "grouped conv1d " + ("in a graph" if B == 90 else "back to back"),
                 f"; traced plain {traced['plain'] * 1e3:.2f}, library {traced['library'] * 1e3:.2f}")
    return times


def dfn_backward_times(gen, card: str, floor: float, dtype=None, batches=(90, 7)):
    """({B: DfnTime}, {B: ms of the step's backward op}, {B: ms of one dout
    copy}, copies):
    the DFN backward of the package on sys.path at the generator's shape,
    B = 90 (the step's) and 7, float32 (or `dtype` at `batches`), inputs warm
    in the L2. The kernel is timed on a contiguous dout; the op
    is `_DynamicFilterKernel.backward` on the dout the G step hands it, the
    last L_out columns of a (B, ZMC_WIDTH) gradient, with whatever copy the
    op makes first; `copies` is how many it made, seen by a pass-through."""
    import torch

    from cpcsv_tpu_torch.device import float32_math
    from cpcsv_tpu_torch.ops import dynamic_filter as dfn_op
    from cpcsv_tpu_torch.ops.cuda import dfn as dfn_cuda

    dtype = dtype or torch.float32
    C, L, K, pad = DFN_SHAPE
    L_out = L + 2 * pad - K + 1
    # float32: sums in other orders; bfloat16: one rounding of each output
    rtol, atol = (1e-5, 1e-4) if dtype == torch.float32 else (2 ** -7, 1e-2)
    print(f"dfn_backward {dtype} [{card}]: us per call, inputs warm in L2; launch floor "
          f"{floor * 1e3:.2f} us; op = the autograd Function's backward on the G step's "
          f"row-strided dout (row stride {ZMC_WIDTH}), its copy included")
    times, ops, copy_ms = {}, {}, {}
    for B in batches:
        img = torch.randn(B, C, L, generator=gen, device="cuda").to(dtype)
        filt = torch.randn(B, 1, C, K, generator=gen, device="cuda").to(dtype)
        strided = torch.randn(B, ZMC_WIDTH, generator=gen, device="cuda").to(dtype)[
            :, -L_out:].unsqueeze(1)
        dout = strided.contiguous()
        ctx = types.SimpleNamespace(saved_tensors=(img, filt), pad=pad)
        fns = {
            "kernel": lambda: dfn_cuda.dfn_backward(img, filt, dout, pad),
            "op": lambda: dfn_op._DynamicFilterKernel.backward(ctx, strided),
            "plain": lambda: dfn_op.dynamic_filter_conv1d_backward_plain(img, filt, dout, pad),
            "library": lambda: torch.ops.aten.convolution_backward(
                dout.view(1, B, L_out), img.view(1, B * C, L), filt.view(B, C, K), None, [1],
                [pad], [1], False, [0], B, [True, True, False]),
            "copy": lambda: strided.contiguous(),
        }
        with float32_math():
            lib, got = fns["library"](), fns["kernel"]()
            check(torch.allclose(lib[0].view(B, C, L).float(), got[0].float(), rtol=rtol,
                                 atol=atol)
                  and torch.allclose(lib[1].view(B, 1, C, K).float(), got[1].float(),
                                     rtol=rtol, atol=atol),
                  "grouped conv1d backward disagrees with dfn_backward")
            with counting_dfn_backward() as handed:
                fns["op"]()
            copies = int(handed[0][1] != strided.stride())
            traced = {k: device_ms(f, f"dfn_backward {k} B={B}") for k, f in fns.items()}
            graphed = {k: graph_ms(f) for k, f in fns.items()}
        times[B] = DfnTime(graphed["kernel"], traced["kernel"], graphed["plain"],
                           graphed["library"],
                           *dfn_backward_bound(B, C, L, K, pad, img.element_size()))
        ops[B], copy_ms[B] = graphed["op"], graphed["copy"]
        dfn_line("dfn_backward", B, times[B], floor, "convolution_backward in a graph",
                 f"; op {graphed['op'] * 1e3:.2f} in a graph ({copies} dout copy of "
                 f"{graphed['copy'] * 1e3:.2f}), traced {traced['op'] * 1e3:.2f}")
    return times, ops, copy_ms, copies


def dfn_step_ms(card: str, forward: DfnTime, backward_op: float, copies: int, copy_ms: float,
                floor: float) -> float:
    """Prints and returns the DFN pair's Σ launches × graph time over one D+G
    step at B=90: DFN_STEP_LAUNCHES of the forward kernel and of the
    backward op (its dout copies included)."""
    n_f, n_b = DFN_STEP_LAUNCHES["dfn_forward"], DFN_STEP_LAUNCHES["dfn_backward"]
    step = n_f * forward.graph_ms + n_b * backward_op
    print(f"DFN pair per step [{card}]: {n_f} x forward {forward.graph_ms * 1e3:.2f} + {n_b} x "
          f"backward op {backward_op * 1e3:.2f} ({copies} dout copy each, {copy_ms * 1e3:.2f} us) "
          f"= {step * 1e3:.2f} us; {n_f + n_b + n_b * copies} launches, floor x launches "
          f"{(n_f + n_b + n_b * copies) * floor * 1e3:.2f} us")
    return step


@contextlib.contextmanager
def counting_dfn_backward():
    """While open, the DFN backward wrapper records the (shape, strides) of
    each dout it is handed, passing each call on: yields that list."""
    from cpcsv_tpu_torch.ops.cuda import dfn as dfn_cuda

    handed = []
    wrapped = dfn_cuda.dfn_backward

    def call(image, filters, dout, pad):
        handed.append((tuple(dout.shape), dout.stride()))
        return wrapped(image, filters, dout, pad)

    with mock.patch.object(dfn_cuda, "dfn_backward", call):
        yield handed


def bn_bound(name: str, N: int, C: int, S: int, itemsize: int = 4):
    """(bound_ms, bound_by) of a BN reduction over (N, C, S) of `itemsize`-byte
    elements (4: float32, 2: bfloat16): bn_stats reads x and writes two
    float32 [C] sums, 3 operations an element; bn_grad_reduce reads x, dy
    and float32 mean and invstd and writes two sums, 5 operations an
    element (float32 arithmetic either way)."""
    n = N * C * S
    nbytes = (itemsize * n + 4 * 2 * C if name == "bn_stats"
              else itemsize * 2 * n + 4 * 4 * C)
    flops = (3 if name == "bn_stats" else 5) * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_GENERATOR_STATES: dict = {}  # (config, seed, stories) -> random_generator_state's


def random_generator_state(cfg, stories, seed: int):
    """A full-width generator state_dict: the reference init
    (`train.state.weights_init`) from `seed`, then BN running statistics set
    from one forward pass on the card, each mean shifted and each variance
    scaled at random, so eval BN is far from the identity and the
    activations keep a useful range. Made once a (config, seed, story
    count): phases 4, 15 and 36 serve the same configs."""
    key = (cfg, seed, len(stories["description"]))
    if key not in _GENERATOR_STATES:
        _GENERATOR_STATES[key] = _random_generator_state(cfg, stories, seed)
    return _GENERATOR_STATES[key]


def _random_generator_state(cfg, stories, seed: int):
    import torch

    from cpcsv_tpu_torch.device import float32_math
    from cpcsv_tpu_torch.evaluation.drivers import _batch_motion_content
    from cpcsv_tpu_torch.models.factory import generator_from_config
    from cpcsv_tpu_torch.train.state import weights_init

    net = generator_from_config(cfg).cuda().eval()
    gc = torch.Generator(device="cuda").manual_seed(seed)
    weights_init(net, gc)

    def calibrate(mod, inputs):
        x = inputs[0].float()
        dims = [d for d in range(x.dim()) if d != 1]
        mean, var = x.mean(dims), x.var(dims)
        n = mean.numel()
        mod.running_mean.copy_(
            mean + 0.1 * var.sqrt() * torch.randn(n, generator=gc, device="cuda"))
        mod.running_var.copy_(
            var * (0.5 + torch.rand(n, generator=gc, device="cuda")) + 1e-3)

    hooks = [m.register_forward_pre_hook(calibrate) for m in net.modules()
             if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    motion, content = _batch_motion_content(cfg, stories)
    with torch.no_grad(), float32_math():
        net.sample_videos(torch.from_numpy(motion).cuda(), torch.from_numpy(content).cuda(),
                          generator=gc)
    for h in hooks:
        h.remove()
    return {k: v.cpu() for k, v in net.state_dict().items()}


def bn_modules(net):
    import torch

    return [m for m in net.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]


def per_step_launches(state, infonce: bool = False) -> dict[str, int]:
    """Each kernel's launches in one D+G step (batches > 1), counted from the
    code (`train/steps.py`, `models/`):
      D step: two generator calls without gradients, each running every G BN
        and the DFN once; per D (no seg D without segment learning),
        `d_phase` encodes real and fake (every encoder BN twice) and calls
        the head three times (real, wrong, fake), or with InfoNCE twice
        (the B² pairs, fake); with the order-consistency branch the story D
        runs its VideoEncoder once, on the shuffled stories; the backward
        passes every D BN call.
      G step: two generator calls; for the cascade, two `train_autoencoder`
        calls (the re-encoder's BNs and upsample1_seg to upsample4_seg); per
        D, `g_phase` encodes the fakes once and calls the head once, and the
        story D's VideoEncoder runs on the real stories (no gradient) and on
        the fakes; the backward passes every BN call on the loss's path, and
        both DFN calls. That is every call but the VideoEncoder's on the real
        stories and, in v1 `_decode` with segment learning, the story call's
        upsample2_seg to upsample4_seg: they feed only the mask, and no loss
        reads the story call's mask. In the cascade the story mask feeds the
        re-encoder, which gates the image trunk and the latent loss, so every
        call is on the path.
      REMAT (`gen.remat`): the G step's backward runs every UpBlock and
        DownBlock call on the loss's path again, each block's BN `bn_stats`
        once more; the D step samples without gradients, so no recompute."""
    from cpcsv_tpu_torch.ops.blocks import UpBlock

    gen = state.gen
    g = len(bn_modules(gen))
    ds = [d for d in (state.d_se, state.d_im, state.d_st) if d is not None]
    enc = sum(len(bn_modules(d.encode_img)) for d in ds)
    head = sum(len(bn_modules(d.get_cond_logits)) for d in ds)
    video = (len(bn_modules(state.d_st.seq_consisten_model))
             if state.d_st.seq_consisten_model is not None else 0)
    d_phase = 2 * enc + (2 if infonce else 3) * head + video
    g_phase = enc + head + 2 * video
    autoencoder = unread_mask_bns = ae_blocks = 0
    blocks = sum(len(bn_modules(m)) for name, m in gen.named_children()
                 if name.startswith(("upsample", "downsample")))
    if gen.cascade:
        ae_blocks = sum(len(bn_modules(getattr(gen, m))) for m in (
            "downsample1_seg", "downsample2_seg", "downsample3_seg", "downsample4_seg",
            "upsample1_seg", "upsample2_seg", "upsample3_seg", "upsample4_seg"))
        autoencoder = ae_blocks + len(bn_modules(gen.presample))
    elif gen.use_segment:
        unread_mask_bns = 3
    check(all(isinstance(getattr(gen, f"upsample{i}"), UpBlock) for i in range(1, 5)),
          "the generator's up blocks are not UpBlocks")
    recompute = (2 * blocks - unread_mask_bns + 2 * ae_blocks) if gen.remat else 0
    return {
        "bn_stats": 2 * g + d_phase + 2 * g + 2 * autoencoder + g_phase + recompute,
        "bn_grad_reduce": (d_phase + 2 * g - unread_mask_bns + 2 * autoencoder + g_phase
                           - video),
        **DFN_STEP_LAUNCHES,
    }


@contextlib.contextmanager
def pinned_to_one_card():
    """While open, on a host of several cards, a config read through
    `config_from_file` that names no MESH_SHAPE gets "data:1": the JAX
    package's `make_mesh("data:1")`, devices[:1]. The CLIs' training runs in
    this process then start no ranks and `Infer`'s eval mesh is cuda:0, so
    that the phases before 37 read on such a host what they read on a host
    of one card (36 runs unpinned; the ranks of 29-33 see card 0 alone)."""
    import torch

    from cpcsv_tpu_torch import config

    real = config.config_from_file

    def pinned(*args, **kwargs):
        cfg = real(*args, **kwargs)
        return cfg if cfg.MESH_SHAPE else cfg.with_updates(MESH_SHAPE="data:1")

    with (mock.patch.object(config, "config_from_file", pinned)
          if torch.cuda.device_count() > 1 else contextlib.nullcontext()):
        yield


@contextlib.contextmanager
def final_saves_only():
    """While open, the trainer's periodic checkpoint saves (the calls without
    `completed`) are skipped and its final save runs: a one-epoch run's
    epoch-0 snapshot holds the final save's state, and each save of a
    full-width state is ~5 s."""
    from cpcsv_tpu_torch.train.checkpoint import CheckpointManager

    real = CheckpointManager.save

    def save(self, state, epoch, completed=None):
        if completed is not None:
            real(self, state, epoch, completed)

    with mock.patch.object(CheckpointManager, "save", save):
        yield


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0, and the sampler's calls."""
    from cpcsv_tpu_torch.evaluation import sampling
    from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda
    from cpcsv_tpu_torch.ops.cuda import dfn as dfn_cuda

    for counts in (dfn_cuda.launches, bn_cuda.launches):
        counts.update(dict.fromkeys(counts, 0))
    sampling.totals.clear()


def sampler_calls() -> dict:
    """The sampler's calls since `reset_counts`, over every net."""
    from cpcsv_tpu_torch.evaluation import sampling

    return {k: sampling.totals[k] for k in ("eager", "captured", "replayed")}


def check_sampler(calls: int, label: str, got: dict = None, eager: int = None) -> dict:
    """The sampler's calls (`sampler_calls()` unless `got`): `calls`
    generation calls, each first call at a key eager (`eager` of them, where
    given) and then captured, every other one a replay, at least one of
    them. Returns the counts."""
    got = got or sampler_calls()
    check(got["eager"] == got["captured"] and got["eager"] + got["replayed"] == calls
          and got["replayed"] > 0 and eager in (None, got["eager"]),
          f"{label}: sampler calls {got}, expected {calls} calls, each eager one captured "
          f"({eager or 'some'} of them) and some replayed")
    print(f"{label}: sampler calls {got} ({calls} generation calls; every call after the first "
          "at a key replays its CUDA graph)")
    return got


def eager_np(infer, batch, seg: bool = False):
    """What `Infer.sample_videos_np` computes, run eagerly: the net's
    `sample_videos` on the card from `infer.generator`, no graph, under a
    DFN patched in by the caller too."""
    import torch

    from cpcsv_tpu_torch.device import float32_math
    from cpcsv_tpu_torch.evaluation.drivers import _batch_motion_content

    motion, content = _batch_motion_content(infer.cfg, batch)
    with torch.no_grad(), float32_math():
        out = infer.net_g.sample_videos(torch.from_numpy(motion).cuda(),
                                        torch.from_numpy(content).cuda(), seg=seg,
                                        generator=infer.generator)
    mask = out.seg.float().cpu().numpy() if out.seg is not None else None
    return out.image.float().cpu().numpy(), mask


def kernel_node_names(graph) -> list[str]:
    """The (mangled) names of a kept torch.cuda.CUDAGraph's kernel nodes,
    read with CUDA's cuGraphKernelNodeGetParams and cuFuncGetName (or
    cuKernelGetName for a node that holds a library kernel)."""
    import ctypes

    class Params(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p)] + [(f, ctypes.c_uint) for f in (
            "gx", "gy", "gz", "bx", "by", "bz", "smem")] + [(f, ctypes.c_void_p) for f in (
                "params", "extra", "kern", "ctx")]

    libcuda = ctypes.CDLL("libcuda.so.1")
    names = []
    for node, kind in graph_nodes(graph):
        if kind != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        p = Params()
        err = libcuda.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(p))
        check(err == 0, f"cuGraphKernelNodeGetParams_v2 failed ({err})")
        name = ctypes.c_char_p()
        if p.func:
            err = libcuda.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func))
        else:
            err = libcuda.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(p.kern))
        check(err == 0 and name.value is not None, f"a kernel node's name: CUDA error {err}")
        names.append(name.value.decode())
    return names


def serving_times(infer, batch, n: int, label: str, card: str) -> dict:
    """Phases 5 and 15: ms a call (median of 5 after 2 warm-ups) of
    `infer.sample_videos_np` on `batch`, a replay, against the same call run
    eagerly (`eager_np`), and from a trace of 3 calls of each the device busy
    time a call (the union of the card's events' intervals) and the idle
    share against the median. Returns {"graphed" | "eager": {"ms", "busy_ms",
    "idle", "ops"}}."""
    out = {}
    for way, fn in (("graphed", lambda: infer.sample_videos_np(batch)),
                    ("eager", lambda: eager_np(infer, batch))):
        for _ in range(2):
            fn()
        times = []
        for _ in range(5):
            t = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t)
        med = sorted(times)[len(times) // 2] * 1e3
        dev, _ = trace(fn, 3)
        names = by_name(dev, 3)
        busy = span_union((e.time_range.start, e.time_range.end) for e in dev) / 3e3
        out[way] = {"ms": med, "busy_ms": busy, "idle": 1 - busy / med, "ops": len(dev) / 3}
        print(f"{label}, {way}: {med:.2f} ms median of 5 (min {min(times) * 1e3:.2f}, max "
              f"{max(times) * 1e3:.2f}), {n * infer.cfg.VIDEO_LEN / med * 1e3:.1f} frames/s "
              f"[{card}]; trace: device busy {busy:.3f} ms per call in {len(dev) / 3:.0f} ops, "
              f"idle share {1 - busy / med:.3f}; top: "
              + "; ".join(f"{k[:60]} {v:.1f} us" for k, v in list(names.items())[:4]))
    g, e = out["graphed"]["ms"], out["eager"]["ms"]
    print(f"{label}: graphed {g:.2f} ms against eager {e:.2f} ms a call ({e / g:.3f}x)")
    return out


def replays_match_eager(infer, batches: dict, label: str) -> dict:
    """Phases 4 and 15. Eager generation is not bit-reproducible under
    cuDNN's default flags: the `deconv` lowering's transposed convs pick a
    data-gradient algorithm that sums in varying order, and two eager calls
    differ in the last bits (PR 14's chip runs). So, for each batch, the
    graph captured at the default flags (the batch's first call was) is read
    against eager calls, the eager-to-eager spread beside it; then, under
    cudnn.deterministic (a key of its own), a first call captures and a
    replay is held against eager `sample_videos` from the same generator
    state bit for bit, the generator advanced alike, a rewound generator
    reaching the replay. Last, every graph of the net's sampler: one DFN
    kernel node among its kernel nodes. Returns {stories: kernel nodes}."""
    import numpy as np
    import torch

    from cpcsv_tpu_torch.evaluation import sampling

    cache = sampling.cache_of(infer.net_g)
    spreads = {}
    for n, batch in batches.items():
        state = infer.generator.get_state()
        got, _ = infer.sample_videos_np(batch)
        eager = []
        for _ in range(2):
            infer.generator.set_state(state)
            eager.append(eager_np(infer, batch)[0])
        spreads[n] = (float(abs(got - eager[0]).max()), float(abs(eager[1] - eager[0]).max()))
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for n, batch in batches.items():
            infer.sample_videos_np(batch)  # eager, then captured at this key
            replayed = sampling.totals["replayed"]
            state = infer.generator.get_state()
            got, _ = infer.sample_videos_np(batch)
            after = infer.generator.get_state()
            infer.generator.set_state(state)
            ref, _ = eager_np(infer, batch)
            check(torch.equal(infer.generator.get_state(), after),
                  f"{label} {n} stories: the replay and the eager call advanced the generator "
                  "apart")
            check(np.array_equal(got, ref), f"{label} {n} stories: replayed frames differ from "
                                            f"eager sample_videos by {float(abs(got - ref).max())}")
            infer.generator.set_state(state)
            again, _ = infer.sample_videos_np(batch)
            check(np.array_equal(again, got), f"{label} {n} stories: a rewound generator did not "
                                              "reach the replay")
            check(sampling.totals["replayed"] == replayed + 2,
                  f"{label} {n} stories: sampler calls {sampler_calls()}")
    finally:
        torch.backends.cudnn.deterministic = saved
    nodes = {}
    for key, graph in cache.graphs.graphs.items():
        names = kernel_node_names(graph.graph)
        dfn = sum("dfn_forward_kernel" in k for k in names)
        check(dfn == 1 and graph.launches["dfn_forward"][1] == 1,
              f"{label}: a sampler graph holds {dfn} DFN kernel nodes, records "
              f"{graph.launches['dfn_forward'][1]} launches")
        if not key[6]:  # the default flags' graph (key: `sampling.sample_key`)
            nodes[key[0][0][0][0]] = len(names)
    print(f"{label}: under cudnn.deterministic every replay bit for bit eager sample_videos from "
          f"the same generator state, which both advance alike, and a rewound generator reaches "
          f"the replay; at the default flags max |replay - eager| and |eager - eager| by stories "
          + ", ".join(f"{n}: {a:.3e}, {b:.3e}" for n, (a, b) in spreads.items())
          + f"; kernel nodes a default-flags graph by stories {nodes}, one dfn_forward_kernel "
          f"in each "
          f"({len(cache.graphs.graphs)} graphs)")
    return nodes


def read_counts() -> dict[str, int]:
    from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda
    from cpcsv_tpu_torch.ops.cuda import dfn as dfn_cuda

    return {**dfn_cuda.launches, **bn_cuda.launches}


def is_d_tag(tag: str) -> bool:
    """A metric of the D step (the seg, image and story Ds' tags)."""
    return "_D/" in tag or tag.endswith("_D")


@contextlib.contextmanager
def spying_updates(history: list, before=None):
    """While open, the trainer's updates append their metrics (floats) to
    `history`, a D and a G entry a pair, whether the pair ran alone
    (`make_train_steps`) or in a chunk of SCAN_STEPS (`make_scan_steps`,
    whose rows come back once a chunk and are split by tag); `before(pairs)`,
    if given, runs before each update call: a D step (1) or a chunk (K)."""
    import torch

    from cpcsv_tpu_torch.train import trainer as trainer_module

    make_steps, make_scan = trainer_module.make_train_steps, trainer_module.make_scan_steps

    def steps(cfg):
        def spy(step, first):
            def run(*a):
                if first and before is not None:
                    before(1)
                state, metrics = step(*a)
                history.append({k: float(v) for k, v in metrics.items()})
                return state, metrics
            return run

        d_step, g_step = make_steps(cfg)
        return spy(d_step, True), spy(g_step, False)

    def scan(cfg):
        real = make_scan(cfg)

        def run(state, rng, st, im, *lrs):
            if before is not None:
                before(len(st["images"]))
            state, metrics = real(state, rng, st, im, *lrs)
            for row in torch.stack(list(metrics.values()), 1).tolist():
                row = dict(zip(metrics, row))
                d = {k: v for k, v in row.items() if is_d_tag(k)}
                history.extend([d, {k: v for k, v in row.items() if k not in d}])
            return state, metrics

        run.graphs = real.graphs
        return run

    with mock.patch.object(trainer_module, "make_train_steps", steps), \
            mock.patch.object(trainer_module, "make_scan_steps", scan):
        yield


def train_at_full_width(name: str, seed: int, card: str) -> types.SimpleNamespace:
    """Phase 6 for one config (a shipped config's name, or a variant's YAML
    path, phases 21-22): WARMUP_STEPS + TIMED_STEPS D+G steps at the
    config's batches from `create_train_state` through `make_train_steps`,
    with every check of the phase; with USE_SEQ_CONSISTENCY the story batch
    carries the trainer's host shuffle. Returns what phases 7-9 read."""
    import numpy as np
    import torch

    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.data.synthetic import synthetic_batches
    from cpcsv_tpu_torch.losses.shuffle import create_random_shuffle
    from cpcsv_tpu_torch.train.state import create_train_state
    from cpcsv_tpu_torch.train.steps import batch_to_device, make_train_steps

    cfg = config_from_file(name)
    name = Path(name).name
    b_st, b_im = cfg.TRAIN.ST_BATCH_SIZE, cfg.TRAIN.IM_BATCH_SIZE
    t0 = time.perf_counter()
    state = create_train_state(cfg, seed)
    nets = state.nets()
    st_host, im_host = synthetic_batches(cfg, b_st, b_im, seed)
    if cfg.USE_SEQ_CONSISTENCY:
        shuffled, order_labels = create_random_shuffle(st_host["images"],
                                                       rng=np.random.default_rng(seed))
        st_host = {**st_host, "shuffled": shuffled, "order_labels": order_labels}
    st_batch, im_batch = (batch_to_device(b, torch.device("cuda")) for b in (st_host, im_host))
    d_step, g_step = make_train_steps(cfg)
    rng = torch.Generator(device="cuda").manual_seed(seed)
    print(f"{name}, ST_BATCH {b_st} ({b_st * cfg.VIDEO_LEN} frames), IM_BATCH {b_im}: "
          f"create_train_state and batches {time.perf_counter() - t0:.2f} s [{card}]; parameters "
          + ", ".join(f"{n} {sum(p.numel() for p in net.parameters()):,}"
                      for n, net in nets.items()))
    before = {n: {k: v.detach().clone() for k, v in net.state_dict().items()}
              for n, net in nets.items()}
    inside = set()
    flags = [mod.register_forward_pre_hook(lambda *_: inside.add(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
        for mod in (state.gen.upsample1, state.d_st.get_cond_logits)]
    expected = per_step_launches(state, cfg.USE_INFONCE)
    steps = WARMUP_STEPS + TIMED_STEPS
    times, metrics = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the main path: the entry points only
    for i in range(steps):
        with contextlib.ExitStack() as stack:
            if i == 0:  # a warm-up step; the shapes are the same every step
                bn_calls = stack.enter_context(counting_bn_calls())
                douts = stack.enter_context(counting_dfn_backward())
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, dm = d_step(state, rng, st_batch, im_batch, LR_D)
            _, gm = g_step(state, rng, st_batch, im_batch, LR_G)
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        metrics.append({**dm, **gm})
    train_counts = read_counts()
    # (N, C, S) -> launches in one step, by kernel
    step_calls = {k: dict(sorted(calls.items())) for k, calls in bn_calls.items()}
    for k, calls in step_calls.items():
        check(sum(calls.values()) == expected[k],
              f"{name} {k}: {sum(calls.values())} calls counted by shape in one step, "
              f"expected {expected[k]}")
        print(f"{k} calls in one step by (N, C, S), {len(calls)} shapes: "
              + ", ".join(f"{sh} x{n}" for sh, n in calls.items()))
    # the G step hands each DFN backward its dout as the gradient of the
    # concatenation zmc_all left it, a column slice; the wrapper gets that
    # view, so nothing copied it on the way
    L_out = DFN_SHAPE[1] + 2 * DFN_SHAPE[3] - DFN_SHAPE[2] + 1
    width = cfg.motion_dim + cfg.content_dim + DFN_SHAPE[1]  # zmc_all's: ZMC_WIDTH at Pororo's
    check(len(douts) == expected["dfn_backward"]
          and all(sh == (b_im, 1, L_out) and st[0] == width and st[-1] == 1
                  for sh, st in douts),
          f"{name}: dfn_backward got dout (shape, strides) {douts} in one step: expected "
          f"{expected['dfn_backward']} views with row stride {width}")
    print(f"dfn_backward was handed in one step dout (shape, strides) {douts}: the column "
          f"slice of zmc_all's gradient, row stride {width}, no copy before the kernel")
    peak = torch.cuda.max_memory_allocated()
    for h in flags:
        h.remove()

    for i, m in enumerate(metrics):
        values = {k: float(v) for k, v in m.items()}
        check(all(np.isfinite(v) for v in values.values()), f"{name} step {i}: metrics {values}")
    check(not cfg.CASCADE_MODEL or set(CASCADE_G_TAGS) <= set(values),
          f"{name}: the cascade's metrics {CASCADE_G_TAGS} missing from {sorted(values)}")
    print("last step: " + ", ".join(f"{k} {v:.4f}" for k, v in values.items()))
    for k, per_step in expected.items():
        check(train_counts[k] == per_step * steps,
              f"{name} {k}: {train_counts[k]} launches in {steps} steps, expected {per_step} a step")
    print(f"launches in {steps} D+G steps: {train_counts}; per step from the code: {expected}")
    check(inside == {(False, False)} and torch.backends.cudnn.allow_tf32
          and torch.backends.cuda.matmul.allow_tf32,
          f"{name}: TF32 flags (cudnn, matmul) inside the steps {inside}")
    print(f"TF32 flags (cudnn, matmul) inside the steps {sorted(inside)}, global after "
          f"{torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32}")
    for n, net in nets.items():
        state_now = net.state_dict()
        still = [k for k, _ in net.named_parameters() if torch.equal(state_now[k], before[n][k])]
        still += [k for k, b in net.named_buffers()
                  if k.endswith(("running_mean", "running_var", "weight_u")) and b.numel() > 1
                  and torch.equal(b, before[n][k])]
        check(not still, f"{name} {n}: unchanged after {steps} steps: {still}")
    del before
    for n, net in nets.items():
        kept = [*net.parameters(), *(p.grad for p in net.parameters()),
                *(b for k, b in net.named_buffers()
                  if k.endswith(("running_mean", "running_var"))),
                *(v for st in state.opts[n].state.values() for v in st.values() if v.dim() > 0)]
        check(all(t.dtype == torch.float32 for t in kept),
              f"{name} {n}: a parameter, gradient, BN statistic or Adam moment is not float32")
    print("every parameter, BN running statistic and SN u (but the 1-element u of each "
          "1-output head conv, which stays ±1) moved; parameters, gradients, BN statistics "
          "and Adam moments float32")
    timed = times[WARMUP_STEPS:]
    med = sorted(timed)[len(timed) // 2]
    print(f"{name} D+G step [{card}]: {med * 1e3:.2f} ms median of {TIMED_STEPS} (min "
          f"{min(timed) * 1e3:.2f}, max {max(timed) * 1e3:.2f}), {1 / med:.3f} steps/s; warm-up "
          + ", ".join(f"{t * 1e3:.2f}" for t in times[:WARMUP_STEPS]) + " ms")
    print(f"{name} peak device memory over the steps {peak / 2**30:.2f} GiB [{card}]")

    def train_step():
        d_step(state, rng, st_batch, im_batch, LR_D)
        g_step(state, rng, st_batch, im_batch, LR_G)

    bn_calls_per_step = expected["bn_stats"] + expected["bn_grad_reduce"]
    # one call of each BN wrapper at each shape of the step, captured in a CUDA
    # graph: one kernel node and nothing else (no finish kernel, no memset)
    dtype = torch.bfloat16 if cfg.COMPUTE_DTYPE == "bfloat16" else torch.float32
    nodes = bn_graph_nodes(step_calls, dtype)
    check(all(n == {GRAPH_KERNEL_NODE: 1} for n in nodes.values()),
          f"{name}: a BN call's CUDA graph holds other than one kernel node: "
          f"{ {k: dict(n) for k, n in nodes.items() if n != {GRAPH_KERNEL_NODE: 1}} }")
    print(f"  one call of each BN wrapper at each of the step's {len(nodes)} (kernel, shape)s, "
          f"{dtype}, captured in a CUDA graph: one kernel node each")
    # the trace, for the busy time. Now and then it loses device events (one
    # to ~110 of the 9,000-16,000 of two steps; in some runs one BN kernel in
    # every trace, however often it is taken again), so the CUDA graph nodes
    # above hold the count of one kernel a call. A lost event only lowers the
    # trace's count: no trace may hold more, or a finish kernel
    dev_events, _ = trace(train_step, 2)
    bn_kernels = {}  # BN device kernels in the 2 traced steps, by name
    for e in dev_events:
        if any(f in e.name for f in ("reduce_maps", "reduce_rows", "finish(")):
            bn_kernels[e.name] = bn_kernels.get(e.name, 0) + 1
    traced = sum(bn_kernels.values())
    check(traced <= 2 * bn_calls_per_step and not any("finish(" in k for k in bn_kernels),
          f"{name}: 2 traced steps ran the BN device kernels {bn_kernels}: more than one "
          f"per call ({bn_calls_per_step} a step), or a finish")
    names = by_name(dev_events, 2)
    busy = sum(names.values()) / 1e3
    ours = {k: v for k, v in names.items()
            if any(f in k for f in ("reduce_maps", "reduce_rows", "finish(", "dfn_"))}
    print(f"  BN device kernels a step in the trace: {traced / 2:g} of {bn_calls_per_step} ("
          + "; ".join(f"{k[:60]} x{v / 2:g}" for k, v in bn_kernels.items()) + ")")
    print(f"{name} trace of 2 steps [{card}]: device busy {busy:.3f} ms a step in "
          f"{len(dev_events) / 2:.0f} ops, idle share {1 - busy / (med * 1e3):.3f}; top: "
          + "; ".join(f"{k[:70]} {v:.1f} us" for k, v in list(names.items())[:8]))
    print(f"  the port's kernels: {sum(ours.values()):.1f} us a step ("
          + "; ".join(f"{k[:50]} {v:.1f} us" for k, v in ours.items()) + ")")
    return types.SimpleNamespace(
        name=name, cfg=cfg, state=state, st_batch=st_batch, im_batch=im_batch, d_step=d_step,
        g_step=g_step, expected=expected, train_counts=train_counts, step_calls=step_calls,
        step_ms=med * 1e3, busy_ms=busy)


def step_spread(a, b):
    """(metrics: largest |a-b| / (|b| + 1e-3), accuracies aside;
    accuracies: largest |a-b|; gradients: largest ‖a-b‖ / ‖b‖; gradients
    that are 0 in exact arithmetic (‖b‖ under 1e-3 of the net's largest,
    the Linear biases before a train-mode BN): largest ‖a-b‖ / the net's
    largest ‖b‖; BN statistics: largest ‖a-b‖ / ‖b‖), and the tensors
    with the largest gradient errors."""
    m, m_key = max((abs(a[0][k] - b[0][k]) / (abs(b[0][k]) + 1e-3), k) for k in b[0]
                   if not k.startswith("Accuracy/"))
    acc = max(abs(a[0][k] - b[0][k]) for k in b[0] if k.startswith("Accuracy/"))
    largest = {}
    for (n, k), g in b[1].items():
        largest[n] = max(largest.get(n, 0.0), float(g.norm()))
    errs, zero_errs = [(0.0, None)], [(0.0, None)]
    for key, g in b[1].items():
        err, norm = float((a[1][key] - g).norm()), float(g.norm())
        if norm >= 1e-3 * largest[key[0]]:
            errs.append((err / norm, key))
        else:
            zero_errs.append((err / largest[key[0]], key))
    st = max(float((a[2][key] - v).norm()) / float(v.norm()) for key, v in b[2].items())
    errs.sort(key=lambda t: -t[0])
    worst_zero = max(zero_errs, key=lambda t: t[0])
    return ((m, acc, errs[0][0], worst_zero[0], st),
            ([(".".join(key), f"{e:.2e}") for e, key in errs[:5] if key], worst_zero[1],
             m_key))


def twin_step(run: types.SimpleNamespace, seed: int, hold: bool = True,
              noise=None, yard: bool = False) -> dict:
    """Phase 7 (17 at bfloat16): from one saved state and the same noise, one
    D+G step with the kernels against one with their plain versions swapped
    in (and one more with the kernels, which must give the same bits but for
    cuDNN), held to the float32 tolerances. At bfloat16 a float32 sum in
    another order can move a bfloat16 rounding, which the step carries on;
    so there the yardstick is four more plain steps whose BN sums run in
    other orders (as the JAX package's two BN arms differ): over the batch,
    over the map and over both in a seeded random order, and in float64
    rounded once, and the kernels may differ from the plain versions by
    three times the largest spread of any two of the five plain steps (ten
    pairs), or by the float32 tolerances. One pair of reversed sums, the
    yardstick before, once came out at a fifth of the kernels' spread:
    reversing a sum moves few of its last bits, and the chaotic step's
    spread is heavy-tailed. In float32 the yardstick holds too where the
    step carries the last-bit differences of the BN sums into the
    generator's gradients at the float32 gradient tolerance itself
    (`F32_YARDSTICK`): the story D's VideoEncoder, its eleven train-mode BNs
    (phase 21: 0.65-0.93 of it in two runs; on the CPU the port's own
    float32 seq-consistency G gradients lie up to 8e-3 from float64), and
    clevr.yml (phase 27: over 12 seeds, `tools/twin_spread.py` on an H100,
    the plain pairs' gradient spread ran 3.1e-3 to 1.27e-2, above 1e-2 in
    three, the kernels' 0.5-1.1 times it; 1.15e-5 against the zero
    gradients' 1e-5 in one). Returns the readings, the kernels' step among
    them (each step's metrics, gradients, BN statistics and state
    checksums); `hold` False prints them and holds nothing. `noise` is the D
    and the G step's draws (default: drawn from seed + 1); `yard` asks for
    the yardstick whatever the config (phase 29 holds the data-parallel step
    to it)."""
    import torch

    from cpcsv_tpu_torch.models import generator as generator_module
    from cpcsv_tpu_torch.ops import batchnorm
    from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda
    from cpcsv_tpu_torch.ops.dynamic_filter import dynamic_filter_conv1d_plain
    from cpcsv_tpu_torch.train.state import state_checksums

    state, cfg = run.state, run.cfg
    nets = state.nets()
    b_st, b_im = cfg.TRAIN.ST_BATCH_SIZE, cfg.TRAIN.IM_BATCH_SIZE
    saved = save_twin(state)
    if noise is None:
        g_noise = torch.Generator(device="cuda").manual_seed(seed + 1)
        noise = [(state.gen.draw_noise(b_st, cfg.VIDEO_LEN, g_noise),
                  state.gen.draw_noise(b_im, 1, g_noise)) for _ in range(2)]

    def plain_patches(reorder=None):
        """The plain versions; with `reorder` (REORDERINGS), their BN sums over
        the dimensions of (N, C, S) it names in a seeded random order, or in
        float64 and rounded to float32 once."""
        def order(t):
            for d in () if reorder in (None, "float64") else reorder:
                gen = torch.Generator(device=t.device).manual_seed(t.shape[d])
                t = t.index_select(d, torch.randperm(t.shape[d], generator=gen,
                                                     device=t.device))
            return t.double() if reorder == "float64" else t

        def stats(x):
            return tuple(v.float() for v in bn_cuda.bn_stats_plain(order(x)))

        def grad_reduce(x, dy, m, i):
            wide = reorder == "float64"
            return tuple(v.float() for v in bn_cuda.bn_grad_reduce_plain(
                order(x), order(dy), m.double() if wide else m, i.double() if wide else i))

        return (mock.patch.object(batchnorm, "bn_stats", stats),
                mock.patch.object(batchnorm, "bn_grad_reduce", grad_reduce),
                mock.patch.object(generator_module, "dynamic_filter_conv1d",
                                  dynamic_filter_conv1d_plain))

    def twin(patches):
        restore_twin(state, saved)
        with contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            _, dm = run.d_step(state, noise[0], run.st_batch, run.im_batch, LR_D)
            _, gm = run.g_step(state, noise[1], run.st_batch, run.im_batch, LR_G)
        return ({k: float(v) for k, v in {**dm, **gm}.items()},
                {(n, k): p.grad.detach().clone() for n, net in nets.items()
                 for k, p in net.named_parameters()},
                {(n, k): b.detach().clone() for n, net in nets.items()
                 for k, b in net.named_buffers() if k.endswith(("running_mean", "running_var"))},
                state_checksums(state).cpu().numpy())

    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # cuDNN's backward would add its own spread
    bf16 = cfg.COMPUTE_DTYPE == "bfloat16"
    yard = yard or bf16 or cfg.USE_SEQ_CONSISTENCY or run.name in F32_YARDSTICK
    try:
        kern, kern_again, ref = twin(()), twin(()), twin(plain_patches())
        reordered = [twin(plain_patches(dims)) for dims in REORDERINGS] if yard else []
    finally:
        torch.backends.cudnn.deterministic = saved_det
    (self_spread, _), (twin_spread, worst) = step_spread(kern_again, kern), step_spread(kern, ref)
    # float32, the kernels sum in other orders than the plain versions; the
    # step carries those last-bit differences through BN
    # divisions and two backward passes. The gradients of the motion GRU's
    # path (m_net -> recurrent) amplify them most: 4.1e-3 on the card, while
    # a wrong reduction or DFN backward moves a gradient by O(1). An accuracy
    # counts labels: 0.01 is two of the ~240 positive labels of IM_BATCH 90
    # flipping at p = 0.5.
    tols, yardstick = (1e-4, 1e-2, 1e-2, 1e-5, 1e-4), None
    if yard:
        pairs = [step_spread(a, b) for a, b in itertools.combinations([ref, *reordered], 2)]
        yardstick = [max(ys) for ys in zip(*(p[0] for p in pairs))]
        tols = tuple(max(t, 3 * y) for t, y in zip(tols, yardstick))
        print(f"{run.name}: {'bfloat16' if bf16 else 'float32'} yardstick, the plain step and "
              f"{len(reordered)} with the BN sums reordered ({REORDERINGS}: seeded random "
              f"orders over those dimensions of (N, C, S), or float64), the largest spread of "
              f"the {len(pairs)} pairs: "
              + ", ".join(f"{y:.3e}" for y in yardstick)
              + "; tolerances three times that or the float32 ones; the pairs' metric spreads "
              + ", ".join(f"{p[0][0]:.2e} ({p[1][2]})" for p in pairs))
    print(f"{run.name}: " + "kernels vs plain versions, one D+G step from one state and noise: largest metric "
          "error {:.3e} (tol {:g}), accuracy {:.3e} (tol {:g}), gradient {:.3e} (tol {:g}), "
          "zero gradient {:.3e} (tol {:g}), BN statistics {:.3e} (tol {:g}); worst gradients, "
          "relative and zero: "
          "{}; kernels vs kernels: {:.3e}, {:.3e}, {:.3e}, {:.3e}, {:.3e}".format(
              *(x for pair in zip(twin_spread, tols) for x in pair), worst, *self_spread))
    if hold:
        check(all(e <= t for e, t in zip(twin_spread, tols)),
              f"{run.name}: kernels vs plain step spread {twin_spread} above {tols}")
    return {"kernels_vs_plain": twin_spread, "tolerances": tols, "yardstick": yardstick,
            "kernels_vs_kernels": self_spread, "kernels": kern}



def rel_l2(a, ref) -> float:
    """Relative L2 distance of numpy array `a` from `ref`."""
    import numpy as np

    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


def set_lowering(net, fused: str) -> None:
    """Every UpBlock of a generator to lowering `fused` (the parameters are
    the same in all four)."""
    from cpcsv_tpu_torch.ops.blocks import UpBlock

    for mod in net.modules():
        if isinstance(mod, UpBlock):
            mod.fused = fused


def shard_devices() -> tuple[list, str]:
    """Phase 36's eval mesh: every local card, or cuda:0 listed twice on a
    host of one card (the split's code path, two replicas on one card), and
    which of the two it is."""
    import torch

    count = torch.cuda.device_count()
    if count > 1:
        return [torch.device("cuda", i) for i in range(count)], f"the host's {count} cards"
    return [torch.device("cuda", 0)] * 2, "cuda:0 listed twice (a host of one card)"


def call_ms(infer, batch, calls: int = 5) -> float:
    """ms of `infer.sample_videos_np(batch)`, the median of `calls` after 2
    warm-ups (a new key's first call eager and captured)."""
    for _ in range(2):
        infer.sample_videos_np(batch)
    times = []
    for _ in range(calls):
        t = time.perf_counter()
        infer.sample_videos_np(batch)
        times.append(time.perf_counter() - t)
    return median(times) * 1e3


def sharded_serving(card: str, seed: int) -> dict:
    """Phase 36: eval-mode generation split over an eval mesh
    (`parallel/mesh.py:make_eval_mesh`, `evaluation/sampling.py`) through
    `Infer`, SHARD_CONFIGS (final.yml at float32, procedural.yml at
    bfloat16) at full published width, STORY_SIZES stories a call, over
    `shard_devices()` (a size the mesh does not divide, 18 over 4 cards, runs
    whole, the unsplit call's bits). Under cudnn.deterministic, two calls a
    size: each block's first call eager and captured on its device, the
    second a replay; each block bit for bit an eager one-device call of the lead's
    net on its rows and its slice of the whole batch's noise; the gathered
    frames against the unsplit call from the same generator
    state, which both leave alike (float32: max |difference| within
    SHARD_F32_BOUND; bfloat16: relative L2 within SHARD_BF16_BOUND); two
    planted faults in a size's first call outside those bounds: each block
    given the next block's noise slice, and the blocks after the first run
    by a replica SHARD_STALE_STEP a parameter away from the lead (a stale
    snapshot); DFN launches equal to blocks x calls; one DFN kernel node in
    each replica's graph. Then ms a call split and
    unsplit at the default flags, and with several cards ms at 72 stories
    over 1, 2 and 4 of them. Returns {"launches", "bf16_launches", "ms"}."""
    import numpy as np
    import torch

    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.data.synthetic import SyntheticStoryDataset, story_batches
    from cpcsv_tpu_torch.device import float32_math
    from cpcsv_tpu_torch.evaluation import sampling
    from cpcsv_tpu_torch.evaluation.drivers import Infer, _batch_motion_content

    devices, how = shard_devices()
    out = {"launches": 0, "bf16_launches": 0, "ms": {}}
    print(f"phase 36: the eval mesh spans {how}")
    for name in SHARD_CONFIGS:
        cfg = config_from_file(name)
        batches = {n: next(story_batches(SyntheticStoryDataset(n, seed=seed), n))
                   for n in STORY_SIZES}
        state = random_generator_state(cfg, batches[STORY_SIZES[-1]], seed)
        one = Infer(cfg, state, device="cuda", seed=seed, devices=devices[:1])
        many = Infer(cfg, state, device="cuda", seed=seed, devices=devices)
        shards = len(many.mesh)
        check(shards == len(devices), f"{name}: {shards} blocks for {len(devices)} devices")
        # blocks a call: a size the mesh does not divide runs whole (the JAX rule)
        split = {n: shards if n % shards == 0 else 1 for n in STORY_SIZES}
        bf16 = cfg.COMPUTE_DTYPE == "bfloat16"
        stale = copy.deepcopy(many.net_g)  # a replica left on the last snapshot
        rng = torch.Generator(device="cuda").manual_seed(seed + 1)
        with torch.no_grad():
            for p in stale.parameters():
                p.add_(SHARD_STALE_STEP * torch.randn(p.shape, generator=rng, device=p.device).sign())
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            got, before, after = {}, {}, {}
            reset_counts()  # the main path: the split calls through Infer
            for n, batch in batches.items():
                for call in range(2):
                    before[n, call] = many.generator.get_state()
                    got[n, call], _ = many.sample_videos_np(batch)
                    after[n, call] = many.generator.get_state()
            counts, sampled = read_counts(), sampler_calls()
            calls, blocks = len(got), 2 * sum(split.values())
            check(counts["dfn_forward"] == blocks and counts["dfn_backward"] == 0
                  and counts["bn_stats"] == counts["bn_grad_reduce"] == 0,
                  f"{name}: {calls} calls in {blocks} blocks ({split}) launched {counts}")
            keys = blocks // 2
            check(sampled == {"eager": keys, "captured": keys, "replayed": keys},
                  f"{name}: sampler calls {sampled}, expected each block's first call at a "
                  f"size eager and captured ({keys}), its second a replay")
            nets = sampling.replicas_of(many.net_g).of(many.net_g, many.mesh)
            nodes = []
            for net in nets:
                for graph in sampling.cache_of(net).graphs.graphs.values():
                    names = kernel_node_names(graph.graph)
                    nodes.append(len(names))
                    check(sum("dfn_forward_kernel" in k for k in names) == 1,
                          f"{name}: a replica's graph holds "
                          f"{sum('dfn_forward_kernel' in k for k in names)} DFN kernel nodes")
            worst, held, faults = {}, {}, {}
            for (n, call), frames in got.items():
                many.generator.set_state(before[n, call])
                motion, content = (torch.from_numpy(a).cuda()
                                   for a in _batch_motion_content(cfg, batches[n]))
                noise = many.net_g.draw_noise(n, cfg.VIDEO_LEN, many.generator)
                rows = n // split[n]
                planted = {"the next block's noise": [], "a stale replica": []}
                for k in range(split[n]):
                    block = slice(k * rows, (k + 1) * rows)
                    nxt = slice((k + 1) % split[n] * rows, ((k + 1) % split[n] + 1) * rows)
                    with torch.no_grad(), float32_math():
                        ref = many.net_g.sample_videos(
                            motion[block], content[block],
                            noise=tuple(t[block] for t in noise)).image.float().cpu().numpy()
                        if call == 0 and split[n] > 1:  # the planted faults
                            planted["the next block's noise"].append(many.net_g.sample_videos(
                                motion[block], content[block],
                                noise=tuple(t[nxt] for t in noise)).image.float().cpu().numpy())
                            planted["a stale replica"].append(ref if k == 0 else stale.sample_videos(
                                motion[block], content[block],
                                noise=tuple(t[block] for t in noise)).image.float().cpu().numpy())
                    check(np.array_equal(frames[block], ref),
                          f"{name} {n} stories, call {call}: block {k} differs from an eager "
                          f"one-device call on its rows by {float(abs(frames[block] - ref).max())}")
                one.generator.set_state(before[n, call])
                whole, _ = one.sample_videos_np(batches[n])
                check(torch.equal(one.generator.get_state(), after[n, call]),
                      f"{name} {n} stories: the split and the unsplit call left the generator "
                      "apart")
                check(whole.shape == frames.shape and bool(np.isfinite(frames).all()),
                      f"{name} {n} stories: frames {frames.shape}, unsplit {whole.shape}")
                worst[n, call] = float(abs(frames - whole).max())
                if split[n] == 1:  # run whole: the unsplit call's bits
                    held[n, call] = (worst[n, call], 0.0)
                    check(worst[n, call] == 0, f"{name} {n} stories, run whole: "
                                               f"{worst[n, call]:.3e} from one device's call")
                    continue
                # float32 in max |difference|, bfloat16 in relative L2
                reading = (lambda a: rel_l2(a, whole)) if bf16 else (
                    lambda a: float(abs(a - whole).max()))
                bound = SHARD_BF16_BOUND if bf16 else SHARD_F32_BOUND
                held[n, call] = (reading(frames), bound)
                check(held[n, call][0] <= bound, f"{name} {n} stories: split frames "
                      f"{held[n, call][0]:.3e} from the unsplit call's, above {bound}")
                for kind, blocks_of in planted.items():
                    if blocks_of:
                        fault = np.concatenate(blocks_of)
                        faults[n, kind] = (reading(fault), float(abs(fault - whole).max()),
                                           rel_l2(fault, whole))
                        check(faults[n, kind][0] > bound, f"{name} {n} stories: {kind} reads "
                              f"{faults[n, kind][0]:.3e}, within the bound {bound}")
        finally:
            torch.backends.cudnn.deterministic = saved
        out["launches"] += counts["dfn_forward"]
        if cfg.COMPUTE_DTYPE == "bfloat16":
            out["bf16_launches"] += counts["dfn_forward"]
        print(f"{name} {cfg.COMPUTE_DTYPE} split over {how} [{card}]: {calls} calls of "
              f"{', '.join(map(str, STORY_SIZES))} stories, blocks by stories {split}; each block "
              "bit for bit an eager one-device call on its rows and noise slice "
              "(cudnn.deterministic); split against unsplit by (stories, call), "
              + ("relative L2 / bound: " if bf16 else "max |difference| / bound: ")
              + ", ".join(f"{k}: {v:.3e} / {t:.3e}" for k, (v, t) in held.items())
              + "; max |difference| " + ", ".join(f"{k}: {v:.3e}" for k, v in worst.items())
              + f"; planted faults (a stale replica: {SHARD_STALE_STEP} a parameter): "
              + ", ".join(f"{n} stories, {kind}: max |difference| {m:.3e}, relative L2 {r:.3e}"
                          for (n, kind), (_, m, r) in faults.items())
              + f"; the generator left alike; dfn_forward {counts['dfn_forward']} "
              f"= the blocks of {calls} calls; sampler {sampled}; kernel nodes a replica's graph {nodes}, "
              "one dfn_forward_kernel in each")
        for n, batch in batches.items():
            split, whole = call_ms(many, batch), call_ms(one, batch)
            out["ms"][name, n] = {"split": split, "whole": whole}
            print(f"{name} {n} stories [{card}]: split over {how} {split:.2f} ms a call "
                  f"({n * cfg.VIDEO_LEN / split * 1e3:.1f} frames/s) against one device "
                  f"{whole:.2f} ms ({n * cfg.VIDEO_LEN / whole * 1e3:.1f} frames/s), median of 5")
        del one, many, stale
        if torch.cuda.device_count() > 1:  # frames/s at 1, 2 and 4 cards
            n = STORY_SIZES[-1]
            for m in (1, 2, 4):
                if m <= torch.cuda.device_count():
                    infer = Infer(cfg, state, device="cuda", seed=seed, devices=devices[:m])
                    ms = call_ms(infer, batches[n])
                    out["ms"][name, n, m] = ms
                    print(f"{name} {n} stories over {m} card(s) [{card}]: {ms:.2f} ms a call, "
                          f"{n * cfg.VIDEO_LEN / ms * 1e3:.1f} frames/s")
                    del infer
        del state
        torch.cuda.empty_cache()
    return out


def bf16_serving(card: str, seed: int) -> dict:
    """Phase 15: story generation at COMPUTE_DTYPE bfloat16 through `Infer`,
    configs throughput.yml (v1) and procedural.yml (cascade), at 18 and 72
    stories, random weights from `seed` with BN statistics calibrated then
    perturbed: float32 numpy frames, finite in [-1, 1]; the DFN forward's
    launches; each lowering's frames and time for a call of 72 stories on
    the same weights and noise, whose spread (bfloat16 rounding alone) is the
    yardstick of the relative L2 to the float32 frames of the same weights
    and noise, and to the frames through the plain DFN; frames/s, device
    busy time and idle share.
    Every call after the first at a key replays its CUDA graph, bit for bit
    eager `sample_videos` (`replays_match_eager`); the plain DFN runs
    eagerly.
    Returns {"launches": dfn_forward launches, "lowering_ms": {config: {fused: ms}},
    "fps": {(config, stories): frames/s}, "ms": {(config, stories): `serving_times`},
    "nodes": {config: kernel nodes by stories}}."""
    import numpy as np
    import torch

    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.data.synthetic import SyntheticStoryDataset, story_batches
    from cpcsv_tpu_torch.evaluation.drivers import Infer
    from cpcsv_tpu_torch.models import generator as generator_module
    from cpcsv_tpu_torch.ops.blocks import FUSED_UPSAMPLE
    from cpcsv_tpu_torch.ops.dynamic_filter import dynamic_filter_conv1d_plain

    out = {"launches": 0, "lowering_ms": {}, "fps": {}, "ms": {}, "nodes": {}}
    for name in BF16_CONFIGS:
        cfg = config_from_file(name)
        check(cfg.COMPUTE_DTYPE == "bfloat16", f"{name}: COMPUTE_DTYPE {cfg.COMPUTE_DTYPE}")
        batches = {n: next(story_batches(SyntheticStoryDataset(n, seed=seed), n))
                   for n in STORY_SIZES}
        state = random_generator_state(cfg, batches[STORY_SIZES[-1]], seed)
        infer = Infer(cfg, state, device="cuda", seed=seed)
        f32 = Infer(cfg.with_updates(COMPUTE_DTYPE="float32"), state, device="cuda", seed=seed)
        check(infer.net_g.dtype == torch.bfloat16 and all(
            p.dtype == torch.float32 for p in infer.net_g.parameters()),
              f"{name}: the generator computes in {infer.net_g.dtype}")
        rng_states, videos = {}, {}
        reset_counts()  # the main path: the entry point only
        for n, batch in batches.items():
            rng_states[n] = infer.generator.get_state()
            videos[n], _ = infer.sample_videos_np(batch)
        counts = read_counts()
        check(counts["dfn_forward"] == len(batches) and counts["dfn_backward"] == 0
              and counts["bn_stats"] == counts["bn_grad_reduce"] == 0,
              f"{name}: bfloat16 serving launched {counts} in {len(batches)} calls")
        out["launches"] += counts["dfn_forward"]
        out["nodes"][name] = replays_match_eager(infer, batches, f"{name} bfloat16")
        # each lowering on the same weights and noise, timed at 72 stories:
        # they compute one function and differ by bfloat16 rounding alone, so
        # their spread is the yardstick of bfloat16's distance from float32
        n = STORY_SIZES[-1]
        lowered, out["lowering_ms"][name] = {}, {}
        for fused in FUSED_UPSAMPLE:
            set_lowering(infer.net_g, fused)
            infer.generator.set_state(rng_states[n])
            lowered[fused], _ = infer.sample_videos_np(batches[n])
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t = time.perf_counter()
                infer.sample_videos_np(batches[n])
                times.append(time.perf_counter() - t)
            out["lowering_ms"][name][fused] = sorted(times)[2] * 1e3
        set_lowering(infer.net_g, cfg.FUSED_UPSAMPLE)
        check(np.array_equal(lowered[cfg.FUSED_UPSAMPLE], videos[n]),
              f"{name}: the same weights and noise gave other frames")
        spread = {f: rel_l2(v, videos[n]) for f, v in lowered.items()}
        # the lowerings round differently in the trunks' upsample convs only;
        # against float32 every layer rounds: three times their spread
        tol = 3 * max(spread.values())
        print(f"{name} bfloat16 serving, {n} stories a call, by FUSED_UPSAMPLE [{card}]: "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in out["lowering_ms"][name].items())
              + f"; relative L2 of each lowering's frames to {cfg.FUSED_UPSAMPLE}'s: "
              + ", ".join(f"{k} {v:.3e}" for k, v in spread.items()))
        for n, video in videos.items():
            check(video.dtype == np.float32 and video.shape == (n, cfg.VIDEO_LEN, 64, 64, 3),
                  f"{name}: bfloat16 serving gave {video.dtype} {video.shape}")
            check(bool(np.isfinite(video).all() and (np.abs(video) <= 1).all()),
                  f"{name}: bfloat16 frames not finite in [-1, 1]")
            f32.generator.set_state(rng_states[n])
            ref, _ = f32.sample_videos_np(batches[n])
            rel = rel_l2(video, ref)
            infer.generator.set_state(rng_states[n])
            with mock.patch.object(generator_module, "dynamic_filter_conv1d",
                                   dynamic_filter_conv1d_plain):
                plain, _ = eager_np(infer, batches[n])  # a replay would not see the patch
            diff = rel_l2(plain, video)
            print(f"{name} bfloat16: {n} stories -> {video.shape} float32 numpy, |frame| mean "
                  f"{abs(video).mean():.4f} max {abs(video).max():.4f}; relative L2 to the "
                  f"float32 frames of the same weights and noise {rel:.3e}, to the plain DFN's "
                  f"{diff:.3e} (tol three times the lowerings' spread, {tol:.3e})")
            # bfloat16 against float32: the rounding the lowerings' spread
            # shows, at every layer. The kernel and the plain DFN round the
            # same float32 sums, summed in other orders, to bfloat16; where
            # one rounds the other way, the trunks carry that as the
            # lowerings carry theirs.
            check(rel <= tol, f"{name} {n} stories: bfloat16 frames {rel:.3e} from float32")
            check(diff <= tol, f"{name} {n} stories: kernel vs plain DFN frames {diff:.3e} apart")
        for n, batch in batches.items():
            out["ms"][name, n] = serving_times(infer, batch, n, f"{name} bfloat16: {n} stories",
                                               card)
            out["fps"][name, n] = n * cfg.VIDEO_LEN / out["ms"][name, n]["graphed"]["ms"] * 1e3
        print(f"{name}: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"[{card}]")
        del infer, f32, state
        torch.cuda.empty_cache()
    return out


def lowering_steps(run: types.SimpleNamespace, card: str) -> dict:
    """Phase 16's lowerings: each FUSED_UPSAMPLE in turn on the generator of a
    phase 6 record, one warm-up and 3 timed D+G steps (host clock between
    synchronises), the launches checked against the per-step count; the
    config's own lowering restored after. Returns {fused: ms a step}."""
    import torch

    from cpcsv_tpu_torch.ops.blocks import FUSED_UPSAMPLE

    state, cfg = run.state, run.cfg
    rng = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for fused in FUSED_UPSAMPLE:
        set_lowering(state.gen, fused)
        reset_counts()  # the main path: the steps only
        times = []
        for i in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run.d_step(state, rng, run.st_batch, run.im_batch, LR_D)
            run.g_step(state, rng, run.st_batch, run.im_batch, LR_G)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        counts = read_counts()
        check(counts == {k: 4 * v for k, v in run.expected.items()},
              f"{run.name} {fused}: launches {counts} in 4 steps, {run.expected} a step")
        out[fused] = sorted(times[1:])[1] * 1e3
    set_lowering(state.gen, cfg.FUSED_UPSAMPLE)
    frames = cfg.TRAIN.ST_BATCH_SIZE * cfg.VIDEO_LEN + cfg.TRAIN.IM_BATCH_SIZE
    print(f"{run.name} D+G step by FUSED_UPSAMPLE [{card}], median of 3 after a warm-up: "
          + ", ".join(f"{k} {v:.2f} ms ({frames / v * 1e3:.1f} frames/s)" for k, v in out.items()))
    return out


def cli_epoch(card: str, name: str, data: list, per_step: dict[str, int], steps,
              tags: set, seed: int, root: Path) -> tuple[dict[str, int], Path]:
    """Phases 19-20 and 24: one epoch of config `name` (a shipped config, or
    a variant's YAML path) through the port's CLI in this process, in a
    working directory under `root`, on `data` (the CLI's --synthetic or
    --data_dir arguments): the launches against the D+G steps (`steps`, or
    as many as the story-D metrics logged, one a step) and the sample grid,
    finite metrics under `tags`, the snapshots of epochs 0 and 1 and the full
    state, float32, and netD_se only with a seg D; frames/s and the epoch's
    seconds. Returns the launches and the run directory, which the caller's
    temporary `root` holds."""
    import numpy as np
    import torch

    from cpcsv_tpu_torch.cli import main_pororo
    from cpcsv_tpu_torch.config import config_from_file

    cfg_file = name if os.path.isabs(name) else str(REPO / "cpcsv_tpu_torch" / "configs" / name)
    name = Path(name).name
    cfg = config_from_file(cfg_file)
    run_root = root / f"cli_{cfg.CONFIG_NAME}"
    run_root.mkdir(parents=True)
    printed = io.StringIO()
    cwd = os.getcwd()
    os.chdir(run_root)
    try:
        with contextlib.redirect_stdout(printed):
            reset_counts()  # the main path: the CLI only
            t = time.perf_counter()
            main_pororo.main(["--cfg", cfg_file, *data, "--max_epoch", "1",
                              "--manualSeed", str(seed)])
            run_s = time.perf_counter() - t
            counts = read_counts()
    finally:
        os.chdir(cwd)
    lines = [line for line in printed.getvalue().splitlines() if line.startswith("----[")]
    print(f"{name} CLI output [{card}]:\n  " + "\n  ".join(lines))
    run_dir = run_root / "output" / "torch" / cfg.CONFIG_NAME
    model = run_dir / "Model"
    for f in ("netG_epoch_0.pth", "netG_epoch_1.pth", "train_state_last.pth",
              "netD_im_epoch_last.pth", "netD_st_epoch_last.pth", "netD_se_epoch_last.pth"):
        wanted = f != "netD_se_epoch_last.pth" or cfg.SEGMENT_LEARNING
        check((model / f).is_file() == wanted,
              f"the {name} run wrote {model / f}: {(model / f).is_file()}, expected {wanted}")
    snapshot = torch.load(model / "netG_epoch_1.pth", weights_only=True)
    check(all(v.dtype == torch.float32 for v in snapshot.values() if v.is_floating_point()),
          f"{name}: the snapshot holds other than float32")
    records = [json.loads(line) for line in (run_dir / "log" / "metrics.jsonl").open()]
    found = {r["tag"] for r in records}
    check(all(np.isfinite(r["value"]) for r in records),
          f"{name}: metrics.jsonl holds a non-finite value")
    check(found == tags, f"{name}: metrics.jsonl tags {sorted(found)}: missing {tags - found}, "
          f"extra {found - tags}")
    logged = sum(r["tag"] == "st_D/loss" for r in records)  # one a step
    steps = steps or logged
    check(logged == steps, f"{name}: {logged} steps logged, expected {steps}")
    expected = {k: v * steps for k, v in per_step.items()}
    expected["dfn_forward"] += 1
    check(counts == expected, f"{name} CLI: launches {counts}, expected {expected} for {steps} "
                              "steps and a sample grid")
    fps = next(r["value"] for r in records if r["tag"] == "perf/frames_per_sec")
    epoch_s = next(r["value"] for r in records if r["tag"] == "perf/epoch_seconds")
    print(f"{name} CLI epoch 0 [{card}]: {steps} D+G steps and a sample grid launched {counts}; "
          f"{fps:.1f} frames/s (perf/frames_per_sec), {epoch_s:.2f} s; {run_s:.2f} s in all, "
          "state init and checkpoints included")
    return counts, run_dir


def cli_trainer(card: str, per_step: dict[str, int], seed: int) -> dict[str, int]:
    """Phase 10: the port's training CLI in this process, on the card, at
    full width: `cascade.yml --synthetic CLI_SYNTHETIC --max_epoch 1`, then
    `--max_epoch 2 --continue_ckpt auto` under a torch.profiler trace, in a
    run directory under build/ that it removes after. Checks the resume, the
    artifacts and the kernels' launches against the steps and sample grids
    run; prints each epoch's frames/s, its steps' time on the host clock and
    the wait for their first batches, the idle share of the traced epoch's
    steps and the checkpoint write times. Returns the launches."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cpcsv_tpu_torch.cli import main_pororo
    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.train import trainer as trainer_module
    from cpcsv_tpu_torch.train.checkpoint import CheckpointManager
    from cpcsv_tpu_torch.train.trainer import EPOCH_STEPS_SPAN

    cfg_file = str(REPO / "cpcsv_tpu_torch" / "configs" / "cascade.yml")
    cfg = config_from_file(cfg_file)
    run_root = REPO / "build" / "chip_smoke_cli"
    if run_root.exists():
        shutil.rmtree(run_root)
    run_root.mkdir(parents=True)
    run_dir = run_root / "output" / "torch" / cfg.CONFIG_NAME
    args = ["--cfg", cfg_file, "--synthetic", str(CLI_SYNTHETIC), "--manualSeed", str(seed)]
    steps_an_epoch = max(CLI_SYNTHETIC, cfg.TRAIN.ST_BATCH_SIZE) // cfg.TRAIN.ST_BATCH_SIZE
    saves = []  # (epoch, seconds) of each CheckpointManager.save
    real_save = CheckpointManager.save

    def timed_save(self, state, epoch, completed=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real_save(self, state, epoch, completed)
        saves.append((epoch, time.perf_counter() - t))

    # host clock: each epoch's steps, from the start of the loop to the last
    # step's metrics read back, and the wait before its first update (its
    # first chunk's, at the config's SCAN_STEPS)
    starts, spans, waits = [], [], []
    real_span = trainer_module.record_function

    @contextlib.contextmanager
    def timed_span(name):
        starts.append(time.perf_counter())
        with real_span(name):
            yield
        spans.append(time.perf_counter() - starts[-1])

    def first_wait(pairs):
        if len(waits) < len(starts):
            waits.append(time.perf_counter() - starts[-1])

    printed = io.StringIO()  # the CLI's output; its config dump is left out below
    cwd = os.getcwd()
    os.chdir(run_root)  # the CLI writes under ./output/torch/
    try:
        with mock.patch.object(CheckpointManager, "save", timed_save), \
                mock.patch.object(trainer_module, "record_function", timed_span), \
                spying_updates([], first_wait), contextlib.redirect_stdout(printed):
            reset_counts()  # the main path: the CLI only
            t = time.perf_counter()
            main_pororo.main(args + ["--max_epoch", "1"])
            first_s = time.perf_counter() - t
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                main_pororo.main(args + ["--max_epoch", "2", "--continue_ckpt", "auto"])
                torch.cuda.synchronize()
            counts = read_counts()
    finally:
        os.chdir(cwd)
    lines = [line for line in printed.getvalue().splitlines()
             if line.startswith(("----[", "Auto-resume", "Continue", "LR DECAY", "SCAN_STEPS"))]
    print(f"CLI output [{card}] (config dumps left out):\n  " + "\n  ".join(lines))
    check("Auto-resume from epoch 1" in lines,
          "the second CLI run did not print 'Auto-resume from epoch 1'")
    check(f"SCAN_STEPS {cfg.SCAN_STEPS}: each chunk's pairs replayed as a CUDA graph of the D+G "
          "pair" in lines, "the CLI did not say that its chunks replay a CUDA graph")

    model = run_dir / "Model"
    for f in ("netG_epoch_0.pth", "netG_epoch_1.pth", "netG_epoch_2.pth", "train_state_last.pth",
              "netD_im_epoch_last.pth", "netD_st_epoch_last.pth", "netD_se_epoch_last.pth"):
        check((model / f).is_file(), f"the CLI runs wrote no {model / f}")
    check((model / "last_epoch.txt").read_text().strip() == "1",
          f"last_epoch.txt holds {(model / 'last_epoch.txt').read_text()!r}, expected 1")
    for png in ("pororo_00000.png", "pororo_00001.png", "segment_00000.png"):
        check((run_dir / "log" / png).is_file(), f"no sample grid {png}")
    records = [json.loads(line) for line in (run_dir / "log" / "metrics.jsonl").open()]
    tags = {r["tag"] for r in records}
    check(all(np.isfinite(r["value"]) for r in records), "metrics.jsonl holds a non-finite value")
    check(tags == set(CASCADE_TAGS), f"metrics.jsonl tags {sorted(tags)} differ from the JAX "
          f"package's cascade set: missing {set(CASCADE_TAGS) - tags}, extra {tags - set(CASCADE_TAGS)}")
    fps = {r["step"]: r["value"] for r in records if r["tag"] == "perf/frames_per_sec"}
    epoch_s = {r["step"]: r["value"] for r in records if r["tag"] == "perf/epoch_seconds"}

    # 2 epochs of steps_an_epoch D+G steps, and an eval-mode sample grid an
    # epoch (one DFN forward, eval BN)
    steps = 2 * steps_an_epoch
    expected = {k: v * steps for k, v in per_step.items()}
    expected["dfn_forward"] += 2
    check(counts == expected, f"CLI runs: launches {counts}, expected {expected} for {steps} "
                              "steps and 2 sample grids")
    print(f"CLI runs: {steps} D+G steps and 2 sample grids launched {counts} = {per_step} a "
          "step, plus one dfn_forward a grid")

    # the traced (second) run: the card's busy time inside its epoch's steps
    span = [e for e in prof.profiler.kineto_results.events()
            if e.name() == EPOCH_STEPS_SPAN and e.device_type() == DeviceType.CPU]
    check(len(span) == 1, f"{len(span)} '{EPOCH_STEPS_SPAN}' ranges in the trace of one epoch")
    start = span[0].start_ns() / 1e3  # µs
    end = start + span[0].duration_ns() / 1e3
    busy = sum(b - a for a, b in raw_device_spans(prof) if start <= a / 1e3 and b / 1e3 <= end) / 1e3
    check(busy > 0, "the trace holds no device work inside the epoch's steps")
    sizes = {f: (model / f).stat().st_size / 2**20 for f in ("netG_epoch_2.pth",
                                                             "train_state_last.pth")}
    check(len(spans) == len(waits) == 2,
          f"{len(spans)} epochs' steps timed in 2 CLI runs of one epoch each")
    frames = steps_an_epoch * (cfg.TRAIN.ST_BATCH_SIZE * cfg.VIDEO_LEN + cfg.TRAIN.IM_BATCH_SIZE)
    print(f"CLI epoch 0 [{card}]: {fps[0]:.1f} frames/s, {epoch_s[0]:.2f} s for "
          f"{steps_an_epoch} steps and the sample grid; the steps alone {spans[0] * 1e3:.2f} ms "
          f"({frames / spans[0]:.1f} frames/s), of which {waits[0] * 1e3:.2f} ms before the "
          f"first step had its batches (epoch 1: {waits[1] * 1e3:.2f} ms); first run "
          f"{first_s:.2f} s in all, state init and checkpoints included")
    print(f"CLI epoch 1 under torch.profiler [{card}]: {fps[1]:.1f} frames/s; its steps span "
          f"{(end - start) / 1e3:.2f} ms traced ({spans[1] * 1e3:.2f} ms on the host clock), "
          f"device busy {busy / 1e3:.2f} ms: idle share {1 - busy / (end - start):.3f} of the "
          f"traced span, {1 - busy / (spans[0] * 1e6):.3f} of epoch 0's untraced steps")
    print(f"checkpoint writes [{card}]: " + ", ".join(f"epoch {e} {s:.2f} s" for e, s in saves)
          + f"; netG_epoch_2.pth {sizes['netG_epoch_2.pth']:.1f} MiB, train_state_last.pth "
          f"{sizes['train_state_last.pth']:.1f} MiB")
    shutil.rmtree(run_root)  # ~2.5 GB of checkpoints
    return counts


def timing(buckets: dict, key: str, fn):
    """`fn`, adding the host seconds of each call to buckets[key] (a list;
    appends are safe from the loaders' threads)."""
    def timed(*args, **kwargs):
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            buckets.setdefault(key, []).append(time.perf_counter() - t)

    return timed


def frechet_by_eigenvalues(mu1, sigma1, mu2, sigma2) -> float:
    """The Frechet distance of `evaluation/frechet.py`, |mu1 − mu2|² +
    Tr(C1 + C2 − 2 sqrt(C1 C2)), with Tr sqrt(C1 C2) taken as the sum of the
    square roots of C1 C2's eigenvalues (real and ≥ 0 for covariances, up to
    rounding) where the product takes the trace of scipy's `sqrtm`: the
    same value, held against the product's in phase 12, for a fraction of
    the host time (a 2048-d `sqrtm` is 10-22 s on the card's host, most of
    it the Schur form). Phases 14 and 34 take their Frechet distances so."""
    import numpy as np

    mu1, mu2 = (np.atleast_1d(np.asarray(m, dtype=np.float64)) for m in (mu1, mu2))
    s1, s2 = (np.atleast_2d(np.asarray(c, dtype=np.float64)) for c in (sigma1, sigma2))
    diff = mu1 - mu2
    root_trace = np.sqrt(np.linalg.eigvals(s1.dot(s2)).astype(complex)).real.sum()
    return float(diff.dot(diff) + np.trace(s1) + np.trace(s2) - 2 * root_trace)


def recorded(calls: list, fn):
    """`fn`, appending (its arguments, its result) of each call to `calls`."""
    def record(*args):
        out = fn(*args)
        calls.append((args, out))
        return out

    return record


def disk_trainer(card: str, per_step: dict[str, int], phase6: types.SimpleNamespace, seed: int,
                 root: Path) -> tuple[dict[str, int], Path, Path]:
    """Phase 11: a procedural Pororo tree (the port's writer, DISK_EPISODES)
    under `root`, then `cascade.yml --data_dir` through the CLI in this
    process for one epoch. Checks the launches against the steps and sample
    grid run, finite metrics under the JAX package's cascade tags, and the
    snapshots; prints the epoch's frames/s, its steps' median host time
    after the first (min, max) against phase 6's, the first-batch wait, the
    host time a batch spends in the datasets and the collate, and the idle
    share of 5 traced steps. Leaves the final snapshot alone for the walks:
    the epoch-0 one holds the same state. Returns (launches, run dir, data
    dir)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cpcsv_tpu_torch.cli import main_pororo
    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.data import loader as loader_module
    from cpcsv_tpu_torch.data import pororo
    from cpcsv_tpu_torch.data.procedural import write_procedural_pororo
    from cpcsv_tpu_torch.train import trainer as trainer_module

    data_dir = root / "pororo"
    t = time.perf_counter()
    info = write_procedural_pororo(str(data_dir), n_episodes=DISK_EPISODES)
    print(f"procedural tree [{card}]: {info} written in {time.perf_counter() - t:.2f} s")
    cfg_file = str(REPO / "cpcsv_tpu_torch" / "configs" / "cascade.yml")
    cfg = config_from_file(cfg_file)
    steps_an_epoch = info["train_clips"] // cfg.TRAIN.ST_BATCH_SIZE
    traced = range(DISK_TRACED[0], DISK_TRACED[0] + DISK_TRACED[1])

    host: dict[str, list] = {}  # host seconds by what ran
    # per epoch: the span's start and length, its update calls (start, pairs)
    starts, spans, step_starts = [], [], []
    window = {}
    real_span = trainer_module.record_function

    def close_window():
        window["host_s"] = time.perf_counter() - window.pop("t")
        window["prof"].__exit__(None, None, None)

    @contextlib.contextmanager
    def timed_span(name):
        starts.append(time.perf_counter())
        step_starts.append([])
        with real_span(name):
            yield
        if "t" in window:  # the traced chunk ended the epoch, its metrics read back
            close_window()
        spans.append(time.perf_counter() - starts[-1])

    def before_update(pairs):
        """One pair at a time, steps `traced` are traced; in chunks of
        SCAN_STEPS, the epoch's last chunk."""
        i = sum(n for _, n in step_starts[-1])  # the pairs run before this call
        if "t" in window and i == traced.stop:  # the card drained with the last readback
            close_window()
        step_starts[-1].append((time.perf_counter(), pairs))
        if i == traced.start if pairs == 1 else i + pairs == steps_an_epoch:
            window["pairs"] = pairs if pairs > 1 else len(traced)
            window["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            window["prof"].__enter__()
            window["t"] = time.perf_counter()

    def timed_loading(buckets):
        stack = contextlib.ExitStack()
        for obj, attr, key in ((pororo.StoryDataset, "__getitem__", "story item"),
                               (pororo.ImageDataset, "__getitem__", "image item"),
                               (loader_module, "default_collate", "collate")):
            stack.enter_context(mock.patch.object(obj, attr, timing(buckets, key,
                                                                     getattr(obj, attr))))
        return stack

    # the loaders alone, the card idle: the clip-index cache built, then the
    # first LOADER_ALONE batches of the story and the image loader in turn
    alone: dict[str, list] = {}
    with timed_loading(alone):
        t = time.perf_counter()
        image_loader, story_loader, _ = pororo.build_pororo_loaders(
            cfg.with_updates(DATA_DIR=str(data_dir)), seed)
        index_s = time.perf_counter() - t
        walls = {}
        for name, loader in (("story", story_loader), ("image", image_loader)):
            loader.set_epoch(0)
            n = min(LOADER_ALONE, len(loader))
            t = time.perf_counter()
            for _ in itertools.islice(loader, n):
                pass
            walls[name] = (time.perf_counter() - t) / n
    print(f"loaders alone [{card}]: clip index and cache {index_s:.2f} s; a story batch "
          f"{walls['story'] * 1e3:.2f} ms, an image batch {walls['image'] * 1e3:.2f} ms on the "
          f"host clock (first {LOADER_ALONE} of each, read ahead by a thread); host time an item "
          f"{np.mean(alone['story item']) * 1e3:.2f} ms a story, "
          f"{np.mean(alone['image item']) * 1e3:.2f} ms an image, a collate "
          f"{np.mean(alone['collate']) * 1e3:.2f} ms")

    run_root = root / "run"
    run_root.mkdir()
    printed = io.StringIO()
    cwd = os.getcwd()
    os.chdir(run_root)
    try:
        with mock.patch.object(trainer_module, "record_function", timed_span), \
                spying_updates([], before_update), timed_loading(host), \
                contextlib.redirect_stdout(printed):
            reset_counts()  # the main path: the CLI only
            t = time.perf_counter()
            main_pororo.main(["--cfg", cfg_file, "--data_dir", str(data_dir), "--max_epoch", "1",
                              "--manualSeed", str(seed)])
            run_s = time.perf_counter() - t
            counts = read_counts()
    finally:
        os.chdir(cwd)
    lines = [line for line in printed.getvalue().splitlines() if line.startswith("----[")]
    print(f"CLI output [{card}]:\n  " + "\n  ".join(lines))
    run_dir = run_root / "output" / "torch" / cfg.CONFIG_NAME

    model = run_dir / "Model"
    for f in ("netG_epoch_0.pth", "netG_epoch_1.pth", "train_state_last.pth",
              "netD_im_epoch_last.pth", "netD_st_epoch_last.pth", "netD_se_epoch_last.pth"):
        check((model / f).is_file(), f"the --data_dir run wrote no {model / f}")
    check((model / "last_epoch.txt").read_text().strip() == "0",
          f"last_epoch.txt holds {(model / 'last_epoch.txt').read_text()!r}, expected 0")
    snapshots = [torch.load(model / f"netG_epoch_{e}.pth", weights_only=True) for e in (0, 1)]
    check(all(torch.equal(snapshots[0][k], v) for k, v in snapshots[1].items()),
          "netG_epoch_0 and netG_epoch_1 of a one-epoch run hold different states")
    (model / "netG_epoch_0.pth").unlink()  # the walks take the final snapshot alone
    check(all((data_dir / c).is_file() for c in ("img_cache4.npy", "following_cache4.npy")),
          "the loaders wrote no clip-index cache")
    records = [json.loads(line) for line in (run_dir / "log" / "metrics.jsonl").open()]
    tags = {r["tag"] for r in records}
    check(all(np.isfinite(r["value"]) for r in records), "metrics.jsonl holds a non-finite value")
    check(tags == set(CASCADE_TAGS), f"metrics.jsonl tags {sorted(tags)} differ from the JAX "
          f"package's cascade set: missing {set(CASCADE_TAGS) - tags}, extra {tags - set(CASCADE_TAGS)}")
    steps = steps_an_epoch
    expected = {k: v * steps for k, v in per_step.items()}
    expected["dfn_forward"] += 1
    check(counts == expected, f"--data_dir run: launches {counts}, expected {expected} for "
                              f"{steps} steps and a sample grid")
    print(f"--data_dir run: {steps} D+G steps and a sample grid launched {counts} = {per_step} "
          "a step, plus one dfn_forward a grid")

    fps = {r["step"]: r["value"] for r in records if r["tag"] == "perf/frames_per_sec"}
    epoch_s = {r["step"]: r["value"] for r in records if r["tag"] == "perf/epoch_seconds"}
    check(len(spans) == 1 and all(sum(n for _, n in s) == steps_an_epoch for s in step_starts),
          f"{len(spans)} epochs with {[[n for _, n in s] for s in step_starts]} steps timed")
    frames_per_step = cfg.TRAIN.ST_BATCH_SIZE * cfg.VIDEO_LEN + cfg.TRAIN.IM_BATCH_SIZE
    for epoch in (0,):
        calls = step_starts[epoch]
        ends = [t for t, _ in calls[1:]] + [starts[epoch] + spans[epoch]]
        pair_ms = [(e - t) * 1e3 / n for (t, n), e in zip(calls, ends)]  # a pair, each call
        wait = (calls[0][0] - starts[epoch]) * 1e3
        if len(calls) > 1:
            later = sorted(pair_ms[1:])
            med = later[len(later) // 2]
            pace = (f"first step {pair_ms[0]:.2f} ms; steps after the first {med:.2f} ms "
                    f"median (min {later[0]:.2f}, max {later[-1]:.2f})")
        else:
            med = pair_ms[0]
            pace = (f"one chunk of {calls[0][1]} pairs at SCAN_STEPS {cfg.SCAN_STEPS} "
                    f"(the run's first: an eager pair, the capture, then replays) "
                    f"{med:.2f} ms a pair")
        print(f"--data_dir epoch {epoch} [{card}]: {fps[epoch]:.1f} frames/s "
              f"(perf/frames_per_sec), {epoch_s[epoch]:.2f} s; its {steps_an_epoch} steps "
              f"{spans[epoch] * 1e3:.2f} ms on the host clock ({steps_an_epoch * frames_per_step / spans[epoch]:.1f} "
              f"frames/s); first-batch wait {wait:.2f} ms; {pace}"
              + f", {window['pairs']} of them traced"
              + f"; phase 6 cascade step {phase6.step_ms:.2f} ms with batches on the card")
    items = {k: len(v) for k, v in host.items()}
    batches = len(host["collate"])
    print(f"loader host time [{card}] (background threads, beside the steps): story batch "
          f"{sum(host['story item']) / (items['story item'] / cfg.TRAIN.ST_BATCH_SIZE) * 1e3:.2f} "
          f"ms in StoryDataset "
          f"({cfg.TRAIN.ST_BATCH_SIZE} stories of {cfg.VIDEO_LEN} PNG frames), image batch "
          f"{sum(host['image item']) / (items['image item'] / cfg.TRAIN.IM_BATCH_SIZE) * 1e3:.2f} ms in "
          f"ImageDataset ({cfg.TRAIN.IM_BATCH_SIZE} frames and masks), collate "
          f"{sum(host['collate']) / batches * 1e3:.2f} ms a batch over {batches} batches; items "
          f"read {items}; host time an item {np.mean(host['story item']) * 1e3:.2f} ms a story, "
          f"{np.mean(host['image item']) * 1e3:.2f} ms an image")
    dev = raw_device_spans(window["prof"])
    busy = sum(b - a for a, b in dev) / 1e6
    check(busy > 0, "the trace of the epoch's steps holds no device work")
    n = window["pairs"]
    print(f"--data_dir epoch 0, {n} steps under torch.profiler "
          f"[{card}]: {window['host_s'] * 1e3 / n:.2f} ms a step on the host clock, device busy "
          f"{busy / n:.2f} ms a step in {len(dev) / n:.0f} ops: idle share "
          f"{1 - busy / (window['host_s'] * 1e3):.3f}; against phase 6's busy "
          f"{phase6.busy_ms:.2f} ms a step, the untraced steps' idle share "
          f"{1 - phase6.busy_ms / med:.3f} (the epoch's median)")
    print(f"--data_dir run [{card}]: {run_s:.2f} s in all, state init, cache build and "
          "checkpoints included")
    return counts, run_dir, data_dir


class TimedExtractor:
    """An extractor whose calls add their host seconds to host[key] and
    their frames to host[key + " frames"] (the call returns numpy, so the
    card has finished)."""

    def __init__(self, ex, key: str, host: dict):
        self.ex, self.key, self.host = ex, key, host
        self.random_init, self.fingerprint, self.backbone = (ex.random_init, ex.fingerprint,
                                                             ex.backbone)

    def __call__(self, x):
        import numpy as np

        t = time.perf_counter()
        out = self.ex(x)
        self.host.setdefault(self.key, []).append(time.perf_counter() - t)
        self.host.setdefault(f"{self.key} frames", []).append(int(np.prod(np.shape(x)[:-3])))
        return out


def timed_extractor(make, key: str, host: dict, inside: set, built: dict):
    """`make` (a make_*_extractor), its extractor timed, kept in built[key],
    and the TF32 flags its backbone sees added to `inside`."""
    import torch

    def build(path, device):
        ex = make(path, device=device)
        ex.net.register_forward_pre_hook(lambda *_: inside.add(
            (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
        built[key] = ex
        return TimedExtractor(ex, key, host)

    return build


def calibrated_copy(net, x, seed: int):
    """A CPU copy of a random-init backbone with BN statistics from one
    train-mode pass over `x` (N, C, ...) and affines drawn away from identity,
    in eval mode: its features depend on the input."""
    import torch

    net = copy.deepcopy(net).cpu()
    gen = torch.Generator().manual_seed(seed)
    bns = [m for m in net.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    with torch.no_grad():
        for m in bns:
            m.momentum = None  # the running statistics become the pass's
            m.weight.uniform_(0.8, 1.2, generator=gen)
            m.bias.normal_(0.0, 0.05, generator=gen)
        net.train()(x)
    for m in bns:
        m.momentum = 0.1
    return net.eval()


def walks(card: str, run_dir: Path, data_dir: Path, seed: int) -> dict[str, int]:
    """Phase 12: --eval_fid 1, --eval_ssim 1 and --load_ckpt 1 through the
    CLI on phase 11's run. Checks one CSV row a snapshot, newest first,
    finite, with the random-init tags; the numbered PNGs; the DFN launches of
    the generations; TF32 off inside the extractors; each backbone's forward
    on the card against the same weights on the CPU. Prints each
    checkpoint's seconds by part (generation and PNG writing, PNG reading,
    each backbone, the host statistics and Frechet) and the backbones'
    frames/s. Returns the launches."""
    import numpy as np
    import torch

    from cpcsv_tpu_torch.cli import main_pororo
    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.device import float32_math
    from cpcsv_tpu_torch.evaluation import datasets, drivers, features, fid, fsd
    from cpcsv_tpu_torch.evaluation.weights import RandomInitMetricWarning

    cfg_file = str(REPO / "cpcsv_tpu_torch" / "configs" / "cascade.yml")
    cfg = config_from_file(cfg_file)
    args = ["--cfg", cfg_file, "--data_dir", str(data_dir), "--manualSeed", str(seed)]
    epochs = WALKED  # phase 11's snapshots, newest first
    test_stories = (len(np.load(data_dir / "train_test_ids.npy", allow_pickle=True)[1])
                    // cfg.TRAIN.ST_BATCH_SIZE * cfg.TRAIN.ST_BATCH_SIZE)
    host: dict[str, list] = {}
    extractors, inside, frechets = {}, set(), []

    patches = [
        mock.patch.object(drivers.Infer, "generate_story",
                          timing(host, "generation and PNG writing", drivers.Infer.generate_story)),
        mock.patch.object(datasets.FolderImageDataset, "__getitem__", timing(
            host, "PNG reading", datasets.FolderImageDataset.__getitem__)),
        mock.patch.object(datasets.FolderStoryDataset, "__getitem__", timing(
            host, "PNG reading", datasets.FolderStoryDataset.__getitem__)),
        mock.patch.object(features, "calculate_activation_statistics", timing(
            host, "statistics", features.calculate_activation_statistics)),
        mock.patch.object(fid, "calculate_frechet_distance", recorded(frechets, timing(
            host, "Frechet", fid.calculate_frechet_distance))),
        mock.patch.object(fsd, "calculate_frechet_distance", recorded(frechets, timing(
            host, "Frechet", fsd.calculate_frechet_distance))),
    ]
    printed = io.StringIO()
    cwd = os.getcwd()
    os.chdir(run_dir.parent.parent.parent)  # the CLI reads ./output/torch/<config>
    try:
        with contextlib.ExitStack() as stack, contextlib.redirect_stdout(printed), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for p in patches:
                stack.enter_context(p)
            for name, key in (("make_inception_extractor", "Inception"),
                              ("make_fsd_extractor", "R(2+1)D")):
                stack.enter_context(mock.patch.object(drivers, name, timed_extractor(
                    getattr(drivers, name), key, host, inside, extractors)))
            reset_counts()  # the main path: the CLI's walks only
            t = time.perf_counter()
            fid_rows = main_pororo.main(args + ["--eval_fid", "1"])
            fid_s = time.perf_counter() - t
            fid_host = {k: list(v) for k, v in host.items()}
            t = time.perf_counter()
            ssim_rows = main_pororo.main(args + ["--eval_ssim", "1"])
            ssim_s = time.perf_counter() - t
            t = time.perf_counter()
            main_pororo.main(args + ["--load_ckpt", str(epochs[0])])
            dump_s = time.perf_counter() - t
            counts, walk_calls = read_counts(), sampler_calls()
    finally:
        os.chdir(cwd)
    eval_dir = run_dir / "Evaluation" / cfg.CONFIG_NAME
    with open(eval_dir / "fid_score2.csv") as f:
        fid_csv = [[float(v) for v in row] for row in csv.reader(f)]
    with open(eval_dir / "ssim_score.csv") as f:
        ssim_csv = [[float(v) for v in row] for row in csv.reader(f)]
    check([r["epoch"] for r in fid_rows] == epochs and [r[0] for r in fid_csv] == epochs,
          f"--eval_fid rows {fid_rows}, CSV {fid_csv}: expected epochs {epochs}, newest first")
    check(all(np.isfinite([r["fid"], r["vfid"]]).all() and r["fid_random_init"]
              and r["fsd_random_init"] for r in fid_rows),
          f"--eval_fid rows {fid_rows}: expected finite values tagged random-init")
    check(fid_csv == [[r["epoch"], r["fid"], r["vfid"]] for r in fid_rows],
          f"fid_score2.csv {fid_csv} differs from the rows {fid_rows}")
    check(printed.getvalue().count("[RANDOM-INIT extractors!]") == len(epochs),
          "the --eval_fid lines lack the random-init tag")
    check(sum(issubclass(w.category, RandomInitMetricWarning) for w in caught) == 2,
          f"{len(caught)} warnings in the walks, expected one RandomInitMetricWarning a backbone")
    check([r["epoch"] for r in ssim_rows] == epochs and [r[0] for r in ssim_csv] == epochs
          and all(np.isfinite(r["ssim"]) for r in ssim_rows),
          f"--eval_ssim rows {ssim_rows}, CSV {ssim_csv}")
    pngs = {d: len([f for f in os.listdir(run_dir / "Evaluation" / d) if f.endswith(".png")])
            for d in ("samples", "ref")}
    check(pngs == {"samples": test_stories * cfg.VIDEO_LEN, "ref": test_stories * cfg.VIDEO_LEN},
          f"--load_ckpt {epochs[0]} wrote {pngs} numbered PNGs, expected {test_stories} test "
          f"stories x {cfg.VIDEO_LEN}")
    # a generate_story per checkpoint and the dump: one DFN forward a story
    # batch; SSIM: one a chunk of 64 stories; eval BN, no gradients
    batches = test_stories // cfg.TRAIN.ST_BATCH_SIZE
    expected = {"dfn_forward": len(epochs) * (batches + -(-test_stories // 64)) + batches,
                "dfn_backward": 0, "bn_stats": 0, "bn_grad_reduce": 0}
    check(counts == expected, f"walks: launches {counts}, expected {expected}")
    check_sampler(expected["dfn_forward"], "walks", walk_calls)
    check(inside == {(False, False)} and torch.backends.cudnn.allow_tf32,
          f"TF32 flags (cudnn, matmul) inside the extractors {inside}")
    print(f"walks: launches {counts}; TF32 flags (cudnn, matmul) inside the extractors "
          f"{sorted(inside)}")
    for r in fid_rows:
        print(f"--eval_fid [{card}]: epoch {r['epoch']} fid {r['fid']!r} fsd {r['vfid']!r} "
              f"(random-init extractors: fid {r['fid_random_init']}, fsd {r['fsd_random_init']})")
    for r in ssim_rows:
        print(f"--eval_ssim [{card}]: epoch {r['epoch']} ssim {r['ssim']!r}")
    n = len(epochs)
    parts = ("generation and PNG writing", "PNG reading", "Inception", "R(2+1)D", "statistics",
             "Frechet")
    print(f"--eval_fid walk [{card}]: {fid_s:.2f} s for {n} checkpoints of {test_stories} "
          f"stories, the backbones' construction included; a checkpoint: "
          + ", ".join(f"{k} {sum(fid_host.get(k, [])) / n:.2f} s" for k in parts)
          + f"; the rest {(fid_s - sum(sum(fid_host.get(k, [])) for k in parts)) / n:.2f} s")
    for key in ("Inception", "R(2+1)D"):
        frames = sum(fid_host[f"{key} frames"])
        print(f"  {key} [{card}]: {frames} frames in {sum(fid_host[key]):.2f} s, "
              f"{frames / sum(fid_host[key]):.1f} frames/s (host clock around the calls, "
              "host-to-card copies included)")
    print(f"--eval_ssim walk [{card}]: {ssim_s:.2f} s, {ssim_s / n:.2f} s a checkpoint of "
          f"{test_stories} stories; --load_ckpt {epochs[0]}: {dump_s:.2f} s for "
          f"{2 * test_stories * cfg.VIDEO_LEN} PNGs")
    # the walk's distances again by the eigenvalues of C1 C2, as phases 14
    # and 34 take theirs: within 1e-6 of the traces they are differences of
    check(len(frechets) == 2 * n, f"{len(frechets)} Frechet distances in the --eval_fid walk")
    for (mu1, s1, mu2, s2), got in frechets:
        t = time.perf_counter()
        eig = frechet_by_eigenvalues(mu1, s1, mu2, s2)
        eig_s = time.perf_counter() - t
        scale = float(np.trace(s1) + np.trace(s2))
        check(abs(eig - got) <= 1e-6 * scale + 1e-12,
              f"a {len(mu1)}-d Frechet distance {got!r} by sqrtm, {eig!r} by eigenvalues "
              f"(traces {scale:.3e})")
        print(f"  {len(mu1)}-d Frechet distance {got!r} (sqrtm), {eig!r} by the eigenvalues of "
              f"C1 C2 in {eig_s:.2f} s (|difference| {abs(eig - got):.2e}, traces {scale:.3e})")

    # each backbone on the card against the same weights on the CPU, its BN
    # calibrated first (calibrated_copy): a random-init backbone's features
    # barely depend on the input, so the raw features could agree while the
    # part that carries the input did not. Both the raw features and the
    # features less their mean over the 4 inputs are held at 1e-3.
    gen = np.random.default_rng(seed)
    for key, shape in (("Inception", (4, 64, 64, 3)),
                       ("R(2+1)D", (4, cfg.VIDEO_LEN, 64, 64, 3))):
        low = 0.0 if key == "Inception" else -1.0  # [0, 1] images, [-1, 1] stories
        calib, x = (torch.from_numpy(gen.uniform(low, 1, shape).astype(np.float32)).movedim(-1, 1)
                    for _ in range(2))
        cpu_net = calibrated_copy(extractors[key].net, calib, seed)
        card_net = copy.deepcopy(cpu_net).cuda()
        with torch.no_grad(), float32_math():
            card_out = card_net(x.cuda()).cpu().numpy()
            cpu_out = cpu_net(x).numpy()
        errs = {}
        for part, a, b in (("raw", card_out, cpu_out),
                           ("centred", card_out - card_out.mean(0), cpu_out - cpu_out.mean(0))):
            errs[part] = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        share = float(np.linalg.norm(cpu_out - cpu_out.mean(0)) / np.linalg.norm(cpu_out))
        check(max(errs.values()) <= 1e-3 and share > 5e-2,
              f"{key} on the card against the CPU: relative L2 {errs} (tol 1e-3), the "
              f"input-dependent share of the features {share:.3e} (expected > 5e-2)")
        print(f"{key} forward, BN calibrated, card against CPU, 4 inputs, float32: relative "
              f"L2 {errs['raw']:.3e} raw, {errs['centred']:.3e} less the mean over the inputs "
              f"(tol 1e-3); the centred features are {share:.3e} of the raw ones")
    return counts


def fvd_is_walks(card: str, run_dir: Path, data_dir: Path, seed: int, root: Path) -> dict[str, int]:
    """Phase 13: --eval_fvd 1 twice and --eval_is 1 through the CLI on phase
    11's run. The first FVD walk finds no I3D weights and takes the R(2+1)D
    backbone ("FVD-R"); the second finds a seeded random I3D state_dict
    written as i3d_kinetics400.pth into a directory that
    $CPCSV_METRIC_WEIGHTS_DIR names, and runs I3D at 224 x 224 x 10 through
    the file loader. Checks one CSV row a snapshot, newest first, finite and
    tagged; the backbone each walk took and the warnings; the numbered PNGs;
    the DFN launches; TF32 off inside the backbones; I3D and the IS
    classifier on the card against the CPU, BN calibrated. Prints each walk's
    seconds a checkpoint by part. Returns the launches."""
    import numpy as np
    import torch

    from cpcsv_tpu_torch.cli import main_pororo
    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.device import float32_math
    from cpcsv_tpu_torch.evaluation import datasets, drivers, fvd, inception_score
    from cpcsv_tpu_torch.evaluation.i3d import I3D
    from cpcsv_tpu_torch.evaluation.weights import RandomInitMetricWarning, random_init_

    cfg_file = str(REPO / "cpcsv_tpu_torch" / "configs" / "cascade.yml")
    cfg = config_from_file(cfg_file)
    args = ["--cfg", cfg_file, "--data_dir", str(data_dir), "--manualSeed", str(seed)]
    epochs = WALKED  # phase 11's snapshots, newest first
    test_stories = (len(np.load(data_dir / "train_test_ids.npy", allow_pickle=True)[1])
                    // cfg.TRAIN.ST_BATCH_SIZE * cfg.TRAIN.ST_BATCH_SIZE)
    frames = test_stories * cfg.VIDEO_LEN
    clips = frames // FVD_FRAMES // 16 * 16  # calculate_fvd's batches of 16
    no_weights, i3d_weights = root / "no_weights", root / "i3d_weights"
    no_weights.mkdir()
    i3d_weights.mkdir()
    torch.save(random_init_(I3D(), seed).state_dict(), i3d_weights / "i3d_kinetics400.pth")

    extractors, inside = {}, set()
    walks = (("FVD-R", "--eval_fvd", no_weights, "default_embedder"),
             ("FVD, I3D", "--eval_fvd", i3d_weights, "default_embedder"),
             ("IS", "--eval_is", no_weights, "make_inception_classifier"))
    out = {}
    cwd = os.getcwd()
    os.chdir(run_dir.parent.parent.parent)  # the CLI reads ./output/torch/<config>
    try:
        for name, flag, weights, factory in walks:
            host: dict[str, list] = {}
            patches = [
                mock.patch.dict(os.environ, {"CPCSV_METRIC_WEIGHTS_DIR": str(weights)}),
                mock.patch.object(drivers, factory, timed_extractor(
                    getattr(drivers, factory), name, host, inside, extractors)),
                mock.patch.object(fvd, "calculate_activation_statistics", timing(
                    host, "statistics", fvd.calculate_activation_statistics)),
                mock.patch.object(fvd, "calculate_frechet_distance", timing(
                    host, "Frechet", fvd.calculate_frechet_distance)),
                mock.patch.object(inception_score, "inception_score_from_probs", timing(
                    host, "statistics", inception_score.inception_score_from_probs)),
            ]
            for obj, attr, key in (
                    (drivers.Infer, "_inference_samples", "generation and PNG writing"),
                    (drivers.Infer, "generate_story", "generation and PNG writing"),
                    (fvd.VideoGenerateDataset, "__getitem__", "PNG reading"),
                    (datasets.FolderImageDataset, "__getitem__", "PNG reading")):
                patches.append(mock.patch.object(obj, attr, timing(host, key, getattr(obj, attr))))
            printed = io.StringIO()
            with contextlib.ExitStack() as stack, contextlib.redirect_stdout(printed), \
                    warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for p in patches:
                    stack.enter_context(p)
                reset_counts()  # the main path: the CLI's walk only
                t = time.perf_counter()
                rows = main_pororo.main(args + [flag, "1"])
                seconds = time.perf_counter() - t
                counts = read_counts()
            out[name] = types.SimpleNamespace(rows=rows, host=host, seconds=seconds,
                                              counts=counts, sampled=sampler_calls(),
                                              caught=caught,
                                              printed=printed.getvalue())
    finally:
        os.chdir(cwd)

    eval_dir = run_dir / "Evaluation" / cfg.CONFIG_NAME
    with open(eval_dir / "fvd_score.csv") as f:
        fvd_csv = [[float(v) for v in row] for row in csv.reader(f)]
    with open(eval_dir / "is_score.csv") as f:
        is_csv = [[float(v) for v in row] for row in csv.reader(f)]
    batches = test_stories // cfg.TRAIN.ST_BATCH_SIZE
    expected = {"dfn_forward": len(epochs) * batches, "dfn_backward": 0, "bn_stats": 0,
                "bn_grad_reduce": 0}
    for name, (backbone, random_init, warned) in {
            "FVD-R": ("r2plus1d_18", True, ["r2plus1d_18"]), "FVD, I3D": ("i3d", False, []),
            "IS": ("inception_fid", True, ["inception_fid"])}.items():
        w = out[name]
        check([r["epoch"] for r in w.rows] == epochs,
              f"{name} walk rows {w.rows}: expected epochs {epochs}, newest first")
        check(w.counts == expected, f"{name} walk: launches {w.counts}, expected {expected}: one "
                                    "dfn_forward a story batch a checkpoint")
        check_sampler(expected["dfn_forward"], f"{name} walk", w.sampled)
        names = [str(c.message).split(":")[0] for c in w.caught
                 if issubclass(c.category, RandomInitMetricWarning)]
        check(names == warned, f"{name} walk: random-init warnings for {names}, expected {warned}")
        if name == "IS":
            check(all(r["is_random_init"] and np.isfinite([r["is_mean"], r["is_std"]]).all()
                      for r in w.rows), f"IS walk rows {w.rows}: expected finite, tagged random")
            check(w.printed.count("[RANDOM-INIT classifier!]") == len(epochs),
                  "the --eval_is lines lack the random-init tag")
            continue
        check(extractors[name].backbone == backbone
              and all(r["fvd_random_init"] == random_init and np.isfinite(r["fvd"])
                      for r in w.rows),
              f"{name} walk: backbone {extractors[name].backbone}, rows {w.rows}: expected "
              f"backbone {backbone}, finite, random-init {random_init}")
        rounded = [c for c in w.caught if "not divisible by 16" in str(c.message)]
        check(len(rounded) == len(epochs) and f"first {clips} clips" in str(rounded[0].message),
              f"{name} walk: {len(rounded)} round-down warnings, expected one a checkpoint "
              f"({frames // FVD_FRAMES} clips to {clips})")
    check(fvd_csv == [[r["epoch"], r["fvd"]] for name in ("FVD-R", "FVD, I3D")
                      for r in out[name].rows],
          f"fvd_score.csv {fvd_csv} differs from the two walks' rows")
    check(is_csv == [[r["epoch"], r["is_mean"], r["is_std"]] for r in out["IS"].rows],
          f"is_score.csv {is_csv} differs from the rows {out['IS'].rows}")
    pngs = {d: len([f for f in os.listdir(run_dir / "Evaluation" / d) if f.endswith(".png")])
            for d in ("ref", os.path.join(cfg.CONFIG_NAME, f"fvd_epoch_{epochs[-1]}"))}
    check(set(pngs.values()) == {frames}, f"the FVD dumps hold {pngs} PNGs, expected {frames}")
    check(inside == {(False, False)} and torch.backends.cudnn.allow_tf32,
          f"TF32 flags (cudnn, matmul) inside the backbones {inside}")
    print(f"FVD and IS walks: launches {expected} each; TF32 flags (cudnn, matmul) inside the "
          f"backbones {sorted(inside)}")
    for name in ("FVD-R", "FVD, I3D"):
        backbone = extractors[name].backbone
        note = ("; the I3D file holds seeded random weights (random_init_, seed "
                f"{seed}), not Kinetics-400's" if backbone == "i3d" else "")
        for r in out[name].rows:
            print(f"--eval_fvd [{card}]: epoch {r['epoch']} fvd {r['fvd']!r} "
                  f"({backbone}, random-init tag {r['fvd_random_init']}){note}")
    for r in out["IS"].rows:
        print(f"--eval_is [{card}]: epoch {r['epoch']} IS {r['is_mean']!r} +- {r['is_std']!r} "
              f"(random-init classifier: {r['is_random_init']})")

    n = len(epochs)
    for name, w in out.items():
        unit, per = ("frames", 1) if name == "IS" else ("clips", FVD_FRAMES)
        parts = ("generation and PNG writing", "PNG reading", name, "statistics", "Frechet")
        done = sum(w.host[f"{name} frames"]) // per
        print(f"{name} walk [{card}]: {w.seconds:.2f} s for {n} checkpoints of {test_stories} "
              "stories, the backbone's construction included; a checkpoint: "
              + ", ".join(f"{'backbone' if k == name else k} {sum(w.host.get(k, [])) / n:.2f} s"
                          for k in parts)
              + f"; the rest {(w.seconds - sum(sum(w.host.get(k, [])) for k in parts)) / n:.2f} s;"
              f" the backbone {done} {unit} in {sum(w.host[name]):.2f} s, "
              f"{done / sum(w.host[name]):.1f} {unit}/s (host clock around the calls, "
              "host-to-card copies included)")

    # I3D and the IS classifier on the card against the same weights on the
    # CPU, BN calibrated first (calibrated_copy), raw and less the inputs'
    # mean, at 1e-3, as phase 12 holds the other two backbones
    gen = np.random.default_rng(seed)
    for key, shape in (("FVD, I3D", (4, 3, FVD_FRAMES, 64, 64)), ("IS", (4, 3, 64, 64))):
        calib, x = (torch.from_numpy(gen.uniform(0, 1, shape).astype(np.float32))
                    for _ in range(2))
        cpu_net = calibrated_copy(extractors[key].net, calib, seed)
        card_net = copy.deepcopy(cpu_net).cuda()
        with torch.no_grad(), float32_math():
            card_out = card_net(x.cuda()).cpu().numpy()
            cpu_out = cpu_net(x).numpy()
        errs = {part: float(np.linalg.norm(a - b) / np.linalg.norm(b)) for part, a, b in (
            ("raw", card_out, cpu_out),
            ("centred", card_out - card_out.mean(0), cpu_out - cpu_out.mean(0)))}
        share = float(np.linalg.norm(cpu_out - cpu_out.mean(0)) / np.linalg.norm(cpu_out))
        label = "I3D" if key == "FVD, I3D" else "IS classifier"
        check(max(errs.values()) <= 1e-3 and share > 5e-2,
              f"{label} on the card against the CPU: relative L2 {errs} (tol 1e-3), the "
              f"input-dependent share of the outputs {share:.3e} (expected > 5e-2)")
        print(f"{label} forward, BN calibrated, card against CPU, 4 inputs {list(shape)}, "
              f"float32: relative L2 {errs['raw']:.3e} raw, {errs['centred']:.3e} less the mean "
              f"over the inputs (tol 1e-3); the centred outputs are {share:.3e} of the raw ones")
    return {k: sum(w.counts[k] for w in out.values()) for k in expected}


def rehearsal_trainer(card: str, per_step: dict[str, int], seed: int, root: Path) -> dict[str, int]:
    """Phase 14: rehearsal.yml (cascade.yml's widths, EVALUATE_FID_SCORE on,
    a snapshot every epoch) with --synthetic CLI_SYNTHETIC --max_epoch 2
    through the CLI in this process, from a working directory under `root`
    so that its .cache/ lands there. Checks finite Evaluation/fid and
    Evaluation/vfid for both epochs, the extractors built once (one
    random-init warning a backbone), the real side's statistics written in
    epoch 0 and read back in epoch 1, a snapshot every epoch, the launches;
    prints the hook's seconds an epoch and its share of the epoch, the host
    Frechet apart (taken by `frechet_by_eigenvalues`, which phase 12 holds
    against the product's `sqrtm`). Returns the launches."""
    import numpy as np
    import torch

    from cpcsv_tpu_torch.cli import main_pororo
    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.evaluation import features, fid, fsd
    from cpcsv_tpu_torch.evaluation.weights import RandomInitMetricWarning
    from cpcsv_tpu_torch.train import trainer as trainer_module

    cfg_file = str(REPO / "cpcsv_tpu_torch" / "configs" / "rehearsal.yml")
    cfg = config_from_file(cfg_file)
    check(cfg.EVALUATE_FID_SCORE and cfg.TRAIN.SNAPSHOT_INTERVAL == 1,
          f"{cfg_file}: EVALUATE_FID_SCORE {cfg.EVALUATE_FID_SCORE}, SNAPSHOT_INTERVAL "
          f"{cfg.TRAIN.SNAPSHOT_INTERVAL}")
    run_root = root / "rehearsal"
    run_root.mkdir()
    cache = run_root / ".cache"
    host: dict[str, list] = {}
    hooks, built = [], []
    real_vfid = trainer_module.GANTrainer.calculate_vfid
    real_make = trainer_module.make_in_memory_extractors

    def listing():
        return {p.name: p.stat().st_mtime_ns for p in cache.glob("*.npz")}

    def timed_vfid(self, state, epoch, testloader):
        before, marks = listing(), {k: len(host.get(k, [])) for k in ("Frechet", "extraction")}
        torch.cuda.synchronize()
        t = time.perf_counter()
        scores = real_vfid(self, state, epoch, testloader)
        torch.cuda.synchronize()
        hooks.append(types.SimpleNamespace(
            epoch=epoch, seconds=time.perf_counter() - t, before=before, after=listing(),
            frechet=sum(host.get("Frechet", [])[marks["Frechet"]:]),
            extractions=len(host.get("extraction", [])) - marks["extraction"]))
        return scores

    def counted_make(device):
        built.append(device)
        return real_make(device)

    args = ["--cfg", cfg_file, "--synthetic", str(CLI_SYNTHETIC), "--max_epoch", "2",
            "--manualSeed", str(seed)]
    printed = io.StringIO()
    cwd = os.getcwd()
    os.chdir(run_root)  # the CLI writes under ./output/torch/, the hook under ./.cache/
    try:
        with mock.patch.object(trainer_module.GANTrainer, "calculate_vfid", timed_vfid), \
                mock.patch.object(trainer_module, "make_in_memory_extractors", counted_make), \
                mock.patch.object(features, "extract_activations", timing(
                    host, "extraction", features.extract_activations)), \
                mock.patch.object(fid, "calculate_frechet_distance", timing(
                    host, "Frechet", frechet_by_eigenvalues)), \
                mock.patch.object(fsd, "calculate_frechet_distance", timing(
                    host, "Frechet", frechet_by_eigenvalues)), \
                contextlib.redirect_stdout(printed), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            reset_counts()  # the main path: the CLI only
            t = time.perf_counter()
            main_pororo.main(args)
            run_s = time.perf_counter() - t
            counts, sampled = read_counts(), sampler_calls()
    finally:
        os.chdir(cwd)
    lines = [line for line in printed.getvalue().splitlines() if line.startswith("----[")]
    print(f"CLI output [{card}]:\n  " + "\n  ".join(lines))
    run_dir = run_root / "output" / "torch" / cfg.CONFIG_NAME
    for e in (0, 1, 2):
        check((run_dir / "Model" / f"netG_epoch_{e}.pth").is_file(),
              f"rehearsal.yml wrote no netG_epoch_{e}.pth: a snapshot every epoch and the last")
    records = [json.loads(line) for line in (run_dir / "log" / "metrics.jsonl").open()]
    tags = {r["tag"] for r in records}
    check(all(np.isfinite(r["value"]) for r in records), "metrics.jsonl holds a non-finite value")
    want = set(CASCADE_TAGS) | {"Evaluation/fid", "Evaluation/vfid"}
    check(tags == want, f"metrics.jsonl tags: missing {want - tags}, extra {tags - want}")
    scores = {(r["tag"], r["step"]): r["value"] for r in records
              if r["tag"].startswith("Evaluation/")}
    check(sorted(scores) == [(t, e) for t in ("Evaluation/fid", "Evaluation/vfid")
                             for e in (0, 1)],
          f"Evaluation/* records {sorted(scores)}, expected fid and vfid at epochs 0 and 1")
    warned = sorted(str(c.message).split(":")[0] for c in caught
                    if issubclass(c.category, RandomInitMetricWarning))
    check(len(built) == 1 and warned == ["inception_fid", "r2plus1d_18"],
          f"the extractors built {len(built)} times, random-init warnings {warned}: expected "
          "once, one a backbone")
    check([h.epoch for h in hooks] == [0, 1], f"the hook ran at epochs {[h.epoch for h in hooks]}")
    check(not hooks[0].before and len(hooks[0].after) == 2 and hooks[0].extractions == 4,
          f"epoch 0's hook: .cache {hooks[0].before} -> {hooks[0].after}, "
          f"{hooks[0].extractions} feature extractions (expected none -> 2 files, 4)")
    check(hooks[1].before == hooks[1].after == hooks[0].after and hooks[1].extractions == 2,
          f"epoch 1's hook: .cache {hooks[1].before} -> {hooks[1].after}, "
          f"{hooks[1].extractions} extractions (expected the epoch 0 files read back, 2)")
    steps_an_epoch = max(CLI_SYNTHETIC, cfg.TRAIN.ST_BATCH_SIZE) // cfg.TRAIN.ST_BATCH_SIZE
    test_stories = max(CLI_SYNTHETIC // 4, cfg.TRAIN.ST_BATCH_SIZE)  # synthetic_loaders' test set
    steps = 2 * steps_an_epoch
    expected = {k: v * steps for k, v in per_step.items()}
    expected["dfn_forward"] += 2 + 2 * -(-test_stories // 64)  # the grids; a hook's chunks
    check(counts == expected, f"rehearsal run: launches {counts}, expected {expected} for "
                              f"{steps} steps, 2 sample grids and 2 hooks")
    # epoch 1's grid and hook replay the graphs epoch 0 captured, from the
    # trainer's kept generators
    check_sampler(2 + 2 * -(-test_stories // 64), "rehearsal run's grids and hooks", sampled,
                  eager=1 + -(-test_stories // 64))
    print(f"rehearsal run: {steps} D+G steps, 2 sample grids and 2 hooks launched {counts} = "
          f"{per_step} a step, plus one dfn_forward a grid and a hook's chunk of "
          f"{test_stories} test stories; .cache {sorted(hooks[0].after)} written in epoch 0, "
          f"read in epoch 1")
    epoch_s = {r["step"]: r["value"] for r in records if r["tag"] == "perf/epoch_seconds"}
    fps = {r["step"]: r["value"] for r in records if r["tag"] == "perf/frames_per_sec"}
    for h in hooks:
        print(f"rehearsal epoch {h.epoch} [{card}]: fid {scores[('Evaluation/fid', h.epoch)]!r} "
              f"vfid {scores[('Evaluation/vfid', h.epoch)]!r} (random-init extractors); epoch "
              f"{epoch_s[h.epoch]:.2f} s, {fps[h.epoch]:.1f} frames/s; the hook {h.seconds:.2f} s "
              f"({h.seconds / epoch_s[h.epoch]:.3f} of the epoch), of which the host Frechet "
              f"{h.frechet:.2f} s (by eigenvalues) and the rest {h.seconds - h.frechet:.2f} s")
    print(f"rehearsal run [{card}]: {run_s:.2f} s in all, state init and 3 checkpoint saves "
          "included")
    return counts


def bn_vs_plain(gen, shapes: list, dtype) -> tuple[dict, set]:
    """Phase 8 at `dtype`: each BN kernel against its plain version at every
    (N, C, S) of `shapes`, x and dy of `dtype`, each 16-byte aligned and one
    element off (so that no row starts on a 16-byte boundary), two launches
    on one input. Returns ({kernel: max abs error}, {(kernel, vec, cluster,
    channels a block)} the shapes ran)."""
    import torch

    from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda

    bn_err = {"bn_stats": 0.0, "bn_grad_reduce": 0.0}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = set()
    for (N, Cb, S), offset in ((sh, off) for sh in shapes for off in (0, 1)):
        x, dy = cold_copies(gen, N, Cb, S, 2, offset, dtype)
        x += 0.5
        p = bn_cuda.plan(N, Cb, S, sms, x.data_ptr() % 16 == 0, x.element_size())
        plans.add(("reduce_rows" if S == 1 else "reduce_maps", p.vec, p.cluster, p.channels))
        xf, dyf = x.float(), dy.float()
        mean = xf.mean(dim=(0, 2))
        inv = torch.rsqrt(xf.var(dim=(0, 2), correction=0) + 1e-5)
        xhat = (xf - mean[:, None]) * inv[:, None]
        results = {
            "bn_stats": (bn_cuda.bn_stats(x), bn_cuda.bn_stats(x), bn_cuda.bn_stats_plain(x),
                         (xf.abs().sum(dim=(0, 2)), (xf * xf).sum(dim=(0, 2)))),
            "bn_grad_reduce": (bn_cuda.bn_grad_reduce(x, dy, mean, inv),
                               bn_cuda.bn_grad_reduce(x, dy, mean, inv),
                               bn_cuda.bn_grad_reduce_plain(x, dy, mean, inv),
                               (dyf.abs().sum(dim=(0, 2)), (dyf * xhat).abs().sum(dim=(0, 2)))),
        }
        for name, (got, again, want, magnitude) in results.items():
            for a, b, r, mag in zip(got, again, want, magnitude):
                # float32 sums in other orders: within 1e-5 of the sum of
                # the terms' magnitudes
                err = (a - r).abs()
                where = f"{name} {dtype} {(N, Cb, S)} offset {offset}"
                check(a.dtype == torch.float32, f"{where}: the sums are {a.dtype}")
                check(torch.equal(a, b), f"{where}: two launches differ")
                check(bool((err <= 1e-5 * mag + 1e-6).all()),
                      f"{where}: kernel vs plain error {err.max().item()}")
                bn_err[name] = max(bn_err[name], err.max().item())
    return bn_err, plans


def bn_library(name: str):
    """One PyTorch call computing the same sums: var_mean (for the
    statistics), native_batch_norm_backward without dx (for the sums)."""
    import torch

    if name == "bn_stats":
        return lambda x: torch.var_mean(x, dim=(0, 2), correction=0)
    return lambda x, dy, mean, inv: torch.ops.aten.native_batch_norm_backward(
        dy, x, torch.ones_like(mean), None, None, mean, inv, True, 1e-5, [False, True, True])


def largest_map(shapes) -> tuple:
    """The (N, C, S) of most elements (the greater shape on a tie)."""
    return max(shapes, key=lambda sh: (sh[0] * sh[1] * sh[2], sh))


def bn_timings(gen, card: str, runs: dict, dtype):
    """Phase 9, for the steps of `runs` ({config: phase 6's record}) at
    `dtype`: each BN kernel at every (N, C, S) a step gave it, and its
    library call at the largest of them (to make room for phase 35: the
    kernels have not changed, and PERF.md keeps the earlier runs' library
    times at every shape), one CUDA graph per
    shape, cycling through input copies that together exceed the L2
    (COLD_BYTES), so no call finds its input there; then each config's sums
    over a step's launches. Returns (per_shape, step_bn): {(kernel, (N, C,
    S)): BnTime with calls = launches a step of each config, library_ms None
    but at the largest shape}, {config: {kernel: (kernel, bound) ms a
    step}}."""
    import torch

    from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda

    itemsize = torch.empty(0, dtype=dtype).element_size()
    print(f"BN per shape, {dtype} [{card}], us per call in one CUDA graph, inputs L2-cold "
          f"(cycled through copies of >= {COLD_BYTES / 1e6:.1f} MB); share = bound / kernel")
    per_shape = {}
    largest = largest_map(set().union(*(set(r.step_calls["bn_stats"])
                                        | set(r.step_calls["bn_grad_reduce"])
                                        for r in runs.values())))
    for name in ("bn_stats", "bn_grad_reduce"):
        for N, Cb, S in sorted(set().union(*(r.step_calls[name] for r in runs.values()))):
            calls = {c: r.step_calls[name].get((N, Cb, S), 0) for c, r in runs.items()}
            inputs = bn_cold_inputs(gen, name, N, Cb, S, dtype)
            kernel_ms = cold_graph_ms(getattr(bn_cuda, name), inputs)
            library_ms = (cold_graph_ms(bn_library(name), inputs) if (N, Cb, S) == largest
                          else None)
            bound, bound_by = bn_bound(name, N, Cb, S, itemsize)
            per_shape[name, (N, Cb, S)] = BnTime((N, Cb, S), calls, kernel_ms, library_ms, bound)
            library = "" if library_ms is None else f"library {library_ms * 1e3:.2f}, "
            print(f"  {name} N={N} C={Cb} S={S}: a step "
                  + ", ".join(f"{c} x{n}" for c, n in calls.items())
                  + f"; kernel {kernel_ms * 1e3:.2f}, {library}bound "
                  f"{bound * 1e3:.3f} ({bound_by}), share {bound / kernel_ms:.3f}; "
                  f"{len(inputs)} copies")
            check(bound <= kernel_ms, f"{name} {(N, Cb, S)}: {kernel_ms * 1e3:.2f} us is under "
                  f"its bound {bound * 1e3:.3f} us: the inputs were not L2-cold")
            del inputs
    step_bn = {c: {} for c in runs}
    for c in runs:
        for name in ("bn_stats", "bn_grad_reduce"):
            rows = [r for (k, _), r in per_shape.items() if k == name and r.calls[c]]
            step_bn[c][name] = tuple(sum(r.calls[c] * getattr(r, k) for r in rows)
                                     for k in ("kernel_ms", "bound_ms"))
            kernel_ms, bound = step_bn[c][name]
            print(f"{c} {name} per step [{card}]: {sum(r.calls[c] for r in rows)} launches at "
                  f"{len(rows)} shapes; sum of launches x kernel {kernel_ms * 1e3:.2f} us, x "
                  f"bound {bound * 1e3:.2f} us; share of the per-step bound "
                  f"{bound / kernel_ms:.3f}")
        kernel_ms, bound = (sum(v) for v in zip(*step_bn[c].values()))
        print(f"{c} BN kernels per step [{card}]: {kernel_ms * 1e3:.2f} us against a bound of "
              f"{bound * 1e3:.2f} us, share {bound / kernel_ms:.3f}")
    return per_shape, step_bn


def bn_largest(gen, card: str, runs: dict, per_shape: dict, dtype) -> dict:
    """Phase 9 at the largest shape the steps of `runs` gave the BN kernels,
    at `dtype`: the plain versions in a graph, and a trace of kernel, plain
    version and library call (the input, 188.7 MB or more, exceeds the L2,
    so no copies); the library's sums held against the kernel's. Returns
    {kernel: {"shape", "plain_ms", "bound_by"}}."""
    import torch

    from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda

    shapes = set().union(*(set(r.step_calls["bn_stats"]) | set(r.step_calls["bn_grad_reduce"])
                           for r in runs.values()))
    N, Cb, S = largest = largest_map(shapes)
    x, dy = cold_copies(gen, N, Cb, S, 2, dtype=dtype)
    mean = x.float().mean(dim=(0, 2))
    inv = torch.rsqrt(x.float().var(dim=(0, 2), correction=0) + 1e-5)
    fns = {
        "bn_stats": {
            "kernel": lambda: bn_cuda.bn_stats(x),
            "plain": lambda: bn_cuda.bn_stats_plain(x),
            "library": lambda: bn_library("bn_stats")(x),
        },
        "bn_grad_reduce": {
            "kernel": lambda: bn_cuda.bn_grad_reduce(x, dy, mean, inv),
            "plain": lambda: bn_cuda.bn_grad_reduce_plain(x, dy, mean, inv),
            "library": lambda: bn_library("bn_grad_reduce")(x, dy, mean, inv),
        },
    }
    lib = fns["bn_grad_reduce"]["library"]()
    got = bn_cuda.bn_grad_reduce(x, dy, mean, inv)
    # the sums' largest distance from float64's, over the sum of the terms'
    # magnitudes, for the library and for the kernel; float64 a few rows at
    # a time (the whole map would take tens of GB)
    exact = [torch.zeros(Cb, dtype=torch.float64, device="cuda") for _ in range(4)]
    for i in range(0, N, 16):
        dyd = dy[i:i + 16].double()
        xhat = (x[i:i + 16].double() - mean.double()[:, None]) * inv.double()[:, None]
        for acc, t in zip(exact, (dyd, dyd * xhat, dyd.abs(), (dyd * xhat).abs())):
            acc += t.sum(dim=(0, 2))
    del dyd, xhat
    off = {who: max(float(((a.double() - e).abs() / m).max())
                    for a, e, m in zip(sums, exact[:2], exact[2:]))
           for who, sums in (("library", (lib[2], lib[1])), ("kernel", got))}
    print(f"bn_grad_reduce {largest} {dtype}: the sums' largest distance from float64's over "
          f"the sum of the terms' magnitudes: library {off['library']:.3e}, kernel "
          f"{off['kernel']:.3e}")
    if dtype == torch.float32:
        close = (torch.allclose(lib[2], got[0], rtol=1e-4, atol=1e-2)
                 and torch.allclose(lib[1], got[1], rtol=1e-4, atol=1e-2))
    else:
        # the library's sums of bfloat16 inputs lie off float64's by far more
        # than float32 rounding, where the kernel's do not: held within one
        # bfloat16 step of the terms' magnitudes
        close = off["library"] <= 2 ** -8 and off["kernel"] <= 1e-5
    check(close, f"native_batch_norm_backward disagrees with bn_grad_reduce at {dtype}")
    out = {}
    for name, f in fns.items():
        plain_ms = graph_ms(f["plain"])
        traced = {k: device_ms(fn, f"{name} {k} {largest} {dtype}") for k, fn in f.items()}
        _, _, kernel_ms, library_ms, bound = per_shape[name, largest]
        bound_by = bn_bound(name, N, Cb, S, x.element_size())[1]
        print(f"{name} (N, C, S)={largest} {dtype} [{card}]: us/call in one CUDA graph kernel "
              f"{kernel_ms * 1e3:.2f}, plain {plain_ms * 1e3:.2f}, library "
              f"{library_ms * 1e3:.2f}; traced "
              + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in traced.items())
              + f"; bound {bound * 1e3:.3f} us ({bound_by})")
        out[name] = {"shape": largest, "plain_ms": plain_ms, "bound_by": bound_by}
    return out


def write_variants(root: Path) -> dict[str, str]:
    """Each of VARIANTS as a YAML file in `root`: the base config's keys with
    the variant's flipped, under a CONFIG_NAME of its own. Returns {file:
    path}."""
    import yaml

    paths = {}
    for fname, base, keys in VARIANTS:
        raw = yaml.safe_load((REPO / "cpcsv_tpu_torch" / "configs" / base).read_text())
        raw.update(keys, CONFIG_NAME=f"{raw['CONFIG_NAME']}_{Path(fname).stem}")
        paths[fname] = str(root / fname)
        Path(paths[fname]).write_text(yaml.safe_dump(raw))
    return paths


def bn_new_maps(gen, card: str) -> dict:
    """Phase 23: the BN kernels at NEW_BN_MAPS, held against their plain
    versions (each input 16-byte aligned and one element off, two launches),
    then in one CUDA graph each with L2-cold inputs as phase 9: kernel,
    plain version and library call against the bound. Returns {kernel:
    [{shape, dtype, max_abs_err, ms, plain_ms, library_ms, bound_ms,
    bound_by}]}."""
    import torch

    from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda

    out = {"bn_stats": [], "bn_grad_reduce": []}
    for shape, dtype_name in NEW_BN_MAPS:
        dtype = getattr(torch, dtype_name)
        err, plans = bn_vs_plain(gen, [shape], dtype)
        for name in out:
            inputs = bn_cold_inputs(gen, name, *shape, dtype)
            kernel_ms = cold_graph_ms(getattr(bn_cuda, name), inputs)
            plain_ms = cold_graph_ms(getattr(bn_cuda, f"{name}_plain"), inputs)
            library_ms = cold_graph_ms(bn_library(name), inputs)
            bound, bound_by = bn_bound(name, *shape, torch.empty(0, dtype=dtype).element_size())
            del inputs
            check(bound <= kernel_ms, f"{name} {shape} {dtype_name}: {kernel_ms * 1e3:.2f} us is "
                  f"under its bound {bound * 1e3:.3f} us: the inputs were not L2-cold")
            print(f"{name} (N, C, S)={shape} {dtype_name} [{card}]: kernel vs plain max abs error "
                  f"{err[name]:.3e} (tol 1e-5 of the terms' magnitude + 1e-6), plans {sorted(plans)}; "
                  f"us a call in one CUDA graph, L2-cold: kernel {kernel_ms * 1e3:.2f}, plain "
                  f"{plain_ms * 1e3:.2f}, library {library_ms * 1e3:.2f}, bound "
                  f"{bound * 1e3:.3f} ({bound_by}), share {bound / kernel_ms:.3f}")
            out[name].append({"shape": list(shape), "dtype": dtype_name,
                              "max_abs_err": err[name], "ms": kernel_ms, "plain_ms": plain_ms,
                              "library_ms": library_ms, "bound_ms": bound, "bound_by": bound_by})
        torch.cuda.empty_cache()
    return out


def seq_cli(card: str, cfg_file: str, per_step: dict[str, int], seed: int,
            root: Path) -> dict[str, int]:
    """Phase 24, the seq-consistency variant through the port's CLI in this
    process: --synthetic SEQ_SYNTHETIC for 2 epochs straight (its checkpoint
    saves skipped: it is the reference), then in another working directory 1
    epoch and a --continue_ckpt auto epoch. The
    resumed epoch's host shuffles equal the straight run's epoch 1 bit for
    bit, and its metrics equal them within 1e-4 (cuDNN held deterministic);
    the launches against the steps and grids run. Returns the launches."""
    import numpy as np
    import torch

    from cpcsv_tpu_torch.cli import main_pororo
    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.train import trainer as trainer_module
    from cpcsv_tpu_torch.train.checkpoint import CheckpointManager

    cfg = config_from_file(cfg_file)
    args = ["--cfg", cfg_file, "--synthetic", str(SEQ_SYNTHETIC), "--manualSeed", str(seed)]
    steps_an_epoch = max(SEQ_SYNTHETIC, cfg.TRAIN.ST_BATCH_SIZE) // cfg.TRAIN.ST_BATCH_SIZE
    shuffles = []  # (shuffled stories, labels) bytes of every host shuffle, in order
    real_shuffle = trainer_module.create_random_shuffle

    def recorded(stories, **kwargs):
        shuffled, labels = real_shuffle(stories, **kwargs)
        shuffles.append((shuffled.tobytes(), labels.tobytes(), labels.sum()))
        return shuffled, labels

    runs, printed = {}, io.StringIO()
    cwd = os.getcwd()
    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    reset_counts()  # the main path: the CLI only
    t = time.perf_counter()
    try:
        with mock.patch.object(trainer_module, "create_random_shuffle", recorded), \
                contextlib.redirect_stdout(printed):
            for label, invocations in (("straight", (["--max_epoch", "2"],)),
                                       ("resumed", (["--max_epoch", "1"],
                                                    ["--max_epoch", "2", "--continue_ckpt",
                                                     "auto"]))):
                work = root / f"seq_cli_{label}"
                work.mkdir()
                os.chdir(work)
                first = len(shuffles)
                # the straight run is the reference: its saves (~5 s each)
                # skipped; the resumed one's first run saves its final state only
                with (mock.patch.object(CheckpointManager, "save", lambda *a, **k: None)
                      if label == "straight" else final_saves_only()):
                    for extra in invocations:
                        main_pororo.main(args + extra)
                runs[label] = (work / "output" / "torch" / cfg.CONFIG_NAME, shuffles[first:])
        counts = read_counts()
    finally:
        os.chdir(cwd)
        torch.backends.cudnn.deterministic = saved_det
    seconds = time.perf_counter() - t
    lines = [line for line in printed.getvalue().splitlines()
             if line.startswith(("----[", "Auto-resume"))]
    print(f"{Path(cfg_file).name} CLI output [{card}]:\n  " + "\n  ".join(lines))
    check("Auto-resume from epoch 1" in lines, "the resumed run did not auto-resume at epoch 1")
    (a_dir, a_shuffles), (b_dir, b_shuffles) = runs["straight"], runs["resumed"]
    check(len(a_shuffles) == len(b_shuffles) == 2 * steps_an_epoch,
          f"{len(a_shuffles)} and {len(b_shuffles)} host shuffles, expected "
          f"{2 * steps_an_epoch} each")
    check(a_shuffles == b_shuffles, "the resumed run's host shuffles differ from the straight "
                                    "run's")
    shuffled_a_batch = [float(n) for _, _, n in a_shuffles]
    check(0 < sum(shuffled_a_batch) < len(a_shuffles) * cfg.TRAIN.ST_BATCH_SIZE,
          f"shuffled stories a batch {shuffled_a_batch}: all or none")
    records = {}
    for label, run_dir in (("straight", a_dir), ("resumed", b_dir)):
        rows = [json.loads(line) for line in (run_dir / "log" / "metrics.jsonl").open()]
        records[label] = {(r["tag"], r["step"]): r["value"] for r in rows
                          if not r["tag"].startswith("perf/")}
    a, b = records["straight"], records["resumed"]
    tags = {tag for tag, _ in a}
    want = set(CASCADE_TAGS) - set(CASCADE_G_TAGS) - {"perf/frames_per_sec", "perf/epoch_seconds"}
    check(tags == want, f"seq CLI tags: missing {want - tags}, extra {tags - want}")
    check(set(a) == set(b), "the straight and resumed runs logged different (tag, step)s")
    check(all(np.isfinite(v) for v in a.values()), "the seq CLI logged a non-finite value")
    order = [v for (tag, _), v in a.items() if tag == "st_D/order"]
    check(len(order) == 2 * steps_an_epoch and all(v > 0 for v in order),
          f"st_D/order {order}: expected one positive order BCE a step")
    worst = max(abs(a[k] - b[k]) / (abs(a[k]) + 1e-6) for k in a)
    check(worst <= 1e-4, f"the resumed epoch's metrics differ from the straight run's by {worst}")
    steps = 4 * steps_an_epoch  # 2 epochs in each run
    expected = {k: v * steps for k, v in per_step.items()}
    expected["dfn_forward"] += 4  # a sample grid an epoch
    check(counts == expected, f"seq CLI: launches {counts}, expected {expected}")
    print(f"seq CLI [{card}]: 2 epochs straight, and 1 + an auto-resumed 1: {len(a_shuffles)} host "
          f"shuffles each, the same bits, {shuffled_a_batch} stories shuffled; metrics (tag, step) {len(a)}, largest relative "
          f"difference {worst:.3e} ({'bitwise' if a == b else 'not bitwise'}); st_D/order "
          + ", ".join(f"{v:.4f}" for v in order) + f"; launches {counts}; {seconds:.2f} s in all")
    for label in runs:
        shutil.rmtree(root / f"seq_cli_{label}")
    return counts


def variant_phases(card: str, gen, seed: int, build_dir: Path) -> types.SimpleNamespace:
    """Phases 21-24 (the module docstring), in a temporary directory under
    `build_dir`. Returns the variants' phase 6 records (`runs`, by file),
    phase 23's `new_maps`, and the launches of the seq CLI, the no-seg CLI
    and its serving."""
    import numpy as np
    import torch

    from cpcsv_tpu_torch.data.synthetic import SyntheticStoryDataset, story_batches
    from cpcsv_tpu_torch.evaluation.drivers import Infer

    with tempfile.TemporaryDirectory(prefix="chip_smoke_variants_", dir=build_dir) as tmp:
        variants = write_variants(Path(tmp))
        runs_var = {}
        for fname in ("final_seq.yml", "final_infonce.yml", "final_noseg.yml", "throughput_seq.yml"):
            bf16 = fname == "throughput_seq.yml"
            phase(f"{22 if bf16 else 21}. training at full width{' at bfloat16' if bf16 else ''}, "
                  f"{fname}: {dict(next(v[2] for v in VARIANTS if v[0] == fname))}")
            run = train_at_full_width(variants[fname], seed, card)
            frames = run.cfg.TRAIN.ST_BATCH_SIZE * run.cfg.VIDEO_LEN + run.cfg.TRAIN.IM_BATCH_SIZE
            print(f"{fname} D+G step [{card}]: {run.step_ms:.2f} ms median, "
                  f"{frames / run.step_ms * 1e3:.1f} frames/s ({frames} frames a step); launches a "
                  f"step {run.expected}")
            phase(f"{22 if bf16 else 21}. one D+G step of {fname}, kernels vs plain versions")
            twin_step(run, seed)
            runs_var[fname] = types.SimpleNamespace(
                cfg=run.cfg, expected=run.expected, step_calls=run.step_calls,
                train_counts=run.train_counts, step_ms=run.step_ms, busy_ms=run.busy_ms)
            del run
            torch.cuda.empty_cache()
        phase("23. BN kernels at the variants' new largest maps: the InfoNCE head's B² rows, "
              "the VideoEncoder's stem")
        new_maps = bn_new_maps(gen, card)
        phase(f"24. the variants through the CLI: final_seq.yml --synthetic {SEQ_SYNTHETIC}, 2 "
              "epochs and an auto-resumed epoch; final_noseg.yml, one epoch, served")
        seq_counts = seq_cli(card, variants["final_seq.yml"], runs_var["final_seq.yml"].expected,
                             seed, Path(tmp))
        noseg = runs_var["final_noseg.yml"]
        noseg_tags = (set(CASCADE_TAGS) - set(CASCADE_G_TAGS)
                      - {"seg_D/loss", "seg_D/real", "seg_D/fake", "Accuracy/se_D"})
        noseg_counts, noseg_dir = cli_epoch(
            card, variants["final_noseg.yml"], ["--synthetic", str(CLI_SYNTHETIC)],
            noseg.expected, None, noseg_tags, seed, Path(tmp))
        infer = Infer(noseg.cfg, device="cuda", output_dir=str(noseg_dir), seed=seed,
                      load_ckpt=1)
        batch = next(story_batches(SyntheticStoryDataset(STORY_SIZES[0], seed=seed),
                                   STORY_SIZES[0]))
        reset_counts()  # the main path: the entry point only
        video, mask = infer.sample_videos_np(batch, seg=True)
        served = read_counts()
        check(video.shape == (STORY_SIZES[0], noseg.cfg.VIDEO_LEN, 64, 64, 3) and mask is None
              and bool(np.isfinite(video).all() and (np.abs(video) <= 1).all()),
              f"final_noseg.yml served {video.shape}, mask {mask is not None}, frames finite in "
              "[-1, 1] expected")
        check(served == {"dfn_forward": 1, "dfn_backward": 0, "bn_stats": 0, "bn_grad_reduce": 0},
              f"serving final_noseg.yml launched {served}")
        print(f"final_noseg.yml's epoch-1 snapshot through Infer [{card}]: {video.shape}, no mask, "
              f"|frame| mean {abs(video).mean():.4f} max {abs(video).max():.4f}; {served}")
        del infer
    return types.SimpleNamespace(runs=runs_var, new_maps=new_maps, seq_counts=seq_counts,
                                 noseg_counts=noseg_counts, served=served)


def restore_twin(state, saved) -> None:
    """Every net and optimizer of `state` back to `saved` (nets' state_dicts,
    optimizers' state_dicts), the optimizer states deep-copied: load_state_dict
    keeps tensors already on the device, and a step would update them in place."""
    for n, net in state.nets().items():
        net.load_state_dict(saved[0][n])
        state.opts[n].load_state_dict(copy.deepcopy(saved[1][n]))


def save_twin(state):
    """(the nets' state_dicts, the optimizers' state_dicts), copies."""
    return ({n: {k: v.detach().clone() for k, v in net.state_dict().items()}
             for n, net in state.nets().items()},
            {n: copy.deepcopy(opt.state_dict()) for n, opt in state.opts.items()})


def time_steps(run: types.SimpleNamespace, steps: int = WARMUP_STEPS + TIMED_STEPS,
               warmup: int = WARMUP_STEPS):
    """`steps` D+G steps of phase 6's record on its batches: (ms of the timed
    ones, those after the first `warmup`, host clock between synchronises,
    peak device memory in bytes, launches)."""
    import torch

    rng = torch.Generator(device="cuda").manual_seed(1)
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the main path: the steps only
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run.d_step(run.state, rng, run.st_batch, run.im_batch, LR_D)
        run.g_step(run.state, rng, run.st_batch, run.im_batch, LR_G)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return times[warmup:], torch.cuda.max_memory_allocated(), read_counts()


def median(xs):
    return sorted(xs)[len(xs) // 2]


def remat_phase(run: types.SimpleNamespace, card: str, seed: int, tols=None,
                timed: bool = True) -> dict:
    """Phase 25, on phase 6's final.yml record (phase 34: on cascade.yml's,
    and on throughput.yml's at bfloat16): REMAT, the generator's up blocks
    recomputed in the G step's backward (`torch.utils.checkpoint`). From one
    saved state and the same noise, one D+G step without and one with it
    (cuDNN deterministic): the same metrics and gradients at the float32
    tolerances, or with `tols` at bfloat16 within phase 17's tolerances
    (`twin_step`'s, three times the reordering yardstick) by `step_spread`,
    and the BN state (running statistics, num_batches_tracked) bit for bit,
    the recompute writing none; each BN wrapper at each shape of the REMAT
    step one kernel node in a CUDA graph; then, if `timed`, 2 warm-up and 5
    timed D+G steps of each, ms a step and peak memory, the launches against
    the count from the code. Returns {"counts": launches, "per_step":
    launches a step with REMAT}."""
    import torch

    state, cfg = run.state, run.cfg
    b_st, b_im = cfg.TRAIN.ST_BATCH_SIZE, cfg.TRAIN.IM_BATCH_SIZE
    saved = save_twin(state)
    g_noise = torch.Generator(device="cuda").manual_seed(seed + 2)
    noise = [(state.gen.draw_noise(b_st, cfg.VIDEO_LEN, g_noise),
              state.gen.draw_noise(b_im, 1, g_noise)) for _ in range(2)]
    state.gen.remat = True
    expected = per_step_launches(state)
    state.gen.remat = False

    def one(remat: bool):
        restore_twin(state, saved)
        state.gen.remat = remat
        with counting_bn_calls() as calls:
            reset_counts()
            _, dm = run.d_step(state, noise[0], run.st_batch, run.im_batch, LR_D)
            _, gm = run.g_step(state, noise[1], run.st_batch, run.im_batch, LR_G)
            counts = read_counts()
        buffers = {(n, k): b.detach().clone() for n, net in state.nets().items()
                   for k, b in net.named_buffers()
                   if k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
        return ({k: float(v) for k, v in {**dm, **gm}.items()},
                {(n, k): p.grad.detach().clone() for n, net in state.nets().items()
                 for k, p in net.named_parameters()}, buffers, counts, calls)

    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain, remat = one(False), one(True)
    finally:
        torch.backends.cudnn.deterministic = saved_det
        state.gen.remat = False
    if tols is None:  # float32: the fixed tolerances
        metric_err = max(abs(remat[0][k] - plain[0][k]) / (abs(plain[0][k]) + 1e-3)
                         for k in plain[0])
        grad_err = max(float((remat[1][k] - g).norm() / (g.norm() + 1e-12))
                       for k, g in plain[1].items() if float(g.norm()) > 0)
        check(metric_err <= 1e-4 and grad_err <= 1e-2,
              f"{run.name} REMAT vs none: metric error {metric_err:.3e} (tol 1e-4), gradient "
              f"{grad_err:.3e} (tol 1e-2)")
        held = (f"largest metric error {metric_err:.3e} (tol 1e-4), gradient {grad_err:.3e} "
                "(tol 1e-2)")
    else:  # bfloat16: phase 17's tolerances, the spreads of `step_spread`
        def statistics(reading):
            return {k: v for k, v in reading[2].items() if not k[1].endswith("tracked")}

        errs, _ = step_spread((remat[0], remat[1], statistics(remat)),
                              (plain[0], plain[1], statistics(plain)))
        check(all(e <= t for e, t in zip(errs, tols)),
              f"{run.name} REMAT vs none: spread {errs} above phase 17's tolerances {tols}")
        held = ("spread (metric, accuracy, gradient, zero gradient, BN statistics) "
                + ", ".join(f"{e:.3e} (tol {t:.3e})" for e, t in zip(errs, tols))
                + ", against phase 17's yardstick tolerances")
    bn_equal = all(torch.equal(remat[2][k], v) for k, v in plain[2].items())
    bitwise = (remat[0] == plain[0] and all(torch.equal(remat[1][k], v)
                                            for k, v in plain[1].items()))
    check(bn_equal, f"{run.name} REMAT: the BN running statistics or num_batches_tracked differ "
                    "from the step without it: the recompute wrote BN state")
    check(plain[3] == run.expected and remat[3] == expected,
          f"{run.name} launches of one step: without REMAT {plain[3]}, with {remat[3]}, "
          f"expected {expected}")
    step_calls = {k: dict(sorted(c.items())) for k, c in remat[4].items()}
    new_shapes = {k: set(c) - set(run.step_calls[k]) for k, c in step_calls.items()}
    check(not any(new_shapes.values()), f"REMAT gave the BN kernels new shapes {new_shapes}")
    nodes = bn_graph_nodes(step_calls, torch.bfloat16 if tols is not None else torch.float32)
    check(all(n == {GRAPH_KERNEL_NODE: 1} for n in nodes.values()),
          f"REMAT: a BN call's CUDA graph holds other than one kernel node: {nodes}")
    print(f"{run.name} REMAT vs none, one D+G step from one state and noise, cuDNN deterministic "
          f"[{card}]: {held}, {'bitwise' if bitwise else 'not bitwise'}; BN running "
          f"statistics and num_batches_tracked bit for bit: {bn_equal}; launches a step "
          f"{plain[3]} without, {remat[3]} with (from the code: {expected}); bn_stats calls by "
          f"shape with REMAT: " + ", ".join(f"{sh} x{n}" for sh, n in step_calls["bn_stats"].items())
          + f"; one kernel node a call at each of {len(nodes)} (kernel, shape)s")
    out = {"counts": {k: plain[3][k] + remat[3][k] for k in plain[3]}, "per_step": expected}
    restore_twin(state, saved)
    if not timed:
        return out
    for remat_on in (False, True):
        restore_twin(state, saved)
        state.gen.remat = remat_on
        torch.cuda.empty_cache()
        times, peak, counts = time_steps(run)
        steps = WARMUP_STEPS + TIMED_STEPS
        want = (expected if remat_on else run.expected)
        check(all(counts[k] == want[k] * steps for k in want),
              f"REMAT {remat_on}: launches {counts} in {steps} steps, expected {want} a step")
        for k in counts:
            out["counts"][k] += counts[k]
        key = "remat" if remat_on else "none"
        out[f"{key}_ms"], out[f"{key}_peak_gib"] = median(times), peak / 2**30
        print(f"{run.name} D+G step, REMAT {remat_on} [{card}]: {median(times):.2f} ms median of "
              f"{TIMED_STEPS} (min {min(times):.2f}, max {max(times):.2f}), peak device memory "
              f"{peak / 2**30:.3f} GiB; launches {counts} in {steps} steps")
    state.gen.remat = False
    restore_twin(state, saved)
    print(f"REMAT on {run.name} [{card}]: {out['remat_ms'] / out['none_ms']:.3f}x the step time, "
          f"{out['remat_peak_gib'] / out['none_peak_gib']:.3f}x the peak memory")
    return out


def adam_mu_phase(run: types.SimpleNamespace, card: str, root: Path, timed: bool = True) -> dict:
    """Phase 26, on phase 6's final.yml record (phase 34: on throughput.yml's
    at bfloat16, `timed` False): ADAM_MU_DTYPE bfloat16, the four Adams with
    their first moments in bfloat16, loaded from the float32 states (cast on
    load). The optimizer state's bytes and 2 warm-up and 5 timed D+G steps
    of each (unless `timed`: one step each, the first after the optimizers
    are made), ms a step; finite
    parameters, bfloat16 first and float32 second moments after the steps;
    if `timed`, a save at bfloat16 through `CheckpointManager` restored into
    float32 optimizers, each first moment cast back to float32 with the same
    values. Returns the launches."""
    import torch

    from cpcsv_tpu_torch.train.checkpoint import CheckpointManager
    from cpcsv_tpu_torch.train.state import make_adam

    state = run.state
    saved = save_twin(state)

    def state_bytes(opts):
        return sum(v.numel() * v.element_size() for opt in opts.values()
                   for st in opt.state.values() for v in st.values() if v.dim() > 0)

    counts_all = collections.Counter()
    out = {}
    for mu in ("float32", "bfloat16"):
        opts = {n: make_adam(net.parameters(), mu) for n, net in state.nets().items()}
        for n, opt in opts.items():
            opt.load_state_dict(copy.deepcopy(saved[1][n]))
        state.opts = opts
        restore_twin(state, saved)
        torch.cuda.empty_cache()
        times, peak, counts = time_steps(run) if timed else time_steps(run, 1, 0)
        counts_all.update(counts)
        moments = [(st["exp_avg"].dtype, st["exp_avg_sq"].dtype) for opt in opts.values()
                   for st in opt.state.values()]
        want = (getattr(torch, mu), torch.float32)
        check(all(m == want for m in moments), f"ADAM_MU_DTYPE {mu}: moments {set(moments)}")
        check(all(bool(torch.isfinite(p).all()) for net in state.nets().values()
                  for p in net.parameters()), f"ADAM_MU_DTYPE {mu}: a parameter is not finite")
        out[mu] = (median(times), state_bytes(opts), peak)
        timing = (f"D+G step {median(times):.2f} ms median of {TIMED_STEPS} (min "
                  f"{min(times):.2f}, max {max(times):.2f})" if timed else
                  f"one D+G step {times[0]:.2f} ms (the first with these optimizers)")
        print(f"{run.name} ADAM_MU_DTYPE {mu} [{card}]: {timing}; Adam state "
              f"{state_bytes(opts) / 2**30:.3f} GiB (first and second moments of the 4 nets); "
              f"peak device memory {peak / 2**30:.3f} GiB; launches {counts}")
    if not timed:
        print(f"{run.name} ADAM_MU_DTYPE bfloat16 against float32 [{card}]: "
              f"{out['bfloat16'][1] / out['float32'][1]:.3f}x the Adam state bytes")
        state.opts = {n: make_adam(net.parameters(), "float32") for n, net in state.nets().items()}
        restore_twin(state, saved)
        return dict(counts_all)
    ckpt = CheckpointManager(str(root / "adam_mu"))
    t = time.perf_counter()
    ckpt.save(state, 0)
    save_s = time.perf_counter() - t
    bf16 = {n: {i: st["exp_avg"].clone() for i, st in opt.state_dict()["state"].items()}
            for n, opt in state.opts.items()}
    state.opts = {n: make_adam(net.parameters(), "float32") for n, net in state.nets().items()}
    ckpt.restore(state)
    back = [(st["exp_avg"].dtype, torch.equal(st["exp_avg"], bf16[n][i].float()))
            for n, opt in state.opts.items() for i, st in opt.state_dict()["state"].items()]
    check(all(d == torch.float32 and same for d, same in back),
          "a bfloat16 save restored at float32: first moments not float32 or not the saved "
          "values")
    print(f"a save at ADAM_MU_DTYPE bfloat16 ({save_s:.2f} s) restored into float32 Adams "
          f"[{card}]: {len(back)} first moments float32, equal to the saved bfloat16 values; "
          f"bfloat16 against float32: {out['bfloat16'][0] / out['float32'][0]:.3f}x the step "
          f"time, {out['bfloat16'][1] / out['float32'][1]:.3f}x the Adam state bytes")
    shutil.rmtree(root / "adam_mu")
    restore_twin(state, saved)
    return dict(counts_all)


def clevr_step(card: str, gen, floor: float, seed: int) -> types.SimpleNamespace:
    """Phase 27: clevr.yml at full width (IM 64 / ST 16, 4 frames, gf_dim
    2048, 18-d codes, 8 labels): phases 6 and 7 for it, with frames/s; the BN
    kernels against their plain versions at every (N, C, S) of its step and
    in one CUDA graph each with L2-cold inputs against the library call and
    the bound, as phases 8-9; the DFN pair at B = 64; serving 16 stories of 4
    frames through `Infer` from the trained generator. Returns what the
    kernels line takes."""
    import numpy as np
    import torch

    from cpcsv_tpu_torch.data.synthetic import SyntheticStoryDataset, story_batches
    from cpcsv_tpu_torch.evaluation.drivers import Infer

    run = train_at_full_width(CLEVR_CONFIG, seed, card)
    cfg = run.cfg
    frames = cfg.TRAIN.ST_BATCH_SIZE * cfg.VIDEO_LEN + cfg.TRAIN.IM_BATCH_SIZE
    print(f"{CLEVR_CONFIG} D+G step [{card}]: {run.step_ms:.2f} ms median, "
          f"{frames / run.step_ms * 1e3:.1f} frames/s ({frames} frames a step); launches a step "
          f"{run.expected}")
    twin_step(run, seed)
    shapes = sorted(set(run.step_calls["bn_stats"]) | set(run.step_calls["bn_grad_reduce"]))
    bn_err, plans = bn_vs_plain(gen, shapes, torch.float32)
    print(f"BN kernels vs plain at {CLEVR_CONFIG}'s {len(shapes)} shapes {shapes}, each aligned "
          f"and one float off: max abs error bn_stats {bn_err['bn_stats']:.3e}, bn_grad_reduce "
          f"{bn_err['bn_grad_reduce']:.3e} (tol 1e-5 of the terms' magnitude + 1e-6); plans "
          f"{sorted(plans)}")
    record = types.SimpleNamespace(expected=run.expected, step_calls=run.step_calls,
                                   train_counts=run.train_counts)
    per_shape, step_bn = bn_timings(gen, card, {CLEVR_CONFIG: record}, torch.float32)
    largest = bn_largest(gen, card, {CLEVR_CONFIG: record}, per_shape, torch.float32)
    fwd = dfn_forward_times(gen, card, floor, batches=(CLEVR_DFN_B,))
    bwd, bwd_op, _, copies = dfn_backward_times(gen, card, floor, batches=(CLEVR_DFN_B,))
    check(copies == 0, f"the DFN backward op copied a row-strided dout {copies} times")

    # serving: the trained generator through Infer, 16 stories of 4 frames
    infer = Infer(cfg, {k: v.detach().cpu() for k, v in run.state.gen.state_dict().items()},
                  device="cuda", seed=seed)
    batch = next(story_batches(SyntheticStoryDataset(
        CLEVR_STORIES, cfg.VIDEO_LEN, cfg.IMSIZE, cfg.TEXT.DIMENSION, cfg.LABEL_NUM, seed=seed),
        CLEVR_STORIES))
    reset_counts()  # the main path: the entry point only
    video, _ = infer.sample_videos_np(batch)
    served = read_counts()
    check(video.shape == (CLEVR_STORIES, cfg.VIDEO_LEN, 64, 64, 3)
          and bool(np.isfinite(video).all() and (np.abs(video) <= 1).all()),
          f"{CLEVR_CONFIG} served {video.shape}: expected finite frames in [-1, 1]")
    check(served == {"dfn_forward": 1, "dfn_backward": 0, "bn_stats": 0, "bn_grad_reduce": 0},
          f"serving {CLEVR_CONFIG} launched {served}")
    for _ in range(2):
        infer.sample_videos_np(batch)
    times = []
    for _ in range(5):
        t = time.perf_counter()
        infer.sample_videos_np(batch)
        times.append((time.perf_counter() - t) * 1e3)
    dev, _ = trace(lambda: infer.sample_videos_np(batch), 3)
    busy = sum(by_name(dev, 3).values()) / 1e3
    n_frames = CLEVR_STORIES * cfg.VIDEO_LEN
    print(f"{CLEVR_CONFIG} serving through Infer [{card}]: {video.shape}, |frame| mean "
          f"{abs(video).mean():.4f} max {abs(video).max():.4f}; {median(times):.2f} ms a call "
          f"median of 5 (min {min(times):.2f}, max {max(times):.2f}), "
          f"{n_frames / median(times) * 1e3:.1f} frames/s; device busy {busy:.3f} ms a call, "
          f"idle share {1 - busy / median(times):.3f}; launches {served}")
    del infer, run
    torch.cuda.empty_cache()
    return types.SimpleNamespace(record=record, bn_err=bn_err, per_shape=per_shape,
                                 step_bn=step_bn, largest=largest, fwd=fwd[CLEVR_DFN_B],
                                 bwd=bwd[CLEVR_DFN_B], bwd_op=bwd_op[CLEVR_DFN_B], served=served)


def profile_trace_kernels(profile_dir: Path) -> dict[str, int]:
    """{kernel family: device kernel events} of the one Chrome trace that
    CPCSV_PROFILE_DIR holds."""
    files = list(profile_dir.glob("*.pt.trace.json"))
    check(len(files) == 1, f"CPCSV_PROFILE_DIR {profile_dir} holds {files}: expected one trace")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    families = ("reduce_maps", "reduce_rows", "dfn_forward_kernel", "dfn_backward_kernel")
    out = {f: sum(f in name for name in kernels) for f in families}
    out["all kernels"] = len(kernels)
    out["MB"] = files[0].stat().st_size / 1e6
    return out


def clevr_cli(card: str, per_step: dict[str, int], seed: int, root: Path) -> dict[str, int]:
    """Phase 28, the CLEVR CLI (`python -m cpcsv_tpu_torch.cli.main_clevr`) in
    this process at full clevr.yml width, cuDNN deterministic: --synthetic
    CLEVR_SYNTHETIC for 2 epochs straight with CPCSV_PROFILE_DIR set (its
    checkpoint saves skipped: it is the reference, and a save is ~5 s at
    this width), then in another working directory 1 epoch and a
    --continue_ckpt auto epoch, all at SCAN_STEPS CLEVR_SCAN (clevr.yml's
    keys otherwise, written to a YAML under `root`): 2 chunks an epoch, the
    first pair eager and captured, every later pair a replay, the resumed
    epoch capturing anew in a process state of its own. The resumed run's
    state (nets, Adam states) equals the straight run's bit for bit, and its
    metrics too; the tags, the launches against the steps and grids run.
    The straight run's trace: one file, the second chunk of epoch 0 (its
    first warm one), the BN and DFN kernels by name, as many as its pairs
    launch (a lost event lowers the count, none raises it).
    Then the resumed run's final snapshot (the others removed) walked with
    --eval_ssim 1 at 4 frames a story (phase 34 walks a CLEVR snapshot with
    --eval_fid). Returns the launches."""
    import numpy as np
    import torch

    from cpcsv_tpu_torch.cli import main_clevr
    from cpcsv_tpu_torch.config import config_from_file
    import yaml

    from cpcsv_tpu_torch.train.checkpoint import CheckpointManager

    raw = yaml.safe_load((REPO / "cpcsv_tpu_torch" / "configs" / CLEVR_CONFIG).read_text())
    raw["SCAN_STEPS"] = CLEVR_SCAN
    cfg_file = str(root / f"clevr_scan{CLEVR_SCAN}.yml")
    Path(cfg_file).write_text(yaml.safe_dump(raw))
    cfg = config_from_file(cfg_file)
    args = ["--cfg", cfg_file, "--synthetic", str(CLEVR_SYNTHETIC), "--manualSeed", str(seed)]
    steps_an_epoch = CLEVR_SYNTHETIC // cfg.TRAIN.ST_BATCH_SIZE
    profile_dir = root / "clevr_profile"
    runs, states, printed, seconds = {}, {}, io.StringIO(), {}
    cwd = os.getcwd()
    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    reset_counts()  # the main path: the CLI only
    try:
        with contextlib.redirect_stdout(printed):
            for label, invocations in (("straight", (["--max_epoch", "2"],)),
                                       ("resumed", (["--max_epoch", "1"],
                                                    ["--max_epoch", "2", "--continue_ckpt",
                                                     "auto"]))):
                work = root / f"clevr_cli_{label}"
                work.mkdir()
                os.chdir(work)
                straight = label == "straight"
                env = {"CPCSV_PROFILE_DIR": str(profile_dir)} if straight else {}
                t = time.perf_counter()
                with mock.patch.dict(os.environ, env), (
                        mock.patch.object(CheckpointManager, "save", lambda *a, **k: None)
                        if straight else final_saves_only()):
                    for extra in invocations:
                        states[label] = main_clevr.main(args + extra)
                seconds[label] = time.perf_counter() - t
                runs[label] = work / "output" / "torch" / cfg.CONFIG_NAME
        counts, sampled = read_counts(), sampler_calls()
    finally:
        os.chdir(cwd)
        torch.backends.cudnn.deterministic = saved_det
    lines = [line for line in printed.getvalue().splitlines()
             if line.startswith(("----[", "Auto-resume", "WARNING", "SCAN_STEPS"))]
    print(f"{CLEVR_CONFIG} CLI output [{card}]:\n  " + "\n  ".join(lines))
    check("Auto-resume from epoch 1" in lines, "the resumed CLEVR run did not auto-resume")
    check(lines.count(f"SCAN_STEPS {CLEVR_SCAN}: each chunk's pairs replayed as a CUDA graph of "
                      "the D+G pair") == 3, "the CLEVR CLI runs did not all replay CUDA graphs")

    def flat(state):
        out = {}
        for name, net in state.nets().items():
            out.update({f"{name}.{k}": v for k, v in net.state_dict().items()})
            for i, st in state.opts[name].state_dict()["state"].items():
                out.update({f"{name}.adam.{i}.{k}": v for k, v in st.items()})
        return out

    a, b = flat(states["straight"]), flat(states["resumed"])
    check(set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a),
          "the resumed CLEVR run's full state differs from the straight run's: "
          + str([k for k in a if k not in b or not torch.equal(a[k], b[k])][:5]))
    records = {}
    for label, run_dir in runs.items():
        rows = [json.loads(line) for line in (run_dir / "log" / "metrics.jsonl").open()]
        records[label] = {(r["tag"], r["step"]): r["value"] for r in rows
                          if not r["tag"].startswith("perf/")}
    tags = {tag for tag, _ in records["straight"]}
    want = set(CASCADE_TAGS) - set(CASCADE_G_TAGS) - {"perf/frames_per_sec", "perf/epoch_seconds"}
    check(tags == want, f"CLEVR CLI tags: missing {want - tags}, extra {tags - want}")
    check(records["straight"] == records["resumed"],
          "the resumed CLEVR run's metrics differ from the straight run's")
    check(all(np.isfinite(v) for v in records["straight"].values()),
          "the CLEVR CLI logged a non-finite value")
    steps = 4 * steps_an_epoch  # 2 epochs in each run
    expected = {k: v * steps for k, v in per_step.items()}
    expected["dfn_forward"] += 4  # a sample grid an epoch
    # each process's first grid captured, the straight run's second replayed
    check_sampler(4, "CLEVR CLI's sample grids", sampled, eager=3)
    check(counts == expected, f"CLEVR CLI: launches {counts}, expected {expected}")
    snapshot = torch.load(runs["resumed"] / "Model" / "netG_epoch_2.pth", weights_only=True)
    check(snapshot["ca_net.fc.weight"].shape[1] == cfg.TEXT.DIMENSION * cfg.VIDEO_LEN
          and snapshot["recurrent.weight_ih"].shape[1]
          == cfg.GAN.Z_DIM + cfg.TEXT.DIMENSION + cfg.LABEL_NUM,
          "the CLEVR snapshot's CA input or motion GRU has other than CLEVR's dims")
    fps = [r for r in (json.loads(line) for line in
                       (runs["straight"] / "log" / "metrics.jsonl").open())
           if r["tag"] == "perf/frames_per_sec"]
    print(f"CLEVR CLI [{card}]: 2 epochs of {steps_an_epoch} steps straight ({seconds['straight']:.2f} "
          f"s, the trace included, no saves) and 1 + an auto-resumed 1 ({seconds['resumed']:.2f} "
          f"s, 2 saves: the first run's final and the resumed run's): the state ({len(a)} "
          f"tensors) and {len(records['straight'])} metrics bit for bit; "
          f"frames/s " + ", ".join(f"epoch {r['step']} {r['value']:.1f}" for r in fps)
          + f"; launches {counts}")

    # CPCSV_PROFILE_DIR: the trace of the straight run's second chunk
    traced = profile_trace_kernels(profile_dir)
    n = CLEVR_SCAN
    bn_traced = traced["reduce_maps"] + traced["reduce_rows"]
    bn_launched = n * (per_step["bn_stats"] + per_step["bn_grad_reduce"])
    check(0.99 * bn_launched <= bn_traced <= bn_launched
          and traced["dfn_forward_kernel"] == n * per_step["dfn_forward"]
          and traced["dfn_backward_kernel"] == n * per_step["dfn_backward"],
          f"the CPCSV_PROFILE_DIR trace holds {traced}: expected {n} steps of {per_step}")
    print(f"CPCSV_PROFILE_DIR [{card}]: one trace, {traced['MB']:.1f} MB, of the second chunk "
          f"of epoch 0 (steps {n}-{2 * n - 1}, a CUDA graph replayed {n} times): "
          f"{traced['all kernels']} device "
          f"kernels, the BN kernels {bn_traced} of {bn_launched} launched (reduce_maps "
          f"{traced['reduce_maps']}, reduce_rows {traced['reduce_rows']}), dfn_forward_kernel "
          f"{traced['dfn_forward_kernel']}, dfn_backward_kernel {traced['dfn_backward_kernel']}")

    # the walks at 4 frames a story, on the final snapshot alone
    run_dir = runs["resumed"]
    (run_dir / "Model" / "netG_epoch_1.pth").unlink()  # the one-epoch run's final snapshot
    printed = io.StringIO()
    os.chdir(run_dir.parent.parent.parent)
    reset_counts()
    try:
        with warnings.catch_warnings(), contextlib.redirect_stdout(printed):
            warnings.simplefilter("ignore")
            t = time.perf_counter()
            ssim_rows = main_clevr.main(args + ["--eval_ssim", "1"])
            ssim_s = time.perf_counter() - t
        walk_counts = read_counts()
    finally:
        os.chdir(cwd)
    n_test = max(CLEVR_SYNTHETIC // 4, cfg.TRAIN.ST_BATCH_SIZE)  # the CLI's test set
    check([r["epoch"] for r in ssim_rows] == [2] and all(np.isfinite(r["ssim"]) for r in ssim_rows),
          f"CLEVR walk: SSIM rows {ssim_rows}")
    # the SSIM walk generates the dataset in chunks of 64
    walk_expected = {"dfn_forward": -(-n_test // 64), "dfn_backward": 0,
                     "bn_stats": 0, "bn_grad_reduce": 0}
    check(walk_counts == walk_expected,
          f"CLEVR walk: launches {walk_counts}, expected {walk_expected}")
    print(f"CLEVR walk of epoch 2's snapshot at {cfg.VIDEO_LEN} frames a story, {n_test} "
          f"test stories [{card}]: --eval_ssim {ssim_rows[0]['ssim']!r} in {ssim_s:.2f} s; "
          f"launches {walk_counts}")
    for label in runs:
        shutil.rmtree(root / f"clevr_cli_{label}")
    return {k: counts[k] + walk_counts[k] for k in counts}


def write_clevr_tree(root: Path, train: int, test: int, seed: int) -> Path:
    """A CLEVR-layout tree (`data/clevr.py`): `train` stories from id 1 and
    `test` from id 10001, 4 frames each (160 x 120 PNGs and L masks, half
    CLEVR's 320 x 240 a side) and their 18-d attribute codes, drawn from
    `seed`."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    root.mkdir()
    codes = {}
    for sid in [*range(1, train + 1), *range(10001, 10001 + test)]:
        for t in range(1, 5):
            Image.fromarray(rng.integers(0, 255, (120, 160, 3), dtype=np.uint8)).save(
                root / ("CLEVR_new_%06d_%d.png" % (sid, t)))
            Image.fromarray(rng.integers(0, 255, (120, 160), dtype=np.uint8), "L").save(
                root / ("CLEVR_new_%06d_%d_mask.png" % (sid, t)))
            codes["%d_%d" % (sid, t)] = (rng.random(18) < 0.3).astype(np.float32)
    np.save(root / "CLEVR_dict.npy", codes)
    return root


def clevr_disk(card: str, per_step: dict[str, int], seed: int, root: Path) -> dict[str, int]:
    """Phase 34, the CLEVR loaders from disk: `cli.main_clevr --data_dir` at
    full clevr.yml width on a tree of CLEVR_DISK stories written here, the
    loaders' fixed id ranges (train 1-10000, test 10001-13000) cut to the
    tree's, for one epoch (its final save alone): the launches against the
    steps and the sample grid, finite metrics under the v1 tags, the
    snapshot; then --eval_fid 1 on that snapshot, random-init extractors,
    its Frechet distances by eigenvalues (`frechet_by_eigenvalues`). Returns
    the launches."""
    import numpy as np

    from cpcsv_tpu_torch.cli import main_clevr
    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.data import clevr as clevr_data
    from cpcsv_tpu_torch.evaluation import fid, fsd

    train, test = CLEVR_DISK
    tree = write_clevr_tree(root / "clevr_tree", train, test, seed)
    cfg_file = str(REPO / "cpcsv_tpu_torch" / "configs" / CLEVR_CONFIG)
    cfg = config_from_file(cfg_file)
    args = ["--cfg", cfg_file, "--data_dir", str(tree), "--manualSeed", str(seed)]
    work = root / "clevr_disk"
    work.mkdir()
    printed, cwd, seconds = io.StringIO(), os.getcwd(), {}
    ranges = {"train": (1, 1 + train), "test": (10001, 10001 + test)}
    try:
        os.chdir(work)
        with mock.patch.dict(clevr_data.ID_RANGES, ranges), contextlib.redirect_stdout(printed):
            reset_counts()  # the main path: the CLI's epoch
            t = time.perf_counter()
            with final_saves_only():
                main_clevr.main(args + ["--max_epoch", "1"])
            seconds["epoch"] = time.perf_counter() - t
            counts = read_counts()
            reset_counts()  # the main path: the walk
            with warnings.catch_warnings(), \
                    mock.patch.object(fid, "calculate_frechet_distance", frechet_by_eigenvalues), \
                    mock.patch.object(fsd, "calculate_frechet_distance", frechet_by_eigenvalues):
                warnings.simplefilter("ignore")
                t = time.perf_counter()
                fid_rows = main_clevr.main(args + ["--eval_fid", "1"])
                seconds["walk"] = time.perf_counter() - t
            walk_counts = read_counts()
    finally:
        os.chdir(cwd)
    lines = [line for line in printed.getvalue().splitlines() if line.startswith("----[")]
    print(f"{CLEVR_CONFIG} --data_dir CLI output [{card}]:\n  " + "\n  ".join(lines))
    run_dir = work / "output" / "torch" / cfg.CONFIG_NAME
    steps = train // cfg.TRAIN.ST_BATCH_SIZE
    expected = {k: v * steps for k, v in per_step.items()}
    expected["dfn_forward"] += 1  # the epoch's sample grid
    check(counts == expected, f"CLEVR --data_dir: launches {counts}, expected {expected}")
    records = [json.loads(line) for line in (run_dir / "log" / "metrics.jsonl").open()]
    tags = {r["tag"] for r in records}
    want = set(CASCADE_TAGS) - set(CASCADE_G_TAGS)
    check(tags == want and all(np.isfinite(r["value"]) for r in records)
          and sum(r["tag"] == "st_D/loss" for r in records) == steps,
          f"CLEVR --data_dir: tags missing {want - tags}, extra {tags - want}, or a non-finite "
          f"value, or other than {steps} steps logged")
    check((run_dir / "Model" / "netG_epoch_1.pth").is_file(),
          "CLEVR --data_dir: no final snapshot")
    n_batches = test // cfg.TRAIN.ST_BATCH_SIZE
    check([r["epoch"] for r in fid_rows] == [1]
          and all(np.isfinite([r["fid"], r["vfid"]]).all() and r["fid_random_init"]
                  and r["fsd_random_init"] for r in fid_rows)
          and walk_counts == {"dfn_forward": n_batches, "dfn_backward": 0, "bn_stats": 0,
                              "bn_grad_reduce": 0},
          f"CLEVR --data_dir --eval_fid: rows {fid_rows}, launches {walk_counts}")
    fps = next(r["value"] for r in records if r["tag"] == "perf/frames_per_sec")
    print(f"CLEVR --data_dir [{card}]: {train} train and {test} test stories of 4 160 x 120 "
          f"frames on disk, one epoch of {steps} D+G steps at {cfg.TRAIN.IM_BATCH_SIZE} / "
          f"{cfg.TRAIN.ST_BATCH_SIZE}: {fps:.1f} frames/s (perf/frames_per_sec), "
          f"{seconds['epoch']:.2f} s with the state's init and final save; launches {counts}; "
          f"--eval_fid of its snapshot over {n_batches} test batches: fid "
          f"{fid_rows[0]['fid']!r} fsd {fid_rows[0]['vfid']!r} (random-init extractors) in "
          f"{seconds['walk']:.2f} s, launches {walk_counts}")
    shutil.rmtree(work)
    shutil.rmtree(tree)
    return {k: counts[k] + walk_counts[k] for k in counts}


# ------------------------------------------------------ 29-31: data parallel
def spawn_dp(tag: str, root: Path, world: int, env=None, mode: str = None,
             one_card: bool = True):
    """Start `world` ranks of this script (`--dp-worker mode`, `tag` unless
    named), each in its own process, which makes its CUDA context and then
    waits for its job, handed over in a file named by `tag`: ranks spawned a
    phase ahead start up beside it. With `one_card` the ranks share card 0,
    the only one they see (phases 29-33 read on a host of several cards what
    they read on one); else `env` places them (phase 37: LOCAL_RANK). Returns
    `start(job)`, which writes the job and returns a function that waits
    for the ranks (DP_TIMEOUT) and returns each rank's result. A rank that
    fails fails the phase, its output's tail printed."""
    import atexit

    import torch

    shared = {"CUDA_VISIBLE_DEVICES": "0"} if one_card and torch.cuda.device_count() > 1 else {}

    job_path = root / f"{tag}_job.pt"
    procs, outs = [], []
    atexit.register(kill_all, procs)  # a phase that fails while the ranks run stops them too
    for rank in range(world):
        out = root / f"{tag}_rank{rank}.pt"
        cmd = [sys.executable, str(REPO / "chip_smoke.py"), "--dp-worker", mode or tag,
               "--dp-rank", str(rank), "--dp-world", str(world), "--dp-init",
               f"file://{root / f'{tag}_rendezvous'}", "--dp-job", str(job_path),
               "--dp-out", str(out)]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True, env={**os.environ, **shared,
                                                       **(env(rank) if env else {})}))
        outs.append(out)

    def start(job: dict):
        staged = job_path.with_suffix(".staged")
        torch.save(job, staged)
        os.replace(staged, job_path)  # whole when a rank sees it
        return wait

    def wait():
        logs = []
        try:
            logs = [p.communicate(timeout=DP_TIMEOUT)[0] for p in procs]
        finally:
            kill_all(procs)  # no rank outlives its phase
        for rank, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                print(f"{tag} rank {rank} exited {p.returncode}:\n{log[-6000:]}", flush=True)
        check(all(p.returncode == 0 for p in procs), f"{tag}: a rank failed")
        return [torch.load(o, weights_only=False) for o in outs]

    return start


def kill_all(procs) -> None:
    """Kill and reap every process of `procs` still running."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def grad_bit_sums(state):
    """int64 sums of the bit patterns of every parameter's gradient, in
    `state.nets()` order: equal gradients give equal sums."""
    import torch

    return torch.stack([p.grad.contiguous().view(torch.int32).sum(dtype=torch.int64)
                        for net in state.nets().values() for p in net.parameters()])


def dp_worker(args) -> int:
    """One rank of phases 29-33 (a process of its own, `spawn_dp`):
      steps: phase 29's D+G step on this rank's data shard in a gloo group
             under the job's MESH_SHAPE ("" or phase 32's DP_FOUR), and with
             the job's "model" (phase 32's DP_MODEL) the same step again from
             the same state, each rank the whole global batch;
      nccl:  phase 30's step in an NCCL group of one rank, then timed steps;
             with the job's "scan", phase 35 (b)'s trainer run;
      cli:   phase 31's and 33's CLI runs, the group formed by the CLI from
             the CPCSV_* variables the parent set (none: one process).
    Writes its readings to --dp-out."""
    import torch
    import torch.distributed as dist

    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.data.synthetic import synthetic_batches
    from cpcsv_tpu_torch.parallel import distributed
    from cpcsv_tpu_torch.parallel.mesh import mesh_layout
    from cpcsv_tpu_torch.train.state import create_train_state, state_checksums
    from cpcsv_tpu_torch.train.steps import batch_to_device, make_train_steps

    if "LOCAL_RANK" in os.environ:  # a rank a card (phase 37)
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    torch.zeros(1, device="cuda")  # the CUDA context, before the job arrives
    waited = time.perf_counter()
    while not os.path.exists(args.dp_job):  # `spawn_dp`'s start
        check(time.perf_counter() - waited < SPAWN_WAIT, f"no job in {SPAWN_WAIT} s")
        time.sleep(0.05)
    job = torch.load(args.dp_job, weights_only=False)
    rank, world = args.dp_rank, args.dp_world
    out = {}
    torch.backends.cudnn.deterministic = True
    cfg = config_from_file(job["config"]).with_updates(
        MESH_SHAPE=job.get("mesh", ""), **({"TRAIN": job["train"]} if "train" in job else {}))
    if args.dp_worker in ("steps", "nccl", "multi"):  # the steps form their mesh's data groups
        distributed.initialize_distributed(args.dp_init, world, rank, backend=job["backend"])
    collectives = collections.Counter()
    real_all_reduce = dist.all_reduce

    def data_group_ranks():
        """The ranks of this rank's data group (None: the default group, every rank)."""
        group = distributed.data_group()
        return list(range(world)) if group is None else dist.get_process_group_ranks(group)

    def counted(tensor, *a, **k):
        collectives["all_reduce"] += 1
        collectives["bytes"] += tensor.numel() * tensor.element_size()
        return real_all_reduce(tensor, *a, **k)

    def step_on(state, step_cfg, rows):
        """One D+G step of `step_cfg` on `rows` of the job's global batches,
        with the job's noise: its readings, the launches counted."""
        st = batch_to_device({k: v[rows(len(v))] for k, v in job["st"].items()},
                             torch.device("cuda"))
        im = batch_to_device({k: v[rows(len(v))] for k, v in job["im"].items()},
                             torch.device("cuda"))
        noise = [tuple(tuple(t.cuda() for t in draws) for draws in pair) for pair in job["noise"]]
        d_step, g_step = make_train_steps(step_cfg)
        torch.cuda.synchronize()
        reset_counts()  # the main path: this rank's step
        collectives.clear()
        t = time.perf_counter()
        with mock.patch.object(dist, "all_reduce", counted):
            _, dm = d_step(state, noise[0], st, im, LR_D)
            _, gm = g_step(state, noise[1], st, im, LR_G)
        torch.cuda.synchronize()
        return {"ms": (time.perf_counter() - t) * 1e3, "counts": read_counts(),
                "metrics": {k: float(v) for k, v in {**dm, **gm}.items()},
                "sums": state_checksums(state).cpu().numpy(),
                "grad_bits": grad_bit_sums(state).cpu().numpy(),
                "collectives": dict(collectives),
                "data_group": data_group_ranks()}

    if args.dp_worker == "steps":
        state = create_train_state(cfg, job["seed"])  # checks the replicas against rank 0's
        out["init"] = state_checksums(state).cpu().numpy()
        out["expected"] = per_step_launches(state)
        saved = save_twin(state) if job.get("model") else None
        layout = mesh_layout(cfg.MESH_SHAPE, rank, world)

        def shard(n):
            local = n // layout.data_count
            return slice(layout.data_index * local, (layout.data_index + 1) * local)

        out.update(step_on(state, cfg, shard))
        if rank == 0:
            nets = state.nets()
            out["grads"] = {(n, k): p.grad.cpu() for n, net in nets.items()
                            for k, p in net.named_parameters()}
            out["stats"] = {(n, k): b.cpu() for n, net in nets.items()
                            for k, b in net.named_buffers()
                            if k.endswith(("running_mean", "running_var"))}
        if saved is not None:  # phase 32: a model axis, every rank the whole batch
            restore_twin(state, saved)
            out["model"] = step_on(state, cfg.with_updates(MESH_SHAPE=job["model"]),
                                   lambda n: slice(0, n))
    elif args.dp_worker == "multi":
        out.update(multi_rank(job, rank, world, step_on, collectives, counted))
    elif args.dp_worker == "nccl":
        state = create_train_state(cfg, job["seed"])
        st_host, im_host = synthetic_batches(cfg, cfg.TRAIN.ST_BATCH_SIZE,
                                             cfg.TRAIN.IM_BATCH_SIZE, job["seed"])
        st, im = (batch_to_device(b, torch.device("cuda")) for b in (st_host, im_host))
        rng = torch.Generator(device="cuda").manual_seed(job["seed"])
        d_step, g_step = make_train_steps(cfg)
        out["expected"] = per_step_launches(state)
        reset_counts()  # the main path: one step held bit for bit, then the timed ones
        with mock.patch.object(dist, "all_reduce", counted):
            _, dm = d_step(state, rng, st, im, LR_D)
            _, gm = g_step(state, rng, st, im, LR_G)
        out["data_group"] = data_group_ranks()
        out["metrics"] = {k: float(v) for k, v in {**dm, **gm}.items()}
        out["sums"] = state_checksums(state).cpu().numpy()
        out["grad_bits"] = grad_bit_sums(state).cpu().numpy()
        torch.backends.cudnn.deterministic = False  # timed as phase 6 runs
        times = []
        for _ in range(WARMUP_STEPS + TIMED_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            d_step(state, rng, st, im, LR_D)
            g_step(state, rng, st, im, LR_G)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        out["times"] = times
        out["counts"] = read_counts()
        out["steps"] = 1 + WARMUP_STEPS + TIMED_STEPS
        if job.get("scan"):  # phase 35 (b): the trainer's chunks, captured under NCCL
            del state
            torch.cuda.empty_cache()
            run = scan_trainer_run(scan_config(job["config"], SCAN_PAIRS),
                                   Path(job["root"]) / "scan_nccl", job["seed"])
            out["scan"] = {"history": run.history, "ways": run.ways, "counts": run.counts,
                           "sums": state_checksums(run.state).cpu().numpy(),
                           "seconds": run.seconds}
    else:
        import builtins

        from cpcsv_tpu_torch.cli import main_pororo
        from cpcsv_tpu_torch.train import trainer as trainer_module
        from cpcsv_tpu_torch.train.checkpoint import CheckpointManager

        history, written, real_open = [], [], builtins.open

        def spying_open(file, mode="r", *a, **k):
            if (rank != 0 and isinstance(file, (str, os.PathLike))
                    and any(m in mode for m in "wax+")
                    and str(Path(file).resolve()).startswith(job["root"])):
                written.append(str(file))
            return real_open(file, mode, *a, **k)

        reset_counts()  # the main path: every CLI run of this rank
        with spying_updates(history), mock.patch.object(builtins, "open", spying_open):
            for label, cwd, argv, saves in job["runs"]:
                os.makedirs(cwd, exist_ok=True)
                os.chdir(cwd)
                if label == "walk" and rank == 0:  # walk the final snapshot alone
                    model = Path(cwd) / "output" / "torch" / cfg.CONFIG_NAME / "Model"
                    for f in model.glob("netG_epoch_*.pth"):
                        if f.name != job["walked"]:
                            f.unlink()
                history.clear()
                t = time.perf_counter()
                with {"none": lambda: mock.patch.object(CheckpointManager, "save",
                                                       lambda *a, **k: None),
                      "final": final_saves_only,
                      "all": contextlib.nullcontext}[saves]():
                    returned = main_pororo.main(argv)
                seconds = time.perf_counter() - t
                out[label] = {"history": copy.deepcopy(history), "seconds": seconds}
                if hasattr(returned, "nets"):
                    out[label]["sums"] = state_checksums(returned).cpu().numpy()
                else:
                    out[label]["returned"] = returned
        out["counts"] = read_counts()
        out["written"] = written
    out.setdefault("collectives", dict(collectives))
    torch.save(out, args.dp_out)
    distributed.destroy_distributed()
    return 0


def dp_step_phase(card: str, seed: int, root: Path) -> tuple[dict[str, int], dict]:
    """Phase 29: two gloo ranks sharing the card at full DP_CONFIG width, IM /
    ST the config's a rank (global twice that), one D+G step from one state
    (each rank builds it from the seed, and the group checks) and one global
    batch and noise, against one process on the global batch with the
    kernels (`twin_step` with the yardstick: the kernels' step, the plain
    one and four with the BN sums reordered, cuDNN deterministic): metrics
    and gradients within the float32 tolerances or three times the
    yardstick. Both ranks' parameters, BN running statistics, SN u and Adam
    moments, their gradients and metrics, bit for bit; each rank's BN
    launches a step as phase 6's. The ranks then run phase 32's DP_MODEL
    step. Returns both ranks' launches of phase 29's step, and for phase 32
    the job, the ranks' readings and the one-process step's (metrics, state
    checksums, gradients' bit sums)."""
    import torch

    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.data.synthetic import synthetic_batches
    from cpcsv_tpu_torch.train.state import create_train_state, state_checksums
    from cpcsv_tpu_torch.train.steps import batch_to_device, make_train_steps

    cfg = config_from_file(DP_CONFIG)
    b_st, b_im = cfg.TRAIN.ST_BATCH_SIZE * DP_WORLD, cfg.TRAIN.IM_BATCH_SIZE * DP_WORLD
    st_host, im_host = synthetic_batches(cfg, b_st, b_im, seed)
    state = create_train_state(cfg, seed)
    init = state_checksums(state).cpu().numpy()
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    noise = [(state.gen.draw_noise(b_st, cfg.VIDEO_LEN, gen), state.gen.draw_noise(b_im, 1, gen))
             for _ in range(2)]
    job = {"config": DP_CONFIG, "seed": seed, "backend": "gloo", "st": st_host, "im": im_host,
           "noise": [tuple(tuple(t.cpu() for t in draws) for draws in pair) for pair in noise]}
    t = time.perf_counter()
    wait = spawn_dp("steps", root, DP_WORLD)({**job, "model": DP_MODEL})
    # meanwhile, the one-process reference on the card
    run = types.SimpleNamespace(
        name=f"{DP_CONFIG} at {b_im} / {b_st} in one process", cfg=cfg, state=state,
        st_batch=batch_to_device(st_host, torch.device("cuda")),
        im_batch=batch_to_device(im_host, torch.device("cuda")),
        d_step=make_train_steps(cfg)[0], g_step=make_train_steps(cfg)[1])
    ref = twin_step(run, seed, noise=noise, yard=True)
    ranks = wait()
    seconds = time.perf_counter() - t
    del run, state
    torch.cuda.empty_cache()
    r0, r1 = ranks
    check((r0["init"] == init).all() and (r1["init"] == init).all(),
          "phase 29: a rank built another initial state than one process from the seed")
    same = (r0["metrics"] == r1["metrics"] and (r0["sums"] == r1["sums"]).all()
            and (r0["grad_bits"] == r1["grad_bits"]).all())
    check(same, "phase 29: the ranks' metrics, state or gradients differ")
    for rank, r in enumerate(ranks):
        got = {k: r["counts"][k] for k in r["expected"]}
        check(got == r["expected"], f"phase 29 rank {rank}: launches {got}, a step {r['expected']}")
    two = (r0["metrics"], {k: g.cuda() for k, g in r0["grads"].items()},
           {k: b.cuda() for k, b in r0["stats"].items()})
    errs, (worst, worst_zero, m_key) = step_spread(two, ref["kernels"])
    tols = ref["tolerances"]
    print(f"phase 29 [{card}]: {DP_WORLD} gloo ranks at {cfg.TRAIN.IM_BATCH_SIZE} / "
          f"{cfg.TRAIN.ST_BATCH_SIZE} a rank against one process at {b_im} / {b_st}, one D+G "
          "step from one state, batch and noise: largest metric error {:.3e} (tol {:.3e}, {}), "
          "accuracy {:.3e} (tol {:.3e}), gradient {:.3e} (tol {:.3e}), zero gradient {:.3e} "
          "(tol {:.3e}), BN statistics {:.3e} (tol {:.3e}); worst gradients {}".format(
              errs[0], tols[0], m_key, errs[1], tols[1], errs[2], tols[2], errs[3], tols[3],
              errs[4], tols[4], worst))
    check(all(e <= tol for e, tol in zip(errs, tols)),
          f"phase 29: two ranks vs one process {errs} above {tols}")
    print(f"  the ranks' parameters, BN running statistics, SN u, Adam moments ({len(r0['sums'])} "
          f"tensors), gradients and metrics bit for bit; launches a rank {r0['counts']} (a step: "
          f"{r0['expected']}); all-reduces a rank a step {r0['collectives']['all_reduce']} "
          f"({r0['collectives']['bytes'] / 2**30:.3f} GiB)")
    print(f"  D+G step ms a rank [{card}]: " + ", ".join(f"{r['ms']:.2f}" for r in ranks)
          + f" (the phase {seconds:.1f} s, phase 32's first step included): gloo stages every "
          "all-reduce through the host and the two ranks share one card, so this is no speed "
          "figure")
    kern = ref["kernels"]
    one = (kern[0], kern[3], torch.stack([g.contiguous().view(torch.int32).sum(dtype=torch.int64)
                                          for g in kern[1].values()]).cpu().numpy())
    return ({k: r0["counts"][k] + r1["counts"][k] for k in r0["counts"]},
            {"job": job, "ranks": ranks, "one": one})


def model_axis_phase(card: str, root: Path, p29: dict, four_ranks) -> dict[str, int]:
    """Phase 32, a mesh with a model axis: (a) phase 29's two ranks' step
    under DP_MODEL, each rank the whole global batch in a data group of
    itself, against phase 29's one process on that batch; (b) 2 × DP_WORLD
    gloo ranks under DP_FOUR at half the config's batches a device, rank r
    on data shard r // 2 in the data group {r % 2, r % 2 + 2}, against phase
    29's rank r // 2. Each bit for bit: metrics, state checksums,
    gradients' bit sums (cuDNN deterministic; a data group of one rank adds
    nothing, and a sum of two operands does not depend on their order); each
    rank's BN launches a step as phase 6's; (b)'s ranks spawned ahead
    (`four_ranks`, `spawn_dp`'s start). Returns the launches of both."""
    import dataclasses

    from cpcsv_tpu_torch.config import config_from_file

    def same(r, ref) -> bool:
        return (r["metrics"] == ref[0] and (r["sums"] == ref[1]).all()
                and (r["grad_bits"] == ref[2]).all())

    ranks, one = p29["ranks"], p29["one"]
    for rank, r in enumerate(ranks):
        m = r["model"]
        check(same(m, one), f"phase 32 rank {rank}: the {DP_MODEL} step differs from one "
                            "process's on the same global batch")
        check(m["data_group"] == [rank], f"phase 32 rank {rank}: data group {m['data_group']}")
        got = {k: m["counts"][k] for k in r["expected"]}
        check(got == r["expected"], f"phase 32 rank {rank}: launches {got}, a step "
                                    f"{r['expected']}")
    cfg = config_from_file(DP_CONFIG)
    print(f"phase 32 [{card}]: {DP_WORLD} gloo ranks under MESH_SHAPE {DP_MODEL} at "
          f"{cfg.TRAIN.IM_BATCH_SIZE} / {cfg.TRAIN.ST_BATCH_SIZE} a device, each rank the "
          f"{cfg.TRAIN.IM_BATCH_SIZE * DP_WORLD} / {cfg.TRAIN.ST_BATCH_SIZE * DP_WORLD} global "
          f"batch, one D+G step bit for bit phase 29's one process ({len(one[0])} metrics, "
          f"{len(one[1])} state tensors, {len(one[2])} gradients) on both ranks; data groups "
          f"{[r['model']['data_group'] for r in ranks]}; launches a rank "
          f"{ranks[0]['model']['counts']}; {ranks[0]['model']['collectives']['all_reduce']} "
          f"all-reduces a rank ({ranks[0]['model']['collectives']['bytes'] / 2**30:.3f} GiB); "
          "ms a rank " + ", ".join(f"{r['model']['ms']:.2f}" for r in ranks))
    half = dataclasses.replace(cfg.TRAIN, IM_BATCH_SIZE=cfg.TRAIN.IM_BATCH_SIZE // 2,
                               ST_BATCH_SIZE=cfg.TRAIN.ST_BATCH_SIZE // 2)
    world = 2 * DP_WORLD
    t = time.perf_counter()
    four = four_ranks({**p29["job"], "mesh": DP_FOUR, "train": half})()
    seconds = time.perf_counter() - t
    for rank, r in enumerate(four):
        ref = ranks[rank // 2]
        check(same(r, (ref["metrics"], ref["sums"], ref["grad_bits"])),
              f"phase 32 rank {rank} of {world} under {DP_FOUR}: its step differs from phase "
              f"29's rank {rank // 2}")
        check(r["data_group"] == [rank % 2, rank % 2 + 2],
              f"phase 32 rank {rank} of {world}: data group {r['data_group']}")
        got = {k: r["counts"][k] for k in r["expected"]}
        check(got == r["expected"], f"phase 32 rank {rank} of {world}: launches {got}, a step "
                                    f"{r['expected']}")
    print(f"phase 32 [{card}]: {world} gloo ranks under MESH_SHAPE {DP_FOUR} at "
          f"{half.IM_BATCH_SIZE} / {half.ST_BATCH_SIZE} a device (the same global batch), rank r "
          f"the data shard of phase 29's rank r // 2: one D+G step bit for bit that rank's on "
          f"all {world}; data groups {[r['data_group'] for r in four]}; launches a rank "
          f"{four[0]['counts']}; {four[0]['collectives']['all_reduce']} all-reduces a rank "
          f"({four[0]['collectives']['bytes'] / 2**30:.3f} GiB); ms a rank "
          + ", ".join(f"{r['ms']:.2f}" for r in four) + f" (the launch {seconds:.1f} s; no speed "
          "figure: the ranks share one card and gloo stages through the host)")
    counts = {k: sum(r["model"]["counts"][k] for r in ranks) for k in ranks[0]["model"]["counts"]}
    for r in four:
        for k in counts:
            counts[k] += r["counts"][k]
    return counts


def nccl_phase(card: str, seed: int, root: Path, phase6_ms: float, nccl_rank) -> tuple[dict, dict]:
    """Phase 30: one rank in an NCCL group of one (`initialize_distributed`;
    its data group is the whole world, the default group), so every
    collective runs: its D+G step of DP_CONFIG at the config's
    batches from the seed equals one process's, bit for bit (metrics, state
    checksums, gradients; cuDNN deterministic), an all-reduce of one rank
    being exact. Then WARMUP_STEPS + TIMED_STEPS steps timed as phase 6's:
    their median against phase 6's prices the collectives. The same rank
    then trains phase 35 (b)'s run. The rank is spawned ahead (`nccl_rank`,
    `spawn_dp`'s start). Returns the launches of phase 30 and that run's
    readings."""
    import torch

    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.data.synthetic import synthetic_batches
    from cpcsv_tpu_torch.train.state import create_train_state, state_checksums
    from cpcsv_tpu_torch.train.steps import batch_to_device, make_train_steps

    cfg = config_from_file(DP_CONFIG)
    state = create_train_state(cfg, seed)
    st_host, im_host = synthetic_batches(cfg, cfg.TRAIN.ST_BATCH_SIZE, cfg.TRAIN.IM_BATCH_SIZE,
                                         seed)
    st, im = (batch_to_device(b, torch.device("cuda")) for b in (st_host, im_host))
    rng = torch.Generator(device="cuda").manual_seed(seed)
    d_step, g_step = make_train_steps(cfg)
    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _, dm = d_step(state, rng, st, im, LR_D)
        _, gm = g_step(state, rng, st, im, LR_G)
    finally:
        torch.backends.cudnn.deterministic = saved_det
    metrics = {k: float(v) for k, v in {**dm, **gm}.items()}
    sums, bits = state_checksums(state).cpu().numpy(), grad_bit_sums(state).cpu().numpy()
    del state
    torch.cuda.empty_cache()
    # the rank gets its job after the reference is done: nothing else runs beside its timed steps
    (r,) = nccl_rank({"config": DP_CONFIG, "seed": seed, "backend": "nccl", "scan": True,
                      "root": str(root)})()
    check(r["metrics"] == metrics and (r["sums"] == sums).all() and (r["grad_bits"] == bits).all(),
          "phase 30: the NCCL rank's step differs from one process's")
    check(r["data_group"] == [0], f"phase 30: the NCCL rank's data group {r['data_group']}")
    expected = {k: v * r["steps"] for k, v in r["expected"].items()}
    got = {k: r["counts"][k] for k in expected}
    check(got == expected, f"phase 30: launches {got}, expected {expected}")
    timed = r["times"][WARMUP_STEPS:]
    med = sorted(timed)[len(timed) // 2]
    print(f"phase 30 [{card}]: one NCCL rank, its collectives in its data group, the whole "
          f"world ({r['data_group']}, the default group): its D+G step of {DP_CONFIG} equals one process's bit "
          f"for bit ({len(metrics)} metrics, {len(sums)} state tensors, {len(bits)} gradients); "
          f"{r['collectives']['all_reduce']} all-reduces a step "
          f"({r['collectives']['bytes'] / 2**30:.3f} GiB); step {med:.2f} ms median of "
          f"{TIMED_STEPS} (min {min(timed):.2f}, max {max(timed):.2f}) against phase 6's "
          f"{phase6_ms:.2f} ms: {med - phase6_ms:+.2f} ms for the collectives of one rank")
    return got, r["scan"]


def cli_env(root: Path):
    """Phase 31's ranks' CPCSV_* variables, by rank."""
    return lambda rank: {"CPCSV_COORDINATOR": f"file://{root / 'cli_rendezvous'}",
                         "CPCSV_NUM_PROCESSES": str(DP_WORLD), "CPCSV_PROCESS_ID": str(rank)}


def dp_cli_phase(card: str, seed: int, root: Path, cli_ranks,
                 one_rank) -> tuple[dict[str, int], dict[str, int]]:
    """Phase 31: the Pororo CLI with two gloo ranks on the card
    (CPCSV_COORDINATOR / CPCSV_NUM_PROCESSES / CPCSV_PROCESS_ID, --backend
    gloo), DP_CONFIG --synthetic DP_SYNTHETIC (one step an epoch at the global
    batch), cuDNN deterministic: 2 epochs straight (saves skipped), and in
    another directory 1 epoch (its final save alone) plus an auto-resumed one, whose state and
    metrics equal the straight run's bit for bit; the ranks' metrics equal
    every step; rank 1 opens no file for writing; one metrics row a step;
    then --eval_ssim 1 on the final snapshot (a centralized walk whose
    metric needs no host Frechet: phase 12 holds --eval_fid): rank 0 walks,
    rank 1 waits and returns None. Phase 33 in the same processes: one epoch of DP_CONFIG
    under MESH_SHAPE DP_MODEL (its final save alone), against one process
    (a third, beside them) at the doubled batches, its saves skipped: the
    steps' metrics and the final state bit for bit on both ranks. The
    processes are spawned ahead (`cli_ranks`, `one_rank`: `spawn_dp`'s
    starts, the ranks with `cli_env`). Returns the launches of phase 31 and
    of phase 33, summed over the processes."""
    import numpy as np
    import yaml

    from cpcsv_tpu_torch.config import config_from_file

    cfg = config_from_file(DP_CONFIG)
    cfg_file = str(REPO / "cpcsv_tpu_torch" / "configs" / DP_CONFIG)
    seeded = ["--synthetic", str(DP_SYNTHETIC), "--manualSeed", str(seed)]
    base = ["--cfg", cfg_file, *seeded, "--backend", "gloo"]
    a, b = str(root / "cli_straight"), str(root / "cli_resumed")
    # phase 33's configs: DP_CONFIG under DP_MODEL, and at the doubled batches
    # in one process
    raw = yaml.safe_load(Path(cfg_file).read_text())
    model_file, one_file = root / "model_axis.yml", root / "one_process.yml"
    model_file.write_text(yaml.safe_dump({**raw, "MESH_SHAPE": DP_MODEL}))
    one_file.write_text(yaml.safe_dump({**raw, "TRAIN": {
        **raw["TRAIN"], "IM_BATCH_SIZE": cfg.TRAIN.IM_BATCH_SIZE * DP_WORLD,
        "ST_BATCH_SIZE": cfg.TRAIN.ST_BATCH_SIZE * DP_WORLD}}))
    # saves: the straight run's skipped, the first run's final one alone
    runs = [("straight", a, base + ["--max_epoch", "2"], "none"),
            ("first", b, base + ["--max_epoch", "1"], "final"),
            ("resumed", b, base + ["--max_epoch", "2", "--continue_ckpt", "auto"], "all"),
            ("walk", b, base + ["--eval_ssim", "1"], "all"),
            ("model", str(root / "cli_model"),
             ["--cfg", str(model_file), *seeded, "--backend", "gloo", "--max_epoch", "1"],
             "final")]
    job = {"config": DP_CONFIG, "root": str(root), "runs": runs, "walked": "netG_epoch_2.pth"}
    one_job = {"config": DP_CONFIG, "root": str(root), "runs": [
        ("model", str(root / "cli_one"), ["--cfg", str(one_file), *seeded, "--max_epoch", "1"],
         "none")]}
    t = time.perf_counter()
    wait = cli_ranks(job)
    (one,) = one_rank(one_job)()
    r0, r1 = wait()
    seconds = time.perf_counter() - t
    for label in ("straight", "first", "resumed"):
        check(r0[label]["history"] == r1[label]["history"],
              f"phase 31: the ranks' metrics differ in the {label} run")
        check((r0[label]["sums"] == r1[label]["sums"]).all(),
              f"phase 31: the ranks' states differ after the {label} run")
    check((r0["resumed"]["sums"] == r0["straight"]["sums"]).all()
          and r0["first"]["history"] + r0["resumed"]["history"] == r0["straight"]["history"],
          "phase 31: 1 + an auto-resumed epoch differ from 2 straight ones")
    check(r1["written"] == [], f"phase 31: rank 1 wrote {r1['written'][:5]}")
    log = root / "cli_straight" / "output" / "torch" / cfg.CONFIG_NAME / "log" / "metrics.jsonl"
    rows = [json.loads(line) for line in log.open()]
    st_rows = [row for row in rows if row["tag"] == "st_D/loss"]
    check(len(st_rows) == 2 and all(np.isfinite(row["value"]) for row in rows),
          f"phase 31: {len(st_rows)} st_D/loss rows for 2 steps, or a non-finite value")
    walked = r0["walk"]["returned"]
    check(r1["walk"]["returned"] is None and len(walked) == 1 and walked[0]["epoch"] == 2
          and np.isfinite(walked[0]["ssim"]),
          f"phase 31: the walk returned {walked} on rank 0, {r1['walk']['returned']} on rank 1")
    steps = 5  # 2 + 1 + 1 epochs of one step, and phase 33's one
    for rank, r in enumerate((r0, r1)):
        got = r["counts"]
        check(got["bn_stats"] == 95 * steps and got["bn_grad_reduce"] == 64 * steps
              and got["dfn_backward"] == 2 * steps and got["dfn_forward"] >= 4 * steps,
              f"phase 31 rank {rank}: launches {got} for {steps} steps")
    print(f"phase 31 [{card}]: the CLI with {DP_WORLD} gloo ranks, {DP_CONFIG} --synthetic "
          f"{DP_SYNTHETIC} (one step an epoch at {cfg.TRAIN.IM_BATCH_SIZE * DP_WORLD} / "
          f"{cfg.TRAIN.ST_BATCH_SIZE * DP_WORLD}): the ranks' metrics and states equal; 1 + an "
          f"auto-resumed epoch equal 2 straight ones bit for bit ({len(r0['resumed']['sums'])} "
          f"tensors, {len(r0['straight']['history'])} step metrics); rank 1 wrote no file; "
          f"--eval_ssim on rank 0 while rank 1 waited: ssim {walked[0]['ssim']:.4f}; seconds a "
          f"run on rank 0 "
          + ", ".join(f"{k} {r0[k]['seconds']:.1f}" for k in ("straight", "first", "resumed",
                                                               "walk"))
          + f" (the phase with 33's run {seconds:.1f} s); launches rank 0 {r0['counts']}, rank 1 "
          f"{r1['counts']} (33's step among them)")
    phase(f"33. the CLI on {DP_WORLD} gloo ranks under MESH_SHAPE {DP_MODEL} (in phase 31's "
          "launch), one epoch, against one process at the doubled batches")
    for rank, r in enumerate((r0, r1)):
        check(r["model"]["history"] == one["model"]["history"]
              and len(one["model"]["history"]) == 2
              and (r["model"]["sums"] == one["model"]["sums"]).all(),
              f"phase 33 rank {rank}: the {DP_MODEL} epoch differs from one process's at the "
              "doubled batches")
    check(one["counts"]["bn_stats"] == 95 and one["counts"]["bn_grad_reduce"] == 64,
          f"phase 33: the one process launched {one['counts']} in its step")
    model_file.unlink()
    one_file.unlink()
    print(f"phase 33 [{card}]: the CLI on {DP_WORLD} gloo ranks under MESH_SHAPE {DP_MODEL}, "
          f"{DP_CONFIG} --synthetic {DP_SYNTHETIC} at {cfg.TRAIN.IM_BATCH_SIZE} / "
          f"{cfg.TRAIN.ST_BATCH_SIZE} a device, one epoch of one step, each rank the "
          f"{cfg.TRAIN.IM_BATCH_SIZE * DP_WORLD} / {cfg.TRAIN.ST_BATCH_SIZE * DP_WORLD} batch: "
          f"the metrics and the state ({len(one['model']['sums'])} tensors) bit for bit one "
          f"process's at {cfg.TRAIN.IM_BATCH_SIZE * DP_WORLD} / "
          f"{cfg.TRAIN.ST_BATCH_SIZE * DP_WORLD}, on both ranks; rank 1 wrote no file; seconds "
          f"rank 0 {r0['model']['seconds']:.1f} (its final save included), one process "
          f"{one['model']['seconds']:.1f} (no save); launches of the one process {one['counts']}")
    return ({k: r0["counts"][k] + r1["counts"][k] for k in r0["counts"]}, one["counts"])


def scan_trainer_run(cfg, root: Path, seed: int) -> types.SimpleNamespace:
    """Phase 35 (a)-(b): GANTrainer on `cfg` (2 epochs of SCAN_PAIRS steps
    from SCAN_SYNTHETIC stories, its checkpoint saves skipped), in this
    process or an NCCL rank's, cuDNN deterministic: every pair's metrics (a
    D and a G entry a pair), the final state, the launches, the seconds and
    the CLI's line on how the chunks ran."""
    import torch

    from cpcsv_tpu_torch.cli.main_pororo import synthetic_loaders
    from cpcsv_tpu_torch.train.checkpoint import CheckpointManager
    from cpcsv_tpu_torch.train.trainer import GANTrainer

    history, printed = [], io.StringIO()
    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with spying_updates(history), contextlib.redirect_stdout(printed), \
                mock.patch.object(CheckpointManager, "save", lambda *a, **k: None):
            reset_counts()  # the main path: the trainer only
            torch.cuda.synchronize()
            t = time.perf_counter()
            trainer = GANTrainer(cfg, str(root), seed=seed)
            state = trainer.train(*synthetic_loaders(cfg, SCAN_SYNTHETIC, seed)[:2])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
            counts = read_counts()
    finally:
        torch.backends.cudnn.deterministic = saved_det
    ways = [line for line in printed.getvalue().splitlines() if line.startswith("SCAN_STEPS")]
    return types.SimpleNamespace(history=history, state=state, counts=counts, seconds=seconds,
                                 ways=ways)


def scan_config(name: str, scan: int):
    """A shipped config at SCAN_STEPS `scan`, 2 epochs."""
    import dataclasses

    from cpcsv_tpu_torch.config import config_from_file

    cfg = config_from_file(name)
    return cfg.with_updates(SCAN_STEPS=scan, TRAIN=dataclasses.replace(cfg.TRAIN, MAX_EPOCH=2))


def state_tensors(state) -> dict:
    """Every tensor of a TrainState by name: the nets' state_dicts (parameters,
    BN running statistics, SN u and v) and the Adam states (moments, steps)."""
    out = {}
    for name, net in state.nets().items():
        out.update({f"{name}.{k}": v for k, v in net.state_dict().items()})
        for i, st in state.opts[name].state_dict()["state"].items():
            out.update({f"{name}.adam.{i}.{k}": v for k, v in st.items()})
    return out


def scan_phase(card: str, seed: int, root: Path) -> dict:
    """Phase 35 (a): for each of SCAN_CONFIGS at full width, 2 epochs of
    SCAN_PAIRS steps through GANTrainer at SCAN_STEPS SCAN_PAIRS (a chunk an
    epoch: the first pair eager, then the capture and SCAN_PAIRS - 1 replays;
    the second epoch's chunk all replays, the generator reseeded) against
    SCAN_STEPS 1: every pair's metrics and every tensor of the final state
    (parameters, Adam moments and steps, BN running statistics, SN u and v)
    bit for bit, the launches equal. Returns the launches of the chunked runs
    and the final.yml reference for phase 35 (b)."""
    import torch

    from cpcsv_tpu_torch.train.state import state_checksums

    counts_all, reference = collections.Counter(), None
    for name in SCAN_CONFIGS:
        runs = {}
        for scan in (SCAN_PAIRS, 1):
            runs[scan] = scan_trainer_run(scan_config(name, scan), root / f"{name}_{scan}", seed)
        chunked, pairs = runs[SCAN_PAIRS], runs[1]
        check(chunked.ways == [f"SCAN_STEPS {SCAN_PAIRS}: each chunk's pairs replayed as a CUDA "
                               "graph of the D+G pair"], f"{name}: the trainer said {chunked.ways}")
        a, b = state_tensors(chunked.state), state_tensors(pairs.state)
        differ = [k for k in b if k not in a or not torch.equal(a[k], b[k])]
        check(len(chunked.history) == len(pairs.history) == 2 * 2 * SCAN_PAIRS,
              f"{name}: {len(chunked.history)} and {len(pairs.history)} updates logged")
        rows = [i for i, (x, y) in enumerate(zip(chunked.history, pairs.history)) if x != y]
        check(not differ and not rows and set(a) == set(b),
              f"{name}: SCAN_STEPS {SCAN_PAIRS} against 1: {len(differ)} of {len(b)} state "
              f"tensors differ ({differ[:4]}), metrics differ at updates {rows}")
        check(chunked.counts == pairs.counts,
              f"{name}: launches {chunked.counts} in chunks, {pairs.counts} a pair at a time")
        check(chunked.state.step == pairs.state.step == 2 * SCAN_PAIRS,
              f"{name}: steps {chunked.state.step} and {pairs.state.step}")
        counts_all.update(chunked.counts)
        counts_all.update(pairs.counts)
        print(f"{name} [{card}]: 2 epochs of {SCAN_PAIRS} steps through GANTrainer, SCAN_STEPS "
              f"{SCAN_PAIRS} (CUDA graph: an eager pair, the capture, {2 * SCAN_PAIRS - 1} "
              f"replays) against SCAN_STEPS 1: {len(b)} state tensors and "
              f"{len(pairs.history)} updates' metrics bit for bit; launches {chunked.counts} in "
              f"both; {chunked.seconds:.2f} s against {pairs.seconds:.2f} s (state init, the "
              "capture and the sample grids included)")
        if name == "final.yml":
            reference = types.SimpleNamespace(history=chunked.history,
                                              sums=state_checksums(chunked.state).cpu().numpy())
        del runs, chunked, pairs, a, b
        torch.cuda.empty_cache()
    return {"counts": dict(counts_all), "reference": reference}


def graph_nodes(graph) -> list[tuple[int, int]]:
    """(node handle, CUgraphNodeType) of each node of a kept
    torch.cuda.CUDAGraph, read with CUDA's cuGraphGetNodes: what the graph
    runs on the card, without a profiler."""
    import ctypes

    libcuda = ctypes.CDLL("libcuda.so.1")
    handle, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    check(libcuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0, "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    check(libcuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0, "cuGraphGetNodes failed")
    out = []
    for node in nodes:
        t = ctypes.c_int(-1)
        check(libcuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) == 0,
              "cuGraphNodeGetType failed")
        out.append((node, t.value))
    return out


def graph_node_types(graph) -> collections.Counter:
    """CUgraphNodeType -> nodes of a kept torch.cuda.CUDAGraph."""
    return collections.Counter(t for _, t in graph_nodes(graph))


def raw_device_spans(prof, name_part: str = "") -> list[tuple[int, int]]:
    """(start, end) in ns of the card's events in a finished torch.profiler
    trace whose names hold `name_part`, read from the raw Kineto events:
    building the profiler's event tree costs tens of seconds of host time
    for a chunk's ~10^5 kernels. User annotations' device copies are left
    out, as `device_events` does."""
    from torch.autograd import DeviceType

    return [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
            and name_part in e.name()]


def span_union(spans) -> float:
    """The length of the union of (start, end) intervals: a sum would count
    overlapping kernels and copies twice."""
    busy, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def busy_ms(prof) -> float:
    """The card's busy time in a finished trace: the union of its device
    events' intervals."""
    return span_union(raw_device_spans(prof)) / 1e6


def scan_timing(card: str, seed: int, pair_ms: dict[str, float]) -> dict[str, int]:
    """Phase 35 (c): for SCAN_TIMED_CONFIGS, a chunk of SCAN_TIMED_K pairs
    (the shipped SCAN_STEPS) through `make_scan_steps` on batches staged on
    the card, against SCAN_TIMED_K pairs one at a time through
    `make_train_steps`, each pair's metrics read back as the trainer's pair
    loop reads them: the ms a step (median of windows closed by a readback:
    SCAN_TIMED_CHUNKS warm chunks, each over its pairs; for single pairs
    `pair_ms`, phase 6's or 16's median step of this run, each closed by a
    synchronise),
    the card's busy ms a step (the union of the kernels' intervals) and the
    idle share from one torch.profiler trace (the card's activity only) of
    a warm chunk and of SCAN_TIMED_PAIRS single pairs, the captured
    graph's nodes by type, and the memory the capture took. Returns the
    launches and each config's chunk ms a step."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.data.synthetic import synthetic_batches
    from cpcsv_tpu_torch.train.state import create_train_state
    from cpcsv_tpu_torch.train.steps import batch_to_device, make_scan_steps, make_train_steps

    counts, chunk_ms_of = collections.Counter(), {}
    K = SCAN_TIMED_K
    for name in SCAN_TIMED_CONFIGS:
        cfg = config_from_file(name)
        state = create_train_state(cfg, seed)
        hosts = [synthetic_batches(cfg, cfg.TRAIN.ST_BATCH_SIZE, cfg.TRAIN.IM_BATCH_SIZE, seed + i)
                 for i in range(4)]
        order = [hosts[k % len(hosts)] for k in range(K)]
        dev = torch.device("cuda")
        st_k = batch_to_device({f: np.stack([b[0][f] for b in order]) for f in order[0][0]}, dev)
        im_k = batch_to_device({f: np.stack([b[1][f] for b in order]) for f in order[0][1]}, dev)
        pairs = [tuple(batch_to_device(b, dev) for b in h) for h in hosts]
        rng = torch.Generator(device="cuda").manual_seed(seed)
        scan = make_scan_steps(cfg)
        reset_counts()  # the main path: the chunks and the single pairs below

        def chunk():
            _, metrics = scan(state, rng, st_k, im_k, LR_D, LR_G)
            return torch.stack(list(metrics.values()), 1).tolist()  # the one readback

        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        rows = chunk()
        first_s = time.perf_counter() - t
        check(len(rows) == K and all(np.isfinite(v) for row in rows for v in row),
              f"{name}: the first chunk's metrics {len(rows)} rows, or a non-finite value")
        peak, pool = torch.cuda.max_memory_allocated(), torch.cuda.memory_reserved() - reserved
        (graph,) = scan.graphs.graphs.values()
        nodes = graph_node_types(graph.graph)
        windows = []
        for _ in range(SCAN_TIMED_CHUNKS):
            t = time.perf_counter()
            chunk()
            windows.append((time.perf_counter() - t) * 1e3 / K)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            chunk()
            traced_s = time.perf_counter() - t
        busy = busy_ms(prof) / K
        chunk_ms = chunk_ms_of[name] = median(windows)

        d_step, g_step = make_train_steps(cfg)

        def pair(k):
            st, im = pairs[k % len(pairs)]
            _, dm = d_step(state, rng, st, im, LR_D)
            _, gm = g_step(state, rng, st, im, LR_G)
            metrics = {**dm, **gm}
            return torch.stack([v.float().reshape(()) for v in metrics.values()]).tolist()

        # on the chunks' stream, where the state's gradient accumulators were made
        with scan.graphs.stream(dev), profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for k in range(SCAN_TIMED_PAIRS):
                pair(k)
            traced_pairs_s = time.perf_counter() - t
        busy_pairs = busy_ms(prof) / SCAN_TIMED_PAIRS
        eager_ms = pair_ms[name]
        got = read_counts()
        counts.update(got)
        steps = (2 + SCAN_TIMED_CHUNKS) * K + SCAN_TIMED_PAIRS
        per_step = per_step_launches(state)
        check(got == {k: v * steps for k, v in per_step.items()},
              f"{name}: launches {got} for {steps} pairs of {per_step}")
        kernel_nodes = nodes[GRAPH_KERNEL_NODE]
        print(f"{name} SCAN_STEPS {K} [{card}]: first chunk {first_s:.2f} s (an eager pair, the "
              f"capture, {K - 1} replays); warm chunks {chunk_ms:.2f} ms a step (median of "
              f"{SCAN_TIMED_CHUNKS} chunks, each closed by its readback; "
              + ", ".join(f"{w:.2f}" for w in windows) + f"), busy {busy:.2f} ms a step "
              f"(traced chunk {traced_s * 1e3 / K:.2f} ms a step): idle share "
              f"{1 - busy / chunk_ms:.3f} untraced, {1 - busy * K / (traced_s * 1e3):.3f} traced")
        print(f"{name} one pair at a time [{card}]: {eager_ms:.2f} ms a step (phase "
              f"{16 if name in BF16_CONFIGS else 6}'s median), busy {busy_pairs:.2f} ms a step "
              f"over {SCAN_TIMED_PAIRS} pairs, each read back (traced "
              f"{traced_pairs_s * 1e3 / SCAN_TIMED_PAIRS:.2f} ms a step): idle share "
              f"{1 - busy_pairs / eager_ms:.3f} untraced, "
              f"{1 - busy_pairs * SCAN_TIMED_PAIRS / (traced_pairs_s * 1e3):.3f} traced; the chunk "
              f"{chunk_ms / eager_ms:.3f}x the pair's ms a step")
        print(f"{name} captured pair [{card}]: {sum(nodes.values())} graph nodes, {kernel_nodes} "
              f"kernel nodes (by CUgraphNodeType {dict(sorted(nodes.items()))}); memory reserved "
              f"by the first chunk {pool / 2**30:.3f} GiB, peak allocated {peak / 2**30:.3f} GiB "
              f"(the state, {K} staged batches, the eager pair and the graph's pool)")
        del state, scan, graph, st_k, im_k, pairs
        torch.cuda.empty_cache()
    return dict(counts), chunk_ms_of


def same_snapshot(a: Path, b: Path) -> list:
    """The keys at which two torch.save'd checkpoints differ: tensors bit for
    bit, anything else by ==."""
    import torch

    def flat(obj, key=()):
        if isinstance(obj, dict):
            for k, v in obj.items():
                yield from flat(v, key + (k,))
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                yield from flat(v, key + (i,))
        else:
            yield key, obj

    x, y = (dict(flat(torch.load(p, map_location="cpu", weights_only=False))) for p in (a, b))
    return sorted((k for k in x.keys() | y.keys() if k not in x or k not in y or not (
        torch.equal(x[k], y[k]) if isinstance(x[k], torch.Tensor) else x[k] == y[k])), key=str)


def multi_rank(job: dict, rank: int, world: int, step_on, collectives, counted) -> dict:
    """One NCCL rank of phase 37, on its own card (LOCAL_RANK), cuDNN
    deterministic: (c) one D+G step of the job's config on its data shard of
    the job's global batch and noise (`step_on`); with the job's "chunk",
    (b) a chunk of MULTI_PAIRS pairs through `make_scan_steps` on its shard
    of fresh global batches (the first pair eager, then the capture and
    replays), the graph's kernel nodes by name and the all-reduces the pair
    issued, then the same pairs eagerly from the state before the chunk;
    then, cuDNN at its defaults as in phase 35 (c), for each of the job's
    "timed" configs a fresh state, a first chunk of 2 pairs (the capture),
    SCAN_TIMED_CHUNKS warm chunks of SCAN_TIMED_K pairs timed, the memory
    the capture took and the state's checksums after; with the job's
    "trace" one more chunk of the job's config, traced on rank 0: the
    card's busy time and NCCL's kernels' share. The launches of each part."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.data.synthetic import synthetic_batches
    from cpcsv_tpu_torch.train.state import create_train_state, state_checksums
    from cpcsv_tpu_torch.train.steps import batch_to_device, make_scan_steps, make_train_steps

    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"card": dev.index, "uuid": str(getattr(torch.cuda.get_device_properties(dev), "uuid",
                                                  dev.index))}
    cfg = config_from_file(job["config"])
    state = create_train_state(cfg, job["seed"])
    out["expected"] = per_step_launches(state)

    def shard(n):
        local = n // world
        return slice(rank * local, (rank + 1) * local)

    def local_chunk(c, k: int, seed: int):
        """k pairs of this rank's shard of fresh global batches of config c,
        stacked on its card (4 batches at most, repeated)."""
        hosts = [synthetic_batches(c, c.TRAIN.ST_BATCH_SIZE * world, c.TRAIN.IM_BATCH_SIZE * world,
                                   seed + i) for i in range(min(k, 4))]
        order = [hosts[i % len(hosts)] for i in range(k)]
        return tuple(batch_to_device({f: np.stack([b[j][f][shard(len(b[j][f]))] for b in order])
                                      for f in order[0][j]}, dev) for j in (0, 1))

    # the step on the side stream of (b)'s chunk: the gradient accumulators
    # it leaves (spectral norm's cached weights hold them) must live on the
    # stream the chunk captures on (`train/graphs.py`)
    scan = make_scan_steps(cfg) if job.get("chunk") else None
    with scan.graphs.stream(dev) if scan else contextlib.nullcontext():
        out["step"] = step_on(state, cfg, shard)
    if rank == 0:
        nets = state.nets()
        out["grads"] = {(n, k): p.grad.cpu() for n, net in nets.items()
                        for k, p in net.named_parameters()}
        out["stats"] = {(n, k): b.to("cpu", copy=True) for n, net in nets.items()
                        for k, b in net.named_buffers() if k.endswith(("running_mean",
                                                                        "running_var"))}
    if job.get("chunk"):
        saved = save_twin(state)
        st_k, im_k = local_chunk(cfg, MULTI_PAIRS, job["seed"] + 10)
        rng = torch.Generator(device=dev)
        rng.manual_seed(job["seed"] + 3)
        reset_counts()
        collectives.clear()
        with mock.patch.object(dist, "all_reduce", counted):
            _, metrics = scan(state, rng, st_k, im_k, LR_D, LR_G)
        rows = torch.stack(list(metrics.values()), 1).tolist()
        (graph,) = scan.graphs.graphs.values()
        names = kernel_node_names(graph.graph)
        out["chunk"] = {"rows": rows, "sums": state_checksums(state).cpu().numpy(),
                        "counts": read_counts(), "kernel_nodes": len(names),
                        "nccl_nodes": sum("nccl" in n.lower() for n in names),
                        # the eager pair's and the capture's calls
                        "all_reduces": collectives["all_reduce"]}
        restore_twin(state, saved)
        rng.manual_seed(job["seed"] + 3)
        d_step, g_step = make_train_steps(cfg)
        rows = []
        reset_counts()
        with scan.graphs.stream(dev):  # where the chunk made the gradient accumulators
            for k in range(MULTI_PAIRS):
                st, im = ({f: v[k] for f, v in b.items()} for b in (st_k, im_k))
                _, dm = d_step(state, rng, st, im, LR_D)
                _, gm = g_step(state, rng, st, im, LR_G)
                rows.append(torch.stack([v.float().reshape(()) for v in {**dm, **gm}.values()])
                            .tolist())
        out["eager"] = {"rows": rows, "sums": state_checksums(state).cpu().numpy(),
                        "counts": read_counts()}
        del scan, graph, saved, st_k, im_k
    del state
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False  # timed as phase 35 (c) runs
    out["timed"] = {}
    for name in job.get("timed", ()):
        tcfg = config_from_file(name)
        state = create_train_state(tcfg, job["seed"])
        st_k, im_k = local_chunk(tcfg, SCAN_TIMED_K, job["seed"])
        scan = make_scan_steps(tcfg)
        rng = torch.Generator(device=dev).manual_seed(job["seed"])

        def chunk(st, im):
            _, metrics = scan(state, rng, st, im, LR_D, LR_G)
            return torch.stack(list(metrics.values()), 1).tolist()  # the one readback

        reset_counts()
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
        t = time.perf_counter()
        rows = chunk(*({f: v[:2] for f, v in b.items()} for b in (st_k, im_k)))
        first_s = time.perf_counter() - t
        pool = torch.cuda.memory_reserved() - reserved
        windows = []
        for _ in range(SCAN_TIMED_CHUNKS):
            t = time.perf_counter()
            rows += chunk(st_k, im_k)
            windows.append((time.perf_counter() - t) * 1e3 / SCAN_TIMED_K)
        pairs, traced = 2 + SCAN_TIMED_CHUNKS * SCAN_TIMED_K, None
        if job.get("trace") and name == job["config"]:  # every rank runs it, rank 0 traces
            with (profile(activities=[ProfilerActivity.CUDA]) if rank == 0
                  else contextlib.nullcontext()) as prof:
                chunk(st_k, im_k)
            pairs += SCAN_TIMED_K
            if rank == 0:
                traced = {"busy_ms": span_union(raw_device_spans(prof)) / 1e6 / SCAN_TIMED_K,
                          "nccl_ms": span_union(raw_device_spans(prof, "nccl")) / 1e6
                          / SCAN_TIMED_K}
        out["timed"][name] = {
            "first_s": first_s, "windows": windows, "pool": pool, "pairs": pairs,
            "finite": bool(np.isfinite(rows).all()), "counts": read_counts(),
            "expected": per_step_launches(state), "traced": traced,
            "sums": state_checksums(state).cpu().numpy()}
        del state, scan, st_k, im_k
        torch.cuda.empty_cache()
    return out


def run_command(argv: list, cwd: Path, env: dict, timeout: float) -> tuple[int, str, float]:
    """A command in a session of its own: (its exit code, its output, its
    seconds); at `timeout` the whole session is killed, ranks and all."""
    t = time.perf_counter()
    p = subprocess.Popen(argv, cwd=cwd, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        text, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        text, _ = p.communicate()
        text += f"\n(killed at its {timeout} s time limit)"
    return p.returncode, text, time.perf_counter() - t


def rank_pids(parent: int) -> list[int]:
    """The processes `parallel.launch.run_ranks` spawned under `parent`
    (their command lines run multiprocessing's spawn_main), by pid."""
    pids = []
    for d in filter(str.isdigit, os.listdir("/proc")):
        try:
            stat = Path(f"/proc/{d}/stat").read_text()
            cmdline = Path(f"/proc/{d}/cmdline").read_bytes()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == parent and b"spawn_main" in cmdline:
            pids.append(int(d))
    return sorted(pids)


def alive(pid: int) -> bool:
    """Whether a process runs (a zombie does not)."""
    try:
        os.kill(pid, 0)
        return Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0] != "Z"
    except (ProcessLookupError, FileNotFoundError):
        return False


def free_port() -> int:
    """A TCP port of 127.0.0.1 that nothing listens on now."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def host_split(cards: int) -> int:
    """Phase 38's cards a "host": half of an even count of 4 or more, else 1
    (two hosts of one card each)."""
    return cards // 2 if cards >= 4 and cards % 2 == 0 else 1


def host_envs(env: dict, per_host: int) -> list[dict]:
    """Phase 38's two host commands' environments: host h sees cards h × per_host
    .. h × per_host + per_host − 1 alone (CUDA_VISIBLE_DEVICES), and both meet at
    127.0.0.1 on a free port (CPCSV_COORDINATOR, CPCSV_NUM_PROCESSES 2,
    CPCSV_PROCESS_ID h)."""
    port = free_port()
    return [{**env, "CUDA_VISIBLE_DEVICES": ",".join(
                 str(h * per_host + i) for i in range(per_host)),
             "CPCSV_COORDINATOR": f"127.0.0.1:{port}", "CPCSV_NUM_PROCESSES": "2",
             "CPCSV_PROCESS_ID": str(h)} for h in range(2)]


def said_cards(text: str) -> list[str]:
    """The card of each rank, as a trainer's 'DATA PARALLEL cards:' line says."""
    line = next((ln for ln in text.splitlines() if ln.startswith("DATA PARALLEL cards: ")), "")
    return [part.split(" ", 2)[2] for part in line.removeprefix("DATA PARALLEL cards: ")
            .split(", ") if part]


def nccl_choice(text: str) -> list[str]:
    """NCCL's own lines (NCCL_DEBUG=INFO) on its version, the settings it
    read, its rings and its transports, deduplicated, at most 12."""
    keys = ("NCCL version", "NCCL_ALGO", "NCCL_PROTO", "Channel 00", "via ", "comm 0x")
    found = []
    for line in text.splitlines():
        rest = line.split("NCCL INFO ", 1)[-1].strip()
        if "NCCL INFO" in line and any(k in rest for k in keys) and rest not in found:
            found.append(rest)
    return found[:12]


def multi_cli(card: str, seed: int, root: Path, world: int) -> dict:
    """Phase 37 (e)-(f) and 38: `python -m cpcsv_tpu_torch.cli.main_pororo
    --cfg MULTI_CLI --synthetic N`, no process group in its environment but
    the ones named, N the global story batch (one step an epoch), cuDNN
    deterministic in every process (`deterministic_site`), NCCL's algorithm
    and protocol pinned (HOST_NCCL, which also has NCCL say its choice):
    (e) 2 epochs as one command that starts `world` ranks (the trainer says
    so, with the global batches and every rank's card); one run directory,
    one metrics row a step. 38: in another directory 1 epoch plus
    --continue_ckpt auto, each as two host commands (`host_envs`: two hosts
    of `host_split(world)` cards, CPCSV_COORDINATOR at 127.0.0.1), rank r on
    physical card r; the resumed checkpoint bit for bit the one-command
    run's when the hosts hold its `world` cards. (f) on 4 cards or more a
    longer run as two host commands whose last rank, on host 1, is killed
    MULTI_KILL_AFTER seconds after host 1's ranks began training: both
    commands exit non-zero within MULTI_KILL_BOUND seconds, no rank alive
    (on 2-3 cards one command of `world` ranks). Returns the
    seconds of each command."""
    import torch

    from cpcsv_tpu_torch.config import config_from_file

    cfg_file = str(REPO / "cpcsv_tpu_torch" / "configs" / MULTI_CLI)
    cfg = config_from_file(cfg_file)
    env = {k: v for k, v in os.environ.items() if k not in GROUP_VARIABLES}
    env["PYTHONPATH"] = os.pathsep.join([deterministic_site(root / "site"), str(REPO)])
    env.update(HOST_NCCL)
    per_host = host_split(world)
    hosts_world = 2 * per_host
    uuids = [str(getattr(torch.cuda.get_device_properties(i), "uuid", i)) for i in range(world)]

    def said(w, hosts, per):
        return (f"DATA PARALLEL: {w} ranks on {hosts} host(s) of {per}, MESH_SHAPE data:{w}, "
                f"global batches IM {cfg.TRAIN.IM_BATCH_SIZE * w} / ST {cfg.TRAIN.ST_BATCH_SIZE * w}")

    def base(w):
        return [sys.executable, "-m", "cpcsv_tpu_torch.cli.main_pororo", "--cfg", cfg_file,
                "--synthetic", str(cfg.TRAIN.ST_BATCH_SIZE * w), "--manualSeed", str(seed)]

    seconds, outputs = {}, {}
    (root / "a").mkdir(exist_ok=True)
    code, outputs["straight"], seconds["straight"] = run_command(
        base(world) + ["--max_epoch", "2"], root / "a", env, 600)
    if code != 0:
        print(outputs["straight"][-6000:])
    check(code == 0, f"phase 37 (e): the straight command exited {code}")
    check(said(world, 1, world) in outputs["straight"],
          f"phase 37 (e): the command's output lacks '{said(world, 1, world)}'")
    check(said_cards(outputs["straight"]) == uuids,
          f"phase 37 (e): the ranks' cards {said_cards(outputs['straight'])}, not {uuids}")
    runs = root / "a" / "output" / "torch"
    check(os.listdir(runs) == [cfg.CONFIG_NAME],
          f"phase 37 (e): run directories {os.listdir(runs)}")
    rows = [json.loads(line) for line in (runs / cfg.CONFIG_NAME / "log" / "metrics.jsonl").open()]
    check(sum(r["tag"] == "st_D/loss" for r in rows) == 2,
          "phase 37 (e): not one st_D/loss row a step of the 2 (rank 0 alone logs)")
    print(f"phase 37 (e) [{card}]: `python -m cpcsv_tpu_torch.cli.main_pororo --cfg {MULTI_CLI} "
          f"--synthetic {cfg.TRAIN.ST_BATCH_SIZE * world}` with no process group in its "
          f"environment: '{said(world, 1, world)}', rank r on card r; one run directory, one "
          f"metrics row a step; {seconds['straight']:.1f} s. NCCL ({HOST_NCCL}): "
          + " | ".join(nccl_choice(outputs["straight"])))

    phase(f"38. training across hosts: two host commands of {per_host} card(s) each "
          f"(CUDA_VISIBLE_DEVICES), CPCSV_COORDINATOR at 127.0.0.1, 1 epoch + --continue_ckpt auto")
    (root / "b").mkdir(exist_ok=True)
    for label, extra in (("first", ["--max_epoch", "1"]),
                         ("resumed", ["--max_epoch", "2", "--continue_ckpt", "auto"])):
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            done = list(pool.map(lambda e: run_command(base(hosts_world) + extra, root / "b", e,
                                                       600), host_envs(env, per_host)))
        for h, (code, text, secs) in enumerate(done):
            outputs[label, h], seconds[label, h] = text, secs
            if code != 0:
                print(text[-6000:])
            check(code == 0, f"phase 38: host {h}'s {label} command exited {code}")
        host0 = outputs[label, 0]
        check(said(hosts_world, 2, per_host) in host0,
              f"phase 38: host 0's {label} output lacks '{said(hosts_world, 2, per_host)}'")
        check(said_cards(host0) == uuids[:hosts_world],
              f"phase 38: the {label} ranks' cards {said_cards(host0)}, not "
              f"{uuids[:hosts_world]}")
    check("Auto-resume from epoch 1" in outputs["resumed", 0],
          "phase 38: the resumed commands did not print 'Auto-resume from epoch 1'")
    model = Path("output", "torch", cfg.CONFIG_NAME, "Model")
    held = hosts_world == world
    # the one command's snapshots (its epoch 0 and its end); the hosts' first
    # command also wrote netG_epoch_1 at its end
    snapshots = sorted(p.name for p in (root / "a" / model).glob("*.pth"))
    if held:
        missing = sorted(set(snapshots) - {p.name for p in (root / "b" / model).glob("*.pth")})
        check(not missing, f"phase 38: the two hosts wrote no {missing}")
        for name in snapshots:
            differ = same_snapshot(root / "a" / model / name, root / "b" / model / name)
            check(not differ, f"phase 38: the two hosts' {name} differs from the one command's "
                              f"at {differ[:4]} ({len(differ)} keys)")
    print(f"phase 38 [{card}]: two host commands of {per_host} card(s) each, CUDA_VISIBLE_DEVICES "
          f"{[e['CUDA_VISIBLE_DEVICES'] for e in host_envs({}, per_host)]}: "
          f"'{said(hosts_world, 2, per_host)}', rank r on physical card r (by UUID); 1 epoch + "
          "--continue_ckpt auto "
          + (f"equal the one command's 2 epochs bit for bit ({', '.join(snapshots)}; "
             "train_state_last.pth: every net, Adam state and the step)" if held else
             f"not held against the one command's {world} cards (another global batch)")
          + "; seconds a command by host: "
          + ", ".join(f"{k[0]} host {k[1]} {v:.1f}" for k, v in seconds.items()
                      if isinstance(k, tuple))
          + ". NCCL on host 0: " + " | ".join(nccl_choice(outputs["resumed", 0])))

    kill_hosts = world >= 4
    (root / "k").mkdir()
    envs = host_envs(env, per_host) if kill_hosts else [env]
    argv = (base(hosts_world) if kill_hosts else base(world)) + ["--max_epoch", "100"]
    procs = [subprocess.Popen(argv, cwd=root / "k", env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, start_new_session=True)
             for e in envs]
    lines = [[] for _ in procs]
    ranks, codes, ends = [], [None] * len(procs), [None] * len(procs)
    try:
        watched = procs[-1]  # the host of the rank killed
        for line in watched.stdout:
            lines[-1].append(line)
            if line.startswith("LR DECAY EPOCH"):  # its first rank's state is built
                break
        drains = [threading.Thread(target=lambda i=i: lines[i].extend(procs[i].stdout),
                                   daemon=True) for i in range(len(procs))]
        for d in drains:
            d.start()
        time.sleep(MULTI_KILL_AFTER)
        ranks = [rank_pids(p.pid) for p in procs]
        want = per_host if kill_hosts else world
        check(all(len(r) == want for r in ranks), f"phase 37 (f): ranks under the commands "
                                                  f"{[len(r) for r in ranks]}, not {want} each")
        os.kill(ranks[-1][-1], signal.SIGKILL)
        t = time.perf_counter()
        for i, p in enumerate(procs):
            codes[i] = p.wait(timeout=MULTI_KILL_BOUND + 60)
            ends[i] = time.perf_counter() - t
        for d in drains:
            d.join(10)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    texts = ["".join(ln) for ln in lines]
    left = [pid for r in ranks for pid in r if alive(pid)]
    killed = (hosts_world if kill_hosts else world) - 1
    check(all(c not in (None, 0) for c in codes) and all(e <= MULTI_KILL_BOUND for e in ends)
          and not left,
          f"phase 37 (f): killed rank {killed}; the commands exited {codes} after {ends} s "
          f"(bound {MULTI_KILL_BOUND} s), ranks left {left}; their outputs' ends:\n"
          + "\n".join(t[-3000:] for t in texts))
    check(all(f"rank {killed} of {killed + 1} exited {128 + signal.SIGKILL}" in t for t in texts),
          f"phase 37 (f): a command did not name the killed rank: {[t[-2000:] for t in texts]}")
    print(f"phase {'38 (f)' if kill_hosts else '37 (f)'} [{card}]: rank {killed}'s process "
          f"killed {MULTI_KILL_AFTER} s after {'host 1' if kill_hosts else 'the command'}'s "
          f"ranks began training: the command(s) exited {codes} after "
          + ", ".join(f"{e:.2f}" for e in ends) + f" s (bound {MULTI_KILL_BOUND} s), none of "
          f"their ranks alive")
    return seconds


def multi_card_phase(card: str, seed: int, root: Path, world: int, ranks: dict,
                     one_card: dict) -> dict:
    """Phase 37 on a host of `world` >= 2 cards, the ranks spawned ahead
    (`ranks`: "all" on every card, "two" on cards 0-1 where there are more,
    "four" under DP_FOUR where there are 4 or more). (c) the reference: one
    process on the `world` ranks' global batch (`twin_step` with the
    reordering yardstick), on the last card while the two ranks run on
    cards 0-1 (else first); the two ranks' step (the reference of (d)) and
    their timed chunks; then every card's ranks: (c) their step against the
    reference within the float32 tolerances or three times the yardstick,
    the ranks' steps bit for bit alike; (b) each rank's chunk bit for bit
    its eager pairs, one NCCL kernel node in the graph for each all-reduce
    of a pair; (a) after the timed chunks every state tensor (parameters,
    BN statistics, SN vectors, Adam moments) bit for bit alike on every
    rank; (g) each rank's launches as the code implies; then (d) the four
    ranks under DP_FOUR against the two ranks' step, bit for bit; phase 38
    with an even count of 4 or more cards, "hosts": the `world` ranks as two
    hosts of half the cards each (CUDA_VISIBLE_DEVICES split, LOCAL_RANK
    within), rank r on physical card r by UUID, their step bit for bit the
    one host's, their timed chunks; (e)-(f) and 38 the CLI (`multi_cli`).
    Prints ms a step of a warm chunk on 1 (phase 35
    (c)'s, `one_card`), 2 and `world` cards, frames/s, the weak-scaling
    efficiency, all-reduces a step, NCCL's share of rank 0's busy time, the
    capture's memory a rank. Returns the launches summed over the ranks."""
    import dataclasses

    import torch

    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.data.synthetic import synthetic_batches
    from cpcsv_tpu_torch.train.state import create_train_state
    from cpcsv_tpu_torch.train.steps import batch_to_device, make_train_steps

    for query in (["topo", "-m"], ["nvlink", "-s"]):
        done = subprocess.run(["nvidia-smi", *query], capture_output=True, text=True)
        text = (done.stdout + done.stderr).rstrip()[:3000]
        print(f"nvidia-smi {' '.join(query)} [{card}]:\n{text}")
    peers = [[i == j or torch.cuda.can_device_access_peer(i, j) for j in range(world)]
             for i in range(world)]
    print(f"peer access between the {world} cards (torch.cuda.can_device_access_peer): {peers}")
    cfg = config_from_file(MULTI_CONFIG)
    timed = list(SCAN_TIMED_CONFIGS)
    ref_card = world - 1 if "two" in ranks else 0
    jobs, noise = {}, {}
    t = time.perf_counter()
    with torch.cuda.device(ref_card):
        state = create_train_state(cfg, seed)
        gen = torch.Generator(device="cuda").manual_seed(seed + 2)
        for w in sorted({world, 2}):
            b_st, b_im = cfg.TRAIN.ST_BATCH_SIZE * w, cfg.TRAIN.IM_BATCH_SIZE * w
            st_host, im_host = synthetic_batches(cfg, b_st, b_im, seed)
            noise[w] = [(state.gen.draw_noise(b_st, cfg.VIDEO_LEN, gen),
                         state.gen.draw_noise(b_im, 1, gen)) for _ in range(2)]
            jobs[w] = {"config": MULTI_CONFIG, "seed": seed, "backend": "nccl", "st": st_host,
                       "im": im_host, "noise": [tuple(tuple(x.cpu() for x in draws)
                                                      for draws in pair) for pair in noise[w]]}
    wait_two = ranks["two"]({**jobs[2], "timed": timed}) if "two" in ranks else None
    with torch.cuda.device(ref_card):
        b_st, b_im = cfg.TRAIN.ST_BATCH_SIZE * world, cfg.TRAIN.IM_BATCH_SIZE * world
        d_step, g_step = make_train_steps(cfg)
        run = types.SimpleNamespace(
            name=f"{MULTI_CONFIG} at {b_im} / {b_st} in one process", cfg=cfg, state=state,
            st_batch=batch_to_device(jobs[world]["st"], torch.device("cuda")),
            im_batch=batch_to_device(jobs[world]["im"], torch.device("cuda")),
            d_step=d_step, g_step=g_step)
        ref = twin_step(run, seed, noise=noise[world], yard=True)
        del run, state, noise
        torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t
    two = wait_two() if wait_two else None
    t = time.perf_counter()
    every = ranks["all"]({**jobs[world], "chunk": True, "timed": timed, "trace": True})()
    every_s = time.perf_counter() - t
    r0 = every[0]
    counts = collections.Counter()
    for rank, r in enumerate(every):
        check(r["card"] == rank, f"phase 37: rank {rank} ran on card {r['card']}")
        # (g) the launches as the code implies: the step, the chunk's and the
        # eager pairs, the timed chunks
        exp = r["expected"]
        got = {k: r["step"]["counts"][k] for k in exp}
        check(got == exp, f"phase 37 (g) rank {rank}: the step launched {got}, a step {exp}")
        for part in ("chunk", "eager"):
            want = {k: v * MULTI_PAIRS for k, v in exp.items()}
            check(r[part]["counts"] == want, f"phase 37 (g) rank {rank}: the {part} pairs "
                                             f"launched {r[part]['counts']}, expected {want}")
        for name, tr in r["timed"].items():
            want = {k: v * tr["pairs"] for k, v in tr["expected"].items()}
            check(tr["counts"] == want and tr["finite"],
                  f"phase 37 (g) rank {rank} {name}: {tr['pairs']} pairs launched "
                  f"{tr['counts']}, expected {want}, or a non-finite metric")
            counts.update(tr["counts"])
        counts.update(r["step"]["counts"])
        counts.update(r["chunk"]["counts"])
        counts.update(r["eager"]["counts"])
        # (b) the replayed chunk against the same pairs run eagerly
        check(r["chunk"]["rows"] == r["eager"]["rows"]
              and (r["chunk"]["sums"] == r["eager"]["sums"]).all(),
              f"phase 37 (b) rank {rank}: the replayed chunk differs from its pairs run eagerly")
        per_pair = r["chunk"]["all_reduces"] // 2
        check(r["chunk"]["nccl_nodes"] == per_pair == r0["step"]["collectives"]["all_reduce"],
              f"phase 37 (b) rank {rank}: {r['chunk']['nccl_nodes']} NCCL kernel nodes in the "
              f"graph for {per_pair} all-reduces a pair")
    # (c) the ranks alike, and within the yardstick of one process
    for rank, r in enumerate(every[1:], 1):
        check(r["step"]["metrics"] == r0["step"]["metrics"]
              and (r["step"]["sums"] == r0["step"]["sums"]).all()
              and (r["step"]["grad_bits"] == r0["step"]["grad_bits"]).all(),
              f"phase 37 (c): rank {rank}'s step differs from rank 0's")
    with torch.cuda.device(ref_card):
        ours = (r0["step"]["metrics"], {k: g.cuda() for k, g in r0["grads"].items()},
                {k: b.cuda() for k, b in r0["stats"].items()})
        errs, (worst, _, m_key) = step_spread(ours, ref["kernels"])
        del ours, ref["kernels"]
        torch.cuda.empty_cache()
    tols = ref["tolerances"]
    check(all(e <= tol for e, tol in zip(errs, tols)),
          f"phase 37 (c): {world} NCCL ranks vs one process {errs} above {tols}")
    # (a) every rank's state after the warm chunks
    for name in timed:
        check(all((r["timed"][name]["sums"] == r0["timed"][name]["sums"]).all() for r in every),
              f"phase 37 (a): after the warm chunks of {name} the ranks' states differ")
    step = r0["step"]["collectives"]
    print(f"phase 37 (c) [{card}]: {world} NCCL ranks, one a card, at {cfg.TRAIN.IM_BATCH_SIZE} / "
          f"{cfg.TRAIN.ST_BATCH_SIZE} a rank against one process at {b_im} / {b_st}, one D+G "
          "step from one state, batch and noise (cuDNN deterministic): largest metric error "
          "{:.3e} (tol {:.3e}, {}), accuracy {:.3e} (tol {:.3e}), gradient {:.3e} (tol {:.3e}), "
          "zero gradient {:.3e} (tol {:.3e}), BN statistics {:.3e} (tol {:.3e}); worst gradients "
          "{}; the ranks' steps bit for bit alike; {} all-reduces a step ({:.3f} GiB); the "
          "reference {:.1f} s, the ranks' launch {:.1f} s".format(
              errs[0], tols[0], m_key, errs[1], tols[1], errs[2], tols[2], errs[3], tols[3],
              errs[4], tols[4], worst, step["all_reduce"], step["bytes"] / 2**30, ref_s, every_s))
    print(f"phase 37 (b) [{card}]: on each of {world} ranks a chunk of {MULTI_PAIRS} pairs (an "
          f"eager pair, the capture, {MULTI_PAIRS - 1} replays) bit for bit the same pairs run "
          f"eagerly ({len(r0['chunk']['rows'][0])} metrics a pair, "
          f"{len(r0['chunk']['sums'])} state tensors); the graph's kernel nodes "
          f"{r0['chunk']['kernel_nodes']}, of which NCCL {r0['chunk']['nccl_nodes']}: one a "
          "pair's all-reduce, on every rank")
    print(f"phase 37 (a) [{card}]: after a first chunk of 2 pairs and {SCAN_TIMED_CHUNKS} warm "
          f"chunk(s) of {SCAN_TIMED_K} (cuDNN at its defaults), every state tensor "
          f"({len(r0['timed'][MULTI_CONFIG]['sums'])}: parameters, BN statistics, SN vectors, "
          f"Adam moments and steps) bit for bit alike on the {world} ranks, for "
          + " and ".join(timed))
    print(f"phase 37 (g) [{card}]: launches a rank as the code implies: a step {r0['expected']}; "
          f"the ranks' launches summed {dict(counts)}")
    if two is not None:
        for r in two:
            for name, tr in r["timed"].items():
                want = {k: v * tr["pairs"] for k, v in tr["expected"].items()}
                check(tr["counts"] == want and tr["finite"],
                      f"phase 37 (g), 2 ranks, {name}: launches {tr['counts']}, expected {want}")
                counts.update(tr["counts"])
            counts.update(r["step"]["counts"])
    if "four" in ranks:
        half = dataclasses.replace(cfg.TRAIN, IM_BATCH_SIZE=cfg.TRAIN.IM_BATCH_SIZE // 2,
                                   ST_BATCH_SIZE=cfg.TRAIN.ST_BATCH_SIZE // 2)
        four = ranks["four"]({**jobs[2], "mesh": DP_FOUR, "train": half})()
        for rank, r in enumerate(four):
            ref2 = two[rank // 2]["step"] if two else every[rank // 2]["step"]
            check(r["metrics"] == ref2["metrics"] and (r["sums"] == ref2["sums"]).all()
                  and (r["grad_bits"] == ref2["grad_bits"]).all(),
                  f"phase 37 (d): rank {rank} under {DP_FOUR} differs from rank {rank // 2} of "
                  f"the 2 ranks under data:2")
            check(r["data_group"] == [rank % 2, rank % 2 + 2],
                  f"phase 37 (d): rank {rank}'s data group {r['data_group']}")
            got = {k: r["counts"][k] for k in r["expected"]}
            check(got == r["expected"], f"phase 37 (d) rank {rank}: launches {got}")
            counts.update(r["counts"])
        print(f"phase 37 (d) [{card}]: 4 NCCL ranks under MESH_SHAPE {DP_FOUR} (NCCL data groups "
              f"{[r['data_group'] for r in four]}) at {half.IM_BATCH_SIZE} / "
              f"{half.ST_BATCH_SIZE} a device, one D+G step bit for bit that of the 2 ranks "
              f"under data:2 at the same global batch, rank r as rank r // 2")
    else:
        print(f"phase 37 (d) [{card}]: {DP_FOUR} needs 4 cards; this host shows {world}")
    hosts = None
    if "hosts" in ranks:  # phase 38: the same ranks as two "hosts" of the cards' halves
        per_host = host_split(world)
        uuids = [str(getattr(torch.cuda.get_device_properties(i), "uuid", i))
                 for i in range(world)]
        t = time.perf_counter()
        hosts = ranks["hosts"]({**jobs[world], "timed": [MULTI_CONFIG]})()
        hosts_s = time.perf_counter() - t
        for rank, r in enumerate(hosts):
            check(r["uuid"] == uuids[rank] and r["card"] == rank % per_host,
                  f"phase 38: rank {rank} ran on card {r['uuid']} (cuda:{r['card']} of its "
                  f"host), not physical card {rank} {uuids[rank]}")
            ref_step = every[rank]["step"]
            check(r["step"]["metrics"] == ref_step["metrics"]
                  and (r["step"]["sums"] == ref_step["sums"]).all()
                  and (r["step"]["grad_bits"] == ref_step["grad_bits"]).all(),
                  f"phase 38: rank {rank}'s step over two hosts differs from the one host's")
            tr = r["timed"][MULTI_CONFIG]
            want = {k: v * tr["pairs"] for k, v in tr["expected"].items()}
            check(tr["counts"] == want and tr["finite"],
                  f"phase 38 rank {rank}: launches {tr['counts']}, expected {want}")
            got = {k: r["step"]["counts"][k] for k in r["expected"]}
            check(got == r["expected"], f"phase 38 rank {rank}: the step launched {got}")
            counts.update(tr["counts"])
            counts.update(r["step"]["counts"])
        print(f"phase 38 [{card}]: {world} NCCL ranks as two hosts of {per_host} cards "
              "(CUDA_VISIBLE_DEVICES split, LOCAL_RANK on each), rank r on physical card r (by "
              "UUID): one D+G step bit for bit the one host's ranks' (metrics, state, "
              f"gradients); the launch {hosts_s:.1f} s")
    # the timings
    rows = {w: rs for w, rs in ((2, two or (every if world == 2 else None)), (world, every))
            if rs is not None}
    frames = cfg.TRAIN.ST_BATCH_SIZE * cfg.VIDEO_LEN + cfg.TRAIN.IM_BATCH_SIZE
    print(f"phase 37 timings [{card}]: a warm chunk of {SCAN_TIMED_K} pairs at 90 / 18 a rank, "
          "ms a step (rank 0's median window; 1 card: phase 35 (c)), frames/s over the cards, "
          "weak-scaling efficiency (1 card's ms / W cards' ms); a first chunk of 2 pairs (the "
          "capture) in s and the memory it reserved a rank")
    for name in timed:
        parts = [f"1 card {one_card[name]:.2f} ms ({frames / one_card[name] * 1e3:.1f} frames/s)"]
        for w, rs in sorted(rows.items()):
            tr = rs[0]["timed"][name]
            ms = median(tr["windows"])
            parts.append(f"{w} cards {ms:.2f} ms ({w * frames / ms * 1e3:.1f} frames/s, efficiency "
                         f"{one_card[name] / ms:.3f}; first chunk {tr['first_s']:.2f} s, "
                         f"reserved {max(r['timed'][name]['pool'] for r in rs) / 2**30:.2f} GiB "
                         "a rank at most)")
        print(f"  {name}: " + "; ".join(parts))
    if hosts is not None:
        tr, one = hosts[0]["timed"][MULTI_CONFIG], median(r0["timed"][MULTI_CONFIG]["windows"])
        ms = median(tr["windows"])
        print(f"  {MULTI_CONFIG} over two hosts of {host_split(world)} cards on this machine "
              f"(phase 38; the rendezvous and rank numbering, not a network between hosts): "
              f"{ms:.2f} ms ({world * frames / ms * 1e3:.1f} frames/s, efficiency "
              f"{one_card[MULTI_CONFIG] / ms:.3f}) against {one:.2f} ms as one command; first "
              f"chunk {tr['first_s']:.2f} s, reserved "
              f"{max(r['timed'][MULTI_CONFIG]['pool'] for r in hosts) / 2**30:.2f} GiB a rank")
    traced = r0["timed"][MULTI_CONFIG]["traced"]
    print(f"  {MULTI_CONFIG} on {world} cards, one traced chunk on rank 0: busy "
          f"{traced['busy_ms']:.2f} ms a step, NCCL's kernels {traced['nccl_ms']:.2f} ms "
          f"({traced['nccl_ms'] / traced['busy_ms']:.3f} of the busy time)")
    multi_cli(card, seed, root, world)
    return dict(counts)


def one_card_phase(card: str, root: Path) -> None:
    """Phase 37 on a host of one card: the CLI's training run of "" stays in
    this process (`launch.local_world` gives 1), and MESH_SHAPE data:2
    raises through the CLI, naming the visible cards."""
    import yaml

    from cpcsv_tpu_torch.cli import dispatch, main_pororo
    from cpcsv_tpu_torch.parallel import launch

    cfg_file = REPO / "cpcsv_tpu_torch" / "configs" / MULTI_CLI
    args = main_pororo.parse_args(["--cfg", str(cfg_file), "--synthetic", "36"])
    world = launch.local_world("", args.device, dispatch.trains(args))
    check(world == 1, f"phase 37: one card gives {world} ranks")
    two = root / "data2.yml"
    two.write_text(yaml.safe_dump({**yaml.safe_load(cfg_file.read_text()), "MESH_SHAPE": "data:2"}))
    try:
        main_pororo.main(["--cfg", str(two), "--synthetic", "36"])
        message = None
    except ValueError as e:
        message = str(e)
    check(message is not None and "needs 2 devices, have 1" in message,
          f"phase 37: MESH_SHAPE data:2 on one card: {message!r}")
    print(f"phase 37 [{card}]: MESH_SHAPE \"\" trains in this process (the CLI runs of the phases "
          f"before started no ranks); data:2 raises: {message}")
    print("phase 37: training across cards (NCCL ranks, one a card) needs two or more cards; "
          "this host shows 1")


def host_rules(card: str) -> None:
    """Phase 38's launch rules on a host of one card: as host 0 of a run of
    two (CPCSV_COORDINATOR, CPCSV_NUM_PROCESSES, CPCSV_PROCESS_ID) a
    training command runs its one rank in its own process, a named mesh of
    more cards than the hosts' raises and one of fewer does too; the hosts'
    rendezvous (`launch.meet`, an in-process store, one thread a host)
    raises on every host for unequal cards."""
    import torch.distributed as dist

    from cpcsv_tpu_torch.parallel import launch

    said = {}
    with mock.patch.dict(os.environ, {"CPCSV_COORDINATOR": "127.0.0.1:1",
                                      "CPCSV_NUM_PROCESSES": "2", "CPCSV_PROCESS_ID": "0"}):
        check(launch.local_world("", "cuda", True) == 1,
              "phase 38: a host of one card starts ranks")
        for mesh_shape in ("data:4", "data:1"):
            try:
                launch.local_world(mesh_shape, "cuda", True)
            except ValueError as e:
                said[mesh_shape] = str(e)
    check("needs 4 devices, have 2 (2 hosts of 1" in said.get("data:4", "")
          and "takes 1 devices, not every one of the 2" in said.get("data:1", ""),
          f"phase 38: the named meshes across two hosts of one card: {said}")
    store, raised = dist.HashStore(), [None, None]

    def host(h):
        try:
            launch.meet(store, h, 2, 1 + h, 10.0)
        except ValueError as e:
            raised[h] = str(e)

    threads = [threading.Thread(target=host, args=(h,)) for h in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(all(r and "host 0 starts 1 rank(s), host 1 starts 2" in r for r in raised),
          f"phase 38: hosts of 1 and 2 cards met: {raised}")
    print(f"phase 38 [{card}]: as host 0 of two, \"\" trains its one rank in this process; "
          f"data:4 raises ({said['data:4']}); data:1 raises ({said['data:1']}); hosts of 1 "
          f"and 2 cards both raise ({raised[0]})")


def seq_shuffle_cost(card: str, per_host: int = 4, batches: int = 3) -> None:
    """Phase 38: the host-side price of the seq-consistency shuffle being the
    host's. A rank of a host of `per_host` reads its host's story batches
    (`training_loaders` under USE_SEQ_CONSISTENCY) and shuffles all of them
    (`create_random_shuffle`), where before it read and shuffled its own:
    ms a batch of each at final.yml's ST_BATCH_SIZE, synthetic stories, on
    the loader's prefetch thread (which overlaps the steps)."""
    import numpy as np

    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.data.loader import DataLoader
    from cpcsv_tpu_torch.data.synthetic import SyntheticStoryDataset
    from cpcsv_tpu_torch.losses.shuffle import create_random_shuffle

    cfg = config_from_file("final.yml")
    st = cfg.TRAIN.ST_BATCH_SIZE
    data = SyntheticStoryDataset(st * per_host * batches, cfg.VIDEO_LEN, cfg.IMSIZE,
                                 cfg.TEXT.DIMENSION, cfg.LABEL_NUM)
    ms = {}
    for label, shards in (("its own", (0,)), ("its host's", tuple(range(per_host)))):
        loader = DataLoader(data, st * per_host, shuffle=True, seed=1, drop_last=True,
                            process_index=0, process_count=per_host, shards=shards)
        rng = np.random.default_rng([0, 0])
        t = time.perf_counter()
        for batch in loader:
            create_random_shuffle(batch["images"], rng=rng)
        ms[label] = (time.perf_counter() - t) * 1e3 / batches
    own, host = ms["its own"], ms["its host's"]
    print(f"phase 38 [{card}]: the seq-consistency story batch of a rank of a host of {per_host}, "
          f"read and shuffled on the host, ms a batch (the mean of {batches}): {st} stories, "
          f"its own, {own:.1f} ms; {st * per_host}, its host's, {host:.1f} ms "
          f"(+{host - own:.1f} ms a step, on the prefetch thread)")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    # one rank of phases 29-31, started by the script itself (`spawn_dp`)
    parser.add_argument("--dp-worker", choices=("steps", "nccl", "cli", "multi"),
                        help=argparse.SUPPRESS)
    for flag, kind in (("--dp-rank", int), ("--dp-world", int), ("--dp-init", str),
                       ("--dp-job", str), ("--dp-out", str)):
        parser.add_argument(flag, type=kind, help=argparse.SUPPRESS)
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run on an NVIDIA GPU")
    if not (REPO / "cpcsv_tpu_torch" / "csrc").is_dir():
        fail(f"{REPO} is not a checkout of the repository (no cpcsv_tpu_torch/)")
    sys.path.insert(0, str(REPO))
    if args.dp_worker:
        return dp_worker(args)

    from cpcsv_tpu_torch import config as config_module  # read at each call: phases pin it
    from cpcsv_tpu_torch.data.synthetic import SyntheticStoryDataset, story_batches
    from cpcsv_tpu_torch.device import float32_math
    from cpcsv_tpu_torch.evaluation import sampling
    from cpcsv_tpu_torch.evaluation.drivers import Infer
    from cpcsv_tpu_torch.models import generator as generator_module
    from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda
    from cpcsv_tpu_torch.ops.cuda import build
    from cpcsv_tpu_torch.ops.cuda import dfn as dfn_cuda
    from cpcsv_tpu_torch.ops.dynamic_filter import (
        dynamic_filter_conv1d_backward_plain,
        dynamic_filter_conv1d_plain,
    )

    # the ranks the CLIs start in this process: none before phase 37 (pinned
    # to one card on a host of several)
    from cpcsv_tpu_torch.parallel import launch

    started, run_ranks = [], launch.run_ranks
    launch.run_ranks = lambda main, argv, world: (started.append(world),
                                                  run_ranks(main, argv, world))[1]
    cards = torch.cuda.device_count()
    pins = contextlib.ExitStack()

    # TF32 allowed globally, as cuDNN allows it by default, and for matmuls
    # too: the entry point must hold its float32 itself (phase 4 checks it),
    # and the kernel comparisons and timings open the same float32 scope
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True

    # ---------------------------------------------------------------- 1. card
    phase("1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    print(f"global cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # --------------------------------------------------------------- 2. build
    phase("2. build")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(build.SOURCES)) as pool:
        logs = dict(zip(build.SOURCES, pool.map(build.build, build.SOURCES)))
    print(f"build {', '.join(build.SOURCES)}, one nvcc each at once: "
          f"{time.perf_counter() - t0:.2f} s [{card}]")
    for name, log in logs.items():
        build.load(name)
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  nvcc {name}: {line.strip()}")

    # ---------------------------------------------------- 3. kernel vs plain
    phase("3. kernel vs plain")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    C, L = 3, 124
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dfn_plans = set()  # (kernel, taps, vec, warps a block) the cases ran

    def offset_copy(t, offset: int):
        """A contiguous copy of t starting `offset` elements past a 256-byte
        boundary: offset 1 leaves no row 16-byte aligned."""
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
        view = buf[offset:].view(t.shape)
        view.copy_(t)
        return view

    # every instantiation (TAPS), each batch, rows aligned and one element
    # off, and two launches on one input
    for dtype in (torch.float32, torch.bfloat16):
        # float32: the taps are summed in another order; bfloat16: the kernel
        # accumulates in float32 and rounds its output to bfloat16 once
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        for B, (K, pad), offset in itertools.product(KERNEL_BATCHES, TAPS, (0, 1)):
            img = offset_copy(torch.randn(B, C, L, generator=gen, device="cuda").to(dtype), offset)
            filt = offset_copy(torch.randn(B, 1, C, K, generator=gen, device="cuda").to(dtype),
                               offset)
            p = dfn_cuda.plan(B, C, L, K, pad, sms, offset == 0)
            dfn_plans.add(("forward", p.taps, p.vec, p.warps))
            out = dfn_cuda.dfn_forward(img, filt, pad)
            with float32_math():
                ref = dynamic_filter_conv1d_plain(img.float(), filt.float(), pad)
            where = f"dfn {dtype} B={B} K={K} pad={pad} offset {offset}"
            check(out.dtype == dtype and out.shape == ref.shape,
                  f"{where}: {out.dtype} {tuple(out.shape)}")
            err = (out.float() - ref).abs()
            check(bool((err <= tol + tol * ref.abs()).all()),
                  f"{where}: kernel vs plain max error {err.max().item()}")
            check(torch.equal(out, dfn_cuda.dfn_forward(img, filt, pad)),
                  f"{where}: two launches differ")
            max_err[dtype] = max(max_err[dtype], err.max().item())
    print(f"dfn kernel vs plain on the card, B in {KERNEL_BATCHES}, K/pad in {TAPS}, rows "
          f"aligned and one element off: max abs error f32 {max_err[torch.float32]:.3e} "
          f"(tol 1e-5), bf16 {max_err[torch.bfloat16]:.3e} (tol 1e-2); two launches give the "
          "same bits")
    # the backward against autograd of the plain version; float32, the sums
    # (up to 124 products) run in another order: 1e-5 + 1e-5·|ref|. dout
    # as the G step hands it over (the last L_out columns of a (B, 613)
    # gradient) and contiguous: the same bits
    bwd_err = 0.0
    for B, (K, pad), offset in itertools.product(KERNEL_BATCHES, TAPS, (0, 1)):
        L_out = L + 2 * pad - K + 1
        img = offset_copy(torch.randn(B, C, L, generator=gen, device="cuda"), offset)
        filt = offset_copy(torch.randn(B, 1, C, K, generator=gen, device="cuda"), offset)
        strided = torch.randn(B, ZMC_WIDTH, generator=gen, device="cuda")[:, -L_out:].unsqueeze(1)
        dout = strided.contiguous()
        p = dfn_cuda.plan(B, C, L, K, pad, sms, offset == 0, backward=True)
        dfn_plans.add(("backward", p.taps, p.vec, p.warps))
        got = dfn_cuda.dfn_backward(img, filt, strided, pad)
        with float32_math():
            ref = dynamic_filter_conv1d_backward_plain(img, filt, dout, pad)
        where = f"dfn backward B={B} K={K} pad={pad} offset {offset}"
        for a, r in zip(got, ref):
            err = (a - r).abs()
            check(a.shape == r.shape and bool((err <= 1e-5 + 1e-5 * r.abs()).all()),
                  f"{where}: kernel vs plain max error {err.max().item()}")
            bwd_err = max(bwd_err, err.max().item())
        for again in (dfn_cuda.dfn_backward(img, filt, strided, pad),
                      dfn_cuda.dfn_backward(img, filt, dout, pad)):
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{where}: two launches, or strided and contiguous dout, differ")
    print(f"dfn backward kernel vs autograd of the plain version, B in {KERNEL_BATCHES}, "
          f"K/pad in {TAPS}, rows aligned and one element off, dout with row stride "
          f"{ZMC_WIDTH}: max abs error {bwd_err:.3e} (tol 1e-5 + 1e-5·|ref|); two launches, "
          f"and a contiguous dout, give the same bits; plans (kernel, taps, vec, warps a block) "
          f"on {sms} SMs: {sorted(dfn_plans)}")
    check({t for _, t, _, _ in dfn_plans} == {21, 7, 0},
          f"the cases ran the instantiations {dfn_plans}")
    # bfloat16, as the G step at COMPUTE_DTYPE bfloat16 hands it over: the
    # kernel sums in float32 and rounds each gradient to bfloat16 once, so it
    # lies within one rounding step (2^-8) of the plain backward on the
    # upcast inputs, plus 1e-5 of the magnitude for the order of the sums
    bwd_err_bf16 = 0.0
    for B, (K, pad), offset in itertools.product(KERNEL_BATCHES, TAPS, (0, 1)):
        L_out = L + 2 * pad - K + 1
        img = offset_copy(torch.randn(B, C, L, generator=gen, device="cuda").bfloat16(), offset)
        filt = offset_copy(torch.randn(B, 1, C, K, generator=gen, device="cuda").bfloat16(),
                           offset)
        strided = torch.randn(B, ZMC_WIDTH, generator=gen, device="cuda").bfloat16()[
            :, -L_out:].unsqueeze(1)
        got = dfn_cuda.dfn_backward(img, filt, strided, pad)
        with float32_math():
            ref = dynamic_filter_conv1d_backward_plain(img.float(), filt.float(),
                                                       strided.float(), pad)
        where = f"dfn backward bfloat16 B={B} K={K} pad={pad} offset {offset}"
        for a, r in zip(got, ref):
            err = (a.float() - r).abs()
            scale = r.abs().max().item()
            check(a.dtype == torch.bfloat16 and a.shape == r.shape
                  and bool((err <= 2 ** -8 * r.abs() + 1e-5 * scale).all()),
                  f"{where}: kernel vs plain max error {err.max().item()}")
            bwd_err_bf16 = max(bwd_err_bf16, err.max().item())
        for again in (dfn_cuda.dfn_backward(img, filt, strided, pad),
                      dfn_cuda.dfn_backward(img, filt, strided.contiguous(), pad)):
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{where}: two launches, or strided and contiguous dout, differ")
    print(f"dfn backward kernel vs the plain version, bfloat16, B in {KERNEL_BATCHES}, K/pad in "
          f"{TAPS}, rows aligned and one element off, dout with row stride {ZMC_WIDTH}: max abs "
          f"error {bwd_err_bf16:.3e} (tol 2^-8·|ref| + 1e-5·max|ref|); two launches, and a "
          "contiguous dout, give the same bits")

    # ------------------------------------------- 4. the slice at full width
    phase("4. the slice at full width")
    pins.enter_context(pinned_to_one_card())
    launches = 0
    expected_launches = 0
    serving_ms, sampler_nodes = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for name in ("final.yml", "cascade.yml"):
            cfg = config_module.config_from_file(name)
            batches = {
                n: next(story_batches(SyntheticStoryDataset(n, seed=args.seed), n))
                for n in STORY_SIZES
            }
            state = random_generator_state(cfg, batches[STORY_SIZES[-1]], args.seed)
            infer = Infer(cfg, state, device="cuda", output_dir=tmp, seed=args.seed)
            rng_states, videos, inside = {}, {}, []
            # a hook fires on the eager call and the capture, not on a replay
            hook = infer.net_g.upsample1.register_forward_pre_hook(lambda *_: inside.append(
                (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))

            reset_counts()  # the main path: entry points only
            for n, batch in batches.items():
                rng_states[n] = infer.generator.get_state()
                videos[n], _ = infer.sample_videos_np(batch)
            _, gen_dir = infer.generate_story(
                story_batches(SyntheticStoryDataset(STORY_SIZES[0], seed=args.seed),
                              STORY_SIZES[0]))
            counts = read_counts()
            count = counts["dfn_forward"]
            hook.remove()
            calls = len(batches) + 1
            check(count == calls,
                  f"{name}: dfn kernel launched {count} times in {calls} generator calls")
            check(counts["dfn_backward"] == counts["bn_stats"] == counts["bn_grad_reduce"] == 0,
                  f"{name}: serving (eval BN, no gradients) launched {counts}")
            # each size's first call eager and captured; generate_story's
            # 18 stories replay the 18-story graph
            check_sampler(calls, f"{name} serving")
            check(inside == [(False, False)] * 2 * len(batches) and torch.backends.cudnn.allow_tf32
                  and torch.backends.cuda.matmul.allow_tf32,
                  f"{name}: TF32 flags (cudnn, matmul) inside the generator {inside}")
            print(f"{name}: TF32 flags (cudnn, matmul) inside the generator, eager calls and "
                  f"captures, {sorted(set(inside))}, global after "
                  f"{torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32}")
            launches += count
            expected_launches += calls

            pngs = sum(len(f) for _, _, f in os.walk(os.path.dirname(gen_dir)))
            check(pngs == 2 * STORY_SIZES[0] * cfg.VIDEO_LEN,
                  f"{name}: generate_story wrote {pngs} PNGs")
            for n, video in videos.items():
                check(video.shape == (n, cfg.VIDEO_LEN, 64, 64, 3),
                      f"{name}: video shape {video.shape}")
                check(bool(np.isfinite(video).all() and (np.abs(video) <= 1).all()),
                      f"{name}: frames not finite in [-1, 1]")
                # the same weights and noise with the plain DFN on the card,
                # eagerly (a replay would not see the patch). The DFN's sum
                # order differs by ~1e-6 and passes through the eval BNs and
                # the convolution trunk before the output.
                infer.generator.set_state(rng_states[n])
                with mock.patch.object(generator_module, "dynamic_filter_conv1d",
                                       dynamic_filter_conv1d_plain):
                    plain, _ = eager_np(infer, batches[n])
                diff = float(abs(plain - video).max())
                check(diff <= 1e-3, f"{name} {n} stories: kernel vs plain DFN frames differ by {diff}")
                print(f"{name}: {n} stories -> {video.shape}, |frame| mean "
                      f"{abs(video).mean():.4f} max {abs(video).max():.4f} std "
                      f"{video.std():.4f}; kernel vs plain DFN max abs diff {diff:.3e} (tol 1e-3)")
            print(f"{name}: generate_story wrote {pngs} PNGs; dfn launches {count} in {calls} calls")
            sampler_nodes[name] = replays_match_eager(infer, batches, name)

            # ------------------------------------------ 5b. slice frames/s
            for n, batch in batches.items():
                serving_ms[name, n] = serving_times(infer, batch, n, f"{name}: {n} stories", card)
            print(f"{name}: peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
            del infer, state
            torch.cuda.empty_cache()
    check(launches == expected_launches, f"dfn launches {launches} != {expected_launches}")

    # ------------------------------------------------- 5a. kernel timings
    phase("5. kernel timings")
    # the card's cost of one launch in a graph, beside every kernel time
    floor = launch_floor_ms()
    empty = device_ms(lambda: torch.cuda._sleep(0), "empty kernel")
    print(f"launch floor [{card}]: {floor * 1e3:.2f} us per launch in one CUDA graph "
          f"(torch.cuda._sleep(0), an empty kernel); traced {empty * 1e3:.2f} us")
    # the main paths' batches: 90 (a training call, 18 stories), 360 (72)
    fwd = dfn_forward_times(gen, card, floor)
    # the kernels line reports graph times at the main path's B=90: the
    # trace gives the library's 90 per-group cuDNN kernels about four times
    # the graph's time
    kernels = {"dfn_forward": {
        "name": "dfn_forward",
        "route": "cuda",
        "source": dfn_cuda.SOURCE,
        "replaces": dfn_cuda.REPLACES,
        "launches": launches,
        "max_abs_err": max_err[torch.float32],
        "ms": fwd[90].graph_ms,
        "plain_ms": fwd[90].plain_ms,
        "bound_ms": fwd[90].bound_ms,
        "bound_by": fwd[90].bound_by,
        "library_ms": fwd[90].library_ms,
        "floor_ms": floor,
        "step_ms": DFN_STEP_LAUNCHES["dfn_forward"] * fwd[90].graph_ms,
    }}

    # ------------------------------------------ 15. serving at bfloat16
    phase("15. serving at bfloat16: throughput.yml and procedural.yml through Infer")
    serving_bf16 = bf16_serving(card, args.seed)

    # ------------------------- 36. generation split over the eval mesh
    phase("36. generation split over the eval mesh through Infer: final.yml, procedural.yml")
    pins.close()  # every card of the host
    shard = sharded_serving(card, args.seed)
    pins.enter_context(pinned_to_one_card())

    # ----------------------- 6-7. training at full width, each config in turn
    runs = {}
    build_dir = REPO / "build"
    build_dir.mkdir(exist_ok=True)
    for name in TRAIN_CONFIGS:
        phase(f"6. training at full width, {name}")
        run = train_at_full_width(name, args.seed, card)
        phase(f"7. one D+G step of {name}, kernels vs plain versions")
        twin_step(run, args.seed)
        if name == "cascade.yml":
            phase("34. REMAT on cascade.yml: a step against one without")
            remat_cascade = remat_phase(run, card, args.seed, timed=False)
        if name == "final.yml":
            phase("25. REMAT on final.yml: a step against one without, then timed")
            remat = remat_phase(run, card, args.seed)
            phase("26. ADAM_MU_DTYPE bfloat16 on final.yml: timed, saved and resumed at float32")
            with tempfile.TemporaryDirectory(prefix="chip_smoke_adam_", dir=build_dir) as tmp:
                adam_counts = adam_mu_phase(run, card, Path(tmp))
        # keep what phases 8-10 read; free the state before the next config
        runs[name] = types.SimpleNamespace(expected=run.expected, step_calls=run.step_calls,
                                           train_counts=run.train_counts, step_ms=run.step_ms,
                                           busy_ms=run.busy_ms)
        del run
        torch.cuda.empty_cache()
    bn_shapes = set().union(*(set(r.step_calls["bn_stats"]) | set(r.step_calls["bn_grad_reduce"])
                              for r in runs.values()))
    train_counts = {k: sum(r.train_counts[k] for r in runs.values()) for k in read_counts()}

    # ----------------- 16-17. training at bfloat16, each config in turn
    runs_bf16, lowering_step_ms = {}, {}
    for name in BF16_CONFIGS:
        phase(f"16. training at bfloat16, {name}")
        run = train_at_full_width(name, args.seed, card)
        frames = run.cfg.TRAIN.ST_BATCH_SIZE * run.cfg.VIDEO_LEN + run.cfg.TRAIN.IM_BATCH_SIZE
        print(f"{name} D+G step at bfloat16 [{card}]: {run.step_ms:.2f} ms median, "
              f"{frames / run.step_ms * 1e3:.1f} frames/s ({frames} frames a step)")
        lowering_step_ms[name] = lowering_steps(run, card)
        phase(f"17. one D+G step of {name} at bfloat16, kernels vs plain versions")
        tolerances = twin_step(run, args.seed)["tolerances"]
        if name == "throughput.yml":
            phase("34. REMAT on throughput.yml at bfloat16, against phase 17's yardstick; "
                  "ADAM_MU_DTYPE bfloat16, a step and the Adam state's bytes")
            remat_bf16 = remat_phase(run, card, args.seed, tols=tolerances, timed=False)
            adam_bf16 = adam_mu_phase(run, card, build_dir, timed=False)
        runs_bf16[name] = types.SimpleNamespace(
            expected=run.expected, step_calls=run.step_calls, train_counts=run.train_counts,
            step_ms=run.step_ms, busy_ms=run.busy_ms)
        del run
        torch.cuda.empty_cache()
    bf16_shapes = set().union(*(set(r.step_calls["bn_stats"]) | set(r.step_calls["bn_grad_reduce"])
                                for r in runs_bf16.values()))
    bf16_counts = {k: sum(r.train_counts[k] for r in runs_bf16.values()) for k in read_counts()}

    # ---------------------------------- 18. the four lowerings side by side
    phase("18. FUSED_UPSAMPLE off, deconv, parity4, parity1 at bfloat16")
    for name in BF16_CONFIGS:
        print(f"{name} [{card}]: " + "; ".join(
            f"{k}: serving {serving_bf16['lowering_ms'][name][k]:.2f} ms a call of "
            f"{STORY_SIZES[-1]} stories, D+G step {lowering_step_ms[name][k]:.2f} ms"
            for k in lowering_step_ms[name]))
    # ------------------------- 8. BN kernels vs plain at the step's shapes
    phase("8. BN kernels vs plain")
    shapes = (sorted(bn_shapes) + sorted({(7, c, sp) for _, c, sp in bn_shapes})
              + list(EDGE_BN_SHAPES))
    bn_err, plans = bn_vs_plain(gen, shapes, torch.float32)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"BN kernels vs plain on the card at {len(shapes)} shapes (N, C, S), each aligned "
          f"and one float off: the step's {sorted(bn_shapes)}, N=7, and {EDGE_BN_SHAPES}: "
          f"max abs error bn_stats {bn_err['bn_stats']:.3e}, bn_grad_reduce "
          f"{bn_err['bn_grad_reduce']:.3e} (tol 1e-5 of the terms' magnitude + 1e-6); two "
          f"launches give the same bits; plans (kernel, vec, cluster, channels a block) on "
          f"{sms} SMs: {sorted(plans)}")
    # bfloat16 x and dy at the bfloat16 steps' shapes: against the plain
    # versions, which sum the same values in float32
    shapes = (sorted(bf16_shapes) + sorted({(7, c, sp) for _, c, sp in bf16_shapes})
              + list(EDGE_BN_SHAPES))
    bn_err_bf16, plans = bn_vs_plain(gen, shapes, torch.bfloat16)
    check({v for _, v, _, _ in plans} == {1, 8}, f"bfloat16 plans {sorted(plans)}")
    print(f"BN kernels vs plain on the card, bfloat16, at {len(shapes)} shapes (N, C, S), each "
          f"aligned and one element off: the bfloat16 steps' {sorted(bf16_shapes)}, N=7, and "
          f"{EDGE_BN_SHAPES}: max abs error bn_stats {bn_err_bf16['bn_stats']:.3e}, "
          f"bn_grad_reduce {bn_err_bf16['bn_grad_reduce']:.3e} (tol 1e-5 of the terms' "
          f"magnitude + 1e-6); two launches give the same bits; plans: {sorted(plans)}")

    # ------------------------------------------------ 9. new kernels' times
    phase("9. kernel timings: the BN reductions at every shape of the step, the DFN backward")

    per_shape, step_bn = bn_timings(gen, card, runs, torch.float32)
    largest = bn_largest(gen, card, runs, per_shape, torch.float32)
    for name in ("bn_stats", "bn_grad_reduce"):
        _, _, kernel_ms, library_ms, bound = per_shape[name, largest[name]["shape"]]
        kernels[name] = {
            "name": name, "route": "cuda", "source": bn_cuda.SOURCE,
            "replaces": bn_cuda.REPLACES[name], "launches": train_counts[name],
            "max_abs_err": bn_err[name], "ms": kernel_ms, "plain_ms": largest[name]["plain_ms"],
            "bound_ms": bound, "bound_by": largest[name]["bound_by"], "library_ms": library_ms,
            "step_ms": step_bn["final.yml"][name][0],
            "step_bound_ms": step_bn["final.yml"][name][1],
            "cascade_step_ms": step_bn["cascade.yml"][name][0],
            "cascade_step_bound_ms": step_bn["cascade.yml"][name][1],
        }
    # the DFN backward at the step's batch and a small one, and the pair's
    # time over one D+G step
    bwd, bwd_op, copy_ms, copies = dfn_backward_times(gen, card, floor)
    check(copies == 0, f"the DFN backward op copied a row-strided dout {copies} times")
    dfn_step = dfn_step_ms(card, fwd[90], bwd_op[90], copies, copy_ms[90], floor)
    kernels["dfn_backward"] = {
        "name": "dfn_backward", "route": "cuda", "source": dfn_cuda.SOURCE,
        "replaces": dfn_cuda.REPLACES_BACKWARD, "launches": train_counts["dfn_backward"],
        "max_abs_err": bwd_err, "ms": bwd[90].graph_ms, "plain_ms": bwd[90].plain_ms,
        "bound_ms": bwd[90].bound_ms, "bound_by": bwd[90].bound_by,
        "library_ms": bwd[90].library_ms, "floor_ms": floor,
        "step_ms": DFN_STEP_LAUNCHES["dfn_backward"] * bwd_op[90],
    }
    for name in ("bn_stats", "bn_grad_reduce"):
        kernels[name]["floor_ms"] = floor
    # bfloat16: the BN kernels at every shape of the bfloat16 steps, their
    # largest; the DFN pair at throughput.yml's IM_BATCH (360) and
    # procedural.yml's (90)
    per_shape_bf16, step_bn_bf16 = bn_timings(gen, card, runs_bf16, torch.bfloat16)
    largest_bf16 = bn_largest(gen, card, runs_bf16, per_shape_bf16, torch.bfloat16)
    for name in ("bn_stats", "bn_grad_reduce"):
        shape = largest_bf16[name]["shape"]
        _, _, kernel_ms, library_ms, bound = per_shape_bf16[name, shape]
        kernels[name].update({
            "bf16_launches": bf16_counts[name], "bf16_shape": shape,
            "bf16_max_abs_err": bn_err_bf16[name], "bf16_ms": kernel_ms,
            "bf16_plain_ms": largest_bf16[name]["plain_ms"], "bf16_bound_ms": bound,
            "bf16_bound_by": largest_bf16[name]["bound_by"], "bf16_library_ms": library_ms,
            **{f"{c.split('.')[0]}_step_{k}": step_bn_bf16[c][name][i]
               for c in BF16_CONFIGS for i, k in ((0, "ms"), (1, "bound_ms"))},
        })
    bwd16, bwd16_op, _, copies16 = dfn_backward_times(gen, card, floor, torch.bfloat16, (360, 90))
    check(copies16 == 0,
          f"the bfloat16 DFN backward op copied a row-strided dout {copies16} times")
    fwd16 = dfn_forward_times(gen, card, floor, torch.bfloat16, (360,))
    for name, t, err in (("dfn_forward", fwd16[360], max_err[torch.bfloat16]),
                         ("dfn_backward", bwd16[360], bwd_err_bf16)):
        kernels[name].update({
            "bf16_launches": bf16_counts[name], "bf16_shape": [360, *DFN_SHAPE[:2]],
            "bf16_max_abs_err": err, "bf16_ms": t.graph_ms, "bf16_plain_ms": t.plain_ms,
            "bf16_bound_ms": t.bound_ms, "bf16_bound_by": t.bound_by,
            "bf16_library_ms": t.library_ms})
    kernels["dfn_forward"]["bf16_launches"] += serving_bf16["launches"]

    # -------------------------------------- 10. the trainer through the CLI
    phase("10. the trainer through the CLI: cascade.yml, one epoch, then auto-resume")
    cli_counts = cli_trainer(card, runs["cascade.yml"].expected, args.seed)

    # ------------------------------- 19. throughput.yml through the CLI
    phase(f"19. throughput.yml --synthetic {THROUGHPUT_SYNTHETIC} through the CLI, one epoch at "
          "bfloat16")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bf16_", dir=build_dir) as tmp:
        cli_bf16, _ = cli_epoch(card, "throughput.yml",
                                ["--synthetic", str(THROUGHPUT_SYNTHETIC)],
                                runs_bf16["throughput.yml"].expected, 2,
                                set(CASCADE_TAGS) - set(CASCADE_G_TAGS), args.seed, Path(tmp))
    for name in kernels:
        bf16 = bf16_counts[name] + cli_bf16[name]
        kernels[name]["bf16_launches"] += cli_bf16[name]
        if name == "dfn_forward":
            kernels[name]["launches"] += (train_counts[name] + cli_counts[name] + bf16
                                          + serving_bf16["launches"])
        else:
            kernels[name]["launches"] = train_counts[name] + cli_counts[name] + bf16

    # -------------------------- 11-12. from disk, then the checkpoint walks
    with tempfile.TemporaryDirectory(prefix="chip_smoke_disk_", dir=build_dir) as tmp:
        phase("11. cascade.yml from a procedural Pororo tree on disk through the CLI, one epoch")
        disk_counts, run_dir, data_dir = disk_trainer(card, runs["cascade.yml"].expected,
                                                      runs["cascade.yml"], args.seed, Path(tmp))
        phase("12. the checkpoint walks: --eval_fid, --eval_ssim, --load_ckpt")
        walk_counts = walks(card, run_dir, data_dir, args.seed)
        phase("13. the FVD and IS walks: --eval_fvd (R(2+1)D, then a seeded I3D file), --eval_is")
        fvd_is_counts = fvd_is_walks(card, run_dir, data_dir, args.seed, Path(tmp))
        phase("14. rehearsal.yml through the CLI, 2 epochs with the in-training FID/FSD")
        rehearsal_counts = rehearsal_trainer(card, runs["cascade.yml"].expected, args.seed,
                                             Path(tmp))
        phase("20. procedural.yml --data_dir on phase 11's tree through the CLI, one epoch at "
              "bfloat16")
        procedural_counts, _ = cli_epoch(card, "procedural.yml", ["--data_dir", str(data_dir)],
                                         runs_bf16["procedural.yml"].expected, None,
                                         set(CASCADE_TAGS), args.seed, Path(tmp))
    for name in kernels:
        kernels[name]["launches"] += (disk_counts[name] + walk_counts[name]
                                      + fvd_is_counts[name] + rehearsal_counts[name]
                                      + procedural_counts[name])
        kernels[name]["bf16_launches"] += procedural_counts[name]
    print(f"launches on the main paths: serving {launches} dfn_forward; the steps of "
          f"{', '.join(runs)} {train_counts}; the CLI {cli_counts}; from disk {disk_counts}; "
          f"the walks {walk_counts}; FVD and IS {fvd_is_counts}; rehearsal {rehearsal_counts}; "
          f"at bfloat16: serving {serving_bf16['launches']} dfn_forward, the steps of "
          f"{', '.join(runs_bf16)} {bf16_counts}, throughput.yml's CLI {cli_bf16}, "
          f"procedural.yml's CLI {procedural_counts}")

    # -------------- 21-24. the remaining training objectives, as variants
    variants = variant_phases(card, gen, args.seed, build_dir)
    runs_var, served = variants.runs, variants.served
    for name in kernels:
        f32_var = sum(r.train_counts[name] for f, r in runs_var.items()
                      if f != "throughput_seq.yml")
        bf16_var = runs_var["throughput_seq.yml"].train_counts[name]
        kernels[name]["launches"] += (f32_var + bf16_var + variants.seq_counts[name]
                                      + variants.noseg_counts[name] + served[name])
        kernels[name]["bf16_launches"] += bf16_var
        kernels[name]["variant_step_launches"] = {f: r.expected[name]
                                                  for f, r in runs_var.items()}
    for name, rows in variants.new_maps.items():
        kernels[name]["new_maps"] = rows
    print(f"launches of the variants: the steps "
          + "; ".join(f"{f} {r.train_counts}" for f, r in runs_var.items())
          + f"; the seq CLI {variants.seq_counts}; the no-seg CLI {variants.noseg_counts}; its "
          f"serving {served}")

    # ------------------------- 27-28. CLEVR's 4-frame stories at full width
    phase(f"27. {CLEVR_CONFIG} at full width: D+G steps, kernels vs plain, the BN and DFN "
          "kernels at its shapes, serving")
    clevr = clevr_step(card, gen, floor, args.seed)
    phase(f"28. the CLEVR CLI: --synthetic {CLEVR_SYNTHETIC}, 2 epochs with CPCSV_PROFILE_DIR, "
          "then 1 and an auto-resumed epoch; --eval_ssim")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_clevr_", dir=build_dir) as tmp:
        clevr_cli_counts = clevr_cli(card, clevr.record.expected, args.seed, Path(tmp))
        phase(f"34. the CLEVR CLI from disk: --data_dir on a tree of {sum(CLEVR_DISK)} stories, "
              "one epoch, then --eval_fid")
        clevr_disk_counts = clevr_disk(card, clevr.record.expected, args.seed, Path(tmp))
    for name in kernels:
        bf16 = remat_bf16["counts"][name] + adam_bf16[name]
        kernels[name]["launches"] += (remat["counts"][name] + adam_counts[name]
                                      + clevr.record.train_counts[name] + clevr.served[name]
                                      + clevr_cli_counts[name] + remat_cascade["counts"][name]
                                      + bf16 + clevr_disk_counts[name])
        kernels[name]["bf16_launches"] += bf16
        kernels[name]["clevr_step_launches"] = clevr.record.expected[name]
        kernels[name]["remat_step_launches"] = remat["per_step"][name]
        kernels[name]["remat_cascade_step_launches"] = remat_cascade["per_step"][name]
        kernels[name]["remat_bf16_step_launches"] = remat_bf16["per_step"][name]
    for name in ("bn_stats", "bn_grad_reduce"):
        shape = clevr.largest[name]["shape"]
        _, _, kernel_ms, library_ms, bound = clevr.per_shape[name, shape]
        kernels[name].update({
            "clevr_shape": shape, "clevr_max_abs_err": clevr.bn_err[name], "clevr_ms": kernel_ms,
            "clevr_plain_ms": clevr.largest[name]["plain_ms"], "clevr_bound_ms": bound,
            "clevr_bound_by": clevr.largest[name]["bound_by"], "clevr_library_ms": library_ms,
            "clevr_step_ms": clevr.step_bn[CLEVR_CONFIG][name][0],
            "clevr_step_bound_ms": clevr.step_bn[CLEVR_CONFIG][name][1],
        })
    for name, t in (("dfn_forward", clevr.fwd), ("dfn_backward", clevr.bwd)):
        kernels[name].update({
            "clevr_shape": [CLEVR_DFN_B, *DFN_SHAPE[:2]], "clevr_ms": t.graph_ms,
            "clevr_plain_ms": t.plain_ms, "clevr_bound_ms": t.bound_ms,
            "clevr_bound_by": t.bound_by, "clevr_library_ms": t.library_ms})
    print(f"launches of REMAT {remat['counts']}, ADAM_MU_DTYPE {adam_counts}, {CLEVR_CONFIG}'s "
          f"steps {clevr.record.train_counts}, its serving {clevr.served}, its CLI and walk "
          f"{clevr_cli_counts}; phase 34: REMAT on cascade.yml {remat_cascade['counts']}, on "
          f"throughput.yml {remat_bf16['counts']}, ADAM_MU_DTYPE on throughput.yml {adam_bf16}, "
          f"the CLEVR CLI from disk {clevr_disk_counts}")

    # ------------------------------------------- 29-31. data parallelism
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_", dir=build_dir) as tmp:
        root = Path(tmp)
        # the ranks of phases 32, 30 and 31 start up a phase ahead (`spawn_dp`)
        four_ranks = spawn_dp("four", root, 2 * DP_WORLD, mode="steps")
        phase(f"29. {DP_WORLD} gloo ranks on the card: a D+G step of {DP_CONFIG} against one "
              "process on the global batch")
        dp_counts, p29 = dp_step_phase(card, args.seed, root)
        nccl_rank = spawn_dp("nccl", root, 1)
        cli_ranks = spawn_dp("cli", root, DP_WORLD, env=cli_env(root))
        one_rank = spawn_dp("cli_one", root, 1, mode="cli")
        phase(f"32. a model axis: {DP_WORLD} gloo ranks under {DP_MODEL} (in phase 29's launch) "
              f"against one process, {2 * DP_WORLD} under {DP_FOUR} against phase 29's "
              f"{DP_WORLD}")
        model_counts = model_axis_phase(card, root, p29, four_ranks)
        del p29
        phase("30. one NCCL rank, its data group the world: phase 6's step bit for bit, then timed")
        nccl_counts, nccl_scan = nccl_phase(card, args.seed, root, runs[DP_CONFIG].step_ms,
                                            nccl_rank)
        phase(f"31. the CLI with {DP_WORLD} gloo ranks: 2 epochs, 1 + an auto-resumed one, "
              "--eval_ssim on rank 0")
        dp_cli_counts, one_cli_counts = dp_cli_phase(card, args.seed, root, cli_ranks, one_rank)
    for name in kernels:
        kernels[name]["launches"] += (dp_counts[name] + nccl_counts[name] + dp_cli_counts[name]
                                      + model_counts[name] + one_cli_counts[name])
        kernels[name]["dp_launches"] = {"steps": dp_counts[name], "nccl": nccl_counts[name],
                                        "cli": dp_cli_counts[name], "model": model_counts[name],
                                        "cli_one_process": one_cli_counts[name]}
    print(f"launches of the data-parallel phases, summed over the ranks: the step {dp_counts}, "
          f"the model axis {model_counts}, NCCL {nccl_counts}, the CLI {dp_cli_counts} (phase "
          f"33's step among them), phase 33's one process {one_cli_counts}")

    # phase 37's ranks, one a card, start up beside phase 35
    multi_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_multi_", dir=build_dir)
    multi_root, multi_ranks = Path(multi_tmp.name), {}
    if cards > 1:
        on_cards = lambda rank: {"LOCAL_RANK": str(rank)}  # noqa: E731
        multi_ranks["all"] = spawn_dp("multi_all", multi_root, cards, on_cards, "multi",
                                      one_card=False)
        if cards > 2:
            multi_ranks["two"] = spawn_dp("multi_two", multi_root, 2, on_cards, "multi",
                                          one_card=False)
        if cards >= 4:
            multi_ranks["four"] = spawn_dp("multi_four", multi_root, 4, on_cards, "steps",
                                           one_card=False)
        if host_split(cards) > 1:  # phase 38: the cards as two hosts' halves
            per_host = host_split(cards)
            multi_ranks["hosts"] = spawn_dp(
                "multi_hosts", multi_root, cards, lambda rank: {
                    "CUDA_VISIBLE_DEVICES": ",".join(
                        str(rank // per_host * per_host + i) for i in range(per_host)),
                    "LOCAL_RANK": str(rank % per_host)}, "multi", one_card=False)

    # ------------------- 35. SCAN_STEPS: chunks of pairs as CUDA graph replays
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scan_", dir=build_dir) as tmp:
        phase(f"35 (a). SCAN_STEPS {SCAN_PAIRS} against 1 through GANTrainer, 2 epochs of "
              f"{SCAN_PAIRS} steps: {', '.join(SCAN_CONFIGS)}")
        scan = scan_phase(card, args.seed, Path(tmp))
    phase(f"35 (b). one NCCL rank (in phase 30's launch): {DP_CONFIG} at SCAN_STEPS {SCAN_PAIRS} "
          "against phase 35 (a)'s one process")
    ref = scan["reference"]
    check(nccl_scan["ways"] == [f"SCAN_STEPS {SCAN_PAIRS}: each chunk's pairs replayed as a CUDA "
                                "graph of the D+G pair"], f"phase 35 (b): {nccl_scan['ways']}")
    check(nccl_scan["history"] == ref.history and (nccl_scan["sums"] == ref.sums).all(),
          "phase 35 (b): the NCCL rank's chunks differ from one process's")
    print(f"phase 35 (b) [{card}]: one NCCL rank, its all-reduces captured in the graph: "
          f"{len(ref.history)} updates' metrics and {len(ref.sums)} state tensors bit for bit "
          f"phase 35 (a)'s one process; {nccl_scan['seconds']:.2f} s; launches "
          f"{nccl_scan['counts']}")
    phase(f"35 (c). SCAN_STEPS {SCAN_TIMED_K} timed: a warm chunk against {SCAN_TIMED_K} pairs "
          f"one at a time, {', '.join(SCAN_TIMED_CONFIGS)}")
    timing_counts, chunk_ms = scan_timing(card, args.seed, {
        n: (runs_bf16 if n in BF16_CONFIGS else runs)[n].step_ms for n in SCAN_TIMED_CONFIGS})
    for name in kernels:
        kernels[name]["launches"] += (scan["counts"][name] + nccl_scan["counts"][name]
                                      + timing_counts[name])
        kernels[name]["scan_launches"] = {"trainer": scan["counts"][name],
                                          "nccl": nccl_scan["counts"][name],
                                          "timed": timing_counts[name]}
    print(f"launches of phase 35, CUDA graph replays included: the trainer runs {scan['counts']}, "
          f"the NCCL rank's {nccl_scan['counts']}, the timed chunks and pairs {timing_counts}")

    # ------------------------------ 37. training across the cards of the host
    pins.close()
    phase(f"37. training across the cards of the host: {cards} card(s)")
    t = time.perf_counter()
    check(started == [], f"the CLI runs of phases 10-34 started ranks: {started}")
    print(f"phase 37 [{card}]: the CLI runs of the phases before, in this process on one card, "
          "started no ranks")
    if cards > 1:
        multi_counts = multi_card_phase(card, args.seed, multi_root, cards, multi_ranks, chunk_ms)
    else:
        one_card_phase(card, multi_root)
        multi_counts = {}
        phase("38. training across hosts: the launch rules on one card")
        host_rules(card)
    seq_shuffle_cost(card)
    multi_tmp.cleanup()
    print(f"phase 37 [{card}]: {time.perf_counter() - t:.1f} s")
    for name in kernels:
        kernels[name]["launches"] += multi_counts.get(name, 0)
        kernels[name]["multi_card_launches"] = multi_counts.get(name, 0)

    # phases 5 and 15 again, side by side: a call replayed against eager
    print(f"serving [{card}], a call graphed / eager: ms (median of 5), device busy ms and idle "
          "share (trace of 3), device ops a call; kernel nodes of its graph")
    for label, rows, nodes in (("f32", serving_ms, sampler_nodes),
                               ("bf16", serving_bf16["ms"], serving_bf16["nodes"])):
        for (name, n), t in rows.items():
            g, e = t["graphed"], t["eager"]
            print(f"  {name} {label} {n} stories: {g['ms']:.2f} / {e['ms']:.2f} ms "
                  f"({e['ms'] / g['ms']:.3f}x), busy {g['busy_ms']:.3f} / {e['busy_ms']:.3f}, "
                  f"idle {g['idle']:.3f} / {e['idle']:.3f}, ops {g['ops']:.0f} / {e['ops']:.0f}, "
                  f"nodes {nodes[name][n]}")

    kernels["dfn_forward"]["launches"] += shard["launches"]
    kernels["dfn_forward"]["bf16_launches"] += shard["bf16_launches"]
    kernels["dfn_forward"]["shard_launches"] = shard["launches"]
    print(f"phase 36 [{card}], ms a call split over {shard_devices()[1]} / on one device: "
          + "; ".join(f"{name} {n}: {t['split']:.2f} / {t['whole']:.2f}"
                      for (name, n, *_), t in shard["ms"].items() if isinstance(t, dict)))

    phase("done")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
