#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``self_supervise_sfm_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, each of which must pass (any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit) and the build of every
   kernel in ``self_supervise_sfm_tpu_torch/csrc`` with ``nvcc`` for sm_90a;
   the seconds to the end of each source's nvcc (all side by side) and of
   the link; the registers, spills and shared memory of the Hopper
   attention body's kernels (K1, K2, K2p, K1m, at head dims 64 and 128), of
   the Hopper backward body's (B9's dq and
   dk/dv, unmasked and under a RelocMask; a spill in either body fails the
   run)
   and of the Hopper GEMM body's (MLP-up, MLP-down, the probe, the
   layer-norm pre-pass, LN+QKV+RoPE, LN+QKV, the out-projection; the last
   three at head dims 64 and 128), of the
   fp32 attention body's (the fp32 forms of K1, K2, K2p, K1m at head dims
   64 and 128; a spill fails the run), of the fp32 backward body's (B9's dq
   and dk/dv in fp32, unmasked and under a RelocMask, at head dims 64 and
   128; a spill fails the run), of the fp32 GEMM body's (the fp32 forms of the five fused block
   kernels and their layer-norm pre-pass, LN+QKV+RoPE, LN+QKV and the
   out-projection also at head dim 128; a spill fails the run), and any
   ptxas advisory that wgmma was serialised (C7518);
2. the GEMM body's operand layouts alone (``gemm_probe``: one tile, then
   ragged rows and a K loop, against an fp32 matmul); each of the twelve
   kernels at the shapes of the paths below, held against its plain
   PyTorch version with the tolerance stated, and timed (CUDA events,
   median) beside its plain version, the PyTorch library call (for the
   fused block kernels: the chain of library calls) computing the same
   function (a yardstick the port never calls) and its bound: the larger of
   its operations at the bf16 tensor-core peak and its bytes at the memory
   peak of an H100 SXM (989 TFLOP/s, 3.35 TB/s); for every site of K1, K2,
   K2p and the fused block kernels the kernel's ratio to its bound and to
   its library call, per call and 20 launches back to back; the layer-norm
   pre-pass of LN+QKV(+RoPE) and MLP-up alone; K3 at its three sites: the
   DPT head's (its rate on its bound's bytes beside the most its
   back-to-back time lets it move; bit-equal to the one-chunk launch and to
   one image a chunk) and the fine tracker's, (5120, 16, 16, 32) -> 31 x
   31 fp32 with no addend (within an fp32 ulp of the plain version,
   bit-equal across chunkings, timed with every image in one chunk and with
   the chunk ``ops/resize.py:image_chunk`` picks, beside ``F.interpolate``
   and its bound), the TrackHead's ``refinenet1``, (16, 148, 148, 128) ->
   296 x 296 fp32 with no addend (within an fp32 ulp, bit-equal across
   chunkings, beside ``F.interpolate`` and its bound), and K3 at the edges
   of its thread mapping (4 and 8
   channels a thread, ragged pixel counts, one image a chunk); B9 at the edges of its tiling and at the train step's sites,
   its RelocMask forms at the edges of their work tiles, at reloc layer 0
   and at the 5-query mask-form shape, a repeat bit-equal, the pair (dq +
   dk/dv) against SDPA's backward; K1m (the flash forward under a
   RelocMask) at the 5-query shape bit-equal to K2p on the same problem and
   within tolerance of its plain version there and at the edges of its
   segment maps, each edge bit-equal to K2 on the unfolded tensors; the
   fp32 forms of K1 (ViT, frame and global sites), K2 (the reloc site) and
   K2p (layers 0 and 23 of the 5-anchor cache, a 20-anchor cache) in fp32
   with TF32 off, each within 2e-5 at the largest |out| of its plain
   version (the lse within 1e-5), a repeat bit-equal, K2p bit-equal to K2,
   the edges of the tiling, timed beside their bound at the fp32 rate (67
   TFLOP/s), the plain version and SDPA in fp32; the fp32 forms of the five
   fused block kernels (the FFMA GEMM body) at the ViT, frame, reloc and
   global sites in fp32 with TF32 off, each output within 2e-5 of its
   largest |value| of the plain version's, a repeat bit-equal, the
   layer-norm pre-pass alone, timed per call and back to back beside the
   bound at the fp32 rate, the plain version and the fp32 chain of library
   calls they replace, then at the edges of the tiling (rows no multiple of
   the tile, a tile across a frame boundary, one row) and on a head-shard
   weight (C, 3 Hl 64); then the head dim 128 forms (8 heads of 128 at C
   1024): K1 at the ViT, frame and global sites, K2 at the reloc site, K2p
   at layers 0 and 23 of the 5-anchor cache, K1m at the 5-query mask form,
   LN+QKV+RoPE, LN+QKV and the out-projection at the ViT, frame, reloc and
   global sites, B9's dq and dk/dv at the train step's sites of 8 heads
   (unmasked, the split's two calls, RelocMask(610, 1374, 2) and
   RelocMask(1525, 1374, 5), the edges of the tiling) beside SDPA's
   backward at d = 128, each against its plain version at the head dim 64
   tolerances, a repeat bit-equal, timed as above; then the fp32 forms at
   head dim 128 (the FFMA bodies) at the same sites of 8 heads, with the fp32
   entries' checks above (2e-5 of the largest |out| or |gradient|, lse 1e-5,
   TF32 off, repeats, K2p and K1m bit-equal to K2, the edges, 96 and 33 q
   rows among them) beside SDPA in fp32, and LN+QKV+RoPE, LN+QKV and the
   out-projection in fp32 at head dim 128 (the FFMA GEMM body) at the ViT,
   frame, reloc and global sites, the edges at 2 and 3 heads of 128 and the
   head shard at 4 of 8 heads, beside the fp32 library chain
   (``check_d128_kernels``);
3. the full-width joint forward: ViT-L/14 + 24 aggregator layers at 518 px,
   bf16 trunk and fp32 heads, 5 anchors + the same 5 images as queries,
   rank 300, random weights from a seeded generator, every trunk block on
   the fused LN+QKV / out-proj / MLP kernels. Launch counts are read around
   one forward; the same forward with every kernel site on its plain
   PyTorch path must agree with it (within the bf16 envelope that an fp32
   forward measures) and give finite poses and point maps. The path with
   only the attention and resize kernels on (the fused block kernels off)
   is timed in the same run. The default configuration (``make_config()``:
   fp32, ``attn_impl="auto"``) runs at the same width: its attention sites
   on the fp32 forms of K1 (72 launches) and K2 (24), no fused block kernel
   ("auto" takes them for a bf16 trunk only, as JAX's), K3 as in bf16; it
   must agree with the fp32 plain forward to fp32 rounding, and is timed
   against the same forward on the dense route, with both peaks. The fp32
   trunk with the fused block kernels asked for (``fused_qkv="on",
   fused_mlp="on"``) runs every trunk block on their fp32 forms (the
   default configuration's launches plus the bf16 path's fused counts under
   fp32 names), is held to the fp32 plain forward as the default
   configuration is, and is timed in turns against it, with both peaks and
   a profile;
4. two-phase serving at the same width and with the same weights:
   ``build_scene_cache`` of the 5 anchors, then ``reloc`` (full heads and
   ``fast_reloc``) of the 5 images against the cache, with launch counts
   around one build and one reloc (the in-place kv2 kernel 24 times a reloc),
   the cache and the reloc taps against the plain-path build / reloc, the
   reloc taps against the joint forward's query taps of phase 3, and timings;
   then a 20-anchor scene: one-shot, anchor-chunked and host-staged builds
   against each other, ``reloc_staged`` against the resident ``reloc`` bit
   for bit, ``reloc_chunked`` against ``reloc``, times and peaks of each.
   Then the default configuration with phase 3's fp32 weights: the build
   of the 5 anchors (an fp32 cache, 59,965,440 bytes an anchor), ``reloc``
   and ``fast_reloc`` on the fp32 forms (K2p 24 times a reloc), held to the
   fp32 plain path at rel-RMS 1e-5, timed; the same with the fused block
   kernels on in fp32 (their launch counts, the same checks, times beside
   the default configuration's); the one-shot fp32 build of the 20-anchor
   scene on the kernels, its time and peak, beside the 48.3 GB of fp32
   logits its global site would store on the dense route.

4b. head dim 128: ``make_config(num_heads=8, compute_dtype="bfloat16")``
   (the trainer's ``--num-heads 8``; ViT-L/14 and the 24-layer aggregator
   at 8 heads of 128) at full width with weights of its own seed: the
   forward, the 5-anchor build, ``reloc`` and ``fast_reloc`` with the
   flagship's launch counts on the head dim 128 forms (no dense attention,
   no plain fused-block chain), their taps, camera tokens and cache against
   the plain path of the same configuration within twice its
   bf16-vs-fp32 envelope, reloc layer 0's mask form (K1m) bit-equal to its
   layout form (K2p), the forward timed in turns against the same
   configuration on the dense route with the fused blocks off and against
   phase 3's flagship, build / reloc / ``fast_reloc`` times, peaks and a
   profile (``run_d128``; its paths go into the kernel line as
   "forward_d128", "build_d128", "reloc_d128", "fast_reloc_d128" and
   "mask_form_d128"). Then its fp32 leg, ``make_config(num_heads=8)``
   (fp32, "auto"): the forward, the build, ``reloc`` and ``fast_reloc``
   with the default configuration's launch counts under the fp32 head dim
   128 names (no dense attention site), held to the fp32 plain path of the
   same configuration at rel-RMS 1e-5, the mask form (K1m fp32) bit-equal
   to the layout form (K2p fp32), the forward timed in turns against its
   dense route and the default configuration at 16 heads of 64, with peaks
   (paths "forward_d128_f32", "build_d128_f32", "reloc_d128_f32",
   "fast_reloc_d128_f32", "mask_form_d128_f32"). Then the same fp32 model
   under ``fused_qkv="on", fused_mlp="on"``: the forward, the build,
   ``reloc`` and ``fast_reloc`` with ``D128_F32_ON_*_LAUNCHES`` (every
   trunk block on the fused blocks' fp32 forms, LN+QKV(+RoPE) and the
   out-projection at head dim 128), held to the same fp32 plain path at
   rel-RMS 1e-5, the forward timed in turns with the "auto" leg (paths
   "forward_d128_f32_on", "build_d128_f32_on", "reloc_d128_f32_on",
   "fast_reloc_d128_f32_on").

5. the self-supervised train step at full width (``bench.py:bench_train``'s
   configuration at depth 24: 2 frames of 518 px duplicated as anchors and
   queries, rank 300, bf16 trunk on fp32 master weights, Adam with a bf16
   first moment, each aggregator layer rematerialised) on a batch of 2 pairs
   x 10 000 correspondences made from known poses: launch counts of one
   step against the code's prediction (the B9 backward kernels among them),
   four steps (the first at learning rate 0), finite losses, nonzero trunk
   and camera gradients, untouched DPT heads, the gradients against the
   plain path's within twice the bf16-vs-fp32 envelope, times, peak memory
   and a profile of one step, with B9's device ms a step; then the same
   state, batch and subsample in fp32 in the default configuration and with
   the fused block kernels on (``fused_qkv="on", fused_mlp="on"``): launch
   counts, loss and gradients against the fp32 plain step (loss rtol 1e-4,
   gradient rel-RMS and norms 1e-3 a subsystem), time and peak in turns.

5b. head dim 128 training: phase 5's step at 8 heads of 128
   (``make_config(num_heads=8, compute_dtype="bfloat16", remat=True)``, the
   trainer's ``--num-heads 8``) on a state of its own seed: the launch
   counts of one step against phase 5's under the head dim 128 names
   (``D128_TRAIN_STEP_LAUNCHES``: B9's dq and dk/dv 120 each, no dense
   attention), four steps (the first at learning rate 0), finite losses and
   gradient norms, the gradients against its own plain path within twice
   its bf16-vs-fp32 envelope, the step timed in turns against phase 5's
   flagship step and against its dense route, the peak with both states
   resident, one profiled step (device busy and B9's device ms, beside
   phase 5's profiled step). Its launch counts are the kernel line's
   "train_d128" path (``run_train_d128``). Then the same state, batch and
   subsample in fp32 (``make_config(num_heads=8, remat=True)``): the
   launches ``D128_F32_TRAIN_STEP_LAUNCHES`` (B9's fp32 head dim 128 pair
   120 + 120, no dense attention), loss and gradients against the fp32
   plain step of the same configuration (loss rtol 1e-4, gradient rel-RMS
   and norms 1e-3 a subsystem), time and peak in turns with its dense
   route, B9's device ms (path "train_d128_f32"); and the same under
   ``fused_qkv="on", fused_mlp="on"``: the launches
   ``D128_F32_ON_TRAIN_STEP_LAUNCHES``, loss and gradients against the same
   fp32 plain step, time in turns with "auto", the fused kernels' device ms
   (path "train_d128_f32_on").

6. the trainer (``train/trainer.py:run``) around phase 5's full-width step,
   on numpy-made synthetic scenes at 518 px (no ``h5py`` needed; artifact
   dumps off, so no matplotlib either): run A takes 6 steps with
   checkpoints at steps 3 and 6, a profile window over one step, one
   sanity check and one validation (one 8-frame scene, 2048
   correspondences a pair); the step-6 checkpoint
   restored bit-equal to run A's state; the spread of one step from the
   step-3 checkpoint restored twice; run B resumes from the step-3
   checkpoint and is held against run A within that spread (bit-equal when
   it is 0). It prints the trainer's steps/s against phase 5's bare step,
   the profiled step's idle share and launches, validation and sanity-check
   ms, checkpoint GB and save / write / restore seconds, and peak GB; run
   A's launch counts go into the kernel line as the "trainer" path.

7. the reconstruction demo (``demos/reconstruct.py:run``) with phase 3's
   weights and the default ``VGGSfMTrackerConfig()`` (random weights from
   a seed) on a numpy-made 5-frame scene (``SyntheticScenes`` with a fine
   checkerboard on its plane, so that the keypoint detector finds 2048
   corners a frame): ``--mode forward`` and ``--mode reloc`` with
   ``--tracks-ba`` and 2048 query points, each with its launch counts
   (phase 3's, or phase 4's build plus reloc, plus one K3 launch per
   tracker chunk of >= 4365 patches), its PLY / KITTI / ``results.json``
   outputs and, when a reconstruction survives the gating, its COLMAP
   models read back (text against binary); the seconds of each stage; the
   tracker with K3 against the einsum path on 1024 queries (patch features
   within phase 3's fp32 envelope, tracks after one fine iteration within
   1e-3 px; the default six iterations printed for the record); the DINO
   ranking through K1 and LN+QKV against the plain path; one tracking call
   profiled (idle share, launches); bundle adjustment on known geometry
   (the plane's points projected with the true poses and K plus 0.5 px
   noise, the poses perturbed) at 5 frames x 6144 and 20 frames x 10,240
   tracks with the torch engine (twice: its spread) and the native one:
   each must bring the RMSE down to the noise and the ATE down, and the
   two engines' final Huber costs must agree within 1e-3; the peak GB. Its
   launch counts are the kernel line's "demo" path.

8. the checkpoint converter and the modules of its slice: phase 3's
   weights (kept on the host) written as a state dict in the reference's
   names and layouts (``reference_state_dict``, this script's own inverse
   of the converter's rules), ``torch.save``d (~5 GB fp32), loaded and
   converted on the demo's ``--pretrained`` path
   (``utils/converter.py:load_torch_state_dict`` + ``convert_sailrecon``):
   every leaf bit-equal to phase 3's, the forward on them bit-equal to
   phase 3's with phase 3's launch counts, the save / load / convert
   seconds; the TrackHead (``heads/track.py``, the default
   ``TrackHeadConfig()``) on the taps of 16 frames of 518 px through the
   bf16 aggregator with 512 query points: K3 launched once a call (the
   ``refinenet1`` upsample (16, 148, 148, 128) -> 296), feature maps
   against the einsum upsample within rel-RMS 1e-5, tracks after one
   iteration within 1e-3 px (after four printed), a call's wall time, idle
   share and launches; K1 and the fused block kernels alone at the ViT-B
   (C 768, 12 heads), ViT-g (C 1536, 24 heads) and ViT-S (C 384, 6 heads)
   sites of 2 frames (LN+QKV,
   the out-projection and the MLP pair at the ViT blocks' shape,
   LN+QKV+RoPE at a frame block's), each against its plain version and
   timed beside its library call or chain and its bound (the kernel line's
   ``width_sites``); ``vit_small`` / ``vit_base`` / ``vit_giant2`` in
   bf16 on 2 frames of 518 px with their launch counts (K1, LN+QKV, the
   out-projection, MLP-up and MLP-down once a block each), against their plain
   path within twice the bf16-vs-fp32 envelope; the ``"aliked"`` extractor
   on phase 7's images, its score maps and top-k scores within 1e-4 of the
   same weights on the CPU and its keypoints within 1e-3 px wherever the
   scores stand apart by more than that, its time an image; the peak GB.
   Its launch counts go into the kernel line as the paths "pretrained",
   "track_head" and one a ViT width.

9. the multi-device path (``parallel/``): one NCCL process of world size
   1 (NCCL takes one rank a device, and the machine has one card) with
   the sharded path forced; the sharded joint forward, build, full-head
   reloc and ``fast_reloc`` with phase 3's weights and inputs, each
   bit-equal to the unsharded program with its launch counts and timed
   beside it; one cache layer's gather; the ring's fold of 2, 5 and 10
   chunks at the global site (16, 6870, 64) bf16 through K1 and the lse
   merge, its forward against fp32 attention (within twice K1-whole's
   error) and its gradients (B9 with ``dlse``) against B9 over the whole,
   timed beside K1 over the whole; the per-rank cache bytes of a
   200-anchor scene at 1, 2, 4 and 8 ranks. Its paths go into the kernel
   line as "sharded_forward", "sharded_build", "sharded_reloc" and
   "ring_fold".

10. multi-device training (``train/loop.py``'s sharded step, the trainer
   under a mesh, ``native/ba.py:ba_solve_multihost``), again in one NCCL
   process of world size 1 with the sharded path forced: the DDP step and
   the FSDP step (whole-leaf slices: the trunk cast and gathered, the
   gradients reduce-scattered), four steps each of phase 5's
   configuration, weights, batch and subsample, bit-equal to phase 5's
   metrics and sampled leaves with phase 5's launch counts, their
   collectives a step (of the order of the gradient buckets) and times
   beside phase 5's; the trainer under the mesh with FSDP, phase 6's
   configuration for 3 steps with a sanity check and a checkpoint at step
   3, its losses equal to phase 6's run A's and the checkpoint restored
   into the one-device layout bit-equal to the live state;
   ``ba_solve_multihost`` over the NCCL group on phase 7's 5 x 6144
   problem, equal to the one-shard solver; the per-rank state bytes at 1,
   2, 4 and 8 ranks under DDP and FSDP. Its paths go into the kernel line
   as "sharded_train" and "sharded_trainer".

11. tensor parallelism over ``model`` (``parallel/sp_block.py``'s Megatron
   blocks, the ring's head split, the head-cut scene cache, the TP step):
   LN+QKV+RoPE and LN+QKV on one rank's head shard, the (1024, 3 Hl 64)
   weight, at m = 2 and 4 model ranks and every rank index, at the frame
   (10, 1374, 1024) and global (1, 6870, 1024) sites and LN+QKV at the ViT
   site, each against its plain version (phase 2's ulps) and bit-equal to
   the whole-width kernel's heads, the m = 1 form bit-equal to the
   whole-width call, timed per call and back to back beside the whole-width
   kernel and the bounds; the m ranks of one frame, reloc and global block
   emulated in turn in one process (each rank's shard through the kernels,
   the row-parallel partials summed where the all-reduce would run) against
   the fp32 block within twice the unsharded kernel block's error; one NCCL
   process of world size 1 with the TP path forced
   (``force_single_device_spmd(tp=True)``): the joint forward, the build and
   a full-head reloc and ``fast_reloc``, and four train steps of phase 5's
   configuration, with their launch counts (no out-projection or MLP
   kernel: the row-parallel tail is plain, as JAX's) and times, held
   against the unsharded kernel programs within twice their distance from
   fp32 (the steps that read the first state, 0 and 1, by their loss and
   gradient norm; steps 2-3 follow updates and are printed); the per-rank bytes of the train state under TP x DDP and TP x
   FSDP at m = 1, 2, 4, 8 and of a 200-anchor kv2 cache cut over heads. Its
   paths go into the kernel line as "tp_shards" (the emulated blocks),
   "tp_forward", "tp_serving" and "tp_train", and the head-shard sites as
   the QKV kernels' "tp_sites".

``python3 chip_smoke.py --kernels-only`` stops after phase 2,
``--until-serving`` after phase 4b, ``--d128-only`` runs the build, phase
2's head dim 128 checks, phase 4b and phase 5b (each with a flagship of its
own);
``--train-only`` runs phase 5 alone after the build, ``--trainer-only``
phases 5 and 6, ``--demo-only`` phase 7, ``--converter-only`` phase 8,
``--sharded-only`` phase 9, ``--sharded-train-only`` phase 10 and
``--tp-only`` phase 11 (on weights they draw from the seed, phase 10 with
phase 5's and phase 6's references made first; their launch counts are then
not merged into the kernel line, which is not printed).
``--torchrun-trainer`` and ``--torchrun-tp`` run under ``torchrun
--nproc_per_node N`` on a machine of N cards (build the kernels once
first): the trainer over DDP / FSDP meshes, and the forward and a 3-step
trainer with the heads cut over the N cards against one card (N = 2 or 4),
in bf16 on the kernels and in fp32 on the plain path.
A run with no arguments takes neither.

The line before the last is a JSON object of every kernel's numbers (the
forward's and the serving paths' numbers go on lines of their own before
it); the last line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

# per call: the median of calls each between two events; back to back: 20
# calls queued behind a spin of the device (tools/timing.py)
from self_supervise_sfm_tpu_torch.tools.timing import back_to_back_ms as _back_to_back_ms
from self_supervise_sfm_tpu_torch.tools.timing import per_call_ms as _time_ms

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # fp32 outside the tensor cores (FFMA)
PEAK_BYTES_PER_S = 3.35e12
NUM_FRAMES = 5
IMG = 518
RANK = 300
SEED = 0
# K1, K1m, K2 and K2p: one attention body written for Hopper
SM90_SOURCE = "self_supervise_sfm_tpu_torch/csrc/flash_fwd_sm90.cu"
# LN+QKV+RoPE, LN+QKV, the out-projection, MLP-up and MLP-down: one GEMM
# body written for Hopper
GEMM_SOURCE = "self_supervise_sfm_tpu_torch/csrc/gemm_sm90.cu"
# the fp32 forms of K1, K1m, K2 and K2p: one FFMA body
F32_SOURCE = "self_supervise_sfm_tpu_torch/csrc/flash_fwd_f32.cu"
# the fp32 forms of B9 (dq, dk/dv; unmasked and under a RelocMask): one FFMA body
F32_BWD_SOURCE = "self_supervise_sfm_tpu_torch/csrc/flash_bwd_f32.cu"
# the fp32 forms of LN+QKV+RoPE, LN+QKV, the out-projection, MLP-up and
# MLP-down: one FFMA GEMM body
F32_GEMM_SOURCE = "self_supervise_sfm_tpu_torch/csrc/gemm_f32.cu"
# the kernels with a head dim, built at 64 and at 128 (on the Hopper bodies
# above); at 128 each counts its launches apart, under its name + "_d128"
D128_KERNELS = ("flash_fwd", "frame_ctx_fwd", "frame_ctx_packed_fwd", "flash_fwd_reloc",
                "fused_ln_qkv_rope", "fused_ln_qkv", "fused_proj_residual", "flash_bwd_dq",
                "flash_bwd_dkv")
# the fp32 forms at head dim 128 (on the FFMA bodies) of the attention
# kernels and of the fused blocks with a head dim, each counting its
# launches apart, under its name + "_d128_f32"
D128_F32_KERNELS = ("flash_fwd", "frame_ctx_fwd", "frame_ctx_packed_fwd", "flash_fwd_reloc",
                    "flash_bwd_dq", "flash_bwd_dkv", "fused_ln_qkv_rope", "fused_ln_qkv",
                    "fused_proj_residual")


# launches of each kernel wrapper in one call at full width (depth 24, 5
# frames): the joint forward (24 ViT + 24 x (frame, reloc, global) blocks),
# a scene-cache build (24 ViT + 24 x (frame, global); the context K/V
# unfused) and a reloc (24 ViT + 24 x (frame, reloc against the cache in
# place)); ``fast_reloc`` decodes no dense head, so no K3
_ZERO = dict.fromkeys(("flash_fwd", "frame_ctx_fwd", "frame_ctx_packed_fwd", "flash_fwd_reloc",
                       "resize_bilinear", "fused_ln_qkv_rope", "fused_ln_qkv",
                       "fused_proj_residual", "fused_mlp_up", "fused_mlp_down", "flash_bwd_dq",
                       "flash_bwd_dkv", "flash_fwd_f32", "frame_ctx_fwd_f32",
                       "frame_ctx_packed_fwd_f32", "flash_fwd_reloc_f32", "flash_bwd_dq_f32",
                       "flash_bwd_dkv_f32", "fused_ln_qkv_rope_f32", "fused_ln_qkv_f32",
                       "fused_proj_residual_f32", "fused_mlp_up_f32", "fused_mlp_down_f32",
                       *(f"{k}_d128" for k in D128_KERNELS),
                       *(f"{k}_d128_f32" for k in D128_F32_KERNELS)), 0)
FORWARD_LAUNCHES = {**_ZERO, "flash_fwd": 72, "frame_ctx_fwd": 24, "resize_bilinear": 2,
                    "fused_ln_qkv_rope": 72, "fused_ln_qkv": 24, "fused_proj_residual": 96,
                    "fused_mlp_up": 96, "fused_mlp_down": 96}
BUILD_LAUNCHES = {**_ZERO, "flash_fwd": 72, "fused_ln_qkv": 24, "fused_ln_qkv_rope": 48,
                  "fused_proj_residual": 72, "fused_mlp_up": 72, "fused_mlp_down": 72}
FAST_RELOC_LAUNCHES = {**_ZERO, "flash_fwd": 48, "frame_ctx_packed_fwd": 24, "fused_ln_qkv": 24,
                       "fused_ln_qkv_rope": 48, "fused_proj_residual": 72, "fused_mlp_up": 72,
                       "fused_mlp_down": 72}
RELOC_LAUNCHES = {**FAST_RELOC_LAUNCHES, "resize_bilinear": 2}
# the default configuration (fp32, "auto"): the attention sites on the fp32
# forms of K1, K2 and K2p, the fused block kernels off ("auto" takes them for
# a bf16 trunk only, as JAX's), K3 as in bf16
DEFAULT_FORWARD_LAUNCHES = {**_ZERO, "flash_fwd_f32": 72, "frame_ctx_fwd_f32": 24,
                            "resize_bilinear": 2}
DEFAULT_BUILD_LAUNCHES = {**_ZERO, "flash_fwd_f32": 72}
DEFAULT_FAST_RELOC_LAUNCHES = {**_ZERO, "flash_fwd_f32": 48, "frame_ctx_packed_fwd_f32": 24}
DEFAULT_RELOC_LAUNCHES = {**DEFAULT_FAST_RELOC_LAUNCHES, "resize_bilinear": 2}
# one full-width train step (phase 5), d = 24 aggregator layers
# rematerialised, v = 24 ViT blocks: forwards v + 2d flash (+ 2d recomputed +
# 2d in the frame-context split's backward), d frame-context (+ d
# recomputed), 3d fused block kernels of each kind (+ 3d recomputed) and v
# more of the ViT's; backwards one B9 pair a flash attention, two a
# frame-context split
# phase 5's metrics of its four steps and its sampled leaves after them
# (host copies), which phase 10 holds its sharded steps to
PHASE5: dict = {}
TRAIN_STEP_LAUNCHES = {**_ZERO, "flash_fwd": 24 + 6 * 24, "frame_ctx_fwd": 2 * 24,
                       "fused_ln_qkv": 24, "fused_ln_qkv_rope": 6 * 24,
                       "fused_proj_residual": 24 + 6 * 24, "fused_mlp_up": 24 + 6 * 24,
                       "fused_mlp_down": 24 + 6 * 24, "flash_bwd_dq": 24 + 4 * 24,
                       "flash_bwd_dkv": 24 + 4 * 24}
# the same step in the default configuration (fp32, "auto"): the attention
# sites on the fp32 forms of K1 and K2 and the backward on B9's fp32 pair,
# the bf16 step's counts; no fused block kernel ("auto", fp32)
DEFAULT_TRAIN_STEP_LAUNCHES = {**_ZERO, "flash_fwd_f32": 24 + 6 * 24,
                               "frame_ctx_fwd_f32": 2 * 24,
                               "flash_bwd_dq_f32": 24 + 4 * 24,
                               "flash_bwd_dkv_f32": 24 + 4 * 24}
# the fp32 trunk with the fused block kernels asked for (``fused_qkv="on",
# fused_mlp="on"``): the default configuration's launches, plus the bf16
# path's fused block counts under the fp32 names (every trunk block on the
# fp32 forms of the five)
FUSED_BLOCK_KERNELS = ("fused_ln_qkv_rope", "fused_ln_qkv", "fused_proj_residual",
                       "fused_mlp_up", "fused_mlp_down")
ON_F32 = dict(fused_qkv="on", fused_mlp="on")


def _on_f32(default: dict, bf16: dict) -> dict:
    return {**default, **{f"{k}_f32": bf16[k] for k in FUSED_BLOCK_KERNELS}}


ON_F32_FORWARD_LAUNCHES = _on_f32(DEFAULT_FORWARD_LAUNCHES, FORWARD_LAUNCHES)
ON_F32_BUILD_LAUNCHES = _on_f32(DEFAULT_BUILD_LAUNCHES, BUILD_LAUNCHES)
ON_F32_RELOC_LAUNCHES = _on_f32(DEFAULT_RELOC_LAUNCHES, RELOC_LAUNCHES)
ON_F32_FAST_RELOC_LAUNCHES = _on_f32(DEFAULT_FAST_RELOC_LAUNCHES, FAST_RELOC_LAUNCHES)
ON_F32_TRAIN_STEP_LAUNCHES = _on_f32(DEFAULT_TRAIN_STEP_LAUNCHES, TRAIN_STEP_LAUNCHES)


def _d128(bf16: dict) -> dict:
    """The bf16 path's launches with every kernel that has a head dim under
    its head dim 128 name: the same model at 8 heads of 128 (phase 4b)."""
    return {**_ZERO, **{(f"{k}_d128" if k in D128_KERNELS else k): n
                        for k, n in bf16.items() if n}}


D128_FORWARD_LAUNCHES = _d128(FORWARD_LAUNCHES)
D128_BUILD_LAUNCHES = _d128(BUILD_LAUNCHES)
D128_RELOC_LAUNCHES = _d128(RELOC_LAUNCHES)
D128_FAST_RELOC_LAUNCHES = _d128(FAST_RELOC_LAUNCHES)
# phase 5b: phase 5's step at 8 heads of 128, B9 on its head dim 128 entries
D128_TRAIN_STEP_LAUNCHES = _d128(TRAIN_STEP_LAUNCHES)


def _d128_f32(default: dict) -> dict:
    """An fp32 configuration's launches with every fp32 kernel that has a
    head dim under its head dim 128 name: the fp32 model at 8 heads of 128
    (the fp32 legs of phases 4b and 5b, "auto" and "on")."""
    names = {f"{k}_f32": f"{k}_d128_f32" for k in D128_F32_KERNELS}
    return {**_ZERO, **{names.get(k, k): n for k, n in default.items() if n}}


D128_F32_FORWARD_LAUNCHES = _d128_f32(DEFAULT_FORWARD_LAUNCHES)
D128_F32_BUILD_LAUNCHES = _d128_f32(DEFAULT_BUILD_LAUNCHES)
D128_F32_RELOC_LAUNCHES = _d128_f32(DEFAULT_RELOC_LAUNCHES)
D128_F32_FAST_RELOC_LAUNCHES = _d128_f32(DEFAULT_FAST_RELOC_LAUNCHES)
D128_F32_TRAIN_STEP_LAUNCHES = _d128_f32(DEFAULT_TRAIN_STEP_LAUNCHES)
# the same model under ``fused_qkv="on", fused_mlp="on"``: the fp32 trunk's
# fused block counts, LN+QKV(+RoPE) and the out-projection on their head dim
# 128 forms, the MLP pair (no head dim) on its fp32 entries
D128_F32_ON_FORWARD_LAUNCHES = _d128_f32(ON_F32_FORWARD_LAUNCHES)
D128_F32_ON_BUILD_LAUNCHES = _d128_f32(ON_F32_BUILD_LAUNCHES)
D128_F32_ON_RELOC_LAUNCHES = _d128_f32(ON_F32_RELOC_LAUNCHES)
D128_F32_ON_FAST_RELOC_LAUNCHES = _d128_f32(ON_F32_FAST_RELOC_LAUNCHES)
D128_F32_ON_TRAIN_STEP_LAUNCHES = _d128_f32(ON_F32_TRAIN_STEP_LAUNCHES)


def _wall_ms(fn, reps: int = 3) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# kernel-name patterns of each class, checked in order
_KERNEL_CLASSES = (
    # the port's own kernels first: a name holding "gemm" or "norm" further
    # down must not claim them
    ("fused_ln_qkv_rope", ("ln_qkv_rope_sm90_kernel",)),
    ("fused_ln_qkv", ("ln_qkv_sm90_kernel",)),
    ("fused_proj_residual", ("proj_residual_sm90_kernel",)),
    ("fused_mlp_up", ("mlp_up_sm90_kernel",)),
    ("fused_mlp_down", ("mlp_down_sm90_kernel",)),
    ("ln_rows (pre-pass of LN+QKV(+RoPE) and MLP-up)", ("ln_rows_kernel",)),
    ("fused_ln_qkv_rope fp32", ("ln_qkv_rope_f32_kernel",)),
    ("fused_ln_qkv fp32", ("ln_qkv_f32_kernel",)),
    ("fused_proj_residual fp32", ("proj_residual_f32_kernel",)),
    ("fused_mlp_up fp32", ("mlp_up_f32_kernel",)),
    ("fused_mlp_down fp32", ("mlp_down_f32_kernel",)),
    ("ln_rows fp32 (pre-pass of the fp32 forms)", ("ln_rows_f32_kernel",)),
    ("fused_ln_qkv_rope d128", ("ln_qkv_rope_d128_sm90_kernel",)),
    ("fused_ln_qkv d128", ("ln_qkv_d128_sm90_kernel",)),
    ("fused_proj_residual d128", ("proj_residual_d128_sm90_kernel",)),
    ("fused_ln_qkv_rope d128 fp32", ("ln_qkv_rope_d128_f32_kernel",)),
    ("fused_ln_qkv d128 fp32", ("ln_qkv_d128_f32_kernel",)),
    ("fused_proj_residual d128 fp32", ("proj_residual_d128_f32_kernel",)),
    ("flash_fwd (K1)", ("flash_fwd_kernel",)),
    ("flash_fwd d128 (K1)", ("flash_fwd_d128_kernel",)),
    ("frame_ctx_fwd d128 (K2)", ("frame_ctx_fwd_d128_kernel",)),
    ("frame_ctx_kv2_fwd d128 (K2p)", ("frame_ctx_kv2_fwd_d128_kernel",)),
    ("flash_fwd_reloc d128 (K1m)", ("flash_fwd_reloc_d128_sm90_kernel",)),
    ("flash_fwd fp32 (K1)", ("flash_fwd_f32_kernel",)),
    ("frame_ctx_fwd fp32 (K2)", ("frame_ctx_fwd_f32_kernel",)),
    ("frame_ctx_kv2_fwd fp32 (K2p)", ("frame_ctx_kv2_fwd_f32_kernel",)),
    ("flash_fwd_reloc fp32 (K1m)", ("flash_fwd_reloc_f32_kernel",)),
    ("flash_bwd_dq fp32 (B9)", ("flash_bwd_dq_f32_kernel", "flash_bwd_dq_reloc_f32_kernel")),
    ("flash_bwd_dkv fp32 (B9)", ("flash_bwd_dkv_f32_kernel", "flash_bwd_dkv_reloc_f32_kernel")),
    ("flash_fwd d128 fp32 (K1)", ("flash_fwd_d128_f32_kernel",)),
    ("frame_ctx_fwd d128 fp32 (K2)", ("frame_ctx_fwd_d128_f32_kernel",)),
    ("frame_ctx_kv2_fwd d128 fp32 (K2p)", ("frame_ctx_kv2_fwd_d128_f32_kernel",)),
    ("flash_fwd_reloc d128 fp32 (K1m)", ("flash_fwd_reloc_d128_f32_kernel",)),
    ("flash_bwd_dq d128 fp32 (B9)", ("flash_bwd_dq_d128_f32_kernel",
                                     "flash_bwd_dq_reloc_d128_f32_kernel")),
    ("flash_bwd_dkv d128 fp32 (B9)", ("flash_bwd_dkv_d128_f32_kernel",
                                      "flash_bwd_dkv_reloc_d128_f32_kernel")),
    ("flash_bwd_dq (B9)", ("flash_bwd_dq_sm90_kernel", "flash_bwd_dq_reloc_sm90_kernel")),
    ("flash_bwd_dkv (B9)", ("flash_bwd_dkv_sm90_kernel", "flash_bwd_dkv_reloc_sm90_kernel")),
    ("flash_bwd_dq d128 (B9)", ("flash_bwd_dq_d128_sm90_kernel",
                                "flash_bwd_dq_reloc_d128_sm90_kernel")),
    ("flash_bwd_dkv d128 (B9)", ("flash_bwd_dkv_d128_sm90_kernel",
                                 "flash_bwd_dkv_reloc_d128_sm90_kernel")),
    ("frame_ctx_fwd (K2)", ("frame_ctx_fwd_kernel",)),
    ("frame_ctx_kv2_fwd (K2p)", ("frame_ctx_kv2_fwd_kernel",)),
    ("flash_fwd_reloc (K1m)", ("flash_fwd_reloc_sm90_kernel",)),
    ("resize_bilinear (K3)", ("resize_bilinear_ac_kernel",)),
    ("convolution", ("conv", "fprop", "dgrad", "winograd", "implicit")),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("softmax / reduction", ("softmax", "reduce", "norm")),
    ("copy / layout", ("copy", "cat", "transpose", "memcpy", "memset", "index",
                       "gather", "scatter")),
)


def profile_forward(fn, label: str = "forward") -> dict:
    """One call of ``fn`` under torch.profiler: device time by kernel class,
    the top kernels, and the device's idle share of the profiled wall time
    (the profiler's own host cost included)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("  profiler: no device events recorded; breakdown not measured")
        return {"measured": False}
    classes = {name: 0.0 for name, _ in _KERNEL_CLASSES}
    classes["elementwise / other"] = 0.0
    for e in kernels:
        key = e.key.lower()
        cls = next((n for n, pats in _KERNEL_CLASSES if any(p in key for p in pats)),
                   "elementwise / other")
        classes[cls] += e.self_device_time_total / 1e3
    busy_ms = sum(classes.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    print(f"  profiled {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.3f}), {sum(e.count for e in kernels)} "
          f"kernel launches")
    for name, ms in sorted(classes.items(), key=lambda kv: -kv[1]):
        print(f"    {name}: {ms:.2f} ms ({ms / busy_ms:.3f})")
    for e in top:
        print(f"    top: {e.self_device_time_total / 1e3:8.2f} ms x{e.count:5d}  {e.key[:90]}")
    return {"measured": True, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "launches": sum(e.count for e in kernels), "classes_ms": classes,
            "top": [[e.key[:120], e.self_device_time_total / 1e3, e.count] for e in top]}


def _bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _site_line(label: str, r: dict) -> None:
    """One site's times and its ratios to its bound and its library call,
    per call and back to back."""
    print(f"  {label}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
          f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
          f"kernel / bound {r['ms'] / r['bound_ms']:.2f}x, kernel / library "
          f"{r['ms'] / r['library_ms']:.2f}x; back to back kernel "
          f"{r['back_to_back_ms']:.4f} ms, library {r['library_back_to_back_ms']:.4f} ms "
          f"({r['back_to_back_ms'] / r['library_back_to_back_ms']:.2f}x)")


def _entry_name(mangled: str) -> str:
    """The last name of an Itanium-mangled nested name (_ZN<len><id>...):
    the kernel's own name, without its namespace or template arguments."""
    i, name = mangled.find("_ZN") + 3, "?"
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    return name


def print_build_log(log: str) -> None:
    """ptxas's registers and spills of every kernel, each line under the
    name of its kernel, and any warning or performance advisory (such as
    wgmma serialisation)."""
    name = "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = _entry_name(line)
        elif "Used" in line or "spill" in line:
            print(f"  ptxas {name}: {line.strip().removeprefix('ptxas info    : ')}")
        elif "warning" in line or "Performance" in line:
            print(f"  {line.strip()}")


def print_sm90_build() -> None:
    """Registers a thread at launch, spills and dynamic shared memory of the
    Hopper attention, backward and GEMM bodies' kernels as the runtime
    reports them, and the setmaxnreg counts they were built with."""
    import ctypes

    from self_supervise_sfm_tpu_torch import _kernels

    names = ("flash_fwd_kernel", "frame_ctx_fwd_kernel", "frame_ctx_kv2_fwd_kernel",
             "flash_fwd_reloc_sm90_kernel", "flash_fwd_d128_kernel", "frame_ctx_fwd_d128_kernel",
             "frame_ctx_kv2_fwd_d128_kernel", "flash_fwd_reloc_d128_sm90_kernel")
    lib = _kernels.library()
    for which, name in enumerate(names):
        info = (ctypes.c_int * 8)()
        rc = lib.sfm_attention_sm90_info(which, info)
        if rc != 0:
            raise RuntimeError(f"sfm_attention_sm90_info({which}): CUDA error {rc}")
        print(f"  {name}: {info[0]} registers a thread at launch, {info[1]} local bytes, "
              f"{info[2]} bytes of dynamic shared memory, {info[3]} stages of {info[5]} keys, "
              f"{info[4]} q rows a tile, setmaxnreg {info[6]} (producer) / {info[7]} "
              f"(consumers)")
        if info[1]:
            raise AssertionError(f"{name}: {info[1]} bytes of spills a thread")
    names = ("mlp_up_sm90_kernel", "mlp_down_sm90_kernel", "gemm_probe_sm90_kernel",
             "ln_rows_kernel", "ln_qkv_rope_sm90_kernel", "ln_qkv_sm90_kernel",
             "proj_residual_sm90_kernel", "ln_qkv_rope_d128_sm90_kernel",
             "ln_qkv_d128_sm90_kernel", "proj_residual_d128_sm90_kernel")
    for which, name in enumerate(names):
        info = (ctypes.c_int * 10)()
        rc = lib.sfm_gemm_sm90_info(which, info)
        if rc != 0:
            raise RuntimeError(f"sfm_gemm_sm90_info({which}): CUDA error {rc}")
        if which == 3:
            print(f"  {name}: {info[0]} registers a thread, {info[1]} local bytes")
            continue
        print(f"  {name}: {info[0]} registers a thread at launch, {info[1]} local bytes, "
              f"{info[2]} bytes of dynamic shared memory, {info[3]} stages, tiles of "
              f"{info[4]} x {info[5]}, {'ping-pong' if info[8] else 'cooperative'}, raster "
              f"groups of {info[9]} row tiles, setmaxnreg {info[6]} (producer) / {info[7]} "
              f"(consumers)")
    for which, name in enumerate(("flash_bwd_dq_sm90_kernel", "flash_bwd_dkv_sm90_kernel",
                                  "flash_bwd_dq_reloc_sm90_kernel",
                                  "flash_bwd_dkv_reloc_sm90_kernel",
                                  "flash_bwd_dq_d128_sm90_kernel",
                                  "flash_bwd_dkv_d128_sm90_kernel",
                                  "flash_bwd_dq_reloc_d128_sm90_kernel",
                                  "flash_bwd_dkv_reloc_d128_sm90_kernel")):
        info = (ctypes.c_int * 8)()
        rc = lib.sfm_flash_bwd_sm90_info(which, info)
        if rc != 0:
            raise RuntimeError(f"sfm_flash_bwd_sm90_info({which}): CUDA error {rc}")
        dq = which % 2 == 0
        print(f"  {name}: {info[0]} registers a thread at launch, {info[1]} local bytes, "
              f"{info[2]} bytes of dynamic shared memory, {info[3]} stages of {info[5]} "
              f"{'keys' if dq else 'q rows'}, {info[4]} "
              f"{'q rows' if dq else 'keys'} a work tile, setmaxnreg {info[6]} "
              f"(producer) / {info[7]} (consumers)")
        if info[1]:
            raise AssertionError(f"{name}: {info[1]} bytes of spills a thread")
    # the fp32 bodies' kernels at head dim 64, then their head dim 128 forms
    f32_fwd = ("flash_fwd_", "frame_ctx_fwd_", "frame_ctx_kv2_fwd_", "flash_fwd_reloc_")
    f32_bwd = ("flash_bwd_dq_", "flash_bwd_dkv_", "flash_bwd_dq_reloc_", "flash_bwd_dkv_reloc_")
    f32_bodies = (
        ("sfm_flash_fwd_f32_info", [f"{k}{hd}f32_kernel" for hd in ("", "d128_") for k in f32_fwd],
         ("q rows", "keys", "head dim")),
        ("sfm_flash_bwd_f32_info", [f"{k}{hd}f32_kernel" for hd in ("", "d128_") for k in f32_bwd],
         ("rows", "rows", "stages")))
    for entry, names, (own, streamed, last) in f32_bodies:
        for which, name in enumerate(names):
            info = (ctypes.c_int * 8)()
            rc = getattr(lib, entry)(which, info)
            if rc != 0:
                raise RuntimeError(f"{entry}({which}): CUDA error {rc}")
            print(f"  {name}: {info[0]} registers a thread, {info[1]} local bytes, {info[2]} "
                  f"bytes of dynamic shared memory, {info[3]} {own} a block, {info[4]} "
                  f"{streamed} a tile, {info[5]} threads, {info[6]} blocks an SM, {last} "
                  f"{info[7]}")
            if info[1]:
                raise AssertionError(f"{name}: {info[1]} bytes of spills a thread")
    for which, name in enumerate(("ln_qkv_rope_f32_kernel", "ln_qkv_f32_kernel",
                                  "proj_residual_f32_kernel", "mlp_up_f32_kernel",
                                  "mlp_down_f32_kernel", "ln_rows_f32_kernel",
                                  "ln_qkv_rope_d128_f32_kernel", "ln_qkv_d128_f32_kernel",
                                  "proj_residual_d128_f32_kernel")):
        info = (ctypes.c_int * 10)()
        rc = lib.sfm_gemm_f32_info(which, info)
        if rc != 0:
            raise RuntimeError(f"sfm_gemm_f32_info({which}): CUDA error {rc}")
        shape = (f"tiles of {info[3]} x {info[4]}, K steps of {info[5]} through {info[6]} "
                 f"stages" if which != 5 else f"{info[3]} rows a block")
        print(f"  {name}: {info[0]} registers a thread, {info[1]} local bytes, {info[2]} "
              f"bytes of dynamic shared memory, {shape}, {info[7]} threads, {info[8]} "
              f"blocks an SM")
        if info[1]:
            raise AssertionError(f"{name}: {info[1]} bytes of spills a thread")
    # C7518 and C7512 (the latter: too few registers for the wgmma in flight)
    advisories = [ln.strip() for ln in _kernels.build_log.splitlines()
                  if "wgmma" in ln and "serialized" in ln]
    print(f"  ptxas wgmma serialisation advisories (C7518, C7512): {advisories or 'none'}")


def _check(name: str, err: float, tol: float) -> None:
    status = "ok" if err <= tol else "FAIL"
    print(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.3e}) {status}")
    if err > tol:
        raise AssertionError(f"{name}: error {err} over tolerance {tol}")


def _logit(key: str, v):
    """Map a head output back to the scale of its logit: log for the exp
    depth and the 1 + exp confidences (softplus of the logit), sign *
    log1p|v| for the inverse-log point maps and the world points.
    Overflowed entries stay inf."""
    import torch

    if key in ("depth_map", "xyz_cnf", "dpt_cnf"):
        # subnormal outputs (logit below log of the smallest normal) carry
        # too few bits to invert: counted with the underflowed ones
        tiny = torch.finfo(torch.float32).tiny
        return torch.where(v < tiny, float("-inf"), torch.log(v))
    return torch.sign(v) * torch.log1p(v.abs())


def flash_site(randn, ulps, site, bh, n, d=64):
    """K1 at one site (bh, n, d): against its plain version (4 ulps, lse
    1e-4), a repeat bit-equal, its bound, and its times beside SDPA's, a
    call and back to back."""
    import torch
    import torch.nn.functional as F

    from self_supervise_sfm_tpu_torch.ops import flash_attention as FA

    q, k, v = randn(bh, n, d), randn(bh, n, d), randn(bh, n, d)
    out, lse = FA.flash_fwd(q, k, v)
    again, lse_again = FA.flash_fwd(q, k, v)
    torch.cuda.synchronize()
    if not (torch.equal(out, again) and torch.equal(lse, lse_again)):
        raise AssertionError(f"flash_fwd[{site}] {tuple(q.shape)}: a repeat differs")
    p_out, p_lse = FA.flash_fwd_plain(q, k, v)
    err = float((out.float() - p_out.float()).abs().max())
    _check(f"flash_fwd[{site}] out {tuple(q.shape)}", err, ulps(p_out, 4))
    _check(f"flash_fwd[{site}] lse", float((lse - p_lse).abs().max()), 1e-4)
    bound, by = _bound_ms(4.0 * bh * n * n * d, 4 * q.numel() * 2 + lse.numel() * 4)
    q4, k4, v4 = (t.view(1, bh, n, d) for t in (q, k, v))
    return dict(
        site=site, shape=[bh, n, d], max_abs_err=err,
        ms=_time_ms(lambda: FA.flash_fwd(q, k, v)),
        plain_ms=_time_ms(lambda: FA.flash_fwd_plain(q, k, v), reps=5),
        library_ms=_time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4)),
        bound_ms=bound, bound_by=by,
        back_to_back_ms=_back_to_back_ms(lambda: FA.flash_fwd(q, k, v)),
        library_back_to_back_ms=_back_to_back_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4)),
    )


def check_kernels(gen):
    """Phase 2: every kernel at the main path's shapes against its plain
    version; returns per-kernel measurements (launches filled in later)."""
    import torch
    import torch.nn.functional as F

    from self_supervise_sfm_tpu_torch.ops import flash_attention as FA
    from self_supervise_sfm_tpu_torch.ops import resize as RS

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # bf16 outputs differ by whole ulps where the fp32 sums of kernel and
    # plain version straddle a rounding boundary: tolerance n ulps at the
    # largest output
    def ulps(ref, n):
        return n * 2.0 ** (math.floor(math.log2(float(ref.abs().max()))) - 7)

    results = []
    # -- K1: flash forward at the ViT, frame and global sites ---------------
    N = (IMG // 14) ** 2 + 5
    sites = [flash_site(randn, ulps, site, bh, n)
             for site, bh, n in (("vit", NUM_FRAMES * 16, N), ("frame", 2 * NUM_FRAMES * 16, N),
                                 ("global", 16, NUM_FRAMES * N))]
    for s_ in sites:
        _site_line(f"flash_fwd[{s_['site']}] {tuple(s_['shape'])}", s_)
    results.append(dict(
        name="flash_fwd", route="cuda", source=SM90_SOURCE,
        replaces="self_supervise_sfm_tpu/ops/flash_attention.py:140",
        # one call at each of the three sites (one ViT + one aggregator layer)
        max_abs_err=max(s["max_abs_err"] for s in sites),
        **{k: sum(s[k] for s in sites) for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
        bound_by=sites[-1]["bound_by"], sites=sites,
    ))

    # -- K2: [context ‖ own frame] attention at the reloc site --------------
    results.append(frame_ctx_site(randn, ulps))

    # -- K3: final DPT upsample 296 -> 518 with the fused pos-embed addend --
    H0 = 4 * (IMG // 14) * 2  # 296
    x = randn(NUM_FRAMES, H0, H0, 128, dtype=torch.float32)
    add = randn(IMG, IMG, 128, dtype=torch.float32)
    out = RS.resize_bilinear_fwd(x, (IMG, IMG), add, torch.bfloat16)
    torch.cuda.synchronize()
    ref = RS.resize_bilinear_plain(x, (IMG, IMG), add, torch.bfloat16)
    err = float((out.float() - ref.float()).abs().max())
    _check(f"resize_bilinear {tuple(x.shape)} -> {IMG} bf16", err, ulps(ref, 1))
    err32 = float((RS.resize_bilinear_fwd(x, (IMG, IMG), add)
                   - RS.resize_bilinear_plain(x, (IMG, IMG), add)).abs().max())
    _check("resize_bilinear fp32 store", err32, 1e-5 * float(ref.float().abs().max()))

    def library():
        y = F.interpolate(x.permute(0, 3, 1, 2), size=(IMG, IMG), mode="bilinear",
                          align_corners=True)
        return (y.permute(0, 2, 3, 1) + add).to(torch.bfloat16)

    # the bound's bytes: x, the addend and the output once each
    bound_bytes = x.numel() * 4 + add.numel() * 4 + out.numel() * 2
    bound, by = _bound_ms(0.0, bound_bytes)
    kernel = lambda: RS.resize_bilinear_fwd(x, (IMG, IMG), add, torch.bfloat16)  # noqa: E731
    # the DPT site's chunk is every image: the launch of the one-chunk mapping
    chunk_dpt = RS.image_chunk(NUM_FRAMES, IMG, IMG, 128)
    one = RS.resize_bilinear_fwd(x, (IMG, IMG), add, torch.bfloat16, img_chunk=NUM_FRAMES)
    split = RS.resize_bilinear_fwd(x, (IMG, IMG), add, torch.bfloat16, img_chunk=1)
    torch.cuda.synchronize()
    dpt_equal = torch.equal(out, one) and torch.equal(out, split)
    print(f"  resize_bilinear DPT site: chosen chunk {chunk_dpt} of {NUM_FRAMES} images; "
          f"bit-equal to the one-chunk launch and to one image a chunk: {dpt_equal}")
    if chunk_dpt != NUM_FRAMES or not dpt_equal:
        raise AssertionError("resize_bilinear: the DPT site moved off the one-chunk launch")
    dpt = dict(
        site="dpt", shape=list(x.shape), out_hw=[IMG, IMG], img_chunk=chunk_dpt,
        max_abs_err=err, max_abs_err_fp32=err32,
        ms=_time_ms(kernel),
        plain_ms=_time_ms(lambda: RS.resize_bilinear_plain(x, (IMG, IMG), add,
                                                           torch.bfloat16), reps=5),
        library_ms=_time_ms(library),
        bound_ms=bound, bound_by=by,
        back_to_back_ms=_back_to_back_ms(kernel),
        library_back_to_back_ms=_back_to_back_ms(library),
    )
    _site_line(f"resize_bilinear {tuple(x.shape)} -> {IMG} bf16", dpt)
    # a model, not a measurement: the device-memory bytes if the addend is
    # read once a call (the bound's) or once an image, beside the most that
    # the measured back-to-back time lets the kernel move at the memory peak
    per_image = bound_bytes + (x.shape[0] - 1) * add.numel() * 4
    print(f"  resize_bilinear: {bound_bytes / dpt['ms'] / 1e6:.1f} GB/s a call "
          f"({bound_bytes / dpt['back_to_back_ms'] / 1e6:.1f} back to back) on the bound's "
          f"{bound_bytes / 1e6:.1f} MB; model (not measured): {bound_bytes / 1e6:.1f} MB "
          f"if the addend is read once a call, {per_image / 1e6:.1f} MB if once an image; "
          f"at the memory peak its back-to-back time allows at most "
          f"{dpt['back_to_back_ms'] * 1e-3 * PEAK_BYTES_PER_S / 1e6:.1f} MB")
    del x, add, out, ref, one, split
    torch.cuda.empty_cache()
    tracker = check_tracker_resize()
    torch.cuda.empty_cache()
    track_head = check_track_head_resize()
    k3_sites = [dpt, tracker, track_head]
    results.append(dict(
        name="resize_bilinear", route="cuda",
        source="self_supervise_sfm_tpu_torch/csrc/resize.cu",
        replaces="self_supervise_sfm_tpu/ops/resize.py:51,136",
        # one call at each of the three sites (the DPT head, the fine tracker,
        # the TrackHead's refinenet1)
        max_abs_err=max(s_["max_abs_err"] for s_ in k3_sites),
        **{k: sum(s_[k] for s_ in k3_sites)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
        bound_by="bytes", sites=k3_sites,
    ))
    # K3 at the edges of its thread mapping, inputs from a generator of their
    # own: 8 channels a thread (C = 24) and 4 (C = 12), 429 / 286 threads (no
    # multiple of the block), with and without the addend, both stores
    k3 = torch.Generator(device="cuda").manual_seed(SEED + 11)
    for c in (24, 12):
        xe = torch.randn((3, 5, 7, c), generator=k3, device="cuda")
        for adde in (None, torch.randn((11, 13, c), generator=k3, device="cuda")):
            for dt in (torch.bfloat16, torch.float32):
                got = RS.resize_bilinear_fwd(xe, (11, 13), adde, dt)
                torch.cuda.synchronize()
                ref = RS.resize_bilinear_plain(xe, (11, 13), adde, dt)
                tol = ulps(ref, 1) if dt == torch.bfloat16 else 1e-5 * float(ref.abs().max())
                _check(f"resize_bilinear edge (3, 5, 7, {c}) -> (11, 13) "
                       f"{'with' if adde is not None else 'no'} addend {dt}",
                       float((got.float() - ref.float()).abs().max()), tol)
    results += check_fused_kernels(randn, ulps)
    # inputs from a generator of their own: the weights of phase 3 are drawn
    # from `gen` after this phase, and stay what they were before these checks
    # were added
    own = torch.Generator(device="cuda").manual_seed(SEED + 3)
    results += check_serving_kernels(
        lambda *shape: torch.randn(shape, generator=own, device="cuda").to(torch.bfloat16),
        ulps)
    edges = torch.Generator(device="cuda").manual_seed(SEED + 7)
    check_attention_edges(
        lambda *shape: torch.randn(shape, generator=edges, device="cuda").to(torch.bfloat16),
        ulps)
    bwd = torch.Generator(device="cuda").manual_seed(SEED + 5)
    results += check_backward_kernels(
        lambda *shape, dtype=torch.bfloat16: torch.randn(
            shape, generator=bwd, device="cuda").to(dtype), ulps)
    f32 = torch.Generator(device="cuda").manual_seed(SEED + 61)
    results += check_f32_kernels(
        lambda *shape: torch.randn(shape, generator=f32, device="cuda"))
    f32_bwd = torch.Generator(device="cuda").manual_seed(SEED + 67)
    results += check_f32_bwd_kernels(
        lambda *shape: torch.randn(shape, generator=f32_bwd, device="cuda"))
    f32_gemm = torch.Generator(device="cuda").manual_seed(SEED + 71)
    results += check_fused_f32_kernels(
        lambda *shape: torch.randn(shape, generator=f32_gemm, device="cuda"))
    d128 = torch.Generator(device="cuda").manual_seed(SEED + 83)
    results += check_d128_kernels(
        lambda *shape, dtype=torch.bfloat16: torch.randn(
            shape, generator=d128, device="cuda").to(dtype), ulps)
    for r in results:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    return results


def frame_ctx_site(randn, ulps, H=16, d=64):
    """K2 at the reloc site, (5, H, 1374, d) against a (1, H, 1525, d)
    context: against its plain version (4 ulps), a repeat bit-equal, its
    bound, and its times beside SDPA's over the [ctx ‖ own] K/V concatenated
    beforehand, a call and back to back."""
    import torch
    import torch.nn.functional as F

    from self_supervise_sfm_tpu_torch.ops import flash_attention as FA

    P, nc = (IMG // 14) ** 2 + 5, NUM_FRAMES * (RANK + 5)
    q, k, v = (randn(NUM_FRAMES, H, P, d) for _ in range(3))
    ck, cv = randn(1, H, nc, d), randn(1, H, nc, d)
    out = FA.frame_ctx_fwd(q, k, v, ck, cv)
    again = FA.frame_ctx_fwd(q, k, v, ck, cv)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"frame_ctx_fwd {tuple(q.shape)}: a repeat differs")
    ref = FA._frame_ctx_dense(q, k, v, ck, cv)
    err = float((out.float() - ref.float()).abs().max())
    _check(f"frame_ctx_fwd {tuple(q.shape)} ctx {tuple(ck.shape)}", err, ulps(ref, 4))
    kk = torch.cat([ck.expand(NUM_FRAMES, -1, -1, -1), k], dim=2)
    vv = torch.cat([cv.expand(NUM_FRAMES, -1, -1, -1), v], dim=2)
    bound, by = _bound_ms(4.0 * NUM_FRAMES * H * P * (nc + P) * d,
                          (4 * q.numel() + 2 * ck.numel()) * 2)
    r = dict(
        name="frame_ctx_fwd" + ("_d128" if d == 128 else ""), route="cuda", source=SM90_SOURCE,
        replaces="self_supervise_sfm_tpu/ops/flash_attention.py:539",
        max_abs_err=err, shape=list(q.shape),
        ms=_time_ms(lambda: FA.frame_ctx_fwd(q, k, v, ck, cv)),
        plain_ms=_time_ms(lambda: FA._frame_ctx_dense(q, k, v, ck, cv), reps=5),
        # SDPA over the [ctx ‖ own] K/V concatenated beforehand
        library_ms=_time_ms(lambda: F.scaled_dot_product_attention(q, kk, vv)),
        bound_ms=bound, bound_by=by,
        back_to_back_ms=_back_to_back_ms(lambda: FA.frame_ctx_fwd(q, k, v, ck, cv)),
        library_back_to_back_ms=_back_to_back_ms(
            lambda: F.scaled_dot_product_attention(q, kk, vv)),
    )
    _site_line(f"frame_ctx_fwd {tuple(q.shape)} ctx {nc}", r)
    return r


def check_d128_kernels(randn, ulps):
    """Phase 2, the kernels at head dim 128 (the model at 8 heads of 128 of
    phase 4b): K1 at the ViT (40, 1374, 128), frame (80, 1374, 128) and
    global (8, 6870, 128) sites, K2 at the reloc site (5, 8, 1374, 128)
    against a (1, 8, 1525, 128) context, K2p at layers 0 and 23 of the
    5-anchor cache (24, 1, 8, 1525, 256), K1m at the 5-query mask form (8,
    6870) x (8, 8395), LN+QKV+RoPE, LN+QKV and the out-projection at C 1024
    in 8 heads at the ViT, frame, reloc and global sites, then B9's dq and
    dk/dv at the train step's sites of 8 heads (``check_backward_kernels``:
    the ViT, frame, global and the split's two sites, RelocMask(610, 1374,
    2) and RelocMask(1525, 1374, 5), the edges of the tiling). Each against
    its plain version at phase 2's tolerances (attention 4 ulps at the
    largest output, lse within 1e-4; the fused blocks 4 ulps for q / k, 2
    for v and the out-projection; B9 4 ulps at the largest |gradient|), a
    repeat bit-equal, timed a call and back to back beside its bound (the
    same operations as the head dim 64 site), its plain version and its
    library call (SDPA at d = 128, its backward for B9; the replaced chain
    for the fused blocks). Then the fp32 forms at head dim 128 on the FFMA
    bodies, in fp32 with TF32 off, at the same sites of 8 heads
    (``check_f32_kernels`` and ``check_f32_bwd_kernels`` with ``H=8,
    d=128``: 2e-5 of the largest |out| or |gradient|, lse 1e-5, repeats,
    K2p and K1m bit-equal to K2, the edges of the tiling) beside SDPA in
    fp32, and LN+QKV+RoPE, LN+QKV and the out-projection on the FFMA GEMM
    body (``check_fused_f32_kernels`` with ``H=8``: 2e-5 of the largest
    |value|, repeats, the edges at 2 and 3 heads of 128, the head shard at
    4 of 8) beside the fp32 library chain."""
    import torch

    N = (IMG // 14) ** 2 + 5
    sites = [flash_site(randn, ulps, site, bh, n, d=128)
             for site, bh, n in (("vit", NUM_FRAMES * 8, N), ("frame", 2 * NUM_FRAMES * 8, N),
                                 ("global", 8, NUM_FRAMES * N))]
    for s_ in sites:
        _site_line(f"flash_fwd_d128[{s_['site']}] {tuple(s_['shape'])}", s_)
    results = [dict(
        name="flash_fwd_d128", route="cuda", source=SM90_SOURCE,
        replaces="self_supervise_sfm_tpu/ops/flash_attention.py:140",
        max_abs_err=max(s["max_abs_err"] for s in sites),
        **{k: sum(s[k] for s in sites) for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
        bound_by=sites[-1]["bound_by"], sites=sites)]
    results.append(frame_ctx_site(randn, ulps, H=8, d=128))
    results += check_serving_kernels(randn, ulps, H=8, d=128)
    results += check_fused_kernels(randn, ulps, C=1024, H=8, mlp=False)
    results += check_backward_kernels(randn, ulps, H=8, d=128)

    def randn32(*shape):
        return randn(*shape, dtype=torch.float32)

    results += check_f32_kernels(randn32, H=8, d=128)
    torch.cuda.empty_cache()
    results += check_f32_bwd_kernels(randn32, H=8, d=128)
    torch.cuda.empty_cache()
    results += check_fused_f32_kernels(randn32, H=8)
    torch.cuda.empty_cache()
    return results


def check_tracker_resize():
    """Phase 2, K3 at the fine tracker's site: every 16 x 16 x 32 patch
    feature of 5 frames x 1024 points upsampled to 31 x 31, fp32, no addend,
    against the plain version (an fp32 ulp, as the DPT site's fp32 store),
    bit-equal across chunkings, timed with every image in one chunk (the
    mapping before the image chunks) and with the chosen chunk, beside the
    plain version, ``F.interpolate`` and the bound. Inputs from a generator
    of their own."""
    import torch
    import torch.nn.functional as F

    from self_supervise_sfm_tpu_torch.ops import resize as RS

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    n, hw = NUM_FRAMES * 1024, (31, 31)
    x = torch.randn((n, 16, 16, 32), generator=gen, device="cuda")
    chunk = RS.image_chunk(n, *hw, 32)
    if not RS.resize_kernel_applicable(tuple(x.shape), hw) or chunk >= n:
        raise AssertionError(f"tracker site: gate or chunk ({chunk}) off the design")
    out = RS.resize_bilinear_fwd(x, hw)
    one = RS.resize_bilinear_fwd(x, hw, img_chunk=n)
    torch.cuda.synchronize()
    ref = RS.resize_bilinear_plain(x, hw)
    err = float((out - ref).abs().max())
    _check(f"resize_bilinear tracker site {tuple(x.shape)} -> {hw} fp32", err,
           1e-5 * float(ref.abs().max()))
    same = torch.equal(out, one)
    print(f"  resize_bilinear tracker site: chunk {chunk} ({-(-n // chunk)} chunks) bit-equal "
          f"to one chunk of {n} images: {same}")
    if not same:
        raise AssertionError("resize_bilinear: the chunked launch differs from one chunk")

    def library():
        return F.interpolate(x.permute(0, 3, 1, 2), size=hw, mode="bilinear",
                             align_corners=True)

    bound, by = _bound_ms(0.0, x.numel() * 4 + out.numel() * 4)
    site = dict(
        site="tracker", shape=list(x.shape), out_hw=list(hw), img_chunk=chunk,
        max_abs_err=err,
        ms=_time_ms(lambda: RS.resize_bilinear_fwd(x, hw)),
        one_chunk_ms=_time_ms(lambda: RS.resize_bilinear_fwd(x, hw, img_chunk=n)),
        plain_ms=_time_ms(lambda: RS.resize_bilinear_plain(x, hw), reps=5),
        library_ms=_time_ms(library),
        bound_ms=bound, bound_by=by,
        back_to_back_ms=_back_to_back_ms(lambda: RS.resize_bilinear_fwd(x, hw)),
        one_chunk_back_to_back_ms=_back_to_back_ms(
            lambda: RS.resize_bilinear_fwd(x, hw, img_chunk=n)),
        library_back_to_back_ms=_back_to_back_ms(library),
    )
    _site_line(f"resize_bilinear tracker site {tuple(x.shape)} -> {hw} fp32, chunk {chunk}",
               site)
    print(f"  resize_bilinear tracker site, one chunk of {n} images (the mapping before "
          f"the chunks): {site['one_chunk_ms']:.4f} ms a call, "
          f"{site['one_chunk_back_to_back_ms']:.4f} ms back to back; chunk {chunk}: "
          f"{site['ms']:.4f} / {site['back_to_back_ms']:.4f} ms; bound {bound:.4f} ms")
    return site


TRACK_FRAMES = 16  # the TrackHead's frames at 518 px (phase 8)


def check_track_head_resize():
    """Phase 2, K3 at the TrackHead's site: the DPT feature extractor's
    ``refinenet1`` upsample of 16 frames, (16, 148, 148, 128) -> 296 x 296
    fp32 with no addend (179.4 M output elements, over the gate's 2^27),
    against the plain version (an fp32 ulp), bit-equal across chunkings,
    timed beside the plain version, ``F.interpolate`` and the bound. Inputs
    from a generator of their own."""
    import torch
    import torch.nn.functional as F

    from self_supervise_sfm_tpu_torch.ops import resize as RS

    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    h = 4 * (IMG // 14)  # 148
    hw = (2 * h, 2 * h)
    x = torch.randn((TRACK_FRAMES, h, h, 128), generator=gen, device="cuda")
    chunk = RS.image_chunk(TRACK_FRAMES, *hw, 128)
    if not RS.resize_kernel_applicable(tuple(x.shape), hw):
        raise AssertionError("TrackHead site: the gate refuses the refinenet1 upsample")
    out = RS.resize_bilinear_fwd(x, hw)
    one = RS.resize_bilinear_fwd(x, hw, img_chunk=TRACK_FRAMES)
    split = RS.resize_bilinear_fwd(x, hw, img_chunk=1)
    torch.cuda.synchronize()
    ref = RS.resize_bilinear_plain(x, hw)
    err = float((out - ref).abs().max())
    _check(f"resize_bilinear TrackHead site {tuple(x.shape)} -> {hw} fp32", err,
           1e-5 * float(ref.abs().max()))
    same = torch.equal(out, one) and torch.equal(out, split)
    print(f"  resize_bilinear TrackHead site: chunk {chunk} of {TRACK_FRAMES} images; "
          f"bit-equal to one chunk and to one image a chunk: {same}")
    if not same:
        raise AssertionError("resize_bilinear: the TrackHead site differs across chunkings")
    del one, split, ref

    def library():
        return F.interpolate(x.permute(0, 3, 1, 2), size=hw, mode="bilinear",
                             align_corners=True)

    bound, by = _bound_ms(0.0, x.numel() * 4 + out.numel() * 4)
    site = dict(
        site="track_head", shape=list(x.shape), out_hw=list(hw), img_chunk=chunk,
        max_abs_err=err,
        ms=_time_ms(lambda: RS.resize_bilinear_fwd(x, hw)),
        plain_ms=_time_ms(lambda: RS.resize_bilinear_plain(x, hw), reps=3),
        library_ms=_time_ms(library),
        bound_ms=bound, bound_by=by,
        back_to_back_ms=_back_to_back_ms(lambda: RS.resize_bilinear_fwd(x, hw)),
        library_back_to_back_ms=_back_to_back_ms(library),
    )
    _site_line(f"resize_bilinear TrackHead site {tuple(x.shape)} -> {hw} fp32, chunk {chunk}",
               site)
    return site


def check_attention_edges(randn, ulps):
    """Phase 2, K1 / K2 / K2p at the edges of the Hopper body's tiling, held
    against their plain versions with the path shapes' tolerances: one q row
    and one key, a second warpgroup whose 64 rows all lie past nq, ragged q
    and key tiles, no context at all, two scenes each with its context, and
    K2p bit-equal to K2 on the split copies."""
    import torch

    from self_supervise_sfm_tpu_torch.ops import flash_attention as FA

    for bh, nq, nk in ((2, 1, 1), (3, 50, 70), (2, 130, 333), (1, 200, 128)):
        q, k, v = randn(bh, nq, 64), randn(bh, nk, 64), randn(bh, nk, 64)
        out, lse = FA.flash_fwd(q, k, v)
        torch.cuda.synchronize()
        p_out, p_lse = FA.flash_fwd_plain(q, k, v)
        _check(f"flash_fwd edge ({bh}, {nq}, {nk})",
               float((out.float() - p_out.float()).abs().max()), ulps(p_out, 4))
        _check(f"flash_fwd edge ({bh}, {nq}, {nk}) lse", float((lse - p_lse).abs().max()), 1e-4)
    for B, F, H, P, nc in ((2, 2, 2, 50, 0), (2, 2, 2, 130, 77), (1, 3, 2, 1, 300)):
        q, k, v = (randn(B * F, H, P, 64) for _ in range(3))
        ckv = randn(2, B, H, nc, 128)
        ck, cv = ckv[1, ..., :64].contiguous(), ckv[1, ..., 64:].contiguous()
        out = FA.frame_ctx_fwd(q, k, v, ck, cv)
        packed = FA.frame_ctx_packed_fwd(q, k, v, ckv, 1)
        torch.cuda.synchronize()
        ref = FA._frame_ctx_dense(q, k, v, ck, cv)
        _check(f"frame_ctx_fwd edge B{B} F{F} P{P} nc{nc}",
               float((out.float() - ref.float()).abs().max()), ulps(ref, 4))
        if not torch.equal(packed, out):
            raise AssertionError(f"frame_ctx_packed_fwd edge nc{nc}: not bit-equal to K2")
    print("  edges: frame_ctx_packed_fwd bit-equal to frame_ctx_fwd at each")


def _f32_tol(ref) -> float:
    """The fp32 entries' tolerance: 2e-5 at the largest |out|
    (``tests/test_torch_attention.py``'s fp32 tolerance against JAX)."""
    return 2e-5 * float(ref.abs().max())


def _f32_site(label, site, kernel, plain, library, flops, nbytes, lse=False):
    """One site of an fp32 entry: against its plain version (out within
    :func:`_f32_tol`, the lse within 1e-5), a repeat bit-equal, SDPA's
    error for the record, and the times beside the bound at the fp32 rate."""
    import torch

    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    out, ref_out = (got[0], ref[0]) if lse else (got, ref)
    err = float((out - ref_out).abs().max())
    _check(f"{label}[{site}] out", err, _f32_tol(ref_out))
    row = dict(site=site, shape=list(out.shape), max_abs_err=err)
    if lse:
        row["lse_err"] = float((got[1] - ref[1]).abs().max())
        _check(f"{label}[{site}] lse", row["lse_err"], 1e-5)
    again = kernel()
    same = (torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])) if lse else \
        torch.equal(again, got)
    if not same:
        raise AssertionError(f"{label}[{site}]: a repeat is not bit-equal")
    del got, again
    row["library_max_abs_err"] = float((library() - ref_out).abs().max())
    del ref, ref_out, out
    bound, by = _bound_ms(flops, nbytes, PEAK_F32_FLOPS)
    row.update(ms=_time_ms(kernel), plain_ms=_time_ms(plain, reps=3, warmup=1),
               library_ms=_time_ms(library), bound_ms=bound, bound_by=by,
               back_to_back_ms=_back_to_back_ms(kernel),
               library_back_to_back_ms=_back_to_back_ms(library))
    _site_line(f"{label}[{site}] fp32", row)
    print(f"    {label}[{site}]: repeat bit-equal; SDPA fp32 max error vs the plain version "
          f"{row['library_max_abs_err']:.3e} (for the record)")
    return row


def check_f32_kernels(randn, H=16, d=64):
    """Phase 2, the fp32 forms of K1, K2 and K2p (the FFMA body of
    ``csrc/flash_fwd_f32.cu``) at the main path's sites, in fp32 with TF32
    off: K1 at the ViT, frame and global sites, K2 at the reloc site, K2p at
    layers 0 and 23 of the 5-anchor cache and at layer 12 of a 20-anchor
    cache (bit-equal to K2 on the layer's split copies, the cache never
    written), each against its plain version (:func:`_f32_site`); then the
    edges of the tiling. Times beside the bound at the fp32 rate (67
    TFLOP/s), the plain version and, as a yardstick only,
    ``F.scaled_dot_product_attention`` in fp32 on the same inputs. ``H``
    heads of ``d``: 16 of 64, or 8 of 128 (the same width, so the same
    operations and bounds; the entries' names gain "_d128"). Returns the
    three entries of the kernel line."""
    import torch
    import torch.nn.functional as F

    from self_supervise_sfm_tpu_torch.ops import flash_attention as FA

    # the plain versions' fp32 matmuls in full fp32 (PyTorch's default, set
    # here as a reference must; restored at the end, a failure ends the run)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    depth = 24
    sfx = "_d128_f32" if d == 128 else "_f32"
    N = (IMG // 14) ** 2 + 5
    results = []

    # -- K1 fp32 at the ViT, frame and global sites ---------------------------
    sites = []
    for site, bh, n in (("vit", NUM_FRAMES * H, N), ("frame", 2 * NUM_FRAMES * H, N),
                        ("global", H, NUM_FRAMES * N)):
        q, k, v = (randn(bh, n, d) for _ in range(3))
        q4, k4, v4 = (t.view(1, bh, n, d) for t in (q, k, v))
        sites.append(_f32_site(
            f"flash_fwd{sfx}", site, lambda: FA.flash_fwd(q, k, v),
            lambda: FA.flash_fwd_plain(q, k, v),
            lambda: F.scaled_dot_product_attention(q4, k4, v4)[0],
            4.0 * bh * n * n * d, 4 * q.numel() * 4 + bh * n * 4, lse=True))
        del q, k, v, q4, k4, v4
        torch.cuda.empty_cache()
    results.append(dict(
        name=f"flash_fwd{sfx}", route="cuda", source=F32_SOURCE,
        replaces="self_supervise_sfm_tpu/ops/flash_attention.py:140",
        # one call at each of the three sites (one ViT + one aggregator layer)
        max_abs_err=max(s_["max_abs_err"] for s_ in sites),
        **{key: sum(s_[key] for s_ in sites)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
        bound_by=sites[-1]["bound_by"], sites=sites))

    # -- K2 fp32 at the reloc site ----------------------------------------------
    P, nc = N, NUM_FRAMES * (RANK + 5)
    q, k, v = (randn(NUM_FRAMES, H, P, d) for _ in range(3))
    ck, cv = randn(1, H, nc, d), randn(1, H, nc, d)
    kk = torch.cat([ck.expand(NUM_FRAMES, -1, -1, -1), k], dim=2)
    vv = torch.cat([cv.expand(NUM_FRAMES, -1, -1, -1), v], dim=2)
    row = _f32_site(f"frame_ctx_fwd{sfx}", "reloc", lambda: FA.frame_ctx_fwd(q, k, v, ck, cv),
                    lambda: FA._frame_ctx_dense(q, k, v, ck, cv),
                    lambda: F.scaled_dot_product_attention(q, kk, vv),
                    4.0 * NUM_FRAMES * H * P * (nc + P) * d,
                    (4 * q.numel() + 2 * ck.numel()) * 4)
    results.append(dict(
        name=f"frame_ctx_fwd{sfx}", route="cuda", source=F32_SOURCE,
        replaces="self_supervise_sfm_tpu/ops/flash_attention.py:539",
        **{key: row[key] for key in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                                     "bound_by")}, sites=[row]))
    del ck, cv, kk, vv

    # -- K2p fp32: the 5-anchor cache (first and last layer), 20 anchors ------
    def library(ckv, layer):
        c_k, c_v = ckv[layer, ..., :d], ckv[layer, ..., d:]
        return F.scaled_dot_product_attention(
            q, torch.cat([c_k.expand(NUM_FRAMES, -1, -1, -1), k], dim=2),
            torch.cat([c_v.expand(NUM_FRAMES, -1, -1, -1), v], dim=2))

    sites = []
    for anchors, layers in ((NUM_FRAMES, (0, depth - 1)), (4 * NUM_FRAMES, (depth // 2,))):
        nc = anchors * (RANK + 5)
        ckv = randn(depth, 1, H, nc, 2 * d)
        before = ckv.clone()
        for layer in layers:
            sites.append(_f32_site(
                f"frame_ctx_packed_fwd{sfx}", f"{anchors} anchors, layer {layer}",
                lambda: FA.frame_ctx_packed_fwd(q, k, v, ckv, layer),
                lambda: FA.frame_ctx_packed_plain(q, k, v, ckv, layer),
                lambda: library(ckv, layer),
                4.0 * NUM_FRAMES * H * P * (nc + P) * d,
                4 * q.numel() * 4 + H * nc * 2 * d * 4))
            k2 = FA.frame_ctx_fwd(q, k, v, ckv[layer, ..., :d].contiguous(),
                                  ckv[layer, ..., d:].contiguous())
            if not torch.equal(FA.frame_ctx_packed_fwd(q, k, v, ckv, layer), k2):
                raise AssertionError(f"frame_ctx_packed_fwd{sfx} layer {layer}: not "
                                     "bit-equal to K2 on the split copies")
        if not torch.equal(ckv, before):
            raise AssertionError(f"frame_ctx_packed_fwd{sfx} wrote to the cache")
        del ckv, before
        torch.cuda.empty_cache()
    print(f"  frame_ctx_packed_fwd{sfx}: bit-equal to frame_ctx_fwd{sfx} (K2) on the split "
          "copies, the cache unwritten")
    results.append(dict(
        name=f"frame_ctx_packed_fwd{sfx}", route="cuda", source=F32_SOURCE,
        replaces="self_supervise_sfm_tpu/ops/flash_attention.py:661",
        # one call at each site measured
        max_abs_err=max(s_["max_abs_err"] for s_ in sites),
        **{key: sum(s_[key] for s_ in sites)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
        bound_by=sites[0]["bound_by"], sites=sites))
    del q, k, v

    # -- the edges of the tiling: one q row and one key, ragged q rows and key
    # tiles, whole tiles, no context, a context of one key, two scenes ---------
    for bh, nq, nk in ((2, 1, 1), (3, 50, 70), (2, 130, 333), (1, 200, 128), (2, 64, 64)):
        q, k, v = randn(bh, nq, d), randn(bh, nk, d), randn(bh, nk, d)
        out, lse = FA.flash_fwd(q, k, v)
        torch.cuda.synchronize()
        p_out, p_lse = FA.flash_fwd_plain(q, k, v)
        _check(f"flash_fwd{sfx} edge ({bh}, {nq}, {nk})",
               float((out - p_out).abs().max()), _f32_tol(p_out))
        _check(f"flash_fwd{sfx} edge ({bh}, {nq}, {nk}) lse",
               float((lse - p_lse).abs().max()), 1e-5)
    for B, Fr, Hh, Pp, nce in ((2, 2, 2, 50, 0), (2, 2, 2, 130, 77), (1, 3, 2, 1, 1),
                               (1, 3, 2, 70, 1), (1, 3, 2, 1, 300)):
        q, k, v = (randn(B * Fr, Hh, Pp, d) for _ in range(3))
        ckv = randn(2, B, Hh, nce, 2 * d)
        c_k, c_v = ckv[1, ..., :d].contiguous(), ckv[1, ..., d:].contiguous()
        out = FA.frame_ctx_fwd(q, k, v, c_k, c_v)
        packed = FA.frame_ctx_packed_fwd(q, k, v, ckv, 1)
        torch.cuda.synchronize()
        ref = FA._frame_ctx_dense(q, k, v, c_k, c_v)
        _check(f"frame_ctx_fwd{sfx} edge B{B} F{Fr} P{Pp} nc{nce}",
               float((out - ref).abs().max()), _f32_tol(ref))
        if not torch.equal(packed, out):
            raise AssertionError(f"frame_ctx_packed_fwd{sfx} edge nc{nce}: not bit-equal to K2")
    print(f"  fp32 edges: frame_ctx_packed_fwd{sfx} bit-equal to frame_ctx_fwd{sfx} at each")
    for r in results:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"SDPA fp32 {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, fp32 rate)")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    return results


def check_f32_bwd_kernels(randn, H=16, d=64):
    """Phase 2, the fp32 forms of B9 (the FFMA backward body of
    ``csrc/flash_bwd_f32.cu``: dq and dk/dv, unmasked and under a RelocMask)
    and of K1m (``csrc/flash_fwd_f32.cu``), in fp32 with TF32 off. Inputs:
    random q, k, v and do, with o and lse from the fp32 forward kernels (K1,
    or K1m under a mask). First the edges of the tiling (ragged q and key
    tails, fewer keys than q rows, with and without dlse) and of the masked
    walks (no context, frame sizes no multiple of 64, one-row frames, one
    frame, whole 64-row segments; K1m there too, bit-equal to K2 fp32 on the
    unfolded tensors), then the train step's five sites and the masked ones
    at reloc layer 0 (16, 2748, 3358) and the 5-query shape (16, 6870,
    8395). Each backward is held against ``flash_bwd_plain`` in fp32 at 2e-5
    of the largest |gradient| of each output (:func:`_f32_tol`), a repeat
    bit-equal, and timed a call and 20 launches back to back beside the
    plain backward, the bound at the fp32 rate (dq 3 products, dk/dv 4, over
    the allowed pairs) and the yardstick ``torch.autograd.grad`` through
    fp32 SDPA after its forward (with the boolean mask at the masked sites),
    whose time the pair is divided by. K1m fp32 at the 5-query shape:
    against ``flash_fwd_plain`` with the mask (out :func:`_f32_tol`, lse
    1e-5), a repeat and K2 fp32 on the unfolded tensors bit-equal, timed
    beside SDPA with the boolean mask. ``H`` heads of ``d``: 16 of 64, or 8
    of 128 (the same operations and bounds; the entries' names gain "_d128",
    and the edges add 96 and 33 q rows: a ragged second q tile, one ragged
    tile).
    Returns the three entries of the kernel line."""
    import torch
    import torch.nn.functional as F

    from self_supervise_sfm_tpu_torch.ops import flash_attention as FA
    from self_supervise_sfm_tpu_torch.ops.mask_spec import RelocMask

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    S = TRAIN_FRAMES
    sfx = "_d128_f32" if d == 128 else "_f32"
    P = (IMG // 14) ** 2 + 5
    nc = S * (RANK + 5)
    nc5 = NUM_FRAMES * (RANK + 5)

    def hold(label, grads, refs):
        errs = []
        for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
            errs.append(float((g - r).abs().max()))
            _check(f"{label} {name}", errs[-1], _f32_tol(r))
        return errs

    def k2_unfolded(q, k, v, mask):
        """K2 fp32 on a K1m problem's unfolded tensors: q and the own keys
        (BH F, 1, P, 64), the context (BH, 1, n_ctx, 64) of each frame's
        scene."""
        bh, nf, fs, n = q.shape[0], mask.num_frames, mask.frame_size, mask.n_ctx

        def own(t):
            return t[:, n:].reshape(bh * nf, 1, fs, d).contiguous()

        def ctx(t):
            return t[:, :n].reshape(bh, 1, n, d).contiguous()

        return FA.frame_ctx_fwd(q.view(bh * nf, 1, fs, d), own(k), own(v), ctx(k),
                                ctx(v)).view(q.shape)

    # -- the edges of the tiling and of the masked walks -----------------------
    edges = [(2, 1, 3, False), (3, 130, 77, True), (2, 257, 130, False), (1, 200, 333, True),
             (2, 64, 64, False)]
    if d == 128:
        edges += [(2, 96, 33, True), (1, 33, 97, False)]
    for bh, nq, nk, with_dlse in edges:
        q, do, k, v = randn(bh, nq, d), randn(bh, nq, d), randn(bh, nk, d), randn(bh, nk, d)
        o, lse = FA.flash_fwd(q, k, v)
        dlse = randn(bh, nq) if with_dlse else None
        grads = FA.flash_bwd(q, k, v, o, lse, do, dlse)
        torch.cuda.synchronize()
        hold(f"flash_bwd{sfx} edge ({bh}, {nq}, {nk}){' dlse' if with_dlse else ''}", grads,
             FA.flash_bwd_plain(q, k, v, o, lse, do, dlse))
    for n_ctx, fs, nf in ((77, 130, 2), (0, 130, 3), (5, 1, 7), (64, 64, 2), (98, 257, 2),
                          (77, 130, 1)):
        mask = RelocMask(n_ctx, fs, nf)
        q, k, v = randn(2, mask.nq, d), randn(2, mask.nk, d), randn(2, mask.nk, d)
        o, lse = FA.flash_fwd_reloc(q, k, v, mask)
        torch.cuda.synchronize()
        p_o, p_lse = FA.flash_fwd_plain(q, k, v, mask)
        _check(f"flash_fwd_reloc{sfx} edge {mask} out", float((o - p_o).abs().max()),
               _f32_tol(p_o))
        _check(f"flash_fwd_reloc{sfx} edge {mask} lse", float((lse - p_lse).abs().max()), 1e-5)
        if not torch.equal(o, k2_unfolded(q, k, v, mask)):
            raise AssertionError(f"flash_fwd_reloc{sfx} edge {mask}: not bit-equal to K2 fp32")
        for with_dlse in (False, True):
            do = randn(2, mask.nq, d)
            dlse = randn(2, mask.nq) if with_dlse else None
            grads = FA.flash_bwd(q, k, v, o, lse, do, dlse, mask)
            torch.cuda.synchronize()
            hold(f"flash_bwd{sfx} edge {mask}{' dlse' if with_dlse else ''}", grads,
                 FA.flash_bwd_plain(q, k, v, o, lse, do, dlse, mask))
    print(f"  fp32 edges: flash_fwd_reloc{sfx} (K1m) bit-equal to frame_ctx_fwd{sfx} (K2) on "
          "the unfolded tensors at each")

    # -- the train step's sites and the masked ones ----------------------------
    # (name, BH, Nq, Nk, with an lse cotangent, mask)
    sites = [("vit", S * H, P, P, False, None),
             ("frame", 2 * S * H, P, P, False, None),
             ("global", H, S * P, S * P, False, None),
             ("split own", S * H, P, P, True, None),
             ("split context", S * H, P, nc, True, None),
             ("reloc layer 0, RelocMask", H, S * P, nc + S * P, False, RelocMask(nc, P, S)),
             ("reloc 5 queries, RelocMask", H, NUM_FRAMES * P, nc5 + NUM_FRAMES * P, False,
              RelocMask(nc5, P, NUM_FRAMES))]
    rows = {f"flash_bwd_dq{sfx}": [], f"flash_bwd_dkv{sfx}": []}
    for site, bh, nq, nk, with_dlse, mask in sites:
        q, do = randn(bh, nq, d), randn(bh, nq, d)
        k, v = randn(bh, nk, d), randn(bh, nk, d)
        o, lse = FA.flash_fwd(q, k, v) if mask is None else FA.flash_fwd_reloc(q, k, v, mask)
        dlse = randn(bh, nq) if with_dlse else None
        grads = FA.flash_bwd(q, k, v, o, lse, do, dlse, mask)
        torch.cuda.synchronize()
        refs = FA.flash_bwd_plain(q, k, v, o, lse, do, dlse, mask)
        errs = dict(zip(("dq", "dk", "dv"), hold(f"flash_bwd{sfx}[{site}]", grads, refs)))
        del refs
        again = FA.flash_bwd(q, k, v, o, lse, do, dlse, mask)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f"flash_bwd{sfx}[{site}]: a second backward is not bit-equal")
        del again, grads
        delta = FA._delta(o, do, dlse).contiguous()
        # allowed pairs a head
        pairs = nq * nk if mask is None else nq * (mask.n_ctx + mask.frame_size)
        io = (2 * q.numel() + 2 * k.numel()) * 4 + 2 * lse.numel() * 4
        qm, km, vm = (t.view(1, bh, -1, d).detach().requires_grad_() for t in (q, k, v))
        attn_mask = None if mask is None else mask.materialize("cuda")
        out = F.scaled_dot_product_attention(qm, km, vm, attn_mask=attn_mask)
        dom = do.view(out.shape)
        sdpa_bwd = lambda: torch.autograd.grad(out, (qm, km, vm), dom,  # noqa: E731
                                               retain_graph=True)
        plain = _time_ms(lambda: FA.flash_bwd_plain(q, k, v, o, lse, do, dlse, mask),
                         reps=3, warmup=1)
        common = dict(site=site, shape=[bh, nq, nk, d], plain_ms=plain,
                      library_ms=_time_ms(sdpa_bwd),
                      library_back_to_back_ms=_back_to_back_ms(sdpa_bwd),
                      masked=mask is not None, repeat_bit_equal=True)
        dq_fn = lambda: FA.flash_bwd_dq(q, k, v, do, lse, delta, mask)  # noqa: E731
        dkv_fn = lambda: FA.flash_bwd_dkv(q, k, v, do, lse, delta, mask)  # noqa: E731
        b_dq, by_dq = _bound_ms(3 * 2.0 * bh * pairs * d, io + q.numel() * 4, PEAK_F32_FLOPS)
        rows[f"flash_bwd_dq{sfx}"].append(dict(
            common, max_abs_err=errs["dq"], bound_ms=b_dq, bound_by=by_dq,
            ms=_time_ms(dq_fn), back_to_back_ms=_back_to_back_ms(dq_fn)))
        b_kv, by_kv = _bound_ms(4 * 2.0 * bh * pairs * d, io + 2 * k.numel() * 4,
                                PEAK_F32_FLOPS)
        rows[f"flash_bwd_dkv{sfx}"].append(dict(
            common, max_abs_err=max(errs["dk"], errs["dv"]), bound_ms=b_kv, bound_by=by_kv,
            ms=_time_ms(dkv_fn), back_to_back_ms=_back_to_back_ms(dkv_fn)))
        del q, k, v, do, o, lse, out, qm, km, vm, attn_mask, delta
        torch.cuda.empty_cache()
    results = []
    for name, line in ((f"flash_bwd_dq{sfx}", 332), (f"flash_bwd_dkv{sfx}", 349)):
        ss = rows[name]
        for s_ in ss:
            print(f"  {name}[{s_['site']}] {s_['shape']}: kernel {s_['ms']:.4f} ms, b2b "
                  f"{s_['back_to_back_ms']:.4f} ms, bound {s_['bound_ms']:.4f} ms "
                  f"({s_['bound_by']}, {s_['bound_ms'] / s_['back_to_back_ms']:.3f} of it b2b, "
                  f"{s_['bound_ms'] / s_['back_to_back_ms'] * PEAK_F32_FLOPS / 1e12:.1f} "
                  f"TFLOP/s), plain backward {s_['plain_ms']:.4f} ms; a repeat bit-equal")
        path = [s_ for s_ in ss if not s_["masked"]]
        results.append(dict(
            name=name, route="cuda", source=F32_BWD_SOURCE,
            # the RelocMask form, the same body
            masked_source=F32_BWD_SOURCE,
            replaces=f"self_supervise_sfm_tpu/ops/flash_attention.py:{line}",
            # one call at each unmasked site of the train step; plain_ms and
            # library_ms compute all three gradients
            max_abs_err=max(s_["max_abs_err"] for s_ in ss),
            **{k: sum(s_[k] for s_ in path)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            bound_by=path[-1]["bound_by"], sites=ss))
    for a, b in zip(rows[f"flash_bwd_dq{sfx}"], rows[f"flash_bwd_dkv{sfx}"]):
        call, b2b = a["ms"] + b["ms"], a["back_to_back_ms"] + b["back_to_back_ms"]
        print(f"  flash_bwd{sfx} pair[{a['site']}]: {call:.4f} ms a call, {b2b:.4f} ms b2b; "
              f"SDPA fp32 backward {a['library_ms']:.4f} / {a['library_back_to_back_ms']:.4f} "
              f"ms; pair / SDPA {call / a['library_ms']:.2f} a call, "
              f"{b2b / a['library_back_to_back_ms']:.2f} b2b")

    # -- K1m fp32 at the 5-query shape -------------------------------------------
    mask = RelocMask(nc5, P, NUM_FRAMES)
    q, k, v = randn(H, mask.nq, d), randn(H, mask.nk, d), randn(H, mask.nk, d)
    out, lse = FA.flash_fwd_reloc(q, k, v, mask)
    torch.cuda.synchronize()
    p_out, p_lse = FA.flash_fwd_plain(q, k, v, mask)
    err = float((out - p_out).abs().max())
    _check(f"flash_fwd_reloc{sfx} out {tuple(q.shape)} x {tuple(k.shape)} {mask}", err,
           _f32_tol(p_out))
    lse_err = float((lse - p_lse).abs().max())
    _check(f"flash_fwd_reloc{sfx} lse", lse_err, 1e-5)
    del p_out, p_lse
    again = FA.flash_fwd_reloc(q, k, v, mask)
    layout = k2_unfolded(q, k, v, mask)
    torch.cuda.synchronize()
    if not (torch.equal(again[0], out) and torch.equal(again[1], lse)):
        raise AssertionError(f"flash_fwd_reloc{sfx}: a repeat is not bit-equal")
    if not torch.equal(layout, out):
        raise AssertionError(f"flash_fwd_reloc{sfx}: not bit-equal to K2 fp32 on the unfolded "
                             "tensors")
    print(f"  flash_fwd_reloc{sfx} (K1m): a repeat bit-equal; bit-equal to frame_ctx_fwd{sfx} "
          "(K2) on the unfolded tensors")
    del again, layout
    qm, km, vm = (t.view(1, H, -1, d) for t in (q, k, v))
    dense_mask = mask.materialize("cuda")
    bound, by = _bound_ms(4.0 * H * mask.nq * (nc5 + P) * d,
                          (2 * q.numel() + 2 * k.numel()) * 4 + lse.numel() * 4,
                          PEAK_F32_FLOPS)
    kernel = lambda: FA.flash_fwd_reloc(q, k, v, mask)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(qm, km, vm, attn_mask=dense_mask)  # noqa: E731
    r = dict(
        name=f"flash_fwd_reloc{sfx}", route="cuda", source=F32_SOURCE,
        replaces="self_supervise_sfm_tpu/ops/flash_attention.py:140",
        variant="mask=RelocMask", max_abs_err=err, lse_err=lse_err, shape=list(q.shape),
        ms=_time_ms(kernel),
        plain_ms=_time_ms(lambda: FA.flash_fwd_plain(q, k, v, mask), reps=3, warmup=1),
        # fp32 SDPA with the materialised boolean mask
        library_ms=_time_ms(library),
        bound_ms=bound, bound_by=by,
        back_to_back_ms=_back_to_back_ms(kernel),
        library_back_to_back_ms=_back_to_back_ms(library))
    _site_line(f"flash_fwd_reloc{sfx} {tuple(q.shape)} x {tuple(k.shape)} {mask}", r)
    results.append(r)
    del q, k, v, qm, km, vm, out, lse, dense_mask
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = tf32
    return results


def check_fused_kernels(randn, ulps, C=1024, H=16, frames=NUM_FRAMES, sites=None,
                        qkv_only=("reloc",), mlp=True):
    """Phase 2, the five fused block kernels at the ViT, frame, reloc and
    global sites (phase 8: at the widths ``C`` / ``H`` of the other ViTs and
    their ``sites``; a site in ``qkv_only`` times the LN+QKV kernel alone,
    the other kernels seeing its shape at another site). At a head dim of
    128 (``C / H``) the three kernels with a head dim are their ``_d128``
    forms, named so in the results; ``mlp=False`` leaves out the MLP pair,
    which has no head dim.
    bf16 outputs: kernel and plain version sum in other orders,
    so a layer-normed operand or a result may round to the neighbouring
    bf16 value; the tolerance is 2 ulps at the largest output, and 4 for
    q / k, where the qk-norm and the two RoPE products each round again.
    The library chain is the unfused block code (fp32 ``F.layer_norm``, cuBLAS
    matmul, chunk / transpose, ``F.gelu``, elementwise RoPE and residual)."""
    import torch

    from self_supervise_sfm_tpu_torch.layers import attention as AT
    from self_supervise_sfm_tpu_torch.layers import params as P
    from self_supervise_sfm_tpu_torch.models import aggregator as AG
    from self_supervise_sfm_tpu_torch.ops import fused_qkv as FQ

    d, Ch = C // H, 4 * C
    sfx = "_d128" if d == 128 else ""
    N = (IMG // 14) ** 2 + 5
    f32 = torch.float32
    bf16 = torch.bfloat16
    norm = lambda n: {"scale": 1 + 0.1 * randn(n, dtype=f32),  # noqa: E731
                      "bias": 0.1 * randn(n, dtype=f32)}
    lin = lambda i, o: {"w": (randn(i, o, dtype=f32) * i**-0.5).to(bf16),  # noqa: E731
                        "b": 0.1 * randn(o, dtype=f32)}
    p = {"norm1": norm(C), "norm2": norm(C),
         "attn": {"qkv": lin(C, 3 * C), "proj": lin(C, C), "q_norm": norm(d),
                  "k_norm": norm(d)},
         "mlp": {"fc1": lin(C, Ch), "fc2": lin(Ch, C)},
         "ls1": {"gamma": randn(C, dtype=f32)}, "ls2": {"gamma": randn(C, dtype=f32)}}
    # the frame's rope tables at the head dim d
    acfg = AG.AggregatorConfig(embed_dim=C, num_heads=H)
    t_frame = AG._rope_tables_frame(acfg, IMG // 14, IMG // 14, "cuda")
    attn_cfg = AT.AttentionConfig(dim=C, num_heads=H, qk_norm=True, ln_eps=1e-5)
    vit_cfg = AT.AttentionConfig(dim=C, num_heads=H, qk_norm=False, ln_eps=1e-6)
    n1, n2, at, ml = p["norm1"], p["norm2"], p["attn"], p["mlp"]
    qn, kn = at["q_norm"], at["k_norm"]
    t_global = AG._tile_tables(t_frame, frames)
    sites = sites or {"vit": (frames, N, None), "frame": (2 * frames, N, t_frame),
                      "reloc": (frames, N, t_frame), "global": (1, frames * N, t_global)}
    sites = {k: (b, n, t_frame if tabs == "frame" else tabs)
             for k, (b, n, tabs) in sites.items()}

    # the MLP kernels' GEMM body alone, fp32 accumulators against an fp32
    # matmul of the same bf16 operands: one tile of one K slice (the weight
    # read MN-major through the transposed-B bit, two 64-column atoms), then
    # ragged rows, several tiles and a K loop through the whole ring. Sums in
    # other orders: tolerance 1e-4 sqrt(K), far below a misplaced operand.
    # Inputs from a generator of their own, so that the other inputs of
    # this phase and the weights of phase 3 stay what they were
    probe = torch.Generator(device="cuda").manual_seed(SEED + 9)
    for rows, kk, cols in ((128, 64, 128), (300, 1024, 384)) if C == 1024 and d == 64 else ():
        a = torch.randn((rows, kk), generator=probe, device="cuda").to(bf16)
        w = (torch.randn((kk, cols), generator=probe, device="cuda") * kk**-0.5).to(bf16)
        got = FQ.gemm_probe(a, w)
        torch.cuda.synchronize()
        ref = torch.matmul(a.float(), w.float())
        _check(f"gemm_probe ({rows} x {kk}) @ ({kk} x {cols})",
               float((got - ref).abs().max()), 1e-4 * kk**0.5)
        del a, w, got, ref

    def measure(name, site, outs, refs, tol_ulps, flops, tensors_in, fns):
        """One kernel at one site: check, bound, and the timings: per call
        and 20 launches back to back, beside the library chain's."""
        torch.cuda.synchronize()
        err = 0.0
        for o, r, label in zip(outs, refs, ("q", "k", "v") if len(outs) == 3 else ("y",)):
            e = float((o.float() - r.float()).abs().max())
            _check(f"{name}[{site}] {label} {tuple(o.shape)}", e,
                   ulps(r, tol_ulps[label]))
            err = max(err, e)
        in_bytes = sum(t.numel() * t.element_size() for t in tensors_in)
        out_bytes = sum(o.numel() * o.element_size() for o in outs)
        bound, by = _bound_ms(flops, in_bytes + out_bytes)
        kernel, plain, library = fns
        return dict(site=site, shape=list(tensors_in[0].shape), max_abs_err=err,
                    ms=_time_ms(kernel), plain_ms=_time_ms(plain, reps=5),
                    library_ms=_time_ms(library), bound_ms=bound, bound_by=by,
                    back_to_back_ms=_back_to_back_ms(kernel),
                    library_back_to_back_ms=_back_to_back_ms(library),
                    input_mb=in_bytes / 1e6, inputs_fit_l2=in_bytes <= 50e6)

    def prepass(name, site, x, norm, eps):
        """The layer-norm pre-pass of a kernel alone (inside its time above):
        hn against the plain version's rows, 2 ulps at the largest; timed."""
        M = x.shape[0] * x.shape[1]
        hn = torch.empty((M, C), dtype=bf16, device="cuda")
        FQ._ln_rows_into(hn, x, norm["scale"], norm["bias"], eps)
        torch.cuda.synchronize()
        hn_ref = FQ._ln_rows(x.float(), norm["scale"], norm["bias"], eps).to(bf16).view(M, C)
        e_hn = float((hn.float() - hn_ref.float()).abs().max())
        _check(f"{name}[{site}] layer-norm pre-pass hn {tuple(hn.shape)}", e_hn,
               ulps(hn_ref, 2))
        pre = lambda: FQ._ln_rows_into(hn, x, norm["scale"], norm["bias"], eps)  # noqa: E731
        per_kernel[name][-1].update(
            prepass_max_abs_err=e_hn, prepass_ms=_time_ms(pre),
            prepass_back_to_back_ms=_back_to_back_ms(pre))

    per_kernel = {k: [] for k in ("fused_ln_qkv_rope", "fused_ln_qkv", "fused_proj_residual",
                                  "fused_mlp_up", "fused_mlp_down")[:5 if mlp else 3]}
    for site, (B, n, tabs) in sites.items():
        M = B * n
        x = randn(B, n, C)
        # -- LN + QKV (+ qk-norm + RoPE) -> q, k, v (B, H, n, 64)
        if tabs is None:
            args = (x, n1["scale"], n1["bias"], at["qkv"]["w"], at["qkv"]["b"], H, 1e-6)
            kern, plain, name = FQ.fused_ln_qkv_fwd, FQ.fused_ln_qkv_plain, "fused_ln_qkv"
            chain = lambda: tuple(t.contiguous() for t in AT.qkv_heads(  # noqa: E731
                at, P.layer_norm(n1, x, 1e-6), vit_cfg))
            ins = [x, at["qkv"]["w"], at["qkv"]["b"], n1["scale"], n1["bias"]]
            tol = {"q": 2, "k": 2, "v": 2}
        else:
            args = (x, n1["scale"], n1["bias"], at["qkv"]["w"], at["qkv"]["b"],
                    qn["scale"], qn["bias"], kn["scale"], kn["bias"], *tabs, H, 1e-5)
            kern, plain = FQ.fused_ln_qkv_rope_fwd, FQ.fused_ln_qkv_rope_plain
            name = "fused_ln_qkv_rope"
            chain = lambda: tuple(t.contiguous() for t in AT.qkv_heads(  # noqa: E731
                at, P.layer_norm(n1, x, 1e-5), attn_cfg, tabs))
            ins = [x, at["qkv"]["w"], at["qkv"]["b"], n1["scale"], n1["bias"],
                   qn["scale"], qn["bias"], kn["scale"], kn["bias"], *tabs]
            tol = {"q": 4, "k": 4, "v": 2}
        per_kernel[name].append(measure(
            name, site, kern(*args), plain(*args), tol, 2.0 * M * C * 3 * C, ins,
            (lambda: kern(*args), lambda: plain(*args), chain)))
        prepass(name, site, x, n1, args[-1])
        if site in qkv_only:
            continue  # the other three kernels see this shape at another site
        # -- head merge + out-proj + layer-scale + residual
        o = randn(B, H, n, d)
        pargs = (o, x, at["proj"]["w"], at["proj"]["b"], p["ls1"]["gamma"])
        per_kernel["fused_proj_residual"].append(measure(
            "fused_proj_residual", site, [FQ.fused_proj_residual_fwd(*pargs)],
            [FQ.fused_proj_residual_plain(*pargs)], {"y": 2}, 2.0 * M * C * C, list(pargs),
            (lambda: FQ.fused_proj_residual_fwd(*pargs),
             lambda: FQ.fused_proj_residual_plain(*pargs),
             lambda: x + P.layer_scale(p["ls1"], P.linear(at["proj"], AT._merge_heads(o))))))
        if not mlp:
            del x, o
            torch.cuda.empty_cache()
            continue
        # -- MLP up: LN2 + fc1 + GELU -> hidden
        uargs = (x, n2["scale"], n2["bias"], ml["fc1"]["w"], ml["fc1"]["b"], 1e-5)
        h = FQ.fused_mlp_up(*uargs)
        per_kernel["fused_mlp_up"].append(measure(
            "fused_mlp_up", site, [h], [FQ.fused_mlp_up_plain(*uargs)], {"y": 2},
            2.0 * M * C * Ch, list(uargs[:5]),
            (lambda: FQ.fused_mlp_up(*uargs), lambda: FQ.fused_mlp_up_plain(*uargs),
             lambda: P.gelu(P.linear(ml["fc1"], P.layer_norm(n2, x, 1e-5))))))
        prepass("fused_mlp_up", site, x, n2, 1e-5)
        # -- MLP down: fc2 + layer-scale + residual, on the up kernel's hidden
        dargs = (h, x, ml["fc2"]["w"], ml["fc2"]["b"], p["ls2"]["gamma"])
        per_kernel["fused_mlp_down"].append(measure(
            "fused_mlp_down", site, [FQ.fused_mlp_down(*dargs)],
            [FQ.fused_mlp_down_plain(*dargs)], {"y": 2}, 2.0 * M * Ch * C, list(dargs),
            (lambda: FQ.fused_mlp_down(*dargs), lambda: FQ.fused_mlp_down_plain(*dargs),
             lambda: x + P.layer_scale(p["ls2"], P.linear(ml["fc2"], h)))))
        del x, o, h
        torch.cuda.empty_cache()

    lines = {"fused_ln_qkv_rope": 158, "fused_ln_qkv": 309, "fused_proj_residual": 411,
             "fused_mlp_up": 526, "fused_mlp_down": 546}
    results = []
    for name, ss in per_kernel.items():
        label = name + (sfx if name in D128_KERNELS else "")
        for s_ in ss:
            print(f"  {label}[{s_['site']}]: kernel {s_['ms']:.4f} ms, plain "
                  f"{s_['plain_ms']:.4f} ms, library chain {s_['library_ms']:.4f} ms, "
                  f"bound {s_['bound_ms']:.4f} ms ({s_['bound_by']}), "
                  f"roofline share {s_['bound_ms'] / s_['ms']:.3f}, "
                  f"inputs {s_['input_mb']:.1f} MB "
                  f"({'fit' if s_['inputs_fit_l2'] else 'exceed'} the 50 MB L2); "
                  f"back to back kernel {s_['back_to_back_ms']:.4f} ms, library chain "
                  f"{s_['library_back_to_back_ms']:.4f} ms "
                  f"({s_['back_to_back_ms'] / s_['library_back_to_back_ms']:.2f}x), "
                  f"{s_['bound_ms'] / s_['back_to_back_ms'] * PEAK_BF16_FLOPS / 1e12:.0f} "
                  f"TFLOP/s")
            if "prepass_ms" in s_:
                print(f"  {label}[{s_['site']}] layer-norm pre-pass alone: "
                      f"{s_['prepass_ms']:.4f} ms a call, {s_['prepass_back_to_back_ms']:.4f} "
                      f"ms back to back")
        results.append(dict(
            name=label, route="cuda", source=GEMM_SOURCE,
            replaces=f"self_supervise_sfm_tpu/ops/fused_qkv.py:{lines[name]}",
            # one call at each site measured
            max_abs_err=max(s_["max_abs_err"] for s_ in ss),
            **{k: sum(s_[k] for s_ in ss)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            bound_by=ss[-1]["bound_by"], sites=ss,
        ))
    return results


def check_fused_f32_kernels(randn, H=16):
    """Phase 2, the fp32 forms of the five fused block kernels (the FFMA GEMM
    body of ``csrc/gemm_f32.cu``) at the ViT, frame, reloc and global sites,
    in fp32 with TF32 off: each output against its plain version within 2e-5
    of its largest |value| (:func:`_f32_tol`), a repeat bit-equal, the
    layer-norm pre-pass alone; times per call and 20 launches back to back
    beside the bound at the fp32 rate (67 TFLOP/s), the plain version and the
    fp32 chain of library calls it replaces (the unfused block code:
    ``F.layer_norm``, cuBLAS SGEMM, chunk / transpose, ``F.gelu``,
    elementwise RoPE and residual). Then the edges of the tiling at C = 256
    (rows no multiple of the 128-row tile, a tile across a frame boundary,
    one row, a zero row) and the head-shard weight (C, 3 Hl d) at Hl = H /
    2. ``H=8``: head dim 128, the three kernels with a head dim alone on
    their ``_d128_f32`` entries (LN+QKV+RoPE at the frame, reloc and global
    sites, LN+QKV at the ViT site, the out-projection at all four; o (B, 8,
    N, 128)), the edges at C = 256 (2 heads of 128) and an odd head count, C
    = 384 (3 heads), the head shard at Hl = 4 of 8. Returns the kernels'
    entries of the kernel line."""
    import torch

    from self_supervise_sfm_tpu_torch.layers import attention as AT
    from self_supervise_sfm_tpu_torch.layers import params as P
    from self_supervise_sfm_tpu_torch.models import aggregator as AG
    from self_supervise_sfm_tpu_torch.ops import fused_qkv as FQ

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False

    def block_params(C, d=64):
        norm = lambda n: {"scale": 1 + 0.1 * randn(n), "bias": 0.1 * randn(n)}  # noqa: E731
        lin = lambda i, o: {"w": randn(i, o) * i**-0.5, "b": 0.1 * randn(o)}  # noqa: E731
        return {"norm1": norm(C), "norm2": norm(C),
                "attn": {"qkv": lin(C, 3 * C), "proj": lin(C, C), "q_norm": norm(d),
                         "k_norm": norm(d)},
                "mlp": {"fc1": lin(C, 4 * C), "fc2": lin(4 * C, C)},
                "ls1": {"gamma": randn(C)}, "ls2": {"gamma": randn(C)}}

    def calls(p, x, H, tabs, eps, o, w_qkv=None, b_qkv=None):
        """(name, kernel, plain, library chain, FLOPs, inputs) of the five
        kernels on x (B, N, C) and o (B, H, N, d), d = C / H."""
        B, N, C = x.shape
        n1, n2, at, ml = p["norm1"], p["norm2"], p["attn"], p["mlp"]
        qn, kn = at["q_norm"], at["k_norm"]
        w_qkv = at["qkv"]["w"] if w_qkv is None else w_qkv
        b_qkv = at["qkv"]["b"] if b_qkv is None else b_qkv
        hl = w_qkv.shape[1] // (3 * (C // H))
        M = B * N
        if tabs is None:
            qargs = (x, n1["scale"], n1["bias"], w_qkv, b_qkv, hl, eps)
            name, kern, plain = "fused_ln_qkv", FQ.fused_ln_qkv_fwd, FQ.fused_ln_qkv_plain
            cfg = AT.AttentionConfig(dim=C, num_heads=H, qk_norm=False, ln_eps=eps)
            ins = [x, w_qkv, b_qkv, n1["scale"], n1["bias"]]
        else:
            qargs = (x, n1["scale"], n1["bias"], w_qkv, b_qkv, qn["scale"], qn["bias"],
                     kn["scale"], kn["bias"], *tabs, hl, eps)
            name, kern = "fused_ln_qkv_rope", FQ.fused_ln_qkv_rope_fwd
            plain = FQ.fused_ln_qkv_rope_plain
            cfg = AT.AttentionConfig(dim=C, num_heads=H, qk_norm=True, ln_eps=eps)
            ins = [x, w_qkv, b_qkv, n1["scale"], n1["bias"], qn["scale"], qn["bias"],
                   kn["scale"], kn["bias"], *tabs]
        chain_p = {**at, "qkv": {"w": w_qkv, "b": b_qkv}}
        out = [(name, lambda: kern(*qargs), lambda: plain(*qargs),
                lambda: tuple(t.contiguous() for t in AT.qkv_heads(
                    chain_p, P.layer_norm(n1, x, eps), cfg, tabs)),
                2.0 * M * C * w_qkv.shape[1], ins)]
        if hl != H:
            return out  # the head shard: LN+QKV(+RoPE) alone
        pargs = (o, x, at["proj"]["w"], at["proj"]["b"], p["ls1"]["gamma"])
        uargs = (x, n2["scale"], n2["bias"], ml["fc1"]["w"], ml["fc1"]["b"], eps)
        h = FQ.fused_mlp_up_plain(*uargs)
        dargs = (h, x, ml["fc2"]["w"], ml["fc2"]["b"], p["ls2"]["gamma"])
        out += [
            ("fused_proj_residual", lambda: FQ.fused_proj_residual_fwd(*pargs),
             lambda: FQ.fused_proj_residual_plain(*pargs),
             lambda: x + P.layer_scale(p["ls1"], P.linear(at["proj"], AT._merge_heads(o))),
             2.0 * M * C * C, list(pargs)),
            ("fused_mlp_up", lambda: FQ.fused_mlp_up(*uargs),
             lambda: FQ.fused_mlp_up_plain(*uargs),
             lambda: P.gelu(P.linear(ml["fc1"], P.layer_norm(n2, x, eps))),
             2.0 * M * C * 4 * C, list(uargs[:5])),
            # on the plain version's hidden: the two halves held apart
            ("fused_mlp_down", lambda: FQ.fused_mlp_down(*dargs),
             lambda: FQ.fused_mlp_down_plain(*dargs),
             lambda: x + P.layer_scale(p["ls2"], P.linear(ml["fc2"], h)),
             2.0 * M * 4 * C * C, list(dargs)),
        ]
        return out

    def hold(name, site, kern, plain):
        """Every output within 2e-5 of its largest |value|, a repeat
        bit-equal; returns the largest error."""
        got = kern()
        torch.cuda.synchronize()
        ref = plain()
        got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
        err = 0.0
        for g, r, label in zip(got, ref, ("q", "k", "v") if len(got) == 3 else ("y",)):
            e = float((g - r).abs().max())
            _check(f"{name} fp32[{site}] {label} {tuple(g.shape)}", e, _f32_tol(r))
            err = max(err, e)
        again = kern()
        again = again if isinstance(again, tuple) else (again,)
        if not all(torch.equal(a, g) for a, g in zip(again, got)):
            raise AssertionError(f"{name} fp32[{site}]: a repeat is not bit-equal")
        return err, got

    C = 1024
    d = C // H
    hd = "_d128" if d == 128 else ""  # the head dim's part of the names
    sfx = hd + "_f32"
    N = (IMG // 14) ** 2 + 5
    p = block_params(C, d)
    t_frame = AG._rope_tables_frame(AG.AggregatorConfig(embed_dim=C, num_heads=H), IMG // 14,
                                    IMG // 14, "cuda")
    t_global = AG._tile_tables(t_frame, NUM_FRAMES)
    # at head dim 128 the kernels with a head dim alone (the MLP pair has none)
    per_kernel = {k: [] for k in (FUSED_BLOCK_KERNELS[:3] if d == 128 else FUSED_BLOCK_KERNELS)}
    for site, (B, n, tabs, eps) in {"vit": (NUM_FRAMES, N, None, 1e-6),
                                     "frame": (2 * NUM_FRAMES, N, t_frame, 1e-5),
                                     "reloc": (NUM_FRAMES, N, t_frame, 1e-5),
                                     "global": (1, NUM_FRAMES * N, t_global, 1e-5)}.items():
        x, o = randn(B, n, C), randn(B, H, n, d)
        for name, kern, plain, chain, flops, ins in calls(p, x, H, tabs, eps, o):
            if name not in per_kernel:
                continue
            err, got = hold(name + hd, site, kern, plain)
            in_bytes = sum(t.numel() * 4 for t in ins)
            out_bytes = sum(g.numel() * 4 for g in got)
            bound, by = _bound_ms(flops, in_bytes + out_bytes, PEAK_F32_FLOPS)
            del got
            row = dict(site=site, shape=list(x.shape), max_abs_err=err,
                       ms=_time_ms(kern), plain_ms=_time_ms(plain, reps=3, warmup=1),
                       library_ms=_time_ms(chain), bound_ms=bound, bound_by=by,
                       back_to_back_ms=_back_to_back_ms(kern),
                       library_back_to_back_ms=_back_to_back_ms(chain))
            if name != "fused_proj_residual" and name != "fused_mlp_down":
                # the layer-norm pre-pass alone (inside the kernel's time)
                norm = p["norm2"] if name == "fused_mlp_up" else p["norm1"]
                hn = torch.empty((B * n, C), device="cuda")
                def pre(hn=hn, x=x, norm=norm, eps=eps):
                    FQ._ln_rows_into(hn, x, norm["scale"], norm["bias"], eps)

                pre()
                torch.cuda.synchronize()
                ref = FQ._ln_rows(x.float(), norm["scale"], norm["bias"], eps).view(B * n, C)
                e_hn = float((hn - ref).abs().max())
                _check(f"{name} fp32[{site}] layer-norm pre-pass hn", e_hn, _f32_tol(ref))
                row.update(prepass_max_abs_err=e_hn, prepass_ms=_time_ms(pre),
                           prepass_back_to_back_ms=_back_to_back_ms(pre))
                del hn, ref
            per_kernel[name].append(row)
            label = name + hd
            _site_line(f"{label}[{site}] fp32", row)
            print(f"    {label}[{site}] fp32: repeat bit-equal; "
                  f"{row['bound_ms'] / row['back_to_back_ms'] * PEAK_F32_FLOPS / 1e12:.1f} "
                  f"TFLOP/s back to back"
                  + (f"; layer-norm pre-pass alone {row['prepass_ms']:.4f} ms a call, "
                     f"{row['prepass_back_to_back_ms']:.4f} ms back to back"
                     if "prepass_ms" in row else ""))
        del x, o
        torch.cuda.empty_cache()

    # -- the edges: C = 256 (4 heads of 64 or 2 of 128), rows no multiple of
    # 128, a 128-row tile across a frame boundary (2 x 200, 3 x 77), one row,
    # a zero row; at head dim 128 also an odd head count, C = 384 (3 heads);
    # the head-shard weight of H / 2 of H heads at C = 1024 ------------------
    widths = (256, 384) if d == 128 else (256,)
    for Ce in widths:
        small = block_params(Ce, d)
        for B, n, eps in ((1, 1, 1e-5), (2, 200, 1e-6), (3, 77, 1e-5), (1, 300, 1e-5)):
            x, o = randn(B, n, Ce), randn(B, Ce // d, n, d)
            x[0, n // 2] = 0.0
            ang = randn(n, d)
            tabs = (torch.cos(ang), torch.sin(ang))
            for t in (None, tabs):
                for name, kern, plain, *_ in calls(small, x, Ce // d, t, eps, o):
                    if name in per_kernel:
                        hold(name + hd, f"edge C {Ce} {B} x {n}", kern,
                             plain)
    x = randn(2, 200, C)
    ang = randn(200, d)
    tabs = (torch.cos(ang), torch.sin(ang))
    for rank in (0, 1):
        cols = torch.cat([torch.arange(rank * 512, rank * 512 + 512, device="cuda") + part * C
                          for part in range(3)])
        w_i = p["attn"]["qkv"]["w"][:, cols].contiguous()
        b_i = p["attn"]["qkv"]["b"][cols].contiguous()
        for t in (None, tabs):
            (name, kern, plain, *_), = calls(p, x, H, t, 1e-5, None, w_i, b_i)
            hold(name + hd, f"head shard {H // 2} of {H}, rank {rank}",
                 kern, plain)
    del x
    print(f"  fp32 fused block kernels at head dim {d}: the edges and the head shard within "
          "tolerance, repeats bit-equal")

    lines = {"fused_ln_qkv_rope": 158, "fused_ln_qkv": 309, "fused_proj_residual": 411,
             "fused_mlp_up": 526, "fused_mlp_down": 546}
    results = []
    for name, ss in per_kernel.items():
        results.append(dict(
            name=f"{name}{sfx}", route="cuda", source=F32_GEMM_SOURCE,
            replaces=f"self_supervise_sfm_tpu/ops/fused_qkv.py:{lines[name]}",
            # one call at each site measured
            max_abs_err=max(s_["max_abs_err"] for s_ in ss),
            **{k: sum(s_[k] for s_ in ss) for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            bound_by=ss[-1]["bound_by"], sites=ss))
        r = results[-1]
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, fp32 "
              f"library chain {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, fp32 rate), {len(ss)} sites")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.empty_cache()
    return results


def check_serving_kernels(randn, ulps, H=16, d=64):
    """Phase 2, the two kernels of the serving path: the [context | own
    frame] attention that reads a layer of the kv2 scene cache in place
    (K2p), and the flash forward under a RelocMask (K1m). bf16 outputs,
    tolerance 4 ulps at the largest output as for K1 / K2, the lse within
    1e-4. K1m runs K2's body over segment maps: on the same problem it must
    equal K2p bit for bit, and at the edges of its maps K2 on the unfolded
    tensors. At head dim 128 (``H`` heads of ``d``): the 5-anchor cache and
    the mask form, a repeat bit-equal; the 20-anchor cache and the edges are
    the head dim 64 run's."""
    import torch
    import torch.nn.functional as F

    from self_supervise_sfm_tpu_torch.ops import attention_core as AC
    from self_supervise_sfm_tpu_torch.ops import flash_attention as FA
    from self_supervise_sfm_tpu_torch.ops.mask_spec import RelocMask

    depth, Fq = 24, NUM_FRAMES
    sfx = "_d128" if d == 128 else ""
    P = (IMG // 14) ** 2 + 5
    q, k, v = (randn(Fq, H, P, d) for _ in range(3))

    def library(ckv, layer):
        # SDPA with what it needs first: the layer's slice, the k / v split,
        # the broadcast over frames and the concatenation with the own K/V
        ck, cv = ckv[layer, ..., :d], ckv[layer, ..., d:]
        kk = torch.cat([ck.expand(Fq, -1, -1, -1), k], dim=2)
        vv = torch.cat([cv.expand(Fq, -1, -1, -1), v], dim=2)
        return F.scaled_dot_product_attention(q, kk, vv)

    # -- K2p at the 5-anchor cache (first and last layer) and at 20 anchors --
    sites = []
    for anchors, layers in ((NUM_FRAMES, (0, depth - 1)),
                            *(((4 * NUM_FRAMES, (depth // 2,)),) if d == 64 else ())):
        nc = anchors * (RANK + 5)
        ckv = randn(depth, 1, H, nc, 2 * d)
        before = ckv.clone()
        for layer in layers:
            out = FA.frame_ctx_packed_fwd(q, k, v, ckv, layer)
            again = FA.frame_ctx_packed_fwd(q, k, v, ckv, layer)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                raise AssertionError(f"frame_ctx_packed_fwd{sfx} layer {layer}: a repeat differs")
            ref = FA.frame_ctx_packed_plain(q, k, v, ckv, layer)
            err = float((out.float() - ref.float()).abs().max())
            name = f"frame_ctx_packed_fwd{sfx}[{anchors} anchors, layer {layer}]"
            _check(f"{name} {tuple(q.shape)} cache {tuple(ckv.shape)}", err, ulps(ref, 4))
            # the same body as K2: bit-equal on the layer's split copies
            k2 = FA.frame_ctx_fwd(q, k, v, ckv[layer, ..., :d].contiguous(),
                                  ckv[layer, ..., d:].contiguous())
            if not torch.equal(out, k2):
                raise AssertionError(f"{name}: not bit-equal to K2 on the split copies")
            bound, by = _bound_ms(4.0 * Fq * H * P * (nc + P) * d,
                                  (4 * q.numel() + H * nc * 2 * d) * 2)
            sites.append(dict(
                site=f"{anchors} anchors, layer {layer}", shape=list(q.shape),
                cache_shape=list(ckv.shape), max_abs_err=err,
                ms=_time_ms(lambda: FA.frame_ctx_packed_fwd(q, k, v, ckv, layer)),
                plain_ms=_time_ms(lambda: FA.frame_ctx_packed_plain(q, k, v, ckv, layer),
                                  reps=5),
                library_ms=_time_ms(lambda: library(ckv, layer)),
                bound_ms=bound, bound_by=by,
                back_to_back_ms=_back_to_back_ms(
                    lambda: FA.frame_ctx_packed_fwd(q, k, v, ckv, layer)),
                library_back_to_back_ms=_back_to_back_ms(lambda: library(ckv, layer))))
        if not torch.equal(ckv, before):
            raise AssertionError("frame_ctx_packed_fwd wrote to the cache")
        for bad in (-1, depth):
            try:
                FA.frame_ctx_packed_fwd(q, k, v, ckv, bad)
            except IndexError:
                continue
            raise AssertionError(f"frame_ctx_packed_fwd took layer {bad}")
        if anchors == NUM_FRAMES:
            ckv5 = ckv
        del before
    print(f"  frame_ctx_packed_fwd{sfx}: bit-equal to frame_ctx_fwd{sfx} (K2) on the split "
          f"copies")
    results = [dict(
        name="frame_ctx_packed_fwd" + sfx, route="cuda", source=SM90_SOURCE,
        replaces="self_supervise_sfm_tpu/ops/flash_attention.py:661",
        # one call at each site measured
        max_abs_err=max(s_["max_abs_err"] for s_ in sites),
        **{key: sum(s_[key] for s_ in sites)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
        bound_by=sites[0]["bound_by"], sites=sites)]

    # -- K1m on the same problem in mask form: rows of all frames at once ----
    nc = NUM_FRAMES * (RANK + 5)
    mask = RelocMask(nc, P, Fq)

    def unfold(x):  # (F, H, P, d) frame-major -> (1, H, F*P, d)
        return x.transpose(0, 1).reshape(1, H, Fq * P, d).contiguous()

    ck = ckv5[0, ..., :d].contiguous()
    cv = ckv5[0, ..., d:].contiguous()
    qm, ks, vs = unfold(q), unfold(k), unfold(v)
    km, vm = torch.cat([ck, ks], dim=2), torch.cat([cv, vs], dim=2)
    q3, k3, v3 = qm[0], km[0], vm[0]
    out, lse = FA.flash_fwd_reloc(q3, k3, v3, mask)
    again, lse_again = FA.flash_fwd_reloc(q3, k3, v3, mask)
    torch.cuda.synchronize()
    if not (torch.equal(out, again) and torch.equal(lse, lse_again)):
        raise AssertionError(f"flash_fwd_reloc{sfx}: a repeat differs")
    p_out, p_lse = FA.flash_fwd_plain(q3, k3, v3, mask)
    err = float((out.float() - p_out.float()).abs().max())
    _check(f"flash_fwd_reloc{sfx} out {tuple(q3.shape)} x {tuple(k3.shape)} {mask}", err,
           ulps(p_out, 4))
    _check(f"flash_fwd_reloc{sfx} lse", float((lse - p_lse).abs().max()), 1e-4)
    # the three forms of the one problem agree: mask, split and layout; the
    # mask form is the layout form's walk over other maps, bit for bit
    layout = unfold(FA.frame_ctx_packed_fwd(q, k, v, ckv5, 0))[0]
    split = AC.reloc_split_attention(qm, ks, vs, ck, cv, mask)[0]
    _check("mask form vs layout form (K2p)", float((out.float() - layout.float()).abs().max()),
           ulps(p_out, 4))
    if not torch.equal(out, layout):
        raise AssertionError(f"flash_fwd_reloc{sfx}: not bit-equal to K2p on the same problem")
    print(f"  flash_fwd_reloc{sfx} (K1m): bit-equal to frame_ctx_packed_fwd{sfx} (K2p) on the "
          f"same problem")
    _check("split form vs layout form (K2p)",
           float((split.float() - layout.float()).abs().max()), ulps(p_out, 4))
    dense_mask = mask.materialize("cuda")
    allowed = Fq * P * (nc + P)  # entries the mask allows, per head
    bound, by = _bound_ms(4.0 * H * allowed * d,
                          (2 * q3.numel() + 2 * k3.numel()) * 2 + lse.numel() * 4)
    kernel = lambda: FA.flash_fwd_reloc(q3, k3, v3, mask)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(qm, km, vm, attn_mask=dense_mask)  # noqa: E731
    split_form = lambda: AC.reloc_split_attention(qm, ks, vs, ck, cv, mask)  # noqa: E731
    r = dict(
        name="flash_fwd_reloc" + sfx, route="cuda", source=SM90_SOURCE,
        replaces="self_supervise_sfm_tpu/ops/flash_attention.py:140",
        variant="mask=RelocMask", max_abs_err=err, shape=list(q3.shape),
        ms=_time_ms(kernel),
        plain_ms=_time_ms(lambda: FA.flash_fwd_plain(q3, k3, v3, mask), reps=3, warmup=1),
        # SDPA with the materialised boolean mask
        library_ms=_time_ms(library),
        bound_ms=bound, bound_by=by,
        back_to_back_ms=_back_to_back_ms(kernel),
        library_back_to_back_ms=_back_to_back_ms(library),
        # the same problem in the other two forms, for the record
        split_form_ms=_time_ms(split_form),
        split_form_back_to_back_ms=_back_to_back_ms(split_form),
        layout_form_ms=sites[0]["ms"], layout_form_back_to_back_ms=sites[0]["back_to_back_ms"])
    print(f"  one reloc attention, three forms: mask (K1m) {r['ms']:.4f} ms "
          f"(b2b {r['back_to_back_ms']:.4f}), split (two K1 calls + lse merge) "
          f"{r['split_form_ms']:.4f} ms (b2b {r['split_form_back_to_back_ms']:.4f}), layout (K2p) "
          f"{r['layout_form_ms']:.4f} ms (b2b {r['layout_form_back_to_back_ms']:.4f})")
    _site_line(f"flash_fwd_reloc{sfx} {tuple(q3.shape)} x {tuple(k3.shape)} {mask}", r)
    results.append(r)
    del q3, k3, v3, qm, km, vm, ks, vs, out, lse, p_out, p_lse, dense_mask
    if d == 64:
        check_reloc_edges(randn, ulps)
    for s_ in sites:
        _site_line(f"frame_ctx_packed_fwd{sfx}[{s_['site']}]", s_)
    torch.cuda.empty_cache()
    return results


def check_reloc_edges(randn, ulps):
    """Phase 2, K1m at the edges of its segment maps: no context, one frame,
    frames shorter than a box (40 frames of 37 rows), whole 256-row frames,
    context and frame tails, frames of 7 rows, whole 128-row segments.
    Each against ``flash_fwd_plain`` with the mask (4 ulps, the lse within
    1e-4) and bit-equal to K2 on the unfolded tensors."""
    import torch

    from self_supervise_sfm_tpu_torch.ops import flash_attention as FA
    from self_supervise_sfm_tpu_torch.ops.mask_spec import RelocMask

    for H, (n_ctx, P, F) in ((16, (0, 1374, 2)), (16, (1525, 1374, 1)), (16, (77, 37, 40)),
                             (16, (610, 256, 3)), (2, (77, 130, 2)), (2, (0, 130, 3)),
                             (2, (128, 128, 2)), (2, (5, 7, 3)), (2, (77, 130, 1))):
        mask = RelocMask(n_ctx, P, F)
        q, k, v = randn(H, mask.nq, 64), randn(H, mask.nk, 64), randn(H, mask.nk, 64)
        out, lse = FA.flash_fwd_reloc(q, k, v, mask)

        def fold(x):  # (H, F * P, 64) -> (F, H, P, 64), frame-major
            return x.view(H, F, P, 64).transpose(0, 1).contiguous()

        k2 = FA.frame_ctx_fwd(fold(q), fold(k[:, n_ctx:]), fold(v[:, n_ctx:]),
                              k[None, :, :n_ctx].contiguous(), v[None, :, :n_ctx].contiguous())
        torch.cuda.synchronize()
        p_out, p_lse = FA.flash_fwd_plain(q, k, v, mask)
        _check(f"flash_fwd_reloc edge ({H}, {mask.nq}, {mask.nk}) {mask}",
               float((out.float() - p_out.float()).abs().max()), ulps(p_out, 4))
        _check(f"flash_fwd_reloc edge {mask} lse", float((lse - p_lse).abs().max()), 1e-4)
        if not torch.equal(fold(out), k2):
            raise AssertionError(f"flash_fwd_reloc edge {mask}: not bit-equal to K2")
    print("  edges: flash_fwd_reloc bit-equal to frame_ctx_fwd (K2) on the unfolded tensors at each")


TRAIN_FRAMES = 2  # frames a scene on the train step (bench.py:bench_train's S)


def check_backward_kernels(randn, ulps, H=16, d=64):
    """Phase 2, the two B9 kernels (dq; dk/dv) of the Hopper backward body at
    the train step's shapes (H heads of d: 16 of 64, or 8 of 128, whose
    entries are named "_d128"): the ViT, frame and global sites and the two
    calls of the frame-context split (own frame, and the broadcast context
    with an lse cotangent), and their RelocMask forms at reloc layer 0's
    shape and at the 5-query shape of phase 4's mask-form check. Inputs:
    random q, k, v and do, with o and lse from the forward kernel. Held
    against ``flash_bwd_plain``: bf16 outputs, kernel and plain version
    recompute p and ds in fp32 with other summation orders and round ds, p
    and the result to bf16, so the tolerance is 4 ulps at the largest |grad|
    of each output. A second backward at the global and the 5-query masked
    site must be bit-equal to the first (no atomics). Timed a call and 20
    launches back to back beside the plain backward (all three gradients)
    and the yardstick ``torch.autograd.grad`` through SDPA at the same shape
    (with the materialised boolean mask at the masked sites; its forward run
    once beforehand, so only the backward is timed), whose time the pair
    (dq + dk/dv) is divided by."""
    import torch
    import torch.nn.functional as F

    from self_supervise_sfm_tpu_torch.ops import flash_attention as FA
    from self_supervise_sfm_tpu_torch.ops.mask_spec import RelocMask

    S = TRAIN_FRAMES
    sfx = "_d128" if d == 128 else ""
    P = (IMG // 14) ** 2 + 5
    nc = S * (RANK + 5)
    nc5 = NUM_FRAMES * (RANK + 5)
    # (name, BH, Nq, Nk, with an lse cotangent, mask)
    sites = [("vit", S * H, P, P, False, None),
             ("frame", 2 * S * H, P, P, False, None),
             ("global", H, S * P, S * P, False, None),
             ("split own", S * H, P, P, True, None),
             ("split context", S * H, P, nc, True, None),
             ("reloc layer 0, RelocMask", H, S * P, nc + S * P, False,
              RelocMask(nc, P, S)),
             ("reloc 5 queries, RelocMask", H, NUM_FRAMES * P, nc5 + NUM_FRAMES * P, False,
              RelocMask(nc5, P, NUM_FRAMES))]
    # the Hopper body at the edges of its tiling first: one q row (against
    # three keys: with one key every gradient is 0 up to rounding noise, no
    # scale for an ulp tolerance), ragged q and key tiles on both sides, fewer keys than q rows, a
    # second warpgroup with no row inside nq; with and without dlse; at head
    # dim 128 also q and key counts inside its 32-row and 64-key tiles
    edges = [(2, 1, 3, False), (3, 130, 77, True), (2, 257, 130, False), (1, 200, 333, True),
             (2, 64, 64, False)] + ([(2, 33, 65, True)] if d == 128 else [])
    for bh, nq, nk, with_dlse in edges:
        q, do, k, v = randn(bh, nq, d), randn(bh, nq, d), randn(bh, nk, d), randn(bh, nk, d)
        o, lse = FA.flash_fwd(q, k, v)
        dlse = randn(bh, nq, dtype=torch.float32) if with_dlse else None
        grads = FA.flash_bwd(q, k, v, o, lse, do, dlse)
        torch.cuda.synchronize()
        refs = FA.flash_bwd_plain(q, k, v, o, lse, do, dlse)
        for label, g, r in zip(("dq", "dk", "dv"), grads, refs):
            _check(f"flash_bwd{sfx} edge ({bh}, {nq}, {nk}){' dlse' if with_dlse else ''} "
                   f"{label}",
                   float((g.float() - r.float()).abs().max()), ulps(r, 4))
    # the RelocMask forms at the edges of their work tiles: context and frame
    # tails at both kinds of boundary, no context, one-row frames, whole
    # 128-row segments, the train site's 98-key context tail; with and
    # without dlse
    for n_ctx, fs, nf in ((77, 130, 2), (0, 130, 3), (5, 1, 7), (128, 128, 2), (98, 257, 2)):
        mask = RelocMask(n_ctx, fs, nf)
        for with_dlse in (False, True):
            q, do = randn(2, mask.nq, d), randn(2, mask.nq, d)
            k, v = randn(2, mask.nk, d), randn(2, mask.nk, d)
            o, lse = FA.flash_fwd_reloc(q, k, v, mask)
            dlse = randn(2, mask.nq, dtype=torch.float32) if with_dlse else None
            grads = FA.flash_bwd(q, k, v, o, lse, do, dlse, mask)
            torch.cuda.synchronize()
            refs = FA.flash_bwd_plain(q, k, v, o, lse, do, dlse, mask)
            for label, g, r in zip(("dq", "dk", "dv"), grads, refs):
                _check(f"flash_bwd{sfx} edge {mask}{' dlse' if with_dlse else ''} {label}",
                       float((g.float() - r.float()).abs().max()), ulps(r, 4))
    rows = {f"flash_bwd_dq{sfx}": [], f"flash_bwd_dkv{sfx}": []}
    for site, bh, nq, nk, with_dlse, mask in sites:
        q, do = randn(bh, nq, d), randn(bh, nq, d)
        k, v = randn(bh, nk, d), randn(bh, nk, d)
        o, lse = FA.flash_fwd(q, k, v) if mask is None else FA.flash_fwd_reloc(q, k, v, mask)
        dlse = randn(bh, nq, dtype=torch.float32) if with_dlse else None
        grads = FA.flash_bwd(q, k, v, o, lse, do, dlse, mask)
        torch.cuda.synchronize()
        refs = FA.flash_bwd_plain(q, k, v, o, lse, do, dlse, mask)
        errs = {}
        for label, g, r in zip(("dq", "dk", "dv"), grads, refs):
            errs[label] = float((g.float() - r.float()).abs().max())
            _check(f"flash_bwd{sfx}[{site}] {label} {tuple(g.shape)}", errs[label],
                   ulps(r, 4))
        if site in ("global", "reloc 5 queries, RelocMask"):
            again = FA.flash_bwd(q, k, v, o, lse, do, dlse, mask)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise AssertionError(f"flash_bwd{sfx}[{site}]: a second backward is not "
                                     f"bit-equal")
            print(f"  flash_bwd{sfx}[{site}]: a second backward bit-equal to the first")
            del again
        delta = FA._delta(o, do, dlse).contiguous()
        # allowed pairs a head
        pairs = nq * nk if mask is None else nq * (mask.n_ctx + mask.frame_size)
        io = (2 * q.numel() + 2 * k.numel()) * 2 + 2 * lse.numel() * 4
        qm, km, vm = (t.view(1, bh, -1, d).detach().requires_grad_() for t in (q, k, v))
        attn_mask = None if mask is None else mask.materialize("cuda")
        out = F.scaled_dot_product_attention(qm, km, vm, attn_mask=attn_mask)
        dom = do.view(out.shape)
        sdpa_bwd = lambda: torch.autograd.grad(out, (qm, km, vm), dom,  # noqa: E731
                                               retain_graph=True)
        plain = _time_ms(lambda: FA.flash_bwd_plain(q, k, v, o, lse, do, dlse, mask),
                         reps=3, warmup=1)
        common = dict(site=site, shape=[bh, nq, nk, d], plain_ms=plain,
                      library_ms=_time_ms(sdpa_bwd),
                      library_back_to_back_ms=_back_to_back_ms(sdpa_bwd),
                      masked=mask is not None)
        dq_fn = lambda: FA.flash_bwd_dq(q, k, v, do, lse, delta, mask)  # noqa: E731
        dkv_fn = lambda: FA.flash_bwd_dkv(q, k, v, do, lse, delta, mask)  # noqa: E731
        b_dq, by_dq = _bound_ms(3 * 2.0 * bh * pairs * d, io + q.numel() * 2)
        rows[f"flash_bwd_dq{sfx}"].append(dict(
            common, max_abs_err=errs["dq"], bound_ms=b_dq, bound_by=by_dq,
            ms=_time_ms(dq_fn), back_to_back_ms=_back_to_back_ms(dq_fn)))
        b_kv, by_kv = _bound_ms(4 * 2.0 * bh * pairs * d, io + 2 * k.numel() * 2)
        rows[f"flash_bwd_dkv{sfx}"].append(dict(
            common, max_abs_err=max(errs["dk"], errs["dv"]), bound_ms=b_kv, bound_by=by_kv,
            ms=_time_ms(dkv_fn), back_to_back_ms=_back_to_back_ms(dkv_fn)))
        del q, k, v, do, o, lse, grads, refs, out, qm, km, vm
        torch.cuda.empty_cache()
    results = []
    for name, line in ((f"flash_bwd_dq{sfx}", 332), (f"flash_bwd_dkv{sfx}", 349)):
        ss = rows[name]
        for s_ in ss:
            print(f"  {name}[{s_['site']}] {s_['shape']}: kernel {s_['ms']:.4f} ms, b2b "
                  f"{s_['back_to_back_ms']:.4f} ms, bound {s_['bound_ms']:.4f} ms "
                  f"({s_['bound_by']}, {s_['bound_ms'] / s_['back_to_back_ms']:.3f} of it b2b, "
                  f"{s_['bound_ms'] / s_['back_to_back_ms'] * PEAK_BF16_FLOPS / 1e12:.0f} "
                  f"TFLOP/s), plain backward {s_['plain_ms']:.4f} ms")
        path = [s_ for s_ in ss if not s_["masked"]]
        kind = name.split("_")[2]
        hd = "d128_" if d == 128 else ""
        results.append(dict(
            name=name, route="cuda",
            source="self_supervise_sfm_tpu_torch/csrc/flash_bwd_sm90.cu",
            # the RelocMask form (0 launches on every path), the same body
            masked_source="self_supervise_sfm_tpu_torch/csrc/flash_bwd_sm90.cu",
            entries=[f"sfm_flash_bwd_{kind}_{hd}sm90", f"sfm_flash_bwd_{kind}_reloc_{hd}sm90"],
            replaces=f"self_supervise_sfm_tpu/ops/flash_attention.py:{line}",
            # one call at each unmasked site of the train step; plain_ms and
            # library_ms compute all three gradients
            max_abs_err=max(s_["max_abs_err"] for s_ in ss),
            **{k: sum(s_[k] for s_ in path)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            bound_by=path[-1]["bound_by"], sites=ss))
    # the pair against SDPA's whole backward, a call and back to back
    for a, b in zip(rows[f"flash_bwd_dq{sfx}"], rows[f"flash_bwd_dkv{sfx}"]):
        call, b2b = a["ms"] + b["ms"], a["back_to_back_ms"] + b["back_to_back_ms"]
        print(f"  flash_bwd{sfx} pair[{a['site']}]: {call:.4f} ms a call, {b2b:.4f} ms b2b; SDPA "
              f"backward {a['library_ms']:.4f} / {a['library_back_to_back_ms']:.4f} ms; pair / "
              f"SDPA {call / a['library_ms']:.2f} a call, {b2b / a['library_back_to_back_ms']:.2f} "
              f"b2b")
    return results


class _F32Launches:
    """The fp32 launches of a wrapper that counts them apart
    (``.launches_f32``: the attention and fused block wrappers), read and
    reset as ``.launches``."""

    attr = "launches_f32"

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self) -> int:
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, n: int) -> None:
        setattr(self.fn, self.attr, n)


class _D128Launches(_F32Launches):
    """The head dim 128 launches of a wrapper (``.launches_d128``), read and
    reset as ``.launches``."""

    attr = "launches_d128"


class _D128F32Launches(_F32Launches):
    """The fp32 head dim 128 launches of an attention or fused block wrapper
    (``.launches_d128_f32``), read and reset as ``.launches``."""

    attr = "launches_d128_f32"


def kernel_wrappers() -> dict:
    """Every kernel's launch wrapper by its name in the kernel line; each
    counts its launches in ``.launches`` (the attention and fused block
    wrappers' fp32 launches under the fp32 names)."""
    from self_supervise_sfm_tpu_torch.ops import flash_attention as FA
    from self_supervise_sfm_tpu_torch.ops import fused_qkv as FQ
    from self_supervise_sfm_tpu_torch.ops import resize as RS

    return {"flash_fwd": FA.flash_fwd, "frame_ctx_fwd": FA.frame_ctx_fwd,
            "frame_ctx_packed_fwd": FA.frame_ctx_packed_fwd,
            "flash_fwd_reloc": FA.flash_fwd_reloc,
            "resize_bilinear": RS.resize_bilinear_fwd,
            "fused_ln_qkv_rope": FQ.fused_ln_qkv_rope_fwd, "fused_ln_qkv": FQ.fused_ln_qkv_fwd,
            "fused_proj_residual": FQ.fused_proj_residual_fwd,
            "fused_mlp_up": FQ.fused_mlp_up, "fused_mlp_down": FQ.fused_mlp_down,
            "flash_bwd_dq": FA.flash_bwd_dq, "flash_bwd_dkv": FA.flash_bwd_dkv,
            "flash_fwd_f32": _F32Launches(FA.flash_fwd),
            "frame_ctx_fwd_f32": _F32Launches(FA.frame_ctx_fwd),
            "frame_ctx_packed_fwd_f32": _F32Launches(FA.frame_ctx_packed_fwd),
            "flash_fwd_reloc_f32": _F32Launches(FA.flash_fwd_reloc),
            "flash_bwd_dq_f32": _F32Launches(FA.flash_bwd_dq),
            "flash_bwd_dkv_f32": _F32Launches(FA.flash_bwd_dkv),
            "fused_ln_qkv_rope_f32": _F32Launches(FQ.fused_ln_qkv_rope_fwd),
            "fused_ln_qkv_f32": _F32Launches(FQ.fused_ln_qkv_fwd),
            "fused_proj_residual_f32": _F32Launches(FQ.fused_proj_residual_fwd),
            "fused_mlp_up_f32": _F32Launches(FQ.fused_mlp_up),
            "fused_mlp_down_f32": _F32Launches(FQ.fused_mlp_down),
            "flash_fwd_d128": _D128Launches(FA.flash_fwd),
            "frame_ctx_fwd_d128": _D128Launches(FA.frame_ctx_fwd),
            "frame_ctx_packed_fwd_d128": _D128Launches(FA.frame_ctx_packed_fwd),
            "flash_fwd_reloc_d128": _D128Launches(FA.flash_fwd_reloc),
            "fused_ln_qkv_rope_d128": _D128Launches(FQ.fused_ln_qkv_rope_fwd),
            "fused_ln_qkv_d128": _D128Launches(FQ.fused_ln_qkv_fwd),
            "fused_proj_residual_d128": _D128Launches(FQ.fused_proj_residual_fwd),
            "flash_bwd_dq_d128": _D128Launches(FA.flash_bwd_dq),
            "flash_bwd_dkv_d128": _D128Launches(FA.flash_bwd_dkv),
            "flash_fwd_d128_f32": _D128F32Launches(FA.flash_fwd),
            "frame_ctx_fwd_d128_f32": _D128F32Launches(FA.frame_ctx_fwd),
            "frame_ctx_packed_fwd_d128_f32": _D128F32Launches(FA.frame_ctx_packed_fwd),
            "flash_fwd_reloc_d128_f32": _D128F32Launches(FA.flash_fwd_reloc),
            "flash_bwd_dq_d128_f32": _D128F32Launches(FA.flash_bwd_dq),
            "flash_bwd_dkv_d128_f32": _D128F32Launches(FA.flash_bwd_dkv),
            "fused_ln_qkv_rope_d128_f32": _D128F32Launches(FQ.fused_ln_qkv_rope_fwd),
            "fused_ln_qkv_d128_f32": _D128F32Launches(FQ.fused_ln_qkv_fwd),
            "fused_proj_residual_d128_f32": _D128F32Launches(FQ.fused_proj_residual_fwd)}


def run_forward(gen):
    """Phase 3: the full-width forward through the kernels, its launch counts,
    and its agreement with the plain-path forward."""
    import torch

    from self_supervise_sfm_tpu_torch.models import aggregator as AG
    from self_supervise_sfm_tpu_torch.models import sailrecon as M

    wrappers = kernel_wrappers()
    unfused = dict(fused_qkv="off", fused_mlp="off")
    plain_sites = dict(attn_impl="dense", global_attn_impl="dense", resize_impl="einsum",
                       **unfused)
    # the main path: every kernel on; the same with the fused block kernels
    # off (attention and resize kernels only); every site on plain PyTorch
    cfg = M.make_config(compute_dtype="bfloat16")
    cfg_unfused = M.make_config(compute_dtype="bfloat16", **unfused)
    cfg_plain = M.make_config(compute_dtype="bfloat16", **plain_sites)
    cfg_f32 = M.make_config(**plain_sites)
    t0 = time.perf_counter()
    p32 = M.init_sailrecon(cfg, gen, device="cuda")
    params = M.cast_trunk_weights(p32, cfg)
    uniq = torch.rand((1, NUM_FRAMES, IMG, IMG, 3), generator=gen, device="cuda")
    images = torch.cat([uniq, uniq], dim=1)
    torch.cuda.synchronize()
    print(f"  init {time.perf_counter() - t0:.2f} s")

    def draw():
        # the same scene-token subsample for every run compared
        return torch.Generator(device="cuda").manual_seed(SEED + 1)

    def fwd(c, p):
        return M.forward(p, c, images, NUM_FRAMES, NUM_FRAMES, rank=RANK,
                         generator=draw(), images_duplicated=True)

    for w in wrappers.values():
        w.launches = 0
    out = fwd(cfg, params)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"  launches in one forward: {launches}")
    expected = FORWARD_LAUNCHES
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")

    def timed(c, reps, p=params):
        """Median forward seconds, all runs, and the peak memory in GB."""
        fwd(c, p)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fwd(c, p)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        return statistics.median(runs), runs, torch.cuda.max_memory_allocated() / 1e9

    # in turns on the one card: fused, unfused, unfused, fused
    step_a, runs_a, peak_gb = timed(cfg, 3)
    unf_a, unf_runs_a, unfused_peak_gb = timed(cfg_unfused, 3)
    unf_b, unf_runs_b, _ = timed(cfg_unfused, 3)
    step_b, runs_b, _ = timed(cfg, 3)
    times, unfused_times = runs_a + runs_b, unf_runs_a + unf_runs_b
    step, unfused_step = statistics.median(times), statistics.median(unfused_times)

    before = {k: w.launches for k, w in wrappers.items()}
    plain = fwd(cfg_plain, params)
    f32 = fwd(cfg_f32, p32)
    torch.cuda.synchronize()
    if {k: w.launches for k, w in wrappers.items()} != before:
        raise AssertionError("the plain-path forward launched a kernel")
    plain_step, _, plain_peak_gb = timed(cfg_plain, 1)

    failures = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    # the default configuration, fp32 with attn_impl "auto": every attention
    # site on the fp32 forms of K1 and K2 (as many launches as the bf16
    # path's K1 and K2), the fused block kernels off (they take bf16 only, as
    # JAX's "auto"), K3 on the fp32 heads' final upsample
    cfg_default = M.make_config()
    for w in wrappers.values():
        w.launches = 0
    dflt = fwd(cfg_default, p32)
    torch.cuda.synchronize()
    n_default = {k: w.launches for k, w in wrappers.items()}
    print(f"  launches in one forward of the default configuration (fp32, auto): "
          f"{ {k: n for k, n in n_default.items() if n} }")
    if n_default != DEFAULT_FORWARD_LAUNCHES:
        raise AssertionError(f"default configuration launch counts {n_default}, "
                             f"expected {DEFAULT_FORWARD_LAUNCHES}")
    # the same forward with its attention on the dense route (fp32 logits
    # stored whole), in turns on the one card: kernels, dense, dense, kernels
    cfg_default_dense = M.make_config(attn_impl="dense", global_attn_impl="dense")
    dk_a, dk_runs_a, default_peak_gb = timed(cfg_default, 2, p32)
    dd_a, dd_runs_a, default_dense_peak_gb = timed(cfg_default_dense, 2, p32)
    dd_b, dd_runs_b, _ = timed(cfg_default_dense, 2, p32)
    dk_b, dk_runs_b, _ = timed(cfg_default, 2, p32)
    default_times, default_dense_times = dk_runs_a + dk_runs_b, dd_runs_a + dd_runs_b
    default_step = statistics.median(default_times)
    default_dense_step = statistics.median(default_dense_times)
    print(f"  default configuration (fp32): forward on the kernels {default_step * 1e3:.2f} ms, "
          f"peak {default_peak_gb:.2f} GB; on the dense route {default_dense_step * 1e3:.2f} "
          f"ms, peak {default_dense_peak_gb:.2f} GB (medians of 4, in turns; dense / kernels "
          f"{default_dense_step / default_step:.3f}x)")

    shapes = {"extrinsic": (1, 5, 3, 4), "intrinsic": (1, 5, 3, 3),
              "point_map": (1, 5, IMG, IMG, 3), "xyz_cnf": (1, 5, IMG, IMG),
              "depth_map": (1, 5, IMG, IMG, 1), "dpt_cnf": (1, 5, IMG, IMG),
              "point_map_by_unprojection": (1, 5, IMG, IMG, 3),
              "cam_tokens": (1, 5, 2048)}
    for k, shape in shapes.items():
        expect(tuple(out[k].shape) == shape, f"{k}: shape {tuple(out[k].shape)}")
        share = float(torch.isfinite(out[k]).float().mean())
        print(f"  {k}: finite share {share:.6f} (kernel path)")

    # trunk (attention and fused block kernels): the kernel path's aggregator
    # output against the plain path's, in relative RMS; the yardstick is what
    # bf16 itself moves the plain path away from an fp32 forward
    def agg(c, p):
        return AG.aggregator_forward(p["aggregator"], c.aggregator, images, NUM_FRAMES,
                                     NUM_FRAMES, RANK, generator=draw(),
                                     images_duplicated=True)

    tk, psi, ck = agg(cfg, params)
    tp, _, cp = agg(cfg_plain, params)
    tf, _, cf = agg(cfg_f32, p32)

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    # the default configuration against the fp32 plain path: the fp32
    # attention kernels against the dense route, both fp32, so agreement to
    # fp32 rounding (rel-RMS 1e-5) in the trunk and the poses;
    # the depth and point maps (K3 against the einsum upsample, both fp32)
    # on the logit scale within phase 3's 1e-3, where both are finite
    td, _, cd = agg(cfg_default, p32)
    same = all(torch.equal(td[li], tf[li]) for li in cfg.aggregator.intermediate_layer_idx)
    for name, a, b in ([(f"tap {li}", td[li], tf[li])
                        for li in cfg.aggregator.intermediate_layer_idx]
                       + [("anchor cam tokens", cd, cf)]
                       + [(k, dflt[k], f32[k]) for k in ("extrinsic", "intrinsic", "cam_tokens")]):
        err = rel(a, b)
        print(f"  default configuration {name}: vs the fp32 plain path rel-RMS {err:.4e} "
              f"(tolerance 1e-5)")
        expect(err <= 1e-5, f"default configuration {name}: {err} over 1e-5")
    print(f"  default configuration trunk taps bit-equal to the fp32 plain path's: {same}")
    for k in ("depth_map", "point_map"):
        ya, yb = _logit(k, dflt[k].float()), _logit(k, f32[k].float())
        both = torch.isfinite(ya) & torch.isfinite(yb)
        err = float(((ya - yb).abs() / yb.abs().clamp(min=1.0))[both].max())
        print(f"  default configuration {k}: max logit error / max(|logit|, 1) {err:.4e} "
              f"(tolerance 1e-3), finite share {float(both.float().mean()):.6f}")
        expect(err <= 1e-3, f"default configuration {k}: {err} over 1e-3")
    del dflt, td, cd

    # the fp32 trunk with the fused block kernels asked for (fused_qkv="on",
    # fused_mlp="on"): every trunk block on the fp32 forms of the five, the
    # attention sites as the default configuration's; held to the fp32 plain
    # path as the default configuration is, timed in turns against it
    cfg_on = M.make_config(**ON_F32)
    for w in wrappers.values():
        w.launches = 0
    on = fwd(cfg_on, p32)
    torch.cuda.synchronize()
    n_on = {k: w.launches for k, w in wrappers.items()}
    print(f"  launches in one forward of the fp32 trunk with the fused block kernels on: "
          f"{ {k: n for k, n in n_on.items() if n} }")
    if n_on != ON_F32_FORWARD_LAUNCHES:
        raise AssertionError(f"fp32 fused-on launch counts {n_on}, expected "
                             f"{ON_F32_FORWARD_LAUNCHES}")
    tn, _, cn = agg(cfg_on, p32)
    on_agree = {}
    for name, a, b in ([(f"tap {li}", tn[li], tf[li])
                        for li in cfg.aggregator.intermediate_layer_idx]
                       + [("anchor cam tokens", cn, cf)]
                       + [(k, on[k], f32[k]) for k in ("extrinsic", "intrinsic", "cam_tokens")]):
        err = rel(a, b)
        on_agree[name] = err
        print(f"  fp32 fused-on {name}: vs the fp32 plain path rel-RMS {err:.4e} "
              f"(tolerance 1e-5)")
        expect(err <= 1e-5, f"fp32 fused-on {name}: {err} over 1e-5")
    for k in ("depth_map", "point_map"):
        ya, yb = _logit(k, on[k].float()), _logit(k, f32[k].float())
        both = torch.isfinite(ya) & torch.isfinite(yb)
        err = float(((ya - yb).abs() / yb.abs().clamp(min=1.0))[both].max())
        on_agree[k] = err
        print(f"  fp32 fused-on {k}: max logit error / max(|logit|, 1) {err:.4e} "
              f"(tolerance 1e-3), finite share {float(both.float().mean()):.6f}")
        expect(err <= 1e-3, f"fp32 fused-on {k}: {err} over 1e-3")
    del on, tn, cn
    # in turns on the one card: fused on, default, default, fused on
    on_a, on_runs_a, on_peak_gb = timed(cfg_on, 2, p32)
    _, od_runs_a, on_default_peak_gb = timed(cfg_default, 2, p32)
    _, od_runs_b, _ = timed(cfg_default, 2, p32)
    _, on_runs_b, _ = timed(cfg_on, 2, p32)
    on_times, on_default_times = on_runs_a + on_runs_b, od_runs_a + od_runs_b
    on_step = statistics.median(on_times)
    on_default_step = statistics.median(on_default_times)
    print(f"  fp32 trunk, fused block kernels on: forward {on_step * 1e3:.2f} ms, peak "
          f"{on_peak_gb:.2f} GB; the default configuration (\"auto\", the unfused chain) "
          f"{on_default_step * 1e3:.2f} ms, peak {on_default_peak_gb:.2f} GB (medians of 4, "
          f"in turns; on / auto {on_step / on_default_step:.3f}x)")
    print("  profile of the fp32 forward with the fused block kernels on:")
    on_profile = profile_forward(lambda: fwd(cfg_on, p32), label="fp32 fused-on forward")

    pairs = [(f"tap {li}", tk[li], tp[li], tf[li])
             for li in cfg.aggregator.intermediate_layer_idx]
    pairs.append(("anchor cam tokens", ck, cp, cf))
    for name, a, b, c in pairs:
        err, env = rel(a, b), rel(b, c)
        print(f"  trunk {name}: kernel vs plain rel-RMS {err:.4e}, plain bf16 vs fp32 "
              f"{env:.4e} (tolerance 2x that)")
        expect(err <= 2 * env, f"trunk {name}: {err} over twice the bf16 envelope {env}")

    # heads (K3): the same taps decoded with the final upsample on the kernel
    # and on the einsum path, compared on the scale of the logits (inverse of
    # the exp / inverse-log activations). With an fp32 store the two differ
    # by fp32 rounding only: tolerance 1e-3 * max(|logit|, 1) per element.
    # With the main path's bf16 store, whole-ulp flips of the stored values
    # move the logits further; that error is printed for the record (phase 2
    # holds the bf16 store itself to one ulp). At random init these heads
    # overflow (and underflow) fp32 on part of the image; the finite masks may
    # differ only at those edges (|logit| within 1 of -log(FLT_MIN)).
    def decode(c, store):
        c = dataclasses.replace(
            c, point=dataclasses.replace(c.point, final_upsample_dtype=store),
            depth=dataclasses.replace(c.depth, final_upsample_dtype=store))
        return M._decode_heads(params, c, tk, ck, (IMG, IMG), psi)

    hk = decode(cfg, "bfloat16")
    for k in ("extrinsic", "intrinsic", "depth_map", "point_map", "cam_tokens"):
        expect(torch.equal(hk[k], out[k]), f"{k}: the forward is not reproducible")
    hp = decode(cfg_plain, "bfloat16")
    hk32, hp32 = decode(cfg, "float32"), decode(cfg_plain, "float32")
    edge = -math.log(torch.finfo(torch.float32).tiny) - 1.0
    for k in ("point_map", "xyz_cnf", "depth_map", "dpt_cnf",
              "point_map_by_unprojection"):
        errs = []
        for ha, hb in ((hk32, hp32), (hk, hp)):
            ya, yb = _logit(k, ha[k].float()), _logit(k, hb[k].float())
            fa, fb = torch.isfinite(ya), torch.isfinite(yb)
            both, flip = fa & fb, fa ^ fb
            at_edge = torch.where(fa, ya, yb).abs() > edge
            if k == "point_map_by_unprojection":
                # a point overflows where its depth does, however small the
                # ray coordinate that scales the other path's finite depth
                at_edge |= torch.minimum(_logit("depth_map", ha["depth_map"].float()),
                                         _logit("depth_map", hb["depth_map"].float())) > edge
            expect(bool(at_edge[flip].all()),
                   f"heads {k}: finite masks differ away from the overflow edge")
            errs.append(float(((ya - yb).abs() / yb.abs().clamp(min=1.0))[both].max()))
        print(f"  heads {k}: K3 vs einsum upsample, max logit error / max(|logit|, 1): "
              f"fp32 store {errs[0]:.4e} (tolerance 1e-3), bf16 store {errs[1]:.4e}; "
              f"finite share {float(torch.isfinite(hk[k]).float().mean()):.6f}")
        expect(errs[0] <= 1e-3, f"heads {k}: {errs[0]} over tolerance")

    # the end-to-end outputs of the two paths, for the record
    for k in ("extrinsic", "intrinsic", "depth_map", "point_map"):
        a, b, c = out[k].float(), plain[k].float(), f32[k].float()
        both = torch.isfinite(a) & torch.isfinite(b) & torch.isfinite(c)
        print(f"  end to end {k}: kernel vs plain max_abs "
              f"{float((a - b)[both].abs().max()):.4e}, plain bf16 vs fp32 "
              f"{float((b - c)[both].abs().max()):.4e}")
    for k in ("extrinsic", "intrinsic", "cam_tokens"):
        expect(bool(torch.isfinite(out[k]).all()), f"{k}: non-finite values")
    if failures:
        raise AssertionError("; ".join(failures))

    # where the time goes: the trunk and the heads alone, then one forward
    # under the profiler, device time grouped by kernel class
    trunk_ms = _wall_ms(lambda: agg(cfg, params))
    heads_ms = _wall_ms(lambda: M._decode_heads(params, cfg, tk, ck, (IMG, IMG), psi))
    print(f"  trunk (aggregator) {trunk_ms:.2f} ms, heads {heads_ms:.2f} ms (median of 3)")
    print("  profile of the main path (every kernel on):")
    breakdown = profile_forward(lambda: fwd(cfg, params))
    print("  profile with the fused block kernels off:")
    unfused_breakdown = profile_forward(lambda: fwd(cfg_unfused, params))
    fps = NUM_FRAMES / step
    for name, sec, gb, n in (("main path (every kernel on)", step, peak_gb, len(times)),
                             ("fused block kernels off", unfused_step, unfused_peak_gb,
                              len(unfused_times)),
                             ("every site on plain PyTorch", plain_step, plain_peak_gb, 1)):
        print(f"  forward, {name}: {sec * 1e3:.2f} ms median of {n} "
              f"({NUM_FRAMES / sec:.3f} frames/s, {NUM_FRAMES} frames of {IMG} px), "
              f"peak memory {gb:.2f} GB")
    state = dict(cfg=cfg, cfg_plain=cfg_plain, cfg_f32=cfg_f32, params=params, p32=p32,
                 uniq=uniq, draw=draw, taps=tk, wrappers=wrappers,
                 out_host={k: out[k].cpu() for k in PRETRAINED_KEYS},
                 default_launches=n_default, on_f32_launches=n_on)
    return launches, state, dict(
        step_ms=step * 1e3, frames_per_s=fps, peak_gb=peak_gb,
        default_step_ms=default_step * 1e3, default_peak_gb=default_peak_gb,
        default_times_ms=[t * 1e3 for t in default_times],
        default_dense_step_ms=default_dense_step * 1e3,
        default_dense_peak_gb=default_dense_peak_gb,
        default_dense_times_ms=[t * 1e3 for t in default_dense_times],
        on_f32_step_ms=on_step * 1e3, on_f32_peak_gb=on_peak_gb,
        on_f32_times_ms=[t * 1e3 for t in on_times],
        on_f32_default_step_ms=on_default_step * 1e3,
        on_f32_default_peak_gb=on_default_peak_gb,
        on_f32_default_times_ms=[t * 1e3 for t in on_default_times],
        on_f32_agreement=on_agree, on_f32_profile=on_profile,
        times_ms=[t * 1e3 for t in times],
        unfused_step_ms=unfused_step * 1e3, unfused_frames_per_s=NUM_FRAMES / unfused_step,
        unfused_peak_gb=unfused_peak_gb, unfused_times_ms=[t * 1e3 for t in unfused_times],
        plain_step_ms=plain_step * 1e3, plain_frames_per_s=NUM_FRAMES / plain_step,
        plain_peak_gb=plain_peak_gb,
        trunk_ms=trunk_ms, heads_ms=heads_ms, profile=breakdown,
        unfused_profile=unfused_breakdown)


def run_serving(state):
    """Phase 4: two-phase serving at full width through the kernels: launch
    counts, agreement with the plain path and with the joint forward, timings,
    and the chunked / host-staged variants on a 20-anchor scene."""
    import torch

    from self_supervise_sfm_tpu_torch.layers.block import qkv_parts
    from self_supervise_sfm_tpu_torch.models import aggregator as AG
    from self_supervise_sfm_tpu_torch.models import sailrecon as M
    from self_supervise_sfm_tpu_torch.ops import attention_core as AC
    from self_supervise_sfm_tpu_torch.ops import flash_attention as FA
    from self_supervise_sfm_tpu_torch.ops.mask_spec import RelocMask

    cfg, cfg_plain, cfg_f32 = state["cfg"], state["cfg_plain"], state["cfg_f32"]
    params, p32, uniq, draw = state["params"], state["p32"], state["uniq"], state["draw"]
    wrappers = state["wrappers"]
    acfg = cfg.aggregator
    failures = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    def counted(fn):
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: w.launches for k, w in wrappers.items()}

    def build(c, p, images=uniq, **kw):
        # the same scene-token subsample as the joint forward of phase 3
        return M.build_scene_cache(p, c, images, rank=RANK, generator=draw(), **kw)

    # -- 1. launch counts around one build, one reloc, one fast reloc --------
    (cache, cam), n_build = counted(lambda: build(cfg, params))
    out, n_reloc = counted(lambda: M.reloc(params, cfg, cache, cam, uniq))
    fast, n_fast = counted(lambda: M.reloc(params, cfg, cache, cam, uniq, fast_reloc=True))
    print(f"  launches in one build: {n_build}")
    print(f"  launches in one reloc: {n_reloc}")
    want_build, want_fast, want_reloc = BUILD_LAUNCHES, FAST_RELOC_LAUNCHES, RELOC_LAUNCHES
    for name, got, want in (("build", n_build, want_build), ("reloc", n_reloc, want_reloc),
                            ("fast_reloc", n_fast, want_fast)):
        if got != want:
            raise AssertionError(f"{name} launch counts {got}, expected {want}")
    kv = cache["kv"]
    nc = NUM_FRAMES * (RANK + 5)
    expect(tuple(kv.shape) == (24, 1, 16, nc, 128) and kv.dtype == torch.bfloat16
           and kv.is_contiguous(), f"cache {tuple(kv.shape)} {kv.dtype}")
    cache_bytes = kv.numel() * kv.element_size()
    print(f"  cache {tuple(kv.shape)} {kv.dtype}: {cache_bytes / 1e6:.1f} MB, "
          f"{cache_bytes / NUM_FRAMES / 1e6:.2f} MB an anchor")
    for k in ("extrinsic", "intrinsic"):
        expect(bool(torch.isfinite(out[k]).all()), f"reloc {k}: non-finite values")
        expect(torch.equal(fast[k], out[k]), f"fast_reloc {k} differs from reloc's")
    expect(tuple(out["point_map"].shape) == (1, NUM_FRAMES, IMG, IMG, 3)
           and tuple(out["xyz_conf_fractions"].shape) == (1, NUM_FRAMES, 18),
           "reloc output shapes")

    # the mask form of reloc layer 0 on the model's own tensors: sdpa with a
    # RelocMask (the masked flash kernel) against the in-place layout form
    def mask_form(params=params, acfg=acfg, kv=None):
        kv = cache["kv"] if kv is None else kv
        tokens, t_frame = AG._reloc_setup(params["aggregator"], acfg, uniq)
        B, Q, Ptok, C = tokens.shape
        fp, rp = (params["aggregator"][k][0] for k in ("frame_blocks", "reloc_blocks"))
        t = AG.block(fp, tokens.reshape(B * Q, Ptok, C), acfg.block_cfg, t_frame)
        q, k, v = qkv_parts(rp, t, acfg.block_cfg, t_frame)
        layout = FA.packed_ctx_attention(q, k, v, kv, 0)

        def unfold(x):
            return x.transpose(0, 1).reshape(1, x.shape[1], Q * Ptok, x.shape[3])

        ck, cv = kv[0, ..., :64], kv[0, ..., 64:]
        masked = AC.sdpa(unfold(q), torch.cat([ck, unfold(k)], dim=2),
                         torch.cat([cv, unfold(v)], dim=2),
                         mask=RelocMask(nc, Ptok, Q), impl="auto")
        return unfold(layout), masked

    (layout, masked), n_mask = counted(mask_form)
    if n_mask["flash_fwd_reloc"] != 1 or n_mask["frame_ctx_packed_fwd"] != 1:
        raise AssertionError(f"mask form launch counts {n_mask}")
    err = float((layout.float() - masked.float()).abs().max())
    tol = 4 * 2.0 ** (math.floor(math.log2(float(layout.abs().max()))) - 7)
    _check("reloc layer 0, mask form (K1m) vs layout form (K2p)", err, tol)
    # one body, one walk: the two forms agree bit for bit
    expect(torch.equal(layout, masked), "reloc layer 0: mask form not bit-equal to layout form")
    print(f"  reloc layer 0, mask form bit-equal to layout form: {torch.equal(layout, masked)}")

    # -- 2. agreement with the plain path and with the joint forward ---------
    before = {k: w.launches for k, w in wrappers.items()}
    cache_p, cam_p = build(cfg_plain, params)
    cache_f, cam_f = build(cfg_f32, p32)

    def taps_of(c, p, ca):
        return AG.aggregator_reloc(p["aggregator"], c.aggregator, ca, uniq)[0]

    tp, tf = taps_of(cfg_plain, params, cache_p), taps_of(cfg_f32, p32, cache_f)
    torch.cuda.synchronize()
    if {k: w.launches for k, w in wrappers.items()} != before:
        raise AssertionError("the plain-path build / reloc launched a kernel")
    tk = taps_of(cfg, params, cache)

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    pairs = [("scene cache", kv, cache_p["kv"], cache_f["kv"]),
             ("anchor cam tokens", cam, cam_p, cam_f)]
    pairs += [(f"reloc tap {li}", tk[li], tp[li], tf[li])
              for li in acfg.intermediate_layer_idx]
    envelope = {}
    for name, a, b, c in pairs:
        err, env = rel(a, b), rel(b, c)
        envelope[name] = env
        print(f"  {name}: kernel vs plain rel-RMS {err:.4e}, plain bf16 vs fp32 "
              f"{env:.4e} (tolerance 2x that)")
        expect(err <= 2 * env, f"{name}: {err} over twice the bf16 envelope {env}")
    # the identity the design rests on: reloc against the cache is the joint
    # forward's query half (same math, another program)
    for li in acfg.intermediate_layer_idx:
        err, env = rel(tk[li], state["taps"][li]), envelope[f"reloc tap {li}"]
        same = torch.equal(tk[li], state["taps"][li])
        print(f"  reloc tap {li} vs the joint forward's: rel-RMS {err:.4e} "
              f"({'bit-equal' if same else 'not bit-equal'}; tolerance 2x {env:.4e})")
        expect(err <= 2 * env, f"reloc tap {li} vs joint forward: {err} over 2x {env}")
    del cache_p, cache_f, tp, tf, state["taps"]
    torch.cuda.empty_cache()

    # -- 3. timings at 5 anchors / 5 queries ----------------------------------
    def timed(fn, reps=5):
        """Median seconds, all runs, and the peak memory in GB over them."""
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        return statistics.median(runs), runs, torch.cuda.max_memory_allocated() / 1e9

    res = {"cache_bytes": cache_bytes, "cache_bytes_per_anchor": cache_bytes / NUM_FRAMES}
    held_gb = torch.cuda.memory_allocated() / 1e9  # weights of both dtypes, cache, images
    res["held_gb"] = held_gb
    t, runs, peak = timed(lambda: build(cfg, params))
    res.update(build_ms=t * 1e3, build_runs_ms=[r * 1e3 for r in runs], build_peak_gb=peak)
    t, runs, peak = timed(lambda: M.reloc(params, cfg, cache, cam, uniq))
    res.update(reloc_ms=t * 1e3, reloc_runs_ms=[r * 1e3 for r in runs],
               reloc_frames_per_s=NUM_FRAMES / t, reloc_peak_gb=peak)
    t, runs, peak = timed(lambda: M.reloc(params, cfg, cache, cam, uniq, fast_reloc=True))
    res.update(fast_reloc_ms=t * 1e3, fast_reloc_runs_ms=[r * 1e3 for r in runs],
               fast_reloc_frames_per_s=NUM_FRAMES / t, fast_reloc_peak_gb=peak)
    print(f"  5 anchors: warm build {res['build_ms']:.2f} ms (peak {res['build_peak_gb']:.2f} "
          f"GB); reloc of 5 queries, full heads {res['reloc_ms']:.2f} ms "
          f"({res['reloc_frames_per_s']:.3f} frames/s, peak {res['reloc_peak_gb']:.2f} GB); "
          f"fast_reloc {res['fast_reloc_ms']:.2f} ms "
          f"({res['fast_reloc_frames_per_s']:.3f} frames/s, peak "
          f"{res['fast_reloc_peak_gb']:.2f} GB); {held_gb:.2f} GB held before each "
          f"(fp32 and bf16 weights, cache, images); medians of 5")
    print("  profile of one build (5 anchors):")
    res["build_profile"] = profile_forward(lambda: build(cfg, params))
    print("  profile of one fast_reloc (5 queries):")
    res["fast_reloc_profile"] = profile_forward(
        lambda: M.reloc(params, cfg, cache, cam, uniq, fast_reloc=True))
    print("  profile of one reloc with full heads (5 queries):")
    res["reloc_profile"] = profile_forward(lambda: M.reloc(params, cfg, cache, cam, uniq))
    del cache, out, fast

    # -- 4. a 20-anchor scene: the five images tiled, each copy perturbed -----
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    scene = uniq.repeat(1, 4, 1, 1, 1)
    scene = (scene + 0.02 * torch.randn(scene.shape, generator=g, device="cuda")).clamp(0, 1)
    A20 = scene.shape[1]
    big, cam_big = build(cfg, params, scene)
    nbytes = big["kv"].numel() * big["kv"].element_size()
    expect(tuple(big["kv"].shape) == (24, 1, 16, A20 * (RANK + 5), 128), "20-anchor cache shape")
    print(f"  20 anchors: cache {tuple(big['kv'].shape)}, {nbytes / 1e9:.3f} GB")
    # anchor-chunked builds against the one-shot build. The fused kernels and
    # the flash kernel work row by row, so chunking the rows changes no value
    # of theirs; the library matmuls of the unfused context K/V and the ViT's
    # patch convolution may pick another summation order for another row
    # count. Tolerance: twice the bf16-vs-fp32 envelope of the cache above.
    for label, kw in (("anchor_chunk=5", dict(anchor_chunk=5)),
                      ("anchor_chunk=5, chunk_embed=False",
                       dict(anchor_chunk=5, chunk_embed=False))):
        ch, cam_ch = build(cfg, params, scene, **kw)
        same = torch.equal(ch["kv"], big["kv"]) and torch.equal(cam_ch, cam_big)
        err = rel(ch["kv"], big["kv"])
        print(f"  {label} build vs one-shot: {'bit-equal' if same else 'not bit-equal'}, "
              f"cache rel-RMS {err:.4e}, max abs "
              f"{float((ch['kv'].float() - big['kv'].float()).abs().max()):.4e} "
              f"(tolerance 2x {envelope['scene cache']:.4e})")
        expect(err <= 2 * envelope["scene cache"], f"{label} build: {err} over tolerance")
        del ch
    # host-staged build into pinned memory; staged reloc against it
    host, cam_host = M.build_scene_cache_staged(params, cfg, scene, rank=RANK,
                                                generator=draw(), num_segments=4)
    expect(host["kv"].device.type == "cpu" and host["kv"].is_pinned(),
           "the staged cache is not in pinned host memory")
    expect(torch.equal(host["kv"], big["kv"].cpu()) and torch.equal(cam_host, cam_big.cpu()),
           "staged build differs from the one-shot build")
    t_res = AG.aggregator_reloc(params["aggregator"], acfg, big, uniq)[0]
    t_st = AG.aggregator_reloc_staged(params["aggregator"], acfg, host, uniq, 4)[0]
    same = all(torch.equal(t_res[li], t_st[li]) for li in acfg.intermediate_layer_idx)
    print(f"  staged build == one-shot build, reloc_staged taps == resident reloc taps: "
          f"{'bit-equal' if same else 'NOT bit-equal'}")
    expect(same, "reloc_staged taps are not bit-equal to the resident reloc's")
    full = M.reloc(params, cfg, big, cam_big, uniq)
    staged = M.reloc_staged(params, cfg, host, cam_host, uniq, num_segments=4)
    chunked = M.reloc_chunked(params, cfg, big, cam_big, uniq, chunk=2)
    for k in ("extrinsic", "intrinsic", "cam_tokens", "depth_map"):
        expect(torch.equal(staged[k], full[k]), f"reloc_staged {k} differs from reloc's")
    # chunks of 2 frames (the last one padded): the trunk kernels work frame
    # by frame, so the camera tokens must not move. cuDNN may pick another
    # algorithm for a head convolution at batch 2: with the final upsample
    # stored in fp32 that is fp32 rounding, held on the logit scale to the
    # tolerance of phase 3's head check; with the path's bf16 store a value
    # may round to its neighbour, and that error is printed for the record.
    same = torch.equal(chunked["cam_tokens"], full["cam_tokens"])
    cfg32 = dataclasses.replace(
        cfg, point=dataclasses.replace(cfg.point, final_upsample_dtype="float32"),
        depth=dataclasses.replace(cfg.depth, final_upsample_dtype="float32"))
    errs = []
    for a, b in ((M.reloc_chunked(params, cfg32, big, cam_big, uniq, chunk=2),
                  M.reloc(params, cfg32, big, cam_big, uniq)), (chunked, full)):
        ya, yb = _logit("depth_map", a["depth_map"]), _logit("depth_map", b["depth_map"])
        both = torch.isfinite(ya) & torch.isfinite(yb)
        errs.append(float(((ya - yb).abs() / yb.abs().clamp(min=1.0))[both].max()))
    del a, b
    print(f"  reloc_chunked(chunk=2) vs reloc: cam tokens "
          f"{'bit-equal' if same else 'not bit-equal'} (rel-RMS "
          f"{rel(chunked['cam_tokens'], full['cam_tokens']):.4e}), depth logits max error "
          f"fp32 store {errs[0]:.4e} (tolerance 1e-3), bf16 store {errs[1]:.4e}")
    expect(rel(chunked["cam_tokens"], full["cam_tokens"]) <= 2 * envelope["reloc tap 23"],
           "reloc_chunked cam tokens over tolerance")
    expect(tuple(chunked["point_map"].shape) == tuple(full["point_map"].shape)
           and errs[0] <= 1e-3, f"reloc_chunked depth: {errs[0]}")
    del full, staged, chunked, t_res, t_st
    torch.cuda.empty_cache()

    big_res = {"anchors": A20, "cache_bytes": nbytes}
    for name, fn in (
        ("build", lambda: build(cfg, params, scene)),
        ("build_chunk5", lambda: build(cfg, params, scene, anchor_chunk=5)),
        ("build_staged4", lambda: M.build_scene_cache_staged(
            params, cfg, scene, rank=RANK, generator=draw(), num_segments=4)),
        ("build_staged4_chunk5", lambda: M.build_scene_cache_staged(
            params, cfg, scene, rank=RANK, generator=draw(), num_segments=4,
            anchor_chunk=5)),
        ("fast_reloc", lambda: M.reloc(params, cfg, big, cam_big, uniq, fast_reloc=True)),
        ("fast_reloc_staged4", lambda: M.reloc_staged(
            params, cfg, host, cam_host, uniq, num_segments=4, fast_reloc=True)),
        ("reloc", lambda: M.reloc(params, cfg, big, cam_big, uniq)),
        ("reloc_chunked2", lambda: M.reloc_chunked(params, cfg, big, cam_big, uniq, chunk=2)),
    ):
        t, runs, peak = timed(fn, reps=3)
        big_res[name] = dict(ms=t * 1e3, runs_ms=[r * 1e3 for r in runs], peak_gb=peak)
        print(f"  20 anchors, {name}: {t * 1e3:.2f} ms median of 3, peak {peak:.2f} GB")
    # one segment's copies alone: device -> pinned host and back
    seg = big["kv"][:6]
    pinned = torch.empty(seg.shape, dtype=seg.dtype, pin_memory=True)
    d2h = _time_ms(lambda: pinned.copy_(seg, non_blocking=True), reps=5)
    h2d = _time_ms(lambda: pinned.to("cuda", non_blocking=True), reps=5)
    seg_bytes = seg.numel() * seg.element_size()
    big_res.update(segment_bytes=seg_bytes, segment_d2h_ms=d2h, segment_h2d_ms=h2d)
    print(f"  one segment of 6 layers, {seg_bytes / 1e6:.1f} MB: to pinned host {d2h:.3f} ms "
          f"({seg_bytes / d2h / 1e6:.1f} GB/s), back {h2d:.3f} ms "
          f"({seg_bytes / h2d / 1e6:.1f} GB/s); staged build - one-shot build = "
          f"{big_res['build_staged4']['ms'] - big_res['build']['ms']:.2f} ms for 4 copies "
          f"out, staged fast_reloc - resident = "
          f"{big_res['fast_reloc_staged4']['ms'] - big_res['fast_reloc']['ms']:.2f} ms for 4 "
          f"copies in")
    res["scene20"] = big_res
    del big, cam_big, host, cam_host, seg, pinned
    torch.cuda.empty_cache()

    # -- 5. the default configuration (fp32, "auto") with phase 3's fp32
    # weights: the build on K1's fp32 form, reloc and fast_reloc on K1's and
    # K2p's, an fp32 cache; against the fp32 plain path at rel-RMS 1e-5 -----
    cfg_d = M.make_config()
    (cache_d, cam_d), n_build_d = counted(lambda: build(cfg_d, p32))
    out_d, n_reloc_d = counted(lambda: M.reloc(p32, cfg_d, cache_d, cam_d, uniq))
    fast_d, n_fast_d = counted(lambda: M.reloc(p32, cfg_d, cache_d, cam_d, uniq,
                                               fast_reloc=True))
    for name, got, want in (("build", n_build_d, DEFAULT_BUILD_LAUNCHES),
                            ("reloc", n_reloc_d, DEFAULT_RELOC_LAUNCHES),
                            ("fast_reloc", n_fast_d, DEFAULT_FAST_RELOC_LAUNCHES)):
        print(f"  default configuration (fp32): launches in one {name}: "
              f"{ {k: n for k, n in got.items() if n} }")
        if got != want:
            raise AssertionError(f"default configuration {name} launch counts {got}, "
                                 f"expected {want}")
    kvd = cache_d["kv"]
    per_anchor = kvd.numel() * kvd.element_size() / NUM_FRAMES
    print(f"  default configuration cache {tuple(kvd.shape)} {kvd.dtype}: "
          f"{per_anchor:.0f} bytes an anchor")
    expect(tuple(kvd.shape) == (24, 1, 16, nc, 128) and kvd.dtype == torch.float32
           and kvd.is_contiguous() and per_anchor == 59_965_440,
           f"default configuration cache {tuple(kvd.shape)} {kvd.dtype}, {per_anchor} bytes "
           "an anchor")
    for k in ("extrinsic", "intrinsic"):
        expect(torch.equal(fast_d[k], out_d[k]), f"default fast_reloc {k} differs from reloc's")
    # the mask form of reloc layer 0 in fp32: K1m's fp32 form against K2p's,
    # one walk on the FFMA body, bit for bit
    (layout_d, masked_d), n_mask_d = counted(
        lambda: mask_form(p32, cfg_d.aggregator, cache_d["kv"]))
    if n_mask_d["flash_fwd_reloc_f32"] != 1 or n_mask_d["frame_ctx_packed_fwd_f32"] != 1:
        raise AssertionError(f"default configuration mask form launch counts {n_mask_d}")
    expect(torch.equal(layout_d, masked_d),
           "default configuration reloc layer 0: mask form (K1m fp32) not bit-equal to the "
           "layout form (K2p fp32)")
    print(f"  default configuration, reloc layer 0, mask form (K1m fp32) bit-equal to the "
          f"layout form (K2p fp32): {torch.equal(layout_d, masked_d)}")
    del layout_d, masked_d
    before = {k: w.launches for k, w in wrappers.items()}
    cache_f, cam_f = build(cfg_f32, p32)
    tf = taps_of(cfg_f32, p32, cache_f)
    out_f = M.reloc(p32, cfg_f32, cache_f, cam_f, uniq)
    torch.cuda.synchronize()
    if {k: w.launches for k, w in wrappers.items()} != before:
        raise AssertionError("the fp32 plain-path build / reloc launched an attention kernel")
    td = taps_of(cfg_d, p32, cache_d)
    for name, a, b in ([("scene cache", kvd, cache_f["kv"]), ("anchor cam tokens", cam_d, cam_f)]
                       + [(f"reloc tap {li}", td[li], tf[li])
                          for li in acfg.intermediate_layer_idx]
                       + [(f"reloc {k}", out_d[k], out_f[k])
                          for k in ("extrinsic", "intrinsic", "cam_tokens")]):
        err = rel(a, b)
        print(f"  default configuration {name}: vs the fp32 plain path rel-RMS {err:.4e} "
              f"(tolerance 1e-5)")
        expect(err <= 1e-5, f"default configuration {name}: {err} over 1e-5")
    del td, out_d, fast_d
    dflt = {}
    for name, fn in (("build", lambda: build(cfg_d, p32)),
                     ("reloc", lambda: M.reloc(p32, cfg_d, cache_d, cam_d, uniq)),
                     ("fast_reloc", lambda: M.reloc(p32, cfg_d, cache_d, cam_d, uniq,
                                                    fast_reloc=True))):
        t, runs, peak = timed(fn, reps=3)
        dflt[name] = dict(ms=t * 1e3, runs_ms=[r * 1e3 for r in runs], peak_gb=peak)
        print(f"  default configuration (fp32), 5 anchors, {name}: {t * 1e3:.2f} ms median of 3, "
              f"peak {peak:.2f} GB")
    dflt["cache_bytes_per_anchor"] = per_anchor
    del cache_d, cam_d, kvd
    torch.cuda.empty_cache()

    # -- 6. the fp32 trunk with the fused block kernels on (fused_qkv="on",
    # fused_mlp="on") on the same weights: build, reloc and fast_reloc with
    # every trunk block on the fp32 forms of the five; the same checks ------
    cfg_on = M.make_config(**ON_F32)
    (cache_o, cam_o), n_build_o = counted(lambda: build(cfg_on, p32))
    out_o, n_reloc_o = counted(lambda: M.reloc(p32, cfg_on, cache_o, cam_o, uniq))
    fast_o, n_fast_o = counted(lambda: M.reloc(p32, cfg_on, cache_o, cam_o, uniq,
                                               fast_reloc=True))
    for name, got, want in (("build", n_build_o, ON_F32_BUILD_LAUNCHES),
                            ("reloc", n_reloc_o, ON_F32_RELOC_LAUNCHES),
                            ("fast_reloc", n_fast_o, ON_F32_FAST_RELOC_LAUNCHES)):
        print(f"  fp32 fused-on: launches in one {name}: "
              f"{ {k: n for k, n in got.items() if n} }")
        if got != want:
            raise AssertionError(f"fp32 fused-on {name} launch counts {got}, expected {want}")
    kvo = cache_o["kv"]
    expect(tuple(kvo.shape) == (24, 1, 16, nc, 128) and kvo.dtype == torch.float32,
           f"fp32 fused-on cache {tuple(kvo.shape)} {kvo.dtype}")
    for k in ("extrinsic", "intrinsic"):
        expect(torch.equal(fast_o[k], out_o[k]), f"fp32 fused-on fast_reloc {k} differs from "
                                                 "reloc's")
    to = taps_of(cfg_on, p32, cache_o)
    on_agree = {}
    for name, a, b in ([("scene cache", kvo, cache_f["kv"]), ("anchor cam tokens", cam_o, cam_f)]
                       + [(f"reloc tap {li}", to[li], tf[li])
                          for li in acfg.intermediate_layer_idx]
                       + [(f"reloc {k}", out_o[k], out_f[k])
                          for k in ("extrinsic", "intrinsic", "cam_tokens")]):
        err = rel(a, b)
        on_agree[name] = err
        print(f"  fp32 fused-on {name}: vs the fp32 plain path rel-RMS {err:.4e} "
              f"(tolerance 1e-5)")
        expect(err <= 1e-5, f"fp32 fused-on {name}: {err} over 1e-5")
    del cache_f, cam_f, tf, out_f, to, out_o, fast_o, kvo
    torch.cuda.empty_cache()
    on_f32 = {"agreement": on_agree}
    for name, fn in (("build", lambda: build(cfg_on, p32)),
                     ("reloc", lambda: M.reloc(p32, cfg_on, cache_o, cam_o, uniq)),
                     ("fast_reloc", lambda: M.reloc(p32, cfg_on, cache_o, cam_o, uniq,
                                                    fast_reloc=True))):
        t, runs, peak = timed(fn, reps=3)
        on_f32[name] = dict(ms=t * 1e3, runs_ms=[r * 1e3 for r in runs], peak_gb=peak)
        print(f"  fp32 fused-on, 5 anchors, {name}: {t * 1e3:.2f} ms median of 3, peak "
              f"{peak:.2f} GB (the default configuration's {dflt[name]['ms']:.2f} ms, peak "
              f"{dflt[name]['peak_gb']:.2f} GB, timed before it)")
    res["on_f32"] = on_f32
    del cache_o, cam_o
    torch.cuda.empty_cache()

    # the one-shot fp32 build of the 20-anchor scene on the kernels; its global
    # site is (16, 27480) x (16, 27480): the dense route would store the fp32
    # logits whole, and the softmax's output beside them
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (big_d, cam_big_d), n_build20 = counted(lambda: build(cfg_d, p32, scene))
    t20 = time.perf_counter() - t0
    peak20 = torch.cuda.max_memory_allocated() / 1e9
    n_global = A20 * ((IMG // 14) ** 2 + 5)
    logits_gb = 16 * n_global * n_global * 4 / 1e9
    expect(n_build20 == DEFAULT_BUILD_LAUNCHES, f"20-anchor fp32 build launches {n_build20}")
    expect(tuple(big_d["kv"].shape) == (24, 1, 16, A20 * (RANK + 5), 128)
           and big_d["kv"].dtype == torch.float32 and bool(torch.isfinite(big_d["kv"]).all())
           and bool(torch.isfinite(cam_big_d).all()), "20-anchor fp32 cache")
    print(f"  default configuration (fp32), 20 anchors, one-shot build on the kernels: "
          f"{t20 * 1e3:.2f} ms (cold, one run), peak {peak20:.2f} GB, cache "
          f"{big_d['kv'].numel() * 4 / 1e9:.3f} GB; launches "
          f"{ {k: n for k, n in n_build20.items() if n} }; the dense route's global site "
          f"(16, {n_global}, {n_global}) would store {logits_gb:.1f} GB of fp32 logits, "
          f"{2 * logits_gb:.1f} GB with the softmax's output (computed, not run)")
    dflt["scene20_build"] = dict(ms=t20 * 1e3, peak_gb=peak20, launches=n_build20,
                                 dense_logits_gb=logits_gb)
    res["default"] = dflt
    del big_d, cam_big_d
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return {"build": n_build, "reloc": n_reloc, "mask_form": n_mask,
            "build_default": n_build_d, "reloc_default": n_reloc_d,
            "mask_form_default": n_mask_d,
            "build20_default": n_build20, "build_on_f32": n_build_o,
            "reloc_on_f32": n_reloc_o}, res


def run_d128(state=None):
    """Phase 4b: the model at 8 heads of 128 (``make_config(num_heads=8,
    compute_dtype="bfloat16")``, what the trainer's ``--num-heads 8``
    builds) at full width, weights from its own seed: the forward,
    ``build_scene_cache``, ``reloc`` and ``fast_reloc`` through the head dim
    128 kernels with the flagship's launch counts site for site (no dense
    attention, no plain fused-block chain); trunk taps, anchor camera tokens
    and the scene cache against the plain path of the same configuration
    within twice its bf16-vs-fp32 envelope; reloc taps against the joint
    forward's; reloc layer 0's mask form (K1m) bit-equal to its layout form
    (K2p); the forward timed in turns against the same configuration on the
    dense route with the fused blocks off and against the flagship (16 heads
    of 64: phase 3's weights, or its own when phase 3 did not run); build,
    reloc and ``fast_reloc`` timed; peaks. Then its fp32 leg,
    ``make_config(num_heads=8)`` (fp32, "auto") on the same fp32 weights:
    the forward, the build, ``reloc`` and ``fast_reloc`` with the default
    configuration's launch counts on the fp32 head dim 128 forms
    (``D128_F32_*_LAUNCHES``: no dense attention site), taps, camera tokens,
    cache and poses against the fp32 plain path of the same configuration at
    rel-RMS 1e-5, reloc layer 0's mask form (K1m fp32) bit-equal to its
    layout form (K2p fp32), the forward timed in turns against its dense
    route and against the default configuration at 16 heads of 64 (phase 3's
    fp32 weights), with peaks, build / reloc / ``fast_reloc`` timed (paths
    "forward_d128_f32", "build_d128_f32", "reloc_d128_f32",
    "fast_reloc_d128_f32", "mask_form_d128_f32"). Then the same fp32 model
    under ``fused_qkv="on", fused_mlp="on"`` on the same weights: the
    forward, the build, ``reloc`` and ``fast_reloc`` with
    ``D128_F32_ON_*_LAUNCHES`` (every trunk block on the fused blocks' fp32
    forms, LN+QKV(+RoPE) and the out-projection at head dim 128; no dense
    attention site, no plain fused chain), held to the same fp32 plain path
    at rel-RMS 1e-5, the forward timed in turns with the "auto" leg (paths
    "forward_d128_f32_on", "build_d128_f32_on", "reloc_d128_f32_on",
    "fast_reloc_d128_f32_on"). ``state``: phase 3's."""
    import torch

    from self_supervise_sfm_tpu_torch.layers.block import qkv_parts
    from self_supervise_sfm_tpu_torch.models import aggregator as AG
    from self_supervise_sfm_tpu_torch.models import sailrecon as M
    from self_supervise_sfm_tpu_torch.ops import attention_core as AC
    from self_supervise_sfm_tpu_torch.ops import flash_attention as FA
    from self_supervise_sfm_tpu_torch.ops.mask_spec import RelocMask

    t_start = time.perf_counter()
    wrappers = kernel_wrappers()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 89)
    if state is None:
        print("  phase 3's flagship made here (phase 3 did not run)")
        flag_cfg = M.make_config(compute_dtype="bfloat16")
        flag_p32 = M.init_sailrecon(flag_cfg, gen, device="cuda")
        flag_params = M.cast_trunk_weights(flag_p32, flag_cfg)
        uniq = torch.rand((1, NUM_FRAMES, IMG, IMG, 3), generator=gen, device="cuda")
    else:
        flag_cfg, flag_params, uniq = state["cfg"], state["params"], state["uniq"]
        flag_p32 = state["p32"]
    images = torch.cat([uniq, uniq], dim=1)
    unfused = dict(fused_qkv="off", fused_mlp="off")
    dense = dict(attn_impl="dense", global_attn_impl="dense")
    cfg = M.make_config(num_heads=8, compute_dtype="bfloat16")
    cfg_dense = M.make_config(num_heads=8, compute_dtype="bfloat16", **dense, **unfused)
    cfg_plain = M.make_config(num_heads=8, compute_dtype="bfloat16", resize_impl="einsum",
                              **dense, **unfused)
    cfg_f32 = M.make_config(num_heads=8, resize_impl="einsum", **dense, **unfused)
    acfg = cfg.aggregator
    p32 = M.init_sailrecon(cfg, gen, device="cuda")
    params = M.cast_trunk_weights(p32, cfg)
    failures = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    def draw():
        # the same scene-token subsample for every run compared
        return torch.Generator(device="cuda").manual_seed(SEED + 1)

    def counted(fn):
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: w.launches for k, w in wrappers.items()}

    def fwd(c, p):
        return M.forward(p, c, images, NUM_FRAMES, NUM_FRAMES, rank=RANK, generator=draw(),
                         images_duplicated=True)

    def build(c, p):
        return M.build_scene_cache(p, c, uniq, rank=RANK, generator=draw())

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    # -- launches: the flagship's, site for site, on the head dim 128 forms
    out, n_fwd = counted(lambda: fwd(cfg, params))
    (cache, cam), n_build = counted(lambda: build(cfg, params))
    rel_out, n_reloc = counted(lambda: M.reloc(params, cfg, cache, cam, uniq))
    fast, n_fast = counted(lambda: M.reloc(params, cfg, cache, cam, uniq, fast_reloc=True))
    launches = {"forward_d128": n_fwd, "build_d128": n_build, "reloc_d128": n_reloc,
                "fast_reloc_d128": n_fast}
    for path, want in (("forward_d128", D128_FORWARD_LAUNCHES),
                       ("build_d128", D128_BUILD_LAUNCHES), ("reloc_d128", D128_RELOC_LAUNCHES),
                       ("fast_reloc_d128", D128_FAST_RELOC_LAUNCHES)):
        got = launches[path]
        print(f"  launches in one {path}: { {k: n for k, n in got.items() if n} }")
        if got != want:
            raise AssertionError(f"{path} launch counts {got}, expected {want}")
    kv = cache["kv"]
    nc = NUM_FRAMES * (RANK + 5)
    expect(tuple(kv.shape) == (24, 1, 8, nc, 256) and kv.dtype == torch.bfloat16,
           f"cache {tuple(kv.shape)} {kv.dtype}")
    shapes = {"extrinsic": (1, 5, 3, 4), "intrinsic": (1, 5, 3, 3), "cam_tokens": (1, 5, 2048),
              "point_map": (1, 5, IMG, IMG, 3), "depth_map": (1, 5, IMG, IMG, 1)}
    for k, shape in shapes.items():
        expect(tuple(out[k].shape) == shape, f"forward {k}: shape {tuple(out[k].shape)}")
    for k in ("extrinsic", "intrinsic", "cam_tokens"):
        expect(bool(torch.isfinite(out[k]).all()), f"forward {k}: non-finite values")
    for k in ("extrinsic", "intrinsic"):
        expect(bool(torch.isfinite(rel_out[k]).all()), f"reloc {k}: non-finite values")
        expect(torch.equal(fast[k], rel_out[k]), f"fast_reloc {k} differs from reloc's")

    # -- agreement with the plain path of the same configuration -------------
    def agg(c, p):
        return AG.aggregator_forward(p["aggregator"], c.aggregator, images, NUM_FRAMES,
                                     NUM_FRAMES, RANK, generator=draw(), images_duplicated=True)

    tk, _, ck = agg(cfg, params)
    for w in wrappers.values():
        w.launches = 0
    tp, _, cp = agg(cfg_plain, params)
    tf, _, cf = agg(cfg_f32, p32)
    cache_p, cam_p = build(cfg_plain, params)
    cache_f, cam_f = build(cfg_f32, p32)

    def taps_of(c, p, ca):
        return AG.aggregator_reloc(p["aggregator"], c.aggregator, ca, uniq)[0]

    rp, rf = taps_of(cfg_plain, params, cache_p), taps_of(cfg_f32, p32, cache_f)
    torch.cuda.synchronize()
    if any(w.launches for w in wrappers.values()):
        raise AssertionError("the plain path of the head dim 128 model launched a kernel")
    rk = taps_of(cfg, params, cache)
    agreement = {}
    pairs = [(f"tap {li}", tk[li], tp[li], tf[li]) for li in acfg.intermediate_layer_idx]
    pairs += [("anchor cam tokens", ck, cp, cf), ("scene cache", kv, cache_p["kv"], cache_f["kv"]),
              ("build cam tokens", cam, cam_p, cam_f)]
    pairs += [(f"reloc tap {li}", rk[li], rp[li], rf[li]) for li in acfg.intermediate_layer_idx]
    for name, a, b, c in pairs:
        err, env = rel(a, b), rel(b, c)
        agreement[name] = [err, env]
        print(f"  d128 {name}: kernel vs plain rel-RMS {err:.4e}, plain bf16 vs fp32 "
              f"{env:.4e} (tolerance 2x that)")
        expect(err <= 2 * env, f"d128 {name}: {err} over twice the bf16 envelope {env}")
    # the reloc against the cache is the joint forward's query half
    for li in acfg.intermediate_layer_idx:
        err, env = rel(rk[li], tk[li]), agreement[f"reloc tap {li}"][1]
        print(f"  d128 reloc tap {li} vs the joint forward's: rel-RMS {err:.4e} "
              f"({'bit-equal' if torch.equal(rk[li], tk[li]) else 'not bit-equal'}; tolerance "
              f"2x {env:.4e})")
        expect(err <= 2 * env, f"d128 reloc tap {li} vs joint forward: {err} over 2x {env}")
    del tp, cp, cache_p, cam_p, rp, rk, tk, ck
    torch.cuda.empty_cache()

    # -- reloc layer 0 in mask form (K1m) against its layout form (K2p) ------
    def mask_form(pa=params["aggregator"], a=acfg, kv=kv):
        tokens, t_frame = AG._reloc_setup(pa, a, uniq)
        B, Q, Ptok, C = tokens.shape
        fp, rp_ = (pa[k][0] for k in ("frame_blocks", "reloc_blocks"))
        t = AG.block(fp, tokens.reshape(B * Q, Ptok, C), a.block_cfg, t_frame)
        q, k, v = qkv_parts(rp_, t, a.block_cfg, t_frame)
        layout = FA.packed_ctx_attention(q, k, v, kv, 0)
        d = q.shape[-1]

        def unfold(x):
            return x.transpose(0, 1).reshape(1, x.shape[1], Q * Ptok, d)

        masked = AC.sdpa(unfold(q), torch.cat([kv[0, ..., :d], unfold(k)], dim=2),
                         torch.cat([kv[0, ..., d:], unfold(v)], dim=2),
                         mask=RelocMask(nc, Ptok, Q), impl="auto")
        return unfold(layout), masked

    (layout, masked), n_mask = counted(mask_form)
    launches["mask_form_d128"] = n_mask
    if n_mask["flash_fwd_reloc_d128"] != 1 or n_mask["frame_ctx_packed_fwd_d128"] != 1:
        raise AssertionError(f"d128 mask form launch counts {n_mask}")
    same = torch.equal(layout, masked)
    print(f"  d128 reloc layer 0, mask form (K1m) bit-equal to layout form (K2p): {same}")
    expect(same, "d128 reloc layer 0: mask form not bit-equal to layout form")
    del layout, masked

    # -- the fp32 legs: make_config(num_heads=8), "auto" and "on" -----------
    cfg32 = M.make_config(num_heads=8)
    cfg32_on = M.make_config(num_heads=8, **ON_F32)
    cfg32_dense = M.make_config(num_heads=8, **dense)
    flag_cfg32 = M.make_config()
    # the fp32 plain path of the same configuration (dense attention)
    before = {k: w.launches for k, w in wrappers.items()}
    out_f = fwd(cfg_f32, p32)
    rel_f = M.reloc(p32, cfg_f32, cache_f, cam_f, uniq)
    torch.cuda.synchronize()
    if {k: w.launches for k, w in wrappers.items()} != before:
        raise AssertionError("the fp32 plain path of the head dim 128 model launched a kernel")

    # the intrinsics on the scale the camera head emits them, the FoV (2 atan
    # of half the image over the focal): the focal, (H / 2) / tan(FoV / 2),
    # magnifies a FoV near 0 (the relu'd FoV head's at random weights) by
    # 1 / FoV; its own distance is printed beside it
    def fov(k):
        return 2.0 * torch.atan((IMG / 2.0) / torch.stack([k[..., 1, 1], k[..., 0, 0]], -1))

    def fp32_leg(c, label, tag, wants):
        """The fp32 model under ``c``: the forward, the build, ``reloc`` and
        ``fast_reloc`` with the launch counts ``wants`` (paths
        "<path>_d128_f32<tag>"), ``fast_reloc``'s poses equal to ``reloc``'s,
        taps, camera tokens, cache and poses against the fp32 plain path at
        rel-RMS 1e-5. Returns the cache, the build's camera tokens and the
        agreement."""
        out, n_fwd = counted(lambda: fwd(c, p32))
        (cache, cam), n_build = counted(lambda: build(c, p32))
        rel_out, n_reloc = counted(lambda: M.reloc(p32, c, cache, cam, uniq))
        fast, n_fast = counted(lambda: M.reloc(p32, c, cache, cam, uniq, fast_reloc=True))
        for path, got, want in zip(("forward", "build", "reloc", "fast_reloc"),
                                   (n_fwd, n_build, n_reloc, n_fast), wants):
            path = f"{path}_d128_f32{tag}"
            launches[path] = got
            print(f"  launches in one {path}: { {k: n for k, n in got.items() if n} }")
            if got != want:
                raise AssertionError(f"{path} launch counts {got}, expected {want}")
        for k in ("extrinsic", "intrinsic"):
            expect(torch.equal(fast[k], rel_out[k]), f"{label} fast_reloc {k} differs from reloc's")
        tk, _, ck = agg(c, p32)
        rk = taps_of(c, p32, cache)
        pairs = [(f"tap {li}", tk[li], tf[li]) for li in acfg.intermediate_layer_idx]
        pairs += [("anchor cam tokens", ck, cf), ("scene cache", cache["kv"], cache_f["kv"]),
                  ("build cam tokens", cam, cam_f)]
        pairs += [(f"reloc tap {li}", rk[li], rf[li]) for li in acfg.intermediate_layer_idx]
        for name, a, b in (("forward", out, out_f), ("reloc", rel_out, rel_f)):
            pairs += [(f"{name} extrinsic", a["extrinsic"], b["extrinsic"]),
                      (f"{name} intrinsic as FoV", fov(a["intrinsic"]), fov(b["intrinsic"])),
                      (f"{name} cam_tokens", a["cam_tokens"], b["cam_tokens"])]
            focal = rel(a["intrinsic"], b["intrinsic"])
            print(f"  {label} {name} intrinsic (focal): rel-RMS {focal:.4e} against the fp32 "
                  f"plain path, for the record (smallest FoV "
                  f"{float(fov(b['intrinsic']).min()):.3e} rad)")
        agree = {}
        for name, a, b in pairs:
            agree[name] = err = rel(a, b)
            print(f"  {label} {name}: kernels vs the fp32 plain path rel-RMS {err:.4e} "
                  f"(tolerance 1e-5)")
            expect(err <= 1e-5, f"{label} {name}: {err} over 1e-5")
        return cache, cam, agree

    cache32, cam32, agree32 = fp32_leg(
        cfg32, "d128 fp32", "", (D128_F32_FORWARD_LAUNCHES, D128_F32_BUILD_LAUNCHES,
                                 D128_F32_RELOC_LAUNCHES, D128_F32_FAST_RELOC_LAUNCHES))
    kv32 = cache32["kv"]
    per_anchor32 = kv32.numel() * kv32.element_size() / NUM_FRAMES
    expect(tuple(kv32.shape) == (24, 1, 8, nc, 256) and kv32.dtype == torch.float32
           and per_anchor32 == 59_965_440,
           f"fp32 d128 cache {tuple(kv32.shape)} {kv32.dtype}, {per_anchor32} bytes an anchor")
    # under "on": every trunk block on the fused blocks' fp32 forms,
    # LN+QKV(+RoPE) and the out-projection at head dim 128
    _, _, agree_on = fp32_leg(
        cfg32_on, "d128 fp32 fused-on", "_on",
        (D128_F32_ON_FORWARD_LAUNCHES, D128_F32_ON_BUILD_LAUNCHES, D128_F32_ON_RELOC_LAUNCHES,
         D128_F32_ON_FAST_RELOC_LAUNCHES))
    del tf, cf, cache_f, cam_f, rf, out_f, rel_f
    torch.cuda.empty_cache()
    (layout, masked), n_mask32 = counted(lambda: mask_form(p32["aggregator"], cfg32.aggregator,
                                                           kv32))
    launches["mask_form_d128_f32"] = n_mask32
    if n_mask32["flash_fwd_reloc_d128_f32"] != 1 or n_mask32["frame_ctx_packed_fwd_d128_f32"] != 1:
        raise AssertionError(f"d128 fp32 mask form launch counts {n_mask32}")
    same32 = torch.equal(layout, masked)
    print(f"  d128 fp32 reloc layer 0, mask form (K1m fp32) bit-equal to layout form (K2p "
          f"fp32): {same32}")
    expect(same32, "d128 fp32 reloc layer 0: mask form not bit-equal to layout form")
    del layout, masked

    # -- times: in turns on the one card --------------------------------------
    def timed(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        return runs, torch.cuda.max_memory_allocated() / 1e9

    turns = {"d128": lambda: fwd(cfg, params), "d128_dense_unfused": lambda: fwd(cfg_dense, params),
             "d64": lambda: fwd(flag_cfg, flag_params)}
    runs, peaks = {k: [] for k in turns}, {}
    for name in ("d128", "d128_dense_unfused", "d64", "d64", "d128_dense_unfused", "d128"):
        r, peak = timed(turns[name])
        runs[name] += r
        peaks[name] = max(peaks.get(name, 0.0), peak)
    med = {k: statistics.median(v) for k, v in runs.items()}
    res = dict(forward_ms=med["d128"], forward_runs_ms=runs["d128"], forward_peak_gb=peaks["d128"],
               dense_unfused_ms=med["d128_dense_unfused"],
               dense_unfused_runs_ms=runs["d128_dense_unfused"],
               dense_unfused_peak_gb=peaks["d128_dense_unfused"],
               flagship_ms=med["d64"], flagship_runs_ms=runs["d64"], flagship_peak_gb=peaks["d64"],
               agreement=agreement, mask_form_bit_equal=same,
               cache_bytes_per_anchor=kv.numel() * kv.element_size() / NUM_FRAMES)
    print(f"  d128 forward {med['d128']:.2f} ms (peak {peaks['d128']:.2f} GB); the same model on "
          f"the dense route with the fused blocks off {med['d128_dense_unfused']:.2f} ms (peak "
          f"{peaks['d128_dense_unfused']:.2f} GB, {med['d128_dense_unfused'] / med['d128']:.3f}x); "
          f"the flagship (16 heads of 64) {med['d64']:.2f} ms (peak {peaks['d64']:.2f} GB, "
          f"d128 / d64 {med['d128'] / med['d64']:.3f}x); medians of 6, in turns")
    for name, fn in (("build", lambda: build(cfg, params)),
                     ("reloc", lambda: M.reloc(params, cfg, cache, cam, uniq)),
                     ("fast_reloc", lambda: M.reloc(params, cfg, cache, cam, uniq,
                                                    fast_reloc=True))):
        r, peak = timed(fn)
        res[f"{name}_ms"], res[f"{name}_runs_ms"], res[f"{name}_peak_gb"] = (
            statistics.median(r), r, peak)
    print(f"  d128 5 anchors: build {res['build_ms']:.2f} ms (peak {res['build_peak_gb']:.2f} GB); "
          f"reloc of 5 queries {res['reloc_ms']:.2f} ms (peak {res['reloc_peak_gb']:.2f} GB); "
          f"fast_reloc {res['fast_reloc_ms']:.2f} ms (peak {res['fast_reloc_peak_gb']:.2f} GB); "
          f"cache {res['cache_bytes_per_anchor']:.0f} bytes an anchor; medians of 3")
    # the fp32 leg in turns: its kernels, the same under "on", its dense
    # route, the default configuration at 16 heads of 64 (the flagship's
    # fp32 weights)
    turns32 = {"d128_f32": lambda: fwd(cfg32, p32),
               "d128_f32_on": lambda: fwd(cfg32_on, p32),
               "d128_f32_dense": lambda: fwd(cfg32_dense, p32),
               "d64_f32": lambda: fwd(flag_cfg32, flag_p32)}
    runs32, peaks32 = {k: [] for k in turns32}, {}
    for name in ("d128_f32", "d128_f32_on", "d128_f32_dense", "d64_f32", "d64_f32",
                 "d128_f32_dense", "d128_f32_on", "d128_f32"):
        r, peak = timed(turns32[name], reps=2)
        runs32[name] += r
        peaks32[name] = max(peaks32.get(name, 0.0), peak)
    med32 = {k: statistics.median(v) for k, v in runs32.items()}
    f32 = dict(forward_ms=med32["d128_f32"], forward_runs_ms=runs32["d128_f32"],
               forward_peak_gb=peaks32["d128_f32"], dense_ms=med32["d128_f32_dense"],
               dense_runs_ms=runs32["d128_f32_dense"], dense_peak_gb=peaks32["d128_f32_dense"],
               d64_ms=med32["d64_f32"], d64_runs_ms=runs32["d64_f32"],
               d64_peak_gb=peaks32["d64_f32"], agreement=agree32, mask_form_bit_equal=same32,
               cache_bytes_per_anchor=per_anchor32, on_ms=med32["d128_f32_on"],
               on_runs_ms=runs32["d128_f32_on"], on_peak_gb=peaks32["d128_f32_on"],
               on_agreement=agree_on)
    print(f"  d128 fp32 forward {med32['d128_f32']:.2f} ms (peak {peaks32['d128_f32']:.2f} GB); "
          f"its dense route {med32['d128_f32_dense']:.2f} ms (peak "
          f"{peaks32['d128_f32_dense']:.2f} GB, {med32['d128_f32_dense'] / med32['d128_f32']:.3f}x)"
          f"; the default configuration at 16 heads of 64 {med32['d64_f32']:.2f} ms (peak "
          f"{peaks32['d64_f32']:.2f} GB, d128 / d64 {med32['d128_f32'] / med32['d64_f32']:.3f}x); "
          f"medians of 4, in turns")
    print(f"  d128 fp32 forward under fused_qkv / fused_mlp \"on\" {med32['d128_f32_on']:.2f} ms "
          f"(peak {peaks32['d128_f32_on']:.2f} GB), on / auto "
          f"{med32['d128_f32_on'] / med32['d128_f32']:.3f}x; medians of 4, in turns")
    for name, fn in (("build", lambda: build(cfg32, p32)),
                     ("reloc", lambda: M.reloc(p32, cfg32, cache32, cam32, uniq)),
                     ("fast_reloc", lambda: M.reloc(p32, cfg32, cache32, cam32, uniq,
                                                    fast_reloc=True))):
        r, peak = timed(fn)
        f32[f"{name}_ms"], f32[f"{name}_runs_ms"], f32[f"{name}_peak_gb"] = (
            statistics.median(r), r, peak)
    print(f"  d128 fp32 5 anchors: build {f32['build_ms']:.2f} ms (peak "
          f"{f32['build_peak_gb']:.2f} GB); reloc of 5 queries {f32['reloc_ms']:.2f} ms (peak "
          f"{f32['reloc_peak_gb']:.2f} GB); fast_reloc {f32['fast_reloc_ms']:.2f} ms (peak "
          f"{f32['fast_reloc_peak_gb']:.2f} GB); medians of 3")
    res["f32"] = f32
    del cache32, cam32, kv32
    torch.cuda.empty_cache()
    print("  profile of the d128 forward:")
    res["profile"] = profile_forward(lambda: fwd(cfg, params), label="d128 forward")
    res["seconds"] = time.perf_counter() - t_start
    print(f"  phase 4b: {res['seconds']:.1f} s")
    del params, p32, cache, cam, out, rel_out, fast
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, res


def _hold_fp32_step(label, loss, g, loss_f, gf, subsystems, rel, grads, expect) -> dict:
    """An fp32 step's loss and gradients against the fp32 plain step's
    (``loss_f``, ``gf``: dense attention, no fused block kernel): the loss
    within rtol 1e-4, each subsystem's gradient within rel-RMS 1e-3 and its
    norm within 1e-3, the tolerances of the tensor-parallel fp32 check."""
    from self_supervise_sfm_tpu_torch.train import loop as L

    loss_rel = abs(loss - loss_f) / abs(loss_f)
    print(f"  {label} step: loss {loss:.6f} against the fp32 plain path's {loss_f:.6f} (rel "
          f"{loss_rel:.3e}, tolerance 1e-4)")
    expect(loss_rel <= 1e-4, f"{label} loss: rel {loss_rel} over 1e-4")
    agree = {"loss_rel": loss_rel}
    for name, part in subsystems.items():
        a, b = part(g), part(gf)
        err = rel(a, b)
        na, nb = float(L.global_norm(a)), float(L.global_norm(b))
        norm_err = abs(na - nb) / nb
        agree[name] = dict(rel_rms=err, norm_kernel=na, norm_plain=nb, norm_rel_err=norm_err,
                           bf16_kernel_rel_rms=grads[name]["rel_rms"])
        print(f"  {label} gradient {name}: vs the fp32 plain path rel-RMS {err:.4e} (tolerance "
              f"1e-3; the bf16 kernel path's {grads[name]['rel_rms']:.4e}), norm {na:.6g} vs "
              f"{nb:.6g} (rel {norm_err:.4e}, tolerance 1e-3)")
        expect(err <= 1e-3, f"{label} gradient {name}: rel-RMS {err} over 1e-3")
        expect(norm_err <= 1e-3, f"{label} gradient norm {name}: {norm_err} over 1e-3")
    return agree


def run_train_default(params, tcfg, batch, idx, loss_f, gf, subsystems, rel, grads, expect,
                      heads=None, want=None, label="default configuration (fp32)",
                      b9=("flash_bwd_dq fp32 (B9)", "flash_bwd_dkv fp32 (B9)")):
    """Phase 5, the train step in the default configuration
    (``make_config(remat=True)``: fp32, "auto") on the kernels: every
    attention site on the fp32 forms of K1 and K2 and its backward on B9's
    fp32 pair. One forward and backward of phase 5's state, batch and
    subsample (the step without its Adam update, which runs no kernel):
    its launches against ``DEFAULT_TRAIN_STEP_LAUNCHES``, its loss and
    gradients against the fp32 plain path's (``loss_f``, ``gf``: dense
    attention) at the fp32 tolerances of the tensor-parallel check (loss
    rtol 1e-4, gradient norms 1e-3) and a gradient rel-RMS of 1e-3 a
    subsystem, set before the first run; its time and peak memory in turns
    with the same on the dense route (dense, kernels, kernels, dense); B9
    fp32's device ms from one profiled run (its profile classes ``b9``).
    ``heads``: ``make_config`` arguments of another head layout (phase 5b's
    fp32 leg: ``num_heads=8``, held to ``want``, the launches under the
    fp32 head dim 128 names). Returns the launch counts and the
    measurements."""
    import torch

    from self_supervise_sfm_tpu_torch.models import sailrecon as M
    from self_supervise_sfm_tpu_torch.train import loop as L

    heads = heads or {}
    want = want or DEFAULT_TRAIN_STEP_LAUNCHES
    wrappers = kernel_wrappers()
    cfg_d = M.make_config(remat=True, **heads)
    cfg_dense = M.make_config(remat=True, attn_impl="dense", global_attn_impl="dense", **heads)
    for w in wrappers.values():
        w.launches = 0
    loss_d, _, gd = L.loss_and_grads(params, cfg_d, tcfg, batch, idx)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"  {label} step: launches {({k: n for k, n in launches.items() if n})}")
    if launches != want:
        raise AssertionError(f"{label} step launch counts {launches}, expected {want}")
    agree = _hold_fp32_step(label, float(loss_d), gd, loss_f, gf, subsystems, rel, grads,
                            expect)
    del gd

    def timed(cfg):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        L.loss_and_grads(params, cfg, tcfg, batch, idx)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated() / 1e9

    runs = {"dense": [], "kernels": []}
    for route in ("dense", "kernels", "kernels", "dense"):
        runs[route].append(timed(cfg_d if route == "kernels" else cfg_dense))
    ms = {r: statistics.median(t for t, _ in v) for r, v in runs.items()}
    peak = {r: max(g for _, g in v) for r, v in runs.items()}
    print(f"  {label} forward + backward: kernels "
          f"{[round(t, 2) for t, _ in runs['kernels']]} ms, peak {peak['kernels']:.2f} GB; "
          f"dense route {[round(t, 2) for t, _ in runs['dense']]} ms, peak "
          f"{peak['dense']:.2f} GB (kernels / dense {ms['kernels'] / ms['dense']:.3f})")
    profile = profile_forward(lambda: L.loss_and_grads(params, cfg_d, tcfg, batch, idx),
                              label=f"{label} forward + backward")
    b9_ms = None
    if profile["measured"]:
        b9_ms = {k: profile["classes_ms"][k] for k in b9}
        print(f"  {label} B9 device ms a step: dq {b9_ms[b9[0]]:.2f}, dk/dv "
              f"{b9_ms[b9[1]]:.2f}, both {sum(b9_ms.values()):.2f} (of device busy "
              f"{profile['busy_ms']:.2f})")
    return dict(launches=launches, agreement=agree, runs=runs, ms=ms, peak_gb=peak,
                profile=profile, b9_device_ms=b9_ms)


def run_train_on_f32(params, tcfg, batch, idx, loss_f, gf, subsystems, rel, grads, expect,
                     heads=None, want=None, label="fp32 fused-on"):
    """Phase 5, the train step with the fp32 trunk on the fused block kernels
    (``make_config(remat=True, fused_qkv="on", fused_mlp="on")``): every
    trunk block's forward (and its remat recompute) on the fp32 forms of the
    five, the attention sites as the default configuration's, the fused
    Functions' backward the plain chain's. One forward and backward of phase
    5's state, batch and subsample: its launches against
    ``ON_F32_TRAIN_STEP_LAUNCHES``, its loss and gradients against the fp32
    plain step's (:func:`_hold_fp32_step`), its time and peak memory in turns
    with the default configuration's (auto, on, on, auto, auto, on), the
    fp32 fused kernels' device ms from one profiled run. ``heads``:
    ``make_config`` arguments of another head layout (phase 5b's fp32 "on"
    leg: ``num_heads=8``, held to ``want``, the fused blocks with a head dim
    and the attention under their fp32 head dim 128 names). Returns the
    launch counts and the measurements."""
    import torch

    from self_supervise_sfm_tpu_torch.models import sailrecon as M
    from self_supervise_sfm_tpu_torch.train import loop as L

    heads = heads or {}
    want = want or ON_F32_TRAIN_STEP_LAUNCHES
    wrappers = kernel_wrappers()
    cfg_on = M.make_config(remat=True, **ON_F32, **heads)
    cfg_d = M.make_config(remat=True, **heads)
    for w in wrappers.values():
        w.launches = 0
    loss_o, _, go = L.loss_and_grads(params, cfg_on, tcfg, batch, idx)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"  {label} step: launches {({k: n for k, n in launches.items() if n})}")
    if launches != want:
        raise AssertionError(f"{label} step launch counts {launches}, expected {want}")
    agree = _hold_fp32_step(label, float(loss_o), go, loss_f, gf, subsystems, rel, grads,
                            expect)
    del go

    def timed(cfg):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        L.loss_and_grads(params, cfg, tcfg, batch, idx)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated() / 1e9

    # three a route in turns: one slow run (2.7 s against 1.4 s on an H100)
    # moves the median of two
    runs = {"auto": [], "on": []}
    for route in ("auto", "on", "on", "auto", "auto", "on"):
        runs[route].append(timed(cfg_on if route == "on" else cfg_d))
    ms = {r: statistics.median(t for t, _ in v) for r, v in runs.items()}
    peak = {r: max(g for _, g in v) for r, v in runs.items()}
    print(f"  {label} forward + backward: fused block kernels on "
          f"{[round(t, 2) for t, _ in runs['on']]} ms, peak {peak['on']:.2f} GB; the same "
          f"configuration under auto {[round(t, 2) for t, _ in runs['auto']]} ms, peak "
          f"{peak['auto']:.2f} GB (on / auto {ms['on'] / ms['auto']:.3f})")
    profile = profile_forward(lambda: L.loss_and_grads(params, cfg_on, tcfg, batch, idx),
                              label=f"{label} forward + backward")
    fused = None
    if profile["measured"]:
        fused = {k: profile["classes_ms"][k] for k in profile["classes_ms"]
                 if k.endswith("fp32") or k.startswith("ln_rows fp32")}
        print(f"  {label}: fused block kernels' device ms a step: "
              f"{ {k: round(v, 2) for k, v in fused.items()} } (of device busy "
              f"{profile['busy_ms']:.2f})")
    return dict(launches=launches, agreement=agree, runs=runs, ms=ms, peak_gb=peak,
                profile=profile, fused_device_ms=fused)


def make_train_batch():
    """One scene in the ``IMC2021Scenes`` / ``stack_scenes`` layout: 2 random
    frames of 518 px and 2 pairs (0 -> 1, 1 -> 0) of 10 000
    correspondences each, made with numpy from SEED + 7. The correspondences
    come from known poses and depths in a 640 x 480 original image (focal
    500 px): source pixels and depths (2-8 units) drawn at random, mapped
    through the two poses into the other camera, so the ground truth
    reprojects them exactly."""
    import numpy as np

    rng = np.random.default_rng(SEED + 7)
    S, K, W0, H0 = TRAIN_FRAMES, 10_000, 640, 480
    Kgt = np.array([[500.0, 0.0, W0 / 2], [0.0, 500.0, H0 / 2], [0.0, 0.0, 1.0]])
    a = 0.1  # the second camera: 0.1 rad about y, then a 0.3 / 0.05 shift
    R = [np.eye(3), np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])]
    t = [np.zeros(3), np.array([0.3, 0.0, 0.05])]
    coords, depths = {"src": [], "dst": []}, {"src": [], "dst": []}
    for s_, d_ in ((0, 1), (1, 0)):
        uv = rng.uniform((0.0, 0.0), (W0, H0), size=(K, 2))
        z = rng.uniform(2.0, 8.0, size=K)
        cam = (np.c_[uv, np.ones(K)] @ np.linalg.inv(Kgt).T) * z[:, None]
        world = (cam - t[s_]) @ R[s_]  # R^T (x - t), row vectors
        cam_d = world @ R[d_].T + t[d_]
        proj = cam_d @ Kgt.T
        coords["src"].append(uv)
        coords["dst"].append(proj[:, :2] / proj[:, 2:])
        depths["src"].append(z)
        depths["dst"].append(cam_d[:, 2])
    f32 = np.float32
    batch = {
        "images": rng.uniform(size=(1, S, IMG, IMG, 3)).astype(f32),
        "K_prime_to_K": np.broadcast_to(np.diag([W0 / IMG, H0 / IMG, 1.0]),
                                        (1, S, 3, 3)).astype(f32),
        "src_idx": np.array([[0, 1]], np.int32), "dst_idx": np.array([[1, 0]], np.int32),
        "src_coords": np.stack(coords["src"])[None].astype(f32),
        "dst_coords": np.stack(coords["dst"])[None].astype(f32),
        "src_depth": np.stack(depths["src"])[None].astype(f32),
        "dst_depth": np.stack(depths["dst"])[None].astype(f32),
        "pair_valid": np.ones((1, 2), f32),
    }
    extr = np.stack([np.c_[R[i], t[i]] for i in range(S)]).astype(f32)
    intr = np.linalg.inv(batch["K_prime_to_K"][0]) @ Kgt
    return batch, extr, intr.astype(f32)


def _hold_bf16_grads(label, gk, gp, gf, expect):
    """A bf16 step's gradients on the kernel path (``gk``) against its plain
    path's (``gp``), each subsystem (ViT, aggregator, camera head) by
    rel-RMS and norm within twice the plain path's distance from the fp32
    plain path (``gf``); the numbers, the subsystems and the rel-RMS."""
    from self_supervise_sfm_tpu_torch.train import loop as L

    subsystems = {
        "vit": lambda g: L._flatten(g["aggregator"]["vit"]),
        "agg": lambda g: L._flatten({k: x for k, x in g["aggregator"].items() if k != "vit"}),
        "camera": lambda g: L._flatten(g["camera_head"]),
    }

    def rel(a, b):
        num = sum(float((x.float() - y.float()).pow(2).sum()) for x, y in zip(a, b))
        return math.sqrt(num) / float(L.global_norm(b))

    grads = {}
    for name, part in subsystems.items():
        a, b, c = part(gk), part(gp), part(gf)
        err, env = rel(a, b), rel(b, c)
        na, nb = float(L.global_norm(a)), float(L.global_norm(b))
        norm_err = abs(na - nb) / nb
        grads[name] = dict(rel_rms=err, envelope=env, norm_kernel=na, norm_plain=nb,
                           norm_rel_err=norm_err)
        print(f"  {label}gradient {name}: kernel vs plain rel-RMS {err:.4e}, norm {na:.6g} vs "
              f"{nb:.6g} (rel {norm_err:.4e}); plain bf16 vs fp32 {env:.4e} "
              f"(tolerance 2x that)")
        expect(err <= 2 * env, f"{label}gradient {name}: {err} over twice the envelope {env}")
        expect(norm_err <= 2 * env, f"{label}gradient norm {name}: {norm_err} over twice {env}")
    return grads, subsystems, rel


def run_train(keep: bool = False):
    """Phase 5: the self-supervised train step at full width (ViT-L/14 and
    24 aggregator layers, 518 px, 2 frames a scene duplicated as anchors and
    queries, rank 300, bf16 trunk on fp32 masters, fp32 camera head, Adam
    with a bf16 first moment, each aggregator layer rematerialised:
    ``bench.py:bench_train``'s configuration at the full depth that it cut
    to 12 for a 16 GB TPU). Launch counts of one step against the code's
    prediction, four steps (the first at learning rate 0), finite losses and
    gradient norms, the untouched DPT heads, and the gradients against the
    plain path's (dense attention, fused kernels off) within twice the
    bf16-vs-fp32 envelope the plain path measures; then times, peak memory
    and a profile of one step. Then the same step in the default
    configuration (fp32, "auto", :func:`run_train_default`). ``keep``: leave
    the step, its state, batch and subsample in ``PHASE5["live"]`` for
    phase 5b's turns."""
    import torch

    from self_supervise_sfm_tpu_torch.models import aggregator as AG
    from self_supervise_sfm_tpu_torch.models import sailrecon as M
    from self_supervise_sfm_tpu_torch.train import loop as L
    from self_supervise_sfm_tpu_torch.train import loss as LS

    wrappers = kernel_wrappers()
    plain_sites = dict(attn_impl="dense", global_attn_impl="dense", fused_qkv="off",
                       fused_mlp="off")
    cfg = M.make_config(compute_dtype="bfloat16", remat=True)
    cfg_plain = M.make_config(compute_dtype="bfloat16", remat=True, **plain_sites)
    cfg_f32 = M.make_config(remat=True, **plain_sites)
    tcfg = L.TrainConfig(rank=RANK, num_images=TRAIN_FRAMES, adam_mu_dtype="bfloat16",
                         warmup_steps=1)
    failures = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    t0 = time.perf_counter()
    state = L.init_train_state(cfg, tcfg, torch.Generator(device="cuda").manual_seed(SEED + 7))
    params = state["params"]
    # conditioned as the JAX package's golden loss test conditions its
    # reference model (tests/test_train_step.py): a small pose-branch output
    # whose bias sums to a unit quaternion and 1 rad fields of view over the
    # 4 iterations, so the residuals start inside the CDF's range
    _condition_pose_branch(params)
    n_params = sum(t.numel() for t in L._flatten(params))
    n_trained = sum(t.numel() for k in ("aggregator", "camera_head")
                    for t in L._flatten(params[k]))
    heads0 = [t.clone() for k in ("depth_head", "point_head") for t in L._flatten(params[k])]
    # a sample of trained leaves, to see whether a step moved them
    sample = lambda: [params["aggregator"]["vit"]["blocks"][0]["attn"]["qkv"]["w"],  # noqa: E731
                      params["aggregator"]["global_blocks"][-1]["mlp"]["fc2"]["w"],
                      params["camera_head"]["pose_branch"]["fc2"]["w"]]
    batch_np, extr_gt, intr_gt = make_train_batch()
    batch = L.batch_to_device(batch_np, "cuda")
    torch.cuda.synchronize()
    print(f"  init {time.perf_counter() - t0:.2f} s: {n_params / 1e6:.1f} M parameters, "
          f"{n_trained / 1e6:.1f} M trained (the DPT heads are not in the loss)")
    # the batch's ground truth reprojects its correspondences exactly
    scene = {k: v[0] for k, v in batch.items() if k != "images"}
    gt = LS.scene_residuals(torch.from_numpy(extr_gt).cuda(), torch.from_numpy(intr_gt).cuda(),
                            scene, tcfg.loss)
    gt_max = float(torch.maximum(gt["residuals"].max(), gt["residuals_approx"].max()))
    print(f"  batch: 2 pairs x 10000 correspondences; ground-truth residual max {gt_max:.3e} px")
    expect(gt_max < 1e-2, f"ground-truth residuals up to {gt_max} px")

    P0 = (IMG // 14) ** 2

    def indices(i):
        g = torch.Generator(device="cuda").manual_seed(SEED + 8 + i)
        return AG.draw_subsample_indices(cfg.aggregator, 1, TRAIN_FRAMES, P0, RANK, g)

    step = L.make_train_step(cfg, tcfg)
    before = [t.clone() for t in sample()]
    for w in wrappers.values():
        w.launches = 0
    state, m0 = step(state, batch, indices(0))
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"  launches in one step: {launches}")
    want = {k: TRAIN_STEP_LAUNCHES[k] for k in wrappers}
    if launches != want:
        raise AssertionError(f"train step launch counts {launches}, expected {want}")
    lr0 = float(m0["learning_rate"])
    expect(lr0 == 0.0 and all(torch.equal(a, b) for a, b in zip(before, sample())),
           f"step 0 (learning rate {lr0}) moved the parameters")

    metrics, times = [m0], []
    torch.cuda.reset_peak_memory_stats()
    for i in (1, 2, 3):
        before = [t.clone() for t in sample()]
        t0 = time.perf_counter()
        state, m = step(state, batch, indices(i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append(m)
        if i == 1:
            expect(all(not torch.equal(a, b) for a, b in zip(before, sample())),
                   "step 1 (learning rate > 0) left a sampled parameter unchanged")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # what phase 10's sharded steps are held to, bit for bit
    PHASE5.update(sample=[t.cpu() for t in sample()], ms=[t * 1e3 for t in times],
                  metrics=[{k: float(x) for k, x in m.items()} for m in metrics])
    keys = ("loss", "loss_cdf_exact", "loss_cdf_approx", "mean_log_residual",
            "log_residual_p50", "grad_norm", "grad_norm_vit", "grad_norm_agg",
            "grad_norm_camera", "learning_rate")
    for i, m in enumerate(metrics):
        vals = {k: float(m[k]) for k in m}
        print(f"  step {i}: " + ", ".join(f"{k} {vals[k]:.6g}" for k in keys))
        expect(all(math.isfinite(x) for x in vals.values()), f"step {i}: non-finite metrics")
        for k in ("grad_norm_vit", "grad_norm_agg", "grad_norm_camera"):
            expect(vals[k] > 0, f"step {i}: {k} = {vals[k]}")
        expect(vals["grad_norm_depth"] == 0 and vals["grad_norm_point"] == 0,
               f"step {i}: nonzero DPT head gradient norms")
    heads = [t for k in ("depth_head", "point_head") for t in L._flatten(params[k])]
    expect(all(torch.equal(a, b) for a, b in zip(heads0, heads)), "a DPT head changed")
    del heads0, heads

    # gradients of the kernel path against the plain path, same state and
    # subsample; the envelope is what bf16 moves the plain path from fp32
    idx = indices(99)
    for w in wrappers.values():
        w.launches = 0
    loss_k, _, gk = L.loss_and_grads(params, cfg, tcfg, batch, idx)
    loss_p, _, gp = L.loss_and_grads(params, cfg_plain, tcfg, batch, idx)
    loss_f, _, gf = L.loss_and_grads(params, cfg_f32, tcfg, batch, idx)
    torch.cuda.synchronize()
    n_kernel = sum(w.launches for w in wrappers.values())
    print(f"  loss: kernel path {float(loss_k):.6f}, plain {float(loss_p):.6f}, "
          f"plain fp32 {float(loss_f):.6f}")
    grads, subsystems, rel = _hold_bf16_grads("", gk, gp, gf, expect)
    del gk, gp
    default = run_train_default(params, tcfg, batch, idx, float(loss_f), gf, subsystems, rel,
                                grads, expect)
    on_f32 = run_train_on_f32(params, tcfg, batch, idx, float(loss_f), gf, subsystems, rel,
                              grads, expect)
    del gf

    # remat: nothing on the kernel path sums with atomics but the loss's
    # histograms (index_add_); the gradients with the layers rematerialised,
    # again, and held, for the record
    cfg_held = M.make_config(compute_dtype="bfloat16", remat=False)
    runs = [L.loss_and_grads(params, c, tcfg, batch, idx)[2]
            for c in (cfg, cfg, cfg_held)]
    flat = [L._flatten(g) for g in runs]

    def equal_share(a, b):
        return sum(bool(torch.equal(x, y)) for x, y in zip(a, b)) / len(a)

    remat = dict(repeat_bit_equal_share=equal_share(flat[0], flat[1]),
                 held_bit_equal_share=equal_share(flat[0], flat[2]),
                 held_rel_rms=rel(flat[0], flat[2]))
    print(f"  remat: leaves bit-equal between two remat runs {remat['repeat_bit_equal_share']:.4f}, "
          f"remat vs held {remat['held_bit_equal_share']:.4f} (rel-RMS "
          f"{remat['held_rel_rms']:.3e})")
    del runs, flat
    if failures:
        raise AssertionError("; ".join(failures))

    step_s = statistics.median(times)
    print("  profile of one train step (every kernel on):")
    profile = profile_forward(lambda: step(state, batch, indices(4)), label="train step")
    b9 = None
    if profile["measured"]:
        b9 = {k: profile["classes_ms"][k] for k in ("flash_bwd_dq (B9)", "flash_bwd_dkv (B9)")}
        print(f"  B9 device ms a step: dq {b9['flash_bwd_dq (B9)']:.2f}, dk/dv "
              f"{b9['flash_bwd_dkv (B9)']:.2f}, both {sum(b9.values()):.2f} (of device busy "
              f"{profile['busy_ms']:.2f})")
    print(f"  train step: {step_s * 1e3:.2f} ms median of {len(times)} "
          f"({[round(t * 1e3, 2) for t in times]}), {1 / step_s:.4f} steps/s, "
          f"peak memory {peak_gb:.2f} GB")
    if keep:
        PHASE5["live"] = dict(step=step, state=state, batch=batch, indices=indices)
    return launches, dict(
        default=default, on_f32=on_f32,
        step_ms=step_s * 1e3, steps_per_s=1 / step_s, times_ms=[t * 1e3 for t in times],
        peak_gb=peak_gb, params_m=n_params / 1e6, trained_m=n_trained / 1e6,
        kernel_launches_gradient_eval=n_kernel,
        metrics=[{k: float(x) for k, x in m.items()} for m in metrics],
        gradients=grads, remat=remat, loss_kernel=float(loss_k), loss_plain=float(loss_p),
        loss_f32=float(loss_f), profile=profile, b9_device_ms=b9)


def _condition_pose_branch(params) -> None:
    """Phase 5's conditioning of a fresh state: a small pose-branch output
    whose bias sums to a unit quaternion and 1 rad fields of view over the 4
    iterations, so the residuals start inside the CDF's range."""
    fc2 = params["camera_head"]["pose_branch"]["fc2"]
    fc2["w"].mul_(0.01)
    fc2["b"].mul_(0.01)
    fc2["b"][[3, 7, 8]] = 0.25


def run_train_d128(live=None, flagship_busy_ms=None):
    """Phase 5b: phase 5's train step at 8 heads of 128
    (``make_config(num_heads=8, compute_dtype="bfloat16", remat=True)``, the
    trainer's ``--num-heads 8``) on a state of its own seed, phase 5's batch
    and subsample draws: the launch counts of one step against
    ``D128_TRAIN_STEP_LAUNCHES`` (phase 5's under the head dim 128 names, B9
    among them: no dense attention left), four steps (the first at learning
    rate 0) with finite losses and gradient norms, the gradients against the
    plain path of the same configuration (dense attention, fused blocks off)
    within twice its bf16-vs-fp32 envelope, the step timed in turns against
    phase 5's flagship step (``live``: ``PHASE5["live"]``, or a flagship
    state made here) and against its own dense route (``attn_impl="dense",
    global_attn_impl="dense"``), the peak with both states resident, and one
    profiled step: device busy and B9's device ms, beside the flagship
    step's device busy (``flagship_busy_ms``: phase 5's profile, or one
    profiled here). Its fp32 leg (:func:`run_train_default` with
    ``num_heads=8``): one forward and backward of the same state, batch
    and subsample in fp32 on the fp32 head dim 128 forms, held to
    ``D128_F32_TRAIN_STEP_LAUNCHES`` and to the fp32 plain step of the same
    configuration (loss rtol 1e-4, gradient norms and rel-RMS 1e-3 a
    subsystem), timed in turns against its dense route, B9's device ms; the
    same under ``fused_qkv="on", fused_mlp="on"`` (:func:`run_train_on_f32`
    with ``num_heads=8``: ``D128_F32_ON_TRAIN_STEP_LAUNCHES``, the same fp32
    plain step, timed in turns against "auto", the fused kernels' device
    ms)."""
    import torch

    from self_supervise_sfm_tpu_torch.models import aggregator as AG
    from self_supervise_sfm_tpu_torch.models import sailrecon as M
    from self_supervise_sfm_tpu_torch.train import loop as L

    t_start = time.perf_counter()
    wrappers = kernel_wrappers()
    dense = dict(attn_impl="dense", global_attn_impl="dense")
    plain_sites = dict(**dense, fused_qkv="off", fused_mlp="off")
    cfg = M.make_config(num_heads=8, compute_dtype="bfloat16", remat=True)
    cfg_dense = M.make_config(num_heads=8, compute_dtype="bfloat16", remat=True, **dense)
    cfg_plain = M.make_config(num_heads=8, compute_dtype="bfloat16", remat=True, **plain_sites)
    cfg_f32 = M.make_config(num_heads=8, remat=True, **plain_sites)
    tcfg = L.TrainConfig(rank=RANK, num_images=TRAIN_FRAMES, adam_mu_dtype="bfloat16",
                         warmup_steps=1)
    failures = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    P0 = (IMG // 14) ** 2

    def indices(i):
        g = torch.Generator(device="cuda").manual_seed(SEED + 8 + i)
        return AG.draw_subsample_indices(cfg.aggregator, 1, TRAIN_FRAMES, P0, RANK, g)

    batch = L.batch_to_device(make_train_batch()[0], "cuda")
    if live is None:
        print("  phase 5's flagship step made here (phase 5 did not run)")
        flag_cfg = M.make_config(compute_dtype="bfloat16", remat=True)
        flag_state = L.init_train_state(flag_cfg, tcfg,
                                        torch.Generator(device="cuda").manual_seed(SEED + 7))
        _condition_pose_branch(flag_state["params"])
        live = dict(step=L.make_train_step(flag_cfg, tcfg), state=flag_state, batch=batch,
                    indices=indices)
    state = L.init_train_state(cfg, tcfg, torch.Generator(device="cuda").manual_seed(SEED + 97))
    params = state["params"]
    _condition_pose_branch(params)
    qn = params["aggregator"]["frame_blocks"][0]["attn"]["q_norm"]["scale"]
    expect(tuple(qn.shape) == (128,), f"q_norm scale {tuple(qn.shape)}")
    sample = lambda: [params["aggregator"]["vit"]["blocks"][0]["attn"]["qkv"]["w"],  # noqa: E731
                      params["aggregator"]["global_blocks"][-1]["mlp"]["fc2"]["w"],
                      params["camera_head"]["pose_branch"]["fc2"]["w"]]

    # -- launches of one step, then four steps ----------------------------------
    step = L.make_train_step(cfg, tcfg)
    before = [t.clone() for t in sample()]
    for w in wrappers.values():
        w.launches = 0
    state, m0 = step(state, batch, indices(0))
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"  launches in one d128 step: { {k: n for k, n in launches.items() if n} }")
    want = {k: D128_TRAIN_STEP_LAUNCHES[k] for k in wrappers}
    if launches != want:
        raise AssertionError(f"d128 train step launch counts {launches}, expected {want}")
    lr0 = float(m0["learning_rate"])
    expect(lr0 == 0.0 and all(torch.equal(a, b) for a, b in zip(before, sample())),
           f"d128 step 0 (learning rate {lr0}) moved the parameters")
    metrics = [m0]
    for i in (1, 2, 3):
        before = [t.clone() for t in sample()]
        state, m = step(state, batch, indices(i))
        metrics.append(m)
        if i == 1:
            torch.cuda.synchronize()
            expect(all(not torch.equal(a, b) for a, b in zip(before, sample())),
                   "d128 step 1 (learning rate > 0) left a sampled parameter unchanged")
    keys = ("loss", "grad_norm", "grad_norm_vit", "grad_norm_agg", "grad_norm_camera",
            "learning_rate")
    for i, m in enumerate(metrics):
        vals = {k: float(x) for k, x in m.items()}
        print(f"  d128 step {i}: " + ", ".join(f"{k} {vals[k]:.6g}" for k in keys))
        expect(all(math.isfinite(x) for x in vals.values()), f"d128 step {i}: non-finite")
        for k in ("grad_norm_vit", "grad_norm_agg", "grad_norm_camera"):
            expect(vals[k] > 0, f"d128 step {i}: {k} = {vals[k]}")

    # -- gradients against the plain path of the same configuration ------------
    idx = indices(99)
    loss_k, _, gk = L.loss_and_grads(params, cfg, tcfg, batch, idx)
    loss_p, _, gp = L.loss_and_grads(params, cfg_plain, tcfg, batch, idx)
    loss_f, _, gf = L.loss_and_grads(params, cfg_f32, tcfg, batch, idx)
    torch.cuda.synchronize()
    print(f"  d128 loss: kernel path {float(loss_k):.6f}, plain {float(loss_p):.6f}, plain "
          f"fp32 {float(loss_f):.6f}")
    grads, subsystems, rel = _hold_bf16_grads("d128 ", gk, gp, gf, expect)
    del gk, gp
    torch.cuda.empty_cache()
    # the fp32 leg: make_config(num_heads=8, remat=True), every attention
    # site on the fp32 forms at 128, against the fp32 plain step above
    f32 = run_train_default(params, tcfg, batch, idx, float(loss_f), gf, subsystems, rel, grads,
                            expect, heads=dict(num_heads=8), want=D128_F32_TRAIN_STEP_LAUNCHES,
                            label="d128 fp32",
                            b9=("flash_bwd_dq d128 fp32 (B9)", "flash_bwd_dkv d128 fp32 (B9)"))
    torch.cuda.empty_cache()
    # and under fused_qkv / fused_mlp "on": every trunk block's forward on the
    # fused blocks' fp32 forms, LN+QKV(+RoPE) and the out-projection at 128
    f32_on = run_train_on_f32(params, tcfg, batch, idx, float(loss_f), gf, subsystems, rel,
                              grads, expect, heads=dict(num_heads=8),
                              want=D128_F32_ON_TRAIN_STEP_LAUNCHES, label="d128 fp32 fused-on")
    del gf
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))

    # -- times in turns: this step, its dense route, phase 5's flagship --------
    step_dense = L.make_train_step(cfg_dense, tcfg)
    holder = {"d128": state, "flag": live["state"]}

    def run(name):
        if name == "flag":
            holder["flag"], _ = live["step"](holder["flag"], live["batch"], live["indices"](5))
        else:
            fn = step if name == "d128" else step_dense
            holder["d128"], _ = fn(holder["d128"], batch, indices(5))

    runs = {"d128": [], "d128_dense": [], "flag": []}
    torch.cuda.reset_peak_memory_stats()
    for name in ("d128", "d128_dense", "flag", "flag", "d128_dense", "d128"):
        if not runs[name]:
            run(name)  # warm
            torch.cuda.synchronize()
        for _ in range(2):
            t0 = time.perf_counter()
            run(name)
            torch.cuda.synchronize()
            runs[name].append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = {k: statistics.median(v) for k, v in runs.items()}
    print(f"  d128 train step {med['d128']:.2f} ms {runs['d128']}; its dense route "
          f"{med['d128_dense']:.2f} ms ({med['d128_dense'] / med['d128']:.3f}x); phase 5's "
          f"flagship step {med['flag']:.2f} ms (d128 / flagship "
          f"{med['d128'] / med['flag']:.3f}x); medians of 4, in turns; peak {peak_gb:.2f} GB "
          f"with both states resident")
    print("  profile of one d128 train step:")
    profile = profile_forward(lambda: run("d128"), label="d128 train step")
    if flagship_busy_ms is None:
        print("  profile of one flagship train step:")
        flag_profile = profile_forward(lambda: run("flag"), label="flagship train step")
        flagship_busy_ms = flag_profile["busy_ms"] if flag_profile["measured"] else None
    b9 = None
    if profile["measured"]:
        cls = profile["classes_ms"]
        b9 = {k: cls[k] for k in ("flash_bwd_dq d128 (B9)", "flash_bwd_dkv d128 (B9)")}
        flag_busy = "not measured" if flagship_busy_ms is None else f"{flagship_busy_ms:.2f}"
        print(f"  B9 d128 device ms a step: dq {b9['flash_bwd_dq d128 (B9)']:.2f}, dk/dv "
              f"{b9['flash_bwd_dkv d128 (B9)']:.2f}, both {sum(b9.values()):.2f} (of device "
              f"busy {profile['busy_ms']:.2f}; the flagship's step {flag_busy})")
    seconds = time.perf_counter() - t_start
    print(f"  phase 5b: {seconds:.1f} s")
    del state, holder, params, step, step_dense
    torch.cuda.empty_cache()
    return {"train_d128": launches, "train_d128_f32": f32["launches"],
            "train_d128_f32_on": f32_on["launches"]}, dict(
        f32=f32, f32_on=f32_on, step_ms=med["d128"], runs_ms=runs["d128"], dense_ms=med["d128_dense"],
        dense_runs_ms=runs["d128_dense"], flagship_ms=med["flag"], flagship_runs_ms=runs["flag"],
        peak_gb_both_states=peak_gb, gradients=grads, loss_kernel=float(loss_k),
        loss_plain=float(loss_p), loss_f32=float(loss_f),
        metrics=[{k: float(x) for k, x in m.items()} for m in metrics],
        profile=profile, flagship_busy_ms=flagship_busy_ms, b9_device_ms=b9,
        seconds=seconds)


class SyntheticScenes:
    """IMC2021-layout scenes made with numpy alone, so that phase 6 needs no
    ``h5py`` (the HDF5 fixture of ``data/synthetic.py`` does): the trainer
    takes this object in place of a data directory (``__len__`` and
    ``load_scene(idx, rng)``). Scene ``idx``: ``num_images`` cameras on a
    ring looking at a textured slanted plane ~5 units away, each frame a 640
    x 480 original (focal 500 px) rendered straight to the processed
    ``img_size`` (padded to square and resized, as ``K_to_K_prime`` maps
    it); every ordered pair gets ``sample_num`` correspondences drawn from
    ``rng`` among the source pixels that land inside the destination frame,
    with both depths, exact by construction."""

    W0, H0, FOCAL = 640, 480, 500.0

    def __init__(self, num_scenes: int, num_images: int, sample_num: int, img_size: int,
                 seed: int, checker: bool = False):
        self.num_scenes, self.num_images = num_scenes, num_images
        self.sample_num, self.img_size, self.seed = sample_num, img_size, seed
        # a fine checkerboard on the plane (squares of ~4.5 px at 518 px):
        # thousands of corners for the keypoint detector, as a photograph has
        self.checker = checker
        self._frames = {}  # idx -> rendered frames (they do not depend on rng)

    def __len__(self) -> int:
        return self.num_scenes

    def _geometry(self, idx: int):
        import numpy as np

        g = np.random.default_rng((self.seed, idx))
        n = np.array([g.uniform(-0.15, 0.15), g.uniform(-0.15, 0.15), 1.0])
        plane = (n / np.linalg.norm(n), -g.uniform(4.5, 5.5))
        tex = g.uniform([1.0, 0.7, 0.0], [3.0, 2.8, 6.28], size=(3, 3))
        poses = []
        for i in range(self.num_images):
            a = 2 * np.pi * i / self.num_images
            eye = np.array([0.5 * np.cos(a), 0.4 * np.sin(a), g.uniform(-0.2, 0.2)])
            z = np.array([0.3 * np.sin(a), 0.2 * np.cos(a), 5.0]) - eye
            z /= np.linalg.norm(z)
            x = np.cross(z, [0.0, -1.0, 0.0])
            x /= np.linalg.norm(x)
            R = np.stack([x, np.cross(z, x), z])
            poses.append(np.c_[R, -R @ eye])
        return plane, tex, np.stack(poses)

    def _hit(self, pose, plane, uv):
        """World points and camera depths where the rays of original-image
        pixels ``uv`` (N, 2) meet the plane."""
        import numpy as np

        R, t = pose[:, :3], pose[:, 3]
        d_cam = np.c_[(uv - [self.W0 / 2, self.H0 / 2]) / self.FOCAL, np.ones(len(uv))]
        origin, d = -R.T @ t, d_cam @ R
        n, c = plane
        s = -(origin @ n + c) / (d @ n)
        return origin + d * s[:, None], s  # depth = s (d_cam has z = 1)

    def _project(self, pose, pts):
        import numpy as np

        cam = pts @ pose[:, :3].T + pose[:, 3]
        K = [[self.FOCAL, 0, self.W0 / 2], [0, self.FOCAL, self.H0 / 2], [0, 0, 1]]
        pix = cam @ np.asarray(K).T
        return pix[:, :2] / pix[:, 2:], cam[:, 2]

    def processed_K(self):
        """The intrinsics in the processed ``img_size`` frame (K_to_K_prime
        @ K_gt)."""
        import numpy as np

        scale = self.img_size / self.W0
        pad = (self.W0 - self.H0) / 2 * scale
        return np.array([[scale * self.FOCAL, 0, scale * self.W0 / 2],
                         [0, scale * self.FOCAL, scale * self.H0 / 2 + pad], [0, 0, 1]])

    def known_tracks(self, idx: int, num_tracks: int, noise_px: float, rng):
        """Tracks of known geometry: plane points seen from camera 0 projected
        into every frame with the true poses and the processed K, plus
        ``noise_px`` Gaussian noise. Returns (tracks (S, N, 2) fp32,
        visibility (S, N), true w2c (S, 3, 4), K (3, 3)); a frame sees a
        point that lands inside it in front of the camera."""
        import numpy as np

        plane, _, poses = self._geometry(idx)
        uv = rng.uniform((0, 0), (self.W0, self.H0), size=(num_tracks, 2))
        pts, _ = self._hit(poses[0], plane, uv)
        K = self.processed_K()
        cam = np.einsum("sij,nj->sni", poses[:, :, :3], pts) + poses[:, None, :, 3]
        pix = np.einsum("ij,snj->sni", K, cam)
        xy = pix[..., :2] / pix[..., 2:]
        vis = ((cam[..., 2] > 0) & (xy >= 0).all(-1) & (xy < self.img_size).all(-1))
        tracks = xy + rng.normal(scale=noise_px, size=xy.shape)
        return tracks.astype(np.float32), vis, poses.astype(np.float32), K

    def load_scene(self, idx: int, rng) -> dict:
        import numpy as np

        plane, tex, poses = self._geometry(idx)
        T, S, N = self.img_size, self.num_images, self.sample_num
        scale = T / self.W0
        pad = (self.W0 - self.H0) / 2 * scale  # the original sits centred in the square
        k2kp = np.array([[scale, 0, 0], [0, scale, pad], [0, 0, 1]], np.float32)
        kp2k = np.linalg.inv(k2kp).astype(np.float32)
        Kgt = np.array([[self.FOCAL, 0, self.W0 / 2], [0, self.FOCAL, self.H0 / 2], [0, 0, 1]],
                       np.float32)
        if idx not in self._frames:
            vv, uu = np.mgrid[0:T, 0:T].astype(np.float64)
            uv = np.c_[uu.ravel(), vv.ravel()] / scale - [0, pad / scale]
            inside = ((uv[:, 0] >= 0) & (uv[:, 0] < self.W0) & (uv[:, 1] >= 0)
                      & (uv[:, 1] < self.H0))
            images, depths = [], []
            for pose in poses:
                pts, depth = self._hit(pose, plane, uv)
                u, v = pts[:, 0] + 0.5 * pts[:, 2], pts[:, 1] - 0.3 * pts[:, 2]
                rgb = np.stack([0.5 + 0.5 * np.sin(f * u + p) * np.cos(g_ * v)
                                for f, g_, p in tex], -1)
                if self.checker:
                    rgb *= 0.55 + 0.45 * (np.sin(60 * u) * np.sin(60 * v) > 0)[:, None]
                images.append(np.where(inside[:, None], rgb, 0.0).reshape(T, T, 3))
                depths.append(np.where(inside, depth, 0.0).reshape(T, T))
            self._frames[idx] = (np.stack(images).astype(np.float32),
                                 np.stack(depths).astype(np.float32))
        images, depths = self._frames[idx]
        pairs = [(i, j) for i in range(S) for j in range(S) if i != j]
        P = len(pairs)
        out = {k: np.zeros(shape, np.float32) for k, shape in (
            ("src_coords", (P, N, 2)), ("dst_coords", (P, N, 2)), ("src_depth", (P, N)),
            ("dst_depth", (P, N)))}
        for p, (i, j) in enumerate(pairs):
            uv = rng.uniform((0, 0), (self.W0, self.H0), size=(3 * N, 2))
            pts, z_src = self._hit(poses[i], plane, uv)
            dst, z_dst = self._project(poses[j], pts)
            ok = np.flatnonzero((dst[:, 0] >= 0) & (dst[:, 0] < self.W0) & (dst[:, 1] >= 0)
                                & (dst[:, 1] < self.H0) & (z_dst > 0))
            take = ok[:N] if len(ok) >= N else rng.choice(ok, N, replace=True)
            out["src_coords"][p], out["dst_coords"][p] = uv[take], dst[take]
            out["src_depth"][p], out["dst_depth"][p] = z_src[take], z_dst[take]
        return {
            "scene_name": f"synthetic_{idx:03d}",
            "image_names": [f"{i:06d}.jpg" for i in range(S)],
            "images": images, "depth_processed": depths,
            "K_to_K_prime": np.broadcast_to(k2kp, (S, 3, 3)).copy(),
            "K_prime_to_K": np.broadcast_to(kp2k, (S, 3, 3)).copy(),
            "K_gt": np.broadcast_to(Kgt, (S, 3, 3)).copy(),
            "poses_w2c_gt": np.concatenate(
                [poses, np.broadcast_to([0.0, 0, 0, 1], (S, 1, 4))], 1).astype(np.float32),
            "src_idx": np.array([i for i, _ in pairs], np.int32),
            "dst_idx": np.array([j for _, j in pairs], np.int32),
            **out, "pair_valid": np.ones(P, np.float32), "shared_focal": False,
        }


def _read_model_equal(model_txt: str, model_bin: str) -> list:
    """The COLMAP model read back from its text and binary files, compared:
    the differences found (text rounds xyz / poses to 10 digits and the
    observations to 1e-4 px)."""
    import numpy as np

    from self_supervise_sfm_tpu_torch.utils.colmap_io import Reconstruction

    a, b = Reconstruction.read_text(model_txt), Reconstruction.read_binary(model_bin)
    bad = []
    if set(a.cameras) != set(b.cameras) or set(a.images) != set(b.images) or (
            set(a.points3d) != set(b.points3d)):
        return ["ids differ"]
    for i in a.images:
        ia, ib = a.images[i], b.images[i]
        if not (np.allclose(ia.qvec_wxyz, ib.qvec_wxyz, atol=1e-9)
                and np.allclose(ia.tvec, ib.tvec, rtol=1e-9, atol=1e-9)
                and np.allclose(ia.xys, ib.xys, atol=1e-4)
                and np.array_equal(ia.point3d_ids, ib.point3d_ids)):
            bad.append(f"image {i}")
    for i in a.points3d:
        pa, pb = a.points3d[i], b.points3d[i]
        if not (np.allclose(pa.xyz, pb.xyz, rtol=1e-9, atol=1e-9) and pa.track == pb.track):
            bad.append(f"point {i}")
    for i in a.cameras:
        if not np.allclose(a.cameras[i].params, b.cameras[i].params, rtol=1e-9):
            bad.append(f"camera {i}")
    return bad


def _rec_residuals(rec):
    """Reprojection residual norms (O,) of every observation of a
    Reconstruction, float64 on the host."""
    import numpy as np

    from self_supervise_sfm_tpu_torch.utils import colmap_io as CIO

    pts, exts, Ks = CIO.reconstruction_to_batch_matrix(rec)
    _, _, ci, pi, uv = CIO.observations(rec)
    cam = np.einsum("oij,oj->oi", exts[ci, :, :3], pts[pi]) + exts[ci, :, 3]
    pix = np.einsum("oij,oj->oi", Ks[ci], cam)
    return np.linalg.norm(pix[:, :2] / pix[:, 2:] - uv, axis=-1)


def _huber_cost(r, delta: float = 4.0) -> float:
    import numpy as np

    return float(np.where(r <= delta, 0.5 * r * r, delta * (r - 0.5 * delta)).sum())


def known_geometry(num_frames: int, num_tracks: int):
    """Phase 7's known-geometry problem: (tracks, vis, the true w2c, the
    perturbed w2c (camera 0 kept), K per frame), from the seed."""
    import numpy as np
    import torch

    from self_supervise_sfm_tpu_torch.ops import geometry as G

    rng = np.random.default_rng((SEED, num_frames, num_tracks))
    scenes = SyntheticScenes(1, num_frames, 16, IMG, SEED + 21)
    tracks, vis, true_w2c, K = scenes.known_tracks(0, num_tracks, 0.5, rng)
    init = true_w2c.copy()
    daa = rng.normal(scale=0.004, size=(num_frames, 3)).astype(np.float32)
    dR = G.axis_angle_to_mat(torch.from_numpy(daa)).numpy()
    init[1:, :, :3] = dR[1:] @ init[1:, :, :3]
    init[1:, :, 3] += rng.normal(scale=0.015, size=(num_frames - 1, 3)).astype(np.float32)
    Ks = np.broadcast_to(K, (num_frames, 3, 3)).astype(np.float32)
    return tracks, vis, true_w2c, init, Ks


def run_known_geometry_ba(num_frames: int, num_tracks: int):
    """Phase 7, bundle adjustment on known geometry: tracks of the synthetic
    plane projected with the true poses and K plus 0.5 px noise, the poses
    perturbed (camera 0 kept: the gauge), then ``tracks_to_reconstruction``
    with the torch engine on the card (twice: its spread) and the native
    engine. Each must bring the reprojection RMSE down to the noise and the
    ATE against the true poses down; the engines' final Huber costs (one
    formula over each output, float64) must agree within 1e-3 relative."""
    import numpy as np

    from self_supervise_sfm_tpu_torch.pipeline import tracking as T
    from self_supervise_sfm_tpu_torch.utils.colmap_io import reconstruction_to_batch_matrix
    from self_supervise_sfm_tpu_torch.utils.evaluation import absolute_trajectory_error

    tracks, vis, true_w2c, init, Ks = known_geometry(num_frames, num_tracks)
    noise_rmse = 0.5 * math.sqrt(2.0)
    failures, res = [], {"frames": num_frames, "tracks": num_tracks,
                         "observations": int(vis.sum())}
    ate0 = absolute_trajectory_error(init, true_w2c)["ate_rmse"]
    outs = {}
    for name, engine in (("torch", "torch"), ("torch_repeat", "torch"), ("native", "native")):
        timings = {}
        t0 = time.perf_counter()
        rec = T.tracks_to_reconstruction(tracks, vis, init, Ks, image_size=(IMG, IMG),
                                         ba_engine=engine, device="cuda", timings=timings)
        wall = time.perf_counter() - t0
        if rec is None:
            raise AssertionError(f"known geometry {num_frames} x {num_tracks}: no point "
                                 "survived the gating")
        r = _rec_residuals(rec)
        _, ext, _ = reconstruction_to_batch_matrix(rec)
        outs[name] = rec
        row = dict(points=len(rec.points3d), observations=len(r),
                   rmse_px=float(np.sqrt((r * r).mean())), huber_cost=_huber_cost(r),
                   ate_rmse=absolute_trajectory_error(ext, true_w2c)["ate_rmse"],
                   seconds=wall, stage_seconds=timings)
        res[name] = row
    # the same reconstruction before the solve: triangulated with the
    # perturbed poses, gated, no bundle adjustment
    rec0 = T.tracks_to_reconstruction(tracks, vis, init, Ks, image_size=(IMG, IMG),
                                      run_ba=False)
    r0 = _rec_residuals(rec0)
    res["initial"] = dict(points=len(rec0.points3d), rmse_px=float(np.sqrt((r0 * r0).mean())),
                          huber_cost=_huber_cost(r0), ate_rmse=ate0)
    print(f"  known geometry, {num_frames} frames x {num_tracks} tracks "
          f"({res['observations']} observations, noise 0.5 px, RMSE of the noise "
          f"{noise_rmse:.4f} px): before BA RMSE {res['initial']['rmse_px']:.4f} px, "
          f"ATE {ate0:.6f}, {res['initial']['points']} points")
    for name in ("torch", "torch_repeat", "native"):
        row = res[name]
        print(f"    {name}: RMSE {row['rmse_px']:.4f} px, Huber cost {row['huber_cost']:.6f}, "
              f"ATE {row['ate_rmse']:.6f}, {row['points']} points, {row['seconds']:.3f} s "
              f"({', '.join(f'{k} {v:.3f} s' for k, v in row['stage_seconds'].items())})")
        if not (row["rmse_px"] <= 1.5 * noise_rmse and row["rmse_px"] < res["initial"]["rmse_px"]):
            failures.append(f"{name}: RMSE {row['rmse_px']} not down to the noise")
        if not row["ate_rmse"] < ate0:
            failures.append(f"{name}: ATE {row['ate_rmse']} not below {ate0}")
    rel = abs(res["torch"]["huber_cost"] - res["native"]["huber_cost"]) / res["native"]["huber_cost"]
    a, b = outs["torch"], outs["torch_repeat"]
    spread_pts = max(float(np.abs(a.points3d[k].xyz - b.points3d[k].xyz).max())
                     for k in a.points3d)
    spread_t = max(float(np.abs(a.images[k].tvec - b.images[k].tvec).max()) for k in a.images)
    spread_cost = abs(res["torch"]["huber_cost"] - res["torch_repeat"]["huber_cost"])
    res.update(engines_cost_rel_diff=rel, torch_spread_points=spread_pts,
               torch_spread_translation=spread_t, torch_spread_cost=spread_cost)
    print(f"    engines' final Huber costs: relative difference {rel:.3e} (tolerance 1e-3); "
          f"torch engine spread over two runs: points {spread_pts:.3e}, translations "
          f"{spread_t:.3e}, cost {spread_cost:.3e}")
    if rel > 1e-3:
        failures.append(f"engines' costs differ by {rel} relative")
    return res, failures


def _to_device(tree, device):
    """A copy of a params tree with every tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device) if hasattr(tree, "to") else tree


def run_demo(host_params=None):
    """Phase 7: the reconstruction demo (``demos/reconstruct.py:run``) at full
    width in both modes with ``--tracks-ba``, its launch counts, the tracker
    with K3 against the einsum path, the DINO ranking through the ViT
    kernels, and bundle adjustment on known geometry with both engines."""
    import dataclasses as dc
    import shutil
    import tempfile

    import numpy as np
    import torch

    from self_supervise_sfm_tpu_torch.demos import reconstruct as D
    from self_supervise_sfm_tpu_torch.models import sailrecon as M
    from self_supervise_sfm_tpu_torch.ops import resize as RS
    from self_supervise_sfm_tpu_torch.pipeline import tracking as T
    from self_supervise_sfm_tpu_torch.pipeline import vggsfm_tracker as TV

    torch.cuda.reset_peak_memory_stats()
    wrappers = kernel_wrappers()
    failures = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    cfg = M.make_config(compute_dtype="bfloat16")
    if host_params is not None:
        params = _to_device(host_params, "cuda")
    else:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = M.cast_trunk_weights(M.init_sailrecon(cfg, gen, device="cuda"), cfg)
    tcfg = TV.VGGSfMTrackerConfig()
    tp = TV.init_vggsfm_tracker(tcfg, torch.Generator(device="cuda").manual_seed(SEED + 2))
    ds = SyntheticScenes(1, NUM_FRAMES, 16, IMG, SEED + 17, checker=True)
    work = tempfile.mkdtemp(prefix="demo_smoke_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    # every tracker call's query count, to predict K3's launches there
    calls = []
    orig_track = TV.track

    def recorded(p, images, query_points, *a, **k):
        calls.append((int(images.shape[1]), int(query_points.shape[1])))
        return orig_track(p, images, query_points, *a, **k)

    res = {"modes": {}}
    launches = dict.fromkeys(wrappers, 0)
    try:
        TV.track = recorded
        for mode in ("forward", "reloc"):
            out_dir = os.path.join(work, mode)
            args = D.parse_args(["--data-root", "-", "--out-dir", out_dir, "--mode", mode,
                                 "--num-images", str(NUM_FRAMES), "--num-scenes", "1",
                                 "--rank", str(RANK), "--tracks-ba",
                                 "--max-query-pts", "2048"])
            calls.clear()
            for w in wrappers.values():
                w.launches = 0
            t0 = time.perf_counter()
            results = D.run(args, ds, params=params, tracker_params=tp, tracker_cfg=tcfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = {k: w.launches for k, w in wrappers.items()}
            (name, entry), = results.items()
            k3_tracker = sum(RS.resize_kernel_applicable((s * q, 16, 16, 32), (31, 31))
                             for s, q in calls)
            base = (FORWARD_LAUNCHES if mode == "forward" else
                    {k: BUILD_LAUNCHES[k] + RELOC_LAUNCHES[k] for k in BUILD_LAUNCHES})
            want = {**base, "resize_bilinear": base["resize_bilinear"] + k3_tracker}
            print(f"  demo --mode {mode} --tracks-ba: {wall:.2f} s; tracker calls (frames, "
                  f"queries) {calls}; launches {n}")
            expect(n == want, f"demo {mode}: launch counts {n}, expected {want}")
            expect(k3_tracker > 0, f"demo {mode}: K3 never took the tracker site")
            for k, v in n.items():
                launches[k] += v
            scene_dir = os.path.join(out_dir, name)
            for f in ("pred.ply", "poses_kitti.txt"):
                expect(os.path.getsize(os.path.join(scene_dir, f)) > 0, f"demo {mode}: {f}")
            with open(os.path.join(out_dir, "results.json")) as f:
                written = json.load(f)[name]
            expect(math.isfinite(written["ate_rmse"]), f"demo {mode}: ATE {written}")
            if "ba_points" in entry:
                bad = _read_model_equal(os.path.join(scene_dir, "sparse_txt"),
                                        os.path.join(scene_dir, "sparse"))
                expect(not bad, f"demo {mode}: COLMAP models read back differ: {bad[:5]}")
                outcome = (f"{entry['ba_points']} points, {entry['ba_tracks']} observations "
                           f"exported; text and binary models read back equal: {not bad}")
            else:
                outcome = ("no reconstruction: no track survived the gating "
                           "(max_reproj_error 8 px, min track length 2)")
            print(f"    {name}: ATE {entry['ate_rmse']:.6f}, {outcome}")
            print(f"    stage seconds: " + ", ".join(
                f"{k} {v:.3f}" for k, v in entry["stage_seconds"].items()))
            res["modes"][mode] = dict(wall_s=wall, launches=n, tracker_calls=list(calls),
                                      k3_tracker_launches=k3_tracker, **entry)
    finally:
        TV.track = orig_track
        shutil.rmtree(work, ignore_errors=True)

    # the tracker with K3 against the einsum path, on the demo's frames
    scene = ds.load_scene(0, np.random.default_rng(0))
    imgs = torch.from_numpy(scene["images"]).cuda()[None]
    xy = T.extract_keypoints(scene["images"][0], max_pts=1024)
    q = torch.from_numpy(xy).cuda()[None]
    plain_cfg = dc.replace(tcfg, resize_impl="einsum")
    fk, ck, vk = TV.track(tp, imgs, q, tcfg)
    fe, ce, ve = TV.track(tp, imgs, q, plain_cfg)
    pr = tcfg.pradius
    topleft = torch.clamp(torch.floor(ck[0]).long() - pr, 0, IMG - (2 * pr + 1))
    patches = TV.extract_patches(imgs[0], topleft, 2 * pr + 1).reshape(-1, 2 * pr + 1,
                                                                      2 * pr + 1, 3)
    before = resize_launches = RS.resize_bilinear_fwd.launches
    feat_k = TV.shallow_encoder(tp["fine_fnet"], patches)
    resize_launches = RS.resize_bilinear_fwd.launches - before
    feat_e = TV.shallow_encoder(tp["fine_fnet"], patches, resize_impl="einsum")
    feat_rel = float((feat_k - feat_e).norm() / feat_e.norm())
    one_k = TV.track(tp, imgs, q, dc.replace(tcfg, fine_iters=1))[0]
    one_e = TV.track(tp, imgs, q, dc.replace(plain_cfg, fine_iters=1))[0]
    torch.cuda.synchronize()
    coarse_diff = float((ck - ce).abs().max())
    one_diff = float((one_k - one_e).abs().max())
    full_diff = float((fk - fe).abs().max())
    print(f"  tracker, {q.shape[1]} queries x {NUM_FRAMES} frames: patch features K3 vs einsum "
          f"rel-RMS {feat_rel:.3e} (tolerance 1e-5, phase 3's fp32 envelope; K3 launches "
          f"{resize_launches}); coarse tracks max diff {coarse_diff:.3e} px (no K3 site); "
          f"fine tracks after one fine iteration {one_diff:.3e} px (tolerance 1e-3); after "
          f"the default {tcfg.fine_iters} iterations {full_diff:.3e} px (for the record: the "
          f"iterated predictor amplifies rounding)")
    expect(feat_rel <= 1e-5, f"tracker patch features: {feat_rel} over 1e-5")
    expect(resize_launches == 1, "tracker patch features: K3 not launched")
    expect(coarse_diff <= 1e-3 and one_diff <= 1e-3, "tracker: K3 and einsum tracks differ")
    expect(bool(torch.isfinite(fk).all() and torch.isfinite(vk).all()), "tracker: non-finite")

    # the DINO ranking on the port's ViT: K1 and LN+QKV, against the plain path
    vit_cfg = cfg.aggregator.vit
    vit_plain = dc.replace(vit_cfg, attn_impl="dense", fused_qkv="off", fused_mlp="off")
    for w in wrappers.values():
        w.launches = 0
    rank_k = T.rank_frames_by_dino(params["aggregator"]["vit"], vit_cfg, imgs[0], 3,
                                   torch.bfloat16)
    n_rank = {k: w.launches for k, w in wrappers.items() if w.launches}
    rank_p = T.rank_frames_by_dino(params["aggregator"]["vit"], vit_plain, imgs[0], 3,
                                   torch.bfloat16)
    print(f"  rank_frames_by_dino: kernels {rank_k}, plain path {rank_p}; launches {n_rank}")
    expect(rank_k == rank_p, f"DINO ranking {rank_k} differs from the plain path's {rank_p}")
    expect(n_rank.get("flash_fwd", 0) > 0 and n_rank.get("fused_ln_qkv", 0) > 0,
           f"DINO ranking launched {n_rank}")

    # where the tracker's time goes: one profiled call
    prof = profile_forward(lambda: TV.track(tp, imgs, q, tcfg), "tracking call")
    res.update(tracker_features_rel=feat_rel, tracker_coarse_diff=coarse_diff,
               tracker_one_iter_diff=one_diff, tracker_full_diff=full_diff,
               rank_kernels=rank_k, rank_plain=rank_p, rank_launches=n_rank,
               tracker_profile=prof)
    del fk, ck, vk, fe, ce, ve, patches, feat_k, feat_e, one_k, one_e

    # bundle adjustment on known geometry: the demo's size and a larger scene
    for frames, tracks in ((NUM_FRAMES, 6144), (20, 10240)):
        r, f = run_known_geometry_ba(frames, tracks)
        res[f"ba_{frames}x{tracks}"] = r
        failures += f
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"  phase 7 peak memory {res['peak_gb']:.2f} GB")
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, res


def _trace_summary(path: str) -> dict:
    """Device busy, wall span, idle share and device launches (kernels,
    copies, memsets: what ``profile_forward`` counts) of a
    ``torch.profiler`` chrome trace (the trainer's profile window)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    busy = sum(e["dur"] for e in device) / 1e3
    wall = (t1 - t0) / 1e3
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
            "launches": len(device),
            "kernels": sum(e.get("cat") == "kernel" for e in device)}


def timed_checkpoints(times: dict):
    """A ``CheckpointManager`` that appends the seconds of each save (the
    host copy; under a mesh the gathers and the write too), write and
    restore to ``times["save_s" | "write_s" | "restore_s"]``."""
    import torch

    from self_supervise_sfm_tpu_torch.train import checkpoint as CK

    class TimedCheckpoints(CK.CheckpointManager):
        def save(self, step, state, layout=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            saved = super().save(step, state, layout)
            if saved:
                times["save_s"].append(time.perf_counter() - t0)
            return saved

        def _write(self, step, host):
            t0 = time.perf_counter()
            super()._write(step, host)
            times["write_s"].append(time.perf_counter() - t0)

        def restore(self, step=None, template=None, layout=None):
            t0 = time.perf_counter()
            out = super().restore(step, template, layout)
            torch.cuda.synchronize()
            times["restore_s"].append(time.perf_counter() - t0)
            return out

    return TimedCheckpoints


def run_trainer(bare_step_ms: float):
    """Phase 6: the trainer (``train/trainer.py:run``) at phase 5's full
    width on numpy-made synthetic scenes at 518 px (2 frames, 10 000
    correspondences a pair; validation on one 8-frame scene, 2048 a pair).
    Run A takes 6 steps: checkpoints at steps 3 and 6, a profile window
    over step 2, one sanity check and one validation at step 6. The spread
    of one step from one state: the step-3 checkpoint restored twice, each
    time stepped on step 3's batch and subsample. Run B resumes from the
    step-3 checkpoint and takes steps 4-6; its metrics are held against run
    A's within that spread (bit-equal when the spread is 0), its final
    state likewise. The step-6 checkpoint restored is bit-equal to run A's
    final state. Launch counts of run A against the prediction."""
    import os
    import shutil
    import tempfile

    import torch

    from self_supervise_sfm_tpu_torch.train import checkpoint as CK
    from self_supervise_sfm_tpu_torch.train import loop as L
    from self_supervise_sfm_tpu_torch.train import trainer as T
    from self_supervise_sfm_tpu_torch.train.loss import LossConfig

    wrappers = kernel_wrappers()
    failures = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    times = {"save_s": [], "write_s": [], "restore_s": [], "val_ms": []}
    TimedCheckpoints = timed_checkpoints(times)

    def timed_validator(*a, **k):
        validate = make_validator(*a, **k)

        def run(params):
            t0 = time.perf_counter()
            out = validate(params)  # two floats on the host: synchronised
            times["val_ms"].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    make_validator = T.make_validator
    T.CheckpointManager, T.make_validator = TimedCheckpoints, timed_validator
    work = tempfile.mkdtemp(prefix="trainer_smoke_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    steps, middle = 6, 3
    train = SyntheticScenes(2, TRAIN_FRAMES, 10_000, IMG, SEED + 11)
    heldout = SyntheticScenes(1, 8, 2048, IMG, SEED + 12)
    tcfg = L.TrainConfig(warmup_steps=1, adam_mu_dtype="bfloat16",
                         loss=LossConfig(max_val=30.0))
    cfg = T.TrainerConfig(
        data_root=train, results_dir=os.path.join(work, "a"), total_steps=steps,
        num_images=TRAIN_FRAMES, sample_num=10_000, rank=RANK, seed=SEED,
        checkpoint_every=middle, sanity_check_every=steps, eval_every=steps,
        eval_data_root=heldout, eval_num_images=8, eval_sample_num=2048,
        artifact_every=0, profile_start=2, profile_steps=1, log_every=1, train=tcfg)
    print("  artifact dumps off (artifact_every=0): this script runs without matplotlib; "
          "the CPU tests write the plots")
    try:
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state_a = T.run(cfg)
        torch.cuda.synchronize()
        run_a_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = {k: w.launches for k, w in wrappers.items()}
        print(f"  run A: {steps} steps in {run_a_s:.2f} s, peak memory {peak_gb:.2f} GB; "
              f"launches {launches}")
        # 6 train steps, one diagnostics forward (the sanity check) and one
        # validation forward, each with every head
        want = {k: steps * TRAIN_STEP_LAUNCHES[k] + 2 * FORWARD_LAUNCHES[k] for k in wrappers}
        if launches != want:
            raise AssertionError(f"trainer launch counts {launches}, expected {want}")

        def rows(results, prefix="train"):
            with open(os.path.join(results, "tensorboard", "metrics.jsonl")) as f:
                return [r for r in map(json.loads, f) if r["prefix"] == prefix]

        ra = rows(cfg.results_dir)
        for r in ra:
            print(f"  step {r['step']}: loss {r['loss']:.6g}, grad_norm {r['grad_norm']:.6g}, "
                  f"grad_norm_camera {r['grad_norm_camera']:.6g}, learning_rate "
                  f"{r['learning_rate']:.6g}, step_seconds {r['step_seconds']:.4f}")
            expect(all(math.isfinite(x) for x in r.values() if isinstance(x, float)),
                   f"step {r['step']}: non-finite metrics")
        expect([r["step"] for r in ra] == list(range(1, steps + 1)), "train rows")
        expect(any(r["loss"] < 2.0 and r["grad_norm_camera"] > 0 for r in ra),
               "every step saturated the CDF (loss 2, no camera gradient)")
        # steps/s between consecutive steps, from step 2 on (0-based step 1:
        # phase 5's median also skips the first step); the profiled step's
        # interval is left out
        rate_rows = [r for r in ra[1:] if r["step"] != cfg.profile_start + 1]
        trainer_ms = statistics.median(1e3 / r["steps_per_sec"] for r in rate_rows)
        # what else ran in each interval of run A
        during = {cfg.profile_start + 1: "profiled", middle + 1: "the step-3 save's host copy",
                  middle + 2: "the step-3 write in flight", middle + 3: "the write in flight"}
        for r in ra[1:]:
            print(f"  interval to step {r['step']}: {1e3 / r['steps_per_sec']:.2f} ms"
                  f" ({during.get(r['step'], 'the step alone')})")
        print(f"  trainer step {trainer_ms:.2f} ms median of steps "
              f"{[r['step'] for r in rate_rows]}, {1e3 / trainer_ms:.4f} steps/s; phase 5's "
              f"bare step {bare_step_ms:.2f} ms ({1e3 / bare_step_ms:.4f} steps/s): trainer / "
              f"bare {trainer_ms / bare_step_ms:.3f}")
        prof = _trace_summary(os.path.join(cfg.results_dir, "profile", "trace.json"))
        print(f"  profiled trainer step {cfg.profile_start + 1}: wall {prof['wall_ms']:.2f} ms, "
              f"device busy {prof['busy_ms']:.2f} ms (idle share {prof['idle_share']:.3f}), "
              f"{prof['launches']} device launches ({prof['kernels']} kernels)")
        (sanity,), (val,) = rows(cfg.results_dir, "sanity"), rows(cfg.results_dir, "val")
        expect(math.isfinite(sanity["mean_px_offset"]), "sanity offset not finite")
        expect(math.isfinite(val["px_residual"]) and math.isfinite(val["log_residual"]),
               "validation not finite")
        ck = os.path.join(cfg.results_dir, "checkpoints")
        ckpt_bytes = os.path.getsize(os.path.join(ck, str(middle), "state.pt"))
        print(f"  sanity check (diagnostics forward + check) {sanity['step_seconds'] * 1e3:.2f} "
              f"ms, mean offset {sanity['mean_px_offset']:.6g} px; validation "
              f"{times['val_ms'][0]:.2f} ms, px_residual {val['px_residual']:.6g}, "
              f"log_residual {val['log_residual']:.6g}")
        print(f"  checkpoint {ckpt_bytes / 1e9:.3f} GB; save (host copy) "
              f"{[round(s, 3) for s in times['save_s']]} s, write "
              f"{[round(s, 3) for s in times['write_s']]} s")

        # the step-6 checkpoint is run A's final state
        def leaves(state):
            return L._flatten([state["params"], state["opt"]["mu"], state["opt"]["nu"]])

        mgr = TimedCheckpoints(ck)
        back = mgr.restore(steps, template=state_a)
        same = [torch.equal(a, b) for a, b in zip(leaves(back), leaves(state_a))]
        expect(all(same) and back["step"] == back["opt"]["count"] == steps,
               "the step-6 checkpoint differs from run A's final state")
        del back

        # the spread of one step from one state: restore, step, twice
        model_cfg = T._model_config(cfg)
        tcfg_run = dataclasses.replace(cfg.train, total_steps=steps, rank=RANK,
                                       num_images=TRAIN_FRAMES)
        stream = T.scene_stream(train, range(1), SEED, 1, start=middle)
        batch = T.batch_to_device(next(stream), torch.device("cuda"))
        stream.close()
        step_fn = L.make_train_step(model_cfg, tcfg_run)
        repeats = []
        for _ in range(2):
            s = mgr.restore(middle, template=state_a)
            _, m = step_fn(s, batch, **T.step_subsample(SEED, middle, "cuda"))
            repeats.append(T._host_scalars(m))
            del s, m
        keys = [k for k in repeats[0] if k not in ("learning_rate",)]
        spread = max(abs(repeats[0][k] - repeats[1][k]) for k in keys)
        a4 = ra[middle]  # run A's row for step middle + 1
        spread_a = max(abs(repeats[0][k] - a4[k]) for k in keys)
        print(f"  same-state spread of step {middle + 1}: max |diff| over its metrics "
              f"{spread:.3e} between two restored runs, {spread_a:.3e} against run A; "
              f"restore {[round(s, 3) for s in times['restore_s']]} s")

        # run B: resume from the middle checkpoint
        cfg_b = dataclasses.replace(cfg, results_dir=os.path.join(work, "b"),
                                    checkpoint_every=0, profile_steps=0)
        os.makedirs(os.path.join(cfg_b.results_dir, "checkpoints"))
        os.rename(os.path.join(ck, str(middle)),
                  os.path.join(cfg_b.results_dir, "checkpoints", str(middle)))
        state_b = T.run(cfg_b)
        rb = rows(cfg_b.results_dir)
        expect([r["step"] for r in rb] == list(range(middle + 1, steps + 1)), "resumed rows")
        # run B saves nothing: its intervals are the trainer with no checkpoint
        quiet_ms = [1e3 / r["steps_per_sec"] for r in rb[1:]]
        print(f"  run B, no checkpoint in flight: intervals {[round(x, 2) for x in quiet_ms]} "
              f"ms, median / bare {statistics.median(quiet_ms) / bare_step_ms:.3f}")
        diffs = [max(abs(x[k] - y[k]) for k in keys) for x, y in zip(ra[middle:], rb)]
        leaves_b, leaves_a = leaves(state_b), leaves(state_a)
        equal_share = sum(bool(torch.equal(a, b)) for a, b in zip(leaves_a, leaves_b)) / len(leaves_a)
        tol = max(spread, spread_a)
        print(f"  resumed run B (steps {middle + 1}-{steps}) against run A: max |diff| by step "
              f"{[f'{x:.3e}' for x in diffs]}; final leaves bit-equal {equal_share:.4f}; "
              f"tolerance: the same-state spread {tol:.3e}")
        if tol == 0.0:
            expect(max(diffs) == 0.0 and equal_share == 1.0,
                   "the resumed run is not bit-equal to the uninterrupted one")
        else:
            expect(diffs[0] <= tol, f"resumed step {middle + 1} off by {diffs[0]} > {tol}")
        (val_b,) = rows(cfg_b.results_dir, "val")
        expect(tol > 0 or val_b["px_residual"] == val["px_residual"], "resumed validation")
        del state_a, state_b
    finally:
        T.CheckpointManager, T.make_validator = CK.CheckpointManager, make_validator
        shutil.rmtree(work, ignore_errors=True)
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, dict(
        steps=steps, run_a_s=run_a_s, trainer_step_ms=trainer_ms,
        trainer_steps_per_s=1e3 / trainer_ms, bare_step_ms=bare_step_ms,
        trainer_over_bare=trainer_ms / bare_step_ms, profile=prof, peak_gb=peak_gb,
        sanity_ms=sanity["step_seconds"] * 1e3, validation_ms=times["val_ms"],
        checkpoint_gb=ckpt_bytes / 1e9, save_s=times["save_s"], write_s=times["write_s"],
        restore_s=times["restore_s"], quiet_step_ms=quiet_ms, spread=spread, spread_vs_a=spread_a,
        resume_diffs=diffs, resume_equal_share=equal_share,
        losses=[r["loss"] for r in ra])


# phase 3's outputs that phase 8 holds the forward on converted weights to
PRETRAINED_KEYS = ("extrinsic", "intrinsic", "depth_map", "point_map", "cam_tokens")


def reference_state_dict(params) -> dict:
    """The port's SailRecon params -> a state dict in the reference's names
    and PyTorch layouts (fp32 CPU tensors), as the published ``sailrecon.pt``
    lays them out: the inverse of ``utils/converter.py``'s rules, written
    here apart from the package (linear weights back to (out, in), convs
    and transposed convs as they are, per-layer blocks as ``name.i``)."""
    sd = {}

    def put(name, t):
        sd[name] = t.detach().to("cpu", copy=True).float().contiguous()

    def lin(pfx, p):
        put(f"{pfx}.weight", p["w"].T)
        if "b" in p:
            put(f"{pfx}.bias", p["b"])

    def ln(pfx, p):
        put(f"{pfx}.weight", p["scale"])
        put(f"{pfx}.bias", p["bias"])

    def conv(pfx, p):
        put(f"{pfx}.weight", p["w"])
        if "b" in p:
            put(f"{pfx}.bias", p["b"])

    def blocks(pfx, ps, qk_norm):
        for i, p in enumerate(ps):
            b = f"{pfx}.{i}"
            ln(f"{b}.norm1", p["norm1"])
            lin(f"{b}.attn.qkv", p["attn"]["qkv"])
            lin(f"{b}.attn.proj", p["attn"]["proj"])
            if qk_norm:
                ln(f"{b}.attn.q_norm", p["attn"]["q_norm"])
                ln(f"{b}.attn.k_norm", p["attn"]["k_norm"])
            put(f"{b}.ls1.gamma", p["ls1"]["gamma"])
            ln(f"{b}.norm2", p["norm2"])
            lin(f"{b}.mlp.fc1", p["mlp"]["fc1"])
            lin(f"{b}.mlp.fc2", p["mlp"]["fc2"])
            put(f"{b}.ls2.gamma", p["ls2"]["gamma"])

    def dpt(pfx, p):
        ln(f"{pfx}.norm", p["norm"])
        for i, q in enumerate(p["projects"]):
            conv(f"{pfx}.projects.{i}", q)
        for i in (0, 1, 3):
            conv(f"{pfx}.resize_layers.{i}", p[f"resize{i}"])
        sc = p["scratch"]
        for i in (1, 2, 3, 4):
            conv(f"{pfx}.scratch.layer{i}_rn", sc[f"layer{i}_rn"])
            f = sc[f"refinenet{i}"]
            for unit in ("resConfUnit1", "resConfUnit2"):
                if unit in f:
                    for c in ("conv1", "conv2"):
                        conv(f"{pfx}.scratch.refinenet{i}.{unit}.{c}", f[unit][c])
            conv(f"{pfx}.scratch.refinenet{i}.out_conv", f["out_conv"])
        conv(f"{pfx}.scratch.output_conv1", sc["output_conv1"])
        if "output_conv2" in sc:
            conv(f"{pfx}.scratch.output_conv2.0", sc["output_conv2"]["conv1"])
            conv(f"{pfx}.scratch.output_conv2.2", sc["output_conv2"]["conv2"])

    agg, vit = params["aggregator"], params["aggregator"]["vit"]
    v = "aggregator.patch_embed"
    conv(f"{v}.patch_embed.proj", vit["patch_embed"]["proj"])
    for k in ("cls_token", "pos_embed", "register_tokens"):
        if vit[k] is not None:
            put(f"{v}.{k}", vit[k])
    blocks(f"{v}.blocks", vit["blocks"], False)
    ln(f"{v}.norm", vit["norm"])
    for mine, ref in (("frame_blocks", "frame_blocks"), ("global_blocks", "global_blocks"),
                      ("reloc_blocks", "global_reloc_blocks")):
        blocks(f"aggregator.{ref}", agg[mine], True)
    for k in ("camera_token", "register_token", "camera_token_reloc", "register_token_reloc"):
        put(f"aggregator.{k}", agg[k])
    cam = params["camera_head"]
    blocks("camera_head.trunk", cam["trunk"], False)
    ln("camera_head.token_norm", cam["token_norm"])
    ln("camera_head.trunk_norm", cam["trunk_norm"])
    put("camera_head.empty_pose_tokens", cam["empty_pose_tokens"])
    lin("camera_head.embed_pose", cam["embed_pose"])
    lin("camera_head.poseLN_modulation.1", cam["poseLN_modulation"])
    lin("camera_head.pose_branch.fc1", cam["pose_branch"]["fc1"])
    lin("camera_head.pose_branch.fc2", cam["pose_branch"]["fc2"])
    dpt("point_head", params["point_head"])
    dpt("depth_head", params["depth_head"])
    return sd


def _tree_paths(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_paths(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree) for x in _tree_paths(t, f"{path}[{i}]")]
    return [(path, tree)]


def _cast_vit_weights(p, dtype):
    """The ViT blocks' matmul weights in the compute dtype, once (the other
    leaves stay fp32), as ``cast_trunk_weights`` does for the aggregator."""
    out = dict(p, blocks=[])
    for b in p["blocks"]:
        b = {**b, "attn": {k: dict(v) for k, v in b["attn"].items()},
             "mlp": {k: dict(v) for k, v in b["mlp"].items()}}
        for sub in (b["attn"]["qkv"], b["attn"]["proj"], b["mlp"]["fc1"], b["mlp"]["fc2"]):
            sub["w"] = sub["w"].to(dtype)
        out["blocks"].append(b)
    return out


def run_converter(host_params=None, phase3=None):
    """Phase 8: (a) phase 3's weights written as a reference state dict,
    saved, loaded and converted on the demo's ``--pretrained`` path: every
    leaf bit-equal, the forward bit-equal to phase 3's with phase 3's launch
    counts; (b) the TrackHead at full width on 16 frames of the bf16
    aggregator's taps: K3 once a call, against the einsum upsample; (c)
    ``vit_small``, ``vit_base`` and ``vit_giant2`` in bf16 against their
    plain path within the bf16 envelope, with their launch counts; (d) the
    ``"aliked"`` extractor on the card against the same weights on the
    CPU. ``host_params``: phase 3's cast weights on the host (None: drawn
    here from the seed, with phase 3's forward run here)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from self_supervise_sfm_tpu_torch.demos import reconstruct as D
    from self_supervise_sfm_tpu_torch.heads import dpt as DH
    from self_supervise_sfm_tpu_torch.heads import track as TH
    from self_supervise_sfm_tpu_torch.layers import vit as V
    from self_supervise_sfm_tpu_torch.models import aggregator as AG
    from self_supervise_sfm_tpu_torch.models import sailrecon as M
    from self_supervise_sfm_tpu_torch.pipeline import aliked as A
    from self_supervise_sfm_tpu_torch.pipeline import extractors as X
    from self_supervise_sfm_tpu_torch.utils import converter as C

    torch.cuda.reset_peak_memory_stats()
    wrappers = kernel_wrappers()
    failures = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    def zero():
        for w in wrappers.values():
            w.launches = 0

    def counts():
        return {k: w.launches for k, w in wrappers.items()}

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    res, launches = {}, {}
    cfg = M.make_config(compute_dtype="bfloat16")

    def draw():
        return torch.Generator(device="cuda").manual_seed(SEED + 1)

    def fwd(p, images):
        return M.forward(p, cfg, images, NUM_FRAMES, NUM_FRAMES, rank=RANK, generator=draw(),
                         images_duplicated=True)

    # -- (a) the round trip through a reference state dict ----------------------
    if host_params is None:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = M.cast_trunk_weights(M.init_sailrecon(cfg, gen, device="cuda"), cfg)
        uniq = torch.rand((1, NUM_FRAMES, IMG, IMG, 3), generator=gen, device="cuda")
        images = torch.cat([uniq, uniq], dim=1)
        zero()
        out = fwd(params, images)
        torch.cuda.synchronize()
        expect(counts() == FORWARD_LAUNCHES, f"reference forward launches {counts()}")
        ref_out = {k: out[k].cpu() for k in PRETRAINED_KEYS}
        host_params = _to_device(params, "cpu")
        del params, out
        print("  phase 3's weights and forward made here (phase 3 did not run)")
    else:
        uniq, ref_out = phase3["uniq"].to("cuda"), phase3["out_host"]
        images = torch.cat([uniq, uniq], dim=1)
    work = tempfile.mkdtemp(prefix="converter_smoke_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    times = {}
    orig = C.load_torch_state_dict, C.convert_sailrecon

    def timed(name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            r = fn(*a, **k)
            times[name] = time.perf_counter() - t0
            return r
        return call

    try:
        t0 = time.perf_counter()
        sd = reference_state_dict(host_params)
        times["state_dict_s"] = time.perf_counter() - t0
        path = os.path.join(work, "sailrecon.pt")
        t0 = time.perf_counter()
        torch.save(sd, path)
        times["save_s"] = time.perf_counter() - t0
        res["file_gb"] = os.path.getsize(path) / 1e9
        res["tensors"], res["params"] = len(sd), sum(t.numel() for t in sd.values())
        del sd
        C.load_torch_state_dict = timed("load_s", orig[0])
        C.convert_sailrecon = timed("convert_s", orig[1])
        t0 = time.perf_counter()
        loaded = D.load_params(cfg, None, device="cuda", pretrained=path)
        torch.cuda.synchronize()
        times["pretrained_path_s"] = time.perf_counter() - t0
    finally:
        C.load_torch_state_dict, C.convert_sailrecon = orig
        shutil.rmtree(work, ignore_errors=True)
    res.update(times)
    print(f"  reference state dict: {res['tensors']} tensors, {res['params'] / 1e9:.4f} G "
          f"params, {res['file_gb']:.3f} GB on disk (fp32); built in "
          f"{times['state_dict_s']:.2f} s, torch.save {times['save_s']:.2f} s; the demo's "
          f"--pretrained path {times['pretrained_path_s']:.2f} s (load_torch_state_dict "
          f"{times['load_s']:.2f} s, convert_sailrecon {times['convert_s']:.2f} s, then to the "
          f"card and the trunk cast)")
    got, want = _tree_paths(loaded), _tree_paths(host_params)
    expect([p for p, _ in got] == [p for p, _ in want], "converted tree's structure")
    bad = [p for (p, a), (_, b) in zip(got, want)
           if (a is None) != (b is None) or (a is not None and (
               a.dtype != b.dtype or not torch.equal(a.cpu(), b)))]
    print(f"  converted leaves bit-equal to phase 3's: {len(got) - len(bad)} of {len(got)}"
          + (f" (first differing: {bad[:3]})" if bad else ""))
    expect(not bad, f"{len(bad)} converted leaves differ")
    del host_params
    zero()
    out = fwd(loaded, images)
    torch.cuda.synchronize()
    launches["pretrained"] = counts()
    print(f"  launches in the forward on the converted weights: {launches['pretrained']}")
    expect(launches["pretrained"] == FORWARD_LAUNCHES,
           f"forward on converted weights: launches {launches['pretrained']}")
    same = {k: torch.equal(out[k].cpu(), ref_out[k]) for k in PRETRAINED_KEYS}
    print(f"  forward on the converted weights bit-equal to phase 3's: {same}")
    expect(all(same.values()), "the forward on converted weights differs from phase 3's")
    del out, images

    # -- (b) the TrackHead at full width ------------------------------------------
    g = torch.Generator(device="cuda").manual_seed(SEED + 23)
    frames = torch.rand((1, TRACK_FRAMES, IMG, IMG, 3), generator=g, device="cuda")
    thcfg = TH.TrackHeadConfig()
    taps, psi, _ = AG.aggregator_forward(
        loaded["aggregator"], cfg.aggregator, torch.cat([frames[:, :1], frames], dim=1), 1,
        TRACK_FRAMES, RANK, generator=draw())
    taps = {li: taps[li] for li in thcfg.intermediate_layer_idx}
    del loaded, frames
    torch.cuda.empty_cache()
    thp = TH.init_track_head(torch.Generator(device="cuda").manual_seed(SEED + 29), thcfg)
    qp = torch.rand((1, 512, 2), generator=g, device="cuda") * (IMG - 1)
    thcfg_e = dataclasses.replace(thcfg, resize_impl="einsum")

    def head(c, iters=None):
        return TH.track_head(thp, taps, (IMG, IMG), psi, qp, c, iters=iters)

    zero()
    coords, vis, conf = head(thcfg)
    torch.cuda.synchronize()
    launches["track_head"] = counts()
    print(f"  TrackHead (16 x 518 px, 512 queries, {thcfg.iters} iterations) launches: "
          f"{launches['track_head']}")
    expect(launches["track_head"] == {**dict.fromkeys(wrappers, 0), "resize_bilinear": 1},
           f"TrackHead launches {launches['track_head']}")
    expect(tuple(coords[-1].shape) == (1, TRACK_FRAMES, 512, 2)
           and bool(torch.isfinite(coords[-1]).all()) and bool(torch.isfinite(vis).all())
           and bool(torch.isfinite(conf).all()), "TrackHead outputs")
    fk, fe = (DH.dpt_head(thp["feature_extractor"], taps, (IMG, IMG), psi,
                          c.feature_extractor_cfg) for c in (thcfg, thcfg_e))
    res["track_head_feature_rel_rms"] = rel(fk, fe)
    del fk, fe
    one_k, one_e = head(thcfg, 1)[0][-1], head(thcfg_e, 1)[0][-1]
    res["track_head_tracks_1_iter_px"] = float((one_k - one_e).abs().max())
    res["track_head_tracks_4_iter_px"] = float((coords[-1] - head(thcfg_e)[0][-1]).abs().max())
    print(f"  TrackHead, K3 against the einsum upsample: feature maps rel-RMS "
          f"{res['track_head_feature_rel_rms']:.3e} (tolerance 1e-5); tracks after one "
          f"iteration max {res['track_head_tracks_1_iter_px']:.3e} px (tolerance 1e-3), after "
          f"{thcfg.iters}: {res['track_head_tracks_4_iter_px']:.3e} px (for the record: random "
          f"weights amplify rounding)")
    expect(res["track_head_feature_rel_rms"] <= 1e-5, "TrackHead feature maps off einsum's")
    expect(res["track_head_tracks_1_iter_px"] <= 1e-3, "TrackHead tracks off einsum's")
    res["track_head_ms"] = _wall_ms(lambda: head(thcfg))
    res["track_head_profile"] = profile_forward(lambda: head(thcfg), "TrackHead call")
    print(f"  TrackHead call: {res['track_head_ms']:.2f} ms wall (median of 3)")
    del taps, thp, coords, vis, conf, one_k, one_e
    torch.cuda.empty_cache()

    # -- (c) the other ViT widths ---------------------------------------------------
    # K1 and the fused block kernels alone at the ViT-B, ViT-g and ViT-S sites
    # (2 frames of 518 px): LN+QKV, the out-projection and the MLP pair at the
    # ViT blocks' shape, LN+QKV+RoPE at a frame block's of that width (no
    # path runs it), each against its plain version, timed beside its
    # library call or chain and its bound
    wgen = torch.Generator(device="cuda").manual_seed(SEED + 37)

    def wrandn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=wgen, device="cuda").to(dtype)

    def ulps(ref, n):
        return n * 2.0 ** (math.floor(math.log2(float(ref.abs().max()))) - 7)

    N = (IMG // 14) ** 2 + 5
    res["width_sites"] = {}
    for C, H in ((768, 12), (1536, 24), (384, 6)):
        ws = {"flash_fwd": [flash_site(wrandn, ulps, f"vit C{C}", 2 * H, N)]}
        _site_line(f"flash_fwd[vit C{C}] {(2 * H, N, 64)}", ws["flash_fwd"][0])
        for r in check_fused_kernels(wrandn, ulps, C=C, H=H, frames=2,
                                     sites={f"vit C{C}": (2, N, None),
                                            f"frame C{C}": (2, N, "frame")},
                                     qkv_only=(f"frame C{C}",)):
            ws[r["name"]] = r["sites"]
        res["width_sites"][C] = ws
        torch.cuda.empty_cache()

    res["vit"] = {}
    for name in ("vit_small", "vit_base", "vit_giant2"):
        vc = getattr(V, name)()
        plain_cfg = dataclasses.replace(vc, attn_impl="dense", fused_qkv="off", fused_mlp="off")
        g = torch.Generator(device="cuda").manual_seed(SEED + 31)
        p32 = V.init_vit(g, "cuda", vc)
        p16 = _cast_vit_weights(p32, torch.bfloat16)
        x = torch.rand((2, IMG, IMG, 3), generator=g, device="cuda")
        zero()
        ok = V.vit_forward(p16, x, vc, torch.bfloat16)
        torch.cuda.synchronize()
        n = {k: v for k, v in counts().items() if v}
        launches[name] = counts()
        d = vc.depth
        # every width a multiple of 128 with an even count of heads of 64:
        # all five kernels in each block
        want = {"flash_fwd": d, "fused_ln_qkv": d, "fused_proj_residual": d,
                "fused_mlp_up": d, "fused_mlp_down": d}
        expect(n == want, f"{name}: launches {n}, expected {want}")
        plain = V.vit_forward(p16, x, plain_cfg, torch.bfloat16)
        f32 = V.vit_forward(p32, x, plain_cfg, torch.float32)
        errs = {}
        for key in ("x_norm_patchtokens", "x_norm_clstoken"):
            err, env = rel(ok[key], plain[key]), rel(plain[key], f32[key])
            errs[key] = [err, env]
            expect(err <= 2 * env, f"{name} {key}: {err} over twice the bf16 envelope {env}")
        ms = _wall_ms(lambda: V.vit_forward(p16, x, vc, torch.bfloat16))
        plain_ms = _wall_ms(lambda: V.vit_forward(p16, x, plain_cfg, torch.bfloat16))
        res["vit"][name] = dict(C=vc.embed_dim, heads=vc.num_heads, depth=d, launches=n,
                                rel_rms=errs, ms=ms, plain_ms=plain_ms)
        print(f"  {name} (C {vc.embed_dim}, {vc.num_heads} heads, depth {d}), 2 x 518 px bf16: "
              f"launches {n}; kernel vs plain rel-RMS "
              + ", ".join(f"{k} {e[0]:.3e} (bf16 envelope {e[1]:.3e})" for k, e in errs.items())
              + f"; {ms:.2f} ms, plain {plain_ms:.2f} ms")
        del p32, p16, x, ok, plain, f32
        torch.cuda.empty_cache()

    # -- (d) ALIKED on the card against the CPU ---------------------------------------
    scene = SyntheticScenes(1, NUM_FRAMES, 16, IMG, SEED + 17, checker=True).load_scene(
        0, np.random.default_rng(0))
    zoo = X.initialize_feature_extractors("aliked", max_pts=2048, device="cuda")
    per_image = []
    for img in scene["images"]:
        t0 = time.perf_counter()
        zoo["aliked"](img)
        per_image.append((time.perf_counter() - t0) * 1e3)
    ap = A.init_aliked(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    apc = _to_device(ap, "cpu")
    res["aliked"] = []
    for img in scene["images"][:2]:
        gi, ci = torch.from_numpy(img).cuda(), torch.from_numpy(img)
        sg = A.aliked_dense(ap, torch.nn.functional.pad(gi, (0, 0, 0, 26, 0, 26))[None])[0]
        sc = A.aliked_dense(apc, torch.nn.functional.pad(ci, (0, 0, 0, 26, 0, 26))[None])[0]
        xg, vg, dg = (t.cpu() for t in A.aliked_keypoints(ap, gi, 2048))
        xc, vc_, dc = A.aliked_keypoints(apc, ci, 2048)
        diff = (vg[1:] - vg[:-1]).abs()
        sep = torch.ones_like(vg, dtype=torch.bool)
        sep[1:] &= diff > 1e-4
        sep[:-1] &= diff > 1e-4
        sep &= vg > 0
        # the detections as sets: the card's keypoints found among the CPU's
        # (near-equal scores only permute entries, or swap the last ones)
        cpu_set = {tuple(p) for p in torch.round(xc[vc_ > 0] * 1e3).long().tolist()}
        card = torch.round(xg[vg > 0] * 1e3).long().tolist()
        r = dict(score_map_err=float((sg.cpu() - sc).abs().max()),
                 top_k_score_err=float((vg - vc_).abs().max()), detections=int((vg > 0).sum()),
                 shared_share=sum(tuple(p) in cpu_set for p in card) / max(len(card), 1),
                 separated=int(sep.sum()),
                 xy_err_separated=float((xg - xc)[sep].abs().max()) if sep.any() else 0.0,
                 desc_err_separated=float((dg - dc)[sep].abs().max()) if sep.any() else 0.0)
        res["aliked"].append(r)
        expect(r["score_map_err"] <= 1e-4 and r["top_k_score_err"] <= 1e-4,
               f"ALIKED scores card vs CPU {r}")
        expect(r["separated"] > 0 and r["xy_err_separated"] <= 1e-3
               and r["shared_share"] >= 0.99, f"ALIKED keypoints card vs CPU {r}")
    res["aliked_ms_per_image"] = per_image
    print(f"  ALIKED (zoo, 2048 points, 518 px padded to 544): "
          f"{[round(t, 2) for t in per_image]} ms an image (the first includes its warm-up); "
          f"card vs CPU on 2 images: {res['aliked']}")
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"  phase 8 peak memory {res['peak_gb']:.2f} GB")
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, res


# the seeds beyond seed 0 of --torchrun-tp's bf16 first-loss check (a median over all)
C1_SEEDS = 4
RING_SITE = (16, NUM_FRAMES * 1374, 64)  # the global site: 16 heads, 5 anchors x 1374 tokens
RING_CHUNKS = (2, 5, 10)
CACHE_ANCHORS = 200


def _same(a, b) -> bool:
    """Bit-equal, NaN where the other is NaN."""
    import torch

    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    a, b = a.cpu(), b.cpu()
    return (a.shape == b.shape and a.dtype == b.dtype
            and bool(((a == b) | (a.isnan() & b.isnan())).all()))


def run_sharded(card: str, host_params=None, phase3=None):
    """Phase 9: the multi-device path on the card, in one NCCL process of
    world size 1 (NCCL takes one rank a device, and the machine has one
    card) with the sharded path forced (``parallel/sp_block.py:
    force_single_device_spmd``): a ring of one chunk, collectives over
    groups of one. (1) the sharded joint forward, bit-equal to the unsharded
    one (and to phase 3's outputs) with phase 3's launch counts; (2) the
    sharded build (the context-sharded cache), full-head reloc and
    ``fast_reloc``, bit-equal to phase 4's program with its launch counts;
    (3) the ring's fold of n = 2, 5, 10 chunks at the global site through
    K1 and the lse merge in one process, forward against fp32 attention and
    gradients (B9 with ``dlse``) against B9 over the whole, timed beside K1
    over the whole; (4) the per-rank cache bytes of a 200-anchor scene.
    ``host_params``: phase 3's cast weights on the host (None: drawn here
    from the seed)."""
    import torch
    import torch.distributed as dist

    from self_supervise_sfm_tpu_torch.models import sailrecon as M
    from self_supervise_sfm_tpu_torch.ops import attention_core as AC
    from self_supervise_sfm_tpu_torch.ops import flash_attention as FA
    from self_supervise_sfm_tpu_torch.ops import ring_attention as RA
    from self_supervise_sfm_tpu_torch.parallel import sharding as Sh
    from self_supervise_sfm_tpu_torch.parallel import sp_block as SP

    wrappers = kernel_wrappers()
    failures = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    def counted(fn):
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: w.launches for k, w in wrappers.items()}

    cfg = M.make_config(compute_dtype="bfloat16")
    acfg = cfg.aggregator
    if host_params is None:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = M.cast_trunk_weights(M.init_sailrecon(cfg, gen, device="cuda"), cfg)
        uniq = torch.rand((1, NUM_FRAMES, IMG, IMG, 3), generator=gen, device="cuda")
        print("  phase 3's weights made here (phase 3 did not run)")
    else:
        params, uniq = _to_device(host_params, "cuda"), phase3["uniq"].to("cuda")
    images = torch.cat([uniq, uniq], dim=1)

    def draw():
        return torch.Generator(device="cuda").manual_seed(SEED + 1)

    def fwd():
        return M.forward(params, cfg, images, NUM_FRAMES, NUM_FRAMES, rank=RANK,
                         generator=draw(), images_duplicated=True)

    def build():
        return M.build_scene_cache(params, cfg, uniq, rank=RANK, generator=draw())

    # the unsharded programs of phases 3 and 4 on the same weights
    ref_out, _ = counted(fwd)
    (ref_cache, ref_cam), _ = counted(build)
    ref_reloc, _ = counted(lambda: M.reloc(params, cfg, ref_cache, ref_cam, uniq))
    ref_fast, _ = counted(lambda: M.reloc(params, cfg, ref_cache, ref_cam, uniq,
                                          fast_reloc=True))
    if phase3 is not None:
        same3 = {k: _same(ref_out[k], phase3["out_host"][k]) for k in PRETRAINED_KEYS}
        print(f"  unsharded forward here bit-equal to phase 3's outputs: {same3}")
        expect(all(same3.values()), "the forward differs from phase 3's")

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    res, launches = {}, {}
    ring_calls, gathers = [], []
    ring_local, all_gather = SP.ring_attention_local, Sh._all_gather

    def ring_spy(*a, **k):
        ring_calls.append(1)
        return ring_local(*a, **k)

    def gather_spy(*a, **k):
        gathers.append(1)
        return all_gather(*a, **k)

    SP.ring_attention_local, Sh._all_gather = ring_spy, gather_spy
    try:
        mesh = Sh.make_mesh(1, 1, 1, device="cuda")
        print(f"  process group: nccl, world size {dist.get_world_size()}; mesh "
              f"{mesh.shape}, sharded path forced")
        with Sh.activate_mesh(mesh), SP.force_single_device_spmd():
            expect(SP.scene_shard(1, NUM_FRAMES, NUM_FRAMES) is not None,
                   "the forced mesh takes the replicated path")
            # -- (1) the sharded joint forward --------------------------------
            ring_calls.clear(), gathers.clear()
            out, n = counted(fwd)
            launches["sharded_forward"] = n
            print(f"  sharded forward: launches {n}; ring calls {len(ring_calls)}, "
                  f"all-gathers {len(gathers)}")
            expect(n == FORWARD_LAUNCHES, f"sharded forward launches {n}")
            expect(len(ring_calls) == acfg.depth and gathers,
                   f"sharded forward: {len(ring_calls)} ring calls, {len(gathers)} gathers")
            same = {k: _same(out[k], ref_out[k]) for k in ref_out}
            print(f"  sharded forward bit-equal to the unsharded one: "
                  f"{all(same.values())} ({sum(same.values())} of {len(same)} outputs)")
            expect(all(same.values()),
                   f"sharded forward differs in {[k for k, v in same.items() if not v]}")
            if phase3 is not None:
                same3 = {k: _same(out[k], phase3["out_host"][k]) for k in PRETRAINED_KEYS}
                print(f"  sharded forward bit-equal to phase 3's outputs: {same3}")
                expect(all(same3.values()), "the sharded forward differs from phase 3's")
            # -- (2) build, reloc, fast_reloc ---------------------------------
            ring_calls.clear()
            (cache, cam), n = counted(build)
            launches["sharded_build"] = n
            print(f"  sharded build: launches {n}; ring calls {len(ring_calls)}; cache "
                  f"{tuple(cache['kv'].shape)} marked {cache['shards']}")
            expect(n == BUILD_LAUNCHES, f"sharded build launches {n}")
            expect(len(ring_calls) == acfg.depth, f"sharded build: {len(ring_calls)} ring calls")
            expect(cache["shards"] == (1, 1, 1), f"cache marked {cache.get('shards')}")
            expect(_same(cache["kv"], ref_cache["kv"]) and _same(cam, ref_cam),
                   "sharded cache or cam tokens differ from the unsharded build's")
            gathers.clear()
            rel, n_rel = counted(lambda: M.reloc(params, cfg, cache, cam, uniq))
            print(f"  sharded reloc: launches {n_rel}; all-gathers {len(gathers)} "
                  f"(one cache layer each of the {acfg.depth}, then the predictions)")
            expect(n_rel == RELOC_LAUNCHES, f"sharded reloc launches {n_rel}")
            expect(len(gathers) >= acfg.depth, f"sharded reloc: {len(gathers)} gathers")
            fast, n_fast = counted(lambda: M.reloc(params, cfg, cache, cam, uniq,
                                                   fast_reloc=True))
            expect(n_fast == FAST_RELOC_LAUNCHES, f"sharded fast_reloc launches {n_fast}")
            launches["sharded_reloc"] = {k: n_rel[k] + n_fast[k] for k in n_rel}
            same_b = dict(cache=_same(cache["kv"], ref_cache["kv"]), cam=_same(cam, ref_cam))
            same_r = {k: _same(rel[k], ref_reloc[k]) for k in ref_reloc}
            same_f = {k: _same(fast[k], ref_fast[k]) for k in ref_fast}
            print(f"  sharded build / reloc / fast_reloc bit-equal to phase 4's program: "
                  f"{same_b}, {all(same_r.values())} ({len(same_r)} outputs), "
                  f"{all(same_f.values())} ({len(same_f)} outputs)")
            expect(all(same_r.values()) and all(same_f.values()),
                   "sharded reloc differs from the unsharded one")
            # times beside the unsharded programs (phases 3 and 4)
            times = {}
            for name, a, b in (
                    ("forward", fwd, fwd), ("build", build, build),
                    ("reloc", lambda: M.reloc(params, cfg, ref_cache, ref_cam, uniq),
                     lambda: M.reloc(params, cfg, cache, cam, uniq)),
                    ("fast_reloc",
                     lambda: M.reloc(params, cfg, ref_cache, ref_cam, uniq, fast_reloc=True),
                     lambda: M.reloc(params, cfg, cache, cam, uniq, fast_reloc=True))):
                with Sh.activate_mesh(None):
                    plain_ms = _wall_ms(a)
                sharded_ms = _wall_ms(b)
                with Sh.activate_mesh(None):
                    plain_ms2 = _wall_ms(a)
                times[name] = dict(unsharded_ms=[plain_ms, plain_ms2], sharded_ms=sharded_ms)
                print(f"  {card}: {name} unsharded {plain_ms:.2f} / {plain_ms2:.2f} ms, "
                      f"sharded (world 1) {sharded_ms:.2f} ms (medians of 3)")
            res["times"] = times
            # what a world of one pays for each of reloc's cache-layer
            # gathers (an NCCL all-gather of a group of one, host cost
            # included) beside a copy of the same layer
            layer = cache["kv"][0:1]
            depth = acfg.depth
            gather_ms = _wall_ms(lambda: [Sh.gather(layer, mesh, "context", 3)
                                          for _ in range(depth)]) / depth
            copy_ms = _wall_ms(lambda: [layer.clone() for _ in range(depth)]) / depth
            res["layer_gather_ms"], res["layer_copy_ms"] = gather_ms, copy_ms
            print(f"  {card}: one cache layer {tuple(layer.shape)} gathered (world 1) "
                  f"{gather_ms:.4f} ms a call, copied {copy_ms:.4f} ms (wall, {depth} in a row)")
            del out, cache, cam, rel, fast, layer
    finally:
        SP.ring_attention_local, Sh._all_gather = ring_local, all_gather
        dist.destroy_process_group()
    del ref_out, ref_cache, ref_cam, ref_reloc, ref_fast, params
    torch.cuda.empty_cache()

    # -- (3) the ring's fold at the global site ---------------------------------
    g = torch.Generator(device="cuda").manual_seed(SEED + 41)
    H, N, d = RING_SITE

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    q, k, v, do = (randn(1, H, N, d) for _ in range(4))
    qf, kf, vf = (t.float().requires_grad_(True) for t in (q, k, v))
    ref = AC.sdpa_dense(qf, kf, vf)
    ref.backward(do.float())
    ref_grads = [t.grad for t in (qf, kf, vf)]
    ref = ref.detach()
    del qf, kf, vf

    def grads_of(fn):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fn(*ts)
        o.backward(do)
        return o.detach(), [t.grad for t in ts]

    whole, whole_g = grads_of(lambda a, b, c: FA.flash_attention_lse(a, b, c)[0])
    err_whole = float((whole.float() - ref).abs().max())
    gerr_whole = [float((a.float() - b).abs().max()) for a, b in zip(whole_g, ref_grads)]
    whole_ms = _time_ms(lambda: FA.flash_attention_lse(q, k, v))
    print(f"  ring fold at {tuple(q.shape)} bf16: K1 over the whole, max error vs fp32 "
          f"{err_whole:.3e}, gradients (B9) dq / dk / dv {gerr_whole}, {whole_ms:.4f} ms")
    folds, fold_launches = [], {key: 0 for key in wrappers}
    for nchunk in RING_CHUNKS:
        (o, gs), n = counted(lambda: grads_of(lambda a, b, c: RA.ring_fold(a, b, c, nchunk)))
        for key in n:
            fold_launches[key] += n[key]
        expect(n["flash_fwd"] == nchunk and n["flash_bwd_dq"] == nchunk
               and n["flash_bwd_dkv"] == nchunk, f"fold of {nchunk}: launches {n}")
        err = float((o.float() - ref).abs().max())
        gerr = [float((a.float() - b).abs().max()) for a, b in zip(gs, ref_grads)]
        vs_whole = [float((a.float() - b.float()).abs().max()) for a, b in zip(gs, whole_g)]
        # twice B9-over-the-whole's error, plus a bf16 ulp of the largest
        # gradient for each rounding the fold adds: the chunk's output
        # cotangent, cast to bf16 for its B9 call (dq, dk, dv), and for dq
        # the n - 1 bf16 sums of the chunks' partials (autograd's
        # accumulation into a bf16 leaf)
        gtol = [2 * e + extra * 2.0 ** (math.floor(math.log2(float(r.abs().max()))) - 7)
                for e, r, extra in zip(gerr_whole, ref_grads, (nchunk, 1, 1))]
        ms = _time_ms(lambda: RA.ring_fold(q, k, v, nchunk))
        folds.append(dict(n=nchunk, chunk=N // nchunk, max_abs_err=err, tolerance=2 * err_whole,
                          grad_err=gerr, grad_tolerance=gtol, grad_vs_whole=vs_whole, ms=ms,
                          whole_ms=whole_ms, launches=n))
        print(f"  fold of {nchunk} chunks of {N // nchunk}: max error vs fp32 {err:.3e} "
              f"(tolerance 2x K1's {2 * err_whole:.3e}); gradients vs fp32 {gerr} "
              f"(tolerances {gtol}), vs B9 over the whole {vs_whole}; {card}: {ms:.4f} ms "
              f"against K1 over the whole {whole_ms:.4f} ms ({ms / whole_ms:.2f}x)")
        expect(err <= 2 * err_whole, f"fold of {nchunk}: error {err} over 2x K1's {err_whole}")
        expect(all(e <= t for e, t in zip(gerr, gtol)),
               f"fold of {nchunk}: gradient errors {gerr} over {gtol}")
    launches["ring_fold"] = fold_launches
    res["ring_fold"] = dict(site=list(q.shape), whole_err=err_whole, whole_grad_err=gerr_whole,
                            whole_ms=whole_ms, folds=folds)
    del q, k, v, do, ref, ref_grads, whole, whole_g

    # the fold of 2 chunks in fp32: K1 fp32 a chunk, and its gradients through
    # B9's fp32 pair with the lse cotangent of the merge, against B9 fp32 over
    # the whole at phase 2's fp32 tolerance (2e-5 of the largest |gradient|)
    q, k, v, do = (torch.randn((1, H, N, d), generator=g, device="cuda") for _ in range(4))
    whole, whole_g = grads_of(lambda a, b, c: FA.flash_attention_lse(a, b, c)[0])
    (o, gs), n = counted(lambda: grads_of(lambda a, b, c: RA.ring_fold(a, b, c, 2)))
    expect(n["flash_fwd_f32"] == 2 and n["flash_bwd_dq_f32"] == 2
           and n["flash_bwd_dkv_f32"] == 2 and sum(n.values()) == 6,
           f"fp32 fold of 2: launches {n}")
    launches["ring_fold_f32"] = n
    err = float((o - whole).abs().max())
    gerr = [float((a - b).abs().max()) for a, b in zip(gs, whole_g)]
    gtol = [_f32_tol(b) for b in whole_g]
    print(f"  fp32 fold of 2 chunks at {tuple(q.shape)}: out vs K1 fp32 over the whole {err:.3e} "
          f"(tolerance {_f32_tol(whole):.3e}); gradients (B9 fp32 with dlse) vs B9 fp32 over "
          f"the whole {gerr} (tolerances {gtol}); launches "
          f"{ {key: c for key, c in n.items() if c} }")
    expect(err <= _f32_tol(whole), f"fp32 fold of 2: out error {err}")
    expect(all(e <= t for e, t in zip(gerr, gtol)), f"fp32 fold of 2: gradient errors {gerr} "
                                                    f"over {gtol}")
    res["ring_fold_f32"] = dict(site=list(q.shape), n=2, max_abs_err=err, grad_err=gerr,
                                grad_tolerance=gtol, launches=n)
    del q, k, v, do, whole, whole_g, o, gs

    # -- (4) the context-sharded cache of a 200-anchor scene --------------------
    per_anchor = acfg.depth * acfg.num_heads * (RANK + acfg.patch_start_idx) * 2 * acfg.head_dim * 2
    res["cache_bytes_200_anchors"] = {
        n: CACHE_ANCHORS * per_anchor / n for n in (1, 2, 4, 8)}
    print(f"  a {CACHE_ANCHORS}-anchor scene's kv2 cache (bf16, depth {acfg.depth}, "
          f"{acfg.num_heads} heads, rank {RANK}): per rank "
          + ", ".join(f"n = {n}: {b / 1e9:.3f} GB" for n, b in
                      res["cache_bytes_200_anchors"].items())
          + f"; reloc gathers one layer at a time, "
          f"{CACHE_ANCHORS * per_anchor / acfg.depth / 1e6:.1f} MB")
    res["launches"] = launches
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, res


def run_sharded_train(card: str, phase6=None):
    """Phase 10: multi-device training on the card, in one NCCL process of
    world size 1 with the sharded path forced (as phase 9): (1) the DDP
    step, four steps of phase 5's configuration, weights, batch and
    subsample, bit-equal to phase 5's metrics and sampled leaves with phase
    5's launch counts, and its collectives a step; (2) the FSDP step
    (whole-leaf slices at a data extent of 1: the trunk cast, gathered and
    its gradients reduce-scattered), the same checks; (3) the trainer under
    the mesh with FSDP, phase 6's configuration for 3 steps with a sanity
    check and a checkpoint at step 3: its losses bit-equal to phase 6's run
    A's (within run A's same-state spread if that is not 0), the
    checkpoint restored into the one-device layout bit-equal to the live
    state; (4) ``ba_solve_multihost`` over the NCCL group on phase 7's
    5 x 6144 problem, equal to the one-shard solver (one OpenMP thread);
    (5) the per-rank state bytes at n = 1, 2, 4, 8. Phase 5's and phase
    6's references come from ``PHASE5`` and ``phase6``, or are made here
    when those phases did not run. Launch counts go into the kernel line as
    "sharded_train" (the DDP and FSDP steps) and "sharded_trainer"."""
    import ctypes
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from self_supervise_sfm_tpu_torch.models import aggregator as AG
    from self_supervise_sfm_tpu_torch.models import sailrecon as M
    from self_supervise_sfm_tpu_torch.native import ba as NBA
    from self_supervise_sfm_tpu_torch.parallel import sharding as Sh
    from self_supervise_sfm_tpu_torch.parallel import sp_block as SP
    from self_supervise_sfm_tpu_torch.pipeline import tracking as TR
    from self_supervise_sfm_tpu_torch.train import checkpoint as CK
    from self_supervise_sfm_tpu_torch.train import loop as L
    from self_supervise_sfm_tpu_torch.train import trainer as T
    from self_supervise_sfm_tpu_torch.train.loss import LossConfig
    from self_supervise_sfm_tpu_torch.utils import colmap_io as CIO

    wrappers = kernel_wrappers()
    failures = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    # phase 5's configuration, weights, batch and subsample
    cfg = M.make_config(compute_dtype="bfloat16", remat=True)
    tcfg = L.TrainConfig(rank=RANK, num_images=TRAIN_FRAMES, adam_mu_dtype="bfloat16",
                         warmup_steps=1)
    batch = L.batch_to_device(make_train_batch()[0], "cuda")
    P0 = (IMG // 14) ** 2

    def indices(i):
        g = torch.Generator(device="cuda").manual_seed(SEED + 8 + i)
        return AG.draw_subsample_indices(cfg.aggregator, 1, TRAIN_FRAMES, P0, RANK, g)

    def fresh_state():
        state = L.init_train_state(cfg, tcfg,
                                   torch.Generator(device="cuda").manual_seed(SEED + 7))
        _condition_pose_branch(state["params"])
        return state

    def sample(params):
        return [params["aggregator"]["vit"]["blocks"][0]["attn"]["qkv"]["w"],
                params["aggregator"]["global_blocks"][-1]["mlp"]["fc2"]["w"],
                params["camera_head"]["pose_branch"]["fc2"]["w"]]

    def steps(state, tc, mesh=None):
        """Four steps of phase 5: metrics, launches of step 0, collectives
        and ms of each step."""
        step = L.make_train_step(cfg, tc)
        out = {"metrics": [], "ms": [], "collectives": []}
        torch.cuda.reset_peak_memory_stats()
        with Sh.activate_mesh(mesh):
            for i in range(4):
                for w in wrappers.values():
                    w.launches = 0
                Sh.collective_counts.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, batch, indices(i))
                torch.cuda.synchronize()
                out["ms"].append((time.perf_counter() - t0) * 1e3)
                out["metrics"].append({k: float(x) for k, x in m.items()})
                out["collectives"].append(dict(Sh.collective_counts))
                if i == 0:
                    out["launches"] = {k: w.launches for k, w in wrappers.items()}
        out["sample"] = [t.cpu() for t in sample(state["params"])]
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        return out

    # phase 6's configuration, for 3 steps, with a sanity check and a
    # checkpoint at step 3, FSDP on
    trainer_steps = 3
    ttcfg = L.TrainConfig(warmup_steps=1, adam_mu_dtype="bfloat16",
                          loss=LossConfig(max_val=30.0), fsdp=True)
    work = tempfile.mkdtemp(prefix="sharded_trainer_smoke_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    tcfg_run = T.TrainerConfig(
        data_root=SyntheticScenes(2, TRAIN_FRAMES, 10_000, IMG, SEED + 11),
        results_dir=os.path.join(work, "mesh"), total_steps=trainer_steps,
        num_images=TRAIN_FRAMES, sample_num=10_000, rank=RANK, seed=SEED,
        checkpoint_every=trainer_steps, sanity_check_every=trainer_steps, eval_every=6,
        eval_data_root=SyntheticScenes(1, 8, 2048, IMG, SEED + 12), eval_num_images=8,
        eval_sample_num=2048, artifact_every=0, log_every=1, train=ttcfg)
    res, launches = {}, {}
    # the references, made before the process group exists (under a group
    # the trainer builds a mesh) when phases 5 and 6 did not run
    if "metrics" not in PHASE5:
        print("  phase 5's reference made here (phase 5 did not run)")
        ref = steps(fresh_state(), tcfg)
        PHASE5.update(metrics=ref["metrics"], sample=ref["sample"], ms=ref["ms"][1:])
        torch.cuda.empty_cache()
    if phase6 is None:
        print("  phase 6's run A made here for its first 3 steps (phase 6 did not run)")
        one = dataclasses.replace(tcfg_run, results_dir=os.path.join(work, "one_device"),
                                  checkpoint_every=0, sanity_check_every=0,
                                  train=dataclasses.replace(ttcfg, fsdp=False))
        T.run(one)
        torch.cuda.empty_cache()
        with open(os.path.join(one.results_dir, "tensorboard", "metrics.jsonl")) as f:
            phase6 = dict(losses=[r["loss"] for r in map(json.loads, f)
                                  if r["prefix"] == "train"], spread=0.0)
    n_trained = len(L._flatten({k: L.param_shapes(cfg)[k] for k in ("aggregator",
                                                                     "camera_head")}))
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = Sh.make_mesh(1, 1, 1, device="cuda")
        print(f"  process group: nccl, world size {dist.get_world_size()}; mesh {mesh.shape}, "
              "sharded path forced")
        with SP.force_single_device_spmd():
            # -- (1) DDP and (2) FSDP steps ----------------------------------
            for name, fsdp in (("ddp", False), ("fsdp", True)):
                tc = dataclasses.replace(tcfg, fsdp=fsdp)
                layout = L.state_layout(cfg, tc, mesh)
                state = fresh_state()
                if fsdp:
                    state = L.train_state_from_params(state["params"], tc, layout)
                cut = sum(Sh.DATA_AXIS in sp for sp in Sh.spec_leaves(layout.specs))
                out = steps(state, tc, mesh)
                del state
                torch.cuda.empty_cache()
                launches[name] = out["launches"]
                same_m = [a == b for a, b in zip(out["metrics"], PHASE5["metrics"])]
                same_s = [torch.equal(a, b) for a, b in zip(out["sample"], PHASE5["sample"])]
                n_coll = [sum(c.values()) for c in out["collectives"]]
                print(f"  {name} step (world 1, {cut} leaves cut): launches of step 0 "
                      f"{out['launches']}; collectives a step {n_coll} "
                      f"({out['collectives'][-1]}) for {n_trained} trained leaves")
                print(f"  {name}: metrics of 4 steps bit-equal to phase 5's {same_m}, sampled "
                      f"leaves {same_s}; loss {[m['loss'] for m in out['metrics']]}")
                print(f"  {card}: {name} step ms {[round(t, 2) for t in out['ms']]}; phase 5's "
                      f"steps 1-3 {[round(t, 2) for t in PHASE5['ms']]}; peak memory "
                      f"{out['peak_gb']:.2f} GB")
                expect(out["launches"] == {k: TRAIN_STEP_LAUNCHES[k] for k in wrappers},
                       f"{name} step launches {out['launches']}")
                expect(all(same_m) and all(same_s),
                       f"{name} step differs from phase 5 (metrics {same_m}, leaves {same_s})")
                expect(max(n_coll) < n_trained // 2,
                       f"{name}: {max(n_coll)} collectives a step for {n_trained} leaves")
                expect(not fsdp or cut > 400, f"fsdp cut {cut} leaves")
                res[name] = dict(step_ms=out["ms"], peak_gb=out["peak_gb"],
                                 collectives=out["collectives"],
                                 leaves_cut=cut, bit_equal_metrics=same_m,
                                 bit_equal_sample=same_s, launches=out["launches"])
            # the three steps in turns on one state (at a data extent of 1
            # FSDP's slices have the whole leaves' shapes): host-clock times
            # spread between calls and within one
            state = fresh_state()
            fns = {"plain": (L.make_train_step(cfg, tcfg), None)}
            for name, fsdp in (("ddp", False), ("fsdp", True)):
                fns[name] = (L.make_train_step(cfg, dataclasses.replace(tcfg, fsdp=fsdp)), mesh)
            turns = {k: [] for k in fns}
            for i, name in enumerate(["plain", "ddp", "fsdp", "fsdp", "ddp", "plain"] * 2):
                step_fn, m_ = fns[name]
                with Sh.activate_mesh(m_):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, _ = step_fn(state, batch, indices(i))
                    torch.cuda.synchronize()
                turns[name].append((time.perf_counter() - t0) * 1e3)
            del state, fns
            torch.cuda.empty_cache()
            res["turns_ms"] = turns
            print(f"  {card}: steps in turns (plain, ddp, fsdp, fsdp, ddp, plain, twice), ms: "
                  + "; ".join(f"{k} {[round(t, 2) for t in v]} (median "
                              f"{statistics.median(v):.2f})" for k, v in turns.items()))
            # -- (3) the trainer under the mesh -----------------------------
            ck_times = {"save_s": [], "write_s": [], "restore_s": []}
            for w in wrappers.values():
                w.launches = 0
            T.CheckpointManager = timed_checkpoints(ck_times)
            try:
                t0 = time.perf_counter()
                live = T.run(tcfg_run)
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0
            finally:
                T.CheckpointManager = CK.CheckpointManager
            launches["trainer"] = {k: w.launches for k, w in wrappers.items()}
            with open(os.path.join(tcfg_run.results_dir, "tensorboard", "metrics.jsonl")) as f:
                rows = [r for r in map(json.loads, f)]
            losses = [r["loss"] for r in rows if r["prefix"] == "train"]
            want_l = phase6["losses"][:trainer_steps]
            diffs = [abs(a - b) for a, b in zip(losses, want_l)]
            tol = phase6.get("spread", 0.0)
            print(f"  trainer under the mesh (fsdp, {trainer_steps} steps, sanity check and "
                  f"checkpoint at {trainer_steps}) in {run_s:.2f} s: losses {losses} against "
                  f"phase 6's run A {want_l} (max |diff| {max(diffs):.3e}, tolerance: run A's "
                  f"same-state spread {tol:.3e}); launches {launches['trainer']}")
            expect(len(losses) == trainer_steps and max(diffs) <= tol,
                   f"mesh trainer losses {losses} against {want_l}")
            # the sanity check's forward of one 2-frame scene: its final DPT
            # upsample (2 x 518 x 518 x 128 elements) is below K3's size gate
            # (2^27) and runs the einsum path
            want_t = {k: trainer_steps * TRAIN_STEP_LAUNCHES[k]
                      + (FORWARD_LAUNCHES[k] if k != "resize_bilinear" else 0)
                      for k in wrappers}
            expect(launches["trainer"] == want_t,
                   f"mesh trainer launches {launches['trainer']}, expected {want_t}")
            expect(any(r["prefix"] == "sanity" for r in rows), "no sanity check row")
            ck = os.path.join(tcfg_run.results_dir, "checkpoints")
            t0 = time.perf_counter()
            back = CK.CheckpointManager(ck).restore(trainer_steps, template=live)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0

            def leaves(state):
                return L._flatten([state["params"], state["opt"]["mu"], state["opt"]["nu"]])

            same = sum(torch.equal(a, b) for a, b in zip(leaves(back), leaves(live)))
            total = len(leaves(live))
            ckpt_gb = os.path.getsize(os.path.join(ck, str(trainer_steps), "state.pt")) / 1e9
            print(f"  the step-{trainer_steps} checkpoint ({ckpt_gb:.3f} GB, gathered to the "
                  f"host leaf by leaf and written in {[round(t, 2) for t in ck_times['save_s']]} "
                  f"s, the write {[round(t, 2) for t in ck_times['write_s']]} s) restored "
                  f"into the one-device layout in {restore_s:.2f} s: {same} of {total} leaves "
                  f"bit-equal to the live state")
            expect(same == total and back["step"] == back["opt"]["count"] == trainer_steps,
                   "the mesh trainer's checkpoint differs from its live state")
            res["trainer"] = dict(losses=losses, reference_losses=want_l, max_diff=max(diffs),
                                  run_s=run_s, save_s=ck_times["save_s"],
                                  write_s=ck_times["write_s"], restore_s=restore_s,
                                  checkpoint_gb=ckpt_gb,
                                  leaves_bit_equal=same, leaves=total,
                                  launches=launches["trainer"])
            del live, back
            torch.cuda.empty_cache()
        # -- (4) bundle adjustment over the NCCL group ----------------------
        tracks, vis, _, init, Ks = known_geometry(NUM_FRAMES, 6144)
        rec = TR.tracks_to_reconstruction(tracks, vis, init, Ks, image_size=(IMG, IMG),
                                          run_ba=False)
        pts, exts, ks = CIO.reconstruction_to_batch_matrix(rec)
        _, _, ci, pi, uv = CIO.observations(rec)
        args = (exts.astype(np.float32), ks.astype(np.float32), pts.astype(np.float32),
                ci, pi, uv)
        lib = ctypes.CDLL(NBA.build())
        lib.omp_get_max_threads.restype = ctypes.c_int
        threads = lib.omp_get_max_threads()
        lib.omp_set_num_threads(1)  # the engine's dynamic schedules sum in a fixed order
        try:
            t0 = time.perf_counter()
            e1, p1, i1 = NBA.ba_solve_multihost(*args, huber_delta=4.0)
            mh_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            e2, p2, i2 = NBA.ba_solve_distributed(*args, num_shards=1, huber_delta=4.0)
            one_s = time.perf_counter() - t0
        finally:
            lib.omp_set_num_threads(threads)
        equal = (np.array_equal(e1, e2) and np.array_equal(p1, p2)
                 and i1["final_cost"] == i2["final_cost"] and i1["iterations"] == i2["iterations"])
        print(f"  ba_solve_multihost over the NCCL group ({NUM_FRAMES} x 6144 known geometry, "
              f"{len(uv)} observations, one OpenMP thread): equal to the one-shard solver "
              f"{equal} (cost {i1['final_cost']:.6f}, {i1['iterations']} iterations); "
              f"{card}: {mh_s:.3f} s against {one_s:.3f} s")
        expect(equal, "ba_solve_multihost differs from ba_solve_distributed(num_shards=1)")
        res["ba"] = dict(equal=equal, final_cost=i1["final_cost"], iterations=i1["iterations"],
                         multihost_s=mh_s, one_shard_s=one_s, observations=int(len(uv)))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    # -- (5) the per-rank state bytes --------------------------------------
    res["state_gb_per_rank"] = {
        mode: {n: L.state_bytes_per_rank(cfg, n, mode == "fsdp", "bfloat16") / 1e9
               for n in (1, 2, 4, 8)} for mode in ("ddp", "fsdp")}
    print("  per-rank train state (fp32 params, bf16 mu, fp32 nu; JAX's rule on this "
          "model's leaves): " + "; ".join(
              f"{mode} " + ", ".join(f"n = {n}: {gb:.3f} GB" for n, gb in by_n.items())
              for mode, by_n in res["state_gb_per_rank"].items()))
    if failures:
        raise AssertionError("; ".join(failures))
    counted = {"sharded_train": {k: launches["ddp"][k] + launches["fsdp"][k] for k in wrappers},
               "sharded_trainer": launches["trainer"]}
    return counted, res


def run_torchrun_trainer(card: str) -> dict:
    """``--torchrun-trainer``: phase 6's configuration (6 steps, one
    numpy-made scene a data rank a step, no checkpoint, no diagnostics) on
    every card of the machine. Without torchrun's environment it is the
    one-device trainer, the reference; under ``torchrun --nproc_per_node
    N`` the trainer over N NCCL ranks with DDP (N x 1), FSDP (N x 1) and
    FSDP over a context extent of 2 (N/2 x 2). Rank 0 prints each run's
    step intervals (steps 3-6), frames a second a card, losses and every
    rank's peak memory. Build the kernels once before starting the ranks
    (each rank would otherwise compile into the same directory)."""
    import os
    import shutil

    import torch
    import torch.distributed as dist

    from self_supervise_sfm_tpu_torch.train import loop as L
    from self_supervise_sfm_tpu_torch.train import trainer as T
    from self_supervise_sfm_tpu_torch.train.loss import LossConfig

    T.maybe_init_distributed("cuda")
    world = dist.get_world_size() if dist.is_initialized() else 1
    primary = not dist.is_initialized() or dist.get_rank() == 0
    runs = [("one_device", 1, False)] if world == 1 else [
        ("ddp", 1, False), ("fsdp", 1, True), ("fsdp_context2", 2, True)]
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "torchrun_smoke")
    out = {"world": world}
    try:
        for name, nc, fsdp in runs:
            results = os.path.join(work, name)
            torch.cuda.reset_peak_memory_stats()
            cfg = T.TrainerConfig(
                data_root=SyntheticScenes(max(world // nc, 1) * 2, TRAIN_FRAMES, 10_000, IMG,
                                          SEED + 11),
                results_dir=results, total_steps=6, num_images=TRAIN_FRAMES,
                sample_num=10_000, rank=RANK, seed=SEED, num_context=nc, checkpoint_every=0,
                sanity_check_every=0, artifact_every=0, log_every=1,
                train=L.TrainConfig(warmup_steps=1, adam_mu_dtype="bfloat16",
                                    loss=LossConfig(max_val=30.0), fsdp=fsdp))
            t0 = time.perf_counter()
            state = T.run(cfg)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            del state
            torch.cuda.empty_cache()
            peak = torch.tensor([torch.cuda.max_memory_allocated() / 1e9], device="cuda")
            if dist.is_initialized():
                peaks = [torch.zeros_like(peak) for _ in range(world)]
                dist.all_gather(peaks, peak)
                peak_gb = [float(p) for p in peaks]
            else:
                peak_gb = [float(peak)]
            if primary:
                with open(os.path.join(results, "tensorboard", "metrics.jsonl")) as f:
                    rows = [r for r in map(json.loads, f) if r["prefix"] == "train"]
                ms = [1e3 / r["steps_per_sec"] for r in rows[2:]]
                fps = [r["frames_per_sec_per_chip"] for r in rows[2:]]
                out[name] = dict(mesh=[world // nc, nc], fsdp=fsdp, run_s=run_s, step_ms=ms,
                                 frames_per_s_per_card=fps, peak_gb=peak_gb,
                                 losses=[r["loss"] for r in rows])
                print(f"  {card}: {name} over {world // nc} x {nc} ranks: step intervals "
                      f"(steps 3-6) {[round(x, 2) for x in ms]} ms, median "
                      f"{statistics.median(ms):.2f}; frames/s a card median "
                      f"{statistics.median(fps):.4f}; peak GB by rank "
                      f"{[round(x, 2) for x in peak_gb]}; losses "
                      f"{[round(r['loss'], 6) for r in rows]}; run {run_s:.1f} s", flush=True)
    finally:
        if dist.is_initialized():
            dist.barrier()
            if primary:
                shutil.rmtree(work, ignore_errors=True)
            dist.destroy_process_group()
        else:
            shutil.rmtree(work, ignore_errors=True)
    return out


TP_EXTENTS = (2, 4)  # the model extents phase 11 cuts the 16 heads over
TP_STATE_EXTENTS = (1, 2, 4, 8)
# launches of the forced tensor-parallel programs (world 1): the column-
# parallel half on the kernels (LN+QKV(+RoPE) on the head shard, K1, K2, the
# in-place kv2 kernel), the row-parallel tail plain (JAX's ``_tp_out_mlp``
# runs XLA products), so no out-projection or MLP kernel
_NO_TAIL = {"fused_proj_residual": 0, "fused_mlp_up": 0, "fused_mlp_down": 0}
TP_FORWARD_LAUNCHES = {**FORWARD_LAUNCHES, **_NO_TAIL}
TP_BUILD_LAUNCHES = {**BUILD_LAUNCHES, **_NO_TAIL}
TP_RELOC_LAUNCHES = {**RELOC_LAUNCHES, **_NO_TAIL}
TP_FAST_RELOC_LAUNCHES = {**FAST_RELOC_LAUNCHES, **_NO_TAIL}
TP_TRAIN_STEP_LAUNCHES = {**TRAIN_STEP_LAUNCHES, **_NO_TAIL}


def _rel_rms(a, b) -> float:
    """RMS of a - b over RMS of b, on the entries finite in both (none
    finite: inf, which no tolerance takes)."""
    import torch

    a, b = a.double(), b.double()
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not bool(fin.any()):
        return float("inf")
    num = float((a - b)[fin].pow(2).mean().sqrt())
    den = float(b[fin].pow(2).mean().sqrt())
    return num / den if den else num


def check_tp_kernels(card: str):
    """Phase 11 (1): LN+QKV+RoPE and LN+QKV on one rank's head shard, the
    (1024, 3 Hl 64) weight of ``sharding.model_part`` (its heads' columns of
    q, of k and of v) at m = 2 and 4 model ranks and every rank index i, at
    the frame site (10, 1374, 1024) and the global site (1, 6870, 1024) for
    LN+QKV+RoPE and the ViT site (5, 1374, 1024) for LN+QKV: each against
    its plain version (4 ulps for q / k, 2 for v, phase 2's) and bit-equal
    to the whole-width kernel's heads [i Hl, (i+1) Hl) (every output element
    is one warpgroup's sum over K in order, whatever the tile); the m = 1
    form (the whole weight through ``model_part``) bit-equal to the
    whole-width call. Times per call and 20 back to back beside the
    whole-width kernel and the bounds (ops at 989 TFLOP/s, bytes at
    3.35 TB/s)."""
    import torch

    from self_supervise_sfm_tpu_torch.layers import attention as AT
    from self_supervise_sfm_tpu_torch.layers import params as P
    from self_supervise_sfm_tpu_torch.models import aggregator as AG
    from self_supervise_sfm_tpu_torch.ops import fused_qkv as FQ
    from self_supervise_sfm_tpu_torch.parallel import sharding as Sh

    g = torch.Generator(device="cuda").manual_seed(SEED + 51)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def ulps(ref, n):
        return n * 2.0 ** (math.floor(math.log2(float(ref.float().abs().max()))) - 7)

    C, H, d = 1024, 16, 64
    N = (IMG // 14) ** 2 + 5
    norm = lambda n: (1 + 0.1 * randn(n, dtype=f32), 0.1 * randn(n, dtype=f32))  # noqa: E731
    ln, qn, kn = norm(C), norm(d), norm(d)
    w = (randn(C, 3 * C, dtype=f32) * C**-0.5).to(bf16)
    b = 0.1 * randn(3 * C, dtype=f32)
    acfg = AG.AggregatorConfig()
    t_frame = AG._rope_tables_frame(acfg, IMG // 14, IMG // 14, "cuda")
    sites = {"frame": (2 * NUM_FRAMES, N, t_frame), "global": (1, NUM_FRAMES * N,
                                                                AG._tile_tables(t_frame, NUM_FRAMES)),
             "vit": (NUM_FRAMES, N, None)}
    out = {"fused_ln_qkv_rope": [], "fused_ln_qkv": []}
    for site, (B, n, tabs) in sites.items():
        x = randn(B, n, C)
        M_ = B * n
        if tabs is None:
            name, kern, plain, eps = "fused_ln_qkv", FQ.fused_ln_qkv_fwd, FQ.fused_ln_qkv_plain, 1e-6
            extra, tol = (), {"q": 2, "k": 2, "v": 2}
        else:
            name, kern, plain, eps = ("fused_ln_qkv_rope", FQ.fused_ln_qkv_rope_fwd,
                                      FQ.fused_ln_qkv_rope_plain, 1e-5)
            extra, tol = (*qn, *kn, *tabs), {"q": 4, "k": 4, "v": 2}

        def args(wi, bi, hl):
            return (x, *ln, wi, bi, *extra, hl, eps)

        whole = kern(*args(w, b, H))
        one = kern(*args(Sh.model_part(w, -1, 1, 0, 3), Sh.model_part(b, -1, 1, 0, 3), H))
        torch.cuda.synchronize()
        _check(f"{name}[{site}] m = 1 form against the whole-width call (bit-equal)",
               max(float((a.float() - c.float()).abs().max()) for a, c in zip(whole, one)), 0.0)
        whole_ms, whole_b2b = _time_ms(lambda: kern(*args(w, b, H))), _back_to_back_ms(
            lambda: kern(*args(w, b, H)))
        in_bytes = lambda wi, bi: sum(t.numel() * t.element_size()  # noqa: E731
                                      for t in (x, wi, bi, *ln, *extra))
        out_bytes = lambda hl: 3 * B * hl * n * d * 2  # noqa: E731
        whole_bound, _ = _bound_ms(2.0 * M_ * C * 3 * C, in_bytes(w, b) + out_bytes(H))
        for m in TP_EXTENTS:
            hl = H // m
            row = dict(site=site, m=m, local_heads=hl, shape=[B, n, C], weight=[C, 3 * hl * d],
                       max_abs_err=0.0, max_abs_vs_whole_heads=0.0, whole_ms=whole_ms,
                       whole_back_to_back_ms=whole_b2b, whole_bound_ms=whole_bound)
            for i in range(m):
                wi = Sh.model_part(w, -1, m, i, 3).contiguous()
                bi = Sh.model_part(b, -1, m, i, 3).contiguous()
                got, ref = kern(*args(wi, bi, hl)), plain(*args(wi, bi, hl))
                torch.cuda.synchronize()
                for label, o, r, wh in zip("qkv", got, ref, whole):
                    e = float((o.float() - r.float()).abs().max())
                    _check(f"{name}[{site}] m = {m} rank {i} {label} {tuple(o.shape)}", e,
                           ulps(r, tol[label]))
                    row["max_abs_err"] = max(row["max_abs_err"], e)
                    row["max_abs_vs_whole_heads"] = max(row["max_abs_vs_whole_heads"], float(
                        (o.float() - wh[:, i * hl:(i + 1) * hl].float()).abs().max()))
                if i == 0:
                    flops = 2.0 * M_ * C * 3 * hl * d
                    bound, by = _bound_ms(flops, in_bytes(wi, bi) + out_bytes(hl))
                    # the library chain the kernel replaces on the shard
                    local = {"qkv": {"w": wi, "b": bi}, "q_norm": dict(zip(("scale", "bias"), qn)),
                             "k_norm": dict(zip(("scale", "bias"), kn))}
                    lcfg = AT.AttentionConfig(dim=hl * d, num_heads=hl, qk_norm=tabs is not None,
                                              ln_eps=eps)
                    chain = lambda: tuple(t.contiguous() for t in AT.qkv_heads(  # noqa: E731
                        local, P.layer_norm(dict(zip(("scale", "bias"), ln)), x, eps), lcfg,
                        tabs))
                    row.update(ms=_time_ms(lambda: kern(*args(wi, bi, hl))),
                               back_to_back_ms=_back_to_back_ms(lambda: kern(*args(wi, bi, hl))),
                               plain_ms=_time_ms(lambda: plain(*args(wi, bi, hl)), reps=5),
                               library_ms=_time_ms(chain),
                               library_back_to_back_ms=_back_to_back_ms(chain),
                               bound_ms=bound, bound_by=by, gflop=flops / 1e9,
                               mbytes=(in_bytes(wi, bi) + out_bytes(hl)) / 1e6)
                del got, ref
            _check(f"{name}[{site}] m = {m}: every rank's q, k, v against the whole-width "
                   "kernel's heads (bit-equal)", row["max_abs_vs_whole_heads"], 0.0)
            print(f"  {card}: {name}[{site}] head shard m = {m} (Hl {hl}, weight "
                  f"{C} x {3 * hl * d}): {row['ms']:.4f} ms a call, {row['back_to_back_ms']:.4f} "
                  f"back to back, plain {row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} "
                  f"({row['bound_by']}, {row['gflop']:.1f} GFLOP, {row['mbytes']:.1f} MB), "
                  f"roofline share {row['bound_ms'] / row['back_to_back_ms']:.3f}; library chain "
                  f"{row['library_ms']:.4f} / {row['library_back_to_back_ms']:.4f}; whole width "
                  f"{whole_ms:.4f} / {whole_b2b:.4f} ms (bound {whole_bound:.4f}); max error "
                  f"{row['max_abs_err']:.3e}")
            out[name].append(row)
        del x, whole, one
    torch.cuda.empty_cache()
    return out


def _tp_block_params(randn, C=1024, d=64):
    """A full-width block's parameters, bf16 weights and fp32 norms, biases
    and layer scales off their initial values."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    norm = lambda n: {"scale": 1 + 0.1 * randn(n, dtype=f32),  # noqa: E731
                      "bias": 0.1 * randn(n, dtype=f32)}
    lin = lambda i, o: {"w": (randn(i, o, dtype=f32) * i**-0.5).to(bf16),  # noqa: E731
                        "b": 0.1 * randn(o, dtype=f32)}
    return {"norm1": norm(C), "norm2": norm(C),
            "attn": {"qkv": lin(C, 3 * C), "proj": lin(C, C), "q_norm": norm(d),
                     "k_norm": norm(d)},
            "mlp": {"fc1": lin(C, 4 * C), "fc2": lin(4 * C, C)},
            "ls1": {"gamma": 0.5 + 0.1 * randn(C, dtype=f32)},
            "ls2": {"gamma": 0.5 + 0.1 * randn(C, dtype=f32)}}


def check_tp_blocks(card: str, wrappers):
    """Phase 11 (2): the m ranks of one Megatron block emulated in turn in
    one process, at m = 2 and 4, for the frame (10 frames of 1374 tokens),
    reloc (5 query frames against the 1525 compressed tokens of 5 anchors)
    and global (6870 tokens) blocks at full width: each rank's part of the
    weights (``sp_block.tp_block_params``) through LN+QKV+RoPE on its head
    shard and K1 / K2 on its Hl heads, its out-projection and fc2 partials
    summed in bf16 where the all-reduce would run (``tp_attn_partial`` /
    ``tp_mlp_partial``), the tail between them (``tp_attn_residual`` /
    ``tp_mlp_residual``). Held against the fp32 block within twice the
    unsharded kernel block's error against it. A check of the shard
    arithmetic; no path of the package runs it (a rank's collectives do)."""
    import torch

    from self_supervise_sfm_tpu_torch.layers.attention import attention_heads_out
    from self_supervise_sfm_tpu_torch.layers.block import (
        BlockConfig, block, block_context_kv, block_with_context, local_attn_cfg, qkv_parts)
    from self_supervise_sfm_tpu_torch.models import aggregator as AG
    from self_supervise_sfm_tpu_torch.parallel import sp_block as SP

    g = torch.Generator(device="cuda").manual_seed(SEED + 52)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    C, N = 1024, (IMG // 14) ** 2 + 5
    cfg = BlockConfig(dim=C, num_heads=16, qk_norm=True)
    p = _tp_block_params(randn)
    p32 = {k: ({kk: ({k3: t.float() for k3, t in vv.items()} if isinstance(vv, dict)
                     else vv.float()) for kk, vv in v.items()}) for k, v in p.items()}
    acfg = AG.AggregatorConfig()
    t_frame = AG._rope_tables_frame(acfg, IMG // 14, IMG // 14, "cuda")
    nc = NUM_FRAMES * (RANK + 5)
    ctx_rows = torch.randint(0, N, (nc,), generator=g, device="cuda")
    rope_ctx = tuple(t[ctx_rows][None] for t in t_frame)
    sites = {"frame": dict(x=randn(2 * NUM_FRAMES, N, C), rope=t_frame),
             "reloc": dict(x=randn(NUM_FRAMES, N, C), rope=t_frame, ctx=randn(1, nc, C)),
             "global": dict(x=randn(1, NUM_FRAMES * N, C),
                            rope=AG._tile_tables(t_frame, NUM_FRAMES))}
    res, launches = [], {k: 0 for k in wrappers}

    def run_block(pp, s, f32=False):
        x, rope = s["x"].float() if f32 else s["x"], s["rope"]
        if "ctx" in s:
            ctx = s["ctx"].float() if f32 else s["ctx"]
            return block_with_context(pp, x, ctx, cfg, rope, rope_ctx)
        return block(pp, x, cfg, rope)

    def emulated(s, m):
        x, rope = s["x"], s["rope"]
        parts = [SP.tp_block_params(p, m, i) for i in range(m)]
        ys = []
        for pl in parts:
            ekv = (block_context_kv(pl, s["ctx"], cfg, rope_ctx) if "ctx" in s else None)
            q, k, v = qkv_parts(pl, x, cfg, rope)
            o = attention_heads_out(pl["attn"], q, k, v, local_attn_cfg(pl, cfg), extra_kv=ekv)
            ys.append(SP.tp_attn_partial(pl, o))
        x1 = SP.tp_attn_residual(p, x, sum(ys[1:], ys[0]))
        y2 = [SP.tp_mlp_partial(pl, x1, cfg) for pl in parts]
        return SP.tp_mlp_residual(p, x1, sum(y2[1:], y2[0]))

    for site, s in sites.items():
        ref32 = run_block(p32, s, f32=True)
        whole = run_block(p, s)
        env = float((whole.float() - ref32).abs().max())
        env_rel = _rel_rms(whole, ref32)
        for m in TP_EXTENTS:
            for w in wrappers.values():
                w.launches = 0
            got = emulated(s, m)
            torch.cuda.synchronize()
            n = {k: w.launches for k, w in wrappers.items()}
            for k in launches:
                launches[k] += n[k]
            err = float((got.float() - ref32).abs().max())
            row = dict(site=site, m=m, max_abs_err_vs_fp32=err, whole_err_vs_fp32=env,
                       rel_rms_vs_fp32=_rel_rms(got, ref32), whole_rel_rms_vs_fp32=env_rel,
                       max_abs_vs_whole=float((got.float() - whole.float()).abs().max()),
                       launches={k: v for k, v in n.items() if v})
            print(f"  {card}: {site} block, {m} model ranks emulated: max error vs fp32 "
                  f"{err:.4e} (unsharded kernel block {env:.4e}; tolerance twice that), rel-RMS "
                  f"{row['rel_rms_vs_fp32']:.3e} (unsharded {env_rel:.3e}), vs the unsharded "
                  f"kernel block {row['max_abs_vs_whole']:.3e}; launches {row['launches']}")
            _check(f"{site} block over {m} model ranks vs fp32", err, 2 * env)
            res.append(row)
            del got
        del ref32, whole
    torch.cuda.empty_cache()
    return res, launches


def run_tp(card: str):
    """Phase 11: tensor parallelism over ``model`` on the card. (1) The
    head-shard form of LN+QKV+RoPE and LN+QKV (``check_tp_kernels``); (2)
    the m ranks of one block emulated in one process (``check_tp_blocks``);
    (3) one NCCL process of world size 1 with the tensor-parallel path
    forced (``force_single_device_spmd(tp=True)``: Megatron's blocks over a
    model group of one, the row-parallel tail plain): the joint forward, the
    build plus a full-head ``reloc`` and ``fast_reloc``, and four train
    steps of phase 5's configuration, each with its launch counts and
    times, held against the unsharded kernel program on the same weights
    (phase 3's, 4's and 5's programs) within twice that program's distance
    from fp32 (forward and serving: rel-RMS of the camera tokens, the pose
    encodings, the depth maps and the cache; the step: rel-RMS of each
    subsystem's gradients); (4) the per-rank bytes of the train state under
    TP x DDP and TP x FSDP at m = 1, 2, 4, 8 and of a 200-anchor kv2 cache
    cut over heads. Its paths go into the kernel line as "tp_shards",
    "tp_forward", "tp_serving" and "tp_train"."""
    import torch
    import torch.distributed as dist

    from self_supervise_sfm_tpu_torch.models import aggregator as AG
    from self_supervise_sfm_tpu_torch.models import sailrecon as M
    from self_supervise_sfm_tpu_torch.parallel import sharding as Sh
    from self_supervise_sfm_tpu_torch.parallel import sp_block as SP
    from self_supervise_sfm_tpu_torch.train import loop as L

    wrappers = kernel_wrappers()
    failures = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    def counted(fn):
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: w.launches for k, w in wrappers.items()}

    res, launches = {}, {}
    t0 = time.perf_counter()
    res["kernels"] = check_tp_kernels(card)
    print(f"  phase 11 (1) head-shard kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    res["blocks"], launches["tp_shards"] = check_tp_blocks(card, wrappers)
    print(f"  phase 11 (2) emulated blocks: {time.perf_counter() - t0:.1f} s")

    # -- (3) world size 1 with the tensor-parallel path forced --------------------
    cfg = M.make_config(compute_dtype="bfloat16")
    cfg32 = M.make_config(attn_impl="dense", global_attn_impl="dense", resize_impl="einsum",
                          fused_qkv="off", fused_mlp="off")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    p32 = M.init_sailrecon(cfg, gen, device="cuda")
    params = M.cast_trunk_weights(p32, cfg)
    p32 = L._unflatten(p32, [t.float() for t in L._flatten(params)])  # the bf16 weights in fp32
    uniq = torch.rand((1, NUM_FRAMES, IMG, IMG, 3), generator=gen, device="cuda")
    images = torch.cat([uniq, uniq], dim=1)

    def draw():
        return torch.Generator(device="cuda").manual_seed(SEED + 1)

    def fwd(c=cfg, p=params):
        return M.forward(p, c, images, NUM_FRAMES, NUM_FRAMES, rank=RANK, generator=draw(),
                         images_duplicated=True)

    def build(c=cfg, p=params):
        return M.build_scene_cache(p, c, uniq, rank=RANK, generator=draw())

    def relocs(cache, cam, c=cfg, p=params):
        return (M.reloc(p, c, cache, cam, uniq), M.reloc(p, c, cache, cam, uniq,
                                                         fast_reloc=True))

    # the unsharded programs and their fp32 counterparts on the same weights
    ref_out = fwd()
    ref_cache, ref_cam = build()
    ref_rel, ref_fast = relocs(ref_cache, ref_cam)
    f32_out = fwd(cfg32, p32)
    f32_cache, f32_cam = build(cfg32, p32)
    f32_rel, f32_fast = relocs(f32_cache, f32_cam, cfg32, p32)
    torch.cuda.synchronize()

    def compare(label, got, ref, f32):
        err, env = _rel_rms(got, ref), _rel_rms(ref, f32)
        print(f"  {label}: rel-RMS vs the unsharded program {err:.3e}, the unsharded "
              f"program vs fp32 {env:.3e} (tolerance twice that)")
        expect(err <= 2 * env, f"{label}: {err} over twice {env}")
        return dict(rel_rms=err, envelope=env)

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = Sh.make_mesh(1, 1, 1, device="cuda")
        print(f"  process group: nccl, world size 1; mesh {mesh.shape}, tensor-parallel "
              "path forced (a model group of one)")
        with Sh.activate_mesh(mesh), SP.force_single_device_spmd(tp=True):
            shard = SP.scene_shard(1, NUM_FRAMES, NUM_FRAMES,
                                   tp=SP.tp_engaged(AG.block_cfgs(cfg.aggregator), mesh))
            expect(shard is not None and shard.tp, "the forced mesh takes no TP layout")
            reduces = []
            reduce_from_model = SP.reduce_from_model

            def reduce_spy(*a, **k):
                reduces.append(1)
                return reduce_from_model(*a, **k)

            SP.reduce_from_model = reduce_spy
            try:
                out, n = counted(fwd)
                n_reduce_fwd = len(reduces)
                (cache, cam), nb = counted(build)
                (rel, fast), nr = counted(lambda: relocs(cache, cam))
            finally:
                SP.reduce_from_model = reduce_from_model
            launches["tp_forward"] = n
            launches["tp_serving"] = {k: nb[k] + nr[k] for k in nb}
            # 2 all-reduces a block: 24 ViT + 3 x 24 aggregator blocks
            print(f"  TP forward: launches {n}; all-reduces over model {n_reduce_fwd}")
            expect(n == TP_FORWARD_LAUNCHES, f"TP forward launches {n}")
            expect(n_reduce_fwd == 2 * 4 * cfg.aggregator.depth,
                   f"TP forward: {n_reduce_fwd} all-reduces")
            expect(nb == TP_BUILD_LAUNCHES, f"TP build launches {nb}")
            print(f"  TP build: launches {nb}; cache {tuple(cache['kv'].shape)} marked "
                  f"{cache['shards']}; reloc + fast_reloc launches {nr}")
            expect(cache["shards"] == (1, 1, 1), f"cache marked {cache['shards']}")
            expect(nr == {k: TP_RELOC_LAUNCHES[k] + TP_FAST_RELOC_LAUNCHES[k] for k in nr},
                   f"TP reloc + fast_reloc launches {nr}")
            agree = {
                "forward_cam_tokens": compare("TP forward cam tokens", out["cam_tokens"],
                                              ref_out["cam_tokens"], f32_out["cam_tokens"]),
                "forward_pose_enc": compare("TP forward pose encodings",
                                            out["pose_enc_list"][-1],
                                            ref_out["pose_enc_list"][-1],
                                            f32_out["pose_enc_list"][-1]),
                "forward_depth": compare(
                    "TP forward depth logits", _logit("depth_map", out["depth_map"]),
                    _logit("depth_map", ref_out["depth_map"]),
                    _logit("depth_map", f32_out["depth_map"])),
                "cache": compare("TP build cache", cache["kv"], ref_cache["kv"],
                                 f32_cache["kv"]),
                "build_cam": compare("TP build cam tokens", cam, ref_cam, f32_cam),
                "reloc_pose_enc": compare("TP reloc pose encodings", rel["pose_enc_list"][-1],
                                          ref_rel["pose_enc_list"][-1],
                                          f32_rel["pose_enc_list"][-1]),
                "reloc_depth": compare(
                    "TP reloc depth logits", _logit("depth_map", rel["depth_map"]),
                    _logit("depth_map", ref_rel["depth_map"]),
                    _logit("depth_map", f32_rel["depth_map"])),
                "fast_reloc_pose_enc": compare("TP fast_reloc pose encodings",
                                               fast["pose_enc_list"][-1],
                                               ref_fast["pose_enc_list"][-1],
                                               f32_fast["pose_enc_list"][-1]),
            }
            res["agreement"] = agree
            del out, cache, cam, rel, fast
            times = {}
            for name, a in (("forward", fwd), ("build", build)):
                with Sh.activate_mesh(None):
                    plain_ms = _wall_ms(a)
                tp_ms = _wall_ms(a)
                with Sh.activate_mesh(None):
                    plain_ms2 = _wall_ms(a)
                times[name] = dict(unsharded_ms=[plain_ms, plain_ms2], tp_ms=tp_ms)
                print(f"  {card}: {name} unsharded {plain_ms:.2f} / {plain_ms2:.2f} ms, "
                      f"tensor-parallel (world 1) {tp_ms:.2f} ms (medians of 3)")
            res["times"] = times
        del ref_out, ref_cache, ref_cam, ref_rel, ref_fast, f32_out, f32_cache, f32_cam
        del f32_rel, f32_fast, params, p32
        torch.cuda.empty_cache()

        # -- the train step under the forced TP path -----------------------------
        res["train"], launches["tp_train"] = _tp_train_steps(card, mesh, wrappers, expect)
    finally:
        dist.destroy_process_group()

    # -- (4) per-rank bytes ------------------------------------------------------
    full = M.make_config()
    state = {}
    for m in TP_STATE_EXTENTS:
        state[m] = dict(ddp=L.state_bytes_per_rank(full, 1, False, "bfloat16", m=m),
                        fsdp_2=L.state_bytes_per_rank(full, 2, True, "bfloat16", m=m),
                        fsdp_4=L.state_bytes_per_rank(full, 4, True, "bfloat16", m=m))
        print(f"  train state a rank (bf16 mu) at m = {m}: TP x DDP "
              f"{state[m]['ddp'] / 1e9:.3f} GB, TP x FSDP over 2 / 4 data ranks "
              f"{state[m]['fsdp_2'] / 1e9:.3f} / {state[m]['fsdp_4'] / 1e9:.3f} GB")
    acfg = full.aggregator
    per_anchor = acfg.depth * acfg.num_heads * (RANK + acfg.patch_start_idx) * 2 * acfg.head_dim * 2
    cache_b = {m: CACHE_ANCHORS * per_anchor / m for m in TP_STATE_EXTENTS}
    print(f"  a {CACHE_ANCHORS}-anchor kv2 cache cut over heads: per rank "
          + ", ".join(f"m = {m}: {b / 1e9:.3f} GB" for m, b in cache_b.items()))
    res["state_bytes"], res["cache_bytes_200_anchors"] = state, cache_b
    res["launches"] = launches
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, res


def _tp_train_steps(card, mesh, wrappers, expect):
    """Phase 11 (3), the step: phase 5's configuration, weights, batch and
    subsample under the forced TP path. The gradients of the first state
    against the unsharded kernel step's within twice its distance from the
    fp32 plain step's (per subsystem, rel-RMS); then four steps with the
    launches of the first, the all-reduces and the times."""
    import torch

    from self_supervise_sfm_tpu_torch.models import aggregator as AG
    from self_supervise_sfm_tpu_torch.models import sailrecon as M
    from self_supervise_sfm_tpu_torch.parallel import sharding as Sh
    from self_supervise_sfm_tpu_torch.parallel import sp_block as SP
    from self_supervise_sfm_tpu_torch.train import loop as L

    cfg = M.make_config(compute_dtype="bfloat16", remat=True)
    cfg32 = M.make_config(remat=True, attn_impl="dense", global_attn_impl="dense",
                          fused_qkv="off", fused_mlp="off")
    tcfg = L.TrainConfig(rank=RANK, num_images=TRAIN_FRAMES, adam_mu_dtype="bfloat16",
                         warmup_steps=1)
    batch = L.batch_to_device(make_train_batch()[0], "cuda")
    P0 = (IMG // 14) ** 2

    def indices(i):
        g = torch.Generator(device="cuda").manual_seed(SEED + 8 + i)
        return AG.draw_subsample_indices(cfg.aggregator, 1, TRAIN_FRAMES, P0, RANK, g)

    state = L.init_train_state(cfg, tcfg, torch.Generator(device="cuda").manual_seed(SEED + 7))
    _condition_pose_branch(state["params"])
    params = state["params"]
    parts = {"vit": lambda g: L._flatten(g["aggregator"]["vit"]),
             "agg": lambda g: L._flatten({k: x for k, x in g["aggregator"].items() if k != "vit"}),
             "camera": lambda g: L._flatten(g["camera_head"])}

    def rel(a, b):
        num = sum(float((x.float() - y.float()).pow(2).sum()) for x, y in zip(a, b))
        return math.sqrt(num) / float(L.global_norm(b))

    idx = indices(0)
    loss_k, _, gk = L.loss_and_grads(params, cfg, tcfg, batch, idx)
    loss_f, _, gf = L.loss_and_grads(params, cfg32, tcfg, batch, idx)
    out = {"gradients": {}}
    with Sh.activate_mesh(mesh), SP.force_single_device_spmd(tp=True):
        layout = L.state_layout(cfg, tcfg, mesh)
        expect(layout.tp, "the forced mesh gives no TP layout")
        loss_t, _, gt = L.sharded_loss_and_grads(params, cfg, tcfg, batch, layout, idx)
    print(f"  TP step loss {float(loss_t):.6f}, unsharded kernel step {float(loss_k):.6f}, "
          f"fp32 plain {float(loss_f):.6f}")
    for name, part in parts.items():
        err, env = rel(part(gt), part(gk)), rel(part(gk), part(gf))
        out["gradients"][name] = dict(rel_rms=err, envelope=env)
        print(f"  TP step gradient {name}: rel-RMS vs the unsharded kernel step {err:.4e}, "
              f"unsharded vs fp32 plain {env:.4e} (tolerance twice that)")
        expect(err <= 2 * env, f"TP step gradient {name}: {err} over twice {env}")
    # what the steps that read the first state are held to: the first
    # state's bf16 loss distance from fp32, and its gradient's (a norm
    # moves at most by the distance of the vectors)
    norm_k = float(L.global_norm(L._flatten(gk)))
    env_loss = abs(float(loss_k) - float(loss_f))
    env_norm = math.sqrt(sum(float((x.float() - y.float()).pow(2).sum())
                             for x, y in zip(L._flatten(gk), L._flatten(gf))))
    del gk, gf, gt
    torch.cuda.empty_cache()
    step = L.make_train_step(cfg, tcfg)
    out.update(metrics=[], ms=[], collectives=[])
    torch.cuda.reset_peak_memory_stats()
    with Sh.activate_mesh(mesh), SP.force_single_device_spmd(tp=True):
        state = L.train_state_from_params(params, tcfg, layout)
        for i in range(4):
            for w in wrappers.values():
                w.launches = 0
            Sh.collective_counts.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch, indices(i))
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["metrics"].append({k: float(x) for k, x in m.items()})
            out["collectives"].append(dict(Sh.collective_counts))
            if i == 0:
                launches = {k: w.launches for k, w in wrappers.items()}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"  TP step launches {launches}; collectives a step {out['collectives'][-1]}")
    expect(launches == TP_TRAIN_STEP_LAUNCHES, f"TP step launches {launches}")
    # steps 0 and 1 read the first state (learning rate 0 at step 0): held to
    # the unsharded step's loss and gradient norm within twice the first
    # state's bf16 distances from fp32 (phase 5's step where it ran, else the
    # unsharded step above for step 0). Steps 2-3 follow updates from a random
    # start, where bf16 runs part (phase 5's own gradient norm moves 5x in a
    # step): printed, not held.
    ref = [(float(loss_k), norm_k)]
    if PHASE5:
        ref = [(PHASE5["metrics"][i]["loss"], PHASE5["metrics"][i]["grad_norm"])
               for i in (0, 1)]
    for i, mt in enumerate(out["metrics"]):
        expect(all(math.isfinite(v) for v in mt.values()), f"TP step {i}: non-finite metrics")
        held = ""
        if i < len(ref):
            dl, dn = abs(mt["loss"] - ref[i][0]), abs(mt["grad_norm"] - ref[i][1])
            held = (f" (unsharded {ref[i][0]:.6g}, {ref[i][1]:.6g}: distances {dl:.3e} / "
                    f"{dn:.3e} against twice {env_loss:.3e} / {env_norm:.3e})")
            expect(dl <= 2 * env_loss, f"TP step {i} loss {mt['loss']} vs {ref[i][0]}: "
                                       f"over twice {env_loss}")
            expect(dn <= 2 * env_norm, f"TP step {i} grad_norm {mt['grad_norm']} vs "
                                       f"{ref[i][1]}: over twice {env_norm}")
        elif PHASE5:
            held = (f" (phase 5: {PHASE5['metrics'][i]['loss']:.6g}, "
                    f"{PHASE5['metrics'][i]['grad_norm']:.6g}; after an update, not held)")
        print(f"  TP step {i}: loss {mt['loss']:.6g}, grad_norm {mt['grad_norm']:.6g}{held}")
    out["first_state_envelope"] = dict(loss=env_loss, grad_norm=env_norm)
    print(f"  {card}: TP step (world 1) {[round(x, 2) for x in out['ms']]} ms, peak "
          f"{out['peak_gb']:.2f} GB" + (f"; phase 5's {[round(x, 2) for x in PHASE5['ms']]}"
                                        if PHASE5 else ""))
    del state, params
    torch.cuda.empty_cache()
    return out, launches


def run_torchrun_tp(card: str) -> dict:
    """``--torchrun-tp``: tensor parallelism across the cards of one machine,
    under ``torchrun --nproc_per_node N`` (N = 2 or 4, one NCCL rank a card,
    a (1, 1, N) mesh). Every rank runs the full-width joint forward of phase
    11 with the heads cut over N (3 runs timed), then rank 0 runs the
    one-device forward and its fp32 counterpart on the same weights: the TP
    forward's camera tokens, pose encodings and depth maps within twice the
    one-device forward's rel-RMS distance from fp32. Then the trainer at
    ``num_model = N`` for 3 steps of phase 6's configuration (no
    checkpoint, no diagnostics), and rank 0 the one-device trainer on the
    same scenes, the later losses printed (the runs part as bf16 sums
    part); step intervals, frames a second a card and every rank's peak
    memory. Then the first bf16 loss at ``C1_SEEDS`` more seeds of the
    first state and batch (one step each, TP and one card), and the check
    over seed 0 and those: TP's median first-loss distance from the fp32
    plain path's loss on the same state and batch within twice one card's
    median distance (every seed's figures printed: one draw of bf16
    rounding decides nothing).
    Then the same 3 steps in fp32 on the kernels (the fp32 forms of K1 / K2
    and B9's fp32 pair, their launches on rank 0 printed), TP against one
    card: steps 1 and 2 read the first state, so their loss (rtol 1e-4) and
    gradient norms (rtol 1e-3) are held with no bf16 rounding in the way.
    Build the kernels once before starting the ranks."""
    import os
    import shutil

    import torch
    import torch.distributed as dist

    from self_supervise_sfm_tpu_torch.models import sailrecon as M
    from self_supervise_sfm_tpu_torch.parallel import sharding as Sh
    from self_supervise_sfm_tpu_torch.train import loop as L
    from self_supervise_sfm_tpu_torch.train import trainer as T
    from self_supervise_sfm_tpu_torch.train.loss import LossConfig

    T.maybe_init_distributed("cuda")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < 2:
        raise ValueError("--torchrun-tp runs under torchrun --nproc_per_node 2 or 4")
    primary = dist.get_rank() == 0
    failures = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    def peaks():
        peak = torch.tensor([torch.cuda.max_memory_allocated() / 1e9], device="cuda")
        got = [torch.zeros_like(peak) for _ in range(world)]
        dist.all_gather(got, peak)
        return [float(p) for p in got]

    out = {"world": world}
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "torchrun_tp")
    try:
        cfg = M.make_config(compute_dtype="bfloat16")
        cfg32 = M.make_config(attn_impl="dense", global_attn_impl="dense",
                              resize_impl="einsum", fused_qkv="off", fused_mlp="off")
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = M.cast_trunk_weights(M.init_sailrecon(cfg, gen, device="cuda"), cfg)
        uniq = torch.rand((1, NUM_FRAMES, IMG, IMG, 3), generator=gen, device="cuda")
        images = torch.cat([uniq, uniq], dim=1)

        def fwd(c=cfg, p=params):
            return M.forward(p, c, images, NUM_FRAMES, NUM_FRAMES, rank=RANK,
                             generator=torch.Generator(device="cuda").manual_seed(SEED + 1),
                             images_duplicated=True)

        mesh = Sh.make_mesh(1, 1, world, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        with Sh.activate_mesh(mesh):
            tp_out = fwd()
            Sh.collective_counts.clear()
            tp_ms = [_wall_ms(fwd, reps=1) for _ in range(3)]
            collectives = dict(Sh.collective_counts)
        out["forward"] = dict(tp_ms=tp_ms, peak_gb=peaks(), collectives_3_runs=collectives)
        if primary:
            ref = fwd()
            one_ms = [_wall_ms(fwd, reps=1) for _ in range(3)]
            p32 = L._unflatten(params, [t.float() for t in L._flatten(params)])
            f32 = fwd(cfg32, p32)
            del p32
            agree = {}
            for key, pick in (("cam_tokens", lambda o: o["cam_tokens"]),
                              ("pose_enc", lambda o: o["pose_enc_list"][-1]),
                              ("depth_map", lambda o: o["depth_map"])):
                err, env = _rel_rms(pick(tp_out), pick(ref)), _rel_rms(pick(ref), pick(f32))
                agree[key] = dict(rel_rms=err, envelope=env)
                expect(err <= 2 * env, f"TP forward {key}: {err} over twice {env}")
            out["forward"].update(one_device_ms=one_ms, agreement=agree)
            print(f"  {card}: forward with the heads over {world} cards "
                  f"{[round(x, 2) for x in tp_ms]} ms, one card {[round(x, 2) for x in one_ms]} "
                  f"ms; agreement with the one-card forward {agree}; peak GB by rank "
                  f"{out['forward']['peak_gb']}; collectives in 3 runs {collectives}", flush=True)
            del ref, f32
        del tp_out, params
        torch.cuda.empty_cache()
        dist.barrier()

        def trainer_cfg(name, num_model, dtype="bfloat16", seed=SEED, steps=3):
            return T.TrainerConfig(
                data_root=SyntheticScenes(2, TRAIN_FRAMES, 10_000, IMG, seed + 11),
                results_dir=os.path.join(work, name), total_steps=steps,
                num_images=TRAIN_FRAMES, sample_num=10_000, rank=RANK, seed=seed,
                num_model=num_model,
                checkpoint_every=0, sanity_check_every=0, artifact_every=0, log_every=1,
                compute_dtype=dtype,
                train=L.TrainConfig(warmup_steps=1, adam_mu_dtype="bfloat16",
                                    loss=LossConfig(max_val=30.0)))

        def one_device_run(name, dtype="bfloat16", **kw):
            make_mesh = T._make_mesh
            T._make_mesh = lambda cfg_, dev: None  # rank 0 alone: the one-device trainer
            try:
                torch.cuda.reset_peak_memory_stats()
                T.run(trainer_cfg(name, 1, dtype, **kw))
            finally:
                T._make_mesh = make_mesh

        def first_losses(tc):
            """The loss of the bf16 kernel path and of the fp32 plain path
            at the first state and batch of trainer config ``tc``, on one
            card."""
            tcfg = dataclasses.replace(tc.train, total_steps=tc.total_steps, rank=tc.rank,
                                       num_images=tc.num_images)
            stream = T.scene_stream(tc.data_root, range(tc.scenes_per_step_per_device),
                                    tc.seed, 1)
            batch0 = L.batch_to_device(next(stream), "cuda")
            stream.close()
            p0 = L.init_train_state(T._model_config(tc), tcfg, torch.Generator(
                device="cuda").manual_seed(tc.seed))["params"]
            cfg32 = M.make_config(img_size=tc.img_size, attn_impl="dense",
                                  global_attn_impl="dense", fused_qkv="off", fused_mlp="off")
            with torch.no_grad():
                loss_k = float(L._loss_fn(p0, T._model_config(tc), tcfg, batch0,
                                          **T.step_subsample(tc.seed, 0, "cuda"))[0])
                loss_f = float(L._loss_fn(p0, cfg32, tcfg, batch0,
                                          **T.step_subsample(tc.seed, 0, "cuda"))[0])
            del p0, batch0
            return loss_k, loss_f

        def rows(name):
            with open(os.path.join(work, name, "tensorboard", "metrics.jsonl")) as f:
                return [r for r in map(json.loads, f) if r["prefix"] == "train"]

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = T.run(trainer_cfg("tp", world))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        del state
        torch.cuda.empty_cache()
        out["trainer"] = dict(run_s=run_s, peak_gb=peaks())
        if primary:
            one_device_run("one_device")
            a, b = rows("tp"), rows("one_device")
            la, lb = [r["loss"] for r in a], [r["loss"] for r in b]
            rel_d = [abs(x - y) / abs(y) for x, y in zip(la, lb)]
            expect(len(la) == len(lb) == 3 and all(math.isfinite(x) for x in la),
                   f"trainer losses {la} / {lb}")
            # the first step's state and batch again, on one card: the loss of
            # the bf16 kernel path and of the fp32 plain path
            loss_k, loss_f = first_losses(trainer_cfg("one_device", 1))
            env = abs(loss_k - loss_f)
            out["trainer"].update(
                first_loss_bf16=loss_k, first_loss_fp32=loss_f, first_loss_envelope=env,
                losses=la, one_device_losses=lb, rel_diff=rel_d,
                step_ms=[1e3 / r["steps_per_sec"] for r in a[1:]],
                one_device_step_ms=[1e3 / r["steps_per_sec"] for r in b[1:]],
                frames_per_s_per_card=[r["frames_per_sec_per_chip"] for r in a[1:]])
            print(f"  {card}: trainer with the heads over {world} cards: losses {la}, one card "
                  f"{lb} (rel {[f'{x:.2e}' for x in rel_d]}); the first state's loss on one "
                  f"card {loss_k:.6f} (bf16 kernels), {loss_f:.6f} (fp32 plain): the first "
                  f"losses' distance {abs(la[0] - lb[0]):.3e} against twice {env:.3e}; "
                  f"step intervals (steps 2-3) "
                  f"{[round(x, 2) for x in out['trainer']['step_ms']]} ms, one card "
                  f"{[round(x, 2) for x in out['trainer']['one_device_step_ms']]} ms; frames/s "
                  f"a card {out['trainer']['frames_per_s_per_card']}; peak GB by rank "
                  f"{out['trainer']['peak_gb']}", flush=True)
        dist.barrier()
        torch.cuda.empty_cache()

        # the bf16 first loss of TP and of one card at more seeds of the first
        # state and batch (one step each); with seed 0 above, the check: TP's
        # median distance from the fp32 plain loss within twice one card's
        spread = []

        def seed_row(seed, la, lb, lk, lf):
            spread.append(dict(seed=seed, tp=la, one_device=lb, bf16_kernels=lk, fp32_plain=lf,
                               tp_distance=abs(la - lf), one_device_distance=abs(lb - lf),
                               distance=abs(la - lb), envelope=abs(lk - lf),
                               ratio=abs(la - lb) / abs(lk - lf)))
            print(f"  {card}: seed {seed}: bf16 first loss with the heads over {world} cards "
                  f"{la:.6f}, one card {lb:.6f}, fp32 plain {lf:.6f}: distance from fp32 TP "
                  f"{abs(la - lf):.3e}, one card {abs(lb - lf):.3e}; TP - one card "
                  f"{abs(la - lb):.3e}, envelope |bf16 kernels - fp32 plain| {abs(lk - lf):.3e} "
                  f"(ratio {spread[-1]['ratio']:.2f})", flush=True)

        if primary:
            seed_row(SEED, la[0], lb[0], loss_k, loss_f)
        for seed in range(SEED + 1, SEED + 1 + C1_SEEDS):
            T.run(trainer_cfg(f"tp_s{seed}", world, seed=seed, steps=1))
            torch.cuda.empty_cache()
            if primary:
                one_device_run(f"one_device_s{seed}", seed=seed, steps=1)
                la, lb = rows(f"tp_s{seed}")[0]["loss"], rows(f"one_device_s{seed}")[0]["loss"]
                lk, lf = first_losses(trainer_cfg(f"one_device_s{seed}", 1, seed=seed, steps=1))
                seed_row(seed, la, lb, lk, lf)
            dist.barrier()
            torch.cuda.empty_cache()
        if primary:
            med_tp = statistics.median(r["tp_distance"] for r in spread)
            med_one = statistics.median(r["one_device_distance"] for r in spread)
            out["trainer"].update(first_loss_seed_spread=spread, median_tp_distance=med_tp,
                                  median_one_device_distance=med_one)
            print(f"  {card}: over seeds {[r['seed'] for r in spread]}: median bf16 first-loss "
                  f"distance from the fp32 plain loss, TP {med_tp:.3e}, one card {med_one:.3e} "
                  f"(TP within twice one card's: {med_tp <= 2 * med_one})", flush=True)
            expect(med_tp <= 2 * med_one,
                   f"TP trainer's median first-loss distance from fp32 {med_tp} over twice one "
                   f"card's {med_one} (seeds {[r['seed'] for r in spread]})")

        # the same three steps in fp32 on the kernels (no bf16 rounding to
        # tell apart from a fault of the cut): steps 1 and 2 read the first
        # state (learning rate 0 at step 1), so their loss and gradient norms
        # must agree with one card's to fp32's summation order; step 3 follows
        # an update and is printed
        wrappers = kernel_wrappers()
        for w in wrappers.values():
            w.launches = 0
        T.run(trainer_cfg("tp_fp32", world, "float32"))
        torch.cuda.synchronize()
        tp_launches = {k: w.launches for k, w in wrappers.items() if w.launches}
        torch.cuda.empty_cache()
        if primary:
            for w in wrappers.values():
                w.launches = 0
            one_device_run("one_device_fp32", "float32")
            one_launches = {k: w.launches for k, w in wrappers.items() if w.launches}
            print(f"  fp32 trainer launches, rank 0 with the heads over {world} cards: "
                  f"{tp_launches}; one card: {one_launches}", flush=True)
            expect(tp_launches.get("flash_bwd_dq_f32", 0) > 0
                   and one_launches.get("flash_bwd_dq_f32", 0) > 0
                   and not any(k.startswith("fused") for k in tp_launches),
                   f"fp32 trainer off the fp32 kernels: {tp_launches} / {one_launches}")
            out["trainer_fp32_launches"] = dict(tp_rank0=tp_launches, one_device=one_launches)
            a, b = rows("tp_fp32"), rows("one_device_fp32")
            keys = ("loss", "grad_norm", "grad_norm_vit", "grad_norm_agg", "grad_norm_camera")
            fp32 = {k: dict(tp=[r[k] for r in a], one_device=[r[k] for r in b],
                            rel=[abs(x[k] - y[k]) / abs(y[k]) for x, y in zip(a, b)])
                    for k in keys}
            expect(len(a) == len(b) == 3, f"fp32 trainer rows {len(a)} / {len(b)}")
            for k, tol in zip(keys, (1e-4,) + (1e-3,) * 4):
                worst = max(fp32[k]["rel"][:2])
                expect(worst <= tol, f"fp32 TP trainer {k} at the first state: relative "
                                     f"distance {worst:.3e} from one card's over {tol:g}")
            out["trainer_fp32"] = fp32
            print(f"  {card}: fp32 trainer on the kernels with the heads over {world} cards "
                  "against one card (steps 1-2 the first state, held: loss rtol 1e-4, gradient "
                  "norms 1e-3; "
                  "step 3 after an update): "
                  + "; ".join(f"{k} {[f'{x:.6g}' for x in v['tp']]} vs "
                              f"{[f'{x:.6g}' for x in v['one_device']]} (rel "
                              f"{[f'{x:.2e}' for x in v['rel']]})" for k, v in fp32.items()),
                  flush=True)
        dist.barrier()
    finally:
        if dist.is_initialized():
            dist.barrier()
            if primary:
                shutil.rmtree(work, ignore_errors=True)
            dist.destroy_process_group()
    if failures:
        raise AssertionError("; ".join(failures))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from self_supervise_sfm_tpu_torch import _kernels

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t_start = t0 = time.perf_counter()
    _kernels.library()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.2f} s (to the end of each "
          f"source's nvcc, side by side, and the link: "
          f"{ {k: round(v, 2) for k, v in _kernels.build_seconds.items()} })")
    print_build_log(_kernels.build_log)
    print_sm90_build()

    if "--train-only" in sys.argv[1:]:
        print("phase 5 alone: full-width train step")
        _, train = run_train()
        print(json.dumps({"train": train}))
        return 0
    if "--demo-only" in sys.argv[1:]:
        print("phase 7 alone: the reconstruction demo (forward and reloc with --tracks-ba), "
              "the tracker, the DINO ranking, bundle adjustment on known geometry")
        _, demo = run_demo()
        print(json.dumps({"demo": demo}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--converter-only" in sys.argv[1:]:
        print("phase 8 alone: the converter round trip, the TrackHead, the ViT widths, ALIKED")
        t0 = time.perf_counter()
        _, conv = run_converter()
        print(f"phase 8: {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"converter": conv}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--sharded-only" in sys.argv[1:]:
        print("phase 9 alone: the multi-device path (NCCL, world size 1, sharded path "
              "forced) and the ring's fold")
        t0 = time.perf_counter()
        _, sharded = run_sharded(card)
        print(f"phase 9: {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"sharded": sharded}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--torchrun-trainer" in sys.argv[1:]:
        print("the trainer on every card of the machine (one rank a card under torchrun; "
              "without it, the one-device reference)")
        result = run_torchrun_trainer(card)
        if int(os.environ.get("RANK", 0)) == 0:
            print(json.dumps({"torchrun_trainer": result}))
            print(json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}}))
        return 0
    if "--tp-only" in sys.argv[1:]:
        print("phase 11 alone: tensor parallelism (the head-shard kernels, the emulated "
              "blocks, NCCL world size 1 with the TP path forced)")
        t0 = time.perf_counter()
        _, tp = run_tp(card)
        print(f"phase 11: {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"tp": tp}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--torchrun-tp" in sys.argv[1:]:
        print("tensor parallelism across the cards of the machine (one rank a card under "
              "torchrun): the forward and the trainer against one card")
        result = run_torchrun_tp(card)
        if int(os.environ.get("RANK", 0)) == 0:
            print(json.dumps({"torchrun_tp": result}))
            print(json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}}))
        return 0
    if "--sharded-train-only" in sys.argv[1:]:
        print("phase 10 alone: multi-device training (NCCL, world size 1, sharded path "
              "forced): the DDP and FSDP steps, the trainer under the mesh, "
              "ba_solve_multihost")
        t0 = time.perf_counter()
        _, sharded_train = run_sharded_train(card)
        print(f"phase 10: {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"sharded_train": sharded_train}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--d128-only" in sys.argv[1:]:
        print("phase 2 (head dim 128 part) and phase 4b alone: the head dim 128 kernels, then "
              "the model at 8 heads of 128")
        d128_gen = torch.Generator(device="cuda").manual_seed(SEED + 83)
        kernels = check_d128_kernels(
            lambda *shape, dtype=torch.bfloat16: torch.randn(
                shape, generator=d128_gen, device="cuda").to(dtype),
            lambda ref, n: n * 2.0 ** (math.floor(math.log2(float(ref.abs().max()))) - 7))
        torch.cuda.empty_cache()
        launches, d128 = run_d128()
        print("phase 5b: the train step at 8 heads of 128 (B9 at head dim 128)")
        train_launches, train_d128 = run_train_d128()
        launches.update(train_launches)
        for k in kernels:
            k["launches_by_path"] = {path: n[k["name"]] for path, n in launches.items()}
            k["launches"] = sum(k["launches_by_path"].values())
        print(json.dumps({"d128": d128}))
        print(json.dumps({"train_d128": train_d128}))
        print(json.dumps({"kernels": kernels}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--trainer-only" in sys.argv[1:]:
        print("phases 5 and 6 alone: the bare train step, then the trainer around it")
        _, train = run_train()
        torch.cuda.empty_cache()
        _, trainer = run_trainer(train["step_ms"])
        print(f"{card}: trainer {trainer['trainer_steps_per_s']:.4f} steps/s against the bare "
              f"step's {train['steps_per_s']:.4f}, peak memory {trainer['peak_gb']:.2f} GB")
        print(json.dumps({"trainer": trainer}))
        return 0
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    print("phase 2: kernels against their plain versions at main-path shapes")
    kernels = check_kernels(gen)
    torch.cuda.empty_cache()
    if "--kernels-only" in sys.argv[1:]:
        print(json.dumps({"kernels": kernels}))
        return 0
    print("phase 3: full-width forward (bf16 trunk, 5 anchors + 5 queries, rank 300)")
    launches, state, fwd = run_forward(gen)
    print(f"{card}: forward {fwd['frames_per_s']:.3f} frames/s, "
          f"peak memory {fwd['peak_gb']:.3f} GB")
    print("phase 4: two-phase serving (scene-cache build, reloc; 5 and 20 anchors)")
    serving_launches, serving = run_serving(state)
    print("phase 4b: head dim 128 (8 heads of 128 at width 1024): the forward and two-phase "
          "serving on the head dim 128 kernels")
    d128_launches, d128 = run_d128(state)
    by_path = {"forward": launches, "forward_default": state["default_launches"],
               "forward_on_f32": state["on_f32_launches"], **serving_launches, **d128_launches}
    for k in kernels:
        k["launches_by_path"] = {path: n[k["name"]] for path, n in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    print(f"{card}: build {serving['build_ms']:.2f} ms, reloc "
          f"{serving['reloc_frames_per_s']:.3f} frames/s (full heads), "
          f"{serving['fast_reloc_frames_per_s']:.3f} frames/s (fast_reloc)")
    print(f"{card}: head dim 128 forward {d128['forward_ms']:.2f} ms against the flagship's "
          f"{d128['flagship_ms']:.2f} ms in turns, build {d128['build_ms']:.2f} ms, reloc "
          f"{d128['reloc_ms']:.2f} ms")
    if "--until-serving" in sys.argv[1:]:
        print(json.dumps({"forward": fwd}))
        print(json.dumps({"serving": serving}))
        print(json.dumps({"d128": d128}))
        print(json.dumps({"kernels": kernels}))
        return 0
    # phase 3's weights wait on the host for phase 7 (the card's memory goes
    # to phases 5 and 6)
    demo_params = _to_device(state["params"], "cpu")
    phase3 = {"uniq": state["uniq"].cpu(), "out_host": state["out_host"]}
    del state
    torch.cuda.empty_cache()
    print("phase 5: full-width train step (2 frames, depth 24, rank 300, bf16 trunk, "
          "fp32 masters, remat)")
    train_launches, train = run_train(keep=True)
    for k in kernels:
        k["launches_by_path"]["train"] = train_launches[k["name"]]
        k["launches_by_path"]["train_default"] = train["default"]["launches"][k["name"]]
        k["launches_by_path"]["train_on_f32"] = train["on_f32"]["launches"][k["name"]]
        k["launches"] += (train_launches[k["name"]] + train["default"]["launches"][k["name"]]
                          + train["on_f32"]["launches"][k["name"]])
    print(f"{card}: train step {train['step_ms']:.2f} ms, {train['steps_per_s']:.4f} "
          f"steps/s, peak memory {train['peak_gb']:.2f} GB")
    print("phase 5b: the train step at 8 heads of 128 (B9 at head dim 128), in turns "
          "against phase 5's")
    train_d128_launches, train_d128 = run_train_d128(
        PHASE5.pop("live"), train["profile"]["busy_ms"] if train["profile"]["measured"] else None)
    for k in kernels:
        for path, n in train_d128_launches.items():
            k["launches_by_path"][path] = n[k["name"]]
            k["launches"] += n[k["name"]]
    print(f"{card}: head dim 128 train step {train_d128['step_ms']:.2f} ms against the "
          f"flagship's {train_d128['flagship_ms']:.2f} ms in turns")
    torch.cuda.empty_cache()
    print("phase 6: the trainer (scene stream, checkpoints and resume, validation, "
          "sanity check) around the full-width step")
    trainer_launches, trainer = run_trainer(train["step_ms"])
    for k in kernels:
        k["launches_by_path"]["trainer"] = trainer_launches[k["name"]]
        k["launches"] += trainer_launches[k["name"]]
    print(f"{card}: trainer {trainer['trainer_steps_per_s']:.4f} steps/s against the bare "
          f"step's {train['steps_per_s']:.4f}, idle share {trainer['profile']['idle_share']:.3f}, "
          f"checkpoint {trainer['checkpoint_gb']:.2f} GB, peak memory {trainer['peak_gb']:.2f} GB")
    torch.cuda.empty_cache()
    print("phase 7: the reconstruction demo (forward and reloc with --tracks-ba), the "
          "tracker, the DINO ranking, bundle adjustment on known geometry")
    demo_launches, demo = run_demo(demo_params)
    for k in kernels:
        k["launches_by_path"]["demo"] = demo_launches[k["name"]]
        k["launches"] += demo_launches[k["name"]]
    torch.cuda.empty_cache()
    print("phase 8: the converter round trip (5 GB, the demo's --pretrained path), the "
          "TrackHead, the ViT widths, ALIKED on the card")
    t0 = time.perf_counter()
    converter_launches, conv = run_converter(demo_params, phase3)
    print(f"phase 8: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    print("phase 9: the multi-device path (NCCL, world size 1, sharded path forced: the "
          "sharded forward, build and reloc) and the ring's fold at the global site")
    t0 = time.perf_counter()
    sharded_launches, sharded = run_sharded(card, demo_params, phase3)
    print(f"phase 9: {time.perf_counter() - t0:.1f} s")
    del demo_params
    torch.cuda.empty_cache()
    print("phase 10: multi-device training (NCCL, world size 1, sharded path forced): the "
          "DDP and FSDP steps against phase 5, the trainer under the mesh against phase 6, "
          "ba_solve_multihost")
    t0 = time.perf_counter()
    sharded_train_launches, sharded_train = run_sharded_train(card, trainer)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    print("phase 11: tensor parallelism (LN+QKV(+RoPE) on a head shard at m = 2 and 4, the m "
          "ranks of a block emulated, NCCL world size 1 with the TP path forced: forward, "
          "build and reloc, four train steps)")
    t0 = time.perf_counter()
    tp_launches, tp = run_tp(card)
    print(f"phase 11: {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        k["tp_sites"] = tp["kernels"].get(k["name"], [])
    for k in kernels:
        for path, n in {**sharded_launches, **sharded_train_launches, **tp_launches}.items():
            k["launches_by_path"][path] = n[k["name"]]
            k["launches"] += n[k["name"]]
    for k in kernels:
        for path, n in converter_launches.items():
            k["launches_by_path"][path] = n[k["name"]]
            k["launches"] += n[k["name"]]
        # phase 8's sites at the other ViT widths, beside phase 2's (whose
        # sums stay the kernel line's numbers)
        k["width_sites"] = [s_ for ws in conv["width_sites"].values()
                            for s_ in ws.get(k["name"], [])]
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was launched on no path")
    print(f"chip_smoke: phases 1-11 in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"demo": demo}))
    print(json.dumps({"converter": conv}))
    print(json.dumps({"forward": fwd}))
    print(json.dumps({"train": train}))
    print(json.dumps({"train_d128": train_d128}))
    print(json.dumps({"trainer": trainer}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"sharded": sharded}))
    print(json.dumps({"sharded_train": sharded_train}))
    print(json.dumps({"tp": {k: v for k, v in tp.items() if k != "kernels"}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
