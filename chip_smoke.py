#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU, the CUDA
toolkit (nvcc) and PyTorch built for CUDA. It imports nothing of JAX and
nothing of the JAX package. Device time, busy time and host syncs are read
with the benchmark's own code (``portbench/trace.py``), and every bound
uses its peaks (``portbench/peaks.py``).

A kernel's bit-equality checks on the card go in
``tests/test_torch_<name>_card.py`` (marker ``card``, run with
``python -m pytest --noconftest -m card tests/test_torch_<name>_card.py``);
this script times and bounds the kernel for the kernel table in
``PERF.md``. (The checks of the kernels before that rule still run here.)

In order, and failing (non-zero exit, no final result line) on the first
thing that is wrong:

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds every kernel of the port from ``i3dr_stereo_tpu_torch/csrc`` and
   measures the card's popcount rate (``csrc/popc_probe.cu``) beside the
   rate the bounds of the two census kernels assume;
3. runs each kernel against its plain torch twin on the card:
   - census cost, every SGM sweep, the sweep that ends in the WTA and
     the row gather at every level of the flagship pyramid at its own
     shape (2448x2048, 1224x1024, 612x512 and 306x256, padded to
     multiples of 128; D = 32, NW = 3, 4 paths, P1/P2 = 0.1/0.8,
     bpm = -16 with the warp gather, and the coarsest level unwarped
     from the minimum disparity; subpixel on level 0), with each level's
     radius-17 backmatch gather, and at small ragged shapes with bpm > 0
     and bpm < 0, 4 and 8 paths, 9x9 and 17x17 census (the unclamped
     forward plane): costs and the int16 / float32 running sums after
     every sweep bit-equal; valid masks identical, disparities within
     1e-4, gathers bit-equal; the row gather also alone on random
     indices and anchors at radius 0, 17, 63 and 200 (wider than its
     staged window), W = 131, 256, 300 and 512, H = 8, 16 and 64, and
     rows off 16-byte alignment. Level 0 times every sweep, the up-sweep
     with and without the WTA, and the stage, and the row gather beside
     ``torch.gather``. ``census_cost`` alone also
     where its strips and runs are ragged: 5x5, 9x9 and 17x17 census
     (NW = 1, 3, 9), D = 8, 32, 48, bpm = 5, -16, 300, -300 (beyond a
     strip on either side), B = 2, W_real < W, H_real < H, and rows of
     2448 columns;
   - the census transform: level 0's two images (the left one and the
     right one warped by the row gather, 2048x2560, 9x9) in one launch,
     timed; then windows 3x3, 9x9, 17x17, 5x7 and 61x61 (wider than its
     image on both axes), B = 2, images smaller than the window, 2-4 grey
     levels, W = 2449, 9x9 at widths no multiple of its tiles (100, 131),
     1-row and 1-column images, as a pair and as one image: bit-equal
     (``torch.equal``);
   - remap at 2448x2048 on the distorted rig of ``bench.py``
     (pipeline_batch), uint8 and float32 sources, cubic and linear,
     B = 1 and 2, each camera alone and both in one launch
     (``rectify_pair``): bit-equal (the left cubic uint8
     B = 1 case timed by events and back to back, the pair beside two
     single calls, and ``grid_sample``);
   - the speckle keep-mask: on level 0's disparities of the flagship
     scene after the downsample-2 front-end (1224x1024, S = 25, max_diff
     1.0), on the same disparities at full 2448x2048 (S = 100 / 0.5), on
     a smooth one-component frame; at 1224x1024 on a serpentine through
     every tile (S = 25), a 194-px one across tile edges at S = its
     size and one less, the one-component frame,
     squares of exactly 25 px (dropped) and 26 px (kept) across tile
     corners and an all-invalid frame (the number removed checked too);
     on random blob fields (S = 12, 100, 200) and on a batch of ragged
     131x45 frames: identical;
4. drives the product's frame: raw uint8 images into
   ``StereoPipeline(device="cuda")`` with ``rectify_inputs=True`` (bicubic)
   and ``bench.py:_flagship_cfg`` unchanged (speckle 100 / 0.5 at
   downsample 2), on a 2448x2048 layered scene: on the ideal rig every
   kernel must launch during one frame and the median error against
   ground truth must be below 0.25 px (density > 0.5); on the distorted
   rig the outputs must be finite; the same matcher through the plain
   twins on the card must agree at 256x320;
5. times the full path (CUDA events, median of 10 frames after warm-up),
   the matcher alone and through the twins (once), the matcher run
   eagerly and replayed as a CUDA graph in turns (host ms and device ms;
   the replay bit-equal to the eager match), and the path without
   rectification and speckle (rectified float inputs), each with the
   card's name and power limit;
6. profiles five back-to-back frames of the full path: device busy
   time, idle share and the device time of the largest kernels, all
   from that one window;
7. runs the volume SGM kernel (``sgm_volume``, one path direction per
   launch, each folded into the running sum S and the group total T in
   place) against its plain twin: the chain's S and the whole
   aggregation bit-equal (and each direction's path costs alone where
   said), at 1x1024x1280x128 float32 with 8 paths (P1/P2 200/400) in the
   float32 mode (every direction alone too; the chain timed whole and
   launch by launch) and in the int16 mode, 1x1024x1280x64 census-scale
   float32 with 4 paths (0.1/0.8), uint8 with sentinels into the int16
   mode at 256x320x64, a 1160x8x400 uint8 volume whose vertical families
   split into groups of one, and a ragged B = 2 131x45x130 volume with
   per-direction penalties and with a vertical group first (both
   modes);
8. drives the SGBM frame: raw uint8 images of ``accuracy_bench.py``'s
   1280x1024 scene through ``StereoPipeline(device="cuda")`` with
   rectification and its SGBM config (D = 128, window 5, 8 paths,
   P1/P2 200/400, uniqueness 10, disp12MaxDiff 1, speckle off,
   subpixel): ``sgm_volume`` must launch during one frame, the
   median error must be below 0.25 px at density > 0.5, and the matcher
   through the plain twins must agree at 256x320; then runs the SGBM
   defaults (speckle 100 / 4.0 at full resolution), the BM defaults and
   dense I3DRSGM at D = 64 once each at 1280x1024 (finite, density
   reported); times the SGBM frame and matcher (CUDA events, median of
   10), reports peak memory, and profiles five SGBM frames as in 6;
9. runs the fused cost + SGM kernels (``fused_census_fwd``,
   ``fused_bt_fwd``) against their plain twins, C and S bit-equal in the
   float32 and the int16 mode: the census kernel at every lean pyramid
   level's shape of the 2448x2048 frame (2048x2448, 1024x1224, 512x616
   and 256x312 after padding to multiples of 8; D = 32, NW = 3, base
   -16 on inputs warped by the prediction, the coarsest level unwarped
   from the minimum disparity; level 0 timed), at 1x2048x2448x256 base 0
   (timed), a 17x17 census, non-uniform bases below -64 and a ragged
   B = 2 frame (W = 131) at D = 48 and at D = 32, there also with bases
   that leave whole rows without a valid column, 5x5 and 17x17 words and
   a partial last warp; the BT kernel at 1x1024x1280x128 (timed) and on
   the ragged B = 2 frame at D = 1, 16, 48, 128, 130, 256, 300, 384 and
   512, W = 131, 64 and 20 (narrower than one staged tile), negative
   minimum disparities and bases that empty rows; then ``fused_census_sgm``
   (4 paths, level 0's shape, and 8 paths on the ragged frame) and
   ``fused_bt_sgm`` (8 paths, 1024x1280x128) whole against their twins
   (at level 0's shape in the int16 and the float32 mode);
10. drives the lean flagship frame: as 4, through
    ``StereoPipeline(device="cuda", lean=True)``: ``census_transform``,
    ``fused_census_fwd``, ``sgm_volume``, ``speckle_ccl`` and ``remap``
    must launch during one
    frame, the same accuracy gate, the matcher
    through the twins at 256x320, timings, peak memory and the 5-frame
    profile;
11. drives the lean SGBM frame: 8's scene and config with
    ``window_size=1`` through ``StereoPipeline(device="cuda",
    lean=True)``: ``fused_bt_fwd`` must launch, the same gates, and the
    ``lean=False`` frame at the same config timed in turns with it
    (lean, default, default, lean), peak memory and profile of both;
12. runs ``bench.py:sgm_direct_2448``'s chain once at 2048x2448: census
    -> ``fused_census_sgm`` (D = 256, 4 paths, int16 mode) -> WTA ->
    min C < 255 -> LR check 1.5 -> speckle 100 / 0.5 at downsample 2:
    finite, density, error against ground truth and peak memory
    reported;
13. runs the post-match kernels against their twins: ``gauss_rays`` (the
    32-direction Gauss fill) on level 0's disparities and valid mask of
    the flagship frame (its own holes, timed) and at 9 more shapes
    (B = 2, ragged, min_elements 5 and 32, 16 directions at radius 40,
    weights that underflow, radius 33, 8 directions, all holes, no
    hole): masks bit-equal, values within 1e-6 relative (exp); radius 32
    and 65 raise; ``wls_lines`` (the WLS line solve) for the horizontal
    and the vertical pass at 2448x2048 and 1280x1024 on that frame's
    guide, data and mask: bit-equal, each timed; at 8 more shapes (lines
    of 1 to 4095 elements, blocks of 1, 2, 4 and 8 lines, B = 2 with
    blocks of lines across the two planes, rows off 16-byte alignment)
    both passes bit-equal;
    one line alone of 2448 and of 2048 (the chain); the whole WLS fill
    (6 launches) timed;
14. drives the ``I3DRSGM`` facade (``matchers/i3drsgm.py``) on the
    flagship scene (rectified float32 images) with ``quick_profile()``
    and ``subpix_profile()``: every kernel of its path must launch
    during one frame, the accuracy gate, ms/frame, peak memory, the
    5-frame profile, ``backward_match`` once, and the kernels against
    the twins (``enableCPU(True)``) at 256x320. ``subpix_profile()``
    as shipped has a top prediction shift of +8 at level 5 (+256 px at
    full resolution), above every disparity of this scene: it runs once
    as shipped (density and error reported, not gated), then gated with
    ``setMinDisparity(0)`` (the coarsest shift for this scene);
15. drives the flagship frame through ``StereoPipeline`` with
    ``interp=True`` (the WLS fill at level 0), ``occlusion_detection``
    and ``occlusion_interp``: ``wls_lines`` must launch, the gates,
    timings, peak, profile and the twins at 256x320; then with
    ``interpolate_missing=True`` alone (``gauss_rays`` must launch); then
    the SGBM frame of 8 with ``interp=True`` (``wls_fill_lr``) once;
16. runs belief propagation's kernels against their twins, bit-equal
    (``torch.equal``): ``bp_messages`` one iteration at 1x1024x1280x128
    on the data cost of 8's scene (timed by events and back to back,
    beside the twin and a ``torch.cummin`` form of the update with its
    largest difference), 5 iterations at level 2's shape (1x128x256x320)
    and 3 at 13 ragged shapes (odd H and W; D = 1, 3, 4, 5, 8, 16, 17,
    64, 256, and 446 / 447, 901 and 1300 on both sides of the cut between
    its two kernels; B = 2, H = 1, W = 1); the staged kernel at the
    ``bp_1920`` cell's shapes (480 disparities: level 1, 1x480x540x960,
    whole for 5 iterations; level 0, 1x480x1080x1920, one iteration
    against the twin in 64-row slabs with a one-row halo, timed by events
    and back to back beside its bound); ``bp_planes`` at
    1x4x1024x1280 (timed) and at 6 ragged
    shapes (K = 1, 2, 3, 4, 7, 16); then drives the BP frame and the
    CSBP frame (8's scene, raw uint8, rectified, the BP / CSBP defaults
    at 128 disparities) through ``StereoPipeline(device="cuda")``: every
    kernel of the path must launch (``remap`` and ``bp_messages``; CSBP
    also ``bp_planes`` and ``speckle_ccl``), density > 0.5 and median
    error < 0.5 px (the reference's tests/test_matchers.py gates),
    ms/frame, ``create_matcher().match`` equal to the pipeline's
    disparities, peak memory, the 5-frame profile and the matcher through
    the twins at 256x320; then ``create_matcher`` with SGBM at
    ``downsample_scale=0.5`` at 1280x1024: a (1024, 1280) result,
    density > 0.5 and median error < 1.0 px (the reference's
    test_downsample_scale gates), timed beside the full-resolution
    matcher;
17. drives the shell around the pipeline at 2448x2048 (``phase_shell``):
    the modules it runs import in a process where ``cv2`` cannot be
    imported; the live graph (``launch_stereo_camera`` with I3DRSGM and
    6 synthetic frames, driven by ``run_source``) processes every frame,
    drops none, launches the flagship kernels, and publishes disparities
    and valid masks bit-equal to ``StereoPipeline.process`` on each pair;
    the matcher node with ``rectify=True`` and a ``RectifyNode`` on raw
    uint8 frames of the distorted rig publish images bit-equal to
    ``rectify_pair`` and to ``remap`` of the float32 frame, and
    disparities bit-equal to ``process``; the node's copy stage
    (``host_copies``) on the eight outputs of a flagship and of an SGBM
    frame gives arrays bit-equal to ``.cpu()`` and allocates nothing
    after its first frame, timed by host clock and by events beside a
    plain page-locked copy of the same bytes (its bound) and beside
    ``to_numpy``; ``StreamRunner`` over 8
    flagship pairs (raw uint8, rectified) at batch 1 with depth 0 and 2
    and at batch 2 with depth 2 gives disparities bit-equal to per-pair
    ``process``, with ms/frame by host clock (each setting twice, in
    turns, split into dispatch and drain), the device idle share of a
    profiled window and peak memory reported, not gated, and the host
    syncs of one frame listed by call site (PyTorch's sync debug mode);
    ``cli live`` at 2448x2048 and ``cli info`` run in-process, exit 0
    and print their JSON;
18. drives the mapping path (``phase_mapping``) on the room and 10-pose
    trajectory of ``examples/demo_mapping_moving.py`` rendered at
    2448x2048 (fx = fy = 2142): ``tsdf_integrate`` bit-equal to its twin
    in a 512^3 volume after three integrations (one pose with half the
    grid behind the camera); ``icp_step`` (a whole track in one
    cooperative launch) against its twin for 3 steps at each pyramid level
    (the same pixels paired, A, b and sum w r^2 within 1e-4 of their
    scales; each step from the twin's state after the last, so both pair
    pixels for the same pose), a whole track in one launch against the
    twins' (1e-4 m, 5e-3 deg), bit-identical over 10 runs, and tracks of
    other levels and steps on odd sizes (a level of 0 steps leaving rmse
    and the fraction 0); a grid larger than the card holds at once raises;
    both kernels timed beside their bounds (the step and the track by
    events and back to back), ``icp_step`` also beside ``Jw^T J`` on a
    ready J.
    Then the main path, counted: ``DepthOdometry`` tracks the 10 frames
    and each is fused into 512^3 x 0.01 m with its estimated pose (one
    ``icp_step`` launch a tracked frame running its 21 steps, one
    ``tsdf_integrate``); the reference's gates
    (ATE < 0.05 m, rotation < 1 deg, map IoU against the ground-truth-pose
    fusion > 0.8 in the demo's 64^3 x 0.08 m volume); the 512^3 IoU,
    ``track`` and ``integrate`` ms, peak memory and the host syncs of one
    ``track`` call by call site and by part (only its final readout may
    sync in the port, its iterations not at all). Last,
    ``launch_processing`` with the flagship config and the map consumer
    over 4 flagship frames into 512^3 x 0.025 m: the background plane at
    10.875 m within 3 voxels; beyond it plus the truncation and a voxel,
    at most 0.1 % of the occupied voxels, each within the truncation of
    the depth the matcher measured at its own pixel (its outliers); the
    volume bit-equal to the twin fed the same depth frames, and the
    graph's ms/frame with and without the consumer.
19. drives capture (``phase_capture``): two emulated GigE Vision cameras
    in a process of their own (``python3 chip_smoke.py --cameras H W
    SCENE``, which the smoke starts and ends), device clocks 1000 s
    apart, 8 triggers of the flagship scene at 2448x2048 at 5 a second,
    SCPS 8996 at 1 GbE: ``GigEStereoSource.pairs()`` alone and ``cli
    live --gige --algorithm I3DRSGM`` with each GVSP backend (every pair
    delivered, payloads exact, each disparity and valid mask bit-equal
    to ``process``; pairs a second, ``dropped_unpaired``, resends, the
    host's reassembly CPU a frame, the matcher's ms/frame), then the same
    frames through two ``FrameRing``s and ``ShmCameraPublisher``s into
    the graph (bit-equal again);
20. drives ``cli live --serve --duration 3`` on the synthetic 2448x2048
    source (``phase_serve``): ``/params`` lists the three servers, a
    ``/set`` of P1 reaches the next frame (each frame bit-equal to
    ``process`` under the P1 it ran with, and not under the other);
21. drives the sharded matcher (``phase_dist``), the flagship config at
    2448x2048, batch 2: mesh 1x1 bit-equal to the unsharded run, mesh
    1x4 on the one card with a 64-row halo at the reference test's gate
    (99 % within 1 px more than 16 rows from the cuts; the agreement by
    bands of 8 rows too), the 2x1 pipeline step on the distorted rig at
    the accuracy gate, ms/frame by events for each and
    ``measure_scaling([1])``;
22. runs ``cli bench`` (``phase_bench``): ``bench.sgm_direct`` with its
    kernels against the plain twins at 512x640, D = 256 (valid masks
    identical, |dd| <= 1e-4), then ``python -m i3dr_stereo_tpu_torch.cli
    bench --config all`` in a process of its own at full sizes: exit
    code 0, a line for each of the eight configurations and each stage,
    every value above 0, ``vs_baseline`` null, the card's name and power
    limit in each line, and each configuration's kernels launched.

``python3 chip_smoke.py --only bp`` (any ``phase_*`` names, comma
separated: ``--only shell`` runs phase 17, ``--only mapping`` phase 18,
``--only capture,serve,dist`` phases 19-21, ``--only bench`` phase 22)
builds the kernels and runs
those phases alone: no kernels line and no result line.

Each kernel's entry also carries its bound (the least time the card could
take: bytes moved once over 3.35 TB/s, or operations over 67 TFLOP/s with
popcounts at their own rate, a sixteenth of it, whichever is larger, at
the timed shape) and, where one PyTorch call
computes the same function (``grid_sample`` for the remap), that call's
time (none for the census transform, which no single PyTorch call
computes); for the row gather it is the time of the whole function in PyTorch
calls (anchor lookup, both clamps, ``x - e``, ``torch.gather``), with the
``torch.gather`` alone on a ready index as a second figure. Every ``ms``
is CUDA events around one wrapper call. ``back_to_back_ms`` is the time a
call where calls are issued back to back (the row gather's through its C
entry, since its wrapper's host work outlasts it), and the row gather's
``library_*back_to_back_ms`` are its PyTorch calls timed the same way;
the remap's ``pair_ms`` and ``two_singles_ms`` are both cameras through
``rectify_pair`` and through two ``remap`` calls, by events.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from portbench import trace
from portbench.peaks import PEAK_BYTES_S, PEAK_OPS_S

H_FULL, W_FULL = 2048, 2448
DEVICE = "cuda"
# host syncs are counted by the line of this package that issued them
PACKAGE = Path(__file__).resolve().parent / "i3dr_stereo_tpu_torch"
# the flagship input of bench.py:_layered_pair
SCENE = dict(max_disp=200, background_disp=16, layers=6, seed=1)
TOL_DISP = 1e-4          # kernel vs twin, per pixel valid in both
TOL_PATH_DISP = 1e-3     # whole matcher, kernels vs twins
MIN_VALID_AGREE = 0.999
MAX_MEDIAN_ERR = 0.25    # the repo's accuracy gate (px)

SOURCES = {
    "census_cost": ("i3dr_stereo_tpu_torch/csrc/census_cost.cu",
                    "i3dr_stereo_tpu/ops/sgm_fused_t.py:187"),
    "sgm_sweep": ("i3dr_stereo_tpu_torch/csrc/sgm_sweep.cu",
                  "i3dr_stereo_tpu/ops/sgm_fused_t.py:187,242,318"),
    "sgm_sweep_wta": ("i3dr_stereo_tpu_torch/csrc/sgm_sweep_wta.cu",
                      "i3dr_stereo_tpu/ops/sgm_fused_t.py:423"),
    "row_gather": ("i3dr_stereo_tpu_torch/csrc/row_gather.cu",
                   "i3dr_stereo_tpu/ops/block_gather.py:109"),
    # the reference's census is an XLA fusion (jax.jit), no pallas_call
    "census_transform": ("i3dr_stereo_tpu_torch/csrc/census_transform.cu",
                         "i3dr_stereo_tpu/ops/census.py:32"),
    "remap": ("i3dr_stereo_tpu_torch/csrc/remap.cu",
              "i3dr_stereo_tpu/ops/rectify_pallas.py:279"),
    "speckle_ccl": ("i3dr_stereo_tpu_torch/csrc/speckle_ccl.cu",
                    "i3dr_stereo_tpu/ops/speckle_pallas.py:304,340"),
    "sgm_volume": ("i3dr_stereo_tpu_torch/csrc/sgm_volume.cu",
                   "i3dr_stereo_tpu/ops/sgm_pallas.py:173,229"),
    # the kernel of the main path's shape (D = 32); every other D runs
    # csrc/fused_cost_sgm.cu's
    "fused_census_fwd": ("i3dr_stereo_tpu_torch/csrc/fused_census32.cu",
                         "i3dr_stereo_tpu/ops/fused_cost_sgm.py:201"),
    "fused_bt_fwd": ("i3dr_stereo_tpu_torch/csrc/fused_bt.cu",
                     "i3dr_stereo_tpu/ops/fused_cost_sgm.py:348"),
    # the reference computes these two in XLA, no pallas_call: unrolled
    # doubling rounds and a lax.scan
    "gauss_rays": ("i3dr_stereo_tpu_torch/csrc/gauss_rays.cu",
                   "i3dr_stereo_tpu/ops/gauss_interp.py:38"),
    "wls_lines": ("i3dr_stereo_tpu_torch/csrc/wls_lines.cu",
                  "i3dr_stereo_tpu/ops/wls.py:32"),
    # BP's two message updates: XLA in the reference (lax.scan and
    # fori_loop), no pallas_call
    "bp_messages": ("i3dr_stereo_tpu_torch/csrc/bp_messages.cu",
                    "i3dr_stereo_tpu/matchers/bp.py:42,75"),
    "bp_planes": ("i3dr_stereo_tpu_torch/csrc/bp_planes.cu",
                  "i3dr_stereo_tpu/matchers/bp.py:122"),
    # the mapping path's voxel update and ICP step: XLA in the reference
    "tsdf_integrate": ("i3dr_stereo_tpu_torch/csrc/tsdf_integrate.cu",
                       "i3dr_stereo_tpu/mapping/tsdf.py:39"),
    "icp_step": ("i3dr_stereo_tpu_torch/csrc/icp_step.cu",
                 "i3dr_stereo_tpu/mapping/odometry.py:112"),
    # SGBM's BT cost and box sum: XLA in the reference, no pallas_call
    "bt_box_cost": ("i3dr_stereo_tpu_torch/csrc/bt_box_cost.cu",
                    "i3dr_stereo_tpu/ops/cost.py:102,151"),
}
# the kernels of each main path: the flagship frame, the SGBM frame
FLAGSHIP_KERNELS = ("census_transform", "census_cost", "sgm_sweep",
                    "sgm_sweep_wta", "row_gather", "remap", "speckle_ccl")
SGBM_KERNELS = ("remap", "bt_box_cost", "sgm_volume")
LEAN_FLAGSHIP_KERNELS = ("census_transform", "fused_census_fwd",
                         "sgm_volume", "speckle_ccl", "remap")
LEAN_SGBM_KERNELS = ("remap", "fused_bt_fwd", "sgm_volume")
# integer operations count at portbench/peaks.py's float32 rate; popcounts
# at 16 a clock an SM where that rate counts 128 lanes x 2, a sixteenth of
# it (4.19e12/s); phase_popc_rate measures what the card holds
PEAK_POPC_S = PEAK_OPS_S / 16

# substrings of the port's CUDA kernel names, for the profile table
KERNEL_SYMBOLS = ("census_cost_kernel", "sgm_sweep_kernel",
                  "row_gather_kernel", "remap_kernel", "ccl_local",
                  "ccl_boundary", "ccl_count", "ccl_keep",
                  "sgm_volume_kernel",
                  "census_fwd_kernel", "census32_kernel", "bt_fwd_kernel",
                  "census_fixed_kernel", "census_any_kernel",
                  "gauss_rays_kernel", "wls_lines_kernel",
                  "bp_messages_", "bp_planes_kernel", "tsdf_kernel",
                  "icp_track_kernel", "bt_box_cost_kernel")
# accuracy_bench.py:sgbm_1280's scene and size
H_SGBM, W_SGBM = 1024, 1280
SGBM_SCENE = dict(max_disp=120, background_disp=8, layers=5, seed=21)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def gpu_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median per-call device time of ``fn`` (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def back_to_back_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Device time of one call of ``fn`` where the host issues calls
    faster than the card runs them: CUDA events around ``iters`` calls
    issued back to back, over ``iters``. For kernels so short that events
    around one call time the host's launch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def row_gather_entry(src, idx, q, radius, out):
    """A call of the row gather's C entry with no wrapper around it (the
    wrapper's checks cost the host more than the kernel costs the card)."""
    from i3dr_stereo_tpu_torch import _build

    B, H, W = src.shape
    lib, stream = _build.library(), _build.stream_of(src)
    args = (src.data_ptr(), idx.data_ptr(), q.data_ptr(), out.data_ptr(), B,
            H, W, q.shape[1], q.shape[2], int(radius), stream)
    check(lib.i3dr_row_gather(*args) == 0, "i3dr_row_gather failed")
    return lambda: lib.i3dr_row_gather(*args)


def census_pair_entry(a, b, hw, outs):
    """A call of the census transform's C entry for a pair of contiguous
    (B, H, W) images into ``outs`` (2, B, H, W, NW), no wrapper around
    it; the call holds the tensors whose memory it reads and writes."""
    from i3dr_stereo_tpu_torch import _build

    check(a.is_contiguous() and b.is_contiguous() and outs.is_contiguous(),
          "census_pair_entry takes contiguous tensors")
    lib, stream = _build.library(), _build.stream_of(a)
    args = (a.data_ptr(), b.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr(), *a.shape, *hw, stream)
    check(lib.i3dr_census_transform(*args) == 0,
          "i3dr_census_transform failed")
    return lambda held=(a, b, outs): lib.i3dr_census_transform(*args)


def gpu_times(fn, iters: int) -> list:
    """Per-call device times of ``fn`` (CUDA events), no warm-up."""
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return times


def set_bound(stats, name: str, nbytes: float, nops: float,
              npopc: float = 0.0) -> None:
    """The least time the card could take for the timed call: every input
    read once and every output written once over the memory rate, or its
    operations over their rate, whichever is larger. Popcounts are counted
    at their own rate (``PEAK_POPC_S``), every other operation at the
    float32 rate."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = max(nops / PEAK_OPS_S, npopc / PEAK_POPC_S) * 1e3
    stats[name]["bound_ms"] = max(t_bytes, t_ops)
    stats[name]["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    stats[name]["bound_bytes"] = int(nbytes)
    stats[name]["bound_bytes_ms"] = t_bytes
    stats[name]["bound_ops"] = int(nops)
    stats[name]["bound_ops_ms"] = t_ops
    stats[name]["bound_popcounts"] = int(npopc)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def flagship_cfg(params):
    """``bench.py:_flagship_cfg``."""
    return params.ALGORITHM_DEFAULTS[params.Algorithm.I3DRSGM].replace(
        disparity_range=256, max_pyramid_level=4, speckle_size=100,
        speckle_downsample=2, median_filter=True)


def rodrigues(rvec) -> np.ndarray:
    """Rotation matrix of a rotation vector (what cv2.Rodrigues gives)."""
    r = np.asarray(rvec, dtype=np.float64)
    theta = np.linalg.norm(r)
    k = r / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.cos(theta) * np.eye(3) + (1 - np.cos(theta)) * np.outer(k, k)
            + np.sin(theta) * kx)


def distorted_rig(camera):
    """The distorted 2448x2048 calibration of ``bench.py``'s pipeline_batch
    row (radial/tangential distortion and a rotation per view)."""
    K = np.array([[2400.0, 0, 1224.0], [0, 2400.0, 1024.0], [0, 0, 1]])
    D = np.array([-0.18, 0.06, 0.0008, -0.0006, 0.0])
    Pl = np.array([[2380.0, 0, 1220.0, 0], [0, 2380.0, 1022.0, 0],
                   [0, 0, 1, 0]])
    Pr = Pl.copy()
    Pr[0, 3] = -2380.0 * 0.3      # Tx = -fx * B
    Rl = rodrigues([0.004, -0.006, 0.002])
    Rr = rodrigues([-0.003, 0.005, -0.002])
    return camera.StereoRig(
        left=camera.CameraModel(W_FULL, H_FULL, K, D, Rl, Pl),
        right=camera.CameraModel(W_FULL, H_FULL, K, D, Rr, Pr))


def raw_u8(img) -> np.ndarray:
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def flagship_levels(cfg, sc):
    """Every level of the flagship pyramid at its own shape (padded to
    multiples of 128, ragged W_real/H_real), built as pyramid_sgm_match
    builds it: (level, left, right, prediction or None, anchors, bpm,
    H_real, W_real) with the padded images on the card. The prediction
    that warps the right view (``row_gather`` at radius 16) is the
    downsampled ground truth, clamped to its block anchors; the coarsest
    level is unwarped and searches from the minimum disparity."""
    from i3dr_stereo_tpu_torch.matchers import pyramid as pyr
    from i3dr_stereo_tpu_torch.ops import block_gather as bg

    dev = torch.device(DEVICE)
    l = torch.tensor(sc.left, device=dev)[None]
    r = torch.tensor(sc.right, device=dev)[None]
    gt = torch.tensor(sc.disparity, device=dev)[None]
    n_levels = cfg.max_pyramid_level
    for level in range(n_levels):
        if level:
            l, r, gt = (pyr._downsample2(l), pyr._downsample2(r),
                        pyr._downsample2(gt))
        _, Hh, Wh = l.shape
        Hp, Wp = -(-Hh // 128) * 128, -(-Wh // 128) * 128
        lp, rp = bg.pad_edge(l, Hp, Wp), bg.pad_edge(r, Hp, Wp).contiguous()
        if level == n_levels - 1:
            yield (level, lp, rp, None, None,
                   int(round(cfg.min_disparity / 2 ** level)), Hh, Wh)
            continue
        pred = bg.pad_edge(torch.round(gt / 2 ** level).to(torch.int32)
                           .clamp(0, Wh - 1), Hp, Wp)
        q = bg.block_anchors(pred)
        q_up = q.repeat_interleave(8, 1).repeat_interleave(128, 2)
        pred_eff = torch.minimum(torch.maximum(pred, q_up - 16),
                                 q_up + 16).contiguous()
        yield level, lp, rp, pred_eff, q, -16, Hh, Wh


def lean_levels(cfg, sc, D=32):
    """Every level of the lean flagship pyramid at its own shape (padded
    to multiples of 8), built as matchers/pyramid.py:_match_level_lean
    builds it: (level, left census, right census, base, H_real, W_real)
    with (1, H8, W8, NW) census words on the card. The prediction that
    warps the right view is the downsampled ground truth (base -D/2);
    the coarsest level is unwarped and searches from the minimum
    disparity."""
    from i3dr_stereo_tpu_torch.matchers import pyramid as pyr
    from i3dr_stereo_tpu_torch.ops.block_gather import pad_edge
    from i3dr_stereo_tpu_torch.ops.census import census_transform

    dev = torch.device(DEVICE)
    l = torch.tensor(sc.left, device=dev)[None]
    r = torch.tensor(sc.right, device=dev)[None]
    gt = torch.tensor(sc.disparity, device=dev)[None]
    n_levels = cfg.max_pyramid_level
    for level in range(n_levels):
        if level:
            l, r, gt = (pyr._downsample2(l), pyr._downsample2(r),
                        pyr._downsample2(gt))
        _, Hh, Wh = l.shape
        H8, W8 = -(-Hh // 8) * 8, -(-Wh // 8) * 8
        if level == n_levels - 1:
            base, rw = int(round(cfg.min_disparity / 2 ** level)), r
        else:
            pred = torch.round(gt / 2 ** level).to(torch.int64).clamp(
                0, Wh - 1)
            xs = torch.arange(Wh, dtype=torch.int64, device=dev)
            base, rw = -(D // 2), r.gather(2, (xs - pred).clamp(0, Wh - 1))
        yield (level,
               census_transform(pad_edge(l, H8, W8), cfg.census_height,
                                cfg.census_width),
               census_transform(pad_edge(rw, H8, W8), cfg.census_height,
                                cfg.census_width), base, Hh, Wh)


def flagship_pipe(lean=False):
    """The product's frame: ``bench.py:_flagship_cfg`` on the ideal rig,
    raw uint8 in, bicubic rectification (the ideal rig's maps are the
    identity up to float64 rounding), speckle on. Returns (pipe, left,
    right, scene, cfg, cloud)."""
    from i3dr_stereo_tpu_torch.config import params
    from i3dr_stereo_tpu_torch.core import camera
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline

    cfg = flagship_cfg(params)
    sc = layered_scene(H_FULL, W_FULL, **SCENE)
    rig = camera.StereoRig.synthetic(W_FULL, H_FULL, fx=580.0,
                                     baseline_m=0.3)
    # fx*T = 174: a 0.5..100 m window keeps disparities 1.7..348 px, so
    # the depth clamp leaves the scene's 16..200 px whole
    cloud = params.PointCloudConfig(depth_max=100.0, depth_min=0.5)
    kw = dict(lean=True) if lean else {}
    pipe = StereoPipeline(rig, cfg, cloud, device=DEVICE, compute_depth=True,
                          compute_points=True, compute_crop=True, **kw)
    check(pipe.rectify_inputs and pipe.config.speckle_size == 100,
          "the flagship frame must rectify and speckle-filter")
    left = torch.tensor(raw_u8(sc.left), device=DEVICE)
    right = torch.tensor(raw_u8(sc.right), device=DEVICE)
    return pipe, left, right, sc, cfg, cloud


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain twins
# ---------------------------------------------------------------------------

def compare_gather(bg, src, idx, q, r, label, stats):
    """row_gather vs its twin, bit-equal."""
    out = bg.block_shift_gather(src, idx, q, r)
    ref = bg.block_shift_gather_plain(src, idx, q, r)
    torch.cuda.synchronize()
    stats["row_gather"]["err"] = max(stats["row_gather"]["err"],
                                     (out - ref).abs().max().item())
    check(torch.equal(out, ref), f"{label}: row_gather differs from its twin")
    return out


def compare_cost(sf, cl, cr, D, *, bpm, H_real, W_real, label, stats,
                 wide_values=True):
    """census_cost vs its twin, C and the unclamped plane bit-equal.
    Returns the kernel's (C, Cw)."""
    C, Cw = sf.census_cost(cl, cr, D, bpm=bpm, H_real=H_real, W_real=W_real)
    Cp, Cwp = sf.census_cost_plain(cl, cr, D, bpm=bpm, H_real=H_real,
                                   W_real=W_real)
    torch.cuda.synchronize()
    check(torch.equal(C, Cp), f"{label}: census_cost differs from its twin "
          f"({(C != Cp).sum().item()} of {C.numel()})")
    check((Cw is None) == (Cwp is None) == (cl.shape[-1] * 32 <= 254),
          f"{label}: unclamped plane present iff more than 254 bits")
    if Cw is not None:
        check(torch.equal(Cw, Cwp),
              f"{label}: census_cost's unclamped plane differs")
        check(not wide_values or bool((Cw > 254).any()),
              f"{label}: no distance above 254")
    stats["census_cost"]["err"] = max(
        stats["census_cost"]["err"],
        int((C.int() - Cp.int()).abs().max().item()))
    return C, Cw


def compare_level(sf, bg, cl, cr, *, bpm, H_real, W_real, directions, ur,
                  pens, label, stats, subpixel=True, time_it=False,
                  card=""):
    """census_cost, every sweep of the SGM chain and the sweep that ends
    in the WTA vs their twins on the same inputs, then the backmatch lookup (row_gather at radius D/2 + 1 around the
    window midpoint) on the level's own right-anchored disparities."""
    D = 32
    C, Cw = compare_cost(sf, cl, cr, D, bpm=bpm, H_real=H_real,
                         W_real=W_real, label=label, stats=stats)

    dirs = (sf.DIRECTIONS_4 if directions == 4 else sf.DIRECTIONS_8)
    down = [d for d in sf._DOWN if d in dirs]
    up = [d for d in sf._UP if d in dirs]
    pen = dict(zip(dirs, pens))
    # the chain as census_sgm_wta runs it: (direction, op)
    chain = [((0, 1), "i16_new"), ((0, -1), "i16_addf")]
    if directions == 4:
        chain += [(down[0], "i16_addi")]
    else:
        chain += [(down[0], "f32_new"), (down[1], "f32_add"),
                  (down[2], "f32_fin"), (up[0], "f32_add"),
                  (up[1], "f32_add")]
    clone = lambda t: None if t is None else t.clone()
    acc16 = acc32 = None
    plain_ms, inputs = [], []
    for d, op in chain:
        Cd = Cw if d == (0, 1) and Cw is not None else C
        i16 = acc16 if op in sf._READS_16 else None
        i32 = acc32 if op in sf._READS_32 else None
        before = (clone(i16), clone(i32))
        inputs.append((Cd, d, op, before))
        p, ms = timed(lambda: sf.sgm_sweep_plain(
            Cd, *d, *pen[d], op, clone(i16), clone(i32)))
        plain_ms.append(ms)
        k = sf.sgm_sweep(Cd, *d, *pen[d], op, i16, i32)   # in place
        torch.cuda.synchronize()
        err = (k.double() - p.double()).abs().max().item()
        stats["sgm_sweep"]["err"] = max(stats["sgm_sweep"]["err"], err)
        check(k.dtype == p.dtype and torch.equal(k, p),
              f"{label}: sgm_sweep {op} {d} differs from its twin (max "
              f"{err})")
        check(op.endswith("new") or k is (i16 if op.startswith("i16")
                                          else i32),
              f"{label}: sgm_sweep {op} did not update its sum in place")
        if op == "f32_fin":
            check(torch.equal(i16, before[0]), f"{label}: f32_fin wrote acc16")
        if op.startswith("i16"):
            acc16 = k
        else:
            acc32 = k
        del p
    acc = acc16 if directions == 4 else acc32
    last = up[-1]
    wkw = dict(subpixel=subpixel, uniqueness_ratio=ur)
    dp, wta_plain_ms = timed(lambda: sf.sgm_sweep_wta_plain(
        C, *last, *pen[last], acc, **wkw))
    snapshot = acc.clone()
    d = sf.sgm_sweep_wta(C, *last, *pen[last], acc, **wkw)
    torch.cuda.synchronize()
    v, vp = d > -1e8, dp > -1e8
    check(torch.equal(v, vp), f"{label}: sgm_sweep_wta valid masks differ "
          f"({(v != vp).sum().item()} px)")
    err = (d - dp)[v].abs().max().item() if v.any() else 0.0
    check(err <= TOL_DISP, f"{label}: sgm_sweep_wta |dd| {err} > {TOL_DISP}")
    check(torch.equal(acc, snapshot), f"{label}: sgm_sweep_wta wrote its sum")
    del snapshot
    stats["sgm_sweep_wta"]["err"] = max(stats["sgm_sweep_wta"]["err"], err)

    # backmatch lookup as matchers/pyramid.py:_backmatch_check_true makes it
    B, Hp, Wp, _ = C.shape
    r_res = torch.where(v, d + float(bpm), 0.0)
    d_r, v_r = sf.right_disparity_from_C(C, bpm, W_real)
    q = torch.full((B, -(-Hp // 8), -(-Wp // 128)), bpm + D // 2,
                   dtype=torch.int32, device=C.device)
    compare_gather(bg, torch.where(v_r, d_r, 1.0e9).contiguous(),
                   torch.round(r_res).to(torch.int32).contiguous(), q,
                   D // 2 + 1, f"{label} backmatch", stats)
    print(f"{label}: census_cost, {len(chain)} sgm_sweep directions "
          f"({str(acc.dtype)[6:]} sum, max {int(acc.max().item())}), "
          f"sgm_sweep_wta and the "
          f"radius-{D // 2 + 1} backmatch gather match their twins (valid "
          f"{v.float().mean().item():.4f}, max |dd| {err})", flush=True)

    if time_it:
        kw = dict(bpm=bpm, H_real=H_real, W_real=W_real)
        stats["census_cost"]["ms"] = gpu_ms(
            lambda: sf.census_cost(cl, cr, D, **kw))
        stats["census_cost"]["plain_ms"] = gpu_ms(
            lambda: sf.census_cost_plain(cl, cr, D, **kw), iters=1, warmup=0)
        n = C.numel()                       # (pixel, disparity) pairs
        NW = cl.shape[-1]
        # both census planes in, C (and the int16 plane) out; per pair a
        # xor and an add a word, and the popcounts at their own rate: one a
        # word, or two for three words (a carry-save adder, as the kernel
        # does at NW = 3)
        npopc = n * (2 if NW == 3 else NW)
        set_bound(stats, "census_cost",
                  2 * cl.numel() * 4 + n * (1 if Cw is None else 3),
                  n * (NW + 3), npopc=npopc)
        st = stats["census_cost"]
        print(f"census_cost at level 0 [{card}]: {st['ms']:.4f} ms (plain "
              f"twin {st['plain_ms']:.1f} ms); bound {st['bound_ms']:.4f} ms "
              f"by {st['bound_by']} ({st['bound_ms'] / st['ms']:.0%} of it "
              f"reached): {st['bound_bytes_ms']:.4f} ms for its "
              f"{st['bound_bytes'] / 1e9:.3f} GB, "
              f"{npopc / PEAK_POPC_S * 1e3:.4f} ms for its "
              f"{npopc / 1e6:.0f} M popcounts at "
              f"{PEAK_POPC_S / 1e12:.2f} T/s ({n * NW / 1e6:.0f} M and "
              f"{n * NW / PEAK_POPC_S * 1e3:.4f} ms at one a word)",
              flush=True)
        time_sweeps(sf, C, acc, inputs, pen, last, wkw, plain_ms,
                    wta_plain_ms, stats, card)


def time_sweeps(sf, C, acc, inputs, pen, last, wkw, plain_ms, wta_plain_ms,
                stats, card):
    """Level 0's 4-path chain: every sweep, the up-sweep with and without
    the WTA, and the stage. The in-place sweeps are timed on scratch
    copies of their sums (the values run away over the repeats; the time
    does not depend on them)."""
    n = C.numel()
    k = len(inputs)
    row = []
    for Cd, d, op, (b16, b32) in inputs:
        s16 = None if b16 is None else b16.clone()
        s32 = None if b32 is None else b32.clone()
        row.append(gpu_ms(lambda: sf.sgm_sweep(Cd, *d, *pen[d], op, s16,
                                               s32)))
    scratch = acc.clone()
    # the same up direction as a sweep that stores its sum, no WTA
    row.append(gpu_ms(lambda: sf.sgm_sweep(C, *last, *pen[last], "i16_addi",
                                           scratch)))
    row.append(gpu_ms(lambda: sf.sgm_sweep_wta(C, *last, *pen[last], acc,
                                               **wkw)))
    print(f"sgm_sweep [{card}] ms: " + ", ".join(
        f"{op} {d}: {t:.4f}" for (_, d, op, _), t in zip(inputs, row))
        + f"; up {last} storing its sum {row[k]:.4f}, with the WTA "
        f"{row[k + 1]:.4f} (x{row[k + 1] / row[k]:.2f})", flush=True)
    stats["sgm_sweep"]["ms"] = sum(row[:k]) / k
    stats["sgm_sweep"]["plain_ms"] = sum(plain_ms) / k
    stats["sgm_sweep_wta"]["ms"] = row[k + 1]
    stats["sgm_sweep_wta"]["plain_ms"] = wta_plain_ms
    # per sweep: C in (1 byte a pair), the int16 sum out and, but for the
    # first, in; ~10 operations a pair. The entry is the chain's mean
    per_sweep = [n * (1 + 2 + 2 * (op in sf._READS_16))
                 for _, _, op, _ in inputs]
    nbytes = sum(per_sweep)
    set_bound(stats, "sgm_sweep", nbytes / k, 10 * n)
    print("sgm_sweep bounds: " + ", ".join(
        f"{op} {b / 1e9:.3f} GB {b / PEAK_BYTES_S * 1e3:.4f} ms "
        f"({b / PEAK_BYTES_S * 1e3 / t:.0%} of it reached)"
        for (_, _, op, _), b, t in zip(inputs, per_sweep, row)), flush=True)
    # C and the int16 sum in, one float32 disparity a pixel out; the
    # recurrence, one add and ~6 operations of WTA a pair
    wta_bytes = n * 3 + 4 * n // 32
    set_bound(stats, "sgm_sweep_wta", wta_bytes, 17 * n)
    stage = sum(row[:k]) + row[k + 1]
    stage_bytes = nbytes + wta_bytes
    print(f"SGM stage at level 0 [{card}]: {k} sweeps + the sweep with the "
          f"WTA {stage:.4f} ms for {stage_bytes / 1e9:.3f} GB moved once "
          f"({stage_bytes / PEAK_BYTES_S * 1e3:.4f} ms at the HBM peak, "
          f"{stage_bytes / stage / 1e6:.1f} GB/s reached); twins "
          f"{sum(plain_ms) + wta_plain_ms:.1f} ms", flush=True)


def phase_popc_rate(card):
    """The card's popcount rate by ``csrc/popc_probe.cu`` (8 independent
    chains of add, popcount, add a thread, 16 blocks of 256 threads an SM),
    beside the rate the bounds of the two census kernels assume."""
    from i3dr_stereo_tpu_torch import _build

    lib = _build.library()
    blocks = 16 * torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    out = torch.empty(blocks * 256, dtype=torch.int32, device=DEVICE)

    def probe():
        err = lib.i3dr_popc_probe(out.data_ptr(), blocks, iters,
                                  torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"popc_probe: CUDA error {err}")

    ms = gpu_ms(probe)
    rate = blocks * 256 * iters * 8 / ms * 1e3
    print(f"popcount rate [{card}]: {rate / 1e12:.3f} T/s measured "
          f"({ms:.3f} ms), {PEAK_POPC_S / 1e12:.3f} T/s assumed by the bounds "
          f"(16 a clock an SM at the clock behind {PEAK_OPS_S / 1e12:.0f} "
          f"TFLOP/s)", flush=True)
    check(rate < 1.1 * PEAK_POPC_S, "the card counts bits faster than the "
          "bounds assume")


def phase_kernels(stats, card):
    from i3dr_stereo_tpu_torch.config import params
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.ops import block_gather as bg
    from i3dr_stereo_tpu_torch.ops import sgm_fused_t as sf
    from i3dr_stereo_tpu_torch.ops.census import census_transform

    dev = torch.device(DEVICE)
    cfg = flagship_cfg(params)

    # E: random indices and anchors that hit both clamps, bit-equal; the
    # radius 0, one whose window is wider than the staged one (200: the
    # read-only path), W = 131 (no multiple of 4 or 128: the pixel-by-pixel
    # tail), H = 8 (one anchor row), and rows that start off 16-byte
    # alignment (views one element into a buffer)
    rng = np.random.default_rng(0)
    for B, H, W, r, shifted in (
            (2, 64, 300, 17, False), (2, 64, 300, 0, False),
            (2, 64, 300, 200, False), (2, 16, 131, 17, False),
            (1, 8, 256, 63, False), (1, 8, 131, 200, False),
            (2, 16, 512, 16, True)):
        src = torch.tensor(rng.uniform(0, 255, (B, H, W)),
                           dtype=torch.float32, device=dev)
        idx = torch.tensor(rng.integers(-60, W + 60, (B, H, W)),
                           dtype=torch.int32, device=dev)
        q = torch.tensor(rng.integers(-20, W + 20,
                                      (B, -(-H // 8), -(-W // 128))),
                         dtype=torch.int32, device=dev)
        if shifted:
            src, idx = (torch.cat([t.new_zeros(1), t.flatten()])[1:]
                        .view(B, H, W) for t in (src, idx))
        compare_gather(bg, src, idx, q, r, f"random idx/q {B}x{H}x{W} r={r}"
                       + (" unaligned" if shifted else ""), stats)
    print("row_gather (random idx/q, both clamps; radius 0, 17, 63, 200; W "
          "131, 256, 300, 512; H 8, 16, 64; unaligned rows): bit-equal",
          flush=True)

    pens = [(cfg.p1, cfg.p2)] * 4
    sc = layered_scene(H_FULL, W_FULL, **SCENE)
    for level, lp, rp, pred_eff, q, bpm, Hh, Wh in flagship_levels(cfg, sc):
        Hp, Wp = lp.shape[-2:]
        rw = rp
        if pred_eff is not None:
            rw = compare_gather(bg, rp, pred_eff, q, 16,
                                f"level {level} warp", stats)
        if level == 0:
            # ms on every kernel's yardstick: CUDA events around one
            # wrapper call. A call of a kernel this short is outlasted by
            # its wrapper's host work, so its device time is also read
            # through its C entry, 50 calls back to back, under a key of
            # its own, beside torch.gather's timed the same way
            stats["row_gather"]["ms"] = gpu_ms(
                lambda: bg.block_shift_gather(rp, pred_eff, q, 16))
            out = torch.empty_like(rp)
            entry = row_gather_entry(rp, pred_eff, q, 16, out)
            check(torch.equal(out, rw), "row_gather's C entry differs")
            stats["row_gather"]["back_to_back_ms"] = back_to_back_ms(entry)
            stats["row_gather"]["plain_ms"] = gpu_ms(
                lambda: bg.block_shift_gather_plain(rp, pred_eff, q, 16),
                iters=1, warmup=0)
            # source, index and anchors in, the gathered image out
            set_bound(stats, "row_gather",
                      12 * rp.numel() + 4 * q.numel(), 6 * rp.numel())
            # the same function in PyTorch calls: anchor lookup, both
            # clamps, x - e, gather; and the gather alone on a ready index
            xs = torch.arange(Wp, dtype=torch.int32, device=dev)

            def gather_whole():
                qq = q.repeat_interleave(8, 1).repeat_interleave(128, 2)
                e = torch.minimum(torch.maximum(pred_eff, qq - 16), qq + 16)
                return torch.gather(rp, 2, (xs - e).clamp(0, Wp - 1).long())

            col = (xs - pred_eff).clamp(0, Wp - 1).long()
            gather_ready = lambda: torch.gather(rp, 2, col)
            check(torch.equal(gather_whole(), rw)
                  and torch.equal(gather_ready(), rw),
                  "torch.gather differs from row_gather")
            st = stats["row_gather"]
            st["library_ms"] = gpu_ms(gather_whole)
            st["library_ready_index_ms"] = gpu_ms(gather_ready)
            st["library_back_to_back_ms"] = back_to_back_ms(gather_whole)
            st["library_ready_index_back_to_back_ms"] = back_to_back_ms(
                gather_ready)
            # the card's streaming rate at the same bytes: an elementwise
            # PyTorch kernel that reads the source and the index and
            # writes one float a pixel
            stream_ms = back_to_back_ms(lambda: torch.add(rp, pred_eff))
            print(f"row_gather at level 0 [{card}]: by events around one "
                  f"call {st['ms']:.4f} ms (bound {st['bound_ms']:.4f} ms, "
                  f"{st['bound_ms'] / st['ms']:.0%} of it reached), the "
                  f"function in PyTorch calls {st['library_ms']:.4f} ms, "
                  f"torch.gather on a ready index "
                  f"{st['library_ready_index_ms']:.4f} ms; 50 calls back to "
                  f"back, a call: the kernel's C entry "
                  f"{st['back_to_back_ms']:.4f} ms "
                  f"({st['bound_ms'] / st['back_to_back_ms']:.0%} of the "
                  f"bound), the function in PyTorch calls "
                  f"{st['library_back_to_back_ms']:.4f} ms, torch.gather on "
                  f"a ready index "
                  f"{st['library_ready_index_back_to_back_ms']:.4f} ms, "
                  f"torch.add (source + index, the same bytes) "
                  f"{stream_ms:.4f} ms", flush=True)
            # kernel against kernel: device time on both sides
            check(st["back_to_back_ms"]
                  < st["library_ready_index_back_to_back_ms"],
                  "row_gather's kernel is slower than torch.gather on a "
                  "ready index (both 50 calls back to back)")
        compare_level(
            sf, bg, census_transform(lp, cfg.census_height, cfg.census_width),
            census_transform(rw, cfg.census_height, cfg.census_width),
            bpm=bpm, H_real=Hh, W_real=Wh, directions=4,
            ur=cfg.uniqueness_ratio, pens=pens,
            label=f"level {level} {Wh}x{Hh} in {Wp}x{Hp} D=32 bpm={bpm}",
            stats=stats, subpixel=(level == 0 and cfg.subpixel),
            time_it=(level == 0), card=card)

    # small ragged shapes, both signs of bpm, 4 and 8 paths, uniqueness
    # on, and a 17x17 census against the negated image (distances up to
    # 288: the unclamped forward plane)
    for bpm, dirs, ur, win in ((5, 4, 0.0, 9), (-7, 8, 10.0, 9),
                               (0, 8, 0.0, 9), (0, 4, 0.0, 17)):
        a = torch.tensor(rng.uniform(0, 255, (2, 48, 136)),
                         dtype=torch.float32, device=dev)
        b = (-a if win == 17 else torch.roll(a, -3, 2) + torch.tensor(
            rng.normal(0, 4, a.shape), dtype=torch.float32, device=dev))
        pens = [(float(rng.uniform(0.05, 2)), float(rng.uniform(2, 9)))
                for _ in range(dirs)]
        compare_level(sf, bg, census_transform(a, win, win),
                      census_transform(b, win, win), bpm=bpm, H_real=45,
                      W_real=131, directions=dirs, ur=ur, pens=pens,
                      label=f"ragged 45x131 in 48x136 bpm={bpm} "
                            f"paths={dirs} ur={ur} census {win}x{win}",
                      stats=stats)

    # census_cost alone where its strips and runs are ragged: NW = 1, 3, 9
    # (5x5, 9x9, 17x17 with the unclamped plane), D = 8 (byte stores), 32,
    # 48 (three runs a pixel), bpm on both sides and beyond a strip's
    # width on both sides, B = 2, W_real < W, H_real < H; then a row of
    # the frame's width that is no multiple of the strip
    a = torch.tensor(rng.uniform(0, 255, (2, 48, 136)), dtype=torch.float32,
                     device=dev)
    b = torch.roll(a, -3, 2) + torch.tensor(rng.normal(0, 4, a.shape),
                                            dtype=torch.float32, device=dev)
    n_cases = 0
    for win in (5, 9, 17):
        cl = census_transform(a, win, win)
        cr = census_transform(-a if win == 17 else b, win, win)
        for D in (8, 32, 48):
            for bpm in (5, -16, 300, -300):
                compare_cost(sf, cl, cr, D, bpm=bpm, H_real=45, W_real=131,
                             label=f"census_cost ragged 2x45x131 in 48x136 "
                                   f"census {win}x{win} D={D} bpm={bpm}",
                             stats=stats, wide_values=abs(bpm) < 131)
                n_cases += 1
    wide = torch.tensor(rng.uniform(0, 255, (1, 16, W_FULL)),
                        dtype=torch.float32, device=dev)
    cw = census_transform(wide, 9, 9)
    for bpm in (5, -16):
        compare_cost(sf, cw, census_transform(torch.roll(wide, -2, 2), 9, 9),
                     32, bpm=bpm, H_real=13, W_real=W_FULL - 9,
                     label=f"census_cost 1x13x{W_FULL - 9} in 16x{W_FULL} "
                           f"bpm={bpm}", stats=stats)
        n_cases += 1
    print(f"census_cost at {n_cases} ragged shapes (NW 1, 3, 9; D 8, 32, 48; "
          f"bpm 5, -16, 300, -300; B = 2; W_real < W, H_real < H; W = "
          f"{W_FULL}): C and the unclamped plane bit-equal to the twin",
          flush=True)

    phase_census(stats, card, sc, cfg)
    phase_remap(stats, card)
    phase_speckle(stats, sc, cfg)


def phase_census(stats, card, sc=None, cfg=None):
    """census_transform vs its twin, bit-equal (``torch.equal``): level 0's
    two images (the left image and the warped right one, 9x9) in one
    launch, timed; then the windows 3x3, 9x9, 17x17, 5x7 and 61x61 (wider
    than its 9x50 image on both axes), B = 2, an image smaller than the
    window, 2-4 grey levels (ties), odd widths (2449) and a word with bit
    31 set, as a pair and as one image; the 9x9 instance also at widths
    that are no multiple of its 32-column tile and at 1-row and 1-column
    images. Level 0 is timed back to back through the C entry and through
    the wrapper. ``sc`` and ``cfg`` default to the flagship scene and
    config."""
    from i3dr_stereo_tpu_torch.config import params
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.ops import block_gather as bg
    from i3dr_stereo_tpu_torch.ops.census import (census_transform,
                                                  census_transform_pair)

    cfg = cfg or flagship_cfg(params)
    sc = sc or layered_scene(H_FULL, W_FULL, **SCENE)
    dev = torch.device(DEVICE)
    st = stats["census_transform"]
    _, lp, rp, pred, q, _, _, _ = next(flagship_levels(cfg, sc))
    rw = bg.block_shift_gather(rp, pred, q, 16)
    hw = (cfg.census_height, cfg.census_width)
    cl, cr = census_transform_pair(lp, rw, *hw)
    pl, pr = census_transform_pair(lp, rw, *hw, plain=True)
    check(torch.equal(cl, pl) and torch.equal(cr, pr),
          "census_transform at level 0 differs from its twin")
    check(bool((cl < 0).any()), "no census word at level 0 has bit 31 set")
    st["ms"] = gpu_ms(lambda: census_transform_pair(lp, rw, *hw))
    st["plain_ms"] = gpu_ms(
        lambda: census_transform_pair(lp, rw, *hw, plain=True), iters=1,
        warmup=0)
    n_pix, n_nb = 2 * lp.numel(), hw[0] * hw[1] - 1
    # two float32 images in, their words out; a compare and a bit insert
    # a neighbour
    set_bound(stats, "census_transform", n_pix * (4 + 4 * cl.shape[-1]),
              n_pix * n_nb * 2)
    st["back_to_back_ms"] = back_to_back_ms(
        lambda: census_transform_pair(lp, rw, *hw), iters=20)
    # back to back through the C entry too: the wrapper's host work and
    # its 126 MB allocation a call are no part of the kernel
    outs = torch.empty((2,) + cl.shape, dtype=torch.int32, device=dev)
    st["entry_back_to_back_ms"] = back_to_back_ms(
        census_pair_entry(lp.contiguous(), rw.contiguous(), hw, outs),
        iters=20)
    check(torch.equal(outs[0], cl) and torch.equal(outs[1], cr),
          "census_transform's C entry differs from the wrapper")
    del outs
    print(f"census_transform level 0 ({lp.shape[-1]}x{lp.shape[-2]}, both "
          f"images, 9x9) [{card}]: bit-equal, {st['ms']:.4f} ms by events "
          f"around one call, {st['back_to_back_ms']:.4f} ms a call back to "
          f"back through the wrapper ({st['entry_back_to_back_ms']:.4f} "
          f"through its C entry) (bound {st['bound_ms']:.4f} ms by "
          f"{st['bound_by']}: "
          f"{st['bound_ms'] / st['ms']:.0%} of it by events, "
          f"{st['bound_ms'] / st['back_to_back_ms']:.0%} back to back, "
          f"{st['bound_ms'] / st['entry_back_to_back_ms']:.0%} through the "
          f"C entry; plain {st['plain_ms']:.1f} ms; no PyTorch call "
          f"computes it)", flush=True)
    del cl, cr, pl, pr, lp, rp, rw

    rng = np.random.default_rng(11)
    n_cases = 0
    for (B, H, W), (h, w), levels in (
            ((1, 37, 70), (3, 3), None), ((2, 19, 33), (9, 9), None),
            ((2, 40, 131), (17, 17), None), ((1, 12, 21), (5, 7), 3),
            ((1, 5, 6), (9, 9), None), ((2, 17, 40), (9, 9), 4),
            ((1, 3, 4), (17, 17), 2), ((2, 16, 2449), (9, 9), None),
            ((1, 24, 2449), (5, 7), None), ((1, 9, 50), (61, 61), 3),
            ((2, 45, 100), (9, 9), None), ((2, 37, 131), (9, 9), 3),
            ((2, 1, 200), (9, 9), None), ((1, 1, 37), (9, 9), None),
            ((2, 70, 1), (9, 9), None), ((1, 33, 1), (9, 9), 2),
            ((2, 40, 2560), (9, 9), None)):
        def image():
            x = (rng.integers(0, levels, (B, H, W)) if levels
                 else rng.uniform(0, 255, (B, H, W)))
            return torch.tensor(x, dtype=torch.float32, device=dev)
        a, b = image(), image()
        label = f"census_transform {B}x{H}x{W} {h}x{w} levels={levels}"
        ka, kb = census_transform_pair(a, b, h, w)
        one = census_transform(a[0], h, w)
        ra, rb = (census_transform(x, h, w, plain=True) for x in (a, b))
        torch.cuda.synchronize()
        check(torch.equal(ka, ra) and torch.equal(kb, rb),
              f"{label}: the pair differs from the twin")
        check(torch.equal(one, ra[0]), f"{label}: one (H, W) image differs "
              f"from the twin")
        n_cases += 1
    print(f"census_transform at {n_cases} shapes (windows 3x3, 9x9, 17x17, "
          f"5x7, 61x61; B = 2; 5x6 and 3x4 under the window; 2-4 grey "
          f"levels; W = 2449; 9x9 at W = 100, 131, 2560, 1-row images of "
          f"200 and 37 columns, 1-column images of 70 and 33 rows): "
          f"bit-equal as a pair and as one image",
          flush=True)


def phase_remap(stats, card):
    """remap vs its twin at the full frame on the distorted rig, one camera
    and both in one launch (``rectify_pair``), bit-equal; the single call and the
    pair timed beside two single calls and ``grid_sample``."""
    from i3dr_stereo_tpu_torch.core import camera
    from i3dr_stereo_tpu_torch.ops import rectify

    rng = np.random.default_rng(5)
    rig = distorted_rig(camera)
    st = stats["remap"]
    for interp in ("cubic", "linear"):
        ml, mr = (rectify.make_rectify_map(cam, interpolation=interp,
                                           device=DEVICE)
                  for cam in (rig.left, rig.right))
        for B in (1, 2):
            shape = (H_FULL, W_FULL) if B == 1 else (B, H_FULL, W_FULL)
            u8l, u8r = (torch.tensor(rng.integers(0, 256, shape,
                                                  dtype=np.uint8),
                                     device=DEVICE) for _ in range(2))
            for sl, sr in ((u8l, u8r), (u8l.float(), u8r.float())):
                label = f"remap {interp} {str(sl.dtype)[6:]} B={B}"
                refl = rectify.remap_plain(sl, ml)
                refr = rectify.remap_plain(sr, mr)
                outl = rectify.remap(sl, ml)
                outr = rectify.remap(sr, mr)
                pl, pr = rectify.rectify_pair(sl, sr, ml, mr)
                torch.cuda.synchronize()
                err = max((o - r).abs().max().item()
                          for o, r in ((outl, refl), (outr, refr),
                                       (pl, refl), (pr, refr)))
                st["err"] = max(st["err"], err)
                check(torch.equal(outl, refl) and torch.equal(outr, refr),
                      f"{label}: a single camera differs from its twin "
                      f"(max {err})")
                check(torch.equal(pl, refl) and torch.equal(pr, refr),
                      f"{label}: the pair differs from its twin (max {err})")
                if (interp, B, sl.dtype) != ("cubic", 1, torch.uint8):
                    print(f"{label} {W_FULL}x{H_FULL}: both cameras, alone "
                          f"and as a pair, bit-equal", flush=True)
                    continue
                src, m = sl, ml
                st["ms"] = gpu_ms(lambda: rectify.remap(src, m))
                st["back_to_back_ms"] = back_to_back_ms(
                    lambda: rectify.remap(src, m))
                st["pair_ms"] = gpu_ms(
                    lambda: rectify.rectify_pair(sl, sr, ml, mr))
                st["two_singles_ms"] = gpu_ms(
                    lambda: (rectify.remap(sl, ml), rectify.remap(sr, mr)))
                st["plain_ms"] = gpu_ms(lambda: rectify.remap_plain(src, m),
                                        iters=1, warmup=0)
                # the uint8 source, the map (index, 4 + 4 weights) in,
                # float32 out; 16 taps of multiply-add per pixel
                set_bound(stats, "remap", src.numel()
                          + m.flat_idx.numel() * (4 + 4 * 2 * m.taps + 4),
                          m.flat_idx.numel() * 2 * (m.taps ** 2 + m.taps))
                # the one PyTorch call: bicubic grid_sample (Keys
                # a = -0.75, border padding) on a float32 image
                mx, my = rectify.inverse_rectify_map_xy(rig.left)
                grid = torch.tensor(np.stack(
                    [(mx + 0.5) * 2 / W_FULL - 1,
                     (my + 0.5) * 2 / H_FULL - 1], -1)[None],
                    dtype=torch.float32, device=DEVICE)
                srcf = src.float()[None, None]
                lib = torch.nn.functional.grid_sample(
                    srcf, grid, mode="bicubic", padding_mode="border",
                    align_corners=False)[0, 0]
                lib_err = (lib - outl).abs().max().item()
                st["library_ms"] = gpu_ms(
                    lambda: torch.nn.functional.grid_sample(
                        srcf, grid, mode="bicubic",
                        padding_mode="border", align_corners=False))
                print(f"{label} {W_FULL}x{H_FULL} [{card}]: bit-equal; one "
                      f"camera {st['ms']:.4f} ms by events around one call "
                      f"({st['back_to_back_ms']:.4f} ms a call back to "
                      f"back; bound {st['bound_ms']:.4f} ms), both cameras "
                      f"as a pair {st['pair_ms']:.4f} ms against two single "
                      f"calls {st['two_singles_ms']:.4f} ms (plain "
                      f"{st['plain_ms']:.3f} ms; grid_sample "
                      f"{st['library_ms']:.4f} ms, max |remap - grid_sample| "
                      f"{lib_err:.4f} grey levels)", flush=True)


def compare_speckle(sp, d, v, S, md, label, stats, time_it=False,
                    removed_expected=None):
    """speckle_ccl vs its twin on (B, H, W) disparities, identical (and,
    where given, the number of valid pixels it must remove)."""
    keep = sp.speckle_keep(d, v, S, md)
    ref = sp.speckle_keep_plain(d, v, S, md)
    torch.cuda.synchronize()
    n_diff = int((keep != ref).sum().item())
    stats["speckle_ccl"]["err"] = max(stats["speckle_ccl"]["err"],
                                      float(n_diff > 0))
    check(n_diff == 0, f"{label}: speckle keep-mask differs from its twin "
          f"on {n_diff} px")
    removed = int((v & ~keep).sum().item())
    check(removed_expected is None or removed == removed_expected,
          f"{label}: {removed} px removed, not {removed_expected}")
    msg = (f"{label}: keep-mask identical ({removed} of "
           f"{int(v.sum().item())} valid px removed)")
    if time_it:
        ms = gpu_ms(lambda: sp.speckle_keep(d, v, S, md))
        plain = gpu_ms(lambda: sp.speckle_keep_plain(d, v, S, md), iters=1,
                       warmup=0)
        msg += f", {ms:.4f} ms (plain {plain:.2f} ms)"
    print(msg, flush=True)
    return time_it and (ms, plain)


def speckle_inputs(sc, cfg):
    """The speckle filter's input on the flagship frame: level 0's
    disparities and valid mask, captured from one kernel run of the
    matcher, with (max_size, max_diff), and after the downsample-2
    front-end (block minima, valid, max_size / 4, max_diff * 2)."""
    from i3dr_stereo_tpu_torch.matchers import pyramid as pyr
    from i3dr_stereo_tpu_torch.ops import speckle as sp

    captured = []

    def capture(disp, valid, **kw):
        captured.append((disp, valid, kw))
        return sp.speckle_filter(disp, valid, **kw)

    l = torch.tensor(sc.left, device=DEVICE)
    r = torch.tensor(sc.right, device=DEVICE)
    pyr.speckle_filter = capture
    try:
        pyr.pyramid_sgm_match(l, r, cfg)
    finally:
        pyr.speckle_filter = sp.speckle_filter
    check(len(captured) == 1, f"speckle ran {len(captured)} times, not once")
    d, v, kw = captured[0]
    check(kw["downsample"] == 2 and kw["max_size"] == 100,
          f"unexpected speckle arguments {kw}")
    S, md = kw["max_size"], kw["max_diff"]
    dd, vv = sp.block_min(d, v, 2)
    S2, md2 = max(S // 4, 1), float(np.float32(md) * np.float32(2))
    check(tuple(dd.shape) == (1, H_FULL // 2, W_FULL // 2), f"{dd.shape}")
    return d, v, (S, md), (dd, vv, S2, md2)


def phase_speckle(stats, sc, cfg):
    """The keep-mask kernel vs its twin on the main path's inputs (level
    0's disparities of the flagship scene, captured from one kernel run
    of the matcher) and on fields made to stress it."""
    from i3dr_stereo_tpu_torch.ops import speckle as sp

    d, v, (S, md), (dd, vv, S2, md2) = speckle_inputs(sc, cfg)
    ms, plain = compare_speckle(
        sp, dd, vv, S2, md2, f"speckle flagship ds2 {W_FULL // 2}x"
        f"{H_FULL // 2} S={S2} max_diff={md2}", stats, time_it=True)
    stats["speckle_ccl"]["ms"], stats["speckle_ccl"]["plain_ms"] = ms, plain
    # disparity and valid in, the keep-mask out (labels and sizes are
    # scratch); a few compares per pixel and neighbour
    set_bound(stats, "speckle_ccl", 6 * dd.numel(), 10 * dd.numel())
    compare_speckle(sp, d.contiguous(), v.contiguous(), S, md,
                    f"speckle full {W_FULL}x{H_FULL} S={S} max_diff={md}",
                    stats, time_it=True)

    # a smooth slanted frame: one component, the longest union-find chains
    yy, xx = torch.meshgrid(torch.arange(H_FULL, device=DEVICE),
                            torch.arange(W_FULL, device=DEVICE),
                            indexing="ij")
    smooth = (0.05 * xx + 0.03 * yy).float()[None]
    ones = torch.ones_like(smooth, dtype=torch.bool)
    compare_speckle(sp, smooth, ones, 100, 0.5,
                    f"speckle smooth one-component {W_FULL}x{H_FULL}", stats,
                    time_it=True)

    # what stresses the count per tile root, at ds2's shape: a serpentine
    # through every tile (tile-root chains as deep as the frame), the
    # one-component frame, components of exactly S pixels (dropped) and of
    # S + 1 (kept) across tile corners, an all-invalid frame
    H2, W2 = H_FULL // 2, W_FULL // 2
    flat = torch.zeros((1, H2, W2), device=DEVICE)
    snake = torch.zeros((1, H2, W2), dtype=torch.bool, device=DEVICE)
    snake[0, ::2] = True
    snake[0, 1::4, W2 - 1] = True
    snake[0, 3::4, 0] = True
    n_snake = int(snake.sum().item())
    compare_speckle(sp, flat, snake, S2, md2, f"speckle serpentine "
                    f"{W2}x{H2} ({n_snake} px, one component)", stats,
                    time_it=True, removed_expected=0)
    # a short serpentine across tile edges at S = its size (dropped) and
    # one less (kept); the twin's rounds grow with S, so it stays short
    short = torch.zeros_like(snake)
    short[0, 14:19:2, 16:80] = True
    short[0, 15, 79] = short[0, 17, 16] = True
    n_short = int(short.sum().item())
    for S_s, removed in ((n_short, n_short), (n_short - 1, 0)):
        compare_speckle(sp, flat, short, S_s, md2, f"speckle {n_short}-px "
                        f"serpentine across tile edges, S = {S_s}", stats,
                        removed_expected=removed)
    compare_speckle(sp, flat, torch.ones_like(snake), S2, md2,
                    f"speckle one-component {W2}x{H2}", stats,
                    removed_expected=0)
    blobs = torch.full((1, H2, W2), -1.0, device=DEVICE)
    n_exact = 0
    for i, y in enumerate(range(30, H2 - 8, 64)):
        for j, x in enumerate(range(30, W2 - 8, 64)):
            value = float(4 * (i + j))      # neighbours never join
            blobs[0, y:y + 5, x:x + 5] = value      # 25 = S2 px
            if (i + j) % 2:
                blobs[0, y + 5, x] = value          # 26 px
            else:
                n_exact += 1
    check(S2 == 25, f"S2 = {S2}")
    compare_speckle(sp, blobs, blobs >= 0, S2, md2, f"speckle squares of "
                    f"{S2} and {S2 + 1} px across tile corners", stats,
                    removed_expected=n_exact * S2)
    compare_speckle(sp, flat, torch.zeros_like(snake), S2, md2,
                    f"speckle all-invalid {W2}x{H2}", stats,
                    removed_expected=0)

    rng = np.random.default_rng(11)
    for S in (12, 100, 200):
        d = torch.tensor(rng.integers(0, 4, (1, 512, 640)) * 1.0,
                         dtype=torch.float32, device=DEVICE)
        v = torch.tensor(rng.random((1, 512, 640)) < 0.8, device=DEVICE)
        compare_speckle(sp, d, v, S, 1.0, f"speckle blobs 640x512 S={S}",
                        stats)
    d = torch.tensor(rng.integers(0, 3, (3, 45, 131)) * 2.0,
                     dtype=torch.float32, device=DEVICE)
    v = torch.tensor(rng.random((3, 45, 131)) < 0.85, device=DEVICE)
    compare_speckle(sp, d, v, 9, 1.0, "speckle batched ragged 3x131x45",
                    stats)


# ---------------------------------------------------------------------------
# phase 4 + 5: the main path at full width
# ---------------------------------------------------------------------------

def phase_main_path(stats, card):
    from i3dr_stereo_tpu_torch.core import camera
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.matchers.pyramid import pyramid_sgm_match
    from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline

    pipe, left, right, sc, cfg, cloud = flagship_pipe()
    rig = pipe.rig

    res = drive_frame(pipe, left, right, sc, FLAGSHIP_KERNELS, "main path",
                      stats, record=FLAGSHIP_KERNELS)
    check(tuple(res.points["xyz"].shape) == (H_FULL * W_FULL, 3),
          "point cloud shape")

    # the distorted calibration: a real remap, finite outputs
    pipe_d = StereoPipeline(distorted_rig(camera), cfg, cloud, device=DEVICE)
    res_d = pipe_d.process(left, right)
    torch.cuda.synchronize()
    for name in ("rect_left", "rect_right", "disparity", "depth"):
        t = getattr(res_d, name)
        check(tuple(t.shape) == (H_FULL, W_FULL)
              and bool(torch.isfinite(t).all()),
              f"distorted rig: {name} not finite at full shape")
    check(bool((res_d.rect_left != left.float()).any()),
          "distorted rig: rectification changed nothing")
    # the scene is already rectified, so the calibration's per-view
    # rotations (0.007 rad apart about x) misalign its rows by ~17 px and
    # leave almost nothing to match: this run checks the path, not accuracy
    print(f"distorted rig: finite outputs, density "
          f"{res_d.valid.float().mean().item():.4f}", flush=True)

    # the same matcher through the plain twins on the card, small scene
    small = layered_scene(256, 320, max_disp=40, seed=2)
    ls = torch.tensor(small.left, device=DEVICE)
    rs = torch.tensor(small.right, device=DEVICE)
    check_twins(pyramid_sgm_match(ls, rs, cfg),
                pyramid_sgm_match(ls, rs, cfg, plain=True), "pyramid")

    # timing
    frame_ms = gpu_ms(lambda: pipe.process(left, right), iters=10, warmup=1)
    rl, rr = res.rect_left, res.rect_right
    match_ms = gpu_ms(lambda: pyramid_sgm_match(rl, rr, cfg), iters=10,
                      warmup=1)
    plain_match_ms = gpu_ms(
        lambda: pyramid_sgm_match(rl, rr, cfg, plain=True),
        iters=1, warmup=0)
    print(f"timing [{card}]: full path (raw u8 -> rectify -> pyramid with "
          f"speckle -> depth, cloud, crop) {frame_ms:.3f} ms/frame "
          f"({1000 / frame_ms:.2f} FPS), matcher kernels {match_ms:.3f} ms, "
          f"matcher plain twins {plain_match_ms:.1f} ms at "
          f"{W_FULL}x{H_FULL}", flush=True)
    match_eager_replayed(rl, rr, cfg, card)
    # for comparison: rectified float inputs, speckle off
    pipe_r = StereoPipeline(rig, cfg.replace(speckle_size=0), cloud,
                            device=DEVICE, compute_crop=True,
                            rectify_inputs=False)
    lf, rf = left.float(), right.float()
    old_ms = gpu_ms(lambda: pipe_r.process(lf, rf), iters=10, warmup=1)
    print(f"timing [{card}]: rectified float inputs, speckle off "
          f"{old_ms:.3f} ms/frame", flush=True)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB", flush=True)
    return pipe, left, right


def match_eager_replayed(rl, rr, cfg, card, iters: int = 10) -> None:
    """The flagship match run eagerly and replayed as a CUDA graph, in
    turns (eager, replay, replay, eager; ``iters`` calls a turn): host ms,
    the call on the host clock (no sync inside it), and device ms, CUDA
    events around the call (the stream from the call's start to its last
    operation's end). The replayed result must be bit-equal to the eager
    one."""
    from i3dr_stereo_tpu_torch.matchers import pyramid as pyr

    profile = pyr.profile_from_config(cfg)
    runs = {"eager": lambda: pyr._match(rl, rr, cfg=cfg, profile=profile,
                                        lean=False, plain=False),
            "replay": lambda: pyr.pyramid_sgm_match(rl, rr, cfg)}
    for _ in range(3):          # eager, captured, then a replay
        got = runs["replay"]()
    want = runs["eager"]()
    check(torch.equal(got.disparity, want.disparity)
          and torch.equal(got.valid, want.valid),
          "the replayed match differs from the eager one")
    turns = ("eager", "replay", "replay", "eager")
    for i, turn in enumerate(turns):
        host, dev = [], []
        for _ in range(iters):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            t0 = time.perf_counter()
            runs[turn]()
            host.append((time.perf_counter() - t0) * 1e3)
            b.record()
            torch.cuda.synchronize()
            dev.append(a.elapsed_time(b))
        print(f"match turn {i + 1} {turn} [{card}]: host "
              f"{statistics.median(host):.3f} ms, device "
              f"{statistics.median(dev):.3f} ms (medians of {iters})",
              flush=True)


# ---------------------------------------------------------------------------
# phase 6: where the frame's time goes
# ---------------------------------------------------------------------------

def phase_profile(pipe, left, right, card, label="flagship",
                  frames: int = 5):
    """Device busy time and idle share over one window of ``frames``
    back-to-back frames, both from the same window: busy is the union of
    the device activity spans the profiler records (device activity only,
    so the host runs as unprofiled as the profiler allows), wall is the
    host clock around the window."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            pipe.process(left, right)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = trace.read(prof, frames).device
    check(len(spans) > 0, "the profiler recorded no device activity")
    busy = trace.length(trace.union((s, e) for s, e, _ in spans)) / 1e3
    per_name: dict[str, list] = {}
    for s, e, name in spans:
        acc = per_name.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += e - s
    ours = sum(t for n, (_, t) in per_name.items()
               if any(k in n for k in KERNEL_SYMBOLS)) / 1e3
    htod = sum(n for name, (n, _) in per_name.items()
               if name.startswith("Memcpy HtoD"))
    print(f"profile {label} [{card}]: {frames} frames, wall "
          f"{wall / frames:.3f} "
          f"ms/frame (profiler on), device busy {busy / frames:.3f} ms/frame "
          f"({len(spans) / frames:.0f} device activities per frame, "
          f"{htod / frames:.0f} of them host-to-device copies), idle "
          f"share {1 - busy / wall:.4f}; the port's kernels "
          f"{ours / frames:.3f} ms/frame", flush=True)
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][1])
    for name, (n, t) in ranked[:12]:
        print(f"  {t / 1e3 / frames:8.3f} ms/frame {n // frames:5d}x  "
              f"{name[:90]}", flush=True)
    print("the port's kernels in that window:", flush=True)
    kernels = {}
    for name, (n, t) in ranked:
        if any(k in name for k in KERNEL_SYMBOLS):
            kernels[name] = t / 1e3 / frames
            print(f"  {t / 1e3 / frames:8.3f} ms/frame {n // frames:5d}x  "
                  f"{name[:90]}", flush=True)
    return {"wall_ms": wall / frames, "busy_ms": busy / frames,
            "idle_share": 1 - busy / wall, "activities": len(spans) / frames,
            "port_kernels_ms": ours / frames, "kernels_ms": kernels,
            "names_ms": {name: t / 1e3 / frames
                         for name, (_, t) in per_name.items()}}


# ---------------------------------------------------------------------------
# phase 7: the volume SGM kernels against their plain twins
# ---------------------------------------------------------------------------

def timed(fn):
    """(fn(), device ms of that one call) (CUDA events)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def chain_bytes(sgm, C, groups, int16_mode, S=None) -> int:
    """Bytes the accumulating chain moves once: per launch the costs read,
    the plane it writes, and the planes it reads (x, acc)."""
    total = 0

    def count(Cv, dy, dx, p1, p2, out, x=None, acc=None):
        nonlocal total
        total += Cv.numel() * (Cv.element_size() + out.element_size()) + sum(
            t.numel() * t.element_size() for t in (x, acc) if t is not None)

    sgm.fold_paths(C, groups, int16_mode, count, S)
    return total


def compare_volume(sgm, C, p1, p2, dirs, label, stats, pens=None,
                   out_dtype=None, time_it=False, per_direction=False):
    """The accumulating chain of sgm_volume launches vs its twin (S after
    the last direction, each direction folded into S and T in place) and
    the whole sgm_aggregate vs sgm_aggregate_plain, bit-equal; with
    ``per_direction`` each direction's path costs alone too."""
    Cb, groups, int16_mode, (H, W, D) = sgm.plan(C, p1, p2, dirs, pens,
                                                 out_dtype)
    sizes = [len(ds) for _, ds in groups]
    if per_direction:
        for (pp1, pp2), ds in groups:
            for dy, dx in ds:
                k = torch.empty(Cb.shape, device=Cb.device)
                sgm.sgm_volume_step(Cb, dy, dx, pp1, pp2, k)
                p = sgm.sgm_volume_path_plain(Cb, dy, dx, pp1, pp2)
                err = (k - p).abs().max().item()
                stats["sgm_volume"]["err"] = max(stats["sgm_volume"]["err"],
                                                 err)
                check(torch.equal(k, p), f"{label}: sgm_volume {(dy, dx)} "
                      f"path costs differ from the twin's (max {err})")
                del k, p
    S = sgm.fold_paths(Cb, groups, int16_mode)
    S_plain, plain_ms = timed(lambda: sgm.fold_paths(
        Cb, groups, int16_mode, sgm.sgm_volume_step_plain))
    err = (S.double() - S_plain.double()).abs().max().item()
    stats["sgm_volume"]["err"] = max(stats["sgm_volume"]["err"], err)
    check(S.dtype == S_plain.dtype and torch.equal(S, S_plain),
          f"{label}: the sgm_volume chain differs from its twin (max {err})")
    whole = sgm.sgm_aggregate(C, p1, p2, dirs, pens, out_dtype=out_dtype)
    ref = S_plain[:, :H, :W, :D]
    check(torch.equal(whole, ref if C.ndim == 4 else ref[0]),
          f"{label}: sgm_aggregate differs from sgm_aggregate_plain")
    big = (ref >= (9999 if int16_mode else 5e8)).float().mean().item()
    print(f"{label}: {sum(sizes)} sgm_volume directions in groups {sizes}, "
          f"the accumulating chain and sgm_aggregate bit-equal to their twins"
          f" ({str(S.dtype)[6:]} S, {big:.4f} of it invalid-level)",
          flush=True)
    del S, S_plain, whole, ref
    if time_it:
        # every launch of the chain, timed inside it (median of 5 chains)
        per_launch = []
        for _ in range(5):
            evs = []

            def step(*a, **kw):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                sgm.sgm_volume_step(*a, **kw)
                e1.record()
                evs.append((a[1:3], e0, e1))

            sgm.fold_paths(Cb, groups, int16_mode, step)
            torch.cuda.synchronize()
            per_launch.append([e0.elapsed_time(e1) for _, e0, e1 in evs])
        launch_ms = [statistics.median(t) for t in zip(*per_launch)]
        ms = gpu_ms(lambda: sgm.fold_paths(Cb, groups, int16_mode))
        stats["sgm_volume"]["ms"], stats["sgm_volume"]["plain_ms"] = (
            ms, plain_ms)
        n = Cb.numel()
        nbytes = chain_bytes(sgm, Cb, groups, int16_mode)
        # ~10 operations an element a direction (the step) and one or two
        # for the op
        set_bound(stats, "sgm_volume", nbytes, 12 * n * sum(sizes))
        print(f"the whole chain ({sum(sizes)} launches, sum included) "
              f"{ms:.3f} ms (plain {plain_ms:.1f}); {nbytes / 1e9:.3f} GB "
              f"moved once, {nbytes / PEAK_BYTES_S * 1e3:.4f} ms at the HBM "
              f"peak, {nbytes / ms / 1e6:.1f} GB/s reached; per launch "
              + ", ".join(f"{d}: {t:.3f}" for (d, _, _), t in zip(evs,
                                                                   launch_ms)),
              flush=True)


def phase_volume(stats):
    from i3dr_stereo_tpu_torch.ops import sgm

    rng = np.random.default_rng(7)
    dev = torch.device(DEVICE)

    def volume(shape, kind, invalid_cols=0):
        if kind == "u8":
            c = rng.integers(0, 81, shape, dtype=np.uint8)
            bad = 255
        else:
            c = (rng.uniform(0, 60, shape) if kind == "float"
                 else rng.integers(0, 81, shape)).astype(np.float32)
            bad = 1.0e9
        c[rng.random(shape) < 0.03] = bad
        for x in range(invalid_cols):      # min_disparity-style columns
            c[..., x, x:] = bad
        return torch.tensor(c, device=dev)

    # the SGBM configuration's volume: 1024x1280, D = 128, 8 paths
    C = volume((1, H_SGBM, W_SGBM, 128), "float", 16)
    compare_volume(sgm, C, 200.0, 400.0, sgm.DIRECTIONS_8,
                   f"sgm_volume {W_SGBM}x{H_SGBM}x128 f32 8 paths", stats,
                   time_it=True, per_direction=True)
    compare_volume(sgm, C, 200.0, 400.0, sgm.DIRECTIONS_8,
                   f"sgm_volume {W_SGBM}x{H_SGBM}x128 f32 8 paths int16 "
                   f"mode", stats, out_dtype=torch.int16)
    del C
    # census-scale costs (integer hamming, D = 64 padded to 128), 4 paths
    compare_volume(sgm, volume((1, H_SGBM, W_SGBM, 64), "int", 16), 0.1,
                   0.8, sgm.DIRECTIONS_4,
                   f"sgm_volume {W_SGBM}x{H_SGBM}x64 census-scale 4 paths",
                   stats)
    # uint8 with the 255 sentinel into the int16 mode
    compare_volume(sgm, volume((1, 256, 320, 64), "u8", 8), 7.0, 86.0,
                   sgm.DIRECTIONS_8, "sgm_volume 320x256x64 uint8 int16 mode",
                   stats, out_dtype=torch.int16, per_direction=True)
    # W * D this wide splits a three-direction family into groups of one
    # (the TPU's VMEM rule: one int16 clamp a direction); two directions
    # still fit one group
    check(not sgm._vmem_ok_vertical(1160, 512, 3, 1), "no split at 1160x512")
    compare_volume(sgm, volume((1, 8, 1160, 400), "u8"), 7.0, 86.0,
                   ((0, 1), (1, 0), (1, 1), (1, -1), (-1, 0), (-1, 1)),
                   "sgm_volume 1160x8x400 uint8 int16 mode, split families",
                   stats, out_dtype=torch.int16)
    # ragged, batched, per-direction penalties: two groups in each
    # vertical family; a vertical group first, without (0, 1) / (0, -1)
    pens = [(1.5, 9.0), (2.0, 11.0), (1.5, 9.0), (2.0, 11.0), (0.75, 30.0),
            (2.0, 11.0), (1.5, 9.0), (0.5, 4.0)]
    Cr = volume((2, 131, 45, 130), "float", 5)
    compare_volume(sgm, Cr, 0.0, 0.0, sgm.DIRECTIONS_8,
                   "sgm_volume ragged 2x45x131x130 per-direction penalties",
                   stats, pens=pens, per_direction=True)
    for od in (None, torch.int16):
        compare_volume(sgm, Cr, 1.5, 9.0, ((1, 0), (1, 1), (1, -1), (-1, 0)),
                       f"sgm_volume ragged 2x45x131x130 a group first "
                       f"{'int16' if od else 'float32'} mode", stats,
                       out_dtype=od)


# ---------------------------------------------------------------------------
# phase 8: the SGBM frame at full width
# ---------------------------------------------------------------------------

def sgbm_cfg(params):
    """``accuracy_bench.py:sgbm_1280``'s config."""
    return params.ALGORITHM_DEFAULTS[params.Algorithm.SGBM].replace(
        disparity_range=128, window_size=5, p1=200.0, p2=400.0,
        uniqueness_ratio=10.0, disp12_max_diff=1.0, speckle_size=0,
        num_directions=8, subpixel=True)


def sgbm_pipe(window_size=5, lean=False):
    """The SGBM frame: ``accuracy_bench.py:sgbm_1280``'s scene and config
    (at another ``window_size`` and through ``lean`` where asked), raw
    uint8 in, rectified on the ideal rig. Returns (pipe, left, right,
    scene, cfg, cloud)."""
    from i3dr_stereo_tpu_torch.config import params
    from i3dr_stereo_tpu_torch.core import camera
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline

    cfg = sgbm_cfg(params).replace(window_size=window_size)
    sc = layered_scene(H_SGBM, W_SGBM, **SGBM_SCENE)
    rig = camera.StereoRig.synthetic(W_SGBM, H_SGBM, fx=580.0,
                                     baseline_m=0.3)
    cloud = params.PointCloudConfig(depth_max=100.0, depth_min=0.5)
    pipe = StereoPipeline(rig, cfg, cloud, device=DEVICE, lean=lean)
    check(pipe.rectify_inputs, "the SGBM frame must rectify")
    left = torch.tensor(raw_u8(sc.left), device=DEVICE)
    right = torch.tensor(raw_u8(sc.right), device=DEVICE)
    return pipe, left, right, sc, cfg, cloud


def phase_sgbm(stats, card):
    from i3dr_stereo_tpu_torch import _build
    from i3dr_stereo_tpu_torch.config import params
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.matchers import registry
    from i3dr_stereo_tpu_torch.ops import sgm
    from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline

    pipe, left, right, sc, cfg, cloud = sgbm_pipe()
    rig = pipe.rig

    res = drive_frame(pipe, left, right, sc, SGBM_KERNELS, "SGBM frame",
                      stats, record=("sgm_volume", "bt_box_cost"))
    check(_build.LAUNCHES["bt_box_cost"] == 1, "SGBM frame: bt_box_cost "
          "launched other than once")

    # the same matcher through the plain twins on the card, small scene
    small = layered_scene(256, 320, max_disp=40, seed=2)
    ls = torch.tensor(small.left, device=DEVICE)
    rs = torch.tensor(small.right, device=DEVICE)
    scfg = cfg.replace(disparity_range=64)
    mk = registry.sgbm_match(ls, rs, scfg)
    registry.sgm_aggregate = sgm.sgm_aggregate_plain
    try:
        mp = registry.sgbm_match(ls, rs, scfg)
    finally:
        registry.sgm_aggregate = sgm.sgm_aggregate
    check_twins(mk, mp, "SGBM")

    # the other dense matchers, once each at full size
    others = (
        ("SGBM defaults (speckle 100 / 4.0)",
         params.ALGORITHM_DEFAULTS[params.Algorithm.SGBM], "speckle_ccl"),
        ("BM defaults", params.ALGORITHM_DEFAULTS[params.Algorithm.BM],
         None),
        ("dense I3DRSGM D=64",
         params.ALGORITHM_DEFAULTS[params.Algorithm.I3DRSGM].replace(
             pyramid=False, disparity_range=64), "sgm_volume"),
    )
    for label, ocfg, kernel in others:
        _build.reset_launches()
        out = StereoPipeline(rig, ocfg, cloud, device=DEVICE).process(
            left, right)
        torch.cuda.synchronize()
        if kernel:
            check(_build.LAUNCHES[kernel] > 0, f"{label}: {kernel} did not "
                  f"launch")
        ov = out.valid
        check(bool(torch.isfinite(out.disparity[ov]).all())
              and bool(torch.isfinite(out.depth).all()),
              f"{label}: non-finite outputs")
        om = (ov.cpu().numpy() & sc.valid)
        oerr = float(np.median(np.abs(out.disparity.cpu().numpy()
                                      - sc.disparity)[om]))
        print(f"{label} at {W_SGBM}x{H_SGBM}: finite, density "
              f"{ov.float().mean().item():.4f}, median |d - GT| {oerr:.4f} "
              f"px", flush=True)

    # timing
    torch.cuda.reset_peak_memory_stats()
    frame_ms = gpu_ms(lambda: pipe.process(left, right), iters=10, warmup=1)
    rl, rr = res.rect_left, res.rect_right
    match_ms = gpu_ms(lambda: registry.sgbm_match(rl, rr, cfg), iters=10,
                      warmup=1)
    print(f"timing [{card}]: SGBM frame (raw u8 -> rectify -> SGBM "
          f"{cfg.disparity_range}d 8 paths -> depth, cloud) {frame_ms:.3f} "
          f"ms/frame ({1000 / frame_ms:.2f} FPS), matcher {match_ms:.3f} ms "
          f"at {W_SGBM}x{H_SGBM}", flush=True)
    print(f"SGBM peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return pipe, left, right

# ---------------------------------------------------------------------------
# phase 8b: SGBM's BT cost and box sum at the sgbm_1920 cell's shape
# ---------------------------------------------------------------------------

# portbench/configs/sgbm_1920.json: 1920x1080, 480 disparities from 147,
# window 9, prefilter cap 31
H_BOX, W_BOX, D_BOX, MIN_D_BOX, WIN_BOX = 1080, 1920, 480, 147, 9


def box_pair(H, W, seed=5):
    """A (1, H, W) prefiltered pair as the sgbm_1920 cell's matcher sees
    it: a layered scene in its range of disparities, resampled a fraction
    of a pixel (as rectification leaves it) and through the x-Sobel
    prefilter, so the costs are fractional."""
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.ops.cost import xsobel_prefilter

    sc = layered_scene(H, W, max_disp=600, background_disp=160, layers=6,
                       seed=seed)
    out = []
    for img in (sc.left, sc.right):
        t = torch.tensor(img, dtype=torch.float32, device=DEVICE)[None]
        t = 0.37 * t + 0.63 * torch.roll(t, 1, -1)
        out.append(xsobel_prefilter(t, 31).contiguous())
    return out


def phase_bt_box(stats, card):
    """``bt_box_cost`` against its plain twin (``box_aggregate(
    *bt_cost_volume(...))`` on the card), bit-equal, at the sgbm_1920
    cell's shape and at other windows (its two passes at 21); its
    time by events and back to back against its bound (the two images read
    once, the volume written once); the twin's device activities counted
    by the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from i3dr_stereo_tpu_torch.ops import cost

    lf, rf = box_pair(H_BOX, W_BOX)
    args = (lf, rf, MIN_D_BOX, D_BOX)

    def twin(win):
        return cost.box_aggregate(*cost.bt_cost_volume(*args), win)

    # 15 runs the one pass at r = 7, 21 the two passes
    for win in (WIN_BOX, 1, 5, 11, 15, 21):
        got = cost.bt_box_cost_volume(*args, win)
        ref, plain_ms = timed(lambda: twin(win))
        err = (got.double() - ref.double()).abs().max().item()
        stats["bt_box_cost"]["err"] = max(stats["bt_box_cost"]["err"], err)
        check(torch.equal(got, ref), f"bt_box_cost window {win} differs "
              f"from its twin (max {err})")
        big = (got >= 5e8).float().mean().item()
        del got, ref
        ms = gpu_ms(lambda: cost.bt_box_cost_volume(*args, win))
        print(f"bt_box_cost {W_BOX}x{H_BOX}x{D_BOX} from {MIN_D_BOX}, window "
              f"{win}: bit-equal to its twin ({big:.4f} of it 1e9); "
              f"[{card}] {ms:.4f} ms by events, twin {plain_ms:.1f} ms "
              f"(one call)", flush=True)
        if win == WIN_BOX:
            stats["bt_box_cost"]["plain_ms"] = plain_ms
            stats["bt_box_cost"]["ms"] = ms
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        twin(WIN_BOX)
        torch.cuda.synchronize()
    spans = trace.read(prof, 1).device
    check(len(spans) > 0, "the profiler recorded no device activity")
    busy = trace.length(trace.union((s, e) for s, e, _ in spans)) / 1e3
    per_name: dict[str, list] = {}
    for s0, e0, name in spans:
        acc = per_name.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += e0 - s0
    print(f"the twin's device activities at window {WIN_BOX}: {len(spans)}, "
          f"busy {busy:.3f} ms", flush=True)
    for name, (n, t) in sorted(per_name.items(),
                               key=lambda kv: -kv[1][1])[:8]:
        print(f"  {t / 1e3:8.3f} ms {n:4d}x  {name[:90]}", flush=True)

    b2b = back_to_back_ms(
        lambda: cost.bt_box_cost_volume(*args, WIN_BOX), iters=20)
    n = H_BOX * W_BOX * D_BOX
    nbytes = 2 * H_BOX * W_BOX * 4 + 4 * n
    set_bound(stats, "bt_box_cost", nbytes, (9 + 2 * (WIN_BOX - 1)) * n)
    st = stats["bt_box_cost"]
    st["back_to_back_ms"] = b2b
    print(f"bt_box_cost [{card}]: {st['ms']:.4f} ms by events, {b2b:.4f} "
          f"back to back; bound {st['bound_ms']:.4f} ms ({st['bound_by']}: "
          f"{nbytes / 1e9:.3f} GB once): {st['bound_ms'] / st['ms']:.1%} / "
          f"{st['bound_ms'] / b2b:.1%} of it; "
          f"{nbytes / b2b / 1e6:.1f} GB/s reached", flush=True)


# ---------------------------------------------------------------------------
# phase 9: the fused cost + SGM kernels against their plain twins
# ---------------------------------------------------------------------------

def compare_fused(name, kernel, plain, args, kw, label, stats):
    """One fused forward kernel vs its twin: C and S bit-equal in the
    float32 and the int16 mode. Returns the kernel's (C, float32 L) and
    the device ms of the float32 twin's one call."""
    out = None
    for od in (torch.float32, torch.int16):
        C, S = kernel(*args, out_dtype=od, **kw)
        (Cp, Sp), ms = timed(lambda: plain(*args, out_dtype=od, **kw))
        errC = int((C.int() - Cp.int()).abs().max().item())
        errS = (S.float() - Sp.float()).abs().max().item()
        stats[name]["err"] = max(stats[name]["err"], float(errC), errS)
        check(torch.equal(C, Cp), f"{label}: {name} C differs from its twin "
              f"(max {errC})")
        check(torch.equal(S, Sp), f"{label}: {name} {str(od)[6:]} S differs "
              f"from its twin (max {errS})")
        out = out or (C, S, ms)
    C, L, plain_ms = out
    print(f"{label}: {name} C and S (float32, int16) bit-equal to the twin "
          f"({(C == 255).float().mean().item():.4f} of C invalid, "
          f"{(C == 254).float().mean().item():.6f} at the clamp, max L below "
          f"1e9 {L[L < 5e8].max().item():.1f})", flush=True)
    return C, L, plain_ms


def time_fused(name, kernel, args, kw, plain_ms, nbytes_in, ops_per_pair,
               stats, label, card, record=True, popc_per_pair=0):
    """Time one fused forward kernel with the int16 path costs the lean
    path asks for (and, for comparison, float32) beside its twin's time
    from compare_fused; with ``record`` the numbers go into the kernel's
    entry."""
    ms32 = gpu_ms(lambda: kernel(*args, **dict(kw, out_dtype=torch.float32)))
    kw = dict(kw, out_dtype=torch.int16)
    ms = gpu_ms(lambda: kernel(*args, **kw))
    b2b32 = back_to_back_ms(
        lambda: kernel(*args, **dict(kw, out_dtype=torch.float32)), iters=10)
    b2b = back_to_back_ms(lambda: kernel(*args, **kw), iters=10)
    C, _ = kernel(*args, **kw)
    n = C.numel()
    nbytes = nbytes_in + 3 * n      # inputs in; uint8 C and int16 S out
    if record:
        stats[name]["ms"], stats[name]["plain_ms"] = ms, plain_ms
        stats[name]["back_to_back_ms"] = b2b
        set_bound(stats, name, nbytes, ops_per_pair * n,
                  npopc=popc_per_pair * n)
    print(f"{label} [{card}]: {name} {ms:.4f} ms with int16 S, {ms32:.4f} "
          f"with float32 (back to back {b2b:.4f}, {b2b32:.4f}; "
          f"plain twin {plain_ms:.1f} ms; int16: "
          f"{nbytes / 1e9:.3f} GB moved once, "
          f"{nbytes / PEAK_BYTES_S * 1e3:.4f} ms at the HBM peak, "
          f"{nbytes / ms / 1e6:.1f} GB/s reached"
          + (f"; {popc_per_pair * n / 1e6:.0f} M popcounts, "
             f"{popc_per_pair * n / PEAK_POPC_S * 1e3:.4f} ms at "
             f"{PEAK_POPC_S / 1e12:.2f} T/s" if popc_per_pair else "")
          + ")", flush=True)


def compare_whole(fn, args, kw, label, card):
    """A whole fused aggregation, kernels vs twins: S and C bit-equal."""
    (S, C), ms = timed(lambda: fn(*args, **kw))
    (Sp, Cp), plain_ms = timed(lambda: fn(*args, plain=True, **kw))
    check(torch.equal(C, Cp), f"{label}: C differs from the twins'")
    check(torch.equal(S, Sp), f"{label}: S differs from the twins' (max "
          f"{(S.double() - Sp.double()).abs().max().item()})")
    level = 9999 if S.dtype == torch.int32 else 5e8
    print(f"{label} [{card}]: S ({str(S.dtype)[6:]}) and C bit-equal to the "
          f"twins ({(S >= level).float().mean().item():.4f} of S "
          f"invalid-level); {ms:.3f} ms (twins {plain_ms:.1f} ms), one call "
          f"each", flush=True)


def phase_fused(stats, card):
    from i3dr_stereo_tpu_torch.config import params
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.ops import fused_cost_sgm as fcs
    from i3dr_stereo_tpu_torch.ops import sgm
    from i3dr_stereo_tpu_torch.ops.census import census_transform
    from i3dr_stereo_tpu_torch.ops.cost import xsobel_prefilter

    dev = torch.device(DEVICE)
    cfg = flagship_cfg(params)
    J = ("fused_census_fwd", fcs.fused_census_horizontal,
         fcs.fused_census_horizontal_plain)
    K = ("fused_bt_fwd", fcs.fused_bt_horizontal,
         fcs.fused_bt_horizontal_plain)

    def bases(H, value):
        return torch.full((H // fcs.row_tile(H),), value, dtype=torch.int32,
                          device=dev)

    # J at every level of the lean pyramid at its own shape
    sc = layered_scene(H_FULL, W_FULL, **SCENE)
    D = 32
    level0 = None
    for level, cl, cr, base, Hh, Wh in lean_levels(cfg, sc, D):
        H8, W8 = cl.shape[1:3]
        args = (fcs.census_word_planes(cl), fcs.census_word_planes(cr),
                bases(H8, base), D, cfg.p1, cfg.p2)
        _, _, twin_ms = compare_fused(
            *J, args, {}, f"lean level {level} {Wh}x{Hh} in {W8}x{H8} "
            f"D={D} base={base}", stats)
        if level == 0:
            level0 = (cl, cr, args, twin_ms)
    cl0, cr0, args0, twin_ms = level0
    NW = cl0.shape[-1]
    words_in = 2 * cl0.numel() * 4
    time_fused(*J[:2], args0, {}, twin_ms, words_in, NW + 10, stats,
               f"lean level 0 {W_FULL}x{H_FULL}x{D} base=-16", card,
               popc_per_pair=NW)

    # bench.py:sgm_direct_2448's shape: all 256 disparities at full
    # resolution, unwarped (base 0)
    cl256 = census_transform(torch.tensor(sc.left, device=dev)[None], 9, 9)
    cr256 = census_transform(torch.tensor(sc.right, device=dev)[None], 9, 9)
    args256 = (fcs.census_word_planes(cl256), fcs.census_word_planes(cr256),
               bases(H_FULL, 0), 256, 10.0, 120.0)
    _, _, twin_ms = compare_fused(
        *J, args256, {}, f"direct {W_FULL}x{H_FULL}x256 base=0", stats)
    time_fused(*J[:2], args256, {}, twin_ms, words_in, NW + 10, stats,
               f"direct {W_FULL}x{H_FULL}x256 base=0", card, record=False,
               popc_per_pair=NW)
    del cl256, cr256, args256
    torch.cuda.empty_cache()

    # small shapes: a 17x17 census against the negated image (distances
    # up to 288, so C clamps and the sweep does not), non-uniform bases
    # reaching below -64, ragged B = 2 (H = 44: row tiles of 4; W = 131;
    # D = 48 leaves half the lanes of K = 2 empty)
    rng = np.random.default_rng(3)
    a = torch.tensor(rng.uniform(0, 255, (2, 44, 131)), dtype=torch.float32,
                     device=dev)
    b = torch.roll(a, -5, 2) + torch.tensor(rng.normal(0, 4, a.shape),
                                            dtype=torch.float32, device=dev)
    ragged = torch.tensor(rng.integers(-90, 20, (11,)), dtype=torch.int32,
                          device=dev)
    # and for the D = 32 kernel: the same ragged frame (W = 131 is no
    # multiple of its 32-column tiles or 8-column blocks), bases that leave
    # whole rows without a valid column on either side, 5x5 and 17x17
    # words, and 2 x 43 rows (row tiles of 1; the last warp is partial)
    empty = ragged.clone()
    empty[2], empty[5], empty[7] = 131 + 40, -(131 + 40), 131
    for win, other, D_s, md, base, label in (
            (17, -a, 40, 0, bases(44, 0), "17x17 census vs the negative"),
            (9, b, 48, 3, ragged, "ragged 2x44x131 D=48 non-uniform base"),
            (9, b, 32, 3, ragged, "ragged 2x44x131 D=32 non-uniform base"),
            (9, b, 32, 0, empty, "ragged 2x44x131 D=32, bases that empty "
                                 "rows"),
            (9, b, 48, 0, empty, "ragged 2x44x131 D=48, bases that empty "
                                 "rows"),
            (5, b, 32, -2, ragged, "ragged 2x44x131 D=32 5x5 census"),
            (17, -a, 32, 0, ragged, "ragged 2x44x131 D=32 17x17 census vs "
                                    "the negative"),
            (9, b[:, :43], 32, 1, bases(43, -7), "2x43x131 D=32, a partial "
                                                 "warp")):
        rows = other.shape[1]
        planes = [fcs.census_word_planes(census_transform(x[:, :rows], win,
                                                          win))
                  for x in (a, other)]
        C, L, _ = compare_fused(*J, (*planes, base, D_s, 1.5, 9.0),
                                dict(min_disp=md), label, stats)
        if label.startswith("17x17"):
            check(bool((C == 254).any()) and L[L < 5e8].max().item() > 254,
                  "17x17: no distance above the uint8 clamp")
    pens = [(1.5, 9.0), (2.0, 11.0), (1.5, 9.0), (2.0, 11.0), (0.75, 30.0),
            (2.0, 11.0), (1.5, 9.0), (0.5, 4.0)]
    ca, cb = census_transform(a, 9, 9), census_transform(b, 9, 9)
    for od in (torch.int16, torch.float32):
        compare_whole(fcs.fused_census_sgm, (ca, cb, 48),
                      dict(base=-7, min_disp=2, per_direction_penalties=pens,
                           directions=sgm.DIRECTIONS_8, out_dtype=od),
                      f"fused_census_sgm ragged 2x44x131x48 8 paths "
                      f"{str(od)[6:]}", card)

    # K at the lean SGBM frame's shape and at a ragged D with a negative
    # minimum disparity
    ssc = layered_scene(H_SGBM, W_SGBM, **SGBM_SCENE)
    lp = xsobel_prefilter(torch.tensor(raw_u8(ssc.left), device=dev)
                          .float()[None], 31).contiguous()
    rp = xsobel_prefilter(torch.tensor(raw_u8(ssc.right), device=dev)
                          .float()[None], 31).contiguous()
    argsK = (lp, rp, bases(H_SGBM, 0), 128, 400.0, 800.0)
    _, _, twin_ms = compare_fused(*K, argsK, {},
                                  f"lean SGBM {W_SGBM}x{H_SGBM}x128", stats)
    time_fused(*K[:2], argsK, {}, twin_ms, 2 * lp.numel() * 4, 30, stats,
               f"lean SGBM {W_SGBM}x{H_SGBM}x128", card)
    pa, pb = xsobel_prefilter(a, 31), xsobel_prefilter(b, 31)
    C, _, _ = compare_fused(*K, (pa, pb, ragged, 130, 16.0, 64.0),
                         dict(min_disp=-2),
                         "ragged 2x44x131 D=130 min_disp=-2 non-uniform base",
                         stats)
    check(bool((C[C < 255] % 2 == 1).any()), "BT: no half-sample cost")
    # every path of the staged kernel, B = 2: W % 8 != 0 (131: the tail
    # walked column by column), a row narrower than one 32-column tile and
    # than the D + 1 halo (20), whole tiles only (64); D = 1, 16, 48 (2 a
    # lane), 128 and 256 (whole 16-byte stores), 130, 300 (12 a lane), 384,
    # 512; negative minimum disparities; bases that empty whole row tiles
    for D_k, md, base_k, W_k in ((1, 0, ragged, 131), (16, -3, empty, 131),
                                 (48, 1, ragged, 131), (128, 0, ragged, 131),
                                 (128, -5, empty, 131), (130, 2, empty, 131),
                                 (256, 0, ragged, 131), (300, -7, ragged, 131),
                                 (512, 4, ragged, 131), (128, 0, ragged, 20),
                                 (512, -2, empty, 20), (128, 3, ragged, 64),
                                 (384, 0, empty, 64)):
        compare_fused(*K, (pa[..., :W_k].contiguous(),
                           pb[..., :W_k].contiguous(), base_k, D_k, 16.0,
                           64.0), dict(min_disp=md),
                      f"ragged 2x44x{W_k} D={D_k} min_disp={md} "
                      + ("bases that empty rows" if base_k is empty
                         else "non-uniform base"), stats)

    # the whole aggregations at the two main paths' shapes: J's int16 plane
    # (int16 mode) or its float32 plane folded into by the sgm_volume chain
    for od in (torch.int16, torch.float32):
        compare_whole(fcs.fused_census_sgm, (cl0, cr0, 32),
                      dict(base=-16,
                           per_direction_penalties=[(cfg.p1, cfg.p2)] * 4,
                           directions=sgm.DIRECTIONS_4, out_dtype=od),
                      f"fused_census_sgm {W_FULL}x{H_FULL}x32 4 paths "
                      f"{str(od)[6:]}", card)
    compare_whole(fcs.fused_bt_sgm, (lp, rp, 128),
                  dict(p1=200.0, p2=400.0, directions=sgm.DIRECTIONS_8),
                  f"fused_bt_sgm {W_SGBM}x{H_SGBM}x128 8 paths int16", card)


# ---------------------------------------------------------------------------
# phases 10 - 12: the lean frames and the direct 256-disparity chain
# ---------------------------------------------------------------------------

def drive_frame(pipe, left, right, sc, kernels, label, stats, record=(),
                max_med=MAX_MEDIAN_ERR):
    """One counted frame of ``pipe``: every kernel of ``kernels`` must
    launch, outputs finite, the accuracy gate (median error below
    ``max_med``, density > 0.5). Returns the result."""
    from i3dr_stereo_tpu_torch import _build

    pipe.process(left, right)  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    res = pipe.process(left, right)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    H, W = left.shape
    print(f"{label} launches at {W}x{H}: {launches}", flush=True)
    for name in kernels:
        check(launches[name] > 0, f"kernel {name} did not launch on the "
              f"{label}")
    for name in record:
        stats[name]["launches"] = launches[name]
    d = res.disparity.cpu().numpy()
    v = res.valid.cpu().numpy()
    check(d.shape == (H, W) and v.shape == d.shape,
          f"{label}: disparity shape {d.shape}")
    check(bool(np.isfinite(d[v]).all()), f"{label}: non-finite disparities")
    check(res.depth is not None and bool(torch.isfinite(res.depth).all()),
          f"{label}: non-finite depth")
    both = v & sc.valid
    density = float(v.mean())
    med = float(np.median(np.abs(d - sc.disparity)[both]))
    print(f"{label} accuracy: density {density:.4f}, GT-valid coverage "
          f"{both.sum() / sc.valid.sum():.4f}, median |d - GT| {med:.4f} px",
          flush=True)
    check(density > 0.5, f"{label}: density {density} too low")
    check(med < max_med, f"{label}: median error {med} >= {max_med}")
    return res


def check_twins(mk, mp, label):
    agree = (mk.valid == mp.valid).float().mean().item()
    vb = mk.valid & mp.valid
    dd = (mk.disparity - mp.disparity)[vb].abs().max().item()
    print(f"{label} 256x320 kernels vs twins: valid agreement {agree:.6f}, "
          f"max |dd| {dd}", flush=True)
    check(agree >= MIN_VALID_AGREE, f"{label}: valid agreement {agree}")
    check(dd <= TOL_PATH_DISP, f"{label}: |dd| {dd} > {TOL_PATH_DISP}")


def phase_lean_flagship(stats, card):
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.matchers.pyramid import pyramid_sgm_match

    pipe, left, right, sc, cfg, _ = flagship_pipe(lean=True)
    torch.cuda.reset_peak_memory_stats()
    res = drive_frame(pipe, left, right, sc, LEAN_FLAGSHIP_KERNELS,
                      "lean flagship frame", stats,
                      record=("fused_census_fwd",))
    check(tuple(res.points["xyz"].shape) == (H_FULL * W_FULL, 3),
          "lean flagship frame: point cloud shape")

    small = layered_scene(256, 320, max_disp=40, seed=2)
    ls = torch.tensor(small.left, device=DEVICE)
    rs = torch.tensor(small.right, device=DEVICE)
    check_twins(pyramid_sgm_match(ls, rs, cfg, lean=True),
                pyramid_sgm_match(ls, rs, cfg, lean=True, plain=True),
                "lean pyramid")

    frame_ms = gpu_ms(lambda: pipe.process(left, right), iters=10, warmup=1)
    rl, rr = res.rect_left, res.rect_right
    match_ms = gpu_ms(lambda: pyramid_sgm_match(rl, rr, cfg, lean=True),
                      iters=10, warmup=1)
    print(f"timing [{card}]: lean flagship frame (raw u8 -> rectify -> lean "
          f"pyramid with speckle -> depth, cloud, crop) {frame_ms:.3f} "
          f"ms/frame ({1000 / frame_ms:.2f} FPS), matcher {match_ms:.3f} ms "
          f"at {W_FULL}x{H_FULL}", flush=True)
    print(f"lean flagship peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return pipe, left, right


def phase_lean_sgbm(stats, card):
    import functools

    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.matchers import registry
    from i3dr_stereo_tpu_torch.ops import fused_cost_sgm as fcs

    # the lean condition is window_size <= 1; everything else unchanged
    pipes, peaks = {}, {}
    for lean in (True, False):
        name = "lean" if lean else "default"
        pipes[name], left, right, sc, cfg, _ = sgbm_pipe(window_size=1,
                                                         lean=lean)
        torch.cuda.reset_peak_memory_stats()
        drive_frame(pipes[name], left, right, sc,
                    LEAN_SGBM_KERNELS if lean else SGBM_KERNELS,
                    f"SGBM window-1 frame ({name})", stats,
                    record=("fused_bt_fwd",) if lean else ())
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30

    small = layered_scene(256, 320, max_disp=40, seed=2)
    ls = torch.tensor(small.left, device=DEVICE)
    rs = torch.tensor(small.right, device=DEVICE)
    scfg = cfg.replace(disparity_range=64)
    mk = registry.sgbm_match(ls, rs, scfg, lean=True)
    registry.fused_bt_sgm = functools.partial(fcs.fused_bt_sgm, plain=True)
    try:
        mp = registry.sgbm_match(ls, rs, scfg, lean=True)
    finally:
        registry.fused_bt_sgm = fcs.fused_bt_sgm
    check_twins(mk, mp, "lean SGBM")

    # the two routes in turns on this card: lean, default, default, lean
    times = {"lean": [], "default": []}
    for name in ("lean", "default", "default", "lean"):
        pipes[name].process(left, right)
        times[name] += gpu_times(lambda: pipes[name].process(left, right), 5)
    for name, ts in times.items():
        print(f"timing [{card}]: SGBM window-1 frame, {name} route (raw u8 "
              f"-> rectify -> SGBM {cfg.disparity_range}d 8 paths -> depth, "
              f"cloud) {statistics.median(ts):.3f} ms/frame (median of "
              f"{len(ts)}, {min(ts):.3f}-{max(ts):.3f}), peak device memory "
              f"{peaks[name]:.2f} GiB at {W_SGBM}x{H_SGBM}", flush=True)
    return pipes, left, right


def phase_direct(card):
    """``bench.py:sgm_direct_2448``'s chain (``bench.sgm_direct``), once."""
    from i3dr_stereo_tpu_torch.bench import sgm_direct
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene

    sc = layered_scene(H_FULL, W_FULL, **SCENE)
    l = torch.tensor(sc.left, device=DEVICE)[None]
    r = torch.tensor(sc.right, device=DEVICE)[None]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, ms = timed(lambda: sgm_direct(l, r, 256))
    ok = out != -10000.0
    check(tuple(out.shape) == (1, H_FULL, W_FULL)
          and bool(torch.isfinite(out).all()), "direct chain: not finite")
    v = ok[0].cpu().numpy()
    both = v & sc.valid
    med = float(np.median(np.abs(out[0].cpu().numpy() - sc.disparity)[both]))
    print(f"direct 256-disparity chain [{card}] at {W_FULL}x{H_FULL}: finite, "
          f"density {v.mean():.4f}, median |d - GT| {med:.4f} px, {ms:.1f} ms "
          f"(one call), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

# ---------------------------------------------------------------------------
# phase 13: the post-match kernels against their plain twins
# ---------------------------------------------------------------------------

def gauss_ops(gi, n_holes, n_directions=32, max_radius=64) -> int:
    """The doubling's operations where this input needs them: in its holes
    alone (a valid pixel's state (d, 0) is never replaced, so it needs no
    work). A round that moves is a shifted read of two planes (two
    selects), an add, a compare and two selects; a direction adds ~12
    (initial state, hit, weight, three sums)."""
    moving = sum(1 for dirs in gi.ray_offsets(n_directions, max_radius)
                 for o in dirs if o != (0, 0))
    return n_holes * (6 * moving + 12 * n_directions)


def phase_postmatch(stats, card):
    """``gauss_rays`` and ``wls_lines`` against their twins: the Gauss fill
    on level 0's disparities and valid mask of the flagship frame (its own
    holes), masks bit-equal (the ray counts decide them: min_elements 1, 5
    and 32 below) and values bit-equal or within 1e-6 relative (exp), then
    ragged and edge cases; the line solve of both WLS passes at 2448x2048
    and 1280x1024 on that frame's guide, data and mask, bit-equal, one
    line alone for the chain's latency, and the whole WLS fill."""
    from i3dr_stereo_tpu_torch.config import params
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.matchers.pyramid import pyramid_sgm_match
    from i3dr_stereo_tpu_torch.ops import gauss_interp as gi
    from i3dr_stereo_tpu_torch.ops import wls

    dev = torch.device(DEVICE)
    cfg = flagship_cfg(params)
    sc = layered_scene(H_FULL, W_FULL, **SCENE)
    l = torch.tensor(sc.left, device=dev)[None]
    r = torch.tensor(sc.right, device=dev)[None]
    res = pyramid_sgm_match(l, r, cfg)
    d, v = res.disparity.contiguous(), res.valid.contiguous()
    holes = int((~v).sum())

    def compare_gauss(d, v, label, **kw):
        k = gi.gauss_interpolate(d, v, **kw)
        p = gi.gauss_interpolate(d, v, plain=True, **kw)
        torch.cuda.synchronize()
        check(torch.equal(k[1], p[1]), f"gauss_rays {label}: the valid "
              f"mask differs from the twin")
        diff = (k[0] - p[0]).abs()
        rel = (diff / p[0].abs().clamp(min=1e-30)).max().item()
        check(bool(torch.isfinite(k[0]).all()),
              f"gauss_rays {label}: non-finite values")
        check(rel <= 1e-6, f"gauss_rays {label}: values {rel} relative "
              f"from the twin")
        stats["gauss_rays"]["err"] = max(stats["gauss_rays"]["err"],
                                         diff.max().item())
        return k, int((diff > 0).sum())

    st = stats["gauss_rays"]
    (out, nv), n_diff = compare_gauss(d, v, "level 0")
    st["ms"] = gpu_ms(lambda: gi.gauss_interpolate(d, v))
    st["back_to_back_ms"] = back_to_back_ms(
        lambda: gi.gauss_interpolate(d, v), iters=10)
    st["plain_ms"] = gpu_ms(lambda: gi.gauss_interpolate(d, v, plain=True),
                            iters=1, warmup=0)
    # disparity and mask in, values and mask out; the doubling's operations
    # in the holes
    set_bound(stats, "gauss_rays", 10 * d.numel(), gauss_ops(gi, holes))
    print(f"gauss_rays level 0 ({W_FULL}x{H_FULL}, {holes} holes, 32 "
          f"directions, radius 64) [{card}]: masks bit-equal, "
          f"{n_diff} values differ from the twin (max "
          f"{st['err']:.3g} px); {st['ms']:.4f} ms by events around one "
          f"call, {st['back_to_back_ms']:.4f} ms a call back to back "
          f"(bound {st['bound_ms']:.4f} ms by {st['bound_by']}; the "
          f"doubling's {st['bound_ops']} operations in the holes "
          f"{st['bound_ops_ms']:.4f} ms; plain "
          f"{st['plain_ms']:.2f} ms; no PyTorch call computes it); "
          f"density {v.float().mean().item():.4f} -> "
          f"{nv.float().mean().item():.4f}", flush=True)
    rng = np.random.default_rng(13)
    n_cases = 0
    for (B, H, W), hole, kw in (
            ((2, 45, 131), 0.6, {}), ((1, 64, 96), 0.5, dict(min_elements=5)),
            ((1, 64, 96), 0.5, dict(min_elements=32)),
            ((1, 40, 50), 0.9, dict(n_directions=16, max_radius=40)),
            ((1, 33, 70), 0.7, dict(sigma=0.05)),
            ((1, 48, 300), 0.97, dict(max_radius=33)),
            ((1, 20, 24), 0.5, dict(n_directions=8)),
            ((1, 16, 16), 1.0, {}), ((1, 16, 16), 0.0, {})):
        dd = torch.tensor(rng.uniform(0, 60, (B, H, W)), dtype=torch.float32,
                          device=dev)
        vv = torch.tensor(rng.random((B, H, W)) >= hole, device=dev)
        compare_gauss(dd, vv, f"{B}x{H}x{W} holes {hole} {kw}", **kw)
        n_cases += 1
    one = gi.gauss_interpolate(d[0], v[0])
    check(torch.equal(one[0], out[0]) and torch.equal(one[1], nv[0]),
          "gauss_rays: an (H, W) frame differs from the batch")
    # the kernel is built for 6 rounds alone: another radius raises
    for radius in (32, 65):
        try:
            gi.gauss_interpolate(d, v, max_radius=radius)
            check(False, f"gauss_rays: max_radius {radius} did not raise")
        except ValueError:
            pass
    print(f"gauss_rays at {n_cases} more shapes (B = 2, ragged, "
          f"min_elements 5 and 32, 16 directions radius 40, weights that "
          f"underflow, radius 33, 8 directions, all holes, no hole): masks "
          f"bit-equal, values within 1e-6 relative; max_radius 32 and 65 "
          f"raise", flush=True)

    st = stats["wls_lines"]
    lam = 1.5 * 8000.0 * 4.0 ** 2 / (4.0 ** 3 - 1.0)    # the first pass's
    for H, W in ((H_FULL, W_FULL), (H_SGBM, W_SGBM)):
        if H == H_FULL:
            g, dd, a = l, d, v.float()
        else:
            g, dd, a = (torch.nn.functional.interpolate(x[None], size=(H, W))
                        [0].contiguous() for x in (l, d, v.float()))
        gn = wls.div_const(g, 255.0)
        for vertical in (False, True):
            w = wls._edge_weights(gn, 0.15, -2 if vertical else -1)
            w = w.contiguous()
            k = wls.thomas_lines(a, w, dd, lam, vertical=vertical)
            p = wls.thomas_lines(a, w, dd, lam, vertical=vertical, plain=True)
            torch.cuda.synchronize()
            label = (f"wls_lines {'vertical' if vertical else 'horizontal'} "
                     f"{W}x{H}")
            check(bool(torch.isfinite(k).all()), f"{label}: non-finite")
            check(torch.equal(k, p), f"{label}: differs from the twin (max "
                  f"{(k - p).abs().max().item()})")
            ms = gpu_ms(lambda: wls.thomas_lines(a, w, dd, lam,
                                                 vertical=vertical))
            b2b = back_to_back_ms(lambda: wls.thomas_lines(
                a, w, dd, lam, vertical=vertical), iters=10)
            plain_ms = gpu_ms(lambda: wls.thomas_lines(
                a, w, dd, lam, vertical=vertical, plain=True), iters=1,
                warmup=0)
            n = dd.numel()
            print(f"{label} [{card}]: bit-equal, {ms:.4f} ms by events "
                  f"around one call, {b2b:.4f} ms back to back (bytes bound "
                  f"{16 * n / PEAK_BYTES_S * 1e3:.4f} ms), plain "
                  f"{plain_ms:.1f} ms", flush=True)
            if H == H_FULL and not vertical:
                st["ms"], st["back_to_back_ms"] = ms, b2b
                st["plain_ms"] = plain_ms
                # a, w, d in and u out once; ~25 float ops an element (its
                # row 7, the elimination 8, the walk back 6, the back
                # substitution 4)
                set_bound(stats, "wls_lines", 16 * n, 25 * n)
            elif H == H_FULL:
                st["vertical_ms"], st["vertical_back_to_back_ms"] = ms, b2b
                st["vertical_plain_ms"] = plain_ms
    # every path of the kernel: a block's lines of 1, 2, 4 or 8, rows in
    # 16-byte pieces or not, blocks of lines across two planes
    rng = np.random.default_rng(17)
    shapes = ((1, 3, 1), (2, 5, 2), (1, 9, 33), (2, 12, 100), (2, 20, 12),
              (1, 4, 4095), (1, 33, 130), (1, 576, 576))
    for B, H, W in shapes:
        ra = torch.tensor(rng.random((B, H, W)) > 0.3, device=dev).float()
        rd = torch.tensor(rng.uniform(0, 30, (B, H, W)), device=dev).float()
        for vertical in (False, True):
            rw = torch.tensor(rng.random((B, H - 1, W) if vertical else
                                         (B, H, W - 1)), device=dev).float()
            if W == 130:   # rows off 16-byte alignment: a view one in
                ra, rd = (torch.cat([x.flatten(), x.new_zeros(1)])[1:]
                          .view(B, H, W) for x in (ra, rd))
            k = wls.thomas_lines(ra, rw, rd, lam, vertical=vertical)
            p = wls.thomas_lines(ra, rw, rd, lam, vertical=vertical,
                                 plain=True)
            torch.cuda.synchronize()
            check(torch.equal(k, p), f"wls_lines {B}x{H}x{W} "
                  f"{'vertical' if vertical else 'horizontal'}: differs "
                  f"from the twin")
    print(f"wls_lines at {len(shapes)} more shapes ({shapes}), both passes: "
          f"bit-equal", flush=True)
    # the chain: one line alone, 32 segments, ~N / 32 dependent steps each
    for N in (W_FULL, H_FULL):
        one_a = torch.rand((1, 1, N), device=dev)
        one_w = torch.rand((1, 1, N - 1), device=dev)
        ms = gpu_ms(lambda: wls.thomas_lines(one_a, one_w, one_a, lam))
        st[f"chain_{N}_ms"] = ms
        print(f"wls_lines one line of {N} [{card}]: {ms:.4f} ms by events "
              f"({ms / N * 1e6:.1f} ns a step, the chain bound of a pass "
              f"of {N})", flush=True)
    fill_ms = gpu_ms(lambda: wls.wls_fill(d, v, l))
    fd, fv = wls.wls_fill(d, v, l)
    check(bool(torch.isfinite(fd).all() and fv.all()),
          "wls_fill at level 0: non-finite values")
    st["wls_fill_ms"] = fill_ms
    print(f"wls_fill (6 wls_lines launches) at {W_FULL}x{H_FULL} [{card}]: "
          f"{fill_ms:.3f} ms by events", flush=True)


# ---------------------------------------------------------------------------
# phase 14: the I3DRSGM facade at its shipped profiles
# ---------------------------------------------------------------------------

FACADE_KERNELS = ("census_transform", "census_cost", "sgm_sweep",
                  "sgm_sweep_wta", "row_gather", "speckle_ccl", "gauss_rays")


def phase_facade(stats, card):
    """``I3DRSGM(device="cuda").match`` on the flagship scene (rectified
    float32 images) with ``quick_profile()`` and ``subpix_profile()``:
    every kernel of the path launches, the accuracy gate, ms/frame, the
    profile window, peak memory, ``backward_match`` once; the kernels
    against the twins (``enableCPU(True)``) at 256x320."""
    from i3dr_stereo_tpu_torch import _build
    from i3dr_stereo_tpu_torch.config.profile import (quick_profile,
                                                      subpix_profile)
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.matchers.i3drsgm import I3DRSGM

    sc = layered_scene(H_FULL, W_FULL, **SCENE)
    l = torch.tensor(sc.left, device=DEVICE)
    r = torch.tensor(sc.right, device=DEVICE)
    small = layered_scene(256, 320, max_disp=40, seed=2)
    ls = torch.tensor(small.left, device=DEVICE)
    rs = torch.tensor(small.right, device=DEVICE)

    def accuracy(res, label):
        dd, vv = res.disparity.cpu().numpy(), res.valid.cpu().numpy()
        check(dd.shape == (H_FULL, W_FULL) and bool(np.isfinite(dd[vv]).all()),
              f"{label}: disparities not finite at full shape")
        both = vv & sc.valid
        return float(vv.mean()), float(np.median(np.abs(dd - sc.disparity)
                                                 [both]))

    for name, make in (("quick", quick_profile), ("subpix", subpix_profile)):
        label = f"facade {name}_profile"
        facade = I3DRSGM(profile=make(), device=DEVICE)
        if name == "subpix":
            # as shipped: a top prediction shift of +8 at level 5 (+256 px
            # at full resolution), above every disparity of this scene
            # (16-200 px); reported, not gated
            density, med = accuracy(facade.match(l, r), label)
            print(f"{label} as shipped (top shift +8) at {W_FULL}x{H_FULL}: "
                  f"density {density:.4f}, median |d - GT| {med:.4f} px "
                  f"(the search window misses the scene; not gated)",
                  flush=True)
            # the coarsest shift set for the scene with the wrapper's own
            # setter: min disparity 0 -> top prediction shift 0
            facade.setMinDisparity(0.0)
            label += " with setMinDisparity(0)"
        torch.cuda.reset_peak_memory_stats()
        facade.match(l, r)
        torch.cuda.synchronize()
        _build.reset_launches()
        res = facade.match(l, r)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        print(f"{label} launches at {W_FULL}x{H_FULL}: {launches}",
              flush=True)
        for k in FACADE_KERNELS:
            check(launches[k] > 0, f"kernel {k} did not launch on the "
                  f"{label} frame")
        if name == "quick":
            stats["gauss_rays"]["launches"] = launches["gauss_rays"]
        density, med = accuracy(res, label)
        print(f"{label} accuracy: density {density:.4f}, median |d - GT| "
              f"{med:.4f} px", flush=True)
        check(density > 0.5, f"{label}: density {density} too low")
        check(med < MAX_MEDIAN_ERR, f"{label}: median error {med}")
        frame_ms = gpu_ms(lambda: facade.match(l, r), iters=10, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"timing [{card}]: {label} (rectified float32 in, "
              f"{len(facade.profile.enabled_levels)} passes) {frame_ms:.3f} "
              f"ms/frame ({1000 / frame_ms:.2f} FPS), peak device memory "
              f"{peak:.2f} GiB at {W_FULL}x{H_FULL}", flush=True)
        # phase_profile drives ``process``: one facade match a frame
        phase_profile(SimpleNamespace(process=facade.match), l, r, card,
                      label=label)
        bwd = facade.backward_match(l, r)
        torch.cuda.synchronize()
        bd = bwd.disparity[bwd.valid]
        check(tuple(bwd.disparity.shape) == (H_FULL, W_FULL)
              and bool(torch.isfinite(bd).all()) and bwd.valid.any(),
              f"{label}: backward_match not finite")
        print(f"{label} backward_match: finite, density "
              f"{bwd.valid.float().mean().item():.4f}", flush=True)
        twin = I3DRSGM(profile=facade.profile, device=DEVICE)
        twin.enableCPU(True)
        check_twins(facade.match(ls, rs), twin.match(ls, rs), label)


# ---------------------------------------------------------------------------
# phase 15: the flagship frame with hole filling and occlusion handling
# ---------------------------------------------------------------------------

def phase_interp(stats, card):
    """``StereoPipeline`` at the flagship config with ``interp`` (the WLS
    fill at level 0), occlusion detection and fill; then with
    ``interpolate_missing`` alone (the Gauss fill through the flat
    config); SGBM at 1280x1024x128 with ``interp`` (``wls_fill_lr``)
    once. The first is also held against the twins at 256x320."""
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.matchers.pyramid import pyramid_sgm_match

    pipe, left, right, sc, cfg, _ = flagship_pipe()
    pipe.update_config(interp=True, occlusion_detection=True,
                       occlusion_interp=True)
    label = "flagship frame with interp + occlusion"
    torch.cuda.reset_peak_memory_stats()
    drive_frame(pipe, left, right, sc, FLAGSHIP_KERNELS + ("wls_lines",),
                label, stats, record=("wls_lines",))
    frame_ms = gpu_ms(lambda: pipe.process(left, right), iters=10, warmup=1)
    print(f"timing [{card}]: {label} {frame_ms:.3f} ms/frame "
          f"({1000 / frame_ms:.2f} FPS), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB at "
          f"{W_FULL}x{H_FULL}", flush=True)
    phase_profile(pipe, left, right, card, label=label)
    small = layered_scene(256, 320, max_disp=40, seed=2)
    ls = torch.tensor(small.left, device=DEVICE)
    rs = torch.tensor(small.right, device=DEVICE)
    check_twins(pyramid_sgm_match(ls, rs, pipe.config),
                pyramid_sgm_match(ls, rs, pipe.config, plain=True), label)

    pipe.update_config(interp=False, occlusion_detection=False,
                       occlusion_interp=False, interpolate_missing=True)
    label = "flagship frame with interpolate_missing (Gauss)"
    torch.cuda.reset_peak_memory_stats()
    drive_frame(pipe, left, right, sc, FLAGSHIP_KERNELS + ("gauss_rays",),
                label, stats)
    frame_ms = gpu_ms(lambda: pipe.process(left, right), iters=10, warmup=1)
    print(f"timing [{card}]: {label} {frame_ms:.3f} ms/frame, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    phase_profile(pipe, left, right, card, label=label)
    del pipe

    spipe, sl, sr, ssc, scfg, _ = sgbm_pipe()
    spipe.update_config(interp=True)
    label = "SGBM frame with interp (wls_fill_lr)"
    torch.cuda.reset_peak_memory_stats()
    drive_frame(spipe, sl, sr, ssc, SGBM_KERNELS + ("wls_lines",), label,
                stats)
    ms = gpu_ms(lambda: spipe.process(sl, sr), iters=3, warmup=0)
    print(f"timing [{card}]: {label} {ms:.3f} ms/frame, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB at "
          f"{W_SGBM}x{H_SGBM}", flush=True)



# ---------------------------------------------------------------------------
# phase 16: belief propagation (BP, CSBP) and the downsampled SGBM frame
# ---------------------------------------------------------------------------

# the gates every backend meets in the reference's tests/test_matchers.py
BP_MAX_MEDIAN_ERR = 0.5
DOWNSAMPLED_MAX_MEDIAN_ERR = 1.0   # its test_downsample_scale
BP_KERNELS = ("remap", "bp_messages")
CSBP_KERNELS = ("remap", "bp_messages", "bp_planes", "speckle_ccl")


def dt_cummin(h, jump, max_disc):
    """The distance transform of ``bp_messages`` written with
    ``torch.cummin`` over d (a yardstick: it rounds otherwise, each
    candidate's ``jump * |d - d'|`` added once)."""
    D = h.shape[-3]
    ramp = jump * torch.arange(D, device=h.device, dtype=h.dtype)[:, None,
                                                                   None]
    f = torch.cummin(h - ramp, dim=-3).values + ramp
    b = torch.cummin((f + ramp).flip(-3), dim=-3).values.flip(-3) - ramp
    return torch.minimum(b, h.amin(-3, keepdim=True) + max_disc)


def bp_iterate_cummin(data, msgs, jump, max_disc):
    """One message update with ``dt_cummin`` and ``torch.mean``."""
    from i3dr_stereo_tpu_torch.matchers import bp

    out = dt_cummin(bp._excluding(data, bp._incoming(msgs)), jump, max_disc)
    return out - out.mean(2, keepdim=True)


def compare_bp(bp, data, msgs, iters, label, dvals=None):
    """The kernel against its twin: bit-equal messages (torch.equal). The
    twin runs first: the kernel consumes ``msgs``."""
    if dvals is None:
        p = bp.bp_iterate(data, msgs, iters, 1.0, 1.7, plain=True)
        k = bp.bp_iterate(data, msgs, iters, 1.0, 1.7)
        name = "bp_messages"
    else:
        p = bp.bp_iterate_planes(data, dvals, msgs, iters, 1.0, 1.7,
                                 plain=True)
        k = bp.bp_iterate_planes(data, dvals, msgs, iters, 1.0, 1.7)
        name = "bp_planes"
    torch.cuda.synchronize()
    check(bool(torch.isfinite(k).all()), f"{name} {label}: not finite")
    check(torch.equal(k, p), f"{name} {label}: differs from the twin (max "
          f"{(k - p).abs().max().item():.3g})")
    return k


def compare_bp_slabs(bp, data, msgs, rows, label):
    """One iteration of the kernel against its twin computed in slabs of
    ``rows`` rows with one row of halo above and below, bit-equal (a
    pixel's new message reads only its own data and its four neighbours'
    messages, so a slab's own rows are exact). ``msgs`` is kept."""
    k = bp.bp_iterate(data, msgs, 1, 1.0, 1.7)
    H = data.shape[-2]
    for y0 in range(0, H, rows):
        y1 = min(y0 + rows, H)
        lo, hi = max(y0 - 1, 0), min(y1 + 1, H)
        p = bp.bp_iterate_plain(data[..., lo:hi, :].contiguous(),
                                msgs[..., lo:hi, :].contiguous(), 1, 1.0,
                                1.7)[..., y0 - lo:y1 - lo, :]
        got = k[..., y0:y1, :]
        check(bool(torch.isfinite(got).all()),
              f"bp_messages {label}: not finite")
        check(torch.equal(got, p), f"bp_messages {label}: rows {y0}-{y1} "
              f"differ from the twin (max {(got - p).abs().max().item():.3g})")
    return k


def phase_bp_staged(stats, card, dev, gen):
    """The staged ``bp_messages`` at the shapes ``bp_1920`` gives it
    (1920x1080, 480 disparities from 0, the sum-pooled pyramid): level 1
    in full for 5 iterations and level 0 for one iteration, against the
    twin, then level 0 timed by events and back to back beside its
    bound."""
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.matchers import bp

    D, H, W = 480, 1080, 1920
    check(bp.messages_shared(D) == 0, f"bp_messages: D = {D} runs the "
          f"strip kernel ({bp.messages_shared(D)} bytes), not the staged one")
    st = stats["bp_messages"]
    sc = layered_scene(H, W, max_disp=460, background_disp=160, layers=6,
                       seed=23)
    l = torch.tensor(sc.left, device=dev)[None]
    r = torch.tensor(sc.right, device=dev)[None]
    d0 = bp.data_cost(l, r, 0, D)
    d1 = bp._pool2(d0)
    m1 = 0.3 * torch.randn((4,) + d1.shape, device=dev, generator=gen)
    compare_bp(bp, d1, m1, 5, f"level 1 {tuple(d1.shape)}, 5 iterations")
    del d1, m1
    torch.cuda.empty_cache()
    m0 = 0.3 * torch.randn((4,) + d0.shape, device=dev, generator=gen)
    compare_bp_slabs(bp, d0, m0, 64, f"level 0 {tuple(d0.shape)}, one "
                     f"iteration")
    torch.cuda.empty_cache()
    # one iteration leaves m0 as it was
    st["staged_ms"] = gpu_ms(lambda: bp.bp_iterate(d0, m0, 1, 1.0, 1.7),
                             iters=5, warmup=1)
    st["staged_back_to_back_ms"] = back_to_back_ms(
        lambda: bp.bp_iterate(d0, m0, 1, 1.0, 1.7), iters=5, warmup=1)
    # as set_bound counts the strip kernel's: 9 volumes, 30 operations
    n = d0.numel()
    st["staged_bound_ms"] = max(9 * n * 4 / PEAK_BYTES_S,
                                30 * n / PEAK_OPS_S) * 1e3
    print(f"bp_messages staged in device memory at bp_1920's shapes "
          f"[{card}]: bit-equal at level 1 {(1, D, H // 2, W // 2)} (5 "
          f"iterations, whole) and level 0 {tuple(d0.shape)} (one "
          f"iteration, the twin in 64-row slabs with a one-row halo); level "
          f"0 {st['staged_ms']:.3f} ms by events, "
          f"{st['staged_back_to_back_ms']:.3f} ms back to back (bound "
          f"{st['staged_bound_ms']:.3f} ms by bytes: "
          f"{st['staged_bound_ms'] / st['staged_ms']:.1%} of it by events, "
          f"{st['staged_bound_ms'] / st['staged_back_to_back_ms']:.1%} back "
          f"to back)", flush=True)
    del d0, m0
    torch.cuda.empty_cache()


def bp_pipe(alg):
    """The SGBM frame's scene and rig (raw uint8, rectified) with the BP
    or CSBP defaults at 128 disparities."""
    from i3dr_stereo_tpu_torch.config import params

    pipe, left, right, sc, _, _ = sgbm_pipe()
    pipe.config = cfg = params.ALGORITHM_DEFAULTS[alg].replace(
        disparity_range=128)
    return pipe, left, right, sc, cfg


def phase_bp(stats, card):
    """``bp_messages`` and ``bp_planes`` against their twins, then the BP
    and CSBP frames and the downsampled SGBM frame."""
    from i3dr_stereo_tpu_torch import _build
    from i3dr_stereo_tpu_torch.config import params
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.matchers import base, bp

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(12)
    sc = layered_scene(H_SGBM, W_SGBM, **SGBM_SCENE)
    l = torch.tensor(sc.left, device=dev)[None]
    r = torch.tensor(sc.right, device=dev)[None]

    # --- bp_messages: level 0 of the BP frame, one iteration ---------------
    st = stats["bp_messages"]
    data = bp.data_cost(l, r, 0, 128)
    msgs = 0.3 * torch.randn((4,) + data.shape, device=dev, generator=gen)
    k = compare_bp(bp, data, msgs, 1, "1x1024x1280x128, one iteration")
    st["ms"] = gpu_ms(lambda: bp.bp_iterate(data, msgs, 1, 1.0, 1.7),
                      iters=5)
    st["back_to_back_ms"] = back_to_back_ms(
        lambda: bp.bp_iterate(data, msgs, 1, 1.0, 1.7), iters=10, warmup=2)
    st["plain_ms"] = gpu_ms(
        lambda: bp.bp_iterate(data, msgs, 1, 1.0, 1.7, plain=True), iters=1,
        warmup=0)
    st["cummin_ms"] = gpu_ms(lambda: bp_iterate_cummin(data, msgs, 1.0, 1.7),
                             iters=5)
    st["cummin_max_abs_err"] = (bp_iterate_cummin(data, msgs, 1.0, 1.7)
                                - k).abs().max().item()
    # data and 4 message planes read, 4 written; ~30 operations a pixel
    # and disparity
    set_bound(stats, "bp_messages", 9 * data.numel() * 4,
              30 * data.numel())
    print(f"bp_messages 1x{H_SGBM}x{W_SGBM}x128, one iteration [{card}]: "
          f"bit-equal (32-pixel strips, {bp.messages_shared(128)} bytes of "
          f"dynamic shared memory a block); {st['ms']:.4f} ms by events, "
          f"{st['back_to_back_ms']:.4f} ms back to back (bound "
          f"{st['bound_ms']:.4f} ms by {st['bound_by']}: "
          f"{st['bound_ms'] / st['ms']:.0%} of it by events, "
          f"{st['bound_ms'] / st['back_to_back_ms']:.0%} back to back; plain "
          f"{st['plain_ms']:.2f} ms; the torch.cummin form "
          f"{st['cummin_ms']:.3f} ms, max |diff| "
          f"{st['cummin_max_abs_err']:.3g}; no PyTorch call computes it)",
          flush=True)
    del k
    # five iterations at level 2's shape
    d2 = bp._pool2(bp._pool2(data))
    m2 = 0.3 * torch.randn((4,) + d2.shape, device=dev, generator=gen)
    compare_bp(bp, d2, m2, 5, f"{tuple(d2.shape)}, 5 iterations")
    ms5 = gpu_ms(lambda: bp.bp_iterate(d2, m2, 5, 1.0, 1.7), iters=5)
    print(f"bp_messages 5 iterations at level 2 {tuple(d2.shape)} [{card}]: "
          f"bit-equal, {ms5:.4f} ms", flush=True)
    del data, msgs
    # both kernels messages_shared picks, on both sides of its cut (the
    # strip kernel to D = 446, then the staging in device memory); D below
    # and above the copies' 16 ahead; W no multiple of the strip, W = 1,
    # H = 1, B = 2
    ragged = ((2, 4, 37, 131), (1, 16, 9, 33), (2, 17, 23, 45),
              (1, 64, 31, 129), (1, 256, 7, 131), (1, 1, 5, 5),
              (1, 3, 1, 300), (2, 446, 3, 37), (1, 447, 3, 45),
              (2, 901, 2, 17), (1, 1300, 1, 3), (2, 8, 5, 1), (1, 5, 1, 1))
    by_kernel = {}
    for shape in ragged:
        dd = torch.rand(shape, device=dev, generator=gen) * 0.7
        mm = 0.3 * torch.randn((4,) + shape, device=dev, generator=gen)
        compare_bp(bp, dd, mm, 3, f"{shape}")
        kernel = "strip" if bp.messages_shared(shape[1]) else "staged"
        by_kernel.setdefault(kernel, []).append(shape)
    check(len(by_kernel) == 2, f"bp_messages: the ragged shapes ran "
          f"{len(by_kernel)} of its 2 kernels")
    print(f"bp_messages 3 iterations at {len(ragged)} ragged shapes: "
          f"bit-equal; 32-pixel strips at {by_kernel['strip']}; staged in "
          f"device memory at {by_kernel['staged']}", flush=True)
    phase_bp_staged(stats, card, dev, gen)

    # --- bp_planes: K = 4 at 1x1024x1280, then ragged -----------------------
    st = stats["bp_planes"]
    K = 4
    dk = torch.rand((1, K, H_SGBM, W_SGBM), device=dev, generator=gen) * 0.7
    dv = torch.randint(0, 128, dk.shape, device=dev, generator=gen).float()
    mk = 0.3 * torch.randn((4,) + dk.shape, device=dev, generator=gen)
    compare_bp(bp, dk, mk, 1, f"1x{K}x{H_SGBM}x{W_SGBM}", dvals=dv)
    st["ms"] = gpu_ms(lambda: bp.bp_iterate_planes(dk, dv, mk, 1, 1.0, 1.7))
    st["back_to_back_ms"] = back_to_back_ms(
        lambda: bp.bp_iterate_planes(dk, dv, mk, 1, 1.0, 1.7), iters=20)
    st["plain_ms"] = gpu_ms(
        lambda: bp.bp_iterate_planes(dk, dv, mk, 1, 1.0, 1.7, plain=True),
        iters=1, warmup=0)
    # data and candidates, 4 message planes in, 4 out; per pixel and
    # direction K^2 (sub, abs, mul, min, add, min) and the mean
    set_bound(stats, "bp_planes", 10 * dk.numel() * 4,
              4 * 6 * K * dk.numel())
    print(f"bp_planes 1x{K}x{H_SGBM}x{W_SGBM} [{card}]: bit-equal; "
          f"{st['ms']:.4f} ms by events, {st['back_to_back_ms']:.4f} ms "
          f"back to back (bound {st['bound_ms']:.4f} ms by "
          f"{st['bound_by']}; plain {st['plain_ms']:.2f} ms; no PyTorch "
          f"call computes it)", flush=True)
    ragged = ((2, 2, 37, 131), (1, 3, 9, 33), (1, 7, 23, 45),
              (1, 16, 31, 129), (2, 4, 1, 300), (1, 1, 4, 4))
    for shape in ragged:
        dd = torch.rand(shape, device=dev, generator=gen) * 0.7
        vv = torch.randint(0, 300, shape, device=dev, generator=gen).float()
        mm = 0.3 * torch.randn((4,) + shape, device=dev, generator=gen)
        compare_bp(bp, dd, mm, 3, f"{shape}", dvals=vv)
    print(f"bp_planes 3 iterations at {len(ragged)} ragged shapes {ragged}: "
          f"bit-equal", flush=True)
    del dk, dv, mk
    torch.cuda.empty_cache()

    # --- the BP and CSBP frames -------------------------------------------
    small = layered_scene(256, 320, max_disp=40, seed=2)
    ls = torch.tensor(small.left, device=dev)
    rs = torch.tensor(small.right, device=dev)
    for alg, kernels in ((params.Algorithm.BP_GPU, BP_KERNELS),
                         (params.Algorithm.CSBP_GPU, CSBP_KERNELS)):
        pipe, left, right, psc, cfg = bp_pipe(alg)
        label = f"{alg.name} frame"
        torch.cuda.reset_peak_memory_stats()
        res = drive_frame(pipe, left, right, psc, kernels, label, stats,
                          max_med=BP_MAX_MEDIAN_ERR)
        if alg == params.Algorithm.BP_GPU:
            stats["bp_messages"]["launches"] = _build.LAUNCHES["bp_messages"]
        else:
            stats["bp_planes"]["launches"] = _build.LAUNCHES["bp_planes"]
        frame_ms = gpu_ms(lambda: pipe.process(left, right), iters=5,
                          warmup=0)
        m = base.create_matcher(cfg, device=DEVICE)
        rl, rr = res.rect_left, res.rect_right
        match_ms = gpu_ms(lambda: m.match(rl, rr), iters=5, warmup=0)
        mres = m.match(rl, rr)
        # the pipeline's mask is the matcher's less its depth-range clamp
        check(torch.equal(mres.disparity, res.disparity)
              and not bool((res.valid & ~mres.valid).any()),
              f"{label}: create_matcher().match differs from the pipeline")
        print(f"timing [{card}]: {label} (raw u8 -> rectify -> "
              f"{alg.name} {cfg.disparity_range}d, {cfg.bp_levels} levels x "
              f"{cfg.bp_iters} iterations -> depth, cloud) {frame_ms:.3f} "
              f"ms/frame, create_matcher().match {match_ms:.3f} ms (equal "
              f"to the pipeline's), peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB at "
              f"{W_SGBM}x{H_SGBM}", flush=True)
        phase_profile(pipe, left, right, card, label=label)
        scfg = cfg.replace(disparity_range=64)
        check_twins(
            bp.belief_propagation_match(
                ls, rs, scfg, constant_space=alg == params.Algorithm.CSBP_GPU),
            bp.belief_propagation_match(
                ls, rs, scfg, constant_space=alg == params.Algorithm.CSBP_GPU,
                plain=True), label)
        del pipe, res, m, mres
        torch.cuda.empty_cache()

    # --- the downsampled SGBM frame ---------------------------------------
    cfg = sgbm_cfg(params).replace(downsample_scale=0.5)
    m = base.create_matcher(cfg, device=DEVICE)
    lf, rf = l[0], r[0]
    res = m.match(lf, rf)
    torch.cuda.synchronize()
    d, v = res.disparity.cpu().numpy(), res.valid.cpu().numpy()
    check(d.shape == (H_SGBM, W_SGBM) and v.shape == d.shape,
          f"downsampled SGBM: output shape {d.shape}")
    check(bool(np.isfinite(d[v]).all()), "downsampled SGBM: not finite")
    both = v & sc.valid
    density = float(v.mean())
    med = float(np.median(np.abs(d - sc.disparity)[both]))
    ms = gpu_ms(lambda: m.match(lf, rf), iters=5, warmup=0)
    full_ms = gpu_ms(lambda: base.create_matcher(
        sgbm_cfg(params), device=DEVICE).match(lf, rf), iters=5, warmup=1)
    print(f"downsampled SGBM frame (downsample_scale 0.5, "
          f"create_matcher().match, {W_SGBM}x{H_SGBM} in and out) [{card}]: "
          f"density {density:.4f}, median |d - GT| {med:.4f} px, {ms:.3f} "
          f"ms (full resolution {full_ms:.3f} ms)", flush=True)
    check(density > 0.5, f"downsampled SGBM: density {density}")
    check(med < DOWNSAMPLED_MAX_MEDIAN_ERR,
          f"downsampled SGBM: median error {med}")


# ---------------------------------------------------------------------------
# phase 17: the shell around the pipeline (node graph, runner, CLI)
# ---------------------------------------------------------------------------

SHELL_FRAMES = 6          # the live graph's synthetic frames
RUNNER_PAIRS = 8          # the stream runner's flagship pairs
RUNNER_SETTINGS = ((1, 0), (1, 2), (2, 2))   # (batch_size, depth)
# the modules the shell phase runs, imported where cv2 cannot be
SHELL_MODULES = (
    "i3dr_stereo_tpu_torch.bridge.graph", "i3dr_stereo_tpu_torch.bridge.nodes",
    "i3dr_stereo_tpu_torch.bridge.launch",
    "i3dr_stereo_tpu_torch.bridge.reconfigure",
    "i3dr_stereo_tpu_torch.bridge.services", "i3dr_stereo_tpu_torch.cli",
    "i3dr_stereo_tpu_torch.io.sources", "i3dr_stereo_tpu_torch.io.savers",
    "i3dr_stereo_tpu_torch.pipeline.pairing",
    "i3dr_stereo_tpu_torch.pipeline.runner",
    "i3dr_stereo_tpu_torch.utils.metrics",
    "i3dr_stereo_tpu_torch.viz.viewer", "i3dr_stereo_tpu_torch.viz.colormap",
    "i3dr_stereo_tpu_torch.native.shm", "i3dr_stereo_tpu_torch.native.gvsp",
    "i3dr_stereo_tpu_torch.bridge.drivers", "i3dr_stereo_tpu_torch.io.gige",
    "i3dr_stereo_tpu_torch.viz.serve", "i3dr_stereo_tpu_torch.dist.mesh",
    "i3dr_stereo_tpu_torch.dist.sharded",
    "i3dr_stereo_tpu_torch.dist.multihost")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def shell_no_cv2() -> None:
    """Every module of the shell phase imports in a process where
    ``import cv2`` fails."""
    code = ("import importlib, sys\n"
            "sys.modules['cv2'] = None\n"
            f"for m in {SHELL_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parent,
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0 and out.stdout.strip() == "ok",
          f"shell: a module needs cv2 at import: {out.stderr[-2000:]}")
    print(f"shell: {len(SHELL_MODULES)} modules import with cv2 blocked",
          flush=True)


def shell_live_graph(card, params, camera) -> None:
    """The live graph at full width: every published disparity and valid
    mask bit-equal to ``StereoPipeline.process`` on the same pair."""
    from i3dr_stereo_tpu_torch import _build
    from i3dr_stereo_tpu_torch.bridge.launch import (launch_stereo_camera,
                                                     run_source)
    from i3dr_stereo_tpu_torch.io.sources import SyntheticStereoSource
    from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline

    rig = camera.StereoRig.synthetic(W_FULL, H_FULL, fx=580.0,
                                     baseline_m=0.3)
    lg = launch_stereo_camera(
        rig, stereo_algorithm=params.Algorithm.I3DRSGM,
        source=SyntheticStereoSource(width=W_FULL, height=H_FULL,
                                     n_frames=SHELL_FRAMES),
        rectify_inputs=False)
    g, node = lg.graph, lg.node("generate_disparity")
    raw, pubs = {}, []
    for side, i in (("left", 0), ("right", 1)):
        g.subscribe(f"/stereo/{side}/image_raw",
                    lambda s, d, i=i: raw.setdefault(s, [None, None])
                    .__setitem__(i, d))
    g.subscribe("/stereo/disparity", lambda s, m: pubs.append((s, m)))
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    n = run_source(lg)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    print(f"shell live graph [{card}]: {n} frames of {W_FULL}x{H_FULL} in "
          f"{wall:.2f} s (scene generation and host copies included), "
          f"processed {node.frames_processed}, dropped "
          f"{node.frames_dropped}; launches {launches}", flush=True)
    check(n == SHELL_FRAMES and node.frames_processed == SHELL_FRAMES
          and node.frames_dropped == 0 and len(pubs) == SHELL_FRAMES,
          f"shell live graph: {n} frames, {node.frames_processed} "
          f"processed, {node.frames_dropped} dropped, {len(pubs)} published")
    for name in FLAGSHIP_KERNELS:
        if name != "remap":
            check(launches[name] > 0, f"shell live graph: {name} did not "
                  "launch")
    ref = StereoPipeline(rig, node.pipeline.config, node.pipeline.cloud,
                         device=DEVICE, rectify_inputs=False)
    for stamp, msg in pubs:
        want = ref.process(*raw[stamp])
        check(np.array_equal(msg["disparity"], want.disparity.cpu().numpy())
              and np.array_equal(msg["valid"], want.valid.cpu().numpy()),
              f"shell live graph: frame at {stamp} differs from process")
    print(f"shell live graph: {len(pubs)} published disparities and valid "
          f"masks bit-equal to StereoPipeline.process (density "
          f"{float(pubs[-1][1]['valid'].mean()):.4f})", flush=True)


def node_outputs(H: int, W: int) -> list:
    """The graph node's eight outputs of an H x W frame on the card, in
    its order and with its shapes and dtypes: the float32 rectified pair,
    disparity, valid, depth, the cloud's xyz, valid and grey rgb."""
    g = torch.Generator(device=DEVICE).manual_seed(H + W)

    def f32(*shape):
        return torch.rand(shape, generator=g, device=DEVICE) * 255

    def mask(*shape):
        return torch.rand(shape, generator=g, device=DEVICE) > 0.3
    return [("left/image_rect", f32(H, W)), ("right/image_rect", f32(H, W)),
            ("disparity", f32(H, W)), ("disparity", mask(H, W)),
            ("depth", f32(H, W)), ("points2", f32(H * W, 3)),
            ("points2", mask(H * W)), ("points2", f32(H * W, 3))]


def shell_node_copies(card) -> None:
    """The node's copy stage (``bridge/nodes.py:host_copies``) against
    its bound, at the flagship's and SGBM's frames: a plain copy of the
    frame's bytes from one device buffer into page-locked memory, by
    events and back to back; the stage on ready tensors by host clock
    (its enqueues and its one wait) and by events; ``to_numpy`` of the
    same tensors, the route it replaced. The stage's arrays bit-equal to
    ``.cpu()``; after its first call it allocates nothing."""
    from i3dr_stereo_tpu_torch.bridge.nodes import host_copies
    from i3dr_stereo_tpu_torch.bridge.pinned import PinnedPool, page_locked
    from i3dr_stereo_tpu_torch.core.frame import to_numpy

    for label, (H, W) in (("flagship", (H_FULL, W_FULL)),
                          ("SGBM", (1080, 1920))):
        outs = node_outputs(H, W)
        nbytes = sum(x.numel() * x.element_size() for _, x in outs)
        src = torch.empty(nbytes, dtype=torch.uint8, device=DEVICE)
        dst = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        plain = lambda: dst.copy_(src, non_blocking=True)
        bound_ms = gpu_ms(plain)
        bound_b2b_ms = back_to_back_ms(plain, iters=20)
        fresh = []

        def counting(shape, dtype):
            fresh.append(shape)
            return page_locked(shape, dtype)
        pool = PinnedPool(counting)
        arrays = host_copies(pool, outs)
        check(all(np.array_equal(a, x.cpu().numpy())
                  for a, (_, x) in zip(arrays, outs)),
              f"node copies {label}: an array differs from .cpu()")
        del arrays
        fresh.clear()
        stage_ms, pageable_ms = [], []
        for _ in range(10):
            torch.cuda.synchronize()
            t = time.perf_counter()
            arrays = host_copies(pool, outs)
            stage_ms.append((time.perf_counter() - t) * 1e3)
            del arrays
            torch.cuda.synchronize()
            t = time.perf_counter()
            arrays = [to_numpy(x) for _, x in outs]
            pageable_ms.append((time.perf_counter() - t) * 1e3)
            del arrays
        check(not fresh, f"node copies {label}: the pool allocated {fresh} "
              "after its first frame")
        stage_ev = gpu_ms(lambda: host_copies(pool, outs))
        stage, pageable = (statistics.median(stage_ms),
                           statistics.median(pageable_ms))
        print(f"shell node copies {label} [{card}]: {nbytes / 1e6:.6f} MB a "
              f"frame in 8 arrays; plain pinned copy {bound_ms:.4f} ms by "
              f"events, {bound_b2b_ms:.4f} back to back "
              f"({nbytes / bound_b2b_ms / 1e6:.2f} GB/s); the node's copy "
              f"stage {stage:.4f} ms by host clock (median of 10; "
              f"{min(stage_ms):.4f}-{max(stage_ms):.4f}), {stage_ev:.4f} by "
              f"events: {bound_b2b_ms / stage:.1%} of the bound; to_numpy "
              f"of the same tensors {pageable:.4f} ms "
              f"({min(pageable_ms):.4f}-{max(pageable_ms):.4f})", flush=True)
        del outs, src, dst, pool
        torch.cuda.empty_cache()


def shell_rectify_graph(card, params, camera, pairs) -> None:
    """The node with ``rectify=True`` and a ``RectifyNode`` on raw uint8
    frames of the distorted rig: rectified images bit-equal to
    ``rectify_pair`` / ``remap``, disparities to ``process``."""
    from i3dr_stereo_tpu_torch.bridge.launch import launch_stereo_matcher
    from i3dr_stereo_tpu_torch.ops.rectify import remap, rectify_pair
    from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline

    rig = distorted_rig(camera)
    lg = launch_stereo_matcher(rig, stereo_algorithm=params.Algorithm.I3DRSGM,
                               rectify_inputs=True,
                               with_standalone_rectify=True, warmup=False)
    g, node = lg.graph, lg.node("generate_disparity")
    got = {}
    for topic in ("/stereo/left/image_rect", "/stereo/right/image_rect",
                  "/stereo/disparity", "/stereo_no_laser/left/image_rect",
                  "/stereo_no_laser/right/image_rect"):
        g.subscribe(topic, lambda s, d, t=topic: got.setdefault(
            (t, s), d))
    ref = StereoPipeline(rig, node.pipeline.config, node.pipeline.cloud,
                         device=DEVICE)
    maps = (ref._lmap, ref._rmap)      # built apart from the nodes' maps
    for l, r in pairs:
        for ns in ("/stereo", "/stereo_no_laser"):
            g.publish(f"{ns}/left/image_raw", l.stamp, l.data)
            g.publish(f"{ns}/right/image_raw", r.stamp, r.data)
        lt, rt = (torch.tensor(x.data, device=DEVICE) for x in (l, r))
        pair = [x.cpu().numpy() for x in rectify_pair(lt, rt, *maps)]
        single = [remap(x.float(), m).cpu().numpy()
                  for x, m in zip((lt, rt), maps)]
        want = ref.process(l.data, r.data)
        for i, side in enumerate(("left", "right")):
            check(np.array_equal(got[(f"/stereo/{side}/image_rect",
                                      l.stamp)], pair[i]),
                  f"shell rectify: the node's {side} image is not "
                  "rectify_pair's")
            check(np.array_equal(got[(f"/stereo_no_laser/{side}/image_rect",
                                      l.stamp)], single[i]),
                  f"shell rectify: RectifyNode's {side} image is not "
                  "remap's")
        msg = got[("/stereo/disparity", l.stamp)]
        check(np.array_equal(msg["disparity"], want.disparity.cpu().numpy())
              and np.array_equal(msg["valid"], want.valid.cpu().numpy()),
              "shell rectify: the node's disparity is not process's")
    same = all(np.array_equal(got[(f"/stereo/{s}/image_rect", l.stamp)],
                              got[(f"/stereo_no_laser/{s}/image_rect",
                                   l.stamp)])
               for l, _ in pairs for s in ("left", "right"))
    print(f"shell rectify graph [{card}]: {len(pairs)} raw uint8 pairs of "
          f"{W_FULL}x{H_FULL} on the distorted rig: the node's rectified "
          f"images bit-equal to rectify_pair, RectifyNode's to remap of the "
          f"float32 frame, disparities and valid masks to process; the two "
          f"nodes' images {'bit-equal' if same else 'differ'}", flush=True)


def shell_runner(card, params, camera, pairs) -> None:
    """``StreamRunner`` over the flagship pairs: bit-equal to per-pair
    ``process`` at every setting; ms/frame, idle share and peak reported."""
    from torch.profiler import ProfilerActivity, profile

    from i3dr_stereo_tpu_torch.pipeline.runner import StreamRunner
    from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline

    rig = camera.StereoRig.synthetic(W_FULL, H_FULL, fx=580.0,
                                     baseline_m=0.3)
    cloud = params.PointCloudConfig(depth_max=100.0, depth_min=0.5)
    pipe = StereoPipeline(rig, flagship_cfg(params), cloud, device=DEVICE)
    want = {}
    for l, r in pairs:
        res = pipe.process(l.data, r.data)
        want[l.stamp] = (res.disparity, res.valid)
    runs = {k: [] for k in RUNNER_SETTINGS}
    split = {k: [] for k in RUNNER_SETTINGS}
    peak = {}
    # the settings in turns, forwards then backwards
    for order in (RUNNER_SETTINGS, RUNNER_SETTINGS[::-1]):
        for bs, depth in order:
            out = []
            runner = StreamRunner(pipe, batch_size=bs)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            stats = runner.run(pairs, lambda st, c, res: out.append(
                (st, c, res.disparity, res.valid)), depth=depth)
            runs[(bs, depth)].append(
                (time.perf_counter() - t0) * 1e3 / len(pairs))
            peak[(bs, depth)] = torch.cuda.max_memory_allocated() / 2**30
            st_ms = runner.metrics.summary()["stages"]
            split[(bs, depth)].append(tuple(
                st_ms[k]["mean_ms"] * st_ms[k]["count"] / len(pairs)
                for k in ("dispatch", "drain")))
            check(stats.frames_in == stats.frames_out == len(pairs),
                  f"shell runner: {stats}")
            for st, c, d, v in out:
                for j in range(c):
                    wd, wv = want[st[j]]
                    check(torch.equal(d[j], wd) and torch.equal(v[j], wv),
                          f"shell runner batch {bs} depth {depth}: frame "
                          f"at {st[j]} differs from process")
            del out
    ms = {}
    for bs, depth in RUNNER_SETTINGS:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            StreamRunner(pipe, batch_size=bs).run(
                pairs, lambda *a: None, depth=depth)
            wall = (time.perf_counter() - t0) * 1e3
        spans = trace.read(prof, len(pairs)).device
        check(len(spans) > 0, "the profiler recorded no device activity")
        busy = trace.length(trace.union((s, e) for s, e, _ in spans)) / 1e3
        r = runs[(bs, depth)]
        ms[(bs, depth)] = statistics.median(r)
        print(f"shell runner batch {bs} depth {depth} [{card}]: "
              f"{len(pairs)} pairs of {W_FULL}x{H_FULL} raw uint8, "
              f"rectified, bit-equal to per-pair process; "
              f"{', '.join(f'{x:.3f}' for x in r)} ms/frame by host clock "
              f"(in turns; of it dispatch + drain "
              f"{', '.join(f'{a:.3f} + {b:.3f}' for a, b in split[(bs, depth)])}"
              f"); profiled window {wall / len(pairs):.3f} ms/frame, device "
              f"busy {busy / len(pairs):.3f} ms/frame, idle share "
              f"{1 - busy / wall:.4f}; peak {peak[(bs, depth)]:.2f} GiB",
              flush=True)
    gain = ms[(1, 0)] - ms[(1, 2)]
    print(f"shell runner [{card}]: depth 2 against depth 0 at batch 1: "
          f"{ms[(1, 0)]:.3f} -> {ms[(1, 2)]:.3f} ms/frame ({gain:+.3f} ms, "
          f"{gain / ms[(1, 0)]:+.1%} of depth 0); batch 2 depth 2 "
          f"{ms[(2, 2)]:.3f}", flush=True)
    sites = trace.sync_sites(lambda: StreamRunner(pipe).run(
        [pairs[0]], lambda *a: None, depth=0), PACKAGE)
    drain = statistics.median(b for _, b in split[(1, 0)])
    print(f"shell runner: what depth 2 can hide is depth 0's wait in its "
          f"drain, {drain:.3f} ms a frame: the host is inside process for "
          f"the rest, and process returns only after its last host sync; "
          f"{sum(sites.values())} syncs in one frame (batch 1, depth 0) by "
          f"call site, besides the drain's event:", flush=True)
    for k, n in sorted(sites.items(), key=lambda kv: -kv[1]):
        print(f"  {n:3d}x {k}", flush=True)


def shell_cli(card) -> None:
    """``cli live`` at full width and ``cli info``, in-process."""
    import contextlib
    import io

    from i3dr_stereo_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["live", "--frames", "3", "--width", str(W_FULL),
                       "--height", str(H_FULL), "--algorithm", "I3DRSGM"])
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli live exited {rc}")
    live = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(live.get("frames") == 3 and live.get("processed") == 3,
          f"cli live: {live}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["info"])
    check(rc == 0, f"cli info exited {rc}")
    info = json.loads(buf.getvalue())
    check("jax" not in info and torch.cuda.get_device_name(0)
          in info.get("devices", []), f"cli info: {info}")
    print(f"shell cli [{card}]: live {json.dumps(live)} in {wall:.2f} s "
          f"(warm-up and scene generation included); info "
          f"{json.dumps(info)}", flush=True)


def phase_shell(stats, card):
    """The shell around the pipeline at 2448x2048: the live graph, the
    graph rectifying raw frames, the stream runner and the CLI."""
    from i3dr_stereo_tpu_torch.config import params
    from i3dr_stereo_tpu_torch.core import camera
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.pipeline.pairing import Stamped

    t0 = time.perf_counter()
    shell_no_cv2()
    shell_live_graph(card, params, camera)
    # one flagship scene, generated once and rolled along x for each pair
    sc = layered_scene(H_FULL, W_FULL, **SCENE)
    L, R = raw_u8(sc.left), raw_u8(sc.right)
    pairs = [(Stamped(i / 5.0, np.roll(L, 97 * i, axis=1), i),
              Stamped(i / 5.0, np.roll(R, 97 * i, axis=1), i))
             for i in range(RUNNER_PAIRS)]
    shell_rectify_graph(card, params, camera, pairs[:2])
    shell_node_copies(card)
    shell_runner(card, params, camera, pairs)
    shell_cli(card)
    torch.cuda.empty_cache()
    print(f"shell phase done in {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 18: the mapping path (TSDF fusion and projective-ICP odometry)
# ---------------------------------------------------------------------------

# examples/demo_mapping_moving.py's room and trajectory, rendered at the
# flagship size (its 320x240 intrinsics scaled by 2448 / 320)
MAP_K = np.array([[2142.0, 0.0, 1224.0], [0.0, 2142.0, 1024.0],
                  [0.0, 0.0, 1.0]], np.float32)
MAP_SCENE = [
    ((0.0, 0.0, 3.0), (0.0, 0.0, -1.0), (3.0, 3.0, 0.01)),
    ((-1.0, 0.0, 2.2), (1.0, 0.0, -0.7), (0.6, 1.6, 0.7)),
    ((0.0, 0.9, 2.0), (0.0, -1.0, -0.4), (1.8, 0.5, 0.9)),
    ((0.45, -0.25, 1.6), (0.0, 0.0, -1.0), (0.35, 0.25, 0.01)),
]
MAP_FRAMES = 10
MAP_GRID = (512, 512, 512)
# the moving rig's volumes: the demo's (gated) and 512^3 over its extent
DEMO_VOLUME = dict(shape=(64, 64, 64), voxel_size=0.08,
                   origin=(-2.0, -2.0, 0.0))
FINE_VOLUME = dict(shape=MAP_GRID, voxel_size=0.01, origin=(-2.0, -2.0, 0.0))
# the stereo-fed volume: 12.8 m at 0.025 m, the scene's 0.87-10.9 m
STEREO_VOLUME = dict(shape=MAP_GRID, voxel_size=0.025,
                     origin=(-6.4, -6.4, 0.0))
STEREO_FRAMES = 4
# occupied voxels of the stereo-fed map beyond the background plane plus
# the truncation and a voxel, at most (the matcher's outliers put 24 of
# 92004 there, 0.026 %; each is held to the depth measured at its pixel)
MAX_BEYOND_SHARE = 1e-3
MAX_ATE_M = 0.05          # the reference's trajectory gates
MAX_ROT_DEG = 1.0
MIN_MAP_IOU = 0.8
# icp_step against its twin: the same pixels pair (sum w exact); A, b and
# sum w r^2 are sums in another order: |dA| / max|A|, |d sum w r^2| / its
# value and |db| / sqrt(max diag A * sum w r^2) (|b| is bounded by that)
TOL_ICP_REL = 1e-4
TOL_TRACK_M = 1e-4        # a whole track, kernels vs twins: translation
TOL_TRACK_DEG = 5e-3      # and rotation
TSDF_OPS_PER_VOXEL = 45   # float operations of tsdf_integrate a voxel
ICP_OPS_PER_PIXEL = 100   # of icp_step a pixel
# the bytes an ICP iteration needs a pixel, as the reference's _icp_level
# reads them: the current vertex (12) and valid flag (1), the previous
# vertex and normal (12 + 12) and ok flag (1) at the hit pixel; the kernel
# reads 48 (the current map's 16 in order, a hit's 32-byte record)
ICP_BYTES_PER_PIXEL = 38


def map_trajectory():
    """The demo's 10 poses (T_wc), default_rng(3)."""
    from i3dr_stereo_tpu_torch.mapping.odometry import _se3_exp

    rng = np.random.default_rng(3)
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(MAP_FRAMES - 1):
        xi = np.array([np.radians(rng.normal(0, 0.1)),
                       np.radians(0.6 + rng.normal(0, 0.1)), 0.0,
                       0.025 + rng.normal(0, 0.003), rng.normal(0, 0.003),
                       0.02 + rng.normal(0, 0.003)], np.float32)
        step = _se3_exp(torch.from_numpy(xi)).numpy()
        poses.append((poses[-1] @ step).astype(np.float32))
    return poses


def rot_diff_deg(Ra, Rb) -> float:
    """Angle between two rotations, from their Frobenius distance."""
    f = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(np.degrees(2 * np.arcsin(min(1.0, f / (2 * np.sqrt(2))))))


def inv_pose(T) -> np.ndarray:
    return np.linalg.inv(np.asarray(T, np.float64)).astype(np.float32)


def map_kernel_tsdf(stats, card, depths, poses) -> None:
    """tsdf_integrate vs its twin at 512^3 from three poses (the third
    with half the grid behind the camera): bit-equal after each; timed."""
    from i3dr_stereo_tpu_torch.mapping import tsdf

    behind = np.eye(4, dtype=np.float32)
    behind[2, 3] = 2.5                 # at z = 2.5 m: z < 2.5 behind it
    shots = [(depths[0], inv_pose(poses[0])), (depths[5], inv_pose(poses[5])),
             (depths[9], inv_pose(behind))]
    g = FINE_VOLUME
    tk = torch.zeros(g["shape"], device=DEVICE)
    wk = torch.zeros_like(tk)
    tp, wp = tk.clone(), wk.clone()
    for i, (d, T) in enumerate(shots):
        dt = torch.tensor(d, device=DEVICE)
        tsdf.integrate(tk, wk, dt, MAP_K, T, g["origin"], g["voxel_size"])
        tp, wp = tsdf.integrate(tp, wp, dt, MAP_K, T, g["origin"],
                                g["voxel_size"], plain=True)
        torch.cuda.synchronize()
        check(torch.equal(tk, tp) and torch.equal(wk, wp),
              f"tsdf_integrate differs from its twin after integration {i}: "
              f"{int((tk != tp).sum())} tsdf, {int((wk != wp).sum())} weight")
        print(f"tsdf_integrate {'x'.join(map(str, g['shape']))} from "
              f"{W_FULL}x{H_FULL}, pose {i}: bit-equal to its twin; seen "
              f"voxels {int((wk > 0).sum())}", flush=True)
    del tp, wp
    dt = torch.tensor(depths[0], device=DEVICE)
    T = inv_pose(poses[0])

    def run(plain=False):
        return tsdf.integrate(tk, wk, dt, MAP_K, T, g["origin"],
                              g["voxel_size"], plain=plain)

    st = stats["tsdf_integrate"]
    st["ms"] = gpu_ms(run)
    st["back_to_back_ms"] = back_to_back_ms(run, iters=20, warmup=2)
    st["plain_ms"] = gpu_ms(lambda: run(plain=True), iters=3, warmup=1)
    st["err"] = 0.0
    n = int(np.prod(g["shape"]))
    set_bound(stats, "tsdf_integrate", 16 * n + 4 * dt.numel(),
              TSDF_OPS_PER_VOXEL * n)
    print(f"timing [{card}]: tsdf_integrate at 512^3 from {W_FULL}x{H_FULL} "
          f"{st['ms']:.4f} ms by events, {st['back_to_back_ms']:.4f} back to "
          f"back; bound {st['bound_ms']:.4f} ms ({st['bound_by']}); twin "
          f"{st['plain_ms']:.2f} ms", flush=True)
    del tk, wk
    torch.cuda.empty_cache()


def icp_compare(a, b, label) -> dict:
    """Kernel state ``a`` against twin state ``b``: the same pixels (sum w
    equal), A, b, sum w r^2 within TOL_ICP_REL of their scales."""
    A, Ap = a[18:54], b[18:54]
    sr2, sr2p = float(a[60]), float(b[60])
    scale_b = float((Ap.reshape(6, 6).diagonal().max() * b[60]).sqrt())
    err = {"A": float((A - Ap).abs().max() / Ap.abs().max()),
           "b": float((a[54:60] - b[54:60]).abs().max()) / max(scale_b, 1e-30),
           "sum_wr2": abs(sr2 - sr2p) / max(sr2p, 1e-30),
           "T": float((a[:16] - b[:16]).abs().max())}
    check(float(a[61]) == float(b[61]) and float(b[61]) > 0,
          f"icp_step {label}: sum w {float(a[61])} against the twin's "
          f"{float(b[61])}")
    check(max(err["A"], err["b"], err["sum_wr2"]) < TOL_ICP_REL,
          f"icp_step {label}: {err} against the twin (tolerance "
          f"{TOL_ICP_REL})")
    return err


def twin_track_compare(tk, tp, label):
    """A track's pose through the kernel against the twins': translation
    and rotation within TOL_TRACK_M / TOL_TRACK_DEG; returns both."""
    a = tk[:16].reshape(4, 4).cpu().numpy()
    b = tp[:16].reshape(4, 4).cpu().numpy()
    dt = float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
    dr = rot_diff_deg(a[:3, :3], b[:3, :3])
    check(dt < TOL_TRACK_M and dr < TOL_TRACK_DEG,
          f"{label}, kernel vs twins: {dt} m, {dr} deg")
    return dt, dr


def map_kernel_icp(stats, card, depths):
    """icp_step vs its twin at each level of a 2448x2048 pair, a whole
    track in one launch, its reruns, other levels and steps on odd sizes;
    timed at level 0 beside Jw^T J on a ready J."""
    from i3dr_stereo_tpu_torch import _build
    from i3dr_stereo_tpu_torch.mapping import odometry as odo

    prev = odo.pack_maps(torch.tensor(depths[0], device=DEVICE), MAP_K, 3)
    cur = odo.pack_maps(torch.tensor(depths[1], device=DEVICE), MAP_K, 3)
    worst = 0.0
    for li in range(3):
        Kl = odo.level_intrinsics(MAP_K, li)
        cam = (Kl[0, 0], Kl[1, 1], Kl[0, 2], Kl[1, 2])
        sp = torch.zeros(odo.STATE, device=DEVICE)
        sp[:16] = torch.eye(4, device=DEVICE).reshape(-1)
        for it in range(3):
            # both from the same state: the twin's after the last step
            sk = sp.clone()
            sp = odo.icp_step(cur[li][0], prev[li][1], cam, sp, 0.5,
                              plain=True)
            odo.icp_step(cur[li][0], prev[li][1], cam, sk, 0.5)
            torch.cuda.synchronize()
            err = icp_compare(sk, sp, f"level {li} step {it}")
            worst = max(worst, err["A"], err["b"], err["sum_wr2"])
        h, w = cur[li][0].shape[:2]
        print(f"icp_step level {li} ({w}x{h}): 3 steps within "
              f"{TOL_ICP_REL:g} of the twin, same pixels (sum w "
              f"{int(float(sk[61]))}); last {json.dumps(err)}", flush=True)
    T0 = torch.eye(4, device=DEVICE)
    _build.reset_launches()
    tk = odo._track(prev, cur, MAP_K, T0)
    torch.cuda.synchronize()
    check(_build.LAUNCHES["icp_step"] == 1,
          f"a track launched icp_step {_build.LAUNCHES['icp_step']} times")
    tp = odo._track(prev, cur, MAP_K, T0, plain=True)
    dt, dr = twin_track_compare(tk, tp, "track")
    n0 = cur[0][0].shape[0] * cur[0][0].shape[1]
    print(f"icp_step: a whole track (4 / 7 / 10 steps) in one launch within "
          f"{dt:.3g} m and {dr:.3g} deg of the twins' (tolerance "
          f"{TOL_TRACK_M:g} m, {TOL_TRACK_DEG:g} deg); worst relative "
          f"difference of a step {worst:.3g}; grid "
          f"{odo._grid(tk.device.index, n0)} blocks", flush=True)
    reruns = [odo._track(prev, cur, MAP_K, T0) for _ in range(10)]
    torch.cuda.synchronize()
    differ = sum(not torch.equal(r, tk) for r in reruns)
    check(not differ, f"icp_step: {differ} of 10 reruns of a track differ "
          f"from the first")
    print("icp_step: 10 reruns of the track bit-identical to the first",
          flush=True)
    # other levels and steps on odd sizes; a level of 0 steps
    for (h, w), levels, iters in (((2047, 2445), 4, (2, 0, 3, 5)),
                                  ((1001, 1333), 3, (3, 2, 0)),
                                  ((2048, 2448), 2, (0, 4))):
        pv = odo.pack_maps(torch.tensor(depths[0][:h, :w], device=DEVICE),
                           MAP_K, levels)
        cv = odo.pack_maps(torch.tensor(depths[1][:h, :w], device=DEVICE),
                           MAP_K, levels)
        tk = odo._track(pv, cv, MAP_K, T0, iters)
        tp = odo._track(pv, cv, MAP_K, T0, iters, plain=True)
        dt, dr = twin_track_compare(tk, tp, f"track {w}x{h} {iters}")
        if iters[0] == 0:
            check(float(tk[16]) == 0.0 and float(tk[17]) == 0.0,
                  f"track {iters}: rmse {float(tk[16])}, fraction "
                  f"{float(tk[17])} after a finest level of 0 steps")
        else:
            check(float(tk[17]) == float(tp[17]),
                  f"track {iters}: fraction {float(tk[17])} against the "
                  f"twins' {float(tp[17])}")
        print(f"icp_step: track {w}x{h}, {levels} levels, steps {iters}: "
              f"within {dt:.3g} m and {dr:.3g} deg of the twins'; rmse "
              f"{float(tk[16]):.4g}, fraction {float(tk[17]):.4g}",
              flush=True)
    # a grid the card cannot hold at once is refused, not cut into steps
    maps, dims, cams, thr2 = odo.launch_table(
        odo.track_levels(prev, cur, MAP_K, (1,)), 0.5)
    state = torch.zeros(odo.STATE, device=DEVICE)
    too_many = odo._grid(state.device.index, 1 << 30) + 1
    part = torch.empty(2 * too_many * 32, device=DEVICE)
    n_before = _build.LAUNCHES["icp_step"]
    try:
        _build.launch("i3dr_icp_track", "icp_step", state.device, len(dims),
                      maps.ctypes.data, dims.ctypes.data, cams.ctypes.data,
                      float(thr2), part.data_ptr(), state.data_ptr(),
                      too_many, _build.stream_of(state))
        refused = None
    except RuntimeError as e:
        refused = str(e)
    check(refused is not None and _build.LAUNCHES["icp_step"] == n_before,
          f"a cooperative grid of {too_many} blocks was not refused")
    print(f"icp_step: a grid of {too_many} blocks raises: {refused}",
          flush=True)
    st = stats["icp_step"]
    st["err"] = worst
    Kl = odo.level_intrinsics(MAP_K, 0)
    cam = (Kl[0, 0], Kl[1, 1], Kl[0, 2], Kl[1, 2])
    state = torch.zeros(odo.STATE, device=DEVICE)
    state[:16] = torch.eye(4, device=DEVICE).reshape(-1)
    ready = state.clone()

    def step():
        return odo.icp_step(cur[0][0], prev[0][1], cam, state, 0.5)

    def track():
        return odo._track(prev, cur, MAP_K, T0)

    st["ms"] = gpu_ms(step)
    st["back_to_back_ms"] = back_to_back_ms(step)
    st["plain_ms"] = gpu_ms(lambda: odo.icp_step(
        cur[0][0], prev[0][1], cam, ready, 0.5, plain=True), iters=5,
        warmup=1)
    track_ms = gpu_ms(track, iters=10)
    st["track_back_to_back_ms"] = back_to_back_ms(track, iters=20)
    plain_track_ms = gpu_ms(lambda: odo._track(prev, cur, MAP_K, T0,
                                               plain=True), iters=2)
    # the yardstick: A = Jw^T J on a ready (N, 6) J, one cuBLAS call
    J = torch.randn(cur[0][0].shape[0] * cur[0][0].shape[1], 6,
                    device=DEVICE)
    Jw = J * (torch.rand(J.shape[0], 1, device=DEVICE) > 0.1)
    st["jtj_ms"] = gpu_ms(lambda: Jw.T @ J)
    st["jtj_back_to_back_ms"] = back_to_back_ms(lambda: Jw.T @ J)
    st["track_ms"] = track_ms
    st["plain_track_ms"] = plain_track_ms
    set_bound(stats, "icp_step", ICP_BYTES_PER_PIXEL * n0,
              ICP_OPS_PER_PIXEL * n0)
    npix = [cur[li][0].shape[0] * cur[li][0].shape[1] for li in range(3)]
    track_bytes = ICP_BYTES_PER_PIXEL * sum(
        n * k for n, k in zip(npix, (4, 7, 10)))
    st["track_bound_ms"] = track_bytes / PEAK_BYTES_S * 1e3
    print(f"timing [{card}]: icp_step at level 0 ({W_FULL}x{H_FULL}) "
          f"{st['ms']:.4f} ms by events, "
          f"{st['back_to_back_ms']:.4f} back to back; bound "
          f"{st['bound_ms']:.4f} ms ({st['bound_by']}); twin "
          f"{st['plain_ms']:.3f} ms; Jw^T J on a ready J {st['jtj_ms']:.4f} "
          f"ms ({st['jtj_back_to_back_ms']:.4f} back to back); a whole track "
          f"on ready maps {track_ms:.4f} ms by events, "
          f"{st['track_back_to_back_ms']:.4f} back to back (bound "
          f"{st['track_bound_ms']:.4f}, {track_bytes / 1e9:.3f} GB), twins "
          f"{plain_track_ms:.2f} ms", flush=True)


def occupancy_iou(a, b) -> float:
    return float((a & b).sum() / max((a | b).sum(), 1))


def map_moving_rig(stats, card, depths, poses) -> None:
    """The demo at 2448x2048: DepthOdometry tracks the 10 frames and each
    is fused into a 512^3 volume with its estimated pose (the main path,
    counted); the reference's gates on the trajectory and the demo's map."""
    from i3dr_stereo_tpu_torch import _build
    from i3dr_stereo_tpu_torch.mapping import DepthOdometry, TSDFVolume

    odo = DepthOdometry(K=MAP_K)
    vol = TSDFVolume(**FINE_VOLUME)
    odo.track(depths[0])                 # warm-up, then a fresh tracker
    odo = DepthOdometry(K=MAP_K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    est, track_ms, integrate_ms = [], [], []
    for d in depths:
        T_wc, ms = timed(lambda: odo.track(d).copy())
        est.append(T_wc)
        track_ms.append(ms)
        _, ms = timed(lambda: vol.integrate(d, MAP_K, inv_pose(T_wc)))
        integrate_ms.append(ms)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"moving rig launches ({MAP_FRAMES} frames of {W_FULL}x{H_FULL}): "
          f"{launches}", flush=True)
    # one launch a tracked frame runs every step of its track
    want = MAP_FRAMES - 1
    steps = want * sum(odo.iters)
    print(f"moving rig: icp_step {launches['icp_step']} launches running "
          f"{steps} steps ({want} tracked frames x {sum(odo.iters)})",
          flush=True)
    check(launches["icp_step"] == want
          and launches["tsdf_integrate"] == MAP_FRAMES,
          f"moving rig: icp_step {launches['icp_step']} (want {want}), "
          f"tsdf_integrate {launches['tsdf_integrate']}")
    for name in ("icp_step", "tsdf_integrate"):
        stats[name]["launches"] = launches[name]
    ate = [float(np.linalg.norm(e[:3, 3] - g[:3, 3]))
           for e, g in zip(est, poses)]
    rot = [rot_diff_deg(e[:3, :3], g[:3, :3]) for e, g in zip(est, poses)]
    check(max(ate) < MAX_ATE_M and max(rot) < MAX_ROT_DEG,
          f"moving rig: ATE {max(ate)} m, rotation {max(rot)} deg")

    def fuse(pose_list, volume):
        v = TSDFVolume(**volume)
        for d, T_wc in zip(depths, pose_list):
            v.integrate(d, MAP_K, inv_pose(T_wc))
        return v

    iou = occupancy_iou(fuse(poses, DEMO_VOLUME).occupancy_grid(),
                        fuse(est, DEMO_VOLUME).occupancy_grid())
    check(iou > MIN_MAP_IOU, f"moving rig: map IoU {iou} <= {MIN_MAP_IOU}")
    iou_fine = occupancy_iou(fuse(poses, FINE_VOLUME).occupancy_grid(),
                             vol.occupancy_grid())
    sites = trace.sync_sites(lambda: odo.track(depths[3]), PACKAGE)
    empty = trace.sync_sites(lambda: None, PACKAGE)
    # the same call in its parts
    from i3dr_stereo_tpu_torch.mapping import odometry as odom
    from i3dr_stereo_tpu_torch.mapping.tsdf import to_device

    box = {}
    parts = {
        "upload": lambda: box.update(d=to_device(depths[4], odo.device)),
        "pack_maps": lambda: box.update(m=odom.pack_maps(box["d"], MAP_K, 3)),
        "iterations": lambda: box.update(s=odom._track(
            odo._prev, box["m"], MAP_K, torch.eye(4, device=DEVICE))),
        "readout": lambda: odom._readout(box["s"]),
    }
    by_part = {k: trace.sync_sites(f, PACKAGE) for k, f in parts.items()}
    print(f"moving rig [{card}]: ATE max {max(ate):.5f} m (final "
          f"{ate[-1]:.5f}), rotation error max {max(rot):.4f} deg, last ICP "
          f"rmse {odo.last_diag['rmse']:.5f} m, inlier share "
          f"{odo.last_diag['inlier_frac']:.4f}; map IoU against the "
          f"ground-truth-pose fusion {iou:.4f} in the demo's 64^3 x 0.08 m "
          f"volume (gate > {MIN_MAP_IOU}), {iou_fine:.4f} in 512^3 x 0.01 m "
          f"(reported)", flush=True)
    med_track = statistics.median(track_ms[1:])
    print(f"timing [{card}]: track {med_track:.3f} ms a frame by events "
          f"(median of {MAP_FRAMES - 1}; "
          f"{', '.join(f'{x:.3f}' for x in track_ms[1:])}; numpy depth in, "
          f"pose out), first frame {track_ms[0]:.3f}; integrate into 512^3 "
          f"{statistics.median(integrate_ms):.3f} ms by events (median); "
          f"peak {peak:.2f} GiB", flush=True)
    print(f"moving rig: {sum(sites.values())} host syncs in one track call, "
          f"by call site (an empty call lists {empty}):", flush=True)
    for k, n in sorted(sites.items(), key=lambda kv: -kv[1]):
        print(f"  {n:3d}x {k}", flush=True)
    print(f"moving rig: the same call in its parts: {by_part}", flush=True)
    port = {k: n for k, n in sites.items() if not k.startswith("outside")}
    check(all("(_readout)" in k for k in port) and sum(port.values()) == 1
          and not by_part["iterations"],
          f"track syncs the host in the port outside its final readout: "
          f"{sites}, by part {by_part}")
    stats["icp_step"]["track_frame_ms"] = med_track
    stats["tsdf_integrate"]["frame_ms"] = statistics.median(integrate_ms)


def map_stereo_fed(card) -> None:
    """launch_processing with the flagship config and the map consumer
    into a 512^3 volume: the background plane at 10.875 m, nothing beyond
    it; bit-equal to the twin fed the same depth frames."""
    from i3dr_stereo_tpu_torch import _build
    from i3dr_stereo_tpu_torch.bridge.launch import launch_processing
    from i3dr_stereo_tpu_torch.config import params
    from i3dr_stereo_tpu_torch.core import camera
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.mapping import (TSDFVolume, make_map_consumer,
                                               tsdf)
    from i3dr_stereo_tpu_torch.mapping.tsdf import to_device

    rig = camera.StereoRig.synthetic(W_FULL, H_FULL, fx=580.0,
                                     baseline_m=0.3)
    cloud = params.PointCloudConfig(depth_max=100.0, depth_min=0.5)
    sc = layered_scene(H_FULL, W_FULL, **SCENE)
    L, R = raw_u8(sc.left), raw_u8(sc.right)
    K = np.array([[rig.left.fx, 0.0, rig.left.cx],
                  [0.0, rig.left.fy, rig.left.cy], [0, 0, 1]], np.float32)

    def graph(consumer):
        return launch_processing(
            rig, stereo_algorithm=params.Algorithm.I3DRSGM,
            config=flagship_cfg(params), cloud=cloud, with_crop=False,
            warmup=False, map_consumer=consumer).graph

    def publish(g, n, t0=0.0):
        for i in range(n):
            g.publish("/stereo/left/image_raw", t0 + i / 5.0, L)
            g.publish("/stereo/right/image_raw", t0 + i / 5.0, R)

    vol = TSDFVolume(**STEREO_VOLUME)
    g_map = graph(make_map_consumer(vol, rig))
    depths = []

    def record(stamp, points):
        if len(depths) == STEREO_FRAMES:       # the timed frames after them
            return
        xyz = np.asarray(points["xyz"]).reshape(H_FULL, W_FULL, 3)
        valid = np.asarray(points["valid"]).reshape(H_FULL, W_FULL)
        depths.append(np.where(valid, xyz[..., 2], 0.0).astype(np.float32))

    g_map.subscribe("/stereo/points2", record)
    g_plain = graph(None)
    publish(g_plain, 1)                          # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    publish(g_map, STEREO_FRAMES)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    check(vol.frames_integrated == STEREO_FRAMES
          and launches["tsdf_integrate"] == STEREO_FRAMES,
          f"stereo-fed map: {vol.frames_integrated} frames integrated, "
          f"launches {launches}")
    for name in FLAGSHIP_KERNELS:
        check(launches[name] > 0, f"stereo-fed map: {name} did not launch")
    z = vol.occupied_points()[:, 2]
    deep = float(z.max()) if len(z) else float("nan")
    bg = 580.0 * 0.3 / SCENE["background_disp"]
    voxel = STEREO_VOLUME["voxel_size"]
    top = bg + 3 * voxel + voxel
    near = int((np.abs(z - bg) <= 3 * voxel).sum())
    beyond = z > top
    deep_px = [int((d > bg + 3 * voxel).sum()) for d in depths]
    explained = beyond_explained(vol.occupied_points()[beyond], depths, K,
                                 3 * voxel)
    valid_px = [int((d > 0).sum()) for d in depths]
    far = depths[0] > bg + 3 * voxel
    cols = np.nonzero(far.any(axis=0))[0]
    print(f"stereo-fed map: {int(beyond.sum())} of {len(z)} occupied voxels "
          f"beyond {top:.4f} m; valid depth pixels deeper than "
          f"{bg + 3 * voxel:.4f} m a frame {deep_px} of {valid_px} (frame 0: "
          f"depths {np.sort(depths[0][far])[-5:] if far.any() else []}, "
          f"columns {cols.min() if len(cols) else None}-"
          f"{cols.max() if len(cols) else None}, rows "
          f"{np.nonzero(far.any(axis=1))[0][[0, -1]] if far.any() else None})",
          flush=True)
    check(near > 0, f"stereo-fed map: no occupied voxel within 3 voxels of "
          f"the background plane at {bg} m")
    # the matcher's outliers lie behind the plane (0.18 % of valid pixels
    # a flagship frame): a voxel beyond it must sit within the truncation
    # of the depth measured at its own pixel, and such voxels stay few
    check(explained == int(beyond.sum())
          and beyond.sum() <= MAX_BEYOND_SHARE * len(z),
          f"stereo-fed map: {int(beyond.sum())} occupied voxels beyond "
          f"{top} m (up to {deep} m), {explained} of them within the "
          f"truncation of their pixel's depth")
    twin = TSDFVolume(**STEREO_VOLUME)
    for d in depths:
        twin.tsdf, twin.weight = tsdf.integrate(
            twin.tsdf, twin.weight, to_device(d, twin.device), K,
            np.eye(4, dtype=np.float32), twin.origin, twin.voxel_size,
            twin.trunc_vox, plain=True)
    check(torch.equal(twin.tsdf, vol.tsdf)
          and torch.equal(twin.weight, vol.weight),
          "stereo-fed map: the kernel-fed volume differs from the twin-fed")
    ms = {"with": [], "without": []}
    for i, (name, g) in enumerate((("without", g_plain), ("with", g_map),
                                   ("with", g_map), ("without", g_plain))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        publish(g, STEREO_FRAMES, t0=10.0 * (i + 1))
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3 / STEREO_FRAMES)
    print(f"stereo-fed map [{card}]: {STEREO_FRAMES} flagship frames of "
          f"{W_FULL}x{H_FULL} through launch_processing into 512^3 x "
          f"{voxel} m: {len(z)} occupied voxels, {near} within 3 voxels of "
          f"the background plane at {bg} m, deepest {deep:.4f} m; "
          f"{int(beyond.sum())} beyond {top:.4f} m, each within the "
          f"truncation of its pixel's measured depth (gate: all, and at most "
          f"{MAX_BEYOND_SHARE:.1%} of the occupied); bit-equal to the twin "
          f"fed the same depth; launches "
          f"{launches}", flush=True)
    print(f"timing [{card}]: the graph with the map consumer "
          f"{', '.join(f'{x:.3f}' for x in ms['with'])} ms/frame, without "
          f"{', '.join(f'{x:.3f}' for x in ms['without'])} (host clock, in "
          f"turns)", flush=True)


def beyond_explained(points, depths, K, trunc) -> int:
    """How many of the camera-frame ``points`` (a static camera at the
    world origin) lie within ``trunc`` of a measured depth at their pixel
    (its 3x3 neighbourhood, against rounding) in some frame."""
    n = 0
    for x, y, z in np.asarray(points, np.float64):
        u = int(round(K[0, 0] * x / z + K[0, 2]))
        v = int(round(K[1, 1] * y / z + K[1, 2]))
        ok = False
        for d in depths:
            win = d[max(v - 1, 0):v + 2, max(u - 1, 0):u + 2]
            win = win[win > 0]
            ok |= bool(len(win)) and float(np.abs(win - z).min()) <= trunc
        n += ok
    return n


def phase_mapping(stats, card):
    """The mapping path at 2448x2048: the two kernels against their
    twins, the moving rig (odometry and fusion, the main path) and the
    stereo-fed map."""
    from concurrent.futures import ThreadPoolExecutor

    from i3dr_stereo_tpu_torch.mapping import render_plane_depth

    t0 = time.perf_counter()
    poses = map_trajectory()
    with ThreadPoolExecutor(5) as pool:
        depths = list(pool.map(lambda T: render_plane_depth(
            MAP_K, T, MAP_SCENE, H_FULL, W_FULL), poses))
    print(f"mapping: {MAP_FRAMES} poses rendered at {W_FULL}x{H_FULL} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    map_kernel_tsdf(stats, card, depths, poses)
    map_kernel_icp(stats, card, depths)
    map_moving_rig(stats, card, depths, poses)
    map_stereo_fed(card)
    torch.cuda.empty_cache()
    print(f"mapping phase done in {time.perf_counter() - t0:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# phase 19: capture (GigE Vision cameras, the shared-memory ring)
# ---------------------------------------------------------------------------

CAPTURE_PAIRS = 8
CAPTURE_FPS = 5.0          # the reference rig's rate (stereo_capture.launch)
CLOCK_OFFSET_NS = 1000 * 10**9   # the right camera's device clock, ahead
GIGE_PACKET = 8996         # SCPS of an MTU of 9000: ~560 packets a frame
WIRE_BPS = 1e9 / 8         # a gigabit link's payload rate (gige_bench.py)
PACE_PACKETS = 16          # packets a camera between pacing sleeps


class GraphSpy:
    """Records the graph ``cli.cmd_live`` launches: the raw frames and the
    node's P1 as each pair reaches the node, its disparities, and the
    source's counters when the feed ends (the CLI closes it after)."""

    def __init__(self, on_start=None):
        import threading

        from i3dr_stereo_tpu_torch.bridge import launch

        self.launch, self.on_start = launch, on_start
        self.orig = (launch.launch_stereo_camera, launch.run_source)
        self.started = threading.Event()
        self.left, self.raw, self.p1, self.pubs = [], [], [], []
        self.sources, self.lg = [], None

    def __enter__(self):
        def launch_stereo_camera(*a, **kw):
            lg = self.lg = self.orig[0](*a, **kw)
            g, node = lg.graph, lg.node("generate_disparity")
            # a pair runs when its right frame reaches the node: P1 is read
            # as its left frame arrives, before any /set can slip between
            g.subscribe("/stereo/left/image_raw", lambda s, d: (
                self.left.append(d), self.p1.append(node.pipeline.config.p1)))
            g.subscribe("/stereo/right/image_raw",
                        lambda s, d: self.raw.append((self.left[-1], d)))
            g.subscribe("/stereo/disparity",
                        lambda s, m: self.pubs.append(m))
            return lg

        def run_source(lg, *a, **kw):
            if self.on_start is not None and not self.started.is_set():
                self.on_start()
            self.started.set()
            n = self.orig[1](lg, *a, **kw)
            self.sources.append(source_counts(lg.nodes["source"]))
            return n

        self.launch.launch_stereo_camera = launch_stereo_camera
        self.launch.run_source = run_source
        return self

    def __exit__(self, *exc):
        self.launch.launch_stereo_camera, self.launch.run_source = self.orig


def source_counts(src) -> dict:
    """A GigE stereo source's counters (none for another source)."""
    if not hasattr(src, "dropped_unpaired"):
        return {}
    rx = [src.left.receiver.stats, src.right.receiver.stats]
    return {"dropped_unpaired": src.dropped_unpaired,
            "resend_requests": sum(s["resend_requests"] for s in rx),
            "dropped_frames": sum(s["dropped"] for s in rx),
            "packets": sum(s["packets"] for s in rx)}


def emulators():
    """Two emulated cameras, control enforced as real cameras do."""
    from i3dr_stereo_tpu_torch.io.gige import GigECameraEmulator

    return [GigECameraEmulator(serial=s, enforce_control=True,
                               resend_cache_blocks=CAPTURE_PAIRS)
            for s in ("SL", "SR")]


def gvsp_packets(img, block_id, timestamp_ns, payload) -> list:
    """``GigECameraEmulator.send_frame``'s LEADER, PAYLOAD and TRAILER
    packets of one uint8 image, by packet id."""
    import struct

    def pkt(fmt, pid, body=b""):
        return struct.pack(">HHI", 0, block_id & 0xFFFF,
                           (fmt << 24) | (pid & 0xFFFFFF)) + body

    h, w = img.shape
    out = [pkt(1, 0, struct.pack(">HHQIII", 0, 1, timestamp_ns, 8 << 16, w,
                                 h) + b"\0" * 16)]
    raw = img.tobytes()
    for off in range(0, len(raw), payload):
        out.append(pkt(3, len(out), raw[off:off + payload]))
    out.append(pkt(2, len(out)))
    return out


def trigger(emus, frames) -> None:
    """Once both cameras are brought up, fire them together at
    CAPTURE_FPS, the right device clock CLOCK_OFFSET_NS ahead: each
    frame's packets leave at a gigabit link's rate from its trigger (a
    5 MB burst into a socket buffer would measure the buffer, not the
    receiver), the two cameras' interleaved chunk by chunk as two links
    stream side by side (two sender threads skewed the pair by tens of
    ms). Every packet enters its camera's resend cache."""
    from i3dr_stereo_tpu_torch.io.gige import (REG_ACQUISITION_START, REG_SCP,
                                               REG_SCPS)

    deadline = time.monotonic() + 120
    while not all(e.regs[REG_ACQUISITION_START] == 1 and e.regs[REG_SCP]
                  for e in emus):
        check(time.monotonic() < deadline, "cameras: never started")
        time.sleep(0.01)
    dests = [e.stream_dest() for e in emus]
    payload = [max(64, (e.regs[REG_SCPS] & 0xFFFF) - 8) for e in emus]
    t_next = time.perf_counter()
    for i, pair in enumerate(frames):
        t0 = time.perf_counter()
        packets = [gvsp_packets(img, i + 1, int(i * 1e9 / CAPTURE_FPS) + off,
                                size)
                   for img, off, size in zip(pair, (0, CLOCK_OFFSET_NS),
                                             payload)]
        for e, pk in zip(emus, packets):
            for pid, data in enumerate(pk):
                e._cache(i + 1, pid, data)
        sent = [0, 0]
        for k in range(max(len(pk) for pk in packets)):
            for c, (e, pk, dest) in enumerate(zip(emus, packets, dests)):
                if k < len(pk):
                    e._send_raw(pk[k], dest, True)
                    sent[c] += len(pk[k])
            if k % PACE_PACKETS == PACE_PACKETS - 1:
                time.sleep(max(0.0, t0 + max(sent) / WIRE_BPS
                               - time.perf_counter()))
        t_next += 1.0 / CAPTURE_FPS
        time.sleep(max(0.0, t_next - time.perf_counter()))


def camera_process(h: int, w: int, scene: dict) -> int:
    """``python3 chip_smoke.py --cameras H W SCENE``: the two emulated
    cameras in a process of their own, as cameras are devices of their
    own (their senders must not share the receiving process's
    interpreter). Prints their addresses, streams ``capture_frames()`` of
    that size and scene once told ``go`` on stdin and the host has
    brought them up, prints what it sent, and serves resends until stdin
    closes."""
    global H_FULL, W_FULL, SCENE
    H_FULL, W_FULL, SCENE = h, w, scene
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    frames = capture_frames()
    emus = emulators()
    print(json.dumps({"cameras": [list(e.address) for e in emus]}),
          flush=True)
    try:
        if sys.stdin.readline().strip() == "go":
            trigger(emus, frames)
            print(json.dumps({"sent": len(frames)}), flush=True)
        sys.stdin.read()
    finally:
        for e in emus:
            e.close()
    return 0


class Cameras:
    """``camera_process`` run from here: ``addresses``, ``go()`` to start
    the stream; on leaving, what it sent is checked and it is ended."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--cameras",
             str(H_FULL), str(W_FULL), json.dumps(SCENE)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        line = self.proc.stdout.readline()
        check(bool(line), "cameras: the camera process did not start")
        self.addresses = [tuple(a) for a in json.loads(line)["cameras"]]
        return self

    def go(self) -> None:
        self.proc.stdin.write("go\n")
        self.proc.stdin.flush()

    def sent(self) -> int:
        return json.loads(self.proc.stdout.readline())["sent"]

    def __exit__(self, *exc):
        try:
            self.proc.stdin.close()
            self.proc.wait(timeout=30)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()


def capture_only(frames, backend) -> dict:
    """Both cameras into ``GigEStereoSource.pairs()`` with no matcher: the
    pairs and their payloads, pairs a second, and the host's reassembly
    CPU a frame (this process's CPU; the cameras run in another)."""
    from i3dr_stereo_tpu_torch.io.gige import GigEStereoSource

    with Cameras() as cams:
        src = GigEStereoSource(*cams.addresses, width=W_FULL, height=H_FULL,
                               packet_size=GIGE_PACKET, backend=backend)
        cpu0 = time.process_time()
        cams.go()
        got, stamps = [], []
        for l, r in src.pairs():
            got.append((l, r))
            stamps.append(time.perf_counter())
        cpu = time.process_time() - cpu0
        counts = source_counts(src)
        src.close()
        check(cams.sent() == len(frames), "capture: the cameras did not "
              "send every frame")
    check(len(got) == len(frames), f"capture ({backend}): {len(got)} of "
          f"{len(frames)} pairs, {counts}")
    for (l, r), (a, b) in zip(got, frames):
        check(np.array_equal(l.data, a) and np.array_equal(r.data, b),
              f"capture ({backend}): a payload differs from the frame sent")
        check(abs(r.device_stamp - l.device_stamp - CLOCK_OFFSET_NS / 1e9)
              < 1e-6 and l.stamp == r.stamp,
              f"capture ({backend}): stamps {l.stamp} {r.stamp} "
              f"{l.device_stamp} {r.device_stamp}")
    span = stamps[-1] - stamps[0]
    return {"pairs_per_s": (len(got) - 1) / span if span > 0 else None,
            "reassembly_ms": cpu * 1e3 / (2 * len(got)), **counts}


def capture_cli(card, params, camera, frames, backend) -> None:
    """``cli live --gige`` on the two emulated cameras, flagship graph:
    every pair delivered, each disparity bit-equal to ``process``."""
    import contextlib
    import io

    from i3dr_stereo_tpu_torch import _build, cli
    from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline

    with Cameras() as cams, GraphSpy(on_start=cams.go) as spy:
        addrs = ",".join(f"{h}:{p}" for h, p in cams.addresses)
        buf = io.StringIO()
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["live", "--gige", addrs, "--gige-backend",
                           backend, "--packet-size", str(GIGE_PACKET),
                           "--width", str(W_FULL), "--height", str(H_FULL),
                           "--algorithm", "I3DRSGM", "--device", DEVICE])
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        check(cams.sent() == len(frames), "cli live --gige: the cameras did "
              "not send every frame")
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    counts = spy.sources[-1]
    check(rc == 0 and out == {"frames": len(frames),
                              "processed": len(frames)},
          f"cli live --gige ({backend}): {out}, {counts}")
    for name in FLAGSHIP_KERNELS:
        if name != "remap":
            check(launches[name] > 0, f"cli live --gige: {name} did not "
                  "launch")
    node = spy.lg.node("generate_disparity")
    ref = StereoPipeline(node.pipeline.rig, node.pipeline.config,
                         node.pipeline.cloud, device=DEVICE,
                         rectify_inputs=False)
    check(len(spy.pubs) == len(frames), "cli live --gige: publications")
    for (a, b), (l, r), msg in zip(frames, spy.raw, spy.pubs):
        check(np.array_equal(l, a) and np.array_equal(r, b),
              f"cli live --gige ({backend}): a frame differs from the sent")
        want = ref.process(a, b)
        check(np.array_equal(msg["disparity"], want.disparity.cpu().numpy())
              and np.array_equal(msg["valid"], want.valid.cpu().numpy()),
              f"cli live --gige ({backend}): a disparity differs from "
              "process")
    match_ms = gpu_ms(lambda: ref.process(*frames[0]), iters=5, warmup=1)
    print(f"cli live --gige {backend} [{card}]: {len(frames)} pairs of "
          f"{W_FULL}x{H_FULL} uint8, right device clock "
          f"{CLOCK_OFFSET_NS / 1e9:.0f} s ahead, every pair delivered and "
          f"each disparity and valid mask bit-equal to process; "
          f"{wall:.2f} s (bring-up, warm-up and 1 s of end-of-stream quiet "
          f"included), {counts}; the matcher {match_ms:.3f} ms/frame "
          f"(events, process); launches {launches}", flush=True)


def capture_ring(card, params, camera, frames) -> None:
    """The same frames through two ``FrameRing``s and
    ``ShmCameraPublisher``s into the flagship graph: bit-equal again."""
    import os

    from i3dr_stereo_tpu_torch import _build
    from i3dr_stereo_tpu_torch.bridge.drivers import ShmCameraPublisher
    from i3dr_stereo_tpu_torch.bridge.graph import Graph
    from i3dr_stereo_tpu_torch.bridge.launch import launch_stereo_matcher
    from i3dr_stereo_tpu_torch.native.shm import FrameRing
    from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline

    rig = camera.StereoRig.synthetic(W_FULL, H_FULL, fx=580.0, baseline_m=0.3)
    g = Graph()
    lg = launch_stereo_matcher(rig, stereo_algorithm=params.Algorithm.I3DRSGM,
                               rectify_inputs=False, graph=g, device=DEVICE)
    node = lg.node("generate_disparity")
    pubs = []
    g.subscribe("/stereo/disparity", lambda s, m: pubs.append(m))
    ref = StereoPipeline(rig, node.pipeline.config, node.pipeline.cloud,
                         device=DEVICE, rectify_inputs=False)
    names = [f"i3dr_smoke_{os.getpid()}_{s}" for s in ("l", "r")]
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    with FrameRing(names[0], slots=2, frame_shape=(H_FULL, W_FULL)) as rl, \
         FrameRing(names[1], slots=2, frame_shape=(H_FULL, W_FULL)) as rr:
        pl = ShmCameraPublisher(g, rl, "/stereo/left", name="left_shm")
        pr = ShmCameraPublisher(g, rr, "/stereo/right", name="right_shm")
        for i, (a, b) in enumerate(frames):
            check(rl.push(i / CAPTURE_FPS, a, seq=i)
                  and rr.push(i / CAPTURE_FPS, b, seq=i), "ring: full")
            check(pl.pump() == 1 and pr.pump() == 1, "ring: pump")
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    check(len(pubs) == len(frames), f"ring: {len(pubs)} disparities")
    for (a, b), msg in zip(frames, pubs):
        want = ref.process(a, b)
        check(np.array_equal(msg["disparity"], want.disparity.cpu().numpy())
              and np.array_equal(msg["valid"], want.valid.cpu().numpy()),
              "ring: a disparity differs from process")
    for name in FLAGSHIP_KERNELS:
        if name != "remap":
            check(launches[name] > 0, f"ring: {name} did not launch")
    print(f"ring [{card}]: {len(frames)} pairs through two FrameRings and "
          f"ShmCameraPublishers into the flagship graph in {wall:.2f} s, "
          f"each disparity bit-equal to process", flush=True)


def capture_frames():
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene

    sc = layered_scene(H_FULL, W_FULL, **SCENE)
    L, R = raw_u8(sc.left), raw_u8(sc.right)
    return [(np.roll(L, 97 * i, axis=1), np.roll(R, 97 * i, axis=1))
            for i in range(CAPTURE_PAIRS)]


def phase_capture(stats, card):
    """Two emulated GigE Vision cameras at 2448x2048 (both backends), the
    CLI's live graph on them, and the shared-memory ring."""
    from i3dr_stereo_tpu_torch.config import params
    from i3dr_stereo_tpu_torch.core import camera

    t0 = time.perf_counter()
    frames = capture_frames()
    rmem = Path("/proc/sys/net/core/rmem_max")
    print(f"capture: the host's largest socket receive buffer (rmem_max) "
          f"{rmem.read_text().strip() if rmem.exists() else 'unknown'} "
          f"bytes", flush=True)
    for backend in ("python", "native"):
        c = capture_only(frames, backend)
        print(f"capture {backend} [{card}]: {CAPTURE_PAIRS} pairs of "
              f"{W_FULL}x{H_FULL} at {CAPTURE_FPS:g} per s, paced at 1 GbE, "
              f"SCPS {GIGE_PACKET}, right device clock {CLOCK_OFFSET_NS / 1e9:.0f} s "
              f"ahead: all paired, payloads exact; {c['pairs_per_s']:.3f} "
              f"pairs/s, reassembly {c['reassembly_ms']:.3f} ms of host CPU "
              f"a frame (this process's; the cameras run in another), "
              f"dropped_unpaired "
              f"{c['dropped_unpaired']}, resend requests "
              f"{c['resend_requests']}, frames dropped "
              f"{c['dropped_frames']}, packets {c['packets']}", flush=True)
        capture_cli(card, params, camera, frames, backend)
    capture_ring(card, params, camera, frames)
    torch.cuda.empty_cache()
    print(f"capture phase done in {time.perf_counter() - t0:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# phase 20: the operator server (cli live --serve)
# ---------------------------------------------------------------------------

SERVE_P1 = 0.4             # the I3DRSGM defaults' P1 is 0.1


class Tee:
    """A stdout that keeps what is written and passes it on."""

    def __init__(self, out):
        self.out, self.text = out, ""

    def write(self, s):
        self.text += s
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def http_get(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def phase_serve(stats, card):
    """``cli live --serve --duration 3`` on the synthetic 2448x2048
    source: ``/params`` lists the three servers, a ``/set`` of P1 reaches
    the next frame (bit-equal to ``process`` under that P1, and not to
    ``process`` under the old one). No JPEG route: the card's machine has
    no OpenCV."""
    import contextlib
    import threading

    from i3dr_stereo_tpu_torch import _build, cli
    from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline

    t0 = time.perf_counter()
    tee = Tee(sys.stdout)
    rc = []

    def wait(cond, what, seconds=120):
        deadline = time.monotonic() + seconds
        while not cond():
            check(time.monotonic() < deadline, f"serve: {what}")
            time.sleep(0.01)

    with GraphSpy() as spy, contextlib.redirect_stdout(tee):
        torch.cuda.synchronize()
        _build.reset_launches()
        th = threading.Thread(target=lambda: rc.append(cli.main(
            ["live", "--serve", "--duration", "3", "--frames", "4",
             "--width", str(W_FULL), "--height", str(H_FULL),
             "--algorithm", "I3DRSGM", "--device", DEVICE])), daemon=True)
        th.start()
        wait(lambda: '"serving"' in tee.text, "no serving line")
        url = next(json.loads(line)["serving"] for line in
                   tee.text.splitlines() if '"serving"' in line)
        served = http_get(url + "params")
        wait(lambda: spy.pubs, "no frame")
        old = spy.lg.node("generate_disparity").pipeline.config
        got = http_get(url + f"set?server=disparity&p1={SERVE_P1}")
        k = len(spy.p1)               # the next pair to reach the node
        th.join(timeout=120)
        check(not th.is_alive(), "serve: the CLI did not end")
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    out = json.loads(tee.text.strip().splitlines()[-1])
    check(rc == [0] and out["frames"] == out["processed"] == len(spy.pubs)
          and out["served"] == url, f"serve: {rc} {out}")
    check({"disparity", "cloud", "view"} <= set(served)
          and served["disparity"]["values"]["p1"] == old.p1,
          f"serve: /params lists {sorted(served)}")
    check(got["ok"] and got["values"]["p1"] == SERVE_P1, f"serve: /set {got}")
    check(len(spy.pubs) > k, f"serve: no frame after the /set ({k} before)")
    for name in FLAGSHIP_KERNELS:
        if name != "remap":
            check(launches[name] > 0, f"serve: {name} did not launch")
    node = spy.lg.node("generate_disparity")
    new = node.pipeline.config
    check(new.p1 == SERVE_P1 and spy.p1[:k] == [old.p1] * k
          and spy.p1[k:] == [SERVE_P1] * (len(spy.pubs) - k),
          f"serve: P1 by frame {spy.p1}, the /set before frame {k}")
    refs = [StereoPipeline(node.pipeline.rig, cfg, node.pipeline.cloud,
                           device=DEVICE, rectify_inputs=False)
            for cfg in (old, new)]
    for i, ((a, b), msg) in enumerate(zip(spy.raw, spy.pubs)):
        want, other = (p.process(a, b) for p in
                       (refs if i < k else refs[::-1]))
        d = want.disparity.cpu().numpy()
        check(np.array_equal(msg["disparity"], d)
              and np.array_equal(msg["valid"], want.valid.cpu().numpy()),
              f"serve: frame {i} differs from process under its P1")
        check(not np.array_equal(d, other.disparity.cpu().numpy()),
              f"serve: frame {i} is the same under both P1s")
    print(f"serve [{card}]: cli live --serve --duration 3 at "
          f"{W_FULL}x{H_FULL}: /params lists {sorted(served)}; /set "
          f"p1={SERVE_P1} (from {old.p1}) answered ok before pair {k}; "
          f"{len(spy.pubs)} frames, each bit-equal to process under the P1 "
          f"it ran with and not under the other; launches {launches}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 21: the sharded matcher and pipeline step (dist/)
# ---------------------------------------------------------------------------

DIST_HALO = 64             # the reference test's 32 rows, for 4 levels
DIST_MARGIN = 16           # rows from a cut left out of the gate (its 8)
MIN_SHARD_AGREE = 0.99     # the reference test's gate (tests/test_dist.py)


def rect_map_at(cam, u, v):
    """Where ``cam``'s rectification samples the raw image for rectified
    pixels (u, v): ``ops/rectify.py:inverse_rectify_map_xy`` at any
    coordinates."""
    x = (u - cam.cx) / cam.fx
    y = (v - cam.cy) / cam.fy
    Ri = np.linalg.inv(cam.R)
    X, Y, Z = (Ri[i, 0] * x + Ri[i, 1] * y + Ri[i, 2] for i in range(3))
    xp, yp = X / Z, Y / Z
    k1, k2, p1, p2, k3 = np.concatenate([cam.D[:5], np.zeros(5)])[:5]
    r2 = xp * xp + yp * yp
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = xp * radial + 2.0 * p1 * xp * yp + p2 * (r2 + 2.0 * xp * xp)
    yd = yp * radial + p1 * (r2 + 2.0 * yp * yp) + 2.0 * p2 * xp * yp
    return cam.K[0, 0] * xd + cam.K[0, 2], cam.K[1, 1] * yd + cam.K[1, 2]


def raw_views(cam, images):
    """The raw images ``cam`` sees of rectified ``images``: each raw pixel
    samples the image where the rectification maps it (the map inverted
    by fixed-point steps, float64), bicubic."""
    from scipy.ndimage import map_coordinates

    y, x = np.mgrid[0:H_FULL, 0:W_FULL].astype(np.float64)
    u, v = x.copy(), y.copy()
    for _ in range(10):
        mx, my = rect_map_at(cam, u, v)
        u += x - mx
        v += y - my
    mx, my = rect_map_at(cam, u, v)
    check(float(np.abs(mx - x).max() + np.abs(my - y).max()) < 1e-3,
          "dist: the rectification map did not invert")
    return np.stack([raw_u8(map_coordinates(img.astype(np.float64), [v, u],
                                            order=3, mode="nearest"))
                     for img in images])


def dist_agreement(res_s, res_1):
    """Share of pixels valid in both runs, more than DIST_MARGIN rows from
    every cut, within 1 px of the unsharded run; and by bands of 8 rows
    from the nearest cut."""
    cuts = np.array([H_FULL // 4 * k for k in (1, 2, 3)])
    rows = np.abs(np.arange(H_FULL)[:, None] - cuts[None]).min(1)
    v = (res_s.valid & res_1.valid).cpu().numpy()
    ok = ((res_s.disparity - res_1.disparity).abs() < 1.0).cpu().numpy()
    sel = v & (rows > DIST_MARGIN)[None, :, None]
    bands = []
    for b in range(0, 64, 8):
        m = v & ((rows >= b) & (rows < b + 8))[None, :, None]
        bands.append((b, float(ok[m].mean())))
    far = v & (rows >= 64)[None, :, None]
    return float(ok[sel].mean()), float(sel.mean()), bands, \
        float(ok[far].mean())


def phase_dist(stats, card):
    """The sharded matcher on the flagship config at 2448x2048, batch 2:
    mesh 1x1 bit-equal to the unsharded run, mesh 1x4 on the one card
    (halo 64) at the reference test's gate away from the cuts, and the
    2x1 pipeline step on the distorted rig at the accuracy gate."""
    from i3dr_stereo_tpu_torch import _build
    from i3dr_stereo_tpu_torch.config import params
    from i3dr_stereo_tpu_torch.core import camera
    from i3dr_stereo_tpu_torch.dist.mesh import make_mesh
    from i3dr_stereo_tpu_torch.dist.multihost import measure_scaling
    from i3dr_stereo_tpu_torch.dist.sharded import (
        make_sharded_matcher, make_sharded_pipeline_step)
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene
    from i3dr_stereo_tpu_torch.matchers.registry import compute_disparity

    t0 = time.perf_counter()
    cfg = flagship_cfg(params)
    scenes = [layered_scene(H_FULL, W_FULL, **{**SCENE, "seed": s})
              for s in (1, 2)]
    # the matcher's input: rectified float32 frames, as process gives it
    L = torch.tensor(np.stack([raw_u8(s.left) for s in scenes]),
                     device=DEVICE).float()
    R = torch.tensor(np.stack([raw_u8(s.right) for s in scenes]),
                     device=DEVICE).float()
    card_dev = L.device

    def counted(fn, label, kernels):
        torch.cuda.synchronize()
        _build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        for name in kernels:
            check(launches[name] > 0, f"dist {label}: {name} did not launch")
        return out, launches

    matcher_kernels = [k for k in FLAGSHIP_KERNELS if k != "remap"]
    res_1, _ = counted(lambda: compute_disparity(L, R, cfg), "unsharded",
                       matcher_kernels)
    m11 = make_sharded_matcher(cfg, make_mesh(1, 1, [card_dev]), halo=0)
    res_11, _ = counted(lambda: m11(L, R), "1x1", matcher_kernels)
    check(torch.equal(res_11.disparity, res_1.disparity)
          and torch.equal(res_11.valid, res_1.valid),
          "dist 1x1: not bit-equal to the unsharded run")
    m14 = make_sharded_matcher(cfg, make_mesh(1, 4, [card_dev] * 4),
                               halo=DIST_HALO)
    res_14, launches = counted(lambda: m14(L, R), "1x4", matcher_kernels)
    agree, share, bands, far = dist_agreement(res_14, res_1)
    print(f"dist 1x4 [{card}]: 4 row blocks of {H_FULL // 4} rows + "
          f"{DIST_HALO}-row halos on one card, flagship config, batch 2: "
          f"{agree:.6f} of the pixels valid in both runs and more than "
          f"{DIST_MARGIN} rows from every cut ({share:.4f} of the batch) "
          f"within 1 px of the unsharded run; by rows from the nearest cut "
          f"{', '.join(f'{b}-{b + 7}: {a:.6f}' for b, a in bands)}; 64 or "
          f"more rows {far:.6f}; launches {launches}", flush=True)
    check(agree >= MIN_SHARD_AGREE, f"dist 1x4: agreement {agree} < "
          f"{MIN_SHARD_AGREE} away from the cuts")

    rig = distorted_rig(camera)
    t1 = time.perf_counter()
    RL = raw_views(rig.left, [s.left for s in scenes])
    RR = raw_views(rig.right, [s.right for s in scenes])
    prep = time.perf_counter() - t1
    cloud = params.PointCloudConfig(depth_max=100.0, depth_min=0.5)
    step = make_sharded_pipeline_step(rig, cfg, cloud,
                                      make_mesh(2, 1, [card_dev] * 2))
    out, launches = counted(lambda: step(RL, RR), "2x1 step",
                            FLAGSHIP_KERNELS)
    check(set(out) == {"rect_left", "rect_right", "disparity", "valid",
                       "depth", "depth_valid"}
          and all(tuple(x.shape) == (2, H_FULL, W_FULL)
                  for x in out.values()), "dist step: outputs")
    check(bool(torch.isfinite(out["depth"]).all()), "dist step: depth")
    acc = []
    for i, sc in enumerate(scenes):
        d = out["disparity"][i].cpu().numpy()
        v = out["valid"][i].cpu().numpy()
        both = v & sc.valid
        acc.append((float(v.mean()),
                    float(np.median(np.abs(d - sc.disparity)[both]))))
    print(f"dist 2x1 step [{card}]: raw views of two layered scenes through "
          f"the distorted rig (made in {prep:.1f} s on the host), linear "
          f"remap on each data shard, the flagship matcher, depth: "
          f"(density, median |d - GT| px) {acc}; launches {launches}",
          flush=True)
    for density, med in acc:
        check(density > 0.5 and med < MAX_MEDIAN_ERR,
              f"dist step: density {density}, median error {med}")

    ms = {"unsharded": gpu_ms(lambda: compute_disparity(L, R, cfg), 3, 1),
          "1x1": gpu_ms(lambda: m11(L, R), 3, 1),
          "1x4": gpu_ms(lambda: m14(L, R), 3, 1),
          "2x1 step": gpu_ms(lambda: step(RL, RR), 3, 1)}
    scaling = measure_scaling(
        lambda mesh: make_sharded_matcher(cfg, mesh, halo=0),
        lambda n: (L[:n], R[:n]), [1], iters=3, devices=[card_dev])
    print(f"dist timing [{card}]: ms/frame by events at batch 2 "
          f"{json.dumps({k: round(v / 2, 3) for k, v in ms.items()})}; "
          f"measure_scaling([1]) {json.dumps(scaling)}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    torch.cuda.empty_cache()
    print(f"dist phase done in {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 22: cli bench (i3dr_stereo_tpu_torch/bench.py), every configuration
# ---------------------------------------------------------------------------

# the kernels each configuration's counted call must launch (the flagship
# matcher alone takes rectified images: no remap)
MATCHER_KERNELS = tuple(k for k in FLAGSHIP_KERNELS if k != "remap")
BENCH_KERNELS = {
    "flagship": MATCHER_KERNELS,
    "flagship_flat": MATCHER_KERNELS,
    "sgbm_1280": ("bt_box_cost", "sgm_volume"),
    "bm_640": (),                     # plain torch in both packages
    "pipeline_batch": SGBM_KERNELS,   # the ideal rig is rectified too
    "sgm_direct_2448": ("census_transform", "fused_census_fwd", "sgm_volume",
                        "speckle_ccl"),
    "e2e_2448": FLAGSHIP_KERNELS,
    "stages": FLAGSHIP_KERNELS,
}
BENCH_DIRECT_SHAPE = (512, 640)   # sgm_direct's kernels against its twins
BENCH_TIMEOUT_S = 600


def phase_bench(stats, card):
    """``bench.sgm_direct`` (the ``sgm_direct_2448`` configuration's
    function) with its kernels against the same function on the plain
    twins at 512x640, D = 256: valid masks identical, |dd| <= 1e-4 where
    valid. Then ``python -m i3dr_stereo_tpu_torch.cli bench --config
    all`` in a process of its own at the configurations' full sizes: exit
    code 0, one line a configuration and one a stage, every value above
    0, ``vs_baseline`` null, the card's name and power limit in every
    line, and each configuration's counted call launching its kernels
    (``BENCH_KERNELS``)."""
    import gc

    from i3dr_stereo_tpu_torch import _build, bench

    H, W = BENCH_DIRECT_SHAPE
    l, r = bench._synthetic_pair(H, W)
    L = torch.tensor(l, device=DEVICE)[None]
    R = torch.tensor(r, device=DEVICE)[None]
    torch.cuda.synchronize()
    _build.reset_launches()
    got = bench.sgm_direct(L, R, 256)
    torch.cuda.synchronize()
    launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    for k in BENCH_KERNELS["sgm_direct_2448"]:
        check(launches.get(k, 0) > 0, f"bench sgm_direct: {k} did not "
              f"launch ({launches})")
    want = bench.sgm_direct(L, R, 256, plain=True)
    vk, vp = got != -10000.0, want != -10000.0
    check(torch.equal(vk, vp), f"bench sgm_direct: valid masks differ at "
          f"{int((vk != vp).sum())} pixels")
    dd = (got - want)[vk].abs().max().item() if bool(vk.any()) else 0.0
    print(f"bench sgm_direct [{card}] at {W}x{H}, D = 256, kernels vs "
          f"twins: valid masks identical (density {vk.float().mean():.4f}), "
          f"max |dd| {dd}; launches {launches}", flush=True)
    check(dd <= TOL_DISP, f"bench sgm_direct: |dd| {dd} > {TOL_DISP}")
    del L, R, got, want, vk, vp
    gc.collect()
    torch.cuda.empty_cache()

    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "i3dr_stereo_tpu_torch.cli", "bench",
           "--config", "all"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    took = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print(f"bench line: {line}", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], flush=True)
    check(proc.returncode == 0, f"cli bench --config all: exit code "
          f"{proc.returncode}")
    lines = [json.loads(x) for x in proc.stdout.splitlines()
             if x.startswith("{")]
    want_n = len(bench.BENCHES) + len(bench.STAGES)
    check(len(lines) == want_n, f"cli bench: {len(lines)} lines, expected "
          f"{want_n}")
    check([x["metric"] for x in lines if x["config"] == "stages"][:-1]
          == [f"stage_{k}_ms" for k in bench.STAGES], "cli bench: stage rows")
    name, limit = torch.cuda.get_device_name(0), card.rsplit(",", 1)[-1]
    for x in lines:
        check(x["value"] > 0 and x["vs_baseline"] is None,
              f"cli bench {x['metric']}: value {x['value']}, vs_baseline "
              f"{x['vs_baseline']}")
        check(name in x["device"] and limit.strip() in x["device"],
              f"cli bench {x['metric']}: device {x['device']!r} does not "
              f"name {card!r}")
    last = {x["config"]: x for x in lines}
    check(set(last) == set(bench.BENCHES), f"cli bench: configs "
          f"{sorted(last)}")
    for cfg_name, kernels in BENCH_KERNELS.items():
        got_k = last[cfg_name]["launches"]
        for k in kernels:
            check(got_k.get(k, 0) > 0, f"cli bench {cfg_name}: {k} did not "
                  f"launch ({got_k})")
        if not kernels:
            check(got_k == {}, f"cli bench {cfg_name}: launched {got_k}")
    print(f"cli bench --config all [{card}]: exit 0, {len(lines)} lines in "
          f"{took:.1f} s (its own process, the build loaded)", flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--cameras"]:
        return camera_process(int(sys.argv[2]), int(sys.argv[3]),
                              json.loads(sys.argv[4]))
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from i3dr_stereo_tpu_torch import _build

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    log = (lib.parent / "build.log").read_text()
    for line in log.splitlines():
        if any(k in line for k in ("entry function", "registers", "spill")):
            print("  " + line.strip(), flush=True)

    stats = {k: {"err": 0.0, "ms": None, "plain_ms": None, "launches": 0,
                 "bound_ms": None, "bound_by": None, "library_ms": None}
             for k in SOURCES}
    if "--only" in sys.argv:
        # a quick look at some phases: no kernels line, no result line
        for name in sys.argv[sys.argv.index("--only") + 1].split(","):
            globals()[f"phase_{name}"](stats, card)
        print(f"--only: done in {time.perf_counter() - t_start:.1f} s",
              flush=True)
        return 0
    phase_popc_rate(card)
    phase_kernels(stats, card)
    phase_profile(*phase_main_path(stats, card), card)
    phase_volume(stats)
    phase_profile(*phase_sgbm(stats, card), card, label="SGBM")
    phase_bt_box(stats, card)
    phase_fused(stats, card)
    phase_profile(*phase_lean_flagship(stats, card), card,
                  label="lean flagship")
    pipes, left, right = phase_lean_sgbm(stats, card)
    for name, pipe in pipes.items():
        phase_profile(pipe, left, right, card,
                      label=f"SGBM window-1 {name}")
    phase_direct(card)
    phase_postmatch(stats, card)
    phase_facade(stats, card)
    phase_interp(stats, card)
    phase_bp(stats, card)
    phase_shell(stats, card)
    phase_mapping(stats, card)
    phase_capture(stats, card)
    phase_serve(stats, card)
    phase_dist(stats, card)
    phase_bench(stats, card)
    print(f"whole run {time.perf_counter() - t_start:.1f} s", flush=True)

    for k, st in stats.items():
        check(st["launches"] > 0, f"kernel {k} launched on no main path")
        check(None not in (st["ms"], st["plain_ms"], st["bound_ms"]),
              f"kernel {k} has an unmeasured number")
    for k, st in stats.items():
        b2b = st.get("back_to_back_ms")
        print(f"{k}: {st['bound_ms'] / st['ms']:.0%} of its bound by events"
              + (f", {st['bound_ms'] / b2b:.0%} back to back" if b2b
                 else ""), flush=True)
    kernels = [{"name": k, "route": "cuda", "source": SOURCES[k][0],
                "replaces": SOURCES[k][1], "launches": s["launches"],
                "max_abs_err": s["err"], "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                "bound_by": s["bound_by"], "bound_bytes": s["bound_bytes"],
                "bound_bytes_ms": s["bound_bytes_ms"],
                "bound_ops": s["bound_ops"],
                "bound_popcounts": s["bound_popcounts"],
                "library_ms": s["library_ms"],
                **{x: s[x] for x in s if x.endswith("_ms")}}
               for k, s in stats.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
