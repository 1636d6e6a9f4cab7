"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's ported paths on the card through
``tpu_pathtracer_torch.engine.regen``: the random-spheres headline
(BASELINE config 3: 1200x800, 100 spp, max depth 50), the procedural
staircase (the staircase-toy row of bench.py: 1200x800, 100 spp, max
depth 64; triangle mesh, textures, NEE shadow rays), the asset-scale
staircase (BASELINE config 4, staircase-hires: 154k triangles, the SAH
BVH4 tier) and the dragon-class knot (872k triangles, the heap BVH
tier), also under the knobs that pick the heap tier's other kernels
(mx_leaf, regroup, fast_math, packet_packs with packet_split), and the
entry points of the JAX package's two decision records that no config
reaches: the sphere kernel's mx layout (K2, K3) on the headline's rays
and the packet walk with leaf queues (K12a, K12b) on the dragon's; and
the probes that split K5's time (K13-K16, ``tpu_pathtracer_torch/
experiments``), on the dragon's lanes and on the TPU probes' seeded
inputs, and the TPU micro-benchmarks (K17a-K20, ``experiments/
tpu_micro.py``) on the TPU file's seeded inputs, the regrouped leaf
phase and the 8-row packet probes (K21-K24) on theirs, and the sphere
layout probe (K25a, K25b) and the shape-cast probe (K26) on theirs and,
K25, on the headline's rays; bench.py's four oracle gates against
the port's NumPy oracle; BASELINE config 5's 4K frame through the
checkpoints, and tiles; and the port's bench
(``tpu_pathtracer_torch/bench.py``): bench.py's four zoo frames the
phases above do not render, its stats pass, config 2 and its JSON line.
It builds the CUDA
kernels from ``tpu_pathtracer_torch/csrc`` first and holds each against
its plain PyTorch version at the shapes its path gives it. Phases, one
line each; any failure raises and exits non-zero:

  1. device: the nvidia-smi name and power limit, torch and CUDA versions;
  2. build: nvcc builds spheres.cu, spheres_mx.cu, tris.cu, bvh.cu,
     bvh4.cu, bvh_mx.cu, bvh_rg.cu, bvh_mr.cu and the probes'
     iter_ablate.cu, leafmt_probe.cu, dma_probe.cu, dual_probe.cu,
     tpu_micro.cu, regroup_probe.cu, multirow_probes.cu,
     sphere_layout_probe.cu and shapecast_probe.cu side by side,
     g++ the native BVH builder (seconds, ptxas lines);
  3. spheres, kernel vs plain on the 960,000 primary rays of sample 0 and
     on the second-bounce rays, in all three modes, with the view's table;
     times (CUDA events, median of 7 warm runs); K1 also timed on the
     middle 32,768 rays of each set, the lane pool the regen engine
     launches it on, as the frame calls it (the view's table, a float
     t_max): a call's device time in a CUDA graph beside its bound and its
     issue-rate floor (the SASS the kernel issues for the pairs it tests
     and the pairs with disc > 0, where it takes the roots);
 3b. the mx layout on the same two ray sets and on their middle 32,768
     rays (the pool's shape): K2 (nearest + features) and K3 (any-hit)
     through ``spheres_hit_feat``/``spheres_anyhit_soa(mx=True)``, counts
     from 0; each within the bound of its plain version (the tensor
     cores sum the split products in their own order: each product within
     MX_ULPS x 2^-24 x the sum of its products' magnitudes, carried
     through the roots; every lane whose winner or occlusion differs is
     one the bound can flip, t within it where the winners agree; the
     counts printed; K3 at t_max FLT_MAX occluded exactly where K2 hits),
     and at the pool the products mode's c.d and o.c
     within that bound; against K1 and K1c at full size (winners agree on
     > 0.995 of the lanes, each departure a lane the split's error can
     flip; t within 5e-3 relative plus that error and features equal
     where they agree; occlusion on > 0.999); at both shapes a call's
     device time in a CUDA graph, in turns with K1 and K1c, beside the
     bound (the products at the bf16 tensor-core peak, the FP32 epilogue
     at 67 TFLOP/s, the bytes: the largest) and the issue-rate floor of
     the kernel's SASS, counted from this run's build (``cuobjdump``);
  4. spheres end to end, small: 96x64, 4 spp, max depth 8, kernel vs
     plain: rmse < 5e-3, SSIM >= 0.99;
  5. spheres end to end, full size, through the kernel: the bench's
     headline frame (``bench.run_frame``: a 1 spp warm-up, one render
     timed by CUDA events, the 128x128 center crop against the committed
     TPU-rendered golden assets/bench_spheres_100spp.ref at rmse < 5e-3,
     SSIM >= 0.99): seconds, Mpaths/s, regen iterations, launches;
  6. triangles, kernel vs plain at the staircase's shapes (primary,
     second-bounce and NEE shadow rays), all three modes, on all 960,000
     lanes and on the middle 32,768 (the lane pool): idx equal on every
     lane, t, u, v, features and occlusion bit-equal; times as in phase 3
     at both shapes;
  7. staircase end to end, small, kernel vs plain, as phase 4;
  8. staircase end to end, full size, as phase 5: the bench's
     staircase-toy frame against assets/bench_staircase_toy_100spp.ref;
  9. BVH4 (K8 nearest, K9 any-hit) vs plain on staircase-hires: 131,072
     primary rays from across the 1200x800 frame, the same lanes'
     second-bounce rays and their first bounce's NEE shadow rays (lanes
     without one at t_max = -1): t bit-equal, ids equal except exact
     ties, occlusion and per-ray counters equal; times as in phase 3; the
     distinct node rows and leaves the plain walk read (its bytes bound);
     the same checks on the frame's own shape, the 131,072 contiguous
     middle-row primary rays of one regen iteration's lane pool and their
     NEE rays; on all five sets each mode's device time a call in a CUDA
     graph beside its bound and its issue-rate floor (the SASS the
     kernel issues for the run's node steps, leaf visits and slots);
 10. heap BVH (K5, K6) vs plain on the dragon-class knot, in the same way,
     also on the frame's shape, the 196,608 contiguous middle-row pixels
     of the dragon's lane pool and their NEE rays; each mode's device time
     a call in a CUDA graph at 131,072 and at the pool beside its bound and
     issue-rate floor, as phase 9's (exact and fast_math);
     then on the same lanes the heap tier's variants: the MXU-leaf kernels
     (K10 nearest, K10b any-hit; the kernel's t, winners, occlusion and
     counters bit-equal, also on the frame's shape, the 196,608 contiguous
     middle-row pixels of the dragon's lane pool and their NEE rays; each
     mode's device time a call in a CUDA graph at 131,072 and at the pool
     beside its bound and issue-rate floor, as phase 9's), with where K10
     departs from the exact K5 at 3 and 6 passes (winners a neighbour of
     K5's, pass-throughs, extra hits, each counted and bounded; K10b's
     occlusion flips counted); the
     regrouped kernel (K11: t, winners and counters bit-equal, also on the
     pool's 196,608 contiguous middle-row primary rays; its leaf visits
     within [1, 1.5]x K5's; K5 and K11 in turns, device time a call in a
     CUDA graph; K11's device time a call in a CUDA graph at 131,072 and
     at the pool beside its bound and issue-rate floor, as phase 9's) and
     K5/K6's fast_math mode against the
     exact plain walk, on phase 10's sets and the pool's (t within 2^-20
     relative where the winners agree; winners, hits and occlusion equal
     except on lanes with a triangle whose exact u, v, u+v, t or |a| lies
     within 2^-20 of an accept bound, counted);
 10c. the packet walk on the same primary and NEE lanes and on the
     pool's two sets (196,608 lanes): K12a (``mr_trace``) and K12b
     (``mr_occluded``), counts from 0; t, winners, features, occlusion
     and per-packet counters bit-equal to the plain walk; t and
     occlusion equal to K5's and K6's, winners but exact ties; each
     mode's device time a call in a CUDA graph at both shapes, in turns
     with K5 and K6 (MR_ROUNDS rounds); the per-packet distribution of
     node rounds, leaf rounds and leaf visits (mean, median, p99, max;
     the widest 1% of the packets' share of the leaf visits) beside K5's
     steps and leaf visits per ray; the bound is K5's and K6's (the same
     function on the same lanes), the packet walk's own work beside it,
     and the issue-rate floor of the build's own SASS (a slot, a node
     round, a merge: ``bvh_mr_ab.mr_sass`` on its ``cuobjdump -sass``)
     for the run's rounds;
 10d. the walk probes on the same primary lanes and the dragon's
     196,608-lane pool, counts from 0: K13 (``iter_ablate.ablate_trace``,
     modes full, nomt, noleaf, walked as K5 walks; acc and per-ray
     counters bit-equal to the plain walk, the counters equal across
     modes) with no culling and at K5's hit t, each mode's device time a
     call in a CUDA graph in turns with K5, beside its bound and the
     issue-rate floor of the build's SASS (``iter_ablate.mode_sass``;
     each mode must keep its leaf round's shuffles, K13_SHFL), and the
     split of its time into node walk (noleaf), leaf-row fetch (nomt -
     noleaf) and leaf arithmetic (full - nomt); K16
     (``dual_probe.dual_steps`` at R = 1, 2, 4 rays a thread in one
     persistent wave of the same warps an SM, rays refilled lane by lane
     from their warp's claims on a counter; step counts bit-equal to the
     plain node phase, also past every R's first wave of rays),
     device time a call in a CUDA graph in turns, beside its warps an
     SM (equal at every R, checked), the issue-rate floor of the build's
     SASS (``dual_probe.walk_sass``: the refill's atomic checked) and the
     latency floor with K17a's round trips measured in the phase;
 11. small: staircase-hires 96x64, 4 spp, depth 8, kernels vs plain, and
     with bvh4=False (through K5/K6) against the BVH4 render;
 12. config 4: the bench's staircase-hires frame, 1200x800 at 2 spp,
     as phase 5 against assets/bench_staircase_hires_2spp.ref, then 100
     spp depth 64 on the warm frame (``bench.render_timed``): seconds,
     Mpaths/s, regen iterations, launches of each kernel, mean;
 13. dragon: the bench's dragon frame, the 872k knot 512x512, 4 spp,
     depth 50, untextured, as phase 5 against
     assets/bench_dragon_4spp.ref; then the same frame
     under mx_leaf, regroup, fast_math and packet_packs=2 with
     packet_split, each timed, its launches read (the variant's kernels
     ran, the default heap kernel it replaces did not, and no frame
     launched the packet walk), gated against the golden and held
     against the default frame: packet_packs bit for bit,
     regroup rmse < 1e-4, fast_math SSIM >= 0.999, mx_leaf SSIM >= 0.999
     and rmse < 2e-3 (MX_FRAME_RMSE), also on two more sample windows,
     and at mx_passes=6 closer to the default than at 3;
 14. profile: one sample per pixel of config 4's frame, of the
     staircase-toy's, of the headline's, of the dragon's and of the
     dragon's under mx_leaf and under regroup, over their middle rows, two
     lane pools' worth of pixels (the profiler's cost grows with the
     kernels it records), under torch.profiler: host dispatches and device
     kernel time per regen iteration, the device's busy share, the kernels
     that take most (and by name config 4's BVH4 kernels, the
     staircase-toy's triangle kernels, the headline's sphere kernel, the
     dragon's K5 and K6, under mx_leaf K10 and K10b, and under regroup K11
     and K6).
     All run after phase 13, the last timed frame: a profiler session
     slows the host's launches in the rest of the process;
 15. the leaf-fetch probes on the TPU probes' seeded inputs, counts from
     0: K14 (``leafmt_probe.leafmt_run``, modes pure, cond, dma, db, db2;
     a visit tested by the warp in K5's split, db's ring filled by the
     bulk-copy engine) bit-equal to its plain version at one 1024-ray
     tile (V = 1024 and 17,408) and at the dragon's 196,608-lane pool (V
     = 128 and 1,152), and K15 (``dma_probe.dma_chain``, sync and db, a
     bulk copy on an mbarrier a cluster) at k = 16,384 and 131,072
     copies; then timed in turns, device time a call in CUDA graphs, each
     beside its bound and the issue-rate floor of the build's SASS: ns a
     visit and a slot, the B-17 reading (dma - pure, dma - db), ns a copy
     and the latency the prefetch hides;
 16. the TPU micro-benchmarks on the TPU file's seeded inputs, counts from
     0 (``tpu_micro.measure``): K17a (the per-lane gather, modes l2 and
     smem; smem's row staged by one bulk copy on an mbarrier, its SASS
     checked by ``tpu_micro.gather_sass``: one UBLKCP, one
     SYNCS.PHASECHK, no staging loop; held on every E3 case of
     tests/micro_cases.py) and K17c (the one-hot fetch: the table's bf16 view built in
     each call by its own kernel, then one 16 B row a lane a step) at the
     TPU's lanes and at 131,072, K17b (the row broadcast and block vote:
     one block, one barrier a step, every warp summing the group partials
     itself; NaN-propagating maxima), first held bit-equal to their plain
     versions (NaN equal to NaN) on every case of tests/micro_cases.py,
     K17c's non-finite tables refused, K17b's step loop checked for one
     block-wide barrier and K17c's for one 16 B load
     (``tpu_micro.vote_sass``, ``onehot_sass``), K18
     (the 8 KB copy chain, the next block from the copied data: one warp,
     one bulk copy on an mbarrier a step; its chain loop's SASS checked
     for the bulk copy and the wait, ``tpu_micro.copy_sass``), K19 and K20
     (a chain of 128-triangle leaves over the card, 128 blocks each with
     a warp that tests ray 0 and walks the chain: K19's clusters staged
     by the bulk-copy engine and read as broadcasts, K20's by per-lane
     loads; first held bit-equal on every case of tests/leaf_cases.py,
     their SASS checked by ``tpu_micro.leaf_sass``, UBLKCP and
     SYNCS.PHASECHK in K19 and in K20 neither, and each launch more than
     one block), each bit-equal to its plain version at 3 steps and at the
     lower count of its pair, then timed in turns at the TPU file's pairs,
     device time a call in a CUDA graph: ns a step, a lane-step (K17b and
     K17c beside the issue-rate floor of their step loops and a latency
     floor: one warp's step and K17a's round trip of the memory it reads,
     this run's; K17b beside the bytes of the rows its chain visits, K17c
     beside its view build's own time, a record of its own), a copy
     (beside K18's issue-rate floor) and a leaf (beside the issue-rate
     floor of the build's leaf loops and the chain's latency floor: its
     step's issue and K18's copy or K17a's L2 round trip, both this
     run's); one torch.gather at the same lanes beside K17a and K17c;
 17. the regrouped leaf phase and the 8-row packet probes on the TPU
     files' seeded inputs, counts from 0: K21 (``regroup_probe``, modes
     ct, g, ray, tri, mt, full; the clusters staged by the bulk-copy
     engine, each ray's winner merged in slot order; its SASS checked for
     UBLKCP and SYNCS and against any shared-memory atomic,
     ``regroup_probe.mode_sass``) on one window, at 4 and 1028 windows
     repeated in one block, and card-wide (132 x 8 blocks of one window),
     device time a call in CUDA graphs, each mode beside its bound and the
     issue-rate floor of the build's SASS;
     K22 (``leafround_probe``, LEAF_MODE 0, 1, 2 at w = 32, 64; 256 and
     2048 rounds), K23 (``multirow_probe``, fixed and assemble; 64 and 512
     steps) and K24 (``gather_probe``, lanes and shfl at S = 8 to 128; 1024
     and 8192 steps), first their SASS (``multirow_probe.round_sass``,
     ``walk_sass``; K22's mode 2 with UBLKCP and SYNCS, modes 0/1 with
     neither), every launch over more than one block, and every case of
     tests/multirow_cases.py (``multirow_checks``), then each bit-equal to
     its plain version (K23/K24 also on every step's idx and bs) at 0, 1,
     3, 17 (and 64) and the pair's lower count, timed in turns at the
     pair: us a window and ns a pair, ns an 8-row leaf round, ns an 8-row
     node step, beside the bound (the FP32 operations; bytes with each
     distinct cluster or node pair once), the issue-rate floor of the
     build's SASS and the chains' latency floors (K22: the producer's
     step, + K15a's copy round trip in mode 2; the walk: a step's issue on
     one warp, + K17a smem's dependent on-chip load but in fixed, K17a
     l2's beside it; the trips from phases 15 and 16 of this run); K22's
     mode 0 must read no slower a round than its mode 2 at each width;
 18. the sphere layout and shape-cast probes, counts from 0: K25a
     (``sphere_layout_probe.spheres_sb``, the sphere table in constant
     memory) and K25b (``spheres_sbf``, + the feature fetch) on the TPU
     file's 16,384 rays and on the headline's 960,000 and 32,768-lane
     pool primary rays of sample 0 and their live bounce-2 rays, each
     bit-equal to its plain version and to K1 (t, idx; K25b's features to
     K1's, 0 on a miss), device time a call in a CUDA graph in turns with
     K1 and the table's copy alone, beside the bound (the pairs' FP32
     operations, the roots only where disc > 0) and the issue-rate floor
     of the build's slot loop (``sphere_layout_ab.slot_sass``); K26
     (``shapecast_probe.shapecast``), all 15 cases bit-equal to their plain
     versions alone and in one launch, each case's launch and the launch
     of all 15 timed;
 19. bench.py's four on-hardware oracle gates (``_oracle_gate``, :85) at
     its shapes and bounds, from the bench's table (``bench.ORACLE_GATES``,
     each rendered and checked by ``bench.finish_oracle_gate``): spheres
     96x64, 4 spp, depth 8 (rmse < 5e-3, SSIM >= 0.99); staircase_mesh 96x64, 4 spp, depth 8; rocks_packet
     (``rocks_zoo_scene(n_big=2, n_small=3, seed=9)``) and knot_packet
     (``knot_zoo_scene(nu=48, nv=24)``) 64x48, 4 spp, depth 8, untextured,
     ``packet_threshold=1`` (rmse < 1e-2, SSIM >= 0.97): each frame
     rendered on the card through its tier's kernels (K1; K4/K4c; the
     BVH4 tier K8/K9 for the rocks, the heap tier K5/K6 for the knot) and
     held against ``tpu_pathtracer_torch.oracle`` of the same scene, read
     to the host. The oracles run in four host processes started after
     phase 2, beside phases 3-13 and 20 (the rocks' takes minutes);
 20. BASELINE config 5's frame, the staircase at 3840x2160, depth 64,
     through ``utils.checkpoint.render_with_checkpoints`` with batch 1:
     straight to 2 spp, and to 1 spp then resumed from its file to 2 spp,
     bit-equal (image and sum buffer); a file whose fingerprint was
     changed is refused; seconds a spp at 4K, Mpaths/s and the 1000 spp
     extrapolation; K4/K4c's launches a 4K spp (``launches_config5_spp``
     in their records). Then the staircase-toy's frame (1200x800, 2 spp,
     depth 64) through ``parallel.tiles.render_image_tiled_regen`` in two
     stripes of the card against one render, within 1e-6
     (tests/test_parallel.py:52-60). The sample counts are cut from 1000
     and 100 to 2. Phase 20 runs after phase 13;
 21. the port's bench (``tpu_pathtracer_torch/bench.py``): bench.py's four
     frames no phase above renders, through the bench's frame entries
     (``bench.run_frame``: a 1 spp warm-up, one timed render, the crop
     gate at rmse < 5e-3, SSIM >= 0.99) at full size: knot-102k (16 spp)
     and terrain-168k (8 spp) on the f32 BVH4 tier, terrain-big-668k (4
     spp) on the quant BVH4 tier, rocks-845k (4 spp) on the heap tier,
     each 512x512, depth 50, untextured; each frame's tier and launch set
     checked, its seconds and launches of each kernel printed (K8/K9's
     and K5/K6's records carry them as ``launches_<frame>``); the stats
     pass on the headline (``bench.path_stats``, 300x200, 4 spp), its
     regen Stats equal to the plain engine's (``render_image(...,
     report_stats=True)``), and rays a path; config 2 (10 spp) on the
     warm headline (K1's ``launches_config2``); then the bench's JSON line
     (``bench.bench_line``) over phase 21's readings and phases 5, 8, 12
     and 13's, its numbers finite and positive (its keys are held to
     bench.py's by tests/test_torch_bench.py). Phase 21 runs
     after phase 20 and before phase 19, which waits for the last
     oracle; all three run before phase 14's profiles;
 22. the twelve decision experiments (``tpu_pathtracer_torch/
     experiments``: pool_probe, crossover, knot_tier_ab, terrain_big_ab,
     dragon_bvh4_ab, width_e2e_ab, width_e2e, width_sweep, sah_vs_median,
     sah_vs_median_stairs, zoo_table, converged_oracle), each function
     once at its script's scenes and resolutions, 1 spp and one timed
     render an arm (the converged oracle at 8 spp against the port's
     oracle, rendered in phase 19's host processes): each arm's tier and
     its timed render's launch set checked against ``TIER_KERNELS``, the
     whole call's too; the images at the three lane pools and at both
     packet widths bit-equal; the arms on other tiers or builders of one
     scene (crossover's brute and BVH4, the knot's BVH4 and heap, the
     terrain-big and dragon quant BVH4 and heap, median and SAH) within
     rmse 1e-5; knot_tier_ab's means equal to 6 digits; the converged
     oracle at rmse < 5e-3, SSIM >= 0.99; seconds, regen iterations and
     launches of each arm printed (the records of K1, K4/K4c, K8/K9 and
     K5/K6 carry each experiment's launches as ``launches_<module>``).
     Phase 22 runs after phase 21 and before phase 19, beside the rock
     pile's oracle.

Each full-size run, and each run of phases 3b, 10c, 10d, 15-22's entry
points, resets the launch counts just before it and reads them just after
(the headline frame must launch no mx kernel, and no frame a probe's).
Every kernel's record carries its bound: the larger of its FP32
operations (counted from the source and this run's inputs, for the BVH
kernels from the node steps and leaf slots its counters report) over 67
TFLOP/s and its bytes (inputs read once, outputs written once; of a BVH's
tables only the distinct node rows and leaf triangle rows this run's rays
read; K15: the bytes it copies) over 3.35 TB/s. The line before
the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Needs a CUDA device: without one it
exits non-zero and prints no result. Imports nothing of JAX.
"""

import collections
import concurrent.futures
import contextlib
import functools
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time
import typing
from unittest import mock

import numpy as np
import torch

from tpu_pathtracer_torch import bench, native
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine import wavefront as wf
from tpu_pathtracer_torch.engine.regen import (_pool_size,
                                               render_image_regen,
                                               render_regen)
from tpu_pathtracer_torch.engine.render import render_image
from tpu_pathtracer_torch.experiments import bvh_mr_ab as mr_ab
from tpu_pathtracer_torch.experiments import converged_oracle as cvo
from tpu_pathtracer_torch.experiments import crossover as co
from tpu_pathtracer_torch.experiments import dma_probe as dm
from tpu_pathtracer_torch.experiments import dragon_bvh4_ab as db
from tpu_pathtracer_torch.experiments import dual_probe as dp
from tpu_pathtracer_torch.experiments import gather_probe as gp
from tpu_pathtracer_torch.experiments import iter_ablate as ia
from tpu_pathtracer_torch.experiments import knot_tier_ab as kt
from tpu_pathtracer_torch.experiments import leafmt_probe as lm
from tpu_pathtracer_torch.experiments import leafround_probe as lr
from tpu_pathtracer_torch.experiments import multirow_probe as mr
from tpu_pathtracer_torch.experiments import pool_probe as pp
from tpu_pathtracer_torch.experiments import regroup_probe as rp
from tpu_pathtracer_torch.experiments import sah_vs_median as sm
from tpu_pathtracer_torch.experiments import sah_vs_median_stairs as sms
from tpu_pathtracer_torch.experiments import shapecast_probe as scp
from tpu_pathtracer_torch.experiments import common
from tpu_pathtracer_torch.experiments import sphere_layout_ab as lab
from tpu_pathtracer_torch.experiments import sphere_layout_probe as slp
from tpu_pathtracer_torch.experiments import spheres_mx_ab as mx_ab
from tpu_pathtracer_torch.experiments import terrain_big_ab as tb
from tpu_pathtracer_torch.experiments import tpu_micro as um
from tpu_pathtracer_torch.experiments import width_e2e as we
from tpu_pathtracer_torch.experiments import width_e2e_ab as wab
from tpu_pathtracer_torch.experiments import width_sweep as ws
from tpu_pathtracer_torch.experiments import zoo_table as zt
from tpu_pathtracer_torch.experiments.arms import Reading
from tpu_pathtracer_torch.experiments.common import (ISSUE_RATE, distinct,
                                                      first_bounce,
                                                      graph_ms,
                                                      graph_rounds,
                                                      sphere_pairs)
from tpu_pathtracer_torch.models.mesh import procedural_staircase_scene
from tpu_pathtracer_torch.models.spheres import random_spheres_scene
from tpu_pathtracer_torch.ops import _build
from tpu_pathtracer_torch.ops import cuda_bvh as cb
from tpu_pathtracer_torch.ops import cuda_bvh4 as cb4
from tpu_pathtracer_torch.ops import cuda_bvh_mr as cmr
from tpu_pathtracer_torch.ops import cuda_bvh_mx as cmx
from tpu_pathtracer_torch.ops import cuda_bvh_rg as crg
from tpu_pathtracer_torch.ops import cuda_spheres as cs
from tpu_pathtracer_torch.ops import cuda_tris as ct
from tpu_pathtracer_torch.ops.v3 import V3
from tpu_pathtracer_torch.ops.vec import FLT_MAX
from tpu_pathtracer_torch.utils import golden

SMALL = dict(nx=96, ny=64, ns=4, max_depth=8)
BVH_RAYS = 131_072
POOL = 1 << 15  # the regen engine's lane pool off the packet path
RMSE_TOL, SSIM_MIN = bench.RMSE_TOL, bench.SSIM_MIN  # the crop gate's
T_RTOL = 2.0 ** -22              # 2 ulp: -fmad=false makes t bit-equal
# H100 SXM peaks (NVIDIA's data sheet, at the full 700 W)
FP32_FLOPS, HBM_BYTES = common.FP32_RATE, common.HBM_RATE
# FP32 operations counted from the kernels' sources (compares not
# counted): a ray-sphere pair (spheres.cu: the oc differences, the two
# 3-term dots, - r2 and disc) and the roots where disc > 0 (the sqrt
# counted as one, -b - sq, -b + sq), a ray-triangle slot (bvh_common.cuh
# mt_hit, its division counted as one), a slab test
SPHERE_PAIR_FLOPS, SPHERE_ROOT_FLOPS = 16, 3
MT_FLOPS, SLAB_FLOPS = 37, 12
# bvh_mx.cu: a slot's 19 x passes products and sums (G's bf16 parts come
# built by mx_tables), 4 combined sums (2 or 5 adds each), f, t, u, v and
# u + v; a ray's F: 9 operations and 10 three-part splits
MX_SLOT_FLOPS = {3: 19 * 3 * 2 + 4 * 2 + 5, 6: 19 * 6 * 2 + 4 * 5 + 5}
MX_RAY_FLOPS = 9 + 10 * 5
# spheres_mx.cu: a pair's two split products are 18 multiply-adds on the
# tensor cores (36 operations at the bf16 peak); its FP32 epilogue b,
# |o|^2 - 2 o.c (2 o.c comes from the mma), + ccq, b*b and disc is 5,
# and 3 more (sqrt, the two roots) where disc > 0; a ray's o.d and |o|^2
# (5 each) and its 6 values' splits (3 each). The first form summed the
# products on the FP32 units: 2 x 17 + 10 a pair (0.307 ms at 960,000
# rays x 486 spheres, PERF.md)
MX_SPHERE_MMA_FLOPS, MX_SPHERE_FLOPS, MX_ROOT_FLOPS = 36, 5, 3
MX_SPHERE_RAY_FLOPS = 2 * 5 + 6 * 3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
# K2 against K1 on the headline's lanes: the share of lanes whose winner
# agrees. The JAX bound is 0.999 (tests/test_fast_math.py:55), measured
# there with exact f32 products (C-15). With the split an NVIDIA H100
# 80GB HBM3 (700 W) reads 0.99794 on all 960,000 primary lanes and
# 0.99917 on all 811,193 bounce-2 lanes (the same in two runs), so 0.999
# fails on the split's own departures; 0.995 allows 2.4x the departures
# of the worse reading. Each departing lane must also be one the split's
# error can flip (cuda_spheres.mx_error).
MX_AGREE = 0.995
MX_T_REL = 5e-3  # tests/test_fast_math.py:59, plus the split's error
TRI_ROW_BYTES = 48  # a [T, 12] f32 triangle row: v0, e1, e2, n
# The issue rate an H100 SXM reaches at most: one warp instruction a
# scheduler a cycle, 4 schedulers on each of its 132 SMs, at the 1,980 MHz
# maximum SM clock. csrc/bvh4.cu's SASS for sm_90a (cuobjdump -sass of the
# library built on an H100, rounded): the lane instructions of a slot
# test (the unrolled leaf loop's body over its slots), of a node step
# (its loads, four slab tests, the rank and the pushes) and of a leaf
# visit's broadcast, merge and pop (a round's, times the visit's lanes:
# 8 nearest, 16 any-hit), in each mode (ISSUE_RATE: experiments/common.py)
BVH4_SASS = {"nearest": (80, 210, 140 * 8), "any_hit": (75, 210, 82 * 16)}
# csrc/spheres.cu's SASS for sm_90a, the nearest modes' unrolled slot
# loop (cuobjdump -sass of experiments/spheres_ab.py --out, counted on
# an H100's build): the lane instructions of a pair, and those it adds
# where disc > 0 (the IEEE sqrtf's fast path, the roots, the compares and
# the selects)
SPHERE_SASS = (21, 18)
# what a slot's leaf test reads of its [T, 64] bf16 row of G's parts at 3
# passes: hi and mid, 20 entries each
MX_ROW_BYTES = 2 * 2 * cmx.G_COLUMNS
# csrc/bvh_mx.cu's SASS for sm_90a at 3 passes (cuobjdump -sass of
# experiments/bvh_mx_ab.py --out, counted on an H100's build, rounded), as
# BVH4_SASS: the lane instructions of a slot test (the leaf loop's body,
# the division's slow path not taken), of a node step (with the walk
# loop's ballots) and of a leaf visit's F reads, merge or ballot and pop
# (a round's, times the visit's lanes: 16 nearest, 32 any-hit)
MX_SASS = {"nearest": (195, 105, 170 * 16), "any_hit": (196, 105, 82 * 32)}
# csrc/bvh.cu's SASS for sm_90a (cuobjdump -sass of experiments/bvh_ab.py
# --out, counted on an H100's build), as BVH4_SASS: the lane instructions
# of a slot test (the leaf loop's body, the division's slow path not
# taken; fast_math's loop is unrolled twice), of a node step (the walk
# loop without its leaf phase: the step, the ballots, the loop) and of a
# leaf visit's shuffles, merge or ballot and pop (a round's, times the
# visit's lanes: 16 nearest, 32 any-hit), in each mode and arithmetic
HEAP_SASS = {"nearest": (68, 117, 146 * 16), "any_hit": (71, 112, 62 * 32),
             "nearest_fast_math": (58, 117, 152 * 16),
             "any_hit_fast_math": (61, 112, 62 * 32)}
# csrc/bvh_rg.cu's SASS for sm_90a (cuobjdump -sass of
# experiments/bvh_rg_ab.py --out, counted on an H100's build), as
# HEAP_SASS: the lane instructions of a slot test (half the leaf loop's
# body, which tests a slot of each of a window's two leaves; the
# division's slow path not taken), of a node step (the walk loop without
# its leaf phase) and of a leaf visit: half a window's pass (its
# shuffles, the lanes' merges and the commit, 140 a lane, times the
# window's 32 lanes) and the visit's record
RG_SASS = {"nearest": (72, 108, 70 * 32 + 16)}
MX_POOL = 3 << 16  # the dragon frame's lane pool (engine/regen.py)
MR_ROUNDS = 3  # phase 10c's rounds of K12a/K12b and K5/K6 in turns
FAST_DELTA = 2.0 ** -20  # fast_math: the bound on t and on accept flips
# K10 against the exact K5: the share of the hits whose winner may
# differ (2048-lane patches of the dragon's tessellation on the CPU read
# 0.4-1.1% at 3 passes and at most 0.1% at 6, tests/test_torch_bvh_mx.py;
# the dragon's 131,072 lanes 0.46-0.50% and 0.016-0.027%, PERF.md)
MX_DEPART = {3: 0.05, 6: 0.005}
NO_LIBRARY = None  # no single PyTorch call computes these hits
OPS = "tpu_pathtracer/ops/"  # where the JAX package's TPU kernels live
DRAGON_KNOBS = (  # (setting, bound against the default dragon frame)
    # K7's knobs only schedule the TPU's packets: the port computes them
    # with K5/K6, so this frame checks the config's plumbing (the knobs
    # reach the engine and leave the route and the image as they are),
    # not a kernel
    (dict(packet_packs=2, packet_split=True), "bit-identical"),
    (dict(regroup=True), "rmse < 1e-4 (tests/test_packet_rg.py:150)"),
    (dict(fast_math=True), "SSIM >= 0.999 (config.py:250-252)"),
    # the JAX package has no test of this path: the golden's SSIM bound
    # tightened tenfold, and rmse at MX_FRAME_RMSE
    (dict(mx_leaf=True), "SSIM >= 0.999 and rmse < 2e-3"),
)
# mx_leaf's frame against the default one. Its split-bf16 test departs
# from the exact walk on ~0.5% of the hits (phase 10), near an edge or at
# grazing incidence, as the JAX kernel does (tests/test_torch_bvh_mx.py),
# and a path through a crack changes its pixel a lot: three 4-sample
# windows of the frame read 7.8e-4 to 9.7e-4 (PERF.md). The bound leaves
# twice that, so a change that reshuffles which paths meet a crack stays
# under it; doubling the rmse takes about four times the departures,
# which phase 10 bounds at 10x the reading.
MX_FRAME_RMSE = 2e-3
# bench.py's readings, for the bench line phase 21 prints: the timed
# renders' seconds of phases 5, 8, 12, 13 and 21 by the bench's frame
# names (tpu_pathtracer_torch/bench.py FRAMES), config 2's and config 4's,
# and rays a path
BENCH_READINGS = {}


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def phase_seconds(number, t0):
    """Print phase ``number``'s seconds since ``t0`` (the phases that do
    not print their own: 1-14); returns the time now, the next phase's
    start."""
    now = time.perf_counter()
    phase("seconds", f"phase {number} in {now - t0:.1f} s")
    return now


def cuda_ms(fn, reps=7):
    """Median milliseconds of ``fn`` on the current stream, warm."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def pool_rays(*vs):
    """The middle POOL lanes of each V3 or tensor of a 1200x800 ray set:
    the shape the regen engine launches the kernels on."""
    n = (vs[0].x if isinstance(vs[0], V3) else vs[0]).shape[0]
    lo = (n - POOL) // 2
    cut = lambda c: c[lo:lo + POOL].contiguous()
    return [V3(*map(cut, v)) if isinstance(v, V3) else cut(v) for v in vs]


# (ms, "operations" or "bytes"): the least time the card could take, the
# larger of flops over its FP32 rate and bytes over its memory rate
bound = common.roofline


def record(name, source, replaces, launches, err, ms, plain_ms, bnd):
    """A kernel's JSON record; ``replaces`` is the TPU kernel's path in
    the repo and its line."""
    return {"name": name, "route": "cuda",
            "source": f"tpu_pathtracer_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": NO_LIBRARY}


def ties_within_ulp(origin, direction, tab, ik, ip, lanes, t_min, t_max):
    """True if on every lane in ``lanes`` the kernel's and the plain
    version's winners have t values within 1 ulp (a tie the two may
    break differently)."""
    for j in lanes.tolist():
        if min(int(ik[j]), int(ip[j])) < 0:
            return False  # a hit against a miss is no tie
        one = lambda v: V3(*(c[j:j + 1] for c in v))
        rows = tab[torch.stack([ik[j], ip[j]]).long()]
        ts = cs._sphere_ts(one(origin), one(direction), rows, t_min,
                           torch.full((1,), t_max, device=tab.device))[0]
        if torch.nextafter(ts.min(), ts.new_tensor(np.inf)) < ts.max():
            return False
    return True


# the kernels each tier launches (bench.tier, from wavefront.mesh_tier)
TIER_KERNELS = {"spheres": {"cuda_spheres"},
                "brute": {"cuda_tris.features", "cuda_tris.any_hit"},
                "bvh4": {"cuda_bvh4.nearest", "cuda_bvh4.any_hit"},
                "quant-bvh4": {"cuda_bvh4.nearest", "cuda_bvh4.any_hit"},
                "heap": {"cuda_bvh.nearest", "cuda_bvh.any_hit"}}
# K13-K26: on no frame's path
PROBE_MODULES = (ia, lm, dm, dp, um, rp, lr, mr, gp, slp, scp)


def checked(tag, expect, fn, *args):
    """``fn(*args)``, a call of the bench that renders on the card and
    returns its ``Timed`` (itself or as ``.timed``), with the launch
    counts of every frame and probe kernel set to 0 just before it and
    read just after: the kernels its timed render launched, and those the
    whole call launched, must be ``expect``."""
    bench.reset_launches()
    bench.reset_launches(PROBE_MODULES)
    out = fn(*args)
    ran = {**bench.read_launches(), **bench.read_launches(PROBE_MODULES)}
    timed = getattr(out, "timed", out)
    if set(ran) != set(expect) or set(timed.launches) != set(expect):
        raise AssertionError(f"{tag}: launched {ran} (timed render "
                             f"{timed.launches}), not {sorted(expect)}")
    return out


def frame_run(where, tag, name, built, expect, cfg=None):
    """The bench's frame ``name`` through ``bench.run_frame`` (a 1 spp
    warm-up, the timed render, the crop gate against its TPU golden) on
    the scene ``built``, under ``cfg`` if given, its launch set checked;
    prints its line under phase ``where``. Returns the bench's
    FrameRun."""
    run = checked(tag, expect, bench.run_frame, bench.FRAMES[name], built,
                  cfg)
    t, cfg, spp = run.timed, run.cfg, run.frame.spp
    phase(where, f"{tag} {cfg.nx}x{cfg.ny} {spp} spp depth "
          f"{cfg.max_depth}: {t.seconds:.3f} s (CUDA events; host wall "
          f"{t.wall:.3f} s), {cfg.num_pixels * spp / t.seconds / 1e6:.3f} "
          f"Mpaths/s, {t.iters} regen iterations "
          f"({t.seconds / t.iters * 1e3:.2f} ms each), kernel launches "
          f"{t.launches}, mean {t.image.mean():.4f}; crop vs TPU golden "
          f"rmse {run.rmse:.3e} ssim {run.ssim:.6f}")
    return run


def small_renders(tag, scene, cam, cfg, patches):
    """``cfg`` rendered through the kernels and through the plain
    versions (``patches``: (module, name, plain function) triples): the
    images must agree (rmse < 5e-3, SSIM >= 0.99; measured bit-equal).
    Returns the kernels' image."""
    img_k = render_image_regen(scene, cam, cfg)
    with contextlib.ExitStack() as stack:
        for mod, name, fn in patches:
            stack.enter_context(mock.patch.object(mod, name, fn))
        img_p = render_image_regen(scene, cam, cfg)
    r, s = golden.rmse(img_k, img_p), golden.ssim(img_k, img_p)
    if not (np.isfinite(img_k).all() and r < RMSE_TOL and s >= SSIM_MIN):
        raise AssertionError(f"{tag} small render: rmse {r:.3e} "
                             f"ssim {s:.5f}")
    phase("small", f"{tag} {cfg.nx}x{cfg.ny} {cfg.ns} spp depth "
          f"{cfg.max_depth}: kernel vs plain rmse {r:.3e} ssim {s:.6f} "
          f"max |diff| {np.abs(img_k - img_p).max():.3e}")
    return img_k


def compare_modes(tag, origin, direction, view, eps, flt_max):
    """All three sphere modes, kernel against plain, on one ray set.
    Returns (max abs error over t and features, kernel ms, plain ms) of
    the features mode."""
    args = (origin, direction, view.sph_c, view.sph_r)
    tab = view.sph_tab
    t_k, i_k, f_k = cs.spheres_hit_feat(*args, view.sph_feat, eps, flt_max,
                                        tab=tab)
    t_p, i_p, f_p = cs._spheres_hit_feat_ref(*args, view.sph_feat, eps,
                                             flt_max)
    torch.cuda.synchronize()
    mism = (i_k != i_p).nonzero().flatten()
    if mism.numel() > 1000:
        raise AssertionError(f"{tag}: idx differs on {mism.numel()} lanes")
    if not ties_within_ulp(origin, direction, tab, i_k, i_p, mism, eps,
                           flt_max):
        raise AssertionError(f"{tag}: idx differs where t does not tie")
    same = i_k == i_p
    hit = same & (i_k >= 0)
    dt = (t_k - t_p)[hit].abs()
    if bool((dt > T_RTOL * t_p[hit].abs()).any()):
        raise AssertionError(f"{tag}: t differs by {dt.max().item():.3e}")
    if not bool((t_k[i_k < 0] == t_p.new_tensor(flt_max)).all()):
        raise AssertionError(f"{tag}: a miss lane has t != FLT_MAX")
    fk, fp = torch.stack(f_k), torch.stack(f_p)
    if not torch.equal(fk[:, hit], fp[:, hit]):
        raise AssertionError(f"{tag}: features differ on hit lanes")
    if bool((fk[:, i_k < 0] != 0).any()):
        raise AssertionError(f"{tag}: features nonzero on miss lanes")
    err = max(dt.max().item() if dt.numel() else 0.0,
              (fk[:, hit] - fp[:, hit]).abs().max().item())

    t2_k, i2_k = cs.spheres_hit_soa(*args, eps, flt_max, tab=tab)
    t2_p, i2_p = cs._spheres_hit_ref(*args, eps, flt_max)
    if not (torch.equal(i2_k, i_k) and torch.equal(t2_k, t_k)):
        raise AssertionError(f"{tag}: t/idx mode differs from features "
                             "mode")
    if not torch.equal(i2_p, i_p):
        raise AssertionError(f"{tag}: plain t/idx differs from plain "
                             "features")
    # any-hit against a per-ray t_max just past the plain hit distance on
    # even lanes and at half of it on odd ones, so both outcomes occur
    odd = torch.arange(t_p.numel(), device=t_p.device) % 2 == 1
    tm = torch.where(i_p >= 0, t_p * torch.where(odd, 0.5, 1.001), flt_max)
    o_k = cs.spheres_anyhit_soa(*args, eps, tm, tab=tab)
    o_p = cs._spheres_anyhit_ref(*args, eps, tm)
    if not torch.equal(o_k, o_p):
        raise AssertionError(f"{tag}: any-hit differs on "
                             f"{(o_k != o_p).sum().item()} lanes")

    ms = cuda_ms(lambda: cs.spheres_hit_feat(*args, view.sph_feat, eps,
                                             flt_max, tab=tab))
    plain_ms = cuda_ms(lambda: cs._spheres_hit_feat_ref(
        *args, view.sph_feat, eps, flt_max))
    ms_soa = cuda_ms(lambda: cs.spheres_hit_soa(*args, eps, flt_max,
                                                tab=tab))
    plain_soa = cuda_ms(lambda: cs._spheres_hit_ref(*args, eps, flt_max))
    ms_any = cuda_ms(lambda: cs.spheres_anyhit_soa(*args, eps, tm,
                                                   tab=tab))
    plain_any = cuda_ms(lambda: cs._spheres_anyhit_ref(*args, eps, tm))
    n, s = origin.x.shape[0], view.sph_r.shape[0]
    _, floor, pairs, disc = sphere_floor(origin, direction, view, eps)
    bnd = bound(sphere_flops(pairs, disc),
                n * (28 + 8 + 72) + s * (16 + 72))
    phase("kernel", f"{tag}: {n} rays x {s} spheres: idx equal on "
          f"{int(same.sum())}/{same.numel()} lanes ({mism.numel()} ties), "
          f"hits {int(hit.sum())}, max |err| t+features {err:.3e}, "
          f"occ equal ({int(o_k.sum())} occluded); features "
          f"{ms:.3f} ms vs plain {plain_ms:.3f} ms (bound {bnd[0]:.4f} ms "
          f"by {bnd[1]}, {floor}), t/idx {ms_soa:.3f} ms vs plain "
          f"{plain_soa:.3f} ms, any-hit {ms_any:.3f} ms vs plain "
          f"{plain_any:.3f} ms")
    return err, ms, plain_ms, bnd


def plain_spheres():
    """The engine's sphere call sent to the plain version, which builds
    its own table from the columns (the view's prebuilt one is
    dropped)."""
    return [(cs, "spheres_hit_feat",
             lambda *a, tab=None: cs._spheres_hit_feat_ref(*a))]


def sphere_pool(tag, origin, direction, view, eps):
    """K1 on the middle POOL lanes of one ray set as the frame calls it
    (the view's table, a float t_max): a call's device time in a CUDA
    graph, beside its bound and its issue-rate floor. Returns (ms, bound,
    floor ms)."""
    po, pd = pool_rays(origin, direction)
    k1 = lambda: cs.spheres_hit_feat(po, pd, view.sph_c, view.sph_r,
                                     view.sph_feat, eps, FLT_MAX,
                                     tab=view.sph_tab)
    ms = graph_ms(k1)
    s_count = view.sph_r.shape[0]
    floor, text, pairs, disc = sphere_floor(po, pd, view, eps)
    bnd = bound(sphere_flops(pairs, disc),
                POOL * (28 + 8 + 72) + s_count * (16 + 72))
    phase("kernel", f"{tag} pool: {POOL} rays x {s_count} spheres: "
          f"{ms:.4f} ms a call in a CUDA graph; bound {bnd[0]:.4f} ms by "
          f"{bnd[1]}, {text}")
    return ms, bnd, floor


def sphere_flops(pairs, disc_pairs):
    """The FP32 operations of ``pairs`` ray-sphere pairs, ``disc_pairs``
    of them with disc > 0, where the roots are taken."""
    return pairs * SPHERE_PAIR_FLOPS + disc_pairs * SPHERE_ROOT_FLOPS


def sphere_floor(origin, direction, view, eps):
    """(ms, text, pairs, disc pairs): the least time the card could issue
    csrc/spheres.cu's SASS for the nearest modes on these rays at t_max =
    FLT_MAX, at ISSUE_RATE, and the pairs it counts."""
    n = origin.x.shape[0]
    pairs, disc = sphere_pairs(origin, direction, view.sph_tab, eps,
                               torch.full((n,), FLT_MAX,
                                          device=origin.x.device))
    lanes = pairs * SPHERE_SASS[0] + disc * SPHERE_SASS[1]
    floor = lanes / 32 / ISSUE_RATE * 1e3
    return floor, (f"issue-rate floor {floor:.4f} ms ({lanes} lane "
                   f"instructions: {pairs} pairs, {disc} with disc > 0)"), \
        pairs, disc


def plain_tris():
    """The engine's triangle calls sent to the plain versions, which build
    their own table from the columns (the engine's prebuilt one is
    dropped)."""
    return [(ct, "tris_hit_feat",
             lambda *a, tab=None: ct._tris_hit_feat_ref(*a)),
            (ct, "tris_anyhit_soa",
             lambda *a, tab=None: ct._tris_anyhit_ref(*a))]


def compare_tri_nearest(tag, origin, direction, view, eps, t_max):
    """The triangle kernel's features and t/idx modes against the plain
    version on one ray set (t_max [N]): idx equal on every lane (the
    kernel keeps the serial loop's first-wins winner, ties included), t,
    u, v and features bit-equal. Returns (hits, the kernel's call, the
    plain call, the t/idx mode's call and its plain call, bound)."""
    n, T = origin.x.shape[0], view.tri_v0.x.shape[0]
    args = (origin, direction, view.tri_v0, view.tri_e1, view.tri_e2,
            view.tri_n)
    kern = lambda: ct.tris_hit_feat(*args, view.tri_feat, eps, t_max,
                                    tab=view.tri_tab)
    plain = lambda: ct._tris_hit_feat_ref(*args, view.tri_feat, eps, t_max)
    soa = lambda: ct.tris_hit_soa(*args, eps, t_max, tab=view.tri_tab)
    plain_soa = lambda: ct._tris_hit_ref(*args, eps, t_max)
    k, p = kern(), plain()
    torch.cuda.synchronize()
    for name, a, b in zip(("t", "idx", "u", "v"), k[:4], p[:4]):
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: {name} differs from the plain "
                                 f"version on {int((a != b).sum())} lanes")
    fk, fp = torch.stack(k[4]), torch.stack(p[4])
    if not torch.equal(fk, fp):
        raise AssertionError(f"{tag}: features differ from the plain "
                             f"version on {int((fk != fp).any(0).sum())} "
                             "lanes")
    if not all(torch.equal(a, b) for a, b in zip(soa(), k[:4])):
        raise AssertionError(f"{tag}: t/idx mode differs from features "
                             "mode")
    bnd = bound(n * T * MT_FLOPS, n * (28 + 16 + 104) + T * (48 + 104))
    return int((k[1] >= 0).sum()), kern, plain, (soa, plain_soa), bnd


def tri_slots_tested(origin, direction, view, eps, t_max):
    """Triangle tests the any-hit kernel needs on these rays: up to and
    including the first hit in slot order, all of them without one, none
    on a lane with t_max <= t_min."""
    tab = view.tri_tab
    n, T = origin.x.shape[0], tab.shape[0]
    tested = torch.full((n,), T, dtype=torch.int64, device=tab.device)
    found = torch.zeros((n,), dtype=torch.bool, device=tab.device)
    for base in range(0, T, ct.T_CHUNK):
        *_, bad = ct._tri_step(origin, direction,
                               tab[base:base + ct.T_CHUNK], eps, t_max)
        ok = ~bad
        has = ok.any(dim=1)
        first = ok.to(torch.uint8).argmax(dim=1)
        tested = torch.where(has & ~found, base + first + 1, tested)
        found = found | has
    return int(torch.where(t_max > eps, tested, 0).sum())


def compare_tri_anyhit(tag, origin, direction, view, eps, t_max):
    """The triangle kernel's any-hit mode against the plain version:
    occlusion equal on every lane, false on the lanes without a shadow
    ray. Returns (occluded, the kernel's call, the plain call, bound)."""
    args = (origin, direction, view.tri_v0, view.tri_e1, view.tri_e2,
            view.tri_n, eps, t_max)
    kern = lambda: ct.tris_anyhit_soa(*args, tab=view.tri_tab)
    plain = lambda: ct._tris_anyhit_ref(*args)
    o_k, o_p = kern(), plain()
    differ = int((o_k != o_p).sum())
    if differ:
        raise AssertionError(f"{tag}: any-hit differs on {differ} lanes")
    if bool(o_k[t_max <= eps].any()):
        raise AssertionError(f"{tag}: a lane without a shadow ray is "
                             "occluded")
    n, T = origin.x.shape[0], view.tri_v0.x.shape[0]
    tests = tri_slots_tested(origin, direction, view, eps, t_max)
    bnd = bound(tests * MT_FLOPS, n * 29 + T * 48)
    return int(o_k.sum()), kern, plain, (bnd, tests)


def tri_shapes(sets, view, eps):
    """Phase 6: the triangle kernel against its plain version on each ray
    set (name: (origin, direction, t_max [N], any_hit)) at the frame's
    960,000 lanes and at the middle POOL lanes, the shape the regen engine
    launches it on. Times: at the frame's shape CUDA events around a call
    (the plain version's too); at the pool's the device time of a call in
    a CUDA graph (with the prebuilt table and a t_max tensor the call
    launches the kernel alone). Returns {(name, shape): (ms, plain ms,
    bound)}."""
    out = {}
    for name, (o, d, tm, any_hit) in sets.items():
        for shape, (so, sd, stm) in (("frame", (o, d, tm)),
                                     ("pool", pool_rays(o, d, tm))):
            tag = f"tris {name} {shape}"
            n = so.x.shape[0]
            if any_hit:
                occ, kern, plain, (bnd, tests) = compare_tri_anyhit(
                    tag, so, sd, view, eps, stm)
                text = (f"{int((stm > eps).sum())} shadow rays, occ equal "
                        f"({occ} occluded), {tests} triangle tests")
            else:
                hits, kern, plain, soa, bnd = compare_tri_nearest(
                    tag, so, sd, view, eps, stm)
                text = (f"idx equal on every lane ({hits} hits), t, u, v "
                        "and features bit-equal")
            if shape == "frame":
                ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
                timing = f"{ms:.3f} ms vs plain {plain_ms:.3f} ms"
                if not any_hit and name == "primary":
                    ms_soa, plain_soa = map(cuda_ms, soa)
                    timing += (f"; t/idx {ms_soa:.3f} ms vs plain "
                               f"{plain_soa:.3f} ms")
            else:
                ms, plain_ms = graph_ms(kern), cuda_ms(plain, reps=3)
                timing = (f"{ms:.4f} ms a call in a CUDA graph, plain "
                          f"{plain_ms:.3f} ms")
            phase("kernel", f"{tag}: {n} rays x {view.tri_tab.shape[0]} "
                  f"triangles: {text}; {timing} (bound {bnd[0]:.4f} ms by "
                  f"{bnd[1]})")
            out[name, shape] = (ms, plain_ms, bnd)
    return out


def build_all():
    """Build the kernels and the BVH builder side by side."""
    def timed(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        return out, time.perf_counter() - t0

    names = ("spheres", "spheres_mx", "tris", "bvh", "bvh4", "bvh_mx",
             "bvh_rg", "bvh_mr", "iter_ablate", "leafmt_probe", "dma_probe",
             "dual_probe", "tpu_micro", "regroup_probe", "multirow_probes",
             "sphere_layout_probe", "shapecast_probe")
    with concurrent.futures.ThreadPoolExecutor(len(names) + 1) as ex:
        futs = {name: ex.submit(timed, _build.build, name)
                for name in names}
        bvh = ex.submit(timed, native.load)
        for name, fut in futs.items():
            lib, secs = fut.result()
            ptxas = [ln.strip() for ln in
                     lib.with_suffix(".log").read_text().splitlines()
                     if "registers" in ln or "spill" in ln]
            phase("build", f"{name}.cu built in {secs:.1f} s: "
                  + " | ".join(ptxas))
        lib, secs = bvh.result()
    phase("build", "BVH builder: " + (
        f"native SAH (g++, {secs:.1f} s)" if lib is not None
        else "NumPy median (the native builder did not build)"))


def sub(v, lanes):
    return V3(*(c[lanes] for c in v))


def mx_against_exact(tag, origin, direction, view, eps, mx_out, occ_mx,
                     t_any):
    """K2 against K1 and K3 against K1c on one ray set: winners agree on
    more than MX_AGREE of the lanes, and each departing lane is one the
    split's error can flip (its winner under either form near a root's
    bound, or the two winners' t within their errors); where the winners
    agree, the features are equal and t is within MX_T_REL relative plus
    the split's error, or the sphere has a root within that error of t_min
    (the other root may win). Any-hit agrees on more than 0.999 of the lanes
    (the JAX bound, tests/test_fast_math.py:71). Returns a text."""
    sph = (view.sph_c, view.sph_r)
    tk, ik, fk = mx_out
    te, ie, fe = cs.spheres_hit_feat(origin, direction, *sph, view.sph_feat,
                                     eps, FLT_MAX)
    n = ik.numel()
    dep = (ik != ie).nonzero().flatten()
    if dep.numel() >= (1.0 - MX_AGREE) * n:
        raise AssertionError(f"{tag}: K2's winner departs from K1's on "
                             f"{dep.numel()} of {n} lanes")
    o, d = sub(origin, dep), sub(direction, dep)
    dt_k, flip_k = cs.mx_error(o, d, *sph, ik[dep], eps)
    dt_e, flip_e = cs.mx_error(o, d, *sph, ie[dep], eps)
    tie = ((ik[dep] >= 0) & (ie[dep] >= 0)
           & ((tk[dep] - te[dep]).double().abs() <= 2.0 * (dt_k + dt_e)))
    if not bool((flip_k | flip_e | tie).all()):
        raise AssertionError(f"{tag}: K2 departs from K1 on a lane the "
                             "split's error cannot explain")
    same = (ik == ie) & (ie >= 0)
    dt, flip = cs.mx_error(origin, direction, *sph, ik, eps)
    gap = (tk - te).double().abs()
    if bool((same & ~flip & (gap > MX_T_REL * te.double() + dt)).any()):
        raise AssertionError(f"{tag}: K2's t leaves K1's beyond 5e-3 "
                             "relative plus the split's error")
    past_rel = int((same & (gap > MX_T_REL * te.double())).sum())
    root_flips = int((same & flip & (gap > MX_T_REL * te.double() + dt))
                     .sum())
    if not torch.equal(torch.stack(fk)[:, same], torch.stack(fe)[:, same]):
        raise AssertionError(f"{tag}: features differ where K2 and K1 "
                             "agree")
    occ_e = cs.spheres_anyhit_soa(origin, direction, *sph, eps, t_any)
    occ_dep = int((occ_mx != occ_e).sum())
    if occ_dep >= 1e-3 * n:
        raise AssertionError(f"{tag}: K3's occlusion departs from K1c's on "
                             f"{occ_dep} of {n} lanes")
    near = flip_k | flip_e
    return (f"K2 vs K1: winners agree on {n - dep.numel()}/{n} lanes "
            f"({dep.numel()} depart: {int(near.sum())} with a winner near "
            f"a root's bound or grazing, {int((tie & ~near).sum())} near "
            f"ties), t beyond 5e-3 "
            f"relative on {past_rel} agreeing lanes (within the split's "
            f"error, or the other root of a sphere with a root near t_min: "
            f"{root_flips}); K3 vs K1c: "
            f"occlusion agrees on {n - occ_dep}/{n} lanes "
            f"({int(occ_e.sum())} occluded)")


def mx_work(origin, direction, view, eps, t_max, any_hit, chunk=8192):
    """What K2 (K3, ``any_hit``) needs and issues on these rays, from the
    plain mx version: (pairs, disc pairs, steps, root steps, root slots).
    pairs: the (ray, sphere) pairs the function needs, every slot for each
    live ray (any-hit: up to its first valid slot); disc pairs: those with
    disc > 0, where it takes the roots. steps: the kernel's steps (a warp
    tile of 8 rays against 32 spheres, 4 mma), every step of the padded
    set for each warp tile with a live ray (any-hit: up to the step in
    which its last ray is decided); root steps: those in which a pair has
    disc > 0, where the warp enters the roots' branch; root slots: the
    (step, pair slot) of those in which a thread's pair has disc > 0, where
    the warp takes that pair's roots."""
    tab = cs.mx_sphere_table(view.sph_c, view.sph_r)
    n, s = origin.x.shape[0], tab.shape[0]
    k, w = cs.MX_CHUNK, cs.MX_RAYS
    s_pad = -(-s // k) * k
    tmax = cs._tmax_vector(t_max, n, origin.x)
    live = tmax > eps
    pad8 = lambda x, m: torch.nn.functional.pad(x.to(torch.uint8),
                                                (0, -m % w))
    pairs = disc_pairs = steps = root_steps = root_slots = 0
    for a in range(0, n, chunk):
        b = min(n, a + chunk)
        m = b - a
        o, d = (V3(*(c[a:b] for c in v)) for v in (origin, direction))
        valid = cs._mx_sphere_ts(o, d, tab, eps, tmax[a:b]) < FLT_MAX
        od = (d.x * o.x + d.y * o.y + d.z * o.z)[:, None]
        oo = (o.x * o.x + o.y * o.y + o.z * o.z)[:, None]
        cd, oc = cs.mx_products(o, d, tab)
        bb = od - cd
        disc = ((bb * bb - ((oo - 2.0 * oc) + tab[:, 3])) > 0.0) \
            & live[a:b, None]
        col = torch.arange(s, device=disc.device)
        if any_hit:
            has = valid.any(dim=1)
            need = torch.where(has, valid.to(torch.uint8).argmax(dim=1) + 1,
                               s)
            need = torch.where(live[a:b], need, 0)
            pairs += int(need.sum())
            disc_pairs += int((disc & (col < need[:, None])).sum())
            warp = torch.nn.functional.pad(-(-need // k), (0, -m % w))
            walked = warp.view(-1, w).amax(dim=1)
            steps += int(walked.sum())
            disc &= col < (walked.repeat_interleave(w)[:m] * k)[:, None]
        else:
            pairs += int(live[a:b].sum()) * s
            disc_pairs += int(disc.sum())
            steps += int((pad8(live[a:b], m).view(-1, w).amax(dim=1)
                          > 0).sum()) * (s_pad // k)
        # a step's sphere r = 8j + 2t + h (the mma's n-tile of 8 spheres,
        # 2 a thread): thread t's pair slot p = 2j + h
        dpad = torch.nn.functional.pad(disc.to(torch.uint8),
                                       (0, s_pad - s, 0, -m % w))
        slot = dpad.view(-1, w, s_pad // k, k // 8, 4, 2).amax(dim=(1, 4))
        root_slots += int((slot > 0).sum())
        root_steps += int((slot.amax(dim=(2, 3)) > 0).sum())
    return pairs, disc_pairs, steps, root_steps, root_slots


def mx_bound(n, s, pairs, disc_pairs, any_hit):
    """(ms, "operations" or "bytes"): the least time for K2's (K3's,
    ``any_hit``) work on these rays, the largest of the split products on
    the tensor cores (MX_SPHERE_MMA_FLOPS a pair at the bf16 peak), the
    FP32 epilogue (MX_SPHERE_FLOPS a pair, the roots where disc > 0, a
    ray's o.d, |o|^2 and splits at 67 TFLOP/s) and the bytes (rays in,
    results out, the table once)."""
    t_fp32 = (pairs * MX_SPHERE_FLOPS + disc_pairs * MX_ROOT_FLOPS
              + n * MX_SPHERE_RAY_FLOPS) / FP32_FLOPS * 1e3
    t_mma = pairs * MX_SPHERE_MMA_FLOPS / BF16_FLOPS * 1e3
    nbytes = (n * 29 + s * 20 if any_hit
              else n * (28 + 8 + 72) + s * (20 + 72))
    t_bytes = nbytes / HBM_BYTES * 1e3
    if max(t_fp32, t_mma) >= t_bytes:
        return max(t_fp32, t_mma), "operations"
    return t_bytes, "bytes"


def mx_sass():
    """{mode: (step, root step, root slot)}: the warp instructions of
    csrc/spheres_mx.cu's sphere loop in this run's build (its
    ``cuobjdump -sass``, counted by ``spheres_mx_ab.step_sass``): a step
    (8 rays x 32 spheres: its LDSM, LDS, 4 HMMA, 8 pairs' epilogues a
    thread and the loop; any-hit with its vote), what the roots' branch
    adds to a step where a pair has disc > 0, and what a pair slot adds
    where it takes its roots. Raises if the build has no HMMA or no
    such loop."""
    return mx_ab.step_sass(common.sass_dump(
        _build.library_path("spheres_mx")))


def mx_floor(per, work):
    """ms: the least time the card could issue the SASS ``per``
    (``mx_sass``'s counts of a mode) for ``work`` (``mx_work``'s steps,
    root steps and root slots) at ISSUE_RATE."""
    return (sum(c * w for c, w in zip(per, work[2:]))
            / ISSUE_RATE * 1e3)


def mx_against_plain(tag, origin, direction, view, eps, t_any, k2, k3):
    """K2 (``k2``, its t, idx and features at t_max FLT_MAX) and K3
    (``k3``, its occlusion at ``t_any``) against their plain versions by
    the bound (``cuda_spheres.mx_nearest_departures`` and
    ``mx_anyhit_departures``); K3 also at a t_max just past the plain hit
    on even lanes and at half of it on odd ones. Returns (text, the
    largest |t - plain t| of K2's agreeing hits, whether an occlusion
    differs)."""
    sph = (view.sph_c, view.sph_r)
    n = origin.x.shape[0]
    fmax = torch.full((n,), FLT_MAX, device=origin.x.device)
    plain = cs._spheres_hit_feat_ref(origin, direction, *sph, view.sph_feat,
                                     eps, fmax, mx=True)
    near = cs.mx_nearest_departures(origin, direction, *sph, eps, fmax, k2,
                                    plain)
    # K3 and K2 share the mma and the epilogue's test: at the same t_max
    # K3 is occluded exactly where K2 finds a hit
    occ_k2 = cs.spheres_anyhit_soa(origin, direction, *sph, eps, fmax,
                                   mx=True)
    if not torch.equal(occ_k2, k2[1] >= 0):
        raise AssertionError(f"{tag}: K3 at t_max FLT_MAX differs from "
                             f"K2's hits on "
                             f"{int((occ_k2 != (k2[1] >= 0)).sum())} lanes")
    tp, ip, _ = plain
    odd = torch.arange(n, device=tp.device) % 2 == 1
    edge = torch.where(ip >= 0, tp * torch.where(odd, 0.5, 1.001), FLT_MAX)
    occ = []
    for tm, o_k in ((t_any, k3),
                    (edge, cs.spheres_anyhit_soa(origin, direction, *sph,
                                                 eps, edge, mx=True))):
        o_p = cs._spheres_anyhit_ref(origin, direction, *sph, eps, tm,
                                     mx=True)
        occ.append(cs.mx_anyhit_departures(origin, direction, *sph, eps, tm,
                                           o_k, o_p))
    text = (f"K3 at t_max FLT_MAX occluded exactly where K2 hits; "
            f"K2 within the bound of its plain version: winners differ on "
            f"{near['differ']} of {n} lanes ({near['by_flip']} a flip, "
            f"{near['by_tie']} a near tie), {near['root_flips']} agreeing "
            f"lanes whose root may flip, max |t - plain| "
            f"{near['t_err']:.3e}; K3 within it: occlusion differs on "
            f"{occ[0]['differ']} (t_max half the hit on odd lanes) and "
            f"{occ[1]['differ']} (just past it on even ones) of {n} lanes")
    return text, near["t_err"], any(o["differ"] for o in occ)


def mx_products_check(tag, origin, direction, view):
    """The kernel's c.d and o.c (its products mode) against the plain
    version's fixed order: each within ``cuda_spheres.mx_product_bound``.
    Returns the largest distance in units of 2^-24 times the sum of the
    products' magnitudes, for c.d and o.c."""
    sph = (view.sph_c, view.sph_r)
    tab = cs.mx_sphere_table(*sph)
    got = cs.spheres_mx_products(origin, direction, *sph)
    units = []
    for k, p, e in zip(got, cs.mx_products(origin, direction, tab),
                       cs.mx_product_bound(origin, direction, tab)):
        gap = (k.double() - p.double()).abs()
        if bool((gap > e).any()):
            raise AssertionError(f"{tag}: the kernel's products leave the "
                                 f"bound on {int((gap > e).sum())} pairs")
        units.append((gap / e * cs.MX_ULPS).max().item())
    return units


def mx_path(sets, view, eps):
    """Phase 3b: the mx entry points (K2, K3) on the headline's ray sets
    (name: (origin, direction)) at their full size and at the middle POOL
    lanes, the launch counts set to 0 just before and read just after;
    each against its plain version by the bound (``mx_against_plain``,
    the products mode at the pool), against K1 and K1c at full size
    (``mx_against_exact``), and timed at both shapes in turns with them
    (device time a call in a CUDA graph: K1 as the frame calls it, the
    view's table and a float t_max; K2, K3 and K1c with prebuilt tables
    and [N] t_max), beside the bound and the issue-rate floor. Returns the
    JSON records of K2 and K3 (the primary set's times and bounds at full
    size and at the pool)."""
    sph = (view.sph_c, view.sph_r)
    mx_tab = cs.mx_operands(*sph)
    shapes = {}
    for name, (o, d) in sets.items():
        shapes[name] = (o, d)
        shapes[f"pool {name}"] = tuple(pool_rays(o, d))
    t_any, fmax = {}, {}
    for name, (o, d) in shapes.items():
        # any-hit t_max: half the exact hit on odd lanes, FLT_MAX else
        t1, i1 = cs.spheres_hit_soa(o, d, *sph, eps, FLT_MAX)
        odd = torch.arange(t1.numel(), device=t1.device) % 2 == 1
        t_any[name] = torch.where((i1 >= 0) & odd, 0.5 * t1,
                                  FLT_MAX).contiguous()
        fmax[name] = torch.full_like(t1, FLT_MAX)
    torch.cuda.synchronize()
    for key in cs.MX_LAUNCHES:
        cs.MX_LAUNCHES[key] = 0
    outs = {name: (cs.spheres_hit_feat(o, d, *sph, view.sph_feat, eps,
                                       FLT_MAX, mx=True),
                   cs.spheres_anyhit_soa(o, d, *sph, eps, t_any[name],
                                         mx=True))
            for name, (o, d) in shapes.items()}
    torch.cuda.synchronize()
    launches = dict(cs.MX_LAUNCHES)
    if min(launches.values()) <= 0:
        raise AssertionError(f"the mx path launched {launches}")
    sass = mx_sass()
    phase("kernel", f"spheres mx SASS of this build (warp instructions: "
          f"a step, + its roots' branch, + a root slot): {sass}")
    recs = {}
    for name, (o, d) in shapes.items():
        tag = f"spheres mx {name}"
        pool = name.startswith("pool")
        k2, k3 = outs[name]
        text, err, occ_differs = mx_against_plain(tag, o, d, view, eps,
                                                  t_any[name], k2, k3)
        if pool:
            cd_units, oc_units = mx_products_check(tag, o, d, view)
            text += (f"; the tensor cores' c.d and o.c within "
                     f"{cd_units:.2f} and {oc_units:.2f} units of 2^-24 "
                     f"sum|products| of the plain order's (bound "
                     f"{cs.MX_ULPS})")
        else:
            text += "; " + mx_against_exact(tag, o, d, view, eps, k2, k3,
                                            t_any[name])
        fm, ta = fmax[name], t_any[name]
        k1 = lambda: cs.spheres_hit_feat(o, d, *sph, view.sph_feat, eps,
                                         FLT_MAX, tab=view.sph_tab)
        k2f = lambda: cs.spheres_hit_feat(o, d, *sph, view.sph_feat, eps, fm,
                                          mx=True, tab=mx_tab)
        k1c = lambda: cs.spheres_anyhit_soa(o, d, *sph, eps, ta,
                                            tab=view.sph_tab)
        k3f = lambda: cs.spheres_anyhit_soa(o, d, *sph, eps, ta, mx=True,
                                            tab=mx_tab)
        turns = [graph_ms(f) for f in (k1, k2f, k2f, k1)]
        turns_any = [graph_ms(f) for f in (k1c, k3f, k3f, k1c)]
        plain = cuda_ms(lambda: cs._spheres_hit_feat_ref(
            o, d, *sph, view.sph_feat, eps, FLT_MAX, mx=True), reps=2)
        plain_any = cuda_ms(lambda: cs._spheres_anyhit_ref(
            o, d, *sph, eps, ta, mx=True), reps=2)
        n, s = o.x.shape[0], view.sph_r.shape[0]
        work = mx_work(o, d, view, eps, fm, False)
        work_any = mx_work(o, d, view, eps, ta, True)
        bnd = mx_bound(n, s, work[0], work[1], False)
        bnd_any = mx_bound(n, s, work_any[0], work_any[1], True)
        floor = mx_floor(sass["features"], work)
        floor_any = mx_floor(sass["any_hit"], work_any)
        phase("kernel", f"{tag}: {n} rays x {s} spheres: {text}; device "
              f"time a call in a CUDA graph, in turns K1 {turns[0]:.4f}, K2 "
              f"{turns[1]:.4f}, K2 {turns[2]:.4f}, K1 {turns[3]:.4f} ms "
              f"(plain K2 {plain:.3f} ms; bound {bnd[0]:.4f} ms by "
              f"{bnd[1]}, issue-rate floor {floor:.4f} ms: {work[2]} "
              f"steps of 4 mma, {work[3]} with a root, {work[1]} pairs "
              f"with disc > 0); K1c {turns_any[0]:.4f}, K3 "
              f"{turns_any[1]:.4f}, K3 {turns_any[2]:.4f}, K1c "
              f"{turns_any[3]:.4f} ms (plain K3 {plain_any:.3f} ms, "
              f"{work_any[0]} pairs needed, bound {bnd_any[0]:.4f} ms by "
              f"{bnd_any[1]}, issue-rate floor {floor_any:.4f} ms: "
              f"{work_any[2]} steps)")
        key = "pool" if pool else "frame"
        done = {"features": (turns[1] + turns[2]) / 2,
                "any_hit": (turns_any[1] + turns_any[2]) / 2}
        if name.endswith("primary"):
            recs.setdefault("features", {})[key] = (
                done["features"], plain, bnd, floor, err)
            recs.setdefault("any_hit", {})[key] = (
                done["any_hit"], plain_any, bnd_any, floor_any,
                float(occ_differs))
    out = []
    for mode, name, line in (("features", "spheres_mx_feat", 271),
                             ("any_hit", "spheres_mx_anyhit", 499)):
        ms, plain, bnd, floor, err = recs[mode]["frame"]
        ms_p, _, bnd_p, floor_p, err_p = recs[mode]["pool"]
        rec = record(name, "spheres_mx.cu",
                     OPS + f"pallas_spheres.py:{line}", launches[mode],
                     max(err, err_p), ms, plain, bnd)
        rec.update(floor_ms=floor, pool=POOL, ms_pool=ms_p,
                   bound_ms_pool=bnd_p[0], bound_by_pool=bnd_p[1],
                   floor_ms_pool=floor_p)
        out.append(rec)
    phase("kernel", f"spheres mx path: launches {launches}")
    return out


def spheres_path(dev):
    """Phases 3-5 and 3b. Returns the headline's profile (phase 14, to run
    after config 4's frame) and the JSON records of K1, K2 and K3."""
    t_phase = time.perf_counter()
    built = bench.build_frame(bench.FRAMES["headline"], dev)
    cfg, scene, cam = built.cfg, built.scene, built.cam
    view = wf.make_view(scene, cfg)
    pix = torch.arange(cfg.num_pixels, device=dev)
    o1, d1 = cam.generate_rays(pix, 0, cfg.nx, cfg.ny)
    err1, ms, plain_ms, bnd = compare_modes("spheres primary", o1, d1, view,
                                            cfg.epsilon, FLT_MAX)
    with mock.patch.object(*plain_spheres()[0]):
        st, _ = wf.bounce_step(scene, view, cfg,
                               wf.initial_state(o1, d1, torch.ones_like(
                                   pix, dtype=torch.bool)), pix, 0, 0)
    live = st.alive
    o2 = V3(*(c[live].contiguous() for c in st.origin))
    d2 = V3(*(c[live].contiguous() for c in st.direction))
    err2, _, _, _ = compare_modes("spheres bounce-2", o2, d2, view,
                                  cfg.epsilon, FLT_MAX)
    # K1 at the lane pool the regen engine launches it on
    pool = {name: sphere_pool(f"spheres {name}", o, d, view, cfg.epsilon)
            for name, (o, d) in (("primary", (o1, d1)),
                                 ("bounce-2", (o2, d2)))}
    t_phase = phase_seconds("3", t_phase)
    mx_recs = mx_path({"primary": (o1, d1), "bounce-2": (o2, d2)}, view,
                      cfg.epsilon)
    t_phase = phase_seconds("3b", t_phase)

    scfg = RenderConfig(**SMALL)
    sscene, scam = random_spheres_scene(scfg.nx, scfg.ny, device=dev)
    small_renders("spheres", sscene, scam, scfg, plain_spheres())
    t_phase = phase_seconds("4", t_phase)

    # K1 alone: no mx sphere kernel, no triangle or probe kernel
    run = frame_run("headline", "headline", "headline", built,
                    TIER_KERNELS["spheres"])
    launches = run.timed.launches["cuda_spheres"]
    if run.timed.image.shape != (cfg.ny, cfg.nx, 3):
        raise AssertionError(f"bad image: shape {run.timed.image.shape}")
    BENCH_READINGS["headline"] = run.timed.seconds
    phase_seconds("5", t_phase)
    k1_rec = record("spheres_hit_feat", "spheres.cu",
                    OPS + "pallas_spheres.py:73", launches, max(err1, err2),
                    ms, plain_ms, bnd)
    ms_pool, bnd_pool, floor_pool = pool["primary"]
    k1_rec.update(pool=POOL, ms_pool=ms_pool, bound_ms_pool=bnd_pool[0],
                  bound_by_pool=bnd_pool[1], floor_ms_pool=floor_pool,
                  ms_pool_bounce2=pool["bounce-2"][0])
    # profiled later: a profiler session slows the host's launches of the
    # frames that follow it in the process (PERF.md)
    profile = functools.partial(profile_frame, "headline", scene, cam, cfg,
                                itemize=("spheres_kernel",))
    return profile, [k1_rec, *mx_recs]


def tri_record(name, launches, frame, pool):
    """The triangle kernel's JSON record: times and bound at the frame's
    shape, and at the lane pool's (``ms_pool``: a call's device time in a
    CUDA graph)."""
    rec = record(name, "tris.cu", OPS + "pallas_tris.py:77", launches, 0.0,
                 frame[0], frame[1], frame[2])
    rec.update(pool=POOL, ms_pool=pool[0], bound_ms_pool=pool[2][0],
               bound_by_pool=pool[2][1])
    return rec


def staircase_path(dev):
    """Phases 6-8. Returns the staircase-toy's profile (phase 14, to run
    after the last full-size frame but the dragon's, as config 4's does)
    and the kernel's JSON records (features mode, the nearest hit of the
    path, and any-hit, its shadow rays)."""
    t_phase = time.perf_counter()
    built = bench.build_frame(bench.FRAMES["staircase"], dev)
    cfg, scene, cam = built.cfg, built.scene, built.cam
    view = wf.make_view(scene, cfg)
    pix = torch.arange(cfg.num_pixels, device=dev)
    o1, d1 = cam.generate_rays(pix, 0, cfg.nx, cfg.ny)
    plain = plain_tris()
    (o2, d2, t2), shadow = first_bounce(scene, view, cfg, o1, d1, pix,
                                        plain)
    t1 = torch.full((cfg.num_pixels,), FLT_MAX, device=dev)
    times = tri_shapes({"primary": (o1, d1, t1, False),
                        "bounce-2": (o2, d2, t2, False),
                        "NEE shadows": (*shadow, True)}, view, cfg.epsilon)
    t_phase = phase_seconds("6", t_phase)

    scfg = RenderConfig(**SMALL)
    sscene, scam = procedural_staircase_scene(scfg.nx, scfg.ny, device=dev)
    small_renders("staircase", sscene, scam, scfg, plain)
    t_phase = phase_seconds("7", t_phase)

    run = frame_run("staircase", "staircase", "staircase", built,
                    TIER_KERNELS["brute"])
    launches = {k.split(".")[1]: v for k, v in run.timed.launches.items()}
    BENCH_READINGS["staircase"] = run.timed.seconds
    phase_seconds("8", t_phase)
    # profiled later: a profiler session slows the host's launches of the
    # frames that follow it in the process (PERF.md)
    profile = functools.partial(profile_frame, "staircase-toy", scene, cam,
                                cfg, itemize=("tris_kernel",))
    return profile, [tri_record("tris_hit_feat", launches["features"],
                       times["primary", "frame"], times["primary", "pool"]),
            tri_record("tris_anyhit_soa", launches["any_hit"],
                       times["NEE shadows", "frame"],
                       times["NEE shadows", "pool"])]


def profile_frame(tag, scene, cam, cfg, itemize=None):
    """Phase 14: one sample per pixel of the middle rows of ``cfg``'s
    frame (two lane pools' worth of pixels) timed without the profiler,
    then under torch.profiler; prints host dispatches and device kernel
    time per regen iteration, the device's busy share (profiled device
    time over the unprofiled wall time), the kernels that take most and,
    by name, each kernel whose name holds one of ``itemize``."""
    from torch.profiler import ProfilerActivity, profile
    one = cfg.replace(ns=1)
    n = min(cfg.num_pixels,
            2 * _pool_size(one, cfg.num_pixels, scene))
    rows = dict(pixel_offset=(cfg.num_pixels - n) // 2, num_pixels=n)
    render_regen(scene, cam, one, **rows)  # warm-up
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    _, iters = render_regen(scene, cam, one, return_iters=True, **rows)
    b.record()
    b.synchronize()
    secs = a.elapsed_time(b) / 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render_regen(scene, cam, one, **rows)
        torch.cuda.synchronize()
    events = prof.key_averages()
    # device time: the kernel events' own (the CPU ops that launch them
    # carry the same time again)
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: e.self_device_time_total
    device_ms = sum(dev_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    top = sorted(kernels, key=dev_us, reverse=True)[:4]
    short = lambda k: k.replace("void ", "").replace("at::native::", "")[:72]
    per_iter = secs / iters * 1e3
    head = f"{tag} 1 spp over {n} pixels: {iters} iterations, "
    if device_ms <= 0:
        phase("profile", f"{head}{per_iter:.2f} ms each; device time not "
              "measured (the profiler reported none)")
        return
    named = ""
    if itemize:
        mine = [e for e in kernels if any(k in e.key for k in itemize)]
        named = "; " + (", ".join(
            f"{short(e.key)} {dev_us(e) / 1e3 / iters:.4f} ms/iter "
            f"({e.count} launches, {dev_us(e) / 1e3 / e.count:.4f} ms "
            f"each, {dev_us(e) / 1e3 / device_ms:.1%} of device time)"
            for e in mine) if mine
            else f"no {' or '.join(itemize)} recorded")
    phase("profile", f"{head}{per_iter:.2f} ms each unprofiled; profiled "
          f"{launches / iters:.0f} kernel "
          f"launches and {device_ms / iters:.3f} ms of device time an "
          f"iteration, device busy {device_ms / iters / per_iter:.1%}; "
          "top: " + ", ".join(
              f"{short(e.key)} {dev_us(e) / 1e3 / iters:.3f} ms/iter"
              for e in top) + named)


def _rg_walk(origin, direction, t_max, tabs, eps, any_hit, visits):
    """regroup's plain walk: K11's rounds for nearest hits, K6's walk for
    shadow rays, as the engine sends them."""
    if any_hit:
        return cb._heap_walk_ref(origin, direction, t_max, tabs, eps, True,
                                 visits)
    t, tri, cnt = crg._rg_walk_ref(origin, direction, t_max, tabs, eps,
                                   visits)
    return t, tri, None, cnt


class Route(typing.NamedTuple):
    """A ``wf.mesh_tier`` route: its nearest and any-hit wrappers
    ((module, name); the plain version is the module's ``_<name>_ref``),
    its plain walk, and its cost model: the leaf slots of a table, slab
    tests a node step, bytes of a node row and of a leaf slot, FP32
    operations of a leaf slot and of a ray's set-up."""
    nearest: tuple
    any_hit: tuple
    walk: typing.Callable
    slots: typing.Callable
    slabs: int
    node_bytes: int
    row_bytes: int
    slot_flops: int
    ray_flops: int


HEAP_NODE = 6 * 4  # one child box (min, max)
ROUTES = {
    "bvh4": Route((cb4, "bvh4_trace"), (cb4, "bvh4_occluded"),
                  cb4._bvh4_walk_ref, lambda tabs: tabs.width, 4,
                  4 * (6 * 4 + 4), TRI_ROW_BYTES, MT_FLOPS, 3),
    "heap": Route((cb, "heap_trace"), (cb, "heap_occluded"),
                  cb._heap_walk_ref, lambda tabs: tabs.prims_per_leaf, 2,
                  HEAP_NODE, TRI_ROW_BYTES, MT_FLOPS, 3),
    # at mx_passes = 3, the config's default
    "heap-mx": Route((cmx, "mx_trace"), (cmx, "mx_occluded"),
                     functools.partial(cmx._mx_walk_ref, passes=3),
                     lambda tabs: tabs.heap.prims_per_leaf, 2, HEAP_NODE,
                     MX_ROW_BYTES, MX_SLOT_FLOPS[3], 3 + MX_RAY_FLOPS),
    # shadow rays under regroup take K6
    "heap-rg": Route((crg, "rg_trace"), (cb, "heap_occluded"), _rg_walk,
                     lambda tabs: tabs.prims_per_leaf, 2, HEAP_NODE,
                     TRI_ROW_BYTES, MT_FLOPS, 3),
}


class BvhKernels:
    """The wrappers of one BVH route (``ROUTES``) on one set of tables,
    their plain versions and the route's cost model."""

    def __init__(self, route, tabs):
        self.tier, self.tabs, self.route = route, tabs, ROUTES[route]
        (mod, name), (amod, aname) = self.route.nearest, self.route.any_hit
        self.trace = getattr(mod, name)
        self.trace_ref = getattr(mod, f"_{name}_ref")
        self.occluded = getattr(amod, aname)
        self.occluded_ref = getattr(amod, f"_{aname}_ref")
        self.slots = self.route.slots(tabs)

    def plain(self):
        """Patches that send the engine through the plain versions."""
        return [(mod, name, getattr(mod, f"_{name}_ref"))
                for mod, name in (self.route.nearest, self.route.any_hit)]

    def walk_plain(self, origin, direction, t_max, eps, any_hit):
        """The plain walk, and the distinct node rows and leaves it read.
        Returns (t, tri, occ, counters, nodes read, leaves read)."""
        visits = {"nodes": [], "leaves": []}
        out = self.route.walk(origin, direction, t_max, self.tabs, eps,
                              any_hit=any_hit, visits=visits)
        return (*out, distinct(visits["nodes"]), distinct(visits["leaves"]))

    def table_bytes(self, nodes, leaves):
        """Bytes of the distinct table rows a walk needs, each read
        once."""
        return (nodes * self.route.node_bytes
                + leaves * self.slots * self.route.row_bytes)

    def nearest_flops(self, n, cnt):
        c = cnt.sum(dim=1, dtype=torch.int64)
        r = self.route
        return (r.ray_flops * n + int(c[4]) * r.slabs * SLAB_FLOPS
                + int(c[2]) * self.slots * r.slot_flops)

    def anyhit_flops(self, n, cnt, occ, best):
        """As nearest, but the last visit of an occluded ray tests only
        the slots up to its first hit."""
        c = cnt.sum(dim=1, dtype=torch.int64)
        r = self.route
        last = int((best[occ].to(torch.int64) % self.slots + 1).sum())
        slots = (int(c[2]) - int(occ.sum())) * self.slots + last
        return (r.ray_flops * n + int(c[4]) * r.slabs * SLAB_FLOPS
                + slots * r.slot_flops)


def compare_bvh_nearest(tag, kern, origin, direction, t_max, eps):
    """A BVH tier's nearest-hit kernel against its plain version: t
    bit-equal, winners equal except exact ties (K10 and K11, which merge
    in their plain versions' order: no exception), per-ray counters
    equal.
    Returns (max abs error of t, kernel ms, plain ms, bound)."""
    tabs = kern.tabs
    t_k, i_k, c_k = kern.trace(origin, direction, t_max, tabs, eps)
    t_p, i_p, _, c_p, nodes, leaves = kern.walk_plain(origin, direction,
                                                      t_max, eps, False)
    torch.cuda.synchronize()
    if kern.tier == "bvh4":
        cb4.check_stack(tabs)
    err = (t_k - t_p).abs().max().item()
    if not torch.equal(t_k, t_p):
        bad = t_k != t_p
        raise AssertionError(f"{tag}: t differs on {int(bad.sum())} lanes "
                             f"(max {(t_k - t_p)[bad].abs().max():.3e})")
    mism = i_k != i_p
    ties = i_k.numel() // 1000 if kern.tier in ("bvh4", "heap") else 0
    if bool((mism & ((i_k < 0) | (i_p < 0))).any()) or \
            int(mism.sum()) > ties:
        raise AssertionError(f"{tag}: winners differ on "
                             f"{int(mism.sum())} lanes")
    if not torch.equal(c_k, c_p):
        raise AssertionError(f"{tag}: per-ray counters differ on "
                             f"{int((c_k != c_p).any(0).sum())} lanes")
    ms = cuda_ms(lambda: kern.trace(origin, direction, t_max, tabs, eps))
    plain_ms = cuda_ms(lambda: kern.trace_ref(origin, direction, t_max,
                                              tabs, eps), reps=2)
    n = origin.x.shape[0]
    bnd = bound(kern.nearest_flops(n, c_k), n * (28 + 8 + 20)
                + kern.table_bytes(nodes, leaves))
    c = c_k.sum(dim=1, dtype=torch.int64).tolist()
    phase("kernel", f"{tag}: {n} rays ({int((t_max > 0).sum())} live): "
          f"t bit-equal, winners equal on {n - int(mism.sum())}/{n} lanes "
          f"({int(mism.sum())} ties), hits {int((i_k >= 0).sum())}, "
          f"counters equal {dict(zip(cb.COUNTERS, c))}; read {nodes} "
          f"distinct node rows, {leaves} leaves; kernel {ms:.3f} ms vs "
          f"plain {plain_ms:.3f} ms (bound {bnd[0]:.4f} ms by {bnd[1]})")
    return err, ms, plain_ms, bnd


def compare_bvh_anyhit(tag, kern, origin, direction, t_max, eps):
    """A BVH tier's any-hit kernel against its plain version: occlusion
    and per-ray counters equal. Returns (lanes whose occlusion differs,
    kernel ms, plain ms, bound)."""
    tabs = kern.tabs
    o_k, c_k = kern.occluded(origin, direction, t_max, tabs, eps)
    _, best, o_p, c_p, nodes, leaves = kern.walk_plain(origin, direction,
                                                       t_max, eps, True)
    torch.cuda.synchronize()
    if kern.tier == "bvh4":
        cb4.check_stack(tabs)
    differ = int((o_k != o_p).sum())
    if differ or not torch.equal(c_k, c_p):
        raise AssertionError(f"{tag}: any-hit differs on {differ} lanes, "
                             f"counters on "
                             f"{int((c_k != c_p).any(0).sum())}")
    if bool(o_k[t_max <= 0].any()):
        raise AssertionError(f"{tag}: a lane without a shadow ray is "
                             "occluded")
    ms = cuda_ms(lambda: kern.occluded(origin, direction, t_max, tabs, eps))
    plain_ms = cuda_ms(lambda: kern.occluded_ref(origin, direction, t_max,
                                                 tabs, eps), reps=2)
    n = origin.x.shape[0]
    bnd = bound(kern.anyhit_flops(n, c_k, o_k, best),
                n * (28 + 1 + 20) + kern.table_bytes(nodes, leaves))
    phase("kernel", f"{tag}: {n} lanes ({int((t_max > 0).sum())} shadow "
          f"rays): occ equal ({int(o_k.sum())} occluded), counters equal; "
          f"read {nodes} distinct node rows, {leaves} leaves; kernel "
          f"{ms:.3f} ms vs plain {plain_ms:.3f} ms (bound {bnd[0]:.4f} ms "
          f"by {bnd[1]})")
    return differ, ms, plain_ms, bnd


def bvh_kernel_phase(tag, scene, cam, cfg, kern):
    """Phases 9 and 10: the tier's kernels against their plain versions
    on BVH_RAYS primary rays taken from across the frame, the same lanes'
    second-bounce rays and their NEE shadow rays. Returns (err, ms,
    plain_ms, bound) of each ray set (primary, bounce-2, NEE shadows), and
    the three ray sets (name: (origin, direction, t_max))."""
    dev = cam.device
    view = wf.make_view(scene, cfg)
    pix = torch.linspace(0, cfg.num_pixels - 1, BVH_RAYS,
                         device=dev).to(torch.int64)
    o1, d1 = cam.generate_rays(pix, 0, cfg.nx, cfg.ny)
    eps = cfg.epsilon
    (o2, d2, t2), shadow = first_bounce(scene, view, cfg, o1, d1, pix,
                                        kern.plain())
    rays = {"primary": (o1, d1, torch.full((BVH_RAYS,), FLT_MAX,
                                           device=dev)),
            "bounce-2": (o2, d2, t2), "NEE shadows": shadow}
    out = {name: (compare_bvh_anyhit if name == "NEE shadows" else
                  compare_bvh_nearest)(f"{tag} {name}", kern, *r, eps)
           for name, r in rays.items()}
    return out, rays


def pool_sets(scene, cam, cfg, kern, n=BVH_RAYS):
    """The frame's own shape: the ``n`` contiguous middle-row pixels (the
    lanes of one regen iteration's pool) as primary rays, and those
    lanes' NEE shadow rays. Name: (origin, direction, t_max)."""
    dev = cam.device
    lo = (cfg.num_pixels - n) // 2
    pix = torch.arange(lo, lo + n, device=dev)
    o1, d1 = cam.generate_rays(pix, 0, cfg.nx, cfg.ny)
    _, shadow = first_bounce(scene, wf.make_view(scene, cfg), cfg, o1, d1,
                             pix, kern.plain())
    return {"pool primary": (o1, d1, torch.full((n,), FLT_MAX,
                                                device=dev)),
            "pool NEE shadows": shadow}


def issue_floor(sass, mode, cnt, slots):
    """(ms, lane instructions): the least time the card could issue a BVH
    kernel's SASS (``sass``: BVH4_SASS, HEAP_SASS or MX_SASS) for a run's
    node steps, leaf visits and slot tests (``cnt``: its per-ray
    counters) at ISSUE_RATE."""
    slot, node, visit = sass[mode]
    c = cnt.sum(dim=1, dtype=torch.int64)
    lanes = slots * slot + int(c[4]) * node + int(c[2]) * visit
    return lanes / 32 / ISSUE_RATE * 1e3, lanes


def graph_phase(tag, kern, sets, checks, eps, sass, fast_math=False):
    """Phases 9 and 10's device times: each mode's call on each ray set
    (name: (origin, direction, t_max); NEE sets in any-hit) captured in a
    CUDA graph, beside its bound (``checks``: the set's compare_bvh_*
    result) and its issue-rate floor (``sass``). Any-hit's slots are those
    up to the first hit. ``fast_math``: the heap kernels' fast_math mode
    (the bound is the exact mode's: the same work). Returns {name: (ms,
    bound, floor ms)}."""
    tabs, out = kern.tabs, {}
    kw = dict(approx_recip=True) if fast_math else {}
    suffix = "_fast_math" if fast_math else ""
    for name, (o, d, tm) in sets.items():
        if "NEE" in name:
            call = lambda: kern.occluded(o, d, tm, tabs, eps, **kw)
            occ, cnt = call()
            best = kern.route.walk(o, d, tm, tabs, eps, any_hit=True)[1]
            c2 = int(cnt[2].sum(dtype=torch.int64))
            slots = ((c2 - int(occ.sum())) * kern.slots
                     + int((best[occ].to(torch.int64) % kern.slots
                            + 1).sum()))
            mode = "any_hit" + suffix
        else:
            call = lambda: kern.trace(o, d, tm, tabs, eps, **kw)
            cnt = call()[2]
            slots = int(cnt[2].sum(dtype=torch.int64)) * kern.slots
            mode = "nearest" + suffix
        ms = graph_ms(call)
        floor, lanes = issue_floor(sass, mode, cnt, slots)
        bnd = checks[name][3]
        phase("kernel", f"{tag} {name} ({mode}, {o.x.shape[0]} lanes): "
              f"{ms:.4f} ms a call in a CUDA graph; bound {bnd[0]:.4f} ms "
              f"by {bnd[1]}, issue-rate floor {floor:.4f} ms ({lanes} lane "
              f"instructions: {slots} slot tests, "
              f"{int(cnt[4].sum(dtype=torch.int64))} node steps)")
        out[name] = (ms, bnd, floor)
    return out


def graph_record(name, source, replaces, launches, check, graph, pool,
                 lanes=BVH_RAYS, where=OPS):
    """A BVH kernel's JSON record (K5, K6, K8, K9, K10, K10b, K11, K12a,
    K12b): times and bound on its phase's set (``check``), the device time
    a call in a CUDA graph and the issue-rate floor on each of the mode's
    sets (``graph_ms``, ``floor_ms``) and, at the frame's own shape
    (``pool``: the set's name, ``lanes`` lanes), its time, bound and
    floor. ``replaces`` is the TPU kernel's file:line under ``where``."""
    rec = record(name, source, where + replaces, launches, *check)
    mine = {k: v for k, v in graph.items()
            if ("NEE" in k) == ("NEE" in pool)}
    ms, bnd, floor = graph[pool]
    rec.update(graph_ms={k: v[0] for k, v in mine.items()},
               floor_ms={k: v[2] for k, v in mine.items()},
               pool=lanes, ms_pool=ms, bound_ms_pool=bnd[0],
               bound_by_pool=bnd[1], floor_ms_pool=floor)
    return rec


def staircase_hires_path(dev):
    """Phases 9, 11 and 12. Returns config 4's profile (phase 14, to run
    after the timed frames) and the JSON records of K8 and K9."""
    t_phase = time.perf_counter()
    frame = bench.FRAMES["staircase_hires"]
    built = bench.build_frame(frame, dev)
    scene, cam = built.scene, built.cam
    more, spp = frame.more
    cfg = built.cfg.replace(ns=spp)  # config 4
    b4 = scene.mesh.bvh4
    phase("scene", f"staircase-hires built in {built.build_s:.1f}"
          f" s: {scene.mesh.num_tris} heap slots, tier "
          f"{wf.mesh_tier(scene, cfg)}, BVH4 {b4.n_nodes} nodes, "
          f"{b4.n_clusters} clusters of {b4.width}, stack_cap "
          f"{b4.stack_cap}, quant {b4.quant}")
    kern = BvhKernels("bvh4", cb4.bvh4_tables(b4))
    checks, rays = bvh_kernel_phase("bvh4 staircase-hires", scene, cam,
                                    cfg, kern)
    pool = pool_sets(scene, cam, cfg, kern)
    tag = "bvh4 staircase-hires"
    checks["pool primary"] = compare_bvh_nearest(
        f"{tag} pool primary", kern, *pool["pool primary"], cfg.epsilon)
    checks["pool NEE shadows"] = compare_bvh_anyhit(
        f"{tag} pool NEE shadows", kern, *pool["pool NEE shadows"],
        cfg.epsilon)
    graph = graph_phase(tag, kern, {**rays, **pool}, checks, cfg.epsilon,
                        BVH4_SASS)
    t_phase = phase_seconds("9", t_phase)

    scfg = RenderConfig(**SMALL)
    sscene, scam = procedural_staircase_scene(scfg.nx, scfg.ny, device=dev,
                                              **frame.scene_kwargs)
    img4 = small_renders("staircase-hires", sscene, scam, scfg,
                         kern.plain())
    for key in cb.LAUNCHES:
        cb.LAUNCHES[key] = 0
    img_h = render_image_regen(sscene, scam, scfg.replace(bvh4=False))
    if min(cb.LAUNCHES["nearest"], cb.LAUNCHES["any_hit"]) <= 0:
        raise AssertionError("bvh4=False did not run the heap kernels")
    r, s = golden.rmse(img_h, img4), golden.ssim(img_h, img4)
    if not (r < RMSE_TOL and s >= SSIM_MIN):
        raise AssertionError(f"heap vs BVH4 small render: rmse {r:.3e} "
                             f"ssim {s:.5f}")
    phase("small", f"staircase-hires bvh4=False (heap kernels "
          f"{dict(cb.LAUNCHES)}) vs BVH4: rmse {r:.3e} ssim {s:.6f} max "
          f"|diff| {np.abs(img_h - img4).max():.3e}")
    t_phase = phase_seconds("11", t_phase)

    # config 4: the bench's staircase-hires frame (2 spp, timed and
    # gated), then 100 spp on the warm frame
    run = frame_run("config4", "staircase-hires", "staircase_hires", built,
                    TIER_KERNELS["bvh4"])
    BENCH_READINGS["staircase_hires"] = run.timed.seconds
    t = checked("config 4", TIER_KERNELS["bvh4"], bench.render_timed, scene,
                cam, cfg)
    launches = {k.split(".")[1]: v for k, v in t.launches.items()}
    if not np.isfinite(t.image).all() or t.image.mean() <= 0:
        raise AssertionError("config 4: non-finite or black image")
    BENCH_READINGS[more] = t.seconds
    paths = cfg.num_pixels * cfg.ns
    phase("config4", f"{cfg.nx}x{cfg.ny} {cfg.ns} spp depth "
          f"{cfg.max_depth}: {t.seconds:.3f} s (CUDA events; host wall "
          f"{t.wall:.3f} s), {paths / t.seconds / 1e6:.3f} Mpaths/s, "
          f"{t.iters} regen iterations ({t.seconds / t.iters * 1e3:.2f} ms "
          f"each), kernel launches {launches}, mean {t.image.mean():.4f}")
    phase_seconds("12", t_phase)
    # profiled later: a profiler session slows the host's launches of the
    # frames timed after it
    profile = functools.partial(profile_frame, "config 4", scene, cam, cfg,
                                itemize=("bvh4",))
    return profile, [
        graph_record("bvh4_trace", "bvh4.cu", "pallas_bvh4.py:295",
                     launches["nearest"], checks["primary"], graph,
                     "pool primary"),
        graph_record("bvh4_occluded", "bvh4.cu", "pallas_bvh4.py:598",
                     launches["any_hit"], checks["NEE shadows"], graph,
                     "pool NEE shadows")]


def near_accept_bound(tab64, o, d, t_min, t_hi):
    """True if some triangle (rows of ``tab64``, [T, 12] float64: v0, e1,
    e2, n) is accepted for the ray ``o``, ``d`` ([3] float64) in (t_min,
    t_hi) to within FAST_DELTA and has its exact u, v, u + v, t or |a|
    within FAST_DELTA of an accept bound: a lane whose outcome a reciprocal
    off by an ulp may flip."""
    v0, e1, e2, n = (tab64[:, 0:3], tab64[:, 3:6], tab64[:, 6:9],
                     tab64[:, 9:12])
    a = -(n @ d)
    s = o - v0
    q = torch.linalg.cross(s, d.expand_as(s))
    u = (q * e2).sum(1) / a
    v = -(q * e1).sum(1) / a
    t = (s * n).sum(1) / a
    dl = FAST_DELTA
    inside = ((a.abs() >= 1e-7 * (1 - dl)) & (u >= -dl) & (v >= -dl)
              & (u + v <= 1 + dl) & (t > t_min * (1 - dl))
              & (t < t_hi * (1 + dl)))
    edge = ((u.abs() <= dl) | (v.abs() <= dl) | ((u + v - 1).abs() <= dl)
            | ((t - t_min).abs() <= dl * t_min)
            | ((t - t_hi).abs() <= dl * abs(t_hi))
            | ((a.abs() - 1e-7).abs() <= dl * 1e-7))
    return bool((inside & edge).any())


def compare_fast_math(tag, kern, origin, direction, t_max, eps, any_hit):
    """K5 (nearest) or K6 (``any_hit``) in fast_math mode against the
    plain walk, which keeps the exact division: where the winners agree, t
    within 2^-20 relative; winners, hits and occlusion equal except on
    lanes near an accept bound (``near_accept_bound``), which are
    counted. Returns (max |t|
    error, or the lanes whose occlusion differs; kernel ms, plain ms,
    bound)."""
    tabs = kern.tabs
    n = origin.x.shape[0]
    args = (origin, direction, t_max, tabs, eps)
    fast = lambda: (cb.heap_occluded if any_hit else cb.heap_trace)(
        *args, approx_recip=True)
    plain = cb._heap_occluded_ref if any_hit else cb._heap_trace_ref
    k = fast()
    t_p, i_p, o_p, c_p, nodes, leaves = kern.walk_plain(
        origin, direction, t_max, eps, any_hit)
    torch.cuda.synchronize()
    if any_hit:
        differ = (k[0] != o_p).nonzero().flatten()
        t_hi, err = t_max, float(differ.numel())
        what = f"occ equal except on {differ.numel()} lanes"
    else:
        t_k, i_k, _ = k
        differ = (i_k != i_p).nonzero().flatten()
        same = (i_k == i_p) & (i_p >= 0)
        dt = (t_k - t_p)[same].abs()
        if bool((dt > FAST_DELTA * t_p[same].abs()).any()):
            raise AssertionError(f"{tag}: t off by {dt.max().item():.3e}")
        t_hi, err = t_p, dt.max().item() if dt.numel() else 0.0
        what = (f"winners equal except on {differ.numel()} lanes, t within "
                f"2^-20 (max |err| {err:.3e})")
    if differ.numel() > 256:
        raise AssertionError(f"{tag}: {differ.numel()} lanes differ")
    tab64 = tabs.tri.double()
    for j in differ.tolist():
        o = torch.stack([c[j] for c in origin]).double()
        d = torch.stack([c[j] for c in direction]).double()
        if not near_accept_bound(tab64, o, d, eps, float(t_hi[j])):
            raise AssertionError(f"{tag}: lane {j} differs with no "
                                 "triangle near an accept bound")
    # the exact and fast_math modes in turns on the same lanes
    exact = lambda: (cb.heap_occluded if any_hit else cb.heap_trace)(*args)
    turns = [cuda_ms(f) for f in (exact, fast, fast, exact)]
    ms = (turns[1] + turns[2]) / 2
    plain_ms = cuda_ms(lambda: plain(*args), reps=2)
    if any_hit:
        bnd = bound(kern.anyhit_flops(n, c_p, o_p, i_p),
                    n * (28 + 1 + 20) + kern.table_bytes(nodes, leaves))
    else:
        bnd = bound(kern.nearest_flops(n, c_p),
                    n * (28 + 8 + 20) + kern.table_bytes(nodes, leaves))
    phase("kernel", f"{tag}: {n} lanes ({int((t_max > 0).sum())} live): "
          f"{what}, each such lane with a triangle within 2^-20 of an "
          f"accept bound; kernel {ms:.3f} ms vs plain (exact) "
          f"{plain_ms:.3f} ms (bound {bnd[0]:.4f} ms by {bnd[1]}); in "
          f"turns exact {turns[0]:.3f}, fast_math {turns[1]:.3f}, "
          f"fast_math {turns[2]:.3f}, exact {turns[3]:.3f} ms")
    return err, ms, plain_ms, bnd


def edge_and_incidence(heap, origin, direction, ids):
    """Of each ray's hit point on heap slot ``ids`` [L], exactly (float64):
    its barycentric distance to the triangle's nearest edge,
    |min(u, v, 1 - u - v)|, and the cosine of the ray's incidence,
    |a| / |n|. The split-bf16 test errs by about its numerators' rounding
    over |a|, so it misjudges hits near an edge or at grazing incidence."""
    rows = heap.tri[ids].double()
    v0, e1, e2, n = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], rows[:, 9:12]
    o = torch.stack(list(origin), 1).double()
    d = torch.stack(list(direction), 1).double()
    a = -(n * d).sum(1)
    q = torch.linalg.cross(o - v0, d)
    u = (q * e2).sum(1) / a
    v = -(q * e1).sum(1) / a
    edge = torch.minimum(torch.minimum(u, v), 1.0 - u - v).abs()
    return edge, a.abs() / n.norm(dim=1)


def mx_departures(tag, mesh, mx_tabs, origin, direction, t_max, eps):
    """Where K10's split-bf16 leaf test departs from the exact K5 on these
    lanes, at 3 and 6 passes: the lanes whose winner is a neighbour of
    K5's (shares a vertex), the pass-throughs (K5 hits, K10 misses or hits
    a triangle that is no neighbour) and the extra hits (K10 hits, K5
    misses), at most MX_DEPART[passes] of the hits; with the median edge
    distance and incidence cosine of those lanes' exact winners (K10's
    where K5 misses) against all hits'. Returns {passes: (neighbour,
    through, extra)}."""
    heap = mx_tabs.heap
    _, i5, _ = cb.heap_trace(origin, direction, t_max, heap, eps)
    hits = int((i5 >= 0).sum())
    verts = torch.stack([mesh.v0, mesh.v1, mesh.v2], 1)  # [T, 3, 3]

    def medians(lanes, ids):
        if lanes.numel() == 0:
            return "-"
        edge, cos = edge_and_incidence(
            heap, V3(*(c[lanes] for c in origin)),
            V3(*(c[lanes] for c in direction)), ids.long())
        return f"{edge.median().item():.4f}, {cos.median().item():.3f}"

    lanes = (i5 >= 0).nonzero().flatten()
    out, parts = {}, [f"all hits {medians(lanes, i5[lanes])}"]
    for passes in cmx.PASSES:
        _, i10, _ = cmx.mx_trace(origin, direction, t_max, mx_tabs, eps,
                                 passes)
        lanes = (i10 != i5).nonzero().flatten()
        a, b = i5[lanes].long(), i10[lanes].long()
        va, vb = verts[a.clamp_min(0)], verts[b.clamp_min(0)]
        near = ((a >= 0) & (b >= 0)
                & (va[:, :, None] == vb[:, None]).all(-1).any(-1).any(-1))
        counts = (int(near.sum()), int(((a >= 0) & ~near).sum()),
                  int((a < 0).sum()))
        if lanes.numel() > MX_DEPART[passes] * hits:
            raise AssertionError(
                f"{tag} at {passes} passes: {lanes.numel()} lanes of {hits} "
                f"hits depart from K5 (bound {MX_DEPART[passes]:.2%})")
        out[passes] = counts
        parts.append(f"{passes} passes: {counts[0]} neighbour winners, "
                     f"{counts[1]} pass-throughs, {counts[2]} extra hits "
                     f"({lanes.numel() / max(hits, 1):.3%} of the hits; "
                     f"{medians(lanes, torch.where(a >= 0, a, b))})")
    phase("kernel", f"{tag}: K10 against K5 on {hits} hits of "
          f"{i5.numel()} lanes (median edge distance, incidence cosine): "
          + "; ".join(parts))
    return out


def heap_variants_phase(scene, cam, cfg, tabs, rays, heap_pool,
                        heap_checks):
    """Phase 10's second half: the heap tier's other kernels on the same
    lanes; K10 and K10b also on the frame's shape (the MX_POOL contiguous
    middle-row pixels and their NEE rays), and each mode's device time a
    call in a CUDA graph; K5/K6's fast_math mode also on K5/K6's pool sets
    (``heap_pool``, with ``heap_checks`` their bounds), timed the same
    way. Returns ({record name: (err, ms, plain_ms, bound)}, the nearest
    modes' from the primary rays; K10/K10b's, K11's and K5/K6's fast_math
    graph_phase times)."""
    out = {}
    mesh, eps = scene.mesh, cfg.epsilon
    o1, d1, t1 = rays["primary"]
    o2, d2, t2 = rays["bounce-2"]
    shadow = rays["NEE shadows"]
    mx_tabs = cmx.mx_tables(mesh)
    mx = BvhKernels("heap-mx", mx_tabs)
    out["mx_trace"] = compare_bvh_nearest("heap-mx dragon primary", mx, o1,
                                          d1, t1, eps)
    compare_bvh_nearest("heap-mx dragon bounce-2", mx, o2, d2, t2, eps)
    out["mx_occluded"] = compare_bvh_anyhit("heap-mx dragon NEE shadows",
                                            mx, *shadow, eps)
    pool = pool_sets(scene, cam, cfg, mx, MX_POOL)
    checks = {"primary": out["mx_trace"], "NEE shadows": out["mx_occluded"],
              "pool primary": compare_bvh_nearest(
                  "heap-mx dragon pool primary", mx, *pool["pool primary"],
                  eps),
              "pool NEE shadows": compare_bvh_anyhit(
                  "heap-mx dragon pool NEE shadows", mx,
                  *pool["pool NEE shadows"], eps)}
    mx_graph = graph_phase("heap-mx dragon", mx,
                           {"primary": rays["primary"],
                            "NEE shadows": shadow, **pool}, checks, eps,
                           MX_SASS)
    for name in ("primary", "bounce-2"):
        mx_departures(f"heap-mx dragon {name}", mesh, mx_tabs, *rays[name],
                      eps)
    occ6 = cb.heap_occluded(*shadow, tabs, eps)[0]
    flips = {p: int((cmx.mx_occluded(*shadow, mx_tabs, eps, p)[0]
                     != occ6).sum()) for p in cmx.PASSES}
    phase("kernel", f"heap-mx dragon NEE shadows: K10b's occlusion differs "
          f"from K6's on {flips[3]} lanes at 3 passes, {flips[6]} at 6, of "
          f"{int((shadow[2] > 0).sum())} shadow rays")
    rg = BvhKernels("heap-rg", tabs)
    rg_sets = {"primary": rays["primary"], "bounce-2": rays["bounce-2"],
               "pool primary": heap_pool["pool primary"]}
    rg_checks = {name: compare_bvh_nearest(f"heap-rg dragon {name}", rg,
                                           *r, eps)
                 for name, r in rg_sets.items()}
    out["rg_trace"] = rg_checks["primary"]
    for name, (o, d, t) in rg_sets.items():
        v5 = int(cb.heap_trace(o, d, t, tabs, eps)[2][2].sum())
        ratio = int(crg.rg_trace(o, d, t, tabs, eps)[2][2].sum()) / max(v5,
                                                                        1)
        if not 1.0 <= ratio <= 1.5:
            raise AssertionError(f"heap-rg dragon {name}: K11's leaf visits "
                                 f"are {ratio:.3f}x K5's, outside [1, 1.5]")
        # K5 and K11 in turns on the same lanes, device time in a graph
        k5 = lambda: cb.heap_trace(o, d, t, tabs, eps)
        k11 = lambda: crg.rg_trace(o, d, t, tabs, eps)
        turns = [graph_ms(f) for f in (k5, k11, k11, k5)]
        phase("kernel", f"heap-rg dragon {name}: K11's leaf visits "
              f"{ratio:.3f}x K5's {v5} (window {crg.WINDOW}; bound 1.5x); in "
              f"turns, ms a call in a CUDA graph: K5 {turns[0]:.4f}, K11 "
              f"{turns[1]:.4f}, K11 {turns[2]:.4f}, K5 {turns[3]:.4f}")
    rg_graph = graph_phase("heap-rg dragon", rg, rg_sets, rg_checks, eps,
                           RG_SASS)
    heap = BvhKernels("heap", tabs)
    out["heap_trace_fast_math"] = compare_fast_math(
        "fast_math dragon primary", heap, o1, d1, t1, eps, False)
    compare_fast_math("fast_math dragon bounce-2", heap, o2, d2, t2, eps,
                      False)
    out["heap_occluded_fast_math"] = compare_fast_math(
        "fast_math dragon NEE shadows", heap, *shadow, eps, True)
    for name, (o, d, t) in heap_pool.items():
        compare_fast_math(f"fast_math dragon {name}", heap, o, d, t, eps,
                          "NEE" in name)
    fm_graph = graph_phase("fast_math dragon", heap,
                           {"primary": rays["primary"],
                            "NEE shadows": shadow, **heap_pool},
                           heap_checks, eps, HEAP_SASS, fast_math=True)
    return out, mx_graph, rg_graph, fm_graph


def mr_sass():
    """({mode: (slot, node round, merge)}, W): the warp instructions of
    csrc/bvh_mr.cu's split walk in this run's build (its ``cuobjdump
    -sass``, counted by ``bvh_mr_ab.mr_sass``: a slot test, a node
    round's loads, slab tests and votes, a leaf round's merge by a warp)
    and the source's warps a packet. Raises if the build holds another
    form."""
    return (mr_ab.mr_sass(common.sass_dump(_build.library_path("bvh_mr"))),
            mr_ab.warps_per_packet(
                (_build.CSRC_DIR / "bvh_mr.cu").read_text()))


def mr_phase(tabs, sets, eps, checks):
    """Phase 10c: the packet walk, K12a (nearest) on the primary rays and
    K12b (any-hit) on their NEE shadow rays, at 131,072 lanes and at the
    dragon's 196,608-lane pool (``sets``: name: (origin, direction,
    t_max), NEE sets in any-hit), the launch counts set to 0 just before
    and read just after; each against its plain version (t, winners,
    features, occlusion and the per-packet counters bit-equal), against
    K5 / K6 (t and occlusion equal, winners equal but on exact ties). The
    function is K5's / K6's on the same lanes, so the bound is theirs
    (``checks``: phase 10's compare_bvh_* results on the same sets, from
    the per-ray work and distinct rows their walks need). Beside it: the
    packet walk's own work (32 lanes x the packets' node rounds, two slab
    tests each, and leaf slots, and the distinct rows it reads), its
    issue-rate floor (``mr_sass``: the build's SASS a slot, a node round
    and a leaf round's merge, for this run's rounds and visits), the
    per-packet distribution of node rounds, leaf rounds and leaf visits,
    and each mode's device time a call in a CUDA graph, in turns with K5
    / K6: the kernel's launch (``cuda_bvh_mr._launch``; K12a without the
    winner's features, which K5's call does not compute either). Returns
    the JSON records of K12a and K12b."""
    torch.cuda.synchronize()
    for key in cmr.LAUNCHES:
        cmr.LAUNCHES[key] = 0
    got = {name: (cmr.mr_occluded if "NEE" in name else cmr.mr_trace)(
        o, d, tm, tabs, eps) for name, (o, d, tm) in sets.items()}
    torch.cuda.synchronize()
    launches = dict(cmr.LAUNCHES)
    if min(launches.values()) <= 0:
        raise AssertionError(f"the packet-walk path launched {launches}")
    sass, W = mr_sass()
    P = tabs.prims_per_leaf
    calls, info = {}, {}
    for name, (o, d, tm) in sets.items():
        any_hit = "NEE" in name
        tag = f"mr dragon {name}"
        n = o.x.shape[0]
        visits = {"nodes": [], "leaves": []}
        t_p, i_p, occ_p, c_p, rounds, leaf_rounds = mr_ab.packet_walk(
            o, d, tm, tabs, eps, any_hit, visits)
        if any_hit:
            occ_k, cnt = got[name]
            occ6, cnt6 = cb.heap_occluded(o, d, tm, tabs, eps)
            if not (torch.equal(occ_k, occ_p) and torch.equal(cnt, c_p)):
                raise AssertionError(f"{tag}: K12b differs from its plain "
                                     f"version on "
                                     f"{int((occ_k != occ_p).sum())} lanes")
            if not torch.equal(occ_k, occ6):
                raise AssertionError(f"{tag}: K12b's occlusion differs from "
                                     f"K6's on {int((occ_k != occ6).sum())} "
                                     "lanes")
            what = (f"occlusion equal to the plain walk's and K6's "
                    f"({int(occ_k.sum())} occluded of "
                    f"{int((tm > 0).sum())} shadow rays)")
            err = 0.0
            calls[name] = (lambda o=o, d=d, tm=tm: cmr._launch(
                cmr._ANY_HIT, o, d, tm, tabs, eps), lambda o=o, d=d, tm=tm:
                cb.heap_occluded(o, d, tm, tabs, eps),
                lambda o=o, d=d, tm=tm: cmr._mr_occluded_ref(o, d, tm, tabs,
                                                             eps))
        else:
            near_k, cnt = got[name]
            t_k, i_k = near_k[:2]
            p_out = cb.winner_features(o, d, t_p, i_p, tabs.tri_feat)
            if not (all(torch.equal(a, b) for a, b in zip(near_k, p_out))
                    and torch.equal(cnt, c_p)):
                raise AssertionError(f"{tag}: K12a differs from its plain "
                                     f"version on "
                                     f"{int((i_k != i_p).sum())} winners, "
                                     f"{int((t_k != t_p).sum())} t")
            t5, i5, cnt6 = cb.heap_trace(o, d, tm, tabs, eps)
            if not torch.equal(t_k, t5):
                raise AssertionError(f"{tag}: K12a's t differs from K5's on "
                                     f"{int((t_k != t5).sum())} lanes")
            # t is equal on every lane, so a winner that differs is a tie
            ties = int((i_k != i5).sum())
            what = (f"t, winners, features and counters equal to the plain "
                    f"walk's; t equal to K5's, winners but {ties} exact "
                    f"ties; hits {int((i_k >= 0).sum())}")
            err = (t_k - t_p).abs().max().item()
            calls[name] = (lambda o=o, d=d, tm=tm: cmr._launch(
                cmr._NEAREST, o, d, tm, tabs, eps), lambda o=o, d=d, tm=tm:
                cb.heap_trace(o, d, tm, tabs, eps),
                lambda o=o, d=d, tm=tm: cmr._mr_trace_ref(o, d, tm, tabs,
                                                          eps))
        n_rounds = int(rounds.sum())
        leaves = int(cnt[2].sum(dtype=torch.int64))
        flops = 3 * n + cmr.LANES * (n_rounds * 2 * SLAB_FLOPS
                                     + leaves * P * MT_FLOPS)
        nodes, leaves_read = distinct(visits["nodes"]), distinct(
            visits["leaves"])
        walk = bound(flops, n * (28 + (1 if any_hit else 8))
                     + cnt.numel() * 4 + nodes * HEAP_NODE
                     + leaves_read * P * TRI_ROW_BYTES)
        mode = "any_hit" if any_hit else "nearest"
        floor, ins = mr_ab.issue_floor(sass[mode], P, W, rounds,
                                       leaf_rounds, cnt[2])
        info[name] = (err, what, walk, floor, ins, cnt, rounds, leaf_rounds,
                      cnt6, nodes, leaves_read)
    times = graph_rounds(["K12", "K5"], list(sets), lambda who, name:
                         calls[name][who == "K5"](), MR_ROUNDS)
    graph, recs = {}, []
    for name in sets:
        err, what, walk, floor, ins, cnt, rounds, leaf_rounds, cnt6, \
            nodes, leaves_read = info[name]
        any_hit = "NEE" in name
        heap, kern = ("K6", "K12b") if any_hit else ("K5", "K12a")
        bnd = checks[name][3]
        ms, ms5 = times["K12", name], times["K5", name]
        graph[name] = (ms, bnd, floor)
        s6 = (cnt6[0] + cnt6[1]).double()
        phase("kernel", f"mr dragon {name}: {sets[name][0].x.shape[0]} "
              f"rays in {cnt.shape[1]} packets: {what}; "
              + mr_ab.describe(cnt, rounds, leaf_rounds)
              + f"; {heap} per ray {s6.mean().item():.1f} steps entering a "
              f"child, {cnt6[2].double().mean().item():.1f} leaf visits; "
              f"read {nodes} distinct node rows, {leaves_read} leaves; "
              f"device time a call in a CUDA graph, median of {MR_ROUNDS} "
              f"in turns: {kern} {ms:.4f} ms, {heap} {ms5:.4f} ms; bound "
              f"{bnd[0]:.4f} ms by {bnd[1]} ({heap}'s), the packet walk's "
              f"own work {walk[0]:.4f} ms by {walk[1]}, issue-rate floor "
              f"{floor:.4f} ms ({ins} warp instructions: SASS (slot, node "
              f"round, merge) {sass['any_hit' if any_hit else 'nearest']}, "
              f"{W} warps a packet)")
    for name in ("primary", "NEE shadows"):
        any_hit = "NEE" in name
        plain_ms = cuda_ms(calls[name][2], reps=2)
        rec = graph_record(
            "mr_occluded" if any_hit else "mr_trace", "bvh_mr.cu",
            "experiments/pallas_bvh_mr.py:214",
            launches["any_hit" if any_hit else "nearest"],
            (info[name][0], graph[name][0], plain_ms, checks[name][3]),
            graph, f"pool {name}", MX_POOL, where="")
        # K5's / K6's device time a call in the same turns
        rec["heap_graph_ms"] = {k: times["K5", k] for k in sets
                                if ("NEE" in k) == any_hit}
        recs.append(rec)
    return recs


# K13's SHFL a leaf phase's round keeps in each mode: the ray's 8 values
# broadcast (o, d, closest, its node), and in full and nomt the pair's
# 4-step tree and the owner's fetch of the sum
K13_SHFL = {"full": 13, "nomt": 13, "noleaf": 8}


def walk_probe_phase(tabs, rays, pool, eps):
    """Phase 10d: the walk probes on phase 10's primary lanes and the
    dragon's 196,608-lane pool (``pool``: pool_sets'), the launch counts
    set to 0 just before and read just after. ``iter_ablate.measure``:
    K13's modes held bit-equal to their plain walks (acc and counters,
    equal across modes), then K5 and the three modes timed in turns,
    device time a call in a CUDA graph, on each set with closest
    held at t_max (no culling, as the TPU probe) and at K5's hit t (a
    subset of K5's visits), the split of each printed; each mode beside
    its bound and the issue-rate floor of the build's SASS
    (``iter_ablate.mode_sass``: a slot, a node step, a leaf round), which
    must keep every broadcast's shuffle (K13_SHFL). K16
    (``dual_probe.measure``) at R = 1, 2, 4 held bit-equal to the plain
    node phase (``dual_probe.hold`` also on the primary and pool primary
    rays together, more than any R's wave seats with no refill) and
    timed in turns, device time a call in a CUDA graph,
    beside its resident warps an SM (equal at every R, else it raises),
    the issue-rate floor of the build's SASS (``dual_probe.walk_sass``:
    raises unless each form's walk loop holds the refill's atomic) and
    the latency floor (the longest ray's steps, each a walk loop's issue
    on one warp and one of K17a's round trips, ``l2`` and ``smem``,
    measured here by ``tpu_micro.round_trips``). Bounds from the node
    steps and leaf slots the counters report and the distinct rows the
    plain walks read.
    Returns the JSON records of K13's three modes (the primary rays' no-
    culling reading, the others beside it) and K16's three forms."""
    t_phase = time.perf_counter()
    dump = common.sass_dump(_build.library_path("iter_ablate"))
    sass = ia.mode_sass(dump)
    shfl = {ia.MODES[int(name.split("ablate_kernelILi")[1][0])]: c[1]
            for name, c in common.sass_counts(dump, ops=("SHFL",)).items()
            if "ablate_kernelILi" in name}
    if any(shfl[m] < k for m, k in K13_SHFL.items()):
        raise AssertionError(f"K13's build dropped a leaf round's shuffles: "
                             f"SHFL {shfl}, at least {K13_SHFL}")
    sets = {"primary": rays["primary"], "pool primary": pool["pool primary"]}
    torch.cuda.synchronize()
    bench.reset_launches((ia, dp))
    readings = {}
    for name, (o, d, tm) in sets.items():
        for hits in (False, True):
            readings[name, hits] = ia.measure(
                o, d, tm, tabs, eps, at_k5_hits=hits, rounds=2,
                time_plain=(name, hits) == ("primary", False))
    k16 = dp.measure(rays["primary"][0], rays["primary"][1], tabs, rounds=2)
    # every R's refill, R = 4's too, on more rays than its wave seats at once
    big = [V3(*(torch.cat((a, b)) for a, b in zip(u, v))) for u, v in
           zip(rays["primary"][:2], pool["pool primary"][:2])]
    seats = {r: r * dp.lanes(r) for r in dp.RAYS_PER_THREAD}
    if big[0].x.shape[0] <= max(seats.values()):
        raise AssertionError(f"K16's check set ({big[0].x.shape[0]} rays) "
                             f"does not reach the refill: {seats}")
    dp.hold(*big, tabs)
    # K17a's dependent load a step, l2 and smem, for K16's latency floor
    trips = um.round_trips(um.probe_inputs(rays["primary"][0].x.device))
    launches = {**{f"iter_ablate.{k}": v for k, v in ia.LAUNCHES.items()},
                **{f"dual_probe.{k}": v for k, v in k16["launches"].items()}}
    if min(launches.values()) <= 0:
        raise AssertionError(f"the walk-probe path launched {launches}")
    P = tabs.prims_per_leaf
    bnds, floors = {}, {}
    for (name, hits), r in readings.items():
        n = sets[name][0].x.shape[0]
        cnt = r["counters"]["modes"]
        c = cnt.sum(dim=1, dtype=torch.int64)
        c5 = r["counters"]["K5"].sum(dim=1, dtype=torch.int64)
        for m in ia.MODES:
            flops = 3 * n + int(c[4]) * 2 * SLAB_FLOPS
            nbytes = n * (28 + 4 + 20) + r["nodes"] * HEAP_NODE
            if m != "noleaf":
                nbytes += r["leaves"] * P * TRI_ROW_BYTES
            if m == "full":
                flops += int(c[2]) * P * MT_FLOPS
            bnds[name, hits, m] = bound(flops, nbytes)
            floors[name, hits, m] = ia.issue_floor(sass[m], cnt, P)[0]
        tag = "closest at K5's hit t" if hits else ("closest at t_max, no "
                                                   "culling")
        phase("kernel", f"K13 dragon {name} ({n} rays), {tag}: every mode's "
              f"acc and counters bit-equal to its plain walk; "
              f"{int(c[4])} node steps and "
              f"{int(c[2])} leaf visits (K5 {int(c5[4])} and {int(c5[2])}), "
              f"{r['nodes']} distinct node rows, {r['leaves']} leaves; "
              f"device time a call in a CUDA graph, 2 rounds in turns: "
              + ", ".join(f"{m} {r['ms'][m]:.4f} ms (bound "
                          f"{bnds[name, hits, m][0]:.4f} by "
                          f"{bnds[name, hits, m][1]}, issue-rate floor "
                          f"{floors[name, hits, m]:.4f})" for m in ia.MODES)
              + f"; split of full: {ia.split_text(r)}")
    phase("kernel", f"K13 SASS of this build (warp instructions: slot, node "
          f"step, leaf round) {sass}, SHFL {shfl}")
    recs = []
    r = readings["primary", False]
    for m in ia.MODES:
        rec = record(f"iter_ablate_{m}", "iter_ablate.cu",
                     "experiments/iter_ablate.py:60",
                     launches[f"iter_ablate.{m}"], 0.0, r["ms"][m],
                     r["plain_ms"][m], bnds["primary", False, m])
        key = lambda name, hits: f"{name}{', at K5 hit t' if hits else ''}"
        rec.update(graph_ms={key(*k): v["ms"][m]
                             for k, v in readings.items()},
                   k5_ms={key(*k): v["ms"]["K5"]
                          for k, v in readings.items()},
                   floor_ms={key(*k[:2]): v for k, v in floors.items()
                             if k[2] == m},
                   bound_ms_by_set={key(*k[:2]): v[0]
                                    for k, v in bnds.items() if k[2] == m})
        recs.append(rec)

    n = rays["primary"][0].x.shape[0]
    total, longest = k16["total"], k16["longest"]
    bnd = bound(3 * n + total * 2 * SLAB_FLOPS,
                n * (24 + 4) + k16["nodes"] * HEAP_NODE)
    # raises unless each R form's walk loop holds the refill's atomic
    sass16 = dp.walk_sass(common.sass_dump(_build.build("dual_probe")))
    if len(set(k16["warps"].values())) != 1:
        raise AssertionError(f"K16's R forms run different warps an SM: "
                             f"{k16['warps']}")
    text = []
    for r in dp.RAYS_PER_THREAD:
        t, readings = k16["ms"][r], k16["readings"][r]
        floor = dp.issue_floor_ms(sass16[r], total, n, r, dp.lanes(r))
        lat = {m: dp.latency_floor_ms(sass16[r], longest, trips[m])
               for m in um.GATHER_MODES}
        text.append(f"R={r} {t:.4f} ms ({t * 1e6 / total:.3f} ns a step; "
                    f"readings {min(readings):.4f}-{max(readings):.4f}; "
                    f"{k16['warps'][r]} warps an SM; walk loop {sass16[r]} "
                    f"(a pass, a refill, atomics, a seat), issue-rate floor "
                    f"{floor:.4f} ms, latency floor {lat['l2']:.4f} (l2) / "
                    f"{lat['smem']:.4f} ms (smem))")
        rec = record(f"dual_probe_r{r}", "dual_probe.cu",
                     "experiments/dual_probe.py:37",
                     launches[f"dual_probe.r{r}"], 0.0, t, k16["plain_ms"],
                     bnd)
        rec.update(warps_per_sm=k16["warps"][r], ns_a_step=t * 1e6 / total,
                   sass=sass16[r], floor_ms=floor,
                   latency_floor_ms=lat, longest=longest)
        recs.append(rec)
    phase("kernel", f"K16 dragon primary: {n} rays, {total} interior steps "
          f"(the longest ray {longest}), bit-equal to the plain node phase "
          f"at every R, and on the primary and pool primary rays together "
          f"({big[0].x.shape[0]}, past every R's first {seats}); device time a call in a CUDA graph, 2 rounds in "
          f"turns: " + ", ".join(text) + f"; plain {k16['plain_ms']:.3f} ms "
          f"(bound {bnd[0]:.4f} ms by {bnd[1]}); K17a's round trips "
          f"(1,024 lanes, this run) l2 {trips['l2']:.1f} ns, smem "
          f"{trips['smem']:.1f} ns; launches {launches}; phase 10d "
          f"in {time.perf_counter() - t_phase:.1f} s")
    return recs


def leaf_probe_phase(dev):
    """Phase 15: the leaf-fetch probes on the TPU probes' seeded inputs,
    the launch counts set to 0 just before and read just after.
    ``leafmt_probe.measure``: K14's modes, a visit tested by the warp in
    K5's split (16 lanes a ray, the (t, slot) shuffle merge), each held
    bit-equal to its plain version at one 1024-ray tile (8 blocks on 8
    SMs; V = 1024 and 17,408) and at the dragon's 196,608-lane pool (192
    tiles; V = 128 and 1,152), past the 611 clusters' wrap (db2 is checked
    and takes db's times: db's kernel), then timed in turns, device time a
    call in a CUDA graph: ns a visit at each shape beside the bound (the
    shape's rays) and the issue-rate floor of the build's SASS
    (``leafmt_probe.mode_sass``: a slot, a pass, a visit; it raises unless
    the slot loop is the 16-lane split and db's visit holds its bulk copy
    and mbarrier wait), and the B-17 reading (dma - pure: the per-lane
    fetch; dma - db: what the bulk-copy ring hides). ``dma_probe.measure``:
    K15's two bulk-copy chains held bit-equal to the plain in-order sum at
    k = 16,384 and 131,072 copies and timed in turns there (CUDA graphs):
    ns a copy and sync - db, beside the bound and the chain loop's issue
    floor (``dma_probe.copy_sass``, which raises without the bulk copy or
    the wait). The records' times, plain times and bounds are at the
    pool's (K14) and the pair's (K15) lower point. Returns the JSON
    records of K14's modes and K15's two kernels."""
    t_phase = time.perf_counter()
    k14_sass = lm.mode_sass(common.sass_dump(_build.build("leafmt_probe")))
    k15_sass = dm.copy_sass(common.sass_dump(_build.build("dma_probe")))
    torch.cuda.synchronize()
    bench.reset_launches((lm, dm))
    k14 = lm.measure(dev, rounds=1)
    k15 = dm.measure(dm.probe_blocks(device=dev), rounds=1)
    launches = {**{f"leafmt_probe.{k}": v for k, v in k14["launches"].items()},
                **{f"dma_probe.{k}": v for k, v in k15["launches"].items()}}
    if min(launches.values()) <= 0:
        raise AssertionError(f"the leaf-probe path launched {launches}")
    recs = []
    bnds, floors = {}, {}
    for m in lm.MODES:
        for s, (_, vs) in lm.SHAPES.items():
            n = k14["n"][s]
            for v in vs:
                bnds[m, s, v] = bound(
                    MT_FLOPS * lm.WIDTH * n * v,
                    n * (28 + 8) + lm.WIDTH * TRI_ROW_BYTES * (
                        1 if m in ("pure", "cond") else min(v, lm.CLUSTERS)))
                floors[m, s, v] = lm.issue_floor(
                    k14_sass[lm.SERVED_BY.get(m, m)], n, v)[0]
        lo = lm.POOL_VISITS[0]
        rec = record(f"leafmt_{m}", "leafmt_probe.cu",
                     "experiments/leafmt_probe.py:36",
                     launches[f"leafmt_probe.{m}"], 0.0,
                     k14["ms"][m, "pool", lo], k14["plain_ms"][m, "pool"],
                     bnds[m, "pool", lo])
        rec.update(graph_ms={f"{s} V={v}": k14["ms"][m, s, v]
                             for s, (_, vs) in lm.SHAPES.items() for v in vs},
                   ns_a_visit={s: k14["per_visit"][m, s] for s in lm.SHAPES},
                   floor_ms={f"{s} V={v}": f for (mm, s, v), f in
                             floors.items() if mm == m},
                   bound_ms_by_cell={f"{s} V={v}": b[0] for (mm, s, v), b in
                                     bnds.items() if mm == m},
                   plain_ms_tile=k14["plain_ms"][m, "tile"],
                   sass=k14_sass[lm.SERVED_BY.get(m, m)])
        if m in lm.SERVED_BY:
            rec["served_by"] = lm.SERVED_BY[m]
        else:
            rec["blocks_per_sm"] = k14["blocks_per_sm"][m]
        recs.append(rec)
    for s, (tiles, (lo, hi)) in lm.SHAPES.items():
        text = [f"{m} {k14['per_visit'][m, s]:.1f} ns a visit "
                f"({k14['per_visit'][m, s] / lm.WIDTH:.2f} a slot; t({lo}) "
                f"{k14['ms'][m, s, lo]:.4f} ms, t({hi}) "
                f"{k14['ms'][m, s, hi]:.4f} ms; bound at V={lo} "
                f"{bnds[m, s, lo][0]:.4f} ms by {bnds[m, s, lo][1]}, "
                f"issue-rate floor {floors[m, s, lo]:.4f} ms; plain "
                f"{k14['plain_ms'][m, s]:.3f} ms)" for m in lm.TIMED]
        b17 = lm.b17(k14["per_visit"], s)
        phase("kernel", f"K14 {s}: {k14['n'][s]} rays ({tiles} tiles of "
              f"8 blocks of 128), every mode bit-equal to its plain version "
              f"at V={lo} and {hi} (db2: db's kernel and times); device "
              f"time a call in a CUDA graph, in turns: " + "; ".join(text)
              + "; B-17: " + ", ".join(f"{k} {v:.1f} ns a visit ({sh:.1%} "
                                      f"of dma)" for k, (v, sh) in
                                      b17.items()))
    phase("kernel", f"K14 SASS of this build (slot, pass, visit) {k14_sass}; "
          f"resident blocks an SM {k14['blocks_per_sm']}")
    lo, hi = dm.COPIES
    per = k15["per_copy"]
    ROUND_TRIPS["k15a"] = per["sync"]  # K22's latency floor (phase 17)
    for m, line in zip(dm.MODES, ("experiments/dma_probe.py:36",
                                  "experiments/dma_probe.py:50")):
        copies = lo + (m == "db")  # db drains one copy past the chain
        rec = record(f"dma_{m}", "dma_probe.cu", line,
                     launches[f"dma_probe.{m}"], 0.0, k15["t"][m][0],
                     k15["plain_ms"],
                     bound(lo, copies * 4 * dm.CLUSTER_FLOATS + 4))
        rec.update(ns_a_copy=per[m], graph_ms_hi=k15["t"][m][1],
                   floor_ms=dm.issue_floor(k15_sass[m][0], lo),
                   sass=k15_sass[m])
        recs.append(rec)
    phase("kernel", f"K15: sync and db (one warp, a bulk copy a cluster on "
          f"an mbarrier) equal to the plain in-order sum at {lo} and {hi} "
          f"copies; device time a call in a CUDA graph, in turns: " +
          ", ".join(f"{r['name'][4:]} {r['ns_a_copy']:.1f} ns a copy "
                    f"(t({lo}) {r['ms']:.3f} ms, bound {r['bound_ms']:.4f} "
                    f"ms by bytes, issue-rate floor {r['floor_ms']:.4f} ms; "
                    f"chain loop {r['sass']})" for r in recs[-2:])
          + f"; sync - db {per['sync'] - per['db']:.1f} ns a copy hidden by "
          f"the prefetch; launches {launches}; phase 15 in "
          f"{time.perf_counter() - t_phase:.1f} s")
    return recs


# experiments/tpu_micro.py: each kernel's TPU body and the FP32 operations
# a lane-step (compares and integer steps not counted): K17a's add; K17b's
# 3 subtractions, 3 products, 2 maxima, its acc add and ~1 a lane for the
# block sum; K17c's 8 adds; K18's add a lane of row 0; K19/K20's 46 of the
# "MT-ish" test (csrc/tpu_micro.cu mt_ish, the division one) a lane and
# triangle
MICRO = {"e3_l2": ("K17a", 123, 1), "e3_smem": ("K17a", 123, 1),
         "e4": ("K17b", 154, 10), "e7": ("K17c", 254, 8),
         "e5": ("K18", 187, 1), "e8": ("K19", 299, 46 * um.BLOCK[1]),
         "e9": ("K20", 367, 46 * um.BLOCK[1])}


def micro_bound(key, lanes, steps, clusters=0):
    """The bound of one micro kernel at ``lanes`` and ``steps``: its FP32
    operations, and its bytes: each input and output once (K17a-K17c, the
    whole table), or the bytes its steps copy (K18: the 8 KB blocks);
    K19/K20: the 9 used rows of each of the chain's ``clusters`` distinct
    clusters once, and ox in and best out (``tpu_micro.leaf_bytes``)."""
    flops = MICRO[key][2] * lanes * steps
    table = 4 * um.ROWS * um.T
    nbytes = {"e3_l2": table + 8 * lanes, "e3_smem": table + 8 * lanes,
              "e4": table + 8 * lanes, "e7": table + 4 * lanes * 9,
              "e5": steps * 4 * um.BLOCK[0] * um.BLOCK[1] + 4 * lanes,
              "e8": um.leaf_bytes(clusters),
              "e9": um.leaf_bytes(clusters)}[key]
    return bound(flops, nbytes)


cases_module = common.cases_module


def leaf_checks(dev, dump):
    """K19/K20 before phase 16's run: the build's SASS (``leaf_sass``:
    raises on another form; K19 holds the bulk copy and the mbarrier wait,
    K20 neither), each launch spread over more than one block, and both
    kernels bit-equal to the plain version at 0, 1 and each case's leaves
    on every case of tests/leaf_cases.py. Returns (SASS, launch shapes,
    ptxas lines). ``dump``: the build's SASS."""
    lib = _build.build("tpu_micro")
    sass = um.leaf_sass(dump)
    ops = {("E8" if "leaf_smem" in n else "E9"):
           {common.opcode(i) for _, i in c}
           for n, c in common.sass_functions(dump).items() if "leaf_" in n}
    for op in (common.BULK_COPY, common.BARRIER_WAIT):
        if not any(o.startswith(op) for o in ops["E8"]):
            raise AssertionError(f"K19's SASS holds no {op}")
        if any(o.startswith(op) for o in ops["E9"]):
            raise AssertionError(f"K20's SASS holds {op}")
    shapes = {exp: um.leaf_shape(exp) for exp in um.LEAF_MODES}
    for exp, (blocks, threads, _) in shapes.items():
        if blocks <= 1:
            raise AssertionError(f"{exp} launches {blocks} block")
    cases = cases_module("leaf_cases")
    for name in cases.LEAF_CASES:
        blocks, x, steps = cases.leaf_case(name)
        blocks = torch.from_numpy(blocks).to(dev)
        x = torch.from_numpy(x).to(dev)
        for k in sorted({0, 1, steps}):
            for exp, mode in um.LEAF_MODES.items():
                got = um.leaf_chain(blocks, x, k, exp)
                want = um._leaf_ref(blocks, x, k, mode)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"{exp} on the edge case {name} at "
                                         f"{k} leaves: kernel != plain on "
                                         f"{int((got != want).sum())} lanes")
    ptx = um.kernel_ptxas(lib.with_suffix(".log").read_text())
    return sass, shapes, {k: ptx[k] for k in ("E8", "E9")}


def micro_checks(dev, dump):
    """K17a-K17c before phase 16's run: the build's SASS (``gather_sass``:
    one bulk copy, one mbarrier wait and no staging loop in K17a smem;
    ``vote_sass``: one block-wide barrier in K17b's step loop;
    ``onehot_sass``: one 16 B load a lane in K17c's), the kernels
    bit-equal to their plain versions with NaN equal to NaN
    (``tpu_micro.same``) at 0, 1 and each case's steps on every E3 (both
    modes), E4 and E7 case of tests/micro_cases.py, K17c's view bit-equal
    to the plain view, and every table of its ``REFUSED`` refused (ROADMAP
    C-20). ``dump``: the build's SASS. Returns (K17a's SASS by mode,
    K17b's, K17c's, ptxas lines by kernel)."""
    lib = _build.build("tpu_micro")
    vote, onehot = um.vote_sass(dump), um.onehot_sass(dump)
    gather = um.gather_sass(dump)
    if gather["smem"][2:] != (1, 1, 0):
        raise AssertionError(f"K17a smem's build holds {gather['smem'][2]} "
                             f"bulk copies, {gather['smem'][3]} mbarrier "
                             f"waits and {gather['smem'][4]} staging loops, "
                             f"not 1, 1 and 0")
    if vote[1] != 1:
        raise AssertionError(f"K17b's step loop holds {vote[1]} block-wide "
                             f"barriers, not one")
    if onehot[1:] != (1, 1):
        raise AssertionError(f"K17c's step loop holds {onehot[1]} global "
                             f"loads, {onehot[2]} of 16 B, not one")
    cases = cases_module("micro_cases")
    on = lambda arrays: [torch.from_numpy(a).to(dev) for a in arrays]
    for name, steps in cases.GATHER_CASES.items():
        table, idx = on(cases.gather_case(name))
        for k in sorted({0, 1, steps}):
            want = um._gather_ref(table, idx, k)
            for m in um.GATHER_MODES:
                got = um.gather_chain(table, idx, k, m)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"K17a {m} on the case {name} at "
                                         f"{k} steps: kernel != plain on "
                                         f"{um.differ(got, want)} lanes")
    for name, steps in cases.VOTE_CASES.items():
        rows, x = on(cases.vote_case(name))
        for k in sorted({0, 1, steps}):
            got, want = um.row_vote_chain(rows, x, k), um._row_vote_ref(
                rows, x, k)
            torch.cuda.synchronize()
            if not um.same(got, want):
                raise AssertionError(f"K17b on the case {name} at {k} steps:"
                                     f" kernel != plain on "
                                     f"{um.differ(got, want)} lanes")
    for name, steps in cases.ONEHOT_CASES.items():
        table, idx = on(cases.onehot_case(name))
        view = um.onehot_view(table)
        if not torch.equal(view.view(torch.int16),
                           um._view_ref(table).view(torch.int16)):
            raise AssertionError(f"K17c's view of the case {name} != plain")
        for k in sorted({0, 1, steps}):
            got, want = um.onehot_chain(table, idx, k), um._onehot_ref(
                table, idx, k)
            torch.cuda.synchronize()
            if not um.same(got, want):
                raise AssertionError(f"K17c on the case {name} at {k} steps:"
                                     f" kernel != plain on "
                                     f"{um.differ(got, want)} lanes")
    _, idx = on(cases.onehot_case("ties"))
    for name in cases.REFUSED:
        try:
            um.onehot_chain(*on([cases.refused_table(name)]), idx, 1)
        except ValueError:
            continue
        raise AssertionError(f"K17c took the table {name}, which is not "
                             f"finite in bf16 (C-20)")
    phase("kernel", f"K17a-K17c: bit-equal to plain (NaN equal to NaN) on "
          f"the cases {', '.join(cases.GATHER_CASES)} (K17a, both modes), "
          f"{', '.join(cases.VOTE_CASES)} and "
          f"{', '.join(cases.ONEHOT_CASES)}; the tables "
          f"{', '.join(cases.REFUSED)} refused; step loops {gather} (K17a by "
          f"mode: instructions, gathers, bulk copies, waits, staging "
          f"loops), {vote} (K17b: instructions, barriers, shuffles) and "
          f"{onehot} (K17c: instructions, loads, 16 B loads)")
    return (gather, vote, onehot,
            um.kernel_ptxas(lib.with_suffix(".log").read_text()))


def micro_phase(dev):
    """Phase 16: the TPU micro-benchmarks on the TPU file's seeded inputs,
    the launch counts set to 0 just before and read just after (K19/K20's
    checks, ``leaf_checks``, come before).
    ``tpu_micro.measure``: K17a (E3, modes l2 and smem) and K17c (E7) at
    the TPU's lanes and at 131,072, K17b (E4), K18 (E5), K19 (E8) and K20
    (E9), each held bit-equal to its plain version at 3 steps and at the
    lower step count of its pair, then timed in turns at the TPU file's
    pairs, device time a call in a CUDA graph (K19 with K20: the A/B of a
    leaf read from shared memory as a broadcast against per-lane loads);
    beside K17a and K17c one ``torch.gather`` at the same lanes (one
    step's gather, not the chain). K17b/K17c's checks (``micro_checks``)
    come before too. Records at the lower step count, and one for K17c's
    view build. Returns the JSON records."""
    t_phase = time.perf_counter()
    inp = um.probe_inputs(dev)
    dump = common.sass_dump(_build.build("tpu_micro"))
    k18_sass = um.copy_sass(dump)
    if k18_sass[1:] != (1, 1):
        raise AssertionError(f"K18's chain loop holds {k18_sass[1]} bulk "
                             f"copies and {k18_sass[2]} mbarrier waits, "
                             f"not one each")
    leaf_sass, leaf_shapes, leaf_ptx = leaf_checks(dev, dump)
    gather_sass, vote_sass, onehot_sass, ptx = micro_checks(dev, dump)
    own = (_build.CSRC_DIR / "tpu_micro.cu").read_text()
    warps = um.source_constant(own, "kVoteWarps", um.TILE // 32)
    threads = um.source_constant(own, "kOnehotThreads", 256)
    lo8 = um.STEPS["E8"][0]
    clusters = len(set(um.chain_clusters(inp["blocks"][:um.LEAF_CLUSTERS],
                                         inp["x"], lo8)))
    torch.cuda.synchronize()
    bench.reset_launches((um,))
    r = um.measure(inp, rounds=2)
    launches = {f"tpu_micro.{k}": v for k, v in r["launches"].items()}
    for mode in ("l2", "smem"):  # the walk's latency floor and its context
        if (f"e3_{mode}", um.TILE) in r["kernels"]:
            ROUND_TRIPS[f"k17a_{mode}"] = r["kernels"][f"e3_{mode}",
                                                       um.TILE]["ns"]
    if min(launches.values()) <= 0:
        raise AssertionError(f"the micro-benchmark path launched {launches}")
    recs = []
    for (key, lanes), v in r["kernels"].items():
        k_id, line, _ = MICRO[key]
        lo, hi = um.STEPS[v["exp"]]
        bnd = micro_bound(key, lanes, lo, clusters)
        rec = record(f"tpu_micro_{key}_{lanes}", "tpu_micro.cu",
                     f"experiments/tpu_micro.py:{line}",
                     launches[f"tpu_micro.{key}"], 0.0, v["t"][0],
                     v["plain_ms"], bnd)
        rec["library_ms"] = v["library_ms"]
        lib = ("" if v["library_ms"] is None else
               f", one torch.gather {v['library_ms']:.4f} ms")
        if key.startswith("e3"):
            # the per-call intercept; the issue-rate floor of a step's SASS
            # in each warp of the fullest SM; l2: the 32 B sectors a step
            # over the step, the L2's rate this chain reaches
            mode = key[3:]
            sass = gather_sass[mode]
            floor = um.gather_floor(sass, lanes)
            icpt = v["t"][0] - lo * v["ns"] / 1e6
            rec.update(ns_a_step=v["ns"], intercept_ms=icpt, sass=sass,
                       floor_ns=floor, ptxas=ptx.get(f"E3 {mode}"))
            lib += (f"; intercept {icpt * 1e3:.2f} us; {ptx.get(f'E3 {mode}')}"
                    f"; step loop {sass} (instructions, gathers, bulk copies, "
                    f"waits, staging loops), issue-rate floor {floor:.1f} ns "
                    f"a step")
            if mode == "l2":
                rec["sectors_tb_s"] = lanes * 32 / v["ns"] / 1e3
                lib += (f"; {rec['sectors_tb_s']:.2f} TB/s of 32 B sectors "
                        f"a step")
            else:  # a warp's gather takes its bank conflicts' wavefronts
                waves = um.smem_wavefronts(
                    inp["table"], um.lanes_of(inp, "E3", lanes > um.TILE),
                    um.STEPS["E3"][1], lo)
                rec.update(wavefronts=waves,
                           bank_floor_ns=um.bank_floor(waves, lanes))
                lib += (f"; {waves:.3f} wavefronts a warp's gather (steps "
                        f"{lo}-{um.STEPS['E3'][1]}), bank floor "
                        f"{rec['bank_floor_ns']:.1f} ns a step")
        if key == "e5":
            rec.update(ns_a_copy=v["ns"], sass=k18_sass,
                       floor_ms=k18_sass[0] * lo / um.WARP_ISSUE_RATE * 1e3)
            lib += (f"; chain loop {k18_sass} (instructions, bulk copies, "
                    f"waits), issue-rate floor {rec['floor_ms']:.4f} ms, "
                    f"{k18_sass[0] / um.WARP_ISSUE_RATE * 1e9:.1f} ns a copy")
        if key == "e4":
            # the issue-rate floor of the step loop's SASS over the SM's 4
            # schedulers; the latency floor: one warp's step, then K17a
            # smem's on-chip round trip (the partials), this run's
            one = vote_sass[0] / um.WARP_ISSUE_RATE * 1e9
            floor = um.vote_floor(vote_sass[0], warps)
            trip = ROUND_TRIPS.get("k17a_smem", float("nan"))
            # the bytes the chain really reads: its distinct 32 B rows once,
            # x in and acc out
            rows_bytes = r["e4_rows"] * 32 + 8 * lanes
            rec.update(ns_a_step=v["ns"], sass=vote_sass, warps=warps,
                       ptxas=ptx.get("E4"), floor_ms=floor * lo / 1e6,
                       latency_floor_ns=one + trip, rows=r["e4_rows"],
                       rows_bytes=rows_bytes,
                       rows_bytes_ms=rows_bytes / common.HBM_RATE * 1e3)
            lib += (f"; {warps} warps, {ptx.get('E4')}; step loop "
                    f"{vote_sass} (instructions, barriers, shuffles), "
                    f"issue-rate floor {floor:.1f} ns a step "
                    f"({rec['floor_ms']:.4f} ms), one warp's step {one:.1f}"
                    f" ns + K17a smem's round trip {trip:.1f} ns = latency "
                    f"floor {one + trip:.1f} ns; {r['e4_rows']} distinct "
                    f"rows, {rows_bytes} B with x and acc: "
                    f"{rec['rows_bytes_ms']:.7f} ms at the memory rate")
        if key == "e7":
            # the latency floor: one warp's step, then K17a smem's on-chip
            # round trip (a row that hits the L1); the 256 KB view does not
            # stay whole in an SM's L1, so K17a l2's trip stands beside it
            one = onehot_sass[0] / um.WARP_ISSUE_RATE * 1e9
            floor = um.onehot_floor(onehot_sass[0], lanes, threads)
            trip = ROUND_TRIPS.get("k17a_smem", float("nan"))
            l2_trip = ROUND_TRIPS.get("k17a_l2", float("nan"))
            rec.update(ns_a_step=v["ns"], sass=onehot_sass, threads=threads,
                       ptxas=ptx.get("E7"), floor_ms=floor * lo / 1e6,
                       latency_floor_ns=one + trip, l2_trip_ns=l2_trip,
                       view_ms=r["e7_view_ms"])
            lib += (f"; blocks of {threads}, {ptx.get('E7')}; step loop "
                    f"{onehot_sass} (instructions, loads, 16 B loads), "
                    f"issue-rate floor {floor:.1f} ns a step "
                    f"({rec['floor_ms']:.4f} ms), one warp's step {one:.1f}"
                    f" ns + K17a smem's round trip {trip:.1f} ns = latency "
                    f"floor {one + trip:.1f} ns (K17a l2's trip "
                    f"{l2_trip:.1f} ns beside it); the view build alone "
                    f"{r['e7_view_ms'] * 1e3:.2f} us in each call")
        if key in ("e8", "e9"):
            exp = v["exp"]
            sass, shape = leaf_sass[exp], leaf_shapes[exp]
            floor = um.leaf_floor(sass, shape)
            chain = sass[3] / um.WARP_ISSUE_RATE * 1e9
            # the chain's latency floor: its step's issue, then K19's copy
            # round trip (K18's, this run) or K20's L2 round trip (K17a
            # l2's step at 1,024 lanes, this run)
            trip_key = ("e5", um.BLOCK[1]) if exp == "E8" else ("e3_l2",
                                                                um.TILE)
            trip = r["kernels"][trip_key]["ns"] if trip_key in r[
                "kernels"] else float("nan")
            rec.update(ns_a_leaf=v["ns"], sass=sass, shape=shape,
                       ptxas=leaf_ptx.get(exp), clusters=clusters,
                       floor_ms=floor * lo / 1e6, chain_ns=chain,
                       latency_floor_ns=chain + trip)
            lib += (f"; {shape[0]} blocks of {shape[1]} threads, {shape[2]} B "
                    f"of dynamic shared memory, {leaf_ptx.get(exp)}; SASS "
                    f"{sass} (a consumer warp's leaf, its tests a lane, its "
                    f"merge, the producer's chain step); issue-rate floor "
                    f"{floor:.1f} ns a leaf ({rec['floor_ms']:.4f} ms), the "
                    f"chain step's issue {chain:.1f} ns + "
                    f"{'K18' if exp == 'E8' else 'K17a l2'}'s round trip "
                    f"{trip:.1f} ns = latency floor "
                    f"{chain + trip:.1f} ns a leaf; {clusters} distinct "
                    f"clusters")
        recs.append(rec)
        per = {"E5": "a copy", "E8": "a leaf", "E9": "a leaf"}.get(
            v["exp"], f"a step, {v['ns'] / lanes:.4f} a lane-step")
        phase("kernel", f"{k_id} {v['exp']} {key} at {lanes} lanes: "
              f"bit-equal to plain at {um.CHECK_STEPS} and {lo} steps; "
              f"{v['ns']:.1f} ns {per} (device time a call in a CUDA "
              f"graph; t({lo}) {v['t'][0]:.4f} ms, "
              f"t({hi}) {v['t'][1]:.4f} ms, readings "
              f"{min(v['readings'][0]):.4f}-{max(v['readings'][0]):.4f} / "
              f"{min(v['readings'][1]):.4f}-{max(v['readings'][1]):.4f}); "
              f"plain t({lo}) {v['plain_ms']:.3f} ms{lib}; bound "
              f"{bnd[0]:.5f} ms by {bnd[1]}")
    # K17c's view build, launched by each K17c call: its own record
    table = inp["table"]
    view_bnd = bound(0, 4 * um.ROWS * um.T + 2 * um.ROWS * um.T)
    view_rec = record(f"tpu_micro_e7_view_{um.T}", "tpu_micro.cu",
                      f"experiments/tpu_micro.py:{MICRO['e7'][1]}",
                      launches["tpu_micro.e7_view"], 0.0, r["e7_view_ms"],
                      cuda_ms(lambda: um._view_ref(table)), view_bnd)
    view_rec.update(ptxas=ptx.get("E7 view"), library_ms=common.graph_ms(
        lambda: um._view_ref(table), um.AB_CALLS))
    recs.append(view_rec)
    phase("kernel", f"K17c view build onehot_view_kernel ({um.T} rows): "
          f"bit-equal to plain on every E7 case; {r['e7_view_ms']:.4f} ms "
          f"(device time in a CUDA graph), plain {view_rec['plain_ms']:.4f} "
          f"ms, one table.t().to(bf16) {view_rec['library_ms']:.4f} ms in a "
          f"graph; {ptx.get('E7 view')}; bound {view_bnd[0]:.5f} ms by "
          f"{view_bnd[1]}")
    phase("kernel", f"micro: E4's vote margin (smallest |sum| / sum|near| "
          f"over {um.STEPS['E4'][0]} steps) {r['e4_margin']:.3e}; E8/E9 "
          f"{r['e8_hits']} of {um.TILE} lanes hit within "
          f"{um.STEPS['E8'][0]} leaves; launches {launches}; phase 16 in "
          f"{time.perf_counter() - t_phase:.1f} s")
    return recs


# K23/K24: two slab tests and two acc adds a lane-step
WALK_FLOPS = 2 * SLAB_FLOPS + 2
# round trips measured earlier in this run, ns: K15a's 4 KB bulk copy
# (phase 15, "k15a") and K17a's dependent load a step at 1,024 lanes from
# shared memory and from the L2 (phase 16, "k17a_smem", "k17a_l2", device
# time in CUDA graphs): the chains' latency floors in phases 16 and 17
# (the walk's node pairs stay on chip, so its floor takes the smem trip;
# the L2's stands beside it)
ROUND_TRIPS: dict = {}


def multirow_checks(dev):
    """K22-K24 before phase 17's run: the build's SASS (``round_sass``,
    ``walk_sass``: raise on another form; K22's mode 2 holds the bulk copy
    and the mbarrier wait, modes 0 and 1 neither), each launch over more
    than one block, and every mode bit-equal to its plain version on the
    seeded inputs (K22 at 0, 1 and 17 rounds, K23/K24 at 0, 1, 17 and 64
    steps, acc and trajectory; ``measure`` adds 3 and the pair's lower
    count) and on every case of tests/multirow_cases.py. Returns (K22's
    SASS, the walk's SASS, K22's launch shapes, the walk's, ptxas lines by
    kernel, by ``multirow_probe.round_key`` and ``walk_key``; the walk's
    shapes by fetch mode)."""
    lib = _build.build("multirow_probes")
    dump = common.sass_dump(lib)
    lanes = mr.source_constant(
        (_build.CSRC_DIR / "multirow_probes.cu").read_text(), "kRoundLanes")
    k22_sass, walk_sass = mr.round_sass(dump, lanes), mr.walk_sass(dump)
    for name, code in common.sass_functions(dump).items():
        if "leafround_kernel" not in name:
            continue
        ops = {common.opcode(i) for _, i in code}
        staged = "leafround_kernelILi2E" in name
        for op in (common.BULK_COPY, common.BARRIER_WAIT):
            if any(o.startswith(op) for o in ops) != staged:
                raise AssertionError(f"K22 {name}: {op} "
                                     f"{'missing' if staged else 'present'}")
    k22_shapes = {(m, w): lr.round_shape(m, w) for m in lr.MODES
                  for w in lr.WIDTHS}
    walk_shapes = {m: mr.walk_shape(m) for m in ("fixed", "assemble",
                                                  "shfl", "lanes")}
    for key, shape in [*k22_shapes.items(), *walk_shapes.items()]:
        if shape[0] <= 1:
            raise AssertionError(f"{key} launches {shape[0]} block")

    def held(what, got, want):
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if not all(torch.equal(g, q) for g, q in zip(got, want)):
            raise AssertionError(f"{what}: kernel != plain")

    rays, blocks = lr.probe_inputs(device=dev)
    for w, b in blocks.items():
        for m in lr.MODES:
            for n in (0, 1, 17):
                held(f"K22 mode {m} w={w} at {n} rounds",
                     lr.leafround_run(rays, b, n, m),
                     lr._leafround_ref(rays, b, n, m))
    ntab, mrays = mr.probe_inputs(device=dev)
    grays, tabs = gp.probe_inputs(device=dev)
    for n in (0, 1, 17, 64):
        for m in mr.MODES:
            held(f"K23 {m} at {n} steps", mr.multirow_run(mrays, ntab, n, m,
                                                          True),
                 mr._multirow_ref(mrays, ntab, n, m))
        for size, tab in tabs.items():
            want = gp._gather_ref(grays, tab, n)
            for m in gp.MODES:
                held(f"K24 {m} S={size} at {n} steps",
                     gp.gather_run(grays, tab, n, m, True), want)
    cases = cases_module("multirow_cases")
    for name in cases.ROUND_CASES:
        for w in lr.WIDTHS:
            r, b, n = (torch.from_numpy(a).to(dev) if hasattr(a, "shape")
                       else a for a in cases.round_case(name, w))
            for m in lr.MODES:
                for k in sorted({0, 1, n, 17}):
                    held(f"K22 mode {m} w={w} on the edge case {name} at "
                         f"{k} rounds", lr.leafround_run(r, b, k, m),
                         lr._leafround_ref(r, b, k, m))
    for name in cases.WALK_CASES:
        for kern in ("K23", "K24"):
            r, t, n = (torch.from_numpy(a).to(dev) if hasattr(a, "shape")
                       else a for a in cases.walk_case(name, kern))
            for k in (0, 1, 3, 17, n):
                if kern == "K23":
                    for m in mr.MODES:
                        held(f"K23 {m} on the edge case {name} at {k} steps",
                             mr.multirow_run(r, t, k, m, True),
                             mr._multirow_ref(r, t, k, m))
                else:
                    want = gp._gather_ref(r, t, k)
                    for m in gp.MODES:
                        held(f"K24 {m} on the edge case {name} at {k} steps",
                             gp.gather_run(r, t, k, m, True), want)
    log = lib.with_suffix(".log").read_text()
    ptx = {**mr.ptxas_by_kernel(log, mr.round_key),
           **mr.ptxas_by_kernel(log, mr.walk_key)}
    return k22_sass, walk_sass, k22_shapes, walk_shapes, ptx


def regroup_bound(upto, pairs, windows, blocks=1):
    """K21's bound at ``windows`` windows on each of ``blocks`` blocks
    (``regroup_probe.bound``): every window's FP32 operations; the
    inputs its outputs depend on (ct none; g the masks; ray the masks and
    rays; tri its 8 words of each cluster; mt and full the masks, rays and
    the 12 used words of each cluster), distinct once a launch, since
    every window and block computes the same window; each block's 8 KB of
    outputs written once."""
    return rp.bound(upto, pairs, windows, blocks)


def packet8_phase(dev):
    """Phase 17: the regrouped leaf phase (K21) and the 8-row packet probes
    (K22-K24) on the TPU files' seeded inputs, the launch counts set to 0
    just before and read just after. Each module's ``measure``: every mode
    held bit-equal to its plain version (K23/K24 on acc and every step's
    idx and bs) at the lower count of its pair and below, then timed in
    turns at the TPU file's pair. Records at the lower count; bounds from
    the FP32 operations and the bytes of that run. Returns the JSON
    records."""
    t_phase = time.perf_counter()
    k22_sass, walk_sass, k22_shapes, walk_shapes, mr_ptx = \
        multirow_checks(dev)
    k21_sass = rp.mode_sass(common.sass_dump(_build.build("regroup_probe")))
    lanes = rp.source_lanes(
        (_build.CSRC_DIR / "regroup_probe.cu").read_text())
    rg_in = rp.probe_inputs(dev)
    lr_rays, lr_blocks = lr.probe_inputs(device=dev)
    ntab, mr_rays = mr.probe_inputs(device=dev)
    gp_rays, gp_tabs = gp.probe_inputs(device=dev)
    torch.cuda.synchronize()
    mods = (rp, lr, mr, gp)
    bench.reset_launches(mods)
    k21 = rp.measure(rg_in, rounds=1)
    k22 = lr.measure(lr_rays, lr_blocks, rounds=1)
    k23 = mr.measure(ntab, mr_rays, rounds=1)
    k24 = gp.measure(gp_rays, gp_tabs, rounds=1)
    launches = bench.read_launches(mods)
    want = {f"{m.__name__.rsplit('.', 1)[1]}.{k}" for m in mods
            for k in m.LAUNCHES}
    if set(launches) != want:
        raise AssertionError(f"the packet-probe path launched {launches}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    recs = []
    lo, hi = rp.WINDOWS
    pairs = k21["pairs"]
    for upto, v in k21["modes"].items():
        bnd = regroup_bound(upto, pairs, lo)
        card_bnd = regroup_bound(upto, pairs, 1, rp.CARD_BLOCKS)
        floor = rp.issue_floor(k21_sass[upto], pairs, lo, lanes,
                               rp.SM_ISSUE_RATE)
        card_floor = rp.issue_floor(k21_sass[upto], pairs, rp.CARD_BLOCKS,
                                    lanes)
        rec = record(f"regroup_{upto}", "regroup_probe.cu",
                     "experiments/regroup_probe.py:94",
                     launches[f"regroup_probe.{upto}"], 0.0, v["t"][0],
                     v["plain_ms"], bnd)
        rec.update(us_window=v["us_window"], ns_pair=v["ns_pair"],
                   card_ms=v["card_ms"], card_ns_pair=v["card_ns_pair"],
                   card_bound_ms=card_bnd[0], floor_ms=floor,
                   card_floor_ms=card_floor, sass=k21_sass[upto])
        recs.append(rec)
        phase("kernel", f"K21 {upto}: bit-equal to plain on 1, {lo} and "
              f"{hi} windows and {rp.CARD_BLOCKS} blocks; device time a call "
              f"in a CUDA graph: {v['us_window']:.3f} us a window, "
              f"{v['ns_pair']:.3f} ns a pair on one SM ({pairs} pairs; "
              f"t({lo}) {v['t'][0]:.4f} ms, t({hi}) {v['t'][1]:.4f} ms, one "
              f"block on 1 of {sms} SMs; issue-rate floor of the build's "
              f"SASS {floor:.4f} ms at {lo}); card-wide {rp.CARD_BLOCKS} "
              f"windows {v['card_ms']:.4f} ms = "
              f"{v['card_ms'] / rp.CARD_BLOCKS * 1e3:.4f} us a window, "
              f"{v['card_ns_pair']:.4f} ns a pair (bound {card_bnd[0]:.5f} "
              f"ms by {card_bnd[1]}, issue-rate floor {card_floor:.4f} ms); "
              f"plain t({lo}) {v['plain_ms']:.3f} ms; bound at {lo} "
              f"{bnd[0]:.5f} ms by {bnd[1]}")
    phase("kernel", f"K21 SASS of this build (test, step, rank, rest), "
          f"{lanes} lanes a slot, the clusters staged by the bulk copy "
          f"(UBLKCP, SYNCS) and no shared-memory atomic: {k21_sass}; the "
          f"ring {rp.ring_bytes()} B of dynamic shared memory a block")
    lo, hi = lr.ROUNDS_PAIR
    copy_trip = ROUND_TRIPS.get("k15a", float("nan"))
    for (m, w), v in k22["modes"].items():
        clusters = (lr.clusters_visited(lr_rays, lr_blocks[w], lo) if m == 2
                    else 0)
        bnd = bound(MT_FLOPS * mr.TILE * w * lo,
                    lr.round_bytes(m, w, clusters))
        sass, shape = k22_sass[m, w], k22_shapes[m, w]
        floor = mr.round_floor(sass, shape)
        chain = sass[2] / mr.WARP_ISSUE_RATE * 1e9
        latency = (chain + (copy_trip if m == 2 else 0.0) if m else None)
        ptx = mr_ptx.get((m, w), "")
        rec = record(f"leafround_m{m}_w{w}", "multirow_probes.cu",
                     "experiments/leafround_probe.py:39",
                     launches[f"leafround_probe.{m}"], 0.0, v["t"][0],
                     v["plain_ms"], bnd)
        rec.update(ns_a_round=v["ns"], sass=sass, shape=shape, ptxas=ptx,
                   clusters=clusters, floor_ms=floor * lo / 1e6,
                   chain_ns=chain, latency_floor_ns=latency)
        recs.append(rec)
        lat = ("no chain" if latency is None else
               f"latency floor {latency:.1f} ns a round (the chain step's "
               f"issue {chain:.1f} ns" + (f" + K15a's copy {copy_trip:.1f} "
                                          f"ns" if m == 2 else "") + ")")
        phase("kernel", f"K22 LEAF_MODE {m} w={w}: bit-equal to plain at "
              f"{lr.CHECK_STEPS} and {lo} rounds; {v['ns']:.1f} ns an 8-row "
              f"leaf round (t({lo}) {v['t'][0]:.4f} ms, t({hi}) "
              f"{v['t'][1]:.4f} ms; {shape[0]} blocks of {shape[1]} threads, "
              f"{shape[2]} B of dynamic shared memory, {ptx}); plain "
              f"t({lo}) {v['plain_ms']:.3f} ms; bound {bnd[0]:.5f} ms by "
              f"{bnd[1]} ({clusters} distinct clusters); SASS {sass} (a "
              f"consumer warp's round, its tests a lane, the producer's chain "
              f"step), issue-rate floor {floor:.1f} ns a round "
              f"({rec['floor_ms']:.5f} ms); {lat}")
    for w in lr.WIDTHS:  # the division repair's witness
        ns0, ns2 = k22["modes"][0, w]["ns"], k22["modes"][2, w]["ns"]
        if ns0 > ns2:
            raise AssertionError(f"K22 w={w}: mode 0 reads {ns0:.1f} ns a "
                                 f"round, slower than mode 2's {ns2:.1f}")
    trip = ROUND_TRIPS.get("k17a_smem", float("nan"))
    l2_trip = ROUND_TRIPS.get("k17a_l2", float("nan"))
    for k_id, res, mod, line, pair in (
            ("K23", k23, mr, "experiments/multirow_probe.py:57", mr.STEPS),
            ("K24", k24, gp, "experiments/gather_probe.py:49", gp.STEPS)):
        lo, hi = pair
        for key, v in res["modes"].items():
            m = key if k_id == "K23" else key[0]
            name = (f"multirow_{m}" if k_id == "K23" else
                    f"gather_{m}_S{key[1]}")
            if m == "fixed":
                pairs = 0
            elif k_id == "K23":  # the trajectory by the kernel, uncounted
                n = ntab.numel() // 6
                _, idx, _ = mr._multirow(mr_rays, ntab, lo, m, True,
                                         mr._lib())
                pairs = mr.pairs_visited(
                    torch.arange(mr.ROWS, device=dev) % (n // 2 - 1) + 1,
                    idx)
            else:
                tab = gp_tabs[key[1]]
                _, idx, _ = gp._gather(gp_rays, tab, lo, m, True, mr._lib())
                pairs = mr.pairs_visited(gp.start_pairs(tab), idx)
            bnd = bound(WALK_FLOPS * mr.TILE * lo, mr.walk_bytes(pairs))
            sass = walk_sass[m, k_id == "K24"]
            walk_shape = walk_shapes[m]
            card_ns, warp_ns = mr.walk_floor(sass[0], walk_shape)
            latency = warp_ns + (0.0 if m == "fixed" else trip)
            ptx = mr_ptx.get((m, k_id == "K24"), "")
            mod_name = mod.__name__.rsplit(".", 1)[1]
            rec = record(name, "multirow_probes.cu", line,
                         launches[f"{mod_name}.{m}"], 0.0, v["t"][0],
                         v["plain_ms"], bnd)
            rec.update(ns_a_step=v["ns"], sass=sass, shape=walk_shape,
                       ptxas=ptx, pairs=pairs, floor_ms=card_ns * lo / 1e6,
                       step_issue_ns=warp_ns, latency_floor_ns=latency,
                       l2_trip_ns=l2_trip)
            recs.append(rec)
            phase("kernel", f"{k_id} {name}: bit-equal to plain (acc, every "
                  f"step's idx and bs) at {mr.CHECK_STEPS} and {lo} steps; "
                  f"{v['ns']:.1f} ns an 8-row node step (t({lo}) "
                  f"{v['t'][0]:.4f} ms, t({hi}) {v['t'][1]:.4f} ms; "
                  f"{walk_shape[0]} blocks of {walk_shape[1]} threads, {ptx});"
                  f" plain t({lo}) {v['plain_ms']:.3f} ms; bound "
                  f"{bnd[0]:.6f} ms by {bnd[1]} ({pairs} distinct pairs); "
                  f"SASS {sass} (a warp's step, REDUX.SUM, BAR), issue-rate "
                  f"floor {card_ns:.2f} ns a step card-wide, a step's issue "
                  f"{warp_ns:.1f} ns, latency floor {latency:.1f} ns (+ "
                  + ("none: constant boxes" if m == "fixed" else
                     f"K17a smem's on-chip load {trip:.1f} ns; K17a l2's "
                     f"{l2_trip:.1f} ns beside it") + ")")
    phase("kernel", f"packet probes: {k21['hits']} of {rp.R} rays hit in "
          f"K21's window; K22 lanes hit after {lr.ROUNDS_PAIR[0]} rounds "
          f"of mode 2: {k22['hits']}; launches {launches}; phase 17 in "
          f"{time.perf_counter() - t_phase:.1f} s")
    return recs


# K25b: a fetched feature's 3 bf16 roundings, 2 subtractions and 2 sums
SBF_FEATURE_FLOPS = 7


def layout_phase(dev):
    """Phase 18: the sphere layout probe (K25a, K25b) on the TPU file's
    16,384 rays and on the headline's sets (``frame_sets``: the 32,768-lane
    pool's and the 960,000 primary rays of sample 0, and the live rays of
    each one's second bounce), and the shape-cast probe (K26), the launch
    counts set to 0 just before and read just after. Each module's
    ``measure``: every kernel held bit-equal to its plain version (K25
    also to K1), then timed (K25: device time a call in a CUDA graph, in
    turns with K1 and the table's copy alone). Bounds: K25a
    SPHERE_PAIR_FLOPS a ray-slot pair over all 512 slots and
    SPHERE_ROOT_FLOPS more where disc > 0, K25b that plus 7 a fetched
    feature of a hit; bytes the rays, the table (and K25b's feature
    table) once, the outputs once. Issue-rate floor: the build's slot loop
    (``sphere_layout_ab.slot_sass``: a pair, the roots where disc > 0)
    over the set's pairs. Returns the JSON records (K25 on the TPU file's
    rays, the pool's primary rays and the 960,000 primary rays)."""
    t_phase = time.perf_counter()
    sets = {"tpu": slp.probe_inputs(dev), **slp.frame_sets(dev)}
    x = scp.probe_x(dev)
    dump = common.sass_dump(_build.library_path("sphere_layout_probe"))
    sass = {"sb": lab.slot_sass(dump)["01"], "sbf": lab.slot_sass(dump)["11"]}
    torch.cuda.synchronize()
    mods = (slp, scp)
    bench.reset_launches(mods)
    k25 = slp.measure(sets, rounds=2)
    k26 = scp.measure(x)
    launches = bench.read_launches(mods)
    want = {f"{m.__name__.rsplit('.', 1)[1]}.{k}" for m in mods
            for k in m.LAUNCHES}
    if set(launches) != want:
        raise AssertionError(f"the layout-probe path launched {launches}")
    phase("kernel", f"K25 SASS of this build: (instructions, LDC, ULDC, "
          f"FP32 with a bank-3 operand) by template arguments (FEAT, ALL) "
          f"{lab.table_reads(dump)}; the slot loop's (pair, root) {sass}")
    recs = []
    table, ftab = 4 * 4 * slp.S, 4 * slp.N_C * slp.S
    for name, v in k25["sets"].items():
        n, hits = v["n"], v["hits"]
        pair_flops = sphere_flops(v["pairs"], v["disc_pairs"])
        bnd = {"sb": bound(pair_flops, 4 * 7 * n + table + 8 * n),
               "sbf": bound(pair_flops + SBF_FEATURE_FLOPS * slp.N_C * hits,
                            4 * 7 * n + table + ftab + (8 + 4 * slp.N_C) * n)}
        floor = {m: lab.issue_floor(sass[m], v["pairs"], v["disc_pairs"])[0]
                 for m in sass}
        ms = v["ms"]
        phase("kernel", f"K25 {name}: {n} rays, {hits} hits, {v['pairs']} "
              f"pairs, {v['disc_pairs']} with disc > 0: sb and sbf bit-equal "
              f"to plain and to K1 (t, idx; features, 0 on a miss); device "
              f"time a call in a CUDA graph, 2 rounds in turns: " + ", ".join(
                  f"{m} {ms[m]:.4f} ms (bound {bnd[m][0]:.4f} by "
                  f"{bnd[m][1]}, issue-rate floor {floor[m]:.4f})"
                  for m in ("sb", "sbf"))
              + f"; the table's copy alone {ms['copy']:.4f} ms; K1b "
              f"{ms['k1b']:.4f}, K1 {ms['k1']:.4f} ms "
              f"({sets[name]['centers'].shape[0]} spheres, K25 {slp.S} "
              f"slots); plain sb {v['plain_ms']['sb']:.2f} ms, sbf "
              f"{v['plain_ms']['sbf']:.2f} ms")
        if name not in ("tpu", "pool primary", "960,000 primary"):
            continue
        for mode, line in (("sb", 117), ("sbf", 38)):
            rec = record(f"sphere_layout_{mode}_{n}", "sphere_layout_probe.cu",
                         f"experiments/sphere_layout_probe.py:{line}",
                         launches[f"sphere_layout_probe.{mode}"], 0.0,
                         ms[mode], v["plain_ms"][mode], bnd[mode])
            rec.update(copy_ms=ms["copy"],
                       k1_ms=ms["k1b" if mode == "sb" else "k1"],
                       floor_ms=floor[mode])
            recs.append(rec)
    bnd = bound(sum(scp.CASE_FLOPS), 4 * scp.N * (1 + len(scp.NAMES)))
    recs.append(record("shapecast", "shapecast_probe.cu",
                       "experiments/shapecast_probe.py:135",
                       launches["shapecast_probe.cases"], 0.0, k26["ms"],
                       k26["plain_ms"], bnd))
    slow = max(k26["case_ms"], key=k26["case_ms"].get)
    phase("kernel", f"K26: all {len(scp.NAMES)} cases bit-equal to plain "
          f"alone and in one launch (A @ B^T sum "
          f"{k26['sums'][scp.NAMES[8]][0]!r}); one launch of all "
          f"{k26['ms'] * 1e3:.2f} us, a case {min(k26['case_ms'].values()) * 1e3:.2f}"
          f"-{k26['case_ms'][slow] * 1e3:.2f} us (slowest {slow!r}); on the "
          f"device (profiler; 0: not measured) all {k26['device_ms'] * 1e3:.2f}"
          f" us, a case {min(k26['case_device_ms'].values()) * 1e3:.2f}-"
          f"{max(k26['case_device_ms'].values()) * 1e3:.2f} us; plain "
          f"{k26['plain_ms']:.2f} ms; bound {bnd[0] * 1e3:.4f} us by {bnd[1]}")
    phase("kernel", f"layout probes: launches {launches}; phase 18 in "
          f"{time.perf_counter() - t_phase:.1f} s")
    return recs


def mx_frame_checks(scene, cam, cfg, base, mx_img):
    """mx_leaf against the default frame beyond phase 13's first frame:
    the same comparison on two more 4-sample windows of the frame (sample
    indices from 4 and from 8), each under MX_FRAME_RMSE; and the mx_leaf
    frame at mx_passes=6, which must come closer to ``base``, the default
    frame, than ``mx_img``, the one at 3 passes."""
    frame = lambda c, s0: render_regen(scene, cam, c, s0=s0).cpu().numpy(
        ).reshape(cfg.ny, cfg.nx, 3)
    mcfg = cfg.replace(mx_leaf=True)
    three = golden.rmse(mx_img, base)
    windows = {s0: golden.rmse(frame(mcfg, s0), frame(cfg, s0))
               for s0 in (4, 8)}
    six = frame(mcfg.replace(mx_passes=6), 0)
    r6 = golden.rmse(six, base)
    text = (", ".join(f"samples {s0}-{s0 + cfg.ns - 1}: rmse {r:.3e}"
                      for s0, r in windows.items())
            + f"; mx_passes=6: rmse {r6:.3e} ssim "
            f"{golden.ssim(six, base):.6f} (3 passes: {three:.3e})")
    if max(windows.values()) >= MX_FRAME_RMSE or not r6 < three:
        raise AssertionError(f"dragon mx_leaf=True vs the default frame: "
                             f"{text} (bound {MX_FRAME_RMSE}, and 6 passes "
                             "closer than 3)")
    phase("dragon", f"mx_leaf=True vs the default frame on {text}")


def dragon_path(dev):
    """Phases 10, 10c, 10d and 13. Returns the default and mx_leaf frames'
    profiles (phase 14, to run after the timed frames) and the JSON
    records of K5, K6, the heap tier's variants (K10, K10b, K11, K5/K6
    fast_math), the packet walk (K12a, K12b) and the walk probes (K13,
    K16)."""
    t_phase = time.perf_counter()
    built = bench.build_frame(bench.FRAMES["dragon"], dev)
    cfg, scene, cam = built.cfg, built.scene, built.cam
    if wf.mesh_tier(scene, cfg) != "heap":
        raise AssertionError("the dragon-class knot left the heap tier")
    phase("scene", f"dragon-class knot built in "
          f"{built.build_s:.1f} s: {scene.mesh.num_tris} heap "
          f"slots, first_leaf {scene.mesh.first_leaf}, "
          f"{scene.mesh.prims_per_leaf} a leaf, tier heap")
    tabs = cb.heap_tables(scene.mesh)
    kern = BvhKernels("heap", tabs)
    tag = "heap dragon"
    res, rays = bvh_kernel_phase(tag, scene, cam, cfg, kern)
    # K5/K6 at the frame's shape: the dragon's lane pool
    pool = pool_sets(scene, cam, cfg, kern, MX_POOL)
    res["pool primary"] = compare_bvh_nearest(
        f"{tag} pool primary", kern, *pool["pool primary"], cfg.epsilon)
    res["pool NEE shadows"] = compare_bvh_anyhit(
        f"{tag} pool NEE shadows", kern, *pool["pool NEE shadows"],
        cfg.epsilon)
    graph = graph_phase(tag, kern, {"primary": rays["primary"],
                                    "NEE shadows": rays["NEE shadows"],
                                    **pool}, res, cfg.epsilon, HEAP_SASS)
    variants, mx_graph, rg_graph, fm_graph = heap_variants_phase(
        scene, cam, cfg, tabs, rays, pool, res)
    t_phase = phase_seconds("10", t_phase)
    mr_recs = mr_phase(tabs, {"primary": rays["primary"],
                              "NEE shadows": rays["NEE shadows"], **pool},
                       cfg.epsilon, res)
    phase_seconds("10c", t_phase)
    probe_recs = walk_probe_phase(tabs, rays, pool, cfg.epsilon)
    t_phase = time.perf_counter()  # phase 10d prints its own

    run = frame_run("dragon", "dragon", "dragon", built, TIER_KERNELS["heap"])
    base, launches = run.timed.image, run.timed.launches
    BENCH_READINGS["dragon"] = run.timed.seconds
    knob_launches, knob_imgs = {}, {}
    for knobs, bound_text in DRAGON_KNOBS:
        kcfg = cfg.replace(**knobs)
        name = ", ".join(f"{k}={v}" for k, v in knobs.items())
        route = {"heap-mx": {"cuda_bvh_mx.nearest", "cuda_bvh_mx.any_hit"},
                 "heap-rg": {"cuda_bvh_rg.nearest", "cuda_bvh.any_hit"}}
        expect = route.get(wf.mesh_tier(scene, kcfg), (
            {"cuda_bvh.nearest_fast_math", "cuda_bvh.any_hit_fast_math"}
            if kcfg.fast_math else {"cuda_bvh.nearest", "cuda_bvh.any_hit"}))
        t = frame_run("dragon", f"dragon {name}", "dragon", built, expect,
                      kcfg).timed
        img, knob_launches[name] = t.image, t.launches
        knob_imgs[name] = img
        r, s = golden.rmse(img, base), golden.ssim(img, base)
        ok = {"packet_packs=2, packet_split=True":
              bool(np.array_equal(img, base)),
              "regroup=True": r < 1e-4,
              "fast_math=True": s >= 0.999,
              "mx_leaf=True": s >= 0.999 and r < MX_FRAME_RMSE}[name]
        if not ok:
            raise AssertionError(f"dragon {name} vs default frame: rmse "
                                 f"{r:.3e} ssim {s:.6f} (bound: "
                                 f"{bound_text})")
        phase("dragon", f"{name} vs the default frame: rmse {r:.3e} ssim "
              f"{s:.6f} max |diff| {np.abs(img - base).max():.3e} (bound: "
              f"{bound_text})")
    mx_frame_checks(scene, cam, cfg, base, knob_imgs["mx_leaf=True"])
    phase_seconds("13", t_phase)
    mx_l = knob_launches["mx_leaf=True"]
    rg_l = knob_launches["regroup=True"]
    fm_l = knob_launches["fast_math=True"]
    # profiled later, as the other frames: the default frame's K5 and K6,
    # the mx_leaf frame's K10 and K10b, and the regroup frame's K11 and
    # K6, by name
    profiles = [
        functools.partial(profile_frame, "dragon", scene, cam, cfg,
                          itemize=("::heap_kernel",)),
        functools.partial(profile_frame, "dragon mx_leaf", scene, cam,
                          cfg.replace(mx_leaf=True),
                          itemize=("::mx_kernel",)),
        functools.partial(profile_frame, "dragon regroup", scene, cam,
                          cfg.replace(regroup=True),
                          itemize=("::rg_kernel", "::heap_kernel"))]
    return profiles, [
        graph_record("heap_trace", "bvh.cu", "pallas_bvh.py:937",
                     launches["cuda_bvh.nearest"], res["primary"], graph,
                     "pool primary", MX_POOL),
        graph_record("heap_occluded", "bvh.cu", "pallas_bvh.py:1393",
                     launches["cuda_bvh.any_hit"], res["NEE shadows"],
                     graph, "pool NEE shadows", MX_POOL),
        graph_record("heap_trace_fast_math", "bvh.cu", "pallas_bvh.py:937",
                     fm_l["cuda_bvh.nearest_fast_math"],
                     variants["heap_trace_fast_math"], fm_graph,
                     "pool primary", MX_POOL),
        graph_record("heap_occluded_fast_math", "bvh.cu",
                     "pallas_bvh.py:1393",
                     fm_l["cuda_bvh.any_hit_fast_math"],
                     variants["heap_occluded_fast_math"], fm_graph,
                     "pool NEE shadows", MX_POOL),
        graph_record("mx_trace", "bvh_mx.cu", "pallas_bvh_mx.py:190",
                     mx_l["cuda_bvh_mx.nearest"], variants["mx_trace"],
                     mx_graph, "pool primary", MX_POOL),
        graph_record("mx_occluded", "bvh_mx.cu", "pallas_bvh_mx.py:302",
                     mx_l["cuda_bvh_mx.any_hit"],
                     variants["mx_occluded"], mx_graph,
                     "pool NEE shadows", MX_POOL),
        graph_record("rg_trace", "bvh_rg.cu", "pallas_bvh_rg.py:230",
                     rg_l["cuda_bvh_rg.nearest"], variants["rg_trace"],
                     rg_graph, "pool primary", MX_POOL), *mr_recs,
        *probe_recs]


CONFIG5 = dict(nx=3840, ny=2160, ns=2, max_depth=64)  # ns cut from 1000
TILE_FRAME = dict(nx=1200, ny=800, ns=2, max_depth=64)  # ns cut from 100
TILE_ATOL = 1e-6  # tests/test_parallel.py:52-60


def start_oracle_gates(dev, pool):
    """Starts the port's oracle of bench.py's four gates (the bench's
    ``ORACLE_GATES``) in ``pool``; the renders on the card and the
    comparisons wait for phase 19."""
    gates = bench.start_oracle_gates(dev, pool)
    phase("oracle", f"the port's NumPy oracle of the {len(gates)} gates "
          f"started in {len(gates)} host processes")
    return gates


def oracle_gate_phase(gates):
    """Phase 19: bench.py's four oracle gates, each frame rendered on the
    card through its tier's kernels (counts from 0 just before, read just
    after) and held against the port's NumPy oracle of the same scene at
    bench.py's bounds (``bench.check_oracle_gate``)."""
    t_phase = time.perf_counter()
    for p in gates:
        g, cfg, tier = p.gate, p.cfg, bench.tier(p.scene, p.cfg)
        run = checked(f"oracle gate {g.name} (tier {tier})",
                      TIER_KERNELS[tier], bench.finish_oracle_gate, p)
        phase("oracle", f"{g.name} ({g.where}) {cfg.nx}x{cfg.ny} {cfg.ns} "
              f"spp depth {cfg.max_depth}, tier {tier}: rmse {run.rmse:.3e} "
              f"(bound < {g.rmse_tol:g}) ssim {run.ssim:.6f} (bound >= "
              f"{g.ssim_min}); kernel launches {run.timed.launches}; oracle "
              f"{run.oracle_s:.1f} s in its host process (waited "
              f"{run.waited_s:.1f} s)")
    phase("oracle", f"phase 19 in {time.perf_counter() - t_phase:.1f} s")


# phase 21: bench.py's frames that no earlier phase renders, and the tier
# each takes (knot and terrain the f32 BVH4 tier, terrain-big the quant
# BVH4 tier, the rock pile the heap)
ZOO_TIERS = {"knot": "bvh4", "terrain": "bvh4", "terrain_big": "quant-bvh4",
             "rocks": "heap"}


def bench_phase(dev, smi):
    """Phase 21: bench.py's four zoo frames through the bench's frame
    entries (``bench.run_frame``: a 1 spp warm-up, the timed render, the
    crop gate), each at full size with its tier and its launch set
    checked; the stats pass on the headline (``bench.path_stats``), its
    regen Stats equal to the plain engine's; config 2 on the warm
    headline; and the bench's JSON line over this phase's readings and
    phases 5, 8, 12 and 13's. Returns the zoo frames' launches of each
    kernel and config 2's."""
    t_phase = time.perf_counter()
    zoo = {}
    for name, route in ZOO_TIERS.items():
        frame = bench.FRAMES[name]
        built = bench.build_frame(frame, dev)
        run = frame_run("bench", frame.label, name, built,
                        TIER_KERNELS[route])
        if run.tier != route:
            raise AssertionError(f"{frame.label}: tier {run.tier}, not "
                                 f"{route}")
        b4 = run.scene.mesh.bvh4
        shape = (f"BVH4 {b4.n_nodes} nodes, stack_cap {b4.stack_cap}"
                 if b4 is not None else
                 f"first_leaf {run.scene.mesh.first_leaf}")
        phase("bench", f"{frame.label} ({frame.crop}): tier {run.tier} "
              f"({run.scene.mesh.num_tris} heap slots, {shape}), scene "
              f"built in {run.build_s:.1f} s, "
              f"{run.timed.seconds / frame.spp * 1e3:.1f} ms/spp")
        BENCH_READINGS[name] = run.timed.seconds
        zoo[name] = run.timed.launches

    frame = bench.FRAMES["headline"]
    built = bench.build_frame(frame, dev)
    cfg, scene, cam = built.cfg, built.scene, built.cam
    scfg, regen = bench.path_stats(scene, cam, cfg)
    _, plain = render_image(scene, cam, scfg.replace(ns=4),
                            report_stats=True)
    if regen != plain:
        raise AssertionError("the headline's stats pass: regen Stats differ "
                             "from the plain engine's: " + str(
                                 {k: (a, b) for k, a, b in
                                  zip(regen._fields, regen, plain) if a != b}))
    rpp = bench.rays_per_path(regen)
    BENCH_READINGS["rays_per_path"] = rpp
    phase("bench", f"headline stats pass {scfg.nx}x{scfg.ny} 4 spp depth "
          f"{scfg.max_depth}: regen Stats equal the plain engine's (primary "
          f"{regen.primary}, secondary {regen.secondary}, shadows "
          f"{regen.shadows}, roulette {regen.roulette_kill}, exceeded max "
          f"bounce {regen.exceed_max_bounce}); {rpp:.4f} rays a path")

    more, spp = frame.more
    t2 = checked("config 2", TIER_KERNELS["spheres"], bench.render_timed,
                 scene, cam, cfg, spp)
    if not (np.isfinite(t2.image).all() and t2.image.mean() > 0.01):
        raise AssertionError(f"config 2: bad image, mean {t2.image.mean()}")
    BENCH_READINGS[more] = t2.seconds
    paths = cfg.num_pixels * spp
    phase("bench", f"config 2: {cfg.nx}x{cfg.ny} {spp} spp "
          f"depth {cfg.max_depth} on the warm headline: {t2.seconds:.3f} s "
          f"(CUDA events; host wall {t2.wall:.3f} s), "
          f"{paths / t2.seconds / 1e6:.3f} Mpaths/s, {t2.iters} regen "
          f"iterations, kernel launches {t2.launches}, mean "
          f"{t2.image.mean():.4f} (no golden)")

    # its keys are bench.py's (tests/test_torch_bench.py); here its numbers
    line = bench.bench_line({**BENCH_READINGS, "device": smi})
    numbers = [v for k, v in (*line.items(), *line["extra"].items())
               if isinstance(v, float)]
    if not all(np.isfinite(v) and v > 0 for v in numbers):
        raise AssertionError(f"bench line: {line}")
    phase("bench", f"bench.py's line over phases 5, 8, 12, 13 and 21 "
          f"(each frame timed once): {json.dumps(line)}")
    phase("bench", f"phase 21 in {time.perf_counter() - t_phase:.1f} s")
    return zoo, t2.launches


# phase 22: the decision experiments, each once at its script's full scene
# and resolution, the timed spp cut to 1 and one timed render an arm (the
# scripts take 2-64 spp, best of up to 3), the converged oracle at 8 spp
# (its script: 100); each arm's tier in the order the module runs them
# (tests/test_torch_experiments_e2e.py holds them to the JAX package's
# dispatch at small sizes)
CONVERGED_SPP = 8
DECIDE = (
    ("pool_probe", lambda d: pp.measure(d, spp=1), ("bvh4",) * 3),
    ("crossover", lambda d: co.measure(d, 1), ("brute", "bvh4")),
    ("knot_tier_ab", lambda d: kt.measure(
        d, config=dict(kt.CONFIG, ns=1), reps=1), ("bvh4", "heap", "bvh4")),
    ("terrain_big_ab", lambda d: tb.measure(d, 1, reps=1),
     ("quant-bvh4", "heap", "quant-bvh4")),
    ("dragon_bvh4_ab", lambda d: db.measure(
        d, config=dict(db.CONFIG, ns=1), reps=1), ("heap", "quant-bvh4")),
    ("width_e2e_ab", lambda d: wab.measure(d, 1, reps=1),
     ("bvh4", "bvh4", "heap", "heap")),
    ("width_e2e", lambda d: we.measure(d, cases={
        k: c._replace(ns=1) for k, c in we.CASES.items()}),
     ("bvh4", "bvh4", "bvh4", "bvh4", "heap", "heap")),
    ("width_sweep", lambda d: ws.measure(d, "stairs", 1), ("bvh4",) * 3),
    ("sah_vs_median", lambda d: sm.measure(d, 1), ("bvh4", "bvh4")),
    ("sah_vs_median_stairs", lambda d: sms.measure_stairs(d, 1),
     ("bvh4", "bvh4")),
    ("zoo_table", lambda d: zt.measure(d, 1), ("bvh4",) * 4),
)
# Arms that run other kernels (another tier or builder) on one scene
# compute one function; they differ where a ray meets two triangles at
# the same t (a shared edge: each walk keeps the first it tests) and the
# path then leaves from the other triangle. On the knot, the torus and
# the terrains the bound is tests/test_bvh4.py:329's. On the staircase a
# builder changes which of a step's two faces a ray meeting their edge
# takes, and their normals differ: one NVIDIA H100 80GB HBM3 (700 W)
# read rmse 6.6e-4, max |diff| 0.5 at 1 spp between the median and SAH
# scenes, so those are held to the crop gate, as phase 12 holds the
# staircase's heap and BVH4 renders.
DECIDE_RMSE = 1e-5


def readings(out, where=""):
    """(label, ``arms.Reading``) of each arm in a decision experiment's
    result, in order; a label joins the result's keys down to the arm."""
    if isinstance(out, Reading):
        return [(where or out.name, out)]
    if isinstance(out, dict):
        return [r for k, v in out.items()
                for r in readings(v, f"{where} {k}".strip())]
    if isinstance(out, (tuple, list)):
        return [r for x in out for r in readings(x, where)]
    return []


def decide_agree(tag, a, b, problems, bound="rmse"):
    """Two arms' images against each other at ``bound``: "exact"
    (bit-equal), "rmse" (rmse < DECIDE_RMSE) or "gate" (the crop gate's
    rmse < 5e-3 and SSIM >= 0.99); prints the reading, records a
    failure."""
    d = float(np.abs(a.image - b.image).max())
    r, s = golden.rmse(a.image, b.image), golden.ssim(a.image, b.image)
    ok = {"exact": d == 0.0, "rmse": r < DECIDE_RMSE,
          "gate": r < RMSE_TOL and s >= SSIM_MIN}[bound]
    text = {"exact": "bit-equal", "rmse": f"rmse < {DECIDE_RMSE:g}",
            "gate": f"rmse < {RMSE_TOL:g}, SSIM >= {SSIM_MIN}"}[bound]
    phase("decide", f"{tag}: {a.name} vs {b.name}: max |diff| {d:.3e} "
          f"(a sample), rmse {r:.3e}, ssim {s:.6f} (bound: {text})")
    if not ok:
        problems.append(f"{tag}: {a.name} vs {b.name} max |diff| {d:.3e} "
                        f"rmse {r:.3e} ssim {s:.6f} (bound: {text})")


def decide_one(dev, name, fn, tiers, problems):
    """One decision experiment, ``fn(dev)``, with the counts of every
    frame and probe kernel set to 0 just before it and read just after:
    its arms' tiers must be ``tiers``, each arm's timed render must launch
    its tier's kernels (``TIER_KERNELS``) and the call no probe kernel;
    prints each arm and checks the invariants its script asserts or
    prints, adding a failure to ``problems``. Returns the launches of
    each kernel in its arms' timed renders."""
    bench.reset_launches()
    bench.reset_launches(PROBE_MODULES)
    t0 = time.perf_counter()
    out = fn(dev)
    secs = time.perf_counter() - t0
    # each timed render sets the frame kernels' counts to 0 before it: what
    # they hold now is the last one's; the probes' counts cover the call
    last = bench.read_launches()
    probes = bench.read_launches(PROBE_MODULES)
    labelled = readings(out)
    arms = [r for _, r in labelled]
    got = tuple(r.tier for r in arms)
    want = set().union(*(TIER_KERNELS[t] for t in tiers))
    if got != tiers or probes or not set(last) <= want:
        raise AssertionError(f"{name}: tiers {got}, not {tiers}; probes "
                             f"launched {probes}, the last render {last}")
    ran = collections.Counter()
    for label, r in labelled:
        ran.update(r.launches)
        if set(r.launches) != TIER_KERNELS[r.tier]:
            raise AssertionError(f"{name} {label}: launched {r.launches}, "
                                 f"not {sorted(TIER_KERNELS[r.tier])}")
        phase("decide", f"{name} {label} {r.cfg.nx}x{r.cfg.ny} {r.spp} spp "
              f"depth {r.cfg.max_depth}: tier {r.tier}, {r.seconds:.3f} s "
              f"(CUDA events; host wall {r.wall:.3f} s), {r.iters} regen "
              f"iterations, kernel launches {r.launches}, mean "
              f"{r.mean:.6f}")
    if name == "pool_probe":
        for b in arms[1:]:
            decide_agree(name, arms[0], b, problems, "exact")
    elif name == "width_e2e_ab":
        for sname, pair in out.items():
            decide_agree(f"{name} {sname}", *pair.values(), problems,
                         "exact")
    elif name in ("crossover", "knot_tier_ab", "terrain_big_ab"):
        for b in arms[1:]:
            decide_agree(name, arms[0], b, problems)
        if name == "terrain_big_ab":
            phase("decide", f"{name}: built in {out[0]:.1f} s, BVH4 tables "
                  f"{out[1]}")
    elif name == "dragon_bvh4_ab":
        decide_agree(name, *arms, problems)
        phase("decide", f"{name}: forced quant tables {out.tables}, "
              f"attached in {out.attach_s:.1f} s; max |heap - bvh4q| of "
              f"the sample sums {out.max_diff:.3e}")
    elif name in ("sah_vs_median", "sah_vs_median_stairs"):
        decide_agree(name, *arms, problems,
                     "gate" if name.endswith("stairs") else "rmse")
        phase("decide", f"{name}: scenes built in {out.builds} s; speedup "
              f"sah vs median {out.speedup:.3f}x")
    elif name == "converged_oracle":
        for cname, c in out.items():
            phase("decide", f"{name} {cname}: rmse {c.rmse:.3e} (bound < "
                  f"{cvo.RMSE_TOL:g}) ssim {c.ssim:.6f} (bound >= "
                  f"{cvo.SSIM_MIN}); oracle {c.oracle_s:.1f} s in its host "
                  f"process (waited {c.waited_s:.1f} s)")
    if not all(np.isfinite(r.image).all() and r.mean > 0 for r in arms):
        problems.append(f"{name}: a non-finite or black image")
    phase("decide", f"{name} in {secs:.1f} s; launches of its timed "
          f"renders {dict(ran)}")
    return dict(ran)


def decision_phase(dev, converged):
    """Phase 22: the twelve decision experiments (``tpu_pathtracer_torch/
    experiments``), each function once at its script's scenes and
    resolutions through ``decide_one``: each arm's tier and launch set,
    the invariants the scripts assert or print (the same image at every
    lane pool and packet width; the tiers' and builders' arms within
    DECIDE_RMSE; knot_tier_ab's means), and the converged oracle
    (``converged``, started in phase 19's pool) inside its bounds.
    Returns each experiment's launches of each kernel."""
    t_phase = time.perf_counter()
    problems = []
    launches = {name: decide_one(dev, name, fn, tiers, problems)
                for name, fn, tiers in (*DECIDE, (
                    "converged_oracle", lambda d: cvo.finish(converged),
                    ("spheres", "spheres")))}
    if problems:
        raise AssertionError("phase 22: " + "; ".join(problems))
    phase("decide", f"phase 22 in {time.perf_counter() - t_phase:.1f} s")
    return launches


def config5_phase(dev, workdir):
    """Phase 20: BASELINE config 5's frame (the staircase at 3840x2160,
    depth 64) through ``render_with_checkpoints`` with batch 1, straight
    to 2 spp (a), and to 1 spp then resumed from the file to 2 spp (b),
    bit-equal; a file whose fingerprint was changed is refused. Then the
    staircase-toy's frame tiled over two stripes of the card against one
    render. Returns the K4/K4c launches of run (a)."""
    from tpu_pathtracer_torch.parallel.tiles import render_image_tiled_regen
    from tpu_pathtracer_torch.utils import checkpoint as ck

    t_phase = time.perf_counter()
    cfg = RenderConfig(**CONFIG5)
    scene, cam = procedural_staircase_scene(cfg.nx, cfg.ny, device=dev)
    batches = []

    def progress(done, total):
        torch.cuda.synchronize()
        batches.append(time.perf_counter())

    path_a = os.path.join(workdir, "a.ckpt")
    path_b = os.path.join(workdir, "b.ckpt")
    bench.reset_launches()
    bench.reset_launches(PROBE_MODULES)
    t0 = time.perf_counter()
    img_a = ck.render_with_checkpoints(scene, cam, cfg, path_a, batch=1,
                                       progress=progress)
    launches = {**bench.read_launches(),
                **bench.read_launches(PROBE_MODULES)}
    if set(launches) != TIER_KERNELS["brute"]:
        raise AssertionError(f"config 5 launched {launches}, not "
                             f"{TIER_KERNELS['brute']}")
    spp_secs = np.diff([t0, *batches])
    ck.render_with_checkpoints(scene, cam, cfg.replace(ns=1), path_b,
                               batch=1)
    # the same file, its fingerprint changed, must be refused
    bad = os.path.join(workdir, "bad.ckpt")
    acc, done, fp = ck.load_checkpoint(path_b)
    ck.save_checkpoint(bad, acc, done, fp ^ 1)
    try:
        ck.render_with_checkpoints(scene, cam, cfg, bad, batch=1)
    except ValueError as e:
        if "fingerprint" not in str(e):
            raise
    else:
        raise AssertionError("config 5 resumed a file of another "
                             "fingerprint")
    img_b = ck.render_with_checkpoints(scene, cam, cfg, path_b, batch=1)
    sums_equal = np.array_equal(ck.load_checkpoint(path_a)[0],
                                ck.load_checkpoint(path_b)[0])
    if not (np.array_equal(img_a, img_b) and sums_equal):
        raise AssertionError(f"config 5 resumed at 1 spp differs from the "
                             f"straight run: max |diff| "
                             f"{np.abs(img_a - img_b).max():.3e}")
    if not (np.isfinite(img_a).all() and img_a.mean() > 0.01):
        raise AssertionError(f"config 5: bad image, mean {img_a.mean()}")
    spp = float(np.mean(spp_secs))
    paths = cfg.num_pixels
    phase("config5", f"{cfg.nx}x{cfg.ny} depth {cfg.max_depth}, batch 1 "
          f"(ns cut from 1000 to {cfg.ns}): seconds a spp "
          f"{', '.join(f'{x:.3f}' for x in spp_secs)} (host clock, each "
          f"batch closed by its copy to the host and its checkpoint "
          f"write), {paths / spp / 1e6:.3f} "
          f"Mpaths/s; 1000 spp at that rate would take {1000 * spp:.0f} s "
          f"(an extrapolation, not a run); kernel launches {launches} "
          f"({ {k: v / cfg.ns for k, v in launches.items()} } a spp); "
          f"stopped at 1 spp and resumed to 2: bit-equal to the straight "
          f"run (image and sum buffer); a changed fingerprint refused; "
          f"mean {img_a.mean():.5f}")

    tcfg = RenderConfig(**TILE_FRAME)
    tscene, tcam = procedural_staircase_scene(tcfg.nx, tcfg.ny, device=dev)
    single = render_image_regen(tscene, tcam, tcfg)
    tiled = render_image_tiled_regen(tscene, tcam, tcfg,
                                     devices=[dev, dev])
    diff = float(np.abs(tiled - single).max())
    phase("config5", f"tiles: the staircase-toy {tcfg.nx}x{tcfg.ny} "
          f"{tcfg.ns} spp depth {tcfg.max_depth} in 2 stripes of {dev} "
          f"against one render: max |diff| {diff:.3e} (bound {TILE_ATOL})")
    if not diff <= TILE_ATOL:
        raise AssertionError(f"tiled render differs by {diff:.3e}")
    phase("config5", f"phase 20 in {time.perf_counter() - t_phase:.1f} s")
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False); nothing runs on the CPU in its place")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    phase("device", f"{torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    t_phase = phase_seconds("1", t_start)
    build_all()
    phase_seconds("2", t_phase)
    # the oracle of phase 19's gates renders on the host (at a lower
    # priority) beside phases 3-13 and 20; the rocks' takes minutes
    pool = multiprocessing.get_context("spawn").Pool(
        len(bench.ORACLE_GATES), initializer=os.nice, initargs=(10,))
    try:
        with tempfile.TemporaryDirectory() as workdir:
            gates = start_oracle_gates(dev, pool)
            converged = cvo.start(dev, pool, spp=CONVERGED_SPP)
            headline_profile, kernels = spheres_path(dev)
            stair_profile, stair_recs = staircase_path(dev)
            config4_profile, config4_recs = staircase_hires_path(dev)
            dragon_profiles, dragon_recs = dragon_path(dev)
            kernels += [*stair_recs, *config4_recs, *dragon_recs]
            c5 = config5_phase(dev, workdir)
            zoo, c2 = bench_phase(dev, smi)
            decided = decision_phase(dev, converged)
            oracle_gate_phase(gates)
    finally:
        pool.terminate()
        pool.join()
    for rec in stair_recs:  # K4's and K4c's launches a 4K spp of config 5
        mode = {"tris_hit_feat": "features",
                "tris_anyhit_soa": "any_hit"}[rec["name"]]
        rec["launches_config5_spp"] = c5[f"cuda_tris.{mode}"] / CONFIG5["ns"]
    # phase 21's frames: K1's in config 2, K8/K9's in the knot and the two
    # terrains, K5/K6's in the rock pile
    zoo_modes = {"spheres_hit_feat": ("cuda_spheres", ("config2",)),
                 "bvh4_trace": ("cuda_bvh4.nearest",
                                ("knot", "terrain", "terrain_big")),
                 "bvh4_occluded": ("cuda_bvh4.any_hit",
                                   ("knot", "terrain", "terrain_big")),
                 "heap_trace": ("cuda_bvh.nearest", ("rocks",)),
                 "heap_occluded": ("cuda_bvh.any_hit", ("rocks",))}
    for rec in kernels:
        key, frames = zoo_modes.get(rec["name"], (None, ()))
        for name in frames:
            rec[f"launches_{name}"] = ({**zoo, "config2": c2}[name])[key]
    # phase 22's experiments: each one's launches of each kernel it ran
    modes = {"spheres_hit_feat": "cuda_spheres",
             "tris_hit_feat": "cuda_tris.features",
             "tris_anyhit_soa": "cuda_tris.any_hit",
             "bvh4_trace": "cuda_bvh4.nearest",
             "bvh4_occluded": "cuda_bvh4.any_hit",
             "heap_trace": "cuda_bvh.nearest",
             "heap_occluded": "cuda_bvh.any_hit"}
    for rec in kernels:
        for name, ran in decided.items():
            if ran.get(modes.get(rec["name"])):
                rec[f"launches_{name}"] = ran[modes[rec["name"]]]
    # phase 14 after every timed frame: a profiler session slows the
    # host's later launches in the process
    t_phase = time.perf_counter()
    for profile in (config4_profile, stair_profile, headline_profile,
                    *dragon_profiles):
        profile()
    phase_seconds("14", t_phase)
    kernels += [*leaf_probe_phase(dev), *micro_phase(dev),
                *packet8_phase(dev), *layout_phase(dev)]
    phase("done", f"all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
