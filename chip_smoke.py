"""Drive the PyTorch/CUDA port on one NVIDIA card: build its kernels, check
each against its plain PyTorch version, and run the Cornell, veach-mis and
San Miguel path-tracing passes, the PrimTracer, BDPT, light-tracer and VCM
passes, the PPM and volumetric path-tracing passes in fog, the
non-perspective sensors, the regenerating wavefront path tracer, the
FastTracer and the game tracer on San Miguel, the path tracer on a
4.8M-triangle San Miguel stand-in (K2's split variant), the adaptive
block sampler
with the image pipeline and the Sobol' sampler on veach-mis, the alpha,
bump, parallax, BSSRDF and spectral scenes, two-level instanced scenes
(their BLAS visits on K1, or K2, K3 and the K1 fallback, with per-lane
roots), instance moves, refit and skinning, Mitsuba scene files through
the port's loader (all 16 BSDF types, path regularization, San Miguel from
a serialized file), the microbenchmarks P1-P3, and multi-device rendering
(the sharded passes and tracers of parallel/render.py over a world of one
rank through NCCL, and the command-line renderer).

    python3 chip_smoke.py [--profile]

Needs one CUDA device, nvcc (CUDA_HOME or PATH), g++ and the repository
checkout; imports nothing of JAX. Each phase prints one JSON line, any
failure exits non-zero, and nothing falls back to the CPU. Each
card-against-CPU comparison (card_vs_cpu) renders its CPU half in a child
forked from this process while the card renders, at most CPU_SIDE_PROCS
at once, and compares when the child is collected (collect_cpu_sides):
before any clock is read for a timing, and at the latest before the
kernel table, so that no timing runs beside a CPU half:

1. the card's name and power limit; build every kernel (csrc/traversal8.cu:
   K1; csrc/traversal_tt.cu: K2, K3; csrc/traversal_pool.cu: K4;
   csrc/microbench.cu: P1-P3; csrc/psf_gather.cu: the game filter's kernel;
   and csrc/schedule_probe.cu, the designs the shared variants of K1 and
   K2, and K3, were measured against), one nvcc
   each, all started together, and print ptxas's registers, stack and
   spills; from cuobjdump's SASS, each traversal kernel's 128-bit loads:
   the shared variants of K1 and K2 must read rows with LDS (no generic
   LD), the global kernels with LDG, and the probe's K3 designs that stage
   a slab, and K2's split variant (top_visits_split_kernel at V = 3 and
   6, both required), must stage with LDGSTS and hold at least one step's
   row loads (K3's LDG count) as LDS or generic LD (through a cluster's
   shared windows, or where a row may lie in either memory);
2. K1's variants against its plain version on the Cornell 512^2 table with
   131,072+513 rays inside the box: the shared variant (the one the size
   rule picks), the global variant forced, and the two designs of
   utils/schedule_probe.py (the shared variant with rays by a static
   stride instead of the queue, and with its stacks in shared memory);
   closest-hit, any-hit and mixed any_mask (half the lanes
   any-hit). t, tri, u, v, step counts and flags must be identical (the
   kernels are built with -fmad=false, so both round op for op); each
   variant timed by the median of 5 synchronised runs and, mixed, by its
   device time (CUDA events queued behind a sleeping kernel, so the host's
   launch cost falls outside). pool_vs_k1 on the same rays (below);
3. PathTracer on Cornell 32^2, depth 4, 16 passes against
   tests/goldens/cornell_32_pt.npz (mean relative error < 0.02);
4. the Cornell headline: PathTracer on Cornell 512^2, max_depth 6, chunks
   of 65,536 lanes, 4 passes, through K1 alone, every launch shared; then
   pool_vs_k1 on every K1 call of one more pass;
4a. veach-mis (2,164 triangles, 331 rows): K1's variants, and pool_vs_k1,
   on 65,536 camera rays plus 65,536 random rays, as in phase 2;
   pool_vs_k1 on tools/microbench_pool.py's four wavefronts (131,072
   camera, bounce, bounce with 40% at tmax 0, shadow rays; and the cut
   bounce set with those 40% at tmax -1, dead), each with the utilization
   of K4's schedule model (schedule_probe.pool_model) beside K4's count,
   and the bounce set again at 1,048,576 rays,
   and on K1's edge batches (one live lane in 65,536) through every K4
   design; the shared variant's prologue from the device times of both
   variants on one ray and on one dead ray per thread of a full grid;
4b. the veach anchor: veach_mis_anchor(48, 48), depth 8, rr_depth 4, NEE,
   256 spp as 16 passes of spp_per_pass=16, through K1; RMSE against the
   mean of tests/goldens/ref_veach.npz's two seeds under 2.5x their RMSE,
   the mean within test_rmse_anchor.py's bound and within 20% of the
   reference's (the JAX package's renders lie 10-16% under);
4c. the veach-mis headline: 512^2, depth 5, chunks of 65,536 lanes, NEE
   with MIS, 8 passes after a warm-up pass, counts zeroed around them: K1
   (all shared) and nothing else, 0 plain calls, 0 capped or overflowed
   rays, a finite non-black film; then pool_vs_k1 on every K1 call of
   one more pass;
4d-4f. the light-path slice (light_path_phases): the PrimTracer headline
   (Cornell 512^2, shading normals), the BDPT and light-tracer headlines
   (the glass Cornell box 256^2, depth 6) with K1's launches per pass by
   mode held to the count worked out from the code, one pass of each
   profiled and one pass of each (PrimTracer's too) recorded and held,
   traversal by traversal, to K1's plain version; the card's BDPT and
   light-tracer images against their goldens, and all three against the
   CPU's, pass by pass;
4g-4i. the participating-media slice (media_phases, BASELINE config 5): the
   card's PPM image against tests/goldens/cornell_32_ppm.npz; the PPM
   (beamgrid) and volumetric path-tracing headlines on fog_cornell 256^2,
   depth 6, with K1's launches per pass by mode held to the code's count,
   PPM's photons stored, ball grid, DDA steps per depth and host reads of
   the loops' exit tests, one pass of each profiled and one recorded and
   held to K1's plain version; where one PPM pass on the card and on the
   CPU part (ppm_flips: photon masks and rows, grid cells, camera rays,
   pixels); both on fog_cornell 32^2 against the CPU, pass by pass;
4j-4l. VCM (vcm_phases): the card's image against
   tests/goldens/cornell_32_vcm.npz; the headline on the glass Cornell box
   256^2, depth 6, with K1's launches per pass by mode held to the code's
   count (as BDPT's, 11 + 41), the valid photon rows and the photon grid's
   cells, one pass profiled and one recorded and held to K1's plain
   version; the glass box 32^2 against the CPU, pass by pass;
4m-4n. the light tracer and the path tracer under the spherical,
   orthographic, telecentric and thin-lens sensors against the CPU, pass
   by pass (sensor_phases); WavefrontPT on Cornell 64^2 with 3,000 lanes
   against the chunked path tracer on the card;
4o. the FastTracer on Cornell 512^2 in both modes: Mrays/s, one K1 launch
   a pass, one call of each held to K1's plain version;
4p-4q. (veach_slice_phases) the AdaptivePathTracer on veach-mis 512^2,
   depth 5, B_VARIANCE, 1,024 blocks a pass (262,144 lanes in one
   pt_radiance call): a warm-up pass, 4 timed passes, s/pass, live rays,
   6 K1 launches a pass (all shared), the chosen blocks' spread; one pass
   profiled, one recorded and each of its K1 calls held to the plain
   version; apply_pipeline on its film (Gaussian filter, NLM with the
   variance buffer, tonemap) timed; all four block modes at 32^2 against
   the CPU. PathTracer with the Sobol' sampler on the same scene, 4 timed
   passes beside 4c's independent sampler, one pass recorded and held to
   K1's plain version; the stratified and Sobol' samplers at 32^2 against
   the CPU, and the tent and Gaussian filters' camera rays (RNG states
   identical, rays within 1e-6);
4r. (feature_phases) the JAX tests' alpha (continuous and binary), bump,
   parallax (PathTracer and WavefrontPT), marble BSSRDF, and spectral
   (C=4: the dispersive glass slab, Cornell) scenes against the CPU pass by
   pass; spectral Cornell against the RGB render within
   tests/test_spectral.py's bounds;
5. the San Miguel stand-in at full width (1.2M triangles; host build
   seconds: native BVH, treelet partition) and 131,072 camera rays plus
   131,072 random rays from the courtyard, closest / any-hit / mixed:
   K1 (the global variant by the size rule; the shared one forced must be
   refused) identical to its plain version; then at both visit budgets the
   path runs (V=6 for camera rays, V=3 for the rest), K2's variants (as
   K1's in phase 2), and K3 and the probe's three K3 designs (cluster,
   split, walk), identical to their plain versions (hits, visit lists,
   counts, min-dropped t, steps, flags) and timed as K1's; on the mixed
   slots, the probe's cluster and walk designs at the probe's own chunk
   size and staging threshold (identical, the
   staged-segment count equal to the plain model's,
   schedule_probe.treelet_segments, and the device time), the cluster and
   split designs staging only (device
   time), and the probe's split of the slots (segments, staged count
   against the model, visits per staged segment, the share of valid
   visits left unstaged); K1 on the exact path's
   fallback batch (tmax -1 on every ray whose visits did not overflow,
   mixed) identical to its plain version and timed, and pool_vs_k1 on
   the same batch (rows from device memory; K1's group design there too),
   the two-phase result identical to the plain two-phase result,
   and the exact treelet path (K2 + K3 + K1 fallback) held to K1 on the
   unsplit table: t identical on every closest-hit lane, tri identical
   except on lanes where two triangles tie in t (counted and printed),
   hit/no-hit identical on any-hit lanes; medians of 5 synchronised runs of
   the treelet path, K1 and the plain two-phase path;
6. San Miguel 128^2, depth 5, 4 passes through the treelet path and again
   through K1 alone (the treelet tables dropped): mean relative error
   < 1e-3, K2 and K3 launched at both V in the first run and not at all
   in the second;
7. the San Miguel headline: San Miguel 1024^2, depth 5, chunks of 131,072
   lanes, 2 passes. The launch counts are zeroed just before and read just
   after; K1, and K2 and K3 at both V, must all launch (every K2 launch
   shared, every K1 launch global), no CUDA tensor may reach a plain
   version, and no ray may be capped or overflow. With
   --profile, one more pass runs under torch.profiler and its kernel table
   is printed, summed over each kernel's template instantiations (and so
   does one more pass of each headline that names a profiled pass: 4c-4q,
   7a, 7c, 9c, 9d; without --profile none of them runs);
7a. the config-3 headline (sm_slice_phases): WavefrontPT on the same
   scene, 1024^2, depth 5, 131,072 lanes, a warm-up pass, then 2 timed
   passes: loop iterations and host reads per pass, K2, K3 and K1-fallback
   launches per pass, no capped, overflowed or clipped ray or path, and
   the live rays of pass index 1 equal to the chunked path tracer's in
   phase 7; one pass profiled; one traversal from a recorded pass held
   kernel by kernel (K2, K3 on K2's slots, K1 on the fallback batch) to
   the plain versions (treelet_on_call);
7b. the FastTracer on San Miguel 1024^2 in both modes: Mrays/s, one K2
   (V=6), K3 and K1 launch a pass, one call of each held to the plain
   versions;
7c. (game_phases) the GameTracer on the same scene, 1024^2: a warm-up
   frame, 4 timed frames, s/frame, live rays, K2 (V=6 camera, V=3
   shadow), K3 and K1-fallback launches a frame, the cache's valid rows
   and occupied cells, peak memory; one frame profiled; both traversals of
   a recorded frame held kernel by kernel to the plain versions; the
   filter's kernel (ops/psf.py, csrc/psf_gather.cu, one launch a frame) on
   that frame's grid and queries (psf_gather line): device ms beside its
   bound, the range search's and the plain version's ms, counts equal away
   from the hard tests' thresholds and sums within PSF_RTOL; the game
   tracer on Cornell 32^2 against the CPU, frame by frame;
7d. (sm48_phases) the San Miguel stand-in at 4,800,000 triangles, built on
   the card (its top table of 998-999 rows is past one block's shared
   memory: K2's split variant):
   PathTracer 1024^2, depth 5,
   chunks of 131,072, a warm-up and 2 timed passes (s/pass, live Mrays/s),
   every K2 launch the split variant at both V, K3, every K1 launch the
   group design, no K4, no plain call, nothing capped; every K2 call of
   one more pass held (hold_k2_call) in the split variant as kept, the
   probe's cluster design at n = 4 and 2n = 8 blocks and the probe's
   global design (one thread per ray), identical to
   the plain version, each timed twice (k2_split_call lines after P1,
   with each design's chain floor and floor_ratio, and
   k2_designs_summary: the sums over the pass, the spread of two readings,
   the fastest design); one traversal of 262,144 rays through the treelet
   path against K1 alone on the 1,057,031-row table (hit/no-hit and t
   within 1e-3);
8. P1-P3 (utils/microbench.py) timed at their full sizes, with the counts
   zeroed around the run; the output of every timed configuration must
   equal its plain version's on the same inputs, and every design, kind
   and form must launch. P1 runs each mode of read
   (thread, shared, group of 16 lanes, cluster of 2, 4 and 8 blocks, bulk
   copy) that fits each table, reading the whole row, and each mode but
   bulk reading a node step's 14 float4, at 1,024 chains and at one chain
   a warp on every SM, and reports ns per dependent row as the slope
   between 256 and 512 steps (p1_ns_per_row). P2 (a) times the port's
   row gathers as table.index_select(0, idx) in three designs (a thread a
   row, a thread a float4, TMA both ways) on two index streams recorded on
   the main path: the game frame's neighbourhood of 7c (RecordPsf and
   psf_take: the index stream of 1,048,576 queries x 8 runs of 16 rows of
   48 bytes that the plain filter gathers; the card's filter runs
   psf_gather) and one EWA
   texel-quad tap of a WavefrontPT iteration of 7a, beside
   torch.index_select and the port's table[idx.long()] (p2_take). P2 (b)
   times step_only, a traversal step on a node or leaf row held in
   registers (veach-mis's root and a leaf row; phase 1 checks that its
   loop holds no load from memory), closest and any-hit, at one warp an
   SM and at full occupancy (p2_step_only); the smallest reading at one
   warp an SM is added to every step of the chain floors. P3 times the
   queue fetch in its three forms (memset, the stream's work area, K4's
   claim at 8 idle lanes, the last on 4a's veach-mis bounce stream with
   40% dead rays and each live ray held for its traversal's steps) at
   both occupancies (p3_forms, with the threshold form's share of cycles
   in fetch rounds beside K4's loss to K1 on that set).
9a. (instanced_phases) the instanced golden: PathTracer on the JAX tests'
   instanced scene (five nodes sharing one sphere: six instances, the
   dense route, K1 with per-lane roots) at 48^2, depth 4, 8 passes against
   tests/goldens/instanced_48_pt.npz (< 0.02), and against the CPU pass by
   pass (CARD_CPU_LIMIT); 30 K1 launches a pass;
9b. bench.py's instanced scene (one 33,020-triangle sphere shared by 16
   nodes, a floor, and for the path tracer an area light) at 512^2, built
   instanced (a split forest: root_top set) and flattened (528,324
   triangles), build
   seconds and rows of each; one traversal of 131,072 camera rays through
   each, Mrays/s; the instanced hits against the flattened ones (validity,
   t within 1e-5 and the node each lands on identical but on grazing rays,
   |cos| < GRAZE, at most 1e-4 of the rays); every K2 (per-lane top-local
   roots), K3 and K1 (per-lane global roots) call of one instanced
   traversal held to its plain version (hold_calls: identical, device
   time, plain time, bound);
9c. PathTracer on it, 512^2, depth 5, chunks of 131,072, 2 passes, the
   flattened build's beside it: s/pass, live Mrays/s, launches per pass
   (K2, K3 and K1 one each per instance per traversal, 17 x 6 traversals a
   chunk), one instanced pass profiled, live rays within LIVE_RAYS_GAP of
   the flattened build's, pass by pass;
9d. the 530-instance grid at 512^2 (the TLAS route): its camera rays'
   visit lists drop nothing; PathTracer depth 5, a warm-up and 2 timed
   passes: 12 K1 launches (per-lane roots) per traversal, the visits its
   other rays drop past the budget (counted), the TLAS walk's host reads,
   its image against the flattened build's (< 0.02); every K1 call of one
   traversal held to its plain version; one pass profiled;
9e. one instance of 9b's scene moved in 4 frames through update_transforms,
   each frame's 256^2 pass against a fresh build's (< 0.02), update and
   build seconds; the Cornell box's sphere moved through the flat refit,
   its hits (t, validity) identical to a fresh build's; skin_vertices of
   65,536 vertices on the card against the CPU (SKIN_LIMIT).
L1-L3. (loader_phases) Mitsuba files written to a temporary directory and
   loaded through scene/loader/ (no file from outside the checkout, .hdr
   the only image format). L1, BASELINE config 1: cornell.xml, phase 4's
   Cornell box as rectangle, cube and sphere shapes (the sphere tessellated
   32 x 64 by the loader); PrimTracer depth and normal AOVs at 512^2 (one
   K1 launch each, the variant the size rule picks for its 612 rows), the
   PT at 512^2, depth 6, chunks of 65,536, a warm-up and 4 timed passes,
   its mean within L1_MEAN_GAP of phase 4's, every K1 call of one pass held
   to the plain version and put through pool_vs_k1; at 32^2 the tables'
   rows equal on the card and the CPU and the PT within CARD_CPU_LIMIT of
   the CPU pass by pass. L2:
   materials.xml, a 4 x 4 grid of spheres, one per BSDF type (with the
   twosided, coating, rough coating and blend adapters), a blackbody area
   light and a sun-and-sky map that must equal preetham_sky's; every type
   in the material table; the PT at L2_SIZE^2 (256^2), depth 5, without
   and with regularization (a warm-up and L2_PASSES timed passes each;
   K2, K3 and the K1 fallback: 63,492 triangles), every K2, K3 and K1
   call of one pass held to its plain version; at L2_SMALL^2 one pass
   each of BDPT and VCM (depth L2_SMALL_DEPTH) and the regularized
   WavefrontPT against the CPU (the PT's, plain and regularized, are
   tests/test_torch_gpu.py::test_loaded_materials_on_gpu's).
   L3: the San Miguel stand-in's nodes merged by material into one
   .serialized file (1,200,444 triangles with normals and uv) and an XML
   that loads each mesh by shapeIndex; every loaded array equal to the one
   written; parse and build seconds; one PT pass at 1024^2, depth 5,
   chunks of 131,072 (K2, K3, K1), the first traversal's calls held to the
   plain versions; parse, build and pass under L3_SECONDS. Last, an
   envmap written as .hdr must load as the image read back (the loader's
   grey stand-in for a missing file must not hide it).
S. (parallel_phases) multi-device rendering on a world of one rank
   through NCCL (the machine has one card; make_mesh from an in-process
   HashStore): the sharded passes against the unsharded ones on the same
   seeds (CARD_CPU_LIMIT; PPM_CARD_CPU_LIMIT and VCM_CARD_CPU_LIMIT for PPM
   and VCM), with the counts zeroed around each run and K1's launches by
   mode equal to the unsharded pass's: S1 the PT on Cornell 512^2, depth
   6, with the row-sharded film and with reduce_film; S2 the light tracer
   (6 + 7 K1 launches), BDPT and VCM (11 + 41) on the glass Cornell box
   256^2, depth 6, each with splat parts and with a per-pass all-reduce;
   S3 PPM on the fog Cornell box 256^2, 65,536 photons, beamgrid, then a
   pass with adaptive radii (r2 within 1e-6); S4 the PT on phase 7's San
   Miguel 1024^2, depth 5, all 1,048,576 lanes in one batch (K2, K3, the
   K1 fallback); the calls of one S1 pass, one S2 BDPT pass and S4's first
   traversal held to the plain versions (record_kernels, hold_calls); S5
   the five sharded tracers, 2 passes at 64^2, against the unsharded
   ones; seconds of every run beside the unsharded run's. Last the CLI in
   a subprocess, BDPT on Cornell 128^2, 2 passes, alone and with
   --devices 1 (the PNGs within one level, a non-zero time in its log),
   and --devices 2, which must raise on one card.

pool_vs_k1 (phases 2, 4, 4a, 4c, 5 and L1) holds K1 as the size rule picks
it, K1's group design on a global table, K4 (csrc/traversal_pool.cu, both
row sources) and the probe's K4 designs (thresholds of 1, 8 and 16 idle
lanes, 1 or 2 fetches an iteration, and K4's first design) to the plain
version on the same rays, every field identical, in closest, any-hit and
mixed mode, and once on the rays shuffled; a recorded pass's calls in
their own modes. Each design runs
with with_util: K1's slots must equal the static schedule's of the plain
steps; a counting kernel's lane steps must equal the steps' sum, its
slots be a multiple of 32 and no fewer, its rays all classified, its live
rays the plain model's (all for the first design) and the next launch's
counters zero. One line per set (or pass), mode and design: device ms
(CUDA events behind a sleeping kernel, twice a design, in order and
back), slots, utilization (steps / slots), lanes, live lanes, the bound
(trav_bound), and the card's name and power limit; pool_vs_k1_summary
sums the natural modes' device ms by design.

Each k1_global_call line's chain floor is its largest live steps times
P1's ns per dependent row for a node step's read (14 float4) in the
design's mode of read (thread or group), one chain a warp, the lowest over
the measured tables of at most the call's rows: a traversal keeps its hot
rows in the nearest cache, so the floor takes the table that caches best
and stays a lower bound. floor_ratio is each design's device ms over its
floor (under 1: the design beat the floor; the run does not fail on it).

The kernel table comes next: one row for each variant of K1 and K2 and
for the probe's K2 global design, for K3 and each of the probe's K3 designs, for K4's two row sources and the
probe's K4 designs, and for P1-P3, with its
launches on its own path (the probe's K2 and K3 designs take none on the
main path, nor does K4; K2's split variant on the
4.8M pass, every call of one pass summed; P1 in each mode), its time and
its plain
version's time (K1 shared on veach-mis, with its utilization there and
on Cornell from pool_vs_k1, K1 global on the San Miguel
fallback batch, K2 and K3 at V=3, K4 on veach-mis (shared rows, and the
probe's designs) and on the San Miguel fallback batch at V=3 (global
rows), with K4's utilization, threshold and every set under by_set; the
other shapes under
by_scene, by_tracer (K1 shared: one pass of each tracer of 4d-4q, summed by
mode, the adaptive and Sobol' passes among them; K1 global, K2 and K3:
WavefrontPT's, the FastTracer's and the GameTracer's launches per pass
and their recorded calls on San Miguel; K1 shared, K1 global, K2 and K3
also the instanced traversals of 9b and 9d, every call summed, and the
loader's: loader_cornell under the K1 variant it took, loader_materials
and loader_sm under K1 global, K2 shared and K3; phase S's launches
under parallel and parallel_san_miguel),
by_v, fallback_by_v and mixed_rays; the forced global variant and the
probe's designs on the same rays beside K1's and K2's shared rows; the
probe's split of the slots beside its cluster design), its device time
where taken, and its bound:
the larger of the bytes it must move over 3.35 TB/s and its float32
operations over 67 TFLOP/s (traversal: the table once, for K3 each slab a
valid visit names, the rays in and the hits out; the measured steps times
a node step's operations). Then the card's name and power limit, and last
the device record.
"""
import json
import os
import re
import resource
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

T0 = time.perf_counter()
# the profiled passes run only under --profile (parsing a trace of 10^5
# device events takes up to a minute)
PROFILE = "--profile" in sys.argv[1:]
HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "goldens", "cornell_32_pt.npz")
N_RAYS = 131072 + 513
# K1's and K2's variants held to the plain versions on a table that fits
# shared memory: the one the size rule picks (None), the global variant
# forced, and the two designs the shared variant was measured against
# (utils/schedule_probe.DESIGNS)
K1_VARIANTS = (None, "global", "stride", "smem_stack")
# K3's designs held to its plain version on the San Miguel slots: the kept
# kernel (None) and the three of utils/schedule_probe.K3_DESIGNS
K3_DESIGNS = (None, "cluster", "split", "walk")
# K1's global variant: one thread per ray, the group design as the
# render paths run it (16 lanes a live ray), and the probe's group designs
# (utils/schedule_probe.GROUP_DESIGNS: 8 or 32 lanes, or 16 with an L2
# prefetch of each node step's eligible children; k1_global_runner)
K1_GLOBAL_DESIGNS = ("thread", "group", "g8", "g32", "g16p")
# the lanes of the edge batch with one live lane
K1_EDGE_BIG = 1 << 20
# pool_vs_k1's designs: K1 as the size rule picks it ("k1"; its slots from
# its static schedule), K1's group design on a global table ("k1_group"),
# K4 ("k4") and the probe's K4 designs (utils/schedule_probe.POOL_DESIGNS:
# thresholds of 1, 8 and 16 idle lanes, 1 or 2 fetches an iteration, and
# K4's first design)
POOL_DESIGNS = ("k1", "k1_group", "k4", "f1", "f8", "f16", "r1", "r2", "first")
# pool_vs_k1's veach-mis wavefronts (tools/microbench_pool.py:60-100): rays,
# and the share of bounce lanes cut to tmax 0 (live) or -1 (dead)
POOL_RAYS = 1 << 17
POOL_CUT = 0.4
# the bounce set again at 8 rays a resident lane of a shared-table launch
# (131,072 rays are ~2), where a refill has more to recover than the tail
POOL_RAYS_BIG = 1 << 20
# the edge batch with one live lane on a shared table (pool_vs_k1's
# veach-mis edges; the San Miguel ones take K1_EDGE_BIG)
POOL_EDGE_BIG = 1 << 16
SM_HALF = 131072
VEACH_HALF = 65536
# the film sizes of the veach-mis and San Miguel headlines
VEACH_SIZE = 512
SM_SIZE = 1024
REF_VEACH = os.path.join(HERE, "tests", "goldens", "ref_veach.npz")
CAL = 2.5   # tests/test_rmse_anchor.py's calibration of the noise floor
# the veach anchor's mean may lie at most this share under or over the
# reference's: the JAX package's own renders of the anchor (seeds 0-2, on
# the CPU) lie 10-16% under it, and the port's equal them
MEAN_GAP = 0.2
# the light-path slice's headlines: PrimTracer passes timed after the
# warm-up; BDPT and light-tracer depth and timed passes (bench.py's config 4)
PRIM_PASSES = 20
LP_DEPTH = 6
LP_PASSES = 4
# the card's renders against the CPU's on the same inputs: passes of BDPT
# and the light tracer (each pass draws a fresh RNG stream), and the limit
# on the mean relative error of every cumulative image, PrimTracer's too:
# the card's images lay 2.5e-8 to 1.8e-7 from the CPU's and the goldens
# (H100 80GB HBM3), the splats' atomic adds and the card's transcendental
# functions rounding a last bit differently. 2 passes (6 until the
# multi-device slice made room for its phase: at 6 the CPU side of the 32²
# BDPT, PPM, VCM, volumetric-PT, adaptive and sampler comparisons took
# ~100 s on a fast host, at 3 ~55 s)
CARD_CPU_PASSES = 2
CARD_CPU_LIMIT = 1e-5
# the participating-media slice (BASELINE config 5): fog_cornell 256^2,
# depth 6; PPM with W*H photons, a warm-up and PPM_PASSES timed passes
# (bench.py's config 5), the volumetric path tracer in chunks of 65,536
# lanes, VPT_PASSES timed passes
MEDIA_DEPTH = 6
PPM_PASSES = 3
VPT_PASSES = 2
# PPM's card image against the CPU's (fog_cornell 32^2, depth 6,
# CARD_CPU_PASSES passes; the volumetric path tracer keeps CARD_CPU_LIMIT):
# the readings lay at 5.6e-6 to 1.41e-5 (H100 80GB HBM3): the photons and
# grids are identical (ppm_flips), but the card's camera rays differ from
# the CPU's by up to 1.8e-7 and the gather kernels weigh each photon by its
# distance to the hit, so some pixels move by more than 1e-4 of their
# value. ~7x the largest reading
PPM_CARD_CPU_LIMIT = 1e-4
# VCM's card image against the CPU's (the glass Cornell box 32^2, depth 6,
# CARD_CPU_PASSES passes): a merge counts a photon by the hard test
# d^2 <= r^2, so where the card's camera hits (within ~1e-6 of the CPU's)
# carry a photon across its radius, a whole photon enters or leaves a
# pixel. The readings lay at 3.3e-6 to 1.99e-5, one pixel of 1,024 off by
# 2.3% (H100 80GB HBM3, 700.00 W); 5x the largest reading
VCM_CARD_CPU_LIMIT = 1e-4
# the sensors: passes of the light tracer and the path tracer at 32^2
# under each non-perspective sensor, card against CPU (CARD_CPU_LIMIT)
SENSOR_PASSES = 3
# WavefrontPT: the config-3 headline (San Miguel 1024^2, depth 5) with a
# pool of WF_LANES lanes (bench.py's chunk), WF_PASSES timed passes; on
# Cornell 64^2, a pool of WF_SMALL_LANES (fewer than the 4,096 paths and
# not a divisor of them) against the chunked path tracer
WF_LANES = 131072
WF_PASSES = 2
WF_SMALL_LANES = 3000
# the FastTracer's timed passes on Cornell 512^2 and San Miguel 1024^2
FAST_PASSES = 20
FAST_SM_PASSES = 3
# the adaptive block sampler on veach-mis 512^2: blocks a pass (every block
# of the film's 32 x 32: 262,144 lanes in one call) and timed passes; the
# Sobol' PT's timed passes beside 4c's independent sampler
ADAPT_BLOCKS = 1024
ADAPT_PASSES = 4
SOBOL_PASSES = 4
# the adaptive tracer's card image against the CPU's (veach-mis 32^2,
# CARD_CPU_PASSES passes, each mode): the film and the variance buffer add
# a pixel's repeated samples with atomics in any order, and the block
# weights read the buffer. The readings lay at 1.7e-7 to 3.5e-7 in all four
# modes (H100 80GB HBM3, 700.00 W): a B_VARIANCE weight that is NaN on one
# side only would move every weighted block, which did not happen; the
# path tracer's limit
ADAPT_CARD_CPU_LIMIT = 1e-5
# the game tracer: timed frames on San Miguel 1024^2; frames and the limit
# of its card image against the CPU's on Cornell 32^2. Its gather and
# history tests are hard tests on floats: the readings lay at 1.1e-7 to
# 1.2e-7, no sample flipped (H100 80GB HBM3, 700.00 W), but one neighbour
# that crosses d^2 <= r^2 or the normal test moves its pixel by ~1/30 of
# itself, ~3e-5 of the image's mean: the limit admits three such crossings
GAME_FRAMES = 4
GAME_CARD_CPU_FRAMES = 3
GAME_CARD_CPU_LIMIT = 1e-4
# the filter's kernel (psf_gather_call): its sums' largest relative
# distance from the plain version's: two sums of the same up to 128
# non-negative float32 terms in other orders, each within 127 x 2^-24 of
# the exact sum
PSF_RTOL = 2 * 127 * 2.0 ** -24
# two-level instancing (9a-9e): the instanced golden's passes (card and
# CPU, tests/test_goldens_family.py's 8); bench.py's instanced scene at
# INST_SIZE^2 with INST_RAYS camera rays (bench.py:436-438) and its path
# tracer (depth INST_DEPTH, chunks of INST_RAYS, INST_PASSES timed passes,
# the flattened build's beside it); the 530-instance grid's timed passes;
# the frames of the moved instance and their film size
INST_GOLDEN_PASSES = 8
INST_SIZE = 512
INST_RAYS = 131072
INST_DEPTH = 5
INST_PASSES = 2
GRID_PASSES = 2
UPDATE_FRAMES = 4
UPDATE_SIZE = 256
# an instanced hit may part from the flattened build's only where the ray
# grazes the surface (|cos| below this between the ray and the normal):
# each build rounds the ray in its own space (local against world)
GRAZE = 0.05
# the instanced path tracer's live rays against the flattened build's, per
# pass: the same paths, parting only where a grazing ray's hit differs
LIVE_RAYS_GAP = 1e-3
# the grid path tracer's bounce and shadow rays drop visits past the TLAS
# walk's budget of 12, as the JAX walk does (its camera rays drop none):
# 58,185.5 a pass measured (H100 80GB HBM3, 700 W); a pass that drops more
# than this fails
GRID_DROPPED_MAX_PER_PASS = 60_000
# lanes of one of the grid's merged traversals whose TLAS walk is rerun on
# the CPU: visit lists, counts and dropped visits identical
GRID_TLAS_CPU_LANES = 65536
# skin_vertices on the card against the CPU: sums of four products of
# values of a few units, each side rounding its own order
SKIN_LIMIT = 1e-5
# device_ms's sleeping kernel: ~6 ms at the H100's 1.755 GHz, longer than
# the host takes to queue its calls
SLEEP_CYCLES = 10_000_000
# the loader slice (loader_phases): sizes, depths, chunks and limits
LOADER_SIZE = 512
LOADER_CHUNK = 65536
LOADER_PASSES = 4
LOADER_SMALL = 32
LOADER_CPU_PASSES = 2
L1_DEPTH = 6
L2_DEPTH = 5
# L2 evaluates all 16 closed forms on every lane, and every simple type
# again inside its coatings and blends (JAX's dispatch): 10-12 s a 512²
# pass and 40-45 s a 32² BDPT or VCM pass on the card and the CPU, so one
# timed pass a setting at L2_SIZE² (one chunk of LOADER_CHUNK lanes), and
# its card-against-CPU passes at 16², BDPT and VCM at depth 2 (20-23 s
# each at depth 3 on the CPU side); the PT's, plain and regularized, are
# tests/test_torch_gpu.py::test_loaded_materials_on_gpu's (the same file,
# size and depth, two passes)
L2_SIZE = 256
L2_PASSES = 1
L2_SMALL = 16
L2_SMALL_DEPTH = 2
L1_MEAN_GAP = 0.05      # only the sphere's tessellation differs from phase 4
L3_SIZE = 1024
L3_DEPTH = 5
L3_CHUNK = 131072
L3_SECONDS = 60.0       # parse, build and one pass
# the traversal kernels' names in a profile, one entry per K2
# instantiation (template argument: V)
KERNEL_RE = re.compile(r"traverse8(?:_shared|_group)?_kernel"
                       r"|top_visits(?:_shared|_split)?_kernel(?:<\d+>)?"
                       r"|treelet_hits_kernel|traverse_pool(?:_shared)?_kernel")
# the kernels in a mangled SASS function name, and their template arguments
SASS_NAME_RE = re.compile(r"(traverse8_shared_kernel|traverse8_kernel"
                          r"|top_visits_shared_kernel|top_visits_split_kernel"
                          r"|treelet_hits_kernel|traverse_pool_shared_kernel"
                          r"|traverse_pool_kernel)"
                          r"(I(?:L[bi]\d+E)+E)?")
# K3's probe designs in a mangled name: the blocks of a cluster and where
# the staged slab lives
PROBE_K3_RE = re.compile(r"probe_treelet_kernelILi(\d)EN\w*?(Cluster|Split|Walk)Stage")
SASS_LOAD_RE = re.compile(r"\b(?:LDS|LDG|LD|LDGSTS)(?:\.[A-Z0-9_]+)*\b")
# P2 (b)'s kernels in a mangled name (node row, any-hit), and every load
# from memory other than the constant bank in a SASS line
STEP_ONLY_RE = re.compile(r"step_only_kernelILb(\d)ELb(\d)E")
SASS_MEM_LOAD_RE = re.compile(r"\b(?:LDGSTS|LDG|LDS|LDL|LD)(?:\.[A-Z0-9_]+)*\b")


def emit(**kw):
    print(json.dumps(dict(kw, t=round(time.perf_counter() - T0, 1))), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_median_ms(fn, reps=5):
    collect_cpu_sides()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, reps=10):
    """Device time of one call of `fn`: the median, over `reps` calls, of the
    time between CUDA events recorded around each call, all queued behind a
    sleeping kernel, so that the host's launch and synchronisation (which
    cuda_median_ms includes) fall outside them."""
    collect_cpu_sides()
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[0].record()
    for k in range(reps):
        fn()
        ev[k + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[k].elapsed_time(ev[k + 1]) for k in range(reps))


def sass_loads(lib_path, nvcc):
    """{kernel<template args>: {128-bit load opcode: count}} from the SASS
    of a built library (cuobjdump -sass)."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            m, p = SASS_NAME_RE.search(ln), PROBE_K3_RE.search(ln)
            args = re.findall(r"L[bi](\d+)E", m.group(2) or "") if m else []
            fn = (m.group(1) + (f"<{','.join(args)}>" if args else "")) if m else None
            if p:
                fn = f"probe_treelet_kernel<{p.group(2).lower()},{p.group(1)}>"
            if fn:
                out[fn] = {}
            continue
        if fn:
            for op in SASS_LOAD_RE.findall(ln):
                if "128" in op:
                    out[fn][op] = out[fn].get(op, 0) + 1
    return out


def sass_loop_loads(lib_path, nvcc):
    """{step_only_kernel<row,mode>: (loops, {load opcode: count inside a
    loop})} from the SASS of a built microbench library: a loop is the
    address range of a backward branch, [its target, the branch]."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    funcs, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            m = STEP_ONLY_RE.search(ln)
            fn = (f"step_only_kernel<{'node' if m.group(1) == '1' else 'leaf'},"
                  f"{'any_hit' if m.group(2) == '1' else 'closest'}>") if m else None
            if fn:
                funcs[fn] = []
            continue
        a = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
        if fn and a:
            funcs[fn].append((int(a.group(1), 16), a.group(2)))
    out = {}
    for fn, ins in funcs.items():
        loops = []
        for addr, text in ins:
            b = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
            if b and int(b.group(1), 16) < addr:
                loops.append((int(b.group(1), 16), addr))
        loads = {}
        for addr, text in ins:
            if any(lo <= addr <= hi for lo, hi in loops):
                for op in SASS_MEM_LOAD_RE.findall(text):
                    loads[op] = loads.get(op, 0) + 1
        out[fn] = (len(loops), loads)
    return out


def ptxas_lines(log, name):
    """ptxas's report lines (registers, stack, spills) of the entry
    functions whose mangled names hold `name`."""
    out, keep = [], False
    for ln in log.splitlines():
        if "Compiling entry" in ln or "Function properties" in ln:
            keep = name in ln
        if keep and ("registers" in ln or "stack frame" in ln):
            out.append(ln.strip())
    return out


def check_variants(label, run, plain, modes, variants, bound=None,
                   timed=("mixed",), plain_reps=5, **info):
    """Each variant of a kernel against its plain version on the same inputs
    in each mode. run(variant, kw) and plain(kw) return (fields, steps,
    flags); every field must be identical and no lane flagged. Each variant
    is timed as a median of 5 synchronised runs (and, in the modes of
    `timed`, by its device time); the plain version in the modes of `timed`,
    as a median of `plain_reps` runs. Emits one line per mode and variant
    (None: the variant the size rule picks); returns {(mode, variant):
    dict(err, ms, device_ms, plain_ms, steps, bound)}. bound(steps,
    table_bytes) gets the variant's steps and the table bytes the plain run
    fetched (RowFetches); no timed device time may be under it."""
    out = {}
    for mode, kw in modes.items():
        with RowFetches() as fetched:
            ref = plain(kw)
        plain_ms = (cuda_median_ms(lambda: plain(kw), reps=plain_reps)
                    if mode in timed else None)
        for variant in variants:
            got = run(variant, kw)
            ok, err = same(got[0], ref[0])
            ms = cuda_median_ms(lambda: run(variant, kw))
            dms = device_ms(lambda: run(variant, kw)) if mode in timed else None
            steps, flagged = int(got[1].sum()), int((got[2] != 0).sum())
            res = dict(err=err, ms=ms, device_ms=dms, plain_ms=plain_ms,
                       steps=steps,
                       bound=bound(steps, fetched.nbytes) if bound else None)
            if dms is not None and res["bound"] and dms < res["bound"][0]:
                fail(f"{label} ({variant or 'auto'}, {mode}) took {dms} ms of "
                     f"device time, under its bound {res['bound'][0]} ms")
            emit(phase="variant_vs_plain", kernel=label, mode=mode,
                 variant=variant or "auto", identical=ok, max_abs_err=err,
                 ms=ms, device_ms=dms, plain_ms=plain_ms, steps=steps,
                 flagged=flagged, bound_ms=res["bound"] and res["bound"][0],
                 **info)
            if not ok:
                fail(f"{label} ({variant or 'auto'}) disagrees with its plain "
                     f"version ({mode}, {info})")
            if flagged:
                fail(f"capped or overflowed lanes in {label} {mode} {info}")
            out[mode, variant] = res
    return out


def equal(x, y):
    """torch.equal, with a NaN equal to a NaN (a NaN tmax comes back as t)."""
    if x is None or y is None:
        return x is y
    if not x.is_floating_point():
        return torch.equal(x, y)
    return (x.shape == y.shape and x.dtype == y.dtype
            and bool(((x == y) | (x.isnan() & y.isnan())).all()))


def same(a, b):
    """(all identical, max abs difference over the finite entries of the
    float tensors) of two tuples of tensors; None entries are skipped, a
    NaN equals a NaN."""
    pairs = [(x, y) for x, y in zip(a, b) if x is not None or y is not None]
    ok = all(equal(x, y) for x, y in pairs)
    err = 0.0
    for x, y in pairs:
        if x.is_floating_point():
            m = torch.isfinite(x) & torch.isfinite(y)
            if bool(m.any()):
                err = max(err, float((x[m] - y[m]).abs().max()))
    return ok, err


class RowFetches:
    """While entered, the plain traversals (ops/traversal8._lockstep, which
    K2's and K3's plain versions share) report their row fetches; `nbytes`
    is then what the call must read of its table: each distinct node row's
    boxes and links and each distinct leaf row's triangles, once. A call
    on a large table reads a small part of it (a fallback batch's few live
    rays), so the whole table would overstate its bound. With `lanes` (a
    (B,) bool mask) only those lanes' fetches count. With `split_rows`,
    `near_far` lists each distinct pair (row reads below split_rows, row
    reads of the rest) of a lane."""

    def __init__(self, lanes=None, split_rows=None):
        from cudatracerlib_tpu_torch.ops import traversal8
        self.t8, self.seen, self.lanes = traversal8, None, lanes
        self.split_rows, self.reads = split_rows, None

    def __enter__(self):
        self.t8.on_fetch = self._log
        return self

    def __exit__(self, *exc):
        self.t8.on_fetch = None

    def _log(self, table, rows, is_node, is_leaf):
        if self.seen is None:
            self.seen = torch.zeros(table.shape[0], dtype=torch.int64,
                                    device=table.device)
        if self.lanes is not None:
            is_node, is_leaf = is_node & self.lanes, is_leaf & self.lanes
        self.seen[rows[is_node].long()] = self.t8.NODE_STEP_BYTES
        self.seen[rows[is_leaf].long()] = self.t8.LEAF_STEP_BYTES
        if self.split_rows is not None:
            if self.reads is None:
                self.reads = torch.zeros((rows.shape[0], 2), dtype=torch.int32,
                                         device=rows.device)
            far = (rows >= self.split_rows).long()
            self.reads[torch.arange(rows.shape[0], device=rows.device), far] += \
                (is_node | is_leaf).to(torch.int32)

    @property
    def nbytes(self):
        return 0 if self.seen is None else int(self.seen.sum())

    @property
    def near_far(self):
        return [] if self.reads is None else \
            [tuple(p) for p in torch.unique(self.reads, dim=0).tolist()]


# the inputs of phase 8's new microbenchmarks, each from the main path:
# TAKE_CALLS, P2's index streams ({name: (table, int32 index)}: the game
# frame's neighbourhood of 7c, recorded by RecordPsf and psf_take, and one
# EWA tap of a WavefrontPT iteration of 7a, recorded by RecordTake);
# MB_INPUTS, P2 (b)'s rows (the veach-mis table's root and a leaf row, 4a)
# and P3's threshold stream (the steps, tmin and tmax of 4a's veach-mis
# bounce wavefront with 40% of its rays dead)
TAKE_CALLS = {}
MB_INPUTS = {}


class RecordTake:
    """While entered, module.name, a row gather called as name(x, idx), is
    wrapped so that its first call whose table `table_of(x)` gives (None:
    not this gather) records (table, the flat int32 index it gathers,
    clamped into the table as the gather clamps it) as TAKE_CALLS[key];
    every call then runs as before."""

    def __init__(self, key, module, name, table_of):
        self.key, self.module, self.name, self.table_of = key, module, name, table_of

    def __enter__(self):
        self.orig = orig = getattr(self.module, self.name)

        def rec(x, idx):
            table = self.table_of(x)
            if table is not None and self.key not in TAKE_CALLS:
                table = table if table.data_ptr() % 16 == 0 else table.clone()
                TAKE_CALLS[self.key] = (table, idx.reshape(-1).clamp(
                    0, table.shape[0] - 1).to(torch.int32).contiguous().clone())
            return orig(x, idx)
        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class RecordPsf:
    """While entered, every ops/psf.psf_gather call appends its arguments
    (grid, p, ns, radius) to `self.calls` and runs as before."""

    def __init__(self, psf):
        self.psf, self.calls = psf, []

    def __enter__(self):
        self.orig = orig = self.psf.psf_gather

        def rec(grid, p, ns, radius):
            self.calls.append((grid, p.clone(), ns.clone(), radius.clone()))
            return orig(grid, p, ns, radius)
        self.psf.psf_gather = rec
        return self

    def __exit__(self, *exc):
        self.psf.psf_gather = self.orig


def psf_take(call, psf):
    """Records as TAKE_CALLS["game_neighbors"] P2's index stream of a
    recorded filter call (grid, p, ns, radius): the rows that the plain
    filter gathers (hashgrid.gather_neighbors' slots: each query's 8 ranges
    of psf.MAX_PER_CELL rows, clamped into the table)."""
    grid, p, _, radius = call
    start = psf.neighbor_ranges(grid, p, radius)[0]
    k = torch.arange(psf.MAX_PER_CELL, dtype=torch.int32, device=p.device)
    idx = (start[:, :, None] + k).clamp_max(grid.data.shape[0] - 1)
    TAKE_CALLS.setdefault("game_neighbors", (grid.data, idx.reshape(-1).contiguous()))


def psf_walk(grid, p, ns, radius, psf, ulps=2):
    """csrc/psf_gather.cu's walk modelled in PyTorch: (acc (B, 3), cnt (B,),
    near (B,), slots (B,)). Cells in order, slots k < min(count,
    psf.MAX_PER_CELL), the distance ((dx*dx + dy*dy) + dz*dz) <= r*r and
    the normal dot ((n.x*ns.x + n.y*ns.y) + n.z*ns.z) > 0.8, sums in slot
    order. `near` marks the queries with a walked slot whose distance lies
    within `ulps` ulp of r^2 or, inside it, whose normal dot lies within
    `ulps` ulp of 0.8: there another order of the plain version's sums may
    decide the test otherwise, and its count differ from the kernel's.
    `slots` counts each query's walked slots."""
    start, count = psf.neighbor_ranges(grid, p, radius)
    B, rows, dev = p.shape[0], grid.data, p.device
    r2 = radius * radius
    tol_r2 = ulps * (torch.nextafter(r2, torch.full_like(r2, float("inf"))) - r2)
    cos = torch.tensor(psf.NORMAL_COS, dtype=torch.float32, device=dev)
    tol_cos = ulps * float(torch.nextafter(cos, cos + 1) - cos)
    acc = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    cnt = torch.zeros(B, dtype=torch.float32, device=dev)
    near = torch.zeros(B, dtype=torch.bool, device=dev)
    for j in range(8):
        for k in range(psf.MAX_PER_CELL):
            walked = k < count[:, j]
            row = rows[(start[:, j] + k).clamp_max(rows.shape[0] - 1).long()]
            d = row[:, 0:3] - p
            n = row[:, psf.NORMAL]
            d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
            dn = (n[:, 0] * ns[:, 0] + n[:, 1] * ns[:, 1]) + n[:, 2] * ns[:, 2]
            ok = walked & (d2 <= r2) & (dn > psf.NORMAL_COS)
            acc = acc + torch.where(ok[:, None], row[:, psf.LI], 0.0)
            cnt = cnt + ok.to(torch.float32)
            near |= walked & (((d2 - r2).abs() <= tol_r2) | (
                (d2 <= r2) & ((dn - psf.NORMAL_COS).abs() <= tol_cos)))
    return acc, cnt, near, count.clamp_max(psf.MAX_PER_CELL).sum(1)


def psf_gather_call(label, call, psf, mb, card):
    """The filter's kernel on one recorded frame's call (grid, p, ns,
    radius) against its plain version: counts equal but where psf_walk
    says a hard test sits within 2 ulp of its threshold, sums within
    PSF_RTOL of the plain's (relative) elsewhere; device ms of the kernel
    alone (on the call's ranges), of the range search and of the plain
    version, the kernel's bound (the queries, their ranges and the outputs
    once, and each distinct row once, over the memory rate; the walked
    slots' distance tests and the passing rows' normal tests and sums over
    the float32 rate: 8 and 9 operations). Emits a psf_gather line and
    returns it."""
    grid, p, ns, r = call
    B = p.shape[0]
    start, count = psf.neighbor_ranges(grid, p, r)
    acc, cnt = psf.psf_gather_ranges(grid, start, count, p, ns, r)
    ref_acc, ref_cnt = psf.psf_gather_plain(grid, p, ns, r)
    torch.cuda.synchronize()
    differ = torch.nonzero(cnt != ref_cnt).flatten()
    near = psf_walk(grid, p[differ], ns[differ], r[differ], psf)[2]
    far = torch.ones(B, dtype=torch.bool, device=p.device)
    far[differ] = False
    err = (acc - ref_acc)[far].abs()
    rel = float((err / ref_acc[far].abs().clamp_min(1e-30)).max()) if err.numel() else 0.0
    walked = count.clamp_max(psf.MAX_PER_CELL)
    cells = torch.unique(torch.stack([start.flatten(), walked.flatten()], 1), dim=0)
    distinct = int(cells[:, 1].sum())
    n_bytes = B * (12 + 12 + 4 + 64 + 12 + 4) + distinct * 4 * psf.ROW_WIDTH
    n_ops = 8 * int(walked.sum()) + 9 * int(ref_cnt.sum())
    bound = mb.bound_ms(n_bytes, n_ops)
    kernel_ms = device_ms(lambda: psf.psf_gather_ranges(grid, start, count, p, ns, r))
    out = dict(phase="psf_gather", nvidia_smi=card, call=label, queries=B,
               rows=grid.data.shape[0], walked_slots=int(walked.sum()),
               distinct_rows=distinct, passing=int(ref_cnt.sum()),
               device_ms=kernel_ms, bound_ms=bound[0], bound_by=bound[1],
               bound_share=bound[0] / kernel_ms,
               ms=cuda_median_ms(lambda: psf.psf_gather(grid, p, ns, r)),
               ranges_device_ms=device_ms(lambda: psf.neighbor_ranges(grid, p, r)),
               plain_device_ms=device_ms(lambda: psf.psf_gather_plain(grid, p, ns, r),
                                         reps=3),
               cnt_unequal=int(differ.numel()), cnt_unequal_near=int(near.sum()),
               max_abs_err=float(err.max()) if err.numel() else 0.0, max_rel_err=rel)
    emit(**out)
    if not bool(near.all()) or rel > PSF_RTOL:
        fail(f"the filter's kernel disagrees with its plain version on {label}: "
             f"{int((~near).sum())} counts away from a threshold, sums {rel:.3g} apart")
    return out


def trav_bound(table_bytes, B, steps, mixed, mb, traversal8, live=None,
               roots=False):
    """bound_ms of one K1 launch over B lanes, `live` of them live
    (traversal8.live_lanes; all B when None): the table rows the live lanes
    fetch, once (table_bytes, RowFetches); every lane's tmin and tmax in,
    and its root with `roots`; a live lane's o and d in, and its any-hit
    flag when mixed; every lane's hits out (t, tri, u, v, steps, flags);
    the live lanes' steps (`steps` less the one step of each dead lane)
    times a node step's operations (the cheaper step kind, so the bound
    stays a lower bound). A dead lane's outputs follow from its tmax, so
    the function needs nothing else of it."""
    live = B if live is None else live
    n_bytes = table_bytes + B * (8 + 4 * int(roots) + 21) + live * (24 + int(mixed))
    return mb.bound_ms(n_bytes, (steps - (B - live)) * traversal8.NODE_STEP_FLOPS)


def live_mask(rays, kw, traversal8):
    """(B,) bool: the live lanes (traversal8.live_lanes) of a K1 call's
    rays and arguments."""
    return traversal8.live_lanes(rays, kw.get("max_iters", traversal8.MAX_ITERS),
                                 kw.get("roots"))


# every pool_vs_k1 reading: one record per set or pass, mode and design,
# for the summary and the kernel table at the end
POOL_VS_K1 = []


def pool_runner(K1, K4, traversal8):
    """run(design, table, rays, kw, counts=False) -> (hit, steps, flags,
    slots, work): a pool_vs_k1 design (POOL_DESIGNS) with with_util. With
    `counts` a design whose kernel counts its own slots runs on a new work
    area and returns it, to read its counters; else (timed runs) on the
    stream's, and work is None."""
    from cudatracerlib_tpu_torch.utils import schedule_probe as probe

    def run(design, table, rays, kw, counts=False):
        kw = plain_kw(kw)
        queue = design == "k1_group"
        work = (traversal8.group_work(rays.o.shape[0] if queue else 0, table.device)
                if counts and design != "k1" else None)
        if design == "k1":
            res = K1(table, rays, with_iters=True, with_util=True, **kw)
        elif queue:
            res = K1(table, rays, with_iters=True, with_util=True, _variant="global",
                     _design="group", _scratch=work, **kw)
        elif design == "k4":
            res = K4(table, rays, with_iters=True, with_util=True, _scratch=work, **kw)
        else:
            res = probe.traverse_pool(table, rays, design, with_iters=True,
                                      with_util=True, _scratch=work, **kw)
        return (*res, work)
    return run


def pool_timed(design, table, rays, kw, K1, K4, traversal8):
    """A call of `design` as a render path would make it (no step sums, no
    slots, the stream's work area), for timing."""
    from cudatracerlib_tpu_torch.utils import schedule_probe as probe
    kw = plain_kw(kw)
    if design == "k1":
        return lambda: K1(table, rays, **kw)
    if design == "k1_group":
        return lambda: K1(table, rays, _variant="global", _design="group", **kw)
    if design == "k4":
        return lambda: K4(table, rays, **kw)
    return lambda: probe.traverse_pool(table, rays, design, **kw)


def check_pool_design(what, design, got, ref, want_live, traversal8):
    """One pool_vs_k1 design's run against the plain version's `ref` (hit,
    steps, flags, slots): every field identical; K1's slots the plain
    version's (its static schedule); a counting kernel's lane steps equal
    to the steps' sum, its slots a multiple of 32 and no fewer, the rays it
    classified all of them, its live rays the plain model's (every ray
    for the first design, which steps the dead ones) and the next launch's
    counters left zero. Returns (max abs err, slots, lane steps)."""
    h, st, fl, slots, work = got
    ok, err = same((*h, st, fl), (*ref[0], ref[1], ref[2]))
    steps = int(ref[1].sum())
    active = counts = None
    if work is None:
        good = int(slots) == int(ref[3])
    else:
        active = int(traversal8.work_util(work)[1])
        counts = [int(work[k]) for k in traversal8.GROUP_COUNTERS]
        B = st.shape[0]
        good = (active == steps and int(slots) % 32 == 0 and int(slots) >= steps
                and int(slots) == int(traversal8.work_util(work)[0])
                and counts[3] == B
                and counts[1] == (B if design == "first" else want_live)
                and not left_counting(work, traversal8))
    if not (ok and good):
        fail(f"{design} on {what}: identical {ok}, slots {int(slots)} "
             f"(plain model {int(ref[3])}), lane steps {active} against "
             f"{steps} steps, counters {counts}, live {want_live}")
    return err, int(slots), active if active is not None else steps


def pool_vs_k1(label, table, rays, modes, K1, K4, traversal8, mb, card,
               shuffle_seed=None, timed=(), reps=10, quiet=False):
    """pool_vs_k1 on one set of rays: each design of POOL_DESIGNS that the
    table takes ("k1_group" on a global table only) in each mode of
    `modes` ({mode: kw}) against the plain version (check_pool_design),
    and with `shuffle_seed` once more on the rays shuffled (the first mode;
    results un-shuffled). Device time (device_ms, `reps` launches) twice a
    design, in the order of POOL_DESIGNS and back; the host time of the
    modes in `timed` (CUDA-synchronised median of 5) and the plain
    version's there. Emits one line per mode and design unless `quiet`;
    returns {(mode, design): dict(lanes, live, steps, slots, util,
    device_ms, ms, plain_ms, bound_ms, err)}."""
    B = rays.o.shape[0]
    run = pool_runner(K1, K4, traversal8)
    designs = [d for d in POOL_DESIGNS
               if d != "k1_group" or traversal8.launch_variant(table) == "global"]
    out, refs = {}, {}
    for mode, kw in modes.items():
        live = live_mask(rays, kw, traversal8)
        want_live = int(live.sum())
        with RowFetches(lanes=live) as fetched:
            ref = refs[mode] = traversal8.intersect_wide(
                table, rays, with_iters=True, with_util=True, **plain_kw(kw))
        steps = int(ref[1].sum())
        plain_ms = (cuda_median_ms(lambda: traversal8.intersect_wide(
            table, rays, **plain_kw(kw)), reps=3) if mode in timed else None)
        bound = trav_bound(fetched.nbytes, B, steps, mode == "mixed", mb, traversal8,
                           want_live, "roots" in kw)
        res = {}
        for design in designs:
            err, slots, active = check_pool_design(
                f"{label} ({mode})", design, run(design, table, rays, kw, counts=True),
                ref, want_live, traversal8)
            res[design] = dict(lanes=B, live=want_live, steps=steps, slots=slots,
                               util=steps / slots if slots else None, err=err,
                               bound_ms=bound[0], bound_by=bound[1], plain_ms=plain_ms,
                               device_ms=[])
        for design in designs + designs[::-1]:
            res[design]["device_ms"].append(device_ms(
                pool_timed(design, table, rays, kw, K1, K4, traversal8), reps=reps))
        for design, r in res.items():
            r["device_ms"] = statistics.median(r["device_ms"])
            r["ms"] = (cuda_median_ms(pool_timed(design, table, rays, kw, K1, K4,
                                                 traversal8)) if mode in timed else None)
            if r["device_ms"] < r["bound_ms"]:
                fail(f"{design} on {label} ({mode}) took {r['device_ms']} ms of device "
                     f"time, under its bound {r['bound_ms']} ms")
            out[mode, design] = r
            if not quiet:
                emit(phase="pool_vs_k1", set=label, mode=mode, design=design,
                     identical=True, rows=table.shape[0],
                     variant=traversal8.launch_variant(table), nvidia_smi=card, **r)
    if shuffle_seed is not None:
        mode, kw = next(iter(modes.items()))
        dev = table.device
        perm = torch.from_numpy(
            np.random.default_rng(shuffle_seed).permutation(B)).to(dev)
        shuffled = type(rays)(*(x[perm].contiguous() for x in rays))
        kw_s = {k: (v[perm].contiguous() if isinstance(v, torch.Tensor) else v)
                for k, v in kw.items()}
        ref = refs[mode]
        for design in designs:
            h, st, fl = run(design, table, shuffled, kw_s)[:3]
            un = [torch.empty_like(x).index_copy_(0, perm, x) for x in (*h[:4], st, fl)]
            ok, _ = same(un, (*ref[0][:4], ref[1], ref[2]))
            if not ok:
                fail(f"{design} on {label}, shuffled ({mode}): not identical")
        if not quiet:
            emit(phase="pool_vs_k1", set=label, mode=mode, shuffled_identical=True,
                 designs=designs)
    return out


def pool_vs_k1_pass(label, calls, K1, K4, traversal8, mb, card):
    """pool_vs_k1 on every recorded K1 call of one pass (record_k1), each in
    its own mode (3 device-time launches a reading), summed by design:
    one line per design with the pass's lanes, live lanes, steps, slots,
    utilization, device ms and bound. Returns {design: dict}."""
    total = {}
    for table, rays, kw in calls:
        mode = traversal8.launch_mode(kw.get("any_hit", False), kw.get("any_mask"))
        res = pool_vs_k1(label, table, rays, {mode: kw}, K1, K4, traversal8, mb, card,
                         reps=3, quiet=True)
        for (_, design), r in res.items():
            t = total.setdefault(design, dict(calls=0, lanes=0, live=0, steps=0, slots=0,
                                              device_ms=0.0, bound_ms=0.0,
                                              bound_by=r["bound_by"], err=0.0))
            t["calls"] += 1
            for k in ("lanes", "live", "steps", "slots", "device_ms", "bound_ms"):
                t[k] += r[k]
            t["err"] = max(t["err"], r["err"])
    variant = traversal8.launch_variant(calls[0][0])
    for design, t in total.items():
        t["util"] = t["steps"] / t["slots"] if t["slots"] else None
        emit(phase="pool_vs_k1", set=label, mode="pass", design=design, identical=True,
             rows=calls[0][0].shape[0], variant=variant, nvidia_smi=card, **t)
        POOL_VS_K1.append(dict(set=label, mode="pass", design=design, variant=variant,
                               **t))
    return total


def pool_sets(label, table, rays, amask, K1, K4, traversal8, mb, card, seed,
              natural="closest", timed=(), model=False):
    """pool_vs_k1 on one set of rays in the three modes (mixed: any-hit where
    `amask`), its natural mode first (shuffled there); records every
    reading in POOL_VS_K1. With `model` (a shared table) one more line: the
    utilization of K4's schedule model (schedule_probe.pool_model, at the
    kept threshold, on the resident warps of one shared-table block per SM)
    from the plain version's steps in the natural mode, beside K4's count.
    Returns pool_vs_k1's result."""
    modes = {"closest": {}, "any_hit": dict(any_hit=True), "mixed": dict(any_mask=amask)}
    modes = {natural: modes[natural], **modes}
    res = pool_vs_k1(label, table, rays, modes, K1, K4, traversal8, mb, card,
                     shuffle_seed=seed, timed=timed)
    if model:
        from cudatracerlib_tpu_torch.utils import schedule_probe as probe
        steps = traversal8.intersect_wide(table, rays, with_iters=True,
                                          **modes[natural])[1].cpu().numpy()
        dead = (~traversal8.live_lanes(rays)).cpu().numpy()
        warps = (torch.cuda.get_device_properties(table.device).multi_processor_count
                 * traversal8.SHARED_THREADS // 32)
        fetch_idle, rounds = traversal8.pool_schedule()
        slots, active = probe.pool_model(steps, dead, warps, fetch_idle, rounds)
        emit(phase="pool_model", set=label, mode=natural, warps=warps,
             fetch_idle=fetch_idle, fetch_rounds=rounds, model_slots=slots,
             model_util=active / slots, k4_util=res[natural, "k4"]["util"],
             k1_util=res[natural, "k1"]["util"])
    for (mode, design), r in res.items():
        POOL_VS_K1.append(dict(
            set=label, mode=mode, design=design, natural=mode == natural,
            variant=traversal8.launch_variant(table),
            **{k: v for k, v in r.items() if k not in ("ms", "plain_ms")}))
    return res


def veach_wavefronts(veach, table, K1, tracermod, Rays, B=POOL_RAYS):
    """tools/microbench_pool.py's four veach-mis wavefronts, built with the
    port: B camera rays of the first image rows (the image again and again
    past 512^2); bounce rays from
    the first hit plus 1e-3 along a random unit direction (numpy seed 7),
    tmin 0 and tmax 1e30 (0 where the camera ray missed); the bounce rays
    with POOL_CUT of the lanes at tmax 0 (live: they may descend the boxes
    around their origin), as the tool cuts them, and again at tmax -1
    (dead); shadow rays toward (0, 10, 0), tmin 0 and tmax the distance.
    Returns {name: (rays, natural mode)}."""
    dev = table.device
    pix = torch.arange(B, dtype=torch.int32, device=dev) % (VEACH_SIZE * VEACH_SIZE)
    cam = tracermod.gen_camera_rays(veach, pix, 0, 0, VEACH_SIZE, VEACH_SIZE)[0]
    cam = Rays(*(x.contiguous() for x in cam))
    h0 = K1(table, cam)
    valid = h0.tri >= 0
    p = cam.o + cam.d * torch.where(valid, h0.t, 1.0)[:, None]
    rng = np.random.default_rng(7)
    d = torch.from_numpy(rng.normal(size=(B, 3)).astype(np.float32)).to(dev)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    zero = torch.zeros(B, device=dev)
    bounce = Rays(o=(p + d * 1e-3).contiguous(), d=d.contiguous(), tmin=zero,
                  tmax=torch.where(valid, 1e30, 0.0).contiguous())
    cut = torch.from_numpy(rng.random(B) < POOL_CUT).to(dev)
    light = torch.tensor([0.0, 10.0, 0.0], device=dev)
    dl = light[None, :] - p
    dist = torch.linalg.norm(dl, dim=1)
    dl = dl / torch.clamp(dist, min=1e-6)[:, None]
    shadow = Rays(o=(p + dl * 1e-3).contiguous(), d=dl.contiguous(), tmin=zero,
                  tmax=torch.where(valid, dist, 0.0).contiguous())
    return {"camera": (cam, "closest"), "bounce": (bounce, "closest"),
            "bounce_cut_tmax0": (bounce._replace(
                tmax=torch.where(cut, 0.0, bounce.tmax).contiguous()), "closest"),
            "bounce_cut_dead": (bounce._replace(
                tmax=torch.where(cut, -1.0, bounce.tmax).contiguous()), "closest"),
            "shadow": (shadow, "any_hit")}


def pool_summary(card):
    """One line: the natural-mode set readings and the recorded passes of
    POOL_VS_K1, device ms and utilization by design, summed over them."""
    rows = [r for r in POOL_VS_K1 if r.get("natural", r["mode"] == "pass")]
    by_set = {}
    for r in rows:
        by_set.setdefault(r["set"], {})[r["design"]] = dict(
            device_ms=r["device_ms"], util=r["util"], slots=r["slots"])
    total = {}
    for r in rows:
        if r["design"] != "k1_group":
            total[r["design"]] = total.get(r["design"], 0.0) + r["device_ms"]
    emit(phase="pool_vs_k1_summary", nvidia_smi=card, by_set=by_set,
         device_ms_summed=total, sets=sorted(by_set))
    return total


def profile_pass(tr, scene_name, **extra):
    """Under --profile, one more pass of `tr` under torch.profiler: device
    time, busy share, event count, and the traversal kernels summed over
    their template instantiations. Without it, nothing."""
    if not PROFILE:
        return
    collect_cpu_sides()
    from torch.profiler import ProfilerActivity, profile as tprofile
    # device activity only: the CPU ops of a pass of 10^5 launches would
    # take minutes to sum, and only device events are counted
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.do_pass()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies, memsets): a CPU op's
    # device time would count its kernels a second time
    evs = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    total = sum(e.self_device_time_total for e in evs)
    top_k = sorted(evs, key=lambda e: -e.self_device_time_total)[:20]
    trav = {}
    for e in evs:
        m = KERNEL_RE.search(e.key)
        if m:
            k = trav.setdefault(m.group(0), dict(count=0, ms=0.0))
            k["count"] += e.count
            k["ms"] += e.self_device_time_total / 1e3
    trav_ms = sum(k["ms"] for k in trav.values())
    emit(phase="profile", scene=scene_name, wall_s=wall, device_ms=total / 1e3,
         device_busy=total / 1e6 / wall, device_events=sum(e.count for e in evs),
         traversal_kernels=trav, traversal_ms=trav_ms,
         traversal_share=trav_ms / max(total / 1e3, 1e-9),
         top=[dict(name=e.key[:70], count=e.count,
                   ms=e.self_device_time_total / 1e3) for e in top_k], **extra)


def plain_kw(kw):
    """A recorded K1 call's arguments for its plain version, which takes no
    design."""
    return {k: v for k, v in kw.items() if k != "_design"}


def record_k1(run, traversal8, Rays):
    """The K1 calls of `run()` as record_kernels records them: the list of
    (table, rays, kw)."""
    from cudatracerlib_tpu_torch.ops import traversal_tt
    return [(args[0], args[1], kw) for kind, args, kw
            in record_kernels(run, traversal8, traversal_tt, Rays) if kind == "K1"]


def k1_on_calls(label, calls, K1, traversal8, mb):
    """K1 against its plain version on each recorded call of one pass
    (check_variants: every field identical, the call timed, its device time
    and one plain run taken, its bound by trav_bound; a call on the global
    variant through k1_global_call), summed by mode.
    Emits one more line per mode; returns {mode: dict}."""
    out = {}
    for i, (table, rays, kw) in enumerate(calls):
        mode = traversal8.launch_mode(kw.get("any_hit", False), kw.get("any_mask"))
        B = rays.o.shape[0]
        live = int(live_mask(rays, kw, traversal8).sum())

        def run(variant, kw):
            h, st, fl = K1(table, rays, with_iters=True, **kw)
            return (*h, st, fl), st, fl

        def plain(kw):
            h, st, fl = traversal8.intersect_wide(table, rays, with_iters=True,
                                                  **plain_kw(kw))
            return (*h, st, fl), st, fl
        if traversal8.launch_variant(table) == "global":
            res = k1_global_call(label, table, rays, kw, traversal8, mb,
                                 k1_global_runner(K1, traversal8))
        else:
            res = check_variants(
                "K1", run, plain, {mode: kw}, (None,), timed=(mode,), plain_reps=1,
                bound=lambda steps, nb: trav_bound(nb, B, steps, mode == "mixed",
                                                   mb, traversal8, live,
                                                   "roots" in kw),
                pass_of=label, call=i, rays=B)[mode, None]
        r = out.setdefault(mode, dict(launches=0, rays=0, live_rays=0, err=0.0,
                                      ms=0.0, device_ms=0.0, plain_ms=0.0,
                                      steps=0, bound_ms=0.0))
        r["launches"] += 1
        r["rays"] += B
        r["live_rays"] += int((rays.tmax > rays.tmin).sum())
        r["err"] = max(r["err"], res["err"])
        for k in ("ms", "device_ms", "plain_ms", "steps"):
            r[k] += res[k]
        r["bound_ms"] += res["bound"][0]
    for mode, r in out.items():
        emit(phase="kernel_on_pass", kernel="K1", pass_of=label, mode=mode,
             identical=True, max_abs_err=r["err"], **{k: v for k, v in r.items()
                                                      if k != "err"})
    return out


def k1_edge_batches(table, rays, n_big, seed=0):
    """The batches that hold K1's global variant at its edges, made from
    `rays` (B of them, on the card), as [(name, rays, kw)]: every lane dead
    (tmax -1); one live lane in n_big (the rays repeated, every other lane
    dead); NaN tmin on a third of the lanes and NaN tmax on another third;
    tmin = tmax = 0; a 2-entry ring stack (it overflows); a 5-step cap (it
    caps) and a 0-step one; one ray; per-lane roots (row 0 or one of its
    node children) with half the lanes dead."""
    dev, B = rays.o.device, rays.o.shape[0]
    gen = np.random.default_rng(seed)
    tmn, tmx = rays.tmin, rays.tmax

    def with_t(tmin, tmax, r=rays):
        return type(rays)(r.o, r.d, tmin.contiguous(), tmax.contiguous())
    idx = torch.arange(n_big, device=dev) % B
    big = type(rays)(*(x[idx].contiguous() for x in rays))
    one_live = torch.full((n_big,), -1.0, device=dev)
    one_live[n_big // 3] = big.tmax[n_big // 3]
    third = torch.from_numpy(gen.integers(0, 3, B)).to(dev)
    nan = torch.full_like(tmn, float("nan"))
    zero = torch.zeros_like(tmn)
    links = table[0, 48:56].contiguous().view(torch.int32)
    starts = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        links[links >= 0]])
    roots = starts[torch.from_numpy(gen.integers(0, starts.numel(), B)).to(dev)]
    half = torch.from_numpy(gen.random(B) < 0.5).to(dev)
    return [
        ("all_dead", with_t(tmn, torch.full_like(tmx, -1.0)), {}),
        (f"one_live_in_{n_big}", with_t(big.tmin, one_live, big), {}),
        ("nan", with_t(torch.where(third == 1, nan, tmn),
                       torch.where(third == 2, nan, tmx)), {}),
        ("tmin_eq_tmax_0", with_t(zero, zero.clone()), {}),
        ("stack_overflow", rays, dict(stack_depth=2)),
        ("step_cap", rays, dict(max_iters=5)),
        ("no_steps", rays, dict(max_iters=0)),
        ("one_ray", type(rays)(*(x[:1].contiguous() for x in rays)), {}),
        ("roots_half_dead", with_t(tmn, torch.where(half, tmx, -1.0)),
         dict(roots=roots.contiguous())),
    ]


def k1_global_runner(K1, traversal8):
    """run_design(design, table, rays, kw, counts=False) -> (hit, steps,
    flags, work): K1's global variant in `design` (K1_GLOBAL_DESIGNS). With
    `counts` a group design runs on a new work area and returns it, to read
    its counters; else (timed runs) on the stream's, as the render paths
    do, and work is None."""
    from cudatracerlib_tpu_torch.utils import schedule_probe as probe

    def run_design(design, table, rays, kw, counts=False):
        kw = plain_kw(kw)
        if design == "thread":
            return (*K1(table, rays, with_iters=True, _variant="global",
                        _design="thread", **kw), None)
        work = traversal8.group_work(rays.o.shape[0], table.device) if counts else None
        if design == "group":
            res = K1(table, rays, with_iters=True, _variant="global",
                     _design="group", _scratch=work, **kw)
        else:
            res = probe.traverse8_group(table, rays, design, with_iters=True,
                                        _scratch=work, **kw)
        return (*res, work)
    return run_design


def left_counting(work, traversal8):
    """True when a group design launch, counting in set 0 of a new work
    area, left a counter of set 1 other than zero (the next launch on the
    stream counts there)."""
    return bool(work[traversal8.GROUP_WORK // 2:traversal8.GROUP_WORK].any())


def check_edge_batch(name, table, rays, kw, K1, traversal8, run_design,
                     pool_run=None, k1_designs=K1_GLOBAL_DESIGNS):
    """One edge batch (k1_edge_batches) in the three modes: each of K1's
    global designs in `k1_designs` (run_design(design, table, rays, kw_) ->
    (hit, steps, flags, work)) on every field against the plain version,
    the group design's live count against the plain model
    (traversal8.live_lanes), every ray classified and the counters left
    zero; with `pool_run` (pool_runner) K4 and the probe's K4 designs too,
    held as pool_vs_k1 holds them (check_pool_design); the overflow and cap
    batches must overflow and cap. Returns {design: max_abs_err}."""
    B = rays.o.shape[0]
    amask = torch.arange(B, device=rays.o.device) % 3 == 0
    want_live = int(traversal8.live_lanes(rays, kw.get("max_iters", traversal8.MAX_ITERS),
                                          kw.get("roots")).sum())
    errs = {}
    for mode, mkw in (("closest", {}), ("any_hit", dict(any_hit=True)),
                      ("mixed", dict(any_mask=amask))):
        ref = traversal8.intersect_wide(table, rays, with_iters=True, with_util=True,
                                        **kw, **mkw)
        flags = ref[2]
        if name == "stack_overflow" and not bool((flags & 2).any()):
            fail(f"the {name} batch did not overflow ({mode})")
        if name == "step_cap" and not bool((flags & 1).any()):
            fail(f"the {name} batch did not cap ({mode})")
        for design in k1_designs:
            h, st, fl, work = run_design(design, table, rays, dict(kw, **mkw),
                                         counts=True)
            ok, err = same((*h, st, fl), (*ref[0], ref[1], ref[2]))
            errs[design] = max(errs.get(design, 0.0), err)
            counts = None if work is None else [int(work[k])
                                                for k in traversal8.GROUP_COUNTERS]
            if not ok or (counts is not None and (counts[1] != want_live
                                                  or counts[3] != B
                                                  or left_counting(work, traversal8))):
                fail(f"K1 global ({design}) on the {name} edge batch ({mode}): "
                     f"identical {ok}, work counters {counts}, live {want_live}")
        for design in (POOL_DESIGNS[2:] if pool_run else ()):
            err = check_pool_design(f"the {name} edge batch ({mode})", design,
                                    pool_run(design, table, rays, dict(kw, **mkw),
                                             counts=True),
                                    ref, want_live, traversal8)[0]
            errs[design] = max(errs.get(design, 0.0), err)
    return errs


# every K1 global call k1_global_call held, for the lines at the end of
# the run (their chain floors need P1, measured in phase 8)
K1_GLOBAL_CALLS = []
# the per-thread design's launches in each run of a main path that takes it
# (the counts zeroed just before the run and read just after), for the
# kernel table's traverse8_kernel row
K1_THREAD_LAUNCHES = {}


def k1_global_call(label, table, rays, kw, traversal8, mb, run_design, ref=None,
                   plain_ms=None, nbytes=None, sweep=False):
    """One call of K1's global variant (table, rays, kw; kw's `_design` is
    the design its call site runs, "thread" without one) in the
    per-thread design and the group design, and with `sweep` in every
    design of K1_GLOBAL_DESIGNS, each against the plain version (`ref`,
    (t, tri, u, v, steps, flags), taken here when not given, with its time
    and the table bytes it fetched): every field identical, the group
    designs' live count equal to the plain model's and their counters left
    zero. Device times (CUDA
    events behind a sleeping kernel, median of 3): the two designs twice,
    in the order thread, group, group, thread, so that each has two
    readings; the rest once. Records the call's lanes, live lanes
    (tmin <= tmax), the mean, p99 and largest steps over the live lanes
    and the times in K1_GLOBAL_CALLS; returns check_variants's result for
    the call site's design, with the times by design."""
    mode = traversal8.launch_mode(kw.get("any_hit", False), kw.get("any_mask"))
    serving = kw.get("_design", "thread")
    kw = plain_kw(kw)
    B = rays.o.shape[0]
    live = live_mask(rays, kw, traversal8)
    if ref is None:
        collect_cpu_sides()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with RowFetches(lanes=live) as fetched:
            h, st, fl = traversal8.intersect_wide(table, rays, with_iters=True, **kw)
            torch.cuda.synchronize()
        plain_ms, nbytes, ref = (time.perf_counter() - t0) * 1e3, fetched.nbytes, \
            (*h, st, fl)
    steps_ref = ref[-2]
    want_live = int(live.sum())
    designs = K1_GLOBAL_DESIGNS if sweep else ("thread", "group")
    err = 0.0
    for design in designs:
        h, st, fl, work = run_design(design, table, rays, kw, counts=True)
        ok, e = same((*h, st, fl), ref)
        counts = None if work is None else [int(work[k])
                                            for k in traversal8.GROUP_COUNTERS]
        if not ok or (counts is not None and (counts[1] != want_live or counts[3] != B
                                              or left_counting(work, traversal8))):
            fail(f"K1 global ({design}) disagrees with its plain version on {label} "
                 f"({mode}): identical {ok}, work counters {counts}, live {want_live}")
        err = max(err, e)
    times = {}
    for design in ("thread", "group", "group", "thread", *designs[2:]):
        times.setdefault(design, []).append(
            device_ms(lambda: run_design(design, table, rays, kw), reps=3))
    steps = int(steps_ref.sum())
    bound = trav_bound(nbytes, B, steps, mode == "mixed", mb, traversal8, want_live,
                       "roots" in kw)
    if min(min(v) for v in times.values()) < bound[0]:
        fail(f"K1 global on {label} took {times} ms of device time, under its "
             f"bound {bound[0]} ms")
    ls = steps_ref[live].double()
    K1_GLOBAL_CALLS.append(dict(
        call_of=label, mode=mode, serving=serving, rows=table.shape[0], lanes=B,
        live=want_live,
        roots="roots" in kw, steps=steps,
        live_steps_mean=float(ls.mean()) if ls.numel() else None,
        live_steps_p99=float(torch.quantile(ls, 0.99)) if ls.numel() else None,
        live_steps_max=int(ls.max()) if ls.numel() else 0,
        device_ms=times, bound_ms=bound[0], plain_ms=plain_ms))
    med = {d: statistics.median(v) for d, v in times.items()}
    return dict(err=err, ms=cuda_median_ms(lambda: run_design(serving, table, rays, kw),
                                           reps=3),
                device_ms=med[serving], plain_ms=plain_ms, steps=steps, bound=bound,
                designs=med)


def chain_floor(p1, design, rows, steps, mb, blocks=None, arith_ns=0.0):
    """(floor ms, the P1 entry): `steps` dependent steps (a call's largest
    live step count), each the ns per dependent row of the P1 reading that
    `design` is held to (mb.floor_entry: a node step's read in its mode of
    read, one chain a warp, the lowest over the measured tables of at most
    `rows` rows) plus `arith_ns`, a step's arithmetic (mb.step_arith_ns:
    the smaller of a node and a leaf step at one warp an SM); (None, None)
    when P1 did not measure that mode."""
    e = mb.floor_entry(p1, design, rows, blocks)
    if e is None:
        return None, None
    return steps * (max(e["ns_per_dependent_row"], 0.0) + arith_ns) / 1e6, e


def floor_fields(times, floors):
    """{design: device ms over its chain floor} (the median of a design's
    readings) for the designs with a floor."""
    return {d: statistics.median(v) / floors[d][0] for d, v in times.items()
            if floors.get(d, (None,))[0]}


def k1_global_lines(p1, mb, arith_ns):
    """One line per call in K1_GLOBAL_CALLS, with each design's chain
    floor: the largest live steps times the ns per dependent row of P1's
    node-step reading in the design's mode of read (thread: one thread a
    row through L1/L2; group: 16 lanes a row), one chain a warp, the lowest
    over the measured tables of at most the call's rows, both from this
    run, each step with arith_ns[design] of arithmetic added (step_only's
    smallest reading at one warp an SM; for the group design, whose lanes
    split a step's tests, a lane's share of it); and floor_ratio, each
    design's device ms over its floor (under 1: the design beat the floor,
    PERF.md names it). Returns the lines."""
    lines = []
    for c in K1_GLOBAL_CALLS:
        floors = {d: chain_floor(p1, d, c["rows"], c["live_steps_max"], mb,
                                 arith_ns=arith_ns[d])
                  for d in ("thread", "group")}
        med = {d: statistics.median(v) for d, v in c["device_ms"].items()}
        line = dict(c, chain_floor_ms={d: f[0] for d, f in floors.items()},
                    ns_per_dependent_row={d: f[1] and f[1]["ns_per_dependent_row"]
                                          for d, f in floors.items()},
                    floor_rows={d: f[1] and f[1]["rows"] for d, f in floors.items()},
                    step_arith_ns=arith_ns,
                    floor_ratio=floor_fields(c["device_ms"], floors),
                    thread_over_group=med["thread"] / med["group"])
        emit(phase="k1_global_call", **line)
        lines.append(line)
    return lines


def timed_passes(tr, n):
    """n passes of `tr`, each timed to torch.cuda.synchronize (do_pass);
    returns (pass seconds, live rays per pass or None)."""
    collect_cpu_sides()
    secs, rays_n = [], []
    for _ in range(n):
        before = getattr(tr, "rays_traced_live", None)
        tr.do_pass()
        secs.append(tr.last_pass_seconds)
        if before is not None:
            rays_n.append(tr.rays_traced_live - before)
    return secs, rays_n or None


# card_vs_cpu's CPU halves: each renders in a child forked from this
# process (CpuSide), on one torch thread, while this process goes on with
# the card; at most CPU_SIDE_PROCS run at once, and a comparison is made
# when its child is collected (collect_cpu_sides: before a new child would
# pass the cap, where a caller needs the readings, before every clock
# reading of a timing (timed_passes, cuda_median_ms, device_ms, and the
# phases that read time.perf_counter), and before the kernel table). A
# child that runs past CPU_SIDE_SECONDS or fails fails the run.
CPU_SIDE_PROCS = 3
CPU_SIDE_SECONDS = 900
CPU_SIDES = []
# seconds this process spent in card_vs_cpu (the card's half) and waiting
# for its children (the card_vs_cpu_time line)
CARD_CPU_SECONDS = dict(card=0.0, wait=0.0)


class CpuSide:
    """fn() (numpy arrays, stacked) computed in a forked child that uses
    the CPU alone: the child inherits this process's state, so `fn` may be
    any closure, and it must not touch CUDA (the child of a process that
    holds a CUDA context cannot use it). The result comes back through a
    temporary .npy file."""

    def __init__(self, fn):
        import multiprocessing
        import tempfile
        fd, self.path = tempfile.mkstemp(prefix="cpu_side_", suffix=".npy")
        os.close(fd)
        self.proc = multiprocessing.get_context("fork").Process(
            target=CpuSide._run, args=(fn, self.path), daemon=True)
        self.proc.start()

    @staticmethod
    def _run(fn, path):
        torch.set_num_threads(1)
        np.save(path, fn())

    def result(self, what):
        self.proc.join(CPU_SIDE_SECONDS)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join()
            fail(f"the CPU half of {what} ran past {CPU_SIDE_SECONDS} s")
        try:
            if self.proc.exitcode != 0:
                fail(f"the CPU half of {what} failed (exit code {self.proc.exitcode})")
            return np.load(self.path)
        finally:
            os.remove(self.path)


def card_vs_cpu(name, make, scene_fn, size, passes, dev, limit=CARD_CPU_LIMIT,
                wait=False, **extra):
    """The same tracer on the card and on the CPU, pass by pass: the mean
    relative error of the cumulative image after each pass, every image
    finite and not black; fails over `limit`. The CPU half renders in a
    forked child (CpuSide) while the card renders; the comparison is made
    when collect_cpu_sides collects it, at once with `wait`, which returns
    the readings."""
    def cpu_half():
        tr = make(scene_fn(size, size).build("cpu"))
        return np.stack([tr.render(1).numpy() for _ in range(passes)])
    collect_cpu_sides(keep=CPU_SIDE_PROCS - 1)
    t0 = time.perf_counter()
    job = CpuSide(cpu_half)
    tr = make(scene_fn(size, size).build(dev))
    card = [tr.render(1).cpu().numpy() for _ in range(passes)]
    del tr
    CARD_CPU_SECONDS["card"] += time.perf_counter() - t0
    CPU_SIDES.append(dict(name=name, size=size, passes=passes, limit=limit,
                          extra=extra, card=card, job=job))
    if wait:
        return collect_cpu_sides()[-1]


def collect_cpu_sides(keep=0):
    """Collect card_vs_cpu's children, oldest first, until `keep` are
    left running, and make each one's comparison (one card_vs_cpu line);
    returns the readings of those collected."""
    done = []
    while len(CPU_SIDES) > keep:
        c = CPU_SIDES.pop(0)
        t0 = time.perf_counter()
        imgs_cpu = c["job"].result(f"{c['name']} card-vs-CPU")
        CARD_CPU_SECONDS["wait"] += time.perf_counter() - t0
        rels = []
        for img_card, img_cpu in zip(c["card"], imgs_cpu):
            for img in (img_card, img_cpu):
                if not np.isfinite(img).all() or not img.mean() > 0.0:
                    fail(f"the {c['name']} card-vs-CPU image is not finite and non-black")
            rels.append(float(np.abs(img_card - img_cpu).mean()
                              / max(img_cpu.mean(), 1e-9)))
        # the last image's pixels off by more than 1e-4 of their own value
        pix = (np.abs(img_card - img_cpu).max(-1)
               / np.maximum(np.abs(img_cpu).max(-1), 1e-6))
        emit(phase="card_vs_cpu", tracer=c["name"], size=c["size"], passes=c["passes"],
             rel_err=max(rels), rel_err_by_pass=rels, limit=c["limit"],
             pixels_off_1e4=int((pix > 1e-4).sum()), max_pixel_rel=float(pix.max()),
             **c["extra"])
        if not max(rels) < c["limit"]:
            fail(f"the {c['name']} card image differs from the CPU image: {rels}")
        done.append(rels)
    return done


def golden_rel(img, name):
    """tests/test_goldens_family.py's rule: the mean relative error against
    tests/goldens/<name>."""
    ref = np.load(os.path.join(HERE, "tests", "goldens", name))["img"]
    return float(np.abs(img - ref).mean() / max(ref.mean(), 1e-6))


def light_path_phases(dev, K1, K4, zero_counts, plain_calls, k1_by_variant,
                      primmod, bdptmod, ltmod, filmmod, example_scenes,
                      traversal8, mb):
    """4d. the PrimTracer headline (BASELINE config 1): Cornell 512^2,
    shading normals, one warm-up pass, then PRIM_PASSES timed passes, one K1
    launch (shared) per pass; one more pass profiled and one recorded, its
    K1 call held to the plain version and timed; the 64^2 card film within
    CARD_CPU_LIMIT of the CPU film. 4e. the BDPT headline (BASELINE config 4): the glass Cornell box
    256^2, depth 6, a warm-up pass, then LP_PASSES timed passes, its K1
    launches per pass by mode against the count worked out from the code
    (NUM_LIGHT_V closest-hit light-walk and any-hit splat traversals, then
    per camera bounce one closest-hit, one any-hit NEE and NUM_LIGHT_V
    any-hit connection traversals), one pass profiled; K1 against its plain
    version on every traversal of one more pass, recorded; then the light
    tracer likewise (1 + 2 * depth launches per pass). 4f. the card's
    images: BDPT (Cornell 32^2, depth 4, 6 passes) and the light tracer
    (depth 4, 12 passes) against their goldens (mean relative error < 0.02),
    and both on the glass Cornell box 32^2, depth 6, CARD_CPU_PASSES
    passes, against the same renders on the CPU (card_vs_cpu). Returns the
    K1 records of one PrimTracer, one BDPT and one light-tracer pass."""
    from cudatracerlib_tpu_torch.ops.traversal import Rays

    def counts():
        return dict(K1=K1.launches, K1_by_variant=dict(K1.launches_by_variant),
                    K1_by_design=dict(K1.launches_by_design),
                    K1_by_mode=dict(K1.launches_by_mode), K4=K4.launches,
                    plain=plain_calls())

    def check_image(img, what):
        if not np.isfinite(img).all() or not img.mean() > 0.0:
            fail(f"the {what} image is not finite and non-black")

    def record(tr, label):
        calls = record_k1(tr.do_pass, traversal8, Rays)
        return dict(launches_per_pass=len(calls),
                    by_mode=k1_on_calls(label, calls, K1, traversal8, mb))

    out = {}
    # 4d. PrimTracer
    scene = example_scenes.cornell_box(512, 512).build(dev)
    tr = primmod.PrimTracer(scene, 512, 512, draw_mode=primmod.D_NORMAL_SHADE)
    tr.do_pass()
    torch.cuda.synchronize()
    zero_counts()
    it0, rw0 = int(tr._iters_dev), int(tr._rows_dev)
    secs, _ = timed_passes(tr, PRIM_PASSES)
    c = counts()
    k1_by_variant["prim"] = c["K1_by_variant"]
    img = filmmod.develop(tr.film).cpu().numpy()
    emit(phase="headline", scene="cornell_box", tracer="PrimTracer",
         draw_mode="D_NORMAL_SHADE", size=512, passes=PRIM_PASSES,
         seconds_per_pass=statistics.median(secs), pass_seconds=secs,
         mrays_per_s=512 * 512 * PRIM_PASSES / sum(secs) / 1e6,
         steps=int(tr._iters_dev) - it0, rows=int(tr._rows_dev) - rw0,
         launches=c, launches_per_pass=c["K1"] / PRIM_PASSES,
         mean_value=float(img.mean()))
    check_image(img, "PrimTracer")
    if (c["K1"] != PRIM_PASSES or c["K1_by_variant"]["shared"] != c["K1"]
            or c["K4"] or c["plain"]):
        fail(f"the PrimTracer run took the wrong kernels: {c}")
    profile_pass(tr, "cornell_box", tracer="PrimTracer")
    out["prim"] = record(tr, "prim_cornell_512")
    card_vs_cpu("PrimTracer", lambda s: primmod.PrimTracer(
        s, 64, 64, draw_mode=primmod.D_NORMAL_SHADE), example_scenes.cornell_box,
        64, 1, dev)
    del tr, scene

    # 4e. BDPT and the light tracer on the glass Cornell box
    scene = example_scenes.cornell_glass(256, 256).build(dev)
    nv = bdptmod.NUM_LIGHT_V
    for name, make, want in (
            ("bdpt", lambda: bdptmod.BDPT(scene, 256, 256, max_depth=LP_DEPTH),
             dict(closest=nv + LP_DEPTH, any_hit=nv + LP_DEPTH * (1 + nv), mixed=0)),
            ("lt", lambda: ltmod.LightTracer(scene, 256, 256, max_depth=LP_DEPTH),
             dict(closest=LP_DEPTH, any_hit=1 + LP_DEPTH, mixed=0))):
        tr = make()
        tr.do_pass()
        torch.cuda.synchronize()
        zero_counts()
        secs, rays_n = timed_passes(tr, LP_PASSES)
        c = counts()
        k1_by_variant[name] = c["K1_by_variant"]
        img = filmmod.develop(tr.film).cpu().numpy()
        per_pass = {m: n / LP_PASSES for m, n in c["K1_by_mode"].items()}
        emit(phase="headline", scene="cornell_glass", tracer=type(tr).__name__,
             size=256, max_depth=LP_DEPTH, passes=LP_PASSES,
             seconds_per_pass=statistics.median(secs), pass_seconds=secs,
             mpaths_per_s=256 * 256 * LP_PASSES / sum(secs) / 1e6,
             spp_per_s=LP_PASSES / sum(secs), live_rays=int(sum(rays_n)),
             mrays_per_s=sum(rays_n) / sum(secs) / 1e6, launches=c,
             launches_per_pass_by_mode=per_pass, expected_per_pass_by_mode=want,
             mean_radiance=float(img.mean()))
        check_image(img, name)
        if (per_pass != {m: float(n) for m, n in want.items()}
                or c["K1_by_variant"]["shared"] != c["K1"] or c["K4"] or c["plain"]):
            fail(f"the {name} run took the wrong kernels: {c}, expected {want} per pass")
        profile_pass(tr, "cornell_glass", tracer=type(tr).__name__)
        out[name] = record(tr, f"{name}_cornell_glass_256")
        del tr
    del scene

    # 4f. the card's images against the goldens and the CPU
    for name, make, passes, golden in (
            ("bdpt", lambda s: bdptmod.BDPT(s, 32, 32, max_depth=4), 6,
             "cornell_32_bdpt.npz"),
            ("lt", lambda s: ltmod.LightTracer(s, 32, 32, max_depth=4), 12,
             "cornell_32_lt.npz")):
        img = make(example_scenes.cornell_box(32, 32).build(dev)).render(passes)
        img = img.cpu().numpy()
        rel = golden_rel(img, golden)
        emit(phase="golden", tracer=name, size=32, max_depth=4, passes=passes,
             rel_err=rel, limit=0.02)
        check_image(img, f"{name} golden")
        if not rel < 0.02:
            fail(f"{name} golden drift {rel}")
    for name, cls in (("BDPT", bdptmod.BDPT), ("LightTracer", ltmod.LightTracer)):
        card_vs_cpu(name, lambda s: cls(s, 32, 32, max_depth=LP_DEPTH),
                    example_scenes.cornell_glass, 32, CARD_CPU_PASSES, dev,
                    scene="cornell_glass", max_depth=LP_DEPTH)
    return out


def ppm_flips(dev, ppmmod, tracermod, traversal8, example_scenes, size=32):
    """Where PPM's card and CPU renders part, on one pass at `size`^2:
    the photon walk's valid masks and rows (a row off by more than 1e-3
    took another path), the cell ids of the surface grid and of the ball
    grid, the camera rays and their hits, and the pass's image (its mean
    relative error and its pixels off by more than 1e-4 of their own
    value). Emits one line."""
    res = {}
    for d in (dev, torch.device("cpu")):
        sc = example_scenes.fog_cornell(size, size).build(d)
        tr = ppmmod.PPMTracer(sc, size, size, max_depth=MEDIA_DEPTH)
        (rows, valid), _ = ppmmod._photon_walk(sc, tr.n_photons, 0, 0x9907,
                                               MEDIA_DEPTH, tr.active_types,
                                               store_medium=True)
        r = torch.tensor(tr.radius, dtype=torch.float32, device=d)
        sg = ppmmod._build_surface_grid(rows, valid, sc.world_lo, sc.world_hi, 2.0 * r)
        vg = ppmmod._build_vol_grid_ball(rows, valid, r, sc.world_lo, sc.world_hi)
        pix = torch.arange(size * size, dtype=torch.int32, device=d)
        rays = tracermod.gen_camera_rays(sc, pix, 0, 0, size, size)[0]
        hit = traversal8.intersect_scene(sc.geom, rays)
        res[d.type] = [x.cpu() for x in (rows, valid, sg.cell_ids, vg.cell_ids,
                                         rays.d, hit.t, tr.render(1))]
    (rc, vc, sc_, bc, dc, tc, ic), (rh, vh, sh, bh, dh, th, ih) = res["cuda"], res["cpu"]
    both = vc & vh
    diff = (rc - rh).abs().amax(-1)
    pix = (ic - ih).abs().amax(-1) / ih.abs().amax(-1).clamp_min(1e-6)
    hits = (tc < 1e29) & (th < 1e29)
    emit(phase="ppm_flips", size=size, photon_rows=int(rc.shape[0]),
         valid_rows=int(vh.sum()), valid_differ=int((vc != vh).sum()),
         rows_off_1e5=int((diff[both] > 1e-5).sum()),
         rows_off_1e3=int((diff[both] > 1e-3).sum()),
         max_row_diff=float(diff[both].max()),
         surface_cells_differ=int((sc_ != sh).sum()),
         ball_cells_differ=int((bc != bh).sum()),
         camera_dir_max_diff=float((dc - dh).abs().max()),
         hit_t_max_diff=float((tc - th)[hits].abs().max()),
         image_rel_err=float((ic - ih).abs().mean() / ih.abs().mean()),
         pixels_off_1e4=int((pix > 1e-4).sum()), pixels=int(pix.numel()),
         max_pixel_rel=float(pix.max()))


def media_phases(dev, K1, K4, zero_counts, plain_calls, k1_by_variant, pathmod,
                 ppmmod, tracermod, filmmod, example_scenes, traversal8, mb):
    """4g. the PPM golden on the card: Cornell 32^2, depth 4, radius 0.08,
    6 passes against tests/goldens/cornell_32_ppm.npz (mean relative error
    < 0.02, the JAX test's limit). 4h. the config-5 headlines on
    fog_cornell 256^2, depth 6: PPM (beamgrid, 65,536 photons) after a
    warm-up pass, PPM_PASSES timed passes, with K1's launches per pass by
    mode held to the code's count (2 * depth closest-hit: the photon walk
    and the camera walk) and its counters (photons stored, ball-grid rows
    and bytes, DDA steps per depth, host reads of the loops' exit tests,
    live rays); the volumetric path tracer (chunks of 65,536 lanes, one per
    pass) after a warm-up, VPT_PASSES timed passes, K1's launches per pass
    by mode held to depth closest-hit and depth any-hit (the shadow rays
    are traced within each bounce); one pass of each profiled, and one pass
    of each recorded and held, traversal by traversal, to K1's plain
    version. 4i. where one PPM pass on the card and on the CPU part
    (ppm_flips); PPM and the volumetric path tracer on fog_cornell 32^2,
    depth 6, CARD_CPU_PASSES passes, against the CPU (PPM_CARD_CPU_LIMIT,
    CARD_CPU_LIMIT). Returns the K1 records of one PPM and one
    volumetric path-tracing pass."""
    from cudatracerlib_tpu_torch.models import medium as mediummod
    from cudatracerlib_tpu_torch.ops.traversal import Rays

    def counts():
        return dict(K1=K1.launches, K1_by_variant=dict(K1.launches_by_variant),
                    K1_by_design=dict(K1.launches_by_design),
                    K1_by_mode=dict(K1.launches_by_mode), K4=K4.launches,
                    plain=plain_calls())

    def check_image(img, what):
        if not np.isfinite(img).all() or not img.mean() > 0.0:
            fail(f"the {what} image is not finite and non-black")

    def check_counts(c, passes, want, what):
        per_pass = {m: n / passes for m, n in c["K1_by_mode"].items()}
        if (per_pass != {m: float(n) for m, n in want.items()}
                or c["K1_by_variant"]["shared"] != c["K1"] or c["K4"] or c["plain"]):
            fail(f"the {what} run took the wrong kernels: {c}, expected {want} per pass")
        return per_pass

    def record(tr, label):
        calls = record_k1(tr.do_pass, traversal8, Rays)
        return dict(launches_per_pass=len(calls),
                    by_mode=k1_on_calls(label, calls, K1, traversal8, mb))

    out = {}
    # 4g. the PPM golden
    zero_counts()
    img = ppmmod.PPMTracer(example_scenes.cornell_box(32, 32).build(dev), 32, 32,
                           max_depth=4, initial_radius=0.08).render(6).cpu().numpy()
    rel = golden_rel(img, "cornell_32_ppm.npz")
    c = counts()
    emit(phase="golden", tracer="ppm", size=32, max_depth=4, passes=6, rel_err=rel,
         limit=0.02, launches=c)
    check_image(img, "PPM golden")
    if not rel < 0.02:
        fail(f"ppm golden drift {rel}")
    check_counts(c, 6, dict(closest=8, any_hit=0, mixed=0), "PPM golden")

    # 4h. the headlines on fog_cornell 256^2
    size = 256
    scene = example_scenes.fog_cornell(size, size).build(dev)
    tr = ppmmod.PPMTracer(scene, size, size, max_depth=MEDIA_DEPTH)
    tr.do_pass()
    torch.cuda.synchronize()
    zero_counts()
    stored0, rays0 = tr.photons_stored, tr.rays_traced_live
    secs, reads, steps = [], [], []
    for _ in range(PPM_PASSES):
        tr.do_pass()
        secs.append(tr.last_pass_seconds)
        reads.append(dict(tr.last_pass_host_reads))
        steps.append(list(tr.last_pass_dda_steps))
    c = counts()
    k1_by_variant["ppm"] = c["K1_by_variant"]
    stored = [(a - b) / PPM_PASSES for a, b in zip(tr.photons_stored, stored0)]
    live = tr.rays_traced_live - rays0
    img = tr.develop().cpu().numpy()
    per_pass = check_counts(c, PPM_PASSES, dict(closest=2 * MEDIA_DEPTH, any_hit=0,
                                                mixed=0), "PPM")
    emit(phase="headline", scene="fog_cornell", tracer="PPMTracer",
         vol_estimator=tr.vol_est, size=size, max_depth=MEDIA_DEPTH,
         photons=tr.n_photons, passes=PPM_PASSES,
         seconds_per_pass=statistics.median(secs), pass_seconds=secs,
         mphotons_per_s=tr.n_photons * PPM_PASSES / sum(secs) / 1e6,
         spp_per_s=PPM_PASSES / sum(secs), live_rays=live,
         mrays_per_s=live / sum(secs) / 1e6,
         photons_stored_per_pass=dict(surface=stored[0], medium=stored[1]),
         ball_grid=tr.last_vol_grid, dda_steps_per_depth=steps,
         host_reads_per_pass=reads, radius=tr.radius, launches=c,
         launches_per_pass_by_mode=per_pass, status=tr.status(),
         mean_radiance=float(img.mean()))
    check_image(img, "PPM fog")
    profile_pass(tr, "fog_cornell", tracer="PPMTracer")
    out["ppm"] = record(tr, f"ppm_fog_cornell_{size}")
    del tr

    tr = pathmod.PathTracer(scene, size, size, max_depth=MEDIA_DEPTH, chunk_size=65536)
    tr.do_pass()
    torch.cuda.synchronize()
    zero_counts()
    reads0 = mediummod.host_reads
    secs, rays_n = timed_passes(tr, VPT_PASSES)
    c = counts()
    k1_by_variant["vol_pt"] = c["K1_by_variant"]
    img = filmmod.develop(tr.film).cpu().numpy()
    chunks = tr._n_chunks
    per_pass = check_counts(c, VPT_PASSES, dict(
        closest=MEDIA_DEPTH * chunks, any_hit=MEDIA_DEPTH * chunks, mixed=0),
        "volumetric PT")
    capped, overflowed = (int(x) for x in tr._ovf_dev.tolist())
    emit(phase="headline", scene="fog_cornell", tracer="PathTracer", media=True,
         size=size, max_depth=MEDIA_DEPTH, chunk_size=65536, passes=VPT_PASSES,
         seconds_per_pass=statistics.median(secs), pass_seconds=secs,
         live_rays=int(sum(rays_n)), mrays_per_s=sum(rays_n) / sum(secs) / 1e6,
         spp_per_s=VPT_PASSES / sum(secs),
         host_reads_per_pass=(mediummod.host_reads - reads0) / VPT_PASSES,
         launches=c, launches_per_pass_by_mode=per_pass, capped=capped,
         overflowed=overflowed, mean_radiance=float(img.mean()))
    check_image(img, "volumetric PT fog")
    if capped or overflowed:
        fail(f"fog: capped {capped} / overflowed {overflowed} rays")
    profile_pass(tr, "fog_cornell", tracer="PathTracer")
    out["vol_pt"] = record(tr, f"vol_pt_fog_cornell_{size}")
    del tr, scene

    # 4i. the card's fog renders against the CPU's, and where PPM's part
    ppm_flips(dev, ppmmod, tracermod, traversal8, example_scenes)
    card_vs_cpu("PPMTracer", lambda s: ppmmod.PPMTracer(s, 32, 32, max_depth=MEDIA_DEPTH),
                example_scenes.fog_cornell, 32, CARD_CPU_PASSES, dev,
                limit=PPM_CARD_CPU_LIMIT, scene="fog_cornell", max_depth=MEDIA_DEPTH)
    card_vs_cpu("PathTracer", lambda s: pathmod.PathTracer(s, 32, 32,
                                                           max_depth=MEDIA_DEPTH),
                example_scenes.fog_cornell, 32, CARD_CPU_PASSES, dev,
                scene="fog_cornell", max_depth=MEDIA_DEPTH)
    return out


def sensor_scene(host, schema, sensors, shapes, tf, sensor_type, size=32, **kw):
    """tests/test_lighttracer.py's sensor scene: a floor under a small area
    light, seen by a sensor of `sensor_type`; a DynamicScene, built later."""
    sc = host.DynamicScene()
    white = sc.add_material(host.MaterialSpec(reflectance=(0.7, 0.7, 0.7)))
    black = sc.add_material(host.MaterialSpec(reflectance=(0, 0, 0)))
    sc.create_node(shapes.rectangle(), white,
                   tf.compose(tf.translate([0, -1, 0]), tf.rotate_deg([1, 0, 0], -90),
                              tf.scale(3)))
    sc.create_node(shapes.rectangle(), black,
                   tf.compose(tf.translate([0, 1.5, 0]), tf.rotate_deg([1, 0, 0], 90),
                              tf.scale(0.5)), emission=(8.0, 8.0, 8.0))
    sc.set_sensor(sensors.make_sensor(sensor_type, tf.look_at([0, 0.6, -2.5], [0, -0.6, 0]),
                                      fov_x_deg=50, film_w=size, film_h=size, **kw))
    return sc


def vcm_phases(dev, K1, K4, zero_counts, plain_calls, k1_by_variant, vcmmod,
               filmmod, example_scenes, traversal8, mb):
    """4j. the VCM golden on the card: Cornell 32^2, depth 4, 4 passes
    against tests/goldens/cornell_32_vcm.npz (mean relative error < 0.02),
    K1's launches per pass by mode held to the code's count (NUM_LIGHT_V +
    depth closest-hit, NUM_LIGHT_V + depth * (1 + NUM_LIGHT_V) any-hit, as
    BDPT's). 4k. the VCM headline on the glass Cornell box 256^2, depth 6,
    a warm-up pass, then LP_PASSES timed passes: s/pass, Mpaths/s, spp/s,
    live rays, valid photon rows per pass, the photon grid's cells, K1's
    launches per pass by mode (11 + 41); one pass profiled, one recorded
    and held, traversal by traversal, to K1's plain version. 4l. VCM on the
    glass Cornell box 32^2, depth 6, CARD_CPU_PASSES passes, against the
    CPU (VCM_CARD_CPU_LIMIT). Returns the K1 record of one pass."""
    from cudatracerlib_tpu_torch.ops import hashgrid
    from cudatracerlib_tpu_torch.ops.traversal import Rays
    nv = vcmmod.NUM_LIGHT_V

    def counts():
        return dict(K1=K1.launches, K1_by_variant=dict(K1.launches_by_variant),
                    K1_by_design=dict(K1.launches_by_design),
                    K1_by_mode=dict(K1.launches_by_mode), K4=K4.launches,
                    plain=plain_calls())

    def check(c, passes, depth, what):
        want = dict(closest=nv + depth, any_hit=nv + depth * (1 + nv), mixed=0)
        per_pass = {m: n / passes for m, n in c["K1_by_mode"].items()}
        if (per_pass != {m: float(n) for m, n in want.items()}
                or c["K1_by_variant"]["shared"] != c["K1"] or c["K4"] or c["plain"]):
            fail(f"the {what} run took the wrong kernels: {c}, expected {want} per pass")
        return per_pass, want

    def check_image(img, what):
        if not np.isfinite(img).all() or not img.mean() > 0.0:
            fail(f"the {what} image is not finite and non-black")

    # 4j. the golden
    zero_counts()
    img = vcmmod.VCM(example_scenes.cornell_box(32, 32).build(dev), 32, 32,
                     max_depth=4).render(4).cpu().numpy()
    rel = golden_rel(img, "cornell_32_vcm.npz")
    c = counts()
    emit(phase="golden", tracer="vcm", size=32, max_depth=4, passes=4, rel_err=rel,
         limit=0.02, launches=c)
    check_image(img, "VCM golden")
    if not rel < 0.02:
        fail(f"vcm golden drift {rel}")
    check(c, 4, 4, "VCM golden")

    # 4k. the headline
    size = 256
    scene = example_scenes.cornell_glass(size, size).build(dev)
    tr = vcmmod.VCM(scene, size, size, max_depth=LP_DEPTH)
    tr.do_pass()
    torch.cuda.synchronize()
    zero_counts()
    stored0 = tr.photons_stored
    secs, rays_n = timed_passes(tr, LP_PASSES)
    c = counts()
    k1_by_variant["vcm"] = c["K1_by_variant"]
    per_pass, want = check(c, LP_PASSES, LP_DEPTH, "VCM")
    g = tr.last_grid
    cells = g.cell_ids[g.cell_ids != hashgrid.INT32_MAX]
    img = filmmod.develop(tr.film).cpu().numpy()
    emit(phase="headline", scene="cornell_glass", tracer="VCM", size=size,
         max_depth=LP_DEPTH, passes=LP_PASSES,
         seconds_per_pass=statistics.median(secs), pass_seconds=secs,
         mpaths_per_s=size * size * LP_PASSES / sum(secs) / 1e6,
         spp_per_s=LP_PASSES / sum(secs), live_rays=int(sum(rays_n)),
         mrays_per_s=sum(rays_n) / sum(secs) / 1e6,
         photon_rows_per_pass=nv * size * size,
         valid_photon_rows_per_pass=(tr.photons_stored - stored0) / LP_PASSES,
         radius=tr.radius, grid_dims=[int(x) for x in g.dims.tolist()],
         grid_cells=int(torch.prod(g.dims.long())),
         grid_cells_occupied=int(torch.unique(cells).numel()),
         launches=c, launches_per_pass_by_mode=per_pass,
         expected_per_pass_by_mode=want, mean_radiance=float(img.mean()))
    check_image(img, "VCM")
    profile_pass(tr, "cornell_glass", tracer="VCM")
    calls = record_k1(tr.do_pass, traversal8, Rays)
    out = dict(launches_per_pass=len(calls),
               by_mode=k1_on_calls(f"vcm_cornell_glass_{size}", calls, K1,
                                   traversal8, mb))
    del tr, scene, calls

    # 4l. the card against the CPU
    card_vs_cpu("VCM", lambda s: vcmmod.VCM(s, 32, 32, max_depth=LP_DEPTH),
                example_scenes.cornell_glass, 32, CARD_CPU_PASSES, dev,
                limit=VCM_CARD_CPU_LIMIT, scene="cornell_glass", max_depth=LP_DEPTH)
    return out


def sensor_phases(dev, K1, zero_counts, plain_calls, pathmod, ltmod, wfmod,
                  example_scenes):
    """4m. the light tracer and the path tracer on the sensor scene at
    32^2, depth 3, under the spherical, orthographic, telecentric and
    thin-lens sensors, each against the CPU pass by pass (CARD_CPU_LIMIT),
    through K1 alone. 4n. WavefrontPT on Cornell 64^2, depth 4, 2 passes,
    with WF_SMALL_LANES lanes (fewer than the paths, not a divisor of them)
    against the chunked PathTracer on the card: the images within
    tests/test_torch_wavefront.py's rtol 1e-5 / atol 1e-7, the live rays
    equal, host reads = iterations + 1."""
    from cudatracerlib_tpu_torch.scene import host, schema, sensors, shapes
    from cudatracerlib_tpu_torch.utils import transforms as tf
    kinds = (("spherical", schema.SENSOR_SPHERICAL, {}),
             ("orthographic", schema.SENSOR_ORTHOGRAPHIC, dict(ortho_scale=(2.0, 2.0))),
             ("telecentric", schema.SENSOR_TELECENTRIC,
              dict(ortho_scale=(2.0, 2.0), aperture_radius=0.05, focus_distance=2.5)),
             ("thinlens", schema.SENSOR_THINLENS,
              dict(aperture_radius=0.05, focus_distance=2.5)))
    for name, st, kw in kinds:
        def scene_fn(w, h, st=st, kw=kw):
            return sensor_scene(host, schema, sensors, shapes, tf, st, w, **kw)
        for tname, cls in (("LightTracer", ltmod.LightTracer),
                           ("PathTracer", pathmod.PathTracer)):
            zero_counts()
            card_vs_cpu(tname, lambda s: cls(s, 32, 32, max_depth=3), scene_fn, 32,
                        SENSOR_PASSES, dev, sensor=name, max_depth=3)
            if K1.launches <= 0 or plain_calls():
                fail(f"the {tname} run under the {name} sensor took the wrong kernels")

    # 4n. the wavefront against the chunked path tracer on the card
    scene = example_scenes.cornell_box(64, 64).build(dev)
    pt = pathmod.PathTracer(scene, 64, 64, max_depth=4, chunk_size=64 * 64)
    wf = wfmod.WavefrontPT(scene, 64, 64, max_depth=4, lanes=WF_SMALL_LANES)
    i1, i2 = pt.render(2).cpu().numpy(), wf.render(2).cpu().numpy()
    err = float(np.abs(i2 - i1).max())
    close = bool(np.allclose(i2, i1, rtol=1e-5, atol=1e-7))
    emit(phase="wavefront_vs_pt", scene="cornell_box", size=64, max_depth=4,
         lanes=WF_SMALL_LANES, passes=2, max_abs_err=err, within_rtol_1e5_atol_1e7=close,
         identical=bool(np.array_equal(i1, i2)), live_rays_pt=pt.rays_traced_live,
         live_rays_wf=wf.rays_traced_live, iters=wf.last_pass_iters,
         host_reads=wf.last_pass_host_reads)
    if not close or pt.rays_traced_live != wf.rays_traced_live:
        fail("the wavefront PT on the card disagrees with the chunked PT")
    if wf.last_pass_host_reads != wf.last_pass_iters + 1:
        fail("the wavefront loop read more than its exit tests")


def fast_cornell_phase(dev, K1, K4, zero_counts, plain_calls, k1_by_variant,
                       fastmod, filmmod, example_scenes, traversal8, mb):
    """4o. the FastTracer on Cornell 512^2 in both modes: a warm-up pass,
    then FAST_PASSES timed passes, one K1 launch (shared) per pass; Mrays/s;
    one more pass of each recorded and its K1 call held to the plain
    version. Returns {"fast": {mode: K1 record}}."""
    from cudatracerlib_tpu_torch.ops.traversal import Rays
    scene = example_scenes.cornell_box(512, 512).build(dev)
    out = {}
    k1_by_variant["fast"] = dict.fromkeys(K1.launches_by_variant, 0)
    for mode, mname in ((fastmod.MODE_DEPTH, "depth"), (fastmod.MODE_VISIBILITY,
                                                         "visibility")):
        tr = fastmod.FastTracer(scene, 512, 512, mode=mode)
        tr.do_pass()
        torch.cuda.synchronize()
        zero_counts()
        secs, _ = timed_passes(tr, FAST_PASSES)
        c = dict(K1=K1.launches, K1_by_variant=dict(K1.launches_by_variant),
                 K1_by_design=dict(K1.launches_by_design),
                 K4=K4.launches, plain=plain_calls())
        for v, n in c["K1_by_variant"].items():
            k1_by_variant["fast"][v] += n
        img = filmmod.develop(tr.film).cpu().numpy()
        emit(phase="headline", scene="cornell_box", tracer="FastTracer", mode=mname,
             size=512, passes=FAST_PASSES, seconds_per_pass=statistics.median(secs),
             pass_seconds=secs, mrays_per_s=512 * 512 * FAST_PASSES / sum(secs) / 1e6,
             launches=c, mean_value=float(img.mean()))
        if not np.isfinite(img).all() or not img.mean() > 0.0:
            fail(f"the FastTracer {mname} image is not finite and non-black")
        if (c["K1"] != FAST_PASSES or c["K1_by_variant"]["shared"] != c["K1"]
                or c["K4"] or c["plain"]):
            fail(f"the FastTracer run took the wrong kernels: {c}")
        calls = record_k1(tr.do_pass, traversal8, Rays)
        out[mname] = dict(launches_per_pass=len(calls), by_mode=k1_on_calls(
            f"fast_{mname}_cornell_512", calls, K1, traversal8, mb))
    return {"fast": out}


def record_scene(run, traversal8, Rays):
    """Run `run()` with traversal8.intersect_scene wrapped so that each
    call's rays (copied), its any-hit mask and its visit budget are
    recorded; returns the list of (rays, kw, coherent)."""
    calls, orig = [], traversal8.intersect_scene

    def rec(geom, rays, any_hit=False, roots=None, with_iters=False,
            coherent=False, any_mask=None):
        kw = {}
        if any_hit:
            kw["any_hit"] = True
        if any_mask is not None:
            kw["any_mask"] = any_mask.clone()
        calls.append((Rays(*(x.contiguous().clone() for x in rays)), kw, coherent))
        return orig(geom, rays, any_hit=any_hit, roots=roots, with_iters=with_iters,
                    coherent=coherent, any_mask=any_mask)
    traversal8.intersect_scene = rec
    try:
        run()
    finally:
        traversal8.intersect_scene = orig
    return calls


def treelet_on_call(label, geom, call, K1, K2, K3, traversal8, traversal_tt, mb):
    """One recorded treelet traversal (rays, kw, coherent) held kernel by
    kernel to the plain versions with check_variants: K2 at the call's
    visit budget, K3 on K2's sorted slots, K1 on the exact path's fallback
    batch (tmax -1 on every ray whose visits did not overflow; both
    designs, k1_global_call); each timed,
    its device time and one plain run taken, its bound as phase 5's.
    Returns {kernel: result} with the fallback's live rays."""
    rays, kw, coherent = call
    V = traversal8.V_COHERENT if coherent else traversal8.V_INCOHERENT
    mode = traversal8.launch_mode(kw.get("any_hit", False), kw.get("any_mask"))
    top, slabs, wide = geom.tt_top, geom.tt_slabs, geom.wide
    B, dev, n_tt = rays.o.shape[0], rays.o.device, slabs.shape[0]
    info = dict(pass_of=label, rays=B, V=V)

    def k2_run(variant, kw_):
        r = K2(top, rays, V, **kw_)
        return (*r[0], *r[1:]), r[5], r[6]

    def k2_plain(kw_):
        r = traversal_tt.top_visits(top, rays, V, **kw_)
        return (*r[0], *r[1:]), r[5], r[6]
    k2 = check_variants("K2", k2_run, k2_plain, {mode: kw}, (None,), timed=(mode,),
                        plain_reps=1, bound=lambda steps, nb: mb.bound_ms(
                            nb + B * 33 + B * (29 + 8 * V),
                            steps * traversal8.NODE_STEP_FLOPS), **info)[mode, None]
    h = K2(top, rays, V, **kw)
    _, keys, order, t_prune = traversal_tt.visit_slots(
        h[0], h[1], h[3], n_tt, traversal8.any_lanes(B, kw.get("any_hit", False),
                                                     kw.get("any_mask"), dev))
    tid = keys >> traversal_tt.VID_ROOT_BITS
    needed = int(torch.unique(tid[tid < n_tt]).numel())

    def k3_run(variant, kw_):
        r = K3(slabs, rays, t_prune, keys, order, V, **kw_)
        return (*r[0], *r[1:]), r[1], r[2]

    def k3_plain(kw_):
        r = traversal_tt.treelet_hits(slabs, rays, t_prune, keys, order, V, **kw_)
        return (*r[0], *r[1:]), r[1], r[2]
    k3 = check_variants("K3", k3_run, k3_plain, {mode: kw}, (None,), timed=(mode,),
                        plain_reps=1, bound=lambda steps, nb: mb.bound_ms(
                            nb + B * 33 + B * V * 29,
                            steps * traversal8.NODE_STEP_FLOPS),
                        treelets_visited=needed, **info)[mode, None]
    tk = traversal_tt.two_phase(K2, K3, top, slabs, rays, V=V, with_overflow=True, **kw)
    fb = type(rays)(rays.o, rays.d, rays.tmin, torch.where(tk[1], tk[0].t, -1.0))

    k1 = k1_global_call(label, wide, fb, dict(kw, _design=traversal8.FALLBACK_DESIGN),
                        traversal8, mb, k1_global_runner(K1, traversal8))
    return dict(K2=k2, K3=k3, K1=k1, fallback_rays=int(tk[1].sum()), mode=mode, V=V,
                rays=B, treelets_visited=needed)


def sm_slice_phases(dev, scene, pt_rays_n, K1, K2, K3, K4, zero_counts, plain_calls,
                    wfmod, fastmod, filmmod, traversal8, traversal_tt, mb):
    """7a. the config-3 headline: WavefrontPT on San Miguel 1024^2, depth 5,
    WF_LANES lanes, a warm-up pass (pass index 0), then WF_PASSES timed
    passes: s/pass, live Mrays/s, loop iterations and host reads per pass,
    K2, K3 and K1-fallback launches per pass (one of each per iteration, K2
    at V=3 and shared, K1 global); no capped or overflowed ray, no path
    left out of the film (clipped), a finite non-black film, and the live
    rays of pass index 1 equal to the chunked PathTracer's pass index 1 in
    phase 7 (`pt_rays_n`); one pass profiled; one traversal from the middle
    of a recorded pass held kernel by kernel to the plain versions. 7b. the
    FastTracer on San Miguel 1024^2 in both modes (camera rays at V=6):
    a warm-up, FAST_SM_PASSES timed passes, Mrays/s, one K2, K3 and K1
    launch per pass; one call of each recorded and held to the plain
    versions. Returns {tracer: dict(launches_per_pass, calls)}, the calls
    as treelet_on_call returns them."""
    from cudatracerlib_tpu_torch.ops import texture
    from cudatracerlib_tpu_torch.ops.traversal import Rays
    geom, n_pix = scene.geom, 1024 * 1024
    out = {}

    def counts():
        return dict(K1=K1.launches, K1_by_variant=dict(K1.launches_by_variant),
                    K1_by_design=dict(K1.launches_by_design),
                    K2_by_v=dict(K2.launches_by_v),
                    K2_by_variant=dict(K2.launches_by_variant),
                    K3_by_v=dict(K3.launches_by_v), K4=K4.launches,
                    plain=plain_calls())

    def check(c, want_by_v, n, what):
        ok = (c["K2_by_v"] == want_by_v and c["K3_by_v"] == want_by_v
              and c["K1"] == n and c["K1_by_variant"]["global"] == n
              and c["K1_by_design"]["group"] == n
              and c["K2_by_variant"]["shared"] == n and not c["K4"] and not c["plain"])
        if not ok:
            fail(f"the {what} run took the wrong kernels: {c}, expected {n} "
                 f"launches of each, {want_by_v}")

    wf = wfmod.WavefrontPT(scene, 1024, 1024, max_depth=5, lanes=WF_LANES)
    wf.do_pass()
    torch.cuda.synchronize()
    zero_counts()
    secs, rays_n, iters, reads, clipped = [], [], [], [], []
    for _ in range(WF_PASSES):
        r0, w0 = wf.rays_traced_live, float(wf.film.weight.sum())
        wf.do_pass()
        secs.append(wf.last_pass_seconds)
        rays_n.append(wf.rays_traced_live - r0)
        iters.append(wf.last_pass_iters)
        reads.append(wf.last_pass_host_reads)
        clipped.append(n_pix - round(float(wf.film.weight.sum()) - w0))
    c = counts()
    capped, overflowed = (int(x) for x in wf._ovf_dev.tolist())
    img = filmmod.develop(wf.film).cpu().numpy()
    per_pass = dict(K2=sum(c["K2_by_v"].values()) / WF_PASSES,
                    K3=sum(c["K3_by_v"].values()) / WF_PASSES,
                    K1_fallback=c["K1"] / WF_PASSES)
    emit(phase="headline", scene="san_miguel_stand_in", tracer="WavefrontPT",
         tris=scene.num_tris, size=1024, max_depth=5, lanes=WF_LANES,
         passes=WF_PASSES, seconds_per_pass=statistics.median(secs),
         pass_seconds=secs, live_rays=int(sum(rays_n)), live_rays_by_pass=rays_n,
         mrays_per_s=sum(rays_n) / sum(secs) / 1e6, iters_per_pass=iters,
         host_reads_per_pass=reads, launches=c, launches_per_pass=per_pass,
         capped=capped, overflowed=overflowed, clipped=clipped,
         pt_live_rays_by_pass=pt_rays_n, live_rays_equal_pt=rays_n[0] == pt_rays_n[1],
         steps=int(wf._iters_dev), mean_radiance=float(img.mean()))
    if not np.isfinite(img).all() or not img.mean() > 0.0:
        fail("the wavefront San Miguel image is not finite and non-black")
    if capped or overflowed or any(clipped):
        fail(f"wavefront: capped {capped} / overflowed {overflowed} rays, "
             f"clipped {clipped} paths")
    if reads != [i + 1 for i in iters]:
        fail(f"wavefront host reads {reads} are not iterations + 1 ({iters})")
    check(c, {traversal8.V_COHERENT: 0, traversal8.V_INCOHERENT: sum(iters)},
          sum(iters), "wavefront")
    if rays_n[0] != pt_rays_n[1]:
        fail(f"wavefront live rays {rays_n[0]} differ from the chunked PT's "
             f"{pt_rays_n[1]} for pass index 1")
    profile_pass(wf, "san_miguel_stand_in", tracer="WavefrontPT")
    quads = scene.textures.texels_quad
    with RecordTake("ewa_tap", texture, "_take_rows", lambda t: t if t is quads else None):
        calls = record_scene(wf.do_pass, traversal8, Rays)
    call = calls[len(calls) // 2]
    del calls
    out["wavefront"] = dict(launches_per_pass=per_pass, calls={
        "mid_pass": treelet_on_call("wavefront_san_miguel_1024", geom, call, K1,
                                    K2, K3, traversal8, traversal_tt, mb)})
    del wf, call
    out["fast"] = dict(launches_per_pass=dict(K2=1, K3=1, K1_fallback=1), calls={})

    for mode, mname in ((fastmod.MODE_DEPTH, "depth"),
                        (fastmod.MODE_VISIBILITY, "visibility")):
        tr = fastmod.FastTracer(scene, 1024, 1024, mode=mode)
        tr.do_pass()
        torch.cuda.synchronize()
        zero_counts()
        secs, _ = timed_passes(tr, FAST_SM_PASSES)
        c = counts()
        img = filmmod.develop(tr.film).cpu().numpy()
        emit(phase="headline", scene="san_miguel_stand_in", tracer="FastTracer",
             mode=mname, size=1024, passes=FAST_SM_PASSES,
             seconds_per_pass=statistics.median(secs), pass_seconds=secs,
             mrays_per_s=n_pix * FAST_SM_PASSES / sum(secs) / 1e6, launches=c,
             mean_value=float(img.mean()))
        if not np.isfinite(img).all() or not img.mean() > 0.0:
            fail(f"the FastTracer {mname} San Miguel image is not finite and non-black")
        check(c, {traversal8.V_COHERENT: FAST_SM_PASSES, traversal8.V_INCOHERENT: 0},
              FAST_SM_PASSES, f"FastTracer {mname}")
        calls = record_scene(tr.do_pass, traversal8, Rays)
        out["fast"]["calls"][mname] = treelet_on_call(
            f"fast_{mname}_san_miguel_1024", geom, calls[0], K1, K2, K3, traversal8,
            traversal_tt, mb)
        del tr, calls
    return out


def veach_slice_phases(dev, veach, veach_4c, K1, K4, zero_counts, plain_calls,
                       k1_by_variant, pathmod, admod, bsmod, pipemod, samplersmod,
                       tracermod, filmmod, example_scenes, traversal8, mb):
    """4p. the adaptive block sampler on veach-mis 512^2, depth 5, B_VARIANCE,
    ADAPT_BLOCKS blocks a pass (262,144 lanes in one pt_radiance call): a
    warm-up pass, then ADAPT_PASSES timed passes: s/pass, live rays, K1
    launches per pass (merged: depth + 1, all shared), the spread of the
    chosen blocks (distinct blocks, the most picks of one block); one pass
    profiled and one recorded, its K1 calls held to the plain version; then
    apply_pipeline on its film (Gaussian filter, NLM with the variance
    buffer, Reinhard tonemap) timed; all four block-sampling modes at 32^2
    against the CPU over CARD_CPU_PASSES passes (ADAPT_CARD_CPU_LIMIT). 4q.
    PathTracer with the Sobol' sampler on the same scene (depth 5, chunks of
    65,536), a warm-up pass and SOBOL_PASSES timed passes, beside 4c's
    independent sampler (`veach_4c`); one pass recorded and held to K1's
    plain version; the stratified and Sobol' samplers at 32^2 against the
    CPU (CARD_CPU_LIMIT), and the tent and Gaussian filters' camera rays
    (RNG states identical, rays within 1e-6). Returns the K1 records of
    one adaptive and one Sobol' pass."""
    from cudatracerlib_tpu_torch.ops.traversal import Rays

    def counts():
        return dict(K1=K1.launches, K1_by_variant=dict(K1.launches_by_variant),
                    K1_by_design=dict(K1.launches_by_design),
                    K4=K4.launches, plain=plain_calls())

    def check(c, n, what):
        if c["K1"] != n or c["K1_by_variant"]["shared"] != n or c["K4"] or c["plain"]:
            fail(f"the {what} run took the wrong kernels: {c}, expected {n} K1")

    out = {}
    # 4p. adaptive
    chosen = []
    orig_choose = bsmod.choose_blocks

    def rec_choose(*a, **kw):
        chosen.append(orig_choose(*a, **kw))
        return chosen[-1]
    tr = admod.AdaptivePathTracer(veach, VEACH_SIZE, VEACH_SIZE, max_depth=5, mode=bsmod.B_VARIANCE,
                                  blocks_per_pass=ADAPT_BLOCKS)
    tr.do_pass()
    torch.cuda.synchronize()
    zero_counts()
    bsmod.choose_blocks = rec_choose
    try:
        secs, rays_n = timed_passes(tr, ADAPT_PASSES)
    finally:
        bsmod.choose_blocks = orig_choose
    c = counts()
    k1_by_variant["adaptive"] = c["K1_by_variant"]
    picks = [torch.bincount(b.long(), minlength=ADAPT_BLOCKS) for b in chosen]
    img = filmmod.develop(tr.film).cpu().numpy()
    emit(phase="headline", scene="veach_mis", tracer="AdaptivePathTracer",
         mode="B_VARIANCE", size=VEACH_SIZE, max_depth=5, blocks_per_pass=ADAPT_BLOCKS,
         lanes=ADAPT_BLOCKS * bsmod.BLOCK ** 2, passes=ADAPT_PASSES,
         seconds_per_pass=statistics.median(secs), pass_seconds=secs,
         live_rays=int(sum(rays_n)), live_rays_by_pass=rays_n,
         mrays_per_s=sum(rays_n) / sum(secs) / 1e6, launches=c,
         launches_per_pass=c["K1"] / ADAPT_PASSES,
         distinct_blocks_by_pass=[int((p > 0).sum()) for p in picks],
         max_picks_by_pass=[int(p.max()) for p in picks],
         weighted_in_block0_by_pass=[int((b[tr.n_det:] == 0).sum()) for b in chosen],
         mean_radiance=float(img.mean()))
    if not np.isfinite(img).all() or not img.mean() > 0.0:
        fail("the adaptive veach-mis image is not finite and non-black")
    check(c, ADAPT_PASSES * 6, "adaptive")
    profile_pass(tr, "veach_mis", tracer="AdaptivePathTracer")
    calls = record_k1(tr.do_pass, traversal8, Rays)
    out["adaptive"] = dict(launches_per_pass=len(calls), by_mode=k1_on_calls(
        "adaptive_veach_512", calls, K1, traversal8, mb))
    del calls
    # the image pipeline on the adaptive film
    pipe = lambda: pipemod.apply_pipeline(tr.film, pipemod.F_GAUSSIAN, tonemap=True,
                                          denoise=True, vb=tr.vb)
    out_img = pipe().cpu().numpy()
    emit(phase="pipeline", scene="veach_mis", size=VEACH_SIZE, filter="gaussian",
         denoise="nlm (variance buffer)", tonemap="reinhard05",
         ms=cuda_median_ms(pipe, reps=3), finite=bool(np.isfinite(out_img).all()),
         mean=float(out_img.mean()))
    if not np.isfinite(out_img).all() or not out_img.mean() > 0.0:
        fail("the pipeline's veach-mis image is not finite and non-black")
    del tr
    for mode, mname in ((bsmod.B_UNIFORM, "uniform"), (bsmod.B_VARIANCE, "variance"),
                        (bsmod.B_DIFFERENCE, "difference"), (bsmod.B_SELECT, "select")):
        rect = (0, 0, 16, 32) if mode == bsmod.B_SELECT else None
        card_vs_cpu("AdaptivePathTracer", lambda s: admod.AdaptivePathTracer(
            s, 32, 32, max_depth=5, mode=mode, select_rect=rect),
            example_scenes.veach_mis, 32, CARD_CPU_PASSES, dev,
            limit=ADAPT_CARD_CPU_LIMIT, mode=mname, max_depth=5)

    # 4q. the Sobol' sampler beside 4c's independent one
    tr = pathmod.PathTracer(veach, VEACH_SIZE, VEACH_SIZE, max_depth=5,
                            chunk_size=VEACH_HALF, sampler_type=samplersmod.SOBOL)
    tr.do_pass()
    torch.cuda.synchronize()
    zero_counts()
    secs, rays_n = timed_passes(tr, SOBOL_PASSES)
    c = counts()
    k1_by_variant["sobol"] = c["K1_by_variant"]
    img = filmmod.develop(tr.film).cpu().numpy()
    emit(phase="headline", scene="veach_mis", tracer="PathTracer", sampler="sobol",
         size=VEACH_SIZE, max_depth=5, chunk_size=VEACH_HALF, passes=SOBOL_PASSES,
         seconds_per_pass=statistics.median(secs), pass_seconds=secs,
         live_rays=int(sum(rays_n)), live_rays_by_pass=rays_n,
         mrays_per_s=sum(rays_n) / sum(secs) / 1e6, launches=c,
         independent_4c=veach_4c, mean_radiance=float(img.mean()))
    if not np.isfinite(img).all() or not img.mean() > 0.0:
        fail("the Sobol' veach-mis image is not finite and non-black")
    check(c, SOBOL_PASSES * tr._n_chunks * 6, "Sobol'")
    calls = record_k1(tr.do_pass, traversal8, Rays)
    out["sobol"] = dict(launches_per_pass=len(calls), by_mode=k1_on_calls(
        "sobol_veach_512", calls, K1, traversal8, mb))
    del tr, calls
    for st, sname in ((samplersmod.STRATIFIED, "stratified"), (samplersmod.SOBOL, "sobol")):
        card_vs_cpu("PathTracer", lambda s: pathmod.PathTracer(
            s, 32, 32, max_depth=5, sampler_type=st), example_scenes.veach_mis, 32,
            CARD_CPU_PASSES, dev, sampler=sname, max_depth=5)
    scenes = [example_scenes.veach_mis(32, 32).build(d) for d in (dev, "cpu")]
    pix = torch.arange(1024, dtype=torch.int32)
    for ft, fname in ((1, "tent"), (2, "gaussian")):
        for st in (0, samplersmod.SOBOL):
            r = [tracermod.gen_camera_rays(s, pix.to(s.device), 3, 2, 32, 32,
                                           filter_type=ft, sampler_type=st)
                 for s in scenes]
            same_state = bool(torch.equal(r[0][3].cpu(), r[1][3]))
            err = max(float((r[0][0].o.cpu() - r[1][0].o).abs().max()),
                      float((r[0][0].d.cpu() - r[1][0].d).abs().max()))
            emit(phase="card_vs_cpu", what="camera_rays", filter=fname, sampler=st,
                 states_identical=same_state, max_abs_err=err, limit=1e-6)
            if not same_state or not err <= 1e-6:
                fail(f"the {fname} filter's camera rays differ on the card")
    return out


def feature_scene(host, schema, sensors, shapes, tf, kind, size):
    """The JAX tests' feature scenes (a DynamicScene, built later): "alpha"
    and "alpha_binary" (tests/test_texture_features.py's masked occluder
    before an emissive wall; a continuous 0.25 mask, a luminance-tested
    checkerboard), "bump" and "parallax" (its bump-mapped plane under a
    point light), "marble" (tests/test_bssrdf.py's subsurface sphere) and
    "glass_slab" (the dispersive slab of test_spectral_dispersion_renders_rainbow)."""
    sc = host.DynamicScene()
    if kind.startswith("alpha"):
        black = sc.add_material(host.MaterialSpec(reflectance=(0, 0, 0)))
        sc.create_node(shapes.rectangle(), black,
                       tf.compose(tf.translate([0, 0, 2]), tf.rotate_deg([0, 1, 0], 180),
                                  tf.scale(4)), emission=(2.0, 2.0, 2.0))
        if kind == "alpha":
            mask, mode = host.TextureSpec(tex_type=schema.TEX_CONSTANT,
                                          value=(0.25,) * 3), 0
        else:
            mask = host.TextureSpec(tex_type=schema.TEX_CHECKERBOARD, value=(0.2,) * 3,
                                    value1=(0.8,) * 3, uv_scale=(4.0, 4.0))
            mode = schema.ALPHA_LUMINANCE
        occ = sc.add_material(host.MaterialSpec(reflectance=(0, 0, 0), tex_alpha_mask=mask,
                                                alpha_mode=mode, alpha_test=0.5))
        sc.create_node(shapes.rectangle(), occ,
                       tf.compose(tf.translate([0, 0, 1]), tf.rotate_deg([0, 1, 0], 180),
                                  tf.scale(4)))
        eye, at, fov = [0, 0, -2], [0, 0, 1], 20
    elif kind in ("bump", "parallax"):
        yy, xx = np.meshgrid(np.linspace(0, 6 * np.pi, 32), np.linspace(0, 6 * np.pi, 32),
                             indexing="ij")
        height = (0.5 + 0.5 * np.sin(xx) * np.sin(yy)).astype(np.float32)
        bump = host.TextureSpec(tex_type=schema.TEX_IMAGE,
                                image=np.repeat(height[..., None], 3, -1))
        m = sc.add_material(host.MaterialSpec(
            reflectance=(0.8, 0.8, 0.8), tex_bump=bump,
            parallax_scale=0.1 if kind == "parallax" else 0.0))
        sc.create_node(shapes.rectangle(), m, tf.compose(tf.rotate_deg([1, 0, 0], -90),
                                                         tf.scale(2)))
        sc.add_point_light((1.5, 2, 0), (6, 6, 6))
        eye, at, fov = [0, 2.5, -2.5], [0, 0, 0], 40
    elif kind == "marble":
        marble = sc.add_material(host.MaterialSpec(
            bsdf_type=schema.BSDF_DIELECTRIC, eta=1.3, bssrdf_sigma_a=(0.05, 0.1, 0.15),
            bssrdf_sigma_s=(3.0, 3.0, 3.0), bssrdf_g=0.3))
        black = sc.add_material(host.MaterialSpec(reflectance=(0, 0, 0)))
        sc.create_node(shapes.sphere(radius=0.5, n_theta=24, n_phi=48), marble)
        sc.create_node(shapes.rectangle(), black,
                       tf.compose(tf.translate([0, 1.8, 0]), tf.rotate_deg([1, 0, 0], 90),
                                  tf.scale(0.8)), emission=(12.0,) * 3)
        eye, at, fov = [0, 0.4, -2.4], [0, 0, 0], 35
    else:   # glass_slab
        white = sc.add_material(host.MaterialSpec(reflectance=(0.8, 0.8, 0.8)))
        glass = sc.add_material(host.MaterialSpec(
            bsdf_type=schema.BSDF_DIELECTRIC, eta=1.45, dispersion_b=0.05,
            two_sided=False))
        sc.create_node(shapes.rectangle(), white,
                       tf.compose(tf.translate([0, 0, 3]), tf.rotate_deg([0, 1, 0], 180),
                                  tf.scale(6)), emission=(4.0, 4.0, 4.0))
        sc.create_node(shapes.rectangle(), glass,
                       tf.compose(tf.translate([0, 0, 1]), tf.rotate_deg([0, 1, 0], 160),
                                  tf.scale(4)))
        eye, at, fov = [0, 0, -2], [0, 0, 1], 30
    sc.set_sensor(sensors.make_sensor(schema.SENSOR_PERSPECTIVE, tf.look_at(eye, at),
                                      fov_x_deg=fov, film_w=size, film_h=size))
    return sc


def feature_phases(dev, K1, zero_counts, plain_calls, pathmod, wfmod, example_scenes):
    """4r. the alpha (continuous and binary), bump, parallax, BSSRDF and
    spectral paths at the JAX tests' sizes, each card against CPU pass by
    pass (CARD_CPU_LIMIT), through K1 alone: PathTracer on every scene,
    WavefrontPT on the alpha, bump and parallax ones; spectral C=4 on
    Cornell 24^2 (24 passes, and against the RGB render within
    tests/test_spectral.py's bound: channel means rtol 0.12, the mean 0.08)
    and on the dispersive glass slab 16^2."""
    from cudatracerlib_tpu_torch.scene import host, schema, sensors, shapes
    from cudatracerlib_tpu_torch.utils import transforms as tf
    runs = (("alpha", 16, 4, 4, True), ("alpha_binary", 16, 4, 4, True),
            ("bump", 24, 2, 4, True), ("parallax", 16, 3, 4, True),
            ("marble", 32, 12, 3, False), ("glass_slab", 16, 4, 4, False))
    for kind, size, depth, passes, with_wf in runs:
        def scene_fn(w, h, kind=kind):
            return feature_scene(host, schema, sensors, shapes, tf, kind, w)
        makes = [(pathmod.PathTracer, {})]
        if with_wf:
            makes.append((wfmod.WavefrontPT, dict(lanes=size * size // 2 + 7)))
        if kind == "glass_slab":
            makes.append((pathmod.PathTracer, dict(spectral=4)))
        for cls, kw in makes:
            zero_counts()
            card_vs_cpu(cls.__name__, lambda s: cls(s, size, size, max_depth=depth, **kw),
                        scene_fn, size, passes, dev, scene=kind, max_depth=depth, **kw)
            if K1.launches <= 0 or plain_calls():
                fail(f"the {cls.__name__} run on {kind} took the wrong kernels")
    # spectral transport on Cornell: the card against the CPU, and against RGB
    zero_counts()
    rels = card_vs_cpu("PathTracer", lambda s: pathmod.PathTracer(
        s, 24, 24, max_depth=4, spectral=4), example_scenes.cornell_box, 24, 4, dev,
        wait=True, scene="cornell_box", spectral=4)
    scene = example_scenes.cornell_box(24, 24).build(dev)
    im1 = pathmod.PathTracer(scene, 24, 24, max_depth=4).render(24).cpu().numpy()
    im2 = pathmod.PathTracer(scene, 24, 24, max_depth=4,
                             spectral=4).render(24).cpu().numpy()
    m1, m2 = im1.mean((0, 1)), im2.mean((0, 1))
    chan = float(np.abs(m2 / m1 - 1.0).max())
    total = float(abs(im2.mean() - im1.mean()) / im1.mean())
    emit(phase="spectral_vs_rgb", scene="cornell_box", size=24, passes=24,
         channel_rel=chan, channel_limit=0.12, mean_rel=total, mean_limit=0.08,
         card_vs_cpu=rels)
    if not (np.isfinite(im2).all() and chan < 0.12 and total < 0.08):
        fail(f"spectral Cornell against RGB: channels {chan}, mean {total}")


def game_phases(dev, card, scene, K1, K2, K3, K4, zero_counts, plain_calls, gamemod,
                hashgrid, filmmod, example_scenes, traversal8, traversal_tt, mb):
    """7c. GameTracer on San Miguel 1024^2 (the scene of phase 7): a warm-up
    frame, then GAME_FRAMES timed frames: s/frame, live rays (camera rays
    and the shadow rays traced), K2 (V=6 camera, V=3 shadow), K3,
    K1-fallback and filter (psf_gather) launches per frame, the cache's
    valid rows and occupied cells; one frame profiled; every traversal of
    one recorded frame held kernel by kernel to the plain versions
    (treelet_on_call), and its filter call to the plain filter
    (psf_gather_call). Then the game
    tracer on Cornell 32^2, GAME_CARD_CPU_FRAMES frames, card against CPU
    (GAME_CARD_CPU_LIMIT). The peak memory is the game's: the scene's
    tables and the frames (the statistics reset before the warm-up frame).
    Returns {"game": dict(launches_per_pass, calls, psf_gather)}, the last
    with the timed frames' psf_gather launches."""
    from cudatracerlib_tpu_torch.ops import psf
    from cudatracerlib_tpu_torch.ops.traversal import Rays
    grids = []
    orig_build = hashgrid.build_grid

    def rec_build(*a, **kw):
        grids.append(orig_build(*a, **kw))
        return grids[-1]
    torch.cuda.reset_peak_memory_stats(dev)
    tr = gamemod.GameTracer(scene, SM_SIZE, SM_SIZE)
    tr.do_pass()
    torch.cuda.synchronize()
    zero_counts()
    hashgrid.build_grid = rec_build
    try:
        secs, rays_n = [], []
        for _ in range(GAME_FRAMES):
            grids.clear()
            r0 = tr.rays_traced_live
            tr.do_pass()
            secs.append(tr.last_pass_seconds)
            rays_n.append(tr.rays_traced_live - r0)
            cid = grids[-1].cell_ids
            valid = cid < hashgrid.INT32_MAX
            rows = (int(valid.sum()), int(torch.unique(cid[valid]).numel()))
    finally:
        hashgrid.build_grid = orig_build
    c = dict(K1=K1.launches, K1_by_variant=dict(K1.launches_by_variant),
             K1_by_design=dict(K1.launches_by_design),
             K2_by_v=dict(K2.launches_by_v), K2_by_variant=dict(K2.launches_by_variant),
             K3_by_v=dict(K3.launches_by_v), K4=K4.launches, plain=plain_calls(),
             psf_gather=psf.psf_gather.launches)
    img = filmmod.develop(tr.film).cpu().numpy()
    per_frame = dict(K2=sum(c["K2_by_v"].values()) / GAME_FRAMES,
                     K3=sum(c["K3_by_v"].values()) / GAME_FRAMES,
                     K1_fallback=c["K1"] / GAME_FRAMES,
                     psf_gather=c["psf_gather"] / GAME_FRAMES)
    g = grids[-1] if grids else None
    emit(phase="headline", scene="san_miguel_stand_in", tracer="GameTracer",
         size=SM_SIZE, frames=GAME_FRAMES, radius=tr.radius,
         seconds_per_frame=statistics.median(secs), frame_seconds=secs,
         live_rays=int(sum(rays_n)), live_rays_by_frame=rays_n,
         mrays_per_s=sum(rays_n) / sum(secs) / 1e6, launches=c,
         launches_per_frame=per_frame, grid_rows=rows[0], grid_cells_occupied=rows[1],
         grid_dims=g.dims.tolist() if g is not None else None,
         peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         mean_radiance=float(img.mean()))
    if not np.isfinite(img).all() or not img.mean() > 0.0:
        fail("the game San Miguel image is not finite and non-black")
    want = {traversal8.V_COHERENT: GAME_FRAMES, traversal8.V_INCOHERENT: GAME_FRAMES}
    if (c["K2_by_v"] != want or c["K3_by_v"] != want or c["K1"] != 2 * GAME_FRAMES
            or c["K1_by_variant"]["global"] != c["K1"]
            or c["K1_by_design"]["group"] != c["K1"]
            or c["K2_by_variant"]["shared"] != 2 * GAME_FRAMES or c["K4"] or c["plain"]
            or c["psf_gather"] != GAME_FRAMES):
        fail(f"the game run took the wrong kernels: {c}")
    profile_pass(tr, "san_miguel_stand_in", tracer="GameTracer")
    with RecordPsf(psf) as rec_psf:
        calls = record_scene(tr.do_pass, traversal8, Rays)
    if len(calls) != 2 or len(rec_psf.calls) != 1:
        fail(f"a game frame traced {len(calls)} times, not 2, and filtered "
             f"{len(rec_psf.calls)} times, not once")
    psf_take(rec_psf.calls[0], psf)
    out = dict(launches_per_pass=per_frame, calls={
        label: treelet_on_call(f"game_{label}_san_miguel_1024", scene.geom, call, K1,
                               K2, K3, traversal8, traversal_tt, mb)
        for label, call in zip(("camera", "shadow"), calls)})
    del tr, calls
    out["psf_gather"] = dict(psf_gather_call("game_san_miguel_1024", rec_psf.calls[0],
                                             psf, mb, card), launches=c["psf_gather"])
    del rec_psf
    card_vs_cpu("GameTracer", lambda s: gamemod.GameTracer(s, 32, 32),
                example_scenes.cornell_box, 32, GAME_CARD_CPU_FRAMES, dev,
                limit=GAME_CARD_CPU_LIMIT)
    return {"game": out}


# 7d: the San Miguel stand-in at 4x phase 7's triangles (its top table
# over 454 rows: K2's split variant), config 3's path tracer settings
SM48_TRIS = 4_800_000
SM48_DEPTH = 5
SM48_CHUNK = 131072
SM48_PASSES = 2
SM48_K1_LIMIT = 1e-3     # hit/no-hit and t against K1 alone
SPLIT_ROWS = 453         # the rows K2's split variant stages (cluster_rows.cuh)
# every K2 call of one 4.8M pass held in each design (hold_k2_call), for
# the lines after P1 (their chain floors)
SM48_K2_CALLS = []
# the floor ratios of k2_call_lines' lines, by design, one dict a call
SM48_K2_LINES = []


def k2_designs(top, probe):
    """(n, {design: (K2 keyword arguments, or the probe's design and
    blocks)}): the K2 designs held on a top table past one block's shared
    memory: the split variant as kept (rows 0-452 on chip, the rest through
    L1/L2), the probe's cluster design at slab_variant's n blocks and at 2n
    (up to 8), and the probe's global design (one thread per ray)."""
    n = probe.slab_variant(top.shape[0], torch.cuda.get_device_properties(
        top.device).shared_memory_per_block_optin)
    designs = {"split": dict(_variant="split"), "cluster": ("cluster", n)}
    if 2 * n <= probe.CLUSTER_MAX:
        designs["cluster_2n"] = ("cluster", 2 * n)
    designs["global"] = ("global",)
    return n, designs


def hold_k2_call(label, top, rays, V, kw, K2, probe, traversal8, traversal_tt, mb):
    """One recorded K2 call (top, rays, V, kw) in every design of
    k2_designs against the plain version (RowFetches for its bound): every
    field identical (hits, visit lists, counts, min-dropped t, steps,
    flags), no lane flagged. Device times (CUDA events behind a sleeping
    kernel, median of 3) of each design twice, in order and back; the kept
    design's synchronised median; the bound (the top rows fetched once, the
    rays in, the outputs out; steps x a node step's operations), which no
    reading may beat; each lane's row reads on the rows the split variant
    stages and on the rest (RowFetches' near_far, for its chain floor).
    Appends the call's record to SM48_K2_CALLS."""
    n, designs = k2_designs(top, probe)
    B = rays.o.shape[0]
    mode = traversal8.launch_mode(kw.get("any_hit", False), kw.get("any_mask"))

    def run(design):
        how = designs[design]
        r = (K2(top, rays, V, **how, **kw) if isinstance(how, dict)
             else probe.top_visits(top, rays, V, *how, **kw))
        return (*r[0], *r[1:])
    collect_cpu_sides()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with RowFetches(split_rows=SPLIT_ROWS) as fetched:
        r = traversal_tt.top_visits(top, rays, V, **kw)
        torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ref = (*r[0], *r[1:])
    err = 0.0
    for design in designs:
        ok, e = same(run(design), ref)
        if not ok:
            fail(f"K2 ({design}) disagrees with its plain version on {label} ({mode})")
        err = max(err, e)
    steps_t, flags = ref[-2], ref[-1]
    if int((flags != 0).sum()):
        fail(f"capped or overflowed K2 lanes on {label}")
    times = {}
    for design in (*designs, *reversed(designs)):
        times.setdefault(design, []).append(device_ms(lambda: run(design), reps=3))
    steps = int(steps_t.sum())
    bound = mb.bound_ms(fetched.nbytes + B * 33 + B * (29 + 8 * V)
                        + (B * 4 if "roots" in kw else 0),
                        steps * traversal8.NODE_STEP_FLOPS)
    if min(min(v) for v in times.values()) < bound[0]:
        fail(f"K2 on {label} took {times} ms of device time, under its bound "
             f"{bound[0]} ms")
    SM48_K2_CALLS.append(dict(
        call_of=label, V=V, mode=mode, rays=B, rows=top.shape[0], blocks=n,
        steps=steps, steps_max=int(steps_t.max()), near_far=fetched.near_far,
        max_abs_err=err,
        device_ms=times, ms=cuda_median_ms(lambda: run("split"), reps=3),
        plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1]))


def k2_call_lines(p1, mb, card, arith_ns=0.0):
    """One line per call in SM48_K2_CALLS, with each design's chain floor
    and floor_ratio; then the sums over the pass by design. A floor is P1's
    node-step reading in the design's mode of read (mb.floor_entry: one
    chain a warp, the lowest over the tables measured up to the top's
    size): the global design's thread reads, and the cluster design's reads
    at the shared reading (a block's own share of the table is the nearest
    memory a row can lie in; P1's cluster reading, of random rows over the
    cluster, overstates the hot upper rows), times the most rows a lane
    reads (its steps less the virtual visits, which read no row and test
    nothing); the kept split variant's shared reading for a lane's reads of
    its staged rows and thread reading for the rest, the most over the
    lanes (mb.split_floor); every row read with `arith_ns` of arithmetic
    added. Returns the sums."""
    sums = {}
    for c in SM48_K2_CALLS:
        reads = max((n + f for n, f in c["near_far"]), default=0)
        floors = {d: mb.split_floor(p1, c["rows"], c["near_far"], arith_ns)
                  if d == "split"
                  else chain_floor(p1, "shared" if d.startswith("cluster") else d,
                                   c["rows"], reads, mb, arith_ns=arith_ns)
                  for d in c["device_ms"]}
        SM48_K2_LINES.append(dict(floor_ratio=floor_fields(c["device_ms"], floors)))
        emit(phase="k2_split_call", nvidia_smi=card, step_arith_ns=arith_ns,
             chain_floor_ms={d: f[0] for d, f in floors.items()},
             ns_per_dependent_row={d: f[1] and (
                 [e["ns_per_dependent_row"] for e in f[1]] if d == "split"
                 else f[1]["ns_per_dependent_row"]) for d, f in floors.items()},
             floor_ratio=SM48_K2_LINES[-1]["floor_ratio"],
             **{k: v for k, v in c.items() if k != "near_far"},
             lanes_near_far_max=[max(x) for x in zip(*c["near_far"])],
             lane_rows_max=reads)
        for d, v in c["device_ms"].items():
            r = sums.setdefault(d, dict(readings=[0.0] * len(v), device_ms=0.0,
                                        chain_floor_ms=0.0))
            r["readings"] = [a + b for a, b in zip(r["readings"], v)]
            r["device_ms"] += statistics.median(v)
            r["chain_floor_ms"] += floors[d][0] or 0.0
    for r in sums.values():
        r["floor_ratio"] = r["device_ms"] / r["chain_floor_ms"] \
            if r["chain_floor_ms"] else None
        r["spread_ms"] = max(r["readings"]) - min(r["readings"])
    kept = sums.get("split")
    best = min(sums, key=lambda d: sums[d]["device_ms"]) if sums else None
    emit(phase="k2_designs_summary", nvidia_smi=card, calls=len(SM48_K2_CALLS),
         by_design=sums, fastest=best, kept="split",
         kept_margin_ms=None if kept is None else min(
             r["device_ms"] - kept["device_ms"] for d, r in sums.items()
             if d != "split"),
         bound_ms=sum(c["bound_ms"] for c in SM48_K2_CALLS),
         plain_ms=sum(c["plain_ms"] for c in SM48_K2_CALLS),
         ms=sum(c["ms"] for c in SM48_K2_CALLS))
    return sums


def sm48_phases(dev, card, K1, K2, K3, K4, zero_counts, plain_calls, pathmod,
                tracermod, filmmod, example_scenes, traversal8, traversal_tt, probe,
                mb, Rays):
    """7d. The San Miguel stand-in at 4,800,000 triangles (its top table
    past one block's shared memory), built on the card (build seconds),
    PathTracer 1024^2, depth 5, chunks of 131,072 (config 3's settings): a
    warm-up pass and SM48_PASSES timed passes (s/pass, live Mrays/s), the
    counts zeroed around them: every K2 launch the split variant, at both
    V, K3, every K1 launch the global variant's group design (the
    fallback), no K4, no plain call, no ray capped or overflowed, a finite
    non-black film. Every K2 call of one more pass recorded and held in
    each K2 design (hold_k2_call). One traversal (131,072 camera rays and
    131,072 random rays from the courtyard, closest hit) through the
    treelet path against K1 alone on the unsplit table: hit/no-hit and t
    within SM48_K1_LIMIT. Returns the launches per pass and the timings."""
    t0 = time.perf_counter()
    sm = example_scenes.san_miguel_stand_in(SM_SIZE, SM_SIZE, target_tris=SM48_TRIS)
    gen_s = time.perf_counter() - t0
    scene = sm.build(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0 - gen_s
    del sm
    geom = scene.geom
    top, wide = geom.tt_top, geom.wide
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    variant, n = traversal_tt.top_variant(top.shape[0], limit), \
        probe.slab_variant(top.shape[0], limit)
    emit(phase="sm48_build", nvidia_smi=card, tris=scene.num_tris, rows=wide.shape[0],
         table_mb=wide.numel() * 4 / 2**20, top_rows=top.shape[0],
         treelets=geom.tt_slabs.shape[0], slab_rows=geom.tt_slabs.shape[1],
         slabs_mb=geom.tt_slabs.numel() * 4 / 2**20, k2_variant=variant,
         cluster_blocks=n, generate_seconds=gen_s, build_seconds=build_s,
         bvh_seconds=scene.host["build_seconds"]["bvh"],
         treelet_seconds=scene.host["build_seconds"]["treelet"])
    if variant != "split":
        fail(f"the 4.8M stand-in's {top.shape[0]}-row top took K2's {variant} variant")

    tr = pathmod.PathTracer(scene, SM_SIZE, SM_SIZE, max_depth=SM48_DEPTH,
                            chunk_size=SM48_CHUNK)
    tr.do_pass()
    torch.cuda.synchronize()
    zero_counts()
    secs, rays_n = timed_passes(tr, SM48_PASSES)
    c = dict(K1=K1.launches, K2=K2.launches, K3=K3.launches, K4=K4.launches,
             plain=plain_calls(), K1_by_variant=dict(K1.launches_by_variant),
             K1_by_design=dict(K1.launches_by_design),
             K2_by_variant=dict(K2.launches_by_variant),
             K2_by_v=dict(K2.launches_by_v), K3_by_v=dict(K3.launches_by_v))
    img = filmmod.develop(tr.film).cpu().numpy()
    capped, overflowed = (int(x) for x in tr._ovf_dev.tolist())
    emit(phase="headline", scene="san_miguel_stand_in_4.8M", nvidia_smi=card,
         tris=scene.num_tris, size=SM_SIZE, max_depth=SM48_DEPTH,
         chunk_size=SM48_CHUNK, passes=SM48_PASSES,
         seconds_per_pass=statistics.median(secs), pass_seconds=secs,
         live_rays=int(sum(rays_n)), mrays_per_s=sum(rays_n) / sum(secs) / 1e6,
         steps=int(tr._iters_dev), capped=capped, overflowed=overflowed,
         launches=c, mean_radiance=float(img.mean()),
         finite=bool(np.isfinite(img).all()))
    if not np.isfinite(img).all() or not img.mean() > 0.0:
        fail("the 4.8M San Miguel image is not finite and non-black")
    if capped or overflowed:
        fail(f"4.8M San Miguel: capped {capped} / overflowed {overflowed} rays")
    if (min(*c["K2_by_v"].values(), *c["K3_by_v"].values(), c["K1"]) <= 0
            or c["K4"] or c["plain"]
            or c["K2_by_variant"]["split"] != c["K2"]
            or c["K1_by_variant"]["global"] != c["K1"]
            or c["K1_by_design"]["group"] != c["K1"]):
        fail(f"the 4.8M San Miguel passes took the wrong kernels: {c}")

    # one more pass recorded: every K2 call held in each design
    calls = [(args, kw) for kind, args, kw
             in record_kernels(tr.do_pass, traversal8, traversal_tt, Rays)
             if kind == "K2"]
    per_pass = c["K2"] // SM48_PASSES
    if len(calls) != per_pass:
        fail(f"a 4.8M pass made {len(calls)} K2 calls, not {per_pass}")
    t1 = time.perf_counter()
    for i, ((top_, rays, V), kw) in enumerate(calls):
        hold_k2_call(f"sm48_pt_call{i}", top_, rays, V, kw, K2, probe, traversal8,
                     traversal_tt, mb)
    emit(phase="sm48_k2_held", calls=len(calls), seconds=time.perf_counter() - t1,
         max_abs_err=max(r["max_abs_err"] for r in SM48_K2_CALLS),
         host_peak_rss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
         device_peak_gb=torch.cuda.max_memory_allocated(dev) / 2**30)
    del calls, tr

    # one traversal through the treelet path against K1 alone
    half = SM48_CHUNK
    pix = (torch.arange(half, dtype=torch.int32, device=dev) * 8) % (SM_SIZE * SM_SIZE)
    cam = tracermod.gen_camera_rays(scene, pix, 0, 0, SM_SIZE, SM_SIZE)[0]
    rng = np.random.default_rng(48)
    o = np.stack([rng.uniform(-16, 16, half), rng.uniform(0.3, 5.0, half),
                  rng.uniform(-10, 10, half)], 1).astype(np.float32)
    d = rng.normal(size=(half, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    B = 2 * half
    rays = Rays(o=torch.cat([cam.o, torch.from_numpy(o).to(dev)]),
                d=torch.cat([cam.d, torch.from_numpy(d).to(dev)]),
                tmin=torch.full((B,), 1e-4, device=dev),
                tmax=torch.full((B,), 1e30, device=dev))
    ex = traversal8.intersect_scene(geom, rays, coherent=True)
    k1 = K1(wide, rays)
    hit_ex, hit_k1 = ex.tri >= 0, k1.tri >= 0
    both = hit_ex & hit_k1
    mismatch = float((hit_ex != hit_k1).float().mean())
    rel = float(((ex.t - k1.t).abs() / k1.t.abs())[both].mean()) if bool(both.any()) else 0.0
    emit(phase="sm48_vs_k1", rays=B, hits=int(both.sum()),
         hit_mismatch_share=mismatch, t_mean_rel_err=rel,
         t_identical=int((ex.t == k1.t)[both].sum()),
         tri_differ=int((ex.tri != k1.tri)[both].sum()), limit=SM48_K1_LIMIT)
    if not (mismatch <= SM48_K1_LIMIT and rel <= SM48_K1_LIMIT):
        fail(f"the 4.8M treelet path against K1 alone: hit mismatch {mismatch}, "
             f"t {rel}")
    return dict(counts_per_pass={k: (v // SM48_PASSES if isinstance(v, int) else
                                     {kk: vv // SM48_PASSES for kk, vv in v.items()})
                                 for k, v in c.items()},
                seconds_per_pass=statistics.median(secs),
                mrays_per_s=sum(rays_n) / sum(secs) / 1e6, top_rows=top.shape[0],
                rows=wide.shape[0], blocks=n, build_seconds=build_s)


def inst_scene(host, schema, sensors, shapes, tf, size, n_spheres=5):
    """tests/test_instancing.py `_scene`: a floor, an emissive light and
    five nodes sharing one 12x24 sphere (six instances: the dense route)."""
    sc = host.DynamicScene()
    white = sc.add_material(host.MaterialSpec(reflectance=(0.7, 0.7, 0.7)))
    red = sc.add_material(host.MaterialSpec(reflectance=(0.6, 0.1, 0.1)))
    black = sc.add_material(host.MaterialSpec(reflectance=(0, 0, 0)))
    rect = shapes.rectangle()
    sc.create_node(rect, white, tf.compose(tf.translate([0, -1, 0]),
                                           tf.rotate_deg([1, 0, 0], -90), tf.scale(4.0)),
                   name="floor")
    sc.create_node(rect, black, tf.compose(tf.translate([0, 2.5, 0]),
                                           tf.rotate_deg([1, 0, 0], 90), tf.scale(1.0)),
                   emission=(10.0, 10.0, 10.0), name="light")
    ball = shapes.sphere(radius=0.4, n_theta=12, n_phi=24)
    for i in range(n_spheres):
        sc.create_node(ball, red if i % 2 else white,
                       tf.compose(tf.translate([-1.6 + i * 0.8, -0.6, 0.3 * (i % 3)]),
                                  tf.scale(0.8 + 0.1 * i)), name=f"ball{i}")
    sc.set_sensor(sensors.make_sensor(
        schema.SENSOR_PERSPECTIVE, tf.look_at([0, 0.5, -4.5], [0, -0.3, 0]),
        fov_x_deg=40.0, film_w=size, film_h=size))
    return sc


def grid_scene(host, schema, sensors, shapes, tf, size):
    """tests/test_instancing.py:120-160: one 6x12 sphere shared by a 23x23
    grid of nodes, a floor and a light (530 instances: the TLAS route)."""
    sc = host.DynamicScene()
    white = sc.add_material(host.MaterialSpec(reflectance=(0.7, 0.7, 0.7)))
    black = sc.add_material(host.MaterialSpec(reflectance=(0, 0, 0)))
    rect = shapes.rectangle()
    sc.create_node(rect, white, tf.compose(tf.translate([0, -1, 0]),
                                           tf.rotate_deg([1, 0, 0], -90), tf.scale(40.0)),
                   name="floor")
    sc.create_node(rect, black, tf.compose(tf.translate([0, 6, 0]),
                                           tf.rotate_deg([1, 0, 0], 90), tf.scale(2.0)),
                   emission=(30.0, 30.0, 30.0), name="light")
    ball = shapes.sphere(radius=0.3, n_theta=6, n_phi=12)
    for gx in range(23):
        for gz in range(23):
            sc.create_node(ball, white, tf.translate([(gx - 11) * 0.9, -0.7,
                                                      (gz - 11) * 0.9]),
                           name=f"b{gx}_{gz}")
    sc.set_sensor(sensors.make_sensor(
        schema.SENSOR_PERSPECTIVE, tf.look_at([0, 3.0, -14.0], [0, -0.5, 0]),
        fov_x_deg=50.0, film_w=size, film_h=size))
    return sc


def bench_inst_scene(host, schema, sensors, shapes, tf, size):
    """bench.py:413-433, the instanced A/B scene: one 33,020-triangle sphere
    shared by a 4x4 grid of nodes, over a floor; flattened, 528,324
    triangles. bench.py times only its traversal and gives it no emitter;
    for the path tracer it gets one area light (a 6x6 rectangle 5 units up,
    facing down), which stays in the flattened part with the floor."""
    sc = host.DynamicScene()
    white = sc.add_material(host.MaterialSpec(reflectance=(0.7, 0.7, 0.7)))
    red = sc.add_material(host.MaterialSpec(reflectance=(0.6, 0.1, 0.1)))
    floor = sc.add_material(host.MaterialSpec(reflectance=(0.4, 0.4, 0.4)))
    sc.create_node(shapes.rectangle(), floor,
                   tf.compose(tf.translate([0, -1, 0]),
                              tf.rotate_deg([1, 0, 0], -90), tf.scale(30.0)))
    sc.create_node(shapes.rectangle(), floor,
                   tf.compose(tf.translate([0, 5, 0]), tf.rotate_deg([1, 0, 0], 90),
                              tf.scale(3.0)), emission=(8.0, 8.0, 8.0), name="light")
    ball = shapes.sphere(radius=0.6, n_theta=128, n_phi=130)
    for i in range(4):
        for j in range(4):
            sc.create_node(ball, red if (i + j) % 2 else white,
                           tf.translate([-3.0 + 2.0 * i, -0.4, -3.0 + 2.0 * j]),
                           name=f"ball{i}_{j}")
    sc.set_sensor(sensors.make_sensor(
        schema.SENSOR_PERSPECTIVE, tf.look_at([0, 4.0, -9.0], [0, -0.5, 0]),
        fov_x_deg=50.0, film_w=size, film_h=size))
    return sc


def record_kernels(run, traversal8, traversal_tt, Rays, window=None):
    """Run `run()` with both traversals' kernel choices
    (traversal8._wide_fn, traversal_tt._kernels) wrapped, so that each K1,
    K2 and K3 call's inputs are recorded, copied (every call still
    launches and counts); with `window` (start, stop) only the calls of
    those indices in call order. Returns [(kernel, args, kw)]."""
    calls = []
    n = [0]
    orig_wide, orig_kernels = traversal8._wide_fn, traversal_tt._kernels

    def record(kind, args):
        n[0] += 1
        if window is None or window[0] <= n[0] - 1 < window[1]:
            calls.append((kind, *args()))

    def keep(kw):
        return {k: v.clone() if isinstance(v, torch.Tensor) else v
                for k, v in kw.items()
                if k in ("any_hit", "any_mask", "roots", "_design") and v is not None
                and v is not False}

    def copy_rays(rays):
        return Rays(*(x.clone() for x in rays))

    def wide_fn(table, pool=False):
        fn = orig_wide(table, pool)

        def rec(table, rays, **kw):
            record("K1", lambda: ((table, copy_rays(rays)), keep(kw)))
            return fn(table, rays, **kw)
        return rec

    def kernels(top):
        p1, p2 = orig_kernels(top)

        def r1(top, rays, V, **kw):
            record("K2", lambda: ((top, copy_rays(rays), V), keep(kw)))
            return p1(top, rays, V, **kw)

        def r2(slabs, rays, t_prune, keys, order, V, **kw):
            record("K3", lambda: ((slabs, copy_rays(rays), t_prune.clone(), keys.clone(),
                                   order.clone(), V), keep(kw)))
            return p2(slabs, rays, t_prune, keys, order, V, **kw)
        return r1, r2
    traversal8._wide_fn, traversal_tt._kernels = wide_fn, kernels
    try:
        run()
    finally:
        traversal8._wide_fn, traversal_tt._kernels = orig_wide, orig_kernels
    return calls


def hold_calls(label, calls, K1, K2, K3, traversal8, traversal_tt, mb):
    """Each recorded call (record_kernels) run again on its kernel and on
    its plain version: every field identical (hits, visit lists, counts,
    steps, flags). Per kernel, summed over its calls: launches, rays, live
    rays (tmax > tmin), steps, the kernel's time (CUDA-synchronised median
    of 3 runs, launch included) and device time (CUDA events behind a
    sleeping kernel, median of 3), the plain version's time (one
    synchronised run) and the bound (the table rows the plain run fetched,
    RowFetches, once; the rays with their roots in, the outputs out; steps
    times a node step's operations; K1's by trav_bound, over its live
    lanes), which no call's device time may beat.
    A K1 call on the global variant also goes through k1_global_call (both
    designs; device_ms_by_design sums their times). Emits one line per
    kernel; returns {kernel: dict}."""
    out = {}
    for kind, args, kw in calls:
        mode = traversal8.launch_mode(kw.get("any_hit", False), kw.get("any_mask"))
        rays = args[1]
        B = rays.o.shape[0]
        extra = B * 4 if "roots" in kw else 0
        if kind == "K1":
            table = args[0]
            run = lambda: K1(table, rays, with_iters=True, **kw)
            plain = lambda: traversal8.intersect_wide(table, rays, with_iters=True,
                                                      **plain_kw(kw))
            flat = lambda r: (*r[0], r[1], r[2])
            steps_of = lambda r: r[1]
            lanes = live_mask(rays, kw, traversal8)
            variant = traversal8.launch_variant(table)
        elif kind == "K2":
            top, _, V = args
            run = lambda: K2(top, rays, V, **kw)
            plain = lambda: traversal_tt.top_visits(top, rays, V, **kw)
            flat = lambda r: (*r[0], *r[1:])
            steps_of = lambda r: r[5]
            io_bytes = B * 33 + B * (29 + 8 * V)
            lanes = None
            variant = traversal_tt.launch_top_variant(top)
        else:
            slabs, _, t_prune, keys, order, V = args
            run = lambda: K3(slabs, rays, t_prune, keys, order, V, **kw)
            plain = lambda: traversal_tt.treelet_hits(slabs, rays, t_prune, keys, order,
                                                      V, **kw)
            flat = lambda r: (*r[0], *r[1:])
            steps_of = lambda r: r[1]
            io_bytes = B * 33 + B * V * 29
            lanes = None
            variant = "global"
        got = run()
        collect_cpu_sides()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with RowFetches(lanes=lanes) as fetched:
            ref = plain()
            torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        ok, err = same(flat(got), flat(ref))
        if not ok:
            fail(f"{kind} disagrees with its plain version on {label} ({mode}, {kw.keys()})")
        steps = int(steps_of(got).sum())
        if kind == "K1":
            bound = trav_bound(fetched.nbytes, B, steps, mode == "mixed", mb, traversal8,
                               int(lanes.sum()), "roots" in kw)
        else:
            bound = mb.bound_ms(fetched.nbytes + io_bytes + extra,
                                steps * traversal8.NODE_STEP_FLOPS)
        r = out.setdefault(kind, dict(launches=0, rays=0, live_rays=0, with_roots=0,
                                      by_mode={}, variants={}, err=0.0, steps=0,
                                      ms=0.0, device_ms=0.0, plain_ms=0.0,
                                      bound_ms=0.0))
        r["launches"] += 1
        r["rays"] += B
        r["live_rays"] += int((rays.tmax > rays.tmin).sum()) if kind != "K3" else 0
        r["with_roots"] += int("roots" in kw)
        r["by_mode"][mode] = r["by_mode"].get(mode, 0) + 1
        r["variants"][variant] = r["variants"].get(variant, 0) + 1
        r["err"] = max(r["err"], err)
        r["steps"] += steps
        dms = device_ms(run, reps=3)
        if dms < bound[0]:
            fail(f"{kind} on {label} took {dms} ms of device time, under its "
                 f"bound {bound[0]} ms: the bound counts work the call does not do")
        r["ms"] += cuda_median_ms(run, reps=3)
        r["device_ms"] += dms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += bound[0]
        if kind == "K1" and variant == "global":
            designs = k1_global_call(label, table, rays, kw, traversal8, mb,
                                     k1_global_runner(K1, traversal8), ref=flat(ref),
                                     plain_ms=plain_ms, nbytes=fetched.nbytes)["designs"]
            for design, dms in designs.items():
                r.setdefault("device_ms_by_design", {})
                r["device_ms_by_design"][design] = \
                    r["device_ms_by_design"].get(design, 0.0) + dms
    for kind, r in out.items():
        emit(phase="kernel_on_call", kernel=kind, call_of=label, identical=True,
             max_abs_err=r["err"], **{k: v for k, v in r.items() if k != "err"})
    return out


def instanced_phases(dev, card, K1, K2, K3, K4, zero_counts, plain_calls, pathmod,
                     tracermod, filmmod, example_scenes, traversal8, traversal_tt, mb):
    """9a-9e, two-level instancing (the main path of this slice: the path
    tracer on instanced scenes, each BLAS visit on K1, or K2, K3 and the K1
    fallback, with per-lane roots). Returns the kernel-table entries
    {kernel: {tracer: dict}}."""
    from cudatracerlib_tpu_torch.ops import instanced
    from cudatracerlib_tpu_torch.ops import shading
    from cudatracerlib_tpu_torch.ops.traversal import Rays
    from cudatracerlib_tpu_torch.scene import animation, host, schema, sensors, shapes
    from cudatracerlib_tpu_torch.utils import transforms as tf
    mods = (host, schema, sensors, shapes, tf)
    out = {}

    def counts():
        return dict(K1=K1.launches, K1_by_mode=dict(K1.launches_by_mode),
                    K1_by_variant=dict(K1.launches_by_variant),
                    K1_by_design=dict(K1.launches_by_design),
                    K2_by_v=dict(K2.launches_by_v),
                    K2_by_variant=dict(K2.launches_by_variant),
                    K3_by_v=dict(K3.launches_by_v), K4=K4.launches, plain=plain_calls())

    def finite(img, what):
        if not np.isfinite(img).all() or not img.mean() > 0.0:
            fail(f"the {what} image is not finite and non-black")

    # 9a. the instanced golden on the card, and the card against the CPU
    # pass by pass
    trs = [pathmod.PathTracer(inst_scene(*mods, 48).build(d), 48, 48, max_depth=4)
           for d in (dev, "cpu")]
    zero_counts()
    rels = []
    for _ in range(INST_GOLDEN_PASSES):
        imgs = [tr.render(1).cpu().numpy() for tr in trs]
        for img in imgs:
            finite(img, "instanced golden")
        rels.append(float(np.abs(imgs[0] - imgs[1]).mean() / max(imgs[1].mean(), 1e-9)))
    c = counts()
    K1_THREAD_LAUNCHES["instanced golden"] = c["K1_by_design"]["thread"]
    g_rel = golden_rel(imgs[0], "instanced_48_pt.npz")
    emit(phase="inst_golden", size=48, max_depth=4, passes=INST_GOLDEN_PASSES,
         golden_rel_err=g_rel, golden_limit=0.02, card_vs_cpu_rel_err=max(rels),
         rel_err_by_pass=rels, card_cpu_limit=CARD_CPU_LIMIT, launches=c)
    if not g_rel < 0.02:
        fail(f"the instanced golden drifted on the card: {g_rel}")
    if not max(rels) < CARD_CPU_LIMIT:
        fail(f"the instanced card image differs from the CPU image: {rels}")
    # 6 instances x (4 merged traversals + 1 shadow flush) a pass, K1 alone
    if c["K1"] != INST_GOLDEN_PASSES * 5 * 6 or c["K2_by_v"][3] or c["plain"] or c["K4"]:
        fail(f"the instanced golden took the wrong kernels: {c}")
    del trs

    # 9b. bench.py's instanced scene at 512^2: builds, and one traversal of
    # 131,072 camera rays through both
    size = INST_SIZE
    sc = bench_inst_scene(*mods, size)
    builds = {}
    for mode in ("auto", "off"):
        t0 = time.perf_counter()
        builds[mode] = sc.build(dev, instancing=mode)
        torch.cuda.synchronize()
        s_ = builds[mode]
        emit(phase="inst_build", scene="bench_instanced", instancing=mode,
             seconds=time.perf_counter() - t0, tris=s_.num_tris,
             wide_rows=s_.geom.wide.shape[0],
             top_rows=None if s_.geom.tt_top is None else s_.geom.tt_top.shape[0],
             treelets=None if s_.geom.tt_slabs is None else s_.geom.tt_slabs.shape[0],
             instances=None if s_.geom.inst is None else s_.geom.inst.root.shape[0],
             root_top_set=s_.geom.inst is not None and s_.geom.inst.root_top is not None,
             bvh_seconds=s_.host["build_seconds"]["bvh"],
             treelet_seconds=s_.host["build_seconds"]["treelet"])
    inst, flat = builds["auto"], builds["off"]
    if inst.geom.inst is None or inst.geom.inst.root_top is None or inst.geom.tt_top is None:
        fail("bench.py's instanced scene did not build a split two-level forest")
    B = INST_RAYS
    pix = torch.arange(B, dtype=torch.int32, device=dev) % (size * size)
    rays = tracermod.gen_camera_rays(inst, pix, 0, 0, size, size)[0]
    rays = Rays(*(x.contiguous() for x in rays))
    hits = {}
    for mode, s_ in builds.items():
        hits[mode] = traversal8.intersect_scene(s_.geom, rays)
        ms = cuda_median_ms(lambda: traversal8.intersect_scene(s_.geom, rays))
        emit(phase="inst_traversal", scene="bench_instanced", instancing=mode, rays=B,
             ms=ms, mrays_per_s=B / ms / 1e3, hits=int(hits[mode].valid.sum()),
             nvidia_smi=card)
    hi, hf = hits["auto"], hits["off"]
    # the comparison rules: validity and t identical but on grazing rays
    # (|cos| < GRAZE between the ray and the hit's normal), where each build
    # rounds its own space; the node each hit lands on identical
    si = shading.fill_dg(inst.geom, rays, hi, flip_to_ray=False)
    sf = shading.fill_dg(flat.geom, rays, hf, flip_to_ray=False)
    cos = torch.where(hf.valid, (sf.ng * rays.d).sum(-1), (si.ng * rays.d).sum(-1)).abs()
    graze = cos < GRAZE
    both = hi.valid & hf.valid
    flips = hi.valid != hf.valid
    t_off = both & ((hi.t - hf.t).abs() > 1e-5 * hf.t.abs() + 1e-6)
    node_i = torch.where(inst.geom.inst.node_id[hi.inst.clamp_min(0).long()] >= 0,
                         inst.geom.inst.node_id[hi.inst.clamp_min(0).long()],
                         inst.geom.shade[hi.tri.clamp_min(0).long(), 25].view(torch.int32))
    node_f = flat.geom.shade[hf.tri.clamp_min(0).long(), 25].view(torch.int32)
    node_off = both & (node_i != node_f)
    bad = (flips | t_off | node_off) & ~graze
    emit(phase="inst_vs_flat", scene="bench_instanced", rays=B,
         hits=int(hf.valid.sum()), validity_flips=int(flips.sum()),
         t_off=int(t_off.sum()), node_off=int(node_off.sum()),
         grazing=int(graze.sum()), off_not_grazing=int(bad.sum()),
         max_t_rel=float(((hi.t - hf.t).abs() / hf.t.abs())[both].max()))
    if int(bad.sum()) or int((flips | t_off | node_off).sum()) > B * 1e-4:
        fail("instanced hits differ from the flattened ones beyond grazing rays")
    # every K2, K3 and K1 call of one instanced traversal against its plain
    # version
    calls = record_kernels(lambda: traversal8.intersect_scene(inst.geom, rays),
                           traversal8, traversal_tt, Rays)
    I = inst.geom.inst.root.shape[0]
    kinds = [c_[0] for c_ in calls]
    if kinds.count("K1") != I or kinds.count("K2") != I or kinds.count("K3") != I:
        fail(f"one instanced traversal made {len(calls)} calls, not 3 x {I}")
    out["bench_traversal"] = hold_calls("bench_instanced_512", calls, K1, K2, K3,
                                        traversal8, traversal_tt, mb)
    del calls

    # 9c. PathTracer on it, 512^2, depth 5, chunks of 131,072: the
    # instanced build against the flattened one in one call
    live = {}
    for mode in ("auto", "off"):
        tr = pathmod.PathTracer(builds[mode], size, size, max_depth=INST_DEPTH,
                                chunk_size=INST_RAYS)
        torch.cuda.synchronize()
        zero_counts()
        r0 = instanced.host_reads
        secs, rays_n = timed_passes(tr, INST_PASSES)
        c = counts()
        K1_THREAD_LAUNCHES[f"bench instanced PT ({mode})"] = c["K1_by_design"]["thread"]
        img = filmmod.develop(tr.film).cpu().numpy()
        finite(img, f"bench instanced ({mode})")
        capped, overflowed = (int(x) for x in tr._ovf_dev.tolist())
        live[mode] = rays_n
        n_calls = tr._n_chunks * (INST_DEPTH + 1)
        per_pass = {k: (v / INST_PASSES if isinstance(v, int) else
                        {kk: vv / INST_PASSES for kk, vv in v.items()})
                    for k, v in c.items()}
        emit(phase="headline", scene="bench_instanced", tracer="PathTracer",
             instancing=mode, size=size, max_depth=INST_DEPTH, chunk_size=INST_RAYS,
             passes=INST_PASSES, seconds_per_pass=statistics.median(secs),
             pass_seconds=secs, live_rays_by_pass=rays_n,
             mrays_per_s=sum(rays_n) / sum(secs) / 1e6, launches_per_pass=per_pass,
             traversals_per_pass=n_calls, tlas_host_reads=instanced.host_reads - r0,
             capped=capped, overflowed=overflowed, mean_radiance=float(img.mean()),
             nvidia_smi=card)
        if capped or overflowed:
            fail(f"bench instanced ({mode}): capped {capped} / overflowed {overflowed}")
        if mode == "auto":
            want = INST_PASSES * n_calls * I
            if (c["K2_by_v"][traversal8.V_INCOHERENT] != want
                    or c["K3_by_v"][traversal8.V_INCOHERENT] != want
                    or c["K2_by_v"][traversal8.V_COHERENT] or c["K1"] != want
                    or c["K1_by_mode"]["any_hit"] != INST_PASSES * tr._n_chunks * I
                    or c["plain"] or c["K4"]):
                fail(f"the instanced pass took the wrong kernels: {c}, "
                     f"{want} launches of each expected")
            out["bench_pt"] = dict(launches_per_pass=per_pass,
                                   seconds_per_pass=statistics.median(secs))
            profile_pass(tr, "bench_instanced", tracer="PathTracer", instancing=mode)
            # the K2, K3 and K1 calls of the pass's second traversal (the
            # depth-1 bounce rays merged with depth 0's shadow rays, 2 x
            # INST_RAYS lanes in mixed mode) held to their plain versions
            calls = record_kernels(tr.do_pass, traversal8, traversal_tt, Rays,
                                   window=(3 * I, 6 * I))
            modes = {traversal8.launch_mode(kw.get("any_hit", False), kw.get("any_mask"))
                     for _, _, kw in calls}
            if len(calls) != 3 * I or modes != {"mixed"}:
                fail(f"the held bench PT traversal made {len(calls)} calls in {modes}")
            out["bench_pt_traversal"] = hold_calls("bench_instanced_pt_512", calls, K1, K2,
                                                   K3, traversal8, traversal_tt, mb)
            del calls
        del tr
    gap = [abs(a - b) / b for a, b in zip(live["auto"], live["off"])]
    emit(phase="inst_live_rays", scene="bench_instanced", instanced=live["auto"],
         flattened=live["off"], rel_gap=gap, limit=LIVE_RAYS_GAP)
    if not max(gap) < LIVE_RAYS_GAP:
        fail(f"instanced live rays differ from the flattened build's: {gap}")
    del hits, hi, hf, si, sf, rays

    # 9d. the 530-instance grid at 512^2 (the TLAS route): the camera rays'
    # visit lists drop nothing (tests/test_instancing.py:156-158); then
    # PathTracer, depth 5, a warm-up and 2 timed passes: the visits its
    # bounce and shadow rays drop past the budget of 12 (counted, as the
    # JAX package counts them) and the TLAS walk's host reads; its image
    # against the flattened build's after the same passes; every K1 call
    # (per-lane roots) of one traversal held to the plain version
    grid_sc = grid_scene(*mods, size)
    grid = grid_sc.build(dev)
    if grid.geom.inst is None or grid.geom.inst.tlas is None:
        fail("the grid scene did not build a TLAS")
    gpix = torch.arange(size * size, dtype=torch.int32, device=dev)
    grays = tracermod.gen_camera_rays(grid, gpix, 0, 0, size, size)[0]
    _, gcounts, cam_dropped = instanced.tlas_visits(grid.geom.inst.tlas,
                                                    grid.geom.inst.tlas_order, grays)
    emit(phase="grid_camera_visits", size=size, rays=size * size,
         dropped=int(cam_dropped), max_visits=int(gcounts.max()),
         mean_visits=float(gcounts.float().mean()))
    if int(cam_dropped):
        fail(f"the grid's camera rays dropped {int(cam_dropped)} TLAS visits")
    del grays
    tr = pathmod.PathTracer(grid, size, size, max_depth=INST_DEPTH, chunk_size=INST_RAYS)
    tr.do_pass()
    torch.cuda.synchronize()
    zero_counts()
    instanced.dropped_visits = 0
    r0 = instanced.host_reads
    secs, rays_n = timed_passes(tr, GRID_PASSES)
    c = counts()
    K1_THREAD_LAUNCHES["grid PT"] = c["K1_by_design"]["thread"]
    reads = instanced.host_reads - r0
    dropped = int(instanced.dropped_visits)
    img = filmmod.develop(tr.film).cpu().numpy()
    finite(img, "grid instanced")
    n_calls = tr._n_chunks * (INST_DEPTH + 1)
    emit(phase="headline", scene="grid_530_instances", tracer="PathTracer", size=size,
         max_depth=INST_DEPTH, chunk_size=INST_RAYS, passes=GRID_PASSES,
         instances=grid.geom.inst.root.shape[0], tlas_rows=grid.geom.inst.tlas.shape[0],
         wide_rows=grid.geom.wide.shape[0], seconds_per_pass=statistics.median(secs),
         pass_seconds=secs, live_rays_by_pass=rays_n,
         mrays_per_s=sum(rays_n) / sum(secs) / 1e6, dropped_visits=dropped,
         dropped_visits_limit=GRID_DROPPED_MAX_PER_PASS * GRID_PASSES,
         tlas_host_reads_per_pass=reads / GRID_PASSES, traversals_per_pass=n_calls,
         launches_per_pass={k: (v / GRID_PASSES if isinstance(v, int) else
                                {kk: vv / GRID_PASSES for kk, vv in v.items()})
                            for k, v in c.items()},
         mean_radiance=float(img.mean()), nvidia_smi=card)
    if dropped > GRID_DROPPED_MAX_PER_PASS * GRID_PASSES:
        fail(f"the grid passes dropped {dropped} TLAS visits, more than "
             f"{GRID_DROPPED_MAX_PER_PASS} a pass")
    want = GRID_PASSES * n_calls * instanced.TLAS_VISITS
    if c["K1"] != want or c["K2_by_v"][3] or c["plain"] or c["K4"]:
        fail(f"the grid pass's launches {c} ({want} K1 expected)")
    grid_flat = grid_sc.build(dev, instancing="off")
    ftr = pathmod.PathTracer(grid_flat, size, size, max_depth=INST_DEPTH,
                             chunk_size=INST_RAYS)
    fimg = ftr.render(1 + GRID_PASSES).cpu().numpy()
    grel = float(np.abs(img - fimg).mean() / max(fimg.mean(), 1e-9))
    emit(phase="grid_vs_flat", size=size, passes=1 + GRID_PASSES, rel_err=grel,
         limit=0.02, dropped_visits=dropped, flat_tris=grid_flat.num_tris,
         flat_wide_rows=grid_flat.geom.wide.shape[0])
    if not grel < 0.02:
        fail(f"the grid's instanced image differs from the flattened one: {grel}")
    del ftr, grid_flat
    profile_pass(tr, "grid_530_instances", tracer="PathTracer")
    # the TLAS walk of one merged traversal (the second of a pass), its
    # middle GRID_TLAS_CPU_LANES lanes (bounce and shadow rays) rerun on
    # the CPU: the same visit lists, counts and dropped visits
    walks, orig_walk = [], instanced.tlas_visits

    def walk(table, order, rays, **kw):
        walks.append((table, order, Rays(*(x.clone() for x in rays)), kw))
        return orig_walk(table, order, rays, **kw)
    instanced.tlas_visits = walk
    try:
        calls = record_kernels(tr.do_pass, traversal8, traversal_tt, Rays)
    finally:
        instanced.tlas_visits = orig_walk
    table, order, wrays, kw = walks[1]
    half = wrays.o.shape[0] // 2
    sl = slice(half - GRID_TLAS_CPU_LANES // 2, half + GRID_TLAS_CPU_LANES // 2)
    part = Rays(*(x[sl].contiguous() for x in wrays))
    on_card = instanced.tlas_visits(table, order, part, **kw)
    on_cpu = instanced.tlas_visits(table.cpu(), order.cpu(), Rays(*(x.cpu() for x in part)),
                                   **kw)
    same_walk = all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu))
    emit(phase="grid_tlas_card_vs_cpu", lanes=GRID_TLAS_CPU_LANES, identical=same_walk,
         dropped=[int(on_card[2]), int(on_cpu[2])], max_visits=kw.get("max_visits"))
    if not same_walk:
        fail("the grid's TLAS walk on the card differs from the CPU's")
    del walks, wrays, part
    per_call = instanced.TLAS_VISITS
    mid = len(calls) // per_call // 2 * per_call
    out["grid_traversal"] = hold_calls("grid_530_instances_512", calls[mid:mid + per_call],
                                       K1, K2, K3, traversal8, traversal_tt, mb)
    out["grid_pt"] = dict(launches_per_pass=c["K1"] / GRID_PASSES,
                          seconds_per_pass=statistics.median(secs),
                          tlas_host_reads_per_pass=reads / GRID_PASSES)
    del tr, calls, grid

    # 9e. updates: one instance of the bench scene moved through
    # update_transforms in UPDATE_FRAMES frames, each frame's pass against
    # a fresh build's at the same transforms
    scene_u = inst
    nid = 2 + 5    # ball1_1 (after the floor and the light)
    rels, upd_s, build_s = [], [], []
    for f in range(UPDATE_FRAMES):
        m = tf.translate([-1.0 + 0.4 * f, -0.4 + 0.3 * f, -1.0 - 0.2 * f])
        t0 = time.perf_counter()
        scene_u = sc.update_transforms(scene_u, {nid: m})
        torch.cuda.synchronize()
        upd_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        fresh = sc.build(dev)
        torch.cuda.synchronize()
        build_s.append(time.perf_counter() - t0)
        imgs = [pathmod.PathTracer(s_, UPDATE_SIZE, UPDATE_SIZE, max_depth=4)
                .render(1).cpu().numpy() for s_ in (scene_u, fresh)]
        for img in imgs:
            finite(img, "moved instance")
        rels.append(float(np.abs(imgs[0] - imgs[1]).mean() / max(imgs[1].mean(), 1e-9)))
    emit(phase="inst_update", scene="bench_instanced", frames=UPDATE_FRAMES,
         size=UPDATE_SIZE, rel_err_by_frame=rels, limit=0.02,
         update_seconds=upd_s, build_seconds=build_s)
    if not max(rels) < 0.02:
        fail(f"a moved instance's pass differs from a fresh build's: {rels}")
    del scene_u, fresh, inst, flat, builds
    # the flat branch: the Cornell box's sphere moved and the table refit
    cb = example_scenes.cornell_box(256, 256)
    sid = next(i for i, n in enumerate(cb._nodes) if n.name == "sphere")
    s0 = cb.build(dev)
    t0 = time.perf_counter()
    moved = cb.update_transforms(s0, {sid: tf.translate([-0.4, 0.2, 0.3])})
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    fresh = cb.build(dev)
    pix = torch.arange(256 * 256, dtype=torch.int32, device=dev)
    crays = Rays(*(x.contiguous() for x in
                   tracermod.gen_camera_rays(fresh, pix, 0, 0, 256, 256)[0]))
    hr = traversal8.intersect_scene(moved.geom, crays)
    hf = traversal8.intersect_scene(fresh.geom, crays)
    h0 = traversal8.intersect_scene(s0.geom, crays)
    tri_off = int((hr.valid & (hr.tri != hf.tri)).sum())
    emit(phase="refit", scene="cornell_box", size=256, refit_seconds=refit_s,
         hits=int(hr.valid.sum()), t_identical=bool(torch.equal(hr.t, hf.t)),
         tri_differs=tri_off, moved_pixels=int((h0.tri != hf.tri).sum()))
    if not (torch.equal(hr.valid, hf.valid) and torch.equal(hr.t, hf.t)):
        fail("the refit Cornell box's hits differ from a fresh build's")
    # skinning on the card against the CPU
    rng = np.random.default_rng(31)
    V, J = 65536, 64
    pos = rng.normal(size=(V, 3)).astype(np.float32)
    ids = rng.integers(0, J, (V, 4)).astype(np.int32)
    wts = rng.random((V, 4)).astype(np.float32)
    wts /= wts.sum(1, keepdims=True)
    mats = np.tile(np.eye(4, dtype=np.float32), (J, 1, 1))
    mats[:, :3, :] += 0.3 * rng.normal(size=(J, 3, 4)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (pos, ids, wts, mats)]
    got = animation.skin_vertices(*(a.to(dev) for a in args))
    ref = animation.skin_vertices(*args)
    err = float((got.cpu() - ref).abs().max())
    emit(phase="skin", vertices=V, joints=J, max_abs_err=err, limit=SKIN_LIMIT,
         ms=cuda_median_ms(lambda: animation.skin_vertices(*(a.to(dev) for a in args))))
    if not err < SKIN_LIMIT:
        fail(f"skin_vertices on the card differs from the CPU: {err}")
    return out


# ---------------------------------------------------------------------------
# the loader slice (loader_phases, L1-L3): scene files written here and
# loaded through the port's scene/loader/
# ---------------------------------------------------------------------------

def _xml_film(size):
    return (f'<film type="hdrfilm"><integer name="width" value="{size}"/>'
            f'<integer name="height" value="{size}"/></film>')


def _xml_shape(kind, body, transform=""):
    tw = f'<transform name="toWorld">{transform}</transform>' if transform else ""
    return f'  <shape type="{kind}">{body}{tw}</shape>\n'


def cornell_xml(size, max_depth=6):
    """example_scenes.cornell_box as a Mitsuba file: the walls, the light
    and the cube as rectangle and cube shapes with the same transforms and
    colours (XML applies its transforms in order, so scale, rotate,
    translate compose as tf.compose(translate, rotate, scale)), the light's
    radiance (17, 12, 4) on a 0.25-scaled rectangle, and the sphere as a
    sphere shape (radius 0.35, the loader's 32 x 64 tessellation)."""
    walls = (("white", '<rotate x="1" angle="-90"/><translate y="-1"/>'),
             ("white", '<rotate x="1" angle="90"/><translate y="1"/>'),
             ("white", '<rotate y="1" angle="180"/><translate z="1"/>'),
             ("red", '<rotate y="1" angle="90"/><translate x="-1"/>'),
             ("green", '<rotate y="1" angle="-90"/><translate x="1"/>'))
    s = ['<?xml version="1.0"?>\n<scene version="0.5.0">\n',
         f'  <integrator type="path"><integer name="maxDepth" value="{max_depth}"/>'
         '</integrator>\n',
         '  <sensor type="perspective"><float name="fov" value="32"/>'
         '<float name="nearClip" value="0.001"/><float name="farClip" value="10000000"/>'
         '<transform name="toWorld"><lookat origin="0, 0, -3.5" target="0, 0, 0" '
         f'up="0, 1, 0"/></transform>{_xml_film(size)}</sensor>\n']
    for name, rgb in (("white", "0.725, 0.71, 0.68"), ("red", "0.63, 0.065, 0.05"),
                      ("green", "0.14, 0.45, 0.091"), ("black", "0, 0, 0")):
        s.append(f'  <bsdf type="diffuse" id="{name}"><rgb name="reflectance" '
                 f'value="{rgb}"/></bsdf>\n')
    for mat, t in walls:
        s.append(_xml_shape("rectangle", f'<ref id="{mat}"/>', t))
    s.append(_xml_shape("rectangle", '<ref id="black"/><emitter type="area">'
                        '<rgb name="radiance" value="17, 12, 4"/></emitter>',
                        '<scale value="0.25"/><rotate x="1" angle="90"/>'
                        '<translate y="0.995"/>'))
    s.append(_xml_shape("sphere", '<float name="radius" value="0.35"/><point '
                        'name="center" x="-0.4" y="-0.65" z="0.3"/><ref id="white"/>'))
    s.append(_xml_shape("cube", '<ref id="white"/>',
                        '<scale x="0.25" y="0.3" z="0.25"/><rotate y="1" angle="20"/>'
                        '<translate x="0.45" y="-0.7" z="-0.2"/>'))
    s.append("</scene>\n")
    return "".join(s)


_IOR15 = '<float name="intIOR" value="1.5"/><float name="extIOR" value="1.0"/>'
_IOR149 = '<float name="intIOR" value="1.49"/><float name="extIOR" value="1.0"/>'
_GGX = '<string name="distribution" value="ggx"/>'
# one BSDF per type id, in schema order; the parameters of tests/test_bsdf.py
# where it has them (hk takes the loader's defaults), with the adapters: a
# twosided diffuse, a coating over a rough conductor, a rough coating over
# a diffuse, a blend of plastic and a rough conductor
MATERIAL_BSDFS = (
    '<bsdf type="twosided"><bsdf type="diffuse"><rgb name="reflectance" '
    'value="0.7, 0.5, 0.3"/></bsdf></bsdf>',
    '<bsdf type="roughdiffuse"><rgb name="reflectance" value="0.6, 0.6, 0.6"/>'
    '<float name="alpha" value="0.3"/></bsdf>',
    f'<bsdf type="dielectric">{_IOR15}</bsdf>',
    f'<bsdf type="thindielectric">{_IOR15}</bsdf>',
    f'<bsdf type="roughdielectric"><float name="alpha" value="0.3"/>{_GGX}{_IOR15}</bsdf>',
    '<bsdf type="conductor"><string name="material" value="cu"/></bsdf>',
    f'<bsdf type="roughconductor"><float name="alpha" value="0.3"/>{_GGX}'
    '<string name="material" value="au"/></bsdf>',
    f'<bsdf type="plastic"><rgb name="diffuseReflectance" value="0.5, 0.2, 0.1"/>'
    f'{_IOR149}</bsdf>',
    f'<bsdf type="roughplastic"><float name="alpha" value="0.3"/>{_GGX}'
    f'<rgb name="diffuseReflectance" value="0.5, 0.2, 0.1"/>{_IOR149}</bsdf>',
    '<bsdf type="phong"><rgb name="specularReflectance" value="0.4, 0.4, 0.4"/>'
    '<rgb name="diffuseReflectance" value="0.3, 0.3, 0.3"/>'
    '<float name="exponent" value="40"/></bsdf>',
    '<bsdf type="ward"><rgb name="specularReflectance" value="0.4, 0.4, 0.4"/>'
    '<rgb name="diffuseReflectance" value="0.3, 0.3, 0.3"/>'
    '<float name="alphaU" value="0.25"/><float name="alphaV" value="0.15"/></bsdf>',
    '<bsdf type="hk"/>',
    f'<bsdf type="coating">{_IOR149}<rgb name="sigmaA" value="0.1, 0.1, 0.1"/>'
    '<float name="thickness" value="1"/><bsdf type="roughconductor">'
    f'<float name="alpha" value="0.2"/>{_GGX}<string name="material" value="cu"/>'
    '</bsdf></bsdf>',
    f'<bsdf type="roughcoating"><float name="alpha" value="0.25"/>{_GGX}{_IOR149}'
    '<rgb name="sigmaA" value="0.1, 0.1, 0.1"/><float name="thickness" value="1"/>'
    '<bsdf type="diffuse"><rgb name="reflectance" value="0.6, 0.4, 0.3"/></bsdf></bsdf>',
    '<bsdf type="blendbsdf"><float name="weight" value="0.4"/><bsdf type="plastic">'
    '<rgb name="diffuseReflectance" value="0.8, 0.2, 0.2"/></bsdf>'
    '<bsdf type="roughconductor"><float name="alpha" value="0.3"/></bsdf></bsdf>',
    '<bsdf type="null"/>',
)


def materials_xml(size, max_depth=5):
    """A 4 x 4 grid of spheres (radius 0.3, the loader's 32 x 64
    tessellation), one for each of the 16 BSDF types, over a diffuse floor,
    lit by a rectangle whose radiance is a 6500 K blackbody and by a
    sun-and-sky environment."""
    s = ['<?xml version="1.0"?>\n<scene version="0.5.0">\n',
         f'  <integrator type="path"><integer name="maxDepth" value="{max_depth}"/>'
         '</integrator>\n',
         '  <sensor type="perspective"><float name="fov" value="45"/>'
         '<transform name="toWorld"><lookat origin="0, 4, -5" target="0, 0.2, 0" '
         f'up="0, 1, 0"/></transform>{_xml_film(size)}</sensor>\n',
         _xml_shape("rectangle", '<bsdf type="diffuse"><rgb name="reflectance" '
                    'value="0.5, 0.5, 0.5"/></bsdf>',
                    '<scale value="4"/><rotate x="1" angle="-90"/>'),
         _xml_shape("rectangle", '<bsdf type="diffuse"><rgb name="reflectance" '
                    'value="0, 0, 0"/></bsdf><emitter type="area"><blackbody '
                    'name="radiance" temperature="6500"/></emitter>',
                    '<rotate x="1" angle="90"/><translate y="3"/>'),
         '  <emitter type="sunsky"><vector name="sunDirection" x="0.35" y="0.7" '
         'z="0.45"/><float name="turbidity" value="3"/></emitter>\n']
    for t, bsdf in enumerate(MATERIAL_BSDFS):
        x, z = -1.5 + (t % 4), -1.5 + (t // 4)
        s.append(_xml_shape("sphere", f'<float name="radius" value="0.3"/><point '
                            f'name="center" x="{x}" y="0.3" z="{z}"/>{bsdf}'))
    s.append("</scene>\n")
    return "".join(s)


def write_serialized(path, meshes, level=1):
    """A Mitsuba .serialized file (version 4, single precision) holding
    `meshes` [(v, f, n, uv)], one zlib stream each, then the offset table
    and the mesh count (the layout scene/loader/serialized.py reads)."""
    import struct
    import zlib
    out = bytearray()
    offsets = []
    for v, f, n, uv in meshes:
        offsets.append(len(out))
        blob = (struct.pack("<I", 0x1003) + b"mesh\0"          # normals, uv, f32
                + struct.pack("<QQ", v.shape[0], f.shape[0])
                + np.ascontiguousarray(v, "<f4").tobytes()
                + np.ascontiguousarray(n, "<f4").tobytes()
                + np.ascontiguousarray(uv, "<f4").tobytes()
                + np.ascontiguousarray(f, "<u4").tobytes())
        out += struct.pack("<HH", 0x041C, 4) + zlib.compress(blob, level)
    out += struct.pack(f"<{len(offsets)}Q", *offsets) + struct.pack("<I", len(offsets))
    with open(path, "wb") as fh:
        fh.write(out)


# the San Miguel stand-in's four materials as the file's BSDFs, in the
# stand-in's material order (ground, walls and columns, leaves, trunks)
SM_BSDFS = (
    f'<bsdf type="roughplastic"><float name="alpha" value="0.2"/>{_GGX}'
    f'<rgb name="diffuseReflectance" value="0.45, 0.4, 0.33"/>{_IOR149}</bsdf>',
    f'<bsdf type="coating">{_IOR149}<rgb name="sigmaA" value="0.05, 0.05, 0.05"/>'
    '<bsdf type="diffuse"><rgb name="reflectance" value="0.55, 0.45, 0.35"/>'
    '</bsdf></bsdf>',
    '<bsdf type="twosided"><bsdf type="diffuse"><rgb name="reflectance" '
    'value="0.12, 0.35, 0.08"/></bsdf></bsdf>',
    '<bsdf type="roughdiffuse"><rgb name="reflectance" value="0.25, 0.16, 0.1"/>'
    '<float name="alpha" value="0.5"/></bsdf>',
)


def sm_loader_files(dirpath, size, example_scenes, shapes):
    """The San Miguel stand-in's nodes in world space, merged by material
    into one mesh each (uv zeros where a node has none), written to one
    .serialized file, and an XML that loads each by shapeIndex with the
    stand-in's camera and a sun-and-sky emitter. Returns (xml path,
    [(v, f, n, uv)] as written)."""
    sc = example_scenes.san_miguel_stand_in(size, size)
    groups = {}
    for node in sc._nodes:
        m = node.mesh.transformed(node.to_world)
        if m.uv is None:
            m = m._replace(uv=np.zeros((m.v.shape[0], 2), np.float32))
        groups.setdefault(node.material, []).append(m)
    meshes = []
    for mat in sorted(groups):
        m = shapes.merge(groups[mat])
        meshes.append((m.v.astype(np.float32), m.f.astype(np.int32),
                       m.n.astype(np.float32), m.uv.astype(np.float32)))
    write_serialized(os.path.join(dirpath, "sm.serialized"), meshes)
    s = ['<?xml version="1.0"?>\n<scene version="0.5.0">\n',
         '  <integrator type="path"><integer name="maxDepth" value="5"/></integrator>\n',
         '  <sensor type="perspective"><float name="fov" value="55"/>'
         '<float name="nearClip" value="0.001"/><float name="farClip" value="10000000"/>'
         '<transform name="toWorld"><lookat origin="8.0, 2.3, -13.2" '
         f'target="-6.0, 2.8, 8.0" up="0, 1, 0"/></transform>{_xml_film(size)}</sensor>\n',
         '  <emitter type="sunsky"><vector name="sunDirection" x="0.45" y="0.75" '
         'z="-0.49"/></emitter>\n']
    for k in range(len(meshes)):
        s.append(_xml_shape("serialized", '<string name="filename" value="sm.serialized"/>'
                            f'<integer name="shapeIndex" value="{k}"/>{SM_BSDFS[k]}'))
    s.append("</scene>\n")
    path = os.path.join(dirpath, "sm.xml")
    with open(path, "w") as fh:
        fh.write("".join(s))
    return path, meshes


def loader_phases(*args):
    """L1-L3, the loader slice: Mitsuba files written to a temporary
    directory (removed after, also when a phase fails), loaded through the
    port's scene/loader/ and rendered on the card. Takes _loader_phases'
    arguments after `tmp`; returns the kernel-table entries {tracer:
    {kernel: dict}}."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="loader_") as tmp:
        out = _loader_phases(tmp, *args)
        collect_cpu_sides()    # the children read the files written here
        return out


def _loader_phases(tmp, dev, card, cornell_mean, K1, K2, K3, K4, zero_counts,
                   plain_calls, pathmod, primmod, bdptmod, vcmmod, wfmod, filmmod,
                   example_scenes, traversal8, traversal_tt, mb):
    from cudatracerlib_tpu_torch.ops.traversal import Rays
    from cudatracerlib_tpu_torch.scene import shapes, sunsky
    from cudatracerlib_tpu_torch.scene.loader import images, mitsuba
    out = {}

    def counts():
        return dict(K1=K1.launches, K1_by_variant=dict(K1.launches_by_variant),
                    K1_by_design=dict(K1.launches_by_design),
                    K1_by_mode=dict(K1.launches_by_mode),
                    K2_by_v=dict(K2.launches_by_v),
                    K2_by_variant=dict(K2.launches_by_variant),
                    K3_by_v=dict(K3.launches_by_v), K4=K4.launches, plain=plain_calls())

    def write(name, text):
        path = os.path.join(tmp, name)
        with open(path, "w") as fh:
            fh.write(text)
        return path

    def finite(img, what):
        if not np.isfinite(img).all() or not img.mean() > 0.0:
            fail(f"the {what} image is not finite and non-black")

    def table_info(scene):
        g = scene.geom
        return dict(tris=scene.num_tris, rows=g.wide.shape[0],
                    top_rows=None if g.tt_top is None else g.tt_top.shape[0],
                    treelets=None if g.tt_slabs is None else g.tt_slabs.shape[0])

    def check_env(sc, want, what):
        """The loaded environment must be the image written (no fallback
        to the loader's grey stand-in)."""
        env = sc._env["image"] if sc._env is not None else None
        if env is None or env.shape != want.shape or not np.array_equal(env, want):
            fail(f"the {what} environment is not the image written")

    def pt_run(scene, size, depth, chunk, passes, what, **kw):
        tr = pathmod.PathTracer(scene, size, size, max_depth=depth, chunk_size=chunk, **kw)
        tr.do_pass()
        torch.cuda.synchronize()
        zero_counts()
        secs, rays_n = timed_passes(tr, passes)
        c = counts()
        img = filmmod.develop(tr.film).cpu().numpy()
        finite(img, what)
        capped, overflowed = (int(x) for x in tr._ovf_dev.tolist())
        if capped or overflowed or c["plain"] or c["K4"]:
            fail(f"{what}: capped {capped}, overflowed {overflowed}, counts {c}")
        K1_THREAD_LAUNCHES[f"loader {what}"] = c["K1_by_design"]["thread"]
        return tr, img, dict(seconds_per_pass=statistics.median(secs), pass_seconds=secs,
                             live_rays=int(sum(rays_n)),
                             mrays_per_s=sum(rays_n) / sum(secs) / 1e6,
                             launches=c, launches_per_pass={
                                 k: (v / passes if isinstance(v, int) else
                                     {kk: vv / passes for kk, vv in v.items()})
                                 for k, v in c.items()},
                             capped=capped, overflowed=overflowed,
                             mean_radiance=float(img.mean()), nvidia_smi=card)

    # L1. BASELINE config 1 through the loader: the Cornell box file
    t0 = time.perf_counter()
    path = write("cornell.xml", cornell_xml(LOADER_SIZE, L1_DEPTH))
    sc, settings = mitsuba.load_mitsuba(path)
    parse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = sc.build(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    info = table_info(scene)
    emit(phase="loader_load", scene="cornell.xml", parse_seconds=parse_s,
         build_seconds=build_s, settings=vars(settings), **info)
    if settings.max_depth != L1_DEPTH or (settings.width, settings.height) != (
            LOADER_SIZE, LOADER_SIZE) or scene.geom.tt_top is not None:
        fail(f"cornell.xml loaded wrong: {vars(settings)}, {info}")
    # the variant of K1 the size rule picks for the loaded table (its
    # 32 x 64 sphere makes it larger than phase 4's)
    variant = traversal8.launch_variant(scene.geom.wide)
    aov = {}
    for mode in (primmod.D_LINEAR_DEPTH, primmod.D_NORMAL_SHADE):
        tr = primmod.PrimTracer(scene, LOADER_SIZE, LOADER_SIZE, draw_mode=mode)
        tr.do_pass()
        torch.cuda.synchronize()
        zero_counts()
        secs, _ = timed_passes(tr, 1)
        c = counts()
        img = filmmod.develop(tr.film).cpu().numpy()
        if not np.isfinite(img).all() or not np.abs(img).max() > 0.0:
            fail(f"the loaded Cornell AOV {mode} is not finite and non-zero")
        aov[mode] = dict(seconds=secs[0], launches=c["K1"],
                         mrays_per_s=LOADER_SIZE ** 2 / secs[0] / 1e6)
        K1_THREAD_LAUNCHES[f"loader cornell.xml AOV {mode}"] = c["K1_by_design"]["thread"]
        if c["K1"] != 1 or c["K1_by_variant"][variant] != 1 or c["K2_by_v"].get(3) \
                or c["plain"]:
            fail(f"the loaded Cornell AOV took the wrong kernels: {c}")
    emit(phase="loader_aov", scene="cornell.xml", size=LOADER_SIZE, k1_variant=variant,
         by_mode={"linear_depth": aov[primmod.D_LINEAR_DEPTH],
                  "normal_shade": aov[primmod.D_NORMAL_SHADE]}, nvidia_smi=card)
    tr, img, r = pt_run(scene, LOADER_SIZE, L1_DEPTH, LOADER_CHUNK, LOADER_PASSES,
                        "loaded Cornell")
    gap = abs(r["mean_radiance"] - cornell_mean) / cornell_mean
    emit(phase="headline", scene="cornell.xml", tracer="PathTracer", size=LOADER_SIZE,
         max_depth=L1_DEPTH, chunk_size=LOADER_CHUNK, passes=LOADER_PASSES,
         phase4_mean=cornell_mean, mean_gap=gap, mean_limit=L1_MEAN_GAP, **r)
    if not gap < L1_MEAN_GAP:
        fail(f"the loaded Cornell box's mean is {gap:.4f} off phase 4's")
    if r["launches"]["K1_by_variant"][variant] != r["launches"]["K1"] or \
            r["launches"]["K2_by_v"].get(3):
        fail(f"the loaded Cornell PT took the wrong kernels: {r['launches']}")
    calls = record_k1(tr.do_pass, traversal8, Rays)
    out["loader_cornell"] = dict(launches_per_pass=len(calls), variant=variant,
                                 launches=r["launches"],
                                 by_mode=k1_on_calls("loader_cornell_512", calls, K1,
                                                     traversal8, mb),
                                 seconds_per_pass=r["seconds_per_pass"])
    # pool_vs_k1 on the same calls (global rows)
    pool_vs_k1_pass("loader_cornell_512", calls, K1, K4, traversal8, mb, card)
    del tr, calls, scene
    small = write("cornell32.xml", cornell_xml(LOADER_SMALL, L1_DEPTH))
    rows = {d: mitsuba.load_mitsuba(small)[0].build(d).geom.wide.shape[0]
            for d in (dev, "cpu")}
    if rows[dev] != rows["cpu"]:
        fail(f"the loaded Cornell tables differ in rows: {rows}")
    card_vs_cpu("PathTracer", lambda s: pathmod.PathTracer(s, LOADER_SMALL, LOADER_SMALL,
                                                           max_depth=L1_DEPTH),
                lambda w, h: mitsuba.load_mitsuba(small)[0], LOADER_SMALL,
                LOADER_CPU_PASSES, dev, scene="cornell.xml", rows=rows["cpu"])

    # L2. every BSDF type: the materials file
    collect_cpu_sides()
    t0 = time.perf_counter()
    path = write("materials.xml", materials_xml(L2_SIZE, L2_DEPTH))
    sc, settings = mitsuba.load_mitsuba(path)
    parse_s = time.perf_counter() - t0
    check_env(sc, sunsky.preetham_sky((0.35, 0.7, 0.45), turbidity=3.0), "materials.xml")
    t0 = time.perf_counter()
    scene = sc.build(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    info = table_info(scene)
    types = list(pathmod.scene_active_types(scene))
    emit(phase="loader_load", scene="materials.xml", parse_seconds=parse_s,
         build_seconds=build_s, bsdf_types=types,
         materials=int(scene.materials.mat_type.shape[0]), **info)
    if types != list(range(16)) or scene.geom.tt_top is None:
        fail(f"materials.xml: types {types}, split table {scene.geom.tt_top is not None}")
    out["loader_materials"] = {}
    for reg in (False, True):
        tr, img, r = pt_run(scene, L2_SIZE, L2_DEPTH, LOADER_CHUNK, L2_PASSES,
                            f"materials (regularize={reg})", regularize=reg)
        emit(phase="headline", scene="materials.xml", tracer="PathTracer",
             regularize=reg, size=L2_SIZE, max_depth=L2_DEPTH,
             chunk_size=LOADER_CHUNK, passes=L2_PASSES, **r)
        lc = r["launches"]
        if not (lc["K1"] and lc["K2_by_v"][traversal8.V_INCOHERENT]
                and lc["K3_by_v"][traversal8.V_INCOHERENT]):
            fail(f"the materials PT did not run K2, K3 and the K1 fallback: {lc}")
        if not reg:
            calls = record_kernels(tr.do_pass, traversal8, traversal_tt, Rays)
            held = hold_calls(f"loader_materials_{L2_SIZE}", calls, K1, K2, K3, traversal8,
                              traversal_tt, mb)
            out["loader_materials"] = {k: dict(v, pass_launches=r["launches_per_pass"],
                                               seconds_per_pass=r["seconds_per_pass"])
                                       for k, v in held.items()}
            del calls
        del tr
    del scene
    small = write("materials_small.xml", materials_xml(L2_SMALL, L2_DEPTH))
    load_small = lambda w, h: mitsuba.load_mitsuba(small)[0]
    sz = L2_SMALL
    for name, make, limit in (
            ("BDPT", lambda s: bdptmod.BDPT(s, sz, sz, max_depth=L2_SMALL_DEPTH),
             CARD_CPU_LIMIT),
            ("VCM", lambda s: vcmmod.VCM(s, sz, sz, max_depth=L2_SMALL_DEPTH),
             VCM_CARD_CPU_LIMIT),
            ("WavefrontPT_regularized", lambda s: wfmod.WavefrontPT(
                s, sz, sz, max_depth=L2_DEPTH, regularize=True), CARD_CPU_LIMIT)):
        card_vs_cpu(name, make, load_small, sz, 1, dev, limit=limit,
                    scene="materials.xml")

    # L3. the loader at San Miguel scale: one serialized file
    collect_cpu_sides()
    t0 = time.perf_counter()
    path, written = sm_loader_files(tmp, L3_SIZE, example_scenes, shapes)
    write_s = time.perf_counter() - t0
    t_l3 = time.perf_counter()
    sc, settings = mitsuba.load_mitsuba(path)
    parse_s = time.perf_counter() - t_l3
    n_tris = sum(f.shape[0] for _, f, _, _ in written)
    loaded = [node.mesh for node in sc._nodes]
    same_arrays = len(loaded) == len(written) and all(
        np.array_equal(m.v, v) and np.array_equal(m.f, f) and np.array_equal(m.n, n)
        and np.array_equal(m.uv, uv) for m, (v, f, n, uv) in zip(loaded, written))
    env_ok = sc._env is not None
    check_env(sc, sunsky.preetham_sky((0.45, 0.75, -0.49)), "sm.xml")
    t0 = time.perf_counter()
    scene = sc.build(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    info = table_info(scene)
    emit(phase="loader_load", scene="sm.xml", write_seconds=write_s,
         parse_seconds=parse_s, mtris_per_s=n_tris / parse_s / 1e6,
         build_seconds=build_s, bvh_seconds=scene.host["build_seconds"]["bvh"],
         treelet_seconds=scene.host["build_seconds"]["treelet"],
         meshes=len(written), arrays_equal=same_arrays, env=env_ok,
         file_mb=os.path.getsize(os.path.join(tmp, "sm.serialized")) / 2 ** 20, **info)
    if not same_arrays:
        fail("the loaded San Miguel arrays differ from the ones written")
    if n_tris != scene.num_tris or scene.geom.tt_top is None:
        fail(f"sm.xml: {scene.num_tris} triangles built of {n_tris}, {info}")
    tr = pathmod.PathTracer(scene, L3_SIZE, L3_SIZE, max_depth=L3_DEPTH,
                            chunk_size=L3_CHUNK)
    torch.cuda.synchronize()
    zero_counts()
    secs, rays_n = timed_passes(tr, 1)
    c = counts()
    img = filmmod.develop(tr.film).cpu().numpy()
    finite(img, "loaded San Miguel")
    capped, overflowed = (int(x) for x in tr._ovf_dev.tolist())
    l3_s = time.perf_counter() - t_l3
    emit(phase="headline", scene="sm.xml", tracer="PathTracer", size=L3_SIZE,
         max_depth=L3_DEPTH, chunk_size=L3_CHUNK, passes=1, seconds_per_pass=secs[0],
         live_rays=int(sum(rays_n)), mrays_per_s=sum(rays_n) / sum(secs) / 1e6,
         launches=c, capped=capped, overflowed=overflowed,
         mean_radiance=float(img.mean()), l3_seconds=l3_s, l3_limit=L3_SECONDS,
         nvidia_smi=card)
    if capped or overflowed or c["plain"] or c["K4"] or not (
            c["K1"] and c["K2_by_v"][traversal8.V_INCOHERENT]
            and c["K3_by_v"][traversal8.V_INCOHERENT]):
        fail(f"the loaded San Miguel pass took the wrong kernels: {c}, "
             f"capped {capped}, overflowed {overflowed}")
    if not l3_s < L3_SECONDS:
        fail(f"L3 took {l3_s:.1f} s")
    # the first traversal of a pass (camera rays merged with no shadow
    # rays): its K2, K3 and K1 calls held to the plain versions
    calls = record_kernels(tr.do_pass, traversal8, traversal_tt, Rays, window=(0, 3))
    held = hold_calls("loader_sm_1024", calls, K1, K2, K3, traversal8, traversal_tt, mb)
    out["loader_sm"] = {k: dict(v, pass_launches={"K1": c["K1"], "K2_by_v": c["K2_by_v"],
                                                   "K3_by_v": c["K3_by_v"]},
                                seconds_per_pass=secs[0]) for k, v in held.items()}
    del tr, calls, scene, sc, written, loaded

    # the loaders' files round trip: an environment map written as .hdr
    env = np.random.default_rng(5).random((16, 32, 3)).astype(np.float32) * 4
    images.write_hdr(os.path.join(tmp, "env.hdr"), env)
    want = images.load_hdr(os.path.join(tmp, "env.hdr"))
    xml = write("env.xml", '<scene version="0.5.0"><emitter type="envmap"><string '
                'name="filename" value="env.hdr"/></emitter></scene>')
    sc, _ = mitsuba.load_mitsuba(xml)
    check_env(sc, want, "env.xml")
    emit(phase="loader_env", scene="env.xml", shape=list(want.shape),
         max_rel_err=float(np.abs(want - env).max() / env.max()), equal_to_written=True)
    return out


# the multi-device slice (phase S): sizes of the sharded passes and tracers
PAR_SIZE = 512          # S1: Cornell, depth 6
PAR_LP_SIZE = 256       # S2, S3: the glass and fog boxes, depth 6
PAR_PHOTONS = 65536     # S3: bench.py's config 5
PAR_SM_DEPTH = 5        # S4: San Miguel 1024^2 (phase 7's scene)
PAR_CLASS_SIZE = 64     # S5: the five sharded tracers, 2 passes each
PAR_CLASS_PASSES = 2
PAR_CLI_SIZE = 128      # the CLI's PPM, 2 passes
PAR_CLI_SECONDS = 300


def _png_pixels(path):
    """The pixels of a PNG that film.save_png wrote (8-bit RGB, filter 0;
    the card's machine has no imaging library)."""
    import struct
    import zlib
    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"{path} is not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    return raw[:, 1:].reshape(h, w, 3)


def parallel_phases(dev, card, sm_scene, K1, K2, K3, K4, zero_counts, plain_calls,
                    traversal8, traversal_tt, mb):
    """S. multi-device rendering (parallel/render.py) on a world of one rank
    through NCCL (make_mesh: the machine has one card): each sharded pass
    and tracer against its unsharded counterpart on the same seeds (mean
    relative error under CARD_CPU_LIMIT, PPM's and VCM's limits for PPM and
    VCM), every launch counted with the counts zeroed just before and read
    just after each run (no plain version on a CUDA tensor, no K4), K1's
    launches by mode equal to the unsharded pass's, seconds of each run
    beside the unsharded run's.
    S1: sharded_pt_pass on Cornell PAR_SIZE^2, depth 6, one pass, the
    row-sharded film and reduce_film=True; S2: sharded_lt_pass,
    sharded_bdpt_pass and sharded_vcm_pass on the glass Cornell box
    PAR_LP_SIZE^2, depth 6, with and without splat parts (K1 by mode: 6 + 7
    for LT, 11 + 41 for BDPT and VCM); S3: sharded_ppm_pass on the fog
    Cornell box PAR_LP_SIZE^2, PAR_PHOTONS photons, beamgrid, then one pass
    of ShardedPPMTracer with adaptive radii (per-pixel r2 within 1e-6);
    S4: sharded_pt_pass on phase 7's San Miguel 1024^2, depth PAR_SM_DEPTH
    (K2, K3, the K1 fallback); one pass of S1, S2's BDPT and S4's first
    traversal recorded and every call held to the plain versions
    (record_kernels, hold_calls); S5: the five sharded tracers rendering
    PAR_CLASS_PASSES passes at PAR_CLASS_SIZE^2, develop() (the splat
    parts folded; render() leaves them out, as the JAX package's) against
    the unsharded ones' render() (the glass box; the PT on Cornell). Last
    the CLI in a subprocess: PPM on Cornell PAR_CLI_SIZE^2, 2 passes,
    alone and with --devices 1 (the PNGs within one level, a non-zero time
    in the log; with --devices the CLI writes the film without splat
    parts, as the JAX CLI, and PPM has none), and --devices 2 must raise. Returns
    {"launches": {case: counts}, "held": {case: hold_calls's result}}."""
    import torch.distributed as dist
    from cudatracerlib_tpu_torch import cli
    from cudatracerlib_tpu_torch.models import bdpt as bdptmod
    from cudatracerlib_tpu_torch.models import film as filmmod
    from cudatracerlib_tpu_torch.models import lighttracer as ltmod
    from cudatracerlib_tpu_torch.models import path as pathmod
    from cudatracerlib_tpu_torch.models import ppm as ppmmod
    from cudatracerlib_tpu_torch.models import vcm as vcmmod
    from cudatracerlib_tpu_torch.ops.traversal import Rays
    from cudatracerlib_tpu_torch.parallel import render as prender
    from cudatracerlib_tpu_torch.utils import example_scenes

    mesh = prender.make_mesh(1, device=dev)
    emit(phase="parallel_mesh", backend=dist.get_backend(), world=mesh.size,
         rank=mesh.rank, device=str(mesh.device), nccl=".".join(
             str(v) for v in torch.cuda.nccl.version()))
    if dist.get_backend() != "nccl" or mesh.device.type != "cuda":
        fail(f"the mesh is not NCCL on the card: {dist.get_backend()}, {mesh.device}")
    out = dict(launches={}, held={})

    def counts():
        return dict(K1=K1.launches, K1_by_variant=dict(K1.launches_by_variant),
                    K1_by_design=dict(K1.launches_by_design),
                    K1_by_mode=dict(K1.launches_by_mode), K2=K2.launches,
                    K2_by_variant=dict(K2.launches_by_variant), K3=K3.launches,
                    K4=K4.launches, plain=plain_calls())

    def run(fn):
        """fn() with the counts zeroed just before and read just after:
        (its result, seconds to torch.cuda.synchronize, counts)."""
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, counts()

    def image(film):
        return filmmod.develop(film._replace(n_passes=1.0)).cpu().numpy()

    def check(case, got, want, limit, same_modes=True, **extra):
        """A sharded run (image, seconds, counts) against its unsharded one."""
        (a, s_a, c_a), (b, s_b, c_b) = got, want
        for img in (a, b):
            if not np.isfinite(img).all() or not img.mean() > 0.0:
                fail(f"the {case} image is not finite and non-black")
        err = float(np.abs(a - b).mean() / max(np.abs(b).mean(), 1e-9))
        out["launches"][case] = c_a
        emit(phase="parallel", case=case, rel_err=err, limit=limit, seconds=s_a,
             unsharded_seconds=s_b, launches=c_a, unsharded_launches=c_b,
             nvidia_smi=card, **extra)
        if not err < limit:
            fail(f"the sharded {case} differs from the unsharded run: {err}")
        if c_a["plain"] or c_a["K4"] or c_a["K1"] <= 0:
            fail(f"the sharded {case} took the wrong kernels: {c_a}")
        if same_modes and c_a["K1_by_mode"] != c_b["K1_by_mode"]:
            fail(f"the sharded {case}'s K1 launches by mode {c_a['K1_by_mode']} "
                 f"differ from the unsharded {c_b['K1_by_mode']}")

    def modes(c, closest, any_hit, case):
        if c["K1_by_mode"] != dict(closest=closest, any_hit=any_hit, mixed=0):
            fail(f"{case}: K1 launches by mode {c['K1_by_mode']}, expected "
                 f"{closest} + {any_hit}")

    # S1. the path tracer on Cornell, both film layouts
    n = PAR_SIZE
    scene = example_scenes.cornell_box(n, n).build(dev)
    tr = pathmod.PathTracer(scene, n, n, max_depth=6, chunk_size=n * n)
    unsharded = run(lambda: tr.render_pass(scene, filmmod.new_film(n, n, dev), 0))
    unsharded = (image(unsharded[0]),) + unsharded[1:]
    for layout in ("rows", "reduce_film"):
        def pt():
            film = filmmod.new_film(n, n, dev)
            if layout == "rows":
                film = prender._film_specs(film, mesh)
            film = prender.sharded_pt_pass(scene, film, 0, mesh, n, n, max_depth=6,
                                           reduce_film=layout == "reduce_film")
            return prender.gather_film(film, mesh) if layout == "rows" else film
        film, secs, c = run(pt)
        check(f"pt_cornell_{n}_{layout}", (image(film), secs, c), unsharded,
              CARD_CPU_LIMIT)
    calls = record_kernels(lambda: prender.sharded_pt_pass(
        scene, prender._film_specs(filmmod.new_film(n, n, dev), mesh), 0, mesh, n, n,
        max_depth=6), traversal8, traversal_tt, Rays)
    out["held"]["pt_cornell"] = hold_calls(f"parallel_pt_cornell_{n}", calls, K1, K2,
                                           K3, traversal8, traversal_tt, mb)
    del tr, scene, calls

    # S2. the light tracer, BDPT and VCM on the glass box, both layouts
    n = PAR_LP_SIZE
    scene = example_scenes.cornell_glass(n, n).build(dev)
    types = pathmod.scene_active_types(scene)
    radius = vcmmod.VCM(scene, n, n, max_depth=LP_DEPTH).initial_radius

    def single(name):
        film = filmmod.new_film(n, n, dev)
        if name == "lt":
            return ltmod.lt_pass(scene, film, 0, n * n, LP_DEPTH, types)
        if name == "bdpt":
            return bdptmod.bdpt_pass(scene, film, 0, n, n, LP_DEPTH, types)[0]
        return vcmmod.vcm_pass(scene, film, 0, n, n, LP_DEPTH, types, radius)[0]

    def sharded(name, parts):
        film = filmmod.new_film(n, n, dev)
        p = prender.new_splat_parts(mesh, n, n) if parts else None
        if name == "lt":
            res = prender.sharded_lt_pass(scene, film, 0, mesh, n, n,
                                          max_depth=LP_DEPTH, splat_parts=p)
            return prender.fold_splat_parts(film, res, mesh) if parts else res
        if parts:
            film = prender._film_specs(film, mesh)
        kw = dict(max_depth=LP_DEPTH, splat_parts=p)
        res = (prender.sharded_bdpt_pass(scene, film, 0, mesh, n, n, **kw)
               if name == "bdpt" else
               prender.sharded_vcm_pass(scene, film, 0, mesh, n, n, radius, **kw))
        if not parts:
            return res
        return prender.fold_splat_parts(prender.gather_film(res[0], mesh), res[1], mesh)

    want_modes = dict(lt=(LP_DEPTH, LP_DEPTH + 1),
                      bdpt=(11, 41), vcm=(11, 41))
    for name in ("lt", "bdpt", "vcm"):
        film, secs, c = run(lambda: single(name))
        modes(c, *want_modes[name], f"unsharded {name}")
        unsharded = (image(film), secs, c)
        for parts in (True, False):
            case = f"{name}_glass_{n}_{'parts' if parts else 'all_reduce'}"
            film, secs, c = run(lambda: sharded(name, parts))
            modes(c, *want_modes[name], case)
            check(case, (image(film), secs, c), unsharded,
                  VCM_CARD_CPU_LIMIT if name == "vcm" else CARD_CPU_LIMIT)
    calls = record_kernels(lambda: sharded("bdpt", True), traversal8, traversal_tt, Rays)
    out["held"]["bdpt_glass"] = hold_calls(f"parallel_bdpt_glass_{n}", calls, K1, K2,
                                           K3, traversal8, traversal_tt, mb)
    del scene, calls

    # S3. PPM on the fog box (beamgrid), then adaptive radii
    scene = example_scenes.fog_cornell(n, n).build(dev)
    kw = dict(n_photons=PAR_PHOTONS, max_depth=MEDIA_DEPTH)
    tr = ppmmod.PPMTracer(scene, n, n, **kw)
    r0 = tr.radius
    film, secs, c = run(lambda: tr.render_pass(scene, filmmod.new_film(n, n, dev), 0))
    unsharded = (image(film), secs, c)
    film, secs, c = run(lambda: prender.sharded_ppm_pass(
        scene, prender._film_specs(filmmod.new_film(n, n, dev), mesh), 0, mesh, n, n,
        radius=r0, with_volume=True, vol_est=tr.vol_est,
        vol_max_per_cell=tr.vol_max_per_cell, **kw))
    check(f"ppm_fog_{n}_beamgrid", (image(prender.gather_film(film, mesh)), secs, c),
          unsharded, PPM_CARD_CPU_LIMIT, photons=PAR_PHOTONS, radius=r0)
    trs = [cls(scene, n, n, adaptive_radii=True, **kw, **extra)
           for cls, extra in ((ppmmod.PPMTracer, {}),
                              (prender.ShardedPPMTracer, dict(mesh=mesh)))]
    (img_u, s_u, c_u), (img_s, s_s, c_s) = [run(lambda: tr_.render(1)) for tr_ in trs]
    r2 = [trs[0]._ppm_state.r2, trs[1].gathered_state().r2]
    r2_err = float(((r2[1] - r2[0]).abs() / r2[0].abs().clamp_min(1e-30)).max())
    check(f"ppm_fog_{n}_adaptive", (img_s.cpu().numpy(), s_s, c_s),
          (img_u.cpu().numpy(), s_u, c_u), PPM_CARD_CPU_LIMIT, r2_max_rel=r2_err)
    if not r2_err < 1e-6:
        fail(f"the sharded adaptive radii differ from the unsharded ones: {r2_err}")
    del scene, tr, trs, r2

    # S4. San Miguel 1024^2 (phase 7's scene): K2, K3 and the K1 fallback
    n = SM_SIZE
    tr = pathmod.PathTracer(sm_scene, n, n, max_depth=PAR_SM_DEPTH, chunk_size=131072)
    film, secs, c = run(lambda: tr.render_pass(sm_scene, filmmod.new_film(n, n, dev), 0))
    unsharded = (image(film), secs, c)
    torch.cuda.reset_peak_memory_stats()
    film, secs, c = run(lambda: prender.sharded_pt_pass(
        sm_scene, prender._film_specs(filmmod.new_film(n, n, dev), mesh), 0, mesh, n, n,
        max_depth=PAR_SM_DEPTH))
    check(f"pt_san_miguel_{n}", (image(prender.gather_film(film, mesh)), secs, c),
          unsharded, CARD_CPU_LIMIT, same_modes=False,
          peak_gb=torch.cuda.max_memory_allocated() / 2**30)
    if (min(c["K2"], c["K3"]) <= 0 or c["K2_by_variant"]["shared"] != c["K2"]
            or c["K1_by_variant"]["global"] != c["K1"]
            or c["K1_by_design"]["group"] != c["K1"]):
        fail(f"the sharded San Miguel pass took the wrong kernels: {c}")
    calls = record_kernels(lambda: prender.sharded_pt_pass(
        sm_scene, prender._film_specs(filmmod.new_film(n, n, dev), mesh), 0, mesh, n, n,
        max_depth=PAR_SM_DEPTH), traversal8, traversal_tt, Rays, window=(0, 3))
    out["held"]["pt_san_miguel"] = hold_calls(f"parallel_pt_san_miguel_{n}", calls,
                                              K1, K2, K3, traversal8, traversal_tt, mb)
    del tr, film, calls

    # S5. the five sharded tracers against the unsharded ones
    n = PAR_CLASS_SIZE
    for name, cls, single_cls, scene_fn, extra, limit in (
            ("ShardedPathTracer", prender.ShardedPathTracer, pathmod.PathTracer,
             example_scenes.cornell_box, {}, CARD_CPU_LIMIT),
            ("ShardedBDPT", prender.ShardedBDPT, bdptmod.BDPT,
             example_scenes.cornell_glass, {}, CARD_CPU_LIMIT),
            ("ShardedLightTracer", prender.ShardedLightTracer, ltmod.LightTracer,
             example_scenes.cornell_glass, {}, CARD_CPU_LIMIT),
            ("ShardedPPMTracer", prender.ShardedPPMTracer, ppmmod.PPMTracer,
             example_scenes.cornell_glass, {}, PPM_CARD_CPU_LIMIT),
            ("ShardedVCM", prender.ShardedVCM, vcmmod.VCM,
             example_scenes.cornell_glass, {}, VCM_CARD_CPU_LIMIT)):
        scene = scene_fn(n, n).build(dev)

        def sharded_develop():
            tr = cls(scene, n, n, mesh=mesh, max_depth=LP_DEPTH, **extra)
            tr.render(PAR_CLASS_PASSES)
            return tr.develop()
        got = run(sharded_develop)
        want = run(lambda: single_cls(scene, n, n, max_depth=LP_DEPTH,
                                      **extra).render(PAR_CLASS_PASSES))
        check(f"{name}_{n}", (got[0].cpu().numpy(),) + got[1:],
              (want[0].cpu().numpy(),) + want[1:], limit, passes=PAR_CLASS_PASSES)
        del scene

    # the CLI: PPM alone, over a world of one rank, and two ranks refused
    import tempfile
    with tempfile.TemporaryDirectory(prefix="cli_") as tmp:
        pngs, logs = [], []
        for extra in ([], ["--devices", "1"]):
            png = os.path.join(tmp, f"ppm{len(pngs)}.png")
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "-m", "cudatracerlib_tpu_torch", "cornell", "-t", "PPM",
                 "-p", "2", "--res", f"{PAR_CLI_SIZE}x{PAR_CLI_SIZE}", "-o", png, *extra],
                cwd=HERE, capture_output=True, text=True, timeout=PAR_CLI_SECONDS)
            done = [ln for ln in p.stdout.splitlines() if ln.startswith("[done]")]
            m = re.search(r" in ([0-9.]+)s", done[-1]) if done else None
            logs.append(dict(args=extra, returncode=p.returncode,
                             wall_s=time.perf_counter() - t0,
                             render_s=float(m.group(1)) if m else None,
                             done=done[-1] if done else None))
            if p.returncode or not m or not float(m.group(1)) > 0 or not os.path.exists(png):
                fail(f"the CLI {extra} failed: {p.returncode}\n{p.stdout[-2000:]}\n"
                     f"{p.stderr[-4000:]}")
            pngs.append(_png_pixels(png).astype(int))
        diff = int(np.abs(pngs[0] - pngs[1]).max())
        try:
            cli.main(["cornell", "-t", "PPM", "-p", "1", "--res", "16x16", "-o",
                      os.path.join(tmp, "two.png"), "--devices", "2"])
        except RuntimeError as e:
            refused = str(e)
        else:
            fail("--devices 2 on one card did not raise")
    emit(phase="parallel_cli", runs=logs, png_max_level_diff=diff,
         png_shape=list(pngs[0].shape), devices_2_refused=refused)
    if diff > 1 or not pngs[0].max() > 0:
        fail(f"the CLI's PPM images differ by {diff} levels (or are black)")
    dist.destroy_process_group()
    return out


def phase8_alone():
    """Phase 8's microbenchmarks alone on the card (about 2 minutes), on
    inputs recorded as main() records them: one GameTracer frame and one
    WavefrontPT pass on the San Miguel stand-in at 1024^2 (RecordPsf and
    psf_take, RecordTake), veach-mis's root and leaf row and its bounce
    wavefront with 40% of the rays dead; prints utils/microbench.measure's result as one JSON line:

        python3 -c "import chip_smoke; chip_smoke.phase8_alone()"
    """
    from cudatracerlib_tpu_torch.models import game, tracer, wavefront
    from cudatracerlib_tpu_torch.ops import cuda_build, psf, texture, traversal8
    from cudatracerlib_tpu_torch.ops.traversal import Rays
    from cudatracerlib_tpu_torch.utils import example_scenes
    from cudatracerlib_tpu_torch.utils import microbench as mb
    if not torch.cuda.is_available():
        fail("no CUDA device")
    dev = torch.device("cuda", 0)
    cuda_build.build("traversal8.cu", "traversal_tt.cu", "microbench.cu", "psf_gather.cu")
    sm = example_scenes.san_miguel_stand_in(SM_SIZE, SM_SIZE).build(dev)
    with RecordPsf(psf) as rec_psf:
        game.GameTracer(sm, SM_SIZE, SM_SIZE).do_pass()
    psf_take(rec_psf.calls[0], psf)
    del rec_psf
    quads = sm.textures.texels_quad
    with RecordTake("ewa_tap", texture, "_take_rows", lambda t: t if t is quads else None):
        wavefront.WavefrontPT(sm, SM_SIZE, SM_SIZE, max_depth=5, lanes=WF_LANES).do_pass()
    veach = example_scenes.veach_mis(VEACH_SIZE, VEACH_SIZE).build(dev)
    table = veach.geom.wide
    rr = veach_wavefronts(veach, table, traversal8.intersect_wide_cuda, tracer,
                          Rays)["bounce_cut_dead"][0]
    steps = traversal8.intersect_wide(table, rr, with_iters=True)[1]
    res = mb.measure(dev, take_calls=dict(TAKE_CALLS), step_rows=mb.table_step_rows(table),
                     queue_stream=(steps, rr.tmin.contiguous(), rr.tmax.contiguous()))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    emit(phase="microbench_alone", nvidia_smi=card, max_abs_err=mb.max_abs_err(res), **res)


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not os.path.isdir(os.path.join(HERE, "cudatracerlib_tpu_torch")):
        fail("run from a checkout of the repository")
    from cudatracerlib_tpu_torch.models import adaptive as admod
    from cudatracerlib_tpu_torch.models import bdpt as bdptmod
    from cudatracerlib_tpu_torch.models import blocksampler as bsmod
    from cudatracerlib_tpu_torch.models import fast as fastmod
    from cudatracerlib_tpu_torch.models import film as filmmod
    from cudatracerlib_tpu_torch.models import game as gamemod
    from cudatracerlib_tpu_torch.models import lighttracer as ltmod
    from cudatracerlib_tpu_torch.models import path as pathmod
    from cudatracerlib_tpu_torch.models import pipeline as pipemod
    from cudatracerlib_tpu_torch.models import ppm as ppmmod
    from cudatracerlib_tpu_torch.models import prim as primmod
    from cudatracerlib_tpu_torch.models import samplers as samplersmod
    from cudatracerlib_tpu_torch.models import tracer as tracermod
    from cudatracerlib_tpu_torch.models import vcm as vcmmod
    from cudatracerlib_tpu_torch.models import wavefront as wfmod
    from cudatracerlib_tpu_torch.ops import (cuda_build, hashgrid, psf, traversal8,
                                             traversal_tt)
    from cudatracerlib_tpu_torch.ops.traversal import Rays
    from cudatracerlib_tpu_torch.utils import example_scenes
    from cudatracerlib_tpu_torch.utils import microbench as mb
    from cudatracerlib_tpu_torch.utils import schedule_probe as probe

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    emit(phase="card", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda)

    # the launch counters of the kernels and the traversals' plain versions
    K1, K2, K3 = (traversal8.intersect_wide_cuda, traversal_tt.top_visits_cuda,
                  traversal_tt.treelet_hits_cuda)
    K4 = traversal8.intersect_wide_pool_cuda
    plains = (traversal8.intersect_wide, traversal_tt.top_visits,
              traversal_tt.treelet_hits)

    def zero_counts():
        for f in (K1, K2, K3, K4, psf.psf_gather, *mb.KERNELS):
            f.launches = 0
        for f in (K2, K3):
            f.launches_by_v = dict.fromkeys(f.launches_by_v, 0)
        for f in (K1, K2):
            f.launches_by_variant = dict.fromkeys(f.launches_by_variant, 0)
        K1.launches_by_mode = dict.fromkeys(K1.launches_by_mode, 0)
        K1.launches_by_design = dict.fromkeys(K1.launches_by_design, 0)
        mb.chase_rows_cuda.launches_by_mode = dict.fromkeys(mb.CHASE_MODES, 0)
        mb.gather_take_cuda.launches_by_design = dict.fromkeys(mb.TAKE_DESIGNS, 0)
        mb.step_only_cuda.launches_by_kind = dict.fromkeys(
            mb.step_only_cuda.launches_by_kind, 0)
        mb.queue_fetch_cuda.launches_by_form = dict.fromkeys(mb.QUEUE_FORMS, 0)
        for f in plains:
            f.cuda_calls = 0

    def k1_variants(label, table, rays, amask_, variants):
        """K1's variants against its plain version on `rays`: closest-hit,
        any-hit and mixed (any-hit where `amask_`); "group" forces the
        global variant's group design."""
        modes_ = {"closest": {}, "any_hit": dict(any_hit=True),
                  "mixed": dict(any_mask=amask_)}

        def run(variant, kw):
            if variant in probe.DESIGNS:
                h, st, fl = probe.traverse8(table, rays, variant,
                                            with_iters=True, **kw)
            elif variant == "group":
                h, st, fl = K1(table, rays, with_iters=True, _variant="global",
                               _design="group", **kw)
            else:
                h, st, fl = K1(table, rays, with_iters=True, _variant=variant,
                               **kw)
            return (*h, st, fl), st, fl

        def plain(kw):
            h, st, fl = traversal8.intersect_wide(table, rays, with_iters=True, **kw)
            return (*h, st, fl), st, fl
        live = int(live_mask(rays, {}, traversal8).sum())
        return check_variants(
            "K1", run, plain, modes_, variants,
            bound=lambda steps, nb: trav_bound(nb, rays.o.shape[0], steps,
                                               True, mb, traversal8, live),
            scene=label, rays=rays.o.shape[0], rows=table.shape[0],
            shared_bytes=table.shape[0] * traversal8.ROW_BYTES,
            rule=traversal8.launch_variant(table))

    def plain_calls():
        return sum(f.cuda_calls for f in plains)

    # 1. build every kernel from the checkout's sources, in parallel
    t0 = time.perf_counter()
    sources = ("traversal8.cu", "traversal_tt.cu", "traversal_pool.cu",
               "microbench.cu", "schedule_probe.cu", "psf_gather.cu")
    cuda_build.build(*sources)
    build_s = time.perf_counter() - t0
    for src in sources:
        log = cuda_build.build_log[src]
        ptxas = [ln.strip() for ln in log["ptxas"].splitlines()
                 if "registers" in ln or "stack frame" in ln
                 or "Compiling entry" in ln]
        emit(phase="build", kernel=src, seconds=round(log["seconds"], 3),
             ptxas=ptxas)
    emit(phase="build", seconds_all=round(build_s, 3))
    # the shared variants must read their rows with LDS (not generic LD),
    # the global ones with LDG; K3's staging probe designs stage with
    # LDGSTS and read a staged row on chip (LDS from the block's own shared
    # memory, or a generic LD: through the cluster's shared windows, or
    # where the split design's row may lie in either memory), so each must
    # hold at least as many such 128-bit loads as K3 holds LDGs (one step's
    # row loads): a staged row read with LDG fails
    shared_bytes = dict(shared="rows * 512",
                        staged="the staged rows * 512 / blocks")
    k3_loads = None
    for src in ("traversal8.cu", "traversal_tt.cu", "traversal_pool.cu",
                "schedule_probe.cu"):
        loads = sass_loads(cuda_build.build_log[src]["path"],
                           cuda_build.find_nvcc())
        if src == "schedule_probe.cu":
            # K3's staging designs only (the walk stages nothing; the rest
            # are K1's and K2's designs or copies of the kernels above)
            loads = {fn: ops for fn, ops in loads.items()
                     if fn.startswith("probe_treelet_kernel<")
                     and "walk" not in fn}
        else:
            k3_loads = k3_loads or loads.get("treelet_hits_kernel")
        step_loads = sum(n for op, n in (k3_loads or {}).items()
                         if op.startswith("LDG."))
        for fn, ops in loads.items():
            kind = ("shared" if "_shared_" in fn else
                    "staged" if fn.startswith(("probe_treelet", "top_visits_split"))
                    else "global")
            lds = sum(n for op, n in ops.items() if op.startswith("LDS"))
            ldg = sum(n for op, n in ops.items() if op.startswith("LDG."))
            generic = sum(n for op, n in ops.items() if op.startswith("LD."))
            emit(phase="sass", kernel=fn, kind=kind, loads_128=ops,
                 on_chip_row_loads=lds + generic if kind == "staged" else None,
                 dynamic_shared_bytes=shared_bytes.get(kind, 0))
            bad = {"shared": lds == 0 or generic > 0, "global": ldg == 0,
                   "staged": (lds + generic < step_loads or step_loads == 0
                              or "LDGSTS.E.BYPASS.128" not in ops)}[kind]
            if bad:
                fail(f"{fn}: unexpected row loads {ops}")
        # K2's split variant's kernel at both V must be there
        if src == "traversal_tt.cu":
            want = {f"top_visits_split_kernel<{V}>" for V in (3, 6)}
            if not want <= set(loads):
                fail(f"K2's split variant's kernels missing from the SASS: "
                     f"{sorted(want - set(loads))}")
        # K4's two row sources must both be there to be checked
        if src == "traversal_pool.cu" and not all(
                any(fn.startswith(k + "<") for fn in loads)
                for k in ("traverse_pool_shared_kernel", "traverse_pool_kernel")):
            fail(f"K4's kernels missing from the SASS: {sorted(loads)}")

    # P2 (b)'s step_only runs its loop on registers alone: no load from
    # memory (LDG, LDS, LDL, generic LD) inside a loop of its SASS
    step_sass = sass_loop_loads(cuda_build.build_log["microbench.cu"]["path"],
                                cuda_build.find_nvcc())
    emit(phase="sass", kernel="step_only_kernel", kind="registers",
         loops_and_loop_loads=step_sass,
         ptxas=ptxas_lines(cuda_build.build_log["microbench.cu"]["ptxas"],
                           "step_only_kernel"))
    if len(step_sass) != 4 or any(n == 0 or loads for n, loads in step_sass.values()):
        fail(f"step_only's loops load from memory, or were not found: {step_sass}")

    # 2. K1 against its plain version at the Cornell path's ray count
    scene512 = example_scenes.cornell_box(512, 512).build(dev)
    table = scene512.geom.wide
    rng = np.random.default_rng(1234)
    o = rng.uniform(0.05, 0.95, (N_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays(torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                torch.full((N_RAYS,), 1e-4, device=dev),
                torch.full((N_RAYS,), 1e9, device=dev))
    amask = torch.from_numpy(rng.random(N_RAYS) < 0.5).to(dev)
    k1_cornell = k1_variants("cornell_box", table, rays, amask, K1_VARIANTS + ("group",))
    # pool_vs_k1: K1, K4 and K4's probe designs on the same rays
    k4_cornell = pool_sets("cornell_phase2", table, rays, amask, K1, K4, traversal8, mb,
                           card, 5, natural="mixed")

    # 3. golden image on the card
    zero_counts()
    tr32 = pathmod.PathTracer(example_scenes.cornell_box(32, 32).build(dev),
                              32, 32, max_depth=4, spp_per_pass=1)
    img = tr32.render(16).cpu().numpy()
    ref = np.load(GOLDEN)["img"]
    rel = float(np.abs(img - ref).mean() / max(ref.mean(), 1e-6))
    emit(phase="golden", size=32, passes=16, rel_err=rel, limit=0.02,
         launches=K1.launches, plain_cuda_calls=plain_calls())
    if not rel < 0.02:
        fail(f"golden drift {rel}")
    if K1.launches <= 0 or plain_calls():
        fail("the golden pass did not run through the kernel alone")

    # 4. the Cornell headline: its path, with the counts zeroed around it
    tr = pathmod.PathTracer(scene512, 512, 512, max_depth=6, chunk_size=65536)
    torch.cuda.synchronize()
    zero_counts()
    secs, rays_n = timed_passes(tr, 4)
    img = filmmod.develop(tr.film).cpu().numpy()
    launches, plain_n = K1.launches, plain_calls()
    k1_by_variant = {"cornell_box": dict(K1.launches_by_variant)}
    cornell_mean = float(img.mean())
    capped, overflowed = (int(x) for x in tr._ovf_dev.tolist())
    emit(phase="headline", scene="cornell_box", size=512, max_depth=6,
         chunk_size=65536, passes=4, seconds_per_pass=statistics.median(secs),
         pass_seconds=secs, live_rays=int(sum(rays_n)),
         mrays_per_s=sum(rays_n) / sum(secs) / 1e6,
         steps=int(tr._iters_dev), capped=capped, overflowed=overflowed,
         launches=launches, launches_by_variant=k1_by_variant["cornell_box"],
         k2_launches=K2.launches, k3_launches=K3.launches,
         plain_cuda_calls=plain_n,
         mean_radiance=float(img.mean()), finite=bool(np.isfinite(img).all()))
    if not np.isfinite(img).all() or not img.mean() > 0.0:
        fail("headline image is not finite and non-black")
    if capped or overflowed:
        fail(f"capped {capped} / overflowed {overflowed} rays")
    if launches <= 0 or plain_n:
        fail("the headline pass did not run through the kernel alone")
    if K1.launches_by_variant["shared"] != launches:
        fail(f"Cornell K1 launches not all shared: {K1.launches_by_variant}")
    # pool_vs_k1 on every K1 call of one more pass
    pool_vs_k1_pass("cornell_pt_512", record_k1(tr.do_pass, traversal8, Rays), K1, K4,
                    traversal8, mb, card)
    del tr, scene512

    # 4a. veach-mis: K4 against K1 and the plain version on its table
    veach = example_scenes.veach_mis(512, 512).build(dev)
    vtable = veach.geom.wide
    pix = (torch.arange(VEACH_HALF, dtype=torch.int32, device=dev) * 4) % (512 * 512)
    cam = tracermod.gen_camera_rays(veach, pix, 0, 0, 512, 512)[0]
    rng = np.random.default_rng(77)
    o = np.stack([rng.uniform(-4, 4, VEACH_HALF), rng.uniform(-1.9, 2.5, VEACH_HALF),
                  rng.uniform(-3, 5.5, VEACH_HALF)], 1).astype(np.float32)
    d = rng.normal(size=(VEACH_HALF, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    B = 2 * VEACH_HALF
    v_rays = Rays(o=torch.cat([cam.o, torch.from_numpy(o).to(dev)]),
                  d=torch.cat([cam.d, torch.from_numpy(d).to(dev)]),
                  tmin=torch.full((B,), 1e-4, device=dev),
                  tmax=torch.full((B,), 1e30, device=dev))
    v_mask = torch.from_numpy(rng.random(B) < 0.5).to(dev)
    emit(phase="veach_build", tris=veach.num_tris, rows=vtable.shape[0],
         table_kb=vtable.numel() * 4 / 1024,
         bvh_seconds=veach.host["build_seconds"]["bvh"])
    k1_veach = k1_variants("veach_mis", vtable, v_rays, v_mask, K1_VARIANTS + ("group",))
    # pool_vs_k1 on the same rays, on tools/microbench_pool.py's four
    # wavefronts (and the cut bounce set's dead form), and on the edge batches
    k4_veach = pool_sets("veach_phase4a", vtable, v_rays, v_mask, K1, K4, traversal8,
                         mb, card, 6, natural="mixed", timed=("mixed",))
    pool_run = pool_runner(K1, K4, traversal8)
    for name, (rr, natural) in veach_wavefronts(veach, vtable, K1, tracermod,
                                                Rays).items():
        pool_sets(f"veach_{name}", vtable, rr, v_mask, K1, K4, traversal8, mb, card,
                  11, natural=natural, model=True)
        if name == "bounce_cut_dead":
            steps = traversal8.intersect_wide(vtable, rr, with_iters=True)[1]
            MB_INPUTS["queue_stream"] = (steps.contiguous(), rr.tmin.contiguous(),
                                         rr.tmax.contiguous())
    MB_INPUTS["step_rows"] = mb.table_step_rows(vtable)
    big = veach_wavefronts(veach, vtable, K1, tracermod, Rays, POOL_RAYS_BIG)["bounce"][0]
    pool_sets("veach_bounce_1m", vtable, big,
              torch.from_numpy(np.random.default_rng(12).random(POOL_RAYS_BIG) < 0.5).to(dev),
              K1, K4, traversal8, mb, card, 12)
    del big
    for name, rr, kw in k1_edge_batches(vtable, v_rays, POOL_EDGE_BIG, seed=6):
        errs = check_edge_batch(name, vtable, rr, kw, K1, traversal8, None, pool_run,
                                k1_designs=())
        emit(phase="pool_edge_batch", batch=name, rows=vtable.shape[0],
             rays=rr.o.shape[0], kw=sorted(kw), identical=True, max_abs_err=errs)
    # the shared variant's prologue (staging the table), from its device
    # time against the global variant's: one ray (one block), and one dead
    # ray (tmax -1, one step) for every thread of a full grid
    n_full = torch.cuda.get_device_properties(dev).multi_processor_count \
        * traversal8.SHARED_THREADS
    one = Rays(*(x[:1].contiguous() for x in v_rays))
    dead = Rays(*(x[:n_full].contiguous() for x in v_rays[:3]),
                tmax=torch.full((n_full,), -1.0, device=dev))
    prologue = {}
    for name, rr in (("one_ray", one), ("dead_full_grid", dead)):
        prologue[name] = [dict(variant=v, device_ms=device_ms(
            lambda: K1(vtable, rr, _variant=v), reps=20))
            for v in ("shared", "global", "global", "shared")]
    emit(phase="prologue", scene="veach_mis", rows=vtable.shape[0],
         shared_bytes=vtable.shape[0] * traversal8.ROW_BYTES, dead_rays=n_full,
         runs=prologue)
    del v_rays, cam

    # 4b. the veach anchor against the independent reference render
    g = np.load(REF_VEACH)
    ref_a, ref_b = g["img"].astype(np.float64), g["img_seed2"].astype(np.float64)
    spp, aw, ah, adepth = (int(g[k]) for k in ("spp", "w", "h", "max_depth"))
    noise = float(np.sqrt(((ref_a - ref_b) ** 2).mean()))
    anchor = example_scenes.veach_mis_anchor(aw, ah).build(dev)
    zero_counts()
    t0 = time.perf_counter()
    ta = pathmod.PathTracer(anchor, aw, ah, max_depth=adepth, rr_depth=4,
                            use_nee=True, spp_per_pass=16)
    ta.render_batched(spp // 16)
    anchor_run = dict(seconds=time.perf_counter() - t0, k1=K1.launches,
                      k4=K4.launches, plain=plain_calls(),
                      ovf=[int(x) for x in ta._ovf_dev.tolist()])
    got = filmmod.develop(ta.film).cpu().numpy().astype(np.float64)
    rmse = float(np.sqrt(((got - 0.5 * (ref_a + ref_b)) ** 2).mean()))
    mean_got, mean_ref = float(got.mean()), float(ref_a.mean())
    mean_bound = 0.05 * max(mean_ref, 1e-6) + 3.0 * noise
    mean_gap = abs(mean_got - mean_ref) / max(mean_ref, 1e-6)
    emit(phase="veach_anchor", size=aw, spp=spp, passes=spp // 16,
         spp_per_pass=16, max_depth=adepth, rmse=rmse, noise_floor=noise,
         limit=CAL * noise, mean=mean_got, mean_ref=mean_ref,
         mean_bound=mean_bound, mean_gap=mean_gap, mean_gap_limit=MEAN_GAP,
         run=anchor_run)
    if not (rmse < CAL * noise and abs(mean_got - mean_ref) < mean_bound
            and mean_gap < MEAN_GAP):
        fail(f"veach anchor: RMSE {rmse} vs {CAL} x {noise}, mean {mean_got} vs {mean_ref}")
    if anchor_run["k1"] <= 0 or anchor_run["k4"] or anchor_run["plain"]:
        fail(f"the anchor run took the wrong kernels: {anchor_run}")
    del anchor, ta

    # 4c. the veach-mis headline, after a warm-up pass
    vtr = pathmod.PathTracer(veach, 512, 512, max_depth=5, chunk_size=65536)
    vtr.do_pass()
    torch.cuda.synchronize()
    zero_counts()
    secs, rays_n = timed_passes(vtr, 8)
    counts = dict(K1=K1.launches, K4=K4.launches, K2=K2.launches,
                  K3=K3.launches, plain=plain_calls(),
                  K1_by_variant=dict(K1.launches_by_variant),
                  K1_by_design=dict(K1.launches_by_design))
    k1_by_variant["veach_mis"] = dict(K1.launches_by_variant)
    img = filmmod.develop(vtr.film).cpu().numpy()
    capped, overflowed = (int(x) for x in vtr._ovf_dev.tolist())
    emit(phase="headline", scene="veach_mis", tris=veach.num_tris, size=512,
         max_depth=5, chunk_size=65536, passes=8, kernel="K1",
         seconds_per_pass=statistics.median(secs), pass_seconds=secs,
         live_rays=int(sum(rays_n)), mrays_per_s=sum(rays_n) / sum(secs) / 1e6,
         launches=counts, steps=int(vtr._iters_dev), capped=capped,
         overflowed=overflowed, mean_radiance=float(img.mean()))
    if (counts["K1"] <= 0 or counts["K4"] or counts["K2"] or counts["K3"]
            or counts["plain"]):
        fail(f"the veach-mis run took the wrong kernels: {counts}")
    if K1.launches_by_variant["shared"] != K1.launches:
        fail(f"veach-mis K1 launches not all shared: {K1.launches_by_variant}")
    if not np.isfinite(img).all() or not img.mean() > 0.0:
        fail("the veach-mis image is not finite and non-black")
    if capped or overflowed:
        fail(f"veach-mis: capped {capped} / overflowed {overflowed} rays")
    pool_vs_k1_pass("veach_pt_512", record_k1(vtr.do_pass, traversal8, Rays), K1, K4,
                    traversal8, mb, card)
    if PROFILE:
        profile_pass(vtr, "veach_mis", kernel="K1")
    del vtr
    veach_4c = dict(seconds_per_pass=statistics.median(secs), pass_seconds=secs,
                    live_rays_by_pass=rays_n, mrays_per_s=sum(rays_n) / sum(secs) / 1e6)

    # 4p-4q. the adaptive block sampler with the image pipeline, and the
    # Sobol' sampler, on the same scene
    veach_records = veach_slice_phases(
        dev, veach, veach_4c, K1, K4, zero_counts, plain_calls, k1_by_variant,
        pathmod, admod, bsmod, pipemod, samplersmod, tracermod, filmmod,
        example_scenes, traversal8, mb)
    del veach

    # 4d-4f. the light-path slice: PrimTracer, BDPT and LightTracer
    light_path = light_path_phases(
        dev, K1, K4, zero_counts, plain_calls, k1_by_variant, primmod, bdptmod,
        ltmod, filmmod, example_scenes, traversal8, mb)

    # 4g-4i. the participating-media slice: PPM and the volumetric PT
    light_path.update(media_phases(
        dev, K1, K4, zero_counts, plain_calls, k1_by_variant, pathmod, ppmmod,
        tracermod, filmmod, example_scenes, traversal8, mb))

    # 4j-4l. VCM; 4m-4n. the sensors and the wavefront against the chunked
    # PT; 4o. the FastTracer on Cornell
    light_path["vcm"] = vcm_phases(dev, K1, K4, zero_counts, plain_calls,
                                   k1_by_variant, vcmmod, filmmod, example_scenes,
                                   traversal8, mb)
    sensor_phases(dev, K1, zero_counts, plain_calls, pathmod, ltmod, wfmod,
                  example_scenes)
    light_path.update(veach_records)
    # 4r. alpha, bump, parallax, BSSRDF and spectral transport, card vs CPU
    feature_phases(dev, K1, zero_counts, plain_calls, pathmod, wfmod, example_scenes)
    light_path.update(fast_cornell_phase(dev, K1, K4, zero_counts, plain_calls,
                                         k1_by_variant, fastmod, filmmod,
                                         example_scenes, traversal8, mb))

    # 5. San Miguel at full width: host build, then K2, K3 and K1 on its tables
    collect_cpu_sides()
    t0 = time.perf_counter()
    sm = example_scenes.san_miguel_stand_in(1024, 1024)
    gen_s = time.perf_counter() - t0
    scene = sm.build(dev)
    torch.cuda.synchronize()
    geom = scene.geom
    top, slabs, wide = geom.tt_top, geom.tt_slabs, geom.wide
    emit(phase="sm_build", tris=scene.num_tris, rows=wide.shape[0],
         table_mb=wide.numel() * 4 / 2**20, top_rows=top.shape[0],
         treelets=slabs.shape[0], slab_rows=slabs.shape[1],
         slabs_mb=slabs.numel() * 4 / 2**20, visit_ids=geom.tt_vid.shape[0],
         shade_mb=geom.shade.numel() * 4 / 2**20,
         texels=scene.textures.texels.shape[0],
         generate_seconds=gen_s,
         build_seconds=time.perf_counter() - t0 - gen_s,
         bvh_seconds=scene.host["build_seconds"]["bvh"],
         treelet_seconds=scene.host["build_seconds"]["treelet"])

    pix = (torch.arange(SM_HALF, dtype=torch.int32, device=dev) * 8) % (1024 * 1024)
    cam = tracermod.gen_camera_rays(scene, pix, 0, 0, 1024, 1024)[0]
    rng = np.random.default_rng(99)
    o = np.stack([rng.uniform(-16, 16, SM_HALF), rng.uniform(0.3, 5.0, SM_HALF),
                  rng.uniform(-10, 10, SM_HALF)], 1).astype(np.float32)
    d = rng.normal(size=(SM_HALF, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    B = 2 * SM_HALF
    sm_rays = Rays(o=torch.cat([cam.o, torch.from_numpy(o).to(dev)]),
                   d=torch.cat([cam.d, torch.from_numpy(d).to(dev)]),
                   tmin=torch.full((B,), 1e-4, device=dev),
                   tmax=torch.full((B,), 1e30, device=dev))
    sm_mask = torch.from_numpy(rng.random(B) < 0.5).to(dev)
    sm_modes = {"closest": {}, "any_hit": dict(any_hit=True),
                "mixed": dict(any_mask=sm_mask)}
    # K1 on the unsplit table: the global variant by the size rule (in both
    # designs, every lane live); the shared variant forced there must be
    # refused, not fall back
    kernel_ms = {}
    k1_sm = k1_variants("san_miguel_stand_in", wide, sm_rays, sm_mask, (None,))
    k1_run_design = k1_global_runner(K1, traversal8)
    k1_global_call("san_miguel_random_rays", wide, sm_rays, dict(any_mask=sm_mask),
                   traversal8, mb, k1_run_design)
    # K1's global variant on the batches at its edges, both designs and the
    # probe's, every field against the plain version
    t0 = time.perf_counter()
    for name, rr, kw in k1_edge_batches(wide, sm_rays, K1_EDGE_BIG, seed=5):
        errs = check_edge_batch(name, wide, rr, kw, K1, traversal8, k1_run_design,
                                pool_run)
        emit(phase="k1_edge_batch", batch=name, rays=rr.o.shape[0],
             live=int(traversal8.live_lanes(rr, kw.get("max_iters", traversal8.MAX_ITERS),
                                            kw.get("roots")).sum()),
             kw=sorted(kw), identical=True, max_abs_err=errs)
    emit(phase="k1_edge_batch", seconds=time.perf_counter() - t0)
    k1_res = {mode: K1(wide, sm_rays, **kw) for mode, kw in sm_modes.items()}
    try:
        K1(wide, sm_rays, _variant="shared")
    except RuntimeError as e:
        emit(phase="refused", kernel="K1", variant="shared", rows=wide.shape[0],
             shared_bytes=wide.shape[0] * traversal8.ROW_BYTES, error=str(e))
    else:
        fail("K1's shared variant on the San Miguel table was not refused")
    n_tt = slabs.shape[0]
    probe_split = (probe.CHUNK, probe.MIN_STAGE)

    def k3_designs(V, slots):
        """K3 and its probe designs (K3_DESIGNS) against its plain version
        on each mode's sorted slots {mode: (keys, order, t_prune)}; then, on
        the mixed slots, the probe's cluster and walk designs at the probe's
        own chunk size and staging threshold (identical, staged count
        against the plain model, device time), the cluster and
        split designs staging only, and the probe's split of the slots.
        Returns check_variants's result."""
        def run(design, m):
            keys, order, t_prune = m["slots"]
            if design is None:
                r = K3(slabs, sm_rays, t_prune, keys, order, V, **m["kw"])
            else:
                r = probe.treelet_hits(slabs, sm_rays, t_prune, keys, order, V,
                                       design, **m["kw"])
            return (*r[0], *r[1:]), r[1], r[2]

        def plain(m):
            keys, order, t_prune = m["slots"]
            r = traversal_tt.treelet_hits(slabs, sm_rays, t_prune, keys, order,
                                          V, **m["kw"])
            return (*r[0], *r[1:]), r[1], r[2]
        modes = {mode: dict(kw=kw, slots=slots[mode])
                 for mode, kw in sm_modes.items()}
        keys, order, t_prune = slots["mixed"]
        tid = keys >> traversal_tt.VID_ROOT_BITS
        valid = tid < n_tt
        needed = int(torch.unique(tid[valid]).numel())
        # K3 reads the slab rows its visits fetch once, the rays (o, d,
        # tmin, the prune t, the any-hit mask) and the B*V keys and slots,
        # and writes one hit per slot (t, tri, u, v, steps, flags)
        res = check_variants(
            "K3", run, plain, modes, K3_DESIGNS,
            bound=lambda steps, nb: mb.bound_ms(
                nb + B * 33 + B * V * 29,
                steps * traversal8.NODE_STEP_FLOPS),
            scene="san_miguel_stand_in", V=V, slots=B * V, treelets=n_tt,
            slab_rows=slabs.shape[1], treelets_visited=needed,
            cluster_blocks=probe.slab_variant(
                slabs.shape[1], torch.cuda.get_device_properties(dev)
                .shared_memory_per_block_optin))
        kw = sm_modes["mixed"]
        ref = plain(modes["mixed"])[0]

        def probe_run(chunk, min_stage, design="cluster", stage_only=False,
                      scratch=None):
            return probe.treelet_hits(slabs, sm_rays, t_prune, keys, order, V,
                                      design, chunk, min_stage, stage_only,
                                      _scratch=scratch, **kw)
        chunk, min_stage = probe_split
        staged = int(probe.treelet_segments(keys, n_tt, chunk, min_stage)[3].sum())
        for design in ("cluster", "walk"):
            scratch = torch.empty(2, dtype=torch.int32, device=dev)
            got = probe_run(chunk, min_stage, design, scratch=scratch)
            ok, err = same((*got[0], *got[1:]), ref)
            dms = device_ms(lambda: probe_run(chunk, min_stage, design))
            emit(phase="k3_sweep", V=V, design=design, chunk=chunk,
                 min_stage=min_stage, device_ms=dms, identical=ok,
                 max_abs_err=err, staged=int(scratch[1]), staged_model=staged)
            if not ok or int(scratch[1]) != staged:
                fail(f"K3's {design} design at chunk {chunk}, min_stage "
                     f"{min_stage}: identical {ok}, staged {int(scratch[1])} "
                     f"against the model's {staged}")
        stage_only = {d: device_ms(lambda: probe_run(*probe_split, design=d,
                                                     stage_only=True))
                      for d in ("cluster", "split")}
        scratch = torch.empty(2, dtype=torch.int32, device=dev)
        probe_run(*probe_split, scratch=scratch)
        start, end, _, staged = probe.treelet_segments(keys, n_tt, *probe_split)
        n_staged, n_valid = int(staged.sum()), int(valid.sum())
        staged_visits = int((end - start)[staged].sum())
        split = dict(chunk=probe_split[0], min_stage=probe_split[1],
                     slots=B * V, valid_visits=n_valid,
                     segments=int(start.numel()), staged=int(scratch[1]),
                     staged_model=n_staged,
                     visits_per_staged_segment=staged_visits / max(n_staged, 1),
                     unstaged_share=1 - staged_visits / max(n_valid, 1),
                     stage_only_device_ms=stage_only)
        emit(phase="k3_split", V=V, **split)
        if int(scratch[1]) != n_staged:
            fail(f"K3 staged {int(scratch[1])} segments, the model {n_staged}")
        k3_splits[V] = split
        return res

    k2_res, k3_res, k3_splits, k4_sm = {}, {}, {}, {}
    for V in (traversal8.V_COHERENT, traversal8.V_INCOHERENT):
        def k2_run(variant, kw):
            if variant in probe.TOP_DESIGNS:
                r = probe.top_visits(top, sm_rays, V, variant, **kw)
            else:
                r = K2(top, sm_rays, V, _variant=variant, **kw)
            return (*r[0], *r[1:]), r[5], r[6]

        def k2_plain(kw):
            r = traversal_tt.top_visits(top, sm_rays, V, **kw)
            return (*r[0], *r[1:]), r[5], r[6]
        # K2 reads the top rows it fetches and the rays and writes the
        # hits, V visits (id, entry t), the count and the min-dropped t
        k2_res[V] = check_variants(
            "K2", k2_run, k2_plain, sm_modes, K1_VARIANTS,
            bound=lambda steps, nb: mb.bound_ms(
                nb + B * 33 + B * (29 + 8 * V),
                steps * traversal8.NODE_STEP_FLOPS),
            scene="san_miguel_stand_in", V=V, rays=B, rows=top.shape[0],
            shared_bytes=top.shape[0] * traversal8.ROW_BYTES,
            rule=traversal_tt.launch_top_variant(top))
        k2_out = {mode: K2(top, sm_rays, V, **kw) for mode, kw in sm_modes.items()}
        k3_res[V] = k3_designs(V, {mode: traversal_tt.visit_slots(
            k2[0], k2[1], k2[3], n_tt, traversal8.any_lanes(
                B, kw.get("any_hit", False), kw.get("any_mask"), dev))[1:]
            for (mode, kw), k2 in zip(sm_modes.items(), k2_out.values())})
        for mode, kw in sm_modes.items():
            h1 = k1_res[mode]
            any_lane = traversal8.any_lanes(B, kw.get("any_hit", False),
                                            kw.get("any_mask"), dev)
            vcnt = k2_out[mode][3]
            tk = traversal_tt.two_phase(K2, K3, top, slabs, sm_rays, V=V,
                                        with_overflow=True, with_iters=True, **kw)
            tp = traversal_tt.two_phase(traversal_tt.top_visits,
                                        traversal_tt.treelet_hits, top, slabs,
                                        sm_rays, V=V, with_overflow=True,
                                        with_iters=True, **kw)
            okt, errt = same((*tk[0], tk[1], tk[2], tk[4]),
                             (*tp[0], tp[1], tp[2], tp[4]))
            coherent = V == traversal8.V_COHERENT
            ex, ex_iters, _, ex_flags = traversal8.intersect_treelet_exact(
                geom, sm_rays, coherent=coherent, with_iters=True, **kw)
            # the exact treelet path against K1 on the unsplit table
            cl = ~any_lane
            t_same = bool(torch.equal(ex.t[cl], h1.t[cl]))
            ties = int((cl & (ex.tri != h1.tri)).sum())
            hit_same = bool(torch.equal((ex.tri >= 0)[any_lane],
                                        (h1.tri >= 0)[any_lane]))
            total, dropped = (int(x) for x in traversal_tt.count_dropped_visits(
                top, sm_rays, V)) if mode == "closest" else (None, None)
            times = dict(
                treelet_ms=cuda_median_ms(lambda: traversal8.intersect_treelet_exact(
                    geom, sm_rays, coherent=coherent, **kw)),
                two_phase_ms=cuda_median_ms(lambda: traversal_tt.two_phase(
                    K2, K3, top, slabs, sm_rays, V=V, **kw)),
                k1_ms=k1_sm[mode, None]["ms"],
                plain_ms=cuda_median_ms(lambda: traversal_tt.two_phase(
                    traversal_tt.top_visits, traversal_tt.treelet_hits, top,
                    slabs, sm_rays, V=V, **kw)))
            if mode == "mixed":
                # K1 on the exact path's fallback batch: every lane whose
                # visits did not overflow has tmax -1 and takes one step
                fb = Rays(sm_rays.o, sm_rays.d, sm_rays.tmin,
                          torch.where(tk[1], tk[0].t, -1.0))
                # (the probe's group designs timed here alone, at V=3)
                kernel_ms["K1_fallback", V] = k1_global_call(
                    f"san_miguel_fallback_V{V}", wide, fb,
                    dict(any_mask=sm_mask, _design=traversal8.FALLBACK_DESIGN),
                    traversal8, mb, k1_run_design,
                    sweep=V == traversal8.V_INCOHERENT)
                # pool_vs_k1 on the same batch (global rows): K1 as the
                # size rule picks it and its group design, K4, the probe's
                k4_sm[V] = pool_sets(f"san_miguel_fallback_V{V}", wide, fb, sm_mask,
                                     K1, K4, traversal8, mb, card, 7 + V,
                                     natural="mixed", timed=("mixed",))
            emit(phase="sm_kernels_vs_plain", mode=mode, rays=B, V=V,
                 two_phase_identical=okt, max_abs_err=errt,
                 visits=int(vcnt.sum()), visits_kept=int(vcnt.clamp_max(V).sum()),
                 dropped_visits=int((vcnt - V).clamp_min(0).sum()),
                 count_dropped_visits=[total, dropped],
                 fallback_rays=int(tk[1].sum()), treelet_steps=int(ex_iters),
                 flags=[int(x) for x in ex_flags.tolist()],
                 exact_t_identical=t_same, tri_ties=ties,
                 any_hit_lanes_identical=hit_same, **times)
            if not okt:
                fail(f"the two-phase path disagrees with its plain version "
                     f"({mode}, V={V})")
            if not (t_same and hit_same):
                fail(f"the treelet path disagrees with K1 beyond t-ties "
                     f"({mode}, V={V})")
            if int(ex_flags.sum()):
                fail(f"capped or overflowed rays on San Miguel ({mode}, V={V})")
    del sm_rays, cam

    # 6. San Miguel 128^2 through the treelet path, then through K1 alone
    scene128 = scene._replace(
        sensor=example_scenes.san_miguel_stand_in(128, 128).sensor_data(dev))
    flat128 = scene128._replace(geom=geom._replace(tt_top=None, tt_slabs=None,
                                                   tt_vid=None))
    imgs, counts = [], []
    for sc in (scene128, flat128):
        zero_counts()
        t128 = pathmod.PathTracer(sc, 128, 128, max_depth=5)
        imgs.append(t128.render(4).cpu().numpy())
        counts.append(dict(k1=K1.launches, k2=K2.launches, k3=K3.launches,
                           k1_by_design=dict(K1.launches_by_design),
                           k2_by_v=dict(K2.launches_by_v),
                           k3_by_v=dict(K3.launches_by_v), plain=plain_calls(),
                           ovf=[int(x) for x in t128._ovf_dev.tolist()]))
    K1_THREAD_LAUNCHES["San Miguel 128 K1 alone"] = counts[1]["k1_by_design"]["thread"]
    rel = float(np.abs(imgs[0] - imgs[1]).mean() / max(imgs[1].mean(), 1e-6))
    emit(phase="sm_image", size=128, max_depth=5, passes=4, rel_err=rel,
         limit=1e-3, treelet_run=counts[0], k1_only_run=counts[1],
         mean_radiance=float(imgs[0].mean()))
    if not rel < 1e-3:
        fail(f"treelet and K1-only San Miguel images differ: {rel}")
    by_v = (*counts[0]["k2_by_v"].values(), *counts[0]["k3_by_v"].values())
    if (min(by_v) <= 0 or counts[1]["k2"]
            or counts[1]["k3"] or counts[1]["k1"] <= 0
            or counts[0]["plain"] or counts[1]["plain"]):
        fail(f"the 128^2 runs took the wrong kernels: {counts}")
    del scene128, flat128

    # 7. the slice's headline: its path, with the counts zeroed around it
    tr = pathmod.PathTracer(scene, 1024, 1024, max_depth=5, chunk_size=131072)
    torch.cuda.synchronize()
    zero_counts()
    secs, rays_n = timed_passes(tr, 2)
    launches = {"K1": K1.launches}
    for name, f in (("K2", K2), ("K3", K3)):
        launches.update({(name, V): n for V, n in f.launches_by_v.items()})
    sm_by_variant = dict(K1=dict(K1.launches_by_variant),
                         K2=dict(K2.launches_by_variant),
                         K1_design=dict(K1.launches_by_design))
    plain_n = plain_calls()
    img = filmmod.develop(tr.film).cpu().numpy()
    capped, overflowed = (int(x) for x in tr._ovf_dev.tolist())
    emit(phase="headline", scene="san_miguel_stand_in", tris=scene.num_tris,
         size=1024, max_depth=5, chunk_size=131072, passes=2,
         seconds_per_pass=statistics.median(secs), pass_seconds=secs,
         live_rays=int(sum(rays_n)), mrays_per_s=sum(rays_n) / sum(secs) / 1e6,
         steps=int(tr._iters_dev), capped=capped, overflowed=overflowed,
         launches={k if isinstance(k, str) else f"{k[0]}_V{k[1]}": n
                   for k, n in launches.items()},
         launches_by_variant=sm_by_variant, plain_cuda_calls=plain_n,
         mean_radiance=float(img.mean()), finite=bool(np.isfinite(img).all()))
    if not np.isfinite(img).all() or not img.mean() > 0.0:
        fail("San Miguel image is not finite and non-black")
    if capped or overflowed:
        fail(f"capped {capped} / overflowed {overflowed} rays")
    if min(launches.values()) <= 0 or plain_n or K4.launches:
        fail(f"the San Miguel pass did not run through K1, and K2 and K3 at "
             f"both V, alone: {launches}, {plain_n} plain calls, "
             f"{K4.launches} K4 launches")
    # the top table fits shared memory, the unsplit table does not
    if (sm_by_variant["K2"]["shared"] != K2.launches
            or sm_by_variant["K1"]["global"] != K1.launches
            or K1.launches_by_design["group"] != K1.launches):
        fail(f"San Miguel launches by variant: {sm_by_variant}")

    # one more pass recorded: each of its K1 fallback calls (chunk by chunk,
    # the camera rays, four bounces merged with the last shadow rays, the
    # shadow flush) in both designs, so that the design this path takes is
    # backed by its own batches' live lanes and times
    per_chunk = tr.max_depth + 1
    pt_calls = record_k1(tr.do_pass, traversal8, Rays)
    if len(pt_calls) != tr._n_chunks * per_chunk:
        fail(f"a San Miguel pass made {len(pt_calls)} K1 calls, not "
             f"{tr._n_chunks} x {per_chunk}")
    pt_fallback = {}
    for i, (table, rays, kw) in enumerate(pt_calls):
        res = k1_global_call(f"san_miguel_pt_chunk{i // per_chunk}_trace{i % per_chunk}",
                             table, rays, kw, traversal8, mb, k1_run_design)
        c = K1_GLOBAL_CALLS[-1]
        r = pt_fallback.setdefault(f"trace{i % per_chunk}", dict(
            calls=0, mode=c["mode"], lanes=0, live=0, live_steps_max=0,
            bound_ms=0.0, device_ms={"thread": 0.0, "group": 0.0}))
        r["calls"] += 1
        r["lanes"] += c["lanes"]
        r["live"] += c["live"]
        r["live_steps_max"] = max(r["live_steps_max"], c["live_steps_max"])
        r["bound_ms"] += c["bound_ms"]
        for design in r["device_ms"]:
            r["device_ms"][design] += res["designs"][design]
    emit(phase="sm_pt_fallback", calls=len(pt_calls), by_trace=pt_fallback,
         device_ms={d: sum(r["device_ms"][d] for r in pt_fallback.values())
                    for d in ("thread", "group")})
    del pt_calls

    if PROFILE:
        profile_pass(tr, "san_miguel_stand_in")
    del tr

    # 7a-7b. WavefrontPT (config 3) and the FastTracer on the same scene
    sm_slice = sm_slice_phases(dev, scene, rays_n, K1, K2, K3, K4, zero_counts,
                               plain_calls, wfmod, fastmod, filmmod, traversal8,
                               traversal_tt, mb)
    # 7c. the game tracer on the same scene, and on Cornell against the CPU
    sm_slice.update(game_phases(dev, card, scene, K1, K2, K3, K4, zero_counts, plain_calls,
                                gamemod, hashgrid, filmmod, example_scenes, traversal8,
                                traversal_tt, mb))

    # 7d. the San Miguel stand-in at 4.8M triangles: K2's split variant
    collect_cpu_sides()
    sm48 = sm48_phases(dev, card, K1, K2, K3, K4, zero_counts, plain_calls, pathmod,
                       tracermod, filmmod, example_scenes, traversal8, traversal_tt,
                       probe, mb, Rays)

    # 8. P1-P3 at full size, each held to its plain version on its inputs:
    # P2's gathers on the index streams recorded in 7a and 7c, P2 (b) on
    # veach-mis's rows and P3's threshold form on its bounce stream (4a)
    missing = {"game_neighbors", "ewa_tap"} - set(TAKE_CALLS)
    if missing:
        fail(f"no {sorted(missing)} gather was recorded on the main path")
    collect_cpu_sides()
    torch.cuda.synchronize()
    zero_counts()
    res = mb.measure(dev, take_calls=dict(TAKE_CALLS), step_rows=MB_INPUTS["step_rows"],
                     queue_stream=MB_INPUTS["queue_stream"])
    TAKE_CALLS.clear()
    mb_launches = dict(P1=mb.chase_rows_cuda.launches,
                       P2_rows=mb.gather_rows_cuda.launches,
                       P2_loop=mb.loop_only_cuda.launches,
                       P2_take=mb.gather_take_cuda.launches,
                       P2_step_only=mb.step_only_cuda.launches,
                       P3=mb.queue_fetch_cuda.launches)
    by_kind = dict(P1=dict(mb.chase_rows_cuda.launches_by_mode),
                   P2_take=dict(mb.gather_take_cuda.launches_by_design),
                   P2_step_only=dict(mb.step_only_cuda.launches_by_kind),
                   P3=dict(mb.queue_fetch_cuda.launches_by_form))
    p1_by_mode = by_kind["P1"]
    emit(phase="microbench", nvidia_smi=card, launches=mb_launches,
         launches_by_kind=by_kind, max_abs_err=mb.max_abs_err(res), **res)
    emit(phase="p1_ns_per_row", nvidia_smi=card, readings={
        f"{e['rows']} {e['mode']}{'' if not e['param'] else e['param']} "
        f"{e['occupancy']} w{e['words']}": e["ns_per_dependent_row"] for e in res["P1"]})
    if min(mb_launches.values()) <= 0 or min(min(v.values()) for v in by_kind.values()) <= 0:
        fail(f"a microbenchmark kernel did not launch: {mb_launches}, {by_kind}")
    if mb.max_abs_err(res) != 0:
        fail("a microbenchmark kernel disagrees with its plain version")
    for call in ("game_neighbors", "ewa_tap"):
        es = [e for e in res["take"] if e["call"] == call]
        emit(phase="p2_take", nvidia_smi=card, call=call, rows=es[0]["rows"],
             gathers=es[0]["gathers"], distinct_rows=es[0]["distinct_rows"],
             index_select_ms=es[0]["library_ms"], port_take_ms=es[0]["plain_ms"],
             index_select_ms_by_word=es[0]["index_select_ms_by_word"],
             bound_ms=es[0]["bound_ms"],
             kept=next(e["design"] for e in es if e["kept"]),
             by_design={e["design"]: dict(ms=e["ms"], bound_share=e["bound_share"],
                                          gbps=e["gbps"],
                                          faster_than_index_select=e["faster_than_index_select"])
                        for e in es})
    arith_ns, arith_e = mb.step_arith_ns(res["step_only"])
    lane_ns, lane_e = mb.step_arith_ns(res["step_only"], per_lane=True)
    emit(phase="p2_step_only", nvidia_smi=card, step_arith_ns=arith_ns,
         step_arith_of=arith_e and f"{arith_e['kind']} any_hit={arith_e['any_hit']}",
         lane_arith_ns=lane_ns,
         lane_arith_of=lane_e and f"{lane_e['kind']} any_hit={lane_e['any_hit']}",
         readings={f"{e['kind']} {'any_hit' if e['any_hit'] else 'closest'} "
                   f"{e['occupancy']}": dict(ns_per_step=e["ns_per_step"],
                                             ns_per_lane_step=e["ns_per_lane_step"],
                                             lanes=e["lanes"])
                   for e in res["step_only"]})
    # the threshold form's fetch cost beside K4's loss to K1 on the same set
    # (pool_vs_k1, 4a: veach-mis bounce rays with 40% dead, closest)
    cut = {r["design"]: r["device_ms"] for r in POOL_VS_K1
           if r["set"] == "veach_bounce_cut_dead" and r["mode"] == "closest"}
    thr = {e["occupancy"]: e for e in res["P3"] if e["form"] == "threshold"}
    emit(phase="p3_forms", nvidia_smi=card,
         readings={f"{e['form']} {e['occupancy']} {e['items']}": dict(
             ms=e["ms"], ns_per_claim=e["ns_per_claim"], ns_per_item=e["ns_per_item"],
             claims=e["claims"], warps=e["warps"]) for e in res["P3"]},
         threshold_fetch_share={o: e["fetch_share"] for o, e in thr.items()},
         threshold_fetch_ns_per_claim={o: e["fetch_ns_per_claim"] for o, e in thr.items()},
         threshold_fetch_ms={o: e["fetch_share"] * e["ms"] for o, e in thr.items()},
         k4_over_k1_cut_dead=cut["k4"] / cut["k1"] if {"k1", "k4"} <= set(cut) else None,
         k4_minus_k1_ms_cut_dead=cut["k4"] - cut["k1"] if {"k1", "k4"} <= set(cut) else None)
    k2_sums = k2_call_lines(res["P1"], mb, card, arith_ns)

    # 9a-9e. two-level instancing: the golden, bench.py's instanced scene
    # (K2 with per-lane roots, K3, the K1 fallback), the 530-instance grid
    # (K1 with per-lane roots), updates and skinning
    collect_cpu_sides()
    inst_res = instanced_phases(dev, card, K1, K2, K3, K4, zero_counts, plain_calls,
                                pathmod, tracermod, filmmod, example_scenes,
                                traversal8, traversal_tt, mb)

    # L1-L3. Mitsuba files through the port's loader: the Cornell box
    # (config 1; K1), all 16 BSDF types with and without regularization,
    # and San Miguel from one serialized file (K2, K3, the K1 fallback)
    loader_res = loader_phases(dev, card, cornell_mean, K1, K2, K3, K4, zero_counts,
                               plain_calls, pathmod, primmod, bdptmod, vcmmod, wfmod,
                               filmmod, example_scenes, traversal8, traversal_tt, mb)

    # S. multi-device rendering (parallel/render.py) on a world of one rank
    # through NCCL, on phase 7's San Miguel scene among others
    par = parallel_phases(dev, card, scene, K1, K2, K3, K4, zero_counts, plain_calls,
                          traversal8, traversal_tt, mb)
    par_n = {"K1": {}, "K2": 0, "K3": 0}
    for c in par["launches"].values():
        for v, k in c["K1_by_variant"].items():
            par_n["K1"][v] = par_n["K1"].get(v, 0) + k
        par_n["K2"] += c["K2"]
        par_n["K3"] += c["K3"]
    k1_by_variant["parallel"] = par_n["K1"]
    light_path["parallel"] = {case: held.get("K1") for case, held in par["held"].items()}

    # the kernel table: one row for each variant of K1 and K2, timed at the
    # main path's shapes: K1 shared on veach-mis (Cornell under by_scene),
    # K1 global on the San Miguel fallback batch at V=3 (the whole
    # 262,144-ray traversal under mixed_rays); K2 and K3 at V=3 (80 of their
    # 96 launches per headline), with both budgets under by_v
    collect_cpu_sides()
    emit(phase="card_vs_cpu_time", card_seconds=CARD_CPU_SECONDS["card"],
         wait_seconds=CARD_CPU_SECONDS["wait"])

    def row(name, src, replaces, launches_n, err, ms, plain_ms, bound, library_ms=None,
            **extra):
        return dict(name=name, route="cuda",
                    source=f"cudatracerlib_tpu_torch/csrc/{src}",
                    replaces=replaces, launches=launches_n, max_abs_err=err,
                    ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                    bound_by=bound[1], library_ms=library_ms, **extra)

    def max_err(res, variant):
        return max(r["err"] for (_, v), r in res.items() if v == variant)

    def brief(r):
        return dict(ms=r["ms"], device_ms=r["device_ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound"][0])

    def sm_by_tracer(kernel, per_pass_key):
        """WavefrontPT's and the FastTracer's launches per pass of `kernel`
        on San Miguel and their recorded calls of it (7a-7b)."""
        return {name: dict(
            launches_per_pass=r["launches_per_pass"][per_pass_key],
            calls={label: dict(rays=c["rays"], V=c["V"], mode=c["mode"],
                               max_abs_err=c[kernel]["err"],
                               steps=c[kernel]["steps"], **brief(c[kernel]))
                   for label, c in r["calls"].items()})
            for name, r in sm_slice.items()}

    def vrow(name, src, replaces, launches_n, err, r, **extra):
        return row(name, src, replaces, launches_n, err, r["ms"], r["plain_ms"],
                   r["bound"], device_ms=r["device_ms"], **extra)

    def k3_row(name, src, design):
        """One row per K3 design at V=3, both budgets under by_v: the kept
        kernel (design None) with its launches on the main path, the
        probe's designs with none; the probe's split of the slots beside
        the cluster design."""
        n = {V: launches["K3", V] if design is None else 0 for V in k3_res}
        by_v = {f"V{V}": dict(launches=n[V], **brief(k3_res[V]["mixed", design]))
                for V in k3_res}
        return vrow(name, src, "cudatracerlib_tpu/ops/traversal_tt.py:340",
                    sum(n.values()), max(max_err(k3_res[V], design) for V in k3_res),
                    k3_res[traversal8.V_INCOHERENT]["mixed", design],
                    design=design or "kept", by_v=by_v,
                    split={f"V{V}": k3_splits[V] for V in k3_splits}
                    if design == "cluster" else None,
                    by_tracer=sm_by_tracer("K3", "K3") if design is None else None)

    def k2_row(name, variant, src="traversal_tt.cu"):
        """K2 on phase 7's 240-row top at V=3, both budgets under by_v: the
        kept shared variant (variant None) with its launches on the main
        path, a design of the probe (src schedule_probe.cu) with none."""
        by_v = {f"V{V}": dict(launches=launches["K2", V] if variant is None else 0,
                              **brief(k2_res[V]["mixed", variant]))
                for V in (traversal8.V_COHERENT, traversal8.V_INCOHERENT)}
        return vrow(name, src,
                    "cudatracerlib_tpu/ops/traversal_tt.py:185",
                    sm_by_variant["K2"][variant or "shared"] if variant is None else 0,
                    max(max_err(k2_res[V], variant) for V in k2_res),
                    k2_res[traversal8.V_INCOHERENT]["mixed", variant],
                    variant=variant or "shared", by_v=by_v,
                    designs={d: {f"V{V}": brief(k2_res[V]["mixed", d])
                                 for V in k2_res} for d in probe.DESIGNS}
                    if variant is None else None,
                    by_tracer=sm_by_tracer("K2", "K2") if variant is None else None)

    def psf_row():
        """The filter's kernel on 7c's recorded game frame: its device ms
        (ms: synchronised, the range search included), the plain filter's
        device ms, its launches in 7c's timed frames (one a frame)."""
        e = sm_slice["game"]["psf_gather"]
        return row("psf_gather_kernel", "psf_gather.cu",
                   "none: the JAX filter (cudatracerlib_tpu/models/game.py:70 accum) is jnp",
                   e["launches"], e["max_abs_err"], e["ms"], e["plain_device_ms"],
                   (e["bound_ms"], e["bound_by"]), device_ms=e["device_ms"],
                   plain="ops/psf.psf_gather_plain (the gather whole, then the sums)",
                   **{k: e[k] for k in ("queries", "rows", "walked_slots", "distinct_rows",
                                        "passing", "bound_share", "ranges_device_ms",
                                        "cnt_unequal", "cnt_unequal_near", "max_rel_err")})

    k1_shared_n = sum(k1_by_variant[sc]["shared"] for sc in k1_by_variant)
    k1_rows = [
        vrow("traverse8_shared_kernel", "traversal8.cu",
             "cudatracerlib_tpu/ops/traversal_pl.py:188", k1_shared_n,
             max(max_err(k1_cornell, None), max_err(k1_veach, None)),
             k1_veach["mixed", None], variant="shared",
             util=k4_veach["mixed", "k1"]["util"],
             by_scene={sc: dict(launches=k1_by_variant[sc]["shared"],
                                **brief(res["mixed", None]),
                                util=pool["mixed", "k1"]["util"],
                                global_variant=brief(res["mixed", "global"]),
                                group_design=brief(res["mixed", "group"]),
                                designs={d: brief(res["mixed", d])
                                         for d in probe.DESIGNS})
                       for sc, res, pool in (("cornell_box", k1_cornell, k4_cornell),
                                             ("veach_mis", k1_veach, k4_veach))},
             by_tracer={name: dict(launches=k1_by_variant[name]["shared"],
                                   one_pass=rec)
                        for name, rec in light_path.items()}),
        vrow("traverse8_group_kernel<16>", "traversal8.cu",
             "cudatracerlib_tpu/ops/traversal_pl.py:188",
             sm_by_variant["K1_design"]["group"],
             max(r["err"] for k, r in kernel_ms.items() if k[0] == "K1_fallback"),
             kernel_ms["K1_fallback", traversal8.V_INCOHERENT], variant="global",
             design="group",
             fallback_by_v={f"V{V}": dict(brief(kernel_ms["K1_fallback", V]),
                                          designs=kernel_ms["K1_fallback", V]["designs"])
                            for V in (traversal8.V_COHERENT, traversal8.V_INCOHERENT)},
             by_tracer=dict(sm_by_tracer("K1", "K1_fallback"),
                            san_miguel_pt=pt_fallback)),
        vrow("traverse8_kernel", "traversal8.cu",
             "cudatracerlib_tpu/ops/traversal_pl.py:188",
             sum(K1_THREAD_LAUNCHES.values()),
             max_err(k1_sm, None), k1_sm["mixed", None], variant="global",
             design="thread", launches_by_run=dict(K1_THREAD_LAUNCHES),
             fallback_by_v={f"V{V}": dict(
                 device_ms=kernel_ms["K1_fallback", V]["designs"]["thread"])
                 for V in (traversal8.V_COHERENT, traversal8.V_INCOHERENT)},
             by_tracer={})]
    def mb_row(entry):
        return (entry["max_abs_err"], entry["ms"], entry["plain_ms"],
                (entry["bound_ms"], entry["bound_by"]))

    def p1_entry(mode, param=None, rows=mb.ROW_TABLE_ROWS, occupancy="chains"):
        return next(e for e in res["P1"] if e["rows"] == rows and e["mode"] == mode
                    and (param is None or e["param"] == param)
                    and e["occupancy"] == occupancy and e["words"] == mb.ROW_WORDS)
    p1 = p1_entry("thread")

    def p1_row(name, mode, param=None):
        """P1 in `mode` at the kernel table's row shape (veach-mis's 331
        rows, 1,024 chains, whole rows; the plain version's time is the
        thread row's: one function, one shape), its ns per dependent row at
        every size, occupancy and read width under by_size."""
        e = p1_entry(mode, param)
        return row(name, "microbench.cu", "tools/microbench_r2.py:89",
                   p1_by_mode[mode], e["max_abs_err"], e["ms"], p1["plain_ms"],
                   (e["bound_ms"], e["bound_by"]), mode=mode, param=param,
                   ns_per_dependent_row=e["ns_per_dependent_row"],
                   by_size={f"{x['rows']} {x['occupancy']} w{x['words']}":
                            x["ns_per_dependent_row"]
                            for x in res["P1"] if x["mode"] == mode
                            and (param is None or x["param"] == param)})
    p2 = next(e for e in res["P2"] if e["rows"] == mb.ROW_TABLE_ROWS
              and e["layout"] == "thread")

    def take_row(design):
        """P2 (a) in `design` on the game frame's neighbourhood gather (the
        row's shape), both recorded streams under by_shape, each with
        index_select's and the port's time beside it."""
        es = {e["call"]: e for e in res["take"] if e["design"] == design}
        e = es["game_neighbors"]
        return row(f"gather_take_{design}_kernel", "microbench.cu",
                   "tools/microbench_r2c.py:67", by_kind["P2_take"][design],
                   max(x["max_abs_err"] for x in es.values()), e["ms"], e["plain_ms"],
                   (e["bound_ms"], e["bound_by"]), library_ms=e["library_ms"],
                   library="torch.index_select (int32 index; building it untimed)",
                   plain="the port's table[idx.long()]", design=design,
                   by_shape={c: dict(rows=x["rows"], gathers=x["gathers"],
                                     ms=x["ms"], library_ms=x["library_ms"],
                                     port_take_ms=x["plain_ms"], bound_ms=x["bound_ms"],
                                     bound_share=x["bound_share"], kept=x["kept"],
                                     faster_than_index_select=x["faster_than_index_select"])
                             for c, x in es.items()})

    def step_row():
        """P2 (b): a node step at one warp an SM (the row's shape; the
        plain version's time there), every kind and occupancy under
        by_kind."""
        e = next(x for x in res["step_only"] if x["kind"] == "node"
                 and not x["any_hit"] and x["occupancy"] == "warp")
        return row("step_only_kernel<node|leaf,closest|any_hit>", "microbench.cu",
                   "tools/microbench_r2c.py:37", mb_launches["P2_step_only"],
                   max(x["max_abs_err"] for x in res["step_only"]), e["ms"],
                   e["plain_ms"], (e["bound_ms"], e["bound_by"]),
                   step_arith_ns=arith_ns,
                   by_kind={f"{x['kind']} {'any_hit' if x['any_hit'] else 'closest'} "
                            f"{x['occupancy']}": dict(
                                ms=x["ms"], ns_per_step=x["ns_per_step"],
                                ns_per_lane_step=x["ns_per_lane_step"], lanes=x["lanes"],
                                launches_by_kind=by_kind["P2_step_only"][x["kind"]])
                            for x in res["step_only"]})

    def queue_row(name, form):
        """P3 in `form` at full occupancy on ROW_QUEUE_ITEMS items (the
        threshold form: the recorded veach-mis stream), every occupancy and
        size under by_run. No PyTorch call computes a queue hand-out."""
        es = [e for e in res["P3"] if e["form"] == form]
        e = next(x for x in es if x["items"] == mb.ROW_QUEUE_ITEMS
                 and x["occupancy"] == "full")
        return row(name, "microbench.cu", "tools/probe_mosaic_pool.py:24",
                   by_kind["P3"][form], max(x["max_abs_err"] for x in es), e["ms"],
                   e["plain_ms"], (e["bound_ms"], e["bound_by"]), form=form,
                   pallas_kernels="k_gather16 :40, k_gather8 :50, k_prefix :62, "
                                  "k_dot :79, k_onehot :93",
                   library="none: no PyTorch call hands out a queue",
                   by_run={f"{x['occupancy']} {x['items']}": dict(
                       ms=x["ms"], ns_per_claim=x["ns_per_claim"],
                       ns_per_item=x["ns_per_item"], warps=x["warps"],
                       fetch_share=x.get("fetch_share")) for x in es})
    # the instanced slice's shapes (9b, 9c, 9d): every call of one
    # traversal, summed, beside the launches of a pass of its path tracer
    def inst_entry(traversal, kind, pt):
        return dict(inst_res[traversal][kind], pass_launches=inst_res[pt]["launches_per_pass"],
                    seconds_per_pass=inst_res[pt]["seconds_per_pass"])
    k1_rows[0]["by_tracer"]["instanced_grid"] = inst_entry("grid_traversal", "K1", "grid_pt")
    # the loaded Cornell box's K1 launches, under the variant and design
    # they took (the per-thread design on a global table)
    lc = loader_res["loader_cornell"]
    k1_rows[0 if lc["variant"] == "shared" else 2]["by_tracer"]["loader_cornell"] = lc
    # every K1 global call held, with its chain floor from this run's P1
    # and step_only
    k1_global = k1_global_lines(res["P1"], mb, dict(thread=arith_ns, group=lane_ns))
    ratios = [r for c in (*k1_global, *SM48_K2_LINES) for r in c["floor_ratio"].values()]
    emit(phase="floor_summary", nvidia_smi=card, step_arith_ns=arith_ns,
         lane_arith_ns=lane_ns,
         calls=len(k1_global) + len(SM48_K2_LINES),
         floor_ratio_min=min(ratios) if ratios else None,
         floor_ratio_max=max(ratios) if ratios else None,
         under_1=sum(r < 1 for r in ratios))
    k1_rows[1]["calls"] = len(k1_global)
    k2_shared = k2_row("top_visits_shared_kernel", None)
    # K2's split variant on the 4.8M pass: every K2 call of one pass
    # summed (each a main-path launch: sm48's launches per pass)
    big = max(SM48_K2_CALLS, key=lambda c: c["bound_ms"])
    k2_split = row(
        "top_visits_split_kernel<V>", "traversal_tt.cu",
        "cudatracerlib_tpu/ops/traversal_tt.py:185",
        sm48["counts_per_pass"]["K2_by_variant"]["split"] * SM48_PASSES,
        max(c["max_abs_err"] for c in SM48_K2_CALLS),
        sum(c["ms"] for c in SM48_K2_CALLS), sum(c["plain_ms"] for c in SM48_K2_CALLS),
        (sum(c["bound_ms"] for c in SM48_K2_CALLS), big["bound_by"]),
        device_ms=k2_sums["split"]["device_ms"], variant="split",
        cluster_blocks=sm48["blocks"], top_rows=sm48["top_rows"],
        calls=len(SM48_K2_CALLS),
        launches_per_pass=sm48["counts_per_pass"]["K2_by_v"],
        chain_floor_ms=k2_sums["split"]["chain_floor_ms"],
        floor_ratio=k2_sums["split"]["floor_ratio"], designs=k2_sums,
        seconds_per_pass=sm48["seconds_per_pass"], mrays_per_s=sm48["mrays_per_s"])
    k3_kept = k3_row("treelet_hits_kernel", "traversal_tt.cu", None)
    for kind, kernel_row in (("K1", k1_rows[1]), ("K2", k2_shared), ("K3", k3_kept)):
        # the instanced visits' K1 fallback runs one thread per ray
        inst_row = k1_rows[2] if kind == "K1" else kernel_row
        inst_row["by_tracer"]["instanced_bench"] = inst_entry("bench_traversal", kind,
                                                              "bench_pt")
        inst_row["by_tracer"]["instanced_bench_pt"] = inst_entry("bench_pt_traversal",
                                                                 kind, "bench_pt")
        for name in ("loader_materials", "loader_sm"):
            kernel_row["by_tracer"][name] = loader_res[name].get(kind)
        n_par = par_n["K1"].get("global", 0) if kind == "K1" else par_n[kind]
        kernel_row["launches"] += n_par
        kernel_row["by_tracer"]["parallel_san_miguel"] = dict(
            launches=n_par, held=par["held"]["pt_san_miguel"].get(kind))
    # K4's rows: each row source on its main shape (veach-mis, San Miguel's
    # fallback batch at V=3, mixed), the probe's K4 designs on veach-mis;
    # every natural-mode set and recorded pass of pool_vs_k1 under by_set
    pool_totals = pool_summary(card)
    f_kept, r_kept = traversal8.pool_schedule()

    def pool_row(name, src, design, main, variant=None):
        recs = [r for r in POOL_VS_K1 if r["design"] == design
                and r.get("natural", r["mode"] == "pass")
                and (variant is None or r["variant"] == variant)]
        return row(name, src, "cudatracerlib_tpu/ops/traversal_pl.py:298", 0,
                   max(r["err"] for r in POOL_VS_K1 if r["design"] == design),
                   main["ms"], main["plain_ms"], (main["bound_ms"], main["bound_by"]),
                   device_ms=main["device_ms"], util=main["util"], on_path=False,
                   design="kept" if design == "k4" else design,
                   fetch_idle=f_kept if design == "k4" else None,
                   fetch_rounds=r_kept if design == "k4" else None,
                   device_ms_summed=pool_totals.get(design),
                   by_set={r["set"]: dict(mode=r["mode"], device_ms=r["device_ms"],
                                          util=r["util"], bound_ms=r["bound_ms"])
                           for r in recs})
    k4_rows = [pool_row(f"traverse_pool_shared_kernel<{f_kept},{r_kept}>",
                        "traversal_pool.cu", "k4", k4_veach["mixed", "k4"], "shared"),
               pool_row(f"traverse_pool_kernel<{f_kept},{r_kept},1>", "traversal_pool.cu",
                        "k4", k4_sm[traversal8.V_INCOHERENT]["mixed", "k4"], "global"),
               *(pool_row(f"probe_pool<{d}>", "schedule_probe.cu", d,
                          k4_veach["mixed", d]) for d in POOL_DESIGNS[3:])]
    emit(kernels=[
        *k1_rows,
        k2_shared,
        k2_split,
        dict(k2_row("probe_top_global_kernel<V>", "global", "schedule_probe.cu"),
             sm48=k2_sums.get("global")),
        k3_kept,
        *(k3_row(f"probe_treelet_kernel<{d}>", "schedule_probe.cu", d)
          for d in probe.K3_DESIGNS),
        *k4_rows,
        p1_row("chase_rows_kernel", "thread"),
        p1_row("chase_rows_shared_kernel", "shared"),
        p1_row("chase_rows_group_kernel<16>", "group", 16),
        p1_row("chase_rows_cluster_kernel<2>", "cluster", 2),
        p1_row("chase_rows_bulk_kernel", "bulk"),
        row("gather_rows_thread_kernel", "microbench.cu",
            "tools/microbench_r2c.py:67", mb_launches["P2_rows"], *mb_row(p2)),
        *(take_row(d) for d in mb.TAKE_DESIGNS),
        psf_row(),
        step_row(),
        queue_row("queue_fetch_kernel", "memset"),
        queue_row("queue_fetch_work_kernel", "work"),
        queue_row("queue_fetch_threshold_kernel<8,4>", "threshold")])
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
