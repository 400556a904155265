"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (the order of the run is given after the list); any failure raises
and the exit code is non-zero:
  1. build every CUDA source of ``semantic_suma_tpu_torch/csrc`` with nvcc
     for sm_90a (one process per source, in parallel) and the native scan
     loader (``native/scan_loader.cpp``) with g++, then measure the
     card's floors: the replayed-graph time of an empty kernel
     (``launch_floor_ms``) and its rate of 64-bit atomics on distinct cells;
  2. kernel A (bilateral filter) against its plain PyTorch version at 64x900
     on a rendered scan and on a random map with invalid pixels on the wrap
     columns and the top and bottom rows, at R = 6 (the unrolled
     instantiation) and R = 3 (the generic one) (rtol = atol = 2e-5);
  3. kernel B (z-buffer) against its plain version at the projection shape
     (57,600 candidates into 57,600 cells), the projection of a KITTI scan
     (124,672 candidates into 57,600 cells), the fusion shape (2^18
     candidates, 2 flags, one of them existence-only) and the three render
     shapes of loop closure (2^18, 2^17 and 2^19 candidates, no flag: the
     search view, the verify view, a composed render), with forced depth
     ties, signed zeros, NaNs and invalid ids, in the packed-key and the
     exact branch, with int64 and int32 ids, bool and uint8 flags, on
     consecutive calls with different inputs on one key table, with no
     candidate at all, and once more after CUDA-graph replays: winners,
     winner depths and existence must be exactly equal and the key table
     must be left empty;
  4. the card against the CPU on a small input: 10 scans at 32x180, each
     scan's CPU step (plain versions) started from a copy of the card's
     state; poses must agree within 1e-3 m and 1e-3 rad;
  5. the main path: ``SurfelSLAM`` (loop closure and spill off) on cuda over
     8 warm-up + 60 timed full-width scans of the synthetic world with the
     bilateral filter on; launch counters are zeroed just before it and read
     just after; asserts that kernels A and B ran, kernel F once a
     ``gauss_newton`` call and kernels D and E never, no creation was
     dropped, and the aligned ATE against ground truth is no worse than the
     JAX package's on the same cell (``compare/filtered_main_jax.json``,
     written by ``compare/filtered_main.py jax``); counts each timed step's
     synchronizing CUDA operations (CUDA sync debug mode) over the whole
     step and its ``to_host`` reads, and asserts that no step synchronizes
     more than once (twice on a scan whose fallback runs: the branch
     flags), its Gauss-Newton loops not at all; times the flag read; then
     steps each of the 68 scans from one state twice, with kernel F and
     with the plain versions of kernels D and E on the latch: on every scan
     that neither run caps the poses agree within 1e-4 m and 1e-5 rad;
  6. the package's default path once (``use_filtered_vertexmap=False``,
     8 + 30 scans of the same world): finite poses, no dropped creation,
     phase 5's synchronization bound and its launches of F, D and E;
  7. the pose graph: rings of 128 to 4096 poses with noisy odometry and 8
     robust loop edges, each solved on the card and with ``device="cpu"``;
     the two results must agree (1.5e-4 m and rad at 128 poses, growing with
     the ring's length) and the error must fall; both times and the card
     run's host reads are printed: the loop closer's small-graph rule
     (``SMALL_GRAPH_POSES``) is set from them;
  8. the loop-closure path: ``SurfelSLAM`` with ``loop_config()`` over a
     64-scan lap and 60 timed scans of continuous revisit through
     ``process_scan_async``, then ``finalize()``; launch counters are zeroed
     just before it and read just after the timed lap; asserts at least one
     closure and one optimization, finite poses, no dropped creation and the
     aligned ATE limit; prints scans/s, the loop counters, and per call the
     host reads, Gauss-Newton calls and iterations by scan type (cruising,
     verifying, searching), the device launches of some more scans traced
     one by one, the ``Stopwatch`` summary and kernel B's launches by shape;
     then holds kernel B exactly to its plain version on the candidates of
     real old views of that run (search, verify and composed shapes), and
     ``verify`` on the card to ``verify`` on a CPU copy of the same state;
     four more scans take the graph past ``SMALL_GRAPH_POSES``, so that
     ``finalize()`` solves it on the card (asserted);
  9. the loop-closure path with range noise (100 scans, sigma 0.03 m), so
     that corrections pass the rebase gates: asserts at least one full
     rebase, one traced searching call, one traced rebasing call, a closure,
     finite poses, no dropped creation and its own ATE limit; its launch
     counters are zeroed and read around it as well;
 10. the accuracy ledger through the CLI (``tools/make_results.py``:
     ``cli.main`` in this process at the CLI's own sizing, spill on): the
     150-scan odometry row, the 150-scan noisy row (2 cm range noise) and
     the 140-scan loop row (``configs/synthetic_loop.xml``), each within
     twice the JAX package's round-5 RESULTS row, the odometry and loop rows
     with no dropped creation, the loop row with at least 20 closures;
 11. the KITTI file path: a 40-scan synthetic sequence exported in the KITTI
     layout, ``cli run --dataset`` with pose export and ``cli eval`` of the
     exported file with the calibration: the two ATEs equal to 1e-6 m and
     under 0.01 m; phase 3 holds kernel B at the shape of a KITTI scan
     (124,672 points into 57,600 cells);
 12. forced spill at full width (``tests/test_spill.py``'s configuration at
     64x900 on a 3 x 2^18-row arena, 80 noisy scans through
     ``process_scan_async`` and ``finalize()``): spilled rows before scan
     45, a chunk paged back in, a closure, at most 1% of the creations
     dropped, the final position within 0.5 m of that of the same scans with
     spill off on a 2^21-row arena; the spill-out, page-in and probe laps
     printed;
 13. the segmenter's two versioned networks (``weights/segmenter_synth_mid``
     and ``_full``) at 1x64x928 on one rendered scan, the card's logits
     against a CPU copy's: label agreement >= 0.99 on valid pixels; the ms
     of a call by stage (projection, network, KNN vote + labels), its peak
     memory, and no host sync in a call;
     ``[segmenter-graph]``: the three benchmark networks (darknet53,
     SalsaNext, SqueezeSegV3-53) through ``Segmenter.__call__`` on 6
     consecutive 64x2048 scans of their cells, an eager call, a capture,
     replays: logits, labels and probabilities equal to the eager path's
     bit for bit, no host sync in a replayed call, at most 4 launches in
     its network span; launches, capture ms, ms a call and memory before
     and after the capture printed;
     ``[segmenter-epilogue]``: darknet53's batch-norm epilogue
     (``csrc/bn_act.cu``) at 64x2048 on a scan of its cell: each of a
     forward's 72 calls equal to its plain version on its own inputs, the
     walk's logits and labels equal to the module forwards' bit for bit,
     eager and replayed, 72 launches a forward and none for SalsaNext;
     each site shape's kernel ms beside its bytes bound and the plain
     version's ms, and the ``segmenter/network`` busy ms with the module
     forwards and with the walk;
     ``[segmenter-sac]``: SqueezeSegV3-53's SAC kernel (``csrc/sac.cu``)
     at 64x2048 on scans of its cell: each of a forward's 23 calls, and
     four shapes whose widths leave a partial tile or fit in one, within
     one bfloat16 ulp of its plain version on its own inputs (the unequal
     elements printed: 0 so far); each site shape's kernel ms alone in a
     replayed graph beside its bytes bound and the plain version's ms; its
     attention kernel (``csrc/sac_attention.cu``) on the same 23 calls and
     on the four shapes at their channels against the library path (cuDNN
     and ATen's bias add) and against float64, the unequal elements and
     the largest ulps printed, held to at most one bfloat16 ulp of the sum
     further from float64 than the library path (only the order of its
     147-term sums differs; where the bias cancels the sum, ulps of the
     result count the cancellation),
     each site shape's ms beside its bytes and FLOPs bounds and the library
     path's ms; 23 launches of each kernel a call, eager and replayed,
     counted as the path ``segmenter_sac``, the only one that launches
     them;
 14. kernel C (KNN label vote) against its plain version at 64x900 on two
     random inputs (forced depth ties, +-inf, NaN, all-invalid rows, ties
     across the wrap seam), an input of runs of equal range differences
     with NaN and +-inf, and the mid network's output of phase 13, on
     consecutive calls and after CUDA-graph replays, and at 32x450,
     32x180, 16x96, 1x7 and 7x1: exactly equal; its replayed-graph time
     beside the earlier kernel's;
 15. both networks' mIoU on the 12 held-out synthetic scans of their
     ``.json``, each within 0.03 of the recorded value;
 16. the segmenter in the loop (``bench.py:217-242``): the mid network
     labels each of 8 warm-up + 60 timed scans for ``process_scan_async``
     at the bench configuration; scans/s on the host clock, one vote and
     two projections a scan, no dropped creation;
 17. the KITTI file path with the network's labels: 20 exported scans,
     ``cli run --dataset ... --segmenter-weights ... --no-gt-labels
     --eval``, ATE under 0.01 m;
 18. ``[train-parity]``: one float32 training step of ``small_rangenet`` at
     2x64x900 on the card and on the CPU from the same weights and batch
     (TF32 off): the loss within 1e-5, the batch statistics within 1e-4 and
     every gradient leaf within 5e-2 of its scale (``leaky_relu``'s kink
     moves the leaves behind an input that falls on its other side);
 19. ``[train]``: the ms of a ``mid_rangenet`` training step (batch 8,
     CUDA events, no host sync in a step), then ``cli train-segmenter``
     with the mid recipe of ``weights/segmenter_synth_mid.pkl.json`` (the
     small recipe if 2000 steps would take over ``TRAIN_BUDGET_S``) into a
     temporary file: held-out mIoU over 0.8138 (0.5 for the small recipe),
     peak memory, host reads a step, wall time, and the written blob's
     labels of one scan against the versioned mid network's;
 20. ``[checkpoint]``: the loop path at full width stopped after 70 scans,
     saved (compacted and as it is), resumed in a fresh ``SurfelSLAM`` and
     continued for 20 scans against the same run without a stop; then an
     archive that the CPU wrote (the stop, 2 scans on the CPU) resumed on
     the card: pose differences, loop state, archive size, save and load
     times;
 21. ``[cli-plots]``: ``cli run --synthetic 20 --plot-dir --save-viewer
     --save-checkpoint`` and ``cli eval --plot-dir``: every file the JAX
     CLI writes, by name, not empty;
 22. ``[readers]``: the native loader on phase 11's 40 files equals numpy
     exactly (ms a scan both ways); the same scans as RobotCar files read
     back exactly, 20 of them through ``SurfelSLAM``: ATE under 0.01 m;
 23. ``[sharded]``: ``cli run --sharded 2`` on the loop row (140 scans,
     64x900, a 2^21-row arena split over 2 ranks on the one card, gloo):
     scans/s, ATE, t_rel, closures (at least one), rebases, no dropped
     creation, each rank's peak memory, launches and collectives a scan
     (CUDA events); then the same run on one device. Then
     ``[sharded-syncs]``: phase 5's cell and first scans on two ranks,
     each step's synchronizations (CUDA sync debug mode) and host reads
     beside one device's. Every sharded phase (23 to 25 and the
     sharded-8dev row) asserts that its Gauss-Newton iterations ran on
     kernels D and E (as many launches of each, at least one);
 24. ``[sharded-nccl]``: ``--sharded 1`` over nccl (the backend rule's
     choice for one rank on one card) and over gloo, 20 scans: the poses
     exactly equal;
 25. ``[sharded-checkpoint]``: phase 23's run stopped at scan 70, saved and
     resumed in fresh ranks: the position difference beside the floor (two
     card runs of the same scans), within ``max(3 * floor, 1 mm)``; the
     archive's size, save and load times;
 26. ``[sharded-train]``: one data-parallel step of the f32 mid network at
     8x64x900 as 2 ranks of 4 against one device's step of 8:
     ``[train-parity]``'s limits; the ms a step of each;
 27. ``[multihost]``: ``parallel.multihost_smoke`` as 2 processes on the
     card: both ``MULTIHOST OK`` lines;
 28. ``[chunked]``: phase 5's cell and scans through ``process_scan_async``
     with ``chunk_size=8`` at ``pipeline_depth`` 4 and 1, beside two
     per-step runs (``chunk_size=1``, depth 4): the depth-1 run within
     ``max(3 x floor, 1 mm)`` of the per-step poses and its last map count
     within 0.5% (at depth 4 the near-capacity rule compacts the arena at
     most drains, which moves the map: that run is held to the ATE limit and
     its difference printed); every run's ATE no worse than phase 5's
     reference, scans/s, host reads and fetches a scan (the depth-1 run
     reads the host less than the per-step runs), phase 5's
     synchronization bound over each run's timed scans, and phase 5's
     launches of F, D and E on the depth-4 run;
 29. ``[sharded-train-2d]``: phase 26's batch on 4 ranks as a 2 x 2 ``("data",
     "model")`` grid (``make_2d_mesh``; the kernels of >= 128 output channels
     split over ``model``) against the same one-device step:
     ``[train-parity]``'s limits on the loss, the batch statistics and every
     gathered gradient, the updated weights as far as the gradients explain;
     ms a step, each rank's peak memory, bytes of parameters and moments
     beside the replicated layout's, and the collectives of a step;
 30. ``[icp]``: kernels D and E (``csrc/icp.cu``: one Gauss-Newton
     linearization and its update) against their plain versions at the
     inputs of a scan of the main cell and of the default one (57,600 data
     pixels against a 64x900 model), from states at iterations 0 and 1: D's
     counters exactly equal and its sums within 1e-5 of their
     Cauchy-Schwarz scale, E's integer state exactly equal, its pose within
     1e-5 and its error sums within 1e-5 relative; a whole loop each way.
     Kernel F (the whole loop in one cooperative launch) at those inputs,
     at the main ones with turkey weights and bilinear sampling, against an
     empty model and on data whose solve fails, each at max_iterations 1, 2
     and 33: its state equal to the trips of D and E on the latch bit for
     bit, and to its plain version within E's limits (1e-4 m and 1e-5 rad
     on a whole loop that neither caps). The times of D and E (replayed
     graph, eager, latched), of their plain versions and of cuBLAS's
     ``rows.T @ rows``; of F (a call, eager, an iteration, its plain
     version, its grid); and a ``gauss_newton`` call (one launch of F
     asserted, no host read) against the trips of D and E and the host
     loop. The sharded route of ``gauss_newton`` (``group=``: D and E,
     the partial sums added over the ranks) at one rank equal to F bit for
     bit at the main and default inputs, and two ranks emulated (D on each
     half of the rows, the buffers added, E) against the plain versions
     within E's limits. Every ``build_rows`` call on the card here is a
     deliberate plain-version check, counted apart. Phase 8 holds D, E, F
     and the sharded route the same way at the inputs of a verify program,
     and ``evaluate`` (kernel F's first iteration) against ``build_rows``'
     statistics at the composed view: counts exact, error sums within 1e-5
     relative.
Phase 10 runs the segmenter and segmenter-full rows as well (each within
twice the JAX package's round-5 row, no dropped creation) and the
sharded-8dev row (8 ranks on the card; twice the JAX row, which was taken
on a virtual CPU mesh; its full arena drops creations in both packages,
held within 1% of JAX's count). Phases 13 to 15 and 30 run right
after phase 3, phase 28 after phase 5, phase 22 after phase 11, phases 16
to 21 and 23 to 27 last, with 29 after 26.
Each of phases 5, 8, 9, 10 to 12, 16, 17, 19 to 25 and 28 counts the kernels'
launches from zero just before its run and reads them just after (a
sharded run's ranks start from zero in their own processes and send their
counts back: the sum and each rank's are printed), with the calls of
``evaluate`` and of ``build_rows`` on CUDA tensors: every path is held to
0 of the latter (no plain linearization on the card), the single-device
paths to one launch of F a ``gauss_newton`` or ``evaluate`` call and
none of D and E. It prints the card's name and power limit, one
``{"kernels": [...]}`` line with a record for kernel A, for kernel B at each
shape that a path launched, for kernel C, the epilogue (``bn_act``, its
``ms``, ``bound_ms`` and ``plain_ms`` those of a darknet53 forward's calls
in phase 13), the SAC kernel (``sac_modulate``) and the attention kernel
(``sac_attention``, its ``library_ms`` cuDNN's convolution and ATen's bias
add), those of a SqueezeSegV3-53 forward's calls in phase 13, and kernels D,
E and F (``launches`` is
the sum over the paths, ``launches_by_path`` the parts; what no path
launches, a KITTI scan's projection (phase 3) and the two-stream render
(phases 3 and 8), are listed in a ``{"held_off_path": [...]}`` line with 0
launches; phase 11 prints the sizes of the projections it launched), and
last one
``{"ok": true, "device": {...}}`` line. ``[time]`` lines give each phase's
seconds. Imports no JAX.

Kernel times are device times: one call captured in a CUDA graph and
replayed; the time of eager calls from Python is printed beside them. A
kernel's bound is the largest of the times its bytes, its arithmetic and
(kernel A) its exponentials or (kernel B) its unavoidable atomics need at
the card's peak rates; every one of them lies under ``launch_floor_ms``.
No single PyTorch call computes kernel C's vote, kernel E's solve and
update or kernel F's loop: their ``library_ms`` is null; kernel D's is
cuBLAS's ``rows.T @ rows`` on the plain version's rows (the reduction
alone). Kernel F's cooperative launch is captured and replayed like the
others.
``--profile-scans N`` traces N more scans after the main path with
``torch.profiler`` and prints the device time by kernel and the idle share,
and does the same for up to ``LOOP_PROFILE_SCANS`` (4) more scans of the
loop path, whose arena holds no more.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
SMS = 132
SFU_PER_SM_PER_CLOCK = 16   # exp2, rsqrt, ...: results per SM per clock

# aligned ATE limit of the loop path (phase 8): PERF.md says where it is from
LOOP_ATE_LIMIT_M = 0.01


def _events_ms(fn, iters: int, warmup: int) -> float:
    """Mean ms per call over ``iters`` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, calls: int = 1) -> float:
    """Device ms per call: ``calls`` calls captured in one CUDA graph and
    replayed, so the host's Python, ctypes and allocation work between
    calls is out of it."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return _events_ms(graph.replay, iters, 10) / calls


def time_ms(fn, iters: int, warmup: int = 3):
    """(device ms, eager ms) per call: one call in a replayed graph, and
    back-to-back calls from Python, which bounds a caller when the host is
    the slower side."""
    eager = _events_ms(fn, iters, warmup)
    return graph_ms(fn, iters), eager


def _smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def phase_build():
    from semantic_suma_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    built = cuda_build.build_all(force=True)
    dt = time.perf_counter() - t0
    print(f"[build] {sorted(built)} in {dt:.1f} s (parallel nvcc, sm_90a)")
    for name, rec in built.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    missing = set(cuda_build.sources()) - set(built)
    if missing:
        raise RuntimeError(f"kernels not rebuilt from source: {missing}")
    from semantic_suma_tpu_torch.io import native_io
    native_io.lib_path().unlink(missing_ok=True)
    t0 = time.perf_counter()
    lib = native_io.build()
    print(f"[build] native scan loader ({native_io.SRC.name}, g++ "
          f"{' '.join(native_io.CXX_FLAGS)}) in "
          f"{time.perf_counter() - t0:.1f} s -> {lib.name}")
    return dt


def phase_floors(dev):
    """The card's floors under the kernels' bounds: the replayed-graph time
    of an empty kernel, and the rate of 64-bit atomicMin on distinct,
    neighbouring cells of a table that fits L2 (2^22 cells, four calls a
    graph so that the launch floor is out of it)."""
    import ctypes

    from semantic_suma_tpu_torch.ops import cuda_build
    lib = cuda_build.library("probes")
    p = ctypes.c_void_p
    lib.empty_launch.argtypes = [p]
    lib.atomic_probe.argtypes = [p, ctypes.c_longlong, ctypes.c_longlong, p]

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def empty():
        cuda_build.check(lib.empty_launch(stream()), "empty_launch")

    floor_ms, eager_ms = time_ms(empty, 2000)
    n = 1 << 22
    cells = torch.full((n,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                       device=dev)

    def probe():
        cuda_build.check(lib.atomic_probe(cells.data_ptr(), n, 0, stream()),
                         "atomic_probe")

    probe()
    torch.cuda.synchronize()
    if not torch.equal(cells, torch.arange(n, device=dev)):
        raise AssertionError("atomic probe wrote other keys than offered")
    atomics_per_s = n / (graph_ms(probe, 200, calls=4) * 1e-3)
    sm_hz = float(_smi("clocks.max.sm").split()[0]) * 1e6
    print(f"[floor] launch_floor_ms {floor_ms:.5f} (one empty kernel in a "
          f"replayed graph; eager from Python {eager_ms:.5f}); 64-bit "
          f"atomicMin on distinct cells {atomics_per_s / 1e9:.1f} G/s; "
          f"SM clock (max) {sm_hz / 1e6:.0f} MHz")
    return {"launch_floor_ms": floor_ms, "atomics_per_s": atomics_per_s,
            "sm_hz": sm_hz, "empty_launch": empty}


def _needed_taps(valid: torch.Tensor, radius: int) -> int:
    """(valid pixel, valid neighbour) pairs of the (2R+1)^2 window: columns
    wrap, rows outside the image are dropped."""
    h = valid.shape[0]
    total = torch.zeros((), dtype=torch.int64, device=valid.device)
    for dy in range(-radius, radius + 1):
        lo, hi = max(0, -dy), min(h, h - dy)
        centre = valid[lo:hi]
        for dx in range(-radius, radius + 1):
            nb = torch.roll(valid[lo + dy:hi + dy], -dx, dims=1)
            total += (centre & nb).sum()
    return int(total)


def phase_bilateral(dev, floors):
    from semantic_suma_tpu_torch.config import DataConfig
    from semantic_suma_tpu_torch.io.simulation import (circular_trajectory,
                                                       default_world,
                                                       render_scan)
    from semantic_suma_tpu_torch.ops.bilateral import (bilateral_filter,
                                                       bilateral_filter_plain)
    from semantic_suma_tpu_torch.ops.projection import project_scan

    cfg = DataConfig()
    h, w = cfg.height, cfg.width
    pose = circular_trajectory(1, radius=18.0, step=1.5, device=dev)[0]
    scan = render_scan(default_world(0, extent=45.0), pose, cfg)
    proj = project_scan(scan.points, scan.labels, scan.probs, cfg=cfg,
                        point_valid=scan.valid)
    rng = np.random.default_rng(0)
    rand_v = rng.normal(size=(h, w, 3)).astype(np.float32) * 5 + 10
    rand_ok = rng.uniform(size=(h, w)) >= 0.1
    for sl in ((slice(None), 0), (slice(None), w - 1), (0, slice(None)),
               (h - 1, slice(None))):
        rand_ok[sl] = rng.uniform(size=rand_ok[sl].shape) >= 0.5
    inputs = [("scan", proj.vertex_map, proj.vertex_valid),
              ("random", torch.from_numpy(rand_v).to(dev),
               torch.from_numpy(rand_ok).to(dev))]
    sig_s, sig_r = 0.5 * 9.0, 2.5  # preprocess_scan's sigmas
    # R = 6 is the unrolled instantiation the path runs, R = 3 the generic
    # one. rtol = atol = 2e-5: the kernel's approximate exp2 and FMAs differ
    # from the plain version's expf by ~1e-6 relative
    err = 0.0
    for radius in (6, 3):
        for name, vm, vv in inputs:
            got = bilateral_filter(vm, vv, sig_s, sig_r, radius)
            want = bilateral_filter_plain(vm, vv, sig_s, sig_r, radius)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
            e = float((got - want).abs().max())
            err = max(err, e)
            print(f"[bilateral] R={radius} {name}: max |kernel - plain| = "
                  f"{e:.3e} (valid {int(vv.sum())}/{h * w})")
    vm, vv = inputs[0][1], inputs[0][2]
    ms, eager_ms = time_ms(lambda: bilateral_filter(vm, vv, sig_s, sig_r),
                           2000)
    plain_ms, _ = time_ms(
        lambda: bilateral_filter_plain(vm, vv, sig_s, sig_r), 5, warmup=1)
    # the work of the function on this scan: vertex read (12 B), valid read
    # (1 B), output written (12 B); for each tap that a valid pixel takes
    # from a valid neighbour ~8 fp32 operations and one exponential, which
    # the special-function units retire at 16 per SM per clock
    taps = _needed_taps(vv, 6)
    terms = {"bytes": h * w * (12 + 1 + 12) / HBM_BYTES_PER_S * 1e3,
             "fp32": taps * 8 / FP32_FLOP_PER_S * 1e3,
             "exp": taps / (SMS * SFU_PER_SM_PER_CLOCK * floors["sm_hz"])
             * 1e3}
    bound_ms = max(terms.values())
    print(f"[bilateral] kernel {ms:.5f} ms (eager calls {eager_ms:.5f} ms), "
          f"plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms ("
          + ", ".join(f"{k} {v:.5f}" for k, v in terms.items())
          + f" over {taps} valid taps), launch floor "
          f"{floors['launch_floor_ms']:.5f} ms")
    return {"name": "bilateral_filter", "route": "cuda",
            "source": "semantic_suma_tpu_torch/csrc/bilateral.cu",
            "replaces": "semantic_suma_tpu/ops/pallas_kernels.py:84",
            "max_abs_err": err, "ms": ms, "eager_ms": eager_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_ms == terms["bytes"]
            else "operations", "library_ms": None}


def _zb_inputs(n, cells, n_flags, seed, dev):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-2000, cells + 2000, size=n)       # ~7% invalid ids
    depth = rng.uniform(0.0, 130.0, size=n).astype(np.float32)
    depth[: n // 4] = np.round(depth[: n // 4], 1)        # forced ties
    special = np.array([0x00000000, 0x80000000, 0xC0400000, 0x7F800000,
                        0x7FC00000, 0xFFC00000, 0x7FC00001],
                       np.uint32).view(np.float32)  # 0, -0, -3, inf, NaNs
    depth[n // 4: n // 4 + 7 * 64] = np.repeat(special, 64)
    flags = tuple(torch.from_numpy(rng.uniform(size=n) < 0.5).to(dev)
                  for _ in range(n_flags))
    return (torch.from_numpy(ids).to(dev), torch.from_numpy(depth).to(dev),
            flags)


def _same(got, want) -> bool:
    """Winners equal and winner depths equal bit for bit (NaNs included)."""
    return torch.equal(got[0], want[0]) and torch.equal(
        got[1].view(torch.int32), want[1].view(torch.int32))


def _zb_err(got, want) -> float:
    """Largest |kernel - plain| over the winners and over the winner depths
    that are finite in both (the rest compare by their bits in ``_same``)."""
    both = torch.isfinite(got[1]) & torch.isfinite(want[1])
    return max(float((got[0] - want[0]).abs().max()),
               float(torch.where(both, got[1] - want[1], 0.0).abs().max()))


def _traced_launches(fn) -> int:
    """Kernels, copies and fills that ``fn`` puts on the card, traced."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def _device_launches(fn) -> int:
    """The same for the second of two calls of ``fn``."""
    fn()
    torch.cuda.synchronize()
    return _traced_launches(fn)


# a scan of the HDL-64 that KITTI recorded: ~120k to 130k points, about two
# candidates for each of the 57,600 cells
KITTI_HDL64_POINTS = 124_672


def phase_zbuffer(dev, floors):
    from semantic_suma_tpu_torch.ops import zbuffer as zb

    full = 64 * 900
    empty = torch.iinfo(torch.int64).max
    out = []
    # the shapes of the odometry path: project_scan (no flag) and fusion (the
    # render flag with its winner, the compatible flag for existence only);
    # of loop closure: the render of a search view, of a verify view and of
    # two streams at once (no flag); of the sharded paths: a rank's fusion
    # of its half of the view at 64x900, and the sharded-8dev row's
    # projection and a rank's fusion of its eighth at 32x450
    for label, n, payloads, qoff, cells in (
            ("projection", full, (), 0, full),
            ("projection-kitti", KITTI_HDL64_POINTS, (), 0, full),
            ("fusion", 1 << 18, (True, False), 1, full),
            ("render-search", 1 << 18, (), 0, full),
            ("render-verify", 1 << 17, (), 0, full),
            ("render-composed", 1 << 19, (), 0, full),
            ("fusion-shard2", 1 << 17, (True, False), 1, full),
            ("projection-32x450", 32 * 450, (), 0, 32 * 450),
            ("fusion-shard8", 1 << 13, (True, False), 1, 32 * 450)):
        n_flags = len(payloads)
        nq = 1 + n_flags
        ids, depth, flags = _zb_inputs(n, cells, n_flags, 7 + n_flags, dev)
        ids2, depth2, flags2 = _zb_inputs(n, cells, n_flags, 70 + n_flags,
                                          dev)
        exact, scale, qmax = zb._quantization(cells, 100.0)
        packed = dict(exact=exact, scale=scale, qclip=qmax - qoff, qoff=qoff)
        two_key = dict(exact=True, scale=1.0, qclip=0, qoff=0)
        as_u8 = tuple(f.to(torch.uint8) for f in flags)
        none = (ids[:0], depth[:0], tuple(f[:0] for f in flags))
        checks, err = 0, 0.0
        for kw in (packed, two_key):
            # consecutive calls on one key table: other inputs, other types,
            # every flag with its winner, no candidate at all
            for args, pl in (((ids, depth, flags), payloads),
                             ((ids2, depth2, flags2), payloads),
                             ((ids.to(torch.int32), depth, flags), payloads),
                             ((ids, depth, as_u8), payloads),
                             ((ids2, depth2, flags2), (True,) * n_flags),
                             (none, payloads),
                             ((ids, depth, flags), payloads)):
                got = zb.zbuffer_cells(*args, cells, payloads=pl, **kw)
                want = zb.zbuffer_cells_plain(*args, cells, payloads=pl, **kw)
                torch.cuda.synchronize()
                err = max(err, _zb_err(got, want))
                if not _same(got, want):
                    bad = int((got[0] != want[0]).sum())
                    raise AssertionError(
                        f"zbuffer {label} (exact={kw['exact']}, check "
                        f"{checks}): {bad} winners differ")
                checks += 1
        if n_flags and not bool(((got[0][2] == 0) | (got[0][2] == -1)).all()):
            raise AssertionError("existence-only flag reports a winner")

        def fn():
            return zb.zbuffer_cells(ids, depth, flags, cells,
                                    payloads=payloads, **packed)

        want = zb.zbuffer_cells_plain(ids, depth, flags, cells,
                                      payloads=payloads, **packed)
        filled = [int((want[0][q] >= 0).sum()) for q in range(nq)]
        ms, eager_ms = time_ms(fn, 2000)
        # after the replays: a table that the decode pass left dirty shows
        # here and nowhere else
        table = zb._tables[(ids.device, nq * cells)]
        torch.cuda.synchronize()
        got = fn()
        err = max(err, _zb_err(got, want))
        if not bool((table == empty).all()) or not _same(got, want):
            raise AssertionError(f"zbuffer {label}: wrong after graph "
                                 "replays (key table left dirty)")
        plain_ms, _ = time_ms(lambda: zb.zbuffer_cells_plain(
            ids, depth, flags, cells, payloads=payloads, **packed), 50)
        # the public function answers in two launches, no torch op beside
        if n_flags:
            per_call = _device_launches(lambda: zb.zbuffer_runs(
                ids, depth, flags, cells, flag_payloads=payloads))
        else:
            per_call = _device_launches(
                lambda: zb.zbuffer_argmin(ids, depth, cells))
        if per_call > 2:
            raise AssertionError(f"zbuffer {label}: {per_call} device "
                                 "launches for one answer")
        # the yardstick: ONE scatter_reduce_ (amin) over the same keys for
        # every query at once, each query's cells in its own slice of one
        # table; a non-member carries the empty key, which changes no cell
        keys = zb.depth_keys(depth, exact, scale, qmax - qoff, qoff).to(
            torch.int64) * (1 << 32) + torch.arange(n, device=dev)
        inside = (ids >= 0) & (ids < cells)
        members = [inside] + [inside & f for f in flags]
        idx_all = torch.cat([q * cells + ids.clamp(0, cells - 1)
                             for q in range(nq)])
        key_all = torch.cat([torch.where(m, keys, empty) for m in members])
        lib_table = torch.full((nq * cells,), empty, dtype=torch.int64,
                               device=dev)
        lib_ms, _ = time_ms(lambda: lib_table.scatter_reduce_(
            0, idx_all, key_all, "amin", include_self=True), 200)
        lib_w = torch.where(lib_table == empty, -1,
                            lib_table & 0xFFFFFFFF).view(nq, cells)
        lib_ok = [q == 0 or payloads[q - 1] for q in range(nq)]
        if not all(torch.equal(lib_w[q], want[0][q])
                   for q in range(nq) if lib_ok[q]):
            raise AssertionError(f"zbuffer {label}: the scatter_reduce_ "
                                 "yardstick computes other winners")
        # the work of the function on these inputs: every input read once,
        # every output written once; and one atomic for every non-empty cell
        # of a query that wants its winner, which no atomic design avoids, at
        # the card's measured rate on distinct cells
        nbytes = n * (ids.element_size() + 4 + n_flags) + nq * cells * (8 + 4)
        atomics = sum(f for q, f in enumerate(filled) if lib_ok[q])
        terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "atomics": atomics / floors["atomics_per_s"] * 1e3}
        bound_ms = max(terms.values())
        print(f"[zbuffer] {label}: {n} candidates -> {cells} cells x {nq} "
              f"queries, {checks} comparisons exact (winners, depths, "
              f"existence; max |kernel - plain| {err}; {filled} filled), "
              f"{per_call} device launches a "
              f"call; kernel {ms:.5f} ms (eager calls "
              f"{eager_ms:.5f} ms), plain {plain_ms:.4f} ms, scatter_reduce_ "
              f"{lib_ms:.5f} ms, bound {bound_ms:.5f} ms (bytes "
              f"{terms['bytes']:.5f} for {nbytes} B, atomics "
              f"{terms['atomics']:.5f} for {atomics}), launch floor "
              f"{floors['launch_floor_ms']:.5f} ms")
        out.append({"name": "zbuffer_cells", "shape": label, "route": "cuda",
                    "source": "semantic_suma_tpu_torch/csrc/zbuffer.cu",
                    "replaces": "semantic_suma_tpu/ops/zbuffer.py:"
                    + ("84" if n_flags else "24"),
                    "max_abs_err": err, "ms": ms, "eager_ms": eager_ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": "bytes" if bound_ms == terms["bytes"]
                    else "operations", "library_ms": lib_ms,
                    "n_flags": n_flags, "n": n})
    return out


def _to(tree, dev):
    """Copy a tensor, or a (named) tuple nesting tensors, to ``dev``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev, copy=True)
    if isinstance(tree, tuple):
        items = [_to(x, dev) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    return tree


def _small_angle(rel: torch.Tensor) -> float:
    """Rotation angle of a near-identity transform from its antisymmetric
    part (asin of |vee(R - R^T)| / 2): the trace formula's arccos cannot
    resolve angles below ~1e-3 rad from f32 rotations."""
    w = torch.stack([rel[2, 1] - rel[1, 2], rel[0, 2] - rel[2, 0],
                     rel[1, 0] - rel[0, 1]])
    return float(torch.asin(torch.clamp(torch.linalg.norm(w) / 2, max=1.0)))


def phase_parity(dev, n_scans: int = 10):
    """The card against the CPU on a small input: ``small()`` with the
    bilateral filter on; each scan starts the CPU step (plain versions of
    the kernels) from a copy of the card's state, and the two poses must
    agree within 1e-3 m and 1e-3 rad (the tolerance the CPU tests hold the
    port to against the JAX package)."""
    from semantic_suma_tpu_torch.config import (LoopClosureConfig, MapConfig,
                                                PreprocessConfig, SumaConfig)
    from semantic_suma_tpu_torch.core.pipeline import init_state, odometry_step
    from semantic_suma_tpu_torch.io.simulation import (circular_trajectory,
                                                       default_world,
                                                       render_scan)

    cfg = SumaConfig(map=MapConfig(spill_enabled=False),
                     loop=LoopClosureConfig(enabled=False),
                     preprocess=PreprocessConfig(use_filtered_vertexmap=True)
                     ).small()
    cpu = torch.device("cpu")
    world = default_world(seed=0, extent=45.0)
    gt = circular_trajectory(n_scans, radius=18.0, step=1.5, device=dev)
    state = init_state(cfg, dev)
    worst_t = worst_r = 0.0
    for i in range(n_scans):
        ct = (1.0 - i / cfg.map.time_init) * cfg.map.log_unstable
        s = render_scan(world, gt[i], cfg.data)
        args = (s.points, s.labels, s.probs, s.valid)
        cpu_state = _to(state, cpu)
        state, info = odometry_step(state, *args, ct, cfg)
        _, cinfo = odometry_step(cpu_state, *_to(args, cpu), ct, cfg)
        pg = info.pose.cpu().double()
        pc = cinfo.pose.double()
        dt = float((pg[:3, 3] - pc[:3, 3]).abs().max())
        dr = _small_angle(torch.linalg.inv(pc) @ pg)
        worst_t, worst_r = max(worst_t, dt), max(worst_r, dr)
        if not (dt <= 1e-3 and dr <= 1e-3):
            raise AssertionError(f"scan {i}: card and CPU poses differ by "
                                 f"{dt} m, {dr} rad")
        if int(info.map_count) != int(cinfo.map_count):
            print(f"[parity] scan {i}: map count card {int(info.map_count)}"
                  f" CPU {int(cinfo.map_count)}")
    print(f"[parity] {n_scans} scans at 32x180: card vs CPU per scan, max "
          f"{worst_t:.3e} m, {worst_r:.3e} rad (limit 1e-3 each)")


def _plain_gn(data, model, t0, icp_cfg, model_cfg, semantic=True,
              max_iterations=None, group=None, early_exit=True):
    """``icp.gauss_newton`` with the plain versions of kernels D and E on
    the latch, all ``max_iterations`` trips (kernel F's plain version ends
    at the latch with the same values; ``group`` and ``early_exit`` do not
    apply)."""
    from semantic_suma_tpu_torch.ops import icp
    return icp.gauss_newton_latched(
        data, model, t0, icp_cfg, model_cfg, semantic, max_iterations,
        products=icp.icp_products_plain, update=icp.gn_update_plain)


# the lower triangle's diagonal in a row of partial sums (ops/icp.NPART)
_TRI_DIAG = [0, 2, 5, 9, 14, 20]


def _hold_icp(tag, data, model, t0, cfg) -> dict:
    """Kernels D and E against their plain versions on the card, on one
    alignment's inputs. D from the state at ``t0`` and iterations 0 and 1:
    the four counters exactly equal, every product within 1e-5 of its
    Cauchy-Schwarz scale ``sqrt(AtA[i,i] AtA[j,j])`` (which bounds the sum
    of the absolute terms, so sums taken in another order stay well inside
    it; ``AtA[6,6]`` is the inlier residual) and the two error sums within
    1e-5 relative. E from that state and D's partial sums: the integer state
    (k, done, counters) exactly equal, the pose within 1e-5 and the error
    sums within 1e-5 relative. Then one whole loop each way: the iterations
    and the pose difference are printed."""
    from semantic_suma_tpu_torch.ops import icp
    ic, mc, sem = cfg.icp, cfg.model, cfg.semantic.enabled
    img = icp._pack_model_image(model)
    il = torch.tril_indices(6, 6)
    out = {"d_abs": 0.0, "d_scaled": 0.0, "e_pose": 0.0, "e_rel": 0.0}
    for k in (0, 1):
        sf, si = icp.gn_state(t0, k)
        part = icp.icp_products(sf, si, data, img, ic, mc, sem)
        want = icp.icp_products_plain(sf, si, data, img, ic, mc, sem)
        want = want[0].double().cpu()
        got = part.double().sum(0).cpu()
        if not torch.equal(got[29:33], want[29:33]):
            raise AssertionError(f"[icp] {tag}: kernel D's counters "
                                 f"{got[29:33].tolist()} against "
                                 f"{want[29:33].tolist()}")
        diag = torch.cat([want[_TRI_DIAG], want[28:29]])
        full = torch.sqrt(torch.outer(diag, diag))
        scale = torch.cat([full[il[0], il[1]], full[:6, 6]]).clamp_min(1e-30)
        diff = (got[:27] - want[:27]).abs()
        rel = ((got[27:29] - want[27:29]).abs()
               / want[27:29].abs().clamp_min(1e-30))
        out["d_abs"] = max(out["d_abs"], float(diff.max()),
                           float((got[27:29] - want[27:29]).abs().max()))
        out["d_scaled"] = max(out["d_scaled"], float((diff / scale).max()),
                              float(rel.max()))
        sf2, si2 = sf.clone(), si.clone()
        icp.gn_update(part, sf, si, ic)
        icp.gn_update_plain(part, sf2, si2, ic)
        if not torch.equal(si, si2):
            raise AssertionError(f"[icp] {tag}: kernel E's integer state "
                                 f"{si.tolist()} against {si2.tolist()}")
        out["e_pose"] = max(out["e_pose"],
                            float((sf[:16] - sf2[:16]).abs().max()))
        out["e_rel"] = max(out["e_rel"], float(
            ((sf[16:19] - sf2[16:19]).abs()
             / sf2[16:19].abs().clamp_min(1e-30)).max()))
    if out["d_scaled"] > 1e-5 or out["e_pose"] > 1e-5 or out["e_rel"] > 1e-5:
        raise AssertionError(f"[icp] {tag}: kernels D and E against their "
                             f"plain versions: {out}")
    rk = icp.gauss_newton(data, model, t0, ic, mc, sem)
    rp = _plain_gn(data, model, t0, ic, mc, sem)
    out["loop_iterations"] = (int(rk.iterations), int(rp.iterations))
    out["loop_pose"] = float((rk.pose - rp.pose).abs().max())
    print(f"[icp] {tag}: D against plain at iterations 0 and 1: counters "
          f"equal, products within {out['d_scaled']:.3e} of their scale "
          f"(largest |difference| {out['d_abs']:.3e}); E from D's sums: "
          f"integer state equal, pose within {out['e_pose']:.3e}, errors "
          f"{out['e_rel']:.3e} relative (limits 1e-5); a whole loop: "
          f"{out['loop_iterations'][0]} iterations with the kernels, "
          f"{out['loop_iterations'][1]} with the plain versions, poses "
          f"{out['loop_pose']:.3e} apart")
    return out


# kernel F is held against kernels D and E at these max_iterations: one
# iteration, two (the second linearizes at F's own update), and the default
# 33, where the loop stops at its test
GN_HOLD_CAPS = (1, 2, 33)


def _state_bits(sf, si):
    return torch.cat([sf.view(torch.int32), si])


def _hold_gn_loop(tag, data, model, t0, cfg) -> dict:
    """Kernel F (``icp.gn_loop``) on one alignment's inputs, from the state
    at ``t0``, at each of ``GN_HOLD_CAPS``: against ``max_iterations`` trips
    of kernels D and E on the latch, the whole state (pose, last_err, the
    statistics, k, done) bit for bit; against its plain version
    (``gn_loop_plain``, the plain latch) within ``[icp]``'s tolerances: at
    one iteration the integer state equal (D's counters are exact at one
    pose), the pose within 1e-5 and the error sums within 1e-5 relative
    (E's limits); at two the pose within 1e-5 and k equal; at 33 the
    iterations printed and, where neither run reaches the cap, the pose
    within ``[main]``'s per-scan limits, 1e-4 m and 1e-5 rad."""
    from semantic_suma_tpu_torch.ops import icp
    ic, mc, sem = cfg.icp, cfg.model, cfg.semantic.enabled
    img = icp._pack_model_image(model)
    out = {"plain_pose": 0.0, "plain_rel": 0.0, "plain_t": 0.0,
           "plain_r": 0.0, "iterations": []}
    for cap in GN_HOLD_CAPS:
        sf, si = icp.gn_state(t0)
        icp.gn_loop(sf, si, data, img, ic, mc, sem, cap)
        sfd, sid = icp.gn_state(t0)
        buf = None
        for _ in range(cap):
            buf = icp.icp_products(sfd, sid, data, img, ic, mc, sem, out=buf)
            icp.gn_update(buf, sfd, sid, ic)
        if not torch.equal(_state_bits(sf, si), _state_bits(sfd, sid)):
            raise AssertionError(
                f"[icp] {tag}: kernel F against kernels D and E at "
                f"max_iterations {cap}: state {sf.tolist()} {si.tolist()} "
                f"against {sfd.tolist()} {sid.tolist()}")
        sfp, sip = icp.gn_state(t0)
        icp.gn_loop_plain(sfp, sip, data, img, ic, mc, sem, cap)
        k, kp = int(si[0]), int(sip[0])
        out["iterations"].append((cap, k, kp))
        pose, plain = sf[:16].view(4, 4), sfp[:16].view(4, 4)
        if cap <= 2:
            d_pose = float((pose - plain).abs().max())
            out["plain_pose"] = max(out["plain_pose"], d_pose)
            ok = d_pose <= 1e-5 and k == kp
            if cap == 1:
                rel = float(((sf[16:19] - sfp[16:19]).abs()
                             / sfp[16:19].abs().clamp_min(1e-30)).max())
                out["plain_rel"] = max(out["plain_rel"], rel)
                ok = ok and torch.equal(si, sip) and rel <= 1e-5
        elif k < cap and kp < cap:
            pk, pp = pose.double().cpu(), plain.double().cpu()
            d_t = float((pk[:3, 3] - pp[:3, 3]).abs().max())
            d_r = _small_angle(torch.linalg.inv(pp) @ pk)
            out["plain_t"] = max(out["plain_t"], d_t)
            out["plain_r"] = max(out["plain_r"], d_r)
            ok = d_t <= 1e-4 and d_r <= 1e-5
        else:
            ok = True
        if not ok:
            raise AssertionError(
                f"[icp] {tag}: kernel F against its plain version at "
                f"max_iterations {cap}: {sf.tolist()} {si.tolist()} against "
                f"{sfp.tolist()} {sip.tolist()}")
    print(f"[icp] {tag}: kernel F equals kernels D and E bit for bit (pose, "
          f"last_err, statistics, k, done) at max_iterations "
          f"{list(GN_HOLD_CAPS)}; against its plain version: pose within "
          f"{out['plain_pose']:.3e} at 1 and 2 iterations, errors "
          f"{out['plain_rel']:.3e} relative (limits 1e-5), at 33 "
          f"{out['plain_t']:.3e} m and {out['plain_r']:.3e} rad (limits "
          f"1e-4 m, 1e-5 rad where neither caps); (cap, iterations F, "
          f"plain): {out['iterations']}")
    return out


def _bits_of(res):
    """A Gauss-Newton result's pose, statistics and iterations as int32
    bits (the iterations of the sharded route are a Python int)."""
    dev = res.pose.device
    k = torch.as_tensor(res.iterations, dtype=torch.int32, device=dev)
    return torch.cat([res.pose.reshape(-1).view(torch.int32),
                      *(t.reshape(1).view(torch.int32) for t in res.stats),
                      k.reshape(1)])


def _hold_sharded(tag, data, model, t0, cfg) -> dict:
    """The sharded route of ``icp.gauss_newton`` (``group=``: kernels D and
    E, the partial sums added over the ranks) on one alignment's inputs.
    At one rank (a group with no process group, where the sum over the
    ranks is the rank's own): against kernel F (``gauss_newton`` without a
    group), the pose, the statistics and the iterations bit for bit, one
    launch of D and of E an iteration and one host read. Then two ranks
    emulated in this process: each iteration D on the top and on the bottom
    half of the data rows, the two buffers added elementwise (the float32
    sum that the group's all-reduce of two ranks makes), E on the sum;
    against the same with the plain versions (``icp_products_plain`` on
    each half, the two rows added, ``gn_update_plain``). At one iteration
    the integer state equal (the counters are exact at one pose), the pose
    within 1e-5 and the error sums within 1e-5 relative (E's limits); over
    a whole loop the pose within ``[main]``'s per-scan limits, 1e-4 m and
    1e-5 rad, where neither run caps."""
    from semantic_suma_tpu_torch.device import to_host
    from semantic_suma_tpu_torch.ops import icp
    from semantic_suma_tpu_torch.parallel.distributed import Group
    ic, mc, sem = cfg.icp, cfg.model, cfg.semantic.enabled
    f = icp.gauss_newton(data, model, t0, ic, mc, sem)
    before = (icp.icp_products.launches, icp.gn_update.launches,
              icp.gn_loop.launches, to_host.count)
    one = icp.gauss_newton(data, model, t0, ic, mc, sem, group=Group())
    after = (icp.icp_products.launches, icp.gn_update.launches,
             icp.gn_loop.launches, to_host.count)
    k = one.iterations
    if tuple(a - b for a, b in zip(after, before)) != (k, k, 0, k):
        raise AssertionError(f"[icp] {tag}: the sharded route launched D, "
                             f"E, F and read the host {after} - {before} "
                             f"times in {k} iterations")
    if not torch.equal(_bits_of(one), _bits_of(f)):
        raise AssertionError(f"[icp] {tag}: the sharded route at one rank "
                             f"{_bits_of(one).tolist()} against kernel F "
                             f"{_bits_of(f).tolist()}")
    img = icp._pack_model_image(model)
    h = data.vertex.shape[0]
    halves = (icp.Maps(*(a[:h // 2] for a in data)),
              icp.Maps(*(a[h // 2:] for a in data)))

    def two_ranks(products, update, cap):
        sf, si = icp.gn_state(t0)
        for _ in range(cap):
            a, b = (products(sf, si, m, img, ic, mc, sem) for m in halves)
            update(a + b, sf, si, ic)
            if bool(si[1]):
                break
        return sf, si

    out = {"iterations": k}
    sf, si = two_ranks(icp.icp_products, icp.gn_update, 1)
    sfp, sip = two_ranks(icp.icp_products_plain, icp.gn_update_plain, 1)
    out["pose_1"] = float((sf[:16] - sfp[:16]).abs().max())
    out["rel_1"] = float(((sf[16:19] - sfp[16:19]).abs()
                          / sfp[16:19].abs().clamp_min(1e-30)).max())
    if not (torch.equal(si, sip) and out["pose_1"] <= 1e-5
            and out["rel_1"] <= 1e-5):
        raise AssertionError(f"[icp] {tag}: two ranks emulated, one "
                             f"iteration: {sf.tolist()} {si.tolist()} against "
                             f"{sfp.tolist()} {sip.tolist()}")
    cap = ic.max_iterations
    sf, si = two_ranks(icp.icp_products, icp.gn_update, cap)
    sfp, sip = two_ranks(icp.icp_products_plain, icp.gn_update_plain, cap)
    out["two_ranks_iterations"] = (int(si[0]), int(sip[0]))
    pk = sf[:16].view(4, 4).double().cpu()
    pp = sfp[:16].view(4, 4).double().cpu()
    out["t"] = float((pk[:3, 3] - pp[:3, 3]).abs().max())
    out["r"] = _small_angle(torch.linalg.inv(pp) @ pk)
    capped = max(out["two_ranks_iterations"]) >= cap
    if not capped and not (out["t"] <= 1e-4 and out["r"] <= 1e-5):
        raise AssertionError(f"[icp] {tag}: two ranks emulated, a whole "
                             f"loop: {out}")
    print(f"[icp] {tag}: the sharded route at one rank equals kernel F bit "
          f"for bit ({k} iterations: {k} launches each of D and E, {k} host "
          f"reads); two ranks emulated (D on each half of the rows, the "
          f"buffers added, E) against the plain versions: one iteration "
          f"integer state equal, pose within {out['pose_1']:.3e}, errors "
          f"{out['rel_1']:.3e} relative (limits 1e-5); a whole loop "
          f"{out['two_ranks_iterations']} iterations (kernels, plain), "
          f"{out['t']:.3e} m and {out['r']:.3e} rad apart (limits 1e-4 m, "
          f"1e-5 rad{', not held: a run capped' if capped else ''})")
    return out


def _hold_evaluate(tag, data, model, cfg) -> dict:
    """``icp.evaluate`` (kernel F's first iteration, one launch) against the
    statistics of ``build_rows`` at the identity, the plain linearization
    it replaced: the four counts exactly equal and the error and the inlier
    residual within 1e-5 relative (kernel D's limit on its error sums)."""
    from semantic_suma_tpu_torch.device import to_host
    from semantic_suma_tpu_torch.ops import icp
    ic, mc, sem = cfg.icp, cfg.model, cfg.semantic.enabled
    eye = torch.eye(4, dtype=torch.float32, device=data.vertex.device)
    launches0, reads0 = icp.gn_loop.launches, to_host.count
    got = icp.evaluate(eye, data, model, ic, mc, sem)
    if (icp.gn_loop.launches - launches0, to_host.count - reads0) != (1, 0):
        raise AssertionError(f"[icp] {tag}: evaluate launched kernel F "
                             f"{icp.gn_loop.launches - launches0} times and "
                             f"read the host {to_host.count - reads0} times")
    _, want = icp.build_rows(eye, data, model, ic, mc, 0, sem)
    counts = ("valid", "inlier", "outlier", "invalid")
    g = {n: int(getattr(got, n)) for n in counts}
    w = {n: int(getattr(want, n)) for n in counts}
    rel = max(abs(float(getattr(got, n)) - float(getattr(want, n)))
              / max(abs(float(getattr(want, n))), 1e-30)
              for n in ("error", "inlier_residual"))
    print(f"[icp] {tag}: evaluate on kernel F against build_rows' "
          f"statistics: counts {g} {'equal' if g == w else f'against {w}'}, "
          f"error and inlier residual within {rel:.3e} relative (limit "
          f"1e-5)")
    if g != w or not rel <= 1e-5:
        raise AssertionError(f"[icp] {tag}: evaluate {got} against {want}")
    return {"rel": rel}


def _poisoned_maps(data):
    """``data`` with the vertex of its first valid pixel set to NaN: the
    sums turn NaN and the solve fails (the CPU tests' ``solve-fails``)."""
    valid = (data.vertex_valid & data.normal_valid).reshape(-1)
    first = int(torch.nonzero(valid)[0, 0])
    vertex = data.vertex.clone()
    vertex.view(-1, 3)[first] = float("nan")
    return data._replace(vertex=vertex)


def _empty_maps(model):
    return model._replace(vertex_valid=torch.zeros_like(model.vertex_valid),
                          normal_valid=torch.zeros_like(model.normal_valid))


def phase_icp(dev, floors):
    """Kernels D, E and F (``csrc/icp.cu``) at the inputs of a scan of the
    main cell and of the default one (57,600 data pixels against a 64x900
    model, nearest sampling, huber, semantic weights): D and E against
    their plain versions, F against D and E bit for bit and against its
    plain version (``_hold_gn_loop``), F also at the main inputs with turkey
    weights and bilinear sampling, against an empty model and on data whose
    solve fails (phase 8 holds all three at the loop's verify inputs).
    Then the times: D and E (one call in a replayed graph and eager, a
    launch that finds the latch set, the plain versions, cuBLAS's
    ``rows.T @ rows`` on the plain rows, the reduction's library call); F
    (one call, eager, an iteration as the difference of 33 forced
    iterations and 1 over 32, its plain version, the grid it chose); and a
    whole ``gauss_newton`` call (kernel F, one launch asserted) against the
    trips of D and E on the latch (``products=``, ``update=``) and the host
    loop (``gauss_newton_host``), no host read asserted for the first."""
    import dataclasses

    from semantic_suma_tpu_torch.device import to_host
    from semantic_suma_tpu_torch.ops import icp
    from semantic_suma_tpu_torch.tools.gn_loop_designs import cell_inputs

    plain0 = icp.plain_on_cuda["build_rows"]
    holds, inputs, f_holds, s_holds = {}, {}, {}, {}
    for name, filtered in (("main", True), ("default", False)):
        inputs[name] = cell_inputs(dev, filtered)
        holds[name] = _hold_icp(name, *inputs[name][1:], inputs[name][0])
        f_holds[name] = _hold_gn_loop(name, *inputs[name][1:],
                                      inputs[name][0])
        s_holds[name] = _hold_sharded(name, *inputs[name][1:],
                                      inputs[name][0])
    cfg, data, model, t0 = inputs["main"]
    turkey = cfg.replace(icp=dataclasses.replace(
        cfg.icp, weighting="turkey", sampling="bilinear"))
    f_holds["turkey"] = _hold_gn_loop("main, turkey + bilinear", data, model,
                                      t0, turkey)
    f_holds["empty"] = _hold_gn_loop("main, empty model", data,
                                     _empty_maps(model), t0, cfg)
    f_holds["poisoned"] = _hold_gn_loop("main, solve fails (a NaN vertex)",
                                        _poisoned_maps(data), model, t0, cfg)
    ic, mc, sem = cfg.icp, cfg.model, cfg.semantic.enabled
    img = icp._pack_model_image(model)
    h, w = data.vertex.shape[:2]
    p, cells = h * w, mc.height * mc.width
    nb = icp._blocks(p)
    sf0, si0 = icp.gn_state(t0)
    sf, si = sf0.clone(), si0.clone()
    sfd, sid = icp.gn_state(t0)
    sid[1:2].fill_(1)   # latched: both kernels return at once
    part = torch.empty((nb, icp.NPART), dtype=torch.float32, device=dev)

    def d_live():
        icp.icp_products(sf0, si0, data, img, ic, mc, sem, out=part)

    def restore():
        sf.copy_(sf0)
        si.copy_(si0)

    def e_live():
        restore()
        icp.gn_update(part, sf, si, ic)

    d_live()
    d_ms, d_eager = time_ms(d_live, 2000)
    d_dead = graph_ms(lambda: icp.icp_products(sfd, sid, data, img, ic, mc,
                                               sem, out=part), 2000)
    e_ms = graph_ms(e_live, 2000) - graph_ms(restore, 2000)
    e_eager = _events_ms(e_live, 500, 10) - _events_ms(restore, 500, 10)
    e_dead = graph_ms(lambda: icp.gn_update(part, sfd, sid, ic), 2000)
    d_plain = _events_ms(lambda: icp.icp_products_plain(
        sf0, si0, data, img, ic, mc, sem), 20, 3)
    row = icp.icp_products_plain(sf0, si0, data, img, ic, mc, sem)
    e_plain = _events_ms(lambda: (restore(), icp.gn_update_plain(
        row, sf, si, ic)), 20, 3) - _events_ms(restore, 20, 3)
    rows, _ = icp.build_rows(sf0[:16].view(4, 4), data, None, ic, mc, si0[0],
                             sem, model_img=img)
    lib_ms = graph_ms(lambda: rows.T @ rows, 2000)

    # kernel F: one call from the state at t0, as gauss_newton makes it;
    # forced to 33 iterations by stop thresholds of 0
    bps, sms = icp.gn_loop_residency(dev.index)
    grid = icp.gn_loop_grid(nb, bps, sms)
    forced = dataclasses.replace(ic, delta=0.0, stopping_threshold=0.0)

    def f_call(conf=ic, cap=ic.max_iterations):
        restore()
        icp.gn_loop(sf, si, data, img, conf, mc, sem, cap)

    f_call(forced, 33)
    if int(si[0]) != 33:
        raise AssertionError(f"kernel F forced to 33 iterations ran {si[0]}")
    f_call()
    its = int(si[0])
    f_ms = graph_ms(f_call, 2000) - graph_ms(restore, 2000)
    f_eager = _events_ms(f_call, 500, 10) - _events_ms(restore, 500, 10)
    f_iter = (graph_ms(lambda: f_call(forced, 33), 500)
              - graph_ms(lambda: f_call(forced, 1), 2000)) / 32
    f_plain = _events_ms(lambda: (restore(), icp.gn_loop_plain(
        sf, si, data, img, ic, mc, sem, ic.max_iterations)), 10, 2) \
        - _events_ms(restore, 10, 2)

    def host_ms(fn, n):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        reads0 = to_host.count
        t_0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return ((time.perf_counter() - t_0) / n * 1e3,
                (to_host.count - reads0) / n)

    def launches():
        return (icp.gn_loop.launches, icp.icp_products.launches,
                icp.gn_update.launches)

    gn = lambda: icp.gauss_newton(data, model, t0, ic, mc, sem)  # noqa: E731
    gn_trips = lambda: icp.gauss_newton_latched(  # noqa: E731
        data, model, t0, ic, mc, sem, products=icp.icp_products,
        update=icp.gn_update)
    gn_host = lambda: icp.gauss_newton_host(  # noqa: E731
        data, model, t0, ic, mc, sem)
    before = launches()
    gn()
    one = tuple(a - b for a, b in zip(launches(), before))
    if one != (1, 0, 0):
        raise AssertionError(f"a gauss_newton call launched F, D, E {one} "
                             "times, not (1, 0, 0)")
    gn_dev = _events_ms(gn, 20, 3)
    gn_clock, gn_reads = host_ms(gn, 20)
    trips_dev = _events_ms(gn_trips, 20, 3)
    trips_clock, trips_reads = host_ms(gn_trips, 20)
    host_dev = _events_ms(gn_host, 10, 2)
    host_clock, host_reads = host_ms(gn_host, 10)

    # bytes each input read once and each output written once: vertex and
    # normal (24 B), two valid bytes, label and probability (8 B) a data
    # pixel, the packed model image (32 B a cell), the state; D writes a
    # row of 33 sums a block, E reads them and rewrites the state, F reads
    # and rewrites the state (its partial sums are scratch). D's arithmetic,
    # ~150 float32 operations a pixel, is ~100x under its bytes; F does it
    # once an iteration
    state_b = 4 * (icp._SF + icp._SI)
    d_bytes = p * 34 + cells * 32 + state_b + nb * icp.NPART * 4
    e_bytes = nb * icp.NPART * 4 + 2 * state_b
    f_bytes = p * 34 + cells * 32 + 2 * state_b
    d_terms = {"bytes": d_bytes / HBM_BYTES_PER_S * 1e3,
               "fp32": p * 150 / FP32_FLOP_PER_S * 1e3}
    d_bound = max(d_terms.values())
    e_bound = e_bytes / HBM_BYTES_PER_S * 1e3
    f_terms = {"bytes": f_bytes / HBM_BYTES_PER_S * 1e3,
               "fp32": its * p * 150 / FP32_FLOP_PER_S * 1e3}
    f_bound = max(f_terms.values())
    f_reread = its * d_terms["bytes"]  # D's bytes read again each iteration
    print(f"[icp] kernel D (icp_products) at {h}x{w} against {mc.height}x"
          f"{mc.width}, {nb} blocks: {d_ms:.5f} ms in a replayed graph "
          f"(eager {d_eager:.5f}), latched {d_dead:.5f}; plain "
          f"{d_plain:.3f} ms; cuBLAS rows.T @ rows {lib_ms:.5f} ms; bound "
          f"{d_bound:.5f} ms ({d_bytes} bytes; "
          + ", ".join(f"{k} {v:.5f}" for k, v in d_terms.items())
          + f"), launch floor {floors['launch_floor_ms']:.5f} ms")
    print(f"[icp] kernel E (gn_update): {e_ms:.5f} ms in a replayed graph "
          f"(eager {e_eager:.5f}; both less the two state copies that keep "
          f"it live), latched {e_dead:.5f}; plain {e_plain:.3f} ms; bound "
          f"{e_bound:.6f} ms ({e_bytes} bytes)")
    print(f"[icp] kernel F (gn_loop): grid {grid} blocks of 256 for {nb} "
          f"slots ({bps} blocks a SM x {sms} SMs resident); a call at the "
          f"main inputs ({its} iterations): {f_ms:.5f} ms in a replayed "
          f"graph (eager {f_eager:.5f}; both less the two state copies); an "
          f"iteration {f_iter:.5f} ms ((33 forced - 1) / 32); plain "
          f"{f_plain:.3f} ms; bound {f_bound:.5f} ms ({f_bytes} bytes once; "
          + ", ".join(f"{k} {v:.5f}" for k, v in f_terms.items())
          + f"; D's bytes read again each iteration {f_reread:.5f})")
    print(f"[icp] a gauss_newton call ({its} iterations): kernel F, one "
          f"launch: {gn_dev:.4f} ms (CUDA events), {gn_clock:.4f} ms host "
          f"clock, {gn_reads:.2f} host reads; the trips of D and E "
          f"({ic.max_iterations} each): {trips_dev:.4f} ms, "
          f"{trips_clock:.4f} ms host clock, {trips_reads:.2f} host reads; "
          f"the host loop (gauss_newton_host): {host_dev:.3f} ms, "
          f"{host_clock:.3f} ms host clock, {host_reads:.2f} host reads")
    if gn_reads != 0:
        raise AssertionError(f"gauss_newton read the host {gn_reads} times")
    print(f"[icp] build_rows on CUDA tensors in this phase's deliberate "
          f"plain-version checks and timings: "
          f"{icp.plain_on_cuda['build_rows'] - plain0} calls (counted apart "
          f"from the paths, each of which is held to 0)")
    common = {"route": "cuda",
              "source": "semantic_suma_tpu_torch/csrc/icp.cu",
              "shape": "main", "bound_by": "bytes"}
    rec_d = {"name": "icp_products",
             "replaces": "semantic_suma_tpu/ops/icp.py:142",
             "max_abs_err": max(v["d_abs"] for v in holds.values()),
             "max_scaled_err": max(v["d_scaled"] for v in holds.values()),
             "ms": d_ms, "eager_ms": d_eager, "dead_ms": d_dead,
             "plain_ms": d_plain, "bound_ms": d_bound,
             "library_ms": lib_ms, **common}
    if d_bound != d_terms["bytes"]:
        rec_d["bound_by"] = "operations"
    rec_d["sharded_equal_to_f"] = True
    rec_e = {"name": "gn_update",
             "replaces": "semantic_suma_tpu/ops/icp.py:240",
             "max_abs_err": max(max(v["e_pose"] for v in holds.values()),
                                max(v["pose_1"] for v in s_holds.values())),
             "max_scaled_err": max(max(v["e_rel"] for v in holds.values()),
                                   max(v["rel_1"]
                                       for v in s_holds.values())),
             "sharded_equal_to_f": True,
             "ms": e_ms, "eager_ms": e_eager, "dead_ms": e_dead,
             "plain_ms": e_plain, "bound_ms": e_bound, "library_ms": None,
             **common}
    rec_f = {"name": "gn_loop",
             "replaces": "semantic_suma_tpu/ops/icp.py:251",
             "max_abs_err": max(max(v["plain_pose"], v["plain_t"])
                                for v in f_holds.values()),
             "max_scaled_err": max(v["plain_rel"] for v in f_holds.values()),
             "equal_to_d_and_e": True, "ms": f_ms,
             "eager_ms": f_eager, "iteration_ms": f_iter,
             "plain_ms": f_plain, "bound_ms": f_bound,
             "bound_rereading_ms": f_reread, "library_ms": None,
             "grid": {"blocks": grid, "slots": nb, "blocks_per_sm": bps,
                      "sms": sms},
             "gn_call_ms": gn_dev, "gn_call_host_ms": gn_clock,
             "gn_trips_ms": trips_dev, "gn_trips_host_ms": trips_clock,
             "gn_host_loop_ms": host_dev, **common}
    if f_bound != f_terms["bytes"]:
        rec_f["bound_by"] = "operations"
    return rec_d, rec_e, rec_f


def _device_profile(slam, scans, ms_per_scan, step=None):
    """Device time per scan by kernel name over ``scans`` more scans, from
    ``torch.profiler``; the idle share compares the device's busy time per
    scan with the un-profiled ``ms_per_scan`` of the timed window. ``step``
    feeds one scan (default: ``slam.process_scan``)."""
    if step is None:
        def step(s):
            slam.process_scan(s.points, s.labels, s.probs, s.valid)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for s in scans:
            step(s)
        torch.cuda.synchronize()
    # device-side rows only (kernels, copies, fills): the operator rows
    # repeat the time of the kernels they launched
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    n = len(scans)
    busy = sum(r[0] for r in rows) / n / 1e3
    print(f"[profile] {n} scans: device busy {busy:.3f} ms/scan in "
          f"{sum(r[1] for r in rows) / n:.0f} device launches/scan, of "
          f"{ms_per_scan:.3f} ms/scan un-profiled -> idle share "
          f"{1.0 - busy / ms_per_scan:.3f}")
    for us, count, key in rows[:12]:
        print(f"[profile]   {us / len(scans) / 1e3:8.3f} ms/scan "
              f"{count / len(scans):7.1f} calls/scan  {key[:90]}")


# The pre-redesign kernel C's replayed-graph ms at 64x900 (PERF.md, PR 9's
# final run on the same card model): printed beside the kernel's own time.
KNN_EARLIER_MS = 0.01351


class _SyncTally:
    """The synchronizing CUDA operations of a run's timed steps, counted by
    CUDA sync debug mode over the whole step, beside its track losses, its
    Gauss-Newton iterations (from the fetched per-scan statistics: nothing
    reads them inside the loop) and its ``to_host`` reads (the packed
    fetches the window waits for included). A step synchronizes once, for
    its branch flags, twice on a scan whose fallback runs
    (core/pipeline.py); its Gauss-Newton loops read nothing."""

    def __init__(self, slam):
        self.slam = slam
        self.syncs = self.losses = self.steps = self.reads = 0
        self.fetches = self.iterations = 0
        self.worst = 0  # most synchronizations in one call beyond its flags

    def run(self, fn, steps: int):
        """Call ``fn`` (it runs ``steps`` steps and drains them) counted."""
        from semantic_suma_tpu_torch.device import to_host
        loss0, stats0 = self.slam.track_loss_count, len(self.slam.statistics)
        reads0 = to_host.count
        waits = self.slam.stopwatch.stats["fetch-wait"]
        fetch0 = waits.count
        out = []
        n = len(_sync_warnings(lambda: out.append(fn())))
        losses = self.slam.track_loss_count - loss0
        self.iterations += sum(st["icp-iterations"]
                               for st in self.slam.statistics[stats0:])
        self.syncs += n
        self.losses += losses
        self.steps += steps
        self.reads += to_host.count - reads0
        self.fetches += waits.count - fetch0
        self.worst = max(self.worst, n - steps - losses)
        return out[0]

    def check(self, tag: str, per_call: bool) -> str:
        """Assert the bound (for each call with ``per_call``, else over the
        run) and return the line that reports the counts."""
        line = (f"synchronizing operations (CUDA sync debug mode, the whole "
                f"step) {self.syncs / self.steps:.3f} a scan (track losses "
                f"{self.losses}"
                + (f", most beyond the flag reads in one call {self.worst}"
                   if per_call else "")
                + f"); Gauss-Newton iterations "
                f"{self.iterations / self.steps:.2f} a scan (fetched "
                f"statistics); to_host reads "
                f"{self.reads / self.steps:.3f} a scan, "
                f"{(self.reads - self.fetches) / self.steps:.3f} besides the "
                f"{self.fetches} fetches")
        if (per_call and self.worst > 0) \
                or self.syncs > self.steps + self.losses \
                or self.reads - self.fetches > self.steps + self.losses:
            raise AssertionError(f"{tag}: the steps synchronize beyond one "
                                 f"flag read a scan: {line}")
        return line


def _flag_read_cost(slam, cfg) -> str:
    """The step's one read on the last state of a run: the branch flags
    computed, and computed, read and the pose orthonormalized on the host
    (``read_flags``). Host clock, 200 calls each after 5."""
    from semantic_suma_tpu_torch.core.pipeline import (jump_flag,
                                                       pose_and_refresh,
                                                       read_flags)
    st = slam.state

    def flags():
        _, moved, need = pose_and_refresh(st.pose, st.last_increment,
                                          st.timestamp, st.map, cfg)
        return (jump_flag(st.last_increment, st.last_increment, st.timestamp,
                          cfg.icp), need, moved)

    def per_call_ms(fn, n=200):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    computed = per_call_ms(flags)
    read = per_call_ms(lambda: read_flags(*flags()))
    return (f"branch flags (the step's one read): computed {computed:.4f} ms "
            f"a call, computed, read and the pose orthonormalized "
            f"{read:.4f} ms (host clock, back to back)")


def phase_main_path(dev, profile_scans: int = 0):
    from semantic_suma_tpu_torch.config import odometry_config
    from semantic_suma_tpu_torch.core.pipeline import StageTimer, SurfelSLAM
    from semantic_suma_tpu_torch.io.simulation import (circular_trajectory,
                                                       default_world,
                                                       render_scan)
    from semantic_suma_tpu_torch.utils.metrics import ate_rmse

    cfg = odometry_config()
    n_warm, n_timed = 8, 60
    n = n_warm + n_timed
    world = default_world(seed=0, extent=45.0)
    gt = circular_trajectory(n + profile_scans, radius=18.0, step=1.5,
                             device=dev)
    scans = [render_scan(world, gt[i], cfg.data)
             for i in range(n + profile_scans)]
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    slam = SurfelSLAM(cfg, device=dev)
    _zero_launch_counts()
    for i in range(n_warm):
        s = scans[i]
        slam.process_scan(s.points, s.labels, s.probs, s.valid)
    torch.cuda.synchronize()
    slam.timer = StageTimer()
    syncs0 = slam.syncs
    tally = _SyncTally(slam)
    t0 = time.perf_counter()
    for i in range(n_warm, n):
        s = scans[i]
        tally.run(lambda: slam.process_scan(s.points, s.labels, s.probs,
                                            s.valid), 1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _read_launch_counts()
    launches["zbuffer_cells_by_flags"] = [
        sum(v for (_, f), v in launches["zbuffer_cells_by_shape"].items()
            if f == k) for k in range(4)]
    peak = torch.cuda.max_memory_allocated()

    est = slam.trajectory()
    if not np.all(np.isfinite(est)):
        raise AssertionError("non-finite poses")
    ate = ate_rmse(gt[:n].cpu().numpy().astype(np.float64), est)
    timed = slam.statistics[n_warm:]
    iters = np.mean([s["icp-iterations"] for s in timed])
    capped = [i for i, s in enumerate(slam.statistics)
              if s["icp-iterations"] >= cfg.icp.max_iterations]
    stages = slam.timer.summary()
    print(f"[main] {n} scans {cfg.data.height}x{cfg.data.width} "
          f"({n_warm} warm-up + {n_timed} timed): "
          f"{n_timed / dt:.2f} scans/s, {dt / n_timed * 1e3:.2f} ms/scan "
          f"(host clock, synchronous SurfelSLAM)")
    print(f"[main] stages (CUDA events, mean ms/scan): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    print(f"[main] GN iterations/scan {iters:.2f} ({len(capped)} of {n} scans "
          f"at the cap of {cfg.icp.max_iterations}: {capped}), host "
          f"syncs/scan "
          f"{(slam.syncs - syncs0) / n_timed:.2f}, track losses "
          f"{slam.track_loss_count}, map surfels "
          f"{slam.statistics[-1]['map-count']}, dropped creations "
          f"{slam.creations_dropped}")
    print(f"[main] aligned ATE {ate:.5f} m, peak device memory "
          f"{peak / 2**20:.1f} MiB")
    print(f"[main] {tally.check('main', True)}")
    print(f"[main] {_flag_read_cost(slam, cfg)}")
    print(f"[main] launches: {launches}")
    print(f"[main] {_one_f_a_call('main', launches)}")
    if launches["bilateral_filter"] != n:
        raise AssertionError(f"bilateral ran {launches['bilateral_filter']} "
                             f"times over {n} scans")
    by_flags = launches["zbuffer_cells_by_flags"]
    if launches["zbuffer_cells"] < 2 * n or by_flags[0] < n \
            or by_flags[2] < n:
        raise AssertionError(f"zbuffer ran {launches['zbuffer_cells']} "
                             f"times ({by_flags} by flag count) over {n} "
                             "scans")
    if slam.creations_dropped:
        raise AssertionError(f"{slam.creations_dropped} creations dropped")
    ref = _reference_ate()
    print(f"[main] aligned ATE {ate:.5f} m against the JAX package's "
          f"{ref:.5f} m on the same cell ({REFERENCE_FILE})")
    if not ate <= ref:
        raise AssertionError(f"ATE {ate} m above the reference's {ref} m")
    if profile_scans:
        _device_profile(slam, scans[n:], dt / n_timed * 1e3)
    _kernel_vs_plain_per_scan(dev, cfg, scans[:n])
    return launches


def _kernel_vs_plain_per_scan(dev, cfg, scans):
    """Each scan of the cell stepped twice from the same state on the card:
    with kernel F (``icp.gauss_newton``) and with the plain versions of
    kernels D and E on the latch (``gauss_newton_latched`` with
    ``icp_products_plain`` and ``gn_update_plain``); the run goes on from
    the kernel's state. On every scan that neither run caps, the poses must
    agree within 1e-4 m and 1e-5 rad (decided before the kernels' first
    run); the iteration counts of both runs are printed."""
    from semantic_suma_tpu_torch.core import pipeline
    from semantic_suma_tpu_torch.ops import icp

    slam = pipeline.SurfelSLAM(cfg, device=dev)  # its confidence schedule
    state = pipeline.init_state(cfg, dev)
    cap = cfg.icp.max_iterations
    its_k, its_p, worst_t, worst_r, held = [], [], 0.0, 0.0, 0
    kernel_gn = icp.gauss_newton
    for i, s in enumerate(scans):
        args = (s.points, s.labels, s.probs, s.valid, slam._conf_at(i), cfg)
        copy = _to(state, dev)
        icp.gauss_newton = _plain_gn
        try:
            _, pinfo = pipeline.odometry_step(copy, *args)
        finally:
            icp.gauss_newton = kernel_gn
        state, kinfo = pipeline.odometry_step(state, *args)
        ik, ip = int(kinfo.iterations), int(pinfo.iterations)
        its_k.append(ik)
        its_p.append(ip)
        if ik >= cap or ip >= cap:
            continue
        pk, pp = kinfo.pose.double().cpu(), pinfo.pose.double().cpu()
        dt = float((pk[:3, 3] - pp[:3, 3]).abs().max())
        dr = _small_angle(torch.linalg.inv(pp) @ pk)
        worst_t, worst_r = max(worst_t, dt), max(worst_r, dr)
        held += 1
        if not (dt <= 1e-4 and dr <= 1e-5):
            raise AssertionError(f"scan {i}: kernel F against the plain "
                                 f"versions from one state: {dt} m, "
                                 f"{dr} rad ({ik} and {ip} iterations)")
    print(f"[main] kernel F against the plain versions, each of "
          f"{len(scans)} scans stepped from one state: {held} scans that "
          f"neither capped agree within {worst_t:.3e} m and {worst_r:.3e} "
          f"rad (limits 1e-4 m, 1e-5 rad); iterations equal on "
          f"{sum(a == b for a, b in zip(its_k, its_p))} of {len(scans)}")
    print(f"[main] iterations a scan, kernels: {its_k}")
    print(f"[main] iterations a scan, plain:   {its_p}")


# The JAX package's aligned ATE on the filtered main cell (the same scans,
# the same SurfelSLAM driving): `python compare/filtered_main.py jax`,
# recorded in this file. `[main]` and `[chunked]` hold the port to it.
REFERENCE_FILE = "compare/filtered_main_jax.json"


def _reference_ate() -> float:
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        REFERENCE_FILE)
    with open(path) as f:
        return float(json.loads(f.read())["ate_m"])


# [chunked]: scans a dispatch, and the dispatches in flight of the chunked
# run and of the chunked run that is held equal to the per-step run
CHUNK_SIZE, CHUNK_DEPTH, CHUNK_DEPTH_HELD = 8, 4, 1


def _drive_async(slam, scans, n_warm, tally=None):
    """``process_scan_async`` over ``scans`` and ``flush``; returns the host
    seconds from scan ``n_warm`` to the end of the flush (synchronized).
    With a ``_SyncTally``, the scans from ``n_warm`` on and the flush are
    counted in it."""
    def drive(part):
        for s in part:
            slam.process_scan_async(s.points, s.labels, s.probs, s.valid)
        slam.flush()

    for s in scans[:n_warm]:
        slam.process_scan_async(s.points, s.labels, s.probs, s.valid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if tally is None:
        drive(scans[n_warm:])
    else:
        tally.run(lambda: drive(scans[n_warm:]), len(scans) - n_warm)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_chunked(dev):
    """``[chunked]``: the main path's cell (the bench sizing, filtered, the
    same 8 + 60 scans) through ``process_scan_async`` with ``chunk_size=8``
    at ``pipeline_depth`` 4 (its launches counted from zero around it) and
    1, beside two per-step runs of the same scans (``chunk_size=1``, depth
    4), whose difference is the floor.

    At depth 4 up to 39 scans are in flight when a chunk drains (4 chunks
    pending and the rest of the one in drain), and the near-capacity rule
    (the JAX package's: compact when the last fetched count plus that many
    scans' worth of creations, ``(1 + lag) * H * W``, exceeds the arena)
    compacts the 2^21-row arena at most drains. Compaction drops the dead
    rows and resets the active view, which changes the map and the
    trajectory: that run is held to the cell's ATE <= 0.05 m, both kernels
    on the path and no dropped creation, and its difference from the
    per-step run is printed. At depth 1 (at most 15 scans in flight) the
    rule never fires, and the chunked run is held to the per-step one: the
    largest position difference within ``max(3 x floor, 1 mm)``, the last
    map count within 0.5%, no compaction, ATE <= 0.05 m. Prints scans/s,
    host reads and fetches a scan of every run, and holds each run's timed
    scans to the main path's synchronization bound (``_SyncTally``)."""
    from semantic_suma_tpu_torch.config import odometry_config
    from semantic_suma_tpu_torch.core.pipeline import SurfelSLAM
    from semantic_suma_tpu_torch.io.simulation import (circular_trajectory,
                                                       default_world,
                                                       render_scan)
    from semantic_suma_tpu_torch.utils.metrics import ate_rmse

    cfg = odometry_config()
    n_warm, n_timed = 8, 60
    n = n_warm + n_timed
    world = default_world(seed=0, extent=45.0)
    gt = circular_trajectory(n, radius=18.0, step=1.5, device=dev)
    gt_np = gt.cpu().numpy().astype(np.float64)
    scans = [render_scan(world, gt[i], cfg.data) for i in range(n)]
    torch.cuda.synchronize()
    runs, ates = {}, {}
    for name, chunk, depth in (
            ("chunked", CHUNK_SIZE, CHUNK_DEPTH),
            ("chunked, held", CHUNK_SIZE, CHUNK_DEPTH_HELD),
            ("per-step", 1, CHUNK_DEPTH), ("per-step again", 1, CHUNK_DEPTH)):
        slam = SurfelSLAM(cfg, pipeline_depth=depth, chunk_size=chunk,
                          device=dev)
        if name == "chunked":
            _zero_launch_counts()
        tally = _SyncTally(slam)
        dt = _drive_async(slam, scans, n_warm, tally)
        if name == "chunked":
            launches = _read_launch_counts()
        runs[name] = slam
        ates[name] = ate_rmse(gt_np, slam.trajectory())
        fetches = slam.stopwatch.stats["fetch-wait"].count
        print(f"[chunked] {name}: chunk_size {chunk}, pipeline_depth "
              f"{depth}, {n} scans ({n_warm} warm-up + {n_timed} timed): "
              f"{n_timed / dt:.2f} scans/s, {dt / n_timed * 1e3:.2f} ms/scan"
              f" (host clock); host reads/scan {slam.syncs / n:.2f}, "
              f"fetches/scan {fetches / n:.3f}, compactions "
              f"{slam.map_version}, map surfels "
              f"{slam.statistics[-1]['map-count']}, dropped creations "
              f"{slam.creations_dropped}, aligned ATE {ates[name]:.5f} m")
        print(f"[chunked] {name}, the timed scans: "
              f"{tally.check('chunked: ' + name, False)}")
    est = {k: v.trajectory() for k, v in runs.items()}
    count = {k: v.statistics[-1]["map-count"] for k, v in runs.items()}
    ref = _reference_ate()

    def diff(a, b="per-step"):
        return float(np.abs(est[a][:, :3, 3] - est[b][:, :3, 3]).max())

    floor = diff("per-step again")
    limit = max(3 * floor, 1e-3)
    print(f"[chunked] largest position difference from the per-step run "
          f"(floor, per step twice, {floor:.3e} m): held run (depth "
          f"{CHUNK_DEPTH_HELD}) {diff('chunked, held'):.3e} m (limit "
          f"{limit:.3e} m), last map count {count['chunked, held']} vs "
          f"{count['per-step']}; depth {CHUNK_DEPTH} "
          f"{diff('chunked'):.3e} m, map count {count['chunked']} after "
          f"{runs['chunked'].map_version} compactions")
    print(f"[chunked] launches: {launches}")
    print(f"[chunked] {_one_f_a_call('chunked', launches)}")
    for name, slam in runs.items():
        if not np.all(np.isfinite(est[name])):
            raise AssertionError(f"chunked: {name}: non-finite poses")
        if slam.creations_dropped:
            raise AssertionError(f"chunked: {name}: creations dropped")
        if not ates[name] <= ref:
            raise AssertionError(f"chunked: {name}: ATE {ates[name]} m above "
                                 f"the reference's {ref} m")
    held = runs["chunked, held"]
    if not held.syncs < runs["per-step"].syncs:
        raise AssertionError(f"chunked: the depth-{CHUNK_DEPTH_HELD} run read "
                             f"the host {held.syncs} times, the per-step run "
                             f"{runs['per-step'].syncs}")
    if not diff("chunked, held") <= limit:
        raise AssertionError(f"chunked: poses {diff('chunked, held')} m "
                             f"off, limit {limit}")
    if abs(count["chunked, held"] - count["per-step"]) \
            > 0.005 * count["per-step"] or held.map_version:
        raise AssertionError(f"chunked: map counts {count}, "
                             f"{held.map_version} compactions")
    if launches["bilateral_filter"] != n or launches["zbuffer_cells"] < 2 * n:
        raise AssertionError(f"chunked: kernels ran {launches} over {n} "
                             "scans")
    return launches


STEP_GRAPH_CELL = "suma-norevisit-offline"
STEP_GRAPH_PROFILED = (10, 20)   # the scans of each run in the profiler


def _cell_sequence(dev, cell: str, seed: int):
    """A benchmark cell's configuration, traffic and one of its sequences
    (the benchmark's own generator, rendered onto the card)."""
    from suma_bench import generator, harness
    from suma_bench.run import port_config
    spec = harness.cell(cell)
    cfgj, traffic = spec["config"], spec["traffic"]
    scans, _ = generator.render_sequence(traffic, cfgj["suma"]["data"],
                                         cfgj["sensor"], seed, dev)
    return port_config(cfgj["suma"]), traffic, scans


def _launch_rows(prof, n: int) -> tuple:
    """``(device operations, launch calls)`` a scan in a profile of ``n``
    scans: the card's kernels, copies and fills, and the host's calls that
    put work on it (a graph's launch is one call)."""
    from torch.autograd import DeviceType
    ops = calls = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            ops += e.count
        elif e.key.startswith("cu") and any(
                k in e.key for k in ("Launch", "Memcpy", "Memset")):
            calls += e.count
    return ops / n, calls / n


def phase_step_graph(dev):
    """``[step-graph]``: one sequence of the benchmark cell
    ``suma-norevisit-offline`` (45 scans through ``process_scan_async`` at
    the cell's depth, then ``flush`` and ``finalize``) through three fresh
    sessions: without step graphs (the session's taken away), then twice
    with them, the second as the benchmark's window sessions run: it takes
    the graphs the first handed on, and captures nothing. Held:
    trajectories, every scan's packed row, creations and drops equal bit
    for bit; the second graph session replays every stage call, and every
    kernel of the step is launched from the graphs (kernel F among the
    profiled operations). Printed: each run's host seconds, device
    operations and launch calls a scan over the profiled scans, peak memory,
    and each graph session's captures, replays and eager calls by stage,
    eager calls by reason and capture ms."""
    from torch.profiler import ProfilerActivity, profile

    from semantic_suma_tpu_torch.core.pipeline import SurfelSLAM
    from semantic_suma_tpu_torch.core.step_graph import STAGES

    cfg, traffic, scans = _cell_sequence(dev, STEP_GRAPH_CELL, 7)
    depth = int(traffic["pipeline_depth"])
    a, b = STEP_GRAPH_PROFILED
    runs = {}
    for name in ("eager", "graphs", "graphs again"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        slam = SurfelSLAM(cfg, pipeline_depth=depth, device=dev)
        graphs = slam._graphs
        if name == "eager":
            slam._graphs = None
        rows = []
        step = slam._step

        def keep(*args, step=step, rows=rows):
            packed, reads = step(*args)
            rows.append(packed.clone())
            return packed, reads
        slam._step = keep
        t0 = time.perf_counter()
        for i, s in enumerate(scans):
            if i == a:
                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
            slam.process_scan_async(s.points, s.labels, s.probs, s.valid)
            if i + 1 == b:
                torch.cuda.synchronize()
                prof.__exit__(None, None, None)
        slam.flush()
        slam.finalize()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ops, calls = _launch_rows(prof, b - a)
        kernel_f = sum(e.count for e in prof.key_averages()
                       if "gn_loop_kernel" in e.key) / (b - a)
        runs[name] = dict(traj=slam.trajectory(), rows=rows,
                          stats=[(st["surfels-created"],
                                  st["creations-dropped"])
                                 for st in slam.statistics],
                          summary=None if name == "eager"
                          else graphs.replayer.summary())
        print(f"[step-graph] {name}: {len(scans)} scans in {dt:.3f} s "
              f"(host clock, scans {a}-{b - 1} profiled); device operations "
              f"{ops:.1f} and launch calls {calls:.1f} a profiled scan, "
              f"kernel F {kernel_f:.1f}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; map "
              f"surfels {slam.statistics[-1]['map-count']}, dropped "
              f"{slam.creations_dropped}, track losses "
              f"{slam.track_loss_count}")
        if name != "eager":
            print(f"[step-graph] {name}: "
                  f"{json.dumps(graphs.replayer.summary())}")
        if name == "graphs again" and not kernel_f >= 1:
            raise AssertionError("step-graph: kernel F not among the "
                                 "profiled graph operations")
        # the session hands its graphs on when it is collected (``keep``
        # holds it in a cycle)
        del slam, graphs, step, keep
        gc.collect()
    want = runs["eager"]
    for name in ("graphs", "graphs again"):
        got = runs[name]
        same = (np.array_equal(got["traj"], want["traj"])
                and got["stats"] == want["stats"]
                and len(got["rows"]) == len(want["rows"])
                and all(torch.equal(x, y)
                        for x, y in zip(got["rows"], want["rows"])))
        print(f"[step-graph] {name} against eager: trajectories, packed "
              f"rows, creations and drops "
              f"{'equal bit for bit' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"step-graph: {name} differs from eager")
    again = runs["graphs again"]["summary"]
    if any(again["eager"][st] or again["captures"][st] for st in STAGES):
        raise AssertionError(f"step-graph: the session that took the "
                             f"graphs over did not replay every call: "
                             f"{again}")


def phase_default_path(dev):
    """The package's default preprocessing (no bilateral filter) once on
    the card, on the main path's world: 8 warm-up + 30 timed scans."""
    import dataclasses

    from semantic_suma_tpu_torch.config import odometry_config
    from semantic_suma_tpu_torch.core.pipeline import SurfelSLAM
    from semantic_suma_tpu_torch.io.simulation import (circular_trajectory,
                                                       default_world,
                                                       render_scan)
    from semantic_suma_tpu_torch.utils.metrics import ate_rmse

    cfg = odometry_config()
    cfg = cfg.replace(preprocess=dataclasses.replace(
        cfg.preprocess, use_filtered_vertexmap=False))
    n_warm, n_timed = 8, 30
    n = n_warm + n_timed
    world = default_world(seed=0, extent=45.0)
    gt = circular_trajectory(n, radius=18.0, step=1.5, device=dev)
    scans = [render_scan(world, gt[i], cfg.data) for i in range(n)]
    slam = SurfelSLAM(cfg, device=dev)
    tally = _SyncTally(slam)
    _zero_launch_counts()
    for i in range(n):
        if i == n_warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        s = scans[i]
        if i < n_warm:
            slam.process_scan(s.points, s.labels, s.probs, s.valid)
        else:
            tally.run(lambda: slam.process_scan(s.points, s.labels, s.probs,
                                                s.valid), 1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _read_launch_counts()
    est = slam.trajectory()
    if not np.all(np.isfinite(est)):
        raise AssertionError("default path: non-finite poses")
    if slam.creations_dropped:
        raise AssertionError(f"default path: {slam.creations_dropped} "
                             "creations dropped")
    ate = ate_rmse(gt.cpu().numpy().astype(np.float64), est)
    print(f"[default] use_filtered_vertexmap=False, {n} scans ({n_warm} "
          f"warm-up + {n_timed} timed): {n_timed / dt:.2f} scans/s, "
          f"{dt / n_timed * 1e3:.2f} ms/scan, aligned ATE {ate:.5f} m, map "
          f"surfels {slam.statistics[-1]['map-count']}, dropped creations 0")
    print(f"[default] {tally.check('default', True)}")
    print(f"[default] {_one_f_a_call('default', launches)}")


def _ring_graph(n: int = 128, n_loops: int = 8, seed: int = 0):
    """A ring of ``n`` poses (one metre apart) with noisy odometry edges and
    ``n_loops`` robust loop edges (true relative poses) between poses half a
    ring apart and to the start; made from ``seed``. The odometry noise
    shrinks with ``sqrt(128 / n)`` so that every size starts with a drift of
    the same order."""
    from semantic_suma_tpu_torch.core.posegraph import Posegraph
    from semantic_suma_tpu_torch.utils import lie

    def exp(x):
        return lie.se3_exp(torch.as_tensor(x, dtype=torch.float32)).numpy()

    rng = np.random.default_rng(seed)
    sigma = 0.01 * (128.0 / n) ** 1.5
    inc = exp([1.0, 0, 0, 0, 0, 2 * np.pi / n])
    g = Posegraph()
    g.set_initial(0, np.eye(4))
    truth, est = [np.eye(4)], [np.eye(4)]
    for i in range(1, n):
        truth.append(truth[-1] @ inc)
        meas = inc @ exp(rng.normal(0, sigma, 6) * [1, 1, 0.2, 0.1, 0.1, 1])
        est.append(est[-1] @ meas)
        g.set_initial(i, est[-1])
        g.add_edge(i - 1, i, meas)
    for k in range(n_loops):
        i = n - 1 - k * 5
        j = (i + n // 2 + k) % (n // 2)
        g.add_edge(i, j, np.linalg.inv(truth[i]) @ truth[j],
                   np.full(6, 100.0, np.float32), robust=True)
    return g


# card-vs-CPU limit of the 128-pose solve, m and rad: the largest difference
# read over 96 card solves on an H100 was 7.24e-5 m (PERF.md); 2x margin
POSEGRAPH_LIMIT = 1.5e-4


def _posegraph_limits(n: int):
    """(m, rad) allowed between the card's and the CPU's solve of an
    ``n``-pose ring, ``n`` metres long: float32 positions resolve 6e-8 of
    the ring's length, and the readings grow with it (PERF.md: 1.6e-3 m and
    1.6e-4 rad at 4096 poses)."""
    return max(POSEGRAPH_LIMIT, 1e-6 * n), max(POSEGRAPH_LIMIT, 1e-7 * n)


POSEGRAPH_SIZES = (128, 256, 512, 1024, 2048, 4096)


def phase_posegraph(dev):
    """Ring graphs of 128 to 4096 poses, each solved on the card and with
    ``device="cpu"`` (10 Gauss-Newton iterations at most, ``dcs``). The two
    results must agree within ``_posegraph_limits`` and the error must fall
    on both. The card sums its float32 ``index_add_``
    contributions in no fixed order, so two card solves differ from each
    other. The times say where the loop closer's small-graph rule
    (``SMALL_GRAPH_POSES``) belongs: the printed crossover is the largest
    size at which the CPU was still the faster one in this run."""
    from semantic_suma_tpu_torch.core import posegraph as pg
    from semantic_suma_tpu_torch.core.loop_closure import SMALL_GRAPH_POSES
    from semantic_suma_tpu_torch.device import to_host

    def solve(device, n):
        g = _ring_graph(n)
        data = g.to_device(device=device)
        err0 = float(pg._robust_cost(pg._residuals(data.poses, data), data,
                                     "dcs", 1.0))
        reads0 = to_host.count
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        err = g.optimize(max_iterations=10, robust_kernel="dcs",
                         robust_delta=1.0, device=device)
        if device != "cpu":
            torch.cuda.synchronize()
        return (np.stack(g.poses()), err0, err, time.perf_counter() - t0,
                to_host.count - reads0)

    solve(dev, 128)  # library handles, first-call costs
    solve("cpu", 128)
    out = []
    for n in POSEGRAPH_SIZES:
        lim_t, lim_r = _posegraph_limits(n)
        pg_, e0, eg, tg, reads = solve(dev, n)
        pc_, _, ec, tc, reads_c = solve("cpu", n)
        dt = float(np.abs(pg_[:, :3, 3] - pc_[:, :3, 3]).max())
        dr = max(_small_angle(torch.from_numpy(np.linalg.inv(a) @ b))
                 for a, b in zip(pc_.astype(np.float64),
                                 pg_.astype(np.float64)))
        print(f"[posegraph] {n}-pose ring, {n - 1} odometry + 8 robust loop "
              f"edges (dcs): error {e0:.4f} -> card {eg:.6f}, CPU {ec:.6f}; "
              f"card vs CPU max {dt:.3e} m, {dr:.3e} rad (limits "
              f"{lim_t:.2e}, {lim_r:.2e}); card {tg * 1e3:.1f} ms with "
              f"{reads} host reads, CPU {tc * 1e3:.1f} ms with {reads_c}")
        if not (dt <= lim_t and dr <= lim_r):
            raise AssertionError(f"pose graph ({n} poses): card and CPU "
                                 f"differ by {dt} m, {dr} rad")
        if not (eg < e0 and ec < e0):
            raise AssertionError(f"pose graph ({n} poses): the error did not "
                                 f"fall ({e0} -> {eg}, {ec})")
        out.append({"poses": n, "card_ms": tg * 1e3, "cpu_ms": tc * 1e3,
                    "host_reads": reads, "diff_m": dt, "diff_rad": dr})
    cpu_wins = [r["poses"] for r in out if r["cpu_ms"] <= r["card_ms"]]
    print(f"[posegraph] the CPU was the faster one at {cpu_wins} poses of "
          f"{list(POSEGRAPH_SIZES)}; the loop closer asks for the CPU up to "
          f"SMALL_GRAPH_POSES = {SMALL_GRAPH_POSES}")
    return out


def _render_candidates(view, pose, cfg, conf, thr, which):
    """(ids, depth) that ``render_view`` hands the z-buffer for one view."""
    from semantic_suma_tpu_torch.core import surfel_map as sm
    from semantic_suma_tpu_torch.utils import lie
    proj = sm._project_surfels(view, lie.se3_inverse(pose), cfg.model)
    sel = sm._selection(view, proj, cfg.map, conf, thr, which)
    ids = torch.where(sel, proj.py * cfg.model.width + proj.px, -1)
    return ids, torch.where(sel, proj.depth, torch.inf)


def _zb_real(label, ids, depth, cells, floors):
    """Kernel B against its plain version on the candidates of a real view:
    winners and depths exactly equal, before and after graph replays."""
    from semantic_suma_tpu_torch.ops import zbuffer as zb
    exact, scale, qmax = zb._quantization(cells, 100.0)
    want = tuple(x[0] for x in zb.zbuffer_cells_plain(
        ids, depth, (), cells, exact=exact, scale=scale, qclip=qmax, qoff=0))
    got = zb.zbuffer_argmin(ids, depth, cells, depth_bound=100.0)
    torch.cuda.synchronize()
    if not _same(got, want):
        raise AssertionError(f"zbuffer {label} (real view): kernel and plain "
                             "version differ")
    ms, eager_ms = time_ms(
        lambda: zb.zbuffer_argmin(ids, depth, cells, depth_bound=100.0), 500)
    got = zb.zbuffer_argmin(ids, depth, cells, depth_bound=100.0)
    torch.cuda.synchronize()
    if not _same(got, want):
        raise AssertionError(f"zbuffer {label} (real view): wrong after "
                             "graph replays")
    n = ids.shape[0]
    filled = int((want[0] >= 0).sum())
    nbytes = n * (ids.element_size() + 4) + cells * (8 + 4)
    bound = max(nbytes / HBM_BYTES_PER_S,
                filled / floors["atomics_per_s"]) * 1e3
    print(f"[zbuffer] {label}, real old view of the loop run: {n} candidates "
          f"({int((ids >= 0).sum())} selected) -> {filled} of {cells} cells "
          f"filled, winners and depths exact (after graph replays too); "
          f"kernel {ms:.5f} ms (eager calls {eager_ms:.5f} ms), bound "
          f"{bound:.5f} ms")
    return {"real_ms": ms, "real_eager_ms": eager_ms, "real_bound_ms": bound,
            "real_filled": filled}


def _scan_kind(new_stats, verify_dispatched: bool, gn_calls: int) -> str:
    """The type of one call of the loop path. ``loop-candidate-found`` is in
    a scan's statistics whenever the search was entered; it ran its three
    alignments only if an old pose was near, which the ``gauss_newton``
    calls of the call show (odometry alone makes 1, a verification 2)."""
    if any("loop-candidate-found" in st for st in new_stats) and gn_calls > 2:
        return "searching"
    if verify_dispatched or any("loop-verifying" in st for st in new_stats):
        return "verifying"
    return "cruising"


def _loop_feeder(slam, rows):
    """``feed(scan) -> kind``: one ``process_scan_async`` call, with a row
    (kind, host reads, gauss_newton calls, iterations, seconds) appended to
    ``rows``. The iterations are the sum of the call's latched loops'
    ``iterations`` (``icp.gauss_newton_latched`` wrapped for the call), a
    device tensor that ``_print_call_types`` reads, or 0."""
    from semantic_suma_tpu_torch.device import to_host
    from semantic_suma_tpu_torch.ops import icp
    from semantic_suma_tpu_torch.ops.icp import gn_counts
    latched = icp.gauss_newton_latched

    def feed(s):
        its = []

        def counted(*args, **kwargs):
            result = latched(*args, **kwargs)
            its.append(result.iterations)
            return result

        before = (to_host.count, gn_counts["calls"], len(slam.statistics),
                  slam.stopwatch.stats["verify-dispatch"].count)
        icp.gauss_newton_latched = counted
        t0 = time.perf_counter()
        try:
            slam.process_scan_async(s.points, s.labels, s.probs, s.valid)
        finally:
            dt = time.perf_counter() - t0
            icp.gauss_newton_latched = latched
        calls = gn_counts["calls"] - before[1]
        kind = _scan_kind(
            slam.statistics[before[2]:],
            slam.stopwatch.stats["verify-dispatch"].count > before[3], calls)
        rows.append((kind, to_host.count - before[0], calls,
                     sum(k.to(torch.int64) if isinstance(k, torch.Tensor)
                         else k for k in its), dt))
        return kind

    return feed


def _print_call_types(label, part):
    its = [r[3] for r in part]
    if any(isinstance(x, torch.Tensor) for x in its):  # one read, here
        its = torch.stack([torch.as_tensor(x, device="cuda").reshape(())
                           .to(torch.int64) for x in its]).tolist()
    part = [(r[0], r[1], r[2], n, r[4]) for r, n in zip(part, its)]
    for kind in ("cruising", "verifying", "searching"):
        sel = [r for r in part if r[0] == kind]
        if not sel:
            print(f"{label}: no {kind} call")
            continue
        m = np.mean([r[1:] for r in sel], axis=0)
        print(f"{label}: {len(sel)} {kind} calls: host reads {m[0]:.1f}, "
              f"gauss_newton calls {m[1]:.2f}, iterations {m[2]:.1f}, "
              f"{m[3] * 1e3:.1f} ms per call (host clock)")


def _count_solves(lc) -> dict:
    """Wrap the closer's small-graph rule so that every pose-graph solve it
    asks for is tallied by device; returns the tally."""
    solves = {}
    rule = lc._solve_device

    def counted_rule(n_poses):
        where = rule(n_poses)
        solves[str(where)] = solves.get(str(where), 0) + 1
        return where

    lc._solve_device = counted_rule
    return solves


# gauss_newton calls made before the launch counters were last zeroed
_GN_CALLS_AT_ZERO = [0]


def _zero_launch_counts():
    from semantic_suma_tpu_torch.ops.bilateral import bilateral_filter
    from semantic_suma_tpu_torch.ops.epilogue import bn_act
    from semantic_suma_tpu_torch.ops.icp import (evaluate, gn_counts, gn_loop,
                                                 gn_update, icp_products,
                                                 plain_on_cuda)
    from semantic_suma_tpu_torch.ops.knn import knn_clean_image
    from semantic_suma_tpu_torch.ops.sac import sac_attention, sac_modulate
    from semantic_suma_tpu_torch.ops.zbuffer import zbuffer_cells
    bilateral_filter.launches = 0
    zbuffer_cells.launches = 0
    zbuffer_cells.launches_by_shape = {}
    knn_clean_image.launches = 0
    bn_act.launches = 0
    sac_attention.launches = 0
    sac_modulate.launches = 0
    icp_products.launches = 0
    gn_update.launches = 0
    gn_loop.launches = 0
    evaluate.calls = 0
    plain_on_cuda["build_rows"] = 0
    _GN_CALLS_AT_ZERO[0] = gn_counts["calls"]


def _read_launch_counts() -> dict:
    """The kernels' launches since ``_zero_launch_counts``, the calls of
    ``icp.evaluate`` and of ``build_rows`` on CUDA tensors, and the
    ``gauss_newton`` calls (``gn_calls``) of this process in that time."""
    from semantic_suma_tpu_torch.cli import _launch_counts
    from semantic_suma_tpu_torch.ops.icp import gn_counts
    return {**_launch_counts(),
            "gn_calls": gn_counts["calls"] - _GN_CALLS_AT_ZERO[0]}


def _one_f_a_call(tag: str, launches: dict) -> str:
    """Assert one launch of kernel F a ``gauss_newton`` or ``evaluate`` call,
    none of kernels D and E and no plain linearization (``build_rows`` on a
    CUDA tensor); return the line that says so."""
    line = (f"kernel F {launches['gn_loop']} launches for "
            f"{launches['gn_calls']} gauss_newton calls and "
            f"{launches['evaluate_calls']} evaluate calls; kernels D and E "
            f"{launches['icp_products']} and {launches['gn_update']}; "
            f"build_rows on CUDA {launches['build_rows_on_cuda']}")
    if launches["gn_loop"] != launches["gn_calls"] \
            + launches["evaluate_calls"] \
            or launches["gn_calls"] == 0 or launches["icp_products"] \
            or launches["gn_update"] or launches["build_rows_on_cuda"]:
        raise AssertionError(f"{tag}: {line}")
    return line


def _d_and_e_a_trip(tag: str, launches: dict) -> str:
    """Assert that a sharded path ran the Gauss-Newton iterations of its
    sharded steps on kernels D and E (as many launches of each, at least
    one) and made no plain linearization; return the line that says so.
    Kernel F runs there too: the loop closer's verification and its
    ``evaluate`` on the replicated scan."""
    line = (f"kernels D and E {launches['icp_products']} and "
            f"{launches['gn_update']} launches (the sharded Gauss-Newton "
            f"iterations, summed over the ranks); kernel F "
            f"{launches['gn_loop']} ({launches['evaluate_calls']} of them "
            f"evaluate); build_rows on CUDA {launches['build_rows_on_cuda']}")
    if not launches["icp_products"] \
            or launches["icp_products"] != launches["gn_update"] \
            or launches["build_rows_on_cuda"]:
        raise AssertionError(f"{tag}: {line}")
    return line


# the most scans ``--profile-scans`` adds to the loop path
LOOP_PROFILE_SCANS = 4


def phase_loop(dev, floors, profile_scans: int = 0):
    """The loop-closure path at full width (see the module docstring)."""
    from semantic_suma_tpu_torch.config import loop_config
    from semantic_suma_tpu_torch.core import surfel_map as sm
    from semantic_suma_tpu_torch.core.loop_closure import LoopCloser
    from semantic_suma_tpu_torch.core.pipeline import SurfelSLAM
    from semantic_suma_tpu_torch.io.simulation import (circular_trajectory,
                                                       default_world,
                                                       render_scan)
    from semantic_suma_tpu_torch.utils.metrics import ate_rmse

    cfg = loop_config()
    n_lap, n_timed = 64, 60   # one lap at radius 18, step 1.8; then revisit
    # traced after the timed lap; 128 scans in all, so that every solve of
    # this phase is a small graph's (phase 9 drives the larger ones)
    n_traced = 4
    n_tail = 4      # fed last: the graph of finalize() is a large one
    # the arena is sized for this lap: 136 scans drop no creation, 142
    # dropped 11,092 on an H100 (PERF.md, Findings)
    profile_scans = min(profile_scans, LOOP_PROFILE_SCANS)
    n = n_lap + n_timed
    n_all = n + n_traced + profile_scans + n_tail
    world = default_world(seed=0, extent=45.0)
    gt = circular_trajectory(n_all, radius=18.0, step=1.8, device=dev)
    scans = [render_scan(world, gt[i], cfg.data) for i in range(n_all)]
    torch.cuda.synchronize()

    slam = SurfelSLAM(cfg, device=dev)
    lc = slam._loop
    lc.warmup(slam)
    torch.cuda.synchronize()
    print(f"[loop] warmup {slam.stopwatch.stats['loop-warmup'].total:.2f} s")
    solves = _count_solves(lc)
    _zero_launch_counts()

    rows = []   # per call: (kind, host reads, GN calls, GN iterations, s)
    feed = _loop_feeder(slam, rows)
    for i in range(n_lap):
        feed(scans[i])
    slam.flush()
    torch.cuda.synchronize()
    lap1 = len(rows)
    t0 = time.perf_counter()
    for i in range(n_lap, n):
        feed(scans[i])
    slam.flush()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    # the path's own launches: read here, before anything else launches
    counts = _read_launch_counts()

    print(f"[loop] {n} scans {cfg.data.height}x{cfg.data.width} (lap of "
          f"{n_lap} + {n_timed} timed, process_scan_async then flush): "
          f"{n_timed / dt:.2f} scans/s, {dt / n_timed * 1e3:.2f} ms/scan "
          f"(host clock); closures {lc.num_loop_closures}, optimizations "
          f"{lc.num_optimizations}, rebases {lc.num_rebases}, soft "
          f"integrations {lc.num_soft_integrations}")
    _print_call_types("[loop] lap 1", rows[:lap1])
    _print_call_types("[loop] timed lap", rows[lap1:])
    print(f"[loop] kernel B launches by (candidates, flags): "
          f"{sorted(counts['zbuffer_cells_by_shape'].items())}")
    print(f"[loop] {_one_f_a_call('loop', counts)}")

    # device launches per call: some more scans, each traced on its own
    launches = {}
    for i in range(n, n + n_traced):
        kinds = []
        count = _traced_launches(lambda: kinds.append(feed(scans[i])))
        launches.setdefault(kinds[0], []).append(count)
    if profile_scans:
        _device_profile(
            slam, scans[n + n_traced:n_all - n_tail], dt / n_timed * 1e3,
            step=lambda sc: slam.process_scan_async(sc.points, sc.labels,
                                                    sc.probs, sc.valid))
    slam.flush()
    print("[loop] device launches per call over "
          f"{n_traced} more scans, each traced on its own: "
          + ", ".join(f"{k} {np.mean(v):.0f} ({len(v)} calls)"
                      for k, v in sorted(launches.items())))

    # kernel B on the candidates of real old views of this run
    ts = slam.timestamp
    thr = ts - cfg.loop.delta_timestamp
    conf = slam.confidence_threshold()
    pose = slam.state.pose
    center = pose[:3, 3]
    cells = cfg.model.height * cfg.model.width
    view_s = sm.refresh_active(slam.state.map, center, cfg.map,
                               priority="old", ts_threshold=thr).active
    view_v = sm.build_view(slam.state.map, center, cfg.map,
                           slam._verify_blocks, ts_threshold=thr)
    view_n = sm.refresh_active(slam.state.map, center, cfg.map,
                               priority="new").active
    ids_s, dep_s = _render_candidates(view_s, pose, cfg, conf, thr, "old")
    ids_v, dep_v = _render_candidates(view_v, pose, cfg, conf, thr, "old")
    ids_n, dep_n = _render_candidates(view_n, pose, cfg, conf, thr, "new")
    real = {
        "render-search": _zb_real("render-search", ids_s, dep_s, cells,
                                  floors),
        "render-verify": _zb_real("render-verify", ids_v, dep_v, cells,
                                  floors),
        "render-composed": _zb_real(
            "render-composed", torch.cat([ids_s, ids_n]),
            torch.cat([dep_s, dep_n]), cells, floors)}
    # card against CPU on one verify program from this state
    view, vthr = slam.old_view(lc.pose_old if lc.pose_old is not None
                               else slam.poses[-1])
    args = (view, vthr, slam._tensor(slam.poses[-1]), slam.last_maps,
            slam.model_maps, slam.last_increment, conf)
    vec_g, _ = lc._fused[0](*args)
    cpu_lc = LoopCloser(cfg, device="cpu")
    cpu_lc._build_fused()
    vec_c, _ = cpu_lc._fused[0](*_to(args, torch.device("cpu")))
    vg, vc = vec_g.cpu().double(), vec_c.double()
    d_pose = float((vg[34:50] - vc[34:50]).abs().max())
    d_inc = float((vg[:22] - vc[:22]).abs().max())
    d_cnt = float((vg[[23, 24, 25, 27, 29, 30, 31, 33]]
                   - vc[[23, 24, 25, 27, 29, 30, 31, 33]]).abs().max())
    print(f"[loop] verify on the card vs on a CPU copy of the same state: "
          f"pose_old {d_pose:.3e}, increment and its log {d_inc:.3e}, counts "
          f"differ by at most {d_cnt:.0f} pixels of {cells} (limits 1e-3, "
          f"1e-3, 0.5% of the pixels)")
    if not (d_pose <= 1e-3 and d_inc <= 1e-3 and d_cnt <= 0.005 * cells):
        raise AssertionError("verify: card and CPU disagree")
    # kernels D, E and F at the verify program's inputs: the scan against the
    # old map rendered at the anchor
    old_maps = sm.render_view(view, args[2], cfg.model, cfg.map, conf, vthr,
                              "old")
    real["icp-verify"] = _hold_icp("loop-verify", slam.last_maps, old_maps,
                                   slam.last_increment, cfg)
    real["gn-loop-verify"] = _hold_gn_loop(
        "loop-verify", slam.last_maps, old_maps, slam.last_increment, cfg)
    real["sharded-verify"] = _hold_sharded(
        "loop-verify", slam.last_maps, old_maps, slam.last_increment, cfg)
    # evaluate at its own inputs: the scan against the composed old and new
    # views (the verification chain's composed statistics)
    comp = sm.compose_views(old_maps, slam.model_maps,
                            cfg.loop.max_loop_closure_distance)
    real["evaluate"] = _hold_evaluate("loop-composed", slam.last_maps, comp,
                                      cfg)

    # past SMALL_GRAPH_POSES poses the closer solves on the card: finalize()
    # does so here, on the path
    for s_ in scans[n_all - n_tail:]:
        feed(s_)
    slam.finalize()
    est = slam.trajectory()
    if not np.all(np.isfinite(est)):
        raise AssertionError("loop path: non-finite poses")
    m = len(est)
    ate = ate_rmse(gt[:m].cpu().numpy().astype(np.float64), est)
    print(f"[loop] after finalize: {m} poses, closures "
          f"{lc.num_loop_closures}, optimizations {lc.num_optimizations}, "
          f"rebases {lc.num_rebases}, soft integrations "
          f"{lc.num_soft_integrations}, aligned ATE {ate:.5f} m (limit "
          f"{LOOP_ATE_LIMIT_M}), map surfels "
          f"{slam.statistics[-1]['map-count']}, dropped creations "
          f"{slam.creations_dropped}")
    print("[loop] stopwatch (host clock): " + "; ".join(
        f"{k} {v['mean_ms']:.2f} ms x{v['count']}"
        for k, v in sorted(slam.stopwatch.summary().items())))
    print(f"[loop] pose-graph solves asked for, by device: "
          f"{sorted(solves.items())}")
    if not any(k.startswith("cuda") for k in solves):
        raise AssertionError("loop path: no pose-graph solve on the card")
    if lc.num_loop_closures < 1 or lc.num_optimizations < 1:
        raise AssertionError("loop path: no closure or no optimization")
    if slam.creations_dropped:
        raise AssertionError(f"loop path: {slam.creations_dropped} creations "
                             "dropped")
    if not ate <= LOOP_ATE_LIMIT_M:
        raise AssertionError(f"loop path: ATE {ate} m > {LOOP_ATE_LIMIT_M} m")
    return counts, real


# phase 9: range noise (m, one sigma), scans, and its aligned ATE limit:
# 0.0195 to 0.0230 m over seven runs on an H100 (the order in which the
# background solves land moves it), held with 2x margin (PERF.md)
NOISY_SIGMA_M = 0.03
NOISY_SCANS = 100
NOISY_ATE_LIMIT_M = 0.04


def phase_loop_noisy(dev, sigma: float = NOISY_SIGMA_M,
                     n: int = NOISY_SCANS, seed: int = 2):
    """The loop path once more on scans with range noise, so that the
    odometry drifts, the optimized graph moves the map past the rebase gates
    and broken chains search again: the full rebase (``update_poses`` and
    the model re-render) and repeated searches run on the card with real
    corrections. The calls that search or integrate are traced on their
    own, so the device launches of a searching and of a rebasing call are
    read; the host clock of those calls includes the tracer. 100 scans:
    with this noise the 2^21-row arena is full after ~135 (1.53 M surfels
    at 100, 2.09 M and dropped creations at 140), and spill cannot help on
    this circle (``loop_config()`` turns it off; its keep radius of 70 m
    holds the whole map). All its graphs are small ones, solved on the
    CPU."""
    from semantic_suma_tpu_torch.config import loop_config
    from semantic_suma_tpu_torch.core.pipeline import SurfelSLAM
    from semantic_suma_tpu_torch.io.simulation import (SimulationReader,
                                                       default_world)
    from semantic_suma_tpu_torch.utils.metrics import ate_rmse

    cfg = loop_config()
    reader = SimulationReader(cfg.data, n, world=default_world(0, extent=45.0),
                              radius=18.0, noise_sigma=sigma, seed=seed,
                              step=1.8, device=dev)
    scans = [reader.read(i) for i in range(n)]
    torch.cuda.synchronize()
    slam = SurfelSLAM(cfg, device=dev)
    lc = slam._loop
    lc.warmup(slam)
    torch.cuda.synchronize()
    solves = _count_solves(lc)
    _zero_launch_counts()
    rows = []
    feed = _loop_feeder(slam, rows)
    # traced on their own: the calls that will search (the closer asked for
    # a synchronous re-entry) or integrate a finished solve, and every 16th
    launches = {}
    for i in range(n):
        rebases = lc.num_rebases
        if lc.sync_request or lc.needs_integration or i % 16 == 15:
            kinds = []
            count = _traced_launches(lambda: kinds.append(feed(scans[i])))
            kind = kinds[0] + ("+rebase" if lc.num_rebases > rebases else "")
            launches.setdefault(kind, []).append(count)
        else:
            feed(scans[i])
    slam.flush()
    torch.cuda.synchronize()
    counts = _read_launch_counts()
    print(f"[loop-noisy] {_one_f_a_call('loop-noisy', counts)}")
    before_final = (lc.num_loop_closures, lc.num_optimizations,
                    lc.num_rebases, lc.num_soft_integrations)
    slam.finalize()
    est = slam.trajectory()
    if not np.all(np.isfinite(est)):
        raise AssertionError("noisy loop path: non-finite poses")
    ate = ate_rmse(reader.poses[:len(est)].cpu().numpy().astype(np.float64),
                   est)
    print(f"[loop-noisy] {n} scans, range noise {sigma} m (seed {seed}): "
          f"closures {before_final[0]}, optimizations "
          f"{before_final[1]}, rebases {before_final[2]}, soft integrations "
          f"{before_final[3]}; after finalize closures "
          f"{lc.num_loop_closures}, optimizations {lc.num_optimizations}, "
          f"rebases {lc.num_rebases}, aligned ATE {ate:.5f} m (limit "
          f"{NOISY_ATE_LIMIT_M}), map surfels "
          f"{slam.statistics[-1]['map-count']}, dropped creations "
          f"{slam.creations_dropped}")
    _print_call_types("[loop-noisy]", rows)
    print(f"[loop-noisy] pose-graph solves asked for, by device: "
          f"{sorted(solves.items())}")
    print("[loop-noisy] device launches per traced call: "
          + ", ".join(f"{k} {np.mean(v):.0f} (min {min(v)}, max {max(v)}, "
                      f"{len(v)} calls)" for k, v in sorted(launches.items())))
    print(f"[loop-noisy] kernel B launches by (candidates, flags): "
          f"{sorted(counts['zbuffer_cells_by_shape'].items())}")
    print("[loop-noisy] stopwatch (host clock): " + "; ".join(
        f"{k} {v['mean_ms']:.2f} ms x{v['count']}"
        for k, v in sorted(slam.stopwatch.summary().items())
        if k.startswith(("integrate", "loop/search", "verify"))))
    if before_final[2] < 1:
        raise AssertionError("noisy loop path: no rebase before finalize")
    if not any(k.startswith("searching") for k in launches):
        raise AssertionError("noisy loop path: no searching call traced")
    if not any("+rebase" in k for k in launches):
        raise AssertionError("noisy loop path: no rebasing call traced")
    if lc.num_loop_closures < 1:
        raise AssertionError("noisy loop path: no closure")
    if slam.creations_dropped:
        raise AssertionError(f"noisy loop path: {slam.creations_dropped} "
                             "creations dropped")
    if not ate <= NOISY_ATE_LIMIT_M:
        raise AssertionError(f"noisy loop path: ATE {ate} m > "
                             f"{NOISY_ATE_LIMIT_M} m")
    return counts


# phase 10: the accuracy-ledger rows through the CLI, each held at twice the
# JAX package's round-5 row of RESULTS.md (its own spread over rounds 3 to 5
# fits in that band). (ATE m, t_rel %) limits; None: not held
LEDGER_LIMITS = {"odometry": (0.0052, 0.0110), "noisy": (0.0424, 0.0800),
                 "loop": (0.0090, None), "segmenter": (0.0062, 0.0150),
                 "segmenter-full": (0.0062, 0.0148),
                 # the JAX row was taken on a virtual 8-device CPU mesh
                 "sharded-8dev": (0.0220, 0.0394)}
LEDGER_MIN_CLOSURES = 20   # the JAX package's row: 41
# the sharded-8dev row keeps JAX's recipe, whose 2^18-row arena is full from
# scan ~48 on (spill is futile on the 18 m circle): the JAX package drops
# 282,332 creations on its virtual 8-device CPU mesh (`python
# compare/sharded_row.py jax`), so the row's drops are held within 1% of
# that count, not to 0
JAX_SHARDED_DROPPED = 282_332


def phase_cli_ledger(dev):
    """The odometry, noisy, loop, segmenter and segmenter-full rows of the
    accuracy ledger through ``cli.main`` in this process, at the CLI's own
    sizing (64x900, 2^21-row arena, 2^18-row view, spill on, bilateral
    filter off), each row's launch counters zeroed just before it and read
    just after. Returns the counts by row."""
    from semantic_suma_tpu_torch.tools import make_results as mr

    counts, rows = {}, {}
    for name in mr.ROWS:
        _zero_launch_counts()
        row = mr.run_row(name)
        torch.cuda.synchronize()
        counts["cli_" + name] = (_sum_launches(row["ranks"]) if "ranks" in row
                                 else _read_launch_counts())
        rows[name] = row
        if "ranks" in row:
            print(f"[cli-ledger] {name}: 8 ranks on one card, "
                  f"{row['scans']} scans, {row['scans_per_sec']:.2f} scans/s "
                  f"(host clock, rank 0), the call {row['call_s']:.1f} s with "
                  f"the ranks' start")
            _rank_lines("cli-ledger", row["ranks"], row["scans"])
        for line in row["stderr"].splitlines():
            if line.startswith(("kernels built", "loop programs warmed")):
                print(f"[cli-ledger] {name}: {line}")
        sp = row.get("spill") or {}
        print(f"[cli-ledger] {name}: {' '.join(row['argv'])}: ATE "
              f"{row['ate_rmse_m']:.5f} m, t_rel {row['t_rel_percent']:.4f} %, "
              f"r_rel {row['r_rel_deg_per_100m']:.4f} deg/100m, final error "
              f"{row['final_error_m']:.4f} m; {row['scans_per_sec']:.2f} "
              f"scans/s, steady-state {row['steady_scans_per_sec']} scans/s "
              f"(host clock); creations dropped {row['creations_dropped']}; "
              f"spill: {sp.get('rows')} rows in {sp.get('chunks')} chunks, "
              f"{sp.get('paged_in')} chunks paged in, {sp.get('probes')} "
              f"probes ({sp.get('futile')} futile, {sp.get('stale')} stale)"
              + (f"; closures {row['loop_closures']}" if name == "loop"
                 else "")
              + (f"; held-out mIoU of the weights {row['val_miou']}"
                 if "val_miou" in row else "")
              + f"; kernel launches {counts['cli_' + name]}")
        print(f"[cli-ledger] {name}: " + (
            _d_and_e_a_trip(name, counts["cli_" + name]) if "ranks" in row
            else _one_f_a_call(name, counts["cli_" + name])))
    print("[cli-ledger] the RESULTS-format table:\n" + mr.table(rows))
    bad = []
    for name, (ate_lim, trel_lim) in LEDGER_LIMITS.items():
        r = rows[name]
        if not r["ate_rmse_m"] <= ate_lim:
            bad.append(f"{name}: ATE {r['ate_rmse_m']} m > {ate_lim}")
        if trel_lim is not None and not r["t_rel_percent"] <= trel_lim:
            bad.append(f"{name}: t_rel {r['t_rel_percent']} % > {trel_lim}")
    sh_drop = rows["sharded-8dev"]["creations_dropped"]
    print(f"[cli-ledger] sharded-8dev: creations dropped {sh_drop}, the JAX "
          f"package's recipe {JAX_SHARDED_DROPPED} (held within 1%)")
    if abs(sh_drop - JAX_SHARDED_DROPPED) > 0.01 * JAX_SHARDED_DROPPED:
        bad.append(f"sharded-8dev: {sh_drop} creations dropped, JAX "
                   f"{JAX_SHARDED_DROPPED}")
    for name in ("odometry", "loop", "segmenter", "segmenter-full"):
        if rows[name]["creations_dropped"]:
            bad.append(f"{name}: {rows[name]['creations_dropped']} creations "
                       "dropped")
    if rows["loop"]["loop_closures"] < LEDGER_MIN_CLOSURES:
        bad.append(f"loop: {rows['loop']['loop_closures']} closures < "
                   f"{LEDGER_MIN_CLOSURES}")
    if bad:
        raise AssertionError("ledger rows: " + "; ".join(bad))
    return counts, rows


KITTI_SCANS = 40
KITTI_ATE_LIMIT_M = 0.01


def phase_cli_kitti(dev, td):
    """The KITTI file path: ``export_synthetic_sequence`` of 40 scans at
    64x900 (valid points only, SemanticKITTI labels, a non-trivial ``Tr``)
    into a temporary directory, then ``cli run --dataset ... --export-poses
    ... --eval`` and ``cli eval --gt ... --est ... --calib ...``; the two
    ATEs must agree to 1e-6 m and lie under 0.01 m. Launch counters are
    zeroed just before the run and read just after it. The sequence stays
    in ``td`` for ``[readers]``."""
    import contextlib
    import io

    from semantic_suma_tpu_torch import cli
    from semantic_suma_tpu_torch.config import DataConfig
    from semantic_suma_tpu_torch.io.kitti import KITTIReader
    from semantic_suma_tpu_torch.io.kitti_export import \
        export_synthetic_sequence
    from semantic_suma_tpu_torch.tools.make_results import last_json

    seq = f"{td}/seq"
    t0 = time.perf_counter()
    export_synthetic_sequence(seq, KITTI_SCANS, DataConfig(), step=1.0,
                              device=dev)
    n_pts = [KITTIReader(seq).read(i).points.shape[0]
             for i in (0, KITTI_SCANS - 1)]
    t_exp = time.perf_counter() - t0
    est = f"{td}/est.txt"
    outs = []
    _zero_launch_counts()
    for argv in (["run", "--dataset", seq, "--export-poses", est,
                  "--eval"],
                 ["eval", "--gt", f"{seq}/poses.txt", "--est", est,
                  "--calib", f"{seq}/calib.txt"]):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            if cli.main(argv) != 0:
                raise AssertionError(f"cli {argv[0]} failed")
        outs.append(out.getvalue())
        if argv[0] == "run":
            torch.cuda.synchronize()
            counts = _read_launch_counts()
            summary = [line for line in err.getvalue().splitlines()
                       if "creations dropped" in line]
    run, ev = (last_json(o) for o in outs)
    d = abs(run["ate_rmse_m"] - ev["ate_rmse_m"])
    # projections: no flag and fewer candidates than the loop closer's
    # renders (2^17 and 2^18, the verify and search views)
    proj = {n: c for (n, f), c in counts["zbuffer_cells_by_shape"].items()
            if f == 0 and n < 1 << 17}
    print(f"[cli-kitti] kernel B projections of the files: "
          f"{sum(proj.values())} launches at {min(proj)} to {max(proj)} "
          f"candidates into 57,600 cells ({len(proj)} sizes)")
    print(f"[cli-kitti] exported {KITTI_SCANS} scans at 64x900 ({n_pts[0]} "
          f"and {n_pts[-1]} points in the first and last file) in "
          f"{t_exp:.1f} s; {outs[0].splitlines()[0]}")
    print(f"[cli-kitti] run --eval ATE {run['ate_rmse_m']:.6f} m, eval "
          f"--calib ATE {ev['ate_rmse_m']:.6f} m (|difference| {d:.2e}, limit "
          f"1e-6), final error {run['final_error_m']:.4f} m; "
          f"{summary[0] if summary else ''}; kernel B launches by "
          f"(candidates, flags): "
          f"{sorted(counts['zbuffer_cells_by_shape'].items())}")
    if not d <= 1e-6:
        raise AssertionError(f"cli eval and run --eval differ by {d} m")
    if not run["ate_rmse_m"] <= KITTI_ATE_LIMIT_M:
        raise AssertionError(f"KITTI path: ATE {run['ate_rmse_m']} m > "
                             f"{KITTI_ATE_LIMIT_M} m")
    return counts


# phase 12: the arena of the forced-spill run. 3 x 2^18 rows: under the lag-4
# headroom of six images (345,600 rows) SurfelSLAM asks for room once
# ~215 of its 384 blocks are taken, which these scans reach before scan 30;
# what lies beyond the keep radius of 17 m then is the far side of the circle
SPILL_ARENA_ROWS = 3 << 18
SPILL_SCANS = 80
# the final error is held to the same scans' run without spill: with 0.03 m
# of range noise a 12 m sensor drifts ~2 m over this circle at 900 columns,
# spill or not (the JAX package 1.73 m at 32x900 on the CPU, the port 2.08
# to 2.29 m at 64x900 over three noise seeds on an H100:
# compare/forced_spill_width.py), so the JAX test's 1.5 m, set at 24x120,
# does not carry over. 0.5 m: about twice the spread of those three seeds
SPILL_ERROR_MARGIN_M = 0.5


def _spill_cfg(arena_rows: int, spill: bool = True):
    """``tests/test_spill.py``'s forced-spill configuration at 64x900."""
    from semantic_suma_tpu_torch.config import forced_spill_config
    return forced_spill_config(64, 900, arena_rows, 1 << 18, spill=spill)


def _spill_drive(dev, cfg, scans):
    """80 scans through ``process_scan_async`` and ``finalize()``: (slam,
    scan of the first spill, most rows spilled at once, seconds)."""
    from semantic_suma_tpu_torch.core.pipeline import SurfelSLAM
    slam = SurfelSLAM(cfg, device=dev)
    slam._loop.warmup(slam)
    torch.cuda.synchronize()
    first, most = None, 0
    t0 = time.perf_counter()
    for i, s in enumerate(scans):
        slam.process_scan_async(s.points, s.labels, s.probs, s.valid)
        if slam.spill is not None:
            if slam.spill.spilled_rows and first is None:
                first = i
            most = max(most, slam.spill.spilled_rows)
    slam.finalize()
    torch.cuda.synchronize()
    return slam, first, most, time.perf_counter() - t0


def _final_error(slam, gt) -> float:
    est = slam.trajectory()
    n = len(est)
    rel = np.linalg.inv(gt[0]) @ gt[n - 1]
    return float(np.linalg.norm(est[n - 1][:3, 3] - rel[:3, 3]))


def phase_spill(dev):
    """Forced spill at full width: ``tests/test_spill.py``'s configuration
    (12 m sensor, keep radius 5 + 12 = 17 m, 4-block chunks) at 64x900 on a
    3 x 2^18-row arena, its boxes and its 80-scan noisy circle (r = 16 m,
    1.6 m steps, sigma 0.03 m, seed 2) through ``process_scan_async`` and
    ``finalize()``; the JAX test's bounds: spilled rows before scan 45, a
    chunk paged back in on the revisit, a closure, at most 1% of the
    creations dropped; and the final position within 0.5 m of the final
    position of the same scans on a 2^21-row arena with spill off, driven
    after it (``SPILL_ERROR_MARGIN_M`` says why not the JAX test's 1.5 m).
    Launch counters are zeroed just before the spill run and read just
    after it."""
    from semantic_suma_tpu_torch.io.simulation import (SimulationReader,
                                                       rich_world)
    from semantic_suma_tpu_torch.utils.metrics import ate_rmse

    cfg = _spill_cfg(SPILL_ARENA_ROWS)
    reader = SimulationReader(cfg.data, SPILL_SCANS, world=rich_world(),
                              radius=16.0, step=1.6, noise_sigma=0.03, seed=2,
                              device=dev)
    scans = [reader.read(i) for i in range(SPILL_SCANS)]
    gt = reader.poses.cpu().numpy().astype(np.float64)
    torch.cuda.synchronize()
    _zero_launch_counts()
    slam, first, most, dt = _spill_drive(dev, cfg, scans)
    counts = _read_launch_counts()
    sp, lc = slam.spill, slam._loop
    created = sum(st["surfels-created"] for st in slam.statistics)
    err = _final_error(slam, gt)
    ate = ate_rmse(gt, slam.trajectory())
    laps = slam.stopwatch.summary()
    print(f"[spill] {SPILL_SCANS} scans 64x900, arena {SPILL_ARENA_ROWS} rows "
          f"({SPILL_ARENA_ROWS // cfg.map.effective_block_size} blocks), view "
          f"{cfg.map.active_capacity}, keep radius "
          f"{cfg.map.active_radius + cfg.map.spill_margin} m: "
          f"{SPILL_SCANS / dt:.2f} scans/s (host clock); first spill at scan "
          f"{first}, at most {most} rows on the host, {len(sp.chunks)} "
          f"chunks ({sp.spilled_rows} rows) at the end, {sp.chunks_paged_in} "
          f"chunks paged in; {sp.probes} probes ({sp.futile_verdicts} futile, "
          f"{sp.stale_verdicts} stale verdicts); closures "
          f"{lc.num_loop_closures}, rebases {lc.num_rebases}; created "
          f"{created}, dropped {slam.creations_dropped}; final error "
          f"{err:.4f} m, aligned ATE {ate:.4f} m")
    print("[spill] host/* laps (host clock): " + "; ".join(
        f"{k} mean {v['mean_ms']:.3f} ms, max {v['max_ms']:.3f} ms x"
        f"{v['count']}" for k, v in sorted(laps.items())
        if k.startswith("host/")))
    print(f"[spill] kernel B launches by (candidates, flags): "
          f"{sorted(counts['zbuffer_cells_by_shape'].items())}")
    ref, _, _, dt_ref = _spill_drive(dev, _spill_cfg(1 << 21, spill=False),
                                     scans)
    err_ref = _final_error(ref, gt)
    print(f"[spill] reference, the same scans on a 2^21-row arena with spill "
          f"off: final error {err_ref:.4f} m, aligned ATE "
          f"{ate_rmse(gt, ref.trajectory()):.4f} m, closures "
          f"{ref._loop.num_loop_closures}, map "
          f"{ref.statistics[-1]['map-count']} surfels, dropped "
          f"{ref.creations_dropped}, {SPILL_SCANS / dt_ref:.2f} scans/s")
    bad = []
    if not (most > 0 and first is not None and first < 45):
        bad.append(f"first spill at scan {first}, not before 45")
    if sp.chunks_paged_in < 1:
        bad.append("no chunk paged back in")
    if lc.num_loop_closures < 1:
        bad.append("no closure")
    if slam.creations_dropped > 0.01 * created:
        bad.append(f"{slam.creations_dropped} of {created} creations dropped")
    if not err <= err_ref + SPILL_ERROR_MARGIN_M:
        bad.append(f"final error {err} m, {err_ref} m without spill")
    if bad:
        raise AssertionError("spill: " + "; ".join(bad))
    return counts


# ---------------------------------------------------------------------------
# the segmenter: the two versioned networks, kernel C, mIoU, the in-loop row
# ---------------------------------------------------------------------------

# label agreement of the card's network with a CPU copy's, on valid pixels:
# both compute in bfloat16 with float32 sums, in other orders
NET_AGREEMENT_MIN = 0.99
# the port's mIoU against the one recorded beside the weights: the port's
# simulator draws its range noise from a torch.Generator, not JAX's keys
MIOU_TOL = 0.03
KITTI_SEGMENTER_SCANS = 20


def _segmenter_scan(dev):
    """One rendered 64x900 scan of the segmenter's world (30% of the boxes
    cars, the ledger rows' ``--movable-fraction 0.3``)."""
    from semantic_suma_tpu_torch.config import DataConfig
    from semantic_suma_tpu_torch.io.simulation import (circular_trajectory,
                                                       default_world,
                                                       render_scan)
    cfg = DataConfig()
    pose = circular_trajectory(1, radius=18.0, step=1.5, device=dev)[0]
    return cfg, render_scan(default_world(seed=0, movable_fraction=0.3), pose,
                            cfg)


def _sync_warnings(fn) -> list:
    """The synchronizing CUDA operations that ``fn`` makes, as CUDA sync
    debug mode reports them (the mode's notice that it is a prototype is
    not one)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    msgs = [str(w.message) for w in caught]
    return [m for m in msgs if "synchroniz" in m and "prototype" not in m]


def phase_segmenter(dev):
    """The two versioned networks at full width (1x64x928 after the wrap
    pad) on one rendered scan: the card's logits against a CPU copy's (the
    plain path, bfloat16 on both), label agreement on valid pixels >= 0.99;
    per network the time of a call split into projection, network and KNN
    vote + ``labels_for_points`` (CUDA events, back-to-back calls), the
    network's device time (one forward in a replayed CUDA graph), the peak
    memory of a call, and that a call makes no host sync (CUDA sync debug
    mode). Returns the class and depth images of the mid
    network's call: kernel C's real input."""
    from semantic_suma_tpu_torch.models.rangenet import make_input
    from semantic_suma_tpu_torch.models.segmenter import Segmenter
    from semantic_suma_tpu_torch.ops.knn import labels_for_points
    from semantic_suma_tpu_torch.ops.projection import project_scan
    from semantic_suma_tpu_torch.tools.make_results import SEGMENTER_WEIGHTS

    cfg, scan = _segmenter_scan(dev)
    pts = scan.points
    zeros = torch.zeros_like(pts[:, 0])
    real = None
    for row, path in SEGMENTER_WEIGHTS.items():
        t0 = time.perf_counter()
        seg = Segmenter.load(str(path), cfg, device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        cpu = Segmenter.load(str(path), cfg, device="cpu")
        n_params = sum(p.numel() for p in seg.model.parameters())
        res = project_scan(pts, remissions=zeros, cfg=cfg)
        x = make_input(res.vertex_map, res.depth_map, res.remission,
                       res.vertex_valid)[None]
        got = seg.logits(x)[0]
        t0 = time.perf_counter()
        want = cpu.logits(x.cpu())[0]
        t_cpu = time.perf_counter() - t0
        valid = res.vertex_valid.cpu()
        agree = float((got.argmax(-1).cpu() == want.argmax(-1))[valid]
                      .float().mean())
        diff = float((got.cpu() - want).abs().max())
        depth = torch.linalg.vector_norm(pts, dim=-1)
        px, py = res.point_px.clamp_min(0), res.point_py.clamp_min(0)
        pv = res.point_px >= 0
        stages = {
            "projection": lambda: project_scan(pts, remissions=zeros,
                                               cfg=cfg),
            "network": lambda: seg.logits(x),
            "knn+labels": lambda: labels_for_points(got, px, py, depth, pv,
                                                    res.depth_map),
            "call": lambda: seg(pts)}
        ms = {k: _events_ms(f, 20, 3) for k, f in stages.items()}
        # the network's device time: one forward captured and replayed
        net_graph_ms = graph_ms(lambda: seg.logits(x), 50)
        # a call reads nothing back to the host: its tensors go straight on
        # to process_scan_async (bench.py:232); a read of one value shows
        # that the detector sees a sync
        if not _sync_warnings(lambda: pts[0, 0].item()):
            raise AssertionError("CUDA sync debug mode reports no sync")
        syncs = _sync_warnings(lambda: seg(pts))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        seg(pts)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        print(f"[segmenter] {row} ({path.name}: {seg.model.stage_blocks} "
              f"blocks, widths {seg.model.widths}, {n_params / 1e6:.1f} M "
              f"parameters, loaded to the card in {t_load:.1f} s) at "
              f"1x{cfg.height}x{cfg.width} (928 columns padded): card vs CPU "
              f"label agreement {agree:.5f} on {int(valid.sum())} valid "
              f"pixels (limit {NET_AGREEMENT_MIN}), max |logit difference| "
              f"{diff:.4f} (|logits| up to {float(want.abs().max()):.1f}); "
              f"CPU forward {t_cpu:.2f} s")
        print(f"[segmenter] {row} ms a call (CUDA events, back-to-back): "
              + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
              + f"; the network in a replayed graph {net_graph_ms:.3f} ms "
              f"(device time); memory held {held / 2**20:.1f} MiB, peak of a "
              f"call {peak / 2**20:.1f} MiB; host syncs in a call "
              f"{len(syncs)}")
        if syncs:
            raise AssertionError(f"{row}: a segmenter call waits for the "
                                 f"device: {syncs[:3]}")
        if not agree >= NET_AGREEMENT_MIN:
            raise AssertionError(f"{row}: card and CPU networks agree on "
                                 f"{agree} of the valid pixels")
        if real is None:
            cls = torch.softmax(got, -1).argmax(-1).to(torch.int32)
            real = (cls, res.depth_map)
        del seg, cpu
    return real


# the benchmark cells whose networks [segmenter-graph] replays, and how many
# consecutive scans of a sequence each runs: an eager call, a capture, replays
SEGMENTER_GRAPH_CELLS = ("sumapp-rangenet53-offline",
                         "sumapp-salsanext-offline",
                         "sumapp-ssgv3-53-offline")
SEGMENTER_GRAPH_SCANS = 6
# launches a replayed call of the span segmenter/network may make: the
# input's copy and the graph's launch, with room
SEGMENTER_GRAPH_MAX_LAUNCHES = 4


def _launch_calls(fn) -> float:
    """The host's calls that put work on the card in one call of ``fn``
    (``_launch_rows``: a graph's launch is one)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _launch_rows(prof, 1)[1]


def _segmenter_spans(fn) -> dict:
    """The span table of one call of ``fn`` (a segmenter call), reduced as
    the benchmark reduces its traced scans (``suma_bench.spans.reduce``):
    ``{span: {"launches", "busy_ms", "host_ms", ...}}``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from suma_bench import spans
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("traced"):
            with record_function("segmenter"):
                fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as td:
        path = f"{td}/trace.json"
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    return spans.reduce(events.get("traceEvents", events))["spans"]


def _memory() -> dict:
    return {"allocated": torch.cuda.memory_allocated(),
            "max_allocated": torch.cuda.max_memory_allocated(),
            "max_reserved": torch.cuda.max_memory_reserved()}


def phase_segmenter_graph(dev):
    """``[segmenter-graph]``: ``Segmenter.__call__``'s network as a CUDA
    graph, for the network of each of ``SEGMENTER_GRAPH_CELLS`` (darknet53,
    SalsaNext, SqueezeSegV3-53) on ``SEGMENTER_GRAPH_SCANS`` consecutive
    64x2048 scans of its cell's sequence (the benchmark's generator): the
    first call eager, the second a capture, the rest replays. Held: every
    call's logits (a forward hook on ``net``, as the benchmark's check
    reads them), labels and probabilities equal bit for bit to the eager
    path's (projection, ``Segmenter.logits``, the vote); one capture and
    the replays after it;
    no host sync in a replayed call (CUDA sync debug mode); at most
    ``SEGMENTER_GRAPH_MAX_LAUNCHES`` launches in a replayed call's
    ``segmenter/network`` span (``spans.reduce``, as ``network_launches``
    reads it). Printed: launch calls of a whole call and of the network,
    eager and replayed; the capture's host ms; ms a call eager and replayed
    (CUDA events, back-to-back calls); memory allocated, peak allocated
    and peak reserved before and after the capture."""
    from semantic_suma_tpu_torch.config import DataConfig
    from semantic_suma_tpu_torch.models.rangenet import make_input
    from semantic_suma_tpu_torch.models.segmenter import Segmenter
    from semantic_suma_tpu_torch.ops.knn import labels_for_points
    from semantic_suma_tpu_torch.ops.projection import project_scan
    from suma_bench import harness

    n = SEGMENTER_GRAPH_SCANS
    for cell in SEGMENTER_GRAPH_CELLS:
        segj = harness.cell(cell)["config"]["segmenter"]
        _, _, scans = _cell_sequence(dev, cell, 11)
        scans = scans[:n]
        cfg = DataConfig(**segj["data"])
        gc.collect()
        torch.cuda.empty_cache()
        seg = Segmenter.load(str(harness.ROOT / segj["weights"]), cfg,
                             use_knn=segj["use_knn"], device=dev)

        def net_input(pts):
            res = project_scan(pts, remissions=torch.zeros_like(pts[:, 0]),
                               cfg=cfg)
            return res, make_input(res.vertex_map, res.depth_map,
                                   res.remission, res.vertex_valid)[None]

        def eager(pts):
            res, x = net_input(pts)
            logits = seg.logits(x)[0]
            depth = torch.linalg.vector_norm(pts, dim=-1)
            return (logits, *labels_for_points(
                logits, res.point_px.clamp_min(0), res.point_py.clamp_min(0),
                depth, res.point_px >= 0, res.depth_map,
                use_knn=seg.use_knn))

        box = {}
        hook = seg.net.register_forward_hook(
            lambda m, i, out: box.__setitem__("logits",
                                              out[0].detach().clone()))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        got, mem = [], {}
        for i, s in enumerate(scans):
            if i == 1:
                torch.cuda.synchronize()
                mem["before"] = _memory()
            labels, probs = seg(s.points)
            if i == 1:
                torch.cuda.synchronize()
                mem["after"] = _memory()
            got.append((box.pop("logits"), labels.clone(), probs.clone()))
        hook.remove()
        rep = seg.replayer
        counts = dict(rep.counts["segmenter"])
        same = all(all(torch.equal(a, b) for a, b in zip(g, eager(s.points)))
                   for g, s in zip(got, scans))
        pts = scans[-1].points
        syncs = _sync_warnings(lambda: seg(pts))
        _, x = net_input(pts)
        launches = {"eager call": _launch_calls(lambda: eager(pts)),
                    "eager network": _launch_calls(lambda: seg.logits(x)),
                    "replayed call": _launch_calls(lambda: seg(pts))}
        table = _segmenter_spans(lambda: seg(pts))
        net_row = table["segmenter/network"]
        ms = {"eager": _events_ms(lambda: eager(pts), 20, 2),
              "replayed": _events_ms(lambda: seg(pts), 20, 2)}
        gib = float(1 << 30)
        print(f"[segmenter-graph] {segj['arch']} ({cell}, {n} scans at "
              f"{cfg.height}x{cfg.width}): calls {counts}, eager by reason "
              f"{dict(rep.invalidations)}; logits, labels and probabilities "
              f"{'equal bit for bit' if same else 'DIFFER'} to the eager "
              f"path's on every call; host syncs in a replayed call "
              f"{len(syncs)}; capture {rep.capture_s * 1e3:.1f} ms (host)")
        print(f"[segmenter-graph] {segj['arch']} launch calls: "
              + ", ".join(f"{k} {v:.0f}" for k, v in launches.items())
              + "; replayed spans (launches, busy ms): "
              + ", ".join(f"{k} {v['launches']:.0f} {v['busy_ms']:.3f}"
                          for k, v in sorted(table.items()))
              + f"; ms a call (CUDA events, back-to-back): eager "
              f"{ms['eager']:.3f}, replayed {ms['replayed']:.3f}")
        print(f"[segmenter-graph] {segj['arch']} memory (GiB) before the "
              f"capture / after: "
              + ", ".join(f"{k} {mem['before'][k] / gib:.4f} / "
                          f"{mem['after'][k] / gib:.4f}"
                          for k in mem["before"]))
        if not same:
            raise AssertionError(f"segmenter-graph: {cell}'s replayed "
                                 f"network differs from the eager one")
        if counts.get("capture") != 1 or counts.get("replay", 0) < n - 2:
            raise AssertionError(f"segmenter-graph: {cell}: calls {counts}")
        if syncs:
            raise AssertionError(f"segmenter-graph: {cell}: a replayed call "
                                 f"waits for the device: {syncs[:3]}")
        if not net_row["launches"] <= SEGMENTER_GRAPH_MAX_LAUNCHES:
            raise AssertionError(f"segmenter-graph: {cell}: "
                                 f"{net_row['launches']} launches in "
                                 "segmenter/network")
        del seg, hook, got


# [segmenter-epilogue]: the darknet53 cell and the SalsaNext cell, the
# epilogue calls of a darknet53 forward, and the card's bytes a second
EPILOGUE_CELL = "sumapp-rangenet53-offline"
EPILOGUE_SALSA_CELL = "sumapp-salsanext-offline"
EPILOGUE_SITES = 72
# the epilogue calls of a forward of the mid network (the phases' segmenter)
MID_SITES = 40


def _module_logits(net, x):
    """The darknet network's logits by its encoder's and decoder's module
    forwards (no epilogue call; the path of training), at a width that
    needs no wrap pad."""
    xp = x.permute(0, 3, 1, 2)
    feats, skips = net.Encoder_0(xp)
    return net.Conv_0(net.Decoder_0(feats, skips).float()).permute(0, 2, 3, 1)


def _epilogue_sites(net, x) -> list:
    """``(args, kwargs)`` of every epilogue call of one eager walk of
    ``net`` on ``x``, in order."""
    from semantic_suma_tpu_torch.models import rangenet
    sites, real = [], rangenet.bn_act

    def record(*a, **kw):
        sites.append((a, kw))
        return real(*a, **kw)

    rangenet.bn_act = record
    try:
        net(x)
    finally:
        rangenet.bn_act = real
    return sites


def _site_key(a, kw) -> tuple:
    y, r = a[0], (a[4] if len(a) > 4 else None)
    return (tuple(y.shape), r is not None, kw["f32"], kw["bf16"])


def _site_bytes(key) -> int:
    shape, has_r, f32, bf16 = key
    n = int(np.prod(shape))
    return n * (2 + 4 * has_r + 4 * f32 + 2 * bf16)


def phase_segmenter_epilogue(dev):
    """``[segmenter-epilogue]``: the batch-norm epilogue (``csrc/bn_act.cu``)
    in darknet53's walk, with ``weights/segmenter_synth_full.pkl`` at
    64x2048 on a scan of its cell. Held: each of a forward's
    ``EPILOGUE_SITES`` calls equal bit for bit to its plain version on the
    card (the ATen operations of the modules) on the call's real inputs;
    the eager walk's logits and labels equal to those of the encoder's and
    decoder's module forwards; the replayed graph's logits equal to the
    eager walk's; ``EPILOGUE_SITES`` launches a darknet53 forward, eager and
    replayed, and none a SalsaNext one. Printed: each site shape's kernel
    time in a replayed graph beside its bytes bound and the plain version's
    time, and the ``segmenter/network`` span's busy ms a call with the
    module forwards and with the walk, both replayed, on one seed. Returns
    the kernel's record of the ``kernels`` line: ``ms``, ``bound_ms`` and
    ``plain_ms`` summed over a forward's calls."""
    from semantic_suma_tpu_torch.config import DataConfig
    from semantic_suma_tpu_torch.models.rangenet import make_input
    from semantic_suma_tpu_torch.models.segmenter import Segmenter
    from semantic_suma_tpu_torch.ops import epilogue
    from semantic_suma_tpu_torch.ops.knn import labels_for_points
    from semantic_suma_tpu_torch.ops.projection import project_scan
    from suma_bench import harness

    def load(cell):
        segj = harness.cell(cell)["config"]["segmenter"]
        cfg = DataConfig(**segj["data"])
        _, _, scans = _cell_sequence(dev, cell, 7)
        seg = Segmenter.load(str(harness.ROOT / segj["weights"]), cfg,
                             use_knn=segj["use_knn"], device=dev)
        return seg, cfg, scans[:SEGMENTER_GRAPH_SCANS]

    def net_input(cfg, pts):
        res = project_scan(pts, remissions=torch.zeros_like(pts[:, 0]),
                           cfg=cfg)
        return res, make_input(res.vertex_map, res.depth_map, res.remission,
                               res.vertex_valid)[None]

    def labels(seg, res, pts, logits):
        depth = torch.linalg.vector_norm(pts, dim=-1)
        return labels_for_points(
            logits, res.point_px.clamp_min(0), res.point_py.clamp_min(0),
            depth, res.point_px >= 0, res.depth_map, use_knn=seg.use_knn)

    gc.collect()
    torch.cuda.empty_cache()
    seg, cfg, scans = load(EPILOGUE_CELL)
    net = seg.net
    pts = scans[0].points
    res, x = net_input(cfg, pts)
    fn = epilogue.bn_act
    with torch.no_grad():
        # each call against its plain version (the modules' ATen
        # operations) on the call's own inputs, element by element
        sites = _epilogue_sites(net, x)
        unequal, err = 0, 0.0
        for a, kw in sites:
            for g, w in zip(fn(*a, **kw), epilogue.bn_act_plain(*a, **kw)):
                if g is not None:
                    bits = torch.int16 if g.dtype == torch.bfloat16 \
                        else torch.int32
                    unequal += int((g.view(bits) != w.view(bits)).sum())
                    err = max(err, float((g.float() - w.float()).abs().max()))
        print(f"[segmenter-epilogue] elements unequal to the plain version "
              f"over the {len(sites)} calls of a forward: {unequal} (largest "
              f"difference {err:.3e})")
        layouts = sorted({(str(a[0].dtype), a[0].is_contiguous(
            memory_format=torch.channels_last)) for a, _ in sites})
        n0 = fn.launches
        walk = seg.logits(x)[0]
        n_eager = fn.launches - n0
        mods = _module_logits(net, x)[0]
        same = torch.equal(walk, mods)
        gap = float((walk - mods).abs().max())
        same_labels = all(torch.equal(a, b) for a, b in zip(
            labels(seg, res, pts, walk), labels(seg, res, pts, mods)))
    print(f"[segmenter-epilogue] darknet53 ({EPILOGUE_CELL}, "
          f"{cfg.height}x{cfg.width}): eager walk vs module forwards: logits "
          f"{'equal bit for bit' if same else 'DIFFER'} (largest "
          f"difference {gap:.3e}), labels and probabilities "
          f"{'equal' if same_labels else 'DIFFER'}; {n_eager} epilogue "
          f"launches a forward; convolution outputs (dtype, channels_last) "
          f"{layouts}")

    # the replayed graph against the eager walk
    box = {}
    hook = net.register_forward_hook(
        lambda m, i, out: box.__setitem__("logits", out[0].detach().clone()))
    replay_same, n_calls = True, []
    for s in scans:
        n0 = fn.launches
        seg(s.points)
        n_calls.append(fn.launches - n0)
        _, xs = net_input(cfg, s.points)
        with torch.no_grad():
            replay_same &= torch.equal(box.pop("logits"), seg.logits(xs)[0])
    hook.remove()
    counts = dict(seg.replayer.counts["segmenter"])
    print(f"[segmenter-epilogue] darknet53 through Segmenter.__call__ on "
          f"{len(scans)} scans: calls {counts}; logits "
          f"{'equal bit for bit' if replay_same else 'DIFFER'} to the eager "
          f"walk's on every call; epilogue launches a call {n_calls}")

    # each site shape: the kernel in a replayed graph, its bytes bound and
    # the plain version (ATen on the card)
    by_key: dict = {}
    for a, kw in sites:
        by_key.setdefault(_site_key(a, kw), [a, kw, 0])[2] += 1
    tot = {"kernel": 0.0, "bound": 0.0, "plain": 0.0, "bytes": 0}
    with torch.no_grad():
        for key, (a, kw, count) in by_key.items():
            k_ms = min(graph_ms(lambda: fn(*a, **kw), 50) for _ in range(2))
            p_ms = graph_ms(lambda: epilogue.bn_act_plain(*a, **kw), 20)
            nbytes = _site_bytes(key)
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            for k, v in (("kernel", k_ms), ("bound", b_ms), ("plain", p_ms),
                         ("bytes", nbytes)):
                tot[k] += v * count
            shape, has_r, f32, bf16 = key
            print(f"[segmenter-epilogue] site {list(shape)} r={int(has_r)} "
                  f"out f32={int(f32)} bf16={int(bf16)} x{count}: kernel "
                  f"{k_ms:.5f} ms, bytes bound {b_ms:.5f} ms "
                  f"({nbytes} B), plain {p_ms:.5f} ms")
    print(f"[segmenter-epilogue] a forward's {len(sites)} calls: kernel "
          f"{tot['kernel']:.4f} ms, bytes bound {tot['bound']:.4f} ms "
          f"({tot['bytes'] / 1e9:.3f} GB, "
          f"{100 * tot['bound'] / tot['kernel']:.1f}% of the roofline), "
          f"plain {tot['plain']:.4f} ms")

    # segmenter/network busy ms: the module forwards (as before the walk)
    # against the walk, each replayed, on one seed
    busy = {}
    for name in ("modules", "walk"):
        gc.collect()
        torch.cuda.empty_cache()
        s2, _, _ = load(EPILOGUE_CELL)
        if name == "modules":
            n2 = s2.net
            n2._walk = lambda xx, n2=n2: n2.Decoder_0(*n2.Encoder_0(xx))
        for s in scans[:4]:
            s2(s.points)
        table = _segmenter_spans(lambda: s2(pts))
        ms = _events_ms(lambda: s2(pts), 20, 2)
        busy[name] = (table["segmenter/network"]["busy_ms"],
                      table["segmenter/network"]["launches"], ms)
        del s2
    print("[segmenter-epilogue] segmenter/network replayed (busy ms, "
          "launches) and a whole call's ms (CUDA events, back-to-back): "
          + "; ".join(f"{k} {v[0]:.4f} ms, {v[1]:.0f}, {v[2]:.3f} ms"
                      for k, v in busy.items()))

    # SalsaNext calls no epilogue
    del seg, net, sites, by_key
    gc.collect()
    torch.cuda.empty_cache()
    salsa, scfg, sscans = load(EPILOGUE_SALSA_CELL)
    n0 = fn.launches
    for s in sscans[:3]:
        salsa(s.points)
    n_salsa = fn.launches - n0
    print(f"[segmenter-epilogue] SalsaNext ({EPILOGUE_SALSA_CELL}): "
          f"{n_salsa} epilogue launches over 3 calls")
    print(f"[segmenter-epilogue] {_smi('name,power.limit')}")
    if not (same and replay_same and same_labels):
        raise AssertionError("segmenter-epilogue: the walk's logits differ "
                             "from the module forwards'")
    if n_eager != EPILOGUE_SITES or any(n != EPILOGUE_SITES for n in n_calls):
        raise AssertionError(f"segmenter-epilogue: {n_eager}, {n_calls} "
                             f"launches, not {EPILOGUE_SITES}")
    if n_salsa:
        raise AssertionError("segmenter-epilogue: SalsaNext launched the "
                             "epilogue")
    if unequal:
        raise AssertionError(f"segmenter-epilogue: {unequal} elements "
                             "unequal to the plain version")
    return {"name": "bn_act", "route": "cuda",
            "shape": f"darknet53 {cfg.height}x{cfg.width}, "
                     f"{n_eager} calls",
            "source": "semantic_suma_tpu_torch/csrc/bn_act.cu",
            "replaces": "none (flax BatchNorm and leaky_relu, left to XLA)",
            "max_abs_err": err, "ms": tot["kernel"], "plain_ms": tot["plain"],
            "bound_ms": tot["bound"], "bound_by": "bytes",
            "library_ms": None}


# [segmenter-sac]: SqueezeSegV3-53's cell, the SAC calls of a forward, and
# shapes whose widths leave a partial tile or fit in one
SAC_CELL = "sumapp-ssgv3-53-offline"
SAC_SITES = 23
SAC_ODD_SHAPES = ((2, 16, 5, 37), (1, 24, 7, 100), (1, 256, 3, 13),
                  (1, 8, 1, 1))


def _sac_sites(net, x) -> tuple:
    """The arguments of every ``sac_attention`` and every ``sac_modulate``
    call of one eager walk of ``net`` on ``x``, in order: two lists."""
    from semantic_suma_tpu_torch.models import squeezesegv3
    names = ("sac_attention", "sac_modulate")
    reals = {k: getattr(squeezesegv3, k) for k in names}
    sites = {k: [] for k in names}

    def recorder(name):
        def record(*a):
            sites[name].append(a)
            return reals[name](*a)
        return record

    for k in names:
        setattr(squeezesegv3, k, recorder(k))
    try:
        with torch.no_grad():
            net(x)
    finally:
        for k in names:
            setattr(squeezesegv3, k, reals[k])
    return sites["sac_attention"], sites["sac_modulate"]


def _ulps(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """``(unequal elements, largest distance in bfloat16 ulps)`` of two
    bfloat16 tensors (the bit patterns as ordered integers)."""
    def ordered(t):
        b = t.contiguous().view(torch.int16).int()
        return torch.where(b < 0, -32768 - b, b)
    d = (ordered(got) - ordered(want)).abs()
    return int((d > 0).sum()), int(d.max()) if d.numel() else 0


def _sac_odd_inputs(shape, dev, seed=5):
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, c, h, w = shape
    cl = torch.channels_last
    a = (torch.randn(n, 9 * c, h, w, generator=gen, device=dev) * 3).to(
        torch.bfloat16).contiguous(memory_format=cl)
    x = torch.randn(n, c, h, w, generator=gen, device=dev).to(
        torch.bfloat16).contiguous(memory_format=cl)
    mean = torch.randn(9 * c, generator=gen, device=dev)
    mul = torch.rand(9 * c, generator=gen, device=dev) + 0.5
    bias = torch.randn(9 * c, generator=gen, device=dev) * 0.2
    return a, x, mean, mul, bias


def _attention_odd_inputs(shape, dev, seed=7):
    """Coordinates, weight and bias of a SAC block of ``C`` channels at an
    ``(N, C, H, W)`` of ``SAC_ODD_SHAPES``, in the walk's layouts."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, c, h, w = shape
    bf, cl = torch.bfloat16, torch.channels_last
    p = (torch.randn(n, 3, h, w, generator=gen, device=dev) * 10).to(
        bf).contiguous(memory_format=cl)
    weight = (torch.randn(9 * c, 3, 7, 7, generator=gen, device=dev)
              * 0.1).to(bf).contiguous(memory_format=cl)
    bias = torch.randn(9 * c, generator=gen, device=dev).to(bf)
    return p, weight, bias


def _attention_f64(p, weight, bias) -> tuple:
    """The attention's sum ``S`` in float64 on the same bfloat16 inputs, and
    its value rounded as the module does: ``bf16(float(bf16(S)) +
    float(b))``."""
    import torch.nn.functional as F
    s = F.conv2d(p.double(), weight.double(), padding=3)
    return s, (s.to(torch.bfloat16).float()
               + bias.float()[:, None, None]).to(torch.bfloat16)


def _sum_ulps(got: torch.Tensor, want: torch.Tensor,
              s: torch.Tensor) -> float:
    """The largest ``|got - want|`` in bfloat16 ulps at the larger of
    ``|s|`` and ``|want|``: the first rounding happens at the sum's scale,
    so where the bias cancels the sum one ulp of ``S`` is many ulps of the
    result, and a count of the result's own ulps measures the cancellation,
    not the sum."""
    scale = torch.maximum(s.abs(), want.double().abs()).clamp_min(1e-30)
    ulp = torch.ldexp(torch.ones_like(scale), torch.frexp(scale)[1] - 8)
    d = (got.double() - want.double()).abs() / ulp
    return float(d.max()) if d.numel() else 0.0


def attention_checks(dev, sites, tag: str) -> dict:
    """The attention kernel (``csrc/sac_attention.cu``) on the ``sites`` (the
    arguments of a forward's ``sac_attention`` calls) and on
    ``SAC_ODD_SHAPES``: against the library path (``sac_attention_plain``:
    cuDNN's convolution, then ATen's bias add) and against the float64 value
    of the same inputs (``_attention_f64``), in bfloat16 ulps of the result
    and of the sum (``_sum_ulps``); held: on every call the kernel's largest
    distance from the float64 value at most one ulp of the sum beyond the
    library path's. Then each site shape's kernel ms alone in a
    replayed graph beside its bytes and FLOPs bounds and the library path's
    ms. Returns the kernel's record (``max_abs_err``: its largest distance
    from the library path in bfloat16 ulps of the sum)."""
    from semantic_suma_tpu_torch.ops import sac
    calls = [*sites, *(_attention_odd_inputs(s, dev) for s in SAC_ODD_SHAPES)]
    unequal, total, worse = 0, 0, []
    to_lib, to_f64, lib_f64 = 0, 0, 0      # ulps of the results
    s_lib, s_f64, s_lib_f64 = 0.0, 0.0, 0.0    # ulps of the sums
    with torch.no_grad():
        for i, args in enumerate(calls):
            got = sac.sac_attention(*args)
            lib = sac.sac_attention_plain(*args)
            s64, ref = _attention_f64(*args)
            u, d = _ulps(got, lib)
            unequal, total = unequal + u, total + got.numel()
            to_lib = max(to_lib, d)
            to_f64 = max(to_f64, _ulps(got, ref)[1])
            lib_f64 = max(lib_f64, _ulps(lib, ref)[1])
            e_got, e_lib = _sum_ulps(got, ref, s64), _sum_ulps(lib, ref, s64)
            s_lib = max(s_lib, _sum_ulps(got, lib, s64))
            s_f64, s_lib_f64 = max(s_f64, e_got), max(s_lib_f64, e_lib)
            if e_got > e_lib + 1:
                worse.append((i, e_got, e_lib))
            del got, lib, s64, ref
    print(f"[segmenter-sac] {tag}: attention, {len(sites)} calls of a "
          f"forward and {len(SAC_ODD_SHAPES)} odd shapes: against the library "
          f"path (cuDNN + ATen's bias add) {unequal} of {total} elements "
          f"unequal, at most {to_lib} bfloat16 ulp of the result, "
          f"{s_lib:.3f} of the sum; from the float64 value at most {to_f64} "
          f"ulp of the result (kernel) and {lib_f64} (library), {s_f64:.3f} "
          f"and {s_lib_f64:.3f} ulp of the sum (held: the kernel's within "
          "one of the library's on every call)")
    if worse:
        raise AssertionError(f"segmenter-sac: {tag}: the attention kernel "
                             "lies more than one ulp of the sum further from "
                             "float64 than the library path (call, kernel, "
                             f"library): {worse}")
    by_shape: dict = {}
    for args in sites:
        by_shape.setdefault((tuple(args[0].shape), tuple(args[1].shape)),
                            [args, 0])[1] += 1
    tot = {"kernel": 0.0, "bound": 0.0, "library": 0.0, "bytes": 0,
           "flops": 0}
    with torch.no_grad():
        for (pshape, wshape), (args, count) in by_shape.items():
            k_ms = min(graph_ms(lambda: sac.sac_attention(*args), 50)
                       for _ in range(2))
            l_ms = graph_ms(lambda: sac.sac_attention_plain(*args), 20)
            n, _, h, w = pshape
            out = n * wshape[0] * h * w
            nbytes = 2 * (out + sum(a.numel() for a in args))
            flops = 2 * 147 * out
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            f_ms = flops / BF16_FLOP_PER_S * 1e3
            for k, v in (("kernel", k_ms), ("bound", max(b_ms, f_ms)),
                         ("library", l_ms), ("bytes", nbytes),
                         ("flops", flops)):
                tot[k] += v * count
            print(f"[segmenter-sac] {tag} attention p {list(pshape)} -> "
                  f"{wshape[0]} x{count}: kernel {k_ms:.5f} ms, bytes bound "
                  f"{b_ms:.5f} ms ({nbytes} B, {100 * b_ms / k_ms:.1f}% of "
                  f"it), FLOPs bound {f_ms:.5f} ms ({flops} FLOP, "
                  f"{flops / k_ms / 1e9:.1f} TFLOP/s), library {l_ms:.5f} ms")
    print(f"[segmenter-sac] {tag}: a forward's {len(sites)} attention calls: "
          f"kernel {tot['kernel']:.4f} ms, bound {tot['bound']:.4f} ms "
          f"(bytes, {tot['bytes'] / 1e9:.3f} GB; "
          f"{100 * tot['bound'] / tot['kernel']:.1f}% of it), "
          f"{tot['flops'] / 1e9:.2f} GFLOP, library {tot['library']:.4f} ms")
    return {"name": "sac_attention", "route": "cuda",
            "shape": f"SqueezeSegV3-53 attention, {len(sites)} calls",
            "source": "semantic_suma_tpu_torch/csrc/sac_attention.cu",
            "replaces": "none (the JAX package has no SqueezeSegV3); cuDNN's "
                        "fprop and ATen's bias add",
            "max_abs_err": s_lib, "ms": tot["kernel"],
            "plain_ms": tot["library"], "bound_ms": tot["bound"],
            "bound_by": "bytes", "library_ms": tot["library"]}


def sac_checks(dev, seg, scans, tag: str) -> tuple:
    """The SAC kernel in ``seg``'s SqueezeSegV3 walk on the first of
    ``scans`` (64x2048 projections): each call of a forward against its plain
    version on its own inputs, and on ``SAC_ODD_SHAPES``; each site shape's
    kernel ms alone in a replayed graph beside its bytes bound and the plain
    version's ms; the attention kernel likewise (``attention_checks``); the
    launches of both kernels in ``Segmenter.__call__`` on every scan (an
    eager call, a capture, replays), counted from zero as a path's. Returns
    ``(the SAC kernel's record, the attention kernel's record, the path's
    launch counts)``."""
    from semantic_suma_tpu_torch.models.rangenet import make_input
    from semantic_suma_tpu_torch.ops import sac
    from semantic_suma_tpu_torch.ops.projection import project_scan
    pts = scans[0].points
    res = project_scan(pts, remissions=torch.zeros_like(pts[:, 0]),
                       cfg=seg.cfg)
    x = make_input(res.vertex_map, res.depth_map, res.remission,
                   res.vertex_valid)[None]
    att_sites, sites = _sac_sites(seg.net, x)
    unequal, ulps, total = 0, 0, 0
    with torch.no_grad():
        for args in [*sites, *(_sac_odd_inputs(s, dev)
                               for s in SAC_ODD_SHAPES)]:
            got = sac.sac_modulate(*args)
            want = sac.sac_modulate_plain(*args)
            u, d = _ulps(got, want)
            unequal, ulps, total = unequal + u, max(ulps, d), \
                total + got.numel()
    print(f"[segmenter-sac] {tag}: {len(sites)} calls of a forward and "
          f"{len(SAC_ODD_SHAPES)} odd shapes against the plain version (the "
          f"ATen operations on the card): {unequal} of {total} elements "
          f"unequal, at most {ulps} bfloat16 ulp")
    by_shape: dict = {}
    for args in sites:
        by_shape.setdefault(tuple(args[1].shape), [args, 0])[1] += 1
    tot = {"kernel": 0.0, "bound": 0.0, "plain": 0.0, "bytes": 0}
    with torch.no_grad():
        for shape, (args, count) in by_shape.items():
            k_ms = min(graph_ms(lambda: sac.sac_modulate(*args), 50)
                       for _ in range(2))
            p_ms = graph_ms(lambda: sac.sac_modulate_plain(*args), 10)
            nbytes = 2 * (2 * args[0].numel() + args[1].numel())
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            for k, v in (("kernel", k_ms), ("bound", b_ms), ("plain", p_ms),
                         ("bytes", nbytes)):
                tot[k] += v * count
            print(f"[segmenter-sac] {tag} x {list(shape)} x{count}: kernel "
                  f"{k_ms:.5f} ms, bytes bound {b_ms:.5f} ms ({nbytes} B, "
                  f"{100 * b_ms / k_ms:.1f}% of the roofline), plain "
                  f"{p_ms:.5f} ms")
    print(f"[segmenter-sac] {tag}: a forward's {len(sites)} calls: kernel "
          f"{tot['kernel']:.4f} ms, bytes bound {tot['bound']:.4f} ms "
          f"({tot['bytes'] / 1e9:.3f} GB, "
          f"{100 * tot['bound'] / tot['kernel']:.1f}% of the roofline), "
          f"plain {tot['plain']:.4f} ms")
    rec_att = attention_checks(dev, att_sites, tag)
    _zero_launch_counts()
    per_call, att_per_call = [], []
    for s in scans:
        n0, a0 = sac.sac_modulate.launches, sac.sac_attention.launches
        seg(s.points)
        per_call.append(sac.sac_modulate.launches - n0)
        att_per_call.append(sac.sac_attention.launches - a0)
    torch.cuda.synchronize()
    counts = _read_launch_counts()
    print(f"[segmenter-sac] {tag} through Segmenter.__call__ on {len(scans)} "
          f"scans: calls {dict(seg.replayer.counts['segmenter'])}, "
          f"sac_modulate launches a call {per_call}, sac_attention's "
          f"{att_per_call}, the epilogue's {counts['bn_act']} in all")
    if ulps > 1:
        raise AssertionError(f"segmenter-sac: {tag}: {unequal} elements "
                             f"unequal to the plain version, up to {ulps} "
                             "ulp")
    if len(sites) != SAC_SITES or len(att_sites) != SAC_SITES \
            or any(n != SAC_SITES for n in per_call + att_per_call):
        raise AssertionError(f"segmenter-sac: {tag}: {len(sites)} and "
                             f"{len(att_sites)} sites, {per_call} and "
                             f"{att_per_call} launches, not {SAC_SITES}")
    rec = {"name": "sac_modulate", "route": "cuda",
           "shape": f"SqueezeSegV3-53 {seg.cfg.height}x{seg.cfg.width}, "
                    f"{len(sites)} calls",
           "source": "semantic_suma_tpu_torch/csrc/sac.cu",
           "replaces": "none (the JAX package has no SqueezeSegV3)",
           "max_abs_err": float(ulps), "ms": tot["kernel"],
           "plain_ms": tot["plain"], "bound_ms": tot["bound"],
           "bound_by": "bytes", "library_ms": None}
    return rec, rec_att, counts


def phase_segmenter_sac(dev):
    """``[segmenter-sac]``: the SAC kernel (``csrc/sac.cu``) and the
    attention kernel (``csrc/sac_attention.cu``) in SqueezeSegV3-53's walk,
    with ``weights/segmenter_ssgv3_synth.pkl`` at 64x2048 on scans of its
    cell (``sac_checks``). Held: every call of a forward and every odd shape
    within one bfloat16 ulp of the SAC kernel's plain version (the unequal
    elements counted and printed), and the attention no more than one ulp
    further from float64 than the library path; ``SAC_SITES`` launches of
    each a call, eager and replayed. Returns the two kernels' records and
    the path's launch counts."""
    from semantic_suma_tpu_torch.config import DataConfig
    from semantic_suma_tpu_torch.models.segmenter import Segmenter
    from suma_bench import harness
    segj = harness.cell(SAC_CELL)["config"]["segmenter"]
    _, _, scans = _cell_sequence(dev, SAC_CELL, 13)
    gc.collect()
    torch.cuda.empty_cache()
    seg = Segmenter.load(str(harness.ROOT / segj["weights"]),
                         DataConfig(**segj["data"]),
                         use_knn=segj["use_knn"], device=dev)
    out = sac_checks(dev, seg, scans[:SEGMENTER_GRAPH_SCANS],
                     f"SqueezeSegV3-53 ({SAC_CELL})")
    print(f"[segmenter-sac] {_smi('name,power.limit')}")
    return out


def _knn_inputs(h, w, seed, dev):
    """Random class and depth images with forced depth ties, +-inf, NaN,
    two all-invalid rows (one the top edge) and ties across the wrap
    seam."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 20, size=(h, w)).astype(np.int32)
    depth = rng.uniform(2.0, 12.0, size=(h, w)).astype(np.float32)
    depth[: h // 2] = np.round(depth[: h // 2] * 4) / 4     # forced ties
    m = rng.uniform(size=(h, w))
    depth[m < 0.05] = np.inf
    depth[(m >= 0.05) & (m < 0.08)] = np.nan
    depth[(m >= 0.08) & (m < 0.10)] = -np.inf
    depth[[0, h // 3]] = np.inf
    seam = [0, 1, w - 2, w - 1]
    depth[:, seam] = 7.0 + rng.integers(0, 3, size=(h, 4)) * 0.25
    cls[:, seam] = rng.integers(0, 3, size=(h, 4))
    return (torch.from_numpy(cls).to(dev),
            torch.from_numpy(depth.astype(np.float32)).to(dev))


def _knn_tie_runs(h, w, seed, dev):
    """Any ``[H, W]``: range steps of 0.25 m along both axes (runs of equal
    range differences, exact in float32, so that the window order decides
    which neighbours vote), a few classes, and NaN, +inf and -inf ranges."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 4, size=(h, w)).astype(np.int32)
    x, y = np.arange(w), np.arange(h)
    depth = (4.0 + 0.25 * (x[None, :] % 3) + 0.25 * (y[:, None] % 2)
             + 0.25 * rng.integers(0, 2, size=(h, w)))
    m = rng.uniform(size=(h, w))
    depth[m < 0.06] = np.nan
    depth[(m >= 0.06) & (m < 0.12)] = np.inf
    depth[(m >= 0.12) & (m < 0.15)] = -np.inf
    return (torch.from_numpy(cls).to(dev),
            torch.from_numpy(depth.astype(np.float32)).to(dev))


# [knn]: the shapes besides the path's 64x900 at which kernel C is held
KNN_SHAPES = ((32, 450), (32, 180), (16, 96), (1, 7), (7, 1))
KNN_TURNS = 5


def phase_knn(dev, floors, real):
    """Kernel C against its plain version at 64x900: two random inputs, runs
    of equal range differences with NaN and +-inf ranges, and the real
    network output of a rendered scan, on consecutive calls and after
    CUDA-graph replays; and at ``KNN_SHAPES`` (runs of equal differences,
    and random inputs where the shape holds their seam columns). The labels
    must be exactly equal. Prints the replayed-graph and eager ms beside
    the earlier kernel's, the plain version's ms and the bound."""
    from semantic_suma_tpu_torch.ops.knn import (knn_clean_image,
                                                 knn_clean_image_plain)

    h, w = real[0].shape
    inputs = [("random-1", *_knn_inputs(h, w, 1, dev)),
              ("random-2", *_knn_inputs(h, w, 2, dev)),
              ("tie-runs", *_knn_tie_runs(h, w, 3, dev)),
              ("scan", *real)]
    small = [(f"{kind}-{hh}x{ww}", *make(hh, ww, 4, dev))
             for hh, ww in KNN_SHAPES
             for kind, make in (("tie-runs", _knn_tie_runs),
                                ("random", _knn_inputs))
             if make is _knn_tie_runs or (hh >= 4 and ww >= 5)]
    checks, changed = 0, {}
    for name, cls, depth in inputs + inputs[:1] + small:
        got = knn_clean_image(cls, depth)
        want = knn_clean_image_plain(cls, depth)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"knn {name}: {int((got != want).sum())} "
                                 "labels differ from the plain version")
        changed[name] = int((want != cls).sum())
        checks += 1
    # a replayed graph on new inputs copied into its static buffers
    s_cls, s_depth = inputs[0][1].clone(), inputs[0][2].clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        s_out = knn_clean_image(s_cls, s_depth)
    for name, cls, depth in inputs[1:] + inputs[:1]:
        s_cls.copy_(cls)
        s_depth.copy_(depth)
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(s_out, knn_clean_image_plain(cls, depth)):
            raise AssertionError(f"knn {name}: wrong after a graph replay")
        checks += 1
    cls, depth = real
    eager_ms = _events_ms(lambda: knn_clean_image(cls, depth), 2000, 3)
    # the kernel on the scan and on a random input in replayed graphs, in
    # turns with the empty kernel (the launch floor at the same clocks):
    # the median of KNN_TURNS turns of 500 replays each
    rnd = inputs[0][1:]
    turns = [(graph_ms(floors["empty_launch"], 500),
              graph_ms(lambda: knn_clean_image(cls, depth), 500),
              graph_ms(lambda: knn_clean_image(*rnd), 500))
             for _ in range(KNN_TURNS)]
    floor_ms, ms, rnd_ms = (float(np.median(t)) for t in zip(*turns))
    spread = (min(t[1] for t in turns), max(t[1] for t in turns))
    plain_ms = _events_ms(lambda: knn_clean_image_plain(cls, depth), 20, 2)
    if not torch.equal(knn_clean_image(cls, depth),
                       knn_clean_image_plain(cls, depth)):
        raise AssertionError("knn: wrong after the timed calls")
    # the work: class and range read once, the label written once; and for
    # every candidate in the image's rows a subtraction, an absolute value
    # and two comparisons (finite, cutoff)
    in_rows = sum(min(h, h - dy) - max(0, -dy) for dy in range(-2, 3)) * w * 5
    nbytes = h * w * (4 + 4 + 4)
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "fp32": in_rows * 4 / FP32_FLOP_PER_S * 1e3}
    bound_ms = max(terms.values())
    print(f"[knn] kernel C: {checks} comparisons exact, at 64x900 and "
          f"{', '.join(f'{a}x{b}' for a, b in KNN_SHAPES)} (labels changed "
          f"by the vote: {changed}); kernel {ms:.5f} ms in a replayed graph "
          f"on the scan (median of {KNN_TURNS} turns, {spread[0]:.5f} to "
          f"{spread[1]:.5f}; random-1 {rnd_ms:.5f}; the empty kernel in the "
          f"same turns {floor_ms:.5f}; before the shared-memory tile "
          f"{KNN_EARLIER_MS} ms, PERF.md; eager calls {eager_ms:.5f} ms), "
          f"plain {plain_ms:.3f} ms (eager), "
          f"library none (no PyTorch call computes the vote), bound "
          f"{bound_ms:.6f} ms (bytes {terms['bytes']:.6f} for {nbytes} B, "
          f"fp32 {terms['fp32']:.6f}), launch floor "
          f"{floors['launch_floor_ms']:.5f} ms")
    return {"name": "knn_clean_image", "route": "cuda",
            "source": "semantic_suma_tpu_torch/csrc/knn.cu",
            "replaces": "semantic_suma_tpu/models/rangenet.py:208",
            "max_abs_err": 0, "ms": ms, "eager_ms": eager_ms,
            "earlier_ms": KNN_EARLIER_MS, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_ms == terms["bytes"]
            else "operations", "library_ms": None}


def phase_miou(dev):
    """Both networks' mIoU on the port's 12 held-out scans (scans 96 to 107
    of ``synthetic_dataset(cfg, 108, seed=0, movable_fraction=0.3)``, the
    split their ``.json`` names), each within 0.03 of the recorded one."""
    from semantic_suma_tpu_torch.config import DataConfig
    from semantic_suma_tpu_torch.models.labels import TRAIN_CLASSES
    from semantic_suma_tpu_torch.models.segmenter import (Segmenter,
                                                          evaluate_miou,
                                                          synthetic_dataset)
    from semantic_suma_tpu_torch.tools.make_results import (SEGMENTER_WEIGHTS,
                                                            val_miou)
    cfg = DataConfig()
    t0 = time.perf_counter()
    imgs, labs, vals = (a[96:] for a in synthetic_dataset(
        cfg, 108, seed=0, movable_fraction=0.3, device=dev))
    t_data = time.perf_counter() - t0
    bad = []
    for row, path in SEGMENTER_WEIGHTS.items():
        seg = Segmenter.load(str(path), cfg, device=dev)
        t0 = time.perf_counter()
        m, per_class = evaluate_miou(seg, imgs, labs, vals)
        ref = val_miou(row)
        print(f"[miou] {row}: {m:.4f} on {imgs.shape[0]} held-out scans "
              f"(recorded {ref}, limit +-{MIOU_TOL}); IoU by raw id "
              + ", ".join(f"{TRAIN_CLASSES[c]}: {v:.3f}"
                          for c, v in sorted(per_class.items()))
              + f"; {time.perf_counter() - t0:.2f} s, scans made in "
              f"{t_data:.2f} s")
        if not abs(m - ref) <= MIOU_TOL:
            bad.append(f"{row}: mIoU {m} against {ref}")
        del seg
    if bad:
        raise AssertionError("miou: " + "; ".join(bad))


def phase_segmenter_loop(dev):
    """``bench.py:217-242``: the mid network labels every scan and
    ``process_scan_async`` takes its tensors (no host read between them) at
    the bench configuration (2^21-row arena, 2^18-row view, two-image fresh
    region, unfiltered, loop closure off), 8 warm-up + 60 timed scans of
    the main path's world, scans/s on the host clock. Launch counters are
    zeroed just before the drive and read just after: one of kernel C and
    ``MID_SITES`` of the epilogue a scan."""
    from semantic_suma_tpu_torch.config import MapConfig, SumaConfig
    from semantic_suma_tpu_torch.core.pipeline import SurfelSLAM
    from semantic_suma_tpu_torch.io.simulation import (circular_trajectory,
                                                       default_world,
                                                       render_scan)
    from semantic_suma_tpu_torch.models.segmenter import Segmenter
    from semantic_suma_tpu_torch.tools.make_results import SEGMENTER_WEIGHTS
    from semantic_suma_tpu_torch.utils.metrics import ate_rmse

    cfg = SumaConfig(map=MapConfig(surfel_capacity=1 << 21,
                                   active_capacity=1 << 18,
                                   min_fresh_rows=2 * 64 * 900,
                                   max_poses=8192))
    n_warm, n_timed = 8, 60
    n = n_warm + n_timed
    world = default_world(seed=0, extent=45.0)
    gt = circular_trajectory(n, radius=18.0, step=1.5, device=dev)
    scans = [render_scan(world, gt[i], cfg.data) for i in range(n)]
    seg = Segmenter.load(str(SEGMENTER_WEIGHTS["segmenter"]), cfg.data,
                         device=dev)
    slam = SurfelSLAM(cfg, enable_loop_closure=False, device=dev)
    torch.cuda.synchronize()
    _zero_launch_counts()
    for i, s in enumerate(scans):
        labels, probs = seg(s.points)
        if i == n_warm:
            slam.flush()
            t0 = time.perf_counter()
        slam.process_scan_async(s.points, labels, probs, s.valid)
    slam.flush()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _read_launch_counts()
    est = slam.trajectory()
    if not np.all(np.isfinite(est)):
        raise AssertionError("segmenter loop: non-finite poses")
    ate = ate_rmse(gt.cpu().numpy().astype(np.float64), est)
    print(f"[segmenter-loop] SurfelSLAM + mid network per scan "
          f"(process_scan_async), {n} scans 64x900 ({n_warm} warm-up + "
          f"{n_timed} timed): {n_timed / dt:.2f} scans/s, "
          f"{dt / n_timed * 1e3:.2f} ms/scan (host clock); aligned ATE "
          f"{ate:.5f} m, map surfels {slam.statistics[-1]['map-count']}, "
          f"dropped creations {slam.creations_dropped}; launches: kernel C "
          f"{counts['knn_clean_image']}, the epilogue {counts['bn_act']}, "
          f"kernel B by (candidates, flags) "
          f"{sorted(counts['zbuffer_cells_by_shape'].items())}")
    proj = counts["zbuffer_cells_by_shape"].get((64 * 900, 0), 0)
    if counts["knn_clean_image"] != n or proj != 2 * n \
            or counts["bn_act"] != MID_SITES * n:
        raise AssertionError(f"segmenter loop: kernel C ran "
                             f"{counts['knn_clean_image']} times, the "
                             f"epilogue {counts['bn_act']} and the "
                             f"projection {proj} times over {n} scans")
    if slam.creations_dropped:
        raise AssertionError(f"segmenter loop: {slam.creations_dropped} "
                             "creations dropped")
    return counts


def phase_cli_kitti_segmenter(dev):
    """The KITTI file path with the network's labels: 20 exported scans of
    the segmenter's world (30% cars, 1 m steps) and ``cli run --dataset ...
    --segmenter-weights <mid> --no-gt-labels --eval``; one vote a scan, ATE
    under 0.01 m. Launch counters are zeroed just before the run and read
    just after: one of kernel C and ``MID_SITES`` of the epilogue a scan."""
    import contextlib
    import io
    import tempfile

    from semantic_suma_tpu_torch import cli
    from semantic_suma_tpu_torch.config import DataConfig
    from semantic_suma_tpu_torch.io.kitti_export import \
        export_synthetic_sequence
    from semantic_suma_tpu_torch.io.simulation import default_world
    from semantic_suma_tpu_torch.tools.make_results import (SEGMENTER_WEIGHTS,
                                                            last_json)

    n = KITTI_SEGMENTER_SCANS
    with tempfile.TemporaryDirectory() as td:
        seq = f"{td}/seq"
        export_synthetic_sequence(
            seq, n, DataConfig(),
            world=default_world(seed=0, movable_fraction=0.3), step=1.0,
            device=dev)
        argv = ["run", "--dataset", seq, "--segmenter-weights",
                str(SEGMENTER_WEIGHTS["segmenter"]), "--no-gt-labels",
                "--eval"]
        out, err = io.StringIO(), io.StringIO()
        _zero_launch_counts()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            if cli.main(argv) != 0:
                raise AssertionError("cli run --dataset --segmenter-weights "
                                     "failed")
        torch.cuda.synchronize()
        counts = _read_launch_counts()
    run = last_json(out.getvalue())
    summary = [line for line in err.getvalue().splitlines()
               if "creations dropped" in line]
    print(f"[cli-kitti-segmenter] {n} exported scans, labels from the mid "
          f"network (--no-gt-labels): {out.getvalue().splitlines()[0]}; ATE "
          f"{run['ate_rmse_m']:.6f} m, final error {run['final_error_m']:.4f}"
          f" m; {summary[0] if summary else ''}; kernel C launches "
          f"{counts['knn_clean_image']}, the epilogue's {counts['bn_act']}")
    if counts["knn_clean_image"] != n or counts["bn_act"] != MID_SITES * n:
        raise AssertionError(f"KITTI segmenter path: kernel C ran "
                             f"{counts['knn_clean_image']} times and the "
                             f"epilogue {counts['bn_act']} for {n} scans")
    if not run["ate_rmse_m"] <= KITTI_ATE_LIMIT_M:
        raise AssertionError(f"KITTI segmenter path: ATE {run['ate_rmse_m']}"
                             f" m > {KITTI_ATE_LIMIT_M} m")
    return counts


# the mid recipe of weights/segmenter_synth_mid.pkl.json, and the held-out
# mIoU it must reach on the card: 0.03 under the recorded 0.8438 (a TPU v5e
# run of the JAX package; the port's simulator draws other range noise)
MID_RECIPE = ["--synthetic", "96", "--mid", "--steps", "2000", "--batch", "8",
              "--lr", "2e-3"]
MID_MIOU_MIN = 0.8438 - MIOU_TOL
# the recipe the phase falls back to when the mid one would not fit in its
# share of the run, and the CLI's own bar for it
SMALL_RECIPE = ["--synthetic", "24", "--small", "--steps", "300"]
TRAIN_BUDGET_S = 300.0


def _train_step_ms(dev, model, batch: int, steps: int = 20):
    """(ms a step in steady state by CUDA events, peak MiB of a step, host
    syncs in a step): ``make_train_step`` on random 64x900 images."""
    from semantic_suma_tpu_torch.models.segmenter import (create_train_state,
                                                          make_train_step)
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.normal(size=(batch, 64, 900, 5)).astype(
        np.float32), device=dev)
    labels = torch.as_tensor(rng.integers(0, 20, (batch, 64, 900)).astype(
        np.int32), device=dev)
    valid = torch.as_tensor(rng.random((batch, 64, 900)) < 0.8, device=dev)
    cw = torch.ones(20, device=dev)
    schedule, state = create_train_state(model, 0, learning_rate=2e-3,
                                         total_steps=2000, device=dev)
    step = make_train_step(schedule, class_weights=cw)
    box = [state]

    def one():
        box[0], _ = step(box[0], images, labels, valid)

    ms = _events_ms(one, steps, 5)
    syncs = _sync_warnings(one)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    one()
    torch.cuda.synchronize()
    return ms, torch.cuda.max_memory_allocated() / 2**20, syncs


def phase_train(dev):
    """Segmenter training on the card through the CLI: the ms of a mid step
    (batch 8, 64x900, CUDA events) first; then ``train-segmenter`` with the
    mid recipe, or the small one if the mid one would not fit in
    ``TRAIN_BUDGET_S``, writing to a temporary path; its held-out mIoU, peak
    memory, host reads a step and wall time; and the written blob against
    the versioned mid network on one scan. Launch counters are zeroed just
    before the CLI run and read just after."""
    import contextlib
    import io
    import tempfile

    from semantic_suma_tpu_torch import cli
    from semantic_suma_tpu_torch.device import to_host
    from semantic_suma_tpu_torch.models.rangenet import mid_rangenet
    from semantic_suma_tpu_torch.models.segmenter import Segmenter
    from semantic_suma_tpu_torch.tools.make_results import (SEGMENTER_WEIGHTS,
                                                            last_json)

    ms, peak_step, syncs = _train_step_ms(dev, mid_rangenet(), 8)
    est = 2000 * ms / 1e3
    print(f"[train] mid_rangenet step, batch 8 at 64x900 (928 padded), "
          f"bf16 forward on float32 master weights: {ms:.2f} ms a step "
          f"(CUDA events, 20 steps after 5), peak {peak_step:.0f} MiB; host "
          f"syncs in a step {len(syncs)}; 2000 steps ~{est:.0f} s")
    if syncs:
        raise AssertionError(f"train: a step waits for the device: "
                             f"{syncs[:3]}")
    full = est <= TRAIN_BUDGET_S
    recipe, bar = (MID_RECIPE, MID_MIOU_MIN) if full else (SMALL_RECIPE, 0.5)
    steps = int(recipe[recipe.index("--steps") + 1])
    with tempfile.TemporaryDirectory() as td:
        out_path = f"{td}/segmenter.pkl"
        argv = ["train-segmenter", *recipe, "--out", out_path]
        out, err = io.StringIO(), io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reads = to_host.count
        _zero_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_launch_counts()
        reads = to_host.count - reads
        peak = torch.cuda.max_memory_allocated() / 2**20
        line = last_json(out.getvalue())
        logs = [x for x in err.getvalue().splitlines()
                if x.startswith(("step 0:", f"step {steps - 1}:", "val mIoU"))]
        miou = line["val_miou"]
        print(f"[train] cli {' '.join(argv[:-2])}: held-out mIoU {miou:.4f} "
              f"(limit > {bar:.4f}; recorded 0.8438, TPU v5e), exit code "
              f"{rc}; wall {wall:.1f} s (data, {steps} steps, evaluation); "
              f"peak {peak:.0f} MiB; host reads {reads} ({reads / steps:.4f} "
              f"a step); kernel B launches "
              f"{sorted(counts['zbuffer_cells_by_shape'].items())}; "
              + " | ".join(logs))
        cfg, scan = _segmenter_scan(dev)
        trained = Segmenter.load(out_path, cfg, device=dev)(scan.points)[0]
        ref = Segmenter.load(str(SEGMENTER_WEIGHTS["segmenter"]), cfg,
                             device=dev)(scan.points)[0]
        valid = scan.valid
        agree = float((trained == ref)[valid].float().mean())
        print(f"[train] the written blob, loaded by Segmenter.load, against "
              f"the versioned {SEGMENTER_WEIGHTS['segmenter'].name} on one "
              f"scan: labels agree on {agree:.4f} of {int(valid.sum())} valid "
              f"points")
    if rc != 0 or not miou > bar:
        raise AssertionError(f"train: mIoU {miou} (bar {bar}), exit {rc}")
    if not full:
        print("[train] the mid recipe did not fit: it is run once through "
              "the CLI on the card apart from this script")
    return counts


def phase_train_parity(dev):
    """One float32 training step of ``small_rangenet`` on the card against
    the same step on the CPU (TF32 off): the same converted weights, the
    same 2x64x900 batch; the largest relative difference of the loss, the
    gradients (each leaf against its largest magnitude) and the updated
    batch statistics. The gradient of ``leaky_relu`` jumps 10x at its
    kink, so an input within rounding of it on one side moves the leaves
    behind it (tests/test_torch_train.py)."""
    from semantic_suma_tpu_torch.convert import flax_variables_from_rangenet
    from semantic_suma_tpu_torch.models.rangenet import small_rangenet
    from semantic_suma_tpu_torch.models.segmenter import (create_train_state,
                                                          make_train_step)
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on")
    rng = np.random.default_rng(7)
    batch = (rng.normal(size=(2, 64, 900, 5)).astype(np.float32),
             rng.integers(0, 20, (2, 64, 900)).astype(np.int32),
             rng.random((2, 64, 900)) < 0.8)
    cw = rng.uniform(0.5, 2.0, 20).astype(np.float32)
    init = small_rangenet(dtype=torch.float32).reset_parameters(3)
    res = {}
    for d in (dev, torch.device("cpu")):
        model = small_rangenet(dtype=torch.float32)
        schedule, state = create_train_state(model, 0, learning_rate=2e-3,
                                             total_steps=100, device=d)
        state.model.load_state_dict(init.state_dict())
        step = make_train_step(schedule, torch.as_tensor(cw, device=d))
        state, m = step(state, *(torch.as_tensor(a, device=d)
                                 for a in batch))
        grads = {n: p.grad.cpu() for n, p in state.model.named_parameters()}
        stats = flax_variables_from_rangenet(
            state.model.state_dict())["batch_stats"]
        res[d.type] = (float(m["loss"]), float(m["accuracy"]), grads, stats)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    (lc, ac, gc, sc), (lp, ap, gp, sp) = res["cuda"], res["cpu"]
    g_rel = {n: rel(gc[n], gp[n]) for n in gp}
    worst = max(g_rel, key=g_rel.get)
    s_c = {k: torch.as_tensor(v) for k, v in _flat_leaves(sc).items()}
    s_p = {k: torch.as_tensor(v) for k, v in _flat_leaves(sp).items()}
    s_rel = max(rel(s_c[k], s_p[k]) for k in s_p)
    l_rel = abs(lc - lp) / abs(lp)
    print(f"[train-parity] small_rangenet float32, one step at 2x64x900, "
          f"card vs CPU: loss {lc:.6f} / {lp:.6f} (relative {l_rel:.2e}), "
          f"accuracy {ac:.5f} / {ap:.5f}; gradients: largest relative "
          f"difference {g_rel[worst]:.2e} ({worst}), median "
          f"{float(np.median(list(g_rel.values()))):.2e} over {len(g_rel)} "
          f"leaves; batch statistics: largest relative difference "
          f"{s_rel:.2e}")
    if not (l_rel <= 1e-5 and s_rel <= 1e-4 and g_rel[worst] <= 5e-2):
        raise AssertionError("train parity: the card's step is not the CPU's")


def _flat_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


CKPT_STOP, CKPT_MORE = 70, 20


def _loop_fields(lc) -> dict:
    """The loop closer's archived fields as plain values."""
    def arr(a):
        return None if a is None else np.asarray(a, np.float64).tolist()
    return {"poses": [arr(p) for p in lc.posegraph._poses],
            "edges": [(int(e[0]), int(e[1]), arr(e[2]), arr(e[3]),
                       *e[4:]) for e in lc.posegraph._edges],
            "unverified": [(c.frm, c.to, arr(c.rel_pose))
                           for c in lc.unverified],
            "verified": [(c.frm, c.to, arr(c.rel_pose)) for c in lc.verified],
            "flags": (lc.already_verified, lc.time_without_loop,
                      lc.loop_count, lc.num_loop_closures),
            "anchors": (arr(lc.pose_old), arr(lc.last_pose_old))}


def _graph_pose_diff(a, b) -> float:
    n = min(len(a.posegraph._poses), len(b.posegraph._poses))
    return max((float(np.abs(np.asarray(a.posegraph._poses[i], np.float64)
                             - np.asarray(b.posegraph._poses[i])).max())
                for i in range(n)), default=0.0)


def phase_checkpoint(dev):
    """Session checkpoints of the loop path at full width
    (``loop_config()``, 64x900, the 2^21-row arena): a run stopped after 70
    scans of the 18 m circle (past the lap, so the closer holds candidates
    and closures), saved, resumed in a fresh ``SurfelSLAM`` and continued
    for 20 scans, against the same 90 scans without a stop (both flush at
    scan 70); the largest pose difference, the loop state's equality, the
    archive's size, the save and load times. Then the same from an archive
    that the CPU wrote: the stopped archive loaded on the CPU, 2 more scans
    there, saved, and resumed on the card. Launch counters are zeroed just
    before the runs and read just after."""
    import os
    import tempfile

    from semantic_suma_tpu_torch.config import loop_config
    from semantic_suma_tpu_torch.core.pipeline import SurfelSLAM
    from semantic_suma_tpu_torch.io.simulation import (circular_trajectory,
                                                       default_world,
                                                       render_scan)
    from semantic_suma_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                          save_checkpoint)

    cfg = loop_config()
    n = CKPT_STOP + CKPT_MORE
    world = default_world(seed=0, extent=45.0)
    gt = circular_trajectory(n, radius=18.0, step=1.8, device=dev)
    scans = [render_scan(world, gt[i], cfg.data) for i in range(n)]

    def drive(slam, lo, hi):
        for s in scans[lo:hi]:
            slam.process_scan_async(s.points, s.labels, s.probs, s.valid)
        slam.flush()

    _zero_launch_counts()
    whole = SurfelSLAM(cfg, device=dev)
    whole._loop.warmup(whole)
    drive(whole, 0, CKPT_STOP)
    drive(whole, CKPT_STOP, n)
    stopped = SurfelSLAM(cfg, device=dev)
    stopped._loop.warmup(stopped)
    drive(stopped, 0, CKPT_STOP)
    fields = _loop_fields(stopped._loop)
    # the floor: the same 70 scans run twice on the card already differ
    # (float atomics sum in another order from run to run)
    floor = float(np.abs(stopped.trajectory()
                         - whole.trajectory()[:CKPT_STOP]).max())
    print(f"[checkpoint] two runs of the same {CKPT_STOP} scans on the card "
          f"differ by {floor:.3e} m at most (closures "
          f"{stopped._loop.num_loop_closures}; the run without a stop "
          f"reaches {whole._loop.num_loop_closures} after {n} scans)")
    bad = []
    with tempfile.TemporaryDirectory() as td:
        for label, compact in (("compacted", True), ("as it is", False)):
            path = f"{td}/s_{compact}.npz"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_checkpoint(stopped, path, compact_map=compact)
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            resumed = load_checkpoint(path, cfg, device=dev)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            same_at_stop = _loop_fields(resumed._loop) == fields
            drive(resumed, CKPT_STOP, n)
            diff = float(np.abs(resumed.trajectory()
                                - whole.trajectory()).max())
            equal = _loop_fields(resumed._loop) == _loop_fields(whole._loop)
            print(f"[checkpoint] card, map {label}: stopped at scan "
                  f"{CKPT_STOP} ({len(fields['verified'])} verified and "
                  f"{len(fields['unverified'])} unverified candidates, "
                  f"{fields['flags'][3]} closures, "
                  f"{len(fields['edges'])} graph edges), archive "
                  f"{os.path.getsize(path) / 2**20:.1f} MiB, save "
                  f"{t_save:.2f} s, load {t_load:.2f} s; loop state equal "
                  f"at the stop {same_at_stop}; after {CKPT_MORE} more scans: "
                  f"largest pose difference against the run without a stop "
                  f"{diff:.3e} m, loop state equal {equal} (graph poses "
                  f"within {_graph_pose_diff(resumed._loop, whole._loop):.3e}"
                  f"), closures {resumed._loop.num_loop_closures} / "
                  f"{whole._loop.num_loop_closures}")
            if not same_at_stop or not np.isfinite(diff):
                bad.append(f"{label}: loop state at the stop {same_at_stop}, "
                           f"pose difference {diff}")
            del resumed
        # an archive written on the CPU: the stopped session on the CPU, two
        # more scans there, then the card resumes it
        cpu = load_checkpoint(f"{td}/s_False.npz", cfg, device="cpu")
        t0 = time.perf_counter()
        for s in scans[CKPT_STOP:CKPT_STOP + 2]:
            cpu.process_scan(s.points.cpu(), s.labels.cpu(), s.probs.cpu(),
                             s.valid.cpu())
        t_cpu = time.perf_counter() - t0
        cpu_path = f"{td}/cpu.npz"
        save_checkpoint(cpu, cpu_path, compact_map=False)
        resumed = load_checkpoint(cpu_path, cfg, device=dev)
        same = _loop_fields(resumed._loop) == _loop_fields(cpu._loop)
        drive(resumed, CKPT_STOP + 2, n)
        diff = float(np.abs(resumed.trajectory() - whole.trajectory()).max())
        print(f"[checkpoint] an archive the CPU wrote (2 scans on the CPU in "
              f"{t_cpu:.1f} s after loading the stop): loop state equal on "
              f"load {same}; after {CKPT_MORE - 2} more scans on the card: "
              f"largest pose difference against the run without a stop "
              f"{diff:.3e} m, closures {resumed._loop.num_loop_closures} / "
              f"{whole._loop.num_loop_closures}")
        if not same or not np.isfinite(diff):
            bad.append(f"CPU archive: loop state {same}, difference {diff}")
    torch.cuda.synchronize()
    counts = _read_launch_counts()
    if bad:
        raise AssertionError("checkpoint: " + "; ".join(bad))
    return counts


# the files the JAX CLI writes (semantic_suma_tpu/cli.py:309-341, 353-361)
JAX_RUN_PLOTS = ["errors.png", "model_depth.png", "model_normals.png",
                 "model_semantics.png", "stats.png", "traj.png"]
JAX_EVAL_PLOTS = ["errors.png", "traj.png"]


def phase_cli_plots(dev):
    """``cli run --synthetic 20 --plot-dir D --save-viewer V.html
    --save-checkpoint C.npz --eval --eval-breakdown --export-poses E`` and
    ``cli eval --plot-dir`` of the exported poses on the card: every file
    the JAX CLI writes exists under its name and is not empty. Launch
    counters are zeroed just before the run and read just after."""
    import contextlib
    import io
    import os
    import tempfile

    from semantic_suma_tpu_torch import cli
    from semantic_suma_tpu_torch.io.kitti import save_poses
    from semantic_suma_tpu_torch.io.simulation import circular_trajectory

    with tempfile.TemporaryDirectory() as td:
        run_argv = ["run", "--synthetic", "20", "--plot-dir", f"{td}/run",
                    "--save-viewer", f"{td}/map.html", "--save-checkpoint",
                    f"{td}/session.npz", "--eval", "--eval-breakdown",
                    "--export-poses", f"{td}/est.txt"]
        gt = f"{td}/gt.txt"
        save_poses(gt, circular_trajectory(20, 18.0, step=1.0).numpy())
        eval_argv = ["eval", "--gt", gt, "--est", f"{td}/est.txt",
                     "--eval-breakdown", "--plot-dir", f"{td}/eval"]
        out, err = io.StringIO(), io.StringIO()
        _zero_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc_run = cli.main(run_argv)
            torch.cuda.synchronize()
            counts = _read_launch_counts()
            rc_eval = cli.main(eval_argv)
        wall = time.perf_counter() - t0
        got = {"run": sorted(os.listdir(f"{td}/run")),
               "eval": sorted(os.listdir(f"{td}/eval"))}
        sizes = {f"{k}/{f}": os.path.getsize(f"{td}/{k}/{f}")
                 for k, names in got.items() for f in names}
        for f in ("map.html", "session.npz"):
            sizes[f] = os.path.getsize(f"{td}/{f}") \
                if os.path.exists(f"{td}/{f}") else 0
    print(f"[cli-plots] cli {' '.join(run_argv[:2])} ... and cli eval "
          f"--plot-dir on the card in {wall:.1f} s (exit codes {rc_run}, "
          f"{rc_eval}): run wrote {got['run']}, eval wrote {got['eval']}; "
          f"bytes {sizes}; kernel B launches "
          f"{sorted(counts['zbuffer_cells_by_shape'].items())}")
    bad = [k for k, v in sizes.items() if v <= 0]
    if rc_run or rc_eval or got["run"] != JAX_RUN_PLOTS \
            or got["eval"] != JAX_EVAL_PLOTS or bad:
        raise AssertionError(f"cli plots: {got}, empty or missing {bad}")
    return counts


# ---------------------------------------------------------------------------
# the readers and the sharded pipeline
# ---------------------------------------------------------------------------

READER_SCANS = 20


def phase_readers(dev, seq):
    """``[readers]``: the native prefetching loader on the 40 files that
    ``[cli-kitti]`` exported (its arrays equal numpy's exactly; ms a scan
    both ways), then the same scans written as RobotCar files (float64
    x, -y, -z) and read back through ``RobocarReader`` (the KITTI points
    exactly), and 20 of them through ``SurfelSLAM`` on the card at the CLI's
    sizing, loops off: the aligned ATE under the KITTI path's 0.01 m. Launch
    counters are zeroed just before the drive and read just after."""
    import os

    from semantic_suma_tpu_torch.core.pipeline import SurfelSLAM
    from semantic_suma_tpu_torch.io import native_io
    from semantic_suma_tpu_torch.io.kitti import KITTIReader, read_bin
    from semantic_suma_tpu_torch.io.robocar import RobocarReader
    from semantic_suma_tpu_torch.utils import metrics

    kitti = KITTIReader(seq, prefetch=False)
    files = kitti.files
    t0 = time.perf_counter()
    loader = native_io.NativeScanLoader(files)
    nat = [loader.read(i) for i in range(len(files))]
    t_nat = (time.perf_counter() - t0) / len(files) * 1e3
    loader.close()
    t0 = time.perf_counter()
    ref = [read_bin(f) for f in files]
    t_np = (time.perf_counter() - t0) / len(files) * 1e3
    exact = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                for a, b in zip(nat, ref))
    print(f"[readers] native loader on {len(files)} KITTI files: arrays "
          f"{'equal' if exact else 'NOT equal'} to numpy's exactly; "
          f"{t_nat:.3f} ms a scan (prefetching, in order, with the "
          f"loader's start), numpy {t_np:.3f} ms a scan (host clock)")
    if not exact:
        raise AssertionError("the native loader differs from numpy")
    rc_dir = os.path.join(seq, "robocar")
    os.makedirs(rc_dir)
    flip = np.array([1.0, -1.0, -1.0])
    for i, (pts, _) in enumerate(ref):
        (pts.astype(np.float64) * flip).tofile(f"{rc_dir}/{i:06d}.bin")
    robocar = RobocarReader(rc_dir)
    if robocar.count() != len(files) or not all(
            np.array_equal(robocar.read(i).points, ref[i][0])
            for i in range(len(files))):
        raise AssertionError("RobotCar files do not read back the points")
    cfg = _cli_cfg(loops=False)
    slam = SurfelSLAM(cfg, device=dev)
    _zero_launch_counts()
    t0 = time.perf_counter()
    for i in range(READER_SCANS):
        s = robocar.read(i)
        slam.process_scan_async(s.points, s.labels, s.probs)
    slam.finalize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_launch_counts()
    res = metrics.evaluate(kitti.gt_poses()[:READER_SCANS],
                           slam.trajectory())
    print(f"[readers] RobotCar: {robocar.count()} files read back exactly; "
          f"{READER_SCANS} scans through SurfelSLAM on the card in "
          f"{wall:.1f} s: aligned ATE {res['ate_rmse_m']:.6f} m (limit "
          f"{KITTI_ATE_LIMIT_M}), creations dropped {slam.creations_dropped}")
    if not res["ate_rmse_m"] <= KITTI_ATE_LIMIT_M or slam.creations_dropped:
        raise AssertionError(f"RobotCar path: ATE {res['ate_rmse_m']} m, "
                             f"{slam.creations_dropped} dropped")
    return counts


def _cli_cfg(loops: bool, xml=None):
    """The CLI's configuration (64x900, 2^21-row arena, 2^18-row view)."""
    import argparse

    from semantic_suma_tpu_torch import cli
    return cli.build_config(argparse.Namespace(
        config=xml, max_scans=None, approach=None, no_semantics=False,
        no_loop_closure=not loops, surfel_capacity=1 << 21,
        active_capacity=1 << 18))


def _cli(argv):
    """``cli.main(argv)`` in this process: (stdout, stderr, wall s); raises
    on a non-zero exit."""
    import contextlib
    import io

    from semantic_suma_tpu_torch import cli
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)} returned {rc}:\n"
                             f"{err.getvalue()[-3000:]}")
    return out.getvalue(), err.getvalue(), time.perf_counter() - t0


def _sum_launches(ranks) -> dict:
    """The ranks' launch counts summed, in ``_read_launch_counts``' form."""
    singles = ("bilateral_filter", "zbuffer_cells", "knn_clean_image",
               "bn_act", "sac_attention", "sac_modulate", "icp_products",
               "gn_update", "gn_loop",
               "evaluate_calls", "build_rows_on_cuda")
    out = {k: 0 for k in singles}
    out["zbuffer_cells_by_shape"] = {}
    for r in ranks:
        c = r["launches"]
        for k in singles:
            out[k] += c[k]
        for shape, n in c["zbuffer_cells_by_shape"].items():
            by = out["zbuffer_cells_by_shape"]
            by[shape] = by.get(shape, 0) + n
    return out


def _rank_lines(tag, ranks, scans):
    """Each rank's peak memory, kernel B launches and collectives a scan."""
    for r in ranks:
        col = r["collectives"]["timed"]
        per = ", ".join(
            f"{k} {v['calls'] / scans:.1f} a scan ({v['ms'] / scans:.3f} ms "
            f"a scan, {v['ms'] / max(v['calls'], 1):.4f} ms a call)"
            for k, v in col.items() if v["calls"])
        print(f"[{tag}] rank {r['rank']}: peak memory {r['peak_mib']:.0f} "
              f"MiB; kernel B launches "
              f"{sorted(r['launches']['zbuffer_cells_by_shape'].items())}; "
              f"collectives (CUDA events) {per}")


def _loop_line(err: str) -> str:
    for line in err.splitlines():
        if line.startswith("loop closures "):
            return line
    return "no loop line"


def _closures(stats_path) -> int:
    with open(stats_path) as f:
        scans = [json.loads(line) for line in f if line.strip()]
    return max((e.get("loop-closures", 0) for e in scans
                if e.get("event") == "scan"), default=0)


def phase_sharded(dev, td):
    """``[sharded]``: ``cli run --sharded 2`` on the loop ledger row (the
    world of ``configs/synthetic_loop.xml``, 140 scans at 1 m, 64x900, a
    2^21-row arena split over the ranks, spill on), two ranks on the one
    card over gloo; then the same run on one device (``tools/
    make_results.py``'s loop row) in this phase. Asserts a closure, no
    dropped creation and the loop row's ATE limit. Returns the ranks'
    summed launches, the single-device run's launches and the sharded
    poses."""
    from semantic_suma_tpu_torch import cli
    from semantic_suma_tpu_torch.tools import make_results as mr

    stats = f"{td}/sharded.jsonl"
    argv = mr.row_args("loop", stats_json=stats) + ["--sharded", "2"]
    out, err, wall = _cli(argv)
    ranks = cli.last_ranks
    row = mr.parse_run(out, err)
    closures = _closures(stats)
    counts = _sum_launches(ranks)
    print(f"[sharded] cli {' '.join(argv)}: {ranks[0]['backend']}, 2 ranks "
          f"on one card; {row['scans_per_sec']:.2f} scans/s, steady-state "
          f"{row['steady_scans_per_sec']} scans/s (host clock; the call "
          f"{wall:.1f} s with the ranks' start); ATE {row['ate_rmse_m']:.5f} "
          f"m, t_rel {row['t_rel_percent']:.4f} %, final error "
          f"{row['final_error_m']:.4f} m; closures {closures}; "
          f"{_loop_line(err)}; creations dropped {row['creations_dropped']}")
    _rank_lines("sharded", ranks, row["scans"])
    print(f"[sharded] {_d_and_e_a_trip('sharded', counts)}")
    _zero_launch_counts()
    single = mr.run_row("loop")
    torch.cuda.synchronize()
    single_counts = _read_launch_counts()
    print(f"[sharded] one device: "
          f"{_one_f_a_call('sharded one device', single_counts)}")
    print(f"[sharded] the same run on one device: "
          f"{single['scans_per_sec']:.2f} scans/s, steady-state "
          f"{single['steady_scans_per_sec']} scans/s; ATE "
          f"{single['ate_rmse_m']:.5f} m, t_rel "
          f"{single['t_rel_percent']:.4f} %; closures "
          f"{single['loop_closures']}; creations dropped "
          f"{single['creations_dropped']}")
    limit = LEDGER_LIMITS["loop"][0]
    if closures < 1 or row["creations_dropped"] \
            or not row["ate_rmse_m"] <= limit:
        raise AssertionError(f"sharded loop run: {closures} closures, "
                             f"{row['creations_dropped']} dropped, ATE "
                             f"{row['ate_rmse_m']} m (limit {limit})")
    return counts, single_counts, np.asarray(ranks[0]["poses"])


# [sharded-syncs]: the scans stepped before counting, and those counted
SYNC_SCANS = (4, 8)


def _count_syncs(slam, n_warm: int, n_counted: int) -> dict:
    """``process_scan`` over ``[main]``'s first scans (``odometry_config()``,
    the world and circle of phase 5) on ``slam``; each counted step's
    synchronizing CUDA operations (sync debug mode over the whole step, as
    ``_SyncTally``), its ``to_host`` reads and its Gauss-Newton iterations
    (fetched statistics), a scan."""
    from semantic_suma_tpu_torch.device import to_host
    from semantic_suma_tpu_torch.io.simulation import (circular_trajectory,
                                                       default_world,
                                                       render_scan)
    n = n_warm + n_counted
    world = default_world(seed=0, extent=45.0)
    gt = circular_trajectory(n, radius=18.0, step=1.5, device=slam.device)
    scans = [render_scan(world, gt[i], slam.cfg.data) for i in range(n)]
    out = {"syncs": 0, "reads": 0, "iterations": 0}
    for i, sc in enumerate(scans):
        def step(sc=sc):
            slam.process_scan(sc.points, sc.labels, sc.probs, sc.valid)
        if i < n_warm:
            step()
            continue
        reads0 = to_host.count
        out["syncs"] += len(_sync_warnings(step))
        out["reads"] += to_host.count - reads0
        out["iterations"] += slam.statistics[-1]["icp-iterations"]
    return {k: v / n_counted for k, v in out.items()}


def _sharded_sync_rank(rank, device, n_warm, n_counted):
    """One rank of ``[sharded-syncs]``: ``_count_syncs`` of a
    ``ShardedSurfelSLAM`` on ``[main]``'s cell (loop closure off), and the
    rank's launches."""
    from semantic_suma_tpu_torch.cli import _launch_counts
    from semantic_suma_tpu_torch.config import odometry_config
    from semantic_suma_tpu_torch.parallel import sharding as sh
    slam = sh.ShardedSurfelSLAM(odometry_config(),
                                sh.make_mesh(device=device),
                                enable_loop_closure=False)
    return {**_count_syncs(slam, n_warm, n_counted),
            "launches": _launch_counts()}


def phase_sharded_syncs(dev):
    """``[sharded-syncs]``: a sharded scan's synchronizations and host reads
    (two ranks on the one card over gloo, ``[main]``'s cell and scans)
    beside the one-device run's (``SurfelSLAM`` on the same scans). The
    sharded step reads ``done`` once a Gauss-Newton iteration and its
    branch flags once; gloo's all-reduces of CUDA tensors stage through the
    host. Asserts that the ranks ran their Gauss-Newton on kernels D and
    E."""
    from semantic_suma_tpu_torch.config import odometry_config
    from semantic_suma_tpu_torch.core.pipeline import SurfelSLAM
    from semantic_suma_tpu_torch.parallel.distributed import launch
    ranks = launch(_sharded_sync_rank, 2, SYNC_SCANS, timeout_s=300,
                   join_timeout_s=600)
    one = _count_syncs(SurfelSLAM(odometry_config(), device=dev), *SYNC_SCANS)
    print(f"[sharded-syncs] [main]'s cell, {SYNC_SCANS[1]} scans counted "
          f"after {SYNC_SCANS[0]}, a scan: two ranks on one card over gloo "
          + "; ".join(f"rank {r}: synchronizing operations (CUDA sync debug "
                      f"mode, the whole step) {x['syncs']:.3f}, to_host "
                      f"reads {x['reads']:.3f}, Gauss-Newton iterations "
                      f"{x['iterations']:.2f}" for r, x in enumerate(ranks))
          + f"; one device (SurfelSLAM): {one['syncs']:.3f}, "
          f"{one['reads']:.3f}, {one['iterations']:.2f}")
    print(f"[sharded-syncs] "
          f"{_d_and_e_a_trip('sharded-syncs', _sum_launches(ranks))}")


NCCL_SCANS = 20


def phase_sharded_nccl(dev):
    """``[sharded-nccl]``: ``cli run --sharded 1``, where the backend rule
    gives nccl (the production backend: a card a rank), and the same run
    over gloo, 20 scans each: the poses equal exactly. Returns the nccl
    run's launches."""
    import contextlib
    import io

    from semantic_suma_tpu_torch import cli
    argv = ["run", "--synthetic", str(NCCL_SCANS), "--sharded", "1"]
    poses, counts, walls = {}, {}, {}
    for b in ("nccl", "gloo"):
        if b == "nccl":
            _, _, walls[b] = _cli(argv)
        else:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(io.StringIO()):
                rc = cli._run_sharded(cli.parse_args(argv), dev, backend=b)
            walls[b] = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"--sharded 1 over {b} returned {rc}")
        ranks = cli.last_ranks
        if ranks[0]["backend"] != b:
            raise AssertionError(f"expected {b}, ran {ranks[0]['backend']}")
        poses[b] = np.asarray(ranks[0]["poses"])
        counts[b] = _sum_launches(ranks)
    for b in ("nccl", "gloo"):
        print(f"[sharded-nccl] {b}: {_d_and_e_a_trip(b, counts[b])}")
    same = np.array_equal(poses["nccl"], poses["gloo"])
    print(f"[sharded-nccl] one rank over nccl (the backend rule's choice) "
          f"and over gloo, {NCCL_SCANS} "
          f"scans each ({walls['nccl']:.1f} s and {walls['gloo']:.1f} s with "
          f"the rank's start): poses "
          f"{'exactly equal' if same else 'DIFFER'} (largest difference "
          f"{float(np.abs(poses['nccl'] - poses['gloo']).max()):.3e})")
    if not same:
        raise AssertionError("nccl and gloo runs differ")
    return counts["nccl"]


CHECKPOINT_STOP = 70


def phase_sharded_checkpoint(dev, td, full):
    """``[sharded-checkpoint]``: the ``[sharded]`` run stopped after scan 70
    and saved, then resumed in fresh ranks to scan 140, beside ``[sharded]``
    (the same run without a stop): the largest position difference of the
    resumed scans, beside the floor (the stopped run's 70 scans against the
    same scans of ``[sharded]``: two card runs of the same scans), held
    within ``max(3 * floor, 1 mm)``; the archive's size and the save and
    load times. Returns the launches of
    both runs."""
    import os
    import re

    from semantic_suma_tpu_torch import cli
    from semantic_suma_tpu_torch.tools import make_results as mr
    ck = f"{td}/sharded_session.npz"
    argv = mr.row_args("loop") + ["--sharded", "2"]
    _, err1, w1 = _cli(argv + ["--max-scans", str(CHECKPOINT_STOP),
                               "--save-checkpoint", ck])
    stop = np.asarray(cli.last_ranks[0]["poses"])
    counts = _sum_launches(cli.last_ranks)
    _, err2, w2 = _cli(argv + ["--resume", ck])
    resumed = np.asarray(cli.last_ranks[0]["poses"])
    more = _sum_launches(cli.last_ranks)
    counts["zbuffer_cells"] += more["zbuffer_cells"]
    for k in ("bilateral_filter", "knn_clean_image", "icp_products",
              "gn_update", "gn_loop", "evaluate_calls", "build_rows_on_cuda"):
        counts[k] += more[k]
    for shape, n in more["zbuffer_cells_by_shape"].items():
        by = counts["zbuffer_cells_by_shape"]
        by[shape] = by.get(shape, 0) + n
    print(f"[sharded-checkpoint] both runs: "
          f"{_d_and_e_a_trip('sharded-checkpoint', counts)}")
    save_s = float(re.search(r"checkpoint saved in ([\d.]+) s", err1)[1])
    load_s = float(re.search(r"checkpoint loaded in ([\d.]+) s", err2)[1])
    n = CHECKPOINT_STOP
    floor = float(np.linalg.norm(stop[:n, :3, 3] - full[:n, :3, 3],
                                 axis=-1).max())
    diff = float(np.linalg.norm(resumed[n:, :3, 3] - full[n:, :3, 3],
                                axis=-1).max())
    # the resumed scans may drift from the run without a stop by a few times
    # what two runs of the same scans differ by, never less than 1 mm
    limit = max(3.0 * floor, 1e-3)
    print(f"[sharded-checkpoint] stopped at scan {n}, saved in {save_s:.3f} "
          f"s ({os.path.getsize(ck)} bytes), loaded in {load_s:.3f} s, "
          f"resumed to {len(resumed)} scans (calls {w1:.1f} s and {w2:.1f} "
          f"s with the ranks' start): largest position difference of the "
          f"resumed scans to the run without a stop {diff:.3e} m; floor (two "
          f"card runs of the same {n} scans) {floor:.3e} m; limit "
          f"{limit:.3e} m")
    if len(resumed) != len(full) or not np.isfinite(resumed).all():
        raise AssertionError("resumed sharded run: wrong or non-finite poses")
    if not diff <= limit:
        raise AssertionError(f"resumed sharded run {diff:.3e} m off the run "
                             f"without a stop (limit {limit:.3e} m)")
    return counts


def _train_batch(seed=11, b=8, h=64, w=900):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, w, 5)).astype(np.float32),
            rng.integers(0, 20, (b, h, w)).astype(np.int32),
            rng.random((b, h, w)) < 0.8,
            rng.uniform(0.5, 2.0, 20).astype(np.float32))


def _step_ms(step, state, batch, n=3):
    """ms a step over ``n`` steps (CUDA events), the state moving on."""
    a, b = torch.cuda.Event(True), torch.cuda.Event(True)
    a.record()
    for _ in range(n):
        state, _ = step(state, *batch)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _sharded_train_rank(rank, device, path):
    """One rank of ``[sharded-train]``: the data-parallel step of the f32
    mid network on this rank's 4 of the 8 images, then its ms a step."""
    from semantic_suma_tpu_torch.convert import flax_variables_from_rangenet
    from semantic_suma_tpu_torch.models.rangenet import mid_rangenet
    from semantic_suma_tpu_torch.models.segmenter import create_train_state
    from semantic_suma_tpu_torch.parallel import sharding as sh
    z = np.load(path)
    mesh = sh.make_mesh(axis="data", device=device)
    part = slice(4 * rank, 4 * rank + 4)
    schedule, state = create_train_state(mid_rangenet(dtype=torch.float32),
                                         0, device=device)
    state = sh.shard_train_state(state, mesh)
    step = sh.make_sharded_train_step(
        schedule, mesh, torch.as_tensor(z["cw"], device=device))
    batch = [torch.as_tensor(z[k][part], device=device)
             for k in ("images", "labels", "valid")]
    state, m = step(state, *batch)
    out = {"loss": float(m["loss"]),
           "grads": {n: p.grad.cpu() for n, p in
                     state.model.named_parameters()},
           "stats": _flat_leaves(flax_variables_from_rangenet(
               state.model.state_dict())["batch_stats"])}
    out["ms"] = _step_ms(step, state, batch)
    return out


def _one_device_step(dev, images, labels, valid, cw):
    """One step of the float32 mid network from seed 0's weights on the
    whole batch on one device: the loss, the gradients, the batch statistics
    and the updated weights, then its ms a step."""
    from semantic_suma_tpu_torch.convert import flax_variables_from_rangenet
    from semantic_suma_tpu_torch.models.rangenet import mid_rangenet
    from semantic_suma_tpu_torch.models.segmenter import (create_train_state,
                                                          make_train_step)
    schedule, state = create_train_state(mid_rangenet(dtype=torch.float32),
                                         0, device=dev)
    step = make_train_step(schedule, torch.as_tensor(cw, device=dev))
    batch = [torch.as_tensor(a, device=dev) for a in (images, labels, valid)]
    state, m = step(state, *batch)
    out = {"loss": float(m["loss"]),
           "grads": {n: p.grad.cpu() for n, p in
                     state.model.named_parameters()},
           "params": {n: p.detach().cpu() for n, p in
                      state.model.named_parameters()},
           "stats": _flat_leaves(flax_variables_from_rangenet(
               state.model.state_dict())["batch_stats"])}
    out["ms"] = _step_ms(step, state, batch)
    del state, step, batch
    torch.cuda.empty_cache()
    return out


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _train_worst(ranks, one) -> dict:
    """The largest relative differences of the ranks' loss, batch
    statistics and gradient leaves from the one-device step's."""
    worst = {"loss": 0.0, "stats": 0.0, "grads": 0.0}
    for r in ranks:
        worst["loss"] = max(worst["loss"],
                            abs(r["loss"] - one["loss"]) / abs(one["loss"]))
        worst["stats"] = max(worst["stats"], max(
            _rel(r["stats"][k], one["stats"][k]) for k in one["stats"]))
        worst["grads"] = max(worst["grads"], max(
            _rel(r["grads"][k], one["grads"][k]) for k in one["grads"]))
    return worst


def phase_sharded_train(dev, td):
    """``[sharded-train]``: one data-parallel step of the float32 mid
    network at 64x900, batch 8 as 2 ranks of 4 on the one card, against
    one single-device step on the same 8 images from the same weights:
    ``[train-parity]``'s limits on the loss, the batch statistics and every
    gradient leaf; the ms a step of each (CUDA events)."""
    from semantic_suma_tpu_torch.parallel.distributed import launch
    images, labels, valid, cw = _train_batch()
    path = f"{td}/train_batch.npz"
    np.savez(path, images=images, labels=labels, valid=valid, cw=cw)
    one = _one_device_step(dev, images, labels, valid, cw)
    ranks = launch(_sharded_train_rank, 2, (path,), timeout_s=600,
                   join_timeout_s=900)
    worst = _train_worst(ranks, one)
    print(f"[sharded-train] mid_rangenet float32 at 8x64x900: 2 ranks of 4 "
          f"vs one device of 8, loss {ranks[0]['loss']:.6f} / "
          f"{one['loss']:.6f} (relative {worst['loss']:.2e}, limit 1e-5), "
          f"batch statistics {worst['stats']:.2e} (limit 1e-4), gradients "
          f"{worst['grads']:.2e} of their scale (limit 5e-2) over "
          f"{len(one['grads'])} leaves; ms a step: data-parallel "
          f"{ranks[0]['ms']:.2f} / {ranks[1]['ms']:.2f} (2 ranks sharing the "
          f"card, gloo), one device {one['ms']:.2f}")
    if not (worst["loss"] <= 1e-5 and worst["stats"] <= 1e-4
            and worst["grads"] <= 5e-2):
        raise AssertionError(f"sharded train step: {worst}")
    return path, one


def _sharded_train_2d_rank(rank, device, path):
    """One rank of ``[sharded-train-2d]`` on the 2 x 2 ``("data",
    "model")`` mesh: the step of the f32 mid network on its data row's 4 of
    the 8 images with the widest kernels split over ``model``, gathered back
    (``unshard_train_state``): loss, gradients, batch statistics, updated
    weights; its bytes of parameters and moments beside the replicated
    layout's, and its collectives in the step (CUDA events). Then the ms a
    step of a fresh state and the rank's peak memory."""
    from semantic_suma_tpu_torch.convert import flax_variables_from_rangenet
    from semantic_suma_tpu_torch.models.rangenet import mid_rangenet
    from semantic_suma_tpu_torch.models.segmenter import create_train_state
    from semantic_suma_tpu_torch.parallel import sharding as sh
    z = np.load(path)
    mesh = sh.make_2d_mesh(2, 2, device=device)
    data, model = mesh.axes["data"], mesh.axes["model"]
    part = slice(4 * data.rank, 4 * data.rank + 4)
    batch = [torch.as_tensor(z[k][part], device=device)
             for k in ("images", "labels", "valid")]
    cw = torch.as_tensor(z["cw"], device=device)

    def fresh():
        schedule, state = create_train_state(
            mid_rangenet(dtype=torch.float32), 0, device=device)
        return (sh.shard_train_state(state, mesh),
                sh.make_sharded_train_step(schedule, mesh, cw))

    torch.cuda.reset_peak_memory_stats(device)
    replicated = 4 * sum(p.numel() for p in mid_rangenet().parameters())
    state, step = fresh()
    for g in (data, model):
        g.counts = dict.fromkeys(g.counts, 0)
        g.timing = True
    state, m = step(state, *batch)
    out = {"place": (data.rank, model.rank), "loss": float(m["loss"]),
           "collectives": {"data": data.summary(), "model": model.summary()},
           "split": len(sh.model_axis_layers(mid_rangenet())),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in state.model.parameters()),
           "moment_bytes": sum(t.numel() * t.element_size()
                               for st in state.optimizer.state.values()
                               for k, t in st.items()
                               if k in ("exp_avg", "exp_avg_sq")),
           "replicated_bytes": replicated}
    for g in (data, model):
        g.timing = False
    state = sh.unshard_train_state(state, mesh)
    out.update(grads={n: p.grad.cpu() for n, p in
                      state.model.named_parameters()},
               params={n: p.detach().cpu() for n, p in
                       state.model.named_parameters()},
               stats=_flat_leaves(flax_variables_from_rangenet(
                   state.model.state_dict())["batch_stats"]))
    del state, step
    state, step = fresh()
    out["ms"] = _step_ms(step, state, batch)
    out["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
    return out


def phase_sharded_train_2d(dev, path, one):
    """``[sharded-train-2d]``: the ``[sharded-train]`` batch (8 images at
    64x900, f32 mid network, seed 0's weights) on 4 ranks as a 2 x 2 grid
    (``make_2d_mesh(2, 2)``: each data row 4 images, the kernels of >= 128
    output channels split over the model axis) over gloo on the one card,
    against the one-device step of the 8 images: ``[train-parity]``'s
    limits on the loss, the batch statistics and every gathered gradient
    leaf; the updated weights differ by no more than the two steps'
    gradients give (AdamW's first step moves a weight by lr * g / (|g| +
    eps)), within 4 float32 ulps of the weight + 1e-8. Prints ms a step,
    each rank's peak memory, bytes of parameters and moments beside the
    replicated layout's, and the collectives of a step with their ms."""
    from semantic_suma_tpu_torch.parallel.distributed import launch
    ranks = launch(_sharded_train_2d_rank, 4, (path,), timeout_s=600,
                   join_timeout_s=900)
    worst = _train_worst(ranks, one)
    lr, eps = 1e-3, 1e-8   # create_train_state's defaults

    def update(g):  # AdamW's first step, per unit of learning rate
        g = g.double()
        return g / (g.abs() + eps)

    update_err = 0.0
    for r in ranks:
        for k, want in one["params"].items():
            d = r["params"][k].double() - want.double()
            explained = -lr * (update(r["grads"][k])
                               - update(one["grads"][k]))
            ulps = torch.as_tensor(np.spacing(want.abs().numpy()))
            update_err = max(update_err, float(
                ((d - explained).abs() / (4 * ulps + 1e-8)).max()))
    print(f"[sharded-train-2d] mid_rangenet float32 at 8x64x900 on a 2 x 2 "
          f"(data x model) grid of gloo ranks vs one device of 8: loss "
          f"{ranks[0]['loss']:.6f} / {one['loss']:.6f} (relative "
          f"{worst['loss']:.2e}, limit 1e-5), batch statistics "
          f"{worst['stats']:.2e} (limit 1e-4), gradients "
          f"{worst['grads']:.2e} of their scale (limit 5e-2) over "
          f"{len(one['grads'])} leaves, updated weights beyond what the "
          f"gradients give {update_err:.3f} of the limit; "
          f"{ranks[0]['split']} kernels split over model")
    for r in ranks:
        print(f"[sharded-train-2d] rank at {r['place']}: "
              f"{r['ms']:.2f} ms a step, peak {r['peak_mib']:.0f} MiB, "
              f"parameters {r['param_bytes'] / 2**20:.2f} MiB + moments "
              f"{r['moment_bytes'] / 2**20:.2f} MiB (replicated "
              f"{r['replicated_bytes'] / 2**20:.2f} + "
              f"{2 * r['replicated_bytes'] / 2**20:.2f}); a step's "
              f"collectives: " + ", ".join(
                  f"{ax} {kind} {v['calls']} in {v['ms']:.1f} ms"
                  for ax, c in r["collectives"].items()
                  for kind, v in c.items() if v["calls"]))
    if not (worst["loss"] <= 1e-5 and worst["stats"] <= 1e-4
            and worst["grads"] <= 5e-2 and update_err <= 1.0):
        raise AssertionError(f"2-D train step: {worst}, update {update_err}")
    if not all(r["param_bytes"] < r["replicated_bytes"] for r in ranks):
        raise AssertionError("2-D train step: a rank holds every weight")


def phase_multihost(dev, td):
    """``[multihost]``: ``parallel.multihost_smoke`` as 2 processes on the
    card (a ``file://`` rendezvous, the backend rule's gloo), each joined
    with a deadline: both ``MULTIHOST OK`` lines."""
    import subprocess
    init = f"file://{td}/multihost_rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, "-m",
         "semantic_suma_tpu_torch.parallel.multihost_smoke", "--coordinator",
         init, "--num-processes", "2", "--process-id", str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    oks = [line for o in outs for line in o.splitlines()
           if line.startswith("MULTIHOST OK")]
    for line in oks:
        print(f"[multihost] {line}")
    if len(oks) != 2 or any(p.returncode for p in procs):
        raise AssertionError("multihost smoke failed:\n"
                             + "\n".join(o[-2000:] for o in outs))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile-scans", type=int, default=0,
                    help="after the main path, trace this many more scans "
                         "with torch.profiler (device time by kernel); the "
                         f"loop path at most {LOOP_PROFILE_SCANS}")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}, {torch.cuda.device_count()} visible, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        print(f"[time] {name} {time.perf_counter() - t0:.1f} s (since the "
              f"start {time.perf_counter() - t_start:.1f} s)", flush=True)
        return out

    timed("build", phase_build)
    floors = timed("floors", phase_floors, dev)
    rec_a = timed("bilateral", phase_bilateral, dev, floors)
    recs_b = timed("zbuffer", phase_zbuffer, dev, floors)
    seg_image = timed("segmenter", phase_segmenter, dev)
    timed("segmenter-graph", phase_segmenter_graph, dev)
    rec_bn = timed("segmenter-epilogue", phase_segmenter_epilogue, dev)
    rec_sac, rec_att, sac_path = timed("segmenter-sac", phase_segmenter_sac,
                                       dev)
    rec_c = timed("knn", phase_knn, dev, floors, seg_image)
    rec_d, rec_e, rec_f = timed("icp", phase_icp, dev, floors)
    timed("miou", phase_miou, dev)
    timed("parity", phase_parity, dev)
    paths = {"segmenter_sac": sac_path,
             "main": timed("main", phase_main_path, dev, args.profile_scans)}
    paths["chunked"] = timed("chunked", phase_chunked, dev)
    timed("step-graph", phase_step_graph, dev)
    timed("default", phase_default_path, dev)
    timed("posegraph", phase_posegraph, dev)
    paths["loop"], real = timed("loop", phase_loop, dev, floors,
                                args.profile_scans)
    paths["loop_noisy"] = timed("loop-noisy", phase_loop_noisy, dev)
    ledger, _ = timed("cli-ledger", phase_cli_ledger, dev)
    paths.update(ledger)
    work = tempfile.TemporaryDirectory(prefix="chip-smoke-")
    td = work.name
    paths["cli_kitti"] = timed("cli-kitti", phase_cli_kitti, dev, td)
    paths["readers"] = timed("readers", phase_readers, dev, f"{td}/seq")
    paths["spill"] = timed("spill", phase_spill, dev)
    paths["segmenter_loop"] = timed("segmenter-loop", phase_segmenter_loop,
                                    dev)
    paths["cli_kitti_segmenter"] = timed(
        "cli-kitti-segmenter", phase_cli_kitti_segmenter, dev)
    timed("train-parity", phase_train_parity, dev)
    paths["train"] = timed("train", phase_train, dev)
    paths["checkpoint"] = timed("checkpoint", phase_checkpoint, dev)
    paths["cli_plots"] = timed("cli-plots", phase_cli_plots, dev)
    paths["sharded"], paths["sharded_single_device"], full = timed(
        "sharded", phase_sharded, dev, td)
    timed("sharded-syncs", phase_sharded_syncs, dev)
    paths["sharded_nccl"] = timed("sharded-nccl", phase_sharded_nccl, dev)
    paths["sharded_checkpoint"] = timed(
        "sharded-checkpoint", phase_sharded_checkpoint, dev, td, full)
    path, one = timed("sharded-train", phase_sharded_train, dev, td)
    timed("sharded-train-2d", phase_sharded_train_2d, dev, path, one)
    timed("multihost", phase_multihost, dev, td)
    work.cleanup()
    # launches: every path counted from zero over its own run and read right
    # after it; "launches" is their sum, "launches_by_path" the parts
    rec_a["launches_by_path"] = {k: v["bilateral_filter"]
                                 for k, v in paths.items()}
    rec_c["launches_by_path"] = {k: v["knn_clean_image"]
                                 for k, v in paths.items()}
    rec_bn["launches_by_path"] = {k: v["bn_act"] for k, v in paths.items()}
    # the SAC kernels run where SqueezeSegV3 runs, and nowhere else
    for rec, key in ((rec_sac, "sac_modulate"), (rec_att, "sac_attention")):
        rec["launches_by_path"] = {k: v[key] for k, v in paths.items()}
        if any(n for k, n in rec["launches_by_path"].items()
               if k != "segmenter_sac"):
            raise AssertionError(f"{key} launched without SqueezeSegV3: "
                                 f"{rec['launches_by_path']}")
    for rec, key in ((rec_d, "icp_products"), (rec_e, "gn_update"),
                     (rec_f, "gn_loop")):
        rec["launches_by_path"] = {k: v[key] for k, v in paths.items()}
    rec_f["evaluate_launches_by_path"] = {k: v["evaluate_calls"]
                                          for k, v in paths.items()}
    verify = real.pop("icp-verify")
    f_verify = real.pop("gn-loop-verify")
    s_verify = real.pop("sharded-verify")
    rec_f["evaluate_max_scaled_err"] = real.pop("evaluate")["rel"]
    rec_f["max_abs_err"] = max(rec_f["max_abs_err"], f_verify["plain_pose"],
                               f_verify["plain_t"])
    rec_f["max_scaled_err"] = max(rec_f["max_scaled_err"],
                                  f_verify["plain_rel"])
    rec_d["max_abs_err"] = max(rec_d["max_abs_err"], verify["d_abs"])
    rec_d["max_scaled_err"] = max(rec_d["max_scaled_err"],
                                  verify["d_scaled"])
    rec_e["max_abs_err"] = max(rec_e["max_abs_err"], verify["e_pose"],
                               s_verify["pose_1"])
    rec_e["max_scaled_err"] = max(rec_e["max_scaled_err"], verify["e_rel"],
                                  s_verify["rel_1"])
    for rec in recs_b:
        shape = (rec["n"], rec["n_flags"])
        rec["launches_by_path"] = {
            k: v["zbuffer_cells_by_shape"].get(shape, 0)
            for k, v in paths.items()}
        rec.update(real.get(rec["shape"], {}))
    on_path, off_path = [], []
    for rec in (rec_a, *recs_b, rec_c, rec_bn, rec_sac, rec_att, rec_d, rec_e,
                rec_f):
        rec["launches"] = sum(rec["launches_by_path"].values())
        (on_path if rec["launches"] else off_path).append(rec)
    # a kernel of a path must have run on it; a shape that no path launches
    # is held against its plain version above and listed apart, with 0
    # launches: a KITTI scan (the exported synthetic scans of phase 11 hold
    # fewer points, each file its own count) and the two-stream render (the
    # loop path composes in image space). Kernels D and E run the sharded
    # paths' Gauss-Newton, kernel F every other
    never = [r["shape"] if r["name"] == "zbuffer_cells" else r["name"]
             for r in off_path]
    if never != ["projection-kitti", "render-composed"]:
        raise AssertionError(f"launched on no path: {never}; only the KITTI "
                             "scan and the two-stream render may be")
    # no path linearizes with the plain version (build_rows on the card)
    plain = {k: v["build_rows_on_cuda"] for k, v in paths.items()}
    print(f"[plain] build_rows on CUDA tensors over {len(plain)} paths: "
          f"{sum(plain.values())}")
    if any(plain.values()):
        raise AssertionError(f"build_rows ran on the card: {plain}")
    keys = ("name", "shape", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "max_scaled_err", "ms",
            "eager_ms", "dead_ms", "earlier_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "real_ms", "real_eager_ms",
            "real_bound_ms", "equal_to_d_and_e", "iteration_ms",
            "bound_rereading_ms", "grid", "gn_call_ms", "gn_call_host_ms",
            "gn_trips_ms", "gn_trips_host_ms", "gn_host_loop_ms",
            "sharded_equal_to_f", "evaluate_launches_by_path",
            "evaluate_max_scaled_err")
    print(json.dumps({"held_off_path": [{k: r[k] for k in keys if k in r}
                                        for r in off_path]}))
    print(_smi("name,power.limit"))
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in on_path]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
