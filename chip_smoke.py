"""Drive the PyTorch port's main path once on an NVIDIA card, and check it.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); imports no jax.  Phases,
in order, each printing what it finds and raising on a failure (the
script then exits non-zero and never prints its last line):

1. device — the card, torch and CUDA versions, nvidia-smi's name and
   power limit;
2. build  — compile every kernel from csrc/ (one nvcc per source, timed);
3. kernels — dd_matvec / dd_rmatvec against the f64 truth at (512, 1024)
   (rtol = atol = 1e-11), against the plain PyTorch version on the card at
   (1441, 5093), (1536, 5120) and (1536, 1536), dense affine's normal
   matrix (within 64·eps32² of Σ|a_ij x_j| per
   output; dd_matvec also against the f64 truth there; dd_rmatvec also bit
   for bit against its own summation order in plain PyTorch,
   ``dd_cuda.rmv_slab_plain``, on a first and a second call), both on rows
   that do not start on a 16-byte boundary (A and x at a 4-byte storage
   offset, each and both), and kernel vs plain median times by CUDA events
   at (1536, 5120), (1536, 1536) and (4096, 8192), the L2 cache flushed before each run
   and the card held asleep until the host has queued the launches; dd A·x
   bit for bit against its summation order (``dd_cuda.mv_order_plain``) on
   long rows (1536, 5120) and on short rows at afiro's pad-128 shape
   (128, 128), timed there; dd Aᵀ·x at (128, 128) (4 slabs, the short-lane
   kernel) as at the pilot's shapes, timed there; then the double-word
   block-ELL kernel at the sparse fleet's shapes (Aᵀ in 8166 block-rows of
   2 tiles, A in 2070 of 4, 154511 nonzeros), one lane and 64 (a copy of the
   matrix a lane, and one shared at lane stride 0), bit for bit against the
   plain form (``bell._dd_matvec_plain``; 64 lanes under vmap), and
   ``bell.dd_matvec`` launching it once a call, single and vmapped, with
   CUDA-event medians of the kernel and the plain form beside the bound of
   its tiles and that of the nonzeros (``bell_dd_mv_roofline``'s);
4. afiro — solve(afiro, "pdas_dd", device="cuda") in f32: gap <= 1e-8,
   objective within 1e-7 relative of the published optimum; then in f64,
   dense and fully sparse (block 16), which takes the plain PyTorch forms on
   the card: the same bars, and no kernel launched;
5. pilot — the constructed-optimum LP at the pilot scale (1441 x 5093,
   padded to 1536 x 5120, f32): the main path.  Launch counters are reset
   just before and read just after; both kernels must have launched.  Gap
   <= 1e-8, objective error <= 1e-7; then a second, timed solve.
6. chol + assembly kernels — the tile kernel on SPD tiles (b = 16, 33, 64,
   96, 128; at 160 and 256 ``factor_tile_`` splits the tile around it)
   against the f64 truth (||L·Lᵀ - N|| / ||N|| <= 32·eps32) and its plain
   version (reconstructions within 64·eps32 of ||N||, the inverse within
   64·eps32 of max|L⁻¹| and |L⁻¹·L - I| <= 64·eps32, both upper triangles
   exactly zero), with kernel and plain median times at b = 128 and 256
   and the tile kernel's own time over back-to-back launches (CUDA
   events, so no profiler runs before the timed solves); a non-PD 64 tile and
   a 256 tile with its non-PD pivot in the trailing half giving an all-NaN
   factor and inverse (ok False); ``factorize(N, use_pallas=True)`` on a pilot-size
   N (1536 x 1536, A·D²·Aᵀ of the phase-5 LP) with its launch counters
   reset before and read after (the panel and Schur kernels' path), held
   against the f64 truth and the plain blocked_cholesky and cholesky_ex,
   with median times of all three (the kernel potrf and cholesky_ex also
   back to back behind a sleep, the card's own time), a non-PD copy coming
   back non-finite, sha256 of the factor, and the first step of the panel and
   Schur kernels (each alone, over back-to-back launches behind a sleep,
   beside torch.matmul and torch.addmm timed the same way; the panel kernel
   on fresh copies, the Schur kernel in place on one buffer, whose operands
   lie in the L2 cache as in the loop; the Schur kernel bit for bit against
   its own sums in plain PyTorch, ``chol_cuda.schur_fma_plain``, and its two
   launches of the panel loop against one whole launch); the same
   factorization and bars at n = 1441 (rows not 16-byte aligned, a last
   panel 33 wide); the assembly kernel against its plain version on the
   m = 16384 engine's pair schedule (each entry within 8·eps32·Σ|w·d²|),
   bit-identical across two runs, with the schedule's run count, mean and
   longest run, and times (whole, and its zeros and its runs apart, from two
   copies of its source built by tools/probe_assembly_kernel.py); then the
   tile engine's Schur kernel at QAP15's widest panel (34 row tiles, their
   595 pairs, block 128, 32 lanes): bit for bit against its own sums in
   plain PyTorch (``chol_cuda.tile_schur_fma_plain``) batched, through the
   operator under vmap and on one lane, its launches, and CUDA-event
   medians beside the plain four-launch chain it replaces (gathers, batched
   SGEMM, ``index_add_``), the SGEMM alone on gathered operands and
   ``lpbench/schur.py``'s bound;
7. sparse afiro — solve(afiro, "pdas_dd", sparse=True, block=16) in f32:
   objective within 1e-5 relative of the published optimum;
8. at scale — the constructed-optimum LP at m = 16384 (16384 x 49152),
   fully sparse, f32, block 128, Mehrotra, entry repair 1e-6: the main
   path of the tile engine.  The host analysis and pair schedule are timed
   on their own; launch counters are reset just before the solve and read
   just after; the tile, assembly and block-ELL dd kernels must have
   launched.  Gap
   <= 1e-6, objective error <= 1e-5; then a second, timed solve and a
   per-stage timing of one factorization and its solves;
9. block 256 — the same LP at block 256 (every diagonal tile split around
   the tile kernel), launch counters reset before and read after (the tile
   kernel must have launched), the same bars; a second, timed solve, and
   one factorization timed beside block 128's;
10. affine — solve(..., "affine"): afiro in f32 after row equilibration
   (optimal, within 2e-3 of the optimum: the f32 iterate floor), in f64
   dense and sparse (block 16; within 1e-6, x float64 on the card, no
   kernel launched), then the pilot LP in f32 (counters reset before and
   read after: dd A·x must have launched; optimal, objective error <= 1e-3;
   dd A·x against its plain version on the pilot's own normal matrix at the
   last iterate's slack; a second, timed solve) and in f64 (<= 1e-6); each
   iteration count beside the JAX package's on the CPU;
11. affine at scale — the m = 16384 LP, sparse, f32, block 128: the state
   and its own engine (built on the raw A) timed on their own, counters
   reset before and read after (the tile and assembly kernels must have
   launched), optimal, objective error <= 1e-3; a second, timed solve with
   its repair steps and its objective error by iteration, and a third with
   phase 8's stages from the program's spans;
12. presolve — solve(afiro, "pdas_dd", presolve=True) in f32: the presolve
   report, counters reset before and read after, gap <= 1e-8, objective
   within 1e-7, x and y restored to the original space;
13. crossover — solve(..., crossover=True) and crossover() in f32, each
   case's certificate on one line, counters reset before and read after:
   (a) afiro dense pdas_dd at pad 32 (certified, certificate gap < 1e-9,
   objective within 2e-6; dd A·x and Aᵀ·x launched); (b) afiro sparse
   block 16 (certified, within 1e-5; the tile and assembly kernels
   launched), then in f64 (no launch); (c) afiro's f32 pdas stop at the
   1e-4 gap through crossover() alone: never worse (certified within 2e-6,
   or x and status returned unchanged); (d) the pilot LP dense through
   "pdas" (certified, objective error <= 2e-6; dd launches; a second,
   timed call beside phase 5's pdas_dd); (e) phase 8's result and engine
   through crossover() (certified, objective error <= 1e-5; the tile and
   assembly kernels launched; one call timed);
14. matrix-free family — (a) solve(simple, "alm") in f32 and "aalm" /
   "selfdual" in f64, solve(afiro, "alm", pad 16) in f64: optimal, the
   value within the JAX tests' bars (1e-2, 5e-2, 1e-4; afiro 2e-3), no
   kernel launched, each count beside the JAX package's on the CPU; (b) the
   pilot LP dense in f32: an ALM phase at a bounded budget (ALM_PILOT),
   then the dd_gradient phase from its multipliers with mu reset to 100,
   counters reset before each phase and read after: dd A·x must launch
   exactly 2·run + 2·outer times and dd Aᵀ·x 2·run in the dd phase (run:
   the inner iterations the chunked loops ran), with ms per inner
   iteration, the violation after every outer step, the objective error,
   and the device-busy share of each inner loop (profiler) over one
   eager chunk and over ten chunks, nine of them CUDA-graph replays;
   (c) the m = 16384 LP through to_sparse_lp, its block-ELL renderings
   required, the same two phases (ALM_AT_SCALE) and measurements, and
   the operands' bytes on the card;
15. batch — (a) the batched dd A·x and Aᵀ·x kernels at (1024, 64, 64),
   batched pdas's N, (256, 64, 128) and (256, 64, 192), the finisher's AD
   of the same-shape and the mixed batch, and (8, 1536, 5120), each lane
   bit for bit against the single kernel (A at a 4-byte storage offset
   too) and both against their summation orders (``mv_order_plain``,
   ``rmv_slab_plain`` batched), within 64·eps32² of Σ|a_ij x_j| of the
   plain batched form, dd A·x against the f64 truth, and CUDA-event medians
   of the batched launch, of a Python loop of B single launches and of the
   plain batched form, beside the bound (dd Aᵀ·x on lanes of at most
   ``dd_cuda.RMV_SHORT_SLABS`` slabs takes the short-lane kernel);
   (b) 1024 LPs of random_lp(s, 24, 8, 48, density 0.3) in one (64, 128)
   box, f32, batched_pdas (60 iterations, Mehrotra, "inverse"), counters
   reset before and read after: batched dd A·x must have launched; every
   optimal lane's objective within 1e-3 of HiGHS; solves/s over three
   timed calls, one more with the dbound retry off beside them (what the
   per-lane retry factorization costs) and the device-busy share of the
   first iteration (profiler); (c) the 256-LP mixed batch with 32 stragglers of the JAX
   package's bench through solve_batch, then embed_batch and two solves
   of the handle (objectives and counts bit-identical to the direct call),
   then a warm re-solve (fewer iterations in all than cold), solves/s of
   the direct and the embedded calls; (d) 256 of (b)'s lanes through
   batched_pdas_dd in f32 (JAX's two-phase protocol: gap_tol 1e-9, two
   refinement steps), counters reset before and read after: both batched
   kernels must have launched; each lane's final gap, with the lanes that
   stop above 1e-8 named (the f32 finisher's floor, the JAX package's
   too); (e) 16 of them in f64 through solve_batch: each lane's status
   and count equal to its single solve(..., "pdas") on the card, no
   kernel launched;
16. batch: sparse, slabbed, affine — (a) the batched assembly kernel on
   the m = 16384 schedule for 8 lanes and the batched tile kernel on
   (8, 128, 128) SPD tiles, each lane bit for bit against the single
   launch and against the plain batched forms, with CUDA-event medians
   beside a Python loop of single launches and the bound; (b)
   batched_normal_solves on phase 8's engine, 8 lanes of D ~ U(0.5, 1.5),
   G ~ N(0, 1), f32, counters reset before and read after: every lane ok
   and within 1e-5 (2-norm, relative) of its single solve_normal_ell, the
   batched kernels launched and no single one, seconds beside 8 single
   calls; (c) a re-solve fleet of 32 LPs of one A at 25fv47 scale, each
   with its own (b, c), block 128, f32: batched sparse pdas (Mehrotra) then
   mu-recentred duals and batched sparse pdas_dd (gap_tol 1e-9), counters
   reset before each and read after (batched tile and assembly kernels,
   no single one): every lane optimal within 1e-3 of HiGHS after phase 1,
   and after the finisher gap < 1e-7 within 1e-4 of HiGHS, or, where the
   f32 finisher floors (the JAX package's too), the precision-floor status
   with the objective bar met; lanes 0-3 within 1e-5 of their single
   solves; solves/s and the device-busy share of one iteration
   (profiler); (d) phase 15's mixed batch through solve_batch(slab_iters=16)
   beside plain solve_batch: the same statuses, objectives within 1e-3 of
   HiGHS, lane-iterations and solves/s of three calls each in turns; (e)
   batched_affine on (b)'s 1024 LPs in f32 (batched dd A·x launched, no
   single one) and on 16 of them in f64 (each lane's status and count of
   its single affine_scaling, no kernel launched);
17. dense-A engines — (a) the pilot LP (phase 5's, rows equilibrated):
   sparse.engine_for(A, block=128) (its panels, tiles, assembly mode and
   costs) and BlockSparseCholesky, one solve_normal with one refinement
   step by each and by ops.dense.solve_normal on the same d ~ U(0.5, 1.5)
   and g ~ N(0, 1): each within 1e-4 of the f64 solution, its relative
   difference from the dense one, host ms (median, min, max of 5 calls),
   counters reset before and read after: the tile kernel once per panel,
   dd A·x twice and Aᵀ·x once (the refinement step), no assembly kernel;
   BlockSparseCholesky's potrf once per diagonal tile; the device-busy
   share of one tile-engine call; (b) the pilot LP through pdas (Mehrotra)
   then pdas_dd (gap_tol 1e-9) on the engine: gap <= 1e-7, objective error
   <= 1e-5, the counts and time beside phase 5's; (c) the 25fv47-scale LP
   (pad 128) the same way on its own engine: objective within 1e-5 of
   HiGHS; (d) (b) with gondzio_correctors=2 in both phases, the same bars;
   (e) f32 affine on the pilot with the engine (optimal, objective error
   <= 1e-3) and afiro dense (pad 32) through pdas + pdas_dd + crossover on
   engine_for(block=16): certified, certificate gap < 1e-9, objective
   within 2e-6.  Counters reset before each path and read after: the tile
   kernel and the dd kernels launched, the assembly kernel not;
18. mesh and the dense-A batch — an NCCL process group of world size 1 (a
   TCP store on 127.0.0.1; one card, and NCCL refuses two ranks on one) and
   ``lp_mesh(1, 1)`` over it, destroyed at the end: (a) the pilot A's
   ``sharded_solve_normal`` (one refinement step) within 1e-6 of
   ``ops.dense.solve_normal`` with the same refinement (its difference and
   bit equality printed; dd A·x twice and Aᵀ·x once), then the pilot
   through pdas then pdas_dd with ``mesh=`` to phase 5's bars, its counts
   and time beside phase 5's; (b) the m = 16384 LP through the at-scale
   two-phase flow with ``mesh=`` on a fresh engine: phase 8's bars, K4 once
   per factorization (on rank 0's slab) and K1 once per panel of each, no
   batched launch; (c) phase 15 (c)'s mix through ``solve_batch(mesh=...)``
   beside plain ``solve_batch``: the same statuses, every optimal lane
   within 1e-3 of HiGHS, solves/s of both; (d) 8 lanes of the pilot's A,
   each with its own (b, c), through batched pdas (Mehrotra) then batched
   pdas_dd (gap_tol 1e-9) on ``engine_for(A, block=128)``: every lane's
   status that of its single solve on the engine (or, in the finisher, the
   f32 precision floor where the other reaches the gap: the JAX package's
   own limit), its objective within 1e-6 of it; the batched tile kernel a
   multiple of the panels and both batched dd kernels launched, no single
   launch; two-phase solves/s of the batch and of the single solves.
19. cli + tools — (a) the pilot LP and the m = 16384 LP written as MPS files
   (read back bit-equal) and solved through the command line in this
   process (``__main__.main``, stdout captured, counters reset before and
   read after): the pilot with ``--solver pdas_dd`` to phase 5's bars (both
   dd kernels launched), the m = 16384 LP with the at-scale recipe and
   ``--report`` to phase 8's bars (the tile and assembly kernels launched;
   the report equal to ``diag.factor_report`` of phase 8's plan), each
   count beside its phase's; ``diag.device_memory_report`` after it (0 <
   peak <= limit) and ``live_buffer_report`` before, after and after
   ``gc``; then a real ``python -m cholesky_is_magic_tpu_torch afiro.mps
   --solver pdas_dd --json`` process to phase 4's bars, the kernel library
   loaded, not rebuilt, and its wall time; (b) ``diag.profile_trace``
   around afiro's f32 pdas_dd (``annotate("pdas_dd")``) and one assembly,
   factorization and solve on phase 8's engine and a block-ELL dd Aᵀ·y
   (``annotate("engine")``):
   the written trace's kernel events of each hand-written kernel equal to
   its counters' deltas, both annotations in it, its size; (c) the pilot's
   pdas state after 5 iterations through ``utils/checkpoint.py`` onto the
   card bit-equal, a warm pdas from it in no more iterations than cold;
   ``nan_debug`` raising on a CUDA 0/0; ``checked_solve_kkt_newton``
   passing on a 64 x 128 f32 system and raising on a zero A.

Each kernel in the JSON line carries its bound: the larger of the bytes it
must move over 3.35 TB/s and its flops over 67 TFLOP/s (FP32 without
tensor cores; H100 SXM data sheet), from this run's shapes.

The second-to-last line is a JSON object describing each kernel (its
``launches`` summed over the main paths' runs: pdas_dd, the f32 affine
pilot, affine at scale, the presolved pdas_dd, the crossover cases, the
dense dd ALM phase, the batched pdas and pdas_dd, phase 17's dense-A
engine paths, phase 18's mesh and dense-A batch paths and phase 19's
command-line and traced paths, each also apart);
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

AFIRO = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "tests", "fixtures", "afiro.mps")
AFIRO_OPTIMUM = -464.75314285714285
EPS32 = float(np.finfo(np.float32).eps)
PLAIN_TOL = 64  # kernel vs plain: PLAIN_TOL * eps32^2 * sum_j |a_ij x_j|
CSRC = "cholesky_is_magic_tpu_torch/csrc/"
POTRF = dict(replaces="cholesky_is_magic_tpu/ops/pallas_chol.py:182",
             source=CSRC + "potrf.cu")
KERNELS = {
    "mv": dict(name="dd_mv_f32", replaces="cholesky_is_magic_tpu/ops/dd_pallas.py:79",
               source=CSRC + "dd_matvec.cu"),
    "rmv": dict(name="dd_rmv_f32", replaces="cholesky_is_magic_tpu/ops/dd_pallas.py:96",
                source=CSRC + "dd_matvec.cu"),
    "potrf_tile": dict(name="potrf_tile_f32", **POTRF),
    "potrf_panel": dict(name="potrf_panel_f32", **POTRF),
    "potrf_schur": dict(name="potrf_schur_f32", **POTRF),
    "assemble_pairs": dict(
        name="assemble_pairs_f32",
        replaces="benchmarks/explore_prefetch_assembly.py:174",
        source=CSRC + "assemble_pairs.cu"),
    "mv_batched": dict(name="dd_mv_f32_batched",
                       replaces="cholesky_is_magic_tpu/ops/dd_pallas.py:79",
                       source=CSRC + "dd_matvec.cu"),
    "rmv_batched": dict(name="dd_rmv_f32_batched",
                        replaces="cholesky_is_magic_tpu/ops/dd_pallas.py:96",
                        source=CSRC + "dd_matvec.cu"),
    "potrf_tile_batched": dict(name="potrf_tile_f32_batched", **POTRF),
    "assemble_pairs_batched": dict(
        name="assemble_pairs_f32_batched",
        replaces="benchmarks/explore_prefetch_assembly.py:174",
        source=CSRC + "assemble_pairs.cu"),
    # No TPU kernel: the JAX package's block-ELL dd product is plain jnp.
    "bell_mv": dict(name="bell_dd_mv_f32", replaces="none (cholesky_is_magic_tpu/ops/bell.py:169)",
                    source=CSRC + "bell_dd.cu"),
    "bell_mv_batched": dict(name="bell_dd_mv_f32_batched",
                            replaces="none (cholesky_is_magic_tpu/ops/bell.py:169)",
                            source=CSRC + "bell_dd.cu"),
    # No TPU kernel: the JAX tile engine's Schur update is plain jnp.
    "tile_schur": dict(name="tile_schur_f32",
                       replaces="none (cholesky_is_magic_tpu/sparse/tiled.py:367)",
                       source=CSRC + "tile_schur.cu"),
    "tile_schur_batched": dict(name="tile_schur_f32_batched",
                               replaces="none (cholesky_is_magic_tpu/sparse/tiled.py:367)",
                               source=CSRC + "tile_schur.cu"),
    # No TPU kernel: the JAX tile engine's triangular solves are plain jnp.
    "tile_solve": dict(name="tile_solve_f32",
                       replaces="none (cholesky_is_magic_tpu/sparse/tiled.py TiledCholesky.solve)",
                       source=CSRC + "tile_solve.cu"),
    "tile_solve_batched": dict(
        name="tile_solve_f32_batched",
        replaces="none (cholesky_is_magic_tpu/sparse/tiled.py TiledCholesky.solve)",
        source=CSRC + "tile_solve.cu"),
}
# QAP15's widest Schur update at block 128 (sparse/symbolic.py's analysis of
# lpbench's qap15 configuration): 34 row tiles and every pair of them, on the
# qap15.fleet32 cell's 32 lanes.
SCHUR_ROWS, SCHUR_LANES = 34, 32
AT_SCALE_M = 16384
# The at-scale recipe of the JAX package's api.solve docstring (:439-440).
AT_SCALE_KW = dict(sparse=True, block=128, mehrotra=True, entry_repair_tol=1e-6,
                   device="cuda", dtype=torch.float32)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12     # H100 SXM FP32 outside the tensor cores
L2_BYTES = 50 * 2**20
SLEEP_CYCLES_PER_MS = 2_000_000  # torch.cuda._sleep cycles, at ~2 GHz


def say(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card only")
    card = card_line()
    say(f"[device] {torch.cuda.get_device_name(0)}  torch {torch.__version__}"
        f"  cuda {torch.version.cuda}  count {torch.cuda.device_count()}")
    say(f"[device] nvidia-smi: {card}")
    return card


def phase_build(cuda_build):
    t = time.perf_counter()
    path = cuda_build.build()
    cuda_build.load()
    say(f"[build] {path.name} in {time.perf_counter() - t:.3f} s")
    log = path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                say(f"[build] {line.strip()}")


def _f64(d):
    return d.hi.double() + d.lo.double()


def _inputs(m, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(m, n, generator=g, device="cuda")
    x = torch.randn(n, generator=g, device="cuda")
    y = torch.randn(m, generator=g, device="cuda")
    return A, x, y


def _reset(*counters):
    for c in counters:
        for k in c:
            c[k] = 0


def _bound(nbytes, flops):
    """The least time the card could take (``bound_ms``) and which of bytes
    or operations sets it (``bound_by``)."""
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FP32_FLOPS * 1e3
    return {"bound_ms": max(t_b, t_f), "bound_by": "bytes" if t_b >= t_f else "operations"}


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _median_ms(fn, reps=20, flush=None, lead=0.0):
    """Median ms of fn() by CUDA events; ``flush``, a buffer larger than the
    L2 cache, is read before each run (outside the timed region), so the
    cache holds none of fn()'s inputs and no dirty lines whose write-back
    the timed run would pay for.
    With ``lead`` the card sleeps that many ms before the first event, so
    the host has queued fn()'s launches before the card reaches them and the
    time is the card's alone."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.sum()
        if lead:
            torch.cuda._sleep(int(SLEEP_CYCLES_PER_MS * lead))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _back_to_back_ms(launch, reps, sleep_ms=0.1):
    """Device ms per call of ``launch(r)``, r = 0 .. reps - 1, queued back
    to back between two CUDA events, after a warm-up call ``launch(reps)``.
    The card sleeps first (``sleep_ms`` per call) while the host queues
    them all, so it never waits on the host."""
    launch(reps)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda._sleep(int(SLEEP_CYCLES_PER_MS * sleep_ms * reps))
    ev[0].record()
    for r in range(reps):
        launch(r)
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def _tile_kernel_ms(chol_cuda, N, reps=200):
    """Device ms per launch of the tile kernel alone, each launch on its
    own copy of N."""
    T = N.expand(reps + 1, *N.shape).clone()
    inv = torch.empty(reps + 1, *N.shape, device="cuda")
    ms = _back_to_back_ms(lambda r: chol_cuda.potrf_tile_(T[r], inv[r]), reps)
    if not bool(torch.isfinite(T).all()):
        raise AssertionError("the tile kernel failed on copies of an SPD tile")
    return ms


def _panel_step_ms(chol_cuda, A0, inv, P, matmul=False, reps=100):
    """Device ms per call of the first panel step of A0 alone, each call on
    its own copy of A0 (so the panel comes from device memory): the panel
    kernel, every copy equal to ``P`` after it, or with ``matmul``
    torch.matmul of the copy's panel by inv's transpose into a fresh
    output."""
    b = inv.shape[0]
    W = A0.expand(reps + 1, *A0.shape).clone()
    if matmul:
        out = torch.empty(reps + 1, *P.shape, device="cuda")
        return _back_to_back_ms(
            lambda r: torch.matmul(W[r, b:, :b], inv.T, out=out[r]), reps)
    ms = _back_to_back_ms(lambda r: chol_cuda.potrf_panel_(
        W[r, b:, :b], inv, W[r, :b, b:]), reps)
    if not (torch.equal(W[:, b:, :b], P.expand(reps + 1, *P.shape))
            and bool((W[:, :b, b:] == 0).all())):
        raise AssertionError("the panel kernel differs between copies")
    return ms


def _check_mv(ddm, A, x, tag):
    """dd_matvec against the f64 truth (rtol = atol = 1e-11) and against its
    plain version (PLAIN_TOL); returns the max abs error vs plain."""
    got = _f64(ddm.dd_matvec(A, x))
    true = A.double() @ x.double()
    t_err = (got - true).abs()
    t_ratio = (t_err / (1e-11 + 1e-11 * true.abs())).max().item()
    p_err = (got - _f64(ddm._dd_matvec_plain(A, x))).abs()
    p_ratio = (p_err / (EPS32**2 * (A.abs() @ x.abs()).double())).max().item()
    say(f"[kernels] mv {tag}: vs f64 truth max abs err {t_err.max().item():.3e},"
        f" worst err/tol {t_ratio:.3e}; vs plain max abs err {p_err.max().item():.3e},"
        f" max err / (eps32^2 sum|ax|) {p_ratio:.3f} (limit {PLAIN_TOL})")
    if not (t_ratio <= 1 and p_ratio <= PLAIN_TOL):
        raise AssertionError(f"mv {tag} misses the f64 truth or its plain version")
    return p_err.max().item()


def _check_rmv(ddm, dd_cuda, A, y, tag):
    """dd_rmatvec against its plain version (PLAIN_TOL), the f64 truth
    (rtol = atol = 1e-11) and, bit for bit on a first and a second call, its
    own summation order in plain PyTorch; returns the max abs error vs
    plain."""
    got, again = ddm.dd_rmatvec(A, y), ddm.dd_rmatvec(A, y)
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count
    order = dd_cuda.rmv_slab_plain(A, y, *dd_cuda.rmv_slabs(*A.shape, sms))
    same = all(torch.equal(g.hi, order.hi) and torch.equal(g.lo, order.lo)
               for g in (got, again))
    true = A.double().T @ y.double()
    t_ratio = ((_f64(got) - true).abs() / (1e-11 + 1e-11 * true.abs())).max().item()
    err = (_f64(got) - _f64(ddm._dd_matvec_plain(A.T, y))).abs()
    ratio = (err / (EPS32**2 * (A.abs().T @ y.abs()).double())).max().item()
    say(f"[kernels] rmv {tag}: vs plain max abs err {err.max().item():.3e}, max err /"
        f" (eps32^2 sum|ax|) {ratio:.3f} (limit {PLAIN_TOL}); vs f64 truth worst"
        f" err/tol {t_ratio:.3e}; bit-equal to its slab order, twice: {same}")
    if not (ratio <= PLAIN_TOL and t_ratio <= 1 and same):
        raise AssertionError(f"rmv {tag} misses its plain version, the truth or its order")
    return err.max().item()


def phase_kernels(ddm, dd_cuda):
    """Kernels against f64 truth and against the plain version; times."""
    A, x, y = _inputs(512, 1024, 3)
    A64 = A.double()
    for which, got, true in (
        ("mv", ddm.dd_matvec(A, x), A64 @ x.double()),
        ("rmv", ddm.dd_rmatvec(A, y), A64.T @ y.double()),
    ):
        err = (_f64(got) - true).abs()
        bound = 1e-11 + 1e-11 * true.abs()
        say(f"[kernels] {which} (512, 1024) vs f64 truth: max abs err "
            f"{err.max().item():.3e}, worst err/tol {(err / bound).max().item():.3e}")
        if not bool((err <= bound).all()):
            raise AssertionError(f"{which} misses the f64 truth at rtol 1e-11")

    stats = {}
    normal = {}  # dd A·x at the pilot's normal matrix, dense affine's shape
    for m, n in ((1441, 5093), (1536, 5120), (1536, 1536)):
        A, x, y = _inputs(m, n, m)
        mv_err = _check_mv(ddm, A, x, f"({m}, {n})")
        rmv_err = _check_rmv(ddm, dd_cuda, A, y, f"({m}, {n})")
        if (m, n) == (1536, 5120):
            stats["mv"] = {"max_abs_err": mv_err}
            stats["rmv"] = {"max_abs_err": rmv_err}
        if (m, n) == (1536, 1536):
            normal["max_abs_err"] = mv_err
    # Rows, x and y that do not start on a 16-byte boundary.
    m, n = 1536, 5120
    g = torch.Generator(device="cuda").manual_seed(5)
    Abuf = torch.randn(m * n + 1, generator=g, device="cuda")
    xbuf = torch.randn(n + 1, generator=g, device="cuda")
    for tag, A, x in (("A at a 4-byte offset", Abuf[1:].view(m, n), xbuf[:n]),
                      ("x at a 4-byte offset", Abuf[:-1].view(m, n), xbuf[1:]),
                      ("A and x at a 4-byte offset", Abuf[1:].view(m, n), xbuf[1:])):
        _check_mv(ddm, A, x, f"({m}, {n}), {tag}")
        _check_rmv(ddm, dd_cuda, A, x[:m], f"({m}, {n}), {tag}")
    del Abuf, xbuf

    flush = torch.zeros(2 * L2_BYTES // 4, device="cuda")
    for m, n in ((1536, 5120), (1536, 1536), (4096, 8192)):
        A, x, y = _inputs(m, n, 7)
        runs = {
            "mv": (lambda: ddm.dd_matvec(A, x), lambda: ddm._dd_matvec_plain(A, x)),
            "rmv": (lambda: ddm.dd_rmatvec(A, y),
                    lambda: ddm._dd_matvec_plain(A.T, y)),
        }
        for which, (kern, plain) in runs.items():
            p1, k1, k2, p2 = (_median_ms(f, flush=flush, lead=0.2)
                              for f in (plain, kern, kern, plain))
            k, p = min(k1, k2), min(p1, p2)
            gbs = m * n * 4 / (k * 1e-3) / 1e9
            nout = m if which == "mv" else n
            # Each element of A read once; 14 flops per element (the product
            # and its error, the compensated accumulation).
            bound = _bound(_nbytes(A) + 4 * (m + n - nout) + 8 * nout, 14 * m * n)
            say(f"[kernels] {which} ({m}, {n}) median ms: kernel {k1:.4f} {k2:.4f}"
                f"  plain {p1:.4f} {p2:.4f} (kernel reads A at {gbs:.0f} GB/s;"
                f" bound {bound['bound_ms']:.4f})")
            if (m, n) == (1536, 5120):
                stats[which].update(ms=k, plain_ms=p, library_ms=None, **bound)
            if (m, n) == (1536, 1536) and which == "mv":
                normal.update(ms=k, plain_ms=p, library_ms=None, **bound)
        del A, x, y
        torch.cuda.empty_cache()
    # Both dd A·x kernels bit for bit against their summation order: the
    # block per row at the pilot's rows, the short-row kernel at afiro's
    # pad-128 shape (128, 128), which the dense f32 afiro solve takes and
    # whose count follows that order; the short one timed there.
    for m, n in ((1536, 5120), (128, 128)):
        A, x, _ = _inputs(m, n, 9)
        got, want = dd_cuda.dd_mv(A, x), dd_cuda.mv_order_plain(A, x)
        same = torch.equal(got[0], want.hi) and torch.equal(got[1], want.lo)
        route = "short rows" if n <= dd_cuda.MV_SHORT_MAX else "a block per row"
        say(f"[kernels] mv ({m}, {n}) ({route}): bit-equal to its summation order"
            f" (dd_cuda.mv_order_plain) {same}")
        if not same:
            raise AssertionError(f"dd A·x at ({m}, {n}) leaves its summation order")
    p1, k1, k2, p2 = (_median_ms(f, flush=flush, lead=0.2) for f in (
        lambda: ddm._dd_matvec_plain(A, x), lambda: ddm.dd_matvec(A, x),
        lambda: ddm.dd_matvec(A, x), lambda: ddm._dd_matvec_plain(A, x)))
    bound = _bound(_nbytes(A, x) + 8 * m, 14 * m * n)
    say(f"[kernels] mv ({m}, {n}), afiro's pad-128 shape, median ms: kernel {k1:.4f} {k2:.4f}"
        f"  plain {p1:.4f} {p2:.4f}  bound {bound['bound_ms']:.5f} ({bound['bound_by']})")
    err = (_f64(ddm.DD(*got)) - _f64(ddm._dd_matvec_plain(A, x))).abs().max().item()
    stats["mv"]["at_128x128"] = dict(ms=min(k1, k2), plain_ms=min(p1, p2), library_ms=None,
                                     max_abs_err=err, **bound)
    # dd Aᵀ·x at that shape: 4 slabs of 32 rows, the short-lane kernel.
    A, _, y = _inputs(m, n, 9)
    err = _check_rmv(ddm, dd_cuda, A, y, f"({m}, {n}), afiro's pad-128 shape")
    p1, k1, k2, p2 = (_median_ms(f, flush=flush, lead=0.2) for f in (
        lambda: ddm._dd_matvec_plain(A.T, y), lambda: ddm.dd_rmatvec(A, y),
        lambda: ddm.dd_rmatvec(A, y), lambda: ddm._dd_matvec_plain(A.T, y)))
    bound = _bound(_nbytes(A, y) + 8 * n, 14 * m * n)
    say(f"[kernels] rmv ({m}, {n}), afiro's pad-128 shape, median ms: kernel {k1:.4f} {k2:.4f}"
        f"  plain {p1:.4f} {p2:.4f}  bound {bound['bound_ms']:.5f} ({bound['bound_by']})")
    stats["rmv"]["at_128x128"] = dict(ms=min(k1, k2), plain_ms=min(p1, p2), library_ms=None,
                                      max_abs_err=err, **bound)
    del flush
    stats["mv"]["at_1536x1536"] = normal
    return stats


# Phase 3 (b): the sparse fleet's block-ELL shapes (pds-10: the 16558 x
# 65321 staircase at width 4, 154511 nonzeros; A in 2070 block-rows of 4
# tiles, Aᵀ in 8166 of 2) and its lanes.
BELL_SHAPES = {"AT": dict(nbr=8166, kb=2, n_rows=65321, n_cols=16558),
               "A": dict(nbr=2070, kb=4, n_rows=16558, n_cols=65321)}
BELL_NNZ = 154511
BELL_LANES = 64


def _bell_matrix(bell, nbr, kb, n_rows, n_cols, nnz, seed):
    """A BellMatrix of this shape on the card: each block-row 1 to kb real
    tiles at distinct block columns (padded after them), ``nnz`` draws of
    positions in the real tiles, its ``nnz`` the nonzeros it holds.  The
    kernel's and the plain form's work depend on the shape alone."""
    rng = np.random.default_rng(seed)
    ncb = -(-n_cols // bell.BC)
    real = rng.integers(1, kb + 1, size=nbr)
    real[0] = kb
    bcols = np.zeros((nbr, kb), np.int64)
    for r in range(nbr):
        bcols[r, :real[r]] = np.sort(rng.choice(ncb, size=real[r], replace=False))
    blocks = np.zeros((nbr, kb, bell.BR, bell.BC), np.float32)
    tile = rng.integers(0, real.sum(), size=nnz)
    owner = np.repeat(np.arange(nbr), real)
    slot = np.concatenate([np.arange(k) for k in real])
    row, col = rng.integers(0, bell.BR, size=nnz), rng.integers(0, bell.BC, size=nnz)
    keep = bcols[owner[tile], slot[tile]] * bell.BC + col < n_cols
    blocks[owner[tile][keep], slot[tile][keep], row[keep], col[keep]] = rng.normal(
        size=int(keep.sum())).astype(np.float32)
    over_r, over_i = np.nonzero(np.arange(nbr)[:, None] * bell.BR + np.arange(bell.BR) >= n_rows)
    blocks[over_r, :, over_i, :] = 0.0
    return bell.BellMatrix(torch.from_numpy(blocks).cuda(), torch.from_numpy(bcols).cuda(),
                           n_rows, n_cols, int(np.count_nonzero(blocks)))


def _bell_bounds(B, lanes, copies):
    """The kernel's bound (every tile element and block column read once a
    copy of the matrix, x read and (hi, lo) written a lane, 14 flops a tile
    element a lane) and the nonzeros' bound of ``bell_dd_mv_roofline`` (a
    value and a 32-bit index a nonzero in place of the tiles)."""
    io = 4 * lanes * B.n_cols + 8 * lanes * B.n_rows
    padded = _bound(copies * _nbytes(B.blocks, B.bcols) + io, 14 * lanes * B.blocks.numel())
    nnz = _bound(copies * 8 * B.nnz + io, 14 * lanes * B.nnz)
    return dict(padded, nnz_bound_ms=nnz["bound_ms"], nnz_bound_by=nnz["bound_by"])


def _same_bits(got, want):
    """(hi, lo) pairs equal bit for bit, the sign of a zero too."""
    return all(torch.equal(u, v) and torch.equal(torch.signbit(u), torch.signbit(v))
               for u, v in zip(got, want))


def phase_bell(bell, bell_cuda, stats):
    """The double-word block-ELL kernel at the sparse fleet's shapes: one
    lane (``dd_mv``) and 64 (``dd_mv_batched``, each lane with its own copy
    of the matrix as ``parallel.stack_sparse_states`` holds the fleet's, and
    one copy shared at lane stride 0), bit for bit against
    ``bell._dd_matvec_plain`` on the same inputs (64 lanes: under
    ``torch.func.vmap``); ``bell.dd_matvec`` itself once per call, single
    and vmapped; CUDA-event medians of the kernel and the plain form (the L2
    cache flushed, the card asleep until the launch is queued) beside both
    bounds."""
    flush = torch.zeros(2 * L2_BYTES // 4, device="cuda")
    single, batched = {}, {}
    for tag, shape in BELL_SHAPES.items():
        B = _bell_matrix(bell, **shape, nnz=BELL_NNZ, seed=21)
        g = torch.Generator(device="cuda").manual_seed(5)
        X = torch.randn(BELL_LANES, B.n_cols, generator=g, device="cuda")
        key = f"{B.n_rows}x{B.n_cols} kb {B.kb}"
        name = f"{tag} ({B.blocks.shape[0]} block-rows of {B.kb} tiles, {B.nnz} nonzeros)"
        kern = lambda: bell_cuda.dd_mv(B.blocks, B.bcols, X[0], B.n_rows, B.nnz)  # noqa: E731
        plain = lambda: bell._dd_matvec_plain(B, X[0])  # noqa: E731
        _reset(bell_cuda.LAUNCHES)
        routed = bell.dd_matvec(B, X[0])
        want = plain()
        same = _same_bits(kern(), want) and _same_bits(routed, want)
        if not (same and bell_cuda.LAUNCHES == {"bell_mv": 2, "bell_mv_batched": 0}):
            raise AssertionError(f"bell {name}, one lane: bit-equal {same},"
                                 f" launches {bell_cuda.LAUNCHES}")
        p1, k1, k2, p2 = (_median_ms(f, flush=flush, lead=0.2)
                          for f in (plain, kern, kern, plain))
        bound = _bell_bounds(B, 1, 1)
        say(f"[kernels] bell {name}, one lane: bit-equal to the plain form, and through"
            f" bell.dd_matvec, {same}; median ms kernel {k1:.4f} {k2:.4f}  plain {p1:.4f}"
            f" {p2:.4f}  bound {bound['bound_ms']:.5f} ({bound['bound_by']}),"
            f" nonzeros' bound {bound['nnz_bound_ms']:.5f}")
        single[key] = dict(ms=min(k1, k2), plain_ms=min(p1, p2), library_ms=None,
                           max_abs_err=0.0, **bound)
        del want, routed
        plain_all = lambda: torch.func.vmap(lambda v: bell._dd_matvec_plain(B, v))(X)  # noqa: E731
        want = plain_all()
        p64 = _median_ms(plain_all, reps=5, flush=flush, lead=0.2)
        torch.cuda.empty_cache()
        _reset(bell_cuda.LAUNCHES)
        routed = torch.func.vmap(lambda v: bell.dd_matvec(B, v))(X)
        same = _same_bits(routed, want)
        if not (same and bell_cuda.LAUNCHES == {"bell_mv": 0, "bell_mv_batched": 1}):
            raise AssertionError(f"bell {name}, vmapped bell.dd_matvec: bit-equal {same},"
                                 f" launches {bell_cuda.LAUNCHES}")
        del routed
        for layout in ("copies", "shared"):
            blocks = B.blocks.expand(BELL_LANES, *B.blocks.shape)
            bcols = B.bcols.expand(BELL_LANES, *B.bcols.shape)
            if layout == "copies":
                blocks, bcols = blocks.clone(), bcols.clone()
            kern = lambda: bell_cuda.dd_mv_batched(blocks, bcols, X, B.n_rows, B.nnz)  # noqa: E731
            same = _same_bits(kern(), want)
            if not same:
                raise AssertionError(f"bell {name}, {BELL_LANES} lanes ({layout}): a lane"
                                     " differs from the plain form")
            k1, k2 = (_median_ms(kern, flush=flush, lead=0.2) for _ in range(2))
            bound = _bell_bounds(B, BELL_LANES, BELL_LANES if layout == "copies" else 1)
            say(f"[kernels] bell {name}, {BELL_LANES} lanes, {layout}: every lane bit-equal"
                f" to the plain form under vmap {same}; median ms kernel {k1:.4f} {k2:.4f}"
                f"  plain {p64:.4f}  bound {bound['bound_ms']:.4f} ({bound['bound_by']}),"
                f" nonzeros' bound {bound['nnz_bound_ms']:.4f}")
            batched[f"{BELL_LANES}x{key} {layout}"] = dict(
                ms=min(k1, k2), plain_ms=p64, library_ms=None, max_abs_err=0.0, **bound)
            del blocks, bcols
            torch.cuda.empty_cache()
        del B, X, want
        torch.cuda.empty_cache()
    first = next(iter(single))
    stats["bell_mv"] = dict(at_shapes=single, shape=first, **single[first])
    first = next(iter(batched))
    stats["bell_mv_batched"] = dict(at_shapes=batched, shape=first, **batched[first])


def _counted(counters):
    """Every launch counter's value, by kernel."""
    return {k: v for c in counters.values() for k, v in c.items()}


def _affine_line(tag, rep, ref, jax_cpu, took=None):
    err = abs(rep.objective - ref) / abs(ref)
    say(f"[{tag}] status {rep.status}  iterations {rep.summary['iterations']}"
        f" (the JAX package on the CPU: {jax_cpu})  objective {rep.objective:.12f}"
        f"  objective error {err:.3e}  residual {rep.summary['residual']:.3e}"
        + ("" if took is None else f"  {took:.3f} s"))
    return err


def _timed_solve(cimt, problem, solver, **kw):
    torch.cuda.synchronize()
    t = time.perf_counter()
    rep = cimt.solve(problem, solver, **kw)
    torch.cuda.synchronize()
    return rep, time.perf_counter() - t


def _check_solve(tag, rep, ref_obj):
    gap = rep.summary["gap"]
    obj_err = abs(rep.objective - ref_obj) / (1.0 + abs(ref_obj))
    say(f"[{tag}] status {rep.status}  iterations {rep.summary['iterations']}"
        f"  phase1 {rep.summary['phase1_iterations']}  gap {gap:.3e}"
        f"  objective {rep.objective:.12f}  objective error {obj_err:.3e}"
        f"  krylov_escalated {rep.summary.get('krylov_escalated', False)}")
    if not (np.isfinite(rep.result.x.cpu().numpy()).all() and gap <= 1e-8
            and obj_err <= 1e-7):
        raise AssertionError(f"{tag}: gap {gap} / objective error {obj_err}")


def phase_afiro(cimt):
    rep = cimt.solve(AFIRO, "pdas_dd", device="cuda", dtype=torch.float32)
    rel = abs(rep.objective - AFIRO_OPTIMUM) / abs(AFIRO_OPTIMUM)
    say(f"[afiro] relative objective error {rel:.3e}")
    if not rel <= 1e-7:
        raise AssertionError(f"afiro objective {rep.objective}")
    _check_solve("afiro", rep, AFIRO_OPTIMUM)


def phase_afiro_f64(cimt, counters):
    """afiro in f64 on the card, dense and fully sparse (block 16): the
    plain forms carry it, no kernel launches."""
    before = _counted(counters)
    for tag, kw in (("afiro f64", {}), ("sparse afiro f64", dict(sparse=True, block=16))):
        rep = cimt.solve(AFIRO, "pdas_dd", device="cuda", dtype=torch.float64, **kw)
        _check_solve(tag, rep, AFIRO_OPTIMUM)
        rel = abs(rep.objective - AFIRO_OPTIMUM) / abs(AFIRO_OPTIMUM)
        after = _counted(counters)
        say(f"[{tag}] relative objective error {rel:.3e} (limit 1e-7); "
            f"{rep.summary['phase1_iterations']} + {rep.summary['iterations']} iterations"
            f" (the CPU takes 22 + 7); x is {rep.result.x.dtype} on {rep.result.x.device};"
            f" kernel launches {sum(after.values()) - sum(before.values())}")
        if not (rel <= 1e-7 and after == before and rep.result.x.is_cuda
                and rep.result.x.dtype == torch.float64):
            raise AssertionError(f"{tag}: objective {rep.objective}, launches {after}")


def phase_pilot(cimt, dd_cuda, card):
    from cholesky_is_magic_tpu_torch.utils.testing import constructed_optimum_lp

    sf, info = constructed_optimum_lp("pilot", seed=0)
    say(f"[pilot] constructed optimum LP {sf.ncons} x {sf.nvars}, "
        f"padded to 1536 x 5120, f32")
    _reset(dd_cuda.LAUNCHES)
    rep, first_s = _timed_solve(cimt, sf, "pdas_dd", device="cuda", dtype=torch.float32)
    launches = dict(dd_cuda.LAUNCHES)
    say(f"[pilot] first solve {first_s:.3f} s, kernel launches {launches}")
    _check_solve("pilot", rep, info["objective"])
    if not all(launches[k] > 0 for k in ("mv", "rmv")):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    rep2, took = _timed_solve(cimt, sf, "pdas_dd", device="cuda", dtype=torch.float32)
    counts = (rep2.summary['phase1_iterations'], rep2.summary['iterations'])
    say(f"[pilot] second solve wall-clock {took:.3f} s "
        f"({counts[0]} + {counts[1]} iterations) on {card}")
    return launches, took, counts


def _recon_err(L, N):
    """||L·Lᵀ - N|| / ||N|| in f64."""
    L64 = L.double()
    return (torch.linalg.norm(L64 @ L64.T - N.double())
            / torch.linalg.norm(N.double())).item()


def _spd(n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    M = torch.randn(n, n, generator=g, device="cuda", dtype=torch.float64)
    return (M @ M.T / n + torch.eye(n, device="cuda", dtype=torch.float64)).float()


def phase_chol(chol, chol_cuda, dense, stats):
    """The tile kernel and the blocked potrf against the truth and their
    plain versions; the panel and Schur kernels' path and times."""
    for b in (16, 33, 64, 96, 128, 160, 256):
        N = _spd(b, b)
        T, inv = N.clone(), torch.empty_like(N)
        chol.factor_tile_(T, inv)
        Lp, Ip = chol._factor_tile_plain(N)
        truth = _recon_err(T, N)
        vs_plain = (torch.linalg.norm(T.double() @ T.double().T
                                      - Lp.double() @ Lp.double().T)
                    / torch.linalg.norm(N.double())).item()
        err = max((T - Lp).abs().max().item(), (inv - Ip).abs().max().item())
        inv_rel = ((inv - Ip).abs().max() / Ip.abs().max()).item()
        eye_err = (inv.double() @ T.double() - torch.eye(
            b, device="cuda", dtype=torch.float64)).abs().max().item()
        say(f"[chol] tile b={b}: ||LLt-N||/||N|| {truth:.3e} ({truth / EPS32:.2f} eps32,"
            f" limit 32), vs plain {vs_plain / EPS32:.2f} eps32 (limit 64),"
            f" inverse vs plain {inv_rel / EPS32:.2f} eps32 of max|inv| (limit 64),"
            f" |inv.L - I| {eye_err / EPS32:.2f} eps32 (limit 64),"
            f" max abs err vs plain {err:.3e}")
        if not (truth <= 32 * EPS32 and vs_plain <= 64 * EPS32
                and inv_rel <= 64 * EPS32 and eye_err <= 64 * EPS32
                and bool((torch.triu(T, 1) == 0).all())
                and bool((torch.triu(inv, 1) == 0).all())):
            raise AssertionError(f"tile kernel at b={b}")
        if b in (128, 256):
            work = N.clone()
            tile = lambda: (work.copy_(N), chol.factor_tile_(work, inv))  # noqa: E731
            plain = lambda: chol._factor_tile_plain(N)  # noqa: E731
            p1, k1, k2, p2 = (_median_ms(f) for f in (plain, tile, tile, plain))
            # Reads the lower triangle, writes L and L⁻¹; b³/3 flops for the
            # factor and b³/3 for the inverse.
            bound = _bound(4 * (b * (b + 1) // 2 + 2 * b * b), 2 * b**3 / 3)
            say(f"[chol] tile b={b} median ms (with the tile copy): "
                f"factor_tile_ {k1:.4f} {k2:.4f}  plain (cholesky_ex + "
                f"solve_triangular) {p1:.4f} {p2:.4f} ({-(-b // chol_cuda.BLOCK)}"
                f" tile-kernel launches per tile; bound of the factor alone"
                f" {bound['bound_ms']:.6f}, {bound['bound_by']})")
        if b == 128:
            alone = _tile_kernel_ms(chol_cuda, N)
            say(f"[chol] tile kernel alone at b=128, back-to-back launches: "
                f"{alone:.4f} ms each (bound {bound['bound_ms']:.6f}, {bound['bound_by']})")
            stats["potrf_tile"] = dict(
                max_abs_err=err, ms=min(k1, k2), plain_ms=min(p1, p2), library_ms=None,
                alone_ms=alone, **bound)
    for b, pivot in ((64, 30), (256, 200)):
        bad = _spd(b, 5)
        bad[pivot, pivot] = -1.0
        inv = torch.empty_like(bad)
        chol.factor_tile_(bad, inv)
        ok = bool(torch.isfinite(bad).all())
        all_nan = bool(torch.isnan(bad).all()) and bool(torch.isnan(inv).all())
        say(f"[chol] non-PD tile b={b}, pivot {pivot}: ok {ok} (L and inverse all"
            f" NaN {all_nan})")
        if ok or not all_nan:
            raise AssertionError(f"a non-PD tile (b={b}) did not come back all NaN")

    # The dense path of the panel and Schur kernels: factorize(use_pallas).
    from cholesky_is_magic_tpu_torch.ingest.device import to_device_lp
    from cholesky_is_magic_tpu_torch.utils.testing import constructed_optimum_lp

    sf, _ = constructed_optimum_lp("pilot", seed=0)
    lp = to_device_lp(sf, pad_multiple=128, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(11)
    d = 0.5 + torch.rand(lp.A.shape[1], generator=g, device="cuda")
    N = dense.normal_matrix(lp.A, d, (~lp.row_mask).float())
    m = sf.ncons  # 1441: rows not 16-byte aligned, a last panel 33 wide
    launches = _check_use_pallas(chol, chol_cuda, dense, N)
    _check_use_pallas(chol, chol_cuda, dense, N[:m, :m].contiguous())

    # The first panel step on its own: kernel vs its plain form.
    b = chol_cuda.BLOCK
    A0 = N.clone()
    inv = torch.empty((b, b), device="cuda")
    chol.factor_tile_(A0[:b, :b], inv)
    panel0 = A0[b:, :b].clone()
    P_plain = panel0 @ inv.T
    work = A0.clone()
    chol_cuda.potrf_panel_(work[b:, :b], inv, work[:b, b:])
    P = work[b:, :b].clone()
    S_plain = torch.tril(A0[b:, b:] - P @ P.T)
    chol_cuda.potrf_schur_(work[b:, b:], P)
    S = torch.tril(work[b:, b:])
    for name, got, plain, mag in (
        ("potrf_panel", P, P_plain, panel0.abs() @ inv.T.abs()),
        ("potrf_schur", S, S_plain,
         torch.tril(A0[b:, b:].abs() + P.abs() @ P.abs().T)),
    ):
        err = (got - plain).abs()
        ratio = (err / (EPS32 * mag + 1e-30)).max().item()
        say(f"[chol] {name} first panel step vs plain: max abs err "
            f"{err.max().item():.3e}, max err / (eps32 sum|terms|) {ratio:.2f}"
            f" (limit {2 * b})")
        if not ratio <= 2 * b:
            raise AssertionError(f"{name} disagrees with its plain version")
        stats[name] = {"max_abs_err": err.max().item()}
    # The Schur kernel's sums, bit for bit, and the panel loop's two launches
    # (the next block column, then the block beyond it) against one.
    exact = torch.equal(S, torch.tril(chol_cuda.schur_fma_plain(A0[b:, b:], P)))
    split = A0[b:, b:].clone()
    chol_cuda.potrf_schur_(split, P, cols=b)
    chol_cuda.potrf_schur_(split[b:, b:], P[b:])
    split_same = torch.equal(torch.tril(split), S)
    say(f"[chol] potrf_schur first panel step: bit-equal to its fma chains in plain"
        f" PyTorch {exact}; two launches (columns < {b}, then the rest) bit-equal to"
        f" one {split_same}; sha256 {_digest(S)}")
    if not (exact and split_same):
        raise AssertionError("potrf_schur differs from its own sums")
    src = A0[b:, b:].clone()
    out = torch.empty_like(src)
    scratch = A0.clone()  # the panel and its strip at the matrix's row stride
    rows = panel0.shape[0]
    alone = [_panel_step_ms(chol_cuda, A0, inv, P) for _ in range(2)]
    matmul_b2b = [_panel_step_ms(chol_cuda, A0, inv, P, matmul=True) for _ in range(2)]
    matmul_ms = _median_ms(lambda: panel0 @ inv.T)
    # The panel: read it and the inverse's lower triangle, write it and its
    # strip; b(b+1)/2 FMAs per row.  The Schur step: read and write S's lower
    # triangle, read P; b FMAs per lower entry.
    stats["potrf_panel"].update(
        ms=min(alone),
        ms_with_copy=_median_ms(lambda: (scratch[b:, :b].copy_(panel0),
                                         chol_cuda.potrf_panel_(scratch[b:, :b], inv,
                                                                scratch[:b, b:]))),
        plain_ms=min(matmul_b2b), library_ms=min(matmul_b2b),
        **_bound(4 * (3 * rows * b + b * (b + 1) // 2), rows * b * (b + 1)))
    tri = rows * (rows + 1) // 2
    schur_runs = {
        "kernel": lambda r: chol_cuda.potrf_schur_(src, P),
        "plain": lambda r: torch.tril(src - P @ P.T),
        "addmm": lambda r: torch.addmm(src, P, P.T, alpha=-1, out=out),
        "kernel, next block column": lambda r: chol_cuda.potrf_schur_(src, P, cols=b),
        "kernel, beyond it": lambda r: chol_cuda.potrf_schur_(src[b:, b:], P[b:]),
    }
    # In place on one buffer (the entries drift by P·Pᵀ per launch, far from
    # overflow), in two turns of opposite order.
    sch = {k: [] for k in schur_runs}
    for turn in (list(schur_runs), list(schur_runs)[::-1]):
        for k in turn:
            sch[k].append(_back_to_back_ms(schur_runs[k], 100))
    stats["potrf_schur"].update(
        ms=min(sch["kernel"]), plain_ms=min(sch["plain"]), library_ms=min(sch["addmm"]),
        ms_with_launch=_median_ms(lambda: chol_cuda.potrf_schur_(src, P)),
        **_bound(4 * (2 * tri + rows * b), 2 * tri * b))
    pan, sc = stats["potrf_panel"], stats["potrf_schur"]
    say(f"[chol] first panel step ({rows} x {b}) median ms: panel kernel alone"
        f" (back-to-back, fresh copies) {alone[0]:.4f} {alone[1]:.4f}, torch.matmul"
        f" the same way {matmul_b2b[0]:.4f} {matmul_b2b[1]:.4f}; panel kernel with"
        f" a restoring copy {pan['ms_with_copy']:.4f}, torch.matmul alone {matmul_ms:.4f}"
        f" (bound {pan['bound_ms']:.5f})")
    say(f"[chol] first trailing update ({rows} x {rows}, depth {b}), back to back behind"
        f" a sleep, ms: " + "; ".join(f"{k} {v[0]:.4f} {v[1]:.4f}" for k, v in sch.items())
        + f"; kernel with the host's launch in it {sc['ms_with_launch']:.4f}"
        f" (bound {sc['bound_ms']:.5f}, {100 * sc['bound_ms'] / sc['ms']:.0f}% of it)")
    return launches


def _digest(x) -> str:
    return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:16]


def _check_use_pallas(chol, chol_cuda, dense, N):
    """factorize(N, use_pallas=True) with its launch counters reset before
    and read after, held against the f64 truth (32·eps32) and the plain
    blocked_cholesky and cholesky_ex (64·eps32); its launches against the
    panel loop's count (per step one Schur launch on the next block column,
    and one more on the rest except at the last step); a non-PD copy; median
    times.  Returns the launches."""
    n = N.shape[0]
    steps = -(-n // chol_cuda.BLOCK) - 1
    _reset(chol_cuda.LAUNCHES)
    f = dense.factorize(N, use_pallas=True)
    torch.cuda.synchronize()
    launches = dict(chol_cuda.LAUNCHES)
    Lb = chol.blocked_cholesky(N)
    Lx = torch.linalg.cholesky_ex(N)[0]
    errs = {k: _recon_err(L, N) for k, L in (("kernel", f.L), ("blocked", Lb),
                                               ("cholesky_ex", Lx))}
    N64 = f.L.double() @ f.L.double().T
    vs = {k: (torch.linalg.norm(N64 - L.double() @ L.double().T)
              / torch.linalg.norm(N.double())).item() for k, L in
          (("blocked", Lb), ("cholesky_ex", Lx))}
    say(f"[chol] factorize(use_pallas=True) on N {tuple(N.shape)}: ok {bool(f.ok)},"
        f" launches {launches}, ||LLt-N||/||N|| in eps32: "
        + ", ".join(f"{k} {v / EPS32:.2f}" for k, v in errs.items())
        + "; kernel vs plain reconstructions in eps32: "
        + ", ".join(f"{k} {v / EPS32:.2f}" for k, v in vs.items())
        + f"; max abs err vs blocked {(f.L - Lb).abs().max().item():.3e},"
          f" vs cholesky_ex {(f.L - Lx).abs().max().item():.3e}; sha256 {_digest(f.L)}")
    bad = N.clone()
    bad[n // 2, n // 2] = -1.0
    bad_ok = bool(dense.factorize(bad, use_pallas=True).ok)
    say(f"[chol] n={n} with a negative diagonal entry: ok {bad_ok}")
    if not (bool(f.ok) and not bad_ok and errs["kernel"] <= 32 * EPS32
            and max(vs.values()) <= 64 * EPS32
            and launches == {"potrf_tile": steps + 1, "potrf_tile_batched": 0,
                             "potrf_panel": steps, "potrf_schur": 2 * steps - 1}):
        raise AssertionError(f"factorize(use_pallas=True) on the card at n={n}")
    kt = [_median_ms(lambda: chol.cholesky(N), 10) for _ in range(2)]
    xt = [_median_ms(lambda: torch.linalg.cholesky_ex(N), 10) for _ in range(2)]
    bt = _median_ms(lambda: chol.blocked_cholesky(N), 3)
    # The card's own time: ~45 launches per potrf, queued behind a sleep.
    kd = [_back_to_back_ms(lambda r: chol.cholesky(N), 10, sleep_ms=2) for _ in range(2)]
    xd = [_back_to_back_ms(lambda r: torch.linalg.cholesky_ex(N), 10, sleep_ms=2)
          for _ in range(2)]
    full_bound = _bound(4 * n * (n + 1), n**3 / 3)["bound_ms"]
    say(f"[chol] n={n} median ms: kernel potrf {kt[0]:.4f} {kt[1]:.4f}  "
        f"cholesky_ex {xt[0]:.4f} {xt[1]:.4f}  plain blocked_cholesky {bt:.1f}"
        f"  (bound {full_bound:.4f} ms, n³/3 flops); back-to-back behind a sleep:"
        f" kernel potrf {kd[0]:.4f} {kd[1]:.4f}  cholesky_ex {xd[0]:.4f} {xd[1]:.4f}")
    return launches


def phase_assembly(eng, stats):
    """The assembly kernel on the m = 16384 engine's schedule."""
    from cholesky_is_magic_tpu_torch.tools.probe_assembly_kernel import pass_launchers

    lengths = torch.diff(eng.asm_run_start)
    say(f"[assembly] schedule: {eng.n_pairs} pairs in {lengths.numel()} runs, mean run "
        f"{lengths.double().mean().item():.2f}, longest {int(lengths.max())}")
    g = torch.Generator(device="cuda").manual_seed(12)
    n = int(eng.asm_k.max().item()) + 1
    d = 10.0 ** (3 * torch.rand(n, generator=g, device="cuda") - 1.5)
    boost = torch.zeros(AT_SCALE_M, device="cuda")
    t1 = eng.assemble_pairs(d, boost)
    t2 = eng.assemble_pairs(d, boost)
    plain = eng._assemble_pairs_plain(d, boost)
    mag = torch.zeros_like(plain).reshape(-1).index_add_(
        0, eng.asm_dst_flat, (eng.asm_w * (d * d)[eng.asm_k]).abs())
    mag = mag + eng._assemble_pairs_plain(torch.zeros_like(d), boost).reshape(-1)
    err = (t1 - plain).abs().reshape(-1)
    ratio = (err / (EPS32 * mag + 1e-30)).max().item()
    same = torch.equal(t1, t2)
    say(f"[assembly] {eng.n_pairs} pairs into {eng.NT + 1} tiles of {eng.b}: "
        f"max abs err vs plain {err.max().item():.3e}, max err / (eps32 sum|w d^2|)"
        f" {ratio:.3f} (limit 8), bit-identical across two runs {same}")
    if not (ratio <= 8 and same):
        raise AssertionError("assemble_pairs disagrees with its plain version")
    # Kernel, plain version and library call alike: the card's own time
    # (asleep until the host has queued the launches), and with the host's
    # launch time in it.  The kernel's zeros and runs apart come from two
    # copies of its source built for that alone.
    kern, plain = (lambda: eng.assemble_pairs(d, boost),
                   lambda: eng._assemble_pairs_plain(d, boost))
    vals = eng.asm_w * (d * d)[eng.asm_k]
    flat = torch.zeros_like(t1).reshape(-1)
    k = [_median_ms(kern, lead=0.2) for _ in range(2)]
    p = [_median_ms(plain, lead=2.0) for _ in range(2)]  # ~50 launches to queue
    kh, ph = ([_median_ms(f) for _ in range(2)] for f in (kern, plain))
    lib = _median_ms(lambda: flat.index_add_(0, eng.asm_dst_flat, vals), lead=0.2)
    zeros, runs = (_median_ms(f, lead=0.2) for f in pass_launchers(eng, d, boost))
    # What the kernel reads once (its 32-bit schedule, the weights, d, the
    # boost) and the tiles written once; 3 flops per pair.  Beside it the same
    # count over the engine's int64 arrays, which the plain version and the
    # kernel before the 32-bit schedule read.
    sched = eng._kernel_schedule
    bound = _bound(_nbytes(eng.asm_w, *sched[:5], d, boost, t1), 3 * eng.n_pairs)
    bound64 = _bound(_nbytes(eng.asm_w, eng.asm_k, eng.asm_run_start, eng.asm_run_dst,
                             d, boost, eng.diag_panel, eng.pperm, t1), 3 * eng.n_pairs)
    say(f"[assembly] median ms, card asleep until queued: kernel {k[0]:.4f} {k[1]:.4f}"
        f" (its zeros alone {zeros:.4f}, its runs alone {runs:.4f})  plain {p[0]:.4f}"
        f" {p[1]:.4f}  index_add_ of the finished products alone {lib:.4f}; with the"
        f" host's launches in it: kernel {kh[0]:.4f} {kh[1]:.4f}  plain {ph[0]:.4f}"
        f" {ph[1]:.4f}; bound {bound['bound_ms']:.4f} ({bound64['bound_ms']:.4f} over the"
        f" int64 arrays)")
    stats["assemble_pairs"] = dict(max_abs_err=err.max().item(), ms=min(k),
                                   plain_ms=min(p), library_ms=lib,
                                   ms_with_launch=min(kh),
                                   plain_ms_with_launch=min(ph), **bound)


def _same_tiles(got, want):
    """Equal bit for bit (the sign of a zero too), NaNs in the same places."""
    g0, w0 = torch.nan_to_num(got), torch.nan_to_num(want)
    return (torch.equal(torch.isnan(got), torch.isnan(want)) and torch.equal(g0, w0)
            and torch.equal(torch.signbit(g0), torch.signbit(w0)))


def phase_tile_schur(chol_cuda, tiled_cuda, stats):
    """The tile engine's Schur kernel at QAP15's widest panel on 32 lanes:
    each lane's (NT+1, 128, 128) tiles, the panel's 34 tiles and a
    destination of its own for each of their 595 pairs.  Bit for bit
    against ``chol_cuda.tile_schur_fma_plain`` on three lanes, batched,
    through ``cim::tile_schur`` under vmap and on one lane alone; then
    CUDA-event medians (the L2 cache flushed, the card asleep until the
    launches are queued) of the kernel, the plain four-launch chain it
    replaces and the SGEMM of that chain alone on gathered operands, beside
    ``lpbench.schur.update``'s bound."""
    from lpbench import schur as lpschur

    rows, lanes, b = SCHUR_ROWS, SCHUR_LANES, 128
    pa, pb = zip(*[(i, j) for i in range(rows) for j in range(i + 1)])
    pairs = len(pa)
    a, bt, dst = (torch.tensor(x, device="cuda")
                  for x in (pa, pb, range(rows, rows + pairs)))
    g = torch.Generator(device="cuda").manual_seed(23)
    L0 = 0.1 * torch.randn(lanes, rows + pairs + 1, b, b, generator=g, device="cuda")
    some = torch.tensor([0, lanes // 2, lanes - 1], device="cuda")
    want = chol_cuda.tile_schur_fma_plain(L0[some][:, dst], L0[some][:, a], L0[some][:, bt])
    _reset(tiled_cuda.LAUNCHES)
    L = L0.clone()
    tiled_cuda.tile_schur_batched_(L, a, bt, dst)
    same = {"batched": _same_tiles(L[some][:, dst], want)}

    def lane(x):
        y = x.clone()
        tiled_cuda.tile_schur(y, a, bt, dst, per_lane=True)
        return y

    L = torch.func.vmap(lane)(L0)
    same["vmap"] = _same_tiles(L[some][:, dst], want)
    one = L0[0].clone()
    tiled_cuda.tile_schur_(one, a, bt, dst)
    same["one lane"] = _same_tiles(one[dst], want[0])
    launched = dict(tiled_cuda.LAUNCHES)
    err = (L[some][:, dst] - want).abs().max().item()
    del want, one
    if not (all(same.values()) and launched["tile_schur"] == 1
            and launched["tile_schur_batched"] == 2):
        raise AssertionError(f"tile_schur: bit-equal {same}, launches {launched}")
    flush = torch.zeros(2 * L2_BYTES // 4, device="cuda")
    L = L0.clone()
    Ga, Gb = L0[:, a], L0[:, bt].transpose(-1, -2)
    U = torch.empty_like(Ga)
    kern = lambda: tiled_cuda.tile_schur_batched_(L, a, bt, dst)  # noqa: E731
    kern1 = lambda: tiled_cuda.tile_schur_(L[0], a, bt, dst)  # noqa: E731

    def chain():
        L.index_add_(1, dst, torch.matmul(L[:, a], L[:, bt].transpose(-1, -2)), alpha=-1)

    p1, k1, k2, p2 = (_median_ms(f, reps=10, flush=flush, lead=1.0)
                      for f in (chain, kern, kern, chain))
    lib = _median_ms(lambda: torch.matmul(Ga, Gb, out=U), reps=10, flush=flush, lead=1.0)
    o1, o2 = (_median_ms(kern1, reps=10, flush=flush, lead=0.2) for _ in range(2))
    bound = lpschur.update(lanes, b, pairs, rows)
    bound1 = lpschur.update(1, b, pairs, rows)
    share = 100 * bound["ms"] / min(k1, k2)
    say(f"[tile schur] QAP15's widest panel: {rows} row tiles, {pairs} pairs, b {b},"
        f" {lanes} lanes: bit-equal to tile_schur_fma_plain on lanes"
        f" {some.tolist()} {same}; launches {launched}; median ms kernel {k1:.4f}"
        f" {k2:.4f}  plain chain (gathers, SGEMM, index_add_) {p1:.4f} {p2:.4f}  the"
        f" chain's SGEMM alone {lib:.4f}  bound {bound['ms']:.4f} ({bound['by']}),"
        f" {share:.2f}% of it; one lane: kernel {o1:.4f} {o2:.4f}  bound"
        f" {bound1['ms']:.4f} ({bound1['by']})")
    stats["tile_schur_batched"] = dict(max_abs_err=err, ms=min(k1, k2), plain_ms=min(p1, p2),
                                       library_ms=lib, bound_ms=bound["ms"],
                                       bound_by=bound["by"], roofline_pct=share)
    stats["tile_schur"] = dict(max_abs_err=err, ms=min(o1, o2), plain_ms=None,
                               library_ms=None, bound_ms=bound1["ms"],
                               bound_by=bound1["by"])
    del L, L0, Ga, Gb, U, flush
    torch.cuda.empty_cache()


def cell_engine(config: str, block: int):
    """The tile engine of a benchmark configuration's A at ``block``: the
    generator's structure (the values and the slack block move no tile)."""
    import scipy.sparse as sp

    from cholesky_is_magic_tpu_torch.sparse import tiled

    with open(f"lpbench/configs/{config}.json") as fh:
        cfg = json.load(fh)
    if cfg["generator"] == "qap_relaxation":
        from lpbench.gen import qap_relaxation as gen

        rows, cols, vals, m, n = gen.structure(cfg["n"])
    else:
        from lpbench.gen import constructed_optimum as gen

        base = gen.base_instance(cfg["m"], cfg["n_struct"], cfg["matrix_seed"],
                                 cfg.get("width", 8))
        rows, cols, vals, m, n = (base[k] for k in ("rows", "cols", "vals", "m", "n"))
    A = sp.csc_matrix((vals, (rows, cols)), shape=(m, n))
    return tiled.engine_for_sparse(A, block=block, device="cuda")


def solve_operands(eng, lanes: int, seed: int):
    """Random (L tiles, inverse tiles, right-hand sides) of ``lanes`` lanes
    on the engine's pattern: off-diagonal entries ~ N(0, 1/(4b)²), each
    inverse lower triangular with a unit diagonal and entries ~ N(0,
    1/(4b)²) below, as the tile factor leaves its upper triangle zero; the
    solution stays of the right-hand side's size through every panel."""
    b, B = eng.b, eng.B
    g = torch.Generator(device="cuda").manual_seed(seed)
    L = torch.randn(lanes, eng.NT + 1, b, b, generator=g, device="cuda") / (4 * b)
    inv = torch.tril(torch.randn(lanes, B, b, b, generator=g, device="cuda"), -1) / (4 * b)
    inv += torch.eye(b, device="cuda")
    rhs = torch.randn(lanes, B * b, generator=g, device="cuda")
    return L, inv, rhs


def phase_tile_solve(tiled_cuda, stats):
    """The tile engine's solve kernel at both fleets' shapes: 64 lanes of
    pds-10's engine and 32 of qap15's, block 128.  Bit for bit against
    ``tiled_cuda.tile_solve_plain`` on three lanes (one with a NaN tile),
    batched, through ``TiledCholesky.solve`` under vmap and on one lane
    alone; then CUDA-event medians (the L2 cache flushed) of both passes
    over every lane beside the plain loop it replaces (``TiledCholesky.solve``
    under vmap with the kernel's route off: the host's launches in it) and
    ``tile_solve_roofline``'s bound."""
    from lpbench.drive import HERE, load

    metric = load(HERE, "metrics", "tile_solve_roofline")
    flush = torch.zeros(2 * L2_BYTES // 4, device="cuda")
    for config, lanes in (("pds-10", 64), ("qap15", 32)):
        t0 = time.perf_counter()
        eng = cell_engine(config, 128)
        analysis_s = time.perf_counter() - t0
        L, inv, rhs = solve_operands(eng, lanes, 25)
        fwd, bwd = (tiled_cuda.SolvePass(eng.fwd_ids, eng.fwd_j, eng.fwd_n, eng.NT - eng.B),
                    tiled_cuda.SolvePass(eng.rows_ids, eng.rows_i, eng.rows_n, eng.NT - eng.B))
        some = [0, lanes // 2, lanes - 1]
        nan_tile = next(int(eng.rows_ids[k, 0]) for k in range(eng.B) if eng._n_rows[k])
        L[some[2], nan_tile] = float("nan")
        want = tiled_cuda.tile_solve_plain(L[some], inv[some], rhs[some], fwd, bwd)
        _reset(tiled_cuda.LAUNCHES)
        got = tiled_cuda._tile_solve_lanes(L, inv, rhs, fwd, bwd, "tile_solve_batched")
        same = {"batched": _same_tiles(got[some], want)}
        solve = lambda x, i, r: eng.solve(x, i, r)  # noqa: E731
        same["vmap"] = _same_tiles(torch.func.vmap(solve)(L, inv, rhs)[some], want)
        same["one lane"] = _same_tiles(eng.solve(L[0], inv[0], rhs[0]), want[0])
        launched = dict(tiled_cuda.LAUNCHES)
        nan_lane = bool(torch.isnan(got[some[2]]).any())
        if not (all(same.values()) and nan_lane and launched["tile_solve"] == 2
                and launched["tile_solve_batched"] == 4):
            raise AssertionError(f"tile_solve {config}: bit-equal {same}, NaN lane {nan_lane},"
                                 f" launches {launched}")
        L[some[2]] = torch.randn_like(L[some[2]]) / (4 * 128)
        kern = lambda: tiled_cuda._tile_solve_lanes(  # noqa: E731
            L, inv, rhs, fwd, bwd, "tile_solve_batched")
        kern1 = lambda: tiled_cuda._tile_solve_lanes(  # noqa: E731
            L[:1], inv[:1], rhs[:1], fwd, bwd, "tile_solve")
        takes = tiled_cuda.takes_tile_solve
        tiled_cuda.takes_tile_solve = lambda *a: False
        try:
            plain = lambda: torch.func.vmap(solve)(L, inv, rhs)  # noqa: E731
            pl1 = _median_ms(plain, reps=3, flush=flush)
        finally:
            tiled_cuda.takes_tile_solve = takes
        k1, k2 = (_median_ms(kern, reps=10, flush=flush, lead=0.5) for _ in range(2))
        o1 = _median_ms(kern1, reps=10, flush=flush, lead=0.2)
        bound = [metric.bound(n, 128, eng.B, eng.NT - eng.B) for n in (lanes, 1)]
        ms_bound = [2 * x["ms"] for x in bound]
        share = 100 * ms_bound[0] / min(k1, k2)
        say(f"[tile solve] {config}'s engine (analysis {analysis_s:.1f} s): B {eng.B}, NT"
            f" {eng.NT}, {eng.NT - eng.B} off-diagonal tiles, widest step"
            f" {max(eng._n_fwd)} / {max(eng._n_rows)} tiles, b 128, {lanes} lanes, cluster"
            f" {tiled_cuda.tile_solve_cluster(128, lanes)} (one lane:"
            f" {tiled_cuda.tile_solve_cluster(128, 1)}): bit-equal to tile_solve_plain on"
            f" lanes {some} (lane {some[2]} with a NaN tile) {same}; launches {launched};"
            f" median ms both passes {k1:.4f} {k2:.4f}  the plain loop under vmap, host"
            f" launches in it, {pl1:.2f}  bound {ms_bound[0]:.4f} ({bound[0]['by']}),"
            f" {share:.2f}% of it; one lane {o1:.4f}, bound {ms_bound[1]:.4f}")
        if config == "pds-10":
            stats["tile_solve_batched"] = dict(
                max_abs_err=0.0, ms=min(k1, k2), plain_ms=pl1, library_ms=None,
                bound_ms=ms_bound[0], bound_by=bound[0]["by"], roofline_pct=share)
            stats["tile_solve"] = dict(max_abs_err=0.0, ms=o1, plain_ms=None,
                                       library_ms=None, bound_ms=ms_bound[1],
                                       bound_by=bound[1]["by"])
        else:
            stats["tile_solve_batched"]["qap15"] = dict(ms=min(k1, k2), plain_ms=pl1,
                                                        bound_ms=ms_bound[0],
                                                        roofline_pct=share)
        del L, inv, rhs, got, want, eng
        torch.cuda.empty_cache()
    del flush


def phase_sparse_afiro(cimt):
    rep = cimt.solve(AFIRO, "pdas_dd", sparse=True, block=16, device="cuda",
                     max_iters=300)
    rel = abs(rep.objective - AFIRO_OPTIMUM) / abs(AFIRO_OPTIMUM)
    say(f"[sparse afiro] status {rep.status}  iterations "
        f"{rep.summary['phase1_iterations']} + {rep.summary['iterations']}"
        f"  gap {rep.summary['gap']:.3e}  objective {rep.objective:.12f}"
        f"  relative error {rel:.3e} (limit 1e-5)")
    if not rel <= 1e-5:
        raise AssertionError(f"sparse afiro objective {rep.objective}")


def build_at_scale_engine(sf=None, info=None, block=128):
    """The m = 16384 LP (made unless given) and its engine at ``block``, the
    host analysis and the pair schedule timed on their own."""
    import scipy.sparse as sp

    from cholesky_is_magic_tpu_torch.ingest.standard_form import scale_constraints
    from cholesky_is_magic_tpu_torch.sparse import native
    from cholesky_is_magic_tpu_torch.sparse.symbolic import analyze
    from cholesky_is_magic_tpu_torch.sparse.tiled import TiledCholesky
    from cholesky_is_magic_tpu_torch.utils.testing import constructed_optimum_lp

    t = time.perf_counter()
    if sf is None:
        sf, info = constructed_optimum_lp(m=AT_SCALE_M, seed=0)
    t_lp = time.perf_counter() - t
    vals, _ = scale_constraints(sf.a_rows, sf.a_vals, sf.b)
    A = sp.csc_matrix((vals, (sf.a_rows, sf.a_cols)), shape=(sf.ncons, sf.nvars))
    t = time.perf_counter()
    plan = analyze(A, block=block)
    t_an = time.perf_counter() - t
    t = time.perf_counter()
    eng = TiledCholesky(plan, device="cuda")
    t_sched = time.perf_counter() - t
    t = time.perf_counter()
    eng.build_ell_assembly(A)
    torch.cuda.synchronize()
    t_pairs = time.perf_counter() - t
    say(f"[at scale] constructed optimum LP {sf.ncons} x {sf.nvars}, nnz {len(sf.a_vals)}"
        f" (built in {t_lp:.3f} s); native symbolic library {native.available()}")
    say(f"[at scale] block {block}: host analysis {t_an:.3f} s, tile schedules {t_sched:.3f} s,"
        f" pair schedule {t_pairs:.3f} s: {eng.B} panels of {eng.b},"
        f" {eng.NT} resident tiles, {eng.n_pairs} pairs")
    return sf, info, eng


def phase_at_scale(cimt, sf, info, counters, card, kw=AT_SCALE_KW):
    """One counted and checked solve at ``kw``, then one more, timed.
    Returns the launches and the second report."""
    tag = f"at scale, block {kw['block']}"
    _reset(*counters.values())
    rep, first_s = _timed_solve(cimt, sf, "pdas_dd", **kw)
    launches = _counted(counters)
    ref = info["objective"]
    gap = rep.summary["gap"]
    obj_err = abs(rep.objective - ref) / abs(ref)
    say(f"[{tag}] first solve {first_s:.3f} s, kernel launches {launches}")
    say(f"[{tag}] status {rep.status}  iterations {rep.summary['phase1_iterations']}"
        f" + {rep.summary['iterations']}  gap {gap:.3e}  objective {rep.objective:.10f}"
        f"  objective error {obj_err:.3e}  krylov_escalated "
        f"{rep.summary.get('krylov_escalated', False)}  repair "
        f"{ {k: float(v) for k, v in rep.result.extra.get('entry_repair', {}).items()} }")
    if not (launches["potrf_tile"] > 0 and launches["assemble_pairs"] > 0
            and launches["bell_mv"] > 0):
        raise AssertionError(f"a kernel of the sparse path never launched: {launches}")
    if not (np.isfinite(rep.result.x.cpu().numpy()).all() and gap <= 1e-6
            and obj_err <= 1e-5):
        raise AssertionError(f"{tag}: gap {gap} / objective error {obj_err}")
    rep2, took = _timed_solve(cimt, sf, "pdas_dd", **kw)
    say(f"[{tag}] second solve wall-clock {took:.3f} s "
        f"({rep2.summary['phase1_iterations']} + {rep2.summary['iterations']} "
        f"iterations, gap {rep2.summary['gap']:.3e}) on {card}")
    return launches, rep2


def _attribute(cimt, sf, kw, solver="pdas_dd"):
    """One more at-scale solve under ``diag.recording()``: per stage (a span
    of the program's) its host self time and calls, no synchronize; the
    tile kernel, run once per panel step where no span is opened, by its
    launches alone (None seconds).  Returns the solve's seconds, the
    stages and the report."""
    from cholesky_is_magic_tpu_torch.utils import diag

    setup = "make_affine_state_sparse" if solver == "affine" else "make_pdas_sparse"
    stages = [(f"setup: {setup} (analysis, schedules, ELL/BELL)", "setup.lane_state"),
              ("assembly (kernel)", "normal.assemble"),
              ("panel loop (factorize)", "normal.factorize"),
              ("  of which tile kernel", None),
              ("raw tile solves", "normal.solve"),
              ("block-ELL dd products", "ops.bell.dd_matvec"),
              ("block-ELL f32 products", "ops.bell.matvec"),
              ("ELL dd products", "ops.ell.dd_matvec"),
              ("ELL f32 products", "ops.ell.matvec")]
    torch.cuda.synchronize()
    t = time.perf_counter()
    with diag.recording() as rec:
        rep = cimt.solve(sf, solver, **kw)
        torch.cuda.synchronize()
    total = time.perf_counter() - t
    totals = rec.totals()
    acc = {}
    for label, name in stages:
        if name is None:
            acc[label] = (None, rec.launches["potrf_tile"] + rec.launches["potrf_tile_batched"])
        elif name in totals:
            calls, _, own = totals[name]
            acc[label] = (own, calls)
    return total, acc, rep


def _say_stages(tag, acc, total):
    for label, (sec, calls) in acc.items():
        if sec is None:
            say(f"[{tag}]   {label}: {calls} launches (no span per panel step)")
        else:
            say(f"[{tag}]   {label}: {sec:.3f} s in {calls} calls "
                f"({100 * sec / total:.1f}%)")


def phase_breakdown(cimt, sf, eng, rep, chol):
    """Where an at-scale solve's time goes: a solve under the program's
    recorder (each stage's host self time), then device-busy share and CUDA-event times of one factorization and one
    raw solve at the final iterate's scaling."""
    from cholesky_is_magic_tpu_torch.solvers.pdas import make_pdas_sparse

    total, acc, rep3 = _attribute(cimt, sf, AT_SCALE_KW)
    its = rep3.summary["phase1_iterations"] + rep3.summary["iterations"]
    say(f"[breakdown] timed solve {total:.3f} s, {its} iterations "
        f"(host clock; each stage's host self time, no synchronize):")
    _say_stages("breakdown", acc, total)

    st, _ = make_pdas_sparse(sf, engine=eng, device="cuda")
    x = rep.result.x
    s = torch.sqrt(torch.clamp_min(torch.minimum(x - st.lp.l, st.lp.u - x), 1e-6))
    boost = torch.zeros(st.lp.m, device="cuda")
    tiles = eng.assemble_pairs(s, boost)
    L, invd, ok = eng.factorize(tiles)
    rhs = torch.ones(eng.B * eng.b, device="cuda")
    for fn, what in ((lambda: eng.factorize(tiles), "one factorization"),
                     (lambda: eng.solve(L, invd, rhs), "one raw solve")):
        _device_busy("breakdown", what, fn)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    Td = [tiles[int(k)].clone() for k in eng._diag_ids_np]
    ev[0].record()
    for k in range(eng.B):
        chol.factor_tile_(Td[k], invd[k])
    ev[1].record()
    torch.cuda.synchronize()
    say(f"[breakdown] {eng.B} tile-kernel launches on this factorization's "
        f"diagonal tiles: {ev[0].elapsed_time(ev[1]):.3f} ms (CUDA events), ok {bool(ok)}")


def _device_busy(tag, what, fn):
    """Profile one call of fn() after a warm-up call: wall ms, device-busy
    ms and share, kernel launches and the top device time, on one line.
    The profiler is a measurement, not a check: its own failure is reported
    and skipped; a failure of fn() propagates."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as err:
        say(f"[{tag}] {what}: device busy share not measured ({err})")
        return
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    try:
        prof.stop()
        events = list(prof.key_averages())
    except RuntimeError as err:
        say(f"[{tag}] {what}: device busy share not measured ({err})")
        return
    dev = {e.key: getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0)) for e in events}
    dev_us = sum(dev.values())
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:4]
    say(f"[{tag}] {what}: wall {wall * 1e3:.3f} ms, device busy "
        f"{dev_us / 1e3:.3f} ms ({100 * dev_us / 1e6 / wall:.1f}%), "
        f"{launches} kernel launches; top device time: "
        + ", ".join(f"{k[:40]} {us / 1e3:.3f} ms" for k, us in top))


def _factorization_ms(eng):
    """Median host-clock ms (synchronized) of one factorization of the
    engine's tiles at a seeded column scaling; ok must hold."""
    g = torch.Generator(device="cuda").manual_seed(13)
    n = int(eng.asm_k.max().item()) + 1
    d = 10.0 ** (3 * torch.rand(n, generator=g, device="cuda") - 1.5)
    tiles = eng.assemble_pairs(d, torch.zeros(AT_SCALE_M, device="cuda"))
    _, _, ok = eng.factorize(tiles)
    if not bool(ok):
        raise AssertionError(f"factorization at block {eng.b} failed")
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.factorize(tiles)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def phase_block256(cimt, sf, info, eng128, counters, card):
    """The at-scale LP at block 256: a counted, checked solve, a timed one,
    and one factorization beside block 128's."""
    kw = dict(AT_SCALE_KW, block=256)
    launches, _ = phase_at_scale(cimt, sf, info, counters, card, kw=kw)
    if not launches["potrf_tile"] > 0:
        raise AssertionError(f"block 256: the tile kernel never launched: {launches}")
    _, _, eng256 = build_at_scale_engine(sf, info, block=256)
    f128, f256 = _factorization_ms(eng128), _factorization_ms(eng256)
    say(f"[block 256] one factorization: block 128 {f128:.3f} ms ({eng128.B} panels),"
        f" block 256 {f256:.3f} ms ({eng256.B} panels) on {card}")


def _check_mv_on_pilot_normal(sf, x):
    """dd A·x on the pilot LP's own normal matrix N = A·D²·Aᵀ (1536 x 1536),
    D the slack (capped at 1e8) of the f32 affine solve's last iterate x: the
    shape and the range of entries its refined solves give the kernel.
    Against the plain version only (PLAIN_TOL): N's rows cancel past what the
    f64 truth's 1e-11 can hold."""
    from cholesky_is_magic_tpu_torch.ingest.device import to_device_lp
    from cholesky_is_magic_tpu_torch.ops import dd as ddm
    from cholesky_is_magic_tpu_torch.ops import dense

    lp = to_device_lp(sf, pad_multiple=128, device="cuda")
    if x.shape != lp.c.shape:
        raise AssertionError(f"affine pilot x {tuple(x.shape)} is not padded as "
                             f"{tuple(lp.c.shape)}")
    slack = torch.clamp(torch.minimum(x - lp.l, lp.u - x), 1e-30, 1e8)
    N = dense.normal_matrix(lp.A, torch.where(lp.col_mask, slack, 1.0),
                            (~lp.row_mask).float())
    g = torch.Generator(device="cuda").manual_seed(13)
    y = torch.randn(N.shape[0], generator=g, device="cuda")
    err = (_f64(ddm.dd_matvec(N, y)) - _f64(ddm._dd_matvec_plain(N, y))).abs()
    ratio = (err / (EPS32**2 * (N.abs() @ y.abs()).double())).max().item()
    say(f"[affine pilot f32] mv on the pilot's normal matrix {tuple(N.shape)}"
        f" (entries up to {N.abs().max().item():.3e}): vs plain max abs err"
        f" {err.max().item():.3e}, max err / (eps32^2 sum|ax|) {ratio:.3f}"
        f" (limit {PLAIN_TOL})")
    if not ratio <= PLAIN_TOL:
        raise AssertionError("mv misses its plain version on the pilot's normal matrix")


def phase_affine(cimt, counters, card):
    """solve(..., "affine") dense: afiro in f32 (rows equilibrated) and in
    f64 dense and sparse (block 16, the plain forms, no launch), then the
    pilot LP in f32 (the dd A·x kernel in every refined solve; counters
    reset before, read after) and in f64.  Returns the f32 pilot solve's
    launches."""
    from cholesky_is_magic_tpu_torch.utils.testing import constructed_optimum_lp

    rep, took = _timed_solve(cimt, AFIRO, "affine", rescale=True, pad_multiple=16,
                             max_iters=600, refine_steps=2, device="cuda",
                             dtype=torch.float32)
    err = _affine_line("affine afiro f32", rep, AFIRO_OPTIMUM, 24, took)
    if not (rep.status == "optimal" and err <= 2e-3):
        raise AssertionError(f"affine afiro f32: {rep.status}, error {err}")
    for tag, kw, jax_cpu in (("affine afiro f64", {}, 22),
                             ("sparse affine afiro f64", dict(sparse=True, block=16), 23)):
        before = _counted(counters)
        rep, took = _timed_solve(cimt, AFIRO, "affine", device="cuda",
                                 dtype=torch.float64, **kw)
        err = _affine_line(tag, rep, AFIRO_OPTIMUM, jax_cpu, took)
        x = rep.result.x
        if not (rep.status == "optimal" and err <= 1e-6 and x.is_cuda
                and x.dtype == torch.float64 and _counted(counters) == before):
            raise AssertionError(f"{tag}: {rep.status}, error {err}, x {x.dtype} "
                                 f"on {x.device}, launches {_counted(counters)}")

    sf, info = constructed_optimum_lp("pilot", seed=0)
    ref = info["objective"]
    _reset(*counters.values())
    rep, took = _timed_solve(cimt, sf, "affine", device="cuda", dtype=torch.float32)
    launches = _counted(counters)
    say(f"[affine pilot f32] first solve {took:.3f} s, kernel launches {launches}")
    err = _affine_line("affine pilot f32", rep, ref, 21)
    if not (rep.status == "optimal" and err <= 1e-3
            and np.isfinite(rep.result.x.cpu().numpy()).all()):
        raise AssertionError(f"affine pilot f32: {rep.status}, error {err}")
    if not launches["mv"] > 0:
        raise AssertionError(f"affine pilot f32: dd A·x never launched: {launches}")
    _check_mv_on_pilot_normal(sf, rep.result.x)
    rep, took = _timed_solve(cimt, sf, "affine", device="cuda", dtype=torch.float32)
    say(f"[affine pilot f32] second solve wall-clock {took:.3f} s "
        f"({rep.summary['iterations']} iterations) on {card}")
    rep, took = _timed_solve(cimt, sf, "affine", device="cuda", dtype=torch.float64)
    err = _affine_line("affine pilot f64", rep, ref, 25, took)
    if not (rep.status == "optimal" and err <= 1e-6):
        raise AssertionError(f"affine pilot f64: {rep.status}, error {err}")
    return launches


def phase_affine_at_scale(cimt, sf, info, counters, card):
    """The m = 16384 LP through solve(..., "affine", sparse=True, block=128)
    in f32: the second engine (on the raw A: affine scaling does not
    equilibrate rows) timed on its own, a counted and checked solve (the
    tile and assembly kernels must launch), and a second, timed one."""
    from cholesky_is_magic_tpu_torch.solvers.affine import make_affine_state_sparse

    torch.cuda.synchronize()
    t = time.perf_counter()
    make_affine_state_sparse(sf, block=128, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    say(f"[affine at scale] set-up of the state and its own engine "
        f"(make_affine_state_sparse, block 128): {time.perf_counter() - t:.3f} s")
    kw = dict(sparse=True, block=128, device="cuda", dtype=torch.float32)
    _reset(*counters.values())
    rep, took = _timed_solve(cimt, sf, "affine", **kw)
    launches = _counted(counters)
    say(f"[affine at scale] first solve {took:.3f} s, kernel launches {launches}")
    err = _affine_line("affine at scale", rep, info["objective"],
                       "27 at m = 2048, 23 at m = 8192, 27 at m = 16384")
    if not (launches["potrf_tile"] > 0 and launches["assemble_pairs"] > 0):
        raise AssertionError(f"a kernel of the sparse affine path never launched: {launches}")
    if not (rep.status == "optimal" and err <= 1e-3
            and np.isfinite(rep.result.x.cpu().numpy()).all()):
        raise AssertionError(f"affine at scale: {rep.status}, error {err}")
    rep, took = _timed_solve(cimt, sf, "affine", record_trace=True, **kw)
    k = rep.summary["iterations"]
    tr = {key: v[:k].cpu().numpy() for key, v in rep.result.extra["trace"].items()}
    repairs = int((tr["residual"] > 1e-6 * sf.ncons).sum())
    say(f"[affine at scale] second solve wall-clock {took:.3f} s ({k} iterations, "
        f"{repairs} of them repair steps, status {rep.status}) on {card}")
    say("[affine at scale] objective error by iteration: " + " ".join(
        f"{abs(o - info['objective']) / abs(info['objective']):.1e}" for o in tr["objective"]))
    total, acc, rep3 = _attribute(cimt, sf, kw, solver="affine")
    say(f"[affine breakdown] timed solve {total:.3f} s, {rep3.summary['iterations']} "
        f"iterations (host clock; each stage's host self time, no synchronize):")
    _say_stages("affine breakdown", acc, total)
    return launches


def phase_presolve(cimt, counters):
    """solve(afiro, "pdas_dd", presolve=True) in f32 on the card: the
    reduced LP's solve (both dd kernels), restored to the original space."""
    _reset(*counters.values())
    rep, took = _timed_solve(cimt, AFIRO, "pdas_dd", presolve=True, device="cuda",
                             dtype=torch.float32)
    launches = _counted(counters)
    say(f"[presolve] {rep.summary['presolve']}")
    say(f"[presolve] {took:.3f} s, kernel launches {launches}")
    _check_solve("presolve", rep, AFIRO_OPTIMUM)
    say(f"[presolve] {rep.summary['phase1_iterations']} + {rep.summary['iterations']}"
        f" iterations (the JAX package on the CPU: 70 + 18)")
    if rep.solution["x"].shape != (32,) or not np.isfinite(rep.solution["y"]).all():
        raise AssertionError(f"presolve: x {rep.solution['x'].shape} not restored")
    return launches


def _cert_line(tag, cert, extra=""):
    say(f"[crossover {tag}] certified {cert['certified']}  repairs {cert['repairs']}"
        f"  widened {int(cert['widened'])}  n_basic {cert['n_basic']}"
        f"  primal {cert['primal_rel']:.3e}  dual {cert['dual_rel']:.3e}  gap {cert['gap']:.3e}"
        f"  bound violation {cert['bound_violation']:.3e}"
        + ("" if "entry_repair_pviol" not in cert
           else f"  entry repair {cert['entry_repair_pviol']}") + extra)


def _launched(counters, before):
    return {k: v - before[k] for k, v in _counted(counters).items()}


def _sum_launches(*runs):
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def phase_crossover(cimt, counters, card, pilot_s, sf, info, eng, at_scale_rep):
    """solve(..., crossover=True) and crossover() on the card: afiro dense
    and sparse (and f64), afiro's f32 pdas stop, the pilot LP through
    "pdas", and phase 8's m = 16384 result on its engine.  Returns the
    launches of the afiro, pilot and at-scale cases."""
    from cholesky_is_magic_tpu_torch.ingest.device import to_device_lp
    from cholesky_is_magic_tpu_torch.solvers import (
        PDASConfig,
        crossover,
        make_pdas,
        make_pdas_sparse,
        pdas,
    )
    from cholesky_is_magic_tpu_torch.utils.testing import constructed_optimum_lp

    f32 = dict(device="cuda", dtype=torch.float32)
    # (a) afiro dense.
    _reset(*counters.values())
    rep, took = _timed_solve(cimt, AFIRO, "pdas_dd", crossover=True, pad_multiple=32, **f32)
    dense = _counted(counters)
    cert = rep.summary["crossover"]
    err = abs(rep.objective - AFIRO_OPTIMUM) / abs(AFIRO_OPTIMUM)
    _cert_line("afiro dense", cert, f"  objective error {err:.3e}  {took:.3f} s on {card}"
               f"  launches {dense}")
    if not (cert["certified"] and cert["gap"] < 1e-9 and err <= 2e-6
            and dense["mv"] > 0 and dense["rmv"] > 0):
        raise AssertionError(f"crossover afiro dense: {cert}, error {err}, {dense}")
    # (b) afiro sparse, then in f64.
    _reset(*counters.values())
    rep, took = _timed_solve(cimt, AFIRO, "pdas_dd", sparse=True, block=16,
                             crossover=True, **f32)
    sparse = _counted(counters)
    cert = rep.summary["crossover"]
    err = abs(rep.objective - AFIRO_OPTIMUM) / abs(AFIRO_OPTIMUM)
    _cert_line("afiro sparse", cert, f"  objective error {err:.3e}  {took:.3f} s on {card}"
               f"  launches {sparse}")
    if not (cert["certified"] and err <= 1e-5 and sparse["potrf_tile"] > 0
            and sparse["assemble_pairs"] > 0):
        raise AssertionError(f"crossover afiro sparse: {cert}, error {err}, {sparse}")
    before = _counted(counters)
    rep, took = _timed_solve(cimt, AFIRO, "pdas_dd", sparse=True, block=16,
                             crossover=True, device="cuda", dtype=torch.float64)
    cert = rep.summary["crossover"]
    err = abs(rep.objective - AFIRO_OPTIMUM) / abs(AFIRO_OPTIMUM)
    launched = _launched(counters, before)
    _cert_line("afiro sparse f64", cert, f"  objective error {err:.3e}  {took:.3f} s on"
               f" {card}  kernel launches {sum(launched.values())}")
    if not (cert["certified"] and err <= 1e-9 and not any(launched.values())):
        raise AssertionError(f"crossover afiro sparse f64: {cert}, {launched}")
    # (c) afiro's f32 pdas stop, through crossover() alone: never worse.
    lp = to_device_lp(cimt.to_standard_form(cimt.read_mps_file(AFIRO)),
                      pad_multiple=32, **f32)
    st = make_pdas(lp)
    res = pdas(st, PDASConfig(gap_tol=1e-4))
    before = _counted(counters)
    out = crossover(res, st.lp)
    stall = _launched(counters, before)
    cert = out.extra["crossover"]
    err = abs(float(out.objective) - AFIRO_OPTIMUM) / abs(AFIRO_OPTIMUM)
    _cert_line("afiro pdas stop", cert, f"  pdas {res.status_name} gap"
               f" {float(res.extra['gap']):.3e}; objective error {err:.3e}; the crossover's"
               f" own launches {stall}")
    if cert["certified"] and not err <= 2e-6:
        raise AssertionError(f"crossover certified afiro's pdas stop at error {err}")
    if not cert["certified"] and not (out.x is res.x and int(out.status) == int(res.status)):
        raise AssertionError("an uncertified crossover changed the result")
    # (d) the pilot LP through "pdas" + crossover, then a timed call.
    psf, pinfo = constructed_optimum_lp("pilot", seed=0)
    ref = pinfo["objective"]
    _reset(*counters.values())
    rep, took = _timed_solve(cimt, psf, "pdas", crossover=True, **f32)
    pilot = _counted(counters)
    cert = rep.summary["crossover"]
    err = abs(rep.objective - ref) / abs(ref)
    _cert_line("pilot", cert, f"  pdas {rep.summary['iterations']} iterations, objective"
               f" error {err:.3e}  first call {took:.3f} s on {card}  launches {pilot}")
    if not (cert["certified"] and err <= 2e-6 and pilot["mv"] > 0 and pilot["rmv"] > 0):
        raise AssertionError(f"crossover pilot: {cert}, error {err}, {pilot}")
    rep, took = _timed_solve(cimt, psf, "pdas", crossover=True, **f32)
    say(f"[crossover pilot] second call wall-clock {took:.3f} s (pdas "
        f"{rep.summary['iterations']} iterations + crossover, {rep.summary['crossover']['repairs']}"
        f" repairs) beside phase 5's pdas_dd second solve {pilot_s:.3f} s, on {card}")
    # (e) phase 8's m = 16384 result, on its engine.
    st, _ = make_pdas_sparse(sf, engine=eng, device="cuda")
    _reset(*counters.values())
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = crossover(at_scale_rep.result, st.lp, engine=eng)
    torch.cuda.synchronize()
    took = time.perf_counter() - t
    scale = _counted(counters)
    cert = out.extra["crossover"]
    err = abs(float(out.objective) - info["objective"]) / abs(info["objective"])
    _cert_line("at scale", cert, f"  entry gap {at_scale_rep.summary['gap']:.3e};"
               f" objective error {err:.3e}  {took:.3f} s on {card}  launches {scale}")
    if not (cert["certified"] and err <= 1e-5 and scale["potrf_tile"] > 0
            and scale["assemble_pairs"] > 0):
        raise AssertionError(f"crossover at scale: {cert}, error {err}, {scale}")
    return _sum_launches(dense, sparse, stall), pilot, scale


# Phase 14's budgets: (outer steps, inner iterations per step) of each ALM
# phase, sized so that the phase adds well under a minute to the smoke on an
# H100 (ms per inner iteration in PERF.md).  The dd phase warm-starts from
# the f32 phase's multipliers with mu reset to 100 (the JAX package's
# TestALMDD protocol, at the reference's 1e-5 / 1e-5 stop).
ALM_PILOT = dict(f32=(4, 1500), dd=(2, 500))
ALM_AT_SCALE = dict(f32=(4, 1000), dd=(2, 200))


def _alm_line(tag, res, took, extra=""):
    inner, slots = int(res.inner_iterations), res.inner_slots
    say(f"[{tag}] outer {int(res.outer_iterations)}  inner {inner}"
        f" (run {slots}, the masked tails of the chunks included)"
        f"  violation {float(res.violation):.3e}  pg {float(res.pg):.3e}"
        f"  value {float(res.value):.10f}  {took:.3f} s,"
        f" {1e3 * took / max(slots, 1):.4f} ms per inner iteration run" + extra)
    if not (torch.isfinite(res.x).all() and np.isfinite(float(res.violation))):
        raise AssertionError(f"{tag}: non-finite result")


def _alm_two_phase(tag, lp, budgets, counters, objective, card):
    """The f32 ALM phase at its budget, then the dd phase warm-started from
    its multipliers with mu reset to 100; each timed, its launches counted
    (counters reset just before, read just after), its violation after
    every outer step printed.  Returns the dd phase's result and launches."""
    import dataclasses

    from cholesky_is_magic_tpu_torch.solvers import ALMConfig, alm, make_alm

    (outA, innA), (outB, innB) = budgets["f32"], budgets["dd"]
    cfgA = ALMConfig(max_outer=outA, inner_iters=innA, violation_tol=1e-5,
                     pg_tol=1e-5, omega_floor=1e-6, record_trace=True)
    cfgB = dataclasses.replace(cfgA, dd_gradient=True, omega_floor=1e-7,
                               max_outer=outB, inner_iters=innB)
    out = {}
    for phase, cfg, start in (("f32", cfgA, lambda: (make_alm(lp), None)),
                              ("dd", cfgB, lambda: (make_alm(
                                  lp, mu=100.0, multipliers=out["f32"].multipliers),
                                  out["f32"].x))):
        st, x0 = start()
        _reset(*counters.values())
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = alm(st, x0=x0, config=cfg)
        torch.cuda.synchronize()
        took = time.perf_counter() - t
        launches = _counted(counters)
        err = abs(float(lp.c @ res.x) - objective) / abs(objective)
        _alm_line(f"{tag} {phase}", res, took, f"  objective error {err:.3e}"
                  f"  launches {launches}  on {card}")
        k = int(res.outer_iterations)
        say(f"[{tag} {phase}] violation after each outer step: " + " ".join(
            f"{v:.3e}" for v in res.trace["violation"][:k].tolist()))
        out[phase], out[phase + " launches"] = res, launches
    return out


def _chunk_busy(tag, lp, res):
    """Device-busy share of the f32 and of the dd inner loop at the dd
    phase's last multipliers (accuracy 0: every iteration runs): one chunk,
    which runs eagerly, then ten, of which the first runs eagerly and the
    other nine replay the chunk's CUDA graph."""
    from cholesky_is_magic_tpu_torch.ops import dd as ddm

    # The module (the package re-exports a function of its name).
    am = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.approx")
    n = am._CHUNK
    prob = am.make_alm_subproblem(lp, res.multipliers, res.mu)
    zero = torch.zeros((), dtype=res.x.dtype, device=res.x.device)
    x0 = am.project_box(prob, res.x)
    xdd = ddm.dd_from(res.x)
    for chunks in (1, 10):
        k = chunks * n
        for what, fn in (
                (f"{k} f32 inner iterations",
                 lambda: am._approx_jit(prob, x0, zero, k)),
                (f"{k} dd inner iterations",
                 lambda: am._approx_dd(lp, prob, res.multipliers, res.mu, xdd, zero, k))):
            _device_busy(tag, what + (" (one eager chunk)" if chunks == 1 else
                                      " (one eager chunk, then graph replays)"), fn)


def phase_alm(cimt, counters, card, sf_scale, info_scale):
    """The matrix-free family on the card: (a) the front door on simple.mps
    and afiro; (b) the pilot LP dense, f32 then dd (the dd A·x and Aᵀ·x
    kernels, counted exactly); (c) the m = 16384 LP on block-ELL operands,
    f32 then dd.  Returns the dense dd phase's launches."""
    from cholesky_is_magic_tpu_torch.ingest.device import to_device_lp, to_sparse_lp
    from cholesky_is_magic_tpu_torch.utils.testing import constructed_optimum_lp

    simple = os.path.join(os.path.dirname(AFIRO), "simple.mps")
    # (a) the front door; the JAX package's counts on the CPU beside each.
    for problem, solver, dt, kw, jax_cpu, ref, tol in (
            (simple, "alm", torch.float32, dict(pad_multiple=16, max_iters=300),
             "4 / 65", -7.0, 1e-2),
            (simple, "aalm", torch.float64, dict(max_iters=60), "25 / 370", -7.0, 5e-2),
            (simple, "selfdual", torch.float64, {}, "119", -7.0, 1e-4),
            (AFIRO, "alm", torch.float64, dict(pad_multiple=16, max_iters=60),
             "9 / 1768", AFIRO_OPTIMUM, 2e-3)):
        before = _counted(counters)
        rep, took = _timed_solve(cimt, problem, solver, device="cuda", dtype=dt, **kw)
        launched = _launched(counters, before)
        sm = rep.summary
        key, counts = (("objective", f"{sm['iterations']}") if solver == "selfdual"
                       else ("value", f"{sm['outer_iterations']} / {sm['inner_iterations']}"))
        tag = f"alm {os.path.basename(problem)} {solver} {str(dt)[6:]}"
        say(f"[{tag}] status {rep.status}  {key} {sm[key]:.10f}  pg {sm['pg']:.3e}"
            f"  iterations {counts} (the JAX package on the CPU: {jax_cpu})"
            f"  {took:.3f} s  kernel launches {sum(launched.values())}")
        if not (rep.status == "optimal" and abs(sm[key] - ref) <= tol
                and not any(launched.values())):
            raise AssertionError(f"{tag}: {sm}, launches {launched}")
    # (b) the pilot LP, dense f32: the dd phase launches dd A·x twice per
    # inner iteration run plus twice per outer step, dd Aᵀ·x twice per
    # inner iteration run.
    psf, pinfo = constructed_optimum_lp("pilot", seed=0)
    lp = to_device_lp(psf, dtype=torch.float32, device="cuda")
    say(f"[alm pilot] {psf.ncons} x {psf.nvars} padded to {tuple(lp.A.shape)}, f32;"
        f" budgets (outer x inner) {ALM_PILOT}")
    out = _alm_two_phase("alm pilot", lp, ALM_PILOT, counters, pinfo["objective"], card)
    res, got = out["dd"], out["dd launches"]
    outer, slots = int(res.outer_iterations), res.inner_slots
    want = dict(mv=2 * slots + 2 * outer, rmv=2 * slots)
    say(f"[alm pilot dd] dd A·x launches {got['mv']} (2·{slots} + 2·{outer} ="
        f" {want['mv']}), dd Aᵀ·x {got['rmv']} (2·{slots} = {want['rmv']});"
        f" inner iterations {int(res.inner_iterations)}, run {slots}")
    if not (got["mv"] == want["mv"] and got["rmv"] == want["rmv"] and slots > 0):
        raise AssertionError(f"alm pilot dd: launches {got}, want {want}")
    _chunk_busy("alm pilot", lp, res)
    # (c) the m = 16384 LP on block-ELL operands.
    torch.cuda.synchronize()
    t = time.perf_counter()
    slp = to_sparse_lp(sf_scale, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    if slp.EB is None or slp.ETB is None:
        raise AssertionError("alm at scale: the block-ELL renderings were gated out")
    sizes = {k: _nbytes(*([v.blocks, v.bcols] if k in ("EB", "ETB") else [v.indices, v.values]))
             for k, v in (("E", slp.E), ("EB", slp.EB), ("ETB", slp.ETB))}
    say(f"[alm at scale] to_sparse_lp {time.perf_counter() - t:.3f} s; operand bytes on the"
        f" card: " + ", ".join(f"{k} {v / 2**20:.1f} MiB" for k, v in sizes.items())
        + f"; EB {tuple(slp.EB.blocks.shape)}, ETB {tuple(slp.ETB.blocks.shape)};"
        f" budgets (outer x inner) {ALM_AT_SCALE}")
    scale = _alm_two_phase("alm at scale", slp, ALM_AT_SCALE, counters,
                           info_scale["objective"], card)
    _chunk_busy("alm at scale", slp, scale["dd"])
    return got


# Phase 15's batches: the JAX package's bench sizes (bench.py:681-711,
# BASELINE.json config 5).
BATCH_SAME = 1024
BATCH_SAME_LP = dict(n_ub=24, n_eq=8, n=48, density=0.3)
BATCH_MIXED = 256
BATCH_KERNEL_SHAPES = ((1024, 64, 64), (256, 64, 128), (256, 64, 192),
                       (8, 1536, 5120))


def _mixed_batch_lp(s):
    """The bench's heterogeneous mix: every eighth LP a straggler."""
    from cholesky_is_magic_tpu_torch.utils.testing import random_lp

    if s % 8 == 7:
        return random_lp(1000 + s, n_ub=48, n_eq=16, n=96, density=0.3)
    return random_lp(s, n_ub=16 + (s % 3) * 8, n_eq=4 + s % 5,
                     n=32 + (s % 4) * 16, density=0.3)


def _sf_of(cimt, ineq):
    from cholesky_is_magic_tpu_torch.ingest.mps import read_mps_string
    from cholesky_is_magic_tpu_torch.utils.testing import write_mps

    return cimt.to_standard_form(read_mps_string(write_mps(ineq)))


def _batch_kernels(ddm, dd_cuda, stats):
    """(a): both batched kernels at phase 15's shapes against the single
    kernel (bit for bit per lane) and their summation orders (bit for bit),
    the plain batched form and the f64 truth, with times; the headline
    entries at batched pdas's N (dd A·x) and the same-shape finisher's AD
    (dd Aᵀ·x)."""
    flush = torch.zeros(2 * L2_BYTES // 4, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(15)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, m, n in BATCH_KERNEL_SHAPES:
        buf = torch.randn(B * m * n + 1, generator=g, device="cuda")
        x = torch.randn(B, n, generator=g, device="cuda")
        y = torch.randn(B, m, generator=g, device="cuda")
        for off in (0, 1):
            A = buf[off:off + B * m * n].view(B, m, n)
            mv, rmv = dd_cuda.dd_mv_batched(A, x), dd_cuda.dd_rmv_batched(A, y)
            one = [dd_cuda.dd_mv(A[k], x[k]) for k in range(B)]
            rone = [dd_cuda.dd_rmv(A[k], y[k]) for k in range(B)]
            order = dd_cuda.mv_order_plain(A, x)
            rorder = dd_cuda.rmv_slab_plain(A, y, *dd_cuda.rmv_slabs(m, n, sms))
            same = (torch.equal(mv[0], torch.stack([o[0] for o in one]))
                    and torch.equal(mv[1], torch.stack([o[1] for o in one]))
                    and torch.equal(mv[0], order.hi) and torch.equal(mv[1], order.lo)
                    and torch.equal(rmv[0], torch.stack([o[0] for o in rone]))
                    and torch.equal(rmv[1], torch.stack([o[1] for o in rone]))
                    and torch.equal(rmv[0], rorder.hi) and torch.equal(rmv[1], rorder.lo))
            errs = {}
            for which, got, plain, scale in (
                    ("mv", mv, ddm._dd_matvec_plain(A, x),
                     (A.abs() @ x.abs().unsqueeze(-1))[..., 0]),
                    ("rmv", rmv, ddm._dd_matvec_plain(A.mT, y),
                     (A.abs().mT @ y.abs().unsqueeze(-1))[..., 0])):
                err = (_f64(ddm.DD(*got)) - _f64(plain)).abs()
                errs[which] = (err.max().item(),
                               (err / (EPS32**2 * scale.double())).max().item())
            true = (A.double() @ x.double().unsqueeze(-1))[..., 0]
            t_ratio = ((_f64(ddm.DD(*mv)) - true).abs()
                       / (1e-11 + 1e-11 * true.abs())).max().item()
            say(f"[batch kernels] ({B}, {m}, {n}){' A at a 4-byte offset' if off else ''}:"
                f" each lane bit-equal to the single kernel, both to their summation orders"
                f" {same}; vs plain max err /"
                f" (eps32^2 sum|ax|) mv {errs['mv'][1]:.3f} rmv {errs['rmv'][1]:.3f}"
                f" (limit {PLAIN_TOL}); mv vs f64 truth worst err/tol {t_ratio:.3e}")
            if not (same and errs["mv"][1] <= PLAIN_TOL and errs["rmv"][1] <= PLAIN_TOL
                    and t_ratio <= 1):
                raise AssertionError(f"batched kernels at ({B}, {m}, {n}), offset {off}")
        A = buf[:B * m * n].view(B, m, n)
        for which, kern, single, plain, nout in (
                ("mv", lambda: dd_cuda.dd_mv_batched(A, x),
                 lambda: [dd_cuda.dd_mv(A[k], x[k]) for k in range(B)],
                 lambda: ddm._dd_matvec_plain(A, x), m),
                ("rmv", lambda: dd_cuda.dd_rmv_batched(A, y),
                 lambda: [dd_cuda.dd_rmv(A[k], y[k]) for k in range(B)],
                 lambda: ddm._dd_matvec_plain(A.mT, y), n)):
            p1, k1, k2, p2 = (_median_ms(f, reps=10, flush=flush, lead=0.2)
                              for f in (plain, kern, kern, plain))
            loop = _median_ms(single, reps=5, flush=flush)
            nin = n if which == "mv" else m
            bound = _bound(_nbytes(A) + 4 * B * nin + 8 * B * nout, 14 * B * m * n)
            route = ""
            if which == "rmv":
                short = dd_cuda.rmv_slabs(m, n, sms)[0] <= dd_cuda.RMV_SHORT_SLABS
                route = " (short-lane kernel)" if short else " (long kernel)"
            say(f"[batch kernels] {which} ({B}, {m}, {n}){route} median ms: batched {k1:.4f}"
                f" {k2:.4f}  loop of {B} single launches {loop:.4f}  plain {p1:.4f}"
                f" {p2:.4f}  bound {bound['bound_ms']:.4f} ({bound['bound_by']},"
                f" {100 * bound['bound_ms'] / min(k1, k2):.0f}% of it)")
            entry = dict(ms=min(k1, k2), plain_ms=min(p1, p2), loop_ms=loop,
                         library_ms=None, max_abs_err=errs[which][0], **bound)
            key = which + "_batched"
            stats.setdefault(key, {}).setdefault("at_shapes", {})[
                f"{B}x{m}x{n}"] = entry
            if (which, (B, m, n)) in (("mv", (1024, 64, 64)), ("rmv", (256, 64, 128))):
                stats[key].update(entry, shape=[B, m, n])
        del buf, A, x, y
        torch.cuda.empty_cache()


def _timed(fn, reps=3):
    """(result of the first call, host-clock seconds of ``reps`` more calls,
    each ending in a synchronize)."""
    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return out, times


def phase_batch(cimt, ddm, dd_cuda, counters, card, stats):
    """Phase 15, the batch mode on the card.  Returns the launches of the
    batched pdas ((b), counted) and batched pdas_dd ((d)) runs."""
    from cholesky_is_magic_tpu_torch import parallel
    from cholesky_is_magic_tpu_torch.solvers.pdas import PDASConfig, make_pdas
    from cholesky_is_magic_tpu_torch.solvers.pdas_dd import make_pdas_dd
    from cholesky_is_magic_tpu_torch.solvers.result import Status
    from cholesky_is_magic_tpu_torch.utils import lanes
    from cholesky_is_magic_tpu_torch.utils.testing import (
        random_lp,
        scipy_reference_solution,
    )

    t_phase = time.perf_counter()
    t_lap = [t_phase]

    def lap(part):
        now = time.perf_counter()
        say(f"[batch] {part} took {now - t_lap[0]:.3f} s")
        t_lap[0] = now

    _batch_kernels(ddm, dd_cuda, stats)
    lap("(a)")
    # (b) the same-shape batch.
    t = time.perf_counter()
    ineqs = [random_lp(s, **BATCH_SAME_LP) for s in range(BATCH_SAME)]
    sfs = [_sf_of(cimt, q) for q in ineqs]
    highs = np.array([scipy_reference_solution(q)[1] for q in ineqs])
    emb = cimt.embed_batch(sfs, pad_multiple=64)
    torch.cuda.synchronize()
    say(f"[batch same] {BATCH_SAME} LPs {sfs[0].ncons} x {sfs[0].nvars} in a"
        f" {tuple(emb.stacked_lp.A.shape[1:])} box, f32; LPs, HiGHS and the embed"
        f" {time.perf_counter() - t:.3f} s on the host")
    cfg = PDASConfig(max_iters=60, mehrotra=True, factor_method="inverse")
    states = lanes.vmap(lambda lp: make_pdas(lp, cfg), emb.stacked_lp)
    _reset(*counters.values())
    res = parallel.batched_pdas(states, cfg)
    torch.cuda.synchronize()
    pdas_launches = _counted(counters)
    res, times = _timed(lambda: parallel.batched_pdas(states, cfg))
    status = res.status.cpu().numpy()
    opt = status == Status.OPTIMAL
    obj = res.objective.cpu().numpy()
    err = np.abs(obj - highs) / np.maximum(1.0, np.abs(highs))
    its = res.iterations.cpu().numpy()
    say(f"[batch same] batched_pdas: {int(opt.sum())}/{BATCH_SAME} optimal, iterations"
        f" {its.min()}-{its.max()} (the loop ran {its.max()}); worst objective error vs"
        f" HiGHS of an optimal lane {err[opt].max():.3e} (limit 1e-3); launches"
        f" {pdas_launches}; solves/s "
        + " ".join(f"{BATCH_SAME / t:.1f}" for t in times)
        + f" (median {BATCH_SAME / float(np.median(times)):.1f}; seconds "
        + " ".join(f"{t:.3f}" for t in times) + f") on {card}")
    if not (pdas_launches["mv_batched"] > 0 and opt.sum() > 0
            and (err[opt] <= 1e-3).all()
            and pdas_launches["mv"] == pdas_launches["rmv"] == 0):
        raise AssertionError(f"batch same: launches {pdas_launches}, errors {err[opt].max()}")
    # What the per-lane dbound select costs: the same batch with the retry
    # off, one call (a lane whose first factorization fails then stops
    # singular, so the lanes that differ are counted).
    cfg0 = dataclasses.replace(cfg, dbound=0.0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    res0 = parallel.batched_pdas(states, cfg0)
    torch.cuda.synchronize()
    t0 = time.perf_counter() - t
    differ = int(((res0.iterations != res.iterations)
                  | (res0.status != res.status)).sum())
    say(f"[batch same] the same batch with dbound 0 (no retry factorization):"
        f" {t0:.3f} s against {float(np.median(times)):.3f} s; lanes whose status or"
        f" count differ {differ} (statuses {np.bincount(res0.status.cpu().numpy(), minlength=6).tolist()})")
    # Device-busy share of the first iteration (the profiler's own
    # processing takes ~7 s an iteration: ~4000 launches and their ops).
    cfg1 = dataclasses.replace(cfg, max_iters=1)
    _device_busy("batch same", "batched_pdas, one iteration",
                 lambda: parallel.batched_pdas(states, cfg1))
    lap("(b)")
    # (d) the two-phase flow on 256 of those lanes.
    k = BATCH_MIXED
    sub = lanes.flatten(res)
    p1 = sub[1]([t[:k] for t in sub[0]])
    lp_leaves, lp_build = lanes.flatten(emb.stacked_lp)
    lps = lp_build([t[:k] for t in lp_leaves])
    dd_states = lanes.vmap(lambda lp, r: make_pdas_dd(lp, warm=r), lps, p1)
    cfg_dd = PDASConfig(max_iters=60, gap_tol=1e-9, refine_steps=2)
    _reset(*counters.values())
    torch.cuda.synchronize()
    t = time.perf_counter()
    res_dd = parallel.batched_pdas_dd(dd_states, cfg_dd)
    torch.cuda.synchronize()
    took = time.perf_counter() - t
    dd_launches = _counted(counters)
    gaps = res_dd.extra["gap"].cpu().numpy()
    opt1 = p1.status.cpu().numpy() == Status.OPTIMAL
    st2 = res_dd.status.cpu().numpy()
    above = [int(i) for i in np.nonzero(opt1 & ~(gaps <= 1e-8))[0]]
    say(f"[batch pdas_dd] {k} lanes, f32: {int((st2 == Status.OPTIMAL).sum())} optimal,"
        f" statuses {np.bincount(st2, minlength=6).tolist()}; iterations"
        f" {res_dd.iterations.max().item()} at most; lanes optimal in phase 1 at gap <="
        f" 1e-8: {int((opt1 & (gaps <= 1e-8)).sum())}/{int(opt1.sum())}; above it (seeds):"
        f" {above} at gaps {[float(f'{gaps[i]:.3e}') for i in above]}, statuses"
        f" {[int(st2[i]) for i in above]}; launches {dd_launches}; {took:.3f} s on {card}")
    if not (dd_launches["mv_batched"] > 0 and dd_launches["rmv_batched"] > 0
            and dd_launches["mv"] == dd_launches["rmv"] == 0
            and all(st2[i] != Status.OPTIMAL for i in above)
            and np.isfinite(res_dd.x.cpu().numpy()).all()):
        raise AssertionError(f"batch pdas_dd: launches {dd_launches}, above {above}")
    lap("(d)")
    # (c) the front door on the bench's mixed batch.
    mixed = [_sf_of(cimt, _mixed_batch_lp(s)) for s in range(BATCH_MIXED)]
    kw = dict(max_iters=60, mehrotra=True)
    _reset(*counters.values())
    direct, t_direct = _timed(lambda: cimt.solve_batch(mixed, **kw), reps=1)
    door = _counted(counters)
    emb_m = cimt.embed_batch(mixed)
    solves = []  # both solves of the handle
    cached, t_cached = _timed(
        lambda: solves.append(cimt.solve_batch(emb_m, **kw)) or solves[-1], reps=1)
    same = all(a.objective == b.objective and a.summary["iterations"]
               == b.summary["iterations"] for c in solves for a, b in zip(direct, c))
    warm = cimt.solve_batch(emb_m, warm=cached, warm_push=1e-3, **kw)
    it = {tag: sum(r.summary["iterations"] for r in reps)
          for tag, reps in (("cold", cached), ("warm", warm))}
    n_opt = {tag: sum(r.status == "optimal" for r in reps)
             for tag, reps in (("cold", direct), ("warm", warm))}
    say(f"[batch front door] {BATCH_MIXED} LPs (32 stragglers) in a"
        f" {tuple(emb_m.stacked_lp.A.shape[1:])} box: optimal {n_opt['cold']}, warm"
        f" {n_opt['warm']}; the handle bit-identical to the direct call: {same};"
        f" iterations cold {it['cold']}, warm {it['warm']}; solves/s direct "
        + " ".join(f"{BATCH_MIXED / t:.1f}" for t in t_direct) + ", embedded "
        + " ".join(f"{BATCH_MIXED / t:.1f}" for t in t_cached)
        + f"; launches {door} on {card}")
    if not (same and it["warm"] < it["cold"] and door["mv_batched"] > 0
            and n_opt["cold"] > 0):
        raise AssertionError(f"batch front door: same {same}, iterations {it}, {door}")
    lap("(c)")
    # (e) f64 on the card: the plain forms.
    before = _counted(counters)
    kw64 = dict(max_iters=60, mehrotra=True, dtype=torch.float64)
    batch64 = cimt.solve_batch(sfs[:16], **kw64)
    launched = _launched(counters, before)
    single = [cimt.solve(sf, "pdas", pad_multiple=64, **kw64) for sf in sfs[:16]]
    got = [(r.status, r.summary["iterations"]) for r in batch64]
    want = [(r.status, r.summary["iterations"]) for r in single]
    say(f"[batch f64] 16 lanes (status, iterations): {got}; single solves equal:"
        f" {got == want}; kernel launches {sum(launched.values())}")
    if not (got == want and not any(launched.values())):
        raise AssertionError(f"batch f64: {got} vs {want}, launches {launched}")
    lap("(e)")
    say(f"[batch] phase 15 took {time.perf_counter() - t_phase:.3f} s")
    return pdas_launches, dd_launches, sfs, highs


SPARSE_LANES = 8  # (a) and (b): lanes on the m = 16384 schedule
FLEET = 32  # (c): lanes of one A at 25fv47 scale
FLEET_P1 = dict(max_iters=200, refine_steps=2, mehrotra=True)
FLEET_P2 = dict(max_iters=200, gap_tol=1e-9, refine_steps=2)


def _sparse_batch_kernels(eng, chol, chol_cuda, tiled_cuda, stats):
    """(a): the batched assembly on the m = 16384 schedule and the batched
    tile kernel on (8, 128, 128) SPD tiles, each lane bit for bit against the
    single launch, against the plain batched forms, with times beside a
    Python loop of single launches and the bound."""
    B = SPARSE_LANES
    g = torch.Generator(device="cuda").manual_seed(16)
    n = int(eng.asm_k.max().item()) + 1
    D = 10.0 ** (3 * torch.rand(B, n, generator=g, device="cuda") - 1.5)
    boost = torch.zeros(AT_SCALE_M, device="cuda")
    tb = tiled_cuda.assemble_pairs_batched(eng, D, boost)
    same = all(torch.equal(tb[k], tiled_cuda.assemble_pairs(eng, D[k], boost))
               for k in range(B))
    plain = eng._assemble_pairs_plain(D, boost)
    err = (tb - plain).abs().max().item()
    kern = lambda: tiled_cuda.assemble_pairs_batched(eng, D, boost)  # noqa: E731
    loop = lambda: [tiled_cuda.assemble_pairs(eng, D[k], boost) for k in range(B)]  # noqa: E731
    plain_f = lambda: eng._assemble_pairs_plain(D, boost)  # noqa: E731
    p1, k1, k2, p2 = (_median_ms(f, lead=lead) for f, lead in (
        (plain_f, 3.0), (kern, 0.2), (kern, 0.2), (plain_f, 3.0)))
    lp = _median_ms(loop, lead=0.5)
    # The schedule (shared) read once, each lane's d and boost read and its
    # tiles written; 3 flops per pair per lane.
    sched = eng._kernel_schedule
    bound = _bound(_nbytes(eng.asm_w, *sched[:5]) + B * _nbytes(D[0], boost, tb[0]),
                   3 * B * eng.n_pairs)
    say(f"[batch sparse kernels] assembly, {B} lanes of the m = {AT_SCALE_M} schedule"
        f" ({eng.n_pairs} pairs): each lane bit-equal to the single launch {same};"
        f" max abs err vs the plain batched form {err:.3e} (it sums in the kernel's"
        f" order); median ms batched {k1:.4f} {k2:.4f}  loop of {B} single launches"
        f" {lp:.4f}  plain {p1:.4f} {p2:.4f}  bound {bound['bound_ms']:.4f}"
        f" ({bound['bound_by']})")
    if not (same and err == 0.0):
        raise AssertionError("batched assembly disagrees with the single launches")
    stats["assemble_pairs_batched"] = dict(
        max_abs_err=err, ms=min(k1, k2), plain_ms=min(p1, p2), loop_ms=lp,
        library_ms=None, shape=[B, eng.NT + 1, eng.b, eng.b], **bound)
    b = chol_cuda.BLOCK
    N = torch.stack([_spd(b, 100 + k) for k in range(B)])
    L, inv = chol_cuda.potrf_tile_batched(N)
    same = all(torch.equal(L[k], Lk) and torch.equal(inv[k], Ik)
               for k, (Lk, Ik) in enumerate(chol_cuda.potrf_tile(N[k]) for k in range(B)))
    Lp, Ip = chol._factor_tile_plain(N)
    err = max((L - Lp).abs().max().item(), (inv - Ip).abs().max().item())
    truth = max(_recon_err(L[k], N[k]) for k in range(B))
    kern = lambda: chol_cuda.potrf_tile_batched(N)  # noqa: E731
    loop = lambda: [chol_cuda.potrf_tile(N[k]) for k in range(B)]  # noqa: E731
    plain_f = lambda: chol._factor_tile_plain(N)  # noqa: E731
    p1, k1, k2, p2 = (_median_ms(f, lead=0.2) for f in (plain_f, kern, kern, plain_f))
    lp = _median_ms(loop, lead=0.5)
    bound = _bound(4 * B * (b * (b + 1) // 2 + 2 * b * b), B * 2 * b**3 / 3)
    say(f"[batch sparse kernels] tile kernel, ({B}, {b}, {b}) SPD tiles: each lane"
        f" bit-equal to the single launch {same}; ||LLt-N||/||N|| {truth / EPS32:.2f}"
        f" eps32 (limit 32); max abs err vs plain {err:.3e}; median ms batched"
        f" {k1:.4f} {k2:.4f}  loop of {B} single launches {lp:.4f}  plain (batched"
        f" cholesky_ex + solve_triangular) {p1:.4f} {p2:.4f}  bound"
        f" {bound['bound_ms']:.6f} ({bound['bound_by']})")
    if not (same and truth <= 32 * EPS32):
        raise AssertionError("batched tile kernel disagrees with the single launches")
    stats["potrf_tile_batched"] = dict(
        max_abs_err=err, ms=min(k1, k2), plain_ms=min(p1, p2), loop_ms=lp,
        library_ms=None, shape=[B, b, b], **bound)


def _seconds(fn):
    """(fn(), host-clock seconds of the call, synchronized on both ends)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _fleet(cimt, k):
    """k LPs of one A at 25fv47 scale (all variables boxed), each with its
    own (b, c) drifted as tests/test_parallel.py:321-329 does, and their
    HiGHS optima."""
    from cholesky_is_magic_tpu_torch.utils.testing import (
        netlib_like_lp,
        scipy_reference_solution,
    )

    base = netlib_like_lp("25fv47")
    n = base.c.shape[0]
    sfs, highs = [], []
    for i in range(k):
        rng = np.random.default_rng(1000 + i)
        x0 = base.l + (base.u - base.l) * (0.2 + 0.6 * rng.random(n))
        lane = dataclasses.replace(
            base, b_ub=base.A_ub @ x0 + 0.05 + rng.random(base.A_ub.shape[0]),
            b_eq=base.A_eq @ x0, c=rng.normal(size=n))
        highs.append(scipy_reference_solution(lane)[1])
        sfs.append(_sf_of(cimt, lane))
    return sfs, np.array(highs)


def _rel(a, b):
    return np.abs(np.asarray(a) - b) / np.maximum(1.0, np.abs(b))


def phase_batch_sparse(cimt, counters, card, stats, sf, eng, same_sfs, same_highs):
    """Phase 16, the rest of the batch mode on the card: (a) the batched
    tile and assembly kernels; (b) batched_normal_solves on the m = 16384
    engine; (c) the re-solve fleet, batched sparse pdas then pdas_dd on one
    engine; (d) the slabbed loop on phase 15's mixed batch; (e)
    batched_affine.  Returns the launches of each path."""
    import importlib

    from cholesky_is_magic_tpu_torch import parallel
    from cholesky_is_magic_tpu_torch.ingest.standard_form import scale_constraints
    from cholesky_is_magic_tpu_torch.ops import chol, chol_cuda, sparse_ops
    from cholesky_is_magic_tpu_torch.ops import dd as ddm
    from cholesky_is_magic_tpu_torch.solvers.result import Status
    from cholesky_is_magic_tpu_torch.sparse import tiled_cuda
    from cholesky_is_magic_tpu_torch.utils import lanes
    from cholesky_is_magic_tpu_torch.utils.testing import scipy_reference_solution

    pdas = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas")
    pdas_dd = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas_dd")
    affine = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.affine")
    t_phase = time.perf_counter()
    t_lap = [t_phase]
    paths = {}

    def lap(part):
        now = time.perf_counter()
        say(f"[batch sparse] {part} took {now - t_lap[0]:.3f} s")
        t_lap[0] = now

    def single_launches(launches):
        return (launches["potrf_tile"] + launches["assemble_pairs"] + launches["tile_schur"]
                + launches["tile_solve"])

    _sparse_batch_kernels(eng, chol, chol_cuda, tiled_cuda, stats)
    lap("(a)")
    # (b) batched normal solves on the m = 16384 engine.
    m, n = sf.ncons, sf.nvars
    vals, _ = scale_constraints(sf.a_rows, sf.a_vals, sf.b)
    E = sparse_ops.from_coo(sf.a_rows, sf.a_cols, vals, (m, n), device="cuda")
    ET = sparse_ops.from_coo(sf.a_cols, sf.a_rows, vals, (n, m), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(17)
    D = 0.5 + torch.rand(SPARSE_LANES, n, generator=g, device="cuda")
    G = torch.randn(SPARSE_LANES, m, generator=g, device="cuda")
    batched = lambda: parallel.batched_normal_solves(  # noqa: E731
        eng, E, ET, D, G, refine_steps=1)
    _reset(*counters.values())
    Y, ok = batched()
    torch.cuda.synchronize()
    paths["batch normal solves"] = launched = _counted(counters)
    t_b = [_seconds(batched)[1] for _ in range(2)]
    singles, t_s = _seconds(lambda: [eng.solve_normal_ell(E, ET, D[k], G[k],
                                                          refine_steps=1)
                                     for k in range(SPARSE_LANES)])
    rel = max((torch.linalg.norm(Y[k] - y) / torch.linalg.norm(y)).item()
              for k, (y, _) in enumerate(singles))
    say(f"[batch normal solves] {SPARSE_LANES} lanes on the m = {m} engine, f32:"
        f" all ok {bool(ok.all())}; worst lane vs its single solve_normal_ell"
        f" {rel:.3e} (limit 1e-5); seconds batched {' '.join(f'{t:.3f}' for t in t_b)}"
        f" vs {SPARSE_LANES} single calls {t_s:.3f}; launches of one batched call"
        f" {launched} on {card}")
    if not (bool(ok.all()) and rel <= 1e-5 and launched["potrf_tile_batched"] > 0
            and launched["assemble_pairs_batched"] > 0 and single_launches(launched) == 0):
        raise AssertionError(f"batched normal solves: rel {rel}, launches {launched}")
    del E, ET, Y, singles
    torch.cuda.empty_cache()
    lap("(b)")
    # (c) the re-solve fleet: one A, FLEET lanes of (b, c).
    t = time.perf_counter()
    sfs, highs = _fleet(cimt, FLEET)
    s0, feng = pdas.make_pdas_sparse(sfs[0], block=128, device="cuda")
    states = [s0] + [pdas.make_pdas_sparse(s, block=128, engine=feng, device="cuda")[0]
                     for s in sfs[1:]]
    stacked = parallel.stack_sparse_states(states)
    torch.cuda.synchronize()
    say(f"[batch fleet] {FLEET} lanes of one A, {sfs[0].ncons} x {sfs[0].nvars} at"
        f" 25fv47 scale, block 128 ({feng.B} panels, {feng.NT} tiles, {feng.n_pairs}"
        f" pairs): LPs, HiGHS, states and the engine {time.perf_counter() - t:.3f} s")
    cfg1, cfg2 = pdas.PDASConfig(**FLEET_P1), pdas.PDASConfig(**FLEET_P2)

    def finisher_states(p1):
        out = []
        for k, st in enumerate(states):
            w, z = pdas_dd.mu_recentered_duals(
                p1.x[k], st.lp.l, st.lp.u, p1.extra["w"][k], p1.extra["z"][k],
                st.lp.col_mask)
            out.append(pdas_dd.PDASDDState(
                x=ddm.dd_from(p1.x[k]), y=ddm.dd_from(p1.extra["y"][k]),
                w=ddm.dd_from(w), z=ddm.dd_from(z), lp=st.lp))
        return out

    _reset(*counters.values())
    p1, t1 = _seconds(lambda: parallel.batched_pdas(stacked, cfg1, engine=feng))
    paths["batch sparse pdas"] = l1 = _counted(counters)
    dd_states = finisher_states(p1)
    _reset(*counters.values())
    p2, t2 = _seconds(lambda: parallel.batched_pdas_dd(
        parallel.stack_sparse_states(dd_states), cfg2, engine=feng))
    paths["batch sparse pdas_dd"] = l2 = _counted(counters)
    st1, st2 = p1.status.cpu().numpy(), p2.status.cpu().numpy()
    err1, err2 = _rel(p1.objective.cpu().numpy(), highs), _rel(p2.objective.cpu().numpy(), highs)
    gaps = p2.extra["gap"].cpu().numpy()
    miss1 = [int(k) for k in np.nonzero((st1 != Status.OPTIMAL) | (err1 > 1e-3))[0]]
    miss2 = [int(k) for k in np.nonzero(~(gaps < 1e-7) | (err2 > 1e-4))[0]]
    # The f32 finisher's floor: lanes that stop above the gap bar stop at
    # the precision floor, in the JAX package too (ROADMAP.md §3; its CPU
    # run: python tests/test_torch_batched_sparse.py 3,13,19,31,0).
    floor = [k for k in miss2 if st2[k] == Status.PRECISION_FLOOR and err2[k] <= 1e-4]
    its1, its2 = p1.iterations.cpu().numpy(), p2.iterations.cpu().numpy()
    say(f"[batch fleet] phase 1 (pdas, Mehrotra): statuses"
        f" {np.bincount(st1, minlength=6).tolist()}, iterations {its1.min()}-{its1.max()},"
        f" worst objective error vs HiGHS {err1.max():.3e} (bar 1e-3), lanes missing"
        f" the bar {miss1}; launches {l1}")
    say(f"[batch fleet] phase 2 (pdas_dd, gap_tol 1e-9): statuses"
        f" {np.bincount(st2, minlength=6).tolist()}, iterations {its2.min()}-{its2.max()},"
        f" worst gap {gaps.max():.3e} (bar 1e-7), worst objective error {err2.max():.3e}"
        f" (bar 1e-4), lanes missing a bar {miss2} at gaps"
        f" {[float(f'{gaps[k]:.3e}') for k in miss2]}, of them at the precision floor"
        f" with the objective bar met {floor}; launches {l2}")
    say(f"[batch fleet] {FLEET} two-phase solves: seconds {t1:.3f} + {t2:.3f}, solves/s"
        f" {FLEET / (t1 + t2):.1f} (phase 1 alone {FLEET / t1:.1f}) on {card}")
    worst = 0.0
    for k in range(4):
        one1 = pdas.pdas(states[k], cfg1, engine=feng)
        one2 = pdas_dd.pdas_dd(dd_states[k], cfg2, engine=feng)
        r1 = _rel(float(one1.objective), float(p1.objective[k]))
        r2 = _rel(float(one2.objective), float(p2.objective[k]))
        worst = max(worst, r1, r2)
        say(f"[batch fleet] lane {k}: batched {int(its1[k])} + {int(its2[k])} iterations,"
            f" single {int(one1.iterations)} + {int(one2.iterations)}; objectives apart"
            f" {r1:.3e} / {r2:.3e} (limit 1e-5)")
    _device_busy("batch fleet", "batched sparse pdas, one iteration",
                 lambda: parallel.batched_pdas(
                     stacked, dataclasses.replace(cfg1, max_iters=1), engine=feng))
    for tag, got in (("pdas", l1), ("pdas_dd", l2)):
        if not (got["potrf_tile_batched"] > 0 and got["assemble_pairs_batched"] > 0
                and single_launches(got) == 0):
            raise AssertionError(f"batch fleet {tag}: launches {got}")
    if not (worst <= 1e-5 and np.isfinite(p2.x.cpu().numpy()).all() and not miss1
            and floor == miss2):
        raise AssertionError(f"batch fleet: lanes 0-3 apart from their single solves"
                             f" {worst}; missing phase 1's bar {miss1}, the finisher's"
                             f" {miss2} (at the floor {floor})")
    del states, stacked, p1, p2
    torch.cuda.empty_cache()
    lap("(c)")
    # (d) the slabbed loop on phase 15's mixed batch.
    mixed_q = [_mixed_batch_lp(s) for s in range(BATCH_MIXED)]
    mixed = [_sf_of(cimt, q) for q in mixed_q]
    mixed_highs = np.array([scipy_reference_solution(q)[1] for q in mixed_q])
    kw = dict(max_iters=60, mehrotra=True)
    plain_f = lambda: cimt.solve_batch(mixed, **kw)  # noqa: E731
    slab_f = lambda: cimt.solve_batch(mixed, slab_iters=16, **kw)  # noqa: E731
    _reset(*counters.values())
    slab = slab_f()
    paths["batch slabbed"] = _counted(counters)
    plain, t_plain, t_slab = plain_f(), [], []
    for _ in range(3):  # in turns
        t_plain.append(_seconds(plain_f)[1])
        t_slab.append(_seconds(slab_f)[1])
    same = [a.status for a in plain] == [b.status for b in slab]
    opt = [i for i, r in enumerate(slab) if r.status == "optimal"]
    err = _rel([slab[i].objective for i in opt], mixed_highs[opt])
    it = {tag: sum(r.summary["iterations"] for r in reps)
          for tag, reps in (("plain", plain), ("slabbed", slab))}
    say(f"[batch slabbed] {BATCH_MIXED} mixed LPs, slab_iters 16: statuses equal to the"
        f" plain batch's {same}; optimal {len(opt)}; worst objective error vs HiGHS"
        f" {err.max():.3e} (limit 1e-3); lane-iterations plain {it['plain']}, slabbed"
        f" {it['slabbed']}; solves/s plain {' '.join(f'{BATCH_MIXED / t:.1f}' for t in t_plain)}"
        f" (median {BATCH_MIXED / float(np.median(t_plain)):.1f}), slabbed"
        f" {' '.join(f'{BATCH_MIXED / t:.1f}' for t in t_slab)} (median"
        f" {BATCH_MIXED / float(np.median(t_slab)):.1f}); launches {paths['batch slabbed']}"
        f" on {card}")
    if not (same and opt and (err <= 1e-3).all()
            and paths["batch slabbed"]["mv_batched"] > 0):
        raise AssertionError(f"batch slabbed: statuses equal {same}, errors {err.max()}")
    lap("(d)")
    # (e) batched affine: phase 15 (b)'s 1024 LPs in f32, 16 of them in f64.
    emb = cimt.embed_batch(same_sfs, pad_multiple=64)
    ast = lanes.vmap(affine.make_affine_state, emb.stacked_lp)
    _reset(*counters.values())
    res, t_first = _seconds(lambda: parallel.batched_affine(ast))
    paths["batch affine"] = launched = _counted(counters)
    t_aff = [t_first, _seconds(lambda: parallel.batched_affine(ast))[1]]
    status = res.status.cpu().numpy()
    opt = status == Status.OPTIMAL
    err = _rel(res.objective.cpu().numpy(), same_highs)
    its = res.iterations.cpu().numpy()
    say(f"[batch affine] {len(same_sfs)} LPs, f32: statuses"
        f" {np.bincount(status, minlength=6).tolist()}, iterations {its.min()}-{its.max()},"
        f" worst objective error of an optimal lane vs HiGHS {err[opt].max():.3e};"
        f" seconds {t_aff[0]:.3f} (first) {t_aff[1]:.3f}"
        f" ({len(same_sfs) / t_aff[1]:.1f} solves/s); launches of the first call"
        f" {launched} on {card}")
    if not (launched["mv_batched"] > 0 and launched["mv"] == 0 and opt.any()
            and np.isfinite(res.x.cpu().numpy()).all()):
        raise AssertionError(f"batch affine f32: launches {launched}")
    emb64 = cimt.embed_batch(same_sfs[:16], pad_multiple=64, dtype=torch.float64)
    ast64 = lanes.vmap(affine.make_affine_state, emb64.stacked_lp)
    before = _counted(counters)
    res64 = parallel.batched_affine(ast64)
    got = list(zip(res64.status.tolist(), res64.iterations.tolist()))
    want = [(int(o.status), int(o.iterations)) for o in (
        affine.affine_scaling(lanes.lane(ast64, k)) for k in range(16))]
    launched64 = _launched(counters, before)
    say(f"[batch affine f64] 16 lanes (status, iterations): {got}; single"
        f" affine_scaling equal: {got == want}; kernel launches {sum(launched64.values())}")
    if not (got == want and not any(launched64.values())):
        raise AssertionError(f"batch affine f64: {got} vs {want}, launches {launched64}")
    lap("(e)")
    say(f"[batch sparse] phase 16 took {time.perf_counter() - t_phase:.3f} s")
    return paths


def _stats_ms(fn, reps=5):
    """(result, median, min, max host-clock ms) of ``reps`` calls of fn(),
    each between two ``torch.cuda.synchronize()``, after a warm-up call."""
    out = fn()
    times = []
    for _ in range(reps):
        out, took = _seconds(fn)
        times.append(took * 1e3)
    return out, float(np.median(times)), min(times), max(times)


def _two_phase(lp, eng, **kw):
    """pdas (Mehrotra) then the pdas_dd finisher warm from it, both on the
    engine, as api.solve's two-phase flow (refine_steps 2, gap_tol 1e-9):
    (phase-1 result, finisher result, seconds of both)."""
    from cholesky_is_magic_tpu_torch.solvers import PDASConfig, make_pdas, pdas
    from cholesky_is_magic_tpu_torch.solvers.pdas_dd import make_pdas_dd, pdas_dd

    cfg1 = PDASConfig(max_iters=500, refine_steps=2, mehrotra=True, **kw)
    cfg2 = PDASConfig(max_iters=500, gap_tol=1e-9, refine_steps=2, mehrotra=True, **kw)
    torch.cuda.synchronize()
    t = time.perf_counter()
    r1 = pdas(make_pdas(lp), cfg1, engine=eng)
    r2 = pdas_dd(make_pdas_dd(lp, warm=r1), cfg2, engine=eng)
    torch.cuda.synchronize()
    return r1, r2, time.perf_counter() - t


def phase_dense_engines(cimt, counters, card, pilot_s):
    """Phase 17, the dense-A engines on the card: (a) the pilot LP's normal
    solve by the tile engine (engine_for), the dense path and
    BlockSparseCholesky; (b) the pilot through pdas then pdas_dd on the
    engine; (c) the 25fv47-scale LP the same way; (d) (b) with Gondzio's
    correctors; (e) affine on the pilot and crossover on afiro with an
    engine.  Returns the launches of each path."""
    import scipy.sparse as sp

    from cholesky_is_magic_tpu_torch.ingest.device import to_device_lp
    from cholesky_is_magic_tpu_torch.ops import dense
    from cholesky_is_magic_tpu_torch.solvers import (
        AffineConfig,
        affine_scaling,
        crossover,
        make_affine_state,
        make_pdas,
    )
    from cholesky_is_magic_tpu_torch.solvers.pdas_dd import make_pdas_dd
    from cholesky_is_magic_tpu_torch.sparse import BlockSparseCholesky, analyze, engine_for
    from cholesky_is_magic_tpu_torch.utils.testing import (
        constructed_optimum_lp,
        netlib_like_lp,
        scipy_reference_solution,
    )

    t_phase = time.perf_counter()
    f32 = dict(device="cuda", dtype=torch.float32)
    paths = {}
    # (a) one normal solve of the pilot LP three ways.
    sf, info = constructed_optimum_lp("pilot", seed=0)
    lp = to_device_lp(sf, pad_multiple=128, **f32)
    A = make_pdas(lp).lp.A
    eng, build_s = _seconds(lambda: engine_for(A, block=128))
    bs, bs_s = _seconds(lambda: BlockSparseCholesky(
        analyze(sp.csc_matrix(A.cpu().double().numpy()), block=128)))
    mask = bs.plan.block_mask | np.eye(bs.n_tiles, dtype=bool)
    say(f"[dense-A] pilot {tuple(A.shape)}: engine_for(block=128) {build_s:.3f} s: "
        f"{eng.B} panels, {eng.NT} tiles, assemble mode {eng.assemble_mode} "
        f"(range cost {eng.range_cost}, scan cost {eng.scan_cost}: "
        f"{'range' if eng.range_cost <= 1.2 * eng.scan_cost else 'scan'}); "
        f"BlockSparseCholesky {bs_s:.3f} s: {bs.n_tiles} panels, {int(mask.sum())} "
        f"tiles, {sum(len(u) for u in bs.updates)} Schur pairs")
    g = torch.Generator(device="cuda").manual_seed(17)
    d = torch.rand(A.shape[1], generator=g, device="cuda") + 0.5
    rhs = torch.randn(A.shape[0], generator=g, device="cuda")
    boost = (~lp.row_mask).to(torch.float32)
    kw = dict(row_boost=boost, refine_steps=1)
    Ad = A.double() * d.double()[None, :]
    truth = torch.linalg.solve(Ad @ Ad.T + torch.diag(boost.double()), rhs.double())
    calls = {"dense": lambda: dense.solve_normal(A, d, rhs, **kw),
             "tiled": lambda: eng.solve_normal(A, d, rhs, **kw),
             "block sparse": lambda: bs.solve_normal(A, d, rhs, **kw)}
    ys = {}
    for tag, fn in calls.items():
        _reset(*counters.values())
        (y, ok), _ = _seconds(fn)
        launched = _counted(counters)
        _, med, lo, hi = _stats_ms(fn)
        ys[tag] = y
        err = float(torch.linalg.norm(y.double() - truth) / torch.linalg.norm(truth))
        say(f"[dense-A solve_normal {tag}] ok {bool(ok)}  error vs f64 {err:.3e}  "
            f"ms median {med:.3f} min {lo:.3f} max {hi:.3f} (5 calls)  launches "
            f"{ {k: v for k, v in launched.items() if v} }  on {card}")
        if not (bool(ok) and err <= 1e-4):
            raise AssertionError(f"dense-A solve_normal {tag}: ok {bool(ok)}, error {err}")
        if tag == "tiled":
            want = dict(potrf_tile=eng.B, mv=2, rmv=1, assemble_pairs=0)
            paths["dense-A solve_normal pilot"] = launched
        elif tag == "block sparse":
            want = dict(potrf_tile=bs.n_tiles, mv=2, rmv=1, assemble_pairs=0)
            paths["BlockSparseCholesky pilot"] = launched
        else:
            want = {}
        if any(launched[k] != v for k, v in want.items()):
            raise AssertionError(f"dense-A {tag}: launches {launched}, want {want}")
    for tag in ("tiled", "block sparse"):
        rel = float(torch.linalg.norm(ys[tag] - ys["dense"]) / torch.linalg.norm(ys["dense"]))
        say(f"[dense-A solve_normal {tag}] relative difference from dense {rel:.3e}")
    _device_busy("dense-A solve_normal tiled", "one call", calls["tiled"])
    # (b) pdas + pdas_dd on the engine, (d) with Gondzio's correctors.
    ref = info["objective"]
    for tag, extra in (("pdas pilot", {}), ("gondzio pilot", dict(gondzio_correctors=2))):
        _reset(*counters.values())
        r1, r2, took = _two_phase(lp, eng, **extra)
        launched = _counted(counters)
        gap = float(r2.extra["gap"])
        err = abs(float(r2.objective) - ref) / abs(ref)
        say(f"[dense-A {tag}] {r1.status_name} {int(r1.iterations)} + {r2.status_name} "
            f"{int(r2.iterations)} iterations, gap {gap:.3e}, objective error {err:.3e}, "
            f"{took:.3f} s (phase 5, dense, no Mehrotra: 27 + 16 in {pilot_s:.3f} s) on "
            f"{card}; launches { {k: v for k, v in launched.items() if v} }")
        if not (gap <= 1e-7 and err <= 1e-5 and launched["potrf_tile"] > 0
                and launched["mv"] > 0 and launched["rmv"] > 0
                and launched["assemble_pairs"] == 0):
            raise AssertionError(f"dense-A {tag}: gap {gap}, error {err}, {launched}")
        paths[f"dense-A {tag}"] = launched
    # (c) the 25fv47-scale LP (bench.py:100-107), pad 128, block 128.
    ineq = netlib_like_lp("25fv47")
    highs = scipy_reference_solution(ineq)[1]
    lp25 = to_device_lp(_sf_of(cimt, ineq), pad_multiple=128, **f32)
    eng25, build_s = _seconds(lambda: engine_for(make_pdas(lp25).lp.A, block=128))
    _reset(*counters.values())
    r1, r2, took = _two_phase(lp25, eng25)
    launched = _counted(counters)
    err = abs(float(r2.objective) - highs) / max(1.0, abs(highs))
    say(f"[dense-A 25fv47] {tuple(lp25.A.shape)}, engine {build_s:.3f} s ({eng25.B} panels, "
        f"{eng25.NT} tiles, {eng25.assemble_mode} -> "
        f"{'range' if eng25.range_cost <= 1.2 * eng25.scan_cost else 'scan'}): "
        f"{r1.status_name} {int(r1.iterations)} + {r2.status_name} {int(r2.iterations)} "
        f"iterations, gap {float(r2.extra['gap']):.3e}, objective error vs HiGHS "
        f"{err:.3e}, {took:.3f} s on {card}; launches "
        f"{ {k: v for k, v in launched.items() if v} }")
    if not (err <= 1e-5 and launched["potrf_tile"] > 0 and launched["mv"] > 0):
        raise AssertionError(f"dense-A 25fv47: error {err}, {launched}")
    paths["dense-A pdas 25fv47"] = launched
    # (e) affine on the pilot with the engine; crossover on afiro dense.
    _reset(*counters.values())
    # api.solve(..., "affine")'s configuration (phase 10).
    res, took = _seconds(lambda: affine_scaling(
        make_affine_state(lp), AffineConfig(max_iters=500, refine_steps=1), engine=eng))
    launched = _counted(counters)
    err = abs(float(res.objective) - ref) / abs(ref)
    say(f"[dense-A affine pilot] {res.status_name} {int(res.iterations)} iterations "
        f"(phase 10, dense: 21), objective error {err:.3e}, {took:.3f} s on {card}; "
        f"launches { {k: v for k, v in launched.items() if v} }")
    if not (res.status_name == "optimal" and err <= 1e-3 and launched["potrf_tile"] > 0
            and launched["mv"] > 0):
        raise AssertionError(f"dense-A affine pilot: {res.status_name}, {err}, {launched}")
    paths["dense-A affine pilot"] = launched
    alp = to_device_lp(cimt.to_standard_form(cimt.read_mps_file(AFIRO)),
                       pad_multiple=32, **f32)
    eng16 = engine_for(make_pdas(alp).lp.A, block=16)
    _reset(*counters.values())
    r1, r2, _ = _two_phase(alp, eng16)
    out, took = _seconds(lambda: crossover(r2, make_pdas_dd(alp).lp, engine=eng16))
    launched = _counted(counters)
    cert = out.extra["crossover"]
    err = abs(float(out.objective) - AFIRO_OPTIMUM) / abs(AFIRO_OPTIMUM)
    _cert_line("afiro dense-A engine", cert, f"  pdas + pdas_dd {int(r1.iterations)} + "
               f"{int(r2.iterations)}, objective error {err:.3e}, crossover {took:.3f} s "
               f"on {card}  launches { {k: v for k, v in launched.items() if v} }")
    if not (cert["certified"] and cert["gap"] < 1e-9 and err <= 2e-6
            and launched["potrf_tile"] > 0):
        raise AssertionError(f"crossover afiro dense-A engine: {cert}, {err}, {launched}")
    paths["dense-A crossover afiro"] = launched
    say(f"[dense-A] phase 17 took {time.perf_counter() - t_phase:.3f} s")
    return paths


def _nccl_world_of_one():
    """A process group of world size 1 on NCCL over a TCP store on
    127.0.0.1 (a free port), and ``lp_mesh(1, 1)`` over it."""
    import socket

    import torch.distributed as dist

    from cholesky_is_magic_tpu_torch.parallel import lp_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    return lp_mesh(dp=1, tp=1)


def _drifted(sf, k):
    """k copies of a boxed StandardForm with its own (b, c) each, drifted
    as tests/test_parallel.py:321-329 does: b = A·x0 for x0 inside the
    box, c ~ N(0, 1)."""
    import scipy.sparse as sp

    A = sp.csr_matrix((sf.a_vals, (sf.a_rows, sf.a_cols)), shape=(sf.ncons, sf.nvars))
    out = []
    for i in range(k):
        rng = np.random.default_rng(1000 + i)
        x0 = sf.l + (sf.u - sf.l) * (0.2 + 0.6 * rng.random(sf.nvars))
        out.append(dataclasses.replace(sf, b=A @ x0, c=rng.normal(size=sf.nvars)))
    return out


DENSE_A_LANES = 8  # phase 18 (d): lanes that share the pilot's A


def phase_mesh(cimt, counters, card, pilot_s, sf8, info8):
    """Phase 18, the multi-device modes and the dense-A batch on the card,
    at world size 1 (NCCL refuses two ranks on one card): (a) the dense tp
    path on the pilot LP; (b) the sparse tp path on the m = 16384 LP; (c)
    the dp batch through solve_batch; (d) a batch of 8 dense states on one
    dense-A engine.  Returns the launches of each path."""
    import torch.distributed as dist

    from cholesky_is_magic_tpu_torch import parallel
    from cholesky_is_magic_tpu_torch.ingest.device import to_device_lp
    from cholesky_is_magic_tpu_torch.ops import dd as ddm
    from cholesky_is_magic_tpu_torch.ops import dense
    from cholesky_is_magic_tpu_torch.solvers import PDASConfig, make_pdas, pdas
    from cholesky_is_magic_tpu_torch.solvers.affine import _into_interior
    from cholesky_is_magic_tpu_torch.solvers.pdas import make_pdas_sparse
    from cholesky_is_magic_tpu_torch.solvers.pdas_dd import (
        PDASDDState,
        make_pdas_dd,
        mu_recentered_duals,
        pdas_dd,
    )
    from cholesky_is_magic_tpu_torch.solvers.result import Status
    from cholesky_is_magic_tpu_torch.sparse import engine_for
    from cholesky_is_magic_tpu_torch.utils import lanes
    from cholesky_is_magic_tpu_torch.utils.testing import (
        constructed_optimum_lp,
        scipy_reference_solution,
    )

    t_phase = time.perf_counter()
    f32 = dict(device="cuda", dtype=torch.float32)
    mesh = _nccl_world_of_one()
    paths = {}
    try:
        say(f"[mesh] NCCL process group of world size {dist.get_world_size()}, "
            f"lp_mesh {tuple(mesh.shape)} {mesh.mesh_dim_names}")
        # (a) the dense tp path: one normal solve, then pdas + pdas_dd.
        sf, info = constructed_optimum_lp("pilot", seed=0)
        lp = to_device_lp(sf, pad_multiple=128, **f32)
        A = make_pdas(lp).lp.A
        g = torch.Generator(device="cuda").manual_seed(18)
        d = torch.rand(A.shape[1], generator=g, device="cuda") + 0.5
        rhs = torch.randn(A.shape[0], generator=g, device="cuda")
        boost = (~lp.row_mask).to(torch.float32)
        _reset(*counters.values())
        y_tp, ok = parallel.sharded_solve_normal(mesh, A, d, rhs, row_boost=boost,
                                                 refine_steps=1)
        torch.cuda.synchronize()
        launched = _counted(counters)
        y, ok1 = dense.solve_normal(A, d, rhs, row_boost=boost, refine_steps=1,
                                    true_residual=True)
        rel = float(torch.linalg.norm(y_tp - y) / torch.linalg.norm(y))
        say(f"[mesh tp solve_normal pilot] {tuple(A.shape)} ok {bool(ok)}: relative "
            f"difference from ops.dense.solve_normal {rel:.3e} (limit 1e-6; bit-equal "
            f"{bool(torch.equal(y_tp, y))}); launches "
            f"{ {k: v for k, v in launched.items() if v} }")
        if not (bool(ok) and bool(ok1) and rel <= 1e-6 and launched["mv"] == 2
                and launched["rmv"] == 1):
            raise AssertionError(f"mesh tp solve_normal: ok {bool(ok)}, {rel}, {launched}")
        paths["mesh tp solve_normal pilot"] = launched
        cfg1 = PDASConfig(max_iters=500, refine_steps=2)
        cfg2 = PDASConfig(max_iters=500, gap_tol=1e-9, refine_steps=2)
        _reset(*counters.values())
        torch.cuda.synchronize()
        t = time.perf_counter()
        r1 = pdas(make_pdas(lp), cfg1, mesh=mesh)
        r2 = pdas_dd(make_pdas_dd(lp, warm=r1), cfg2, mesh=mesh)
        torch.cuda.synchronize()
        took = time.perf_counter() - t
        launched = _counted(counters)
        ref = info["objective"]
        gap = float(r2.extra["gap"])
        err = abs(float(r2.objective) - ref) / (1.0 + abs(ref))
        say(f"[mesh tp pilot] pdas + pdas_dd with mesh=: {int(r1.iterations)} + "
            f"{int(r2.iterations)} iterations (phase 5: 27 + 16), {r2.status_name}, gap "
            f"{gap:.3e}, objective error {err:.3e}, {took:.3f} s (phase 5's second "
            f"solve {pilot_s:.3f} s) on {card}; launches "
            f"{ {k: v for k, v in launched.items() if v} }")
        if not (gap <= 1e-8 and err <= 1e-7 and launched["mv"] > 0
                and launched["rmv"] > 0 and np.isfinite(r2.x.cpu().numpy()).all()):
            raise AssertionError(f"mesh tp pilot: gap {gap}, error {err}, {launched}")
        paths["mesh tp pilot"] = launched
        # (b) the sparse tp path: the m = 16384 LP on a fresh engine, the
        # api's at-scale two-phase flow (AT_SCALE_KW) with mesh=.
        t = time.perf_counter()
        cold, eng = make_pdas_sparse(sf8, block=AT_SCALE_KW["block"], **f32)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        p1 = PDASConfig(max_iters=500, refine_steps=2, mehrotra=True)
        p2 = PDASConfig(max_iters=500, gap_tol=1e-9, refine_steps=2, mehrotra=True,
                        entry_repair_tol=AT_SCALE_KW["entry_repair_tol"])
        _reset(*counters.values())
        torch.cuda.synchronize()
        t = time.perf_counter()
        r1 = pdas(cold, p1, engine=eng, mesh=mesh)
        l, u, mask = cold.lp.l, cold.lp.u, cold.lp.col_mask
        x = _into_interior(r1.x, l, u, mask)
        w, z = mu_recentered_duals(x, l, u, torch.clamp_min(r1.extra["w"], 1e-8),
                                   torch.clamp_min(r1.extra["z"], 1e-8), mask)
        st = PDASDDState(x=ddm.dd_from(x), y=ddm.dd_from(r1.extra["y"]),
                         w=ddm.dd_from(w), z=ddm.dd_from(z), lp=cold.lp)
        r2 = pdas_dd(st, p2, engine=eng, mesh=mesh)
        torch.cuda.synchronize()
        took = time.perf_counter() - t
        launched = _counted(counters)
        ref = info8["objective"]
        gap = float(r2.extra["gap"])
        err = abs(float(r2.objective) - ref) / abs(ref)
        factorizations = launched["assemble_pairs"]
        say(f"[mesh tp at scale] engine {build_s:.3f} s ({eng.B} panels); pdas + pdas_dd "
            f"with mesh=: {int(r1.iterations)} + {int(r2.iterations)} iterations (phase 8: "
            f"12 + 4), {r2.status_name}, gap {gap:.3e}, objective error {err:.3e}, "
            f"{took:.3f} s on {card}; {factorizations} factorizations, K1 "
            f"{launched['potrf_tile']} ({launched['potrf_tile'] / max(factorizations, 1):.0f}"
            f" a factorization); launches {launched}")
        if not (gap <= 1e-6 and err <= 1e-5
                and factorizations >= int(r1.iterations) + int(r2.iterations)
                and launched["potrf_tile"] == eng.B * factorizations
                and launched["assemble_pairs_batched"] == 0
                and launched["potrf_tile_batched"] == 0
                and launched["tile_schur"] + launched["tile_schur_batched"] == 0):
            raise AssertionError(f"mesh tp at scale: gap {gap}, error {err}, {launched}")
        paths["mesh tp at scale"] = launched
        # (c) the dp batch: phase 15 (c)'s mix through solve_batch with and
        # without the mesh, in turns.
        ineqs = [_mixed_batch_lp(s) for s in range(BATCH_MIXED)]
        mixed = [_sf_of(cimt, q) for q in ineqs]
        highs = np.array([scipy_reference_solution(q)[1] for q in ineqs])
        kw = dict(max_iters=60, mehrotra=True)
        times = {"plain": [], "mesh": []}
        reps = {}
        for tag in ("plain", "mesh"):
            _reset(*counters.values())
            out, took = _seconds(lambda: cimt.solve_batch(
                mixed, mesh=mesh if tag == "mesh" else None, **kw))
            reps[tag] = out
            times[tag].append(took)
            if tag == "mesh":
                paths["mesh dp solve_batch"] = _counted(counters)
        st_p = np.array([int(r.result.status) for r in reps["plain"]])
        st_m = np.array([int(r.result.status) for r in reps["mesh"]])
        obj = np.array([r.objective for r in reps["mesh"]])
        opt = st_m == Status.OPTIMAL
        err = np.abs(obj - highs) / np.maximum(1.0, np.abs(highs))
        say(f"[mesh dp batch] {BATCH_MIXED} LPs: statuses equal {bool((st_p == st_m).all())}"
            f", optimal {int(opt.sum())}, worst objective error of an optimal lane vs "
            f"HiGHS {err[opt].max():.3e} (limit 1e-3); solves/s plain "
            + " ".join(f"{BATCH_MIXED / t:.1f}" for t in times["plain"]) + ", mesh "
            + " ".join(f"{BATCH_MIXED / t:.1f}" for t in times["mesh"])
            + f" on {card}; launches "
            f"{ {k: v for k, v in paths['mesh dp solve_batch'].items() if v} }")
        if not ((st_p == st_m).all() and opt.any() and (err[opt] <= 1e-3).all()
                and paths["mesh dp solve_batch"]["mv_batched"] > 0):
            raise AssertionError(f"mesh dp batch: statuses {st_m}, errors {err[opt].max()}")
    finally:
        dist.destroy_process_group()
    # (d) a batch of dense states on one dense-A engine: the pilot's A,
    # each lane its own (b, c).
    lps = [to_device_lp(s, pad_multiple=128, **f32) for s in _drifted(sf, DENSE_A_LANES)]
    states = [make_pdas(x) for x in lps]
    eng = engine_for(states[0].lp.A, block=128)
    c1 = PDASConfig(max_iters=500, refine_steps=2, mehrotra=True)
    c2 = PDASConfig(max_iters=500, gap_tol=1e-9, refine_steps=2, mehrotra=True)
    _reset(*counters.values())
    torch.cuda.synchronize()
    t = time.perf_counter()
    b1 = parallel.batched_pdas(parallel.stack_states(states), c1, engine=eng)
    torch.cuda.synchronize()
    paths["dense-A batch pdas"] = _counted(counters)
    _reset(*counters.values())
    dd_states = [make_pdas_dd(x, warm=lanes.lane(b1, k)) for k, x in enumerate(lps)]
    b2 = parallel.batched_pdas_dd(parallel.stack_states(dd_states), c2, engine=eng)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t
    paths["dense-A batch pdas_dd"] = _counted(counters)
    t = time.perf_counter()
    singles = []
    for x in lps:
        s1 = pdas(make_pdas(x), c1, engine=eng)
        singles.append((s1, pdas_dd(make_pdas_dd(x, warm=s1), c2, engine=eng)))
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t
    rows = []
    bad = []
    # A finisher that stops at the f32 precision floor (the JAX package's
    # own limit, ROADMAP §3) where its twin reaches the gap is held to the
    # objective bar, as phase 16 (c) holds its floored lanes.
    floor_or_optimal = {Status.OPTIMAL, Status.PRECISION_FLOOR}
    for k, (s1, s2) in enumerate(singles):
        rel = abs(float(b2.objective[k]) - float(s2.objective)) / max(1.0, abs(float(s2.objective)))
        st = (int(b2.status[k]), int(s2.status))
        rows.append(f"{k}: {int(b1.iterations[k])}+{int(b2.iterations[k])} vs "
                    f"{int(s1.iterations)}+{int(s2.iterations)}, statuses {st}, gaps "
                    f"{float(b2.extra['gap'][k]):.2e} / {float(s2.extra['gap']):.2e}, "
                    f"objectives apart {rel:.1e}")
        if not (int(b1.status[k]) == int(s1.status) and rel <= 1e-6
                and (st[0] == st[1] or set(st) == floor_or_optimal)):
            bad.append(k)
    say(f"[dense-A batch] {DENSE_A_LANES} lanes of the pilot's A {tuple(states[0].lp.A.shape)}"
        f" on engine_for(block=128) ({eng.B} panels): batched pdas + pdas_dd statuses "
        f"{b1.status.tolist()} / {b2.status.tolist()}; lane: batch vs single counts "
        + "; ".join(rows)
        + f"; {DENSE_A_LANES / batch_s:.2f} two-phase solves/s batched ({batch_s:.3f} s) "
        f"against {DENSE_A_LANES / single_s:.2f} single ({single_s:.3f} s) on {card}")
    for tag in ("dense-A batch pdas", "dense-A batch pdas_dd"):
        got = paths[tag]
        say(f"[{tag}] launches { {k: v for k, v in got.items() if v} }")
        if not (got["potrf_tile_batched"] > 0 and got["potrf_tile_batched"] % eng.B == 0
                and got["mv_batched"] > 0 and got["rmv_batched"] > 0
                and got["potrf_tile"] == got["mv"] == got["rmv"] == 0):
            raise AssertionError(f"{tag}: launches {got}")
    if bad:
        raise AssertionError(f"dense-A batch: lanes {bad} differ from their single solves")
    say(f"[mesh] phase 18 took {time.perf_counter() - t_phase:.3f} s")
    return paths


ROOT = os.path.dirname(os.path.abspath(__file__))
# Phase 19 (b): the kernels' functions in the profiler's trace (a pattern of
# names: dd A·x is either kernel, rows of at most dd_cuda.MV_SHORT_MAX
# columns taking the short-row one; dd Aᵀ·x either, lanes of at most
# dd_cuda.RMV_SHORT_SLABS slabs taking the short-lane one), and the counters
# whose deltas they must equal (a batched launch runs the same functions).
TRACED = {"dd_mv_kernel|dd_mv_short_kernel": ("mv", "mv_batched"),
          "dd_rmv_kernel|dd_rmv_short_kernel": ("rmv", "rmv_batched"),
          "potrf_tile_kernel": ("potrf_tile", "potrf_tile_batched"),
          "assemble_chunks_kernel": ("assemble_pairs", "assemble_pairs_batched"),
          "bell_dd_mv_kernel": ("bell_mv", "bell_mv_batched")}


def _write_mps(sf, path):
    """A StandardForm of equality rows as an MPS file: columns in order,
    each column's entries in the COO order, every value by ``repr``, so that
    reading it back gives the same arrays in the same order.  (The package's
    ``utils/testing.py::write_mps`` loops over a dense A.)"""
    if not (np.all(sf.row_type == 0) and sf.obj_sign == 1.0):
        raise ValueError("_write_mps takes a minimization with equality rows")
    order = np.argsort(sf.a_cols, kind="stable")
    rows, cols, vals = sf.a_rows[order], sf.a_cols[order], sf.a_vals[order]
    starts = np.searchsorted(cols, np.arange(sf.nvars + 1))
    out = ["NAME          STANDARD", "ROWS", " N  OBJ"]
    out += [f" E  R{i}" for i in range(sf.ncons)]
    out.append("COLUMNS")
    for j in range(sf.nvars):
        if sf.c[j] != 0.0 or starts[j] == starts[j + 1]:
            out.append(f"    C{j}  OBJ  {float(sf.c[j])!r}")
        out += [f"    C{j}  R{i}  {float(v)!r}"
                for i, v in zip(rows[starts[j]:starts[j + 1]], vals[starts[j]:starts[j + 1]])]
    out.append("RHS")
    out += [f"    RHS  R{i}  {float(v)!r}" for i, v in enumerate(sf.b) if v != 0.0]
    out.append("BOUNDS")
    for j, (lo, hi) in enumerate(zip(sf.l, sf.u)):
        if lo == -np.inf:
            out.append(f" MI BND  C{j}")  # the reader's MI also sets ub = 0
            if hi != 0.0:
                out.append(f" UP BND  C{j}  {float(hi)!r}" if hi != np.inf
                           else f" PL BND  C{j}")
            continue
        if lo != 0.0:
            out.append(f" LO BND  C{j}  {float(lo)!r}")
        if hi != np.inf:
            out.append(f" UP BND  C{j}  {float(hi)!r}")
    out.append("ENDATA")
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\n")
    import cholesky_is_magic_tpu_torch as cimt

    back = cimt.to_standard_form(cimt.read_mps_file(path))
    for k in ("a_rows", "a_cols", "a_vals", "b", "c", "l", "u"):
        if not np.array_equal(getattr(back, k), getattr(sf, k)):
            raise AssertionError(f"{path}: {k} does not round-trip")


def _cli(cli_main, counters, argv):
    """``python -m cholesky_is_magic_tpu_torch`` in this process: stdout
    captured, the counters reset just before and read just after.  Returns
    its lines, its JSON line, the launches and the host seconds."""
    import contextlib
    import io

    buf = io.StringIO()
    _reset(*counters.values())
    torch.cuda.synchronize()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    took = time.perf_counter() - t
    launches = _counted(counters)
    lines = buf.getvalue().splitlines()
    if rc != 0:
        raise AssertionError(f"CLI {argv}: exit {rc}")
    return lines, json.loads(lines[-1]), launches, took


def _cli_line(tag, out, err, took, launches, earlier):
    say(f"[cli] {tag}: status {out['status']}  iterations {out['phase1_iterations']} + "
        f"{out['iterations']} ({earlier})  gap {out['gap']:.3e}  objective "
        f"{out['objective']:.12f}  objective error {err:.3e}  wall_seconds "
        f"{out['wall_seconds']}  host {took:.3f} s  launches "
        f"{ {k: v for k, v in launches.items() if v} }")


def _trace_kernels(logdir):
    """The written trace's size in MB, its kernel events by TRACED function
    and its annotation names."""
    import glob
    import re

    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"profile_trace wrote {files}")
    mb = os.path.getsize(files[0]) / 1e6
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    pats = {k: re.compile(rf"\b(?:{k})\b") for k in TRACED}
    counts = dict.fromkeys(TRACED, 0)
    for ev in events:
        if ev.get("cat") == "kernel":
            for k, pat in pats.items():
                if pat.search(ev.get("name", "")):
                    counts[k] += 1
    names = {ev.get("name") for ev in events
             if ev.get("cat") in ("user_annotation", "gpu_user_annotation")}
    return mb, counts, names, sum(ev.get("cat") == "kernel" for ev in events)


def phase_cli(cimt, counters, card, sf8, info8, eng8, rep8, pilot_counts):
    """Phase 19, the command line and the tools on the card: (a) the pilot
    and the m = 16384 LP through ``main([...])`` from MPS files, the latter
    with ``--report``, and afiro through a real ``python -m`` process; (b)
    ``diag.profile_trace`` around afiro's pdas_dd and one factorization and
    solve on phase 8's engine, its kernel events against the counters; (c)
    ``device_memory_report``, ``live_buffer_report``, a checkpoint round
    trip and warm start, ``nan_debug`` and ``checked_solve_kkt_newton``.
    Returns the launches of each path."""
    import gc
    import tempfile

    from cholesky_is_magic_tpu_torch.__main__ import main as cli_main
    from cholesky_is_magic_tpu_torch.ingest.device import to_device_lp
    from cholesky_is_magic_tpu_torch.kkt import dense_kkt_operator, kkt_residuals
    from cholesky_is_magic_tpu_torch.ops import bell as bell_ops
    from cholesky_is_magic_tpu_torch.ops import cuda_build
    from cholesky_is_magic_tpu_torch.solvers.pdas import (
        PDASConfig,
        make_pdas,
        make_pdas_sparse,
        pdas,
    )
    from cholesky_is_magic_tpu_torch.utils import checkpoint, diag, lanes
    from cholesky_is_magic_tpu_torch.utils.testing import constructed_optimum_lp

    t_phase = time.perf_counter()
    paths = {}
    sf5, info5 = constructed_optimum_lp("pilot", seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the CLI at full width.
        pilot_mps, scale_mps = os.path.join(tmp, "pilot.mps"), os.path.join(tmp, "m16384.mps")
        t = time.perf_counter()
        _write_mps(sf5, pilot_mps)
        _write_mps(sf8, scale_mps)
        say(f"[cli] MPS files written and read back bit-equal in "
            f"{time.perf_counter() - t:.3f} s: pilot {os.path.getsize(pilot_mps) / 1e6:.1f} MB,"
            f" m = 16384 {os.path.getsize(scale_mps) / 1e6:.1f} MB")
        _, out, launches, took = _cli(cli_main, counters, [
            pilot_mps, "--solver", "pdas_dd", "--json", "--pad", "128"])
        ref = info5["objective"]
        err = abs(out["objective"] - ref) / (1.0 + abs(ref))
        _cli_line("pilot pdas_dd", out, err, took, launches,
                  f"phase 5: {pilot_counts[0]} + {pilot_counts[1]}")
        if not (out["gap"] <= 1e-8 and err <= 1e-7 and launches["mv"] > 0
                and launches["rmv"] > 0):
            raise AssertionError(f"cli pilot: {out}, {launches}")
        paths["cli pilot pdas_dd"] = launches

        live = [diag.live_buffer_report()]
        lines, out, launches, took = _cli(cli_main, counters, [
            scale_mps, "--solver", "pdas_dd", "--sparse", "--block", "128", "--mehrotra",
            "--entry-repair-tol", "1e-6", "--json", "--report"])
        live.append(diag.live_buffer_report())
        ref = info8["objective"]
        err = abs(out["objective"] - ref) / abs(ref)
        _cli_line("m = 16384 pdas_dd", out, err, took, launches,
                  f"phase 8: {rep8.summary['phase1_iterations']} + "
                  f"{rep8.summary['iterations']}")
        if not (out["gap"] <= 1e-6 and err <= 1e-5 and launches["potrf_tile"] > 0
                and launches["assemble_pairs"] > 0):
            raise AssertionError(f"cli at scale: {out}, {launches}")
        paths["cli at scale pdas_dd"] = launches
        report, direct = "\n".join(lines[:-1]), diag.factor_report(eng8.plan)
        say("[cli] --report: " + report.replace("\n", " | "))
        if report != direct:
            raise AssertionError(f"--report differs from factor_report on phase 8's plan:"
                                 f"\n{report}\n{direct}")
        mem = diag.device_memory_report()
        mib = {k: mem[k] / 2**20 for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")}
        say(f"[memory] after the m = 16384 CLI run: in use {mib['bytes_in_use']:.1f} MiB,"
            f" peak {mib['peak_bytes_in_use']:.1f} MiB, limit {mib['bytes_limit']:.1f} MiB")
        if not 0 < mem["peak_bytes_in_use"] <= mem["bytes_limit"]:
            raise AssertionError(f"device_memory_report: {mib}")
        del lines, out
        gc.collect()
        live.append(diag.live_buffer_report())
        say("[memory] live tensors before / after the run / after del and gc: "
            + " / ".join(f"{r['count']} storages {r['bytes'] / 2**20:.1f} MiB" for r in live))

        lib = cuda_build.library_path()
        built = (lib.stat().st_mtime_ns, sorted(os.listdir(lib.parent)))
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "cholesky_is_magic_tpu_torch", AFIRO, "--solver",
             "pdas_dd", "--json"], cwd=ROOT, capture_output=True, text=True, timeout=300)
        took = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f"python -m: exit {proc.returncode}\n{proc.stderr[-3000:]}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        err = abs(out["objective"] - AFIRO_OPTIMUM) / abs(AFIRO_OPTIMUM)
        same_lib = (lib.stat().st_mtime_ns, sorted(os.listdir(lib.parent))) == built
        say(f"[cli] python -m cholesky_is_magic_tpu_torch afiro.mps --solver pdas_dd --json:"
            f" exit 0 in {took:.3f} s (process start, import, CUDA context, solve);"
            f" status {out['status']}  {out['phase1_iterations']} + {out['iterations']}"
            f"  gap {out['gap']:.3e}  objective error {err:.3e}  wall_seconds"
            f" {out['wall_seconds']}; kernel library loaded from {lib.name}, not rebuilt:"
            f" {same_lib}")
        if not (out["gap"] <= 1e-8 and err <= 1e-7 and same_lib):
            raise AssertionError(f"python -m afiro: {out}, library unchanged {same_lib}")

    # (b) profile_trace on the card.
    st8, _ = make_pdas_sparse(sf8, engine=eng8, device="cuda")
    if st8.lp.ETB is None:
        raise AssertionError("trace: the block-ELL rendering of Aᵀ was gated out")
    x = rep8.result.x
    s = torch.sqrt(torch.clamp_min(torch.minimum(x - st8.lp.l, st8.lp.u - x), 1e-6))
    boost = torch.zeros(st8.lp.m, device="cuda")
    rhs = torch.ones(eng8.B * eng8.b, device="cuda")
    with tempfile.TemporaryDirectory() as logdir:
        before = _counted(counters)
        t = time.perf_counter()
        with diag.profile_trace(logdir):
            with diag.annotate("pdas_dd"):
                rep = cimt.solve(AFIRO, "pdas_dd", device="cuda", dtype=torch.float32)
            torch.cuda.synchronize()
            mid = _counted(counters)
            with diag.annotate("engine"):
                L, invd, ok = eng8.factorize(eng8.assemble_pairs(s, boost))
                y = eng8.solve(L, invd, rhs)
                r = bell_ops.dd_matvec(st8.lp.ETB, y[:st8.lp.m])  # a refinement's dd Aᵀ·y
        took = time.perf_counter() - t
        after = _counted(counters)
        mb, counts, names, n_kernels = _trace_kernels(logdir)
    paths["trace afiro pdas_dd"] = {k: mid[k] - before[k] for k in after}
    paths["trace engine"] = {k: after[k] - mid[k] for k in after}
    deltas = {f: sum(after[k] - before[k] for k in ks) for f, ks in TRACED.items()}
    say(f"[trace] profile_trace around afiro pdas_dd ({rep.summary['phase1_iterations']} +"
        f" {rep.summary['iterations']}, gap {rep.summary['gap']:.3e}) and one factorization"
        f" + solve on phase 8's engine (ok {bool(ok)}, y finite"
        f" {bool(torch.isfinite(y).all())}): {took:.3f} s, trace {mb:.1f} MB,"
        f" {n_kernels} kernel events; hand-written kernels in the trace {counts},"
        f" counter deltas {deltas}; annotations {sorted(n for n in names if n in ('pdas_dd', 'engine'))}")
    if counts != deltas or not {"pdas_dd", "engine"} <= names or not all(deltas.values()):
        raise AssertionError(f"trace: kernels {counts} vs counters {deltas}, annotations {names}")
    if not (bool(ok) and bool(torch.isfinite(y).all()) and rep.summary["gap"] <= 1e-8
            and bool(torch.isfinite(r.hi).all())):
        raise AssertionError("trace: the traced solve, factorization or product failed")

    # (c) checkpoint, checked mode.
    lp = to_device_lp(sf5, pad_multiple=128, dtype=torch.float32, device="cuda")
    st = make_pdas(lp)
    r5 = pdas(st, PDASConfig(max_iters=5))
    mid_st = dataclasses.replace(st, x=r5.x, y=r5.extra["y"], w=r5.extra["w"], z=r5.extra["z"])
    with tempfile.TemporaryDirectory() as ck:
        checkpoint.save(ck, mid_st)
        size = os.path.getsize(os.path.join(ck, "state.pt")) / 2**20
        restored = checkpoint.load(ck, make_pdas(lp))
    got, want = lanes.flatten(restored)[0], lanes.flatten(mid_st)[0]
    equal = len(got) == len(want) and all(
        a.is_cuda and a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))
    cold = pdas(make_pdas(lp), PDASConfig())
    warm = pdas(make_pdas(lp, warm=restored), PDASConfig())
    say(f"[checkpoint] pilot pdas state after 5 iterations ({len(want)} tensors,"
        f" {size:.1f} MiB): loaded onto cuda bit-equal {equal}; cold pdas"
        f" {int(cold.iterations)} iterations ({cold.status_name}), warm from the checkpoint"
        f" {int(warm.iterations)} ({warm.status_name})")
    if not (equal and int(warm.iterations) <= int(cold.iterations)):
        raise AssertionError("checkpoint: round trip or warm start")
    try:
        with diag.nan_debug():
            zero = torch.zeros(4, device="cuda")
            zero / zero
    except FloatingPointError as e:
        say(f"[nan_debug] CUDA 0/0 raised FloatingPointError: {e}")
    else:
        raise AssertionError("nan_debug: a CUDA 0/0 did not raise")
    rng = np.random.default_rng(1)
    m, n = 64, 128
    put = lambda v: torch.as_tensor(v, dtype=torch.float32, device="cuda")  # noqa: E731
    pos = lambda k: put(0.1 + rng.random(k))  # noqa: E731
    A = put(rng.normal(size=(m, n)))
    sl, su, w, z, e, f = (pos(n) for _ in range(6))
    g, h = put(rng.random(m)), pos(n)
    op = dense_kkt_operator(A)
    deltas = diag.checked_solve_kkt_newton(sl, su, w, z, op, e, f, g, h)
    res = kkt_residuals(sl, su, w, z, op, e, f, g, h, deltas)
    try:
        diag.checked_solve_kkt_newton(sl, su, w, z, dense_kkt_operator(torch.zeros_like(A)),
                                      e, f, g, h)
    except diag.KKTCheckError as err:
        raised = str(err)
    else:
        raise AssertionError("checked_solve_kkt_newton: a zero A did not raise")
    say(f"[checked] f32 CUDA KKT system {m} x {n}: passed, residuals "
        f"{[f'{float(r):.2e}' for r in res]}; zero A raised: {raised}")
    say(f"[cli] phase 19 took {time.perf_counter() - t_phase:.3f} s")
    return paths


def main() -> int:
    card = phase_device()
    import cholesky_is_magic_tpu_torch as cimt
    from cholesky_is_magic_tpu_torch.ops import bell, bell_cuda, chol, chol_cuda, cuda_build
    from cholesky_is_magic_tpu_torch.ops import dd as ddm
    from cholesky_is_magic_tpu_torch.ops import dd_cuda, dense
    from cholesky_is_magic_tpu_torch.sparse import tiled_cuda
    from cholesky_is_magic_tpu_torch.utils.precision import set_highest_precision

    set_highest_precision()
    phase_build(cuda_build)
    counters = {"dd": dd_cuda.LAUNCHES, "chol": chol_cuda.LAUNCHES,
                "tiled": tiled_cuda.LAUNCHES, "bell": bell_cuda.LAUNCHES}
    stats = phase_kernels(ddm, dd_cuda)
    phase_bell(bell, bell_cuda, stats)
    phase_afiro(cimt)
    phase_afiro_f64(cimt, counters)
    launches, pilot_s, pilot_counts = phase_pilot(cimt, dd_cuda, card)
    chol_launches = phase_chol(chol, chol_cuda, dense, stats)
    launches.update(potrf_panel=chol_launches["potrf_panel"],
                    potrf_schur=chol_launches["potrf_schur"])
    sf, info, eng = build_at_scale_engine()
    phase_assembly(eng, stats)
    phase_tile_schur(chol_cuda, tiled_cuda, stats)
    phase_tile_solve(tiled_cuda, stats)
    phase_sparse_afiro(cimt)
    sparse_launches, rep = phase_at_scale(cimt, sf, info, counters, card)
    launches.update(potrf_tile=sparse_launches["potrf_tile"],
                    assemble_pairs=sparse_launches["assemble_pairs"],
                    bell_mv=sparse_launches["bell_mv"],
                    tile_schur=sparse_launches["tile_schur"],
                    tile_solve=sparse_launches["tile_solve"])
    phase_breakdown(cimt, sf, eng, rep, chol)
    phase_block256(cimt, sf, info, eng, counters, card)
    by_path = {"pdas_dd": dict(launches),
               "affine pilot f32": phase_affine(cimt, counters, card),
               "affine at scale": phase_affine_at_scale(cimt, sf, info, counters, card),
               "presolve pdas_dd": phase_presolve(cimt, counters)}
    (by_path["crossover afiro"], by_path["crossover pilot"],
     by_path["crossover at scale"]) = phase_crossover(cimt, counters, card, pilot_s,
                                                      sf, info, eng, rep)
    by_path["alm dd pilot"] = phase_alm(cimt, counters, card, sf, info)
    (by_path["batch pdas"], by_path["batch pdas_dd"], same_sfs,
     same_highs) = phase_batch(cimt, ddm, dd_cuda, counters, card, stats)
    by_path.update(phase_batch_sparse(cimt, counters, card, stats, sf, eng,
                                      same_sfs, same_highs))
    by_path.update(phase_dense_engines(cimt, counters, card, pilot_s))
    by_path.update(phase_mesh(cimt, counters, card, pilot_s, sf, info))
    by_path.update(phase_cli(cimt, counters, card, sf, info, eng, rep, pilot_counts))
    say(card_line())  # name, power limit: exactly as nvidia-smi prints them
    # Every kernel's max_abs_err, ms, plain_ms, bound_ms, bound_by and
    # library_ms; the panel kernel's ms_with_copy and the assembly kernel's
    # times with the host's launches in them besides.  ``launches`` sums
    # every main path's run; ``launches_by_path`` keeps each apart.
    kernels = [dict(KERNELS[k], route="cuda",
                    launches=sum(p.get(k, 0) for p in by_path.values()),
                    launches_by_path={n: p.get(k, 0) for n, p in by_path.items()},
                    **stats[k])
               for k in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
