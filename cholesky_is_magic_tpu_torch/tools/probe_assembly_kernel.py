"""The pair-schedule assembly kernel on the m = 16384 constructed LP: the
schedule's runs, a fingerprint of the tiles, and the kernel's time by
chunk size and by pass.

    python -m cholesky_is_magic_tpu_torch.tools.probe_assembly_kernel [--block 128 256]

Per block size it builds the engine of ``constructed_optimum_lp(m=16384,
seed=0)`` (row-scaled as ``solve`` scales it), and prints

- the number of pairs and of runs (destinations), the mean and the longest
  run, and how many runs have 1, 2, 3-4, 5-8, ... pairs;
- sha256 of ``eng.assemble_pairs(d, boost)`` for a seeded d, twice.  This
  part uses nothing but the engine's public method, so the same file run
  against another tree of the package (``PYTHONPATH=<tree> python <this
  file>``) shows whether two kernels agree bit for bit;
- where the package has ``tiled_cuda.kernel_schedule``: CUDA-event medians
  of the kernel at chunk sizes 1024 ... 16384 (the card asleep until the
  host has queued the launch, tiles allocated inside the timed call as the
  solver's are) and of ``torch.zeros`` of the tiles; every chunk size must
  give the same tiles.  Then its zeros and its runs apart at the wrapper's
  chunk: two copies of ``csrc/assemble_pairs.cu``, one that returns after
  the zeros and one that writes none, built here (:func:`pass_launchers`).

Needs one CUDA card and nvcc; imports no jax.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess

import numpy as np
import torch

M = 16384
SLEEP_CYCLES = 400_000  # ~0.2 ms at ~2 GHz
# Edits of csrc/assemble_pairs.cu: a block returns after its zeros; a block
# has no entries to zero.
ZEROS_ONLY = ("  __syncthreads();  // the block's zeros before the block's sums\n",
              "  return;\n")
RUNS_ONLY = ("  const int e1 = min(total, e0 + chunk);\n", "  const int e1 = e0;\n")


def engine(block: int):
    import scipy.sparse as sp

    from cholesky_is_magic_tpu_torch.ingest.standard_form import scale_constraints
    from cholesky_is_magic_tpu_torch.sparse.tiled import engine_for_sparse
    from cholesky_is_magic_tpu_torch.utils.testing import constructed_optimum_lp

    sf, _ = constructed_optimum_lp(m=M, seed=0)
    vals, _ = scale_constraints(sf.a_rows, sf.a_vals, sf.b)
    A = sp.csc_matrix((vals, (sf.a_rows, sf.a_cols)), shape=(sf.ncons, sf.nvars))
    return engine_for_sparse(A, block=block, device="cuda"), sf.nvars


def median_ms(fn, reps=20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def pass_launchers(eng, d, boost):
    """Two functions of no arguments that launch, on ``eng``'s schedule, a
    copy of the assembly kernel that only writes its zeros, and one that only
    sums its runs; each allocates its tiles as the wrapper does.  Built here
    from copies of csrc/assemble_pairs.cu, both nvcc started together."""
    from cholesky_is_magic_tpu_torch.ops import cuda_build
    from cholesky_is_magic_tpu_torch.sparse import tiled_cuda

    out_dir = cuda_build.BUILD_DIR / "probe_assembly"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (cuda_build.CSRC_DIR / "assemble_pairs.cu").read_text()
    procs = []
    for name, (old, new) in (("zeros_only", ZEROS_ONLY), ("runs_only", RUNS_ONLY)):
        if text.count(old) != 1:
            raise RuntimeError(f"assemble_pairs.cu has changed: {old!r}")
        cu = out_dir / f"assemble_pairs_{name}.cu"
        cu.write_text(text.replace(old, new))
        cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-shared", str(cu),
               "-o", str(cu.with_suffix(".so"))]
        procs.append((cu.with_suffix(".so"), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    sched = eng._kernel_schedule
    rb = boost.to(torch.float32).contiguous()
    shape = (eng.NT + 1, eng.b, eng.b)
    stream = torch.cuda.current_stream(d.device).cuda_stream

    def launcher(so):
        fn = ctypes.CDLL(str(so)).cim_assemble_pairs_f32
        fn.argtypes = tiled_cuda._SIGNATURES["cim_assemble_pairs_f32"]
        fn.restype = ctypes.c_int

        def launch():
            tiles = torch.empty(shape, dtype=torch.float32, device=d.device)
            cuda_build.raise_on(fn(
                tiles.data_ptr(), tiles.numel(), sched.chunk, eng.asm_w.data_ptr(),
                sched.k.data_ptr(), d.data_ptr(), sched.run_start.data_ptr(),
                sched.run_dst.data_ptr(), sched.run_row.data_ptr(),
                sched.chunk_run.data_ptr(), rb.data_ptr(), rb.shape[0], stream),
                "assemble_pairs, one pass")
            return tiles
        return launch

    launchers = []
    for so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {so.name}:\n{log}")
        launchers.append(launcher(so))
    return tuple(launchers)


def probe(block: int, reps: int) -> None:
    from cholesky_is_magic_tpu_torch.sparse import tiled_cuda

    eng, n = engine(block)
    lengths = np.diff(eng.asm_run_start.cpu().numpy())
    edges = [1, 2, 3, 5, 9, 17, 33, 65, 1 << 30]
    hist = ", ".join(
        f"{lo}" + ("" if hi == lo + 1 else f"-{hi - 1}" if hi < 1 << 30 else "+")
        + f": {int(((lengths >= lo) & (lengths < hi)).sum())}"
        for lo, hi in zip(edges[:-1], edges[1:]))
    print(f"[assembly probe] block {block}: {eng.n_pairs} pairs in {len(lengths)} runs "
          f"into {eng.NT + 1} tiles; mean run {lengths.mean():.2f}, longest "
          f"{lengths.max()}; runs by length: {hist}", flush=True)
    rng = np.random.default_rng(12)
    d = torch.from_numpy((10.0 ** (3 * rng.random(n) - 1.5)).astype(np.float32)).cuda()
    boost = torch.from_numpy(((rng.random(M) < 0.1) * 0.5).astype(np.float32)).cuda()
    tiles = [eng.assemble_pairs(d, boost) for _ in range(2)]
    digest = [hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16] for t in tiles]
    print(f"[assembly probe] block {block}: tiles sha256 {digest[0]}, second run "
          f"{'same' if digest[1] == digest[0] else digest[1]}", flush=True)
    whole = [median_ms(lambda: eng.assemble_pairs(d, boost), reps) for _ in range(2)]
    zeros = median_ms(lambda: torch.zeros_like(tiles[0]), reps)
    print(f"[assembly probe] block {block}: assemble_pairs {whole[0]:.4f} {whole[1]:.4f} ms;"
          f" torch.zeros of the tiles {zeros:.4f} ms", flush=True)
    if not hasattr(tiled_cuda, "kernel_schedule"):
        return
    own = eng._kernel_schedule
    run_start, run_dst = (t.cpu().numpy() for t in (eng.asm_run_start, eng.asm_run_dst))
    for chunk in (1024, 2048, 4096, 8192, 16384):
        eng._kernel_schedule = tiled_cuda.kernel_schedule(eng, run_start, run_dst, chunk)
        if not torch.equal(eng.assemble_pairs(d, boost), tiles[0]):
            raise AssertionError(f"chunk {chunk} gives other tiles")
        t = [median_ms(lambda: eng.assemble_pairs(d, boost), reps) for _ in range(2)]
        print(f"[assembly probe] block {block} chunk {chunk:5d}: {t[0]:.4f} {t[1]:.4f} ms",
              flush=True)
    eng._kernel_schedule = own
    apart = [median_ms(fn, reps) for fn in pass_launchers(eng, d, boost)]
    print(f"[assembly probe] block {block} chunk {own.chunk} (the wrapper's): zeros only "
          f"{apart[0]:.4f} ms, runs only {apart[1]:.4f} ms", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--block", type=int, nargs="+", default=[128, 256])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    for block in args.block:
        probe(block, args.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[assembly probe] card, power limit: {smi.stdout.strip()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
