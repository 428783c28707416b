"""The Schur kernel's time at every panel step of the blocked potrf, the
potrf's launches one by one, a fingerprint of both, and the kernel by tile
and register shape.

    python -m cholesky_is_magic_tpu_torch.tools.probe_schur_kernel \\
        [--steps] [--timeline] [--hashes] [--host-clock] [--variants] [--stamps]
        [--priority] [--n 1536 1441]

``--steps`` runs the panel loop on an n x n SPD matrix by the tile, panel and
Schur wrappers.  Before each trailing update (t = n - 128 (k + 1), depth
min(128, n - 128 k)) it times, each alone over back-to-back launches between
two CUDA events with the card asleep while the host queues them: the Schur
kernel on the whole trailing block; ``torch.addmm`` of the same block (the
full square, into a fresh output); and, where the wrapper takes ``cols``, the
kernel on the next block column alone and on the block beyond it, the two
launches of ``chol_cuda.potrf``.  The kernel runs in place on one buffer, as
in the loop, where the operands were written just before and lie in the L2
cache.  Prints the times per step, their sums per n, and the first step's
share of its bound (b FMAs per lower entry at 67 TFLOP/s).

``--timeline`` profiles one ``chol.cholesky(N)`` queued behind a sleep and
prints every kernel launch in start order with its own time, the sums by
kernel, the time from the first start to the last end, and the time in
which no kernel ran.

``--hashes`` prints sha256 of the Schur kernel's output on the first step of
each n and of ``chol.cholesky(N)``, and the potrf's own time (back to back
behind a sleep).  ``--host-clock`` prints the host-clock median of 50 calls of
``chol.cholesky(N)`` and of ``torch.linalg.cholesky_ex(N)``, each call
synchronized: the time to the end and the time to queue it.  These four use
only public functions, so ``PYTHONPATH=<tree> python <this file> --hashes``
runs them against another tree of the package: equal hashes mean bit-equal
kernels.

``--variants`` builds one copy of ``csrc/potrf.cu`` per (tile, rows per
thread, columns per thread), its constants rewritten in the copy, every nvcc
started together, and times each on the first, a middle and the last two
steps of n = 1536, whole and on the next block column, in two turns of
opposite order; every variant must give the library's bits.

``--stamps`` builds a copy of the source whose first two blocks (a diagonal
tile and a full one) stamp ``clock64()`` at the kernel's entry, after the
staging is queued, around each k-stage's wait and products, after the read
of S and at the end, and prints the cycles between the stamps on the first
and the last step of n = 1536.

``--priority`` times the potrf behind a sleep with ``chol_cuda``'s first
stream (the chain of dependent kernels) at high and at normal priority, in
turns.

Needs one CUDA card and nvcc; imports no jax.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import inspect
import subprocess
import time

import numpy as np
import torch

from cholesky_is_magic_tpu_torch.ops import chol, chol_cuda

PEAK_FP32_FLOPS = 67e12  # H100 SXM, FP32 outside the tensor cores
SLEEP_CYCLES_PER_MS = 2_000_000  # torch.cuda._sleep cycles, at ~2 GHz
# (tile, rows per thread, columns per thread): every launch at that one shape.
VARIANTS = [(64, 4, 4), (64, 8, 4), (64, 4, 8), (64, 2, 4), (64, 4, 2), (32, 4, 4), (32, 2, 2),
            (32, 4, 2), (32, 2, 4), (128, 8, 8)]
CONSTANTS = [
    ("using SchurBig = SchurShape<64, 4, 4>;", "using SchurBig = SchurShape<{tile}, {rm}, {rn}>;"),
    ("using SchurSmall = SchurShape<32, 4, 2>;",
     "using SchurSmall = SchurShape<{tile}, {rm}, {rn}>;"),
]


# clock64() stamps by thread 0 of the first two blocks, in a copy of the source.
_WAIT = "  stage_wait<{s}>();\n  schur_chunks<Sh, kDiag>(acc, Aw, Bw, {lo}, min({hi}, nk4));\n"
STAMPS = [
    ("namespace {\n",
     "namespace {\n__device__ long long g_stamps[32];\n#define STAMP(i) if (blockIdx.x < 2 "
     "&& threadIdx.x == 0) g_stamps[16 * blockIdx.x + (i)] = clock64();\n"),
    ("  extern __shared__ float4 smem4[];\n  const int ncb",
     "  extern __shared__ float4 smem4[];\n  STAMP(0)\n  const int ncb"),
    ("  // Warp w covers the 4 x 8 threads at", "  STAMP(1)\n  // Warp w covers the 4 x 8 threads at"),
    *[(_WAIT.format(s=i, lo=8 * i, hi=8 * i + 8),
       f"  stage_wait<{i}>();\n  STAMP({2 + 3 * i})\n  schur_chunks<Sh, kDiag>(acc, "
       f"Aw, Bw, {8 * i}, min({8 * i + 8}, nk4));\n  STAMP({3 + 3 * i})\n") for i in range(4)],
    ("  // S's entries, ahead of the last stage's products.\n",
     "  // S's entries, ahead of the last stage's products.\n  STAMP(13)\n"),
    ("      if (gi < t && gj <= gi && gj < cols) S[gi * lds + gj] = "
     "__fsub_rn(sv[p][q], acc[p][q]);\n    }\n  }\n}\n",
     "      if (gi < t && gj <= gi && gj < cols) S[gi * lds + gj] = "
     "__fsub_rn(sv[p][q], acc[p][q]);\n    }\n  }\n  STAMP(14)\n}\n"),
]
STAMP_NAMES = {1: "staging queued", 2: "stage 0 landed", 3: "its products", 5: "stage 1 landed",
               6: "its products", 8: "stage 2 landed", 9: "its products", 11: "stage 3 landed "
               "(S read queued before)", 12: "its products", 13: "S read queued", 14: "S subtracted and stored"}
STAMP_TAIL = ('extern "C" int cim_schur_stamps(long long* out) {\n  return static_cast<int>('
              "cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps)));\n}\n")


def back_to_back_ms(launch, reps: int, sleep_ms: float = 0.1) -> float:
    """Device ms per call of ``launch()`` over ``reps`` calls between two
    CUDA events, after a warm-up call; the card sleeps (``sleep_ms`` per
    call) while the host queues them, so it never waits on the host."""
    launch()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda._sleep(int(SLEEP_CYCLES_PER_MS * sleep_ms * reps))
    ev[0].record()
    for _ in range(reps):
        launch()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def spd(n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    return torch.tensor(M @ M.T / n + np.eye(n), dtype=torch.float32, device="cuda")


def panel_steps(A: torch.Tensor):
    """Runs the panel loop in place on A by the wrappers, one whole Schur
    launch per step; yields (k, S, P) before each trailing update."""
    n, b = A.shape[0], chol_cuda.BLOCK
    inv = torch.empty((b, b), device=A.device)
    for k, off in enumerate(range(0, n - b, b)):
        e = off + b
        chol_cuda.potrf_tile_(A[off:e, off:e], inv)
        chol_cuda.potrf_panel_(A[e:, off:e], inv, A[off:e, e:])
        yield k, A[e:, e:], A[e:, off:e]
        chol_cuda.potrf_schur_(A[e:, e:], A[e:, off:e])


def steps(n: int, reps: int, seed: int) -> None:
    takes_cols = "cols" in inspect.signature(chol_cuda.potrf_schur_).parameters
    b = chol_cuda.BLOCK
    sums = {}
    for k, S, P in panel_steps(spd(n, seed)):
        t = S.shape[0]
        work = S.clone()  # at its own row stride; P stays in the matrix
        out = torch.empty_like(work)
        runs = {"whole": lambda: chol_cuda.potrf_schur_(work, P),
                "addmm": lambda: torch.addmm(work, P, P.T, alpha=-1, out=out)}
        if takes_cols:
            c = min(b, t)
            runs["next block column"] = lambda: chol_cuda.potrf_schur_(work, P, cols=c)
            if t > c:
                runs["beyond it"] = lambda: chol_cuda.potrf_schur_(work[c:, c:], P[c:])
        times = {name: [] for name in runs}
        for turn in (list(runs), list(runs)[::-1]):
            for name in turn:
                times[name].append(back_to_back_ms(runs[name], reps))
        best = {name: min(v) for name, v in times.items()}
        for name, v in best.items():
            sums[name] = sums.get(name, 0.0) + v
        bound = t * (t + 1) * P.shape[1] / PEAK_FP32_FLOPS * 1e3
        print(f"[schur probe] n={n} step {k} t {t}: "
              + ", ".join(f"{name} {v:.4f}" for name, v in best.items())
              + f" ms; bound {bound:.5f} ms ({100 * bound / best['whole']:.0f}% of it)",
              flush=True)
    print(f"[schur probe] n={n} sums over the steps (ms): "
          + ", ".join(f"{name} {v:.4f}" for name, v in sums.items()), flush=True)


def timeline(n: int, seed: int) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    N = spd(n, seed)
    chol.cholesky(N)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SLEEP_CYCLES_PER_MS * 5)
        chol.cholesky(N)
        torch.cuda.synchronize()
    runs = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == DeviceType.CUDA and "potrf_" in e.name)
    if not runs:
        print(f"[schur probe] n={n} timeline: not measured (the profiler saw no kernel)")
        return
    short = {"tile": "K1", "panel": "K2", "schur": "K3"}
    t0, busy_to, idle, by = runs[0][0], runs[0][0], 0.0, {}
    line = []
    for start, end, name in runs:
        key = next(v for k, v in short.items() if f"potrf_{k}_kernel" in name)
        by.setdefault(key, []).append(end - start)
        idle += max(0.0, start - busy_to)
        busy_to = max(busy_to, end)
        line.append(f"{key}@{start - t0:.1f}+{end - start:.1f}")
    print(f"[schur probe] n={n} timeline (kernel@start+duration, us): " + " ".join(line))
    print(f"[schur probe] n={n}: {len(runs)} launches, first start to last end "
          f"{(busy_to - t0) / 1e3:.4f} ms, no kernel running {idle / 1e3:.4f} ms; "
          + "; ".join(f"{k} x {len(v)} sum {sum(v) / 1e3:.4f} ms (median {np.median(v):.1f} us)"
                      for k, v in sorted(by.items())), flush=True)


def hashes(n: int, seed: int) -> None:
    digest = lambda x: hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:16]  # noqa: E731
    N = spd(n, seed)
    _, S, P = next(panel_steps(N.clone()))
    S = S.clone()
    chol_cuda.potrf_schur_(S, P)
    first, second = digest(chol.cholesky(N)), digest(chol.cholesky(N))
    own = [back_to_back_ms(lambda: chol.cholesky(N), 10, sleep_ms=2) for _ in range(3)]
    print(f"[schur hash] n={n}: first trailing update {digest(torch.tril(S))}; "
          f"cholesky {first}, second call {'same' if second == first else second}; "
          f"potrf back to back behind a sleep (ms) " + " ".join(f"{v:.4f}" for v in own),
          flush=True)


def host_clock(n: int, seed: int) -> None:
    N = spd(n, seed)
    for name, fn in (("potrf", lambda: chol.cholesky(N)),
                     ("cholesky_ex", lambda: torch.linalg.cholesky_ex(N))):
        fn()
        torch.cuda.synchronize()
        whole, queued = [], []
        for _ in range(50):
            t = time.perf_counter()
            fn()
            queued.append(time.perf_counter() - t)
            torch.cuda.synchronize()
            whole.append(time.perf_counter() - t)
        print(f"[schur host clock] n={n} {name}: median {np.median(whole) * 1e3:.4f} ms to the "
              f"end, {np.median(queued) * 1e3:.4f} ms to queue it", flush=True)


def priority(n: int, seed: int) -> None:
    N = spd(n, seed)
    dev = N.device
    sets = {name: (torch.cuda.Stream(dev, priority=p), torch.cuda.Stream(dev),
                   *(torch.cuda.Event() for _ in range(3)))
            for name, p in (("high", -1), ("normal", 0))}
    for turn in (("high", "normal"), ("normal", "high"), ("high", "normal")):
        for name in turn:
            chol_cuda._STREAMS[torch.cuda.current_device()] = sets[name]
            ms = [back_to_back_ms(lambda: chol.cholesky(N), 10, sleep_ms=2) for _ in range(3)]
            print(f"[schur priority] n={n} chain stream {name}: "
                  + " ".join(f"{v:.4f}" for v in ms), flush=True)
    del chol_cuda._STREAMS[torch.cuda.current_device()]


def build_variants():
    """One library per variant, each from its own copy of csrc/potrf.cu."""
    from cholesky_is_magic_tpu_torch.ops import cuda_build

    text = (cuda_build.CSRC_DIR / "potrf.cu").read_text()
    out_dir = cuda_build.BUILD_DIR / "probe_schur"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build.find_nvcc()
    procs = {}
    for key in VARIANTS:
        tile, rm, rn = key
        copy = text
        for old, new in CONSTANTS:
            if copy.count(old) != 1:
                raise RuntimeError(f"potrf.cu has changed: {old!r}")
            copy = copy.replace(old, new.format(tile=tile, rm=rm, rn=rn))
        cu = out_dir / f"schur_t{tile}_{rm}x{rn}.cu"
        cu.write_text(copy)
        so = cu.with_suffix(".so")
        cmd = [nvcc, *cuda_build.NVCC_FLAGS, "-shared", str(cu), "-o", str(so)]
        procs[key] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        lines = out.splitlines()
        at = max(i for i, ln in enumerate(lines) if "potrf_schur_kernel" in ln)
        regs = next(ln.strip() for ln in lines[at:] if "registers" in ln)
        lib = ctypes.CDLL(str(so))
        lib.cim_potrf_schur_f32.argtypes = chol_cuda._SIGNATURES["cim_potrf_schur_f32"]
        lib.cim_potrf_schur_f32.restype = ctypes.c_int
        libs[key] = (lib, regs)
    return libs


def variants(reps: int, seed: int) -> None:
    from cholesky_is_magic_tpu_torch.ops import cuda_build

    libs = build_variants()
    for (tile, rm, rn), (_, regs) in libs.items():
        print(f"[schur variants] tile {tile} {rm} x {rn} per thread, "
              f"{(tile // rm) * (tile // rn)} threads: {regs}")
    stream = torch.cuda.current_stream().cuda_stream
    n, b = 1536, chol_cuda.BLOCK
    for k, S, P in panel_steps(spd(n, seed)):
        t = S.shape[0]
        if k not in (0, 5, 9, 10):
            continue
        want = S.clone()
        chol_cuda.potrf_schur_(want, P)
        vec = chol_cuda.aligned16(P.data_ptr(), P.stride(0))
        work = S.clone()

        def launch(lib, cols):
            cuda_build.raise_on(lib.cim_potrf_schur_f32(
                work.data_ptr(), work.stride(0), P.data_ptr(), P.stride(0), t,
                P.shape[1], cols, vec, stream), "schur variant")

        times = {key: ([], []) for key in libs}
        for turn in (list(libs), list(libs)[::-1]):
            for key in turn:
                lib = libs[key][0]
                work.copy_(S)
                launch(lib, t)
                if not torch.equal(work, want):
                    raise AssertionError(f"variant {key} differs from the library's")
                times[key][0].append(back_to_back_ms(lambda: launch(lib, t), reps))
                times[key][1].append(back_to_back_ms(lambda: launch(lib, min(b, t)), reps))
        for (tile, rm, rn), (whole, col) in sorted(times.items(), key=lambda kv: min(kv[1][0])):
            print(f"[schur variants] step {k} t {t}: tile {tile} {rm} x {rn}: whole "
                  f"{whole[0]:.4f} {whole[1]:.4f}, next block column {col[0]:.4f} "
                  f"{col[1]:.4f} ms", flush=True)


def stamps(seed: int) -> None:
    from cholesky_is_magic_tpu_torch.ops import cuda_build

    text = (cuda_build.CSRC_DIR / "potrf.cu").read_text()
    for old, new in STAMPS:
        if text.count(old) != 1:
            raise RuntimeError(f"potrf.cu has changed: {old!r}")
        text = text.replace(old, new)
    out_dir = cuda_build.BUILD_DIR / "probe_schur"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "schur_stamps.cu"
    cu.write_text(text + STAMP_TAIL)
    so = cu.with_suffix(".so")
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-shared", str(cu),
                    "-o", str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.cim_potrf_schur_f32.argtypes = chol_cuda._SIGNATURES["cim_potrf_schur_f32"]
    lib.cim_potrf_schur_f32.restype = ctypes.c_int
    lib.cim_schur_stamps.argtypes = [ctypes.c_void_p]
    lib.cim_schur_stamps.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    got = (ctypes.c_longlong * 32)()
    for k, S, P in panel_steps(spd(1536, seed)):
        if k not in (0, 10):
            continue
        work, t = S.clone(), S.shape[0]
        for rep in range(3):
            cuda_build.raise_on(lib.cim_potrf_schur_f32(
                work.data_ptr(), work.stride(0), P.data_ptr(), P.stride(0), t, P.shape[1],
                t, chol_cuda.aligned16(P.data_ptr(), P.stride(0)), stream), "schur stamps")
            torch.cuda.synchronize()
            cuda_build.raise_on(lib.cim_schur_stamps(ctypes.addressof(got)), "stamps")
            for blk, what in ((0, "diagonal tile"), (1, "full tile")):
                v = [got[16 * blk + i] for i in range(16)]
                marks = sorted(STAMP_NAMES)
                print(f"[schur stamps] step {k} t {t} run {rep} block {blk} ({what}), cycles "
                      f"from the entry: " + ", ".join(f"{STAMP_NAMES[i]} {v[i] - v[0]}"
                                                      for i in marks), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    for flag in ("--steps", "--timeline", "--hashes", "--host-clock", "--variants", "--stamps",
                 "--priority"):
        ap.add_argument(flag, action="store_true")
    ap.add_argument("--n", type=int, nargs="+", default=[1536, 1441])
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    for n in args.n:
        if args.steps:
            steps(n, args.reps, args.seed)
        if args.timeline:
            timeline(n, args.seed)
        if args.hashes:
            hashes(n, args.seed)
        if args.host_clock:
            host_clock(n, args.seed)
        if args.priority:
            priority(n, args.seed)
    if args.variants:
        variants(args.reps, args.seed)
    if args.stamps:
        stamps(args.seed)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[schur probe] card, power limit: {smi.stdout.strip()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
