"""The double-word Aᵀ·x kernel by threads per block, columns per thread and
rows loaded ahead, and a fingerprint of its output.

    python -m cholesky_is_magic_tpu_torch.tools.probe_rmv_kernel [--hashes]

Without arguments: builds one copy of ``csrc/dd_matvec.cu`` per variant,
with the kernel's constants (``kRmvThreads``, ``kRmvCols`` and ``rmv_vec``,
``kRmvRows``, ``kRmvBatch``) rewritten in the copy, every nvcc started
together, and times ``cim_dd_rmv_f32`` of each at (1536, 5120) and
(4096, 8192): CUDA-event medians, the L2 cache flushed by a read before each
run and the card asleep until the host has queued the launch, in two turns
of opposite order.  Every variant must give the library's own result bit for
bit (the slab partition, and with it the order of the sums, is
``dd_cuda.rmv_slabs``' for all of them).  A few variants are also built from
a copy of the source whose last block skips the combine (``NO_COMBINE``):
their time is the kernel's up to the tickets, their result is not checked.
Beside them, ``torch.sum`` of A (one read of the same bytes) and the wrapper
behind a fresh ``torch.zeros`` of its tickets (what tickets allocated per
call would cost), timed the same way.  Prints each variant's times, the library's own variant, and the card's
name and power limit.

With ``--stamps``: the library's own variant built from a copy of the source
that stamps ``%globaltimer`` at the kernel's entry, where a column block's
last block learns that it is the last, and at the end of its combine; prints
the spread of both over the column blocks.

With ``--hashes``: sha256 of hi and lo of ``ops.dd.dd_rmatvec`` on seeded
inputs at ragged and aligned shapes, on views that do not start on a
16-byte boundary, and of a second call, then its time at (1536, 5120) and
(4096, 8192), timed as above.  It uses nothing but that public function, so
the same file run against another tree of the package
(``PYTHONPATH=<tree> python <this file> --hashes``) shows whether two
kernels agree bit for bit, and times both in one call.

Needs one CUDA card and nvcc; imports no jax.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess

import numpy as np
import torch

SHAPES = [(1, 1), (7, 300), (300, 7), (129, 257), (1441, 5093), (1536, 5120),
          (4096, 8192)]
# (threads, columns per thread, rows ahead, partials per batch of the combine;
# 0: without the combine)
VARIANTS = [(t, c, r, 8) for t in (64, 128, 256) for c in (1, 2, 4) for r in (4, 8, 16)
            if t * c <= 256]
VARIANTS += [(128, 2, 8, b) for b in (0, 4, 16, 32)] + [(128, 2, r, 8) for r in (6, 12)]
VARIANTS += [(t, c, 8, 0) for t, c in ((64, 4), (128, 1), (256, 1))]
# No block combines, and none minds the tickets the others left.
NO_COMBINE = [("    if (!last) return;\n", "    return;\n"),
              ("      if (before >= slabs) __trap();\n", "")]
# The kernel's constants as the source states them, each with the pattern a
# variant's copy gets: (threads, columns, rows, batch) -> text.
CONSTANTS = [
    ("constexpr int kRmvThreads = 128;\n", "constexpr int kRmvThreads = {t};\n"),
    ("constexpr int kRmvCols = 2;\n", "constexpr int kRmvCols = {c};\n"),
    ("using rmv_vec = float2;", "using rmv_vec = {vec};"),
    ("constexpr int kRmvRows = 8;\n", "constexpr int kRmvRows = {r};\n"),
    ("constexpr int kRmvBatch = 8;\n", "constexpr int kRmvBatch = {b};\n"),
]
OWN = (128, 2, 8, 8)  # the constants above
# Stamps of %globaltimer (ns) in the scratch past the partials: the kernel's
# entry, and per column block the last block's arrival and its combine's end.
STAMPS = [
    ("  __shared__ int last;\n",
     "  __shared__ int last;\n"
     "  unsigned long long* stamps = reinterpret_cast<unsigned long long*>(\n"
     "      part_lo + static_cast<long long>(gridDim.y) * ldp);\n"
     "  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(stamps[0]));\n  }\n"),
    ("    if (!last) return;\n",
     "    if (!last) return;\n"
     "    if (threadIdx.x == 0) {\n"
     "      asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(stamps[1 + 2 * blockIdx.x]));\n    }\n"),
    ("  if (left <= 0) return;\n#pragma unroll\n  for (int j = 0; j < kRmvCols; ++j) {\n    if (j < left) {\n",
     "  if (left <= 0) return;\n"
     "  if (threadIdx.x == 0 && slabs > 1 && acc[0].hi == acc[0].hi) {\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(stamps[2 + 2 * blockIdx.x]));\n  }\n"
     "#pragma unroll\n  for (int j = 0; j < kRmvCols; ++j) {\n    if (j < left) {\n"),
]
L2_BYTES = 50 * 2**20
SLEEP_CYCLES = 400_000  # ~0.2 ms at ~2 GHz


def _inputs(m, n, seed, offset=0):
    """Seeded f32 A (m, n) and y (m,) on the card, as views ``offset``
    elements into their storage."""
    rng = np.random.default_rng(seed)
    A = torch.from_numpy(rng.normal(size=m * n + offset).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.normal(size=m + offset).astype(np.float32)).cuda()
    return A[offset:].view(m, n), y[offset:]


def hashes() -> None:
    from cholesky_is_magic_tpu_torch.ops import dd as ddm

    def digest(d):
        h = hashlib.sha256(d.hi.cpu().numpy().tobytes())
        h.update(d.lo.cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    for m, n in SHAPES:
        for offset in (0, 1):
            A, y = _inputs(m, n, m + n, offset)
            first, second = digest(ddm.dd_rmatvec(A, y)), digest(ddm.dd_rmatvec(A, y))
            print(f"[rmv hash] ({m}, {n}) storage offset {offset}: {first}"
                  f" second call {'same' if second == first else second}", flush=True)
    flush = torch.zeros(2 * L2_BYTES // 4, device="cuda")
    for m, n in ((1536, 5120), (4096, 8192)):
        A, y = _inputs(m, n, 7)
        t = [median_ms(lambda: ddm.dd_rmatvec(A, y), flush) for _ in range(3)]
        print(f"[rmv hash] ({m}, {n}) dd_rmatvec median ms: "
              + " ".join(f"{v:.4f}" for v in t), flush=True)


def median_ms(fn, flush, reps=20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.sum()
        torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _source(edits) -> str:
    """csrc/dd_matvec.cu with each (old, new) of ``edits`` applied once."""
    from cholesky_is_magic_tpu_torch.ops import cuda_build

    text = (cuda_build.CSRC_DIR / "dd_matvec.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"dd_matvec.cu has changed: {old!r}")
        text = text.replace(old, new)
    return text


def build_variants():
    """One library per variant, each from its own copy of csrc/dd_matvec.cu."""
    from cholesky_is_magic_tpu_torch.ops import cuda_build, dd_cuda

    out_dir = cuda_build.BUILD_DIR / "probe_rmv"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build.find_nvcc()
    procs = {}
    for key in VARIANTS:
        t, c, r, ahead = key
        fill = dict(t=t, c=c, r=r, b=max(ahead, 1),
                    vec={1: "float", 2: "float2", 4: "float4"}[c])
        edits = [(old, new.format(**fill)) for old, new in CONSTANTS]
        cu = out_dir / f"rmv_t{t}_c{c}_r{r}_a{ahead}.cu"
        cu.write_text(_source(edits + ([] if ahead else NO_COMBINE)))
        so = cu.with_suffix(".so")
        cmd = [nvcc, *cuda_build.NVCC_FLAGS, "-shared", str(cu), "-o", str(so)]
        procs[key] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{text}")
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        lib = ctypes.CDLL(str(so))
        lib.cim_dd_rmv_f32.argtypes = dd_cuda._SIGNATURES["cim_dd_rmv_f32"]
        lib.cim_dd_rmv_f32.restype = ctypes.c_int
        libs[key] = (lib, regs[-2:])
    return libs


def stamps() -> None:
    """The library's own variant with stamps: when each column block's last
    block arrived and when its combine ended, from the kernel's entry."""
    from cholesky_is_magic_tpu_torch.ops import cuda_build, dd_cuda

    out_dir = cuda_build.BUILD_DIR / "probe_rmv"
    out_dir.mkdir(parents=True, exist_ok=True)
    cut = out_dir / "dd_matvec_stamps.cu"
    cut.write_text(_source(STAMPS))
    so = out_dir / "rmv_stamps.so"
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-shared", str(cut),
                    "-o", str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.cim_dd_rmv_f32.argtypes = dd_cuda._SIGNATURES["cim_dd_rmv_f32"]
    lib.cim_dd_rmv_f32.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.zeros(2 * L2_BYTES // 4, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for m, n in ((1536, 5120), (4096, 8192)):
        A, y = _inputs(m, n, 7)
        slabs, rows = dd_cuda.rmv_slabs(m, n, sms)
        blocks = -(-n // dd_cuda.RMV_CTA_COLS)
        ldp = -(-n // 4) * 4
        hi, lo = torch.empty(n, device="cuda"), torch.empty(n, device="cuda")
        part = torch.zeros(2 * slabs * ldp + 4 * (1 + 2 * blocks), device="cuda")
        tickets = torch.zeros(blocks, dtype=torch.int32, device="cuda")
        for rep in range(3):
            flush.sum()
            torch.cuda._sleep(SLEEP_CYCLES)
            cuda_build.raise_on(lib.cim_dd_rmv_f32(
                A.data_ptr(), y.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                part.data_ptr(), part[slabs * ldp:].data_ptr(), tickets.data_ptr(),
                m, n, A.stride(0), ldp, slabs, rows, stream), "dd_rmv with stamps")
            torch.cuda.synchronize()
            t = part[2 * slabs * ldp:].view(torch.int64).cpu().numpy()[:1 + 2 * blocks]
            arrive = np.sort(t[1::2] - t[0]) / 1e3
            combine = (t[2::2] - t[1::2]) / 1e3
            print(f"[rmv stamps] ({m}, {n}) run {rep}: last block of a column block "
                  f"arrives {arrive[0]:.1f} .. {arrive[-1]:.1f} us after the entry "
                  f"(median {np.median(arrive):.1f}); its combine takes "
                  f"{combine.min():.1f} .. {combine.max():.1f} us (median "
                  f"{np.median(combine):.1f}); last end {(t[2::2] - t[0]).max() / 1e3:.1f}",
                  flush=True)


def variants(reps: int) -> None:
    from cholesky_is_magic_tpu_torch.ops import cuda_build, dd_cuda

    libs = build_variants()
    def name(key):
        return (f"threads {key[0]:3d} columns {key[1]} rows ahead {key[2]:2d}"
                + (f" partials per batch {key[3]:2d}" if key[3] else " up to the tickets"))

    for key, (_, regs) in libs.items():
        print(f"[rmv probe] {name(key)}: {' | '.join(regs)}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.zeros(2 * L2_BYTES // 4, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    blocks_of = lambda n: -(-n // dd_cuda.RMV_CTA_COLS)  # noqa: E731
    for m, n in ((1536, 5120), (4096, 8192)):
        A, y = _inputs(m, n, 7)
        slabs, rows = dd_cuda.rmv_slabs(m, n, sms)
        want = dd_cuda.dd_rmv(A, y)
        ldp = -(-n // 4) * 4
        hi, lo = torch.empty(n, device="cuda"), torch.empty(n, device="cuda")
        part = torch.empty((2, slabs, ldp), device="cuda")
        tickets = torch.zeros(n, dtype=torch.int32, device="cuda")

        def launch(lib):
            cuda_build.raise_on(lib.cim_dd_rmv_f32(
                A.data_ptr(), y.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                part[0].data_ptr(), part[1].data_ptr(), tickets.data_ptr(), m, n,
                A.stride(0), ldp, slabs, rows, stream), "dd_rmv variant")

        times = {key: [] for key in libs}
        for turn in (list(libs), list(libs)[::-1]):
            for key in turn:
                lib = libs[key][0]
                hi.fill_(float("nan"))
                launch(lib)
                if key[3] and not (torch.equal(hi, want[0]) and torch.equal(lo, want[1])
                                   and not bool(tickets.any())):
                    raise AssertionError(f"variant {key} differs from the library's")
                times[key].append(median_ms(lambda: launch(lib), flush, reps))
                tickets.zero_()
        lib_ms = [median_ms(lambda: dd_cuda.dd_rmv(A, y), flush, reps) for _ in range(2)]
        fresh = [median_ms(lambda: (torch.zeros(blocks_of(n), dtype=torch.int32,
                                                device="cuda"), dd_cuda.dd_rmv(A, y)),
                           flush, reps) for _ in range(2)]
        read = [median_ms(lambda: torch.sum(A), flush, reps) for _ in range(2)]
        print(f"[rmv probe] ({m}, {n}): {slabs} slabs of {rows} rows; the wrapper "
              f"(with its allocations, threads, columns, rows, batch = {OWN}) "
              f"{lib_ms[0]:.4f} {lib_ms[1]:.4f} ms; behind a torch.zeros of "
              f"{blocks_of(n)} tickets {fresh[0]:.4f} {fresh[1]:.4f} ms; torch.sum(A) "
              f"{read[0]:.4f} {read[1]:.4f} ms")
        for key, t in sorted(times.items(), key=lambda kv: min(kv[1])):
            print(f"[rmv probe] ({m}, {n}) {name(key)}: {t[0]:.4f} {t[1]:.4f} ms",
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hashes", action="store_true")
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if args.hashes:
        hashes()
    elif args.stamps:
        stamps()
    else:
        variants(args.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[rmv probe] card, power limit: {smi.stdout.strip()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
