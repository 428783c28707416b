"""The double-word Aᵀ·x kernels by threads per block, columns per thread,
rows loaded ahead and slabs, a fingerprint of their output, and their bits
and times against another revision.

    python -m cholesky_is_magic_tpu_torch.tools.probe_rmv_kernel
        [--short | --stamps | --hashes | --against REV]

Without arguments: builds one copy of ``csrc/dd_matvec.cu`` per variant of
the long kernel (``dd_rmv_kernel``), with its constants (``kRmvThreads``,
``kRmvCols``, ``kRmvRows``, ``kRmvBatch``) rewritten in the copy, every
nvcc started together, and times ``cim_dd_rmv_f32`` of each at (1536, 5120)
and (4096, 8192): CUDA-event medians, the L2 cache flushed by a read before
each run and the card asleep until the host has queued the launch, in two
turns of opposite order.  Every variant must give the library's own result
bit for bit (the slab partition, and with it the order of the sums, is
``dd_cuda.rmv_slabs``' for all of them).  A few variants are also built from
a copy of the source whose last block skips the combine (``NO_COMBINE``):
their time is the kernel's up to the tickets, their result is not checked.
Beside them, ``torch.sum`` of A (one read of the same bytes) and the wrapper
behind a fresh ``torch.zeros`` of its tickets (what tickets allocated per
call would cost), timed the same way.

With ``--short``: the same for the short-lane kernel (``dd_rmv_short_kernel``,
lanes of at most ``kRmvShortSlabs`` slabs): a copy per setting of
``kRmvShortThreads``, ``kRmvShortCols`` and ``kRmvShortRows`` (``SHORT``),
timed on the batched launch at ``BATCH`` and the single one at afiro's
(128, 128), each bit-equal to the library; then the switch: copies with
``kRmvShortSlabs`` rewritten (0: every lane the long kernel) timed at
``SWITCH`` shapes of 2 to 32 slabs.

With ``--stamps``: the long kernel built from a copy of the source that
stamps ``%globaltimer`` at the kernel's entry, where a column block's last
block learns that it is the last, and at the end of its combine; prints the
spread of both over the column blocks.  Then the short kernel built with
``-DCIM_RMV_PROBE`` (``RMV_STAMP`` in the source): per block, its entry, the
arrival of its first chunk of rows, the end of its chain and of the
combine, at ``BATCH``'s short shapes and (128, 128).

With ``--hashes``: sha256 of hi and lo of ``ops.dd.dd_rmatvec`` on seeded
inputs at ragged and aligned shapes, on views that do not start on a
16-byte boundary, and of a second call, then its time at (1536, 5120) and
(4096, 8192), timed as above.  It uses nothing but that public function, so
the same file run against another tree of the package
(``PYTHONPATH=<tree> python <this file> --hashes``) shows whether two
kernels agree bit for bit, and times both in one call.

With ``--against REV``: also ``csrc/dd_matvec.cu`` as it was at git revision
REV (``git show``, kept as ``build/rmv_probe/dd_matvec_<REV>.cu``; a machine
without git, as the card's, finds it there, so run the option once where git
is), built beside the source as it is.  Both run ``BATCH``, afiro's
(128, 128), the pilot's (1536, 5120) and the ragged ``RAGGED`` shapes at
storage offsets 0 and 1, batched and lane by lane, and the library's
wrappers the same inputs: hi and lo must be equal bit for bit.  Then both
are timed at ``BATCH`` and the two single shapes in the order REV, this,
this, REV: each launch alone with the L2 flushed (beside a one-element fill
timed the same way, the method's floor), and back to back.

Prints the card's name and power limit.  Needs one CUDA card and nvcc;
imports no jax.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
from pathlib import Path

import numpy as np
import torch

from cholesky_is_magic_tpu_torch.ops import cuda_build, dd_cuda

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
    ("constexpr int kRmvRows = 8;\n", "constexpr int kRmvRows = {r};\n"),
    ("constexpr int kRmvBatch = 8;\n", "constexpr int kRmvBatch = {b};\n"),
]
OWN = (128, 2, 8, 8)  # the constants above
# The short-lane kernel's, (threads, columns, rows) and the switch.
SHORT_CONSTANTS = [
    ("constexpr int kRmvShortThreads = 128;\n", "constexpr int kRmvShortThreads = {t};\n"),
    ("constexpr int kRmvShortCols = 2;\n", "constexpr int kRmvShortCols = {c};\n"),
    ("constexpr int kRmvShortRows = 16;\n", "constexpr int kRmvShortRows = {r};\n"),
]
SHORT_OWN = (128, 2, 16)
SLABS = f"constexpr int kRmvShortSlabs = {dd_cuda.RMV_SHORT_SLABS};\n"
SHORT = [(t, c, r) for t in (128, 256) for c in (1, 2, 4) for r in (8, 16, 32)]
SWITCHES = (0, 8, 16, 32)  # 0: every lane on the long kernel
# (lanes, m, n): the finishers' and the smoke's batch shapes.
BATCH = [(1024, 64, 64), (256, 64, 128), (256, 64, 192), (8, 1536, 5120)]
# Around the switch: 2 to 32 slabs (rmv_slabs on 132 SMs), batched and single.
SWITCH = [(256, 64, 128), (256, 128, 128), (256, 256, 128), (256, 288, 128),
          (64, 512, 128), (64, 544, 128), (16, 1024, 128), (1, 256, 5120), (1, 512, 1024),
          (1, 4096, 8192)]
RAGGED = [(5, 37, 91), (3, 65, 33), (2, 256, 300), (4, 257, 128), (7, 100, 257),
          (1, 1, 1), (9, 7, 300), (3, 96, 70)]
READER = """
extern "C" int cim_probe_read(unsigned long long* host, long long count) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, cim_rmv_stamps, count * 8));
}
extern "C" int cim_probe_reset() {
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, cim_rmv_stamps);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaMemset(p, 0, sizeof(cim_rmv_stamps)));
}
"""
SRC = cuda_build.CSRC_DIR / "dd_matvec.cu"
OUT = cuda_build.BUILD_DIR.parent / "rmv_probe"
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


def back_to_back_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn`` over ``reps`` calls queued back to back
    between two CUDA events, the card asleep while the host queues them (no
    flush: what a loop that has just written A finds)."""
    fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES // 4 * reps)  # ~50 us a call
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def _source(edits, text=None) -> str:
    """csrc/dd_matvec.cu (or ``text``) with each (old, new) of ``edits``
    applied once."""
    text = SRC.read_text() if text is None else text
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"dd_matvec.cu has changed: {old!r}")
        text = text.replace(old, new)
    return text


def _registers(log: str, kernel: str) -> list[str]:
    """ptxas's register lines of the entry functions named ``kernel``."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif "registers" in line and name is not None and f"{len(kernel)}{kernel}" in name:
            out.append(line.strip().split("ptxas info    : ")[-1])
    return out


def build(sources: dict) -> dict:
    """name -> (source text, extra nvcc flags): one library each from its
    own copy under build/rmv_probe/, every nvcc started together; name ->
    (library, ptxas log)."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build.find_nvcc()
    procs = {}
    for name, (text, flags) in sources.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        cmd = [nvcc, *cuda_build.NVCC_FLAGS, *flags, "-shared", str(cu), "-o", str(so)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn in ("cim_dd_rmv_f32", "cim_dd_rmv_f32_batched"):
            getattr(lib, fn).argtypes = dd_cuda._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, log)
    return libs


class Launch:
    """Launches of a library's Aᵀ·x on fixed (B, m, n) A and (B, m) y, or
    (m, n) and (m,) for the single entry point, into outputs of its own, with
    the long kernel's partials and tickets whichever kernel runs."""

    def __init__(self, lib, A, y):
        self.lib, self.A, self.y = lib, A, y
        m, n = A.shape[-2:]
        lanes = A.shape[0] if A.dim() == 3 else 1
        sms = torch.cuda.get_device_properties(A.device).multi_processor_count
        self.slabs, self.rows = dd_cuda.rmv_slabs(m, n, sms)
        self.ldp = -(-n // 4) * 4
        self.part = torch.empty((2, lanes, self.slabs, self.ldp), device=A.device)
        self.tickets = torch.zeros(lanes * -(-n // dd_cuda.RMV_CTA_COLS), dtype=torch.int32,
                                   device=A.device)
        self.hi = torch.empty(*A.shape[:-2], n, device=A.device)
        self.lo = torch.empty_like(self.hi)

    def __call__(self):
        A, y = self.A, self.y
        m, n = A.shape[-2:]
        common = (A.data_ptr(), y.data_ptr(), self.hi.data_ptr(), self.lo.data_ptr(),
                  self.part[0].data_ptr(), self.part[1].data_ptr(), self.tickets.data_ptr(),
                  m, n, A.stride(-2), self.ldp, self.slabs, self.rows)
        stream = torch.cuda.current_stream().cuda_stream
        if A.dim() == 3:
            err = self.lib.cim_dd_rmv_f32_batched(*common, A.shape[0], A.stride(0),
                                                  y.stride(0), stream)
        else:
            err = self.lib.cim_dd_rmv_f32(*common, stream)
        cuda_build.raise_on(err, "dd_rmv probe launch")

    def result(self):
        self.hi.fill_(float("nan"))
        self()
        if bool(self.tickets.any()):
            raise AssertionError("a launch left a ticket that is not zero")
        return self.hi.clone(), self.lo.clone()


def _lanes(B, m, n, seed, offset=0):
    """Seeded (B, m, n) A whose storage starts ``offset`` floats in, and
    (B, m) y; B = 0 for one (m, n) A and (m,) y."""
    rng = np.random.default_rng(seed)
    size = max(B, 1) * m * n
    A = torch.from_numpy(rng.normal(size=size + offset).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.normal(size=(max(B, 1), m)).astype(np.float32)).cuda()
    A = A[offset:].view(max(B, 1), m, n)
    return (A, y) if B else (A[0], y[0])


def _bound_ms(B, m, n) -> float:
    """A read once, y read, hi and lo written, over 3.35 TB/s (the bytes
    bound the product: ~14 flops an element against 67 TFLOP/s)."""
    return (4 * B * m * n + 4 * B * m + 8 * B * n) / 3.35e12 * 1e3


def variants(reps: int) -> None:
    """The long kernel by threads, columns, rows and combine batch."""
    sources = {}
    for key in VARIANTS:
        t, c, r, ahead = key
        edits = [(old, new.format(t=t, c=c, r=r, b=max(ahead, 1))) for old, new in CONSTANTS]
        sources[f"rmv_t{t}_c{c}_r{r}_a{ahead}"] = (
            _source(edits + ([] if ahead else NO_COMBINE)), [])
    built = build(sources)
    libs = {key: built[f"rmv_t{key[0]}_c{key[1]}_r{key[2]}_a{key[3]}"] for key in VARIANTS}

    def name(key):
        return (f"threads {key[0]:3d} columns {key[1]} rows ahead {key[2]:2d}"
                + (f" partials per batch {key[3]:2d}" if key[3] else " up to the tickets"))

    for key, (_, log) in libs.items():
        print(f"[rmv probe] {name(key)}: {' | '.join(_registers(log, 'dd_rmv_kernel'))}")
    flush = torch.zeros(2 * L2_BYTES // 4, device="cuda")
    blocks_of = lambda n: -(-n // dd_cuda.RMV_CTA_COLS)  # noqa: E731
    for m, n in ((1536, 5120), (4096, 8192)):
        A, y = _inputs(m, n, 7)
        want = dd_cuda.dd_rmv(A, y)
        times = {key: [] for key in libs}
        for turn in (list(libs), list(libs)[::-1]):
            for key in turn:
                run = Launch(libs[key][0], A, y)
                got = run.result() if key[3] else None
                if key[3] and not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise AssertionError(f"variant {key} differs from the library's")
                times[key].append(median_ms(run, flush, reps))
                run.tickets.zero_()
        slabs, rows = run.slabs, run.rows
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


def _wrapper(A, y):
    """The library's own result through the public wrappers."""
    out = dd_cuda.dd_rmv_batched(A, y) if A.dim() == 3 else dd_cuda.dd_rmv(A, y)
    return out[0], out[1]


def short(reps: int) -> None:
    """The short-lane kernel by threads, columns and rows, then the switch."""
    def key_name(key):
        return "short_t{}_c{}_r{}".format(*key)

    sources = {key_name(key): (_source([(old, new.format(t=key[0], c=key[1], r=key[2]))
                                        for old, new in SHORT_CONSTANTS]), [])
               for key in SHORT}
    if SLABS not in SRC.read_text():
        raise RuntimeError("dd_matvec.cu: kRmvShortSlabs is not dd_cuda.RMV_SHORT_SLABS")
    for s in SWITCHES:
        sources[f"switch_{s}"] = (_source([(SLABS, f"constexpr int kRmvShortSlabs = {s};\n")]),
                                  [])
    libs = build(sources)
    for key in SHORT:
        regs = _registers(libs[key_name(key)][1], "dd_rmv_short_kernel")
        print(f"[rmv short] threads {key[0]} columns {key[1]} rows {key[2]:2d}: "
              + " | ".join(regs), flush=True)
    flush = torch.zeros(2 * L2_BYTES // 4, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [s for s in BATCH if dd_cuda.rmv_slabs(*s[1:], sms)[0] <= dd_cuda.RMV_SHORT_SLABS]
    for B, m, n in shapes + [(0, 128, 128)]:
        A, y = _lanes(B, m, n, B + m + n)
        want = _wrapper(A, y)
        times = {key: [] for key in SHORT}
        for turn in (SHORT, SHORT[::-1]):
            for key in turn:
                run = Launch(libs[key_name(key)][0], A, y)
                got = run.result()
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise AssertionError(f"short variant {key} differs from the library's")
                times[key].append(median_ms(run, flush, reps))
        shape = f"({B}, {m}, {n})" if B else f"({m}, {n}) single"
        print(f"[rmv short] {shape}: bound {_bound_ms(max(B, 1), m, n):.4f} ms (bytes);"
              f" every variant bit-equal to the library", flush=True)
        for key, t in sorted(times.items(), key=lambda kv: min(kv[1])):
            own = " (the source's)" if key == SHORT_OWN else ""
            print(f"[rmv short] {shape} threads {key[0]} columns {key[1]} rows {key[2]:2d}:"
                  f" {t[0]:.4f} {t[1]:.4f} ms{own}", flush=True)
    order = [f"switch_{s}" for s in SWITCHES]
    for B, m, n in SWITCH:
        A, y = _lanes(0 if B == 1 else B, m, n, m + n)
        want = _wrapper(A, y)
        times = {name: [] for name in order}
        for name in order + order[::-1]:
            run = Launch(libs[name][0], A, y)
            got = run.result()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"{name} differs from the library at ({B}, {m}, {n})")
            times[name].append(median_ms(run, flush, reps))
        slabs = dd_cuda.rmv_slabs(m, n, sms)[0]
        print(f"[rmv switch] ({B}, {m}, {n}), {slabs} slabs, bound {_bound_ms(B, m, n):.4f} ms: "
              + "; ".join(f"short up to {name.split('_')[1]} slabs "
                          + " ".join(f"{v:.4f}" for v in times[name]) for name in order),
              flush=True)


def stamps() -> None:
    """The long kernel with stamps: when each column block's last block
    arrived and when its combine ended, from the kernel's entry."""
    lib, _ = build({"long_stamps": (_source(STAMPS), [])})["long_stamps"]
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


STAMP_BLOCKS = 16384  # kRmvStampBlocks


def short_stamps(reps: int) -> None:
    """The short kernel's stamps: per block its entry, first chunk, chain
    end and combine end."""
    lib, _ = build({"short_stamps": (SRC.read_text() + READER, ["-DCIM_RMV_PROBE"])})[
        "short_stamps"]
    lib.cim_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.cim_probe_read.restype = ctypes.c_int
    lib.cim_probe_reset.argtypes = []
    lib.cim_probe_reset.restype = ctypes.c_int
    flush = torch.zeros(2 * L2_BYTES // 4, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [s for s in BATCH if dd_cuda.rmv_slabs(*s[1:], sms)[0] <= dd_cuda.RMV_SHORT_SLABS]
    for B, m, n in shapes + [(0, 128, 128)]:
        A, y = _lanes(B, m, n, 3)
        run = Launch(lib, A, y)
        ms = median_ms(run, flush, reps)
        for rep in range(3):
            cuda_build.raise_on(lib.cim_probe_reset(), "stamp reset")
            flush.sum()
            torch.cuda._sleep(SLEEP_CYCLES)
            run()
            torch.cuda.synchronize()
            host = np.zeros(4 * STAMP_BLOCKS, dtype=np.uint64)
            cuda_build.raise_on(lib.cim_probe_read(host.ctypes.data, host.size), "stamp read")
            s = host.reshape(STAMP_BLOCKS, 4).astype(np.int64)
            s = s[s[:, 0] != 0]
            blocks = len(s)
            t0 = s[:, 0].min()
            q = lambda v: f"{np.median(v) / 1e3:.2f} (max {v.max() / 1e3:.2f})"  # noqa: E731
            shape = f"({B}, {m}, {n})" if B else f"({m}, {n}) single"
            print(f"[rmv short stamps] {shape}, {blocks} blocks, run {rep}: us, median over"
                  f" blocks: entry after the first {q(s[:, 0] - t0)}; first chunk landed"
                  f" {q(s[:, 1] - s[:, 0])}; chain {q(s[:, 2] - s[:, 1])}; barrier +"
                  f" combine {q(s[:, 3] - s[:, 2])}; last end {(s[:, 3].max() - t0) / 1e3:.2f};"
                  f" stamped build by CUDA events {ms:.4f} ms", flush=True)


def against_source(rev: str) -> Path:
    """csrc/dd_matvec.cu at ``rev``, from build/rmv_probe/ or from git."""
    path = OUT / f"dd_matvec_{rev}.cu"
    if not path.exists():
        rel = SRC.relative_to(SRC.parents[2]).as_posix()
        proc = subprocess.run(["git", "show", f"{rev}:{rel}"], capture_output=True, text=True,
                              cwd=SRC.parents[2])
        if proc.returncode:
            raise RuntimeError(f"git show {rev}:{rel} failed and {path} is not there:"
                               f" {proc.stderr.strip()}")
        OUT.mkdir(parents=True, exist_ok=True)
        path.write_text(proc.stdout)
    return path


def against(rev: str, reps: int) -> None:
    """Bits and times of this source's kernels against ``rev``'s."""
    libs = build({"this": (SRC.read_text(), []),
                  f"rev_{rev}": (against_source(rev).read_text(), [])})
    this, old = libs["this"][0], libs[f"rev_{rev}"][0]
    for name, (_, log) in libs.items():
        print(f"[rmv against] {name}: "
              + " | ".join(_registers(log, "dd_rmv_kernel")
                           + _registers(log, "dd_rmv_short_kernel")))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    checked = 0
    for B, m, n in BATCH + RAGGED + [(0, 128, 128), (0, 1536, 5120), (0, 257, 300)]:
        for offset in (0, 1):
            A, y = _lanes(B, m, n, B + m + n, offset)
            pairs = [(Launch(this, A, y).result(), Launch(old, A, y).result(), "launch")]
            pairs.append((_wrapper(A, y), pairs[0][1], "wrapper"))
            if B:
                for k in range(min(B, 3)):
                    pairs.append((Launch(this, A[k], y[k]).result(),
                                  tuple(t[k] for t in pairs[0][1]), f"lane {k} single"))
            if m * n * max(B, 1) <= 1 << 23:
                order = dd_cuda.rmv_slab_plain(A, y, *dd_cuda.rmv_slabs(m, n, sms))
                pairs.append(((order.hi, order.lo), pairs[0][1], "rmv_slab_plain"))
            for got, want, what in pairs:
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise AssertionError(f"({B}, {m}, {n}) offset {offset}: {what} differs"
                                         f" from {rev}'s kernel")
                checked += 1
    print(f"[rmv against] {checked} comparisons at {len(BATCH) + len(RAGGED) + 3} shapes,"
          f" offsets 0 and 1: hi and lo bit-equal to {rev}'s kernel", flush=True)
    flush = torch.zeros(2 * L2_BYTES // 4, device="cuda")
    one = torch.empty(1, device="cuda")
    floor = [median_ms(lambda: one.fill_(0.0), flush, reps) for _ in range(2)]
    print(f"[rmv against] timing floor, a one-element fill timed the same way: {floor[0]:.4f}"
          f" {floor[1]:.4f} ms", flush=True)
    for B, m, n in BATCH + [(0, 128, 128), (0, 1536, 5120)]:
        A, y = _lanes(B, m, n, 7)
        runs = {"rev": Launch(old, A, y), "this": Launch(this, A, y)}
        t = {k: [] for k in runs}
        warm = {k: [] for k in runs}
        for k in ("rev", "this", "this", "rev"):
            t[k].append(median_ms(runs[k], flush, reps))
            warm[k].append(back_to_back_ms(runs[k], 10 * reps))
        lanes = max(B, 1)
        kind = "short" if runs["this"].slabs <= dd_cuda.RMV_SHORT_SLABS else "long"
        shape = f"({B}, {m}, {n})" if B else f"({m}, {n}) single"
        print(f"[rmv against] {shape}, {runs['this'].slabs} slabs ({kind} kernel), median ms:"
              f" {rev} {t['rev'][0]:.4f} {t['rev'][1]:.4f}, this {t['this'][0]:.4f}"
              f" {t['this'][1]:.4f}; back to back, A in L2 when it fits: {rev}"
              f" {warm['rev'][0]:.4f} {warm['rev'][1]:.4f}, this {warm['this'][0]:.4f}"
              f" {warm['this'][1]:.4f}; bound {_bound_ms(lanes, m, n):.4f} (bytes)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hashes", action="store_true")
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--short", action="store_true")
    ap.add_argument("--against", metavar="REV")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if args.against:
        against_source(args.against)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if args.hashes:
        hashes()
    elif args.stamps:
        stamps()
        short_stamps(args.reps)
    elif args.short:
        short(args.reps)
    elif args.against:
        against(args.against, args.reps)
    else:
        variants(args.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[rmv probe] card, power limit: {smi.stdout.strip()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
