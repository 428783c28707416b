"""The double-word A·x kernels by row length: where the short-row kernel
stops paying.

    python -m cholesky_is_magic_tpu_torch.tools.probe_mv_kernel

Builds two copies of ``csrc/dd_matvec.cu`` into ``build/mv_probe/``, one
with ``kMvShortMax`` rewritten to 0 (every row a block, ``dd_mv_kernel``)
and one to 2^30 (every row a warp, ``dd_mv_short_kernel``), and times both
on the batched launch at (256, 64, n) and the single launch at (1536, n) for
row lengths n from 64 to 2048, and at the batched pdas shape (1024, 64, 64):
CUDA-event medians, the L2 cache flushed by a read before each run and the
card asleep until the host has queued the launch, in the order block, warp,
warp, block.  Both must equal ``dd_cuda.mv_order_plain`` bit for bit at
every shape.  Prints the times, the bound (A read once, x read, hi and lo
written, over 3.35 TB/s), the row lengths where the warp kernel is faster,
and the card's name and power limit.

Needs one CUDA card and nvcc; imports no jax.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import numpy as np
import torch

from cholesky_is_magic_tpu_torch.ops import cuda_build, dd_cuda

SRC = cuda_build.CSRC_DIR / "dd_matvec.cu"
OUT = cuda_build.BUILD_DIR.parent / "mv_probe"
LIMIT = f"constexpr int kMvShortMax = {dd_cuda.MV_SHORT_MAX};\n"
VARIANTS = {"block": 0, "warp": 1 << 30}
LENGTHS = (64, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048)
SLEEP_CYCLES_PER_MS = 2_000_000
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def build() -> dict[str, ctypes.CDLL]:
    text = SRC.read_text()
    if text.count(LIMIT) != 1:
        raise RuntimeError("dd_matvec.cu: kMvShortMax is not dd_cuda.MV_SHORT_MAX")
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build.find_nvcc()
    procs = {}
    for name, limit in VARIANTS.items():
        src = OUT / f"dd_matvec_{name}.cu"
        src.write_text(text.replace(LIMIT, f"constexpr int kMvShortMax = {limit};\n"))
        procs[name] = subprocess.Popen(
            [nvcc, *cuda_build.NVCC_FLAGS, "-shared", "-o", str(OUT / f"lib{name}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        dll = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        dll.cim_dd_mv_f32_batched.argtypes = [_P, _P, _P, _P, _I, _I, _LL, _I, _LL, _LL, _P]
        dll.cim_dd_mv_f32_batched.restype = _I
        libs[name] = dll
    return libs


def launch(dll, A: torch.Tensor, x: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor):
    B, m, n = A.shape
    err = dll.cim_dd_mv_f32_batched(A.data_ptr(), x.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                                    m, n, n, B, m * n, n,
                                    torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with error {err}")


def median_ms(fn, flush, reps: int = 20, lead: float = 0.2) -> float:
    fn()
    times = []
    for _ in range(reps):
        flush.sum()
        torch.cuda._sleep(int(SLEEP_CYCLES_PER_MS * lead))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    return float(np.median(times))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    libs = build()
    flush = torch.zeros(25 * 2**20, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(1024, 64, 64)] + [(256, 64, n) for n in LENGTHS] + [(1, 1536, n)
                                                                    for n in LENGTHS]
    faster = []
    for B, m, n in shapes:
        A = torch.randn(B, m, n, generator=g, device="cuda")
        x = torch.randn(B, n, generator=g, device="cuda")
        want = dd_cuda.mv_order_plain(A, x)
        out = {k: (torch.empty(B, m, device="cuda"), torch.empty(B, m, device="cuda"))
               for k in libs}
        for k, (hi, lo) in out.items():
            launch(libs[k], A, x, hi, lo)
        torch.cuda.synchronize()
        same = all(torch.equal(hi, want.hi) and torch.equal(lo, want.lo)
                   for hi, lo in out.values())
        t = {k: [] for k in libs}
        for k in ("block", "warp", "warp", "block"):
            t[k].append(median_ms(lambda: launch(libs[k], A, x, *out[k]), flush, args.reps))
        bound = (4 * (B * m * n + B * n) + 8 * B * m) / 3.35e12 * 1e3
        best = {k: min(v) for k, v in t.items()}
        if best["warp"] < best["block"]:
            faster.append((B, m, n))
        print(f"[mv probe] ({B}, {m}, {n}): block {t['block'][0]:.4f} {t['block'][1]:.4f}"
              f"  warp {t['warp'][0]:.4f} {t['warp'][1]:.4f} ms; bound {bound:.4f} ms;"
              f" both bit-equal to mv_order_plain {same}", flush=True)
        if not same:
            raise AssertionError(f"a dd A·x kernel leaves its order at ({B}, {m}, {n})")
        del A, x, out, want
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[mv probe] the warp kernel is faster at {faster}; kMvShortMax is"
          f" {dd_cuda.MV_SHORT_MAX}; card, power limit: {smi.stdout.strip()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
