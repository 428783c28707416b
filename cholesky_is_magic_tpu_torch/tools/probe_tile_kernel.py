"""Where the tile kernel's cycles go, on the card, and its bits against
another revision.

    python -m cholesky_is_magic_tpu_torch.tools.probe_tile_kernel [--b 128]
        [--against REV]

Builds copies of ``csrc/potrf.cu`` with nvcc (the library's flags, every
nvcc started together) into ``build/tile_probe/``, with
``-DCIM_TILE_PROBE``: the first CTA of ``potrf_tile_kernel`` then stamps
``clock64()`` at its entry, when the first diagonal block's copies are
issued and its zeros written, when those rows have landed, when the other
warps have staged the rest (beside the first factor), and per 32-column
sub-panel p at the end of: D (the pivot warp's factor of the diagonal
block), X (the inverse warp, a column step behind it), U (the product
warps' part of the previous update), S (the store warps' store of the
previous block), B (the barrier after all of them), and in C: Crows (the
four diagonal warps' rows of the sub-panel below, those of the next
diagonal block), Cdiag (their update of that block), Crest (the other
warps' products) and C (the barrier); then the last block's store.  One copy per setting
of ``kQuietSmsps`` (which SM sub-partitions the product warps leave to the
pivot and inverse warps) and ``kStoreSmsp`` (whose warps store), each held
against ``torch.linalg.cholesky``; the same copies built without stamps (a
stamp's atomic costs cycles) are timed by CUDA events over back-to-back
launches behind a sleep, the single launch on fresh copies of a (b, b) tile
and the batched one on (8, b, b), in turns.

With ``--against REV``: also ``csrc/potrf.cu`` as it was at git revision
REV (``git show``, kept as ``build/tile_probe/potrf_<REV>.cu``; a machine
without git, as the card's, finds it there, so run the option once where
git is), built without stamps beside the source as it is.  Both factor the
same tiles: 256 random SPD tiles (half of them with rows and columns scaled
by 10^U(-2, 2)) and 16 non-PD ones (a negative pivot at a random place) at
each b in 16, 33, 100 and 128, in one batched launch per b and by single
launches in place on 16 of them; L and the inverse must be equal bit for
bit.  Then both times, in the order REV, this, this, REV.

Prints the card's name, power limit and SM clock.  Needs one CUDA card and
nvcc; imports no jax.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

from cholesky_is_magic_tpu_torch.ops import cuda_build

SRC = cuda_build.CSRC_DIR / "potrf.cu"
OUT = cuda_build.BUILD_DIR.parent / "tile_probe"
QUIET = "constexpr int kQuietSmsps = {};\n"
STORE = "constexpr int kStoreSmsp = {};\n"
OWN = (2, 0)  # the source's (kQuietSmsps, kStoreSmsp)
VARIANTS = (OWN, (2, 1), (1, 0))
READER = """
extern "C" int cim_probe_read(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, cim_tile_stamps, sizeof(cim_tile_stamps)));
}
extern "C" int cim_probe_reset() {
  static const unsigned long long zero[64] = {};
  return static_cast<int>(cudaMemcpyToSymbol(cim_tile_stamps, zero, sizeof(zero)));
}
"""
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
SIGNATURES = {
    "cim_potrf_tile_f32": [_P, _LL, _P, _LL, _I, _P],
    "cim_potrf_tile_f32_batched": [_P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL, _I, _I, _P],
}


def variant_name(variant) -> str:
    return "quiet{}_store{}".format(*variant)


def against_source(rev: str) -> Path:
    """csrc/potrf.cu at ``rev``, from build/tile_probe/ or from git."""
    path = OUT / f"potrf_{rev}.cu"
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


def build_all(sources: dict[str, tuple[str, bool]]) -> dict[str, ctypes.CDLL]:
    """name -> (source text, stamped): one library each, nvcc in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build.find_nvcc()
    procs = {}
    for name, (text, stamped) in sources.items():
        src = OUT / f"{name}.cu"
        src.write_text(text + (READER if stamped else ""))
        cmd = [nvcc, *cuda_build.NVCC_FLAGS, *(["-DCIM_TILE_PROBE"] if stamped else []),
               "-shared", "-o", str(OUT / f"lib{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        regs = [line.strip() for line in out.splitlines()
                if "potrf_tile" in line or ("registers" in line and "Used" in line)]
        print(f"[probe] built {name}: " + " | ".join(regs[:4]), flush=True)
        dll = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        for fn, argtypes in SIGNATURES.items():
            getattr(dll, fn).argtypes = argtypes
            getattr(dll, fn).restype = _I
        if sources[name][1]:
            dll.cim_probe_read.argtypes = [_P]
            dll.cim_probe_read.restype = _I
            dll.cim_probe_reset.argtypes = []
            dll.cim_probe_reset.restype = _I
        libs[name] = dll
    return libs


def batched(dll, N: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, L⁻¹) of the (B, b, b) tiles N in one launch of ``dll``."""
    B, b, _ = N.shape
    L, inv = torch.empty_like(N), torch.empty_like(N)
    err = dll.cim_potrf_tile_f32_batched(N.data_ptr(), b, b * b, L.data_ptr(), b, b * b,
                                         inv.data_ptr(), b, b * b, b, B,
                                         torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"batched launch failed with error {err}")
    return L, inv


def single_(dll, T: torch.Tensor, inv: torch.Tensor) -> None:
    b = T.shape[0]
    err = dll.cim_potrf_tile_f32(T.data_ptr(), T.stride(0), inv.data_ptr(), inv.stride(0), b,
                                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with error {err}")


def spd(B: int, b: int, seed: int, scaled: bool = False) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    M = torch.randn(B, b, b, generator=g, device="cuda", dtype=torch.float64)
    N = M @ M.mT / b + torch.eye(b, device="cuda", dtype=torch.float64)
    if scaled:
        s = 10.0 ** (4 * torch.rand(B, b, 1, generator=g, device="cuda",
                                    dtype=torch.float64) - 2)
        N = s * N * s.mT
    return N.float()


def back_to_back_ms(launch, reps: int, sleep_ms: float = 0.1) -> float:
    """Device ms per call of ``launch(r)``, r = 0 .. reps - 1, queued back
    to back between two CUDA events behind a sleep (as chip_smoke.py)."""
    launch(reps)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2_000_000 * sleep_ms * reps))
    ev[0].record()
    for r in range(reps):
        launch(r)
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def timings(libs: dict, order: list[str], b: int, reps: int) -> None:
    """Each library's single launch on a fresh copy of the tile and its
    (8, b, b) batched launch, each alone over back-to-back launches behind a
    sleep, in the given order; builds without stamps."""
    N1 = spd(1, b, 1)[0]
    N8 = spd(8, b, 2)
    T = N1.expand(reps + 1, b, b).clone()
    inv = torch.empty_like(T)
    L8, I8 = torch.empty_like(N8), torch.empty_like(N8)
    stream = torch.cuda.current_stream().cuda_stream
    for tag in order:
        dll = libs[tag]
        T.copy_(N1.expand(reps + 1, b, b))
        one = back_to_back_ms(lambda r: single_(dll, T[r], inv[r]), reps)

        def eight(r):
            err = dll.cim_potrf_tile_f32_batched(N8.data_ptr(), b, b * b, L8.data_ptr(), b,
                                                 b * b, I8.data_ptr(), b, b * b, b, 8, stream)
            if err:
                raise RuntimeError(f"batched launch failed with error {err}")

        print(f"[probe] {tag}: ms a launch, back to back: single ({b}, {b}) {one:.4f},"
              f" batched (8, {b}, {b}) {back_to_back_ms(eight, reps):.4f}", flush=True)


def stamps(libs: dict, b: int, reps: int) -> None:
    N = spd(1, b, 1)[0]
    ref = torch.linalg.cholesky(N.double())
    host = np.zeros(64, dtype=np.uint64)
    panels = -(-b // 32)
    for tag in [variant_name(v) for v in VARIANTS]:
        dll = libs[tag]
        runs = []
        for _ in range(reps):
            T, inv = N.clone(), torch.empty_like(N)
            if dll.cim_probe_reset():
                raise RuntimeError("resetting the stamps failed")
            single_(dll, T, inv)
            torch.cuda.synchronize()
            if dll.cim_probe_read(host.ctypes.data):
                raise RuntimeError("reading the stamps failed")
            rel = ((T.double() - ref).abs().max() / ref.abs().max()).item()
            if not rel <= 64 * np.finfo(np.float32).eps:
                raise AssertionError(f"{tag} disagrees with cholesky: {rel}")
            s = host.astype(np.int64)
            row = {"copies issued": s[2] - s[0], "zeros written": s[3] - s[0],
                   "first block landed": s[1] - s[0], "rest landed": s[4] - s[0]}
            prev = s[1]
            for p in range(panels):
                base = 8 + 10 * p
                for k, ph in enumerate(("D", "X", "U", "S")):
                    if s[base + k]:
                        row[f"{ph}{p}"] = s[base + k] - prev
                row[f"B{p}"] = s[base + 4] - prev
                for k, ph in ((5, "Crows"), (6, "Cdiag"), (7, "Crest"), (8, "C")):
                    if s[base + k]:
                        row[f"{ph}{p}"] = s[base + k] - s[base + 4]
                prev = s[base + 8]
            row["store"] = s[5] - prev
            row["total"] = s[5] - s[0]
            runs.append(row)
        med = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
        print(f"[probe] {tag} stamps, b={b}, median cycles of {reps} launches: "
              + ", ".join(f"{k} {v:.0f}" for k, v in med.items()), flush=True)


def compare(new, old, rev: str) -> None:
    """L and the inverse of both builds, bit for bit, on SPD and non-PD
    tiles, batched and single in place."""
    total = same = 0
    for b in (16, 33, 100, 128):
        N = torch.cat([spd(128, b, 10 + b), spd(128, b, 20 + b, scaled=True)])
        bad = spd(16, b, 30 + b)
        g = torch.Generator().manual_seed(b)
        piv = torch.randint(0, b, (16,), generator=g)
        bad[torch.arange(16), piv, piv] = -1.0
        T = torch.cat([N, bad])
        (L1, I1), (L0, I0) = batched(new, T), batched(old, T)
        torch.cuda.synchronize()
        eq = (L1.view(torch.int32) == L0.view(torch.int32)).flatten(1).all(1) \
            & (I1.view(torch.int32) == I0.view(torch.int32)).flatten(1).all(1)
        nan_ok = bool(torch.isnan(L1[-16:]).all() and torch.isnan(I1[-16:]).all()
                      and torch.isfinite(L1[:-16]).all())
        ones = 0
        for k in list(range(8)) + list(range(T.shape[0] - 8, T.shape[0])):
            Ta, Ia, Tb, Ib = T[k].clone(), torch.empty_like(T[k]), T[k].clone(), \
                torch.empty_like(T[k])
            single_(new, Ta, Ia)
            single_(old, Tb, Ib)
            ones += int(torch.equal(Ta.view(torch.int32), Tb.view(torch.int32))
                        and torch.equal(Ia.view(torch.int32), Ib.view(torch.int32))
                        and torch.equal(Ta.view(torch.int32), L1[k].view(torch.int32)))
        total += T.shape[0]
        same += int(eq.sum())
        print(f"[probe] b={b}: {T.shape[0]} tiles (256 SPD, 16 non-PD), batched L and inverse"
              f" bit-equal to {rev}'s: {int(eq.sum())}/{T.shape[0]}; non-PD all NaN, SPD"
              f" finite: {nan_ok}; single launches in place bit-equal: {ones}/16", flush=True)
        if not (bool(eq.all()) and nan_ok and ones == 16):
            raise AssertionError(f"the tile kernel differs from {rev}'s at b={b}")
    print(f"[probe] against {rev}: {same}/{total} tiles bit-equal", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=128)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--against", metavar="REV")
    args = ap.parse_args()
    old_src = against_source(args.against) if args.against else None
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card" + (f" ({old_src} is ready for it)"
                                                if old_src else ""))
    text = SRC.read_text()
    if text.count(QUIET.format(OWN[0])) != 1 or text.count(STORE.format(OWN[1])) != 1:
        raise RuntimeError("potrf.cu: kQuietSmsps or kStoreSmsp changed; update the probe's OWN")
    sources = {}
    for v in VARIANTS:
        copy = (text.replace(QUIET.format(OWN[0]), QUIET.format(v[0]))
                .replace(STORE.format(OWN[1]), STORE.format(v[1])))
        sources[variant_name(v)] = (copy, True)
        sources[variant_name(v) + "_timed"] = (copy, False)
    if old_src:
        sources["this"] = (text, False)
        sources[args.against] = (old_src.read_text(), False)
    libs = build_all(sources)
    stamps(libs, args.b, args.reps)
    order = [variant_name(v) + "_timed" for v in VARIANTS]
    timings(libs, order + order[::-1], args.b, args.reps)
    if old_src:
        compare(libs["this"], libs[args.against], args.against)
        timings(libs, [args.against, "this", "this", args.against], args.b, args.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[probe] card, power limit, SM clock: {smi.stdout.strip()}  (the source's"
          f" kQuietSmsps, kStoreSmsp: {OWN})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
