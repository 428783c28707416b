"""Where the tile kernel's cycles go, on the card.

    python -m cholesky_is_magic_tpu_torch.tools.probe_tile_kernel [--b 128]

Builds instrumented copies of ``csrc/potrf.cu`` with nvcc (the library's
flags) into ``build/tile_probe/``: thread 0 of ``potrf_tile_kernel`` reads
``clock64()`` at the start, after every CTA barrier and after each diagonal
block, so each 32-column sub-panel splits into D (one warp factors and
inverts the diagonal block), S (the sub-panel and the inverse's block row)
and U (the fused trailing update), between the load and the store.  Three
variants of the diagonal block's divisions, each held against
``torch.linalg.cholesky`` and timed by CUDA events (L2 flushed) in turns:

- ``committed``: the source as it is (only the lanes that need a quotient
  divide);
- ``all_lanes``: every lane runs both ``__fdiv_rn``, as the unblocked
  kernel did (zeros and stale entries take the division's slow path);
- ``reciprocal``: one ``__frcp_rn`` and two multiplies instead of the two
  divisions (rounds differently from the plain recurrence).

Prints median cycles per phase, the card's SM clock and its name and power
limit.  Needs one CUDA card and nvcc; imports no jax.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess

import numpy as np
import torch

from cholesky_is_magic_tpu_torch.ops import cuda_build

SRC = cuda_build.CSRC_DIR / "potrf.cu"
OUT = cuda_build.BUILD_DIR.parent / "tile_probe"

GUARDED = """    float lij;
    if (i > j) {
      lij = __fdiv_rn(a[j], s);
    } else {
      lij = (i == j) ? s : 0.0f;
      x[j] = __fdiv_rn(x[j], s);  // row j of the inverse is final
    }
"""
VARIANTS = {
    "committed": GUARDED,
    "all_lanes": """    const float q = __fdiv_rn(a[j], s);
    const float lij = (i < j) ? 0.0f : (i == j ? s : q);
    x[j] = __fdiv_rn(x[j], s);
""",
    "reciprocal": """    const float rs = __frcp_rn(s);
    float lij;
    if (i > j) {
      lij = __fmul_rn(a[j], rs);
    } else {
      lij = (i == j) ? s : 0.0f;
      x[j] = __fmul_rn(x[j], rs);
    }
""",
}
PROBE = "if (threadIdx.x == 0) cim_probe[cim_np++] = clock64();"
READER = """
extern "C" int cim_probe_read(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, cim_probe, sizeof(cim_probe)));
}
"""


def instrument(text: str, variant: str) -> str:
    """The source with the variant's divisions and the clock probes."""
    if text.count(GUARDED) != 1:
        raise RuntimeError("potrf.cu: the diagonal block's divisions changed; "
                           "update the probe's variants")
    text = text.replace(GUARDED, VARIANTS[variant])
    start = text.index("potrf_tile_kernel(const float* A")
    end = text.index("\n}\n", start)  # the kernel's closing brace
    body = text[start:end]
    body = body.replace("__syncthreads();", "__syncthreads(); " + PROBE)
    body = re.sub(r"(factor_diag_block\([^;]*\);)", r"\1 " + PROBE, body)
    body = body.replace("extern __shared__ float4 smem4[];",
                        "extern __shared__ float4 smem4[];\n  int cim_np = 0;\n  " + PROBE)
    text = text[:start] + body + "\n  " + PROBE + text[end:]
    text = text.replace("#include <cuda_runtime.h>\n",
                        "#include <cuda_runtime.h>\n__device__ long long cim_probe[256];\n", 1)
    return text + READER


def build(variant: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"potrf_{variant}.cu"
    lib = OUT / f"libprobe_{variant}.so"
    src.write_text(instrument(SRC.read_text(), variant))
    cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {variant}:\n{proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    dll.cim_potrf_tile_f32.argtypes = [P, LL, P, LL, I, P]
    dll.cim_potrf_tile_f32.restype = I
    dll.cim_probe_read.argtypes = [P]
    dll.cim_probe_read.restype = I
    return dll


def run(dll, N, reps, flush):
    b = N.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    host = np.zeros(256, dtype=np.int64)
    cycles, ms = [], []
    ref = torch.linalg.cholesky(N.double())
    for _ in range(reps):
        T, inv = N.clone(), torch.empty_like(N)
        flush.zero_()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        err = dll.cim_potrf_tile_f32(T.data_ptr(), b, inv.data_ptr(), b, b, stream)
        ev[1].record()
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"launch failed with error {err}")
        ms.append(ev[0].elapsed_time(ev[1]))
        if dll.cim_probe_read(host.ctypes.data):
            raise RuntimeError("reading the probe failed")
        rel = ((T.double() - ref).abs().max() / ref.abs().max()).item()
        if not rel <= 64 * np.finfo(np.float32).eps:
            raise AssertionError(f"probe kernel disagrees with cholesky: {rel}")
        cycles.append(host.copy())
    return np.median(np.array(cycles), axis=0), float(np.median(ms))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=128)
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    b = args.b
    rng = np.random.default_rng(1)
    M = rng.normal(size=(b, b))
    N = torch.tensor(M @ M.T / b + np.eye(b), dtype=torch.float32, device="cuda")
    flush = torch.empty(25 * 2**20, device="cuda")  # 100 MB > the 50 MB L2
    libs = {v: build(v) for v in VARIANTS}
    panels = -(-b // 32)
    names = ["load"] + [f"{p}{k}" for k in range(panels) for p in ("D", "Dwait", "S", "U")] \
        + ["store"]
    for v in ("committed", "all_lanes", "reciprocal", "committed"):
        stamps, ms = run(libs[v], N, args.reps, flush)
        d = np.diff(stamps[: len(names) + 1])
        diag = sum(x for n, x in zip(names, d) if n.startswith("D") and "wait" not in n)
        print(f"[probe] b={b} {v}: event median {ms:.4f} ms, {d.sum():.0f} cycles, of which "
              f"diagonal blocks {diag:.0f}; " + ", ".join(f"{n} {x:.0f}" for n, x in zip(names, d)),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[probe] card, power limit, SM clock: {smi.stdout.strip()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
