"""Drive the PyTorch port's main path once on an NVIDIA card, and check it.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); imports no jax.  Phases,
in order, each printing what it finds and raising on a failure (the
script then exits non-zero and never prints its last line):

1. device — the card, torch and CUDA versions, nvidia-smi's name and
   power limit;
2. build  — compile the double-word kernels from csrc/ (timed);
3. kernels — dd_matvec / dd_rmatvec against the f64 truth at (512, 1024)
   (rtol = atol = 1e-11), against the plain PyTorch version on the card at
   (1441, 5093) and (1536, 5120) (within 64·eps32² of Σ|a_ij x_j| per
   output), and kernel vs plain median times by CUDA events at
   (1536, 5120) and (4096, 8192);
4. afiro — solve(afiro, "pdas_dd", device="cuda") in f32: gap <= 1e-8,
   objective within 1e-7 relative of the published optimum;
5. pilot — the constructed-optimum LP at the pilot scale (1441 x 5093,
   padded to 1536 x 5120, f32): the main path.  Launch counters are reset
   just before and read just after; both kernels must have launched.  Gap
   <= 1e-8, objective error <= 1e-7; then a second, timed solve.

The second-to-last line is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
KERNELS = {
    "mv": dict(name="dd_mv_f32", replaces="cholesky_is_magic_tpu/ops/dd_pallas.py:79"),
    "rmv": dict(name="dd_rmv_f32", replaces="cholesky_is_magic_tpu/ops/dd_pallas.py:96"),
}
SOURCE = "cholesky_is_magic_tpu_torch/csrc/dd_matvec.cu"


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


def phase_build(dd_cuda):
    t = time.perf_counter()
    path = dd_cuda.build()
    dd_cuda._load()
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


def _median_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_kernels(ddm):
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
    for m, n in ((1441, 5093), (1536, 5120)):
        A, x, y = _inputs(m, n, m)
        for which, got, plain, scale in (
            ("mv", ddm.dd_matvec(A, x), ddm._dd_matvec_plain(A, x),
             A.abs() @ x.abs()),
            ("rmv", ddm.dd_rmatvec(A, y), ddm._dd_matvec_plain(A.T, y),
             A.abs().T @ y.abs()),
        ):
            err = (_f64(got) - _f64(plain)).abs()
            ratio = (err / (EPS32**2 * scale.double())).max().item()
            say(f"[kernels] {which} ({m}, {n}) vs plain: max abs err "
                f"{err.max().item():.3e}, max err / (eps32^2 sum|ax|) {ratio:.3f}"
                f" (limit {PLAIN_TOL})")
            if not ratio <= PLAIN_TOL:
                raise AssertionError(f"{which} disagrees with its plain version")
            if (m, n) == (1536, 5120):
                stats[which] = {"max_abs_err": err.max().item()}

    for m, n in ((1536, 5120), (4096, 8192)):
        A, x, y = _inputs(m, n, 7)
        runs = {
            "mv": (lambda: ddm.dd_matvec(A, x), lambda: ddm._dd_matvec_plain(A, x)),
            "rmv": (lambda: ddm.dd_rmatvec(A, y),
                    lambda: ddm._dd_matvec_plain(A.T, y)),
        }
        for which, (kern, plain) in runs.items():
            p1, k1, k2, p2 = (_median_ms(f) for f in (plain, kern, kern, plain))
            k, p = min(k1, k2), min(p1, p2)
            gbs = m * n * 4 / (k * 1e-3) / 1e9
            say(f"[kernels] {which} ({m}, {n}) median ms: kernel {k1:.4f} {k2:.4f}"
                f"  plain {p1:.4f} {p2:.4f}  (kernel reads A at {gbs:.0f} GB/s)")
            if (m, n) == (1536, 5120):
                stats[which].update(ms=k, plain_ms=p)
        del A, x, y
        torch.cuda.empty_cache()
    return stats


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


def phase_pilot(cimt, dd_cuda, card):
    from cholesky_is_magic_tpu_torch.utils.testing import constructed_optimum_lp

    sf, info = constructed_optimum_lp("pilot", seed=0)
    say(f"[pilot] constructed optimum LP {sf.ncons} x {sf.nvars}, "
        f"padded to 1536 x 5120, f32")
    for k in dd_cuda.LAUNCHES:
        dd_cuda.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    rep = cimt.solve(sf, "pdas_dd", device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = dict(dd_cuda.LAUNCHES)
    say(f"[pilot] first solve {first_s:.3f} s, kernel launches {launches}")
    _check_solve("pilot", rep, info["objective"])
    if not all(launches[k] > 0 for k in KERNELS):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    torch.cuda.synchronize()
    t = time.perf_counter()
    rep2 = cimt.solve(sf, "pdas_dd", device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    say(f"[pilot] second solve wall-clock {time.perf_counter() - t:.3f} s "
        f"({rep2.summary['phase1_iterations']} + {rep2.summary['iterations']} "
        f"iterations) on {card}")
    return launches


def main() -> int:
    card = phase_device()
    import cholesky_is_magic_tpu_torch as cimt
    from cholesky_is_magic_tpu_torch.ops import dd as ddm
    from cholesky_is_magic_tpu_torch.ops import dd_cuda
    from cholesky_is_magic_tpu_torch.utils.precision import set_highest_precision

    set_highest_precision()
    phase_build(dd_cuda)
    stats = phase_kernels(ddm)
    phase_afiro(cimt)
    launches = phase_pilot(cimt, dd_cuda, card)
    say(card_line())  # name, power limit: exactly as nvidia-smi prints them
    kernels = [
        dict(KERNELS[k], route="cuda", source=SOURCE, launches=launches[k],
             **stats[k])
        for k in KERNELS
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
