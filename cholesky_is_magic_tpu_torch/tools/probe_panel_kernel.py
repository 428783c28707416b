"""The panel kernel's time at every panel step of the blocked potrf, by
rows per CTA.

    python -m cholesky_is_magic_tpu_torch.tools.probe_panel_kernel [--n 1536 1441]

Runs ``chol_cuda.potrf``'s panel loop on an n x n SPD matrix.  Before each
panel step (``rows`` = n - 128 (k + 1) rows below the k-th diagonal block,
b = 128) it times the panel kernel (``potrf_panel_kernel``) alone at every
number of rows per CTA in ``chol_cuda.PANEL_ROWS`` (the wrapper takes
``chol_cuda.PANEL_ROWS_PER_CTA``), beside ``torch.matmul`` of the panel
by the inverse's transpose: CUDA events around back-to-back calls, each
on its own copy of the matrix (so the panel comes from device memory),
the card asleep while the host queues them, in two turns of opposite
order.  Every choice must give the same panel bit for bit,
within 2b·eps32·Σ|terms| of ``torch.matmul``, and a zero strip.

Prints, per step, the time at each choice (the lesser of the two turns)
and the fastest; per n, the sum over the steps at each choice, at the
fastest of each step and of ``torch.matmul``; then the card's name and
power limit.  Needs one CUDA card and nvcc; imports no jax.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from cholesky_is_magic_tpu_torch.ops import chol_cuda

EPS32 = float(np.finfo(np.float32).eps)
SLEEP_CYCLES_PER_CALL = 200_000  # ~0.1 ms at ~2 GHz


def back_to_back_ms(launch, reps: int) -> float:
    """Device ms per call of ``launch(r)``, r = 0 .. reps - 1, between two
    CUDA events, after a warm-up call ``launch(reps)``; the card sleeps
    while the host queues them, so it never waits on the host."""
    launch(reps)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * reps)
    ev[0].record()
    for r in range(reps):
        launch(r)
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def step_ms(A, off, e, inv, choice, reps):
    """Device ms of the panel step at columns [off, e) of A's copies at
    ``choice`` (rows per CTA, or "matmul"); the copies after the kernel,
    for the checks."""
    W = A.expand(reps + 1, *A.shape).clone()
    if choice == "matmul":
        out = torch.empty(reps + 1, A.shape[0] - e, e - off, device=A.device)
        ms = back_to_back_ms(lambda r: torch.matmul(W[r, e:, off:e], inv.T, out=out[r]), reps)
        return ms, None
    ms = back_to_back_ms(lambda r: chol_cuda._potrf_panel(
        W[r, e:, off:e], inv, W[r, off:e, e:], choice), reps)
    return ms, W


def probe(n: int, reps: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    A = torch.tensor(M @ M.T / n + np.eye(n), dtype=torch.float32, device="cuda")
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count
    b = chol_cuda.BLOCK
    inv = torch.empty((b, b), device="cuda")
    choices = [*chol_cuda.PANEL_ROWS, "matmul"]
    sums = {c: 0.0 for c in choices}
    fastest_sum = 0.0
    for k, off in enumerate(range(0, n - b, b)):
        e = off + b
        rows = n - e
        chol_cuda.potrf_tile_(A[off:e, off:e], inv)
        panel = A[e:, off:e].clone()
        plain = panel @ inv.T
        mag = panel.abs() @ inv.T.abs()
        times = {c: [] for c in choices}
        ref = None
        for turn in (choices, choices[::-1]):
            for c in turn:
                ms, W = step_ms(A, off, e, inv, c, reps)
                times[c].append(ms)
                if W is None:
                    continue
                got = W[:, e:, off:e]
                if ref is None:
                    ref = got[0].clone()
                    ratio = ((ref - plain).abs() / (EPS32 * mag + 1e-30)).max().item()
                    if not ratio <= 2 * b:
                        raise AssertionError(f"panel kernel vs torch.matmul: {ratio}")
                if not (torch.equal(got, ref.expand_as(got))
                        and bool((W[:, off:e, e:] == 0).all())):
                    raise AssertionError(f"panel kernel at rows per CTA {c} differs")
                del W, got
        best = {c: min(t) for c, t in times.items()}
        kernel = {c: t for c, t in best.items() if c in chol_cuda.PANEL_ROWS}
        fastest = min(kernel, key=kernel.get)
        for c in choices:
            sums[c] += best[c]
        fastest_sum += kernel[fastest]
        print(f"[probe] n={n} step {k} rows {rows}: "
              + ", ".join(f"{c} rows per CTA ({-(-rows // c)} CTAs) {kernel[c]:.4f}"
                          for c in chol_cuda.PANEL_ROWS)
              + f"; torch.matmul {best['matmul']:.4f}; fastest {fastest}", flush=True)
        chol_cuda.potrf_panel_(A[e:, off:e], inv, A[off:e, e:])
        chol_cuda.potrf_schur_(A[e:, e:], A[e:, off:e])
    print(f"[probe] n={n} sum over the panel steps (ms): "
          + ", ".join(f"{c} rows per CTA {sums[c]:.4f}" for c in chol_cuda.PANEL_ROWS)
          + f"; fastest per step {fastest_sum:.4f}; torch.matmul {sums['matmul']:.4f}"
          f"  (the wrapper takes {chol_cuda.PANEL_ROWS_PER_CTA}; {sms} SMs)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, nargs="+", default=[1536, 1441])
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    for n in args.n:
        probe(n, args.reps, args.seed)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[probe] card, power limit: {smi.stdout.strip()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
