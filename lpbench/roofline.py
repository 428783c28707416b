"""The yardstick of the hand-written kernels: the least time an H100 could
take for the work a launch's shapes need, and a kernel's share of it.

Each input byte is counted as read once and each output byte as written
once, whatever the kernel reads again, with float32 operations at the
published FP32 rate (outside the tensor cores).  The peaks are NVIDIA's
data sheet for the SXM part, which assume the full 700 W power limit; a
card set lower runs below them, so every share is printed beside the
card's power limit.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_FP32_FLOPS = 67e12  # FP32, no tensor cores
PEAK_POWER_W = 700.0  # the power limit the peaks assume

# dd A·x and Aᵀ·x: per element of A the product and its error and the
# compensated accumulation.
DD_FLOPS_PER_ELEMENT = 14


def bound(nbytes: float, flops: float) -> dict:
    """The least time in ms (``ms``) and which of ``"bytes"`` or
    ``"operations"`` sets it (``by``)."""
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FP32_FLOPS * 1e3
    return {"ms": max(t_b, t_f), "by": "bytes" if t_b >= t_f else "operations",
            "bytes": nbytes, "flops": flops}


def dd_mv(lanes: int, m: int, n: int, shared_a: bool = False) -> dict:
    """Double-word A·x on ``lanes`` lanes of (m, n) float32 A and float32 x,
    a (hi, lo) pair of m float32 out per lane; ``shared_a``: one A for all
    lanes, read once."""
    a = 4 * m * n * (1 if shared_a else lanes)
    return bound(a + 4 * lanes * n + 8 * lanes * m,
                 DD_FLOPS_PER_ELEMENT * lanes * m * n)


def dd_rmv(lanes: int, m: int, n: int, shared_a: bool = False) -> dict:
    """Double-word Aᵀ·y: (m, n) A, m float32 in, a (hi, lo) pair of n out."""
    a = 4 * m * n * (1 if shared_a else lanes)
    return bound(a + 4 * lanes * m + 8 * lanes * n,
                 DD_FLOPS_PER_ELEMENT * lanes * m * n)


def potrf_tile(lanes: int, b: int) -> dict:
    """Cholesky factor and inverse of ``lanes`` (b, b) tiles: the lower
    triangle read, L and L⁻¹ written; b³/3 for the factor and b³/3 for the
    inverse."""
    return bound(4 * lanes * (b * (b + 1) // 2 + 2 * b * b),
                 lanes * 2 * b**3 / 3)


def assemble_pairs(lanes: int, schedule_bytes: int, n_pairs: int, n_d: int,
                   n_boost: int, tiles: int, b: int) -> dict:
    """Assembly of the normal matrix's resident tiles from the pair
    schedule: the schedule (weights, columns and runs, ``schedule_bytes``,
    shared by the lanes) read once, each lane's column scaling (``n_d``)
    and row boost (``n_boost``) read and its ``tiles`` (b, b) tiles
    written; 3 operations per pair per lane."""
    return bound(schedule_bytes + 4 * lanes * (n_d + n_boost + tiles * b * b),
                 3 * lanes * n_pairs)


def share_pct(bound_ms: float, device_ms: float) -> float | None:
    """The kernel's share of its bound in %, or None where it never ran."""
    if device_ms <= 0.0:
        return None
    return 100.0 * bound_ms / device_ms


def traced_share(run, kernel_pattern: str, targets) -> float | None:
    """A kernel's share of its roofline over the traced call: the bounds of
    its launches, each recorded with its shapes by the wrappers
    ``targets``, over the device time of the profiler's kernel events whose
    name matches ``kernel_pattern``.  None where the kernel did not run or
    the events and the recorded launches do not pair up one to one."""
    if run.trace is None:
        return None
    bounds = [d for t in targets for d in run.launches.get(t, [])]
    launches, device_s = run.trace.kernel_s(kernel_pattern)
    if launches == 0:
        return None
    if launches != len(bounds):
        run.say(f"[roofline] {kernel_pattern}: {launches} kernel events against"
                f" {len(bounds)} recorded launches; share not read")
        return None
    bound_ms = sum(d["ms"] for d in bounds)
    by = sorted({d["by"] for d in bounds})
    share = share_pct(bound_ms, 1e3 * device_s)
    run.say(f"[roofline] {kernel_pattern}: {launches} launches, device {1e3 * device_s:.4f} ms,"
            f" bound {bound_ms:.4f} ms ({'/'.join(by)}; {PEAK_BYTES_PER_S / 1e12:.2f} TB/s,"
            f" {PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s FP32 at {PEAK_POWER_W:.0f} W), {share:.2f}%")
    return share
