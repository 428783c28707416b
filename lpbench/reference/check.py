"""The plain checker: what decides ``correct``.

It takes the fleet as the generator made it (A, l, u and each lane's b, c
and exact optimum) and the iterate each lane's solve returned, and works
out in float64 NumPy how far that iterate is from the optimum and from
feasibility.  It imports nothing of the program and takes nothing the
program made except the iterates it judges: the operands the program
solves (rounded to the configuration's dtype, rows equilibrated as the
program's path does it) are worked out again here from the generator's
arrays, so the residuals and the gap are those of the LP the program was
asked to solve, and the errors against the exact optimum are those of the
LP the generator made.

Per lane (x = x_hi + x_lo where the solver returns a low word, y the
equality duals in the program's scaled rows, z and w the lower- and
upper-bound duals):

- ``primal_res``  ||A_s x - b_s||∞ / (1 + ||b_s||∞) on the scaled rows
- ``dual_res``    ||A_sᵀ y + z - w - c||∞ / (1 + ||c||∞)
- ``gap``         |c'x - (b_s'y + l'z - u'w)| / (1 + |c'x|)
- ``obj_err``     |c'x - c'x*| / (1 + |c'x*|) against the exact optimum
- ``x_err``       ||x - x*||∞ / (1 + ||x*||∞)
- ``y_err``       ||S y - y*||∞ / (1 + ||y*||∞), S the row scales
- ``zw_err``      max(||z - z*||∞, ||w - w*||∞) / (1 + ||c - Aᵀy*||∞)
- ``obj_claim``   |objective returned - c'x| / (1 + |c'x|)

A number that is not finite reads ``inf``.  The numbers of a run are the
largest over its lanes and calls.
"""

from __future__ import annotations

import dataclasses

import numpy as np

NUMBERS = ("primal_res", "dual_res", "gap", "obj_err", "x_err", "y_err",
           "zw_err", "obj_claim")


@dataclasses.dataclass(frozen=True)
class Operands:
    """The operands the program's path solves, worked out again: the row
    scales ``scale`` and, in float32 then widened to float64, the scaled
    values ``vals_s`` of A's triplets, each lane's scaled ``b_s``, ``c``,
    and the shared ``l``, ``u``."""

    scale: np.ndarray
    vals_s: np.ndarray
    b_s: np.ndarray
    c: np.ndarray
    l: np.ndarray
    u: np.ndarray


def _round(v, dtype: str) -> np.ndarray:
    """float64 values rounded to the operands' ``dtype``, widened back."""
    return np.asarray(v, np.float64).astype(dtype).astype(np.float64)


def program_operands(fleet, path: str, dtype: str = "float32") -> Operands:
    """The LP of each lane as the program's ``path`` holds it in ``dtype``.

    ``"dense"``: the operands rounded to ``dtype`` on the host, then each
    row scaled on the card in ``dtype`` by s = 1 / max_j |a_ij| (rows whose
    max is under 1e-6 keep scale 1), every operation rounded once.
    ``"sparse"``: the rows scaled on the host in float64, then rounded to
    ``dtype``."""
    m, rows = fleet.m, fleet.rows
    if path == "dense":
        t = np.dtype(dtype).type
        v = np.asarray(fleet.vals, np.float64).astype(dtype)
        rmax = np.zeros(m, dtype)
        np.maximum.at(rmax, rows, np.abs(v))
        one = t(1.0)
        scale = np.where(rmax < t(1e-6), one,
                         one / np.where(rmax == 0, one, rmax)).astype(dtype)
        vals_s = (v * scale[rows]).astype(np.float64)
        b_s = (np.asarray(fleet.b, np.float64).astype(dtype) * scale[None, :]).astype(np.float64)
        scale = scale.astype(np.float64)
    elif path == "sparse":
        norm = np.zeros(m)
        np.maximum.at(norm, rows, np.abs(fleet.vals))
        scale = np.where(norm < 1e-6, 1.0, 1.0 / np.where(norm == 0, 1.0, norm))
        vals_s = _round(fleet.vals * scale[rows], dtype)
        b_s = _round(fleet.b * scale[None, :], dtype)
    else:
        raise ValueError(f"unknown path {path!r}")
    return Operands(scale=scale, vals_s=vals_s, b_s=b_s, c=_round(fleet.c, dtype),
                    l=_round(fleet.l, dtype), u=_round(fleet.u, dtype))


def _inf_norm(v) -> float:
    return float(np.max(np.abs(v))) if np.size(v) else 0.0


def lane_numbers(fleet, ops: Operands, k: int, got: dict) -> dict:
    """The numbers of lane ``k``'s returned iterate ``got`` (host arrays
    ``x``, optional ``x_lo``, ``y``, ``z``, ``w`` and the float
    ``objective``; padding beyond n and m is ignored)."""
    m, n = fleet.m, fleet.n
    x = np.asarray(got["x"], np.float64)[:n]
    if got.get("x_lo") is not None:
        x = x + np.asarray(got["x_lo"], np.float64)[:n]
    y = np.asarray(got["y"], np.float64)[:m]
    z = np.asarray(got["z"], np.float64)[:n]
    w = np.asarray(got["w"], np.float64)[:n]
    rows, cols = fleet.rows, fleet.cols
    Ax = np.bincount(rows, ops.vals_s * x[cols], minlength=m)
    Aty = np.bincount(cols, ops.vals_s * y[rows], minlength=n)
    b, c = ops.b_s[k], ops.c[k]
    pobj = float(c @ x)
    dobj = float(b @ y + ops.l @ z - ops.u @ w)
    xs, ys = fleet.x[k], fleet.y[k]
    rc_star = fleet.z[k] - fleet.w[k]
    out = {
        "primal_res": _inf_norm(Ax - b) / (1.0 + _inf_norm(b)),
        "dual_res": _inf_norm(Aty + z - w - c) / (1.0 + _inf_norm(c)),
        "gap": abs(pobj - dobj) / (1.0 + abs(pobj)),
        "obj_err": abs(float(fleet.c[k] @ x) - fleet.objective[k])
        / (1.0 + abs(fleet.objective[k])),
        "x_err": _inf_norm(x - xs) / (1.0 + _inf_norm(xs)),
        "y_err": _inf_norm(y * ops.scale - ys) / (1.0 + _inf_norm(ys)),
        "zw_err": max(_inf_norm(z - fleet.z[k]), _inf_norm(w - fleet.w[k]))
        / (1.0 + _inf_norm(rc_star)),
        "obj_claim": abs(float(got["objective"]) - pobj) / (1.0 + abs(pobj)),
    }
    return {key: (v if np.isfinite(v) else float("inf")) for key, v in out.items()}


def worst(fleet, path: str, calls: list, dtype: str = "float32") -> dict:
    """The largest of each number over every lane of every call; ``calls``
    is a list of per-lane lists of returned iterates (see
    :func:`lane_numbers`)."""
    ops = program_operands(fleet, path, dtype)
    out = {key: 0.0 for key in NUMBERS}
    for lanes in calls:
        for k, got in enumerate(lanes):
            for key, v in lane_numbers(fleet, ops, k, got).items():
                out[key] = max(out[key], v)
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """Whether every number that has a limit is within it."""
    return all(numbers[key] <= lim for key, lim in limits.items())
