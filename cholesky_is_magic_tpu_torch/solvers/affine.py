"""Slack and ratio-test helpers of primal affine scaling.

Counterpart of ``cholesky_is_magic_tpu/solvers/affine.py:192-248``: the
helpers pdas uses.  The affine solver loop itself is not ported yet.
"""

from __future__ import annotations

import torch

BIG_BOUND = 1e10  # "effectively infinite" bound threshold (affine-scaling.lisp:67-75)


def _into_interior(x, l, u, mask):
    """Pull x strictly inside [l, u] by a relative epsilon (the reference
    asserts strict interiority; in floating point an iterate can land on a
    bound, after which every ratio test returns 0)."""
    eps = 1e-12 if x.dtype == torch.float64 else 1e-6
    margin = eps * torch.clamp_max(u - l, 1.0)
    xi = torch.clamp(x, l + margin, u - margin)
    xi = torch.where(u - l < 2 * margin, 0.5 * (l + u), xi)
    return torch.where(mask, xi, x)


def _slack(l, x, u, cap, mask):
    """min(cap, x - l, u - x), 1 on masked entries (slack, :137-148)."""
    s = torch.clamp_max(torch.minimum(x - l, u - x), cap)
    return torch.where(mask, torch.clamp_min(s, 1e-30), 1.0)


def _centering_direction(l, x, u, mask):
    """Pull toward the nearer bound's opposite (:150-163)."""
    both_inf = (l <= -BIG_BOUND) & (u >= BIG_BOUND)
    toward_upper = (x - l) < (u - x)
    d = torch.where(
        both_inf,
        0.0,
        torch.where(
            toward_upper,
            torch.clamp_max(u - x, 1.0),
            torch.clamp_min(l - x, -1.0),
        ),
    )
    return torch.where(mask, d, 0.0)


def _max_step(l, x, u, g, mask):
    """Masked ratio test (max-step, :120-133): largest t with
    l <= x + t·g <= u, each ratio clamped at >= 0."""
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    step = torch.where(
        g == 0,
        inf,
        torch.clamp_min(torch.where(g < 0, (l - x) / g, (u - x) / g), 0.0),
    )
    step = torch.where(mask, step, inf)
    return torch.min(step)
