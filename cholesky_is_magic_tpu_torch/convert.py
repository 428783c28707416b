"""Carry operands, iterates and results between NumPy and the port.

The JAX package's objects, handed over as NumPy arrays (any object whose
fields ``np.asarray`` accepts), become the port's tensors on a chosen device
and dtype, so that both packages can start from bit-identical state; the
port's results come back as NumPy.  Nothing here imports jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cholesky_is_magic_tpu_torch.ingest.device import DeviceLP, SparseKKTLP, SparseLP
from cholesky_is_magic_tpu_torch.ops.bell import BellMatrix
from cholesky_is_magic_tpu_torch.ops.dd import DD
from cholesky_is_magic_tpu_torch.ops.sparse_ops import ELLMatrix
from cholesky_is_magic_tpu_torch.solvers.alm import ALMState
from cholesky_is_magic_tpu_torch.solvers.approx import ApproxProblem, comp_fields
from cholesky_is_magic_tpu_torch.solvers.pdas import PDASState
from cholesky_is_magic_tpu_torch.solvers.pdas_dd import PDASDDState
from cholesky_is_magic_tpu_torch.solvers.result import SolveResult

_FLOAT_FIELDS = ("A", "c", "b", "l", "u")


def tensor_from_numpy(v, *, device="cuda", dtype=None) -> torch.Tensor:
    """One array -> tensor on ``device``; ``dtype`` None keeps the array's."""
    t = torch.from_numpy(np.array(v, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def device_lp_from_numpy(lp, *, device="cuda", dtype=None) -> DeviceLP:
    """A DeviceLP from an object with the fields A, c, b, l, u, row_mask,
    col_mask, row_type, m, n; ``dtype`` applies to the float fields."""
    fields = {
        f: tensor_from_numpy(getattr(lp, f), device=device,
                             dtype=dtype if f in _FLOAT_FIELDS else None)
        for f in _FLOAT_FIELDS + ("row_mask", "col_mask", "row_type")
    }
    return DeviceLP(**fields, m=int(lp.m), n=int(lp.n))


def pdas_state_from_numpy(st, *, device="cuda", dtype=None) -> PDASState:
    """A PDASState from an object with fields x, y, w, z and lp."""
    put = lambda v: tensor_from_numpy(v, device=device, dtype=dtype)
    return PDASState(
        x=put(st.x), y=put(st.y), w=put(st.w), z=put(st.z),
        lp=device_lp_from_numpy(st.lp, device=device, dtype=dtype),
    )


def pdas_dd_state_from_numpy(st, *, device="cuda", dtype=None) -> PDASDDState:
    """A PDASDDState from an object with fields x, y, w, z (each with
    ``hi`` and ``lo``) and lp."""
    put = lambda d: DD(tensor_from_numpy(d.hi, device=device, dtype=dtype),
                       tensor_from_numpy(d.lo, device=device, dtype=dtype))
    return PDASDDState(
        x=put(st.x), y=put(st.y), w=put(st.w), z=put(st.z),
        lp=device_lp_from_numpy(st.lp, device=device, dtype=dtype),
    )


def _ell_from_numpy(E, *, device, dtype) -> ELLMatrix:
    return ELLMatrix(
        indices=tensor_from_numpy(np.asarray(E.indices, np.int64), device=device),
        values=tensor_from_numpy(E.values, device=device, dtype=dtype),
        n_cols=int(E.n_cols),
    )


def _bell_from_numpy(B, *, device, dtype):
    if B is None:
        return None
    return BellMatrix(
        blocks=tensor_from_numpy(B.blocks, device=device, dtype=dtype),
        bcols=tensor_from_numpy(np.asarray(B.bcols, np.int64), device=device),
        n_rows=int(B.n_rows),
        n_cols=int(B.n_cols),
        nnz=int(np.count_nonzero(np.asarray(B.blocks))),
    )


def sparse_lp_from_numpy(lp, *, device="cuda", dtype=None) -> SparseLP:
    """A SparseLP from an object with the fields E (indices, values,
    n_cols), EB and ETB (blocks, bcols, n_rows, n_cols; or None), c, b, l,
    u, row_type, m, n; ``dtype`` applies to the float fields, indices
    become int64."""
    put = lambda v: tensor_from_numpy(v, device=device, dtype=dtype)  # noqa: E731
    return SparseLP(
        E=_ell_from_numpy(lp.E, device=device, dtype=dtype),
        EB=_bell_from_numpy(lp.EB, device=device, dtype=dtype),
        ETB=_bell_from_numpy(lp.ETB, device=device, dtype=dtype),
        c=put(lp.c), b=put(lp.b), l=put(lp.l), u=put(lp.u),
        row_type=tensor_from_numpy(lp.row_type, device=device),
        m=int(lp.m), n=int(lp.n),
    )


def sparse_kkt_lp_from_numpy(lp, *, device="cuda", dtype=None) -> SparseKKTLP:
    """A SparseKKTLP from an object with the fields E and ET (indices,
    values, n_cols), EB and ETB (blocks, bcols, n_rows, n_cols; or None),
    c, b, l, u, row_mask, col_mask, m, n; ``dtype`` applies to the float
    fields, indices become int64.  The arrays may carry a leading lane axis
    (a stacked batch of one A)."""
    put = lambda v: tensor_from_numpy(v, device=device, dtype=dtype)  # noqa: E731
    mask = lambda v: tensor_from_numpy(np.asarray(v, bool), device=device)  # noqa: E731
    return SparseKKTLP(
        E=_ell_from_numpy(lp.E, device=device, dtype=dtype),
        ET=_ell_from_numpy(lp.ET, device=device, dtype=dtype),
        c=put(lp.c), b=put(lp.b), l=put(lp.l), u=put(lp.u),
        row_mask=mask(lp.row_mask), col_mask=mask(lp.col_mask),
        m=int(lp.m), n=int(lp.n),
        EB=_bell_from_numpy(lp.EB, device=device, dtype=dtype),
        ETB=_bell_from_numpy(lp.ETB, device=device, dtype=dtype),
    )


def pdas_sparse_state_from_numpy(st, *, device="cuda", dtype=None) -> PDASState:
    """A PDASState over a SparseKKTLP from an object with the fields x, y,
    w, z and lp (see :func:`sparse_kkt_lp_from_numpy`), with or without a
    leading lane axis."""
    put = lambda v: tensor_from_numpy(v, device=device, dtype=dtype)  # noqa: E731
    return PDASState(
        x=put(st.x), y=put(st.y), w=put(st.w), z=put(st.z),
        lp=sparse_kkt_lp_from_numpy(st.lp, device=device, dtype=dtype),
    )


def pdas_dd_sparse_state_from_numpy(st, *, device="cuda",
                                    dtype=None) -> PDASDDState:
    """A PDASDDState over a SparseKKTLP from an object with the fields x, y,
    w, z (each with ``hi`` and ``lo``) and lp, with or without a leading
    lane axis."""
    put = lambda d: DD(tensor_from_numpy(d.hi, device=device, dtype=dtype),  # noqa: E731
                       tensor_from_numpy(d.lo, device=device, dtype=dtype))
    return PDASDDState(
        x=put(st.x), y=put(st.y), w=put(st.w), z=put(st.z),
        lp=sparse_kkt_lp_from_numpy(st.lp, device=device, dtype=dtype),
    )


def approx_problem_from_numpy(prob, *, device="cuda", dtype=None) -> ApproxProblem:
    """An ApproxProblem from an object with its fields (Q dense, or an ELL
    matrix with QB / QTB block-ELL renderings or None)."""
    put = lambda v: tensor_from_numpy(v, device=device, dtype=dtype)  # noqa: E731
    Q = (_ell_from_numpy(prob.Q, device=device, dtype=dtype)
         if hasattr(prob.Q, "indices") else put(prob.Q))
    dtype = dtype or torch.from_numpy(np.array(prob.q)).dtype
    return ApproxProblem(
        Q=Q,
        QB=_bell_from_numpy(prob.QB, device=device, dtype=dtype),
        QTB=_bell_from_numpy(prob.QTB, device=device, dtype=dtype),
        q=put(prob.q), s=put(prob.s), beta=put(prob.beta),
        c_lin=put(prob.c_lin), nu=put(prob.nu), l=put(prob.l), u=put(prob.u),
        z0=put(prob.z0), n_quads=int(prob.n_quads), n_vars=int(prob.n_vars),
        **comp_fields(*(np.asarray(getattr(prob, f)) for f in (
            "comp_a", "comp_b", "comp_a0", "comp_b0", "comp_sign")),
            dtype=dtype, device=device),
    )


def alm_state_from_numpy(st, *, device="cuda", dtype=None) -> ALMState:
    """An ALMState from an object with the fields lp (a dense or a sparse
    LP), mu, omega, nu, multipliers, mult_l and mult_u."""
    put = lambda v: tensor_from_numpy(v, device=device, dtype=dtype)  # noqa: E731
    lp = (sparse_lp_from_numpy if hasattr(st.lp, "E") else device_lp_from_numpy)(
        st.lp, device=device, dtype=dtype)
    return ALMState(
        lp=lp, mu=put(st.mu), omega=put(st.omega), nu=put(st.nu),
        multipliers=put(st.multipliers), mult_l=put(st.mult_l),
        mult_u=put(st.mult_u),
    )


_RESULT_EXTRA = ("y", "w", "z", "x_lo", "gap", "dual_objective")


def solve_result_from_numpy(res, *, device="cuda", dtype=None) -> SolveResult:
    """A SolveResult from an object with fields x, objective, status,
    iterations, residual_norm and ``extra`` (of which y, w, z, x_lo, gap and
    dual_objective are carried where present); ``dtype`` applies to the
    float fields, status and iterations become int32."""
    put = lambda v: tensor_from_numpy(v, device=device, dtype=dtype)
    count = lambda v: tensor_from_numpy(v, device=device, dtype=torch.int32)
    return SolveResult(
        x=put(res.x), objective=put(res.objective), status=count(res.status),
        iterations=count(res.iterations), residual_norm=put(res.residual_norm),
        extra={k: put(res.extra[k]) for k in _RESULT_EXTRA if k in res.extra},
    )


def to_numpy(obj):
    """Tensors (inside dataclasses, tuples, lists and dicts) -> NumPy."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, DD):
        return DD(to_numpy(obj.hi), to_numpy(obj.lo))
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy(v) for v in obj)
    return obj
