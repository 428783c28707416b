"""Host-side presolve: shrink a StandardForm before it reaches the device.

A NumPy-only copy of ``cholesky_is_magic_tpu/ingest/presolve.py``; only the
StandardForm import differs.  The reference has no presolve — every Netlib instance goes to CHOLMOD at
full size.  This module is a deliberate capability EXTENSION (documented in
PARITY.md): real MPS files are full of fixed variables, singleton rows, and
empty rows/columns, and every eliminated row/column also shrinks the
padded operands, the normal matrix, and the factor schedule.

Rules applied to fixpoint (the classic safe reductions, e.g. Andersen &
Andersen 1995, §"simple presolve"):

1. bound infeasibility: l_j > u_j  -> infeasible.
2. fixed columns (l_j = u_j): substitute x_j, move A[:, j]·x_j into b.
3. empty rows: b_i must be ~0, else infeasible; drop.
4. singleton rows (one structural nonzero): a_ij x_j = b_i fixes
   x_j = b_i / a_ij; out-of-bounds -> infeasible, else rule 2.
5. empty columns: x_j appears only in the objective; it sits at the bound
   minimizing c_j x_j (missing bound on that side -> unbounded).
6. free column singletons: x_j free, appearing only in row i — the row
   can always be satisfied by x_j, so row i AND column j leave; c_j folds
   into the remaining row-i columns (c_k -= c_j a_ik / a_ij) and
   x_j = (b_i - sum a_ik x_k) / a_ij at postsolve.  The rule that fires
   constantly on standard-form slack structures.
7. doubleton-equation substitution: row i has exactly two live nonzeros
   (j, k) and x_j appears ONLY in row i (column singleton, so the
   substitution causes no fill): x_j = (b_i - a_ik x_k) / a_ij; x_j's
   bounds transfer onto x_k, c_j folds into c_k, row i and column j
   leave.
8. row activity bounds (forcing constraints, Andersen & Andersen §4):
   with Lmin_i/Lmax_i the extreme achievable activities of row i over
   the live columns' bounds, b_i outside [Lmin, Lmax] is infeasible;
   b_i = Lmax (resp. Lmin) FORCES every live column to its
   activity-maximizing (minimizing) bound — all pinned, row dropped.
   Dual postsolve: for an Lmax-forcing row every pinned column demands
   y_i >= rc_j/a_ij (both bound sides reduce to the same inequality
   direction), so y_i = max_j rc_j/a_ij restores sign-correct
   complementarity exactly; Lmin mirrors with min.

Every elimination is recorded (``steps``); :meth:`Presolve.restore` maps a
reduced solution back to the ORIGINAL variable space by replaying the
substitutions in reverse, and :meth:`Presolve.restore_duals` reconstructs
the full row duals / reduced costs (eliminated rows get the
complementarity-consistent choice y_i = c_j / a_ij, which makes the folded
reduced costs EQUAL to the original-space reduced costs for kept columns;
rule-3/4 rows get y_i = 0).  Callers keep using the original StandardForm
(and extract_solution) for reporting.  Equality form is preserved — the
reduced problem drops straight into to_device_lp / make_pdas_sparse.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cholesky_is_magic_tpu_torch.ingest.standard_form import StandardForm


@dataclasses.dataclass
class Presolve:
    """Result of :func:`presolve`.

    ``status`` is one of ``"reduced"`` (solve the returned problem, then
    :meth:`restore`), ``"solved"`` (every variable was eliminated —
    ``restore(None)`` gives the full solution), ``"infeasible"``, or
    ``"unbounded"``.
    """

    status: str
    nvars_full: int
    kept_cols: np.ndarray  # original indices of the reduced problem's columns
    kept_rows: np.ndarray
    fixed_vals: np.ndarray  # (nvars_full,) values of eliminated columns (0 where kept)
    detail: str = ""  # human-readable reason for infeasible/unbounded
    # c'x contribution of the eliminated columns: reduced-space objective
    # values (primal or dual) + obj_offset = full-space values.  Tracked
    # INCREMENTALLY (each elimination adds c_j*val at the then-current,
    # possibly folded, c_j).
    obj_offset: float = 0.0
    # Ordered elimination record for the substitution rules; replayed in
    # reverse by restore()/restore_duals().  Entries:
    #   ("doubleton", j, k, i, aij, aik, bi, lj, uj, cj)
    #   ("freecol",   j, i, aij, bi, cols, coefs, cj)
    #   ("forcing",   i, cols, vals, side)   side=+1: Lmax, -1: Lmin
    steps: list = dataclasses.field(default_factory=list)

    def restore(self, x_reduced=None) -> np.ndarray:
        """Lift a reduced-space solution to the original variable space:
        fixed values, then the substitution steps replayed in reverse."""
        x = self.fixed_vals.copy()
        if len(self.kept_cols):
            if x_reduced is None:
                raise ValueError("reduced problem has free variables; pass x_reduced")
            xr = np.asarray(x_reduced, dtype=np.float64)[: len(self.kept_cols)]
            x[self.kept_cols] = xr
        for step in reversed(self.steps):
            if step[0] == "doubleton":
                _, j, k, _i, aij, aik, bi, lj, uj, _cj = step
                x[j] = float(np.clip((bi - aik * x[k]) / aij, lj, uj))
            elif step[0] == "freecol":
                _, j, _i, aij, bi, cols, coefs, _cj = step
                x[j] = (bi - float(coefs @ x[cols])) / aij
        return x

    def restore_duals(self, sf, y_reduced, rc_reduced, x_full=None):
        """Full-space (y, reduced costs) from the reduced solve's duals.

        Pass 1 — defaults: every eliminated substitution row takes
        y_i = c_j / a_ij (c_j at elimination time).  With the c-fold
        c_k -= c_j a_ik / a_ij this makes row i's contribution a_ik y_i
        equal the fold delta, so by telescoping the kept columns' reduced
        costs EQUAL the reduced solve's and every substituted column's
        rc is exactly 0.  Rule-3/4 rows (redundant / handled by a fixed
        variable) take y_i = 0.  Eliminated columns' reduced costs are
        recomputed from the original data as c_j - (A'y)_j.

        Pass 2 — bound-transfer corrections (needs ``x_full``, the
        :meth:`restore`-d primal): when the reduced solve pins x_k at a
        TRANSFERRED doubleton bound strictly inside x_k's original box,
        the surplus rc_k = delta belongs to the substituted column, not
        to x_k (the binding constraint is really x_j at its bound) —
        under the defaults the restored duals would violate
        complementarity (rc_k != 0 at an interior x_k) and
        b'y + l'z - u'w would miss c'x.  The correction shifts it:
        y_i += delta / a_ik, which zeroes rc_k and puts
        rc_j = -a_ij delta / a_ik on the at-bound x_j.  Steps replay
        LATEST FIRST with incremental rc updates, so transfer chains
        (x_j itself at a bound transferred from an even earlier
        doubleton) cascade the surplus to the row that really binds.
        Without ``x_full`` the defaults-only result is returned
        (correct whenever no transferred bound is binding).
        """
        y = np.zeros(sf.ncons, dtype=np.float64)
        y[self.kept_rows] = np.asarray(y_reduced, np.float64)[
            : len(self.kept_rows)
        ]
        for step in self.steps:
            if step[0] == "doubleton":
                _, _j, _k, i, aij, *_rest, cj = step
                y[i] = cj / aij
            elif step[0] == "freecol":
                _, _j, i, aij, _bi, _cols, _coefs, cj = step
                y[i] = cj / aij
        rc = np.asarray(sf.c, np.float64).copy()
        np.subtract.at(
            rc, np.asarray(sf.a_cols),
            np.asarray(sf.a_vals) * y[np.asarray(sf.a_rows)],
        )
        rc[self.kept_cols] = np.asarray(rc_reduced, np.float64)[
            : len(self.kept_cols)
        ]
        # Forcing rows (rule 8), latest first: every pinned column gives
        # the SAME inequality direction on y_i (at-lower needs
        # rc_j - a_ij y_i >= 0 with a_ij > 0, at-upper needs <= 0 with
        # a_ij < 0 — both say y_i <= rc_j/a_ij for Lmin-forcing, >= for
        # Lmax), so the extreme ratio restores exact sign-correct
        # complementarity.  rc of every original column in row i (all
        # eliminated — a forcing row pins its whole live support, and
        # earlier-dead columns stay dead) updates incrementally so
        # chained forcing rows cascade correctly.
        if any(s[0] == "forcing" for s in self.steps):
            import scipy.sparse as sp

            A0 = sp.csr_matrix(
                (np.asarray(sf.a_vals), (np.asarray(sf.a_rows),
                                         np.asarray(sf.a_cols))),
                shape=(sf.ncons, sf.nvars),
            )
            A0.sum_duplicates()
            for step in reversed(self.steps):
                if step[0] != "forcing":
                    continue
                _, i, cols_p, vals_p, side = step
                ratios = rc[cols_p] / vals_p
                y[i] = float(ratios.max() if side > 0 else ratios.min())
                sl0 = slice(A0.indptr[i], A0.indptr[i + 1])
                rc[A0.indices[sl0]] -= A0.data[sl0] * y[i]
        if x_full is None:
            return y, rc
        x = np.asarray(x_full, np.float64)
        l0 = np.asarray(sf.l, np.float64)
        u0 = np.asarray(sf.u, np.float64)
        inf_b = 1e29  # the standard-form +/-1e30 infinity encoding

        def at_bound(v, bnd):
            return abs(bnd) < inf_b and abs(v - bnd) <= 1e-6 * (1.0 + abs(bnd))

        for step in reversed(self.steps):
            if step[0] != "doubleton":
                continue  # freecol: x_j free => rc_j = 0 is forced; no shift
            _, j, k, i, aij, aik, _bi, lj, uj, _cj = step
            delta = rc[k]
            if delta == 0.0:
                continue
            j_pinned = at_bound(x[j], lj) or at_bound(x[j], uj)
            k_interior = (
                (l0[k] <= -inf_b or x[k] > l0[k] + 1e-6 * (1.0 + abs(l0[k])))
                and (u0[k] >= inf_b or x[k] < u0[k] - 1e-6 * (1.0 + abs(u0[k])))
            )
            if j_pinned and k_interior:
                y[i] += delta / aik
                rc[k] = 0.0
                rc[j] -= aij * delta / aik
        return y, rc

    def report(self) -> str:
        nk, nr = len(self.kept_cols), len(self.kept_rows)
        return (
            f"presolve: {self.status}; cols {self.nvars_full} -> {nk}, "
            f"rows eliminated down to {nr}"
        )


def presolve(
    sf: StandardForm, tol: float = 1e-11
) -> tuple[StandardForm, Presolve]:
    """Apply the safe reductions to fixpoint.  Returns (reduced_sf, info);
    ``reduced_sf`` is a NEW StandardForm over the kept rows/columns (the
    input is not modified).  When ``info.status != "reduced"`` the returned
    StandardForm is the leftover problem state and should not be solved."""
    import scipy.sparse as sp

    n, m = sf.nvars, sf.ncons
    A = sp.csc_matrix(
        (sf.a_vals, (sf.a_rows, sf.a_cols)), shape=(m, n)
    )
    A.sum_duplicates()
    A.eliminate_zeros()
    l = sf.l.copy()
    u = sf.u.copy()
    c = sf.c.copy()
    b = sf.b.copy()
    col_alive = np.ones(n, dtype=bool)
    row_alive = np.ones(m, dtype=bool)
    fixed_vals = np.zeros(n, dtype=np.float64)
    steps: list = []
    obj_acc = 0.0  # incremental: folds change c, so c@fixed_vals is wrong

    def fail(status, detail):
        kept_cols = np.flatnonzero(col_alive)
        kept_rows = np.flatnonzero(row_alive)
        info = Presolve(
            status=status, nvars_full=n, kept_cols=kept_cols,
            kept_rows=kept_rows, fixed_vals=fixed_vals, detail=detail,
            obj_offset=obj_acc, steps=steps,
        )
        return _subset(sf, A, b, c, l, u, kept_rows, kept_cols), info

    if np.any(l > u + tol):
        j = int(np.argmax(l - u))
        return fail("infeasible", f"bounds cross at column {j}")

    def fix_column(j, val):
        """Substitute x_j = val: b -= A[:, j] * val, kill the column."""
        nonlocal obj_acc
        obj_acc += float(c[j]) * val
        fixed_vals[j] = val
        col_alive[j] = False
        sl = slice(A.indptr[j], A.indptr[j + 1])
        rows_j = A.indices[sl]
        b[rows_j] -= A.data[sl] * val
        A.data[sl] = 0.0

    def kill_row(i):
        """Drop row i entirely (zero its remaining live entries)."""
        row_alive[i] = False
        A.data[A.indices == i] = 0.0
        b[i] = 0.0

    changed = True
    while changed:
        changed = False
        # Rule 2: fixed columns.
        scale = 1.0 + np.abs(l)
        fixable = col_alive & np.isfinite(l) & (u - l <= tol * scale)
        for j in np.flatnonzero(fixable):
            fix_column(j, 0.5 * (l[j] + u[j]))
            changed = True

        # Row occupancy over live entries.
        Ac = sp.csc_matrix(A)  # data zeroed for dead cols
        Ac.eliminate_zeros()
        Ar = Ac.tocsr()
        row_nnz = np.diff(Ar.indptr)

        # Rule 3: empty rows.
        empty = row_alive & (row_nnz == 0)
        for i in np.flatnonzero(empty):
            if abs(b[i]) > 1e-7 * (1.0 + np.abs(sf.b[i])):
                return fail("infeasible", f"empty row {i} with b={b[i]:.3e}")
            row_alive[i] = False
            changed = True

        # Rule 4: singleton rows.
        singles = row_alive & (row_nnz == 1)
        for i in np.flatnonzero(singles):
            sl_ = slice(Ar.indptr[i], Ar.indptr[i + 1])
            j = int(Ar.indices[sl_][0])
            aij = float(Ar.data[sl_][0])
            if not col_alive[j]:
                continue  # stale occupancy; next sweep re-derives
            # Pivot-magnitude guard (advisor r2): a tiny a_ij amplifies
            # b_i/a_ij, and the value-scaled acceptance width would then
            # accept a numerically dubious fix.  Leave the row to the
            # solver instead.
            row_scale = max(np.max(np.abs(Ar.data[sl_])), abs(b[i]), 1.0)
            if abs(aij) < 1e-10 * row_scale:
                continue
            val = b[i] / aij
            width = 1e-7 * (1.0 + abs(val))
            if val < l[j] - width or val > u[j] + width:
                return fail(
                    "infeasible",
                    f"singleton row {i} forces x[{j}]={val:.6g} outside "
                    f"[{l[j]:.6g}, {u[j]:.6g}]",
                )
            row_alive[i] = False
            fix_column(j, float(np.clip(val, l[j], u[j])))
            changed = True

        # Rule 5: empty columns (objective-only variables).
        Ac = sp.csc_matrix(A)
        Ac.eliminate_zeros()
        col_nnz = np.diff(Ac.indptr)
        for j in np.flatnonzero(col_alive & (col_nnz == 0)):
            if c[j] > 0:
                if not np.isfinite(l[j]):
                    return fail("unbounded", f"objective column {j} has no lower bound")
                val = l[j]
            elif c[j] < 0:
                if not np.isfinite(u[j]):
                    return fail("unbounded", f"objective column {j} has no upper bound")
                val = u[j]
            else:
                val = float(np.clip(0.0, l[j], u[j]))
            fix_column(j, val)
            changed = True

        # Occupancy for the column-singleton rules (6, 7).
        Ac = sp.csc_matrix(A)
        Ac.eliminate_zeros()
        col_nnz = np.diff(Ac.indptr)
        Ar = Ac.tocsr()
        row_nnz = np.diff(Ar.indptr)
        inf_b = 1e29  # the standard-form +/-1e30 infinity encoding

        for j in np.flatnonzero(col_alive & (col_nnz == 1)):
            if not col_alive[j]:
                continue
            slc = slice(Ac.indptr[j], Ac.indptr[j + 1])
            i = int(Ac.indices[slc][0])
            aij = float(Ac.data[slc][0])
            if not row_alive[i]:
                continue
            rs = slice(Ar.indptr[i], Ar.indptr[i + 1])
            row_cols = Ar.indices[rs]
            row_vals = Ar.data[rs]
            live = col_alive[row_cols]
            scale = max(np.max(np.abs(row_vals[live])), abs(b[i]), 1.0)
            if abs(aij) < 1e-10 * scale:
                continue  # pivot guard, as in rule 4

            free_j = l[j] < -inf_b and u[j] > inf_b
            if free_j:
                # Rule 6: free column singleton — row i is satisfiable by
                # x_j alone; fold c_j, drop row i and column j.
                others = [
                    (int(k), float(v))
                    for k, v in zip(row_cols, row_vals)
                    if k != j and col_alive[k]
                ]
                cj = float(c[j])
                for k, v in others:
                    c[k] -= cj * v / aij
                obj_acc += cj * float(b[i]) / aij
                cols = np.asarray([k for k, _ in others], np.int64)
                coefs = np.asarray([v for _, v in others], np.float64)
                steps.append(("freecol", j, i, aij, float(b[i]), cols,
                              coefs, cj))
                col_alive[j] = False
                A.data[slice(A.indptr[j], A.indptr[j + 1])] = 0.0
                kill_row(i)
                changed = True
                continue

            if row_nnz[i] == 2 and np.sum(live) == 2:
                # Rule 7: doubleton equation with a column singleton —
                # substitute x_j = (b_i - a_ik x_k) / a_ij (no fill: x_j
                # lives only in row i), transfer x_j's bounds to x_k.
                (k,) = [int(kk) for kk in row_cols if kk != j and col_alive[kk]]
                aik = float(row_vals[list(row_cols).index(k)])
                if abs(aik) < 1e-10 * scale:
                    continue
                # An infinite x_j bound transfers an INFINITE endpoint
                # (x_k -> -sign(aij/aik)*inf as x_j -> +inf) — computing it
                # from the +/-1e30 sentinel instead fabricates a ~1e28
                # "finite" bound on x_k (never binding thanks to the pivot
                # guard, but semantically wrong).
                r = aij / aik
                t1 = ((-1e30 if r > 0 else 1e30) if u[j] > inf_b
                      else (float(b[i]) - aij * u[j]) / aik)
                t2 = ((1e30 if r > 0 else -1e30) if l[j] < -inf_b
                      else (float(b[i]) - aij * l[j]) / aik)
                klo, khi = (t1, t2) if t1 <= t2 else (t2, t1)
                new_l = max(l[k], np.clip(klo, -1e30, 1e30))
                new_u = min(u[k], np.clip(khi, -1e30, 1e30))
                width = 1e-7 * (1.0 + max(abs(new_l), abs(new_u)))
                if new_l > new_u + width:
                    return fail(
                        "infeasible",
                        f"doubleton row {i} forces x[{k}] into the empty "
                        f"interval [{new_l:.6g}, {new_u:.6g}]",
                    )
                l[k], u[k] = new_l, max(new_u, new_l)
                cj = float(c[j])
                c[k] -= cj * aik / aij
                obj_acc += cj * float(b[i]) / aij
                steps.append(("doubleton", j, k, i, aij, aik, float(b[i]),
                              float(l[j]), float(u[j]), cj))
                col_alive[j] = False
                A.data[slice(A.indptr[j], A.indptr[j + 1])] = 0.0
                kill_row(i)
                changed = True

        # Rule 8: row activity bounds — infeasibility + forcing rows.
        Ac = sp.csc_matrix(A)
        Ac.eliminate_zeros()
        Ar = Ac.tocsr()
        for i in np.flatnonzero(row_alive):
            sl_ = slice(Ar.indptr[i], Ar.indptr[i + 1])
            cols_i = Ar.indices[sl_]
            vals_i = Ar.data[sl_]
            live = col_alive[cols_i]
            cols_i, vals_i = cols_i[live], vals_i[live]
            if cols_i.size == 0:
                continue  # rule 3 handles it next sweep
            lo_c = np.where(vals_i > 0, l[cols_i], u[cols_i])
            hi_c = np.where(vals_i > 0, u[cols_i], l[cols_i])
            lo_fin = np.isfinite(lo_c) & (np.abs(lo_c) < inf_b)
            hi_fin = np.isfinite(hi_c) & (np.abs(hi_c) < inf_b)
            Lmin = float(vals_i @ np.where(lo_fin, lo_c, 0.0)) if lo_fin.all() else -np.inf
            Lmax = float(vals_i @ np.where(hi_fin, hi_c, 0.0)) if hi_fin.all() else np.inf
            mag = float(
                np.abs(vals_i) @ np.maximum(
                    np.abs(np.where(lo_fin, lo_c, 0.0)),
                    np.abs(np.where(hi_fin, hi_c, 0.0)),
                )
            )
            feas_wid = 1e-7 * (1.0 + abs(b[i]) + mag)
            if b[i] > Lmax + feas_wid or b[i] < Lmin - feas_wid:
                return fail(
                    "infeasible",
                    f"row {i} activity in [{Lmin:.6g}, {Lmax:.6g}] cannot "
                    f"reach b={b[i]:.6g}",
                )
            # Forcing acceptance: tight tolerance (a wrong accept pins
            # columns), and a pivot guard against tiny entries whose
            # rc/a ratios would blow up in the dual postsolve.
            force_wid = 1e-9 * (1.0 + abs(b[i]) + mag)
            if np.min(np.abs(vals_i)) < 1e-10 * (1.0 + np.max(np.abs(vals_i))):
                continue
            if np.isfinite(Lmax) and b[i] >= Lmax - force_wid and Lmax - Lmin > force_wid:
                pin = hi_c
                side = 1
            elif np.isfinite(Lmin) and b[i] <= Lmin + force_wid and Lmax - Lmin > force_wid:
                pin = lo_c
                side = -1
            else:
                continue
            steps.append(("forcing", int(i), cols_i.copy(),
                          vals_i.copy(), side))
            for j, v in zip(cols_i, pin):
                fix_column(int(j), float(v))
            kill_row(i)
            changed = True

    kept_cols = np.flatnonzero(col_alive)
    kept_rows = np.flatnonzero(row_alive)
    status = "solved" if len(kept_cols) == 0 else "reduced"
    info = Presolve(
        status=status, nvars_full=n, kept_cols=kept_cols,
        kept_rows=kept_rows, fixed_vals=fixed_vals,
        obj_offset=obj_acc, steps=steps,
    )
    return _subset(sf, A, b, c, l, u, kept_rows, kept_cols), info


def _subset(sf, A, b, c, l, u, kept_rows, kept_cols) -> StandardForm:
    """Build the reduced StandardForm over (kept_rows, kept_cols)."""
    import scipy.sparse as sp

    Ared = sp.csc_matrix(A)
    Ared.eliminate_zeros()
    Ared = Ared[kept_rows][:, kept_cols].tocoo()
    n_orig_kept = int(np.sum(kept_cols < sf.initial_vars))
    return StandardForm(
        nvars=len(kept_cols),
        ncons=len(kept_rows),
        c=c[kept_cols],
        a_rows=Ared.row.astype(np.int32),
        a_cols=Ared.col.astype(np.int32),
        a_vals=Ared.data.astype(np.float64),
        b=b[kept_rows],
        row_type=sf.row_type[kept_rows],
        l=l[kept_cols],
        u=u[kept_cols],
        initial_vars=n_orig_kept,
        obj_sign=sf.obj_sign,
    )
