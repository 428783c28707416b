"""Panel-wave tiled sparse Cholesky: the fully sparse normal-equations engine.

Counterpart of ``cholesky_is_magic_tpu/sparse/tiled.py`` for the fully
sparse path (``engine_for_sparse`` + ``prepare_normal_ell``): analyse once
on the host, then per factorization

    assemble the resident (b, b) tiles of P·A·D²·Aᵀ·Pᵀ from the sorted
      pair schedule                                   (one kernel, K4)
    per 128-column panel:
      chol + tri-inv of the diagonal tile             (one kernel, K1)
      all the panel's TRSMs:  (R, b, b) x (b, b)      (one batched matmul)
      all the panel's SYRKs:  L[dst] -= L[a]·L[b]ᵀ    (one kernel in place;
                                                       off the card one
                                                       batched matmul + one
                                                       index_add_)

Storage is a compact (NT+1, b, b) tile array (row NT is a dummy target of
the padded schedules), so memory follows nnz(L) tiles, not m².  Both
triangular solves run one gather and one batched matvec per panel, using
the stored tile inverses.

Where the JAX package runs ``lax.fori_loop``s over the panels, the port
runs host loops over device tensors.  The per-panel index arrays are kept
on the device padded, as in the JAX package; the host knows each panel's
true length and slices to it, so no padded entry is ever computed and the
dummy row is never written.  The TRSM products and the solves are
``torch.matmul`` (XLA einsums outside any Pallas kernel in the JAX
package); the tile factor, the assembly and the Schur updates are the
hand-written kernels on float32 CUDA tensors (:mod:`..ops.chol_cuda`,
:mod:`.tiled_cuda`) and their plain versions on a CPU tensor or in another
dtype on the card (the SYRKs as ``torch.matmul`` + ``index_add_``, as the
JAX package's einsum + scatter-add).  ``ok`` is read on the host once per
factorization, and only when the dbound retry is armed.

The engine also runs inside a lane of a batched solve (``parallel.batched``
vmaps the solvers with ``torch.func.vmap``; the lanes share A and so the
engine, and differ in their scalings).  There (``per_lane``) the kernels
are reached through operators (``cim::assemble_pairs`` here,
``cim::factor_tile`` in :mod:`..ops.chol`, ``cim::tile_schur`` in
:mod:`.tiled_cuda`) whose vmap rules launch one batched kernel for all the
lanes (the plain forms with a lane axis off the card), and the dbound retry
and the Krylov gate become per-lane selects with no host read, as
``lax.cond`` becomes under ``jax.vmap``.

The dense-A entry points (:func:`engine_for`, :meth:`TiledCholesky.assemble`,
``prepare_normal``, ``solve_normal``) take a dense (padded) A instead of
the pair schedule: the tiles of P·A·D²·Aᵀ·Pᵀ come from ``torch.matmul``
over row blocks of the permuted, scaled A (XLA matmuls in the JAX package
too), put in tile order by one gather, then the same panel loop (K1 per
panel on the card) and solves, and the refinement residuals run against the
unassembled operator through the double-word A·x and Aᵀ·x (the dd kernels
on the card).  They run inside a lane too (``per_lane``: a batch of dense
states whose lanes share A's pattern, each assembling from its own A).

The mesh (tensor-parallel) mode of the fully sparse path
(``prepare_normal_ell(mesh=...)``, JAX ``sparse/tiled.py:541-706``): every
rank of the mesh's 'tp' group assembles its contiguous slab of the sorted
pair schedule (K4 on the card, over a schedule of the slab's runs) and one
all-reduce sums the slabs' tiles; in the panel loop each rank computes its
share of the panel's SYRK pairs and one all-reduce per panel carries the
Schur updates; the tile factor (K1), the TRSMs, the triangular solves and
the refinement stay replicated.
"""

from __future__ import annotations

import functools
import itertools
import weakref
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from cholesky_is_magic_tpu_torch.ops import chol
from cholesky_is_magic_tpu_torch.ops import dd as ddm
from cholesky_is_magic_tpu_torch.ops import dense as dense_ops
from cholesky_is_magic_tpu_torch.ops import krylov, normal
from cholesky_is_magic_tpu_torch.ops.cuda_build import takes_kernel
from cholesky_is_magic_tpu_torch.sparse import tiled_cuda
from cholesky_is_magic_tpu_torch.sparse.symbolic import FactorPlan
from cholesky_is_magic_tpu_torch.utils.spans import count, span


def _pad2(lists, fill):
    width = max((len(x) for x in lists), default=0)
    width = max(width, 1)
    out = np.full((len(lists), width), fill, dtype=np.int64)
    for r, x in enumerate(lists):
        out[r, : len(x)] = x
    return out


def engine_for_sparse(A_host, block: int = 128, snode_align: bool = True,
                      dtype=None, device="cuda") -> "TiledCholesky":
    """Analyse-once engine on ``device`` with the O(nnz) pair schedule
    attached: the fully sparse entry point, no dense A anywhere.
    ``A_host`` is anything scipy.sparse converts to CSC."""
    import scipy.sparse as sp

    from cholesky_is_magic_tpu_torch.sparse.symbolic import analyze

    with span("setup.analysis"):
        A_csc = sp.csc_matrix(A_host)
        eng = TiledCholesky(analyze(A_csc, block=block), snode_align=snode_align,
                            device=device)
        eng.build_ell_assembly(A_csc, dtype=dtype or torch.float32)
        return eng


def engine_for(A, block: int = 128, snode_align: bool = True,
               device="cuda") -> "TiledCholesky":
    """Analyse-once engine on ``device`` for a (possibly padded) dense A, a
    tensor or an array: the entry point solvers take as
    ``pdas(..., engine=...)`` on a dense state.  Zero (padded) rows
    contribute only their boosted diagonal; the symbolic analysis sees them
    as isolated vertices."""
    import scipy.sparse as sp

    from cholesky_is_magic_tpu_torch.sparse.symbolic import analyze

    if isinstance(A, torch.Tensor):
        A = A.detach().cpu().double().numpy()
    A_host = sp.csc_matrix(np.asarray(A, np.float64))
    return TiledCholesky(analyze(A_host, block=block), snode_align=snode_align,
                         device=device)


class TiledCholesky:
    """Analyse-once tile engine for one sparsity pattern (the
    cholmod_analyze / cholmod_factorize split, affine-scaling.lisp:271)."""

    def __init__(self, plan: FactorPlan, snode_align: bool = True,
                 device="cuda"):
        self.plan = plan
        self.device = torch.device(device)
        b = plan.block
        aligned = snode_align and plan.slots is not None
        self.snode_align = aligned
        if aligned:
            # Supernode-aligned layout: panels hold whole supernodes; gap
            # slots are inert padding rows (zero rows, boosted unit
            # diagonal, exactly like end-padding).
            B = plan.slot_mask.shape[0]
            mask = plan.slot_mask | np.eye(B, dtype=bool)
        else:
            B = plan.block_mask.shape[0]
            mask = plan.block_mask | np.eye(B, dtype=bool)
        mask &= np.tril(np.ones((B, B), dtype=bool))
        # The resident set is the etree-exact elementwise block mask: a SYRK
        # pair whose destination is not resident contributes exact zeros
        # (fill-path theorem), so it is dropped (see the JAX package).
        self.mask = mask

        tiles = [(int(i), int(j)) for i in range(B) for j in range(B) if mask[i, j]]
        tid = {t: k for k, t in enumerate(tiles)}
        self.tiles = tiles
        self.NT = len(tiles)
        self.B = B
        self.b = b
        DUMMY = self.NT  # padded gathers/scatters address this extra tile row

        diag_ids, rows_ids, rows_i = [], [], []
        syrk_a, syrk_b, syrk_dst = [], [], []
        fwd_ids, fwd_j = [], []
        self.dropped_updates = 0  # provably-zero SYRK pairs skipped
        for k in range(B):
            diag_ids.append(tid[(k, k)])
            rows = [i for i in range(k + 1, B) if mask[i, k]]
            rows_ids.append([tid[(i, k)] for i in rows])
            rows_i.append(rows)
            pa, pb, pd = [], [], []
            for ii, i in enumerate(rows):
                for j in rows[: ii + 1]:
                    dst = (max(i, j), min(i, j))
                    if not mask[dst]:
                        self.dropped_updates += 1
                        continue
                    pa.append(tid[(i, k)])
                    pb.append(tid[(j, k)])
                    pd.append(tid[dst])
            syrk_a.append(pa); syrk_b.append(pb); syrk_dst.append(pd)
            fwd = [(tid[(k, j)], j) for j in range(k) if mask[k, j]]
            fwd_ids.append([t for t, _ in fwd])
            fwd_j.append([j for _, j in fwd])

        # Each panel's true list lengths, known on the host.
        self._n_rows = [len(x) for x in rows_ids]
        self._n_syrk = [len(x) for x in syrk_dst]
        self._n_fwd = [len(x) for x in fwd_ids]
        self._trsm_tiles, self._schur_products = sum(self._n_rows), sum(self._n_syrk)
        self._diag_ids_np = np.asarray(diag_ids, np.int64)

        put = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=self.device)  # noqa: E731
        self.diag_ids = put(diag_ids)
        self.rows_ids = put(_pad2(rows_ids, DUMMY))
        self.rows_i = put(_pad2(rows_i, B))  # B = the dummy row of y
        self.syrk_a = put(_pad2(syrk_a, DUMMY))
        self.syrk_b = put(_pad2(syrk_b, DUMMY))
        self.syrk_dst = put(_pad2(syrk_dst, DUMMY))
        self.fwd_ids = put(_pad2(fwd_ids, DUMMY))
        self.fwd_j = put(_pad2(fwd_j, B))
        diag_panel = np.full(self.NT + 1, -1, np.int64)
        diag_panel[diag_ids] = np.arange(B)
        self.diag_panel = put(diag_panel)  # tile -> its panel, or -1
        # The dense-A assembly's tables, kept on the host (the per-panel
        # index lists built from them go to the device at first assemble):
        # each tile's (row, column) tile, and per column panel j the
        # contiguous row-tile window [lo_j, hi_j] covering its resident
        # tiles with the destination tile of each window row (DUMMY where
        # not resident).
        self.tile_i = np.asarray([t[0] for t in tiles] + [0], np.int64)
        self.tile_j = np.asarray([t[1] for t in tiles] + [0], np.int64)
        asm_lo, asm_dst = [], []
        for j in range(B):
            rows = [i for i in range(j, B) if mask[i, j] or i == j]
            lo, hi = min(rows), max(rows)
            asm_lo.append(lo)
            rowset = set(rows)
            asm_dst.append([tid[(lo + r, j)] if (lo + r) in rowset else DUMMY
                            for r in range(hi - lo + 1)])
        self.Rmax_asm = max(len(x) for x in asm_dst)
        self.asm_lo = np.asarray(asm_lo, np.int64)
        self.asm_dst = _pad2(asm_dst, DUMMY)
        self._panels = None
        # Relative matmul cost of the two assembly modes (units of b·b·n):
        # range mode computes B full windows, scan mode exactly NT tiles.
        self.range_cost = B * self.Rmax_asm
        self.scan_cost = self.NT
        self.assemble_mode = "auto"  # per-engine override ("scan"/"range")

        n_pad = B * b
        if aligned:
            # Slot s holds permuted column j when slots[j] == s; gap slots
            # map to the (zero, boosted) padding rows plan.n .. n_pad-1.
            pperm = np.empty(n_pad, dtype=np.int64)
            used = np.zeros(n_pad, dtype=bool)
            pperm[plan.slots] = plan.perm
            used[plan.slots] = True
            pperm[~used] = np.arange(plan.n, n_pad)
        else:
            pperm = np.arange(n_pad)
            pperm[: plan.n] = plan.perm
        slot_of = np.empty(n_pad, np.int64)
        slot_of[pperm] = np.arange(n_pad)
        self._slot_of_np = slot_of
        self.pperm = put(pperm)
        self.slot_of = put(slot_of)  # row -> its slot

    # ---- pair-schedule assembly -----------------------------------------

    def build_ell_assembly(self, A_host, dtype=None):
        """Host-side pair schedule for O(nnz) assembly (assemble_pairs).

        N[p, q] = Σ_k A[p,k]·A[q,k]·d_k²: for every column k and every row
        pair (p, q) sharing it, emit (weight A[p,k]·A[q,k], k, flat
        destination in the compact tile array), mirrored inside diagonal
        tiles, sorted by destination.  The enumeration runs in C++ when
        native/symbolic.cpp is available, with this Python loop as the
        fallback.  The run offsets of equal destinations are recorded
        too."""
        import scipy.sparse as sp

        from cholesky_is_magic_tpu_torch.sparse import native

        if dtype is None:
            dtype = torch.float32
        A_csc = sp.csc_matrix(A_host)
        A_csc.sort_indices()
        b, B = self.b, self.B
        slot_of = self._slot_of_np
        tilemap = np.full((B, B), -1, np.int64)
        for t, (i, j) in enumerate(self.tiles):
            tilemap[i, j] = t
        sched = native.pair_schedule(A_csc, slot_of, b, tilemap)
        if sched is not None:
            ws, ks, dst = sched
        else:
            ws, ks, dst = [], [], []
            for k in range(A_csc.shape[1]):
                lo, hi = A_csc.indptr[k], A_csc.indptr[k + 1]
                rows = A_csc.indices[lo:hi]
                vals = A_csc.data[lo:hi]
                slots = slot_of[rows]
                for a in range(len(rows)):
                    for c in range(a + 1):
                        sa, sc = int(slots[a]), int(slots[c])
                        shi, slo_ = (sa, sc) if sa >= sc else (sc, sa)
                        t = tilemap[shi // b, slo_ // b]
                        if t < 0:
                            raise AssertionError(
                                "N entry outside the resident tile set")
                        w = vals[a] * vals[c]
                        ws.append(w)
                        ks.append(k)
                        dst.append(t * b * b + (shi % b) * b + (slo_ % b))
                        if shi != slo_ and shi // b == slo_ // b:
                            # The tile factor may read the whole tile:
                            # mirror off-diagonals inside diagonal tiles.
                            ws.append(w)
                            ks.append(k)
                            dst.append(t * b * b + (slo_ % b) * b + (shi % b))
        ws = np.asarray(ws, np.float64)
        ks = np.asarray(ks, np.int64)
        dst = np.asarray(dst, np.int64)
        order = np.argsort(dst, kind="stable")
        dst = dst[order]
        put = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        self.asm_w = put(ws[order]).to(dtype)
        self.asm_k = put(ks[order])
        self.asm_dst_flat = put(dst)
        self.n_pairs = len(ws)
        run_start, run_dst, by_rank, self._asm_passes = _runs_and_passes(dst)
        self._asm_dst_np, self._run_start_np, self._run_dst_np = dst, run_start, run_dst
        self.asm_run_start = put(run_start)
        self.asm_run_dst = put(run_dst)
        self.asm_pass_pos = put(by_rank)
        self.asm_pass_dst = put(dst[by_rank])
        self._slabs = {}  # (ntp, rank) -> _Slab, the mesh mode's schedules
        self.op_key = next(_KEYS)
        _ENGINES[self.op_key] = self
        # The assembly kernel's 32-bit view of this schedule, where
        # assemble_pairs will launch it.
        self._kernel_schedule = None
        if takes_kernel(self.device, dtype):
            self._kernel_schedule = tiled_cuda.kernel_schedule(
                self, run_start, run_dst)

    def assemble_pairs(self, d, row_boost=None, per_lane: bool = False):
        """Resident tiles of P(A·D)(A·D)ᵀPᵀ from the pair schedule, plus the
        boosted unit diagonal of padded and gap slots (and ``row_boost`` on
        the first len(row_boost) rows): the hand-written kernel on float32
        CUDA tensors, :meth:`_assemble_pairs_plain` on a CPU tensor or in
        another dtype on the card.  ``per_lane`` (a lane under
        ``torch.func.vmap``): through :func:`assemble_pairs_op`, one batched
        launch for all the lanes."""
        if row_boost is None:
            row_boost = torch.zeros(0, dtype=self.asm_w.dtype, device=d.device)
        with span("normal.assemble"):
            if per_lane:
                return assemble_pairs_op(d, row_boost, self.op_key)
            return _assemble_pairs(self, d, row_boost)

    def _assemble_pairs_plain(self, d, row_boost, slab=None):
        """The plain version: one gather of d², one multiply, the sorted sums,
        then the boost.  Leading axes of ``d`` (and of ``row_boost``, or
        none) are lanes: (..., n) gives (..., NT+1, b, b), each lane equal to
        the call on it alone.  The sums are one ``index_add_`` per
        occurrence rank (a pass adds every destination's r-th pair, so no
        destination appears twice in a pass): each entry adds its pairs one
        after the other in schedule order from zero, as the kernel does and
        as one sequential ``index_add_`` would, and on the card no order
        rests on atomics, so the result is the same run after run.
        ``slab`` (a :class:`_Slab` of the mesh mode): only its pairs, and the
        boost only where the slab carries it."""
        b = self.b
        dt = self.asm_w.dtype
        lead = d.shape[:-1]
        d2 = (d * d).to(dt)
        if slab is None:
            p0, p1, pos, pdst, passes, boost = (
                0, self.n_pairs, self.asm_pass_pos, self.asm_pass_dst,
                self._asm_passes, True)
        else:
            p0, p1, pos, pdst, passes, boost = slab[:6]
        vals = (self.asm_w[p0:p1] * d2[..., self.asm_k[p0:p1]]).reshape(
            int(np.prod(lead)), p1 - p0)
        flat = vals.new_zeros((vals.shape[0], (self.NT + 1) * b * b))
        for lo, hi in passes:
            flat.index_add_(1, pdst[lo:hi], vals[:, pos[lo:hi]])
        tiles = flat.reshape(*lead, self.NT + 1, b, b)
        tiles[..., self.NT, :, :] = 0.0
        if not boost:
            return tiles
        rb = F.pad(row_boost.to(dt), (0, self.B * b - row_boost.shape[-1]),
                   value=1.0)
        boost_p = rb[..., self.pperm].reshape(*rb.shape[:-1], self.B, b)
        eye = torch.eye(b, dtype=dt, device=d.device)
        tiles[..., self.diag_ids, :, :] += eye * boost_p[..., :, :, None]
        return tiles

    # ---- dense-A assembly -----------------------------------------------

    def _prep_operands(self, A, d, row_boost):
        """Pad to the slot grid, permute, scale: (AD rows by slot, boost)."""
        n_pad = self.B * self.b
        m = A.shape[0]
        if m < n_pad:
            A = F.pad(A, (0, 0, 0, n_pad - m))
            if row_boost is None:
                row_boost = torch.zeros(m, dtype=A.dtype, device=A.device)
            row_boost = F.pad(row_boost, (0, n_pad - m), value=1.0)
        AD = A[self.pperm, :] * d[None, :]
        boost_p = row_boost[self.pperm] if row_boost is not None else None
        return AD, boost_p

    def _panel_lists(self):
        """Per column panel j: its window (lo, width), the window rows that
        hold a resident tile, and its resident row tiles (scan mode); the
        index lists on the device.  And per mode the gather that puts the
        panels' products, concatenated in panel order, in tile order (then
        the dummy tile): range mode's products are the window rows' tiles,
        scan mode's the resident tiles of the column, so each tile is one
        product exactly once either way."""
        if self._panels is None:
            put = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
            panels, rtiles, stiles = [], [], []
            for j in range(self.B):
                rows = np.flatnonzero(self.asm_dst[j] != self.NT)
                mine = np.flatnonzero(self.tile_j[:self.NT] == j)
                panels.append((int(self.asm_lo[j]), int(rows[-1]) + 1, put(rows),
                               put(self.tile_i[mine])))
                rtiles.append(self.asm_dst[j][rows])
                stiles.append(mine)
            order = {mode: put(np.append(np.argsort(np.concatenate(ids), kind="stable"),
                                         self.NT))
                     for mode, ids in (("range", rtiles), ("scan", stiles))}
            self._panels = panels, order
        return self._panels

    def assemble(self, A, d, row_boost=None, mode: str = "auto"):
        """Resident tiles of P(A·D)(A·D)ᵀPᵀ (+ the boost on the diagonal) as
        an (NT+1, b, b) tensor, from a dense A by ``torch.matmul``.

        - "scan": exactly the NT tile products, one batched matmul per
          column panel over its resident row tiles (the JAX package runs
          one tile per ``lax.scan`` step).  A batched matmul over all NT
          tiles at once would gather NT row blocks of AD (NT·b·n values:
          ~0.2 GB at the pilot LP in f32); per panel the gather holds one
          panel's row tiles at most, and the host issues B matmuls, not NT;
        - "range": one (w·b, n) x (n, b) matmul per column panel over the
          contiguous window of w row tiles that covers its resident ones
          (the JAX package pads every window to Rmax; its extra rows land
          in the dummy tile), the resident rows kept.  B matmuls;
          over-computes where a window is taller than its resident count.

        "auto" takes range when its cost (B·Rmax) is at most 1.2× scan's
        (NT), as in the JAX package.  Every resident tile is the product of
        the same two row blocks either way.  The panels' products are
        concatenated in panel order with a zero dummy tile and put in tile
        order by one gather (:meth:`_panel_lists`): no tile is written by
        index into a tensor made beforehand, so the assembly runs under
        ``torch.func.vmap`` as it runs alone, each lane from its own A."""
        if mode == "auto":
            mode = "range" if self.range_cost <= 1.2 * self.scan_cost else "scan"
        if mode not in ("range", "scan"):
            raise ValueError(f"assemble: unknown mode {mode!r}")
        b = self.b
        with span("normal.assemble"):
            AD, boost_p = self._prep_operands(A, d, row_boost)
            Ap = AD.reshape(self.B, b, -1)
            panels, order = self._panel_lists()
            parts = []
            for j, (lo, w, rows, srows) in enumerate(panels):
                if mode == "range":
                    G = torch.matmul(AD[lo * b:(lo + w) * b], Ap[j].T)
                    parts.append(G.reshape(w, b, b)[rows])
                else:
                    parts.append(torch.matmul(Ap[srows], Ap[j].T))
            tiles = torch.cat(parts + [AD.new_zeros((1, b, b))])[order[mode]]
            if boost_p is not None:
                eye = torch.eye(b, dtype=tiles.dtype, device=tiles.device)
                tiles[self.diag_ids] += eye * boost_p.reshape(self.B, b)[:, :, None]
            return tiles

    # ---- factor and solve -----------------------------------------------

    def factorize(self, tiles, per_lane: bool = False, mesh=None):
        """One host loop over the panels; per panel one tile factor +
        inverse, one batched TRSM, and the Schur update of the panel's SYRK
        pairs.  On float32 CUDA tiles that update is one launch of the
        hand-written kernel (:func:`.tiled_cuda.tile_schur`), in place on L,
        nothing gathered or scattered; otherwise (CPU tensors, another dtype,
        ``mesh``) one batched SYRK of the gathered tiles + one ``index_add_``.
        Leaves ``tiles`` as it is.  ``per_lane`` (a lane under
        ``torch.func.vmap``): the tile factor and the Schur kernel through
        their operators, one launch each for all the lanes.
        ``mesh``: each panel's SYRK batch shared over the mesh's 'tp' ranks,
        everything else replicated; each rank computes its contiguous share
        of the panel's Schur-update pairs into a zero buffer of all of them,
        and one all-reduce per panel sums the buffers before the one
        ``index_add_``.  A panel's pairs have distinct destinations, so each
        buffer entry is one rank's product plus zeros and the all-reduce
        adds nothing else: given the same tiles the factor is the single
        factorization's, up to how a rank's smaller batched matmul rounds
        (bit for bit at tp = 1).  Spans ``factorize.tile``,
        ``factorize.trsm`` and ``factorize.schur`` hold each panel's three
        steps; the counters add one lane's TRSM tiles and Schur-update tile
        products.  Returns (L_tiles, invdiag, ok)."""
        count("normal.factorizations")
        count("normal.trsm_tiles", self._trsm_tiles)
        count("normal.schur_products", self._schur_products)
        with span("normal.factorize"):
            b = self.b
            L = tiles.clone()
            invd = tiles.new_zeros((self.B, b, b))
            kernel = mesh is None and takes_kernel(L.device, L.dtype)
            if mesh is not None:
                import torch.distributed as dist

                group = mesh.get_group("tp")
                ntp, rank = dist.get_world_size(group), mesh.get_local_rank("tp")
            for k in range(self.B):
                with span("factorize.tile"):
                    chol.factor_tile_(L[int(self._diag_ids_np[k])], invd[k], per_lane)
                nr = self._n_rows[k]
                if nr:
                    with span("factorize.trsm"):
                        rid = self.rows_ids[k, :nr]
                        L[rid] = torch.matmul(L[rid], invd[k].T)
                ns = self._n_syrk[k]
                if ns and kernel:
                    with span("factorize.schur"):
                        tiled_cuda.tile_schur(L, self.syrk_a[k, :ns], self.syrk_b[k, :ns],
                                              self.syrk_dst[k, :ns], per_lane)
                elif ns:
                    with span("factorize.schur"):
                        lo, hi = 0, ns
                        if mesh is not None:
                            w = -(-ns // ntp)
                            lo, hi = min(rank * w, ns), min((rank + 1) * w, ns)
                        sa, sb = self.syrk_a[k, lo:hi], self.syrk_b[k, lo:hi]
                        U = torch.matmul(L[sa], L[sb].transpose(1, 2))
                        if mesh is not None:
                            U = F.pad(U, (0, 0, 0, 0, lo, ns - hi))
                            dist.all_reduce(U, group=group)
                        L.index_add_(0, self.syrk_dst[k, :ns], U, alpha=-1)
            diags = torch.diagonal(L[self.diag_ids], dim1=1, dim2=2)
            ok = torch.all(torch.isfinite(L)) & torch.all(diags > 0)
            return L, invd, ok

    def solve(self, tiles, invd, rhs):
        """Blocked forward and backward substitution with the stored tile
        inverses: one gather + one batched matvec per panel."""
        b, B = self.b, self.B
        r = rhs.reshape(B, b)
        y = invd.new_zeros((B + 1, b))
        for k in range(B):
            acc = r[k]
            nf = self._n_fwd[k]
            if nf:
                Ls = tiles[self.fwd_ids[k, :nf]]
                ys = y[self.fwd_j[k, :nf]]
                acc = acc - torch.matmul(Ls, ys[:, :, None]).sum(0)[:, 0]
            y[k] = invd[k] @ acc
        z = invd.new_zeros((B + 1, b))
        for k in range(B - 1, -1, -1):
            acc = y[k]
            nr = self._n_rows[k]
            if nr:
                Ls = tiles[self.rows_ids[k, :nr]]  # L[i, k] tiles
                zs = z[self.rows_i[k, :nr]]
                acc = acc - torch.matmul(zs[:, None, :], Ls).sum(0)[0]
            z[k] = invd[k].T @ acc
        return z[:B].reshape(B * b)

    def _factor(self, tiles, shift, per_lane: bool = False, mesh=None):
        """ops.normal.factor_with_retry's ``factor``: :meth:`factorize` of
        ``tiles``, or with ``shift`` (the dbound retry) of a copy with
        dbound·max(diag) added to the diagonal tiles.  ``mesh``: over its
        'tp' axis.  Returns ((L_tiles, invdiag), ok)."""
        if shift is not None:
            eye = torch.eye(self.b, dtype=tiles.dtype, device=tiles.device)
            diags = torch.diagonal(tiles[self.diag_ids], dim1=1, dim2=2)
            tiles = tiles.clone()
            tiles[self.diag_ids] += normal.jitter(shift, diags) * eye[None]
        L, invd, ok = self.factorize(tiles, per_lane, mesh)
        return (L, invd), ok

    def raw_solve(self, L, invd, r, m: int):
        """One unrefined solve of the factored N for ``r``, a right-hand
        side over the ``m`` original rows: padded, permuted, :meth:`solve`,
        and taken back to the original rows."""
        count("normal.solves")
        with span("normal.solve"):
            rp = F.pad(r, (0, self.B * self.b - m))[self.pperm]
            return self.solve(L, invd, rp)[self.slot_of[:m]]

    # ---- the mesh (tensor-parallel) mode --------------------------------

    def _slab(self, ntp: int, rank: int) -> "_Slab":
        """Rank ``rank``'s share of the sorted pair schedule over ``ntp``
        ranks, made once per (ntp, rank): the contiguous slab of
        ceil(pairs / ntp) pairs (the last ones shorter), its plain version's
        passes, and on a card in float32 the assembly kernel's schedule of
        the slab's runs (:func:`.tiled_cuda.kernel_schedule`; a run cut by a
        slab boundary keeps only the slab's pairs).  Rank 0 carries the
        boost; the other ranks' slabs leave every entry without a pair in
        the slab at zero."""
        key = (ntp, rank)
        if key not in self._slabs:
            w = -(-self.n_pairs // ntp)
            p0, p1 = min(rank * w, self.n_pairs), min((rank + 1) * w, self.n_pairs)
            _, _, by_rank, passes = _runs_and_passes(self._asm_dst_np[p0:p1])
            put = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
            kernel = None
            if self._kernel_schedule is not None:
                kernel = tiled_cuda.kernel_schedule(self, *self._slab_runs(p0, p1),
                                                    boost=rank == 0)
            self._slabs[key] = _Slab(
                p0, p1, put(by_rank), put(self._asm_dst_np[p0:p1][by_rank]),
                passes, rank == 0, kernel)
        return self._slabs[key]

    def _slab_runs(self, p0: int, p1: int):
        """The runs of the sorted pair schedule that meet pairs [p0, p1),
        cut to them: (run starts with the end appended, run destinations),
        what ``tiled_cuda.kernel_schedule`` takes."""
        if p1 == p0:
            return np.array([p0], np.int64), np.zeros(0, np.int64)
        rs = self._run_start_np
        s0 = int(np.searchsorted(rs[:-1], p0, "right")) - 1
        s1 = int(np.searchsorted(rs[:-1], p1, "left"))
        return np.clip(rs[s0:s1 + 1], p0, p1), self._run_dst_np[s0:s1]

    def assemble_pairs_tp(self, mesh, d, row_boost):
        """:meth:`assemble_pairs` over the mesh's 'tp' axis: each rank sums
        its slab of the pair schedule (:meth:`_slab`) into a whole tile
        array (K4 over the slab's schedule on float32 CUDA tensors, the
        plain version otherwise), and one all-reduce adds the ranks' arrays
        (``(NT+1)·b²`` values once per factorization).  Every entry's pairs
        lie in one slab, or in two neighbouring slabs where a slab boundary
        cuts its run: both ranks then hold a partial of that entry and the
        all-reduce adds the two, the only change of summation order against
        one rank (at tp = 1 the tiles are the single assembly's, bit for
        bit)."""
        import torch.distributed as dist

        group = mesh.get_group("tp")
        slab = self._slab(dist.get_world_size(group), mesh.get_local_rank("tp"))
        if takes_kernel(d.device, d.dtype, self.asm_w.dtype):
            tiles = tiled_cuda.assemble_pairs(self, d, row_boost, slab.kernel)
        else:
            tiles = self._assemble_pairs_plain(d, row_boost, slab)
        dist.all_reduce(tiles, group=group)
        return tiles

    # ---- the fully sparse normal equations ------------------------------

    def prepare_normal_ell(self, E, ET, d, m, row_boost=None, refine_steps=0,
                           dbound: float = 0.0, krylov_steps: int = 0,
                           krylov_gate=None, EB=None, ETB=None,
                           per_lane: bool = False, mesh=None):
        """Factor once, solve many, from sparse operands: pair-schedule
        assembly + planned tile factorization; each solve_fn(g) adds
        double-word refinement against the unassembled operator.  ``E`` /
        ``ET`` are the ELL forms of A and Aᵀ, ``EB`` / ``ETB`` (both or
        neither) the block-ELL forms the Richardson residuals then ride.
        ``krylov_steps`` > 0 switches refinement to flexible PCG with the
        tile factor as preconditioner, per call when ``krylov_gate`` (a
        0-dim bool tensor) is given.  ``m`` is the row count.
        ``per_lane``: a lane under ``torch.func.vmap`` (the dbound retry and
        the Krylov gate computed both ways and selected).  ``mesh`` (every
        rank of it makes the call; a ('dp', 'tp') DeviceMesh) assembles and
        factors over its 'tp' axis (:meth:`assemble_pairs_tp`,
        :meth:`factorize`); the triangular solves and the refinement stay
        replicated.  Returns (solve_fn, ok)."""
        from cholesky_is_magic_tpu_torch.ops import bell, sparse_ops

        boost = row_boost if row_boost is not None else torch.zeros(
            m, dtype=d.dtype, device=d.device)
        if mesh is not None:
            from cholesky_is_magic_tpu_torch.parallel.sharded import check_mesh

            check_mesh(mesh)
            if per_lane:
                raise ValueError("prepare_normal_ell: mesh= runs one lane per "
                                 "call (the dp batch splits the lanes)")
            tiles = self.assemble_pairs_tp(mesh, d, boost)
        else:
            tiles = self.assemble_pairs(d, boost, per_lane)
        (L, invd), ok = normal.factor_with_retry(
            functools.partial(self._factor, tiles, per_lane=per_lane, mesh=mesh),
            dbound, per_lane)
        d2 = ddm.two_prod(d, d) if refine_steps else None
        # Block-ELL dd products when both are carried, the ELL pair otherwise.
        prod, A, AT = ((bell, EB, ETB) if EB is not None and ETB is not None
                       else (sparse_ops, E, ET))

        def residual(y, g):
            u = ddm.dd_mul(prod.dd_matvec(AT, y), d2)  # d² ∘ Aᵀ y
            v = ddm.dd_add_w(prod.dd_matvec_dd(A, u), boost * y)
            return ddm.dd_add_w(ddm.dd_neg(v), g).to_working()

        pcg = (krylov.ell_normal_apply(E, ET, d, boost),
               functools.partial(krylov.ell_residual_dd, E, ET, d, row_boost=boost)
               ) if krylov_steps else None
        return normal.refined_solve(functools.partial(self.raw_solve, L, invd, m=m),
                                    residual, ok, refine_steps, krylov_steps,
                                    krylov_gate, pcg, per_lane), ok

    def solve_normal_ell(self, E, ET, d, g, row_boost=None, refine_steps=0,
                         dbound: float = 0.0, krylov_steps: int = 0,
                         EB=None, ETB=None, per_lane: bool = False, mesh=None):
        """(A·D)(A·D)ᵀ y = g entirely from sparse operands (see
        prepare_normal_ell).  Returns (y, ok)."""
        solve_fn, ok = self.prepare_normal_ell(
            E, ET, d, g.shape[0], row_boost=row_boost,
            refine_steps=refine_steps, dbound=dbound,
            krylov_steps=krylov_steps, EB=EB, ETB=ETB, per_lane=per_lane,
            mesh=mesh,
        )
        return solve_fn(g), ok

    # ---- the dense-A normal equations -----------------------------------

    def prepare_normal(self, A, d, row_boost=None, refine_steps=0,
                       dbound: float = 0.0, krylov_steps: int = 0,
                       krylov_gate=None, per_lane: bool = False):
        """Assemble and factor once from a dense A; returns (solve_fn, ok),
        the factor-once / solve-many split.  ``refine_steps`` adds
        double-word Richardson refinement against the UNASSEMBLED operator
        (ops.dense.operator_residual), so the f32 tile factor reaches the
        dense dd path's accuracy; ``krylov_steps`` > 0 switches to flexible
        PCG with the tile factor as preconditioner, per call when
        ``krylov_gate`` (a 0-dim bool tensor) is given.  ``ok`` is read on
        the host only when the dbound retry is armed.  ``per_lane`` (a lane
        of a batch of dense states under ``torch.func.vmap``, A the lane's
        own): the tile factor through its operator (one batched launch per
        panel for all the lanes), the retry and the gate selected per
        lane."""
        tiles = self.assemble(A, d, row_boost, mode=self.assemble_mode)
        (L, invd), ok = normal.factor_with_retry(
            functools.partial(self._factor, tiles, per_lane=per_lane), dbound, per_lane)
        AD = A * d[None, :] if (refine_steps or krylov_steps) else None
        residual, pcg = dense_ops.unassembled_operator(AD, row_boost)
        return normal.refined_solve(functools.partial(self.raw_solve, L, invd, m=A.shape[0]),
                                    residual, ok, refine_steps, krylov_steps,
                                    krylov_gate, pcg, per_lane), ok

    def solve_normal(self, A, d, g, row_boost=None, refine_steps=0,
                     dbound: float = 0.0, krylov_steps: int = 0):
        """Drop-in for ops.dense.solve_normal through the tile engine (see
        prepare_normal).  Returns (y, ok)."""
        solve_fn, ok = self.prepare_normal(
            A, d, row_boost=row_boost, refine_steps=refine_steps,
            dbound=dbound, krylov_steps=krylov_steps,
        )
        return solve_fn(g), ok


def _runs_and_passes(dst: np.ndarray):
    """For sorted flat destinations: (run_start, run_dst, by_rank, passes).
    The runs of equal destinations (their starts, with the end appended,
    and their destinations); and the plain assembly's order: a pair's rank
    in its run (its destination's occurrence), the pairs grouped by rank
    (``by_rank``), each group one pass (``passes``, its bounds in
    ``by_rank``), so that no scatter sees a destination twice (see
    ``TiledCholesky._assemble_pairs_plain``)."""
    run_dst, run_start = np.unique(dst, return_index=True)
    run_start = np.append(run_start, len(dst)).astype(np.int64)
    rank = np.arange(len(dst)) - np.repeat(run_start[:-1], np.diff(run_start))
    by_rank = np.argsort(rank, kind="stable")
    bounds = np.cumsum(np.bincount(rank)) if len(rank) else np.zeros(0, np.int64)
    passes = list(zip([0, *bounds[:-1].tolist()], bounds.tolist()))
    return run_start, run_dst.astype(np.int64), by_rank, passes


class _Slab(NamedTuple):
    """A rank's share of the pair schedule in the mesh mode
    (``TiledCholesky._slab``): pairs [p0, p1), the plain version's passes
    over them (positions in the slab, destinations, bounds), whether it
    carries the boost, and the kernel's schedule of its runs (or None)."""

    p0: int
    p1: int
    pass_pos: torch.Tensor
    pass_dst: torch.Tensor
    passes: list
    boost: bool
    kernel: object


# The engines the assembly operator can name: an operator takes tensors and
# numbers, so it names its engine by ``op_key``, given once per schedule.
_KEYS = itertools.count()
_ENGINES: "weakref.WeakValueDictionary[int, TiledCholesky]" = weakref.WeakValueDictionary()


def _assemble_pairs(eng, d, row_boost):
    """The engine's tiles: the kernel on float32 CUDA operands
    (:func:`.tiled_cuda.assemble_pairs`), the plain version otherwise."""
    if takes_kernel(d.device, d.dtype, eng.asm_w.dtype):
        return tiled_cuda.assemble_pairs(eng, d, row_boost)
    return eng._assemble_pairs_plain(d, row_boost)


@torch.library.custom_op("cim::assemble_pairs", mutates_args=())
def assemble_pairs_op(d: torch.Tensor, row_boost: torch.Tensor,
                      engine: int) -> torch.Tensor:
    """The (NT+1, b, b) tiles of engine ``engine`` (its ``op_key``) for the
    column scaling ``d`` (:func:`_assemble_pairs`).  Under
    ``torch.func.vmap`` one launch of
    :func:`.tiled_cuda.assemble_pairs_batched` for all the lanes (an
    unbatched ``row_boost`` shared at lane stride 0), or the plain version
    on the lane axis off the card."""
    return _assemble_pairs(_ENGINES[engine], d, row_boost)


@assemble_pairs_op.register_fake
def _(d, row_boost, engine):
    eng = _ENGINES[engine]
    return d.new_empty((eng.NT + 1, eng.b, eng.b), dtype=eng.asm_w.dtype)


@assemble_pairs_op.register_vmap
def _(info, in_dims, d, row_boost, engine):
    eng = _ENGINES[engine]
    dd, bd = in_dims[0], in_dims[1]
    d = d.movedim(dd, 0) if dd is not None else d.expand(info.batch_size, *d.shape)
    if bd is not None:
        row_boost = row_boost.movedim(bd, 0)
    if takes_kernel(d.device, d.dtype, eng.asm_w.dtype):
        return tiled_cuda.assemble_pairs_batched(eng, d, row_boost), 0
    return eng._assemble_pairs_plain(d, row_boost), 0
