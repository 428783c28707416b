"""Host-side symbolic analysis: the `cholmod_analyze` replacement.

Computed once per sparsity pattern (the reference calls cholmod-analyze once
and reuses the symbolic factor every iteration, affine-scaling.lisp:271):

- :func:`amd_order` — quotient-graph minimum-degree fill-reducing ordering
  (CHOLMOD uses AMD/nested dissection; any fill-reducing permutation is
  functionally equivalent, the quality only affects nnz(L));
- :func:`elimination_tree` — Liu's algorithm with path compression;
- :func:`postorder` — DFS postorder of the etree;
- :func:`column_counts` — exact per-column L counts via row-subtree walks;
- :func:`supernodes` — fundamental supernodes + relaxed amalgamation;
- :func:`analyze` — everything above for the IPM normal matrix N = A·Aᵀ,
  plus the static 128-tile block-nonzero map the device factorization
  schedules against, and the nnz/flop report the reference prints at solver
  start (affine-scaling.lisp:273-279 via wrapper.c accessors).

Pure numpy/scipy graph work; a C++ native fast path for large patterns
lives in native/symbolic.cpp (see sparse.native).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp


def normal_pattern(A: sp.spmatrix) -> sp.csc_matrix:
    """Boolean pattern of N = A·Aᵀ (cholmod_aat analogue)."""
    Ab = sp.csr_matrix(A, copy=True)
    Ab.data = np.ones_like(Ab.data)
    N = (Ab @ Ab.T).tocsc()
    N.data = np.ones_like(N.data)
    return N


def amd_order(N: sp.spmatrix, use_native: bool = True) -> np.ndarray:
    """Minimum-degree ordering of a symmetric pattern.

    Quotient-graph minimum degree: eliminated vertices become *elements*;
    a variable's degree is the size of the union of its variable neighbors
    and the variables of its adjacent elements.  This is the core of AMD
    minus the "approximate" degree bounds and supervariable detection —
    O(n · deg²) worst case, fine host-side for the sizes the Python path
    serves (the C++ native path handles large patterns).
    """
    if use_native:
        from cholesky_is_magic_tpu_torch.sparse import native

        perm = native.amd_order(N)
        if perm is not None:
            return perm
    C = sp.csc_matrix(N)
    n = C.shape[0]
    # Elimination-graph minimum degree: eliminate the min-degree vertex,
    # clique its neighborhood (the fill L would create), repeat.
    adj = [set() for _ in range(n)]
    for j in range(n):
        for i in C.indices[C.indptr[j] : C.indptr[j + 1]]:
            if i != j:
                adj[j].add(int(i))
    alive = np.ones(n, dtype=bool)
    degs = np.array([len(a) for a in adj], dtype=np.int64)
    perm = np.empty(n, dtype=np.int64)
    for k in range(n):
        cand = np.flatnonzero(alive)
        v = int(cand[np.argmin(degs[cand])])
        perm[k] = v
        alive[v] = False
        nb = adj[v]
        for u in nb:
            adj[u].discard(v)
            adj[u] |= nb - {u}
            degs[u] = len(adj[u])
        adj[v] = set()
    return perm


def elimination_tree(
    N: sp.spmatrix, perm: Optional[np.ndarray] = None, use_native: bool = True
) -> np.ndarray:
    """Parent array of the elimination tree of P·N·Pᵀ (Liu 1986, with path
    compression).  Uses the C++ kernel when available."""
    C = sp.csc_matrix(N)
    n = C.shape[0]
    if perm is not None:
        C = C[perm][:, perm].tocsc()
    if use_native:
        from cholesky_is_magic_tpu_torch.sparse import native

        p = native.elimination_tree(C)
        if p is not None:
            return p
    parent = np.full(n, -1, dtype=np.int64)
    ancestor = np.full(n, -1, dtype=np.int64)
    for j in range(n):
        for i in C.indices[C.indptr[j] : C.indptr[j + 1]]:
            i = int(i)
            if i >= j:
                continue
            # Walk from i to the root of its current subtree, compressing.
            k = i
            while ancestor[k] != -1 and ancestor[k] != j:
                nxt = ancestor[k]
                ancestor[k] = j
                k = nxt
            if ancestor[k] == -1:
                ancestor[k] = j
                parent[k] = j
    return parent


def postorder(parent: np.ndarray) -> np.ndarray:
    """DFS postorder of the forest given by ``parent``."""
    n = len(parent)
    children = [[] for _ in range(n)]
    roots = []
    for v in range(n):
        p = parent[v]
        if p == -1:
            roots.append(v)
        else:
            children[p].append(v)
    post = np.empty(n, dtype=np.int64)
    k = 0
    for root in roots:
        stack = [(root, iter(children[root]))]
        while stack:
            node, it = stack[-1]
            child = next(it, None)
            if child is None:
                stack.pop()
                post[k] = node
                k += 1
            else:
                stack.append((child, iter(children[child])))
    assert k == n, "parent array is not a forest"
    return post


def _row_structures(C: sp.csc_matrix, parent: np.ndarray):
    """Yield (i, structure of row i of L) via etree walks (O(nnz(L)))."""
    n = C.shape[0]
    marker = np.full(n, -1, dtype=np.int64)
    R = sp.csr_matrix(C)
    for i in range(n):
        struct = []
        marker[i] = i
        for j in R.indices[R.indptr[i] : R.indptr[i + 1]]:
            j = int(j)
            if j >= i:
                continue
            while marker[j] != i:
                struct.append(j)
                marker[j] = i
                j = int(parent[j])
                if j == -1:
                    break
        yield i, struct


def column_counts(
    N: sp.spmatrix,
    perm: Optional[np.ndarray],
    parent: np.ndarray,
    use_native: bool = True,
):
    """Exact nnz per column of L (incl. diagonal) for chol(P·N·Pᵀ).

    Returns (counts, nnz_L, flops): the data behind the reference's
    factorization cost report (lnz/fl; affine-scaling.lisp:273-279).
    Uses the C++ kernel when available."""
    C = sp.csc_matrix(N)
    n = C.shape[0]
    if perm is not None:
        C = C[perm][:, perm].tocsc()
    if use_native:
        from cholesky_is_magic_tpu_torch.sparse import native

        out = native.column_counts(C, parent)
        if out is not None:
            return out
    counts = np.ones(n, dtype=np.int64)  # diagonal
    for _, struct in _row_structures(C, parent):
        for j in struct:
            counts[j] += 1
    nnz_L = int(counts.sum())
    flops = float((counts.astype(np.float64) ** 2).sum())
    return counts, nnz_L, flops


def supernodes(parent: np.ndarray, counts: np.ndarray, relax: int = 8) -> list[tuple[int, int]]:
    """Partition columns into supernodes [(start, end), ...).

    Fundamental supernodes: j joins j-1's supernode when parent[j-1] == j
    and count[j-1] == count[j] + 1 (identical structure below the
    diagonal).  Relaxed amalgamation merges a run shorter than ``relax``
    into the preceding run when that run is its etree parent (the last
    column of the previous run is a child of a column in this run) —
    trading a little fill for larger MXU-friendly panels (CHOLMOD's
    supernodal amalgamation analogue).  Merging is restricted to
    tree-adjacent runs: amalgamating *independent* components would glue
    unrelated structure into one supernode and defeat the panel alignment
    of pack_supernodes."""
    n = len(parent)
    snodes: list[tuple[int, int]] = []
    start = 0
    for j in range(1, n):
        fundamental = parent[j - 1] == j and counts[j - 1] == counts[j] + 1
        if not fundamental:
            snodes.append((start, j))
            start = j
    snodes.append((start, n))
    if relax > 1:
        merged: list[tuple[int, int]] = []
        for s, e in snodes:
            tree_adjacent = (
                merged
                and merged[-1][1] == s
                and s <= parent[s - 1] < e  # prev run's root parents into this run
            )
            if tree_adjacent and (e - s) < relax and (e - merged[-1][0]) <= 4 * relax:
                merged[-1] = (merged[-1][0], e)
            else:
                merged.append((s, e))
        snodes = merged
    return snodes


def pack_supernodes(snodes: list, block: int) -> tuple[np.ndarray, int]:
    """Assign each (postordered) column a slot so no supernode straddles a
    ``block``-wide panel boundary.

    Whole supernodes are packed greedily into panels; a supernode that
    would straddle starts a fresh panel (leaving inert gap slots), and
    supernodes wider than ``block`` are split at panel boundaries (harmless:
    within a supernode the below-diagonal structure is identical, so the
    split tiles are dense anyway).  Returns (slots, n_panels): ``slots`` is
    monotonically increasing, so the triangular structure is preserved.

    This is the tile-level rendering of CHOLMOD's supernodal amalgamation
    (sparse-cholesky.lisp:24,265 toggles supernodal mode): panel boundaries
    follow the structure instead of a fixed grid, so independent
    subproblems stop densifying shared tiles.
    """
    n = snodes[-1][1] if snodes else 0
    slots = np.empty(n, dtype=np.int64)
    cur = 0
    for s, e in snodes:
        w = e - s
        if w > block - (cur % block) and (cur % block) != 0:
            cur += block - cur % block  # start a fresh panel
        while w > block:
            slots[s : s + block] = np.arange(cur, cur + block)
            cur += block
            s += block
            w -= block
        slots[s:e] = np.arange(cur, cur + w)
        cur += w
    n_panels = max(1, (cur + block - 1) // block)
    return slots, n_panels


def _slot_block_mask(
    C: sp.csc_matrix,
    parent: np.ndarray,
    block: int,
    slots: np.ndarray,
    B: int,
    use_native: bool = True,
) -> np.ndarray:
    """Block-tile structure of L on the slot grid: tile
    (slots[i]//block, slots[j]//block) is resident iff L[i, j] != 0."""
    if use_native:
        from cholesky_is_magic_tpu_torch.sparse import native

        mask = native.block_mask_slots(C, parent, block, slots, B)
        if mask is not None:
            return mask
    mask = np.zeros((B, B), dtype=bool)
    st = slots // block
    for i, struct in _row_structures(C, parent):
        bi = st[i]
        mask[bi, bi] = True
        for j in struct:
            mask[bi, st[j]] = True
    return mask


@dataclasses.dataclass
class FactorPlan:
    """Static schedule for the device factorization (the symbolic factor)."""

    n: int  # matrix dimension (true, unpadded)
    perm: np.ndarray  # fill-reducing permutation (new <- old)
    iperm: np.ndarray  # inverse permutation
    parent: np.ndarray  # elimination tree (permuted indices)
    post: np.ndarray  # postorder of the etree
    counts: np.ndarray  # nnz per column of L
    snodes: list  # supernode column ranges [(s, e), ...)
    block: int  # device tile width
    block_mask: np.ndarray  # (B, B) bool: which L tiles are structurally nonzero
    # The reference's startup report (AA' nnz/flops, factor nnz/flops).
    nnz_N: int
    nnz_L: int
    flops: float
    # Supernode-aligned slot layout (pack_supernodes): slot of each permuted
    # column, and the block mask on the slot grid.  None when not computed.
    slots: Optional[np.ndarray] = None
    slot_mask: Optional[np.ndarray] = None

    @property
    def n_padded(self) -> int:
        return self.block_mask.shape[0] * self.block

    def stats(self) -> dict:
        B = self.block_mask.shape[0]
        out = {
            "nnz_N": self.nnz_N,
            "nnz_L": self.nnz_L,
            "factor_flops": self.flops,
            "supernodes": len(self.snodes),
            "nonzero_tiles": int(self.block_mask.sum()),
            "total_tiles": int(B * (B + 1) // 2),
        }
        if self.slot_mask is not None:
            Bs = self.slot_mask.shape[0]
            out["aligned_tiles"] = int(self.slot_mask.sum())
            out["aligned_panels"] = Bs
        return out


def analyze(
    A: sp.spmatrix,
    block: int = 128,
    order: bool = True,
    use_native: bool = True,
) -> FactorPlan:
    """Full symbolic analysis of the normal matrix N = A·Aᵀ.

    The block_mask marks which (row-tile, col-tile) pairs of L can hold
    nonzeros: the device factorization executes exactly those tile
    operations and skips the rest — dynamic sparsity decided entirely at
    ingest (SURVEY.md §7 "Hard parts": all structure static)."""
    Np = normal_pattern(A)
    m = Np.shape[0]
    if order:
        # Best-of orderings, CHOLMOD-style: AMD is not universally better
        # than the natural order (e.g. banded structure, where min-degree
        # scatters the band: measured 2x the resident tiles and 1.5x the
        # iteration time at m=4096).  RCM re-bands scattered structures
        # cheaply.  Compute the exact fill of each candidate, keep least.
        cands = [amd_order(Np, use_native=use_native), np.arange(m)]
        try:
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            cands.append(
                np.asarray(
                    reverse_cuthill_mckee(sp.csr_matrix(Np), symmetric_mode=True),
                    dtype=np.int64,
                )
            )
        except ImportError:
            pass
        best = None
        for cand in cands:
            par = elimination_tree(Np, cand, use_native=use_native)
            _, cand_nnz, _ = column_counts(Np, cand, par, use_native=use_native)
            if best is None or cand_nnz < best[0]:
                best = (cand_nnz, cand, par)
        _, perm0, parent0 = best
    else:
        perm0 = np.arange(m)
        parent0 = elimination_tree(Np, perm0, use_native=use_native)
    post = postorder(parent0)
    # Compose with the postorder: subtrees become contiguous index ranges,
    # which (a) makes fundamental-supernode detection valid (it assumes a
    # postordered tree) and (b) clusters each subtree's fill into compact
    # tile blocks — the tile-level sparsity the device schedule exploits.
    # Postordering is fill-neutral (it reorders within the same etree).
    perm = perm0[post]
    pos = np.empty(m, dtype=np.int64)
    pos[post] = np.arange(m)
    parent = np.where(
        parent0[post] == -1, -1, pos[np.where(parent0[post] == -1, 0, parent0[post])]
    )
    iperm = np.empty(m, dtype=np.int64)
    iperm[perm] = np.arange(m)
    counts0, nnz_L, flops = column_counts(Np, perm0, parent0, use_native=use_native)
    counts = counts0[post]
    snodes = supernodes(parent, counts)

    # Block-tile structure of L from the row structures (C++ fast path).
    B = (m + block - 1) // block
    C = Np[perm][:, perm].tocsc()
    block_mask = None
    if use_native:
        from cholesky_is_magic_tpu_torch.sparse import native

        block_mask = native.block_mask(C, parent, block)
    if block_mask is None:
        block_mask = np.zeros((B, B), dtype=bool)
        for i, struct in _row_structures(C, parent):
            bi = i // block
            block_mask[bi, bi] = True
            for j in struct:
                block_mask[bi, j // block] = True
    slots, slot_B = pack_supernodes(snodes, block)
    slot_mask = _slot_block_mask(
        C, parent, block, slots, slot_B, use_native=use_native
    )
    return FactorPlan(
        n=m,
        perm=perm,
        iperm=iperm,
        parent=parent,
        post=np.arange(m),  # the relabeled tree is postordered by construction
        counts=counts,
        snodes=snodes,
        block=block,
        block_mask=block_mask,
        nnz_N=int(Np.nnz),
        nnz_L=nnz_L,
        flops=flops,
        slots=slots,
        slot_mask=slot_mask,
    )
