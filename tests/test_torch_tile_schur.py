"""The tile engine's Schur update, L[dst] -= L[a]·L[b]ᵀ per pair of a panel,
in the kernel's own summation order (``chol_cuda.tile_schur_fma_plain``: one
chain of fused multiply-adds per entry, k ascending, one float32
subtraction), on the CPU.

The card test (``tests/test_torch_cuda_tile_schur.py``) holds the kernel
(``csrc/tile_schur.cu``) against ``tile_schur_fma_plain`` bit for bit, so
here that function is held against exact rational arithmetic rounded to
float32 once per fused multiply-add, and against the update as the JAX
package computes it (``S - A @ B.T`` in float32) within
2k·eps32·Σ|terms|, at the tile widths 16, 32 and 128 and on rectangular
tails.  Then the wrappers' CPU route (the same sums), the operator
``cim::tile_schur`` under ``torch.func.vmap``, and
``TiledCholesky.factorize``'s dispatch: which route each kind of operand
takes, and that the kernel's route factors as the plain one does.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cholesky_is_magic_tpu_torch.ops import chol_cuda
from cholesky_is_magic_tpu_torch.sparse import tiled, tiled_cuda
from test_torch_schur import _fma_exact, _round_f32

EPS32 = float(np.finfo(np.float32).eps)


def _operands(lead, r, c, k, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda *shape: rng.normal(size=lead + shape).astype(np.float32)  # noqa: E731
    return f32(r, c), f32(r, k), f32(c, k)


@pytest.mark.parametrize("lead,r,c,k", [((), 3, 4, 5), ((), 5, 2, 7), ((), 1, 1, 1),
                                        ((2,), 2, 3, 4), ((2, 2), 3, 3, 3)])
def test_tile_schur_fma_plain_is_the_exact_chain(lead, r, c, k):
    S, A, B = _operands(lead, r, c, k, r * c * k)
    got = chol_cuda.tile_schur_fma_plain(*map(torch.from_numpy, (S, A, B))).numpy()
    want = S.copy()
    for idx in np.ndindex(*lead, r, c):
        *head, i, j = idx
        acc = np.float32(0.0)
        for t in range(k):
            acc = _fma_exact(A[(*head, i, t)], B[(*head, j, t)], acc)
        want[idx] = _round_f32(Fraction(float(S[idx])) - Fraction(float(acc)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("r,c,k", [(16, 16, 16), (32, 32, 32), (128, 128, 128),
                                   (128, 40, 128), (33, 70, 100), (1, 128, 16)])
def test_tile_schur_fma_plain_matches_the_jax_update(r, c, k):
    """Within 2k·eps32·Σ|terms| of the float32 update in JAX and of the
    port's plain matmul form, on every entry."""
    S, A, B = _operands((2,), r, c, k, r + c + k)
    got = chol_cuda.tile_schur_fma_plain(*map(torch.from_numpy, (S, A, B))).numpy()
    with jax.default_matmul_precision("highest"):
        jx = np.asarray(jnp.asarray(S) - jnp.asarray(A) @ jnp.swapaxes(jnp.asarray(B), -1, -2))
    St, At, Bt = map(torch.from_numpy, (S, A, B))
    plain = (St - At @ Bt.transpose(-1, -2)).numpy()
    mag = np.abs(S) + np.abs(A) @ np.swapaxes(np.abs(B), -1, -2)
    for other in (jx, plain):
        assert np.all(np.abs(got - other) <= 2 * k * EPS32 * mag)


def test_a_diagonal_destination_stays_symmetric():
    """A pair i = j updates its destination with A·Aᵀ: the chains of (r, c)
    and (c, r) take the same products in the same order, so a symmetric
    destination stays symmetric bit for bit."""
    rng = np.random.default_rng(4)
    A = torch.from_numpy(rng.normal(size=(3, 32, 32)).astype(np.float32))
    S = A @ A.transpose(1, 2) + torch.eye(32)
    got = chol_cuda.tile_schur_fma_plain(S, A, A)
    assert torch.equal(got, got.transpose(1, 2))


def _tiles(lanes, nt, b, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(lanes, nt, b, b)).astype(np.float32))


PAIRS = [torch.tensor(x) for x in ([0, 1, 1, 2], [0, 0, 1, 1], [3, 4, 5, 6])]


def _by_pair(L, a, b, dst):
    """The update one pair at a time, leading axes lanes."""
    out = L.clone()
    for p in range(len(a)):
        out[..., dst[p], :, :] = chol_cuda.tile_schur_fma_plain(
            L[..., dst[p], :, :], L[..., a[p], :, :], L[..., b[p], :, :])
    return out


def test_the_wrappers_cpu_route_is_the_kernels_sums():
    """CPU tensors take ``tile_schur_fma_plain``'s sums, single and batched,
    and launch nothing; the pairs' products are those of the tiles before
    the update (no destination is an operand)."""
    L = _tiles(3, 8, 16, 1)
    want = _by_pair(L, *PAIRS)
    before = dict(tiled_cuda.LAUNCHES)
    one = L[1].clone()
    tiled_cuda.tile_schur_(one, *PAIRS)
    many = L.clone()
    tiled_cuda.tile_schur_batched_(many, *PAIRS)
    assert torch.equal(one, want[1]) and torch.equal(many, want)
    assert tiled_cuda.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        tiled_cuda._tile_schur_launch(L, *PAIRS, "tile_schur_batched", "tile_schur")
    assert tiled_cuda.LAUNCHES == before


@pytest.mark.parametrize("in_dim", [0, 1])
def test_the_operator_under_vmap_updates_every_lane_in_place(in_dim):
    L = _tiles(4, 8, 16, 2)
    want = _by_pair(L, *PAIRS)

    def lane(x):
        y = x.clone()
        tiled_cuda.tile_schur(y, *PAIRS, per_lane=True)
        return y

    got = torch.func.vmap(lane, in_dims=in_dim, out_dims=in_dim)(L.movedim(0, in_dim))
    assert torch.equal(got.movedim(in_dim, 0), want)


def _engine(n, block, dtype=torch.float32):
    from cholesky_is_magic_tpu_torch.ingest.standard_form import scale_constraints
    from lpbench.gen import qap_relaxation as qap

    f = qap.fleet(n, 0, 1, lanes=1)
    vals, _ = scale_constraints(f.rows.astype(np.int32), f.vals, f.b[0])
    A = sp.csc_matrix((vals, (f.rows, f.cols)), shape=(f.m, f.n))
    return f, tiled.engine_for_sparse(A, block=block, dtype=dtype, device="cpu")


class _OneRank:
    """A 'tp' group of one rank, without a process group."""

    def get_group(self, name):
        return None

    def get_local_rank(self, name):
        return 0


def test_factorize_routes_the_schur_update(monkeypatch):
    """Where ``takes_kernel`` says the kernel (float32 on a card: here made
    to say so on the CPU, where the route runs the kernel's sums), each
    panel with pairs makes one call of ``tiled_cuda.tile_schur``, through
    the operator inside a lane; the mesh route makes none.  The factor
    agrees with the plain route's (batched matmul + ``index_add_``) to
    float32 rounding, and under vmap each lane with its single factor."""
    import torch.distributed as dist

    f, eng = _engine(5, 16)
    rng = np.random.default_rng(7)
    d = torch.as_tensor(np.exp(rng.uniform(-1, 1, (2, f.n))), dtype=torch.float32)
    tiles = torch.stack([eng.assemble_pairs(d[k]) for k in range(2)])
    L_plain, _, ok_plain = eng.factorize(tiles[0])
    calls = []
    route = tiled_cuda.tile_schur

    def counted(L, a, b, dst, per_lane=False):
        calls.append(per_lane)
        route(L, a, b, dst, per_lane)

    monkeypatch.setattr(tiled_cuda, "tile_schur", counted)
    monkeypatch.setattr(tiled, "takes_kernel", lambda *dev_and_dtypes: True)
    L_k, _, ok_k = eng.factorize(tiles[0])
    panels = sum(1 for n in eng._n_syrk if n)
    assert panels > 1 and calls == [False] * panels
    assert bool(ok_k) and bool(ok_plain)
    rel = float(torch.linalg.norm(L_k - L_plain) / torch.linalg.norm(L_plain))
    assert rel <= 1e-5, rel
    calls.clear()
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1)
    monkeypatch.setattr(dist, "all_reduce", lambda t, group=None: t)
    L_mesh, _, _ = eng.factorize(tiles[0], mesh=_OneRank())
    assert calls == [] and torch.equal(L_mesh, L_plain)
    lanes = torch.func.vmap(lambda t: eng.factorize(t, per_lane=True)[0])(tiles)
    assert calls == [True] * panels
    assert torch.equal(lanes[0], L_k)
    single = eng.factorize(tiles[1])[0]
    assert float(torch.linalg.norm(lanes[1] - single) / torch.linalg.norm(single)) <= 1e-6


def test_float64_and_the_cpu_keep_the_plain_route(monkeypatch):
    """Without the patch, CPU tensors (float32 or float64) never reach the
    kernel's route."""
    calls = []
    monkeypatch.setattr(tiled_cuda, "tile_schur", lambda *a, **k: calls.append(a))
    for dtype in (torch.float32, torch.float64):
        f, eng = _engine(4, 16, dtype)
        d = torch.ones(f.n, dtype=dtype)
        L, _, ok = eng.factorize(eng.assemble_pairs(d))
        assert bool(ok) and sum(eng._n_syrk) > 0
    assert calls == []
