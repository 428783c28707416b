"""The hand-written CUDA kernels on the card: the double-word matvecs (also
on rows that do not start on a 16-byte boundary; Aᵀ·x and both A·x kernels,
short rows and long, bit for bit against their summation orders in plain
PyTorch), the blocked Cholesky (tile, panel,
Schur; tiles wider than 128 split around the tile kernel) and the
pair-schedule assembly, each against its plain PyTorch version, the dense
and sparse solves (afiro; block 256), crossover on both paths (its dd
products and its B·Bᵀ factorizations launch the kernels; a singular first
basis takes the dbound retry), the matrix-free family (ALM in f32 and f64;
the dense dd ALM's exact launch counts; the sparse two-phase protocol; the
inner loop's CUDA graph against its eager chunks), the batched dd kernels
(each lane bit-equal to the single launch, under vmap too, the lane limit)
and the batched tile and assembly kernels (each lane bit-equal to the single
launch, at the m = 16384 schedule too), the batch solves (f64 lane counts
equal to the CPU's; the f32 two-phase batch through the batched kernels; a
sparse batch on one engine through the batched tile and assembly kernels;
the slabbed front door), the dense-A engines (the tile engine's K1 per
panel, BlockSparseCholesky's potrf per diagonal tile, the dd kernels in the
refinement), and float64 on the card, which takes the plain forms and
launches no kernel (Gondzio's correctors on a dense-A engine too).

Every test here needs an NVIDIA card and skips without one.  The file
imports no jax, so it also runs on a machine without it; the repository's
tests/conftest.py imports jax, so run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from cholesky_is_magic_tpu_torch.ops import chol, chol_cuda
from cholesky_is_magic_tpu_torch.ops import dd as ddm
from cholesky_is_magic_tpu_torch.ops import dd_cuda
from cholesky_is_magic_tpu_torch.sparse import tiled, tiled_cuda

pytestmark = pytest.mark.cuda

EPS32 = float(np.finfo(np.float32).eps)
AFIRO = os.path.join(os.path.dirname(__file__), "fixtures", "afiro.mps")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _f64(d):
    return d.hi.double().cpu().numpy() + d.lo.double().cpu().numpy()


def _inputs(rng, m, n, dev):
    A = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.normal(size=m).astype(np.float32)).to(dev)
    return A, x, y


def test_kernels_match_f64_truth(dev):
    """test_dd_pallas.py::test_tpu_exact's contract, on the H100."""
    A, x, y = _inputs(np.random.default_rng(3), 512, 1024, dev)
    A64 = A.double().cpu().numpy()
    np.testing.assert_allclose(_f64(ddm.dd_matvec(A, x)),
                               A64 @ x.double().cpu().numpy(),
                               rtol=1e-11, atol=1e-11)
    np.testing.assert_allclose(_f64(ddm.dd_rmatvec(A, y)),
                               A64.T @ y.double().cpu().numpy(),
                               rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("m,n", [(1, 1), (7, 300), (300, 7), (129, 257),
                                 (1441, 5093)])
def test_kernels_match_plain_on_ragged_shapes(dev, m, n):
    """Not bit-equal (the summation order differs): within 64·eps32² of
    Σ|a_ij x_j| per output."""
    A, x, y = _inputs(np.random.default_rng(m + n), m, n, dev)
    for got, plain, scale in (
        (ddm.dd_matvec(A, x), ddm._dd_matvec_plain(A, x), A.abs() @ x.abs()),
        (ddm.dd_rmatvec(A, y), ddm._dd_matvec_plain(A.T, y),
         A.abs().T @ y.abs()),
    ):
        err = np.abs(_f64(got) - _f64(plain))
        assert np.all(err <= 64 * EPS32**2 * scale.double().cpu().numpy())


@pytest.mark.parametrize("view", ["A[1:]", "x[1:]", "both"])
def test_dd_mv_on_misaligned_views(dev, view):
    """A·x where the rows (lda = 5093, and a view one row in) or x (a view
    one element in) do not start on a 16-byte boundary: against the plain
    version within 64·eps32² of Σ|a_ij x_j| and the f64 truth within
    1e-11."""
    m, n = 1441, 5093
    A, x, _y = _inputs(np.random.default_rng(11), m + 1, n + 1, dev)
    A = A[:, :n].contiguous()
    A = A[1:] if view in ("A[1:]", "both") else A[:m]
    x = x[1:] if view in ("x[1:]", "both") else x[:n]
    assert A.is_contiguous() and A.shape == (m, n) and x.shape == (n,)
    got = _f64(ddm.dd_matvec(A, x))
    scale = (A.abs() @ x.abs()).double().cpu().numpy()
    assert np.all(np.abs(got - _f64(ddm._dd_matvec_plain(A, x)))
                  <= 64 * EPS32**2 * scale)
    np.testing.assert_allclose(got, A.double().cpu().numpy() @ x.double().cpu().numpy(),
                               rtol=1e-11, atol=1e-11)


# Both sides of the short-lane kernel's switch (dd_cuda.RMV_SHORT_SLABS = 16
# slabs): (64, 64), (64, 128) 2 slabs, (128, 128) 4, (256, 300) 8, (257, 128)
# 9, (512, 128) 16 on the short kernel; (544, 128) 17 and the pilot's 27 on
# the long one.
RMV_SHAPES = [(1, 1), (7, 300), (300, 7), (129, 257), (1441, 5093), (1536, 5120),
              (64, 64), (64, 128), (128, 128), (256, 300), (257, 128), (512, 128),
              (544, 128)]


def _rmv_slab_order(A, y):
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count
    return dd_cuda.rmv_slab_plain(A, y, *dd_cuda.rmv_slabs(*A.shape[-2:], sms))


@pytest.mark.parametrize("m,n", RMV_SHAPES)
def test_dd_rmv_is_bit_equal_to_its_slab_order(dev, m, n):
    """Aᵀ·x against the same sums in plain PyTorch (rows ascending inside a
    slab, slabs ascending): equal bit for bit, hi and lo, and again on a
    second call (the column blocks' tickets are back at zero, short and long
    calls on one stream)."""
    A, _x, y = _inputs(np.random.default_rng(m + n), m, n, dev)
    want = _rmv_slab_order(A, y)
    for _ in range(2):
        got = ddm.dd_rmatvec(A, y)
        assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)
    for t in dd_cuda._TICKETS.values():
        assert not bool(t.any())


@pytest.mark.parametrize("view", ["A[1:]", "x[1:]", "both"])
@pytest.mark.parametrize("m,n", [(1441, 5093), (1536, 5120)])
def test_dd_rmv_on_misaligned_views(dev, m, n, view):
    """Aᵀ·x where the rows (a view of the storage one element in, or lda =
    5093) or x (a view one element in) do not start on a 16-byte boundary:
    bit-equal to the slab order, within 64·eps32² of Σ|a_ij x_i| of the
    plain version and 1e-11 of the f64 truth."""
    rng = np.random.default_rng(13)
    Abuf = torch.from_numpy(rng.normal(size=m * n + 1).astype(np.float32)).to(dev)
    ybuf = torch.from_numpy(rng.normal(size=m + 1).astype(np.float32)).to(dev)
    A = (Abuf[1:] if view in ("A[1:]", "both") else Abuf[:-1]).view(m, n)
    y = ybuf[1:] if view in ("x[1:]", "both") else ybuf[:m]
    got = ddm.dd_rmatvec(A, y)
    want = _rmv_slab_order(A, y)
    assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)
    scale = (A.abs().T @ y.abs()).double().cpu().numpy()
    assert np.all(np.abs(_f64(got) - _f64(ddm._dd_matvec_plain(A.T, y)))
                  <= 64 * EPS32**2 * scale)
    np.testing.assert_allclose(
        _f64(got), A.double().cpu().numpy().T @ y.double().cpu().numpy(),
        rtol=1e-11, atol=1e-11)


def test_each_call_counts_one_launch(dev):
    A, x, y = _inputs(np.random.default_rng(0), 64, 96, dev)
    before = dict(dd_cuda.LAUNCHES)
    ddm.dd_matvec(A, x)
    ddm.dd_rmatvec(A, y)
    ddm.dd_rmatvec(A, y)
    assert dd_cuda.LAUNCHES["mv"] == before["mv"] + 1
    assert dd_cuda.LAUNCHES["rmv"] == before["rmv"] + 2


def test_wrapper_refuses_what_the_kernels_do_not_take(dev):
    A, x, _y = _inputs(np.random.default_rng(1), 16, 32, dev)
    with pytest.raises(TypeError):
        dd_cuda.dd_mv(A.double(), x.double())
    with pytest.raises(TypeError):
        dd_cuda.dd_rmv(A.double(), _y.double())
    with pytest.raises(TypeError):
        chol_cuda.potrf(_spd(8, 0, dev).double())
    S, P = _spd(8, 0, dev), torch.ones(8, chol_cuda.BLOCK + 1, device=dev)
    with pytest.raises(ValueError, match="depth"):
        chol_cuda.potrf_schur_(S, P)
    with pytest.raises(ValueError, match="cols"):
        chol_cuda.potrf_schur_(S, P[:, :4], cols=9)
    with pytest.raises(ValueError, match="contiguous"):
        ddm.dd_matvec(A[:, ::2], x[::2])
    with pytest.raises(ValueError, match="shapes"):
        ddm.dd_matvec(A, x[:5])
    with pytest.raises(ValueError, match="CUDA"):
        dd_cuda.dd_mv(A, x.cpu())


def _counts():
    return {**dd_cuda.LAUNCHES, **chol_cuda.LAUNCHES, **tiled_cuda.LAUNCHES}


def test_float64_on_the_card_takes_the_plain_forms(dev):
    """float64 CUDA operands get the plain forms' values on the card and
    launch no kernel."""
    rng = np.random.default_rng(2)
    A = torch.tensor(rng.normal(size=(40, 70)), device=dev)
    x = torch.tensor(rng.normal(size=70), device=dev)
    y = torch.tensor(rng.normal(size=40), device=dev)
    N = A @ A.T / 70 + torch.eye(40, dtype=torch.float64, device=dev)
    Asp = (rng.random((40, 70)) < 0.1) * rng.normal(size=(40, 70))
    Asp[np.arange(40), np.arange(40)] += 2.0
    eng = tiled.engine_for_sparse(Asp, block=16, dtype=torch.float64, device=dev)
    before = _counts()
    for got, want in ((ddm.dd_matvec(A, x), ddm._dd_matvec_plain(A, x)),
                      (ddm.dd_rmatvec(A, y), ddm._dd_matvec_plain(A.T, y))):
        assert got.hi.dtype == torch.float64
        assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)
    assert torch.equal(chol.cholesky(N), chol.blocked_cholesky(N))
    T, inv = N.clone(), torch.empty_like(N)
    chol.factor_tile_(T, inv)
    Lp, Ip = chol._factor_tile_plain(N)
    assert torch.equal(T, Lp) and torch.equal(inv, Ip)
    boost = torch.zeros(40, dtype=torch.float64, device=dev)
    # index_add_ on the card adds with atomics: equal to rounding, not bitwise.
    torch.testing.assert_close(eng.assemble_pairs(x, boost),
                               eng._assemble_pairs_plain(x, boost),
                               rtol=1e-13, atol=1e-13)
    assert _counts() == before


@pytest.mark.parametrize("kw", [dict(), dict(sparse=True, block=16)],
                         ids=["dense", "sparse"])
def test_solve_afiro_in_float64_on_the_card(dev, kw):
    """afiro in f64 on the card, through the plain forms (no kernel
    launches): gap <= 1e-8, objective within 1e-7 relative; the CPU takes
    22 + 7 iterations on the same call."""
    import cholesky_is_magic_tpu_torch as cimt

    before = _counts()
    rep = cimt.solve(AFIRO, "pdas_dd", dtype=torch.float64, **kw)
    assert _counts() == before
    print(f"f64 afiro {kw}: {rep.summary['phase1_iterations']} + "
          f"{rep.summary['iterations']} iterations (CPU: 22 + 7), gap "
          f"{rep.summary['gap']:.3e}")
    assert rep.result.x.is_cuda and rep.result.x.dtype == torch.float64
    assert rep.status == "optimal" and rep.summary["gap"] <= 1e-8
    assert abs(rep.objective + 464.75314285714285) <= 1e-7 * 464.75314285714285


def test_solve_afiro_on_the_card(dev):
    import cholesky_is_magic_tpu_torch as cimt

    rep = cimt.solve(AFIRO, "pdas_dd", device="cuda")
    assert rep.summary["gap"] <= 1e-8
    assert abs(rep.objective + 464.75314285714285) <= 1e-7 * 464.75314285714285


def test_affine_afiro_on_the_card_launches_dd_mv(dev):
    """Dense f32 affine on afiro (rows equilibrated): every refined normal
    solve's residual launches dd A·x; the f32 iterate floor within 2e-3."""
    import cholesky_is_magic_tpu_torch as cimt

    before = _counts()
    rep = cimt.solve(AFIRO, "affine", rescale=True, pad_multiple=16,
                     max_iters=600, refine_steps=2)
    launched = {k: v - before[k] for k, v in _counts().items()}
    print(f"f32 afiro affine: {rep.summary['iterations']} iterations, "
          f"launches {launched}")
    assert launched["mv"] > 0
    assert rep.status == "optimal"
    assert abs(rep.objective + 464.75314285714285) <= 2e-3 * 464.75314285714285


def test_sparse_affine_on_the_card_launches_tile_and_assembly(dev):
    """Sparse f32 affine at block 16 on the m = 256 constructed LP: the tile
    and assembly kernels launch in every factorization."""
    import cholesky_is_magic_tpu_torch as cimt
    from cholesky_is_magic_tpu_torch.utils.testing import constructed_optimum_lp

    sf, info = constructed_optimum_lp(m=256, seed=0)
    before = _counts()
    rep = cimt.solve(sf, "affine", sparse=True, block=16)
    launched = {k: v - before[k] for k, v in _counts().items()}
    print(f"sparse f32 affine m = 256: {rep.summary['iterations']} iterations, "
          f"launches {launched}")
    assert launched["potrf_tile"] > 0 and launched["assemble_pairs"] > 0
    assert rep.status == "optimal"
    ref = info["objective"]
    assert abs(rep.objective - ref) <= 1e-3 * abs(ref)


def _spd(n, seed, dev):
    """A well-conditioned SPD f32 matrix on the card."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    return torch.tensor(M @ M.T / n + np.eye(n), dtype=torch.float32,
                        device=dev)


def _rel_err(a, b):
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max()).item()


@pytest.mark.parametrize("b", [1, 5, 16, 33, 64, 96, 127, 128, 160, 256])
def test_potrf_tile_matches_plain_and_truth(dev, b):
    """L·Lᵀ within 32·eps32 of N (f64 truth, relative in the Frobenius
    norm); L and L⁻¹ within 64·eps32 of the plain version, relative to
    their largest entry; only the lower triangle is read; upper triangles
    are exact zeros.  Above 128 the tile is split around the kernel, one
    launch per 128-column leaf."""
    N = _spd(b, b, dev)
    T = N.clone()
    iu = torch.triu_indices(b, b, 1, device=dev)
    T[iu[0], iu[1]] = float("nan")
    inv = torch.empty_like(T)
    before = chol_cuda.LAUNCHES["potrf_tile"]
    chol.factor_tile_(T, inv)
    torch.cuda.synchronize()
    assert chol_cuda.LAUNCHES["potrf_tile"] == before - (-b // chol_cuda.BLOCK)
    L64 = T.double()
    rel = (torch.linalg.norm(L64 @ L64.T - N.double())
           / torch.linalg.norm(N.double())).item()
    assert rel <= 32 * EPS32
    Lp, Ip = chol._factor_tile_plain(N)
    assert _rel_err(T, Lp) <= 64 * EPS32 and _rel_err(inv, Ip) <= 64 * EPS32
    assert bool((torch.triu(T, 1) == 0).all() & (torch.triu(inv, 1) == 0).all())


def test_potrf_tile_non_pd_is_all_nan(dev):
    T = _spd(64, 2, dev)
    T[30, 30] = -1.0
    inv = torch.empty_like(T)
    chol.factor_tile_(T, inv)
    assert bool(torch.isnan(T).all() & torch.isnan(inv).all())


@pytest.mark.parametrize("pivot", [60, 200])
def test_potrf_tile_split_non_pd_is_all_nan(dev, pivot):
    """A 256 tile whose non-positive pivot is in the leading or the
    trailing half: the whole L and L⁻¹ NaN."""
    T = _spd(256, 3, dev)
    T[pivot, pivot] = -1.0
    inv = torch.empty_like(T)
    chol.factor_tile_(T, inv)
    assert bool(torch.isnan(T).all() & torch.isnan(inv).all())


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("rows", [1, 31, 33, 1408])
@pytest.mark.parametrize("b", [16, 33, 100, 128])
def test_potrf_panel_matches_plain(dev, b, rows, aligned):
    """The panel kernel on a panel and strip that are views into a larger
    matrix (row stride > b; rows 16-byte aligned or not), with NaN above
    the diagonal of inv, which must not be read: P·tril(inv)ᵀ within
    2b·eps32 of Σ|terms|, the strip exactly zero, everything else
    untouched."""
    rng = np.random.default_rng(b * rows)
    width = -(-(b + rows) // 4) * 4 + (4 if aligned else 1)
    M = torch.tensor(rng.normal(size=(b + rows, width)), dtype=torch.float32,
                     device=dev)
    buf = torch.tensor(np.tril(rng.normal(size=(chol_cuda.BLOCK,) * 2)),
                       dtype=torch.float32, device=dev)
    inv = buf[:b, :b]
    iu = torch.triu_indices(b, b, 1, device=dev)
    inv[iu[0], iu[1]] = float("nan")
    M0 = M.clone()
    panel, strip = M[b:, :b], M[:b, b:b + rows]
    before = chol_cuda.LAUNCHES["potrf_panel"]
    chol_cuda.potrf_panel_(panel, inv, strip)
    torch.cuda.synchronize()
    assert chol_cuda.LAUNCHES["potrf_panel"] == before + 1
    low = torch.tril(torch.nan_to_num(inv, nan=0.0))
    plain = M0[b:, :b] @ low.T
    mag = M0[b:, :b].abs() @ low.abs().T
    assert bool(((panel - plain).abs() <= 2 * b * EPS32 * mag).all())
    assert bool((strip == 0).all())
    rest = torch.ones_like(M, dtype=torch.bool)
    rest[b:, :b] = False
    rest[:b, b:b + rows] = False
    assert torch.equal(M[rest], M0[rest])


@pytest.mark.parametrize("rows,b", [(33, 33), (1408, 128)])
def test_potrf_panel_same_at_every_rows_per_cta(dev, rows, b):
    """The launch geometry changes who computes a row, not its sums: every
    rows-per-CTA of ``PANEL_ROWS`` gives the same panel bit for bit."""
    rng = np.random.default_rng(rows)
    M0 = torch.tensor(rng.normal(size=(b + rows, b + rows)), dtype=torch.float32,
                      device=dev)
    inv = torch.tensor(np.tril(rng.normal(size=(b, b))), dtype=torch.float32, device=dev)
    got = []
    for rpc in chol_cuda.PANEL_ROWS:
        M = M0.clone()
        chol_cuda._potrf_panel(M[b:, :b], inv, M[:b, b:], rpc)
        got.append(M)
    assert all(torch.equal(g, got[0]) for g in got[1:])


def _schur_operands(dev, t, b, aligned, seed):
    """S (t, t) and P (t, b) as views into one larger matrix (row stride
    > t + b; rows 16-byte aligned or not), NaN in S's strict upper triangle;
    the matrix, its untouched copy, and the two views."""
    rng = np.random.default_rng(seed)
    width = -(-(b + t) // 4) * 4 + (4 if aligned else 1)
    M = torch.tensor(rng.normal(size=(t, width)), dtype=torch.float32, device=dev)
    S, P = M[:, b:b + t], M[:, :b]
    iu = torch.triu_indices(t, t, 1, device=dev)
    S[iu[0], iu[1]] = float("nan")
    return M, M.clone(), S, P


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("t", [1, 31, 33, 128, 1408])
@pytest.mark.parametrize("b", [16, 33, 100, 128])
def test_potrf_schur_matches_plain(dev, b, t, aligned):
    """The Schur kernel on views into a larger matrix, NaN planted in S's
    strict upper triangle: each lower entry within 2b·eps32 of Σ|terms| of
    tril(S - P·Pᵀ) and bit-equal to its own sums in plain PyTorch
    (``schur_fma_plain``); the upper triangle and everything else untouched;
    one launch."""
    M, M0, S, P = _schur_operands(dev, t, b, aligned, b * t)
    assert chol_cuda.aligned16(P.data_ptr(), P.stride(0)) == aligned
    want = chol_cuda.schur_fma_plain(S, P)
    low = torch.tril(S)
    plain = torch.tril(low - P @ P.T)
    mag = torch.tril(low.abs() + P.abs() @ P.abs().T)
    before = chol_cuda.LAUNCHES["potrf_schur"]
    chol_cuda.potrf_schur_(S, P)
    torch.cuda.synchronize()
    assert chol_cuda.LAUNCHES["potrf_schur"] == before + 1
    assert bool(((torch.tril(S) - plain).abs() <= 2 * b * EPS32 * mag).all())
    assert torch.equal(torch.tril(S), torch.tril(want))
    assert bool(torch.isnan(S[tuple(torch.triu_indices(t, t, 1, device=dev))]).all())
    rest = torch.ones_like(M, dtype=torch.bool)
    rest[:, b:b + t] = False
    assert torch.equal(M[rest], M0[rest])


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("t,cols", [(1408, 128), (1313, 128), (300, 100), (161, 128),
                                    (129, 128), (64, 1)])
def test_potrf_split_update_equals_whole(dev, t, cols, aligned):
    """The panel loop's two launches (the leading ``cols`` columns, then the
    block beyond them) give the bits of one whole launch, and the first
    leaves every column from ``cols`` on untouched."""
    b = chol_cuda.BLOCK
    _M, _M0, S, P = _schur_operands(dev, t, b, aligned, t + cols)
    whole, split = S.clone(), S.clone()
    chol_cuda.potrf_schur_(whole, P)
    chol_cuda.potrf_schur_(split, P, cols=cols)
    assert torch.equal(torch.tril(split)[:, cols:], torch.tril(S)[:, cols:])
    chol_cuda.potrf_schur_(split[cols:, cols:], P[cols:])
    torch.cuda.synchronize()
    assert torch.equal(torch.tril(split), torch.tril(whole))
    assert bool(torch.isnan(split[tuple(torch.triu_indices(t, t, 1, device=dev))]).all())


@pytest.mark.parametrize("n", [1, 100, 128, 129, 300, 515, 1441])
def test_potrf_matches_plain(dev, n):
    """The panel loop (tile, panel and Schur kernels) against the plain
    blocked_cholesky and cholesky_ex: within 64·eps32 of the largest
    entry; the upper triangle exactly zero; N untouched.  At n = 1441 the
    rows do not start on 16-byte boundaries and the last panel is 33
    wide.  Each of the panels - 1 steps launches the Schur kernel on the
    next block column, and every step but the last once more on the rest."""
    N = _spd(n, n, dev)
    N0 = N.clone()
    before = dict(chol_cuda.LAUNCHES)
    L = chol.cholesky(N)
    torch.cuda.synchronize()
    panels = -(-n // chol_cuda.BLOCK)
    assert chol_cuda.LAUNCHES["potrf_tile"] == before["potrf_tile"] + panels
    assert chol_cuda.LAUNCHES["potrf_panel"] == before["potrf_panel"] + panels - 1
    assert (chol_cuda.LAUNCHES["potrf_schur"]
            == before["potrf_schur"] + max(panels - 1, 0) + max(panels - 2, 0))
    assert torch.equal(N, N0)
    assert bool((torch.triu(L, 1) == 0).all())
    for plain in (chol.blocked_cholesky(N), torch.linalg.cholesky_ex(N)[0]):
        assert _rel_err(L, plain) <= 64 * EPS32
    bad = N.clone()
    bad[n // 2, n // 2] = -1.0
    assert not bool(torch.isfinite(chol.cholesky(bad)).all())
    # Twice more on a side stream of the caller's: the same bits.
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        again = [chol.cholesky(N) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(L, a) for a in again)


@pytest.mark.parametrize("block", [8, 16, 32, 128])
def test_assemble_pairs_matches_plain_and_repeats_bit_for_bit(dev, block):
    """Two runs are equal, and equal bit for bit to the plain version on the
    CPU, whose index_add_ adds in schedule order as the kernel does.  The
    plain version on the card adds with atomics in any order: within
    8·eps32·Σ|w·d²| of it per entry, for runs of up to 32 pairs (an order
    apart, a longer sum's rounding grows with its length).  The schedule has
    runs of one pair and a long diagonal run (a dense row)."""
    rng = np.random.default_rng(block)
    m, n = 150, 260
    A = (rng.random((m, n)) < 0.04) * rng.normal(size=(m, n))
    A[np.arange(m), np.arange(m)] += 2.0
    A[7, :] = rng.normal(size=n)
    eng = tiled.engine_for_sparse(A, block=block, device=dev)
    d = torch.tensor(rng.random(n) + 0.5, dtype=torch.float32, device=dev)
    boost = torch.tensor((rng.random(m) < 0.1) * 1.0, dtype=torch.float32,
                         device=dev)
    before = tiled_cuda.LAUNCHES["assemble_pairs"]
    t1 = eng.assemble_pairs(d, boost)
    t2 = eng.assemble_pairs(d, boost)
    torch.cuda.synchronize()
    assert tiled_cuda.LAUNCHES["assemble_pairs"] == before + 2
    assert torch.equal(t1, t2)
    sched = eng._kernel_schedule
    lengths = torch.diff(sched.run_start)
    assert int(lengths.min()) <= 1 and int(lengths.max()) >= n
    host = tiled.engine_for_sparse(A, block=block, device="cpu")
    assert torch.equal(t1.cpu(), host._assemble_pairs_plain(d.cpu(), boost.cpu()))
    plain = eng._assemble_pairs_plain(d, boost)
    mag = torch.zeros_like(plain).reshape(-1).index_add_(
        0, eng.asm_dst_flat, (eng.asm_w * (d * d)[eng.asm_k]).abs())
    err = (t1 - plain).abs().reshape(-1)
    err[sched.run_dst[lengths > 32].long()] = 0.0
    assert bool((err <= 8 * EPS32 * mag).all())


def test_solve_sparse_afiro_on_the_card(dev):
    import cholesky_is_magic_tpu_torch as cimt

    before = (chol_cuda.LAUNCHES["potrf_tile"],
              tiled_cuda.LAUNCHES["assemble_pairs"])
    rep = cimt.solve(AFIRO, "pdas_dd", sparse=True, block=16, device="cuda",
                     max_iters=300)
    assert chol_cuda.LAUNCHES["potrf_tile"] > before[0]
    assert tiled_cuda.LAUNCHES["assemble_pairs"] > before[1]
    assert abs(rep.objective + 464.75314285714285) <= 1e-5 * 464.75314285714285


def test_solve_sparse_block_256_on_the_card(dev):
    """The tile engine at block 256 (tiles split around the tile kernel):
    the same status as the CPU run, the known optimum within 1e-5."""
    import cholesky_is_magic_tpu_torch as cimt
    from cholesky_is_magic_tpu_torch.utils.testing import constructed_optimum_lp

    sf, info = constructed_optimum_lp(m=300, seed=4)
    kw = dict(sparse=True, block=256, dtype=torch.float32)
    before = chol_cuda.LAUNCHES["potrf_tile"]
    rep = cimt.solve(sf, "pdas_dd", device="cuda", **kw)
    assert chol_cuda.LAUNCHES["potrf_tile"] > before
    ref = cimt.solve(sf, "pdas_dd", device="cpu", **kw)
    assert rep.status == ref.status
    ref_obj = info["objective"]
    assert abs(rep.objective - ref_obj) <= 1e-5 * (1.0 + abs(ref_obj))


def test_crossover_afiro_dense_on_the_card(dev):
    """solve(afiro, "pdas_dd", crossover=True) in f32 on the card: a
    certified vertex (certificate gap < 1e-9), the published optimum within
    2e-6; the crossover's own double-word products launch both dd kernels."""
    import cholesky_is_magic_tpu_torch as cimt
    from cholesky_is_magic_tpu_torch.ingest.device import to_device_lp
    from cholesky_is_magic_tpu_torch.solvers import (
        PDASConfig,
        crossover,
        make_pdas,
        pdas,
    )

    rep = cimt.solve(AFIRO, "pdas_dd", crossover=True, pad_multiple=32)
    cert = rep.summary["crossover"]
    assert cert["certified"] and cert["gap"] < 1e-9, cert
    assert abs(rep.objective + 464.75314285714285) <= 2e-6 * 464.75314285714285
    # The crossover alone, from a pdas stop: its launches, and never worse.
    sf = cimt.to_standard_form(cimt.read_mps_file(AFIRO))
    st = make_pdas(to_device_lp(sf, pad_multiple=32, device=dev))
    res = pdas(st, PDASConfig(gap_tol=1e-4))
    before = _counts()
    out = crossover(res, st.lp)
    launched = {k: v - before[k] for k, v in _counts().items()}
    assert launched["mv"] > 0 and launched["rmv"] > 0
    if out.extra["crossover"]["certified"]:
        assert abs(float(out.objective) + 464.75314285714285) <= 2e-6 * 464.75314285714285
    else:
        assert out.x is res.x and int(out.status) == int(res.status)


def test_crossover_afiro_sparse_on_the_card(dev):
    """sparse=True, block 16: certified, within 1e-5; each repair pass's
    B·Bᵀ factorization launches the tile and assembly kernels."""
    import cholesky_is_magic_tpu_torch as cimt

    before = _counts()
    rep = cimt.solve(AFIRO, "pdas_dd", sparse=True, block=16, crossover=True)
    launched = {k: v - before[k] for k, v in _counts().items()}
    assert launched["potrf_tile"] > 0 and launched["assemble_pairs"] > 0
    assert rep.summary["crossover"]["certified"]
    assert abs(rep.objective + 464.75314285714285) <= 1e-5 * 464.75314285714285


def test_crossover_sparse_afiro_in_float64_on_the_card(dev):
    """f64 on the card takes the plain forms (no launch) and the same
    repair decisions as the CPU."""
    import cholesky_is_magic_tpu_torch as cimt

    kw = dict(sparse=True, block=16, crossover=True, dtype=torch.float64)
    before = _counts()
    rep = cimt.solve(AFIRO, "pdas_dd", device="cuda", **kw)
    assert _counts() == before
    cpu = cimt.solve(AFIRO, "pdas_dd", device="cpu", **kw)
    for k in ("certified", "repairs", "widened", "n_basic", "n_lower", "n_upper"):
        assert rep.summary["crossover"][k] == cpu.summary["crossover"][k], k
    assert rep.summary["crossover"]["certified"] and rep.result.x.is_cuda
    assert abs(rep.objective + 464.75314285714285) <= 1e-9 * 464.75314285714285


WIDEN_MPS = """NAME          WIDEN
ROWS
 N  COST
 E  R1
 E  R2
 E  R3
COLUMNS
    X1        COST      1.0        R1        1.0
    X2        COST      2.0        R1        1.0
    X2        R2        1.0        R3        1.0
    X3        COST      1.0        R2        1.0
RHS
    RHS       R1        1.0005     R2        1.0005
    RHS       R3        0.0005
BOUNDS
 UP BND       X1        2.0
 UP BND       X2        2.0
 UP BND       X3        2.0
ENDATA
"""


def test_crossover_widen_fixture_on_the_card(dev, monkeypatch):
    """tests/test_crossover.py's widen fixture (x2 misread as at-lower by a
    stale 2e-3 dual): the first basis leaves row 3 empty, so its B·Bᵀ is
    singular and the dbound retry factors it; one widen pass certifies."""
    import cholesky_is_magic_tpu_torch as cimt
    from cholesky_is_magic_tpu_torch.ingest.device import to_device_lp
    from cholesky_is_magic_tpu_torch.ingest.mps import read_mps_string
    from cholesky_is_magic_tpu_torch.ops import dense
    from cholesky_is_magic_tpu_torch.solvers import SolveResult, Status, crossover

    oks = []
    factorize = dense.factorize

    def recorded(N, *args, **kwargs):
        f = factorize(N, *args, **kwargs)
        oks.append(bool(f.ok))
        return f

    monkeypatch.setattr(dense, "factorize", recorded)
    sf = cimt.to_standard_form(read_mps_string(WIDEN_MPS))
    lp = to_device_lp(sf, pad_multiple=4, device=dev)
    pad = lambda v: torch.tensor(v + [0.0] * (4 - len(v)), device=dev)  # noqa: E731
    x = pad([1.0, 5e-4, 1.0])
    res = SolveResult(
        x=x, objective=torch.dot(lp.c, x),
        status=torch.tensor(Status.OPTIMAL, dtype=torch.int32),
        iterations=torch.tensor(10, dtype=torch.int32),
        residual_norm=torch.tensor(0.0, device=dev),
        extra={"y": pad([1.0, 1.0, 0.0]), "w": torch.zeros(4, device=dev),
               "z": pad([0.0, 2e-3, 0.0]), "gap": torch.tensor(1e-6)},
    )
    out = crossover(res, lp)
    cert = out.extra["crossover"]
    assert oks[:2] == [False, True]  # singular, then the dbound retry
    assert cert["certified"] and cert["widened"] == 1 and cert["repairs"] >= 1
    assert float(out.objective) == pytest.approx(2.001, rel=1e-6)
    assert float(out.x[1]) == pytest.approx(5e-4, rel=1e-3)


SIMPLE = os.path.join(os.path.dirname(__file__), "fixtures", "simple.mps")


def test_alm_simple_in_float32_on_the_card(dev):
    """solve(simple, "alm") in f32 (the JAX package on the CPU: 4 / 65):
    optimal, value -7 within the JAX tests' 1e-2; the f32 products are
    library calls, so no kernel launches."""
    import cholesky_is_magic_tpu_torch as cimt

    before = _counts()
    rep = cimt.solve(SIMPLE, "alm", pad_multiple=16, max_iters=300)
    launched = {k: v - before[k] for k, v in _counts().items()}
    print(f"f32 simple alm: {rep.summary}")
    assert rep.status == "optimal"
    assert rep.summary["value"] == pytest.approx(-7.0, abs=1e-2)
    assert not any(launched.values())
    assert rep.result.x.is_cuda and rep.result.x.dtype == torch.float32


def test_dense_dd_alm_launches_the_dd_kernels_exactly(dev):
    """ALMConfig(dd_gradient=True) on dense f32 afiro: each inner iteration
    run launches dd A·x and dd Aᵀ·x twice (the gradients at y and z'), each
    outer step dd A·x twice more (the residuals at entry and at z): the
    counts are 2·run + 2·outer and 2·run, where run counts the masked tail
    of each stopped inner loop's last chunk too."""
    import cholesky_is_magic_tpu_torch as cimt
    from cholesky_is_magic_tpu_torch.ingest.device import to_device_lp
    from cholesky_is_magic_tpu_torch.solvers import ALMConfig, alm, make_alm

    lp = to_device_lp(cimt.to_standard_form(cimt.read_mps_file(AFIRO)),
                      pad_multiple=16, device=dev)
    before = _counts()
    res = alm(make_alm(lp), config=ALMConfig(
        max_outer=4, inner_iters=300, violation_tol=1e-5, pg_tol=1e-5,
        omega_floor=1e-7, dd_gradient=True))
    launched = {k: v - before[k] for k, v in _counts().items()}
    outer, run = int(res.outer_iterations), res.inner_slots
    print(f"dense dd alm afiro: outer {outer}, inner {int(res.inner_iterations)},"
          f" run {run}, launches {launched}")
    assert outer == 4 and run >= int(res.inner_iterations) > 0
    assert launched["mv"] == 2 * run + 2 * outer
    assert launched["rmv"] == 2 * run
    assert torch.isfinite(res.x).all() and res.x.dtype == torch.float32


def test_alm_in_float64_on_the_card_launches_nothing(dev):
    """f64 ALM on afiro (pad 16) takes the plain forms on the card: no
    kernel launches; optimal, its value within 2e-3 of the published
    optimum (the JAX package on the CPU: 9 / 1768)."""
    import cholesky_is_magic_tpu_torch as cimt

    before = _counts()
    rep = cimt.solve(AFIRO, "alm", pad_multiple=16, max_iters=60,
                     dtype=torch.float64)
    launched = {k: v - before[k] for k, v in _counts().items()}
    print(f"f64 afiro alm: {rep.summary}")
    assert not any(launched.values())
    assert rep.status == "optimal"
    assert rep.summary["value"] == pytest.approx(-464.75314285714285, abs=2e-3)
    assert rep.result.x.is_cuda and rep.result.x.dtype == torch.float64


def test_sparse_alm_two_phase_on_the_card(dev):
    """The two-phase protocol on the m = 2048 constructed LP's block-ELL
    operands, at a bounded budget: an f32 phase, then the dd phase from its
    multipliers with mu reset to 100.  Both run on the block-ELL products
    (plain PyTorch: no kernel launches), finite, the dd phase's violation
    below the f32 phase's."""
    import dataclasses

    from cholesky_is_magic_tpu_torch.ingest.device import to_sparse_lp
    from cholesky_is_magic_tpu_torch.solvers import ALMConfig, alm, make_alm
    from cholesky_is_magic_tpu_torch.utils.testing import constructed_optimum_lp

    sf, info = constructed_optimum_lp(m=2048, seed=0)
    lp = to_sparse_lp(sf, device=dev)
    assert lp.EB is not None and lp.ETB is not None
    cfgA = ALMConfig(max_outer=3, inner_iters=300, violation_tol=1e-5,
                     pg_tol=1e-5, omega_floor=1e-6)
    cfgB = dataclasses.replace(cfgA, dd_gradient=True, omega_floor=1e-7,
                               max_outer=2, inner_iters=100)
    before = _counts()
    resA = alm(make_alm(lp), config=cfgA)
    resB = alm(make_alm(lp, mu=100.0, multipliers=resA.multipliers),
               x0=resA.x, config=cfgB)
    launched = {k: v - before[k] for k, v in _counts().items()}
    err = abs(float(lp.c @ resB.x) - info["objective"]) / abs(info["objective"])
    print(f"sparse alm m = 2048: f32 violation {float(resA.violation):.3e},"
          f" dd violation {float(resB.violation):.3e}, objective error {err:.3e}")
    assert not any(launched.values())
    assert int(resB.outer_iterations) == 2
    assert torch.isfinite(resB.x).all()
    assert float(resB.violation) < float(resA.violation)


@pytest.mark.parametrize("kind", ["dense f32", "dense dd", "block-ELL f32", "block-ELL dd"])
def test_chunk_graph_replays_the_eager_loop(dev, monkeypatch, kind):
    """On the card the inner loop replays its chunks as a CUDA graph after
    one eager chunk (solvers.approx._ChunkGraph).  An ALM run with the
    graphs gives the eager run's iterate, multipliers, violation, pg and
    counts bit for bit, and the dd kernels' counters the same launches:
    each replay adds the launches the capture holds."""
    import importlib

    import cholesky_is_magic_tpu_torch as cimt
    from cholesky_is_magic_tpu_torch.ingest.device import to_device_lp, to_sparse_lp
    from cholesky_is_magic_tpu_torch.solvers import ALMConfig, alm, make_alm
    from cholesky_is_magic_tpu_torch.utils.testing import constructed_optimum_lp

    am = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.approx")
    if kind.startswith("dense"):
        lp = to_device_lp(cimt.to_standard_form(cimt.read_mps_file(AFIRO)),
                          pad_multiple=16, device=dev)
    else:
        lp = to_sparse_lp(constructed_optimum_lp(m=256, seed=0)[0], device=dev)
    cfg = ALMConfig(max_outer=3, inner_iters=200, violation_tol=1e-5,
                    pg_tol=1e-5, omega_floor=1e-7, dd_gradient=kind.endswith("dd"))

    def run():
        before = _counts()
        res = alm(make_alm(lp), config=cfg)
        return res, {k: v - before[k] for k, v in _counts().items()}

    captured = []
    init = am._ChunkGraph.__init__
    monkeypatch.setattr(am._ChunkGraph, "__init__",
                        lambda self, *a: (captured.append(1), init(self, *a))[1])
    g, gl = run()
    monkeypatch.setattr(am, "_GRAPHS", False)
    e, el = run()
    print(f"{kind}: inner {int(g.inner_iterations)}, run {g.inner_slots},"
          f" graphs {len(captured)}, launches {gl}")
    assert captured and gl == el
    assert g.inner_slots == e.inner_slots
    for key in ("x", "multipliers", "violation", "pg", "value", "outer_iterations",
                "inner_iterations"):
        assert torch.equal(getattr(g, key), getattr(e, key)), key


def _lane_inputs(rng, B, m, n, offset, dev):
    """(B, m, n) A whose storage starts ``offset`` floats in (so with an odd
    n no lane or row starts on a 16-byte boundary), (B, n) x, (B, m) y."""
    buf = rng.normal(size=B * m * n + offset).astype(np.float32)
    A = torch.from_numpy(buf).to(dev)[offset:].view(B, m, n)
    x = torch.from_numpy(rng.normal(size=(B, n)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.normal(size=(B, m)).astype(np.float32)).to(dev)
    return A, x, y


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("B,m,n,shared", [
    pytest.param(B, m, n, shared,
                 id="-".join(map(str, (B, m, n))) + (f"-{shared}" if shared else ""))
    for B, m, n, shared in [(1, 64, 64, None), (5, 37, 91, None), (64, 64, 128, None),
                            (3, 1441, 5093, None), (1024, 64, 64, None), (256, 64, 192, None),
                            (256, 64, 128, "shared A"), (9, 37, 91, "shared x and y"),
                            (4, 544, 128, "shared A")]])
def test_batched_kernels_equal_the_single_kernels_per_lane(dev, B, m, n, shared, offset):
    """Each lane of one batched launch is the single launch on that lane, bit
    for bit, and within 64·eps32² of Σ|a_ij x_j| of the plain batched form;
    the batched Aᵀ·x also bit for bit its order (the batched
    ``rmv_slab_plain``); A, or x and y, shared by every lane at lane stride 0
    too; one count per batched launch, none on the single counters."""
    A, x, y = _lane_inputs(np.random.default_rng(B + m + n), B, m, n, offset, dev)
    if shared == "shared A":
        A = A[0].expand(B, m, n)
    elif shared:
        x, y = x[0].expand(B, n), y[0].expand(B, m)
    before = dict(dd_cuda.LAUNCHES)
    mv, rmv = dd_cuda.dd_mv_batched(A, x), dd_cuda.dd_rmv_batched(A, y)
    assert dd_cuda.LAUNCHES["mv_batched"] == before["mv_batched"] + 1
    assert dd_cuda.LAUNCHES["rmv_batched"] == before["rmv_batched"] + 1
    assert dd_cuda.LAUNCHES["mv"] == before["mv"]
    for k in range(B):
        one, rone = dd_cuda.dd_mv(A[k], x[k]), dd_cuda.dd_rmv(A[k], y[k])
        assert torch.equal(mv[0][k], one[0]) and torch.equal(mv[1][k], one[1])
        assert torch.equal(rmv[0][k], rone[0]) and torch.equal(rmv[1][k], rone[1])
    order = _rmv_slab_order(A, y)
    assert torch.equal(rmv[0], order.hi) and torch.equal(rmv[1], order.lo)
    for got, plain, scale in (
        (mv, ddm._dd_matvec_plain(A, x), (A.abs() @ x.abs().unsqueeze(-1))[..., 0]),
        (rmv, ddm._dd_matvec_plain(A.mT, y),
         (A.abs().mT @ y.abs().unsqueeze(-1))[..., 0]),
    ):
        err = np.abs(_f64(ddm.DD(*got)) - _f64(plain))
        assert np.all(err <= 64 * EPS32**2 * scale.double().cpu().numpy())


@pytest.mark.parametrize("shared_x", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("B,m,n", [(3, 5, 1), (1024, 64, 64), (9, 37, 91),
                                   (4, 64, dd_cuda.MV_SHORT_MAX),
                                   (4, 64, dd_cuda.MV_SHORT_MAX + 1), (2, 300, 2000)])
def test_dd_mv_kernels_equal_their_summation_order(dev, B, m, n, offset, shared_x):
    """Both dd A·x kernels (short rows up to MV_SHORT_MAX columns, a block
    per row beyond) equal ``dd_cuda.mv_order_plain`` bit for bit, batched
    and single, with A's lanes and rows off a 16-byte boundary and x shared
    by every lane at lane stride 0."""
    A, x, _ = _lane_inputs(np.random.default_rng(B + m + n), B, m, n, offset, dev)
    if shared_x:
        x = x[0].expand(B, n)
    want = dd_cuda.mv_order_plain(A, x)
    got = dd_cuda.dd_mv_batched(A, x)
    assert torch.equal(got[0], want.hi) and torch.equal(got[1], want.lo)
    for k in range(min(B, 4)):
        one = dd_cuda.dd_mv(A[k], x[k].contiguous())
        assert torch.equal(one[0], want.hi[k]) and torch.equal(one[1], want.lo[k])


def test_batched_kernels_under_vmap_and_at_the_lane_limit(dev):
    """torch.func.vmap of the dispatchers takes one batched launch each
    (an unbatched A shared by every lane too); more than 65535 lanes
    raise."""
    A, x, y = _lane_inputs(np.random.default_rng(2), 4, 33, 70, 1, dev)
    before = dict(dd_cuda.LAUNCHES)
    vm = torch.func.vmap(ddm.dd_matvec)(A, x)
    vr = torch.func.vmap(ddm.dd_rmatvec, in_dims=(None, 0))(A[0], y)
    assert dd_cuda.LAUNCHES["mv_batched"] == before["mv_batched"] + 1
    assert dd_cuda.LAUNCHES["rmv_batched"] == before["rmv_batched"] + 1
    for k in range(4):
        assert torch.equal(vm.hi[k], ddm.dd_matvec(A[k], x[k]).hi)
        assert torch.equal(vr.lo[k], ddm.dd_rmatvec(A[0], y[k]).lo)
    big = torch.zeros(65536, 1, 1, device=dev)
    with pytest.raises(ValueError, match="65535"):
        dd_cuda.dd_mv_batched(big, big[:, 0])
    with pytest.raises(ValueError, match="65535"):
        dd_cuda.dd_rmv_batched(big, big[:, 0])
    edge = torch.zeros(65535, 1, 1, device=dev)
    hi, _ = dd_cuda.dd_rmv_batched(edge, edge[:, 0])
    torch.cuda.synchronize()
    assert hi.shape == (65535, 1)


def _batch_problems():
    from cholesky_is_magic_tpu_torch.utils.testing import random_lp, write_mps
    from cholesky_is_magic_tpu_torch.ingest.mps import read_mps_string
    import cholesky_is_magic_tpu_torch as cimt

    return [cimt.to_standard_form(read_mps_string(write_mps(
        random_lp(60 + s, n_ub=8 + 2 * s, n_eq=2, n=12 + s)))) for s in range(6)]


def test_solve_batch_in_float64_on_the_card_equals_the_cpu(dev):
    """f64 solve_batch on the card takes the plain forms (no launch) and
    each lane's status and count of the CPU's, the objective within 1e-9."""
    import cholesky_is_magic_tpu_torch as cimt

    sfs = _batch_problems()
    kw = dict(pad_multiple=16, max_iters=200, dtype=torch.float64)
    before = _counts()
    card = cimt.solve_batch(sfs, **kw)
    assert _counts() == before
    cpu = cimt.solve_batch(sfs, device="cpu", **kw)
    for a, b in zip(card, cpu):
        assert a.status == b.status == "optimal"
        assert a.summary["iterations"] == b.summary["iterations"]
        assert a.objective == pytest.approx(b.objective, rel=1e-9)


def test_batched_two_phase_in_float32_launches_the_batched_kernels(dev):
    """f32 on the card: solve_batch and batched_pdas launch batched dd A·x
    (their refinement residuals), batched_pdas_dd both batched kernels, and
    none of them a single launch; every lane optimal in phase 1 reaches gap
    <= 1e-8."""
    import importlib

    import cholesky_is_magic_tpu_torch as cimt
    from cholesky_is_magic_tpu_torch import parallel
    from cholesky_is_magic_tpu_torch.utils import lanes

    pdas = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas")
    pdas_dd = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas_dd")
    emb = cimt.embed_batch(_batch_problems(), pad_multiple=16)
    before = dict(dd_cuda.LAUNCHES)
    reps = cimt.solve_batch(emb, max_iters=200)
    assert dd_cuda.LAUNCHES["mv_batched"] > before["mv_batched"]
    assert all(r.status == "optimal" for r in reps)
    lps = [lanes.lane(emb.stacked_lp, k) for k in range(len(reps))]
    p1 = parallel.batched_pdas(
        parallel.stack_states([pdas.make_pdas(lp) for lp in lps]),
        pdas.PDASConfig(max_iters=200, factor_method="inverse"))
    assert (p1.status == 1).all()
    states = parallel.stack_states([
        pdas_dd.make_pdas_dd(lp, warm=lanes.lane(p1, k))
        for k, lp in enumerate(lps)])
    mid = dict(dd_cuda.LAUNCHES)
    res = parallel.batched_pdas_dd(states, pdas.PDASConfig(
        max_iters=200, gap_tol=1e-9, refine_steps=2))
    got = {k: dd_cuda.LAUNCHES[k] - mid[k] for k in mid}
    assert got["mv_batched"] > 0 and got["rmv_batched"] > 0
    assert got["mv"] == got["rmv"] == 0
    assert float(res.extra["gap"].max()) <= 1e-8
    assert dd_cuda.LAUNCHES["mv"] == before["mv"]


@pytest.mark.parametrize("B,b", [(B, b) for B in (1, 8, 32, 140) for b in (16, 33, 100, 128)]
                         + [(3, 33), (5, 16)])
def test_batched_tile_kernel_equals_single_launches(dev, B, b):
    """Every lane of one batched tile-kernel launch is the single launch on
    that tile, bit for bit (a tile read at a lane stride inside a larger
    array too; more lanes than the card has SMs), and the single launch in
    place too, under vmap of the operator as well; a non-PD lane is all NaN
    alone; one count per batched launch."""
    rng = np.random.default_rng(B * b)
    M = rng.normal(size=(B, b, b))
    N = torch.tensor(M @ np.swapaxes(M, 1, 2) / b + np.eye(b), dtype=torch.float32,
                     device=dev)
    N[B - 1, 2, 2] = -1.0
    big = torch.zeros(B, b + 3, b + 5, device=dev)
    big[:, 1:b + 1, 2:b + 2] = N
    for T in (N, big[:, 1:b + 1, 2:b + 2]):
        before = dict(chol_cuda.LAUNCHES)
        L, inv = chol_cuda.potrf_tile_batched(T)
        assert chol_cuda.LAUNCHES["potrf_tile_batched"] == before["potrf_tile_batched"] + 1
        assert chol_cuda.LAUNCHES["potrf_tile"] == before["potrf_tile"]
        for k in range(B):
            Lk, Ik = chol_cuda.potrf_tile(N[k])
            for got, want in ((L[k], Lk), (inv[k], Ik)):
                torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
        assert bool(torch.isnan(L[B - 1]).all()) and bool(torch.isfinite(L[:B - 1]).all())
    for k in range(min(B, 8)):
        T, Ik = N[k].clone(), torch.empty_like(N[k])
        chol_cuda.potrf_tile_(T, Ik)
        torch.testing.assert_close(T, L[k], rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(Ik, inv[k], rtol=0, atol=0, equal_nan=True)
    vm = torch.func.vmap(chol.factor_tile_op)(N)
    torch.testing.assert_close(vm[0], L, rtol=0, atol=0, equal_nan=True)
    if B > 1:
        Lp, _ = chol._factor_tile_plain(N[:B - 1])
        assert float((L[:B - 1] - Lp).abs().max()) <= 64 * EPS32 * float(Lp.abs().max())


def _at_scale_engine(dev):
    import scipy.sparse as sp

    from cholesky_is_magic_tpu_torch.ingest.standard_form import scale_constraints
    from cholesky_is_magic_tpu_torch.utils.testing import constructed_optimum_lp

    sf, _ = constructed_optimum_lp(m=16384, seed=0)
    vals, _ = scale_constraints(sf.a_rows, sf.a_vals, sf.b)
    A = sp.csc_matrix((vals, (sf.a_rows, sf.a_cols)), shape=(sf.ncons, sf.nvars))
    return tiled.engine_for_sparse(A, block=128, device=dev), sf


@pytest.mark.parametrize("where", ["small", "m=16384"])
def test_batched_assembly_equals_single_launches(dev, where):
    """Every lane of one batched assembly launch is the single launch on
    that lane's d and boost, bit for bit, with a boost per lane or one
    shared; the plain version on the lane axis agrees (each entry within
    8·eps32·Σ|w·d²|, bit for bit where it sums in the kernel's order)."""
    rng = np.random.default_rng(4)
    if where == "small":
        m, n = 150, 260
        A = (rng.random((m, n)) < 0.04) * rng.normal(size=(m, n))
        A[np.arange(m), np.arange(m)] += 2.0
        eng, B = tiled.engine_for_sparse(A, block=33, device=dev), 6
    else:
        eng, sf = _at_scale_engine(dev)
        m, n, B = sf.ncons, sf.nvars, 4
    D = torch.tensor(10.0 ** (3 * rng.random((B, n)) - 1.5), dtype=torch.float32,
                     device=dev)
    bo = torch.tensor((rng.random((B, m)) < 0.1) * 0.5, dtype=torch.float32, device=dev)
    before = dict(tiled_cuda.LAUNCHES)
    tb = tiled_cuda.assemble_pairs_batched(eng, D, bo)
    ts = tiled_cuda.assemble_pairs_batched(eng, D, bo[0])
    assert tiled_cuda.LAUNCHES["assemble_pairs_batched"] == before["assemble_pairs_batched"] + 2
    for k in range(B):
        assert torch.equal(tb[k], tiled_cuda.assemble_pairs(eng, D[k], bo[k]))
        assert torch.equal(ts[k], tiled_cuda.assemble_pairs(eng, D[k], bo[0]))
    assert torch.equal(torch.func.vmap(
        lambda d, r: eng.assemble_pairs(d, r, per_lane=True))(D, bo), tb)
    assert torch.equal(eng._assemble_pairs_plain(D, bo), tb)


def test_batched_sparse_pdas_on_the_card(dev):
    """Three afiro-sized LPs of one A with their own (b, c)
    (tests/test_parallel.py's family, block 16, f32): the batched sparse
    pdas launches the batched tile and assembly kernels and no single one;
    every lane optimal (the JAX test's f32 bar), within 1e-3 of its single
    solve on the same engine."""
    import importlib

    import cholesky_is_magic_tpu_torch as cimt
    from cholesky_is_magic_tpu_torch import parallel
    from cholesky_is_magic_tpu_torch.ingest.mps import read_mps_string
    from cholesky_is_magic_tpu_torch.utils.testing import random_lp, write_mps

    pdas = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas")
    base = random_lp(11, n_ub=24, n_eq=6, n=32, bounded=True)
    sfs = []
    for i in range(3):
        rng = np.random.default_rng(1000 + i)
        x0 = base.l + (base.u - base.l) * (0.2 + 0.6 * rng.random(32))
        lane = dataclasses.replace(
            base, b_ub=base.A_ub @ x0 + 0.05 + rng.random(base.A_ub.shape[0]),
            b_eq=base.A_eq @ x0, c=rng.normal(size=32))
        sfs.append(cimt.to_standard_form(read_mps_string(write_mps(lane))))
    st0, eng = pdas.make_pdas_sparse(sfs[0], block=16, device=dev)
    states = [st0] + [pdas.make_pdas_sparse(s, block=16, engine=eng, device=dev)[0]
                      for s in sfs[1:]]
    cfg = pdas.PDASConfig(max_iters=200, refine_steps=2)
    before = _counts()
    res = parallel.batched_pdas(parallel.stack_sparse_states(states), cfg, engine=eng)
    got = {k: v - before[k] for k, v in _counts().items()}
    assert got["potrf_tile_batched"] > 0 and got["assemble_pairs_batched"] > 0
    assert got["potrf_tile"] == got["assemble_pairs"] == 0
    assert (res.status == 1).all()
    for k, st in enumerate(states):
        one = pdas.pdas(st, cfg, engine=eng)
        assert float(res.objective[k]) == pytest.approx(float(one.objective), rel=1e-3)


def test_solve_batch_slabbed_on_the_card(dev):
    """solve_batch(slab_iters=16) on 16 LPs in f32: every lane's status as
    the plain batch's, objectives within 1e-3 of it."""
    import cholesky_is_magic_tpu_torch as cimt
    from cholesky_is_magic_tpu_torch.ingest.mps import read_mps_string
    from cholesky_is_magic_tpu_torch.utils.testing import random_lp, write_mps

    sfs = [cimt.to_standard_form(read_mps_string(write_mps(
        random_lp(s, n_ub=12 + s % 5, n_eq=3, n=20 + s % 7)))) for s in range(16)]
    plain = cimt.solve_batch(sfs, pad_multiple=32, max_iters=200)
    slab = cimt.solve_batch(sfs, pad_multiple=32, max_iters=200, slab_iters=16)
    for a, b in zip(plain, slab):
        assert a.status == b.status
        assert b.objective == pytest.approx(a.objective, rel=1e-3, abs=1e-3)


def _afiro_dense(dev, dtype):
    import cholesky_is_magic_tpu_torch as cimt
    from cholesky_is_magic_tpu_torch.ingest.device import to_device_lp

    sf = cimt.to_standard_form(cimt.read_mps_file(AFIRO))
    return to_device_lp(sf, pad_multiple=32, dtype=dtype, device=dev)


@pytest.mark.parametrize("kind", ["tiled", "block sparse"])
def test_dense_a_engines_on_the_card(dev, kind):
    """A normal solve of afiro's equilibrated A by a dense-A engine in f32
    on the card: within 1e-5 of the same engine's f64 solve on the CPU;
    the tile kernel once per panel (the tile engine) or per diagonal tile
    (BlockSparseCholesky's potrf), dd A·x twice and Aᵀ·x once for the
    refinement step, no assembly kernel."""
    import scipy.sparse as sp

    from cholesky_is_magic_tpu_torch.solvers import make_pdas
    from cholesky_is_magic_tpu_torch.sparse import BlockSparseCholesky, analyze, engine_for

    lp = make_pdas(_afiro_dense(dev, torch.float32)).lp
    A, boost = lp.A, (~lp.row_mask).float()  # the padded rows' unit diagonal
    if kind == "tiled":
        make = lambda d: engine_for(A, block=16, device=d)  # noqa: E731
    else:
        plan = analyze(sp.csc_matrix(A.cpu().double().numpy()), block=16)
        make = lambda d: BlockSparseCholesky(plan, device=d)  # noqa: E731
    eng, host = make(dev), make("cpu")
    rng = np.random.default_rng(0)
    d = rng.random(A.shape[1]) + 0.5
    g = rng.normal(size=A.shape[0])
    before = {**dd_cuda.LAUNCHES, **chol_cuda.LAUNCHES, **tiled_cuda.LAUNCHES}
    y, ok = eng.solve_normal(A, torch.from_numpy(d).float().to(dev),
                             torch.from_numpy(g).float().to(dev), row_boost=boost,
                             refine_steps=1)
    got = {k: v - before[k] for k, v in
           {**dd_cuda.LAUNCHES, **chol_cuda.LAUNCHES, **tiled_cuda.LAUNCHES}.items()}
    ref, ok_ref = host.solve_normal(A.cpu().double(), torch.from_numpy(d),
                                    torch.from_numpy(g), row_boost=boost.cpu().double(),
                                    refine_steps=1)
    assert bool(ok) and bool(ok_ref)
    assert float((y.cpu().double() - ref).norm() / ref.norm()) <= 1e-5
    panels = eng.B if kind == "tiled" else eng.n_tiles
    assert (got["potrf_tile"], got["mv"], got["rmv"], got["assemble_pairs"]) == (
        panels, 2, 1, 0)


def test_dense_engine_and_gondzio_in_float64_on_the_card_equal_the_cpu(dev):
    """pdas_dd with Gondzio's correctors on afiro's dense state with a
    dense-A engine, in f64 on the card: the CPU's status and count, no
    kernel launched (f64 takes the plain forms)."""
    from cholesky_is_magic_tpu_torch.solvers import PDASConfig, make_pdas, pdas
    from cholesky_is_magic_tpu_torch.solvers.pdas_dd import make_pdas_dd, pdas_dd
    from cholesky_is_magic_tpu_torch.sparse import engine_for

    cfg1 = PDASConfig(max_iters=300, refine_steps=2, mehrotra=True, gondzio_correctors=2)
    cfg2 = dataclasses.replace(cfg1, gap_tol=1e-9)
    out = {}
    for where in ("cuda", "cpu"):
        lp = _afiro_dense(where, torch.float64)
        eng = engine_for(make_pdas(lp).lp.A, block=16, device=where)
        before = sum({**dd_cuda.LAUNCHES, **chol_cuda.LAUNCHES}.values())
        r1 = pdas(make_pdas(lp), cfg1, engine=eng)
        r2 = pdas_dd(make_pdas_dd(lp, warm=r1), cfg2, engine=eng)
        assert sum({**dd_cuda.LAUNCHES, **chol_cuda.LAUNCHES}.values()) == before
        out[where] = (int(r1.iterations), int(r2.iterations), r2.status_name,
                      float(r2.objective))
    assert out["cuda"][:3] == out["cpu"][:3]
    assert out["cuda"][3] == pytest.approx(-464.75314285714285, rel=1e-9)


@pytest.fixture
def nccl_mesh(dev):
    """A process group of world size 1 on NCCL (a TCP store on 127.0.0.1)
    and ``lp_mesh(1, 1)`` over it; destroyed after the test."""
    import socket

    import torch.distributed as dist

    from cholesky_is_magic_tpu_torch.parallel import lp_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        yield lp_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def test_tp_solve_normal_ell_at_world_size_1(dev, nccl_mesh):
    """The m = 16384 engine's solve_normal_ell with ``mesh=`` at world size
    1 on NCCL: its assembly (K4 on rank 0's slab, the whole schedule) is
    bit-equal to the unsharded assembly, and the solve (K1 once per panel)
    within 1e-5 of the unsharded one."""
    from cholesky_is_magic_tpu_torch.ingest.standard_form import scale_constraints
    from cholesky_is_magic_tpu_torch.ops import sparse_ops

    eng, sf = _at_scale_engine(dev)
    vals, _ = scale_constraints(sf.a_rows, sf.a_vals, sf.b)
    m, n = sf.ncons, sf.nvars
    E = sparse_ops.from_coo(sf.a_rows, sf.a_cols, vals, (m, n), device=dev)
    ET = sparse_ops.from_coo(sf.a_cols, sf.a_rows, vals, (n, m), device=dev)
    rng = np.random.default_rng(14)
    d = torch.tensor(rng.random(n) + 0.5, dtype=torch.float32, device=dev)
    g = torch.tensor(rng.normal(size=m), dtype=torch.float32, device=dev)
    boost = torch.zeros(m, dtype=torch.float32, device=dev)
    assert torch.equal(eng.assemble_pairs_tp(nccl_mesh, d, boost),
                       eng.assemble_pairs(d, boost))
    before = _counts()
    y_tp, ok_tp = eng.solve_normal_ell(E, ET, d, g, refine_steps=1, mesh=nccl_mesh)
    got = {k: v - before[k] for k, v in _counts().items()}
    y, ok = eng.solve_normal_ell(E, ET, d, g, refine_steps=1)
    assert bool(ok_tp) and bool(ok)
    assert float((y_tp - y).norm() / y.norm()) <= 1e-5
    assert (got["assemble_pairs"], got["potrf_tile"]) == (1, eng.B)
    assert got["assemble_pairs_batched"] == got["potrf_tile_batched"] == 0


@pytest.mark.parametrize("ntp", [2, 4])
def test_slab_assembly_kernels_on_the_card(dev, ntp):
    """The tp mode's assembly on the m = 16384 schedule without a process
    group: each rank's slab by the assembly kernel over the slab's own
    schedule is bit-equal to the plain slab assembly, only rank 0's carries
    the boost, and the slabs sum to the whole assembly within
    8·eps32·Σ|w·d²| per entry (a run cut by a slab boundary is summed in
    two parts)."""
    eng, sf = _at_scale_engine(dev)
    rng = np.random.default_rng(15)
    d = torch.tensor(rng.random(sf.nvars) + 0.5, dtype=torch.float32, device=dev)
    boost = torch.tensor((rng.random(sf.ncons) < 0.1) * 0.5, dtype=torch.float32,
                         device=dev)
    parts = []
    for rank in range(ntp):
        slab = eng._slab(ntp, rank)
        assert slab.boost == (rank == 0)
        tiles = tiled_cuda.assemble_pairs(eng, d, boost, slab.kernel)
        assert torch.equal(tiles, eng._assemble_pairs_plain(d, boost, slab))
        parts.append(tiles)
    whole = eng.assemble_pairs(d, boost)
    absw = torch.zeros_like(whole).view(-1).index_add_(
        0, eng.asm_dst_flat, (eng.asm_w * d[eng.asm_k] ** 2).abs())
    err = (sum(parts) - whole).abs().view(-1)
    assert bool((err <= 8 * EPS32 * absw).all())


def test_dense_a_engine_batch_on_the_card(dev):
    """A batch of 4 dense states of one A (the family of
    tests/test_parallel.py:321-329, block 16, f32) on engine_for: each
    lane's assembled tiles within 1e-6 (relative to the largest entry) of
    the single engine's assembly of that lane (a batched matmul may round
    apart); on those tiles the batched tile kernel gives each lane the
    single launch's factor and inverse bit for bit; batched pdas then
    pdas_dd on the engine launch the batched tile and dd kernels and no
    single one, every lane at its single solve's status (or a finisher at
    the f32 precision floor where its twin is optimal, held as
    chip_smoke.py phase 18 (d) holds it), the objective within 1e-6."""
    import importlib

    import cholesky_is_magic_tpu_torch as cimt
    from cholesky_is_magic_tpu_torch import parallel
    from cholesky_is_magic_tpu_torch.ingest.device import to_device_lp
    from cholesky_is_magic_tpu_torch.ingest.mps import read_mps_string
    from cholesky_is_magic_tpu_torch.sparse import engine_for
    from cholesky_is_magic_tpu_torch.utils import lanes
    from cholesky_is_magic_tpu_torch.utils.testing import random_lp, write_mps

    pdas = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas")
    dd = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas_dd")
    base = random_lp(11, n_ub=24, n_eq=6, n=32, bounded=True)
    lps = []
    for i in range(4):
        rng = np.random.default_rng(1000 + i)
        x0 = base.l + (base.u - base.l) * (0.2 + 0.6 * rng.random(32))
        lane = dataclasses.replace(
            base, b_ub=base.A_ub @ x0 + 0.05 + rng.random(base.A_ub.shape[0]),
            b_eq=base.A_eq @ x0, c=rng.normal(size=32))
        sf = cimt.to_standard_form(read_mps_string(write_mps(lane)))
        lps.append(to_device_lp(sf, pad_multiple=16, dtype=torch.float32, device=dev))
    states = [pdas.make_pdas(lp) for lp in lps]
    eng = engine_for(states[0].lp.A, block=16, device=dev)
    A = torch.stack([st.lp.A for st in states])
    D = torch.tensor(np.random.default_rng(2).random((4, A.shape[2])) + 0.5,
                     dtype=torch.float32, device=dev)
    boost = (~states[0].lp.row_mask).float()  # the padded rows' unit diagonal
    batched = lanes.vmap(lambda a, v: eng.assemble(a, v, boost), A, D)
    for k in range(4):
        one = eng.assemble(A[k], D[k], boost)
        assert float((batched[k] - one).abs().max() / one.abs().max()) <= 1e-6
    for t in eng._diag_ids_np:
        T = batched[:, int(t)].contiguous()
        L, X = chol_cuda.potrf_tile_batched(T)
        for k in range(4):
            L1, X1 = chol_cuda.potrf_tile(T[k])
            assert torch.equal(L[k], L1) and torch.equal(X[k], X1)
    c1 = pdas.PDASConfig(max_iters=200, refine_steps=2, mehrotra=True)
    c2 = pdas.PDASConfig(max_iters=300, gap_tol=1e-9, refine_steps=2, mehrotra=True)
    before = _counts()
    b1 = parallel.batched_pdas(parallel.stack_states(states), c1, engine=eng)
    b2 = parallel.batched_pdas_dd(parallel.stack_states(
        [dd.make_pdas_dd(lp, warm=lanes.lane(b1, k)) for k, lp in enumerate(lps)]),
        c2, engine=eng)
    got = {k: v - before[k] for k, v in _counts().items()}
    assert got["potrf_tile_batched"] > 0 and got["mv_batched"] > 0 and got["rmv_batched"] > 0
    assert got["potrf_tile"] == got["mv"] == got["rmv"] == 0
    for k, lp in enumerate(lps):
        s1 = pdas.pdas(states[k], c1, engine=eng)
        s2 = dd.pdas_dd(dd.make_pdas_dd(lp, warm=s1), c2, engine=eng)
        assert int(b1.status[k]) == int(s1.status)
        st = {int(b2.status[k]), int(s2.status)}
        assert len(st) == 1 or st == {1, 5}  # optimal / precision floor
        assert float(b2.objective[k]) == pytest.approx(float(s2.objective), rel=1e-6)
