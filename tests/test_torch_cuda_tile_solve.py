"""The tile engine's solve kernel on the card (``csrc/tile_solve.cu``,
``sparse/tiled_cuda.py``), bit for bit against its own sums in plain
PyTorch (``tiled_cuda.tile_solve_plain``): batched, through
``TiledCholesky.solve`` under ``torch.func.vmap`` and on one lane alone, on
the engines of both tile-engine cells (pds-10's near-diagonal factor and
qap15's filled one) at block 128 and 256 with a NaN tile in one lane; at
every width the kernel takes on a small engine; lanes that are not
contiguous, shared operands; the launch counts, and what launches nothing
(float64, a width the kernel does not take).  Then a factor's raw solve by
the kernel against the plain loop, and a small fleet to each lane's exact
optimum with the same iteration counts on both routes.

Every test here needs an NVIDIA card and skips without one.  The file
imports no jax; run it on the card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_tile_solve.py -m cuda
"""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cholesky_is_magic_tpu_torch.sparse import tiled, tiled_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bit for bit (the sign of a zero too), NaNs in the same places."""
    g0, w0 = torch.nan_to_num(got), torch.nan_to_num(want)
    return (torch.equal(torch.isnan(got), torch.isnan(want)) and torch.equal(g0, w0)
            and torch.equal(torch.signbit(g0), torch.signbit(w0)))


@functools.lru_cache(maxsize=None)
def _engine(config: str, block: int):
    import chip_smoke

    return chip_smoke.cell_engine(config, block)


def _qap_engine(n: int, block: int):
    from lpbench.gen import qap_relaxation as qap

    rows, cols, vals, m, nn = qap.structure(n)
    A = sp.csc_matrix((vals, (rows, cols)), shape=(m, nn))
    return tiled.engine_for_sparse(A, block=block, device="cuda")


def _passes(eng):
    off = eng.NT - eng.B
    return (tiled_cuda.SolvePass(eng.fwd_ids, eng.fwd_j, eng.fwd_n, off),
            tiled_cuda.SolvePass(eng.rows_ids, eng.rows_i, eng.rows_n, off))


def _operands(eng, lanes, seed):
    import chip_smoke

    return chip_smoke.solve_operands(eng, lanes, seed)


def _nan_tile(eng):
    return next(int(eng.rows_ids[k, 0]) for k in range(eng.B) if eng._n_rows[k])


@pytest.mark.parametrize("config,block", [("pds-10", 128), ("qap15", 128), ("pds-10", 256),
                                          ("qap15", 256)])
def test_bit_equal_on_the_cells_engines(dev, config, block):
    eng = _engine(config, block)
    L, inv, rhs = _operands(eng, 3, 11)
    L[2, _nan_tile(eng)] = float("nan")
    fwd, bwd = _passes(eng)
    want = tiled_cuda.tile_solve_plain(L, inv, rhs, fwd, bwd)
    got = tiled_cuda._tile_solve_lanes(L, inv, rhs, fwd, bwd, "tile_solve_batched")
    assert _same_bits(got, want)
    assert torch.isnan(got[2]).any() and not torch.isnan(got[:2]).any()
    assert _same_bits(torch.func.vmap(eng.solve)(L, inv, rhs), want)
    for k in range(3):
        assert _same_bits(eng.solve(L[k], inv[k], rhs[k]), want[k])


@pytest.mark.parametrize("block", list(tiled_cuda.SOLVE_BLOCKS))
def test_every_width_the_kernel_takes(dev, block):
    """QAP8's relaxation at each width; one lane, a batch of 5, and the
    cluster sizes each takes."""
    eng = _qap_engine(8, block)
    fwd, bwd = _passes(eng)
    L, inv, rhs = _operands(eng, 5, block)
    want = tiled_cuda.tile_solve_plain(L, inv, rhs, fwd, bwd)
    assert _same_bits(tiled_cuda._tile_solve_lanes(L, inv, rhs, fwd, bwd, "tile_solve"), want)
    assert _same_bits(eng.solve(L[3], inv[3], rhs[3]), want[3])
    for lanes in (1, 5, 64):
        c = tiled_cuda.tile_solve_cluster(block, lanes)
        assert c in (1, 2, 4, 8) and block % c == 0 and (block // c) % 16 == 0
        assert block // c <= 128


def test_lanes_that_are_not_contiguous_and_shared_operands(dev):
    eng = _qap_engine(8, 128)
    L, inv, rhs = _operands(eng, 4, 5)
    fwd, bwd = _passes(eng)
    want = tiled_cuda.tile_solve_plain(L, inv, rhs, fwd, bwd)
    # Lanes on axis 1 of L and of the inverses: the vmap rule gets strided lanes.
    got = torch.func.vmap(eng.solve, in_dims=(1, 1, 0))(
        L.movedim(0, 1).contiguous(), inv.movedim(0, 1).contiguous(), rhs)
    assert _same_bits(got, want)
    # One factor for every right-hand side (L and inverses unbatched).
    want1 = tiled_cuda.tile_solve_plain(L[1], inv[1], rhs, fwd, bwd)
    got1 = torch.func.vmap(eng.solve, in_dims=(None, None, 0))(L[1], inv[1], rhs)
    assert _same_bits(got1, want1)


def test_launches_move_by_two_per_raw_solve(dev):
    eng = _qap_engine(8, 128)
    L, inv, rhs = _operands(eng, 3, 3)
    m = eng.plan.n
    r = rhs[:, :m]
    before = dict(tiled_cuda.LAUNCHES)
    eng.raw_solve(L[0], inv[0], r[0], m)
    assert tiled_cuda.LAUNCHES["tile_solve"] - before["tile_solve"] == 2
    torch.func.vmap(lambda x, i, g: eng.raw_solve(x, i, g, m))(L, inv, r)
    assert tiled_cuda.LAUNCHES["tile_solve_batched"] - before["tile_solve_batched"] == 2
    assert tiled_cuda.LAUNCHES["tile_solve"] - before["tile_solve"] == 2


def test_float64_and_other_widths_keep_the_loop(dev):
    before = dict(tiled_cuda.LAUNCHES)
    eng = _qap_engine(8, 128)
    L, inv, rhs = (x.double() for x in _operands(eng, 1, 2))
    y = eng.solve(L[0], inv[0], rhs[0])
    eng16 = _qap_engine(8, 16)
    L, inv, rhs = _operands(eng16, 1, 2)
    y16 = eng16.solve(L[0], inv[0], rhs[0])
    assert tiled_cuda.LAUNCHES == before
    assert torch.isfinite(y).all() and torch.isfinite(y16).all()


def test_a_factors_raw_solve_matches_the_loop(dev, monkeypatch):
    """QAP8 at block 128: the factor of a scaled normal matrix, one raw
    solve by the kernel and by the plain loop (the kernel's route turned
    off), within float32 rounding of each other, each with a residual
    under the solve tolerance of ``lpbench/normal_check.py``."""
    from cholesky_is_magic_tpu_torch.ingest.standard_form import scale_constraints
    from lpbench.gen import qap_relaxation as qap

    f = qap.fleet(8, 0, 1, lanes=1)
    vals, _ = scale_constraints(f.rows.astype(np.int32), f.vals, f.b[0])
    A = sp.csc_matrix((vals, (f.rows, f.cols)), shape=(f.m, f.n))
    eng = tiled.engine_for_sparse(A, block=128, device="cuda")
    rng = np.random.default_rng(3)
    d = torch.as_tensor(np.exp(rng.uniform(-1, 1, f.n)), dtype=torch.float32, device="cuda")
    # A boost of 1e-2 on every row (the relaxation's rows are dependent).
    L, inv, ok = eng.factorize(eng.assemble_pairs(d, torch.full((f.m,), 1e-2, device="cuda")))
    assert bool(ok)
    g = torch.as_tensor(rng.normal(size=f.m), dtype=torch.float32, device="cuda")
    y = eng.raw_solve(L, inv, g, f.m)
    monkeypatch.setattr(tiled_cuda, "takes_tile_solve", lambda *a: False)
    y_loop = eng.raw_solve(L, inv, g, f.m)
    A64 = A.toarray() * d.double().cpu().numpy()[None, :]
    N = A64 @ A64.T + 1e-2 * np.eye(f.m)
    for x in (y, y_loop):
        x64 = x.double().cpu().numpy()
        res = np.linalg.norm(N @ x64 - g.double().cpu().numpy())
        assert res / (np.linalg.norm(N) * np.linalg.norm(x64) + np.linalg.norm(g.cpu())) < 1e-6
    assert float((y - y_loop).norm() / y_loop.norm()) < 1e-4


def test_a_fleet_reaches_each_optimum_as_the_loop_does(dev, monkeypatch):
    """Four lanes of QAP8 through the batched pdas on one engine at block
    128, by the kernel and by the plain loop: every lane optimal on both
    routes, with the same iteration counts, and x within 1e-4 of the
    loop's (the raw solve is the refinement's preconditioner: the dd
    Richardson steps set the answer)."""
    from lpbench.gen import qap_relaxation as qap
    from lpbench.program import mod, optimal_status, standard_forms

    f = qap.fleet(8, 0, 1, lanes=4)
    pdas = mod("solvers.pdas")
    kw = dict(block=128, dtype=torch.float32, device="cuda")
    sfs = standard_forms(f)
    st0, eng = pdas.make_pdas_sparse(sfs[0], **kw)
    states = [st0] + [pdas.make_pdas_sparse(sf, engine=eng, **kw)[0] for sf in sfs[1:]]
    stacked = mod("parallel").stack_sparse_states(states)
    cfg = pdas.PDASConfig(max_iters=200, refine_steps=2, mehrotra=True)
    before = tiled_cuda.LAUNCHES["tile_solve_batched"]
    res = mod("parallel").batched_pdas(stacked, cfg, engine=eng)
    assert tiled_cuda.LAUNCHES["tile_solve_batched"] > before
    monkeypatch.setattr(tiled_cuda, "takes_tile_solve", lambda *a: False)
    res_loop = mod("parallel").batched_pdas(stacked, cfg, engine=eng)
    assert (res.status == optimal_status()).all() and (res_loop.status == optimal_status()).all()
    assert res.iterations.tolist() == res_loop.iterations.tolist()
    scale = 1 + res_loop.x.abs().max()
    assert float((res.x - res_loop.x).abs().max() / scale) < 1e-4
