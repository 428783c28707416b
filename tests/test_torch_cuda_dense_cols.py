"""Dense columns set apart from the tile engine's normal matrix, on the card:
the solve kernel's forward and backward passes launched alone (as the
correction between them runs) bit for bit as the two passes launched
together, batched and on one lane; N_s's forest factored in one launch bit
for bit as one panel at a time; the split factor and solves on the card
against the plain float64 whole N; and a small LandS fleet on the card, every
lane at its own optimum under the cell's limits.

Every test here needs an NVIDIA card and skips without one.  The file
imports no jax; run it on the card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_dense_cols.py -m cuda
"""

from unittest import mock

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cholesky_is_magic_tpu_torch.ingest.standard_form import scale_constraints
from cholesky_is_magic_tpu_torch.ops import sparse_ops
from cholesky_is_magic_tpu_torch.sparse import symbolic, tiled_cuda
from cholesky_is_magic_tpu_torch.sparse.tiled import engine_for_sparse
from lpbench import normal_plain as plain
from lpbench.gen import lands_saa as lands

pytestmark = pytest.mark.cuda
SEED = 2**31 + 2626
CAPACITIES = [0, 1, 2, 3]


def _engine(A, **kw):
    """``engine_for_sparse`` with the rule picking the capacities (below ~700
    scenarios it picks none of them by itself)."""
    pick = np.asarray(CAPACITIES, np.int64)
    with mock.patch.object(symbolic, "dense_columns", lambda _: pick):
        return engine_for_sparse(A, **kw)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _lands(scenarios, block, device):
    f = lands.fleet(scenarios, 0, 1, lanes=1)
    vals, _ = scale_constraints(f.rows.astype(np.int32), f.vals, f.b[0])
    A = sp.csc_matrix((vals, (f.rows, f.cols)), shape=(f.m, f.n))
    return f, vals, _engine(A, block=block, device=device)


def test_passes_alone_are_the_whole_solve(dev):
    f, _, eng = _lands(600, 128, dev)
    rng = np.random.default_rng(SEED)
    D = torch.as_tensor(np.exp(rng.uniform(-1, 1, (3, f.n))), dtype=torch.float32, device=dev)
    R = torch.as_tensor(rng.standard_normal((3, eng.B * eng.b)), dtype=torch.float32,
                        device=dev)
    L, invd, _ = torch.func.vmap(lambda d: eng.factorize(eng.assemble_pairs(d, per_lane=True),
                                                         per_lane=True))(D)
    before = dict(tiled_cuda.LAUNCHES)
    both = torch.func.vmap(lambda *x: eng.solve(*x))(L, invd, R)
    apart = torch.func.vmap(lambda l, i, r: eng.solve(l, i, eng.solve(l, i, r, passes=1),
                                                      passes=2))(L, invd, R)
    assert torch.equal(both, apart)
    assert tiled_cuda.LAUNCHES["tile_solve_batched"] - before["tile_solve_batched"] == 4
    one = eng.solve(L[1], invd[1], eng.solve(L[1], invd[1], R[1], passes=1), passes=2)
    assert torch.equal(one, both[1])


def test_a_run_of_panels_factors_in_one_launch_bit_for_bit(dev):
    """N_s's forest at block 128 is one run of panels: its tiles factor in
    one launch of the batched tile kernel for every lane (none a panel), and
    L, the inverse tiles and the dense columns' part equal one panel at a
    time, batched and on one lane."""
    from cholesky_is_magic_tpu_torch.ops import chol_cuda

    f, _, eng = _lands(600, 128, dev)
    assert eng._panel_runs == [(0, eng.B - 1)] and eng.B > 1
    rng = np.random.default_rng(SEED)
    D = torch.as_tensor(np.exp(rng.uniform(-1, 1, (3, f.n))), dtype=torch.float32, device=dev)

    def lanes():
        return torch.func.vmap(lambda d: eng.factorize(eng.assemble_pairs(d, per_lane=True),
                                                       per_lane=True, d=d))(D)

    def one():
        return eng.factorize(eng.assemble_pairs(D[1]), d=D[1])

    before = dict(chol_cuda.LAUNCHES)
    got, got_one = lanes(), one()
    launched = {k: chol_cuda.LAUNCHES[k] - before.get(k, 0) for k in chol_cuda.LAUNCHES}
    assert launched.get("potrf_tile_batched", 0) == 2 and launched.get("potrf_tile", 0) == 0
    runs, eng._panel_runs = eng._panel_runs, [(k, k) for k in range(eng.B)]
    try:
        want, want_one = lanes(), one()
    finally:
        eng._panel_runs = runs
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(got_one, want_one):
        assert torch.equal(a, b)


def test_split_solves_on_the_card_match_the_plain_whole_matrix(dev):
    """Tolerances as ``lpbench/dense_cols_check.py``'s (factor 1e-5,
    refined residual 1e-6, forward cond·1e-6)."""
    f, vals, eng = _lands(600, 128, dev)
    kw = dict(dtype=torch.float32, device=dev)
    E = sparse_ops.from_coo(f.rows, f.cols, vals, (f.m, f.n), **kw)
    ET = sparse_ops.from_coo(f.cols, f.rows, vals, (f.n, f.m), apart_rows=CAPACITIES, **kw)
    rng = np.random.default_rng(SEED)
    for scale in (1e-6, 1.0, 1e6):
        d = np.exp(rng.uniform(-1.5, 1.5, f.n))
        d[:4] = np.sqrt(scale) * rng.uniform(0.5, 2.0, 4)
        d_t = torch.as_tensor(d, **kw)
        g_t = torch.as_tensor(rng.standard_normal(f.m), **kw)
        N = plain.normal_matrix(f.rows, f.cols, vals, f.m, d_t.double().cpu().numpy(),
                                device=dev)
        want = plain.solve(plain.factor(N), g_t.double())
        cond = float(torch.linalg.cond(N))
        y, ok = eng.solve_normal_ell(E, ET, d_t, g_t, refine_steps=2)
        assert bool(ok)
        assert plain.residual_error(N, y, g_t) <= 1e-6
        assert float(torch.linalg.norm(y.double() - want) / torch.linalg.norm(want)) <= cond * 1e-6


def test_a_small_fleet_reaches_each_lanes_optimum(dev, monkeypatch):
    """Four lanes of 40 scenarios on the card (the kernels at block 32), the
    rule's floor lowered as on the CPU (``tests/test_torch_dense_cols.py``):
    every lane optimal, correct under the cell's limits."""
    import json
    import pathlib

    from lpbench.drive import Driver
    from lpbench.reference import check

    monkeypatch.setattr(symbolic, "DENSE_SQRT_M", 1.0)
    root = pathlib.Path(__file__).resolve().parents[1]
    config = json.loads((root / "lpbench/configs/lands.json").read_text())
    for key in ("m", "n_struct"):
        config.pop(key)
    config["scenarios"] = 40
    traffic = {"entry": "sparse_fleet", "block": 32, "lanes": 4, "phases": ["phase1"]}
    drv = Driver(config, traffic, SEED, "cuda")
    drv.setup()
    assert drv.state[0].n_dense == 4
    call = drv.call()
    drv.to_host(call)
    assert drv.stopped(call) == 4
    got = check.worst(drv.fleet, drv.path, [drv.iterates(call)], "float32")
    limits = json.loads((root / "lpbench/limits/lands.saa64.json").read_text())["limits"]
    assert check.verdict(got, limits), got
