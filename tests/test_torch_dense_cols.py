"""Dense columns set apart from the tile engine's normal matrix, on the CPU.

LandS (``lpbench/gen/lands_saa.py``): the generator's counts, basis and
optimum; the split factor and solves (N = N_s + A_d·Δ·A_dᵀ, the correction
in the factor's coordinates) against the plain float64 whole N of
``lpbench/normal_plain.py``; Aᵀ·y with the long rows held apart against the
products without; a 4-lane fleet to each lane's exact optimum; the rule
(``sparse.symbolic.dense_columns``) selecting nothing on the accepted
configurations, whose engines and products then stay as they were; the
span ``normal.dense_cols`` and its counters; the forward and backward
passes of the tile solve alone.  Tolerances are each written with their
reason.
"""

import json
import pathlib
from unittest import mock

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cholesky_is_magic_tpu_torch.ingest.standard_form import scale_constraints
from cholesky_is_magic_tpu_torch.ops import bell, sparse_ops
from cholesky_is_magic_tpu_torch.sparse import symbolic
from cholesky_is_magic_tpu_torch.sparse.tiled import engine_for_sparse
from cholesky_is_magic_tpu_torch.utils import diag
from lpbench import normal_plain as plain
from lpbench.gen import constructed_optimum as co
from lpbench.gen import lands_saa as lands
from lpbench.gen import qap_relaxation as qap

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEED = 2**31 + 26
CAPACITIES = [0, 1, 2, 3]  # the first-stage columns, LandS's dense ones


def _engine(A, columns=CAPACITIES, **kw):
    """``engine_for_sparse`` with the rule picking ``columns`` (below ~700
    scenarios it picks none of the capacities by itself)."""
    pick = np.asarray(columns, np.int64)
    with mock.patch.object(symbolic, "dense_columns", lambda _: pick):
        return engine_for_sparse(A, **kw)


def _scaled(f):
    """(row-scaled values, A as CSC) of a fleet's A, as the program holds it."""
    vals, _ = scale_constraints(f.rows.astype(np.int32), f.vals, f.b[0])
    return vals, sp.csc_matrix((vals, (f.rows, f.cols)), shape=(f.m, f.n))


def _dense_factor(eng, L):
    """The engine's compact tiles as one dense lower factor in slot order."""
    b = eng.b
    out = torch.zeros((eng.B * b, eng.B * b), dtype=L.dtype)
    for t, (i, j) in enumerate(eng.tiles):
        out[i * b:(i + 1) * b, j * b:(j + 1) * b] = L[t]
    return torch.tril(out)


# ---- the generator ------------------------------------------------------


@pytest.mark.parametrize("scenarios", [1, 2, 10, 5000])
def test_lands_counts(scenarios):
    rows, cols, vals, m, n_struct = lands.structure(scenarios)
    assert (m, n_struct, len(vals)) == lands.counts(scenarios) == (
        2 + 7 * scenarios, 4 + 12 * scenarios, 8 + 28 * scenarios)
    lengths = np.bincount(cols, minlength=n_struct)
    assert (lengths[:4] == scenarios + 2).all() and (lengths[4:] == 2).all()
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, n_struct)).tocsr()
    assert A.nnz == len(vals)  # no duplicate entries
    assert np.array_equal(A[1, :4].toarray()[0], lands.BUDGET)


@pytest.mark.parametrize("scenarios", [2, 10, 200])
def test_lands_basis_and_optimum(scenarios):
    """A nonsingular basis with the four capacities in it, and each lane's
    constructed optimum feasible, dual feasible and complementary."""
    f = lands.fleet(scenarios, 0, 1, lanes=3)
    assert set(CAPACITIES) <= set(f.basic.tolist())
    A = sp.csc_matrix((f.vals, (f.rows, f.cols)), shape=(f.m, f.n))
    lu = sp.linalg.splu(sp.csc_matrix(A[:, f.basic]))
    assert np.abs(lu.U.diagonal()).min() > 1e-3  # nonsingular
    nonbasic = np.setdiff1d(np.arange(f.n), f.basic)
    for k in range(f.lanes):
        # The basis gives back the basic values from b and the others' bounds.
        x_b = lu.solve(f.b[k] - A[:, nonbasic] @ f.x[k][nonbasic])
        np.testing.assert_allclose(x_b, f.x[k][f.basic], rtol=0, atol=1e-9)
        x, y, z, w = f.x[k], f.y[k], f.z[k], f.w[k]
        np.testing.assert_allclose(A @ x, f.b[k], rtol=0, atol=1e-12)
        np.testing.assert_allclose(A.T @ y + z - w, f.c[k], rtol=0, atol=1e-12)
        assert (x >= f.l).all() and (x <= f.u).all()
        assert np.abs(z * (x - f.l)).max() == 0.0 and np.abs(w * (f.u - x)).max() == 0.0
        inside = (x > f.l) & (x < f.u)
        assert inside[f.basic].all() and inside.sum() == f.m  # strict complementarity


def test_lands_lane_is_the_same_whatever_the_lanes():
    few, many = lands.fleet(10, 0, 1, lanes=2), lands.fleet(10, 0, 1, lanes=5)
    for key in ("b", "c", "x", "y", "z", "w", "objective"):
        np.testing.assert_array_equal(getattr(few, key), getattr(many, key)[:2])
    with pytest.raises(ValueError):
        lands.make({"scenarios": 10, "m": 71, "matrix_seed": 0, "lane_seed": 1}, 0, 1)


# ---- the rule -----------------------------------------------------------


def test_the_rule_selects_the_capacities_at_scale():
    """10·sqrt(m) passes N + 2 from about 700 scenarios on; below, the
    capacities are not long against m and stay in N."""
    for scenarios, want in ((40, []), (1000, CAPACITIES), (5000, CAPACITIES)):
        _, A = _scaled(lands.fleet(scenarios, 0, 1, lanes=1))
        assert symbolic.dense_columns(A).tolist() == want


def _accepted():
    """The accepted configurations' A at their own sizes."""
    out = {}
    for name in ("pilot", "pds-10"):
        c = json.loads((ROOT / "lpbench/configs" / f"{name}.json").read_text())
        b = co.base_instance(c["m"], c["n_struct"], c["matrix_seed"], c["width"])
        out[name] = sp.csc_matrix((b["vals"], (b["rows"], b["cols"])), shape=(b["m"], b["n"]))
    sh = qap.base(15, 0)
    out["qap15"] = sp.csc_matrix((sh["vals"], (sh["rows"], sh["cols"])),
                                 shape=(sh["m"], sh["n"]))
    return out


def test_the_rule_selects_nothing_on_the_accepted_configurations():
    for name, A in _accepted().items():
        assert symbolic.dense_columns(A).size == 0, name


@pytest.mark.parametrize("kind", ["pilot", "pds-10", "qap15"])
def test_engines_and_products_unchanged_where_nothing_is_set_apart(kind):
    """Tiny instances of the accepted configurations: the fully sparse
    engine, which applies the rule, plans, factors and solves bit for bit
    as the engine that sets nothing apart, and the operands carry no rows
    apart."""
    import importlib

    pdas = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas")
    from lpbench.program import standard_forms

    f = (qap.fleet(4, 0, 1, 1) if kind == "qap15"
         else co.fleet(24, 48, 0, 1, 1) if kind == "pilot" else co.fleet(48, 96, 0, 1, 1, 4))
    sf = standard_forms(f)[0]
    kw = dict(block=16, dtype=torch.float32, device="cpu")
    st, eng = pdas.make_pdas_sparse(sf, **kw)
    _, A = _scaled(f)
    plain_eng = _engine(A, columns=[], **kw)
    assert eng.n_dense == 0 and st.lp.ET.apart is None
    assert st.lp.ETB is None or st.lp.ETB.apart is None
    for a, b in ((eng.plan.perm, plain_eng.plan.perm), (eng.plan.slot_mask, plain_eng.plan.slot_mask),
                 (eng._asm_dst_np, plain_eng._asm_dst_np)):
        assert np.array_equal(a, b)
    rng = np.random.default_rng(SEED)
    d = torch.as_tensor(np.exp(rng.uniform(-1, 1, f.n)), dtype=torch.float32)
    g = torch.as_tensor(rng.standard_normal(f.m), dtype=torch.float32)
    lp = st.lp
    got = [e.solve_normal_ell(lp.E, lp.ET, d, g, refine_steps=2, EB=lp.EB, ETB=lp.ETB)[0]
           for e in (eng, plain_eng)]
    assert torch.equal(got[0], got[1])


@pytest.mark.parametrize("kind", ["pilot", "pds-10", "qap15"])
def test_every_panel_runs_alone_on_the_accepted_configurations(kind):
    """Tiny instances of the accepted configurations: every panel but the
    last has TRSM tiles, so the engine's panel loop factors one tile at a
    time, as before runs of panels were taken together (at full size too:
    ``pds-10``'s 137 panels and ``qap15``'s 52 each run alone)."""
    f = (qap.fleet(4, 0, 1, 1) if kind == "qap15"
         else co.fleet(24, 48, 0, 1, 1) if kind == "pilot" else co.fleet(48, 96, 0, 1, 1, 4))
    _, A = _scaled(f)
    eng = engine_for_sparse(A, block=16, dtype=torch.float32, device="cpu")
    assert eng._panel_runs == [(k, k) for k in range(eng.B)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("lanes", [0, 3], ids=["single", "vmap"])
def test_a_run_of_panels_factors_as_the_panel_loop(dtype, block, lanes):
    """N_s's forest is one run of panels, factored in one call: L, its
    inverse tiles and the dense columns' part bit for bit as one panel at a
    time, on one lane and under ``vmap``."""
    f = lands.fleet(40, 0, 1, lanes=1)
    _, A = _scaled(f)
    eng = _engine(A, block=block, dtype=dtype, device="cpu")
    assert eng._panel_runs == [(0, eng.B - 1)] and eng.B > 1
    rng = np.random.default_rng(SEED)
    D = torch.as_tensor(np.exp(rng.uniform(-2, 2, (max(lanes, 1), f.n))), dtype=dtype)

    def factor(d, per_lane):
        return eng.factorize(eng.assemble_pairs(d, per_lane=per_lane), per_lane, d=d)

    def both():
        if lanes:
            return torch.func.vmap(lambda d: factor(d, True))(D)
        return factor(D[0], False)

    got = both()
    runs, eng._panel_runs = eng._panel_runs, [(k, k) for k in range(eng.B)]
    want = both()
    eng._panel_runs = runs
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---- the split factor and solves ----------------------------------------


@pytest.mark.parametrize("dtype,factor_tol,raw_tol,refined_tol,forward_tol", [
    # N_s's Cholesky factor is backward stable: ‖L Lᵀ − N_s‖ / ‖N_s‖ reads
    # at most one u (f64 1.1e-16, f32 7.9e-8; u = 1.1e-16, 6e-8).  The split
    # solves' residual error against the whole N reads under u in f64 (5.3e-17
    # raw) and up to 2.1e-8 raw, 3.9e-9 refined in f32, across δ from 1e-6 to
    # 1e6 on the capacities; the forward error over cond(N) under 5.5e-18 in
    # f64 and 8.5e-10 in f32.  Each tolerance gives about ten times the most
    # read.
    (torch.float64, 1e-15, 5e-16, 5e-16, 1e-16),
    (torch.float32, 1e-6, 2e-7, 5e-8, 1e-8),
], ids=["f64", "f32"])
@pytest.mark.parametrize("scenarios,block", [(8, 16), (8, 32), (40, 16), (40, 32)])
def test_split_solves_match_the_plain_whole_normal_matrix(scenarios, block, dtype, factor_tol,
                                                           raw_tol, refined_tol, forward_tol):
    f = lands.fleet(scenarios, 0, 1, lanes=1)
    vals, A = _scaled(f)
    kw = dict(dtype=dtype, device="cpu")
    eng = _engine(A, block=block, **kw)
    assert eng.n_dense == 4
    E = sparse_ops.from_coo(f.rows, f.cols, vals, (f.m, f.n), **kw)
    ET = sparse_ops.from_coo(f.cols, f.rows, vals, (f.n, f.m), apart_rows=CAPACITIES, **kw)
    keep = f.cols >= 4
    rng = np.random.default_rng([SEED, scenarios, block])
    for scale in (1e-6, 1.0, 1e6):  # δ = d² on the capacities
        d = np.exp(rng.uniform(-1.5, 1.5, f.n))
        d[:4] = np.sqrt(scale) * rng.uniform(0.5, 2.0, 4)
        boost, g = 1e-6 * rng.random(f.m), rng.standard_normal(f.m)
        d_t, b_t, g_t = (torch.as_tensor(v, **kw) for v in (d, boost, g))
        d64, b64 = d_t.double().numpy(), b_t.double().numpy()
        L, invd, ok, Q, ML = eng.factorize(eng.assemble_pairs(d_t, b_t), d=d_t)
        assert bool(ok)
        Ns = plain.normal_matrix(f.rows[keep], f.cols[keep], vals[keep], f.m, d64, b64,
                                 perm=eng.pperm.numpy())
        assert plain.backward_error(Ns, _dense_factor(eng, L)) <= factor_tol
        N = plain.normal_matrix(f.rows, f.cols, vals, f.m, d64, b64)
        want = plain.solve(plain.factor(N), g_t.double())
        cond = float(torch.linalg.cond(N))
        for steps, tol in ((0, raw_tol), (2, refined_tol)):
            y, ok = eng.solve_normal_ell(E, ET, d_t, g_t, row_boost=b_t, refine_steps=steps)
            assert bool(ok)
            assert plain.residual_error(N, y, g_t) <= tol, (scale, steps)
            err = float(torch.linalg.norm(y.double() - want) / torch.linalg.norm(want))
            assert err <= cond * forward_tol, (scale, steps, err, cond)


def test_split_solves_under_vmap_match_each_lane():
    """Three lanes' scalings through the per-lane path (the retry armed, as
    the fleet runs it): each lane bit for bit its single solve."""
    f = lands.fleet(12, 0, 1, lanes=1)
    vals, A = _scaled(f)
    kw = dict(dtype=torch.float32, device="cpu")
    eng = _engine(A, block=16, **kw)
    E = sparse_ops.from_coo(f.rows, f.cols, vals, (f.m, f.n), **kw)
    ET = sparse_ops.from_coo(f.cols, f.rows, vals, (f.n, f.m), apart_rows=CAPACITIES, **kw)
    rng = np.random.default_rng(SEED)
    D = torch.as_tensor(np.exp(rng.uniform(-3, 3, (3, f.n))), **kw)
    G = torch.as_tensor(rng.standard_normal((3, f.m)), **kw)

    def one(d, g, per_lane):
        return eng.solve_normal_ell(E, ET, d, g, refine_steps=2, dbound=1e-6,
                                    per_lane=per_lane)[0]

    got = torch.func.vmap(lambda d, g: one(d, g, True))(D, G)
    for k in range(3):
        assert torch.equal(got[k], one(D[k], G[k], True))


# ---- products -----------------------------------------------------------


def test_transposed_products_with_the_long_rows_apart():
    """Aᵀ·y, f32 and dd, with A's dense columns held apart from Aᵀ's ELL and
    block-ELL forms (a dense block of their rows): the other rows bit for
    bit as the ELL form that pads every row to the dense columns' length
    (adding an exact zero changes no sum), and every row within the
    product's own rounding of the float64 product; the block-ELL form, which
    the long rows would keep from passing its byte gate, the same; A·x,
    scale_columns and the dense form through the held rows too."""
    f = lands.fleet(40, 0, 1, lanes=1)
    vals, A = _scaled(f)
    kw = dict(dtype=torch.float32, device="cpu")
    whole = sparse_ops.from_coo(f.cols, f.rows, vals, (f.n, f.m), **kw)
    split = sparse_ops.from_coo(f.cols, f.rows, vals, (f.n, f.m), apart_rows=CAPACITIES, **kw)
    assert whole.indices.shape[1] == 42 and split.indices.shape[1] == 2
    assert bell.from_coo(f.cols, f.rows, vals, (f.n, f.m), **kw) is None
    blocked = bell.from_coo(f.cols, f.rows, vals, (f.n, f.m), apart_rows=CAPACITIES, **kw)
    assert blocked is not None and blocked.apart is not None
    y = torch.as_tensor(np.random.default_rng(SEED).standard_normal(f.m), **kw)
    others = torch.ones(f.n, dtype=torch.bool)
    others[CAPACITIES] = False
    got, want = sparse_ops.matvec(split, y), sparse_ops.matvec(whole, y)
    assert torch.equal(got[others], want[others])
    got_dd, want_dd = sparse_ops.dd_matvec(split, y), sparse_ops.dd_matvec(whole, y)
    assert torch.equal(got_dd.hi[others], want_dd.hi[others])
    assert torch.equal(got_dd.lo[others], want_dd.lo[others])
    truth = torch.as_tensor(A.T @ y.double().numpy())
    scale = torch.as_tensor(abs(A.T) @ abs(y.double().numpy()))
    # f32: one rounding of each of at most 42 terms, 42u of Σ|a||y|;
    # double-word: about u² relative, so 1e-12 of Σ|a||y| leaves room.
    for f32, dd in ((got, got_dd), (bell.matvec(blocked, y), bell.dd_matvec(blocked, y))):
        assert ((f32.double() - truth).abs() <= 42 * 6e-8 * scale).all()
        assert ((dd.hi.double() + dd.lo.double() - truth).abs() <= 1e-12 * scale).all()
    dd_y = sparse_ops.ddm.DD(y, y * 1e-8)
    got_dd = sparse_ops.dd_matvec_dd(split, dd_y)
    truth2 = truth + torch.as_tensor(A.T @ (y * 1e-8).double().numpy())
    assert ((got_dd.hi.double() + got_dd.lo.double() - truth2).abs() <= 1e-12 * scale).all()
    assert torch.equal(sparse_ops.to_dense(split), sparse_ops.to_dense(whole))
    # (Aᵀ)ᵀ·x = A·x adds the held rows' product after the others' scatter:
    # another order, so within A's rows' rounding (at most 5 terms, 5u).
    x = np.random.default_rng(SEED + 1).standard_normal(f.n)
    got = sparse_ops.rmatvec(split, torch.as_tensor(x, **kw)).double()
    assert ((got - torch.as_tensor(A @ x))
            .abs() <= 5 * 6e-8 * torch.as_tensor(abs(A) @ abs(x)) + 1e-30).all()
    d = torch.rand(f.m, dtype=torch.float32) + 0.5
    assert torch.equal(sparse_ops.to_dense(sparse_ops.scale_columns(split, d)),
                       sparse_ops.to_dense(sparse_ops.scale_columns(whole, d)))


def test_tile_solve_passes_alone_compose_to_the_whole_solve():
    """The forward pass alone then the backward pass alone is the solve, bit
    for bit, on the loop and through the kernel's plain route (the operator,
    under vmap too)."""
    from cholesky_is_magic_tpu_torch.sparse import tiled_cuda

    f = lands.fleet(40, 0, 1, lanes=1)
    _, A = _scaled(f)
    kw = dict(dtype=torch.float32, device="cpu")
    eng = _engine(A, block=32, **kw)
    rng = np.random.default_rng(SEED)
    D = torch.as_tensor(np.exp(rng.uniform(-1, 1, (2, f.n))), **kw)
    R = torch.as_tensor(rng.standard_normal((2, eng.B * eng.b)), **kw)
    L, invd, _ = eng.factorize(eng.assemble_pairs(D[0]))
    both = eng.solve(L, invd, R[0])
    assert torch.equal(eng.solve(L, invd, eng.solve(L, invd, R[0], passes=1), passes=2), both)
    op = lambda r, p: tiled_cuda.tile_solve(eng, L, invd, r, p)  # noqa: E731
    assert torch.equal(op(op(R[0], 1), 2), op(R[0], 3))
    batched = torch.func.vmap(lambda r: op(op(r, 1), 2))(R)
    assert torch.equal(batched, torch.func.vmap(lambda r: op(r, 3))(R))


# ---- the fleet, the span and the counters ---------------------------------


def test_a_lands_fleet_reaches_each_lanes_exact_optimum(monkeypatch):
    """Four lanes of 40 scenarios through ``lpbench``'s sparse fleet entry,
    float32 and the configuration's pdas settings, the rule's floor lowered
    so that it sets the capacities apart at this size: every lane optimal,
    at its own optimum, as close as the cell's own limits ask."""
    from lpbench.drive import Driver
    from lpbench.reference import check

    monkeypatch.setattr(symbolic, "DENSE_SQRT_M", 1.0)
    config = json.loads((ROOT / "lpbench/configs/lands.json").read_text())
    for key in ("m", "n_struct"):
        config.pop(key)
    config["scenarios"] = 40
    traffic = {"entry": "sparse_fleet", "block": 16, "lanes": 4, "phases": ["phase1"]}
    drv = Driver(config, traffic, SEED, "cpu")
    drv.setup()
    assert drv.state[0].n_dense == 4 and drv.state[1].lp.ET.apart is not None
    call = drv.call()
    drv.to_host(call)
    assert drv.stopped(call) == 4
    got = check.worst(drv.fleet, drv.path, [drv.iterates(call)], "float32")
    limits = json.loads((ROOT / "lpbench/limits/lands.saa64.json").read_text())["limits"]
    assert check.verdict(got, limits), got


def test_span_and_counters():
    """``normal.dense_cols`` opens inside ``normal.factorize`` (once a
    factorization) and inside ``normal.solve`` (once a raw solve), and the
    benchmark's reduction rolls it up to those layers; the counters read
    k per factorization."""
    from lpbench import program_spans

    f = lands.fleet(12, 0, 1, lanes=1)
    vals, A = _scaled(f)
    kw = dict(dtype=torch.float32, device="cpu")
    eng = _engine(A, block=16, **kw)
    E = sparse_ops.from_coo(f.rows, f.cols, vals, (f.m, f.n), **kw)
    ET = sparse_ops.from_coo(f.cols, f.rows, vals, (f.n, f.m), apart_rows=CAPACITIES, **kw)
    d = torch.ones(f.n, **kw)
    g = torch.ones(f.m, **kw)
    with diag.recording() as rec:
        solve_fn, _ = eng.prepare_normal_ell(E, ET, d, f.m, refine_steps=2)
        solve_fn(g)
    assert rec.counts["normal.factorizations"] == 1
    assert rec.counts["normal.dense_cols"] == rec.counts["normal.dense_col_rhs"] == 4
    parents = [rec.spans[s.parent].name for s in rec.spans if s.name == "normal.dense_cols"]
    assert parents == ["normal.factorize"] + ["normal.solve"] * 3
    assert {program_spans.layer_of(rec.spans, i) for i, s in enumerate(rec.spans)
            if s.name == "normal.dense_cols"} == {"normal.factorize", "normal.solve"}
    with diag.recording() as rec:  # the dbound retry's second factorization
        eng.prepare_normal_ell(E, ET, d, f.m, dbound=1e-6, per_lane=True)
    assert rec.counts["normal.dense_col_rhs"] == 4 * rec.counts["normal.factorizations"] == 8
