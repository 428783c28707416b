"""The port's same-A sparse batch, held against the JAX package on the CPU.

Three LPs of one constraint matrix with their own (b, c) (the JAX
package's ``TestBatchedSparseEngine.family``: a re-solve fleet) go through
both packages' batched sparse pdas and the two-phase flow on one tile engine
(block 16, f64): each lane's status and count equal to the JAX lane's, the
objective within 1e-8 relative, and each lane equal to the port's own single
solve on the same engine.  Then ``batched_normal_solves`` on the JAX test's
banded A against the JAX package's (1e-10 relative) and the port's single
solves; the per-lane dbound retry on the engine; the operators
``cim::factor_tile`` and ``cim::assemble_pairs`` under ``torch.func.vmap``
against lane-by-lane calls; the plain assembly's fixed order; and the
refusals.  Warnings that vmap fell back to a per-lane loop are errors here.
Each JAX run happens once per module.
"""

import dataclasses as dc
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cholesky_is_magic_tpu as cim
import cholesky_is_magic_tpu_torch as cimt
from cholesky_is_magic_tpu.ingest.mps import read_mps_string as j_read
from cholesky_is_magic_tpu.ops import dd as j_ddm
from cholesky_is_magic_tpu.ops import sparse_ops as j_sparse_ops
from cholesky_is_magic_tpu.parallel import batched_pdas as j_batched_pdas
from cholesky_is_magic_tpu.parallel import batched_pdas_dd as j_batched_pdas_dd
from cholesky_is_magic_tpu.parallel import stack_sparse_states as j_stack
from cholesky_is_magic_tpu.parallel.batched import (
    batched_normal_solves as j_batched_normal_solves,
)
from cholesky_is_magic_tpu.solvers import PDASConfig as JConfig
from cholesky_is_magic_tpu.solvers.pdas import make_pdas_sparse as j_make_sparse
from cholesky_is_magic_tpu.solvers.pdas_dd import PDASDDState as JDDState
from cholesky_is_magic_tpu.solvers.pdas_dd import mu_recentered_duals as j_mu
from cholesky_is_magic_tpu.sparse.tiled import engine_for_sparse as j_engine
from cholesky_is_magic_tpu.utils import testing as j_testing
from cholesky_is_magic_tpu_torch import convert, parallel
from cholesky_is_magic_tpu_torch.ingest.mps import read_mps_string
from cholesky_is_magic_tpu_torch.ops import chol, sparse_ops
from cholesky_is_magic_tpu_torch.ops import dd as ddm
from cholesky_is_magic_tpu_torch.sparse import tiled

tpdas = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas")
tpdas_dd = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas_dd")

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")

F64 = dict(dtype=torch.float64, device="cpu")
P1 = dict(max_iters=200, refine_steps=2)
P2 = dict(max_iters=200, gap_tol=1e-9, refine_steps=2)


def _family(k=3, seed=11):
    """tests/test_parallel.py::TestBatchedSparseEngine.family: k same-A LPs
    with per-lane (b, c), as MPS texts, and HiGHS's optima."""
    base = j_testing.random_lp(seed, n_ub=24, n_eq=6, n=32, bounded=True)
    texts, funs = [], []
    for i in range(k):
        rng = np.random.default_rng(1000 + i)
        x0 = base.l + (base.u - base.l) * (0.2 + 0.6 * rng.random(32))
        lane = dc.replace(
            base,
            b_ub=base.A_ub @ x0 + 0.05 + rng.random(base.A_ub.shape[0]),
            b_eq=base.A_eq @ x0,
            c=rng.normal(size=32),
        )
        funs.append(j_testing.scipy_reference_solution(lane)[1])
        texts.append(j_testing.write_mps(lane))
    return texts, funs


@pytest.fixture(scope="module")
def fleet():
    """Both packages' batched sparse pdas and two-phase flow on the family,
    in f64 on one engine each; the JAX runs once."""
    texts, funs = _family()
    jsf = [cim.to_standard_form(j_read(t)) for t in texts]
    tsf = [cimt.to_standard_form(read_mps_string(t)) for t in texts]
    js0, jeng = j_make_sparse(jsf[0], block=16, dtype=jnp.float64)
    jstates = [js0] + [j_make_sparse(sf, block=16, engine=jeng, dtype=jnp.float64)[0]
                       for sf in jsf[1:]]
    ts0, teng = tpdas.make_pdas_sparse(tsf[0], block=16, **F64)
    tstates = [ts0] + [tpdas.make_pdas_sparse(sf, block=16, engine=teng, **F64)[0]
                       for sf in tsf[1:]]
    jp1 = j_batched_pdas(j_stack(jstates), JConfig(**P1), engine=jeng)
    tcfg1 = tpdas.PDASConfig(**P1)
    tp1 = parallel.batched_pdas(parallel.stack_sparse_states(tstates), tcfg1,
                                engine=teng)
    # The finisher from each package's own phase 1 (mu-recentred duals).
    jdd = []
    for i, st in enumerate(jstates):
        w, z = j_mu(jp1.x[i], st.lp.l, st.lp.u, jp1.extra["w"][i],
                    jp1.extra["z"][i], st.lp.col_mask)
        jdd.append(JDDState(x=j_ddm.dd_from(jp1.x[i]),
                            y=j_ddm.dd_from(jp1.extra["y"][i]),
                            w=j_ddm.dd_from(w), z=j_ddm.dd_from(z), lp=st.lp))
    jp2 = j_batched_pdas_dd(j_stack(jdd), JConfig(**P2), engine=jeng)
    tdd = []
    for i, st in enumerate(tstates):
        w, z = tpdas_dd.mu_recentered_duals(
            tp1.x[i], st.lp.l, st.lp.u, tp1.extra["w"][i], tp1.extra["z"][i],
            st.lp.col_mask)
        tdd.append(tpdas_dd.PDASDDState(
            x=ddm.dd_from(tp1.x[i]), y=ddm.dd_from(tp1.extra["y"][i]),
            w=ddm.dd_from(w), z=ddm.dd_from(z), lp=st.lp))
    tcfg2 = tpdas.PDASConfig(**P2)
    tp2 = parallel.batched_pdas_dd(parallel.stack_sparse_states(tdd), tcfg2,
                                   engine=teng)
    return dict(funs=funs, jp1=jp1, tp1=tp1, jp2=jp2, tp2=tp2, teng=teng,
                tstates=tstates, tdd=tdd, tcfg1=tcfg1, tcfg2=tcfg2,
                jstates=jstates, jdd=jdd)


@pytest.mark.parametrize("phase", ["pdas", "pdas_dd"])
def test_batched_sparse_lanes_match_jax(fleet, phase):
    """Each lane's status and iteration count equal to the JAX package's
    batched lane, the objective within 1e-8 relative; both phases meet the
    JAX test's bars against HiGHS (1e-3; after the finisher gap < 1e-7 and
    1e-4)."""
    jr, tr = (fleet["jp1"], fleet["tp1"]) if phase == "pdas" else (
        fleet["jp2"], fleet["tp2"])
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    np.testing.assert_array_equal(tr.iterations.numpy(), np.asarray(jr.iterations))
    np.testing.assert_allclose(tr.objective.numpy(), np.asarray(jr.objective),
                               rtol=1e-8)
    assert (tr.status.numpy() == 1).all()
    bar = 1e-3 if phase == "pdas" else 1e-4
    for i, fun in enumerate(fleet["funs"]):
        assert float(tr.objective[i]) == pytest.approx(fun, rel=bar, abs=bar)
    if phase == "pdas_dd":
        assert float(tr.extra["gap"].max()) < 1e-7


@pytest.mark.parametrize("phase", ["pdas", "pdas_dd"])
def test_each_sparse_lane_equals_its_single_solve(fleet, phase):
    """A lane of the batch is the port's own single solve on the same
    engine: the same count and status, x bit for bit (the kernels'
    operators run the plain forms here), the objective within 1e-14
    relative (a batched dot sums in another order)."""
    eng = fleet["teng"]
    for k in range(3):
        if phase == "pdas":
            one = tpdas.pdas(fleet["tstates"][k], fleet["tcfg1"], engine=eng)
            tr = fleet["tp1"]
        else:
            one = tpdas_dd.pdas_dd(fleet["tdd"][k], fleet["tcfg2"], engine=eng)
            tr = fleet["tp2"]
        assert int(one.iterations) == int(tr.iterations[k])
        assert int(one.status) == int(tr.status[k])
        assert torch.equal(one.x, tr.x[k])
        assert float(one.objective) == pytest.approx(float(tr.objective[k]),
                                                     rel=1e-14)


def test_jax_states_through_the_ports_solvers(fleet):
    """The JAX package's states handed over as NumPy
    (``convert.pdas_dd_sparse_state_from_numpy`` on its stacked finisher
    states, with their lane axis; ``pdas_sparse_state_from_numpy`` on one
    phase-1 state, without): the port's batched finisher gives the JAX
    finisher's statuses and counts, and the port's single pdas the JAX
    batch's lane 0."""
    stacked = j_stack(fleet["jdd"])
    st = convert.pdas_dd_sparse_state_from_numpy(
        jax.tree.map(np.asarray, stacked), device="cpu")
    assert st.x.hi.shape == (3, fleet["tdd"][0].x.hi.shape[0])
    assert st.lp.E.indices.dtype == torch.int64 and st.lp.m == stacked.lp.m
    tr = parallel.batched_pdas_dd(st, fleet["tcfg2"], engine=fleet["teng"])
    jr = fleet["jp2"]
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    np.testing.assert_array_equal(tr.iterations.numpy(), np.asarray(jr.iterations))
    np.testing.assert_allclose(tr.objective.numpy(), np.asarray(jr.objective),
                               rtol=1e-8)
    one = convert.pdas_sparse_state_from_numpy(
        jax.tree.map(np.asarray, fleet["jstates"][0]), device="cpu")
    assert one.x.dim() == 1 and one.lp.ET.n_cols == st.lp.ET.n_cols
    r = tpdas.pdas(one, fleet["tcfg1"], engine=fleet["teng"])
    assert int(r.iterations) == int(fleet["jp1"].iterations[0])
    assert float(r.objective) == pytest.approx(float(fleet["jp1"].objective[0]),
                                               rel=1e-8)


def _banded(m=192, band=6, seed=3):
    """tests/test_sparse_pipeline.py's banded A, its ELL forms in both
    packages (f64), and the random stream after it."""
    rng = np.random.default_rng(seed)
    n = 2 * m
    rows, cols, vals = [], [], []
    for i in range(m):
        for k in range(band):
            rows.append(i)
            cols.append((2 * i + k) % n)
            vals.append(rng.normal())
    A = sp.csc_matrix((vals, (rows, cols)), shape=(m, n))
    return A, rng


@pytest.fixture(scope="module")
def normal_solves():
    A, rng = _banded()
    m, n = A.shape
    coo = A.tocoo()
    B = 8
    D = rng.random((B, n)) + 0.5
    G = rng.normal(size=(B, m))
    jeng = j_engine(A, block=64, dtype=jnp.float64)
    jE = j_sparse_ops.from_coo(coo.row, coo.col, coo.data, (m, n), dtype=jnp.float64)
    jET = j_sparse_ops.from_coo(coo.col, coo.row, coo.data, (n, m), dtype=jnp.float64)
    jY, jok = j_batched_normal_solves(jeng, jE, jET, jnp.asarray(D), jnp.asarray(G),
                                      mesh=None, refine_steps=1)
    teng = tiled.engine_for_sparse(A, block=64, **F64)
    tE = sparse_ops.from_coo(coo.row, coo.col, coo.data, (m, n), **F64)
    tET = sparse_ops.from_coo(coo.col, coo.row, coo.data, (n, m), **F64)
    return dict(A=A, D=torch.from_numpy(D), G=torch.from_numpy(G), jY=np.asarray(jY),
                jok=np.asarray(jok), eng=teng, E=tE, ET=tET)


def test_batched_normal_solves_match_jax(normal_solves):
    """Y within 1e-10 relative of the JAX package's, every lane ok."""
    ns = normal_solves
    Y, ok = parallel.batched_normal_solves(ns["eng"], ns["E"], ns["ET"], ns["D"],
                                           ns["G"], refine_steps=1)
    assert ok.all() and ns["jok"].all()
    rel = np.linalg.norm(Y.numpy() - ns["jY"]) / np.linalg.norm(ns["jY"])
    assert rel <= 1e-10, rel


def test_batched_normal_solves_lanes_equal_single_solves(normal_solves):
    ns = normal_solves
    Y, _ = parallel.batched_normal_solves(ns["eng"], ns["E"], ns["ET"], ns["D"],
                                          ns["G"], refine_steps=1)
    for i in range(Y.shape[0]):
        y1, ok1 = ns["eng"].solve_normal_ell(ns["E"], ns["ET"], ns["D"][i],
                                             ns["G"][i], refine_steps=1)
        assert bool(ok1) and torch.equal(Y[i], y1)
    with pytest.raises(NotImplementedError, match="multi-device"):
        parallel.batched_normal_solves(ns["eng"], ns["E"], ns["ET"], ns["D"],
                                       ns["G"], mesh=object())


def test_per_lane_dbound_retry_on_the_engine(normal_solves):
    """A lane whose normal matrix is singular (a row of A·D zero) fails its
    first factorization and takes the retry per lane (ok, and equal to the
    single call's host-branch retry); the other lanes are bit-equal to the
    batch without it."""
    ns = normal_solves
    eng, E, ET = ns["eng"], ns["E"], ns["ET"]
    D, G = ns["D"][:4].clone(), ns["G"][:4]
    D[1, 10:16] = 0.0  # row 5 of A·D is zero: N is singular
    kw = dict(refine_steps=1, dbound=1e-6)
    Y, ok = parallel.batched_normal_solves(eng, E, ET, D, G, **kw)
    assert ok.all()
    keep = torch.tensor([0, 2, 3])
    Y0, _ = parallel.batched_normal_solves(eng, E, ET, D[keep], G[keep], **kw)
    assert torch.equal(Y[keep], Y0)
    tiles = eng.assemble_pairs(D[1], torch.zeros(E.shape[0], **F64))
    assert not bool(eng.factorize(tiles)[2])
    y1, ok1 = eng.solve_normal_ell(E, ET, D[1], G[1], **kw)
    assert bool(ok1)
    np.testing.assert_allclose(Y[1].numpy(), y1.numpy(), rtol=1e-12, atol=1e-12)
    _, ok_off = parallel.batched_normal_solves(eng, E, ET, D, G, refine_steps=1)
    assert ok_off.tolist() == [True, False, True, True]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("b", [16, 33])
def test_factor_tile_operator_under_vmap(dtype, b):
    """cim::factor_tile's vmap rule (the batched launch on the card, the
    plain form on the stack here) equals the operator lane by lane, and its
    fake form gives the shapes; a non-PD lane is all NaN alone."""
    rng = np.random.default_rng(b)
    M = rng.normal(size=(4, b, b))
    T = torch.tensor(M @ np.swapaxes(M, 1, 2) / b + np.eye(b), dtype=dtype)
    T[2, 3, 3] = -1.0
    L, inv = torch.func.vmap(chol.factor_tile_op)(T)
    for k in range(4):
        Lk, Ik = chol.factor_tile_op(T[k])
        for got, want in ((L[k], Lk), (inv[k], Ik)):  # bit for bit, NaN too
            torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert bool(torch.isnan(L[2]).all()) and bool(torch.isfinite(L[[0, 1, 3]]).all())
    # An unbatched tile beside a batched operand: expanded to every lane.
    L2 = torch.func.vmap(lambda s: chol.factor_tile_op(T[0])[0] * s)(
        torch.ones(3, dtype=dtype))
    assert torch.equal(L2, L[0].expand(3, b, b))
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        a, c = chol.factor_tile_op(torch.empty(b, b))
        assert a.shape == c.shape == (b, b)


@pytest.mark.parametrize("b", [160, 256])
def test_wide_tile_split_inside_a_lane(b):
    """The card's 2 x 2 split of tiles wider than 128 run inside a lane
    (its leaf the operator, as a batched solver runs it on the card): no
    vmap fallback, each lane bit-equal to the split with the plain leaf
    alone, a non-PD lane all NaN alone."""
    rng = np.random.default_rng(b)
    M = rng.normal(size=(3, b, b))
    T = torch.tensor(M @ np.swapaxes(M, 1, 2) / b + np.eye(b))
    T[1, b - 20, b - 20] = -1.0

    def lane(t):
        L, inv = t.clone(), torch.empty_like(t)
        chol._factor_tile_split_(L, inv, chol._lane_leaf_)
        return L, inv

    L, inv = torch.func.vmap(lane)(T)
    for k in range(3):
        Lk, Ik = T[k].clone(), torch.empty_like(T[k])
        chol._factor_tile_split_(Lk, Ik, chol.factor_tile_)
        for got, want in ((L[k], Lk), (inv[k], Ik)):
            torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert bool(torch.isnan(L[1]).all()) and bool(torch.isfinite(L[[0, 2]]).all())


def _small_engine(block, dtype=torch.float64):
    rng = np.random.default_rng(block)
    m, n = 60, 110
    A = (rng.random((m, n)) < 0.06) * rng.normal(size=(m, n))
    A[np.arange(m), np.arange(m)] += 2.0
    A[7, :] = rng.normal(size=n)  # a dense row: a long diagonal run
    return tiled.engine_for_sparse(A, block=block, dtype=dtype, device="cpu"), rng, n, m


@pytest.mark.parametrize("shared_boost", [False, True])
@pytest.mark.parametrize("block", [8, 16])
def test_assemble_pairs_operator_under_vmap(block, shared_boost):
    """cim::assemble_pairs's vmap rule equals the engine lane by lane, with
    a boost per lane or one shared (lane stride 0 on the card), and the
    plain version on a lane axis equals it too."""
    eng, rng, n, m = _small_engine(block)
    D = torch.tensor(rng.random((5, n)) + 0.5)
    bo = torch.tensor((rng.random((5, m)) < 0.2) * 1.0)
    if shared_boost:
        tiles = torch.func.vmap(
            lambda d: eng.assemble_pairs(d, bo[0], per_lane=True))(D)
    else:
        tiles = torch.func.vmap(
            lambda d, r: eng.assemble_pairs(d, r, per_lane=True))(D, bo)
    for k in range(5):
        one = eng.assemble_pairs(D[k], bo[0] if shared_boost else bo[k])
        assert torch.equal(tiles[k], one)
    assert torch.equal(tiles, eng._assemble_pairs_plain(D, bo[0] if shared_boost else bo))
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        out = tiled.assemble_pairs_op(torch.empty(n, dtype=torch.float64),
                                      torch.empty(m, dtype=torch.float64), eng.op_key)
        assert out.shape == (eng.NT + 1, eng.b, eng.b)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_assembly_sums_in_one_fixed_order(dtype):
    """The plain assembly adds each destination's pairs one occurrence rank
    per pass: two calls are bit-equal, and equal to one sequential
    index_add_ in schedule order (the order the kernel sums in) within the
    working precision's rounding, here on the CPU bit for bit."""
    eng, rng, n, m = _small_engine(16, dtype)
    lengths = torch.diff(eng.asm_run_start)
    assert int(lengths.max()) >= n and len(eng._asm_passes) == int(lengths.max())
    d = torch.tensor(rng.random(n) + 0.5, dtype=dtype)
    boost = torch.zeros(m, dtype=dtype)
    t1 = eng._assemble_pairs_plain(d, boost)
    assert torch.equal(t1, eng._assemble_pairs_plain(d, boost))
    b = eng.b
    old = torch.zeros((eng.NT + 1) * b * b, dtype=dtype).index_add_(
        0, eng.asm_dst_flat, eng.asm_w * (d * d)[eng.asm_k]).reshape(-1, b, b)
    old[eng.NT] = 0.0
    rb = torch.nn.functional.pad(boost, (0, eng.B * b - m), value=1.0)
    old[eng.diag_ids] += torch.eye(b, dtype=dtype) * rb[eng.pperm].reshape(
        eng.B, b, 1)
    assert torch.equal(t1, old)


def test_stack_sparse_states_refuses_unequal_structures(fleet):
    """States of two different patterns (other shapes) do not stack, nor
    states whose static fields differ; a sparse batch needs its engine."""
    text = j_testing.write_mps(
        j_testing.random_lp(12, n_ub=20, n_eq=6, n=32, bounded=True))
    other, _ = tpdas.make_pdas_sparse(
        cimt.to_standard_form(read_mps_string(text)), block=16, **F64)
    st = fleet["tstates"][0]
    with pytest.raises(ValueError):
        parallel.stack_sparse_states([st, other])
    with pytest.raises(ValueError, match="differ outside"):
        parallel.stack_sparse_states(
            [st, dc.replace(st, lp=dc.replace(st.lp, m=st.lp.m + 1))])
    with pytest.raises(ValueError, match="sparse operand set needs engine"):
        parallel.batched_pdas(parallel.stack_sparse_states([st, st]))


def _fleet_runs(lanes_):
    """The lanes ``lanes_`` of chip_smoke.py phase 16 (c)'s re-solve fleet
    (25fv47 scale, one A) through both packages' batched two-phase flow in
    f32 on the CPU, block 128: per package (phase-1 statuses and counts,
    finisher statuses, counts, gaps, objective errors vs HiGHS)."""
    from cholesky_is_magic_tpu.ops import dd as jdd
    from cholesky_is_magic_tpu_torch.utils import testing as t_testing

    base = t_testing.netlib_like_lp("25fv47")
    n = base.c.shape[0]
    texts, funs = [], []
    for i in lanes_:
        rng = np.random.default_rng(1000 + i)
        x0 = base.l + (base.u - base.l) * (0.2 + 0.6 * rng.random(n))
        lane = dc.replace(
            base, b_ub=base.A_ub @ x0 + 0.05 + rng.random(base.A_ub.shape[0]),
            b_eq=base.A_eq @ x0, c=rng.normal(size=n))
        funs.append(t_testing.scipy_reference_solution(lane)[1])
        texts.append(t_testing.write_mps(lane))
    funs = np.array(funs)
    p1kw = dict(max_iters=200, refine_steps=2, mehrotra=True)
    jsf = [cim.to_standard_form(j_read(t)) for t in texts]
    js0, jeng = j_make_sparse(jsf[0], block=128)
    jst = [js0] + [j_make_sparse(sf, block=128, engine=jeng)[0] for sf in jsf[1:]]
    jp1 = j_batched_pdas(j_stack(jst), JConfig(**p1kw), engine=jeng)
    f32 = lambda v: jdd.dd_from(jnp.asarray(v, jnp.float32))  # noqa: E731
    jdds = []
    for i, st in enumerate(jst):
        w, z = j_mu(jp1.x[i], st.lp.l, st.lp.u, jp1.extra["w"][i], jp1.extra["z"][i],
                    st.lp.col_mask)
        jdds.append(JDDState(x=f32(jp1.x[i]), y=f32(jp1.extra["y"][i]), w=f32(w),
                             z=f32(z), lp=st.lp))
    jp2 = j_batched_pdas_dd(j_stack(jdds), JConfig(**P2), engine=jeng)
    tsf = [cimt.to_standard_form(read_mps_string(t)) for t in texts]
    ts0, teng = tpdas.make_pdas_sparse(tsf[0], block=128, device="cpu")
    tst = [ts0] + [tpdas.make_pdas_sparse(sf, block=128, engine=teng, device="cpu")[0]
                   for sf in tsf[1:]]
    tp1 = parallel.batched_pdas(parallel.stack_sparse_states(tst),
                                tpdas.PDASConfig(**p1kw), engine=teng)
    tdds = []
    for i, st in enumerate(tst):
        w, z = tpdas_dd.mu_recentered_duals(
            tp1.x[i], st.lp.l, st.lp.u, tp1.extra["w"][i], tp1.extra["z"][i],
            st.lp.col_mask)
        tdds.append(tpdas_dd.PDASDDState(
            x=ddm.dd_from(tp1.x[i]), y=ddm.dd_from(tp1.extra["y"][i]),
            w=ddm.dd_from(w), z=ddm.dd_from(z), lp=st.lp))
    tp2 = parallel.batched_pdas_dd(parallel.stack_sparse_states(tdds),
                                   tpdas.PDASConfig(**P2), engine=teng)
    out = {}
    for tag, p1, p2 in (("JAX", jp1, jp2), ("port", tp1, tp2)):
        err = np.abs(np.asarray(p2.objective, np.float64) - funs) / np.maximum(
            1.0, np.abs(funs))
        out[tag] = (np.asarray(p1.status).tolist(), np.asarray(p1.iterations).tolist(),
                    np.asarray(p2.status).tolist(), np.asarray(p2.iterations).tolist(),
                    np.asarray(p2.extra["gap"], np.float64), err)
    return out


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 PYTHONPATH=. python
    #     tests/test_torch_batched_sparse.py 3,13,19,31,0
    import sys

    assert jax.config.jax_enable_x64, "run with JAX_ENABLE_X64=1, as conftest does"
    chosen = [int(k) for k in sys.argv[1].split(",")]
    for tag, (s1, i1, s2, i2, gaps, err) in _fleet_runs(chosen).items():
        print(f"fleet lanes {chosen}, f32, {tag}: phase 1 statuses {s1}, iterations {i1};"
              f" finisher statuses {s2}, iterations {i2}, gaps "
              + " ".join(f"{g:.3e}" for g in gaps)
              + ", objective errors vs HiGHS " + " ".join(f"{e:.3e}" for e in err))
