"""The port's batch mode, held against the JAX package on the CPU in f64.

The same numpy-seeded LPs go through the JAX package's vmapped solvers and
the port's lane-batched loops (``parallel.batched_pdas`` /
``batched_pdas_dd``, ``api.solve_batch`` / ``embed_batch``).  Bars: each
lane's status and iteration count equal to the JAX package's, x within
1e-6, the objective within 1e-9 relative; the dd finisher's gap <= 1e-9.
Each JAX batch runs once per module (its compile is most of its cost) and
is shared by the cases that compare against it.  Also: the per-lane dbound
retry (the other lanes bit-equal to the single call), ``prepare_normal(
method="inverse")`` against the JAX package's, the batched plain dd forms
bit-equal per lane, the vmap rule of the dd operators, and the NumPy LP
fixtures bit-equal to the JAX package's.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cholesky_is_magic_tpu as cim
import cholesky_is_magic_tpu_torch as cimt
from cholesky_is_magic_tpu.ingest import to_device_lp as j_to_device_lp
from cholesky_is_magic_tpu.ingest.mps import read_mps_string as j_read
from cholesky_is_magic_tpu.ops import dense as j_dense
from cholesky_is_magic_tpu.parallel import batched_pdas as j_batched_pdas
from cholesky_is_magic_tpu.parallel import batched_pdas_dd as j_batched_pdas_dd
from cholesky_is_magic_tpu.solvers import PDASConfig as JConfig
from cholesky_is_magic_tpu.solvers import make_pdas as j_make_pdas
from cholesky_is_magic_tpu.solvers.pdas_dd import make_pdas_dd as j_make_pdas_dd
from cholesky_is_magic_tpu.utils import testing as j_testing
from cholesky_is_magic_tpu_torch import parallel
from cholesky_is_magic_tpu_torch.ingest.device import to_device_lp
from cholesky_is_magic_tpu_torch.ingest.mps import read_mps_string
from cholesky_is_magic_tpu_torch.ops import dd as ddm
from cholesky_is_magic_tpu_torch.ops import dd_cuda, dense
from cholesky_is_magic_tpu_torch.utils import lanes
from cholesky_is_magic_tpu_torch.utils import testing as t_testing

tpdas = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas")
tpdas_dd = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas_dd")

torch.set_num_threads(1)

SEEDS = [0, 2, 4, 6]  # tests/test_parallel.py::batch_of_lps


def _mps(seed, **kw):
    return j_testing.write_mps(j_testing.random_lp(seed, **kw))


def _lps(texts, pad=16):
    """The same MPS texts as JAX and port DeviceLPs (f64, CPU)."""
    jl = [j_to_device_lp(cim.to_standard_form(j_read(t)), pad_multiple=pad,
                         dtype=jnp.float64) for t in texts]
    tl = [to_device_lp(cimt.to_standard_form(read_mps_string(t)),
                       pad_multiple=pad, dtype=torch.float64, device="cpu")
          for t in texts]
    return jl, tl


def _jstack(xs):
    return jax.tree.map(lambda *a: jnp.stack(a), *xs)


def _jlane(tree, k):
    return jax.tree.map(lambda a: a[k], tree)


def _assert_lanes_match(jr, tr, gap=None):
    """Per-lane status and count equal, x within 1e-6, objective within
    1e-9 relative (and the gap below ``gap``)."""
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    np.testing.assert_array_equal(tr.iterations.numpy(),
                                  np.asarray(jr.iterations))
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), atol=1e-6)
    np.testing.assert_allclose(tr.objective.numpy(), np.asarray(jr.objective),
                               rtol=1e-9, atol=1e-12)
    if gap is not None:
        assert float(tr.extra["gap"].max()) <= gap


@pytest.fixture(scope="module")
def batch():
    """The four LPs of test_parallel.py's batch through both packages'
    batched pdas, "direct" and "inverse"; each JAX batch once."""
    texts = [_mps(s, bounded=True) for s in SEEDS]
    jl, tl = _lps(texts)
    out = {"jl": jl, "tl": tl}
    for method in ("direct", "inverse"):
        jcfg = JConfig(max_iters=200, factor_method=method)
        tcfg = tpdas.PDASConfig(max_iters=200, factor_method=method)
        js = _jstack([j_make_pdas(lp) for lp in jl])
        ts = parallel.stack_states([tpdas.make_pdas(lp) for lp in tl])
        out[method] = (j_batched_pdas(js, jcfg), parallel.batched_pdas(ts, tcfg),
                       ts, tcfg)
    return out


@pytest.mark.parametrize("method", ["direct", "inverse"])
def test_batched_pdas_matches_jax(batch, method):
    jr, tr, _, _ = batch[method]
    _assert_lanes_match(jr, tr)
    assert (tr.status.numpy() == 1).all()
    # The lanes stop at their own counts (tests/test_parallel.py's batch).
    assert tr.iterations.tolist() == [18, 14, 12, 13]
    np.testing.assert_allclose(tr.extra["y"].numpy(), np.asarray(jr.extra["y"]),
                               atol=1e-6)


def test_a_lane_that_stops_early_equals_its_own_solve(batch):
    """Lane 2 stops after 12 iterations while lane 0 runs to 18: frozen from
    then on, it is the single-LP pdas on the same LP (count and status
    equal, x, y and the objective within 1e-12)."""
    _, tr, ts, tcfg = batch["direct"]
    for k in range(len(SEEDS)):
        one = tpdas.pdas(lanes.lane(ts, k), tcfg)
        assert int(one.iterations) == int(tr.iterations[k])
        assert int(one.status) == int(tr.status[k])
        np.testing.assert_allclose(tr.x[k].numpy(), one.x.numpy(), atol=1e-12)
        np.testing.assert_allclose(tr.extra["y"][k].numpy(),
                                   one.extra["y"].numpy(), atol=1e-12)
        assert float(tr.objective[k]) == pytest.approx(float(one.objective),
                                                       rel=1e-12)


def test_batched_pdas_trace_rows_stop_with_their_lane(batch):
    """record_trace: each lane writes its own rows and stops writing when
    it stops (NaN after its count), as in the single solve."""
    _, _, ts, _ = batch["direct"]
    cfg = tpdas.PDASConfig(max_iters=30, record_trace=True)
    tr = parallel.batched_pdas(ts, cfg)
    for k in range(len(SEEDS)):
        one = tpdas.pdas(lanes.lane(ts, k), cfg)
        for key in ("gap", "objective", "step"):
            np.testing.assert_allclose(tr.extra["trace"][key][k].numpy(),
                                       one.extra["trace"][key].numpy(),
                                       rtol=1e-10, atol=1e-14)
        n = int(tr.iterations[k])
        assert np.isnan(tr.extra["trace"]["gap"][k, n:].numpy()).all()


def test_batched_pdas_dd_matches_jax(batch):
    """The dense double-word finisher over the batch, warm from the
    "inverse" batch's lanes (make_pdas_dd's mu-recentred duals)."""
    jr1, tr1, _, _ = batch["inverse"]
    jcfg = JConfig(max_iters=200, gap_tol=1e-9, refine_steps=2)
    tcfg = tpdas.PDASConfig(max_iters=200, gap_tol=1e-9, refine_steps=2)
    js = _jstack([j_make_pdas_dd(lp, warm=_jlane(jr1, k))
                  for k, lp in enumerate(batch["jl"])])
    ts = parallel.stack_states([tpdas_dd.make_pdas_dd(lp, warm=lanes.lane(tr1, k))
                                for k, lp in enumerate(batch["tl"])])
    jr, tr = j_batched_pdas_dd(js, jcfg), parallel.batched_pdas_dd(ts, tcfg)
    _assert_lanes_match(jr, tr, gap=1e-9)
    assert (tr.status.numpy() == 1).all()
    np.testing.assert_allclose(tr.extra["x_lo"].numpy(),
                               np.asarray(jr.extra["x_lo"]), atol=1e-12)
    # Each lane is the single finisher on its LP.
    one = tpdas_dd.pdas_dd(lanes.lane(ts, 1), tcfg)
    assert int(one.iterations) == int(tr.iterations[1])
    np.testing.assert_allclose(tr.x[1].numpy(), one.x.numpy(), atol=1e-12)


def test_batched_pdas_dd_entry_repair_per_lane(batch):
    """entry_repair_tol: every lane repairs on its own (a per-lane select,
    no host read), each lane equal to the single finisher's repair."""
    tl = batch["tl"]
    cfg = tpdas.PDASConfig(max_iters=3, gap_tol=1e-9, refine_steps=2,
                           entry_repair_tol=1e-12)
    states = [tpdas_dd.make_pdas_dd(lp) for lp in tl]
    tr = parallel.batched_pdas_dd(parallel.stack_states(states), cfg)
    rep = tr.extra["entry_repair"]
    for k, st in enumerate(states):
        one = tpdas_dd.pdas_dd(st, cfg)
        assert float(rep["pviol_before"][k]) == pytest.approx(
            float(one.extra["entry_repair"]["pviol_before"]), rel=1e-12)
        assert float(rep["pviol_after"][k]) == pytest.approx(
            float(one.extra["entry_repair"]["pviol_after"]), rel=1e-9, abs=1e-15)
        assert int(one.iterations) == int(tr.iterations[k])
        np.testing.assert_allclose(tr.x[k].numpy(), one.x.numpy(), atol=1e-10)
    assert (rep["pviol_after"] < rep["pviol_before"]).all()


def _normal_batch(seed=0, B=4, m=12, n=20):
    """A batch of normal systems with padded rows; lane 1's scaling is zero
    on most columns, so its N is singular until the dbound retry."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, m, n))
    A[:, 10:, :] = 0.0
    d = rng.random((B, n)) + 0.5
    d[1, 3:] = 0.0
    g = rng.normal(size=(B, m))
    boost = np.zeros(m)
    boost[10:] = 1.0
    return A, d, g, boost


@pytest.mark.parametrize("method", ["direct", "inverse"])
def test_per_lane_dbound_retry(method):
    """prepare_normal(per_lane=True) under vmap: the lane whose first
    factorization fails takes the retry (ok, and its solve within 1e-9 of
    the single call's host-branch retry); the other lanes equal the single
    call bit for bit."""
    A, d, g, boost = _normal_batch()
    At, dt, gt, bt = map(torch.from_numpy, (A, d, g, boost))

    def one(a, s, r):
        fn, ok = dense.prepare_normal(a, s, row_boost=bt, dbound=1e-6,
                                      method=method, per_lane=True)
        return fn(r), ok

    y, ok = lanes.vmap(one, At, dt, gt)
    assert ok.all()
    for k in range(A.shape[0]):
        first = dense.factorize(dense.normal_matrix(At[k], dt[k], bt),
                                blocked=method == "inverse")
        assert bool(first.ok) == (k != 1)
        fn, okk = dense.prepare_normal(At[k], dt[k], row_boost=bt, dbound=1e-6,
                                       method=method)
        yk = fn(gt[k])
        assert bool(okk)
        if k == 1:
            np.testing.assert_allclose(y[k].numpy(), yk.numpy(), rtol=1e-9)
        else:
            assert torch.equal(y[k], yk)


@pytest.mark.parametrize("gate", [True, False])
def test_per_lane_krylov_gate(gate):
    """The Krylov gate as a per-lane select equals the host branch."""
    A, d, g, boost = _normal_batch(seed=1)
    d[1] = d[0]
    At, dt, gt, bt = map(torch.from_numpy, (A, d, g, boost))
    gates = torch.tensor([gate, not gate, gate, not gate])

    def one(a, s, r, gt_):
        fn, _ = dense.prepare_normal(a, s, row_boost=bt, krylov_steps=3,
                                     krylov_gate=gt_, per_lane=True)
        return fn(r)

    y = lanes.vmap(one, At, dt, gt, gates)
    for k in range(A.shape[0]):
        fn, _ = dense.prepare_normal(At[k], dt[k], row_boost=bt, krylov_steps=3,
                                     krylov_gate=gates[k])
        np.testing.assert_allclose(y[k].numpy(), fn(gt[k]).numpy(),
                                   rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("case", ["spd", "boosted", "singular"])
def test_prepare_normal_inverse_matches_jax(case):
    """method="inverse" (blocked Cholesky, W = L⁻¹, solves Wᵀ(W·g)) against
    the JAX package's: y within 1e-12 relative, ok equal."""
    rng = np.random.default_rng({"spd": 3, "boosted": 4, "singular": 5}[case])
    m, n = 40, 72
    A = rng.normal(size=(m, n))
    d = rng.random(n) + 0.5
    g = rng.normal(size=m)
    boost = None
    if case == "boosted":
        A[33:] = 0.0
        boost = np.zeros(m)
        boost[33:] = 1.0
    if case == "singular":
        d[30:] = 0.0  # rank 30 < m: the factorization fails
    kw = dict(refine_steps=1, method="inverse")
    jfn, jok = j_dense.prepare_normal(
        jnp.asarray(A), jnp.asarray(d),
        row_boost=None if boost is None else jnp.asarray(boost), **kw)
    tfn, tok = dense.prepare_normal(
        torch.from_numpy(A), torch.from_numpy(d),
        row_boost=None if boost is None else torch.from_numpy(boost), **kw)
    assert bool(tok) == bool(jok) == (case != "singular")
    jy, ty = np.asarray(jfn(jnp.asarray(g))), tfn(torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(ty, jy, rtol=1e-12, atol=1e-12 * np.abs(jy).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_plain_dd_forms_equal_the_single_ones(dtype):
    """_dd_matvec_plain over a leading lane axis (the batched kernels' plain
    form) is bit-equal per lane to the single plain form, for A·x and
    Aᵀ·x (on A.mT)."""
    rng = np.random.default_rng(7)
    A = torch.from_numpy(rng.normal(size=(5, 13, 37))).to(dtype)
    x = torch.from_numpy(rng.normal(size=(5, 37))).to(dtype)
    y = torch.from_numpy(rng.normal(size=(5, 13))).to(dtype)
    mv, rmv = ddm._dd_matvec_plain(A, x), ddm._dd_matvec_plain(A.mT, y)
    for k in range(5):
        one, rone = ddm._dd_matvec_plain(A[k], x[k]), ddm.dd_rmatvec(A[k], y[k])
        assert torch.equal(mv.hi[k], one.hi) and torch.equal(mv.lo[k], one.lo)
        assert torch.equal(rmv.hi[k], rone.hi) and torch.equal(rmv.lo[k], rone.lo)
    # Under vmap the dispatchers give the same bits.
    vm = torch.func.vmap(ddm.dd_matvec)(A, x)
    assert torch.equal(vm.hi, mv.hi) and torch.equal(vm.lo, mv.lo)


def test_dd_operators_batch_under_vmap():
    """The dd operators' vmap rule sends a batch to the batched wrappers
    (here CPU tensors, which the wrappers refuse: the rule was reached), and
    their fake forms give the outputs' shapes."""
    A, x, y = torch.zeros(3, 4, 5), torch.zeros(3, 5), torch.zeros(3, 4)
    with pytest.raises(ValueError, match="dd_mv_batched takes CUDA"):
        torch.func.vmap(dd_cuda.dd_mv_op)(A, x)
    with pytest.raises(ValueError, match="dd_rmv_batched takes CUDA"):
        torch.func.vmap(dd_cuda.dd_rmv_op, in_dims=(None, 0))(A[0], y)
    with pytest.raises(ValueError, match="dd_mv takes CUDA"):
        dd_cuda.dd_mv_op(A[0], x[0])
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        hi, lo = dd_cuda.dd_rmv_op(torch.empty(4, 5), torch.empty(4))
        assert hi.shape == lo.shape == (5,)


def _texts_hetero():
    """tests/test_api.py::test_solve_batch_heterogeneous's LPs, one of them
    small (it stops first), without the mesh."""
    return [_mps(40 + s, n_ub=n_ub, n_eq=n_eq, n=n, density=0.5)
            for s, (n_ub, n_eq, n) in enumerate(
                [(10, 4, 20), (14, 2, 26), (4, 2, 6), (12, 4, 24)])]


def _sfs(texts):
    return ([cim.to_standard_form(j_read(t)) for t in texts],
            [cimt.to_standard_form(read_mps_string(t)) for t in texts])


@pytest.fixture(scope="module")
def front_door():
    """solve_batch through both packages, each JAX box once: the warm
    restart and embed-cache LPs (tests/test_api.py:159, :186; one box) and
    the heterogeneous mix (one box)."""
    kw = dict(pad_multiple=16, max_iters=200)
    warm_j, warm_t = _sfs([_mps(60 + s, n_ub=8, n_eq=2, n=12) for s in range(4)])
    emb_j, emb_t = _sfs([_mps(80 + s, n_ub=8, n_eq=2, n=12) for s in range(4)])
    het_j, het_t = _sfs(_texts_hetero())
    f64 = dict(dtype=torch.float64, device="cpu")
    out = {"kw": kw, "f64": f64, "warm_t": warm_t, "emb_t": emb_t}
    for tag, sj, st in (("warm", warm_j, warm_t), ("emb", emb_j, emb_t),
                        ("het", het_j, het_t)):
        cold_j = cim.solve_batch(sj, dtype=jnp.float64, **kw)
        cold_t = cimt.solve_batch(st, **f64, **kw)
        out[tag] = (cold_j, cold_t)
    wj = cim.solve_batch(warm_j, dtype=jnp.float64, warm=out["warm"][0],
                         warm_push=1e-3, **kw)
    out["warm_warm"] = wj
    return out


def _assert_reports_match(jreps, treps):
    for rj, rt in zip(jreps, treps):
        assert rt.status == rj.status
        assert rt.summary["iterations"] == rj.summary["iterations"]
        assert rt.summary["factor_method"] == rj.summary["factor_method"]
        assert rt.objective == pytest.approx(rj.objective, rel=1e-9)
        for key in ("y", "reduced_costs", "x"):
            np.testing.assert_allclose(rt.solution[key], rj.solution[key],
                                       atol=1e-6)
        assert rt.summary["gap_bound"] == pytest.approx(rj.summary["gap_bound"],
                                                        rel=1e-6, abs=1e-12)
        assert set(rt.summary) == set(rj.summary)


@pytest.mark.parametrize("tag", ["warm", "emb", "het"])
def test_solve_batch_matches_jax(front_door, tag):
    jreps, treps = front_door[tag]
    assert len(treps) == len(jreps) == 4
    assert all(r.status == "optimal" for r in treps)
    _assert_reports_match(jreps, treps)


def test_solve_batch_heterogeneous_lanes_equal_their_single_solves(front_door):
    """Each lane of the heterogeneous batch agrees with its own single
    solve (the bar of tests/test_api.py:141-151)."""
    _, treps = front_door["het"]
    for rep in treps:
        single = cimt.solve(rep.sf, "pdas", pad_multiple=16, max_iters=200,
                            **front_door["f64"])
        tol = 2e-4 * max(1.0, abs(single.objective)) + 1e-4
        assert abs(rep.objective - single.objective) < tol
        np.testing.assert_allclose(rep.solution["y"], single.solution["y"],
                                   atol=1e-2)


def test_the_small_lp_of_the_mixed_batch_stops_first_as_its_own_solve(front_door):
    """The mixed batch's small LP (4 + 2 rows, 6 columns, in the common box)
    stops before the lanes that run on, and its report is the single pdas
    on the same embedded LP: the same count and status, x within 1e-12."""
    _, treps = front_door["het"]
    its = [r.summary["iterations"] for r in treps]
    assert its[2] < max(its)
    emb = cimt.embed_batch(_sfs(_texts_hetero())[1], pad_multiple=16,
                           **front_door["f64"])
    cfg = tpdas.PDASConfig(max_iters=200, factor_method="inverse")
    one = tpdas.pdas(tpdas.make_pdas(lanes.lane(emb.stacked_lp, 2), cfg), cfg)
    assert int(one.iterations) == its[2]
    assert one.status_name == treps[2].status
    np.testing.assert_allclose(treps[2].result.x.numpy(), one.x.numpy(),
                               atol=1e-12)


def test_solve_batch_warm_restart(front_door):
    """The same problem list restarted from its reports converges in far
    fewer iterations, with the JAX package's counts; a warm list from
    another box or of another length raises ValueError."""
    kw, f64 = front_door["kw"], front_door["f64"]
    cold = front_door["warm"][1]
    warm = cimt.solve_batch(front_door["warm_t"], warm=cold, warm_push=1e-3,
                            **f64, **kw)
    _assert_reports_match(front_door["warm_warm"], warm)
    it_cold = sum(r.summary["iterations"] for r in cold)
    it_warm = sum(r.summary["iterations"] for r in warm)
    assert it_warm < 0.7 * it_cold, (it_warm, it_cold)
    with pytest.raises(ValueError, match="padded box"):
        cimt.solve_batch(front_door["warm_t"], pad_multiple=32, max_iters=50,
                         warm=cold, **f64)
    with pytest.raises(ValueError, match="reports"):
        cimt.solve_batch(front_door["warm_t"], max_iters=50, warm=cold[:3],
                         **f64)


def test_solve_batch_embed_cache(front_door):
    """A BatchEmbed solves bit-identically to the direct call, twice, and
    composes with a warm restart; its explicit pad_multiple / dtype are
    ignored in favour of the handle's, as in the JAX package."""
    kw, f64 = front_door["kw"], front_door["f64"]
    direct = front_door["emb"][1]
    emb = cimt.embed_batch(front_door["emb_t"], pad_multiple=16, **f64)
    cached = cimt.solve_batch(emb, max_iters=200)
    recached = cimt.solve_batch(emb, max_iters=200, pad_multiple=64,
                                dtype=torch.float32)
    for a, b, c in zip(direct, cached, recached):
        assert a.objective == b.objective == c.objective
        assert a.summary["iterations"] == b.summary["iterations"] \
            == c.summary["iterations"]
        assert torch.equal(a.result.x, c.result.x)
    warm = cimt.solve_batch(emb, max_iters=200, warm=cached, warm_push=1e-3)
    assert all(r.status == "optimal" for r in warm)
    assert (sum(r.summary["iterations"] for r in warm)
            < sum(r.summary["iterations"] for r in cached))
    assert cimt.solve_batch([], **f64, **kw) == []


def test_batched_loops_refuse_what_the_single_loops_refuse(batch):
    """The batch refuses what a single loop refuses (an unknown factor
    method) and takes what it takes: with Gondzio's correctors each lane
    is its single solve (tests/test_torch_gondzio.py holds both against
    the JAX package)."""
    _, _, ts, _ = batch["direct"]
    cfg = tpdas.PDASConfig(max_iters=200, mehrotra=True, gondzio_correctors=1)
    tr = parallel.batched_pdas(ts, cfg)
    for k in range(len(SEEDS)):
        one = tpdas.pdas(lanes.lane(ts, k), cfg)
        assert (int(one.status), int(one.iterations)) == (
            int(tr.status[k]), int(tr.iterations[k]))
        np.testing.assert_allclose(tr.x[k].numpy(), one.x.numpy(), atol=1e-12)
    with pytest.raises(ValueError, match="unknown method"):
        parallel.batched_pdas(ts, tpdas.PDASConfig(factor_method="cholmod"))


def test_stack_refuses_unequal_lanes():
    _, tl = _lps([_mps(0), _mps(1, n=12)])
    with pytest.raises(ValueError, match="padded shape"):
        parallel.stack_device_lps(tl)
    a, b = _lps([_mps(0), _mps(1)])[1]
    import dataclasses

    with pytest.raises(ValueError, match="outside their tensors"):
        lanes.stack([a, dataclasses.replace(b, m=b.m + 1)])


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_lp_fixtures_equal_the_jax_packages(seed):
    """random_lp, write_mps and scipy_reference_solution (and
    netlib_like_lp) are the JAX package's, bit for bit."""
    jl, tl = j_testing.random_lp(seed), t_testing.random_lp(seed)
    for f in ("c", "A_ub", "b_ub", "A_eq", "b_eq", "l", "u"):
        assert np.array_equal(getattr(jl, f), getattr(tl, f))
    assert t_testing.write_mps(tl) == j_testing.write_mps(jl)
    js, jf, jx = j_testing.scipy_reference_solution(jl)
    ts, tf, tx = t_testing.scipy_reference_solution(tl)
    assert (ts, tf) == (js, jf) and np.array_equal(tx, jx)
    assert (t_testing.write_mps(t_testing.netlib_like_lp("afiro", seed))
            == j_testing.write_mps(j_testing.netlib_like_lp("afiro", seed)))
