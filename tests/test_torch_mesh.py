"""The port's mesh modes, held against the JAX package on the CPU.

The JAX package runs its mesh versions on the conftest's 8-virtual-device
CPU mesh (``lp_mesh(dp=2, tp=4)`` for tp, ``lp_mesh(dp=8, tp=1)`` for dp);
the port runs SPMD over gloo ranks started by
``cholesky_is_magic_tpu_torch.utils.testing.run_ranks`` (spawned, so no rank
imports jax): one spawn of 4 ranks runs every case on ``lp_mesh(1, 4)`` and
on ``lp_mesh(2, 2)``, one spawn of 1 rank on ``lp_mesh(1, 1)``.  Inputs are
numpy-seeded and f64 unless a case says f32.  Bars:

- across ranks: the JAX test's bar against JAX's mesh version (1e-9 for
  the normal solves, the same status and count and x within 1e-6 for the
  solvers), the count equal to the port's unsharded run, and every rank's
  result the same;
- at tp = 1: bit-equal to the port's unsharded call.  The sharded normal
  solve refines against the UNASSEMBLED operator by construction (JAX
  ``parallel/sharded.py:126-135``), where the dense pdas and affine
  backends refine against the assembled N (``ops/dense.py`` ``dd_residual``);
  so pdas and affine at tp = 1 are held bit-equal to their unsharded run
  with the dense solve refined against the unassembled operator
  (``true_residual``), the form pdas_dd's dense backend always takes.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cholesky_is_magic_tpu as cim
from cholesky_is_magic_tpu.ingest import to_device_lp as j_to_device_lp
from cholesky_is_magic_tpu.ingest.mps import read_mps_string as j_read
from cholesky_is_magic_tpu.utils.testing import random_lp, write_mps
from cholesky_is_magic_tpu_torch import api, parallel
from cholesky_is_magic_tpu_torch.ingest.device import to_device_lp
from cholesky_is_magic_tpu_torch.ingest.mps import read_mps_string
from cholesky_is_magic_tpu_torch.ingest.standard_form import to_standard_form
from cholesky_is_magic_tpu_torch.ops import dense
from cholesky_is_magic_tpu_torch.solvers import backend
from cholesky_is_magic_tpu_torch.utils import lanes
from cholesky_is_magic_tpu_torch.utils import testing as T

jpar = importlib.import_module("cholesky_is_magic_tpu.parallel")
jpdas = importlib.import_module("cholesky_is_magic_tpu.solvers.pdas")
jdd = importlib.import_module("cholesky_is_magic_tpu.solvers.pdas_dd")
jaff = importlib.import_module("cholesky_is_magic_tpu.solvers.affine")
tpdas = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas")
tdd = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas_dd")
taff = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.affine")

torch.set_num_threads(1)

CFG = dict(max_iters=200)
DD_CFG = dict(max_iters=300, gap_tol=1e-8, refine_steps=2)
SPARSE_CFG = dict(max_iters=300, refine_steps=2)


def _sf(seed, **kw):
    text = write_mps(random_lp(seed, bounded=True, **kw))
    return to_standard_form(read_mps_string(text)), cim.to_standard_form(j_read(text))


def _conditioned(kappa_n, m=96, n=192, seed=0):
    """tests/test_parallel.py::TestShardedConditioning._conditioned: an f32
    A whose normal matrix has condition ~kappa_n, g, and the f64 solution."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.normal(size=(m, m)))
    V, _ = np.linalg.qr(rng.normal(size=(n, m)))
    sv = np.logspace(0.0, np.log10(kappa_n) / 2.0, m)
    A = (U @ np.diag(sv) @ V.T).astype(np.float32)
    g = rng.normal(size=m).astype(np.float32)
    Af = A.astype(np.float64)
    return A, g, np.linalg.solve(Af @ Af.T, g.astype(np.float64))


def _inputs():
    rng = np.random.default_rng(0)
    normal = dict(A=rng.normal(size=(24, 64)), d=rng.random(64) + 0.5,
                  g=rng.normal(size=24))
    rng = np.random.default_rng(1)
    A = rng.normal(size=(16, 80))
    A[12:] = 0.0
    g = rng.normal(size=16)
    g[12:] = 0.0
    boost = np.zeros(16)
    boost[12:] = 1.0
    boosted = dict(A=A, d=rng.random(80) + 0.5, g=g, row_boost=boost,
                   refine_steps=1)
    A9, g9, x9 = _conditioned(1e9)
    A8, g8, x8 = _conditioned(1e8, seed=3)
    ones = np.ones(192, np.float32)
    rng = np.random.default_rng(7)
    A7 = rng.normal(size=(48, 128)).astype(np.float32)
    d7 = (10.0 ** rng.uniform(-1.5, 1.5, size=128)).astype(np.float32)
    g7 = rng.normal(size=48).astype(np.float32)
    AD7 = A7.astype(np.float64) * d7.astype(np.float64)[None, :]
    lps = {}
    for name, seed, kw, pad in (("pdas", 3, dict(n_ub=12, n_eq=4, n=24), 8),
                                ("pdas_dd", 2, dict(n_ub=24, n_eq=6, n=32), 16),
                                ("affine", 5, dict(n_ub=12, n_eq=4, n=24), 8)):
        sf, jsf = _sf(seed, **kw)
        lps[name] = (to_device_lp(sf, pad_multiple=pad, dtype=torch.float64,
                                  device="cpu"),
                     j_to_device_lp(jsf, pad_multiple=pad, dtype=jnp.float64))
    simple = to_device_lp(to_standard_form(cim.read_mps_file(
        "tests/fixtures/simple.mps")), pad_multiple=8, dtype=torch.float64,
        device="cpu")
    sparse = {seed: _sf(seed, n_ub=24, n_eq=6, n=32) for seed in (2, 4)}
    rng = np.random.default_rng(3)
    sf2 = sparse[2][0]
    ell = dict(d=rng.random(sf2.nvars) + 0.5, g=rng.normal(size=sf2.ncons))
    ell_batch = dict(D=rng.random((4, sf2.nvars)) + 0.5,
                     G=rng.normal(size=(4, sf2.ncons)))
    batch = [_sf(s) for s in range(8)]
    batch_lps = [to_device_lp(sf, pad_multiple=16, dtype=torch.float64,
                              device="cpu") for sf, _ in batch]
    return dict(
        normal=normal, boosted=boosted,
        raw9=dict(A=A9, d=ones, g=g9), retry9=dict(A=A9, d=ones, g=g9,
                                                   dbound=1e-6, krylov_steps=80),
        krylov8=dict(A=A8, d=ones, g=g8, krylov_steps=20), x9=x9, x8=x8,
        dd7=dict(A=A7, d=d7, g=g7, refine_steps=2),
        x7=np.linalg.solve(AD7 @ AD7.T, g7.astype(np.float64)),
        lps=lps, simple=simple, sparse=sparse, ell=ell, ell_batch=ell_batch,
        batch=batch, batch_lps=batch_lps,
    )


NORMAL = ("normal", "boosted", "raw9", "retry9", "krylov8", "dd7")
SOLVERS = ("pdas", "pdas_dd", "affine")


def _tp_cases(inp):
    cases = [("normal", inp[k]) for k in NORMAL]
    cfgs = {"pdas": CFG, "pdas_dd": DD_CFG, "affine": {}}
    cases += [(k, dict(lp=T.lp_arrays(inp["lps"][k][0]), cfg=cfgs[k]))
              for k in SOLVERS]
    cases += [("placement", dict(lp=T.lp_arrays(inp["simple"])))]
    cases += [("sparse", dict(sf=inp["sparse"][4][0], block=16, cfg=SPARSE_CFG,
                              dd_cfg=DD_CFG)),
              ("normal_ell", dict(sf=inp["sparse"][2][0], block=16,
                                  refine_steps=1, **inp["ell"]))]
    return cases


def _dp_cases(inp):
    return [("normal", inp["normal"]),
            ("batch", dict(lps=[T.lp_arrays(lp) for lp in inp["batch_lps"]],
                           cfg=CFG, dd_cfg=DD_CFG,
                           sfs=[sf for sf, _ in inp["batch"]], slab_iters=8)),
            ("normal_batch", dict(sf=inp["sparse"][2][0], block=16,
                                  refine_steps=1, **inp["ell_batch"]))]


@pytest.fixture(scope="module")
def inp():
    return _inputs()


@pytest.fixture(scope="module")
def ranks(inp):
    """Every case on every mesh: {(dp, tp): [each rank's {name: result}]}."""
    tp_cases, dp_cases = _tp_cases(inp), _dp_cases(inp)
    names = lambda cases: [f"{k}:{i}" for i, (k, _) in enumerate(cases)]  # noqa: E731
    out = {}
    for world, runs in ((4, [(1, 4, tp_cases), (2, 2, dp_cases)]),
                        (1, [(1, 1, tp_cases)])):
        per_rank = T.run_ranks(T.mesh_cases, world, runs, timeout=600)
        for j, (dp, tp, cases) in enumerate(runs):
            out[(dp, tp)] = [dict(zip(names(cases), r[j])) for r in per_rank]
    return out


def _case(ranks, mesh, key):
    """(rank 0's result of case ``key`` on ``mesh``), after checking that
    every rank returned the same."""
    results = [r[key] for r in ranks[mesh]]
    for other in results[1:]:
        _assert_same(other, results[0])
    return results[0]


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, list):
        for u, v in zip(a, b):
            _assert_same(u, v)
    else:
        np.testing.assert_array_equal(a, b)


def _key(name):
    return {"normal": "normal:0", "boosted": "normal:1", "raw9": "normal:2",
            "retry9": "normal:3", "krylov8": "normal:4", "dd7": "normal:5",
            "pdas": "pdas:6", "pdas_dd": "pdas_dd:7", "affine": "affine:8",
            "placement": "placement:9", "sparse": "sparse:10",
            "normal_ell": "normal_ell:11"}[name]


@pytest.fixture(scope="module")
def jax_runs(inp):
    """The JAX package's mesh versions, once per module."""
    mesh = jpar.lp_mesh(dp=2, tp=4)
    out = {}
    with jax.default_matmul_precision("highest"):
        for k in NORMAL:
            # Jitted: JAX's eager shard_map dispatches its refinement op by
            # op (minutes on the CPU); the test in test_parallel.py is slow.
            kw = dict(inp[k])
            args = [jnp.asarray(kw.pop(v)) for v in ("A", "d", "g", "row_boost")
                    if v in kw]
            solve = jax.jit(lambda *a, kw=kw: jpar.sharded_solve_normal(
                mesh, *a[:3], row_boost=a[3] if len(a) > 3 else None, **kw))
            y, ok = solve(*args)
            out[k] = (np.asarray(y), bool(ok))
    sh = lambda st: dataclasses.replace(st, lp=jpar.shard_lp_columns(st.lp, mesh))  # noqa: E731
    lp = inp["lps"]["pdas"][1]
    out["pdas"] = jpdas.pdas(sh(jpdas.make_pdas(lp)), jpdas.PDASConfig(**CFG),
                             mesh=mesh)
    lp = inp["lps"]["pdas_dd"][1]
    out["pdas_dd"] = jdd.pdas_dd(jdd.make_pdas_dd(lp), jpdas.PDASConfig(**DD_CFG),
                                 mesh=mesh)
    lp = inp["lps"]["affine"][1]
    out["affine"] = jaff.affine_scaling(sh(jaff.make_affine_state(lp)), mesh=mesh)
    jsf = inp["sparse"][4][1]
    st, eng = jpdas.make_pdas_sparse(jsf, block=16, dtype=jnp.float64)
    out["sparse_pdas"] = jpdas.pdas(st, jpdas.PDASConfig(**SPARSE_CFG), engine=eng,
                                    mesh=mesh)
    st, eng = jdd.make_pdas_dd_sparse(jsf, block=16, dtype=jnp.float64)
    out["sparse_pdas_dd"] = jdd.pdas_dd(st, jpdas.PDASConfig(**DD_CFG),
                                        engine=eng, mesh=mesh)
    jlps = [j_to_device_lp(jsf, pad_multiple=16, dtype=jnp.float64)
            for _, jsf in inp["batch"]]
    states = jax.tree.map(lambda *xs: jnp.stack(xs),
                          *[jpdas.make_pdas(lp) for lp in jlps])
    out["batch"] = jpar.batched_pdas(
        jpar.shard_batched_pdas(states, jpar.lp_mesh(dp=8, tp=1)),
        jpdas.PDASConfig(**CFG))
    return out


def _true_residual(monkeypatch_ctx):
    """The dense normal solve refined against the unassembled operator
    (the sharded solve's refinement), for the tp = 1 comparisons."""
    plain = dense.prepare_normal

    def prepare(*args, **kw):
        kw["true_residual"] = True
        return plain(*args, **kw)

    monkeypatch_ctx.setattr(dense, "prepare_normal", prepare)


@pytest.fixture(scope="module")
def port_runs(inp):
    """The port's unsharded runs of the solver cases: plain, and (for the
    tp = 1 comparisons of pdas and affine) with the dense normal solve
    refined against the unassembled operator."""
    def solve(name):
        lp = inp["lps"][name][0]
        if name == "affine":
            return taff.affine_scaling(taff.make_affine_state(lp))
        if name == "pdas":
            return tpdas.pdas(tpdas.make_pdas(lp), tpdas.PDASConfig(**CFG))
        return tdd.pdas_dd(tdd.make_pdas_dd(lp), tpdas.PDASConfig(**DD_CFG))

    out = {k: solve(k) for k in SOLVERS}
    with pytest.MonkeyPatch.context() as mp:
        _true_residual(mp)
        out.update({f"{k}_unassembled": solve(k) for k in ("pdas", "affine")})
    return out


def _normal_unsharded(kw):
    """ops.dense.solve_normal with the sharded solve's refinement form."""
    kw = dict(kw)
    t = {v: torch.as_tensor(kw.pop(v)) for v in ("A", "d", "g")}
    if "row_boost" in kw:
        kw["row_boost"] = torch.as_tensor(kw["row_boost"])
    kw.setdefault("refine_steps", 0)
    y, ok = dense.solve_normal(t["A"], t["d"], t["g"], true_residual=True, **kw)
    return y.numpy(), bool(ok)


@pytest.mark.parametrize("name", NORMAL[:2])
def test_sharded_solve_normal_matches_jax(ranks, jax_runs, inp, name):
    """test_parallel.py::TestShardedNormal::test_matches_single_chip and
    ::test_with_refinement_and_boost: within 1e-9 (1e-8 with the
    refinement and boost) of JAX's mesh version, padded rows exactly 0;
    bit-equal to the unsharded solve at tp = 1; on lp_mesh(2, 2) too."""
    y_j, ok_j = jax_runs[name]
    tol = dict(rtol=1e-9, atol=1e-9) if name == "normal" else dict(rtol=1e-8, atol=1e-10)
    meshes = ((1, 4), (2, 2)) if name == "normal" else ((1, 4),)
    for mesh in meshes:
        r = _case(ranks, mesh, _key(name))
        assert r["ok"] and ok_j
        np.testing.assert_allclose(r["y"], y_j, **tol)
    if name == "boosted":
        np.testing.assert_array_equal(r["y"][12:], 0.0)
    y1, ok1 = _normal_unsharded(inp[name])
    r1 = _case(ranks, (1, 1), _key(name))
    assert r1["ok"] == ok1
    np.testing.assert_array_equal(r1["y"], y1)


def test_dbound_retry_and_krylov(ranks, jax_runs, inp):
    """test_parallel.py::TestShardedConditioning, f32: without the retry the
    tp factor of a kappa-1e9 N fails; with dbound and 80 PCG steps it
    solves to rel < 2e-4, and 20 PCG steps at kappa 1e8 to rel < 5e-5, as
    JAX's mesh version does; bit-equal to the unsharded solve at tp = 1."""
    rel = lambda y, x: np.linalg.norm(y.astype(np.float64) - x) / np.linalg.norm(x)  # noqa: E731
    for who in (_case(ranks, (1, 4), _key("raw9")), dict(zip(("y", "ok"), jax_runs["raw9"]))):
        assert not who["ok"]
    for key, x, bar in (("retry9", inp["x9"], 2e-4), ("krylov8", inp["x8"], 5e-5)):
        r = _case(ranks, (1, 4), _key(key))
        y_j, ok_j = jax_runs[key]
        assert r["ok"] and ok_j
        assert rel(r["y"], x) < bar and rel(y_j, x) < bar
        y1, ok1 = _normal_unsharded(inp[key])
        r1 = _case(ranks, (1, 1), _key(key))
        assert r1["ok"] == ok1
        np.testing.assert_array_equal(r1["y"], y1)


def test_sharded_refinement_is_double_word_accurate(ranks, jax_runs, inp):
    """test_parallel.py::TestShardedDDRefinement, f32: two dd refinement
    steps on each rank's block (hi and lo all-reduced apart) reach rel <
    5e-6 against the f64 solve, as JAX's mesh version does."""
    x = inp["x7"]
    for y in (_case(ranks, (1, 4), _key("dd7"))["y"], jax_runs["dd7"][0]):
        assert np.linalg.norm(y.astype(np.float64) - x) / np.linalg.norm(x) < 5e-6
    y1, _ = _normal_unsharded(inp["dd7"])
    np.testing.assert_array_equal(_case(ranks, (1, 1), _key("dd7"))["y"], y1)


@pytest.mark.parametrize("name", SOLVERS)
def test_tp_solvers_match_jax(ranks, jax_runs, port_runs, name):
    """test_parallel.py::TestShardedNormal::test_tp_pdas_end_to_end,
    ::test_tp_pdas_dd_tight_gap and TestShardedAffine: at tp = 4 the status
    of JAX's mesh run (its count too, but for affine, whose f64 end game
    follows rounding: ROADMAP §3) and x within 1e-6 of it, the count of
    the port's unsharded run; at tp = 1 bit-equal to the unsharded run
    (pdas and affine with the sharded solve's refinement form, see the
    module docstring)."""
    jr = jax_runs[name]
    r = _case(ranks, (1, 4), _key(name))
    assert int(r["status"]) == int(jr.status) == 1
    if name != "affine":
        assert int(r["iterations"]) == int(jr.iterations)
    np.testing.assert_allclose(r["x"], np.asarray(jr.x), rtol=1e-6, atol=1e-8)
    assert int(r["iterations"]) == int(port_runs[name].iterations)
    if name == "pdas_dd":
        assert float(r["gap"]) < 1e-7
    one = port_runs.get(f"{name}_unassembled", port_runs[name])
    r1 = _case(ranks, (1, 1), _key(name))
    assert int(r1["iterations"]) == int(one.iterations)
    np.testing.assert_array_equal(r1["x"], one.x.numpy())


def test_column_placement(ranks, inp):
    """test_parallel.py::test_column_sharded_lp_placement: rank k of 'tp'
    holds columns [k·N/tp, (k+1)·N/tp) of A, the shape stays whole."""
    A = inp["simple"].A.numpy()
    for mesh, tp in (((1, 4), 4), ((1, 1), 1)):
        w = A.shape[1] // tp
        for k, r in enumerate(ranks[mesh]):
            got = r[_key("placement")]
            assert got["lo"] == k * w and tuple(got["shape"]) == A.shape
            np.testing.assert_array_equal(got["A"], A[:, k * w:(k + 1) * w])


def test_tp_sparse_engine(ranks, jax_runs, inp):
    """tests/test_sparse_pipeline.py:238-330: the fully sparse pdas and
    pdas_dd with ``mesh=`` take JAX's mesh run's status and count with x
    within 1e-6, the unsharded port run's count and objective (1e-6), and
    are bit-equal to it at tp = 1."""
    sf = inp["sparse"][4][0]
    kw = dict(block=16, dtype=torch.float64, device="cpu")
    st, eng = tpdas.make_pdas_sparse(sf, **kw)
    one = {"pdas": tpdas.pdas(st, tpdas.PDASConfig(**SPARSE_CFG), engine=eng)}
    st, eng = tdd.make_pdas_dd_sparse(sf, **kw)
    one["pdas_dd"] = tdd.pdas_dd(st, tpdas.PDASConfig(**DD_CFG), engine=eng)
    for phase in ("pdas", "pdas_dd"):
        jr = jax_runs[f"sparse_{phase}"]
        r = _case(ranks, (1, 4), _key("sparse"))[phase]
        assert int(r["status"]) == int(jr.status) == 1
        assert int(r["iterations"]) == int(jr.iterations) == int(one[phase].iterations)
        np.testing.assert_allclose(r["x"], np.asarray(jr.x), rtol=1e-6, atol=1e-8)
        assert float(r["objective"]) == pytest.approx(float(one[phase].objective), rel=1e-6)
        r1 = _case(ranks, (1, 1), _key("sparse"))[phase]
        np.testing.assert_array_equal(r1["x"], one[phase].x.numpy())
        assert int(r1["iterations"]) == int(one[phase].iterations)


def test_tp_normal_ell(ranks, inp):
    """The tile engine's solve_normal_ell with ``mesh=``
    (tests/test_sparse_pipeline.py::test_mesh_solve_normal_ell_matches_single_chip):
    at tp = 4 within 1e-9 of the unsharded solve, its tiles within 1e-12
    (a slab boundary may split an entry's sum); at tp = 1 both bit-equal."""
    sf = inp["sparse"][2][0]
    eng, E, ET = T._engine_and_ell(sf, 16)
    d, g = (torch.as_tensor(inp["ell"][k]) for k in ("d", "g"))
    y, ok = eng.solve_normal_ell(E, ET, d, g, refine_steps=1)
    tiles = eng.assemble_pairs(d, torch.zeros(sf.ncons, dtype=d.dtype)).numpy()
    r4, r1 = (_case(ranks, m, _key("normal_ell")) for m in ((1, 4), (1, 1)))
    assert r4["ok"] and r1["ok"] and bool(ok)
    np.testing.assert_allclose(r4["y"], y.numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(r4["tiles"], tiles, rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(r1["y"], y.numpy())
    np.testing.assert_array_equal(r1["tiles"], tiles)


@pytest.mark.parametrize("ntp", [2, 3, 4])
def test_slab_schedules_walked_as_the_kernel_walks_them(inp, ntp):
    """The tp assembly's per-rank kernel schedules (the slab's runs, a run
    cut at a slab boundary kept in part; rank 0 alone with the boost and
    the bare diagonal slots), walked in f64 as the assembly kernel walks
    them: each equal to the plain slab assembly (1e-12), the slabs summing
    to the whole assembly (1e-12), every pair in exactly one slab."""
    from cholesky_is_magic_tpu_torch.sparse import tiled_cuda

    sf = inp["sparse"][2][0]
    eng = T._engine_and_ell(sf, 8)[0]
    rng = np.random.default_rng(ntp)
    d = torch.as_tensor(rng.random(sf.nvars) + 0.5)
    boost = torch.as_tensor((rng.random(sf.ncons) < 0.2) * 0.5)
    total, pairs = 0.0, 0
    for rank in range(ntp):
        slab = eng._slab(ntp, rank)
        starts, dst = eng._slab_runs(slab.p0, slab.p1)
        sched = tiled_cuda.kernel_schedule(eng, starts, dst, chunk=64, boost=rank == 0)
        walked = _walk(eng, sched, d.numpy(), boost.numpy())
        plain = eng._assemble_pairs_plain(d, boost, slab).numpy()
        np.testing.assert_allclose(walked, plain, rtol=1e-12, atol=1e-12)
        total, pairs = total + walked, pairs + slab.p1 - slab.p0
    assert pairs == eng.n_pairs
    whole = eng.assemble_pairs(d, boost).numpy()
    np.testing.assert_allclose(total, whole, rtol=1e-12, atol=1e-12)


def _walk(eng, sched, d, boost):
    """The tiles as the assembly kernel builds them (csrc/assemble_pairs.cu),
    in f64: zeros, then per chunk each run's pairs in schedule order plus
    its boost."""
    k, start, dst, row, chunk_run = (t.numpy() for t in sched[:5])
    w = eng.asm_w.numpy()
    out = np.zeros((eng.NT + 1) * eng.b * eng.b)
    for c in range(len(chunk_run) - 1):
        for s in range(chunk_run[c], chunk_run[c + 1]):
            acc = sum(w[p] * d[k[p]] ** 2 for p in range(start[s], start[s + 1]))
            out[dst[s]] = acc + (0.0 if row[s] < 0 else
                                 boost[row[s]] if row[s] < len(boost) else 1.0)
    return out.reshape(eng.NT + 1, eng.b, eng.b)


def test_dp_batch(ranks, jax_runs, inp):
    """test_parallel.py::TestBatched::test_dp_sharded_batch, test_api.py's
    and test_sparse_pipeline.py's solve_batch over 'dp': on lp_mesh(2, 2)
    every rank returns the whole batch, every lane equal to the unsharded
    batch (batched_pdas, batched_pdas_dd, the slabbed loop, solve_batch),
    and batched_pdas's lanes take JAX's dp-sharded statuses and counts."""
    lps = inp["batch_lps"]
    cfg, dd_cfg = tpdas.PDASConfig(**CFG), tpdas.PDASConfig(**DD_CFG)
    states = parallel.stack_states([tpdas.make_pdas(lp) for lp in lps])
    r1 = parallel.batched_pdas(states, cfg)
    dd_states = parallel.stack_states([
        tdd.make_pdas_dd(lp, warm=lanes.lane(r1, k)) for k, lp in enumerate(lps)])
    want = {
        "pdas": r1, "pdas_dd": parallel.batched_pdas_dd(dd_states, dd_cfg),
        "slabbed": parallel.batched_pdas_slabbed(states, cfg, slab_iters=8),
    }
    got = _case(ranks, (2, 2), "batch:1")
    for k, res in want.items():
        for f, v in T.result_arrays(res).items():
            np.testing.assert_array_equal(got[k][f], v, err_msg=f"{k}.{f}")
    reports = api.solve_batch([sf for sf, _ in inp["batch"]], device="cpu",
                              dtype=torch.float64, pad_multiple=16,
                              max_iters=cfg.max_iters)
    for rep, g in zip(reports, got["solve_batch"]):
        for f, v in T.result_arrays(rep.result).items():
            np.testing.assert_array_equal(g[f], v)
    jr = jax_runs["batch"]
    np.testing.assert_array_equal(got["pdas"]["status"], np.asarray(jr.status))
    np.testing.assert_array_equal(got["pdas"]["iterations"], np.asarray(jr.iterations))
    np.testing.assert_allclose(got["pdas"]["x"], np.asarray(jr.x), rtol=1e-6, atol=1e-8)


def test_dp_batched_normal_solves(ranks, inp):
    """test_sparse_pipeline.py::test_vmapped_ell_solves_match_singles over
    'dp': the lanes split over dp=2, every lane equal to the unsharded
    batched_normal_solves."""
    sf = inp["sparse"][2][0]
    eng, E, ET = T._engine_and_ell(sf, 16)
    Y, ok = parallel.batched_normal_solves(
        eng, E, ET, *(torch.as_tensor(inp["ell_batch"][k]) for k in ("D", "G")),
        refine_steps=1)
    got = _case(ranks, (2, 2), "normal_batch:2")
    np.testing.assert_array_equal(got["Y"], Y.numpy())
    np.testing.assert_array_equal(got["ok"], ok.numpy())


def test_mesh_arguments_are_checked():
    """lp_mesh needs a process group; a mesh= that is not a ('dp', 'tp')
    DeviceMesh is a TypeError wherever a solver takes one."""
    with pytest.raises(RuntimeError, match="process group"):
        parallel.lp_mesh(1, 1, device_type="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        backend.check_backend(None, None, object())
