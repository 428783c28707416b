"""The tile engine's Schur kernel on the card (``csrc/tile_schur.cu``,
``sparse/tiled_cuda.py``), bit for bit against its own sums in plain
PyTorch (``chol_cuda.tile_schur_fma_plain``): single and under
``torch.func.vmap`` on 1, 7 and 32 lanes, on random tiles of widths 16 to
257 and on the panels of a QAP relaxation's engine (one pair, the diagonal
destinations, the widest panel, the last panel with pairs); NaN and Inf in
an operand; the launch counts and what launches nothing (float64, CPU
tensors, the ``mesh=`` route).  Then ``TiledCholesky.factorize`` with the
kernel against its plain route (gathers, SGEMM, ``index_add_``) on the QAP
relaxation at n = 8 and 12, both held to the plain float64 normal
equations within ``lpbench/normal_check.py``'s tolerances, and a 4-lane
n = 8 fleet to each lane's exact optimum within the cell's limits.

Every test here needs an NVIDIA card and skips without one.  The file
imports no jax; run it on the card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_tile_schur.py -m cuda
"""

import json
import pathlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cholesky_is_magic_tpu_torch.ops import chol_cuda
from cholesky_is_magic_tpu_torch.sparse import tiled, tiled_cuda

pytestmark = pytest.mark.cuda

ROOT = pathlib.Path(__file__).resolve().parents[1]


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


def _plain(L, a, b, dst):
    """What the kernel leaves in L (leading axes lanes), on L's device."""
    out = L.clone()
    out[..., dst, :, :] = chol_cuda.tile_schur_fma_plain(
        L[..., dst, :, :], L[..., a, :, :], L[..., b, :, :])
    return out


def _tiles(rng, lanes, nt, b, dev):
    shape = (lanes, nt, b, b)
    v = rng.normal(size=shape) * np.exp(2 * rng.normal(size=shape))
    return torch.from_numpy(v.astype(np.float32)).to(dev)


def _panel(rows: int, first: int = 0):
    """A panel of ``rows`` row tiles (tiles first .. first + rows - 1) and
    every pair i >= j of them, each into a tile of its own after them: the
    pair lists as ``TiledCholesky`` builds them."""
    a, b = zip(*[(first + i, first + j) for i in range(rows) for j in range(i + 1)])
    dst = range(first + rows, first + rows + len(a))
    return [torch.tensor(x, dtype=torch.int64) for x in (a, b, dst)]


def _run(L, pairs, lanes_batched, vmapped):
    a, b, dst = (t.to(L.device) for t in pairs)
    out = L.clone()
    if not lanes_batched:
        tiled_cuda.tile_schur_(out, a, b, dst)
    elif vmapped:
        def lane(x):
            y = x.clone()
            tiled_cuda.tile_schur(y, a, b, dst, per_lane=True)
            return y

        out = torch.func.vmap(lane)(L)
    else:
        tiled_cuda.tile_schur_batched_(out, a, b, dst)
    torch.cuda.synchronize()
    return out, (a, b, dst)


@pytest.mark.parametrize("b", [16, 32, 48, 128, 130, 257])
@pytest.mark.parametrize("rows", [1, 3])
def test_kernel_is_its_plain_sums_on_one_lane(dev, b, rows):
    """Widths below, at and above 128 (a tile in 128 blocks), a ragged last
    stage of k (48, 130, 257) and rows not on 16-byte boundaries (130, 257)."""
    rng = np.random.default_rng([b, rows])
    pairs = _panel(rows)
    nt = rows + len(pairs[0]) + 1
    L = _tiles(rng, 1, nt, b, dev)[0]
    before = tiled_cuda.LAUNCHES["tile_schur"]
    got, ops = _run(L, pairs, False, False)
    assert tiled_cuda.LAUNCHES["tile_schur"] == before + 1
    assert _same_bits(got, _plain(L, *ops))


@pytest.mark.parametrize("lanes", [1, 7, 32])
@pytest.mark.parametrize("vmapped", [False, True], ids=["batched", "vmap"])
def test_every_lane_is_its_plain_sums(dev, lanes, vmapped):
    """One launch for every lane, single-launch bits in each: the batched
    wrapper and the operator under vmap."""
    rng = np.random.default_rng([lanes, vmapped])
    pairs = _panel(5)
    L = _tiles(rng, lanes, 5 + len(pairs[0]) + 1, 128, dev)
    key = "tile_schur_batched"
    before = dict(tiled_cuda.LAUNCHES)
    got, ops = _run(L, pairs, True, vmapped)
    assert tiled_cuda.LAUNCHES[key] == before[key] + 1
    assert tiled_cuda.LAUNCHES["tile_schur"] == before["tile_schur"]
    assert _same_bits(got, _plain(L, *ops))
    for k in range(lanes):
        one, _ = _run(L[k], pairs, False, False)
        assert _same_bits(got[k], one)


def test_lanes_at_any_stride(dev):
    """Lanes that are not row-major run on a copy written back; a lane
    stride that is not a multiple of 4 floats launches unaligned."""
    rng = np.random.default_rng(5)
    pairs = _panel(3)
    nt = 3 + len(pairs[0]) + 1
    base = _tiles(rng, 4, nt, 32, dev)
    a, b, dst = (t.to(dev) for t in pairs)
    want = _plain(base, a, b, dst)
    strided = base.transpose(0, 1).contiguous().transpose(0, 1)  # tiles outermost
    tiled_cuda.tile_schur_batched_(strided, a, b, dst)
    flat = torch.empty(4 * nt * 32 * 32 + 4 * 3, device=dev)
    odd = flat.as_strided(base.shape, (nt * 32 * 32 + 3, 32 * 32, 32, 1))
    odd.copy_(base)
    tiled_cuda.tile_schur_batched_(odd, a, b, dst)
    torch.cuda.synchronize()
    assert _same_bits(strided, want) and _same_bits(odd, want)


def _qap_engine(n, block, dev, dtype=torch.float32):
    from cholesky_is_magic_tpu_torch.ingest.standard_form import scale_constraints
    from lpbench.gen import qap_relaxation as qap

    f = qap.fleet(n, 0, 1, lanes=1)
    vals, _ = scale_constraints(f.rows.astype(np.int32), f.vals, f.b[0])
    A = sp.csc_matrix((vals, (f.rows, f.cols)), shape=(f.m, f.n))
    return f, vals, tiled.engine_for_sparse(A, block=block, dtype=dtype, device=dev)


def test_the_engines_panels(dev):
    """The QAP relaxation's engine at n = 8, block 32: the panel of one pair,
    the widest panel, the last panel with pairs (every panel's pairs include
    its diagonal destinations i = j), on 7 lanes under vmap and one alone."""
    _, _, eng = _qap_engine(8, 32, dev)
    ns = eng._n_syrk
    with_pairs = [k for k in range(eng.B) if ns[k]]
    picks = {min(with_pairs, key=lambda k: (ns[k], k)), max(with_pairs, key=lambda k: ns[k]),
             with_pairs[-1]}
    assert 1 in [ns[k] for k in picks]
    rng = np.random.default_rng(8)
    L = _tiles(rng, 7, eng.NT + 1, eng.b, dev)
    for k in sorted(picks):
        pairs = [t[k, :ns[k]].cpu() for t in (eng.syrk_a, eng.syrk_b, eng.syrk_dst)]
        assert torch.any(pairs[0] == pairs[1])  # diagonal destinations
        for batched in (False, True):
            src = L if batched else L[3]
            got, ops = _run(src, pairs, batched, batched)
            assert _same_bits(got, _plain(src, *ops)), (k, batched)


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), float("-inf")])
def test_nan_and_inf_spread_as_in_the_plain_form(dev, bad):
    rng = np.random.default_rng(11)
    pairs = _panel(3)
    L = _tiles(rng, 2, 3 + len(pairs[0]) + 1, 64, dev)
    L[0, 1, 5, 7] = bad   # an operand: row 5 of every product with tile 1
    L[1, 0, 0, 0] = bad
    L[1, 2, 9, 3] = bad
    got, ops = _run(L, pairs, True, True)
    want = _plain(L, *ops)
    assert _same_bits(got, want)
    assert not torch.isfinite(got).all()


def test_what_launches_nothing(dev, monkeypatch):
    """float64 on the card and float32 on the CPU factor by the plain
    route; so does the mesh route, whatever the dtype."""
    f, vals, eng64 = _qap_engine(5, 16, dev, torch.float64)
    rng = np.random.default_rng(3)
    d = torch.as_tensor(np.exp(rng.uniform(-1, 1, f.n)), device=dev)
    before = dict(tiled_cuda.LAUNCHES)
    eng64.factorize(eng64.assemble_pairs(d, torch.zeros(f.m, dtype=d.dtype, device=dev)))
    _, _, eng_cpu = _qap_engine(5, 16, "cpu")
    eng_cpu.factorize(eng_cpu.assemble_pairs(d.float().cpu()))
    torch.cuda.synchronize()
    assert tiled_cuda.LAUNCHES == before
    _, _, eng32 = _qap_engine(5, 16, dev)
    tiles = eng32.assemble_pairs(d.float())
    before = dict(tiled_cuda.LAUNCHES)

    class OneRank:  # a 'tp' group of one, without a process group
        def get_group(self, name):
            return None

        def get_local_rank(self, name):
            return 0

    import torch.distributed as dist

    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1)
    monkeypatch.setattr(dist, "all_reduce", lambda t, group=None: t)
    L_mesh, _, ok = eng32.factorize(tiles, mesh=OneRank())
    assert bool(ok) and tiled_cuda.LAUNCHES == before
    L, _, ok = eng32.factorize(tiles)
    assert bool(ok) and tiled_cuda.LAUNCHES["tile_schur"] == (
        before["tile_schur"] + sum(1 for k in eng32._n_syrk if k))


def _dense(eng, L):
    b = eng.b
    out = torch.zeros((eng.B * b, eng.B * b), dtype=L.dtype, device=L.device)
    for t, (i, j) in enumerate(eng.tiles):
        out[i * b:(i + 1) * b, j * b:(j + 1) * b] = L[t]
    return out


@pytest.mark.parametrize("n", [8, 12])
def test_factorize_with_the_kernel_against_the_plain_route(dev, monkeypatch, n):
    """At block 128 (the cells' block): the factor with the kernel and by
    the plain route each within normal_check.py's tolerances of the float64
    normal equations (backward error 1e-5, solve residual 1e-6, forward
    error cond times 1e-6), and within that of each other."""
    from cholesky_is_magic_tpu_torch.ops import sparse_ops
    from lpbench import normal_plain as plain
    from lpbench.normal_check import FACTOR_TOL, SOLVE_TOL

    f, vals, eng = _qap_engine(n, 128, dev)
    rng = np.random.default_rng([n, 23])
    d = torch.as_tensor(np.exp(rng.uniform(-1.5, 1.5, f.n)), dtype=torch.float32, device=dev)
    boost = torch.as_tensor(1e-6 * rng.random(f.m), dtype=torch.float32, device=dev)
    tiles = eng.assemble_pairs(d, boost)
    before = tiled_cuda.LAUNCHES["tile_schur"]
    L_k, invd_k, ok_k = eng.factorize(tiles)
    assert tiled_cuda.LAUNCHES["tile_schur"] > before
    monkeypatch.setattr(tiled, "takes_kernel", lambda *a: False)
    L_p, invd_p, ok_p = eng.factorize(tiles)
    monkeypatch.undo()
    assert bool(ok_k) and bool(ok_p)
    d64, b64 = d.double().cpu().numpy(), boost.double().cpu().numpy()
    N_slot = plain.normal_matrix(f.rows, f.cols, vals, f.m, d64, b64,
                                 perm=eng.pperm.cpu().numpy(), device=dev)
    errs = [plain.backward_error(N_slot, _dense(eng, L)) for L in (L_k, L_p)]
    assert max(errs) <= FACTOR_TOL, errs
    between = float(torch.linalg.norm(_dense(eng, L_k) - _dense(eng, L_p))
                    / torch.linalg.norm(_dense(eng, L_p)))
    assert between <= FACTOR_TOL, between
    N = plain.normal_matrix(f.rows, f.cols, vals, f.m, d64, b64, device=dev)
    g = torch.as_tensor(rng.standard_normal(f.m), dtype=torch.float32, device=dev)
    want = plain.solve(plain.factor(N), g.double())
    cond = float(torch.linalg.cond(N))
    E = sparse_ops.from_coo(f.rows, f.cols, vals, (f.m, f.n), dtype=torch.float32, device=dev)
    ET = sparse_ops.from_coo(f.cols, f.rows, vals, (f.n, f.m), dtype=torch.float32,
                             device=dev)
    y, ok = eng.solve_normal_ell(E, ET, d, g, row_boost=boost, refine_steps=0)
    assert bool(ok)
    assert plain.residual_error(N, y, g) <= SOLVE_TOL
    err = float(torch.linalg.norm(y.double() - want) / torch.linalg.norm(want))
    assert err <= cond * SOLVE_TOL, (err, cond)


def test_a_fleet_reaches_each_lanes_exact_optimum(dev):
    """Four lanes of n = 8 on one engine at block 128, float32, the qap15
    configuration's pdas settings: every lane optimal and within the cell's
    limits (``lpbench/limits/qap15.fleet32.json``), the Schur kernel
    launched batched."""
    from lpbench.drive import Driver
    from lpbench.reference import check

    config = json.loads((ROOT / "lpbench/configs/qap15.json").read_text())
    config = {k: v for k, v in config.items() if k not in ("m", "n_struct")}
    config["n"] = 8
    traffic = {"entry": "sparse_fleet", "block": 128, "lanes": 4, "phases": ["phase1"]}
    limits = json.loads((ROOT / "lpbench/limits/qap15.fleet32.json").read_text())["limits"]
    drv = Driver(config, traffic, 2**31 + 23, "cuda")
    drv.setup()
    before = tiled_cuda.LAUNCHES["tile_schur_batched"]
    call = drv.call()
    drv.to_host(call)
    assert tiled_cuda.LAUNCHES["tile_schur_batched"] > before
    assert drv.stopped(call) == 4
    got = check.worst(drv.fleet, drv.path, [drv.iterates(call)], "float32")
    assert check.verdict(got, limits), got
