"""Which operands go to the hand-written kernels, and what the kernels'
host-side schedules hold.

- ``cuda_build.takes_kernel``: float32 on a CUDA device goes to a kernel;
  every other dtype, mixed dtypes and every CPU tensor take the plain
  PyTorch form, as the JAX package sends non-f32 operands to its XLA form
  (``ops/dd_pallas.py`` ``_tiles``).  The three dispatchers ask it, so a
  float64 tensor never reaches a float32-only wrapper.
- afiro in f64 through the port on the CPU, dense (at the default padding)
  and fully sparse, against the same call of the JAX package: its iteration
  counts, gap and objective, inside the bars the card's f64 solves are held
  to (gap <= 1e-8, objective within 1e-7 of the published optimum).
- ``dd_cuda.rmv_slab_plain`` and ``dd_cuda.mv_order_plain`` (Aᵀ·x and A·x
  in the CUDA kernels' own summation orders) against the JAX package's
  compensated products and the f64 truth.
- ``tiled_cuda.kernel_schedule`` (the assembly kernel's 32-bit schedule)
  walked as the kernel walks it, against the JAX engine's tiles.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cholesky_is_magic_tpu as cim
import cholesky_is_magic_tpu_torch as cimt
from cholesky_is_magic_tpu.ops import dd as jdd
from cholesky_is_magic_tpu.sparse import tiled as jtiled
from cholesky_is_magic_tpu_torch.ops import chol, cuda_build, dd_cuda
from cholesky_is_magic_tpu_torch.ops import dd as ddm
from cholesky_is_magic_tpu_torch.sparse import tiled, tiled_cuda

torch.set_num_threads(1)

AFIRO = os.path.join(os.path.dirname(__file__), "fixtures", "afiro.mps")
OPTIMUM = -464.75314285714285
EPS32 = float(np.finfo(np.float32).eps)


@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_takes_kernel_by_device_and_dtype(device, dtype):
    want = device.startswith("cuda") and dtype == torch.float32
    assert cuda_build.takes_kernel(torch.device(device), dtype) is want
    assert cuda_build.takes_kernel(torch.device(device), dtype, dtype) is want


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float64),
                                    (torch.float64, torch.float32),
                                    (torch.float32, torch.float32, torch.float16)])
def test_takes_kernel_refuses_mixed_dtypes(dtypes):
    assert not cuda_build.takes_kernel(torch.device("cuda"), *dtypes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_tensors_take_the_plain_forms(dtype, monkeypatch):
    """No dispatcher reaches a wrapper with a CPU tensor of either dtype."""
    def boom(*a, **k):
        raise AssertionError("a CPU tensor reached a CUDA wrapper")

    for mod, name in ((dd_cuda, "dd_mv"), (dd_cuda, "dd_rmv"),
                      (chol.chol_cuda, "potrf"), (chol.chol_cuda, "potrf_tile_"),
                      (tiled_cuda, "assemble_pairs")):
        monkeypatch.setattr(mod, name, boom)
    rng = np.random.default_rng(0)
    A = torch.tensor(rng.normal(size=(6, 9)), dtype=dtype)
    x = torch.tensor(rng.normal(size=9), dtype=dtype)
    assert ddm.dd_matvec(A, x).hi.dtype == dtype
    assert ddm.dd_rmatvec(A, x[:6]).hi.dtype == dtype
    N = A @ A.T + torch.eye(6, dtype=dtype)
    assert chol.cholesky(N).dtype == dtype
    T, inv = N.clone(), torch.empty_like(N)
    chol.factor_tile_(T, inv)
    assert torch.allclose(inv @ T, torch.eye(6, dtype=dtype), atol=1e-4)
    eng = tiled.engine_for_sparse(A.double().numpy(), block=4, dtype=dtype,
                                  device="cpu")
    assert eng.assemble_pairs(torch.ones(9, dtype=dtype)).dtype == dtype


@pytest.mark.parametrize("kw", [dict(), dict(sparse=True, block=16)],
                         ids=["dense", "sparse"])
def test_afiro_f64_counts_gap_and_objective(kw):
    ref = cim.solve(AFIRO, "pdas_dd", dtype=jnp.float64, **kw)
    rep = cimt.solve(AFIRO, "pdas_dd", dtype=torch.float64, device="cpu", **kw)
    assert rep.status == ref.status == "optimal"
    for key in ("phase1_iterations", "iterations"):
        assert rep.summary[key] == ref.summary[key]
    assert rep.summary["gap"] == pytest.approx(ref.summary["gap"], rel=1e-3)
    assert rep.objective == pytest.approx(ref.objective, rel=1e-10)
    assert rep.summary["gap"] <= 1e-8
    assert abs(rep.objective - OPTIMUM) <= 1e-7 * abs(OPTIMUM)


@pytest.mark.parametrize("m,n,sms,lanes", [
    pytest.param(m, n, sms, lanes, id="-".join(map(str, (m, n, sms)))
                 + (f"-{lanes}lanes" if lanes > 1 else ""))
    for m, n, sms, lanes in [(1, 1, 132, 1), (7, 300, 132, 1), (300, 7, 132, 1),
                             (129, 257, 132, 1), (200, 520, 8, 1), (64, 64, 132, 1),
                             (64, 128, 132, 1), (64, 64, 132, 2), (64, 128, 132, 2)]])
def test_rmv_slab_plain_matches_jax_and_the_truth(m, n, sms, lanes):
    """The kernel's summation order (rows ascending per slab, slabs
    ascending) on f32 inputs: within 64·eps32² of Σ|a_ij x_i| of the JAX
    package's compensated Aᵀ·x (another order), and 1e-11 of the f64 truth;
    a batch is its lanes, each bit-equal to the single call on it."""
    rng = np.random.default_rng(m * n)
    A = rng.normal(size=(lanes, m, n)).astype(np.float32)
    x = rng.normal(size=(lanes, m)).astype(np.float32)
    slabs, rows = dd_cuda.rmv_slabs(m, n, sms)
    assert slabs == -(-m // rows) and (slabs - 1) * rows < m <= slabs * rows
    if lanes == 1:
        got = dd_cuda.rmv_slab_plain(torch.from_numpy(A[0]), torch.from_numpy(x[0]),
                                     slabs, rows)
        got = ddm.DD(got.hi[None], got.lo[None])
    else:
        got = dd_cuda.rmv_slab_plain(torch.from_numpy(A), torch.from_numpy(x), slabs, rows)
        one = dd_cuda.rmv_slab_plain(torch.from_numpy(A[1]), torch.from_numpy(x[1]),
                                     slabs, rows)
        assert torch.equal(got.hi[1], one.hi) and torch.equal(got.lo[1], one.lo)
    assert got.hi.dtype == torch.float32 and got.hi.shape == (lanes, n)
    got = got.hi.double().numpy() + got.lo.double().numpy()
    for k in range(lanes):
        ref = jdd._dd_matvec_xla(jnp.asarray(A[k]).T, jnp.asarray(x[k]))
        ref = np.asarray(ref.hi, np.float64) + np.asarray(ref.lo, np.float64)
        scale = np.abs(A[k]).astype(np.float64).T @ np.abs(x[k]).astype(np.float64)
        assert np.all(np.abs(got[k] - ref) <= 64 * EPS32**2 * scale)
        np.testing.assert_allclose(got[k], A[k].astype(np.float64).T @ x[k].astype(np.float64),
                                   rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("m,n", [(1, 1), (64, 64), (37, 91), (5, 300), (300, 7),
                                 (3, 700)])
def test_mv_order_plain_matches_jax_and_the_truth(m, n):
    """dd A·x in the CUDA kernels' summation order (128 threads over the
    columns, each warp's shuffle tree, the warps in order) on f32 inputs:
    within 64·eps32² of Σ|a_ij x_j| of the JAX package's compensated A·x
    (another order), and 1e-11 of the f64 truth; a batch is its lanes."""
    rng = np.random.default_rng(m + n)
    A = rng.normal(size=(2, m, n)).astype(np.float32)
    x = rng.normal(size=(2, n)).astype(np.float32)
    got = dd_cuda.mv_order_plain(torch.from_numpy(A), torch.from_numpy(x))
    assert got.hi.dtype == torch.float32 and got.hi.shape == (2, m)
    one = dd_cuda.mv_order_plain(torch.from_numpy(A[1]), torch.from_numpy(x[1]))
    assert torch.equal(got.hi[1], one.hi) and torch.equal(got.lo[1], one.lo)
    got = got.hi.double().numpy() + got.lo.double().numpy()
    for k in range(2):
        ref = jdd._dd_matvec_xla(jnp.asarray(A[k]), jnp.asarray(x[k]))
        ref = np.asarray(ref.hi, np.float64) + np.asarray(ref.lo, np.float64)
        scale = np.abs(A[k]).astype(np.float64) @ np.abs(x[k]).astype(np.float64)
        assert np.all(np.abs(got[k] - ref) <= 64 * EPS32**2 * scale)
        np.testing.assert_allclose(got[k], A[k].astype(np.float64) @ x[k].astype(np.float64),
                                   rtol=1e-11, atol=1e-11)


def test_rmv_slabs_keeps_its_partition():
    """The partition fixes the order of the kernel's sums: the pilot shape
    on an H100's 132 SMs stays 27 slabs of 57 rows."""
    assert dd_cuda.rmv_slabs(1536, 5120, 132) == (27, 57)
    assert dd_cuda.rmv_slabs(4096, 8192, 132) == (17, 241)
    assert dd_cuda.rmv_slabs(1, 1, 132) == (1, 1)
    # The batched finishers' and afiro's shapes, on the short-lane kernel.
    assert dd_cuda.rmv_slabs(64, 64, 132) == (2, 32)
    assert dd_cuda.rmv_slabs(64, 128, 132) == (2, 32)
    assert dd_cuda.rmv_slabs(128, 128, 132) == (4, 32)
    assert dd_cuda.rmv_slabs(512, 128, 132)[0] == dd_cuda.RMV_SHORT_SLABS == 16
    assert dd_cuda.rmv_slabs(544, 128, 132) == (17, 32)


def _walk_schedule(eng, sched, d, boost):
    """The tiles as the assembly kernel builds them, in f64 numpy: zeros,
    then per chunk each run's pairs summed in schedule order plus its
    boost."""
    k, start, dst, row, chunk_run = (t.numpy() for t in sched[:5])
    w = eng.asm_w.numpy()
    total = (eng.NT + 1) * eng.b * eng.b
    out = np.zeros(total)
    chunks = -(-total // sched.chunk)
    assert chunk_run.shape == (chunks + 1,) and chunk_run[-1] == len(dst)
    for c in range(chunks):
        for s in range(chunk_run[c], chunk_run[c + 1]):
            assert c * sched.chunk <= dst[s] < (c + 1) * sched.chunk
            acc = 0.0
            for p in range(start[s], start[s + 1]):
                acc += w[p] * d[k[p]] ** 2
            bst = 0.0 if row[s] < 0 else (boost[row[s]] if row[s] < len(boost) else 1.0)
            out[dst[s]] = acc + bst
    return out.reshape(eng.NT + 1, eng.b, eng.b)


@pytest.mark.parametrize("block,chunk", [(4, 4), (8, 64), (16, 4096), (5, 12)])
def test_kernel_schedule_walk_matches_the_jax_engine(block, chunk):
    """The 32-bit schedule (runs, empty runs on bare diagonal slots, boosted
    rows, chunk offsets) reproduces the JAX engine's assemble_pairs to
    1e-12 in f64, with runs of length 1 and a long diagonal run."""
    rng = np.random.default_rng(block)
    m, n = 37, 80
    A = (rng.random((m, n)) < 0.08) * rng.normal(size=(m, n))
    A[np.arange(m), np.arange(m)] += 2.0
    A[3, :] = rng.normal(size=n)  # a long diagonal run
    d = rng.random(n) + 0.5
    boost = (rng.random(m) < 0.2) * 0.75
    eng = tiled.engine_for_sparse(A, block=block, dtype=torch.float64, device="cpu")
    assert eng._kernel_schedule is None  # made for float32 on a card only
    sched = tiled_cuda.kernel_schedule(eng, eng.asm_run_start.numpy(),
                                       eng.asm_run_dst.numpy(), chunk)
    assert all(t.dtype == torch.int32 for t in sched[:5])
    lengths = np.diff(sched.run_start.numpy())
    assert lengths.min() == 0 and (lengths == 1).any() and lengths.max() >= n // 2
    assert np.all(np.diff(sched.run_dst.numpy()) > 0)
    got = _walk_schedule(eng, sched, d, boost)
    plain = eng._assemble_pairs_plain(torch.from_numpy(d), torch.from_numpy(boost))
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-12, atol=1e-12)
    jeng = jtiled.engine_for_sparse(A, block=block, dtype=jnp.float64)
    ref = jeng.assemble_pairs(jnp.asarray(d), jnp.asarray(boost))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("block", [8, 16, 32, 128])
def test_kernel_schedule_walk_in_f32_is_the_plain_version_bit_for_bit(block):
    """Walked with the kernel's roundings (d², w·d², a running f32 sum in
    schedule order, the boost last), the schedule gives the plain version's
    f32 tiles on the CPU bit for bit: the card's kernel is held to them."""
    rng = np.random.default_rng(block)
    m, n = 150, 260
    A = (rng.random((m, n)) < 0.04) * rng.normal(size=(m, n))
    A[np.arange(m), np.arange(m)] += 2.0
    A[7, :] = rng.normal(size=n)
    eng = tiled.engine_for_sparse(A, block=block, device="cpu")
    d = (rng.random(n) + 0.5).astype(np.float32)
    boost = ((rng.random(m) < 0.1) * 1.0).astype(np.float32)
    sched = tiled_cuda.kernel_schedule(eng, eng.asm_run_start.numpy(),
                                       eng.asm_run_dst.numpy())
    k, start, dst, row, _ = (t.numpy() for t in sched[:5])
    vals = eng.asm_w.numpy() * (d * d)[k]
    out = np.zeros((eng.NT + 1) * block * block, np.float32)
    for s in range(len(dst)):
        acc = np.float32(0.0)
        for p in range(start[s], start[s + 1]):
            acc = acc + vals[p]
        bst = np.float32(0.0 if row[s] < 0 else boost[row[s]] if row[s] < m else 1.0)
        out[dst[s]] = acc + bst if start[s + 1] > start[s] else bst
    assert out.dtype == np.float32 and np.diff(start).max() >= n
    plain = eng._assemble_pairs_plain(torch.from_numpy(d), torch.from_numpy(boost))
    np.testing.assert_array_equal(out.reshape(plain.shape), plain.numpy())


def test_kernel_schedule_refuses_indices_past_32_bits():
    eng = tiled.engine_for_sparse(np.eye(3), block=2, device="cpu")
    with pytest.raises(ValueError, match="32-bit"):
        tiled_cuda.kernel_schedule(eng, eng.asm_run_start.numpy(),
                                   eng.asm_run_dst.numpy(), chunk=2**31)
