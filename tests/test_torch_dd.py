"""The port's double-word arithmetic, held against the JAX package bit for
bit, and the CPU side of its CUDA kernel wrapper.

Every op of ``ops/dd.py`` and the plain matvec ``_dd_matvec_plain`` (for A
and Aᵀ, ragged shapes) must be bit-equal to the JAX package's eager ops in
f64 and f32: both run IEEE round-to-nearest with no contraction, in the
same order.  ``dd_matvec_dd`` / ``dd_rmatvec_dd`` add a working-precision
BLAS matvec of the lo part, whose summation order differs between the two
frameworks: they agree to 1e-15 relative of Σ|A|·|x| instead.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py); here the wrapper's build plumbing is tested."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cholesky_is_magic_tpu.ops import dd as jdd
from cholesky_is_magic_tpu_torch.ops import dd as tdd
from cholesky_is_magic_tpu_torch.ops import cuda_build
from cholesky_is_magic_tpu_torch.ops import dd_cuda

torch.set_num_threads(1)

DTYPES = ["float64", "float32"]


def _rand(rng, shape, dtype, spread=6):
    """Values over ~2*spread decades, with signs, zeros and exact ties."""
    v = rng.normal(size=shape) * 10.0 ** rng.uniform(-spread, spread, size=shape)
    v = np.where(rng.random(shape) < 0.05, 0.0, v)
    return v.astype(dtype)


def _dd(rng, shape, dtype):
    """A normalized double-word (numpy pair, fast_two_sum in ``dtype``)."""
    a = _rand(rng, shape, dtype)
    b = (a * rng.normal(size=shape) * 1e-9).astype(dtype)
    s = (a + b).astype(dtype)
    return s, (b - (s - a)).astype(dtype)


def _both(x):
    """numpy -> (jax array, torch tensor), or a pair -> (jax DD, torch DD)."""
    if isinstance(x, tuple):
        (jh, th), (jl, tl) = _both(x[0]), _both(x[1])
        return jdd.DD(jh, jl), tdd.DD(th, tl)
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def _equal(j, t):
    if isinstance(j, tuple):
        assert isinstance(t, tuple) and len(j) == len(t)
        for a, b in zip(j, t):
            _equal(a, b)
        return
    a, b = np.asarray(j), t.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


BINARY_W = ["two_sum", "fast_two_sum", "two_prod", "dd_dot"]
BINARY_DD = ["dd_add", "dd_sub", "dd_mul", "dd_div"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", BINARY_W)
def test_working_precision_ops_bit_equal(op, dtype):
    rng = np.random.default_rng(sum(map(ord, op)))
    (ja, ta), (jb, tb) = _both(_rand(rng, 333, dtype)), _both(_rand(rng, 333, dtype))
    _equal(getattr(jdd, op)(ja, jb), getattr(tdd, op)(ta, tb))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", BINARY_DD)
def test_double_word_ops_bit_equal(op, dtype):
    rng = np.random.default_rng(len(op))
    (jx, tx), (jy, ty) = _both(_dd(rng, 257, dtype)), _both(_dd(rng, 257, dtype))
    _equal(getattr(jdd, op)(jx, jy), getattr(tdd, op)(tx, ty))


@pytest.mark.parametrize("dtype", DTYPES)
def test_mixed_and_unary_ops_bit_equal(dtype):
    rng = np.random.default_rng(7)
    (jx, tx) = _both(_dd(rng, 129, dtype))
    (jy, ty) = _both(_dd(rng, 129, dtype))
    (jw, tw) = _both(_rand(rng, 129, dtype))
    c = rng.random(129) < 0.5
    jc, tc = _both(c)
    _equal(jdd.dd_add_w(jx, jw), tdd.dd_add_w(tx, tw))
    _equal(jdd.dd_scale(jx, jw), tdd.dd_scale(tx, tw))
    _equal(jdd.dd_neg(jx), tdd.dd_neg(tx))
    _equal(jdd.dd_from(jw), tdd.dd_from(tw))
    _equal(jdd.dd_where(jc, jx, jy), tdd.dd_where(tc, tx, ty))
    _equal(jdd.dd_less(jx, jy), tdd.dd_less(tx, ty))
    _equal(jx.to_working(), tx.to_working())
    lo = np.minimum(_rand(rng, 129, dtype), 0).astype(dtype)
    hi = (lo + np.abs(_rand(rng, 129, dtype))).astype(dtype)
    (jl, tl), (jh, th) = _both(lo), _both(hi)
    _equal(jdd.dd_clip(jx, jl, jh), tdd.dd_clip(tx, tl, th))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 2, 7, 64, 100, 333])
def test_reductions_bit_equal(n, dtype):
    rng = np.random.default_rng(n)
    (jx, tx) = _both(_dd(rng, (5, n), dtype))
    for axis in (-1, 0):
        _equal(jdd.dd_sum(jx, axis=axis), tdd.dd_sum(tx, axis=axis))
        _equal(jdd.dd_min(jx, axis=axis), tdd.dd_min(tx, axis=axis))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(200, 333), (1, 17), (37, 5), (64, 128)])
def test_plain_matvec_bit_equal(shape, dtype):
    """_dd_matvec_plain, the plain version of both CUDA kernels, against
    the JAX package's _dd_matvec_xla, for A and Aᵀ on ragged shapes; the
    CPU dispatch of dd_matvec / dd_rmatvec / dd_residual takes it."""
    rng = np.random.default_rng(sum(shape))
    m, n = shape
    (jA, tA) = _both(_rand(rng, shape, dtype, spread=3))
    (jx, tx) = _both(_rand(rng, n, dtype, spread=3))
    (jy, ty) = _both(_rand(rng, m, dtype, spread=3))
    _equal(jdd._dd_matvec_xla(jA, jx), tdd._dd_matvec_plain(tA, tx))
    _equal(jdd._dd_matvec_xla(jA.T, jy), tdd._dd_matvec_plain(tA.T, ty))
    before = dict(dd_cuda.LAUNCHES)
    _equal(jdd.dd_matvec(jA, jx), tdd.dd_matvec(tA, tx))
    _equal(jdd.dd_rmatvec(jA, jy), tdd.dd_rmatvec(tA, ty))
    _equal(jdd.dd_residual(jy, jA, jx), tdd.dd_residual(ty, tA, tx))
    assert dd_cuda.LAUNCHES == before  # CPU tensors never reach a kernel


@pytest.mark.parametrize("dtype", DTYPES)
def test_matvec_dd_agrees(dtype):
    rng = np.random.default_rng(11)
    m, n = 48, 80
    A = _rand(rng, (m, n), dtype, spread=2)
    (jA, tA) = _both(A)
    (jx, tx) = _both(_dd(rng, n, dtype))
    (jy, ty) = _both(_dd(rng, m, dtype))
    for j, t, scale in (
        (jdd.dd_matvec_dd(jA, jx), tdd.dd_matvec_dd(tA, tx),
         np.abs(A) @ np.abs(np.asarray(jx.hi, np.float64))),
        (jdd.dd_rmatvec_dd(jA, jy), tdd.dd_rmatvec_dd(tA, ty),
         np.abs(A).T @ np.abs(np.asarray(jy.hi, np.float64))),
    ):
        a = np.asarray(j.hi, np.float64) + np.asarray(j.lo, np.float64)
        b = t.hi.numpy().astype(np.float64) + t.lo.numpy().astype(np.float64)
        tol = (1e-15 if dtype == "float64" else 1e-12) * (scale + 1e-300)
        assert np.all(np.abs(a - b) <= tol)


def test_split_constant_and_dtype_guard():
    assert tdd._split_constant(torch.float32) == 4097.0
    assert tdd._split_constant(torch.float64) == 2.0**27 + 1
    with pytest.raises(ValueError):
        tdd._split_constant(torch.float16)


def test_wrapper_refuses_cpu_tensors():
    A, x = torch.zeros(4, 3), torch.zeros(3)
    with pytest.raises(ValueError, match="CUDA"):
        dd_cuda.dd_mv(A, x)
    with pytest.raises(ValueError, match="CUDA"):
        dd_cuda.dd_rmv(A, torch.zeros(4))


def test_missing_nvcc_is_a_clear_error(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has the CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()


def test_nvcc_found_through_cuda_home(monkeypatch, tmp_path):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert cuda_build.find_nvcc() == str(nvcc)


def test_library_is_keyed_by_the_sources(monkeypatch, tmp_path):
    real = cuda_build.sources()
    assert [p.name for p in real] == ["assemble_pairs.cu", "bell_dd.cu",
                                      "dd_matvec.cu", "potrf.cu", "tile_schur.cu",
                                      "tile_solve.cu"]
    path = cuda_build.library_path()
    assert path.parent == cuda_build.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "cim_torch_kernels")
    assert "--fmad=false" in cuda_build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    assert not any("fast_math" in f for f in cuda_build.NVCC_FLAGS)
    for src in real:
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    assert cuda_build.library_path() == path
    edited = tmp_path / "potrf.cu"
    edited.write_bytes(edited.read_bytes() + b"\n// edited\n")
    assert cuda_build.library_path() != path


@pytest.mark.parametrize("m,n", [(1, 1), (31, 7), (512, 1024), (1441, 5093),
                                 (1536, 5120), (4096, 8192), (100000, 3)])
def test_rmv_slabs_cover_every_row(m, n):
    slabs, rows = dd_cuda.rmv_slabs(m, n, sms=132)
    assert 1 <= slabs <= 65535 and rows >= 1
    assert slabs * rows >= m and (slabs - 1) * rows < m
    assert rows >= min(32, m)
