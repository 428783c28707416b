"""The port's blocked Cholesky (ops/chol.py) and the dense factorize
options, held against the JAX package in f64.

On the CPU the JAX ``pallas_chol.cholesky`` runs its plain
``blocked_cholesky`` (it takes the Pallas kernel only on a TPU), and the
port's ``cholesky`` runs its own ``blocked_cholesky``: the factors agree
within 1e-12 relative.  So the port's ``factorize(use_pallas=True)`` is held
against both JAX ``use_pallas=True`` and ``blocked=True``.  A non-PD input
gives NaN and ``ok`` False in both.
The tile factor of the sparse engine (``factor_tile_``) is held against
the JAX engine's ``cholesky`` + ``solve_triangular``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cholesky_is_magic_tpu.ops import dense as jdense
from cholesky_is_magic_tpu.ops import pallas_chol as jchol
from cholesky_is_magic_tpu_torch.ops import chol as tchol
from cholesky_is_magic_tpu_torch.ops import chol_cuda
from cholesky_is_magic_tpu_torch.ops import dense as tdense

torch.set_num_threads(1)


# The JAX functions, compiled once per shape.
J_BLOCKED = jax.jit(jchol.blocked_cholesky)
J_CHOLESKY = jax.jit(jchol.cholesky)
J_FACTORIZE = jax.jit(jdense.factorize, static_argnames=("use_pallas", "blocked"))


def _spd(n, seed):
    """A well-conditioned SPD matrix with entries spread over 2 decades."""
    rng = np.random.default_rng(seed)
    s = 10.0 ** rng.uniform(-1, 1, n)
    M = rng.normal(size=(n, n))
    return s[:, None] * (M @ M.T / n + np.eye(n)) * s[None, :]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


@pytest.mark.parametrize("n", [1, 7, 24, 33])
def test_blocked_cholesky_matches_jax(n):
    N = _spd(n, n)
    L = tchol.blocked_cholesky(torch.from_numpy(N)).numpy()
    assert _rel(J_BLOCKED(jnp.asarray(N)), L) <= 1e-12
    assert _rel(J_CHOLESKY(jnp.asarray(N)), L) <= 1e-12
    np.testing.assert_array_equal(np.triu(L, 1), 0.0)
    assert _rel(tchol.cholesky(torch.from_numpy(N)), L) == 0.0
    assert _rel(np.linalg.cholesky(N), L) <= 1e-12


@pytest.mark.parametrize("jax_opts, opts", [
    (dict(use_pallas=True), dict(use_pallas=True)),
    (dict(blocked=True), dict(use_pallas=True)),
    (dict(), dict()),
])
def test_factorize_options_match_jax(jax_opts, opts):
    N = _spd(40, 3)
    fj = J_FACTORIZE(jnp.asarray(N), **jax_opts)
    ft = tdense.factorize(torch.from_numpy(N), **opts)
    assert bool(fj.ok) and bool(ft.ok)
    assert _rel(fj.L, ft.L) <= 1e-12
    bad = N.copy()
    bad[25, 25] = -1.0
    fj = J_FACTORIZE(jnp.asarray(bad), **jax_opts)
    ft = tdense.factorize(torch.from_numpy(bad), **opts)
    assert not bool(fj.ok) and not bool(ft.ok)
    np.testing.assert_array_equal(ft.L.numpy(), np.eye(40))


@pytest.mark.parametrize("b", [1, 8, 16, 33])
def test_factor_tile_matches_the_jax_engine_step(b):
    T = _spd(b, b)
    Lj = jnp.linalg.cholesky(jnp.asarray(T))
    Ij = jax.scipy.linalg.solve_triangular(Lj, jnp.eye(b), lower=True)
    Tt = torch.from_numpy(np.tril(T) + np.triu(np.full((b, b), 7.0), 1))
    inv = torch.empty_like(Tt)
    tchol.factor_tile_(Tt, inv)  # reads the lower triangle only
    assert _rel(Lj, Tt) <= 1e-10 and _rel(Ij, inv) <= 1e-10
    np.testing.assert_array_equal(np.triu(Tt.numpy(), 1), 0.0)
    np.testing.assert_array_equal(np.triu(inv.numpy(), 1), 0.0)


def test_factor_tile_non_pd_is_all_nan():
    bad = _spd(16, 1)
    bad[5, 5] = -1.0
    Lj = jnp.linalg.cholesky(jnp.asarray(bad))
    Tt = torch.from_numpy(bad)
    inv = torch.empty_like(Tt)
    tchol.factor_tile_(Tt, inv)
    # JAX: NaN on the lower triangle; the port: NaN everywhere.  Either
    # fails the engine's finiteness check.
    assert np.isnan(np.asarray(Lj)[np.tril_indices(16)]).all()
    assert bool(torch.isnan(Tt).all()) and bool(torch.isnan(inv).all())


def test_cuda_wrappers_refuse_cpu_tensors():
    N = torch.eye(4, dtype=torch.float32)
    before = dict(chol_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        chol_cuda.potrf(N)
    with pytest.raises(ValueError, match="CUDA"):
        chol_cuda.potrf_tile_(N, N.clone())
    assert chol_cuda.LAUNCHES == before
