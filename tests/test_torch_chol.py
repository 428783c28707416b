"""The port's blocked Cholesky (ops/chol.py) and the dense factorize
options, held against the JAX package in f64.

On the CPU the JAX ``pallas_chol.cholesky`` runs its plain
``blocked_cholesky`` (it takes the Pallas kernel only on a TPU), and the
port's ``cholesky`` runs its own ``blocked_cholesky``: the factors agree
within 1e-12 relative.  So the port's ``factorize(use_pallas=True)`` is held
against both JAX ``use_pallas=True`` and ``blocked=True``.  A non-PD input
gives NaN and ``ok`` False in both.
The tile factor of the sparse engine (``factor_tile_``) is held against
the JAX engine's ``cholesky`` + ``solve_triangular``; so is the 2 × 2 split
that the card runs around its tile kernel for tiles wider than 128
(``_factor_tile_split_``), here with the plain tile factor as its leaf."""

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
    (dict(blocked=True), dict(blocked=True)),
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


def _split_plain(T):
    """The card's split route for wide tiles, in place, with the plain tile
    factor (``factor_tile_`` on a CPU tensor) as its leaf; returns L⁻¹."""
    inv = torch.empty_like(T)
    tchol._factor_tile_split_(T, inv, tchol.factor_tile_)
    return inv


@pytest.mark.parametrize("b", [1, 8, 16, 33, 129, 160, 256])
def test_factor_tile_matches_the_jax_engine_step(b):
    """The plain tile factor (b <= 33) and the split route (b > 128) against
    JAX's whole-tile cholesky + solve_triangular: L and L⁻¹ within 1e-10
    (plain) and 1e-12 (split) relative, in f64."""
    T = _spd(b, b)
    Lj = jnp.linalg.cholesky(jnp.asarray(T))
    Ij = jax.scipy.linalg.solve_triangular(Lj, jnp.eye(b), lower=True)
    Tt = torch.from_numpy(np.tril(T) + np.triu(np.full((b, b), 7.0), 1))
    split = b > chol_cuda.BLOCK
    if split:
        inv = _split_plain(Tt)  # reads the lower triangle only
    else:
        inv = torch.empty_like(Tt)
        tchol.factor_tile_(Tt, inv)  # reads the lower triangle only
    tol = 1e-12 if split else 1e-10
    assert _rel(Lj, Tt) <= tol and _rel(Ij, inv) <= tol
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


@pytest.mark.parametrize("b,pivot", [(256, 40), (256, 200), (160, 150)])
def test_factor_tile_split_non_pd_is_all_nan(b, pivot):
    """A non-positive pivot in the leading (pivot < 128) or the trailing
    half of a split tile: the whole L and L⁻¹ NaN, ok False, as JAX's
    whole-tile cholesky fails."""
    bad = _spd(b, 2)
    bad[pivot, pivot] = -1.0
    Lj = jnp.linalg.cholesky(jnp.asarray(bad))
    assert np.isnan(np.asarray(Lj)[np.tril_indices(b)]).all()
    Tt = torch.from_numpy(bad)
    inv = _split_plain(Tt)
    assert bool(torch.isnan(Tt).all()) and bool(torch.isnan(inv).all())
    assert not bool(torch.isfinite(Tt).all())  # the engine's ok is False


def test_cuda_wrappers_refuse_cpu_tensors():
    N = torch.eye(4, dtype=torch.float32)
    before = dict(chol_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        chol_cuda.potrf(N)
    with pytest.raises(ValueError, match="CUDA"):
        chol_cuda.potrf_tile_(N, N.clone())
    assert chol_cuda.LAUNCHES == before
