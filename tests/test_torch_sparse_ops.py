"""The port's ELL and block-ELL products, held against the JAX package.

Both packages build their operands from the same numpy-seeded COO triplets
(f64): the arrays must be equal, the BELL byte gate must agree, the
double-word products are bit-equal where the operation order is the same
(dd_matvec), and the products that end in a working-precision sum
(matvec, rmatvec, dd_matvec_dd) agree within 1e-15 of Σ|a||x|; sdmult
(y <- alpha·op(A)·x + beta·y), scale_columns and to_dense (repeated slots
summed) within 1e-12 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cholesky_is_magic_tpu.ops import bell as jbell
from cholesky_is_magic_tpu.ops import dd as jdd
from cholesky_is_magic_tpu.ops import sparse_ops as jso
from cholesky_is_magic_tpu_torch.ops import bell as tbell
from cholesky_is_magic_tpu_torch.ops import dd as tdd
from cholesky_is_magic_tpu_torch.ops import sparse_ops as tso

torch.set_num_threads(1)

# The JAX products, each compiled once per shape (eager dispatch compiles
# every elementwise op of the dd trees on its own).
J_ELL = {f: jax.jit(getattr(jso, f)) for f in
         ("matvec", "rmatvec", "dd_matvec", "dd_matvec_dd")}
J_BELL = {f: jax.jit(getattr(jbell, f)) for f in
          ("matvec", "dd_matvec", "dd_matvec_dd")}


def _coo(seed, m, n, density):
    rng = np.random.default_rng(seed)
    mask = rng.random((m, n)) < density
    rows, cols = np.nonzero(mask)
    vals = rng.normal(size=rows.size) * 10.0 ** rng.uniform(-2, 2, rows.size)
    # A few duplicate triplets: both packages sum them.
    dup = rng.integers(0, rows.size, 5)
    return (np.concatenate([rows, rows[dup]]), np.concatenate([cols, cols[dup]]),
            np.concatenate([vals, rng.normal(size=5)]), rng)


def _f64(d):
    if isinstance(d, torch.Tensor):
        return d.numpy().astype(np.float64)
    return np.asarray(d, np.float64)


def _dd(d):
    return _f64(d.hi) + _f64(d.lo)


def _within(j, t, scale, rel=1e-15):
    assert np.all(np.abs(_f64(j) - _f64(t)) <= rel * scale + 1e-300)


SHAPES = [(37, 300, 0.05), (300, 37, 0.1), (130, 260, 0.02)]


@pytest.mark.parametrize("m,n,density", SHAPES)
def test_ell_from_coo_and_products(m, n, density):
    rows, cols, vals, rng = _coo(m + n, m, n, density)
    J = jso.from_coo(rows, cols, vals, (m, n), dtype=jnp.float64)
    T = tso.from_coo(rows, cols, vals, (m, n), dtype=torch.float64,
                     device="cpu")
    np.testing.assert_array_equal(np.asarray(J.indices), T.indices.numpy())
    np.testing.assert_array_equal(np.asarray(J.values), T.values.numpy())
    assert T.shape == J.shape
    A = np.abs(np.asarray(jso.to_dense(J)))
    x, y = rng.normal(size=n), rng.normal(size=m)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    _within(J_ELL["matvec"](J, jx), tso.matvec(T, tx), A @ np.abs(x))
    JT = jso.from_coo(cols, rows, vals, (n, m), dtype=jnp.float64)
    TT = tso.from_coo(cols, rows, vals, (n, m), dtype=torch.float64,
                      device="cpu")
    _within(J_ELL["rmatvec"](J, jy), tso.rmatvec(T, ty), A.T @ np.abs(y))
    _within(J_ELL["matvec"](JT, jy), tso.matvec(TT, ty), A.T @ np.abs(y))
    # Double-word: the same ops in the same order -> bit-equal.
    for a, b in zip(J_ELL["dd_matvec"](J, jx), tso.dd_matvec(T, tx)):
        np.testing.assert_array_equal(_f64(a), _f64(b))
    xd = (rng.normal(size=n), rng.normal(size=n) * 1e-17)
    jr = J_ELL["dd_matvec_dd"](J, jdd.DD(*map(jnp.asarray, xd)))
    tr = tso.dd_matvec_dd(T, tdd.DD(*map(torch.from_numpy, xd)))
    _within(_dd(jr), _dd(tr), A @ np.abs(xd[0]))


@pytest.mark.parametrize("m,n,density", SHAPES)
def test_bell_from_coo_and_products(m, n, density):
    rows, cols, vals, rng = _coo(m * n, m, n, density)
    J = jbell.from_coo(rows, cols, vals, (m, n), dtype=jnp.float64,
                       max_dense_frac=8.0)
    T = tbell.from_coo(rows, cols, vals, (m, n), dtype=torch.float64,
                       max_dense_frac=8.0, device="cpu")
    np.testing.assert_array_equal(np.asarray(J.blocks), T.blocks.numpy())
    np.testing.assert_array_equal(np.asarray(J.bcols), T.bcols.numpy())
    assert (T.shape, T.kb) == (J.shape, J.kb)
    dense = np.zeros((m, n))
    np.add.at(dense, (rows, cols), vals)
    A = np.abs(dense)
    x = rng.normal(size=n)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    _within(J_BELL["matvec"](J, jx), tbell.matvec(T, tx), A @ np.abs(x))
    for a, b in zip(J_BELL["dd_matvec"](J, jx), tbell.dd_matvec(T, tx)):
        np.testing.assert_array_equal(_f64(a), _f64(b))
    xd = (rng.normal(size=n), rng.normal(size=n) * 1e-17)
    jr = J_BELL["dd_matvec_dd"](J, jdd.DD(*map(jnp.asarray, xd)))
    tr = tbell.dd_matvec_dd(T, tdd.DD(*map(torch.from_numpy, xd)))
    _within(_dd(jr), _dd(tr), A @ np.abs(xd[0]))


@pytest.mark.parametrize("kw", [dict(), dict(max_dense_frac=8.0),
                                dict(max_bytes=1024, max_dense_frac=8.0)])
def test_bell_byte_gates_agree(kw):
    """The None return (stay on ELL) agrees for every gate setting."""
    for m, n, density in SHAPES + [(8, 128, 0.5)]:
        rows, cols, vals, _ = _coo(7, m, n, density)
        for dt_j, dt_t in ((jnp.float32, torch.float32),
                           (jnp.float64, torch.float64)):
            J = jbell.from_coo(rows, cols, vals, (m, n), dtype=dt_j, **kw)
            T = tbell.from_coo(rows, cols, vals, (m, n), dtype=dt_t,
                               device="cpu", **kw)
            assert (J is None) == (T is None)
    assert tbell.from_coo(np.zeros(0, int), np.zeros(0, int), np.zeros(0),
                          (4, 4), device="cpu") is None


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("m,n,density", SHAPES)
def test_sdmult_full_signature(m, n, density, transpose):
    """y <- alpha·op(A)·x + beta·y (sparse-m*, tests/test_sparse_ops.py:40)."""
    rows, cols, vals, rng = _coo(m + 2 * n, m, n, density)
    J = jso.from_coo(rows, cols, vals, (m, n), dtype=jnp.float64)
    T = tso.from_coo(rows, cols, vals, (m, n), dtype=torch.float64, device="cpu")
    k_in, k_out = (m, n) if transpose else (n, m)
    x, y = rng.normal(size=k_in), rng.normal(size=k_out)
    for alpha, beta, with_y in ((-1.0, 2.0, True), (0.5, 0.0, True), (1.0, 0.0, False)):
        yj = jnp.asarray(y) if with_y else None
        yt = torch.from_numpy(y) if with_y else None
        jo = jso.sdmult(J, jnp.asarray(x), yj, alpha=alpha, beta=beta,
                        transpose=transpose)
        to = tso.sdmult(T, torch.from_numpy(x), yt, alpha=alpha, beta=beta,
                        transpose=transpose)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-12,
                                   atol=1e-12 * float(np.abs(np.asarray(jo)).max()))


@pytest.mark.parametrize("m,n,density", SHAPES)
def test_scale_columns_and_to_dense(m, n, density):
    """A·diag(d) in ELL and the dense matrix back, the duplicate triplets
    and the padded slots of each row summed (tests/test_sparse_ops.py:55)."""
    rows, cols, vals, rng = _coo(3 * m + n, m, n, density)
    J = jso.from_coo(rows, cols, vals, (m, n), dtype=jnp.float64)
    T = tso.from_coo(rows, cols, vals, (m, n), dtype=torch.float64, device="cpu")
    dense = np.zeros((m, n))
    np.add.at(dense, (rows, cols), vals)
    np.testing.assert_allclose(tso.to_dense(T).numpy(), np.asarray(jso.to_dense(J)),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(tso.to_dense(T).numpy(), dense, rtol=1e-12, atol=0)
    d = rng.random(n) + 0.5
    JS = jso.scale_columns(J, jnp.asarray(d))
    TS = tso.scale_columns(T, torch.from_numpy(d))
    np.testing.assert_array_equal(TS.indices.numpy(), np.asarray(JS.indices))
    np.testing.assert_allclose(TS.values.numpy(), np.asarray(JS.values), rtol=1e-12)
    np.testing.assert_allclose(tso.to_dense(TS).numpy(), np.asarray(jso.to_dense(JS)),
                               rtol=1e-12, atol=0)


def test_coo_duplicates_summed():
    rows, cols, vals = np.array([0, 0, 1]), np.array([1, 1, 0]), np.array([2.0, 3.0, 1.0])
    T = tso.from_coo(rows, cols, vals, (2, 2), dtype=torch.float64, device="cpu")
    J = jso.from_coo(rows, cols, vals, (2, 2), dtype=jnp.float64)
    np.testing.assert_array_equal(tso.to_dense(T).numpy(), [[0.0, 5.0], [1.0, 0.0]])
    np.testing.assert_array_equal(tso.to_dense(T).numpy(), np.asarray(jso.to_dense(J)))
