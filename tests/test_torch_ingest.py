"""The PyTorch port's host ingest, operands and package boundary, held
against the JAX package.

The MPS reader and standard form are NumPy copies: every array must be
equal on every fixture.  ``to_device_lp`` must give bit-equal operands at
the pad multiples and dtypes the solvers use.  The port must import with
jax unavailable."""

import dataclasses
import glob
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cholesky_is_magic_tpu as cim
import cholesky_is_magic_tpu_torch as cimt
from cholesky_is_magic_tpu.ingest import to_device_lp
from cholesky_is_magic_tpu.ingest.standard_form import (
    extract_solution,
    scale_constraints,
)
from cholesky_is_magic_tpu.solvers.result import Status
from cholesky_is_magic_tpu.utils.testing import constructed_optimum_lp
from cholesky_is_magic_tpu_torch import convert
from cholesky_is_magic_tpu_torch.ingest import device as t_device
from cholesky_is_magic_tpu_torch.ingest import standard_form as t_sf
from cholesky_is_magic_tpu_torch.solvers.result import Status as TStatus
from cholesky_is_magic_tpu_torch.utils import precision as t_precision
from cholesky_is_magic_tpu_torch.utils import testing as t_testing

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = sorted(glob.glob(os.path.join(ROOT, "tests", "fixtures", "*.mps")))
PORT = os.path.join(ROOT, "cholesky_is_magic_tpu_torch")
LP_FIELDS = ("A", "c", "b", "l", "u", "row_mask", "col_mask", "row_type")


def _plain(obj):
    """Dataclasses -> dicts of plain values, arrays as lists (exact ==)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, np.ndarray):
        return (str(obj.dtype), obj.tolist())
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_mps_and_standard_form_equal(path):
    mj, mt = cim.read_mps_file(path), cimt.read_mps_file(path)
    assert _plain(mj) == _plain(mt)
    assert _plain(cim.to_standard_form(mj)) == _plain(cimt.to_standard_form(mt))


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_rescale_scale_and_extract_equal(path):
    sj = cim.to_standard_form(cim.read_mps_file(path))
    st = cimt.to_standard_form(cimt.read_mps_file(path))
    vj, bj = scale_constraints(sj.a_rows, sj.a_vals, sj.b)
    vt, bt = t_sf.scale_constraints(st.a_rows, st.a_vals, st.b)
    np.testing.assert_array_equal(vj, vt)
    np.testing.assert_array_equal(bj, bt)
    x = np.random.default_rng(0).normal(size=sj.nvars + 5)
    assert _plain(extract_solution(sj, x)) == _plain(t_sf.extract_solution(st, x))
    assert _plain(cim.rescale_sf(sj)) == _plain(cimt.rescale_sf(st))


@pytest.mark.parametrize("pad", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("path", FIXTURES[:3], ids=os.path.basename)
def test_to_device_lp_equal(path, dtype, pad):
    sj = cim.to_standard_form(cim.read_mps_file(path))
    st = cimt.to_standard_form(cimt.read_mps_file(path))
    lj = to_device_lp(sj, pad_multiple=pad, dtype=getattr(jnp, dtype))
    lt = t_device.to_device_lp(st, pad_multiple=pad,
                               dtype=getattr(torch, dtype), device="cpu")
    assert (lj.m, lj.n, lj.shape) == (lt.m, lt.n, tuple(lt.shape))
    for f in LP_FIELDS:
        a, b = np.asarray(getattr(lj, f)), getattr(lt, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_to_device_lp_explicit_shape():
    st = cimt.to_standard_form(cimt.read_mps_file(FIXTURES[0]))
    lt = t_device.to_device_lp(st, shape=(st.ncons + 3, st.nvars + 2),
                               device="cpu")
    assert tuple(lt.A.shape) == (st.ncons + 3, st.nvars + 2)
    assert not bool(lt.row_mask[-1]) and not bool(lt.col_mask[-1])
    with pytest.raises(ValueError):
        t_device.to_device_lp(st, shape=(1, 1), device="cpu")
    assert t_device.round_up(27, 16) == 32 and t_device.round_up(32, 16) == 32


@pytest.mark.parametrize("kw", [dict(m=64, seed=3), dict(name="afiro", seed=1)])
def test_constructed_optimum_lp_equal(kw):
    sj, ij = constructed_optimum_lp(**kw)
    st, it = t_testing.constructed_optimum_lp(**kw)
    assert _plain(sj) == _plain(st)
    assert _plain(ij) == _plain(it)
    assert t_testing.NETLIB_SCALES["pilot"] == (1441, 3652)


def test_convert_carries_a_device_lp_both_ways():
    sj = cim.to_standard_form(cim.read_mps_file(FIXTURES[0]))
    lj = to_device_lp(sj, pad_multiple=16, dtype=jnp.float64)
    lt = convert.device_lp_from_numpy(lj, dtype=torch.float32,
                                      device="cpu")
    assert lt.A.dtype == torch.float32 and lt.row_mask.dtype == torch.bool
    lt64 = convert.device_lp_from_numpy(lj, device="cpu")
    back = convert.to_numpy(lt64)
    for f in LP_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(lj, f)), back[f])
    assert (back["m"], back["n"]) == (lj.m, lj.n)


def test_status_codes_equal():
    for name in ("RUNNING", "OPTIMAL", "SINGULAR", "UNBOUNDED", "MAX_ITERS",
                 "PRECISION_FLOOR"):
        assert getattr(Status, name) == getattr(TStatus, name)
    assert Status.NAMES == TStatus.NAMES


def test_precision_guard_turns_tf32_off_and_asserts_it():
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32"):
            t_precision.assert_highest_precision()
        seen = t_precision.highest_precision(
            lambda: (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision())
        )()
        assert seen == (False, False, "highest")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_port_imports_without_jax():
    """Every module of the port imports with jax unavailable (the machine
    with the card has no jax)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import cholesky_is_magic_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(k.startswith('cholesky_is_magic_tpu.') for k in sys.modules)\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import jax|from jax|import cholesky_is_magic_tpu\b"
                         r"|from cholesky_is_magic_tpu\b)", re.M)
    files = glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True)
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path
