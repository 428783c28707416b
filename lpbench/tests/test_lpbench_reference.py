"""The plain checker: it accepts each lane's exact optimum, rejects a
perturbed iterate, works out the program's operands as the program holds
them, and imports nothing of the program."""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from lpbench.gen import fleet
from lpbench.reference import check

LPBENCH = pathlib.Path(__file__).resolve().parents[1]
SEED = 2**31 + 23
EXACT = ("obj_err", "x_err", "y_err", "zw_err")


def _exact(f, ops):
    return [{"x": f.x[k], "x_lo": None, "y": f.y[k] / ops.scale, "z": f.z[k],
             "w": f.w[k], "objective": float(ops.c[k] @ f.x[k])} for k in range(f.lanes)]


@pytest.mark.parametrize("path", ["dense", "sparse"])
def test_accepts_the_exact_optimum(path):
    f = fleet(80, 160, 0, SEED, lanes=4)
    # In float64 the operands are the generator's own: every number is rounding.
    ops = check.program_operands(f, path, "float64")
    nums = check.worst(f, path, [_exact(f, ops)], "float64")
    assert max(nums.values()) <= 1e-13, nums
    # In float32 the LP the program solves is the rounded one: the exact
    # optimum of the generator's LP misses its rows by about the rounding.
    ops = check.program_operands(f, path, "float32")
    nums = check.worst(f, path, [_exact(f, ops)], "float32")
    assert all(nums[k] <= 1e-15 for k in EXACT), nums
    assert 1e-10 < nums["primal_res"] <= 1e-6, nums


@pytest.mark.parametrize("what", ["x", "y", "z", "w", "objective", "x_lo"])
def test_rejects_a_perturbed_iterate(what):
    f = fleet(80, 160, 0, SEED, lanes=4)
    ops = check.program_operands(f, "sparse", "float64")
    good = _exact(f, ops)
    bad = [dict(g) for g in good]
    k = 2
    if what == "objective":
        bad[k]["objective"] += 1e-3 * (1 + abs(bad[k]["objective"]))
    elif what == "x_lo":
        bad[k]["x_lo"] = np.full(f.n, 1e-6)
    else:
        v = np.array(bad[k][what], np.float64)
        v[7] += 1e-3 * (1 + np.abs(v).max())
        bad[k][what] = v
    before = check.worst(f, "sparse", [good], "float64")
    after = check.worst(f, "sparse", [bad], "float64")
    moved = [key for key in check.NUMBERS if after[key] > 1e3 * max(before[key], 1e-15)]
    assert moved, (before, after)
    limits = {key: 1e-10 for key in check.NUMBERS}
    assert check.verdict(before, limits) and not check.verdict(after, limits)


@pytest.mark.parametrize("cell", ["pilot.batch128", "pds-10.fleet64"])
def test_the_cells_limits_reject_a_perturbed_iterate(cell):
    limits = json.loads((LPBENCH / "limits" / f"{cell}.json").read_text())["limits"]
    f = fleet(80, 160, 0, SEED, lanes=3)
    ops = check.program_operands(f, "dense", "float32")
    bad = _exact(f, ops)
    bad[1]["x"] = bad[1]["x"] * (1 + 1e-2)
    assert not check.verdict(check.worst(f, "dense", [bad]), limits)


def test_a_nan_reads_inf():
    f = fleet(40, 80, 0, SEED, lanes=2)
    ops = check.program_operands(f, "dense")
    got = _exact(f, ops)
    got[0]["x"] = np.full(f.n, np.nan)
    nums = check.worst(f, "dense", [got])
    assert nums["primal_res"] == float("inf")
    assert not check.verdict(nums, {"primal_res": 1.0})


def test_operands_are_the_programs():
    """The reference's float32 operands equal what the port's set-up holds
    (compared here only; the reference itself never imports the port)."""
    import torch

    from cholesky_is_magic_tpu_torch.ingest.device import to_device_lp
    from cholesky_is_magic_tpu_torch.ingest.standard_form import StandardForm
    from cholesky_is_magic_tpu_torch.solvers.pdas import make_pdas, make_pdas_sparse

    f = fleet(64, 128, 0, SEED, lanes=2)
    for k in range(2):
        sf = StandardForm(nvars=f.n, ncons=f.m, c=f.c[k], a_rows=f.rows.astype(np.int32),
                          a_cols=f.cols.astype(np.int32), a_vals=f.vals, b=f.b[k],
                          row_type=np.zeros(f.m, np.int8), l=f.l, u=f.u,
                          initial_vars=f.n_struct)
        st = make_pdas(to_device_lp(sf, pad_multiple=16, device="cpu"))
        ops = check.program_operands(f, "dense", "float32")
        A = st.lp.A.numpy()
        np.testing.assert_array_equal(A[f.rows, f.cols].astype(np.float64), ops.vals_s)
        np.testing.assert_array_equal(st.lp.b.numpy()[:f.m].astype(np.float64), ops.b_s[k])
        st, _ = make_pdas_sparse(sf, block=16, device="cpu", dtype=torch.float32)
        ops = check.program_operands(f, "sparse", "float32")
        np.testing.assert_array_equal(st.lp.b.numpy().astype(np.float64), ops.b_s[k])
        np.testing.assert_array_equal(st.lp.c.numpy().astype(np.float64), ops.c[k])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("sub", ["reference", "gen"])
def test_imports_nothing_of_the_program(sub):
    names = {n.split(".")[0] for p in (LPBENCH / sub).glob("*.py") for n in _imports(p)}
    assert names <= {"__future__", "dataclasses", "numpy", "lpbench"}, names
    code = (f"import sys; sys.path.insert(0, {str(LPBENCH.parent)!r}); "
            f"import lpbench.{sub}; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    loaded = set(ast.literal_eval(out.strip()))
    assert not loaded & {"torch", "jax", "cholesky_is_magic_tpu",
                         "cholesky_is_magic_tpu_torch"}, loaded
