"""Each cell's control comes out not correct, at a size a test run holds
(the cells' own limits, tiny LPs on the CPU); the readings on the card at
the cells' own sizes are in PERF.md and ``limits/<workload>.json``.

- ``pilot.batch128`` (float32 operands, a double-word finisher): the
  program with its own lower-precision path switched on, the finisher run
  as the float32 ``pdas`` with the same settings;
- ``pds-10.fleet64`` (float32 with TF32 off, no lower path of the
  program's own): the reference in the program's place, each lane's exact
  optimum rounded to TF32."""

import json

from lpbench.drive import Driver
from lpbench.readings import control_config, round_to_tf32, rounded_optimum
from lpbench.reference import check
from lpbench.tests import tiny


def test_round_to_tf32():
    import numpy as np

    v = np.array([1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-11, 1.0 + 2.0**-20, -3.0])
    np.testing.assert_array_equal(round_to_tf32(v), [1.0, 1.0 + 2.0**-9, 1.0, -3.0])


def test_pilot_control_the_f32_finisher_is_not_correct(tmp_path):
    root = tiny.make_tiny_root(tmp_path)
    path = root / "configs" / "pilot.json"
    path.write_text(json.dumps(control_config(json.loads(path.read_text()), "f32")))
    line = tiny.run(root, "pilot.batch128", 0)["line"]
    assert line["correct"] is False, line["checks"]


def test_pds10_control_the_rounded_optimum_is_not_correct(tmp_path):
    root = tiny.make_tiny_root(tmp_path)
    cfg = json.loads((root / "configs" / "pds-10.json").read_text())
    traffic = json.loads((root / "traffic" / "fleet64.json").read_text())
    limits = json.loads((root / "limits" / "pds-10.fleet64.json").read_text())["limits"]
    drv = Driver(cfg, traffic, tiny.SEED, "cpu", root)
    ops = check.program_operands(drv.fleet, drv.path, cfg["dtype"])
    nums = check.worst(drv.fleet, drv.path, [rounded_optimum(drv.fleet, ops)])
    assert not check.verdict(nums, limits), (nums, limits)
