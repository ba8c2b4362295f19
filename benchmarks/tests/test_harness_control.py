"""The control (the plain reference in TF32, put in the program's place)
comes out not correct under each cell's limits, where the program comes
out correct: on the CPU at tiny sizes. ``test_harness_chip.py`` holds the
same at the cells' own sizes on the card."""

import pytest

import tinybench  # noqa: F401
from harness.check import judge
from harness.readings import collect


@pytest.mark.parametrize("workload", ["terrain-rerender-classic",
                                      "tex4k-bake-classic"])
def test_the_control_fails_where_the_program_passes(tiny_manifest, workload):
    spec = tiny_manifest.checks(workload)
    for row in collect(tiny_manifest, workload, [2**33 + 5], "cpu"):
        assert judge(row["program"], spec)[0], row["program"]
        assert not judge(row["control"], spec)[0], row["control"]
