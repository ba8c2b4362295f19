"""On the card, at each cell's own sizes: the program reads under every
limit of the cell and the control (the reference in TF32) over one at
least, on three seeds. The benchmark's runs do not run this."""

import pytest

from tinybench import need_card


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["terrain-rerender-classic",
                                      "tex4k-bake-classic"])
def test_the_control_fails_where_the_program_passes(workload):
    need_card()
    from harness.check import judge
    from harness.manifest import Manifest
    from harness.readings import collect

    man = Manifest()
    spec = man.checks(workload)
    for row in collect(man, workload, [2**31 + 101, 2**31 + 102, 2**31 + 103]):
        assert judge(row["program"], spec)[0], row["program"]
        assert not judge(row["control"], spec)[0], row["control"]
