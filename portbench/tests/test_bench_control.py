"""The control, the reference in TF32 put in the program's place, is not
correct: at a small size on the CPU (TF32's rounding of a product's
operands, forward and backward), it reads above the cell's limits on at
least one number, on three seeds. On the card ``portbench/control.py``
reads it at the cells' own size."""

import pytest

from tiny import CELLS, ROOT, overrides


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_limit(cell):
    from portbench import control
    from portbench.harness import cell as harness

    limits = harness.load(ROOT, cell)[4]
    rows = control.readings(ROOT, cell, range(3, 6), require_cuda=False,
                            overrides=overrides(cell))
    for row in rows:
        assert any(row["control"][k] > limits[k] for k in limits
                   if k in row["control"]), row
        for k in limits:
            assert row["program"][k] <= limits[k], (k, row)
