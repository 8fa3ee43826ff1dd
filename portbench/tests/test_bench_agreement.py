"""On the CPU, at a small size, whole trials through the port's plain
path agree with the reference: every run of every cell is correct, its
numbers under the cell's own limits."""

import pytest

from tiny import CELLS, run


@pytest.mark.parametrize("cell", CELLS)
def test_trials_agree_with_the_reference(cell):
    result, _ = run(cell)
    assert result["correct"], result["compared"]
    assert result["failed"] == 0
    assert result["attempted"] >= (3 if cell.endswith("seeds32") else 1)
    assert result["compared"]["schedule"]["value"] == 0
