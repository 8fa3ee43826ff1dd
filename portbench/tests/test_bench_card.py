"""On the card: one short run of each cell is correct and reports its
end-to-end metrics (``python -m pytest portbench/tests -m gpu`` on a
machine with a CUDA card; skipped without one)."""

import time

import pytest

from tiny import CELLS, ROOT


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.harness import cell as harness

    result, _ = harness.run(ROOT, cell, 2**31 + 17, 1.0, False,
                            time.perf_counter())
    assert result["correct"], result["compared"]
    assert result["device"]["platform"] == "gpu"
    assert result["metrics"]["train_samples_per_s"]["value"] > 0
