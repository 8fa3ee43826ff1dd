"""A small size for the benchmark's CPU tests: every width of the cells'
configurations cut down, a few segments of MOSI's shape, few epochs."""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CONFIG = {"input_dims": [6, 3, 4], "h_dims": [5, 4, 3], "zy_size": 4,
          "zl_size": 4, "za_size": 3, "zv_size": 5, "fy_size": 3,
          "fl_size": 4, "fa_size": 3, "fv_size": 3, "memsize": 4,
          "att1_shape": 6, "att2_shape": 5, "gamma1_shape": 6,
          "gamma2_shape": 5, "seqlength": 5, "batchsize": 8,
          "num_epochs": 3, "split": {"n_train": 40, "n_valid": 12,
                                     "n_test": 14, "max_words": 8}}
TRAFFIC = {"warmup_epochs": 2}
CELLS = ("mfm_mosi.trials", "mfm_mosi.seeds32", "m_b_mosi.seeds32",
         "m_b_mosi.trials")


def overrides(cell):
    """The small size for ``cell``: its lanes cut to 3."""
    traffic = dict(TRAFFIC)
    if cell.endswith("seeds32"):
        traffic["lanes"] = 3
    return {"config": CONFIG, "traffic": traffic}


def run(cell, seed=2**31 + 11, trace=False, root=ROOT):
    """One run of ``cell`` on the CPU at the small size: (result,
    lines)."""
    from portbench.harness import cell as harness

    return harness.run(root, cell, seed, 0.2, trace, time.perf_counter(),
                       require_cuda=False, overrides=overrides(cell))
