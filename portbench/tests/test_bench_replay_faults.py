"""On the card, a fault planted in the captured epoch alone, so that only
the graph's replays carry it and the eager first epoch is sound, makes
``correct`` false, while the first steps' numbers stay within their
limits: the check follows a replayed epoch. The faults: each step leaves
the optimizer's state unchanged; each step takes half its batch (the
mean over the rest). ``python -m pytest portbench/tests -m gpu`` on a
machine with a CUDA card; skipped without one."""

import time

import pytest

from tiny import CELLS, ROOT

FIRST_STEPS = ("step1_loss", "grad1_leaf", "change3_median")


def _capturing():
    import torch

    return torch.cuda.is_current_stream_capturing()


def _unchanged(monkeypatch):
    from factorized_tpu_torch import train

    for owner in (train.FlatAdam, train.LaneAdam):
        original = owner.step

        def step(self, original=original):
            if not _capturing():
                original(self)

        monkeypatch.setattr(owner, "step", step)


def _half(monkeypatch):
    from factorized_tpu_torch import train
    from factorized_tpu_torch.parallel import multiseed

    for owner in (train.TrainProgram, multiseed.LanePrograms):
        original = owner.step

        def step(self, params, optimizer, x, y, *args, original=original,
                 **kwargs):
            if _capturing():
                n = x.shape[1] // 2
                x, y = x[:, :n], y[:n]
            return original(self, params, optimizer, x, y, *args, **kwargs)

        monkeypatch.setattr(owner, "step", step)


FAULTS = {"unchanged": _unchanged, "half": _half}


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_in_the_replays_is_not_correct(cell, fault, monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.harness import cell as harness

    FAULTS[fault](monkeypatch)
    result, _ = harness.run(ROOT, cell, 2**31 + 23, 0.0, False,
                            time.perf_counter())
    compared = result["compared"]
    print(cell, fault, {k: v["value"] for k, v in compared.items()})
    assert result["correct"] is False, compared
    for k in FIRST_STEPS:
        assert compared[k]["value"] <= compared[k]["limit"], compared
