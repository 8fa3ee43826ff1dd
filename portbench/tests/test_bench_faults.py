"""A run drives a program broken underneath and ``correct`` comes out
false, for each fault the cells can have: a step that returns its state
unchanged, half of each batch left out (the mean over the rest), an
answer altered where the predict produces it. (Every cell runs on one
card: there is no exchange between chips to leave out.)"""

import pytest

from tiny import CELLS, run


def _unchanged(monkeypatch):
    from factorized_tpu_torch import train

    monkeypatch.setattr(train.FlatAdam, "step", lambda self: None)
    monkeypatch.setattr(train.LaneAdam, "step", lambda self: None)


def _half(monkeypatch):
    from factorized_tpu_torch import train
    from factorized_tpu_torch.parallel import multiseed

    def halve(original):
        def step(self, params, optimizer, x, y, *args, **kwargs):
            n = x.shape[1] // 2
            return original(self, params, optimizer, x[:, :n], y[:n],
                            *args, **kwargs)
        return step

    for owner in (train.TrainProgram, multiseed.LanePrograms):
        monkeypatch.setattr(owner, "step", halve(owner.step))


def _answer(monkeypatch):
    from factorized_tpu_torch import trainers
    from factorized_tpu_torch.parallel import multiseed

    def alter(original):
        def predict(*args, **kwargs):
            y = original(*args, **kwargs).copy()
            y[..., 0] += 1.0
            return y
        return predict

    monkeypatch.setattr(trainers, "_predict_y", alter(trainers._predict_y))
    monkeypatch.setattr(multiseed.LanePrograms, "predict",
                        alter(multiseed.LanePrograms.predict))


FAULTS = {"unchanged": _unchanged, "half": _half, "answer": _answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, _ = run(cell)
    assert result["correct"] is False, result["compared"]
