"""What the check and the metrics read of the program is there, or the
run fails: an epoch loop that no longer runs its epochs through
``self.epoch`` leaves the picked epoch unrecorded and the run raises,
rather than report a check or a metric that read nothing."""

from types import SimpleNamespace

import pytest

from tiny import run


def test_a_loop_that_hides_its_epochs_fails_the_run(monkeypatch):
    from factorized_tpu_torch import train
    from factorized_tpu_torch.parallel import multiseed

    from portbench.harness.observe import Unobserved

    def run_body(self, n):
        self.slot.zero_()
        for _ in range(n):
            self.body()
        return self.records[:n].cpu().numpy()

    for owner in (train.ChunkedLoop, multiseed.LaneLoop):
        monkeypatch.setattr(owner, "run", run_body)
    with pytest.raises(Unobserved):
        run("mfm_mosi.trials")


def test_missing_records_and_spans_raise():
    from portbench.harness.observe import Observer, Unobserved, check_observed

    obs = Observer()
    steps = SimpleNamespace(count=3, losses=[0.0] * 3, init=0, mu1=0, last=0)
    epoch = SimpleNamespace(end=0)
    with pytest.raises(Unobserved, match="first steps"):
        check_observed(obs, [{}], [None], [epoch], 1, False)
    with pytest.raises(Unobserved, match="picked epoch"):
        check_observed(obs, [{}], [steps], [], 1, False)
    with pytest.raises(Unobserved, match="trainer.setup span"):
        check_observed(obs, [{}], [steps], [epoch], 1, False)
