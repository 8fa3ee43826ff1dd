"""``--profile DIR`` (``factorized_tpu_torch/utils/profiling.py``): the
command traced by torch.profiler into a Chrome trace that names the
products it ran and the port's spans; the span recorder: nesting, the
trial's id, its bound, no profiler range without a profiler, and the
tree of spans a trainer's call records."""

import json

import numpy as np
import pytest
import torch

from factorized_tpu_torch import cli, trainers
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.utils import profiling
from factorized_tpu_torch.utils.logging import RunLogger
from factorized_tpu_torch.utils.profiling import Recorder, trace

TINY = {"seqlength": 5, "h_dims": [4, 4, 4], "memsize": 4, "zy_size": 4,
        "zl_size": 4, "za_size": 4, "zv_size": 4, "fy_size": 4,
        "fl_size": 4, "fa_size": 4, "fv_size": 4, "att1_shape": 4,
        "att2_shape": 4, "gamma1_shape": 4, "gamma2_shape": 4,
        "batchsize": 8, "num_epochs": 1}


def _traces(directory):
    return sorted(directory.glob("*.pt.trace.json"))


def _data():
    rng = np.random.default_rng(0)
    data = []
    for n in (16, 8, 8):
        data += [rng.normal(size=(n, 5, 325)).astype(np.float32),
                 rng.normal(size=(n,)).astype(np.float32)]
    return data


def test_profile_writes_a_trace_of_the_command(tmp_path, monkeypatch):
    data = _data()
    monkeypatch.setattr(cli, "load_dataset", lambda *a: tuple(data))
    config = tmp_path / "tiny.json"
    config.write_text(json.dumps(TINY))
    prof = tmp_path / "prof"
    assert cli.main(["mosi", "--config", str(config), "--device", "cpu",
                     "--out", str(tmp_path / "runs"), "--profile",
                     str(prof)]) == 0
    (path,) = _traces(prof)
    names = {e.get("name") for e in json.loads(path.read_text())
             ["traceEvents"]}
    assert {"aten::mm", "aten::addmm"} & names
    assert {"ftt.trial", "ftt.loop.run", "ftt.step.forward"} <= names
    assert list((tmp_path / "runs").glob("*.jsonl"))


def test_trace_and_timers_on_the_host(tmp_path):
    a = torch.ones(64, 64)
    with trace(str(tmp_path)):
        with profiling.span("probe", rows=64) as s:
            a @ a
    assert s.seconds > 0
    (path,) = _traces(tmp_path)
    events = json.loads(path.read_text())["traceEvents"]
    (mark,) = [e for e in events if e.get("name") == "ftt.probe"]
    # a host range, not a user annotation the profiler would also copy
    # onto the device's timeline
    assert mark["dur"] > 0 and mark["cat"] == "cpu_op"
    (record,) = [r for r in profiling.spans() if r.index == s.index]
    assert record.name == "probe" and record.attrs == {"rows": 64}
    assert record.end_ns - record.start_ns == s.end_ns - s.start_ns


def test_spans_nest_and_share_their_trial():
    rec = Recorder()
    with rec.span("outside") as outside:
        pass
    with rec.span("trial", lanes=2) as t:
        with rec.span("a") as a:
            with rec.span("b") as b:
                b.attrs["nodes"] = 7
        with rec.span("c") as c:
            pass
    by = {r.name: r for r in rec.spans()}
    assert [r.name for r in rec.spans()] == ["outside", "b", "a", "c",
                                             "trial"]
    assert by["outside"].parent is None and by["outside"].trial is None
    assert by["trial"].parent is None and by["trial"].trial == t.index
    assert by["a"].parent == t.index and by["c"].parent == t.index
    assert by["b"].parent == a.index
    assert {by[n].trial for n in "abc"} == {t.index}
    assert by["b"].attrs == {"nodes": 7} and by["trial"].attrs == {
        "lanes": 2}
    assert by["trial"].start_ns <= by["a"].start_ns <= by["b"].start_ns
    assert by["b"].end_ns <= by["a"].end_ns <= c.start_ns
    assert outside.index < t.index < a.index < b.index < c.index


def test_the_recorder_keeps_the_last_spans_and_counts_the_dropped():
    rec = Recorder()
    assert rec.records.maxlen == profiling.MAX_SPANS == 65536
    for i in range(profiling.MAX_SPANS + 10):
        with rec.span("s", i=i):
            pass
    kept = rec.spans()
    assert len(kept) == profiling.MAX_SPANS and rec.dropped == 10
    assert kept[0].attrs == {"i": 10} and kept[-1].attrs == {
        "i": profiling.MAX_SPANS + 9}
    rec.clear()
    assert rec.spans() == [] and rec.dropped == 0


def test_no_profiler_range_without_a_profiler(monkeypatch):
    opened = []
    real = torch._C._profiler._RecordFunctionFast

    def counting(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counting)
    rec = Recorder()
    with rec.span("quiet"):
        pass
    assert opened == []
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with rec.span("loud"):
            pass
    assert opened == ["ftt.loud"]
    assert [r.name for r in rec.spans()] == ["quiet", "loud"]


@pytest.mark.parametrize("trainer", ["train_mfm", "train_mfm_ablation"])
def test_a_trainer_records_its_tree_of_spans(trainer):
    cfg = MFMConfig(**TINY).replace(
        num_epochs=2, model_type="m_b" if trainer != "train_mfm" else "mfm")
    profiling.clear()
    getattr(trainers, trainer)(*_data(), cfg, device="cpu",
                               logger=RunLogger(echo=False))
    recs = profiling.spans()
    by = {r.index: r for r in recs}
    (top,) = [r for r in recs if r.name == "trial"]
    assert top.parent is None and top.attrs == {
        "trainer": trainer, "model_type": cfg.model_type, "lanes": 1}
    assert {r.trial for r in recs} == {top.index}

    def names(parent):
        return [r.name for r in sorted(recs, key=lambda r: r.index)
                if r.parent == parent.index]

    assert names(top) == ["trainer.setup", "loop.run", "trainer.score"]
    (setup,) = [r for r in recs if r.name == "trainer.setup"]
    assert names(setup) == ["setup.data", "setup.init"]
    (run,) = [r for r in recs if r.name == "loop.run"]
    assert run.attrs == {"epochs": 2}
    # on the CPU every epoch runs its steps eagerly, inside ``run``
    assert names(run) == (["step.forward", "step.backward",
                           "step.optimizer"] * 2 + ["epoch.eval"]) * 2 + [
        "loop.read"]
    (score,) = [r for r in recs if r.name == "trainer.score"]
    assert names(score) == ["score.pack", "score.forward", "score.read"]
    for r in recs:
        if r.parent is not None:
            p = by[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns


def test_lanes_record_their_tree_of_spans():
    from factorized_tpu_torch.parallel.multiseed import train_mfm_multiseed

    cfg = MFMConfig(**TINY).replace(num_epochs=2)
    profiling.clear()
    train_mfm_multiseed(*_data(), cfg, n_seeds=2, device="cpu",
                        logger=RunLogger(echo=False))
    recs = sorted(profiling.spans(), key=lambda r: r.index)
    (top,) = [r for r in recs if r.name == "trial"]
    assert top.attrs == {"trainer": "train_mfm_multiseed",
                         "model_type": "mfm", "lanes": 2}
    assert {r.trial for r in recs} == {top.index}
    assert [r.name for r in recs if r.parent == top.index] == [
        "lanes.data", "lanes.init", "loop.run", "trainer.score"]
    (score,) = [r for r in recs if r.name == "trainer.score"]
    assert [r.name for r in recs if r.parent == score.index] == [
        "score.forward", "score.read"]
    (run,) = [r for r in recs if r.name == "loop.run"]
    assert [r.name for r in recs if r.parent == run.index] == (
        ["step.forward", "step.backward", "step.optimizer"] * 2
        + ["epoch.eval"]) * 2 + ["loop.read"]
