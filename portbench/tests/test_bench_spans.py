"""The readers of the program's spans (``harness/spans.py``,
``metrics/capture_s.py``, ``eager_epoch_s.py``,
``graph_nodes_per_step.py``, ``first_score_s.py``) on a synthetic
window: only the spans inside the window's trials count, the first score
is the warm-up's, and a program that records no spans gives no
number."""

from types import SimpleNamespace

import pytest

from tiny import ROOT, run

from portbench.harness.cell import reader
from factorized_tpu_torch.utils import profiling
from factorized_tpu_torch.utils.profiling import Span

S = 1_000_000_000  # ns a second


def _span(name, a, b, **attrs):
    return Span(name, int(a * S), int(b * S), None, None, attrs, 0)


# the window's two trials (the benchmark's spans, seconds): 100-105 and
# 105-111; a warm-up trial before it (90-98) and a traced trial after
WINDOW = [("trial", 100.0, 105.0, {"index": 0}),
          ("loop.run", 101.0, 102.0, {"epochs": 10, "first": True}),
          ("trial", 105.0, 111.0, {"index": 1})]
PROGRAM = [
    _span("graph.eager", 91.0, 92.0),
    _span("graph.capture", 92.0, 95.0, nodes=999, pool_bytes=1),
    _span("trainer.score", 96.0, 97.5),
    _span("graph.eager", 100.5, 101.0),
    _span("graph.capture", 101.0, 102.5, nodes=37_000, pool_bytes=1),
    _span("trainer.score", 104.0, 104.1),
    _span("graph.eager", 106.0, 106.75),
    _span("graph.capture", 107.0, 108.0, nodes=37_000, pool_bytes=1),
    _span("trainer.score", 110.0, 110.1),
    _span("graph.eager", 112.0, 113.0),
    _span("graph.capture", 113.0, 117.0, nodes=5, pool_bytes=1),
]


def _ctx():
    return SimpleNamespace(spans=list(WINDOW), trials=2, batches=40)


@pytest.fixture
def program(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(PROGRAM))


@pytest.mark.parametrize("metric,want", [
    ("capture_s", (1.5 + 1.0) / 2),
    ("eager_epoch_s", (0.5 + 0.75) / 2),
    ("graph_nodes_per_step", 37_000 / 40),
    ("first_score_s", 1.5)])
def test_a_reader_keeps_the_windows_spans(program, metric, want):
    assert reader(ROOT, metric)(_ctx()) == pytest.approx(want)


def test_the_first_score_must_come_before_the_window(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [
        s for s in PROGRAM if s.start_ns >= 100 * S])
    assert reader(ROOT, "first_score_s")(_ctx()) is None


@pytest.mark.parametrize("metric", ["capture_s", "eager_epoch_s",
                                    "graph_nodes_per_step",
                                    "first_score_s"])
def test_no_spans_no_number(monkeypatch, metric):
    # a program older than its recorder, and one that ran no graph
    monkeypatch.delattr(profiling, "spans")
    assert reader(ROOT, metric)(_ctx()) is None
    monkeypatch.setattr(profiling, "spans", lambda: [], raising=False)
    assert reader(ROOT, metric)(_ctx()) is None


def test_a_traced_run_on_the_cpu_reads_the_first_score():
    result, _ = run("mfm_mosi.trials", trace=True)
    metrics = result["metrics"]
    assert metrics["first_score_s"]["value"] > 0
    assert metrics["first_score_s"]["unit"] == "s"
    # no graph is captured on the CPU
    assert not {"capture_s", "eager_epoch_s",
                "graph_nodes_per_step"} & set(metrics)
