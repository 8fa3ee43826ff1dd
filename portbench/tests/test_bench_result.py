"""The run's contract: the result line's keys, the metrics each kind of
run reports, the compared numbers last on standard error and in the
line, no result and a nonzero exit without a card."""

import json
import os
import subprocess
import sys

import pytest

from tiny import ROOT, run

KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


def test_untraced_run_reports_the_end_to_end_metrics():
    result, lines = run("mfm_mosi.trials")
    assert list(result) == KEYS
    assert sorted(result["metrics"]) == ["setup_s", "train_samples_per_s"]
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert [ln.split(":")[0] for ln in lines[1:]] == [
        f"compared {k}" for k in result["compared"]]


def test_traced_run_adds_its_breakdown_and_device_window():
    result, _ = run("m_b_mosi.trials", trace=True)
    assert list(result) == KEYS[:-1] + ["breakdown", "compared"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "setup_s" not in result["metrics"]


def test_no_card_no_result(tmp_path):
    if _has_card():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ, HOME=str(tmp_path), TMPDIR=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "mfm_mosi.trials", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def _has_card():
    import torch

    return torch.cuda.is_available()


def test_result_is_json():
    result, _ = run("mfm_mosi.seeds32")
    assert json.loads(json.dumps(result)) == result
