"""``--profile DIR`` (``factorized_tpu_torch/utils/profiling.py``): the
command traced by torch.profiler into a Chrome trace that names the
products it ran; ``Throughput`` and ``time_fn`` on the host clock."""

import json

import numpy as np
import torch

from factorized_tpu_torch import cli
from factorized_tpu_torch.utils.profiling import Throughput, time_fn, trace

TINY = {"seqlength": 5, "h_dims": [4, 4, 4], "memsize": 4, "zy_size": 4,
        "zl_size": 4, "za_size": 4, "zv_size": 4, "fy_size": 4,
        "fl_size": 4, "fa_size": 4, "fv_size": 4, "att1_shape": 4,
        "att2_shape": 4, "gamma1_shape": 4, "gamma2_shape": 4,
        "batchsize": 8, "num_epochs": 1}


def _traces(directory):
    return sorted(directory.glob("*.pt.trace.json"))


def test_profile_writes_a_trace_of_the_command(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    data = []
    for n in (16, 8, 8):
        data += [rng.normal(size=(n, 5, 325)).astype(np.float32),
                 rng.normal(size=(n,)).astype(np.float32)]
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
    assert list((tmp_path / "runs").glob("*.jsonl"))


def test_trace_and_timers_on_the_host(tmp_path):
    a = torch.ones(64, 64)
    with trace(str(tmp_path)):
        a @ a
    assert len(_traces(tmp_path)) == 1
    meter = Throughput(device="cpu")
    meter.start()
    a @ a
    meter.stop(4)
    assert meter.steps == 4 and meter.steps_per_sec > 0
    assert time_fn(torch.mm, a, a, reps=3, device="cpu") > 0
