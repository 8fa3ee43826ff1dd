"""The harness is driven by data: a configuration, a traffic mix, a cell
and a per-layer metric that a later change adds as files, with entries in
``BENCHMARK.json``, are found by name and run with no edit of code."""

import json
import shutil

from tiny import CONFIG, TRAFFIC, run


def test_new_files_are_found_by_name(tmp_path):
    from tiny import ROOT

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    here = tmp_path / "portbench"
    config = json.loads((here / "configs" / "mfm_mosi.json").read_text())
    config.update(CONFIG, batchsize=4, num_epochs=2)
    (here / "configs" / "new_model.json").write_text(json.dumps(config))
    (here / "traffic" / "seeds2.json").write_text(
        json.dumps(dict(TRAFFIC, lanes=2)))
    (here / "limits" / "new_model.seeds2.json").write_text(
        (here / "limits" / "mfm_mosi.seeds32.json").read_text())
    (here / "metrics" / "trials_in_window.py").write_text(
        "def read(ctx):\n    return float(ctx.trials)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "new_model", "source": "a test",
                             "file": "portbench/configs/new_model.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "new_model.seeds2",
                               "config": "new_model", "traffic": "seeds2",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "trials_in_window", "unit": "trials",
                               "better": "higher", "source": "host_clock",
                               "layer": "trainers",
                               "moves": "train_samples_per_s",
                               "workloads": ["new_model.seeds2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    result, _ = run("new_model.seeds2", trace=True, root=tmp_path)
    assert result["metrics"]["trials_in_window"]["value"] >= 1
    assert result["attempted"] == 2 * result["metrics"][
        "trials_in_window"]["value"]
    # a metric that lists other cells is not read here
    assert "encode_roofline" not in result["metrics"]
