"""The port's ``check`` (``factorized_tpu_torch/check.py`` and the ``check``
subcommand) against the JAX package's, line for line: the same printed
lines and the same summaries on fabricated reference-format text logs,
on JSONL logs (the single-seed trainers' ``final`` records, ``missing``'s
per-condition sub-dicts, the multi-seed ``per_seed`` lists, the
multi-trait ``mae: [..]`` lists), with ``--condition``, ``--multitrait``
and ``--style pom|ie2``, and on a directory the port's command wrote
(``--seeds 2`` beside a single-seed run). Exact equality: the scraper
computes nothing in floating point but a min, a max and a rounding."""

import json

import numpy as np
import pytest

from factorized_tpu import check as jax_check
from factorized_tpu import cli as jax_cli
from factorized_tpu_torch import check, cli

REFERENCE_LOG = """\
[{'input_dims': [300, 5, 20]}]
0 1.08 1.03 saving model
1 1.07 1.02
scoring y_hat
mae:  0.993
corr:  0.62
mult_acc:  0.34
mult f_score:  0.49
Classification Report :
              precision    recall  f1-score   support

       False    0.51603   1.00000   0.68077       354
        True    0.00000   0.00000   0.00000       332

    accuracy                        0.51603       686
   macro avg    0.25802   0.50000   0.34038       686
weighted avg    0.26629   0.51603   0.35130       686
avg / total    0.26629   0.51603   0.35330       686
Accuracy  0.77
mae:  1.05
corr:  0.44
mult_acc:  0.31
Accuracy  0.71
"""

MISSING_LOG = """\
OrderedDict([('zy_size', 32)])
all present 0.11 0.22 0.33
l missing 0.5 0.6 0.7
a missing 0.4 0.5 0.6
v missing 0.3 0.4 0.5
scoring y_hat_nol
mae:  1.11
Accuracy  0.70
scoring y_hat_noa
mae:  1.22
Accuracy  0.65
scoring y_hat_nov
mae:  1.33
corr:  0.5
"""

MULTITRAIT_LOG = """\
mae: [0.91, 1.12, 0.73, 0.55]
corr: [0.21, 0.32, 0.43, nan]
mult_acc: [0.31, 0.22, 0.53, 0.14]
test mae: [0.1, 0.1, 0.1, 0.1]
mae: [0.81, 1.22, 0.63, 0.65]
corr: [0.25, 0.12, 0.53, 0.24]
"""


def _jsonl(path, records):
    path.write_text("".join(json.dumps(r) + "\n" for r in records))


def _fabricate(root):
    """A directory of every kind of log ``check`` reads."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "ref.txt").write_text(REFERENCE_LOG)
    (root / "missing.log").write_text(MISSING_LOG)
    (root / "missing_b.txt").write_text(
        MISSING_LOG.replace("0.5 0.6 0.7", "0.1 0.9 0.2"))
    (root / "notes.md").write_text("mae: 0.001\n")
    _jsonl(root / "mosi_0.jsonl", [
        {"kind": "config", "zy_size": 32},
        {"kind": "epoch", "epoch": 0, "train_loss": 1.0, "valid_loss": 0.9},
        {"kind": "final", "mae": 0.97, "corr": 0.31, "mult_acc": 0.3,
         "mult_f_score": 0.4, "binary_accuracy": 0.55, "binary_f1": 0.5}])
    _jsonl(root / "mosi_1.jsonl", [
        {"kind": "config"},
        {"kind": "final", "per_seed": [
            {"mae": 0.99, "corr": 0.2, "binary_accuracy": 0.51},
            {"mae": 0.95, "corr": float("nan"), "binary_accuracy": 0.58},
            {"mae": 1.02, "corr": 0.35, "binary_accuracy": 0.49}],
         "best_seed": 1}])
    _jsonl(root / "missing_0.jsonl", [
        {"kind": "config"},
        {"kind": "final",
         "y_hat": {"mae": 0.9, "binary_accuracy": 0.6},
         "y_hat_nol": {"mae": 1.1, "binary_accuracy": 0.5},
         "y_hat_noa": {"mae": 1.2, "binary_accuracy": 0.52},
         "y_hat_nov": {"mae": 1.0, "binary_accuracy": 0.56}}])
    _jsonl(root / "you_0.jsonl", [
        {"kind": "config"},
        {"kind": "final", "accuracy": 0.61, "f1_weighted": 0.58}])
    _jsonl(root / "broken.jsonl", [{"kind": "final", "mae": 0.5}])
    with open(root / "broken.jsonl", "a") as f:
        f.write("{not json\n")
    return root


def _multitrait(root, traits=4):
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    text = MULTITRAIT_LOG
    if traits != 4:  # every log of a directory has one trait count
        rows = [", ".join(str(round(v, 3))
                          for v in rng.uniform(0.1, 1.2, traits))
                for _ in range(5)]
        text = "".join(f"{key}: [{row}]\n" for key, row in zip(
            ("mae", "corr", "mult_acc", "mae", "corr"), rows))
    (root / "pom_0.txt").write_text(text)
    for k in range(2):
        _jsonl(root / f"pom_{k + 1}.jsonl", [{"kind": "config"}, *[
            {"kind": "final",
             "mae": rng.uniform(0.5, 1.5, traits).tolist(),
             "corr": rng.uniform(-0.2, 0.6, traits).tolist(),
             "mult_acc": rng.uniform(0.1, 0.6, traits).tolist()}
            for _ in range(2)]])
    return root


def _lines(fn, *args, **kw):
    """fn's printed lines through its ``out``, and its result."""
    lines = []
    result = fn(*args, out=lambda *a: lines.append(" ".join(map(str, a))),
                **kw)
    return lines, result


@pytest.mark.parametrize("condition", [None, "l", "a", "v"])
def test_check_dir_is_the_jax_one(tmp_path, condition):
    root = _fabricate(tmp_path / "logs")
    got = _lines(check.check_dir, str(root), condition=condition)
    want = _lines(jax_check.check_dir, str(root), condition=condition)
    assert got[0] == want[0] and got[0]
    np.testing.assert_equal(got[1], want[1])


@pytest.mark.parametrize("traits", [4, 17])
@pytest.mark.parametrize("style", [None, "pom", "ie2"])
def test_best_multitrait_is_the_jax_one(tmp_path, style, traits):
    root = _multitrait(tmp_path / f"mt_{traits}", traits)
    got = _lines(check.best_multitrait, str(root), style=style)
    want = _lines(jax_check.best_multitrait, str(root), style=style)
    assert got[0] == want[0] and got[0]
    np.testing.assert_equal(got[1], want[1])


@pytest.mark.parametrize("argv", [
    [], ["--condition", "l"], ["--multitrait"],
    ["--multitrait", "--style", "pom"], ["--multitrait", "--style", "ie2"]],
    ids=["dir", "condition", "multitrait", "pom", "ie2"])
def test_the_check_command_is_the_jax_one(tmp_path, capsys, argv):
    root = tmp_path / "logs"
    _fabricate(root)
    _multitrait(root)
    assert cli.main(["check", "--dir", str(root), *argv]) == 0
    got = capsys.readouterr().out
    assert jax_cli.main(["check", "--dir", str(root), *argv]) == 0
    assert got == capsys.readouterr().out and got


def test_check_reads_what_the_port_command_wrote(tmp_path, capsys,
                                                 monkeypatch):
    """A run directory of the port's command: a ``--seeds 2`` trial and a
    single-seed one, at a small ``--config`` on a cut of the synthetic
    MOSI set; both packages' ``check`` print the same lines, and the
    multi-seed run's best is its seeds' best."""
    rng = np.random.default_rng(1)

    def load(*a, **kw):
        out = []
        for n in (32, 16, 16):
            out += [rng.normal(size=(n, 4, 325)).astype(np.float32),
                    rng.normal(size=(n,)).astype(np.float32)]
        return tuple(out)

    monkeypatch.setattr(cli, "load_dataset", load)
    config = tmp_path / "small.json"
    config.write_text(json.dumps({
        "seqlength": 4, "h_dims": [6, 5, 4], "memsize": 6, "zy_size": 5,
        "zl_size": 6, "za_size": 4, "zv_size": 5, "fy_size": 4,
        "fl_size": 5, "fa_size": 4, "fv_size": 3, "att1_shape": 8,
        "att2_shape": 8, "gamma1_shape": 8, "gamma2_shape": 8,
        "batchsize": 16}))
    out = tmp_path / "runs"
    common = ["mosi", "--config", str(config), "--epochs", "1", "--device",
              "cpu", "--out", str(out)]
    assert cli.main([*common, "--seeds", "2"]) == 0
    (out / "mosi_0.jsonl").rename(out / "mosi_seeds.jsonl")
    assert cli.main(common) == 0
    capsys.readouterr()
    assert cli.main(["check", "--dir", str(out)]) == 0
    got = capsys.readouterr().out
    assert jax_cli.main(["check", "--dir", str(out)]) == 0
    assert got == capsys.readouterr().out
    lines = got.splitlines()
    assert lines[0] == "mosi_0.jsonl 1" and "mosi_seeds.jsonl 1" in lines
    final = [json.loads(line) for line in
             (out / "mosi_seeds.jsonl").read_text().splitlines()][-1]
    seeds = [m["mae"] for m in final["per_seed"]]
    assert len(seeds) == 2
    seeds_block = lines[lines.index("mosi_seeds.jsonl 1"):]
    assert f"mae: {min(seeds)}" in seeds_block[:seeds_block.index("")]
