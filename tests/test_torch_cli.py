"""The ``mosi`` command line's run log and checkpoint against the JAX
package's: the log's first line is the config in the reference's
six-dict layout (``MFMConfig.to_legacy``), and ``--save-ckpt`` writes the
fields a resume reads back (``_resume_lr``, ``_resume_best_valid``)."""

import json

import numpy as np
import pytest
import torch

from factorized_tpu.config import MFMConfig as JaxConfig
from factorized_tpu.config import best_acc_mosi_config as jax_best
from factorized_tpu_torch import cli
from factorized_tpu_torch.config import MFMConfig, best_acc_mosi_config
from factorized_tpu_torch.utils.checkpoint import restore_checkpoint

# best_acc_mosi_config, and a kl_ef and a missing config off the defaults
CONFIGS = {
    "best": {},
    "kl_ef": dict(model_type="kl_ef", h_dims=[40, 24, 16], memsize=32,
                  batchsize=16, num_epochs=7),
    "missing": dict(missing=1, zl_size=24, att1_shape=64, gamma2_drop=0.3,
                    lr=5e-4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on few cores; with one torch
    thread each, the small CPU ops here do not wait on one another."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_to_legacy_is_the_jax_packages(name):
    port = best_acc_mosi_config(**CONFIGS[name])
    ref = jax_best(**CONFIGS[name])
    assert port.to_legacy() == ref.to_legacy()
    assert (json.dumps(port.to_legacy(), default=str)
            == json.dumps(ref.to_legacy(), default=str))


def test_to_legacy_of_the_defaults_is_the_jax_packages():
    assert MFMConfig().to_legacy() == JaxConfig().to_legacy()


def test_mosi_run_logs_the_legacy_config_and_saves_the_resume_fields(
        tmp_path, monkeypatch, capsys):
    """A 2-epoch CPU run: the first stdout line is the legacy config, and
    the checkpoint's config holds the last epoch's lr and the best
    validation loss."""
    rng = np.random.default_rng(1)

    def data(n):
        return (rng.normal(size=(n, 20, 325)).astype(np.float32),
                rng.normal(size=(n,)).astype(np.float32))

    monkeypatch.setattr(cli, "load_mosi",
                        lambda t, **kw: (*data(24), *data(8), *data(8)))
    out = tmp_path / "runs"
    argv = ["mosi", "--mode", "best", "--epochs", "2", "--batchsize", "8",
            "--device", "cpu", "--out", str(out), "--save-ckpt"]
    assert cli.main(argv) == 0
    first = capsys.readouterr().out.splitlines()[0]
    cfg = cli.trial_config(cli.build_parser().parse_args(argv))
    assert first == json.dumps(cfg.to_legacy(), default=str)
    assert json.loads(first) == json.loads(json.dumps(
        jax_best(input_dims=[300, 5, 20], num_epochs=2,
                 batchsize=8).to_legacy(), default=str))
    _, meta = restore_checkpoint(str(out / "ckpt_mosi_0"))
    history = [json.loads(line) for line in
               (out / "mosi_0.jsonl").read_text().splitlines()
               if json.loads(line)["kind"] == "epoch"]
    assert len(history) == 2
    resume_lr = meta["config"]["_resume_lr"]
    assert isinstance(resume_lr, float) and resume_lr > 0.0
    best = meta["config"]["_resume_best_valid"]
    assert np.isfinite(best)
    assert best == min(e["valid_loss"] for e in history)
