"""The port's multi-process gate (``factorized_tpu_torch/parallel/
multiprocess.py``) on the CPU, as the caller asks (``device="cpu"``; the
card is the default, and without one the launcher and the worker raise
before any training): two gloo ranks on 127.0.0.1 train the
data-parallel payload (the JAX package's tiny MFM config, dropout and the
MMD on) while one process trains it on the whole batch; the ranks' trained
parameters and per-epoch losses equal the single process's within 1e-5
(the JAX package's bound) and each other's bit for bit. The worker refuses
a world of two without a coordinator, and a rank whose rendezvous never
comes is killed at its deadline with its output in the error."""

import subprocess
import sys

import numpy as np
import pytest

from factorized_tpu_torch.parallel import multiprocess


@pytest.fixture(scope="module")
def report():
    return multiprocess.verify_multiprocess(2, 1, epochs=2, timeout=180,
                                         device="cpu")


def test_verify_multiprocess_passes(report):
    assert report["ok"] and report["global_devices"] == 2
    assert report["max_abs_diff_vs_single_process"] < 1e-5
    assert len(report["accs"]) == 2 and np.isfinite(report["accs"]).all()


def test_the_ranks_agree_bit_for_bit(report):
    assert report["ranks_bitwise_equal"]
    # the plain versions on the CPU: no kernel launch, on any rank
    for launches in (*report["launches"], report["single_launches"]):
        assert launches and not any(launches.values())


def test_the_worker_refuses_a_missing_coordinator(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        multiprocess.worker_main(["--process-id", "0", "--num-processes",
                                  "2", "--local-devices", "1", "--out",
                                  str(tmp_path / "w.npz")])
    assert e.value.code == 2
    assert "--coordinator is required" in capsys.readouterr().err


def test_the_module_is_spawnable():
    out = subprocess.run(
        [sys.executable, "-m", "factorized_tpu_torch.parallel.multiprocess",
         "--help"], capture_output=True, text=True, timeout=60,
        cwd=multiprocess._REPO_ROOT)
    assert out.returncode == 0 and "--coordinator" in out.stdout


def test_a_rank_left_alone_is_killed_at_its_deadline(tmp_path):
    from factorized_tpu_torch.parallel.sharding import free_port

    args = [["--process-id", 0, "--num-processes", 2, "--local-devices", 1,
             "--coordinator", f"127.0.0.1:{free_port()}", "--out",
             tmp_path / "w.npz", "--device", "cpu"]]
    outs = multiprocess.spawn([multiprocess.worker_command(*a)
                               for a in args], 4.0, str(tmp_path))
    assert outs[0][0] is None
    with pytest.raises(RuntimeError, match="killed after 4 s"):
        multiprocess.check(outs, "multiprocess worker", 4.0)


@pytest.mark.parametrize("entry", ["launch", "worker"])
def test_the_card_is_the_default(entry, tmp_path, monkeypatch):
    """Without ``device``/``--device`` a rank runs on its card; with no
    card that is an error, never a quiet move to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "launch":
            multiprocess.launch(2, 1, out_dir=str(tmp_path), timeout=5)
        else:
            multiprocess.worker_main([
                "--process-id", "0", "--num-processes", "1",
                "--local-devices", "1", "--out", str(tmp_path / "w.npz")])
