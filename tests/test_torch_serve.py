"""The port's serving path on the CPU: Predictor against the JAX
package's Predictor on the same weights, the frozen-params guard,
MicroBatcher merging, the HTTP endpoint, the checkpoint round trip, the
CLI, and the refusal to run on the CPU unless asked."""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import factorized_tpu.models.mfm as jmfm
from factorized_tpu.config import MFMConfig as JaxConfig
from factorized_tpu.serve import Predictor as JaxPredictor
from factorized_tpu_torch import resolve_device
from factorized_tpu_torch.cli import build_parser, main
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.convert import from_numpy
from factorized_tpu_torch.models.mfm import MFM
from factorized_tpu_torch.serve import (MicroBatcher, Predictor,
                                        make_server, serve_http)
from factorized_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)

JCFG = JaxConfig(
    seqlength=5, input_dims=[8, 4, 5], h_dims=[6, 5, 4], memsize=6,
    zy_size=5, zl_size=6, za_size=4, zv_size=5,
    fy_size=4, fl_size=5, fa_size=4, fv_size=3,
    att1_shape=8, att2_shape=8, gamma1_shape=8, gamma2_shape=8,
)
CFG = MFMConfig.from_dict(JCFG.to_dict())


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jmfm.mfm_init(jax.random.PRNGKey(0),
                                                  JCFG))


@pytest.fixture(scope="module")
def predictor(jax_params):
    return Predictor(CFG, from_numpy(jax_params), batch_size=8, device="cpu")


def _x(n, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, CFG.seqlength, CFG.d_total)).astype(np.float32)


def test_predict_matches_jax_predictor(jax_params, predictor):
    ref = JaxPredictor(JCFG, jax_params, batch_size=8)
    X = _x(19)                       # two full chunks and a ragged one
    y = predictor.predict(X)
    assert y.shape == (19,)
    np.testing.assert_allclose(y, ref.predict(X), rtol=2e-4, atol=1e-5)
    empty = predictor.predict(np.zeros((0, CFG.seqlength, CFG.d_total)))
    assert empty.shape == ref.predict(
        np.zeros((0, CFG.seqlength, CFG.d_total))).shape == (0,)
    # chunking does not change the answer
    whole = Predictor(CFG, predictor.params, batch_size=32, device="cpu")
    np.testing.assert_allclose(whole.predict(X), y, rtol=1e-5, atol=1e-6)
    probe = predictor.probe(X, reps=2)
    assert probe["n"] == 19 and probe["median_s"] > 0


def test_params_frozen_guard(predictor):
    p = Predictor(CFG, predictor.params, batch_size=8, device="cpu")
    X = _x(2)
    assert p.predict(X).shape == (2,)
    p.params = dict(p.params)
    with pytest.raises(ValueError, match="frozen"):
        p.predict(X)


def test_microbatcher_merges_concurrent_requests(predictor):
    batcher = MicroBatcher(predictor, max_wait_ms=200.0)
    xs = [_x(k, seed=k) for k in (1, 2, 3, 1, 2, 1)]
    out = [None] * len(xs)
    go = threading.Barrier(len(xs))

    def hit(i):
        go.wait()
        out[i] = batcher.submit(xs[i])

    threads = [threading.Thread(target=hit, args=(i,))
               for i in range(len(xs))]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        with pytest.raises(ValueError, match="expected input shape"):
            batcher.submit(np.zeros((2, 3, 4), np.float32))
    finally:
        batcher.close()
    for x, y in zip(xs, out):
        np.testing.assert_allclose(y, predictor.predict(x), rtol=1e-5,
                                   atol=1e-6)
    assert batcher.requests_served == len(xs)
    assert batcher.batches_run < len(xs)
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(xs[0])


@pytest.mark.parametrize("micro_batch", [True, False])
def test_http_endpoint(predictor, micro_batch):
    server, batcher = make_server(predictor, "127.0.0.1", 0,
                                  micro_batch=micro_batch)
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{port}"

    def post(payload):
        req = urllib.request.Request(
            f"{base}/predict", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read())

    try:
        X = _x(3)
        y = np.asarray(post({"x": X.tolist()})["y"], np.float32)
        np.testing.assert_allclose(y, predictor.predict(X), rtol=1e-5,
                                   atol=1e-6)
        one = post({"x": X[0].tolist()})["y"]        # one (t, d) sample
        assert len(one) == 1
        with pytest.raises(urllib.error.HTTPError) as bad:
            post({"x": [[1.0, 2.0]]})
        assert bad.value.code == 400
        with urllib.request.urlopen(f"{base}/health", timeout=30) as resp:
            info = json.loads(resp.read())
        assert info["status"] == "ok" and info["model_type"] == "mfm"
        assert info["micro_batch"] is micro_batch
        assert info["device"] == "cpu"
        with pytest.raises(urllib.error.HTTPError) as missing:
            urllib.request.urlopen(f"{base}/nope", timeout=30)
        assert missing.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        if batcher is not None:
            batcher.close()
    th.join(timeout=10)
    assert not th.is_alive()


def test_serve_http_blocks_and_answers(predictor):
    # serve_http runs until the process ends, as the CLI's server does:
    # a daemon thread on a port found free just before
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    threading.Thread(target=serve_http, args=(predictor, "127.0.0.1", port),
                     daemon=True).start()
    X = _x(2)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict",
        data=json.dumps({"x": X.tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    deadline = time.monotonic() + 30
    while True:
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                y = np.asarray(json.loads(resp.read())["y"], np.float32)
            break
        except urllib.error.URLError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)
    np.testing.assert_allclose(y, predictor.predict(X), rtol=1e-5, atol=1e-6)


def test_checkpoint_round_trip(tmp_path, predictor):
    model = MFM(CFG, seed=3, device="cpu")
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, model.tree(), step=7, config=CFG.to_dict())
    meta = json.loads((tmp_path / "ckpt" / "meta.json").read_text())
    assert meta == {"step": 7, "config": CFG.to_dict(),
                    "has_opt_state": False, "format": "torch"}
    state, _ = restore_checkpoint(path)
    for k, v in model.state_dict().items():
        node = state["params"]
        for part in k.split("."):
            node = node[part]
        assert torch.equal(node, v)
    p = Predictor.from_checkpoint(path, batch_size=8, device="cpu")
    direct = Predictor(CFG, model.tree(), batch_size=8, device="cpu")
    X = _x(5)
    np.testing.assert_array_equal(p.predict(X), direct.predict(X))
    # a JAX package's format is read from its own files (state/ for
    # Orbax), which this directory lacks; an unknown format is refused
    (tmp_path / "ckpt" / "meta.json").write_text(
        json.dumps(dict(meta, format="orbax")))
    with pytest.raises(FileNotFoundError, match="_METADATA"):
        restore_checkpoint(path)
    (tmp_path / "ckpt" / "meta.json").write_text(
        json.dumps(dict(meta, format="pickle")))
    with pytest.raises(ValueError, match="format 'pickle'"):
        restore_checkpoint(path)


def test_cli_parse_and_serve(tmp_path, monkeypatch):
    args = build_parser().parse_args(
        ["serve", "--checkpoint", "d", "--host", "0.0.0.0", "--port", "0",
         "--no-microbatch", "--max-wait-ms", "5", "--device", "cpu"])
    assert (args.checkpoint, args.host, args.port, args.no_microbatch,
            args.max_wait_ms, args.device) == ("d", "0.0.0.0", 0, True,
                                               5.0, "cpu")
    defaults = build_parser().parse_args(["serve", "--checkpoint", "d"])
    assert (defaults.port, defaults.device, defaults.no_microbatch) == \
        (8787, None, False)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, MFM(CFG, device="cpu").tree(),
                    config=CFG.to_dict())
    seen = {}

    def fake_serve(predictor, host, port, micro_batch, max_wait_ms):
        seen.update(device=str(predictor.device), host=host, port=port,
                    micro_batch=micro_batch, max_wait_ms=max_wait_ms)

    monkeypatch.setattr("factorized_tpu_torch.serve.serve_http", fake_serve)
    assert main(["serve", "--checkpoint", path, "--device", "cpu",
                 "--port", "0", "--no-microbatch"]) == 0
    assert seen == {"device": "cpu", "host": "127.0.0.1", "port": 0,
                    "micro_batch": False, "max_wait_ms": 3.0}


def test_entry_points_refuse_the_cpu_unless_asked(tmp_path, monkeypatch,
                                                  predictor):
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, predictor.params, config=CFG.to_dict())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(CFG, predictor.params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor.from_checkpoint(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MFM(CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["serve", "--checkpoint", path])
    assert resolve_device("cpu") == torch.device("cpu")
