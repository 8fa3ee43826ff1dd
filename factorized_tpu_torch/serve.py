"""Inference and serving (port of ``factorized_tpu/serve.py``).

- :class:`Predictor` holds frozen weights on the device and exposes a
  numpy-in/numpy-out ``predict`` that pads every chunk to a static batch.
- :class:`MicroBatcher` merges concurrent requests into one batch.
- :func:`serve_http` is a JSON-over-HTTP endpoint on the standard
  library's ``http.server``.

Everything runs on the CUDA card unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from factorized_tpu_torch import resolve_device
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.models import get_model


# the standard-return model types the JAX package's Predictor serves
SUPPORTED = ("mfm", "kl", "kl_ef", "missing", "m_a", "m_b", "m_c", "m_d",
             "mfn")


class Predictor:
    """Serves ``y_hat`` of a model of the MFM family (``model_type``,
    default ``cfg.model_type``; ported: ``mfm``, ``kl_ef`` and
    ``missing``, whose all-present decode gives ``y_hat``)."""

    def __init__(self, cfg: MFMConfig, params, model_type: Optional[str] = None,
                 batch_size: int = 256, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.batch_size = batch_size
        name = model_type or cfg.model_type
        if name not in SUPPORTED:
            raise ValueError(
                f"Predictor supports the standard-return model types "
                f"{SUPPORTED}, got {name!r} (s2s/bm have different "
                f"outputs - load them through their trainers)")
        _, apply_fn = get_model(name)
        self._name = name

        def to_device(tree):
            if isinstance(tree, dict):
                return {k: to_device(v) for k, v in tree.items()}
            return torch.as_tensor(tree, dtype=torch.float32).to(
                self.device).contiguous()

        params_dev = to_device(params)
        # The device copy is taken once, here: reassigning .params (e.g. a
        # checkpoint hot-reload) would silently keep serving the
        # construction-time weights, so fail loudly instead (hot-reload =
        # build a new Predictor).
        frozen = params

        def _fwd(x):
            if self.params is not frozen:
                raise ValueError(
                    "Predictor weights are frozen at construction (copied "
                    "to the device); build a new Predictor instead of "
                    "reassigning .params")
            # eval mode is deterministic: the MMD draw is seeded the same
            # way on every call, as the JAX Predictor passes PRNGKey(0)
            gen = torch.Generator(device=self.device).manual_seed(0)
            with torch.inference_mode():
                out = apply_fn(params_dev, x, cfg, generator=gen,
                               train=False)
            y_hat = out[0][3]
            # scalar regression -> (n,); classification keeps (n, C)
            return (y_hat.squeeze(1)
                    if cfg.task == "regression" and cfg.output_dim == 1
                    else y_hat)

        self._fwd = _fwd

    @classmethod
    def from_checkpoint(cls, path: str, **kw):
        """A Predictor over a checkpoint of ``utils.checkpoint``; ``kw`` go
        to the constructor (e.g. ``model_type="missing"`` for a checkpoint
        of ``--missing 1``, whose config keeps ``model_type`` "mfm")."""
        from factorized_tpu_torch.utils.checkpoint import restore_checkpoint

        state, meta = restore_checkpoint(path)
        return cls(MFMConfig.from_dict(meta["config"]), state["params"], **kw)

    def _empty_result(self):
        """Shape-correct zero-length result: (0,) for scalar regression,
        (0, C) for classification logits and multi-output regression."""
        if self.cfg.task == "classification" or self.cfg.output_dim > 1:
            return np.zeros((0, self.cfg.output_dim), np.float32)
        return np.zeros((0,), np.float32)

    def _pad_to_batch(self, chunk):
        """Zero-pad rows up to the static serving batch size. Returns
        (padded, n_pad)."""
        pad = self.batch_size - chunk.shape[0]
        if pad > 0:
            chunk = np.concatenate(
                [chunk, np.zeros((pad,) + chunk.shape[1:], np.float32)])
        return chunk, max(pad, 0)

    def predict(self, X):
        """X batch-major (n, t, d_total) numpy -> predictions (n,) or
        logits (n, C). Every chunk is padded to ``batch_size`` rows."""
        X = np.asarray(X, np.float32)
        n = X.shape[0]
        if n == 0:
            return self._empty_result()
        outs = []
        B = self.batch_size
        for s in range(0, n, B):
            chunk, pad = self._pad_to_batch(X[s:s + B])
            xt = torch.from_numpy(np.ascontiguousarray(chunk.swapaxes(0, 1)))
            y = self._fwd(xt.to(self.device)).cpu().numpy()
            outs.append(y[: B - pad] if pad else y)
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    def probe(self, X, reps: int = 10):
        """Latency probe: median end-to-end seconds of one ``predict(X)``
        after a warm-up call (host clock; ``predict`` returns host arrays,
        so the device work is done inside the timed region)."""
        times = []
        self.predict(X)
        for _ in range(reps):
            t0 = time.perf_counter()
            self.predict(X)
            times.append(time.perf_counter() - t0)
        n = int(np.asarray(X).shape[0])
        return {
            "n": n,
            "median_s": float(np.median(times)),
            "p99_s": float(np.quantile(times, 0.99)),
            "throughput_per_s": float(n / np.median(times)),
        }


class MicroBatcher:
    """Dynamic request coalescing for online serving.

    One worker thread drains a queue, concatenates waiting requests into
    ONE batch (up to ``max_batch`` samples, waiting at most
    ``max_wait_ms`` after the first arrival), runs one padded forward and
    scatters the results back: N concurrent small requests cost one
    forward's kernel launches instead of N.

    ``submit`` is thread-safe and blocks until the caller's slice is
    ready; an exception from the batched forward reaches every caller in
    that batch.
    """

    def __init__(self, predictor: Predictor, max_batch: Optional[int] = None,
                 max_wait_ms: float = 3.0):
        self.predictor = predictor
        self.max_batch = int(max_batch or predictor.batch_size)
        self.max_wait = max_wait_ms / 1e3
        self.batches_run = 0       # forwards executed
        self.requests_served = 0   # requests coalesced into them
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        # serializes submit()'s stop-check + enqueue against close():
        # without it a request could pass the check, be enqueued after
        # close() drained the queue, and block its caller forever
        self._close_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="microbatcher")
        self._thread.start()

    def submit(self, x):
        """x (n, t, d) -> predictions for exactly these n samples."""
        x = np.asarray(x, np.float32)
        # validate BEFORE enqueueing: a malformed request fails alone and
        # never poisons the batch it would be coalesced into
        t = self.predictor.cfg.seqlength
        d = sum(self.predictor.cfg.input_dims)
        if x.ndim != 3 or x.shape[1:] != (t, d):
            raise ValueError(
                f"expected input shape (n, {t}, {d}), got {x.shape}")
        if x.shape[0] == 0:
            return self.predictor._empty_result()
        box = {}
        ev = threading.Event()
        with self._close_lock:
            if self._stop.is_set():
                raise RuntimeError(
                    "MicroBatcher is closed - no worker will serve this "
                    "request")
            self._queue.put((x, box, ev))
        ev.wait()
        if "error" in box:
            raise box["error"]
        return box["y"]

    def _loop(self):
        while not self._stop.is_set():
            try:
                batch = [self._queue.get(timeout=0.1)]
            except queue.Empty:
                continue
            total = batch[0][0].shape[0]
            deadline = time.perf_counter() + self.max_wait
            while total < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    item = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                batch.append(item)
                total += item[0].shape[0]
            try:
                y = self.predictor.predict(
                    np.concatenate([b[0] for b in batch]))
                o = 0
                for x, box, ev in batch:
                    box["y"] = y[o:o + x.shape[0]]
                    o += x.shape[0]
                    ev.set()
                self.batches_run += 1
                self.requests_served += len(batch)
            except Exception as e:  # noqa: BLE001 - fan out to callers
                for _, box, ev in batch:
                    box["error"] = e
                    ev.set()

    def close(self):
        with self._close_lock:
            # after this, submit() raises instead of enqueueing: every
            # request already enqueued is served by the worker or failed
            # by the drain below
            self._stop.set()
        self._thread.join(timeout=2)
        while True:
            try:
                _, box, ev = self._queue.get_nowait()
            except queue.Empty:
                break
            box["error"] = RuntimeError("MicroBatcher closed")
            ev.set()


def make_server(predictor: Predictor, host: str = "127.0.0.1",
                port: int = 8787, micro_batch: bool = True,
                max_wait_ms: float = 3.0):
    """The HTTP server behind :func:`serve_http`, not yet serving:
    POST /predict {"x": [[...t x d...]]} -> {"y": [...]}; GET /health ->
    model info. Returns (server, batcher); batcher is None without
    micro-batching, when a lock serializes device access instead. Port 0
    takes a free port (``server.server_address[1]``). The caller runs
    ``server.serve_forever()`` and, when done, ``server.shutdown()``,
    ``server.server_close()`` and ``batcher.close()``."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    device_lock = threading.Lock()
    batcher = (MicroBatcher(predictor, max_wait_ms=max_wait_ms)
               if micro_batch else None)

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, status, body):
            try:
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                pass  # client went away; nothing sane to send

        def do_GET(self):
            if self.path != "/health":
                self.send_error(404)
                return
            info = {
                "status": "ok",
                "model_type": predictor._name,
                "task": predictor.cfg.task,
                "seqlength": predictor.cfg.seqlength,
                "d_total": sum(predictor.cfg.input_dims),
                "batch_size": predictor.batch_size,
                "device": str(predictor.device),
                "micro_batch": batcher is not None,
            }
            if batcher is not None:
                info["batches_run"] = batcher.batches_run
                info["requests_served"] = batcher.requests_served
            self._reply(200, json.dumps(info).encode())

        def do_POST(self):
            if self.path != "/predict":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            # compute the whole response before sending any status, so an
            # error still produces a clean 400
            try:
                payload = json.loads(self.rfile.read(length))
                x = np.asarray(payload["x"], np.float32)
                if x.ndim == 2:
                    x = x[None]
                if batcher is not None:
                    y = batcher.submit(x)
                else:
                    with device_lock:
                        y = predictor.predict(x)
                status = 200
                body = json.dumps({"y": np.asarray(y).tolist()}).encode()
            except Exception as e:  # noqa: BLE001 - report to client
                status = 400
                body = json.dumps({"error": str(e)}).encode()
            self._reply(status, body)

        def log_message(self, *a):
            pass

    return ThreadingHTTPServer((host, port), Handler), batcher


def serve_http(predictor: Predictor, host: str = "127.0.0.1",
               port: int = 8787, micro_batch: bool = True,
               max_wait_ms: float = 3.0):
    """Blocking JSON HTTP endpoint (see :func:`make_server`). With
    ``micro_batch`` (default) concurrent requests are coalesced by
    :class:`MicroBatcher`; otherwise a lock serializes them."""
    server, batcher = make_server(predictor, host, port, micro_batch,
                                  max_wait_ms)
    print(f"serving on http://{host}:{server.server_address[1]}/predict",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        if batcher is not None:
            batcher.close()
