"""Inference and serving (port of ``factorized_tpu/serve.py``).

- :class:`Predictor` packs a model's weights once into the ``y_hat``-only
  forward (``models.predict.YHat``) and exposes a numpy-in/numpy-out
  ``predict`` that pads every chunk to a static batch. On the card each
  batch size is one CUDA graph, captured at its first use (the
  constructor captures ``batch_size``), that ``predict`` replays once a
  chunk; on the CPU the same forward runs eagerly on the plain kernels.
  ``autotune`` picks the batch size by throughput, ``probe`` and
  ``device_latency`` time it, ``export`` writes the forward with its
  weights as a ``torch.export`` artifact.
- :class:`ExportedPredictor` serves such an artifact without the model
  code or a checkpoint.
- :class:`MicroBatcher` merges concurrent requests into one batch.
- :func:`serve_http` is a JSON-over-HTTP endpoint on the standard
  library's ``http.server``.

Everything runs on the CUDA card unless ``device="cpu"`` is asked for;
a failed capture or replay raises, nothing falls back to an eager
forward on the card.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from factorized_tpu_torch import resolve_device
from factorized_tpu_torch.config import MFMConfig
from factorized_tpu_torch.models import get_model
from factorized_tpu_torch.models.predict import YHat
from factorized_tpu_torch.train import Graphed

# the standard-return model types the JAX package's Predictor serves
SUPPORTED = ("mfm", "kl", "kl_ef", "missing", "m_a", "m_b", "m_c", "m_d",
             "mfn")
# autotune's batch sizes, as the JAX package's
CANDIDATES = (64, 128, 256, 512, 1024)
# one capture at a time in the process: a capture (train.Graphed)
# synchronises the card, empties the allocator's cache and pauses the
# collector, none of which may happen during another thread's capture
_CAPTURE_LOCK = threading.Lock()


class Replay:
    """``forward`` at one batch size as one CUDA graph: ``x`` the static
    batch-major input ``(B, t, d)``, ``y`` the static output; calling it
    replays the graph (``train.Graphed``: an eager warm-up, then one
    capture and its replay, both done here, with the capture's
    ``capture_ms`` and ``pool_bytes``). The capture fails on this
    thread's unsafe calls only, so a server's worker thread can capture
    while other threads use the card."""

    def __init__(self, forward, shape, device):
        x = torch.zeros(shape, dtype=torch.float32, device=device)
        out = {}

        def run():
            with torch.no_grad():
                out["y"] = forward(x.transpose(0, 1))

        self.x = x
        self.graph = Graphed(run, capture_error_mode="thread_local")
        with _CAPTURE_LOCK:
            self.graph()  # the warm-up
            self.graph()  # the capture and its first replay
        self.y = out["y"]
        self.capture_ms = self.graph.capture_ms
        self.pool_bytes = self.graph.pool_bytes

    def __call__(self):
        self.graph()


class Predictor:
    """Serves ``y_hat`` of a model of the MFM family or an ablation
    (``model_type``, default ``cfg.model_type``; ported: ``mfm``, ``kl``,
    ``kl_ef``, ``missing``, whose all-present decode gives ``y_hat``, and
    ``m_a``..``m_d``)."""

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
        get_model(name)  # the types not yet ported raise here
        self._name = name
        self._serve(YHat(cfg, params, name, self.device))

    def _serve(self, forward):
        """Serve ``forward`` (x (t, n, d) time-major -> y_hat). The weights
        are taken once, here: reassigning ``.params`` (e.g. a checkpoint
        hot-reload) would silently keep serving the construction-time
        weights, so ``predict`` fails loudly instead (hot-reload = build a
        new Predictor). On the card the graph of ``batch_size`` is
        captured now, before any server thread runs."""
        self.forward = forward
        self._frozen = self.params
        self._graphs = {}
        self._staging = {}
        self._lock = threading.Lock()
        if self.device.type == "cuda":
            self._graph(self.batch_size)

    @classmethod
    def from_checkpoint(cls, path: str, **kw):
        """A Predictor over a checkpoint of ``utils.checkpoint``: the
        port's, or the JAX package's Orbax or msgpack directory; ``kw`` go
        to the constructor (e.g. ``model_type="missing"`` for a checkpoint
        of ``--missing 1``, whose config keeps ``model_type`` "mfm")."""
        from factorized_tpu_torch.utils.checkpoint import restore_checkpoint

        state, meta = restore_checkpoint(path)
        return cls(MFMConfig.from_dict(meta["config"]), state["params"], **kw)

    @classmethod
    def from_exported(cls, path: str, device=None) -> "ExportedPredictor":
        return ExportedPredictor(path, device)

    def _check_frozen(self):
        if self.params is not self._frozen:
            raise ValueError(
                "Predictor weights are frozen at construction (copied "
                "to the device); build a new Predictor instead of "
                "reassigning .params")

    def _graph(self, B: int) -> Replay:
        """The replay of the forward at batch B, captured at its first use
        (as ``jax.jit`` compiles a shape once)."""
        if B not in self._graphs:
            t, d = self.cfg.seqlength, sum(self.cfg.input_dims)
            self._graphs[B] = Replay(self.forward, (B, t, d), self.device)
        return self._graphs[B]

    def graph_stats(self) -> dict:
        """{batch size: {"capture_ms", "pool_bytes"}} of the graphs held."""
        return {B: {"capture_ms": g.capture_ms, "pool_bytes": g.pool_bytes}
                for B, g in self._graphs.items()}

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
        self._check_frozen()
        if self.device.type != "cuda":
            return self._predict_eager(X)
        with self._lock:
            return self._predict_replayed(X)

    def _predict_eager(self, X):
        outs = []
        B = self.batch_size
        for s in range(0, X.shape[0], B):
            chunk, pad = self._pad_to_batch(X[s:s + B])
            with torch.no_grad():
                y = self.forward(torch.from_numpy(chunk).to(
                    self.device).transpose(0, 1)).numpy()
            outs.append(y[: B - pad] if pad else y)
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    def _predict_replayed(self, X):
        """Each chunk staged into its own slice of a pinned host buffer,
        copied to the graph's input without waiting, replayed, and its
        output copied into its own slice of a pinned output buffer; one
        synchronisation at the end. Slices are not reused within a call,
        so no copy overwrites data still in flight."""
        n, B = X.shape[0], self.batch_size
        chunks = -(-n // B)
        g = self._graph(B)
        xin, yout = self._buffers(B, chunks, g)
        host_in = xin.numpy()
        for i in range(chunks):
            part = X[i * B:(i + 1) * B]
            host_in[i, :part.shape[0]] = part
            host_in[i, part.shape[0]:] = 0.0
            g.x.copy_(xin[i], non_blocking=True)
            g()
            yout[i].copy_(g.y, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return yout.numpy().reshape((chunks * B,) + g.y.shape[1:])[:n].copy()

    def _buffers(self, B, chunks, g):
        """Pinned (chunks, B, t, d) input and (chunks, B, ...) output
        buffers for batch B, grown as needed and kept between calls."""
        have = self._staging.get(B)
        if have is None or have[0].shape[0] < chunks:
            have = (torch.empty((chunks,) + tuple(g.x.shape),
                                dtype=torch.float32, pin_memory=True),
                    torch.empty((chunks,) + tuple(g.y.shape),
                                dtype=torch.float32, pin_memory=True))
            self._staging[B] = have
        return have[0][:chunks], have[1][:chunks]

    def autotune(self, X, candidates=CANDIDATES, reps: int = 3):
        """Pick the serving batch size that maximizes end-to-end
        throughput for ``X``-shaped traffic: for each candidate (skipping
        those past twice the rows, as mostly padding) one capture on the
        card and ``reps`` timed ``predict(X)`` calls; sets
        ``self.batch_size`` to the winner and returns ``{batch_size:
        samples/s}``. Throughput includes the host copies, what a serving
        caller observes. Only the winner's graph and staging buffers are
        kept."""
        X = np.asarray(X, np.float32)
        n = X.shape[0]
        results = {}
        for B in candidates:
            if B > 2 * n and results:
                continue
            self.batch_size = int(B)
            self.predict(X)  # the capture at this batch size, and a warm-up
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                self.predict(X)
                times.append(time.perf_counter() - t0)
            results[int(B)] = float(n / np.median(times))
        self.batch_size = max(results, key=results.get)
        with self._lock:
            for store in (self._graphs, self._staging):
                for B in [B for B in store if B != self.batch_size]:
                    del store[B]
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return results

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

    def device_latency(self, X, iters: int = 100):
        """Per-forward latency without the host copies: ``iters`` replays
        of the padded batch's graph queued back to back (a replay is never
        elided, so they need no data dependency), after one warm replay.
        ``latency_s`` is CUDA events' time over ``iters``,
        ``wall_latency_s`` the host clock's over the same window (the
        queueing included). On the CPU, the eager forward ``iters`` times,
        both by the host clock."""
        X, _ = self._pad_to_batch(np.asarray(X, np.float32)
                                  [: self.batch_size])
        self._check_frozen()
        B = self.batch_size
        if self.device.type != "cuda":
            x = torch.from_numpy(X).transpose(0, 1)
            with torch.no_grad():
                self.forward(x)
                t0 = time.perf_counter()
                for _ in range(iters):
                    self.forward(x)
            wall = device = time.perf_counter() - t0
        else:
            with self._lock:
                g = self._graph(B)
                g.x.copy_(torch.from_numpy(X))
                g()
                torch.cuda.synchronize(self.device)
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                t0 = time.perf_counter()
                start.record()
                for _ in range(iters):
                    g()
                end.record()
                end.synchronize()
                wall = time.perf_counter() - t0
                device = start.elapsed_time(end) / 1e3
        return {
            "batch": int(B),
            "iters": int(iters),
            "latency_s": device / iters,
            "throughput_per_s": float(B * iters / device),
            "wall_latency_s": wall / iters,
        }

    # ------------------------------------------------ AOT export/load

    def export(self, path: str, symbolic_batch: bool = True):
        """Write the ``y_hat`` forward with its packed weights as one
        artifact: ``torch.export`` of the forward module (the two
        recurrences stay the custom ops ``ftt::mfm_encode_eval`` and
        ``ftt::multi_lstm_eval``), saved by ``torch.export.save``, so the
        serving host needs this package's ops and the file, not the model
        code or a checkpoint. The artifact is for this process's device.

        By default the batch dimension is symbolic (``torch.export.Dim``):
        one artifact serves any batch size, and ``ExportedPredictor``
        pads to its ``batch_size`` (meta records this one as the start)
        and can autotune. ``symbolic_batch=False`` pins ``batch_size``
        into the artifact (autotune then refuses).

        Writes ``<path>/exported.pt2`` and ``<path>/meta.json``."""
        t, d = self.cfg.seqlength, sum(self.cfg.input_dims)
        # an example batch of 1 would pin a symbolic batch to 1
        b = max(self.batch_size, 2) if symbolic_batch else self.batch_size
        x = torch.zeros((t, b, d), dtype=torch.float32, device=self.device)
        dynamic = ({"x": {1: torch.export.Dim("batch", min=1)}}
                   if symbolic_batch else None)
        program = torch.export.export(self.forward, (x,),
                                      dynamic_shapes=dynamic)
        os.makedirs(path, exist_ok=True)
        torch.export.save(program, os.path.join(path, "exported.pt2"))
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({
                "config": self.cfg.to_dict(),
                "model_type": self._name,
                "batch_size": int(self.batch_size),
                "symbolic_batch": bool(symbolic_batch),
                "platforms": [self.device.type],
            }, f)
        return path


class ExportedPredictor(Predictor):
    """Serve from a ``Predictor.export`` artifact: the same numpy-in/out
    ``predict`` (padding to ``batch_size``), on the card through the same
    graph per batch size; no checkpoint or parameters needed, only this
    package's ops (``ops/cuda_mfn.py`` and ``ops/cuda_lstm.py``, imported
    with this module, register the custom ops the artifact calls).
    Symbolic-batch artifacts (the export default) serve any batch size,
    so ``autotune`` works; fixed-shape artifacts (``symbolic_batch=False``)
    refuse it. An artifact for another platform than this process's
    device is refused."""

    def __init__(self, path: str, device=None):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        self.device = resolve_device(device)
        self.cfg = MFMConfig.from_dict(meta["config"])
        self._name = meta["model_type"]
        self.batch_size = int(meta["batch_size"])
        self._symbolic = bool(meta.get("symbolic_batch", False))
        self.params = ()  # the weights live inside the artifact
        if self.device.type not in meta["platforms"]:
            raise ValueError(
                f"artifact was exported for {list(meta['platforms'])}, "
                f"this process runs on {self.device.type!r} - re-export on "
                f"the serving platform")
        program = torch.export.load(os.path.join(path, "exported.pt2"))
        self._serve(program.module())

    def autotune(self, *a, **kw):
        if not self._symbolic:
            raise NotImplementedError(
                "this artifact was exported with symbolic_batch=False "
                "(fixed batch shape); re-export with the default "
                "symbolic batch, or run autotune() before export()")
        return super().autotune(*a, **kw)


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
