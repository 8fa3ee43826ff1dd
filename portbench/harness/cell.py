"""One run of one cell: set-up, the measured window of trials, the check,
the metrics and the result line.

Everything that belongs to one cell is found by name: the cell's entry
in ``BENCHMARK.json`` names its configuration (a file of sizes) and its
traffic (``portbench/traffic/<traffic>.json``); its limits are
``portbench/limits/<cell>.json``, one for each number the cell compares
(``check.NAMES``); each per-layer metric is a reader,
``portbench/metrics/<metric>.py``, whose ``read(ctx)`` returns a number
or None (nothing to read: the metric is left out of the line).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

from portbench.harness import check, data as mosi, traffic as gen
from portbench.harness.observe import Observer, check_observed

FORBIDDEN = ("jax", "jaxlib", "flax", "factorized_tpu")


class NoDevice(RuntimeError):
    """The run has no card, or fewer than the cell asks for."""


def load(root: Path, name: str):
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` with what its
    names point to: (bench, cell, config dict, traffic dict, limits,
    end-to-end metric entries, per-layer metric entries)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; "
                         f"known: {sorted(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    here = root / "portbench"
    traffic = json.loads((here / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    limits = json.loads((here / "limits" / f"{name}.json").read_text())

    def mine(m):
        return name in m.get("workloads", [name])

    return (bench, cell, config, traffic, limits,
            [m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


def reader(root: Path, metric: str):
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _device(chips, require_cuda):
    import torch

    if not require_cuda:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false: this benchmark "
                       "runs on a CUDA card only")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards, "
                       f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def run(root: Path, name: str, seed: int, seconds: float, trace: bool,
        t_start: float, require_cuda: bool = True, overrides=None):
    """One run: the result line's dict and the compared numbers' lines.
    ``overrides`` (tests, on the CPU): {"config": keys, "traffic": keys}
    replacing the files'."""
    import torch

    bench, cell, config, traffic, limits, e2e, per_layer = load(root, name)
    seed = int(seed) % 2**64
    overrides = overrides or {}
    config = {**config, **overrides.get("config", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    dev = _device(int(cell["chips"]), require_cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from factorized_tpu_torch.config import MFMConfig
    from factorized_tpu_torch.ops import counts

    cfg = MFMConfig.from_dict(config)
    phases = {"import_s": time.perf_counter() - t_start}
    unknown = set(limits) - set(check.NAMES)
    if unknown:
        raise SystemExit(f"limits for unknown numbers {sorted(unknown)}")
    split = config["split"]
    data = mosi.arrays(seed, split, cfg)
    K = int(traffic["lanes"])
    phases["data_s"] = time.perf_counter() - t_start - phases["import_s"]
    obs = Observer()
    obs.install()
    try:
        gen.run_trial(cfg.replace(num_epochs=int(traffic["warmup_epochs"])),
                      config, traffic, data, gen.trial_seed(seed, 0, warmup=True), dev)
        _sync(dev)
        for span, a, b, _ in obs.spans:
            key = f"warmup.{span}_s"
            phases[key] = phases.get(key, 0.0) + (b - a)
        obs.spans.clear()
        obs.records.clear()
        obs.epochs.clear()

        t0 = time.perf_counter()
        phases["warmup_s"] = t0 - t_start - phases["import_s"] - phases[
            "data_s"]
        before = counts.snapshot()
        trials, records = [], []
        while not trials or time.perf_counter() - t0 < seconds:
            s = gen.trial_seed(seed, len(trials))
            n_rec = len(obs.records)
            obs.pick = check.replay_pick(s, cfg.num_epochs, K)
            with obs.span("trial", index=len(trials)):
                trials.append(gen.run_trial(cfg, config, traffic, data, s,
                                            dev))
            records.append(obs.records[n_rec] if len(obs.records) > n_rec
                           else None)
        t1 = time.perf_counter()
        launches = counts.since(before)
        window_spans = list(obs.spans)
        epochs_seen = list(obs.epochs)
        check_observed(obs, trials, records, epochs_seen, K,
                       dev.type == "cuda")

        traced = None
        if trace:
            traced = _traced_trial(obs, cfg, config, traffic, data,
                                   gen.trial_seed(seed, len(trials)), dev)
            phases.update(traced[2])
    finally:
        obs.uninstall()

    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    for rec in obs.records[len(records):]:
        rec.init = rec.mu1 = rec.last = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    numbers = check.compare(config, cfg.model_type, trials, records,
                            epochs_seen, data, dev, seed, K)
    phases["check_s"] = time.perf_counter() - t_check
    correct = all(numbers[k] <= limits[k] for k in limits)

    nb = split["n_train"] // cfg.batchsize
    epochs = sum(t["lanes"][0]["epochs"] for t in trials)
    lane_count = sum(len(t["lanes"]) for t in trials)
    failed = sum(lane["diverged"] for t in trials for lane in t["lanes"])
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    peaks = json.loads((root / "portbench" / "peaks.json").read_text())
    ctx = SimpleNamespace(
        config=config, traffic=traffic, split=split, lanes=K, batch=cfg.batchsize,
        batches=nb, trials=len(trials), epochs=epochs, steps=epochs * nb,
        samples=K * epochs * nb * cfg.batchsize, window_s=t1 - t0,
        spans=window_spans, launches=launches,
        peaks=peaks.get(kind), trace=traced and traced[0],
        traced=traced and traced[1])

    if trace:
        metrics = {}
        for m in per_layer:
            value = reader(root, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {
            "train_samples_per_s": {"value": ctx.samples / ctx.window_s,
                                    "unit": "samples/s"},
            "setup_s": {"value": t0 - t_start, "unit": "s"}}
        metrics = {m["name"]: metrics[m["name"]] for m in e2e}

    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        raise RuntimeError(f"the process holds {found} after the window")

    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": kind, "count": int(cell["chips"]),
              "memory_peak_bytes": int(peak),
              "power_limit_w": _power_limit() if dev.type == "cuda"
              else None}
    if trace:
        device["busy_s"] = ctx.trace.busy_s
        device["window_s"] = ctx.trace.window_s
    compared = {k: {"value": numbers[k], "limit": limits[k]}
                for k in check.NAMES if k in limits}
    result = {"correct": bool(correct), "attempted": lane_count,
              "failed": int(failed), "metrics": metrics, "device": device}
    if trace:
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    result["compared"] = compared
    lines = [" ".join(f"{k} {v:.6g}" for k, v in phases.items())]
    lines += [f"compared {k}: {v['value']!r} limit {v['limit']!r}"
              for k, v in compared.items()]
    return result, lines


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _traced_trial(obs, cfg, config, traffic, data, seed, dev):
    """One more trial after the window, under ``torch.profiler``: (its
    ``trace.Trace``, its counts: steps, epochs, trials)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench.harness.trace import Trace

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        obs.profiling = True
        try:
            with obs.span("trial", index="traced"):
                out = gen.run_trial(cfg, config, traffic, data, seed, dev)
            _sync(dev)
        finally:
            obs.profiling = False
    t1 = time.perf_counter()
    tr = Trace.from_profiler(prof)
    epochs = out["lanes"][0]["epochs"]
    nb = config["split"]["n_train"] // cfg.batchsize
    return tr, {"steps": epochs * nb, "epochs": epochs, "trials": 1}, {
        "traced_s": t1 - t0, "trace_read_s": time.perf_counter() - t1,
        "trace_ops": len(tr.ops)}


def print_result(result, lines):
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()


def main(argv, t_start):
    import argparse

    p = argparse.ArgumentParser(description="One run of one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path(__file__).resolve().parents[2]
    try:
        result, lines = run(root, args.workload, args.seed, args.seconds,
                            bool(args.trace), t_start)
    except NoDevice as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    print_result(result, lines)
    return 0

