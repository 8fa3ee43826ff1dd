"""Readings from which a cell's limits are set: over many seeds, the
program's numbers against the float32 reference, and the control's (the
reference in TF32 in the program's place) against the same reference.

    python3 portbench/control.py --workload <cell> --seeds <n> \
        [--first <seed>] [--control-seeds <m>]

runs, in one process, one trial (or bucket) per seed at the cell's own
size through the program, and prints one JSON line per seed: {"seed",
"program": {number: reading}, "control": {number: reading}, "faults":
{fault: {number: reading}}} (the control and the faults on the first
``m`` seeds only, all by default), then the largest program reading and
the smallest control and fault reading of each number (``check.faults``:
the faults planted in the reference). The benchmark's own runs do not
run it; ``portbench/tests/test_bench_control.py`` runs it at a small
size.
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def readings(root, name, seeds, *, require_cuda=True, overrides=None,
             out=None, control_seeds=None):
    """[{"seed", "program", "control", "faults"}] of one trial a seed;
    the control and the faults on the first ``control_seeds`` seeds
    (None: all)."""
    import torch

    from portbench.harness import cell, check, data as mosi, traffic as gen
    from portbench.harness.observe import Observer

    _, entry, config, traffic, _, _, _ = cell.load(root, name)
    overrides = overrides or {}
    config = {**config, **overrides.get("config", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    dev = cell._device(int(entry["chips"]), require_cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from factorized_tpu_torch.config import MFMConfig

    cfg = MFMConfig.from_dict(config)
    K = int(traffic["lanes"])
    rows = []
    obs = Observer()
    obs.install()
    try:
        for n, seed in enumerate(seeds):
            data = mosi.arrays(seed, config["split"], cfg)
            obs.records.clear()
            obs.epochs.clear()
            s = gen.trial_seed(seed, 0)
            obs.pick = check.replay_pick(s, cfg.num_epochs, K)
            trial = gen.run_trial(cfg, config, traffic, data, s, dev)
            args = (config, cfg.model_type, [trial])
            epochs = obs.epochs[:1]
            row = {"seed": seed, "detail": details(config, cfg, trial,
                                                   obs.records[0], data,
                                                   dev, seed, K),
                   "program": check.compare(*args, obs.records[:1], epochs,
                                            data, dev, seed, K)}
            if control_seeds is None or n < control_seeds:
                row["control"] = check.control(*args, epochs, data, dev,
                                               seed, K)
                row["faults"] = check.faults(*args, epochs, data, dev,
                                             seed, K)
            rows.append(row)
            if out is not None:
                print(json.dumps(row), file=out, flush=True)
    finally:
        obs.uninstall()
    return rows


def details(config, cfg, trial, record, data, dev, seed, K):
    """``check.detail`` of the program's, the control's and the half
    batch's first steps against the float32 reference, for the first
    lane that ``check.sample`` draws."""
    from portbench.harness import check
    from portbench.reference import model as ref, steps as rs

    _, lane = check.sample(seed, 1, K)[0]
    kw = dict(lr=cfg.lr, lanes=K, lane=lane)
    args = (config, cfg.model_type, trial["seed"], data, dev)
    refr = rs.first_steps(*args, ref.Numerics(False), **kw)
    return {"lane": lane,
            "program": check.detail(check.program_steps(record, lane), refr),
            "control": check.detail(rs.first_steps(
                *args, ref.Numerics(True), **kw), refr),
            "half": check.detail(rs.first_steps(
                *args, ref.Numerics(False), half=True, **kw), refr)}


def main(argv):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first", type=int, default=20_000_000_001)
    p.add_argument("--control-seeds", type=int, default=None)
    args = p.parse_args(argv)
    rows = readings(ROOT, args.workload,
                    range(args.first, args.first + args.seeds),
                    out=sys.stdout, control_seeds=args.control_seeds)
    low = [r for r in rows if "control" in r]
    summary = {k: {"program_max": max(r["program"][k] for r in rows),
                   "control_min": min(r["control"][k] for r in low),
                   **{f"{f}_min": min(r["faults"][f][k] for r in low)
                      for f in low[0]["faults"] if k in low[0]["faults"][f]}}
               for k in low[0]["control"]}
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "seconds": time.perf_counter() - T_START}))


if __name__ == "__main__":
    main(sys.argv[1:])
