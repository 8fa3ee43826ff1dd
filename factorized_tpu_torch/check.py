"""Results aggregation — the rebuild of the reference's ``check.py``
log scraper (the port's own copy of ``factorized_tpu/check.py``, which
imports nothing of JAX; the port keeps its own copy of such a module).

Two sources:
- JSONL run records written by :class:`factorized_tpu_torch.utils.
  logging.RunLogger` (the native path; multi-seed runs store their
  ``per_seed`` metrics in the ``final`` record, ``multitrait`` its
  per-trait lists);
- legacy stdout ``.txt`` logs in the reference's printed format
  (``check.py:174-189`` regex semantics: ``Accuracy`` lines,
  ``weighted avg`` report rows, ``mae``/``corr:``/``mult_acc`` lines,
  and the missing-modality ``scoring y_hat_no*`` sections /
  ``{all present,l,a,v} missing`` reconstruction-MSE lines,
  ``check.py:43-110``).

Per run the best values are reported (max for acc/fscore/corr/mult_acc,
min for mae), exactly like the reference.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np


def _best(metrics):
    out = {}
    agg = {
        "acc": max, "fscore": max, "corr": max, "mult_acc": max,
        "mae": min,
    }
    for k, fn in agg.items():
        vals = [v for v in metrics.get(k, []) if v == v]  # drop NaN
        if vals:
            out[k] = fn(vals)
    return out


def parse_text_log(path, condition=None):
    """Scrape one reference-format stdout log. ``condition`` filters a
    missing-modality section ('l'|'a'|'v'|None), mirroring the ``ttt``/
    ``add`` machinery at ``check.py:57-71``. The per-file run counter
    (``_runs``) counts config lines like the reference's ``tot`` counter
    over ``OrderedDict`` lines (``check.py:175-177,190``)."""
    metrics = defaultdict(list)
    recon = defaultdict(list)
    add = condition is None
    with open(path, errors="replace") as f:
        for line in f:
            if "OrderedDict" in line or line.startswith("[{'"):
                metrics["_runs"].append(1.0)
            for tag in ("all present", "l missing", "a missing", "v missing"):
                if line.startswith(tag):
                    try:
                        recon[tag].append(
                            [float(x) for x in line.split()[2:]]
                        )
                    except ValueError:
                        pass
            if condition is not None:
                if f"scoring y_hat_no{condition}" in line:
                    add = True
                elif "scoring y_hat_no" in line:
                    add = False
            if not add:
                continue
            parts = line.split()
            if "Accuracy" in line and len(parts) >= 2:
                try:
                    metrics["acc"].append(float(parts[1]))
                except ValueError:
                    pass
            if "avg" in line and "total" in line and len(parts) >= 6:
                try:
                    metrics["fscore"].append(float(parts[5]))
                except ValueError:
                    pass
            if "weighted avg" in line and len(parts) >= 5:
                try:
                    metrics["fscore"].append(float(parts[4]))
                except ValueError:
                    pass
            if "mae" in line and len(parts) == 2:
                try:
                    metrics["mae"].append(float(parts[1]))
                except ValueError:
                    pass
            if "corr:" in line and len(parts) >= 2:
                try:
                    metrics["corr"].append(float(parts[1]))
                except ValueError:
                    pass
            if "mult_acc" in line and len(parts) >= 2:
                try:
                    metrics["mult_acc"].append(float(parts[1]))
                except ValueError:
                    pass
    return metrics, recon


def parse_jsonl(path, condition=None):
    """Collect metrics from a RunLogger JSONL file. Values from EVERY
    per-condition sub-dict are collected (best-over-conditions like the
    reference's unfiltered text scrape); ``condition`` ('l'|'a'|'v')
    restricts to that missing-modality section's sub-dicts."""
    metrics = defaultdict(list)
    # fscore maps to the BINARY weighted F1 to match what the text
    # scrape extracts from the classification report's 'weighted avg'
    # row (check.py:182-183); the 7-class rounded F1 gets its own key
    key_map = {
        "mae": "mae", "corr": "corr", "mult_acc": "mult_acc",
        "mult_f_score": "mult_fscore", "binary_accuracy": "acc",
        "binary_f1": "fscore", "accuracy": "acc", "f1_weighted": "fscore",
    }

    def collect(d):
        for k, v in d.items():
            if k in key_map and isinstance(v, (int, float)):
                metrics[key_map[k]].append(v)

    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("kind") == "config":
                metrics["_runs"].append(1.0)
            if rec.get("kind") != "final":
                continue
            scalars = {k: v for k, v in rec.items()
                       if not isinstance(v, (dict, list))}
            if condition is None:
                collect(scalars)
            for k, v in rec.items():
                if isinstance(v, dict):
                    if condition is not None and k != f"y_hat_no{condition}":
                        continue
                    collect(v)
                elif isinstance(v, list) and condition is None:
                    # multiseed runs store per_seed=[{...}, ...]
                    for item in v:
                        if isinstance(item, dict):
                            collect(item)
    return metrics


def check_dir(directory, condition=None, out=print):
    """Aggregate every .jsonl/.txt log under ``directory``; print
    per-file bests (reference format) and return a summary dict."""
    summary = {}
    files = sorted(os.listdir(directory))
    all_recon = defaultdict(list)
    for name in files:
        path = os.path.join(directory, name)
        if name.endswith(".jsonl"):
            metrics = parse_jsonl(path, condition)
            recon = {}
        elif name.endswith(".txt") or name.endswith(".log"):
            metrics, recon = parse_text_log(path, condition)
        else:
            continue
        best = _best(metrics)
        if not best and not recon:
            continue
        n_runs = len(metrics.get("_runs", []))
        if n_runs:
            best["_runs"] = n_runs
        summary[name] = best
        # reference prints `file2 tot` — filename + per-file run count
        # (``check.py:190``)
        out(name, n_runs)
        for k in ("acc", "fscore", "mae", "corr", "mult_acc"):
            if k in best:
                out(f"{k}: {best[k]}")
        out("")
        for tag, rows in recon.items():
            all_recon[tag].extend(rows)
    # missing-modality aggregation: min over runs per condition
    # (check.py:99-110)
    for tag, rows in all_recon.items():
        if not rows:
            continue
        # a run killed mid-print can leave a short row; keep only rows
        # of the most common length rather than crashing aggregation
        lengths = [len(r) for r in rows]
        want = max(set(lengths), key=lengths.count)
        arr = np.asarray([r for r in rows if len(r) == want])
        if arr.size:
            out(tag, np.min(arr, axis=0))
            summary.setdefault("_recon_min", {})[tag] = np.min(
                arr, axis=0).tolist()
    return summary


def parse_text_log_multitrait(path):
    """Multi-trait logs (the reference's POM/IEMOCAP modes,
    ``check.py:128-164``): metric lines carry bracketed per-trait lists
    like ``mae: [0.9, 1.1, ...]``. Returns per-metric arrays
    (n_records, n_traits)."""
    rows = {"mae": [], "corr": [], "mult_acc": []}
    with open(path, errors="replace") as f:
        for line in f:
            for key in rows:
                tag = f"{key}:"
                if tag in line and "[" in line and "]" in line and (
                        key != "mae" or "test" not in line):
                    try:
                        vals = [float(x) for x in
                                line[line.index("[") + 1:
                                     line.index("]")].split(",")]
                        rows[key].append(vals)
                    except ValueError:
                        pass
    return {k: np.asarray(v) for k, v in rows.items() if v}


def parse_jsonl_multitrait(path):
    """Multi-trait metrics from RunLogger JSONL: 'final' records whose
    mae/corr/mult_acc values are per-trait LISTS."""
    rows = {"mae": [], "corr": [], "mult_acc": []}
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("kind") != "final":
                continue
            for k in rows:
                v = rec.get(k)
                if isinstance(v, list) and v:
                    rows[k].append([float(x) for x in v])
    return {k: np.asarray(v) for k, v in rows.items() if v}


# POM logs carry 17 per-trait columns; the reference reports only these
# indices (trait 14 is dropped, ``check.py:241``)
_POM_WANT = list(range(14)) + [15, 16]


def _multitrait_files(directory):
    for name in sorted(os.listdir(directory)):
        path = os.path.join(directory, name)
        if name.endswith(".jsonl"):
            yield name, parse_jsonl_multitrait(path)
        elif name.endswith(".txt") or name.endswith(".log"):
            yield name, parse_text_log_multitrait(path)


def _pom_rows(agg, out, want=None):
    """The reference's POM print block (``check.py:230-250``): min-mae /
    max-corr rows, plus an 'acc' row = max mult_acc per trait x100."""
    result = {}
    for k, label, fn in (("mae", "mae", np.nanmin),
                         ("corr", "corr", np.nanmax),
                         ("mult_acc", "acc", np.nanmax)):
        if k not in agg:
            continue
        stacked = np.concatenate(agg[k], axis=0)
        best = fn(stacked, axis=0)
        idx = want
        if idx is None or max(idx) >= best.shape[0]:
            idx = range(best.shape[0])
        vals = [float(best[i]) for i in idx]
        if label == "acc":
            # reference scales mult_acc x100 in the POM acc row
            # (``check.py:247``: round(x,3)*100.0)
            out("acc:", "&".join(str(round(v, 3) * 100.0) for v in vals))
        else:
            out(f"{label}:", "&".join(str(round(v, 3)) for v in vals))
        result[label] = vals
    return result


def best_multitrait(directory, out=print, style=None):
    """Per-trait bests across a directory of multi-trait logs:
    min mae / max corr / max mult_acc per trait (``check.py:150-159``).
    Reads both reference-format .txt logs and our JSONL records.

    ``style`` selects the reference's aggregation mode:
    - ``None`` (default): directory-wide bests, one row per metric —
      the generic surface.
    - ``'pom'``: directory-wide accumulation with the reference's POM
      report (``check.py:230-250``): mae/corr rows plus a per-trait
      ``acc`` row (max mult_acc x100); when logs carry 17 POM traits
      only the reference's 16 ``want`` indices are printed (trait 14
      dropped, ``check.py:241``).
    - ``'ie2'``: accumulators RESET PER FILE (``check.py:122-127``) —
      each log gets its own mae/corr rows over its first 3 traits;
      returns ``{filename: rows}``.
    """
    if style == "ie2":
        result = {}
        for name, rows in _multitrait_files(directory):
            if not rows:
                continue
            out(name, sum(len(a) for a in rows.values()))
            per = {}
            for k, label, fn in (("mae", "mae", np.nanmin),
                                 ("corr", "corr", np.nanmax)):
                if k not in rows:
                    continue
                best = fn(rows[k], axis=0)[:3]  # want=[0,1,2]
                out(f"{label}:",
                    "&".join(str(round(float(v), 3)) for v in best))
                per[label] = [float(v) for v in best]
            out("")
            result[name] = per
        return result

    agg = {}
    n_traits = 0
    for name, rows in _multitrait_files(directory):
        if rows and style == "pom":
            out(name, sum(len(a) for a in rows.values()))
        for k, arr in rows.items():
            agg.setdefault(k, []).append(arr)
            n_traits = max(n_traits, arr.shape[1])
    if style == "pom":
        return _pom_rows(agg, out,
                         want=_POM_WANT if n_traits == 17 else None)
    result = {}
    for k, arrs in agg.items():
        stacked = np.concatenate(arrs, axis=0)
        fn = np.nanmin if k == "mae" else np.nanmax
        result[k] = fn(stacked, axis=0).tolist()
        out(f"{k}:", "&".join(str(round(x, 3)) for x in result[k]))
    return result
