"""The comparison that decides ``correct``.

For a sample of the window's trials, drawn from the run's seed (over K
lanes, a bucket and some of its lanes), the reference recomputes:

- the trial's first three train steps from the same seed (the initial
  weights, the batches and the draws worked out again): ``step1_loss``,
  the relative gap of the first step's label loss; ``grad1_leaf``, the
  worst leaf's gap between the norms of the program's first gradient
  (Adam's first moment after one step over 1 - b1) and the reference's;
  ``change3_median``, the median leaf's gap between the norms of the
  parameters' change over the three steps. A leaf's gap is measured
  against the larger of its own reference norm and the median leaf's; a
  leaf whose first reference gradient is under a thousandth of the
  median leaf's moves by rounding alone under Adam and is left out of the
  change; ``change3_leaf``, the worst leaf's gap of that change. (The
  later steps' loss and the worst leaf's change swing from seed to seed:
  a unit whose pre-activation lies within rounding of a ReLU's kink
  after the first update flips on one side, and moves one leaf and the
  next steps' loss by far more than rounding; a cell compares
  ``change3_leaf`` only where the control reads well above that.)
- one whole epoch of the first sampled trial, drawn from its seed among
  the epochs after the first (on the card, replays of the captured
  graph), from the state the program held at its start (its parameters,
  Adam's moments, count and lr, the generator's state: the reference can
  only follow the program there from the program's own state; the start
  is what the first steps check): ``replay_loss``, the relative gap of
  the epoch's mean label loss; ``replay_change_median`` and
  ``replay_change_leaf``, the median and the worst leaf's gap of the
  parameters' change over the epoch; ``replay_valid``, the relative gap
  between the epoch's validation loss and the reference's of the
  parameters the epoch left.
- ``valid_loss``: the relative gap between the best validation loss the
  trial kept and the reference's validation loss of the parameters the
  trial returned (its eval, its keeper);
- ``test_mae``: the relative gap between the trial's test MAE and the
  reference's MAE of the returned parameters (its predict, its score);
- ``schedule``: epochs whose learning rate differs from the plateau
  schedule replayed from the trial's validation losses, plus one where
  the kept best is not the least validation loss (exact: limit 0).

``control`` gives the same numbers with the reference in TF32 put in
the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model as ref
from portbench.reference import steps as rs

NAMES = ("step1_loss", "grad1_leaf", "change3_median", "change3_leaf",
         "replay_loss", "replay_change_median", "replay_change_leaf",
         "replay_valid", "valid_loss", "test_mae", "schedule")
STEP_NAMES = NAMES[:4]
REPLAY_NAMES = NAMES[4:8]
EVAL_NAMES = NAMES[8:10]
B1 = 0.9


def sample(seed, trials, lanes, n_trials=2, n_lanes=3):
    """[(trial index, lane)] to compare, drawn from ``seed``: up to
    ``n_trials`` trials of one lane, or one bucket and ``n_lanes`` of its
    lanes."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 7]))
    if lanes == 1:
        idx = rng.choice(trials, size=min(n_trials, trials), replace=False)
        return [(int(i), 0) for i in sorted(idx)]
    i = int(rng.integers(trials))
    ks = rng.choice(lanes, size=min(n_lanes, lanes), replace=False)
    return [(i, int(k)) for k in sorted(ks)]


def leaf_gaps(prog, refr, keep=None):
    """Each leaf's |norm(prog) - norm(ref)| over the larger of the leaf's
    reference norm and the median leaf's."""
    names = [k for k in refr if keep is None or k in keep]
    rn = {k: float(torch.linalg.vector_norm(refr[k].double())) for k in names}
    med = float(np.median(list(rn.values())))
    return {k: abs(float(torch.linalg.vector_norm(prog[k].double())) - rn[k])
            / max(rn[k], med, 1e-30) for k in names}


def leaf_gap(prog, refr, keep=None):
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(prog, refr, keep).values())


def moving_leaves(grad1):
    """The leaves whose first reference gradient is at least a thousandth
    of the median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(g.double()))
             for k, g in grad1.items()}
    med = float(np.median(list(norms.values())))
    return {k for k, n in norms.items() if n >= 1e-3 * med}


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def step_numbers(prog, refr):
    """step1_loss, grad1_leaf and change3_median of ``prog`` (a dict like
    ``steps.first_steps``'s) against ``refr``."""
    keep = moving_leaves(refr["grad1"])
    change = leaf_gaps(prog["change"], refr["change"], keep)
    return {"step1_loss": _rel(prog["losses"][0], refr["losses"][0]),
            "grad1_leaf": leaf_gap(prog["grad1"], refr["grad1"]),
            "change3_median": float(np.median(list(change.values()))),
            "change3_leaf": max(change.values())}


def replay_numbers(prog, refr, valid):
    """replay_loss, replay_change_median and replay_change_leaf of
    ``prog`` (``program_replay``'s) against ``refr``
    (``steps.replay_epoch``'s), and replay_valid of the epoch's
    validation loss against ``valid``, the reference's of the parameters
    the epoch left."""
    keep = moving_leaves(refr["grad1"])
    change = leaf_gaps(prog["change"], refr["change"], keep)
    return {"replay_loss": _rel(prog["loss"], refr["loss"]),
            "replay_change_median": float(np.median(list(change.values()))),
            "replay_change_leaf": max(change.values()),
            "replay_valid": _rel(prog["valid"], valid)}


def detail(prog, refr):
    """What ``step_numbers`` reads, taken apart: each step's loss gap, the
    worst leaves, the median leaf's gap and the whole vector's."""
    keep = moving_leaves(refr["grad1"])
    out = {"step_gaps": [_rel(p, r) for p, r in
                         zip(prog["losses"], refr["losses"])]}
    for key, kept in (("grad1", None), ("change", keep)):
        gaps = leaf_gaps(prog[key], refr[key], kept)
        names = sorted(gaps, key=lambda k: -gaps[k])[:3]
        out[f"{key}_worst"] = [[k, gaps[k], float(torch.linalg.vector_norm(
            refr[key][k].double()))] for k in names]
        out[f"{key}_median"] = float(np.median(list(gaps.values())))

        def whole(t):
            return float(torch.linalg.vector_norm(torch.cat(
                [t[k].double().reshape(-1) for k in gaps])))

        out[f"{key}_total"] = _rel(whole(prog[key]), whole(refr[key]))
    return out


def program_steps(record, lane):
    """The program's first steps from its ``observe.StepRecord``."""
    k = None if record.lanes is None else lane
    losses = [float(x if k is None else x[k]) for x in record.losses]
    grad1 = record.split(record.mu1 / (1.0 - B1), k)
    change = record.split(record.last - record.init, k)
    return {"losses": losses, "grad1": grad1, "change": change}


def program_replay(record):
    """The program's picked epoch from its ``observe.EpochRecord``: the
    epoch's tracked loss and validation loss from its records row, the
    parameters' change over it and the parameters it left."""
    row = record.row.detach().cpu().double()
    if record.lanes is not None:
        row = row[:, record.lane]
    start, end = record.split(record.start[0]), record.split(record.end[0])
    return {"loss": float(row[0]), "valid": float(row[1]), "end": end,
            "change": {k: end[k] - start[k] for k in end}}


def reference_replay(cfg, model, record, seed, data, device, num, lanes,
                     half=False):
    """``steps.replay_epoch`` from the start of the program's picked
    epoch."""
    start = {key: record.split(record.start[j])
             for j, key in enumerate(("flat", "mu", "nu"))}
    return rs.replay_epoch(cfg, model, seed, data, device, num, start=start,
                           count=int(record.count), lr=float(record.lr),
                           gen_state=record.gen_state, lanes=lanes,
                           lane=record.lane, half=half)


def valid_mae(cfg, model, flat, data, device, num):
    """The validation loss (MAE) of parameters {leaf: tensor}."""
    y = rs.eval_y(cfg, model, rs.nest(flat), data[2], device, num)
    return float(np.mean(np.abs(y.astype(np.float64) - data[3])))


def replay_pick(seed, epochs, lanes):
    """(epoch, lane) of a trial seeded ``seed`` whose epoch the check
    follows: one of the epochs after the first (on the card, a replay)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 11]))
    return int(rng.integers(1, max(2, epochs))), int(rng.integers(lanes))


def eval_numbers(cfg, model, trial, data, device, num, y_ref=None):
    """valid_loss and test_mae of one lane's ``trial`` (a dict of
    ``traffic.lane_results``) against ``num``'s eval of its parameters;
    ``y_ref`` the float32 reference's (valid, test) y_hat where ``num``
    stands in for the program (the control)."""
    _, _, X_valid, y_valid, X_test, y_test = data
    yv = rs.eval_y(cfg, model, trial["params"], X_valid, device, num)
    yt = rs.eval_y(cfg, model, trial["params"], X_test, device, num)
    if y_ref is None:
        best, mae = trial["best_valid"], trial["mae"]
    else:
        best = np.mean(np.abs(y_ref[0] - y_valid))
        mae = np.mean(np.abs(y_ref[1] - y_test))
    return ({"valid_loss": _rel(best, np.mean(np.abs(yv.astype(np.float64)
                                                     - y_valid))),
             "test_mae": _rel(mae, np.mean(np.abs(yt.astype(np.float64)
                                                  - y_test)))},
            (yv, yt))


def schedule_mismatches(trial, lr):
    """Epochs whose lr is not the replayed plateau schedule's, plus one
    where the kept best is not the least validation loss."""
    valids = trial["valids"]
    want = rs.plateau_lrs(valids, lr)
    bad = sum(np.float32(a) != np.float32(b)
              for a, b in zip(trial["lrs"], want))
    least = np.float32(min(valids)) if valids else np.float32(np.inf)
    return int(bad) + int(np.float32(trial["best_valid"]) != least)


def compare(cfg, model, trials, records, epochs, data, device, seed,
            lanes):
    """Every number of ``NAMES`` over the sample: the worst reading."""
    num = ref.Numerics(tf32=False)
    out = dict.fromkeys(NAMES, 0.0)
    picked = sample(seed, len(trials), lanes)
    i = picked[0][0]
    prog = program_replay(epochs[i])
    refr = reference_replay(cfg, model, epochs[i], trials[i]["seed"], data,
                            device, num, lanes)
    out.update(replay_numbers(prog, refr, valid_mae(cfg, model, prog["end"],
                                                    data, device, num)))
    for i, lane in picked:
        trial = trials[i]["lanes"][lane]
        refr = rs.first_steps(cfg, model, trials[i]["seed"], data, device,
                              num, lr=cfg["lr"], lanes=lanes, lane=lane)
        got = step_numbers(program_steps(records[i], lane), refr)
        got.update(eval_numbers(cfg, model, trial, data, device, num)[0])
        got["schedule"] = schedule_mismatches(trial, cfg["lr"])
        for k, v in got.items():
            out[k] = max(out[k], v)
    return out


def faults(cfg, model, trials, epochs, data, device, seed, lanes):
    """The numbers of faults planted in the float32 reference put in the
    program's place: ``half`` (each step on half its batch, the mean
    over the rest), ``unchanged`` (the picked epoch leaves the state as
    it found it) and ``answer`` (one validation and one test answer
    altered by 1 where the predict produces them). A state left unchanged
    in the first steps reads 1 on ``grad1_leaf`` and ``change3_median``
    by their measure."""
    num = ref.Numerics(False)
    out = {"half": dict.fromkeys(STEP_NAMES + REPLAY_NAMES[:3], 0.0),
           "unchanged": dict.fromkeys(REPLAY_NAMES[1:3], 0.0),
           "answer": dict.fromkeys(EVAL_NAMES, 0.0)}
    _, _, X_valid, y_valid, X_test, y_test = data
    picked = sample(seed, len(trials), lanes)
    i = picked[0][0]
    args = (cfg, model, epochs[i], trials[i]["seed"], data, device, num,
            lanes)
    full = reference_replay(*args)
    half = reference_replay(*args, half=True)
    out["half"].update({k: v for k, v in replay_numbers(
        {**half, "valid": 0.0}, full, 0.0).items() if k in out["half"]})
    still = {"loss": full["loss"], "valid": 0.0,
             "change": {k: torch.zeros_like(v)
                        for k, v in full["change"].items()}}
    out["unchanged"].update({k: v for k, v in replay_numbers(
        still, full, 0.0).items() if k in out["unchanged"]})
    for i, lane in picked:
        trial = trials[i]["lanes"][lane]
        kw = dict(lr=cfg["lr"], lanes=lanes, lane=lane)
        refr = rs.first_steps(cfg, model, trials[i]["seed"], data, device,
                              num, **kw)
        half = rs.first_steps(cfg, model, trials[i]["seed"], data, device,
                              num, half=True, **kw)
        _, (yv, yt) = eval_numbers(cfg, model, trial, data, device, num)
        got = dict(step_numbers(half, refr))
        altered = {}
        for key, y, truth in (("valid_loss", yv, y_valid),
                              ("test_mae", yt, y_test)):
            y = y.astype(np.float64)
            bad = y.copy()
            bad[0] += 1.0
            altered[key] = _rel(np.mean(np.abs(bad - truth)),
                                np.mean(np.abs(y - truth)))
        for k, v in got.items():
            out["half"][k] = max(out["half"][k], v)
        for k, v in altered.items():
            out["answer"][k] = max(out["answer"][k], v)
    return out


def control(cfg, model, trials, epochs, data, device, seed, lanes):
    """The numbers of ``compare`` with the TF32 reference in the
    program's place, against the float32 reference."""
    f32, tf32 = ref.Numerics(False), ref.Numerics(True)
    out = dict.fromkeys(NAMES[:-1], 0.0)
    picked = sample(seed, len(trials), lanes)
    i = picked[0][0]
    args = (cfg, model, epochs[i], trials[i]["seed"], data, device)
    full, low = reference_replay(*args, f32, lanes), reference_replay(
        *args, tf32, lanes)
    low_valid = valid_mae(cfg, model, low["end"], data, device, tf32)
    out.update(replay_numbers(
        {**low, "valid": low_valid}, full,
        valid_mae(cfg, model, low["end"], data, device, f32)))
    for i, lane in picked:
        trial = trials[i]["lanes"][lane]
        kw = dict(lr=cfg["lr"], lanes=lanes, lane=lane)
        refr = rs.first_steps(cfg, model, trials[i]["seed"], data, device,
                              f32, **kw)
        low = rs.first_steps(cfg, model, trials[i]["seed"], data, device,
                             tf32, **kw)
        got = step_numbers(low, refr)
        _, y32 = eval_numbers(cfg, model, trial, data, device, f32)
        got.update(eval_numbers(cfg, model, trial, data, device, tf32,
                                y_ref=y32)[0])
        for k, v in got.items():
            out[k] = max(out[k], v)
    return out
