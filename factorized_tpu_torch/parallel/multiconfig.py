"""Shape-bucketed and evolving searches: many search trials trained as
lanes of one program (port of
``factorized_tpu/parallel/multiconfig.py``, ``--bucket``, ``--evolve``
and ``--cull-frac``).

The reference's production workload is an endless random search of
small models (``mfm_mosi.py:1302-1369``), one model at a time. Most of
what a trial draws does not change the program: the nine dropout rates,
``out_drop``, the four loss weights (``HP_FIELDS``) and the lr are
values; only the size fields (``SHAPE_FIELDS``) change its shapes. So
the drawn configs are grouped by ``shape_signature`` and each group
trains as K = configs x seeds lanes of the lane programs of
``parallel/multiseed.py``: the step runs under ``torch.func.vmap``, lane
k's loss built from ``lane_cfg(rep, hp[k])`` with its row of a ``(K,
n_hp)`` matrix of values (a tensor rate runs its dropout site,
``ops.core.dropout``), each kernel launching once a pass for all the
lanes, Adam one lr and one step count a lane
(``train.LaneAdam``). The evaluation and the test predict run on the
representative config, as the JAX package's ``make_eval_fn(apply_fn,
rep_cfg)``: in eval mode no value field is read.

``train_evolving_search`` is successive halving over one shape: after
each rung of ``num_epochs`` it ranks the configs by their best
validation number, test-scores the lanes that finish (``score_bucket_
lanes``) and re-draws the worst ``cull_frac`` of the configs in place
(``resample_values``, ``recycle_lanes``): new values, parameters and
Adam state, lr, scheduler and best record, written into the buffers of
the one ``LaneLoop`` that every rung runs, so one CUDA graph capture
serves the whole search (a rung's later epochs are replays). A recycled
lane's parameters come from a generator seeded ``_run_seed(seed + 1000 *
(rung + 1), lane)``, the counterpart of the JAX package's
``fold_in(PRNGKey(seed + 1000 * (rung + 1)), lane)``; each rung's draws
from the program's generator seeded ``_run_seed(seed, key_salt)``, with
``key_salt`` 777 + rung. The graph registers that generator
(``train.Graphed``); ``torch.Generator.manual_seed`` between two replays
sets the seed and offset that the next replay reads, which
``chip_smoke.py`` step 21 checks on the card. A snapshot at a rung
boundary (``_evolve_snapshot``) resumes to the uninterrupted run bit for
bit.

Across ranks (``mesh=``): as ``parallel/multiseed.py``'s lanes, each
rank trains its share of the K lanes (a ``"batch"`` axis splits each
lane group's batch too), lane k initialised and drawing as in one
process; records, scores and parameters are gathered, every rank
returns the whole result and rank 0 alone writes the logs and
snapshots. A culled lane is recycled by the rank that holds it.
"""

from __future__ import annotations

import math
import random
from collections import defaultdict
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from factorized_tpu_torch import resolve_device
from factorized_tpu_torch.config import MFMConfig, sample_search_config
from factorized_tpu_torch.models import get_model
from factorized_tpu_torch.parallel import sharding
from factorized_tpu_torch.parallel.multiseed import (
    DEFAULT_EPOCH_CHUNK, MULTISEED_TYPES, LaneLoop, LanePrograms, LaneShard,
    _Null, _run_seed, data_fingerprint, lane_state, opt_state_lanes,
    prepare_bucket_data, sched_from_dicts, sched_to_dicts, stack_lanes,
    take_lane, take_lanes)
from factorized_tpu_torch.train import LaneAdam, make_loss_fn
from factorized_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)
from factorized_tpu_torch.utils.logging import RunLogger
from factorized_tpu_torch.utils.metrics import (score_classification,
                                                score_multitrait,
                                                score_regression)

# each lane's value fields, its row of the (K, n_hp) matrix: everything
# the search draws that is not a shape (``out_drop`` is read by no
# bucketable type, as in the reference, and kept for the drift check)
HP_FIELDS = (
    "zy_to_fy_dropout", "zl_to_fl_dropout", "za_to_fa_dropout",
    "zv_to_fv_dropout", "fy_to_y_dropout",
    "att1_drop", "att2_drop", "gamma1_drop", "gamma2_drop", "out_drop",
    "lda_mmd", "lda_xl", "lda_xa", "lda_xv",
)

# the fields that change the program: configs share a bucket only where
# they agree on all of them
SHAPE_FIELDS = (
    "input_dims", "h_dims", "memsize", "windowsize", "output_dim",
    "seqlength", "zy_size", "zl_size", "za_size", "zv_size",
    "fy_size", "fl_size", "fa_size", "fv_size",
    "att1_shape", "att2_shape", "gamma1_shape", "gamma2_shape",
    "out_shape", "batchsize", "num_epochs", "task", "model_type",
    "missing", "zeros",
)


def shape_signature(cfg) -> tuple:
    """The config's program signature, hashable."""
    vals = []
    for f in SHAPE_FIELDS:
        v = getattr(cfg, f)
        vals.append(tuple(v) if isinstance(v, list) else v)
    return tuple(vals)


def bucket_configs(cfgs: Sequence) -> List[List[int]]:
    """The configs' indices grouped by shape signature, in the order
    each signature first appears."""
    groups = defaultdict(list)
    for i, c in enumerate(cfgs):
        groups[shape_signature(c)].append(i)
    return list(groups.values())


def lane_cfg(rep_cfg, hp_vec):
    """The representative config with its value fields replaced by one
    lane's row (under vmap, 0-d tensors)."""
    return rep_cfg.replace(**{f: hp_vec[i] for i, f in enumerate(HP_FIELDS)})


def hp_matrix(cfgs: Sequence, seeds_per_config: int) -> np.ndarray:
    """(K, n_hp) float32 lane values, lane = (config major, seed
    minor)."""
    rows = []
    for c in cfgs:
        row = [float(getattr(c, f)) for f in HP_FIELDS]
        rows.extend([row] * seeds_per_config)
    return np.asarray(rows, np.float32)


class ConfigBucketProgram(LanePrograms):
    """The lane programs of one shape signature whose lanes each carry
    their own values (``lane_loss``), and the ``LaneLoop`` that runs them:
    built at the first call, then reused by every later call on the same
    data and lane count (``bind``), so its CUDA graph is captured once.
    ``state`` is the loop's live buffers; ``load_state`` copies a snapshot
    into them and ``recycle`` re-initialises lanes in place."""

    def __init__(self, apply_fn, rep_cfg, generator, valid_metric="loss"):
        super().__init__(apply_fn, rep_cfg, generator, valid_metric)
        self.rep_cfg = rep_cfg
        self.loop = None

    def lane_loss(self, hp):
        if hp is None:
            return self.loss_fn
        return make_loss_fn(self.apply_fn, lane_cfg(self.rep_cfg, hp),
                            "joint")

    def bind(self, params, lrs, prep, epochs):
        """The loop over ``prep``'s tensors for ``len(lrs)`` lanes and
        chunks of up to ``epochs``: the one built before where it fits,
        else a new one from ``params`` (a tree of ``(K, ...)`` leaves)."""
        loop, K = self.loop, len(lrs)
        if (loop is None or loop.batches[0] is not prep["Xb"]
                or loop.opt.lanes != K or loop.records.shape[0] < epochs):
            dev = prep["Xb"].device
            opt = LaneAdam(stack_lanes([take_lane(params, k)
                                        for k in range(K)], dev), lrs)
            hps = torch.zeros((K, len(HP_FIELDS)), dtype=torch.float32,
                              device=dev)
            self.loop = LaneLoop(self, opt.params, opt, prep["Xb"],
                                 prep["yb"], prep["Xv"], prep["yv"],
                                 epochs=epochs,
                                 valid_metric=self.valid_metric, hps=hps)
        return self.loop

    def start(self, params, lrs):
        """Every lane of the bound loop a fresh trial: ``params``, a fresh
        Adam at ``lrs``, a fresh scheduler and best record."""
        loop = self.loop
        opt = loop.opt
        with torch.no_grad():
            opt.flat.copy_(opt.flatten(params))
            opt.reset_lanes(range(opt.lanes))
            opt.set_lr(lrs)
            loop.sched["best"].fill_(math.inf)
            loop.sched["bad"].zero_()
            loop.sched["cooldown"].zero_()
            loop.best.fill_(-math.inf if loop.acc_mode else math.inf)
            loop.has_best.zero_()

    def state(self):
        """The bound loop's live buffers: the lanes' parameters (a tree of
        views), Adam, the scheduler, the best record and the value
        matrix."""
        loop = self.loop
        return {"loop": loop, "params": loop.params, "opt": loop.opt,
                "sched": loop.sched, "best": loop.best,
                "best_flat": loop.best_flat, "has_best": loop.has_best,
                "hps": loop.hps}

    def load_state(self, state):
        """``state`` copied into the bound loop's buffers in place: a
        snapshot (``_host_state``) or another loop's live state; the
        loop's own state is left as it is."""
        loop = self.loop
        if state.get("loop") is loop:
            return
        if "opt" in state:
            state = host_lanes(_host_state(state), self.shard)
        opt = loop.opt
        opt.load_state_dict(state["opt_state"], params=state["params"])
        with torch.no_grad():
            loop.best_flat.copy_(opt.flatten(state["best_params"]))
            loop.best.copy_(torch.tensor(state["best"],
                                         dtype=torch.float32))
            loop.has_best.copy_(torch.tensor(state["has_best"],
                                             dtype=torch.bool))
        sched_from_dicts(state["sched"], loop.sched)

    @staticmethod
    def recycle(state, lanes, fresh):
        """Lanes ``lanes`` (a device index tensor) of the live ``state``
        set to the parameters ``fresh`` (a tree of ``(len(lanes), ...)``
        leaves) with a fresh Adam, in place: one ``index_copy_`` of the
        rows and ``LaneAdam.reset_lanes``."""
        opt = state["opt"]
        with torch.no_grad():
            opt.flat.index_copy_(0, lanes, opt.flatten(fresh))
        opt.reset_lanes(lanes)


def _host_state(state):
    """A live ``state`` (``ConfigBucketProgram.state``) as host copies:
    the form a snapshot restores; sharded, every rank's lanes gathered
    (all K)."""
    loop = state["loop"]
    st = lane_state(loop, loop.programs.shard)
    return {"params": loop.opt.tree_of(st["flat"]),
            "opt_state": st["opt_state"],
            "sched": sched_to_dicts(st["sched"]),
            "best": [float(b) for b in st["best"]],
            "best_params": loop.opt.tree_of(st["best_flat"]),
            "has_best": [bool(b) for b in st["has_best"]]}


def host_lanes(state, shard):
    """This rank's lanes of a host ``state`` of all K (``_host_state``, a
    snapshot's); the state itself unsharded."""
    if shard is None or shard.group is None:
        return state
    lanes = shard.lanes
    sl = slice(lanes.start, lanes.stop)
    return {"params": take_lanes(state["params"], lanes),
            "opt_state": opt_state_lanes(state["opt_state"], lanes),
            "sched": list(state["sched"])[sl],
            "best": list(state["best"])[sl],
            "best_params": take_lanes(state["best_params"], lanes),
            "has_best": list(state["has_best"])[sl]}


def train_config_bucket(
    X_train, y_train, X_valid, y_valid, X_test, y_test, cfgs, *,
    seeds_per_config: int = 1,
    lr: Optional[float] = None,
    use_config_lr: bool = False,
    logger: Optional[RunLogger] = None,
    seed: int = 123,
    binary_threshold: float = 0.0,
    threshold_mode: str = "ge",
    valid_metric: str = "loss",
    state_in: Optional[dict] = None,
    return_state: bool = False,
    key_salt: int = 777,
    epoch_offset: int = 0,
    program: Optional[ConfigBucketProgram] = None,
    prep: Optional[dict] = None,
    defer_scoring: bool = False,
    params=None,
    device=None,
    mesh=None,
    shard: Optional[LaneShard] = None,
):
    """Train a bucket of same-shape configs, K = ``len(cfgs) *
    seeds_per_config`` lanes of one program (the JAX package's
    ``train_config_bucket``). The configs may differ in
    any ``HP_FIELDS`` value and in ``lr``: ``use_config_lr`` gives each
    lane its config's lr (``moud``/``you``, ``mfm_moud.py:466``), else
    every lane takes ``lr`` (1e-3 by default, ``mfm_mosi.py:403``).

    ``state_in``/``return_state`` chain the rungs of the evolving search:
    the previous call's ``state`` trains on for ``num_epochs`` (the
    program's own live state is read in place, a snapshot is copied in).
    ``key_salt`` seeds the call's draws (``_run_seed(seed, key_salt)``),
    ``epoch_offset`` numbers the logged epochs, ``program`` reuses a
    ``ConfigBucketProgram`` (and its captured loop) and ``prep`` a
    ``prepare_bucket_data`` of these arrays. ``params``: a tree of ``(K,
    ...)`` leaves to start from (else lane k from a generator seeded
    ``_run_seed(seed, k)``).

    Returns {"results": per lane {config_index, seed_index, metrics,
    best_valid}, "best_lane", "best_params"/"params" (the best lane's, a
    lane with non-finite metrics never wins), "history", "lane_params"
    (every lane's scored parameters on the CPU)} (+ "state"). With
    ``defer_scoring`` (which needs ``return_state``) no lane is scored:
    the results carry ``best_valid`` alone, for ``score_bucket_lanes``.

    ``mesh``: a ``sharding.Mesh`` sharing out the lanes (the module's
    doc); every rank returns the whole result. ``shard``: the
    ``LaneShard`` of a caller that shares the result itself
    (``train_evolving_search``).
    """
    logger = logger or RunLogger()
    if defer_scoring and not return_state:
        raise ValueError(
            "defer_scoring=True requires return_state=True — the "
            "caller must score finished lanes from the returned "
            "state (score_bucket_lanes)")
    sigs = {shape_signature(c) for c in cfgs}
    if len(sigs) != 1:
        raise ValueError(
            f"train_config_bucket got {len(sigs)} distinct shape "
            "signatures; bucket configs with bucket_configs() first")
    rep = cfgs[0]
    if rep.model_type not in MULTISEED_TYPES:
        raise ValueError(
            f"config-bucketed search supports model types "
            f"{MULTISEED_TYPES}; got {rep.model_type!r}")
    name = rep.model_type
    K = len(cfgs) * seeds_per_config
    outer = shard is None
    shard = shard or LaneShard(mesh, K, f"lanes={K} (configs x seeds)")
    if not shard.member:
        return shard.share_result(None)
    logger = shard.logger(logger)
    dev = resolve_device(device)
    if prep is None:
        prep = prepare_bucket_data(X_train, y_train, X_valid, y_valid,
                                   X_test, y_test, rep, seed=seed,
                                   device=dev, mesh=mesh)
    elif prep["seed"] != seed or prep["batchsize"] != rep.batchsize \
            or prep["task"] != rep.task:
        raise ValueError(
            "prep= was built for a different seed/batchsize/task than "
            "this bucket; rebuild it with prepare_bucket_data(...)")
    elif prep["fingerprint"] != data_fingerprint(
            X_train, X_valid, X_test,
            prep["Xb"].device if mesh is None else mesh, y_train, y_valid,
            y_test):
        raise ValueError(
            "prep= was built from different dataset arrays (or another "
            "device) than the ones passed positionally — the positional "
            "X/y args would be silently ignored. Rebuild it with "
            "prepare_bucket_data(...) on THESE tensors/device.")

    init, apply_fn = get_model(name)
    if program is None:
        program = ConfigBucketProgram(
            apply_fn, rep, torch.Generator(device=prep["Xb"].device),
            valid_metric)
    elif program.valid_metric != valid_metric:
        raise ValueError(f"program= keeps {program.valid_metric!r}, this "
                         f"bucket {valid_metric!r}")
    shard.bind(program)
    if use_config_lr:
        lane_lr = np.repeat([float(c.lr) for c in cfgs], seeds_per_config)
    else:
        lane_lr = np.full(K, 1e-3 if lr is None else lr)
    lane_lr = lane_lr.astype(np.float32)[shard.lo:shard.hi]
    chunk = min(rep.num_epochs, DEFAULT_EPOCH_CHUNK) or 1
    if state_in is None:
        if params is None:
            params = stack_lanes([init(torch.Generator().manual_seed(
                _run_seed(seed, k)), rep) for k in shard.lanes], dev)
        else:
            params = take_lanes(params, shard.lanes)
        program.bind(params, lane_lr, prep, chunk)
        program.start(params, lane_lr)
    else:
        if "opt" not in state_in:
            state_in = host_lanes(state_in, shard)
        program.bind(state_in["params"], lane_lr, prep, chunk)
        program.load_state(state_in)
    loop = program.loop
    with torch.no_grad():
        loop.hps.copy_(torch.from_numpy(
            hp_matrix(cfgs, seeds_per_config)[shard.lo:shard.hi]))
    program.generator.manual_seed(_run_seed(seed, key_salt))

    history = []
    e = 0
    while e < rep.num_epochs:
        n = min(chunk - e % chunk, rep.num_epochs - e)
        records = shard.gather(loop.run(n), dim=2).astype(np.float32)
        for j in range(n):
            ep = epoch_offset + e + j
            tracked, valids = records[j, 0], records[j, 1]
            logger.text(ep, tracked.round(4).tolist(),
                        valids.round(4).tolist())
            logger.record("epoch", epoch=ep, train_loss=tracked.tolist(),
                          valid_loss=valids.tolist())
            history.append({"epoch": ep, "valids": valids.tolist(),
                            "lrs": records[j, 2].tolist()})
        e += n

    state_out = program.state()
    best_h = shard.gather(loop.best.cpu()).numpy()
    if defer_scoring:
        results = [{"config_index": k // seeds_per_config,
                    "seed_index": k % seeds_per_config,
                    "best_valid": float(best_h[k])} for k in range(K)]
        out = {"results": results, "best_lane": None, "best_params": None,
               "params": None, "history": history, "state": state_out}
        return shard.share_result(out) if outer else out
    # a lane with no best yet (no epoch run, or just recycled) is scored
    # with its live parameters
    preds = shard.gather(program.predict(loop.opt.tree_of(loop.eval_flat()),
                                         prep["Xte"]))
    eval_stack = loop.opt.tree_of(shard.gather(loop.eval_flat().cpu()))
    yte = prep["yte"]
    multi = rep.output_dim > 1 and rep.task == "regression"
    results = []
    for k in range(K):
        results.append({
            "config_index": k // seeds_per_config,
            "seed_index": k % seeds_per_config,
            "metrics": _score_pred(preds[k], yte, rep, binary_threshold,
                                   threshold_mode),
            "best_valid": float(best_h[k]),
        })
    key_metric = ("accuracy" if rep.task == "classification"
                  else "mae_mean" if multi else "mae")
    maximize = rep.task == "classification"

    def rank_val(k):
        # NaN-safe: a diverged lane never wins the pick
        v = results[k]["metrics"][key_metric]
        if not np.isfinite(v):
            return np.inf
        return -v if maximize else v

    pick = min(range(K), key=rank_val)
    # multi-trait: the best lane's per-trait lists at the top level too,
    # which check --multitrait reads
    logger.record("final", per_lane=[r["metrics"] for r in results],
                  best_lane=pick,
                  best_config_index=results[pick]["config_index"],
                  **(results[pick]["metrics"] if multi else {}))
    pick_tree = take_lane(eval_stack, pick)
    out = {"results": results, "best_lane": pick, "best_params": pick_tree,
           "params": pick_tree, "history": history,
           "lane_params": pytree.tree_map(lambda a: a.cpu(), eval_stack)}
    if return_state:
        out["state"] = state_out
    return shard.share_result(out) if outer else out


def _score_pred(pred, yte, rep, binary_threshold, threshold_mode):
    """One lane's test metrics: classification, multi-trait (per-trait
    lists and their mean MAE, ``mae_mean``, which the ranks read) or
    scalar regression."""
    if rep.task == "classification":
        return score_classification(pred, yte, out=_Null())
    if rep.output_dim > 1 and rep.task == "regression":
        m = score_multitrait(pred, yte, out=_Null())
        return {**m, "mae_mean": float(np.mean(m["mae"]))}
    return score_regression(pred, yte, binary_threshold, threshold_mode,
                            out=_Null())


def score_bucket_lanes(program, state, lanes, Xte_d, yte, rep,
                       binary_threshold=0.0, threshold_mode="ge"):
    """Test-score lanes ``lanes`` of a bucket ``state``: their best
    parameters (a lane with no best its live ones) gathered into one
    ``(len(lanes), ...)`` tree, one predict at that width, metrics per
    lane. Returns (metrics list, the gathered tree); ``take_lane(tree,
    pos)`` is lane ``lanes[pos]``'s parameters. Sharded, each rank scores
    the lanes it holds and the scores and trees are gathered (the tree
    on the host)."""
    opt = state["opt"]
    eval_flat = LanePrograms.select(state["has_best"], state["best_flat"],
                                    opt.flat)
    shard = program.shard
    if shard is None or shard.group is None:
        sub = take_lanes(opt.tree_of(eval_flat), lanes)
        preds = program.predict(sub, Xte_d)
        metrics = [_score_pred(preds[i], yte, rep, binary_threshold,
                               threshold_mode) for i in range(len(lanes))]
        return metrics, sub
    mine = shard.mine(lanes)
    scored = []
    if mine:
        sub = take_lanes(opt.tree_of(eval_flat),
                         [lanes[p] - shard.lo for p in mine])
        preds = program.predict(sub, Xte_d)
        scored = [(p, _score_pred(preds[i], yte, rep, binary_threshold,
                                  threshold_mode), take_lane(sub, i))
                  for i, p in enumerate(mine)]
    scored = sorted(shard.gather_list(scored), key=lambda r: r[0])
    return ([m for _, m, _ in scored],
            stack_lanes([tree for _, _, tree in scored], "cpu"))


# ---- the evolving search (successive halving with lanes recycled) -------


def resample_values(template, dataset: str, rng=None):
    """A fresh search draw's value fields and lr (``mfm_mosi.py:1311-
    1344``) on ``template``'s shape: the same ``shape_signature``, so it
    can take a lane of a running bucket."""
    draw = sample_search_config(dataset, rng)
    vals = {f: getattr(draw, f) for f in HP_FIELDS}
    return template.replace(lr=draw.lr, **vals)


def recycle_lanes(state, lane_indices, *, cfg, init, lrs_new, seed: int,
                  valid_metric: str = "loss", fresh=None):
    """Lanes ``lane_indices`` of a live bucket ``state`` made fresh trials
    in place: new parameters (``fresh``, a tree of ``(len(lanes), ...)``
    leaves, else lane k's from ``init`` with a generator seeded
    ``_run_seed(seed, k)``), a fresh Adam (count 0), lr ``lrs_new``, a
    fresh scheduler and no best record. The other lanes' buffers are not
    touched, and lanes are independent, so their runs go on as if nothing
    had been culled."""
    opt = state["opt"]
    dev = opt.flat.device
    shard = state["loop"].programs.shard
    pos = (list(range(len(lane_indices))) if shard is None
           else shard.mine(lane_indices))
    if not pos:
        return state
    lo = 0 if shard is None else shard.lo
    lanes = torch.tensor([int(lane_indices[p]) - lo for p in pos],
                         dtype=torch.long, device=dev)
    if fresh is None:
        fresh = stack_lanes([init(torch.Generator().manual_seed(
            _run_seed(seed, int(lane_indices[p]))), cfg) for p in pos], dev)
    elif len(pos) != len(lane_indices):
        fresh = take_lanes(fresh, pos)
    ConfigBucketProgram.recycle(state, lanes, fresh)
    best_fill = -math.inf if valid_metric == "accuracy" else math.inf
    lrs = np.asarray(lrs_new, np.float32)[pos]
    _reset_books(state["sched"], state["best"], state["has_best"], lanes,
                 torch.tensor(lrs, device=dev), best_fill)
    return state


@torch.no_grad()
def _reset_books(sched, best, has_best, lanes, lrs_arr, best_fill):
    """The scheduler's and the best keeper's entries of ``lanes`` reset in
    place (the lr is Adam's own tensor)."""
    sched["lr"].index_copy_(0, lanes, lrs_arr)
    sched["best"].index_fill_(0, lanes, math.inf)
    sched["bad"].index_fill_(0, lanes, 0)
    sched["cooldown"].index_fill_(0, lanes, 0)
    best.index_fill_(0, lanes, best_fill)
    has_best.index_fill_(0, lanes, False)


def _rng_to_json(st):
    """``random.Random.getstate()`` as JSON (``_rng_from_json`` is the
    inverse), so a resumed search draws what the uninterrupted one
    draws."""
    version, internal, gauss = st
    return {"version": version, "internal": list(internal), "gauss": gauss}


def _rng_from_json(d):
    return (d["version"], tuple(d["internal"]), d["gauss"])


def _evolve_snapshot(path, template, state, cfgs, rung_next, rng,
                     explored, overall, rung_logs, logger):
    """The whole search at a rung boundary under ``path``: the live, the
    per-lane best and the overall best parameters, Adam, the lanes'
    configs, lrs, scheduler and best records, the draws' RNG and the
    search's books (the JAX package's ``_ev`` meta). Sharded, every
    rank's lanes are gathered and the writer alone writes."""
    host = _host_state(state)
    if not sharding.is_writer():
        return
    tree = {"live": host["params"], "best": host["best_params"]}
    if overall is not None:
        tree["overall"] = overall["params"]
    meta = template.to_dict()
    meta["_ev"] = {
        "rung_next": rung_next,
        "explored": explored,
        "cfgs": [c.to_dict() for c in cfgs],
        "lrs": [d["lr"] for d in host["sched"]],
        "best_valid": host["best"],
        "has_best": host["has_best"],
        "sched": host["sched"],
        "rng": _rng_to_json(rng.getstate()),
        "overall": (None if overall is None else
                    {k: overall[k] for k in ("metrics", "best_valid",
                                             "config", "rung")}),
        "rung_logs": rung_logs,
    }
    save_checkpoint(path, tree, opt_state=host["opt_state"], step=rung_next,
                    config=meta)
    logger.text(f"evolve snapshot -> {path} (next rung {rung_next})")


def _evolve_resume(resume_from, template, rng, K, logger):
    """Restore an ``_evolve_snapshot``: returns (state, cfgs, start rung,
    explored, overall, rung logs) and sets ``rng``'s state. Refuses a
    checkpoint of another kind, lane count or shape signature."""
    st, meta = restore_checkpoint(resume_from)
    ev = meta.get("config", {}).get("_ev")
    if ev is None:
        raise ValueError(
            f"checkpoint at {resume_from} is not an evolving-search "
            "snapshot (no _ev metadata); --resume on --evolve needs a "
            "snapshot written by a previous --evolve run")
    if len(ev["lrs"]) != K:
        raise ValueError(
            f"checkpoint at {resume_from} holds {len(ev['lrs'])} lanes "
            f"but this run has {K} (--trials x --seeds); they must match")
    cfgs = [MFMConfig.from_dict(d) for d in ev["cfgs"]]
    if shape_signature(cfgs[0]) != shape_signature(template):
        raise ValueError(
            f"checkpoint at {resume_from} was taken at a different "
            "shape signature than this run's template; resume with the "
            "same --seed/--config so the template matches")
    state = {"params": st["params"]["live"], "opt_state": st["opt_state"],
             "sched": ev["sched"], "best": ev["best_valid"],
             "best_params": st["params"]["best"],
             "has_best": ev["has_best"]}
    rng.setstate(_rng_from_json(ev["rng"]))
    overall = None
    if ev["overall"] is not None:
        overall = dict(ev["overall"])
        overall["params"] = st["params"]["overall"]
    logger.text(f"resumed evolving search from {resume_from} at rung "
                f"{ev['rung_next']} (explored {ev['explored']} configs)")
    return (state, cfgs, int(ev["rung_next"]), int(ev["explored"]),
            overall, list(ev["rung_logs"]))


def train_evolving_search(
    X_train, y_train, X_valid, y_valid, X_test, y_test, template,
    dataset: str, *,
    n_configs: int = 8,
    rungs: int = 4,
    cull_frac: float = 0.5,
    seeds_per_config: int = 1,
    rng=None,
    lr: Optional[float] = None,
    use_config_lr: bool = False,
    logger: Optional[RunLogger] = None,
    seed: int = 123,
    binary_threshold: float = 0.0,
    threshold_mode: str = "ge",
    valid_metric: str = "loss",
    program: Optional[ConfigBucketProgram] = None,
    ckpt_dir: Optional[str] = None,
    resume_from: Optional[str] = None,
    params=None,
    init_lanes=None,
    device=None,
    mesh=None,
):
    """Successive halving over the values of one shape, culled lanes
    recycled into fresh trials (the JAX package's
    ``train_evolving_search``). K = ``n_configs *
    seeds_per_config`` lanes hold ``template`` and ``n_configs - 1``
    draws of ``resample_values``; each rung (``template.num_epochs``
    epochs, ``train_config_bucket`` on the one program) ranks the configs
    by their best validation number (the best of their seeds), test-scores
    the lanes that finish (the culled ones, or all at the last rung) and
    re-draws the worst ``cull_frac`` of the configs.

    ``ckpt_dir`` snapshots the search at every rung boundary;
    ``resume_from`` goes on from one, as the uninterrupted run.
    ``params``: the first rung's parameters (a tree of ``(K, ...)``
    leaves); ``init_lanes(lanes, rung)``: a recycled lanes' parameters (a
    tree of ``(len(lanes), ...)`` leaves) in place of their seeded draw.
    ``mesh``: a ``sharding.Mesh`` sharing out the lanes (the module's
    doc); every rank returns the whole result.

    Returns {"best": the overall best finished lane (metrics, best_valid,
    config, rung, params), "rungs": each rung's scores, culls and configs,
    "explored_configs", "params"}.
    """
    logger = logger or RunLogger()
    rng = rng or random.Random(seed)
    rep = template
    cfgs = [template] + [resample_values(template, dataset, rng)
                         for _ in range(n_configs - 1)]
    if rep.model_type not in MULTISEED_TYPES:
        raise ValueError(
            f"the evolving search supports model types "
            f"{MULTISEED_TYPES}; got {rep.model_type!r}")
    K = n_configs * seeds_per_config
    shard = LaneShard(mesh, K, f"lanes={K} (configs x seeds)")
    if not shard.member:
        return shard.share_result(None)
    logger = shard.logger(logger)
    init, apply_fn = get_model(rep.model_type)
    dev = resolve_device(device)
    program = program or ConfigBucketProgram(
        apply_fn, rep, torch.Generator(device=dev), valid_metric)
    multi = rep.output_dim > 1 and rep.task == "regression"
    key_metric = ("accuracy" if rep.task == "classification"
                  else "mae_mean" if multi else "mae")
    maximize = key_metric == "accuracy"

    def better(a, b):
        # NaN-safe: a diverged record never stays the overall best
        if not np.isfinite(a):
            return False
        if not np.isfinite(b):
            return True
        return a > b if maximize else a < b

    data = (X_train, y_train, X_valid, y_valid, X_test, y_test)
    prep = prepare_bucket_data(*data, rep, seed=seed, device=dev, mesh=mesh)
    state = None
    start_rung = 0
    explored = n_configs
    overall = None
    rung_logs = []
    if resume_from:
        (state, cfgs, start_rung, explored, overall,
         rung_logs) = _evolve_resume(resume_from, rep, rng, K, logger)
        if start_rung >= rungs:
            raise ValueError(
                f"checkpoint at {resume_from} already completed "
                f"{start_rung} rungs; this run asks for {rungs} — "
                "raise --evolve to continue the search")
    else:
        # one "config" record per explored trial (check counts them as
        # runs); a resumed run's first draws are in the first run's log
        for c in cfgs:
            logger.record("config", **c.to_dict())
    for rung in range(start_rung, rungs):
        out = train_config_bucket(
            *data, list(cfgs), seeds_per_config=seeds_per_config, lr=lr,
            use_config_lr=use_config_lr, logger=logger, seed=seed,
            binary_threshold=binary_threshold,
            threshold_mode=threshold_mode, valid_metric=valid_metric,
            state_in=state, return_state=True, key_salt=777 + rung,
            epoch_offset=rung * rep.num_epochs, program=program, prep=prep,
            defer_scoring=True, params=params, device=dev, mesh=mesh,
            shard=shard)
        state = out["state"]
        cfg_snapshot = [c.to_dict() for c in cfgs]

        bv = np.asarray([r["best_valid"] for r in out["results"]])
        per_cfg = bv.reshape(n_configs, seeds_per_config)
        scores = (per_cfg.max(1) if valid_metric == "accuracy"
                  else per_cfg.min(1))
        entry = {"rung": rung, "scores": scores.tolist(), "culled": [],
                 "configs": cfg_snapshot}
        # the culls first, by the validation number; a trial is test-scored
        # once, when it finishes (culled, or at the last rung)
        culled = []
        if rung < rungs - 1:
            n_cull = int(cull_frac * n_configs)
            if n_cull:
                order = np.argsort(scores)
                culled = [int(c) for c in
                          (order[:n_cull] if valid_metric == "accuracy"
                           else order[-n_cull:])]
                entry["culled"] = culled
        finish_lanes = (list(range(K)) if rung == rungs - 1 else
                        [ci * seeds_per_config + s for ci in culled
                         for s in range(seeds_per_config)])
        if finish_lanes:
            metrics_list, sub = score_bucket_lanes(
                program, state, finish_lanes, prep["Xte"], prep["yte"],
                rep, binary_threshold, threshold_mode)

            def rank_pos(p):
                v = metrics_list[p][key_metric]
                if not np.isfinite(v):
                    return np.inf
                return -v if maximize else v

            pick_pos = min(range(len(finish_lanes)), key=rank_pos)
            logger.record(
                "final", per_lane=metrics_list, lanes=finish_lanes,
                best_lane=finish_lanes[pick_pos],
                best_config_index=finish_lanes[pick_pos]
                // seeds_per_config,
                **(metrics_list[pick_pos] if multi else {}))
            for pos, (lane, m) in enumerate(zip(finish_lanes,
                                                metrics_list)):
                if overall is None or better(m[key_metric],
                                             overall["metrics"]
                                             [key_metric]):
                    overall = {
                        "metrics": m, "best_valid": float(bv[lane]),
                        "config": cfg_snapshot[lane // seeds_per_config],
                        "rung": rung, "params": take_lane(sub, pos)}
        if culled:
            lanes, lrs_new = [], []
            for ci in culled:
                new_cfg = resample_values(template, dataset, rng)
                cfgs[ci] = new_cfg
                explored += 1
                logger.record("config", **new_cfg.to_dict())
                for s in range(seeds_per_config):
                    lanes.append(int(ci) * seeds_per_config + s)
                    lrs_new.append(
                        float(new_cfg.lr) if use_config_lr
                        else (1e-3 if lr is None else lr))
            recycle_lanes(state, lanes, cfg=rep, init=init, lrs_new=lrs_new,
                          seed=seed + 1000 * (rung + 1),
                          valid_metric=valid_metric, fresh=(None if init_lanes is None
                                 else init_lanes(lanes, rung)))
        rung_logs.append(entry)
        logger.record("rung", **{k: v for k, v in entry.items()
                                 if k != "configs"})
        if ckpt_dir and rung < rungs - 1:
            _evolve_snapshot(ckpt_dir, rep, state, cfgs, rung + 1, rng,
                             explored, overall, rung_logs, logger)

    logger.record("evolve_final", explored_configs=explored,
                  best_rung=overall["rung"], best_metrics=overall["metrics"],
                  best_config=overall["config"])
    return shard.share_result({"best": overall, "rungs": rung_logs,
                               "explored_configs": explored,
                               "params": overall["params"]})
