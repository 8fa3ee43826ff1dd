"""What the benchmark sees of the program while it runs: host spans
around the program's calls, and the first steps of every optimizer.

Nothing here changes what the program computes. ``Observer.install``
wraps a few of the program's functions from the outside, each wrapper
calling the original with the same arguments:

- spans (``perf_counter`` seconds; under a trace also a
  ``torch.profiler.record_function`` named ``portbench.<span>``, so
  that the trace's idle gaps can be named): a trainer's set-up
  (``trainer.setup``; over lanes its data, ``trainer.data``, and its
  initial weights, ``trainer.init``), each ``run`` of an epoch loop (``loop.run``,
  with its epochs, and whether it is the loop's first), each epoch as
  the loop's ``Graphed`` takes it (``epoch.eager``, ``epoch.capture``,
  ``epoch.replay``) and the test predict (``score``);
- the first ``STEPS`` steps of each optimizer (``FlatAdam``,
  ``LaneAdam``): its flat parameters before the first step, Adam's first
  moment after it (the first gradient times 1 - b1) and the parameters
  after the last, and each step's tracked loss as the program's step
  returns it. Device copies, taken in the eager first epoch, before any
  graph is captured;
- one epoch of each trial, ``pick`` = (epoch, lane) as the harness sets
  it before the trial (on the card every epoch after the first is a
  replay of the captured graph): that lane's optimizer state (the flat
  parameters, Adam's moments), step count and lr and the loop
  generator's state before the epoch, its optimizer state after it, and
  the epoch's row of the loop's records. Device copies between two
  epochs, outside any capture.

What this reads of the program's internals is listed in ``READS``; a
record taken under a CUDA graph capture, or one that never came, raises
(``check_observed``) rather than leave the check or a metric silent.
"""

from __future__ import annotations

import contextlib
import time

import torch

STEPS = 3

# The program's internals this module reads or wraps: a change to any of
# them has to carry the observer along (PERF.md, "Layers").
READS = (
    "train.FlatAdam.step / LaneAdam.step (self.flat, self.mu, self.state, "
    "self.count, self.lr, self.params)",
    "train.TrainProgram.step / multiseed.LanePrograms.step (their tracked "
    "loss)",
    "train.ChunkedLoop.run / multiseed.LaneLoop.run (each epoch as "
    "self.epoch(); self.opt, self.records, self.generator or "
    "self.programs.generator)",
    "train.Graphed.__call__ (self.graph, self.warm: eager, capture, replay)",
    "trainers._Setup.__init__, trainers._predict_y, "
    "multiseed.LanePrograms.predict, multiseed.prepare_bucket_data, "
    "multiseed.init_lanes (spans)",
)


class Unobserved(RuntimeError):
    """What the check or a metric reads was not recorded, or was recorded
    under a graph capture: the program's internals moved (``READS``)."""


def _not_capturing(t, what):
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        raise Unobserved(f"{what} was taken under a CUDA graph capture: it "
                         f"would copy nothing the replays compute")


class StepRecord:
    """The first steps of one optimizer: ``layout`` [(leaf path,
    per-lane shape)], in its flat order; ``init``, ``mu1`` and ``last``
    flat vectors ((P,) or (K, P)); ``losses`` the tracked losses."""

    def __init__(self, optimizer):
        self.lanes = getattr(optimizer, "lanes", None)
        self.layout = list(_layout(optimizer.params, self.lanes is not None))
        self.count = 0
        self.init = self.mu1 = self.last = None
        self.losses = []

    def split(self, vec, lane=None):
        """A flat vector (a lane's row where ``lane`` is given) as
        {leaf path: tensor}, on the CPU."""
        v = (vec if lane is None else vec[lane]).detach().cpu()
        return _split(v, self.layout)


class EpochRecord:
    """One epoch of one trial, lane ``lane``: ``start`` and ``end`` its
    optimizer state rows (3, P): flat parameters, mu, nu; ``count`` the
    step count and ``lr`` the lr before it; ``gen_state`` the loop's
    generator state before it; ``row`` its records row ((5,) or (3, K));
    ``layout`` as ``StepRecord``'s."""

    def __init__(self, loop, epoch, lane):
        opt = loop.opt
        self.epoch, self.lane = epoch, lane
        self.lanes = getattr(opt, "lanes", None)
        self.layout = list(_layout(opt.params, self.lanes is not None))
        self.start = self.end = self.row = None
        self.count = self.lr = self.gen_state = None

    def _rows(self, opt):
        if self.lanes is None:
            return opt.state.reshape(-1, opt.flat.shape[-1])
        return opt.state[:, self.lane]

    def _one(self, t):
        return t if self.lanes is None else t[self.lane]

    def before(self, loop):
        opt = loop.opt
        _not_capturing(opt.state, "the replayed epoch's start")
        self.start = self._rows(opt).detach().clone()
        self.count = self._one(opt.count).detach().clone()
        self.lr = self._one(opt.lr).detach().clone()
        gen = getattr(loop, "generator", None)
        if gen is None:
            gen = loop.programs.generator
        self.gen_state = gen.get_state()

    def after(self, loop, slot):
        _not_capturing(loop.opt.state, "the replayed epoch's end")
        self.end = self._rows(loop.opt).detach().clone()
        self.row = loop.records[slot].detach().clone()

    def split(self, vec):
        """A flat (P,) vector as {leaf path: tensor}, on the CPU."""
        return _split(vec.detach().cpu(), self.layout)


def _split(v, layout):
    out, at = {}, 0
    for path, shape in layout:
        n = 1
        for s in shape:
            n *= s
        out[path] = v[at:at + n].reshape(shape)
        at += n
    return out


def _layout(tree, lanes, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _layout(v, lanes, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", tuple(v.shape[1:] if lanes else v.shape)


class Observer:
    def __init__(self):
        self.spans = []
        self.records = []
        self.epochs = []
        # (epoch, lane) of the next trial's ``EpochRecord``; None: none
        self.pick = None
        self.profiling = False
        self._saved = []

    @contextlib.contextmanager
    def span(self, name, **attrs):
        mark = (torch.profiler.record_function(f"portbench.{name}")
                if self.profiling else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with mark:
                yield
        finally:
            self.spans.append((name, t0, time.perf_counter(), attrs))

    def _wrap(self, owner, attr, make):
        original = getattr(owner, attr)
        self._saved.append((owner, attr, original))
        setattr(owner, attr, make(original))

    def install(self):
        from factorized_tpu_torch import trainers, train
        from factorized_tpu_torch.parallel import multiseed

        obs = self

        def optimizer_step(original):
            def step(self):
                rec = getattr(self, "_portbench_record", None)
                if rec is None:
                    rec = self._portbench_record = StepRecord(self)
                    obs.records.append(rec)
                if rec.count < STEPS:
                    _not_capturing(self.flat, f"step {rec.count + 1}'s record")
                if rec.count == 0:
                    rec.init = self.flat.detach().clone()
                original(self)
                rec.count += 1
                if rec.count == 1:
                    rec.mu1 = self.mu.detach().clone()
                if rec.count == STEPS:
                    rec.last = self.flat.detach().clone()
            return step

        def program_step(original):
            def step(self, params, optimizer, *args, **kwargs):
                tracked = original(self, params, optimizer, *args, **kwargs)
                rec = getattr(optimizer, "_portbench_record", None)
                if rec is not None and len(rec.losses) < STEPS:
                    rec.losses.append(tracked.detach().clone())
                return tracked
            return step

        def spanned(name):
            def make(original):
                def call(*args, **kwargs):
                    with obs.span(name):
                        return original(*args, **kwargs)
                return call
            return make

        def loop_run(original):
            def run(self, n):
                first = not getattr(self, "_portbench_ran", False)
                if first:
                    self._portbench_ran = True
                    self._portbench_done = 0
                    obs._observe_epochs(self)
                self._portbench_slot = 0
                with obs.span("loop.run", epochs=n, first=first):
                    return original(self, n)
            return run

        def graphed_call(original):
            def call(self):
                name = ("epoch.replay" if self.graph is not None else
                        "epoch.capture" if self.warm else "epoch.eager")
                with obs.span(name):
                    return original(self)
            return call

        self._wrap(train.FlatAdam, "step", optimizer_step)
        self._wrap(train.LaneAdam, "step", optimizer_step)
        self._wrap(train.TrainProgram, "step", program_step)
        self._wrap(multiseed.LanePrograms, "step", program_step)
        self._wrap(train.ChunkedLoop, "run", loop_run)
        self._wrap(multiseed.LaneLoop, "run", loop_run)
        self._wrap(train.Graphed, "__call__", graphed_call)
        self._wrap(trainers._Setup, "__init__", spanned("trainer.setup"))
        self._wrap(trainers, "_predict_y", spanned("score"))
        self._wrap(multiseed.LanePrograms, "predict", spanned("score"))
        self._wrap(multiseed, "prepare_bucket_data", spanned("trainer.data"))
        self._wrap(multiseed, "init_lanes", spanned("trainer.init"))

    def _observe_epochs(self, loop):
        """``loop``'s epochs through a wrapper that records the picked
        one (``EpochRecord``) around it."""
        pick, self.pick = self.pick, None
        if pick is None:
            return
        rec = EpochRecord(loop, *pick)
        self.epochs.append(rec)
        inner = loop.epoch

        def epoch():
            at, slot = loop._portbench_done, loop._portbench_slot
            loop._portbench_done += 1
            loop._portbench_slot += 1
            if at != rec.epoch:
                return inner()
            rec.before(loop)
            out = inner()
            rec.after(loop, slot)
            return out

        loop.epoch = epoch

    def uninstall(self):
        while self._saved:
            owner, attr, original = self._saved.pop()
            setattr(owner, attr, original)


def check_observed(obs, trials, records, epochs, lanes, cuda):
    """Raise ``Unobserved`` where a window trial lacks what the check and
    the metrics read: its first steps, its picked epoch, its spans."""
    def need(ok, what):
        if not ok:
            raise Unobserved(
                f"{what}: the program's internals that the benchmark reads "
                f"have changed (portbench/harness/observe.py READS)")

    need(len(records) == len(trials) and all(
        r is not None and r.count >= STEPS and len(r.losses) == STEPS
        and r.init is not None and r.mu1 is not None and r.last is not None
        for r in records), "a trial's first steps were not recorded")
    need(len(epochs) == len(trials) and all(
        e is not None and e.end is not None for e in epochs),
        "a trial's picked epoch was not recorded")
    names = [s[0] for s in obs.spans]
    setup = ("trainer.setup",) if lanes == 1 else ("trainer.data",
                                                   "trainer.init")
    for name in setup + ("loop.run", "score"):
        need(names.count(name) >= len(trials), f"no {name} span a trial")
    if cuda:
        for name in ("epoch.eager", "epoch.capture", "epoch.replay"):
            need(names.count(name) >= len(trials),
                 f"no {name} span a trial")
