"""Tracing (port of ``factorized_tpu/utils/profiling.py``) and the port's
host spans.

- ``trace(logdir)``: a context manager around ``torch.profiler.profile``
  (CPU activity, and CUDA where a card is present) that writes one Chrome
  trace, ``<logdir>/<host>_<pid>.<ms>.pt.trace.json``, which TensorBoard
  (the PyTorch profiler plugin) or ``chrome://tracing`` opens. The
  hand-written kernels appear under their own names; a CUDA graph's
  replay shows its kernels as well; the spans below appear as
  ``ftt.<name>`` ranges.
- ``span(name, **attrs)``: a context manager that records one host span
  of the process: ``Span(name, start_ns, end_ns, parent, trial, attrs,
  index)`` on ``time.perf_counter_ns()``. ``index`` numbers the spans of
  the process in the order they open; ``parent`` is the index of the
  span open around it on the same thread (None at the top); ``trial``
  the index of the ``trial`` span around it (its own for a ``trial``),
  so the spans of one trainer call share it. ``with span(...) as s``
  gives the open span: ``s.attrs`` takes attributes known only at its
  end, ``s.seconds`` its length once it has closed. While a
  ``torch.profiler`` (or autograd profiler) is on, each span is also a
  profiler range ``ftt.<name>`` on the trace's clock; with no profiler
  no range is opened. The range is a function-scope record
  (``torch._C._profiler._RecordFunctionFast``, a ``cpu_op`` in the
  trace) and not ``record_function``'s user annotation, which the
  profiler also copies onto the device's timeline as if it were device
  work: a span that waits on the card (``loop.read``) would read as the
  card busy.
  ``spans()`` returns the records (the last ``MAX_SPANS``, in the order
  the spans closed), ``dropped()`` counts those evicted, ``clear()``
  empties both.
- ``trial``: a trainer's decorator: its call is one ``trial`` span
  (``trainer``: its name), unless a trial is already open on the thread
  (a trainer that delegates to another); ``note_trial(**attrs)`` adds
  what the trainer builds (``model_type``, ``lanes``) to the open
  trial's attributes.

Where the port opens spans (each module's docstring names its own):
``trial`` around each public trainer; ``trainer.setup`` (``setup.data``,
``setup.init``), ``lanes.data`` and ``lanes.init`` for the trainers'
set-up; ``loop.run`` (``loop.read``) in the epoch loops; ``graph.eager``,
``graph.capture`` (``capture.prepare``, ``capture.record``,
``capture.instantiate``) and ``graph.replay`` in ``train.Graphed``;
``step.forward``, ``step.backward``, ``step.optimizer`` and
``epoch.eval`` in the train programs, which run eagerly and under
capture but never in a replay; ``trainer.score`` (``score.pack``,
``score.forward``, ``score.read``) for the test score.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from typing import NamedTuple, Optional

import torch

# records kept; older ones are evicted (and counted in ``dropped``)
MAX_SPANS = 65536


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    trial: Optional[int]
    attrs: dict
    index: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _Open:
    """A span while it is open (``Recorder.span``)."""

    __slots__ = ("recorder", "name", "attrs", "index", "parent", "trial",
                 "start_ns", "end_ns", "_range")

    def __init__(self, recorder, name, attrs):
        self.recorder, self.name, self.attrs = recorder, name, attrs
        self.end_ns = None

    def __enter__(self):
        rec = self.recorder
        stack = rec._stack()
        top = stack[-1] if stack else None
        self.index = next(rec._counter)
        self.parent = None if top is None else top.index
        self.trial = (self.index if self.name == "trial"
                      else None if top is None else top.trial)
        stack.append(self)
        self._range = None
        if torch._C._autograd._profiler_enabled():
            self._range = torch._C._profiler._RecordFunctionFast(
                "ftt." + self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        self.recorder._stack().pop()
        self.recorder._close(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Recorder:
    """Host spans in a bounded deque of ``maxlen`` records; ``dropped``
    counts the records evicted. Each thread nests its own spans."""

    def __init__(self, maxlen: int = MAX_SPANS):
        self.records = collections.deque(maxlen=maxlen)
        self.dropped = 0
        self._counter = itertools.count()
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _close(self, s):
        record = Span(s.name, s.start_ns, s.end_ns, s.parent, s.trial,
                      s.attrs, s.index)
        with self._lock:
            if len(self.records) == self.records.maxlen:
                self.dropped += 1
            self.records.append(record)

    def span(self, name: str, **attrs) -> _Open:
        return _Open(self, name, attrs)

    def enclosing(self, name: str):
        """The innermost span named ``name`` open on this thread, or
        None."""
        for s in reversed(self._stack()):
            if s.name == name:
                return s
        return None

    def spans(self) -> list:
        with self._lock:
            return list(self.records)

    def clear(self):
        with self._lock:
            self.records.clear()
            self.dropped = 0


# the process's recorder, which the port's spans write to
RECORDER = Recorder()


def span(name: str, **attrs) -> _Open:
    return RECORDER.span(name, **attrs)


def spans() -> list:
    return RECORDER.spans()


def dropped() -> int:
    return RECORDER.dropped


def clear():
    RECORDER.clear()


def trial(trainer):
    """``trainer``'s call as one ``trial`` span, unless one is open."""
    @functools.wraps(trainer)
    def run(*args, **kwargs):
        if RECORDER.enclosing("trial") is not None:
            return trainer(*args, **kwargs)
        with RECORDER.span("trial", trainer=trainer.__name__):
            return trainer(*args, **kwargs)
    return run


def note_trial(**attrs):
    """``attrs`` into the attributes of the ``trial`` span open on this
    thread (none open: nothing)."""
    s = RECORDER.enclosing("trial")
    if s is not None:
        s.attrs.update(attrs)
