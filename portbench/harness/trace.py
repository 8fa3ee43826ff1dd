"""The device trace of a traced trial, reduced to what the per-layer
metrics read.

``torch.profiler`` (CUPTI on the card) records every kernel, copy and
fill the device ran, and the benchmark's own host spans as
``portbench.<span>`` ranges. ``Trace`` keeps, for the window of the
span ``portbench.trial``: each device operation's base name and
interval, the union of those intervals (the device's busy time), and
the benchmark's spans, which name the gaps in which the device was idle.
"""

from __future__ import annotations

import re

_NAME = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)\s*(?:<|\()")


def base_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters: ``void ns::k<3>(float*)`` -> ``k``."""
    if name.startswith("void "):
        name = name[len("void "):]
    name = name.replace("(anonymous namespace)::", "")
    if " " in re.split(r"[<(]", name, maxsplit=1)[0].strip():
        return name  # a copy or fill: "Memcpy HtoD (Pageable -> Device)"
    m = _NAME.search(name)
    return m.group(1) if m else name


def _ns(ev, which):
    f = getattr(ev, f"{which}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{which}_us")()) * 1000


class Trace:
    """``ops``: [(base name, start ns, end ns)] of the device in the
    window; ``spans``: [(name, start ns, end ns)] of the benchmark's
    ranges; ``window``: (start ns, end ns) of ``portbench.trial``."""

    def __init__(self, ops, spans, window):
        self.ops, self.spans, self.window = ops, spans, window
        self.window_s = (window[1] - window[0]) / 1e9
        self.busy = _union([(a, b) for _, a, b in ops])
        self.busy_s = sum(b - a for a, b in self.busy) / 1e9

    @classmethod
    def from_profiler(cls, prof):
        ops, spans = [], []
        for ev in prof.profiler.kineto_results.events():
            name = ev.name()
            start = _ns(ev, "start")
            end = start + _ns(ev, "duration")
            if name.startswith("portbench."):
                # the benchmark's ranges; the profiler also copies them
                # onto the device's timeline, which is not device work
                if "CUDA" not in str(ev.device_type()):
                    spans.append((name[len("portbench."):], start, end))
            elif "CUDA" in str(ev.device_type()):
                ops.append((base_name(name), start, end))
        trial = [(a, b) for n, a, b in spans if n == "trial"]
        if not trial:
            raise RuntimeError("the trace holds no portbench.trial range")
        window = trial[0]
        ops = [(n, max(a, window[0]), min(b, window[1])) for n, a, b in ops
               if b > window[0] and a < window[1]]
        return cls(ops, spans, window)

    def kernel_seconds(self, names):
        """Device seconds of the operations whose base name is in
        ``names``."""
        names = set(names)
        return sum(b - a for n, a, b in self.ops if n in names) / 1e9

    def top_ops(self, k=10):
        """The k operations that took the most device time: [[name,
        seconds]]."""
        tot = {}
        for n, a, b in self.ops:
            tot[n] = tot.get(n, 0) + (b - a)
        return [[n, t / 1e9] for n, t in
                sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k=10):
        """The k longest intervals of the window with no device
        operation, each named by the innermost benchmark span open at its
        start: [[span name, seconds]]."""
        gaps, at = [], self.window[0]
        for a, b in self.busy:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.window[1] > at:
            gaps.append((at, self.window[1]))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            open_ = [(s, n) for n, s, e in self.spans if s <= a < e]
            out.append([max(open_)[1] if open_ else "none", (b - a) / 1e9])
        return out


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out
