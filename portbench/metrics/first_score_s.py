"""Seconds of the process's first test score: the program's earliest
``trainer.score`` span (``trainers._Setup.score`` or
``multiseed.LanePrograms.predict``), which is the set-up's warm-up
trial's: it must end before the window's first trial starts."""

from portbench.harness.spans import program_spans, seconds


def read(ctx):
    spans = program_spans()
    trials = [a for n, a, _, _ in ctx.spans if n == "trial"]
    if not spans or not trials:
        return None
    start = min(trials) * 1e9
    scores = [s for s in spans if s.name == "trainer.score"]
    if not scores:
        return None
    first = min(scores, key=lambda s: s.start_ns)
    return seconds(first) if first.end_ns <= start else None
