"""The program's own spans (``factorized_tpu_torch.utils.profiling``:
``spans()``, records with ``name``, ``start_ns``, ``end_ns`` on
``time.perf_counter_ns()`` and ``attrs``), as the readers of the
per-layer metrics take them. A program that records none (one older
than its recorder) gives None, and the readers return None."""


def program_spans():
    """Every span the program holds, or None where it records none."""
    try:
        from factorized_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    return None if spans is None else spans()


def in_window(ctx, name):
    """The program's spans named ``name`` that lie inside one of the
    window's ``trial`` spans (``ctx.spans``, the benchmark's, on
    ``time.perf_counter()``: the same clock in seconds), in the order
    they closed; None where the program records no spans."""
    spans = program_spans()
    if spans is None:
        return None
    trials = [(a * 1e9, b * 1e9) for n, a, b, _ in ctx.spans if n == "trial"]
    return [s for s in spans if s.name == name and any(
        a <= s.start_ns and s.end_ns <= b for a, b in trials)]


def seconds(s):
    return (s.end_ns - s.start_ns) / 1e9
