"""Host milliseconds of a replayed epoch: the epoch loop's ``run`` calls
that are not a trial's first (those hold only graph replays and the
chunk's one host read), over the epochs they ran."""


def read(ctx):
    runs = [(b - a, attrs["epochs"]) for name, a, b, attrs in ctx.spans
            if name == "loop.run" and not attrs["first"]]
    epochs = sum(n for _, n in runs)
    if not epochs:
        return None
    return 1e3 * sum(d for d, _ in runs) / epochs
