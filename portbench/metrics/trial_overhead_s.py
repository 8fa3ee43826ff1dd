"""Mean seconds a trial spends beyond its epochs at the steady replay
rate: the trainer's set-up, the eager first epoch, the capture and the
test score. From the benchmark's host spans: each trial's span less its
epochs times the replayed epoch, as ``epoch_replay_ms`` reads it (the
epoch loop's ``run`` calls that are not a trial's first)."""


def read(ctx):
    runs = [(b - a, attrs["epochs"]) for name, a, b, attrs in ctx.spans
            if name == "loop.run" and not attrs["first"]]
    trials = [b - a for name, a, b, _ in ctx.spans if name == "trial"]
    replayed = sum(n for _, n in runs)
    if not replayed or not trials:
        return None
    per_epoch = sum(d for d, _ in runs) / replayed
    return sum(trials) / len(trials) - ctx.epochs / len(trials) * per_epoch
