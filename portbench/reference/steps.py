"""The reference's side of a trial: its first train steps under plain
Adam, its eval of given parameters, and the plateau schedule and
best-valid keeper replayed from a trial's validation losses."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model as ref

B1, B2, EPS = 0.9, 0.999, 1e-8


def lane_seed(seed: int, lane: int) -> int:
    """The init seed of lane ``lane`` of a bucket seeded ``seed``."""
    return int(np.random.SeedSequence([int(seed), int(lane)])
               .generate_state(1)[0])


def batches(X_train, y_train, seed, batchsize):
    """The training set permuted once by ``seed`` and cut into full
    batches, time-major: (nb, t, B, d), (nb, B)."""
    p = np.random.RandomState(int(seed)).permutation(X_train.shape[0])
    X, y = np.asarray(X_train)[p], np.asarray(y_train, np.float32)[p]
    nb = X.shape[0] // batchsize
    X = X[:nb * batchsize].reshape(nb, batchsize, *X.shape[1:])
    return (np.ascontiguousarray(X.transpose(0, 2, 1, 3)),
            y[:nb * batchsize].reshape(nb, batchsize))


def leaves(tree, prefix=""):
    """A nested dict of tensors as {dotted path: tensor}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def first_steps(cfg, model, seed, data, device, num, *, lr, steps=3,
                lanes=1, lane=0, half=False):
    """The first ``steps`` train steps of a trial seeded ``seed`` (of
    lane ``lane`` of a bucket of ``lanes`` seeded ``seed`` where
    ``lanes`` > 1): {"losses": the label loss of each step, "grad1":
    {leaf: the first gradient}, "change": {leaf: the parameters after
    the last step less the initial ones}}, tensors on the CPU. ``half``:
    each step on the first half of its batch alone (a fault)."""
    batched = lanes > 1
    init = ref.init_params(cfg, model, lane_seed(seed, lane) if batched
                           else seed)
    flat = {k: v.to(device) for k, v in leaves(init).items()}
    zeros = {k: torch.zeros_like(v) for k, v in flat.items()}
    draws = ref.Draws(seed, device, lanes, lane, batched)
    out = adam_steps(cfg, model, flat, zeros, dict(zeros), 0, lr,
                     seed, data, draws, num, steps=steps, half=half)
    return {"losses": out["losses"], "grad1": out["grad1"],
            "change": out["change"]}


def replay_epoch(cfg, model, seed, data, device, num, *, start, count, lr,
                 gen_state, lanes=1, lane=0, half=False):
    """One whole epoch of a trial seeded ``seed`` from the state at its
    start as the program held it (``start``: {"flat", "mu", "nu"}, each
    {leaf: tensor}; Adam's step ``count``; the lane's ``lr``; the loop
    generator's ``gen_state``): {"loss": the epoch's mean label loss in
    float32, "grad1", "change" (over the epoch), "end": {leaf: the
    parameters after it}}, on the CPU. ``half`` as ``first_steps``'s."""
    draws = ref.Draws(seed, device, lanes, lane, lanes > 1)
    draws.gen.set_state(gen_state)
    nb = data[0].shape[0] // cfg["batchsize"]
    return adam_steps(cfg, model,
                      *({k: v.to(device) for k, v in start[key].items()}
                        for key in ("flat", "mu", "nu")),
                      int(count), float(lr), seed, data, draws, num,
                      steps=nb, half=half)


def adam_steps(cfg, model, flat, mu, nu, count, lr, seed, data, draws, num,
               *, steps, half=False):
    """``steps`` train steps under Adam from parameters ``flat`` and
    moments ``mu``, ``nu`` ({leaf: tensor} on the device, not changed)
    after ``count`` steps, on the first ``steps`` batches of the trial
    seeded ``seed``: {"losses", "loss" (their float32 mean), "grad1",
    "change", "end"}, on the CPU."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in flat.items()}
    mu = {k: v.detach().clone() for k, v in mu.items()}
    nu = {k: v.detach().clone() for k, v in nu.items()}
    tree = nest(params)
    Xb, yb = batches(data[0], data[1], seed, cfg["batchsize"])
    device = next(iter(params.values())).device
    acc = torch.zeros((), dtype=torch.float32, device=device)
    losses, grad1 = [], {}
    for i in range(steps):
        rows = cfg["batchsize"] // 2 if half else cfg["batchsize"]
        x = torch.from_numpy(Xb[i][:, :rows]).to(device)
        y = torch.from_numpy(yb[i][:rows]).to(device)
        loss, disc = ref.joint_loss(ref.forward(tree, x, cfg, model, num,
                                                draws), x, y, cfg)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        acc = acc + disc.detach()
        losses.append(float(disc.detach()))
        with torch.no_grad():
            # Adam's bias corrections in float32, as optax computes them
            c = torch.tensor(float(count + i + 1), dtype=torch.float32)
            bc1, bc2 = (1.0 - B1 ** c).to(device), (1.0 - B2 ** c).to(device)
            for (k, p), g in zip(params.items(), grads):
                g = torch.zeros_like(p) if g is None else g
                if i == 0:
                    grad1[k] = g.detach().cpu()
                mu[k].mul_(B1).add_(g, alpha=1.0 - B1)
                nu[k].mul_(B2).addcmul_(g, g, value=1.0 - B2)
                u = (mu[k] / bc1) / ((nu[k] / bc2).sqrt() + EPS)
                p.sub_(lr * u)
    end = {k: p.detach().cpu() for k, p in params.items()}
    return {"losses": losses, "loss": float(acc / steps), "grad1": grad1,
            "change": {k: end[k] - flat[k].detach().cpu() for k in end},
            "end": end}


def nest(flat):
    """{dotted path: tensor} as a nested dict."""
    out = {}
    for path, v in flat.items():
        *head, last = path.split(".")
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def _rebuild(like, flat, prefix=""):
    out = {}
    for k, v in like.items():
        out[k] = (_rebuild(v, flat, f"{prefix}{k}.") if isinstance(v, dict)
                  else flat[f"{prefix}{k}"])
    return out


def eval_y(cfg, model, params, X, device, num):
    """y_hat (n,) of ``params`` (a nested dict) over batch-major X."""
    p = {k: torch.as_tensor(v, dtype=torch.float32).to(device)
         for k, v in leaves(params).items()}
    x = torch.from_numpy(np.ascontiguousarray(
        np.asarray(X, np.float32).swapaxes(0, 1))).to(device)
    return ref.y_hat(_rebuild(params, p), x, cfg, model, num).cpu().numpy()


def plateau_lrs(valids, lr, factor=0.1, patience=10, threshold=1e-4):
    """ReduceLROnPlateau('min') with torch's defaults, in float32, from
    a trial's validation losses: the lr after each epoch."""
    f32 = np.float32
    lr, best, bad = f32(lr), f32(np.inf), 0
    out = []
    for v in valids:
        if f32(v) < best * f32(1.0 - threshold):
            best, bad = f32(v), 0
        else:
            bad += 1
        if bad > patience:
            lr, bad = f32(lr * f32(factor)), 0
        out.append(float(lr))
    return out
