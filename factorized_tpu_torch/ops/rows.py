"""Random draws and batch-coupled terms in a sharded step.

A sharded run must compute what one process computes on the whole
batch and on all K lanes. Two settings say how this process's share
lies in the whole, each None outside a sharded step:

- the data group (``sharded_rows``): this rank holds rows ``[index * n,
  (index + 1) * n)`` of a global batch of ``size * n`` rows
  (``parallel.sharding.Group``: ``size``, ``index``, ``all_gather``);
- the lanes (``lane_index``): the lane this vmapped call computes, out
  of ``n_lanes`` lanes in all (``parallel.multiseed.LanePrograms``).

``draw`` makes every random draw of a train or eval forward: it draws
the global tensor, ``(n_lanes, ...)`` with the global rows, from the
generator (every rank's generator is seeded alike, so every rank draws
the same) and keeps this call's lane and rows. Drawn so, lane k's draw
is the ``k``-th of one ``(K, ...)`` draw, which is what ``torch.func.
vmap(randomness="different")`` draws; the lane programs call with
``randomness="same"`` and let ``draw`` pick the lane.

A sharded step's loss is scaled by the rank's share, ``1 / size``, and
its gradients are summed over the group: a mean over the rank's rows
then sums to the mean over the batch. A term of all the rows at once
(the MMD) reads them through ``gather_rows``: every rank computes the
same term, and the gather's backward keeps this rank's rows of its
gradient times ``size``, so the term's gradient is counted once. A sum
over rows (the KLD) goes through ``row_sum``, times ``size``.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

_ROWS = None
_LANES = None


@contextmanager
def sharded_rows(group):
    """Draws and batch-coupled terms under ``group`` (None: unsharded)."""
    global _ROWS
    old, _ROWS = _ROWS, group
    try:
        yield
    finally:
        _ROWS = old


@contextmanager
def lane_index(n_lanes: int, index):
    """Draws of lane ``index`` (a vmapped 0-d long tensor) of
    ``n_lanes``."""
    global _LANES
    old, _LANES = _LANES, (n_lanes, index)
    try:
        yield
    finally:
        _LANES = old


def draw(op, generator, shape, rows=0, whole=False):
    """``op`` (``torch.rand`` or ``torch.randn``) of ``shape``, this
    call's part of the global draw: its lane, and under a data group the
    global rows along axis ``rows`` cut to this rank's (``whole``: all of
    them, for a term of the whole batch)."""
    shape = list(shape)
    group = _ROWS
    if group is not None:
        n = shape[rows]
        shape[rows] = n * group.size
    dev = generator.device
    if _LANES is None:
        out = op(shape, generator=generator, device=dev)
    else:
        n_lanes, index = _LANES
        out = op([n_lanes, *shape], generator=generator, device=dev)[index]
    if group is not None and not whole:
        out = out.narrow(rows, group.index * n, n)
    return out


def gather_rows(z, axis=0):
    """``z``'s rows of every rank of the data group along ``axis``, in
    rank order; ``z`` itself outside one."""
    if _ROWS is None:
        return z
    return GatherShards.apply(z, axis, _ROWS, float(_ROWS.size))


def row_sum(x):
    """A sum over this rank's rows as its part of the step's loss (see the
    module's doc)."""
    return x if _ROWS is None else x * _ROWS.size


class GatherShards(torch.autograd.Function):
    """The all-gather of ``z`` along ``axis`` over ``group``, in rank
    order; its backward keeps this rank's slice of the gradient times
    ``scale``: ``size`` for rows (``gather_rows``), 1 for a weight's
    columns in tensor parallelism (``sharding.TensorParallel``). Under
    ``torch.func.vmap`` it gathers the lanes at once."""

    @staticmethod
    def forward(z, axis, group, scale):
        return group.all_gather(z, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        z, axis, group, scale = inputs
        ctx.axis, ctx.group, ctx.scale = axis, group, scale
        ctx.n = z.shape[axis]

    @staticmethod
    def backward(ctx, grad):
        g = grad.narrow(ctx.axis, ctx.group.index * ctx.n, ctx.n)
        return g * ctx.scale, None, None, None

    @staticmethod
    def vmap(info, in_dims, z, axis, group, scale):
        if in_dims[0] is None:
            return GatherShards.apply(z, axis, group, scale), None
        z = z.movedim(in_dims[0], 0)
        return GatherShards.apply(z, axis + 1, group, scale), 0
