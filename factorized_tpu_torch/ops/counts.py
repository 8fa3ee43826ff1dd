"""The kernel wrappers' launch counters, taken and added to as a whole.

Each wrapper of ``cuda_mfn`` and ``cuda_lstm`` adds one to its module's
``*_LAUNCHES`` counter where it launches its kernel (``L2_LAUNCHES`` is
a dict by wrapper). A CUDA graph replays its kernels without calling the
wrappers, so a captured graph keeps what its capture counted
(``since``), gives the counters back their values from before the
capture, which launched nothing (``restore``), and adds its counts at
each replay (``add``).
"""

from __future__ import annotations

from typing import Optional

from factorized_tpu_torch.ops import cuda_lstm, cuda_mfn

MODULES = (cuda_mfn, cuda_lstm)


def _names(module):
    return [a for a in vars(module) if a.endswith("LAUNCHES")]


def snapshot() -> dict:
    """Every counter now: {(module, attribute): an int, or a dict's
    copy}."""
    return {(m, a): (dict(v) if isinstance(v, dict) else v)
            for m in MODULES for a in _names(m)
            for v in (getattr(m, a),)}


def since(before: dict, after: Optional[dict] = None) -> dict:
    """The launches counted after ``before`` (a ``snapshot``), up to now
    or to the snapshot ``after``."""
    out = {}
    for key, now in (after or snapshot()).items():
        old = before[key]
        out[key] = ({k: v - old.get(k, 0) for k, v in now.items()}
                    if isinstance(now, dict) else now - old)
    return out


def add(delta: dict):
    """Adds ``delta`` (of ``since``) to the counters."""
    for (m, a), d in delta.items():
        if isinstance(d, dict):
            counter = getattr(m, a)
            for k, v in d.items():
                counter[k] = counter.get(k, 0) + v
        else:
            setattr(m, a, getattr(m, a) + d)


def restore(snap: dict):
    """Sets every counter back to ``snap``."""
    for (m, a), v in snap.items():
        if isinstance(v, dict):
            getattr(m, a).clear()
            getattr(m, a).update(v)
        else:
            setattr(m, a, v)


def named(delta: dict) -> dict:
    """``delta`` (of ``since``) keyed ``"module.COUNTER"`` (``"cuda_mfn.
    LAUNCHES"``; a per-kernel counter, such as ``LANE_LAUNCHES``, as a
    dict of its nonzero counts): picklable, for a result written by
    another process."""
    return {f"{m.__name__.rsplit('.', 1)[-1]}.{a}":
            ({k: int(n) for k, n in v.items() if n} if isinstance(v, dict)
             else int(v))
            for (m, a), v in delta.items()}
