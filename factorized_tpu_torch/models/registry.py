"""Model registry: string dispatch on ``cfg.model_type`` (port of
``factorized_tpu/models/registry.py``). Ported: ``mfm``, ``kl``,
``kl_ef``, ``missing`` and the ablations ``m_a``..``m_d``.

Apply returns, as in the JAX package: ``mfm``, ``kl``, ``kl_ef`` and the
ablations give ``(decoded, reg_loss, missing_loss)``; ``missing`` gives
``(decoded, nol, noa, nov, mmd, missing_loss)``."""

from __future__ import annotations

from factorized_tpu_torch.models import ablations, mfm

MODELS = {
    "mfm": (mfm.mfm_init, mfm.mfm_apply),
    "kl": (mfm.mfm_kl_init, mfm.mfm_kl_apply),
    "kl_ef": (mfm.mfm_kl_ef_init, mfm.mfm_kl_ef_apply),
    "missing": (mfm.mfm_missing_init, mfm.mfm_missing_apply),
    "m_a": (ablations.m_a_init, ablations.m_a_apply),
    "m_b": (ablations.m_b_init, ablations.m_b_apply),
    "m_c": (ablations.m_c_init, ablations.m_c_apply),
    "m_d": (ablations.m_d_init, ablations.m_d_apply),
}

# names the JAX package registers that this port does not have yet
NOT_YET_PORTED = ("s2s", "bm", "mfn")


def get_model(name: str):
    """(init, apply) for a model type."""
    if name in MODELS:
        return MODELS[name]
    if name in NOT_YET_PORTED:
        raise NotImplementedError(f"model type {name!r} is not yet ported")
    raise ValueError(f"unknown model type {name!r}; known: "
                     f"{sorted(MODELS) + list(NOT_YET_PORTED)}")
