"""Model registry: string dispatch on ``cfg.model_type`` (port of
``factorized_tpu/models/registry.py``). Ported: ``mfm``, ``kl``,
``kl_ef``, ``missing``, the ablations ``m_a``..``m_d``, the baselines
``s2s`` and ``bm``, and ``mfn``, the standalone MFN predictor. As in the
JAX package, ``eflstm`` and ``self_attention`` are not registered: their
trees take ``d``, ``h`` and ``t`` rather than a config
(``models.baselines``).

Apply returns, as in the JAX package: ``mfm``, ``kl``, ``kl_ef`` and the
ablations give ``(decoded, reg_loss, missing_loss)``; ``missing`` gives
``(decoded, nol, noa, nov, mmd, missing_loss)``; ``s2s`` gives ``(nol,
noa, nov, mmd)``, each a one-element list of a reconstruction; ``bm``
gives ``(y_nol, y_noa, y_nov, mmd)``; ``mfn`` gives its logits ``(n,
output_dim)``."""

from __future__ import annotations

from factorized_tpu_torch.models import ablations, baselines, mfm

MODELS = {
    "mfm": (mfm.mfm_init, mfm.mfm_apply),
    "kl": (mfm.mfm_kl_init, mfm.mfm_kl_apply),
    "kl_ef": (mfm.mfm_kl_ef_init, mfm.mfm_kl_ef_apply),
    "missing": (mfm.mfm_missing_init, mfm.mfm_missing_apply),
    "m_a": (ablations.m_a_init, ablations.m_a_apply),
    "m_b": (ablations.m_b_init, ablations.m_b_apply),
    "m_c": (ablations.m_c_init, ablations.m_c_apply),
    "m_d": (ablations.m_d_init, ablations.m_d_apply),
    "s2s": (baselines.seq2seq_init, baselines.seq2seq_apply),
    "bm": (baselines.basic_missing_init, baselines.basic_missing_apply),
    "mfn": (baselines.mfn_predictor_init, baselines.mfn_predictor_apply),
}

# names the JAX package registers that this port does not have yet
NOT_YET_PORTED = ()


def get_model(name: str):
    """(init, apply) for a model type."""
    if name in MODELS:
        return MODELS[name]
    if name in NOT_YET_PORTED:
        raise NotImplementedError(f"model type {name!r} is not yet ported")
    raise ValueError(f"unknown model type {name!r}; known: "
                     f"{sorted(MODELS) + list(NOT_YET_PORTED)}")
