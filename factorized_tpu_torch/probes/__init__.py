"""Probes of the encode backward's design on the card, ported from the JAX
package's ``scripts/bwd_residual_probe.py`` and
``scripts/twostep_bwd_probe.py``. Each is run as
``python -m factorized_tpu_torch.probes.<name>`` (``--device cpu`` for the
CPU) and ends with one JSON line."""
