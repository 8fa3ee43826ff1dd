"""Model families of the port; ``get_model`` dispatches on the name."""

from factorized_tpu_torch.models.registry import get_model

__all__ = ["get_model"]
