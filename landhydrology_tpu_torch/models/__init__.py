"""Model families (soil)."""

from landhydrology_tpu_torch.models.base import AbstractModel

__all__ = ["AbstractModel"]
