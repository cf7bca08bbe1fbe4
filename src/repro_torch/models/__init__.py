"""Model zoo of the port (dense GQA decoder so far)."""
from repro_torch.models.model import DepthSegment, Model

__all__ = ["DepthSegment", "Model"]
