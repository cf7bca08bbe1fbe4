"""Model zoo of the port (dense GQA and MLA + MoE decoders so far)."""
from repro_torch.models.model import DepthSegment, Model, ModelOutputs

__all__ = ["DepthSegment", "Model", "ModelOutputs"]
