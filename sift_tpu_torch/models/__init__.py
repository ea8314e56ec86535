"""The pipeline's stages (the JAX package's ``sift_tpu.models`` names)."""

from sift_tpu_torch.models.match import match_descriptors
from sift_tpu_torch.models.sift import detect_and_describe

__all__ = ["detect_and_describe", "match_descriptors"]
