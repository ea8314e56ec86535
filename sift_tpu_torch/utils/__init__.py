"""Host-side helpers (the JAX package's ``sift_tpu.utils`` names)."""

from sift_tpu_torch.utils.keypoints import Keypoints
from sift_tpu_torch.utils.numerics import round_half_away

__all__ = ["round_half_away", "Keypoints"]
