"""sift_tpu_torch -- the SIFT pipeline of ``sift_tpu`` in PyTorch + CUDA.

A port of the JAX package to an NVIDIA H100: plain tensor code in PyTorch,
and a hand-written Hopper kernel (csrc/) for each TPU kernel on the main
path.  Entry points run on the card unless the caller passes
``device="cpu"``.  float32 products run in full precision: TF32 stays off,
as the exact-integer matcher and the bit-faithful blur chain require.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from sift_tpu_torch.config import SiftConfig  # noqa: E402
from sift_tpu_torch.models.match import match_descriptors, pairwise_sq_dists  # noqa: E402
from sift_tpu_torch.models.sift import (  # noqa: E402
    detect_and_describe,
    detect_and_describe_batch,
)
from sift_tpu_torch.utils.io import load_image, save_image  # noqa: E402
from sift_tpu_torch.utils.keypoints import Keypoints  # noqa: E402

__all__ = [
    "SiftConfig",
    "Keypoints",
    "detect_and_describe",
    "detect_and_describe_batch",
    "match_descriptors",
    "pairwise_sq_dists",
    "load_image",
    "save_image",
]
