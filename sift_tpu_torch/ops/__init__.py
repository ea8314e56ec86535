"""Image operations on tensors (the JAX package's ``sift_tpu.ops`` names);
the kernel wrappers live in the modules beside them."""

from sift_tpu_torch.ops.blur import gaussian_blur, separable_blur
from sift_tpu_torch.ops.color import to_grayscale
from sift_tpu_torch.ops.resize import downsample_nearest_x2, upsample_bilinear

__all__ = [
    "to_grayscale",
    "downsample_nearest_x2",
    "upsample_bilinear",
    "gaussian_blur",
    "separable_blur",
]
