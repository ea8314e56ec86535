from sift_tpu_torch.parallel.dist import batched_detect, sharded_match
from sift_tpu_torch.parallel.mesh import make_mesh
from sift_tpu_torch.parallel.spatial import spatial_detect_and_describe

__all__ = [
    "make_mesh",
    "sharded_match",
    "batched_detect",
    "spatial_detect_and_describe",
]
