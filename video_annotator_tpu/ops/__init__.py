"""Compute kernels: warp, corners, optical flow, RANSAC (plain XLA)."""

from video_annotator_tpu.ops.warp_xla import (  # noqa: F401
    bilinear_sample,
    compute_warp_map,
    warp_image_xla,
    warp_yuv420_xla,
)
