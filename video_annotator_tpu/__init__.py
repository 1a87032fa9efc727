"""video_annotator_tpu — a JAX/XLA video stabilization framework.

A ground-up rebuild of the capabilities of ``hedgepigdaniel/video-annotator``
(fisheye action-camera stabilization + reprojection) on one accelerator:

- ``camera`` / ``so3``: pure-JAX camera models (rectilinear + equidistant
  fisheye) and SO(3) utilities (the math inside the reference's
  ``opencv/createMap.cl`` and ``opencv/FrameSourceWarp.cpp``).
- ``ops``: compute kernels — fused map-generation + remap warp (plain
  XLA), Shi-Tomasi corners, pyramidal Lucas-Kanade optical flow, batched
  rotation RANSAC.
- ``smoothing``: Savitzky-Golay on SO(3), Kalman, and GPMF-gyro-driven
  trajectory filters as ``lax.scan``-able transforms.
- ``models``: stabilizer families mirroring the reference's filter choices
  (``dewobble``-style SO(3) rotation stabilizer — the flagship — plus 2D
  similarity/``vidstab``-style and block-matching ``deshake``-style).
- ``io``: host-side decode/encode front-ends (OpenCV-FFmpeg, Y4M, raw NV12),
  GoPro segment join, GPMF metadata parsing, double-buffered device feed.
- ``pipeline``: two-phase analyse/encode rendering, trajectory persistence
  (the ``.trf`` analogue), comparison grids, per-stage profiler.
- ``parallel``: device-mesh sharding — data-parallel over streams, spatial
  sharding of the warp grid, temporal sharding with smoother halos.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Persistent executable cache: every CLI invocation is a fresh process,
# and the 4K warp and analyse executables take seconds to compile. JAX
# itself honours JAX_COMPILATION_CACHE_DIR; without it the cache lives in
# the checkout (``.jax_cache``, git-ignored) at a fixed path, so reruns
# hit it. Opt out with VAT_NO_COMPILE_CACHE=1.
if not (_os.environ.get("VAT_NO_COMPILE_CACHE")
        or _os.environ.get("JAX_COMPILATION_CACHE_DIR")):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache",
        ),
    )

from video_annotator_tpu.camera import (  # noqa: F401
    Camera,
    CameraModel,
    CameraPreset,
    get_output_camera,
    get_preset_camera,
)
