"""Multi-chip scaling: device meshes, sharded pipeline stages.

The reference's parallelism is process-level (N concurrent ffmpeg processes,
``src/render.ts:21-22``; xargs -P in ``concat.sh:197-219``) on one GPU. The
device-mesh equivalents (SURVEY.md section 2.4):

- data parallel: batch of independent streams sharded over the ``data``
  mesh axis (``parallel/streams.py``);
- temporal (sequence) parallel: the frame-time axis sharded over ``time``
  with a ``smooth_radius`` halo exchanged between neighbors — the analogue
  of context parallelism for this workload (``parallel/temporal.py``);
- spatial (tensor) parallel: the warp's output pixel grid sharded over
  ``space`` (``parallel/pipeline.py``, ``parallel/streams.py``).
"""

from video_annotator_tpu.parallel.mesh import make_mesh  # noqa: F401
from video_annotator_tpu.parallel.temporal import (  # noqa: F401
    distributed_accumulate_rotations,
    smooth_rotations_sharded,
)
