"""Video reader/writer front-ends.

Replaces the reference's decode/encode plumbing (VAAPI hardware decode +
hwframe transfers, ``opencv/AvFrameSourceFileVaapi.cpp``; libx264 encode at
QP 19, ``src/render.ts:12-19``) with host-side decode streaming planar
YUV 4:2:0 numpy frames:

- ``.y4m``: pure-Python, lossless raw (no external deps);
- everything else (``.mp4`` etc.): OpenCV's FFMPEG backend;
- ``synthetic://...``: the ground-truth generator (``io/synthetic.py``).

All readers yield ``(y, u, v)`` uint8 planes; all writers accept them.
The device feed path (``io/prefetch.py``) double-buffers these into
device memory.
"""

from __future__ import annotations

import dataclasses
import os
from fractions import Fraction
from typing import Iterator, Optional, Tuple

import numpy as np

from video_annotator_tpu.io import y4m as y4m_mod

Planes = Tuple[np.ndarray, np.ndarray, np.ndarray]


@dataclasses.dataclass
class VideoMeta:
    """Probe data the planner needs (the ffprobe analogue,
    ``src/render.ts:1298-1322``)."""

    width: int
    height: int
    fps: Fraction
    num_frames: Optional[int] = None


def bgr_to_yuv420(bgr: np.ndarray) -> Planes:
    import cv2

    h, w = bgr.shape[:2]
    i420 = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV_I420)
    # Parse via the flat buffer: per-plane row alignment in the stacked
    # I420 image only works when h % 4 == 0, but the data layout is always
    # plane-contiguous.
    flat = i420.reshape(-1)
    cs = (h // 2) * (w // 2)
    y = flat[: h * w].reshape(h, w)
    u = flat[h * w : h * w + cs].reshape(h // 2, w // 2)
    v = flat[h * w + cs :].reshape(h // 2, w // 2)
    return y, u, v


def yuv420_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    import cv2

    h, w = y.shape
    flat = np.concatenate(
        [np.ascontiguousarray(p, np.uint8).reshape(-1) for p in (y, u, v)]
    )
    i420 = flat.reshape(h * 3 // 2, w)
    return cv2.cvtColor(i420, cv2.COLOR_YUV2BGR_I420)


class _Y4MSource:
    def __init__(self, path: str, start_frame: int = 0):
        self._r = y4m_mod.Y4MReader(path)
        h = self._r.header
        # Frame count from the file size (fixed-size frames after the header).
        # Frame markers may carry parameters ("FRAME Ip\n"); measure the
        # first marker's real length instead of assuming bare "FRAME\n".
        header_len = self._r._f.tell()
        fsz = os.path.getsize(path)
        marker = self._r._f.readline()
        self._r._f.seek(header_len)
        mlen = len(marker) if marker.startswith(b"FRAME") else 6
        frame_bytes = h.width * h.height * 3 // 2 + mlen
        self.meta = VideoMeta(
            h.width, h.height, h.fps, int(max(fsz - header_len, 0) // frame_bytes)
        )
        # Fixed-size frames make trim seeks byte-exact; a marker check
        # guards against variable-length FRAME parameter lines.
        self.start_frame = 0
        if start_frame > 0:
            pos = header_len + start_frame * frame_bytes
            self._r._f.seek(pos)
            probe = self._r._f.read(5)
            if probe == b"FRAME":
                self._r._f.seek(pos)
                self.start_frame = start_frame
            else:
                self._r._f.seek(header_len)

    def __iter__(self) -> Iterator[Planes]:
        return iter(self._r)

    def close(self):
        self._r.close()


class _CvSource:
    def __init__(self, path: str, start_frame: int = 0):
        import cv2

        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise FileNotFoundError(f"cannot open video: {path}")
        w = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        fps = self._cap.get(cv2.CAP_PROP_FPS) or 30.0
        n = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.meta = VideoMeta(w, h, Fraction(fps).limit_denominator(1001), n or None)
        self.start_frame = 0
        if start_frame > 0:
            # OpenCV's FFMPEG backend seeks then decodes forward from the
            # keyframe internally, so positioning is frame-exact.
            if self._cap.set(cv2.CAP_PROP_POS_FRAMES, start_frame) and int(
                self._cap.get(cv2.CAP_PROP_POS_FRAMES)
            ) == start_frame:
                self.start_frame = start_frame

    def __iter__(self) -> Iterator[Planes]:
        while True:
            ok, bgr = self._cap.read()
            if not ok:
                return
            yield bgr_to_yuv420(bgr)

    def close(self):
        self._cap.release()


def open_reader(path: str, prefer_native: bool = True, start_frame: int = 0):
    """Open a video source; returns an object with ``.meta``, ``__iter__``
    yielding (y, u, v) uint8 planes, and ``.start_frame`` — the source
    index of the first yielded frame.

    ``start_frame`` requests a trim seek (the ffmpeg ``-ss`` the
    reference's trimmed renders use): honored exactly by the native libav
    loader (keyframe seek + pts drop window), the cv2 backend
    (``CAP_PROP_POS_FRAMES``) and y4m (fixed-size frames). Sources that
    cannot seek report ``start_frame == 0`` and the caller skips frames
    itself — iterate with ``enumerate(reader, start=reader.start_frame)``.

    Compressed files prefer the threaded C++/libav loader
    (``io/native.py``) when built, falling back to OpenCV's reader.
    """
    if path.startswith("synthetic://"):
        from video_annotator_tpu.io.synthetic import SyntheticSource

        src = SyntheticSource.from_uri(path)
        src.start_frame = 0
        return src
    if path.endswith(".y4m"):
        return _Y4MSource(path, start_frame=start_frame)
    if prefer_native:
        try:
            from video_annotator_tpu.io.native import (
                NativeVideoSource,
                native_available,
            )

            if native_available():
                return NativeVideoSource(path, start_frame=start_frame)
        except (FileNotFoundError, RuntimeError, OSError):
            pass
    return _CvSource(path, start_frame=start_frame)


class _Y4MSink:
    def __init__(self, path: str, meta: VideoMeta):
        self._w = y4m_mod.Y4MWriter(path, meta.width, meta.height, meta.fps)

    def write(self, planes: Planes):
        self._w.write(*planes)

    def close(self):
        self._w.close()


class _FfmpegSink:
    """Escape hatch for encoders this host cannot drive natively
    (h264_vaapi / h264_nvenc / h264_amf / hevc_* — the reference's
    hardware-encode targets, ``src/render.ts:275-281``,
    ``concat.sh:216,323``): pipe Y4M into an ``ffmpeg`` binary that owns
    the hardware encoder. It only engages when an ffmpeg binary is on
    PATH."""

    def __init__(self, path: str, meta: VideoMeta, encoder: str,
                 qp: int = 19, binary: Optional[str] = None):
        import shutil
        import subprocess

        ffmpeg = binary or shutil.which("ffmpeg")
        if ffmpeg is None:
            raise ValueError(
                f"encoder {encoder!r} is not built in (native: libx264/"
                f"libx265/mpeg4; cv2 fourcc: 4-char names) and no ffmpeg "
                f"binary is on PATH to delegate to")
        cmd = [ffmpeg, "-y", "-loglevel", "error"]
        if "vaapi" in encoder:
            # The reference's VAAPI encode shape (concat.sh:216): device
            # init + hwupload ahead of the encoder.
            cmd += ["-vaapi_device", "/dev/dri/renderD128"]
        cmd += ["-f", "yuv4mpegpipe", "-i", "pipe:0"]
        if "vaapi" in encoder:
            cmd += ["-vf", "format=nv12,hwupload"]
        cmd += ["-c:v", encoder, "-qp", str(qp), path]
        self._proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)
        self._path = path
        self._pipe = y4m_mod.Y4MWriter(
            self._proc.stdin, meta.width, meta.height, meta.fps)

    def write(self, planes: Planes):
        try:
            self._pipe.write(*planes)
        except BrokenPipeError:
            self._proc.wait()
            raise RuntimeError(
                f"delegated ffmpeg encoder exited early "
                f"(rc={self._proc.returncode}) writing {self._path}")

    def close(self):
        if self._proc is None:
            return
        proc, self._proc = self._proc, None
        try:
            self._pipe.close()
        except BrokenPipeError:
            pass
        rc = proc.wait()
        if rc != 0:
            raise RuntimeError(
                f"delegated ffmpeg encode of {self._path} failed (rc={rc})")


class _CvSink:
    """Encode via OpenCV-FFMPEG (mp4v/avc1). The reference's default encoder
    is libx264 with constant QP 19 (``src/render.ts:12-19``); OpenCV's
    writer API has no QP knob, so this is bitrate-default — the CLI exposes
    ``--encoder`` to pick the fourcc."""

    def __init__(self, path: str, meta: VideoMeta, fourcc: str = "mp4v"):
        import cv2

        self._wr = cv2.VideoWriter(
            path,
            cv2.VideoWriter_fourcc(*fourcc),
            float(meta.fps),
            (meta.width, meta.height),
        )
        if not self._wr.isOpened():
            raise RuntimeError(f"cannot open encoder for {path} ({fourcc})")

    def write(self, planes: Planes):
        self._wr.write(yuv420_to_bgr(*planes))

    def close(self):
        self._wr.release()


class _NullSink:
    """``--no-output`` (``src/cli.ts:123-131``): run the pipeline, discard."""

    def write(self, planes: Planes):
        pass

    def close(self):
        pass


# Encoder names routed to the native libav writer (libx264 at constant
# QP 19 — the reference's "visually lossless" setting, src/render.ts:12-19).
# 4-char fourcc names (mp4v, avc1, ...) keep going through OpenCV.
_NATIVE_ENCODERS = {"libx264", "x264", "h264", "libx265", "hevc", "mpeg4"}


def default_encoder() -> str:
    """libx264 when the native writer is built (the reference's default,
    ``src/cli.ts:120``); OpenCV's mp4v otherwise."""
    try:
        from video_annotator_tpu.io.native import native_writer_available

        if native_writer_available():
            return "libx264"
    except Exception:
        pass
    return "mp4v"


def open_writer(path: Optional[str], meta: VideoMeta, encoder: str = "mp4v",
                copy_streams_from: Optional[str] = None,
                trim_start: float = 0.0, trim_end: float = -1.0,
                allow_native: bool = True):
    """Open a frame sink. ``copy_streams_from`` stream-copies the source's
    audio and GPMF data tracks into the output container (native writer
    only; the reference maps them in ``src/join.ts:56-82``), restricted to
    the ``[trim_start, trim_end)`` source window (seconds)."""
    if path is None:
        return _NullSink()
    if path.endswith(".y4m"):
        return _Y4MSink(path, meta)
    # Alias map from fourccs/common names to libav encoder names — the C
    # side's lookup would otherwise miss and silently substitute libx264.
    native_name = {
        "x264": "libx264", "h264": "libx264", "avc1": "libx264",
        "mp4v": "mpeg4", "hevc": "libx265", "hvc1": "libx265",
        "x265": "libx265",
    }.get(encoder, encoder if encoder in _NATIVE_ENCODERS else None)
    if allow_native and (encoder in _NATIVE_ENCODERS
                         or (copy_streams_from is not None
                             and native_name is not None)):
        try:
            from video_annotator_tpu.io.native import (
                NativeVideoWriter,
                native_writer_available,
            )

            if native_writer_available():
                return NativeVideoWriter(
                    path, meta, encoder=native_name, qp=19,
                    copy_streams_from=copy_streams_from,
                    trim_start=trim_start, trim_end=trim_end,
                )
        except (RuntimeError, OSError) as e:
            import sys

            print(
                f"warning: native writer unavailable for {path} ({e}); "
                "falling back to cv2 (bitrate-default, no stream "
                "passthrough)",
                file=sys.stderr,
            )
    if encoder not in _NATIVE_ENCODERS and len(encoder) != 4:
        # Not built in and not a cv2 fourcc: a hardware/exotic encoder name
        # (h264_vaapi, hevc_nvenc, ...). Delegate to an ffmpeg binary
        # rather than silently substituting libx264 (which is what the
        # native writer's C-side codec lookup would do) or mp4v.
        if copy_streams_from is not None:
            import sys

            print(
                f"warning: --encoder {encoder!r} is not a built-in codec; "
                "encoding WITHOUT audio/GPMF stream passthrough",
                file=sys.stderr,
            )
        return _FfmpegSink(path, meta, encoder)
    return _CvSink(path, meta, fourcc=encoder if len(encoder) == 4 else "mp4v")
