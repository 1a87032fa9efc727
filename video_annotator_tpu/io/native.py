"""ctypes bindings for the native (C++/libav) decode front-end.

``native/loader.cpp`` demuxes + decodes on a dedicated thread (plus
libavcodec's internal frame threading) into a planar-YUV ring buffer — the
reference's native decode chain (``opencv/AvFrameSourceFileVaapi.cpp`` ff.)
rebuilt for a host-CPU -> accelerator pipeline. Falls back silently when the shared
library hasn't been built (``make -C native``).
"""

from __future__ import annotations

import ctypes
import os
import threading
from fractions import Fraction
from typing import Iterator, Optional, Tuple

import numpy as np

from video_annotator_tpu.io.video import VideoMeta

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libvaloader.so")

_u8p = ctypes.POINTER(ctypes.c_uint8)

# One signature table per shared library: {symbol: (restype, argtypes)}.
# A symbol prefixed with '?' is optional (older builds of the .so).
_LOADER_SIG = {
    "va_open": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int]),
    "?va_open_seek": (
        ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int, ctypes.c_long]),
    "?va_start_frame": (ctypes.c_long, [ctypes.c_void_p]),
    "va_meta": (
        ctypes.c_int,
        [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int)] * 4
        + [ctypes.POINTER(ctypes.c_long)]),
    "va_next": (ctypes.c_int, [ctypes.c_void_p] + [_u8p] * 3),
    "va_close": (None, [ctypes.c_void_p]),
    "va_frame_index": (ctypes.c_long, [ctypes.c_void_p]),
    "va_error": (ctypes.c_char_p, [ctypes.c_void_p]),
}
_WRITER_SIG = {
    "vaw_open": (
        ctypes.c_void_p,
        [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
         ctypes.c_double, ctypes.c_double, ctypes.c_int]),
    "vaw_write": (ctypes.c_int, [ctypes.c_void_p] + [_u8p] * 3),
    "vaw_close": (ctypes.c_int, [ctypes.c_void_p]),
    "vaw_error": (ctypes.c_char_p, [ctypes.c_void_p]),
}
_CONCAT_SIG = {
    "va_concat": (
        ctypes.c_int,
        [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_char_p]),
    "va_concat_error": (ctypes.c_char_p, []),
}

_lib_cache: dict = {}
_build_attempted = False


def _try_build() -> None:
    """Best-effort one-shot ``make -C native`` when a .so is missing.

    The shared libraries are build artifacts (not tracked in git); a fresh
    checkout builds them on first use so the native decode/encode paths and
    their tests keep working without a manual build step.
    """
    global _build_attempted
    if _build_attempted:
        return
    _build_attempted = True
    if os.environ.get("VAT_NATIVE_AUTOBUILD", "1") == "0":
        return
    import subprocess
    import sys

    print(f"[vat] native libs missing; building (make -C {_NATIVE_DIR}; "
          "set VAT_NATIVE_AUTOBUILD=0 to skip)", file=sys.stderr)
    try:
        res = subprocess.run(
            ["make", "-C", _NATIVE_DIR, "all"],
            capture_output=True, timeout=120, check=False,
        )
        if res.returncode != 0:
            tail = res.stderr.decode(errors="replace").strip().splitlines()
            print("[vat] native build FAILED: "
                  + (tail[-1] if tail else f"rc={res.returncode}"),
                  file=sys.stderr)
    except (OSError, subprocess.TimeoutExpired) as e:
        print(f"[vat] native build FAILED: {e!r}", file=sys.stderr)


def _load(path: str, signatures: dict):
    """CDLL + bind the signature table; None (cached) if absent/unloadable."""
    if path in _lib_cache:
        return _lib_cache[path]
    if not os.path.exists(path):
        _try_build()
    lib = None
    if os.path.exists(path):
        try:
            lib = ctypes.CDLL(path)
            for name, (restype, argtypes) in signatures.items():
                optional = name.startswith("?")
                sym = name[1:] if optional else name
                if optional and not hasattr(lib, sym):
                    continue
                fn = getattr(lib, sym)
                fn.restype = restype
                fn.argtypes = argtypes
        except OSError:
            lib = None
    _lib_cache[path] = lib
    return lib


def load_library():
    return _load(_LIB_PATH, _LOADER_SIG)


def native_available() -> bool:
    return load_library() is not None


class NativeVideoSource:
    """Reader-compatible source backed by the C++ loader.

    ``start_frame`` trims at the demuxer: keyframe-backward seek plus a
    pts-exact decode-and-drop window in C (the ffmpeg ``-ss`` analogue the
    reference's trimmed renders rely on, ``src/render.ts:1369-1373``).
    Iteration then begins at source frame ``self.start_frame``.
    """

    def __init__(self, path: str, ring_frames: int = 8,
                 start_frame: int = 0):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native loader not built (make -C native)")
        self._lib = lib
        # Serializes va_next against va_close: closing frees the C-side
        # Loader (ring, mutex, condvar), so it must never run while a
        # va_next is blocked inside it. The decode thread keeps pushing
        # frames (or EOF), so a pending va_next always returns and a
        # concurrent close() waits briefly rather than use-after-freeing.
        self._lock = threading.Lock()
        if start_frame > 0 and hasattr(lib, "va_open_seek"):
            self._h = lib.va_open_seek(path.encode(), ring_frames,
                                       int(start_frame))
            self.start_frame = int(start_frame)
        else:
            self._h = lib.va_open(path.encode(), ring_frames)
            self.start_frame = 0
        if not self._h:
            raise FileNotFoundError(f"native loader cannot open {path}")
        w = ctypes.c_int()
        h = ctypes.c_int()
        fn = ctypes.c_int()
        fd = ctypes.c_int()
        n = ctypes.c_long()
        lib.va_meta(self._h, w, h, fn, fd, n)
        self.meta = VideoMeta(
            w.value, h.value,
            Fraction(fn.value or 30, fd.value or 1),
            n.value or None,
        )

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        w, h = self.meta.width, self.meta.height
        u8p = ctypes.POINTER(ctypes.c_uint8)
        while True:
            y = np.empty((h, w), np.uint8)
            u = np.empty((h // 2, w // 2), np.uint8)
            v = np.empty((h // 2, w // 2), np.uint8)
            with self._lock:
                if not self._h:  # concurrently closed: end iteration
                    return
                r = self._lib.va_next(
                    self._h,
                    y.ctypes.data_as(u8p),
                    u.ctypes.data_as(u8p),
                    v.ctypes.data_as(u8p),
                )
                if r < 0:
                    # Decode errors must not pass as clean EOF: a
                    # truncated file would otherwise silently render a
                    # short output.
                    err = self._lib.va_error(self._h)
                    raise RuntimeError(
                        f"native decode failed: "
                        f"{err.decode() if err else r}"
                    )
            if r != 1:
                return
            yield y, u, v

    def close(self):
        with self._lock:
            if self._h:
                self._lib.va_close(self._h)
                self._h = None


_WRITER_LIB_PATH = os.path.join(_NATIVE_DIR, "libvawriter.so")


def load_writer_library():
    return _load(_WRITER_LIB_PATH, _WRITER_SIG)


def native_writer_available() -> bool:
    return load_writer_library() is not None


class NativeVideoWriter:
    """Sink backed by the C++ encoder (libx264 QP 19 by default).

    The reference's encode semantics: ``-c:v libx264 -qp 19`` (visually
    lossless, ``src/render.ts:12-19``) with the source's audio and GPMF
    data tracks stream-copied alongside (``src/join.ts:56-82``). Pass
    ``copy_streams_from`` (and the trim window, source-time seconds) to
    enable the passthrough.
    """

    def __init__(self, path: str, meta: VideoMeta, encoder: str = "libx264",
                 qp: int = 19, copy_streams_from: Optional[str] = None,
                 trim_start: float = 0.0, trim_end: float = -1.0,
                 ring_frames: int = 8):
        lib = load_writer_library()
        if lib is None:
            raise RuntimeError("native writer not built (make -C native)")
        self._lib = lib
        self._w, self._h2 = meta.width, meta.height
        # The C ABI takes the rate as int32 num/den. A float fps like
        # 29.97 has a 50-bit exact numerator that ctypes would SILENTLY
        # truncate into a garbage timebase — bound the fraction (1001
        # covers the NTSC family exactly) and range-check.
        fps = Fraction(meta.fps).limit_denominator(1001)
        if not (0 < fps.numerator < 2**31 and 0 < fps.denominator < 2**31):
            raise ValueError(f"unrepresentable fps {meta.fps!r}")
        self._handle = lib.vaw_open(
            path.encode(), meta.width, meta.height,
            fps.numerator, fps.denominator, encoder.encode(), qp,
            copy_streams_from.encode() if copy_streams_from else None,
            float(trim_start), float(trim_end), ring_frames,
        )
        if not self._handle:
            raise RuntimeError(
                f"native writer cannot open {path} ({encoder})"
            )

    def write(self, planes):
        y, u, v = (np.ascontiguousarray(p, np.uint8) for p in planes)
        # The C side memcpys w*h (resp. w*h/4) bytes from each pointer —
        # an undersized plane would read out of bounds. Real checks, not
        # asserts: `python -O` strips asserts and this guards a memcpy.
        if (y.shape != (self._h2, self._w)
                or u.shape != (self._h2 // 2, self._w // 2)
                or v.shape != (self._h2 // 2, self._w // 2)):
            raise ValueError(
                f"plane shapes {y.shape}/{u.shape}/{v.shape} do not match "
                f"writer geometry {self._w}x{self._h2}")
        u8p = ctypes.POINTER(ctypes.c_uint8)
        r = self._lib.vaw_write(
            self._handle, y.ctypes.data_as(u8p), u.ctypes.data_as(u8p),
            v.ctypes.data_as(u8p),
        )
        if r != 1:
            err = self._lib.vaw_error(self._handle)
            raise RuntimeError(
                f"native encode failed: {err.decode() if err else r}"
            )

    def close(self):
        if self._handle:
            h, self._handle = self._handle, None
            status = self._lib.vaw_close(h)
            if status != 0:
                raise RuntimeError(f"native writer close failed ({status})")


_CONCAT_LIB_PATH = os.path.join(_NATIVE_DIR, "libvaconcat.so")


def load_concat_library():
    return _load(_CONCAT_LIB_PATH, _CONCAT_SIG)


def native_concat_available() -> bool:
    return load_concat_library() is not None


def native_concat(segments, output: str) -> None:
    """Lossless stream-copy concat of homogeneous segments (video +
    audio + GPMF data tracks) — the reference's `join`
    (``src/join.ts:59-82``), without an ffmpeg binary."""
    lib = load_concat_library()
    if lib is None:
        raise RuntimeError("native concat not built (make -C native)")
    arr = (ctypes.c_char_p * len(segments))(
        *[s.encode() for s in segments]
    )
    if lib.va_concat(arr, len(segments), output.encode()) != 0:
        err = lib.va_concat_error()
        raise RuntimeError(
            f"native concat failed: {err.decode() if err else 'unknown'}"
        )
