"""Double-buffered host->device frame feed.

The reference's answer to decode/compute overlap is hardware surface
sharing (VAAPI frames mapped into OpenCL, ``opencv/hw_init.cpp:54-69``;
copied when mapping is unavailable, ``opencv/AvFrameSourceMapOpenCl.cpp``).
Here: a reader thread decodes ahead and issues asynchronous
``jax.device_put`` transfers a configurable depth in front of the consumer,
so host->device transfer and device compute overlap with host decode.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_SENTINEL = object()


class DevicePrefetcher:
    """Wrap a planar-YUV frame iterator with device-side prefetch.

    Yields ``(y, u, v)`` as device arrays. ``depth`` frames are in flight
    at any time (decode + transfer happen on a worker thread; the transfers
    themselves are async dispatches). Planes keep their source dtype
    (uint8): transfers stay 4x smaller and the consumer's jit converts
    where needed — an eager per-plane astype would be one more dispatch
    per plane. Pass ``dtype`` to force an (eager) conversion.
    """

    def __init__(
        self,
        frames,
        depth: int = 3,
        dtype=None,
        device: Optional[jax.Device] = None,
    ):
        self._frames = frames
        self._dtype = dtype
        self._device = device or jax.devices()[0]
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            it = iter(self._frames)
            # The stop check must precede next(): pulling another frame
            # after close() races the caller freeing the underlying
            # source (the native loader's handle — a use-after-free, not
            # just a wasted decode).
            while not self._stop.is_set():
                try:
                    y, u, v = next(it)
                except StopIteration:
                    break
                def put(a):
                    out = jax.device_put(np.asarray(a), self._device)
                    if self._dtype is not None:
                        out = out.astype(self._dtype)
                    return out
                self._q.put((put(y), put(u), put(v)))
            self._q.put(_SENTINEL)
        except BaseException as e:  # propagate into the consumer
            self._err = e
            self._q.put(_SENTINEL)

    def __iter__(self) -> Iterator[Tuple[jax.Array, jax.Array, jax.Array]]:
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            yield item

    def close(self):
        """Stop and JOIN the worker before the caller closes the source.

        Returning before the worker exits would let it touch a source the
        caller is about to free (segfault observed with the native
        loader: worker in ``va_next`` while ``va_close`` deletes the
        handle). Drain in a loop — the worker may be blocked in ``put()``
        and enqueue one more item after each drain.
        """
        self._stop.set()
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)


class AsyncFrameWriter:
    """Device->host readback + encode off the hot loop.

    The reverse of :class:`DevicePrefetcher` (the reference's hwdownload
    side): the consumer enqueues device arrays and keeps dispatching; a
    worker thread blocks on the transfers and feeds the underlying writer,
    so readback overlaps with device compute. ``depth`` bounds in-flight
    frames (device memory). Writer/transfer errors surface on the next
    ``put`` or on ``close``.
    """

    def __init__(self, writer, depth: int = 3):
        self._writer = writer
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                return
            if self._err is not None:
                continue  # drain after failure
            try:
                self._writer.write(tuple(np.asarray(p) for p in item))
            except BaseException as e:
                self._err = e

    def write(self, planes):
        if self._err is not None:
            raise self._err
        self._q.put(planes)

    def close(self):
        self._q.put(_SENTINEL)
        self._thread.join()
        if self._err is not None:
            # The worker's error is the root cause; close() after a failed
            # encode often raises a generic secondary error that would
            # mask it. Still attempt the close to release the handle.
            try:
                self._writer.close()
            except Exception:
                pass
            raise self._err
        self._writer.close()


class DeviceReduceSink:
    """Device-resident output consumer: the readback-free sink.

    ``write((y, u, v))`` folds each output frame into a running on-device
    int32 checksum, wrapping by design (one tiny jitted reduce per frame —
    a real data dependency, so the warps it consumes must complete);
    ``close()`` fetches the 4-byte scalar. Used by the decode-overlap benchmark
    (``benchmarks/run.py::bench_e2e_decode_overlap``) so the host->device
    link carries UPLOADS ONLY and the host feed becomes the true wall —
    the overlap claim `e2e >= 0.8 * feed_only` is then falsifiable: a
    serialized pipeline fails it, unlike a readback-bound loop where
    decode is a rounding error. The honest
    ``--no-output`` null sink (which still reads every frame back, like
    ffmpeg's ``-f null``) is unchanged.
    """

    def __init__(self):
        self._acc = None
        self._fn = None
        self.checksum: int = 0

    def write(self, planes):
        import jax
        import jax.numpy as jnp

        if self._fn is None:
            @jax.jit
            def fn(acc, y, u, v):
                return (acc + y.sum(dtype=jnp.int32)
                        + u.sum(dtype=jnp.int32) + v.sum(dtype=jnp.int32))

            self._fn = fn
            self._acc = jnp.int32(0)
        y, u, v = planes
        self._acc = self._fn(self._acc, y, u, v)

    def close(self):
        if self._acc is not None:
            self.checksum = int(self._acc)
