"""Request-level serving front end: dynamic batching over the pipeline
(port of ``vit_tpu/serving.py``).

Requests land on a queue; a batcher thread coalesces them — it dispatches
when ``max_batch`` requests wait or the oldest has waited ``max_wait_ms`` —
decodes JPEG payloads in one native call, and enqueues one batch on the card
through ``InferencePipeline.dispatch``. A resolver thread waits for each
in-flight batch (the copy of its logits to the host synchronizes with the
CUDA stream) and resolves each request's ``Future`` with its own row, so the
batcher never waits on the card. ``pipeline_depth`` bounds the batches in
flight.

Errors are per request: a corrupt JPEG or a pre-decoded array of the wrong
shape fails only its own future, and the server keeps serving.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Union

import numpy as np

from vit_tpu_torch.data import JpegDecoder
from vit_tpu_torch.pipeline import to_host


class BatchingServer:
    """Coalesce single classify requests into device batches.

    ``pipeline``: an ``InferencePipeline`` (or anything with
    ``__call__(raw_uint8_batch) -> logits``). ``decoder`` turns JPEG bytes
    into the fixed ``[S, S, 3]`` uint8 the pipeline preprocesses; requests
    may also be pre-decoded ``[S, S, 3]`` uint8 arrays.
    """

    def __init__(
        self,
        pipeline,
        *,
        decoder: Optional[JpegDecoder] = None,
        max_batch: Optional[int] = None,
        max_wait_ms: float = 5.0,
        pipeline_depth: int = 2,
        warm: bool = True,
    ):
        self.pipeline = pipeline
        self.decoder = decoder or JpegDecoder(size=256)
        self.max_batch = max_batch or getattr(pipeline, "batch_size", 64)
        self.max_wait_s = max_wait_ms / 1e3
        # the resolver queue's bound; in flight can exceed it by two (one
        # batch in the blocked batcher's hands, one being resolved)
        self.pipeline_depth = max(1, int(pipeline_depth))
        if warm and hasattr(pipeline, "warm"):
            pipeline.warm()  # every bucket runs once before traffic
        self._q: "queue.Queue" = queue.Queue()
        self._rq: "queue.Queue" = queue.Queue(maxsize=self.pipeline_depth)
        self._closed = False
        # serializes submit against close: nothing is enqueued after the
        # shutdown sentinel, which the batcher treats as end of stream
        self._lock = threading.Lock()
        self._resolver = threading.Thread(target=self._resolver_loop, daemon=True)
        self._resolver.start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client side --------------------------------------------------------

    def submit(self, item: Union[bytes, np.ndarray]) -> Future:
        """Enqueue one request (JPEG bytes or a decoded uint8 image);
        returns a ``Future`` resolving to that request's logits row."""
        f: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._q.put((item, f))
        return f

    def classify(self, item: Union[bytes, np.ndarray], timeout: Optional[float] = None) -> np.ndarray:
        """Submit one request and wait for its logits."""
        return self.submit(item).result(timeout=timeout)

    def close(self, timeout: float = 10.0) -> None:
        """Drain outstanding requests and stop both threads."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)  # wake the batcher; nothing can follow it
        self._thread.join(timeout=timeout)
        # the batcher pushes the resolver's sentinel as its last act
        self._resolver.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- batcher ------------------------------------------------------------

    def _collect(self):
        """Gather until max_batch or the first request's deadline. Returns a
        list of (item, future), or None on the shutdown sentinel."""
        first = self._q.get()
        if first is None:
            return None
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:  # shutdown sentinel: flush what we have
                break
            batch.append(nxt)
        return batch

    def _decode(self, items, futures):
        """Decode payloads to one [n, S, S, 3] uint8 array. A failing JPEG
        or a wrong-shape array fails only its own future (decode is retried
        per item to find the offender); returns (array, futures) of the
        survivors."""
        expected = (self.decoder.size, self.decoder.size, 3)
        jpeg_idx, decoded = [], list(items)
        for i, it in enumerate(items):
            if isinstance(it, (bytes, bytearray)):
                jpeg_idx.append(i)
            elif getattr(it, "shape", None) != expected:
                futures[i].set_exception(ValueError(
                    f"pre-decoded request has shape {getattr(it, 'shape', None)}, "
                    f"expected {expected} (the decoder's output; resize on the "
                    f"client or pass JPEG bytes)"
                ))
                decoded[i] = None
        if jpeg_idx:
            try:
                arrs = self.decoder([items[i] for i in jpeg_idx])
                for j, i in enumerate(jpeg_idx):
                    decoded[i] = arrs[j]
            except Exception:  # noqa: BLE001 — find and fail only the corrupt items
                for i in jpeg_idx:
                    try:
                        decoded[i] = self.decoder([items[i]])[0]
                    except Exception as e:  # noqa: BLE001 — reported on its future
                        futures[i].set_exception(e)
                        decoded[i] = None
        keep = [i for i, d in enumerate(decoded) if d is not None]
        if not keep:
            return None, []
        return np.stack([decoded[i] for i in keep]), [futures[i] for i in keep]

    def _resolve(self, pending):
        """Wait for an in-flight batch and resolve its futures."""
        handles, futures = pending
        try:
            logits = to_host(handles)
            for i, f in enumerate(futures):
                f.set_result(logits[i])
        except Exception as e:  # noqa: BLE001 — a device-side failure fails that batch
            for f in futures:
                if not f.done():
                    f.set_exception(e)

    def _resolver_loop(self):
        while True:
            pending = self._rq.get()
            if pending is None:
                return
            self._resolve(pending)

    def _loop(self):
        dispatch = getattr(self.pipeline, "dispatch", None)
        try:
            while True:
                batch = self._collect()
                if batch is None:  # shutdown, queue drained
                    return
                items, futures = zip(*batch)
                raw, live = self._decode(list(items), list(futures))
                if raw is None:
                    # the shutdown sentinel may have closed this fully failed
                    # batch; without this check the next _collect blocks forever
                    if self._closed and self._q.empty():
                        return
                    continue
                try:
                    if dispatch is not None:
                        self._rq.put((dispatch(raw), live))
                    else:  # plain callable pipeline: synchronous
                        logits = self.pipeline(raw)
                        for i, f in enumerate(live):
                            f.set_result(logits[i])
                except Exception as e:  # noqa: BLE001 — reported on the batch's futures
                    for f in live:
                        if not f.done():
                            f.set_exception(e)
                if self._closed and self._q.empty():
                    return
        finally:
            self._rq.put(None)  # the resolver drains in order, then exits
