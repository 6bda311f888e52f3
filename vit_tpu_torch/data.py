"""Host JPEG decode and the data feeders of serving and training (port of
``vit_tpu/data.py``).

Raw JPEG bytes become a fixed-size ``[N, S, S, 3]`` uint8 batch on the host.
``JpegDecoder`` takes the first route that runs on this machine:

- ``native``: the multithreaded libjpeg decoder of ``native/jpeg_decoder.cpp``
  (ctypes-bound, GIL-free), built on demand with ``make -C native``;
- ``nvjpeg``: where libjpeg's headers are missing (the H100 machine), the
  CUDA toolkit's nvJPEG through ``csrc/jpeg_nvjpeg.cpp``, the same C ABI,
  built by ``ops._build.build_nvjpeg`` into ``vit_tpu_torch/_build/``;
- ``pil``: PIL, where neither builds.

Resize, crop and normalize then run on the card (``vit_tpu_torch.pipeline``).
``classify_jpeg_stream`` decodes batch k+1 while the card runs batch k;
``JpegFolderDataset`` feeds training, decoding and copying the next batch
to the card while the current step runs.

The binding is the same C ABI that ``vit_tpu/data.py`` uses; it is repeated
here because importing ``vit_tpu`` imports JAX and flax, which the port's
machine does not have.
"""

from __future__ import annotations

import ctypes
import importlib.util
import io
import os
import queue
import shutil
import subprocess
import tempfile
import threading
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from vit_tpu_torch.pipeline import to_device, to_host

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libvitjpeg.so")

# Decode flags and ABI version (must mirror native/jpeg_decoder.cpp).
_FLAG_DCT_SCALE = 1
_ABI_VERSION = 2

def _open_lib(path: str = _LIB_PATH) -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    try:
        if lib.vt_api_version() != _ABI_VERSION:
            return None
    except AttributeError:  # pre-versioning binary
        return None
    return lib


def _open_rebuilt_lib() -> Optional[ctypes.CDLL]:
    """Load a just-rebuilt library through a unique temporary path: dlopen
    caches by path name, so reopening ``_LIB_PATH`` could return the stale
    mapping."""
    try:
        fd, tmp = tempfile.mkstemp(prefix="libvitjpeg-", suffix=".so")
        os.close(fd)
        shutil.copy2(_LIB_PATH, tmp)
    except OSError:
        return _open_lib()
    try:
        return _open_lib(tmp)
    finally:
        os.unlink(tmp)  # the mapping survives the unlink


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.vt_decode_jpeg_batch.restype = ctypes.c_int
    lib.vt_decode_jpeg_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),   # data
        ctypes.POINTER(ctypes.c_int64),   # offsets [n+1]
        ctypes.c_int,                     # n
        ctypes.c_int,                     # out_size
        ctypes.POINTER(ctypes.c_uint8),   # out
        ctypes.POINTER(ctypes.c_int64),   # status [n]
        ctypes.c_int,                     # n_threads
        ctypes.c_int,                     # flags
    ]
    return lib


def _load_native() -> Optional[ctypes.CDLL]:
    lib = _open_lib() if os.path.exists(_LIB_PATH) else None
    if lib is None:
        try:  # (re)build on demand; a machine without libjpeg takes the next route
            subprocess.run(["make", "-C", _NATIVE_DIR, "clean", "all"],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
        lib = _open_rebuilt_lib()
        if lib is None:
            return None
    return _bind(lib)


def _load_nvjpeg() -> Optional[ctypes.CDLL]:
    """The nvJPEG decoder, built on first use; None without ``nvcc``, without
    a card, or where it does not build or start."""
    from vit_tpu_torch.ops import _build

    try:
        lib = _open_lib(str(_build.build_nvjpeg()))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    if lib is None:
        return None
    lib.vt_nvjpeg_init.restype = ctypes.c_int
    lib.vt_nvjpeg_init.argtypes = []
    return _bind(lib) if lib.vt_nvjpeg_init() == 0 else None


_lib_lock = threading.Lock()
_lib_state: dict = {}


def _decoder_lib():
    """(backend, library) of the first route that runs here, looked up once:
    ``("native", lib)``, ``("nvjpeg", lib)``, ``("pil", None)`` or
    ``(None, None)`` where nothing can decode."""
    with _lib_lock:
        if "backend" not in _lib_state:
            for name, load in (("native", _load_native), ("nvjpeg", _load_nvjpeg)):
                lib = load()
                if lib is not None:
                    break
            else:
                name = "pil" if importlib.util.find_spec("PIL") is not None else None
            _lib_state["backend"] = (name, lib)
        return _lib_state["backend"]


class JpegDecoder:
    """Batch JPEG -> uint8 RGB ``[N, size, size, 3]`` with a host bilinear
    resize (half-pixel centers). ``backend`` names the route that runs:
    ``native`` (libjpeg), ``nvjpeg`` or ``pil`` (module docstring), or
    ``none``, where a call raises. ``fast=True`` lets libjpeg's IDCT
    downscale by a power of two first (the other routes decode at full
    scale).

    The library is looked up on the first decode, so a server fed only
    pre-decoded arrays never builds or loads it."""

    def __init__(self, size: int = 256, threads: Optional[int] = None, fast: bool = False):
        self.size = size
        self.threads = threads or min(32, os.cpu_count() or 8)
        self.fast = fast

    @property
    def backend(self) -> str:
        return _decoder_lib()[0] or "none"

    def __call__(self, jpegs: Sequence[bytes]) -> np.ndarray:
        backend, lib = _decoder_lib()
        if lib is not None:
            return self._decode_lib(lib, jpegs)
        if backend == "pil":
            return self._decode_pil(jpegs)
        raise RuntimeError("no JPEG decoder: native/ does not build (libjpeg), nvJPEG does not "
                           "build or start (nvcc, a card) and PIL is not installed")

    def _decode_lib(self, lib, jpegs: Sequence[bytes]) -> np.ndarray:
        n = len(jpegs)
        data = np.frombuffer(b"".join(jpegs), np.uint8)
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum([len(j) for j in jpegs], out=offsets[1:])
        out = np.empty((n, self.size, self.size, 3), np.uint8)
        status = np.zeros(n, np.int64)
        failures = lib.vt_decode_jpeg_batch(
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, self.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self.threads, _FLAG_DCT_SCALE if self.fast else 0,
        )
        if failures:
            bad = np.nonzero(status)[0].tolist()
            raise ValueError(f"{failures} corrupt JPEG(s) at indices {bad[:8]}")
        return out

    def _decode_pil(self, jpegs: Sequence[bytes]) -> np.ndarray:
        from PIL import Image

        out = np.zeros((len(jpegs), self.size, self.size, 3), np.uint8)
        bad = []
        for i, raw in enumerate(jpegs):
            try:
                img = Image.open(io.BytesIO(raw))
                if self.fast:
                    img.draft("RGB", (self.size, self.size))
                out[i] = _resize_bilinear_u8(np.asarray(img.convert("RGB")), self.size)
            except OSError:  # PIL's error for unreadable and truncated files
                bad.append(i)
        if bad:  # the libraries' error, so that callers see one contract
            raise ValueError(f"{len(bad)} corrupt JPEG(s) at indices {bad[:8]}")
        return out


def _resize_bilinear_u8(arr: np.ndarray, size: int) -> np.ndarray:
    """Numpy mirror of the native resize (half-pixel centers), so the PIL
    fallback agrees with the native path."""
    h, w, _ = arr.shape
    if h == size and w == size:
        return arr
    fy = np.clip((np.arange(size) + 0.5) * (h / size) - 0.5, 0, h - 1)
    fx = np.clip((np.arange(size) + 0.5) * (w / size) - 0.5, 0, w - 1)
    y0 = fy.astype(np.int32)
    x0 = fx.astype(np.int32)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (fy - y0)[:, None, None]
    wx = (fx - x0)[None, :, None]
    a = arr.astype(np.float32)
    top = a[y0][:, x0] + (a[y0][:, x1] - a[y0][:, x0]) * wx
    bot = a[y1][:, x0] + (a[y1][:, x1] - a[y1][:, x0]) * wx
    return (top + (bot - top) * wy + 0.5).astype(np.uint8)


class JpegFolderDataset:
    """Shuffled, batched, multi-epoch training iterator over JPEG bytes
    (``vit_tpu/data.py:191-364``).

    Per-epoch deterministic shuffle (``seed`` and the epoch index: the same
    order as ``vit_tpu``'s, exact resume at an epoch boundary), decode of
    batch k+1 on a background thread while the card trains on batch k.
    Yields ``(images fp32 [B, S, S, 3], labels int32 [B])`` on ``device``
    (default the card): the images over 255 when ``normalize``. The train
    step takes the int32 labels as they are (``cross_entropy_loss`` indexes
    with ``labels.long()``).

    ``samples`` is a sequence of ``(jpeg_bytes_or_path, label)``; paths are
    read lazily on the decode thread. The last short batch of an epoch is
    dropped when ``drop_remainder``. ``num_shards`` / ``shard_index`` give
    each worker a disjoint, equal slice of every epoch's shuffled order.

    On a card the producer thread copies each batch from pinned memory with
    ``non_blocking=True`` on a side stream and records an event; the
    consumer's stream waits on that event before the batch is handed over,
    and the tensors are marked as used on the consumer's stream
    (``record_stream``), so the caching allocator does not hand their memory
    back to the side stream while the step still reads it. A pageable copy
    from the producer would queue behind the train step and block that
    thread. ``mesh`` (a batch sharded over cards) waits for ROADMAP.md Queue
    1 item 8."""

    def __init__(
        self,
        samples: Sequence,
        batch_size: int,
        *,
        size: int = 224,
        seed: int = 0,
        decoder: Optional[JpegDecoder] = None,
        drop_remainder: bool = True,
        normalize: bool = True,
        prefetch: bool = True,
        mesh=None,
        num_shards: Optional[int] = None,
        shard_index: Optional[int] = None,
        device="cuda",
    ):
        if (num_shards is None) != (shard_index is None):
            raise ValueError("pass num_shards and shard_index together")
        if num_shards is not None and not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
        self._shard = (shard_index or 0, num_shards or 1)
        if len(samples) // self._shard[1] < batch_size:
            raise ValueError(
                f"{len(samples)} samples / {self._shard[1]} shards < batch_size {batch_size}")
        if mesh is not None:
            raise NotImplementedError("mesh=: a batch sharded over several cards is "
                                      "ROADMAP.md Queue 1 item 8")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("JpegFolderDataset: no CUDA card (pass device='cpu')")
        self.samples = list(samples)
        self.batch_size = batch_size
        self.seed = seed
        self.decoder = decoder or JpegDecoder(size=size)
        self.drop_remainder = drop_remainder
        self.normalize = normalize
        self.prefetch = prefetch

    def __len__(self) -> int:
        n = len(self.samples) // self._shard[1]
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    def _order(self, epoch: int) -> np.ndarray:
        order = np.random.default_rng((self.seed, epoch)).permutation(len(self.samples))
        idx, num = self._shard
        # every shard truncated to len // num samples, so that all workers
        # take the same number of batches an epoch
        return order[idx::num][: len(self.samples) // num]

    def _load(self, idx: np.ndarray):
        jpegs = []
        labels = np.empty(len(idx), np.int32)
        for j, i in enumerate(idx):
            raw, labels[j] = self.samples[i]
            if not isinstance(raw, (bytes, bytearray)):
                with open(raw, "rb") as f:
                    raw = f.read()
            jpegs.append(raw)
        images = self.decoder(jpegs).astype(np.float32)
        if self.normalize:
            images /= 255.0
        return images, labels

    def epoch(self, epoch: int = 0) -> Iterator:
        """One pass over the data in the epoch's shuffled order."""
        order = self._order(epoch)
        batches = (order[k * self.batch_size:(k + 1) * self.batch_size]
                   for k in range(len(self)))
        if not self.prefetch:
            for idx in batches:
                images, labels = self._load(idx)
                yield to_device(images, self.device), to_device(labels, self.device)
            return
        yield from self._prefetched(batches)

    def _prefetched(self, batches) -> Iterator:
        on_card = self.device.type == "cuda"
        q: "queue.Queue" = queue.Queue(maxsize=2)  # bounded lookahead
        # a generator dropped mid-epoch raises GeneratorExit at its yield; the
        # event stops the producer, which would otherwise block on q.put
        # forever, holding a thread and up to two batches
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                side = torch.cuda.Stream(self.device) if on_card else None
                for idx in batches:
                    if stop.is_set():
                        return
                    images, labels = self._load(idx)
                    if on_card:
                        with torch.cuda.stream(side):
                            item = (to_device(images, self.device),
                                    to_device(labels, self.device))
                            ready = torch.cuda.Event()
                            ready.record(side)
                        item = item + (ready,)
                    else:
                        item = (to_device(images, self.device), to_device(labels, self.device))
                    if not put(item):
                        return
                put(None)
            except Exception as e:  # noqa: BLE001 — raised again on the consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                if on_card:
                    images, labels, ready = item
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(ready)
                    images.record_stream(stream)
                    labels.record_stream(stream)
                    item = (images, labels)
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)

    def epochs(self, n: int) -> Iterator:
        """``n`` epochs back to back, yielding ``(epoch, images, labels)``."""
        for e in range(n):
            for images, labels in self.epoch(e):
                yield e, images, labels


def classify_jpegs(pipeline, jpegs: List[bytes], *, decoder: Optional[JpegDecoder] = None):
    """JPEG bytes -> logits through an ``InferencePipeline``: decode on the
    host, resize / crop / normalize and the model on the card."""
    decoder = decoder or JpegDecoder()
    return pipeline(decoder(jpegs))


def classify_jpeg_stream(
    pipeline,
    batches: Iterable[List[bytes]],
    *,
    decoder: Optional[JpegDecoder] = None,
) -> Iterator[np.ndarray]:
    """Streaming serving loop (``vit_tpu/data.py:376-401``): decode batch k+1
    on the host while the card runs batch k.

    ``pipeline.dispatch`` enqueues a batch on the card and returns without
    waiting, so decoding the next batch overlaps the card's work. The
    one-batch lookahead keeps at most one undelivered batch in flight.
    Yields one fp32 logits array per input batch, in order, each equal to
    ``classify_jpegs`` of that batch."""
    decoder = decoder or JpegDecoder()
    pending = None  # the in-flight chunks of the previous batch
    for jpegs in batches:
        raw = decoder(jpegs)  # overlaps the card's work on the previous batch
        if pending is not None:
            yield to_host(pending)
        pending = pipeline.dispatch(raw)
    if pending is not None:
        yield to_host(pending)
