"""On-device preprocessing + bucketed batch inference (port of
``vit_tpu/pipeline.py``).

``preprocess`` runs resize / crop / normalize on the model's device, so raw
uint8 images cross to the device once. ``InferencePipeline`` pads each
host batch to the smallest batch bucket that holds it (default 1, 4, 16,
``batch_size``) and returns logits; ``dispatch`` only enqueues the work, so
a caller can decode the next batch while the card computes: the batch goes
to the card from pinned memory with ``non_blocking=True`` (``to_device``),
and nothing in it waits for the card (no pageable copy, no read back).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def resize_bilinear(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize, NHWC. Antialiased, as ``jax.image.resize``: without
    antialiasing a downscale differs from it by ~0.27 of the [0, 1] range."""
    x = F.interpolate(img.permute(0, 3, 1, 2), size=size, mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def center_crop(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    _, h, w, _ = img.shape
    th, tw = size
    top, left = (h - th) // 2, (w - tw) // 2
    return img[:, top: top + th, left: left + tw, :]


def normalize(img, mean=IMAGENET_MEAN, std=IMAGENET_STD, dtype=torch.bfloat16):
    """``(img - mean) / std`` cast to ``dtype``. ``mean`` and ``std`` given
    as fp32 tensors on ``img``'s device are used as they are; sequences are
    copied there first, and on a card that copy waits for the stream."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=img.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=img.device)
    return ((img - mean) / std).to(dtype)


def preprocess(
    raw: torch.Tensor,
    *,
    image_size: int,
    resize_to: Optional[int] = None,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    dtype=torch.bfloat16,
) -> torch.Tensor:
    """uint8/float NHWC -> normalized model input on ``raw``'s device.

    Scale to [0, 1], resize so the short side is ``resize_to`` (default
    ``image_size * 256 // 224``, aspect ratio kept), center-crop, normalize.
    """
    img = raw.float()
    if raw.dtype == torch.uint8:
        img = img / 255.0
    resize_to = resize_to or max(image_size, int(image_size * 256 / 224))
    _, h, w, _ = img.shape
    scale = resize_to / min(h, w)
    img = resize_bilinear(img, (max(resize_to, round(h * scale)),
                                max(resize_to, round(w * scale))))
    img = center_crop(img, (image_size, image_size))
    return normalize(img, mean, std, dtype)


class InferencePipeline:
    """Preprocess + forward per batch bucket, with pad-to-bucket.

    ``model`` is an ``nn.Module`` whose parameters sit on the device that
    runs it. Ragged batches pad (by repeating their last image) to the
    smallest bucket that holds them, so the card sees a few fixed batch
    shapes; ``warm()`` runs each bucket once before traffic (the first call
    builds the kernels)."""

    def __init__(
        self,
        model: torch.nn.Module,
        *,
        image_size: int,
        batch_size: int = 64,
        batch_buckets: Optional[Sequence[int]] = None,
        dtype=torch.bfloat16,
    ):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.batch_size = batch_size
        self.image_size = image_size
        self.dtype = dtype
        if batch_buckets is None:
            batch_buckets = []
            b = batch_size
            while b >= 1:
                batch_buckets.append(b)
                b //= 4
        self.batch_buckets = sorted(set(int(b) for b in batch_buckets) | {batch_size})
        # on the device once, so that no batch copies them (a copy that waits)
        self._mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=self.device)
        self._std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=self.device)

    def _run(self, raw: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            x = preprocess(raw, image_size=self.image_size, mean=self._mean, std=self._std,
                           dtype=self.dtype)
            return self.model(x)

    def _bucket_for(self, n: int) -> int:
        for b in self.batch_buckets:
            if b >= n:
                return b
        return self.batch_size

    def warm(self):
        """Run every bucket once (builds the kernels on first use)."""
        shape = (self.image_size, self.image_size, 3)
        for b in self.batch_buckets:
            self._run(torch.zeros((b,) + shape, dtype=torch.uint8, device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def dispatch(self, raw_images: np.ndarray):
        """Enqueue a host batch; returns the in-flight logits (one tensor on
        the model's device per ``batch_size`` chunk) without waiting for the
        card."""
        n = raw_images.shape[0]
        bs = self.batch_size
        pending = []
        # n == 0 still runs one padded chunk and slices it empty, so an empty
        # poll returns (0, C) instead of failing np.concatenate downstream
        for start in range(0, max(n, 1), bs):
            chunk = raw_images[start: start + bs]
            bucket = self._bucket_for(chunk.shape[0])
            pad = bucket - chunk.shape[0]
            if chunk.shape[0] == 0:
                chunk = np.zeros((bucket,) + raw_images.shape[1:], raw_images.dtype)
            elif pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
            logits = self._run(to_device(chunk, self.device))
            pending.append(logits[: bucket - pad])
        return pending

    def __call__(self, raw_images: np.ndarray) -> np.ndarray:
        """Classify a host batch of any size; returns fp32 numpy logits."""
        return to_host(self.dispatch(raw_images))


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without blocking the host: on a card, a
    pinned copy from PyTorch's caching host allocator, sent with
    ``non_blocking=True`` on the current stream (the allocator records an
    event there and reuses the pinned block only after the copy has landed);
    on the CPU, the array itself."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def to_host(pending) -> np.ndarray:
    """Wait for in-flight logits and copy them to the host. The copy to the
    CPU synchronizes with the stream the logits were computed on."""
    return np.concatenate([p.float().cpu().numpy() for p in pending], axis=0)
