"""Write the JPEG fixtures of ``tests/data/torch_jpeg/`` and their digests.

    python tests/make_torch_jpeg_fixtures.py

Needs PIL (to encode) and the native decoder of ``native/`` (to digest),
which does not build where libjpeg's headers are missing; the files are
committed, and this script is only rerun to change them. The images are
smooth synthetic content drawn from a seed at ImageNet-like sizes, in the
encodings a decoder must handle: baseline 4:2:0, 4:2:2 and 4:4:4,
progressive, restart markers, grayscale, and one truncated file that every
decoder must refuse.

``digests.npz`` holds, for each valid file, the digest of its decode at
``DIGEST_SIZE`` px by ``vit_tpu_torch.data.JpegDecoder``'s native route
(``chip_smoke.jpeg_digest``: the per-channel means and a 32 x 32 map of
8 x 8 area means a channel). ``chip_smoke.digest_errors`` holds another
decoder's output to it.
"""

from __future__ import annotations

import io
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "tests" / "data" / "torch_jpeg"
SEED = 22

# name -> (width, height, PIL save options, grayscale)
FIXTURES = {
    "baseline_420_500x375": (500, 375, dict(subsampling=2), False),
    "baseline_420_375x500": (375, 500, dict(subsampling=2), False),
    "baseline_444_640x480": (640, 480, dict(subsampling=0), False),
    "baseline_420_1024x768": (1024, 768, dict(subsampling=2), False),
    "baseline_444_256x256": (256, 256, dict(subsampling=0), False),
    "baseline_422_500x333": (500, 333, dict(subsampling=1), False),
    "baseline_420_333x500": (333, 500, dict(subsampling=2), False),
    "progressive_420_640x480": (640, 480, dict(subsampling=2, progressive=True), False),
    "progressive_444_500x375": (500, 375, dict(subsampling=0, progressive=True), False),
    "progressive_420_1024x768": (1024, 768, dict(subsampling=2, progressive=True), False),
    "restart_420_640x480": (640, 480, dict(subsampling=2, restart_marker_blocks=8), False),
    "restart_444_375x500": (375, 500, dict(subsampling=0, restart_marker_rows=1), False),
    "gray_500x375": (500, 375, {}, True),
    "gray_progressive_256x256": (256, 256, dict(progressive=True), True),
    "baseline_420_480x640": (480, 640, dict(subsampling=2), False),
}
TRUNCATED = "truncated_640x480"  # the first bytes of a baseline file, cut inside its tables
TRUNCATE_AT = 400


def smooth_image(rng: np.random.Generator, w: int, h: int) -> np.ndarray:
    """uint8 ``[h, w, 3]``: a few low-frequency waves a channel, each with
    its own direction and phase, over a ramp that differs per channel, so
    that swapping channels, transposing or dropping the chroma moves the
    area means by tens of levels."""
    y, x = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    ramps = (x, y, 0.6 * x + 0.4 * (1 - y))
    out = np.empty((h, w, 3), np.float64)
    for c in range(3):
        v = 0.55 * ramps[c]
        for _ in range(4):
            fx, fy = rng.uniform(0.5, 4.0, 2) * rng.choice([-1, 1], 2)
            v += rng.uniform(0.05, 0.15) * np.sin(2 * np.pi * (fx * x + fy * y) + rng.uniform(0, 6.3))
        out[..., c] = v
    out = (out - out.min()) / (out.max() - out.min())
    return (out * 235 + 10).round().astype(np.uint8)


def encode(arr: np.ndarray, gray: bool, options: dict) -> bytes:
    from PIL import Image

    img = Image.fromarray(arr)
    if gray:
        img = img.convert("L")
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=90, **options)
    return buf.getvalue()


def main() -> int:
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from vit_tpu_torch.data import JpegDecoder

    decoder = JpegDecoder(size=chip_smoke.DIGEST_SIZE, threads=4)
    if decoder.backend != "native":
        print(f"the digests come from the native decoder; this machine has {decoder.backend}",
              file=sys.stderr)
        return 1
    rng = np.random.default_rng(SEED)
    OUT.mkdir(parents=True, exist_ok=True)
    digests = {}
    for name, (w, h, options, gray) in FIXTURES.items():
        data = encode(smooth_image(rng, w, h), gray, options)
        (OUT / f"{name}.jpg").write_bytes(data)
        means, area = chip_smoke.jpeg_digest(decoder([data])[0])
        digests[f"{name}/means"], digests[f"{name}/area"] = means, area
    full = encode(smooth_image(rng, 640, 480), False, dict(subsampling=2))
    (OUT / f"{TRUNCATED}.jpg").write_bytes(full[:TRUNCATE_AT])
    np.savez_compressed(OUT / "digests.npz", **digests)
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"{len(FIXTURES) + 1} files and digests.npz in {OUT.relative_to(REPO)}: {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
