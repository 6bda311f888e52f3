"""The port's serving path on the CPU: preprocess against vit_tpu's, the
pipeline's batch buckets, the batching server, and the package's
independence from JAX."""

import io
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from vit_tpu_torch.data import JpegDecoder
from vit_tpu_torch.models import ViT
from vit_tpu_torch.pipeline import InferencePipeline, preprocess
from vit_tpu_torch.serving import BatchingServer

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


# F.interpolate(bilinear, antialias=True) and jax.image.resize agree to
# ~1e-5 of the [0, 1] range here (without antialiasing a downscale differs
# by ~0.27); after the ImageNet std division that is ~5e-5.
@pytest.mark.parametrize("hw", [(256, 256), (300, 400)])
def test_preprocess_matches_jax(hw):
    import jax.numpy as jnp
    from vit_tpu.pipeline import preprocess as jax_preprocess

    raw = np.random.default_rng(0).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    out = preprocess(torch.from_numpy(raw), image_size=224, dtype=torch.float32)
    ref = np.asarray(jax_preprocess(jnp.asarray(raw), image_size=224, dtype=jnp.float32))
    assert out.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=0)


def _model():
    gen = torch.Generator().manual_seed(0)
    model = ViT(image_size=32, patch_size=8, num_classes=10, dim=64, depth=1, heads=2,
                dim_head=32, mlp_dim=128)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model


def _pipeline(batch_size=16):
    return InferencePipeline(_model(), image_size=32, batch_size=batch_size, dtype=torch.float32)


def _images(n, seed=0, size=32):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def test_pipeline_buckets_and_padding():
    pipe = _pipeline(batch_size=16)
    assert pipe.batch_buckets == [1, 4, 16]
    assert [pipe._bucket_for(n) for n in (1, 2, 4, 5, 16)] == [1, 4, 4, 16, 16]
    seen = []
    pipe.model.register_forward_hook(lambda m, args, out: seen.append(args[0].shape[0]))
    imgs = _images(21)
    out = pipe(imgs)
    assert out.shape == (21, 10) and out.dtype == np.float32
    assert seen == [16, 16]  # 16, then 5 padded to the 16-bucket
    one = np.concatenate([pipe(imgs[i: i + 1]) for i in (0, 20)])
    np.testing.assert_allclose(out[[0, 20]], one, atol=1e-5, rtol=0)
    assert pipe(imgs[:0]).shape == (0, 10)
    pipe.warm()
    assert seen[-3:] == [1, 4, 16]


def test_server_answers_requests_and_isolates_a_bad_one():
    pipe = _pipeline(batch_size=4)
    imgs = _images(9, seed=1)
    with BatchingServer(pipe, decoder=JpegDecoder(size=32), max_wait_ms=20) as server:
        futures = [None] * 9
        bad = server.submit(np.zeros((31, 32, 3), np.uint8))

        def send(i):
            futures[i] = server.submit(imgs[i])

        threads = [threading.Thread(target=send, args=(i,)) for i in range(9)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
        rows = np.stack([f.result(timeout=30) for f in futures])
        with pytest.raises(ValueError, match="shape"):
            bad.result(timeout=30)
    direct = np.concatenate([pipe(imgs[i: i + 1]) for i in range(9)])
    assert rows.shape == (9, 10) and np.isfinite(rows).all()
    np.testing.assert_allclose(rows, direct, atol=1e-5, rtol=0)
    with pytest.raises(RuntimeError):
        server.submit(imgs[0])


def _jpeg(seed, size=40):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(_images(1, seed, size)[0]).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def test_jpeg_decode_matches_vit_tpu_and_serves():
    from vit_tpu.data import JpegDecoder as JaxPackageDecoder

    jpegs = [_jpeg(i) for i in range(3)]
    ours = JpegDecoder(size=32)(jpegs)
    np.testing.assert_array_equal(ours, JaxPackageDecoder(size=32)(jpegs))
    pipe = _pipeline(batch_size=4)
    with BatchingServer(pipe, decoder=JpegDecoder(size=32), max_wait_ms=20) as server:
        futures = [server.submit(j) for j in jpegs] + [server.submit(b"not a jpeg")]
        rows = np.stack([f.result(timeout=30) for f in futures[:3]])
        with pytest.raises((ValueError, OSError)):  # native decoder / PIL
            futures[3].result(timeout=30)
    np.testing.assert_allclose(rows, pipe(ours), atol=1e-5, rtol=0)


def test_import_leaves_jax_out():
    code = (
        "import sys; import vit_tpu_torch, vit_tpu_torch.serving, vit_tpu_torch.pipeline, "
        "vit_tpu_torch.data, vit_tpu_torch.utils, vit_tpu_torch.nn, vit_tpu_torch.ops; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'vit_tpu')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_no_source_of_the_port_imports_jax():
    for path in (REPO / "vit_tpu_torch").rglob("*.py"):
        if "_build" in path.relative_to(REPO).parts:
            continue  # build outputs, not the package's sources
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in ("jax", "jaxlib", "flax", "vit_tpu"), (path, line)
