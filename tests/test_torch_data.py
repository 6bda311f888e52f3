"""The port's data feeders on the CPU against vit_tpu's: ``JpegDecoder``'s
routes and the committed fixtures, ``JpegFolderDataset`` (order, shards,
images, labels, prefetch, the abandonment guard, errors),
``classify_jpeg_stream`` and ``python -m vit_tpu_torch.train --data``.
The tests marked ``cuda`` hold the decoder and the dataset's card path on
the card. JAX is imported only inside the tests."""

import io
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
from vit_tpu_torch import data
from vit_tpu_torch.data import JpegDecoder, JpegFolderDataset, classify_jpeg_stream, classify_jpegs
from vit_tpu_torch.models import ViT
from vit_tpu_torch.pipeline import InferencePipeline, to_device

torch.set_num_threads(2)


def _jpeg(rng, hw=(48, 64), gray=False):
    from PIL import Image

    img = Image.fromarray(rng.integers(0, 255, (*hw, 3), dtype=np.uint8))
    buf = io.BytesIO()
    (img.convert("L") if gray else img).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def _samples(n=12):
    rng = np.random.default_rng(1)
    return [(_jpeg(rng, gray=i == 5), i) for i in range(n)]  # label == sample index


def _pair(samples, prefetch=True, **kw):
    from vit_tpu.data import JpegFolderDataset as JaxDataset

    ours = JpegFolderDataset(samples, size=32, prefetch=prefetch, device="cpu", **kw)
    ref = JaxDataset(samples, size=32, prefetch=prefetch, **kw)
    return ours, ref


def _assert_same_epoch(ours, ref, epoch):
    got, want = list(ours.epoch(epoch)), list(ref.epoch(epoch))
    assert len(got) == len(want) == len(ours) == len(ref)
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == torch.float32 and gl.dtype == torch.int32
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    return got


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("kw", [dict(batch_size=4, seed=3),
                                dict(batch_size=5, seed=0, drop_remainder=False),
                                dict(batch_size=2, seed=5, num_shards=3, shard_index=1),
                                dict(batch_size=3, seed=2, normalize=False)],
                         ids=["plain", "remainder", "shard", "unnormalized"])
def test_dataset_matches_vit_tpu(prefetch, kw):
    """Order, shards, images bitwise and labels, epoch by epoch."""
    ours, ref = _pair(_samples(), prefetch, **kw)
    for epoch in (0, 1):
        got = _assert_same_epoch(ours, ref, epoch)
    assert got[0][0].shape[1:] == (32, 32, 3)


def test_shards_partition_each_epoch_and_paths_read_lazily(tmp_path):
    samples = _samples()
    paths = []
    for raw, label in samples:
        p = tmp_path / f"{label}.jpg"
        p.write_bytes(raw)
        paths.append((str(p), label))
    seen = []
    for shard in range(3):
        ours, ref = _pair(paths, batch_size=2, seed=5, num_shards=3, shard_index=shard)
        seen += [int(v) for _, y in _assert_same_epoch(ours, ref, 0) for v in y]
    assert sorted(seen) == list(range(12))
    ours = JpegFolderDataset(samples, 4, size=32, device="cpu")
    rows = list(ours.epochs(2))
    assert [e for e, _, _ in rows] == [0, 0, 0, 1, 1, 1]
    paths_rows = list(JpegFolderDataset(paths, 4, size=32, device="cpu").epochs(2))
    for (_, a, la), (_, b, lb) in zip(rows, paths_rows):
        assert torch.equal(a, b) and torch.equal(la, lb)


def test_abandoned_epoch_stops_its_producer():
    before = set(threading.enumerate())
    ds = JpegFolderDataset(_samples(), 2, size=32, device="cpu")
    it = ds.epoch(0)
    next(it)
    time.sleep(0.3)  # the producer fills its queue and blocks on put
    (producer,) = set(threading.enumerate()) - before
    assert producer.is_alive()
    it.close()  # GeneratorExit at the yield: the guard stops and joins it
    producer.join(timeout=5)
    assert not producer.is_alive()


@pytest.mark.parametrize("prefetch", [True, False])
def test_decode_errors_surface_on_the_consumer(prefetch):
    samples = _samples(8)
    samples[6] = (b"not a jpeg", 6)
    ds = JpegFolderDataset(samples, 8, size=32, prefetch=prefetch, device="cpu")
    with pytest.raises(ValueError, match="corrupt"):
        list(ds.epoch(0))


def test_argument_errors():
    samples = _samples()
    with pytest.raises(ValueError, match="together"):
        JpegFolderDataset(samples, 2, shard_index=1, device="cpu")
    with pytest.raises(ValueError, match="not in"):
        JpegFolderDataset(samples, 2, num_shards=3, shard_index=3, device="cpu")
    with pytest.raises(ValueError, match="batch_size"):
        JpegFolderDataset(samples, 4, num_shards=4, shard_index=0, device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        JpegFolderDataset(samples, 2, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            JpegFolderDataset(samples, 2)


def _tiny_vit():
    gen = torch.Generator().manual_seed(0)
    model = ViT(image_size=32, patch_size=8, num_classes=10, dim=32, depth=1, heads=2,
                dim_head=16, mlp_dim=64, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model


def _jpeg_batches():
    rng = np.random.default_rng(0)
    return [[_jpeg(rng, (40, 52)) for _ in range(3)], [_jpeg(rng, (40, 52)) for _ in range(2)],
            [_jpeg(rng, (52, 40)) for _ in range(5)]]


def test_stream_is_classify_jpegs_batch_by_batch():
    pipe = InferencePipeline(_tiny_vit(), image_size=32, batch_size=2, dtype=torch.float32)
    dec = JpegDecoder(size=36)
    batches = _jpeg_batches()
    streamed = list(classify_jpeg_stream(pipe, iter(batches), decoder=dec))
    assert len(streamed) == len(batches)
    for got, jpegs in zip(streamed, batches):
        np.testing.assert_array_equal(got, classify_jpegs(pipe, jpegs, decoder=dec))
    assert list(classify_jpeg_stream(pipe, [], decoder=dec)) == []


def test_stream_matches_vit_tpu():
    """Within test_torch_serving.py's 1e-5 on a tiny fp32 ViT whose weights
    come from vit_tpu's through ``from_jax_params``."""
    import jax
    import jax.numpy as jnp
    from vit_tpu.data import JpegDecoder as JaxDecoder
    from vit_tpu.data import classify_jpeg_stream as jax_stream
    from vit_tpu.models import ViT as JaxViT
    from vit_tpu.pipeline import InferencePipeline as JaxPipeline

    from vit_tpu_torch.utils import from_jax_params

    cfg = dict(image_size=32, patch_size=8, num_classes=10, dim=32, depth=1, heads=2,
               mlp_dim=64, dim_head=16)
    jm = JaxViT(**cfg)
    rng = np.random.default_rng(0)  # drawn here: jax.jit of init would cost seconds
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, 32, 32, 3))))
    variables = jax.tree.map(lambda s: 0.2 * rng.standard_normal(s.shape, np.float32), shapes)
    tm = ViT(**cfg, device="cpu")
    tm.load_state_dict(from_jax_params(variables, tm.jax_stages), strict=True)
    batches = _jpeg_batches()
    ours = list(classify_jpeg_stream(
        InferencePipeline(tm, image_size=32, batch_size=2, dtype=torch.float32),
        batches, decoder=JpegDecoder(size=36)))
    ref = list(jax_stream(JaxPipeline(jm, variables, image_size=32, batch_size=2,
                                      dtype=jnp.float32), batches, decoder=JaxDecoder(size=36)))
    assert len(ours) == len(ref) == 3
    for got, want in zip(ours, ref):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_decoder_backend_is_a_route_that_runs(monkeypatch):
    assert JpegDecoder().backend == "native"  # this machine builds native/
    monkeypatch.setattr(data, "_lib_state", {})
    monkeypatch.setattr(data, "_load_native", lambda: None)
    monkeypatch.setattr(data, "_load_nvjpeg", lambda: None)
    dec = JpegDecoder(size=32)
    assert dec.backend == "pil"
    rng = np.random.default_rng(2)
    jpegs = [_jpeg(rng) for _ in range(2)]
    assert dec(jpegs).shape == (2, 32, 32, 3)
    monkeypatch.setattr(data, "_lib_state", {})
    monkeypatch.setattr(data.importlib.util, "find_spec", lambda name: None)
    assert dec.backend == "none"
    with pytest.raises(RuntimeError, match="no JPEG decoder"):
        dec(jpegs)


def test_nvjpeg_route_needs_nvcc_here():
    """Without nvcc (this machine) the nvJPEG route reports itself absent
    instead of raising."""
    if torch.cuda.is_available():
        pytest.skip("a machine with a card may build the route")
    assert data._load_nvjpeg() is None


@pytest.mark.parametrize("route", ["native", "pil"])
def test_fixtures_hold_their_digests_and_faults_fail(route):
    """The committed fixtures through this machine's native decoder (which
    made the digests: exact) and the PIL route (its own libjpeg build),
    with the planted faults failing the digest and the truncated file
    failing its own index (``chip_smoke.check_jpeg_fixtures``)."""
    dec = JpegDecoder(size=chip_smoke.DIGEST_SIZE, threads=2)
    if route == "pil":
        dec = dec._decode_pil
    worst = chip_smoke.check_jpeg_fixtures(dec)
    assert worst[0] <= chip_smoke.JPEG_TOL["means"] and worst[1] <= chip_smoke.JPEG_TOL["area"]
    if route == "native":
        assert worst == [0.0, 0.0]


def test_fixtures_are_small_and_complete():
    names, jpegs, digests, truncated = chip_smoke.jpeg_fixtures()
    assert len(names) == 15 and len(truncated) < 1000
    total = sum(p.stat().st_size for p in chip_smoke.JPEG_DIR.iterdir())
    assert total <= 1 << 20, total
    assert {k.split("/")[1] for k in digests} == {"means", "area"}
    assert digests[f"{names[0]}/area"].shape == (32, 32, 3)


def test_evaluate_takes_an_epoch():
    from vit_tpu_torch.train import evaluate

    ds = JpegFolderDataset(_samples(8), 4, size=32, device="cpu")
    model = _tiny_vit().eval()
    got = evaluate(model, ds.epoch(0))
    assert got["samples"] == 8 and 0.0 <= got["top1"] <= 1.0 and np.isfinite(got["loss"])


def test_train_cli_on_a_folder(tmp_path, capsys):
    from vit_tpu_torch.train import main

    rng = np.random.default_rng(3)
    folder = tmp_path / "jpegs"
    folder.mkdir()
    for i in range(6):
        (folder / f"{i:02d}.jpg").write_bytes(_jpeg(rng, (40, 30)))
    (folder / "notes.txt").write_text("not an image")
    run = tmp_path / "run"
    assert main(["--device", "cpu", "--data", str(folder), "--image-size", "32",
                 "--config", '{"dim": 32, "mlp_dim": 64}', "--batch", "4", "--steps", "2",
                 "--classes", "10", "--checkpoint-dir", str(run), "--save-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "step 2: loss" in out and "checkpoints at steps [1, 2]" in out
    assert sorted(p.name for p in run.iterdir()) == ["metrics.json", "step_1.pt", "step_2.pt"]


def test_to_device_on_the_cpu_is_the_array():
    arr = np.arange(6, dtype=np.uint8).reshape(2, 3)
    t = to_device(arr, torch.device("cpu"))
    assert t.data_ptr() == arr.ctypes.data


# -- on the card ----------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_decoder_holds_the_digests():
    _card()
    dec = JpegDecoder(size=chip_smoke.DIGEST_SIZE)
    assert dec.backend in ("native", "nvjpeg")
    chip_smoke.check_jpeg_fixtures(dec)


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [True, False])
def test_card_dataset_equals_the_cpu_one(prefetch):
    """The side-stream prefetch hands the consumer's stream the same
    batches as the CPU dataset, while a kernel on the consumer's stream
    runs between them."""
    dev = _card()
    samples = _samples()
    cpu = list(JpegFolderDataset(samples, 4, size=32, seed=1, device="cpu").epoch(0))
    ds = JpegFolderDataset(samples, 4, size=32, seed=1, prefetch=prefetch, device=dev)
    busy = torch.randn(2048, 2048, device=dev)
    for (x, y), (cx, cy) in zip(ds.epoch(0), cpu):
        busy = busy @ busy / 2048.0  # keeps the consumer's stream busy
        assert x.device.type == "cuda" and torch.equal(x.cpu(), cx) and torch.equal(y.cpu(), cy)
