"""The port's int8 ViT (``QuantViT``) against vit_tpu's ``vit_apply_w8a8`` on
the CPU, from the same parameters and the same numpy images, in every mode;
its quantized weights against vit_tpu's ``quantize_vit``; and the int8 model
served through ``InferencePipeline`` and ``BatchingServer``.

vit_tpu's ``w8a8_kernel`` mode runs its Pallas kernels in interpret mode on
the CPU (``interpret=jax.default_backend() != "tpu"``); its ``w8`` and
``w8a8`` modes reach ``ops.qkv_attention``, which runs under both of its CPU
backends, ``xla`` and ``interpret``.
"""

import threading

import numpy as np
import pytest
import torch

from vit_tpu_torch.data import JpegDecoder
from vit_tpu_torch.models import ViT
from vit_tpu_torch.pipeline import InferencePipeline, preprocess
from vit_tpu_torch.serving import BatchingServer
from vit_tpu_torch.utils import (
    QuantViT,
    from_jax_params,
    from_jax_quant,
    quantize_vit,
    resolve_quant_mode,
)

torch.set_num_threads(2)

CFG = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2, heads=4,
           mlp_dim=128, dim_head=16)


def _images(b, seed=0):
    return np.random.default_rng(seed).standard_normal((b, 32, 32, 3)).astype(np.float32)


def _jax_pair(dtype):
    """vit_tpu's ViT and variables (numpy, perturbed so that biases and LN
    parameters are not zeros and ones), and the port's ViT loaded with them."""
    import jax
    import jax.numpy as jnp
    from vit_tpu.models import ViT as JaxViT

    jm = JaxViT(**CFG, dtype=getattr(jnp, dtype) if dtype else None)
    v = jax.jit(jm.init)({"params": jax.random.PRNGKey(1)}, jnp.asarray(_images(1)))
    rng = np.random.default_rng(1)
    v = jax.tree.map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rng.standard_normal(a.shape).astype(np.float32), v
    )
    tm = ViT(**CFG, dtype=getattr(torch, dtype) if dtype else None, device="cpu")
    tm.load_state_dict(from_jax_params(v), strict=True)
    return jm, v, tm


def test_quantize_vit_matches_jax_and_from_jax_quant_round_trips():
    from vit_tpu.utils.quantize import quantize_vit as jax_quantize_vit

    _, variables, tm = _jax_pair("bfloat16")
    qm = quantize_vit(tm)
    assert qm.dtype == torch.bfloat16 and qm.mode == "auto"
    qvars = jax_quantize_vit(variables)
    state = from_jax_quant(qvars)
    ours = qm.state_dict()
    assert set(state) == set(ours)
    for key, value in state.items():  # codes and scales: bitwise equal
        assert value.dtype == ours[key].dtype, key
        torch.testing.assert_close(ours[key], value, rtol=0, atol=0, msg=key)
    assert ours["encoder.blocks.1.attn.qkv_kernel"].dtype == torch.int8
    assert tuple(ours["encoder.blocks.1.ff.w2_scale"].shape) == (1, CFG["dim"])
    fresh = QuantViT(**CFG, device="cpu")
    missing, unexpected = fresh.load_state_dict(state, strict=True)
    assert not missing and not unexpected
    # the float model is not changed
    assert tm.encoder.blocks[0].attn.qkv_kernel.dtype == torch.float32


def _kmajor_follows(qm):
    for block in qm.encoder.blocks:
        for mod, name in (("attn", "qkv_kernel"), ("attn", "out_kernel"), ("ff", "w1"),
                          ("ff", "w2")):
            m = getattr(block, mod)
            copy = getattr(m, f"{name}_kmajor")
            assert copy.is_contiguous() and copy.dtype == torch.int8
            torch.testing.assert_close(copy, getattr(m, name).t(), rtol=0, atol=0)


def test_quant_vit_keeps_k_major_codes_beside_the_state_dict():
    """Both W8A8 kernels read the int8 weights K-major: QuantViT derives
    those copies (of the attention's and the MLP's four weights) when it is
    built and after each load_state_dict (strict loading of from_jax_quant's
    tree included), and keeps them out of the state dict, whose codes stay in
    vit_tpu's [in, out] layout."""
    from vit_tpu.utils.quantize import quantize_vit as jax_quantize_vit

    _, variables, tm = _jax_pair(None)
    qm = quantize_vit(tm)
    _kmajor_follows(qm)
    assert not any("kmajor" in k for k in qm.state_dict())
    fresh = QuantViT(**CFG, device="cpu")
    _kmajor_follows(fresh)
    fresh.load_state_dict(from_jax_quant(jax_quantize_vit(variables)), strict=True)
    _kmajor_follows(fresh)
    torch.testing.assert_close(fresh.encoder.blocks[1].attn.out_kernel_kmajor,
                               qm.encoder.blocks[1].attn.out_kernel_kmajor, rtol=0, atol=0)
    state = {k: -v if v.dtype == torch.int8 else v for k, v in qm.state_dict().items()}
    fresh.load_state_dict(state, strict=True)  # a second load moves them again
    _kmajor_follows(fresh)
    torch.testing.assert_close(fresh.encoder.blocks[0].attn.qkv_kernel_kmajor,
                               -qm.encoder.blocks[0].attn.qkv_kernel_kmajor, rtol=0, atol=0)
    torch.testing.assert_close(fresh.encoder.blocks[1].ff.w2_kmajor,
                               -qm.encoder.blocks[1].ff.w2_kmajor, rtol=0, atol=0)
    assert tuple(fresh.encoder.blocks[0].ff.w1_kmajor.shape) == (CFG["mlp_dim"], CFG["dim"])


def test_from_jax_quant_refuses_a_qkv_bias_tree():
    """A quantized tree with a qkv bias converts (the qkv-bias layout is
    ported) to ``encoder.blocks.{i}.attn.qkv_bias``, which a ``QuantViT``
    without a qkv bias refuses to load and a ``QuantViT(qkv_bias=True)``
    loads."""
    _, variables, _ = _jax_pair(None)
    from vit_tpu.utils.quantize import quantize_vit as jax_quantize_vit

    qvars = jax_quantize_vit(variables)
    bias = np.arange(2 * 192, dtype=np.float32).reshape(2, 192)
    qvars["params"]["encoder"]["blocks"]["attn"]["qkv_bias"] = bias
    state = from_jax_quant(qvars)
    np.testing.assert_array_equal(state["encoder.blocks.1.attn.qkv_bias"].numpy(), bias[1])
    with pytest.raises(RuntimeError, match="qkv_bias"):
        QuantViT(**CFG, device="cpu").load_state_dict(state, strict=True)
    QuantViT(**CFG, qkv_bias=True, device="cpu").load_state_dict(state, strict=True)


def test_resolve_quant_mode_matches_jax():
    from vit_tpu.utils import quantize as jq

    from vit_tpu_torch.utils import W8A8_KERNEL_MIN_BATCH

    assert W8A8_KERNEL_MIN_BATCH == jq.W8A8_KERNEL_MIN_BATCH
    assert [resolve_quant_mode(b) for b in range(1, 17)] == [
        jq.resolve_quant_mode(b) for b in range(1, 17)
    ]


# Max |logit| difference from vit_apply_w8a8 (|logits| ~2), per stream dtype
# and resolved mode. Measured on these inputs:
# - fp32, every mode: <= 1.2e-6 (sums in other orders; no int8 code moved).
# - bf16 w8a8_kernel: 6.0e-7. This mode quantizes the fp32 GELU hidden, where
#   an fp32 ulp rarely crosses a rounding boundary.
# - bf16 w8: 3.7e-3; bf16 w8a8: 9.6e-3 at batch 2, 1.2e-2 at batch 4. These
#   modes round the GELU hidden to bf16 (utils/quantize.py:200), and torch's
#   and XLA's tanh-GELU differ in the last fp32 bit of a third of their
#   values, so 3% of the bf16 hiddens land one bf16 ulp apart. w8a8 then
#   quantizes those hiddens per row, and where one is a row's maximum the
#   row's scale moves and so do many of its codes.
# Each bound is 2.5-3x its measured gap.
TOL = {(None, "w8"): 1e-5, (None, "w8a8"): 1e-5, (None, "w8a8_kernel"): 1e-5,
       ("bfloat16", "w8"): 1e-2, ("bfloat16", "w8a8"): 3e-2, ("bfloat16", "w8a8_kernel"): 1e-5}


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize(
    "mode,batch,backend",
    [("w8", 2, "xla"), ("w8", 2, "interpret"), ("w8a8", 2, "xla"), ("w8a8", 2, "interpret"),
     ("w8a8_kernel", 2, "xla"), ("auto", 1, "xla"), ("auto", 4, "interpret"), ("auto", 8, "xla")],
)
def test_quant_vit_matches_jax(mode, batch, backend, dtype, monkeypatch):
    import jax.numpy as jnp
    from vit_tpu.utils.quantize import quantize_vit as jax_quantize_vit
    from vit_tpu.utils.quantize import vit_apply_w8a8

    jm, variables, tm = _jax_pair(dtype)
    qm = quantize_vit(tm, mode=mode)
    img = _images(batch, seed=2)
    monkeypatch.setenv("VIT_TPU_BACKEND", backend)
    jdt = getattr(jnp, dtype) if dtype else jnp.float32
    ref = np.asarray(vit_apply_w8a8(jm, jax_quantize_vit(variables), jnp.asarray(img).astype(jdt),
                                    mode=mode), np.float32)
    with torch.inference_mode():
        out = qm(torch.from_numpy(img).to(getattr(torch, dtype) if dtype else torch.float32))
    assert out.dtype == torch.float32 and out.shape == (batch, CFG["num_classes"])
    resolved = resolve_quant_mode(batch) if mode == "auto" else mode
    err = np.abs(out.numpy() - ref).max()
    assert err <= TOL[(dtype, resolved)], err


def test_quant_vit_mean_pool_and_explicit_mode():
    qm = quantize_vit(_jax_pair(None)[2])
    img = torch.from_numpy(_images(2, seed=3))
    with torch.inference_mode():
        auto = qm(img)  # batch 2: w8a8
        torch.testing.assert_close(auto, qm(img, mode="w8a8"), rtol=0, atol=0)
        assert not torch.equal(auto, qm(img, mode="w8"))
    with pytest.raises(ValueError, match="mode"):
        qm(img, mode="int4")
    with pytest.raises(ValueError, match="mode"):
        QuantViT(**CFG, mode="int4", device="cpu")
    cfg = dict(CFG, pool="mean")
    tm = ViT(**cfg, device="cpu")
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(0)))
    out = quantize_vit(tm)(img)
    assert out.shape == (2, 10) and torch.isfinite(out).all()


def _served_model():
    tm = ViT(**CFG, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return quantize_vit(tm)


def _raw(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


def test_quant_vit_through_the_pipeline_runs_each_bucket_in_its_mode():
    qm = _served_model()
    pipe = InferencePipeline(qm, image_size=32, batch_size=16, dtype=torch.float32)
    assert pipe.device.type == "cpu" and pipe.batch_buckets == [1, 4, 16]
    seen = []
    qm.register_forward_hook(lambda m, args, out: seen.append(args[0].shape[0]))
    raw = _raw(21)
    x = preprocess(torch.from_numpy(raw), image_size=32, dtype=torch.float32)
    for n, bucket in ((1, 1), (3, 4), (9, 16)):
        out = pipe(raw[:n])
        assert seen[-1] == bucket and out.shape == (n, 10)
        xb = torch.cat([x[:n], x[n - 1:n].expand(bucket - n, -1, -1, -1)])
        with torch.inference_mode():
            ref = qm(xb, mode=resolve_quant_mode(bucket))[:n].numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_quant_vit_behind_the_batching_server():
    qm = _served_model()
    pipe = InferencePipeline(qm, image_size=32, batch_size=16, dtype=torch.float32)
    batches = []
    qm.register_forward_hook(lambda m, args, out: batches.append(args[0].shape[0]))
    raw = _raw(12, seed=1)
    with BatchingServer(pipe, decoder=JpegDecoder(size=32), max_wait_ms=20) as server:
        futures = [None] * len(raw)

        def send(i):
            futures[i] = server.submit(raw[i])

        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(raw))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
        rows = np.stack([f.result(timeout=60) for f in futures])
    assert rows.shape == (12, 10) and np.isfinite(rows).all()
    assert batches[:3] == [1, 4, 16]  # warm-up, one forward per bucket
    # each row is its request's logits in the mode of the bucket it rode in:
    # one of the three modes' direct results, batch-invariant on the CPU
    x = preprocess(torch.from_numpy(raw), image_size=32, dtype=torch.float32)
    with torch.inference_mode():
        direct = {m: qm(x, mode=m).numpy() for m in ("w8", "w8a8", "w8a8_kernel")}
    for i, row in enumerate(rows):
        assert min(np.abs(row - d[i]).max() for d in direct.values()) <= 1e-5, i
