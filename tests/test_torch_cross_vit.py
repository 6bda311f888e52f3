"""The port's CrossViT against vit_tpu's on the CPU: ``Transformer(final_norm=)``
against flax, chip_smoke's weight draw against vit_tpu's init tree, the
cls <-> patch cross-attention with the low-query path forced on and off, the
tiny model in both of vit_tpu's CPU modes (``xla``, and ``interpret``: the
Pallas kernels in interpreter mode), and serving. On the card: kernel 1 at
the preset's two encoder shapes against its twin (kernel 2 at its MLP
shapes is in ``tests/test_torch_small_vits.py``).

The tiny model is ``MODEL_REGISTRY["cross_vit"]`` of vit_tpu (encoders of
depth 1: each one unscanned layer, unfused, on the fused-qkv twin) and the
same with encoders of depth 2 (scanned: the fused attention block's twin).
Parameters are drawn by ``chip_smoke.cross_vit_tree`` and perturbed, so that
no bias or LayerNorm parameter is a constant.
"""

import numpy as np
import pytest
import torch

from chip_smoke import CROSS_VIT, ZOO2_ATTN, cross_vit_tree, kernel_tol
from vit_tpu_torch import ops
from vit_tpu_torch.data import JpegDecoder
from vit_tpu_torch.models import CrossViT
from vit_tpu_torch.nn import Attention, Transformer
from vit_tpu_torch.pipeline import InferencePipeline
from vit_tpu_torch.serving import BatchingServer
from vit_tpu_torch.utils import from_jax_params

torch.set_num_threads(2)

# Max |logit| difference allowed (|logits| up to 4.2 on this input).
# fp32: every op in fp32 on both sides, summed in other orders: 1e-4
#   (measured 1.4e-6 to 2.1e-6, both modes).
# bf16: the port rounds where vit_tpu's kernels and modules round, and is
#   equal to vit_tpu run op by op (jax.disable_jit) in interpret mode within
#   8.3e-7 (depth 1) and 3.6e-7 (depth 2). Under jit XLA keeps some bf16
#   values in fp32 (excess precision), so vit_tpu's own two modes differ by
#   0.0222 / 0.0210, and the bound is twice the larger of that gap and
#   0.02, as tests/test_torch_vit_family.py holds its families. Measured,
#   the port from xla / interpret: 0.0152 / 0.0092 at depth 1, 0.0276 /
#   0.0148 at depth 2.
TOL_FP32 = 1e-4


def _config(depth):
    """vit_tpu's registry config with encoders of ``depth``, in the port's
    keywords (no dropout), and its image size."""
    from vit_tpu.models import MODEL_REGISTRY

    _, cfg, size = MODEL_REGISTRY["cross_vit"]
    cfg = {k: v for k, v in cfg.items() if k not in ("dropout", "emb_dropout")}
    return dict(cfg, sm_enc_depth=depth, lg_enc_depth=depth), size


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    perturb = lambda a: a + 0.02 * rng.standard_normal(np.shape(a)).astype(np.float32)
    walk = lambda t: {k: walk(v) if isinstance(v, dict) else perturb(v) for k, v in t.items()}
    return walk(tree)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(np.shape(v))
    return out


def _jax_logits(cfg, tree, img, dtype, mode):
    import jax
    import jax.numpy as jnp
    from vit_tpu.models import CrossViT as JaxCrossViT

    jd = getattr(jnp, dtype) if dtype != "float32" else None
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIT_TPU_BACKEND", mode)
        model = JaxCrossViT(**cfg, dropout=0.0, emb_dropout=0.0, dtype=jd)
        return np.asarray(jax.jit(model.apply)(tree, jnp.asarray(img)), np.float32)


def _loaded(cfg, tree, dtype=None):
    model = CrossViT(**cfg, dtype=dtype, device="cpu")
    model.load_state_dict(from_jax_params(tree, model.jax_stages), strict=True)
    return model


@pytest.fixture(scope="module", params=[1, 2], ids=["depth1", "depth2"])
def tiny(request):
    """The tiny model's config, images, tree, and its vit_tpu logits by
    (dtype, mode), each computed once."""
    cfg, size = _config(request.param)
    img = np.random.default_rng(0).standard_normal((2, size, size, 3)).astype(np.float32)
    tree = _perturbed(cross_vit_tree(cfg, seed=3), seed=4)
    cache = {}

    def logits(dtype, mode):
        if (dtype, mode) not in cache:
            cache[dtype, mode] = _jax_logits(cfg, tree, img, dtype, mode)
        return cache[dtype, mode]

    return cfg, img, tree, logits


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth", [1, 2])
def test_transformer_final_norm_matches_flax(depth, dtype):
    """A stack with ``final_norm`` (LayerNorm eps 1e-5 in the stack's dtype,
    after the layers, outside ``blocks``) against vit_tpu's (at depth 2 in
    interpret mode, on the fused block; at depth 1 unfused in either mode):
    the same names, fp32 within 1e-5 of the output's scale, bf16 within one
    bf16 ulp of it."""
    import jax
    import jax.numpy as jnp
    from vit_tpu.nn.blocks import Transformer as JaxTransformer

    x = np.random.default_rng(depth).standard_normal((2, 9, 32)).astype(np.float32)
    jd = getattr(jnp, dtype) if dtype != "float32" else None
    mod = JaxTransformer(dim=32, depth=depth, heads=2, dim_head=16, mlp_dim=64, final_norm=True,
                         norm_eps=1e-5, dtype=jd)
    xj = jnp.asarray(x, jd or jnp.float32)
    tree = _perturbed(jax.tree.map(np.asarray, jax.jit(mod.init)(jax.random.PRNGKey(0), xj)),
                      depth)
    assert set(tree["params"]) == ({"blocks", "final_norm"} if depth > 1
                                   else {"attn_0", "ff_0", "final_norm"})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIT_TPU_BACKEND", "interpret" if depth > 1 else "xla")
        ref = np.asarray(jax.jit(mod.apply)(tree, xj).astype(jnp.float32))
    td = getattr(torch, dtype) if dtype != "float32" else None
    enc = Transformer(32, depth, 2, 16, 64, final_norm=True, norm_eps=1e-5, dtype=td,
                      device="cpu")
    state = from_jax_params({"enc": tree["params"]}, {"enc/blocks": depth})  # a stack's prefix
    enc.load_state_dict({k[len("enc."):]: v for k, v in state.items()}, strict=True)
    assert enc.final_norm.eps == 1e-5
    with torch.inference_mode():
        out = enc(torch.from_numpy(x).to(td or torch.float32))
    assert out.dtype == (td or torch.float32)
    err = float(np.abs(out.float().numpy() - ref).max())
    scale = float(np.abs(ref).max())
    assert err <= (1e-5 if dtype == "float32" else 2.0**-7) * scale, err


@pytest.mark.parametrize("cfg", ["preset", "tiny depth 1", "tiny depth 2"])
def test_tree_has_the_names_and_shapes_of_init(cfg):
    import jax
    import jax.numpy as jnp
    from vit_tpu.models import CrossViT as JaxCrossViT

    c, size = (CROSS_VIT, 256) if cfg == "preset" else _config(int(cfg[-1]))
    want = jax.eval_shape(JaxCrossViT(**c).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, size, size, 3), jnp.float32))
    assert _leaves(cross_vit_tree(c, seed=0)) == _leaves(jax.tree.map(lambda a: a, want))


@pytest.mark.parametrize("dtype,mode", [("float32", "xla"), ("float32", "interpret"),
                                        ("bfloat16", "xla"), ("bfloat16", "interpret")])
def test_cross_vit_matches_jax(dtype, mode, tiny):
    cfg, img, tree, jax_logits = tiny
    ref = jax_logits(dtype, mode)
    model = _loaded(cfg, tree, getattr(torch, dtype) if dtype != "float32" else None)
    ops.reset_launch_counts()
    with torch.inference_mode():
        out = model(torch.from_numpy(img))
    assert sum(ops.launch_counts().values()) == 0
    assert out.dtype == torch.float32 and out.shape == (2, 10)  # the fp32 sum of the heads
    err = float(np.abs(out.numpy() - ref).max())
    if dtype == "float32":
        assert err <= TOL_FP32, err
    else:
        control = float(np.abs(jax_logits(dtype, "interpret" if mode == "xla" else "xla")
                               - ref).max())
        assert err <= 2 * max(control, 0.02), (err, control)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lowq", [True, False])
def test_cross_attend_matches_vit_tpu_on_both_paths(lowq, dtype):
    """One cls token (projected to the other stream's width, 64) attending
    itself and 16 patch tokens through the cross branch, with the low-query
    path forced on and off on both sides (vit_tpu in interpret mode; in bf16
    run op by op): fp32 within 1e-5 of the output's scale, bf16 within one
    bf16 ulp of it."""
    import jax
    import jax.numpy as jnp
    from vit_tpu.nn.attention import Attention as JaxAttention

    rng = np.random.default_rng(12)
    cls = rng.standard_normal((2, 1, 64)).astype(np.float32)
    ctx = rng.standard_normal((2, 16, 64)).astype(np.float32)
    jd = getattr(jnp, dtype) if dtype != "float32" else None
    mod = JaxAttention(dim=64, heads=2, dim_head=16, norm_eps=1e-5, lowq_cross=lowq, dtype=jd)
    cj, xj = jnp.asarray(cls, jd or jnp.float32), jnp.asarray(ctx, jd or jnp.float32)
    init = jax.jit(lambda k: mod.init(k, cj, context=xj, kv_include_self=True))(
        jax.random.PRNGKey(0))
    tree = _perturbed(jax.tree.map(np.asarray, init), 13)
    apply = lambda t: mod.apply(t, cj, context=xj, kv_include_self=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIT_TPU_BACKEND", "interpret")
        if dtype == "float32":
            ref = np.asarray(jax.jit(apply)(tree), np.float32)
        else:
            with jax.disable_jit():
                ref = np.asarray(apply(jax.tree.map(jnp.asarray, tree)).astype(jnp.float32))
    td = getattr(torch, dtype) if dtype != "float32" else None
    attn = Attention(64, 2, 16, cross=True, lowq_cross=lowq, norm_eps=1e-5, dtype=td,
                     device="cpu")
    attn.load_state_dict(from_jax_params(tree, {}), strict=True)
    calls = []
    attn._lowq_cross_attention = lambda *a, f=attn._lowq_cross_attention: calls.append(1) or f(*a)
    with torch.inference_mode():
        out = attn(torch.from_numpy(cls).to(td or torch.float32),
                   torch.from_numpy(ctx).to(td or torch.float32), kv_include_self=True)
    assert calls == ([1] if lowq else [])
    err = float(np.abs(out.float().numpy() - ref).max())
    assert err <= (1e-5 if dtype == "float32" else 2.0**-7) * float(np.abs(ref).max()), err


@pytest.mark.parametrize("lowq", [None, False])
def test_cross_vit_runs_either_cross_path_within_the_fp32_bound(lowq, tiny):
    """The tiny model with the low-query gate left to vit_tpu's FLOP rule (it
    fires: 1 query against 17 and 65 keys at inner 32) and forced off (the
    standard path, on the flash kernel's twin) meets the fp32 bound against
    vit_tpu's gate, in xla mode."""
    cfg, img, tree, jax_logits = tiny
    model = _loaded(cfg, tree)
    calls = []
    for name, mod in model.named_modules():
        if name.endswith(("sm_attends_lg", "lg_attends_sm")):
            mod.lowq_cross = lowq
            mod._lowq_cross_attention = (
                lambda *a, f=mod._lowq_cross_attention: calls.append(1) or f(*a))
    with torch.inference_mode():
        out = model(torch.from_numpy(img)).numpy()
    assert len(calls) == (2 * cfg["depth"] * cfg["cross_attn_depth"] if lowq is None else 0)
    assert float(np.abs(out - jax_logits("float32", "xla")).max()) <= TOL_FP32


def test_preset_geometry_takes_the_low_query_path():
    """At the preset's image, patches and cross-attention width (256 px,
    patches 16 and 64: 257 and 17 tokens; 8 heads of 64) every cross-attention
    takes the low-query path (here at narrow stand-in encoder widths, one
    round), and each encoder sees its stream's token count."""
    model = CrossViT(**dict(CROSS_VIT, sm_dim=16, lg_dim=32, sm_enc_depth=1, lg_enc_depth=1,
                            sm_enc_heads=1, lg_enc_heads=1, sm_enc_dim_head=16,
                            lg_enc_dim_head=16, sm_enc_mlp_dim=16, lg_enc_mlp_dim=16, depth=1,
                            cross_attn_depth=1, num_classes=4), device="cpu")
    calls, seen = [], []
    for name, mod in model.named_modules():
        if name.endswith(("sm_attends_lg", "lg_attends_sm")):
            mod._lowq_cross_attention = (
                lambda *a, f=mod._lowq_cross_attention: calls.append(1) or f(*a))
    for name in ("sm_enc_0", "lg_enc_0"):
        getattr(model, name).register_forward_hook(lambda m, a, o: seen.append(a[0].shape[1]))
    with torch.inference_mode():
        out = model(torch.zeros(1, 256, 256, 3))
    assert calls == [1, 1] and seen == [257, 17] and out.shape == (1, 4)


def test_default_cross_vit_asks_for_the_card():
    cfg, _ = _config(1)
    if torch.cuda.is_available():
        assert next(CrossViT(**cfg).sm_head.parameters()).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            CrossViT(**cfg)


def test_server_answers_requests(tiny):
    cfg, img, tree, _ = tiny
    model = _loaded(cfg, tree)
    size = img.shape[1]
    pipe = InferencePipeline(model, image_size=size, batch_size=4, dtype=torch.float32)
    imgs = np.random.default_rng(2).integers(0, 256, (6, size, size, 3), dtype=np.uint8)
    with BatchingServer(pipe, decoder=JpegDecoder(size=size), max_wait_ms=20) as server:
        futures = [server.submit(im) for im in imgs]
        rows = np.stack([f.result(timeout=60) for f in futures])
    direct = np.concatenate([pipe(imgs[i: i + 1]) for i in range(6)])
    assert rows.shape == (6, 10) and np.isfinite(rows).all()
    np.testing.assert_allclose(rows, direct, atol=1e-5, rtol=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("what,n,dim,heads,eps", ZOO2_ATTN,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_attention_block_kernel_at_cross_vit_shapes(cuda, what, n, dim, heads, eps):
    """Kernel 1 at the preset's two encoder shapes (batch 8; 257 tokens at
    dim 192, 17 at 384; 8 heads of 64, inner 512: the wgmma GEMM at K 192
    and N 192, the core at 17 keys) against its twin, within kernel_tol."""
    from vit_tpu_torch.ops import block_attention as ba

    gen = torch.Generator(device=cuda).manual_seed(n)
    r = lambda *s: torch.randn(*s, generator=gen, device=cuda)
    d = 64
    x = r(8, n, dim).bfloat16()
    args = (x, 1.0 + 0.1 * r(dim), 0.1 * r(dim), (r(dim, 3 * heads * d) / dim**0.5).bfloat16(),
            (r(heads * d, dim) / (heads * d) ** 0.5).bfloat16(), 0.1 * r(dim))
    before = ops.launch_counts()["attention_block"]
    out = ops.attention_block(*args, heads, ln_eps=eps)
    assert ops.launch_counts()["attention_block"] == before + 1
    ref = ba.xla_attention_block(*args, heads, d**-0.5, eps)
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out.float()).all() and err <= kernel_tol(ref, x, out.dtype), err
