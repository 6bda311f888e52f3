"""The port's SimpleViT, ParallelViT and EfficientViT against vit_tpu's on the
CPU: the sin-cos embedding and the mean pool bitwise against JAX's,
chip_smoke's weight draws against vit_tpu's init trees, the parallel
branches' names and sum, the tiny models in both of vit_tpu's CPU modes
(``xla``, and ``interpret``: the Pallas kernels in interpreter mode), and
serving. On the card: kernel 3 at ParallelViT's preset shape and kernel 2
at every family's, each against its twin (kernel 1 at SimpleViT's and
EfficientViT's shapes is in ``tests/test_torch_pit.py``).

The tiny models are the families' ``MODEL_REGISTRY`` configs of vit_tpu
(depth 2: SimpleViT's and EfficientViT's stacks scanned, on the fused
attention block's twin; ParallelViT's two branches a layer unfused, on the
fused-qkv twin) and the same at depth 1 (unscanned and unfused; ParallelViT
with three branches). Parameters are drawn by chip_smoke's ``*_tree`` functions
and perturbed, so that no bias or LayerNorm parameter is a constant.
"""

import importlib

import numpy as np
import pytest
import torch

from chip_smoke import (
    EFFICIENT,
    PARALLEL_N,
    PARALLEL_VIT,
    SIMPLE_VIT,
    ZOO_MLP,
    efficient_tree,
    kernel_tol,
    parallel_vit_tree,
    simple_vit_tree,
)
from vit_tpu_torch import ops
from vit_tpu_torch.data import JpegDecoder
from vit_tpu_torch.models import EfficientViT, ParallelViT, SimpleViT
from vit_tpu_torch.nn import Transformer, mean_tokens
from vit_tpu_torch.pipeline import InferencePipeline
from vit_tpu_torch.serving import BatchingServer
from vit_tpu_torch.utils import from_jax_params

torch.set_num_threads(2)

PRESETS = {"simple_vit": SIMPLE_VIT, "parallel_vit": PARALLEL_VIT, "efficient": EFFICIENT}
TREES = {"simple_vit": simple_vit_tree, "parallel_vit": parallel_vit_tree,
         "efficient": efficient_tree}
# (family, depth) of the tiny models; ParallelViT at depth 1 with 3 branches
VARIANTS = [("simple_vit", 2), ("simple_vit", 1), ("parallel_vit", 2), ("parallel_vit", 1),
            ("efficient", 2), ("efficient", 1)]

# Max |logit| difference allowed (|logits| up to 3.3 on these inputs).
# fp32: every op in fp32 on both sides, summed in other orders: 1e-4
#   (measured 7.2e-7 to 1.8e-6, both modes).
# bf16: the port rounds where vit_tpu's kernels and modules round, but the
#   patch embedding's fp32 product sums in another order, which can flip one
#   bf16 value of the stream (1 of 2048 in EfficientViT at depth 1), and
#   under jit XLA keeps some bf16 values in fp32 (excess precision) and
#   fuses its own bf16 attention path. So vit_tpu's own two modes differ by
#   0.0046 to 0.0165 here. Against interpret mode the ViT test's 4e-3 holds
#   for SimpleViT at depth 2 only (HOLDS_4E3, measured 0.0036); elsewhere,
#   and against xla mode, the bound is twice the larger of vit_tpu's own
#   xla-vs-interpret gap and 0.02. Measured, the port from xla / interpret
#   (the gap):
#     simple_vit depth 2    0.0071 / 0.0036 (0.0059)
#     simple_vit depth 1    0.0100 / 0.0070 (0.0046)
#     parallel_vit depth 2  0.0193 / 0.0149 (0.0165)
#     parallel_vit depth 1  0.0086 / 0.0106 (0.0086)  (three branches)
#     efficient depth 2     0.0094 / 0.0145 (0.0114)
#     efficient depth 1     0.0062 / 0.0055 (0.0060)
TOL_FP32, TOL_BF16_INTERPRET = 1e-4, 4e-3
HOLDS_4E3 = {("simple_vit", 2)}


def _config(fam, depth):
    """vit_tpu's registry config of ``fam`` at ``depth``, in chip_smoke's
    form (EfficientViT's encoder as a dict), and its image size."""
    from vit_tpu.models import MODEL_REGISTRY

    _, cfg, size = MODEL_REGISTRY[fam]
    cfg = dict(cfg)
    if fam == "efficient":
        t = cfg["transformer"]
        cfg["transformer"] = dict(dim=t.dim, depth=depth, heads=t.heads, dim_head=t.dim_head,
                                  mlp_dim=t.mlp_dim)
    else:
        cfg["depth"] = depth
    if fam == "parallel_vit" and depth == 1:
        cfg["num_parallel_branches"] = 3
    return cfg, size


def _depth(fam, cfg):
    return cfg["transformer"]["depth"] if fam == "efficient" else cfg["depth"]


def _jax_model(fam, cfg, dtype=None):
    from vit_tpu import models as jm
    from vit_tpu.nn.blocks import Transformer as JaxTransformer

    if fam == "efficient":
        return jm.EfficientViT(**{**cfg, "transformer": JaxTransformer(**cfg["transformer"])},
                               dtype=dtype)
    return {"simple_vit": jm.SimpleViT, "parallel_vit": jm.ParallelViT}[fam](**cfg, dtype=dtype)


def _port_model(fam, cfg, dtype=None, device="cpu"):
    if fam == "efficient":
        return EfficientViT(**cfg, dtype=dtype, device=device)
    return {"simple_vit": SimpleViT, "parallel_vit": ParallelViT}[fam](**cfg, dtype=dtype,
                                                                      device=device)


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    perturb = lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(np.float32)
    walk = lambda t: {k: walk(v) if isinstance(v, dict) else perturb(v) for k, v in t.items()}
    return walk(tree)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


@pytest.fixture(scope="module", params=VARIANTS, ids=[f"{f}-depth{d}" for f, d in VARIANTS])
def tiny(request):
    fam, depth = request.param
    cfg, size = _config(fam, depth)
    img = np.random.default_rng(0).standard_normal((2, size, size, 3)).astype(np.float32)
    return fam, cfg, img, _perturbed(TREES[fam](cfg, seed=3), seed=4)


def _jax_logits(fam, cfg, tree, img, dtype, mode, monkeypatch):
    import jax
    import jax.numpy as jnp

    jd = getattr(jnp, dtype) if dtype != "float32" else None
    monkeypatch.setenv("VIT_TPU_BACKEND", mode)
    return np.asarray(jax.jit(_jax_model(fam, cfg, jd).apply)(tree, jnp.asarray(img)), np.float32)


def _loaded(fam, cfg, tree, dtype=None):
    model = _port_model(fam, cfg, dtype)
    model.load_state_dict(from_jax_params(tree, model.jax_stages), strict=True)
    return model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,w,dim", [(8, 8, 1024), (4, 4, 64), (3, 5, 16), (16, 16, 512)])
def test_posemb_sincos_2d_is_bitwise_jax(h, w, dim, dtype):
    import jax.numpy as jnp
    from vit_tpu.ops.patch_embed import posemb_sincos_2d as jax_posemb

    ref = np.asarray(jax_posemb(h, w, dim, dtype=getattr(jnp, dtype)).astype(jnp.float32))
    out = ops.posemb_sincos_2d(h, w, dim, dtype=getattr(torch, dtype))
    assert out.dtype == getattr(torch, dtype) and out.shape == (h * w, dim)
    np.testing.assert_array_equal(out.float().numpy(), ref)


@pytest.mark.parametrize("shape", [(4, 65, 64), (2, 16, 1024), (3, 257, 32)])
def test_mean_tokens_is_bitwise_jnp_mean(shape):
    """The mean pool on a bf16 stream: jnp.mean sums in fp32, divides by n in
    fp32 and rounds once to bf16; so does ``mean_tokens``."""
    import jax.numpy as jnp

    rng = np.random.default_rng(shape[1])
    for scale in (0.1, 1.0, 30.0):
        x = (scale * rng.standard_normal(shape)).astype(np.float32)
        ref = np.asarray(jnp.mean(jnp.asarray(x, jnp.bfloat16), axis=1).astype(jnp.float32))
        out = mean_tokens(torch.from_numpy(x).bfloat16())
        assert out.dtype == torch.bfloat16
        np.testing.assert_array_equal(out.float().numpy(), ref)


@pytest.mark.parametrize("fam", list(PRESETS))
@pytest.mark.parametrize("cfg", ["preset", "tiny depth 2", "tiny depth 1"])
def test_trees_have_the_names_and_shapes_of_init(fam, cfg):
    import jax
    import jax.numpy as jnp

    c, size = (PRESETS[fam], 256) if cfg == "preset" else _config(fam, int(cfg[-1]))
    want = jax.eval_shape(_jax_model(fam, c).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, size, size, 3), jnp.float32))
    assert _leaves(TREES[fam](c, seed=0)) == _leaves(jax.tree.map(lambda a: a, want))


def test_parallel_branches_carry_vit_tpus_names():
    """Layer i's branches sit on the stack as ``attn_{i}_{b}`` / ``ff_{i}_{b}``,
    so ``encoder/attn_0_1/...`` maps by the plain ``a/b/c -> a.b.c`` rule;
    the FF branches keep LayerNorm eps 1e-6 and the tanh GELU whatever the
    stack's ``norm_eps`` and ``activation`` (vit_tpu builds them without)."""
    enc = Transformer(16, 2, 2, 8, 32, parallel_branches=3, norm_eps=1e-5,
                      activation="gelu_exact", device="cpu")
    names = {k.split(".")[0] for k in enc.state_dict()}
    assert names == {f"{kind}_{i}_{b}" for kind in ("attn", "ff") for i in range(2)
                     for b in range(3)}
    assert enc.jax_stages == {} and Transformer(16, 2, 2, 8, 32, device="cpu").jax_stages == {
        "blocks": 2}
    assert enc.attn_1_2.norm_eps == 1e-5
    assert (enc.ff_1_2.ln_eps, enc.ff_1_2.activation) == (1e-6, "gelu")


@pytest.mark.parametrize("dtype,mode", [("float32", "xla"), ("float32", "interpret"),
                                        ("bfloat16", "xla"), ("bfloat16", "interpret")])
def test_family_matches_jax(dtype, mode, tiny, monkeypatch):
    fam, cfg, img, tree = tiny
    ref = _jax_logits(fam, cfg, tree, img, dtype, mode, monkeypatch)
    model = _loaded(fam, cfg, tree, getattr(torch, dtype) if dtype != "float32" else None)
    ops.reset_launch_counts()
    with torch.inference_mode():
        out = model(torch.from_numpy(img))
    assert sum(ops.launch_counts().values()) == 0
    assert out.dtype == torch.float32 and out.shape == (2, 10)  # fp32 heads, as JAX's
    err = float(np.abs(out.numpy() - ref).max())
    if dtype == "float32":
        assert err <= TOL_FP32, err
    elif mode == "interpret" and (fam, _depth(fam, cfg)) in HOLDS_4E3:
        assert err <= TOL_BF16_INTERPRET, err
    else:
        other = _jax_logits(fam, cfg, tree, img, dtype, "interpret" if mode == "xla" else "xla",
                            monkeypatch)
        control = float(np.abs(other - ref).max())
        assert err <= 2 * max(control, 0.02), (err, control)


def _fused_chain(self, x, **_):
    """A planted fault: each layer's branches as fused blocks (the residual
    inside each), run one after another like the layers of a plain stack.
    The training keywords ``Transformer.forward`` takes are ignored: the
    test runs inference."""
    for i in range(self.depth):
        for kind in ("attn", "ff"):
            for b in range(self.branches):
                branch = getattr(self, f"{kind}_{i}_{b}")
                x = branch(x) if kind == "attn" else x + branch(x)
    return x


@pytest.mark.parametrize("fault", ["branches fused", "residual inside each branch"])
def test_parallel_vit_faults_fail_the_bound(fault, monkeypatch):
    """A ParallelViT whose branches run as fused blocks one after another, or
    whose attention branches each add the residual before the sum, must miss
    the fp32 bound that the port meets."""
    cfg, size = _config("parallel_vit", 2)
    img = np.random.default_rng(0).standard_normal((2, size, size, 3)).astype(np.float32)
    tree = _perturbed(parallel_vit_tree(cfg, seed=3), seed=4)
    ref = _jax_logits("parallel_vit", cfg, tree, img, "float32", "xla", monkeypatch)
    model = _loaded("parallel_vit", cfg, tree)
    with torch.inference_mode():
        good = float(np.abs(model(torch.from_numpy(img)).numpy() - ref).max())
        for name, mod in model.encoder.named_children():
            if name.startswith("attn"):
                mod.fuse_residual = True  # the branch returns x + delta
        if fault == "branches fused":
            monkeypatch.setattr(Transformer, "forward", _fused_chain)
        bad = float(np.abs(model(torch.from_numpy(img)).numpy() - ref).max())
    assert good <= TOL_FP32 < bad, (good, bad)


@pytest.mark.parametrize("fam", list(PRESETS))
def test_default_constructors_ask_for_the_card(fam):
    cfg, _ = _config(fam, 1)
    if fam == "efficient":  # the shell's own default, around an encoder on the CPU
        t = cfg["transformer"]
        enc = Transformer(t["dim"], 1, t["heads"], t["dim_head"], t["mlp_dim"], device="cpu")
        build = lambda: EfficientViT(**{**cfg, "transformer": enc})
    else:
        build = lambda: {"simple_vit": SimpleViT, "parallel_vit": ParallelViT}[fam](**cfg)
    if torch.cuda.is_available():
        assert next(build().head.parameters()).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            build()


def test_simple_vit_takes_channels_first():
    cfg, size = _config("simple_vit", 1)
    tree = _perturbed(simple_vit_tree(cfg, seed=3), seed=4)
    img = np.random.default_rng(1).standard_normal((2, size, size, 3)).astype(np.float32)
    nhwc = _loaded("simple_vit", cfg, tree)
    nchw = SimpleViT(**cfg, channels_first=True, device="cpu")
    nchw.load_state_dict(nhwc.state_dict(), strict=True)
    with torch.inference_mode():
        a = nhwc(torch.from_numpy(img))
        b = nchw(torch.from_numpy(img).permute(0, 3, 1, 2).contiguous())
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("fam", list(PRESETS))
def test_server_answers_requests(fam):
    cfg, size = _config(fam, 2)
    model = _loaded(fam, cfg, _perturbed(TREES[fam](cfg, seed=3), seed=4))
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
@pytest.mark.parametrize("b", [8, 128])
def test_qkv_attention_kernel_at_parallel_vit_shape(cuda, b):
    """Kernel 3 at ParallelViT's preset shape (257 tokens, 8 heads of 64:
    the core's streamed variant) against its twin, within chip_smoke's
    kernel_tol, reached through ``ops.qkv_attention`` as a branch reaches
    it."""
    qa = importlib.import_module("vit_tpu_torch.ops.qkv_attention")
    gen = torch.Generator(device=cuda).manual_seed(b)
    qkv = torch.randn(b, PARALLEL_N, 3 * 512, generator=gen, device=cuda).bfloat16()
    before = ops.launch_counts()["qkv_attention"]
    out = ops.qkv_attention(qkv, 8)
    assert ops.launch_counts()["qkv_attention"] == before + 1
    ref = qa.xla_qkv_attention(qkv, 8)
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out.float()).all() and err <= kernel_tol(ref, None, out.dtype), err


@pytest.mark.cuda
@pytest.mark.parametrize("what,n,dim,f,eps", ZOO_MLP,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_mlp_kernel_at_family_shapes(cuda, what, n, dim, f, eps):
    """Kernel 2 at each family's preset shape (batch 8, each family's
    LayerNorm eps, without the residual as FeedForward calls it) against its
    twin, within chip_smoke's kernel_tol."""
    from vit_tpu_torch.ops.fused_mlp import reference_mlp

    gen = torch.Generator(device=cuda).manual_seed(n + dim)
    r = lambda *s: torch.randn(*s, generator=gen, device=cuda)
    args = (r(8, n, dim).bfloat16(), (r(dim, f) / dim**0.5).bfloat16(), 0.1 * r(f),
            (r(f, dim) / f**0.5).bfloat16(), 0.1 * r(dim), 1.0 + 0.1 * r(dim), 0.1 * r(dim))
    kw = dict(activation="gelu", residual=False, ln_eps=eps)
    before = ops.launch_counts()["fused_mlp"]
    out = ops.mlp(*args, **kw)
    assert ops.launch_counts()["fused_mlp"] == before + 1
    ref = reference_mlp(*args, **kw)
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out.float()).all() and err <= kernel_tol(ref, None, out.dtype), err
