"""Training ScalableViT and CrossFormer: the tiny models' loss and gradients
against ``jax.value_and_grad`` of vit_tpu's (ScalableViT also with split key
and value widths in ``reference_block_order``, CrossFormer also with
``reference_quirks``' shared bias and a stage of 1-token windows), an IWSA
window past 1,024 tokens against ``jax.vjp``, kernel 5's Function on strided
views of fused rows and kernel 6's with CrossFormer's biases, with
chip_smoke's planted faults, and the position-bias MLPs cut out of the
graph. AdamW steps, dropout, ``init_params`` and the trainer are in
``tests/test_torch_train_windows_steps.py``.

The helpers are ``tests/test_torch_train_branches.py``'s (``SPECS``). The
card tests carry the ``cuda`` marker: ``python -m pytest --noconftest -m
cuda tests/test_torch_train_windows.py``.
"""

import contextlib

import numpy as np
import pytest
import torch

import chip_smoke as cs
from test_torch_train_branches import (
    FP32_TOL,
    _rel,
    card_step_fills_every_gradient,
    check_loss_and_grads,
    images,
    jax_loss_and_grads,
    model_cases,
    port,
)
from test_torch_train_zoo import _KernelsAsTwins
from vit_tpu_torch import ops
from vit_tpu_torch import train as tt
from vit_tpu_torch.models import scalable_vit as tsv
from vit_tpu_torch.utils import from_jax_params

torch.set_num_threads(2)

FAMILIES = ("scalable_vit", "crossformer")
VARIANTS = ("scalable_vit split", "crossformer quirks")


@pytest.mark.parametrize("model,precision,mode,route", model_cases(FAMILIES) + [
    (m, "fp32", "xla", route) for m in VARIANTS for route in ("twins", "functions")])
def test_loss_and_grads_match_jax(model, precision, mode, route, monkeypatch):
    """ScalableViT (kernel 4 at each SSA's 16-wide keys, kernel 3 in each
    IWSA's windows, kernel 2 in each ConvMLP; stage 1's two blocks scanned
    in vit_tpu; "split": kernel 5 at SSA's 24-wide keys and on the split q,
    k, v views of IWSA's fused rows, ff2 before IWSA) and CrossFormer
    (kernel 6 in each SDA and LDA with its position-bias MLP's bias needing
    a gradient; stage 1's LDA on 1-token windows, where the softmax's
    Jacobian is zero; "quirks": the shared [1, 1, S, S] bias): loss and every
    gradient against ``jax.value_and_grad`` of vit_tpu's, within the bounds
    of ``test_torch_train_branches``. At 1-token windows the q and k
    columns of LDA's ``qkv_kernel``, its DPB's gradients and the bias's are
    zero in vit_tpu: held by size (``GRAD_FLOOR``), as are the DPBs' last
    biases, whose gradient sums each softmax row's dS, zero but for
    rounding (measured at most 4e-10 of the largest gradient's norm).

    CrossFormer's bf16 cross-scale embedding biases are held to vit_tpu's
    fp32 gradients (``CROSS_EMBED_BIASES``)."""
    against = CROSS_EMBED_BIASES if model == "crossformer" and precision == "bf16" else ()
    check_loss_and_grads(model, precision, mode, route, monkeypatch, against_fp32=against)


# The bias gradients of CrossFormer's cross-scale embedding convs in bf16:
# vit_tpu's CPU modes both sum the bf16 cotangent over the map's positions in
# bf16 (1,568 at stage 0), which puts them 0.43 (stage 0) and 0.09 (stage 1)
# from its fp32 gradients in relative L2 in either mode, where the port sums
# in fp32 and lands 0.0056 and 0.0051 from them (measured; the port 0.70
# from vit_tpu's bf16 at stage 0). They are held to vit_tpu's fp32 gradients,
# no farther from them than vit_tpu's bf16 ones.
CROSS_EMBED_BIASES = tuple(f"embed_{s}.conv_{i}.bias" for s in range(2) for i in range(2))


# -- an IWSA window past the fused kernel, kernel 5 on the fused rows' views -----------


def test_iwsa_past_1024_tokens_matches_jax_vjp(monkeypatch):
    """One 36 x 36 IWSA window (1,296 tokens, past ``qkv_kernel_fits``'s
    1,024) on the card's route: ``ops.qkv_attention`` takes
    ``FlashAttentionFn`` on strided q, k, v views of the fused rows (kernel
    5's twin forward, the Q-chunked flash backward over six chunks, the last
    padded). The input's and every parameter's gradient against
    ``jax.vjp`` of vit_tpu's ``_IWSA`` (its kernel 3 under xla's twin),
    fp32, within 1e-5 relative L2 (measured below 1e-6): the views' gradients
    land in their thirds of the fused rows. A backward that swaps the q and
    k thirds (VIEW_BWD_FAULT) is past it."""
    import jax
    import jax.numpy as jnp
    from vit_tpu import ops as jops
    from vit_tpu.models.scalable_vit import _IWSA as JaxIWSA

    rng = np.random.default_rng(36)
    x = rng.standard_normal((1, 36, 36, 32)).astype(np.float32)
    g = rng.standard_normal((1, 36, 36, 32)).astype(np.float32)
    jm = JaxIWSA(32, None, 2, 16, 16)
    params = jax.device_get(jm.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"])
    params = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
                          params)

    def f(p, a):
        with jops.force_backend("xla"):
            return jm.apply({"params": p}, a)

    _, vjp = jax.vjp(f, params, jnp.asarray(x))
    jgrads, jdx = jax.device_get(vjp(jnp.asarray(g)))
    ref = from_jax_params({"params": jgrads}, {})

    def grads(scope):
        tm = tsv._IWSA(32, None, 2, 16, 16, dtype=None, device="cpu")
        tm.load_state_dict(from_jax_params({"params": params}, {}), strict=True)
        with monkeypatch.context() as mp, scope:
            kernels = _KernelsAsTwins(mp)
            xt = torch.from_numpy(x).requires_grad_()
            (tm(xt) * torch.from_numpy(g)).sum().backward()
        assert kernels.launched() == {"flash_attention_kv_blocked": 1}
        return xt.grad, {k: p.grad for k, p in tm.named_parameters()}

    dx, got = grads(contextlib.nullcontext())
    assert _rel(dx, jdx) <= FP32_TOL
    for k, p in got.items():
        assert _rel(p, ref[k]) <= FP32_TOL, (k, _rel(p, ref[k]))
    dx, got = grads(cs.flash_view_swapped())
    assert max(_rel(got[k], ref[k]) for k in ref) > 100 * FP32_TOL


def _fused_views(gen, b, n, heads, d):
    """q, k, v: the strided per-head views of one fused ``[b, n, 3 * heads *
    d]`` tensor, as ``ops.qkv_attention`` takes them."""
    qkv = torch.randn(b, n, 3 * heads * d, generator=gen)
    return list(qkv.view(b, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0))


def test_flash_function_on_fused_row_views_fails_the_view_fault():
    """``check_function`` of kernel 5's Function (its twin forward) on the
    strided q, k, v views of fused rows, 2 heads of 32 over 1,296 tokens (a
    reduced IWSA stage 0): every gradient within kernel_tol's form of
    autograd through the twin, and each planted fault (``function_faults``:
    the flash backward's, and VIEW_BWD_FAULT, which applies only where q and
    k are views of one storage) past it."""
    gen = torch.Generator().manual_seed(5)
    args = _fused_views(gen, 1, 1296, 2, 32) + [None]
    kw = dict(scale=32**-0.5, mask_self=False)
    assert cs.VIEW_BWD_FAULT in cs.function_faults("flash_attention_kv_blocked", args, kw)
    apart = [a.contiguous() for a in args[:3]] + [None]
    assert cs.VIEW_BWD_FAULT not in cs.function_faults("flash_attention_kv_blocked", apart, kw)
    g = torch.randn(1, 2, 1296, 32, generator=gen)
    err = cs.check_function("cpu", "flash_attention_kv_blocked", args, kw, g,
                            forward=cs.twin_forward("flash_attention_kv_blocked"))
    assert err <= 1e-5


# (what, windows, S, C, bias heads or None): CrossFormer's stage-0 SDA with a
# per-head bias and with the quirk's shared one, its 16-token LDA and a
# 1-token LDA, heads of 32.
WINDOW_CASES = (("SDA per head", 4, 49, 64, 2), ("SDA shared", 4, 49, 64, 1),
                ("LDA 16", 6, 16, 64, 2), ("LDA 1", 8, 1, 64, 2))


@pytest.mark.parametrize("what,nw,s,c,bias_heads", WINDOW_CASES)
def test_window_function_with_dpb_bias_fails_its_faults(what, nw, s, c, bias_heads):
    """``check_function`` of kernel 6's Function (its twin forward) at
    CrossFormer's windows, the bias needing a gradient: every gradient
    within kernel_tol's form of autograd through the twin; each planted
    fault (``function_faults``: the LayerNorm gradients swapped; with a
    per-head bias its heads reversed, with a shared one dbias from the first
    head only) past it. At 1-token windows dbias is zero in both: held by
    size, and no bias fault applies."""
    gen = torch.Generator().manual_seed(s)
    heads = c // 32
    args = [torch.randn(nw, s, c, generator=gen), 1 + 0.1 * torch.randn(c, generator=gen),
            0.1 * torch.randn(c, generator=gen),
            torch.randn(c, 3 * c, generator=gen) * c**-0.5,
            torch.randn(c, c, generator=gen) * c**-0.5, 0.1 * torch.randn(c, generator=gen),
            torch.randn(1, bias_heads, s, s, generator=gen)]
    kw = dict(heads=heads, scale=32**-0.5, ln_eps=1e-5)
    faults = cs.function_faults("window_attention_block", args, kw)
    want = {"SDA per head": cs.QKV_BIAS_BWD_FAULTS[1], "SDA shared": cs.WINDOW_BIAS_BWD_FAULT,
            "LDA 16": cs.QKV_BIAS_BWD_FAULTS[1], "LDA 1": None}[what]
    assert faults == list(cs.FUNCTION_FAULTS[1:]) + ([want] if want else [])
    g = torch.randn(nw, s, c, generator=gen)
    err = cs.check_function("cpu", "window_attention_block", args, kw, g,
                            forward=cs.twin_forward("window_attention_block"))
    assert err <= 1e-5


@pytest.mark.parametrize("model", ["crossformer", "crossformer quirks"])
def test_detached_dpb_fails_the_bound(model, monkeypatch):
    """CrossFormer on the card's route (fp32) with DPB_DETACHED_FAULT planted:
    its position-bias MLPs get no gradient, past the 1e-5 bound (the loss
    unmoved)."""
    img, labels = images(0, 2, 112)
    jloss, jgrads = jax_loss_and_grads(model, "fp32", "xla")
    tm = port(model)
    _KernelsAsTwins(monkeypatch)
    with cs.crossformer_dpb_detached(tm):
        loss = tt.cross_entropy_loss(tm(torch.from_numpy(img), train=True),
                                     torch.from_numpy(labels))
        loss.backward()
    ref = from_jax_params({"params": jgrads}, tm.jax_stages)
    over = [k for k, p in tm.named_parameters() if ".dpb." in k and (
        p.grad is None or _rel(p.grad, ref[k]) > FP32_TOL)]
    assert len(over) >= 4, over
    assert abs(loss.item() - jloss) <= FP32_TOL


# -- on the card ------------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("model", FAMILIES + VARIANTS)
def test_a_card_step_fills_every_gradient(cuda, model):
    card_step_fills_every_gradient(model, cuda)


@pytest.mark.cuda
def test_flash_function_on_iwsa_views_matches_its_twin(cuda):
    """Kernel 5's Function on the card on the strided q, k, v views of IWSA
    stage 0's fused rows (4,096 tokens, 2 heads of 32) at batch 2: one
    launch, every gradient within kernel_tol's form of autograd through the
    twin, the planted faults (VIEW_BWD_FAULT among them) past it."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    qkv = torch.randn(2, 4096, 192, generator=gen, device=cuda).bfloat16()
    args = list(qkv.view(2, 4096, 3, 2, 32).permute(2, 0, 3, 1, 4).unbind(0)) + [None]
    kw = dict(scale=32**-0.5, mask_self=False)
    g = torch.randn(2, 2, 4096, 32, generator=gen, device=cuda).bfloat16()
    ops.reset_launch_counts()
    cs.check_function("card", "flash_attention_kv_blocked", args, kw, g)
    assert ops.launch_counts()["flash_attention_kv_blocked"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("what,nw,s,c,bias_heads", WINDOW_CASES)
def test_window_function_with_dpb_bias_on_the_card(cuda, what, nw, s, c, bias_heads):
    """Kernel 6's Function on the card at CrossFormer's windows (batch 8's
    windows), the bias needing a gradient: one launch, every gradient within
    kernel_tol's form of autograd through the twin, the planted faults past
    it."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    r = lambda *shape: torch.randn(*shape, generator=gen, device=cuda)
    args = [r(8 * nw, s, c).bfloat16(), 1 + 0.1 * r(c), 0.1 * r(c),
            (r(c, 3 * c) * c**-0.5).bfloat16(), (r(c, c) * c**-0.5).bfloat16(), 0.1 * r(c),
            r(1, bias_heads, s, s)]
    kw = dict(heads=c // 32, scale=32**-0.5, ln_eps=1e-5)
    g = r(8 * nw, s, c).bfloat16()
    ops.reset_launch_counts()
    cs.check_function("card", "window_attention_block", args, kw, g)
    assert ops.launch_counts()["window_attention_block"] == 1
