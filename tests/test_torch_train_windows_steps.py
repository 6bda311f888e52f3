"""Training ScalableViT and CrossFormer, the trainer's side: AdamW steps
against ``vit_tpu.train.make_train_step``, dropout with planted keep masks,
``init_params`` against flax's ``init``, the trainer and its CLI, the
constructors' dropout. The loss and gradients, the Functions and their
planted faults, and the card tests are in ``tests/test_torch_train_windows.py``.

The helpers are ``tests/test_torch_train_branches.py``'s (``SPECS``).
"""

import pytest
import torch

from test_torch_train_branches import (
    check_adamw_steps,
    check_dropout,
    check_init_params,
    check_trainer_and_cli,
    port,
)
from test_torch_train_windows import FAMILIES

torch.set_num_threads(2)


# -- AdamW, dropout, init, the trainer ------------------------------------------------------


def _one_token_zeros(tm):
    """The values of the tiny CrossFormer whose gradient is zero by
    construction: stage 1's LDA attends 1-token windows, where the softmax's
    Jacobian is zero, so the q and k columns of its ``qkv_kernel`` and its
    position-bias MLP get none (8,866 of 352,214 values)."""
    lda = tm.stage_1[0].lda
    return 2 * lda.qkv_kernel.shape[1] // 3 * lda.qkv_kernel.shape[0] + sum(
        p.numel() for p in lda.dpb.parameters())


@pytest.mark.parametrize("model", FAMILIES)
def test_adamw_steps_match_jax(model):
    """Two AdamW updates against vit_tpu's (test_torch_train_branches'
    rule; CrossFormer's values with a gradient zero by construction left out
    of KEPT_SHARE's count: with them 96.97% of its values kept their
    gradient above ADAM_TAU in the first update, without them 99.48%)."""
    check_adamw_steps(model, _one_token_zeros if model == "crossformer" else None)


@pytest.mark.parametrize("model", FAMILIES + ("scalable_vit split",))
def test_dropout_with_planted_masks_matches_jax(model, monkeypatch):
    """ScalableViT at dropout 0.25 (each SSA's and IWSA's ``drop`` after
    ``to_out``, their attention still on the kernels' route; each ConvMLP's
    ``drop1`` and ``drop2`` on the plain path; stage 1's scanned blocks in
    vit_tpu's order; "split": ff2 before IWSA) and CrossFormer at
    attn_dropout and ff_dropout 0.25 (``drop`` after each attention's
    inverse partition, kernel 6 still running; each ConvMLP's two): one
    queue of planted masks, the same draws, loss and gradients within
    1e-5."""
    check_dropout(model, monkeypatch)


@pytest.mark.parametrize("model", FAMILIES)
def test_init_params_matches_flax_init(model):
    check_init_params(model)


@pytest.mark.parametrize("name", FAMILIES)
def test_trainer_and_cli_take_the_family(name, tmp_path, capsys):
    check_trainer_and_cli(name, tmp_path, capsys)


def test_constructors_take_their_dropout():
    """ScalableViT's ``dropout`` reaches every SSA, IWSA and ConvMLP;
    CrossFormer's ``attn_dropout`` every SDA and LDA, its ``ff_dropout``
    every ConvMLP (0 by default, as vit_tpu's)."""
    rates = lambda tm: {(type(m).__name__, m.dropout) for m in tm.modules()
                        if type(m).__name__ in ("_SSA", "_IWSA", "_LSDAttention", "ConvMLP")}
    assert rates(port("scalable_vit", dropout=0.3)) == {("_SSA", 0.3), ("_IWSA", 0.3),
                                                        ("ConvMLP", 0.3)}
    assert rates(port("crossformer", attn_dropout=0.2, ff_dropout=0.3)) == {
        ("_LSDAttention", 0.2), ("ConvMLP", 0.3)}
    assert rates(port("crossformer")) == {("_LSDAttention", 0.0), ("ConvMLP", 0.0)}
