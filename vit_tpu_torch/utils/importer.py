"""Reference-checkpoint importer (port of ``vit_tpu/utils/importer.py``).

The reference ``vit-flax`` models name their parameters by flax call order
(``Transformer_0/Attention_3/Dense_0``: its blocks are stacked by a Python
loop). Each ``import_reference_*_params`` maps such a tree onto
``vit_tpu``'s named layout, leaf for leaf the tree ``vit_tpu``'s function of
the same name returns, as numpy arrays; ``from_jax_params(tree,
model.jax_stages)`` then loads it into the port's model::

    tree = import_reference_vit_params(ref_variables, depth=6)
    model = ViT(**cfg, dtype=torch.bfloat16)          # on the card
    model.load_state_dict(from_jax_params(tree, model.jax_stages))

A reference tree is a nested dict of arrays (numpy, or anything
``np.asarray`` takes), with or without its top ``params`` key (CvT and
LeViT: ``params`` and ``batch_stats``). Every leaf keeps its dtype; the
zeros put in for the reference's missing biases take the dtype of the
leaf beside them where ``vit_tpu`` uses ``zeros_like``, else fp32 (JAX's
default). Numpy only: no leaf goes through torch, JAX or ``ml_dtypes``.

PatchMerger's queries are the reference's fixed ``jax.random.normal(
PRNGKey(0), (tokens, dim))`` draw (its bug register #4), reproduced bit for
bit by ``_jax_normal``: jax's default threefry2x32 generator
(``jax_threefry_partitionable``), its uniform draw, and XLA's fp32
``erf_inv`` as its CPU backend evaluates it.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from vit_tpu_torch.core.xla_math import fma, lsa_log_temperature, xla_logf

_F32 = np.float32


def _params(ref):
    return ref["params"] if "params" in ref else ref


def _zeros(n: int):
    return np.zeros((n,), _F32)


def _stack(*trees):
    """``jax.tree.map(lambda *xs: jnp.stack(xs), *trees)``: the layers of a
    scanned stack along a leading depth axis."""
    if isinstance(trees[0], dict):
        return {k: _stack(*(t[k] for t in trees)) for k in trees[0]}
    return np.stack([np.asarray(t) for t in trees])


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _encoder(layer, depth: int, scan: bool) -> Dict[str, Any]:
    """Layers ``i -> (attn, ff)`` stacked under ``blocks`` (``scan`` and
    depth > 1), else named ``attn_{i}`` / ``ff_{i}``."""
    encoder: Dict[str, Any] = {}
    if scan and depth > 1:
        attns, ffs = zip(*(layer(i) for i in range(depth)))
        encoder["blocks"] = {"attn": _stack(*attns), "ff": _stack(*ffs)}
    else:
        for i in range(depth):
            encoder[f"attn_{i}"], encoder[f"ff_{i}"] = layer(i)
    return encoder


def _ff(ff, norm, ln_bias=None):
    """A FeedForward's ``Dense_0`` / ``Dense_1`` behind its LayerNorm."""
    scale = norm["scale"]
    return {"ln_scale": scale,
            "ln_bias": np.zeros_like(scale) if ln_bias is None else ln_bias,
            "w1": ff["Dense_0"]["kernel"], "b1": ff["Dense_0"]["bias"],
            "w2": ff["Dense_1"]["kernel"], "b2": ff["Dense_1"]["bias"]}


def _conv_mlp(m, norm):
    """A 1x1-conv MLP (``Conv_0`` / ``Conv_1``) behind a bias-free norm."""
    return {"ff": {"ln_scale": norm["scale"], "ln_bias": np.zeros_like(norm["scale"]),
                   "w1": _conv1x1_to_dense(m["Conv_0"])["kernel"], "b1": m["Conv_0"]["bias"],
                   "w2": _conv1x1_to_dense(m["Conv_1"])["kernel"], "b2": m["Conv_1"]["bias"]}}


def _channel_norm(ln):
    """A channel LayerNorm's ``g`` / ``b`` -> ``scale`` / ``bias``."""
    return {"scale": np.reshape(ln["g"], -1), "bias": np.reshape(ln["b"], -1)}


def import_reference_deepvit_params(ref_params: Dict[str, Any], depth: int, *,
                                    scan: bool = True) -> Dict[str, Any]:
    """A reference ``deepvit.py`` tree -> ``DeepViT``'s: ``vit.py``'s layout
    plus each Attention's ``reattn_weights`` and re-attention LayerNorm,
    stacked under ``scan`` as the encoder is (``vit_tpu``'s docstring says
    per-layer always; its code stacks, and this follows the code)."""
    tr = _params(ref_params)["Transformer_0"]
    out = import_reference_vit_params(ref_params, depth, scan=scan)
    enc = out["params"]["encoder"]

    def reattn(i):
        a = tr[f"Attention_{i}"]
        ln = a["LayerNorm_0"]
        return {"reattn_weights": np.asarray(a["reattn_weights"]),
                "reattn_scale": np.asarray(ln["scale"]), "reattn_bias": np.asarray(ln["bias"])}

    if scan and depth > 1:
        enc["blocks"]["attn"].update(_stack(*(reattn(i) for i in range(depth))))
    else:
        for i in range(depth):
            enc[f"attn_{i}"].update(reattn(i))
    return out


def import_reference_lsa_params(ref_params: Dict[str, Any], depth: int, dim_head: int = 64, *,
                                scan: bool = True) -> Dict[str, Any]:
    """A reference ``vit_small_datasets.py`` tree -> ``ViTSmallDatasets``'s:
    ``SPT_0``, ``Transformer_0/{LSA_i, FeedForward_i, PreNorm_i}`` (scale-only
    norms), the head's ``LayerNorm_0`` and ``Dense_0``. The reference's
    constant temperature becomes the learned ``log_temperature`` at the same
    value, ``core.xla_math.lsa_log_temperature(dim_head)`` (the model's own
    init value too)."""
    p = _params(ref_params)
    tr = p["Transformer_0"]
    log_tau = lsa_log_temperature(dim_head)

    def layer(i):
        norm = tr[f"PreNorm_{2 * i}"]["LayerNorm_0"]
        attn = tr[f"LSA_{i}"]
        return ({"norm_scale": norm["scale"], "norm_bias": np.zeros_like(norm["scale"]),
                 "qkv_kernel": attn["Dense_0"]["kernel"],
                 "out_kernel": attn["Dense_1"]["kernel"], "out_bias": attn["Dense_1"]["bias"],
                 "log_temperature": log_tau},
                _ff(tr[f"FeedForward_{i}"], tr[f"PreNorm_{2 * i + 1}"]["LayerNorm_0"]))

    head_scale = p["LayerNorm_0"]["scale"]
    spt = p["SPT_0"]
    return _numpy({"params": {
        "cls": p["cls"],
        "pos_embedding": p["pos_embedding"],
        "spt": {"norm": {"scale": spt["LayerNorm_0"]["scale"]},
                "proj": {"kernel": spt["Dense_0"]["kernel"], "bias": spt["Dense_0"]["bias"]}},
        "encoder": _encoder(layer, depth, scan),
        "head_norm": {"scale": head_scale, "bias": np.zeros_like(head_scale)},
        "head": {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]},
    }})


def import_reference_simple_vit_params(ref_params: Dict[str, Any], depth: int, *,
                                       scan: bool = True) -> Dict[str, Any]:
    """A reference ``simple_vit.py`` tree -> ``SimpleViT``'s: ``Dense_1`` the
    patch projection, ``Dense_0`` the head, ``LayerNorm_0`` the head norm
    (scale only); the layer norms sit inside ``Attention_i`` /
    ``FeedForward_i`` without biases, and the out projection has none: zeros
    where ``vit_tpu`` keeps biases."""
    p = _params(ref_params)
    tr = p["Transformer_0"]

    def layer(i):
        attn, ff = tr[f"Attention_{i}"], tr[f"FeedForward_{i}"]
        zeros = np.zeros_like(attn["LayerNorm_0"]["scale"])
        return ({"norm_scale": attn["LayerNorm_0"]["scale"], "norm_bias": zeros,
                 "qkv_kernel": attn["Dense_0"]["kernel"],
                 "out_kernel": attn["Dense_1"]["kernel"], "out_bias": zeros},
                _ff(ff, ff["LayerNorm_0"], ln_bias=zeros))

    return _numpy({"params": {
        "patch_embed": {"proj": {"kernel": p["Dense_1"]["kernel"],
                                 "bias": p["Dense_1"]["bias"]}},
        "encoder": _encoder(layer, depth, scan),
        "head_norm": {"scale": p["LayerNorm_0"]["scale"]},
        "head": {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]},
    }})


def _encoder_layers(tr, depth, *, scan):
    """The vit-style Transformer: ``Attention_i`` / ``FeedForward_i`` behind
    ``PreNorm_{2i}`` / ``PreNorm_{2i+1}`` -> raw-parameter blocks, stacked
    under ``scan``. A norm without a bias gets zeros like its scale; an
    attention without ``Dense_1`` (no out projection) gets no ``out_*``; an
    out projection without a bias gets fp32 zeros."""

    def layer(i):
        attn_norm = tr[f"PreNorm_{2 * i}"]["LayerNorm_0"]
        ff_norm = tr[f"PreNorm_{2 * i + 1}"]["LayerNorm_0"]
        attn = tr[f"Attention_{i}"]
        a = {"norm_scale": attn_norm["scale"],
             "norm_bias": attn_norm.get("bias", np.zeros_like(attn_norm["scale"])),
             "qkv_kernel": attn["Dense_0"]["kernel"]}
        if "Dense_1" in attn:
            out = attn["Dense_1"]
            a["out_kernel"] = out["kernel"]
            a["out_bias"] = out.get("bias", _zeros(np.shape(out["kernel"])[1]))
        return a, _ff(tr[f"FeedForward_{i}"], ff_norm, ln_bias=ff_norm.get("bias"))

    return _encoder(layer, depth, scan)


def import_reference_t2t_params(ref_params: Dict[str, Any], depth: int,
                                n_t2t_layers: int = 3) -> Dict[str, Any]:
    """A reference ``t2t.py`` tree -> ``T2TViT``'s: each
    ``RearrangeUnfoldTransformer_i`` but the last holds a one-head depth-1
    Transformer without an out projection (always unscanned), ``Dense_0``
    the tokenizer's projection, ``Transformer_0`` the encoder (stacked),
    ``LayerNorm_0`` + ``Dense_1`` the head."""
    p = _params(ref_params)
    out: Dict[str, Any] = {
        "cls": p["cls"],
        "pos_embedding": p["pos_embedding"],
        "proj": {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]},
        "encoder": _encoder_layers(p["Transformer_0"], depth, scan=True),
        "head_norm": {"scale": p["LayerNorm_0"]["scale"]},
        "head": {"kernel": p["Dense_1"]["kernel"], "bias": p["Dense_1"]["bias"]},
    }
    for i in range(n_t2t_layers - 1):  # the last tokenizer layer has no transformer
        tr = p[f"RearrangeUnfoldTransformer_{i}"]["Transformer_0"]
        out[f"t2t_{i}"] = _encoder_layers(tr, 1, scan=False)
    return _numpy({"params": out})


def import_reference_pit_params(ref_params: Dict[str, Any], depth: int) -> Dict[str, Any]:
    """A reference ``pit.py`` tree -> ``PiT``'s, single-stage configs only:
    the reference's Pool never runs (its ``not_last`` bug), so its
    multi-stage models are a flat encoder, while ``PiT`` pools. Call order
    names the head ``Dense_0`` and the patch projection ``Dense_1``."""
    p = _params(ref_params)
    return _numpy({"params": {
        "cls": p["cls"],
        "pos_embedding": p["pos_embedding"],
        "proj": {"kernel": p["Dense_1"]["kernel"], "bias": p["Dense_1"]["bias"]},
        "stage_0": _encoder_layers(p["Transformer_0"], depth, scan=True),
        "head_norm": {"scale": p["LayerNorm_0"]["scale"]},
        "head": {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]},
    }})


def _split_qkv_encoder_layers(tr, depth, *, scan):
    """A vit-style encoder whose Attention keeps split q (``Dense_0``), kv
    (``Dense_1``) and out (``Dense_2``) kernels: q and kv concatenate into
    the fused ``qkv_kernel``."""

    def layer(i):
        norm = tr[f"PreNorm_{2 * i}"]["LayerNorm_0"]
        attn = tr[f"Attention_{i}"]
        return ({"norm_scale": norm["scale"], "norm_bias": np.zeros_like(norm["scale"]),
                 "qkv_kernel": np.concatenate([attn["Dense_0"]["kernel"],
                                               attn["Dense_1"]["kernel"]], axis=1),
                 "out_kernel": attn["Dense_2"]["kernel"], "out_bias": attn["Dense_2"]["bias"]},
                _ff(tr[f"FeedForward_{i}"], tr[f"PreNorm_{2 * i + 1}"]["LayerNorm_0"]))

    return _encoder(layer, depth, scan)


def import_reference_cross_vit_params(ref_params: Dict[str, Any], *, depth: int,
                                      sm_enc_depth: int, lg_enc_depth: int,
                                      cross_attn_depth: int) -> Dict[str, Any]:
    """A reference ``cross_vit.py`` tree -> ``CrossViT``'s:
    ``ImageEmbedder_{0,1}``; ``MultiScaleEncoder_0`` with
    ``Transformer_{2d}`` (small) / ``Transformer_{2d+1}`` (large) and
    ``CrossTransformer_d``, whose cross ``Attention_{2j}`` / ``_{2j+1}``
    sit beside ``ProjectInOut_{2j}`` (small attends large) /
    ``ProjectInOut_{2j+1}`` and scale-only PreNorms; the heads
    ``LayerNorm_{0,1}`` + ``Dense_{0,1}``."""
    p = _params(ref_params)
    msa = p["MultiScaleEncoder_0"]
    out: Dict[str, Any] = {}
    for branch, emb in (("sm", "ImageEmbedder_0"), ("lg", "ImageEmbedder_1")):
        e = p[emb]
        out[f"{branch}_embedder"] = {
            "cls": e["cls"], "pos_embedding": e["pos_embedding"],
            "patch_embed": {"proj": {"kernel": e["Dense_0"]["kernel"],
                                     "bias": e["Dense_0"]["bias"]}}}

    def dense(d):
        return {"kernel": d["kernel"], "bias": d["bias"]}

    def cross_attention(ct, j):
        attn, norm = ct[f"Attention_{j}"], ct[f"PreNorm_{j}"]["LayerNorm_0"]
        return {"norm": {"scale": norm["scale"], "bias": np.zeros_like(norm["scale"])},
                "to_q": {"kernel": attn["Dense_0"]["kernel"]},
                "to_kv": {"kernel": attn["Dense_1"]["kernel"]},
                "to_out": dense(attn["Dense_2"])}

    for d in range(depth):
        for branch, tr, enc_depth in (("sm", msa[f"Transformer_{2 * d}"], sm_enc_depth),
                                      ("lg", msa[f"Transformer_{2 * d + 1}"], lg_enc_depth)):
            enc = _split_qkv_encoder_layers(tr, enc_depth, scan=True)
            fn = tr["LayerNorm_0"]
            enc["final_norm"] = {"scale": fn["scale"], "bias": np.zeros_like(fn["scale"])}
            out[f"{branch}_enc_{d}"] = enc
        ct = msa[f"CrossTransformer_{d}"]
        for j in range(cross_attn_depth):
            sm_pio, lg_pio = ct[f"ProjectInOut_{2 * j}"], ct[f"ProjectInOut_{2 * j + 1}"]
            out[f"cross_{d}_{j}"] = {
                "sm_attends_lg_proj_in": dense(sm_pio["Dense_0"]),
                "sm_attends_lg_proj_out": dense(sm_pio["Dense_1"]),
                "sm_attends_lg": cross_attention(ct, 2 * j),
                "lg_attends_sm_proj_in": dense(lg_pio["Dense_0"]),
                "lg_attends_sm_proj_out": dense(lg_pio["Dense_1"]),
                "lg_attends_sm": cross_attention(ct, 2 * j + 1),
            }
    out["sm_head_norm"] = {"scale": p["LayerNorm_0"]["scale"]}
    out["lg_head_norm"] = {"scale": p["LayerNorm_1"]["scale"]}
    out["sm_head"] = dense(p["Dense_0"])
    out["lg_head"] = dense(p["Dense_1"])
    return _numpy({"params": out})


def _conv1x1_to_dense(conv):
    """A ``(1, 1, cin, cout)`` conv kernel -> a ``(cin, cout)`` Dense
    kernel (its bias, if any, kept)."""
    k = conv["kernel"]
    out = {"kernel": np.reshape(k, (np.shape(k)[2], np.shape(k)[3]))}
    if "bias" in conv:
        out["bias"] = conv["bias"]
    return out


def import_reference_twins_params(ref_params: Dict[str, Any],
                                  depths=(1, 1, 5, 4)) -> Dict[str, Any]:
    """A reference ``twins_svt.py`` tree -> ``TwinsSVT``'s:
    ``PatchEmbedding_{s}``, ``PEG_{s}`` and two Transformers a stage
    (``Transformer_{2s}``, ``Transformer_{2s+1}``), whose layers create
    Local / MLP / Global / MLP with their PreNorms in that order (stage 4 has
    no local pair). 1x1 convs become Dense kernels; GSA's subsampling conv
    keeps its ``(k, k, cin, cout)`` layout."""
    p = _params(ref_params)
    out: Dict[str, Any] = {}

    def block(tr, depth, has_local):
        per = 4 if has_local else 2

        def layer(i):
            lo: Dict[str, Any] = {}
            if has_local:
                la = tr[f"LocalAttention_{i}"]
                norm = tr[f"PreNorm_{per * i}"]["LayerNorm_0"]
                to_out = _conv1x1_to_dense(la["Conv_2"])
                lo["local"] = {
                    "norm_scale": norm["scale"], "norm_bias": np.zeros_like(norm["scale"]),
                    # to_q and to_kv ([k|v]) concatenate into the fused [q|k|v]
                    "qkv_kernel": np.concatenate([_conv1x1_to_dense(la["Conv_0"])["kernel"],
                                                  _conv1x1_to_dense(la["Conv_1"])["kernel"]],
                                                 axis=1),
                    "out_kernel": to_out["kernel"],
                    "out_bias": to_out.get("bias", _zeros(np.shape(to_out["kernel"])[1])),
                }
                lo["ff1"] = _conv_mlp(tr[f"MLP_{2 * i}"], tr[f"PreNorm_{per * i + 1}"]["LayerNorm_0"])
            ga = tr[f"GlobalAttention_{i}"]
            gnorm = tr[f"PreNorm_{per * i + (2 if has_local else 0)}"]["LayerNorm_0"]
            lo["global"] = {
                "norm": {"scale": gnorm["scale"], "bias": np.zeros_like(gnorm["scale"])},
                "to_q": _conv1x1_to_dense(ga["Conv_0"]),
                "to_kv": {"kernel": ga["Conv_1"]["kernel"]},  # (k, k, cin, 2 * inner)
                "to_out": _conv1x1_to_dense(ga["Conv_2"]),
            }
            fnorm = tr[f"PreNorm_{per * i + (3 if has_local else 1)}"]["LayerNorm_0"]
            lo["ff2"] = _conv_mlp(tr[f"MLP_{2 * i + 1}" if has_local else f"MLP_{i}"], fnorm)
            return lo

        layers = [layer(i) for i in range(depth)]
        return {"layers": _stack(*layers) if depth > 1 else layers[0]}

    for s in range(1, 5):
        has_local = s < 4
        out[f"embed_{s}"] = {"proj": _conv1x1_to_dense(p[f"PatchEmbedding_{s - 1}"]["Conv_0"])}
        peg = p[f"PEG_{s - 1}"]["Conv_0"]
        out[f"peg_{s}"] = {"proj": {"kernel": peg["kernel"], "bias": peg["bias"]}}
        out[f"block_a_{s}"] = block(p[f"Transformer_{2 * (s - 1)}"], depths[s - 1], has_local)
        out[f"block_b_{s}"] = block(p[f"Transformer_{2 * (s - 1) + 1}"], depths[s - 1], has_local)
    out["head"] = {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]}
    return _numpy({"params": out})


def import_reference_nest_params(ref_params: Dict[str, Any], num_hierarchies: int,
                                 block_repeats, block_grid_sides) -> Dict[str, Any]:
    """A reference ``nest.py`` tree -> ``NesT``'s: ``Transformer_i`` is
    hierarchy i (most blocks first); its scalar-per-token ``pos_emb``
    broadcasts over the channels into one table of the level's
    ``(1, side, side, dim)``; channel LayerNorms' ``g`` / ``b`` become
    ``scale`` / ``bias``; 1x1 convs Dense kernels (bias-free: fp32 zeros for
    the MLP's). ``block_grid_sides[i]`` is hierarchy i's block-map side."""
    p = _params(ref_params)
    out: Dict[str, Any] = {
        "proj": _conv1x1_to_dense(p["Conv_0"]),
        "head_norm": _channel_norm(p["LayerNorm_0"]),
        "head": {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]},
    }
    for li in range(num_hierarchies):
        tr = p[f"Transformer_{li}"]
        side = block_grid_sides[li]
        dim = np.shape(tr["PreNorm_0"]["LayerNorm_0"]["g"])[-1]
        pos = np.reshape(tr["pos_emb"], (1, side, side, 1))
        out[f"pos_emb_{li}"] = np.broadcast_to(pos, (1, side, side, dim)).copy()
        for d in range(block_repeats[li]):
            attn, ff = tr[f"Attention_{d}"], tr[f"FeedForward_{d}"]
            out[f"attn_{li}_{d}"] = {
                "norm": _channel_norm(tr[f"PreNorm_{2 * d}"]["LayerNorm_0"]),
                "to_qkv": _conv1x1_to_dense(attn["Conv_0"]),
                "to_out": _conv1x1_to_dense(attn["Conv_1"]),
            }
            f_norm = _channel_norm(tr[f"PreNorm_{2 * d + 1}"]["LayerNorm_0"])
            w1 = _conv1x1_to_dense(ff["Conv_0"])["kernel"]
            w2 = _conv1x1_to_dense(ff["Conv_1"])["kernel"]
            out[f"ff_{li}_{d}"] = {"ff": {
                "ln_scale": f_norm["scale"], "ln_bias": f_norm["bias"],
                "w1": w1, "b1": _zeros(w1.shape[1]), "w2": w2, "b2": _zeros(w2.shape[1])}}
        if li + 1 < num_hierarchies:
            agg = p[f"Aggregate_{li}"]
            out[f"agg_{li}"] = {
                "conv": {"kernel": agg["Conv_0"]["kernel"], "bias": agg["Conv_0"]["bias"]},
                "norm": _channel_norm(agg["LayerNorm_0"])}
    return _numpy({"params": out})


def import_reference_scalable_vit_params(ref_params: Dict[str, Any], depths) -> Dict[str, Any]:
    """A reference ``scalable_vit.py`` tree -> ``ScalableViT``'s (build it
    with ``reference_block_order=True``: the reference's tuple-unpack bug
    runs both MLPs before IWSA, and its weights follow that order). Per
    layer d: SSA ``Conv_0`` q / ``Conv_1`` k / ``Conv_2`` v / ``Conv_3`` out;
    IWSA ``Conv_0`` LIM / ``Conv_1..3`` q, k, v / ``Conv_4`` out;
    ``MLP_{2d}``, ``MLP_{2d+1}``; ``PreNorm_{4d..4d+3}`` = [ssa, ff1, ff2,
    iwsa]; a stage's first layer unscanned, the rest stacked."""
    p = _params(ref_params)
    head_scale = p["LayerNorm_0"]["scale"]
    out: Dict[str, Any] = {
        "patchify": {"kernel": p["Conv_0"]["kernel"], "bias": p["Conv_0"]["bias"]},
        "head_norm": {"scale": head_scale, "bias": np.zeros_like(head_scale)},
        "head": {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]},
    }

    def norm(ln):
        return {"scale": ln["scale"], "bias": np.zeros_like(ln["scale"])}

    for s, depth in enumerate(depths):
        tr = p[f"Transformer_{s}"]
        peg = tr["PEG_0"]["Conv_0"]
        out[f"peg_{s}"] = {"proj": {"kernel": peg["kernel"], "bias": peg["bias"]}}
        out[f"stage_norm_{s}"] = norm(tr["LayerNorm_0"])
        if s + 1 < len(depths):
            d = p[f"Downsample_{s}"]["Conv_0"]
            out[f"down_{s}"] = {"conv": {"kernel": d["kernel"], "bias": d["bias"]}}

        def layer(i, tr=tr):
            ssa = tr[f"ScalableSelfAttention_{i}"]
            iwsa = tr[f"InteractiveWindowedSelfAttention_{i}"]
            return {
                "ssa": {"norm": norm(tr[f"PreNorm_{4 * i}"]["LayerNorm_0"]),
                        "to_q": _conv1x1_to_dense(ssa["Conv_0"]),
                        "to_k": {"kernel": ssa["Conv_1"]["kernel"]},
                        "to_v": {"kernel": ssa["Conv_2"]["kernel"]},
                        "to_out": _conv1x1_to_dense(ssa["Conv_3"])},
                "ff1": _conv_mlp(tr[f"MLP_{2 * i}"], tr[f"PreNorm_{4 * i + 1}"]["LayerNorm_0"]),
                "ff2": _conv_mlp(tr[f"MLP_{2 * i + 1}"],
                                 tr[f"PreNorm_{4 * i + 2}"]["LayerNorm_0"]),
                "iwsa": {"norm": norm(tr[f"PreNorm_{4 * i + 3}"]["LayerNorm_0"]),
                         "lim": {"kernel": iwsa["Conv_0"]["kernel"],
                                 "bias": iwsa["Conv_0"]["bias"]},
                         "to_q": _conv1x1_to_dense(iwsa["Conv_1"]),
                         "to_k": _conv1x1_to_dense(iwsa["Conv_2"]),
                         "to_v": _conv1x1_to_dense(iwsa["Conv_3"]),
                         "to_out": _conv1x1_to_dense(iwsa["Conv_4"])},
            }

        for key, val in layer(0).items():
            out[f"{key}_{s}_0"] = val
        rest = [layer(i) for i in range(1, depth)]
        if len(rest) > 1:
            out[f"stage_{s}"] = _stack(*rest)
        elif rest:
            out[f"stage_{s}"] = rest[0]
    return _numpy({"params": out})


def import_reference_cvt_params(ref_params: Dict[str, Any], depths=(1, 2, 10)) -> Dict[str, Any]:
    """A reference ``cvt.py`` tree (``params`` and ``batch_stats``) ->
    ``CvT``'s. The reference's BatchNorms always use the batch's statistics
    (``use_running_average=False``), so its logits match the port's
    ``forward(img, train=True)``; served, the port uses the running
    statistics imported here."""
    p, bs = ref_params["params"], ref_params["batch_stats"]
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def dw(src, src_bs):
        bn = src["BatchNorm_0"]
        return ({"depthwise": {"kernel": src["Conv_0"]["kernel"]},
                 "bn": {"scale": bn["scale"], "bias": bn["bias"]},
                 "pointwise": {"kernel": src["Conv_1"]["kernel"]}},
                {"bn": {"mean": src_bs["BatchNorm_0"]["mean"],
                        "var": src_bs["BatchNorm_0"]["var"]}})

    for s in range(1, len(depths) + 1):
        conv = p[f"Conv_{s - 1}"]
        params[f"embed_{s}"] = {"kernel": conv["kernel"], "bias": conv["bias"]}
        params[f"embed_norm_{s}"] = _channel_norm(p[f"LayerNorm_{s - 1}"])
        tr, tr_bs = p[f"Transformer_{s - 1}"], bs[f"Transformer_{s - 1}"]
        for i in range(depths[s - 1]):
            attn, attn_bs = tr[f"Attention_{i}"], tr_bs[f"Attention_{i}"]
            norm = tr[f"PreNorm_{2 * i}"]["LayerNorm_0"]
            q_p, q_s = dw(attn["DepthWiseConv2d_0"], attn_bs["DepthWiseConv2d_0"])
            kv_p, kv_s = dw(attn["DepthWiseConv2d_1"], attn_bs["DepthWiseConv2d_1"])
            params[f"attn_{s}_{i}"] = {
                "norm": {"scale": norm["scale"], "bias": np.zeros_like(norm["scale"])},
                "to_q": q_p, "to_kv": kv_p, "to_out": _conv1x1_to_dense(attn["Conv_0"])}
            stats[f"attn_{s}_{i}"] = {"to_q": q_s, "to_kv": kv_s}
            ff = tr[f"FeedForward_{i}"]
            ff_norm = tr[f"PreNorm_{2 * i + 1}"]["LayerNorm_0"]
            w1 = _conv1x1_to_dense(ff["Conv_0"])["kernel"]
            w2 = _conv1x1_to_dense(ff["Conv_1"])["kernel"]
            params[f"ff_{s}_{i}"] = {"ff": {
                "ln_scale": ff_norm["scale"], "ln_bias": np.zeros_like(ff_norm["scale"]),
                "w1": w1, "b1": _zeros(w1.shape[1]), "w2": w2, "b2": _zeros(w2.shape[1])}}
    params["head"] = {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]}
    return _numpy({"params": params, "batch_stats": stats})


def import_reference_levit_params(ref_params: Dict[str, Any], stages: int, depths,
                                  dim_key: int = 32) -> Dict[str, Any]:
    """A reference ``levit.py`` tree (``params`` and ``batch_stats``) ->
    ``LeViT``'s (its BatchNorms as CvT's). The reference's Transformers
    alternate stage and downsampling blocks. It adds its position table as
    ``bias / scale`` to logits already scaled; ``LeViT`` adds the table
    directly, so the table is imported times ``sqrt(dim_key)``, an fp32
    multiply of the fp32 leaf."""
    p, bs = ref_params["params"], ref_params["batch_stats"]
    inv_scale = float(dim_key) ** 0.5  # 1 / (dim_key ** -0.5)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i in range(4):
        params[f"stem_{i}"] = {"kernel": p[f"Conv_{i}"]["kernel"], "bias": p[f"Conv_{i}"]["bias"]}

    def attention(tr, tr_bs, d):
        attn, attn_bs = tr[f"Attention_{d}"], tr_bs[f"Attention_{d}"]
        # numpy keeps array * python float in the array's dtype (NEP 50), as JAX does
        ap: Dict[str, Any] = {"pos_bias": {"pos_bias": {
            "embedding": np.asarray(attn["Embed_0"]["embedding"]) * inv_scale}}}
        asb: Dict[str, Any] = {}
        for j, name in enumerate(("to_q", "to_k", "to_v", "to_out")):
            conv = attn[f"Conv_{j}"]
            ap[f"{name}_conv"] = {k: conv[k] for k in ("kernel", "bias") if k in conv}
            bn, bn_s = attn[f"BatchNorm_{j}"], attn_bs[f"BatchNorm_{j}"]
            ap[f"{name}_bn"] = {"scale": bn["scale"], "bias": bn["bias"]}
            asb[f"{name}_bn"] = {"mean": bn_s["mean"], "var": bn_s["var"]}
        return ap, asb

    def mlp(tr, d):
        m = tr[f"MLP_{d}"]
        return {"ff": {"w1": _conv1x1_to_dense(m["Conv_0"])["kernel"], "b1": m["Conv_0"]["bias"],
                       "w2": _conv1x1_to_dense(m["Conv_1"])["kernel"], "b2": m["Conv_1"]["bias"]}}

    t = 0
    for s in range(stages):
        tr, tr_bs = p[f"Transformer_{t}"], bs[f"Transformer_{t}"]
        for d in range(depths[s]):
            params[f"stage_{s}_attn_{d}"], stats[f"stage_{s}_attn_{d}"] = attention(tr, tr_bs, d)
            params[f"stage_{s}_mlp_{d}"] = mlp(tr, d)
        t += 1
        if s + 1 < stages:
            tr, tr_bs = p[f"Transformer_{t}"], bs[f"Transformer_{t}"]
            params[f"down_{s}_attn_0"], stats[f"down_{s}_attn_0"] = attention(tr, tr_bs, 0)
            params[f"down_{s}_mlp_0"] = mlp(tr, 0)
            t += 1
    if "Dense_1" in p:  # a distillation head: Dense_0 distills, Dense_1 classifies
        params["head"] = {"kernel": p["Dense_1"]["kernel"], "bias": p["Dense_1"]["bias"]}
        params["distill_head"] = {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]}
    else:
        params["head"] = {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]}
    return _numpy({"params": params, "batch_stats": stats})


def import_reference_crossformer_params(ref_params: Dict[str, Any],
                                        depths=(2, 2, 8, 2)) -> Dict[str, Any]:
    """A reference ``crossformer.py`` tree -> ``CrossFormer``'s (build it
    with ``reference_quirks=True``: the reference's DPB is a scalar bias
    gathered with a mismatched stride, and its weights follow that math)."""
    p = _params(ref_params)
    out: Dict[str, Any] = {"head": {"kernel": p["Dense_0"]["kernel"],
                                    "bias": p["Dense_0"]["bias"]}}

    def dpb(src):
        d = {f"fc{i}": {"kernel": src[f"Dense_{i}"]["kernel"], "bias": src[f"Dense_{i}"]["bias"]}
             for i in range(4)}
        d.update({f"ln{i}": {"scale": src[f"LayerNorm_{i}"]["scale"]} for i in range(3)})
        return d

    def attn(src):
        to_out = _conv1x1_to_dense(src["Conv_1"])
        norm = _channel_norm(src["LayerNorm_0"])
        return {"norm_scale": norm["scale"], "norm_bias": norm["bias"],
                "qkv_kernel": _conv1x1_to_dense(src["Conv_0"])["kernel"],
                "out_kernel": to_out["kernel"], "out_bias": to_out["bias"],
                "dpb": dpb(src["DynamicPositionBias_0"])}

    def conv_mlp(src):
        norm = _channel_norm(src["LayerNorm_0"])
        return {"ff": {"ln_scale": norm["scale"], "ln_bias": norm["bias"],
                       "w1": _conv1x1_to_dense(src["Conv_0"])["kernel"], "b1": src["Conv_0"]["bias"],
                       "w2": _conv1x1_to_dense(src["Conv_1"])["kernel"],
                       "b2": src["Conv_1"]["bias"]}}

    for s, depth in enumerate(depths):
        cel = p[f"CrossEmbedLayer_{s}"]
        out[f"embed_{s}"] = {f"conv_{i}": {"kernel": cel[f"Conv_{i}"]["kernel"],
                                           "bias": cel[f"Conv_{i}"]["bias"]}
                             for i in range(len(cel))}
        tr = p[f"Transformer_{s}"]
        blocks = [{"sda": attn(tr[f"Attention_{2 * i}"]), "mlp1": conv_mlp(tr[f"MLP_{2 * i}"]),
                   "lda": attn(tr[f"Attention_{2 * i + 1}"]),
                   "mlp2": conv_mlp(tr[f"MLP_{2 * i + 1}"])} for i in range(depth)]
        out[f"stage_{s}"] = _stack(*blocks) if depth > 1 else blocks[0]
    return _numpy({"params": out})


def import_reference_cait_params(ref_params: Dict[str, Any], depth: int,
                                 cls_depth: int) -> Dict[str, Any]:
    """A reference ``cait.py`` tree -> ``CaiT``'s. Its attention keeps
    separate q (``Dense_0``) and kv (``Dense_1``) kernels even for
    self-attention: concatenated for the patch stage, kept split in the
    class stage. The talking-heads mixes map as they are. LayerScale is the
    reference's constant epsilon (it never learns it), banded by the model's
    depth: 0.1 up to 18 layers, 1e-5 up to 24, else 1e-6."""
    p = _params(ref_params)

    def stage(tr, n_layers, self_attention, eps):
        def layer(i):
            attn, ff = tr[f"Attention_{i}"], tr[f"FeedForward_{i}"]
            norm = tr[f"PreNorm_{2 * i}"]["LayerNorm_0"]
            ff_norm = tr[f"PreNorm_{2 * i + 1}"]["LayerNorm_0"]
            zeros = np.zeros_like(norm["scale"])
            mixes = {"mix_heads_pre": attn["mix_heads_pre_attn"],
                     "mix_heads_post": attn["mix_heads_post_attn"]}
            if self_attention:
                a = {"norm_scale": norm["scale"], "norm_bias": zeros,
                     "qkv_kernel": np.concatenate([attn["Dense_0"]["kernel"],
                                                   attn["Dense_1"]["kernel"]], axis=1),
                     "out_kernel": attn["Dense_2"]["kernel"],
                     "out_bias": attn["Dense_2"]["bias"], **mixes}
            else:
                a = {"norm": {"scale": norm["scale"], "bias": zeros},
                     "to_q": {"kernel": attn["Dense_0"]["kernel"]},
                     "to_kv": {"kernel": attn["Dense_1"]["kernel"]},
                     "to_out": {"kernel": attn["Dense_2"]["kernel"],
                                "bias": attn["Dense_2"]["bias"]}, **mixes}
            dim = np.shape(norm["scale"])[0]
            return {"attn": a, "ff": _ff(ff, ff_norm, ln_bias=zeros),
                    "ls_attn": np.full((dim,), eps, _F32), "ls_ff": np.full((dim,), eps, _F32)}

        layers = [layer(i) for i in range(n_layers)]
        return {"blocks": _stack(*layers) if n_layers > 1 else layers[0]}

    eps = 0.1 if depth <= 18 else (1e-5 if depth <= 24 else 1e-6)
    head_scale = p["LayerNorm_0"]["scale"]
    return _numpy({"params": {
        "cls": p["cls"],
        "pos_embedding": p["pos_embedding"],
        "patch_embed": {"proj": {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]}},
        "patch_stage": stage(p["Transformer_0"], depth, True, eps),
        "cls_stage": stage(p["Transformer_1"], cls_depth, False, eps),
        "head_norm": {"scale": head_scale, "bias": np.zeros_like(head_scale)},
        "head": {"kernel": p["Dense_1"]["kernel"], "bias": p["Dense_1"]["bias"]},
    }})


def _bias_free_layer(tr, attn_i, ff_i, attn_norm_i, ff_norm_i):
    """One unscanned layer whose norms (scale-only) and out projection
    have no bias: zeros like the attention norm's scale for all three."""
    attn, norm = tr[f"Attention_{attn_i}"], tr[f"PreNorm_{attn_norm_i}"]["LayerNorm_0"]
    zeros = np.zeros_like(norm["scale"])
    return ({"norm_scale": norm["scale"], "norm_bias": zeros,
             "qkv_kernel": attn["Dense_0"]["kernel"], "out_kernel": attn["Dense_1"]["kernel"],
             "out_bias": zeros},
            _ff(tr[f"FeedForward_{ff_i}"], tr[f"PreNorm_{ff_norm_i}"]["LayerNorm_0"],
                ln_bias=zeros))


def import_reference_parallel_vit_params(ref_params: Dict[str, Any], depth: int,
                                         branches: int = 2) -> Dict[str, Any]:
    """A reference ``parallel_vit.py`` tree -> ``ParallelViT``'s (never
    scanned). Per layer d and branch b: ``Attention_{dB+b}``,
    ``FeedForward_{dB+b}``, ``PreNorm_{2dB+b}`` (attention) and
    ``PreNorm_{2dB+B+b}`` (MLP), scale-only; the out projections have no
    bias."""
    p = _params(ref_params)
    tr = p["Transformer_0"]
    encoder: Dict[str, Any] = {}
    for d in range(depth):
        for b in range(branches):
            i = d * branches + b
            encoder[f"attn_{d}_{b}"], encoder[f"ff_{d}_{b}"] = _bias_free_layer(
                tr, i, i, 2 * d * branches + b, 2 * d * branches + branches + b)
    head_scale = p["LayerNorm_0"]["scale"]
    head = p["Dense_1"]
    return _numpy({"params": {
        "cls": p["cls"],
        "pos_embedding": p["pos_embedding"],
        "patch_embed": {"proj": {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]}},
        "encoder": encoder,
        "head_norm": {"scale": head_scale, "bias": np.zeros_like(head_scale)},
        "head": {"kernel": head["kernel"],
                 "bias": head["bias"] if "bias" in head else _zeros(np.shape(head["kernel"])[1])},
    }})


def import_reference_patch_merger_params(ref_params: Dict[str, Any], depth: int, merge_at: int,
                                         num_tokens_out: int) -> Dict[str, Any]:
    """A reference ``patch_merger.py`` tree -> ``PatchMergerViT``'s. The
    reference's merger queries are a fixed ``PRNGKey(0)`` draw, not a
    parameter (its bug register #4); the same draw, ``_jax_normal``, seeds
    the learned ``queries``. Its ``pos_embedding`` has a row for a cls token
    it never uses (it pools by mean): that row is dropped. (``merge_at`` is
    ``vit_tpu``'s signature; it reads it not.)"""
    p = _params(ref_params)
    tr = p["Transformer_0"]
    dim = np.shape(p["Dense_1"]["kernel"])[1]
    out: Dict[str, Any] = {
        "pos_embedding": np.asarray(p["pos_embedding"])[:, :-1],
        "patch_embed": {"proj": {"kernel": p["Dense_1"]["kernel"], "bias": p["Dense_1"]["bias"]}},
    }
    for i in range(depth):
        out[f"attn_{i}"], out[f"ff_{i}"] = _bias_free_layer(tr, i, i, 2 * i, 2 * i + 1)
    merger_scale = tr["PatchMerger_0"]["LayerNorm_0"]["scale"]
    out["merger"] = {"queries": _jax_normal(0, (num_tokens_out, dim)),
                     "norm": {"scale": merger_scale, "bias": np.zeros_like(merger_scale)}}
    head_scale = p["LayerNorm_0"]["scale"]
    out["head_norm"] = {"scale": head_scale, "bias": np.zeros_like(head_scale)}
    out["head"] = {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]}
    return _numpy({"params": out})


def import_reference_vit_params(ref_params: Dict[str, Any], depth: int, *,
                                scan: bool = True) -> Dict[str, Any]:
    """A reference ``vit.py`` tree -> ``ViT``'s: ``Dense_0`` the patch
    projection, ``Dense_1`` the head, ``LayerNorm_0`` the head norm,
    ``Transformer_0/{Attention_i, FeedForward_i, PreNorm_{2i}, PreNorm_{2i+1}}``.
    ``scan=True`` (the encoder's default) stacks the layers along a leading
    depth axis; ``scan=False`` names them ``attn_{i}`` / ``ff_{i}``."""
    p = _params(ref_params)
    tr = p["Transformer_0"]

    def layer(i):
        norm = tr[f"PreNorm_{2 * i}"]["LayerNorm_0"]
        ff_norm = tr[f"PreNorm_{2 * i + 1}"]["LayerNorm_0"]
        attn = tr[f"Attention_{i}"]
        return ({"norm_scale": norm["scale"], "norm_bias": norm["bias"],
                 "qkv_kernel": attn["Dense_0"]["kernel"],
                 "out_kernel": attn["Dense_1"]["kernel"], "out_bias": attn["Dense_1"]["bias"]},
                _ff(tr[f"FeedForward_{i}"], ff_norm, ln_bias=ff_norm["bias"]))

    return _numpy({"params": {
        "cls": p["cls"],
        "pos_embedding": p["pos_embedding"],
        "patch_embed": {"proj": {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]}},
        "encoder": _encoder(layer, depth, scan),
        "head_norm": {"scale": p["LayerNorm_0"]["scale"], "bias": p["LayerNorm_0"]["bias"]},
        "head": {"kernel": p["Dense_1"]["kernel"], "bias": p["Dense_1"]["bias"]},
    }})


def import_reference_region_vit_params(ref_params: Dict[str, Any],
                                       depths=(2, 2, 8, 2)) -> Dict[str, Any]:
    """A reference ``region_vit_flax.py`` tree -> ``RegionViT``'s (build it
    with ``reference_quirks=True``): ``Conv_0`` the local 8x8 / stride-4
    tokenizer, ``Conv_1`` the region 1x1 projection (of the local map's
    channel-major space-to-depth), ``Downsample_{s-1}`` the one downsample a
    stage shares, ``R2LTransformer_{s}`` = {``Embed_0`` the rel-pos table,
    ``Attention_i`` {bias-free ``LayerNorm_0``, ``Dense_0`` qkv, ``Dense_1``
    out}, ``MLP_i`` {bias-free ``LayerNorm_0``, ``Dense_0``, ``Dense_1``}},
    ``LayerNorm_0`` + ``Dense_0`` the head. The bias-free norms import fp32
    zero biases."""
    p = _params(ref_params)
    out: Dict[str, Any] = {
        "local_conv": {"kernel": p["Conv_0"]["kernel"], "bias": p["Conv_0"]["bias"]},
        "region_proj": {"kernel": _conv1x1_to_dense(p["Conv_1"])["kernel"],
                        "bias": p["Conv_1"]["bias"]},
        "head_norm": {"scale": p["LayerNorm_0"]["scale"]},
        "head": {"kernel": p["Dense_0"]["kernel"], "bias": p["Dense_0"]["bias"]},
    }
    for s, depth in enumerate(depths):
        if s > 0:
            ds = p[f"Downsample_{s - 1}"]["Conv_0"]
            out[f"down_{s}"] = {"conv": {"kernel": ds["kernel"], "bias": ds["bias"]}}
        tr = p[f"R2LTransformer_{s}"]
        dim = np.shape(tr["Attention_0"]["Dense_0"]["kernel"])[0]

        def block(i, tr=tr, dim=dim):
            at, ml = tr[f"Attention_{i}"], tr[f"MLP_{i}"]
            return {"attn": {"norm_scale": at["LayerNorm_0"]["scale"], "norm_bias": _zeros(dim),
                             "qkv_kernel": at["Dense_0"]["kernel"],
                             "out_kernel": at["Dense_1"]["kernel"],
                             "out_bias": at["Dense_1"]["bias"]},
                    "ff": _ff(ml, ml["LayerNorm_0"], ln_bias=_zeros(dim))}

        blocks = [block(i) for i in range(depth)]
        out[f"stage_{s}"] = {
            "rel_pos_bias": {"rel_pos_bias": {"embedding": tr["Embed_0"]["embedding"]}},
            "blocks": _stack(*blocks) if depth > 1 else blocks[0]}
    return _numpy({"params": out})


# -- jax.random.normal(PRNGKey(seed), shape) in fp32, bit for bit ---------------
#
# jax's default generator: threefry2x32 over the 64-bit iota of the shape
# (jax_threefry_partitionable; jax/_src/prng.py), its 32 random bits the xor
# of the two output words; uniform in [nextafter(-1, 0), 1) from the top 23
# bits (jax/_src/random.py `_uniform`); normal = sqrt(2) erf_inv(u)
# (`_normal_real`). erf_inv is XLA's fp32 polynomial (Giles) of w =
# -log1p(-u^2), with XLA's CPU log1p (Cephes' rational form below sqrt(2) - 1,
# else log(1 + x) by Cephes' logf) and its multiply-adds fused: each fused
# multiply-add is taken in float64 and rounded once to fp32.

_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ERFINV_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                 -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                 -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _threefry2x32(key, x0, x1):
    """The Threefry-2x32 hash of the counter words ``x0``, ``x1`` (uint32
    arrays) under ``key`` = (k0, k1): 20 rounds, a key injection after
    every four."""
    ks = (np.uint32(key[0]), np.uint32(key[1]),
          np.uint32(key[0]) ^ np.uint32(key[1]) ^ np.uint32(0x1BD11BDA))
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = x0 ^ ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r)))
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + ks[(i + 2) % 3]) + np.uint32(i + 1)  # array adds wrap silently
    return x0, x1


def _horner(x, coeffs):
    p = np.zeros_like(x)
    for c in coeffs:
        p = fma(p, x, _F32(c))
    return p


def _xla_log1p(x):
    """XLA's CPU fp32 log1p of ``x`` in (-1, 0]."""
    x2 = x * x
    small = x + fma(_F32(-0.5), x2, (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)))
    with np.errstate(divide="ignore", invalid="ignore"):
        large = xla_logf(np.maximum(_F32(1) + x, np.finfo(_F32).tiny))
    return np.where(np.abs(x) < _F32(0.41421356237309504880), small, large)


def _xla_erf_inv(u):
    w = -_xla_log1p((-u) * u)
    lt = w < _F32(5)
    with np.errstate(invalid="ignore"):
        w = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3)).astype(_F32)
    p = np.where(lt, _F32(_ERFINV_W_LT5[0]), _F32(_ERFINV_W_GE5[0]))
    for a, b in zip(_ERFINV_W_LT5[1:], _ERFINV_W_GE5[1:]):
        p = fma(p, w, np.where(lt, _F32(a), _F32(b)))
    return np.where(np.abs(u) == 1, u * _F32(np.inf), p * u)


def _jax_normal(seed: int, shape) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape)`` (fp32) in
    numpy, bit for bit."""
    n = int(np.prod(shape))
    counts = np.arange(n, dtype=np.uint64)
    hi = (counts >> np.uint64(32)).astype(np.uint32)
    lo = (counts & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = _threefry2x32(((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF), hi, lo)
    bits = (b0 ^ b1).reshape(shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(_F32) - _F32(1)
    lo_ = np.nextafter(_F32(-1), _F32(0))
    u = np.maximum(lo_, floats * _F32(2) + lo_)  # (hi - lo) is 2 in fp32
    return (_F32(np.sqrt(2)) * _xla_erf_inv(u)).astype(_F32)
