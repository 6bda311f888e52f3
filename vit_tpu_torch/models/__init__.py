"""Models of the port: the 18 families of ``vit_tpu/models`` and ``ViTMoE``.

``MODEL_REGISTRY`` maps each family's name to (class, tiny smoke config,
image size), the tiny configs of ``vit_tpu``'s ``MODEL_REGISTRY``;
``REFERENCE_PRESETS`` and ``create`` (``models/presets.py``) give the
reference-scale constructions. ``ViTMoE``, as in ``vit_tpu``, is in
neither. Nothing is built on import: a config holds keyword arguments only
(``efficient``'s encoder as the port ``Transformer``'s).

``TRAINING_ONLY_DROPPED``: the training-only keys of ``vit_tpu``'s configs
that a port constructor does not take, dropped from that family's registry
config and preset: none, since every family trains (``vit_tpu_torch.train``)
and takes its dropout keys. Every config key is ``vit_tpu``'s, with its
value.
"""

from vit_tpu_torch.models.cait import CaiT
from vit_tpu_torch.models.cross_vit import CrossViT
from vit_tpu_torch.models.crossformer import CrossFormer
from vit_tpu_torch.models.cvt import CvT
from vit_tpu_torch.models.deepvit import DeepViT
from vit_tpu_torch.models.efficient import EfficientViT
from vit_tpu_torch.models.levit import LeViT
from vit_tpu_torch.models.nest import NesT
from vit_tpu_torch.models.parallel_vit import ParallelViT
from vit_tpu_torch.models.patch_merger import PatchMergerViT
from vit_tpu_torch.models.pit import PiT
from vit_tpu_torch.models.region_vit import RegionViT
from vit_tpu_torch.models.scalable_vit import ScalableViT
from vit_tpu_torch.models.simple_vit import SimpleViT
from vit_tpu_torch.models.t2t import T2TViT
from vit_tpu_torch.models.twins_svt import TwinsSVT
from vit_tpu_torch.models.vit import ViT
from vit_tpu_torch.models.vit_moe import ViTMoE
from vit_tpu_torch.models.vit_small_datasets import ViTSmallDatasets

__all__ = ["CaiT", "CrossFormer", "CrossViT", "CvT", "DeepViT", "EfficientViT", "LeViT", "NesT",
           "ParallelViT", "PatchMergerViT", "PiT", "RegionViT", "ScalableViT", "SimpleViT",
           "T2TViT", "TwinsSVT", "ViT", "ViTMoE", "ViTSmallDatasets", "MODEL_REGISTRY",
           "TRAINING_ONLY_DROPPED"]

TRAINING_ONLY_DROPPED = {}

# name -> (class, tiny smoke config, image size): vit_tpu/models/__init__.py:55-174
MODEL_REGISTRY = {
    "vit": (
        ViT,
        dict(image_size=64, patch_size=16, num_classes=10, dim=64, depth=2, heads=4,
             mlp_dim=128, dim_head=16),
        64,
    ),
    "simple_vit": (
        SimpleViT,
        dict(image_size=64, patch_size=16, num_classes=10, dim=64, depth=2, heads=4,
             mlp_dim=128, dim_head=16),
        64,
    ),
    "deepvit": (
        DeepViT,
        dict(image_size=64, patch_size=16, num_classes=10, dim=64, depth=2, heads=4,
             mlp_dim=128, dim_head=16),
        64,
    ),
    "parallel_vit": (
        ParallelViT,
        dict(image_size=64, patch_size=16, num_classes=10, dim=64, depth=2, heads=4,
             mlp_dim=128, dim_head=16, num_parallel_branches=2),
        64,
    ),
    "patch_merger_vit": (
        PatchMergerViT,
        dict(image_size=64, patch_size=16, num_classes=10, dim=64, depth=4, heads=4,
             mlp_dim=128, dim_head=16, patch_merge_layer=2, patch_merge_num_tokens=4),
        64,
    ),
    "cait": (
        CaiT,
        dict(image_size=64, patch_size=16, num_classes=10, dim=64, depth=2, cls_depth=1,
             heads=4, mlp_dim=128, dim_head=16),
        64,
    ),
    "vit_small_datasets": (
        ViTSmallDatasets,
        dict(image_size=64, patch_size=16, num_classes=10, dim=64, depth=2, heads=4,
             mlp_dim=128, dim_head=16),
        64,
    ),
    "cross_vit": (
        CrossViT,
        dict(image_size=64, num_classes=10, sm_dim=32, lg_dim=64, sm_patch_size=8,
             lg_patch_size=16, sm_enc_depth=1, lg_enc_depth=1, sm_enc_mlp_dim=64,
             lg_enc_mlp_dim=128, cross_attn_depth=1, depth=1, sm_enc_heads=2,
             lg_enc_heads=2, cross_attn_heads=2, sm_enc_dim_head=16, lg_enc_dim_head=16,
             cross_attn_dim_head=16, dropout=0.0, emb_dropout=0.0),
        64,
    ),
    "crossformer": (
        CrossFormer,
        dict(num_classes=10, dim=(32, 64), depth=(1, 1), global_window_size=(4, 2),
             local_window_size=7, cross_embed_kernel_sizes=((4, 8), (2, 4)),
             cross_embed_strides=(4, 2)),
        112,
    ),
    "twins_svt": (
        TwinsSVT,
        dict(num_classes=10, s1_emb_dim=16, s1_depth=1, s1_local_patch_size=4,
             s1_global_k=4, s2_emb_dim=16, s2_depth=1, s2_local_patch_size=4,
             s2_global_k=4, s3_emb_dim=32, s3_depth=1, s3_local_patch_size=4,
             s3_global_k=2, s4_emb_dim=32, s4_depth=1, s4_global_k=2),
        64,
    ),
    "nest": (
        NesT,
        dict(image_size=32, patch_size=4, num_classes=10, dim=32, heads=2,
             num_hierarchies=2, block_repeats=(1, 1)),
        32,
    ),
    "scalable_vit": (
        ScalableViT,
        dict(num_classes=10, dim=32, depth=(1, 1), heads=(2, 4),
             reduction_factor=(2, 1), window_size=(4, None),
             ssa_dim_key=16, ssa_dim_value=16, iwsa_dim_key=16, iwsa_dim_value=16),
        64,
    ),
    "region_vit": (
        RegionViT,
        dict(num_classes=10, dim=(32, 64), depth=(1, 1), window_size=7,
             local_patch_size=4, use_peg=True),
        112,
    ),
    "cvt": (
        CvT,
        dict(num_classes=10, s1_emb_dim=16, s1_depth=1, s2_emb_dim=32, s2_depth=1,
             s3_emb_dim=32, s3_depth=1, s3_heads=2),
        32,
    ),
    "levit": (
        LeViT,
        dict(image_size=64, num_classes=10, stages=3, dim=(32, 32, 32), depth=1,
             heads=(1, 2, 4), mlp_mult=2, dim_key=16, dim_value=16),
        64,
    ),
    "pit": (
        PiT,
        dict(image_size=64, patch_size=8, num_classes=10, dim=32, depth=(1, 1),
             heads=2, mlp_dim=64, dim_head=16),
        64,
    ),
    "t2t": (
        T2TViT,
        dict(image_size=64, num_classes=10, dim=64, depth=1, heads=2, mlp_dim=128,
             t2t_layers=((7, 4), (3, 2), (3, 2))),
        64,
    ),
    # the injected-encoder shell: a small vanilla Transformer, as keyword arguments
    "efficient": (
        EfficientViT,
        dict(image_size=64, patch_size=16, num_classes=10, dim=64,
             transformer=dict(dim=64, depth=2, heads=4, dim_head=16, mlp_dim=128)),
        64,
    ),
}

# presets import the constructors from this package, defined by here
from vit_tpu_torch.models.presets import REFERENCE_PRESETS, create  # noqa: E402

__all__ += ["REFERENCE_PRESETS", "create"]
