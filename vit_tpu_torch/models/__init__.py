"""Models of the port: ``ViT``, ``DeepViT``, ``CaiT``, ``TwinsSVT``, ``T2TViT``, ``PiT``,
``SimpleViT``, ``ParallelViT``, ``EfficientViT``, ``CrossViT``, ``PatchMergerViT``,
``ViTSmallDatasets``, ``CrossFormer``, ``NesT``, ``ScalableViT``, ``RegionViT``, ``CvT``
and ``LeViT`` so far (the rest of the zoo is ROADMAP.md Queue 1 item 6)."""

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
from vit_tpu_torch.models.vit_small_datasets import ViTSmallDatasets

__all__ = ["CaiT", "CrossFormer", "CrossViT", "CvT", "DeepViT", "EfficientViT", "LeViT", "NesT",
           "ParallelViT", "PatchMergerViT", "PiT", "RegionViT", "ScalableViT", "SimpleViT",
           "T2TViT", "TwinsSVT", "ViT", "ViTSmallDatasets"]
