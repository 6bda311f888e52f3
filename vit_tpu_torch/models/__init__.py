"""Models of the port (``ViT`` so far; the rest of the zoo is ROADMAP.md
Queue 1 item 6)."""

from vit_tpu_torch.models.vit import ViT

__all__ = ["ViT"]
