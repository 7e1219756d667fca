"""Model zoo, dense-LM slice: shared layer library + the decoder LM."""

from repro_torch.models.config import ArchConfig, SHAPES, ShapeSpec, shape_for
from repro_torch.models.transformer import LM, Ctx, build_lm

__all__ = ["ArchConfig", "SHAPES", "ShapeSpec", "shape_for",
           "LM", "Ctx", "build_lm"]
