"""Generators, by the synthesis variant a snapshot records."""

from .generator_full import GeneratorFull, cat_feats_dict
from .generator_v18 import GeneratorV18

GENERATORS = {cls.variant: cls for cls in (GeneratorFull, GeneratorV18)}

__all__ = ["GENERATORS", "GeneratorFull", "GeneratorV18", "cat_feats_dict"]
