"""Generators, by the variant a snapshot records."""

from .generator_512 import Generator512
from .generator_full import GeneratorFull, cat_feats_dict
from .generator_v18 import GeneratorV18

GENERATORS = {cls.variant: cls for cls in (GeneratorFull, GeneratorV18, Generator512)}

__all__ = ["GENERATORS", "Generator512", "GeneratorFull", "GeneratorV18", "cat_feats_dict"]
