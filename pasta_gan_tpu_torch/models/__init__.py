"""Generators."""

from .generator_full import GeneratorFull, cat_feats_dict

__all__ = ["GeneratorFull", "cat_feats_dict"]
