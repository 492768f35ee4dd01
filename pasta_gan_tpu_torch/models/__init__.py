"""Generators, by the variant a snapshot records (`GENERATORS`), and the
model registry by the reference's class names (counterpart of
`pasta_gan_tpu/models/__init__.py`: `MODEL_REGISTRY`, `build_model`), so
configs written against the reference or the JAX package resolve here too."""

from __future__ import annotations

from typing import Any, Callable, Dict

from ..nn.discriminator import Discriminator
from .generator_512 import Generator512, Generator512Plain
from .generator_ablations import (
    GeneratorAvgPatchFull,
    GeneratorNoCoarse,
    GeneratorNoCoarseNoMask,
    GeneratorPatch,
    GeneratorPatchDenorm,
    GeneratorPatchDenormCat,
    GeneratorPatchFull,
    GeneratorRaw,
    GeneratorRawFull,
)
from .generator_full import GeneratorFull, cat_feats_dict
from .generator_stock import GeneratorStock
from .generator_v1 import GeneratorV1
from .generator_v10 import GeneratorV10
from .generator_v11 import GeneratorV11, GeneratorV12
from .generator_v13 import GeneratorV13, GeneratorV14
from .generator_v15 import GeneratorV15, GeneratorV15_2, GeneratorV17
from .generator_v18 import GeneratorV18
from .generator_v21 import GeneratorV16, GeneratorV20, GeneratorV21

GENERATORS = {cls.variant: cls for cls in (GeneratorFull, GeneratorV18, Generator512)}

# the generator zoo and the ablation clusters, by class name (also the reference's dotted names)
ZOO = (GeneratorV10, GeneratorV11, GeneratorV12, GeneratorV13, GeneratorV14, GeneratorV15, GeneratorV15_2,
       GeneratorV17, GeneratorV16, GeneratorV20, GeneratorV21, GeneratorRaw, GeneratorPatch, GeneratorPatchDenorm,
       GeneratorPatchDenormCat, GeneratorRawFull, GeneratorPatchFull, GeneratorAvgPatchFull, GeneratorNoCoarse,
       GeneratorNoCoarseNoMask)

MODEL_REGISTRY: Dict[str, Callable[..., Any]] = {
    "GeneratorFull": GeneratorFull,
    "GeneratorV18": GeneratorV18,
    "Generator512": Generator512,
    "Generator512Plain": Generator512Plain,
    "GeneratorStock": GeneratorStock,
    "GeneratorV1": GeneratorV1,
    "Discriminator": Discriminator,
    **{cls.__name__: cls for cls in ZOO},
    # the reference's dotted names (training_options.json)
    "training.networks.Generator": GeneratorV1,
    "training.networks.GeneratorFull": GeneratorFull,
    "training.networks.GeneratorV18": GeneratorV18,
    "training.networks.Generator_512": Generator512Plain,
    "training.networks.Generator_512_v2": Generator512Plain,
    "training.networks.Discriminator": Discriminator,
    **{f"training.networks.{cls.__name__}": cls for cls in ZOO
       if cls not in (GeneratorV15, GeneratorV15_2)},
    # the reference's GeneratorV15 builds the three-SpadeResBlock network
    "training.networks.GeneratorV15": GeneratorV15_2,
}

def register_model(name: str, ctor: Callable[..., Any]) -> None:
    MODEL_REGISTRY[name] = ctor


def build_model(class_name: str, **kwargs):
    if class_name in MODEL_REGISTRY:
        return MODEL_REGISTRY[class_name](**kwargs)
    raise KeyError(f"unknown model {class_name!r}; known: {sorted(MODEL_REGISTRY)}")


__all__ = ["GENERATORS", "MODEL_REGISTRY", "ZOO", "Discriminator", "Generator512",
           "Generator512Plain", "GeneratorFull", "GeneratorStock", "GeneratorV1", "GeneratorV18", "build_model", "cat_feats_dict",
           "register_model"] + [cls.__name__ for cls in ZOO]
