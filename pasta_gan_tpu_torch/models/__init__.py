"""Generators, by the variant a snapshot records (`GENERATORS`), and the
model registry by the reference's class names (counterpart of
`pasta_gan_tpu/models/__init__.py`: `MODEL_REGISTRY`, `build_model`), so
configs written against the reference or the JAX package resolve here too."""

from __future__ import annotations

from typing import Any, Callable, Dict

from ..nn.discriminator import Discriminator
from .generator_512 import Generator512, Generator512Plain
from .generator_full import GeneratorFull, cat_feats_dict
from .generator_stock import GeneratorStock
from .generator_v18 import GeneratorV18

GENERATORS = {cls.variant: cls for cls in (GeneratorFull, GeneratorV18, Generator512)}

MODEL_REGISTRY: Dict[str, Callable[..., Any]] = {
    "GeneratorFull": GeneratorFull,
    "GeneratorV18": GeneratorV18,
    "Generator512": Generator512,
    "Generator512Plain": Generator512Plain,
    "GeneratorStock": GeneratorStock,
    "Discriminator": Discriminator,
    # the reference's dotted names (training_options.json)
    "training.networks.GeneratorFull": GeneratorFull,
    "training.networks.GeneratorV18": GeneratorV18,
    "training.networks.Generator_512": Generator512Plain,
    "training.networks.Generator_512_v2": Generator512Plain,
    "training.networks.Discriminator": Discriminator,
}

# the JAX package's keys whose classes the port has not ported yet (ROADMAP §A 10 item 4)
NOT_PORTED = (
    "GeneratorV1", "GeneratorV10", "GeneratorV11", "GeneratorV12", "GeneratorV13", "GeneratorV14", "GeneratorV15",
    "GeneratorV15_2", "GeneratorV17", "GeneratorV16", "GeneratorV20", "GeneratorV21", "GeneratorRaw",
    "GeneratorPatch", "GeneratorPatchDenorm", "GeneratorPatchDenormCat", "GeneratorRawFull", "GeneratorPatchFull",
    "GeneratorAvgPatchFull", "GeneratorNoCoarse", "GeneratorNoCoarseNoMask",
    "training.networks.GeneratorRaw", "training.networks.GeneratorPatch", "training.networks.GeneratorPatchDenorm",
    "training.networks.GeneratorPatchDenormCat", "training.networks.GeneratorRawFull",
    "training.networks.GeneratorPatchFull", "training.networks.GeneratorAvgPatchFull",
    "training.networks.GeneratorNoCoarse", "training.networks.GeneratorNoCoarseNoMask",
    "training.networks.Generator", "training.networks.GeneratorV10", "training.networks.GeneratorV11",
    "training.networks.GeneratorV12", "training.networks.GeneratorV13", "training.networks.GeneratorV14",
    "training.networks.GeneratorV15", "training.networks.GeneratorV17", "training.networks.GeneratorV16",
    "training.networks.GeneratorV20", "training.networks.GeneratorV21",
)


def register_model(name: str, ctor: Callable[..., Any]) -> None:
    MODEL_REGISTRY[name] = ctor


def build_model(class_name: str, **kwargs):
    if class_name in MODEL_REGISTRY:
        return MODEL_REGISTRY[class_name](**kwargs)
    if class_name in NOT_PORTED:
        raise KeyError(f"model {class_name!r} is not ported yet (ROADMAP §A 10 item 4: the flow V1 generator, the "
                       "v10-v21 generators and the ablations)")
    raise KeyError(f"unknown model {class_name!r}; known: {sorted(MODEL_REGISTRY)}")


__all__ = ["GENERATORS", "MODEL_REGISTRY", "NOT_PORTED", "Discriminator", "Generator512", "Generator512Plain",
           "GeneratorFull", "GeneratorStock", "GeneratorV18", "build_model", "cat_feats_dict", "register_model"]
