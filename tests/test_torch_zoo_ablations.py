"""The ablation clusters of the port's zoo (models/generator_ablations.py)
against the JAX package's, on the CPU (tests/_torch_zoo.py has the method),
and the model registry's zoo keys.

Thin forwards at 64x64, channel_base 512, channel_max 32 (PatchDenormCat:
4096 and 128, since its concatenating blocks take the 128-channel spade
features beside x and need channels(32) == 128), batch 2, noise const:
every output within the generator limits (rtol 1e-2, atol 5e-3; finetune
images atol 1e-2).  The gated classes (PatchDenormCat's clothes mask,
NoCoarse's upper and lower masks) see 20-80 % of each mask on each side, no
JAX mask value lies within 1e-5 of 0.9 and the binarised masks are equal;
NoCoarse's `> 10` fallback runs in the second sample and not in the first.
Full width: the state_dict keys and shapes against `jax.eval_shape` of each
class's init.  `build_model` builds every zoo key of the JAX registry (the
reference's dotted names too) as the class of that name, and only the flow
V1 generator's two keys stay unported.
"""

import ast

import pytest

from pasta_gan_tpu_torch import models

from _torch_zoo import one_torch_thread  # noqa: F401  (autouse fixture)
from _torch_zoo import FOUR, SINGLE, Pair, assert_close, assert_fallback_ran, full_width_keys_and_shapes

THIN = dict(img_resolution=64, channel_base=512, channel_max=32)
GATE_1 = (("synthesis_b64",), "synthesis.b64.torgb", ("m_bias",))
GATE_2 = (("synthesis_b64",), "synthesis.b64.torgb", ("m_bias1", "m_bias2"))
CASES = {  # name -> (denorm inputs, gate, finetune output indices, config)
    "GeneratorRaw": ((), None, (), THIN),
    "GeneratorPatch": ((), None, (), THIN),
    "GeneratorRawFull": ((), None, (), THIN),
    "GeneratorPatchFull": ((), None, (), THIN),
    "GeneratorAvgPatchFull": ((), None, (), THIN),
    "GeneratorPatchDenorm": (SINGLE, None, (1,), THIN),
    "GeneratorPatchDenormCat": (SINGLE, GATE_1, (1,), dict(img_resolution=64, channel_base=4096, channel_max=128)),
    "GeneratorNoCoarse": (FOUR, GATE_2, (0, 1, 2, 3), THIN),
    "GeneratorNoCoarseNoMask": (FOUR, None, (0, 1, 2, 3), THIN),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    keys, gate, finetune, cfg = CASES[name]
    pair = Pair(name, cfg, keys, gate=gate)
    ours, ref = pair.outputs()
    assert_close(name, ours, ref, finetune)
    if name == "GeneratorNoCoarse":
        assert_fallback_ran(pair.jax_masks[0], pair.inp["denorm_upper_mask"])
        assert_fallback_ran(pair.jax_masks[1], pair.inp["denorm_lower_mask"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_full_width_keys_and_shapes(name):
    n_keys, n_values = full_width_keys_and_shapes(name, CASES[name][0])
    print(f"{name}: {n_keys} state_dict entries, {n_values / 1e6:.2f} M values")


def test_build_model_builds_every_zoo_key():
    from pasta_gan_tpu.models import MODEL_REGISTRY as JAX_REGISTRY

    tree = ast.parse(open("pasta_gan_tpu/models/__init__.py").read())
    node = next(n for n in tree.body if isinstance(n, ast.AnnAssign) and n.target.id == "MODEL_REGISTRY")
    jax_keys = [k.value for k in node.value.keys]
    zoo_names = {cls.__name__ for cls in models.ZOO}
    zoo_keys = [k for k in jax_keys if JAX_REGISTRY[k].__name__ in zoo_names]
    assert len(models.ZOO) == 20 and len(zoo_keys) == 39
    for key in zoo_keys:
        model = models.build_model(key, img_resolution=32, channel_base=64, channel_max=8)
        assert type(model).__name__ == JAX_REGISTRY[key].__name__, key
    assert type(models.build_model("training.networks.GeneratorV15")) is models.GeneratorV15_2
    assert set(jax_keys) == set(models.MODEL_REGISTRY)
