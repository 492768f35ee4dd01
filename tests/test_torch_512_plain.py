"""Generator512Plain (models/generator_512.py, the reference's `Generator_512`
and `Generator_512_v2`) against the JAX package's, and the model registry
(models/__init__.py) against the JAX package's keys, on the CPU.

* Forward parity at img_resolution 64 (the square canvas a 64x40 image
  pads to), channel_base 512, channel_max 32, batch 2, 48- and 60-channel
  style stacks, `noise_mode="const"` (each layer's `noise_const` carried
  from JAX's "buffers") and truncation psi 0.7: the image within the Full
  generator's limits, rtol 1e-2 / atol 5e-3; the JAX variables carried by
  `io/from_jax.py:state_dict_from_jax` with a strict load.
* `build_model` of every key the port registers builds the port's class;
  the port registers every key of the JAX registry (the flow generator V1's
  two keys were the last); an unknown key raises like JAX's.
"""

import ast

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pasta_gan_tpu.models.generator_512 import Generator512Plain as JaxGenerator512Plain
from pasta_gan_tpu_torch import models
from pasta_gan_tpu_torch.io.from_jax import state_dict_from_jax
from pasta_gan_tpu_torch.models.generator_512 import Generator512Plain

from test_torch_generator import _jax_variables
from test_torch_train import rel_l2
from test_torch_train_loop import one_torch_thread  # noqa: F401  (autouse fixture)

RES, N = 64, 2
THIN = dict(img_resolution=RES, channel_base=512, channel_max=32)


def _inputs(nc, seed=0):
    rng = np.random.default_rng(seed)
    return dict(c=rng.standard_normal((N, RES // 4, RES // 4, nc)).astype(np.float32) * 0.5,
                retain=rng.standard_normal((N, RES, RES, 3)).astype(np.float32) * 0.5,
                pose=rng.standard_normal((N, RES, RES, 6)).astype(np.float32) * 0.5)


@pytest.mark.parametrize("style_input_nc", [48, 60])
def test_forward_matches_jax(style_input_nc):
    cfg = dict(THIN, style_input_nc=style_input_nc)
    jgen = JaxGenerator512Plain(**cfg)
    inp = _inputs(style_input_nc)
    v = _jax_variables(jgen, inp, seed=1)
    w_avg = np.random.default_rng(2).standard_normal(512).astype(np.float32)
    ref = jgen.apply(v, None, **{k: jnp.asarray(a) for k, a in inp.items()}, truncation_psi=0.7,
                     w_avg=jnp.asarray(w_avg), noise_mode="const")
    port = Generator512Plain(**cfg)
    sd = state_dict_from_jax(v, port.state_dict())
    port.load_state_dict(sd, strict=True)
    assert "synthesis.b64.merge_conv.weight" in sd and "synthesis.b32.merge_conv.weight" not in sd
    assert "synthesis.b64.torgb.m_weight1" not in sd and "synthesis.spade_b128_1.conv_0.weight" not in sd
    assert tuple(sd["style_encoding.model.0.weight"].shape)[1] == style_input_nc
    with torch.no_grad():
        img = port(None, *[torch.from_numpy(inp[k]) for k in ("c", "retain", "pose")], truncation_psi=0.7,
                   w_avg=torch.from_numpy(w_avg), noise_mode="const")
    print(f"Generator512Plain ({style_input_nc}-channel style): relative L2 against JAX {rel_l2(img.numpy(), ref):.3g}")
    assert img.shape == (N, RES, RES, 3)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), rtol=1e-2, atol=5e-3)


def _jax_registry_keys():
    tree = ast.parse(open("pasta_gan_tpu/models/__init__.py").read())
    node = next(n for n in tree.body if isinstance(n, ast.AnnAssign) and n.target.id == "MODEL_REGISTRY")
    return [k.value for k in node.value.keys]


@pytest.mark.parametrize("key", sorted(models.MODEL_REGISTRY))
def test_build_model_builds_the_ports_class(key):
    from pasta_gan_tpu.models import MODEL_REGISTRY as JAX_REGISTRY

    kwargs = {
        "GeneratorStock": dict(z_dim=8, c_dim=0, w_dim=8, img_resolution=8, img_channels=3,
                               synthesis_kwargs=dict(channel_base=64, channel_max=8)),
        "Discriminator": dict(c_dim=0, img_resolution=8, channel_base=64, channel_max=8),
        "training.networks.Discriminator": dict(c_dim=0, img_resolution=8, channel_base=64, channel_max=8),
    }.get(key, dict(img_resolution=32 if "512" not in key else 16, channel_base=64, channel_max=8))
    model = models.build_model(key, **kwargs)
    assert type(model) is models.MODEL_REGISTRY[key]
    assert type(model).__name__ == JAX_REGISTRY[key].__name__


def test_registry_covers_the_jax_keys():
    keys = _jax_registry_keys()
    assert sorted(models.MODEL_REGISTRY) == sorted(keys)
    assert models.MODEL_REGISTRY["training.networks.Generator_512_v2"] is Generator512Plain
    for key in ("GeneratorV1", "training.networks.Generator"):  # the flow generator, the last keys ported
        model = models.build_model(key, img_resolution=32, channel_base=64, channel_max=8)
        assert type(model) is models.GeneratorV1
    with pytest.raises(KeyError, match="unknown model 'GeneratorV99'"):
        models.build_model("GeneratorV99")
