"""The port's Generator512 vs the JAX package's on the CPU.

`Generator512` against the JAX `Generator512` at thin widths
(img_resolution 256, channel_base 2048, channel_max 64), the JAX side run
with `pack_tail` on and off: (img, pred_parsing) rtol 1e-2 / atol 5e-3,
finetune_img rtol 1e-2 / atol 1e-2 (tests/test_torch_generator_v18.py's
tolerances); at full width the port's state_dict goes back through the
JAX package's `convert_generator_full` to every JAX leaf, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pasta_gan_tpu.io.torch_import import convert_generator_full
from pasta_gan_tpu.models import Generator512 as JaxGenerator512
from pasta_gan_tpu_torch.io.from_jax import state_dict_from_jax
from pasta_gan_tpu_torch.models import Generator512

from test_torch_generator import KEYS, _inputs, _jax_variables
from test_torch_train_loop import one_torch_thread  # noqa: F401  (autouse fixture)

THIN = dict(img_resolution=256, channel_base=2048, channel_max=64)


def _inputs_512(seed, N=1, R=256):
    inp = _inputs(seed=seed, N=N, R=R)
    inp["c"] = np.random.default_rng(seed + 100).standard_normal((N, R // 4, R // 4, 45)).astype(np.float32) * 0.5
    return inp


def _port_from_jax(variables, **cfg):
    gen = Generator512(**cfg)
    gen.load_state_dict(state_dict_from_jax(variables, gen.state_dict()), strict=True)
    return gen.eval()


def test_state_dict_round_trip_full_width():
    cfg = dict(img_resolution=512)
    inp = _inputs_512(0, R=512)
    v = _jax_variables(JaxGenerator512(**cfg), inp)
    port = _port_from_jax(v, **cfg)
    sd = port.state_dict()
    assert tuple(sd["synthesis.b8.const"].shape) == (512, 8, 8) and "synthesis.b4.const" not in sd
    assert tuple(sd["style_encoding.model.0.weight"].shape)[1] == 45 and "style_encoding.model.7.weight" not in sd
    assert "const_encoding.model.6.weight" in sd and "synthesis.b32.merge_conv.weight" not in sd
    assert port.num_ws == 2 * 7 - 1 + 1  # blocks 8 ... 512, one w for the first, plus the last ToRGB's
    back = convert_generator_full({k: t.numpy() for k, t in sd.items()}, v)
    flat_v = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_v) == len(sd)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("pack_tail", [True, False])
def test_forward_matches_jax(pack_tail):
    jgen = JaxGenerator512(pack_tail=pack_tail, **THIN)
    inp = _inputs_512(seed=1)
    v = _jax_variables(jgen, inp, seed=2)
    ref = jax.jit(lambda v, x: jgen.apply(v, None, **x, noise_mode="none"))(
        v, {k: jnp.asarray(a) for k, a in inp.items()})
    port = _port_from_jax(v, **THIN)
    with torch.no_grad():
        ours = port(None, *[torch.from_numpy(inp[k]) for k in KEYS], noise_mode="none")
    assert len(ours) == len(ref) == 3
    for name, a, b, atol in zip(("img", "finetune_img", "pred_parsing"), ours, ref, (5e-3, 1e-2, 5e-3)):
        assert tuple(a.shape) == tuple(b.shape), name
        assert bool(torch.isfinite(a).all()), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-2, atol=atol, err_msg=name)
