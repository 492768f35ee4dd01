"""The mask-headed single-branch pyramid of the port's zoo against the JAX
package's, on the CPU (tests/_torch_zoo.py has the method):

* the ToRGB heads "mask1" (`m_weight`) and "masks_hand" (`m_weight`,
  `hm_weight`) of nn/synthesis.py:ToRGBLayerFull, and SynthesisBlockFull's
  `head_always`, against the JAX layers;
* GeneratorV15, GeneratorV15_2 (models/generator_v15.py) at 64x64 and
  GeneratorV17 at 256x256 (its texture block's SPADE blocks are laid out for
  256);
* GeneratorV16, GeneratorV20, GeneratorV21 (models/generator_v21.py, on
  nn/synthesis.py:SynthesisNetworkSingle) at 64x64 with the JAX side's
  `pack_tail` on and off.

channel_base 512 (2048 at 256), channel_max 32, batch 2, noise const: every
output within the generator limits (rtol 1e-2, atol 5e-3; finetune images
atol 1e-2).  Each gate (mask > 0.9) sees 20-80 % of its mask on each side,
no JAX mask value lies within 1e-5 of 0.9 and the binarised masks are equal;
the second sample has no denorm (and, for V21, face) pixel, so the `> 10`
valid-pixel fallbacks run there and not in the first.  Full width: the
state_dict keys and shapes against `jax.eval_shape` of each class's init.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pasta_gan_tpu import models as jax_models
from pasta_gan_tpu.nn.synthesis import ToRGBLayerFull as JaxToRGBLayerFull
from pasta_gan_tpu_torch.io.from_jax import state_dict_from_jax
from pasta_gan_tpu_torch.nn.synthesis import SynthesisBlockFull, ToRGBLayerFull

from _torch_zoo import one_torch_thread  # noqa: F401  (autouse fixture)
from _torch_zoo import SINGLE, V15, V21, Pair, assert_close, assert_fallback_ran, full_width_keys_and_shapes

THIN = dict(img_resolution=64, channel_base=512, channel_max=32)
THIN_256 = dict(img_resolution=256, channel_base=2048, channel_max=32)


def _gate(res, heads=("m_bias",), jax_path=None):
    return (jax_path or (f"synthesis_b{res}",), f"synthesis.b{res}.torgb", heads)


@pytest.mark.parametrize("head,names", [("mask1", ("m_weight",)), ("masks_hand", ("m_weight", "hm_weight"))])
def test_torgb_heads_match_jax(head, names):
    C, w_dim = 16, 8
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, C)).astype(np.float32)
    w = rng.standard_normal((2, w_dim)).astype(np.float32)
    jl = JaxToRGBLayerFull(C, 3, w_dim, head_mode=head, head_always=True)
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        jax.eval_shape(lambda: jl.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(w))))
    ref_img, ref_aux = jl.apply(params, jnp.asarray(x), jnp.asarray(w))
    port = ToRGBLayerFull(C, 3, w_dim, head=head)
    port.load_state_dict(state_dict_from_jax(params, port.state_dict()), strict=True)
    assert all(f"{n}" in port.state_dict() for n in names)
    with torch.no_grad():
        img, aux = port(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w))
    aux = aux if isinstance(aux, tuple) else (aux,)
    ref_aux = ref_aux if isinstance(ref_aux, tuple) else (ref_aux,)
    assert len(aux) == len(names) == len(ref_aux)
    np.testing.assert_allclose(img.permute(0, 2, 3, 1).numpy(), np.asarray(ref_img), rtol=1e-5, atol=1e-5)
    for a, b in zip(aux, ref_aux):
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    # head_always builds the head on a block that is not the last style block
    block = SynthesisBlockFull(8, 8, w_dim, 16, 3, is_last=False, head=head, head_always=True)
    assert all(hasattr(block.torgb, n) for n in names)
    assert not hasattr(SynthesisBlockFull(8, 8, w_dim, 16, 3, is_last=False, head=head).torgb, names[0])


V15_CASES = {"GeneratorV15": THIN, "GeneratorV15_2": THIN, "GeneratorV17": THIN_256}


@pytest.mark.parametrize("name", sorted(V15_CASES))
def test_v15_family_matches_jax(name):
    cfg = V15_CASES[name]
    pair = Pair(name, cfg, V15, gate=_gate(cfg["img_resolution"]))
    ours, ref = pair.outputs()
    assert_close(name, ours, ref, finetune=(1,))
    assert_fallback_ran(pair.jax_masks[0], pair.inp["denorm_mask"])


@functools.lru_cache(maxsize=1)
def _single_pair(name):
    """One class's pair, shared by its pack_tail cases (the same tree; the
    port runs once)."""
    v21 = name == "GeneratorV21"
    gate = _gate(64, ("m_bias", "hm_bias") if v21 else ("m_bias",), jax_path=("synthesis", "b64"))
    return Pair(name, THIN, V21 if v21 else SINGLE, gate=gate)


@pytest.mark.parametrize("pack_tail", [True, False])
@pytest.mark.parametrize("name", ["GeneratorV16", "GeneratorV20", "GeneratorV21"])
def test_single_branch_generators_match_jax(name, pack_tail):
    v21 = name == "GeneratorV21"
    pair = _single_pair(name)
    pair.jgen = jax_models.MODEL_REGISTRY[name](**THIN, pack_tail=pack_tail)
    ours, ref = pair.outputs()
    assert_close(name, ours, ref, finetune=(1,))
    assert_fallback_ran(pair.jax_masks[0], pair.inp["denorm_mask"])
    if v21:  # the face-average fill: its own fallback, on the face mask alone
        assert_fallback_ran(pair.inp["face_mask"], pair.inp["face_mask"])


@pytest.mark.parametrize("name", sorted(V15_CASES) + ["GeneratorV16", "GeneratorV20", "GeneratorV21"])
def test_full_width_keys_and_shapes(name):
    keys = V15 if name in V15_CASES else V21 if name == "GeneratorV21" else SINGLE
    n_keys, n_values = full_width_keys_and_shapes(name, keys)
    print(f"{name}: {n_keys} state_dict entries, {n_values / 1e6:.2f} M values")
