"""The spade-modulated-conv lineage of the port's zoo (models/generator_v10.py,
generator_v11.py, generator_v13.py: GeneratorV10, V11, V12, V13, V14) against
the JAX package's classes, on the CPU (tests/_torch_zoo.py has the method).

Thin forwards at 256x256 (the clusters' spade features are laid out for
256), channel_base 2048, channel_max 32 (V13/V14's attention at 128 needs
channels(128) >= 8), batch 2, noise const: every output within the
generator limits (rtol 1e-2, atol 5e-3; finetune images atol 1e-2).  The
V11-V14 gates (`_gate`, mask > 0.9) see 20-80 % of their mask on each side,
no JAX mask value lies within 1e-5 of 0.9, and the binarised masks are equal.
Full width: the state_dict keys and shapes of each class against
`jax.eval_shape` of its init; the `port_key` rules for the zoo's flat names.
"""

import pytest

from pasta_gan_tpu_torch.io.from_jax import port_key

from _torch_zoo import one_torch_thread  # noqa: F401  (autouse fixture)
from _torch_zoo import SPADE, Pair, assert_close, full_width_keys_and_shapes

THIN = dict(img_resolution=256, channel_base=2048, channel_max=32)
LAST = (("synthesis_b256",), "synthesis.b256.torgb", ("m_bias",))  # the pyramid's last ToRGB's mask head
CASES = {  # name -> (gate, finetune output indices)
    "GeneratorV10": (None, ()),
    "GeneratorV11": (LAST, (1,)),
    "GeneratorV12": (LAST, (1,)),
    "GeneratorV13": ((("synthesis_b128",), "synthesis.b128.torgb", ("m_bias",)), ()),
    "GeneratorV14": (LAST, (1,)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    gate, finetune = CASES[name]
    pair = Pair(name, THIN, SPADE, gate=gate)
    ours, ref = pair.outputs()
    assert_close(name, ours, ref, finetune)


@pytest.mark.parametrize("name", sorted(CASES))
def test_full_width_keys_and_shapes(name):
    n_keys, n_values = full_width_keys_and_shapes(name, SPADE)
    print(f"{name}: {n_keys} state_dict entries, {n_values / 1e6:.2f} M values")


def test_port_key_maps_the_zoos_flat_names():
    assert port_key(("synthesis_b64", "conv0", "spade_affine_1", "weight")) == (
        "synthesis.b64.conv0.spade_affine.1.weight", "param")
    assert port_key(("synthesis_spade_b256", "torgb", "m_bias")) == ("synthesis.spade_b256.torgb.m_bias", "param")
    assert port_key(("style_encoding", "model_5", "linear", "kernel")) == (
        "style_encoding.model.5.linear.weight", "dense")
    assert port_key(("style_encoding", "feat_enc_3", "weight")) == ("style_encoding.feat_enc.3.weight", "param")
    assert port_key(("synthesis", "spade_encoder_2", "skip", "weight")) == (
        "synthesis.spade_encoder.2.skip.weight", "param")
    assert port_key(("texture", "shortcut_0", "mask_conv_1", "merge_conv_2", "bias"))[0] == \
        "texture.shortcut.0.mask_conv.1.merge_conv.2.bias"
    # the rule is for top-level names only, and the Full cluster's names are unchanged
    assert port_key(("synthesis", "b64", "merge_conv", "weight"))[0] == "synthesis.b64.merge_conv.weight"
    assert port_key(("style_encoding", "dense2", "linear", "kernel"))[0] == "style_encoding.model.5.linear.weight"
