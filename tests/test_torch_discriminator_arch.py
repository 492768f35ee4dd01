"""The port's Discriminator in each of the reference's architectures ("orig",
"skip", "resnet"; nn/discriminator.py) against the JAX package's, on the CPU,
with the JAX variables carried across by
`io/from_jax.py:discriminator_state_dict_from_jax` (strict load: the skip
architecture's per-block and epilogue `fromrgb` names carry too).

* Forward logits, fp32: rtol 1e-4, atol 1e-5 (tests/test_torch_discriminator.py's).
* Which FIR route each architecture takes, counted through the `down2`
  wrapper's launch helper (on the CPU it runs the plain version): "skip"
  downsamples the 3-channel image at every block, "resnet" runs its 1x1
  skips there, "orig" runs neither.
"""

import collections

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pasta_gan_tpu.nn.discriminator import Discriminator as JaxDiscriminator
from pasta_gan_tpu_torch.io.from_jax import discriminator_state_dict_from_jax
from pasta_gan_tpu_torch.nn.discriminator import Discriminator
from pasta_gan_tpu_torch.ops import upfirdn_kernels as uk

from test_torch_train import draw_variables
from test_torch_train_loop import one_torch_thread  # noqa: F401  (autouse fixture)

RES, N = 32, 4
CFG = dict(c_dim=16, img_resolution=RES, img_channels=3, channel_base=256, channel_max=32, conv_clamp=256.0,
           mbstd_group_size=2)


@pytest.mark.parametrize("architecture", ["orig", "skip", "resnet"])
def test_logits_match_jax_and_fir_route(architecture, monkeypatch):
    rng = np.random.default_rng(0)
    img = (rng.standard_normal((N, RES, RES, 3)) * 0.5).astype(np.float32)
    c = rng.standard_normal((N, 16)).astype(np.float32)
    jd = JaxDiscriminator(architecture=architecture, **CFG)
    variables = draw_variables(jax.eval_shape(jd.init, jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(c)), 4)
    port = Discriminator(architecture=architecture, **CFG)
    port.load_state_dict(discriminator_state_dict_from_jax(variables, port.state_dict()), strict=True)
    names = set(port.state_dict())
    assert ("b16.fromrgb.weight" in names) == ("b4.fromrgb.weight" in names) == (architecture == "skip")
    assert ("b32.skip.weight" in names) == (architecture == "resnet")

    calls = collections.Counter()
    apply = uk._down2_apply

    def counted(x, pad, gain):
        calls[(pad, tuple(x.shape))] += 1
        return apply(x, pad, gain)

    monkeypatch.setattr(uk, "_down2_apply", counted)
    with torch.no_grad():
        ours = port(torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2))), torch.from_numpy(c))
    ref = np.asarray(jd.apply(variables, jnp.asarray(img), jnp.asarray(c)))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-5)
    res = [RES // 2**i for i in range(4)]  # 32, 16, 8 (blocks) and 4 (epilogue)
    expected = {
        "orig": {},
        "skip": {(1, (N, 3, r, r)): 1 for r in res[:-1]},
        "resnet": {(1, (N, port.channels(r), r, r)): 1 for r in res[:-1]},
    }[architecture]
    assert dict(calls) == expected
