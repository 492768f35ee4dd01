"""The port's Discriminator (nn/discriminator.py) against the JAX package's, on
the CPU, with the JAX variables carried across by
`io/from_jax.py:discriminator_state_dict_from_jax`.

* MinibatchStdLayer: rtol 1e-5, atol 1e-6.
* Forward logits, fp32: rtol 1e-4, atol 1e-5.
* The R1 penalty (rtol 1e-4) and its gradient with respect to every D
  parameter (a second derivative through the `down2` skips): relative L2
  1e-3, with a floor of 1e-6 of the largest gradient norm for gradients that
  vanish in exact arithmetic.
* bf16 compute (blocks and mapping in bf16, the epilogue in fp32) against the
  JAX package's bf16 D: relative error of the logits within 0.05.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pasta_gan_tpu.models import Discriminator as JaxDiscriminator
from pasta_gan_tpu.nn.layers import MinibatchStdLayer as JaxMinibatchStd
from pasta_gan_tpu.train import losses as jlosses
from pasta_gan_tpu_torch.io.from_jax import discriminator_state_dict_from_jax
from pasta_gan_tpu_torch.nn.discriminator import Discriminator
from pasta_gan_tpu_torch.nn.layers import MinibatchStdLayer
from pasta_gan_tpu_torch.train import losses as tlosses

from test_torch_train import draw_variables, rel_l2
from test_torch_train_loop import one_torch_thread  # noqa: F401  (autouse fixture)

CFG = dict(c_dim=512, img_resolution=32, img_channels=3, channel_base=256, channel_max=32, conv_clamp=256.0,
           mbstd_group_size=2)
N = 4


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((N, 32, 32, 3)).astype(np.float32) * 0.5
    c = rng.standard_normal((N, 512)).astype(np.float32)
    return img, c


@pytest.fixture(scope="module")
def pair():
    img, c = _inputs()
    jd = JaxDiscriminator(**CFG)
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(c))
    variables = draw_variables(shapes, 4)
    port = Discriminator(**CFG)
    port.load_state_dict(discriminator_state_dict_from_jax(variables, port.state_dict()), strict=True)
    return jd, variables, port, img, c


@pytest.mark.parametrize("group", [2, 4, None])
def test_minibatch_std_matches_jax(group):
    x = np.random.default_rng(1).standard_normal((4, 5, 3, 6)).astype(np.float32)
    ref = JaxMinibatchStd(group, 2).apply({}, jnp.asarray(x))
    ours = MinibatchStdLayer(group, 2)(_nchw(x))
    np.testing.assert_allclose(ours.numpy().transpose(0, 2, 3, 1), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_state_dict_names_and_rejection(pair):
    jd, variables, port, _, _ = pair
    names = set(port.state_dict())
    assert {"b32.fromrgb.weight", "b32.skip.weight", "b8.conv1.bias", "b4.fc.weight", "b4.out.weight",
            "mapping.embed.weight", "mapping.fc7.bias"} <= names
    bad = jax.tree_util.tree_map(lambda x: x, variables)
    bad["params"]["b4"]["out"]["weight"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        discriminator_state_dict_from_jax(bad, port.state_dict())
    missing = {"params": {k: v for k, v in variables["params"].items() if k != "b8"}}
    with pytest.raises(KeyError):
        discriminator_state_dict_from_jax(missing, port.state_dict())


def test_forward_and_r1_match_jax(pair):
    jd, variables, port, img, c = pair
    ref = jax.jit(jd.apply)(variables, jnp.asarray(img), jnp.asarray(c))
    ours = port(_nchw(img), torch.from_numpy(c))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (N, 1)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)

    def jax_r1(v):
        return jlosses.r1_penalty(jd.apply, v, jnp.asarray(img), jnp.asarray(c))

    pen_ref, g_ref = jax.jit(jax.value_and_grad(jax_r1))(variables)
    g_ref = discriminator_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, g_ref))
    ct = torch.from_numpy(c)
    pen = tlosses.r1_penalty(lambda x: port(x.permute(0, 3, 1, 2), ct), torch.from_numpy(img))
    names = [n for n, _ in port.named_parameters()]
    params = list(port.parameters())  # b4.out.bias does not reach the input gradient: None
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, torch.autograd.grad(pen, params, allow_unused=True))]
    np.testing.assert_allclose(float(pen.detach()), float(pen_ref), rtol=1e-4)
    floor = 1e-6 * max(float(np.linalg.norm(v.numpy())) for v in g_ref.values())
    bad = {n: rel_l2(g.numpy(), g_ref[n].numpy()) for n, g in zip(names, grads)
           if np.linalg.norm(g.numpy() - g_ref[n].numpy()) > 1e-3 * np.linalg.norm(g_ref[n].numpy()) + floor}
    assert not bad, bad
    assert float(np.linalg.norm(g_ref["b32.skip.weight"].numpy())) > 0  # the skip's down2 is on the R1 path


def test_bf16_forward_matches_jax_bf16(pair):
    _, variables, port, img, c = pair
    jd16 = JaxDiscriminator(dtype=jnp.bfloat16, **CFG)
    ref = np.asarray(jax.jit(jd16.apply)(variables, jnp.asarray(img), jnp.asarray(c)), np.float32)
    port.set_dtype(torch.bfloat16)
    try:
        ours = port(_nchw(img), torch.from_numpy(c)).detach()
        assert ours.dtype == torch.float32  # the epilogue stays fp32
        assert rel_l2(ours.numpy(), ref) <= 0.05
    finally:
        port.set_dtype(torch.float32)
