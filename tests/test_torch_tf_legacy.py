"""The port's legacy TF pickle conversion (pasta_gan_tpu_torch/io/tf_legacy.py)
and GeneratorStock (models/generator_stock.py) against the JAX package's, on
the CPU.

The pickle bytes come from the JAX tests' own fabricators
(tests/test_tf_legacy.py: `_fake_tf_pickle`, `_tf_gen_stub`, which draw the
TF variables by inverting the JAX name tables) and are loaded by both
packages:

* the converted tensors equal JAX's once `io/from_jax.py` carries JAX's
  trees across, exactly (rtol 0, atol 0), for D in each architecture and
  for GeneratorStock in `skip`, `resnet` and `orig` (the last from
  lod-suffixed ToRGB names); w_avg is the pickle's `dlatent_avg`.  D's
  `b4.fc.weight` is held to JAX's matrix before `discriminator_state_dict_
  from_jax`'s NHWC -> NCHW permutation: both packages take TF's Dense0
  transposed, as the reference does, and only the port flattens NCHW like
  TF (io/tf_legacy.py's docstring);
* GeneratorStock forwards agree with JAX's on the converted weights (batch 2,
  `noise_mode="const"`, truncation psi 0.7 toward `dlatent_avg`) within the
  Full generator's limits, rtol 1e-2 / atol 5e-3 (the relative L2 is
  printed: ~1e-7 in fp32);
* the restricted unpickler refuses a callable global, gives None for a
  payload that is not a TF 3-tuple, and loads stubs pickled by the JAX
  package; unknown TF kwargs, a version below 4, a missing and a mis-shaped
  tensor raise.
"""

import io
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pasta_gan_tpu.io import tf_legacy as jtf
from pasta_gan_tpu.models.generator_stock import GeneratorStock as JaxGeneratorStock
from pasta_gan_tpu.nn.discriminator import Discriminator as JaxDiscriminator
from pasta_gan_tpu_torch.io import tf_legacy as ttf
from pasta_gan_tpu_torch.io.from_jax import discriminator_state_dict_from_jax, state_dict_from_jax
from pasta_gan_tpu_torch.models.generator_stock import GeneratorStock
from pasta_gan_tpu_torch.nn.discriminator import Discriminator

from test_tf_legacy import _fake_tf_pickle, _tf_gen_stub
from test_torch_train import rel_l2
from test_torch_train_loop import one_torch_thread  # noqa: F401  (autouse fixture)

RES, W_DIM = 32, 32
GEN_RTOL, GEN_ATOL = 1e-2, 5e-3  # tests/test_torch_generator.py's limits
D_CFG = dict(c_dim=8, img_resolution=RES, img_channels=3, channel_base=512, channel_max=32, mbstd_group_size=2)


def _zeros(shapes):
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _paths(tree):
    for keypath, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        yield tuple(k.key for k in keypath), leaf


def tf_discriminator_stub(architecture, seed=0, res=RES, c_dim=8, channel_base=512, channel_max=32):
    """A TF D stub (as a plain dict) drawn by inverting JAX's name table,
    and the JAX variables (zeros) of its geometry."""
    jd = JaxDiscriminator(architecture=architecture, c_dim=c_dim, img_resolution=res, img_channels=3,
                          channel_base=channel_base, channel_max=channel_max, mbstd_group_size=2)
    c = jnp.zeros((2, c_dim)) if c_dim else None
    shapes = _zeros(jax.eval_shape(jd.init, jax.random.PRNGKey(0), jnp.zeros((2, res, res, 3)), c))
    rng = np.random.default_rng(seed)
    tf_vars = {}
    for path, leaf in _paths(shapes):
        name, transpose = jtf._tf_name_for(path[1:], res)
        shape = tuple(leaf.shape)[::-1] if transpose else tuple(leaf.shape)
        tf_vars[name] = rng.normal(0, 1, shape).astype(np.float32)
    kw = dict(label_size=c_dim, resolution=res, num_channels=3, fmap_base=channel_base // 2, fmap_max=channel_max,
              mbstd_group_size=2, architecture=architecture)
    return dict(version=4, static_kwargs=kw, variables=list(tf_vars.items()), components={}), shapes


def tf_generator_stub(architecture, res=RES, w_dim=W_DIM, mapping_layers=2, channel_base=512, channel_max=32):
    """A TF Gs stub (as a plain dict) for a stock generator of that geometry,
    drawn by JAX's `_tf_gen_stub`; "orig" is named the progressive-growing
    way (ToRGB_lod0)."""
    jg = JaxGeneratorStock(z_dim=w_dim, c_dim=0, w_dim=w_dim, img_resolution=res, img_channels=3,
                           mapping_kwargs=dict(num_layers=mapping_layers),
                           synthesis_kwargs=dict(channel_base=channel_base, channel_max=channel_max,
                                                 architecture=architecture))
    shapes = _zeros(jax.eval_shape(lambda: jg.init(jax.random.PRNGKey(0), jnp.zeros((1, w_dim)), None,
                                                   noise_mode="const")))
    kw = dict(latent_size=w_dim, label_size=0, dlatent_size=w_dim, resolution=res, num_channels=3,
              mapping_layers=mapping_layers, fmap_base=channel_base // 2, fmap_max=channel_max)
    if architecture != "orig":
        kw["architecture"] = architecture
    stub = dict(_tf_gen_stub(shapes, kw)[0])
    if architecture == "orig":
        top = f"synthesis/{res}x{res}/ToRGB/"
        stub["variables"] = [(n.replace(top, "ToRGB_lod0/"), v) for n, v in stub["variables"]]
    return stub


def tf_pickle(g_state, d_state):
    """The bytes of a legacy TF (G, D, Gs) pickle."""
    return _fake_tf_pickle([g_state, d_state, g_state])


def _load_both(g_state, d_state):
    data = tf_pickle(g_state, d_state)
    return jtf.load_tf_network_stubs(io.BytesIO(data)), ttf.load_tf_network_stubs(io.BytesIO(data))


@pytest.mark.parametrize("architecture", ["resnet", "skip", "orig"])
def test_discriminator_conversion_equals_jax(architecture):
    d_state, shapes = tf_discriminator_stub(architecture)
    jstubs, tstubs = _load_both(d_state, d_state)
    assert all(isinstance(s, ttf.TFNetworkStub) for s in tstubs)
    jvars = jtf.convert_tf_discriminator(jstubs[1], shapes)
    port = Discriminator(architecture=architecture, **D_CFG)
    got = ttf.convert_tf_discriminator(tstubs[1], port.state_dict())
    want = discriminator_state_dict_from_jax(jvars, port.state_dict())
    want["b4.fc.weight"] = state_dict_from_jax(jvars)["b4.fc.weight"]  # JAX's matrix, unpermuted
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    d_vars = dict(d_state["variables"])
    torch.testing.assert_close(got["b4.fc.weight"], torch.from_numpy(d_vars["4x4/Dense0/weight"].T.copy()))
    port.load_state_dict(got, strict=True)
    assert torch.isfinite(port(torch.ones(2, 3, RES, RES), torch.ones(2, 8))).all()
    assert ttf.discriminator_kwargs_from_tf(tstubs[1]) == jtf.discriminator_kwargs_from_tf(jstubs[1])


@pytest.mark.parametrize("architecture", ["skip", "resnet", "orig"])
def test_generator_stock_conversion_and_forward_equal_jax(architecture):
    g_state = tf_generator_stub(architecture)
    jstubs, tstubs = _load_both(g_state, g_state)
    jgen, jvars, jw_avg = jtf.generator_stock_from_tf(jstubs[2])
    tgen, sd, w_avg = ttf.generator_stock_from_tf(tstubs[2])
    assert jgen.synthesis_kwargs["architecture"] == tgen.synthesis.b8.architecture == architecture
    want = state_dict_from_jax(jvars, tgen.state_dict())
    assert sorted(sd) == sorted(want)
    for k in want:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0, msg=k)
    assert sd["synthesis.b8.conv0.noise_strength"].ndim == 0
    np.testing.assert_array_equal(w_avg.numpy(), np.asarray(jw_avg))

    z = np.random.default_rng(5).standard_normal((2, W_DIM)).astype(np.float32)
    jimg, jw = jgen.apply(jvars, jnp.asarray(z), None, w_avg=jnp.asarray(jw_avg), truncation_psi=0.7,
                          noise_mode="const")
    with torch.no_grad():
        img, w_raw = tgen(torch.from_numpy(z), None, w_avg=w_avg, truncation_psi=0.7, noise_mode="const")
    err = rel_l2(img.numpy(), jimg)
    print(f"GeneratorStock {architecture}: image relative L2 against JAX {err:.3g}")
    assert img.shape == (2, RES, RES, 3)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=GEN_RTOL, atol=GEN_ATOL)
    np.testing.assert_allclose(w_raw.numpy(), np.asarray(jw), rtol=GEN_RTOL, atol=GEN_ATOL)


def test_unpickler_refuses_code_and_loads_jax_stubs():
    class Evil:
        def __reduce__(self):
            import os

            return (os.getenv, ("HOME",))

    assert ttf.load_tf_network_stubs(io.BytesIO(pickle.dumps(Evil()))) is None
    with pytest.raises(pickle.UnpicklingError, match="not allowed"):
        ttf._LegacyUnpickler(io.BytesIO(pickle.dumps(Evil()))).load()
    assert ttf.load_tf_network_stubs(io.BytesIO(pickle.dumps({"G": 1}))) is None
    assert ttf.load_tf_network_stubs(io.BytesIO(b"")) is None
    # stubs pickled again by either package (their module path is a table entry, not an import)
    state = dict(version=4, static_kwargs={}, variables=[("w", np.ones((2, 2), np.float32))], components={})
    for stub_cls in (jtf.TFNetworkStub, ttf.TFNetworkStub):
        stubs = ttf.load_tf_network_stubs(io.BytesIO(pickle.dumps(tuple(stub_cls(state) for _ in range(3)))))
        assert stubs is not None and all(type(s) is ttf.TFNetworkStub for s in stubs)
        np.testing.assert_array_equal(ttf.collect_tf_params(stubs[0])["w"], 1.0)
    nested = ttf.TFNetworkStub(variables=[], components={"sub": ttf.TFNetworkStub(variables=[("v", np.zeros(3))])})
    assert set(ttf.collect_tf_params(nested)) == {"sub/v"}


def test_bad_kwargs_versions_and_tensors_raise():
    bad = ttf.TFNetworkStub(version=4, static_kwargs=dict(bogus=1), variables=[], components={})
    old = ttf.TFNetworkStub(version=3, static_kwargs={}, variables=[], components={})
    for fn in (ttf.generator_kwargs_from_tf, ttf.discriminator_kwargs_from_tf):
        with pytest.raises(ValueError, match="Unknown TensorFlow kwarg bogus"):
            fn(bad)
        with pytest.raises(ValueError, match="version too low"):
            fn(old)
    g = ttf.TFNetworkStub(tf_generator_stub("skip"))
    assert ttf.generator_kwargs_from_tf(g) == jtf.generator_kwargs_from_tf(jtf.TFNetworkStub(g))
    target = GeneratorStock(**ttf.generator_kwargs_from_tf(g)).state_dict()
    missing = ttf.TFNetworkStub(g, variables=[kv for kv in g.variables if kv[0] != "synthesis/8x8/Conv1/weight"])
    with pytest.raises(KeyError, match="synthesis/8x8/Conv1/weight"):
        ttf.convert_tf_generator(missing, target)
    wrong = ttf.TFNetworkStub(g, variables=[(n, v[:1] if n == "mapping/Dense0/bias" else v) for n, v in g.variables])
    with pytest.raises(ValueError, match="mapping/Dense0/bias"):
        ttf.convert_tf_generator(wrong, target)
