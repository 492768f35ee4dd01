"""Port GeneratorFull vs the JAX package's, and the weight translation both ways.

* JAX variables -> `state_dict_from_jax` -> `load_state_dict(strict=True)`,
  and back: the port's `state_dict()` through the JAX package's own
  `convert_generator_full` reproduces every JAX leaf exactly (full width).
* Forward parity with `noise_mode="none"`, the JAX side run with
  `pack_tail=True` and `pack_tail=False`: (img, pred_parsing) rtol 1e-2 /
  atol 5e-3, finetune_img rtol 1e-2 / atol 1e-2 (tests/test_torch_import.py's
  tolerances for the full model).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pasta_gan_tpu.io.torch_import import convert_generator_full
from pasta_gan_tpu.models import GeneratorFull as JaxGeneratorFull
from pasta_gan_tpu_torch.io.checkpoints import load_snapshot, save_snapshot
from pasta_gan_tpu_torch.io.from_jax import state_dict_from_jax
from pasta_gan_tpu_torch.models import GeneratorFull, cat_feats_dict

RES = 256
KEYS = ("c", "retain", "pose", "denorm_upper_input", "denorm_lower_input", "denorm_upper_mask",
        "denorm_lower_mask")


def _inputs(seed=0, N=1, R=RES):
    rng = np.random.default_rng(seed)
    return dict(
        c=rng.standard_normal((N, R // 4, R // 4, 42)).astype(np.float32) * 0.5,
        retain=rng.standard_normal((N, R, R, 3)).astype(np.float32) * 0.5,
        pose=rng.standard_normal((N, R, R, 6)).astype(np.float32) * 0.5,
        denorm_upper_input=rng.standard_normal((N, R, R, 3)).astype(np.float32) * 0.5,
        denorm_lower_input=rng.standard_normal((N, R, R, 3)).astype(np.float32) * 0.5,
        denorm_upper_mask=(rng.uniform(size=(N, R, R, 1)) > 0.4).astype(np.float32),
        denorm_lower_mask=(rng.uniform(size=(N, R, R, 1)) > 0.4).astype(np.float32),
    )


def _jax_variables(gen, inputs, seed=0):
    """The JAX generator's variable tree (from eval_shape: no compile), every
    leaf drawn from a numpy seed with its init's scale."""
    shapes = jax.eval_shape(lambda: gen.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, None,
        **{k: jnp.asarray(v) for k, v in inputs.items()}, noise_mode="random"))
    rng = np.random.default_rng(seed)

    def scaled(names, x, leaf):
        if names[-1] in ("bias", "m_bias1", "noise_strength"):
            return x * 0.1 + (1.0 if names[-2] == "affine" else 0.0)
        if names[-1] == "kernel":
            return x / np.sqrt(leaf.shape[0])
        if names[1] == "mapping" and names[-2].startswith("fc"):
            return x / 0.01  # lr_multiplier
        return x

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        return np.asarray(scaled([p.key for p in path], x, leaf), np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port_from_jax(variables, **cfg):
    gen = GeneratorFull(**cfg)
    gen.load_state_dict(state_dict_from_jax(variables, gen.state_dict()), strict=True)
    return gen.eval()


def test_state_dict_round_trip_full_width():
    """At the served width: JAX tree -> port -> the JAX package's converter
    gives back every leaf bit for bit."""
    cfg = dict(img_resolution=RES, channel_base=16384, channel_max=512)
    jgen = JaxGeneratorFull(**cfg)
    v = _jax_variables(jgen, _inputs(N=1))
    port = _port_from_jax(v, **cfg)
    back = convert_generator_full({k: t.numpy() for k, t in port.state_dict().items()}, v)
    flat_v = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_v) == len(port.state_dict())
    for path, leaf in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf, err_msg=jax.tree_util.keystr(path))


def test_state_dict_from_jax_rejects_mismatches():
    cfg = dict(img_resolution=RES, channel_base=512, channel_max=32)
    v = _jax_variables(JaxGeneratorFull(**cfg), _inputs())
    port = GeneratorFull(**cfg)
    expected = port.state_dict()
    state_dict_from_jax(v, expected)
    missing = {"params": {k: d for k, d in v["params"].items() if k != "mapping"}}
    with pytest.raises(KeyError):
        state_dict_from_jax(missing, expected)
    extra = {"params": dict(v["params"], extra_block={"weight": np.zeros((1, 1, 1, 1), np.float32)})}
    with pytest.raises(KeyError):
        state_dict_from_jax(extra, expected)
    bad = jax.tree_util.tree_map(lambda x: x, v)
    bad["params"]["mapping"]["fc0"]["weight"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        state_dict_from_jax(bad, expected)
    with pytest.raises(KeyError):
        state_dict_from_jax(dict(v, buffers={}), expected)


@pytest.mark.parametrize("pack_tail", [True, False])
def test_forward_matches_jax(pack_tail):
    cfg = dict(img_resolution=RES, channel_base=512, channel_max=32)
    jgen = JaxGeneratorFull(pack_tail=pack_tail, **cfg)
    inp = _inputs(seed=1)
    v = _jax_variables(jgen, inp, seed=2)
    ref = jax.jit(lambda v, x: jgen.apply(v, None, **x, noise_mode="none"))(
        v, {k: jnp.asarray(a) for k, a in inp.items()})
    port = _port_from_jax(v, **cfg)
    with torch.no_grad():
        ours = port(None, *[torch.from_numpy(inp[k]) for k in KEYS], noise_mode="none")
    for name, a, b, atol in zip(("img", "finetune_img", "pred_parsing"), ours, ref, (5e-3, 1e-2, 5e-3)):
        assert tuple(a.shape) == tuple(b.shape), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-2, atol=atol, err_msg=name)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_forward_bf16_matches_jax_bf16_and_fp32():
    """bf16 compute (`set_dtype`, the served mode) against the JAX package's
    `dtype=bfloat16` generator and against the port's own fp32 forward, on
    the same weights: every output within a relative L2 error of 0.05 (a
    correct bf16 path lands near 0.01 here)."""
    cfg = dict(img_resolution=RES, channel_base=512, channel_max=32)
    inp = _inputs(seed=5)
    v = _jax_variables(JaxGeneratorFull(**cfg), inp, seed=2)
    jgen16 = JaxGeneratorFull(dtype=jnp.bfloat16, **cfg)
    ref16 = jax.jit(lambda v, x: jgen16.apply(v, None, **x, noise_mode="none"))(
        v, {k: jnp.asarray(a, jnp.bfloat16) for k, a in inp.items()})
    port = _port_from_jax(v, **cfg)
    with torch.no_grad():
        ours32 = port(None, *[torch.from_numpy(inp[k]) for k in KEYS], noise_mode="none")
        ours16 = port.set_dtype(torch.bfloat16)(
            None, *[torch.from_numpy(inp[k]).bfloat16() for k in KEYS], noise_mode="none")
    for name, a16, j16, a32 in zip(("img", "finetune_img", "pred_parsing"), ours16, ref16, ours32):
        a16 = a16.float().numpy()
        assert np.isfinite(a16).all(), name
        assert _rel_l2(a16, j16) <= 0.05, (name, _rel_l2(a16, j16))
        # above 0: the forward really computed in bf16
        assert 0 < _rel_l2(a16, a32.numpy()) <= 0.05, (name, _rel_l2(a16, a32.numpy()))


def test_sub_callables_and_snapshot_round_trip(tmp_path):
    """encode_style / encode_pose / map_ws / synthesize (the CLI's sequence)
    equal forward, and a snapshot reloads to the same outputs."""
    cfg = dict(img_resolution=RES, channel_base=512, channel_max=32)
    gen = GeneratorFull(**cfg).reset_parameters(torch.Generator().manual_seed(0)).eval()
    x = {k: torch.from_numpy(a) for k, a in _inputs(seed=3).items()}
    w_avg = torch.randn(512, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        full = gen(None, *[x[k] for k in KEYS], truncation_psi=0.7, w_avg=w_avg, noise_mode="none")
        style, feats = gen.encode_style(x["c"], x["retain"])
        ws, _ = gen.map_ws(None, style, w_avg=w_avg, truncation_psi=0.7)
        split = gen.synthesize(ws, gen.encode_pose(x["pose"]), cat_feats_dict(feats),
                               *[x[k] for k in KEYS[3:]], noise_mode="none")
    for a, b in zip(full, split):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    path = str(tmp_path / "snap.pt")
    save_snapshot(path, gen.state_dict(), w_avg, {"model": gen.config})
    sd, w2, config = load_snapshot(path)
    assert config["model"] == gen.config
    gen2 = GeneratorFull(**config["model"])
    gen2.load_state_dict(sd, strict=True)
    with torch.no_grad():
        again = gen2.eval()(None, *[x[k] for k in KEYS], truncation_psi=0.7, w_avg=w2, noise_mode="none")
    for a, b in zip(full, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_random_noise_uses_the_explicit_generator():
    cfg = dict(img_resolution=RES, channel_base=512, channel_max=32)
    gen = GeneratorFull(**cfg).reset_parameters(torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        for m in gen.modules():
            if getattr(m, "noise_strength", None) is not None:
                m.noise_strength.fill_(0.5)
    x = [torch.from_numpy(_inputs(seed=4)[k]) for k in KEYS]

    def run(seed):
        with torch.no_grad():
            return gen(None, *x, noise_mode="random", generator=torch.Generator().manual_seed(seed))[1]

    torch.testing.assert_close(run(7), run(7), rtol=0, atol=0)
    assert not torch.equal(run(7), run(8))
