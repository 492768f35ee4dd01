"""The flow generator V1 of the port (pasta_gan_tpu_torch/nn/flow.py,
models/generator_v1.py, nn/encoders.py:StyleEncoderNetwork) against the JAX
package's, on the CPU.

* SpectralConv and SpectralConvTranspose, with and without `update_sn`:
  outputs within rtol 1e-4 / atol 1e-5, and after one power iteration u and
  v within 1e-6 of JAX's written-back "spectral" collection.
* `batch_norm_2d`, `apply_offset` and `grid_sample_border` (in-range and
  border coordinates) within 1e-5; `l2_normalize_channels` and `AddCoords`
  (with and without the radius; V1 uses neither) within 1e-6.
* FlowNet(12) at 64x64 by the JAX V1 test's normalized error (random
  spectral + batch-statistics stacks amplify to offsets of order 1e8):
  mean |port - JAX| / mean |JAX| <= 1e-3, max <= 5e-2.
* GeneratorV1 at 64x64 (channel_base 512, channel_max 32, batch 2, noise
  const) after a strict carry of the "params", "buffers" and "spectral"
  collections: the flow head `flow3` is scaled alike on both sides so that
  the offsets spread by 3 pixels (most samples land inside the frame, so the
  image parity tests the warp), then the image within rtol 1e-2 /
  atol 5e-3.  bf16 against fp32 is printed beside JAX's own distance and
  must not exceed it by more than a quarter.
* StyleEncoderNetwork at its reference indices (`model.5` the attention).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pasta_gan_tpu.models import GeneratorV1 as JaxGeneratorV1
from pasta_gan_tpu.nn import flow as jflow
from pasta_gan_tpu.nn.encoders import StyleEncoderNetwork as JaxStyleEncoderNetwork
from pasta_gan_tpu_torch import models
from pasta_gan_tpu_torch.io.from_jax import state_dict_from_jax
from pasta_gan_tpu_torch.nn import flow
from pasta_gan_tpu_torch.nn.encoders import StyleEncoderNetwork

from test_torch_generator import _jax_variables

R, N = 64, 2
CFG = dict(img_resolution=R, channel_base=512, channel_max=32)
KEYS = ("c", "retain", "pose", "aff_pose", "aff_top", "lower")
OFFSET_STD = 3.0  # pixels: the scaled flow head's offset spread
IN_FRAME = 0.8  # share of the grid's samples that must land inside the frame


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def unit_vectors(shapes, rng):
    """Normalized N(0, 1) u and v for every leaf of a "spectral" collection."""
    def draw(leaf):
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        return a / np.linalg.norm(a)
    return jax.tree_util.tree_map(draw, shapes)


def _conv_pair(transpose, update_sn, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 12, 12)).astype(np.float32)  # NCHW
    if transpose:
        jm, pm = jflow.SpectralConvTranspose(8, 16, 3, update_sn=update_sn), flow.SpectralConvTranspose(8, 16, 3)
    else:
        jm, pm = jflow.SpectralConv(8, 16, 3, 2, 1, update_sn=update_sn), flow.SpectralConv(8, 16, 3, 2, 1)
    pm.update_sn = update_sn
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 12, 12, 8))))
    v = {"params": jax.tree_util.tree_map(lambda l: rng.standard_normal(l.shape).astype(np.float32) * 0.3,
                                          shapes["params"]),
         "spectral": unit_vectors(shapes["spectral"], rng)}
    pm.load_state_dict(state_dict_from_jax(v, pm.state_dict()), strict=True)
    return jm, pm, v, x


@pytest.mark.parametrize("transpose", [False, True], ids=["conv", "transposed"])
@pytest.mark.parametrize("update_sn", [False, True], ids=["eval", "update_sn"])
def test_spectral_convs_match_jax(transpose, update_sn):
    jm, pm, v, x = _conv_pair(transpose, update_sn, seed=int(transpose) * 2 + int(update_sn))
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    if update_sn:
        yj, state = jm.apply(v, xj, mutable=["spectral"])
    else:
        yj, state = jm.apply(v, xj), v
    y = pm(torch.from_numpy(x))
    assert y.shape == (2, 16, 24, 24) if transpose else (2, 16, 6, 6)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(yj).transpose(0, 3, 1, 2), rtol=1e-4, atol=1e-5)
    for name in ("weight_u", "weight_v"):
        np.testing.assert_allclose(getattr(pm, name).numpy(), np.asarray(state["spectral"][name]), atol=1e-6)
    moved = not np.allclose(np.asarray(state["spectral"]["weight_u"]), v["spectral"]["weight_u"])
    assert moved == update_sn
    y.sum().backward()  # the gradient reaches weight_orig through sigma, not through u and v
    assert pm.weight_orig.grad is not None and bool(torch.isfinite(pm.weight_orig.grad).all())


def test_batch_norm_apply_offset_and_grid_sample_match_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 5, 7, 6)) * 2 + 1).astype(np.float32)
    w, b = rng.standard_normal(6).astype(np.float32), rng.standard_normal(6).astype(np.float32)
    bn = flow.batch_norm_2d(nchw(x), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(bn.numpy().transpose(0, 2, 3, 1),
                               np.asarray(jflow.batch_norm_2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-5)

    img = rng.standard_normal((2, 24, 20, 3)).astype(np.float32)
    for scale in (2.0, 30.0):  # in range, and far past the border (replicated)
        offset = (rng.standard_normal((2, 24, 20, 2)) * scale).astype(np.float32)
        grid = flow.apply_offset(nchw(offset))
        grid_j = jflow.apply_offset(jnp.asarray(offset))
        np.testing.assert_allclose(grid.numpy(), np.asarray(grid_j), rtol=1e-6, atol=1e-6)
        out = flow.grid_sample_border(nchw(img), grid)
        out_j = jflow.grid_sample_border(jnp.asarray(img), grid_j)
        outside = float((grid.abs() > 1).any(-1).float().mean())
        print(f"offset scale {scale}: {outside:.3f} of the samples outside the frame")
        assert (outside < 0.2) if scale == 2.0 else (outside > 0.5)
        np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(flow.l2_normalize_channels(nchw(img)).numpy().transpose(0, 2, 3, 1),
                               np.asarray(jflow.l2_normalize_channels(jnp.asarray(img))), rtol=1e-6, atol=1e-6)
    for with_r in (False, True):  # width 20 != height 24: the coordinate channels cannot swap unseen
        out = flow.AddCoords(with_r)(nchw(img))
        out_j = jflow.AddCoords(with_r=with_r).apply({}, jnp.asarray(img))
        assert out.shape[1] == 3 + 2 + with_r
        np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), np.asarray(out_j), rtol=1e-6, atol=1e-6)


def test_flownet_matches_jax_by_normalized_error():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((N, R, R, 12)).astype(np.float32)
    jnet = jflow.FlowNet(12)
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v = {"params": jax.tree_util.tree_map(lambda l: rng.standard_normal(l.shape).astype(np.float32) * 0.05,
                                          shapes["params"]),
         "spectral": unit_vectors(shapes["spectral"], rng)}
    net = flow.FlowNet(12)
    net.load_state_dict(state_dict_from_jax(v, net.state_dict()), strict=True)
    grid_j = np.asarray(jax.jit(jnet.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        grid = net(nchw(x)).numpy()
    denom = np.mean(np.abs(grid_j))
    mean_err, max_err = np.mean(np.abs(grid - grid_j)) / denom, np.max(np.abs(grid - grid_j)) / denom
    print(f"FlowNet 64x64: mean |grid| {denom:.4g}; normalized error mean {mean_err:.3g}, max {max_err:.3g}")
    assert mean_err <= 1e-3 and max_err <= 5e-2


@pytest.fixture(scope="module")
def v1_pair():
    rng = np.random.default_rng(0)
    inp = dict(c=rng.standard_normal((N, R // 4, R // 4, 48)), retain=rng.standard_normal((N, R, R, 3)),
               pose=rng.standard_normal((N, R, R, 6)), aff_pose=rng.standard_normal((N, R, R, 3)),
               aff_top=rng.standard_normal((N, R, R, 3)), lower=rng.standard_normal((N, R, R, 3)))
    inp = {k: (a * 0.5).astype(np.float32) for k, a in inp.items()}
    jgen = JaxGeneratorV1(**CFG)
    v = _jax_variables(jgen, inp, seed=1)
    shapes = jax.eval_shape(lambda: jgen.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                                              None, **{k: jnp.asarray(a) for k, a in inp.items()},
                                              noise_mode="const"))
    v["spectral"] = unit_vectors(shapes["spectral"], rng)
    port = models.build_model("GeneratorV1", **CFG)
    port.load_state_dict(state_dict_from_jax(v, port.state_dict()), strict=True)
    port.eval()
    x = [torch.from_numpy(inp[k]) for k in KEYS]
    with torch.no_grad():
        off = port.flownet.offset(port.flow_input(*x[2:]))
    # scale the flow head alike on both sides: the offsets then spread by OFFSET_STD pixels
    scale = np.float32(OFFSET_STD / float(off.std()))
    head = v["params"]["flownet"]["flow3"]
    head["weight"], head["bias"] = head["weight"] * scale, head["bias"] * scale
    port.load_state_dict(state_dict_from_jax(v, port.state_dict()), strict=True)
    return port, jgen, v, inp, x, float(off.std())


def test_generator_v1_matches_jax(v1_pair):
    port, jgen, v, inp, x, raw_std = v1_pair
    with torch.no_grad():
        grid = port.flow(*x[2:])
        img = port(None, *x, noise_mode="const").numpy()
    inside = float((grid.abs() <= 1).all(-1).float().mean())
    xj = {k: jnp.asarray(a) for k, a in inp.items()}
    ref = np.asarray(jax.jit(lambda v, x: jgen.apply(v, None, **x, noise_mode="const"))(v, xj))
    print(f"GeneratorV1 64x64: unscaled offset std {raw_std:.4g}; {inside:.3f} of the samples in the frame; "
          f"image relative L2 against JAX {rel_l2(img, ref):.3g}")
    assert inside >= IN_FRAME
    assert img.shape == (N, R, R, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(img, ref, rtol=1e-2, atol=5e-3)

    port.set_dtype(torch.bfloat16)
    try:
        with torch.no_grad():
            img16 = port(None, *x, noise_mode="const").float().numpy()
    finally:
        port.set_dtype(torch.float32)
    jb = JaxGeneratorV1(**CFG, dtype=jnp.bfloat16)
    ref16 = np.asarray(jax.jit(lambda v, x: jb.apply(v, None, **x, noise_mode="const"))(v, xj), np.float32)
    port_d, jax_d = rel_l2(img16, img), rel_l2(ref16, ref)
    print(f"GeneratorV1 bf16 vs fp32 relative L2: port {port_d:.4g}, JAX {jax_d:.4g}")
    assert port_d <= 1.25 * jax_d


def test_generator_v1_update_sn_moves_only_the_spectral_buffers(v1_pair):
    port = models.build_model("GeneratorV1", **CFG).eval()
    port.load_state_dict(v1_pair[0].state_dict())
    before = {k: t.clone() for k, t in port.state_dict().items()}
    port.flownet.set_update_sn(True)
    with torch.no_grad():
        port(None, *v1_pair[4], noise_mode="const")
    moved = {k for k, t in port.state_dict().items() if not torch.equal(t, before[k])}
    assert moved and all(k.startswith("flownet.") and k.endswith(("weight_u", "weight_v")) for k in moved)
    n_sn = sum(isinstance(m, flow._SpectralNorm) for m in port.modules())
    assert len(moved) == 2 * n_sn, (len(moved), n_sn)


def test_style_encoder_network_at_reference_indices():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16, 48)).astype(np.float32)
    retain = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    jenc = JaxStyleEncoderNetwork(48, output_nc=128, ngf=16)
    shapes = jax.eval_shape(lambda: jenc.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(retain)))
    v = {"params": jax.tree_util.tree_map(lambda l: rng.standard_normal(l.shape).astype(np.float32) * 0.2,
                                          shapes["params"])}
    v["params"]["model.5"]["gamma"] = np.float32(0.7)  # the attention's residual gain, 0 at init
    enc = StyleEncoderNetwork(48, output_nc=128, ngf=16)
    sd = state_dict_from_jax(v, enc.state_dict())
    enc.load_state_dict(sd, strict=True)
    assert "model.5.theta.weight" in sd and "model.6.linear.weight" in sd and "model.13.weight" in sd
    style_j, feats_j = jenc.apply(v, jnp.asarray(x), jnp.asarray(retain))
    with torch.no_grad():
        style, feats = enc(nchw(x), nchw(retain))
    np.testing.assert_allclose(style.numpy(), np.asarray(style_j), rtol=1e-4, atol=1e-4)
    for a, b in zip(feats, feats_j):
        np.testing.assert_allclose(a.numpy().transpose(0, 2, 3, 1), np.asarray(b), rtol=1e-4, atol=1e-4)
