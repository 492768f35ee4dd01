"""The port's regularizers and training options (train/losses.py, train/vgg.py,
train/step.py, cli/train.py) against the JAX package, on the CPU, at the tiny
config of tests/test_torch_train.py (res 16, channel_base 256, channel_max
32, mbstd group 2, batch 4, fp32, noise off, Adam eps 1e-3 on both sides),
weights carried by io/from_jax.py:

* `contextual_loss` on numpy-seeded features, with and without `pono`, with
  a tied row minimum and chunk sizes that do and do not divide H*W: the
  value within rtol 1e-5, the gradient with respect to x within a relative
  L2 of 1e-4; `contextual_vgg_loss` through one carried VGG19 the same way;
* `g_loss_fn` with `contextual_weight` 1: every stat within LOSS_RTOL;
* `g_pl_step` (Greg, `pl_weight` 2) from pl_mean 0 and from 0.05, with the
  path-length noise rebuilt from JAX's key chain: the penalties and the new
  pl_mean within LOSS_RTOL, G's step within STEP_REL_L2.  (Two steps in a
  row are not compared: the first step's 1e-4 differences grow past
  STEP_REL_L2 in the second, whose penalty is a small difference of
  lengths);
* `run_G` at z_dim 8 on draws taken from JAX's key chain, once with the
  mixing on and once off: ws and the images within 1e-4;
  `MappingNetwork` with z against JAX's, and a GeneratorFull at z_dim 8 and
  full width through `state_dict_from_jax` and back through the JAX
  package's `convert_generator_full`, bit for bit;
* `cli.train -n` prints the config that `pasta_gan_tpu.cli.train -n` prints
  for the same flags (compared as parsed JSON: `kimg_per_tick` is a float in
  the port).
"""

import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pasta_gan_tpu.cli import train as jax_cli_train
from pasta_gan_tpu.io.torch_import import convert_generator_full
from pasta_gan_tpu.models import GeneratorFull as JaxGeneratorFull
from pasta_gan_tpu.nn.mapping import MappingNetwork as JaxMappingNetwork
from pasta_gan_tpu.train.losses import contextual_loss as jax_contextual_loss
from pasta_gan_tpu.train.vgg import contextual_vgg_loss as jax_contextual_vgg_loss
from pasta_gan_tpu.train.vgg import init_vgg19 as jax_init_vgg19
from pasta_gan_tpu_torch.cli import train as cli_train
from pasta_gan_tpu_torch.io.from_jax import state_dict_from_jax, vgg19_state_dict_from_jax
from pasta_gan_tpu_torch.models import GeneratorFull
from pasta_gan_tpu_torch.nn.mapping import MappingNetwork
from pasta_gan_tpu_torch.train.losses import contextual_loss
from pasta_gan_tpu_torch.train.vgg import VGG19Features, contextual_vgg_loss

from test_torch_train import LOSS_RTOL, N, RES, STEP_REL_L2, _flat, jax_tiny_config, make_pair, rel_l2
from test_torch_train_loop import one_torch_thread  # noqa: F401  (autouse fixture)

CX_RTOL, CX_GRAD_REL_L2 = 1e-5, 1e-4


def _jax_cx(x, y, **kw):
    return jax.value_and_grad(lambda a: jax_contextual_loss(a, jnp.asarray(y), **kw))(jnp.asarray(x))


def _port_cx(fn, x, y):
    xt = torch.from_numpy(x).requires_grad_(True)
    v = fn(xt, torch.from_numpy(y))
    (g,) = torch.autograd.grad(v, xt)
    return float(v.detach()), g.numpy()


@pytest.mark.parametrize("pono", [True, False])
def test_contextual_loss_matches_jax(pono):
    rng = np.random.default_rng(0)
    n, h, w, c = 3, 8, 6, 16
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    y = rng.standard_normal((n, h, w, c)).astype(np.float32)
    # a tied row minimum (and row maximum of the affinities): y's positions 5 and
    # 9 are one vector, and x's position 5 is that vector too
    yq, xq = y.reshape(n, h * w, c), x.reshape(n, h * w, c)
    yq[:, 9] = yq[:, 5]
    xq[:, 5] = yq[:, 5]
    mu = y.mean(axis=-1, keepdims=True) if pono else y.mean(axis=(1, 2), keepdims=True)
    xf, yf = (((a - mu) / np.linalg.norm(a - mu, axis=-1, keepdims=True)).reshape(n, h * w, c) for a in (x, y))
    d = 1.0 - np.einsum("nqc,nkc->nqk", xf, yf)
    assert (d[:, 5] == d[:, 5].min(axis=-1, keepdims=True)).sum(axis=-1).min() >= 2  # the tie is there
    jv, jg = _jax_cx(x, y, pono=pono)
    # one chunk of whole samples; 5 rows, which do not divide H*W = 48; rows of one sample
    for chunk in (1 << 26, 5 * h * w, 1):
        v, g = _port_cx(lambda a, b: contextual_loss(a, b, pono=pono, chunk_elems=chunk), x, y)
        np.testing.assert_allclose(v, float(jv), rtol=CX_RTOL, err_msg=f"chunk {chunk}")
        assert rel_l2(g, jg) <= CX_GRAD_REL_L2, (chunk, rel_l2(g, jg))


def test_contextual_vgg_loss_matches_jax():
    vgg_vars = jax.tree_util.tree_map(np.asarray, jax_init_vgg19(jax.random.PRNGKey(3), image_size=16))
    vgg = VGG19Features()
    vgg.load_state_dict(vgg19_state_dict_from_jax(vgg_vars, vgg.state_dict()), strict=True)
    vgg.requires_grad_(False).eval()
    rng = np.random.default_rng(1)
    x, y = (np.clip(rng.standard_normal((2, 32, 32, 3)) * 0.5, -1, 1).astype(np.float32) for _ in range(2))
    jv, jg = jax.jit(jax.value_and_grad(lambda a, b: jax_contextual_vgg_loss(vgg_vars, a, b)))(
        jnp.asarray(x), jnp.asarray(y))
    v, g = _port_cx(lambda a, b: contextual_vgg_loss(vgg, a, b), x, y)
    assert v > 0
    np.testing.assert_allclose(v, float(jv), rtol=CX_RTOL)
    assert rel_l2(g, jg) <= CX_GRAD_REL_L2, rel_l2(g, jg)


@pytest.fixture(scope="module")
def reg_pair():
    jcfg = jax_tiny_config()
    jcfg = dataclasses.replace(jcfg, loss=dataclasses.replace(jcfg.loss, pl_weight=2.0, contextual_weight=1.0))
    return make_pair(jcfg)


def test_g_loss_fn_with_contextual_matches_jax(reg_pair):
    jt, js, pt, ps, b_j, b_t = reg_pair
    total_j, (stats_j, _) = jax.jit(lambda g, d: jt.g_loss_fn(g, d, b_j, js.ada_p, jax.random.PRNGKey(1)))(
        js.g_params, js.d_params)
    with torch.no_grad():
        total, stats = pt.g_loss_fn(ps.G, ps.D, b_t)
    assert float(stats["Loss/G/contextual"]) > 0
    np.testing.assert_allclose(float(total), float(total_j), rtol=LOSS_RTOL)
    for k, v in stats_j.items():
        np.testing.assert_allclose(float(stats[k]), float(v), rtol=LOSS_RTOL, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("pl_mean", [0.0, 0.05])
def test_g_pl_step_matches_jax(reg_pair, pl_mean):
    jt, js, pt, ps, b_j, b_t = reg_pair
    ps = copy.deepcopy(ps)  # the step updates in place
    ps.pl_mean.fill_(pl_mean)
    js = dataclasses.replace(js, pl_mean=jnp.float32(pl_mean))
    rng = jax.random.PRNGKey(10)
    g0 = {k: v.clone() for k, v in ps.G.state_dict().items()}
    js1, jstats = jax.jit(jt.g_pl_step)(js, b_j, rng)
    # JAX's draw: fold_in(rng, step), split, normal over the shrunk batch's image / sqrt(H W)
    pl_rng, _ = jax.random.split(jax.random.fold_in(rng, js.step), 2)
    noise = jax.random.normal(pl_rng, (N // 2, RES, RES, 3)) / jnp.sqrt(jnp.asarray(RES * RES, jnp.float32))
    ps, stats = pt.g_pl_step(ps, b_t, pl_noise=torch.from_numpy(np.array(noise)))
    assert sorted(stats) == sorted(jstats)
    for k, v in jstats.items():
        np.testing.assert_allclose(float(stats[k]), float(v), rtol=LOSS_RTOL, err_msg=k)
    assert float(stats["Loss/pl_penalty"]) > 0
    np.testing.assert_allclose(float(ps.pl_mean), float(js1.pl_mean), rtol=LOSS_RTOL)
    assert float(ps.pl_mean) != pl_mean
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, js1.g_params))
    ours = ps.G.state_dict()
    delta = {k: ours[k].numpy() - g0[k].numpy() for k in ref}
    assert rel_l2(_flat(delta), _flat({k: ref[k].numpy() - g0[k].numpy() for k in ref})) <= STEP_REL_L2
    assert not any(np.abs(d).max() > 0 for k, d in delta.items() if k.startswith("D."))


def _mixing_draws(rng, n, z_dim, num_ws, prob):
    """JAX run_G's draws for key `rng` (pasta_gan_tpu/train/step.py:148-176)."""
    z_rng, mix_rng, cutoff_rng, _ = jax.random.split(rng, 4)
    cutoff_rng, use_rng = jax.random.split(cutoff_rng)
    return {"z": torch.from_numpy(np.array(jax.random.normal(z_rng, (n, z_dim)))),
            "z2": torch.from_numpy(np.array(jax.random.normal(mix_rng, (n, z_dim)))),
            "cutoff": int(jax.random.randint(cutoff_rng, (), 1, num_ws)),
            "use_mix": bool(jax.random.uniform(use_rng) < prob)}


def test_run_g_style_mixing_matches_jax():
    jcfg = jax_tiny_config()
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, z_dim=8),
                               loss=dataclasses.replace(jcfg.loss, style_mixing_prob=0.5))
    jt, js, pt, ps, b_j, b_t = make_pair(jcfg)
    num_ws = ps.G.num_ws
    run = jax.jit(lambda g, r: jt.run_G(g, b_j, r))
    seen = set()
    for i in range(16):
        rng = jax.random.PRNGKey(i)
        draws = _mixing_draws(rng, N, 8, num_ws, 0.5)
        if draws["use_mix"] in seen:
            continue
        seen.add(draws["use_mix"])
        ref = run(js.g_params, rng)
        with torch.no_grad():
            ours = pt.run_G(ps.G, b_t, draws=draws)
        ws = ours[3].numpy()
        mixed = not np.array_equal(ws[:, 0], ws[:, -1])
        assert mixed == draws["use_mix"], draws
        for name, a, b in zip(("img", "finetune_img", "pred_parsing", "ws", "w_raw", "stylecode"), ours, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=name)
    assert seen == {True, False}
    # without draws, the trainer draws its own from the host generator
    with torch.no_grad():
        img = pt.run_G(ps.G, b_t)[0]
    assert torch.isfinite(img).all()


def test_mapping_with_z_matches_jax():
    jmap = JaxMappingNetwork(z_dim=8, c_dim=16, w_dim=32, num_ws=5, num_layers=2)
    rng = np.random.default_rng(2)
    z, c = rng.standard_normal((3, 8)).astype(np.float32), rng.standard_normal((3, 16)).astype(np.float32)
    shapes = jax.eval_shape(jmap.init, jax.random.PRNGKey(0), jnp.asarray(z), jnp.asarray(c))
    v = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    port = MappingNetwork(8, 16, 32, 5, num_layers=2)
    port.load_state_dict(state_dict_from_jax(v, port.state_dict()), strict=True)
    w_avg = rng.standard_normal(32).astype(np.float32)
    for psi, cutoff in ((1.0, None), (0.7, None), (0.5, 2)):
        ref = jmap.apply(v, jnp.asarray(z), jnp.asarray(c), w_avg=jnp.asarray(w_avg), truncation_psi=psi,
                         truncation_cutoff=cutoff)
        with torch.no_grad():
            ours = port(torch.from_numpy(z), torch.from_numpy(c), w_avg=torch.from_numpy(w_avg),
                        truncation_psi=psi, truncation_cutoff=cutoff)
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_state_dict_round_trip_z_dim_full_width():
    cfg = dict(z_dim=8, img_resolution=256, channel_base=16384, channel_max=512)
    jgen = JaxGeneratorFull(**cfg)
    rng = np.random.default_rng(0)
    x = lambda *s: jnp.zeros((1,) + s, jnp.float32)  # noqa: E731
    shapes = jax.eval_shape(lambda: jgen.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, x(8), x(64, 64, 42), x(256, 256, 3),
        x(256, 256, 6), x(256, 256, 3), x(256, 256, 3), x(256, 256, 1), x(256, 256, 1), noise_mode="const"))
    v = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    port = GeneratorFull(**cfg)
    assert tuple(port.mapping.fc0.weight.shape) == (512, 8 + 512)
    port.load_state_dict(state_dict_from_jax(v, port.state_dict()), strict=True)
    back = convert_generator_full({k: t.numpy() for k, t in port.state_dict().items()}, v)
    flat_v = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_v) == len(port.state_dict())
    for path, leaf in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf, err_msg=jax.tree_util.keystr(path))


def _dry_run_config(main, argv, capsys):
    main(argv)
    out = capsys.readouterr().out
    head, rest = out.split("Resolved training config:\n", 1)
    assert rest.rstrip().endswith("Dry run: exiting (reference --dry-run semantics).")
    return json.loads(rest.split("\n\nDry run:", 1)[0])


@pytest.mark.parametrize("flags", [
    [],
    ["--cfg", "paper256", "--batch", "8", "--pl_weight", "2", "--contextual_weight", "1", "--gamma", "5",
     "--aug", "fixed", "--p", "0.2", "--kimg_per_tick", "2", "--img_snap", "3", "--workers", "2",
     "--fmaps", "0.25", "--accum", "2", "--dtype", "float32", "--ada_exact_geom", "--seed", "7", "--snap", "5"],
    ["--aug", "noaug", "--vgg_weight", "0", "--l1_weight", "10", "--mask_weight", "0", "--augpipe", "bgcfnc",
     "--target", "0.5", "--ada_stack_calls", "RESUME"],
])
def test_cli_dry_run_prints_the_jax_config(flags, tmp_path, capsys):
    resume = tmp_path / "network.pkl"
    resume.write_bytes(b"")  # a file: both CLIs then speed ADA up (ada.kimg 100)
    argv = ["--outdir", str(tmp_path / "runs"), *[str(resume) if f == "RESUME" else f for f in flags]]
    if "RESUME" in flags:
        argv.insert(-1, "--resume")
    ref = _dry_run_config(jax_cli_train.main, argv + ["-n"], capsys)
    ours = _dry_run_config(cli_train.main, argv + ["--dry-run"], capsys)
    assert ours == ref
    assert not (tmp_path / "runs").exists()
    if "RESUME" in flags:
        assert ours["ada"]["kimg"] == 100
