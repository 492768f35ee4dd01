"""`cli.train --resume <network pickle>` on the CPU, end to end (no JAX
here): a legacy TF pickle of a 32px stock generator and D (drawn by
inverting the port's name tables) goes through the loop's dispatch, which
tells a network pickle from the port's own train state by
`zipfile.is_zipfile`, into a thin `fashion` run of one step: the run dir
takes JAX's `-resumecustom` suffix, ADA's horizon is 100 kimg, the stats
are finite and the transferred tensors are those the pickle holds."""

import io
import json
import os
import pickle
import sys
import types

import numpy as np
import torch

from pasta_gan_tpu_torch.cli import train as cli_train
from pasta_gan_tpu_torch.io import tf_legacy
from pasta_gan_tpu_torch.models.generator_stock import GeneratorStock
from pasta_gan_tpu_torch.nn.discriminator import Discriminator

from test_torch_train_loop import THIN, one_torch_thread  # noqa: F401  (autouse fixture)

RES, W_DIM, CHANNEL_BASE, CHANNEL_MAX = 32, 512, 256, 32


class _Network:
    """Pickled under dnnlib.tflib.network.Network, as a TF export is."""


def _tf_variables(names_for, state_dict, rng):
    out = {}
    for key, leaf in state_dict.items():
        name, kind = names_for(tuple(key.split(".")))
        shape = tuple(leaf.shape)
        if len(shape) == 4:
            shape = (shape[2], shape[3], shape[1], shape[0])  # OIHW -> TF [kh, kw, in, out]
        elif kind == "fcT":
            shape = shape[::-1]
        elif kind == "const":
            shape = (1,) + shape
        elif kind == "noise":
            shape = (1, 1) + shape
        out[name] = rng.normal(0, 0.1, shape).astype(np.float32)
    return out


def _tf_pickle():
    rng = np.random.default_rng(0)
    g_kw = dict(latent_size=W_DIM, label_size=0, dlatent_size=W_DIM, resolution=RES, mapping_layers=1,
                fmap_base=CHANNEL_BASE // 2, fmap_max=CHANNEL_MAX)
    gen = GeneratorStock(**tf_legacy.generator_kwargs_from_tf(tf_legacy.TFNetworkStub(version=4, static_kwargs=g_kw)))
    g_vars = _tf_variables(tf_legacy._tf_gen_name_for, gen.state_dict(), rng)
    g_vars["dlatent_avg"] = rng.normal(0, 1, (W_DIM,)).astype(np.float32)
    d_kw = dict(label_size=0, resolution=RES, fmap_base=CHANNEL_BASE // 2, fmap_max=CHANNEL_MAX, mbstd_group_size=2)
    disc = Discriminator(c_dim=0, img_resolution=RES, channel_base=CHANNEL_BASE, channel_max=CHANNEL_MAX)
    d_vars = _tf_variables(lambda p: (lambda n, t: (n, "fcT" if t else "plain"))(*tf_legacy._tf_name_for(p, RES)),
                           disc.state_dict(), rng)
    nets = []
    for kw, variables in ((g_kw, g_vars), (d_kw, d_vars), (g_kw, g_vars)):
        n = _Network()
        n.__dict__.update(version=4, static_kwargs=kw, variables=list(variables.items()), components={})
        nets.append(n)
    mod = types.ModuleType("dnnlib.tflib.network")
    mod.Network = _Network
    _Network.__module__ = "dnnlib.tflib.network"
    _Network.__qualname__ = _Network.__name__ = "Network"
    saved = {k: sys.modules.get(k) for k in ("dnnlib", "dnnlib.tflib", "dnnlib.tflib.network")}
    sys.modules.update({"dnnlib": types.ModuleType("dnnlib"), "dnnlib.tflib": types.ModuleType("dnnlib.tflib"),
                        "dnnlib.tflib.network": mod})
    try:
        return pickle.dumps(tuple(nets)), g_vars, d_vars
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def test_cli_train_one_step_from_a_tf_pickle(tmp_path, capsys):
    data, g_vars, d_vars = _tf_pickle()
    assert tf_legacy.load_tf_network_stubs(io.BytesIO(data)) is not None
    path = str(tmp_path / "source.pkl")
    with open(path, "wb") as f:
        f.write(data)
    out = cli_train.main(["--outdir", str(tmp_path / "runs"), "--kimg", "0.002", "--resume", path, *THIN])
    assert out["run_dir"].endswith("-synthetic-resumecustom")
    assert 'Transferred from "' in capsys.readouterr().out
    state, records = out["state"], out["records"]
    assert state.step == 1 and all(np.isfinite(v) for v in records[0].values())
    with open(os.path.join(out["run_dir"], "training_options.json")) as f:
        assert json.load(f)["ada"]["kimg"] == 100
    # the noise maps keep the pickle's values (buffers: copied, never trained); D's epilogue conv took a step
    ema = state.G_ema.state_dict()["synthesis.b32.conv1.noise_const"]  # a buffer: copied, never trained
    torch.testing.assert_close(ema, torch.from_numpy(g_vars["synthesis/noise6"][0, 0]), rtol=0, atol=0)
    assert not torch.equal(state.D.state_dict()["b4.conv.weight"],
                           torch.from_numpy(d_vars["4x4/Conv/weight"].transpose(3, 2, 0, 1).copy()))
