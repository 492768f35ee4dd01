"""Transfer-learning resume (pasta_gan_tpu_torch/io/transfer.py, the resume
dispatch of train/loop.py and cli/train.py) against the JAX package's, on
the CPU.

A tiny port TrainState and a tiny JAX one hold the same weights
(tests/test_torch_train.py's `make_pair`, with noise on so that the
`noise_const` buffers transfer too).  Each package transfers from the same
pickle; afterwards G, G_ema and D equal JAX's trees carried across by
`io/from_jax.py` exactly, w_avg equals, both copy and shape-skip the same
names, and the step, pl_mean, the ADA counters and the Adam states stay
fresh.  D's `b4.fc.weight` is held to JAX's matrix before the carrier's
NHWC -> NCHW permutation (tests/test_torch_tf_legacy.py says why).

* A legacy TF pickle (tests/test_torch_tf_legacy.py's stubs) at the
  state's widths and at a narrower `channel_max`.
* A reference-style snapshot: a pickle of {"G_ema": a port GeneratorFull at
  another `channel_max`, with a `mapping.w_avg` buffer, "D": a port D}.
* One `train_step` after the transfer is finite.
* The CLI: a preset that is not in the `open_url` cache exits naming it
  (HOME at tmp_path); one placed in the cache resolves; `noresume` proceeds;
  the run-dir suffixes.  (A `cli.train --resume <TF pickle>` run:
  tests/test_torch_transfer_cli.py; the port's own train-state-*.pt through
  the same dispatch: tests/test_torch_train_loop.py.)
"""

import copy
import dataclasses
import hashlib
import json
import pickle

import numpy as np
import pytest
import torch

from pasta_gan_tpu.io import transfer as jtransfer
from pasta_gan_tpu_torch.cli import train as cli_train
from pasta_gan_tpu_torch.io import transfer as ttransfer
from pasta_gan_tpu_torch.io.from_jax import discriminator_state_dict_from_jax, port_key, state_dict_from_jax
from pasta_gan_tpu_torch.models import GeneratorFull

from test_torch_tf_legacy import tf_discriminator_stub, tf_generator_stub, tf_pickle
from test_torch_train import jax_tiny_config, make_pair
from test_torch_train_loop import one_torch_thread  # noqa: F401  (autouse fixture)


def tf_network_pickle(res, w_dim, mapping_layers, channel_base, channel_max):
    """A legacy TF (G, D, Gs) pickle: a skip stock generator and a resnet D
    without labels, of that geometry, drawn by inverting JAX's name tables;
    returns (bytes, the D's TF variables)."""
    g = tf_generator_stub("skip", res=res, w_dim=w_dim, mapping_layers=mapping_layers, channel_base=channel_base,
                          channel_max=channel_max)
    d, _ = tf_discriminator_stub("resnet", seed=3, res=res, c_dim=0, channel_base=channel_base,
                                 channel_max=channel_max)
    return tf_pickle(g, d), dict(d["variables"])


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_tiny_config()
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, use_noise=True),
                               loss=dataclasses.replace(jcfg.loss, vgg_weight=0.0))
    return make_pair(jcfg)


def _jax_names(paths):
    """JAX dotted leaf paths ("params.synthesis.b8.conv0.weight") -> port state_dict keys."""
    return sorted(port_key(tuple(p.split(".")[1:]))[0] for p in paths)


def _check_equal_to_jax(jnew, pnew, d_copied):
    for name, tree in (("G", jnew.g_params), ("G_ema", jnew.g_ema_params)):
        got = getattr(pnew, name).state_dict()
        want = state_dict_from_jax(tree, got)
        for k, v in want.items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=f"{name} {k}")
    got = pnew.D.state_dict()
    want = discriminator_state_dict_from_jax(jnew.d_params, got)
    if "b4.fc.weight" in d_copied:
        want["b4.fc.weight"] = state_dict_from_jax(jnew.d_params)["b4.fc.weight"]
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=f"D {k}")
    np.testing.assert_array_equal(pnew.w_avg.numpy(), np.asarray(jnew.w_avg))


def _check_fresh(p, before):
    assert p.step == 0 and float(p.pl_mean) == 0.0 and float(p.ada_p) == float(before.ada_p)
    assert float(p.ada_signs_sum) == 0.0 and float(p.ada_signs_count) == 0.0
    assert not p.g_opt.state and not p.d_opt.state


@pytest.mark.parametrize("tf_channel_max", [32, 16])
def test_transfer_from_tf_pickle_equals_jax(pair, tmp_path, tf_channel_max, capsys):
    jt, jstate, pt, pstate, _, b_t = pair
    m = jt.config.model
    data, d_vars = tf_network_pickle(m.img_resolution, m.w_dim, m.mapping_layers, m.channel_base, tf_channel_max)
    path = str(tmp_path / "tf.pkl")
    with open(path, "wb") as f:
        f.write(data)

    jg_src, jd_src, _ = jtransfer._tf_source_trees(path)
    _, jg_copied, jg_mismatched = jtransfer.copy_matching_leaves(jstate.g_params, jg_src)
    _, jd_copied, jd_mismatched = jtransfer.copy_matching_leaves(jstate.d_params, jd_src)
    g_sd, d_sd, _ = ttransfer._tf_sources(path)
    _, g_copied, g_mismatched = ttransfer.copy_matching(pstate.G.state_dict(), g_sd)
    _, d_copied, d_mismatched = ttransfer.copy_matching(pstate.D.state_dict(), d_sd)
    assert sorted(g_copied) == _jax_names(jg_copied) and sorted(g_mismatched) == _jax_names(jg_mismatched)
    assert sorted(d_copied) == _jax_names(jd_copied) and sorted(d_mismatched) == _jax_names(jd_mismatched)
    assert "synthesis.b8.conv1.noise_const" in g_copied and "b4.out.weight" in d_mismatched
    assert ("synthesis.b8.conv1.weight" in g_copied) == (tf_channel_max == 32)

    jnew = jtransfer.transfer_from_network_pickle(jstate, path, verbose=False)
    pnew = ttransfer.transfer_from_network_pickle(copy.deepcopy(pstate), path, verbose=True)
    assert (f"G {len(g_copied)} leaves ({len(g_mismatched)} shape-skipped), D {len(d_copied)} leaves "
            f"({len(d_mismatched)} shape-skipped)") in capsys.readouterr().out
    _check_equal_to_jax(jnew, pnew, d_copied)
    assert not torch.equal(pnew.w_avg, pstate.w_avg)
    torch.testing.assert_close(pnew.D.state_dict()["b16.conv0.weight"],
                               torch.from_numpy(d_vars["16x16/Conv0/weight"].transpose(3, 2, 0, 1).copy()))
    _check_fresh(pnew, pstate)

    state, stats = pt.train_step(pnew, b_t)
    assert state.step == 1 and all(np.isfinite(float(v)) for v in stats.values())


def test_transfer_from_reference_snapshot_equals_jax(pair, tmp_path):
    jt, jstate, pt, pstate, _, _ = pair
    m = jt.config.model
    g = GeneratorFull(img_resolution=m.img_resolution, channel_base=m.channel_base, channel_max=16,
                      mapping_layers=m.mapping_layers, use_noise=True).reset_parameters(torch.Generator().manual_seed(7))
    g.mapping.register_buffer("w_avg", torch.randn(512, generator=torch.Generator().manual_seed(8)))
    d = copy.deepcopy(pstate.D).reset_parameters(torch.Generator().manual_seed(9))
    path = str(tmp_path / "network-snapshot.pkl")
    with open(path, "wb") as f:
        pickle.dump({"G_ema": g, "D": d, "augment_pipe": None}, f)

    g_sd = ttransfer.state_dict_from_reference_pickle(path, "G_ema")
    assert "mapping.w_avg" in g_sd and ttransfer.state_dict_from_reference_pickle(path, "G") == {}
    _, g_copied, g_mismatched = ttransfer.copy_matching(pstate.G.state_dict(), g_sd)
    _, j_copied, j_mismatched = jtransfer.copy_matching_leaves(
        jstate.g_params, jtransfer.convert_reference_partial(g_sd, jstate.g_params))
    assert sorted(g_copied) == _jax_names(j_copied) and j_mismatched == []
    assert "synthesis.b16.conv1.weight" in g_copied and "synthesis.b4.const" not in g_copied
    assert sorted(g_mismatched) == sorted(set(pstate.G.state_dict()) & set(g_sd) - set(g_copied))

    jnew = jtransfer.transfer_from_network_pickle(jstate, path, verbose=False)
    pnew = ttransfer.transfer_from_network_pickle(copy.deepcopy(pstate), path, verbose=False)
    _check_equal_to_jax(jnew, pnew, set(d.state_dict()))
    torch.testing.assert_close(pnew.w_avg, g.mapping.w_avg, rtol=0, atol=0)
    for k, v in d.state_dict().items():
        torch.testing.assert_close(pnew.D.state_dict()[k], v, rtol=0, atol=0, msg=k)
    _check_fresh(pnew, pstate)

    with open(path, "wb") as f:
        f.write(b"ctorch_utils.persistence\n_reconstruct_persistent_obj\n.")  # what a reference snapshot names
    with pytest.raises(ModuleNotFoundError, match="import hooks"):
        ttransfer.state_dict_from_reference_pickle(path)
    tf_path = str(tmp_path / "tf.pkl")
    with open(tf_path, "wb") as f:
        f.write(tf_pickle(*[dict(version=4, static_kwargs={}, variables=[], components={})] * 2))
    with pytest.raises(ValueError, match="legacy TensorFlow"):
        ttransfer.state_dict_from_reference_pickle(tf_path)


def test_cli_resume_presets_and_run_dirs(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HOME", str(tmp_path))  # an empty open_url cache; nothing is fetched
    argv = ["--outdir", str(tmp_path / "runs"), "--synthetic", "4", "--dry-run"]
    with pytest.raises(SystemExit, match="ffhq256"):
        cli_train.main(argv + ["--resume", "ffhq256"])
    url = cli_train.RESUME_SPECS["ffhq256"]
    cache = tmp_path / ".cache" / "pasta_gan_tpu"
    cache.mkdir(parents=True)
    placed = cache / f"{hashlib.md5(url.encode()).hexdigest()}_ffhq-res256-mirror-paper256-noaug.pkl"
    placed.write_bytes(b"placed")
    assert cli_train.resolve_resume("ffhq256") == (str(placed), "-resumeffhq256")
    capsys.readouterr()
    cli_train.main(argv + ["--resume", "ffhq256"])
    assert json.loads(capsys.readouterr().out.split("Resolved training config:\n")[1].split("\n\nDry run")[0])[
        "ada"]["kimg"] == 100
    cli_train.main(argv + ["--resume", "noresume"])
    assert json.loads(capsys.readouterr().out.split("Resolved training config:\n")[1].split("\n\nDry run")[0])[
        "ada"]["kimg"] != 100
    assert cli_train.resolve_resume("noresume") == (None, "-noresume")
    assert cli_train.resolve_resume(None) == (None, "")
    assert cli_train.resolve_resume(str(placed)) == (str(placed), "-resumecustom")
    state_file = tmp_path / "train-state-latest.pt"
    torch.save({"state": {}}, state_file)
    assert cli_train.resolve_resume(str(state_file)) == (str(state_file), "")
    with pytest.raises(SystemExit, match="no such file"):
        cli_train.resolve_resume(str(tmp_path / "missing.pkl"))
