"""`pasta_gan_tpu_torch/utils` (EasyDict, Logger, assert_shape,
print_module_summary) and the encoders no generator builds (FeatureEncoder,
SpaceToDepth) against the JAX package.

* EasyDict and the Logger tee behave as the JAX package's copies (the Logger
  restores sys.stdout / sys.stderr on close);
* assert_shape accepts wildcards and raises on rank and size;
* print_module_summary's rows: a name, the parameters and buffers first
  counted there, the output shape and dtype for each submodule call up to
  `max_nesting`, and the totals;
* FeatureEncoder on weights carried from a JAX tree (the reference's names:
  `model.<i>`) against JAX's forward; SpaceToDepth against JAX's layout.
"""

import io
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pasta_gan_tpu import utils as jutils
from pasta_gan_tpu.nn.encoders import FeatureEncoder as JaxFeatureEncoder
from pasta_gan_tpu.nn.layers import SpaceToDepth as JaxSpaceToDepth
from pasta_gan_tpu_torch import utils
from pasta_gan_tpu_torch.io.from_jax import state_dict_from_jax
from pasta_gan_tpu_torch.nn.encoders import FeatureEncoder
from pasta_gan_tpu_torch.nn.layers import Conv2dLayer, SpaceToDepth

FWD_RTOL = 1e-5  # fp32 convs in two frameworks, relative L2


def test_easydict_matches_the_jax_copy():
    for cls in (utils.EasyDict, jutils.EasyDict):
        d = cls(a=1)
        d.b = 2
        assert d == {"a": 1, "b": 2} and d.a == 1 and d["b"] == 2
        del d.a
        assert "a" not in d
        with pytest.raises(AttributeError):
            d.missing


def test_logger_tees_and_restores(tmp_path, monkeypatch):
    out, err = io.StringIO(), io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    monkeypatch.setattr(sys, "stderr", err)
    path = tmp_path / "log.txt"
    with utils.Logger(str(path)) as log:
        assert sys.stdout is log and sys.stderr is log
        print("to stdout")
        print("to stderr", file=sys.stderr)
    assert sys.stdout is out and sys.stderr is err
    assert path.read_text() == "to stdout\nto stderr\n"
    # the JAX Logger writes both streams to the saved stdout, and so does the port's
    assert out.getvalue() == "to stdout\nto stderr\n" and err.getvalue() == ""
    log = utils.Logger(None)
    print("no file")
    log.close()
    assert sys.stdout is out and out.getvalue().endswith("no file\n")


def test_assert_shape():
    x = torch.zeros(2, 3, 4)
    utils.assert_shape(x, [2, None, 4])
    utils.assert_shape(x, [2, torch.tensor(3), 4])
    with pytest.raises(AssertionError, match="rank"):
        utils.assert_shape(x, [2, 3])
    with pytest.raises(AssertionError, match="dim 2"):
        utils.assert_shape(x, [None, 3, 5])


class _Two(torch.nn.Module):
    """A module with a buffer, a shared layer and a two-tensor output."""

    def __init__(self):
        super().__init__()
        self.conv = Conv2dLayer(3, 4, 3)
        self.head = torch.nn.Linear(4, 2)
        self.register_buffer("scale", torch.ones(4))

    def forward(self, x):
        y = self.conv(x) * self.scale[:, None, None]
        return y, self.head(y.mean(dim=(2, 3)))


def test_print_module_summary_rows(capsys):
    torch.manual_seed(0)
    m = _Two()
    x = torch.randn(2, 3, 8, 8)
    y, z = utils.print_module_summary(m, x)
    assert y.shape == (2, 4, 8, 8) and z.shape == (2, 2)
    rows = [line.split() for line in capsys.readouterr().out.splitlines() if line.strip()]
    assert rows[0] == ["_Two", "Parameters", "Buffers", "Output", "shape", "Datatype"]
    body = rows[2:-2]
    # the calls in the order they return; conv's non-persistent filter buffer counts as a buffer
    assert body == [
        ["conv", str(4 * 3 * 9 + 4), str(16), "[2,", "4,", "8,", "8]", "float32"],
        ["head", str(4 * 2 + 2), "-", "[2,", "2]", "float32"],
        ["<top-level>:0", "-", "4", "[2,", "4,", "8,", "8]", "float32"],
        ["<top-level>:1", "-", "-", "[2,", "2]", "float32"],
    ]
    assert rows[-1] == ["Total", str(4 * 3 * 9 + 4 + 10), str(16 + 4), "-", "-"]
    # max_nesting 0 keeps the top-level call alone, with everything it holds
    utils.print_module_summary(m, x, max_nesting=0)
    rows = [line.split() for line in capsys.readouterr().out.splitlines() if line.strip()]
    assert [r[0] for r in rows[2:-2]] == ["<top-level>:0", "<top-level>:1"]
    assert rows[2][1:3] == [str(4 * 3 * 9 + 4 + 10), str(16 + 4)]


def _carry_feature_encoder(params):
    """A JAX FeatureEncoder's params -> the port's state_dict (`stem`, `down<i>`
    -> `model.0`, `model.<i + 1>`: the pose encoder's translation)."""
    sd = state_dict_from_jax({"params": {"const_encoding": params}})
    return {k[len("const_encoding."):]: v for k, v in sd.items()}


@pytest.mark.parametrize("n_down", [3, 7])
def test_feature_encoder_matches_jax(n_down):
    ngf, res = 8, 2 ** (n_down + 1)
    jm = JaxFeatureEncoder(6, ngf=ngf, n_downsampling=n_down)
    rng = np.random.default_rng(n_down)
    x = rng.standard_normal((2, res, res, 6)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    params = jax.tree_util.tree_map(lambda s: (rng.standard_normal(s.shape) * 0.5).astype(np.float32), shapes)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    port = FeatureEncoder(6, ngf=ngf, n_downsampling=n_down)
    sd = _carry_feature_encoder(params)
    assert set(sd) == set(port.state_dict()) == (
        {f"model.{i}.{p}" for i in range(n_down + 1) for p in ("weight", "bias")})
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape == (2, 2, 2, ngf * 8 if n_down > 3 else ngf * 4)
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < FWD_RTOL


@pytest.mark.parametrize("block", [2, 4])
def test_space_to_depth_matches_jax(block):
    x = np.random.default_rng(block).standard_normal((2, 8, 12, 3)).astype(np.float32)
    ref = np.asarray(JaxSpaceToDepth(block_size=block).apply({}, jnp.asarray(x)))
    m = SpaceToDepth(block)
    assert not list(m.state_dict())
    out = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(out, ref)
