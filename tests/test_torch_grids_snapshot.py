"""The training snapshot grids (`train/loop.py:SnapshotGrids`) of the port vs
the JAX package on the CPU.

`SnapshotGrids` on a thin GeneratorFull whose weights and noise_const
buffers come from one JAX variable tree: the fakes grid's forward
(`noise_mode="const"`) against the JAX generator's on the same batch, and
the try-on grid's rows (swap lower / full / upper by thirds, each row
routed by the JAX `prepare_tryon_grid_batch` and run through the JAX
generator, as `pasta_gan_tpu/train/loop.py:238-262` does, jitted): rtol 1e-2 /
atol 1e-2, the finetune tolerance of tests/test_torch_generator.py; the
parsing grid's palette pixels equal wherever the JAX logits' top two lie
more than 1e-3 apart.
"""

import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from pasta_gan_tpu import utils as jutils
from pasta_gan_tpu.data import dataset as jds
from pasta_gan_tpu.models import GeneratorFull as JaxGeneratorFull
from pasta_gan_tpu_torch.data import dataset as tds
from pasta_gan_tpu_torch.io.from_jax import state_dict_from_jax
from pasta_gan_tpu_torch.models import GeneratorFull
from pasta_gan_tpu_torch.runtime.config import TrainConfig
from pasta_gan_tpu_torch.train import loop

from _torch_native import jax_native_oracle  # noqa: F401  (autouse fixture)
from test_torch_generator import _inputs, _jax_variables
from test_torch_train_loop import one_torch_thread  # noqa: F401  (autouse fixture)

SWAPS = ("lower", "full", "upper")


def test_snapshot_grids_match_jax(tmp_path, monkeypatch):
    cfg = dict(img_resolution=256, channel_base=512, channel_max=32)
    jgen = JaxGeneratorFull(**cfg)
    v = _jax_variables(jgen, _inputs(), seed=3)
    G = GeneratorFull(**cfg)
    G.load_state_dict(state_dict_from_jax(v, G.state_dict()), strict=True)
    assert float(G.synthesis.b256.conv1.noise_strength.detach()) != 0  # the const maps reach the images
    saved = {}

    def capture(images, path, **kw):
        saved[os.path.basename(path)] = (np.asarray(images), kw)

    monkeypatch.setattr(loop, "save_image_grid", capture)
    grids = loop.SnapshotGrids(str(tmp_path), tds.SyntheticUvitonDataset(num_samples=3, seed=2),
                               TrainConfig(batch_size=3), torch.device("cpu"))
    grids.save(G.eval(), "000000")
    assert (grids.grid_n, grids.gnum) == (3, 3)

    @jax.jit
    def fwd(b):  # the JAX loop's snapshot forward (pasta_gan_tpu/train/loop.py:207-214)
        _, ft, parsing = jgen.apply(v, None, b["style_input"], b["retain"], b["pose"], b["denorm_upper_img"],
                                    b["denorm_lower_img"], b["denorm_upper_mask"], b["denorm_lower_mask"],
                                    noise_mode="const", rngs={"noise": jax.random.PRNGKey(0)})
        return ft, parsing

    ft, parsing = fwd({k: jnp.asarray(t.numpy()) for k, t in grids.batch.items()})
    fakes, kw = saved["fakes000000.png"]
    assert kw == {}
    np.testing.assert_allclose(fakes, np.asarray(ft), rtol=1e-2, atol=1e-2)
    pal, kw = saved["parsing000000.png"]
    assert kw == {"drange": (0, 1)}
    top2 = np.sort(np.asarray(parsing), axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 1e-3
    assert sure.mean() > 0.99
    np.testing.assert_array_equal(pal[sure], jutils.parsing_to_rgb(np.asarray(parsing))[sure])

    # the try-on grid: person r (a row) wearing provider c's garments (a column)
    rows = []
    for r, swap in enumerate(SWAPS):  # gap = gnum // 3 = 1 row a third
        person = {k: np.repeat(a[r:r + 1], 3, axis=0) for k, a in grids.host.items()}
        garment = {k: a[:3] for k, a in grids.host.items()}
        rows.append(np.asarray(fwd(jds.prepare_tryon_grid_batch(person, garment, swap=swap))[0]))
    tryon, kw = saved["tryon_grid000000.png"]
    assert kw == {"grid_cols": 3}
    np.testing.assert_allclose(tryon, np.concatenate(rows, axis=0), rtol=1e-2, atol=1e-2)
