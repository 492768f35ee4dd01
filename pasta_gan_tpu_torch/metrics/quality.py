"""The training-quality yardstick of `scripts/quality_regression.py` and
`scripts/eval_run_snapshots.py` (the JAX package's tools), for the port's
`cli/quality_regression.py` and `cli/eval_run_snapshots.py`.

* `eval_batches`: the fixed synthetic evaluation set, `SyntheticUvitonDataset`
  samples collated and routed by `prepare_train_batch` a batch at a time, the
  batch at offset i with its erasure drawn from a CPU generator seeded i (the
  JAX tools key it `PRNGKey(i)`).
* `eval_forward`: the tools' forward, the generator's finetune image with
  the fixed noise maps (`noise_mode="const"`) and no truncation.
* `quality_metrics`: fid_proxy (the FID formula over an extractor's
  features, NOT comparable to reference FID), recon L1 and PSNR of fakes
  against reals, with the JAX scripts' host arithmetic: uint8 images by
  truncation, `np.cov(rowvar=False)`, `fid_from_stats`, PSNR at a peak of 2.

By default the extractor is `extractors.jax_simpleconv`, the JAX
`SimpleConvFeatures(seed=0)`'s weights, so the numbers read on the JAX
records' scale.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .formulas import fid_from_stats


def eval_batches(samples: int, batch: int, seed: int = 123, res: int = 256, device="cuda") -> List[Dict]:
    """The `samples` synthetic samples of `seed` as train-step batches of
    `batch` (the last one shorter where `batch` does not divide `samples`)."""
    from ..data.dataset import SyntheticUvitonDataset, collate, prepare_train_batch

    ds = SyntheticUvitonDataset(num_samples=samples, resolution=res, seed=seed)
    return [prepare_train_batch(collate([ds[k] for k in range(i, min(i + batch, samples))]),
                                torch.Generator().manual_seed(i), device=device)
            for i in range(0, samples, batch)]


@torch.no_grad()
def eval_forward(gen, batch) -> torch.Tensor:
    """The finetune image [B, H, W, 3] of one train-step batch, noise const."""
    return gen(None, batch["style_input"], batch["retain"], batch["pose"], batch["denorm_upper_img"],
               batch["denorm_lower_img"], batch["denorm_upper_mask"], batch["denorm_lower_mask"],
               noise_mode="const")[1]


def generate(gen, batches) -> np.ndarray:
    """`eval_forward` over every batch, as one float32 host array."""
    return np.concatenate([eval_forward(gen, b).float().cpu().numpy() for b in batches])


def reals_of(batches) -> np.ndarray:
    return np.concatenate([b["real_img"].cpu().numpy() for b in batches])


def to_u8(x: np.ndarray) -> np.ndarray:
    """[-1, 1] -> uint8, truncating (the JAX scripts' `astype(np.uint8)`)."""
    return np.clip((x + 1) * 127.5, 0, 255).astype(np.uint8)


def feature_stats(images: np.ndarray, extractor):
    """(mean, covariance) of the extractor's features of [-1, 1] images."""
    f = extractor(to_u8(images))
    f = f.cpu().numpy() if torch.is_tensor(f) else np.asarray(f)
    return f.mean(0), np.cov(f, rowvar=False)


def fid_proxy(fakes: np.ndarray, reals: np.ndarray, extractor) -> float:
    return float(fid_from_stats(*feature_stats(reals, extractor), *feature_stats(fakes, extractor)))


def quality_metrics(fakes: np.ndarray, reals: np.ndarray, extractor) -> Dict[str, float]:
    """{fid_proxy, recon_l1, psnr_db} of fakes against reals (NHWC, [-1, 1]), unrounded."""
    l1 = float(np.mean(np.abs(fakes - reals)))
    mse = float(np.mean((fakes - reals) ** 2))
    return {"fid_proxy": fid_proxy(fakes, reals, extractor), "recon_l1": l1,
            "psnr_db": float(10.0 * np.log10(4.0 / max(mse, 1e-12)))}  # drange [-1, 1]: peak 2
