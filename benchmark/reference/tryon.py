"""The try-on forward of the serving CLIs (a copy of the port's
`cli/test.py:tryon_forward`): style, pose, mapping and synthesis calls."""

from __future__ import annotations

import torch

from .models.generator_full import cat_feats_dict


@torch.no_grad()
def tryon_forward(gen, w_avg, batch, truncation_psi: float = 1.0, noise_mode: str = "none") -> torch.Tensor:
    """The finetune image [B, H, W, 3] (NHWC) of the try-on `batch`."""
    stylecode, feats = gen.encode_style(batch["style_input"], batch["retain"])
    pose_feat = gen.encode_pose(batch["pose"])
    ws, _ = gen.map_ws(None, stylecode, w_avg=w_avg, truncation_psi=truncation_psi)
    return gen.synthesize(
        ws, pose_feat, cat_feats_dict(feats),
        batch["denorm_upper_img"], batch["denorm_lower_img"],
        batch["denorm_upper_mask"], batch["denorm_lower_mask"],
        noise_mode=noise_mode,
    )[1]
