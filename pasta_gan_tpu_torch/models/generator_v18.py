"""GeneratorV18, the released 256x192 checkpoint's interface (counterpart of
`pasta_gan_tpu/models/generator_v18.py`).

Differences from GeneratorFull: the last style block's ToRGB predicts upper
and lower sigmoid masks instead of a 6-class parsing map (synthesis variant
"v18"), the style encoder takes a 60-channel stack (the 10 norm image
patches and the 10 norm stickman patches, `data/dataset.py:prepare_tryon_batch_v18`),
and `synthesize` / `forward` return the 4-tuple
(img, finetune_img, upper_mask, lower_mask), NHWC.
"""

from __future__ import annotations

from .generator_full import GeneratorFull, nhwc, nchw


class GeneratorV18(GeneratorFull):
    variant = synthesis_variant = "v18"

    def __init__(self, style_input_nc: int = 60, **kwargs):
        super().__init__(style_input_nc=style_input_nc, **kwargs)

    def synthesize(self, ws, pose_feat, cat_feats, denorm_upper_input, denorm_lower_input,
                   denorm_upper_mask, denorm_lower_mask, noise_mode="random", generator=None):
        img, finetune_img, (upper_mask, lower_mask) = self.synthesis(
            ws, pose_feat, cat_feats, nchw(denorm_upper_input), nchw(denorm_lower_input),
            nchw(denorm_upper_mask), nchw(denorm_lower_mask), noise_mode=noise_mode,
            generator=generator,
        )
        return nhwc(img), nhwc(finetune_img), nhwc(upper_mask), nhwc(lower_mask)
