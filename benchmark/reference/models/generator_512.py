"""The 512x320 generators (counterpart of `pasta_gan_tpu/models/generator_512.py`).

`Generator512`, the released 512 checkpoint's interface: the Full wiring at
512.  The synthesis pyramid starts at 8 (`start_res=8`, so the const encoder
downsamples min(6, log2(res) - 3) times, 512 -> 8x8), merges the retain
features above 32 (`merge_min_res=32`) and keeps the Full variant's parsing
head, SPADE refinement and texture finetune block; the style encoder takes
the 45-channel stack of `prepare_tryon_batch_512` (the 10 upper parts and
the 5 lower parts {0, 6..9}, 3 channels each) and has no extra
convolutions.  The sub-callables and `forward` are GeneratorFull's, NHWC,
returning (img, finetune_img, pred_parsing).
"""

from __future__ import annotations

from .generator_full import GeneratorFull


class Generator512(GeneratorFull):
    variant = "512"  # what a snapshot records; the synthesis is the Full variant
    start_res, merge_min_res, style_extra_convs = 8, 32, 0

    def __init__(self, img_resolution: int = 512, channel_base: int = 32768, style_input_nc: int = 45, **kwargs):
        super().__init__(img_resolution=img_resolution, channel_base=channel_base, style_input_nc=style_input_nc,
                         **kwargs)
