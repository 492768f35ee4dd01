#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`pasta_gan_tpu_torch`) on one NVIDIA GPU.

  python3 chip_smoke.py    # needs one NVIDIA GPU; the last line is the JSON verdict

Phases, each fatal on failure:
1. Build the six kernels from `pasta_gan_tpu_torch/csrc/` with nvcc (one
   process per source, all started together).
2. Kernel phase.  The routing kernels at the try-on paths' batch-16 shapes
   (norm_warp and composite on the Full route; norm_warp at 8 channels,
   composite at the fused shape and denorm_warp, constant border, on the
   released-256 route, plus a smaller replicate-border denorm_warp case),
   norm_warp also at the training step's batch 32 (self route) and the Full
   route's batch 1, each norm_warp case bit-exact and beside a memset of
   its output, and
   the routing kernels at the 512 route's batch-8 shapes from the fixture's
   512x320 pairs (norm_warp N 15, n0 10, 128x128 patches; composite 15
   parts, 2 groups, all eroded, no hands; denorm_warp [8,15,4,512,512]),
   each bit-exact, and
   the FIR kernels at the training path's largest shapes (up2 pre-FIR
   [16,128,128,128], down2 [32,64,256,256]), up2 at the serving path's most
   launched up-conv shapes and D's backward, down2 at every class of the
   training step, and up2 and down2 at every class one batch-8 forward of
   the full-width Generator512 gives them (counted in that forward), each
   against its plain PyTorch version on the card (fp32
   with TF32 off, and bf16), with times from CUDA events (L2 flushed before
   each launch; mean and median of 20; through the Python wrapper and
   through the C entry point alone), the byte/operation
   bound and a one-call library yardstick (`grid_sample`, depthwise
   `conv_transpose2d` / `conv2d`); the FIR kernels also check their adjoint
   identity.
3. Full serving phase: a full-width GeneratorFull (channel_base 16384,
   channel_max 512, 256px) drawn from a seeded generator is saved as a
   snapshot and served through `pasta_gan_tpu_torch.cli.test.main` for 16
   synthetic pairs on the fused denorm route.  Then the card's result is
   held against the port's CPU path on a small input, the bf16 forward
   against the fp32 one at batch 16, and the end-to-end try-on (routing +
   bf16 forward) is timed at batch 16 and 1, each step also under
   `torch.profiler` (device ms, busy share, device operations, top ones).
4. Released-256 (V18) serving phase: a full-width GeneratorV18 snapshot is
   served through `cli.test.main --generator v18` for 16 synthetic pairs,
   once with `--denorm fused` (composite launches, denorm_warp does not) and
   once with `--denorm separate` (denorm_warp launches, composite does not).
   The two routes' batches are held against each other on the card, the
   card's routing and a thin V18 forward against the CPU path, and the
   end-to-end V18 try-on is timed and profiled on both routes at batch 16
   and 1.
5. 512x320 serving phase (`serving_512`): a full-width Generator512
   snapshot (channel_base 32768, channel_max 512, start 8) is served through
   `cli.test_512.main --dataroot` on the fixture's 8 test pairs for each
   `--change_region`, on `--denorm fused` and `separate` (8 triptychs of
   512x960 a run).  The two routes' batches are held against each other on
   the card for every region, the card's routing and a thin Generator512
   forward against the CPU path, the bf16 forward against the fp32 one at
   batch 8, and the end-to-end try-on is timed and profiled at batch 8 and
   1.
6. Training phase: `pasta_gan_tpu_torch.cli.train.main` trains the
   full-width `fashion` G and D (random init from seed 0, He-initialized
   VGG19) for 4 steps at batch 32 in bf16, R1 on the first, on 64 synthetic
   samples, with the image grids every tick (`--img_snap 1`); losses must be
   finite, G, D and G_ema must move, every grid PNG must decode at its
   shape.  It prints the Gmain+Dmain and R1 step times, sec/kimg, peak
   memory and a `torch.profiler` breakdown of one step.
7. ADA training phase (`training_ada`): the same run with `--aug ada --p 0.5`
   (the `bgc` pipe, the two-pass warp, stacked D calls, R1 through the
   pipe); besides the checks of phase 6, `Progress/augment_p` must follow
   the controller's arithmetic.  It prints the same times and profile, the
   pipe's own time per call (Dmain's 96 stacked images forward, Gmain's 64
   forward and backward, R1's 32), and then runs three steps with
   `--ada_exact_geom` (D calls one by one), printing their time and peak
   memory, or that they do not fit.
8. Card against CPU: one fp32 training step (Gmain, Dmain, R1) at a thin
   width is held against the same step on the port's CPU path, without ADA,
   with the debug-percentile `bgc` pipe and with random draws (the pipe
   draws on the host, so one seed gives both sides the same draws), and
   with style mixing (z_dim 8) and the contextual loss, then one Greg step;
   `contextual_loss` on one relu1_2-sized pair ([1, 256, 256, 64]) on the
   card against the CPU.
9. Real-data phase (`real_data`, on the committed fixture tree
   tests/fixtures/upt_mini, whose MANIFEST.json holds the digests of PIL's
   decoded arrays and of the JAX package's `load_sample`, neither of which
   this machine has): every file decoded and every record loaded by the
   port must match its digest; host ms a sample of JPEG and PNG decoding,
   keypoints + stickman, masks and `load_sample`, and `InfiniteLoader` at
   batch 32 with 1 and 3 worker processes; `cli.test --dataroot` serves the
   fixture's 16 test pairs with the Full snapshot of phase 3
   (`serving_real`, PNGs named by the JAX rule) and the try-on is timed at
   batch 16 with the host loading inside the timed call and with the batch
   loaded beforehand; `cli.train --data --workers 3 --aug noaug` trains 4
   full-width steps at batch 32 (`training_real`), one tick a step,
   `--snap 2` (a snapshot is saved at step 3 and at the end) and no image
   grids (`--img_snap 0`, so no grid save gives the loader slack), printing
   `Timing/data` beside Gmain+Dmain for each step.
10. Metrics phase (`metrics`): `cli.calc_metrics` over the Full snapshot of
   phase 3 with random-weight InceptionV3 and VGG16/LPIPS detector files:
   FID, KID, PR and IS over 64 synthetic pairs at batch 32
   (`metrics_network`), FID of `serving_real`'s PNGs against the fixture's
   images with `--resolution 256` (`metrics_folder`, no kernel), ppl2_wend
   over 64 samples with the LPIPS distance (`metrics_ppl`), every value
   finite; each path launches its kernels exactly as often as its batches
   give.  InceptionV3 and VGG16 features and the LPIPS distance on the card
   against the CPU, and FID from the card's features against FID from the
   CPU's; the detectors' rates beside their FLOP bounds, the network
   source's images/s (synthetic and `--dataroot` pairs), the host formulas'
   times, a projected fid50k_full wall time and peak memory.
11. int8 serving phase (`int8_serving`, after the 512 serving phase, on
   the Full, V18 and 512 snapshots): `cli.test --quant int8_static
   --calib_batches 2` and `--quant int8` (Full, 16 synthetic pairs),
   `--generator v18 --quant int8_static`, and `cli.test_512 --quant
   int8_static` (fullbody, the fixture's 8 pairs, fused route); the
   int8_conv launches of one batch-16 Full int8_static forward and one
   batch-8 Generator512 forward (bf16) counted by class, every class held to
   its plain version at max abs error 0 and timed through its wrapper and
   its C entry point beside its bound (int8 operations at 1979 TOP/s, or
   bytes), the plain version, im2col + `torch._int_mm` (`library_ms`) and
   the bf16 cuDNN conv of the same geometry; int8 and int8_static against
   the fp32 forward (batch 16); end-to-end timing and profiles (Full in both
   modes at batch 16 and 1, 512 int8_static at batch 8 and 1) and peak
   memory; the card against the CPU (int8_static, full width, batch 2, fp32,
   the card's calibrated scales) within twice the forward's own move under
   a 1e-6 relative input change (measured on the card).
12. Regularized training phase (`training_reg`, after the ADA phase):
   `cli.train --aug noaug --pl_weight 2 --contextual_weight 1` at full width
   for 5 steps at batch 32, Greg (path-length regularization, the synthesis
   network's double backward, on 16 samples) at steps 0 and 4, R1 at step 0,
   no grids; Greg's stats finite, pl_mean moved, G, D and G_ema moved.  It
   prints Gmain+Dmain with the contextual loss, Greg and R1 times, the
   contextual loss's device ms (one Gmain profiled with and without it), the
   relu1_2 affinity term's time against its matmul bound, one Greg step's
   launches and peak memory, and every (kernel, extend or pad, dtype, shape)
   class of up2 and down2 that Greg launches, each held to its plain
   version.
13. Conditional metrics phase (`metrics_conditional`, after the metrics
   phase): the fixture's UPT_subset1_256_192 test images laid flat with their
   parsing maps and OpenPose files beside them (the one whose file lists no
   person left out) through `cli.calc_metrics --conditional` against
   `serving_real`'s PNGs on the random InceptionV3; every item must carry its
   part images and pose heatmap; the host ms of one `PartsFolderDataset` item.
14. Transfer-learning phase (`training_transfer`): a legacy TF (G, D, Gs)
   pickle of the ffhq256 resume preset's geometry (256px, 512-d z and w, 8
   mapping layers, fmap_base 8192, a resnet D with minibatch-std groups of 8;
   weights from seed 0, written through this script's own inverse of the
   reference's TF name tables) placed in an `open_url` cache under a
   temporary HOME, then `cli.train --resume ffhq256 --aug noaug` at full
   width for 3 steps at batch 32: before the first step every transferred
   tensor is on the card and equals the pickle's value after the layout
   move, w_avg is the pickle's `dlatent_avg`; then losses finite and G, D and
   G_ema moved.  It prints the leaves copied and shape-skipped and the
   Gmain+Dmain time.
15. Stock generator, skip D and plain 512 phases (`stock_forward`, `d_skip`,
   `plain_512`): the same pickle's Gs through `generator_stock_from_tf` onto
   the card, its forward at batch 16 in bf16 and fp32 timed and profiled,
   against the CPU at batch 2; a full-width `architecture="skip"` D at batch
   32 (bf16) timed, its fp32 logits against the CPU's; Generator512Plain at
   the released-512 widths at batch 8 (bf16) timed, a thin one against the
   CPU; every up2/down2 class these forwards launch held to its plain
   version at max abs error 0.
16. Zoo phase (`zoo`): each of the 20 classes of the generator zoo and the
   ablations (`models.ZOO`) built through `models.build_model` at its
   defaults (channel_base 16384, channel_max 512, 256x256; seeded weights),
   its parameter count, one bf16 forward at batch 8 on random inputs of its
   shapes (binary masks) with its launch counts set to 0 just before it
   (`zoo_<class>`, up2 and down2 as `ZOO` predicts them), its outputs finite
   and of their documented shapes, every up2/down2 class of that forward
   equal to its plain version; the card against the CPU at a thin width
   (channel_base 1024, channel_max 32; PatchDenormCat 16384 and 128; batch 2,
   fp32, noise const), each
   gating mask head's threshold placed in a gap of its logits first and the
   binarised masks equal; V14, V17, V21 and NoCoarse timed (images/s, host
   and device ms, busy share, bf16 against fp32).  It prints its seconds.
Each path's launch counts are set to 0 just before it runs and read just
after; each path must launch exactly its kernels (`PATH_KERNELS`).  The
training phase also counts down2's launches by (pad, dtype, input shape) in
one Gmain+Dmain and one R1 step.  Every number printed is tagged with the
card's name and power limit.  The `kernels` line gives each kernel's
launches per path and their sum, its time through its C entry point alone
(`ms`, the kernel's own) and through its Python wrapper (`wrapper_ms`,
which also holds the wrapper's host path).
"""

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
TOL = 5e-5  # routing tolerance (atol)
NEAR = 1e-5  # pixels whose plain mask value lies this close to the threshold are not compared
FIR_F32_TOL = 1e-6  # the FIR kernels repeat the plain version's rounded operations in its order
BF16_REL = 2.0 ** -7  # 2 ulp of bf16
TRAIN_STEPS, TRAIN_BATCH = 4, 32
# training_reg: Greg every 4 steps (g_reg_interval) from the first, so 5 steps run it twice; R1 on the first
REG_STEPS = 5
REG_ARGV = ["--aug", "noaug", "--pl_weight", "2", "--contextual_weight", "1"]
ADA_P = 0.5  # the training_ada path's initial augment probability: about half the draws transform
# card vs CPU training step (tests/test_torch_train.py's tolerances)
LOSS_RTOL, GRAD_REL_L2, STEP_REL_L2 = 1e-4, 1e-3, 1e-2
REPLACES = {"norm_warp": "pasta_gan_tpu/ops/pallas_warp.py:172",
            "composite": "pasta_gan_tpu/ops/pallas_warp.py:480",
            "denorm_warp": "pasta_gan_tpu/ops/pallas_warp.py:78",
            "up2": "pasta_gan_tpu/ops/pallas_upfirdn.py:60",
            "down2": "pasta_gan_tpu/ops/pallas_upfirdn.py:134",
            # not a Pallas kernel: XLA's s8 x s8 -> s32 conv_general_dilated in int8_conv_like
            "int8_conv": "pasta_gan_tpu/ops/quant.py:131"}
# bf16 vs fp32 forward, ||bf16 - fp32|| / ||fp32|| of the finetune image.  bf16
# keeps 8 mantissa bits (2^-8 = 0.4 % per rounding); with this script's
# snapshot init at channel_base 512 on the CPU a correct bf16 path gives 0.031,
# and a bf16-only fault that clamps the demodulation coefficients gives 2.07.
BF16_REL_L2 = 0.1
# the kernels each driven path launches (and no other)
FUSED = {"norm_warp", "composite", "up2", "down2"}
SEPARATE = {"norm_warp", "denorm_warp", "up2", "down2"}
# int8 serving: the int8 conv, the float up-convs below 32 rows and the skips' upsample (up2); the down-convs
# run int8 after a plain FIR (no down2)
INT8 = {"norm_warp", "composite", "up2", "int8_conv"}
PATH_KERNELS = {"serving_full": FUSED, "serving_v18_fused": FUSED, "serving_v18_separate": SEPARATE,
                "serving_512_fused": FUSED, "serving_512_separate": SEPARATE, "training": FUSED,
                "training_ada": FUSED, "training_reg": FUSED, "serving_real": FUSED, "training_real": FUSED,
                "metrics_network": FUSED, "metrics_folder": set(), "metrics_ppl": FUSED,
                "serving_int8_static": INT8, "serving_int8": INT8, "serving_v18_int8_static": INT8,
                "serving_512_int8_static": INT8, "training_transfer": FUSED,
                # the stock generator's up-convs and image skips; the skip D's image pyramid; Generator512Plain's
                # up-convs and image skips (no SPADE encoder, so no 1x1 down-conv); the conditional reals
                "stock_forward": {"up2"}, "d_skip": {"down2"}, "plain_512": {"up2"}, "metrics_conditional": set()}
FIXTURE = os.path.join("tests", "fixtures", "upt_mini")  # the UPT-layout fixture tree, relative to this script
# the metrics phase: calc_metrics over the Full snapshot; a GeneratorFull forward launches up2 14 times and
# down2 once (the serving path's counts), and calc_metric draws the generated source anew for each metric
METRICS_NETWORK = ["fid50k_full", "kid50k_full", "pr50k3_full", "is50k"]
METRICS_SYNTHETIC, METRICS_BATCH, PPL_SYNTHETIC, PPL_SAMPLES = 64, 32, 16, 64
FORWARD_UP2, FORWARD_DOWN2 = 14, 1
# card vs CPU limits of the detectors: the JAX package's oracle tests' (max abs / max |ref|; LPIPS rtol)
INCEPTION_REL, VGG16_REL, LPIPS_RTOL, FID_RTOL = 2e-4, 3e-4, 1e-4, 1e-3
PR_PROTOCOL = (200000, 50000)  # pr50k3_full's real and generated feature counts


def card_tag():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_time_ms(torch, fn, iters=20, warmup=3):
    """(mean, median) device ms of fn() over `iters` launches, CUDA events
    around each launch; a 256 MB write before each one evicts the 50 MB L2,
    as the main path finds it cold."""
    scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        scratch.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return sum(times) / iters, statistics.median(times)


def kernel_times(torch, run, plain, library=None, plain_iters=20):
    """The timing keys of a kernel's result: its mean and median ms, the plain
    version's mean and, where one call computes the same function, that
    call's mean and median."""
    ms, ms_median = cuda_time_ms(torch, run)
    lib, lib_median = cuda_time_ms(torch, library) if library is not None else (None, None)
    return dict(ms=ms, ms_median=ms_median, plain_ms=cuda_time_ms(torch, plain, iters=plain_iters)[0],
                library_ms=lib, library_median=lib_median)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def sector_bytes(torch, total_bytes, byte_offsets):
    """Bytes of the distinct 32-byte sectors (the card's unit of DRAM access)
    that `byte_offsets` fall in, within a buffer of `total_bytes`."""
    occupied = torch.zeros(-(-total_bytes // 32), dtype=torch.bool, device=byte_offsets.device)
    occupied[byte_offsets // 32] = True
    return 32 * int(occupied.sum())


def norm_source_bytes(torch, r):
    """Bytes of the two NHWC source frames that the norm warp must read for
    this run's matrices: the sectors holding a bilinear tap of nonzero weight
    of a valid part (replicate border, as `norm_warp_reference` samples)."""
    from pasta_gan_tpu_torch.ops.warp_math import warp_coords

    src = r["src_u"]
    B, H, W, C = src.shape
    N = r["minv_norm"].shape[1]
    sx, sy = warp_coords(r["minv_norm"], r["patch_hw"])  # [B, N, h, w]
    sx, sy = sx.clamp(0.0, W - 1), sy.clamp(0.0, H - 1)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    xi, yi = x0.long(), y0.long()
    xj, yj = (xi + 1).clamp(max=W - 1), (yi + 1).clamp(max=H - 1)
    # frame f = source * B + b of a virtual [2, B, H, W] stack of pixels
    part_src = (torch.arange(N, device=src.device) >= r["n_upper"]).long()
    frame = (part_src[None, :] * B + torch.arange(B, device=src.device)[:, None])[..., None, None]
    live = (r["valid_norm"] != 0)[..., None, None].expand_as(sx)
    offs = []
    for yy, xx, keep in ((yi, xi, live), (yi, xj, live & (sx > x0)), (yj, xi, live & (sy > y0)),
                         (yj, xj, live & (sx > x0) & (sy > y0))):
        offs.append((((frame * H + yy) * W + xx) * C * 4)[keep])
    return sector_bytes(torch, 2 * nbytes(src), torch.cat(offs))


def frame_taps(torch, minv, valid, patch_hw, frame_hw):
    """The bilinear taps (constant-zero border) of every frame pixel of every
    part, as [(flat patch index, keep)] for the 4 taps; keep marks a tap of
    nonzero weight inside the patch, at a pixel that a valid part reaches."""
    from pasta_gan_tpu_torch.ops.warp_math import warp_coords

    Hs, Ws = patch_hw
    sx, sy = warp_coords(minv, frame_hw)  # [B, N, H, W]
    live = (valid != 0)[..., None, None] & (sx > -1) & (sx < Ws) & (sy > -1) & (sy < Hs)
    sx, sy = sx.clamp(-1.0, float(Ws)), sy.clamp(-1.0, float(Hs))
    x0, y0 = torch.floor(sx), torch.floor(sy)
    xi, yi = x0.long(), y0.long()
    taps = []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yy, xx = yi + dy, xi + dx
        keep = live & (yy >= 0) & (yy < Hs) & (xx >= 0) & (xx < Ws)
        if dx:
            keep &= sx > x0
        if dy:
            keep &= sy > y0
        taps.append((yy * Ws + xx, keep))
    return taps


def composite_patch_bytes(torch, wk, patches, minv, valid, frame_hw, groups, erode_parts):
    """Bytes of the planar patches [B, N, 4, h, w] that the composite must
    read for this run's data: the mask channel's taps of nonzero weight at
    every frame pixel each valid part reaches, and the image channels' taps
    only where the part is the last saturated one of its group (the pixel it
    leaves in the output)."""
    B, N, C, Hs, Ws = patches.shape
    sat = wk.denorm_warp_reference(patches, minv, valid, frame_hw)[:, :, 3] >= wk.MASK_SATURATION_THRESHOLD
    ero = [p for p in range(N) if erode_parts[p]]
    sat = sat.float()
    sat[:, ero] = wk.erode_binary(sat[:, ero])
    sat = (sat > 0) & (valid != 0)[..., None, None]
    winner = torch.zeros_like(sat)
    covered = [torch.zeros_like(sat[:, 0]) for _ in range(max(groups) + 1)]
    for p in reversed(range(N)):
        winner[:, p] = sat[:, p] & ~covered[groups[p]]
        covered[groups[p]] |= sat[:, p]

    bp = (torch.arange(B, device=patches.device)[:, None] * N + torch.arange(N, device=patches.device))[..., None, None]
    offs = []
    for pix, keep in frame_taps(torch, minv, valid, (Hs, Ws), frame_hw):
        offs.append((((bp * C + 3) * Hs * Ws + pix) * 4)[keep])
        for c in range(3):
            offs.append((((bp * C + c) * Hs * Ws + pix) * 4)[keep & winner])
    return sector_bytes(torch, nbytes(patches), torch.cat(offs))


def denorm_patch_bytes(torch, patches, minv, valid, frame_hw):
    """Bytes of the planar patches [B, N, C, h, w] that denorm_warp (constant
    border) must read for this run's data: every channel's taps of nonzero
    weight at every frame pixel each valid part reaches."""
    B, N, C, Hs, Ws = patches.shape
    bp = (torch.arange(B, device=patches.device)[:, None] * N + torch.arange(N, device=patches.device))[..., None, None]
    offs = []
    for pix, keep in frame_taps(torch, minv, valid, (Hs, Ws), frame_hw):
        for c in range(C):
            offs.append((((bp * C + c) * Hs * Ws + pix) * 4)[keep])
    return sector_bytes(torch, nbytes(patches), torch.cat(offs))


def near_threshold_pixels(torch, wk, srcs, minv, valid, frame_hw, erode_parts):
    """[B, H, W] bool: pixels where a kernel/plain rounding difference could
    flip a saturation decision (plain mask value within NEAR of the threshold,
    dilated by the 5x5 erosion for eroded parts)."""
    F = torch.nn.functional
    m = wk.denorm_warp_reference(srcs, minv, valid, frame_hw)[:, :, 3]
    near = ((m - wk.MASK_SATURATION_THRESHOLD).abs() <= NEAR).float()
    ero = [p for p, e in enumerate(erode_parts) if e]
    near[:, ero] = F.max_pool2d(near[:, ero], 5, stride=1, padding=2)
    return near.amax(dim=1) > 0


def composite_entry(torch, ck, cargs):
    """The composite kernel through its C entry point alone, into preallocated
    outputs: (launch, (group planes, hand masks)).  For a kernel of a few tens
    of microseconds the wrapper's host path sits inside the CUDA events."""
    from pasta_gan_tpu_torch.ops.warp_kernels import MASK_SATURATION_THRESHOLD

    srcs, minv, valid, (H, W), groups, erode, hands = cargs
    B, N, _, Hs, Ws = srcs.shape
    n_groups = max(groups) + 1
    g_out = torch.empty((B, n_groups, 3, H, W), device=srcs.device)
    h_out = torch.empty((B, len(hands), H, W), device=srcs.device)
    bits = [sum(1 << p for p in range(N) if f(p)) for f in (lambda p: groups[p] == 1, lambda p: erode[p],
                                                            lambda p: p in hands)]
    stream = ck.stream_of(srcs.device)

    def launch():
        ck.COMPOSITE.launch(srcs.data_ptr(), minv.data_ptr(), valid.data_ptr(), g_out.data_ptr(),
                            h_out.data_ptr() if hands else None, B, N, Hs, Ws, H, W, n_groups, *bits, len(hands),
                            MASK_SATURATION_THRESHOLD, stream)
    return launch, (g_out, h_out)


def norm_warp_entry(torch, ck, args):
    """The norm_warp kernel through its C entry point alone: (launch, output)."""
    src0, src1, minv, valid, n0, (h, w) = args
    B, H, W, C = src0.shape
    N = minv.shape[1]
    out = torch.empty((B, N, C, h, w), device=src0.device)
    stream = ck.stream_of(src0.device)

    def launch():
        ck.NORM_WARP.launch(src0.data_ptr(), src1.data_ptr(), minv.data_ptr(), valid.data_ptr(), out.data_ptr(),
                            B, N, n0, H, W, h, w, C, stream)
    return launch, out


def denorm_warp_entry(torch, ck, dargs, border="constant"):
    """The denorm_warp kernel through its C entry point alone: (launch, output)."""
    srcs, minv, valid, (H, W) = dargs
    B, N, C, Hs, Ws = srcs.shape
    out = torch.empty((B, N, C, H, W), device=srcs.device)
    stream = ck.stream_of(srcs.device)

    def launch():
        ck.DENORM_WARP.launch(srcs.data_ptr(), minv.data_ptr(), valid.data_ptr(), out.data_ptr(), B, N, C, Hs, Ws,
                              H, W, int(border == "replicate"), stream)
    return launch, out


def entry_times(torch, launch, outputs, expected):
    """Launch once, hold the outputs equal to the wrapper's, then time: the
    `entry_ms` and `entry_median` keys of a kernel's result."""
    launch()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(outputs, expected)), "the C entry point differs from its wrapper"
    ms, median = cuda_time_ms(torch, launch)
    return dict(entry_ms=ms, entry_median=median)


def composite_skip_share(wk, cargs):
    """Share of the valid (part, strip) pairs the composite kernel skips (a
    warp's strip of 2 x 32 pixels)."""
    srcs, minv, valid, frame_hw = cargs[:4]
    live = wk.composite_live_tiles(minv, valid, frame_hw, srcs.shape[-2:])
    return 1.0 - float(live.float().sum()) / float(valid.sum() * live.shape[2] * live.shape[3])


def norm_warp_case(torch, wk, ck, r, label, tag, plain_iters=20):
    """norm_warp on one route's operands `r`: bit-exact against its plain
    version, timed through its wrapper and through its C entry point beside a
    memset of the same output and the `grid_sample` yardstick (one call per
    source frame), with the byte bound of the source sectors its taps need.
    Returns (result, the plain version's patches)."""
    from pasta_gan_tpu_torch.ops.warp_math import warp_coords

    F = torch.nn.functional
    args = (r["src_u"], r["src_l"], r["minv_norm"], r["valid_norm"], r["n_upper"], r["patch_hw"])
    assert bool(torch.isfinite(r["minv_norm"]).all()), "non-finite routing matrices"
    out_k = wk.norm_warp(*args)
    out_p = wk.norm_warp_reference(*args)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    assert err == 0, f"norm_warp ({label}) differs from its plain version: {err}"
    B, N, C, h, w = out_k.shape
    H, W = r["src_u"].shape[1:3]
    n0 = r["n_upper"]
    # grid_sample yardstick: one call per source frame, explicit pixel coordinates
    sx, sy = warp_coords(r["minv_norm"], (h, w))  # [B, N, h, w]
    grid = torch.stack([sx / (W - 1) * 2 - 1, sy / (H - 1) * 2 - 1], dim=-1)
    g_u = grid[:, :n0].reshape(B, n0 * h, w, 2).contiguous()
    g_l = grid[:, n0:].reshape(B, (N - n0) * h, w, 2).contiguous()
    nchw_u = r["src_u"].permute(0, 3, 1, 2).contiguous()
    nchw_l = r["src_l"].permute(0, 3, 1, 2).contiguous()

    def library():
        F.grid_sample(nchw_u, g_u, mode="bilinear", padding_mode="border", align_corners=True)
        F.grid_sample(nchw_l, g_l, mode="bilinear", padding_mode="border", align_corners=True)

    ref = F.grid_sample(nchw_u, g_u, mode="bilinear", padding_mode="border", align_corners=True)
    lib_err = float((ref.reshape(B, C, n0, h, w).transpose(1, 2) * r["valid_norm"][:, :n0, None, None, None]
                     - out_p[:, :n0]).abs().max())
    del ref, grid
    src_bytes = norm_source_bytes(torch, r)
    launch, out_e = norm_warp_entry(torch, ck, args)
    et = entry_times(torch, launch, (out_e,), (out_k,))
    memset, memset_median = cuda_time_ms(torch, out_e.zero_)
    res = dict(
        err=err, **kernel_times(torch, lambda: wk.norm_warp(*args), lambda: wk.norm_warp_reference(*args), library,
                                plain_iters=plain_iters),
        **et, bytes=src_bytes + nbytes(r["minv_norm"], r["valid_norm"], out_k),
        ops=B * N * h * w * (12 + 10 * C),  # ~12 flops of coordinates + C channels x 9 of blend + gate
        extra=(f"entry ms {et['entry_ms']:.4f} (median {et['entry_median']:.4f}); memset of the output "
               f"{memset:.4f} (median {memset_median:.4f}); source sectors read {src_bytes / 1e6:.2f} of "
               f"{nbytes(r['src_u'], r['src_l']) / 1e6:.2f} MB; grid_sample max |diff| vs plain {lib_err:.3g}"),
    )
    report_kernel(f"norm_warp({label}, {list(out_k.shape)})", res, tag)
    return res, out_p


def kernel_phase(torch, wk, tag):
    from pasta_gan_tpu_torch.data.dataset import SyntheticUvitonDataset, collate, tryon_warp_inputs
    from pasta_gan_tpu_torch.data.warp import self_warp_inputs
    from pasta_gan_tpu_torch.ops import cuda_kernels as ck

    B = 16
    ds = SyntheticUvitonDataset(num_samples=B)
    person = collate([ds[i] for i in range(B)])
    garment = collate([ds[(i + 1) % B] for i in range(B)])
    r = tryon_warp_inputs(person, garment, device="cuda")
    results = {}

    # ---- norm_warp at the Full route's batch 16, the training step's batch 32
    # (self route, as prepare_train_batch feeds it) and the Full route's batch 1
    results["norm_warp"], out_p = norm_warp_case(torch, wk, ck, r, "Full b16", tag)
    train = collate([SyntheticUvitonDataset(num_samples=64, seed=0)[i] for i in range(32)])
    image = torch.as_tensor(train["image"], device="cuda").float() / 255.0
    um, lm = (torch.as_tensor(train[k], device="cuda").float() for k in ("upper_mask", "lower_mask"))
    norm_warp_case(torch, wk, ck, self_warp_inputs(image * um, image * lm, um, lm,
                                                   torch.as_tensor(train["keypoints"], device="cuda").float()),
                   "training b32", tag, plain_iters=5)
    del train, image, um, lm
    norm_warp_case(torch, wk, ck, tryon_warp_inputs(collate([ds[0]]), collate([ds[1]]), device="cuda"), "Full b1", tag)
    # ---- composite (fed the plain norm output, so both sides see the same patches)
    results["composite"] = composite_case(torch, wk, ck, out_p, r, f"Full b16, {list(out_p.shape)}", tag)
    return results


def composite_case(torch, wk, ck, srcs, r, label, tag, plain_iters=20):
    """composite on a route's operands `r` and planar patches `srcs`: against
    its plain version (pixels a near-threshold plain mask value could flip
    left out, and counted), timed through its wrapper and its C entry point,
    with the byte bound of the patch sectors this run's data needs.  Returns
    the result."""
    cargs = (srcs, r["minv_denorm"], r["valid_denorm"], r["frame_hw"], r["groups"], r["erode_parts"],
             r["hand_parts"])
    minv, valid, frame_hw, N = cargs[1], cargs[2], cargs[3], srcs.shape[1]
    g_k, h_k = wk.composite(*cargs)
    g_p, h_p = wk.composite_reference(*cargs)
    torch.cuda.synchronize()
    assert h_k.shape == h_p.shape == (srcs.shape[0], len(r["hand_parts"])) + tuple(frame_hw)
    keep = ~near_threshold_pixels(torch, wk, srcs, minv, valid, frame_hw, r["erode_parts"])
    err = max(float(((g_k - g_p).abs() * keep[:, None, None]).max()),
              float(((h_k - h_p).abs() * keep[:, None]).max()) if h_k.numel() else 0.0)
    assert err <= TOL, f"composite ({label}) disagrees with its plain version: {err}"
    H, W = frame_hw
    n_ero = int(sum(r["erode_parts"][p] * valid[:, p].sum().item() for p in range(N)))
    patch_bytes = composite_patch_bytes(torch, wk, srcs, minv, valid, frame_hw, r["groups"], r["erode_parts"])
    # per valid (sample, part): coordinates + mask blend (~21 flops) per frame pixel,
    # a 5x5 min (~8 flops) per pixel of eroded parts, and the 3-channel blend where saturated
    sat_px = int((wk.denorm_warp_reference(srcs, minv, valid, frame_hw)[:, :, 3] >= wk.MASK_SATURATION_THRESHOLD).sum())
    ops = int(valid.sum()) * H * W * 21 + n_ero * H * W * 8 + sat_px * 27
    launch, outs_e = composite_entry(torch, ck, cargs)
    et = entry_times(torch, launch, outs_e, (g_k, h_k))
    res = dict(err=err, **kernel_times(torch, lambda: wk.composite(*cargs), lambda: wk.composite_reference(*cargs),
                                       plain_iters=plain_iters),
               **et, bytes=patch_bytes + nbytes(minv, valid, g_k, h_k), ops=ops,
               extra=(f"entry ms {et['entry_ms']:.4f} (median {et['entry_median']:.4f}); patch sectors read "
                      f"{patch_bytes / 1e6:.2f} of {nbytes(srcs) / 1e6:.2f} MB; {int((~keep).sum())} near-threshold "
                      f"pixels not compared; {composite_skip_share(wk, cargs):.3f} of the valid (part, strip) pairs "
                      "skipped"))
    report_kernel(f"composite({label} -> {list(g_k.shape)})", res, tag)
    return res


def denorm_warp_case(torch, wk, ck, srcs, r, tag, plain_iters=5):
    """denorm_warp, constant border, on a route's planar patches `srcs`:
    against its plain version, timed through its wrapper and its C entry
    point beside the `grid_sample` yardstick (one call over the B*N patches),
    with the byte bound of the patch sectors its taps need.  Returns the result."""
    from pasta_gan_tpu_torch.ops.warp_math import warp_coords

    F = torch.nn.functional
    minv, valid, frame_hw = r["minv_denorm"], r["valid_denorm"], r["frame_hw"]
    dargs = (srcs, minv, valid, frame_hw)
    dn_k = wk.denorm_warp(*dargs)
    dn_p = wk.denorm_warp_reference(*dargs)
    torch.cuda.synchronize()
    err = float((dn_k - dn_p).abs().max())
    assert err <= TOL, f"denorm_warp disagrees with its plain version: {err}"
    B, N, C, Hs, Ws = srcs.shape
    H, W = frame_hw
    # grid_sample yardstick: one call over the B*N patches, the grid built outside the timed call
    sx, sy = warp_coords(minv, frame_hw)
    grid = torch.stack([sx / (Ws - 1) * 2 - 1, sy / (Hs - 1) * 2 - 1], dim=-1).reshape(B * N, H, W, 2).contiguous()
    flat = srcs.reshape(B * N, C, Hs, Ws)

    def library():
        return F.grid_sample(flat, grid, mode="bilinear", padding_mode="zeros", align_corners=True)

    lib_err = float((library().reshape(B, N, C, H, W) * valid[:, :, None, None, None] - dn_p).abs().max())
    patch_bytes = denorm_patch_bytes(torch, srcs, minv, valid, frame_hw)
    inside = int(sum(k.sum() for _, k in frame_taps(torch, minv, valid, (Hs, Ws), frame_hw)[:1]))
    # ~12 flops of coordinates per pixel of a valid part, ~10 per channel where it samples
    ops = int(valid.sum()) * H * W * 12 + inside * C * 10
    del dn_p
    launch, out_e = denorm_warp_entry(torch, ck, dargs)
    et = entry_times(torch, launch, (out_e,), (dn_k,))
    del out_e
    res = dict(err=err, **kernel_times(torch, lambda: wk.denorm_warp(*dargs),
                                       lambda: wk.denorm_warp_reference(*dargs), library, plain_iters=plain_iters),
               **et, bytes=patch_bytes + nbytes(minv, valid, dn_k), ops=ops,
               extra=(f"entry ms {et['entry_ms']:.4f} (median {et['entry_median']:.4f}); "
                      f"patch sectors read {patch_bytes / 1e6:.2f} of {nbytes(srcs) / 1e6:.2f} MB, "
                      f"{nbytes(dn_k) / 1e6:.1f} MB written; grid_sample max |diff| vs plain {lib_err:.3g}"))
    report_kernel(f"denorm_warp(constant, {list(srcs.shape)} -> {list(dn_k.shape)})", res, tag)
    return res


def v18_kernel_phase(torch, wk, tag):
    """The released-256 route's kernels at batch 16 from synthetic pairs:
    norm_warp at 8 channels, composite at the fused route's shape (timed
    through its C entry point too), and denorm_warp with the constant border (the
    separate route's first pass) with its `grid_sample` yardstick; then a
    smaller replicate-border denorm_warp case.  Returns {"denorm_warp": ...}."""
    from pasta_gan_tpu_torch.data.dataset import SyntheticUvitonDataset, collate, tryon_warp_inputs_v18
    from pasta_gan_tpu_torch.ops import cuda_kernels as ck

    B = 16
    ds = SyntheticUvitonDataset(num_samples=B)
    r = tryon_warp_inputs_v18(collate([ds[i] for i in range(B)]), collate([ds[(i + 1) % B] for i in range(B)]),
                              device="cuda")
    assert bool(torch.isfinite(r["minv_norm"]).all()) and bool(torch.isfinite(r["minv_denorm"]).all())

    # ---- norm_warp at C = 8 (image, mask, stickman, pad)
    _, out_p = norm_warp_case(torch, wk, ck, r, "V18 b16, C=8", tag, plain_iters=5)

    # ---- composite at the fused route's shape (10 parts, 2 groups, no hands)
    srcs = out_p[:, :, 0:4].contiguous()
    composite_case(torch, wk, ck, srcs, r, f"V18 fused, {list(srcs.shape)}", tag, plain_iters=5)
    # ---- denorm_warp, constant border, on the route's image + mask patches
    res = denorm_warp_case(torch, wk, ck, srcs, r, tag)
    minv, valid, frame_hw = r["minv_denorm"], r["valid_denorm"], r["frame_hw"]
    H, W = frame_hw

    # ---- denorm_warp, replicate border, two samples
    rargs = (srcs[:2].contiguous(), minv[:2].contiguous(), valid[:2].contiguous(), frame_hw)
    rk = wk.denorm_warp(*rargs, "replicate")
    rp = wk.denorm_warp_reference(*rargs, "replicate")
    torch.cuda.synchronize()
    rerr = float((rk - rp).abs().max())
    assert rerr <= TOL, f"denorm_warp (replicate) disagrees with its plain version: {rerr}"
    rres = dict(err=rerr, **kernel_times(torch, lambda: wk.denorm_warp(*rargs, "replicate"),
                                         lambda: wk.denorm_warp_reference(*rargs, "replicate"), plain_iters=5),
                bytes=nbytes(rargs[0], rargs[1], rargs[2], rk), ops=rk.numel() * 10 + 12 * H * W * 20,
                extra="every pixel samples the clamped patch; bound counts the whole patches")
    report_kernel(f"denorm_warp(replicate, {list(rargs[0].shape)} -> {list(rk.shape)})", rres, tag)
    return {"denorm_warp": res}


def kernel_512_phase(torch, wk, tag):
    """The 512 route's kernels at batch 8 on the fixture's 512x320 pairs
    (fullbody): norm_warp with N = 15 parts, n0 = 10, 128x128 patches from
    512x512 frames; composite with 15 parts, 2 groups, every mask eroded and
    no hand parts; denorm_warp (constant border) [8,15,4,128,128] ->
    [8,15,4,512,512], the separate route's first pass.  Each must equal its
    plain version bit for bit.  Then up2 and down2 at every (extend or pad,
    dtype, input shape) that one bf16 forward of the full-width Generator512
    (the serving phase's snapshot weights) gives them at batch 8, each held
    to its plain version as the 256 cases are (`fir_case`)."""
    from pasta_gan_tpu_torch.cli import test as cli
    from pasta_gan_tpu_torch.data import dataset as tds
    from pasta_gan_tpu_torch.models import Generator512
    from pasta_gan_tpu_torch.ops import cuda_kernels as ck

    person, garment = fixture_512_batch(tds, 8)
    gen = Generator512().reset_parameters(torch.Generator().manual_seed(0)).cuda().set_dtype(torch.bfloat16)
    b = tds.prepare_tryon_batch_512(on_card(torch, person), on_card(torch, garment), "fullbody", device="cuda")
    with torch.no_grad():
        classes = fir_classes(torch, lambda: cli.tryon_forward(gen, torch.zeros(512, device="cuda"),
                                                                 {k: v.to(torch.bfloat16) for k, v in b.items()}))
    del gen, b
    torch.cuda.empty_cache()
    print(f"Generator512 forward (batch 8, bf16): {sum(classes.values())} FIR launches in "
          f"{len(classes)} classes: " + ", ".join(f"{k}: {n}" for k, n in sorted(classes.items())) + f" [{tag}]",
          flush=True)
    r = tds.warp_inputs_512_batch(person, garment, "fullbody", device="cuda")
    assert r["minv_norm"].shape[1] == 15 and r["n_upper"] == 10 and r["hand_parts"] == () and all(r["erode_parts"])
    res = {}
    res["norm_warp"], out_p = norm_warp_case(torch, wk, ck, r, "512 b8, N=15, n0=10", tag, plain_iters=5)
    res["composite"] = composite_case(torch, wk, ck, out_p, r, f"512 fullbody b8, {list(out_p.shape)}", tag,
                                      plain_iters=3)
    res["denorm_warp"] = denorm_warp_case(torch, wk, ck, out_p, r, tag, plain_iters=3)
    bad = {k: v["err"] for k, v in res.items() if v["err"] != 0}
    assert not bad, f"a kernel differs from its plain version at the 512 shapes: {bad}"
    g = torch.Generator(device="cuda").manual_seed(0)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    for kind, arg, dt, shape in sorted(classes):
        res[(kind, arg, dt, shape)] = fir_case(torch, g, kind, arg, dtypes[dt], shape, tag)
    assert {k[0] for k in classes} == {"up2", "down2"}, f"the 512 forward launched FIR kernels {sorted(classes)}"
    return res


def report_kernel(label, res, tag):
    """Add the bound (bytes over 3.35 TB/s or fp32 operations over 67 TFLOP/s,
    the larger) to `res` and print the kernel's line."""
    res["bound_ms"] = max(res["bytes"] / PEAK_BYTES_PER_S, res["ops"] / PEAK_FP32_FLOPS) * 1e3
    res["bound_by"] = "bytes" if res["bytes"] / PEAK_BYTES_PER_S >= res["ops"] / PEAK_FP32_FLOPS else "operations"
    lib = "null" if res["library_ms"] is None else f"{res['library_ms']:.4f} (median {res['library_median']:.4f})"
    print(f"kernel {label}: max_abs_err={res['err']:.3g} kernel_ms={res['ms']:.4f} (median {res['ms_median']:.4f}) "
          f"plain_ms={res['plain_ms']:.4f} bound_ms={res['bound_ms']:.4f} ({res['bound_by']}) "
          f"library_ms={lib}; {res['extra']} [{tag}]", flush=True)


# the main path's case of each FIR kernel, the one the `kernels` line reports
FIR_MAIN = {("up2", 1, "bfloat16", (16, 128, 128, 128)): "up2", ("down2", 1, "bfloat16", (32, 64, 256, 256)): "down2"}


def fir_kernel_phase(torch, tag):
    """up2 (extend 0 and 1) at the pre-FIR shape [16,128,128,128] and down2
    (pad 1 and 0) at the D skip's [32,64,256,256], fp32 and bf16, then up2 in
    bf16 at every other up-conv shape of the serving path (extend 1,
    [16,256,64,64] down to [16,512,4,4], whose 10-wide rows take the
    short-row kernel) and at D's backward through its skip (extend 0,
    [32,64,128,128]), and down2 at the training step's other classes (bf16:
    D's skip down to [32,512,8,8] and at [64,64,256,256], G's backward
    through the up-convs down to [32,512,10,10]; fp32: 3-channel images
    [32,3,r,r], r = 256 ... 8): the kernel against its plain version on the card, the
    adjoint identity, times, the byte bound and the depthwise cuDNN call
    that computes the same function.  Each case is also timed through the C
    entry point alone into a preallocated output (`entry`): for a kernel of
    a few microseconds the wrapper's host path sits inside the CUDA events.
    Returns the results of the main path's cases (FIR_MAIN) under "up2" and
    "down2"."""
    g = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    specs = [("up2", e, dt, (16, 128, 128, 128)) for e in (1, 0) for dt in (torch.bfloat16, torch.float32)]
    specs += [("down2", p, dt, (32, 64, 256 + 2 * (1 - p), 256 + 2 * (1 - p)))
              for p in (1, 0) for dt in (torch.bfloat16, torch.float32)]
    specs += [("up2", 1, torch.bfloat16, (16, 256, 64, 64))]
    specs += [("up2", 1, torch.bfloat16, (16, 512, s, s)) for s in (32, 16, 8, 4)]
    specs += [("up2", 0, torch.bfloat16, (32, 64, 128, 128))]
    # down2 at the training step's other classes: D's skip at r = 128 ... 8
    # (pad 1, [32, c, r, r]) and G's backward through each up-conv pre-FIR
    # (pad 0 on rows of 2r + 2, r = 128 ... 4), c = min(16384 / r, 512)
    specs += [("down2", 1, torch.bfloat16, (32, min(16384 // r, 512), r, r)) for r in (128, 64, 32, 16, 8)]
    specs += [("down2", 0, torch.bfloat16, (32, min(16384 // r, 512), 2 * r + 2, 2 * r + 2))
              for r in (128, 64, 32, 16, 8, 4)]
    # ... D's skip over real and fake together, and the fp32 image pyramid of 3-channel images
    specs += [("down2", 1, torch.bfloat16, (64, 64, 256, 256))]
    specs += [("down2", 1, torch.float32, (32, 3, r, r)) for r in (256, 128, 64, 32, 16, 8)]
    for kind, arg, dt, shape in specs:
        res = fir_case(torch, g, kind, arg, dt, shape, tag)
        main = FIR_MAIN.get((kind, arg, str(dt)[6:], shape))
        if main:
            results[main] = res
    return results


def fir_check(torch, g, kind, arg, dt, shape):
    """up2 (`arg` extend) or down2 (`arg` pad) through its wrapper on an input
    of `shape` drawn from `g`, against its plain version on the card: fp32
    within FIR_F32_TOL, bf16 within 2 ulp.  Returns (x, y, plain y, max abs
    error)."""
    from pasta_gan_tpu_torch.ops import upfirdn_kernels as uk

    x = torch.randn(shape, generator=g, device="cuda").to(dt)
    if kind == "up2":
        y, yp = uk.up2(x, extend=arg), uk.up2_reference(x, arg)
    else:
        y, yp = uk.down2(x, pad=arg), uk.down2_reference(x, arg)
    torch.cuda.synchronize()
    assert y.shape == yp.shape and y.dtype == dt, (kind, y.shape, yp.shape)
    err = float((y.float() - yp.float()).abs().max())
    if dt == torch.float32:
        assert err <= FIR_F32_TOL, f"{kind} fp32 disagrees with its plain version: {err}"
    else:
        assert torch.allclose(y.float(), yp.float(), rtol=BF16_REL, atol=1e-6), \
            f"{kind} bf16 disagrees with its plain version beyond 2 ulp: {err}"
    return x, y, yp, err


def fir_case(torch, g, kind, arg, dt, shape, tag):
    """One FIR kernel case on an input of `shape` drawn from `g`: up2 (`arg`
    extend) or down2 (`arg` pad) against its plain version on the card (fp32
    within FIR_F32_TOL, bf16 within 2 ulp), the adjoint identity, the C
    entry point alone equal to the wrapper, times, the byte bound and the
    depthwise cuDNN call that computes the same function.  Prints the case's
    line and returns its result."""
    from pasta_gan_tpu_torch.ops import cuda_kernels as ck
    from pasta_gan_tpu_torch.ops import upfirdn_kernels as uk

    F = torch.nn.functional
    taps = torch.tensor([1.0, 3.0, 3.0, 1.0], device="cuda") / 8.0
    filt = torch.outer(taps, taps)
    x, y, yp, err = fir_check(torch, g, kind, arg, dt, shape)
    C = shape[1]
    if kind == "up2":
        run = lambda: uk.up2(x, extend=arg)  # noqa: E731
        plain = lambda: uk.up2_reference(x, arg)  # noqa: E731
        w = (filt * 4.0).to(dt).expand(C, 1, 4, 4).contiguous()
        library = lambda: F.conv_transpose2d(x, w, stride=2, padding=1 - arg, groups=C)  # noqa: E731
        adjoint = lambda gr: uk.down2(gr, pad=1 - arg, gain=4.0)  # noqa: E731
        flops_per_out = 10
    else:
        run = lambda: uk.down2(x, pad=arg)  # noqa: E731
        plain = lambda: uk.down2_reference(x, arg)  # noqa: E731
        w = filt.to(dt).expand(C, 1, 4, 4).contiguous()
        library = lambda: F.conv2d(x, w, stride=2, padding=arg, groups=C)  # noqa: E731
        adjoint = lambda gr: uk.up2(gr, extend=1 - arg, gain=0.25)  # noqa: E731
        flops_per_out = 36
    yl = library()
    assert yl.shape == y.shape, (kind, y.shape, yl.shape)
    lib_err = float((yl.float() - yp.float()).abs().max())
    gr = torch.randn(y.shape, generator=g, device="cuda").to(dt)
    # <y, g> = <x, adjoint(g)>, the difference over ||y|| ||g|| (bf16 keeps 8 bits)
    lhs = float((y.double() * gr.double()).sum())
    rhs = float((x.double() * adjoint(gr).double()).sum())
    adj = abs(lhs - rhs) / float(y.double().norm() * gr.double().norm())
    assert adj <= (1e-6 if dt == torch.float32 else 1e-3), f"{kind} adjoint identity off by {adj}"
    del yp, yl, gr
    ye = torch.empty_like(y)
    entry = lambda: (ck.UP2 if kind == "up2" else ck.DOWN2).launch(  # noqa: E731
        x.data_ptr(), ye.data_ptr(), int(dt == torch.bfloat16), shape[0] * C, shape[2], shape[3], arg, 1.0,
        ck.stream_of(x.device))
    entry()
    torch.cuda.synchronize()
    assert torch.equal(ye, y), f"{kind} through its C entry point differs from its wrapper"
    entry_ms, entry_median = cuda_time_ms(torch, entry)
    label = f"{kind}({'extend' if kind == 'up2' else 'pad'}={arg}, {str(dt)[6:]}, {list(shape)})"
    res = dict(err=err, **kernel_times(torch, run, plain, library, plain_iters=5), bytes=nbytes(x, y),
               entry_ms=entry_ms, entry_median=entry_median,
               ops=y.numel() * flops_per_out,
               extra=f"entry ms {entry_ms:.4f} (median {entry_median:.4f}); adjoint identity relative error "
                     f"{adj:.3g}; library max |diff| vs plain {lib_err:.3g}")
    report_kernel(label, res, tag)
    return res


def serve(torch, cli, ck, tag, path, argv, data=("--synthetic", "16")):
    """One `cli.test.main` run of 16 pairs (synthetic, or `data`'s) with the
    launch counts set to 0 just before it and read just after; the run must
    write 16 PNGs (the CLI refuses non-finite images) and launch exactly the
    path's kernels.  Returns (counts, written paths)."""
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    written = cli.main(argv + [*data, "--batchsize", "16"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = ck.launch_counts()
    print(f"cli.test ({path}): {len(written)} images in {cli_s:.2f} s (first call, includes loading); "
          f"launches {launches} [{tag}]", flush=True)
    assert len(written) == 16 and all(os.path.getsize(p) > 1000 for p in written), "missing try-on PNGs"
    for p in written:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", p
    ran = {name for name, n in launches.items() if n > 0}
    assert ran == PATH_KERNELS[path], f"{path} launched {sorted(ran)}, expected {sorted(PATH_KERNELS[path])}"
    return launches, written


def batch_diff(torch, wk, a, b, r, patches):
    """Max |a - b| over the keys of two try-on batches, leaving out the pixels
    a near-threshold plain mask value could flip (`r` the route's operands,
    `patches` its plain 4-channel norm patches); and the count left out."""
    near = near_threshold_pixels(torch, wk, patches, r["minv_denorm"], r["valid_denorm"], r["frame_hw"],
                                 r["erode_parts"])[..., None]
    worst = 0.0
    for k in a:
        d = (a[k].to(near.device) - b[k].to(near.device)).abs()
        if d.shape[1:3] == near.shape[1:3]:
            d = d * ~near
        worst = max(worst, float(d.max()))
    return worst, int(near.sum())


def host_ms(torch, fn, iters):
    """Median wall ms of one synchronised run, and the last output."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3, out


def time_tryon(torch, cli, gen, w_avg, prepare, batches, label, tag, res=256):
    """End-to-end try-on (routing + bf16 forward) for each (B, person,
    garment, iters) of `batches`: median host ms, then each step alone and
    under torch.profiler.  `prepare(person, garment)` routes one batch."""
    def route(p, gm):
        return {k: v.to(torch.bfloat16) for k, v in prepare(p, gm).items()}

    for B, p, gm, iters in batches:
        e2e_ms, out = host_ms(torch, lambda: cli.tryon_forward(gen, w_avg, route(p, gm)), iters)
        assert tuple(out.shape) == (B, res, res, 3) and bool(torch.isfinite(out.float()).all())
        batch = route(p, gm)
        steps = {"routing": lambda: route(p, gm), "forward": lambda: cli.tryon_forward(gen, w_avg, batch)}
        split = []
        for name, fn in steps.items():
            ms, _ = host_ms(torch, fn, iters)
            device_ms, n_ops, top = device_profile(torch, fn)
            split.append(f"{name} {ms:.2f} ms")
            busy = "not measured" if device_ms is None else f"{device_ms / ms:.3f}"
            dev = "not measured (no device time in the trace)" if device_ms is None else f"{device_ms:.3f} ms"
            print(f"profile {label} batch {B} {name}: host {ms:.2f} ms, device {dev}, busy {busy}, "
                  f"{n_ops:.0f} device ops per run [{tag}]", flush=True)
            for op, op_ms, n in top:
                print(f"    {op_ms:9.3f} ms {n:7.1f}x  {op[:100]}", flush=True)
        print(f"end-to-end try-on ({label}, routing + bf16 forward, full width): batch {B} {e2e_ms:.2f} ms, "
              f"{B / e2e_ms * 1e3:.1f} imgs/s (median of {iters}; {' + '.join(split)}) [{tag}]", flush=True)


def on_card(torch, d):
    return {k: torch.as_tensor(v, device="cuda") for k, v in d.items()}


def tryon_batches(torch, collate, ds):
    """(B, person, garment, iters) at batch 16 and batch 1, on the card."""
    p16 = on_card(torch, collate([ds[i] for i in range(16)]))
    g16 = on_card(torch, collate([ds[(i + 1) % 16] for i in range(16)]))
    return [(16, p16, g16, 10), (1, on_card(torch, collate([ds[0]])), on_card(torch, collate([ds[1]])), 20)]


def slice_phase(torch, wk, ck, tag, tmp):
    """Full serving through cli.test (fused route), card vs CPU, bf16 vs fp32,
    end-to-end timing.  Returns the serving run's launch counts."""
    from pasta_gan_tpu_torch.cli import test as cli
    from pasta_gan_tpu_torch.data.dataset import (
        SyntheticUvitonDataset, collate, prepare_tryon_batch, tryon_warp_inputs,
    )
    from pasta_gan_tpu_torch.io.checkpoints import save_snapshot
    from pasta_gan_tpu_torch.models import GeneratorFull

    g = torch.Generator().manual_seed(0)
    gen = GeneratorFull(img_resolution=256, channel_base=16384, channel_max=512).reset_parameters(g)
    snap = os.path.join(tmp, "snapshot.pt")
    save_snapshot(snap, gen.state_dict(), 0.1 * torch.randn(512, generator=g),
                  {"model": gen.config, "generator": gen.variant})
    del gen
    launches, _ = serve(torch, cli, ck, tag, "serving_full", ["--network", snap, "--outdir", os.path.join(tmp, "tryon")])

    # ---- the card's result against the port's CPU path on a small input
    ds = SyntheticUvitonDataset(num_samples=4, seed=3)
    person, garment = collate([ds[0], ds[1]]), collate([ds[2], ds[3]])
    b_gpu = prepare_tryon_batch(person, garment, device="cuda")
    b_cpu = prepare_tryon_batch(person, garment, device="cpu")
    r = tryon_warp_inputs(person, garment, device="cpu")
    patches = wk.norm_warp_reference(r["src_u"], r["src_l"], r["minv_norm"], r["valid_norm"], r["n_upper"], r["patch_hw"])
    worst, n_near = batch_diff(torch, wk, b_gpu, b_cpu, r, patches)
    assert worst <= TOL, f"try-on batch on the card differs from the CPU path: {worst}"
    thin = GeneratorFull(img_resolution=256, channel_base=512, channel_max=32)
    thin.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        o_cpu = cli.tryon_forward(thin.eval(), torch.zeros(512), b_cpu)
        o_gpu = cli.tryon_forward(thin.cuda(), torch.zeros(512, device="cuda"), {k: v.cuda() for k, v in b_cpu.items()})
    gerr = float((o_gpu.cpu() - o_cpu).abs().max())
    ok = torch.allclose(o_gpu.cpu(), o_cpu, rtol=1e-2, atol=1e-2)
    print(f"card vs CPU (batch 2): routing max_abs_err={worst:.3g} ({n_near} near-threshold "
          f"pixels excluded), thin-generator finetune max_abs_err={gerr:.3g} [{tag}]", flush=True)
    assert ok, "generator output on the card differs from the CPU path"

    # ---- the timed bf16 forward against the same snapshot's fp32 forward, full width
    gen, w_avg = cli.load_generator(snap, torch.device("cuda"))
    batches = tryon_batches(torch, collate, SyntheticUvitonDataset(num_samples=16))
    _, p16, g16, _ = batches[0]
    b32 = prepare_tryon_batch(p16, g16, device="cuda")
    o32 = cli.tryon_forward(gen, w_avg, b32)
    gen.set_dtype(torch.bfloat16)
    o16 = cli.tryon_forward(gen, w_avg, {k: v.to(torch.bfloat16) for k, v in b32.items()}).float()
    assert tuple(o16.shape) == (16, 256, 256, 3) and bool(torch.isfinite(o16).all()), "bad bf16 try-on images"
    rel = float((o16 - o32).norm() / o32.norm())
    print(f"bf16 vs fp32 forward (batch 16, full width): finetune relative L2 error {rel:.4g} "
          f"(limit {BF16_REL_L2}), max |diff| {float((o16 - o32).abs().max()):.4g} of max |fp32| "
          f"{float(o32.abs().max()):.4g} [{tag}]", flush=True)
    assert rel <= BF16_REL_L2, f"the bf16 forward differs from the fp32 one: relative L2 error {rel}"
    del o32, o16, b32

    # ---- end-to-end timing (routing + bf16 forward) and where the time goes
    torch.cuda.reset_peak_memory_stats()
    time_tryon(torch, cli, gen, w_avg, lambda p, gm: prepare_tryon_batch(p, gm, device="cuda"), batches, "full", tag)
    print(f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated [{tag}]", flush=True)
    return launches


def v18_phase(torch, wk, ck, tag, tmp):
    """Released-256 serving: a full-width GeneratorV18 through cli.test on
    the fused and the separate denorm route, the two routes' batches against
    each other on the card, the card against the CPU path (routing and a thin
    V18 forward, batch 2), end-to-end timing on both routes.  Returns the
    two serving runs' launch counts by path."""
    from pasta_gan_tpu_torch.cli import test as cli
    from pasta_gan_tpu_torch.data.dataset import (
        SyntheticUvitonDataset, collate, prepare_tryon_batch_v18, tryon_warp_inputs_v18,
    )
    from pasta_gan_tpu_torch.io.checkpoints import save_snapshot
    from pasta_gan_tpu_torch.models import GeneratorV18

    g = torch.Generator().manual_seed(0)
    gen = GeneratorV18(img_resolution=256, channel_base=16384, channel_max=512).reset_parameters(g)
    snap = os.path.join(tmp, "snapshot_v18.pt")
    save_snapshot(snap, gen.state_dict(), 0.1 * torch.randn(512, generator=g),
                  {"model": gen.config, "generator": gen.variant})
    del gen
    launches = {}
    for denorm in ("fused", "separate"):
        path = f"serving_v18_{denorm}"
        launches[path], _ = serve(torch, cli, ck, tag, path, [
            "--network", snap, "--generator", "v18", "--denorm", denorm,
            "--outdir", os.path.join(tmp, f"tryon_v18_{denorm}")])

    def plain_patches(r):
        out = wk.norm_warp_reference(r["src_u"], r["src_l"], r["minv_norm"], r["valid_norm"], r["n_upper"],
                                     r["patch_hw"])
        return out[:, :, 0:4].contiguous()

    # ---- the two routes against each other on the card, batch 16
    batches = tryon_batches(torch, collate, SyntheticUvitonDataset(num_samples=16))
    _, p16, g16, _ = batches[0]
    fused = prepare_tryon_batch_v18(p16, g16, device="cuda", denorm="fused")
    separate = prepare_tryon_batch_v18(p16, g16, device="cuda", denorm="separate")
    r = tryon_warp_inputs_v18(p16, g16, device="cuda")
    worst, n_near = batch_diff(torch, wk, separate, fused, r, plain_patches(r))
    print(f"V18 routing on the card, separate vs fused route (batch 16): max |diff| {worst:.3g} "
          f"({n_near} near-threshold pixels excluded) [{tag}]", flush=True)
    assert worst <= TOL, f"the separate route differs from the fused one: {worst}"
    del fused, separate, r

    # ---- the card's result against the port's CPU path on a small input
    ds = SyntheticUvitonDataset(num_samples=4, seed=3)
    person, garment = collate([ds[0], ds[1]]), collate([ds[2], ds[3]])
    b_cpu = prepare_tryon_batch_v18(person, garment, device="cpu")
    r = tryon_warp_inputs_v18(person, garment, device="cpu")
    errs = {}
    for denorm in ("fused", "separate"):
        b_gpu = prepare_tryon_batch_v18(person, garment, device="cuda", denorm=denorm)
        errs[denorm], n_near = batch_diff(torch, wk, b_gpu, b_cpu, r, plain_patches(r))
        assert errs[denorm] <= TOL, f"V18 batch ({denorm}) on the card differs from the CPU path: {errs[denorm]}"
    thin = GeneratorV18(img_resolution=256, channel_base=512, channel_max=32)
    thin.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        o_cpu = cli.tryon_forward(thin.eval(), torch.zeros(512), b_cpu)
        o_gpu = cli.tryon_forward(thin.cuda(), torch.zeros(512, device="cuda"), {k: v.cuda() for k, v in b_cpu.items()})
    gerr = float((o_gpu.cpu() - o_cpu).abs().max())
    print(f"V18 card vs CPU (batch 2): routing max_abs_err fused {errs['fused']:.3g} / separate "
          f"{errs['separate']:.3g} ({n_near} near-threshold pixels excluded), thin-generator finetune "
          f"max_abs_err={gerr:.3g} [{tag}]", flush=True)
    assert torch.allclose(o_gpu.cpu(), o_cpu, rtol=1e-2, atol=1e-2), "V18 generator on the card differs from the CPU"

    # ---- end-to-end timing on both routes, bf16
    gen, w_avg = cli.load_generator(snap, torch.device("cuda"), "v18")
    gen.set_dtype(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    for denorm in ("fused", "separate"):
        time_tryon(torch, cli, gen, w_avg,
                   lambda p, gm: prepare_tryon_batch_v18(p, gm, device="cuda", denorm=denorm),  # noqa: B023
                   batches, f"v18 {denorm}", tag)
    print(f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated (V18) [{tag}]", flush=True)
    return launches


def fixture_root():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), FIXTURE)


def fixture_512_batch(tds, B, first=0):
    """Collated (person, garment) of the fixture's 512x320 test pairs first ... first + B - 1 (wrapping)."""
    ds = tds.UvitonDataset512Test(fixture_root())
    items = [ds[(first + i) % len(ds)] for i in range(B)]
    return tds.collate([it["person"] for it in items]), tds.collate([it["garment"] for it in items])


def serving_512_phase(torch, wk, ck, tag, tmp):
    """512x320 serving: a full-width Generator512 (channel_base 32768,
    channel_max 512, start 8, merge above 32, seed 0) through cli.test_512 on
    the fixture's 8 test pairs for each --change_region on the fused and the
    separate denorm route, each run launching exactly its path's kernels and
    writing 8 triptychs that decode to 512x960; the two routes' batches
    against each other on the card (batch 8, every region); the card against
    the CPU path (routing on both routes and a thin Generator512 forward,
    batch 2, fp32); the bf16 forward against the fp32 one (batch 8); the
    end-to-end try-on (fullbody, bf16, from a loaded batch) timed and
    profiled at batch 8 and 1.  Returns the serving runs' launch counts,
    summed over the regions, by path."""
    from pasta_gan_tpu_torch.cli import test as cli
    from pasta_gan_tpu_torch.cli import test_512 as cli512
    from pasta_gan_tpu_torch.data import dataset as tds
    from pasta_gan_tpu_torch.data import image_io
    from pasta_gan_tpu_torch.data.warp import CHANGE_REGIONS
    from pasta_gan_tpu_torch.io.checkpoints import save_snapshot
    from pasta_gan_tpu_torch.models import Generator512

    g = torch.Generator().manual_seed(0)
    gen = Generator512().reset_parameters(g)
    assert (gen.config["img_resolution"], gen.config["channel_base"], gen.config["channel_max"]) == (512, 32768, 512)
    snap = os.path.join(tmp, "snapshot_512.pt")
    save_snapshot(snap, gen.state_dict(), 0.1 * torch.randn(512, generator=g),
                  {"model": gen.config, "generator": gen.variant})
    del gen
    launches = {}
    for denorm in ("fused", "separate"):
        path = f"serving_512_{denorm}"
        launches[path] = dict.fromkeys(ck.KERNELS, 0)
        for region in CHANGE_REGIONS:
            ck.reset_launch_counts()
            t0 = time.perf_counter()
            written = cli512.main(["--network", snap, "--dataroot", fixture_root(), "--change_region", region,
                                   "--denorm", denorm, "--batchsize", "8",
                                   "--outdir", os.path.join(tmp, f"tryon_512_{denorm}_{region}")])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            counts = ck.launch_counts()
            ran = {name for name, n in counts.items() if n > 0}
            assert ran == PATH_KERNELS[path], f"{path} ({region}) launched {sorted(ran)}, expected {sorted(PATH_KERNELS[path])}"
            assert len(written) == 8 and all(image_io.read_image(p).shape == (512, 960, 3) for p in written), \
                f"{path} ({region}): missing or misshapen triptychs"
            for k, n in counts.items():
                launches[path][k] += n
            print(f"cli.test_512 ({path}, --change_region {region}): {len(written)} triptychs (512x960) in "
                  f"{cli_s:.2f} s (first call, includes loading); launches {counts} [{tag}]", flush=True)

    # ---- the two routes against each other on the card, every region, batch 8
    p8, g8 = fixture_512_batch(tds, 8)
    for region in CHANGE_REGIONS:
        fused = tds.prepare_tryon_batch_512(p8, g8, region, device="cuda", denorm="fused")
        separate = tds.prepare_tryon_batch_512(p8, g8, region, device="cuda", denorm="separate")
        r = tds.warp_inputs_512_batch(p8, g8, region, device="cuda")
        patches = wk.norm_warp_reference(r["src_u"], r["src_l"], r["minv_norm"], r["valid_norm"], r["n_upper"],
                                         r["patch_hw"])
        worst, n_near = batch_diff(torch, wk, separate, fused, r, patches)
        print(f"512 routing on the card, separate vs fused route ({region}, batch 8): max |diff| {worst:.3g} "
              f"({n_near} near-threshold pixels excluded) [{tag}]", flush=True)
        assert worst <= TOL, f"the 512 separate route differs from the fused one ({region}): {worst}"
        del fused, separate, r, patches

    # ---- the card's result against the port's CPU path, batch 2, fp32
    person, garment = fixture_512_batch(tds, 2, first=1)
    b_cpu = tds.prepare_tryon_batch_512(person, garment, "fullbody", device="cpu")
    r = tds.warp_inputs_512_batch(person, garment, "fullbody", device="cpu")
    patches = wk.norm_warp_reference(r["src_u"], r["src_l"], r["minv_norm"], r["valid_norm"], r["n_upper"],
                                     r["patch_hw"])
    errs = {}
    for denorm in ("fused", "separate"):
        b_gpu = tds.prepare_tryon_batch_512(person, garment, "fullbody", device="cuda", denorm=denorm)
        errs[denorm], n_near = batch_diff(torch, wk, b_gpu, b_cpu, r, patches)
        assert errs[denorm] <= TOL, f"512 batch ({denorm}) on the card differs from the CPU path: {errs[denorm]}"
    thin = Generator512(channel_base=1024, channel_max=32).reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        o_cpu = cli.tryon_forward(thin.eval(), torch.zeros(512), b_cpu)
        o_gpu = cli.tryon_forward(thin.cuda(), torch.zeros(512, device="cuda"), {k: v.cuda() for k, v in b_cpu.items()})
    gerr = float((o_gpu.cpu() - o_cpu).abs().max())
    print(f"512 card vs CPU (fullbody, batch 2): routing max_abs_err fused {errs['fused']:.3g} / separate "
          f"{errs['separate']:.3g} ({n_near} near-threshold pixels excluded), thin-generator finetune "
          f"max_abs_err={gerr:.3g} [{tag}]", flush=True)
    assert torch.allclose(o_gpu.cpu(), o_cpu, rtol=1e-2, atol=1e-2), "Generator512 on the card differs from the CPU"
    del thin, o_cpu, o_gpu

    # ---- the timed bf16 forward against the same snapshot's fp32 forward, full width, batch 8
    gen, w_avg = cli.load_generator(snap, torch.device("cuda"), "512")
    p8, g8 = on_card(torch, p8), on_card(torch, g8)
    b32 = tds.prepare_tryon_batch_512(p8, g8, "fullbody", device="cuda")
    o32 = cli.tryon_forward(gen, w_avg, b32)
    gen.set_dtype(torch.bfloat16)
    o16 = cli.tryon_forward(gen, w_avg, {k: v.to(torch.bfloat16) for k, v in b32.items()}).float()
    assert tuple(o16.shape) == (8, 512, 512, 3) and bool(torch.isfinite(o16).all()), "bad bf16 512 try-on images"
    rel = float((o16 - o32).norm() / o32.norm())
    print(f"512 bf16 vs fp32 forward (batch 8, full width): finetune relative L2 error {rel:.4g} (limit "
          f"{BF16_REL_L2}), max |diff| {float((o16 - o32).abs().max()):.4g} of max |fp32| "
          f"{float(o32.abs().max()):.4g} [{tag}]", flush=True)
    assert rel <= BF16_REL_L2, f"the 512 bf16 forward differs from the fp32 one: relative L2 error {rel}"
    del o32, o16, b32

    # ---- end-to-end timing (routing + bf16 forward) from a loaded batch, and where the time goes
    p1, g1 = (on_card(torch, d) for d in fixture_512_batch(tds, 1))
    torch.cuda.reset_peak_memory_stats()
    time_tryon(torch, cli, gen, w_avg, lambda p, gm: tds.prepare_tryon_batch_512(p, gm, "fullbody", device="cuda"),
               [(8, p8, g8, 10), (1, p1, g1, 20)], "512 fullbody", tag, res=512)
    print(f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated (512) [{tag}]", flush=True)
    del gen
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------ int8 serving

INT8_PEAK_OPS = 1979e12  # H100 SXM int8 tensor-core operations a second (dense)
# int8 vs fp32 forward, ||int8 - fp32|| / ||fp32|| of the finetune image: about twice the largest
# int8-vs-fp32 distance of the JAX package's own forward in the CPU tests (0.112, Generator512 at
# channel_base 512, channel_max 32, 64px; tests/test_torch_quant_generators.py); a wrong scale or a conv on
# the wrong operands moves it above 1
INT8_REL_L2 = 0.25
# card vs CPU of the int8_static forward: the CPU tests' rule (tests/test_torch_quant_generators.py): within
# INT8_SENSITIVITY_FACTOR times the forward's own move when its inputs move by INT8_PERTURB relative (the
# larger of two draws, on the card), since one ulp before a quantize can flip a rounding and the flips spread
INT8_PERTURB, INT8_SENSITIVITY_FACTOR = 1e-6, 2.0


def int8_classes(torch, fn):
    """Run fn() once and count its int8_conv calls by class (kh, stride,
    dilation, C, O, H, W, output dtype, scale kind, paddings, batch), through a
    counting wrapper around `ops/quant.py:int8_conv` that is removed again
    before returning."""
    from collections import Counter

    from pasta_gan_tpu_torch.ops import quant as tq

    hist, conv = Counter(), tq.int8_conv

    def counted(xq, wq, sx, sw, stride=1, padding_hw=((0, 0), (0, 0)), lhs_dilation=1, out_dtype=torch.bfloat16):
        N, C, H, W = xq.shape
        hist[(wq.shape[2], stride, lhs_dilation, C, wq.shape[0], H, W, str(out_dtype)[6:],
              "scalar" if sx.numel() == 1 else "per_sample", tuple(map(tuple, padding_hw)), N)] += 1
        return conv(xq, wq, sx, sw, stride, padding_hw, lhs_dilation, out_dtype)

    tq.int8_conv = counted
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        tq.int8_conv = conv
    return hist


def int8_library(torch, xq, wq, sx, sw, stride, padding_hw, dil, out_dtype):
    """The yardstick: im2col (int8, in memory) + `torch._int_mm` (s8 x s8 ->
    s32) + the same epilogue; never called by the port.  None where
    `_int_mm` does not take the shape (K or O not a multiple of 8)."""
    F = torch.nn.functional
    N, C, H, W = xq.shape
    O, _, kh, kw = wq.shape
    (pt, pb), (pl, pr) = padding_hw
    K = C * kh * kw
    if O % 8 or N * H * W <= 16:
        return None
    x = xq
    if dil > 1:
        xd = torch.zeros(N, C, (H - 1) * dil + 1, (W - 1) * dil + 1, dtype=torch.int8, device=xq.device)
        xd[:, :, ::dil, ::dil] = x
        x = xd
    x = F.pad(x, (pl, pr, pt, pb))
    cols = x.unfold(2, kh, stride).unfold(3, kw, stride)  # [N, C, Ho, Wo, kh, kw]
    Ho, Wo = cols.shape[2:4]
    a = cols.permute(0, 2, 3, 1, 4, 5).reshape(N * Ho * Wo, K)
    b = wq.reshape(O, K)
    if K % 8:
        a, b = F.pad(a, (0, 8 - K % 8)), F.pad(b, (0, 8 - K % 8))
    acc = torch._int_mm(a, b.t())
    y = acc.view(N, Ho, Wo, O).permute(0, 3, 1, 2).float()
    if out_dtype == torch.bfloat16:
        y = y.to(torch.bfloat16).float()
    return (y * (sx.float().reshape(-1, 1, 1, 1) * sw.float().reshape(1, -1, 1, 1))).to(out_dtype)


def int8_case(torch, g, cls, tag, launches=None, iters=10):
    """One int8_conv class on random int8 operands of its shape: the kernel
    against its plain version on the card (max abs error 0), through its
    wrapper and its C entry point alone (operands packed beforehand), the
    plain version, the library yardstick (im2col + `_int_mm`, also held to
    the plain version) and the bf16 cuDNN conv of the same geometry; the
    bound: useful operations (2 x C x O x the taps that land on real input,
    summed over the outputs) over 1979 TOP/s, or bytes (int8 input and
    weight, the output, the scales) over 3.35 TB/s, the larger."""
    from pasta_gan_tpu_torch.ops import cuda_kernels as ck
    from pasta_gan_tpu_torch.ops import quant as tq

    F = torch.nn.functional
    kh, stride, dil, C, O, H, W, dt, scale, pads, N = cls
    out_dtype = getattr(torch, dt)
    (pt, pb), (pl, pr) = pads
    xq = torch.randint(-127, 128, (N, C, H, W), generator=g, device="cuda", dtype=torch.int8)
    wq = torch.randint(-127, 128, (O, C, kh, kh), generator=g, device="cuda", dtype=torch.int8)
    sx = torch.rand((N, 1, 1, 1) if scale == "per_sample" else (), generator=g, device="cuda") * 0.05 + 1e-3
    sw = torch.rand(O, generator=g, device="cuda") * 0.01 + 1e-4
    args = (xq, wq, sx, sw, stride, pads, dil, out_dtype)
    run = lambda: tq.int8_conv(*args)  # noqa: E731
    plain = lambda: tq.int8_conv_reference(*args)  # noqa: E731
    y, yp = run(), plain()
    torch.cuda.synchronize()
    assert y.shape == yp.shape and y.dtype == out_dtype, (cls, y.shape, yp.shape)
    err = float((y.float() - yp.float()).abs().max())
    assert err == 0, f"int8_conv {cls} differs from its plain version: max abs error {err}"
    yl = int8_library(torch, *args)
    lib_err = None if yl is None else float((yl.float() - yp.float()).abs().max())
    # the C entry point alone, its operands laid out beforehand, into a preallocated output
    ops = tq.kernel_operands(xq, wq, stride, pads, dil)
    sxf = sx.float().reshape(-1).contiguous()
    ye = torch.empty_like(y)
    entry = lambda: tq.launch_kernel(ops, sxf, sw, ye)  # noqa: E731
    entry()
    torch.cuda.synchronize()
    assert torch.equal(ye, y), f"int8_conv {cls} through its C entry point differs from its wrapper"
    entry_ms, entry_median = cuda_time_ms(torch, entry, iters=iters)
    ms, ms_median = cuda_time_ms(torch, run, iters=iters)
    plain_ms = cuda_time_ms(torch, plain, iters=2, warmup=1)[0]
    lib = cuda_time_ms(torch, lambda: int8_library(torch, *args), iters=iters)[0] if yl is not None else None
    xb = torch.randn(N, C, H, W, generator=g, device="cuda").to(torch.bfloat16)
    if dil > 1:  # input dilation 2 with padding 3 of a 6x6 kernel is a stride-2 transposed conv
        wb = torch.randn(C, O, kh, kh, generator=g, device="cuda").to(torch.bfloat16)
        bf16 = lambda: F.conv_transpose2d(xb, wb, stride=dil, padding=kh - 1 - pt)  # noqa: E731
    else:
        wb = torch.randn(O, C, kh, kh, generator=g, device="cuda").to(torch.bfloat16)
        bf16 = lambda: F.conv2d(xb, wb, stride=stride, padding=(pt, pl))  # noqa: E731
    assert tuple(bf16().shape) == tuple(y.shape), (cls, bf16().shape, y.shape)
    bf16_ms = cuda_time_ms(torch, bf16, iters=iters)[0]
    ones = torch.ones(N, 1, H, W, dtype=torch.int8, device="cuda")
    taps = float(tq.int8_conv_reference(ones, torch.ones(1, 1, kh, kh, dtype=torch.int8, device="cuda"),
                                        torch.ones((), device="cuda"), torch.ones(1, device="cuda"), stride, pads,
                                        dil, torch.float32).double().sum())
    ops = 2.0 * C * O * taps
    nbytes_ = xq.numel() + wq.numel() + y.numel() * y.element_size() + 4 * (N + O)
    res = dict(err=err, entry_ms=entry_ms, entry_median=entry_median, ms=ms, ms_median=ms_median, plain_ms=plain_ms,
               library_ms=lib, bf16_ms=bf16_ms, ops=ops, bytes=nbytes_,
               bound_ms=max(nbytes_ / PEAK_BYTES_PER_S, ops / INT8_PEAK_OPS) * 1e3,
               bound_by="bytes" if nbytes_ / PEAK_BYTES_PER_S >= ops / INT8_PEAK_OPS else "operations")
    n = "" if launches is None else f"{launches} per forward, "
    lib_s = "null" if lib is None else f"{lib:.4f} (im2col + _int_mm, max |diff| vs plain {lib_err:.3g})"
    print(f"kernel int8_conv({kh}x{kh}, stride {stride}, dilation {dil}, {C}->{O}, [{N},{C},{H},{W}] -> "
          f"{list(y.shape)}, {dt}, {scale} scale): {n}max_abs_err={err:.3g} entry_ms={entry_ms:.4f} (median "
          f"{entry_median:.4f}) wrapper_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={res['bound_ms']:.4f} "
          f"({res['bound_by']}; {ops / entry_ms / 1e9:.1f} TOP/s) library_ms={lib_s} bf16 cuDNN conv "
          f"{bf16_ms:.4f} [{tag}]", flush=True)
    return res


def int8_kernel_classes(torch, label, gen, w_avg, batch, tag):
    """Count the int8_conv launches of one forward of `gen` (its quant mode
    set) by class, hold every class to its plain version and time it
    (`int8_case`); returns {class: (launches, result)}."""
    from pasta_gan_tpu_torch.cli import test as cli

    with torch.no_grad():
        classes = int8_classes(torch, lambda: cli.tryon_forward(gen, w_avg, batch))
    print(f"{label}: {sum(classes.values())} int8_conv launches in {len(classes)} classes [{tag}]", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for cls, n in sorted(classes.items(), key=lambda kv: str(kv[0])):
        out[cls] = (n, int8_case(torch, g, cls, tag, launches=n))
        torch.cuda.empty_cache()
    total = sum(n * r["entry_ms"] for n, r in out.values())
    bound = sum(n * r["bound_ms"] for n, r in out.values())
    bf16 = sum(n * r["bf16_ms"] for n, r in out.values())
    lib = sum(n * r["library_ms"] for n, r in out.values() if r["library_ms"] is not None)
    print(f"{label}: int8_conv {total:.3f} ms a forward through the C entry point (bound {bound:.3f} ms; the bf16 "
          f"cuDNN convs of the same geometries {bf16:.3f} ms; im2col + _int_mm {lib:.3f} ms where it applies) "
          f"[{tag}]", flush=True)
    return out


def int8_serve_512(torch, cli512, ck, tag, tmp, snap, path, argv):
    """One cli.test_512 run on the fixture's 8 pairs (fullbody, fused route),
    launch counts set to 0 just before and read just after."""
    from pasta_gan_tpu_torch.data import image_io

    ck.reset_launch_counts()
    t0 = time.perf_counter()
    written = cli512.main(["--network", snap, "--dataroot", fixture_root(), "--change_region", "fullbody",
                           "--batchsize", "8", "--outdir", os.path.join(tmp, path)] + argv)
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    print(f"cli.test_512 ({path}, {' '.join(argv)}): {len(written)} triptychs in {time.perf_counter() - t0:.2f} s "
          f"(first call, includes loading and calibration); launches {counts} [{tag}]", flush=True)
    assert len(written) == 8 and all(image_io.read_image(p).shape == (512, 960, 3) for p in written), path
    ran = {name for name, n in counts.items() if n > 0}
    assert ran == PATH_KERNELS[path], f"{path} launched {sorted(ran)}, expected {sorted(PATH_KERNELS[path])}"
    return counts


def int8_serving_phase(torch, wk, ck, tag, tmp):
    """int8 serving (W8A8, ops/quant.py) on the snapshots of the Full, V18 and
    512 serving phases: cli.test --quant int8_static --calib_batches 2 and
    --quant int8 (Full, 16 synthetic pairs), --generator v18 --quant
    int8_static, and cli.test_512 --quant int8_static (fullbody, the
    fixture's 8 pairs), each launching exactly its path's kernels; the
    int8_conv classes of one batch-16 Full int8_static forward and one
    batch-8 Generator512 forward (bf16), each held to its plain version at
    max abs error 0 and timed beside its bound, the library yardstick and the
    bf16 cuDNN conv; the card against the CPU (int8_static, full width, batch
    2, fp32, the same calibrated scales); int8 and int8_static against the
    fp32 forward on the timed batch; end-to-end timing and profiles (Full at
    batch 16 and 1 in both modes, 512 int8_static at batch 8 and 1, bf16)
    and peak memory.  Returns (the serving runs' launch counts by path, the
    kernels line's int8_conv result)."""
    from pasta_gan_tpu_torch.cli import test as cli
    from pasta_gan_tpu_torch.cli import test_512 as cli512
    from pasta_gan_tpu_torch.data import dataset as tds
    from pasta_gan_tpu_torch.models import GeneratorFull

    snap, snap_v18, snap_512 = (os.path.join(tmp, f"snapshot{s}.pt") for s in ("", "_v18", "_512"))
    launches = {}
    for path, argv in (("serving_int8_static", ["--network", snap, "--quant", "int8_static", "--calib_batches", "2"]),
                       ("serving_int8", ["--network", snap, "--quant", "int8"]),
                       ("serving_v18_int8_static", ["--network", snap_v18, "--generator", "v18", "--quant",
                                                    "int8_static"])):
        launches[path], _ = serve(torch, cli, ck, tag, path, argv + ["--outdir", os.path.join(tmp, path)])
    launches["serving_512_int8_static"] = int8_serve_512(torch, cli512, ck, tag, tmp, snap_512,
                                                         "serving_512_int8_static", ["--quant", "int8_static"])

    # ---- the int8_conv classes of one batch-16 Full forward and one batch-8 Generator512 forward, bf16
    gen, w_avg = cli.load_generator(snap, torch.device("cuda"))
    batches = tryon_batches(torch, tds.collate, tds.SyntheticUvitonDataset(num_samples=16))
    _, p16, g16, _ = batches[0]
    b32 = tds.prepare_tryon_batch(p16, g16, device="cuda")
    o32 = cli.tryon_forward(gen, w_avg, b32).float()
    gen.set_dtype(torch.bfloat16)
    b16 = {k: v.to(torch.bfloat16) for k, v in b32.items()}
    cli.calibrate_int8_static(gen, w_avg, [b16])
    full_classes = int8_kernel_classes(torch, "GeneratorFull int8_static forward (batch 16, bf16)", gen, w_avg, b16,
                                       tag)
    main_cls = max(full_classes, key=lambda c: full_classes[c][0] * full_classes[c][1]["entry_ms"])
    result = full_classes[main_cls][1]
    print(f"int8_conv's main class (the most time in the Full forward): {main_cls} [{tag}]", flush=True)

    # ---- int8 and int8_static against the fp32 forward on the timed batch (bf16 compute)
    rels = {}
    for mode in ("int8_static", "int8"):
        gen.quant = mode
        o8 = cli.tryon_forward(gen, w_avg, b16).float()
        assert tuple(o8.shape) == (16, 256, 256, 3) and bool(torch.isfinite(o8).all()), f"bad {mode} try-on images"
        rels[mode] = float((o8 - o32).norm() / o32.norm())
    print(f"int8 vs fp32 forward (batch 16, full width, bf16 compute): finetune relative L2 error int8_static "
          f"{rels['int8_static']:.4g}, int8 {rels['int8']:.4g} (limit {INT8_REL_L2}; bf16 alone: the Full serving "
          f"phase's line) [{tag}]", flush=True)
    assert max(rels.values()) <= INT8_REL_L2, f"the int8 forward differs from the fp32 one: {rels}"
    del o32, o8, b32

    # ---- end-to-end timing (routing + bf16 int8 forward) and where the time goes, Full
    gen.quant = "int8_static"
    torch.cuda.reset_peak_memory_stats()
    for mode in ("int8_static", "int8"):
        gen.quant = mode
        time_tryon(torch, cli, gen, w_avg, lambda p, gm: tds.prepare_tryon_batch(p, gm, device="cuda"), batches,
                   f"full {mode}", tag)
    print(f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated (Full int8) [{tag}]", flush=True)
    del gen, b16
    torch.cuda.empty_cache()

    # ---- Generator512: classes at batch 8, timing at batch 8 and 1
    gen, w_avg = cli.load_generator(snap_512, torch.device("cuda"), "512")
    gen.set_dtype(torch.bfloat16)
    p8, g8 = (on_card(torch, d) for d in fixture_512_batch(tds, 8))
    route512 = lambda p, gm: tds.prepare_tryon_batch_512(p, gm, "fullbody", device="cuda")  # noqa: E731
    b8 = {k: v.to(torch.bfloat16) for k, v in route512(p8, g8).items()}
    cli.calibrate_int8_static(gen, w_avg, [b8])
    int8_kernel_classes(torch, "Generator512 int8_static forward (batch 8, bf16)", gen, w_avg, b8, tag)
    p1, g1 = (on_card(torch, d) for d in fixture_512_batch(tds, 1))
    torch.cuda.reset_peak_memory_stats()
    time_tryon(torch, cli, gen, w_avg, route512, [(8, p8, g8, 10), (1, p1, g1, 20)], "512 fullbody int8_static",
               tag, res=512)
    print(f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated (512 int8_static) [{tag}]", flush=True)
    del gen, b8
    torch.cuda.empty_cache()

    # ---- the card against the CPU: int8_static, full width, batch 2, fp32, the card's calibrated scales
    ds = tds.SyntheticUvitonDataset(num_samples=4, seed=3)
    person, garment = tds.collate([ds[0], ds[1]]), tds.collate([ds[2], ds[3]])
    b_cpu = tds.prepare_tryon_batch(person, garment, device="cpu")
    gen_gpu, w_gpu = cli.load_generator(snap, torch.device("cuda"))
    cli.calibrate_int8_static(gen_gpu, w_gpu, [{k: v.cuda() for k, v in b_cpu.items()}])
    gen_cpu, w_cpu = cli.load_generator(snap, "cpu")
    gen_cpu.load_quant_scales({k: v.cpu() for k, v in gen_gpu.quant_scales().items()})
    gen_cpu.quant = "int8_static"
    t0 = time.perf_counter()
    o_cpu = cli.tryon_forward(gen_cpu, w_cpu, b_cpu)
    cpu_s = time.perf_counter() - t0
    b_gpu = {k: v.cuda() for k, v in b_cpu.items()}
    o_gpu = cli.tryon_forward(gen_gpu, w_gpu, b_gpu)
    rel = float((o_gpu.cpu() - o_cpu).norm() / o_cpu.norm())
    # the forward's own move (the same algorithm on either device; measured on the card, where it is fast)
    sens = 0.0
    for seed in (1, 2):
        rng = torch.Generator(device="cuda").manual_seed(seed)
        moved = {k: v if "mask" in k else v * (1 + INT8_PERTURB * torch.randn(v.shape, generator=rng, device="cuda"))
                 for k, v in b_gpu.items()}
        sens = max(sens, float((cli.tryon_forward(gen_gpu, w_gpu, moved) - o_gpu).norm() / o_gpu.norm()))
    o_gpu = o_gpu.cpu()
    print(f"int8_static card vs CPU (full width, batch 2, fp32, the card's calibrated scales): finetune relative L2 "
          f"{rel:.4g}, max |diff| {float((o_gpu - o_cpu).abs().max()):.4g}; the forward's own move under a "
          f"{INT8_PERTURB:g} relative input change {sens:.4g} (limit {INT8_SENSITIVITY_FACTOR} x that); one CPU "
          f"forward {cpu_s:.1f} s [{tag}]", flush=True)
    assert rel <= INT8_SENSITIVITY_FACTOR * sens, f"int8_static on the card differs from the CPU: {rel} vs {sens}"
    del gen_gpu, gen_cpu
    torch.cuda.empty_cache()
    return launches, result


def device_profile(torch, fn, iters=5, top=8):
    """Device ms and device operations per run of fn() under torch.profiler
    (one stream, so operations do not overlap), and the `top` operations by
    time as (name, ms per run, count per run).  Device ms is None when the
    trace holds no device time."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ops = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ops[e.name][0] += e.time_range.elapsed_us()
            ops[e.name][1] += 1
    device_ms = sum(t for t, _ in ops.values()) / 1e3 / iters
    n_ops = sum(n for _, n in ops.values()) / iters
    ranked = sorted(ops.items(), key=lambda kv: -kv[1][0])[:top]
    return (device_ms or None), n_ops, [(op, us / 1e3 / iters, n / iters) for op, (us, n) in ranked]


def check_grids(run_dir, n_samples, tag):
    """The image grids of a cli.train run with --img_snap 1: the four written
    at the start and fakes / parsing / tryon_grid for every tick's kimg tag,
    each decoded by the port's PNG decoder to its shape (grid_n = min(16,
    batch, samples) tiles of 256x256 in ceil(sqrt(grid_n)) columns; a gnum x
    gnum try-on grid, gnum = min(6, grid_n))."""
    from pasta_gan_tpu_torch.data import image_io

    grid_n = min(16, TRAIN_BATCH, n_samples)
    gnum = min(6, grid_n)
    cols = math.ceil(math.sqrt(grid_n))
    tile = (256 * math.ceil(grid_n / cols), 256 * cols, 3)
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        tags = {f"{round(json.loads(line)['Progress/kimg'] * 1000) // 1000:06d}" for line in f}
    want = {f"{n}.png": tile for n in ("reals", "init_denorm_upper", "init_denorm_lower", "init_retain")}
    for t in tags:
        want.update({f"fakes{t}.png": tile, f"parsing{t}.png": tile, f"tryon_grid{t}.png": (256 * gnum, 256 * gnum, 3)})
    got = {n: image_io.read_image(os.path.join(run_dir, n)).shape for n in sorted(os.listdir(run_dir))
           if n.endswith(".png")}
    assert got == want, f"grids written {got}, expected {want}"
    print(f"image grids: {len(got)} PNGs decoded at their shapes ({', '.join(sorted(got))}) [{tag}]", flush=True)


def run_cli_train(torch, ck, tag, tmp, path, argv, data=("--synthetic", "64"), n_samples=64, grids=True,
                  steps=TRAIN_STEPS):
    """cli.train at full width: `steps` steps at batch TRAIN_BATCH, bf16, R1
    on the first, 64 synthetic samples (or `data`'s, `n_samples` of them),
    extra flags `argv`, the image grids every tick (`--img_snap 1`) or, with
    `grids` false, none (`--img_snap 0`).  Checks what every training path
    must give (finite stats, G, D and G_ema moved, exactly the kernels of
    PATH_KERNELS[path], every grid PNG) and returns (cli output, launches)."""
    from pasta_gan_tpu_torch.cli import train as cli_train

    # cuDNN's fp32 convolutions (the VGG19 features, D's epilogue) run as a
    # user of cli.train gets them: TF32, PyTorch's default
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    out = cli_train.main(["--outdir", os.path.join(tmp, "runs"), *data, "--batch", str(TRAIN_BATCH),
                          "--dtype", "bfloat16", "--seed", "0", "--kimg", str(steps * TRAIN_BATCH / 1000),
                          "--img_snap", str(int(grids)), *argv])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = ck.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    trainer, state, records = out["trainer"], out["state"], out["records"]
    print(f"cli.train {' '.join([*data, *argv])}: {state.step} steps at batch {TRAIN_BATCH} in {wall_s:.1f} s "
          f"(includes making the samples on the host); launches {launches}; peak {peak_gb:.2f} GB allocated [{tag}]",
          flush=True)
    assert state.step == steps and len(records) == steps
    assert "Loss/r1_penalty" in records[0], "R1 did not run on the first step"
    for r in records:
        bad = {k: v for k, v in r.items() if not math.isfinite(v)}
        assert not bad, f"non-finite training stats: {bad}"
    ran = {name for name, n in launches.items() if n > 0}
    expected = PATH_KERNELS[path]
    assert ran == expected, f"{path} launched {sorted(ran)}, expected {sorted(expected)}"
    init = trainer.init_state(torch.Generator().manual_seed(0))  # what the run started from
    moved = {name: any(not torch.equal(a, b) for a, b in zip(getattr(state, name).parameters(), ref.parameters()))
             for name, ref in (("G", init.G), ("D", init.D), ("G_ema", init.G))}
    assert all(moved.values()), f"parameters did not move: {moved}"
    if grids:
        check_grids(out["run_dir"], n_samples, tag)
    return out, launches


def step_times(torch, out, batch, tag, label):
    """Median host ms of Gmain+Dmain (cli.train's steps 2-4) and of 3 R1 steps,
    and sec/kimg from them; printed, returned as (main, r1) ms."""
    trainer, state, records = out["trainer"], out["state"], out["records"]
    main_ms = [r["Timing/Gmain_Dmain"] * 1e3 for r in records[1:]]
    data_ms = [r["Timing/data"] * 1e3 for r in records[1:]]
    r1_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, r1 = trainer.d_r1_step(state, batch)
        float(r1["Loss/r1_penalty"])
        r1_ms.append((time.perf_counter() - t1) * 1e3)
    med = statistics.median
    step_ms = med(data_ms) + med(main_ms) + med(r1_ms) / (trainer.config.d_reg_interval or 1)
    print(f"{label} step (full width, batch {TRAIN_BATCH}, bf16): Gmain+Dmain median {med(main_ms):.1f} ms "
          f"(steps 2-{TRAIN_STEPS}: {', '.join(f'{t:.1f}' for t in main_ms)}; step 1 with R1 and warm-up "
          f"{records[0]['Timing/Gmain_Dmain'] * 1e3:.1f} ms); R1 median {med(r1_ms):.1f} ms "
          f"({', '.join(f'{t:.1f}' for t in r1_ms)}); data+routing median {med(data_ms):.1f} ms [{tag}]", flush=True)
    print(f"{label} sec/kimg: {step_ms / TRAIN_BATCH:.3f} (data + Gmain+Dmain + R1/16, medians); the loop's last "
          f"tick {last_tick_sec_per_kimg(out['run_dir']):.3f} [{tag}]", flush=True)
    return med(main_ms), med(r1_ms)


def profile_steps(torch, ck, out, batch, tag, label, down2_classes=False):
    """One Gmain+Dmain and one R1 step under torch.profiler (device ms, busy
    share over the host time of the same step run once more unprofiled, top
    operations); returns {step: (device ms, host ms, launches)}."""
    trainer, state = out["trainer"], out["state"]
    res, classes = {}, {}
    for name, fn, top_n in (("Gmain+Dmain", lambda: trainer.train_step(state, batch), 10),
                            ("R1", lambda: trainer.d_r1_step(state, batch), 6)):
        device_ms, n_ops, top = device_profile(torch, fn, iters=1, top=top_n)
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t1) * 1e3
        res[name] = (device_ms, host_ms, ck.launch_counts())
        if down2_classes:
            classes[name] = {k[1:]: n for k, n in fir_classes(torch, fn).items() if k[0] == "down2"}
        busy = "not measured" if device_ms is None else f"{device_ms / host_ms:.3f}"
        dev = "not measured (no device time in the trace)" if device_ms is None else f"{device_ms:.1f} ms"
        print(f"profile {label} {name} step (batch {TRAIN_BATCH}): host {host_ms:.1f} ms, device {dev}, busy {busy}, "
              f"{n_ops:.0f} device ops [{tag}]", flush=True)
        for op, op_ms, n in top:
            print(f"    {op_ms:9.3f} ms {n:7.1f}x  {op[:100]}", flush=True)
    print(f"{label} launches per step { {k: v[2] for k, v in res.items()} } [{tag}]", flush=True)
    for name, hist in classes.items():
        print(f"down2 launches in one {name} step by (pad, dtype, input shape), {sum(hist.values())} in all: "
              + ", ".join(f"{k}: {n}" for k, n in sorted(hist.items(), key=lambda kv: -kv[1])) + f" [{tag}]",
              flush=True)
    return res


def train_batch(torch):
    from pasta_gan_tpu_torch.data.dataset import SyntheticUvitonDataset, collate, prepare_train_batch

    ds = SyntheticUvitonDataset(num_samples=64, seed=0)
    return prepare_train_batch(collate([ds[i] for i in range(TRAIN_BATCH)]), torch.Generator().manual_seed(1))


def train_phase(torch, ck, tag, tmp):
    """The noaug training path.  Returns the kernels' launch counts of its cli.train run."""
    out, launches = run_cli_train(torch, ck, tag, tmp, "training", ["--aug", "noaug"])
    batch = train_batch(torch)
    step_times(torch, out, batch, tag, "training")
    profile_steps(torch, ck, out, batch, tag, "training", down2_classes=True)
    torch.backends.cudnn.allow_tf32 = False
    return launches


def ada_controller(torch, records, cfg):
    """Progress/augment_p of each step by the controller's arithmetic (float32,
    from the run's D(real) signs): every `interval` steps p moves by
    sign(mean sign - target) * batch * interval / (kimg * 1000), not below 0."""
    f32 = torch.float32
    p, total, count, out = torch.tensor(cfg.ada.initial_p, dtype=f32), torch.zeros((), dtype=f32), 0.0, []
    for i, r in enumerate(records):
        total, count = total + torch.tensor(r["Loss/signs/real"], dtype=f32), count + 1.0
        if (i + 1) % cfg.ada.interval == 0:
            adjust = torch.sign(total / max(count, 1.0) - cfg.ada.target) * (
                (cfg.batch_size * cfg.ada.interval) / (cfg.ada.kimg * 1000.0))
            p, total, count = (p + adjust).clamp_min(0.0), torch.zeros((), dtype=f32), 0.0
        out.append(float(p))
    return out


def pipe_times(torch, pipe, tag):
    """The ADA pipe's own time per call at the step's shapes: forward over the
    96 stacked images of Dmain, forward and backward over Gmain's 64 and over
    R1's 32 (float32 images, as G gives them); device ms from torch.profiler,
    wall ms from CUDA events.  Returns {label: device ms}."""
    gen = torch.Generator().manual_seed(0)
    res = {}
    for label, n, backward in (("Dmain fwd", 3 * TRAIN_BATCH, False), ("Gmain fwd+bwd", 2 * TRAIN_BATCH, True),
                               ("R1 fwd+bwd", TRAIN_BATCH, True)):
        x = (torch.rand((n, 256, 256, 3), device="cuda") * 2 - 1).requires_grad_(backward)
        cot = torch.randn((n, 256, 256, 3), device="cuda")

        def run():
            y = pipe(x, ADA_P, gen)
            if backward:
                torch.autograd.grad(y, x, cot)

        device_ms, n_ops, top = device_profile(torch, run, iters=3, top=4)
        wall_ms = cuda_time_ms(torch, run, iters=5, warmup=1)[1]
        res[label] = device_ms
        print(f"ADA pipe {label} over {n} images: device {device_ms:.2f} ms, {n_ops:.0f} device ops, "
              f"CUDA events {wall_ms:.2f} ms (median of 5) [{tag}]; top: "
              + "; ".join(f"{op[:60]} {ms:.2f} ms" for op, ms, _ in top), flush=True)
    return res


def train_ada_phase(torch, ck, tag, tmp):
    """The training_ada path: cli.train --aug ada from p = ADA_P (bgc pipe,
    two-pass warp, stacked D calls), then one --ada_exact_geom run of three steps
    (D calls one by one).  Returns the launch counts of the --aug ada run."""
    out, launches = run_cli_train(torch, ck, tag, tmp, "training_ada", ["--aug", "ada", "--p", str(ADA_P)])
    trainer, records = out["trainer"], out["records"]
    cfg = trainer.config
    assert cfg.ada.enabled and cfg.ada.pipe == "bgc" and cfg.ada.fast_geom and cfg.ada.stack_calls
    expected = ada_controller(torch, records, cfg)
    got = [r["Progress/augment_p"] for r in records]
    assert all(abs(a - b) <= 1e-7 for a, b in zip(got, expected)), f"augment p {got}, controller gives {expected}"
    print(f"training_ada augment p by step {got} (controller: {expected}); D(real) signs "
          f"{[r['Loss/signs/real'] for r in records]} [{tag}]", flush=True)
    batch = train_batch(torch)
    step_times(torch, out, batch, tag, "training_ada")
    prof = profile_steps(torch, ck, out, batch, tag, "training_ada")
    pipe = pipe_times(torch, trainer.augment_fn, tag)
    main_dev = prof["Gmain+Dmain"][0]
    if main_dev:
        share = (pipe["Dmain fwd"] + pipe["Gmain fwd+bwd"]) / main_dev
        print(f"ADA pipe share of a Gmain+Dmain step's device time (Dmain fwd + Gmain fwd+bwd over the profiled "
              f"step): {share:.3f} [{tag}]", flush=True)
    del out, trainer, batch
    torch.cuda.empty_cache()

    from pasta_gan_tpu_torch.cli import train as cli_train

    torch.cuda.reset_peak_memory_stats()
    try:
        ex = cli_train.main(["--outdir", os.path.join(tmp, "runs"), "--synthetic", "32", "--batch", str(TRAIN_BATCH),
                             "--dtype", "bfloat16", "--seed", "0", "--kimg", str(3 * TRAIN_BATCH / 1000),
                             "--aug", "ada", "--p", str(ADA_P), "--ada_exact_geom", "--img_snap", "0"])
        torch.cuda.synchronize()
        r = ex["records"]
        assert not ex["trainer"].config.ada.stack_calls and not ex["trainer"].config.ada.fast_geom
        assert all(math.isfinite(v) for rec in r for v in rec.values())
        main_ms = [rec["Timing/Gmain_Dmain"] * 1e3 for rec in r[1:]]
        print(f"training_ada --ada_exact_geom (D calls one by one): Gmain+Dmain steps 2-3 "
              f"{', '.join(f'{t:.1f}' for t in main_ms)} ms (step 1 with "
              f"warm-up {r[0]['Timing/Gmain_Dmain'] * 1e3:.1f} ms, its R1 {r[0]['Timing/Dreg'] * 1e3:.1f} ms); peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated [{tag}]", flush=True)
        del ex
    except torch.cuda.OutOfMemoryError as e:
        print(f"training_ada --ada_exact_geom does not fit in the card's memory at batch {TRAIN_BATCH}: "
              f"{str(e).splitlines()[0]} [{tag}]", flush=True)
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    return launches


def train_reg_phase(torch, ck, tag, tmp):
    """The training_reg path: cli.train at full width with Greg (`--pl_weight
    2`, every 4 steps from the first, on the first 16 samples of the batch)
    and the contextual loss (`--contextual_weight 1`, the He-initialized
    VGG19), `--aug noaug`, REG_STEPS steps at batch 32, no grids.  Greg's
    stats must be finite and pl_mean must move (run_cli_train checks the
    rest).  Prints Gmain+Dmain with the contextual loss, Greg and R1 (each
    run again, timed with a synchronise), the contextual loss's device ms
    (one Gmain under torch.profiler with and without it), its relu1_2
    affinity term at batch 4 against its matmul bound, and one Greg step's
    launches, peak memory and FIR classes, each class held to its plain
    version (Greg's double backward gives up2 and down2 pads and extends that
    the forward never launches).  Returns the launch counts of the run."""
    import copy

    from pasta_gan_tpu_torch.runtime.config import replace_nested
    from pasta_gan_tpu_torch.train.losses import contextual_loss

    out, launches = run_cli_train(torch, ck, tag, tmp, "training_reg", REG_ARGV, grids=False, steps=REG_STEPS)
    trainer, state, records = out["trainer"], out["state"], out["records"]
    cfg = trainer.config
    assert cfg.loss.pl_weight == 2 and cfg.loss.contextual_weight == 1 and trainer.vgg is not None
    greg_steps = [i for i, r in enumerate(records) if "Timing/Greg" in r]
    assert greg_steps == list(range(0, REG_STEPS, cfg.g_reg_interval)), f"Greg ran at steps {greg_steps}"
    pl_mean = float(state.pl_mean)
    assert math.isfinite(pl_mean) and pl_mean != 0.0, f"pl_mean did not move: {pl_mean}"
    assert all(r["Loss/G/contextual"] > 0 for r in records)
    med = statistics.median
    main_ms = [r["Timing/Gmain_Dmain"] * 1e3 for r in records[1:]]
    data_ms = [r["Timing/data"] * 1e3 for r in records[1:]]
    greg_run = [records[i]["Timing/Greg"] * 1e3 for i in greg_steps]
    print(f"training_reg (full width, batch {TRAIN_BATCH}, bf16, contextual loss on, Greg at steps {greg_steps}): "
          f"Gmain+Dmain median {med(main_ms):.1f} ms (steps 2-{REG_STEPS}: {', '.join(f'{t:.1f}' for t in main_ms)}; "
          f"step 1 {records[0]['Timing/Gmain_Dmain'] * 1e3:.1f}); Greg in the run "
          f"{', '.join(f'{t:.1f}' for t in greg_run)} ms; R1 in the run "
          f"{records[0]['Timing/Dreg'] * 1e3:.1f} ms; pl_penalty {[records[i]['Loss/pl_penalty'] for i in greg_steps]}, "
          f"pl_mean {pl_mean:.6g}; contextual {[round(r['Loss/G/contextual'], 4) for r in records]} [{tag}]", flush=True)

    batch = train_batch(torch)
    greg_ms, r1_ms = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, st = trainer.g_pl_step(state, batch)
        float(st["Loss/G/reg"])
        greg_ms.append((time.perf_counter() - t0) * 1e3)
        assert all(math.isfinite(float(v)) for v in st.values()), st
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, st = trainer.d_r1_step(state, batch)
        float(st["Loss/r1_penalty"])
        r1_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    trainer.g_pl_step(state, batch)
    torch.cuda.synchronize()
    greg_launches, greg_peak = ck.launch_counts(), torch.cuda.max_memory_allocated() / 1e9
    assert greg_launches["up2"] > 0 and greg_launches["down2"] > 0, f"Greg launched {greg_launches}"
    step_ms = med(data_ms) + med(main_ms) + med(greg_ms) / cfg.g_reg_interval + med(r1_ms) / cfg.d_reg_interval
    print(f"training_reg Greg (batch {TRAIN_BATCH // cfg.loss.pl_batch_shrink} of {TRAIN_BATCH}): "
          f"{', '.join(f'{t:.1f}' for t in greg_ms)} ms; R1 {', '.join(f'{t:.1f}' for t in r1_ms)} ms; one Greg step's "
          f"launches {greg_launches}, peak {greg_peak:.2f} GB allocated; sec/kimg {step_ms / TRAIN_BATCH:.3f} (data + "
          f"Gmain+Dmain + Greg/{cfg.g_reg_interval} + R1/{cfg.d_reg_interval}, medians) [{tag}]", flush=True)
    classes = fir_classes_equal(torch, lambda: trainer.g_pl_step(state, batch), "training_reg Greg", tag)
    assert {k[:2] for k in classes} >= {("up2", 0), ("up2", 1), ("down2", 0), ("down2", 1)}, sorted(classes)

    # the contextual loss's share of one Gmain: the same Gmain with and without it
    g_params = list(state.G.parameters())
    plain = copy.copy(trainer)
    plain.config = replace_nested(cfg, **{"loss.contextual_weight": 0.0})
    gmain = {}
    for label, t in (("with", trainer), ("without", plain)):
        gmain[label] = device_profile(torch, lambda: t._grads_with_accum(
            lambda b: t.g_loss_fn(state.G, state.D, b), g_params, batch), iters=1, top=8)
    (dev_with, ops_with, top), (dev_without, ops_without, _) = gmain["with"], gmain["without"]
    ctx_ms = None if dev_with is None or dev_without is None else dev_with - dev_without
    print(f"training_reg one Gmain (batch {TRAIN_BATCH}) under torch.profiler: device "
          f"{'not measured' if dev_with is None else f'{dev_with:.1f} ms'} with the contextual loss, "
          f"{'not measured' if dev_without is None else f'{dev_without:.1f} ms'} without; the contextual loss "
          f"{'not measured' if ctx_ms is None else f'{ctx_ms:.1f} device ms'}; {ops_with:.0f} against "
          f"{ops_without:.0f} device ops [{tag}]", flush=True)
    for op, op_ms, n in top:
        print(f"    {op_ms:9.3f} ms {n:7.1f}x  {op[:100]}", flush=True)

    # the relu1_2 affinity term alone, forward and backward, at batch 4 (its cost is linear in the batch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, hw, c = 4, 256 * 256, 64
    fx = torch.relu(torch.randn((n, 256, 256, c), generator=gen, device="cuda")).requires_grad_(True)
    fy = torch.relu(torch.randn((n, 256, 256, c), generator=gen, device="cuda"))
    fwd_ms = cuda_time_ms(torch, lambda: contextual_loss(fx, fy), iters=2, warmup=1)[1]
    both_ms = cuda_time_ms(torch, lambda: torch.autograd.grad(contextual_loss(fx, fy), fx), iters=1, warmup=1)[1]
    bound_fwd = n * 2 * hw * hw * c / PEAK_FP32_FLOPS * 1e3
    print(f"contextual_loss at relu1_2 ([{n}, 256, 256, {c}] fp32, H*W = {hw}): forward {fwd_ms:.1f} ms, forward + "
          f"backward {both_ms:.1f} ms (CUDA events, median of 2, one); {fwd_ms / n:.2f} / {both_ms / n:.2f} ms a sample; "
          f"bound (the affinity products at {PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s fp32) {bound_fwd:.1f} / "
          f"{2 * bound_fwd:.1f} ms [{tag}]", flush=True)
    del fx, fy, out, trainer, state, batch, plain, g_params
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    return launches


def contextual_card_vs_cpu(torch, tag):
    """`contextual_loss` on one relu1_2-sized pair ([1, 256, 256, 64], fp32,
    TF32 off) on the card against the CPU: its 64 chunks of 1024 query rows
    at the real H*W, within LOSS_RTOL."""
    from pasta_gan_tpu_torch.train.losses import contextual_loss

    g = torch.Generator().manual_seed(0)
    x, y = (torch.relu(torch.randn((1, 256, 256, 64), generator=g)) for _ in range(2))
    t0 = time.perf_counter()
    v_cpu = float(contextual_loss(x, y))
    cpu_s = time.perf_counter() - t0
    v_gpu = float(contextual_loss(x.cuda(), y.cuda()))
    rel = abs(v_gpu - v_cpu) / abs(v_cpu)
    print(f"contextual_loss card vs CPU ([1, 256, 256, 64] fp32): card {v_gpu:.8g}, CPU {v_cpu:.8g} (CPU {cpu_s:.1f} "
          f"s), relative {rel:.3g} (limit {LOSS_RTOL}) [{tag}]", flush=True)
    assert math.isfinite(v_gpu) and rel <= LOSS_RTOL, f"contextual_loss on the card differs: {v_gpu} vs {v_cpu}"


def array_digest(a):
    """Shape, dtype and sha256 of an array's values, as MANIFEST.json records
    them (a boolean array hashed as 0/1 bytes)."""
    import hashlib

    import numpy as np

    a = np.asarray(a)
    raw = np.ascontiguousarray(a.astype(np.uint8) if a.dtype == bool else a)
    return {"shape": list(a.shape), "dtype": str(a.dtype), "sha256": hashlib.sha256(raw.tobytes()).hexdigest()}


def median_ms(fn, args_list, reps=3):
    """Median wall ms of fn(*args) over every args of the list, `reps` times each."""
    ts = []
    for args in args_list:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(*args)
            ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def real_data_phase(torch, ck, tag, tmp):
    """The real-data paths on the fixture tree: every decoded file and every
    `load_sample` record against MANIFEST.json's digests (PIL's and the JAX
    package's arrays); host times of decoding, the stickman, the masks,
    load_sample and the loader; `cli.test --dataroot` with the Full snapshot
    of the serving phase (`serving_real`) and imgs/s with and without the
    host loading; `cli.train --data` (`training_real`) with a snapshot inside
    the run and one at its end.  Returns the two paths' launch counts."""
    import numpy as np

    from pasta_gan_tpu_torch.cli import test as cli
    from pasta_gan_tpu_torch.data import dataset as tds
    from pasta_gan_tpu_torch.data import image_io, masks, stickman
    from pasta_gan_tpu_torch.train import loop

    root = fixture_root()
    with open(os.path.join(root, "MANIFEST.json")) as f:
        man = json.load(f)

    # ---- every fixture array against the manifest
    bad = [rel for rel, d in man["files"].items() if array_digest(image_io.read_image(os.path.join(root, rel))) != d]
    bad += [rel for rel, d in man["acgpn_l256"].items()
            if array_digest(image_io.read_l_resized(os.path.join(root, rel), (256, 256))) != d]
    records = []
    for key, want in sorted(man["records"].items()):
        ds, person = key.split("/")
        rec = tds.record_paths(root, ds, person, ".png" if ds == "MPV_256_192" else "_label.png")
        records.append(rec)
        got = {k: array_digest(v) for k, v in tds.load_sample(*rec).items()}
        bad += [f"{key} {k}" for k in sorted(set(want) | set(got)) if got.get(k) != want.get(k)]
    for key, want in sorted(man["records_512"].items()):
        got = {k: array_digest(v) for k, v in tds.load_sample(*tds.record_paths(root, *key.split("/")),
                                                                 size=(512, 320)).items()}
        bad += [f"{key} {k}" for k in sorted(set(want) | set(got)) if got.get(k) != want.get(k)]
    assert not bad, f"arrays that differ from MANIFEST.json: {bad}"
    n_arrays = sum(len(v) for v in man["records"].values())
    print(f"real_data: {len(man['files'])} decoded files, {len(man['acgpn_l256'])} resized ACGPN masks, "
          f"{len(records)} load_sample records ({n_arrays} arrays) and {len(man['records_512'])} 512x320 records "
          f"equal MANIFEST.json's digests [{tag}]", flush=True)

    # ---- host times on this machine's CPU, medians over the fixture's 256x192 files
    files_256 = [rel for rel in man["files"] if "_512_320" not in rel]
    jpgs = [(os.path.join(root, rel),) for rel in files_256 if rel.endswith(".jpg")]
    pngs = [(os.path.join(root, rel),) for rel in files_256 if rel.endswith(".png")]
    mask_args = []
    for _, kpt, par in records:
        parsing = image_io.read_image(par)
        parsing, left = tds.pad_to_square((parsing[..., 0] if parsing.ndim == 3 else parsing).astype(np.uint8), 0)
        kps = stickman.load_keypoints(kpt)
        kps[:, 0] += left
        mask_args.append((kps, parsing))
    host = {
        "JPEG decode (read_rgb)": median_ms(image_io.read_rgb, jpgs),
        "PNG decode (read_image)": median_ms(image_io.read_image, pngs),
        "keypoints + stickman": median_ms(lambda k: stickman.draw_pose_from_cords(stickman.load_keypoints(k), (256, 192)),
                                          [(kpt,) for _, kpt, _ in records]),
        "masks (build_sample_masks)": median_ms(masks.build_sample_masks, mask_args),
        "load_sample": median_ms(tds.load_sample, records),
    }
    print("real_data host ms a sample (median over the fixture, this machine's CPU): "
          + ", ".join(f"{k} {v:.3f}" for k, v in host.items()) + f" [{tag}]", flush=True)
    train_ds = tds.UvitonDatasetFull(root)
    for workers in (1, 3):
        t0 = time.perf_counter()
        with loop.InfiniteLoader(train_ds, TRAIN_BATCH, seed=0, num_workers=workers) as loader:
            next(loader)
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(5):
                next(loader)
            ms = (time.perf_counter() - t0) * 1e3 / 5
        print(f"real_data InfiniteLoader batch {TRAIN_BATCH}, {workers} worker process(es): first batch after "
              f"{first_s:.2f} s (start-up included), then {ms:.1f} ms a batch over 5 batches [{tag}]", flush=True)

    # ---- serving the fixture's test pairs with the Full snapshot of the serving phase
    snap = os.path.join(tmp, "snapshot.pt")
    launches_s, written = serve(torch, cli, ck, tag, "serving_real",
                                ["--network", snap, "--outdir", os.path.join(tmp, "tryon_real")], data=("--dataroot", root))
    with open(os.path.join(root, "UPT_subset1_256_192", "test_pairs_front_list_shuffle_0508.txt")) as f:
        names = [f"{a.split('.')[0]}__{b.split('.')[0]}.png" for a, b in (line.split() for line in f)]
    assert [os.path.basename(p) for p in written] == names, "served file names do not follow the JAX rule"
    test_ds = tds.UvitonDataset256Test(root)
    gen, w_avg = cli.load_generator(snap, torch.device("cuda"))
    gen.set_dtype(torch.bfloat16)

    def load16():
        pairs = [test_ds[i] for i in range(16)]
        return tds.collate([p["person"] for p in pairs]), tds.collate([p["garment"] for p in pairs])

    def tryon(person, garment):
        b = tds.prepare_tryon_batch(person, garment, device="cuda")
        return cli.tryon_forward(gen, w_avg, {k: v.to(torch.bfloat16) for k, v in b.items()})

    loaded = load16()
    with_ms, out = host_ms(torch, lambda: tryon(*load16()), 5)
    assert tuple(out.shape) == (16, 256, 256, 3) and bool(torch.isfinite(out.float()).all())
    pre_ms, _ = host_ms(torch, lambda: tryon(*loaded), 10)
    print(f"real_data try-on (Full, bf16, batch 16, fixture pairs): host loading included {with_ms:.2f} ms, "
          f"{16 / with_ms * 1e3:.1f} imgs/s (median of 5); loaded beforehand {pre_ms:.2f} ms, "
          f"{16 / pre_ms * 1e3:.1f} imgs/s (median of 10) [{tag}]", flush=True)
    del gen, out

    # ---- training on the fixture: a snapshot inside the run (tick 2, --snap 2) and one at its end
    saves, save = [], loop._save_snapshot

    def counted(run_dir, state, config, cur_nimg, verbose):
        saves.append((state.step, os.path.join(run_dir, f"network-snapshot-{cur_nimg // 1000:06d}.pt")))
        return save(run_dir, state, config, cur_nimg, verbose)

    loop._save_snapshot = counted
    try:
        out, launches_t = run_cli_train(
            torch, ck, tag, tmp, "training_real",
            ["--aug", "noaug", "--workers", "3", "--kimg_per_tick", str(TRAIN_BATCH / 1000), "--snap", "2"],
            data=("--data", root), n_samples=len(tds.UvitonDatasetFull(root)), grids=False)
    finally:
        loop._save_snapshot = save
    torch.backends.cudnn.allow_tf32 = False
    assert [step for step, _ in saves] == [3, TRAIN_STEPS], f"snapshots saved at steps {[s for s, _ in saves]}"
    assert all(os.path.exists(p) for _, p in saves)
    assert os.path.exists(os.path.join(out["run_dir"], "train-state-latest.pt"))
    recs = out["records"]
    for i, r in enumerate(recs):
        r1 = f", R1 {r['Timing/Dreg'] * 1e3:.1f} ms" if "Timing/Dreg" in r else ""
        print(f"training_real step {i + 1}: Timing/data {r['Timing/data'] * 1e3:.1f} ms (loader wait + routing), "
              f"Gmain+Dmain {r['Timing/Gmain_Dmain'] * 1e3:.1f} ms{r1} [{tag}]", flush=True)
    data_ms = statistics.median(r["Timing/data"] * 1e3 for r in recs[1:])
    main_ms = statistics.median(r["Timing/Gmain_Dmain"] * 1e3 for r in recs[1:])
    print(f"training_real: median Timing/data {data_ms:.1f} ms against Gmain+Dmain {main_ms:.1f} ms (steps 2-"
          f"{TRAIN_STEPS}); snapshots at steps {[s for s, _ in saves]} [{tag}]", flush=True)
    return {"serving_real": launches_s, "training_real": launches_t}


def fir_classes(torch, fn):
    """Run fn() once more and count its up2 and down2 launches by (kernel,
    extend or pad, dtype, input shape), through counting wrappers around the
    module's launch helpers that are removed again before returning; the
    package itself is unchanged."""
    from collections import Counter

    from pasta_gan_tpu_torch.ops import upfirdn_kernels as uk

    hist, up, down = Counter(), uk._up2_apply, uk._down2_apply

    def counted(kind, launch):
        def run(x, arg, gain):
            hist[(kind, arg, str(x.dtype)[6:], tuple(x.shape))] += 1
            return launch(x, arg, gain)
        return run

    uk._up2_apply, uk._down2_apply = counted("up2", up), counted("down2", down)
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        uk._up2_apply, uk._down2_apply = up, down
    return hist


def fir_classes_equal(torch, fn, label, tag):
    """Count fn()'s up2/down2 launches by class (`fir_classes`) and hold each
    class to its plain version at max abs error 0; returns the classes."""
    classes = fir_classes(torch, fn)
    g = torch.Generator(device="cuda").manual_seed(0)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    errs = {k: fir_check(torch, g, k[0], k[1], dtypes[k[2]], k[3])[3] for k in sorted(classes)}
    print(f"{label}: FIR launches by (kernel, extend or pad, dtype, input shape), {sum(classes.values())} in "
          f"{len(classes)} classes, each against its plain version (max abs error): "
          + ", ".join(f"{k}: {n}x {errs[k]:.3g}" for k, n in sorted(classes.items())) + f" [{tag}]", flush=True)
    assert all(e == 0.0 for e in errs.values()), errs
    return classes


def last_tick_sec_per_kimg(run_dir):
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        return json.loads(f.read().splitlines()[-1])["Timing/sec_per_kimg"]


def train_card_vs_cpu(torch, tag, label="noaug", ada=None, reg=False):
    """One fp32 training step (Gmain and Dmain gradients, train_step, d_r1_step)
    at a thin width (channel_base 512, channel_max 32, batch 4, noise off,
    no VGG, Adam eps 1e-3 as in tests/test_torch_train.py) on the card against
    the port's CPU path, from the same weights and the same batch.  `ada`:
    None (no pipe), "debug" (the bgc pipe at debug percentile 0.3 on both
    sides) or "random" (the bgc pipe from p = ADA_P; both trainers draw on
    the host from the same seed, so both get the same draws).  Fast geometry,
    stacked D calls.  Dmain runs on the G that Gmain updated (D's condition
    comes from G), and the two sides' G updates differ by ~3e-4 of the step,
    which moves D(real)'s mean score by ~2e-4 of itself on an H100 (under
    random ADA draws, and without ADA on the stickman-repaired synthetic
    batch): so Dmain's stats are compared from the gradient pass on the same
    weights, R1 runs from the same state on both sides, and the steps
    themselves are held to STEP_REL_L2.

    `reg`: the same step with z_dim 8 and style mixing at probability 1
    (both trainers draw z, the mixing z and the cutoff on the host from the
    same seed) and the contextual loss (weight 1, a He-initialized VGG19
    carried to both sides, taps relu3_2 ... relu5_2: the relu1_2 and relu2_2
    terms' 65536 x 65536 and 16384 x 16384 affinities a sample take minutes
    on the CPU, and `contextual_card_vs_cpu` holds the relu1_2 size), then
    one Greg step
    (z_dim 0, pl_weight 2, one pl_noise on both sides) from the same state:
    its stats and pl_mean within LOSS_RTOL, G's step within STEP_REL_L2."""
    import copy

    from pasta_gan_tpu_torch.runtime.config import from_preset, replace_nested
    from pasta_gan_tpu_torch.train import vgg as tvgg

    base = replace_nested(from_preset("fashion", batch=4), **{
        "model.channel_base": 512, "model.channel_max": 32, "model.use_noise": False, "loss.vgg_weight": 0.0,
        "ada.enabled": ada is not None, "ada.initial_p": ADA_P, "g_opt.eps": 1e-3, "d_opt.eps": 1e-3})
    cfg, vgg, taps = base, (None, None), tvgg.CONTEXTUAL_TAPS
    if reg:
        cfg = replace_nested(base, **{"model.z_dim": 8, "loss.style_mixing_prob": 1.0, "loss.contextual_weight": 1.0})
        vgg_cpu = tvgg.init_vgg19(torch.Generator().manual_seed(0), "cpu")
        vgg = (vgg_cpu, copy.deepcopy(vgg_cpu).cuda())
        tvgg.CONTEXTUAL_TAPS = taps[2:]
    try:
        _card_vs_cpu_steps(torch, tag, label, cfg, ada, vgg)
    finally:
        tvgg.CONTEXTUAL_TAPS = taps
    if reg:
        _card_vs_cpu_greg(torch, tag, replace_nested(base, **{"loss.pl_weight": 2.0}))


def _card_vs_cpu_greg(torch, tag, cfg):
    """One Greg step on the card and on the CPU from the same state and pl_noise (see train_card_vs_cpu)."""
    import copy

    from pasta_gan_tpu_torch.data.dataset import SyntheticUvitonDataset, collate, erasure_draws, prepare_train_batch
    from pasta_gan_tpu_torch.train.step import GANTrainer

    ds = SyntheticUvitonDataset(num_samples=4, seed=5)
    b_cpu = prepare_train_batch(collate([ds[i] for i in range(4)]), device="cpu",
                                draws=erasure_draws(4, torch.Generator().manual_seed(2)))
    tc, tg = GANTrainer(cfg, device="cpu"), GANTrainer(cfg, device="cuda")
    sc = tc.init_state(torch.Generator().manual_seed(1))
    sg = tg.init_state(G=copy.deepcopy(sc.G), D=copy.deepcopy(sc.D))
    sc.pl_mean.fill_(0.05)
    sg.pl_mean.fill_(0.05)
    n = 4 // cfg.loss.pl_batch_shrink
    noise = torch.randn((n, 256, 256, 3), generator=torch.Generator().manual_seed(3)) / 256.0
    before = {k: v.clone() for k, v in sc.G.state_dict().items()}
    sc, st_c = tc.g_pl_step(sc, b_cpu, pl_noise=noise)
    sg, st_g = tg.g_pl_step(sg, {k: v.cuda() for k, v in b_cpu.items()}, pl_noise=noise.cuda())
    for k, v in {**st_c, "pl_mean": sc.pl_mean}.items():
        card = float(sg.pl_mean if k == "pl_mean" else st_g[k])
        assert abs(card - float(v)) <= LOSS_RTOL * abs(float(v)) + 1e-6, f"Greg {k}: card {card} vs CPU {float(v)}"
    sd_c, sd_g = sc.G.state_dict(), sg.G.state_dict()
    dc = torch.cat([(sd_c[k] - before[k]).flatten() for k in sorted(sd_c)])
    dg = torch.cat([(sd_g[k].cpu() - before[k]).flatten() for k in sorted(sd_c)])
    err = float((dg - dc).norm() / dc.norm())
    print(f"card vs CPU Greg step (fp32, thin, batch 4 -> {n}, pl_mean 0.05): pl_penalty card "
          f"{float(st_g['Loss/pl_penalty']):.6g} CPU {float(st_c['Loss/pl_penalty']):.6g}, pl_mean card "
          f"{float(sg.pl_mean):.6g} CPU {float(sc.pl_mean):.6g}, G step relative L2 {err:.3g} (limit {STEP_REL_L2}) "
          f"[{tag}]", flush=True)
    assert err <= STEP_REL_L2, f"Greg's G step on the card differs from the CPU's: {err}"


def _card_vs_cpu_steps(torch, tag, label, cfg, ada, vgg):
    """The step comparison of train_card_vs_cpu for config `cfg`; `vgg`: (CPU, card) networks or Nones."""
    import copy

    from pasta_gan_tpu_torch.data.dataset import SyntheticUvitonDataset, collate, erasure_draws, prepare_train_batch
    from pasta_gan_tpu_torch.train.augment import AugmentPipe
    from pasta_gan_tpu_torch.train.step import GANTrainer

    augment_fn = None
    if ada == "debug":
        pipe = AugmentPipe.from_spec("bgc", fast_geom=True)
        augment_fn = lambda im, p, gen: pipe(im, p, gen, debug_percentile=0.3)  # noqa: E731
    ds = SyntheticUvitonDataset(num_samples=4, seed=5)
    b_cpu = prepare_train_batch(collate([ds[i] for i in range(4)]), device="cpu",
                                draws=erasure_draws(4, torch.Generator().manual_seed(2)))
    b_gpu = {k: v.cuda() for k, v in b_cpu.items()}
    tc = GANTrainer(cfg, vgg=vgg[0], device="cpu", augment_fn=augment_fn)
    tg = GANTrainer(cfg, vgg=vgg[1], device="cuda", augment_fn=augment_fn)
    sc = tc.init_state(torch.Generator().manual_seed(1))
    sg = tg.init_state(G=copy.deepcopy(sc.G), D=copy.deepcopy(sc.D))

    def close(k, card, cpu):
        assert abs(card - cpu) <= LOSS_RTOL * abs(cpu) + 1e-6, f"{label} {k}: card {card} vs CPU {cpu}"

    worst = 0.0
    p = float(sc.ada_p)
    g_keys = []
    for fn in (lambda t, s: (lambda b: t.g_loss_fn(s.G, s.D, b, p), list(s.G.parameters())),
               lambda t, s: (lambda b: t.d_loss_fn(s.D, s.G, b, p), list(s.D.parameters()))):
        (lc, pc), (lg, pg) = fn(tc, sc), fn(tg, sg)
        gc, st_c = tc._grads_with_accum(lc, pc, b_cpu)
        gg, st_g = tg._grads_with_accum(lg, pg, b_gpu)
        g_keys = g_keys or list(st_c)
        for k, v in st_c.items():
            if v.ndim == 0:
                close(k, float(st_g[k]), float(v))
        floor = 1e-6 * max(float(g.norm()) for g in gc)
        for a, b in zip(gg, gc):
            # a gradient that vanishes in exact arithmetic (a bias in front of an
            # InstanceNorm) is held to the floor, the others to GRAD_REL_L2
            err, allowed = float((a.cpu() - b).norm()), GRAD_REL_L2 * float(b.norm()) + floor
            assert err <= allowed, f"{label}: gradient on the card differs: {err} vs {float(b.norm())}"
            worst = max(worst, err / allowed)

    before = {n: {k: v.clone() for k, v in getattr(sc, n).state_dict().items()} for n in ("G", "D")}
    stats, r1_states = [], []
    for t, s, b in ((tc, sc, b_cpu), (tg, sg, b_gpu)):
        r1_state, r1 = t.d_r1_step(copy.deepcopy(s), b)
        r1_states.append(r1_state)
        s, st = t.train_step(s, b)
        st = {k: v for k, v in st.items() if k in g_keys or k == "Progress/augment_p"}
        stats.append({k: float(v) for k, v in {**st, **r1}.items()})
    for k, v in stats[0].items():
        close(k, stats[1][k], v)
    pairs = [("G", sc.G, sg.G), ("D", sc.D, sg.D), ("D by R1", r1_states[0].D, r1_states[1].D)]
    step_errs = {}
    for name, m_c, m_g in pairs:
        ref, sd_c, sd_g = before[name[0]], m_c.state_dict(), m_g.state_dict()
        dc = torch.cat([(sd_c[k] - ref[k]).flatten() for k in sorted(sd_c)])
        dg = torch.cat([(sd_g[k].cpu() - ref[k]).flatten() for k in sorted(sd_c)])
        step_errs[name] = float((dg - dc).norm() / dc.norm())
        assert step_errs[name] <= STEP_REL_L2, f"{label}: {name} step on the card differs from the CPU's: {step_errs[name]}"
    print(f"card vs CPU training step, {label} (fp32, thin, batch 4): worst gradient difference {worst:.3g} of its "
          f"allowance ({GRAD_REL_L2} relative L2, or 1e-6 of the largest gradient's norm), step relative L2 "
          f"{', '.join(f'{k} {v:.3g}' for k, v in step_errs.items())} (limit {STEP_REL_L2}), r1 penalty card "
          f"{stats[1]['Loss/r1_penalty']:.6g} CPU {stats[0]['Loss/r1_penalty']:.6g}"
          + (f", contextual card {stats[1]['Loss/G/contextual']:.6g} CPU {stats[0]['Loss/G/contextual']:.6g}"
             if cfg.loss.contextual_weight > 0 else "") + f" [{tag}]", flush=True)


def random_detectors(torch, tmp):
    """Detector files with random weights under torchvision's names, drawn
    from a seeded generator: an InceptionV3 with He-normal convs and
    randomized BN statistics (folded at load), and a VGG16 with He-normal
    weights and LPIPS heads.  He scaling keeps the 2048-d features varying
    between images, so an FID of them is not rounding noise.  Returns the two
    paths."""
    from pasta_gan_tpu_torch.metrics import vgg16 as tvgg
    from pasta_gan_tpu_torch.metrics.inception import BasicConv2d, InceptionV3Features

    g = torch.Generator().manual_seed(0)

    def he(shape):
        fan_in = math.prod(shape[1:])
        return torch.randn(shape, generator=g) * math.sqrt(2.0 / fan_in)

    inc = {}
    for name, m in InceptionV3Features(device="cpu").named_modules():
        if isinstance(m, BasicConv2d):
            c = m.weight.shape[0]
            inc[f"{name}.conv.weight"] = he(m.weight.shape)
            inc[f"{name}.bn.weight"] = torch.rand(c, generator=g) + 0.5
            inc[f"{name}.bn.bias"] = torch.randn(c, generator=g) * 0.1
            inc[f"{name}.bn.running_mean"] = torch.randn(c, generator=g) * 0.1
            inc[f"{name}.bn.running_var"] = torch.rand(c, generator=g) + 0.5
    vgg, c_in = {}, 3
    for i, c in zip(tvgg._CONV_IDX, [c for c in tvgg._PLAN if c != "M"]):
        vgg[f"features.{i}.weight"], vgg[f"features.{i}.bias"] = he((c, c_in, 3, 3)), torch.randn(c, generator=g) * 0.01
        c_in = c
    for j, shape in ((0, (4096, 512 * 49)), (3, (4096, 4096))):
        vgg[f"classifier.{j}.weight"], vgg[f"classifier.{j}.bias"] = he(shape), torch.randn(shape[0], generator=g) * 0.01
    for k, c in enumerate((64, 128, 256, 512, 512)):
        vgg[f"lin{k}.model.1.weight"] = torch.rand((1, c, 1, 1), generator=g)
    paths = os.path.join(tmp, "inception.pt"), os.path.join(tmp, "vgg16.pt")
    torch.save(inc, paths[0])
    torch.save(vgg, paths[1])
    return paths


def graph_flops(torch, module, x):
    """FLOPs of module(x) from its convolutions' and linear layers' shapes,
    two per multiply-add, counted by forward hooks that are removed again."""
    from pasta_gan_tpu_torch.metrics.inception import BasicConv2d

    total = [0]

    def hook(m, inputs, out):
        total[0] += 2 * out.numel() * (m.weight[0].numel() if m.weight.dim() == 4 else m.weight.shape[1])

    hooks = [m.register_forward_hook(hook) for m in module.modules()
             if isinstance(m, (BasicConv2d, torch.nn.Conv2d, torch.nn.Linear))]
    try:
        module(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def counted_flops(torch, fn):
    """FLOPs of one fn() as torch.utils.flop_counter counts them: its
    convolutions (transposed ones included) and matmuls, two per
    multiply-add; the FIR kernels' taps and elementwise work are not counted."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def check_launches(path, counts, expected):
    """The path launched exactly its kernels, each exactly `expected` times."""
    ran = {name for name, n in counts.items() if n > 0}
    assert ran == PATH_KERNELS[path], f"{path} launched {sorted(ran)}, expected {sorted(PATH_KERNELS[path])}"
    assert all(counts[k] == expected.get(k, 0) for k in counts), f"{path} launched {counts}, expected {expected}"


def run_calc_metrics(torch, ck, tag, path, argv, metrics, run_dir=None):
    """One `cli.calc_metrics.main` run with the launch counts set to 0 just
    before it and read just after: every value finite, one result a metric,
    each appended to `metric-<name>.jsonl` under `run_dir` with the printed
    keys.  Returns (results, launches)."""
    from pasta_gan_tpu_torch.cli import calc_metrics as cm

    ck.reset_launch_counts()
    t0 = time.perf_counter()
    results = cm.main(argv + ["--metrics", ",".join(metrics)] + (["--run_dir", run_dir] if run_dir else []))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ck.launch_counts()
    assert [r["metric"] for r in results] == metrics, [r["metric"] for r in results]
    for r in results:
        assert r["results"] and all(math.isfinite(v) for v in r["results"].values()), r
        if run_dir:
            with open(os.path.join(run_dir, f"metric-{r['metric']}.jsonl")) as f:
                row = json.loads(f.read().splitlines()[-1])
            assert sorted(row) == sorted(["results", "metric", "total_time", "extractor", "snapshot_pkl", "timestamp"])
    vals = "; ".join(f"{k} {v:.6g}" for r in results for k, v in r["results"].items())
    print(f"calc_metrics ({path}): {vals}; extractor {results[0]['extractor']}; {secs:.2f} s (first call, includes "
          f"loading); launches {launches} [{tag}]", flush=True)
    return results, launches


def metrics_phase(torch, ck, tag, tmp):
    """The evaluation path: `cli.calc_metrics` over the Full snapshot of the
    serving phase with random-weight detectors (`metrics_network`: FID, KID,
    PR and IS over `--synthetic` pairs; `metrics_folder`: FID of
    `serving_real`'s PNGs against the fixture's images, no kernel;
    `metrics_ppl`: ppl2_wend with the LPIPS distance), each launching
    exactly its kernels the number of times its batches give; InceptionV3,
    VGG16 and LPIPS on the card against the CPU, and FID from the card's
    features against FID from the CPU's; the detectors' rates with their
    bounds, the network source's rates, the host formulas' times on this
    machine's CPU and a projected fid50k_full wall time.  Returns the three
    paths' launch counts."""
    import numpy as np

    from pasta_gan_tpu_torch.cli import calc_metrics as cm
    from pasta_gan_tpu_torch.data import image_io
    from pasta_gan_tpu_torch.metrics import FeatureStats, formulas, lpips_distance
    from pasta_gan_tpu_torch.metrics import vgg16 as tvgg
    from pasta_gan_tpu_torch.metrics.inception import InceptionV3Features

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    inc_path, vgg_path = random_detectors(torch, tmp)
    snap = os.path.join(tmp, "snapshot.pt")
    run_dir = os.path.join(tmp, "metric_runs")
    os.makedirs(run_dir)
    launches = {}

    # ---- the three paths through the CLI
    n_batches = -(-METRICS_SYNTHETIC // METRICS_BATCH) * len(METRICS_NETWORK)
    net_res, launches["metrics_network"] = run_calc_metrics(
        torch, ck, tag, "metrics_network", ["--network", snap, "--synthetic", str(METRICS_SYNTHETIC), "--batch",
                                            str(METRICS_BATCH), "--detector", inc_path], METRICS_NETWORK, run_dir)
    assert all(r["extractor"] == "inception-torch-v1" for r in net_res)
    check_launches("metrics_network", launches["metrics_network"], {
        "norm_warp": n_batches, "composite": n_batches, "up2": FORWARD_UP2 * n_batches,
        "down2": FORWARD_DOWN2 * n_batches})
    gen_dir = os.path.join(tmp, "tryon_real")  # serving_real's 16 PNGs, 256x192
    real_dir = os.path.join(fixture_root(), "UPT_subset1_256_192", "image")
    _, launches["metrics_folder"] = run_calc_metrics(
        torch, ck, tag, "metrics_folder", ["--gen_dir", gen_dir, "--real_dir", real_dir, "--resolution", "256",
                                           "--detector", inc_path], ["fid50k_full"], run_dir)
    check_launches("metrics_folder", launches["metrics_folder"], {})
    ppl_batches = -(-PPL_SAMPLES // METRICS_BATCH)
    ppl_res, launches["metrics_ppl"] = run_calc_metrics(
        torch, ck, tag, "metrics_ppl", ["--network", snap, "--synthetic", str(PPL_SYNTHETIC), "--batch",
                                        str(METRICS_BATCH), "--ppl_samples", str(PPL_SAMPLES), "--ppl_detector",
                                        vgg_path], ["ppl2_wend"])
    assert ppl_res[0]["results"]["ppl2_wend"] > 0
    # each batch routes twice (garments i and i + 1), embeds twice and synthesizes twice
    check_launches("metrics_ppl", launches["metrics_ppl"], {
        "norm_warp": 2 * ppl_batches, "composite": 2 * ppl_batches, "up2": FORWARD_UP2 * 2 * ppl_batches,
        "down2": FORWARD_DOWN2 * 2 * ppl_batches})

    # ---- the detectors on the card against the CPU, fp32, TF32 off
    names = sorted(os.listdir(real_dir))[:8]
    reals = np.stack([image_io.read_rgb(os.path.join(real_dir, n)) for n in names])  # 8 images, 256x192
    fakes = np.stack([image_io.read_rgb(os.path.join(gen_dir, n)) for n in sorted(os.listdir(gen_dir))[:8]])
    inc = {d: InceptionV3Features.from_file(inc_path, device=d) for d in ("cuda", "cpu")}
    feats = {d: [inc[d](x).cpu().numpy() for x in (reals, fakes)] for d in inc}
    inc_err = float(np.abs(feats["cuda"][0] - feats["cpu"][0]).max() / np.abs(feats["cpu"][0]).max())
    fid, host = {}, {}  # host: ms of the formulas on this machine's CPU
    for d, (fr, fg) in feats.items():
        stats = []
        for f in (fr, fg):
            st = FeatureStats(capture_mean_cov=True)
            st.append(f)
            stats.append(st.get_mean_cov())
        t0 = time.perf_counter()
        fid[d] = formulas.fid_from_stats(*stats[0], *stats[1])
        host["fid_from_stats (2048-d)"] = (time.perf_counter() - t0) * 1e3
    fid_err = abs(fid["cuda"] - fid["cpu"]) / abs(fid["cpu"])
    vgg_sd = tvgg.load_state_dict_file(vgg_path)
    vgg = {d: tvgg.VGG16Features.from_state_dict(vgg_sd, device=d) for d in ("cuda", "cpu")}
    v = {d: vgg[d](reals).cpu().numpy() for d in vgg}
    vgg_err = float(np.abs(v["cuda"] - v["cpu"]).max() / np.abs(v["cpu"]).max())
    a, b = reals[:4].astype(np.float32), reals[4:8].astype(np.float32)
    lp = {d: lpips_distance(vgg_sd, device=d)(torch.from_numpy(a).to(d), torch.from_numpy(b).to(d)).cpu().numpy()
          for d in ("cuda", "cpu")}
    lp_err = float(np.abs(lp["cuda"] - lp["cpu"]).max() / np.abs(lp["cpu"]).max())
    print(f"metrics card vs CPU (fp32, TF32 off): InceptionV3 features of 8 images at 256x192 max abs / max |ref| "
          f"{inc_err:.3g} (limit {INCEPTION_REL}); VGG16 fc7 {vgg_err:.3g} (limit {VGG16_REL}); LPIPS of 4 pairs "
          f"relative {lp_err:.3g} (limit {LPIPS_RTOL}); FID of 8 fixture images against 8 served ones card "
          f"{fid['cuda']:.6g} CPU {fid['cpu']:.6g}, relative {fid_err:.3g} (limit {FID_RTOL}) [{tag}]", flush=True)
    assert inc_err <= INCEPTION_REL and vgg_err <= VGG16_REL and fid_err <= FID_RTOL
    np.testing.assert_allclose(lp["cuda"], lp["cpu"], rtol=LPIPS_RTOL)
    del inc["cpu"], vgg["cpu"]

    # ---- rates on the card, each beside its bound
    g = torch.Generator(device="cuda").manual_seed(0)
    x_inc = torch.randint(0, 256, (64, 256, 192, 3), generator=g, device="cuda", dtype=torch.uint8)
    x_vgg = torch.randint(0, 256, (64, 224, 224, 3), generator=g, device="cuda", dtype=torch.uint8)
    pair = [torch.rand((32, 256, 256, 3), generator=g, device="cuda") * 255 for _ in range(2)]
    lpips_model = tvgg.LPIPSFeatures.from_state_dict(vgg_sd, device="cuda")
    dist = lpips_distance(vgg_sd, device="cuda")
    rates = {}
    for name, fn, n, flops in (
            ("InceptionV3 (2048-d, batch 64, from 256x192 uint8)", lambda: inc["cuda"](x_inc), 64,
             graph_flops(torch, inc["cuda"], x_inc[:1])),
            ("VGG16 fc7 (4096-d, batch 64, 224x224)", lambda: vgg["cuda"](x_vgg), 64,
             graph_flops(torch, vgg["cuda"], x_vgg[:1])),
            ("LPIPS (32 pairs, 256x256)", lambda: dist(*pair), 32,
             2 * graph_flops(torch, lpips_model, pair[0][:1] / 127.5 - 1.0))):
        ms, _ = host_ms(torch, fn, 10)
        bound_ms = n * flops / PEAK_FP32_FLOPS * 1e3
        rates[name.split()[0]] = n / ms * 1e3
        print(f"metrics rate {name}: {ms:.2f} ms, {n / ms * 1e3:.1f} a second (median of 10); {flops / 1e9:.2f} "
              f"GFLOP each, bound {bound_ms:.2f} ms ({n / bound_ms * 1e3:.0f} a second at {PEAK_FP32_FLOPS / 1e12:.0f} "
              f"TFLOP/s fp32), {bound_ms / ms:.3f} of it [{tag}]", flush=True)
    del x_inc, x_vgg, pair, lpips_model, dist, vgg
    sources = {}
    for label, (root, n_syn) in (("--synthetic", (None, METRICS_SYNTHETIC)), ("--dataroot", (fixture_root(), 0))):
        src = cm._network_source(snap, root, n_syn, METRICS_BATCH, device="cuda")
        passes = []
        for _ in range(2):  # the first pass draws the synthetic samples and warms the card up
            t0 = time.perf_counter()
            n = sum(int(batch.shape[0]) for batch in src())
            torch.cuda.synchronize()
            passes.append(time.perf_counter() - t0)
        sources[label] = n / passes[1]
        device_ms, n_ops, top = device_profile(torch, lambda: next(src()), iters=2)  # the first batch of a pass
        b = min(n, METRICS_BATCH)
        print(f"metrics network source ({label}, batch {b}, fp32 forward, {n} pairs): {passes[1] * 1e3:.1f} ms a "
              f"pass, {sources[label]:.1f} images/s (first pass {passes[0]:.2f} s"
              f"{', host loading in the pass' if root else ''}); one batch's device time "
              f"{'not measured' if device_ms is None else f'{device_ms:.1f} ms'}, {n_ops:.0f} device ops [{tag}]",
              flush=True)
        for op, op_ms, cnt in top:
            print(f"    {op_ms:9.3f} ms {cnt:7.1f}x  {op[:100]}", flush=True)
        if root is None:
            # cuDNN's heuristics pick FFT convolutions for this fp32 forward; what would autotuning pick?
            torch.backends.cudnn.benchmark = True
            try:
                for _ in range(2):  # the first pass tunes
                    t0 = time.perf_counter()
                    sum(int(batch.shape[0]) for batch in src())
                    torch.cuda.synchronize()
                tuned = time.perf_counter() - t0
            finally:
                torch.backends.cudnn.benchmark = False
            print(f"metrics network source ({label}) with cudnn.benchmark on (TF32 still off): {tuned * 1e3:.1f} ms a "
                  f"pass, {n / tuned:.1f} images/s (measured only; the CLI keeps cuDNN's defaults) [{tag}]", flush=True)

    # ---- host formulas on this machine's CPU
    rng = np.random.default_rng(0)
    n = METRICS_SYNTHETIC
    f_r, f_g = rng.standard_normal((n, 2048)).astype(np.float32), rng.standard_normal((n, 2048)).astype(np.float32)
    t0 = time.perf_counter()
    formulas.kid_from_features(f_r, f_g, rng=np.random.default_rng(0))
    host[f"kid_from_features (N {n})"] = (time.perf_counter() - t0) * 1e3
    for n_pr in (n, 2048):
        f_r, f_g = (rng.standard_normal((n_pr, 4096)).astype(np.float32) for _ in range(2))
        t0 = time.perf_counter()
        formulas.precision_recall_from_features(f_r, f_g)
        host[f"precision_recall_from_features (N {n_pr}, 4096-d)"] = pr_ms = (time.perf_counter() - t0) * 1e3
    R, G = PR_PROTOCOL  # cost ~ R^2 + G^2 + 2RG distances (manifold x manifold and probes x manifold, both ways)
    pr_protocol_s = pr_ms / 1e3 * (R * R + G * G + 2 * R * G) / (4 * 2048 * 2048)
    print("metrics host ms on this machine's CPU: " + ", ".join(f"{k} {v:.1f}" for k, v in host.items())
          + f"; precision_recall at {G} generated and {R} real, extrapolated as N^2 from N 2048: "
          f"{pr_protocol_s / 60:.1f} min [{tag}]", flush=True)
    for label, gen_rate in sources.items():
        total = 50000 / gen_rate + 50000 / rates["InceptionV3"] + host["fid_from_stats (2048-d)"] / 1e3
        print(f"metrics projected fid50k_full wall time over {label} pairs: 50k at {gen_rate:.1f} images/s + 50k "
              f"through InceptionV3 at {rates['InceptionV3']:.0f}/s + the formula: {total / 60:.1f} min [{tag}]",
              flush=True)
    print(f"metrics phase: peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated, "
          f"{time.perf_counter() - t_phase:.1f} s [{tag}]", flush=True)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- transfer learning, stock G, skip D, plain 512,
# conditional metrics (the phases of ROADMAP §A 10 items 1-3)

# the geometry of the `ffhq256` resume preset, ffhq-res256-mirror-paper256-noaug.pkl (StyleGAN2-ADA's paper256
# config): TF static_kwargs of its Gs and D
FFHQ256_G = dict(latent_size=512, label_size=0, dlatent_size=512, resolution=256, num_channels=3, mapping_layers=8,
                 fmap_base=8192, fmap_max=512, architecture="skip")
FFHQ256_D = dict(label_size=0, resolution=256, num_channels=3, fmap_base=8192, fmap_max=512, architecture="resnet",
                 mbstd_group_size=8)
TRANSFER_STEPS = 3
STOCK_BATCH, PLAIN_512_BATCH = 16, 8
# a forward's FIR launches: GeneratorStock (skip) and Generator512Plain run up2 twice in each block above the
# first (the up-conv's pre-FIR and the image skip): 6 blocks 8 ... 256, 6 blocks 16 ... 512; the skip D runs
# down2 on the image at each of its 6 blocks 256 ... 8
STOCK_UP2, D_SKIP_DOWN2, PLAIN_512_UP2 = 12, 6, 12
GEN_RTOL, GEN_ATOL = 1e-2, 5e-3  # card vs CPU of a generator (tests/test_torch_generator.py's limits)
# the zoo phase: class -> (up2, down2 launches of one forward, its outputs: i an image [B, 256, 256, 3], m a mask
# [B, 256, 256, 1], h a mask [B, 128, 128, 1]).  Every pyramid block above 4x4 runs up2 twice (its up-conv's pre-FIR
# and the image skip): 12 at 256; a block run a second time (V11's and V13's spade block, a texture block) 2 more,
# V14's two spade blocks 4, V12's spade block (at 256, no up-conv, no skip) none.  down2 once a 1x1 down-conv: the
# skip of each halving ResBlock of a denorm encoder (V10's three; V13's and V14's two; one in V11, V15, V17, V16/V20/
# V21 and PatchDenorm; NoCoarse encodes two garments); the pyramid-only ablations have none.
ZOO = {"GeneratorV10": (12, 3, "i"), "GeneratorV11": (14, 1, "iim"), "GeneratorV12": (12, 1, "iim"),
       "GeneratorV13": (14, 2, "ih"), "GeneratorV14": (16, 2, "iim"), "GeneratorV15": (14, 1, "iim"),
       "GeneratorV15_2": (14, 1, "iim"), "GeneratorV17": (14, 1, "iim"), "GeneratorV16": (14, 1, "iim"),
       "GeneratorV20": (14, 1, "iim"), "GeneratorV21": (14, 1, "iimm"), "GeneratorRaw": (12, 0, "iii"),
       "GeneratorPatch": (12, 0, "iii"), "GeneratorPatchDenorm": (14, 1, "iim"),
       "GeneratorPatchDenormCat": (14, 1, "iim"),
       "GeneratorRawFull": (12, 0, "iiii"), "GeneratorPatchFull": (12, 0, "iiii"),
       "GeneratorAvgPatchFull": (12, 0, "iiii"), "GeneratorNoCoarse": (14, 2, "iiii"),
       "GeneratorNoCoarseNoMask": (14, 2, "iiii")}
# the ToRGB whose mask heads feed a `> 0.9` gate, and the heads' bias names (none: no gate)
ZOO_GATES = {**{n: ("synthesis.b256.torgb", ("m_bias",)) for n in (
    "GeneratorV11", "GeneratorV12", "GeneratorV14", "GeneratorV15", "GeneratorV15_2", "GeneratorV17", "GeneratorV16",
    "GeneratorV20", "GeneratorPatchDenormCat")},
    "GeneratorV13": ("synthesis.b128.torgb", ("m_bias",)),
    "GeneratorV21": ("synthesis.b256.torgb", ("m_bias", "hm_bias")),
    "GeneratorNoCoarse": ("synthesis.b256.torgb", ("m_bias1", "m_bias2"))}
ZOO_BATCH, ZOO_TIMED = 8, ("GeneratorV14", "GeneratorV17", "GeneratorV21", "GeneratorNoCoarse")
# the card-vs-CPU width; PatchDenormCat's concatenating blocks need channels(128) == 128 (the spade features' width)
ZOO_THIN, ZOO_THIN_CAT = dict(channel_base=1024, channel_max=32), dict(channel_base=16384, channel_max=128)
ZOO_RAW_STYLE = ("GeneratorRaw", "GeneratorRawFull")  # style encoders over the full-resolution garment
GATE_LOGIT_STD = 6.0  # the card-vs-CPU gating heads' logits, spread as a trained mask head's are
PATH_KERNELS.update({f"zoo_{name}": {"up2", "down2"} if down2 else {"up2"}
                     for name, (_, down2, _) in ZOO.items()})

D_RTOL, D_ATOL = 1e-4, 1e-5  # ... of D's logits (tests/test_torch_discriminator.py's)


def tf_gen_name(key):
    """A GeneratorStock state_dict key -> (the TF variable name a StyleGAN2
    export gives it, layout kind): this script's own inverse of the
    reference's pattern table (`legacy.py:170-202`)."""
    parts = key.split(".")
    leaf = parts[-1]
    if parts[0] == "mapping":
        return f"mapping/Dense{parts[1][2:]}/{leaf}", "fcT" if leaf == "weight" else "plain"
    r = int(parts[1][1:])
    if leaf == "const":
        return f"synthesis/{r}x{r}/Const/const", "const"
    layer = {"conv0": "Conv0_up", "conv1": "Conv" if r == 4 else "Conv1", "torgb": "ToRGB"}[parts[2]]
    if leaf == "noise_const":
        lod = int(math.log2(r))
        return f"synthesis/noise{0 if r == 4 else 2 * lod - (5 if parts[2] == 'conv0' else 4)}", "noise"
    if parts[3] == "affine":
        return (f"synthesis/{r}x{r}/{layer}/mod_{leaf}", "fcT" if leaf == "weight" else "bias+1")
    return f"synthesis/{r}x{r}/{layer}/{leaf}", "flip" if (leaf == "weight" and parts[2] == "conv0") else "plain"


def tf_disc_name(key):
    """A Discriminator state_dict key -> (TF name, layout kind) (`legacy.py:266-285`)."""
    parts = key.split(".")
    block, layer, leaf = parts[0], parts[1], parts[-1]
    dense = "fcT" if leaf == "weight" else "plain"
    if block == "b4":
        return {"conv": (f"4x4/Conv/{leaf}", "plain"), "fc": (f"4x4/Dense0/{leaf}", dense),
                "out": (f"Output/{leaf}", dense), "fromrgb": (f"4x4/FromRGB/{leaf}", "plain")}[layer]
    r = int(block[1:])
    name = {"fromrgb": "FromRGB", "conv0": "Conv0", "conv1": "Conv1_down", "skip": "Skip"}[layer]
    return f"{r}x{r}/{name}/{leaf}", "plain"


def tf_shape(shape, kind):
    """The TF shape of a port tensor of `shape` (OIHW convs are [kh, kw, in, out] in TF)."""
    if len(shape) == 4:
        return (shape[2], shape[3], shape[1], shape[0])
    return {"fcT": shape[::-1], "const": (1,) + shape, "noise": (1, 1) + shape}.get(kind, shape)


def tf_to_port(a, kind):
    """What the conversion must make of TF array `a` (the reference's `legacy.py` moves)."""
    import numpy as np

    if kind == "fcT":
        return a.T
    if kind == "const":
        return a[0]
    if kind == "noise":
        return a[0, 0]
    if kind == "bias+1":
        return a + 1.0
    if a.ndim == 4:
        return (a[::-1, ::-1] if kind == "flip" else a).transpose(3, 2, 0, 1)
    return np.asarray(a)


class _TFNetwork:
    """Pickled as `dnnlib.tflib.network.Network`, the class a TF export names."""


def legacy_tf_pickle(torch, path):
    """Write a legacy TF (G, D, Gs) pickle of the ffhq256 preset's geometry,
    weights drawn from seed 0 by TF name (G and Gs share their arrays, split
    into `mapping` and `synthesis` components as an export is).  Returns the
    tensors the port must make of it: {"G": {key: tensor}, "D": {...},
    "w_avg": tensor}."""
    import pickle
    import types

    import numpy as np

    from pasta_gan_tpu_torch.io import tf_legacy
    from pasta_gan_tpu_torch.models.generator_stock import GeneratorStock
    from pasta_gan_tpu_torch.nn.discriminator import Discriminator

    rng = np.random.default_rng(0)
    gen = GeneratorStock(**tf_legacy.generator_kwargs_from_tf(tf_legacy.TFNetworkStub(version=4,
                                                                                       static_kwargs=FFHQ256_G)))
    disc = Discriminator(c_dim=0, img_resolution=256, architecture="resnet", channel_base=16384, channel_max=512,
                         mbstd_group_size=8)
    expected, tf_vars = {}, {}
    for net, module, name_of in (("G", gen, tf_gen_name), ("D", disc, tf_disc_name)):
        expected[net], tf_vars[net] = {}, {}
        for key, leaf in module.state_dict().items():
            name, kind = name_of(key)
            a = rng.standard_normal(tf_shape(tuple(leaf.shape), kind)).astype(np.float32)
            if kind in ("bias+1", "plain") and leaf.ndim <= 1:
                a *= 0.1  # biases, noise strengths
            elif name.startswith("mapping/") and kind == "fcT":
                a *= 100.0  # the mapping's raw weights are N(0, 1 / lr_multiplier)
            tf_vars[net][name] = a
            expected[net][key] = torch.from_numpy(np.array(tf_to_port(a, kind), dtype=np.float32, order="C"))
    w_avg = rng.standard_normal(512).astype(np.float32)
    del gen, disc

    def network(static_kwargs, variables, components=None):
        n = _TFNetwork()
        n.__dict__.update(version=4, name="", static_kwargs=static_kwargs, variables=list(variables.items()),
                          components=components or {})
        return n

    g_vars = tf_vars["G"]
    comps = {c: network({}, {k[len(c) + 1:]: v for k, v in g_vars.items() if k.startswith(c + "/")})
             for c in ("mapping", "synthesis")}
    G = network(FFHQ256_G, {"dlatent_avg": w_avg}, comps)
    nets = (G, network(FFHQ256_D, tf_vars["D"]), G)
    mod = types.ModuleType("dnnlib.tflib.network")
    mod.Network = _TFNetwork
    _TFNetwork.__module__, _TFNetwork.__qualname__, _TFNetwork.__name__ = "dnnlib.tflib.network", "Network", "Network"
    fake = {"dnnlib": types.ModuleType("dnnlib"), "dnnlib.tflib": types.ModuleType("dnnlib.tflib"),
            "dnnlib.tflib.network": mod}
    saved = {k: sys.modules.get(k) for k in fake}
    sys.modules.update(fake)
    try:
        with open(path, "wb") as f:
            pickle.dump(nets, f, protocol=4)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    expected["w_avg"] = torch.from_numpy(w_avg)
    return expected


def check_transferred(torch, state, expected):
    """Every tensor of the train state that the pickle names with its shape
    equals the pickle's value after the layout move, on the card; returns
    {"G": (copied, shape-skipped), "G_ema": ..., "D": ..., "w_avg": moved}."""
    out = {}
    for net, src in (("G", expected["G"]), ("G_ema", expected["G"]), ("D", expected["D"])):
        sd = getattr(state, net).state_dict()
        copied = skipped = 0
        for key, want in src.items():
            if key not in sd:
                continue
            if tuple(sd[key].shape) != tuple(want.shape):
                skipped += 1
                continue
            assert sd[key].device.type == "cuda", (net, key, sd[key].device)
            assert torch.equal(sd[key].cpu(), want), f"{net}.{key} differs from the pickle's value"
            copied += 1
        out[net] = (copied, skipped)
    assert out["G"] == out["G_ema"], out
    out["w_avg"] = torch.equal(state.w_avg.cpu(), expected["w_avg"])
    return out


def transfer_phase(torch, ck, tag, tmp):
    """The training_transfer path: the ffhq256 preset's geometry as a legacy
    TF pickle in an `open_url` cache under a temporary HOME, then `cli.train
    --resume ffhq256` at full width (bf16, batch 32, noaug, 64 synthetic
    samples, TRANSFER_STEPS steps, no grids).  Before the first step every
    transferred tensor must be on the card and equal the pickle's value
    after the layout move (checked by a wrapper around
    `io/transfer.py:transfer_from_network_pickle`, removed again after the
    run); then run_cli_train's checks (finite stats, G, D and G_ema moved,
    exactly the FUSED kernels).  Returns (launches, pickle path, expected
    tensors)."""
    import hashlib

    from pasta_gan_tpu_torch.cli import train as cli_train
    from pasta_gan_tpu_torch.io import transfer

    t0 = time.perf_counter()
    home = os.path.join(tmp, "home")
    cache = os.path.join(home, ".cache", "pasta_gan_tpu")
    os.makedirs(cache)
    url = cli_train.RESUME_SPECS["ffhq256"]
    pkl = os.path.join(cache, f"{hashlib.md5(url.encode()).hexdigest()}_{url.rsplit('/', 1)[1]}")
    expected = legacy_tf_pickle(torch, pkl)
    make_s = time.perf_counter() - t0
    seen, original, old_home = {}, transfer.transfer_from_network_pickle, os.environ.get("HOME")

    def checked(state, path, verbose=True):
        t1 = time.perf_counter()
        state = original(state, path, verbose)
        torch.cuda.synchronize()
        seen["s"] = time.perf_counter() - t1
        seen.update(check_transferred(torch, state, expected))
        return state

    transfer.transfer_from_network_pickle, os.environ["HOME"] = checked, home
    try:
        out, launches = run_cli_train(torch, ck, tag, tmp, "training_transfer",
                                      ["--aug", "noaug", "--resume", "ffhq256"], grids=False, steps=TRANSFER_STEPS)
    finally:
        transfer.transfer_from_network_pickle = original
        if old_home is None:
            os.environ.pop("HOME", None)
        else:
            os.environ["HOME"] = old_home
    assert "G" in seen, "the run did not transfer from the pickle"
    assert out["run_dir"].endswith("-resumeffhq256"), out["run_dir"]
    assert seen["w_avg"], "w_avg is not the pickle's dlatent_avg"
    assert seen["G"][0] > 0 and seen["D"][0] > 0, f"nothing transferred: {seen}"
    state, records = out["state"], out["records"]
    moved = {net: any(not torch.equal(sd[k].cpu(), v) for k, v in expected["G" if net != "D" else "D"].items()
                      if k in sd and sd[k].shape == v.shape and "noise_const" not in k)
             for net, sd in (("G", state.G.state_dict()), ("G_ema", state.G_ema.state_dict()),
                             ("D", state.D.state_dict()))}
    assert all(moved.values()), f"transferred tensors did not train: {moved}"
    main_ms = [r["Timing/Gmain_Dmain"] * 1e3 for r in records[1:]]
    print(f"training_transfer: pickle of {os.path.getsize(pkl) / 1e6:.1f} MB written in {make_s:.1f} s; converted and "
          f"transferred in {seen['s']:.2f} s; G {seen['G'][0]} leaves copied, {seen['G'][1]} shape-skipped (G_ema the "
          f"same), D {seen['D'][0]} copied, {seen['D'][1]} shape-skipped; w_avg moved to dlatent_avg: "
          f"{seen['w_avg']}; Gmain+Dmain median {statistics.median(main_ms):.1f} ms (steps 2-{TRANSFER_STEPS}: "
          f"{', '.join(f'{t:.1f}' for t in main_ms)}; step 1 with R1 {records[0]['Timing/Gmain_Dmain'] * 1e3:.1f}); "
          f"losses G {[round(r['Loss/G/loss'], 4) for r in records]} D {[round(r['Loss/D/loss'], 4) for r in records]} "
          f"[{tag}]", flush=True)
    del out, state
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    return launches, pkl, expected


def timed_forward(torch, fn, label, tag, iters=10):
    """Median host ms of fn() ended by a synchronise, then its device ms and
    top operations under torch.profiler; printed."""
    ms, out = host_ms(torch, fn, iters)
    device_ms, n_ops, top = device_profile(torch, fn, iters=3)
    dev = "not measured (no device time in the trace)" if device_ms is None else f"{device_ms:.3f} ms"
    busy = "not measured" if device_ms is None else f"{device_ms / ms:.3f}"
    print(f"{label}: host {ms:.2f} ms (median of {iters}), device {dev}, busy {busy}, {n_ops:.0f} device ops "
          f"[{tag}]", flush=True)
    for op, op_ms, n in top:
        print(f"    {op_ms:9.3f} ms {n:7.1f}x  {op[:100]}", flush=True)
    return ms, device_ms, out


def stock_phase(torch, ck, tag, pkl, expected):
    """stock_forward: the transfer pickle's Gs converted by
    `generator_stock_from_tf` onto the card (every tensor equal to the
    expected one), one bf16 forward at batch STOCK_BATCH with the launch
    counts set to 0 just before it, that forward timed in fp32 and bf16, its
    FIR classes held to their plain versions, the card against the CPU at
    batch 2 (fp32, noise const, psi 0.7 toward dlatent_avg).  d_skip: a
    full-width skip-architecture D of the same width (seeded weights), one
    bf16 forward at batch 32 counted, timed, its FIR classes checked, and its
    fp32 logits at batch 8 against the CPU's.  Returns both paths' launches."""
    from pasta_gan_tpu_torch.io import tf_legacy
    from pasta_gan_tpu_torch.nn.discriminator import Discriminator

    launches = {}
    with open(pkl, "rb") as f:
        stubs = tf_legacy.load_tf_network_stubs(f)
    gen, sd, w_avg = tf_legacy.generator_stock_from_tf(stubs[2])
    del stubs
    assert sorted(sd) == sorted(expected["G"]) and all(torch.equal(sd[k], v) for k, v in expected["G"].items())
    assert torch.equal(w_avg, expected["w_avg"])
    gen = gen.cuda().eval()
    w_avg = w_avg.cuda()
    z = torch.randn((STOCK_BATCH, 512), generator=torch.Generator().manual_seed(1)).cuda()

    def forward(b=STOCK_BATCH):
        with torch.no_grad():
            return gen(z[:b], None, w_avg=w_avg, truncation_psi=0.7, noise_mode="const")[0]

    gen.set_dtype(torch.bfloat16)
    ck.reset_launch_counts()
    img = forward()
    torch.cuda.synchronize()
    launches["stock_forward"] = ck.launch_counts()
    check_launches("stock_forward", launches["stock_forward"], {"up2": STOCK_UP2})
    assert img.shape == (STOCK_BATCH, 256, 256, 3) and bool(torch.isfinite(img).all())
    torch.cuda.reset_peak_memory_stats()
    bf16_ms, bf16_dev, _ = timed_forward(torch, forward, f"stock_forward GeneratorStock 256 (ffhq256 geometry, "
                                         f"{sum(p.numel() for p in gen.parameters()) / 1e6:.2f} M parameters) batch "
                                         f"{STOCK_BATCH} bf16", tag)
    fir_classes_equal(torch, forward, "stock_forward bf16", tag)
    gen.set_dtype(torch.float32)
    fp32_ms, fp32_dev, img32 = timed_forward(torch, forward, f"stock_forward batch {STOCK_BATCH} fp32 (TF32 off)", tag)
    gen.set_dtype(torch.bfloat16)
    rel = float((forward().float() - img32).norm() / img32.norm())
    print(f"stock_forward: {STOCK_BATCH / bf16_ms * 1e3:.1f} images/s bf16, {STOCK_BATCH / fp32_ms * 1e3:.1f} fp32; "
          f"bf16 vs fp32 relative L2 {rel:.4g} (limit {BF16_REL_L2}); launches {launches['stock_forward']}; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated [{tag}]", flush=True)
    assert rel <= BF16_REL_L2
    gen.set_dtype(torch.float32)
    with torch.no_grad():
        on_card = forward(2).cpu()
        cpu_gen = gen.cpu()
        on_cpu = cpu_gen(z[:2].cpu(), None, w_avg=w_avg.cpu(), truncation_psi=0.7, noise_mode="const")[0]
    err = float((on_card - on_cpu).abs().max())
    print(f"stock_forward card vs CPU (batch 2, fp32, noise const, psi 0.7): max abs error {err:.3g}, relative L2 "
          f"{float((on_card - on_cpu).norm() / on_cpu.norm()):.3g} (rtol {GEN_RTOL}, atol {GEN_ATOL}) [{tag}]",
          flush=True)
    torch.testing.assert_close(on_card, on_cpu, rtol=GEN_RTOL, atol=GEN_ATOL)
    del gen, cpu_gen, img, img32

    disc = Discriminator(c_dim=0, img_resolution=256, architecture="skip", channel_base=16384, channel_max=512,
                         mbstd_group_size=8).reset_parameters(torch.Generator().manual_seed(2))
    imgs = torch.randn((TRAIN_BATCH, 3, 256, 256), generator=torch.Generator().manual_seed(3)) * 0.5
    with torch.no_grad():
        logits_cpu = disc(imgs[:8], None)
    disc = disc.cuda().set_dtype(torch.bfloat16)
    x = imgs.cuda()

    def d_forward():
        with torch.no_grad():
            return disc(x, None)

    ck.reset_launch_counts()
    logits = d_forward()
    torch.cuda.synchronize()
    launches["d_skip"] = ck.launch_counts()
    check_launches("d_skip", launches["d_skip"], {"down2": D_SKIP_DOWN2})
    assert logits.shape == (TRAIN_BATCH, 1) and bool(torch.isfinite(logits).all())
    timed_forward(torch, d_forward, f"d_skip Discriminator(architecture='skip') 256 batch {TRAIN_BATCH} bf16", tag)
    fir_classes_equal(torch, d_forward, "d_skip bf16", tag)
    disc.set_dtype(torch.float32)
    with torch.no_grad():
        logits_card = disc(x[:8], None).cpu()
    print(f"d_skip card vs CPU (batch 8, fp32): logits max abs error "
          f"{float((logits_card - logits_cpu).abs().max()):.3g} (rtol {D_RTOL}, atol {D_ATOL}); launches "
          f"{launches['d_skip']} [{tag}]", flush=True)
    torch.testing.assert_close(logits_card, logits_cpu, rtol=D_RTOL, atol=D_ATOL)
    del disc, x
    torch.cuda.empty_cache()
    return launches


def plain_512_phase(torch, ck, tag):
    """plain_512: Generator512Plain at the released-512 widths (channel_base
    32768, channel_max 512) on random inputs of the 512 path's shapes (a
    48-channel style stack at 128x128, retain and pose at 512x512), one bf16
    forward at batch PLAIN_512_BATCH counted, timed, its FIR classes held to
    their plain versions; the card against the CPU at batch 1 on a thin width
    (channel_base 1024, channel_max 32), fp32.  Returns the path's launches."""
    from pasta_gan_tpu_torch.models import Generator512Plain

    g = torch.Generator().manual_seed(4)

    def inputs(b):
        return (torch.randn((b, 128, 128, 48), generator=g) * 0.5, torch.randn((b, 512, 512, 3), generator=g) * 0.5,
                torch.randn((b, 512, 512, 6), generator=g) * 0.5)

    gen = Generator512Plain().reset_parameters(torch.Generator().manual_seed(5)).cuda().set_dtype(torch.bfloat16)
    x = [t.cuda().to(torch.bfloat16) for t in inputs(PLAIN_512_BATCH)]

    def forward():
        with torch.no_grad():
            return gen(None, *x, noise_mode="const")

    ck.reset_launch_counts()
    img = forward()
    torch.cuda.synchronize()
    launches = {"plain_512": ck.launch_counts()}
    check_launches("plain_512", launches["plain_512"], {"up2": PLAIN_512_UP2})
    assert img.shape == (PLAIN_512_BATCH, 512, 512, 3) and bool(torch.isfinite(img).all())
    torch.cuda.reset_peak_memory_stats()
    ms, _, _ = timed_forward(torch, forward, f"plain_512 Generator512Plain (channel_base 32768, "
                             f"{sum(p.numel() for p in gen.parameters()) / 1e6:.2f} M parameters) batch "
                             f"{PLAIN_512_BATCH} bf16", tag, iters=5)
    fir_classes_equal(torch, forward, "plain_512 bf16", tag)
    print(f"plain_512: {PLAIN_512_BATCH / ms * 1e3:.1f} images/s; launches {launches['plain_512']}; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated [{tag}]", flush=True)
    del gen, x, img
    thin = Generator512Plain(channel_base=1024, channel_max=32).reset_parameters(torch.Generator().manual_seed(6))
    x1 = inputs(1)
    with torch.no_grad():
        on_cpu = thin(None, *x1, noise_mode="const")
        on_card = thin.cuda()(None, *[t.cuda() for t in x1], noise_mode="const").cpu()
    print(f"plain_512 card vs CPU (batch 1, thin, fp32): max abs error {float((on_card - on_cpu).abs().max()):.3g} "
          f"(rtol {GEN_RTOL}, atol {GEN_ATOL}) [{tag}]", flush=True)
    torch.testing.assert_close(on_card, on_cpu, rtol=GEN_RTOL, atol=GEN_ATOL)
    torch.cuda.empty_cache()
    return launches


def zoo_inputs(torch, cls, nc, batch, g, device):
    """Random inputs of a zoo class's forward after (z): the style stack at
    `nc` channels (64x64, or 256x256 for the raw-garment encoders), retain 3
    channels, pose 6, then each denorm garment (3 channels) and binary mask
    (1 channel) its forward names, all NHWC fp32."""
    import inspect

    names = list(inspect.signature(cls.forward).parameters)
    extra = names[names.index("pose") + 1 : names.index("truncation_psi")]
    cr = 256 if cls.__name__ in ZOO_RAW_STYLE else 64
    x = [torch.randn((batch, cr, cr, nc), generator=g) * 0.5, torch.randn((batch, 256, 256, 3), generator=g) * 0.5,
         torch.randn((batch, 256, 256, 6), generator=g) * 0.5]
    for name in extra:
        x.append((torch.rand((batch, 256, 256, 1), generator=g) > 0.4).float() if "mask" in name
                 else torch.randn((batch, 256, 256, 3), generator=g) * 0.5)
    return [t.to(device) for t in x]


def zoo_gate_gap(torch, gen, name, x):
    """Spread each gating mask head's logits (its weight scaled to a standard
    deviation of GATE_LOGIT_STD) and place the 0.9 threshold in the widest gap
    of the logits within their 20-80 % quantiles, from one forward of `gen`
    on `x`: a sigmoid mask is discontinuous at the threshold, so one ulp
    between two devices would flip a pixel that lies on it."""
    path, biases = ZOO_GATES[name]
    torgb = gen.get_submodule(path)
    caught = []
    hook = torgb.register_forward_hook(lambda m, a, out: caught.append(out[1]))
    with torch.no_grad():
        gen(None, *x, noise_mode="const")
    hook.remove()
    heads = caught[0] if isinstance(caught[0], tuple) else (caught[0],)
    for bias_name, m in zip(biases, heads):
        bias = getattr(torgb, bias_name)
        y = (torch.logit(m.double()) - float(bias.detach())).flatten().cpu()
        y = y[torch.isfinite(y)]
        scale = GATE_LOGIT_STD / float(y.std())
        y = (y * scale).sort().values
        lo, hi = int(0.2 * y.numel()) + 1, int(0.8 * y.numel()) - 1
        k = lo + int(torch.argmax(y[lo + 1 : hi + 1] - y[lo:hi]))
        with torch.no_grad():
            getattr(torgb, bias_name.replace("bias", "weight")).mul_(scale)
            bias.fill_(math.log(0.9 / 0.1) - 0.5 * float(y[k] + y[k + 1]))


def zoo_phase(torch, ck, tag):
    """zoo: every class of `models.ZOO` at its defaults, built through
    `build_model` (seeded weights drawn on the card): one bf16 forward at
    ZOO_BATCH with its launch counts set to 0 just before it (outputs finite
    and of the shapes ZOO documents, launches as ZOO predicts), its FIR
    classes held to their plain versions; the card against the CPU at a thin
    width (ZOO_THIN), batch 2, fp32, noise const, after `zoo_gate_gap` (the
    binarised masks equal); ZOO_TIMED timed at ZOO_BATCH (bf16; bf16 vs fp32
    relative L2 of each image output).  Prints its seconds; returns the
    paths' launches."""
    from pasta_gan_tpu_torch import models

    t0 = time.perf_counter()
    launches = {}
    shapes = {"i": (256, 256, 3), "m": (256, 256, 1), "h": (128, 128, 1)}
    for i, cls in enumerate(models.ZOO):
        name = cls.__name__
        up2, down2, outs = ZOO[name]
        with torch.device("cuda"):
            gen = models.build_model(name)
        gen.reset_parameters(torch.Generator(device="cuda").manual_seed(10 + i)).eval().set_dtype(torch.bfloat16)
        n_params = sum(p.numel() for p in gen.parameters())
        x = zoo_inputs(torch, cls, gen.config["style_input_nc"], ZOO_BATCH, torch.Generator().manual_seed(i), "cuda")

        def forward():
            with torch.no_grad():
                out = gen(None, *x, noise_mode="const")
            return out if isinstance(out, tuple) else (out,)

        ck.reset_launch_counts()
        out = forward()
        torch.cuda.synchronize()
        path = f"zoo_{name}"
        launches[path] = ck.launch_counts()
        check_launches(path, launches[path], {"up2": up2, "down2": down2})
        assert [tuple(o.shape) for o in out] == [(ZOO_BATCH, *shapes[k]) for k in outs], (name, [o.shape for o in out])
        assert all(bool(torch.isfinite(o).all()) for o in out), name
        fir_classes_equal(torch, forward, f"zoo {name} (build_model defaults, {n_params / 1e6:.2f} M parameters) "
                                          f"bf16 batch {ZOO_BATCH}", tag)
        if name in ZOO_TIMED:
            ms, _, _ = timed_forward(torch, forward, f"zoo {name} batch {ZOO_BATCH} bf16", tag, iters=5)
            gen.set_dtype(torch.float32)
            out32 = forward()
            rels = [float((a.float() - b).norm() / b.norm()) for a, b, k in zip(out, out32, outs) if k == "i"]
            print(f"zoo {name}: {ZOO_BATCH / ms * 1e3:.1f} images/s bf16; bf16 vs fp32 relative L2 of the image "
                  f"outputs {', '.join(f'{r:.4g}' for r in rels)} (limit {BF16_REL_L2}) [{tag}]", flush=True)
            assert max(rels) <= BF16_REL_L2, (name, rels)
            del out32
        del gen, out, x

        width = ZOO_THIN_CAT if name == "GeneratorPatchDenormCat" else ZOO_THIN
        thin = models.build_model(name, **width).reset_parameters(torch.Generator().manual_seed(10 + i)).eval()
        x2 = zoo_inputs(torch, cls, thin.config["style_input_nc"], 2, torch.Generator().manual_seed(100 + i), "cpu")
        thin.cuda()
        if name in ZOO_GATES:
            zoo_gate_gap(torch, thin, name, [t.cuda() for t in x2])

        def run_thin(dev):
            """The thin model's outputs on `dev` (to the CPU) and its gating masks."""
            thin.to(dev)
            caught = []
            torgb = thin.get_submodule(ZOO_GATES[name][0]) if name in ZOO_GATES else None
            hook = torgb.register_forward_hook(lambda m, a, o: caught.append(o[1])) if torgb else None
            with torch.no_grad():
                res = thin(None, *[t.to(dev) for t in x2], noise_mode="const")
            if hook:
                hook.remove()
            heads = (caught[0] if isinstance(caught[0], tuple) else (caught[0],)) if caught else ()
            return [t.cpu() for t in (res if isinstance(res, tuple) else (res,))], [m.cpu() > 0.9 for m in heads]

        card_out, card_gates = run_thin("cuda")
        cpu_out, cpu_gates = run_thin("cpu")
        errs = [float((a - b).abs().max()) for a, b in zip(card_out, cpu_out)]
        flips = sum(int((a != b).sum()) for a, b in zip(card_gates, cpu_gates))
        print(f"zoo {name} card vs CPU (thin, batch 2, fp32, noise const): max abs error per output "
              f"{', '.join(f'{e:.3g}' for e in errs)} (rtol {GEN_RTOL}, atol {GEN_ATOL}); gate pixels that differ "
              f"{flips} [{tag}]", flush=True)
        assert flips == 0, name
        for a, b in zip(card_out, cpu_out):
            torch.testing.assert_close(a, b, rtol=GEN_RTOL, atol=GEN_ATOL)
        del thin
        torch.cuda.empty_cache()
    print(f"zoo: {len(models.ZOO)} classes in {time.perf_counter() - t0:.1f} s [{tag}]", flush=True)
    return launches


def metrics_conditional_phase(torch, ck, tag, tmp):
    """metrics_conditional: `cli.calc_metrics --conditional` with the fixture's
    UPT_subset1_256_192 test images laid flat as reals, each with its
    `_label.png` and `_keypoints.json` beside it (`upt_0004`'s OpenPose file
    lists no person, so it is left out), against `serving_real`'s PNGs, FID
    on the random-weight InceptionV3 of the metrics phase; every item must
    carry its part images and pose heatmap; the host ms of one
    `PartsFolderDataset` item.  Returns the path's launches (none)."""
    import json
    import shutil

    from pasta_gan_tpu_torch.data.parts import PartsFolderDataset

    src = os.path.join(fixture_root(), "UPT_subset1_256_192")
    real_dir = os.path.join(tmp, "parts_real")
    os.makedirs(real_dir)
    left_out = []
    for name in sorted(os.listdir(os.path.join(src, "image"))):
        stem = os.path.splitext(name)[0]
        with open(os.path.join(src, "keypoints", f"{stem}_keypoints.json")) as f:
            if not json.load(f)["people"]:
                left_out.append(stem)
                continue
        shutil.copy(os.path.join(src, "image", name), real_dir)
        shutil.copy(os.path.join(src, "parsing", f"{stem}_label.png"), real_dir)
        shutil.copy(os.path.join(src, "keypoints", f"{stem}_keypoints.json"), real_dir)
    ds = PartsFolderDataset(real_dir, resolution=256)
    item_ms, complete = [], 0
    for i in range(len(ds)):
        t0 = time.perf_counter()
        item = ds[i]
        item_ms.append((time.perf_counter() - t0) * 1e3)
        complete += all(k in item for k in ("head_img", "top_img", "pant_img", "palm_img", "pose_heatmap"))
        assert item["image"].shape == (256, 256, 3) and item["pose_heatmap"].shape == (256, 256, 18)
    assert complete == len(ds) > 0, f"{complete} of {len(ds)} items carry their part images and heatmap"
    launches = {}
    res, launches["metrics_conditional"] = run_calc_metrics(
        torch, ck, tag, "metrics_conditional",
        ["--gen_dir", os.path.join(tmp, "tryon_real"), "--real_dir", real_dir, "--conditional", "--resolution", "256",
         "--detector", os.path.join(tmp, "inception.pt")], ["fid50k_full"])
    check_launches("metrics_conditional", launches["metrics_conditional"], {})
    print(f"metrics_conditional: FID {res[0]['results']['fid50k_full']:.6g} over {len(ds)} conditional reals "
          f"({complete} with part images and heatmap; left out, no person: {left_out}); one PartsFolderDataset item "
          f"{statistics.median(item_ms):.2f} ms on the host (median of {len(ds)}) [{tag}]", flush=True)
    return launches



# the flow generator V1 (v1_flow): one forward launches up2 twice in each block above 4x4 (the up-conv's pre-FIR and
# the image skip), 6 blocks 8 ... 256; it has no SPADE branch and its encoders' 3x3 down-convs filter on the plain
# path, so no down2 (12 and 0 counted on the CPU with a counting _up2_apply / _down2_apply)
V1_BATCH, V1_UP2 = 8, 12
V1_THIN = dict(channel_base=1024, channel_max=32)  # the card-vs-CPU width (FlowNet keeps its fixed widths)
V1_OFFSET_STD = 3.0  # pixels: the flow head is scaled so that random weights' offsets spread this far
V1_IN_FRAME = 0.8  # share of the warp's samples that must land inside the frame
FLOW_MEAN_REL, FLOW_MAX_REL = 1e-3, 5e-2  # the flow grid's normalized error (tests/test_v1_parity.py's limits)
SN_ATOL = 1e-5  # u and v after one power iteration, card vs CPU
# the patch discriminators (patch_d) at their defaults: patch 64, so 4 halving ResBlocks, each with a 1x1 skip
# down-conv (down2; its gradient is up2).  V1 samples real and fake (8 down2 forward), V2 the fake alone (4); the
# backward reaches every skip (pred_fake reads both branches): 8 + 4 up2
PD_BATCH, PD_LEVELS = 16, 4
PD_DOWN2 = PD_UP2 = 3 * PD_LEVELS
PD_THIN = dict(scale_capacity=1.0, max_nc=64, patch_size=32)
# the thin patch discriminators' gradient to the fake image, card vs CPU (relative L2).  With cuDNN off (PyTorch's
# own CUDA convolutions) it reads ~1e-6 and is held to PD_GRAD_REL_NO_CUDNN: the port's own check.  With cuDNN on,
# the library's heuristic picks FFT convolutions for fp32 backward passes (the phase prints their kernels), whose
# rounding puts it at 9.46e-4 on an H100; PD_GRAD_REL_CUDNN is ten times that reading, so that another algorithm
# choice of cuDNN's does not fail the check, while a fault of the port (a wrong tap, tile or draw) reads of order 1
PD_GRAD_REL_NO_CUDNN, PD_GRAD_REL_CUDNN = 1e-5, 1e-2
HOST_ROUTE_CLOSE, HOST_ROUTE_MEAN = 0.995, 2e-3  # tests/test_host_router.py:_compare's criterion
PATH_KERNELS.update({"v1_flow": {"up2"}, "patch_d": {"up2", "down2"}, "host_routing": {"norm_warp", "composite"}})


def v1_inputs(torch, batch, g, device, res=256):
    """GeneratorV1's inputs after z, NHWC: the 48-channel style stack at a
    quarter of the resolution, retain 3, pose 6, aff_pose 3, aff_top 3,
    lower 3."""
    shapes = [(res // 4, res // 4, 48), (res, res, 3), (res, res, 6), (res, res, 3), (res, res, 3), (res, res, 3)]
    return [(torch.randn((batch, *s), generator=g) * 0.5).to(device) for s in shapes]


def scale_flow_head(torch, gen, x):
    """Scale the flow head `flownet.flow3` so that the offsets of `x` spread
    by V1_OFFSET_STD pixels: random spectral + batch-statistics stacks reach
    offsets of order 1e8, which clamps every sample to the border.  Returns
    the unscaled spread."""
    with torch.no_grad():
        std = float(gen.flownet.offset(gen.flow_input(*x[2:])).float().std())
        gen.flownet.flow3.weight.mul_(V1_OFFSET_STD / std)
        gen.flownet.flow3.bias.mul_(V1_OFFSET_STD / std)
    return std


def flow_errors(torch, grid, ref):
    """(mean, max) |grid - ref| over mean |ref|."""
    d, denom = (grid - ref).abs(), ref.abs().mean()
    return float(d.mean() / denom), float(d.max() / denom)


def v1_phase(torch, ck, tag):
    """v1_flow: GeneratorV1 through `build_model` at its defaults (256x256,
    channel_base 32768, channel_max 512, 48-channel style stack, FlowNet(12);
    seeded weights drawn on the card, the flow head scaled by
    `scale_flow_head`), one bf16 and one fp32 forward at V1_BATCH with the
    launch counts set to 0 just before them, its FIR classes held to their
    plain versions, both timed, bf16 against fp32; the card against the CPU
    at V1_THIN, batch 2, fp32, noise const, on one state (u and v included):
    the flow grid by normalized error and the image within the generator
    limits, once in eval and once with `update_sn`, whose u and v must agree.
    Returns the path's launches."""
    from pasta_gan_tpu_torch import models

    t0 = time.perf_counter()
    with torch.device("cuda"):
        gen = models.build_model("GeneratorV1")
    gen.reset_parameters(torch.Generator(device="cuda").manual_seed(21)).eval()
    n_params = sum(p.numel() for p in gen.parameters())
    x = v1_inputs(torch, V1_BATCH, torch.Generator().manual_seed(21), "cuda")
    raw_std = scale_flow_head(torch, gen, x)

    def forward():
        with torch.no_grad():
            return gen(None, *x, noise_mode="const")

    ck.reset_launch_counts()
    outs = {}
    for dt in (torch.bfloat16, torch.float32):
        gen.set_dtype(dt)
        outs[dt] = forward().float()
    torch.cuda.synchronize()
    launches = ck.launch_counts()
    check_launches("v1_flow", launches, {"up2": 2 * V1_UP2})
    with torch.no_grad():
        grid = gen.flow(*x[2:])
    inside = float((grid.abs() <= 1).all(-1).float().mean())
    for out in outs.values():
        assert tuple(out.shape) == (V1_BATCH, 256, 256, 3) and bool(torch.isfinite(out).all())
    rel = float((outs[torch.bfloat16] - outs[torch.float32]).norm() / outs[torch.float32].norm())
    print(f"v1_flow: GeneratorV1 (build_model defaults, {n_params / 1e6:.2f} M parameters), batch {V1_BATCH}: "
          f"unscaled offset spread {raw_std:.4g} px, scaled to {V1_OFFSET_STD}; {inside:.3f} of the samples in the "
          f"frame; bf16 vs fp32 relative L2 of the image {rel:.4g} (BF16_REL_L2 {BF16_REL_L2}) [{tag}]", flush=True)
    flops = counted_flops(torch, forward)
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        gen.set_dtype(dt)
        fir_classes_equal(torch, forward, f"v1_flow {name} batch {V1_BATCH}", tag)
        ms, device_ms, _ = timed_forward(torch, forward, f"v1_flow GeneratorV1 batch {V1_BATCH} {name}", tag, iters=5)
        rate = "not measured" if device_ms is None else f"{flops / device_ms / 1e9:.1f} TFLOP/s at the device ms"
        print(f"v1_flow {name}: {V1_BATCH / ms * 1e3:.1f} images/s; {flops / 1e9:.1f} GFLOP a forward counted "
              f"(convolutions and matmuls), {rate} [{tag}]", flush=True)
    del gen, outs, x, grid
    torch.cuda.empty_cache()

    thin = models.build_model("GeneratorV1", **V1_THIN).reset_parameters(torch.Generator().manual_seed(22)).eval()
    x2 = v1_inputs(torch, 2, torch.Generator().manual_seed(23), "cpu")
    scale_flow_head(torch, thin, x2)
    state = {k: t.clone() for k, t in thin.state_dict().items()}

    def run(dev, update_sn):
        thin.load_state_dict(state)
        thin.to(dev).flownet.set_update_sn(update_sn)
        xs = [t.to(dev) for t in x2]
        with torch.no_grad():
            grid = thin.flow(*xs[2:]).cpu()
            img = thin(None, *xs, noise_mode="const").cpu()
        sn = {k: t.cpu().clone() for k, t in thin.state_dict().items() if k.endswith(("weight_u", "weight_v"))}
        return grid, img, sn

    for update_sn in (False, True):
        (grid_c, img_c, sn_c), (grid_g, img_g, sn_g) = run("cpu", update_sn), run("cuda", update_sn)
        mean_rel, max_rel = flow_errors(torch, grid_g, grid_c)
        inside = float((grid_c.abs() <= 1).all(-1).float().mean())
        sn_err = max(float((sn_g[k] - sn_c[k]).abs().max()) for k in sn_c)
        moved = max(float((sn_c[k] - state[k]).abs().max()) for k in sn_c)
        print(f"v1_flow card vs CPU (thin, batch 2, fp32, noise const, update_sn {update_sn}): flow grid normalized "
              f"error mean {mean_rel:.3g} max {max_rel:.3g} (limits {FLOW_MEAN_REL}, {FLOW_MAX_REL}); {inside:.3f} of "
              f"the samples in the frame; image max abs error {float((img_g - img_c).abs().max()):.3g} (rtol "
              f"{GEN_RTOL}, atol {GEN_ATOL}); u, v max abs error {sn_err:.3g} (limit {SN_ATOL}), moved {moved:.3g} "
              f"[{tag}]", flush=True)
        assert mean_rel <= FLOW_MEAN_REL and max_rel <= FLOW_MAX_REL and inside >= V1_IN_FRAME
        torch.testing.assert_close(img_g, img_c, rtol=GEN_RTOL, atol=GEN_ATOL)
        assert sn_err <= SN_ATOL and (moved > 0) == update_sn
    del thin
    torch.cuda.empty_cache()
    print(f"v1_flow: {time.perf_counter() - t0:.1f} s [{tag}]", flush=True)
    return {"v1_flow": launches}


def patch_d_step(torch, D, D2, real, fake, draws, draws2):
    """One forward and backward of both patch discriminators: V1 on (real,
    fake) and V2 on the fake, a non-saturating loss of each, gradients to
    the fake image and every parameter.  Returns (V1 logits, V2 logits,
    d loss / d fake)."""
    import torch.nn.functional as F

    f = fake.detach().requires_grad_(True)
    pred_real, pred_fake = D(real, f, draws=draws)
    pred2 = D2(f, draws=draws2)
    loss = F.softplus(pred_fake).mean() + F.softplus(-pred_real).mean() + F.softplus(pred2).mean()
    D.zero_grad(set_to_none=True)
    D2.zero_grad(set_to_none=True)
    loss.backward()
    return torch.cat([pred_real, pred_fake], 1), pred2, f.grad


def patch_d_phase(torch, ck, tag):
    """patch_d: StyleGAN2PatchDiscriminator and its V2 at their defaults
    (capacity 4, max_nc 384, patch 64, 8 tiles; seeded weights drawn on the
    card) on real and fake [PD_BATCH, 3, 256, 256] frames, forward and
    backward (`patch_d_step`) with the launch counts set to 0 just before it;
    the draws come from one CPU generator; its FIR classes held to their
    plain versions; timed, with its peak memory; the card against the CPU at
    PD_THIN on the same draws, with cuDNN on and off: logits within D's
    limits, the parameters' gradients within GRAD_REL_L2, the gradient to the
    fake image within PD_GRAD_REL_CUDNN (cuDNN on; its FFT kernels printed)
    and PD_GRAD_REL_NO_CUDNN (off).  Returns the path's launches."""
    from pasta_gan_tpu_torch.nn.patch_discriminator import (
        StyleGAN2PatchDiscriminator,
        StyleGAN2PatchDiscriminatorV2,
    )

    t0 = time.perf_counter()

    def build(cfg, device, seed):
        g = torch.Generator(device=device).manual_seed(seed)
        with torch.device(device):
            return [cls(**cfg).reset_parameters(g) for cls in (StyleGAN2PatchDiscriminator,
                                                               StyleGAN2PatchDiscriminatorV2)]

    def frames(batch, device):
        g = torch.Generator().manual_seed(31)
        return [(torch.rand((batch, 3, 256, 256), generator=g) * 2 - 1).to(device) for _ in range(2)]

    D, D2 = build({}, "cuda", 31)
    n_params = sum(p.numel() for p in D.parameters()) + sum(p.numel() for p in D2.parameters())
    real, fake = frames(PD_BATCH, "cuda")
    g = torch.Generator().manual_seed(32)
    draws = (D.draw_patches(PD_BATCH, 256, 256, g), D.draw_patches(PD_BATCH, 256, 256, g))
    draws2 = (D2.draw_patches(PD_BATCH, 256, 256, g), None)

    def step():
        return patch_d_step(torch, D, D2, real, fake, draws, draws2)

    ck.reset_launch_counts()
    out = step()
    torch.cuda.synchronize()
    launches = ck.launch_counts()
    check_launches("patch_d", launches, {"down2": PD_DOWN2, "up2": PD_UP2})
    T = D.tile_grid(256, 256)[2]
    assert tuple(out[0].shape) == (PD_BATCH, 2 * T) and tuple(out[1].shape) == (PD_BATCH * T, 1)
    assert all(bool(torch.isfinite(o).all()) for o in out) and float(out[2].abs().sum()) > 0
    fir_classes_equal(torch, step, f"patch_d forward + backward batch {PD_BATCH}", tag)
    torch.cuda.reset_peak_memory_stats()
    step()
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms, _, _ = timed_forward(torch, step, f"patch_d V1 + V2 forward + backward, batch {PD_BATCH} fp32 "
                                          f"({n_params / 1e6:.2f} M parameters)", tag, iters=5)
    print(f"patch_d: forward + backward {ms:.2f} ms a step, peak {peak:.2f} GB allocated [{tag}]", flush=True)
    del D, D2, real, fake, out
    torch.cuda.empty_cache()

    g = torch.Generator().manual_seed(34)
    Dc, D2c = build(PD_THIN, "cpu", 33)
    draws = (Dc.draw_patches(2, 256, 256, g), Dc.draw_patches(2, 256, 256, g))
    draws2 = (D2c.draw_patches(2, 256, 256, g), None)

    def thin_step(dev, cudnn=True):
        """(logits, V2 logits, gradient to the fake image, parameter gradients), moved to the CPU."""
        Dt, D2t = [m.to(dev) for m in build(PD_THIN, "cpu", 33)]
        torch.backends.cudnn.enabled = cudnn
        try:
            logits, logits2, grad = patch_d_step(torch, Dt, D2t, *frames(2, dev), draws, draws2)
        finally:
            torch.backends.cudnn.enabled = True
        params = torch.cat([p.grad.flatten() for m in (Dt, D2t) for p in m.parameters()])
        return [t.detach().cpu() for t in (logits, logits2, grad, params)]

    cpu = thin_step("cpu")
    _, _, top = device_profile(torch, lambda: thin_step("cuda"), iters=1, top=10_000)
    fft = [(op, op_ms) for op, op_ms, _ in top if "fft" in op.lower()]
    print(f"patch_d thin step with cuDNN on: {len(fft)} of its {len(top)} device kernel names hold 'fft', "
          f"{sum(op_ms for _, op_ms in fft):.3f} ms: {sorted({op.split('<')[0] for op, _ in fft})} [{tag}]", flush=True)
    for cudnn, grad_limit in ((True, PD_GRAD_REL_CUDNN), (False, PD_GRAD_REL_NO_CUDNN)):
        card = thin_step("cuda", cudnn)
        g_rel, p_rel = (float((card[i] - cpu[i]).norm() / cpu[i].norm()) for i in (2, 3))
        print(f"patch_d card vs CPU (capacity 1, max_nc 64, patch 32, batch 2, fp32, the same draws, cuDNN "
              f"{'on' if cudnn else 'off'}): logits max abs error {float((card[0] - cpu[0]).abs().max()):.3g}, V2 "
              f"{float((card[1] - cpu[1]).abs().max()):.3g} (rtol {D_RTOL}, atol {D_ATOL}); gradient to the fake image "
              f"relative L2 {g_rel:.3g} (limit {grad_limit}), to the parameters {p_rel:.3g} (limit {GRAD_REL_L2}) "
              f"[{tag}]", flush=True)
        torch.testing.assert_close(card[0], cpu[0], rtol=D_RTOL, atol=D_ATOL)
        torch.testing.assert_close(card[1], cpu[1], rtol=D_RTOL, atol=D_ATOL)
        assert g_rel <= grad_limit and p_rel <= GRAD_REL_L2
    print(f"patch_d: {time.perf_counter() - t0:.1f} s [{tag}]", flush=True)
    return {"patch_d": launches}


def route_agreement(torch, host, dev, keys):
    """The JAX host-route test's criterion between a host route's dict and a
    device route's RoutedPatches; returns the worst (share close, mean |d|)."""
    worst = (1.0, 0.0)
    for k in keys:
        a, b = torch.as_tensor(host[k]).float(), getattr(dev, k).float().cpu()
        close = float(torch.isclose(a, b, rtol=1e-3, atol=2e-3).float().mean())
        mean = float((a - b).abs().mean())
        assert close >= HOST_ROUTE_CLOSE and mean < HOST_ROUTE_MEAN, (k, close, mean)
        worst = (min(worst[0], close), max(worst[1], mean))
    return worst


def host_routing_phase(torch, ck, tag):
    """host_routing: `route_patches_host_transfer_batch` over the fixture's 16
    test pairs and `HostRoutingPipeline(training_route_fn())` over 32
    synthetic samples (2 batches of 16), each held to the card's device
    route of the same batch (the launches counted) by the JAX host-route
    test's criterion; host ms a batch at 1, 4 and all of the machine's
    threads beside the device route's ms.  Returns the path's launches."""
    from pasta_gan_tpu_torch.data import dataset as tds
    from pasta_gan_tpu_torch.data import host_router as hr
    from pasta_gan_tpu_torch.data.warp import route_patches_batch, route_patches_transfer_batch

    t0 = time.perf_counter()
    keys = ("norm_img", "norm_img_lower", "denorm_upper_img", "denorm_lower_img", "norm_clothes_masks",
            "denorm_hand_masks")
    ds = tds.UvitonDataset256Test(fixture_root())
    items = [ds[i] for i in range(len(ds))]
    person, garment = tds.collate([it["person"] for it in items]), tds.collate([it["garment"] for it in items])
    cpu_args = tds._tryon_sources(person, garment, "cpu")
    np_args = [t.numpy() for t in cpu_args]
    card_args = [t.cuda() for t in cpu_args]
    host = hr.route_patches_host_transfer_batch(*np_args)
    ck.reset_launch_counts()
    dev = route_patches_transfer_batch(*card_args)
    torch.cuda.synchronize()
    launches = ck.launch_counts()
    close, mean = route_agreement(torch, host, dev, keys)
    print(f"host_routing: the fixture's {len(items)} test pairs, host transfer route vs the card's: worst share "
          f"close {close:.5f} (>= {HOST_ROUTE_CLOSE}), worst mean |difference| {mean:.3g} (< {HOST_ROUTE_MEAN}) "
          f"[{tag}]", flush=True)

    syn = tds.SyntheticUvitonDataset(num_samples=32, resolution=256, seed=0)
    batches = [tds.collate([syn[i] for i in range(b, b + 16)]) for b in (0, 16)]
    n, close, mean = 0, 1.0, 0.0
    for item in hr.HostRoutingPipeline(iter(batches), hr.training_route_fn()):
        hb = item["host_batch"]
        img = torch.as_tensor(hb["image"], device="cuda").float() / 255.0
        up, lo = (torch.as_tensor(hb[k], device="cuda").float() for k in ("upper_mask", "lower_mask"))
        dev = route_patches_batch(img * up, img * lo, up, lo, torch.as_tensor(hb["keypoints"], device="cuda").float())
        c, m = route_agreement(torch, item["routed"], dev, keys[:5])
        close, mean, n = min(close, c), max(mean, m), n + 1
    torch.cuda.synchronize()
    launches = ck.launch_counts()
    assert n == 2
    print(f"host_routing: HostRoutingPipeline(training_route_fn()) over 32 synthetic samples, 2 batches of 16, each "
          f"held to the card's training route: worst share close {close:.5f}, mean |difference| {mean:.3g} [{tag}]",
          flush=True)
    check_launches("host_routing", launches, {"norm_warp": 3, "composite": 3})

    n_threads = os.cpu_count() or 1
    times = {}
    for workers in sorted({1, 4, n_threads}):
        ts = []
        for _ in range(3):
            s = time.perf_counter()
            hr.route_patches_host_transfer_batch(*np_args, workers=workers)
            ts.append((time.perf_counter() - s) * 1e3)
        times[workers] = statistics.median(ts)
    dev_ms, _ = host_ms(torch, lambda: route_patches_transfer_batch(*card_args), 10)
    print(f"host_routing: transfer route of {len(items)} pairs (256x192), host ms a batch by sample threads "
          + ", ".join(f"{w}: {ms:.1f}" for w, ms in times.items())
          + f" ({n_threads} CPU threads; the warp also splits its rows); the card's route {dev_ms:.2f} ms [{tag}]",
          flush=True)
    print(f"host_routing: {time.perf_counter() - t0:.1f} s [{tag}]", flush=True)
    return {"host_routing": launches}


def tools_phase(torch, tag, tmp):
    """The dataset tools: `cli.dataset_tool convert` of the fixture's 256x192
    images into a zip at --resolution 64, read back and counted, and
    `cli.draw_point` on one fixture person (no PIL on this machine: this is
    what shows the tools run here)."""
    import zipfile

    from pasta_gan_tpu_torch.cli import dataset_tool, draw_point
    from pasta_gan_tpu_torch.data import image_io

    t0 = time.perf_counter()
    src = os.path.join(fixture_root(), "UPT_subset1_256_192", "image")
    names = sorted(n for n in os.listdir(src) if n.lower().endswith((".jpg", ".jpeg", ".png")))
    dest = os.path.join(tmp, "tools_fixture64.zip")
    n = dataset_tool.main(["convert", "--source", src, "--dest", dest, "--resolution", "64"])
    with zipfile.ZipFile(dest) as z:
        pngs = sorted(m for m in z.namelist() if m.endswith(".png"))
        shapes = {image_io.decode_bytes(z.read(m), m)[0].shape for m in pngs}
        meta = json.loads(z.read("dataset.json"))
    assert n == len(names) == len(pngs) and shapes == {(64, 64, 3)} and meta["labels"] is None, (n, shapes, meta)
    stem = os.path.splitext(names[0])[0]
    out_png = os.path.join(tmp, "tools_overlay.png")
    overlay = draw_point.main(["--image", os.path.join(src, names[0]), "--keypoints", os.path.join(
        fixture_root(), "UPT_subset1_256_192", "keypoints", f"{stem}_keypoints.json"), "--out", out_png])
    back = image_io.read_image(out_png)
    drawn = int((back != image_io.read_rgb(os.path.join(src, names[0]))).any(-1).sum())
    assert back.shape == (256, 192, 3) and (back == overlay).all() and drawn > 100, (back.shape, drawn)
    print(f"tools: dataset_tool packed {n} fixture images at 64x64 (read back: {len(pngs)} PNGs); draw_point drew "
          f"{drawn} pixels over {names[0]}; {time.perf_counter() - t0:.1f} s [{tag}]", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pasta_gan_tpu_torch.ops import cuda_kernels as ck
    from pasta_gan_tpu_torch.ops import warp_kernels as wk

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = card_tag()
    print(f"card: {tag}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    reports = ck.build_kernels()
    print(f"built {sorted(reports) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    results = kernel_phase(torch, wk, tag)
    results.update(v18_kernel_phase(torch, wk, tag))
    kernel_512_phase(torch, wk, tag)
    results.update(fir_kernel_phase(torch, tag))
    with tempfile.TemporaryDirectory() as tmp:
        launches = {"serving_full": slice_phase(torch, wk, ck, tag, tmp)}
        launches.update(v18_phase(torch, wk, ck, tag, tmp))
        launches.update(serving_512_phase(torch, wk, ck, tag, tmp))
        int8_launches, results["int8_conv"] = int8_serving_phase(torch, wk, ck, tag, tmp)
        launches.update(int8_launches)
        launches["training"] = train_phase(torch, ck, tag, tmp)
        launches["training_ada"] = train_ada_phase(torch, ck, tag, tmp)
        launches["training_reg"] = train_reg_phase(torch, ck, tag, tmp)
        launches.update(real_data_phase(torch, ck, tag, tmp))
        launches.update(metrics_phase(torch, ck, tag, tmp))
        launches.update(metrics_conditional_phase(torch, ck, tag, tmp))
        launches["training_transfer"], pkl, expected = transfer_phase(torch, ck, tag, tmp)
        launches.update(stock_phase(torch, ck, tag, pkl, expected))
        del expected
        launches.update(plain_512_phase(torch, ck, tag))
        launches.update(zoo_phase(torch, ck, tag))
        launches.update(v1_phase(torch, ck, tag))
        launches.update(patch_d_phase(torch, ck, tag))
        launches.update(host_routing_phase(torch, ck, tag))
        tools_phase(torch, tag, tmp)
    train_card_vs_cpu(torch, tag)
    train_card_vs_cpu(torch, tag, "ADA debug percentile", ada="debug")
    train_card_vs_cpu(torch, tag, "ADA random draws", ada="random")
    train_card_vs_cpu(torch, tag, "style mixing and the contextual loss", reg=True)
    contextual_card_vs_cpu(torch, tag)

    kernels = [
        {"name": name, "route": "cuda", "source": f"pasta_gan_tpu_torch/csrc/{ck.KERNELS[name].source}",
         "replaces": REPLACES[name], "launches": sum(counts[name] for counts in launches.values()),
         "max_abs_err": res["err"], "ms": res["entry_ms"], "ms_median": res["entry_median"],
         "wrapper_ms": res["ms"], "wrapper_ms_median": res["ms_median"], "plain_ms": res["plain_ms"],
         "bound_ms": res["bound_ms"],
         "bound_by": res["bound_by"], "library_ms": res["library_ms"],
         "launches_by_path": {path: counts[name] for path, counts in launches.items()}}
        for name, res in results.items()
    ]
    assert sorted(k["name"] for k in kernels) == sorted(ck.KERNELS), "a kernel is missing from the kernels line"
    assert all(k["launches"] > 0 for k in kernels), "a kernel launched on no path"
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all [{tag}]", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
