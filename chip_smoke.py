#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`pasta_gan_tpu_torch`) on one NVIDIA GPU.

  python3 chip_smoke.py    # needs one NVIDIA GPU; the last line is the JSON verdict

Phases, each fatal on failure:
1. Build the routing kernels from `pasta_gan_tpu_torch/csrc/` with nvcc (one
   process per source, all started together).
2. Kernel phase, at the try-on path's batch-16 shapes: each kernel against
   its plain PyTorch version on the card (fp32, TF32 off), with times from
   CUDA events (L2 flushed before each launch), the byte/operation bound
   (the bytes are the 32-byte sectors this run's taps reach) and, for the
   norm warp, `grid_sample` as the library yardstick.
3. Slice phase: a full-width GeneratorFull (channel_base 16384, channel_max
   512, 256px) drawn from a seeded generator is saved as a snapshot and
   served through `pasta_gan_tpu_torch.cli.test.main` for 16 synthetic pairs;
   both kernels' launch counters must rise during that run.  Then the card's
   result is held against the port's CPU path on a small input, the bf16
   forward against the fp32 one at batch 16, and the end-to-end try-on
   (routing + bf16 forward) is timed at batch 16 and 1, each step also under
   `torch.profiler` (device ms, busy share, device operations, top ones).
Every number printed is tagged with the card's name and power limit.
"""

import json
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
# bf16 vs fp32 forward, ||bf16 - fp32|| / ||fp32|| of the finetune image.  bf16
# keeps 8 mantissa bits (2^-8 = 0.4 % per rounding); with this script's
# snapshot init at channel_base 512 on the CPU a correct bf16 path gives 0.031,
# and a bf16-only fault that clamps the demodulation coefficients gives 2.07.
BF16_REL_L2 = 0.1


def card_tag():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_time_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of fn() over `iters` launches, CUDA events around each
    launch; a 256 MB write before each one evicts the 50 MB L2, as the main
    path finds it cold."""
    scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        scratch.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        total += s.elapsed_time(e)
    return total / iters


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


def composite_patch_bytes(torch, wk, patches, minv, valid, frame_hw, groups, erode_parts):
    """Bytes of the planar patches [B, N, 4, h, w] that the composite must
    read for this run's data: the mask channel's taps of nonzero weight at
    every frame pixel each valid part reaches, and the image channels' taps
    only where the part is the last saturated one of its group (the pixel it
    leaves in the output)."""
    from pasta_gan_tpu_torch.ops.warp_math import warp_coords

    B, N, C, Hs, Ws = patches.shape
    H, W = frame_hw
    sx, sy = warp_coords(minv, frame_hw)  # [B, N, H, W]
    live = (valid != 0)[..., None, None] & (sx > -1) & (sx < Ws) & (sy > -1) & (sy < Hs)
    sx, sy = sx.clamp(-1.0, float(Ws)), sy.clamp(-1.0, float(Hs))
    x0, y0 = torch.floor(sx), torch.floor(sy)
    xi, yi = x0.long(), y0.long()
    taps = []  # (y, x, in range with nonzero weight)
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yy, xx = yi + dy, xi + dx
        keep = (yy >= 0) & (yy < Hs) & (xx >= 0) & (xx < Ws)
        if dx:
            keep &= sx > x0
        if dy:
            keep &= sy > y0
        taps.append((yy, xx, keep))

    sat = wk.denorm_warp_reference(patches, minv, frame_hw)[:, :, 3] >= wk.MASK_SATURATION_THRESHOLD
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
    for yy, xx, keep in taps:
        pix = yy * Ws + xx
        offs.append((((bp * C + 3) * Hs * Ws + pix) * 4)[keep & live])
        for c in range(3):
            offs.append((((bp * C + c) * Hs * Ws + pix) * 4)[keep & live & winner])
    return sector_bytes(torch, nbytes(patches), torch.cat(offs))


def near_threshold_pixels(torch, wk, srcs, minv, valid, frame_hw, erode_parts):
    """[B, H, W] bool: pixels where a kernel/plain rounding difference could
    flip a saturation decision (plain mask value within NEAR of the threshold,
    dilated by the 5x5 erosion for eroded parts)."""
    F = torch.nn.functional
    m = wk.denorm_warp_reference(srcs, minv, frame_hw)[:, :, 3] * valid[:, :, None, None]
    near = ((m - wk.MASK_SATURATION_THRESHOLD).abs() <= NEAR).float()
    ero = [p for p, e in enumerate(erode_parts) if e]
    near[:, ero] = F.max_pool2d(near[:, ero], 5, stride=1, padding=2)
    return near.amax(dim=1) > 0


def kernel_phase(torch, wk, tag):
    from pasta_gan_tpu_torch.data.dataset import SyntheticUvitonDataset, collate, tryon_warp_inputs

    F = torch.nn.functional
    B = 16
    ds = SyntheticUvitonDataset(num_samples=B)
    person = collate([ds[i] for i in range(B)])
    garment = collate([ds[(i + 1) % B] for i in range(B)])
    r = tryon_warp_inputs(person, garment, device="cuda")
    results = {}

    # ---- norm_warp
    args = (r["src_u"], r["src_l"], r["minv_norm"], r["valid_norm"], r["n_upper"], r["patch_hw"])
    assert bool(torch.isfinite(r["minv_norm"]).all()), "non-finite routing matrices"
    out_k = wk.norm_warp(*args)
    out_p = wk.norm_warp_reference(*args)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    assert err <= TOL, f"norm_warp disagrees with its plain version: {err}"
    N = r["minv_norm"].shape[1]
    h, w = r["patch_hw"]
    H, W = r["src_u"].shape[1:3]
    # grid_sample yardstick: one call per source frame, explicit pixel coordinates
    from pasta_gan_tpu_torch.ops.warp_math import warp_coords

    sx, sy = warp_coords(r["minv_norm"], (h, w))  # [B, N, h, w]
    grid = torch.stack([sx / (W - 1) * 2 - 1, sy / (H - 1) * 2 - 1], dim=-1)
    n0 = r["n_upper"]
    g_u = grid[:, :n0].reshape(B, n0 * h, w, 2).contiguous()
    g_l = grid[:, n0:].reshape(B, (N - n0) * h, w, 2).contiguous()
    nchw_u = r["src_u"].permute(0, 3, 1, 2).contiguous()
    nchw_l = r["src_l"].permute(0, 3, 1, 2).contiguous()

    def library():
        F.grid_sample(nchw_u, g_u, mode="bilinear", padding_mode="border", align_corners=True)
        F.grid_sample(nchw_l, g_l, mode="bilinear", padding_mode="border", align_corners=True)

    ref = F.grid_sample(nchw_u, g_u, mode="bilinear", padding_mode="border", align_corners=True)
    lib_err = float((ref.reshape(B, 4, n0, h, w).transpose(1, 2) * r["valid_norm"][:, :n0, None, None, None]
                     - out_p[:, :n0]).abs().max())
    src_bytes = norm_source_bytes(torch, r)
    byts = src_bytes + nbytes(r["minv_norm"], r["valid_norm"], out_k)
    ops = B * N * h * w * 52  # ~12 flops of coordinates + 4 channels x 9 of blend + gate
    results["norm_warp"] = dict(
        err=err, ms=cuda_time_ms(torch, lambda: wk.norm_warp(*args)),
        plain_ms=cuda_time_ms(torch, lambda: wk.norm_warp_reference(*args)),
        library_ms=cuda_time_ms(torch, library),
        bytes=byts, ops=ops,
        extra=(f"source sectors read {src_bytes / 1e6:.2f} of {nbytes(r['src_u'], r['src_l']) / 1e6:.2f} MB; "
               f"grid_sample max |diff| vs plain {lib_err:.3g}"),
    )

    # ---- composite (fed the plain norm output, so both sides see the same patches)
    cargs = (out_p, r["minv_denorm"], r["valid_denorm"], r["frame_hw"], r["groups"],
             r["erode_parts"], r["hand_parts"])
    g_k, h_k = wk.composite(*cargs)
    g_p, h_p = wk.composite_reference(*cargs)
    torch.cuda.synchronize()
    near = near_threshold_pixels(torch, wk, out_p, r["minv_denorm"], r["valid_denorm"],
                                 r["frame_hw"], r["erode_parts"])
    keep = ~near
    err = max(float(((g_k - g_p).abs() * keep[:, None, None]).max()),
              float(((h_k - h_p).abs() * keep[:, None]).max()))
    assert err <= TOL, f"composite disagrees with its plain version: {err}"
    n_excl = int(near.sum())
    Hf, Wf = r["frame_hw"]
    n_valid = int(r["valid_denorm"].sum())
    n_ero = int(sum(r["erode_parts"][p] * r["valid_denorm"][:, p].sum().item() for p in range(N)))
    patch_bytes = composite_patch_bytes(torch, wk, out_p, r["minv_denorm"], r["valid_denorm"], r["frame_hw"],
                                        r["groups"], r["erode_parts"])
    byts = patch_bytes + nbytes(r["minv_denorm"], r["valid_denorm"], g_k, h_k)
    # per valid (sample, part): coordinates + mask blend (~21 flops) per frame pixel,
    # a 5x5 min (~8 flops) per pixel of eroded parts, and the 3-channel blend where saturated
    sat_px = int((wk.denorm_warp_reference(out_p, r["minv_denorm"], r["frame_hw"])[:, :, 3]
                  >= wk.MASK_SATURATION_THRESHOLD).sum())
    ops = n_valid * Hf * Wf * 21 + n_ero * Hf * Wf * 8 + sat_px * 27
    results["composite"] = dict(
        err=err, ms=cuda_time_ms(torch, lambda: wk.composite(*cargs)),
        plain_ms=cuda_time_ms(torch, lambda: wk.composite_reference(*cargs)),
        library_ms=None, bytes=byts, ops=ops,
        extra=(f"patch sectors read {patch_bytes / 1e6:.2f} of {nbytes(out_p) / 1e6:.2f} MB; "
               f"{n_excl} near-threshold pixels not compared"),
    )
    for name, res in results.items():
        res["bound_ms"] = max(res["bytes"] / PEAK_BYTES_PER_S, res["ops"] / PEAK_FP32_FLOPS) * 1e3
        res["bound_by"] = "bytes" if res["bytes"] / PEAK_BYTES_PER_S >= res["ops"] / PEAK_FP32_FLOPS else "operations"
        lib = "null" if res["library_ms"] is None else f"{res['library_ms']:.4f}"
        print(f"kernel {name}: max_abs_err={res['err']:.3g} kernel_ms={res['ms']:.4f} "
              f"plain_ms={res['plain_ms']:.4f} bound_ms={res['bound_ms']:.4f} ({res['bound_by']}) "
              f"library_ms={lib}; {res['extra']} [{tag}]", flush=True)
    return results


def slice_phase(torch, wk, tag, tmp):
    from pasta_gan_tpu_torch.cli import test as cli
    from pasta_gan_tpu_torch.data.dataset import (
        SyntheticUvitonDataset, collate, prepare_tryon_batch, tryon_warp_inputs,
    )
    from pasta_gan_tpu_torch.io.checkpoints import save_snapshot
    from pasta_gan_tpu_torch.models import GeneratorFull

    g = torch.Generator().manual_seed(0)
    gen = GeneratorFull(img_resolution=256, channel_base=16384, channel_max=512).reset_parameters(g)
    snap = os.path.join(tmp, "snapshot.pt")
    save_snapshot(snap, gen.state_dict(), 0.1 * torch.randn(512, generator=g), {"model": gen.config})
    outdir = os.path.join(tmp, "tryon")

    wk.reset_launch_counts()
    t0 = time.perf_counter()
    written = cli.main(["--network", snap, "--synthetic", "16", "--batchsize", "16", "--outdir", outdir])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {k: v.launches for k, v in wk.KERNELS.items()}
    print(f"cli.test: {len(written)} images in {cli_s:.2f} s (first call, includes loading); "
          f"launches {launches} [{tag}]", flush=True)
    assert len(written) == 16 and all(os.path.getsize(p) > 1000 for p in written), "missing try-on PNGs"
    for p in written:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", p
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was not launched on the main path"

    # ---- the card's result against the port's CPU path on a small input
    ds = SyntheticUvitonDataset(num_samples=4, seed=3)
    person, garment = collate([ds[0], ds[1]]), collate([ds[2], ds[3]])
    b_gpu = prepare_tryon_batch(person, garment, device="cuda")
    b_cpu = prepare_tryon_batch(person, garment, device="cpu")
    r = tryon_warp_inputs(person, garment, device="cpu")
    patches = wk.norm_warp_reference(r["src_u"], r["src_l"], r["minv_norm"], r["valid_norm"], r["n_upper"], r["patch_hw"])
    near = near_threshold_pixels(torch, wk, patches, r["minv_denorm"], r["valid_denorm"], r["frame_hw"],
                                 r["erode_parts"])[..., None]
    worst = 0.0
    for k in b_cpu:
        d = (b_gpu[k].cpu() - b_cpu[k]).abs()
        if d.shape[1:3] == near.shape[1:3]:
            d = d * ~near
        worst = max(worst, float(d.max()))
    assert worst <= TOL, f"try-on batch on the card differs from the CPU path: {worst}"
    thin = GeneratorFull(img_resolution=256, channel_base=512, channel_max=32)
    thin.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        o_cpu = cli.tryon_forward(thin.eval(), torch.zeros(512), b_cpu)
        o_gpu = cli.tryon_forward(thin.cuda(), torch.zeros(512, device="cuda"), {k: v.cuda() for k, v in b_cpu.items()})
    gerr = float((o_gpu.cpu() - o_cpu).abs().max())
    ok = torch.allclose(o_gpu.cpu(), o_cpu, rtol=1e-2, atol=1e-2)
    print(f"card vs CPU (batch 2): routing max_abs_err={worst:.3g} ({int(near.sum())} near-threshold "
          f"pixels excluded), thin-generator finetune max_abs_err={gerr:.3g} [{tag}]", flush=True)
    assert ok, "generator output on the card differs from the CPU path"

    # ---- the timed bf16 forward against the same snapshot's fp32 forward, full width
    gen, w_avg = cli.load_generator(snap, torch.device("cuda"))

    def on_card(d):
        return {k: torch.as_tensor(v, device="cuda") for k, v in d.items()}

    ds = SyntheticUvitonDataset(num_samples=16)
    p16 = on_card(collate([ds[i] for i in range(16)]))
    g16 = on_card(collate([ds[(i + 1) % 16] for i in range(16)]))
    p1, g1 = on_card(collate([ds[0]])), on_card(collate([ds[1]]))
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
    def route(p, gm):
        b = prepare_tryon_batch(p, gm, device="cuda")
        return {k: v.to(torch.bfloat16) for k, v in b.items()}

    def host_ms(fn, iters):
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

    torch.cuda.reset_peak_memory_stats()
    for B, p, gm, iters in ((16, p16, g16, 10), (1, p1, g1, 20)):
        e2e_ms, out = host_ms(lambda: cli.tryon_forward(gen, w_avg, route(p, gm)), iters)
        assert tuple(out.shape) == (B, 256, 256, 3) and bool(torch.isfinite(out.float()).all())
        batch = route(p, gm)
        steps = {"routing": lambda: route(p, gm), "forward": lambda: cli.tryon_forward(gen, w_avg, batch)}
        split = []
        for name, fn in steps.items():
            ms, _ = host_ms(fn, iters)
            device_ms, n_ops, top = device_profile(torch, fn)
            split.append(f"{name} {ms:.2f} ms")
            busy = "not measured" if device_ms is None else f"{device_ms / ms:.3f}"
            dev = "not measured (no device time in the trace)" if device_ms is None else f"{device_ms:.3f} ms"
            print(f"profile batch {B} {name}: host {ms:.2f} ms, device {dev}, busy {busy}, "
                  f"{n_ops:.0f} device ops per run [{tag}]", flush=True)
            for op, op_ms, n in top:
                print(f"    {op_ms:9.3f} ms {n:7.1f}x  {op[:100]}", flush=True)
        print(f"end-to-end try-on (routing + bf16 forward, full width): batch {B} {e2e_ms:.2f} ms, "
              f"{B / e2e_ms * 1e3:.1f} imgs/s (median of {iters}; {' + '.join(split)}) [{tag}]", flush=True)
    print(f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated [{tag}]", flush=True)
    return launches


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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pasta_gan_tpu_torch.ops import warp_kernels as wk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = card_tag()
    print(f"card: {tag}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    reports = wk.build_kernels()
    print(f"built {sorted(reports) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    results = kernel_phase(torch, wk, tag)
    with tempfile.TemporaryDirectory() as tmp:
        launches = slice_phase(torch, wk, tag, tmp)

    replaces = {"norm_warp": "pasta_gan_tpu/ops/pallas_warp.py:172",
                "composite": "pasta_gan_tpu/ops/pallas_warp.py:480"}
    kernels = [
        {"name": name, "route": "cuda", "source": f"pasta_gan_tpu_torch/csrc/{wk.KERNELS[name].source}",
         "replaces": replaces[name], "launches": launches[name], "max_abs_err": res["err"],
         "ms": res["ms"], "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
         "bound_by": res["bound_by"], "library_ms": res["library_ms"]}
        for name, res in results.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
