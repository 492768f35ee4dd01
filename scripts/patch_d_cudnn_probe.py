#!/usr/bin/env python3
"""Which convolution of the patch discriminators moves their fp32 gradient
on cuDNN, and what a non-FFT path costs, on one NVIDIA GPU:

  python3 scripts/patch_d_cudnn_probe.py

TF32 is off throughout.  Part 1 records every convolution of one thin
forward + backward of both patch discriminators (`chip_smoke.PD_THIN`,
batch 2, the smoke's draws) through a `TorchFunctionMode`, with the output
gradient of each; then runs each call's forward, input gradient (dgrad) and
weight gradient (wgrad) alone on the card with cuDNN, under the profiler,
and prints the relative L2 error of each against float64 on the CPU beside
the device kernels it ran (cuDNN's algorithm shows in their names: `fft`,
`winograd`, `implicit_convolve`, `xmma`...); the depthwise FIR
convolutions (`ops/upfirdn2d.py:_correlate`, forward and backward alike,
recorded by a wrapper since they run inside an autograd Function) likewise.
Part 2 prints the gradient to the fake image against the CPU's (the smoke's
check) and the time of the full-size step (defaults, batch 16, CUDA events,
median of 10) for: cuDNN as PyTorch picks it, cuDNN off, cuDNN off for the
depthwise FIR alone, channels_last activations and weights (NHWC kernels,
which have no FFT algorithm), and `cudnn.benchmark`.  Part 3 holds the
gradient at every leaf module's output of the card's step (cuDNN on, then
off) to the CPU's, in the order backward reaches them, so the first layer
whose backward moves it shows."""

import os
import statistics
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import torch
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from pasta_gan_tpu_torch.nn.patch_discriminator import StyleGAN2PatchDiscriminator, StyleGAN2PatchDiscriminatorV2
    from pasta_gan_tpu_torch.ops import cuda_kernels as ck
    from pasta_gan_tpu_torch.ops import upfirdn2d as ud

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = cs.card_tag()
    ck.build_kernels([ck.UP2, ck.DOWN2])

    def build(cfg, device, seed):
        g = torch.Generator(device=device).manual_seed(seed)
        with torch.device(device):
            return [cls(**cfg).reset_parameters(g) for cls in (StyleGAN2PatchDiscriminator,
                                                               StyleGAN2PatchDiscriminatorV2)]

    def frames(batch, device):
        g = torch.Generator().manual_seed(31)
        return [(torch.rand((batch, 3, 256, 256), generator=g) * 2 - 1).to(device) for _ in range(2)]

    g = torch.Generator().manual_seed(34)
    Dc, D2c = build(cs.PD_THIN, "cpu", 33)
    draws = (Dc.draw_patches(2, 256, 256, g), Dc.draw_patches(2, 256, 256, g))
    draws2 = (D2c.draw_patches(2, 256, 256, g), None)

    # ---- part 1: every convolution of the thin step, each of its three passes alone
    calls = []

    class Record(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func in (F.conv2d, torch.conv2d) and torch.is_tensor(out) and out.requires_grad:
                x, w = args[0], args[1]
                opts = {k: kwargs.get(k, d) for k, d in (("stride", 1), ("padding", 0), ("groups", 1))}
                for i, k in enumerate(("bias", "stride", "padding", "dilation", "groups")[: len(args) - 2]):
                    if k in opts:
                        opts[k] = args[2 + i]
                rec = dict(x=x.detach().clone(), w=w.detach().clone(), opts=opts, gy=None)
                # the output gradient as autograd hands it on, strides and all
                out.register_hook(lambda gy, rec=rec: rec.__setitem__("gy", gy.detach()))
                calls.append(rec)
            return out

    correlate, firs = ud._correlate, []

    def recorded(x, f, padding):
        firs.append((x.detach().clone(), f.detach().clone(), padding))
        return correlate(x, f, padding)

    D, D2 = [m.to("cuda") for m in build(cs.PD_THIN, "cpu", 33)]
    ud._correlate = recorded
    try:
        with Record():
            cs.patch_d_step(torch, D, D2, *frames(2, "cuda"), draws, draws2)
        torch.cuda.synchronize()
    finally:
        ud._correlate = correlate
    print(f"patch_d thin step: {len(calls)} convolutions [{tag}]", flush=True)

    def rel(a, b):
        return float((a.double().cpu() - b).norm() / b.norm().clamp_min(1e-300))

    worst = defaultdict(float)
    for i, c in enumerate(calls):
        if c["gy"] is None:
            continue
        x, w, gy, o = c["x"], c["w"], c["gy"], c["opts"]
        stride, pad, groups = o["stride"], o["padding"], o["groups"]
        x64, w64, gy64 = x.double().cpu().requires_grad_(True), w.double().cpu().requires_grad_(True), gy.double().cpu()
        y64 = F.conv2d(x64, w64, stride=stride, padding=pad, groups=groups)
        dx64, dw64 = torch.autograd.grad(y64, (x64, w64), gy64)
        gyc = gy.contiguous()
        passes = {
            "forward": (lambda: F.conv2d(x, w, stride=stride, padding=pad, groups=groups), y64.detach()),
            "dgrad": (lambda: torch.nn.grad.conv2d_input(x.shape, w, gy, stride=stride, padding=pad, groups=groups),
                      dx64),
            "dgrad, contiguous output gradient": (
                lambda: torch.nn.grad.conv2d_input(x.shape, w, gyc, stride=stride, padding=pad, groups=groups), dx64),
            "wgrad": (lambda: torch.nn.grad.conv2d_weight(x, w.shape, gy, stride=stride, padding=pad, groups=groups),
                      dw64),
        }
        for name, (fn, ref) in passes.items():
            fn()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                got = fn()
                torch.cuda.synchronize()
            kernels = sorted({e.name.split("(")[0][:60] for e in prof.events()
                              if e.device_type == torch.autograd.DeviceType.CUDA})
            err = rel(got, ref)
            key = (tuple(w.shape), stride, pad, groups, name)
            worst[key] = max(worst[key], err)
            print(f"conv {i}: x {list(x.shape)} w {list(w.shape)} stride {stride} pad {pad} groups {groups} {name} "
                  f"(output gradient strides {gy.stride()}): "
                  f"relative L2 vs float64 {err:.3g}; kernels {kernels} [{tag}]", flush=True)
    for i, (x, f, padding) in enumerate(firs):
        ref = correlate(x.double().cpu(), f.double().cpu(), padding)
        correlate(x, f, padding)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = correlate(x, f, padding)
            torch.cuda.synchronize()
        kernels = sorted({e.name.split("(")[0][:60] for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA})
        err = rel(got, ref)
        key = (tuple(f.shape), tuple(x.shape[1:]), padding, 1, "depthwise FIR")
        worst[key] = max(worst[key], err)
        print(f"FIR {i}: x {list(x.shape)} f {list(f.shape)} padding {padding}: relative L2 vs float64 {err:.3g}; "
              f"kernels {kernels} [{tag}]", flush=True)
    for key, err in sorted(worst.items(), key=lambda kv: -kv[1])[:8]:
        print(f"worst: w {list(key[0])} stride {key[1]} pad {key[2]} groups {key[3]} {key[4]}: {err:.3g} [{tag}]",
              flush=True)

    # ---- part 2: the smoke's check and the full-size step's time under each path
    cpu = cs.patch_d_step(torch, Dc, D2c, *frames(2, "cpu"), draws, draws2)[2].detach()

    def fir_without_cudnn(x, f, padding):
        with torch.backends.cudnn.flags(enabled=False):
            return correlate(x, f, padding)

    def variant(name):
        torch.backends.cudnn.enabled = name != "cudnn off"
        torch.backends.cudnn.benchmark = name == "cudnn.benchmark"
        ud._correlate = fir_without_cudnn if name == "FIR without cudnn" else correlate
        fmt = torch.channels_last if name == "channels_last" else torch.contiguous_format
        return fmt

    for name in ("cudnn default", "cudnn off", "FIR without cudnn", "channels_last", "cudnn.benchmark"):
        fmt = variant(name)
        try:
            Dt, D2t = [m.to("cuda", memory_format=fmt) for m in build(cs.PD_THIN, "cpu", 33)]
            real, fake = (t.contiguous(memory_format=fmt) for t in frames(2, "cuda"))
            grad = cs.patch_d_step(torch, Dt, D2t, real, fake, draws, draws2)[2]
            g_rel = float((grad.cpu() - cpu).norm() / cpu.norm())
            Df, D2f = build({}, "cuda", 31)
            Df, D2f = Df.to(memory_format=fmt), D2f.to(memory_format=fmt)
            real, fake = (t.contiguous(memory_format=fmt) for t in frames(cs.PD_BATCH, "cuda"))
            gd = torch.Generator().manual_seed(32)
            dr = (Df.draw_patches(cs.PD_BATCH, 256, 256, gd), Df.draw_patches(cs.PD_BATCH, 256, 256, gd))
            dr2 = (D2f.draw_patches(cs.PD_BATCH, 256, 256, gd), None)
            step = lambda: cs.patch_d_step(torch, Df, D2f, real, fake, dr, dr2)  # noqa: E731
            for _ in range(3):
                step()
            ts = []
            for _ in range(10):
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                step()
                e.record()
                torch.cuda.synchronize()
                ts.append(s.elapsed_time(e))
            print(f"{name}: gradient to the fake image relative L2 vs the CPU {g_rel:.3g}; full-size step (batch "
                  f"{cs.PD_BATCH}) {statistics.median(ts):.2f} ms [{tag}]", flush=True)
            del Df, D2f, real, fake
            torch.cuda.empty_cache()
        finally:
            torch.backends.cudnn.enabled = True
            torch.backends.cudnn.benchmark = False
            ud._correlate = correlate

    # ---- part 3: the gradient at every leaf module's output, card against CPU, in backward order
    def layer_grads(dev, cudnn):
        Dt, D2t = [m.to(dev) for m in build(cs.PD_THIN, "cpu", 33)]
        rec, hooks, calls_of = [], [], defaultdict(int)
        for root, tagname in ((Dt, "V1"), (D2t, "V2")):
            for name, mod in root.named_modules():
                if next(mod.children(), None) is None:
                    def hook(m, i, o, name=f"{tagname}.{name}"):
                        if torch.is_tensor(o) and o.requires_grad:
                            k = calls_of[name]
                            calls_of[name] += 1
                            o.register_hook(lambda g, name=name, k=k: rec.append((name, k, g.detach().cpu())))
                    hooks.append(mod.register_forward_hook(hook))
        torch.backends.cudnn.enabled = cudnn
        try:
            cs.patch_d_step(torch, Dt, D2t, *frames(2, dev), draws, draws2)
        finally:
            torch.backends.cudnn.enabled = True
            for h in hooks:
                h.remove()
        return rec

    ref = {(n, k): g for n, k, g in layer_grads("cpu", True)}
    for cudnn in (True, False):
        rows = []
        for n, k, g in layer_grads("cuda", cudnn):
            r = ref.get((n, k))
            if r is not None and r.shape == g.shape:
                rows.append(f"{n}#{k} {float((g - r).norm() / r.norm().clamp_min(1e-30)):.2e}")
        print(f"part 3, cuDNN {'on' if cudnn else 'off'}: the gradient at each leaf module's output, relative L2 to "
              f"the CPU's, in backward order: {'; '.join(rows)} [{tag}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
