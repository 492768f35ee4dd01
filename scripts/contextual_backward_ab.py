#!/usr/bin/env python3
"""The contextual loss's backward on one NVIDIA GPU: the port's derived
backward against autograd through the same chunk formula.

    python3 scripts/contextual_backward_ab.py [--batch 4]

`train/losses.py:_CXRowMax` recomputes each chunk of affinities and applies
the formula's derivative by hand.  The alternative it replaced recomputes the
chunk under autograd and differentiates it (`autograd_contextual_loss`
below, the JAX formula written out as tensor operations).  On relu1_2-sized
features ([batch, 256, 256, 64] fp32, H*W = 65536, TF32 off) both must give
the same value and gradients within a relative L2 of 1e-5; then each is
timed (forward, and forward + backward; CUDA events, median of 2) in turns
autograd, derived, derived, autograd.
"""

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pasta_gan_tpu_torch.train import losses  # noqa: E402


def _row_max(xf, yf, h):
    d = 1.0 - torch.matmul(xf, yf.transpose(1, 2))
    d_norm = d / (d.amin(dim=-1, keepdim=True) + 1e-3)
    w = torch.exp((1.0 - d_norm) / h)
    return (w / w.sum(dim=-1, keepdim=True)).amax(dim=-1)


class _AutogradRowMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xf, yf, h, chunk_elems):
        ctx.save_for_backward(xf, yf)
        ctx.h, ctx.chunk_elems = h, chunk_elems
        out = xf.new_empty(xf.shape[:2])
        for ns, rs in losses._cx_chunks(xf.shape[0], xf.shape[1], yf.shape[1], chunk_elems):
            _, _, w = losses._cx_affinities(xf[ns, rs], yf[ns], h, keep_d=False)
            out[ns, rs] = w.amax(dim=-1) / w.sum(dim=-1)
        return out

    @staticmethod
    def backward(ctx, grad):
        xf, yf = ctx.saved_tensors
        gx = torch.empty_like(xf)
        n, q, _ = xf.shape
        for ns, rs in losses._cx_chunks(n, q, yf.shape[1], ctx.chunk_elems):
            with torch.enable_grad():
                xc = xf[ns, rs].detach().requires_grad_(True)
                (gx[ns, rs],) = torch.autograd.grad(_row_max(xc, yf[ns], ctx.h), xc, grad[ns, rs])
        return gx, None, None, None


def autograd_contextual_loss(x, y, h=0.1):
    n, hh, ww, c = x.shape
    mu = y.mean(dim=-1, keepdim=True)
    xf = losses.feature_normalize(x - mu).reshape(n, hh * ww, c)
    yf = losses.feature_normalize(y - mu).reshape(n, hh * ww, c)
    cx = _AutogradRowMax.apply(xf, yf, h, losses.CONTEXTUAL_CHUNK_ELEMS).mean(dim=1)
    return (-torch.log(cx)).mean()


def event_ms(fn, iters=2):
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def main():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=4)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.relu(torch.randn((args.batch, 256, 256, 64), generator=g, device="cuda")).requires_grad_(True)
    y = torch.relu(torch.randn((args.batch, 256, 256, 64), generator=g, device="cuda"))
    fns = {"autograd": autograd_contextual_loss, "derived": losses.contextual_loss}
    ref = {}
    for name, fn in fns.items():
        v = fn(x, y)
        ref[name] = (float(v), torch.autograd.grad(v, x)[0])
    rel = float((ref["derived"][1] - ref["autograd"][1]).norm() / ref["autograd"][1].norm())
    print(f"value autograd {ref['autograd'][0]:.8g} derived {ref['derived'][0]:.8g}; gradient relative L2 {rel:.3g}",
          flush=True)
    assert ref["derived"][0] == ref["autograd"][0] and rel <= 1e-5, (ref["derived"][0], ref["autograd"][0], rel)
    for name in ("autograd", "derived", "derived", "autograd"):
        fn = fns[name]
        fwd = event_ms(lambda: fn(x, y))
        both = event_ms(lambda: torch.autograd.grad(fn(x, y), x))
        print(f"{name}: forward {fwd:.1f} ms, forward + backward {both:.1f} ms "
              f"([{args.batch}, 256, 256, 64] fp32; {card})", flush=True)


if __name__ == "__main__":
    main()
