"""Serving cells: the offline try-on renderer of `cli.test` / `cli.test_512`.

One client in a closed loop sends batches of (person, garment) pairs drawn
by seed from a pool of synthetic person records.  Each batch is the timed
path: `collate` -> the configuration's routing (`prepare_tryon_batch[_512]`)
-> `cli/test.py:tryon_forward` -> un-padded to the record's frame -> uint8
images on the host, what the service hands out (PNG encoding is left out).

Set-up: the pool's records through the program's `host_sample`, the
generator built on the card with the benchmark's seeded weights in the
traffic's dtype, and warm-up batches that build and load every kernel.
The window then runs batches until `seconds` have passed.  A traced run
also times routing and forward apart (each ended by a synchronise) and
profiles `trace_batches` more batches, recording each kernel launch.

After the window: the peak memory is read, the program's generator is
freed, and the reference re-routes (float32, TF32 off) and re-renders (at
the traffic's dtype) a sample of the window's batches, a reservoir drawn
from the seed, for the checks named in the cell's `checks/<workload>.json`.
"""

from __future__ import annotations

import time

import numpy as np

from ..harness import precision
from ..harness.flops import count_flops
from ..harness.names import PROGRAM, REFERENCE, resolve
from ..harness.pool import draw_pairs, host_pool
from ..harness.record import Record
from ..harness.weights import draw_weights, load_weights, template_of

# the routed tensors the generator takes, compared with the reference's
ROUTED_KEYS = ("style_input", "retain", "pose", "denorm_upper_img", "denorm_lower_img",
               "denorm_upper_mask", "denorm_lower_mask")
ROUTE_TOL = 1e-3  # an element of a routed tensor counts as off when it differs by more
MAX_BATCHES = 100_000


def to_uint8(out, cols):
    """The served images: [B, H, W, 3] in [-1, 1] -> the frame's columns, uint8
    as `cli/test.py:save_image` writes them (clip, then truncate)."""
    import torch

    return ((out[:, :, cols[0]:cols[1]].float() + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)


def build_model(package: str, cfg: dict, device, weights=None):
    import torch

    cls = resolve(package, cfg["model"]["class"])
    with torch.device(device):
        m = cls(**cfg["model"]["kwargs"])
    if weights is not None:
        load_weights(m, weights)
    return m.eval()


class Server:
    """The program under test, with the benchmark's inputs."""

    def __init__(self, spec, device, control: bool = False):
        import torch

        cfg, tr = spec.config, spec.traffic
        self.spec, self.device = spec, device
        self.batch = tr["batch"]
        self.cols = cfg["cols"]
        self.psi, self.noise_mode = tr["truncation_psi"], tr["noise_mode"]
        frame = tuple(cfg["frame"])
        self.collate = resolve(PROGRAM, "data.dataset:collate")
        t = time.perf_counter()
        self.pool = host_pool(spec.seed, tr["pool"], frame)
        self.persons, self.garments = draw_pairs(spec.seed, tr["pool"], self.batch, MAX_BATCHES)
        self.setup_phases = {"pool_s": time.perf_counter() - t}
        t = time.perf_counter()
        ref_cls = resolve(REFERENCE, cfg["model"]["class"])
        self.weights = draw_weights(template_of(lambda: ref_cls(**cfg["model"]["kwargs"])), spec.seed, device)
        g = torch.Generator(device=device).manual_seed(spec.seed % (2**63) + 1)
        self.w_avg = torch.randn(cfg["model"]["kwargs"].get("w_dim", 512), generator=g, device=device)
        self.gen = build_model(PROGRAM, cfg, device, self.weights)
        self.setup_phases["model_s"] = time.perf_counter() - t
        self.gen.set_dtype(getattr(torch, tr["dtype"]))
        route = resolve(PROGRAM, cfg["route"]["program"])
        kwargs = dict(cfg["route"]["kwargs"], denorm=tr["denorm"])
        self.route = lambda p, g: route(p, g, device=device, **kwargs)  # noqa: E731
        self.forward = resolve(PROGRAM, "cli.test:tryon_forward")
        if control:
            self._control()

    def _control(self):
        """The control: the program's own int8 serving path for the generator,
        and the reference's float32 routing rounded to bfloat16 in place of
        the program's routing (the routing is float32; the precision below)."""
        import torch

        self.gen.quant = "int8"
        ref_route = resolve(REFERENCE, self.spec.config["route"]["reference"])
        kwargs = dict(self.spec.config["route"]["kwargs"], denorm=self.spec.traffic["denorm"])

        def route(p, g):
            with precision.fp32_exact():
                b = ref_route(p, g, device=self.device, **kwargs)
            return {k: v.to(torch.bfloat16).float() for k, v in b.items()}

        self.route = route

    def inputs(self, i):
        return ([self.pool[j] for j in self.persons[i]], [self.pool[j] for j in self.garments[i]])

    def serve(self, i, spans=None):
        """Batch i through the timed path: (routed batch, uint8 images on the host, all finite)."""
        import torch

        persons, garments = self.inputs(i)
        t0 = time.perf_counter()
        with _span("routing"):
            batch = self.route(self.collate(persons), self.collate(garments))
            if spans is not None:
                torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        with _span("forward"):
            out = self.forward(self.gen, self.w_avg, batch, self.psi, self.noise_mode)
            img = to_uint8(out, self.cols)
            finite = torch.isfinite(out).all()
        with _span("to_host"):
            img = img.cpu()
        if spans is not None:
            spans.setdefault("routing", []).append(t1 - t0)
            spans.setdefault("forward", []).append(time.perf_counter() - t1)
        return batch, img, bool(finite)


def _span(name):
    import torch

    return torch.profiler.record_function(f"bench.{name}")


def run(spec, device, t_start: float, control: bool = False) -> Record:
    import torch

    tr = spec.traffic
    rec = Record(cell=spec.cell, config=spec.config, traffic=tr, trace_run=spec.trace,
                 units_per_request=tr["batch"])
    t_enter = time.time()
    srv = Server(spec, device, control=control)
    n_warm = tr["warmup_batches"]
    t = time.perf_counter()
    for i in range(MAX_BATCHES - n_warm, MAX_BATCHES):  # pairs the window does not use
        srv.serve(i)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rec.setup_s = time.time() - t_start
    phases = dict(imports_s=t_enter - t_start, **srv.setup_phases, warmup_s=time.perf_counter() - t)
    rec.notes.append("set-up " + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()))

    keep = Reservoir(tr["check_batches"], spec.seed)
    spans = {} if spec.trace else None
    start = time.perf_counter()
    deadline = start + spec.seconds
    i = 0
    while time.perf_counter() < deadline and i < MAX_BATCHES - n_warm - tr.get("trace_batches", 0):
        t0 = time.perf_counter()
        try:
            batch, img, finite = srv.serve(i, spans)
        except RuntimeError as e:  # a batch that fails counts against the attempted ones
            rec.failed += 1
            rec.notes.append(f"batch {i}: {e}")
            batch, img, finite = None, None, True
        t1 = time.perf_counter()
        rec.requests.append((t0, t1))
        if not finite:
            rec.failed += 1
        if batch is not None:
            keep.offer(i, lambda: ({k: batch[k] for k in ROUTED_KEYS}, img))
        i += 1
    rec.attempted = i
    rec.window_s = rec.requests[-1][1] - start if rec.requests else 0.0
    rec.spans = spans or {}

    if spec.trace:
        profile_batches(srv, rec, range(i, i + tr["trace_batches"]))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    weights, w_avg = srv.weights, srv.w_avg
    inputs = {j: srv.inputs(j) for j in keep.items}
    del srv
    if device.type == "cuda":
        torch.cuda.empty_cache()
    check(spec, device, keep.items, inputs, weights, w_avg, rec)
    return rec


class Reservoir:
    """A uniform sample of k of the window's batches, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.items = k, {}
        self.rng = np.random.default_rng([seed, 2])

    def offer(self, i, make):
        if len(self.items) < self.k:
            self.items[i] = make()
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.k:
                del self.items[sorted(self.items)[j]]
                self.items[i] = make()


def profile_batches(srv, rec, indices):
    """Serve `indices` under torch.profiler, recording every kernel launch's
    arguments (a wrapper on `CudaKernel.launch`, this segment only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..harness.trace import SEGMENT, read_profile

    ck = resolve(PROGRAM, "ops.cuda_kernels:CudaKernel")
    original = ck.launch

    def recorded(self, *args):
        rec.launches.append((self.name, args))
        return original(self, *args)

    torch.cuda.synchronize(srv.device)
    ck.launch = recorded
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(SEGMENT):
                for j in indices:
                    srv.serve(j)
                torch.cuda.synchronize(srv.device)
    finally:
        ck.launch = original
    rec.trace = read_profile(prof)
    rec.spans["trace_batches"] = [len(indices)]


def check(spec, device, kept, inputs, weights, w_avg, rec):
    """The reference re-routes and re-renders the kept batches.

    `route_share`: the largest share, over the kept batches, of routed
    elements more than ROUTE_TOL off the reference's routing (float32, TF32
    off, as the program routes).  `image_gap`: the largest mean |difference|,
    in uint8 levels, of one served image from the reference's image rendered
    at the precision the traffic states (bfloat16 weights and activations)
    and truncated to uint8 alike.  Printed, not compared: `fp32_gap`, the
    same gap against the reference in float32 (bfloat16's own rounding, which
    a random generator amplifies by its argmax masks).  In a traced run the
    float32 forward also counts the configuration's FLOPs per image."""
    import torch

    cfg, tr = spec.config, spec.traffic
    collate = resolve(REFERENCE, "data.batches:collate")
    route = resolve(REFERENCE, cfg["route"]["reference"])
    forward = resolve(REFERENCE, "tryon:tryon_forward")
    kwargs = dict(cfg["route"]["kwargs"], denorm=tr["denorm"])
    route_share, image_gap, fp32_gap = 0.0, 0.0, 0.0
    with precision.fp32_exact():
        ref = build_model(REFERENCE, cfg, device, weights)
        for i, (routed, img) in sorted(kept.items()):
            persons, garments = inputs[i]
            b = route(collate(persons), collate(garments), device=device, **kwargs)
            off = sum(int(((routed[k].float() - b[k]).abs() > ROUTE_TOL).sum()) for k in ROUTED_KEYS)
            route_share = max(route_share, off / sum(b[k].numel() for k in ROUTED_KEYS))
            served = img.to(device).float()
            fwd = (forward, ref.set_dtype(torch.float32), w_avg, b, tr["truncation_psi"], tr["noise_mode"])
            if rec.trace_run and rec.flops_per_unit is None:  # the configuration's FLOPs at the cell's shapes
                out, flops = count_flops(*fwd)
                rec.flops_per_unit = flops / b["pose"].shape[0]
            else:
                out = fwd[0](*fwd[1:])
            fp32_gap = max(fp32_gap, gap(served, to_uint8(out, cfg["cols"])))
            ref.set_dtype(getattr(torch, tr["dtype"]))
            out = forward(ref, w_avg, b, tr["truncation_psi"], tr["noise_mode"])
            image_gap = max(image_gap, gap(served, to_uint8(out, cfg["cols"])))
    if not kept:
        route_share = image_gap = float("inf")
    rec.diagnostics["fp32_gap"] = fp32_gap
    rec.checks["route_share"] = (route_share, spec.limits["route_share"])
    rec.checks["image_gap"] = (image_gap, spec.limits["image_gap"])


def gap(served, want) -> float:
    """The largest mean |difference| of one image from its reference, in uint8 levels."""
    return float((served - want.float()).abs().flatten(1).mean(1).max())
