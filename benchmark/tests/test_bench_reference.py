"""The frozen reference against the port on the CPU, at thin widths, with the
same weights (the benchmark's seeded draw) and the same host samples: the
routing of both serving paths and the two generators' try-on forwards.  On
the CPU the port runs the plain versions of its kernels, so the two agree
bit for bit."""

import pytest
import torch

from benchmark.harness.names import PROGRAM, REFERENCE, resolve
from benchmark.harness.pool import draw_pairs, host_pool
from benchmark.harness.weights import draw_weights, load_weights, template_of
from benchmark.tests.tiny import tiny_spec

CELLS = ["serve_full256_b16", "serve_full512_b8"]
ROUTED = ("style_input", "retain", "pose", "denorm_upper_img", "denorm_lower_img", "denorm_upper_mask",
          "denorm_lower_mask", "person_img")


def batch_of(spec, seed=11, batch=2):
    pool = host_pool(seed, 4, spec.config["frame"], workers=1)
    persons, garments = draw_pairs(seed, 4, batch, 1)
    collate = resolve(PROGRAM, "data.dataset:collate")
    return collate([pool[i] for i in persons[0]]), collate([pool[i] for i in garments[0]])


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("denorm", ["fused", "separate"])
def test_routing_matches_the_port(workload, denorm):
    spec = tiny_spec(workload)
    person, garment = batch_of(spec)
    r = spec.config["route"]
    cpu = torch.device("cpu")
    got = resolve(PROGRAM, r["program"])(person, garment, device=cpu, denorm=denorm, **r["kwargs"])
    ref = resolve(REFERENCE, r["reference"])(person, garment, device=cpu, denorm=denorm, **r["kwargs"])
    for k in ROUTED:
        assert torch.equal(got[k], ref[k]), k
    assert float(ref["denorm_upper_mask"].sum()) > 0  # the garments' patches reach the frame


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_matches_the_port(workload, dtype):
    spec = tiny_spec(workload)
    cfg = spec.config
    cls_p, cls_r = resolve(PROGRAM, cfg["model"]["class"]), resolve(REFERENCE, cfg["model"]["class"])
    kw = cfg["model"]["kwargs"]
    weights = draw_weights(template_of(lambda: cls_r(**kw)), 5, torch.device("cpu"))
    prog, ref = cls_p(**kw), cls_r(**kw)
    load_weights(prog, weights)
    load_weights(ref, weights)
    prog.set_dtype(dtype).eval()
    ref.set_dtype(dtype).eval()
    person, garment = batch_of(spec)
    r = cfg["route"]
    batch = resolve(REFERENCE, r["reference"])(person, garment, device=torch.device("cpu"), **r["kwargs"])
    w_avg = torch.randn(kw["w_dim"], generator=torch.Generator().manual_seed(3))
    got = resolve(PROGRAM, "cli.test:tryon_forward")(prog, w_avg, batch, 1.0, "none")
    want = resolve(REFERENCE, "tryon:tryon_forward")(ref, w_avg, batch, 1.0, "none")
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_weights_are_drawn_alike_for_both_sides_and_differ_by_seed():
    spec = tiny_spec("serve_full256_b16")
    kw = spec.config["model"]["kwargs"]
    cls_r = resolve(REFERENCE, spec.config["model"]["class"])
    t = template_of(lambda: cls_r(**kw))
    a, b, c = (draw_weights(t, s, torch.device("cpu")) for s in (5, 5, 6))
    assert set(a) == {n for n, _ in resolve(PROGRAM, spec.config["model"]["class"])(**kw).named_parameters()}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["mapping.fc0.weight"], c["mapping.fc0.weight"])
    # a parameter that the model sets to a constant gets that constant plus N(0, 0.1)
    bias = [k for k in a if k.endswith("affine.bias")][0]  # bias_init 1
    assert abs(float(a[bias].mean()) - 1.0) < 0.1 and 0.05 < float(a[bias].std()) < 0.2
