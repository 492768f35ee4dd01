"""The harness's arithmetic, its discovery of files by name, and its refusal
to measure without a card, on the CPU."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import env, metric_math
from benchmark.harness.record import Record
from benchmark.harness.trace import SEGMENT, Trace, read_profile
from benchmark.run import load_json, load_spec, metrics_of, read_metrics


def record(**kw):
    return Record(cell={}, config={}, traffic={"kind": "serve"}, trace_run=False, **kw)


def test_window_rate_counts_every_completed_request_over_the_window():
    rec = record(requests=[(0.0, 0.1), (0.1, 0.25), (0.25, 0.3), (0.3, 0.5)], units_per_request=16, window_s=0.5)
    assert metric_math.units_per_s(rec) == pytest.approx(4 * 16 / 0.5)
    rec.failed = 1
    assert metric_math.units_per_s(rec) == pytest.approx(3 * 16 / 0.5)


def test_p95_over_all_batches():
    values = list(range(1, 101))  # 1 .. 100 ms
    assert metric_math.percentile(values, 95) == pytest.approx(95.05)
    assert metric_math.percentile([5.0], 95) == 5.0
    rec = record(requests=[(0.0, v / 1e3) for v in values])
    from benchmark.run import reader

    assert reader("tryon_batch_ms_p95")(rec) == pytest.approx(95.05)


def test_roofline_counts_of_the_main_fir_shapes():
    up2 = metric_math.roofline_cost("up2")
    # up2 extend 1 on [16, 128, 128, 128] bf16: 2048 planes, 128x128 in, 258x258 out
    ops, nbytes = up2.cost((0, 0, 1, 2048, 128, 128, 1, 1.0, "cuda"))
    assert nbytes == 2 * (2048 * 128 * 128 + 2048 * 258 * 258) == 339_755_008
    assert ops == 10 * 2048 * 258 * 258
    down2 = metric_math.roofline_cost("down2")
    # down2 pad 1 on [32, 64, 256, 256] bf16: 2048 planes, 128x128 out
    ops, nbytes = down2.cost((0, 0, 1, 2048, 256, 256, 1, 1.0, "cuda"))
    assert nbytes == 2 * (2048 * 256 * 256 + 2048 * 128 * 128) == 335_544_320
    assert ops == 36 * 2048 * 128 * 128
    norm = metric_math.roofline_cost("norm_warp")
    ops, nbytes = norm.cost((0, 0, 0, 0, 0, 16, 14, 10, 256, 256, 64, 64, 4, "cuda"))
    assert nbytes == 4 * (16 * 14 * 4 * 64 * 64 + 16 * 14 * 10)
    comp = metric_math.roofline_cost("composite")
    _, nbytes = comp.cost((0, 0, 0, 0, 0, 16, 14, 64, 64, 256, 256, 2, 0, 0, 0, 4, 0.5, "cuda"))
    assert nbytes == 4 * (16 * (3 * 2 + 4) * 256 * 256 + 16 * 14 * 10)
    assert metric_math.roofline_cost("no_such_kernel") is None


def test_kernel_roofline_is_least_time_over_device_time():
    from benchmark.roofline import PEAK_BYTES

    args = (0, 0, 1, 2048, 128, 128, 1, 1.0, "cuda")
    least = 339_755_008 / PEAK_BYTES
    trace = Trace(window_s=1.0, busy_s=0.5,
                  device_ops={"void up2_kernel<__nv_bfloat16, 1>(...)": 4 * least, "sm90_xmma_fprop": 1.0})
    rec = record(trace=trace, launches=[("up2", args), ("up2", args)])
    assert metric_math.kernel_roofline(rec) == pytest.approx(50.0)


def test_trace_reading_merges_kernels_and_names_gaps_by_host_span():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, a, b, dev):
        return SimpleNamespace(name=name, device_type=dev, time_range=SimpleNamespace(start=a * 1e6, end=b * 1e6))

    events = [ev(SEGMENT, 0.0, 10.0, cpu), ev("bench.routing", 0.0, 4.0, cpu), ev("bench.forward", 4.0, 10.0, cpu),
              ev("k1", 1.0, 3.0, cuda), ev("k2", 2.0, 3.5, cuda), ev("k1", 5.0, 9.0, cuda),
              ev("bench.forward", 4.0, 10.0, cuda)]
    t = read_profile(SimpleNamespace(events=lambda: events))
    assert t.window_s == 10.0 and t.busy_s == pytest.approx(2.5 + 4.0)
    assert t.device_ops == pytest.approx({"k1": 6.0, "k2": 1.5})
    assert t.gaps == pytest.approx({"routing": 1.0 + 1.5, "forward": 1.0})  # each gap by the span at its start
    b = t.breakdown()
    assert b["device_ops"][0] == ["k1", 6.0] and len(b["idle_gaps"]) == 2


def test_mfu_and_idle_share():
    rec = record(requests=[(0, 1)] * 10, units_per_request=16, window_s=2.0, flops_per_unit=1e11,
                 trace=Trace(window_s=2.0, busy_s=1.5))
    assert metric_math.mfu(rec) == pytest.approx(100 * 1e11 * 80 / 989e12)
    assert metric_math.idle_share(rec) == pytest.approx(25.0)


def copy_benchmark(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(env.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(env.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    return root


def test_a_new_configuration_traffic_and_metric_are_found_as_new_files(tmp_path):
    root = copy_benchmark(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark/configs/full256.json").read_text())
    cfg["name"] = "full256_thin"
    cfg["model"]["kwargs"]["channel_base"] = 512
    (root / "benchmark/configs/full256_thin.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "benchmark/traffic/tryon_b16.json").read_text())
    traffic["batch"] = 1
    (root / "benchmark/traffic/tryon_b1.json").write_text(json.dumps(traffic))
    (root / "benchmark/checks/serve_thin_b1.json").write_text(json.dumps({"route_share": 1.0, "image_gap": 1.0}))
    (root / "benchmark/metrics/requests_done.serve.py").write_text(
        "def read(record):\n    return float(len(record.requests))\n")
    bench["configs"].append({"name": "full256_thin", "source": "https://example.org", "reduced": ["channel_base"],
                             "file": "benchmark/configs/full256_thin.json", "why": "a test"})
    bench["workloads"].append({"name": "serve_thin_b1", "config": "full256_thin", "traffic": "tryon_b1",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "requests_done.serve", "unit": "n", "better": "higher",
                               "source": "host_clock", "layer": "routing", "moves": "setup_s",
                               "workloads": ["serve_thin_b1"]})
    spec = load_spec(bench, "serve_thin_b1", 3, 1.0, True, root=str(root))
    assert spec.config["model"]["kwargs"]["channel_base"] == 512 and spec.traffic["batch"] == 1
    assert spec.limits == {"route_share": 1.0, "image_gap": 1.0}
    names = [m["name"] for m in metrics_of(bench, "serve_thin_b1", True)]
    assert names == ["requests_done.serve"]
    rec = record(requests=[(0, 1)] * 3)
    assert read_metrics(metrics_of(bench, "serve_thin_b1", True), rec, root=str(root)) == {
        "requests_done.serve": {"value": 3.0, "unit": "n"}}
    # the existing cells see only their own metrics
    assert "requests_done.serve" not in [m["name"] for m in metrics_of(bench, "serve_full256_b16", True)]


def test_every_cell_names_files_that_exist():
    bench = load_json(env.ROOT, "BENCHMARK.json")
    for w in bench["workloads"]:
        spec = load_spec(bench, w["name"], 1, 1.0, False)
        assert spec.traffic["kind"] and set(spec.limits)
        for m in metrics_of(bench, w["name"], False) + metrics_of(bench, w["name"], True):
            assert os.path.exists(os.path.join(env.BENCH_DIR, "metrics", m["name"] + ".py")), m["name"]


def run_cli(cwd, env_extra):
    e = dict(os.environ, **env_extra)
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "serve_full256_b16", "--seed", "1",
                           "--seconds", "1"], cwd=cwd, env=e, capture_output=True, text=True, timeout=300)


def test_the_harness_refuses_to_measure_without_a_card():
    p = run_cli(env.ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_the_harness_fails_without_the_program(tmp_path):
    root = copy_benchmark(tmp_path)
    p = run_cli(root, {"CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_flops_are_counted_two_per_multiply_add():
    from benchmark.harness.flops import count_flops

    x, w = torch.ones(2, 3, 8, 8), torch.ones(4, 3, 3, 3)
    out, flops = count_flops(torch.nn.functional.conv2d, x, w, None, 1, 1)
    assert out.shape == (2, 4, 8, 8) and flops == 2 * 2 * 4 * 8 * 8 * 3 * 3 * 3
