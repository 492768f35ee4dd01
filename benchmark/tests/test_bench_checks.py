"""The checks that decide `correct`, driven through a whole run of each cell at
thin widths on the CPU (the harness's look for a card skipped): a sound run
is correct, and each fault that a serving cell can have, planted in the timed
path, and the control make it not correct."""

import pytest

from benchmark.harness.names import PROGRAM, resolve
from benchmark.run import is_correct
from benchmark.tests.tiny import run_tiny, tiny_spec

CELLS = ["serve_full256_b16", "serve_full512_b8"]


def broken(forward, fault):
    """The program's try-on forward with `fault` planted where its images are produced."""
    state = {}

    def run(*args, **kw):
        out = forward(*args, **kw)
        if fault == "stale":  # the previous batch's images handed out again
            out, state["prev"] = state.get("prev", out), out
        elif fault == "half":  # the second half of the batch left out
            out = out.clone()
            out[out.shape[0] // 2:] = 0
        elif fault == "alter":  # one answer altered where it is produced
            out = out.clone()
            out[0] = out[1]
        return out

    return run


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    rec = run_tiny(tiny_spec(workload, seconds=0.2))
    assert rec.attempted >= 1 and rec.failed == 0
    # on the CPU the port runs its kernels' plain versions: bit for bit the reference
    assert {k: v for k, (v, _) in rec.checks.items()} == {"route_share": 0.0, "image_gap": 0.0}
    assert is_correct(rec)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["stale", "half", "alter"])
def test_a_fault_in_the_timed_path_is_not_correct(workload, fault, monkeypatch):
    module = resolve(PROGRAM, "cli.test:tryon_forward").__module__
    monkeypatch.setattr(f"{module}.tryon_forward", broken(resolve(PROGRAM, "cli.test:tryon_forward"), fault))
    rec = run_tiny(tiny_spec(workload, seconds=0.2))
    value, limit = rec.checks["image_gap"]
    assert value > limit and not is_correct(rec)


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    """The program's int8 serving path for the generator and the reference's
    routing rounded to bfloat16 in place of the program's."""
    rec = run_tiny(tiny_spec(workload, seconds=0.2), control=True)
    value, limit = rec.checks["route_share"]
    assert value > limit and not is_correct(rec)
    assert rec.checks["image_gap"][0] > 0.0


def test_a_run_with_nothing_checked_is_not_correct():
    from benchmark.harness.record import Record

    assert not is_correct(Record(cell={}, config={}, traffic={}, trace_run=False))
