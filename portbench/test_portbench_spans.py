"""The stretch read with the program's spans (``spans.reduce``) on
hand-made profiler events, the readers of the program's spans on a hand-made
``ctx``, and a traced run at a test's size on the CPU with the program's
tracer on (``spans_run``)."""
import importlib.util
import json
from collections import namedtuple

import pytest

torch = pytest.importorskip("torch")

from portbench import bench, serving, spans, spans_run, tiny, trace  # noqa: E402
from repro_torch.trace import Record  # noqa: E402

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
Range = namedtuple("Range", "start end")
NEW = [m["name"] for m in spans_run.METRICS]


class Ev:
    def __init__(self, name, start, end, device=False, id=0):
        self.name, self.time_range, self.id = name, Range(start, end), id
        self.device_type = CUDA if device else CPU


def _program(name, start, end, dstart=None, dend=None):
    """A program span on the host and, where it launched work, its range on
    the device's timeline."""
    evs = [Ev("repro_torch." + name, start, end)]
    if dstart is not None:
        evs.append(Ev("repro_torch." + name, dstart, dend, device=True))
    return evs


def _launch(t, cid, start, end, name="k"):
    return [Ev("cudaLaunchKernel", t, t + 1, id=cid), Ev(name, start, end, device=True, id=cid)]


def _decode_step():
    """A stretch of 0-100 us: the harness's decode span around the program's
    engine.decode, which launches two kernels in model.decode and one copy
    in engine.readback; the kernels run late, after model.decode ended."""
    return ([Ev("portbench:stretch", 0, 100), Ev("portbench:decode", 2, 98)]
            + _program("engine.decode", 4, 96, 20, 70)
            + _program("model.decode", 6, 16, 20, 50)
            + _program("engine.readback", 16, 90, 60, 70)
            + _launch(8, 101, 20, 30, "gemm") + _launch(12, 102, 40, 50, "gemm")
            + _launch(18, 103, 60, 70, "Memcpy DtoH")
            + [Ev("cudaStreamSynchronize", 20, 89, id=104)])


def test_program_ranges_are_no_device_work():
    evs = _decode_step()
    bare = [e for e in evs if not e.name.startswith("repro_torch.")]
    got, want = spans.reduce(evs), trace.reduce(bare)
    for key in ("busy_s", "window_s", "kernels", "calls"):
        assert got[key] == want[key], key
    assert got["busy_s"] == pytest.approx(30e-6)
    assert got["calls"] == {"gemm": 2, "Memcpy DtoH": 1}
    # the harness's own reduction counts them as device work and as kernels
    assert trace.reduce(evs)["busy_s"] == pytest.approx(50e-6)
    assert "repro_torch.engine.decode" in trace.reduce(evs)["kernels"]


def test_a_gap_is_named_by_the_innermost_spans_that_cover_it():
    g = spans.reduce(_decode_step())["idle_gaps"]
    # the gaps 0-20, 30-40, 50-60 and 70-100, all in the harness's decode:
    # model.decode covers the first's midpoint; engine.readback the others',
    # though model.decode ended and engine.decode covers them too
    assert g == {"decode/model.decode": pytest.approx(20e-6),
                 "decode/engine.readback": pytest.approx(50e-6)}


def test_a_gap_under_a_parent_whose_child_ended_is_the_parents():
    evs = ([Ev("portbench:stretch", 0, 100), Ev("portbench:step", 0, 100)]
           + _program("train.step", 1, 99) + _program("train.forward", 2, 10)
           + _launch(3, 1, 5, 20) + [Ev("portbench:egress", 99.5, 100)])
    g = spans.reduce(evs)["idle_gaps"]
    assert g == {"step/train.step": pytest.approx(80e-6), "step/train.forward": pytest.approx(5e-6)}
    # a gap under no span of either kind, and under the harness's alone
    evs = [Ev("portbench:stretch", 0, 100), Ev("portbench:source", 40, 100)] + _launch(1, 1, 10, 40)
    assert spans.reduce(evs)["idle_gaps"] == {"untracked": pytest.approx(10e-6),
                                              "source": pytest.approx(60e-6)}


def test_kernels_go_to_the_spans_of_their_launch():
    s = spans.reduce(_decode_step())
    prog, inner = s["program"], s["innermost"]
    assert prog["engine.decode"] == {"spans": 1, "launches": 3, "device_s": pytest.approx(30e-6)}
    assert prog["model.decode"] == {"spans": 1, "launches": 2, "device_s": pytest.approx(20e-6)}
    assert prog["engine.readback"] == {"spans": 1, "launches": 1,
                                       "device_s": pytest.approx(10e-6)}
    assert inner == {"model.decode": {"launches": 2, "device_s": pytest.approx(20e-6)},
                     "engine.readback": {"launches": 1, "device_s": pytest.approx(10e-6)}}
    assert "stretch spans model.decode: 2 launches" in spans.line(s)


def test_a_launch_from_another_thread_goes_to_the_span_open_then():
    """A backward launches from the autograd engine's thread, inside the
    caller's train.backward; a launch outside the stretch counts nowhere."""
    evs = ([Ev("portbench:stretch", 10, 100)] + _program("train.step", 10, 100)
           + _program("train.backward", 20, 80) + _program("layer.period", 30, 40)
           + _launch(35, 7, 50, 60) + _launch(60, 8, 61, 70) + _launch(5, 9, 11, 12))
    s = spans.reduce(evs)
    assert s["program"]["train.backward"]["launches"] == 2
    assert s["program"]["layer.period"]["device_s"] == pytest.approx(10e-6)
    assert s["program"]["train.step"] == {"spans": 1, "launches": 2,
                                          "device_s": pytest.approx(19e-6)}


def _read(name, ctx):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", bench.HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def _ctx():
    """Two engine steps outside the stretch and one inside; two requests
    queued outside, one inside; a training stretch of two steps."""
    ms = 1_000_000
    recs = [
        Record("engine.step", None, None, 0, 10 * ms),
        Record("engine.queued", 1, None, -5 * ms, 1 * ms),
        Record("engine.prefill", 1, 0, 1 * ms, 9 * ms),
        Record("model.prefill", None, 2, 2 * ms, 5 * ms),
        Record("engine.readback", None, 2, 5 * ms, 6 * ms),
        Record("engine.step", None, None, 10 * ms, 16 * ms),
        Record("engine.decode", None, 5, 10 * ms, 16 * ms),
        Record("model.decode", None, 6, 11 * ms, 12 * ms),
        Record("ring.held", 1, 6, 15 * ms, 15 * ms, value=3),
        Record("engine.queued", 2, None, -2 * ms, 16 * ms),
        Record("engine.prefill", 2, None, 16 * ms, 20 * ms),  # an idle step's
        Record("ring.held", 2, None, 21 * ms, 21 * ms, value=1),
        Record("engine.step", None, None, 30 * ms, 50 * ms, profiled=True),
        Record("engine.queued", 3, None, 0, 40 * ms, profiled=True),
        Record("engine.prefill", 3, 12, 30 * ms, 50 * ms, profiled=True),
        Record("ring.held", 3, None, 51 * ms, 51 * ms, value=9, profiled=True),
        Record("ring.parked", 1, 6, 15 * ms, 15 * ms, value=0),
        Record("ring.parked", 2, None, 21 * ms, 21 * ms, value=1),
        Record("ring.parked", 4, None, 22 * ms, 22 * ms, value=1),
        Record("ring.parked", 5, None, 23 * ms, 23 * ms, value=0),
        Record("ring.parked", 3, None, 51 * ms, 51 * ms, value=4, profiled=True),
    ]
    table = {"engine.decode": {"spans": 2, "launches": 300, "device_s": 0.004},
             "engine.prefill": {"spans": 1, "launches": 500, "device_s": 0.006},
             "train.step": {"spans": 2, "launches": 9000, "device_s": 0.76},
             "train.forward": {"spans": 2, "launches": 2000, "device_s": 0.16},
             "train.backward": {"spans": 2, "launches": 5000, "device_s": 0.40},
             "train.adamw": {"spans": 2, "launches": 2000, "device_s": 0.19}}
    return {"spans": recs, "steps": [], "egress": [], "window_s": 1.0,
            "trace": {"busy_s": 0.8, "window_s": 1.0, "program": table}}


def test_each_reader_reads_the_hand_computed_value():
    ctx = _ctx()
    # waits 6 and 18 ms: numpy's p90 between them, 6 + 0.9 x 12
    assert _read("queue_wait_p90_ms", ctx) == pytest.approx(16.8)
    assert _read("ring_held_p90", ctx) == pytest.approx(1 + 0.9 * 2)
    # parked 0, 1, 1, 0 after four sends: one of three rose
    assert _read("ring_parked_pct", ctx) == pytest.approx(100 / 3)
    # 10 - 3 - 1 and 6 - 1 ms
    assert _read("engine_self_ms", ctx) == pytest.approx((6 + 5) / 2)
    assert _read("decode_launches", ctx) == 150
    assert _read("prefill_launches", ctx) == 500
    assert _read("forward_ms", ctx) == pytest.approx(80)
    assert _read("backward_ms", ctx) == pytest.approx(200)
    assert _read("adamw_ms", ctx) == pytest.approx(95)


@pytest.mark.parametrize("name", NEW)
def test_each_reader_reads_nothing_without_the_programs_spans(name):
    # the context the harness builds today, with and without a stretch
    assert _read(name, {"steps": [], "egress": [], "window_s": 1.0, "trace": None}) is None
    ctx = dict(_ctx(), spans=[])
    ctx["trace"] = {"busy_s": 0.8, "window_s": 1.0, "kernels": {}, "idle_gaps": {}}
    assert _read(name, ctx) is None
    ctx = _ctx()  # a stretch without device work
    ctx["trace"]["busy_s"] = 0.0
    if name.endswith(("_launches", "forward_ms", "backward_ms", "adamw_ms")):
        assert _read(name, ctx) is None


def test_the_metrics_are_well_formed_for_the_benchmark():
    spec = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
    old = {m["name"] for m in spec["per_layer"]}
    ends = {m["name"]: m.get("workloads") for m in spec["end_to_end"]}
    cells = {c["name"] for c in spec["workloads"]}
    layers = {m["layer"] for m in spec["per_layer"]}
    assert len(set(NEW)) == len(NEW) and not old & set(NEW)
    for m in spans_run.METRICS:
        assert (bench.HERE / "metrics" / f"{m['name']}.py").is_file()
        assert set(m["workloads"]) <= set(ends[m["moves"]] or cells)
        assert m["layer"] in layers or m["layer"].startswith("trainer: ")


def _traced(monkeypatch, workload, on):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    if on:
        spans_run.install(patch=monkeypatch.setattr)
    small = tiny.run(workload, seed=21)  # its spec lists the new metrics where installed
    small.trace = True
    small.mix = dict(small.mix, stretch_at=0.3, stretch_s=0.2)
    return serving.run_cell(small)


@pytest.mark.parametrize("workload", tiny.SERVE)
def test_a_traced_run_with_the_tracer_on_reports_the_engines_metrics(monkeypatch, workload):
    result, checks = _traced(monkeypatch, workload, True)
    assert result["correct"], checks
    m = result["metrics"]
    for name in ("queue_wait_p90_ms", "ring_held_p90", "engine_self_ms"):
        assert m[name]["value"] > 0, name
    assert m["ring_parked_pct"]["value"] >= 0
    # no card: no launch and no device time to put down to a span
    assert "decode_launches" not in m and "prefill_launches" not in m
    gaps = result["breakdown"]["idle_gaps"]
    assert all("." in name for name, _ in gaps), gaps  # each under a program span
    assert "device_idle_share.serve" in m


def test_with_the_tracer_off_the_run_is_the_harnesss(monkeypatch):
    result, _ = _traced(monkeypatch, tiny.SERVE[0], False)
    assert result["correct"] and not set(NEW) & set(result["metrics"])
    assert all("." not in name for name, _ in result["breakdown"]["idle_gaps"])
