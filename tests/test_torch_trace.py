"""The port's tracer (``repro_torch.trace``) and the spans and counters of the
serving engine, the model and the trainer, on the CPU at a smoke size: off,
it records nothing, reads no clock and never touches the profiler; on, its
spans nest as the engine's and the trainer's calls do."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import trace
from repro_torch.configs import smoke_config
from repro_torch.models.common import init_params
from repro_torch.serve.engine import OrderedServingEngine
from repro_torch.train import OptConfig, init_opt_state, make_train_step


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def _engine(arch="olmo-1b", **kw):
    cfg = smoke_config(arch)
    return OrderedServingEngine(cfg, init_params(cfg, 2, "cpu"), device="cpu", **kw)


def _serve(eng, n=8, long_first=0, seed=1):
    """Submit ``n`` requests (the first with ``long_first`` new tokens when
    given) and run them to the end; returns the serials."""
    rng = np.random.RandomState(seed)
    serials = []
    for i in range(n):
        prompt = rng.randint(0, eng.cfg.vocab_size, size=int(rng.randint(4, 12)))
        new = long_first if i == 0 and long_first else int(rng.randint(2, 8))
        serials.append(eng.submit(prompt, max_new_tokens=new))
    eng.run_to_completion(max_steps=5000)
    return serials


def _ancestors(recs, i):
    out = []
    while recs[i].parent is not None:
        i = recs[i].parent
        out.append(recs[i].name)
    return out


class _NoClock:
    def perf_counter_ns(self):
        raise AssertionError("the tracer read the clock while off")


def _raise(*a, **k):
    raise AssertionError("record_function entered while tracing is off")


def test_off_records_nothing_reads_no_clock_and_never_enters_the_profiler(monkeypatch):
    want = _engine()
    _serve(want)
    # as if a profiler session were on: an off tracer must still not call it
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(trace, "time", _NoClock())
    eng = _engine()
    serials = _serve(eng)
    assert trace.take() == []
    assert [c.serial for c in eng.completions] == serials
    assert eng.stats == want.stats
    assert eng.stats == {"prefills": 8, "decode_steps": want.stats["decode_steps"], "emitted": 8}
    assert eng.completed == want.completed == 8
    assert trace.span("engine.step") is trace.span("model.decode")  # one shared no-op


def test_on_engine_spans_nest_as_the_calls_do():
    trace.enable()
    eng = _engine()
    serials = _serve(eng)
    recs = trace.take()
    names = {r.name for r in recs}
    assert {"engine.step", "engine.prefill", "engine.decode", "engine.upload",
            "model.prefill", "model.decode", "engine.readback", "engine.install",
            "engine.bookkeep", "engine.queued", "ring.held", "ring.parked",
            "layer.period"} <= names
    for i, r in enumerate(recs):
        assert r.t0 <= r.t1
        if r.name == "model.decode":
            assert _ancestors(recs, i)[:2] == ["engine.decode", "engine.step"]
        if r.name == "model.prefill":
            assert _ancestors(recs, i)[:2] == ["engine.prefill", "engine.step"]
        if r.name == "layer.period":
            assert _ancestors(recs, i)[0] in ("model.prefill", "model.decode")
        if r.parent is not None:  # a child lies inside its parent
            p = recs[r.parent]
            assert p.t0 <= r.t0 and r.t1 <= p.t1
    queued = [r for r in recs if r.name == "engine.queued"]
    assert sorted(r.id for r in queued) == serials
    for q in queued:
        first = min((r for r in recs if r.name == "engine.prefill" and r.id == q.id),
                    key=lambda r: r.t0)
        assert q.t1 <= first.t1 and q.t0 <= q.t1
    assert sum(r.name == "engine.step" for r in recs) == \
        eng.stats["prefills"] + eng.stats["decode_steps"] + 1  # the last, idle, call
    held = [r for r in recs if r.name == "ring.held"]
    parked = [r for r in recs if r.name == "ring.parked"]
    assert [r.id for r in held] and len(held) == eng.completed == 8
    assert [r.id for r in parked] == [r.id for r in held]
    assert all(_ancestors(recs, recs.index(r))[0] == "engine.bookkeep" for r in held + parked)
    assert eng.completed - eng.stats["emitted"] == 0
    assert not any(r.profiled for r in recs)


def _parks_forced(order, size):
    """Sends that find their serial past the ring's window, given the order
    the completions reach the ring: the window starts after the longest
    run of serials from 1 completed before."""
    done, nxt, parks = set(), 1, 0
    for t in order:
        parks += t >= nxt + size
        done.add(t)
        while nxt in done:
            nxt += 1
    return parks


def test_parked_counts_the_sends_a_ring_of_two_cannot_take():
    eng = _engine(max_slots=4, max_len=64, reorder_size=2)
    order = []
    send = eng._reorder.send
    eng._reorder.send = lambda t, out: (order.append(t), send(t, out))
    trace.enable()
    serials = _serve(eng, n=16, long_first=30)
    recs = trace.take()
    assert [c.serial for c in eng.completions] == serials
    forced = _parks_forced(order, 2)
    assert forced > 0  # the slow first request holds the window back
    parked = [0] + [r.value for r in recs if r.name == "ring.parked"]
    assert sum(b > a for a, b in zip(parked, parked[1:])) == forced
    assert all(b - a <= 1 for a, b in zip(parked, parked[1:])) and parked[-1] == 0
    assert eng.completed == eng.stats["emitted"] == 16
    held = [r.value for r in recs if r.name == "ring.held"]
    assert max(held) >= 3 and held[-1] == 0


def test_each_period_of_a_moe_model_is_one_span_in_its_step():
    eng = _engine("qwen2-moe-a2.7b")
    trace.enable()
    _serve(eng, n=2)
    recs = trace.take()
    steps = [i for i, r in enumerate(recs) if r.name in ("model.prefill", "model.decode")]
    periods = [r.parent for r in recs if r.name == "layer.period"]
    assert steps and all(periods.count(i) == eng.cfg.num_periods for i in steps)
    assert set(periods) == set(steps)


def test_spans_under_the_profiler_are_on_its_timeline():
    eng = _engine()
    trace.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _serve(eng, n=2)
    recs = trace.take()
    assert recs and all(r.profiled for r in recs if r.name != "engine.queued")
    shown = {ev.name for ev in prof.events() if ev.name.startswith(trace.PREFIX)}
    assert {"repro_torch.engine.step", "repro_torch.engine.readback",
            "repro_torch.model.decode", "repro_torch.layer.period"} <= shown


@pytest.mark.parametrize("remat", ["none", "full"])
def test_one_train_step_records_forward_backward_and_adamw_under_its_step(remat):
    cfg = dataclasses.replace(smoke_config("olmo-1b"), remat=remat)
    params = init_params(cfg, 0, "cpu")
    ocfg = OptConfig()
    step = make_train_step(cfg, ocfg)
    state = init_opt_state(ocfg, params)
    rng = np.random.RandomState(0)
    batch = {k: rng.randint(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    trace.enable()
    step(params, state, batch)
    recs = trace.take()
    top = [r for r in recs if r.parent is None]
    assert [r.name for r in top] == ["train.step"]
    kids = [r.name for r in recs if r.parent == recs.index(top[0])]
    assert kids == ["train.forward", "train.backward", "train.adamw"]
    layers = {}
    for i, r in enumerate(recs):
        if r.name == "layer.period":
            phase = [a for a in _ancestors(recs, i) if a.startswith("train.")][0]
            layers[phase] = layers.get(phase, 0) + 1
    # the backward recomputes each checkpointed period inside its own span
    want = {"train.forward": cfg.num_periods}
    if remat == "full":
        want["train.backward"] = cfg.num_periods
    assert layers == want


def test_the_serving_profile_counts_no_span_as_device_work():
    from repro_torch.launch import profile_serve

    class Ev:
        def __init__(self, name, us, device=True):
            self.name, self.device_time = name, us
            self.device_type = (torch.autograd.DeviceType.CUDA if device
                                else torch.autograd.DeviceType.CPU)

    class Prof:
        def events(self):
            return [Ev("sm90_xmma_gemm_bf16bf16_bf16f32", 30.0), Ev("fill_kernel", 10.0),
                    Ev(trace.PREFIX + "engine.decode", 55.0), Ev(trace.PREFIX + "layer.period", 20.0),
                    Ev("cudaLaunchKernel", 5.0, device=False)]

    groups, runs, kernels = profile_serve._device_split(Prof())
    assert groups == {"matrix products": pytest.approx(30e-6), "other": pytest.approx(10e-6)}
    assert runs == {"matrix products": 1, "other": 1}
    assert set(kernels) == {"sm90_xmma_gemm_bf16bf16_bf16f32", "fill_kernel"}
