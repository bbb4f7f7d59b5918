"""The traffic generator and the serving source with backpressure."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench import serving, tiny, traffic  # noqa: E402
from portbench.bench import data  # noqa: E402
from portbench.trace import Spans  # noqa: E402


def _mix():
    return data("traffic", "stream-code")


def test_same_seed_same_requests():
    a = traffic.RequestSource(_mix(), 2**31 + 11, 50304, 2048)
    b = traffic.RequestSource(_mix(), 2**31 + 11, 50304, 2048)
    for _ in range(150):
        ra, rb = a.next(), b.next()
        assert ra.max_new_tokens == rb.max_new_tokens
        assert np.array_equal(ra.prompt, rb.prompt)


def test_every_seed_asks_the_same_lengths_and_blocks_hold_one_set():
    mix = _mix()
    n = mix["block"]
    seen = []
    for seed in (1, 2, 2**31 + 3):
        src = traffic.RequestSource(mix, seed, 50304, 8192)
        reqs = [src.next() for _ in range(2 * n)]
        seen.append(([(r.prompt.size, r.max_new_tokens) for r in reqs], reqs[0].prompt))
    lengths = seen[0][0]
    assert all(s[0] == lengths for s in seen)  # the same work in the same order
    assert sorted(lengths[:n]) == sorted(lengths[n:])  # each block the same set
    assert lengths[:n] != lengths[n:]  # in an order of its own
    assert not np.array_equal(seen[0][1], seen[1][1])  # the seed draws the tokens


def test_lengths_follow_the_mix():
    mix = _mix()
    pairs = traffic.block_lengths(mix, 8192)
    assert pairs[:, 0].min() >= 64 and pairs[:, 0].max() == 7936
    assert pairs[:, 1].min() >= 2 and pairs[:, 1].max() == 64
    assert np.median(pairs[:, 0]) == pytest.approx(1500, rel=0.01)
    assert np.median(pairs[:, 1]) == pytest.approx(13, rel=0.05)


def test_prompts_are_cut_to_the_context_less_the_output():
    mix = _mix()
    full, cut = traffic.block_lengths(mix, 8192), traffic.block_lengths(mix, 2048)
    assert np.array_equal(full[:, 1], cut[:, 1])  # the outputs as asked
    assert (cut.sum(axis=1) <= 2048).all()
    assert np.array_equal(cut[:, 0], np.minimum(full[:, 0], 2048 - full[:, 1]))
    assert (cut[:, 0] < full[:, 0]).any() and (cut[:, 0] == full[:, 0]).any()


def test_train_batches_are_seeded_and_rows_differ():
    mix = data("traffic", "train")
    a = traffic.train_batch(mix, 50304, 2**31 + 5, 3)
    b = traffic.train_batch(mix, 50304, 2**31 + 5, 3)
    assert np.array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == (8, 1024)
    assert len({r.tobytes() for r in a["tokens"]}) == 8
    assert np.array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])


def _drive(seed):
    run = tiny.run("olmo-1b.stream-code", seed=seed)
    params, engine, spans = serving.setup(run)
    pending = []
    step = engine.step

    def watched():
        pending.append(len(engine.pending))
        return step()

    engine.step = watched
    w = serving.window(run, engine, spans)
    kinds = [s["kind"] for s in w["steps"]]
    egressed = [(e["serial"], tuple(e["tokens"])) for e in w["egress"]]
    return run, pending, kinds, egressed


def test_source_keeps_depth_pending_and_one_seed_repeats_its_run():
    run, pending, kinds, egressed = _drive(9)
    assert pending and all(n == run.params["depth"] for n in pending)
    _, _, kinds2, egressed2 = _drive(9)
    n = min(len(kinds), len(kinds2))
    m = min(len(egressed), len(egressed2))
    assert n > 20 and m > 5
    assert kinds[:n] == kinds2[:n]
    assert egressed[:m] == egressed2[:m]


def test_window_arithmetic_on_synthetic_timestamps():
    w = {"window_s": 2.0,
         "steps": [{"tokens": 100}, {"tokens": 4}, {"tokens": 4}],
         "egress": [{"latency_s": t / 1000} for t in range(1, 101)]}
    r = serving.rates(w)
    assert r["serve_tokens_per_s"] == pytest.approx(54.0)
    assert r["egress_p90_ms"] == pytest.approx(90.1)


def test_hold_is_egress_less_completion():
    import importlib.util
    from pathlib import Path

    path = Path(serving.__file__).parent / "metrics" / "egress_hold_p90_ms.py"
    spec = importlib.util.spec_from_file_location("hold", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    spans = Spans(False)
    assert spans.records == []
    egress = [{"hold_s": h / 1000, "traced": False} for h in range(11)]
    egress.append({"hold_s": 99.0, "traced": True})  # in the profiled stretch: left out
    assert mod.read({"egress": egress}) == pytest.approx(9.0)
