"""Port parity: the ordered serving engine against the JAX engine on the CPU
(smoke olmo-1b in f32, parameters shared through numpy), plus the JAX
engine's own regression tests (tests/test_substrate.py) run on the port.
The JAX engine and parameters come from a spawned child (``torch_jaxref``),
never from this process."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_jaxref import Reference
from repro_torch.configs import smoke_config
from repro_torch.models import transformer
from repro_torch.models.common import init_params
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.engine import OrderedServingEngine

JAX = Reference()
_jax_child = JAX.fixture()

@functools.lru_cache(maxsize=None)
def _shared_f32(seed: int):
    """(port cfg, port params): smoke olmo-1b in f32 with the JAX package's
    parameters at PRNGKey(seed)."""
    cfg = dataclasses.replace(
        smoke_config("olmo-1b"), dtype=torch.float32, param_dtype=torch.float32
    )
    return cfg, params_from_numpy(JAX("model_params", "float32", seed), "cpu")


def _requests(n, vocab, seed=0):
    rng = np.random.RandomState(seed)
    return [
        (rng.randint(0, vocab, size=rng.randint(4, 12)), int(rng.randint(2, 10)))
        for _ in range(n)
    ]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("schedule", ["interleave", "prefill_first"])
def test_engine_matches_jax_engine(schedule):
    cfg, params = _shared_f32(0)
    reqs = _requests(8, cfg.vocab_size)
    want, want_stats = JAX("engine_run", 0, reqs, schedule, 3, 48)
    eng = OrderedServingEngine(cfg, params, max_slots=3, max_len=48, schedule=schedule,
                               device="cpu")
    for prompt, n in reqs:
        eng.submit(prompt, max_new_tokens=n)
    got = eng.run_to_completion()
    assert [c.serial for c in got] == [serial for serial, _ in want]
    for g, (_, tokens) in zip(got, want):
        np.testing.assert_array_equal(g.tokens, tokens)
    assert eng.stats == want_stats


def test_engine_preserves_arrival_order():
    cfg = smoke_config("olmo-1b")
    params = init_params(cfg, 0, "cpu")
    eng = OrderedServingEngine(cfg, params, max_slots=3, max_len=48, device="cpu")
    serials = [eng.submit(p, max_new_tokens=n) for p, n in _requests(8, cfg.vocab_size)]
    comps = eng.run_to_completion()
    assert [c.serial for c in comps] == sorted(serials)
    assert eng.stats["prefills"] == 8


def _generate_ref(cfg, params, prompt, n_new):
    out = transformer.generate(cfg, params, torch.from_numpy(prompt)[None, :].long(), n_new - 1)
    return out[0].numpy()


def test_engine_matches_generate_reference():
    cfg, params = _shared_f32(1)
    prompt = np.asarray([5, 9, 2, 77, 31], np.int32)
    eng = OrderedServingEngine(cfg, params, max_slots=2, max_len=32, device="cpu")
    eng.submit(prompt, max_new_tokens=6)
    comps = eng.run_to_completion()
    np.testing.assert_array_equal(comps[0].tokens, _generate_ref(cfg, params, prompt, 6))


def test_decode_position_buffer_never_aliased():
    """The engine mutates its host ``position`` buffer in place after each
    decode; what it hands the decode must be a copy that keeps its call-time
    value for the whole run (``torch.from_numpy`` would alias the buffer)."""
    cfg, params = _shared_f32(1)
    prompt = np.asarray([5, 9, 2, 77, 31], np.int32)
    ref = _generate_ref(cfg, params, prompt, 6)
    eng = OrderedServingEngine(cfg, params, max_slots=2, max_len=32, device="cpu")
    captured = []  # (call-time copy, live reference handed to decode)
    inner = eng._decode

    def spy(p, toks, cache, position):
        captured.append((position.numpy().copy(), position))
        return inner(p, toks, cache, position)

    eng._decode = spy
    eng.submit(prompt, max_new_tokens=6)
    comps = eng.run_to_completion()
    np.testing.assert_array_equal(comps[0].tokens, ref)
    assert captured, "decode was never invoked"
    for at_call, held in captured:
        np.testing.assert_array_equal(held.numpy(), at_call)
        assert not np.shares_memory(held.numpy(), eng.position)


def test_small_reorder_ring_no_livelock():
    """A slow head-of-line request and a reorder ring smaller than the number
    of later completions: overflow completions park host-side and the engine
    terminates in bounded steps with ordered egress."""
    cfg = smoke_config("olmo-1b")
    params = init_params(cfg, 2, "cpu")
    eng = OrderedServingEngine(cfg, params, max_slots=4, max_len=64, reorder_size=4,
                               device="cpu")
    prompt = np.random.RandomState(1).randint(0, cfg.vocab_size, size=6)
    serials = [eng.submit(prompt, max_new_tokens=40 if i == 0 else 2) for i in range(64)]
    comps = eng.run_to_completion(max_steps=5000)
    assert [c.serial for c in comps] == sorted(serials)
    assert eng._reorder.parked_count() == 0
    assert eng.stats["emitted"] == 64
