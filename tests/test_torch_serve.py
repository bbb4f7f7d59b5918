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


def test_engine_stays_eager_on_the_cpu():
    """On the CPU no decode step is captured: every one runs eagerly
    (``decode_replays`` stays 0).  The benchmark's warm-up call of ``_decode``
    on the engine's own params, tokens and cache still returns (the slots'
    next tokens, the engine's cache), and ``engine.tokens`` stays the buffer
    a prefill writes its first token into."""
    cfg = smoke_config("olmo-1b")
    params = init_params(cfg, 3, "cpu")
    eng = OrderedServingEngine(cfg, params, max_slots=3, max_len=48, device="cpu")
    tokens = eng.tokens
    position = torch.zeros((eng.max_slots,), dtype=torch.int32)
    out, cache = eng._decode(eng.params, eng.tokens, eng.cache, position)
    assert out.shape == (3,) and out.dtype == torch.long
    assert cache is eng.cache and eng.tokens is tokens
    for leaf in (leaf for slot in eng.cache.values() for leaf in slot.values()):
        leaf.zero_()
    eng.tokens.zero_()
    for prompt, n in _requests(6, cfg.vocab_size, seed=4):
        eng.submit(prompt, max_new_tokens=n)
    eng._do_prefill()
    assert eng.tokens is tokens and int(tokens[0]) == eng.slot_generated[0][0]
    eng.run_to_completion()
    assert eng.stats["decode_steps"] > 0
    assert eng.decode_replays == 0 and eng._graph is None


# ---------------------------------------------------------------- on the card
# each family at widths the kernels take (head width 64, SSM head width 64,
# state 128, chunk 64), two periods, in f32 with TF32 off: a bf16 product
# could round differently under capture, where the served tokens are compared
CARD_ARCHS = ("olmo-1b", "qwen2-moe-a2.7b", "mamba2-780m")


def _card_cut(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the decode graph is a CUDA graph; K3, K4 and K5 "
                    "have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(smoke_config(arch), d_model=128, head_dim=64, ssm_head_dim=64,
                              ssm_state=128, ssm_chunk=64, dtype=torch.float32,
                              param_dtype=torch.float32)
    return cfg, init_params(cfg, 0, "cuda")


def _card_requests(cfg, n=10):
    rng = np.random.RandomState(5)
    return [(rng.randint(0, cfg.vocab_size, size=int(rng.randint(20, 150))),
             int(rng.randint(3, 24))) for _ in range(n)]


def _eager(monkeypatch):
    """Every engine made inside decodes eagerly, as on a mesh."""
    monkeypatch.setattr(OrderedServingEngine, "_graphed", lambda self, params, cache: False)


def _served(cfg, params, requests, schedule):
    from repro_torch.kernels.dispatch.ops import dispatch

    eng = OrderedServingEngine(cfg, params, max_slots=4, max_len=256, schedule=schedule,
                               device="cuda")
    for prompt, n in requests:
        eng.submit(prompt, max_new_tokens=n)
    before = dispatch.LAUNCHES
    comps = eng.run_to_completion()
    torch.cuda.synchronize()
    return eng, comps, dispatch.LAUNCHES - before


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["interleave", "prefill_first"])
@pytest.mark.parametrize("arch", CARD_ARCHS)
def test_graphed_decode_serves_the_eager_tokens_on_card(arch, schedule, monkeypatch):
    """Ten requests through four slots, prefills installed between decode
    steps: the graphed engine egresses the tokens of the eager one, in
    order; every decode step after the first (the capture) is a replay; and
    K3's launch count is the eager run's."""
    cfg, params = _card_cut(arch)
    requests = _card_requests(cfg)
    eng, got, k3 = _served(cfg, params, requests, schedule)
    with monkeypatch.context() as m:
        _eager(m)
        eager, want, k3_eager = _served(cfg, params, requests, schedule)
    assert [c.serial for c in got] == [c.serial for c in want] == list(range(1, len(requests) + 1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
    assert eng.stats == eager.stats
    assert eng._graph is not None and eager._graph is None
    assert eng.decode_replays == eng.stats["decode_steps"] - 1 and eager.decode_replays == 0
    assert k3 == k3_eager
    assert k3 == (eng.stats["prefills"] + eng.stats["decode_steps"]) * cfg.num_layers * (
        arch == "qwen2-moe-a2.7b")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", CARD_ARCHS)
def test_capture_leaves_one_eager_steps_cache_and_tokens_on_card(arch, monkeypatch):
    """After the step that captures the graph, and after a replay, the
    cache (every leaf, the SSM and conv states too) and the slots' tokens
    equal those an eager engine holds after the same steps, exactly."""
    cfg, params = _card_cut(arch)
    requests = _card_requests(cfg, 4)

    def two_steps(eng):
        for prompt, n in requests:
            eng.submit(prompt, max_new_tokens=n)
        for _ in requests:
            eng._do_prefill()
        held = []
        for _ in range(2):
            eng._do_decode()
            torch.cuda.synchronize()
            held.append((eng.tokens.clone(), {si: {name: leaf.clone() for name, leaf in slot.items()}
                                              for si, slot in eng.cache.items()}))
        return held

    graphed = OrderedServingEngine(cfg, params, max_slots=4, max_len=256, device="cuda")
    got = two_steps(graphed)
    assert graphed.decode_replays == 1
    with monkeypatch.context() as m:
        _eager(m)
        want = two_steps(OrderedServingEngine(cfg, params, max_slots=4, max_len=256,
                                              device="cuda"))
    for (g_tok, g_cache), (w_tok, w_cache) in zip(got, want):
        assert torch.equal(g_tok, w_tok)
        for si, slot in w_cache.items():
            for name, leaf in slot.items():
                assert torch.equal(g_cache[si][name], leaf), (si, name)


@pytest.mark.cuda
def test_engine_frees_its_graph_on_card():
    """The graph and its memory pool go with the engine: after ``del``,
    ``gc.collect()`` and ``empty_cache()`` the card's reserved memory is
    back within 64 MiB of its level before the engine (a first engine,
    served and freed before, takes the process's one-time set-up: cuBLAS
    handles and workspaces)."""
    import gc

    cfg, params = _card_cut("qwen2-moe-a2.7b")
    requests = _card_requests(cfg, 6)

    def serve_and_free():
        eng = OrderedServingEngine(cfg, params, max_slots=4, max_len=8192, device="cuda")
        for prompt, n in requests:
            eng.submit(prompt, max_new_tokens=n)
        eng.run_to_completion()
        torch.cuda.synchronize()
        held = torch.cuda.memory_reserved()
        assert eng.decode_replays > 0
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return held

    serve_and_free()
    before = torch.cuda.memory_reserved()
    held = serve_and_free()
    cache_bytes = 2 * cfg.num_layers * 4 * cfg.num_kv_heads * 8192 * cfg.hd * 4
    assert held - before >= cache_bytes  # the engine's cache was on the card
    assert torch.cuda.memory_reserved() - before <= 64 * 2**20
