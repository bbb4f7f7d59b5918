"""Port parity: the hybrid jamba-1.5-large-398b (seven mamba layers, one
attention layer and four MoE layers a period) and the cross-attention
llama-3.2-vision-90b against the JAX package on the CPU: the cross-attention
layer in train, prefill and decode, the whole smoke models (llama with
encoder states), their caches, and jamba through the serving engine.

Parameters come from the JAX package's ``init_params`` (smoke configs) and
move over through numpy; inputs and encoder states are made with numpy from
a seed.  Every JAX computation runs in a spawned child (``torch_jaxref``),
never in this process.  On the CPU the kernels' plain versions run; one
``cuda``-marked test holds jamba's path through K3, K4 and K5 on the card.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_jaxref import Reference, bf16
from torch_parity import (BF16_REL, F32_REL, check_moe_layers, check_transformer, close, leaves,
                          period0, tokens)
from repro_torch.configs import smoke_config
from repro_torch.kernels.attention import ops as flash_ops
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.kernels.dispatch import ops as dispatch_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ssd as k5
from repro_torch.models import attention, common, ffn, ssm, transformer
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.serve.engine import OrderedServingEngine

JAX = Reference()
_jax_child = JAX.fixture()

JAMBA, LLAMA = "jamba-1.5-large-398b", "llama-3.2-vision-90b"
XATTN_SLOT = "4"  # llama's period: four self-attention slots, then cross-attention


@functools.lru_cache(maxsize=None)
def _params_np(dtype: str, arch: str, seed: int = 0) -> dict:
    return JAX("model_params", dtype, seed, arch)


@functools.lru_cache(maxsize=None)
def _models(dtype: str, arch: str, seed: int = 0):
    """(port cfg, port params): the JAX smoke config of ``arch`` in ``dtype``
    and its parameters (PRNGKey(seed))."""
    cfg = common.from_reference_config(
        JAX("config_fields", arch, True, dtype=dtype, param_dtype=dtype))
    return cfg, params_from_numpy(_params_np(dtype, arch, seed), device="cpu")


def _array(rng, shape, dtype: str):
    """A seeded normal array in ``dtype`` (bf16 as ``ml_dtypes``), and the
    same as a tensor."""
    a = rng.standard_normal(shape)
    a = bf16(a) if dtype == "bfloat16" else a.astype(np.float32)
    return a, tensor_from_numpy(a, "cpu")


def _encoder_states(cfg, dtype: str, B: int = 2):
    """Encoder states (B, num_encoder_tokens, D) for ``cfg``, or (None,
    None) for a config that reads none."""
    if not cfg.num_encoder_tokens:
        return None, None
    return _array(np.random.RandomState(9), (B, cfg.num_encoder_tokens, cfg.d_model), dtype)


# ------------------------------------------------------- the cross-attention
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("dtype,rel", [("float32", F32_REL), ("bfloat16", BF16_REL)])
def test_cross_attention_matches_reference(dtype, rel, kind):
    """``cross_attn``, ``cross_attn_prefill`` (the encoder k/v it returns
    for the cache) and ``cross_attn_decode`` (which only reads them) of
    smoke llama's cross-attention layer against the reference."""
    cfg, _ = _models(dtype, LLAMA)
    p_np = period0(_params_np(dtype, LLAMA)["layers"])[XATTN_SLOT]["xattn"]
    assert "kv_norm_scale" in p_np  # defined (and never applied) by the reference
    p = params_from_numpy(p_np, "cpu")
    rng = np.random.RandomState(10)
    B, Se, Hkv, Dh = 2, cfg.num_encoder_tokens, cfg.num_kv_heads, cfg.hd
    enc_np, enc = _encoder_states(cfg, dtype, B)
    if kind == "decode":
        x_np, x = _array(rng, (B, 1, cfg.d_model), dtype)
        (ek_np, ek), (ev_np, ev) = (_array(rng, (B, Hkv, Se, Dh), dtype) for _ in range(2))
        before = (ek.clone(), ev.clone())
        y, cache = attention.cross_attn_decode(cfg, p, x, (ek, ev))
        assert cache[0] is ek and cache[1] is ev
        assert torch.equal(ek, before[0]) and torch.equal(ev, before[1])
        want = JAX("xattn_layer", dtype, x_np, None, p_np, kind, (ek_np, ev_np))
    else:
        x_np, x = _array(rng, (B, 24, cfg.d_model), dtype)
        want = JAX("xattn_layer", dtype, x_np, enc_np, p_np, kind)
        if kind == "train":
            y = attention.cross_attn(cfg, p, x, enc)
        else:
            y, (ek, ev) = attention.cross_attn_prefill(cfg, p, x, enc)
            want, want_ek, want_ev = want
            for got, w in ((ek, want_ek), (ev, want_ev)):
                assert got.dtype == x.dtype and tuple(got.shape) == (B, Hkv, Se, Dh)
                close(got.float().numpy(), w, rel)
    assert y.dtype == x.dtype and y.shape == x.shape
    close(y.float().numpy(), want, rel)


# ---------------------------------------------------------------- the cache
@pytest.mark.parametrize("arch,changes", [(JAMBA, {}), (LLAMA, {}), ("olmo-1b", {"kv_quant": True})])
def test_init_cache_matches_abstract_cache(arch, changes):
    """jamba's cache holds k/v beside ssm/conv, llama's the encoder ek/ev
    beside k/v, and under ``kv_quant`` k/v are int8 with f32 scales: every
    leaf's name, shape and dtype as the reference's ``abstract_cache``."""
    cfg = dataclasses.replace(common.from_reference_config(
        JAX("config_fields", arch, True, dtype="bfloat16", param_dtype="bfloat16")), **changes)
    want = JAX("abstract_cache", "bfloat16", 3, 40, arch, **changes)
    got = transformer.init_cache(cfg, 3, 40, "cpu")
    assert [(n, s, d) for n, s, d in want] == [
        (n, tuple(t.shape), str(t.dtype).removeprefix("torch.")) for n, t in leaves(got)]
    assert not any(t.any() for _, t in leaves(got))


def test_init_cache_refuses_an_unknown_mixer():
    cfg = dataclasses.replace(smoke_config("olmo-1b"), pattern=(("attn", "mlp"), ("rnn", "mlp")))
    with pytest.raises(ValueError, match="unknown mixer 'rnn'"):
        transformer.init_cache(cfg, 1, 8, "cpu")


# --------------------------------------------------------------- the models
MODEL_CASES = [(LLAMA, "float32", F32_REL, F32_REL), (LLAMA, "bfloat16", BF16_REL, BF16_REL),
               (JAMBA, "float32", F32_REL, F32_REL)]


@pytest.mark.parametrize("arch,dtype,rel,decode_rel", MODEL_CASES)
def test_forward_prefill_decode_match_reference(arch, dtype, rel, decode_rel):
    """Forward, prefill (every cache leaf: k/v, ek/ev, ssm/conv) and decode
    of the whole smoke model, llama with encoder states, against the
    reference."""
    cfg, params = _models(dtype, arch)
    toks = tokens(2, 24, cfg.vocab_size)
    enc_np, enc = _encoder_states(cfg, dtype)
    want = JAX("transformer_outputs", dtype, toks, 28, arch, enc_np)
    assert (float(want["aux"]) > 0) == cfg.has("moe")
    check_transformer(cfg, params, toks, want, rel, decode_rel, enc)


def test_jamba_bf16_routing_differences_are_near_ties():
    """Smoke jamba in bf16, held as phi3.5-moe is (its whole model in f32
    above): each of its four MoE layers a period, run on the reference's
    own input to that layer, routes every token as the reference does or at
    a near-tie within one bf16 step of the router input (``check_moe_layers``).
    (Over the whole bf16 model the router inputs drift apart by several
    bf16 steps through its fourteen mamba layers, so a whole-model
    difference is not a one-step near-tie past the second MoE layer; the
    routing rule itself is held in every layer here.)"""
    cfg, params = _models("bfloat16", JAMBA)
    toks = tokens(2, 24, cfg.vocab_size)
    check_moe_layers(cfg, params, JAX("moe_routing", "bfloat16", toks, JAMBA), BF16_REL)


@pytest.mark.parametrize("arch", [JAMBA, LLAMA])
def test_generate_tokens_equal_reference(arch):
    cfg, params = _models("float32", arch)
    prompt = tokens(2, 8, cfg.vocab_size, seed=7)
    enc_np, enc = _encoder_states(cfg, "float32")
    want = JAX("generate", "float32", prompt, 6, arch, enc_np)
    got = transformer.generate(cfg, params, torch.from_numpy(prompt).long(), 6, enc)
    assert got.shape == (2, 7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_encoder_states_move_the_logits():
    """llama's logits depend on the encoder states, through every entry
    point that takes them."""
    cfg, params = _models("float32", LLAMA)
    toks = torch.from_numpy(tokens(2, 8, cfg.vocab_size)).long()
    _, enc = _encoder_states(cfg, "float32")
    for fn in (lambda e: transformer.forward_train(cfg, params, toks, e)[0],
               lambda e: transformer.prefill(cfg, params, toks, e, max_len=12)[0]):
        assert not torch.allclose(fn(enc), fn(enc * 0.5))


# --------------------------------------------------------------- the engine
@pytest.mark.timeout(300)
@pytest.mark.parametrize("schedule", ["interleave", "prefill_first"])
def test_engine_matches_jax_engine(schedule):
    """Smoke jamba in f32 through the port's engine and the JAX engine: the
    same tokens, in the same order, after the same steps (the prefill hands
    each request's k/v and ssm/conv states to its slot; decode updates them
    in place)."""
    cfg, params = _models("float32", JAMBA, 1)
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, cfg.vocab_size, size=rng.randint(4, 12)), int(rng.randint(2, 10)))
            for _ in range(6)]
    want, want_stats = JAX("engine_run", 1, reqs, schedule, 3, 40, JAMBA)
    eng = OrderedServingEngine(cfg, params, max_slots=3, max_len=40, schedule=schedule,
                               device="cpu")
    for prompt, n in reqs:
        eng.submit(prompt, max_new_tokens=n)
    got = eng.run_to_completion()
    assert [c.serial for c in got] == [serial for serial, _ in want]
    for c, (_, toks) in zip(got, want):
        np.testing.assert_array_equal(c.tokens, toks)
    assert eng.stats == want_stats


@pytest.mark.parametrize("arch,changes", [(LLAMA, {}), ("olmo-1b", {"kv_quant": True})])
def test_engine_refuses_what_the_jax_engine_cannot_serve(arch, changes):
    """The JAX engine's prefill passes no encoder states and its prefill
    cache has no scales for an int8 cache: the port's engine refuses both
    kinds of config rather than serve something it cannot be held to."""
    cfg = dataclasses.replace(smoke_config(arch), **changes)
    with pytest.raises(ValueError, match="encoder states"):
        OrderedServingEngine(cfg, {}, device="cpu")


# ---------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_jamba_kernel_route_matches_plain_on_card(monkeypatch):
    """One period of jamba at widths the kernels take (head width 64, SSM
    head width 64, state 128, chunk 64), f32: a prefill launches K4 once
    (slot 4), K5 seven times a scan's launches (the mamba slots) and K3 four
    times (the MoE slots), a decode step K3 four times; the greedy tokens
    equal the plain route's (the three plain versions on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K3, K4 and K5 are CUDA kernels with no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(smoke_config(JAMBA, num_periods=1), d_model=128, head_dim=64,
                              ssm_head_dim=64, ssm_state=128, ssm_chunk=64,
                              dtype=torch.float32, param_dtype=torch.float32)
    params = common.init_params(cfg, 0, "cuda")
    toks = torch.from_numpy(tokens(2, 100, cfg.vocab_size)).long().cuda()
    counters = (flash_ops.flash_attention, ssd_ops.ssd, dispatch_ops.dispatch)
    before = [fn.LAUNCHES for fn in counters]
    steps = 6
    got = transformer.generate(cfg, params, toks, steps)
    launched = [fn.LAUNCHES - b for fn, b in zip(counters, before)]
    assert launched == [1, 7 * k5.LAUNCHES_PER_CALL, 4 * (1 + steps)]
    with monkeypatch.context() as m:
        m.setattr(attention, "flash_attention",
                  lambda q, k, v, causal=True: attention_ref(q, k, v, causal))
        m.setattr(ssm, "ssd", lambda x, dt, A, Bm, Cm, *, chunk: ssd_ops.ssd_scan_ref(
            x, dt, A, Bm, Cm, chunk))
        m.setattr(ffn, "dispatch",
                  lambda *a, **kw: dispatch_ops.dispatch(*a, **kw, use_kernel=False))
        want = transformer.generate(cfg, params, toks, steps)
    assert [fn.LAUNCHES - b for fn, b in zip(counters, before)] == launched
    assert torch.equal(got, want)
