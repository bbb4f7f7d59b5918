"""Port parity: the Mamba2 family (mamba2-780m, ``models/ssm.py``) against
the JAX package on the CPU: the block in train, prefill and decode, the
whole smoke model, its cache and the serving engine.

Parameters come from the JAX package's ``init_params`` (smoke config) and
move over through numpy; inputs are made with numpy from a seed.  Every JAX
computation runs in a spawned child (``torch_jaxref``), never in this
process.  ``mamba_prefill`` scans through ``kernels.ssd.ops.ssd``: the plain
``ssd_chunked`` on the CPU, kernel K5 on the card (``cuda`` marker).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_jaxref import Reference, bf16
from torch_parity import (BF16_REL, F32_REL, MAMBA_BF16_DECODE_REL, check_transformer, close,
                          leaves, period0, tokens)
from repro_torch.configs import smoke_config
from repro_torch.kernels import parity
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import common, ssm, transformer
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.serve.engine import OrderedServingEngine

JAX = Reference()
_jax_child = JAX.fixture()

ARCH = "mamba2-780m"
SSD_TOL = 2e-4  # the SSD scan's tolerance (tests/test_kernels.py:153-154)
CASES = [("float32", F32_REL, F32_REL), ("bfloat16", BF16_REL, MAMBA_BF16_DECODE_REL)]


@functools.lru_cache(maxsize=None)
def _models(dtype: str, seed: int = 0):
    cfg = common.from_reference_config(
        JAX("config_fields", ARCH, True, dtype=dtype, param_dtype=dtype))
    return cfg, params_from_numpy(JAX("model_params", dtype, seed, ARCH), device="cpu")


def _layer(dtype: str, L: int, seed=0):
    """(cfg, layer 0's mamba parameters as numpy and as tensors, x (2, L, D)
    as numpy and as a tensor)."""
    cfg, _ = _models(dtype)
    p_np = period0(JAX("model_params", dtype, 0, ARCH)["layers"])["0"]["mamba"]
    x = np.random.RandomState(seed).standard_normal((2, L, cfg.d_model))
    x = bf16(x) if dtype == "bfloat16" else x.astype(np.float32)
    return cfg, p_np, params_from_numpy(p_np, "cpu"), x, tensor_from_numpy(x, "cpu")


# ---------------------------------------------------------------- the block
@pytest.mark.parametrize("L", [13, 16])  # a ragged length (padded with dt = 0) and two chunks
@pytest.mark.parametrize("dtype,rel,_", CASES)
def test_mamba_train_and_prefill_match_reference(dtype, rel, _, L):
    cfg, p_np, p, x_np, x = _layer(dtype, L)
    assert cfg.ssm_chunk == 8
    y = ssm.mamba_train(cfg, p, x)
    assert y.dtype == x.dtype and y.shape == x.shape
    close(y.float().numpy(), JAX("mamba_layer", ARCH, dtype, x_np, p_np, "train"), rel)
    y, (h, conv) = ssm.mamba_prefill(cfg, p, x)
    want_y, want_h, want_conv = JAX("mamba_layer", ARCH, dtype, x_np, p_np, "prefill")
    close(y.float().numpy(), want_y, rel)
    assert h.dtype == torch.float32 and h.shape == want_h.shape
    close(h.numpy(), want_h, SSD_TOL if dtype == "float32" else rel)
    assert conv.dtype == x.dtype and conv.shape == want_conv.shape
    close(conv.float().numpy(), want_conv, rel)


@pytest.mark.parametrize("dtype,_,rel", CASES)
def test_mamba_decode_matches_reference(dtype, _, rel):
    cfg, p_np, p, x_np, x = _layer(dtype, 1, seed=1)
    rng = np.random.RandomState(2)
    state = rng.standard_normal((2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)) * 0.5
    conv = rng.standard_normal((2, cfg.ssm_conv_kernel - 1, cfg.d_inner + 2 * cfg.ssm_state))
    state = state.astype(np.float32)
    conv = bf16(conv) if dtype == "bfloat16" else conv.astype(np.float32)
    cache = (torch.from_numpy(state), tensor_from_numpy(conv, "cpu"))
    y, (h, c) = ssm.mamba_decode(cfg, p, x, cache)
    want_y, want_h, want_c = JAX("mamba_layer", ARCH, dtype, x_np, p_np, "decode", (state, conv))
    close(y.float().numpy(), want_y, rel)
    close(h.numpy(), want_h, rel)
    np.testing.assert_array_equal(c.float().numpy(), np.asarray(want_c, np.float32))


def test_causal_conv_is_the_shifted_sum():
    """The grouped conv equals sum_k w[k] * x[t + k - (K-1)] (zeros before
    the start), then SiLU: the reference's ``conv_general_dilated`` layout."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.standard_normal((2, 9, 5)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
    xp = torch.nn.functional.pad(x, (0, 0, 3, 0))
    want = sum(w[k] * xp[:, k:k + 9] for k in range(4)) + b
    torch.testing.assert_close(ssm._causal_conv(x, w, b), torch.nn.functional.silu(want),
                               rtol=1e-6, atol=1e-6)


def test_prefill_scans_through_the_kernel_wrapper_and_train_does_not(monkeypatch):
    """``mamba_prefill`` calls ``ops.ssd`` (K5 on the card) with contiguous
    f32 inputs padded to a chunk multiple, from a zero state; ``mamba_train``
    stays on the plain ``ssd_chunked`` (K5 has no backward)."""
    cfg, _, p, _, x = _layer("float32", 13)
    calls = []
    inner = ssm.ssd

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return inner(*args, **kwargs)

    monkeypatch.setattr(ssm, "ssd", spy)
    ssm.mamba_train(cfg, p, x)
    assert not calls
    ssm.mamba_prefill(cfg, p, x)
    (args, kwargs), = calls
    assert kwargs == {"chunk": cfg.ssm_chunk}
    assert args[0].shape == (2, 16, cfg.ssm_heads, cfg.ssm_head_dim)
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in args)


# --------------------------------------------------------------- the model
@pytest.mark.parametrize("dtype,rel,decode_rel", CASES)
def test_forward_prefill_decode_match_reference(dtype, rel, decode_rel):
    cfg, params = _models(dtype)
    toks = tokens(2, 24, cfg.vocab_size)
    want = JAX("transformer_outputs", dtype, toks, 28, ARCH)
    assert float(want["aux"]) == 0.0
    check_transformer(cfg, params, toks, want, rel, decode_rel)


def test_generate_tokens_equal_reference():
    cfg, params = _models("float32")
    prompt = tokens(2, 8, cfg.vocab_size, seed=7)
    want = JAX("generate", "float32", prompt, 6, ARCH)
    got = transformer.generate(cfg, params, torch.from_numpy(prompt).long(), num_steps=6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_cache_matches_abstract_cache():
    cfg, _ = _models("bfloat16")
    want = JAX("abstract_cache", "bfloat16", 3, 40, ARCH)
    got = transformer.init_cache(cfg, 3, 40, "cpu")
    assert [(n, s, d) for n, s, d in want] == [
        (n, tuple(t.shape), str(t.dtype).removeprefix("torch.")) for n, t in leaves(got)]
    assert not any(t.any() for _, t in leaves(got))


@pytest.mark.timeout(300)
@pytest.mark.parametrize("schedule", ["interleave", "prefill_first"])
def test_engine_matches_jax_engine(schedule):
    """Smoke mamba2 in f32 through the port's engine and the JAX engine: the
    same tokens, in the same order, after the same steps (the prefill hands
    each request's ssm and conv states to its slot; decode updates them in
    place)."""
    cfg, params = _models("float32", 1)
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, cfg.vocab_size, size=rng.randint(4, 12)), int(rng.randint(2, 10)))
            for _ in range(6)]
    want, want_stats = JAX("engine_run", 1, reqs, schedule, 3, 40, ARCH)
    eng = OrderedServingEngine(cfg, params, max_slots=3, max_len=40, schedule=schedule,
                               device="cpu")
    for prompt, n in reqs:
        eng.submit(prompt, max_new_tokens=n)
    got = eng.run_to_completion()
    assert [c.serial for c in got] == [serial for serial, _ in want]
    for c, (_, toks) in zip(got, want):
        np.testing.assert_array_equal(c.tokens, toks)
    assert eng.stats == want_stats


# ---------------------------------------------------------------- on the card
def _card_config():
    """Smoke mamba2 at widths K5 takes (P = 64, N = 128, chunk 64), f32."""
    return dataclasses.replace(smoke_config(ARCH), d_model=128, ssm_head_dim=64, ssm_state=128,
                               ssm_chunk=64, dtype=torch.float32, param_dtype=torch.float32)


@pytest.mark.cuda
def test_mamba_prefill_kernel_route_matches_plain_on_card(monkeypatch):
    """On the card ``mamba_prefill`` scans through K5 (three launches): y,
    the ssm state and the conv state agree with the plain route
    (``ssd_chunked`` on the card) within the scan's tolerance, at a ragged
    length and at a chunk multiple; a smoke model's prefill launches K5 once
    per layer and its greedy tokens equal the plain route's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K5 is a CUDA kernel with no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _card_config()
    params = common.init_params(cfg, 0, "cuda")
    p = params["layers"]["0"]["mamba"]
    p = {k: v[0] for k, v in p.items()}
    def plain(x, dt, A, Bm, Cm, *, chunk):
        return ssd_ops.ssd_scan_ref(x, dt, A, Bm, Cm, chunk)

    for L in (100, 128):
        x = torch.from_numpy(np.random.RandomState(L).standard_normal((2, L, cfg.d_model))
                             .astype(np.float32)).cuda()
        before = ssd_ops.ssd.LAUNCHES
        y, (h, conv) = ssm.mamba_prefill(cfg, p, x)
        assert ssd_ops.ssd.LAUNCHES == before + 3
        with monkeypatch.context() as m:
            m.setattr(ssm, "ssd", plain)
            y_p, (h_p, conv_p) = ssm.mamba_prefill(cfg, p, x)
        assert parity.ssd_close((y, h), (y_p, h_p), SSD_TOL)[0]
        assert torch.equal(conv, conv_p)

    toks = torch.from_numpy(tokens(2, 40, cfg.vocab_size)).long().cuda()
    before = ssd_ops.ssd.LAUNCHES
    got = transformer.generate(cfg, params, toks, 6)
    assert ssd_ops.ssd.LAUNCHES == before + 3 * cfg.num_layers
    with monkeypatch.context() as m:
        m.setattr(ssm, "ssd", plain)
        want = transformer.generate(cfg, params, toks, 6)
    assert torch.equal(got, want)
