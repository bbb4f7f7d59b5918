"""Port parity: configs, parameters and the dense transformer (olmo-1b
family) against the JAX package on the CPU.

Parameters come from the JAX package's ``init_params`` and move over through
numpy (the two frameworks' random streams never match); token inputs are made
with numpy from a seed.  Every JAX computation runs in a spawned child
(``torch_jaxref``), never in this process.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_jaxref import Reference
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import attention, common, transformer
from repro_torch.models.convert import params_from_numpy

JAX = Reference()
_jax_child = JAX.fixture()


def _plain_fields(smoke: bool = True, **changes) -> dict:
    """The JAX olmo-1b config (smoke or full, with ``changes``) as plain
    values (dtypes by name)."""
    return JAX("config_fields", "olmo-1b", smoke, **changes)


@functools.lru_cache(maxsize=None)
def _models(dtype: str):
    """(port cfg, port params) of the JAX smoke config in ``dtype`` and its
    parameters (PRNGKey(0)), moved over through numpy."""
    cfg = common.from_reference_config(_plain_fields(dtype=dtype, param_dtype=dtype))
    params = params_from_numpy(JAX("model_params", dtype, 0), device="cpu")
    return cfg, params


def _tokens(B, S, vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= rel * scale, f"max |diff| {err} > {rel} * {scale}"


# ------------------------------------------------------------------ configs
def test_configs_mirror_the_reference():
    assert get_config("olmo-1b") == common.from_reference_config(_plain_fields(smoke=False))
    assert smoke_config("olmo-1b") == common.from_reference_config(_plain_fields())
    with pytest.raises(KeyError, match="not yet ported"):
        get_config("mamba2-780m")
    with pytest.raises(KeyError, match="unknown"):
        get_config("no-such-arch")


@pytest.mark.parametrize(
    "change",
    [
        {"kv_quant": True},
        {"seq_parallel": True},
        {"pattern": (("mamba", "none"),)},
        {"pattern": (("attn", "mlp"), ("xattn", "mlp"))},
        {"pattern": (("attn", "moe"),), "num_experts": 4, "top_k": 2},
    ],
)
def test_unported_features_raise(change):
    cfg = dataclasses.replace(smoke_config("olmo-1b"), **change)
    with pytest.raises(NotImplementedError):
        common.init_params(cfg, 0, "cpu")
    with pytest.raises(NotImplementedError):
        transformer.prefill(cfg, {}, torch.zeros(1, 4, dtype=torch.long))


# --------------------------------------------------------------- parameters
@pytest.mark.parametrize("arch_cfg", ["smoke", "full"])
def test_param_shapes_and_dtypes_match_abstract_params(arch_cfg):
    smoke = arch_cfg == "smoke"
    cfg = common.from_reference_config(_plain_fields(smoke))
    want, count = JAX("abstract_params", "olmo-1b", smoke)
    got = {
        name: (tuple(shape), str(dtype).removeprefix("torch."))
        for name, (shape, dtype) in _leaves(common.param_shapes(cfg))
    }
    assert got == want
    assert common.count_params(cfg) == count
    if arch_cfg == "smoke":  # allocate only the small one here
        real = {
            name: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for name, t in _leaves(common.init_params(cfg, 0, "cpu"))
        }
        assert real == want


def test_init_params_follows_the_reference_init_rules():
    cfg = dataclasses.replace(smoke_config("olmo-1b"), param_dtype=torch.float32)
    p = common.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    wq = p["layers"]["0"]["attn"]["wq"]  # normal, 1/sqrt(fan_in)
    wo = p["layers"]["0"]["attn"]["wo"]  # scaled: / sqrt(2 * layers) more
    assert abs(wq.std().item() * np.sqrt(cfg.d_model) - 1) < 0.05
    depth = np.sqrt(2.0 * cfg.num_layers)
    fan_in = cfg.num_heads * cfg.hd
    assert abs(wo.std().item() * np.sqrt(fan_in) * depth - 1) < 0.05
    again = common.init_params(cfg, 3, "cpu")["layers"]["0"]["attn"]["wq"]
    assert torch.equal(wq, again)  # same seed, same parameters


def test_bf16_params_round_trip_bit_exact():
    # the smoke config's own bf16 parameters
    flat = dict(_leaves(JAX("model_params", None, 4)))
    got = dict(_leaves(params_from_numpy(flat, device="cpu")))
    for name, a in flat.items():
        t = got[name]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16), a.view(np.uint16))


# -------------------------------------------------------------------- norms
@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm", "nonparametric_ln"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm_matches_reference(norm_type, dtype):
    rng = np.random.RandomState(5)
    x = (rng.standard_normal((2, 7, 64)) * 3 + 1).astype(np.float32)
    p = {"n_scale": rng.standard_normal(64).astype(np.float32),
         "n_bias": rng.standard_normal(64).astype(np.float32)}
    if norm_type == "rmsnorm":
        del p["n_bias"]
    cfg = dataclasses.replace(smoke_config("olmo-1b"), norm_type=norm_type)
    tdt = getattr(torch, dtype)
    want = JAX("apply_norm", norm_type, x, p, dtype)
    got = common.apply_norm(cfg, torch.from_numpy(x).to(tdt), {k: torch.from_numpy(v) for k, v in p.items()}, "n")
    assert got.dtype == tdt
    _close(got.float().numpy(), want, 1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_matches_reference(fraction):
    cfg = dataclasses.replace(smoke_config("olmo-1b"), rope_fraction=fraction)
    rng = np.random.RandomState(6)
    x = rng.standard_normal((2, 9, 4, cfg.hd)).astype(np.float32)
    pos = rng.randint(0, 500, (2, 9)).astype(np.int32)
    jc, _, want = JAX("rope", fraction, x, pos)
    tc, ts = attention.rope_freqs(cfg, torch.from_numpy(pos))
    _close(tc.numpy(), jc, 1e-5)
    got = attention.apply_rope(torch.from_numpy(x), tc, ts)
    _close(got.numpy(), want, 1e-5)


# ---------------------------------------------------------------- transformer
# f32: both frameworks compute the same algorithm; the bound covers sum order
# and the rope tables' last bits (relative to the largest logit).
F32_REL = 1e-4
# bf16: the frameworks round at other places (the JAX prefill rounds q and
# the softmax weights to bf16); the bound of tests/test_models_smoke.py
BF16_REL = 3e-2


@pytest.mark.parametrize("dtype,rel", [("float32", F32_REL), ("bfloat16", BF16_REL)])
def test_forward_prefill_decode_match_reference(dtype, rel):
    cfg, params = _models(dtype)
    B, S = 2, 24
    toks = _tokens(B, S, cfg.vocab_size)
    tt = torch.from_numpy(toks).long()
    want = JAX("transformer_outputs", dtype, toks, S + 4)

    want_full = want["full"]
    got_full = transformer.forward_train(cfg, params, tt)
    assert got_full.dtype == torch.float32 and got_full.shape == (B, S, cfg.padded_vocab)
    _close(got_full[..., : cfg.vocab_size].numpy(), want_full[..., : cfg.vocab_size], rel)

    want_p = want["prefill"]
    got_p, cache = transformer.prefill(cfg, params, tt[:, : S - 1], max_len=S + 4)
    _close(got_p[:, : cfg.vocab_size].numpy(), want_p[:, : cfg.vocab_size], rel)
    for name in ("k", "v"):
        assert tuple(cache["0"][name].shape) == want[name].shape
        _close(cache["0"][name].float().numpy(), want[name], rel)

    pos = np.full((B,), S - 1, np.int32)
    want_d = want["decode"]
    got_d, cache2 = transformer.decode_step(cfg, params, tt[:, S - 1], cache, torch.from_numpy(pos))
    assert cache2 is cache  # updated in place
    _close(got_d[:, : cfg.vocab_size].numpy(), want_d[:, : cfg.vocab_size], rel)
    # and decode agrees with the full forward at the last position
    _close(got_d[:, : cfg.vocab_size].numpy(), got_full[:, S - 1, : cfg.vocab_size].numpy(), rel)


def test_generate_tokens_equal_reference():
    cfg, params = _models("float32")
    prompt = _tokens(2, 8, cfg.vocab_size, seed=7)
    want = JAX("generate", "float32", prompt, 6)
    got = transformer.generate(cfg, params, torch.from_numpy(prompt).long(), num_steps=6)
    assert got.shape == (2, 7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_cache_matches_abstract_cache():
    cfg, _ = _models("bfloat16")
    want = JAX("abstract_cache", "bfloat16", 3, 40)
    got = transformer.init_cache(cfg, 3, 40, "cpu")
    assert len(want) == len(list(_leaves(got)))
    for (name, shape, dtype), (gname, t) in zip(want, _leaves(got)):
        assert name == gname and tuple(t.shape) == shape
        assert str(t.dtype).removeprefix("torch.") == dtype
        assert not t.any()
