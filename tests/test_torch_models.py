"""Port parity: configs, parameters and the dense transformer (olmo-1b,
glm4-9b, chatglm3-6b, starcoder2-15b, musicgen-large), with the int8 KV
cache (``kv_quant``) and ``seq_parallel``, against the JAX package on the
CPU.  (The MoE and mamba2 families: ``test_torch_moe.py`` and
``test_torch_ssm.py``; jamba and llama-3.2-vision: ``test_torch_hybrid.py``.)

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

from torch_jaxref import Reference, bf16
from torch_parity import (BF16_REL, F32_REL, check_transformer, close, leaves, period0,
                          quantize_cache, tokens)
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.models import attention, common, transformer
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy

JAX = Reference()
_jax_child = JAX.fixture()


DENSE_ARCHS = ("olmo-1b", "glm4-9b", "chatglm3-6b", "starcoder2-15b", "musicgen-large")


def _plain_fields(smoke: bool = True, arch: str = "olmo-1b", **changes) -> dict:
    """The JAX ``arch`` config (smoke or full, with ``changes``) as plain
    values (dtypes by name)."""
    return JAX("config_fields", arch, smoke, **changes)


@functools.lru_cache(maxsize=None)
def _models(dtype: str, arch: str = "olmo-1b"):
    """(port cfg, port params) of the JAX smoke config of ``arch`` in
    ``dtype`` and its parameters (PRNGKey(0)), moved over through numpy."""
    cfg = common.from_reference_config(_plain_fields(arch=arch, dtype=dtype, param_dtype=dtype))
    params = params_from_numpy(JAX("model_params", dtype, 0, arch), device="cpu")
    return cfg, params


# ------------------------------------------------------------------ configs
def test_registry_holds_the_ported_archs():
    assert ARCH_IDS == DENSE_ARCHS + ("qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b", "mamba2-780m",
                                      "jamba-1.5-large-398b", "llama-3.2-vision-90b")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_mirror_the_reference(arch):
    assert get_config(arch) == common.from_reference_config(_plain_fields(False, arch))
    assert smoke_config(arch) == common.from_reference_config(_plain_fields(True, arch))
    with pytest.raises(KeyError, match="unknown"):
        get_config("no-such-arch")


# --------------------------------------------------------------- parameters
@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("arch_cfg", ["smoke", "full"])
def test_param_shapes_and_dtypes_match_abstract_params(arch_cfg, arch):
    smoke = arch_cfg == "smoke"
    cfg = common.from_reference_config(_plain_fields(smoke, arch))
    want, count = JAX("abstract_params", arch, smoke)
    got = {
        name: (tuple(shape), str(dtype).removeprefix("torch."))
        for name, (shape, dtype) in leaves(common.param_shapes(cfg))
    }
    assert got == want
    assert common.count_params(cfg) == count
    assert common.count_active_params(cfg) == JAX("count_active_params", arch, smoke)
    if arch_cfg == "smoke":  # allocate only the small one here
        real = {
            name: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for name, t in leaves(common.init_params(cfg, 0, "cpu"))
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
    flat = dict(leaves(JAX("model_params", None, 4)))
    got = dict(leaves(params_from_numpy(flat, device="cpu")))
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
    close(got.float().numpy(), want, 1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_matches_reference(fraction):
    cfg = dataclasses.replace(smoke_config("olmo-1b"), rope_fraction=fraction)
    rng = np.random.RandomState(6)
    x = rng.standard_normal((2, 9, 4, cfg.hd)).astype(np.float32)
    pos = rng.randint(0, 500, (2, 9)).astype(np.int32)
    jc, _, want = JAX("rope", fraction, x, pos)
    tc, ts = attention.rope_freqs(cfg, torch.from_numpy(pos))
    close(tc.numpy(), jc, 1e-5)
    got = attention.apply_rope(torch.from_numpy(x), tc, ts)
    close(got.numpy(), want, 1e-5)


# ---------------------------------------------------------------- transformer
@pytest.mark.parametrize("arch", DENSE_ARCHS)
@pytest.mark.parametrize("dtype,rel", [("float32", F32_REL), ("bfloat16", BF16_REL)])
def test_forward_prefill_decode_match_reference(dtype, rel, arch):
    cfg, params = _models(dtype, arch)
    B, S = 2, 24
    toks = tokens(B, S, cfg.vocab_size)
    want = JAX("transformer_outputs", dtype, toks, S + 4, arch)
    assert float(want["aux"]) == 0.0  # no MoE layer
    full, got_d = check_transformer(cfg, params, toks, want, rel)
    # and decode agrees with the full forward at the last position
    V = cfg.vocab_size
    close(got_d[:, :V].numpy(), full[:, S - 1, :V].numpy(), rel)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_generate_tokens_equal_reference(arch):
    cfg, params = _models("float32", arch)
    prompt = tokens(2, 8, cfg.vocab_size, seed=7)
    want = JAX("generate", "float32", prompt, 6, arch)
    got = transformer.generate(cfg, params, torch.from_numpy(prompt).long(), num_steps=6)
    assert got.shape == (2, 7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_cache_matches_abstract_cache():
    cfg, _ = _models("bfloat16")
    want = JAX("abstract_cache", "bfloat16", 3, 40)
    got = transformer.init_cache(cfg, 3, 40, "cpu")
    assert len(want) == len(list(leaves(got)))
    for (name, shape, dtype), (gname, t) in zip(want, leaves(got)):
        assert name == gname and tuple(t.shape) == shape
        assert str(t.dtype).removeprefix("torch.") == dtype
        assert not t.any()


# ------------------------------------------------------ kv_quant, seq_parallel
@pytest.mark.parametrize("dtype,rel", [("float32", F32_REL), ("bfloat16", BF16_REL)])
def test_attn_decode_quant_matches_reference(dtype, rel):
    """``attn_decode_quant`` on the same int8 cache as the reference: the
    new k/v quantized per (b, head) into the int8 leaves bit for bit at each
    sequence's position, in place, their scales within f32 rounding, and
    the output within the model tolerance."""
    cfg, _ = _models(dtype)
    cfg = dataclasses.replace(cfg, kv_quant=True)
    p_np = period0(JAX("model_params", dtype, 0)["layers"])["0"]["attn"]
    rng = np.random.RandomState(8)
    B, S, Hkv, Dh = 2, 12, cfg.num_kv_heads, cfg.hd
    x_np = rng.standard_normal((B, 1, cfg.d_model))
    x_np = bf16(x_np) if dtype == "bfloat16" else x_np.astype(np.float32)
    cache_np = {
        "k": rng.randint(-127, 128, (B, Hkv, S, Dh)).astype(np.int8),
        "v": rng.randint(-127, 128, (B, Hkv, S, Dh)).astype(np.int8),
        "k_scale": rng.uniform(1e-3, 5e-2, (B, Hkv, S)).astype(np.float32),
        "v_scale": rng.uniform(1e-3, 5e-2, (B, Hkv, S)).astype(np.float32),
    }
    position = np.array([5, 11], np.int32)
    want_y, want_cache = JAX("attn_decode_quant", dtype, x_np, p_np, cache_np, position)
    cache = {k: torch.from_numpy(v.copy()) for k, v in cache_np.items()}
    y, new = attention.attn_decode_quant(cfg, params_from_numpy(p_np, "cpu"),
                                         tensor_from_numpy(x_np, "cpu"), cache,
                                         torch.from_numpy(position))
    assert new is cache and y.dtype == cfg.dtype
    close(y.float().numpy(), want_y, rel)
    for name in ("k", "v"):
        assert cache[name].dtype == torch.int8
        np.testing.assert_array_equal(cache[name].numpy(), want_cache[name])
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(cache[name].numpy(), want_cache[name], rtol=1e-6)


@pytest.mark.parametrize("dtype,rel", [("float32", F32_REL), ("bfloat16", BF16_REL)])
def test_int8_kv_decode_matches_reference(dtype, rel):
    """Smoke olmo with ``kv_quant``: the prefill's cache stays in the model's
    dtype (as the reference's, whose prefill never reads the switch); made
    int8 by the reference test's rule, one ``decode_step`` agrees with the
    reference's on its own quantized cache, and with the full forward within
    the reference test's 0.08 of scale; the cache stays int8."""
    cfg, params = _models(dtype)
    cfg_q = dataclasses.replace(cfg, kv_quant=True)
    B, S, V = 2, 24, cfg.vocab_size
    toks = tokens(B, S, V)
    tt = torch.from_numpy(toks).long()
    full, _ = transformer.forward_train(cfg, params, tt)
    _, cache = transformer.prefill(cfg_q, params, tt[:, : S - 1], max_len=S + 4)
    assert all(t.dtype == cfg.dtype for _, t in leaves(cache))
    qcache = quantize_cache(cache)
    got, new = transformer.decode_step(cfg_q, params, tt[:, S - 1], qcache,
                                       torch.full((B,), S - 1, dtype=torch.int32))
    assert new is qcache
    want, want_cache = JAX("quant_decode", dtype, toks, S + 4)
    close(got[:, :V].numpy(), want[:, :V], rel)
    ref = full[:, S - 1, :V]
    assert float((got[:, :V] - ref).abs().max()) < 0.08 * float(ref.abs().max())
    want_leaves = dict(leaves(want_cache))
    for name, t in leaves(new):
        w = want_leaves[name]
        assert str(t.dtype).removeprefix("torch.") == w.dtype.name, name
        if name.endswith("scale"):
            close(t.numpy(), w, rel)
        elif dtype == "float32":
            np.testing.assert_array_equal(t.numpy(), w, err_msg=name)
        else:  # int8 encodings of k/v that agree within rel: compared as the values they stand for
            scale = dict(leaves(new))[f"{name}_scale"]
            close((t.float() * scale[..., None]).numpy(),
                  w.astype(np.float32) * want_leaves[f"{name}_scale"][..., None], rel)


def test_seq_parallel_changes_nothing():
    """``seq_parallel`` places the residual stream on a mesh in the JAX
    package, and there is no mesh here: smoke glm4 with it gives the same
    logits as without, bit for bit, and matches the reference with it."""
    cfg, params = _models("float32", "glm4-9b")
    cfg_sp = dataclasses.replace(cfg, seq_parallel=True)
    toks = tokens(2, 16, cfg.vocab_size)
    tt = torch.from_numpy(toks).long()
    assert torch.equal(transformer.forward_train(cfg_sp, params, tt)[0],
                       transformer.forward_train(cfg, params, tt)[0])
    want = JAX("transformer_outputs", "float32", toks, 20, "glm4-9b", seq_parallel=True)
    check_transformer(cfg_sp, params, toks, want, F32_REL)
