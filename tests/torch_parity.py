"""Shared checks of the port's model tests (``tests/test_torch_{models,moe,
ssm}.py``): the port's transformer entry points held to the JAX package's
values, which the caller got from ``torch_jaxref`` in its spawned child.
Imports neither jax nor ``repro``."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer

# f32: both frameworks compute the same algorithm; the bound covers sum order
# and the rope tables' last bits (relative to the largest logit).
F32_REL = 1e-4
# bf16: the frameworks round at other places (the JAX prefill rounds q and
# the softmax weights to bf16); the bound of tests/test_models_smoke.py
BF16_REL = 3e-2
# mamba2's bf16 decode takes another (recurrent) numeric path than its
# prefill: the bound of tests/test_models_smoke.py:76
MAMBA_BF16_DECODE_REL = 0.15


def tokens(B, S, vocab, seed=0) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


def leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def close(got, want, rel):
    """max |got - want| <= rel * max(max |want|, 1)."""
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= rel * scale, f"max |diff| {err} > {rel} * {scale}"


def period0(tree: dict) -> dict:
    """Period 0's slice of a stacked parameter tree of numpy arrays."""
    return {k: period0(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


def check_transformer(cfg, params, toks: np.ndarray, want: dict, rel: float,
                      decode_rel: float | None = None):
    """``forward_train`` (logits, aux), ``prefill`` of all but the last token
    (logits, every cache leaf) and ``decode_step`` of the last (logits, and
    every cache leaf after it, written in place) against ``want``, the
    output of ``torch_jaxref.transformer_outputs`` on ``toks``."""
    B, S = toks.shape
    V = cfg.vocab_size
    decode_rel = rel if decode_rel is None else decode_rel
    tt = torch.from_numpy(toks).long()
    full, aux = transformer.forward_train(cfg, params, tt)
    assert full.dtype == torch.float32 and full.shape == (B, S, cfg.padded_vocab)
    close(full[..., :V].numpy(), want["full"][..., :V], rel)
    close(aux.numpy(), want["aux"], rel)

    got_p, cache = transformer.prefill(cfg, params, tt[:, : S - 1], max_len=S + 4)
    close(got_p[:, :V].numpy(), want["prefill"][:, :V], rel)
    want_cache = dict(leaves(want["cache"]))
    assert [n for n, _ in leaves(cache)] == sorted(want_cache)
    for name, t in leaves(cache):
        assert tuple(t.shape) == want_cache[name].shape, name
        close(t.float().numpy(), want_cache[name], rel)

    pos = torch.full((B,), S - 1, dtype=torch.int32)
    got_d, cache2 = transformer.decode_step(cfg, params, tt[:, S - 1], cache, pos)
    assert cache2 is cache  # updated in place
    close(got_d[:, :V].numpy(), want["decode"][:, :V], decode_rel)
    want_d = dict(leaves(want["cache_d"]))
    for name, t in leaves(cache):
        close(t.float().numpy(), want_d[name], decode_rel)
    return full, got_d
