"""Shared checks of the port's model tests (``tests/test_torch_{models,moe,
ssm,hybrid}.py``): the port's transformer entry points held to the JAX
package's values, which the caller got from ``torch_jaxref`` in its spawned
child.  Imports neither jax nor ``repro``."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import ffn, transformer
from repro_torch.tree import flatten

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


def leaves(tree):
    """(name, leaf) pairs in leaf order (``repro_torch.tree.flatten``)."""
    return flatten(tree).items()


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
                      decode_rel: float | None = None, encoder_states=None):
    """``forward_train`` (logits, aux), ``prefill`` of all but the last token
    (logits, every cache leaf) and ``decode_step`` of the last (logits, and
    every cache leaf after it, written in place) against ``want``, the
    output of ``torch_jaxref.transformer_outputs`` on ``toks`` (and
    ``encoder_states``, a tensor)."""
    B, S = toks.shape
    V = cfg.vocab_size
    decode_rel = rel if decode_rel is None else decode_rel
    tt = torch.from_numpy(toks).long()
    full, aux = transformer.forward_train(cfg, params, tt, encoder_states)
    assert full.dtype == torch.float32 and full.shape == (B, S, cfg.padded_vocab)
    close(full[..., :V].numpy(), want["full"][..., :V], rel)
    close(aux.numpy(), want["aux"], rel)

    got_p, cache = transformer.prefill(cfg, params, tt[:, : S - 1], encoder_states,
                                       max_len=S + 4)
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


# ------------------------------------------------------- bf16 routing (P9)
def bf16_step(h: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at each element of h (0 where h is 0).
    bf16 keeps 8 significant bits, so at |h| = m 2**e with m in [1/2, 1) the
    spacing is 2**(e - 8); two roundings of one value to bf16 (to nearest,
    each within half a spacing) differ by at most one spacing."""
    _, e = torch.frexp(h.float())
    return torch.where(h == 0, 0.0, torch.ldexp(torch.ones_like(h, dtype=torch.float32), e - 8))


def _check_layer_routing(cfg, w, ids, keep, h, ref, B: int, S: int):
    """One MoE layer's routing (assignments ``ids``, kept mask ``keep``,
    router input h) against the reference's record ``ref``.  Each framework
    sends every token to the top-k of its own router scores h @ w and keeps
    what arrival order within capacity keeps; a token whose top-k (in
    order) differs must be a near-tie: for each pair of experts a, b that
    the two rank the other way round, the reference's score gap
    |s_a - s_b| is at most what one bf16 step of every element of its
    router input can move it,
        bound(a, b) = sum_d bf16_step(h_d) |w_da - w_db|,
    since s_a - s_b = sum_d h_d (w_da - w_db).  Returns the (T,) masks of
    the tokens whose experts differ and of those a neighbour's other choice
    pushed past (or back within) an expert's capacity."""
    k = cfg.top_k
    h_ref = torch.from_numpy(np.asarray(ref["h"], np.float32))
    got_s, want_s = h.float() @ w, h_ref @ w
    got_i = ids.reshape(-1, k).long()
    want_i = torch.from_numpy(np.asarray(ref["ids"])).reshape(-1, k).long()
    assert torch.equal(got_i, torch.topk(got_s, k).indices)
    assert torch.equal(want_i, torch.topk(want_s, k).indices)

    def kept(i):  # arrival order (token-major, choice minor) within capacity
        onehot = torch.nn.functional.one_hot(i.reshape(-1), cfg.num_experts)
        rank = (onehot.cumsum(0) - onehot).gather(1, i.reshape(-1, 1))[:, 0]
        return (rank < ffn.moe_capacity(cfg, B * S)).reshape(-1, k)

    assert torch.equal(keep.reshape(-1, k), kept(got_i))
    step = bf16_step(h_ref)
    other = (got_i != want_i).any(1)
    for t in torch.nonzero(other).flatten().tolist():
        experts = sorted(set(got_i[t].tolist()) | set(want_i[t].tolist()))
        swapped = [(a, b) for a in experts for b in experts if a < b
                   and bool(got_s[t, a] > got_s[t, b]) != bool(want_s[t, a] > want_s[t, b])]
        assert swapped, f"token {t}: top-{k} {got_i[t].tolist()} != {want_i[t].tolist()}"
        for a, b in swapped:
            gap = abs(float(want_s[t, a] - want_s[t, b]))
            bound = float((step[t] * (w[:, a] - w[:, b]).abs()).sum())
            assert gap <= bound, (
                f"token {t}: experts {a}, {b} swap at a score gap {gap} > {bound}, "
                "more than one bf16 step of the router input: a routing fault")
    return other, (kept(got_i) != kept(want_i)).any(1)


def _moe_routers(cfg, params) -> list:
    return [params["layers"][str(si)]["moe"]["w_router"][i]
            for i in range(cfg.num_periods)
            for si, (_, kind) in enumerate(cfg.pattern) if kind == "moe"]


class _SpyDispatch:
    """Inside the block, records (ids, h, kept mask) of every dispatch
    ``ffn.moe`` makes."""

    def __enter__(self):
        self.seen, self._inner = [], ffn.dispatch

        def spy(ids, h, P, C, group=1):
            out = self._inner(ids, h, P, C, group=group)
            self.seen.append((ids, h, out[2] >= 0))
            return out

        ffn.dispatch = spy
        return self.seen

    def __exit__(self, *exc):
        ffn.dispatch = self._inner


def check_routing(cfg, params, toks: np.ndarray, want: list, rel: float,
                  encoder_states=None) -> int:
    """Every MoE layer's routing in the port's ``forward_train`` on ``toks``
    against ``want``, the reference's (``torch_jaxref.moe_routing``), by
    ``_check_layer_routing``; the router inputs agree within ``rel`` of
    scale at the tokens that no token routed otherwise reaches: one whose
    experts differ, or one pushed past an expert's capacity (all tokens
    share it), reaches the tokens after it in its sequence in the later
    layers, through the causal mixers.  Returns the number of tokens (over
    all layers) whose experts differ."""
    with _SpyDispatch() as seen:
        transformer.forward_train(cfg, params, torch.from_numpy(toks).long(), encoder_states)
    routers = _moe_routers(cfg, params)
    assert len(seen) == len(want) == len(routers)
    B, S = toks.shape
    reached = torch.zeros(B, S, dtype=torch.bool)
    differing = 0
    for (ids, h, keep), ref, w in zip(seen, want, routers):
        clean = ~reached.reshape(-1)
        close(h.float()[clean].numpy(), np.asarray(ref["h"], np.float32)[clean.numpy()], rel)
        other, pushed = _check_layer_routing(cfg, w, ids, keep, h, ref, B, S)
        differing += int(other.sum())
        reached |= (other | pushed).reshape(B, S).int().cummax(dim=1).values.bool()
    return differing


def check_moe_layers(cfg, params, want: list, rel: float) -> int:
    """Every MoE layer of the port on the reference's own input to that
    layer (``want``, from ``torch_jaxref.moe_routing``): the router input
    within ``rel`` of scale of the reference's, and the routing by
    ``_check_layer_routing``.  Returns the number of tokens (over all
    layers) whose experts differ."""
    routers = _moe_routers(cfg, params)
    slots = [(i, str(si)) for i in range(cfg.num_periods)
             for si, (_, kind) in enumerate(cfg.pattern) if kind == "moe"]
    assert len(want) == len(slots)
    differing = 0
    for (i, si), ref, w in zip(slots, want, routers):
        p = {k: v[i] for k, v in params["layers"][si]["moe"].items()}
        x = ref["x"]
        with _SpyDispatch() as seen:
            ffn.moe(cfg, p, torch.from_numpy(np.asarray(x, np.float32)).to(cfg.dtype))
        ((ids, h, keep),) = seen
        close(h.float().numpy(), np.asarray(ref["h"], np.float32), rel)
        other, _ = _check_layer_routing(cfg, w, ids, keep, h, ref, *x.shape[:2])
        differing += int(other.sum())
    return differing


def quantize_cache(cache: dict) -> dict:
    """A bf16 cache made int8 with per-(b, head, position) scales, by the
    JAX package's test rule (``tests/test_serving_optimizations.py:26-43``):
    scale = absmax over Dh / 127 + 1e-9, values rounded and clipped to
    [-127, 127]; other leaves as they are."""
    out = {}
    for si, slot in cache.items():
        out[si] = {}
        for name, t in slot.items():
            if name in ("k", "v"):
                a = t.float()
                scale = a.abs().amax(-1) / 127.0 + 1e-9
                out[si][name] = torch.round(a / scale[..., None]).clamp(-127, 127).to(torch.int8)
                out[si][f"{name}_scale"] = scale
            else:
                out[si][name] = t
    return out
