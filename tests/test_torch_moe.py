"""Port parity: the Mixture-of-Experts family (qwen2-moe-a2.7b,
phi3.5-moe-42b-a6.6b) against the JAX package on the CPU, and the gradients
of K3's autograd Function (``kernels.dispatch.ops.Dispatch``).

Parameters come from the JAX package's ``init_params`` (smoke configs) and
move over through numpy; inputs are made with numpy from a seed.  Every JAX
computation runs in a spawned child (``torch_jaxref``), never in this
process.  On the CPU ``moe`` dispatches through the plain ``dispatch_ref``;
K3 runs only on the card (``cuda`` marker).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_jaxref import Reference, bf16
from torch_parity import BF16_REL, F32_REL, check_transformer, close, period0, tokens
from repro_torch.configs import smoke_config
from repro_torch.kernels.dispatch import dispatch as k3
from repro_torch.kernels.dispatch import ops as dispatch_ops
from repro_torch.kernels.dispatch.ops import Dispatch
from repro_torch.kernels.dispatch.ref import dispatch_ref
from repro_torch.models import common, ffn, transformer
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.serve.engine import OrderedServingEngine

JAX = Reference()
_jax_child = JAX.fixture()

MOE_ARCHS = ("qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b")
GRAD_TOL = 2e-5  # f32, as K4's Function (tests/test_torch_flash.py)


@functools.lru_cache(maxsize=None)
def _models(dtype: str, arch: str, capacity_factor=None):
    """(port cfg, port params): the JAX smoke config of ``arch`` in ``dtype``
    (and ``capacity_factor``) and its parameters (PRNGKey(0))."""
    changes = dict(dtype=dtype, param_dtype=dtype)
    if capacity_factor is not None:
        changes["capacity_factor"] = capacity_factor
    cfg = common.from_reference_config(JAX("config_fields", arch, True, **changes))
    return cfg, params_from_numpy(JAX("model_params", dtype, 0, arch), device="cpu")


def _layer(dtype: str, arch: str, capacity_factor=None, seed=0):
    """(cfg, layer 0's MoE parameters as numpy and as tensors, x as numpy and
    as a tensor (2, 24, D))."""
    cfg, _ = _models(dtype, arch, capacity_factor)
    p_np = period0(JAX("model_params", dtype, 0, arch)["layers"])["0"]["moe"]
    x = np.random.RandomState(seed).standard_normal((2, 24, cfg.d_model))
    x = bf16(x) if dtype == "bfloat16" else x.astype(np.float32)
    return cfg, p_np, params_from_numpy(p_np, "cpu"), x, tensor_from_numpy(x, "cpu")


def _spy_dest(monkeypatch, route=None):
    """Record the ``dest`` of every dispatch ``moe`` makes; ``route``
    replaces the wrapper."""
    seen = []
    inner = route or ffn.dispatch

    def spy(*args, **kwargs):
        out = inner(*args, **kwargs)
        seen.append(out[2])
        return out

    monkeypatch.setattr(ffn, "dispatch", spy)
    return seen


# ---------------------------------------------------------------- the layer
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype,rel", [("float32", F32_REL), ("bfloat16", BF16_REL)])
def test_moe_matches_reference(arch, dtype, rel, monkeypatch):
    cfg, p_np, p, x_np, x = _layer(dtype, arch)
    seen = _spy_dest(monkeypatch)
    y, aux = ffn.moe(cfg, p, x)
    want_y, want_aux, want_keep = JAX("moe_layer", arch, dtype, x_np, p_np)
    assert y.dtype == x.dtype and y.shape == x.shape and aux.dtype == torch.float32
    close(y.float().numpy(), want_y, rel)
    close(aux.numpy(), want_aux, rel)
    (dest,) = seen  # one dispatch, with partitions = experts
    assert dest.shape == (x.shape[0] * x.shape[1] * cfg.top_k,)
    if dtype == "float32":  # the same routing, so the same assignments kept
        np.testing.assert_array_equal((dest >= 0).numpy(), want_keep)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_drops_the_same_assignments(arch, monkeypatch):
    """At capacity factor 0.5 the experts overflow: K3's plain version keeps
    arrival order (token-major, choice minor) within an expert, as the
    reference's stable sort does, so the same assignments are dropped (dest
    -1 here, ``E*C`` in the reference) and y and aux agree."""
    cfg, p_np, p, x_np, x = _layer("float32", arch, capacity_factor=0.5)
    assert cfg.capacity_factor == 0.5
    seen = _spy_dest(monkeypatch)
    y, aux = ffn.moe(cfg, p, x)
    want_y, want_aux, want_keep = JAX("moe_layer", arch, "float32", x_np, p_np, 0.5)
    keep = (seen[0] >= 0).numpy()
    assert not keep.all() and keep.any()
    np.testing.assert_array_equal(keep, want_keep)
    close(y.numpy(), want_y, F32_REL)
    close(aux.numpy(), want_aux, F32_REL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_hands_k3_the_token_rows(arch, monkeypatch):
    """``moe`` gathers no copy of the token rows: the dispatch gets h (T, D)
    itself with ``group`` = top_k (assignment t reads row t // k), and its
    buffers equal the dispatch of the gathered rows ``h[t // k]``."""
    cfg, _, p, _, x = _layer("float32", arch)
    seen = []

    def spy(ids, pay, P, C, **kw):
        seen.append((ids, pay, P, C, kw))
        return dispatch_ref(ids, pay, P, C, **kw)

    monkeypatch.setattr(ffn, "dispatch", spy)
    ffn.moe(cfg, p, x)
    ((ids, h, P, C, kw),) = seen
    T = x.shape[0] * x.shape[1]
    assert kw == {"group": cfg.top_k} and h.shape == (T, cfg.d_model) and ids.shape == (T * cfg.top_k,)
    gathered = h[torch.arange(T * cfg.top_k) // cfg.top_k]
    for a, b in zip(dispatch_ref(ids, h, P, C, cfg.top_k), dispatch_ref(ids, gathered, P, C)):
        assert torch.equal(a, b)


def test_moe_capacity_matches_the_reference_formula():
    cfg = smoke_config("qwen2-moe-a2.7b")  # 8 experts, top-2, factor 1.25
    assert ffn.moe_capacity(cfg, 48) == 15  # ceil(48 * 2 / 8 * 1.25)
    assert ffn.moe_capacity(cfg, 4) == 4  # never below 4
    assert ffn.moe_capacity(dataclasses.replace(cfg, capacity_factor=0.5), 48) == 6


# ---------------------------------------------------- gradients (K3's Function)
def _function_route(monkeypatch):
    """``moe`` through K3's autograd Function on the CPU, with the plain
    version swapped in for the kernel (which runs only on the card)."""
    monkeypatch.setattr(Dispatch, "forward_fn", staticmethod(dispatch_ref))
    return _spy_dest(monkeypatch, route=lambda ids, pay, P, C, group=1: Dispatch.apply(
        ids, pay, P, C, group))


def _moe_grads(cfg, p, x, g, g_aux):
    """(y, aux, dx, {name: dp}) of ``moe`` by autograd."""
    p = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    x = x.detach().clone().requires_grad_()
    y, aux = ffn.moe(cfg, p, x)
    torch.autograd.backward((y, aux), (g, g_aux))
    return y, aux, x.grad, {k: v.grad for k, v in p.items()}


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_dispatch_function_gradients_match_plain_and_jax_vjp(arch, capacity_factor,
                                                             monkeypatch):
    """The gradients of ``moe`` with respect to x, the router and the expert
    (and shared-expert and norm) weights, through K3's Function, equal the
    plain route's (autograd through ``dispatch_ref``) and JAX's ``jax.vjp``
    of the reference ``moe`` within 2e-5 in f32, with and without drops."""
    cfg, p_np, p, x_np, x = _layer("float32", arch, capacity_factor)
    rng = np.random.RandomState(4)
    g = rng.standard_normal(x_np.shape).astype(np.float32)
    g_aux = np.float32(0.7)
    tg, tga = torch.from_numpy(g), torch.tensor(g_aux)
    y_p, aux_p, dx_p, dp_p = _moe_grads(cfg, p, x, tg, tga)  # the plain route

    seen = _function_route(monkeypatch)
    y, aux, dx, dp = _moe_grads(cfg, p, x, tg, tga)
    assert seen and y.grad_fn is not None
    assert torch.equal(y, y_p) and torch.equal(aux, aux_p)
    assert torch.equal(dx, dx_p)
    for name in dp:
        assert torch.equal(dp[name], dp_p[name]), name

    want_dx, want_dp = JAX("moe_vjp", arch, x_np, p_np, g, g_aux, capacity_factor)
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=GRAD_TOL, atol=GRAD_TOL)
    assert sorted(dp) == sorted(want_dp)
    for name in dp:
        np.testing.assert_allclose(dp[name].numpy(), want_dp[name], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("k", [2, 4])
def test_dispatch_function_gradient_wrt_token_rows_matches_jax_vjp(k):
    """K3's Function with ``group`` = k (the plain forward swapped in): the
    gradient with respect to the token rows h, each token's k gathered rows
    summed, equals ``jax.vjp`` of the reference ``dispatch_ref`` on
    ``jnp.repeat(h, k)`` within 2e-5 in f32, at capacity factor 0.5 (drops)."""
    rng = np.random.RandomState(30 + k)
    tokens, E, W = 48, 8, 32
    C = max(int(np.ceil(tokens * k / E * 0.5)), 4)
    ids = np.argsort(rng.standard_normal((tokens, E)), axis=1)[:, :k].astype(np.int32).reshape(-1)
    h = rng.standard_normal((tokens, W)).astype(np.float32)
    g = rng.standard_normal((E, C, W)).astype(np.float32)
    th = torch.from_numpy(h).requires_grad_()
    orig = Dispatch.forward_fn
    try:
        Dispatch.forward_fn = staticmethod(dispatch_ref)
        buf, counts, dest = Dispatch.apply(torch.from_numpy(ids), th, E, C, k)
    finally:
        Dispatch.forward_fn = staticmethod(orig)
    assert (dest < 0).any() and int(counts.max()) > C  # drops at capacity
    buf.backward(torch.from_numpy(g))
    want = JAX("dispatch_vjp", ids, h, E, C, k, g)
    np.testing.assert_allclose(th.grad.numpy(), want, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_dispatch_function_backward_is_the_gather():
    """The backward of K3's Function hands each tuple the gradient of the
    buffer row it landed in, and zero to dropped and invalid tuples."""
    ids = torch.tensor([1, 0, 1, 1, -1, 0], dtype=torch.int32)
    pay = torch.arange(12, dtype=torch.float32).reshape(6, 2).requires_grad_()
    orig = Dispatch.forward_fn
    try:
        Dispatch.forward_fn = staticmethod(dispatch_ref)
        buf, counts, dest = Dispatch.apply(ids, pay, 2, 2)  # the fourth 1 is dropped
    finally:
        Dispatch.forward_fn = staticmethod(orig)
    assert dest.tolist() == [2, 0, 3, -1, -1, 1] and counts.tolist() == [2, 3]
    assert not counts.requires_grad and not dest.requires_grad
    gbuf = torch.arange(1, 9, dtype=torch.float32).reshape(2, 2, 2)
    buf.backward(gbuf)
    want = torch.stack([gbuf.reshape(4, 2)[d] if d >= 0 else torch.zeros(2)
                        for d in dest.tolist()])
    assert torch.equal(pay.grad, want)


# --------------------------------------------------------------- the models
# Whole models in f32 for both, and in bf16 for qwen2-moe.  Smoke phi3.5-moe's
# bf16 forward sends 4 of its 48 tokens to another expert than the reference
# does (7 when capacity drops follow): the frameworks round the residual
# stream at other places, and its router's top-2 of 8 has near-ties that a
# bf16 step flips.  Its MoE layer is held in bf16 above, on the same inputs.
MODEL_CASES = [(arch, "float32", F32_REL) for arch in MOE_ARCHS] + [
    ("qwen2-moe-a2.7b", "bfloat16", BF16_REL)]


@pytest.mark.parametrize("arch,dtype,rel", MODEL_CASES)
def test_forward_prefill_decode_match_reference(arch, dtype, rel):
    cfg, params = _models(dtype, arch)
    toks = tokens(2, 24, cfg.vocab_size)
    want = JAX("transformer_outputs", dtype, toks, 28, arch)
    assert float(want["aux"]) > 0
    check_transformer(cfg, params, toks, want, rel)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_generate_tokens_equal_reference(arch):
    cfg, params = _models("float32", arch)
    prompt = tokens(2, 8, cfg.vocab_size, seed=7)
    want = JAX("generate", "float32", prompt, 6, arch)
    got = transformer.generate(cfg, params, torch.from_numpy(prompt).long(), num_steps=6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("schedule", ["interleave", "prefill_first"])
def test_engine_matches_jax_engine(schedule):
    """Smoke qwen2-moe in f32 through the port's engine and the JAX engine:
    the same tokens, in the same order, after the same steps."""
    cfg, _ = _models("float32", "qwen2-moe-a2.7b")
    params = params_from_numpy(JAX("model_params", "float32", 1, "qwen2-moe-a2.7b"), "cpu")
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, cfg.vocab_size, size=rng.randint(4, 12)), int(rng.randint(2, 10)))
            for _ in range(6)]
    want, want_stats = JAX("engine_run", 1, reqs, schedule, 3, 40, "qwen2-moe-a2.7b")
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
@pytest.mark.cuda
def test_moe_kernel_route_matches_plain_on_card(monkeypatch):
    """On the card ``moe`` dispatches through K3 (one launch) inside its
    autograd Function: y and aux equal the plain route's (``dispatch_ref`` on
    the card) bit for bit in f32, and so do the gradients of x and every
    weight, with and without drops; ``forward_train`` of smoke qwen2-moe
    gives every weight of the MoE layer a gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K3 is a CUDA kernel with no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(4)
    for arch in MOE_ARCHS:
        for cf in (1.25, 0.5):
            cfg = dataclasses.replace(smoke_config(arch), dtype=torch.float32,
                                      param_dtype=torch.float32, capacity_factor=cf)
            p = {k: v[0] for k, v in common.init_params(cfg, 0, "cuda")["layers"]["0"]["moe"]
                 .items()}
            x, g = (torch.from_numpy(rng.standard_normal((2, 24, cfg.d_model))
                                     .astype(np.float32)).cuda() for _ in range(2))
            g_aux = torch.tensor(0.7, device="cuda")
            before = dispatch_ops.dispatch.LAUNCHES
            got = _moe_grads(cfg, p, x, g, g_aux)
            assert dispatch_ops.dispatch.LAUNCHES == before + k3.LAUNCHES_PER_CALL == before + 1
            with monkeypatch.context() as m:
                m.setattr(ffn, "dispatch",
                          lambda *a, **kw: dispatch_ops.dispatch(*a, **kw, use_kernel=False))
                want = _moe_grads(cfg, p, x, g, g_aux)
            assert dispatch_ops.dispatch.LAUNCHES == before + 1
            for a, b in zip(got[:3], want[:3]):
                assert torch.equal(a, b)
            for name in got[3]:
                assert torch.equal(got[3][name], want[3][name]), name

    cfg = dataclasses.replace(smoke_config("qwen2-moe-a2.7b"), dtype=torch.float32,
                              param_dtype=torch.float32, head_dim=64)
    params = common.init_params(cfg, 0, "cuda")
    layer = params["layers"]["0"]["moe"]
    for t in layer.values():
        t.requires_grad_()
    toks = torch.from_numpy(tokens(2, 24, cfg.vocab_size)).long().cuda()
    logits, aux = transformer.forward_train(cfg, params, toks)
    (logits.logsumexp(-1).sum() + aux).backward()
    for name, t in layer.items():
        assert t.grad is not None and bool(t.grad.isfinite().all()) and bool(t.grad.any()), name
