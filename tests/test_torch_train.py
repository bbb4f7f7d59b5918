"""Port parity: training (``repro_torch.train``, ``transformer.loss_fn`` and
remat, ``launch/train.py``) against the JAX package on the CPU.

The schedule and AdamW run on shared parameters, gradients and state;
``loss_fn`` and its gradients on the JAX package's smoke parameters, moved
over through numpy, for every model family; a five-step loss curve of
``make_train_step`` against the reference's jitted one.  Every JAX
computation runs in a spawned child (``torch_jaxref``), never in this
process.  One ``cuda``-marked test trains on the card through K4.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_jaxref import Reference, bf16
from torch_parity import BF16_REL, close, leaves, tokens
from repro_torch.configs import smoke_config
from repro_torch.kernels.attention import ops as flash_ops
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.models import attention, common, transformer
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.train import (DataConfig, OptConfig, OrderedTokenPipeline, apply_adamw,
                               init_opt_state, make_prefill_step, make_serve_step,
                               make_train_step, schedule)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

JAX = Reference()
_jax_child = JAX.fixture()

ARCHS = ("olmo-1b", "qwen2-moe-a2.7b", "mamba2-780m", "jamba-1.5-large-398b",
         "llama-3.2-vision-90b")
LOSS_RTOL = 1e-5  # f32 loss
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6  # f32 gradients, element by element
# jamba's f32 gradients: its embed gradient has elements that its eight
# layers' contributions nearly cancel, off by up to 7.8e-5 where the leaf's
# largest is 9.8 (1.2e-5 of it), so its gradients are held to GRAD_RTOL of
# each leaf's largest (the model tests' rule, torch_parity.close)
SCALED_GRADS = ("jamba-1.5-large-398b",)
BF16_TOL = 2e-2  # bf16 loss and aux, relative to max(|want|, 1) (the flash tolerance)
# bf16 gradients, relative to each leaf's largest: up to 2.2e-2 seen on this
# draw (two or three bf16 steps near 1: mamba2's embed, llama's attention
# wo), under the bf16 model bound of tests/test_models_smoke.py.  The bound
# holds a wrong gradient (one token left out of the loss reads 0.16-0.49),
# not the last bits: the port's gradients with two mantissa bits dropped
# read 1.2e-2 to 4.1e-2 (PERF.md, training findings)
BF16_GRAD_TOL = BF16_REL


@functools.lru_cache(maxsize=None)
def _models(dtype: str, arch: str):
    """(port cfg, port params): the JAX smoke config of ``arch`` in ``dtype``
    and its PRNGKey(0) parameters, moved over through numpy."""
    fields = JAX("config_fields", arch, True, dtype=dtype, param_dtype=dtype)
    cfg = common.from_reference_config(fields)
    return cfg, params_from_numpy(JAX("model_params", dtype, 0, arch), device="cpu")


def _clone(tree):
    return tree_map(torch.clone, tree)


def _batch(cfg, B=2, S=16, seed=0, mask=False) -> dict:
    toks = tokens(B, S, cfg.vocab_size, seed)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    rng = np.random.RandomState(seed + 1)
    if mask:
        batch["loss_mask"] = (rng.rand(B, S) < 0.7).astype(np.float32)
    if cfg.num_encoder_tokens:
        enc = (rng.randn(B, cfg.num_encoder_tokens, cfg.d_model) * 0.5).astype(np.float32)
        batch["encoder_states"] = enc if cfg.dtype == torch.float32 else bf16(enc)
    return batch


def _port_batch(batch: dict) -> dict:
    return {k: tensor_from_numpy(v, "cpu") for k, v in batch.items()}


def _loss_and_grads(cfg, params, batch):
    flat = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, metrics = transformer.loss_fn(cfg, tree_unflatten(params, flat), batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _ordered(tree):
    return [v for _, v in leaves(tree)]


# ---------------------------------------------------------------- schedule
@pytest.mark.parametrize("ocfg", [
    dict(peak_lr=3e-4, warmup_steps=10, decay_steps=100),
    dict(peak_lr=1.0, warmup_steps=2, decay_steps=8, min_lr_frac=0.0),
], ids=["warm10-decay100", "warm2-decay8"])
def test_schedule_matches_reference(ocfg):
    steps = np.arange(121, dtype=np.int32)
    want = JAX("opt_schedule", ocfg, steps)
    got = np.asarray([float(schedule(OptConfig(**ocfg), torch.tensor(s, dtype=torch.int32)))
                      for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ------------------------------------------------------------------- AdamW
def tree_round(tree):
    return tree_map(lambda v: np.clip(np.round(v * 4) / 4, -16, 16), tree)


def _opt_case(kind: str, seed: int = 0):
    """(ocfg fields, params, grads, state) as numpy trees: a few leaves of
    several shapes at step 4, with moments and master made from a seed;
    ``clip`` draws gradients whose global norm is past ``grad_clip``."""
    rng = np.random.RandomState(seed)
    draw = lambda s=1.0: {"a": rng.randn(8, 16) * s, "b": {"c": rng.randn(32) * s,
                                                           "d": rng.randn(3, 4, 5) * s}}
    f32 = functools.partial(tree_map, lambda v: v.astype(np.float32))
    params = f32(draw())
    grads = f32(draw(0.01))
    if kind.endswith("clip"):
        # past grad_clip, the global norm scales every gradient, and the two
        # frameworks sum the squares in other orders: multiples of 1/4 up to
        # 16 have squares and sums that f32 holds exactly in any order, so
        # both sides clip by the same scale
        grads = f32(tree_round(draw(16.0)))
    mu = f32(draw(0.01))
    nu = f32({"a": np.abs(rng.randn(8, 16)) * 1e-4, "b": {
        "c": np.abs(rng.randn(32)) * 1e-4, "d": np.abs(rng.randn(3, 4, 5)) * 1e-4}})
    state = {"mu": mu, "nu": nu, "step": np.int32(4)}
    ocfg = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=20)
    if kind.startswith("bf16"):
        as_bf16 = functools.partial(tree_map, bf16)
        params, grads = as_bf16(params), as_bf16(grads)
        state["mu"], state["nu"] = as_bf16(mu), as_bf16(nu)
        ocfg.update(moment_dtype="bfloat16", master_fp32=False)
    else:
        state["master"] = f32({"a": params["a"] + 1e-3, "b": params["b"]})
    return ocfg, params, grads, state


def _bf16_ulps(got: torch.Tensor, want: np.ndarray) -> int:
    """The largest distance in bf16 steps between two bf16 arrays."""
    def ordered(bits):
        bits = bits.astype(np.int32)
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits & 0x7FFF)

    g = ordered(got.view(torch.uint16).numpy())
    w = ordered(np.asarray(want).view(np.uint16))
    return int(np.abs(g - w).max())


@pytest.mark.parametrize("kind", ["f32", "f32-clip", "bf16-moments-no-master-clip"])
def test_apply_adamw_matches_reference(kind):
    ocfg, params, grads, state = _opt_case(kind)
    want_p, want_s, want_m = JAX("adamw", ocfg, params, grads, state)
    oc = OptConfig(**{**ocfg, "moment_dtype": getattr(torch, ocfg.get("moment_dtype",
                                                                       "float32"))})
    tp, tg, ts = (params_from_numpy(t, "cpu") for t in (params, grads, state))
    before = [id(t) for t in tree_leaves(tp) + tree_leaves(ts)]
    got_p, got_s, got_m = apply_adamw(oc, tp, tg, ts)
    assert [id(t) for t in tree_leaves(got_p) + tree_leaves(got_s)] == before  # in place
    assert got_s["step"].dtype == torch.int32 and int(got_s["step"]) == 5
    np.testing.assert_allclose(float(got_m["lr"]), want_m["lr"], rtol=1e-6)
    np.testing.assert_allclose(float(got_m["grad_norm"]), want_m["grad_norm"], rtol=1e-6)
    pairs = [(got_p, want_p), (got_s["mu"], want_s["mu"]), (got_s["nu"], want_s["nu"])]
    if "master" in want_s:
        pairs.append((got_s["master"], want_s["master"]))
    else:
        assert "master" not in got_s
    for got, want in pairs:
        for (name, g), (_, w) in zip(leaves(got), leaves(want)):
            if kind.startswith("bf16"):
                assert g.dtype == torch.bfloat16, name
                assert _bf16_ulps(g, w) <= 1, name
            else:
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, err_msg=name)


# twins of tests/test_substrate.py's optimizer tests
def test_adamw_reduces_loss_quadratic():
    ocfg = OptConfig(peak_lr=0.1, warmup_steps=2, decay_steps=200, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    state = init_opt_state(ocfg, params)
    loss = lambda p: torch.sum(p["w"] ** 2)
    l0 = float(loss(params))
    for _ in range(100):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(loss({"w": w}), [w])
        params, state, m = apply_adamw(ocfg, params, {"w": g}, state)
    assert float(loss(params)) < 1e-2 * l0


def test_adamw_bf16_moments_master_off():
    ocfg = OptConfig(moment_dtype=torch.bfloat16, master_fp32=False, peak_lr=0.5,
                     warmup_steps=1)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = init_opt_state(ocfg, params)
    assert "master" not in state
    assert state["mu"]["w"].dtype == torch.bfloat16
    g = {"w": torch.ones(4, dtype=torch.bfloat16)}
    params2, state2, _ = apply_adamw(ocfg, params, g, state)
    assert params2["w"].dtype == torch.bfloat16
    assert float(params2["w"][0]) < 1.0


def test_schedule_warmup_and_decay():
    ocfg = OptConfig(peak_lr=1.0, warmup_steps=10, decay_steps=100, min_lr_frac=0.1)
    assert float(schedule(ocfg, torch.tensor(5))) == pytest.approx(0.5)
    assert float(schedule(ocfg, torch.tensor(10))) == pytest.approx(1.0, abs=1e-3)
    assert float(schedule(ocfg, torch.tensor(100))) == pytest.approx(0.1, abs=1e-3)


def test_data_pipeline_deterministic_and_seekable():
    cfg = DataConfig(vocab_size=256, seq_len=16, global_batch=4, seed=3)
    p1 = OrderedTokenPipeline(cfg)
    batches = [next(p1) for _ in range(5)]
    p2 = OrderedTokenPipeline(cfg, start_serial=3)
    np.testing.assert_array_equal(next(p2)["tokens"], batches[3]["tokens"])
    assert all(b["tokens"].max() < 256 and b["tokens"].dtype == np.int32 for b in batches)
    p1.seek(0)
    np.testing.assert_array_equal(next(p1)["tokens"], batches[0]["tokens"])


# ------------------------------------------------------------ loss and grads
# jamba's whole model is held in f32 only, as in test_torch_hybrid.py: over
# its bf16 model the router inputs drift apart by several bf16 steps through
# the mamba layers, and some tokens go to other experts
LOSS_CASES = [(arch, dtype, False) for arch in ARCHS for dtype in ("float32", "bfloat16")
              if (arch, dtype) != ("jamba-1.5-large-398b", "bfloat16")]
LOSS_CASES.append(("olmo-1b", "float32", True))


@pytest.mark.timeout(240)
@pytest.mark.parametrize("arch,dtype,mask", LOSS_CASES,
                         ids=[f"{a}-{d}{'-mask' if m else ''}" for a, d, m in LOSS_CASES])
def test_loss_and_grads_match_reference(arch, dtype, mask):
    cfg, params = _models(dtype, arch)
    batch = _batch(cfg, mask=mask)
    want_loss, want_m, want_g = JAX("loss_grads", dtype, arch, batch)
    loss, metrics, grads = _loss_and_grads(cfg, params, _port_batch(batch))
    assert loss.dtype == torch.float32 and loss.shape == ()
    want_g = _ordered(want_g)
    assert [tuple(g.shape) for g in grads] == [w.shape for w in want_g]
    if dtype == "float32":
        for got, want in ((loss, want_loss), (metrics["nll"], want_m["nll"]),
                          (metrics["aux"], want_m["aux"])):
            np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_RTOL, atol=1e-7)
        for (name, _), g, w in zip(leaves(params), grads, want_g):
            if arch in SCALED_GRADS:
                close(g.numpy(), w, GRAD_RTOL)
            else:
                np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                           err_msg=name)
    else:
        close(loss.numpy(), want_loss, BF16_TOL)
        close(metrics["aux"].numpy(), want_m["aux"], BF16_TOL)
        for (name, p), g, w in zip(leaves(params), grads, want_g):
            assert g.dtype == p.dtype, name  # as jax.grad gives
            close(g.float().numpy(), np.asarray(w, np.float32), BF16_GRAD_TOL)
    if cfg.has("moe"):
        assert float(metrics["aux"]) > 0


# ------------------------------------------------------------------- remat
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_leaves_gradients_bit_equal(arch):
    base, params = _models("float32", arch)
    batch = _port_batch(_batch(base))
    runs = {r: _loss_and_grads(dataclasses.replace(base, remat=r), params, batch)
            for r in ("none", "full", "dots")}
    loss0, _, grads0 = runs["none"]
    for r in ("full", "dots"):
        loss, _, grads = runs[r]
        assert torch.equal(loss, loss0), r
        assert all(torch.equal(g, g0) for g, g0 in zip(grads, grads0)), r


class _CountOps(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the calls of each aten op under the mode (the backward's
    included: autograd runs the backward's ops through it too)."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-moe-a2.7b", "jamba-1.5-large-398b"])
def test_remat_policies_recompute_what_they_say(arch):
    """``full`` runs products of the forward again in the backward; ``dots``
    saves the products with no batch dimension (``mm``), so a period of one
    sublayer runs no more of them than ``none`` does.  In a period of
    several sublayers (jamba) each sublayer is also checkpointed in full,
    as the reference nests ``jax.checkpoint``, and recomputes its own."""
    base, params = _models("float32", arch)
    batch = _port_batch(_batch(base))
    mm = {}
    for r in ("none", "full", "dots"):
        with _CountOps() as mode:
            _loss_and_grads(dataclasses.replace(base, remat=r), params, batch)
        mm[r] = mode.counts[torch.ops.aten.mm.default]
    if len(base.pattern) == 1:
        assert mm["none"] == mm["dots"] < mm["full"]
    else:
        assert mm["none"] < mm["dots"] < mm["full"]


@pytest.mark.parametrize("remat,passes", [("full", 2), ("none", 1)])
def test_flash_forward_runs_in_the_forward_and_the_recompute(monkeypatch, remat, passes):
    """K4's autograd Function under ``remat``: its ``forward_fn`` (the
    kernel on the card; a plain spy here) runs once a layer in the forward
    and once more in the recompute, and its backward still gives the plain
    version's gradients."""
    base, params = _models("float32", "olmo-1b")
    cfg = dataclasses.replace(base, remat=remat)
    calls = []

    def spy(q, k, v, causal):
        calls.append(q.shape)
        return attention_ref(q, k, v, causal)

    monkeypatch.setattr(flash_ops.FlashAttention, "forward_fn", staticmethod(spy))
    monkeypatch.setattr(attention, "flash_attention",
                        lambda q, k, v, causal=True: flash_ops.FlashAttention.apply(q, k, v,
                                                                                    causal))
    batch = _port_batch(_batch(cfg))
    loss, _, grads = _loss_and_grads(cfg, params, batch)
    assert len(calls) == passes * cfg.num_layers
    monkeypatch.undo()
    loss0, _, grads0 = _loss_and_grads(base, params, batch)
    torch.testing.assert_close(loss, loss0, rtol=1e-6, atol=0)
    for g, g0 in zip(grads, grads0):
        torch.testing.assert_close(g, g0, rtol=2e-5, atol=2e-6)


# ------------------------------------------------------------- train step
def _lr_at(ocfg: dict, step: int) -> float:
    return float(schedule(OptConfig(**ocfg), torch.tensor(step)))


@pytest.mark.timeout(240)
def test_five_train_steps_match_the_reference_jitted_step():
    cfg, params = _models("float32", "olmo-1b")
    params = _clone(params)
    ocfg = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=5)
    data = OrderedTokenPipeline(DataConfig(cfg.vocab_size, 32, 2, seed=0))
    batches = [{k: b[k] for k in ("tokens", "labels")} for b in (next(data) for _ in range(5))]
    want_metrics, want_params, want_state = JAX("train_steps", "float32", "olmo-1b", ocfg,
                                                batches)
    oc = OptConfig(**ocfg)
    step = make_train_step(cfg, oc)
    state = init_opt_state(oc, params)
    for t, (b, want) in enumerate(zip(batches, want_metrics), start=1):
        params, state, m = step(params, state, b)
        assert set(m) == set(want) == {"loss", "nll", "aux", "lr", "grad_norm"}
        np.testing.assert_allclose(float(m["loss"]), want["loss"], rtol=1e-4)
        np.testing.assert_allclose(float(m["lr"]), want["lr"], rtol=1e-6)
        # up to 7.6e-6 on three draws; one token left out of each step's
        # loss moves the grad norm by 6.3e-2 or more
        np.testing.assert_allclose(float(m["grad_norm"]), want["grad_norm"], rtol=1e-4)
    # Adam moves an element whose gradient is near 0 by up to 2 lr where the
    # two frameworks' gradients differ in sign there
    bound = 2 * _lr_at(ocfg, 5) + 1e-6
    for (name, got), (_, want) in zip(leaves(params), leaves(want_params)):
        err = float(np.abs(got.numpy() - want).max())
        assert err <= bound, (name, err, bound)
    assert int(state["step"]) == int(want_state["step"]) == 5
    # the moments average the clipped gradients and their squares: held to
    # the gradients' tolerance, relative to each leaf's largest
    for key in ("mu", "nu"):
        for (name, got), (_, want) in zip(leaves(state[key]), leaves(want_state[key])):
            err = float(np.abs(got.numpy() - want).max())
            assert err <= GRAD_RTOL * float(np.abs(want).max()), (key, name, err)


def test_serve_step_and_prefill_step_give_generate_tokens():
    cfg, params = _models("float32", "olmo-1b")
    prompt = torch.from_numpy(tokens(2, 9, cfg.vocab_size, 3)).long()
    want = transformer.generate(cfg, params, prompt, 5)
    logits, cache = make_prefill_step(cfg)(params, {"tokens": prompt})
    # pad the prefill cache to room for the decode steps
    S = prompt.shape[1]
    full = transformer.init_cache(cfg, 2, S + 5, device="cpu")
    for slot in cache:
        for name, t in cache[slot].items():
            full[slot][name][..., :S, :].copy_(t)
    token = logits.argmax(-1).to(torch.int32)
    out = [token]
    serve = make_serve_step(cfg)
    pos = torch.full((2,), S, dtype=torch.int32)
    for _ in range(5):
        token, full = serve(params, full, token.long(), pos)
        assert token.dtype == torch.int32
        out.append(token)
        pos = pos + 1
    torch.testing.assert_close(torch.stack(out, 1).long(), want.long(), rtol=0, atol=0)


# ------------------------------------------------------------- the driver
@pytest.mark.timeout(240)
def test_train_driver_end_to_end_with_resume(tmp_path):
    """The twin of the reference's driver test, and the resumed steps equal
    an uninterrupted run's, bit for bit (exactly-once resume on the CPU)."""
    from repro_torch.launch.train import main

    d = str(tmp_path / "ck")
    common_args = ["--arch", "olmo-1b", "--smoke", "--batch", "2", "--seq", "32",
                   "--device", "cpu"]
    losses = main(common_args + ["--steps", "8", "--ckpt-dir", d, "--ckpt-every", "4"])
    assert len(losses) == 8
    losses2 = main(common_args + ["--steps", "12", "--ckpt-dir", d, "--ckpt-every", "4",
                                  "--resume"])
    assert len(losses2) == 4  # steps 8..11 only
    # the uninterrupted run has the 12-step schedule from the start, so it
    # is compared on a run resumed from its own step-8 checkpoint
    d2 = str(tmp_path / "ck2")
    straight = main(common_args + ["--steps", "12", "--ckpt-dir", d2, "--ckpt-every", "8"])
    import shutil
    shutil.rmtree(f"{d2}/step_0000000012")
    resumed = main(common_args + ["--steps", "12", "--ckpt-dir", d2, "--resume"])
    assert resumed == straight[8:]
    assert all(np.isfinite(losses + losses2))


def test_train_driver_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.device_count():
        pytest.skip("checks the behaviour of a machine without CUDA")
    from repro_torch.launch.train import main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--smoke", "--steps", "1"])


# ---------------------------------------------------------------- the card
# one step through K4 against the same step through the plain version,
# relative to the plain version's loss and gradient norm; a planted wrong
# forward (K4 with its causal mask dropped) must land outside them.  On an
# H100: K4 2.1e-4 and 1.4e-5, the planted forward 9.9e-3 and 0.70
CARD_LOSS_REL, CARD_GNORM_REL = 2e-3, 1e-3


@pytest.mark.cuda
def test_train_step_on_the_card_through_k4(monkeypatch):
    """One train step of olmo-1b at kernel-legal widths (head dim 128) on the
    card: K4 launched in the forward and the recompute; layer 0's q, k, v as
    the step passed them held through K4 to ``attention_ref`` at the flash
    tolerance; the step's loss and gradient norm within the limits of the
    same step with the plain version as K4's forward, and a planted wrong
    forward outside them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K4 is a CUDA kernel with no CPU mode)")
    from repro_torch.kernels import parity
    from repro_torch.kernels.attention.flash import flash_fwd

    cfg = dataclasses.replace(smoke_config("olmo-1b"), d_model=512, num_heads=4,
                              num_kv_heads=4, head_dim=128, d_ff=1024, vocab_size=1024,
                              remat="full")
    params = common.init_params(cfg, 0, "cuda")
    batch = next(OrderedTokenPipeline(DataConfig(cfg.vocab_size, 256, 2, seed=0)))
    oc = OptConfig(warmup_steps=2, decay_steps=4)
    kernel = flash_ops.FlashAttention.forward_fn
    calls = []
    inner = attention.flash_attention

    def spy(q, k, v, causal=True):
        calls.append((q.detach(), k.detach(), v.detach(), causal))
        return inner(q, k, v, causal)

    monkeypatch.setattr(attention, "flash_attention", spy)
    runs = {}
    for route, fwd in (("kernel", kernel), ("plain", attention_ref),
                       ("planted", lambda q, k, v, causal: kernel(q, k, v, False))):
        p = _clone(params)
        monkeypatch.setattr(flash_ops.FlashAttention, "forward_fn", staticmethod(fwd))
        flash_ops.flash_attention.LAUNCHES = 0
        _, _, m = make_train_step(cfg, oc)(p, init_opt_state(oc, p), batch)
        runs[route] = ({k: float(v) for k, v in m.items()}, flash_ops.flash_attention.LAUNCHES)
    monkeypatch.undo()
    (mk, launches), (mp, _) = runs["kernel"], runs["plain"]
    assert launches == 2 * cfg.num_layers
    assert np.isfinite(mk["loss"])
    q, k, v, causal = calls[0]
    err = float((flash_fwd(q, k, v, causal).float() - attention_ref(q, k, v, causal).float())
                .abs().max())
    rel = {r: (abs(m["loss"] - mp["loss"]) / abs(mp["loss"]),
               abs(m["grad_norm"] - mp["grad_norm"]) / mp["grad_norm"])
           for r, (m, _) in runs.items() if r != "plain"}
    print(f"layer 0 K4 max|err| {err:.3e}; loss and grad norm relative to plain: {rel}")
    assert err <= parity.FLASH_TOL[q.dtype]
    assert rel["kernel"][0] <= CARD_LOSS_REL and rel["kernel"][1] <= CARD_GNORM_REL
    assert rel["planted"][0] > CARD_LOSS_REL and rel["planted"][1] > CARD_GNORM_REL
