"""Port parity: flash attention (K4's wrapper and plain version) against the
JAX package's ``attention_ref``.

Inputs are made with numpy from a seed and handed to both frameworks; the
JAX side runs in a spawned child (``torch_jaxref``), never in this process.
K4 itself runs only on the card (``cuda`` marker); on the CPU the wrapper takes
the plain ``attention_ref``, and a tiled emulation of the bf16 kernel's
arithmetic (below) stands in for the kernel's design.  The Pallas kernel is
not the reference here: it raises on the installed jax (ROADMAP R1).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_jaxref import Reference
from repro_torch.kernels import parity
from repro_torch.kernels.attention import flash
from repro_torch.kernels.attention.ops import FlashAttention, flash_attention
from repro_torch.kernels.attention.ref import attention_ref

# (B, S, H, Hkv, Dh): the sweep of tests/test_kernels.py plus ragged S
SHAPES = [
    (1, 128, 2, 2, 64),
    (2, 256, 4, 2, 64),
    (1, 256, 8, 1, 128),
    (1, 1, 4, 2, 64),
    (2, 13, 4, 2, 64),
    (1, 200, 8, 2, 128),
]
# the tolerances of tests/test_kernels.py
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX = Reference()
_jax_child = JAX.fixture()


# the edges of the bf16 kernel's 64-row tiles, in the emulation's sweep
EDGE_SHAPES = [
    (1, 63, 4, 2, 64),
    (2, 65, 4, 4, 128),
    (2, 129, 4, 1, 64),
    (1, 1, 2, 2, 128),
]


def _inputs(B, S, H, Hkv, Dh, seed=2):
    return parity.flash_inputs(B, S, H, Hkv, Dh, seed)


def _torch(a, dtype, device="cpu"):
    return torch.from_numpy(a).to(device=device, dtype=TORCH_DTYPES[dtype])


@pytest.mark.parametrize("B,S,H,Hkv,Dh", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_cpu_matches_jax_ref(B, S, H, Hkv, Dh, dtype, causal):
    q, k, v = _inputs(B, S, H, Hkv, Dh)
    ref = JAX("attention", q, k, v, dtype, causal)
    before = flash_attention.LAUNCHES
    out = flash_attention(*(_torch(a, dtype) for a in (q, k, v)), causal=causal)
    assert flash_attention.LAUNCHES == before  # the CPU path launches nothing
    assert out.dtype == TORCH_DTYPES[dtype] and out.shape == (B, S, H, Dh)
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), rtol=TOL[dtype], atol=TOL[dtype]
    )


@pytest.mark.parametrize(
    "shape_q,shape_kv,dtype,match",
    [
        ((1, 16, 4, 96), (1, 16, 4, 96), torch.float32, "head_dim"),
        ((1, 16, 4, 64), (1, 16, 4, 64), torch.float16, "dtypes"),
        ((1, 16, 4, 64), (1, 16, 3, 64), torch.float32, "multiple"),
        ((1, 16, 4, 64), (1, 8, 4, 64), torch.float32, "match"),
        ((1, 16, 64), (1, 16, 64), torch.float32, "expected"),
    ],
)
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(shape_q, shape_kv, dtype, match):
    q = torch.zeros(shape_q, dtype=dtype)
    kv = torch.zeros(shape_kv, dtype=dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        flash.check_inputs(q, kv, kv)


def test_kernel_wrapper_rejects_cpu_and_strided_tensors():
    q = torch.zeros(1, 16, 4, 64)
    with pytest.raises(ValueError, match="CUDA kernel"):
        flash.flash_fwd(q, q, q)  # never a silent CPU fallback
    strided = torch.zeros(1, 4, 16, 64).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash.check_inputs(strided, q, q)
    shifted = torch.zeros(16 * 4 * 64 + 1, dtype=torch.bfloat16)[1:].view(1, 16, 4, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):  # TMA needs aligned tensors
        flash.check_inputs(shifted, shifted, shifted)


@pytest.mark.cuda
def test_flash_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K4 is a CUDA kernel with no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    flash._entry()  # the library's launch plan equals flash.plan()
    # SHAPES and the tile edges of parity.FLASH_SWEEP, f32 and bf16, both causal settings
    rows = parity.check_flash(flash.flash_fwd, tuple(SHAPES) + parity.FLASH_SWEEP)
    assert len(rows) == 4 * (len(SHAPES) + len(parity.FLASH_SWEEP))


# ---------------------------------------------------------------- the bf16 kernel's design
def _emulate_tensor_core_kernel(q, k, v, causal, tile=64, warpgroups=flash.TC_WARPGROUPS):
    """The bf16 kernel's arithmetic on the CPU, tile by tile: 64-row q tiles
    against 64-key tiles of their causal prefix, scores in fp32, the scale
    folded into exp2 on the fp32 scores, P rounded to bf16 before P V, the
    mask only on the last key tile.  Warpgroup w of ``warpgroups`` takes key
    tiles w, w + warpgroups, ... with its own online rescale of the fp32
    running max, denominator and accumulator; the partial results are
    merged at the end."""
    B, S, H, Dh = q.shape
    G = H // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)  # (B, H, S, Dh)
    kf, vf = (t.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3) for t in (k, v))
    scale_log2 = math.log2(math.e) / math.sqrt(Dh)
    pos = torch.arange(S)
    out = torch.empty(B, H, S, Dh)
    for q0 in range(0, S, tile):
        rows = qf[:, :, q0:q0 + tile]
        r = rows.shape[2]
        n_tiles = -(-(min(S, q0 + tile) if causal else S) // tile)
        parts = []
        for w in range(warpgroups):
            m = torch.full((B, H, r), -math.inf)
            l = torch.zeros(B, H, r)
            acc = torch.zeros(B, H, r, Dh)
            for t in range(w, n_tiles, warpgroups):
                kt, vt = kf[:, :, t * tile:(t + 1) * tile], vf[:, :, t * tile:(t + 1) * tile]
                s = rows @ kt.transpose(-1, -2)
                if t == n_tiles - 1 and causal:
                    keys = pos[t * tile:t * tile + kt.shape[2]]
                    s = s.masked_fill(keys[None, :] > pos[q0:q0 + r, None], -math.inf)
                m_new = torch.maximum(m, s.amax(-1) * scale_log2)
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s * scale_log2 - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ vt
                m = m_new
            parts.append((m, l, acc))
        m = torch.stack([pm for pm, _, _ in parts]).amax(0)
        scales = [torch.exp2(pm - m) for pm, _, _ in parts]  # 0 for a warpgroup without tiles
        l = sum(pl * a for (_, pl, _), a in zip(parts, scales))
        acc = sum(pa * a[..., None] for (_, _, pa), a in zip(parts, scales))
        out[:, :, q0:q0 + r] = acc / l[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("B,S,H,Hkv,Dh", SHAPES + EDGE_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_design_matches_jax_ref(B, S, H, Hkv, Dh, causal):
    q, k, v = _inputs(B, S, H, Hkv, Dh)
    ref = JAX("attention", q, k, v, "bfloat16", causal)
    out = _emulate_tensor_core_kernel(*(_torch(a, "bfloat16") for a in (q, k, v)), causal)
    if S > 64:  # more than one key tile: the split and the merge are exercised
        one = _emulate_tensor_core_kernel(*(_torch(a, "bfloat16") for a in (q, k, v)), causal,
                                          warpgroups=1)
        np.testing.assert_allclose(one.float().numpy(), out.float().numpy(),
                                   rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
    assert out.dtype == torch.bfloat16 and out.shape == (B, S, H, Dh)
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), rtol=TOL["bfloat16"], atol=TOL["bfloat16"]
    )


@pytest.mark.parametrize("Dh", flash.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_launch_plan(Dh, dtype):
    tensor_cores = dtype == "bfloat16"
    for S in (1, 13, 63, 64, 65, 128, 129, 200, 512, 4096):
        p = flash.plan(2, S, 16, Dh, TORCH_DTYPES[dtype])
        assert p.path == ("tensor_cores" if tensor_cores else "cuda_cores")
        assert p.smem_bytes <= flash.SMEM_LIMIT
        # the grid covers every query row once: ceil(S / rows) tiles, per head and batch
        assert p.grid == (math.ceil(S / p.block_rows), 16, 2)
        assert (p.grid[0] - 1) * p.block_rows < S <= p.grid[0] * p.block_rows
        if tensor_cores:
            # two consumer warpgroups on the m64 rows and one producer warp;
            # one such block fits an SM (233,472 bytes, 1,024 reserved per block)
            assert (p.block_rows, p.key_tile, p.threads) == (64, 64, 2 * 128 + 32)
            assert p.smem_bytes + 1024 <= 233_472
        else:
            assert (p.block_rows, p.key_tile, p.threads) == (32, 32, 128)


def _fake_plan(skew=0):
    """A ``flash_fwd_plan`` that answers from ``flash.plan``, with ``skew``
    added to the shared memory of bf16 at Dh=128."""
    def plan_fn(S, Dh, code, out):
        dtype = {c: d for d, c in flash._DTYPE_CODES.items()}[code]
        p = flash.plan(1, S, 1, Dh, dtype)
        extra = skew if (dtype == torch.bfloat16 and Dh == 128) else 0
        out[:] = [flash._PATH_CODES[p.path], p.block_rows, p.key_tile, p.threads, p.grid[0],
                  p.smem_bytes + extra]
        return 0
    return plan_fn


@pytest.mark.parametrize("skew", [0, 8])
def test_check_plan_holds_the_library_to_plan(skew):
    if skew:
        with pytest.raises(RuntimeError, match="plan"):
            flash.check_plan(_fake_plan(skew))
    else:
        flash.check_plan(_fake_plan())


def test_check_flash_sweep_on_cpu():
    shapes = ((1, 13, 4, 2, 64), (2, 65, 2, 1, 128))
    rows = parity.check_flash(flash_attention, shapes, device="cpu")
    assert len(rows) == 8 and all(err <= parity.FLASH_TOL[torch.bfloat16] for _, err in rows)

    def off(q, k, v, causal):  # a wrong kernel: one output element moved by 0.1
        out = attention_ref(q, k, v, causal).clone()
        out[0, -1, 0, 0] += 0.1
        return out
    with pytest.raises(RuntimeError, match="disagrees"):
        parity.check_flash(off, shapes[:1], device="cpu")


# ---------------------------------------------------------------- gradients (K4's Function)
# (B, S, H, Hkv, Dh): GQA with Hkv < H, a ragged S, and the head widths of K4
GRAD_SHAPES = [(1, 13, 4, 2, 64), (2, 65, 4, 1, 128)]


def _grads(fn, q, k, v, g, causal):
    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v, causal)
    out.backward(g)
    return out, (q.grad, k.grad, v.grad)


@pytest.mark.parametrize("B,S,H,Hkv,Dh", GRAD_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_gradients_match_plain_and_jax_vjp(B, S, H, Hkv, Dh, causal, monkeypatch):
    """K4's autograd Function, with the plain forward swapped in for the
    kernel (which runs only on the card): its q, k, v gradients equal those
    of ``attention_ref`` under autograd, and JAX's ``jax.vjp`` of the
    reference ``attention_ref`` (the reference's ``custom_vjp`` backward)
    within 2e-5 in f32."""
    monkeypatch.setattr(FlashAttention, "forward_fn", staticmethod(attention_ref))
    q, k, v = _inputs(B, S, H, Hkv, Dh)
    g = np.random.RandomState(3).standard_normal((B, S, H, Dh)).astype(np.float32)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out, got = _grads(FlashAttention.apply, tq, tk, tv, tg, causal)
    assert out.grad_fn is not None
    _, plain = _grads(attention_ref, tq, tk, tv, tg, causal)
    want = JAX("attention_vjp", q, k, v, g, causal)
    for a, b, c in zip(got, plain, want):
        assert a.shape == b.shape and torch.equal(a, b)  # the same recompute
        np.testing.assert_allclose(a.numpy(), c, rtol=TOL["float32"], atol=TOL["float32"])


@pytest.mark.cuda
def test_flash_kernel_gradients_on_card():
    """On the card ``flash_attention`` runs K4 and its output carries a
    ``grad_fn``: the kernel route's q, k, v gradients equal the plain
    route's within 2e-2 (bf16) and 2e-5 (f32), and ``forward_train`` gives
    every attention weight a gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K4 is a CUDA kernel with no CPU mode)")
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer
    from repro_torch.models.common import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    for B, S, H, Hkv, Dh in GRAD_SHAPES:
        q, k, v = (torch.from_numpy(a).cuda() for a in _inputs(B, S, H, Hkv, Dh))
        g = torch.from_numpy(np.random.RandomState(3).standard_normal((B, S, H, Dh))
                             .astype(np.float32)).cuda()
        for dtype, tol in ((torch.float32, TOL["float32"]), (torch.bfloat16, TOL["bfloat16"])):
            args = [t.to(dtype) for t in (q, k, v, g)]
            for causal in (True, False):
                before = flash_attention.LAUNCHES
                out, got = _grads(flash_attention, *args, causal)
                assert flash_attention.LAUNCHES == before + 1  # forward launches only
                assert out.grad_fn is not None
                _, want = _grads(attention_ref, *args, causal)
                for a, b in zip(got, want):
                    assert a.dtype == dtype
                    assert float((a.float() - b.float()).abs().max()) <= tol

    cfg = dataclasses.replace(smoke_config("olmo-1b"), head_dim=64, dtype=torch.float32,
                              param_dtype=torch.float32)
    params = init_params(cfg, 0, "cuda")
    attn = params["layers"]["0"]["attn"]
    for name in ("wq", "wk", "wv"):
        attn[name].requires_grad_()
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 24))).cuda()
    before = flash_attention.LAUNCHES
    transformer.forward_train(cfg, params, toks).logsumexp(-1).sum().backward()
    assert flash_attention.LAUNCHES > before
    for name in ("wq", "wk", "wv"):
        grad = attn[name].grad
        assert grad is not None and bool(grad.isfinite().all()) and bool(grad.any())
