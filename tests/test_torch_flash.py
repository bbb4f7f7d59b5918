"""Port parity: flash attention (K4's wrapper and plain version) against the
JAX package's ``attention_ref``.

Inputs are made with numpy from a seed and handed to both frameworks.  K4
itself runs only on the card (``cuda`` marker); on the CPU the wrapper takes
the plain ``attention_ref``.  The Pallas kernel is not the reference here: it
raises on the installed jax (ROADMAP R1).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.kernels.attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.attention import flash
from repro_torch.kernels.attention.ops import flash_attention
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


def _inputs(B, S, H, Hkv, Dh, seed=2):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    return q, k, v


def _torch(a, dtype, device="cpu"):
    return torch.from_numpy(a).to(device=device, dtype=TORCH_DTYPES[dtype])


@pytest.mark.parametrize("B,S,H,Hkv,Dh", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_cpu_matches_jax_ref(B, S, H, Hkv, Dh, dtype, causal):
    q, k, v = _inputs(B, S, H, Hkv, Dh)
    ref = jax_attention_ref(
        *(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)), causal=causal
    )
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


@pytest.mark.cuda
def test_flash_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K4 is a CUDA kernel with no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    for shape in SHAPES:
        for dtype in TOL:
            for causal in (True, False):
                q, k, v = (_torch(a, dtype, "cuda") for a in _inputs(*shape))
                out = flash.flash_fwd(q, k, v, causal)
                torch.cuda.synchronize()
                ref = attention_ref(q, k, v, causal)
                torch.testing.assert_close(
                    out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype],
                    msg=lambda m: f"{shape} {dtype} causal={causal}: {m}",
                )
