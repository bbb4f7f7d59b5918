"""K4: the hand-written Hopper flash-attention forward (``csrc/flash_fwd.cu``).

Counterpart of ``repro.kernels.attention.flash``, the Pallas TPU kernel.  The
CUDA source is compiled at first use (``kernels._build``) and called through
its C entry on PyTorch's current stream, without synchronising.  Takes any
``S >= 1``, head widths 64 and 128, float32 or bfloat16; anything else raises.
bfloat16 runs on the tensor cores (wgmma, TMA), float32 on the CUDA cores:
:func:`plan` says how each is launched, and the library's own plan is held
to it when the library is loaded.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from .. import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on an H100
# the bf16 kernel's K/V ring depth and consumer warpgroups (tc::STAGES,
# tc::kWarpgroups in the source)
TC_STAGES, TC_WARPGROUPS = 5, 2


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the C entry launches one call: grid (blocks along S, H, B)."""

    path: str  # "tensor_cores" (bf16: wgmma + TMA) or "cuda_cores" (f32)
    block_rows: int  # query rows per block
    key_tile: int  # keys per K/V tile
    threads: int  # per block
    grid: tuple[int, int, int]
    smem_bytes: int  # dynamic shared memory per block


def plan(B: int, S: int, H: int, Dh: int, dtype: torch.dtype) -> Plan:
    """The launch of ``flash_fwd`` for q (B,S,H,Dh) of ``dtype``, as the C
    entry makes it (``flash_fwd_plan`` in the source)."""
    if dtype == torch.bfloat16:
        # a tile is Dh/64 boxes of 64 x 64 bf16: q once, K and V in each
        # stage; the second warpgroup's accumulator, max and denominators
        # (Dh/2 + 4 f32 per thread); an mbarrier for q and three per stage;
        # 1024 bytes to align the swizzled boxes
        boxes = (Dh // 64) * (1 + 2 * TC_STAGES)
        exchange = (Dh // 2 + 4) * 128 * 4
        smem = boxes * 64 * 64 * 2 + exchange + (1 + 3 * TC_STAGES) * 8 + 1024
        rows, keys, threads = 64, 64, 128 * TC_WARPGROUPS + 32
        path = "tensor_cores"
    else:
        # q, v tiles [32][Dh] and the k tile [32][Dh+1] in f32
        rows, keys, threads, smem = 32, 32, 128, 4 * (32 * Dh + 32 * (Dh + 1) + 32 * Dh)
        path = "cuda_cores"
    return Plan(path, rows, keys, threads, (-(-S // rows), H, B), smem)


_PATH_CODES = {"cuda_cores": 0, "tensor_cores": 1}


def check_plan(plan_fn) -> None:
    """Hold the library's ``flash_fwd_plan(S, Dh, dtype code, out)`` to
    :func:`plan`; raise if they differ."""
    out = (ctypes.c_int * 6)()
    for dtype, code in _DTYPE_CODES.items():
        for Dh in HEAD_DIMS:
            for S in (1, 63, 64, 65, 512):
                if plan_fn(S, Dh, code, out):
                    raise RuntimeError(f"flash_fwd_plan refused S={S} Dh={Dh} {dtype}")
                want = plan(1, S, 1, Dh, dtype)
                got = tuple(out)
                expect = (_PATH_CODES[want.path], want.block_rows, want.key_tile, want.threads,
                          want.grid[0], want.smem_bytes)
                if got != expect:
                    raise RuntimeError(
                        f"{SOURCE.name} plans S={S} Dh={Dh} {dtype} as {got}; "
                        f"plan() says {expect}"
                    )


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what the kernel does not take: shapes, dtypes, layout."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"expected q (B,S,H,Dh) and k, v (B,S,Hkv,Dh); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, S, H, Dh = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != Dh or H % k.shape[2]:
        raise ValueError(
            f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} "
            "(same B, S, Dh; H a multiple of Hkv)"
        )
    if S < 1:
        raise ValueError("empty sequence")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {Dh} not supported by the kernel; supported: {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the kernel takes float32 or "
            "bfloat16, the same for q, k and v"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("bf16 q, k and v must start 16-byte aligned (TMA loads them)")


# q, k, v, o; B, S, H, Hkv, Dh, dtype code, causal
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.entry(SOURCE, "flash_fwd", _ARGTYPES)
    plan_fn = _build.load(SOURCE).flash_fwd_plan
    plan_fn.argtypes = (ctypes.c_int,) * 3 + (ctypes.POINTER(ctypes.c_int),)
    plan_fn.restype = ctypes.c_int
    check_plan(plan_fn)
    return fn


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Launch K4 on CUDA tensors; returns ``o`` (B,S,H,Dh) in q's dtype."""
    check_inputs(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd launches a CUDA kernel; tensors are on {q.device}")
    B, S, H, Dh = q.shape
    o = torch.empty_like(q)
    _build.launch(
        _entry(), q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, S, H, k.shape[2], Dh, _DTYPE_CODES[q.dtype], int(causal),
    )
    return o
