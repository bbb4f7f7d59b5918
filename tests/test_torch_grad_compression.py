"""The port's int8 error-feedback gradient compression
(``repro_torch.train.grad_compression``): the quantizer against the JAX
package's (in a spawned child, ``torch_jaxref``), error feedback, and the
compressed all-reduce over a two-rank gloo group in spawned processes."""
import multiprocessing
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_jaxref import Reference
from repro_torch.train.grad_compression import (_dequantize, _quantize,
                                                compress_allreduce_leaf, init_error_state,
                                                make_compressed_allreduce)

JAX = Reference()
_jax_child = JAX.fixture()


def _inputs(case: str) -> np.ndarray:
    rng = np.random.RandomState(0)
    if case == "normal":
        return (rng.randn(64, 33) * 0.01).astype(np.float32)
    if case == "ties":  # x / scale lands on k + 1/2: round half to even
        return (np.arange(-254, 255, dtype=np.float32) / 2) * np.float32(0.25)
    if case == "spiky":
        x = (rng.randn(4096) * 1e-4).astype(np.float32)
        x[17] = 3.0
        return x
    return np.zeros(7, np.float32)


@pytest.mark.parametrize("case", ["normal", "ties", "spiky", "zeros"])
def test_quantize_matches_reference(case):
    x = _inputs(case)
    want_q, want_s = JAX("quantize", x)
    q, s = _quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8 and q.shape == x.shape
    np.testing.assert_array_equal(q.numpy(), want_q)
    np.testing.assert_allclose(float(s), want_s, rtol=1e-7)
    deq = _dequantize(q, s)
    assert deq.dtype == torch.float32
    assert float((deq - torch.from_numpy(x)).abs().max()) <= float(s) / 2 * (1 + 1e-6)


# twin of tests/test_substrate.py::test_grad_compression_error_feedback_unbiased_over_steps
def test_grad_compression_error_feedback_unbiased_over_steps():
    rng = np.random.RandomState(0)
    g_true = torch.from_numpy(rng.randn(64) * 0.01).float()
    err = torch.zeros(64)
    acc_q = torch.zeros(64)
    acc_true = torch.zeros(64)
    for _ in range(50):
        compensated = g_true + err
        q, s = _quantize(compensated)
        deq = _dequantize(q, s)
        err = compensated - deq
        acc_q = acc_q + deq
        acc_true = acc_true + g_true
    rel = float(torch.linalg.norm(acc_q - acc_true) / torch.linalg.norm(acc_true))
    assert rel < 0.01, rel


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_grads(rank: int) -> dict:
    rng = np.random.RandomState(100 + rank)
    return {"w": torch.from_numpy(rng.randn(32, 16) * 0.01).float(),
            "b": {"c": torch.from_numpy(rng.randn(40) * 0.1).to(torch.bfloat16)}}


def _rank_main(rank: int, world: int, port: int, out) -> None:
    """One rank of the gloo group: the reference test's leaf (rank r holds
    row r of arange(16).reshape(2, 8) * 0.01), then three steps of
    ``make_compressed_allreduce`` over a tree with error feedback."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        g = torch.arange(16.0).reshape(2, 8)[rank] * 0.01
        summed, err = compress_allreduce_leaf(g, torch.zeros(8))
        allreduce = make_compressed_allreduce()
        grads = _rank_grads(rank)
        state = init_error_state(grads)
        steps = []
        for _ in range(3):
            total, state = allreduce(grads, state)
            steps.append({"w": total["w"].numpy(), "c": total["b"]["c"].float().numpy(),
                          "c_dtype": str(total["b"]["c"].dtype)})
        out.put((rank, summed.numpy(), err.numpy(), steps))
    finally:
        dist.destroy_process_group()


@pytest.mark.timeout(120)
def test_compressed_allreduce_over_a_two_rank_gloo_group():
    world, port = 2, _free_port()
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, out)) for r in range(world)]
    for p in procs:
        p.start()
    results = dict((r, rest) for r, *rest in (out.get(timeout=100) for _ in procs))
    for p in procs:
        p.join(timeout=30)
        assert not p.is_alive() and p.exitcode == 0
    true_sum = (torch.arange(16.0).reshape(2, 8) * 0.01).sum(0).numpy()
    for summed, err, _ in results.values():
        rel = np.linalg.norm(summed - true_sum) / np.linalg.norm(true_sum)
        assert rel < 0.02, rel  # the reference's bound (tests/test_distribution.py)
    np.testing.assert_array_equal(results[0][0], results[1][0])  # every rank, the same sum
    exact = {k: sum(_rank_grads(r)["w"] if k == "w" else _rank_grads(r)["b"]["c"].float()
                    for r in range(world)).numpy() for k in ("w", "c")}
    for step in range(3):
        a, b = results[0][2][step], results[1][2][step]
        assert a["c_dtype"] == "torch.bfloat16"  # each leaf comes back in its dtype
        for k in ("w", "c"):
            np.testing.assert_array_equal(a[k], b[k])
            rel = np.linalg.norm(a[k] - exact[k]) / np.linalg.norm(exact[k])
            assert rel < 0.02, (step, k, rel)
