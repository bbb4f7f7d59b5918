"""Operations, bytes and model FLOPs against shapes worked out by hand."""
import pytest

from portbench import counts
from portbench.families import transformer

DENSE = dict(d_model=8, num_heads=2, num_kv_heads=2, num_layers=1, d_ff=16, vocab_size=10)
MOE = dict(d_model=8, num_heads=2, num_kv_heads=2, num_layers=1, d_ff=4, vocab_size=10,
           num_experts=4, top_k=2, moe_d_ff=4, num_shared_experts=1)


def test_k4_counts():
    # B 1, S 4, H 2, Dh 8: 2 x 10 causal pairs, 4 FLOPs a pair and width unit
    flops, nbytes = counts.k4(1, 4, 2, 2, 8)
    assert flops == 4 * 20 * 8
    assert nbytes == 2 * 4 * 8 * (2 + 2 + 2 + 2)  # q, k, v read, o written, bf16


def test_k4_bounds_at_the_port_shapes():
    # S 512, H 16, Dh 128: bytes bound it (the kernel table's 0.00250 ms)
    assert counts.bound_s(*counts.k4(1, 512, 16, 16, 128)) * 1e3 == pytest.approx(0.0025041, rel=1e-4)
    # training's call, B 8 x S 1024 (the table's 0.04006 ms)
    assert counts.bound_s(*counts.k4(8, 1024, 16, 16, 128)) * 1e3 == pytest.approx(0.040065, rel=1e-4)


def test_k3_counts():
    # 3 tokens, top 2, 4 experts, rows of 8 bf16: ids, 3 rows read, 6 rows
    # written, counts, destinations
    _, nbytes = counts.k3(3, 2, 4, 8)
    assert nbytes == 6 * 4 + 3 * 8 * 2 + 6 * 8 * 2 + 4 * 4 + 6 * 4


def test_k3_bound_at_a_qwen2_moe_prefill():
    # 1,500 tokens, top 4 of 60, width 2,048: 6,000 ids and destinations,
    # 1,500 rows read and 6,000 written, 60 counts; bytes bind
    nbytes = 6000 * 4 * 2 + (1500 + 6000) * 2048 * 2 + 60 * 4
    assert counts.k3(1500, 4, 60, 2048) == (0.0, nbytes)
    assert counts.bound_s(*counts.k3(1500, 4, 60, 2048)) == pytest.approx(nbytes / 3.35e12)


def test_configured_capacity_drops_nothing():
    """qwen2-moe's capacity factor gives every expert a row for every token
    in the program (so K3's count keeps every assignment); the program's
    default drops."""
    import dataclasses

    pytest.importorskip("torch")
    from portbench import bench
    from repro_torch.models.ffn import moe_capacity

    cfg = bench.program_config(bench.load("qwen2-moe-a2.7b.stream-code", 0, 1.0, False).model)
    for tokens in (1, 7, 16, 1500, 7936):
        assert moe_capacity(cfg, tokens) >= tokens
    assert moe_capacity(dataclasses.replace(cfg, capacity_factor=1.25), 96) == 8


def test_model_flops_by_hand():
    # attention 8 x 4 x (2 + 2 + 2 + 2) = 256, MLP 3 x 8 x 16 = 384, head 80
    assert transformer.linear_weights(DENSE) == 256 + 384 + 80
    # routed 3 x 8 x 4 x (2 + 1) = 288, router 8 x 4 = 32
    assert transformer.linear_weights(MOE) == 256 + 288 + 32 + 80
    # a 3-token prompt: 2 x 3 x 640, the head once, 6 attended pairs
    assert transformer.prefill_flops(DENSE, 3) == 2 * 3 * 640 + 2 * 80 + 4 * 6 * 8
    # two slots decoding at positions 0 and 2: 1 and 3 keys
    assert transformer.decode_flops(DENSE, [0, 2]) == 2 * (2 * 720) + 4 * 8 * (1 + 3)
    assert transformer.train_flops(DENSE, 2, 3) == 3 * 2 * (2 * 3 * 720 + 4 * 6 * 8)


def test_olmo_train_step_share_of_peak():
    olmo = dict(d_model=2048, num_heads=16, num_kv_heads=16, num_layers=16, d_ff=8192,
                vocab_size=50304)
    assert transformer.linear_weights(olmo) == 1_176_764_416
    # PR 23's 394 ms step: 15.27% of the bf16 peak
    assert transformer.train_flops(olmo, 8, 1024) / 0.394 / counts.PEAKS["bf16_flops_per_s"] == \
        pytest.approx(0.1527, abs=5e-4)
