"""The dry-run, roofline, hill-climb and report of the port
(``repro_torch.launch.{dryrun,roofline,hillclimb,report}``) on the
``fake`` process-group backend.

Everything runs in two spawned children (``_child_results``,
``_child_pod``), so that no pytest worker keeps a default process group: smoke configs on the test meshes (2,4) and (2,2,2), fake tensors,
no data.
"""
import dataclasses
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import pytest

torch = pytest.importorskip("torch")

TEST_MESH = ((2, 4), ("data", "model"))
POD_MESH = ((2, 2, 2), ("pod", "data", "model"))
REL = 0.01  # the issue's 1% for counts that should add up


def _shape(kind, S=64, B=8):
    from repro_torch.configs import SHAPES

    name = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}[kind]
    return dataclasses.replace(SHAPES[name], seq_len=S, global_batch=B)


def _hand_argument_bytes(cfg, shape, mesh_shape):
    """Rank 0's argument bytes of a train step, from the specs by hand:
    each dim split by the mesh dims its (sanitized) spec names."""
    import math

    from repro_torch.models.common import abstract_params, param_pspecs
    from repro_torch.sharding.partitioning import AbstractMesh, batch_spec, sanitize_spec
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.tree import flatten

    mesh = AbstractMesh(*mesh_shape)
    size = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def local(shape_, spec):
        dims = []
        for d, axes in zip(shape_, list(spec) + [None] * (len(shape_) - len(spec))):
            group = () if axes is None else (axes,) if isinstance(axes, str) else axes
            dims.append(d // math.prod(size[a] for a in group))
        return math.prod(dims)

    ocfg = OptConfig(moment_dtype=cfg.optim_moment_dtype, master_fp32=cfg.optim_master_fp32)
    specs, ap = flatten(param_pspecs(cfg)), flatten(abstract_params(cfg))
    total = 0
    for name, a in ap.items():
        n = local(tuple(a.shape), sanitize_spec(mesh, specs[name], tuple(a.shape)))
        total += n * a.element_size()  # the parameter
        total += 2 * n * torch.empty((), dtype=ocfg.moment_dtype).element_size()  # mu, nu
        total += 4 * n if ocfg.master_fp32 else 0  # f32 master
    total += 4  # step, int32
    B, S = shape.global_batch, shape.seq_len
    total += 2 * 4 * local((B, S), batch_spec(mesh, B, 1))  # tokens, labels int32
    return total


def _all_sharded_products(mesh_shape):
    """Per-device FLOPs x chips of two products whose outputs are cut over
    every mesh dim, and the global count of the same products."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Shard
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun
    from repro_torch.sharding.partitioning import NamedSharding, P

    mesh = dryrun.fake_mesh(*mesh_shape)
    with FakeTensorMode():
        x = dryrun.place_fake(torch.empty(64, 128), NamedSharding(mesh, P("data", None)))
        w1 = dryrun.place_fake(torch.empty(128, 256), NamedSharding(mesh, P(None, "model")))
        w2 = dryrun.place_fake(torch.empty(256, 96), NamedSharding(mesh, P(None, None)))

    def fn(a, b, c):
        h = a @ b  # (64 over data, 256 over model)
        return (h.redistribute(h.device_mesh, [Shard(0), Shard(1)]) @ c).redistribute(
            h.device_mesh, [Shard(0), Shard(1)])

    counter, _, _ = dryrun.count_step(fn, (x, w1, w2), mesh)
    with FakeTensorMode(), FlopCounterMode(display=False) as fc:
        a, b, c = torch.empty(64, 128), torch.empty(128, 256), torch.empty(256, 96)
        (a @ b) @ c
    return counter.flops * mesh.size(), fc.get_total_flops()


def _child_pod():
    """The qwen2-moe smoke train cell on the (2,2,2) pod mesh (the slow one:
    DTensor weighs many strategies a op on three mesh dims)."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch import dryrun

    return dryrun.lower_cell("qwen2-moe-a2.7b", "train_4k", False,
                             cfg=smoke_config("qwen2-moe-a2.7b"), shape=_shape("train", S=32),
                             mesh_shape=POD_MESH)[0]


def _variants():
    """Every variant of the hill-climb's llama decode cell, on its smoke
    config: (argument bytes, step time, fsdp_params, kv_quant) each."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch import hillclimb

    spec = hillclimb.CELLS["llama_decode"]
    out = {}
    for name, tf in spec["variants"]:
        cfg = tf(smoke_config(spec["arch"], num_periods=1))
        r = hillclimb.measure(spec["arch"], spec["shape"], cfg, shape=_shape("decode"),
                              mesh_shape=TEST_MESH)
        out[name] = (r["memory_analysis"]["argument_bytes"], r["step_time_s"],
                     cfg.fsdp_params, cfg.kv_quant)
    return out


def _child_results(tmp):
    """The other checks' numbers, computed in a (spawned) child."""
    import json
    import os

    from repro_torch.configs import smoke_config
    from repro_torch.launch import dryrun, report, roofline

    out = {}
    olmo = dataclasses.replace(smoke_config("olmo-1b"), remat="full")
    rec, mem, _ = dryrun.lower_cell("olmo-1b", "train_4k", False, cfg=olmo,
                                    shape=_shape("train"), mesh_shape=TEST_MESH)
    out["olmo_train"] = rec
    out["hand_args"] = _hand_argument_bytes(olmo, _shape("train"), TEST_MESH)
    out["products"] = _all_sharded_products(TEST_MESH)
    out["variants"] = _variants()

    # aggregate = nP x body + the rest: the roofline record of 2 periods
    # against the dry-run of 4
    for kind in ("train", "prefill"):
        cfg = lambda n: dataclasses.replace(smoke_config("olmo-1b", num_periods=n), remat="full")
        kw = dict(shape=_shape(kind), mesh_shape=TEST_MESH)
        two = roofline.corrected_record("olmo-1b", _shape(kind).name, False, cfg=cfg(2), **kw)
        four, _, _ = dryrun.lower_cell("olmo-1b", _shape(kind).name, False, cfg=cfg(4), **kw)
        out[f"depths/{kind}"] = (two, four)

    # report: the tables of these records
    dirs = {k: os.path.join(tmp, k) for k in ("dryrun", "roofline", "perf")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    with open(os.path.join(dirs["dryrun"], "results.jsonl"), "w") as f:
        f.write(json.dumps(rec) + "\n")
    with open(os.path.join(dirs["roofline"], "roofline.jsonl"), "w") as f:
        for kind in ("train", "prefill"):
            f.write(json.dumps(out[f"depths/{kind}"][0]) + "\n")
    with open(os.path.join(dirs["perf"], "llama_decode.jsonl"), "w") as f:
        for kind in ("train", "prefill"):
            f.write(json.dumps(dict(out[f"depths/{kind}"][0], variant="v", cell="c")) + "\n")
    out["tables"] = (report.dryrun_table(os.path.join(dirs["dryrun"], "results.jsonl")),
                     report.roofline_table(os.path.join(dirs["roofline"], "roofline.jsonl")),
                     report.perf_tables(dirs["perf"]))
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    with ProcessPoolExecutor(max_workers=2,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        pod = pool.submit(_child_pod)
        out = pool.submit(_child_results, str(tmp_path_factory.mktemp("exp"))).result()
        return dict(out, qwen_pod=pod.result())


def test_lower_cell_on_the_test_meshes(results):
    """The twin of ``tests/test_distribution.py``'s compile tests."""
    for key, chips in (("olmo_train", 8), ("qwen_pod", 8)):
        r = results[key]
        assert r["chips"] == chips and r["flops_per_device"] > 0, key
        assert r["counted_routes"] == "plain"
        assert r["memory_analysis"]["generated_code_bytes"] is None
        assert r["memory_analysis"]["temp_bytes"] > 0
        assert r["bottleneck"] in ("compute", "memory", "collective")
    assert results["qwen_pod"]["mesh"] == "2x2x2"
    # the pod mesh shards the batch over pod x data: gradients are reduced
    assert results["qwen_pod"]["collective_bytes_per_device"]["total"] > 0


def test_argument_bytes_are_the_local_shards(results):
    assert results["olmo_train"]["memory_analysis"]["argument_bytes"] == results["hand_args"]


def test_per_device_flops_times_chips_is_the_global_count(results):
    per_device_x_chips, global_count = results["products"]
    assert global_count > 0
    assert abs(per_device_x_chips - global_count) <= REL * global_count


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_aggregate_is_periods_times_body_plus_the_rest(results, kind):
    """The body and rest of the 2-period roofline record predict the
    4-period dry-run's counts."""
    two, four = results[f"depths/{kind}"]
    assert two["num_periods"] == 2
    four_totals = {"flops_per_device": four["flops_per_device"],
                   "bytes_per_device": four["bytes_per_device"],
                   "collective_total_bytes": four["collective_bytes_per_device"]["total"]}
    for total, body in (("flops_per_device", "body_flops"), ("bytes_per_device", "body_bytes"),
                        ("collective_total_bytes", "body_coll")):
        assert two[body] > 0 or body == "body_coll"
        rest = two[total] - 2 * two[body]
        assert rest >= 0, (total, rest)
        want = 4 * two[body] + rest
        assert abs(four_totals[total] - want) <= REL * want, (total, four_totals[total], want)


def test_hillclimb_measure_applies_each_variant(results):
    v = results["variants"]
    assert set(v) == {"baseline", "tp_resident", "tp_resident+int8kv", "int8kv_only"}
    base = v["baseline"][0]
    assert v["tp_resident"][2] is False and v["tp_resident"][0] > base  # weights not FSDP-cut
    assert v["int8kv_only"][3] is True and v["int8kv_only"][0] < base  # int8 cache
    assert v["tp_resident+int8kv"][0] < v["tp_resident"][0]


def test_report_tables_render_from_the_records(results):
    dry, roof, perf = results["tables"]
    assert dry.count("\n") == 2 and "| olmo-1b | train_4k | 2x4 |" in dry
    assert roof.count("\n") == 3 and "| olmo-1b | train_4k |" in roof
    assert "| olmo-1b | prefill_32k |" in roof
    assert "### llama_decode" in perf and perf.count("| v |") == 2
