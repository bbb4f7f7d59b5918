"""A cell cut to a size the CPU runs in seconds, for the tests: the same
harness, program and reference, the model at its family's tiny sizes
(``tiny(model)``; the transformer's: two layers of width 64 and a
vocabulary of 256), a few slots and short requests."""
from __future__ import annotations

import copy
import json
import time

from . import bench, families

# the serving cells of BENCHMARK.json
SERVE = [c["name"] for c in json.loads((bench.ROOT / "BENCHMARK.json").read_text())["workloads"]
         if bench.data("traffic", c["traffic"])["kind"] == "serve"]
# bfloat16 rounding weighs more at width 64 than at the cell's width: sound
# runs at this size read loss 5e-4, gradient 2e-3 and change 1.5e-3 (the
# cell's limits are 1.2e-4, 7e-4 and 5e-3), so the tests hold them to 10x
TRAIN_LIMITS = {"loss_gap": 5e-3, "grad_norm_gap": 2e-2, "change_gap": 5e-2}
# olmo-1b's served tokens at width 128 and a vocabulary of 1,024 (the
# control's test): sound runs read a widest gap of 0.004-0.009, the float8
# control 0.15-0.27
GAP_LIMIT = {"served_logit_gap": 0.1}


def run(workload: str, seed: int = 5, seconds: float = 1.0) -> bench.Run:
    return shrink(bench.load(workload, seed, seconds, False))


def shrink(r: bench.Run) -> bench.Run:
    """A loaded run cut to a test's size, on the CPU."""
    r.config = dict(r.config, model=families.of(r.config).tiny(r.config["model"]))
    r.mix = copy.deepcopy(r.mix)
    if r.mix["kind"] == "serve":
        r.mix["prompt"].update(median=12, min=4, max=24)
        r.mix["output"].update(median=6, min=2, max=12)
        r.mix["sample"] = 64  # every request the window egresses (~30)
        r.params = dict(r.params, slots=4, max_len=48, depth=3)
        r.seconds = 1.6  # 80 steps on the tests' clock (conftest.StepClock)
    else:
        r.mix.update(batch=2, seq_len=16)
        r.params = dict(r.params, limits=TRAIN_LIMITS)
    r.device, r.t_start = "cpu", time.perf_counter()
    return r
