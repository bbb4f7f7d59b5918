"""Mean host ms of an engine step (the program's engine.step span) less its
model.prefill, model.decode and engine.readback spans: the scheduler, the
uploads, the cache install, the slots' bookkeeping and the reorder ring's
sends, over the steps outside the profiled stretch."""
from portbench.metrics import program

LESS = ("model.prefill", "model.decode", "engine.readback")


def read(ctx):
    recs = program.records(ctx)
    steps = {i: r.t1 - r.t0 for i, r in enumerate(recs)
             if r.name == "engine.step" and not r.profiled}
    for r in recs:
        if r.name in LESS:
            j = r.parent
            while j is not None and recs[j].name != "engine.step":
                j = recs[j].parent
            if j in steps:
                steps[j] -= r.t1 - r.t0
    return sum(steps.values()) / len(steps) / 1e6 if steps else None
