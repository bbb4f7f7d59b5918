"""90th percentile of a request's wait in the engine's queue, in ms: the
program's engine.queued span, from its submit to its prefill's start, over
the requests prefilled outside the profiled stretch."""
from portbench.metrics import program


def read(ctx):
    recs = program.records(ctx)
    outside = {r.id for r in recs if r.name == "engine.prefill" and not r.profiled}
    return program.p90([(r.t1 - r.t0) / 1e6 for r in recs
                        if r.name == "engine.queued" and r.id in outside])
