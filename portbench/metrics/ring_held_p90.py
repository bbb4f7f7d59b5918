"""90th percentile of the completions held in the reorder ring (handed to
it and not yet emitted), sampled by the program at each completion's send
(ring.held), outside the profiled stretch."""
from portbench.metrics import program


def read(ctx):
    return program.p90([r.value for r in program.records(ctx)
                        if r.name == "ring.held" and not r.profiled])
