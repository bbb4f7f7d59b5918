"""Share of the completions sent to the reorder ring that its window could
not take yet and parked, outside the profiled stretch: a send parked where
the program's ring.parked sample (the completions parked after it) rose
from the send before."""
from portbench.metrics import program


def read(ctx):
    parked = [r.value for r in program.records(ctx)
              if r.name == "ring.parked" and not r.profiled]
    if len(parked) < 2:
        return None
    return 100.0 * sum(b > a for a, b in zip(parked, parked[1:])) / (len(parked) - 1)
