# Port copy of src/repro/core/scheduler.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Dynamic scheduling heuristics (paper §6), generalized to DAG dataflow.

The central scheduler answers: which operator next, and how many tuples
(= constant time slice s / per-tuple cost c_i). Heuristics:

- QST (§6.1): queue-size throttling — earliest operator whose *output* queues
  are below its selectivity-scaled threshold T_i = C·cs_i / Σ cs_j.
- LP  (§6.2): last-in-pipeline — latest (topologically) schedulable operator.
- ET  (§6.3): estimated worklist completion time p_i = I_i·c_i/(w_i+1), max wins.
- CT  (§6.4): normalized current-window throughput n_i = (T_i^w + w_i·s)/(c_i·cs_i),
  min wins (the bottleneck operator).
- ADAPTIVE: CT's pick, plus a periodic controller (:meth:`Scheduler.adapt`)
  that re-estimates per-operator cost/selectivity, recomputes each node's
  share of total load, and resizes the effective parallelism cap M_i
  (``node.dop_cap``) — the paper's dynamic mapping of exposed parallelism
  onto machine parallelism (§2/§6).

Topology awareness: the pipeline hands the scheduler weighted op-to-op edges
``(u, v, w)`` (routing nodes collapsed; a B-way split contributes w=1/B).
``cs_i`` becomes the *flow rate* out of operator i per source tuple, computed
by propagating estimated selectivities through the graph — for a linear chain
this reduces exactly to the cumulative-selectivity product of the paper.

All heuristics consider only *schedulable* operators: w_i < M_i and non-empty
worklist.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .costmodel import op_cost_us
from .operators import OperatorNode

HEURISTICS = ("qst", "lp", "et", "ct", "adaptive")


class Scheduler:
    """Central scheduler data structure (paper §2.2/§6)."""

    def __init__(
        self,
        nodes: List[OperatorNode],
        heuristic: str = "ct",
        *,
        time_slice: float = 0.002,  # s, the constant slice (paper §6)
        capacity: int = 4096,  # C for QST
        window: float = 0.05,  # w for CT
        edges: Optional[Sequence[Tuple[int, int, float]]] = None,
        num_workers: int = 4,  # machine parallelism (adaptive controller)
        adapt_interval: float = 0.02,  # s between controller re-estimations
        cost_priors: Optional[Dict[str, float]] = None,  # {op name: cost_us}
    ):
        if heuristic not in HEURISTICS:
            raise ValueError(f"unknown heuristic {heuristic!r}; pick from {HEURISTICS}")
        self.nodes = nodes
        self.heuristic = heuristic
        self.time_slice = time_slice
        self.capacity = capacity
        self.window = window
        self.num_workers = num_workers
        self.adapt_interval = adapt_interval
        # Explicit cost priors override each spec's declared cost_us until
        # live estimates warm up — the same override surface the process
        # backend's allocator uses (costmodel.op_cost_us).
        self.cost_priors = dict(cost_priors) if cost_priors else None
        self.adaptations = 0  # controller invocations (instrumentation)
        self._lock = threading.Lock()
        self._window_start = time.perf_counter()  # guarded-by: self._lock
        # Weighted op->op edges; default: linear chain with unit weights.
        if edges is None:
            edges = [(i, i + 1, 1.0) for i in range(len(nodes) - 1)]
        self._edges = list(edges)
        self._out: list[list[tuple[int, float]]] = [[] for _ in nodes]
        has_in = [False] * len(nodes)
        self._ingress_flow = [0.0] * len(nodes)
        for u, v, w in self._edges:
            if u < 0:  # ingress fraction edge (source is a routing node)
                self._ingress_flow[v] += w
                has_in[v] = True
            else:
                self._out[u].append((v, w))
                has_in[v] = True
        for i, seen in enumerate(has_in):
            if not seen:
                self._ingress_flow[i] = 1.0

    # ------------------------------------------------------------------ utils
    def _cost(self, i: int) -> float:
        n = self.nodes[i]
        prior = op_cost_us(n.spec, self.cost_priors) * 1e-6
        return max(n.stats.cost(prior), 1e-9)

    def _selectivity(self, i: int) -> float:
        n = self.nodes[i]
        return n.stats.selectivity(n.spec.selectivity)

    def _flows(self) -> tuple[list[float], list[float]]:
        """(in_rate, out_rate) per op, per source tuple, via the weighted DAG.

        Node indices are in topological order, so a single ascending pass
        propagates flow correctly.
        """
        in_rate = list(self._ingress_flow)
        out_rate = [0.0] * len(self.nodes)
        for i in range(len(self.nodes)):
            out_rate[i] = max(in_rate[i] * self._selectivity(i), 1e-9)
            for v, w in self._out[i]:
                in_rate[v] += out_rate[i] * w
        return in_rate, out_rate

    def _budget(self, i: int) -> int:
        return max(1, int(self.time_slice / self._cost(i)))

    def _schedulable(self) -> list[int]:
        return [i for i, n in enumerate(self.nodes) if n.schedulable()]

    def idle_hint(self) -> bool:
        """True when the graph looks drained: every worklist is empty and no
        worker is mid-tuple.  Lets idle workers park (sleep at the backoff
        cap) instead of hot-spinning ``acquire()`` — new work always arrives
        via a push, which refills a worklist before the next poll."""
        return all(
            n.worklist_size() == 0 and n.workers.load() == 0 for n in self.nodes
        )

    def snapshot(self) -> List[dict]:
        """Live per-operator scheduling state, one dict per node: name,
        queued work, allotted workers, effective parallelism cap, and the
        current cost/selectivity estimates.  The introspection feed behind
        :meth:`.api.Session.stats` on the thread backend."""
        out = []
        for i, n in enumerate(self.nodes):
            out.append({
                "op": n.spec.name,
                "kind": n.spec.kind,
                "worklist": n.worklist_size(),
                "workers": n.workers.load(),
                "dop_cap": min(n.dop_cap, n.max_dop),
                "cost_us": self._cost(i) * 1e6,
                "selectivity": self._selectivity(i),
            })
        return out

    # ---------------------------------------------------------------- acquire
    def acquire(self) -> Optional[Tuple[OperatorNode, int]]:
        """Pick (node, tuple budget) for a worker, or None if nothing to do."""
        with self._lock:
            idx = self._pick()
            if idx is None:
                return None
            node = self.nodes[idx]
            node.workers.fetch_add(1)
            return node, self._budget(idx)

    def release(self, node: OperatorNode) -> None:
        """Return a worker's allotment after its :meth:`acquire` time slice."""
        node.workers.fetch_sub(1)

    # ------------------------------------------------------------- controller
    def adapt(self) -> None:
        """One adaptive-controller step: re-estimate cost/selectivity, then
        resize each operator's effective parallelism cap M_i proportionally to
        its share of total load (in_rate_i · c_i), bounded by its max DOP.

        A ``dop_cap`` is a *cap*, not a reservation: idle operators consume
        no workers, so caps may sum past ``num_workers`` and a hot operator
        must stay able to absorb every idle worker — which is why this uses
        ceil-of-share rather than the process backend's hard-partitioning
        :func:`~.costmodel.proportional_allocation` (there a stage width
        reserves forked processes).  The two backends do share one *cost*
        surface: :func:`~.costmodel.op_cost_us` folds ``cost_priors``
        overrides into the declared priors on both paths.  Estimates refresh
        implicitly: :meth:`OpStats.cost`/``selectivity`` fold in measured
        busy time and tuple counts once warmed up.
        """
        in_rate, _ = self._flows()
        loads = [in_rate[i] * self._cost(i) for i in range(len(self.nodes))]
        total = sum(loads) or 1.0
        for i, node in enumerate(self.nodes):
            share = loads[i] / total
            cap = max(1, math.ceil(self.num_workers * share))
            node.dop_cap = min(cap, node.max_dop)
        self.adaptations += 1

    # ----------------------------------------------------------------- picks
    def _pick(self) -> Optional[int]:  # holds: self._lock
        cand = self._schedulable()
        if not cand:
            return None
        if self.heuristic == "lp":
            return cand[-1]
        if self.heuristic == "qst":
            return self._pick_qst(cand)
        if self.heuristic == "et":
            return self._pick_et(cand)
        return self._pick_ct(cand)  # ct + adaptive

    def _pick_qst(self, cand: list[int]) -> Optional[int]:  # holds: self._lock
        _, out_rate = self._flows()
        total = sum(out_rate)
        for i in cand:
            succ = self._out[i]
            if not succ:
                return i  # egress operator: output is unbounded
            threshold = max(self.capacity * out_rate[i] / total, 1.0)
            if all(self.nodes[v].worklist_size() < threshold for v, _ in succ):
                return i
        return cand[0]  # all throttled: fall back to earliest (keeps progress)

    def _pick_et(self, cand: list[int]) -> int:  # holds: self._lock
        best, best_p = cand[0], -1.0
        for i in cand:
            n = self.nodes[i]
            p = n.worklist_size() * self._cost(i) / (n.workers.load() + 1)
            if p > best_p:
                best, best_p = i, p
        return best

    def _pick_ct(self, cand: list[int]) -> int:  # holds: self._lock
        now = time.perf_counter()
        if now - self._window_start > self.window:
            for n in self.nodes:
                n.stats.window_busy = 0.0
            self._window_start = now
        _, out_rate = self._flows()
        best, best_n = cand[0], float("inf")
        for i in cand:
            n = self.nodes[i]
            eff = (n.stats.window_busy + n.workers.load() * self.time_slice) / (
                self._cost(i) * out_rate[i]
            )
            if eff < best_n:
                best, best_n = i, eff
        return best
