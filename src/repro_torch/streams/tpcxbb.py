# Port copy of src/repro/streams/tpcxbb.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""TPCx-BB streaming queries Q1-Q4, Q15 (paper §7 table 1) as pipelines.

Pipeline structures follow table 1 exactly (SL = stateless, PS = partitioned
stateful, SF = stateful):
  Q1 : SS -> SL -> PS -> PS -> SF   items sold together hourly top-100
  Q2 : WC -> SL -> PS -> SL -> PS -> SF  viewed-together (60-min sessions)
  Q3 : WC -> SL -> PS -> PS         last-5 views before purchase (10 days)
  Q4 : WC -> SL -> PS -> SL -> SF   cart abandonment: avg pages per session
  Q15: SS -> SL -> SL -> PS         categories w/ flat or declining sales

Each builder returns (specs, source_iterator). Specs carry per-op cost/
selectivity priors used by the scheduler and the discrete-event simulator.

DAG forms (``q1_dag``/``q4_dag``/``q15_dag``, registry ``DAG_QUERIES``)
restructure a query's partitioned hot spot as a genuine dataflow DAG:
a keyed ``Split`` fans tuples across B parallel copies of the partitioned
operator (same key routes to the same branch, so per-key state is preserved)
and a ``Merge`` re-interleaves the branch outputs in split-ingress order —
egress is identical to the linear form, but the hot operator's exposed
parallelism is B-fold. Builders return (nodes, edges, source_iterator) for
:class:`repro_torch.core.GraphPipeline`.
"""
from __future__ import annotations

import itertools
from typing import Iterable

from repro_torch.core import Merge, OpSpec, Split

from . import sources

SESSION_TIMEOUT = 3600.0  # 60 min
HOUR = 3600.0


# ----------------------------------------------------------------------- Q1
def q1(n: int = 20000, seed: int = 0):
    def project(sale):  # SL
        return [(sale.store, sale.basket, sale.item, sale.ts)]

    def basket_pairs(state, key, t):  # PS by basket
        store, basket, item, ts = t
        items = state or []
        outs = [((min(item, i2), max(item, i2)), ts) for i2 in items if i2 != item]
        return items + [item], outs

    def pair_count(state, key, t):  # PS by pair
        pair, ts = t
        c = (state or 0) + 1
        return c, [(pair, c, ts)]

    def hourly_top100(state, t):  # SF
        pair, c, ts = t
        top, hour = state if state else ({}, 0)
        top[pair] = c
        out = []
        if ts // HOUR > hour:
            hour = ts // HOUR
            ranked = sorted(top.items(), key=lambda kv: -kv[1])[:100]
            out = [("top100", hour, ranked)]
        return (top, hour), out

    specs = [
        OpSpec("project", "stateless", project, cost_us=4, selectivity=1.0),
        OpSpec(
            "basket_pairs", "partitioned", basket_pairs,
            key_fn=lambda t: t[1], num_partitions=64,
            init_state=lambda: None, cost_us=6, selectivity=1.2,
        ),
        OpSpec(
            "pair_count", "partitioned", pair_count,
            key_fn=lambda t: t[0], num_partitions=128,
            init_state=lambda: 0, cost_us=5, selectivity=1.0,
        ),
        OpSpec("hourly_top100", "stateful", hourly_top100, init_state=lambda: None,
               cost_us=8, selectivity=0.01),
    ]
    return specs, sources.store_sales(n, seed=seed, dt_s=6.0)  # ~hours span


# ----------------------------------------------------------------------- Q2
def q2(n: int = 20000, seed: int = 0):
    def views(c):  # SL: keep views only
        return [(c.user, c.item, c.ts)] if c.action == "view" else []

    def sessionize(state, key, t):  # PS by user: emit co-viewed pairs per session
        user, item, ts = t
        sess = state or {"items": [], "last": ts}
        outs = []
        if ts - sess["last"] > SESSION_TIMEOUT and sess["items"]:
            items = sorted(set(sess["items"]))
            outs = [(a, b) for i, a in enumerate(items) for b in items[i + 1 :]]
            sess = {"items": [], "last": ts}
        sess["items"].append(item)
        sess["last"] = ts
        return sess, outs

    def norm_pair(p):  # SL
        return [p]

    def pair_count(state, key, p):  # PS by pair
        c = (state or 0) + 1
        return c, [(p, c)]

    def top30(state, t):  # SF
        pair, c = t
        top, n_in = state if state else ({}, 0)
        top[pair] = c
        n_in += 1
        ranked = sorted(top.items(), key=lambda kv: -kv[1])[:30]
        return (top, n_in), [ranked] if n_in % 50 == 0 else []

    specs = [
        OpSpec("views", "stateless", views, cost_us=3, selectivity=0.86),
        OpSpec(
            "sessionize", "partitioned", sessionize,
            key_fn=lambda t: t[0], num_partitions=128,
            init_state=lambda: None, cost_us=8, selectivity=0.6,
        ),
        OpSpec("norm_pair", "stateless", norm_pair, cost_us=2, selectivity=1.0),
        OpSpec(
            "pair_count", "partitioned", pair_count,
            key_fn=lambda p: p, num_partitions=128,
            init_state=lambda: 0, cost_us=5, selectivity=1.0,
        ),
        OpSpec("top30", "stateful", top30, init_state=lambda: None,
               cost_us=10, selectivity=0.02),
    ]
    return specs, sources.clickstream(n, seed=seed, dt_s=4.0)  # sessions can time out


# ----------------------------------------------------------------------- Q3
def q3(n: int = 20000, seed: int = 0):
    TEN_DAYS = 10 * 24 * 3600.0

    def project(c):  # SL
        return [(c.user, c.item, c.action, c.ts)]

    def last5_before_purchase(state, key, t):  # PS by user
        user, item, action, ts = t
        hist = [(i, s) for (i, s) in (state or []) if ts - s < TEN_DAYS][-5:]
        outs = []
        if action == "purchase":
            outs = [(item, viewed) for (viewed, _) in hist]
        elif action == "view":
            hist = hist + [(item, ts)]
        return hist, outs

    def view_count(state, key, t):  # PS by viewed item
        purchased, viewed = t
        c = (state or 0) + 1
        return c, [(viewed, c)]

    specs = [
        OpSpec("project", "stateless", project, cost_us=3, selectivity=1.0),
        OpSpec(
            "last5", "partitioned", last5_before_purchase,
            key_fn=lambda t: t[0], num_partitions=128,
            init_state=lambda: None, cost_us=7, selectivity=0.3,
        ),
        OpSpec(
            "view_count", "partitioned", view_count,
            key_fn=lambda t: t[1], num_partitions=128,
            init_state=lambda: 0, cost_us=4, selectivity=1.0,
        ),
    ]
    return specs, sources.clickstream(n, seed=seed)


# ----------------------------------------------------------------------- Q4
def q4(n: int = 20000, seed: int = 0):
    def project(c):  # SL
        return [(c.user, c.action, c.ts)]

    def abandoned_sessions(state, key, t):  # PS by user
        user, action, ts = t
        sess = state or {"pages": 0, "cart": False, "bought": False, "last": ts}
        outs = []
        if ts - sess["last"] > SESSION_TIMEOUT and sess["pages"]:
            if sess["cart"] and not sess["bought"]:
                outs = [(user, sess["pages"])]
            sess = {"pages": 0, "cart": False, "bought": False, "last": ts}
        sess["pages"] += 1
        sess["cart"] |= action == "add2cart"
        sess["bought"] |= action == "purchase"
        sess["last"] = ts
        return sess, outs

    def pages(t):  # SL
        return [t[1]]

    def running_avg(state, pages_n):  # SF
        total, count = state if state else (0, 0)
        total, count = total + pages_n, count + 1
        return (total, count), [total / count]

    specs = [
        OpSpec("project", "stateless", project, cost_us=3, selectivity=1.0),
        OpSpec(
            "abandoned", "partitioned", abandoned_sessions,
            key_fn=lambda t: t[0], num_partitions=128,
            init_state=lambda: None, cost_us=7, selectivity=0.05,
        ),
        OpSpec("pages", "stateless", pages, cost_us=2, selectivity=1.0),
        OpSpec("running_avg", "stateful", running_avg, init_state=lambda: None,
               cost_us=3, selectivity=1.0),
    ]
    return specs, sources.clickstream(n, seed=seed, dt_s=4.0)


# ----------------------------------------------------------------------- Q15
def q15(n: int = 20000, seed: int = 0):
    WEEK = 7 * 24 * 3600.0

    def in_store(s):  # SL: filter to interesting stores
        return [s] if s.store < 10 else []

    def project(s):  # SL
        return [(s.category, s.ts // WEEK, s.qty * s.price)]

    def slope(state, key, t):  # PS by category: regression over weekly sums
        cat, week, amount = t
        weeks = state or {}
        weeks[week] = weeks.get(week, 0.0) + amount
        out = []
        if len(weeks) >= 3:
            xs = sorted(weeks)
            ys = [weeks[x] for x in xs]
            n_ = len(xs)
            mx = sum(xs) / n_
            my = sum(ys) / n_
            denom = sum((x - mx) ** 2 for x in xs) or 1.0
            b = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / denom
            if b <= 0:
                out = [(cat, b)]
        return weeks, out

    specs = [
        OpSpec("in_store", "stateless", in_store, cost_us=2, selectivity=0.5),
        OpSpec("project", "stateless", project, cost_us=3, selectivity=1.0),
        OpSpec(
            "slope", "partitioned", slope,
            key_fn=lambda t: t[0], num_partitions=10,  # 10 categories (paper)
            init_state=lambda: None, cost_us=9, selectivity=0.4,
        ),
    ]
    return specs, sources.store_sales(n, seed=seed, dt_s=400.0)  # spans weeks


QUERIES = {"q1": q1, "q2": q2, "q3": q3, "q4": q4, "q15": q15}


def run_query(
    name: str,
    n: int = 20000,
    *,
    seed: int = 0,
    backend: str = "thread",
    num_workers=4,  # int, or "auto" for cost-model worker allocation
    batch_size: int = 1,
    heuristic: str = "ct",
    cost_priors=None,
    **kw,
):
    """One-shot runner with backend plumb-through: compile query ``name`` and
    run it on the chosen execution backend.  ``thread`` honors ``heuristic``
    and ``batch_size``; ``process`` cuts the query into staged process worker
    groups at its partitioned/stateful boundaries (e.g. Q1's SL|PS|PS|SF
    becomes four stages) — pass ``stages=1`` via ``**kw`` for the ingress-only
    plan, ``io_batch``/``max_inflight`` for exchange tuning.

    ``num_workers="auto"`` sizes each stage's worker group from the query's
    declared per-op cost/selectivity priors (table 1 carries them on every
    ``OpSpec``) via :mod:`repro_torch.core.costmodel` — the skew-aware allocation
    a hot ``sessionize``/``basket_pairs`` stage wants; ``cost_priors=``
    ``{op name: cost_us}`` overrides the declared numbers.

    Runs natively on the :class:`repro_torch.core.Engine` surface (``**kw`` is
    parsed strictly by :meth:`repro_torch.core.EngineConfig.from_kwargs`, so typos
    raise :class:`repro_torch.core.ConfigError`); returns ``(handle, RunReport)``
    where ``handle`` exposes the uniform result surface (``outputs``,
    ``egress_count``, ``markers``) plus backend introspection pass-through.
    For plan inspection without running, build the engine yourself::

        engine = Engine(EngineConfig.from_kwargs(backend="process",
                                                 num_workers="auto"))
        print(engine.plan(QUERIES["q2"](n=1)[0]).explain())
    """
    from repro_torch.core import Engine, EngineConfig

    specs, src = QUERIES[name](n=n, seed=seed)
    engine = Engine(EngineConfig.from_kwargs(
        backend=backend,
        num_workers=num_workers,
        batch_size=batch_size,
        heuristic=heuristic,
        cost_priors=cost_priors,
        **kw,
    ))
    result = engine.run(specs, src)
    return result.handle(), result.report


# ------------------------------------------------------------------ DAG forms
def q1_dag(n: int = 20000, seed: int = 0, branches: int = 2):
    """Q1 as a DAG: the basket_pairs hot spot runs on ``branches`` parallel
    keyed branches (split by basket -> per-key state stays consistent)."""
    specs, src = q1(n=n, seed=seed)
    project, basket_pairs, pair_count, hourly_top100 = specs
    nodes = {"project": project, "split": Split("keyed", key_fn=lambda t: t[1])}
    edges = [("project", "split")]
    for b in range(branches):
        nodes[f"pairs{b}"] = basket_pairs
        edges += [("split", f"pairs{b}"), (f"pairs{b}", "merge")]
    nodes["merge"] = Merge()
    nodes["pair_count"] = pair_count
    nodes["top100"] = hourly_top100
    edges += [("merge", "pair_count"), ("pair_count", "top100")]
    return nodes, edges, src


def q4_dag(n: int = 20000, seed: int = 0, branches: int = 2):
    """Q4 as a DAG: whole sessionize->pages sub-chains run per branch (split
    keyed by user), merged back in arrival order before the running average."""
    specs, src = q4(n=n, seed=seed)
    project, abandoned, pages, running_avg = specs
    nodes = {"project": project, "split": Split("keyed", key_fn=lambda t: t[0])}
    edges = [("project", "split")]
    for b in range(branches):
        nodes[f"abandoned{b}"] = abandoned
        nodes[f"pages{b}"] = pages
        edges += [
            ("split", f"abandoned{b}"),
            (f"abandoned{b}", f"pages{b}"),
            (f"pages{b}", "merge"),
        ]
    nodes["merge"] = Merge()
    nodes["avg"] = running_avg
    edges += [("merge", "avg")]
    return nodes, edges, src


def q15_dag(n: int = 20000, seed: int = 0, branches: int = 2):
    """Q15 as a DAG: regression slopes computed on parallel keyed branches;
    the merge is the egress node (ordered fan-in straight to the collector)."""
    specs, src = q15(n=n, seed=seed)
    in_store, project, slope = specs
    nodes = {
        "in_store": in_store,
        "project": project,
        "split": Split("keyed", key_fn=lambda t: t[0]),
        "merge": Merge(),
    }
    edges = [("in_store", "project"), ("project", "split")]
    for b in range(branches):
        nodes[f"slope{b}"] = slope
        edges += [("split", f"slope{b}"), (f"slope{b}", "merge")]
    return nodes, edges, src


DAG_QUERIES = {"q1": q1_dag, "q4": q4_dag, "q15": q15_dag}


def sim_ops(query: str):
    """SimOp list mirroring a query's cost/selectivity profile (fig. 8 sims)."""
    from repro_torch.core.simulate import SimOp

    specs, _src = QUERIES[query](n=1)
    out = []
    for s in specs:
        out.append(
            SimOp(
                name=s.name,
                kind=s.kind,
                cost_us=s.cost_us,
                selectivity=s.selectivity,
                num_partitions=s.num_partitions,
            )
        )
    return out
