# Port copy of src/repro/streams/sources.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Synthetic stream sources (paper §7 benchmark inputs).

- web clickstreams: (ts, user, item, category, action) with zipf-ish item
  popularity and session structure (action in view/add2cart/purchase)
- store sales: (ts, store, basket, item, category, qty, price)
- call-data records (fig. 1 example): (ts, caller, callee, duration, cell)

All generators are deterministic given a seed.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Iterator


@dataclass(frozen=True)
class Click:
    ts: float
    user: int
    item: int
    category: int
    action: str  # view | add2cart | purchase


@dataclass(frozen=True)
class Sale:
    ts: float
    store: int
    basket: int
    item: int
    category: int
    qty: int
    price: float


@dataclass(frozen=True)
class CDR:
    ts: float
    caller: int
    callee: int
    duration: float
    cell: int  # tower/cell id -> location proxy
    area_code: int


def _zipf_item(rng: random.Random, n_items: int, skew: float = 1.2) -> int:
    # inverse-cdf-ish cheap zipf
    u = rng.random()
    return min(int(n_items * (u ** skew)), n_items - 1)


def clickstream(
    n: int,
    *,
    n_users: int = 500,
    n_items: int = 1000,
    n_categories: int = 24,
    seed: int = 0,
    dt_s: float = 0.05,
) -> Iterator[Click]:
    rng = random.Random(seed)
    ts = 0.0
    carts: dict[int, list[int]] = {}
    for _ in range(n):
        ts += rng.expovariate(1.0 / dt_s)
        user = rng.randrange(n_users)
        item = _zipf_item(rng, n_items)
        r = rng.random()
        if r < 0.86:
            action = "view"
        elif r < 0.95:
            action = "add2cart"
            carts.setdefault(user, []).append(item)
        else:
            action = "purchase"
        yield Click(ts, user, item, item % n_categories, action)


def store_sales(
    n: int,
    *,
    n_stores: int = 20,
    n_items: int = 500,
    n_categories: int = 10,
    basket_size: int = 4,
    seed: int = 0,
    dt_s: float = 0.02,
) -> Iterator[Sale]:
    rng = random.Random(seed)
    ts = 0.0
    basket_id = 0
    emitted = 0
    while emitted < n:
        basket_id += 1
        store = rng.randrange(n_stores)
        k = 1 + rng.randrange(basket_size)
        for _ in range(min(k, n - emitted)):
            ts += rng.expovariate(1.0 / dt_s)
            item = _zipf_item(rng, n_items)
            yield Sale(
                ts, store, basket_id, item, item % n_categories,
                1 + rng.randrange(3), round(rng.uniform(1, 100), 2),
            )
            emitted += 1


def cdr_stream(
    n: int,
    *,
    n_phones: int = 2000,
    n_cells: int = 64,
    seed: int = 0,
    dt_s: float = 0.01,
    fraud_fraction: float = 0.01,
) -> Iterator[CDR]:
    """High-mobility fraud workload: a small fraction of phones 'teleport'
    between distant cells (paper fig. 1)."""
    rng = random.Random(seed)
    ts = 0.0
    location: dict[int, int] = {}
    fraudsters = set(rng.sample(range(n_phones), max(1, int(n_phones * fraud_fraction))))
    for _ in range(n):
        ts += rng.expovariate(1.0 / dt_s)
        caller = rng.randrange(n_phones)
        prev = location.get(caller, rng.randrange(n_cells))
        if caller in fraudsters:
            cell = rng.randrange(n_cells)  # jumps anywhere
        else:
            cell = max(0, min(n_cells - 1, prev + rng.choice([-1, 0, 0, 1])))
        location[caller] = cell
        yield CDR(
            ts,
            caller,
            rng.randrange(n_phones),
            rng.uniform(5, 600),
            cell,
            408 if rng.random() < 0.7 else 650,
        )
