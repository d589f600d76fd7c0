"""The one generator of segment sequences, driven by a traffic file
(traffic/<name>.json):

- `pool`: {item: count}, the multiset of one cycle (items: streams.py);
- `order`: "permutation_repeated" (the seed draws one permutation of the
  multiset, repeated cycle after cycle) or "permutation_per_cycle" (a new
  permutation each cycle, every one drawn from the seed);
- `cycles`: the length of a finite list (the stream axis deals a list);
  a closed loop on one process draws as long as the window lasts;
- `warm`: the items decoded in set-up, on every process.

The same seed gives the same sequence; every seed gives every cycle the
same multiset, in another order.
"""
from __future__ import annotations

import itertools

import numpy as np

ORDERS = ("permutation_repeated", "permutation_per_cycle")


def rng(seed: int) -> np.random.Generator:
    """A generator for any whole seed (negative or past 64 bits too)."""
    return np.random.default_rng(int(seed) % (1 << 64))


def multiset(traffic: dict) -> list:
    """The items of one cycle, in the file's order."""
    return [item for item, n in traffic["pool"].items() for _ in range(n)]


def sequence(traffic: dict, seed: int):
    """An endless iterator of the items of `traffic` drawn from `seed`."""
    order = traffic["order"]
    if order not in ORDERS:
        raise ValueError(f"traffic: unknown order {order!r} ({ORDERS})")
    items, g = multiset(traffic), rng(seed)
    if order == "permutation_repeated":
        perm = [items[i] for i in g.permutation(len(items))]
        return itertools.cycle(perm)
    return itertools.chain.from_iterable(
        [items[i] for i in g.permutation(len(items))]
        for _ in itertools.count())


def segment_list(traffic: dict, seed: int) -> list:
    """The first `cycles` cycles of the sequence, as a list."""
    n = traffic["cycles"] * len(multiset(traffic))
    return list(itertools.islice(sequence(traffic, seed), n))
