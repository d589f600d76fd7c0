import itertools
from collections import Counter

import pytest

from decode_bench.harness import spec, traffic as tf

POOL = {"a": 4, "b": 1}


@pytest.mark.parametrize("order", tf.ORDERS)
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 12345, 2**40 + 3, -5])
def test_sequence_is_deterministic_and_draws_the_multiset(order, seed):
    t = dict(pool=POOL, order=order)
    first = list(itertools.islice(tf.sequence(t, seed), 50))
    again = list(itertools.islice(tf.sequence(t, seed), 50))
    assert first == again
    for k in range(10):      # every cycle is the pool's multiset
        assert Counter(first[5 * k:5 * k + 5]) == Counter(POOL)


def test_repeated_order_repeats_one_permutation_and_seeds_differ():
    t = dict(pool={"a": 1, "b": 1, "c": 1, "d": 1, "e": 1},
             order="permutation_repeated")
    seqs = {s: list(itertools.islice(tf.sequence(t, s), 15))
            for s in range(8)}
    for s in seqs.values():
        assert s[:5] == s[5:10] == s[10:]
    assert len({tuple(s[:5]) for s in seqs.values()}) > 1


def test_per_cycle_order_draws_new_permutations():
    t = dict(pool={"a": 1, "b": 1, "c": 1, "d": 1}, order="permutation_per_cycle",
             cycles=16)
    lst = tf.segment_list(t, 11)
    assert len(lst) == 64
    cycles = {tuple(lst[4 * k:4 * k + 4]) for k in range(16)}
    assert len(cycles) > 1
    assert lst == tf.segment_list(t, 11)


def test_unknown_order_raises():
    with pytest.raises(ValueError):
        tf.sequence(dict(pool=POOL, order="random"), 1)


@pytest.mark.parametrize("name", ["ldp_segments"])
def test_committed_mixes_draw_from_their_pools(name):
    t = spec.traffic(name)
    seq = list(itertools.islice(tf.sequence(t, 99), 3 * len(tf.multiset(t))))
    assert set(seq) == set(t["pool"])
    assert set(t["warm"]) <= set(t["pool"])
