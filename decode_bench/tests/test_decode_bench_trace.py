import types

import pytest

from decode_bench.harness import trace


def test_union_gaps_and_overlap():
    u = trace.union([(5, 7), (0, 2), (1, 3), (6, 8)])
    assert u == [(0, 3), (5, 8)]
    assert trace.gaps(u, 0, 10) == [(3, 5), (8, 10)]
    assert trace.gaps(u, -1, 4) == [(-1, 0), (3, 4)]
    assert trace.clip([(0, 3), (5, 8)], 1, 6) == [(1, 3), (5, 6)]
    assert trace.overlap([(3, 5), (8, 10)], [(4, 9)]) == pytest.approx(2)


def test_work_inside_spans_on_their_stream():
    spans = [(10, 20, 7), (30, 40, None)]
    work = [(11, 12, 7), (12, 14, 9), (19, 21, 7), (31, 33, 1)]
    # (12, 14) runs on another stream; (19, 21) leaves the span
    assert trace.in_spans(spans, work) == pytest.approx(1 + 2)


def test_install_wraps_by_name_and_undo_restores():
    mod = types.ModuleType("decode_bench_fake_mod")

    class K:
        def m(self):
            return 2
    mod.f, mod.K = (lambda x: x + 1), K
    import sys
    sys.modules[mod.__name__] = mod
    try:
        f0, m0 = mod.f, K.__dict__["m"]
        undo, found = trace.install({
            "host:f": [(mod.__name__, "f")], "host:m": [(mod.__name__, "K.m")],
            "host:gone": [(mod.__name__, "missing"), ("no_such_module", "x")]})
        assert found == ["host:f", "host:m"]
        assert mod.f is not f0 and mod.f(1) == 2 and K().m() == 2
        undo()
        assert mod.f is f0 and K.__dict__["m"] is m0
    finally:
        del sys.modules[mod.__name__]


def test_keep_stats_records_each_call():
    class Base:
        def decode_stream(self, data):
            self.stats = {"frames": len(data), "parse_s": 0.5, "name": "x"}
            return data

    class Dec(Base):
        pass
    into = []
    undo = trace.keep_stats(Dec, into)
    Dec().decode_stream([1, 2])
    undo()
    assert into == [{"frames": 2, "parse_s": 0.5}]
    assert "decode_stream" not in Dec.__dict__
