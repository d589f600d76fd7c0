import pytest

from decode_bench.harness import window


class Clock:
    """A clock that each segment advances by its own duration."""

    def __init__(self, durations):
        self.t, self.durations = 100.0, iter(durations)

    def __call__(self):
        return self.t

    def decode(self, item):
        self.t += next(self.durations)
        return [item], None


def test_window_closes_after_the_segment_that_straddles_seconds():
    c = Clock([4.0, 4.0, 9.0, 4.0, 4.0])
    w = window.closed_loop(c.decode, iter("abcde"), 10.0, clock=c)
    # 4 + 4 < 10; the third segment completes at 17 >= 10: counted whole
    assert [s[0] for s in w["segments"]] == ["a", "b", "c"]
    assert w["t_close"] - w["t_open"] == pytest.approx(17.0)
    assert window.fps(3, w["t_open"], w["t_close"]) == pytest.approx(3 / 17)


def test_window_closes_on_a_segment_ending_exactly_at_seconds():
    c = Clock([5.0, 5.0, 5.0])
    w = window.closed_loop(c.decode, iter("abc"), 10.0, clock=c)
    assert len(w["segments"]) == 2


def test_window_ends_with_the_items():
    c = Clock([1.0, 1.0])
    w = window.closed_loop(c.decode, iter("ab"), 10.0, clock=c)
    assert len(w["segments"]) == 2


def test_rate_counts_every_frame_over_the_whole_window():
    # 3 segments of 4, 4 and 16 frames in 2 + 2 + 9 s: 24 frames / 13 s
    assert window.fps(24, 0.0, 13.0) == pytest.approx(24 / 13)


def test_p95_nearest_rank():
    lat = [0.1] * 95 + [0.5] * 5
    assert window.segment_ms_p95(lat) == pytest.approx(100.0)
    lat = [0.1] * 94 + [0.5] * 6
    assert window.segment_ms_p95(lat) == pytest.approx(500.0)
    assert window.nearest_rank([3.0, 1.0, 2.0], 0.5) == 2.0
    assert window.segment_ms_p95([]) is None
    # a straddling segment is a sample like any other
    assert window.segment_ms_p95([0.2] * 19 + [9.0]) == pytest.approx(200.0)
    assert window.segment_ms_p95([0.2] * 18 + [9.0] * 2) == pytest.approx(
        9000.0)
