"""The frozen work arithmetic against the program's roofline.py."""
import pytest

from decode_bench.harness import streams, work


@pytest.mark.parametrize("item", ["s96x64_ldp5", "s96x64_ra5",
                                  "s96x64_ldp5.idr"])
def test_frozen_work_equals_the_programs(item):
    from p265_tpu_torch import roofline
    pictures = roofline.census(streams.segment_bytes(item))
    mine, theirs = work.work(pictures), roofline.work(pictures)
    for kind in ("stages", "kernels"):
        assert set(mine[kind]) == set(theirs[kind])
        for k, w in mine[kind].items():
            t = theirs[kind][k]
            assert (w.bytes, w.ops, w.link, w.fp32) == (t.bytes, t.ops, t.link,
                                                        t.fp32)
            card = "NVIDIA H100 80GB HBM3"
            assert work.bound_ms(w, work.peaks(card)) == pytest.approx(
                roofline.bound(t, card)[0], rel=1e-12)
    # the committed file holds the same sums
    frozen = work.load(item)
    for kind in ("stages", "kernels"):
        assert frozen[kind] == mine[kind]


def test_peaks_equal_the_programs_and_unknown_cards_have_none():
    from p265_tpu_torch.roofline import PEAKS
    for card, p in PEAKS.items():
        mine = work.peaks(card)
        assert {k: mine[k] for k in p} == pytest.approx(p)
    assert work.peaks("some other card") is None
    assert work.load("no_such_item") is None
