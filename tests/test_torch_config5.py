"""BASELINE configuration 5 (p265_tpu_torch/testgen/streams.py CONFIG5:
four 4K random-access streams) on the CPU.

- The committed streams: each matches its sha256, get_stream serves it
  from CONFIG5, its headers say 3840x2160 and 5 pictures, and the port's
  native parse alone (no reconstruction) gives decode order POC 0, 4, 2,
  1, 3, slice types I, P, B, B, B and one IRAP picture.  CONFIG5 shares
  no name with GENERATORS; data/GOLDEN_MD5 has a line for every stream,
  picture, plane and filter stage.
- The recipe: at 192x128 the port's `_gop(192, 128, 5, "RA", seed=s)`
  writes the bytes tools/make_streams._gop writes, for the four seeds.
- The schedule: on the four 4K streams' bytes, the port's
  split_irap_segments and schedule_segments give the JAX package's
  segments and work lists at 1, 2, 3 and 4 processes.
- The configuration at 192x128, end to end: the four small streams over
  2 gloo ranks through profile_shard.run_config5 (the stream axis, the
  global batch of their IRAP pictures, the space axis), every plane
  checked inside the ranks against the golden MD5s of the port's
  GoldenDecoder; one of them through TorchDecoder("cpu") against the
  JAX package's TpuDecoder and golden (np.array_equal, every plane before
  and after the loop filters).
- `slow` (not in tier-1): GoldenDecoder on each 4K stream gives
  data/GOLDEN_MD5 (5 pictures of pure-Python golden at 4K a stream).
"""
import hashlib
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import pytest

from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu_torch.pipeline.decoder import TorchDecoder
from p265_tpu_torch.testgen import streams
from tools import make_streams

NAMES = list(streams.CONFIG5)
SEEDS = (5, 6, 7, 8)
SMALL = (192, 128, 5, "RA")
TIMEOUT_S = 300


@pytest.fixture(scope="module", autouse=True)
def small():
    """Made in four spawned processes while the tests before they are
    needed run, in this order: the four 192x128 streams of the port's
    encoder, {("port", seed): Future of the bytes}; the native parse of
    each 4K stream, {("parse", name): Future of streams.decode_order};
    the reference encoder's streams, {("ref", seed): ...}.  The end-to-end
    test needs only the first and runs while the others are made."""
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(4, mp_context=ctx) as ex:
        jobs = {("port", s): ex.submit(streams._gop, *SMALL, seed=s)
                for s in SEEDS}
        jobs.update({("parse", n): ex.submit(streams.decode_order, _bytes(n))
                     for n in NAMES})
        jobs.update({("ref", s): ex.submit(make_streams._gop, *SMALL, seed=s)
                     for s in SEEDS})
        yield jobs


def _bytes(name: str) -> bytes:
    with open(os.path.join(streams.DATA, name + ".265"), "rb") as f:
        return f.read()


def test_config5_names():
    assert NAMES == [f"s4k_ra5_s{s}" for s in SEEDS]
    assert not set(NAMES) & set(streams.GENERATORS)
    assert list(streams.GENERATORS) == (list(make_streams.GENERATORS)
                                        + list(streams.PORT_ONLY))


@pytest.mark.parametrize("name", NAMES)
def test_config5_stream_committed(name):
    sums = streams.committed_sums()
    data = _bytes(name)
    assert hashlib.sha256(data).hexdigest() == sums[name + ".265"]
    assert streams.get_stream(name) == data
    assert streams.generator(name) is streams.CONFIG5[name]
    assert streams.stream_info(data) == dict(
        width=3840, height=2160, frames=5, tiles=(1, 1), wpp=False)


def test_golden_md5_file_covers_config5():
    table = streams.read_md5()
    want = {(poc, stage, c) for poc in range(5)
            for stage in streams.PLANE_STAGES for c in range(3)}
    for name in NAMES:
        assert set(table[name]) == want
        assert all(len(v) == 32 for v in table[name].values())
        assert streams.golden_md5_of(name) == table[name]
    with pytest.raises(KeyError, match="GOLDEN_MD5"):
        streams.golden_md5_of("s1080_ldp4")


def test_schedule_matches_reference():
    from p265_tpu.shard import distributed as ref
    from p265_tpu_torch.shard import distributed as port
    data = [_bytes(n) for n in NAMES]
    for d in data:
        segs = port.split_irap_segments(d)
        assert segs == ref.split_irap_segments(d) and len(segs) == 1
    for n in (1, 2, 3, 4):
        for rank in range(n):
            got = port.schedule_segments(data, n, rank)
            assert got == ref.schedule_segments(data, n, rank)
            assert [w[0] for w in got[0]] == list(range(rank, 4, n))


def test_check_md5_refuses_one_sample(small):
    from p265_tpu_torch.golden.decoder import GoldenDecoder as PortGolden
    data = small[("port", SEEDS[0])].result(timeout=TIMEOUT_S)
    frames = PortGolden().decode_stream(data)
    expected = streams.golden_md5(data)
    streams.check_md5(frames, expected, "same")
    with pytest.raises(RuntimeError, match="planes decoded"):
        streams.check_md5(frames[:-1], expected, "one picture short")
    streams.check_md5(frames[:-1], expected, "a segment", complete=False)
    frames[2].prefilter[1] = frames[2].prefilter[1].copy()
    frames[2].prefilter[1][3, 5] ^= 1
    with pytest.raises(RuntimeError, match="pre plane 1 differs"):
        streams.check_md5(frames, expected, "one sample")


def test_config5_small_end_to_end(small):
    """The configuration at 192x128 over 2 gloo ranks, and one stream
    against the JAX package's TpuDecoder, side by side."""
    from p265_tpu.pipeline.decoder import TpuDecoder
    from p265_tpu_torch.profile_shard import run_config5
    data = [small[("port", s)].result(timeout=TIMEOUT_S) for s in SEEDS]
    cases = [(f"small_s{s}", d, streams.golden_md5(d))
             for s, d in zip(SEEDS, data)]
    with ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(run_config5, 2, TIMEOUT_S, cases)
        gold = GoldenDecoder().decode_stream(data[1])
        want = TpuDecoder().decode_stream(data[1])
        got = TorchDecoder("cpu").decode_stream(data[1])
        rec = ranks.result()
    assert [f.poc for f in got] == [f.poc for f in want] == [
        g.poc for g in gold] == [0, 4, 2, 1, 3]
    for f, w, g in zip(got, want, gold):
        for c in range(3):
            assert np.array_equal(f.planes[c], np.asarray(w.planes[c]))
            assert np.array_equal(f.planes[c], g.planes[c])
            pre = f.prefilter[c].numpy()
            assert np.array_equal(pre, np.asarray(w.prefilter[c]))
            assert np.array_equal(pre, g.prefilter[c])
    assert rec["backend"] == "gloo" and rec["pictures"] == [5] * 4
    assert sorted(si for r in rec["stream"] for si, _, _ in r["segments"]) \
        == [0, 1, 2, 3]
    assert [r["streams"] for r in rec["batch"]] == [[0, 1], [2, 3]]
    for sp in rec["space"]:
        assert [p["poc"] for p in sp["pictures"]] == [0, 4, 2, 1, 3]
        assert all(p["collectives"] > 0 for p in sp["pictures"])
    assert rec["streams_per_s"] > 0 and rec["pictures_per_s"] > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_recipe_matches_make_streams(small, seed):
    got = small[("port", seed)].result(timeout=TIMEOUT_S)
    assert got == small[("ref", seed)].result(timeout=TIMEOUT_S)
    assert streams.stream_info(got) == dict(
        width=192, height=128, frames=5, tiles=(1, 1), wpp=False)


@pytest.mark.slow
@pytest.mark.parametrize("name", NAMES)
def test_golden_md5_file_is_golden(name):
    assert streams.golden_md5(_bytes(name)) == streams.read_md5()[name]


@pytest.mark.parametrize("name", NAMES)
def test_config5_stream_structure(small, name):
    """The port's native CTU parse alone: one RA mini-GOP (I, P, B, B, B
    in decode order POC 0, 4, 2, 1, 3) in one IRAP segment."""
    from p265_tpu_torch.hls import nal
    assert small[("parse", name)].result(timeout=TIMEOUT_S) == [
        (poc, kind, 3840, 2160) for poc, kind in
        ((0, 2), (4, 1), (2, 0), (1, 0), (3, 0))]
    irap = [u for u in nal.split_nal_units(_bytes(name))
            if nal.is_irap(u.nal_type) and u.rbsp[0] >> 7]
    assert len(irap) == 1
