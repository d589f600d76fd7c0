"""The host spans of the port's decoders (p265_tpu_torch/spans.py) on CPU
tensors: the stats each decoder keeps (wall and thread CPU seconds of the
motion replay, the tensor plan, the MC pack and its reference stacking,
the batch pack, the upload, the dispatch and the fetch; each picture's wait
for the recon worker), the counters of what B pictures add (bi-predicted
PUs, TMVP pictures, MC blocks, stacked references, the pictures packed
from the motion replay's PU table) on the CTC's random
access, the `p265:` profiler ranges on the thread that runs each stage and
none with the profiler off, an incomplete picture's error, and the
benchmark's readers of those stats.
"""
import functools
import itertools
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from decode_bench.harness import spec
from p265_tpu_torch import spans
from p265_tpu_torch.golden.decoder import GoldenDecoder
from p265_tpu_torch.hls import nal
from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
from p265_tpu_torch.kernels.mc import (CHROMA_BUCKETS, LUMA_BUCKETS,
                                       mc_block_counts, tile_pu)
from p265_tpu_torch.pipeline.decoder import COUNTERS, SPANS, TorchDecoder
from p265_tpu_torch.testgen.conformance import _gop
from p265_tpu_torch.testgen.ctc import ra_ctc_schedule
from p265_tpu_torch.testgen.streams import _intra, get_stream

DECODERS = {"serial": TorchDecoder, "pipelined": PipelinedTorchDecoder}
STREAM = "s96x64_ldp5"


@functools.lru_cache(maxsize=None)
def _golden():
    return GoldenDecoder().decode_stream(get_stream(STREAM))


@functools.lru_cache(maxsize=None)
def _decoded(kind):
    dec = DECODERS[kind]("cpu")
    return dec, dec.decode_stream(get_stream(STREAM))


@pytest.mark.parametrize("kind", DECODERS)
def test_motion_replay_is_timed(kind):
    dec, frames = _decoded(kind)
    assert any(f.plan.pus for f in frames)      # P pictures: a replay
    assert dec.stats["finalize_s"] > 0
    assert dec.stats["tensor_plan_s"] > 0 and dec.stats["mc_pack_s"] > 0


@pytest.mark.parametrize("kind", DECODERS)
def test_cpu_seconds_within_wall(kind):
    st = _decoded(kind)[0].stats
    for name in SPANS:
        assert 0 <= st[name + "_cpu_s"] <= st[name + "_s"], name


@pytest.mark.parametrize("kind", DECODERS)
def test_recon_parts_within_recon(kind):
    st = _decoded(kind)[0].stats
    parts = sum(st[k + "_s"] for k in ("mc_pack", "pack", "upload",
                                        "dispatch"))
    assert 0 < parts <= st["recon_s"]


@pytest.mark.parametrize("kind", DECODERS)
def test_queue_wait(kind):
    st = _decoded(kind)[0].stats
    assert st["queue_wait_s"] >= 0
    if kind == "serial":
        assert st["queue_wait_s"] == 0


@pytest.mark.parametrize("kind", DECODERS)
def test_planes_unchanged(kind):
    frames, gold = _decoded(kind)[1], _golden()
    assert [f.poc for f in frames] == [g.poc for g in gold]
    for f, g in zip(frames, gold):
        for c in range(3):
            assert np.array_equal(f.planes[c], g.planes[c]), (f.poc, c)


@pytest.mark.parametrize("kind", DECODERS)
def test_ranges_on_the_stage_threads(kind):
    """Under a profiler of every thread, each stage's `p265:` range is on
    the thread that runs it: the replay and the tensor plan on the
    caller's, the packs on the recon worker's (the caller's when serial)."""
    dec = DECODERS[kind]("cpu")
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        dec.decode_stream(get_stream(STREAM))
    threads = {}
    for e in prof.events():
        if e.name.startswith(spans.PREFIX):
            threads.setdefault(e.name[len(spans.PREFIX):], set()).add(
                e.thread)
    for name in ("finalize", "tensor_plan", "mc_pack", "ref_stack", "pack",
                 "upload", "dispatch", "fetch"):
        assert len(threads.get(name, ())) == 1, (name, threads)
    parse, recon = threads["finalize"], threads["mc_pack"]
    assert threads["tensor_plan"] == parse
    assert threads["pack"] == threads["dispatch"] == threads[
        "ref_stack"] == recon
    assert (parse == recon) == (kind == "serial")


def test_no_range_without_a_profiler(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    assert not spans.profiling()
    dec = PipelinedTorchDecoder("cpu")
    dec.decode_stream(get_stream(STREAM))
    assert dec.stats["finalize_s"] > 0 and entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span(None, "probe"):
            pass
    assert entered == [spans.PREFIX + "probe"]


def test_span_parts_wall_from_cpu():
    st = {}
    with spans.span(st, "sleep"):
        time.sleep(0.05)
    with spans.span(st, "busy"):
        t0 = time.thread_time()
        while time.thread_time() - t0 < 0.02:
            pass
    assert st["sleep_s"] >= 0.05 and st["sleep_cpu_s"] < 0.5 * st["sleep_s"]
    assert 0.02 <= st["busy_cpu_s"] <= st["busy_s"]
    with spans.span(None, "nothing"):   # no stats: nothing kept
        pass


def test_span_keys_of_one_thread_each(monkeypatch):
    """Threads that each time their own key of one shared dict lose no
    update, with the interpreter switching threads as often as it can:
    every span reads exactly one tick of a per-thread clock."""
    local = threading.local()

    def tick():
        local.n = getattr(local, "n", 0) + 1
        return float(local.n)

    class Clock:
        perf_counter = thread_time = staticmethod(tick)

    monkeypatch.setattr(spans, "time", Clock)
    st, n_threads, reps = {}, 16, 2000
    for k in range(n_threads):
        st[f"t{k}_s"] = st[f"t{k}_cpu_s"] = 0.0

    def run(k):
        for _ in range(reps):
            with spans.span(st, f"t{k}"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=run, args=(k,))
              for k in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    # each span reads the clock twice for its CPU and twice for its wall
    # interval: the CPU interval is one tick, the wall interval three
    for k in range(n_threads):
        assert st[f"t{k}_cpu_s"] == reps and st[f"t{k}_s"] == 3 * reps


@functools.lru_cache(maxsize=None)
def _two_slice_gop():
    return _gop("LDP", 3, 31, qp=33, w=128, h=128, num_slices=2,
                sign_data_hiding=True)


def _drop_second_slice_of(stream: bytes, pic: int) -> bytes:
    units = nal.split_nal_units(stream)
    idx = [i for i, u in enumerate(units) if nal.is_slice_nal(u.nal_type)]
    drop = idx[2 * pic + 1]
    return b"".join(nal.make_nal(u.nal_type, u.rbsp)
                    for i, u in enumerate(units) if i != drop)


def _error(dec, data):
    with pytest.raises(ValueError) as e:
        dec.decode_stream(data)
    return str(e.value)


@pytest.mark.parametrize("kind", DECODERS)
def test_incomplete_picture_raises_as_before(kind):
    """A P picture that lost its second slice: the same ValueError as
    DecoderBase raises for golden; under error_resilient the same
    pictures and errors as golden."""
    data = _drop_second_slice_of(_two_slice_gop(), 1)
    dec = DECODERS[kind]("cpu")
    want = _error(GoldenDecoder(), data)
    assert "picture incomplete" in want
    assert _error(dec, data) == want
    assert dec._pic is None
    got = DECODERS[kind]("cpu", error_resilient=True)
    gold = GoldenDecoder(error_resilient=True)
    frames, gframes = got.decode_stream(data), gold.decode_stream(data)
    assert got.errors == gold.errors and got.errors
    assert [f.poc for f in frames] == [f.poc for f in gframes]
    for f, g in zip(frames, gframes):
        for c in range(3):
            assert np.array_equal(f.planes[c], g.planes[c]), (f.poc, c)


# the benchmark's readers of these stats: (stats of two ranks, value)
_RANKS = [dict(frames=3, finalize_s=0.9, finalize_cpu_s=0.3,
               tensor_plan_s=0.06, tensor_plan_cpu_s=0.06, mc_pack_s=0.3,
               mc_pack_cpu_s=0.1, pack_s=0.24, pack_cpu_s=0.04,
               queue_wait_s=0.0),
          dict(frames=1, finalize_s=0.3, finalize_cpu_s=0.2,
               tensor_plan_s=0.02, tensor_plan_cpu_s=0.01, mc_pack_s=0.1,
               mc_pack_cpu_s=0.1, pack_s=0.08, pack_cpu_s=0.0,
               queue_wait_s=0.2)]
READERS = {
    "replay.finalize_ms_per_frame": ("finalize_s", 300.0),
    "plan.tensor_plan_ms_per_frame": ("tensor_plan_s", 20.0),
    "recon.mc_pack_ms_per_frame": ("mc_pack_s", 100.0),
    "recon.queue_wait_ms_per_frame": ("queue_wait_s", 50.0),
    # wall 2.0 s, CPU 0.81 s
    "host.off_cpu_share": ("pack_cpu_s", 100 * (1 - 0.81 / 2.0)),
}


@pytest.mark.parametrize("name", READERS)
def test_metric_reader(name):
    mod = spec.metric(name)
    key, want = READERS[name]
    ranks = [dict(stats=dict(s)) for s in _RANKS]
    assert mod.read(ranks) == pytest.approx(want)
    assert mod.read([]) is None
    del ranks[1]["stats"][key]              # a program without the span
    assert mod.read(ranks) is None
    assert mod.read([dict(stats={})]) is None
    zero = [dict(stats={k: 0 for k in s}) for s in _RANKS]
    assert mod.read(zero) is None           # no frames, no wall time


def test_queue_wait_of_zero_is_a_reading():
    mod = spec.metric("recon.queue_wait_ms_per_frame")
    assert mod.read([dict(stats=dict(_RANKS[0]))]) == 0.0


def test_readers_are_declared():
    declared = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for name in READERS:
        mod, entry = spec.metric(name), declared[name]
        assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE, mod.RANGES) == (
            entry["unit"], entry["layer"], "fps", "program_span", {})
        assert entry["workloads"] == ["main1080_1card.ldp_segments",
                                      "main1080_ra_1card.ra_segments"]


def test_decoder_keys_exist_before_decoding():
    for cls in DECODERS.values():
        st = cls("cpu").stats
        for name, sfx in itertools.product(SPANS, ("_s", "_cpu_s")):
            assert st[name + sfx] == 0.0
        assert st["queue_wait_s"] == 0.0
        for name in COUNTERS:
            assert st[name] == 0, name


RA = "s96x64_ractc17"


@functools.lru_cache(maxsize=None)
def _ra_decoded(kind):
    dec = DECODERS[kind]("cpu")
    return dec.stats, dec.decode_stream(get_stream(RA))


def _tiles(pu) -> int:
    """The MC blocks of one PU: its luma and its chroma tiles."""
    return (len(tile_pu(pu.x, pu.y, pu.w, pu.h, LUMA_BUCKETS))
            + len(tile_pu(pu.x >> 1, pu.y >> 1, pu.w >> 1, pu.h >> 1,
                          CHROMA_BUCKETS)))


@pytest.mark.parametrize("kind", DECODERS)
def test_counters_of_the_ctc_random_access(kind):
    """s96x64_ractc17: an IDR and 16 B pictures with TMVP; the counters
    against the PU records, the MC block census and the GOP table's
    reference sets (four pictures at most, each a 96x64 4:2:0 slab)."""
    st, frames = _ra_decoded(kind)
    pus = [pu for f in frames for pu in f.plan.pus]
    bi = [pu for pu in pus if min(pu.motion.ref_idx) >= 0]
    assert st["replay_pus"] == len(pus)
    assert st["replay_bi_pus"] == len(bi) > 0
    assert st["tmvp_pictures"] == 16
    assert st["mc_blocks"] == sum(sum(mc_block_counts(f.plan).values())
                                  for f in frames if f.plan.pus)
    assert st["mc_bi_blocks"] == sum(_tiles(pu) for pu in bi) > 0
    want = sum(len(refs) for _, _, refs in ra_ctc_schedule(17))
    assert st["ref_pictures"] == want == 57
    assert st["ref_stack_bytes"] == want * (96 * 64 + 2 * 48 * 32)
    assert 0 < st["ref_stack_s"] <= st["mc_pack_s"]
    # every B picture packed straight from the motion replay's PU table
    assert st["mc_table_pictures"] == 16


@pytest.mark.parametrize("kind", DECODERS)
def test_mc_table_pictures_counts_only_replay_tables(kind):
    """The Python parse hands the MC pack PuRec objects, whose table the
    pack builds itself: the same blocks, and no picture counted."""
    dec = DECODERS[kind]("cpu", use_native_parse=False)
    frames = dec.decode_stream(get_stream(RA))
    st, (native, _) = dec.stats, _ra_decoded(kind)
    assert st["mc_table_pictures"] == 0 < native["mc_table_pictures"]
    for name in ("mc_blocks", "mc_bi_blocks", "ref_pictures"):
        assert st[name] == native[name], name
    assert len(frames) == 17


def test_ref_stack_nests_inside_mc_pack():
    dec = PipelinedTorchDecoder("cpu")
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        dec.decode_stream(get_stream(RA))
    ev = [e for e in prof.events() if e.name.startswith(spans.PREFIX)]
    packs = [e for e in ev if e.name == spans.PREFIX + "mc_pack"]
    stacks = [e for e in ev if e.name == spans.PREFIX + "ref_stack"]
    assert len(stacks) == 16 and len(packs) == 16
    for s in stacks:
        assert any(p.thread == s.thread
                   and p.time_range.start <= s.time_range.start
                   and s.time_range.end <= p.time_range.end
                   for p in packs), s


def test_counters_are_zero_on_intra_pictures():
    dec = TorchDecoder("cpu")
    assert len(dec.decode_stream(_intra(64, 64))) == 1
    for name in COUNTERS:
        assert dec.stats[name] == 0, name


def test_mc_pack_us_per_block_reader():
    mod = spec.metric("recon.mc_pack_us_per_block")
    ranks = [dict(stats=dict(mc_pack_s=0.3, mc_blocks=1000, frames=3)),
             dict(stats=dict(mc_pack_s=0.1, mc_blocks=600, frames=1))]
    assert mod.read(ranks) == pytest.approx(0.4 / 1600 * 1e6)
    assert mod.read([]) is None
    del ranks[1]["stats"]["mc_blocks"]      # a program without the counter
    assert mod.read(ranks) is None
    zero = [dict(stats=dict(mc_pack_s=0.2, mc_blocks=0, frames=1))]
    assert mod.read(zero) is None           # intra pictures: no block
    entry = [m for m in spec.benchmark()["per_layer"]
             if m["name"] == "recon.mc_pack_us_per_block"][0]
    assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE, mod.RANGES) == (
        entry["unit"], entry["layer"], "fps", "program_span", {}) == (
        "us", "recon worker", "fps", "program_span", {})
    assert entry["workloads"] == ["main1080_ra_1card.ra_segments",
                                  "main1080_1card.ldp_segments"]
