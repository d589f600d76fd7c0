"""The MC pack over a picture's PU table (kernels/mc.py mc_arrays) against
the per-PU pack it replaced, on the CPU.

The oracle, `old_block_counts` and `old_arrays_padded`, is
`mc_block_counts` and `mc_arrays_padded` as they stood before the pack read
the motion replay's PU table, verbatim: per-PU comprehensions over the
PuRec objects, a per-PU reference lookup and a per-PU tiling.  Every
bucket, field, row and dtype must be equal, on the committed 96x64 LDP, RA
and CTC random-access streams (bi, AMP, ref_idx 1, TMVP), the first P
picture of s1080_ldp4, a weighted-prediction GOP of the port's encoder,
and the Python parse of one stream (PuRec objects, no table).  Then the
decoders' hot path: the native parse's pictures are packed straight from
the table, with no PuRec built, while every reader that iterates plan.pus
still gets the objects.
"""
import copy
import functools
import pickle

import numpy as np
import pytest

from p265_tpu_torch.golden.decoder import GoldenDecoder
from p265_tpu_torch.hls import nal
from p265_tpu_torch.kernels import mc
from p265_tpu_torch.kernels.mc import (BIT_DEPTH, CHROMA_BUCKETS,
                                       LUMA_BUCKETS, tile_pu)
from p265_tpu_torch.native import replay
from p265_tpu_torch.native.parse import native_parse_available
from p265_tpu_torch.native.replay import PuList, pu_records, pu_table
from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
from p265_tpu_torch.testgen.conformance import _gop
from p265_tpu_torch.testgen.streams import get_stream

pytestmark = pytest.mark.skipif(not native_parse_available(),
                                reason="no C compiler for the native parse")


# ---------------------------------------------------------------------------
# the oracle: the per-PU pack, verbatim
# ---------------------------------------------------------------------------


def old_block_counts(plan) -> dict:
    """Per-bucket MC block counts {"y16": n, ..., "c2": n} of one picture."""
    out = {f"{grp}{b}": 0 for grp in ("y", "c")
           for b in (LUMA_BUCKETS if grp == "y" else CHROMA_BUCKETS)}
    for p in plan.pus:
        for grp, sizes, rect in (
                ("y", LUMA_BUCKETS, (p.x, p.y, p.w, p.h)),
                ("c", CHROMA_BUCKETS,
                 (p.x >> 1, p.y >> 1, p.w >> 1, p.h >> 1))):
            for (_, _, s) in tile_pu(*rect, sizes):
                out[f"{grp}{s}"] += 1
    return out


def old_arrays_padded(plan, poc_index: dict, pad_rows: dict):
    """All inter PUs -> size-bucketed MC block arrays.

    Returns {"y": {block: fields}, "c": {block: fields}} with fields pos
    [n,2] (y, x), mv0/mv1 [n,2], r0/r1 [n], has1 [n] bool and weight rows
    wp_0 (luma) or wp_1/wp_2 (cb/cr) [n,5] = (w0, o0, w1, o1, log2_wd);
    identity weights (1, 0, 1, 0, 0) reproduce unweighted rounding.
    pad_rows {"y16": n, ...} gives each bucket's row count; the port passes
    mc_block_counts(plan), so nothing is padded.  Pad rows, where a count
    exceeds the blocks, sit at pos = (plane height, 0) and are dropped by
    mc_pred_planes."""
    pus = plan.pus
    npu = len(pus)

    def pad_only(grp, block, ph):
        tgt = pad_rows[f"{grp}{block}"]
        d = dict(pos=np.full((tgt, 2), 0, np.int32),
                 mv0=np.zeros((tgt, 2), np.int32),
                 mv1=np.zeros((tgt, 2), np.int32),
                 r0=np.zeros(tgt, np.int32),
                 r1=np.zeros(tgt, np.int32),
                 has1=np.zeros(tgt, bool))
        d["pos"][:] = (ph, 0)
        wp = np.zeros((tgt, 5), np.int32)
        wp[:, 0] = wp[:, 2] = 1
        if grp == "y":
            d["wp_0"] = wp
        else:
            d["wp_1"], d["wp_2"] = wp, wp.copy()
        return d

    if npu == 0:
        return {grp: {b: pad_only(grp, b, ph) for b in sizes}
                for grp, sizes, ph in
                (("y", LUMA_BUCKETS, plan.sps.pic_height),
                 ("c", CHROMA_BUCKETS, plan.sps.pic_height >> 1))}

    uses1 = np.array([p.motion.uses(1) for p in pus], bool)
    uses0 = np.array([p.motion.uses(0) for p in pus], bool)
    l0 = np.where(uses0, 0, 1)                   # first used list per PU
    mv = np.array([p.motion.mv for p in pus], np.int32).reshape(npu, 2, 2)
    rpoc = np.array([p.motion.ref_poc for p in pus], np.int64)
    ridx = np.array([p.motion.ref_idx for p in pus], np.int32)
    ar = np.zeros((npu, 2), np.int32)
    for lx in range(2):
        use = uses1 if lx else uses0
        for i in np.nonzero(use)[0]:
            ar[i, lx] = poc_index[int(rpoc[i, lx])]
    mv0 = mv[np.arange(npu), l0]
    r0 = ar[np.arange(npu), l0]
    has1 = uses0 & uses1
    mv1 = np.where(has1[:, None], mv[:, 1], 0).astype(np.int32)
    r1 = np.where(has1, ar[:, 1], 0).astype(np.int32)

    wt = None
    if ((plan.pps.weighted_pred and plan.sh.slice_type == 1)
            or (plan.pps.weighted_bipred and plan.sh.slice_type == 0)):
        wt = plan.sh.pred_weights
    wp_pu = np.zeros((3, npu, 5), np.int32)
    wp_pu[:, :, 0] = 1   # w0
    wp_pu[:, :, 2] = 1   # w1
    if wt is not None:
        for i, p in enumerate(pus):
            for c in range(3):
                denom = wt.luma_log2_denom if c == 0 else wt.chroma_log2_denom
                wp_pu[c, i, 4] = denom + (14 - BIT_DEPTH) - 6
                off = 0 if c == 0 else 2 * c
                e0 = wt.get(int(l0[i]), int(ridx[i, l0[i]]))
                wp_pu[c, i, 0], wp_pu[c, i, 1] = e0[off], e0[off + 1]
                if has1[i]:
                    e1 = wt.get(1, int(ridx[i, 1]))
                    wp_pu[c, i, 2], wp_pu[c, i, 3] = e1[off], e1[off + 1]

    out = {}
    for grp, sizes, ph in (("y", LUMA_BUCKETS, plan.sps.pic_height),
                           ("c", CHROMA_BUCKETS, plan.sps.pic_height >> 1)):
        tiles = {b: [] for b in sizes}   # per bucket: (y, x, pu_idx)
        for i, p in enumerate(pus):
            if grp == "y":
                rect = (p.x, p.y, p.w, p.h)
            else:
                rect = (p.x >> 1, p.y >> 1, p.w >> 1, p.h >> 1)
            for (ty, tx, s) in tile_pu(*rect, sizes):
                tiles[s].append((ty, tx, i))
        out[grp] = {}
        for b in sizes:
            rows = tiles[b]
            n = len(rows)
            tgt = pad_rows[f"{grp}{b}"]
            if tgt < n:
                raise ValueError(f"pad_rows[{grp}{b}]={tgt} < {n} blocks")
            if n == 0:
                out[grp][b] = pad_only(grp, b, ph)
                continue
            pos = np.array([(r[0], r[1]) for r in rows], np.int32)
            pu_of = np.array([r[2] for r in rows], np.int32)

            def padded(a, fill=0):
                full = np.full((tgt,) + a.shape[1:], fill, a.dtype)
                full[:n] = a
                return full

            d = dict(pos=padded(pos), mv0=padded(mv0[pu_of]),
                     mv1=padded(mv1[pu_of]), r0=padded(r0[pu_of]),
                     r1=padded(r1[pu_of]), has1=padded(has1[pu_of]))
            d["pos"][n:] = (ph, 0)
            if grp == "y":
                d["wp_0"] = padded(wp_pu[0][pu_of])
            else:
                d["wp_1"] = padded(wp_pu[1][pu_of])
                d["wp_2"] = padded(wp_pu[2][pu_of])
            out[grp][b] = d
    return out


# ---------------------------------------------------------------------------
# the inter pictures of each input, as a decode's plans
# ---------------------------------------------------------------------------


class _Plans(GoldenDecoder):
    """The parse of a stream with no reconstruction; keeps each inter
    picture's FramePlan."""

    def __init__(self, native_parse=True):
        super().__init__(use_native_parse=native_parse)
        self.plans = []

    def _run_recon(self, task):
        if task["plan"].pus:
            self.plans.append(task["plan"])
        task["frame"].planes = task["frame"].prefilter = [None] * 3
        task["pic"].planes = [np.zeros((2, 2), np.int32)] * 3


def _parsed(data: bytes, native_parse=True, n_pictures=None) -> list:
    dec = _Plans(native_parse)
    units = nal.split_nal_units(data)
    if n_pictures is not None:   # the units before the next picture's
        starts = [i for i, u in enumerate(units)
                  if nal.is_slice_nal(u.nal_type) and u.rbsp[0] >> 7]
        units = units[:starts[n_pictures]]
    for u in units:
        dec.decode_nal(u)
    dec.flush()
    return dec.plans


INPUTS = {
    "s96x64_ldp5": lambda: _parsed(get_stream("s96x64_ldp5")),
    "s96x64_ra5": lambda: _parsed(get_stream("s96x64_ra5")),
    "s96x64_ractc17": lambda: _parsed(get_stream("s96x64_ractc17")),
    "s96x64_ractc17q40": lambda: _parsed(get_stream("s96x64_ractc17q40")),
    # the IDR picture and the first P picture
    "s1080_ldp4_first_p": lambda: _parsed(get_stream("s1080_ldp4"),
                                          n_pictures=2),
    "weighted_ra": lambda: _parsed(_gop("RA", 5, 14, qp=32,
                                        weighted_pred=True,
                                        weighted_bipred=True)),
    "python_parse_ractc17": lambda: _parsed(get_stream("s96x64_ractc17"),
                                            native_parse=False),
}


@functools.lru_cache(maxsize=None)
def _plans(name):
    return INPUTS[name]()


def _poc_list(plan) -> list:
    """The picture's reference POCs, sorted, after a POC that no PU reads
    and that sorts last: the list is not sorted, and no index equals a
    POC's rank in sorted order."""
    return [10 ** 6] + sorted(set(plan.l0_pocs) | set(plan.l1_pocs))


def _assert_same(got, want, where):
    assert list(got) == list(want), where
    for grp in want:
        assert list(got[grp]) == list(want[grp]), (where, grp)
        for b in want[grp]:
            g, w = got[grp][b], want[grp][b]
            assert list(g) == list(w), (where, grp, b)
            for f, a in w.items():
                assert g[f].dtype == a.dtype, (where, grp, b, f)
                assert g[f].shape == a.shape, (where, grp, b, f)
                assert np.array_equal(g[f], a), (where, grp, b, f)


@pytest.mark.parametrize("name", INPUTS)
def test_table_pack_equals_the_per_pu_pack(name):
    plans = _plans(name)
    assert plans
    native_parse = not name.startswith("python_parse")
    for plan in plans:
        where = (name, plan.poc)
        # a table straight from the replay, or objects from the parse
        assert isinstance(plan.pus, PuList) == native_parse, where
        table = pu_table(plan.pus)
        assert table.dtype == np.int32 and table.shape == (
            len(plan.pus), replay.PU_W), where
        poc_list = _poc_list(plan)
        pidx = {p: i for i, p in enumerate(poc_list)}
        got = mc.mc_arrays(plan, poc_list)
        cnt = old_block_counts(plan)
        _assert_same(got, old_arrays_padded(plan, pidx, cnt), where)
        assert mc.mc_block_counts(plan) == cnt, where
        assert {f"{grp}{b}": len(d["pos"]) for grp in got
                for b, d in got[grp].items()} == cnt, where
        # the wrapper, with and without pad rows
        for pad in (cnt, {k: v + 3 for k, v in cnt.items()}):
            _assert_same(mc.mc_arrays_padded(plan, pidx, pad),
                         old_arrays_padded(plan, pidx, pad), where)
    # what each input is there for
    pus = [p for plan in plans for p in plan.pus]
    bi = [p for p in pus if p.motion.uses(0) and p.motion.uses(1)]
    if name in ("s96x64_ra5", "s96x64_ractc17", "weighted_ra"):
        assert bi, name
    if name.startswith("s96x64_ractc17"):
        assert any(max(p.motion.ref_idx) == 1 for p in pus)
        assert any(plan.sh.temporal_mvp_enabled for plan in plans)
        assert any(4 * min(p.w, p.h) in (max(p.w, p.h), 3 * max(p.w, p.h))
                   for p in pus)            # AMP's 1:4 and 3:4 partitions
    if name == "weighted_ra":
        assert any(not np.array_equal(
            d["wp_0"][:, :4], np.broadcast_to([1, 0, 1, 0],
                                              d["wp_0"][:, :4].shape))
            for plan in plans
            for d in mc.mc_arrays(plan, _poc_list(plan))["y"].values())
    if name == "s1080_ldp4_first_p":
        assert len(plans) == 1 and len(pus) > 1000


def test_a_poc_missing_from_the_list_raises():
    plan = max(_plans("s96x64_ractc17"), key=lambda p: len(p.l1_pocs))
    table = pu_table(plan.pus)
    used = sorted({int(p) for lx in range(2)
                   for p in table[table[:, 8 + lx] >= 0, 10 + lx]})
    for drop in used:
        poc_list = [p for p in _poc_list(plan) if p != drop]
        pidx = {p: i for i, p in enumerate(poc_list)}
        with pytest.raises(KeyError):
            old_arrays_padded(plan, pidx, old_block_counts(plan))
        with pytest.raises(KeyError):
            mc.mc_arrays(plan, poc_list)
        with pytest.raises(KeyError):
            mc.mc_arrays_padded(plan, pidx, old_block_counts(plan))
    with pytest.raises(KeyError):
        mc.mc_arrays(plan, [])


def test_an_empty_table_packs_empty_buckets():
    plan = copy.copy(_plans("s96x64_ldp5")[0])
    plan.pus = PuList(np.zeros((0, replay.PU_W), np.int32))
    got = mc.mc_arrays(plan, [])
    for grp, sizes in (("y", LUMA_BUCKETS), ("c", CHROMA_BUCKETS)):
        assert list(got[grp]) == list(sizes)
        for d in got[grp].values():
            assert d["pos"].shape == (0, 2) and d["pos"].dtype == np.int32
            assert d["has1"].shape == (0,) and d["has1"].dtype == bool


# ---------------------------------------------------------------------------
# the decoders' hot path reads the table; other readers get the objects
# ---------------------------------------------------------------------------


def test_the_pipelined_decoder_builds_no_pu_record(monkeypatch):
    def refuse(table):
        raise AssertionError("a PuRec was built on the hot path")
    data = get_stream("s96x64_ractc17")
    want = GoldenDecoder().decode_stream(data)
    monkeypatch.setattr(replay, "pu_records", refuse)
    dec = PipelinedTorchDecoder("cpu")
    frames = dec.decode_stream(data)
    inter = [f for f in frames if f.plan.pus]
    assert len(inter) == 16 == dec.stats["mc_table_pictures"]
    assert all(isinstance(f.plan.pus, PuList) for f in inter)
    assert dec.stats["replay_pus"] == sum(len(f.plan.pus) for f in inter)
    assert [f.poc for f in frames] == [f.poc for f in want]
    for f, g in zip(frames, want):
        for a, b in zip(f.planes, g.planes):
            assert np.array_equal(a, b), f.poc
    monkeypatch.undo()
    # once the hot path is done, reading plan.pus builds the objects
    for f in inter:
        assert list(f.plan.pus) == pu_records(f.plan.pus.table)


def test_the_python_parse_is_packed_from_its_objects():
    dec = PipelinedTorchDecoder("cpu", use_native_parse=False)
    frames = dec.decode_stream(get_stream("s96x64_ractc17"))
    assert dec.stats["mc_table_pictures"] == 0
    assert dec.stats["mc_blocks"] == sum(
        sum(old_block_counts(f.plan).values()) for f in frames if f.plan.pus)


def test_readers_that_iterate_get_the_records():
    """The golden inter prediction (golden/recon.py build_inter_pred) of
    the native parse's plans reads the PuRec objects that iterating
    plan.pus builds: objects equal to pu_records(table) and to the Python
    parse's, and the same prediction planes; the roofline census reads the
    same numbers from the PuList as from a plain list of its objects."""
    from p265_tpu_torch.golden.recon import build_inter_pred
    from p265_tpu_torch.plan.frame_plan import build_tensor_plan
    from p265_tpu_torch.roofline import picture_census
    data = get_stream("s96x64_ractc17")
    by_poc = {g.poc: g.planes for g in GoldenDecoder().decode_stream(data)}
    py_plans = {p.poc: p for p in _plans("python_parse_ractc17")}
    plans = _parsed(data)
    assert len(plans) == 16
    for plan in plans:
        assert isinstance(plan.pus, PuList) and plan.pus._records is None
        refs = {p: by_poc[p] for p in plan.l0_pocs + plan.l1_pocs}
        got = build_inter_pred(plan, refs)
        recs = pu_records(plan.pus.table)
        assert plan.pus._records is not None
        assert list(plan.pus) == recs == py_plans[plan.poc].pus
        assert [plan.pus[i] for i in range(len(recs))] == recs
        for x, y in zip(got, build_inter_pred(py_plans[plan.poc], refs)):
            assert np.array_equal(x, y), plan.poc
        tplan = build_tensor_plan(plan, skip_pred=True)
        plain = copy.copy(plan)
        plain.pus = list(recs)
        assert (picture_census(plan, tplan)
                == picture_census(plain, tplan)), plan.poc


def test_pu_list_reads_its_table_until_used():
    plan = _plans("s96x64_ractc17")[1]
    table = plan.pus.table
    pus = PuList(table)
    built = []
    real = replay.pu_records

    def counting(t):
        built.append(len(t))
        return real(t)
    replay.pu_records, saved = counting, replay.pu_records
    try:
        assert len(pus) == len(table) and bool(pus)
        assert not PuList(table[:0])
        assert pu_table(pus) is table and not built
        # a copy, a deep copy and a pickle keep the table, unbuilt
        for other in (copy.copy(pus), copy.deepcopy(pus),
                      pickle.loads(pickle.dumps(pus))):
            assert isinstance(other, PuList)
            assert np.array_equal(other.table, table) and not built
        first = pus[0]
        assert built == [len(table)]
        assert first == real(table)[0] and list(pus) == real(table)
        assert pus[1:3] == real(table)[1:3] and pus[-1] == real(table)[-1]
        assert pu_table(pus) is table       # reading keeps the table
        # read only: nothing can change it away from its table
        assert not hasattr(pus, "append") and not hasattr(pus, "extend")
        with pytest.raises(TypeError):
            pus[0] = first
        # a copy of a built list keeps the table and the objects
        other = copy.deepcopy(pus)
        assert isinstance(other, PuList) and list(other) == list(pus)
        assert np.array_equal(pu_table(other), table)
    finally:
        replay.pu_records = saved
    assert built == [len(table)]
