"""The port's motion replay in C (native/replay.c, one call a picture)
against the Python loop it replaced, grid for grid, on the CPU.

The oracle, `replay_motion_py`, is the Python `NativeParseState
.replay_motion` loop as it stood before the replay moved to C, verbatim
(golden/mv.py's merge and AMVP derivation over the C parser's CU/PU
events).  Each inter picture's native parse is replayed by both, from the
same MotionCtx, and they must agree on mctx.mv, ref_idx, ref_poc, lt,
motion_coded and cur_cu and on every field of every plan.pus entry, in
order.  Streams: the port's encoder (LDP, LDP2, RA, WPP, tiles, two
slices, AMP, TMVP, long-term references), the committed s96x64_ldp5 and
s96x64_ra5, the first P picture of s1080_ldp4, and a recorded event
stream replayed with its long-term flags flipped.
"""
import copy
import functools
import os
import subprocess
import types

import numpy as np
import pytest

from p265_tpu_torch import native
from p265_tpu_torch.golden.decoder import DecoderBase
from p265_tpu_torch.hls import nal
from p265_tpu_torch.hls.params import PPS, SPS
from p265_tpu_torch.native.parse import (EV_CU, PART_NAMES,
                                         native_parse_available)
from p265_tpu_torch.native.replay import pu_records
from p265_tpu_torch.testgen.encoder import Encoder, make_moving_sequence
from p265_tpu_torch.testgen.streams import get_stream

pytestmark = pytest.mark.skipif(not native_parse_available(),
                                reason="no C compiler for the native parse")


def replay_motion_py(self, plan, mctx) -> None:
    """Walk the C parser's CU/PU event stream in z-order, re-deriving
    merge/AMVP candidates (which never affect the bitstream) with a
    replay availability grid that reproduces the parse-time neighborhood
    (golden/mv.py motion_at semantics)."""
    n_ev = int(self._ev.count)
    if n_ev == 0:
        return
    assert mctx is not None, "inter events need a MotionCtx"
    from p265_tpu_torch.golden.mv import Motion, derive_amvp, derive_merge_list
    from p265_tpu_torch.syntax.ctu import PuRec, wrap_mv
    sps = self.sps
    w4 = (sps.pic_width + 3) >> 2
    h4 = (sps.pic_height + 3) >> 2
    avail = np.zeros((h4, w4), bool)
    tile_map4 = plan.tile_map4
    slice_of_ctb = plan.slice_of_ctb
    log2_ctb, wc = sps.log2_ctb_size, sps.pic_width_ctbs
    cur = {"tile": 0, "slice": 0}

    def avail_at(x: int, y: int) -> bool:
        if x < 0 or y < 0 or x >= sps.pic_width or y >= sps.pic_height:
            return False
        if tile_map4[y >> 2, x >> 2] != cur["tile"]:
            return False
        addr = (y >> log2_ctb) * wc + (x >> log2_ctb)
        if slice_of_ctb[addr] != cur["slice"]:
            return False
        return bool(avail[y >> 2, x >> 2])

    mctx.avail = avail_at
    mctx.intra_map = plan.intra_map
    ev = self.ev[:n_ev]
    pending = None  # (x0, y0, size) of the CU awaiting availability mark
    for r in ev:
        if r[0] == EV_CU:
            if pending is not None:
                x0, y0, size = pending
                x1 = min(x0 + size, sps.pic_width)
                y1 = min(y0 + size, sps.pic_height)
                avail[y0 >> 2:(y1 + 3) >> 2, x0 >> 2:(x1 + 3) >> 2] = True
            x0, y0, size = int(r[1]), int(r[2]), 1 << int(r[3])
            pending = (x0, y0, size)
            cur["tile"] = int(tile_map4[y0 >> 2, x0 >> 2])
            cur["slice"] = int(
                slice_of_ctb[(y0 >> log2_ctb) * wc + (x0 >> log2_ctb)])
            mctx.begin_cu()
            continue
        x, y, w, h = (int(r[1]), int(r[2]), int(r[3]), int(r[4]))
        part, part_idx = PART_NAMES[int(r[5])], int(r[6])
        if r[7]:  # merge
            cx0, cy0, csize = pending
            cu_log2 = csize.bit_length() - 1
            cands = derive_merge_list(mctx, cx0, cy0, csize, x, y, w, h,
                                      part, part_idx, int(r[18]))
            motion = cands[int(r[8])].copy()
        else:
            idc = int(r[9])
            motion = Motion()
            for lx in (0, 1):
                if (idc == 0 and lx == 1) or (idc == 1 and lx == 0):
                    continue
                ridx = int(r[10 + lx])
                mvd = (int(r[12 + 2 * lx]), int(r[13 + 2 * lx]))
                amvp = derive_amvp(mctx, x, y, w, h, lx, ridx)
                mvp = amvp[int(r[16 + lx])]
                motion.mv[lx] = (wrap_mv(mvp[0] + mvd[0]),
                                 wrap_mv(mvp[1] + mvd[1]))
                motion.ref_idx[lx] = ridx
                motion.ref_poc[lx] = mctx.list_pocs[lx][ridx]
                # NOTE: lt stays False here, matching the Python parser
                # (_prediction_unit leaves Motion.lt default on the AMVP
                # path; the grids must agree bit-for-bit)
        mctx.store_pu(x, y, w, h, motion)
        plan.pus.append(PuRec(x, y, w, h, motion))


GRIDS = ("mv", "ref_idx", "ref_poc", "lt", "motion_coded")


def _flip_lists(m):
    m.list_lt = [[not v for v in lts] for lts in m.list_lt]


def _flip_col(m):
    if m.col_mv is not None:
        lt = (m.col_lt if m.col_lt is not None
              else np.zeros(m.col_ref_poc.shape, bool))
        m.col_lt = ~np.asarray(lt, bool)


def _flip_col_list(m):
    m.sh = copy.copy(m.sh)
    m.sh.collocated_from_l0 = not m.sh.collocated_from_l0


def _extend_l0(m):
    m.list_pocs = [m.list_pocs[0] + [min(m.list_pocs[0]) - 1],
                   m.list_pocs[1]]
    m.list_lt = [m.list_lt[0] + [False], m.list_lt[1]]


# inputs of the derivation that do not change the syntax: one recorded
# event stream replayed with them altered still has one answer
PERTURB = {
    "lt_all": lambda m: (_flip_lists(m), _flip_col(m)),
    "lt_lists": _flip_lists,
    "lt_col": _flip_col,
    "no_backward": lambda m: setattr(m, "no_backward", not m.no_backward),
    "col_from_l1": _flip_col_list,
    "l0_longer": _extend_l0,        # more zero candidates in L0 than L1
}


def _fuzz(ev, rng, list_pocs) -> np.ndarray:
    """A random motion syntax over the CU geometry of `ev`: every PU's
    merge flag and index, direction, reference indices, mvds (up to the
    16-bit limits, so that the sum wraps) and mvp flags drawn from rng,
    and an 8x8 CU's 2Nx2N PU split into two 8x4 or 4x8 PUs (no
    bi-prediction coded there, as the syntax allows none)."""
    n0, n1 = len(list_pocs[0]), len(list_pocs[1])
    out = []
    for r in ev:
        if r[0] == EV_CU:
            out.append(r.copy())
            continue
        pus = [r.copy()]
        if r[3] == r[4] == 8 and r[5] == 0:
            hor = rng.random() < 0.5            # 2NxN, else Nx2N
            a = r.copy()
            a[5], a[6] = (1, 0) if hor else (2, 0)
            a[3], a[4] = (8, 4) if hor else (4, 8)
            b = a.copy()
            b[6] = 1
            b[1 if not hor else 2] += 4
            pus = [a, b]
        for p in pus:
            p[7] = rng.random() < 0.5
            p[8] = rng.integers(0, p[18])
            p[9] = rng.integers(0, 2 if p[3] + p[4] == 12 else 3) if n1 else 0
            p[10] = rng.integers(0, n0) if p[9] != 1 else -1
            p[11] = rng.integers(0, n1) if n1 and p[9] != 0 else -1
            lim = rng.choice([64, 64, 64, 1 << 15])
            p[12:16] = rng.integers(-lim, lim, 4)
            if rng.random() < 0.1:      # at the 16-bit edges
                p[12:16] = rng.choice([-32768, -32767, 32766, 32767], 4)
            p[16:18] = rng.integers(0, 2, 2)
            out.append(p)
    return np.array(out, np.int32)


def _fresh(mctx, perturb=None):
    """A copy of a MotionCtx with grids of its own, altered by
    PERTURB[perturb] if given."""
    m = copy.copy(mctx)
    for g in GRIDS:
        setattr(m, g, getattr(mctx, g).copy())
    m.list_lt = [list(v) for v in mctx.list_lt]
    if perturb is not None:
        PERTURB[perturb](m)
    return m


def _pu_fields(pus) -> list:
    return [(p.x, p.y, p.w, p.h, [tuple(v) for v in p.motion.mv],
             list(p.motion.ref_idx), list(p.motion.ref_poc),
             [bool(v) for v in p.motion.lt]) for p in pus]


def _oracle(ns, plan, mctx):
    """The Python loop on a copy of the picture's state -> (mctx, pus)."""
    pl = types.SimpleNamespace(tile_map4=plan.tile_map4,
                               slice_of_ctb=plan.slice_of_ctb,
                               intra_map=plan.intra_map, pus=[])
    replay_motion_py(ns, pl, mctx)
    return mctx, pl.pus


def _assert_same(got_mctx, got_pus, want_mctx, want_pus, where):
    for g in GRIDS:
        a, b = getattr(got_mctx, g), getattr(want_mctx, g)
        assert a.dtype == b.dtype and np.array_equal(a, b), (where, g)
    assert got_mctx.cur_cu == want_mctx.cur_cu, where
    assert _pu_fields(got_pus) == _pu_fields(want_pus), where
    for p in got_pus:   # the records' own types, as the consumers use them
        assert all(type(v) is bool for v in p.motion.lt), where
        assert all(type(c) is int for v in p.motion.mv for c in v), where


class _Replayed(DecoderBase):
    """The native parse without reconstruction; each inter picture is
    replayed by the Python oracle on a copy of its MotionCtx, then
    finalized as the decoders finalize it (the C replay), and the two are
    compared.  perturb: also both on copies altered by PERTURB[perturb].
    fuzz: a seed; each picture's events are first replaced by a random
    motion syntax over the same CUs (_fuzz).  max_inter: stop comparing
    after that many inter pictures."""

    def __init__(self, perturb=None, fuzz=None, max_inter=None):
        super().__init__(use_native_parse=True)
        self.perturb, self.max_inter = perturb, max_inter
        self.rng = None if fuzz is None else np.random.default_rng(fuzz)
        # per compared picture: (PuRecs, list POCs, list lt flags)
        self.seen = []
        self.perturbed = []     # per picture: its PuRecs, perturbed

    def _schedule_recon(self, task):
        pass

    def _finish_picture(self):
        pic = self._pic
        ns = None if pic is None else getattr(pic["plan"], "nstate", None)
        if (ns is None or pic["mctx"] is None or not ns._ev.count
                or (self.max_inter is not None
                    and len(self.seen) >= self.max_inter)):
            return super()._finish_picture()
        plan, mctx = pic["plan"], pic["mctx"]
        if self.rng is not None:
            ev = _fuzz(ns.ev[:ns._ev.count], self.rng, mctx.list_pocs)
            assert len(ev) <= len(ns.ev)
            ns.ev[:len(ev)] = ev
            ns._ev.count = len(ev)
        where = (pic["poc"], self.perturb)
        want_mctx, want_pus = _oracle(ns, plan, _fresh(mctx))
        if self.perturb is not None:
            fm, fp = _oracle(ns, plan, _fresh(mctx, self.perturb))
            cm = _fresh(mctx, self.perturb)
            table = ns.replay_motion(plan, cm)
            _assert_same(cm, pu_records(table), fm, fp, where)
            self.perturbed.append(fp)
        assert not plan.pus
        super()._finish_picture()       # finalize: the C replay
        _assert_same(mctx, plan.pus, want_mctx, want_pus, where)
        self.seen.append((want_pus, mctx.list_pocs, mctx.list_lt))


def _encode(w, h, n, structure, pps_kw=None, sps_kw=None, num_slices=1,
            qp=32, seed=5):
    sps = SPS(pic_width=w, pic_height=h, **(sps_kw or {}))
    pps = PPS(init_qp=qp, sign_data_hiding=True, **(pps_kw or {}))
    frames = make_moving_sequence(w, h, n, seed=seed)
    stream, _ = Encoder(sps, pps, qp=qp, seed=seed).encode_sequence(
        frames, structure, num_slices=num_slices)
    return stream


_TMVP = dict(temporal_mvp_enabled=True)
ENCODED = {
    "ldp": lambda: _encode(96, 64, 4, "LDP"),
    "ldp2": lambda: _encode(96, 64, 4, "LDP2"),
    "ra": lambda: _encode(96, 64, 6, "RA"),
    "wpp": lambda: _encode(160, 96, 3, "LDP",
                           pps_kw=dict(entropy_coding_sync_enabled=True)),
    "tiles": lambda: _encode(128, 128, 3, "LDP", pps_kw=dict(
        tiles_enabled=True, num_tile_columns=2, num_tile_rows=2)),
    "two_slices": lambda: _encode(96, 64, 3, "LDP", num_slices=2),
    "amp": lambda: _encode(96, 64, 3, "LDP", sps_kw=dict(amp_enabled=True)),
    "tmvp_ldp": lambda: _encode(96, 64, 4, "LDP", sps_kw=_TMVP),
    "tmvp_ra": lambda: _encode(96, 64, 6, "RA", sps_kw=_TMVP),
    "tmvp_ra_qp40": lambda: _encode(96, 64, 6, "RA", sps_kw=_TMVP, qp=40),
    "tmvp_ldp_lt": lambda: _encode(96, 64, 4, "LDP-LT", sps_kw=dict(
        temporal_mvp_enabled=True, num_reorder_pics=2,
        max_dec_pic_buffering=6, long_term_ref_pics_present=True)),
}


@functools.cache
def _stream(name: str) -> bytes:
    return ENCODED[name]()


def _pus_of(dec):
    return [p for s in dec.seen for p in s[0]]


# what each stream has to exercise, read from the compared pictures
WITNESS = {
    "ldp": lambda d: len(d.seen) == 3,
    # two references in L0 (the encoder codes ref_idx 0; the zero merge
    # candidates run over both)
    "ldp2": lambda d: any(len(s[1][0]) == 2 for s in d.seen),
    "ra": lambda d: any(min(p.motion.ref_idx) >= 0 for p in _pus_of(d)),
    "wpp": lambda d: len(d.seen) == 2,
    "tiles": lambda d: len(d.seen) == 2,
    "two_slices": lambda d: len(d.seen) == 2,
    # the encoder codes 2NxN and Nx2N, no asymmetric part: with AMP on,
    # 8x8 CUs split into 8x4 and 4x8 PUs
    "amp": lambda d: any(p.w + p.h == 12 for p in _pus_of(d)),
    "tmvp_ldp": lambda d: len(d.seen) == 3,
    "tmvp_ra": lambda d: any(min(p.motion.ref_idx) >= 0 for p in _pus_of(d)),
    "tmvp_ra_qp40": lambda d: any(min(p.motion.ref_idx) >= 0
                                  for p in _pus_of(d)),
    "tmvp_ldp_lt": lambda d: any(any(s[2][0]) for s in d.seen),
}


@pytest.mark.parametrize("name", sorted(ENCODED))
def test_c_replay_equals_the_python_loop_on_encoded_streams(name):
    dec = _Replayed()
    frames = dec.decode_stream(_stream(name))
    assert all(getattr(f.plan, "nstate", None) is not None for f in frames)
    assert dec.seen and all(s[0] for s in dec.seen), name
    assert WITNESS[name](dec), name


@pytest.mark.parametrize("name", ["s96x64_ldp5", "s96x64_ra5"])
def test_c_replay_equals_the_python_loop_on_committed_streams(name):
    dec = _Replayed()
    frames = dec.decode_stream(get_stream(name))
    n_inter = sum(bool(f.plan.pus) for f in frames)
    assert len(dec.seen) == n_inter == len(frames) - 1
    if name.endswith("ra5"):
        assert any(min(p.motion.ref_idx) >= 0 for p in _pus_of(dec))


def test_c_replay_equals_the_python_loop_on_the_first_1080p_p_picture():
    units = nal.split_nal_units(get_stream("s1080_ldp4"))
    starts = [i for i, u in enumerate(units)
              if nal.is_slice_nal(u.nal_type) and u.rbsp[0] >> 7]
    dec = _Replayed(max_inter=1)
    for u in units[:starts[2]]:         # the IDR picture and the first P
        dec.decode_nal(u)
    dec.flush()
    assert len(dec.seen) == 1
    assert len(dec.seen[0][0]) > 1000   # thousands of PUs in a 1080p P


@pytest.mark.parametrize("name,perturb,fuzz", [
    ("tmvp_ldp", "lt_all", None), ("tmvp_ra", "lt_all", None),
    ("tmvp_ldp_lt", "lt_all", None), ("tmvp_ra", "lt_lists", None),
    ("tmvp_ra", "lt_col", None), ("tmvp_ra_qp40", "no_backward", None),
    ("tmvp_ra", "col_from_l1", None), ("tmvp_ra", "l0_longer", 6)])
def test_c_replay_equals_the_python_loop_with_inputs_altered(name, perturb,
                                                              fuzz):
    """The long-term flags of the lists and of the collocated picture,
    NoBackwardPredFlag, collocated_from_l0 and an L0 entry that no PU
    codes do not change the syntax, so
    one recorded event stream replayed with them altered still has one
    answer: both replays must give it (fuzz: on a random motion syntax,
    whose merge indices reach the zero candidates)."""
    dec = _Replayed(perturb=perturb, fuzz=fuzz)
    dec.decode_stream(_stream(name))
    assert len(dec.perturbed) == len(dec.seen) > 0
    # the change reached the derivation: other motion than unaltered
    assert any(_pu_fields(a) != _pu_fields(s[0])
               for a, s in zip(dec.perturbed, dec.seen))
    if perturb == "lt_all":     # long-term motion in the result
        assert any(any(p.motion.lt) for pus in dec.perturbed for p in pus)


@pytest.mark.parametrize("name,seed", [
    ("tmvp_ra", 1), ("tmvp_ra", 2), ("tmvp_ldp_lt", 3), ("ldp2", 4),
    ("tiles", 5)])
def test_c_replay_equals_the_python_loop_on_random_motion_syntax(name, seed):
    """Every PU's motion syntax drawn at random over a stream's CUs (merge
    indices, directions, references, mvds to the 16-bit limits, 8x8 CUs
    split into 8x4 and 4x8 PUs): the two replays must agree on all of it."""
    dec = _Replayed(fuzz=seed)
    dec.decode_stream(_stream(name))
    pus = _pus_of(dec)
    assert len(dec.seen) > 1 and len(pus) > 50
    assert any(p.w + p.h == 12 for p in pus)
    assert any(abs(c) > 16384 for p in pus for v in p.motion.mv for c in v)


def test_replay_pus_counts_the_inter_pictures_pus():
    from p265_tpu_torch.pipeline.decoder import TorchDecoder
    data = get_stream("s96x64_ldp5")
    units = nal.split_nal_units(data)
    starts = [i for i, u in enumerate(units)
              if nal.is_slice_nal(u.nal_type) and u.rbsp[0] >> 7]
    idr = TorchDecoder("cpu")
    assert idr.stats["replay_pus"] == 0
    for u in units[:starts[1]]:         # the IDR picture alone
        idr.decode_nal(u)
    assert len(idr.flush()) == 1 and idr.stats["replay_pus"] == 0
    dec = TorchDecoder("cpu")
    frames = dec.decode_stream(data)
    inter = [f for f in frames if f.plan.pus]
    assert len(inter) == len(frames) - 1
    assert dec.stats["replay_pus"] == sum(len(f.plan.pus) for f in inter)


def test_a_newer_replay_source_rebuilds_the_library(tmp_path, monkeypatch):
    """_build compiles the library from replay.c (which includes ctu.c,
    which includes cabac.c) and rebuilds it when any of them is newer."""
    names = [os.path.basename(p) for p in
             (native._SRC, native._SRC_CTU, native._SRC_REPLAY)]
    assert names == ["cabac.c", "ctu.c", "replay.c"]
    srcs = []
    for p in (native._SRC, native._SRC_CTU, native._SRC_REPLAY):
        q = tmp_path / os.path.basename(p)
        q.write_bytes(open(p, "rb").read())
        srcs.append(str(q))
    so = str(tmp_path / "build" / "_cabac.so")
    runs = []
    real = subprocess.run

    def run(cmd, *a, **k):
        runs.append(cmd)
        return real(cmd, *a, **k)

    monkeypatch.setattr(native.subprocess, "run", run)
    assert native._build(srcs, so) and len(runs) == 1
    assert runs[0][-1] == srcs[-1]
    assert native._build(srcs, so) and len(runs) == 1    # up to date
    t = os.path.getmtime(so) + 10
    os.utime(srcs[-1], (t, t))                           # replay.c newer
    assert native._build(srcs, so) and len(runs) == 2
    import ctypes
    assert hasattr(ctypes.CDLL(so), "replay_motion")
