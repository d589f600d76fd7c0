"""The CTC's random-access coding for the port's test encoder.

`CtcEncoder.encode_sequence(frames, "RA-CTC")` codes the GOP of
`encoder_randomaccess_main.cfg` (JCT-VC CTC JCTVC-L1100): an IDR at the
base QP, then GOPs of 8 B pictures in the decode order 8 4 2 1 3 6 5 7,
each with its QP offset (in slice_qp_delta) and its reference POC deltas
(`RA_CTC_GOP`), two active references in each list, references before
POC 0 dropped.  Beside the GOP, the encoder codes what the CTC turns on
and the plain `Encoder` does not:

- AMP: the four asymmetric shapes are drawn among the 2-PU partitions of
  16x16 and 32x32 CUs (with `sps.amp_enabled`);
- ref_idx 1: an AMVP list takes its second reference for a seeded share
  (`REF1_SHARE`), with the motion searched against that picture;
- bi-prediction in the 2-PU partitions too (never for 8x4 and 4x8 PUs);
- TMVP from `collocated_ref_idx` 0 of L1 in B slices.

The first three override the hooks of `Encoder`'s inter CU planning
(`_pick_part`, `_ref_of`, `_search_pu`), whose defaults write the bytes they
wrote, so every existing structure and recipe is unchanged.  The SPS passed
in carries `amp_enabled`, `temporal_mvp_enabled` and the DPB sizes
(`ra_ctc_sps`).
"""
from __future__ import annotations

from p265_tpu_torch.hls import nal
from p265_tpu_torch.hls.bitio import BitWriter
from p265_tpu_torch.hls.params import (PPS, SPS, write_pps,
                                       write_profile_tier_level, write_sps)
from p265_tpu_torch.hls.slice_header import SLICE_B, SLICE_I
from p265_tpu_torch.testgen.encoder import Encoder

# (POC in the GOP, QP offset, reference POC deltas, all used), in decode
# order: encoder_randomaccess_main.cfg's Frame1..Frame8
RA_CTC_GOP = (
    (8, 1, (-8, -10, -12, -16)),
    (4, 2, (-4, -6, 4)),
    (2, 3, (-2, -4, 2, 6)),
    (1, 4, (-1, 1, 3, 7)),
    (3, 4, (-1, -3, 1, 5)),
    (6, 3, (-2, -4, -6, 2)),
    (5, 4, (-1, -5, 1, 3)),
    (7, 4, (-1, -3, -7, 1)),
)
GOP_SIZE = 8
N_REF = (2, 2)          # active references in L0 and L1
REF1_SHARE = 0.3        # share of AMVP lists that code ref_idx 1
AMP_PARTS = ("2NxnU", "2NxnD", "nLx2N", "nRx2N")


def ra_ctc_sps(w: int, h: int) -> SPS:
    """The SPS of an RA-CTC stream: AMP and TMVP on; three pictures of
    reordering.  The GOP holds at most four references and the current
    picture, so a DPB of five (what HM signals) outputs every picture in
    POC order under spec C.5.2.2.  The committed streams say six: a decoder
    that counts the current picture when it checks the DPB for fullness,
    as decode_bench/reference's does, outputs POC 4 before POC 3 at five."""
    return SPS(pic_width=w, pic_height=h, amp_enabled=True,
               temporal_mvp_enabled=True, max_dec_pic_buffering=6,
               num_reorder_pics=3)


def parameter_sets(sps: SPS, pps: PPS) -> bytes:
    """The VPS, SPS and PPS NAL units an RA-CTC stream starts with."""
    out = b""
    for kind, write, arg in ((nal.NAL_VPS, _write_vps, sps),
                             (nal.NAL_SPS, write_sps, sps),
                             (nal.NAL_PPS, write_pps, pps)):
        w = BitWriter()
        write(w, arg)
        out += nal.make_nal(kind, w.get_bytes())
    return out


def ra_ctc_schedule(n: int) -> list:
    """(poc, QP offset, reference POCs) of an RA-CTC sequence of `n`
    pictures in decode order: the IDR, then whole GOPs of 8."""
    if n < 1 or (n - 1) % GOP_SIZE:
        raise ValueError(f"RA-CTC codes 1 + 8k pictures, not {n}")
    out = [(0, 0, [])]
    for base in range(0, n - 1, GOP_SIZE):
        for off, dqp, deltas in RA_CTC_GOP:
            poc = base + off
            out.append((poc, dqp, [poc + d for d in deltas if poc + d >= 0]))
    return out


def _encode_in_worker(setup, ref_pics, frame, poc, dqp, refs, num_slices):
    """CtcEncoder._encode_picture in a worker process, on an encoder that
    holds only the picture's references."""
    cls, sps, pps, qp, seed, full_search = setup
    enc = cls(sps, pps, qp=qp, seed=seed, full_mode_search=full_search)
    enc.refs = list(ref_pics)
    return enc._encode_picture(frame, poc, dqp, refs, num_slices)


def _write_vps(w: BitWriter, sps: SPS) -> None:
    """hls.params.write_vps with the SPS's DPB sizes (the VPS bounds the
    SPS's)."""
    w.u(0, 4)   # vps_video_parameter_set_id
    w.u(3, 2)   # vps_reserved_three_2bits
    w.u(0, 6)   # vps_max_layers_minus1
    w.u(0, 3)   # vps_max_sub_layers_minus1
    w.u(1, 1)   # vps_temporal_id_nesting_flag
    w.u(0xFFFF, 16)  # vps_reserved_0xffff_16bits
    write_profile_tier_level(w)
    w.u(1, 1)   # vps_sub_layer_ordering_info_present_flag
    w.ue(sps.max_dec_pic_buffering - 1)
    w.ue(sps.num_reorder_pics)
    w.ue(0)     # vps_max_latency_increase_plus1
    w.u(0, 6)   # vps_max_layer_id
    w.ue(0)     # vps_num_layer_sets_minus1
    w.u(0, 1)   # vps_timing_info_present_flag
    w.u(0, 1)   # vps_extension_flag
    w.rbsp_trailing_bits()


class CtcEncoder(Encoder):
    """The test encoder with the CTC's RA GOP, AMP, ref_idx 1, bi-predicted
    2-PU partitions and TMVP from L1."""

    def encode_sequence(self, frames, structure: str = "RA-CTC",
                        num_slices: int = 1, jobs: int = 1):
        """"RA-CTC": (stream, recon list in POC order); any other
        structure as `Encoder` codes it.  With `jobs` > 1 the pictures
        whose references are all coded are encoded in that many worker
        processes at once (a picture's bytes depend only on its
        references, its POC and the seed, so the stream is the same)."""
        if structure != "RA-CTC":
            return super().encode_sequence(frames, structure, num_slices)
        sched = ra_ctc_schedule(len(frames))
        out = parameter_sets(self.sps, self.pps)
        if jobs > 1:
            coded = self._encode_parallel(frames, sched, num_slices, jobs)
        else:
            coded = {poc: self._encode_picture(frames[poc], poc, dqp, refs,
                                               num_slices)
                     for poc, dqp, refs in sched}
        out += b"".join(coded[poc][0] for poc, _, _ in sched)
        return out, [coded[p][1].planes for p in sorted(coded)]

    def _encode_picture(self, frame, poc, dqp, refs, num_slices):
        """One picture at the base QP plus `dqp`, every reference used ->
        (NAL bytes, its reference record).  The GOP table keeps in each
        picture's reference set every coded picture a later one uses, so
        no picture is kept with used flag 0."""
        base_qp = self.qp
        self.qp = base_qp + dqp
        try:
            nb, _, _, _ = self.encode_frame(
                frame, poc=poc, slice_type=SLICE_B if refs else SLICE_I,
                used_pocs=refs, n_ref=N_REF, num_slices=num_slices)
        finally:
            self.qp = base_qp
        return nb, self.refs[-1]

    def _encode_parallel(self, frames, sched, num_slices, jobs) -> dict:
        """encode_sequence's pictures over `jobs` processes, each picture
        submitted once its references are coded: poc -> (NAL bytes,
        reference record)."""
        import multiprocessing
        from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor
        from concurrent.futures import wait as wait_for
        setup = (type(self), self.sps, self.pps, self.qp, self.seed,
                 self.full_search)
        coded, running = {}, {}
        todo = list(sched)
        with ProcessPoolExecutor(
                jobs, mp_context=multiprocessing.get_context("spawn")) as ex:
            while todo or running:
                for pic in [p for p in todo if set(p[2]) <= set(coded)]:
                    poc, dqp, refs = pic
                    todo.remove(pic)
                    running[ex.submit(
                        _encode_in_worker, setup,
                        [coded[r][1] for r in refs], frames[poc], poc, dqp,
                        refs, num_slices)] = poc
                done, _ = wait_for(running, return_when=FIRST_COMPLETED)
                for fut in done:
                    coded[running.pop(fut)] = fut.result()
        return coded

    def _make_mctx(self, sh, poc, l0_pocs, l1_pocs):
        if sh.slice_type == SLICE_B:
            sh.collocated_from_l0 = False
        return super()._make_mctx(sh, poc, l0_pocs, l1_pocs)

    # -- the hooks of Encoder's inter CU planning ----------------------------
    def _ref_of(self, lx: int) -> int:
        """ref_idx 1 for a seeded share of the lists that have two."""
        two = len(self.mctx.list_pocs[lx]) > 1
        return 1 if two and self.rng.random() < REF1_SHARE else 0

    def _pick_part(self, size: int) -> str:
        """2NxN, Nx2N, and with AMP at 16x16 and 32x32 its four shapes."""
        shapes = ("2NxN", "Nx2N")
        if self.sps.amp_enabled and size >= 16:
            shapes += AMP_PARTS
        return shapes[int(self.rng.integers(0, len(shapes)))]

    def _search_pu(self, x, y, w, h, is_b):
        """A PU of a 2-PU partition searches as a 2Nx2N PU does: uni L0, uni
        L1 or bi."""
        return self._search(x, y, w, h, is_b)
