# Copy of p265_tpu/plan/frame_plan.py.  Deviation: the device_mc option and
# its branches are gone (they imported the JAX MC).  build_tensor_plan
# keeps the host MC of golden/recon.py; attach_pred_planes takes a device
# and always uses the port's device MC (kernels/mc.py
# build_inter_pred_device: K2 plus the PCM stamp), so its inter_pred
# planes are int32 tensors on that device.
"""Frame-plan tensorization (Stage A output -> Stage B input, SURVEY.md 7.1).

Turns the parsed FramePlan (TU records in z-order) into dense, fixed-shape,
size-bucketed tensors plus a wavefront schedule:

- every TU gets a wavefront step: step = 1 + max(step of producers of every
  reference sample it reads).  TUs within a step are independent and run
  batched on the TPU (SURVEY.md 7.4).
- intra reference availability + substitution (spec 8.4.4.2.2) are resolved
  HERE into per-TU gather coordinate tables: ref i reads plane[ys[i], xs[i]],
  or the mid-value 128 when no reference exists.  This erases all
  data-dependent control flow before XLA sees anything.

All arrays NumPy here; pipeline/decoder.py ships them to the device.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from p265_tpu_torch.syntax.ctu import FramePlan
from p265_tpu_torch.golden.recon import tu_qp
from p265_tpu_torch.tables import INTRA_ANGLE, INTRA_HOR_VER_DIST_THRES, INV_ANGLE

LOG2_SIZES = (2, 3, 4, 5)


@dataclass
class TuBatch:
    """All TUs of one size in one plane-group, with per-step slices."""
    size: int
    # per-TU data, ordered by step
    pos: np.ndarray        # [n, 2] (y, x) in plane coords
    step: np.ndarray       # [n]
    coeffs: np.ndarray     # [n, s, s] int32 quantized levels (0 if pred_only)
    qp: np.ndarray         # [n] effective (chroma-mapped) qp
    mode: np.ndarray       # [n]
    c_idx: np.ndarray      # [n]
    is_dst: np.ndarray     # [n] bool
    tskip: np.ndarray      # [n] bool
    has_res: np.ndarray    # [n] bool
    bypass: np.ndarray     # [n] bool: levels are the residual (lossless CU)
    scale_m: np.ndarray | None  # [n, s, s] dequant matrices (None = flat 16)
    inter: np.ndarray      # [n] bool: prediction comes from the MC pred plane
    filter_flag: np.ndarray    # [n] bool ([1 2 1] smoothing)
    strong_allowed: np.ndarray  # [n] bool (32x32 luma + sps flag)
    dc_edge: np.ndarray    # [n] bool (luma, size<32 DC/10/26 edge filters)
    ref_ys: np.ndarray     # [n, 2*(2s+1)] gather rows (left block then top block)
    ref_xs: np.ndarray     # [n, 2*(2s+1)]
    ref_ok: np.ndarray     # [n, 2*(2s+1)] bool: False -> constant 128
    # RAW (pre-substitution) availability in spec search order
    # (bottom-left .. corner .. top-right), for in-kernel substitution
    ok_scan: np.ndarray = None   # [n, 4s+1] bool


@dataclass
class PlanePlan:
    plane_idx: int         # 0 luma, 1 cb, 2 cr
    shape: tuple[int, int]
    n_steps: int
    batches: dict[int, TuBatch] = field(default_factory=dict)  # by log2
    inter_pred: np.ndarray | None = None   # MC prediction plane (P/B frames)


@dataclass
class TensorPlan:
    planes: list[PlanePlan]
    frame_plan: FramePlan


def _filter_flag(mode: int, size: int, c_idx: int) -> bool:
    if c_idx != 0 or mode == 1 or size == 4:
        return False
    min_dist = min(abs(mode - 26), abs(mode - 10))
    return min_dist > INTRA_HOR_VER_DIST_THRES.get(size, 10)


def _expand_large(tus):
    """Split pred-only records larger than 32x32 (64x64 skip CUs) into four
    quadrant records so every record fits a TuBatch bucket."""
    from p265_tpu_torch.syntax.ctu import TuRec
    out = []
    for t in tus:
        if t.log2 <= 5:
            out.append(t)
            continue
        assert t.pred_only and t.is_inter
        half = 1 << (t.log2 - 1)
        for dy in (0, half):
            for dx in (0, half):
                out.append(TuRec(t.x + dx, t.y + dy, t.log2 - 1, t.c_idx,
                                 t.mode, None, qp=t.qp, pred_only=True,
                                 is_inter=True, tile=t.tile,
                                 slice_idx=t.slice_idx))
    return out


def build_tensor_plan(plan: FramePlan, refs: dict | None = None,
                      pred_planes: list | None = None,
                      skip_pred: bool = False) -> TensorPlan:
    """skip_pred: build the (purely syntax-derived) buckets WITHOUT the MC
    prediction planes -- used to tensorize at parse time, before reference
    pixels exist; attach_pred_planes fills them in at reconstruction time."""
    ns = getattr(plan, "nstate", None)
    if ns is not None:
        # native Stage-A parse already emitted the bucketed records; motion
        # replay (ns.finalize) has populated plan.pus for inter pictures
        assert not plan.tus, "mixed native/python parse in one picture"
        plan._has_pcm = False          # PCM slices fall back to Python parse
        plan._needs_pred = bool(plan.pus)
        tp = ns.tensor_plan(plan)
        if plan._needs_pred and not skip_pred:
            pred = pred_planes
            if pred is None:
                from p265_tpu_torch.golden.recon import build_inter_pred
                pred = build_inter_pred(plan, refs or {})
            for pp, pl in zip(tp.planes, pred):
                pp.inter_pred = pl
        return tp
    sps = plan.sps
    w, h = sps.pic_width, sps.pic_height
    shapes = [(h, w), (h >> 1, w >> 1), (h >> 1, w >> 1)]
    inter_pred = pred_planes
    if skip_pred:
        inter_pred = None
    elif inter_pred is None and (plan.pus or any(t.pcm for t in plan.tus)):
        from p265_tpu_torch.golden.recon import build_inter_pred
        inter_pred = build_inter_pred(plan, refs or {})
    plan._has_pcm = any(t.pcm for t in plan.tus)
    plan._needs_pred = bool(plan.pus) or plan._has_pcm
    planes = []
    for p_idx in range(3):
        ph, pw = shapes[p_idx]
        g_h, g_w = (ph + 3) >> 2, (pw + 3) >> 2
        avail = np.zeros((g_h, g_w), bool)
        prod_step = np.zeros((g_h, g_w), np.int32)  # step of producing TU
        tus = _expand_large([t for t in plan.tus if t.c_idx == p_idx])
        per_tu = []
        cur_tile = 0
        cur_slice = 0
        for t in tus:
            if t.tile != cur_tile or t.slice_idx != cur_slice:
                cur_tile = t.tile
                cur_slice = t.slice_idx
                avail[:] = False  # no prediction across tile/slice boundaries
            size = 1 << t.log2
            n = size
            if t.is_inter:
                # MC prediction: no in-frame reference dependency
                nref2 = 2 * (2 * n + 1)
                ys = np.zeros(nref2, np.int32)
                xs = np.zeros(nref2, np.int32)
                okv = np.zeros(nref2, bool)
                step = 1
                per_tu.append((t, step, ys, xs, okv,
                               np.zeros(4 * n + 1, bool)))
                y1 = min(t.y + size, ph)
                x1 = min(t.x + size, pw)
                avail[t.y >> 2:(y1 + 3) >> 2, t.x >> 2:(x1 + 3) >> 2] = True
                prod_step[t.y >> 2:(y1 + 3) >> 2, t.x >> 2:(x1 + 3) >> 2] = step
                continue
            # reference search order: p[-1][2N-1]..p[-1][-1], p[0..2N-1][-1]
            coords = ([(t.x - 1, t.y + i) for i in range(2 * n - 1, -1, -1)]
                      + [(t.x - 1, t.y - 1)]
                      + [(t.x + i, t.y - 1) for i in range(2 * n)])
            oks, srcs = [], []
            for (x, y) in coords:
                ok = 0 <= x < pw and 0 <= y < ph and avail[y >> 2, x >> 2]
                oks.append(ok)
                srcs.append((x, y) if ok else None)
            if any(oks):
                # substitution: forward-fill from search order (first entry
                # takes the first available source)
                if srcs[0] is None:
                    srcs[0] = srcs[next(i for i, o in enumerate(oks) if o)]
                for i in range(1, len(srcs)):
                    if srcs[i] is None:
                        srcs[i] = srcs[i - 1]
                ok_any = True
            else:
                ok_any = False
            # repackage into left[0..2N], top[0..2N] order (corner at idx 0)
            n4 = 4 * n + 1
            corner_src = srcs[2 * n] if ok_any else None
            left_srcs = [corner_src] + [srcs[2 * n - 1 - i] for i in range(2 * n)]
            top_srcs = [corner_src] + [srcs[2 * n + 1 + i] for i in range(2 * n)]
            all_srcs = left_srcs + top_srcs
            ys = np.array([s[1] if s else 0 for s in all_srcs], np.int32)
            xs = np.array([s[0] if s else 0 for s in all_srcs], np.int32)
            okv = np.array([s is not None for s in all_srcs], bool)
            # wavefront step: 1 + max over producer steps of read samples
            dep = 0
            for s in all_srcs:
                if s is not None:
                    dep = max(dep, int(prod_step[s[1] >> 2, s[0] >> 2]))
            step = dep + 1
            per_tu.append((t, step, ys, xs, okv, np.array(oks, bool)))
            # mark this TU's samples
            y1 = min(t.y + size, ph)
            x1 = min(t.x + size, pw)
            avail[t.y >> 2:(y1 + 3) >> 2, t.x >> 2:(x1 + 3) >> 2] = True
            prod_step[t.y >> 2:(y1 + 3) >> 2, t.x >> 2:(x1 + 3) >> 2] = step

        n_steps = max((s for _, s, *_ in per_tu), default=0)
        pp = PlanePlan(p_idx, shapes[p_idx], n_steps,
                       inter_pred=None if inter_pred is None else inter_pred[p_idx])
        for log2 in LOG2_SIZES:
            size = 1 << log2
            rows = [r for r in per_tu if r[0].log2 == log2]
            if not rows:
                continue
            rows.sort(key=lambda r: r[1])
            m = len(rows)
            nref = 2 * (2 * size + 1)
            b = TuBatch(
                size=size,
                pos=np.array([[t.y, t.x] for t, *_ in rows], np.int32),
                step=np.array([s for _, s, *_ in rows], np.int32),
                coeffs=np.stack([
                    (t.levels if (t.levels is not None and not t.pred_only)
                     else np.zeros((size, size), np.int32)) for t, *_ in rows]),
                qp=np.array([tu_qp(plan, p_idx, t.qp) for t, *_ in rows], np.int32),
                mode=np.array([t.mode for t, *_ in rows], np.int32),
                c_idx=np.full(m, p_idx, np.int32),
                is_dst=np.array([p_idx == 0 and t.log2 == 2 and not t.is_inter
                                 for t, *_ in rows], bool),
                tskip=np.array([t.tskip for t, *_ in rows], bool),
                has_res=np.array([not t.pred_only for t, *_ in rows], bool),
                inter=np.array([t.is_inter for t, *_ in rows], bool),
                bypass=np.array([t.bypass for t, *_ in rows], bool),
                scale_m=(None if plan.scaling is None else np.stack(
                    [plan.scaling[(log2, t.matrix_id)] for t, *_ in rows])),
                filter_flag=np.array(
                    [_filter_flag(t.mode, size, p_idx) for t, *_ in rows], bool),
                strong_allowed=np.array(
                    [p_idx == 0 and size == 32 and sps.strong_intra_smoothing
                     and _filter_flag(t.mode, size, p_idx) for t, *_ in rows], bool),
                dc_edge=np.array(
                    [p_idx == 0 and size < 32 for t, *_ in rows], bool),
                ref_ys=np.stack([r[2] for r in rows]),
                ref_xs=np.stack([r[3] for r in rows]),
                ref_ok=np.stack([r[4] for r in rows]),
                ok_scan=np.stack([r[5] for r in rows]),
            )
            pp.batches[log2] = b
        planes.append(pp)
    return TensorPlan(planes, plan)


def attach_pred_planes(tplan: TensorPlan, refs: dict, device) -> None:
    """Fill the MC prediction planes of a tplan built with skip_pred=True,
    now that the reference pictures' pixels exist."""
    plan = tplan.frame_plan
    if not getattr(plan, "_needs_pred", False):
        return
    if all(pp.inter_pred is not None for pp in tplan.planes):
        return  # already attached
    from p265_tpu_torch.kernels.mc import build_inter_pred_device
    pred = build_inter_pred_device(plan, refs or {}, device)
    for pp, pl in zip(tplan.planes, pred):
        pp.inter_pred = pl
