"""Intra wavefront reconstruction over one tall merged plane.

Counterpart of p265_tpu/pipeline/wavefront.py.  The luma and chroma planes
of every frame of a batch fold into ONE tall plane (segments of height
h + GUARD, width max w), so same-size TUs of all planes share a bucket and
the number of sequential steps is the max, not the sum, over planes.
Every TU carries a wavefront step (1 + the max step of the TUs whose
samples it predicts from): the TUs of one step are independent.

The per-picture entry points `reconstruct_scan_plane`, `reconstruct_scan`
and `reconstruct_scan_frames` (counterparts of reconstruct_tpu_scan*) and
the batch and row-sharded paths all go through `run_scan`: the hoisted
inter TUs, the scan's residuals and the wavefront over one merged plane.

The wavefront itself, the counterpart of the JAX `_scan_plane` (one
`lax.scan` inside the per-picture device program), is `scan_plane`: it
packs the scan once (`pack_scan`) and, on a CUDA plane, walks every step in
ONE launch of csrc/scan.cu (`scan_packed`: one thread-block cluster, a
warp per TU, the hardware cluster barrier between steps); on a CPU plane
it runs the
plain version, `scan_packed_ref`, over the same packed record.

The kernels read the fields as a dispatch stages them, at the reference's
wire dtypes (coordinates at `coord_dtype`, mode uint8, levels int16, qp
and scale_m uint8, flags as bytes): K1 and the scan kernel refuse any
other dtype, and only the plain versions widen (kernels/staging.py
`widen`).  The hoisted inter TUs reach the plane through K1's plane
epilogue (`init_plane`: the residual added to the prediction at each TU
and clipped, in place).

Shapes are exact.  The JAX package padded them to a power-of-two ladder so
XLA would not recompile; eager torch has no compile to protect, so each
step works on exactly its own TUs (a slice of the step-ordered arrays) and
no pad lanes exist.  Host halves are NumPy copies (the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from p265_tpu_torch.plan.frame_plan import PlanePlan, TensorPlan, TuBatch
from p265_tpu_torch.kernels import _build, intra, itransform
from p265_tpu_torch.kernels.staging import stage, widen
from p265_tpu_torch.tables import INTRA_ANGLE, INV_ANGLE

GUARD = 32

# per-TU fields of a scan bucket, as stack_plane emits them
SCAN_FIELDS = ("pos", "ref_ys", "ref_xs", "ref_ok", "mode", "filter_flag",
               "strong_allowed", "dc_edge", "coeffs", "qp", "is_dst",
               "tskip", "bypass", "scale_m")

_SCAN_KEEP = ("pos", "step", "coeffs", "qp", "mode", "c_idx", "is_dst",
              "tskip", "has_res", "bypass", "scale_m", "inter",
              "filter_flag", "strong_allowed", "dc_edge", "ref_ys", "ref_xs",
              "ref_ok", "ok_scan")


def segment_offsets(pps_: list) -> list:
    """First row of each PlanePlan's segment in merge_segments' plane."""
    offs, off = [], 0
    for pp in pps_:
        offs.append(off)
        off += pp.shape[0] + GUARD
    return offs


def merge_segments(pps_: list):
    """Fold PlanePlans of arbitrary shapes into one tall PlanePlan, each
    input at a row offset of the heights (plus GUARD) before it.

    Copy of the JAX _merge_segments without a ShapePolicy and without the
    dense host prediction plane (the port always computes MC on the
    device)."""
    pw = max(pp.shape[1] for pp in pps_)
    offs = segment_offsets(pps_)
    total_h = offs[-1] + pps_[-1].shape[0]
    n_steps = max(pp.n_steps for pp in pps_)
    merged = PlanePlan(0, (total_h, pw), n_steps)
    all_sizes = sorted({log2 for pp in pps_ for log2 in pp.batches})
    for log2 in all_sizes:
        parts = []
        for pp, off in zip(pps_, offs):
            b = pp.batches.get(log2)
            if b is None:
                continue
            pos = b.pos.copy()
            pos[:, 0] += off
            rys = b.ref_ys + off  # invalid refs are gated by ref_ok
            parts.append((b, pos, rys))
        if not parts:
            continue
        order = np.argsort(
            np.concatenate([b.step for b, _, _ in parts]), kind="stable")

        def cat(key):
            return np.concatenate([getattr(b, key) for b, _, _ in parts])[order]

        merged.batches[log2] = TuBatch(
            size=1 << log2,
            pos=np.concatenate([p for _, p, _ in parts])[order],
            step=cat("step"), coeffs=cat("coeffs"), qp=cat("qp"),
            mode=cat("mode"), c_idx=cat("c_idx"), is_dst=cat("is_dst"),
            tskip=cat("tskip"), has_res=cat("has_res"), bypass=cat("bypass"),
            scale_m=(None if all(b.scale_m is None for b, _, _ in parts)
                     else np.concatenate(
                         [b.scale_m if b.scale_m is not None
                          else np.full((len(b.step), 1 << log2, 1 << log2),
                                       16, np.int32)
                          for b, _, _ in parts])[order]),
            inter=cat("inter"), filter_flag=cat("filter_flag"),
            strong_allowed=cat("strong_allowed"), dc_edge=cat("dc_edge"),
            ref_ys=np.concatenate([r for _, _, r in parts])[order],
            ref_xs=cat("ref_xs"), ref_ok=cat("ref_ok"),
            ok_scan=cat("ok_scan"),
        )
    return merged


def coord_dtype(shape) -> type:
    """The wire dtype of the coordinates of a tall plane of `shape` (rows,
    pw), the reference's rule (p265_tpu/pipeline/wavefront.py
    _stack_plane): uint16 while the rows, the guard rows included, and
    the width stay below 65000, else int32."""
    ph, pw = shape
    return np.uint16 if max(ph + GUARD, pw) < 65000 else np.int32


def stack_plane(pp: PlanePlan) -> dict:
    """Host: per-size compact per-TU arrays of the scan, in step order.

    Returns {log2: fields} with the SCAN_FIELDS (scale_m only where a
    scaling list is in use) plus `starts` [n_steps+1] int64, host only:
    the TUs of wavefront step k+1 are rows starts[k]:starts[k+1].  The
    fields travel at the reference's wire dtypes: coordinates (pos, ref_ys,
    ref_xs) at coord_dtype, mode, qp and scale_m uint8, coeffs int16, the
    flags bool; the kernels read them at these dtypes."""
    cdt = coord_dtype(pp.shape)
    out = {}
    for log2, b in pp.batches.items():
        d = dict(
            starts=np.searchsorted(b.step, np.arange(1, pp.n_steps + 2)
                                   ).astype(np.int64),
            pos=b.pos.astype(cdt),
            ref_ys=b.ref_ys.astype(cdt),
            ref_xs=b.ref_xs.astype(cdt),
            ref_ok=b.ref_ok.astype(bool),
            mode=b.mode.astype(np.uint8),
            filter_flag=b.filter_flag.astype(bool),
            strong_allowed=b.strong_allowed.astype(bool),
            dc_edge=b.dc_edge.astype(bool),
            coeffs=b.coeffs.astype(np.int16),
            qp=b.qp.astype(np.uint8),
            is_dst=b.is_dst.astype(bool),
            tskip=b.tskip.astype(bool),
            bypass=b.bypass.astype(bool),
        )
        if b.scale_m is not None:
            d["scale_m"] = b.scale_m.astype(np.uint8)
        out[log2] = d
    return out


def expand(tu: dict) -> dict:
    """Device: residuals (dequant + inverse transform) of every scan TU, in
    ONE K1 launch, beside the staged fields the scan reads.

    tu: {log2: fields} as stack_plane gives them, as device tensors at
    their wire dtypes.  Returns {log2: dict(ref_ys, ref_xs [n, 2(2s+1)]
    and pos [n, 2] at coord_dtype, ref_ok, mode uint8, filter_flag,
    strong_allowed, dc_edge, residual [n, s, s] int32)}: the staged
    fields as they are, no cast."""
    res = itransform.batch_residual_grouped(tu)
    return {log2: dict({k: d[k] for k in _SCAN_READS}, residual=res[log2])
            for log2, d in tu.items()}


def ref_index(d: dict, pw: int) -> torch.Tensor:
    """The flat indices ref_ys * pw + ref_xs [n, 2(2s+1)] int64 of a scan
    bucket's references in a plane of width pw (the plain version's; the
    kernel forms them itself)."""
    return widen(d["ref_ys"], torch.int64) * pw + widen(d["ref_xs"],
                                                          torch.int64)


# the kernel's per-bucket fields, in the column order of its table, with
# their dtypes (None: the launch's coordinate dtype, uint16 or int32) and
# their shapes per TU (s: the TU's size)
_PACK_FIELDS = (
    ("ref_ys", None, lambda s: (4 * s + 2,)),
    ("ref_xs", None, lambda s: (4 * s + 2,)),
    ("ref_ok", torch.bool, lambda s: (4 * s + 2,)),
    ("mode", torch.uint8, lambda s: ()),
    ("filter_flag", torch.bool, lambda s: ()),
    ("strong_allowed", torch.bool, lambda s: ()),
    ("dc_edge", torch.bool, lambda s: ()),
    ("pos", None, lambda s: (2,)),
    ("residual", torch.int32, lambda s: (s, s)),
)
# the staged fields of a scan TU that expand() hands the scan
_SCAN_READS = tuple(k for k, _, _ in _PACK_FIELDS if k != "residual")
_COORDS = (torch.uint16, torch.int32)
# the scan kernel's launch shape, csrc/scan.cu's (kCtas, kWarps): one
# cluster of 16 CTAs of 16 warps, 256 warps, so every TU of the widest step
# of a 1080p I picture (66 TUs) has a warp of its own (a 16x16 TU takes
# two, a 32x32 TU eight); chosen from the shapes that profile_scan.py times
# on an H100 (PERF.md)
SCAN_SHAPE = (16, 16)
# intraPredAngle, then invAngle, per mode 0..34 (the kernel's angle table)
_ANGLES = np.zeros(70, np.int32)
_ANGLES[2:35] = INTRA_ANGLE
_ANGLES[35 + 11:35 + 26] = INV_ANGLE


@dataclasses.dataclass
class ScanPack:
    """The argument record of one scan, built once by pack_scan.

    buckets: {log2: expand()'s fields}, ascending log2; starts: int32
    [n_buckets, n_steps + 1] on the plane's device, the TUs of step k of
    bucket i being rows starts[i][k]:starts[i][k+1]; step_tus: host [n_steps]
    TUs a step over all buckets; table: host int64 [n_buckets, 10], the
    kernel's per-bucket pointers and log2, and coord_wide whether its
    coordinates are int32 (else uint16) (CUDA only: None and False)."""
    buckets: dict
    starts: torch.Tensor
    step_tus: np.ndarray
    n_steps: int
    table: np.ndarray | None
    coord_wide: bool = False


def step_starts(starts: dict, n_steps: int) -> np.ndarray:
    """The host step starts {log2: [n_steps+1]} -> int32 [n_buckets,
    n_steps+1] in ascending log2, the layout ScanPack.starts has on the
    device (stage it with the dispatch's arrays)."""
    return (np.stack([starts[k] for k in sorted(starts)]).astype(np.int32)
            if starts else np.zeros((0, n_steps + 1), np.int32))


def pack_scan(stacked: dict, starts: dict, n_steps: int, device,
              starts_dev=None) -> ScanPack:
    """expand()'s output and the host step starts {log2: int64
    [n_steps+1]} -> the scan's ScanPack.  starts_dev: the same starts
    already on `device` (step_starts(), staged with the dispatch); None
    stages them here.  On a CUDA device every field must have the dtype
    (the wire dtypes of _PACK_FIELDS; one coordinate dtype, uint16 or
    int32, for every bucket), shape and device the kernel reads; a
    mismatch raises (nothing is cast)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    buckets = dict(sorted(stacked.items()))
    st = step_starts({log2: starts[log2] for log2 in buckets}, n_steps)
    if starts_dev is None:
        starts_dev = stage(st, device)
    elif (starts_dev.dtype != torch.int32 or starts_dev.device != device
          or tuple(starts_dev.shape) != st.shape):
        raise ValueError(f"pack_scan: starts_dev must be int32 {st.shape} "
                         f"on {device}, got {starts_dev.dtype} "
                         f"{tuple(starts_dev.shape)} on {starts_dev.device}")
    step_tus = (st[:, 1:] - st[:, :-1]).sum(0)
    table, coord = None, None
    if device.type == "cuda":
        table = np.zeros((len(buckets), 10), np.int64)
        for row, (log2, d) in enumerate(buckets.items()):
            s, n = 1 << log2, d["mode"].shape[0]
            if log2 not in (2, 3, 4, 5) or int(st[row, -1]) > n:
                raise ValueError(f"pack_scan: bucket log2={log2} with {n} "
                                 f"TUs, starts to {int(st[row, -1])}")
            if coord is None:
                coord = d["pos"].dtype
            if coord not in _COORDS:
                raise ValueError(f"pack_scan: coordinates must be one of "
                                 f"{_COORDS}, got {coord}")
            ptrs = []
            for name, dt, per in _PACK_FIELDS:
                t, dt = d[name], dt or coord
                if (t.dtype != dt or tuple(t.shape) != (n, *per(s))
                        or t.device != device or not t.is_contiguous()):
                    raise ValueError(
                        f"pack_scan: {name} must be contiguous {dt} "
                        f"{(n, *per(s))} on {device}, got {t.dtype} "
                        f"{tuple(t.shape)} on {t.device}")
                ptrs.append(t.data_ptr())
            table[row] = (*ptrs, log2)
    return ScanPack(buckets, starts_dev, step_tus, n_steps, table,
                    coord == torch.int32)


def scan_packed_ref(packed: ScanPack, plane, k0: int, k1: int):
    """Plain version of the scan kernel: steps k0..k1-1 of `packed` over
    `plane` [rows, pw] int32, in place.

    Every bucket of a step predicts from the SAME pre-step plane and all
    buckets land in ONE merged scatter (TUs of a step never overlap).
    Chroma TUs ride in the same buckets: their per-TU flags switch the
    luma-only smoothing and edge filters off (c_idx 0 semantics).  An
    unavailable reference is 128 and its index is never read.  The
    staged coordinates and modes are widened here (the kernel reads them
    as they are)."""
    flat = plane.view(-1)
    pw = plane.shape[1]
    starts = packed.starts.tolist()
    wide = {log2: (ref_index(d, pw), widen(d["mode"], torch.int64),
                   widen(d["pos"], torch.int64))
            for log2, d in packed.buckets.items()}
    for k in range(k0, k1):
        idx, val = [], []
        for (log2, d), st in zip(packed.buckets.items(), starts):
            a, b = st[k], st[k + 1]
            if a == b:
                continue
            s = 1 << log2
            ref_idx, mode, pos = (w[a:b] for w in wide[log2])
            ok = d["ref_ok"][a:b]
            refs = torch.where(ok, flat[torch.where(ok, ref_idx, 0)], 128)
            pred = intra.predict_from_refs(
                refs, mode, d["filter_flag"][a:b],
                d["strong_allowed"][a:b], s, 0, d["dc_edge"][a:b])
            ar = torch.arange(s, device=plane.device)
            idx.append(((pos[:, 0, None, None] + ar[None, :, None]) * pw
                        + pos[:, 1, None, None]
                        + ar[None, None, :]).reshape(-1))
            val.append((pred + d["residual"][a:b]).clamp(0, 255).reshape(-1))
        if idx:
            flat[torch.cat(idx)] = torch.cat(val)
    return plane


def scan_packed(packed: ScanPack, plane, k0: int, k1: int,
                barrier_only: bool = False):
    """The scan kernel (csrc/scan.cu): steps k0..k1-1 of `packed` over the
    CUDA plane [rows, pw] int32, in place, in ONE launch of one thread-block
    cluster (SCAN_SHAPE) on the current stream.  barrier_only walks the
    same steps and barriers and computes no TU (the floor of the step
    chain, for measurement).  A range or a launch the card refuses
    raises."""
    _scan_launch(packed, plane, k0, k1, barrier_only)
    _build.LAUNCHES["scan"] += 1
    return plane


def _scan_launch(packed: ScanPack, plane, k0: int, k1: int,
                 barrier_only: bool, defines: tuple = ()) -> None:
    """scan_packed's launch, uncounted, through the kernel library built
    with `defines` (profile_scan.py's other launch shapes)."""
    if (plane.dtype != torch.int32 or plane.dim() != 2
            or not plane.is_contiguous()
            or plane.device != packed.starts.device
            or packed.table is None):
        raise ValueError(f"scan: plane must be contiguous int32 [rows, pw] "
                         f"on {packed.starts.device}, got {plane.dtype} "
                         f"{tuple(plane.shape)} on {plane.device}")
    if not 0 <= k0 < k1 <= packed.n_steps:
        raise ValueError(f"scan: steps [{k0}, {k1}) outside "
                         f"[0, {packed.n_steps})")
    dev = plane.device
    lib = _build.library(defines)
    with torch.cuda.device(dev):
        err = lib.p265_scan(
            packed.table.ctypes.data, len(packed.buckets),
            packed.starts.data_ptr(), packed.n_steps + 1, k0, k1,
            plane.data_ptr(), plane.shape[1], int(packed.coord_wide),
            int(barrier_only),
            _ANGLES.ctypes.data, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "scan")


def scan_plane(stacked: dict, starts: dict, n_steps: int, plane,
               after_step=None, starts_dev=None):
    """Device: run the wavefront over `plane` [rows, pw] int32 in place.

    stacked: expand() output; starts: {log2: host int64 [n_steps+1]};
    starts_dev: pack_scan's.
    Packs the scan once (pack_scan), then runs it: on a CPU plane by the
    plain version, on a CUDA plane by the kernel (any other device
    raises).  Without after_step, one run over all the steps; with it,
    one run per step, each followed by after_step(plane), empty step or
    not (the row-sharded scan refreshes its halo rows there).  A scan
    with no size bucket runs nothing."""
    if plane.device.type not in ("cpu", "cuda"):
        raise ValueError(f"scan_plane: no scan for a plane on {plane.device}")
    run = scan_packed_ref if plane.device.type == "cpu" else scan_packed
    packed = pack_scan(stacked, starts, n_steps, plane.device, starts_dev)
    ranges = ([(0, n_steps)] if after_step is None
              else [(k, k + 1) for k in range(n_steps)])
    for k0, k1 in ranges:
        if packed.buckets and k1 > k0:
            run(packed, plane, k0, k1)
        if after_step is not None:
            after_step(plane)
    return plane


def hoist_inter(merged) -> dict | None:
    """Pull every inter-predicted TU out of the wavefront scan.

    Inter TUs read no in-picture samples (their prediction is the MC
    plane), so they all sit at step 1; applying them in one pass before
    the scan keeps the dependency order (intra readers of inter samples sit
    at step >= 2) and leaves the scan intra-only.  Mutates merged.batches
    in place; returns {log2: dict(pos, coeffs, qp, tskip, bypass
    [, scale_m])} of the inter TUs, at stack_plane's wire dtypes, or None
    when there are none."""
    cdt = coord_dtype(merged.shape)
    out = {}
    for log2, b in list(merged.batches.items()):
        m = np.asarray(b.inter)
        if not m.any():
            continue
        d = dict(pos=b.pos[m].astype(cdt),
                 coeffs=b.coeffs[m].astype(np.int16),
                 qp=b.qp[m].astype(np.uint8), tskip=b.tskip[m].astype(bool),
                 bypass=b.bypass[m].astype(bool))
        if b.scale_m is not None:
            d["scale_m"] = b.scale_m[m].astype(np.uint8)
        out[log2] = d
        keep = ~m
        merged.batches[log2] = dataclasses.replace(
            b, **{f: (None if getattr(b, f) is None else getattr(b, f)[keep])
                  for f in _SCAN_KEEP})
    return out or None


def init_plane(itu, pred, shape, device):
    """Device: the plane [rows, pw] int32 before the scan.  With hoisted
    inter TUs (itu: hoist_inter's dict as staged, or None), the prediction
    plane `pred` (updated in place), or zeros, with each TU's residual
    added at its position and clipped to 0..255 by ONE K1 launch (its
    plane epilogue, all sizes); without, zeros.  Intra regions keep values
    that the scan overwrites.  A CPU plane takes init_plane_ref, which
    equals it wherever pred holds samples (0..255)."""
    if torch.device(device).type == "cpu":
        return init_plane_ref(itu, pred, shape, device)
    if itu is None or pred is None:
        plane = torch.zeros(shape, dtype=torch.int32, device=device)
    else:
        plane = pred
    if itu is not None:
        itransform.batch_residual_grouped(itu, plane=plane)
    return plane


def init_plane_ref(itu, pred, shape, device):
    """Plain version of init_plane, the reference's composition: the
    residuals of the hoisted inter TUs (one K1 call, its plain version on
    CPU tensors) and one scatter into a zero plane, then clip(pred +
    residual) over the whole plane; zeros without inter TUs."""
    plane = torch.zeros(shape, dtype=torch.int32, device=device)
    if itu is None:
        return plane
    pw = shape[1]
    res = itransform.batch_residual_grouped(itu)
    idx, val = [], []
    for log2, d in itu.items():
        ar = torch.arange(1 << log2, device=device)
        pos = widen(d["pos"], torch.int64)
        idx.append(((pos[:, 0, None, None] + ar[None, :, None]) * pw
                    + pos[:, 1, None, None]
                    + ar[None, None, :]).reshape(-1))
        val.append(res[log2].reshape(-1))
    res_plane = torch.zeros_like(plane).view(-1)
    res_plane[torch.cat(idx)] = torch.cat(val)
    base = pred if pred is not None else plane
    return (base + res_plane.view(shape)).clamp(0, 255)


def scan_fields(tu: dict) -> tuple:
    """stack_plane's output -> (the per-TU arrays to stage, the host
    `starts` {log2: [n_steps+1]})."""
    return ({log2: {k: v for k, v in d.items() if k != "starts"}
             for log2, d in tu.items()},
            {log2: d["starts"] for log2, d in tu.items()})


def run_scan(itu, fields, starts: dict, n_steps: int, pred, shape, device,
             after_step=None, starts_dev=None):
    """Device: the whole reconstruction of one merged plane.  The hoisted
    inter TUs (one K1 launch) over the prediction plane `pred` (or None),
    then the residuals of the scan's TUs (one K1 launch) and the wavefront.
    itu and fields are device tensors (hoist_inter's and scan_fields'
    outputs after stage()); starts_dev as pack_scan's.  Returns the plane
    [shape] int32."""
    plane = init_plane(itu, pred, shape, device)
    return scan_plane(expand(fields), starts, n_steps, plane, after_step,
                      starts_dev=starts_dev)


# ---------------------------------------------------------------------------
# per-picture entry points: tensor plans -> prefilter planes, no filters
# ---------------------------------------------------------------------------


def attached_pred(pps_: list, offs: list, shape, device):
    """Device: the prediction plane [shape] int32 that holds every
    PlanePlan's attached inter_pred (numpy or tensor; build_tensor_plan or
    attach_pred_planes put it there) at its segment's first row offs[i];
    None when no PlanePlan has one."""
    if all(pp.inter_pred is None for pp in pps_):
        return None
    pred = torch.zeros(shape, dtype=torch.int32, device=device)
    for pp, off in zip(pps_, offs):
        if pp.inter_pred is not None:
            h, w = pp.shape
            pred[off:off + h, :w] = torch.as_tensor(pp.inter_pred).to(
                device=device, dtype=torch.int32)
    return pred


def _reconstruct_merged(pps_: list, device) -> list:
    """One scan over the merged segments of any PlanePlans -> their planes
    (int32 tensors on `device`, input order).  A PlanePlan's attached
    inter_pred is the prediction of its inter TUs."""
    device = torch.device(device)
    merged = merge_segments(pps_)
    if not merged.batches:
        return [torch.zeros(pp.shape, dtype=torch.int32, device=device)
                for pp in pps_]
    offs = segment_offsets(pps_)
    total_h, pw = merged.shape
    shape = (total_h + GUARD, pw)
    pred = attached_pred(pps_, offs, shape, device)
    itu = hoist_inter(merged)
    fields, starts = scan_fields(stack_plane(merged))
    dev = stage(dict(itu=itu, tu=fields,
                     starts=step_starts(starts, merged.n_steps)), device)
    plane = run_scan(dev["itu"], dev["tu"], starts, merged.n_steps, pred,
                     shape, device, starts_dev=dev["starts"])
    return [plane[off:off + pp.shape[0], :pp.shape[1]]
            for pp, off in zip(pps_, offs)]


def reconstruct_scan_plane(pp: PlanePlan, device):
    """The scan of a single PlanePlan -> its plane, int32 on `device`.
    Counterpart of reconstruct_tpu_scan_plane."""
    return _reconstruct_merged([pp], device)[0]


def reconstruct_scan(tplan: TensorPlan, device) -> list:
    """One picture's tensor plan -> its [y, cb, cr] prefilter planes (int32
    on `device`), the three planes in one merged scan.  Counterpart of
    reconstruct_tpu_scan."""
    return _reconstruct_merged(tplan.planes, device)


def reconstruct_scan_frames(tplans: list, device) -> list:
    """F tensor plans -> per frame [y, cb, cr] prefilter planes; frames may
    differ in resolution, all 3F planes share one scan.  Counterpart of
    reconstruct_tpu_scan_frames."""
    flat = _reconstruct_merged([pp for tp in tplans for pp in tp.planes],
                               device)
    return [flat[3 * f:3 * f + 3] for f in range(len(tplans))]
