"""Intra wavefront reconstruction over one tall merged plane.

Counterpart of p265_tpu/pipeline/wavefront.py.  The luma and chroma planes
of every frame of a batch fold into ONE tall plane (segments of height
h + GUARD, width max w), so same-size TUs of all planes share a bucket and
the number of sequential steps is the max, not the sum, over planes.
Every TU carries a wavefront step (1 + the max step of the TUs whose
samples it predicts from): the TUs of one step are independent.

Shapes are exact.  The JAX package padded them to a power-of-two ladder so
XLA would not recompile; eager torch has no compile to protect, so each
step works on exactly its own TUs (a slice of the step-ordered arrays) and
no pad lanes exist.  Host halves are NumPy copies (the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import numpy as np
import torch

from p265_tpu_torch.plan.frame_plan import PlanePlan, TuBatch
from p265_tpu_torch.kernels import intra
from p265_tpu_torch.kernels import itransform

GUARD = 32

# per-TU fields of a scan bucket, as stack_plane emits them
SCAN_FIELDS = ("pos", "ref_ys", "ref_xs", "ref_ok", "mode", "filter_flag",
               "strong_allowed", "dc_edge", "coeffs", "qp", "is_dst",
               "tskip", "bypass", "scale_m")


def merge_segments(pps_: list):
    """Fold PlanePlans of arbitrary shapes into one tall PlanePlan, each
    input at a row offset of the heights (plus GUARD) before it.

    Copy of the JAX _merge_segments without a ShapePolicy and without the
    dense host prediction plane (the port always computes MC on the
    device)."""
    pw = max(pp.shape[1] for pp in pps_)
    offs = []
    off = 0
    for pp in pps_:
        offs.append(off)
        off += pp.shape[0] + GUARD
    total_h = off - GUARD
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


def stack_plane(pp: PlanePlan) -> dict:
    """Host: per-size compact per-TU arrays of the scan, in step order.

    Returns {log2: fields} with the SCAN_FIELDS (scale_m only where a
    scaling list is in use) plus `starts` [n_steps+1] int64: the TUs of
    wavefront step k+1 are rows starts[k]:starts[k+1].  Coordinates are
    int64, ready to index with; coefficients travel as int16."""
    out = {}
    for log2, b in pp.batches.items():
        d = dict(
            starts=np.searchsorted(b.step, np.arange(1, pp.n_steps + 2)
                                   ).astype(np.int64),
            pos=b.pos.astype(np.int64),
            ref_ys=b.ref_ys.astype(np.int64),
            ref_xs=b.ref_xs.astype(np.int64),
            ref_ok=b.ref_ok.astype(bool),
            mode=b.mode.astype(np.int32),
            filter_flag=b.filter_flag.astype(bool),
            strong_allowed=b.strong_allowed.astype(bool),
            dc_edge=b.dc_edge.astype(bool),
            coeffs=b.coeffs.astype(np.int16),
            qp=b.qp.astype(np.int32),
            is_dst=b.is_dst.astype(bool),
            tskip=b.tskip.astype(bool),
            bypass=b.bypass.astype(bool),
        )
        if b.scale_m is not None:
            d["scale_m"] = b.scale_m.astype(np.int32)
        out[log2] = d
    return out


def expand(tu: dict, pw: int) -> dict:
    """Device: residuals (dequant + inverse transform) of every scan TU,
    and flat gather/scatter indices into the tall plane [*, pw].

    tu: {log2: fields} as stack_plane gives them, as device tensors.
    Returns {log2: dict(ref_idx, ref_ok, mode, filter_flag, strong_allowed,
    dc_edge, out_idx [n, s*s], residual [n, s, s])}."""
    out = {}
    res = itransform.batch_residual_grouped(tu)   # all sizes, one launch
    for log2, d in tu.items():
        s = 1 << log2
        dev = d["pos"].device
        ar = torch.arange(s, device=dev)
        oi = ((d["pos"][:, 0, None, None] + ar[None, :, None]) * pw
              + d["pos"][:, 1, None, None] + ar[None, None, :])
        out[log2] = dict(
            ref_idx=d["ref_ys"] * pw + d["ref_xs"], ref_ok=d["ref_ok"],
            mode=d["mode"], filter_flag=d["filter_flag"],
            strong_allowed=d["strong_allowed"], dc_edge=d["dc_edge"],
            out_idx=oi.reshape(-1, s * s), residual=res[log2])
    return out


def scan_plane(stacked: dict, starts: dict, n_steps: int, plane,
               after_step=None):
    """Device: run the wavefront over `plane` [rows, pw] int32 in place.

    stacked: expand() output; starts: {log2: host int64 [n_steps+1]}.
    Every bucket of a step predicts from the SAME pre-step plane and all
    buckets land in ONE merged scatter (TUs of a step never overlap).
    Chroma TUs ride in the same buckets: their per-TU flags switch the
    luma-only smoothing and edge filters off (c_idx 0 semantics).
    after_step(plane), where given, runs after every step, empty or not
    (the row-sharded scan refreshes its halo rows there)."""
    flat = plane.view(-1)
    for k in range(n_steps):
        idx, val = [], []
        for log2, d in stacked.items():
            a, b = int(starts[log2][k]), int(starts[log2][k + 1])
            if a == b:
                continue
            s = 1 << log2
            refs = torch.where(d["ref_ok"][a:b], flat[d["ref_idx"][a:b]], 128)
            pred = intra.predict_from_refs(
                refs, d["mode"][a:b], d["filter_flag"][a:b],
                d["strong_allowed"][a:b], s, 0, d["dc_edge"][a:b])
            idx.append(d["out_idx"][a:b].reshape(-1))
            val.append((pred + d["residual"][a:b]).clamp(0, 255).reshape(-1))
        if idx:
            flat[torch.cat(idx)] = torch.cat(val)
        if after_step is not None:
            after_step(plane)
    return plane
