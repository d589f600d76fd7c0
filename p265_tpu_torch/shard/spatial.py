"""Row-sharded Stage B: ONE picture's reconstruction and loop filters over
the ranks of a process group (the 'space' axis).

Counterpart of p265_tpu/shard/spatial.py, with one process per rank
(shard/mesh.py).

- The picture is split into CTU-row blocks, one per rank.  HEVC intra
  prediction reads reference samples only from the row just above a TU
  and from its own left column; with CTU-aligned blocks, below-left
  references never cross a block boundary (raster decode order makes them
  unavailable there).  So the wavefront scan shards with a ONE-ROW halo:
  every rank runs the GLOBAL step numbering over its own block, and after
  every step each rank hands its bottom reconstructed row to the next rank
  as its top halo row; the numbering makes every producer run at an
  earlier step than its consumer.  The three components' blocks, each with
  its halo row, sit in one local tall plane, so a step costs ONE
  collective, not three.
- Motion compensation reads arbitrary rows of the reference pictures, so
  the row-sharded DPB slabs are all-gathered before each rank interpolates
  the MC blocks of its own rows (K2).
- Deblocking shards with a 4-row halo (the vertical-edge pass is
  row-local), SAO with a 1-row halo (shard/filters.py).

Shapes are exact.  The JAX package padded every device's TU lists and
gather maps to fleet-common shapes so that XLA would compile one program
(and pinned a pad TU into each device's guard); eager torch runs each
rank's own lists, as pipeline/batch_decode.py does without the shape
ladder.  Row blocks are still CTU-aligned, so the last ranks may own rows
past the picture (1080 rows are 16.875 CTUs); every output is cut back.

Every function returns full planes (int32 tensors on `device`) on every
rank: the ranks' blocks are gathered.  Bit-exact vs the unsharded path.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from p265_tpu_torch.golden.decoder import DecoderBase, bypass_pixel_masks
from p265_tpu_torch.kernels.loopfilter import (
    chroma_edge_params, deblock_chroma_vertical, deblock_luma_vertical,
    filter_flags, luma_edge_params)
from p265_tpu_torch.kernels.mc import (mc_arrays_padded, mc_block_counts,
                                       mc_pred_planes, ref_stacks, stamp_pcm,
                                       uses_l1)
from p265_tpu_torch.kernels.staging import stage
from p265_tpu_torch.pipeline.wavefront import (GUARD, hoist_inter,
                                               merge_segments, run_scan,
                                               scan_fields, stack_plane,
                                               step_starts)
from p265_tpu_torch.plan.frame_plan import PlanePlan, build_tensor_plan
from p265_tpu_torch.shard.filters import sao_sharded
from p265_tpu_torch.shard.mesh import (COUNTS, all_gather,
                                       halo_exchange_rows, join_rows,
                                       local_rows)

_I32 = torch.int32


def _ranks(group) -> tuple:
    return dist.get_world_size(group), dist.get_rank(group)


def _planes(planes, device) -> list:
    return [torch.as_tensor(p).to(device=device, dtype=_I32) for p in planes]


def _gather_blocks(blocks: list, shapes, group) -> list:
    """This rank's row blocks of several planes (each [hl_c, <= W]) -> the
    full planes of the given shapes, in ONE all-gather."""
    width = max(w for _, w in shapes)
    hls = [b.shape[0] for b in blocks]
    buf = blocks[0].new_zeros((sum(hls), width))
    r = 0
    for b in blocks:
        buf[r:r + b.shape[0], :b.shape[1]] = b
        r += b.shape[0]
    g = all_gather(buf, group)
    out, r = [], 0
    for hl, (h, w) in zip(hls, shapes):
        out.append(join_rows(g[:, r:r + hl, :w], h))
        r += hl
    return out


# ---------------------------------------------------------------------------
# row-sharded wavefront reconstruction (a 1-row halo after every step)
# ---------------------------------------------------------------------------


def block_rows(ph: int, n: int, align: int) -> int:
    """CTU-aligned row-block height of each of n ranks covering ph rows."""
    return align * -(-ph // (n * align))


def _local_plane(pp: PlanePlan, hl: int, rank: int, n: int) -> PlanePlan:
    """The TUs of row block `rank` of a PlanePlan, localized: plane row y
    goes to local row y - r0 + 1 (local row 0 is the halo row) and
    reference rows are clipped to [0, hl] (an unavailable reference is
    gated by ref_ok).  Keeps the picture's n_steps, so that every rank runs
    the same steps."""
    r0 = rank * hl
    out = PlanePlan(pp.plane_idx, (1 + hl, pp.shape[1]), pp.n_steps)
    for log2, b in pp.batches.items():
        sel = np.minimum(b.pos[:, 0] // hl, n - 1) == rank
        if not sel.any():
            continue
        nb = dataclasses.replace(b, **{
            f.name: getattr(b, f.name)[sel] for f in dataclasses.fields(b)
            if f.name != "size" and getattr(b, f.name) is not None})
        nb.pos[:, 0] += 1 - r0
        nb.ref_ys = np.clip(nb.ref_ys + 1 - r0, 0, hl)
        out.batches[log2] = nb
    return out


def reconstruct_spatial(tplan, group, device, pred_planes=None) -> list:
    """Row-sharded reconstruction of ONE picture over the ranks of `group`.

    tplan: the picture's TensorPlan, the same on every rank.  pred_planes:
    [3] MC prediction planes (e.g. from mc_spatial; numpy or tensors),
    default the tensor plan's own inter_pred.  Returns the [y, cb, cr]
    prefilter planes (int32 on `device`) on every rank, bit-exact vs the
    unsharded scan.  Residuals go through K1 (one launch for the hoisted
    inter TUs, one for the scan's); one all-gather a wavefront step."""
    device = torch.device(device)
    n, rank = _ranks(group)
    ctb = tplan.frame_plan.sps.ctb_size
    hls = [block_rows(pp.shape[0], n, ctb if i == 0 else ctb >> 1)
           for i, pp in enumerate(tplan.planes)]
    merged = merge_segments([_local_plane(pp, hl, rank, n)
                             for pp, hl in zip(tplan.planes, hls)])
    # segment starts as merge_segments lays them out
    offs = np.cumsum([0] + [1 + hl + GUARD for hl in hls[:-1]])
    total_h, pw = merged.shape
    shape = (total_h + GUARD, pw)

    if pred_planes is None:
        pred_planes = [pp.inter_pred for pp in tplan.planes]
    pred = None
    if any(p is not None for p in pred_planes):
        pred = torch.zeros(shape, dtype=_I32, device=device)
        for p, o, hl in zip(pred_planes, offs, hls):
            if p is not None:
                blk = local_rows(_planes([p], device)[0], rank, hl)
                pred[o + 1:o + 1 + hl, :blk.shape[1]] = blk

    itu = hoist_inter(merged)
    fields, starts = scan_fields(stack_plane(merged))
    # the halo rows and the last owned rows of each segment ride along
    dev = stage(dict(itu=itu, tu=fields,
                     starts=step_starts(starts, merged.n_steps),
                     top=offs, bottom=offs + np.asarray(hls)), device)
    top, bottom = dev["top"], dev["bottom"]

    def exchange(plane):
        g = all_gather(plane[bottom], group)              # [n, 3, pw]
        if rank > 0:
            plane[top] = g[rank - 1]

    plane = run_scan(dev["itu"], dev["tu"], starts, merged.n_steps, pred,
                     shape, device, exchange, starts_dev=dev["starts"])
    return _gather_blocks([plane[o + 1:o + 1 + hl, :pp.shape[1]]
                           for o, hl, pp in zip(offs, hls, tplan.planes)],
                          [pp.shape for pp in tplan.planes], group)


# ---------------------------------------------------------------------------
# MC from a row-sharded DPB: all-gather the reference slabs, filter locally
# ---------------------------------------------------------------------------


def shard_refs(refs: dict, group, device, pad_rows: list | None = None):
    """This rank's rows of the DPB reference planes, row-sharded over the
    ranks of `group`.

    refs: {poc: [y, cb, cr]} (the same on every rank) -> (poc_list, [3]
    uint8 [n_refs, rows, W(c)] tensors on `device`).  pad_rows: optional
    [3] per-component row totals (multiples of the rank count), default
    the least such multiple; padding REPLICATES the last row, so a gather
    clamped to the padded height reads the spec's edge-extended samples."""
    n, rank = _ranks(group)
    poc_list = sorted(refs)
    out = []
    for c, stack in enumerate(ref_stacks(refs, poc_list, device)):
        h = stack.shape[1]
        tgt = pad_rows[c] if pad_rows is not None else n * -(-h // n)
        if tgt > h:
            stack = torch.cat([stack, stack[:, -1:].expand(-1, tgt - h, -1)],
                              1)
        hl = tgt // n
        out.append(stack[:, rank * hl:(rank + 1) * hl].contiguous())
    return poc_list, out


def _band_blocks(arrays: dict, hls: list, rank: int) -> dict:
    """The MC blocks whose rows meet this rank's row band.  A block that
    straddles two bands is interpolated by both ranks; each keeps its own
    rows."""
    out = {}
    for grp, hl in (("y", hls[0]), ("c", hls[1])):
        out[grp] = {}
        for b, d in arrays[grp].items():
            y = d["pos"][:, 0]
            sel = (y < (rank + 1) * hl) & (y + b > rank * hl)
            out[grp][b] = {k: v[sel] for k, v in d.items()}
    return out


def mc_spatial(plan, refs: dict, group, device) -> list | None:
    """MC prediction planes computed from a row-sharded DPB.

    Every rank all-gathers the reference slabs (the DPB slab collective;
    one all-gather for all references and components), cuts them to the
    picture's height (so K2's clamp is the spec's edge rule), interpolates
    the blocks of its own rows in one K2 launch and combines them; the
    row bands are gathered and the PCM samples stamped.  Returns None when
    the picture has neither PUs nor PCM CUs, else three int32 planes on
    `device` on every rank, bit-exact vs build_inter_pred_device."""
    has_pcm = any(t.pcm for t in plan.tus)
    if not plan.pus and not has_pcm:
        return None
    device = torch.device(device)
    n, rank = _ranks(group)
    H, W = plan.sps.pic_height, plan.sps.pic_width
    shapes = ((H, W), (H >> 1, W >> 1), (H >> 1, W >> 1))
    hls = [block_rows(H, n, 8)] + [block_rows(H >> 1, n, 8)] * 2
    bands = [torch.zeros((hl, w), dtype=_I32, device=device)
             for hl, (_, w) in zip(hls, shapes)]
    if plan.pus:
        poc_list, local = shard_refs(refs, group, device,
                                     [hl * n for hl in hls])
        g = all_gather(torch.cat([s.reshape(-1) for s in local]), group)
        stacks, off = [], 0
        for s, (h, w) in zip(local, shapes):
            k = s.numel()
            full = g[:, off:off + k].reshape(n, *s.shape).transpose(0, 1)
            stacks.append(full.reshape(s.shape[0], -1, w)[:, :h].contiguous())
            off += k
        arrays = _band_blocks(mc_arrays_padded(
            plan, {p: i for i, p in enumerate(poc_list)},
            mc_block_counts(plan)), hls, rank)
        planes = mc_pred_planes(stacks, stage(arrays, device), shapes,
                                uses_l1(arrays))
        bands = [local_rows(p, rank, hl) for p, hl in zip(planes, hls)]
    out = _gather_blocks(bands, shapes, group)
    stamp_pcm(plan, out)
    return out


# ---------------------------------------------------------------------------
# row-sharded deblocking (V pass local; H pass with a 4-row halo)
# ---------------------------------------------------------------------------


def _h_edge_params(glob: np.ndarray, hl: int, rank: int) -> np.ndarray:
    """This rank's slab [n_seg, hl//8 + 1] of transposed-layout H-edge
    params [n_seg, n_e] (edges on the 8-row grid of the plane: rows 8, 16,
    ..): the edges at rows r0, r0+8, .., r0+hl (zeros = no edge)."""
    pe = hl // 8 + 1
    out = np.zeros((glob.shape[0], pe), np.int32)
    for k in range(pe):
        row = rank * hl + 8 * k
        # edge validity is the edge-param builder's: glob holds exactly the
        # legal edges, so a plane height that is no multiple of 8 (540
        # chroma rows at 1080p) keeps its last edge (536)
        if row >= 8 and row // 8 - 1 < glob.shape[1]:
            out[:, k] = glob[:, row // 8 - 1]
    return out


def deblock_spatial(plan, planes: list, group, device) -> list:
    """Row-sharded deblocking of [y, cb, cr] over the ranks of `group`:
    the vertical-edge pass on each rank's rows, then the horizontal-edge
    pass after a 4-row halo exchange of the V-filtered samples (spec
    order; the vertical filter on the transposes, with each rank's own
    edge slab, shared boundary edge included).  Bit-exact vs the unsharded
    deblocking; full int32 planes on every rank."""
    device = torch.device(device)
    n, rank = _ranks(group)
    planes = _planes(planes, device)
    shapes = [tuple(p.shape) for p in planes]
    (H, W), (Hc, Wc) = shapes[0], shapes[1]
    # row blocks on the 8-row deblocking grid; rows past the picture get
    # zeroed edge params (no edge exists there), so their values are inert
    hl, hc = block_rows(H, n, 8), block_rows(Hc, n, 8)

    def t(a):   # at the kernel's wire dtype, cast on the host
        return torch.from_numpy(np.ascontiguousarray(a, np.int16)).to(device)

    y = local_rows(planes[0], rank, hl)
    ch = torch.stack([local_rows(planes[c], rank, hc) for c in (1, 2)])
    bs_v, beta_v, tc_v = luma_edge_params(plan, vertical=True)
    tcb_v, tcr_v = chroma_edge_params(plan, vertical=True)
    if bs_v.shape[1]:
        y = deblock_luma_vertical(
            y[None], *(local_rows(t(a), rank, hl // 4)[None]
                       for a in (bs_v, beta_v, tc_v)))[0]
    if tcb_v.shape[1]:
        ch = deblock_chroma_vertical(ch, torch.stack(
            [local_rows(t(a), rank, hc // 4) for a in (tcb_v, tcr_v)]))

    # one exchange for the three planes: their 4 edge rows side by side
    def edge_rows(sl):
        return torch.cat([y[sl], ch[0][sl], ch[1][sl]], 1)
    top, bot = halo_exchange_rows(torch.cat(
        [edge_rows(slice(0, 4)), edge_rows(slice(-4, None))]), 4, group)
    cols = (slice(0, W), slice(W, W + Wc), slice(W + Wc, W + 2 * Wc))

    def ext(local, i):   # 4 zero rows put the edges on the filter's 8k+8 grid
        return torch.cat([local.new_zeros((4, local.shape[1])),
                          top[:, cols[i]], local, bot[:, cols[i]]])

    bs_h, beta_h, tc_h = luma_edge_params(plan, vertical=False)
    tcb_h, tcr_h = chroma_edge_params(plan, vertical=False)
    y = deblock_luma_vertical(
        ext(y, 0).T[None], *(t(_h_edge_params(a, hl, rank))[None]
                             for a in (bs_h, beta_h, tc_h)))[0].T[8:8 + hl]
    che = torch.stack([ext(ch[0], 1), ext(ch[1], 2)]).transpose(1, 2)
    ch = deblock_chroma_vertical(che, torch.stack(
        [t(_h_edge_params(a, hc, rank)) for a in (tcb_h, tcr_h)])
    ).transpose(1, 2)[:, 8:8 + hc]
    return _gather_blocks([y, ch[0], ch[1]], shapes, group)


def loop_filters_spatial(plan, planes: list, group, device) -> list:
    """The in-loop filter chain (deblocking, then SAO), row-sharded with
    halo exchange; bypass samples keep their prefilter values.  Bit-exact
    vs golden apply_loop_filters; full int32 planes on every rank."""
    device = torch.device(device)
    masks = bypass_pixel_masks(plan)
    orig = out = _planes(planes, device)
    deblock_on, sao_luma, sao_chroma = filter_flags(plan)
    if deblock_on:
        out = deblock_spatial(plan, out, group, device)
    if sao_luma or sao_chroma:
        out = sao_sharded(plan, out, group, device)
    if masks:
        out = [torch.where(torch.from_numpy(m).to(device), o, p)
               for m, o, p in zip(masks, orig, out)]
    return out


def decode_picture_spatial(plan, refs: dict, group, device):
    """One picture, Stage B sharded over the ranks of `group`: sharded-DPB
    MC -> row-sharded wavefront recon -> halo deblocking + SAO.

    refs {poc: [y, cb, cr]} (numpy or tensors, the same on every rank).
    Returns (prefilter, filtered) [y, cb, cr] int32 planes on `device`, on
    every rank; bit-exact vs the unsharded golden and torch paths."""
    pred = mc_spatial(plan, refs, group, device)
    tplan = build_tensor_plan(plan, refs=None, pred_planes=pred)
    prefilter = reconstruct_spatial(tplan, group, device)
    return prefilter, loop_filters_spatial(plan, prefilter, group, device)


class SpatialDecoder(DecoderBase):
    """Annex-B stream -> frames, every picture through
    decode_picture_spatial over the ranks of `group`; every rank decodes
    the same stream and gets every frame.  frame.planes are host int32
    arrays; frame.prefilter and the DPB planes stay on `device`.
    `pictures` records, in decode order, each picture's wall seconds (to
    its planes on the host) and its collectives and their bytes."""

    def __init__(self, group, device):
        super().__init__(use_native_parse=True)
        self.group, self.device = group, torch.device(device)
        # the intra A-table product is exact only in full float32
        torch.backends.cuda.matmul.allow_tf32 = False
        self.pictures: list = []

    def _run_recon(self, task: dict) -> None:
        t0, c0 = time.perf_counter(), dict(COUNTS)
        refs = {p: r.planes for p, r in task["refs"].items()}
        pre, filt = decode_picture_spatial(task["plan"], refs, self.group,
                                           self.device)
        task["frame"].prefilter = pre
        task["pic"].planes = filt
        task["frame"].planes = [p.cpu().numpy() for p in filt]
        dt = time.perf_counter() - t0
        self.stats["recon_s"] += dt
        self.pictures.append(dict(
            poc=task["plan"].poc, seconds=dt,
            **{k: COUNTS[k] - c0[k] for k in COUNTS}))
