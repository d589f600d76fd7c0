"""Motion compensation (spec 8.5.3.3): 8-tap luma / 4-tap chroma
interpolation of size-bucketed MC blocks, uni/bi/weighted combination, and
the scatter into a prediction plane.  Bit-exact vs golden/inter.py.

Counterpart of p265_tpu/kernels/mc.py (host packing copied, device side in
torch) and, for the interpolation kernel, p265_tpu/kernels/pallas_mc.py
(csrc/mc.cu behind `mc_blocks_grouped`, which interpolates every block of
a picture in one launch; `mc_blocks` is its one-group call).  The host
copies are NumPy only: the port imports nothing of the JAX package.
`build_inter_pred_device` gives a picture's prediction planes with its PCM
samples stamped in, as the JAX package's does.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from p265_tpu_torch.tables import CHROMA_FILTER, LUMA_FILTER
from p265_tpu_torch.kernels import _build
from p265_tpu_torch.kernels.staging import stage

BIT_DEPTH = 8

# MC block-size buckets: each inter PU is tiled greedily with the LARGEST
# fitting square blocks; a (B+taps-1)^2 window serves a BxB block, so large
# blocks fetch far fewer window samples per output sample.
LUMA_BUCKETS = (16, 8, 4)
CHROMA_BUCKETS = (8, 4, 2)

# ---------------------------------------------------------------------------
# host: PU -> block arrays (copies of p265_tpu/kernels/mc.py)
# ---------------------------------------------------------------------------


def tile_pu(x0: int, y0: int, w: int, h: int, sizes) -> list:
    """Greedy largest-square tiling of one PU rectangle -> [(y, x, size)].
    w/h are multiples of sizes[-1]; sizes are descending powers of two."""
    def decomp(n):
        segs = []
        for s in sizes:
            k = n // s
            segs.extend([s] * k)
            n -= k * s
        return segs
    out = []
    yo = 0
    for sy in decomp(h):
        xo = 0
        for sx in decomp(w):
            s = min(sx, sy)
            for dy in range(0, sy, s):
                for dx in range(0, sx, s):
                    out.append((y0 + yo + dy, x0 + xo + dx, s))
            xo += sx
        yo += sy
    return out


def mc_block_counts(plan) -> dict:
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


def mc_arrays_padded(plan, poc_index: dict, pad_rows: dict):
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
# device
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _filters(taps: int, device: torch.device) -> torch.Tensor:
    """[fractions, taps] int32 interpolation filters."""
    f = LUMA_FILTER if taps == 8 else CHROMA_FILTER
    return torch.tensor(np.asarray(f), dtype=torch.int32, device=device)


def mc_blocks_ref(refs, pos, ridx, mv, block: int, taps: int):
    """Plain torch version: 14-bit MC intermediates [n, block, block] int32.

    refs [R,H,W] uint8 reference planes; pos [n,2] (y, x) block origins;
    ridx [n] int32; mv [n,2] (mvx, mvy) int32 in quarter (luma) or eighth
    (chroma) pel.  Window samples are clamped to the picture (spec edge
    rule), so any MV is exact."""
    # fraction mask, integer-MV shift (quarter / eighth pel), window lead
    fmask, unit, half = (3, 2, 3) if taps == 8 else (7, 3, 1)
    filt = _filters(taps, refs.device)
    R, H, W = refs.shape
    span = block + taps - 1
    iy = pos[:, 0] + (mv[:, 1] >> unit) - half
    ix = pos[:, 1] + (mv[:, 0] >> unit) - half
    ar = torch.arange(span, device=refs.device)
    ys = (iy[:, None] + ar[None, :]).clamp(0, H - 1).long()
    xs = (ix[:, None] + ar[None, :]).clamp(0, W - 1).long()
    r = ridx.clamp(0, R - 1).long()
    win = refs[r[:, None, None], ys[:, :, None], xs[:, None, :]].to(
        torch.int32)
    fh = filt[(mv[:, 0] & fmask).long()]
    fv = filt[(mv[:, 1] & fmask).long()]
    tmp = sum(fh[:, t, None, None] * win[:, :, t:t + block]
              for t in range(taps)) >> (BIT_DEPTH - 8)
    out = sum(fv[:, t, None, None] * tmp[:, t:t + block, :]
              for t in range(taps))
    return out >> 6


def mc_blocks_grouped_ref(groups) -> list:
    """Plain version of mc_blocks_grouped: one mc_blocks_ref call a group."""
    return [mc_blocks_ref(*g) for g in groups]


GEOMETRIES = ((16, 8), (8, 8), (4, 8), (8, 4), (4, 4), (2, 4))
MAX_GROUPS = 32   # groups of one launch (csrc/mc.cu kMaxGroups)
_LUMA = np.ascontiguousarray(LUMA_FILTER, np.int32)
_CHROMA = np.ascontiguousarray(CHROMA_FILTER, np.int32)
# csrc/mc.cu's epilogues: the 14-bit intermediates of one list a group;
# the finished samples of uni- or bi-predicted pictures in their plane
_RAW, _UNI, _BI = 0, 1, 2


def _checked(t, name, dt, shape, dev):
    if (t.dtype != dt or t.device != dev
            or (shape is not None and tuple(t.shape) != shape)):
        raise ValueError(f"mc_blocks: {name} must be {dt} {shape} on {dev}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def _refs_row(refs, block, taps, dev) -> tuple:
    """(refs, its table columns R, H, W) after the checks of a group."""
    if (block, taps) not in GEOMETRIES or refs.dim() != 3 or min(
            refs.shape) == 0:
        raise ValueError(f"mc_blocks: bad refs {tuple(refs.shape)} or "
                         f"geometry {(block, taps)}")
    refs = _checked(refs, "refs", torch.uint8, None, dev)
    return refs, refs.shape


def _launch(table: list, epilogue: int, dev) -> None:
    """One launch of csrc/mc.cu over the group rows of `table`."""
    if len(table) > MAX_GROUPS:
        raise ValueError(f"mc_blocks: {len(table)} groups, at most "
                         f"{MAX_GROUPS} in one launch")
    rows = np.array(table, np.int64)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.p265_mc_grouped(
            rows.ctypes.data, len(table), _LUMA.ctypes.data,
            _CHROMA.ctypes.data, epilogue,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mc")
    _build.LAUNCHES["mc"] += 1


def mc_blocks_grouped(groups) -> list:
    """MC intermediates of several block groups: each group (refs, pos,
    ridx, mv, block, taps) as mc_blocks_ref takes it -> one [n, block,
    block] int32 view per group, cut from one flat buffer.

    A CPU tensor takes the plain version; CUDA tensors launch csrc/mc.cu
    once for all groups, with its intermediates epilogue."""
    groups = list(groups)
    if not groups:
        return []
    dev = groups[0][0].device
    if dev.type == "cpu":
        return mc_blocks_grouped_ref(groups)
    if dev.type != "cuda":
        raise ValueError(f"mc_blocks: no kernel for {dev}")
    return _blocks_kernel(groups, dev)


def _blocks_kernel(groups, dev) -> list:
    off, views, fields = 0, [], []
    for refs, pos, ridx, mv, block, taps in groups:
        refs, (R, H, W) = _refs_row(refs, block, taps, dev)
        n = pos.shape[0]
        f = (_checked(pos, "pos", torch.int32, (n, 2), dev),
             _checked(mv, "mv", torch.int32, (n, 2), dev),
             _checked(ridx, "ridx", torch.int32, (n,), dev))
        fields.append((refs, *f, off, R, H, W, n, block, taps))
        views.append((off, n, block))
        off += n * block * block
    out = torch.empty(off, dtype=torch.int32, device=dev)
    if off:
        _launch([(refs.data_ptr(), pos.data_ptr(), mv.data_ptr(), 0,
                  ridx.data_ptr(), 0, 0, 0, out.data_ptr() + 4 * o, R, H, W,
                  n, block, taps, _word_loads(refs), 0, 0, 0)
                 for refs, pos, mv, ridx, o, R, H, W, n, block, taps
                 in fields], _RAW, dev)
    return [out[o:o + n * b * b].view(n, b, b) for o, n, b in views]


def _word_loads(refs) -> bool:
    """Whether the kernel may load the reference rows as aligned words."""
    return refs.shape[2] % 4 == 0 and refs.data_ptr() % 4 == 0


def mc_blocks(refs, pos, ridx, mv, block: int, taps: int):
    """Same contract as mc_blocks_ref: mc_blocks_grouped with one group."""
    return mc_blocks_grouped([(refs, pos, ridx, mv, block, taps)])[0]


def combine(p0, p1, has_l1, w_params):
    """uni/bi (+ explicit weighted) combination -> 8-bit samples, int32.

    p1 None: the picture is uni-directional, the bi path is skipped.
    w_params None, or (w0, o0, w1, o1, log2_wd) [n] each."""
    if w_params is None:
        uni = ((p0 + (1 << 5)) >> 6).clamp(0, 255)
        if p1 is None:
            return uni
        bi = ((p0 + p1 + (1 << 6)) >> 7).clamp(0, 255)
        return torch.where(has_l1[:, None, None], bi, uni)
    w0, o0, w1, o1, log2_wd = (a[:, None, None] for a in w_params)
    shift_u = log2_wd + 6
    one = torch.ones_like(shift_u)
    pu = torch.bitwise_right_shift(
        p0 * w0 + torch.bitwise_left_shift(one, shift_u - 1), shift_u)
    uni = (pu + o0).clamp(0, 255)
    if p1 is None:
        return uni
    sb = p0 * w0 + p1 * w1 + torch.bitwise_left_shift(o0 + o1 + 1, shift_u)
    bi = torch.bitwise_right_shift(sb, log2_wd + 7).clamp(0, 255)
    return torch.where(has_l1[:, None, None], bi, uni)


def uses_l1(arrays) -> bool:
    """Host: whether any block of mc_arrays_padded's arrays reads list 1
    (the has_bi of mc_pred_planes, known without a device sync)."""
    return any(bool(a["has1"].any()) for grp in arrays.values()
               for a in grp.values())


def _destinations(shapes, out, dev) -> list:
    """The planes mc_pred_planes writes: fresh zero planes, or the segments
    of out = (plane [rows, pitch] int32, first row of each component)."""
    if out is None:
        return [torch.zeros(s, dtype=torch.int32, device=dev)
                for s in shapes]
    plane, rows = out
    if (plane.dtype != torch.int32 or plane.dim() != 2
            or plane.device != dev or not plane.is_contiguous()):
        raise ValueError("mc_pred_planes: out must be a contiguous 2-D "
                         f"int32 plane on {dev}")
    segs = [plane[r:r + h, :w] for r, (h, w) in zip(rows, shapes)]
    if any(r < 0 or s.shape != tuple(sh)
           for r, s, sh in zip(rows, segs, shapes)):
        raise ValueError(f"mc_pred_planes: segments {shapes} at rows "
                         f"{rows} do not fit the plane {tuple(plane.shape)}")
    return segs


def mc_pred_planes_ref(stacks, arrays, shapes, has_bi: bool,
                       out=None) -> list:
    """Plain version of mc_pred_planes: mc_blocks_grouped_ref over every
    (plane, bucket, list), combine(), then the samples of the blocks
    scattered into the planes; pad blocks, which lie below the plane, and
    any sample outside it are dropped."""
    dev = stacks[0].device
    planes = _destinations(shapes, out, dev)
    for c, (stack, (H, W), plane) in enumerate(zip(stacks, shapes, planes)):
        grp, taps = ("y", 8) if c == 0 else ("c", 4)
        for block, d in sorted(arrays[grp].items(), reverse=True):
            if d["pos"].shape[0] == 0:
                continue
            pred = mc_blocks_grouped_ref(
                [(stack, d["pos"], d[f"r{lx}"], d[f"mv{lx}"], block, taps)
                 for lx in ((0, 1) if has_bi else (0,))])
            samp = combine(pred[0], pred[1] if has_bi else None, d["has1"],
                           tuple(d[f"wp_{c}"][:, k] for k in range(5)))
            ar = torch.arange(block, device=dev)
            ys = (d["pos"][:, 0, None] + ar).long()
            xs = (d["pos"][:, 1, None] + ar).long()
            keep = (((ys >= 0) & (ys < H))[:, :, None]
                    & ((xs >= 0) & (xs < W))[:, None, :])
            plane[ys[:, :, None].expand_as(keep)[keep],
                  xs[:, None, :].expand_as(keep)[keep]] = samp[keep]
    return planes


def mc_pred_planes(stacks, arrays, shapes, has_bi: bool, out=None) -> list:
    """One picture's MC prediction planes (y, cb, cr): every block of every
    plane interpolated, combined and placed by ONE launch of csrc/mc.cu.

    stacks (y, cb, cr) uint8 reference stacks [R,H,W] (device-resident DPB
    slabs); arrays {"y": {block: fields}, "c": {...}} as mc_arrays_padded
    gives them, as tensors on the same device; shapes the three plane
    shapes.  has_bi False skips the second list.  out None: the planes are
    new [H, W] int32 tensors, 0 where no block lies.  out = (plane, rows):
    the samples go into the [H, W] segments of the contiguous int32 `plane`
    that start at rows[c] (the tall prediction plane of a batch), which
    are returned as views; samples no block covers keep what the plane
    held, so the caller hands segments of zeros.  Pad blocks (pos = (H,
    0)) are skipped.  A CPU tensor takes the plain version,
    mc_pred_planes_ref; CUDA tensors launch the kernel, which combines the
    lists in registers and stores the samples in place: no torch operation
    follows it."""
    dev = stacks[0].device
    if dev.type == "cpu":
        return mc_pred_planes_ref(stacks, arrays, shapes, has_bi, out)
    if dev.type != "cuda":
        raise ValueError(f"mc_pred_planes: no kernel for {dev}")
    return _pred_planes_kernel(stacks, arrays, shapes, has_bi, out)


def _pred_planes_kernel(stacks, arrays, shapes, has_bi, out) -> list:
    dev = stacks[0].device
    planes = _destinations(shapes, out, dev)
    table, alive = [], []
    for c, (stack, plane) in enumerate(zip(stacks, planes)):
        grp, taps = ("y", 8) if c == 0 else ("c", 4)
        for block, d in arrays[grp].items():
            n = d["pos"].shape[0]
            if n == 0:
                continue
            refs, (R, H, W) = _refs_row(stack, block, taps, dev)
            f = [_checked(d["pos"], "pos", torch.int32, (n, 2), dev),
                 _checked(d["mv0"], "mv0", torch.int32, (n, 2), dev),
                 _checked(d["r0"], "r0", torch.int32, (n,), dev),
                 _checked(d[f"wp_{c}"], "wp", torch.int32, (n, 5), dev)]
            if has_bi:
                f += [_checked(d["mv1"], "mv1", torch.int32, (n, 2), dev),
                      _checked(d["r1"], "r1", torch.int32, (n,), dev),
                      _checked(d["has1"], "has1", torch.bool, (n,), dev)]
            alive += [refs, *f]
            p = [t.data_ptr() for t in f] + [0, 0, 0]
            table.append((refs.data_ptr(), p[0], p[1], p[4], p[2], p[5],
                          p[6], p[3], plane.data_ptr(), R, H, W, n, block,
                          taps, _word_loads(refs), plane.stride(0),
                          *plane.shape))
    if table:
        _launch(table, _BI if has_bi else _UNI, dev)
    return planes


# ---------------------------------------------------------------------------
# PCM samples and the picture's prediction planes
# ---------------------------------------------------------------------------


def pcm_samples(plan, offsets, pitch: int):
    """Host: (flat indices int64, samples int32) of every PCM TU of `plan`
    in a plane of row pitch `pitch` where component c starts at row
    offsets[c] (None: leave component c out); None when there are none.

    PCM TUs are pred-only inter TUs whose levels are the samples, so the
    samples go into the prediction plane (spec 8.4.4.1 pcm_sample)."""
    idx, val = [], []
    for t in plan.tus:
        if not t.pcm or offsets[t.c_idx] is None:
            continue
        ar = np.arange(1 << t.log2)
        rows = offsets[t.c_idx] + t.y + ar
        idx.append((rows[:, None] * pitch + t.x + ar[None, :]).ravel())
        val.append(np.asarray(t.levels, np.int32).ravel())
    if not idx:
        return None
    return np.concatenate(idx).astype(np.int64), np.concatenate(val)


def stamp_pcm(plan, out: list) -> None:
    """Overwrite the PCM CUs' samples of the device planes `out` [y, cb, cr]
    (int32) with their parsed levels: one scatter a plane.  Counterpart of
    p265_tpu.kernels.mc.stamp_pcm, which stamps host planes TU by TU."""
    for c, plane in enumerate(out):
        st = pcm_samples(plan, [0 if k == c else None for k in range(3)],
                         plane.shape[1])
        if st is not None:
            idx, val = stage(st, plane.device)
            plane.view(-1)[idx] = val


def ref_stacks(refs: dict, poc_list: list, device) -> tuple:
    """(y, cb, cr) uint8 reference stacks [R, H, W] on `device`, in
    poc_list order.  refs {poc: [y, cb, cr]}: numpy arrays or tensors,
    values 0..255."""
    def slab(plane):
        if isinstance(plane, torch.Tensor):
            return plane.to(device=device, dtype=torch.uint8)
        return torch.from_numpy(np.ascontiguousarray(plane, np.uint8)).to(
            device)
    return tuple(torch.stack([slab(refs[p][c]) for p in poc_list])
                 for c in range(3))


def build_inter_pred_device(plan, refs: dict, device):
    """A picture's prediction planes on `device`: the MC of every inter PU
    through one grouped K2 launch (mc_pred_planes), then the PCM samples
    stamped over it.  Counterpart of p265_tpu.kernels.mc.
    build_inter_pred_device (same contract as golden build_inter_pred).

    refs {poc: [y, cb, cr]} reference planes (numpy arrays or tensors).
    Returns None when the picture has neither inter PUs nor PCM CUs, else
    three int32 planes on `device` (zero planes under the stamp when it
    has no PUs)."""
    has_pcm = any(t.pcm for t in plan.tus)
    if not plan.pus and not has_pcm:
        return None
    device = torch.device(device)
    H, W = plan.sps.pic_height, plan.sps.pic_width
    shapes = ((H, W), (H >> 1, W >> 1), (H >> 1, W >> 1))
    if plan.pus:
        poc_list = sorted(refs)
        arrays = mc_arrays_padded(plan, {p: i for i, p in enumerate(poc_list)},
                                  mc_block_counts(plan))
        out = mc_pred_planes(ref_stacks(refs, poc_list, device),
                             stage(arrays, device), shapes, uses_l1(arrays))
    else:
        out = [torch.zeros(s, dtype=torch.int32, device=device)
               for s in shapes]
    stamp_pcm(plan, out)
    return out
