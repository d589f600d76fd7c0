"""Random intra scans for holding the scan kernel (csrc/scan.cu) against
its plain version, wavefront.scan_packed_ref: `random_scan` builds the
expand() fields and step starts of one scan over a random plane, with
every mode, size and flag, unavailable references, empty steps, steps
wider than the kernel's warps and steps of one TU; `wide_scan` builds one
at 4K plane width whose steps have more work items than the kernel's
cluster has warps, each step reading what earlier steps wrote;
`coord_plane` builds a tensor-plan plane whose coordinates pass 32767 (the
tall planes and wide planes of the narrow wire dtypes).  The fields are
at the wire dtypes the kernel reads: coordinates (ref_ys, ref_xs, pos) at
`coord` (uint16, or int32), mode uint8, flags bool, residuals int32."""
from __future__ import annotations

import numpy as np
import torch


def random_scan(rng, dev, n_steps: int = 48, per_size: int = 140,
                one_a_step: bool = False, coord=np.uint16):
    """A random scan over a random 1024x1024 int32 plane -> (stacked,
    starts, n_steps, plane): per size 4..32, `per_size` TUs over the steps
    (a fifth of the steps left empty), each mode 0..34 at least 4 times
    when per_size >= 140, random filter_flag / strong_allowed / dc_edge,
    residuals to +-300; or, with one_a_step, exactly one TU a step, the
    sizes in turn.  Every TU writes a 32x32 tile (rows 32 on) that no
    other TU of its step writes (a later step may write it again); its
    references are anywhere but in the tiles its own step writes, all
    available, none, or a random mix, and a third of the unavailable ones
    point outside the plane (rows past it, to the coordinate dtype's
    largest).  Row 0 is a ramp that no TU writes: every third 32x32 TU
    reads it on both edges, so the strong-smoothing flatness test passes
    there (and fails elsewhere)."""
    rows = cols = 1024
    tile = 32
    tiles_x = cols // tile
    plane = rng.integers(0, 256, (rows, cols)).astype(np.int32)
    plane[0] = 50 + np.arange(cols) // 8
    if one_a_step:
        steps = {log2: np.arange(log2 - 2, n_steps, 4)
                 for log2 in (2, 3, 4, 5)}
    else:
        empty = set(rng.choice(n_steps, n_steps // 5,
                               replace=False).tolist())
        live = np.array([k for k in range(n_steps) if k not in empty])
        steps = {log2: np.sort(rng.choice(live, per_size))
                 for log2 in (2, 3, 4, 5)}
    n_tiles = (rows // tile - 1) * tiles_x
    free = {k: list(rng.permutation(n_tiles)) for k in range(n_steps)}
    own = {}             # the tile of every TU; the tiles of every step
    by_step = {k: set() for k in range(n_steps)}
    for log2, st in steps.items():
        own[log2] = np.array([free[int(k)].pop() for k in st], np.int64)
        for k, tl in zip(st, own[log2]):
            by_step[int(k)].add(int(tl))
    stacked, starts = {}, {}
    for log2, st in steps.items():
        s, n = 1 << log2, len(st)
        nr = 4 * s + 2
        ty, tx = own[log2] // tiles_x + 1, own[log2] % tiles_x
        pos = np.stack([ty * tile + rng.integers(0, tile // s, n) * s,
                        tx * tile + rng.integers(0, tile // s, n) * s], 1)
        idx = rng.integers(0, rows * cols, (n, nr))
        for u in range(n):
            mine = by_step[int(st[u])]
            while True:     # no reference inside a tile of the TU's step
                y, x = idx[u] // cols, idx[u] % cols
                tl = (y // tile - 1) * tiles_x + x // tile
                bad = (y >= tile) & np.isin(tl, list(mine))
                if not bad.any():
                    break
                idx[u, bad] = rng.integers(0, rows * cols, int(bad.sum()))
        r = rng.random(n)
        ok = np.where((r < 0.4)[:, None], True, np.where(
            (r < 0.5)[:, None], False, rng.random((n, nr)) < 0.7))
        ys, xs = idx // cols, idx % cols
        _far(rng, ok, ys, xs, rows, coord)
        mode = rng.permutation(np.arange(n) % 35).astype(np.uint8)
        ff, sa, de = (rng.random(n) < 0.5 for _ in range(3))
        if log2 == 5:
            flat = np.arange(n) % 3 == 0
            x0 = rng.integers(0, cols - nr // 2, (n, 2))
            ramp = np.concatenate([x0[:, :1] + np.arange(nr // 2),
                                   x0[:, 1:] + np.arange(nr // 2)], 1)
            ys[flat], xs[flat], ok[flat], ff[flat] = 0, ramp[flat], True, True
        stacked[log2] = _fields(rng, dev, s, ys, xs, ok, mode, ff, sa, de,
                                pos, coord)
        starts[log2] = np.searchsorted(st, np.arange(n_steps + 1))
    return stacked, starts, n_steps, torch.from_numpy(plane).to(dev)


def _far(rng, ok, ys, xs, rows: int, coord) -> None:
    """A third of the unavailable references (ok False) of ys, xs, in
    place, to rows past the plane's: rows + 3, or the largest the
    coordinate dtype holds, at a random column."""
    far = ~ok & (rng.random(ok.shape) < 0.33)
    top = int(np.iinfo(coord).max)
    ys[far] = rng.choice([rows + 3, top], int(far.sum()))
    xs[far] = rng.integers(0, top, int(far.sum()))


def _fields(rng, dev, s, ys, xs, ok, mode, ff, sa, de, pos, coord) -> dict:
    """One size bucket of expand() fields on `dev`, coordinates at
    `coord`, with random residuals to +-300."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in dict(
        ref_ys=ys.astype(coord), ref_xs=xs.astype(coord), ref_ok=ok,
        mode=mode, filter_flag=ff, strong_allowed=sa, dc_edge=de,
        pos=pos.astype(coord),
        residual=rng.integers(-300, 300, (len(mode), s, s)).astype(np.int32),
    ).items()}


# TUs a step of wide_scan, per size: 8 + 2 + 1 + 1 work items of the scan
# kernel each (a warp's item is at most 128 samples)
WIDE_TUS = {5: 40, 4: 30, 3: 25, 2: 25}


def work_items(starts: dict, n_steps: int) -> np.ndarray:
    """The scan kernel's work items in each step: a TU of s x s samples is
    max(1, s * s / 128) items."""
    out = np.zeros(n_steps, np.int64)
    for log2, st in starts.items():
        out += np.diff(np.asarray(st)[:n_steps + 1]) * max(
            1, (1 << (2 * log2)) // 128)
    return out


def wide_scan(rng, dev, n_steps: int = 4, cols: int = 3840,
              coord=np.uint16):
    """A scan over a plane of 4K width whose every step is wider than the
    scan kernel's cluster (16 CTAs x 16 warps), so the kernel loops over
    its items -> (stacked, starts, n_steps, plane).  Step k writes the
    32x32 tiles of tile row k + 1 (rows 32(k + 1) on): WIDE_TUS TUs, each
    alone in its tile, 430 work items a step.  The references of a step-k
    TU lie in the tile rows that steps 0..k-1 wrote (step 0: row band 0,
    which no TU writes), all available, none, or a random mix, and a third
    of the unavailable ones point outside the plane; every mode, random
    smoothing / strong / edge flags."""
    tile = 32
    tiles_x = cols // tile
    rows = tile * (n_steps + 1)
    plane = rng.integers(0, 256, (rows, cols)).astype(np.int32)
    stacked, starts = {}, {}
    place = {log2: ([], []) for log2 in WIDE_TUS}  # (steps, tiles) by size
    for k in range(n_steps):
        perm = iter(rng.permutation(tiles_x).tolist())
        for log2, n in WIDE_TUS.items():
            for _ in range(n):
                place[log2][0].append(k)
                place[log2][1].append(next(perm))
    for log2, (st, tx) in place.items():
        s, n = 1 << log2, len(st)
        st, tx = np.array(st), np.array(tx)
        nr = 4 * s + 2
        pos = np.stack([(st + 1) * tile + rng.integers(0, tile // s, n) * s,
                        tx * tile + rng.integers(0, tile // s, n) * s], 1)
        lo = np.where(st == 0, 0, tile)[:, None]
        y = lo + (rng.random((n, nr)) * ((st + 1) * tile - lo[:, 0])[:, None]
                  ).astype(np.int64)
        xs = rng.integers(0, cols, (n, nr))
        r = rng.random(n)
        ok = np.where((r < 0.4)[:, None], True, np.where(
            (r < 0.5)[:, None], False, rng.random((n, nr)) < 0.7))
        _far(rng, ok, y, xs, rows, coord)
        mode = rng.permutation(np.arange(n) % 35).astype(np.uint8)
        ff, sa, de = (rng.random(n) < 0.5 for _ in range(3))
        stacked[log2] = _fields(rng, dev, s, y, xs, ok, mode, ff, sa, de,
                                pos, coord)
        starts[log2] = np.searchsorted(st, np.arange(n_steps + 1))
    return stacked, starts, n_steps, torch.from_numpy(plane).to(dev)


def coord_plane(rng, shape, per_size: int = 12, exclusive: bool = False,
                inter_pred: bool = False):
    """A PlanePlan of `shape` (rows, cols) whose TUs (per_size of each size
    4..32, a third of them inter-predicted at step 1, the others intra at
    steps 2..9) sit in the last 4096 rows and columns, so with rows or
    columns past 32768 their positions and references pass 32767 too;
    random levels, qp, modes and flags (no DST on an inter TU); every
    TU's references lie inside the plane, a random mix of them available.
    It has no scaling lists, and no inter_pred unless `inter_pred`: then
    one as MC's is, random samples under the inter TUs and zeros
    elsewhere.  exclusive: every TU alone in a 32x32 tile, and no
    reference inside a tile of a TU of its own step (a scan the kernel
    and its plain version run alike: no TU reads what its step writes)."""
    from p265_tpu_torch.plan.frame_plan import PlanePlan, TuBatch
    rows, cols = shape
    pp = PlanePlan(0, tuple(shape), 10)
    r0, c0 = max(0, rows - 4096) // 32, max(0, cols - 4096) // 32
    ty, tx = rows // 32 - r0, cols // 32 - c0
    tiles = iter(rng.permutation(ty * tx).tolist()) if exclusive else None
    owner = {}           # tile -> the step of the TU that writes it
    for log2 in (2, 3, 4, 5):
        s, n = 1 << log2, per_size
        step = np.sort(np.where(rng.random(n) < 1 / 3, 1,
                                rng.integers(2, 10, n)))
        inter = step == 1

        def at(hi, k):
            lo = max(0, hi - 4096)
            return lo + rng.integers(0, (hi - lo) // s, k) * s

        def flags(*sh):
            return rng.random(sh) < 0.5
        nr = 4 * s + 2
        pos = np.stack([at(rows, n), at(cols, n)], 1)
        if exclusive:
            t = np.array([next(tiles) for _ in range(n)])
            pos = np.stack([(r0 + t // tx) * 32 + rng.integers(0, 32 // s, n)
                            * s, (c0 + t % tx) * 32
                            + rng.integers(0, 32 // s, n) * s], 1)
            owner.update(zip(t.tolist(), step.tolist()))
        pp.batches[log2] = TuBatch(
            size=s, pos=pos.astype(np.int32),
            step=step.astype(np.int32),
            coeffs=rng.integers(-64, 65, (n, s, s)).astype(np.int32),
            qp=rng.integers(0, 52, n).astype(np.int32),
            mode=rng.integers(0, 35, n).astype(np.int32),
            c_idx=np.zeros(n, np.int32),
            is_dst=flags(n) & (log2 == 2) & ~inter,   # intra luma only
            tskip=flags(n) & (log2 == 2), has_res=np.ones(n, bool),
            bypass=rng.random(n) < 0.1, scale_m=None, inter=inter,
            filter_flag=flags(n), strong_allowed=flags(n), dc_edge=flags(n),
            ref_ys=rng.integers(max(0, rows - 4096), rows, (n, nr)).astype(
                np.int32),
            ref_xs=rng.integers(max(0, cols - 4096), cols, (n, nr)).astype(
                np.int32),
            ref_ok=flags(n, nr), ok_scan=flags(n, 4 * s + 1))
    if exclusive:   # draw again every reference inside a tile of its step
        for b in pp.batches.values():
            for u in range(len(b.step)):
                while True:
                    tl = ((b.ref_ys[u] // 32 - r0) * tx
                          + b.ref_xs[u] // 32 - c0)
                    bad = np.array([owner.get(int(t)) == b.step[u]
                                    for t in tl])
                    if not bad.any():
                        break
                    k = int(bad.sum())
                    b.ref_ys[u, bad] = rng.integers(r0 * 32, rows, k)
                    b.ref_xs[u, bad] = rng.integers(c0 * 32, cols, k)
    if inter_pred:
        pp.inter_pred = np.zeros(shape, np.int32)
        for b in pp.batches.values():
            for y, x in b.pos[b.inter]:
                pp.inter_pred[y:y + b.size, x:x + b.size] = rng.integers(
                    0, 256, (b.size, b.size))
    return pp
