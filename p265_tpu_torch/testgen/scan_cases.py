"""Random intra scans for holding the scan kernel (csrc/scan.cu) against
its plain version, wavefront.scan_packed_ref: `random_scan` builds the
expand() fields and step starts of one scan over a random plane, with
every mode, size and flag, unavailable references, empty steps, steps
wider than the kernel's warps and steps of one TU; `wide_scan` builds one
at 4K plane width whose steps have more work items than the kernel's
cluster has warps, each step reading what earlier steps wrote."""
from __future__ import annotations

import numpy as np
import torch


def random_scan(rng, dev, n_steps: int = 48, per_size: int = 140,
                one_a_step: bool = False):
    """A random scan over a random 1024x1024 int32 plane -> (stacked,
    starts, n_steps, plane): per size 4..32, `per_size` TUs over the steps
    (a fifth of the steps left empty), each mode 0..34 at least 4 times
    when per_size >= 140, random filter_flag / strong_allowed / dc_edge,
    residuals to +-300; or, with one_a_step, exactly one TU a step, the
    sizes in turn.  Every TU writes a 32x32 tile (rows 32 on) that no
    other TU of its step writes (a later step may write it again); its
    references are anywhere but in the tiles its own step writes, all
    available, none, or a random mix, and a third of the unavailable ones
    point outside the plane.  Row 0 is a ramp that no TU writes: every
    third 32x32 TU reads it on both edges, so the strong-smoothing
    flatness test passes there (and fails elsewhere)."""
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
        far = ~ok & (rng.random((n, nr)) < 0.33)
        idx[far] = rng.choice([-7, -3 * cols, rows * cols + 11, 10 ** 12],
                              int(far.sum()))
        mode = rng.permutation(np.arange(n) % 35).astype(np.int32)
        ff, sa, de = (rng.random(n) < 0.5 for _ in range(3))
        if log2 == 5:
            flat = np.arange(n) % 3 == 0
            x0 = rng.integers(0, cols - nr // 2, (n, 2))
            ramp = np.concatenate([x0[:, :1] + np.arange(nr // 2),
                                   x0[:, 1:] + np.arange(nr // 2)], 1)
            idx[flat], ok[flat], ff[flat] = ramp[flat], True, True
        stacked[log2] = _fields(rng, dev, s, idx, ok, mode, ff, sa, de, pos)
        starts[log2] = np.searchsorted(st, np.arange(n_steps + 1))
    return stacked, starts, n_steps, torch.from_numpy(plane).to(dev)


def _fields(rng, dev, s, idx, ok, mode, ff, sa, de, pos) -> dict:
    """One size bucket of expand() fields on `dev`, with random residuals
    to +-300."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in dict(
        ref_idx=idx.astype(np.int64), ref_ok=ok, mode=mode,
        filter_flag=ff, strong_allowed=sa, dc_edge=de,
        pos=pos.astype(np.int64),
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


def wide_scan(rng, dev, n_steps: int = 4, cols: int = 3840):
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
        idx = y * cols + rng.integers(0, cols, (n, nr))
        r = rng.random(n)
        ok = np.where((r < 0.4)[:, None], True, np.where(
            (r < 0.5)[:, None], False, rng.random((n, nr)) < 0.7))
        far = ~ok & (rng.random((n, nr)) < 0.33)
        idx[far] = rng.choice([-7, -3 * cols, rows * cols + 11, 10 ** 12],
                              int(far.sum()))
        mode = rng.permutation(np.arange(n) % 35).astype(np.int32)
        ff, sa, de = (rng.random(n) < 0.5 for _ in range(3))
        stacked[log2] = _fields(rng, dev, s, idx, ok, mode, ff, sa, de, pos)
        starts[log2] = np.searchsorted(st, np.arange(n_steps + 1))
    return stacked, starts, n_steps, torch.from_numpy(plane).to(dev)
