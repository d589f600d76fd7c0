"""Random cases for holding the residual kernel (csrc/itransform.cu) and
the MC kernel (csrc/mc.cu) against their plain versions, and the plain
versions against the JAX package.

`residual_groups` builds one batch_residual_grouped call at the wire
dtypes the kernel reads (levels int16 or int32, qp and scale_m uint8): TUs
of the four sizes, each size with counts that leave a partial last tile,
qp 0..51 in turn (so every size meets the left-shift branch of the
dequant, qp/6 above its bit depth), DST, transform skip and bypass flags,
optional scaling matrices (some all 255), a few TUs of saturating levels
(+-2^15), and for the plane epilogue optional TU positions, each TU alone
in a 32x32 tile of a plane.

`pred_case` builds one picture for mc_pred_planes: reference stacks of
random samples, and per plane (y, cb, cr) MC blocks of every bucket laid
out without overlap on the bucket's grid (about an eighth of the plane
stays uncovered), in mc_arrays_padded's layout with `pad` pad rows a bucket at
(plane height, 0); a tenth of the blocks have MVs up to `far` pixels, the
rest up to a tenth of that, so windows cross every edge; with `has_bi`, 60%
of the blocks bi-predicted; with `weighted`, explicit weights and offsets
in -128..127 (negative ones too) and log2_wd 0..7 a block, else the
identity rows (1, 0, 1, 0, 0) of unweighted prediction.  Everything is
NumPy from a seeded generator; `kernels.staging.stage` moves it to a
device."""
from __future__ import annotations

import numpy as np

from p265_tpu_torch.kernels.mc import CHROMA_BUCKETS, LUMA_BUCKETS

TILE = 1024   # samples of a residual kernel tile (csrc/itransform.cu)


def residual_groups(rng, n: int = 150, scale: bool = False,
                    dtype=np.int16, sizes=(2, 3, 4, 5),
                    plane: tuple | None = None) -> dict:
    """{log2: fields} of batch_residual_grouped (module docstring): about
    n TUs a size, never a whole number of tiles.  plane (rows, cols): each
    TU also gets a position `pos` [m,2] (uint16 below 65000 rows and
    columns, else int32) in a 32x32 tile of its own, in the last 4096 rows
    and columns of the plane (so past 32767 where the plane is that
    large)."""
    out = {}
    for log2 in sizes:
        s = 1 << log2
        per_tile = TILE >> (2 * log2)
        m = n + int(rng.integers(0, per_tile))
        if m % per_tile == 0 and per_tile > 1:
            m += 1
        lv = ((rng.random((m, s, s)) < 0.2)
              * rng.integers(-200, 200, (m, s, s))).astype(dtype)
        lv[:5] = rng.integers(-32768, 32768, (5, s, s))
        dst = (rng.random(m) < 0.4) if log2 == 2 else np.zeros(m, bool)
        tsk = (((rng.random(m) < 0.3) & ~dst) if log2 == 2
               else np.zeros(m, bool))
        f = dict(coeffs=lv, qp=(np.arange(m) % 52).astype(np.uint8),
                 is_dst=dst, tskip=tsk, bypass=rng.random(m) < 0.15)
        if scale:
            f["scale_m"] = rng.integers(1, 256, (m, s, s)).astype(np.uint8)
            f["scale_m"][:8] = 255
        out[log2] = f
    if plane is not None:
        rows, cols = plane
        r0, c0 = max(0, rows - 4096) // 32, max(0, cols - 4096) // 32
        ty, tx = rows // 32 - r0, cols // 32 - c0
        total = sum(f["qp"].shape[0] for f in out.values())
        if total > ty * tx:
            raise ValueError(f"residual_groups: {total} TUs, {ty * tx} "
                             f"tiles")
        tiles = iter(rng.permutation(ty * tx).tolist())
        dt = np.uint16 if max(rows, cols) < 65000 else np.int32
        for log2, f in out.items():
            s, m = 1 << log2, f["qp"].shape[0]
            t = np.array([next(tiles) for _ in range(m)], np.int64)
            f["pos"] = np.stack(
                [(r0 + t // tx) * 32 + rng.integers(0, 32 // s, m) * s,
                 (c0 + t % tx) * 32 + rng.integers(0, 32 // s, m) * s],
                1).astype(dt)
    return out


def _blocks(rng, h: int, w: int, sizes, fill: float) -> dict:
    """{size: [k,2] (y, x)}: blocks of the sizes, largest first, on each
    size's grid, never overlapping; a free cell takes a block with
    probability `fill`."""
    taken = np.zeros((h, w), bool)
    out = {}
    for b in sizes:
        gh, gw = h // b, w // b
        free = ~taken[:gh * b, :gw * b].reshape(gh, b, gw, b).any((1, 3))
        pick = free & (rng.random((gh, gw)) < fill)
        ys, xs = np.nonzero(pick)
        out[b] = np.stack([ys * b, xs * b], 1).astype(np.int32)
        cover = np.repeat(np.repeat(pick, b, 0), b, 1)
        taken[:gh * b, :gw * b] |= cover
    return out


def pred_case(rng, H: int, W: int, has_bi: bool = False,
              weighted: bool = False, far: int = 300, pad: int = 5,
              R: int = 3, fill: float = 0.5) -> tuple:
    """(stacks, arrays, shapes) of one picture (module docstring): stacks
    (y, cb, cr) uint8 [R, h, w]; arrays {"y": {16: fields, 8: .., 4: ..},
    "c": {8: .., 4: .., 2: ..}} as mc_arrays_padded gives them; shapes the
    three plane shapes."""
    shapes = ((H, W), (H >> 1, W >> 1), (H >> 1, W >> 1))
    stacks = tuple(rng.integers(0, 256, (R, h, w)).astype(np.uint8)
                   for h, w in shapes)
    arrays = {}
    for grp, sizes, (h, w), unit in (("y", LUMA_BUCKETS, shapes[0], 4),
                                     ("c", CHROMA_BUCKETS, shapes[1], 8)):
        arrays[grp] = {}
        for b, pos in _blocks(rng, h, w, sizes, fill).items():
            k = len(pos)
            m = k + pad
            full = np.zeros((m, 2), np.int32)
            full[:k] = pos
            full[k:] = (h, 0)
            reach = np.where(rng.random(m) < 0.1, far,
                             max(1, far // 10))[:, None]
            d = dict(pos=full)
            for lx in range(2):
                d[f"mv{lx}"] = (rng.integers(-1 << 20, 1 << 20, (m, 2))
                                % (2 * reach * unit + 1)
                                - reach * unit).astype(np.int32)
                d[f"r{lx}"] = rng.integers(0, R, m).astype(np.int32)
            d["has1"] = (rng.random(m) < 0.6) if has_bi else np.zeros(m, bool)
            if not has_bi:
                d["mv1"][:] = 0
                d["r1"][:] = 0
            for c in ((0,) if grp == "y" else (1, 2)):
                wp = np.zeros((m, 5), np.int32)
                wp[:, 0] = wp[:, 2] = 1
                if weighted:
                    wp[:, :4] = rng.integers(-128, 128, (m, 4))
                    wp[:, 4] = rng.integers(0, 8, m)
                d[f"wp_{c}"] = wp
            arrays[grp][b] = d
    return stacks, arrays, shapes
