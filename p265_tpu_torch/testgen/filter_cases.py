"""Random loop-filter cases for holding the filter kernels
(csrc/loopfilter.cu) against their plain versions and the plain versions
against the JAX package: `deblock_case` builds planes and per-segment edge
parameters for the vertical-edge filter, `deblock_planes_case` a batch's
luma and chroma planes with the parameters of both directions (the
`deblock_planes` layout), `sao_case` planes and per-CTB SAO maps, and
`bypass_masks` the bypass masks of the SAO store, all NumPy from a seeded
generator, the planes int32 and the parameters at the wire dtypes the
kernels read (pack_filter_params': the edge parameters int16, the SAO
maps int8); `layouts` lays planes out as the filters receive them,
`row_blocks` cuts a plane as the row-sharded SAO does, and
`tiled_deblock` is a model of the deblocking kernel's tiling.

The planes are 8-column blocks of a level each, the levels a random walk
(small steps, some large), with noise of an amplitude that varies by
block (none, small, large), clipped to 0..255, and bands of saturated
samples at 0 and at 255: flat blocks with small steps take the strong
filter, noisier ones the normal filter, the rest no filter, and the clamps
to 0..255 are reached.  The parameters span the 8-bit tables' range: bS in
{0, 1, 2}, beta 0..64, tc 0..24; SAO types off, band and edge, all four
edge classes, band positions 0..31 (28..31 wrap), offsets -7..7."""
from __future__ import annotations

import numpy as np
import torch

from p265_tpu_torch.syntax.ctu import SAO_BAND, SAO_EDGE

# luma and chroma shapes: heights multiples of 8 (chroma: of 4) and not of
# the CTB, widths that leave 4 (chroma: 2..4) columns after the last edge
SHAPES = {"luma": (2, 72, 136), "chroma": (4, 36, 68)}


def planes(rng, B: int, H: int, W: int) -> np.ndarray:
    """[B,H,W] int32 blocky planes in 0..255 (module docstring)."""
    nb = -(-W // 8)
    steps = rng.integers(-6, 7, (B, H, nb))
    big = rng.random((B, H, nb)) < 0.1
    steps[big] = rng.integers(-60, 61, int(big.sum()))
    # one level a 4-line segment and 8-column block, shared by its lines
    lev = 128 + np.cumsum(steps[:, ::4], axis=2)
    lev = np.repeat(lev, 4, axis=1)[:, :H]
    amp = rng.choice([0, 0, 1, 2, 6, 40], (B, H // 4 + 1, nb))
    amp = np.repeat(amp, 4, axis=1)[:, :H]
    out = np.repeat(lev, 8, axis=2)[:, :, :W]
    noise = rng.integers(-64, 65, (B, H, W))
    out = out + (noise * np.repeat(amp, 8, axis=2)[:, :, :W]) // 64
    sat = rng.random((B, H // 4 + 1, nb)) < 0.08
    sat = np.repeat(np.repeat(sat, 4, axis=1)[:, :H], 8, axis=2)[:, :, :W]
    out = np.where(sat, np.where(out > 128, 255, 0), out)
    return np.clip(out, 0, 255).astype(np.int32)


def n_edges(W: int) -> int:
    """Edges at x = 8(k+1), x < W: luma_edge_params' count on a luma plane
    of width W, chroma_edge_params' (every 16 luma samples) on a chroma
    plane of width W."""
    return len(range(8, W, 8))


def deblock_case(rng, B: int, H: int, W: int, chroma: bool = False) -> dict:
    """{"planes": [B,H,W] int32, "tc": [B,H//4,n_e], and for luma "bs" and
    "beta"} int16: a quarter of the segments have bS 0, and a tenth of the
    rest beta or tc 0."""
    return dict(planes=planes(rng, B, H, W),
                **_random_params(rng, (B, H // 4, n_edges(W)), chroma))


def deblock_planes_case(rng, F: int, H: int, W: int) -> dict:
    """{"luma": [F,H,W], "chroma": [2F,H/2,W/2]} int32 planes and the edge
    parameters of both directions under pack_filter_params' keys
    (bs/beta/tc/tcc _v: [., rows/4, edges along x]; _h: the transposed
    layout [., columns/4, edges along y]), drawn as deblock_case draws
    them."""
    Hc, Wc = H // 2, W // 2
    case = {"luma": planes(rng, F, H, W), "chroma": planes(rng, 2 * F, Hc,
                                                          Wc)}
    for key, (h, w), (hc, wc) in (("v", (H, W), (Hc, Wc)),
                                  ("h", (W, H), (Wc, Hc))):
        lp = _random_params(rng, (F, h // 4, n_edges(w)), chroma=False)
        cp = _random_params(rng, (2 * F, hc // 4, n_edges(wc)), chroma=True)
        case.update({f"{k}_{key}": v for k, v in lp.items()})
        case[f"tcc_{key}"] = cp["tc"]
    return case


def _random_params(rng, shape, chroma: bool) -> dict:
    """The edge parameters of one grid: tc, and bs, beta for luma."""
    tc = rng.integers(0, 25, shape)
    tc[rng.random(shape) < 0.1] = 0
    out = dict(tc=tc.astype(np.int16))
    if not chroma:
        bs = rng.integers(0, 3, shape)
        bs[rng.random(shape) < 0.25] = 0
        beta = rng.integers(0, 65, shape)
        beta[rng.random(shape) < 0.1] = 0
        out.update(bs=bs.astype(np.int16), beta=beta.astype(np.int16))
    return out


def tiled_deblock(luma, chroma, fp: dict, tile: tuple = (32, 32)) -> tuple:
    """A model, in plain torch, of how csrc/loopfilter.cu's deblock_tiles
    cuts deblock_planes: each (th, tw) tile of every plane (th, tw
    multiples of 8; the last ones partial) is cropped with a 4-sample halo
    on every side (zeros outside the plane), the crop is deblocked
    vertically, then horizontally, with the parameters of its own edges
    (those at the tile's left column and top row and every 8 samples after
    them, to the first past it), and only the tile's own samples are kept.
    The result equals deblock_planes_ref when the halo holds all that a
    tile's samples depend on."""
    from p265_tpu_torch.kernels import loopfilter as lf

    def lp(key):
        return [fp[f"{n}_{key}"] for n in ("bs", "beta", "tc")]

    return (_tiled(luma, lp("v"), lp("h"), lf.deblock_luma_vertical_ref,
                   tile),
            _tiled(chroma, [fp["tcc_v"]], [fp["tcc_h"]],
                   lf.deblock_chroma_vertical_ref, tile))


def _crop(a, i0: int, n: int, axis: int):
    """n entries of `a` along `axis` from i0, zeros outside it."""
    if not a.shape[axis]:
        shape = list(a.shape)
        shape[axis] = n
        return a.new_zeros(shape)
    idx = torch.arange(i0, i0 + n)
    ok = (idx >= 0) & (idx < a.shape[axis])
    got = a.index_select(axis, idx.clamp(0, a.shape[axis] - 1))
    shape = [1] * a.dim()
    shape[axis] = n
    return torch.where(ok.view(shape), got, torch.zeros((), dtype=a.dtype))


def _tile_params(ps: list, s0: int, k0: int, n_k: int, staged) -> list:
    """The parameters [B, S, K] of one direction cropped to a canvas: its
    4-sample segments from s0 (staged: the canvas's lines that hold
    samples) and n_k edges from k0; zero where no segment is staged or no
    edge exists."""
    seg = staged.view(-1, 4)[:, 0].view(1, -1, 1)
    return [_crop(_crop(p, s0, seg.shape[1], 1), k0, n_k, 2) * seg
            for p in ps]


def _tiled(planes, pv: list, ph: list, fn, tile: tuple):
    th, tw = tile
    B, H, W = planes.shape
    out = torch.empty((B, H, W), dtype=planes.dtype)
    # the crop sits at (8, 8) of a canvas of (th + 12, tw + 12), so that
    # the edges at the tile's top row and left column fall on the filter's
    # 8(k+1) grid; its first 4 rows and columns stay zero
    for y0 in range(0, H, th):
        for x0 in range(0, W, tw):
            canvas = _crop(_crop(planes, y0 - 8, th + 12, 1), x0 - 8,
                           tw + 12, 2)
            rows = (torch.arange(y0 - 8, y0 + th + 4) >= y0 - 4)
            cols = (torch.arange(x0 - 8, x0 + tw + 4) >= x0 - 4)
            canvas = canvas * (rows[:, None] & cols[None, :])
            v = _tile_params(pv, (y0 - 8) // 4, x0 // 8 - 1, tw // 8 + 1,
                             rows)
            canvas = fn(canvas, *v)
            h = _tile_params(ph, (x0 - 8) // 4, y0 // 8 - 1, th // 8 + 1,
                             cols)
            canvas = fn(canvas.transpose(1, 2), *h).transpose(1, 2)
            hh, ww = min(th, H - y0), min(tw, W - x0)
            out[:, y0:y0 + hh, x0:x0 + ww] = canvas[:, 8:8 + hh, 8:8 + ww]
    return out


def sao_case(rng, B: int, H: int, W: int, ctb: int) -> dict:
    """{"src": [B,H,W] int32, "ty", "cls": [B,ny,nx], "offs": [B,4,ny,nx]
    int8} with ny, nx = ceil(H/ctb), ceil(W/ctb), as pack_filter_params
    stages sao_maps: the CTB types off, band or edge (each about a third),
    band classes 0..31 with 28..31 at least once a plane, edge classes
    0..3, offsets -7..7."""
    ny, nx = -(-H // ctb), -(-W // ctb)
    ty = rng.choice([0, SAO_BAND, SAO_EDGE], (B, ny, nx))
    ty[:, 0, 0], ty[:, -1, -1] = SAO_BAND, SAO_EDGE
    band = rng.integers(0, 32, (B, ny, nx))
    band[:, 0, 0] = 28 + rng.integers(0, 4, B)
    cls = np.where(ty == SAO_EDGE, rng.integers(0, 4, (B, ny, nx)), band)
    cls[ty == 0] = rng.integers(0, 32, int((ty == 0).sum()))
    offs = rng.integers(-7, 8, (B, 4, ny, nx))
    return dict(src=planes(rng, B, H, W), ty=ty.astype(np.int8),
                cls=cls.astype(np.int8), offs=offs.astype(np.int8))


def bypass_masks(rng, B: int, H: int, W: int, unit: int = 8) -> np.ndarray:
    """[B,H,W] bool masks of random unit x unit blocks (about a tenth of
    them; the bypass CUs of a picture), one plane left without any."""
    ny, nx = -(-H // unit), -(-W // unit)
    blk = rng.random((B, ny, nx)) < 0.1
    blk[0, 0, 0] = True
    if B > 1:
        blk[-1] = False
    m = np.repeat(np.repeat(blk, unit, axis=1), unit, axis=2)
    return np.ascontiguousarray(m[:, :H, :W])


def layouts(a: np.ndarray, device) -> dict:
    """a [B,H,W] as tensors on `device` in the layouts the filters are
    handed: contiguous, a transposed view of [B,W,H] storage (the
    horizontal pass), and rows of a taller, wider plane (the batch path's
    segments of one tall plane)."""
    B, H, W = a.shape
    tall = torch.zeros((B, H + 8, W + 16), dtype=torch.int32, device=device)
    tall[:, :H, :W] = torch.from_numpy(a)
    return {"contiguous": torch.from_numpy(a).to(device),
            "transposed": torch.from_numpy(np.ascontiguousarray(
                a.transpose(0, 2, 1))).to(device).transpose(1, 2),
            "rows of a taller plane": tall[:, :H, :W]}


def row_blocks(plane: torch.Tensor, n: int, hl: int) -> list:
    """A [H,W] plane cut as the row-sharded SAO cuts it over n ranks:
    [(first row, block [hl,W], top halo [1,W], bottom halo [1,W])], rows
    past H zero, the halo rows zero at the picture's edges."""
    H, W = plane.shape
    pad = torch.cat([plane, plane.new_zeros((n * hl - H, W))])
    zero = plane.new_zeros((1, W))
    return [(r0, pad[r0:r0 + hl], pad[r0 - 1:r0] if r0 else zero,
             pad[r0 + hl:r0 + hl + 1] if r0 + hl < H else zero)
            for r0 in range(0, n * hl, hl)]
