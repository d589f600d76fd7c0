"""Random loop-filter cases for holding the filter kernels
(csrc/loopfilter.cu) against their plain versions and the plain versions
against the JAX package: `deblock_case` builds planes and per-segment edge
parameters for the vertical-edge filter, `sao_case` planes and per-CTB SAO
maps, all NumPy int32 from a seeded generator; `layouts` lays planes out
as the filters receive them, `row_blocks` cuts a plane as the row-sharded
SAO does.

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
    """{"planes": [B,H,W], "tc": [B,H//4,n_e], and for luma "bs" and
    "beta"} int32: a quarter of the segments have bS 0, and a tenth of the
    rest beta or tc 0."""
    shape = (B, H // 4, n_edges(W))
    tc = rng.integers(0, 25, shape)
    tc[rng.random(shape) < 0.1] = 0
    case = dict(planes=planes(rng, B, H, W), tc=tc.astype(np.int32))
    if not chroma:
        bs = rng.integers(0, 3, shape)
        bs[rng.random(shape) < 0.25] = 0
        beta = rng.integers(0, 65, shape)
        beta[rng.random(shape) < 0.1] = 0
        case.update(bs=bs.astype(np.int32), beta=beta.astype(np.int32))
    return case


def sao_case(rng, B: int, H: int, W: int, ctb: int) -> dict:
    """{"src": [B,H,W], "ty", "cls": [B,ny,nx], "offs": [B,4,ny,nx]} int32
    with ny, nx = ceil(H/ctb), ceil(W/ctb), as sao_maps builds them: the
    CTB types off, band or edge (each about a third), band classes 0..31
    with 28..31 at least once a plane, edge classes 0..3, offsets -7..7."""
    ny, nx = -(-H // ctb), -(-W // ctb)
    ty = rng.choice([0, SAO_BAND, SAO_EDGE], (B, ny, nx))
    ty[:, 0, 0], ty[:, -1, -1] = SAO_BAND, SAO_EDGE
    band = rng.integers(0, 32, (B, ny, nx))
    band[:, 0, 0] = 28 + rng.integers(0, 4, B)
    cls = np.where(ty == SAO_EDGE, rng.integers(0, 4, (B, ny, nx)), band)
    cls[ty == 0] = rng.integers(0, 32, int((ty == 0).sum()))
    offs = rng.integers(-7, 8, (B, 4, ny, nx))
    return dict(src=planes(rng, B, H, W), ty=ty.astype(np.int32),
                cls=cls.astype(np.int32), offs=offs.astype(np.int32))


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
