"""Row-sharded SAO: each rank filters its row block with 1-row halos.

Counterpart of p265_tpu/shard/filters.py.  SAO's edge offsets read a
1-sample neighbourhood, so a plane split into row blocks needs one halo
row from each neighbour.  Whether a neighbour exists is decided by the
GLOBAL row index, so rank 0's top halo and the last rank's bottom halo
(zeros) are never read as neighbours.  Bit-exact vs the unsharded SAO.
On CUDA tensors the row block runs through the SAO kernel of
csrc/loopfilter.cu (kernels/loopfilter.py sao_kernel, with the block's
first row and the picture's height); on CPU tensors through `_sao_local`,
its plain version.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from p265_tpu_torch.kernels.loopfilter import on_cuda, sao_kernel, sao_maps
from p265_tpu_torch.kernels.staging import widen
from p265_tpu_torch.shard.mesh import (all_gather, halo_exchange_rows,
                                       join_rows, local_rows)
from p265_tpu_torch.syntax.ctu import SAO_BAND, SAO_EDGE

_EO = ((0, -1, 0, 1), (-1, 0, 1, 0), (-1, -1, 1, 1), (-1, 1, 1, -1))


def _pick(k, keys, offs):
    """sum_i (k == keys[i]) * offs[i]."""
    return sum(torch.where(k == kv, o, 0) for kv, o in zip(keys, offs))


def _sao_local(local, top, bot, ty, cls, offs, row0: int, total_h: int):
    """SAO of a local row block [hl, W] int32 with its halo rows; ty, cls
    [hl, W] and offs [4, hl, W] are the per-sample CTB parameters."""
    ext = torch.cat([top, local, bot])                 # [hl+2, W]
    hl, W = local.shape
    dev = local.device
    v = local
    d_band = _pick(((v >> 3) - cls) & 31, (0, 1, 2, 3), offs)
    gy = row0 + torch.arange(hl, device=dev)[:, None]  # global row index
    xx = torch.arange(W, device=dev)[None, :]
    d_edges = []
    for (dy0, dx0, dy1, dx1) in _EO:
        n0 = torch.roll(ext, -dx0, 1)[1 + dy0:1 + dy0 + hl]
        n1 = torch.roll(ext, -dx1, 1)[1 + dy1:1 + dy1 + hl]
        valid = ((gy + dy0 >= 0) & (gy + dy0 < total_h)
                 & (xx + dx0 >= 0) & (xx + dx0 < W)
                 & (gy + dy1 >= 0) & (gy + dy1 < total_h)
                 & (xx + dx1 >= 0) & (xx + dx1 < W))
        e = torch.sign(v - n0) + torch.sign(v - n1)
        d_edges.append(torch.where(valid, _pick(e, (-2, -1, 1, 2), offs), 0))
    d_edge = torch.where(cls == 0, d_edges[0],
                         torch.where(cls == 1, d_edges[1],
                                     torch.where(cls == 2, d_edges[2],
                                                 d_edges[3])))
    delta = torch.where(ty == SAO_BAND, d_band,
                        torch.where(ty == SAO_EDGE, d_edge, 0))
    return (v + delta).clamp(0, 255)


def sao_rows(local, top, bot, ty_g, cls_g, offs_g, ctb: int, row0: int,
             total_h: int):
    """SAO of the row block [hl, W] int32 that starts at picture row row0,
    with its halo rows top and bot [1, W]; ty_g/cls_g [ny,nx] and offs_g
    [4,ny,nx] int8 are the plane's CTB maps (rows past the map take its
    last CTB row; they lie past the picture and are cut off; the plain
    version also takes int32 maps)."""
    if on_cuda(local, "sao_rows"):
        return sao_kernel(torch.cat([top, local, bot])[None], ty_g[None],
                          cls_g[None], offs_g[None], ctb, row0, total_h,
                          halo=1)[0]
    ty_g, cls_g, offs_g = (widen(t, torch.int32)
                           for t in (ty_g, cls_g, offs_g))
    hl, W = local.shape
    dev = local.device
    ys = ((row0 + torch.arange(hl, device=dev)) // ctb).clamp(
        max=ty_g.shape[0] - 1)
    xs = torch.arange(W, device=dev) // ctb
    return _sao_local(local, top, bot, ty_g[ys][:, xs], cls_g[ys][:, xs],
                      offs_g[:, ys][:, :, xs], row0, total_h)


def sao_sharded(plan, planes: list, group, device) -> list:
    """Row-block-sharded SAO over the ranks of `group`: [y, cb, cr] planes
    (the same on every rank; numpy or tensors) -> the filtered int32
    planes on `device`, on every rank.  Two collectives a filtered plane:
    the halo exchange and the gather of the blocks."""
    device = torch.device(device)
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    sh = plan.sh
    outs = []
    for c in range(3):
        plane = torch.as_tensor(planes[c]).to(device=device,
                                               dtype=torch.int32)
        if not (sh.sao_luma if c == 0 else sh.sao_chroma):
            outs.append(plane)
            continue
        H, W = plane.shape
        ctb = plan.sps.ctb_size if c == 0 else plan.sps.ctb_size >> 1
        hl = -(-H // (n * 8)) * 8      # row blocks on an 8-row grid
        local = local_rows(plane, rank, hl)
        top, bot = halo_exchange_rows(local, 1, group)
        # the CTB maps at the kernel's wire dtype, cast on the host
        out = sao_rows(local, top, bot, *(torch.from_numpy(a.astype(
            np.int8)).to(device) for a in sao_maps(plan, c)),
                       ctb, rank * hl, H)
        outs.append(join_rows(all_gather(out, group), H))
    return outs
