"""Ranks, process groups and the collectives of the sharded paths.

Counterpart of p265_tpu/shard/mesh.py.  The JAX package puts N devices in
one process under `shard_map`; the port runs ONE process per rank with one
device each (NCCL across cards, gloo for CPU tensors), and a mesh axis is
a process group:

  'stream' -- independent bitstreams (data parallel)
  'space'  -- CTU-row blocks within a picture (halo-exchanged stencils,
              row-sharded wavefront reconstruction)

Every collective here is an all-reduce: `all_gather` is an all-reduce
(sum) of a zero-filled [N, ...] buffer in which each rank fills its own
slot.  That one collective is carried by NCCL, by gloo for CPU tensors and
by gloo for CUDA tensors (two ranks that share one card: gloo has no
send/recv for CUDA tensors, and NCCL refuses two ranks on one card).
`COUNTS` counts the collectives and their bytes, so a run can report its
collectives per picture.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from p265_tpu_torch.tables import DCT8

COUNTS = {"collectives": 0, "bytes": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


@dataclass
class Mesh:
    """This rank's place in a layout of ranks: axis names, their sizes,
    this rank's index on each, and the process group of its line along
    each axis (`group` spans every rank of the mesh)."""
    axes: tuple
    shape: tuple
    coords: tuple
    groups: dict = field(default_factory=dict)
    group: object = None

    def size(self, axis: str) -> int:
        return self.shape[self.axes.index(axis)]

    def index(self, axis: str) -> int:
        return self.coords[self.axes.index(axis)]


def make_mesh(axes=("stream", "space")) -> Mesh:
    """A 2-D (stream, space) layout of every rank of the default group,
    (2, n/2) when the rank count n is even, else (1, n), as the JAX
    make_mesh reshapes its devices; rank r sits at (r // b, r % b).
    Collective: every rank must call it (dist.new_group)."""
    n, rank = dist.get_world_size(), dist.get_rank()
    a = 2 if n % 2 == 0 and n > 1 else 1
    b = n // a
    grid = np.arange(n).reshape(a, b)
    groups = {}
    # new_group is collective: every rank creates every line, in one order
    for ax, lines in ((axes[0], grid.T), (axes[1], grid)):
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[ax] = g
    return Mesh(tuple(axes), (a, b), (rank // b, rank % b), groups,
                dist.group.WORLD)


def _count(t: torch.Tensor) -> None:
    COUNTS["collectives"] += 1
    COUNTS["bytes"] += t.numel() * t.element_size()


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """[...] on every rank of `group` (same shape and dtype everywhere) ->
    [N, ...], slot i holding the tensor of the group's rank i.  One
    all-reduce."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    buf = torch.zeros((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    buf[rank] = t
    _count(buf)
    dist.all_reduce(buf, group=group)
    return buf


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over the ranks of `group` (in place, returned)."""
    _count(t)
    dist.all_reduce(t, group=group)
    return t


def local_rows(plane: torch.Tensor, rank: int, hl: int) -> torch.Tensor:
    """Rows [rank*hl, (rank+1)*hl) of a [H, W] plane, zero rows past H."""
    out = plane.new_zeros((hl,) + tuple(plane.shape[1:]))
    blk = plane[rank * hl:(rank + 1) * hl]
    out[:blk.shape[0]] = blk
    return out


def join_rows(gathered: torch.Tensor, h: int) -> torch.Tensor:
    """[N, hl, W] row blocks in rank order -> the [h, W] plane."""
    return gathered.reshape(-1, *gathered.shape[2:])[:h]


def gather_planes(planes: list, group) -> list:
    """Every rank's list of 2-D planes (shapes and count may differ from
    rank to rank, dtype not) -> per rank of `group`, its list of planes,
    on every rank.  Two all-reduces: the shapes, then the samples."""
    n = dist.get_world_size(group)
    dev, dt = planes[0].device, planes[0].dtype
    shapes = torch.zeros((16, 2), dtype=torch.int64, device=dev)
    if len(planes) > 16:
        raise ValueError("gather_planes: at most 16 planes")
    for i, p in enumerate(planes):
        shapes[i] = torch.tensor(p.shape)
    all_shapes = all_gather(shapes, group).cpu().numpy()
    sizes = all_shapes.prod(axis=2).sum(axis=1)
    flat = torch.zeros(int(sizes.max()), dtype=dt, device=dev)
    mine = torch.cat([p.reshape(-1) for p in planes])
    flat[:mine.numel()] = mine
    got = all_gather(flat, group)
    out = []
    for r in range(n):
        off, lst = 0, []
        for h, w in all_shapes[r]:
            if h * w == 0:
                break
            lst.append(got[r, off:off + h * w].view(int(h), int(w)))
            off += h * w
        out.append(lst)
    return out


def halo_exchange_rows(block: torch.Tensor, halo: int, group):
    """Exchange `halo` boundary rows with both row neighbours in `group`.

    block: [rows_local, W].  Returns (top_halo, bottom_halo): the previous
    rank's bottom rows and the next rank's top rows, zeros at the picture
    edges.  One all-reduce."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    g = all_gather(torch.cat([block[:halo], block[-halo:]]), group)
    zero = torch.zeros_like(block[:halo])
    top = g[rank - 1, halo:] if rank > 0 else zero
    bot = g[rank + 1, :halo] if rank < n - 1 else zero
    return top, bot


def sharded_stencil_step(mesh: Mesh, planes, device) -> torch.Tensor:
    """Demonstration step of the multi-rank path: per-stream 8-point DCT
    over 8-row bands, a vertical 3-tap stencil across the row shards with a
    1-row halo exchange, and a global checksum whose parity is added to
    every sample.  Counterpart of the JAX sharded_stencil_step.

    planes [S, H, W] integer, the same on every rank: S is split over
    'stream', H (in 8-row bands) over 'space'.  Returns the full [S, H, W]
    int32 result on every rank.  torch has no integer matmul on CUDA, so
    the band product is an int64 multiply-sum (exact: |sum| < 2^31)."""
    device = torch.device(device)
    a, b = mesh.size("stream"), mesh.size("space")
    i, j = mesh.index("stream"), mesh.index("space")
    planes = torch.as_tensor(np.asarray(planes)).to(device)
    S, H, W = planes.shape
    s, hl = S // a, H // b
    local = planes[i * s:(i + 1) * s, j * hl:(j + 1) * hl].long()
    m = torch.as_tensor(np.asarray(DCT8), dtype=torch.int64, device=device)
    bands = local.reshape(s, hl // 8, 1, 8, W // 8, 8)
    comp = ((m.view(1, 1, 8, 8, 1, 1) * bands).sum(3) >> 6).to(torch.int32)
    comp = comp.reshape(s, hl, W)
    # halo rows of every stream of the shard in one exchange
    rows = comp.permute(1, 0, 2).reshape(hl, s * W)
    top, bot = halo_exchange_rows(rows, 1, mesh.groups["space"])
    ext = torch.cat([top, rows, bot]).reshape(hl + 2, s, W).permute(1, 0, 2)
    sten = (ext[:, :-2] + 2 * ext[:, 1:-1] + ext[:, 2:]) >> 2
    checksum = all_sum(sten.sum(dtype=torch.int64).reshape(1), mesh.group)
    sten = sten + (checksum & 1).to(torch.int32)
    g = all_gather(sten, mesh.group)
    out = torch.empty((S, H, W), dtype=torch.int32, device=device)
    for r in range(a * b):
        ri, rj = divmod(r, b)
        out[ri * s:(ri + 1) * s, rj * hl:(rj + 1) * hl] = g[r]
    return out
