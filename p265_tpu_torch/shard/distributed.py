"""Multi-process data-parallel decode: one process per rank, each on its
own device, over torch.distributed.

Counterpart of p265_tpu/shard/distributed.py.  Every process parses ONLY
the streams or IRAP segments it owns (they are independent: the codec's
own data-parallel axis) and decodes them on its device.  The JAX package
agreed on global program shapes with an allgather, so that every process
compiled identical XLA programs; eager torch has no programs to agree on,
so the port exchanges nothing but its results.

Deliberate difference from the reference: `split_irap_segments` keeps a
VPS, SPS or PPS NAL unit that appears in the middle of a segment in that
segment (and adds it to the parameter sets of every later segment); the
reference strips it from its segment, which then cannot be decoded on its
own when later slices of the segment need it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from p265_tpu_torch.golden.decoder import DecoderBase
from p265_tpu_torch.hls import nal as nal_mod
from p265_tpu_torch.plan.frame_plan import build_tensor_plan
from p265_tpu_torch.shard.decoder import sharded_multistream_recon
from p265_tpu_torch.shard.mesh import Mesh, all_gather


def initialize(coordinator: str, num_processes: int, process_id: int,
               backend: str = "gloo") -> None:
    """Join the process group: coordinator "host:port" (rank 0 listens
    there), the number of processes and this one's rank; backend "nccl"
    for CUDA tensors with one card a rank, "gloo" for CPU tensors or for
    ranks that share a card."""
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def global_mesh(axis: str = "stream") -> Mesh:
    """A 1-D mesh over every rank of the default group."""
    n, rank = dist.get_world_size(), dist.get_rank()
    return Mesh((axis,), (n,), (rank,), {axis: dist.group.WORLD},
                dist.group.WORLD)


def split_irap_segments(data: bytes) -> list[bytes]:
    """IRAP-delimited scheduling units: an Annex-B stream is cut at each
    IRAP picture whose slice has first_slice_segment_in_pic_flag set, and
    every segment is prefixed with all parameter sets seen before it, so
    that it decodes on its own.  A parameter set inside a segment stays
    there too.  Segments keep stream order."""
    arr = np.frombuffer(data, dtype=np.uint8)
    n = len(arr)
    sc = np.flatnonzero((arr[:-2] == 0) & (arr[1:-1] == 0) & (arr[2:] == 1))
    if len(sc) == 0:
        return [data]
    # a 4-byte start code owns its leading zero byte
    unit_starts = [int(s) - (1 if s > 0 and arr[s - 1] == 0 else 0)
                   for s in sc]
    unit_starts.append(n)
    params = b""
    segments: list[bytes] = []
    cur: list[bytes] = []
    pending: list[bytes] = []   # parameter sets since the last other unit
    cur_has_slice = False
    for i, s in enumerate(unit_starts[:-1]):
        raw = data[s:unit_starts[i + 1]]
        hdr_off = int(sc[i]) + 3 - s
        if len(raw) < hdr_off + 3:
            cur.append(raw)
            continue
        t = (raw[hdr_off] >> 1) & 63
        if t in (nal_mod.NAL_VPS, nal_mod.NAL_SPS, nal_mod.NAL_PPS):
            params += raw
            pending.append(raw)
            continue
        first_in_pic = bool(raw[hdr_off + 2] & 0x80)
        if nal_mod.is_irap(t) and first_in_pic and cur_has_slice:
            segments.append(b"".join(cur))
            cur, cur_has_slice = [], False
        # a new segment opens with every parameter set so far; inside a
        # segment they stay where they were, for the units after them
        cur += pending if cur else [params]
        pending = []
        cur.append(raw)
        if nal_mod.is_slice_nal(t):
            cur_has_slice = True
    if cur:
        segments.append(b"".join(cur + pending))
    return segments


def schedule_segments(streams: list[bytes], num_processes: int,
                      process_id: int):
    """Round-robin IRAP segments of a stream batch over processes.

    Returns (my_work, layout): my_work = [(stream_idx, seg_idx, bytes)]
    owned by this process; layout = per-stream segment counts, so results
    can be put back in global order."""
    all_segs = [(si, gi, seg)
                for si, s in enumerate(streams)
                for gi, seg in enumerate(split_irap_segments(s))]
    my_work = [w for i, w in enumerate(all_segs)
               if i % num_processes == process_id]
    layout = [len(split_irap_segments(s)) for s in streams]
    return my_work, layout


def decode_segments_production(my_segments: list[bytes], device) -> list:
    """Decode this process's IRAP segments through the production
    PipelinedTorchDecoder on `device` (native parse, device MC from
    device-resident DPB slabs, loop filters, full DPB).  Returns per
    segment its DecodedFrames in output order."""
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    return [PipelinedTorchDecoder(device).decode_stream(seg)
            for seg in my_segments]


class _ParsePlans(DecoderBase):
    """Stage A alone: the frame plans of a stream in decode order."""

    def __init__(self):
        super().__init__(use_native_parse=True)
        self.plans: list = []

    def _schedule_recon(self, task: dict) -> None:
        self.plans.append(task["plan"])


def decode_streams_distributed(my_streams: list[bytes], mesh: Mesh, device,
                               axis: str = "stream") -> list:
    """Decode this process's streams as its share of a global
    data-parallel batch over mesh[axis]: the first picture of each stream
    (an IRAP picture) is parsed here only and reconstructed on `device`
    through sharded_multistream_recon.  Every rank must own as many
    streams.  Returns per local stream its [y, cb, cr] prefilter planes
    (uint8 tensors on `device`)."""
    device = torch.device(device)
    group = mesh.groups[axis]
    counts = all_gather(torch.tensor([len(my_streams)], device=device),
                        group)
    if bool((counts != len(my_streams)).any()):
        raise ValueError("decode_streams_distributed: the ranks own "
                         f"{counts.flatten().tolist()} streams; they must "
                         "own as many")
    rank = dist.get_rank(group)
    out = []
    for s in my_streams:
        p = _ParsePlans()
        p.decode_stream(s)
        tplan = build_tensor_plan(p.plans[0], skip_pred=True)
        out.append(sharded_multistream_recon(tplan, group, device)[rank])
    return out
