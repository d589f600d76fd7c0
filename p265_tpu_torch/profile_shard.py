"""Sharded decode on CUDA cards: the space axis (one picture's rows over
the ranks) and the stream axis (independent streams over the ranks), one
process a rank.

    python -m p265_tpu_torch.profile_shard [--ranks N]

Decodes s1080_ldp4 with the unsharded TorchDecoder (a warm-up pass, then
a timed pass), then over N ranks (default 2): the space axis with
SpatialDecoder (two passes, every picture of both passes bit-exact against
the unsharded planes), then the stream axis with one copy of s1080_ldp4 a
rank through decode_segments_production (bit-exact too).  Prints the
card, the transport and, per rank, each picture's wall seconds (to its
planes on the host), collectives and bytes, and the kernel launches,
beside the unsharded decoder's per-picture wall; the last line is one JSON
object.

Transport: NCCL with one rank a card when there are at least N cards;
else the N ranks share cuda:0 over gloo (NCCL refuses two ranks on one
card), or the CPU where there is no card (the tests rehearse run_ranks
so).  chip_smoke.py's sharded phase runs the same rank functions.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import queue
import socket
import subprocess
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

STREAM = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "s1080_ldp4.265")
TIMEOUT_S = 600


def transport(ranks: int) -> tuple:
    """(backend, card index of each rank; None: the CPU, where no card)."""
    n = torch.cuda.device_count()
    if n >= ranks:
        return "nccl", list(range(ranks))
    return "gloo", [0 if n else None] * ranks


def planes_of(frames) -> dict:
    """The planes of decoded frames, before and after the filters, as
    uint8 arrays keyed "{poc}_{pre|post}_{c}"."""
    out = {}
    for f in frames:
        for c in range(3):
            out[f"{f.poc}_pre_{c}"] = _host(f.prefilter[c])
            out[f"{f.poc}_post_{c}"] = _host(f.planes[c])
    return out


def _host(p) -> np.ndarray:
    if isinstance(p, torch.Tensor):
        p = p.cpu().numpy()
    return np.asarray(p, np.uint8)


def _check(frames, ref, what: str) -> None:
    """Raise unless every plane of `frames` equals the reference's (a
    planes_of mapping, or an .npz file of one)."""
    n_ref = len({k.split("_")[0] for k in ref})
    if len(frames) != n_ref:
        raise RuntimeError(f"{what}: {len(frames)} frames, reference has "
                           f"{n_ref}")
    for f in frames:
        for c in range(3):
            for kind, p in (("pre", f.prefilter[c]), ("post", f.planes[c])):
                if not np.array_equal(_host(p), ref[f"{f.poc}_{kind}_{c}"]):
                    raise RuntimeError(f"{what}: poc {f.poc} {kind}filter "
                                       f"plane {c} differs from the "
                                       "reference")


def space_axis(rank, world, device, data: bytes, ref_path: str,
               passes: int = 1) -> list:
    """Rank function: decode `data` with SpatialDecoder over every rank,
    `passes` times, each picture checked against the reference planes.
    Returns per pass its per-picture records and kernel launches."""
    from p265_tpu_torch.kernels import _build
    from p265_tpu_torch.shard import mesh
    from p265_tpu_torch.shard.spatial import SpatialDecoder
    ref = np.load(ref_path)
    out = []
    for _ in range(passes):
        _build.reset_launch_counts()
        mesh.reset_counts()
        dec = SpatialDecoder(dist.group.WORLD, device)
        frames = dec.decode_stream(data)
        launches = dict(_build.LAUNCHES)
        _check(frames, ref, f"space axis, rank {rank}/{world}")
        out.append(dict(pictures=dec.pictures, launches=launches))
    return out


def stream_axis(rank, world, device, streams: list, ref_paths: list
                ) -> dict:
    """Rank function: the IRAP segments of `streams`, round robin over the
    ranks, decoded by decode_segments_production; each checked against
    ref_paths[stream] (an .npz of planes_of), or where that is None
    against the golden decode of the segment."""
    from p265_tpu_torch.golden.decoder import GoldenDecoder
    from p265_tpu_torch.kernels import _build
    from p265_tpu_torch.shard.distributed import (decode_segments_production,
                                                  schedule_segments)
    work, _ = schedule_segments(streams, world, rank)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    outs = decode_segments_production([w[2] for w in work], device)
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    for (si, gi, seg), frames in zip(work, outs):
        ref = (planes_of(GoldenDecoder().decode_stream(seg))
               if ref_paths[si] is None else np.load(ref_paths[si]))
        _check(frames, ref, f"stream axis, rank {rank}/{world}, stream "
               f"{si} segment {gi}")
    return dict(segments=[[si, gi, len(f)] for (si, gi, _), f in
                          zip(work, outs)], seconds=seconds,
                launches=launches)


def _free_addr() -> str:
    s = socket.socket()
    s.bind(("localhost", 0))
    addr = f"localhost:{s.getsockname()[1]}"
    s.close()
    return addr


def _rank_main(jobs, rank, world, backend, card, addr, q) -> None:
    try:
        from p265_tpu_torch.shard.distributed import initialize
        device = torch.device("cpu")
        if card is not None:
            torch.cuda.set_device(card)
            device = torch.device("cuda", card)
        initialize(addr, world, rank, backend)
        try:
            res = [fn(rank, world, device, *args) for fn, args in jobs]
        finally:
            dist.destroy_process_group()
        q.put((rank, None, res))
    except BaseException:  # noqa: BLE001 -- reported to the parent
        q.put((rank, traceback.format_exc(), None))


def run_ranks(jobs: list, ranks: int, timeout: float = TIMEOUT_S) -> tuple:
    """Run `jobs` [(rank function, args)] in order in one spawned process a
    rank.  Returns (backend, per rank the list of the jobs' results).
    Any rank's failure, or the timeout, raises; every process is stopped
    before this returns.  Build the kernels first (kernels._build.library):
    the ranks then load the same library."""
    backend, cards = transport(ranks)
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    addr = _free_addr()
    procs = [ctx.Process(target=_rank_main, args=(jobs, r, ranks, backend,
                                                  cards[r], addr, q))
             for r in range(ranks)]
    got = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(got) < ranks:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"sharded run: timed out after {timeout} "
                                   f"s ({sorted(got)} of {ranks} ranks done)")
            try:
                rank, err, res = q.get(timeout=min(left, 5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in got]
                if dead:
                    raise RuntimeError(f"sharded run: rank(s) {dead} exited "
                                       "without a result")
                continue
            if err is not None:
                raise RuntimeError(f"sharded run: rank {rank} failed:\n{err}")
            got[rank] = res
    finally:
        for p in procs:
            if p.is_alive():
                p.join(timeout=30 if len(got) == ranks else 1)
            if p.is_alive():
                p.kill()
                p.join()
    return backend, [got[r] for r in range(ranks)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_shard: needs a CUDA device")
    from p265_tpu_torch.kernels import _build
    from p265_tpu_torch.pipeline.decoder import TorchDecoder
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    _build.library()
    with open(STREAM, "rb") as f:
        data = f.read()

    class Timed(TorchDecoder):
        def _run_recon(self, task):
            t0 = time.perf_counter()
            super()._run_recon(task)
            self.pictures.append(dict(poc=task["plan"].poc,
                                      seconds=time.perf_counter() - t0))

    for _ in range(2):   # a warm-up pass, then the timed one
        dec = Timed("cuda")
        dec.pictures = []
        frames = dec.decode_stream(data)
    unsharded = dec.pictures
    print("unsharded TorchDecoder, s per picture: "
          + ", ".join(f"poc {p['poc']} {p['seconds']:.4f}" for p in unsharded),
          flush=True)
    with tempfile.TemporaryDirectory() as d:
        ref = os.path.join(d, "ref.npz")
        np.savez(ref, **planes_of(frames))
        backend, res = run_ranks(
            [(space_axis, (data, ref, 2)),
             (stream_axis, ([data] * args.ranks, [ref] * args.ranks))],
            args.ranks)
    print(f"{args.ranks} ranks over {backend}; every picture bit-exact "
          "against the unsharded decode", flush=True)
    for rank, (space, stream) in enumerate(res):
        for i, pas in enumerate(space):
            print(f"rank {rank} space axis pass {i}: launches "
                  f"{pas['launches']}; per picture: " + ", ".join(
                      f"poc {p['poc']} {p['seconds']:.4f} s "
                      f"{p['collectives']} coll {p['bytes']} B"
                      for p in pas["pictures"]), flush=True)
        print(f"rank {rank} stream axis: {stream['segments']} in "
              f"{stream['seconds']:.4f} s, launches {stream['launches']}",
              flush=True)
    print(json.dumps(dict(card=smi, ranks=args.ranks, backend=backend,
                          unsharded=unsharded,
                          space=[r[0] for r in res],
                          stream=[r[1] for r in res])), flush=True)


if __name__ == "__main__":
    main()
