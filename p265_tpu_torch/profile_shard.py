"""Sharded decode on CUDA cards: the space axis (one picture's rows over
the ranks) and the stream axis (independent streams over the ranks), one
process a rank.

    python -m p265_tpu_torch.profile_shard [--ranks N] [--config5]

Decodes s1080_ldp4 with the unsharded TorchDecoder (a warm-up pass, then
a timed pass), then over N ranks (default 2): the space axis with
SpatialDecoder (two passes, every picture of both passes bit-exact against
the unsharded planes), then the stream axis with one copy of s1080_ldp4 a
rank through decode_segments_production (bit-exact too).  Prints the
card, the transport and, per rank, each picture's wall seconds (to its
planes on the host), collectives and bytes, and the kernel launches,
beside the unsharded decoder's per-picture wall; the last line is one JSON
object.

--config5 decodes BASELINE configuration 5 instead (the four 4K
random-access streams of testgen/streams.py CONFIG5), every plane of every
picture checked against the committed golden MD5s (data/GOLDEN_MD5): the
stream axis (the four streams' IRAP segments round robin over the ranks;
per rank its segments, wall, launches and peak memory; streams/s and
pictures/s over all ranks), the global batch (decode_streams_distributed:
the four IRAP pictures as one batch, each rank owning 4 / N streams) and
the space axis (s4k_ra5_s5 through SpatialDecoder over every rank: each
picture's wall, collectives and bytes).  N must divide 4.

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


def _is_md5(ref) -> bool:
    return isinstance(ref, dict) and isinstance(next(iter(ref)), tuple)


def _load(ref):
    """A reference as _check takes it: an .npz path is loaded."""
    return np.load(ref) if isinstance(ref, str) else ref


def _peak(device):
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def _check(frames, ref, what: str, complete: bool = True) -> None:
    """Raise unless every plane of `frames` equals the reference's: a
    planes_of mapping or an .npz file of one, or golden MD5s
    ({(poc, stage, plane): md5}, testgen/streams.py; `complete`: every
    picture they list was decoded)."""
    if _is_md5(ref):
        from p265_tpu_torch.testgen.streams import check_md5
        check_md5(frames, ref, what, complete)
        return
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
    `passes` times, each picture checked against the reference planes
    (an .npz of planes_of, or golden MD5s).  Returns per pass its
    per-picture records, kernel launches and peak device memory."""
    from p265_tpu_torch.kernels import _build
    from p265_tpu_torch.shard import mesh
    from p265_tpu_torch.shard.spatial import SpatialDecoder
    ref = _load(ref_path)
    out = []
    for _ in range(passes):
        _reset_peak(device)
        _build.reset_launch_counts()
        mesh.reset_counts()
        dec = SpatialDecoder(dist.group.WORLD, device)
        frames = dec.decode_stream(data)
        launches = dict(_build.LAUNCHES)
        _check(frames, ref, f"space axis, rank {rank}/{world}")
        out.append(dict(pictures=dec.pictures, launches=launches,
                        peak=_peak(device)))
    return out


def stream_axis(rank, world, device, streams: list, ref_paths: list
                ) -> dict:
    """Rank function: the IRAP segments of `streams`, round robin over the
    ranks, decoded by decode_segments_production; each checked against
    ref_paths[stream] (an .npz of planes_of, or golden MD5s of the
    stream), or where that is None against the golden decode of the
    segment.  -> its segments (stream, segment, frames), wall seconds,
    kernel launches and peak device memory."""
    from p265_tpu_torch.golden.decoder import GoldenDecoder
    from p265_tpu_torch.kernels import _build
    from p265_tpu_torch.shard.distributed import (decode_segments_production,
                                                  schedule_segments)
    work, layout = schedule_segments(streams, world, rank)
    _reset_peak(device)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    outs = decode_segments_production([w[2] for w in work], device)
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    for (si, gi, seg), frames in zip(work, outs):
        ref = (planes_of(GoldenDecoder().decode_stream(seg))
               if ref_paths[si] is None else _load(ref_paths[si]))
        _check(frames, ref, f"stream axis, rank {rank}/{world}, stream "
               f"{si} segment {gi}", complete=layout[si] == 1)
    return dict(segments=[[si, gi, len(f)] for (si, gi, _), f in
                          zip(work, outs)], seconds=seconds,
                launches=launches, peak=_peak(device))


def global_batch(rank, world, device, streams: list, expected: list
                 ) -> dict:
    """Rank function: the IRAP pictures of `streams` as one global batch
    over the ranks (shard/distributed.py decode_streams_distributed, the
    reference's global data-parallel batch): rank r owns streams
    r*k..r*k+k-1 (k = len(streams) / world); each prefilter plane of its
    pictures checked against expected[stream], the stream's golden MD5s
    (its IRAP picture is POC 0).  -> the streams it owned, wall seconds,
    kernel launches and peak device memory."""
    from p265_tpu_torch.kernels import _build
    from p265_tpu_torch.shard.distributed import (decode_streams_distributed,
                                                  global_mesh)
    from p265_tpu_torch.testgen.streams import plane_md5
    if len(streams) % world:
        raise ValueError(f"global batch: {len(streams)} streams over "
                         f"{world} ranks")
    k = len(streams) // world
    mine = list(range(rank * k, rank * k + k))
    _reset_peak(device)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    planes = decode_streams_distributed([streams[i] for i in mine],
                                        global_mesh(), device)
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    for si, pl in zip(mine, planes):
        for c in range(3):
            if plane_md5(_host(pl[c])) != expected[si][(0, "pre", c)]:
                raise RuntimeError(f"global batch, rank {rank}/{world}: "
                                   f"stream {si} plane {c} differs from "
                                   "golden's MD5")
    return dict(streams=mine, seconds=seconds, launches=launches,
                peak=_peak(device))


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


def config5_streams() -> list:
    """[(name, bytes, golden MD5s)] of the CONFIG5 streams, from the
    committed files and data/GOLDEN_MD5."""
    from p265_tpu_torch.testgen.streams import (CONFIG5, get_stream,
                                                golden_md5_of)
    return [(n, get_stream(n), golden_md5_of(n)) for n in CONFIG5]


def run_config5(ranks: int, timeout: float = TIMEOUT_S,
                streams: list | None = None) -> dict:
    """BASELINE configuration 5 over `ranks` ranks: the stream axis on the
    streams, the global batch of their IRAP pictures and the space axis
    on the first stream (s4k_ra5_s5), in that order in each rank, every
    plane checked against the golden MD5s inside the ranks.  streams:
    [(name, bytes, golden MD5s)], default config5_streams().  ->
    dict(backend, names, pictures (per stream), stream, batch, space: per
    rank the rank functions' records; streams_per_s, pictures_per_s: the
    stream axis over all ranks, from its slowest rank's wall).  Build the
    kernels first."""
    names, data, expected = zip(*(streams or config5_streams()))
    names, data, expected = list(names), list(data), list(expected)
    backend, res = run_ranks(
        [(stream_axis, (data, expected)), (global_batch, (data, expected)),
         (space_axis, (data[0], expected[0], 1))], ranks, timeout)
    pictures = [len({poc for poc, _, _ in e}) for e in expected]
    wall = max(r[0]["seconds"] for r in res)
    return dict(backend=backend, names=names, pictures=pictures,
                stream=[r[0] for r in res], batch=[r[1] for r in res],
                space=[r[2][0] for r in res],
                streams_per_s=len(names) / wall,
                pictures_per_s=sum(pictures) / wall)


def _mib(nbytes) -> str:
    return "n/a" if nbytes is None else f"{nbytes / 2 ** 20:.1f} MiB"


def config5_lines(rec: dict) -> list:
    """run_config5's record as text lines, one a rank and axis."""
    names = rec["names"]
    out = []
    for rank, (st, bt, sp) in enumerate(zip(rec["stream"], rec["batch"],
                                            rec["space"])):
        out.append(
            f"config 5 rank {rank} stream axis: "
            + ", ".join(f"{names[si]} ({f} pictures)"
                        for si, _, f in st["segments"])
            + f" bit-exact vs golden MD5 in {st['seconds']:.4f} s; peak "
            f"{_mib(st['peak'])}; launches {st['launches']}")
        out.append(
            f"config 5 rank {rank} global batch: IRAP pictures of "
            + ", ".join(names[si] for si in bt["streams"])
            + f" bit-exact vs golden MD5 in {bt['seconds']:.4f} s; peak "
            f"{_mib(bt['peak'])}; launches {bt['launches']}")
        out.append(
            f"config 5 rank {rank} space axis, {names[0]} bit-exact vs "
            "golden MD5; per picture (wall s, collectives, bytes): "
            + ", ".join(f"poc {p['poc']} {p['seconds']:.4f} "
                        f"{p['collectives']} {p['bytes']}"
                        for p in sp["pictures"])
            + f"; peak {_mib(sp['peak'])}; launches {sp['launches']}")
    out.append(f"config 5 stream axis over {len(rec['stream'])} ranks "
               f"({rec['backend']}): {rec['streams_per_s']:.4f} streams/s, "
               f"{rec['pictures_per_s']:.4f} pictures/s (slowest rank's "
               "wall)")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--config5", action="store_true",
                    help="decode BASELINE configuration 5 (see above)")
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
    if args.config5:
        t0 = time.perf_counter()
        rec = run_config5(args.ranks, timeout=2 * TIMEOUT_S)
        for line in config5_lines(rec):
            print(line, flush=True)
        print(f"config 5: {time.perf_counter() - t0:.1f} s", flush=True)
        print(json.dumps(dict(card=smi, ranks=args.ranks, **rec)),
              flush=True)
        return
    with open(STREAM, "rb") as f:
        data = f.read()

    class Timed(TorchDecoder):
        def _run_recon_group(self, tasks):
            t0 = time.perf_counter()
            super()._run_recon_group(tasks)
            self.pictures.append(dict(poc=tasks[0]["plan"].poc,
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
