"""Where the host time of Stage B goes, picture by picture.

    python -m p265_tpu_torch.profile_pack [stream] [--device cpu]
        [--reps 5] [--turns 2]

The counterpart of profiling/probe_pack.py.  The stream is a name of
p265_tpu_torch/testgen/streams.py, read from p265_tpu_torch/data (default
s1080, as the reference's).  After one warm-up decode by TorchDecoder on
`cuda` (or --device), it takes every picture as that decoder dispatched it
and times, best of `reps` on warm caches:

- `finalize_s`, one sample from the warm-up decode: the native parse's
  `finalize` of the picture (the motion replay and the SAO records),
  which runs once, when the picture's parse ends, outside parse_s and
  recon_s;
- each Stage-B host phase of the port: the tensor plan (`_build_tplan`),
  `merge_segments`, `hoist_inter`, `stack_plane`, `pack_filter_params`,
  and beside it the deblocking grids it derives, by the C call a picture
  (`edge_params_c`, native/deblock.py, what pack_filter_params runs where
  the native library loads) and by the NumPy reference
  (`edge_params_numpy`, luma_edge_params and chroma_edge_params),
  `mc_arrays` (P pictures: the MC pack over the PU table), `pcm_samples`,
  the whole `build_batch`, the staging fill (kernels/staging.py `fill`
  into a ring slot), the enqueue of its one copy (`send`), and the
  dispatch plus the fetch of the output planes (`decode_batch_planes` +
  `fetch_planes`, synchronised; its planes must equal the warm-up's);
- the "rest" of a dispatch, the part of a serial TorchDecoder dispatch
  that profile_decode's stage table charges to no stage: `ref_stacks`
  (P pictures), the hoisted inter TUs' K1 call, scatter
  and clip (`init_plane`) and the fetch, each synchronised; the serial
  dispatch itself (`_run_recon_group`, synchronised); and what is left of
  it when the parts the phases above time are taken away (`unexplained`).

Then it decodes the stream with TorchDecoder and PipelinedTorchDecoder in
turns (serial, pipelined, pipelined, serial, ...; `turns` passes of each),
each pass a fresh decoder ending with every plane on the host.  It prints
one JSON record on stdout, with the card's name and power limit as
nvidia-smi gives them.  A CUDA device that is not there raises: nothing
falls back to the CPU.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import time

import numpy as np
import torch


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def best(fn, reps: int, setup=None) -> float:
    """Best seconds of `reps` calls of fn(*setup()) (setup untimed)."""
    out = float("inf")
    for _ in range(reps):
        args = setup() if setup is not None else ()
        t0 = time.perf_counter()
        fn(*args)
        out = min(out, time.perf_counter() - t0)
    return out


def _warm_tasks(data: bytes, device):
    """One TorchDecoder decode; -> (decoder, its frames by POC, every
    dispatched task in decode order, each with "finalize_s": the seconds
    of its native parse state's finalize, which only its first call
    spends)."""
    from p265_tpu_torch.native.parse import NativeParseState
    from p265_tpu_torch.pipeline.decoder import TorchDecoder
    dec = TorchDecoder(device)
    tasks, spent = [], {}
    run, finalize = dec._run_recon_group, NativeParseState.finalize

    def spy(group):
        run(group)
        tasks.extend(group)

    def timed(self, plan, mctx=None):
        t0 = time.perf_counter()
        finalize(self, plan, mctx)
        spent[plan.poc] = spent.get(plan.poc, 0.0) + (
            time.perf_counter() - t0)
    dec._run_recon_group = spy
    NativeParseState.finalize = timed
    try:
        frames = dec.decode_stream(data)
    finally:
        NativeParseState.finalize = finalize
        del dec._run_recon_group
    for t in tasks:
        t["finalize_s"] = spent[t["plan"].poc]
    return dec, {f.poc: f for f in frames}, tasks


def picture(dec, task, frame, device, reps: int) -> dict:
    """The phases and the rest of one dispatched picture (module
    docstring)."""
    from p265_tpu_torch.kernels import loopfilter as lf
    from p265_tpu_torch.kernels import mc, staging
    from p265_tpu_torch.pipeline import batch_decode as bd
    from p265_tpu_torch.pipeline import wavefront as wf
    from p265_tpu_torch.pipeline.decoder import fetch_planes
    plan, tplan = task["plan"], task["tplan"]
    pps_ = list(tplan.planes)
    H, W = plan.sps.pic_height, plan.sps.pic_width
    seg = (H + wf.GUARD, (H >> 1) + wf.GUARD)

    merged = wf.merge_segments(pps_)
    wf.hoist_inter(merged)
    ph = dict(
        _build_tplan=best(lambda: dec._build_tplan(plan), reps),
        merge_segments=best(lambda: wf.merge_segments(pps_), reps),
        hoist_inter=best(wf.hoist_inter, reps,
                         lambda: (wf.merge_segments(pps_),)),
        stack_plane=best(lambda: wf.stack_plane(merged), reps),
        pack_filter_params=best(lambda: lf.pack_filter_params([plan]), reps),
        edge_params_c=best(lambda: lf._edge_grids_c([plan]), reps),
        edge_params_numpy=best(lambda: lf._edge_grids_numpy([plan]), reps))
    rest = {}
    mc_arr = refs = None
    if plan.pus:
        poc_list = sorted(task["refs"])
        slabs = {p: r.planes for p, r in task["refs"].items()}
        ph["mc_arrays"] = best(lambda: mc.mc_arrays(plan, poc_list), reps)
        mc_arr = [mc.mc_arrays(plan, poc_list)]

        def stacks():
            out = mc.ref_stacks(slabs, poc_list, device)
            _sync(device)
            return out
        rest["ref_stacks"] = best(stacks, reps)
        refs = [stacks()]
    ph["pcm_samples"] = best(lambda: mc.pcm_samples(
        plan, bd.segment_rows(1, 0, *seg), merged.shape[1]), reps)
    ph["build_batch"] = best(
        lambda: bd.build_batch([tplan], [plan], mc=mc_arr), reps)

    batch = bd.build_batch([tplan], [plan], mc=mc_arr)
    tu, starts = wf.scan_fields(batch["tu"])
    tree = dict(fp=batch["fp"], mc=batch["mc"], pcm=batch["pcm"],
                itu=batch["itu"], tu=tu,
                starts=wf.step_starts(starts, batch["n_steps"]))
    ring = staging.ring(device)
    arrays = [np.asarray(a) for a in staging.leaves(tree)]
    offs, nbytes = staging.layout(arrays)
    ph["staging_fill"] = best(lambda slot, buf: staging.fill(
        buf, arrays, offs), reps, lambda: ring.acquire(nbytes))
    ph["copy_enqueue"] = best(lambda slot, buf: ring.send(
        slot, buf, nbytes), reps, lambda: ring.acquire(nbytes))
    _sync(device)

    got = []

    def dispatch():
        pl, pc, fl, fc = bd.decode_batch_planes(batch, refs, device)
        got[:] = fetch_planes([fl[0], fc[0], fc[1]])
    ph["dispatch_fetch"] = best(dispatch, reps)
    if not all(np.array_equal(g, w) for g, w in zip(got, frame.planes)):
        raise RuntimeError(f"profile_pack: poc {plan.poc}: the timed "
                           "dispatch differs from the warm-up decode")

    dev = staging.stage(tree, device)
    total_h, pw = batch["meta"]["shape"]
    shape = (total_h + wf.GUARD, pw)
    pred = torch.zeros(shape, dtype=torch.int32, device=device)

    def init():
        wf.init_plane(dev["itu"], pred, shape, device)
        _sync(device)
    rest["init_plane"] = best(init, reps)
    rest["fetch"] = best(lambda: fetch_planes(task["pic"].planes), reps)

    def serial():
        dec._run_recon_group([task])
        _sync(device)
    rest["serial_dispatch"] = best(serial, reps)
    rest["unexplained"] = rest["serial_dispatch"] - sum(
        ph.get(k, 0.0) for k in ("mc_arrays", "build_batch",
                                 "dispatch_fetch")) - rest.get(
        "ref_stacks", 0.0)
    return dict(poc=plan.poc, kind="P" if plan.pus else "I",
                leaves=len(arrays), h2d_bytes=nbytes,
                finalize_s=task["finalize_s"], phases=ph, rest=rest)


def passes(data: bytes, device, turns: int) -> dict:
    """Warm passes of TorchDecoder and PipelinedTorchDecoder in turns ->
    {"serial": [s, ...], "pipelined": [...], "stats": {decoder: [the
    pass's stats (numbers)]}}."""
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    from p265_tpu_torch.pipeline.decoder import TorchDecoder
    kinds = {"serial": TorchDecoder, "pipelined": PipelinedTorchDecoder}
    out = {"serial": [], "pipelined": [],
           "stats": {"serial": [], "pipelined": []}}
    for i in range(turns):
        for kind in (("serial", "pipelined") if i % 2 == 0
                     else ("pipelined", "serial")):
            gc.collect()
            _sync(device)
            dec = kinds[kind](device)
            t0 = time.perf_counter()
            dec.decode_stream(data)
            _sync(device)
            out[kind].append(time.perf_counter() - t0)
            out["stats"][kind].append(
                {k: v for k, v in dec.stats.items()
                 if isinstance(v, (int, float))})
    return out


def run(stream: str = "s1080", device: str = "cuda", reps: int = 5,
        turns: int = 2) -> dict:
    """The record main() prints (module docstring)."""
    from p265_tpu_torch.testgen.streams import get_stream
    device = torch.device(device)
    rec = dict(stream=stream, device=str(device), reps=reps, card=None,
               smi=None)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("profile_pack: no CUDA card; pass --device "
                               "cpu")
        rec["card"] = torch.cuda.get_device_name(device)
        rec["smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    data = get_stream(stream)
    dec, frames, tasks = _warm_tasks(data, device)
    rec["pictures"] = [picture(dec, t, frames[t["plan"].poc], device, reps)
                       for t in tasks]
    rec["passes"] = passes(data, device, turns)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stream", nargs="?", default="s1080")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.stream, args.device, args.reps, args.turns)),
          flush=True)


if __name__ == "__main__":
    main()
