"""A cell on several cards: one process a card, started with the `spawn`
method, each running cell.run_rank on `cuda:<rank>`.  Each process talks
to this one over a pipe of its own: it reports when its set-up is done,
opens its window when every rank has reported (the barrier), and sends
its summary back.  Pipes are socket pairs, so the run makes no named
semaphore and no file in /dev/shm, and needs no rendezvous address."""
from __future__ import annotations

import os
import time
import traceback
from multiprocessing.connection import wait


def _rank_main(cell, seed, seconds, trace, device, rank, nranks,
               conn) -> None:
    try:
        import torch
        torch.set_num_threads(max(1, (os.cpu_count() or nranks) // nranks))
        if device == "cuda":
            torch.cuda.set_device(rank)
            device = f"cuda:{rank}"
        from decode_bench.harness.cell import run_rank

        def barrier():
            conn.send(("ready", rank, None))
            if conn.recv() != "go":
                raise RuntimeError("the run was stopped before its window")
        conn.send(("ok", rank, run_rank(cell, seed, seconds, trace, device,
                                        rank, nranks, barrier)))
    except Exception:  # noqa: BLE001 -- reported to the parent, which fails
        conn.send(("error", rank, traceback.format_exc()))
    finally:
        conn.close()


def _receive(conns: dict, deadline: float, what: str) -> dict:
    """{rank: payload} of one message of kind `what` from every rank;
    raises RuntimeError on an error, a closed pipe or the deadline."""
    got, waiting = {}, dict(conns)
    while waiting:
        left = deadline - time.monotonic()
        if left <= 0:
            raise RuntimeError(f"ranks {sorted(waiting)} did not report "
                               f"{what} before the deadline")
        for c in wait(list(waiting.values()), timeout=left):
            rank = next(r for r, x in waiting.items() if x is c)
            try:
                kind, _, payload = c.recv()
            except EOFError:
                raise RuntimeError(f"rank {rank} ended without a word")
            if kind == "error":
                raise RuntimeError(f"rank {rank}:\n{payload}")
            got[rank] = payload
            del waiting[rank]
    return got


def run_ranks(cell: dict, seed: int, seconds: float, trace: bool,
              device: str, nranks: int, deadline: float) -> list:
    """The summaries of every rank, in rank order; raises RuntimeError if
    a rank fails or the monotonic `deadline` passes first."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    conns, procs = {}, []
    try:
        for r in range(nranks):
            conns[r], theirs = ctx.Pipe()
            procs.append(ctx.Process(target=_rank_main,
                                     name=f"decode_bench-rank{r}",
                                     args=(cell, seed, seconds, trace, device,
                                           r, nranks, theirs)))
            procs[-1].start()
            theirs.close()      # the rank's end lives in the rank alone
        _receive(conns, deadline, "set-up")
        for c in conns.values():
            c.send("go")
        out = _receive(conns, deadline, "a summary")
    except RuntimeError:
        for c in conns.values():
            try:
                c.send("stop")
            except OSError:
                pass
        raise
    finally:
        for p in procs:
            p.join(timeout=30)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        for c in conns.values():
            c.close()
    return [out[r] for r in range(nranks)]
