"""Pipelined torch decoder: host parse overlaps device reconstruction.

Counterpart of p265_tpu/pipeline/async_decoder.py `PipelinedTpuDecoder`.
Three stages on three threads:

- parse + tensor plan + frame-DAG grouping on the caller's thread (shapes
  and the grouping rule are pure syntax, so neither needs reference
  pixels);
- one ordered recon worker: pack + device dispatch of one group at a time,
  strictly in decode order, so every picture's MC sees finished reference
  slabs;
- one fetch worker: the device-to-host copy of the output planes.

Device work is asynchronous behind the dispatch, so in steady state the
parse CPU, the pack CPU, the device and the copy engine run concurrently.

Groups are formed by TorchDecoder._schedule_recon on the caller's thread,
by the rule alone, before they reach the worker's queue (the reference's
_put_groups; there is nothing to compile, so its _warm_compile has no
counterpart).  The parse may run ahead of the reconstruction by the open
group (fewer than frame_dag_max pictures) plus the 4 groups the queue
holds; how far it actually is ahead never decides a group, so the same
stream gives the same groups on every run.

A worker's error is re-raised by flush() (and by save_state()); the
pictures queued after it are not reconstructed.  The reference's worker
keeps reconstructing after an error; the port's does not, with or without
error_resilient: resilience works on parse errors, which are raised and
caught on the caller's thread (tests/test_torch_aux.py holds both decoders
against golden on a truncated slice), and a picture that follows a failed
reconstruction would read slabs that were never written.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from p265_tpu_torch.pipeline.decoder import TorchDecoder, fetch_planes
from p265_tpu_torch.spans import span


class PipelinedTorchDecoder(TorchDecoder):

    def __init__(self, device="cuda", **kw):
        super().__init__(device, **kw)
        self._q: queue.Queue = queue.Queue(maxsize=4)
        self._worker = None
        self._worker_err = None
        self._fetch_exec = None
        self._fetch_futs: list = []
        self._fetch_stream = None

    def _emit_group(self, group: list) -> None:
        if self._worker is None:
            self._fetch_exec = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="p265-torch-fetch")
            self._worker = threading.Thread(
                target=self._run_worker, name="p265-torch-recon",
                daemon=True)
            self._worker.start()
        self._q.put((time.perf_counter(), group))

    def _run_worker(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                t_put, group = item
                # each picture of the group waited from the put to the get
                self.stats["queue_wait_s"] += ((time.perf_counter() - t_put)
                                               * len(group))
                if self._worker_err is None:
                    self._run_recon_group(group)
            except Exception as e:  # noqa: BLE001 -- re-raised by flush()
                self._worker_err = e
            finally:
                self._q.task_done()

    def _fetch(self, task: dict) -> None:
        """Hand the picture's device-to-host copy to the fetch worker; on
        CUDA it waits for an event recorded behind the picture's work."""
        event = None
        if self.device.type == "cuda":
            if self._fetch_stream is None:
                self._fetch_stream = torch.cuda.Stream(self.device)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self._fetch_futs.append(self._fetch_exec.submit(
            self._materialize, task["frame"], task["pic"].planes, event))

    def _materialize(self, frame, planes, event) -> None:
        with span(self.stats, "fetch"):
            frame.planes = fetch_planes(planes, event, self._fetch_stream)

    def _drain_recon(self) -> None:
        """Close the open group, wait for every queued picture and its
        fetch, stop both workers (the next picture starts new ones), and
        re-raise the first worker error."""
        self._close_group()
        if self._worker is None:
            return
        self._q.put(None)
        self._worker.join()
        self._worker = None
        futs, self._fetch_futs = self._fetch_futs, []
        self._fetch_exec.shutdown(wait=True)
        self._fetch_exec = None
        errs = [self._worker_err] + [f.exception() for f in futs]
        self._worker_err = None
        for err in errs:
            if err is not None:
                raise err
