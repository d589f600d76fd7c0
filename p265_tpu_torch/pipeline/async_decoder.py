"""Pipelined torch decoder: host parse overlaps device reconstruction.

Counterpart of p265_tpu/pipeline/async_decoder.py `PipelinedTpuDecoder`.
Three stages on three threads:

- parse + tensor plan on the caller's thread (shapes are pure syntax, so
  the plan needs no reference pixels);
- one ordered recon worker: pack + device dispatch, strictly in decode
  order, so every picture's MC sees finished reference slabs;
- one fetch worker: the device-to-host copy of the output planes.

Device work is asynchronous behind the dispatch, so in steady state the
parse CPU, the pack CPU, the device and the copy engine run concurrently.
A worker's error is re-raised by flush(); the pictures after it are not
reconstructed.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from p265_tpu_torch.pipeline.decoder import TorchDecoder, fetch_planes


class PipelinedTorchDecoder(TorchDecoder):

    def __init__(self, device):
        super().__init__(device)
        self._q: queue.Queue = queue.Queue(maxsize=4)
        self._worker = None
        self._worker_err = None
        self._fetch_exec = None
        self._fetch_futs: list = []
        self._fetch_stream = None

    def _schedule_recon(self, task: dict) -> None:
        task["tplan"] = self._build_tplan(task["plan"])
        if self._worker is None:
            self._fetch_exec = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="p265-torch-fetch")
            self._worker = threading.Thread(
                target=self._run_worker, name="p265-torch-recon",
                daemon=True)
            self._worker.start()
        self._q.put(task)

    def _run_worker(self) -> None:
        while True:
            task = self._q.get()
            try:
                if task is None:
                    return
                if self._worker_err is None:
                    self._run_recon(task)
            except Exception as e:  # noqa: BLE001 -- re-raised by flush()
                self._worker_err = e
            finally:
                self._q.task_done()

    def _run_recon(self, task: dict) -> None:
        t0 = time.perf_counter()
        self._dispatch(task)
        event = None
        if self.device.type == "cuda":
            if self._fetch_stream is None:
                self._fetch_stream = torch.cuda.Stream(self.device)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self._fetch_futs.append(self._fetch_exec.submit(
            self._materialize, task["frame"], task["pic"].planes, event))
        self.stats["recon_s"] += time.perf_counter() - t0

    def _materialize(self, frame, planes, event) -> None:
        t0 = time.perf_counter()
        frame.planes = fetch_planes(planes, event, self._fetch_stream)
        self.stats["fetch_s"] += time.perf_counter() - t0

    def _drain_recon(self) -> None:
        """Wait for every queued picture and its fetch, stop both workers,
        and re-raise the first worker error."""
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
