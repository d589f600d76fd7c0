"""Per-CU QP derivation with quantization groups (spec 8.6.1, 7.3.8.10).

One state machine driven identically by the decoder, the serializer, and the
encoder's planning walk, so the derived QPs can never diverge between them.
Events, in traversal order:
  start_segment(slice_qp)                 -- slice / tile / WPP row start
  maybe_start_qg(x0, y0)                  -- every coding_quadtree node
  set_delta(v)                            -- first coded TU of the group
  qp()                                    -- current luma QP
  end_cu()                                -- after each leaf CU
"""
from __future__ import annotations

import numpy as np


class QpState:
    def __init__(self, sps, pps, qp_map: np.ndarray, avail_fn):
        self.enabled = pps.cu_qp_delta_enabled
        self.slice_qp = 26
        self.ctb_log2 = sps.log2_ctb_size
        self.min_qg_log2 = sps.log2_ctb_size - pps.diff_cu_qp_delta_depth
        self.qp_map = qp_map
        self.avail = avail_fn
        self.last_cu_qp = 26
        self.delta = 0
        self.delta_coded = False
        self.pred = 26

    def start_segment(self, slice_qp: int) -> None:
        self.slice_qp = slice_qp
        self.last_cu_qp = slice_qp
        self.pred = slice_qp
        self.delta = 0
        self.delta_coded = not self.enabled
        self.qg_xy = (0, 0)

    def maybe_start_qg(self, x0: int, y0: int, log2_size: int) -> None:
        if not self.enabled or log2_size < self.min_qg_log2:
            return
        self.delta = 0
        self.delta_coded = False
        self.qg_xy = (x0, y0)
        prev = self.last_cu_qp

        def nb(nx, ny):
            if nx < 0 or ny < 0:
                return prev
            # neighbor must lie in the same CTB and be already coded
            if (nx >> self.ctb_log2 != x0 >> self.ctb_log2
                    or ny >> self.ctb_log2 != y0 >> self.ctb_log2):
                return prev
            if not self.avail(nx, ny):
                return prev
            return int(self.qp_map[ny >> 2, nx >> 2])

        a = nb(x0 - 1, y0)
        b = nb(x0, y0 - 1)
        self.pred = (a + b + 1) >> 1

    def set_delta(self, v: int) -> None:
        self.delta = v
        self.delta_coded = True

    def qp(self) -> int:
        if not self.enabled:
            return self.slice_qp
        return (self.pred + self.delta + 52) % 52

    def end_cu(self) -> None:
        self.last_cu_qp = self.qp()
