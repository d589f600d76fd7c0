"""The stream axis: independent streams decoded side by side, one a rank.

Counterpart of p265_tpu/shard/decoder.py.  The JAX package padded S
streams' frame plans to common shapes, stacked them on a leading 'stream'
axis and ran one shard_map, so that every device ran the one compiled
program.  Eager torch needs no common shapes: each rank reconstructs its
own stream's tensor plan, at its own shapes, through the port's batch path
(build_batch + decode_batch_planes: K2 for the MC, K1 for the residuals),
and the prefilter planes are gathered.  Bit-exact vs the unsharded path.
"""
from __future__ import annotations

import torch

from p265_tpu_torch.kernels.mc import mc_arrays, ref_stacks
from p265_tpu_torch.pipeline.batch_decode import (build_batch,
                                                  decode_batch_planes)
from p265_tpu_torch.shard.mesh import gather_planes


def sharded_multistream_recon(tplan, group, device, refs: dict | None = None
                              ) -> list:
    """Every rank of `group` passes its own stream's picture (TensorPlan);
    returns, on every rank, the [y, cb, cr] prefilter planes of each
    rank's picture in rank order (uint8 tensors on `device`).

    refs {poc: [y, cb, cr]}: the reference planes of an inter picture,
    whose MC then runs on the device (K2)."""
    device = torch.device(device)
    plan = tplan.frame_plan
    mc = stacks = None
    if plan.pus:
        if refs is None:
            raise ValueError("sharded_multistream_recon: an inter picture "
                             "needs its reference planes")
        poc_list = sorted(refs)
        mc = [mc_arrays(plan, poc_list)]
        stacks = [ref_stacks(refs, poc_list, device)]
    pl, pc, _, _ = decode_batch_planes(build_batch([tplan], [plan], mc=mc),
                                       stacks, device)
    return gather_planes([pl[0], pc[0], pc[1]], group)
