"""Integration points of the port, the counterpart of __graft_entry__.py.

entry(device): one batched intra step of the decoder on the card: the
dequant and inverse transform of a batch of TUs (K1, kernels/itransform.py
batch_residual) followed by the 35-mode prediction, the residual add and
the scatter into the plane (kernels/intra.py predict_batch), on the arrays
of example_batch().

dryrun_multichip(n): the sharded paths of p265_tpu_torch.shard on the
shapes of __graft_entry__.dryrun_multichip, one process a rank over
profile_shard.transport(n) (NCCL with one rank a card where there are n
cards, else gloo ranks sharing card 0; the CPU only where there is no
card), each bit-exact against the port's golden decoder: the stream axis
(n 64x64 intra streams, one a rank), one 64 x 32n P picture row-sharded
(sharded DPB MC, the row-sharded wavefront, halo deblocking and SAO), and
a 256x1080 intra picture whose 1080 rows do not divide into CTU rows or
evenly over the ranks (the pad-and-slice row blocks).
"""
from __future__ import annotations

import numpy as np

CASES = ("multistream", "spatial", "rows1080")


def example_batch(n=8, size=8, H=64, W=64) -> tuple:
    """The arrays of __graft_entry__._example_batch (seed 0): plane, pos,
    ref_ys, ref_xs, ref_ok, mode, levels, qp (the same values; qp at the
    uint8 wire dtype that K1 reads)."""
    rng = np.random.default_rng(0)
    nref = 2 * (2 * size + 1)
    plane = np.zeros((H + 32, W), np.int32)
    pos = np.stack([rng.integers(0, (H - size) // size, n) * size,
                    rng.integers(0, (W - size) // size, n) * size], axis=1
                   ).astype(np.int32)
    ref_ys = rng.integers(0, H, (n, nref)).astype(np.int32)
    ref_xs = rng.integers(0, W, (n, nref)).astype(np.int32)
    ref_ok = rng.random((n, nref)) < 0.5
    mode = rng.integers(0, 35, n).astype(np.int32)
    levels = (rng.random((n, size, size)) < 0.2) * rng.integers(
        -64, 64, (n, size, size))
    qp = rng.integers(20, 45, n).astype(np.uint8)
    return (plane, pos, ref_ys, ref_xs, ref_ok, mode, levels.astype(np.int32),
            qp)


def entry(device: str = "cuda") -> tuple:
    """(forward, args): forward(*args) is the batched intra step, args the
    example batch as tensors on `device`.  On a CUDA device the residuals
    come from K1; on CPU tensors from its plain version."""
    import torch
    from p265_tpu_torch.kernels.intra import predict_batch
    from p265_tpu_torch.kernels.itransform import batch_residual
    size, log2 = 8, 3
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("graft_entry: no CUDA card; pass device='cpu'")

    def forward(plane, pos, ref_ys, ref_xs, ref_ok, mode, levels, qp):
        no = torch.zeros_like(qp, dtype=torch.bool)
        res = batch_residual(levels, qp, no, no, log2)
        filt = mode >= 0  # exercise the filter path
        strong = torch.zeros_like(filt)
        return predict_batch(plane, pos, ref_ys, ref_xs, ref_ok, mode,
                             filt, strong, res, size, 0)

    return forward, tuple(torch.from_numpy(a).to(dev)
                          for a in example_batch(size=size))


def _golden(stream: bytes) -> list:
    """[(plan, prefilter planes, filtered planes)] of every picture."""
    from p265_tpu_torch.golden.decoder import GoldenDecoder
    return [(g.plan, g.prefilter, g.planes)
            for g in GoldenDecoder().decode_stream(stream)]


def make_cases(n: int, cases=CASES) -> dict:
    """The streams of the dry run over n ranks, encoded by the port's test
    encoder and decoded by its golden decoder: {case: inputs}."""
    from p265_tpu_torch.hls.params import PPS, SPS
    from p265_tpu_torch.testgen.encoder import (Encoder, IntraEncoder,
                                                make_moving_sequence,
                                                make_test_image)
    out = {}
    if "multistream" in cases:
        out["multistream"] = [_golden(IntraEncoder(
            SPS(pic_width=64, pic_height=64), PPS(init_qp=34), qp=34,
            seed=seed).encode_frame(make_test_image(64, 64, seed))[0])[0]
            for seed in range(n)]
    if "spatial" in cases:
        w, h = 64, 32 * n           # a CTU-aligned row block a rank
        frames = make_moving_sequence(w, h, 2, seed=5)
        stream, _ = Encoder(SPS(pic_width=w, pic_height=h, log2_ctb_size=5),
                            PPS(init_qp=34, sign_data_hiding=True), qp=34,
                            seed=5).encode_sequence(frames, "LDP")
        out["spatial"] = _golden(stream)
    if "rows1080" in cases:
        w, h = 256, 1080
        stream = IntraEncoder(SPS(pic_width=w, pic_height=h),
                              PPS(init_qp=37, sign_data_hiding=True), qp=37,
                              seed=11).encode_frame(make_test_image(w, h,
                                                                    11))[0]
        out["rows1080"] = _golden(stream)[0]
    return out


def _equal(got, want, what: str) -> None:
    for c, (g, w) in enumerate(zip(got, want)):
        g = g.cpu().numpy() if hasattr(g, "cpu") else np.asarray(g)
        if not np.array_equal(g, np.asarray(w)):
            raise RuntimeError(f"dryrun_multichip: {what} plane {c} differs "
                               "from golden")


def dryrun_rank(rank, world, device, cases: dict) -> dict:
    """Rank function: every case of `cases` (make_cases), checked against
    golden; -> the kernels' launches on this rank."""
    import torch.distributed as dist
    from p265_tpu_torch.kernels import _build
    from p265_tpu_torch.plan.frame_plan import build_tensor_plan
    from p265_tpu_torch.shard.decoder import sharded_multistream_recon
    from p265_tpu_torch.shard.spatial import (decode_picture_spatial,
                                              loop_filters_spatial,
                                              reconstruct_spatial)
    group = dist.group.WORLD
    _build.reset_launch_counts()
    if "multistream" in cases:
        pics = cases["multistream"]
        outs = sharded_multistream_recon(build_tensor_plan(pics[rank][0]),
                                         group, device)
        for s, (got, (_, pre, _)) in enumerate(zip(outs, pics)):
            _equal(got, pre, f"stream axis, stream {s}")
    if "spatial" in cases:
        (ref_plan, _, ref), (plan, pre, filt) = cases["spatial"]
        got_pre, got_filt = decode_picture_spatial(
            plan, {ref_plan.poc: ref}, group, device)
        _equal(got_pre, pre, "space axis P picture prefilter")
        _equal(got_filt, filt, "space axis P picture filtered")
    if "rows1080" in cases:
        plan, pre, filt = cases["rows1080"]
        out = reconstruct_spatial(build_tensor_plan(plan), group, device)
        _equal(out, pre, "256x1080 prefilter")
        _equal(loop_filters_spatial(plan, out, group, device), filt,
               "256x1080 filtered")
    return dict(_build.LAUNCHES)


def dryrun_multichip(n: int, cases=CASES) -> dict:
    """The sharded paths over n ranks (module docstring), bit-exact against
    golden; a difference raises.  -> {"backend", "launches": per rank
    the kernels' launches}."""
    import torch
    from p265_tpu_torch.profile_shard import run_ranks
    if torch.cuda.is_available():
        from p265_tpu_torch.kernels import _build
        _build.library()
    backend, res = run_ranks([(dryrun_rank, (make_cases(n, cases),))], n)
    return dict(backend=backend, launches=[r[0] for r in res])
