"""p265_tpu_torch: the HEVC decoder's reconstruction path in PyTorch + CUDA.

The counterpart of `p265_tpu`.  Stage A (bitstream parse, DPB, motion
replay, tensor plans) is this package's own copy of the JAX package's host
modules (`hls`, `entropy`, `native`, `syntax`, `golden`, `plan`, `dpb`,
`tables`, `yuv`), held against the originals by the tests; Stage B (MC,
residuals, the intra wavefront scan, deblocking, SAO) runs here on torch
tensors, on one device or over several ranks of torch.distributed
(`shard`: a picture's CTU rows, or independent streams, one a rank).
The two Pallas kernels of the JAX package are hand-written CUDA for
Hopper (`csrc/`), built with nvcc at first use.

Every function takes an explicit `device`; nothing here imports JAX or the
JAX package `p265_tpu`.
"""
