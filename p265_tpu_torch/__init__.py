"""p265_tpu_torch: the HEVC decoder's reconstruction path in PyTorch + CUDA.

The counterpart of `p265_tpu`'s device side.  Stage A (bitstream parse,
DPB, motion replay, tensor plans) is shared with `p265_tpu` through its
JAX-free host modules (`hls`, `entropy`, `native`, `syntax`, `golden`,
`plan`, `dpb`, `tables`, `testgen`, `yuv`); Stage B (MC, residuals, the
intra wavefront scan, deblocking, SAO) runs here on torch tensors.  The two
Pallas kernels of the JAX package are hand-written CUDA for Hopper
(`csrc/`), built with nvcc at first use.

Every function takes an explicit `device`; nothing here imports JAX.
"""
