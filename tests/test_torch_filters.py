"""The port's loop-filter device functions against the JAX package's, on
random cases (p265_tpu_torch/testgen/filter_cases.py), bit-exact.

deblock_planes, deblock_luma_vertical, deblock_chroma_vertical and
sao_apply take their plain versions on CPU tensors; each is held against
p265_tpu.kernels.loopfilter's _deblock_luma_vertical,
_deblock_chroma_vertical and _sao_apply, vmapped over the batch as
p265_tpu/pipeline/batch_decode.py:449-476 runs them (deblock_planes: both
directions, the horizontal one on swapped axes), with np.array_equal, on
contiguous planes, on transposed views (the layout of the single-direction
horizontal pass) and on rows of a taller plane (the batch path's).  The
model of the deblocking kernel's tiles (filter_cases.tiled_deblock) is held
against deblock_planes_ref.  The row-sharded SAO (shard/filters.py
sao_rows) is held against the JAX SAO of the whole plane, block by block.
The kernels of csrc/loopfilter.cu are held against these plain versions on
the card (tests/test_torch_gpu.py).  No tolerance: the result is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import p265_tpu.kernels.loopfilter as jlf
from p265_tpu_torch.kernels import loopfilter as lf
from p265_tpu_torch.shard.filters import sao_rows
from p265_tpu_torch.testgen import filter_cases as fc

# the JAX device functions take the wire grids (int16 edge parameters,
# int8 SAO maps) widened to int32, as p265_tpu/pipeline/batch_decode.py
# widens them before it calls them
def _i32(*arrays):
    return [np.asarray(a, np.int32) for a in arrays]


def _deblock_luma(planes, *params):
    return jax.vmap(jlf._deblock_luma_vertical.__wrapped__)(
        planes, *_i32(*params))


def _deblock_chroma(planes, tc):
    return jax.vmap(jlf._deblock_chroma_vertical.__wrapped__)(
        planes, *_i32(tc))


def _sao_jax(src, ty, cls, offs, ctb):
    return jax.vmap(jlf._sao_apply.__wrapped__, in_axes=(0, 0, 0, 0, None))(
        src, *_i32(ty, cls, offs), ctb)


def _deblock_planes_jax(luma, chroma, fp):
    """The JAX package's deblocking of a batch
    (p265_tpu/pipeline/batch_decode.py:449-466)."""
    for key in ("v", "h"):
        if key == "h":
            luma, chroma = jnp.swapaxes(luma, 1, 2), jnp.swapaxes(chroma, 1, 2)
        if fp[f"bs_{key}"].shape[2]:
            luma = _deblock_luma(luma, *(fp[f"{n}_{key}"]
                                         for n in ("bs", "beta", "tc")))
        if fp[f"tcc_{key}"].shape[2]:
            chroma = _deblock_chroma(chroma, fp[f"tcc_{key}"])
        if key == "h":
            luma, chroma = jnp.swapaxes(luma, 1, 2), jnp.swapaxes(chroma, 1, 2)
    return np.asarray(luma), np.asarray(chroma)


def _planes_case(seed: int, shape) -> tuple:
    """(numpy case, its parameters as CPU tensors)."""
    c = fc.deblock_planes_case(np.random.default_rng(20 + seed), *shape)
    return c, {k: torch.from_numpy(v) for k, v in c.items()
               if k not in ("luma", "chroma")}


# luma shapes [F,H,W] of the deblock_planes cases: chroma 36 rows (H % 8 ==
# 4, as 540 is), no vertical chroma edge; no vertical edge at all; no
# horizontal edge at all
PLANES_SHAPES = [(2, 72, 136), (1, 72, 16), (1, 40, 8), (1, 8, 40)]


def _torch(a: np.ndarray, transposed: bool) -> torch.Tensor:
    """a [B,H,W] as a tensor, contiguous or a transposed view of
    contiguous [B,W,H] storage."""
    if not transposed:
        return torch.from_numpy(a)
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1))
                            ).transpose(1, 2)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deblock_luma_matches_jax(seed, transposed):
    c = fc.deblock_case(np.random.default_rng(seed), *fc.SHAPES["luma"])
    planes = _torch(c["planes"], transposed)
    assert planes.is_contiguous() != transposed
    args = [torch.from_numpy(c[k]) for k in ("bs", "beta", "tc")]
    got = lf.deblock_luma_vertical(planes, *args)
    want = np.asarray(_deblock_luma(c["planes"], c["bs"], c["beta"],
                                    c["tc"]))
    assert not np.array_equal(want, c["planes"])
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(planes, _torch(c["planes"], transposed))


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deblock_chroma_matches_jax(seed, transposed):
    c = fc.deblock_case(np.random.default_rng(10 + seed),
                        *fc.SHAPES["chroma"], chroma=True)
    planes = _torch(c["planes"], transposed)
    got = lf.deblock_chroma_vertical(planes, torch.from_numpy(c["tc"]))
    want = np.asarray(_deblock_chroma(c["planes"], c["tc"]))
    assert not np.array_equal(want, c["planes"])
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("layout", ["contiguous", "rows of a taller plane"])
@pytest.mark.parametrize("shape", PLANES_SHAPES)
def test_deblock_planes_ref_matches_jax(shape, layout):
    """deblock_planes on CPU tensors (its plain version, deblock_planes_ref)
    equals the JAX vertical-then-horizontal composition; the inputs are not
    modified."""
    c, fp = _planes_case(0, shape)
    luma, chroma = (fc.layouts(c[k], "cpu")[layout]
                    for k in ("luma", "chroma"))
    got = lf.deblock_planes(luma, chroma, fp)
    want = _deblock_planes_jax(c["luma"], c["chroma"], c)
    for g, w, k in zip(got, want, ("luma", "chroma")):
        assert not np.array_equal(w, c[k]), k
        assert np.array_equal(g.numpy(), w), k
    assert np.array_equal(luma.numpy(), c["luma"])
    assert np.array_equal(chroma.numpy(), c["chroma"])


@pytest.mark.parametrize("tile", [(32, 32), (16, 24)])
@pytest.mark.parametrize("shape", PLANES_SHAPES)
def test_tiled_deblock_model_matches_plain(shape, tile):
    """The kernel's tiling, modelled in plain torch: every tile (the last
    ones partial) deblocked on its crop with a 4-sample halo equals
    deblock_planes_ref on the whole planes."""
    c, fp = _planes_case(1, shape)
    luma, chroma = torch.from_numpy(c["luma"]), torch.from_numpy(c["chroma"])
    got = fc.tiled_deblock(luma, chroma, fp, tile)
    want = lf.deblock_planes_ref(luma, chroma, fp)
    assert not torch.equal(want[0], luma)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("plane", ["luma", "chroma"])
@pytest.mark.parametrize("ctb", [64, 32, 16])
def test_sao_matches_jax(ctb, plane, transposed):
    """CTB 64/32/16 on luma, ctb >> 1 on chroma; the heights are no
    multiple of the CTB."""
    B, H, W = fc.SHAPES[plane]
    size = ctb if plane == "luma" else ctb >> 1
    assert H % size
    c = fc.sao_case(np.random.default_rng(ctb + (plane == "chroma")),
                    B, H, W, size)
    maps = [torch.from_numpy(c[k]) for k in ("ty", "cls", "offs")]
    got = lf.sao_apply(_torch(c["src"], transposed), *maps, size)
    want = np.asarray(_sao_jax(c["src"], c["ty"], c["cls"], c["offs"], size))
    assert not np.array_equal(want, c["src"])
    assert np.array_equal(got.numpy(), want)


def test_sao_cases_cover_every_class():
    """The SAO cases hold every type, every edge class and the band
    positions that wrap."""
    c = fc.sao_case(np.random.default_rng(0), 8, 72, 136, 16)
    ty, cls = c["ty"], c["cls"]
    assert {0, lf.SAO_BAND, lf.SAO_EDGE} <= set(ty.ravel().tolist())
    assert set(cls[ty == lf.SAO_EDGE].tolist()) == {0, 1, 2, 3}
    assert set(cls[ty == lf.SAO_BAND].tolist()) >= {28, 29, 30, 31}
    assert c["offs"].min() == -7 and c["offs"].max() == 7


@pytest.mark.parametrize("ctb", [64, 16])
def test_sao_rows_match_jax(ctb):
    """Four row blocks of 24 rows (the last one past the picture's 72
    rows) with one halo row from each neighbour (zeros at the picture's
    edges), filtered through sao_rows: each equal to its rows of the JAX
    SAO of the whole plane."""
    c = fc.sao_case(np.random.default_rng(5), 1, 72, 136, ctb)
    want = np.asarray(_sao_jax(c["src"], c["ty"], c["cls"], c["offs"],
                               ctb))[0]
    maps = [torch.from_numpy(c[k][0]) for k in ("ty", "cls", "offs")]
    blocks = fc.row_blocks(torch.from_numpy(c["src"][0]), 4, 24)
    assert [b[0] for b in blocks] == [0, 24, 48, 72]
    for r0, local, top, bot in blocks:
        got = sao_rows(local, top, bot, *maps, ctb, r0, 72).numpy()
        n = max(0, min(24, 72 - r0))
        assert np.array_equal(got[:n], want[r0:r0 + n]), r0


def test_wrappers_refuse_other_devices():
    c = fc.deblock_case(np.random.default_rng(3), *fc.SHAPES["chroma"],
                        chroma=True)
    meta = torch.empty(c["planes"].shape, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        lf.deblock_chroma_vertical(meta, torch.from_numpy(c["tc"]))
    with pytest.raises(ValueError, match="no kernel for meta"):
        lf.deblock_luma_vertical(meta, *(torch.from_numpy(c["tc"]),) * 3)
    with pytest.raises(ValueError, match="no kernel for meta"):
        lf.deblock_planes(meta, meta, {})
    with pytest.raises(ValueError, match="no kernel for meta"):
        lf.sao_apply(meta, *(torch.zeros(1, 1, 1, dtype=torch.int32),) * 3,
                     64)
    with pytest.raises(ValueError, match="CUDA"):
        lf.sao_kernel(torch.from_numpy(c["planes"]), *(
            torch.zeros(4, 1, 1, dtype=torch.int32),) * 3, 64)


def test_main_path_calls_each_filter_function_per_dispatch(monkeypatch):
    """A CPU TorchDecoder pass on s96x64_ldp5 (both filters on in every
    slice) calls deblock_planes once a dispatch (luma and chroma, both
    directions; on CPU tensors it reaches deblock_planes_ref) and sao_apply
    twice (luma, then cb and cr together), through the module's
    attributes: on the card, one deblocking and two SAO launches a
    dispatch."""
    from p265_tpu_torch.pipeline.decoder import TorchDecoder
    from p265_tpu_torch.testgen.streams import get_stream
    calls = []
    for name in ("deblock_planes", "deblock_planes_ref", "sao_apply"):
        def spy(*a, _name=name, _f=getattr(lf, name)):
            calls.append((_name, tuple(a[0].shape), tuple(a[1].shape)))
            return _f(*a)
        monkeypatch.setattr(lf, name, spy)
    frames = TorchDecoder("cpu").decode_stream(get_stream("s96x64_ldp5"))
    assert len(frames) == 5
    one = [("deblock_planes", (1, 64, 96), (2, 32, 48)),
           ("deblock_planes_ref", (1, 64, 96), (2, 32, 48)),
           ("sao_apply", (1, 64, 96), (1, 1, 2)),
           ("sao_apply", (2, 32, 48), (2, 1, 2))]
    assert calls == one * 5
