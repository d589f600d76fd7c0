"""The port's upload contract (kernels/staging.py) against the reference's.

`stage` on random trees (every wire dtype, empty, 0-d and non-contiguous
leaves) against torch.from_numpy of each leaf; `stage` against the
reference's own `_pack` + `_unpack` (p265_tpu/pipeline/batch_decode.py, in
JAX on the CPU) over the array list `_build_batch` makes for a 96x64 LDP P
picture; the device-side widening of uint16 coordinates against the int64
indices of the wide path on planes wider than 32768; decodes through
TorchDecoder and PipelinedTorchDecoder bit-exact against golden with one
staging copy a dispatch and no staged leaf written in place; and
`profile_pack` at 96x64 on the CPU.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import p265_tpu.pipeline.batch_decode as jbd
from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu_torch import profile_pack
from p265_tpu_torch.kernels import staging
from p265_tpu_torch.pipeline import batch_decode as bd
from p265_tpu_torch.pipeline import wavefront as wf
from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
from p265_tpu_torch.pipeline.decoder import TorchDecoder
from p265_tpu_torch.run_config import Dispatches
from p265_tpu_torch.testgen.scan_cases import coord_plane
from p265_tpu_torch.testgen.streams import get_stream
from test_torch_batch_decode import p_picture  # noqa: F401  (fixture)

_DTYPES = (np.bool_, np.uint8, np.int16, np.uint16, np.int32, np.int64,
           np.float32)


def _leaf(rng):
    """A random array: any wire dtype, sometimes empty, 0-d or a
    non-contiguous view."""
    dt = np.dtype(_DTYPES[rng.integers(len(_DTYPES))])
    kind = rng.integers(5)
    shape = (() if kind == 0 else (0, 3) if kind == 1
             else tuple(rng.integers(1, 9, rng.integers(1, 4))))
    if dt == np.bool_:
        a = rng.random(shape) < 0.5
    elif dt.kind == "f":
        a = rng.standard_normal(shape).astype(dt)
    else:
        info = np.iinfo(dt)
        a = rng.integers(info.min, info.max, shape, dtype=dt,
                         endpoint=True)
    if kind == 4 and a.ndim >= 1:       # non-contiguous: a strided view
        a = (np.stack([a, a]) if a.ndim == 1 else a)[..., ::2]
        a = a.T if a.ndim >= 2 else a
    return np.asarray(a)


def _tree(rng, depth=0):
    if depth == 3 or rng.random() < 0.35:
        return _leaf(rng)
    kind = rng.integers(4)
    n = int(rng.integers(1, 5))
    if kind == 0:
        return {f"k{i}": _tree(rng, depth + 1) for i in range(n)}
    if kind == 1:
        return [_tree(rng, depth + 1) for _ in range(n)]
    if kind == 2:
        return tuple(_tree(rng, depth + 1) for _ in range(n))
    return None


def _same_tree(got, src):
    """got mirrors src; every leaf torch.equal to torch.from_numpy of the
    source at its dtype and shape."""
    if src is None:
        assert got is None
    elif isinstance(src, dict):
        assert isinstance(got, dict) and list(got) == list(src)
        for k in src:
            _same_tree(got[k], src[k])
    elif isinstance(src, (list, tuple)):
        assert type(got) is type(src) and len(got) == len(src)
        for g, s in zip(got, src):
            _same_tree(g, s)
    else:
        want = torch.from_numpy(src.copy())
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_stage_random_trees(seed):
    rng = np.random.default_rng(seed)
    tree = {"a": [_leaf(rng) for _ in range(12)], "b": _tree(rng),
            "c": (None, _tree(rng)), "d": _leaf(rng)}
    stats = {}
    got = staging.stage(tree, "cpu", stats)
    _same_tree(got, tree)
    arrays = staging.leaves(tree)
    offs, nbytes = staging.layout(arrays)
    assert stats["h2d_copies"] == 1 and stats["h2d_bytes"] == nbytes
    assert all(o % 16 == 0 for o in offs)
    base = None
    for t in staging.leaves(got):
        if t.numel():            # every leaf a view of one buffer
            ptr = t.untyped_storage().data_ptr()
            assert base is None or ptr == base
            base = ptr
            assert (t.storage_offset() * t.element_size()) % 16 == 0
    assert base is not None


def test_stage_ring_reuse_and_growth():
    """Two slots, trees of growing size in turn: every earlier result
    stays intact (the CPU copy lands in a fresh tensor; the slot is
    refilled), and an empty tree makes no copy."""
    rng = np.random.default_rng(7)
    ring = staging.StagingRing("cpu", slots=2)
    trees = [{"x": rng.integers(0, 1 << 15, n).astype(np.uint16),
              "y": rng.random(n) < 0.5}
             for n in (10, 1000, 600_000, 10, 2_000_000)]
    outs = [ring.stage(t) for t in trees]
    for got, src in zip(outs, trees):
        _same_tree(got, src)
    stats = {}
    assert ring.stage({"e": np.zeros((0, 4), np.int16), "n": None},
                      stats)["e"].shape == (0, 4)
    assert stats["h2d_copies"] == 0
    with pytest.raises(ValueError):
        staging.StagingRing("cpu", slots=1)


def test_stage_matches_reference_pack(p_picture, monkeypatch):  # noqa: F811
    """The array list of the reference's _build_batch for a P picture
    (scan buckets, hoisted inter TUs, filter grids, MC blocks), through
    the reference's _pack and _unpack in JAX and through stage: equal
    values and dtypes, field by field."""
    d = p_picture
    seen = []

    def spy(arrays):
        seen.append(list(arrays))
        return pack(arrays)

    pack = jbd._pack
    monkeypatch.setattr(jbd, "_pack", spy)
    jbd._build_batch([d["tplan"]], [d["g"].plan], policy=None,
                     mc=[d["mc_jax"]])
    arrays = seen[0]
    assert len({a.dtype for a in arrays}) >= 5
    bufs, specs = pack(arrays)
    want = jbd._unpack(tuple(jnp.asarray(b) for b in bufs), specs)
    got = staging.stage(arrays, "cpu")
    assert len(got) == len(want) == len(arrays)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.dtype == staging.torch_dtype(w.dtype), i
        assert tuple(g.shape) == w.shape, i
        assert np.array_equal(g.numpy(), w), i


@pytest.mark.parametrize("cols", (40_000, 70_000))
def test_widen_matches_wide_indices(cols):
    """A plane wider than 32768 (uint16 coordinates to 65000, int32 past
    it): the scan's reference indices and positions, and the hoisted
    inter TUs' positions, widened on the device from the staged fields
    equal the int64 ones of the wide path."""
    rng = np.random.default_rng(cols)
    pp = coord_plane(rng, (64, cols))
    merged = wf.merge_segments([pp])
    want = {log2: (b.ref_ys.astype(np.int64)[~b.inter] * cols
                   + b.ref_xs.astype(np.int64)[~b.inter],
                   b.pos.astype(np.int64)[~b.inter],
                   b.pos.astype(np.int64)[b.inter])
            for log2, b in merged.batches.items()}
    itu = wf.hoist_inter(merged)
    fields, starts = wf.scan_fields(wf.stack_plane(merged))
    wire = np.uint16 if cols < 65000 else np.int32
    assert all(f["pos"].dtype == wire and f["ref_xs"].dtype == wire
               for f in fields.values())
    assert all(f["pos"].dtype == wire for f in itu.values())
    assert max(int(f["ref_xs"].max()) for f in fields.values()) > 32767
    dev = staging.stage(dict(itu=itu, tu=fields), "cpu")
    stacked = wf.expand(dev["tu"])
    for log2, (idx, pos, ipos) in want.items():
        # the scan reads the staged coordinates as they are; the plain
        # version's flat indices are the wide path's
        assert stacked[log2]["ref_ys"].dtype == staging.torch_dtype(wire)
        got = wf.ref_index(stacked[log2], cols)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), idx)
        assert np.array_equal(
            staging.widen(stacked[log2]["pos"], torch.int64).numpy(), pos)
        assert np.array_equal(
            staging.widen(dev["itu"][log2]["pos"], torch.int64).numpy(),
            ipos)
    u16 = torch.from_numpy(np.array([0, 1, 32767, 32768, 65535], np.uint16))
    for dt in (torch.int32, torch.int64):
        w = staging.widen(u16, dt)
        assert w.dtype == dt and w.tolist() == [0, 1, 32767, 32768, 65535]


@pytest.mark.parametrize("name", ("s96x64_ldp5", "s96x64_ra5"))
@pytest.mark.parametrize("cls", (TorchDecoder, PipelinedTorchDecoder))
def test_decode_one_copy_a_dispatch(name, cls, monkeypatch):
    """Bit-exact vs golden; stats["h2d_copies"] is the dispatch count;
    every staged leaf is still equal to its source after the decode (no
    consumer wrote into a leaf in place)."""
    data = get_stream(name)
    staged = []

    def spy(tree, device, stats=None):
        out = stage(tree, device, stats)
        staged.append((out, staging.per_leaf(tree, device)))
        return out

    stage = bd.stage
    monkeypatch.setattr(bd, "stage", spy)
    with Dispatches() as dispatches:
        dec = cls("cpu")
        frames = dec.decode_stream(data)
    gold = GoldenDecoder().decode_stream(data)
    assert len(frames) == len(gold)
    for f, g in zip(frames, gold):
        for c in range(3):
            assert np.array_equal(f.planes[c], g.planes[c]), (f.poc, c)
    assert len(dispatches) == len(staged) > 1
    assert dec.stats["h2d_copies"] == len(dispatches)
    assert dec.stats["h2d_bytes"] > 0
    for got, want in staged:
        for g, w in zip(staging.leaves(got), staging.leaves(want),
                        strict=True):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_profile_pack_cpu(capsys):
    """profile_pack at 96x64 on the CPU: one JSON record, every phase of
    every picture timed, the P pictures' MC pack and rest split, both
    decoders' passes."""
    profile_pack.main(["s96x64_ldp5", "--device", "cpu", "--reps", "1",
                       "--turns", "1"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["stream"] == "s96x64_ldp5" and rec["device"] == "cpu"
    pics = rec["pictures"]
    assert [p["kind"] for p in pics] == ["I", "P", "P", "P", "P"]
    for p in pics:
        assert all(v >= 0 for v in p["phases"].values())
        assert p["h2d_bytes"] > 0 and p["finalize_s"] > 0
        assert ("mc_arrays_padded" in p["phases"]) == (p["kind"] == "P")
        assert ("ref_stacks" in p["rest"]) == (p["kind"] == "P")
    assert len(rec["passes"]["serial"]) == len(rec["passes"]["pipelined"])
    assert all(s > 0 for s in rec["passes"]["serial"])
