"""The port's own copy of the host side against the JAX package's, on the CPU.

p265_tpu_torch carries verbatim copies of the JAX-free host modules of
p265_tpu (parse, DPB, golden decoder, tensor plans, tables, the test
encoder), so that it
imports nothing of p265_tpu.  Each copy must equal its original after the
import rewrite `p265_tpu` -> `p265_tpu_torch`, apart from the deviations
listed here and in a comment at the top of the copy (two code changes, the
first of which sends attach_pred_planes to the port's device MC, and three
reworded comments); the two golden
decoders must decode the same planes and the two tensor plans must be
equal, field by field; the committed test streams must be the ones the JAX
package's encoder makes for their seeds, and the port's copy of the encoder
must write the same bytes.
"""
import dataclasses
import hashlib
import os
import re

import numpy as np
import pytest

import p265_tpu.tables as jtables
import p265_tpu_torch.tables as ttables
from p265_tpu.golden.decoder import GoldenDecoder as JaxGolden
from p265_tpu.hls.params import PPS, SPS
from p265_tpu.plan.frame_plan import build_tensor_plan as jax_tensor_plan
from p265_tpu.testgen.encoder import (Encoder, IntraEncoder,
                                      make_moving_sequence, make_test_image)
from p265_tpu_torch.golden.decoder import GoldenDecoder as PortGolden
from p265_tpu_torch.hls import nal as PortNal
from p265_tpu_torch.hls import params as port_params
from p265_tpu_torch.plan.frame_plan import (
    build_tensor_plan as port_tensor_plan)
from p265_tpu_torch.testgen import encoder as port_encoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "p265_tpu_torch", "data")

COPIED = ("tables.py", "yuv.py",
          "hls/__init__.py", "hls/bitio.py", "hls/nal.py", "hls/params.py",
          "hls/slice_header.py", "entropy/__init__.py", "entropy/engine.py",
          "native/__init__.py", "native/parse.py", "native/cabac.c",
          "native/ctu.c", "syntax/__init__.py", "syntax/ctu.py",
          "syntax/qp.py", "syntax/residual.py", "syntax/tiles.py",
          "golden/__init__.py", "golden/decoder.py", "golden/recon.py",
          "golden/intra.py", "golden/inter.py", "golden/transform.py",
          "golden/mv.py", "golden/deblock.py", "golden/sao.py",
          "dpb/__init__.py", "dpb/dpb.py", "plan/__init__.py",
          "plan/frame_plan.py", "golden/trace.py", "testgen/__init__.py",
          "testgen/encoder.py")

_HOST_MC = ("from p265_tpu_torch.golden.recon import build_inter_pred\n",
            "pred = build_inter_pred(plan, refs or {})\n")

# (old, new) text replacements that turn the rewritten original into the
# copy; every other line is verbatim
DEVIATIONS = {
    "plan/frame_plan.py": [
        ("                      device_mc: bool = False,\n", ""),
        ("                if device_mc:\n"
         "                    from p265_tpu_torch.kernels.mc import "
         "build_inter_pred_device\n"
         "                    pred = build_inter_pred_device(plan, refs or {})"
         "\n"
         "                else:\n"
         "                    " + _HOST_MC[0] + "                    "
         + _HOST_MC[1],
         "                " + _HOST_MC[0] + "                " + _HOST_MC[1]),
        ("        if device_mc:\n"
         "            from p265_tpu_torch.kernels.mc import "
         "build_inter_pred_device\n"
         "            inter_pred = build_inter_pred_device(plan, refs or {})\n"
         "        else:\n"
         "            " + _HOST_MC[0]
         + "            inter_pred = build_inter_pred(plan, refs or {})\n",
         "        " + _HOST_MC[0]
         + "        inter_pred = build_inter_pred(plan, refs or {})\n"),
        ("def attach_pred_planes(tplan: TensorPlan, refs: dict,\n"
         "                       device_mc: bool = True) -> None:",
         "def attach_pred_planes(tplan: TensorPlan, refs: dict, device) "
         "-> None:"),
        # the device MC only, on an explicit device
        ("    if device_mc:\n"
         "        from p265_tpu_torch.kernels.mc import "
         "build_inter_pred_device\n"
         "        pred = build_inter_pred_device(plan, refs or {})\n"
         "    else:\n"
         "        " + _HOST_MC[0] + "        " + _HOST_MC[1],
         "    from p265_tpu_torch.kernels.mc import build_inter_pred_device\n"
         "    pred = build_inter_pred_device(plan, refs or {}, device)\n"),
    ],
    "native/__init__.py": [
        ('_SO = os.path.join(_DIR, "_cabac.so")',
         '_SO = os.path.join(os.path.dirname(_DIR), "build", "_cabac.so")'),
        ("            subprocess.run(\n"
         '                ["cc", "-O3", "-fPIC", "-shared", "-o", _SO, src],\n'
         "                check=True, capture_output=True)\n",
         "            os.makedirs(os.path.dirname(_SO), exist_ok=True)\n"
         '            tmp = f"{_SO}.{os.getpid()}.tmp"\n'
         "            subprocess.run(\n"
         '                ["cc", "-O3", "-fPIC", "-shared", "-o", tmp, src],\n'
         "                check=True, capture_output=True)\n"
         "            os.replace(tmp, _SO)\n"),
    ],
}

# (first, last, n): lines first..last of the original (1-based) are
# replaced by n lines of the copy: comments reworded, no code
LINE_DEVIATIONS = {
    "tables.py": (3, 12, 7),
    "native/cabac.c": (7, 7, 1),
    "native/ctu.c": (256, 256, 1),
}

_IMPORT = re.compile(r"^(\s*)(from|import) p265_tpu(?=[.\s])", re.M)


def _read(*parts) -> str:
    with open(os.path.join(*parts)) as f:
        return f.read()


@pytest.mark.parametrize("rel", COPIED)
def test_copy_is_verbatim_but_for_listed_deviations(rel):
    want = _read(ROOT, "p265_tpu", rel)
    if rel.endswith(".py"):
        want = _IMPORT.sub(r"\1\2 p265_tpu_torch", want)
    for old, new in DEVIATIONS.get(rel, ()):
        assert want.count(old) == 1, (rel, old)
        want = want.replace(old, new)
    got = _read(ROOT, "p265_tpu_torch", rel)
    lines = got.splitlines(keepends=True)
    mark = "//" if rel.endswith(".c") else "#"
    n_head = next(i for i, ln in enumerate(lines + [""])
                  if not ln.startswith(mark))
    head, body = lines[:n_head], lines[n_head:]
    if rel in DEVIATIONS or rel in LINE_DEVIATIONS:
        assert "Deviation" in "".join(head), rel
    else:
        assert not head, rel
    want = want.splitlines(keepends=True)
    if rel in LINE_DEVIATIONS:
        first, last, n = LINE_DEVIATIONS[rel]
        assert body[:first - 1] == want[:first - 1]
        assert body[first - 1 + n:] == want[last:]
        assert body[first - 1:first - 1 + n] != want[first - 1:last]
    else:
        assert body == want
    assert not re.search(r"^\s*(from|import) p265_tpu(\.|\s|$)", got, re.M)


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)) and not np.isscalar(a):
        return (len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


def test_tables_constants_equal():
    names = [n for n, v in vars(jtables).items()
             if not n.startswith("_") and not callable(v)
             and not isinstance(v, type(np))]
    assert len(names) >= 20, names
    for n in names:
        assert _same(getattr(jtables, n), getattr(ttables, n)), n


def _gop(structure, n, seed, w=96, h=64, qp=30, sps_kw=None, **pps_kw):
    sps = SPS(pic_width=w, pic_height=h, temporal_mvp_enabled=True,
              num_reorder_pics=2, max_dec_pic_buffering=5, **(sps_kw or {}))
    pps = PPS(init_qp=qp, sign_data_hiding=True, **pps_kw)
    return Encoder(sps, pps, qp=qp, seed=seed).encode_sequence(
        make_moving_sequence(w, h, n, seed=seed), structure=structure)[0]


def _intra(w, h, seed, sps_kw=None, pps_kw=None, qp=30):
    sps = SPS(pic_width=w, pic_height=h, **(sps_kw or {}))
    pps = PPS(init_qp=qp, **(pps_kw or {}))
    return IntraEncoder(sps, pps, qp=qp, seed=seed).encode_frame(
        make_test_image(w, h, seed))[0]


# the parameters of tests/test_e2e_*.py, test_wpp_tiles.py,
# test_pcm_bypass_wp.py and test_scaling_lists.py
STREAMS = {
    "LDP": lambda: _gop("LDP", 3, 2),
    "LDP2": lambda: _gop("LDP2", 4, 3),
    "RA_bi": lambda: _gop("RA", 5, 4),
    "WP_RA": lambda: _gop("RA", 5, 14, qp=32, weighted_pred=True,
                          weighted_bipred=True),
    "tiles_wpp_intra": lambda: _intra(
        256, 128, 8, qp=31, pps_kw=dict(
            sign_data_hiding=True, tiles_enabled=True, num_tile_columns=2,
            num_tile_rows=1, entropy_coding_sync_enabled=True)),
    "tiles_P": lambda: _gop("LDP", 3, 13, w=192, h=128, qp=33,
                            tiles_enabled=True, num_tile_columns=2,
                            num_tile_rows=2, loop_filter_across_tiles=False),
    "scaling_tskip": lambda: _intra(96, 64, 5,
                                    sps_kw=dict(scaling_list_enabled=True),
                                    pps_kw=dict(transform_skip_enabled=True)),
    "pcm": lambda: _intra(96, 64, 4, sps_kw=dict(
        pcm_enabled=True, pcm_loop_filter_disabled=True)),
    "bypass": lambda: _intra(96, 64, 3,
                             pps_kw=dict(transquant_bypass_enabled=True)),
    "I_104x56": lambda: _intra(104, 56, 6),
}


def _tplan_equal(a, b, what):
    assert len(a.planes) == len(b.planes) == 3, what
    for pa, pb in zip(a.planes, b.planes):
        assert (pa.plane_idx, tuple(pa.shape), pa.n_steps) == (
            pb.plane_idx, tuple(pb.shape), pb.n_steps), what
        assert _same(pa.inter_pred, pb.inter_pred) or (
            pa.inter_pred is None and pb.inter_pred is None), what
        assert sorted(pa.batches) == sorted(pb.batches), what
        for log2, ba in pa.batches.items():
            bb = pb.batches[log2]
            for fld in dataclasses.fields(ba):
                x, y = getattr(ba, fld.name), getattr(bb, fld.name)
                if x is None or y is None:
                    assert x is None and y is None, (what, log2, fld.name)
                else:
                    assert np.array_equal(x, y), (what, log2, fld.name)
                    assert np.asarray(x).dtype == np.asarray(y).dtype


def _pus(plan) -> list:
    return [(p.x, p.y, p.w, p.h, list(p.motion.mv), list(p.motion.ref_idx),
             list(p.motion.ref_poc), list(p.motion.lt)) for p in plan.pus]


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_goldens_agree(name):
    """Both golden decoders give the same planes before and after the
    loop filters, and their frame plans equal tensor plans."""
    data = STREAMS[name]()
    want = JaxGolden().decode_stream(data)
    got = PortGolden().decode_stream(data)
    assert [f.poc for f in got] == [f.poc for f in want]
    if name == "RA_bi":
        assert any(p.motion.uses(0) and p.motion.uses(1)
                   for f in got for p in f.plan.pus)
    for g, w in zip(got, want):
        for c in range(3):
            assert np.array_equal(g.planes[c], w.planes[c]), (g.poc, c)
            assert np.array_equal(g.prefilter[c], w.prefilter[c]), (g.poc, c)
        assert _pus(g.plan) == _pus(w.plan), g.poc
        skip = bool(w.plan.pus)   # inter pictures: no refs here
        _tplan_equal(port_tensor_plan(g.plan, skip_pred=skip),
                     jax_tensor_plan(w.plan, skip_pred=skip), (name, g.poc))


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_native_parse_plans_agree(name):
    """The native C parse of both packages (the port's main path) gives
    equal motion and equal tensor plans (its buckets come from ctu.c, not
    from plan.tus).  The golden scalar recon needs plan.tus, so the planes
    of a native-parse golden decode are not compared."""
    data = STREAMS[name]()
    want = JaxGolden(use_native_parse=True).decode_stream(data)
    got = PortGolden(use_native_parse=True).decode_stream(data)
    assert [f.poc for f in got] == [f.poc for f in want]
    # PCM slices fall back to the Python parse
    native = [getattr(f.plan, "nstate", None) is not None for f in got]
    assert all(native) != (name == "pcm"), native
    for g, w in zip(got, want):
        assert _pus(g.plan) == _pus(w.plan), g.poc
        skip = bool(w.plan.pus)
        _tplan_equal(port_tensor_plan(g.plan, skip_pred=skip),
                     jax_tensor_plan(w.plan, skip_pred=skip), (name, g.poc))


def _sums() -> dict:
    out = {}
    for line in _read(DATA, "SHA256SUMS").splitlines():
        digest, fn = line.split()
        out[fn] = digest
    return out


_PCM = dict(pcm_enabled=True, pcm_loop_filter_disabled=True)


@pytest.mark.parametrize("fn,structure,seed,sps_kw", [
    ("s96x64_ldp5.265", "LDP", 41, None), ("s96x64_ra5.265", "RA", 50, None),
    ("s96x64_pcm_ldp5.265", "LDP", 43, _PCM)])
def test_committed_small_streams_match_the_encoder(fn, structure, seed,
                                                   sps_kw):
    with open(os.path.join(DATA, fn), "rb") as f:
        data = f.read()
    assert hashlib.sha256(data).hexdigest() == _sums()[fn]
    assert data == _gop(structure, 5, seed, qp=32, sps_kw=sps_kw)


def test_port_encoder_writes_the_same_bytes():
    """A 64x64 LDP stream of 3 frames from each package's encoder."""
    def encode(enc_mod, params_mod):
        sps = params_mod.SPS(pic_width=64, pic_height=64,
                             temporal_mvp_enabled=True)
        pps = params_mod.PPS(init_qp=32, sign_data_hiding=True)
        return enc_mod.Encoder(sps, pps, qp=32, seed=6).encode_sequence(
            enc_mod.make_moving_sequence(64, 64, 3, seed=6),
            structure="LDP")
    import p265_tpu.hls.params as jax_params
    import p265_tpu.testgen.encoder as jax_encoder
    want, want_rec = encode(jax_encoder, jax_params)
    got, got_rec = encode(port_encoder, port_params)
    assert got == want and len(got) > 100
    assert _same(got_rec, want_rec)


@pytest.mark.parametrize("fn", ["s1080_ldp4.265", "s1080_ra8.265"])
def test_committed_1080p_streams_match_their_sha256(fn):
    """The 1080p streams take the pure-Python encoder many minutes, so they
    are held to their checksums only (tools/make_streams.py names their
    generators: _gop(1920, 1080, n, structure), seed 5, QP 32)."""
    with open(os.path.join(DATA, fn), "rb") as f:
        data = f.read()
    assert hashlib.sha256(data).hexdigest() == _sums()[fn]
    units = PortNal.split_nal_units(data)
    sps = next(port_params.parse_sps(u.rbsp) for u in units
               if u.nal_type == PortNal.NAL_SPS)
    assert (sps.pic_width, sps.pic_height) == (1920, 1080)
    assert sum(1 for u in units if PortNal.is_slice_nal(u.nal_type)) == int(
        fn.split(".")[0][-1])
