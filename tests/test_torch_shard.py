"""The port's sharded paths (p265_tpu_torch.shard) on CPU tensors over gloo,
bit-exact against golden and against the JAX package's shard functions.

Every case of tests/test_spatial.py, tests/test_sharding.py and
tests/test_distributed.py has a counterpart here, at the same picture sizes
and rank counts (2, 4 and 8), plus mc_spatial on a P picture with PCM CUs
and the parameter-set fix of split_irap_segments.  One set of worker
processes per rank count (one process a rank, gloo over a free localhost
port) runs every case of that count, in a module-scoped fixture; each
worker set has its own timeout.  While they run, the parent computes the
same functions of p265_tpu.shard on a JAX CPU mesh of the same size (the
conftest provides 8 devices).  Every rank's result must equal golden and
the JAX result, np.array_equal.
"""
import multiprocessing
import os
import pickle
import socket
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from p265_tpu.golden.decoder import GoldenDecoder as JaxGolden
from p265_tpu.hls.params import PPS, SPS
from p265_tpu.testgen.encoder import (Encoder, IntraEncoder,
                                      make_moving_sequence, make_test_image)
from p265_tpu_torch.golden.decoder import GoldenDecoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300

_WORKER = r"""
import pickle, sys, traceback
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from p265_tpu_torch.plan.frame_plan import build_tensor_plan
from p265_tpu_torch.shard import distributed as D
from p265_tpu_torch.shard import spatial as S
from p265_tpu_torch.shard.decoder import sharded_multistream_recon
from p265_tpu_torch.shard.filters import sao_sharded
from p265_tpu_torch.shard.mesh import make_mesh, sharded_stencil_step

inp, addr, rank, n, out = sys.argv[1:6]
rank, n = int(rank), int(n)
with open(inp, "rb") as f:
    cases = pickle.load(f)
D.initialize(addr, n, rank)
W, cpu = dist.group.WORLD, "cpu"


def np_(x):
    if isinstance(x, (list, tuple)):
        return [np_(v) for v in x]
    return x.numpy() if isinstance(x, torch.Tensor) else x


def run(kind, a):
    if kind == "recon":
        return S.reconstruct_spatial(build_tensor_plan(a["plan"]), W, cpu)
    if kind == "filters":
        return S.loop_filters_spatial(a["plan"], a["planes"], W, cpu)
    if kind == "deblock":
        return S.deblock_spatial(a["plan"], a["planes"], W, cpu)
    if kind == "decode":
        return S.decode_picture_spatial(a["plan"], a["refs"], W, cpu)
    if kind == "mc":
        return S.mc_spatial(a["plan"], a["refs"], W, cpu)
    if kind == "sao":
        return sao_sharded(a["plan"], a["planes"], W, cpu)
    if kind == "multistream":
        return sharded_multistream_recon(
            build_tensor_plan(a["plans"][rank]), W, cpu)
    if kind == "stencil":
        return sharded_stencil_step(make_mesh(), a["planes"], cpu)
    if kind == "dp_decode":
        k = len(a["streams"]) // n
        mine = a["streams"][k * rank:k * (rank + 1)]
        return D.decode_streams_distributed(mine, D.global_mesh(), cpu)
    if kind == "production":
        work, layout = D.schedule_segments(a["streams"], n, rank)
        outs = D.decode_segments_production([w[2] for w in work], cpu)
        return dict(layout=layout, work=[(si, gi) for si, gi, _ in work],
                    frames=[[(f.poc, bool(f.plan.pus), np_(f.planes),
                              np_(f.prefilter)) for f in fr] for fr in outs])
    raise ValueError(kind)


res = {}
try:
    for name, kind, a in cases:
        got = run(kind, a)
        res[name] = got if kind == "production" else np_(got)
except Exception:
    traceback.print_exc()
    sys.exit(1)
finally:
    dist.destroy_process_group()
with open(out, "wb") as f:
    pickle.dump(res, f)
print(f"rank {rank}/{n}: {len(res)} cases OK", flush=True)
"""


def _free_addr() -> str:
    s = socket.socket()
    s.bind(("localhost", 0))
    addr = f"localhost:{s.getsockname()[1]}"
    s.close()
    return addr


def _start(n: int, cases: list, tmp) -> dict:
    """Start one worker process a rank for `cases` over n ranks."""
    d = tmp / f"ranks{n}"
    d.mkdir()
    (d / "worker.py").write_text(_WORKER)
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    addr = _free_addr()
    procs = [subprocess.Popen(
        [sys.executable, str(d / "worker.py"), str(d / "cases.pkl"), addr,
         str(r), str(n), str(d / f"out{r}.pkl")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(n)]
    return dict(n=n, dir=d, procs=procs, t0=time.monotonic())


def _finish(run: dict) -> list:
    """Wait for a worker set (its own timeout) -> per rank its results."""
    outs = []
    for p in run["procs"]:
        left = TIMEOUT_S - (time.monotonic() - run["t0"])
        try:
            outs.append(p.communicate(timeout=max(left, 1))[0].decode())
        except subprocess.TimeoutExpired:
            for q in run["procs"]:
                q.kill()
            pytest.fail(f"{run['n']} ranks: timed out after {TIMEOUT_S} s")
    res = []
    for r, (p, out) in enumerate(zip(run["procs"], outs)):
        assert p.returncode == 0, f"rank {r}/{run['n']} failed:\n{out[-4000:]}"
        with open(run["dir"] / f"out{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


# --- inputs: the generators of tests/test_spatial.py, test_sharding.py and
# test_distributed.py ------------------------------------------------------


def _intra(w=64, h=128, ctb_log2=5, qp=32, seed=11):
    sps = SPS(pic_width=w, pic_height=h, log2_ctb_size=ctb_log2)
    pps = PPS(init_qp=qp, sign_data_hiding=True)
    img = make_test_image(w, h, seed)
    return IntraEncoder(sps, pps, qp=qp, seed=seed).encode_frame(img)[0]


def _ldp(w=64, h=128, n=3, ctb_log2=5, qp=32, seed=7, **sps_kw):
    sps = SPS(pic_width=w, pic_height=h, log2_ctb_size=ctb_log2, **sps_kw)
    pps = PPS(init_qp=qp, sign_data_hiding=True)
    frames = make_moving_sequence(w, h, n, seed=seed)
    return Encoder(sps, pps, qp=qp, seed=seed).encode_sequence(
        frames, "LDP")[0]


# name -> (generator, arguments); the JAX test each one comes from in the
# comments.  The default CTB is 64x64 (log2 6).
STREAMS = {
    # test_spatial.py
    "intra": (_intra, {}),
    "i256": (_intra, dict(h=256)),
    "filters": (_intra, dict(qp=37)),
    "deblock": (_intra, dict(qp=40, seed=3)),
    "i1080": (_intra, dict(h=1080, qp=37)),
    "i104": (_intra, dict(h=104, qp=34)),
    "ldp": (_ldp, {}),
    "ldp13": (_ldp, dict(seed=13)),
    "ldp104": (_ldp, dict(h=104)),
    # the committed PCM stream's GOP, cut to its first P picture
    "pcm": (_ldp, dict(w=96, h=64, n=2, ctb_log2=6, seed=43,
                       pcm_enabled=True, pcm_loop_filter_disabled=True)),
    # test_sharding.py
    **{f"ms{s}": (_intra, dict(w=96, h=64, ctb_log2=6, seed=s + 20))
       for s in range(4)},
    "sao": (_intra, dict(w=128, h=128, ctb_log2=6, seed=20)),
    # test_distributed.py
    **{f"dp{s}": (_intra, dict(w=64, h=64, ctb_log2=6, qp=33, seed=s))
       for s in range(4)},
    **{f"prod{s}": (_ldp, dict(w=192, h=128, n=4, ctb_log2=6, seed=s))
       for s in (7, 8, 9)},
}
# the streams whose JAX shard functions the parent runs too
_JAX_STREAMS = ("intra", "i1080", "i104", "deblock", "ldp104", "ldp13",
                "pcm", "ms0", "ms1", "ms2", "ms3", "sao")


def _refs(frames, i):
    return {frames[i - 1].poc: frames[i - 1].planes}


def _mesh1d(n, name="space"):
    return Mesh(np.array(jax.devices()[:n]).reshape(n), (name,))


def _jax_refs(jg: dict, stencil) -> dict:
    """The JAX package's shard functions on the same inputs, on a JAX CPU
    mesh of the same size: each function once at each rank count it has
    (a case that repeats a function at a rank count on another picture is
    held against golden alone, as its JAX test is), plus the unsharded
    functions the JAX tests compare with.  Four threads: XLA compiles
    without the interpreter lock."""
    from p265_tpu.kernels.loopfilter import deblock_tpu, sao_tpu
    import p265_tpu.kernels.mc as jmc
    from p265_tpu.plan.frame_plan import build_tensor_plan
    from p265_tpu.shard import spatial as JS
    from p265_tpu.shard.decoder import sharded_multistream_recon
    from p265_tpu.shard.filters import sao_sharded
    from p265_tpu.shard.mesh import make_mesh, sharded_stencil_step

    def recon(key, n):
        return lambda: JS.reconstruct_spatial(
            build_tensor_plan(jg[key][0].plan), _mesh1d(n))

    def host(planes):
        return [np.asarray(p) for p in planes]

    i1080, d, s = jg["i1080"][0], jg["deblock"][0], jg["sao"][0]
    fr = jg["ldp104"]
    tasks = dict(
        recon_2=recon("intra", 2), recon_1080=recon("i1080", 4),
        recon_odd_8=recon("i104", 8),
        stencil=lambda: np.asarray(sharded_stencil_step(make_mesh(8),
                                                        stencil)),
        filters_1080=lambda: JS.loop_filters_spatial(
            i1080.plan, i1080.prefilter, _mesh1d(4)),
        deblock=lambda: JS.deblock_spatial(d.plan, d.prefilter, _mesh1d(4)),
        deblock_tpu=lambda: host(deblock_tpu(
            d.plan, [np.asarray(p, np.int32) for p in d.prefilter])),
        ldp104_1=lambda: JS.decode_picture_spatial(
            fr[1].plan, _refs(fr, 1), _mesh1d(4)),
        multistream=lambda: sharded_multistream_recon(
            [build_tensor_plan(jg[f"ms{k}"][0].plan) for k in range(4)],
            _mesh1d(4, "stream")),
        sao=lambda: sao_sharded(s.plan, s.prefilter, _mesh1d(4)),
        sao_tpu=lambda: host(sao_tpu(s.plan, host(s.prefilter))))
    for name, key in (("mc", "ldp13"), ("mc_pcm", "pcm")):
        f = jg[key]
        tasks[name] = (lambda f=f: JS.mc_spatial(f[1].plan, _refs(f, 1),
                                                 _mesh1d(4)))
        tasks[name + "_device"] = (lambda f=f: jmc.build_inter_pred_device(
            f[1].plan, _refs(f, 1)))
    # the JAX MC stamps PCM into read-only views of its device planes,
    # which fails on a picture with PUs: give its stamp writable copies
    orig_stamp = jmc.stamp_pcm

    def stamp(plan, out):
        out[:] = [np.array(p) for p in out]
        orig_stamp(plan, out)
    jmc.stamp_pcm = stamp
    try:
        with ThreadPoolExecutor(4) as ex:
            futs = {k: ex.submit(fn) for k, fn in tasks.items()}
            return {k: f.result() for k, f in futs.items()}
    finally:
        jmc.stamp_pcm = orig_stamp


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    """Runs every case: {"port": {n: [per rank {case: result}]},
    "jax": {case: JAX result}, "gold": {stream: golden frames},
    "streams": {stream: bytes}}."""
    tmp = tmp_path_factory.mktemp("shard")
    # the test encoder is the slow part of the set-up: four processes
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(4, mp_context=ctx) as ex:
        futs = {k: ex.submit(fn, **kw) for k, (fn, kw) in sorted(
            STREAMS.items(), key=lambda kv: not kv[0].startswith("prod"))}
        streams = {k: f.result() for k, f in futs.items()}
    gold = {k: GoldenDecoder().decode_stream(v) for k, v in streams.items()}
    g = {k: v[0] for k, v in gold.items()}
    stencil = (np.arange(4 * 64 * 64, dtype=np.int32).reshape(4, 64, 64)
               & 255)

    def recon(k):
        return "recon", dict(plan=g[k].plan)

    def filt(kind, k):
        return kind, dict(plan=g[k].plan, planes=g[k].prefilter)

    def picture(kind, k, i):
        return kind, dict(plan=gold[k][i].plan, refs=_refs(gold[k], i))

    jobs = {
        8: dict(recon_8=recon("i256"), recon_odd_8=recon("i104"),
                stencil=("stencil", dict(planes=stencil))),
        4: dict(recon_4=recon("intra"), recon_1080=recon("i1080"),
                filters=filt("filters", "filters"),
                filters_1080=filt("filters", "i1080"),
                deblock=filt("deblock", "deblock"), sao=filt("sao", "sao"),
                mc=picture("mc", "ldp13", 1), mc_pcm=picture("mc", "pcm", 1),
                multistream=("multistream", dict(
                    plans=[g[f"ms{s}"].plan for s in range(4)])),
                **{f"{k}_{i}": picture("decode", k, i)
                   for k in ("ldp", "ldp104") for i in (1, 2)}),
        2: dict(recon_2=recon("intra"),
                dp_decode=("dp_decode", dict(
                    streams=[streams[f"dp{s}"] for s in range(4)])),
                production=("production", dict(streams=[
                    streams["prod7"] + streams["prod8"], streams["prod9"]]))),
    }
    runs = {n: _start(n, [(name, kind, a) for name, (kind, a) in cs.items()],
                      tmp) for n, cs in jobs.items()}
    # meanwhile, the JAX package's shard functions on a CPU mesh
    jg = {k: JaxGolden().decode_stream(streams[k]) for k in _JAX_STREAMS}
    jx = _jax_refs(jg, stencil)
    port = {n: _finish(r) for n, r in runs.items()}
    return dict(port=port, jax=jx, gold=gold, streams=streams,
                stencil=stencil)


def _each_rank(shard, n, name):
    outs = [r[name] for r in shard["port"][n]]
    assert len(outs) == n
    return outs


def _equal(got, want, what):
    assert len(got) == len(want), what
    for c, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(np.asarray(g), np.asarray(w)), (what, c)


def _check(shard, n, name, want):
    """Every rank's result equals `want` (golden or unsharded) and, where
    the parent ran it, the JAX shard function's."""
    for out in _each_rank(shard, n, name):
        _equal(out, want, (name, "reference"))
        if name in shard["jax"]:
            _equal(out, shard["jax"][name], (name, "jax"))


# --- tests/test_spatial.py -------------------------------------------------


@pytest.mark.parametrize("n_dev", [2, 4])
def test_recon_spatial_intra_bit_exact(shard, n_dev):
    _check(shard, n_dev, f"recon_{n_dev}", shard["gold"]["intra"][0].prefilter)


def test_recon_spatial_8dev(shard):
    _check(shard, 8, "recon_8", shard["gold"]["i256"][0].prefilter)


def test_filters_spatial_bit_exact(shard):
    _check(shard, 4, "filters", shard["gold"]["filters"][0].planes)


def test_deblock_spatial_bit_exact(shard):
    _check(shard, 4, "deblock", shard["jax"]["deblock_tpu"])


@pytest.mark.parametrize("key", ["ldp", "ldp104"])
def test_inter_spatial_full_picture(shard, key):
    """P pictures (inter PUs + intra CUs): sharded-DPB MC + row-sharded
    recon + halo filters == golden; ldp104 is 104 = 3*32 + 8 rows high
    (tests/test_spatial.py test_inter_spatial_odd_height), so row blocks
    pad and MC reads edge-extended reference rows."""
    frames = shard["gold"][key]
    assert any(f.plan.pus for f in frames[1:])
    for i in (1, 2):
        name = f"{key}_{i}"
        for pre, filt in _each_rank(shard, 4, name):
            _equal(pre, frames[i].prefilter, (name, "golden pre"))
            _equal(filt, frames[i].planes, (name, "golden filt"))
            if name in shard["jax"]:
                jpre, jfilt = shard["jax"][name]
                _equal(pre, jpre, (name, "jax pre"))
                _equal(filt, jfilt, (name, "jax filt"))


@pytest.mark.parametrize("name", ["mc", "mc_pcm"])
def test_mc_spatial_matches_device_mc(shard, name):
    """mc_pcm: a P picture with inter PUs and PCM CUs, whose PCM samples
    are stamped over the sharded MC."""
    from p265_tpu_torch.golden.recon import build_inter_pred
    frames = shard["gold"]["ldp13" if name == "mc" else "pcm"]
    plan = frames[1].plan
    assert plan.pus and (name == "mc" or any(t.pcm for t in plan.tus))
    _check(shard, 4, name, shard["jax"][name + "_device"])
    _equal(shard["jax"][name + "_device"],
           build_inter_pred(plan, _refs(frames, 1)), "golden host MC")


def test_recon_spatial_1080_rows(shard):
    _check(shard, 4, "recon_1080", shard["gold"]["i1080"][0].prefilter)


def test_filters_spatial_1080_rows(shard):
    _check(shard, 4, "filters_1080", shard["gold"]["i1080"][0].planes)


def test_recon_spatial_odd_height_8dev(shard):
    _check(shard, 8, "recon_odd_8", shard["gold"]["i104"][0].prefilter)


# --- tests/test_sharding.py ------------------------------------------------


def test_multistream_dp_bit_exact(shard):
    for outs in _each_rank(shard, 4, "multistream"):
        assert len(outs) == 4
        for s in range(4):
            _equal(outs[s], shard["gold"][f"ms{s}"][0].prefilter, s)
            _equal(outs[s], shard["jax"]["multistream"][s], (s, "jax"))


def test_sao_halo_sharded_bit_exact(shard):
    _check(shard, 4, "sao", shard["jax"]["sao_tpu"])


def test_stencil_step_runs(shard):
    for out in _each_rank(shard, 8, "stencil"):
        assert out.shape == shard["stencil"].shape
        assert np.array_equal(out, shard["jax"]["stencil"])


# --- tests/test_distributed.py ---------------------------------------------


def test_two_process_dp_decode(shard):
    for rank, outs in enumerate(_each_rank(shard, 2, "dp_decode")):
        assert len(outs) == 2
        for li, out in enumerate(outs):
            _equal(out, shard["gold"][f"dp{2 * rank + li}"][0].prefilter,
                   (rank, li))


def test_two_process_production_segments(shard):
    """>= 4-frame inter streams through the production PipelinedTorchDecoder
    on 2 processes, IRAP-delimited scheduling, bit-exact vs golden."""
    from p265_tpu_torch.shard.distributed import split_irap_segments
    st = shard["streams"]
    segs = [split_irap_segments(s) for s in (st["prod7"] + st["prod8"],
                                             st["prod9"])]
    assert [len(x) for x in segs] == [2, 1]
    owned = []
    for rank, out in enumerate(_each_rank(shard, 2, "production")):
        assert out["layout"] == [2, 1]
        for (si, gi), frames in zip(out["work"], out["frames"]):
            owned.append((si, gi))
            assert len(frames) == 4, (si, gi)
            assert any(has_pus for _, has_pus, _, _ in frames)
            gold = shard["gold"][{(0, 0): "prod7", (0, 1): "prod8",
                                  (1, 0): "prod9"}[si, gi]]
            for (poc, _, planes, pre), g in zip(frames, gold):
                assert poc == g.poc
                _equal(planes, g.planes, (rank, si, gi, poc))
                _equal(pre, g.prefilter, (rank, si, gi, poc, "pre"))
    assert sorted(owned) == [(0, 0), (0, 1), (1, 0)]


def test_split_keeps_mid_segment_parameter_sets():
    """The one place the port differs from the reference on purpose: a
    parameter set between two pictures of a segment stays in that segment
    (and joins the parameter sets of later segments), where
    p265_tpu.shard.distributed.split_irap_segments strips it.  Each
    segment decodes alone to the golden decode of the whole stream."""
    from p265_tpu.shard.distributed import split_irap_segments as jax_split
    from p265_tpu_torch.hls import nal
    from p265_tpu_torch.shard.distributed import split_irap_segments
    sps = SPS(pic_width=64, pic_height=64)
    pps = PPS(init_qp=32, sign_data_hiding=True)

    def gop(seed):
        frames = make_moving_sequence(64, 64, 3, seed=seed)
        return Encoder(sps, pps, qp=32, seed=seed).encode_sequence(
            frames, "LDP")[0]
    a = gop(3)
    units = _units(a)
    pps_nal = next(u for u in units if _type(u) == nal.NAL_PPS)
    slices = [i for i, u in enumerate(units) if nal.is_slice_nal(_type(u))]
    # the PPS again, between the second and the third picture
    stream = (b"".join(units[:slices[2]] + [pps_nal] + units[slices[2]:])
              + gop(4))
    segs = split_irap_segments(stream)
    assert len(segs) == 2
    assert _units(segs[0]) == _units(a)[:slices[2]] + [pps_nal] + _units(
        a)[slices[2]:]
    assert pps_nal in _units(segs[1])
    # the reference drops the PPS from its segment
    assert _units(jax_split(stream)[0]) == _units(a)
    gold = GoldenDecoder().decode_stream(stream)
    got = [f for s in segs for f in GoldenDecoder().decode_stream(s)]
    assert [f.poc for f in got] == [f.poc for f in gold]
    for f, g in zip(got, gold):
        _equal(f.planes, g.planes, f.poc)


def _units(data: bytes) -> list:
    """The NAL units of an Annex-B stream, each with its start code."""
    arr = np.frombuffer(data, np.uint8)
    sc = np.flatnonzero((arr[:-2] == 0) & (arr[1:-1] == 0) & (arr[2:] == 1))
    starts = [int(s) - (1 if s > 0 and arr[s - 1] == 0 else 0) for s in sc]
    return [data[s:e] for s, e in zip(starts, starts[1:] + [len(data)])]


def _type(unit: bytes) -> int:
    off = unit.index(b"\x00\x00\x01") + 3
    return (unit[off] >> 1) & 63


def test_rank_functions_of_the_card_run():
    """profile_shard.run_ranks with the rank functions of chip_smoke.py's
    sharded phase, rehearsed on CPU tensors over gloo: the space axis on
    the committed PCM stream and the stream axis on the three committed
    small streams, every picture checked inside the ranks."""
    import tempfile
    from p265_tpu_torch.profile_shard import (planes_of, run_ranks,
                                              space_axis, stream_axis)
    data = {}
    for fn in ("s96x64_ldp5", "s96x64_ra5", "s96x64_pcm_ldp5"):
        with open(os.path.join(ROOT, "p265_tpu_torch", "data",
                               fn + ".265"), "rb") as f:
            data[fn] = f.read()
    pcm = data["s96x64_pcm_ldp5"]
    with tempfile.TemporaryDirectory() as d:
        ref = os.path.join(d, "ref.npz")
        np.savez(ref, **planes_of(GoldenDecoder().decode_stream(pcm)))
        backend, res = run_ranks(
            [(space_axis, (pcm, ref, 1)),
             (stream_axis, (list(data.values()), [None, None, ref]))], 2,
            timeout=TIMEOUT_S)
    assert backend == "gloo" and len(res) == 2
    for space, stream in res:
        pics = space[0]["pictures"]
        assert [p["poc"] for p in pics] == [0, 1, 2, 3, 4]
        assert all(p["collectives"] > 0 for p in pics)
    assert sorted(s[0] for _, stream in res
                  for s in stream["segments"]) == [0, 1, 2]
