"""The port's roofline (p265_tpu_torch.roofline): its census of a stream
against the JAX package's (mc_block_counts and build_tensor_plan on the
same bytes, as profiling/mfu_accounting.py takes them) and against what a
CPU TorchDecoder pass hands to the kernels; the byte and operation rules
on a hand-made picture; the peaks.  Zero tolerance throughout.
"""
import numpy as np
import pytest

from p265_tpu.golden.decoder import GoldenDecoder as JaxGolden
from p265_tpu.kernels.mc import mc_block_counts as jax_mc_block_counts
from p265_tpu.plan.frame_plan import build_tensor_plan as jax_tensor_plan
from p265_tpu_torch import roofline
from p265_tpu_torch.kernels import itransform
from p265_tpu_torch.pipeline import batch_decode as bd
from p265_tpu_torch.pipeline import wavefront as wf
from p265_tpu_torch.pipeline.decoder import TorchDecoder
from p265_tpu_torch.testgen.streams import get_stream

STREAMS = ("s96x64_ldp5", "s96x64_ra5", "s96x64_pcm_ldp5")
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def censuses():
    return {s: roofline.census(get_stream(s)) for s in STREAMS}


def _jax_census(data: bytes) -> list:
    """Per picture: (poc, {(plane, bucket, list): blocks}, tus, scan,
    steps) from the JAX package, in the census' layout."""

    class ParseOnly(JaxGolden):
        def __init__(self):
            super().__init__(use_native_parse=True)
            self.out = []

        def _run_recon(self, task):
            plan = task["plan"]
            tp = jax_tensor_plan(plan, None, device_mc=True, skip_pred=True)
            blocks = {}
            bi = type("Bi", (), {})()
            bi.pus = [p for p in plan.pus
                      if p.motion.uses(0) and p.motion.uses(1)]
            for lx, pl in ((0, plan), (1, bi)):
                cnt = jax_mc_block_counts(pl)
                for plane in roofline.PLANES:
                    grp = "y" if plane == "y" else "c"
                    for k, n in cnt.items():
                        if k[0] == grp:
                            blocks[plane, int(k[1:]), lx] = n
            tus, scan = {}, {}
            for pp in tp.planes:
                for log2, b in pp.batches.items():
                    inter = np.asarray(b.inter, bool)
                    for split, m in (("inter", inter), ("intra", ~inter)):
                        if not m.any():
                            continue
                        t = tus.setdefault(log2, {}).setdefault(
                            split, dict.fromkeys(roofline.TU_CLASSES, 0))
                        for k, v in roofline.tu_counts(
                                np.asarray(b.is_dst)[m],
                                np.asarray(b.tskip)[m],
                                np.asarray(b.bypass)[m]).items():
                            t[k] += v
                    if inter.all():
                        continue
                    s = scan.setdefault(log2, dict(planar=0, angular=0,
                                                   filtered=0, refs=0))
                    mode = np.asarray(b.mode)[~inter]
                    s["planar"] += int((mode == 0).sum())
                    s["angular"] += int((mode >= 2).sum())
                    s["filtered"] += int(np.asarray(b.filter_flag)[~inter]
                                         .sum())
                    s["refs"] += int(np.asarray(b.ok_scan)[~inter].sum())
            self.out.append((plan.poc, blocks, tus, scan,
                             max(pp.n_steps for pp in tp.planes)))
            task["frame"].planes = task["frame"].prefilter = [None] * 3
            task["pic"].planes = [np.zeros((2, 2), np.int32)] * 3

    d = ParseOnly()
    d.decode_stream(data)
    return d.out


@pytest.mark.parametrize("name", ["s96x64_ldp5", "s96x64_ra5"])
def test_census_equals_jax_package(censuses, name):
    want = _jax_census(get_stream(name))
    got = censuses[name]
    assert len(got) == len(want) == 5
    assert any(sum(p["mc"].values()) for p in got)
    for pic, (poc, blocks, tus, scan, steps) in zip(got, want):
        assert pic["poc"] == poc
        assert pic["mc"] == blocks, poc
        assert pic["tus"] == tus, poc
        assert pic["scan"] == scan, poc
        assert pic["steps"] == steps, poc
    if name == "s96x64_ra5":
        assert any(n for p in got for (_, _, lx), n in p["mc"].items()
                   if lx == 1), "no bi-predicted block"


def _captured_pass(name: str, monkeypatch) -> dict:
    """Per picture (one dispatch a picture, serial TorchDecoder on CPU
    tensors) the arguments of every K1, K2 (mc_pred_planes) and scan
    call."""
    calls = []
    orig = (itransform.batch_residual_grouped, bd.mc_pred_planes,
            wf.scan_plane)

    def k1(groups):
        calls.append(("k1", groups))
        return orig[0](groups)

    def k2(stacks, arrays, shapes, has_bi, out=None):
        calls.append(("k2", (stacks, arrays, shapes, has_bi)))
        return orig[1](stacks, arrays, shapes, has_bi, out)

    def scan(stacked, starts, n_steps, plane, after_step=None, **kw):
        calls.append(("scan", n_steps))
        return orig[2](stacked, starts, n_steps, plane, after_step, **kw)

    monkeypatch.setattr(itransform, "batch_residual_grouped", k1)
    monkeypatch.setattr(bd, "mc_pred_planes", k2)
    monkeypatch.setattr(wf, "scan_plane", scan)
    per_pic, cur = [], None
    orig_run = TorchDecoder._run_recon_group

    def run(self, tasks):
        nonlocal cur
        cur = dict(k1=[], k2=[], scan=[])
        calls.clear()
        orig_run(self, tasks)
        for kind, a in calls:
            cur[kind].append(a)
        per_pic.append((tasks[0]["plan"].poc, cur))

    monkeypatch.setattr(TorchDecoder, "_run_recon_group", run)
    TorchDecoder("cpu").decode_stream(get_stream(name))
    return per_pic


def _call_tus(groups_list) -> dict:
    """{log2: {split: {class: TUs}}} of K1 calls; a scan call carries the
    intra TUs (its fields have a mode), a hoisted call the inter ones."""
    out = {}
    for groups in groups_list:
        for log2, f in groups.items():
            split = "intra" if "mode" in f else "inter"
            n = f["coeffs"].shape[0]
            if not n:
                continue
            dst = f.get("is_dst")
            cnt = roofline.tu_counts(
                np.zeros(n, bool) if dst is None else dst.numpy(),
                f["tskip"].numpy(), f["bypass"].numpy())
            t = out.setdefault(log2, {}).setdefault(
                split, dict.fromkeys(roofline.TU_CLASSES, 0))
            for k, v in cnt.items():
                t[k] += v
    return out


def _call_groups(call) -> dict:
    """{(plane, block, list): (refs, pos, ridx, mv, taps)} of the blocks an
    mc_pred_planes call interpolates: all but the pad rows in list 0, the
    ones that read list 1 in list 1."""
    stacks, arrays, shapes, has_bi = call
    out = {}
    for c, plane in enumerate(roofline.PLANES):
        for block, d in arrays["y" if c == 0 else "c"].items():
            real = d["pos"][:, 0] < shapes[c][0]
            for lx in ((0, 1) if has_bi else (0,)):
                m = real & d["has1"] if lx else real
                out[plane, block, lx] = (stacks[c], d["pos"][m],
                                         d[f"r{lx}"][m], d[f"mv{lx}"][m],
                                         8 if c == 0 else 4)
    return out


def _call_windows(calls) -> list:
    """Per plane (y, cb, cr) the distinct reference samples the K2 calls
    read, brute force: every window sample of every block, clamped."""
    stacks, seen = [], {}
    for call in calls:
        for (_, block, _), (refs, pos, ridx, mv, taps) in _call_groups(
                call).items():
            key = refs.data_ptr()
            if key not in seen:
                seen[key] = len(stacks)
                stacks.append((refs, set()))
            R, H, W = refs.shape
            unit, lead = (2, 3) if taps == 8 else (3, 1)
            span = np.arange(block + taps - 1)
            got = stacks[seen[key]][1]
            for (y, x), r, (mx, my) in zip(pos.tolist(), ridx.tolist(),
                                           mv.tolist()):
                ys = np.clip(y + (my >> unit) - lead + span, 0, H - 1)
                xs = np.clip(x + (mx >> unit) - lead + span, 0, W - 1)
                got.update((r, a, b) for a in ys.tolist()
                           for b in xs.tolist())
    return [len(s) for _, s in stacks]


@pytest.mark.parametrize("name", STREAMS)
def test_census_equals_the_kernel_calls(censuses, name, monkeypatch):
    """The TUs and blocks a CPU TorchDecoder pass hands to K1 and K2 equal
    the census: K2 (mc_pred_planes) interpolates list 0 of every block but
    the pad rows and list 1 of the bi-predicted ones, and reads the
    census's reference samples, on bi-predicted pictures too."""
    passes = _captured_pass(name, monkeypatch)
    pics = censuses[name]
    assert [p for p, _ in passes] == [p["poc"] for p in pics]
    for (poc, calls), pic in zip(passes, pics):
        assert _call_tus(calls["k1"]) == pic["tus"], poc
        assert calls["scan"] == [pic["steps"]], poc
        got = {}
        for call in calls["k2"]:
            for key, (_, pos, _, _, _) in _call_groups(call).items():
                got[key] = got.get(key, 0) + pos.shape[0]
        want = {k: n for k, n in pic["mc"].items() if n}
        windows = _call_windows(calls["k2"]) if calls["k2"] else [0, 0, 0]
        assert {k: n for k, n in got.items() if n} == want, poc
        assert windows == pic["ref_samples"], poc


def test_filter_kernels_are_their_stages(censuses):
    """The deblocking and SAO kernels do the whole of their stages: on
    s96x64_ldp5 (both filters on in every picture) their work equals the
    stages', picture by picture and summed, and the kernels are listed
    after the three others."""
    assert roofline.KERNELS == ("itransform", "mc", "scan", "deblock", "sao")
    pics = censuses["s96x64_ldp5"]
    assert all(p["filters"] == dict(deblock=True, sao=[True] * 3)
               for p in pics)
    for pic in pics:
        pw = roofline.picture_work(pic)
        for k in ("deblock", "sao"):
            assert pw["k:" + k] == pw[k] and pw[k].bytes > 0, (pic["poc"], k)
    w = roofline.work(pics)
    for k in ("deblock", "sao"):
        assert w["kernels"][k] == w["stages"][k]
        assert w["kernels"][k].ops == 0


def test_byte_and_operation_rules():
    """One TU of each size in each class and split, one block of each
    bucket and list, counted by hand."""
    tus, scan = {}, {}
    for log2 in (2, 3, 4, 5):
        one = dict(bypass=1, tskip=1, dst=1 if log2 == 2 else 0, dct=1)
        tus[log2] = dict(inter=dict(one, dst=0), intra=dict(one))
        scan[log2] = dict(planar=1, angular=1, filtered=1, refs=10)
    blocks = {(p, b, lx): 1 for lx in (0, 1) for p, bs in
              (("y", (16, 8, 4)), ("cb", (8, 4, 2)), ("cr", (8, 4, 2)))
              for b in bs}
    pic = dict(poc=0, inter=True, shapes=[(64, 96), (32, 48), (32, 48)],
               ctbs=6, steps=3, mc=blocks, ref_samples=[1000, 200, 300],
               pred_samples=[640, 160, 160], tus=tus, scan=scan,
               scaling=False, filters=dict(deblock=True,
                                           sao=[True, False, False]))
    w = roofline.work([pic])
    st, k = w["stages"], w["kernels"]
    # K1: levels and residuals int16, qp and flags a byte each
    res_bytes = sum(n * (4 * 4 ** l2 + 2) for l2, n in
                    ((2, 7), (3, 6), (4, 6), (5, 6)))
    assert res_bytes == 7 * 66 + 6 * 258 + 6 * 1026 + 6 * 4098
    # per size: dequant on the non-bypass TUs (5 at 4x4, else 4), s^3 for
    # the two DCT TUs, 2 s^3 for the DST one
    res_ops = (16 * 5 + 64 * 2 + 128) + (64 * 4 + 512 * 2) \
        + (256 * 4 + 4096 * 2) + (1024 * 4 + 32768 * 2)
    assert st["residual"] == k["itransform"] == roofline.Work(res_bytes,
                                                              res_ops)
    # the MC filter alone (mc_blocks_grouped): per block and list 9 bytes
    # of record and B^2 int16 out; the filter's taps * ((B+taps-1) B + B^2)
    geo = [(16, 8), (8, 8), (4, 8)] + [(8, 4), (4, 4), (2, 4)] * 2
    k2_bytes = 1500 + 2 * sum(9 + 2 * b * b for b, _ in geo)
    k2_ops = 2 * sum(t * ((b + t - 1) * b + b * b) for b, t in geo)
    assert sum((roofline.mc_block_work(b, t, 2) for b, t in geo),
               roofline.Work(1500, 0, fp32=True)) == roofline.Work(
        k2_bytes, k2_ops, fp32=True)
    # the MC stage, which K2 computes whole: references, records and
    # samples; the filter plus the combine's add a list-1 sample
    assert k["mc"] == st["mc"] == roofline.Work(
        1500 + 2 * 9 * len(geo) + 960,
        k2_ops + sum(b * b for b, _ in geo), fp32=True)
    # scan: per intra TU residual 2 s^2, output s^2, 6 bytes of record,
    # plus its available references; planar 4 and angular 2 a sample,
    # smoothing 2 a reference of 4s+2
    n_intra = {2: 4, 3: 3, 4: 3, 5: 3}
    scan_bytes = sum(n * (3 * 4 ** l2 + 6) + 10 for l2, n in n_intra.items())
    scan_ops = sum(6 * 4 ** l2 + 2 * (4 * 2 ** l2 + 2) for l2 in n_intra)
    assert st["scan"] == k["scan"] == roofline.Work(scan_bytes, scan_ops,
                                                    fp32=True)
    planes = 64 * 96 + 2 * 32 * 48
    assert st["deblock"] == roofline.Work(2 * planes + 64 * 96 // 16, 0)
    assert st["sao"] == roofline.Work(2 * 64 * 96 + 6 * 6, 0)
    assert st["fetch"] == roofline.Work(planes, 0, link=True)
    # scaling lists: six matrices a size, two at 32x32, once a picture
    pic["scaling"] = True
    assert roofline.work([pic])["stages"]["residual"].bytes == res_bytes + \
        6 * 16 + 6 * 64 + 6 * 256 + 2 * 1024
    # two pictures: twice the work
    assert roofline.work([pic, pic])["kernels"]["mc"] == roofline.Work(
        2 * (1500 + 2 * 9 * len(geo) + 960),
        2 * (k2_ops + sum(b * b for b, _ in geo)), fp32=True)


def test_bound_and_peaks():
    w = roofline.Work(3_350_000_000_000, 1)
    assert roofline.bound(w, H100) == (1000.0, "bytes")
    ops = roofline.Work(1, 132 * 64 * 1_980_000_000)
    ms, by = roofline.bound(ops, H100)
    assert by == "operations" and ms == 1000.0
    # operations exact in float32 run at twice the int32 rate
    fp32 = roofline.Work(1, 132 * 128 * 1_980_000_000, fp32=True)
    assert roofline.bound(fp32, H100) == (1000.0, "operations")
    with pytest.raises(ValueError, match="two types"):
        ops + fp32
    assert ops + roofline.Work(5, 0, fp32=True) == roofline.Work(6, ops.ops)
    assert roofline.bound_ms(roofline.Work(64_000_000, 0, link=True),
                             H100) == 1.0
    for card in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "cpu", ""):
        with pytest.raises(ValueError, match="no peaks"):
            roofline.bound(w, card)


def test_window_samples_clamp():
    # a rectangle wholly left of the plane reads its first column
    assert roofline.window_samples([(0, -20, 4, -10)], (8, 8)) == 4
    # overlapping rectangles count once
    assert roofline.window_samples([(0, 0, 4, 4), (2, 2, 6, 6)],
                                   (8, 8)) == 16 + 16 - 4
    assert roofline.window_samples([(-5, -5, 50, 50)], (8, 8)) == 64


def test_table_command(capsys):
    assert roofline.main(["s96x64_ldp5", "--card", H100]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("s96x64_ldp5: one pass, 5 pictures (4 inter)")
    assert [ln.split()[0] for ln in out[2:11]] == [
        *roofline.STAGES, "K:itransform", "K:mc", "K:scan"]
    with pytest.raises(ValueError, match="no peaks"):
        roofline.main(["s96x64_ldp5", "--card", "some card"])
