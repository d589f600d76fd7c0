"""Frame-DAG batching of the port on CPU tensors: mutually independent
inter pictures (hierarchical-B siblings) share one batch_decode pass.

The cases of tests/test_frame_dag.py for TorchDecoder and
PipelinedTorchDecoder on a 192x128 random-access stream of 8 frames: the
port's plan_frame_groups gives the groups of the JAX package's on the same
task list; frame_dag_max=4 is bit-exact against golden and against
TpuDecoder(frame_dag_max=4); frame_dag_max=1 gives the same planes and no
dag_batched; with the loop filters off the siblings still batch and
equal the unfiltered golden decode; the pipelined decoder forms the same
groups on every run.
And build_batch / decode_batch_planes at F = 2 with per-frame MC against
the JAX decode_batch_planes on the same inputs.  Tolerance zero.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import p265_tpu.kernels.mc as jmc
import p265_tpu.pipeline.batch_decode as jbd
from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu.pipeline.decoder import TpuDecoder
from p265_tpu.pipeline.decoder import plan_frame_groups as jax_groups
from p265_tpu.pipeline.wavefront import ShapePolicy
from p265_tpu.plan.frame_plan import build_tensor_plan as jax_tensor_plan
from p265_tpu_torch.hls.params import PPS, SPS
from p265_tpu_torch.kernels import mc
from p265_tpu_torch.pipeline import batch_decode as bd
from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
from p265_tpu_torch.pipeline.decoder import TorchDecoder, plan_frame_groups
from p265_tpu_torch.testgen.encoder import Encoder, make_moving_sequence

DECODERS = [TorchDecoder, PipelinedTorchDecoder]


@functools.lru_cache(maxsize=None)
def _ra_stream(n=8, seed=11, w=192, h=128):
    sps = SPS(pic_width=w, pic_height=h, temporal_mvp_enabled=True)
    pps = PPS(init_qp=32, sign_data_hiding=True)
    frames = make_moving_sequence(w, h, n, seed=seed)
    return Encoder(sps, pps, qp=32, seed=seed).encode_sequence(frames,
                                                               "RA")[0]


@functools.lru_cache(maxsize=None)
def _golden(seed=11):
    return GoldenDecoder().decode_stream(_ra_stream(seed=seed))


def _pocs(groups) -> list:
    return [[t["frame"].poc for t in g] for g in groups]


def _spy(cls, **kw):
    """A decoder of class `cls` that records its tasks in decode order and
    the groups it reconstructs."""
    class Spy(cls):
        def __init__(self):
            super().__init__("cpu", **kw)
            self.tasks, self.groups = [], []

        def _schedule_recon(self, task):
            self.tasks.append(task)
            super()._schedule_recon(task)

        def _emit_group(self, group):
            self.groups.append([t["frame"].poc for t in group])
            super()._emit_group(group)
    return Spy()


def test_group_planner_matches_reference():
    """Same groups as the reference's planner on the same task list;
    groups keep decode order and no member references another; the groups
    the decoder formed while parsing are the planner's."""
    dec = _spy(TorchDecoder, frame_dag_max=4)
    dec.decode_stream(_ra_stream())
    got = plan_frame_groups(dec.tasks, 4)
    assert _pocs(got) == _pocs(jax_groups(dec.tasks, 4))
    assert _pocs(got) == dec.groups
    assert [t["frame"].poc for g in got for t in g] == [
        t["frame"].poc for t in dec.tasks]
    assert any(len(g) >= 2 for g in got), "no sibling group formed"
    for g in got:
        pocs = {t["frame"].poc for t in g}
        for t in g:
            assert not (pocs - {t["frame"].poc}) & set(t["refs"])
    assert _pocs(plan_frame_groups(dec.tasks, 1)) == [
        [t["frame"].poc] for t in dec.tasks]
    assert max(len(g) for g in plan_frame_groups(dec.tasks, 2)) == 2


@pytest.mark.parametrize("cls", DECODERS)
def test_ra_batched_bit_exact(cls):
    gold = _golden()
    d = cls("cpu", frame_dag_max=4)
    out = d.decode_stream(_ra_stream())
    assert d.stats.get("dag_batched", 0) >= 2
    assert [f.poc for f in out] == [g.poc for g in gold]
    for f, g in zip(out, gold):
        for c in range(3):
            assert np.array_equal(f.planes[c], g.planes[c]), (f.poc, c)
            assert np.array_equal(f.prefilter[c].numpy(),
                                  g.prefilter[c]), (f.poc, c)


def test_ra_batched_equals_tpu_decoder():
    jd = TpuDecoder(frame_dag_max=4)
    want = jd.decode_stream(_ra_stream())
    td = PipelinedTorchDecoder("cpu", frame_dag_max=4)
    got = td.decode_stream(_ra_stream())
    assert td.stats["dag_batched"] == jd.stats["dag_batched"] >= 2
    assert [f.poc for f in got] == [f.poc for f in want]
    for f, w in zip(got, want):
        for c in range(3):
            assert np.array_equal(f.planes[c], np.asarray(w.planes[c]))
            assert np.array_equal(f.prefilter[c].numpy(),
                                  np.asarray(w.prefilter[c]))


@pytest.mark.parametrize("cls", DECODERS)
def test_batched_equals_unbatched(cls):
    """frame_dag_max=1 (the default: batching off) and 4 give the same
    planes."""
    s = _ra_stream()
    a = cls("cpu")
    assert a.frame_dag_max == 1
    outs_a = a.decode_stream(s)
    assert "dag_batched" not in a.stats
    b = cls("cpu", frame_dag_max=4)
    outs_b = b.decode_stream(s)
    assert b.stats.get("dag_batched", 0) >= 2
    assert [f.poc for f in outs_a] == [f.poc for f in outs_b]
    for fa, fb in zip(outs_a, outs_b):
        for c in range(3):
            assert np.array_equal(fa.planes[c], fb.planes[c]), (fa.poc, c)


def test_filters_off_decoder_batches():
    """apply_filters=False at frame_dag_max 4: the siblings still share
    one pass, and every plane equals the unfiltered golden decode."""
    gold = GoldenDecoder(apply_filters=False).decode_stream(_ra_stream())
    d = PipelinedTorchDecoder("cpu", apply_filters=False, frame_dag_max=4)
    out = d.decode_stream(_ra_stream())
    assert d.stats.get("dag_batched", 0) >= 2
    assert [f.poc for f in out] == [g.poc for g in gold]
    for f, g in zip(out, gold):
        for c in range(3):
            assert np.array_equal(f.planes[c], g.planes[c]), (f.poc, c)
            assert np.array_equal(f.prefilter[c].numpy(),
                                  g.prefilter[c]), (f.poc, c)


def test_pipelined_groups_are_the_same_on_every_run():
    runs = []
    for _ in range(10):
        dec = _spy(PipelinedTorchDecoder, frame_dag_max=4)
        dec.decode_stream(_ra_stream())
        runs.append(dec.groups)
    assert all(r == runs[0] for r in runs[1:])
    assert any(len(g) >= 2 for g in runs[0])


def test_decode_batch_planes_two_frames_with_mc_matches_jax():
    """Two sibling B pictures (different reference sets, bi-prediction) in
    one batch, each with its own MC arrays and reference stacks."""
    gold = _golden()
    by_poc = {g.poc: g for g in gold}
    dec = _spy(TorchDecoder, frame_dag_max=4)
    dec.decode_stream(_ra_stream())
    pair = next(g for g in dec.groups if len(g) >= 2)[:2]
    tasks = [next(t for t in dec.tasks if t["frame"].poc == p) for p in pair]
    plans = [by_poc[p].plan for p in pair]       # Python-parse plans
    assert any(p.motion.uses(0) and p.motion.uses(1)
               for plan in plans for p in plan.pus)
    tplans = [jax_tensor_plan(p, skip_pred=True) for p in plans]
    # the reference's shapes come from its policy, as TpuDecoder feeds it
    root = ShapePolicy()
    n_refs = [len(t["refs"]) for t in tasks]
    for tp, n in zip(tplans, n_refs):
        root.observe(tp, n_refs=n)
    root.observe_group(tplans, n_refs)
    pol = root.profile((1, len(pair)))
    mc_port, mc_jax, stacks, refs_jax = [], [], [], []
    for t, plan in zip(tasks, plans):
        pocs = sorted(t["refs"])
        pidx = {p: i for i, p in enumerate(pocs)}
        cnt = mc.mc_block_counts(plan)
        assert cnt == jmc.mc_block_counts(plan)
        mc_port.append(mc.mc_arrays_padded(plan, pidx, cnt))
        mc_jax.append(jmc.mc_arrays_padded(
            plan, pidx, {k: pol.mc_rows(k, n) for k, n in cnt.items()}))
        stacks.append(tuple(torch.from_numpy(np.stack(
            [by_poc[p].planes[c] for p in pocs]).astype(np.uint8))
            for c in range(3)))
        padded = pocs + [pocs[0]] * (pol.refs_cap(len(pocs)) - len(pocs))
        refs_jax.append(tuple(
            tuple(jnp.asarray(by_poc[p].planes[c].astype(np.uint8))
                  for p in padded) for c in range(3)))
    assert len(set(n_refs)) == 2          # stacks of different lengths
    want = jbd.decode_batch_planes(tplans, plans, policy=pol, mc=mc_jax,
                                   refs=tuple(refs_jax))
    got = bd.decode_batch_planes(
        bd.build_batch(tplans, plans, mc=mc_port), stacks, "cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8
        assert np.array_equal(g.numpy(), np.asarray(w))
    for f, p in enumerate(pair):
        assert np.array_equal(got[2][f].numpy(), by_poc[p].planes[0])
        assert np.array_equal(got[3][f].numpy(), by_poc[p].planes[1])
        assert np.array_equal(got[3][2 + f].numpy(), by_poc[p].planes[2])
