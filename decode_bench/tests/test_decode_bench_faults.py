"""A run driven on the CPU with the timed path broken underneath: each
fault must turn `correct` false, the sound path and the control must read
as they should.  The look for a card is skipped; the rest of a run
(set-up, window, comparison, result) is the benchmark's own."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from decode_bench.harness.cell import run_rank
from decode_bench.harness.result import result
from decode_bench.harness.streams import BENCH_DIR, REPO_DIR
from decode_bench.tests.helpers import STREAM_AXIS, tiny_cell, units
from decode_bench.tools.control import control_cell


def _run(cell, seed=2**31 + 77, seconds=0.6, trace=False, **kw):
    ranks = [run_rank(cell, seed, seconds, trace, "cpu", **kw)]
    return result(cell, ranks, 1, ranks[0]["t_open"] - 1.0, trace, units())


def test_a_sound_run_is_correct_and_its_line_ends_with_the_check():
    out = _run(tiny_cell())
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "check"
    assert all(c["value"] == 0 == c["limit"] for c in out["check"].values())
    assert set(out["metrics"]) == {"fps", "setup_s"}
    assert out["device"]["count"] == 1


def _files(root: str) -> dict:
    """{path: (size, mtime)} of the files under root, bytecode caches and
    the build caches left out."""
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x not in ("__pycache__", ".cache")]
        for f in files:
            st = os.stat(os.path.join(d, f))
            out[os.path.join(d, f)] = (st.st_size, st.st_mtime_ns)
    return out


def test_a_cell_on_a_new_stream_takes_new_files_only(tmp_path, monkeypatch):
    """s416_ldp4, which no cell uses, enters a pool by new files alone: its
    sum file, its reference digests (tools/make_expected.py) and a traffic
    file.  The cell runs to `correct`; no file of decode_bench/ is
    written."""
    from decode_bench.harness import check, spec, streams
    from decode_bench.tools.make_expected import write
    before = _files(BENCH_DIR)
    stream = "s416_ldp4"
    for d in ("sums", "expected", "traffic"):
        (tmp_path / d).mkdir()
    with open(os.path.join(streams.DATA_DIR, "SHA256SUMS")) as f:
        line = next(x for x in f if x.split()[1] == stream + ".265")
    (tmp_path / "sums" / (stream + ".sha256")).write_text(line)
    (tmp_path / "traffic" / "s416_segments.json").write_text(json.dumps(
        dict(pool={stream: 1}, order="permutation_repeated", warm=[stream])))
    monkeypatch.setattr(streams, "SUMS_DIR", str(tmp_path / "sums"))
    monkeypatch.setattr(check, "EXPECTED_DIR", str(tmp_path / "expected"))
    write(stream, str(tmp_path / "expected"))
    rec = check.load_expected(stream)
    assert len(rec["pictures"]) == 4
    assert rec["segment_sha256"] == hashlib.sha256(
        streams.segment_bytes(stream)).hexdigest() == line.split()[0]
    out = _run(tiny_cell(**spec.traffic("s416_segments",
                                        bench_dir=str(tmp_path))))
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
    assert out["check"]["planes_wrong"]["value"] == 0
    assert out["check"]["pictures_missing"]["value"] == 0
    assert _files(BENCH_DIR) == before


def test_a_traced_cpu_run_reads_the_programs_stats():
    out = _run(tiny_cell(), trace=True)
    assert out["correct"]
    assert out["metrics"]["parse.slice_ms_per_frame"]["value"] > 0
    assert out["metrics"]["recon.host_ms_per_frame"]["value"] > 0


def test_a_sample_altered_where_the_planes_are_fetched(monkeypatch):
    import p265_tpu_torch.pipeline.async_decoder as ad
    fetch = ad.fetch_planes

    def altered(*a, **k):
        planes = fetch(*a, **k)
        planes[1][3, 5] ^= 1
        return planes
    monkeypatch.setattr(ad, "fetch_planes", altered)
    out = _run(tiny_cell())
    assert not out["correct"]
    assert out["check"]["planes_wrong"]["value"] > 0
    assert out["failed"] == out["attempted"]


def test_half_of_a_segments_pictures_left_out(monkeypatch):
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    decode = PipelinedTorchDecoder.decode_stream

    def half(self, data):
        frames = decode(self, data)
        return frames[:len(frames) // 2]
    monkeypatch.setattr(PipelinedTorchDecoder, "decode_stream", half)
    out = _run(tiny_cell())
    assert not out["correct"]
    assert out["check"]["pictures_missing"]["value"] > 0


def test_half_of_a_ranks_share_left_out_on_the_stream_axis(monkeypatch):
    import p265_tpu_torch.shard.distributed as dist
    schedule = dist.schedule_segments

    def half(streams, n, rank):
        mine, layout = schedule(streams, n, rank)
        return mine[1::2], layout
    cell = tiny_cell(STREAM_AXIS, chips=4,
                     order="permutation_per_cycle", cycles=8)
    sound = run_rank(cell, 5, 0.6, False, "cpu", rank=1, nranks=4)
    assert sound["segments_misdealt"] == 0
    monkeypatch.setattr(dist, "schedule_segments", half)
    r = run_rank(cell, 5, 0.6, False, "cpu", rank=1, nranks=4)
    assert r["segments_misdealt"] > 0
    out = result(cell, [r] + [sound] * 3, 4, r["t_open"] - 1.0, False,
                 units())
    assert not out["correct"]


def test_a_ranks_results_left_out_of_the_exchange():
    cell = tiny_cell(STREAM_AXIS, chips=4,
                     order="permutation_per_cycle", cycles=8)
    ranks = [run_rank(cell, 9, 0.4, False, "cpu", rank=r, nranks=4)
             for r in range(3)]
    out = result(cell, ranks, 4, ranks[0]["t_open"] - 1.0, False, units())
    assert not out["correct"]
    assert out["check"]["ranks_missing"]["value"] == 1


def test_the_control_fails():
    out = _run(control_cell(tiny_cell()))
    assert not out["correct"]
    assert out["check"]["planes_wrong"]["value"] > 0


def test_two_cpu_ranks_in_two_processes():
    from decode_bench.harness.launch import run_ranks
    import time
    cell = tiny_cell(STREAM_AXIS, chips=4,
                     order="permutation_per_cycle", cycles=8)
    ranks = run_ranks(cell, 123456789012, 0.8, False, "cpu", 2,
                      time.monotonic() + 240)
    out = result(cell, ranks, 2, min(r["t_open"] for r in ranks) - 1.0,
                 False, units())
    assert out["correct"] and out["device"]["count"] == 2
    assert [r["rank"] for r in ranks] == [0, 1]


def _cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "decode_bench/run.py", "--workload",
         "main1080_1card.ldp_segments", "--seed", "1", "--seconds", "1",
         *extra], cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_a_card_the_run_exits_nonzero_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = _cli(REPO_DIR)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_alone_in_a_directory_the_run_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO_DIR, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "decode_bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    r = _cli(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_the_kernels_part_of_setup_is_reported_apart():
    from decode_bench.harness.result import setup_parts
    built = dict(kernels_s=21.5, kernels_built=True, parse_built=True,
                 warm_s=24.0)
    loaded = dict(kernels_s=0.02, kernels_built=False, parse_built=False,
                  warm_s=3.1)
    assert setup_parts([{"setup_parts": built}, {"setup_parts": loaded}]) \
        == built
    assert setup_parts([{"setup_parts": loaded}]) == loaded
    assert setup_parts([{"setup_parts": {}}]) == {}
    out = _run(tiny_cell())     # on the CPU no kernel library is loaded
    assert out["setup"] == {} and list(out)[-1] == "check"
