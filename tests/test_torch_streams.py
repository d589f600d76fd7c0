"""The port's stream set (p265_tpu_torch/testgen/streams.py) against
tools/make_streams.py, and the slice through run_config against the JAX
package, on the CPU.

- The port's GENERATORS has make_streams' names, then its own
  (PORT_ONLY), and both modules write
  the same bytes for s416_ldp4 and for `_intra` with 4x2 tiles and WPP at
  512x256 (8x4 CTBs: each tile 2x2 CTBs, so the WPP sync after a row's
  second CTB falls inside a tile).
- Every committed stream matches data/SHA256SUMS, and the headers of each
  GENERATORS stream give the size, frame count, tile grid and WPP flag its
  generator sets.
- get_stream reads a committed stream, encodes an uncommitted one into
  its cache, refuses unknown names and a committed file whose bytes differ
  from SHA256SUMS.
- `run_config --device cpu` passes its golden gate on s416_ldp4; its gate
  refuses a frame that differs by one sample.  TorchDecoder("cpu") equals
  the JAX package's TpuDecoder and golden, plane for plane before and
  after the loop filters (np.array_equal), on s416_ldp4 and on the
  512x256 tiles+WPP stream.
"""
import functools
import hashlib
import os

import numpy as np
import pytest

from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu_torch import run_config
from p265_tpu_torch.pipeline.decoder import TorchDecoder
from p265_tpu_torch.testgen import streams
from tools import make_streams

# name -> (width, height, frames, tile grid, WPP) as its generator sets
HEADERS = {
    "s1080": (1920, 1080, 1, (1, 1), False),
    "s1080_ldp4": (1920, 1080, 4, (1, 1), False),
    "s1080_ldp16": (1920, 1080, 16, (1, 1), False),
    "s1080_ra8": (1920, 1080, 8, (1, 1), False),
    "s416_ldp4": (416, 240, 4, (1, 1), False),
    "s832_ldp4": (832, 480, 4, (1, 1), False),
    "s4k": (3840, 2160, 1, (1, 1), False),
    "s1080_t8": (1920, 1080, 1, (4, 2), False),
    "s1080_t8w": (1920, 1080, 1, (4, 2), True),
    "s1080_ra17": (1920, 1080, 17, (1, 1), False),
}
TILES_WPP = dict(tiles_enabled=True, num_tile_columns=4, num_tile_rows=2,
                 entropy_coding_sync_enabled=True)


@functools.lru_cache(maxsize=None)
def _stream(name: str) -> bytes:
    if name == "t8w_512x256":
        return streams._intra(512, 256, **TILES_WPP)
    return streams.get_stream(name)


def test_generator_names_match_make_streams():
    assert list(streams.GENERATORS) == (list(make_streams.GENERATORS)
                                        + list(streams.PORT_ONLY))
    assert set(HEADERS) == set(streams.GENERATORS)


@pytest.mark.parametrize("name", ["s416_ldp4", "t8w_512x256"])
def test_same_bytes_as_make_streams(name):
    if name == "s416_ldp4":
        got = streams.GENERATORS[name]()
        want = make_streams.GENERATORS[name]()
        assert got == streams.get_stream(name)     # the committed bytes
    else:
        got = streams._intra(512, 256, **TILES_WPP)
        want = make_streams._intra(512, 256, **TILES_WPP)
        assert streams.stream_info(got) == dict(
            width=512, height=256, frames=1, tiles=(4, 2), wpp=True)
    assert got == want


def _sums() -> dict:
    return streams.committed_sums()


@pytest.mark.parametrize("fn", sorted(_sums()))
def test_committed_stream_matches_sha256(fn):
    with open(os.path.join(streams.DATA, fn), "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == _sums()[fn]


@pytest.mark.parametrize("name", sorted(HEADERS))
def test_committed_stream_headers(name):
    assert name + ".265" in _sums(), f"{name} is not committed"
    w, h, frames, tiles, wpp = HEADERS[name]
    assert streams.stream_info(streams.get_stream(name)) == dict(
        width=w, height=h, frames=frames, tiles=tiles, wpp=wpp)


def test_get_stream_caches_uncommitted(tmp_path, monkeypatch):
    made = []

    def tiny():
        made.append(1)
        return streams._intra(64, 64)
    monkeypatch.setattr(streams, "cache_dir", lambda: str(tmp_path))
    monkeypatch.setitem(streams.GENERATORS, "tiny", tiny)
    data = streams.get_stream("tiny")
    assert made == [1]
    with open(tmp_path / "tiny.265", "rb") as f:
        assert f.read() == data
    assert streams.get_stream("tiny") == data and made == [1]
    assert streams.stream_info(data)["width"] == 64
    with open(os.path.join(streams.DATA, "s416_ldp4.265"), "rb") as f:
        assert streams.get_stream("s416_ldp4") == f.read()
    assert not (tmp_path / "s416_ldp4.265").exists()
    with pytest.raises(KeyError, match="unknown stream"):
        streams.get_stream("s9999")


def test_get_stream_refuses_a_changed_committed_file(tmp_path, monkeypatch):
    sums = _sums()
    (tmp_path / "SHA256SUMS").write_text(
        f"{sums['s416_ldp4.265']}  s416_ldp4.265\n")
    data = bytearray(streams.get_stream("s416_ldp4"))
    data[-1] ^= 1
    (tmp_path / "s416_ldp4.265").write_bytes(bytes(data))
    monkeypatch.setattr(streams, "DATA", str(tmp_path))
    with pytest.raises(ValueError, match="sha256"):
        streams.get_stream("s416_ldp4")


def test_run_config_cpu_gates_against_golden(capsys):
    assert run_config.main(["s416_ldp4", "0", "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "416x240, 4 frames" in err
    assert "cold pass" in err and "bit-exact vs golden" in err
    assert "dispatches (pocs: scan steps): [0]:" in err


def test_gate_refuses_one_sample():
    gold = run_config.golden_frames(_stream("t8w_512x256"))
    frames = run_config.golden_frames(_stream("t8w_512x256"))
    run_config.gate(frames, gold, "same")
    frames[0].prefilter[1] = frames[0].prefilter[1].copy()
    frames[0].prefilter[1][3, 5] ^= 1
    with pytest.raises(RuntimeError, match="prefilter 1 differs"):
        run_config.gate(frames, gold, "one sample")


@pytest.mark.parametrize("name", ["s416_ldp4", "t8w_512x256"])
def test_port_matches_tpu_decoder_and_golden(name):
    from p265_tpu.pipeline.decoder import TpuDecoder
    data = _stream(name)
    gold = GoldenDecoder().decode_stream(data)
    want = TpuDecoder().decode_stream(data)
    got = TorchDecoder("cpu").decode_stream(data)
    assert [f.poc for f in got] == [f.poc for f in want] == [
        g.poc for g in gold]
    for f, w, g in zip(got, want, gold):
        for c in range(3):
            assert np.array_equal(f.planes[c], np.asarray(w.planes[c]))
            assert np.array_equal(f.planes[c], g.planes[c])
            pre = f.prefilter[c].numpy()
            assert np.array_equal(pre, np.asarray(w.prefilter[c]))
            assert np.array_equal(pre, g.prefilter[c])
