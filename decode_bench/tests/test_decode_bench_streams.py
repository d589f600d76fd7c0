import os
import shutil

import numpy as np
import pytest

from decode_bench.harness import check, streams


def test_committed_streams_match_their_sums():
    for name in streams.sums():
        assert streams.read_stream(name)


def _copy(tmp_path, name: str, corrupt: bool) -> tuple:
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    src = os.path.join(streams.DATA_DIR, name + ".265")
    dst = data_dir / (name + ".265")
    shutil.copy(src, dst)
    if corrupt:
        raw = bytearray(dst.read_bytes())
        raw[len(raw) // 2] ^= 1
        dst.write_bytes(bytes(raw))
    return str(data_dir), streams.SUMS


def test_a_stream_whose_sha256_differs_is_refused(tmp_path):
    d, s = _copy(tmp_path, "s96x64_ldp5", corrupt=True)
    with pytest.raises(ValueError, match="sha256"):
        streams.read_stream("s96x64_ldp5", data_dir=d, sums_path=s)


def test_a_missing_stream_is_refused_and_never_encoded(tmp_path):
    with pytest.raises(FileNotFoundError):
        streams.read_stream("s96x64_ldp5", data_dir=str(tmp_path))
    with pytest.raises(ValueError, match="no sum"):
        streams.read_stream("s96x64_unknown")


def test_an_unknown_cut_is_refused():
    with pytest.raises(ValueError, match="no cut"):
        streams.segment_bytes("s96x64_ldp5.tail")


def test_idr_cut_holds_the_parameter_sets_and_one_picture():
    data = streams.read_stream("s96x64_ldp5")
    cut = streams.segment_bytes("s96x64_ldp5.idr")
    units = streams.nal_units(cut)
    types = [t for t, _, _ in units]
    assert types[:3] == [32, 33, 34]
    assert all(streams.is_irap(t) for t in types[3:])
    assert sum(first for t, first, _ in units if streams.is_slice(t)) == 1
    assert data.startswith(b"".join(raw for _, _, raw in units[:3]))


def test_idr_cut_decodes_equal_to_the_streams_first_picture_on_the_cpu():
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    whole = PipelinedTorchDecoder("cpu").decode_stream(
        streams.segment_bytes("s96x64_ldp5"))
    cut = PipelinedTorchDecoder("cpu").decode_stream(
        streams.segment_bytes("s96x64_ldp5.idr"))
    assert len(cut) == 1 and cut[0].poc == whole[0].poc == 0
    for a, b in zip(cut[0].planes, whole[0].planes):
        assert np.array_equal(a, b)
    want = check.load_expected("s96x64_ldp5.idr")["pictures"]
    assert check.compare(check.frame_digests(cut), want) == (0, 0)

