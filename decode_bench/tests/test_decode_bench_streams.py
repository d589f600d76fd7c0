import hashlib
import os
import shutil

import numpy as np
import pytest

from decode_bench.harness import check, spec, streams
from decode_bench.tests import helpers

IDR_ITEM = "s96x64_ldp5.idr"


def _streams_read() -> set:
    """The streams that something reads: the items of every committed
    traffic file's pool and warm list, the tiny cell's pool and the IRAP
    cut tested here."""
    items = set(helpers.SMALL) | {IDR_ITEM}
    tdir = os.path.join(streams.BENCH_DIR, "traffic")
    for f in os.listdir(tdir):
        if f.endswith(".json"):
            t = spec.traffic(f.removesuffix(".json"))
            items |= set(t["pool"]) | set(t.get("warm", []))
    return {item.partition(".")[0] for item in items}


def test_committed_streams_match_their_sums():
    """Each stream read has its sum file, and no sum file is dead data."""
    assert sorted(streams.sums()) == sorted(_streams_read())
    for name in streams.sums():
        assert streams.read_stream(name)


def test_each_sum_equals_the_programs_own_table():
    """The benchmark's sums and the program's data/SHA256SUMS are kept
    apart on purpose; this catches a drift between them."""
    with open(os.path.join(streams.DATA_DIR, "SHA256SUMS")) as f:
        program = {n.removesuffix(".265"): d
                   for d, n in (line.split() for line in f if line.strip())}
    for name, digest in streams.sums().items():
        assert digest == program[name], name


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
    return str(data_dir)


def test_a_stream_whose_sha256_differs_is_refused(tmp_path):
    d = _copy(tmp_path, "s96x64_ldp5", corrupt=True)
    with pytest.raises(ValueError, match="sha256"):
        streams.read_stream("s96x64_ldp5", data_dir=d)


def test_a_missing_stream_is_refused_and_never_encoded(tmp_path):
    with pytest.raises(FileNotFoundError):
        streams.read_stream("s96x64_ldp5", data_dir=str(tmp_path))
    with pytest.raises(ValueError, match="no sum"):
        streams.read_stream("s96x64_unknown")


GOOD = streams.read_sum("s96x64_ldp5")


@pytest.mark.parametrize("text, match", [
    (None, "'s96x64_ldp5' has no sum: .* is not there"),
    (f"{GOOD}  s96x64_ldp5.265\n{GOOD}  s96x64_ldp5.265\n", "2 lines"),
    ("", "0 lines"),
    (f"{GOOD}  s96x64_ra5.265\n", "names 's96x64_ra5.265'"),
    (f"{GOOD}\n", "names ''"),
    (f"{GOOD[:-1]}  s96x64_ldp5.265\n", "not 64 lowercase hex"),
    (f"{GOOD.upper()}  s96x64_ldp5.265\n", "not 64 lowercase hex"),
    (f"{GOOD[:-1]}g  s96x64_ldp5.265\n", "not 64 lowercase hex"),
], ids=["no_file", "two_lines", "empty", "another_stream", "no_stream",
        "short_digest", "upper_case", "not_hex"])
def test_a_sum_file_that_is_not_one_line_naming_its_stream_is_refused(
        tmp_path, monkeypatch, text, match):
    if text is not None:
        (tmp_path / "s96x64_ldp5.sha256").write_text(text)
    monkeypatch.setattr(streams, "SUMS_DIR", str(tmp_path))
    with pytest.raises(ValueError, match=match) as e:
        streams.read_stream("s96x64_ldp5")
    assert str(tmp_path / "s96x64_ldp5.sha256") in str(e.value)


def test_an_unknown_cut_is_refused():
    with pytest.raises(ValueError, match="no cut"):
        streams.segment_bytes("s96x64_ldp5.tail")


def test_idr_cut_holds_the_parameter_sets_and_one_picture():
    data = streams.read_stream("s96x64_ldp5")
    cut = streams.segment_bytes(IDR_ITEM)
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
        streams.segment_bytes(IDR_ITEM))
    assert len(cut) == 1 and cut[0].poc == whole[0].poc == 0
    for a, b in zip(cut[0].planes, whole[0].planes):
        assert np.array_equal(a, b)
    want = check.load_expected(IDR_ITEM)["pictures"]
    assert check.compare(check.frame_digests(cut), want) == (0, 0)


@pytest.mark.parametrize("item", sorted(
    f.removesuffix(".json") for f in os.listdir(check.EXPECTED_DIR)))
def test_each_items_bytes_are_those_its_reference_digests_were_made_from(
        item):
    rec = check.load_expected(item)
    assert hashlib.sha256(streams.segment_bytes(item)).hexdigest() \
        == rec["segment_sha256"]
