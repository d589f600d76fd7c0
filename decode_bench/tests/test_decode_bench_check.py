import json
import subprocess
import sys
import types

import numpy as np
import pytest

from decode_bench.harness import check, streams, traffic as tf
from decode_bench.harness.spec import benchmark, traffic

SMALL = ["s96x64_ldp5", "s96x64_ra5", "s96x64_ldp5.idr"]


def _frames(planes_by_poc):
    return [types.SimpleNamespace(poc=p, planes=pl) for p, pl in planes_by_poc]


def test_compare_counts_planes_and_pictures():
    y = np.zeros((4, 4), np.int32)
    c = np.ones((2, 2), np.int32)
    want = check.frame_digests(_frames([(0, [y, c, c]), (1, [y, c, c])]))
    assert check.compare(want, want) == (0, 0)
    bad = y.copy()
    bad[1, 2] = 9
    got = check.frame_digests(_frames([(0, [bad, c, c]), (1, [y, c, c])]))
    assert check.compare(got, want) == (1, 0)
    assert check.compare(want[:1], want) == (0, 1)
    swapped = check.frame_digests(_frames([(1, [y, c, c]), (0, [y, c, c])]))
    assert check.compare(swapped, want) == (0, 2)
    wide = y.copy()
    wide[0, 0] = 256          # would wrap to 0 as uint8
    got = check.frame_digests(_frames([(0, [wide, c, c]), (1, [y, c, c])]))
    assert check.compare(got, want) == (1, 0)


@pytest.mark.parametrize("item", SMALL)
def test_reference_digests_equal_the_programs_golden_and_cpu_path(item):
    from p265_tpu_torch.golden.decoder import GoldenDecoder
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    want = check.load_expected(item)["pictures"]
    data = streams.segment_bytes(item)
    for frames in (GoldenDecoder().decode_stream(data),
                   PipelinedTorchDecoder("cpu").decode_stream(data)):
        assert check.compare(check.frame_digests(frames), want) == (0, 0)


@pytest.mark.parametrize("item", SMALL)
def test_committed_digests_are_the_references(item):
    from decode_bench.tools.make_expected import expected
    rec = expected(item)
    assert rec["pictures"] == check.load_expected(item)["pictures"]


def test_every_pool_item_has_reference_digests_and_work():
    import os
    from decode_bench.harness import work
    for w in benchmark()["workloads"]:
        for item in traffic(w["traffic"])["pool"]:
            rec = check.load_expected(item)
            assert rec["pictures"]
            assert work.load(item) is not None
            assert os.path.exists(os.path.join(work.WORK_DIR, item + ".json"))


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r);"
            "from decode_bench import reference;"
            "from decode_bench.harness import streams;"
            "reference.decode(streams.segment_bytes('s96x64_ldp5.idr'));"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))" % streams.REPO_DIR)
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True).stdout
    top = set(json.loads(out.splitlines()[-1]))
    assert not top & {"p265_tpu", "p265_tpu_torch", "jax", "torch"}
