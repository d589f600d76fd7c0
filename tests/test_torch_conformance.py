"""What DecoderBase gives, through the port's decoders on CPU tensors, vs
the golden decoder, bit-exact: the stream kinds that the JAX package's
tests hold TpuDecoder and GoldenDecoder to, beyond those of
tests/test_torch_decoder.py.

Long-term references (tests/test_longterm.py), cu_qp_delta in intra and
inter pictures and reference-list modification (tests/test_cu_qp_delta.py),
several slices, dependent slice segments, slices with tiles and with WPP
(tests/test_multislice.py), weighted prediction over short- and long-term
references (tests/test_conformance_corners.py), and the CRA / RASL / BLA /
EOS splices of tests/test_rasl.py.  Sizes 96x64 to 192x128.  The recipes
live in p265_tpu_torch/testgen/conformance.py (tests/test_torch_gpu.py
decodes them on the card), with the port's copies of the JAX tests' two
helpers, held here against the originals.
"""
import functools

import numpy as np
import pytest
from test_multislice import _param_nals
from test_rasl import _splice_from_cra

from p265_tpu.golden.decoder import GoldenDecoder
from p265_tpu_torch.hls import nal
from p265_tpu_torch.hls.params import PPS, SPS
from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
from p265_tpu_torch.pipeline.decoder import TorchDecoder
from p265_tpu_torch.testgen.conformance import (STREAMS, param_nals,
                                                splice_from_cra)


@functools.lru_cache(maxsize=None)
def _golden(name):
    data = STREAMS[name][0]()
    return data, GoldenDecoder().decode_stream(data)


@pytest.mark.parametrize("cls", [TorchDecoder, PipelinedTorchDecoder])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_matches_golden(name, cls):
    data, gold = _golden(name)
    assert STREAMS[name][1](gold), "the stream does not hold the case"
    if name == "dependent_slices":
        units = [u for u in nal.split_nal_units(data)
                 if nal.is_slice_nal(u.nal_type)]
        assert len(units) == 3
    frames = cls("cpu").decode_stream(data)
    assert [f.poc for f in frames] == [g.poc for g in gold]
    for f, g in zip(frames, gold):
        for c in range(3):
            assert np.array_equal(f.planes[c], g.planes[c]), (f.poc, c)
            assert np.array_equal(f.prefilter[c].numpy(),
                                  g.prefilter[c]), (f.poc, c)


def test_helpers_equal_the_jax_tests():
    """The port's param_nals and splice_from_cra give the bytes of the JAX
    package's tests' _param_nals and _splice_from_cra."""
    sps = SPS(pic_width=192, pic_height=128)
    pps = PPS(init_qp=31, sign_data_hiding=True, tiles_enabled=True,
              num_tile_columns=2, num_tile_rows=2)
    assert param_nals(sps, pps) == _param_nals(sps, pps)
    data, _ = _golden("cra_rasl_full")
    assert splice_from_cra(data) == _splice_from_cra(data)
    assert splice_from_cra(data) != data
