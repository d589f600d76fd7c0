"""The entries that a window drives, by the name a configuration gives in
`entry`.  Each is made on one process for its rank and returns
(decode, this rank's items, the decoder class).  An item is (its position
in the traffic's sequence, its pool name); decode(item) -> (frames,
error): the program's decoded frames in output order, or None with the
error's text.

- "decoder": `decode_stream(segment)` of a fresh
  `p265_tpu_torch.pipeline.async_decoder.PipelinedTorchDecoder(device,
  **config["decoder"])` a segment.
- "stream_axis": this rank's share of the segment list, dealt by
  `p265_tpu_torch.shard.distributed.schedule_segments`, each decoded by
  `decode_segments_production([segment], device)`, one segment a call.
"""
from __future__ import annotations

from decode_bench.harness.streams import segment_bytes


def _guarded(fn):
    def decode(item):
        try:
            return fn(item[1]), None
        except Exception as e:  # noqa: BLE001 -- counted as a failed segment
            return None, f"{type(e).__name__}: {e}"
    return decode


def decoder(config: dict, device, items, warm, rank: int,
            nranks: int) -> tuple:
    """-> (decode, this rank's item iterator, decoder class)."""
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    opts = config.get("decoder", {})
    cache = {}

    def run(item):
        if item not in cache:
            cache[item] = segment_bytes(item)
        return PipelinedTorchDecoder(device, **opts).decode_stream(
            cache[item])
    if nranks != 1:
        raise ValueError("entry 'decoder' runs on one process")
    return _guarded(run), enumerate(items), PipelinedTorchDecoder


def stream_axis(config: dict, device, items, warm, rank: int,
                nranks: int) -> tuple:
    """items: the whole finite segment list; this rank decodes its share
    in the order schedule_segments deals it."""
    from p265_tpu_torch.pipeline.async_decoder import PipelinedTorchDecoder
    from p265_tpu_torch.shard.distributed import (decode_segments_production,
                                                  schedule_segments)
    items = list(items)
    data = {it: segment_bytes(it) for it in set(items) | set(warm)}
    mine, layout = schedule_segments([data[it] for it in items], nranks,
                                     rank)
    if any(n != 1 for n in layout):
        raise ValueError("entry 'stream_axis': every pool item must be one "
                         "IRAP segment (its reference digests are of it)")
    segment = {items[si]: seg for si, _, seg in mine}

    def run(item):
        return decode_segments_production([segment.get(item, data[item])],
                                          device)[0]
    return (_guarded(run), iter([(si, items[si]) for si, _, _ in mine]),
            PipelinedTorchDecoder)


ENTRIES = {"decoder": decoder, "stream_axis": stream_axis}
