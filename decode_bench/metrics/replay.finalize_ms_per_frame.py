"""The motion replay's host time a frame: the decoders' stats `finalize_s`
(the span around `native/parse.py NativeParseState.finalize` in
`pipeline/decoder.py TorchDecoder._finish_picture`, on the parse thread:
the replay of the C parse's motion syntax into PUs and the SAO records)
over `frames`, summed over the window's segments on every rank."""
UNIT = "ms"
LAYER = "motion replay"
MOVES = "fps"
SOURCE = "program_span"
RANGES = {}


def read(ranks: list):
    stats = [r.get("stats") or {} for r in ranks]
    if not stats or not all("finalize_s" in s for s in stats):
        return None
    frames = sum(s.get("frames", 0) for s in stats)
    if not frames:
        return None
    return sum(s["finalize_s"] for s in stats) / frames * 1e3
