"""The native slice parse's host time a frame: the decoders' stats
`parse_s` (golden/decoder.py `_decode_slice`: the CABAC and CTU parse of
each slice, the motion replay not included) over `frames`, summed over
the window's segments on every rank."""
UNIT = "ms"
LAYER = "parse"
MOVES = "fps"
SOURCE = "program_span"
RANGES = {}


def read(ranks: list):
    parse = sum(r.get("stats", {}).get("parse_s", 0.0) for r in ranks)
    frames = sum(r.get("stats", {}).get("frames", 0) for r in ranks)
    return parse / frames * 1e3 if frames and parse else None
