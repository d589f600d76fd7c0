"""The tensor plan's host time a frame: the decoders' stats `tensor_plan_s`
(the span around `build_tensor_plan` in `pipeline/decoder.py
TorchDecoder._build_tplan`, on the parse thread) over `frames`, summed
over the window's segments on every rank."""
UNIT = "ms"
LAYER = "tensor plan"
MOVES = "fps"
SOURCE = "program_span"
RANGES = {}


def read(ranks: list):
    stats = [r.get("stats") or {} for r in ranks]
    if not stats or not all("tensor_plan_s" in s for s in stats):
        return None
    frames = sum(s.get("frames", 0) for s in stats)
    if not frames:
        return None
    return sum(s["tensor_plan_s"] for s in stats) / frames * 1e3
