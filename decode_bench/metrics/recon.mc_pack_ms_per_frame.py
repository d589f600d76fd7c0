"""The MC pack's host time a frame: the decoders' stats `mc_pack_s` (the
span around `mc_block_counts`, `mc_arrays_padded` and `ref_stacks` in
`pipeline/decoder.py TorchDecoder._dispatch_group`, on the recon worker)
over `frames`, summed over the window's segments on every rank."""
UNIT = "ms"
LAYER = "recon worker"
MOVES = "fps"
SOURCE = "program_span"
RANGES = {}


def read(ranks: list):
    stats = [r.get("stats") or {} for r in ranks]
    if not stats or not all("mc_pack_s" in s for s in stats):
        return None
    frames = sum(s.get("frames", 0) for s in stats)
    if not frames:
        return None
    return sum(s["mc_pack_s"] for s in stats) / frames * 1e3
