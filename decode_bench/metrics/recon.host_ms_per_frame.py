"""The recon worker's host time a frame: the decoders' stats `recon_s`
(the MC pack, the batch pack, the staged upload and the enqueue of the
device work) over `frames`, summed over the window's segments on every
rank."""
UNIT = "ms"
LAYER = "recon worker"
MOVES = "fps"
SOURCE = "program_span"
RANGES = {}


def read(ranks: list):
    recon = sum(r.get("stats", {}).get("recon_s", 0.0) for r in ranks)
    frames = sum(r.get("stats", {}).get("frames", 0) for r in ranks)
    return recon / frames * 1e3 if frames and recon else None
