"""How long a picture waited for the recon worker: the decoders' stats
`queue_wait_s` (each picture's time from the parse thread's put of its
group on `PipelinedTorchDecoder._q` to the recon worker's get of it;
0 in the serial decoder) over `frames`, summed over the window's
segments on every rank.  A reading of 0 is a reading."""
UNIT = "ms"
LAYER = "recon queue"
MOVES = "fps"
SOURCE = "program_span"
RANGES = {}


def read(ranks: list):
    stats = [r.get("stats") or {} for r in ranks]
    if not stats or not all("queue_wait_s" in s for s in stats):
        return None
    frames = sum(s.get("frames", 0) for s in stats)
    if not frames:
        return None
    return sum(s["queue_wait_s"] for s in stats) / frames * 1e3
