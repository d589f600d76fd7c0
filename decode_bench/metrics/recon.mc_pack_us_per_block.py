"""The MC pack's host time a block: the decoders' stats `mc_pack_s` (the
span around `mc_block_counts`, `mc_arrays_padded` and `ref_stacks` in
`pipeline/decoder.py TorchDecoder._dispatch_group`, on the recon worker)
over `mc_blocks` (the MC blocks `mc_arrays_padded` packed, luma and
chroma), summed over the window's segments on every rank, in
microseconds: the pack's cost per unit of work, comparable between
P-only and bi-predicted traffic.  None where a program keeps no
`mc_blocks`, or packed none."""
UNIT = "us"
LAYER = "recon worker"
MOVES = "fps"
SOURCE = "program_span"
RANGES = {}


def read(ranks: list):
    stats = [r.get("stats") or {} for r in ranks]
    if not stats or not all("mc_pack_s" in s and "mc_blocks" in s
                            for s in stats):
        return None
    blocks = sum(s["mc_blocks"] for s in stats)
    if not blocks:
        return None
    return sum(s["mc_pack_s"] for s in stats) / blocks * 1e6
