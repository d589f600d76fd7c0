"""The share of the host stages' time spent off the CPU: 1 minus their
thread CPU seconds over their wall seconds, in percent, from the
decoders' stats of the spans that run host work only (`finalize` and
`tensor_plan` on the parse thread, `mc_pack` and `pack` on the recon
worker; `p265_tpu_torch/spans.py`), summed over the window's segments on
every rank.  For Python work the time off the CPU is the wait for the
interpreter lock, plus the OS's preemption."""
UNIT = "%"
LAYER = "host threads"
MOVES = "fps"
SOURCE = "program_span"
RANGES = {}

SPANS = ("finalize", "tensor_plan", "mc_pack", "pack")


def read(ranks: list):
    stats = [r.get("stats") or {} for r in ranks]
    keys = [n + sfx for n in SPANS for sfx in ("_s", "_cpu_s")]
    if not stats or not all(k in s for s in stats for k in keys):
        return None
    wall = sum(s[n + "_s"] for s in stats for n in SPANS)
    cpu = sum(s[n + "_cpu_s"] for s in stats for n in SPANS)
    return 100 * (1 - cpu / wall) if wall else None
