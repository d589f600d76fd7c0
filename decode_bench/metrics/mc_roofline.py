"""The MC stage's share of its roofline: the least time the card could
take for the MC stage's work (K2: interpolation, combine and placement;
frozen census counts of the decoded segments, harness/work.py, at the
card's peaks) over the device time inside the ranges around
`pipeline/batch_decode.py mc_pred_planes`, summed over the window on
every rank, in percent."""
UNIT = "%"
LAYER = "kernels"
MOVES = "fps"
SOURCE = "device_trace"
RANGES = {"stage:mc": [("p265_tpu_torch.pipeline.batch_decode",
                        "mc_pred_planes")]}
STAGE = "mc"


def read(ranks: list):
    bound = dev = 0.0
    for r in ranks:
        b, t = r.get("stage_bound_s"), r.get("trace")
        if not b or not t or not t["stage_device_s"].get(STAGE):
            return None
        bound += b[STAGE]
        dev += t["stage_device_s"][STAGE]
    return 100 * bound / dev if dev and bound else None
