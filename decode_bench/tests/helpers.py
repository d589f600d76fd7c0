"""A tiny cell on the small committed streams, for the CPU."""
from decode_bench.harness import spec

SMALL = {"s96x64_ldp5": 2, "s96x64_ra5": 1}
# a configuration of the stream axis (one process a card, each rank's
# share dealt by schedule_segments), for the launcher's and the deal's tests
STREAM_AXIS = {"name": "tiny_stream_axis", "chips": 4, "entry": "stream_axis",
               "decoder": {}}


def tiny_cell(config="main1080_1card", chips: int = 1, **traffic) -> dict:
    """config: a configuration's name, or the configuration itself."""
    t = dict(pool=dict(SMALL), order="permutation_repeated",
             warm=["s96x64_ldp5"])
    t.update(traffic)
    cfg = spec.config(config) if isinstance(config, str) else dict(config)
    return dict(workload={"name": "tiny", "chips": chips},
                config=cfg, traffic=t,
                end_to_end=["fps", "setup_s"],
                per_layer=["parse.slice_ms_per_frame",
                           "recon.host_ms_per_frame"])


def units() -> dict:
    b = spec.benchmark()
    return {m["name"]: m["unit"] for m in b["end_to_end"] + b["per_layer"]}
