"""The device's idle share of the traced window: 1 minus the union of the
intervals in which any device operation ran (kernels and copies on every
stream, each instant counted once) over the window's wall, in percent;
the mean of the ranks."""
UNIT = "%"
LAYER = "device"
MOVES = "fps"
SOURCE = "device_trace"
RANGES = {}


def read(ranks: list):
    traced = [r["trace"] for r in ranks if r.get("trace")]
    if not traced or len(traced) != len(ranks) or not all(
            t["window_s"] for t in traced):
        return None
    return 100 * sum(1 - t["busy_s"] / t["window_s"]
                     for t in traced) / len(traced)
