"""First-divergence tracing for CABAC bin streams (SURVEY.md 5.1).

Wraps the CABAC engines to log every (kind, ctx, bin) event; diffing an
encoder log against a decoder log localizes the first desynchronized syntax
element.
"""
from __future__ import annotations


class BinLog:
    def __init__(self):
        self.events: list[tuple] = []

    def diff(self, other: "BinLog") -> int | None:
        for i, (a, b) in enumerate(zip(self.events, other.events)):
            if a != b:
                return i
        if len(self.events) != len(other.events):
            return min(len(self.events), len(other.events))
        return None


def attach_logger(engine, log: BinLog):
    """Wrap encode/decode methods of a CabacEncoder/CabacDecoder in-place."""
    if hasattr(engine, "decode_bin"):
        orig_bin, orig_byp, orig_term = (engine.decode_bin, engine.decode_bypass,
                                         engine.decode_terminate)

        def decode_bin(idx):
            v = orig_bin(idx)
            log.events.append(("ctx", idx, v))
            return v

        def decode_bypass():
            v = orig_byp()
            log.events.append(("byp", None, v))
            return v

        def decode_terminate():
            v = orig_term()
            log.events.append(("term", None, v))
            return v

        engine.decode_bin = decode_bin
        engine.decode_bypass = decode_bypass
        engine.decode_terminate = decode_terminate
    else:
        orig_bin, orig_byp, orig_term = (engine.encode_bin, engine.encode_bypass,
                                         engine.encode_terminate)

        def encode_bin(idx, b):
            log.events.append(("ctx", idx, b))
            orig_bin(idx, b)

        def encode_bypass(b):
            log.events.append(("byp", None, b))
            orig_byp(b)

        def encode_terminate(b):
            log.events.append(("term", None, b))
            orig_term(b)

        engine.encode_bin = encode_bin
        engine.encode_bypass = encode_bypass
        engine.encode_terminate = encode_terminate
    return engine
