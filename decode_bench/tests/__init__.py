"""The benchmark's own tests: python -m pytest decode_bench/tests -q.  The
harness runs here on the CPU with the program's plain kernels and the
small committed streams; the card's test skips without a card."""
