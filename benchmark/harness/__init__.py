"""The harness: general code that every cell shares. What belongs to one
configuration, traffic mix or per-layer metric lives in configs/,
traffic/ and metrics/, found by the names in BENCHMARK.json."""
