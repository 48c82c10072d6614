"""Per-layer metrics, one file each, named as in BENCHMARK.json, and K2's
byte model (``k2_bytes``)."""
