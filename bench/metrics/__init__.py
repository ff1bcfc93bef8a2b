"""Per-layer metrics, one reader a metric, named as in BENCHMARK.json:
``read(reading)`` returns the number, or None where the run has nothing
for it to read."""
