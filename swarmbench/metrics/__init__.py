"""Metric readers, one file a metric, found by the name in BENCHMARK.json."""
