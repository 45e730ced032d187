"""The port's benchmark: a harness driven by the files that BENCHMARK.json names (README.md)."""
