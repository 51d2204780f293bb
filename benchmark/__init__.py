"""The port's benchmark (BENCHMARK.json at the repository's root): run.py
runs one cell once; harness.py holds the run, loads.py the traffic
generator, yardstick.py the peaks, counts and statistics, reference/ the
plain float64 reference, configs/ traffic/ metrics/ one file per
configuration, traffic mix and per-layer metric."""
