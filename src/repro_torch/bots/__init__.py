"""BOTS workloads on the port: twins of benchmarks/bots_*.py and run_curve."""
