"""Debug probes of the port's kernels, run as `python -m` modules."""
