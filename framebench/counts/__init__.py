"""Frozen operation and byte counts of the kernels whose roofline share
the benchmark reports."""
