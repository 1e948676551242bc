"""The harness: cells, traffic, deployments, traces and the check."""
