"""CPU tests of the benchmark (run them with python -m pytest framebench/tests), and the readings of the check on the card."""
