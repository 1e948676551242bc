"""The benchmark of libplacebo_tpu_torch: see README.md."""
