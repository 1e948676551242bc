"""Hand-written Hopper kernels (sources in ../../csrc), each with its
plain PyTorch version and a launch counter: K1 (color_map), K2
(error_diffusion), K3 (shear) and the colour tail's per-frame scalars
(peak_tone)."""
