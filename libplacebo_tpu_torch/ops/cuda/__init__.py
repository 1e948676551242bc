"""Hand-written Hopper kernels (sources in ../../csrc), each with its
plain PyTorch version and a launch counter: K1 (color_map), K2
(error_diffusion), K3 (shear), the colour tail's per-frame scalars
(peak_tone) and the front's merge, decode and PQ linearize (front)."""
