"""A frozen copy of the program's plain PyTorch and NumPy for the parts of
libplacebo's chain the reference follows step by step, cut to what
`reference/chain.py` calls: colour-space metadata and its inference,
the spline tone curve driven by the detected peak, perceptual gamut
mapping in IPT with its fitted gamut boundaries, the peak's temporal
filter, and the blue-noise matrix.  Every other stage is written
afresh in `reference/stages.py`.  It imports nothing outside this
directory, and no change to the program under test reaches it."""
