"""Operations and bytes of each network and kernel, from shapes alone.

The counts read the same work whatever implements it: they come from the
published architectures and the call's shapes, never from which kernels a
run picked.  An FFT or Winograd convolution does fewer operations than
counted, so a share of a peak built on them is a counted share.
"""

#: One NVIDIA H100 SXM, NVIDIA's data sheet: dense float32 outside the
#: tensor cores, and HBM3 bandwidth.  Both assume the 700 W power limit.
PEAK_F32_FLOP_PER_S = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
