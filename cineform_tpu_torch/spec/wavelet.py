"""2-6 wavelet filter contract.

The CineForm codec uses a "2-6" biorthogonal integer wavelet: a 2-tap Haar
lowpass (sum, no shift on the forward transform) and a 6-tap highpass whose
interior form reduces to a difference of neighboring lowpass sums.  Border
rows/columns use asymmetric 6-tap filters.  All arithmetic is 32-bit integer
with arithmetic right shifts; the rounding constant is 4 and the filter shift
is 3 (divide by 8).

Behavioral contract (scalar model): reference `Example/WaveletDemo/utils.c`
  - forward lowpass   `utils.c:263,270,275`:  low[k]  = x[2k] + x[2k+1]
  - forward highpass interior `utils.c:271`:
        high[k] = ((-x[2k-2]-x[2k-1]+x[2k+2]+x[2k+3] + 4) >> 3) + x[2k]-x[2k+1]
                = ((low[k-1] - low[k+1] ... sign note below) ...)
      in lowpass terms: ((-low[k-1] + low[k+1] + 4) >> 3) + (x[2k] - x[2k+1])
  - forward highpass first edge `utils.c:264-266`:
        (5*x0 - 11*x1 + 4*x2 + 4*x3 - 1*x4 - 1*x5 + 4) >> 3
  - forward highpass last edge `utils.c:276-278`:
        (11*x[n-2] - 5*x[n-1] - 4*x[n-3] - 4*x[n-4] + x[n-5] + x[n-6] + 4) >> 3
  - inverse (utils.c:285-311): reconstruct even/odd with
        interior: even = (((L[k-1]-L[k+1]+4)>>3) + L[k] + H[k]) >> 1
                  odd  = (((-L[k-1]+L[k+1]+4)>>3) + L[k] - H[k]) >> 1
        first:    even = (((11*L0 - 4*L1 + L2 + 4)>>3) + H0) >> 1
                  odd  = ((( 5*L0 + 4*L1 - L2 + 4)>>3) - H0) >> 1
        last:     even = ((( 5*Ln + 4*L[n-1] - L[n-2] + 4)>>3) + Hn) >> 1
                  odd  = (((11*Ln - 4*L[n-1] + L[n-2] + 4)>>3) - Hn) >> 1

The production codec implements the identical math as fused SSE2 row/column
kernels (`Codec/spatial.c:253` FilterHorizontalRow16s, border coefficient
comments at `Codec/spatial.c:277-286`).

The 2-2 (Haar) temporal/interlaced variant (`utils.c:210-247`,
`Codec/temporal.c:71`):
    forward: low = a + b ; high = a - b
    inverse: a = (low + high) >> 1 ; b = (low - high) >> 1
"""

# Rounding constant added before the >>3 in all 6-tap filter expressions
# (`Example/WaveletDemo/utils.c:249`, `Codec/spatial.c` uses the same).
# The filters' taps live in `ops/dwt.py`, which is all that reads this
# module.
ROUNDING = 4
