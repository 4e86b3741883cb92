"""roofline_pct.nlms: the least time of the NLMS work that the traced
window completed, over the device's busy time in it (the union of every
kernel, copy and set), in %.

The work per sample of a stream is the recursion's function in f64, as
its bit-exact contract fixes it (a frozen copy of
``utils/profiling.nlms_roofline``): the estimate's 256 products and 255
sums, the window energy and divisor (5), the update ``2.0 * u * MU * e / d
+ c`` per tap (5 x 256): 1,796 operations at the f64 peak; x and ref in,
est and err out as int16, 8 bytes.  Operations bound it: 52.8 ps a sample
on one H100 (NVIDIA's data sheet: 34 TFLOP/s f64, 3.35 TB/s HBM3)."""

TAPS = 256
OPS_PER_SAMPLE = (2 * TAPS - 1) + 5 + 5 * TAPS  # 1,796
BYTES_PER_SAMPLE = 4 * 2
HBM_BPS, F64_OPS = 3.35e12, 34e12


def least_s(samples):
    return samples * max(BYTES_PER_SAMPLE / HBM_BPS, OPS_PER_SAMPLE / F64_OPS)


def read(r):
    if r.samples <= 0 or r.trace.busy_s <= 0:
        return None
    return 100.0 * least_s(r.samples) / r.trace.busy_s
