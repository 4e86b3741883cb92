"""roofline_pct.wiener: the least time of the Wiener chain's work that the
traced window completed, over the device's busy time in it (the union of
every kernel, copy and set, whatever its name), in %.

The work is the chain's function per 512-sample block, whatever implements
it (a frozen copy of ``utils/profiling.enhance_chain_roofline``): the
window, a forward and an inverse 1024-point real FFT at 2.5 N log2 N each,
|X| (4 a bin), the latch (3), the gain with its phase (8) over 513 bins, the
VAD (6) and the OLA with its store (2) per sample: 64,015 operations, held
to the int8 peak; and int16 in and out once, 2,048 bytes.  Bytes bound it:
0.611 ns a block on one H100 (NVIDIA's data sheet: 3.35 TB/s HBM3, 1,979
TOP/s int8)."""

BLOCK = 512
OPS_PER_BLOCK = 1024 + 2 * 2.5 * 1024 * 10 + (4 + 3 + 8) * 513 + (6 + 2) * 512  # 64,015
BYTES_PER_BLOCK = 2 * BLOCK * 2
HBM_BPS, INT8_OPS = 3.35e12, 1979e12


def least_s(samples):
    blocks = samples / BLOCK
    return blocks * max(BYTES_PER_BLOCK / HBM_BPS, OPS_PER_BLOCK / INT8_OPS)


def read(r):
    if r.samples <= 0 or r.trace.busy_s <= 0:
        return None
    return 100.0 * least_s(r.samples) / r.trace.busy_s
