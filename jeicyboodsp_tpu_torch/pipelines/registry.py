"""File-in/file-out pipelines of the port (counterpart of
``jeicyboodsp_tpu/pipelines/registry.py``).  Ported so far: the enhancement
chain (``wiener``, ``specsub``), the 7-band EQ (``geq``), the echo
cancellers (``nlms``, ``bnlms``), pitch (``pitch1``-``pitch3``), corpus
MFCC (``mfcc``), the RIR fast convolution (``fastconv``) and the FFT
roundtrip program (``fft``).  Each reads its inputs as the reference
program does:

- ``wiener``/``specsub`` read from byte 0: the reference never skips the
  44-byte header (WienerFilter_final.cpp:81 is commented out);
- ``geq`` skips the header (7Band_GEQ.cpp:116);
- ``nlms``/``bnlms`` skip the input's header but not the reference
  signal's (NormalLMS.cpp:65-66);
- ``pitch*``, ``mfcc``, ``fastconv`` and ``fft`` skip the header.

``kw`` is passed on to the op: ``device`` (a CUDA card by default; "cpu"
runs the plain versions) for all, ``fft_engine`` for the enhancement chain,
pitch, MFCC and fastconv, ``dtype`` for the enhancement chain, the GEQ,
pitch, MFCC, fastconv and fft, ``use_assoc_scan`` for the enhancement chain, ``verbose``
for fft.
"""

from __future__ import annotations

import numpy as np

from jeicyboodsp_tpu_torch.io.wav import read_pcm16, read_wav_ref, write_pcm16


def _read(path: str, skip_header: bool):
    return read_wav_ref(path) if skip_header else read_pcm16(path)


def geq(inp: str, out: str, **kw):
    """7Band_GEQ: header skipped.  kw: device, gains_db, compat, dtype
    (float64 by default, the reference's numbers; float32 is ``--fast``)."""
    from jeicyboodsp_tpu_torch.ops import geq as G

    y = G.run_quant(_read(inp, True), **kw)
    write_pcm16(out, y)
    return y


def wiener(inp: str, out: str, **kw):
    """Wiener NR: header NOT skipped.  kw: dtype, use_assoc_scan, fft_engine,
    device (float64 ``xla`` by default, the compat contract)."""
    from jeicyboodsp_tpu_torch.ops import enhance as E

    y = E.run_stream(_read(inp, False), "wiener", **kw)
    write_pcm16(out, y)
    return y


def specsub(inp: str, out: str, **kw):
    """Spectral subtraction: header NOT skipped.  kw: as :func:`wiener`."""
    from jeicyboodsp_tpu_torch.ops import enhance as E

    y = E.run_stream(_read(inp, False), "specsub", **kw)
    write_pcm16(out, y)
    return y


def nlms(inp: str, ref: str, est_out: str, err_out: str, **kw):
    """NLMS AEC: input header skipped, reference NOT.  kw: device, compat."""
    from jeicyboodsp_tpu_torch.ops import nlms as N

    est, err = N.run_nlms_stream(_read(inp, True), _read(ref, False), **kw)
    write_pcm16(est_out, est)
    write_pcm16(err_out, err)
    return est, err


def bnlms(inp: str, ref: str, est_out: str, err_out: str, **kw):
    """Block NLMS AEC: input header skipped, reference NOT.  kw: device."""
    from jeicyboodsp_tpu_torch.ops import nlms as N

    est, err = N.run_bnlms_stream(_read(inp, True), _read(ref, False), **kw)
    write_pcm16(est_out, est)
    write_pcm16(err_out, err)
    return est, err


def pitch(inp: str, method: int = 1, **kw):
    """Print-only in the reference: one line per 512-sample block, as the JAX
    pipeline prints it.  kw: dtype, fft_engine, device."""
    from jeicyboodsp_tpu_torch.ops import features as FE

    args, vals, f0s = FE.pitch_run(_read(inp, True), method=method, **kw)
    for a, v, f in zip(args, vals, f0s):  # numpy scalars, printed as the JAX pipeline's
        print(f"Estimation arg {a} , value {v} pitch {f}")
    return args, vals, f0s


def mfcc(list_file: str, **kw):
    """Corpus MFCC from an 'input output' list file: headers skipped (:83),
    the first frame of the run skipped (:95-97), features written as
    little-endian f64.  kw: dtype, fft_engine, device."""
    from jeicyboodsp_tpu_torch.ops import features as FE

    first = True
    with open(list_file) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 2:
                continue
            src, dst = parts
            feats = FE.mfcc_run(_read(src, True), skip_first=first, **kw)
            first = False
            np.asarray(feats, dtype="<f8").tofile(dst)


def fastconv(inp: str, out: str, **kw):
    """3D-audio RIR convolution: header skipped (:79).  kw: dtype,
    real_fft, fft_engine, device."""
    from jeicyboodsp_tpu_torch.ops import fastconv as FC

    y = FC.run_stream(_read(inp, True), **kw)
    write_pcm16(out, y)
    return y


def fft_roundtrip(inp: str, out: str, verbose: bool = False, **kw):
    """FFT roundtrip program: header skipped.  With ``verbose`` the
    reference's print surface: its operation counter after every FFT call,
    forward and inverse, so twice per block, then the stream-end lines
    (FFTAlgorithm_ver2.cpp:64-66, 87, 148).  kw: dtype, device."""
    import sys

    from jeicyboodsp_tpu_torch.ops import fft as F

    y = F.run_stream(_read(inp, True), **kw)
    if verbose:
        add, mul = F.fft_op_counts(F.BLOCK_LEN)
        line = "%d-point FFT Calculation add %d multiply %d \n " % (F.BLOCK_LEN, add, mul)
        for _ in range(len(y) // F.BLOCK_LEN):
            sys.stdout.write(line)
            sys.stdout.write(line)
        sys.stdout.write("Break! The buffer is insufficient.\n")
        sys.stdout.write("Processing End\n")
    write_pcm16(out, y)
    return y


PIPELINES = {
    "geq": geq,
    "wiener": wiener,
    "specsub": specsub,
    "nlms": nlms,
    "bnlms": bnlms,
    "pitch1": lambda inp, **kw: pitch(inp, 1, **kw),
    "pitch2": lambda inp, **kw: pitch(inp, 2, **kw),
    "pitch3": lambda inp, **kw: pitch(inp, 3, **kw),
    "mfcc": mfcc,
    "fastconv": fastconv,
    "fft": fft_roundtrip,
}
