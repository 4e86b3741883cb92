"""File-in/file-out pipelines of the port (counterpart of
``jeicyboodsp_tpu/pipelines/registry.py``).  Ported so far: the enhancement
chain (``wiener``, ``specsub``), the 7-band EQ (``geq``) and the echo
cancellers (``nlms``, ``bnlms``).  Each reads its inputs as the reference
program does:

- ``wiener``/``specsub`` read from byte 0: the reference never skips the
  44-byte header (WienerFilter_final.cpp:81 is commented out);
- ``geq`` skips the header (7Band_GEQ.cpp:116);
- ``nlms``/``bnlms`` skip the input's header but not the reference
  signal's (NormalLMS.cpp:65-66).

``kw`` is passed on to the op: ``device`` (a CUDA card by default; "cpu"
runs the plain versions) for all, ``fft_engine`` for the enhancement chain.
"""

from __future__ import annotations

from jeicyboodsp_tpu_torch.io.wav import read_pcm16, read_wav_ref, write_pcm16


def _read(path: str, skip_header: bool):
    return read_wav_ref(path) if skip_header else read_pcm16(path)


def geq(inp: str, out: str, **kw):
    """7Band_GEQ: header skipped.  kw: device, gains_db, compat."""
    from jeicyboodsp_tpu_torch.ops import geq as G

    y = G.run_quant(_read(inp, True), **kw)
    write_pcm16(out, y)
    return y


def wiener(inp: str, out: str, **kw):
    """Wiener NR: header NOT skipped.  kw: fft_engine, device."""
    from jeicyboodsp_tpu_torch.ops import enhance as E

    y = E.run_stream(_read(inp, False), "wiener", **kw)
    write_pcm16(out, y)
    return y


def specsub(inp: str, out: str, **kw):
    """Spectral subtraction: header NOT skipped.  kw: fft_engine, device."""
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


PIPELINES = {
    "geq": geq,
    "wiener": wiener,
    "specsub": specsub,
    "nlms": nlms,
    "bnlms": bnlms,
}
