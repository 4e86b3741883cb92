"""File-in/file-out pipelines of the port (counterpart of
``jeicyboodsp_tpu/pipelines/registry.py``).  Ported so far: the enhancement
chain, ``wiener`` and ``specsub``.  Both read the input from byte 0: the
reference never skips the 44-byte header (WienerFilter_final.cpp:81 is
commented out).  ``kw``: ``fft_engine`` (mxu8f, mxu8t, mxu8, mxu3) and
``device`` (a CUDA card by default; "cpu" runs the plain versions), as
:func:`jeicyboodsp_tpu_torch.ops.enhance.run_stream` takes them."""

from __future__ import annotations

from jeicyboodsp_tpu_torch.io.wav import read_pcm16, write_pcm16
from jeicyboodsp_tpu_torch.ops import enhance as E


def wiener(inp: str, out: str, **kw):
    """Wiener NR: header NOT skipped.  kw: fft_engine, device."""
    y = E.run_stream(read_pcm16(inp), "wiener", **kw)
    write_pcm16(out, y)
    return y


def specsub(inp: str, out: str, **kw):
    """Spectral subtraction: header NOT skipped.  kw: fft_engine, device."""
    y = E.run_stream(read_pcm16(inp), "specsub", **kw)
    write_pcm16(out, y)
    return y


PIPELINES = {
    "wiener": wiener,
    "specsub": specsub,
}
