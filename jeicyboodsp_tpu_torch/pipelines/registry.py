"""File-in/file-out pipelines of the port (counterpart of
``jeicyboodsp_tpu/pipelines/registry.py``).  Ported so far: the enhancement
chain (``wiener``, ``specsub``) and its resumable streaming form
(``stream``), the 7-band EQ (``geq``), the echo cancellers (``nlms``,
``bnlms``), pitch (``pitch1``-``pitch3``), corpus MFCC (``mfcc``), the RIR
fast convolution (``fastconv``), the FFT roundtrip program (``fft``) and the
2-mic MVDR beamformer (``mvdr``).  Each reads its inputs as the reference
program does:

- ``wiener``/``specsub``/``stream`` read from byte 0: the reference never
  skips the 44-byte header (WienerFilter_final.cpp:81 is commented out);
- ``geq`` skips the header (7Band_GEQ.cpp:116);
- ``nlms``/``bnlms`` skip the input's header but not the reference
  signal's (NormalLMS.cpp:65-66);
- ``pitch*``, ``mfcc``, ``fastconv``, ``fft`` and both ``mvdr`` inputs skip
  the header.

``kw`` is passed on to the op: ``device`` (a CUDA card by default; "cpu"
runs the plain versions) for all, ``fft_engine`` for the enhancement chain,
pitch, MFCC, fastconv and MVDR, ``dtype`` for the enhancement chain and its
stream, the GEQ, pitch, MFCC, fastconv, fft and MVDR, ``use_assoc_scan`` for
the enhancement chain, ``verbose`` for fft, ``d_time`` and ``collapse`` for
MVDR; ``stream`` takes its checkpoint arguments by name.
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


def mvdr(left: str, right: str, out: str, **kw):
    """MVDR beamformer: both headers skipped (BeamForming_MVDR_ver1.cpp:
    81-82).  kw: d_time, dtype, fft_engine, collapse, device (float64
    ``xla`` by default, the compat contract)."""
    from jeicyboodsp_tpu_torch.ops import mvdr as M

    y = M.run_stream(_read(left, True), _read(right, True), **kw)
    write_pcm16(out, y)
    return y


def stream_enhance(inp: str, out: str, mode: str = "wiener", ckpt: str | None = None,
                   ckpt_every: int = 4, chunk_blocks: int = 4,
                   crash_after_chunks: int | None = None, dtype=None, device="cuda"):
    """Resumable block-streaming enhancement at the file surface: a killed
    run resumes from its last checkpoint and its output is byte-identical to
    an uninterrupted run.

    The checkpoint is one atomically replaced npz holding the session state's
    leaves (``leaf_{i}``, as ``save_pytree`` orders them), the next ``block``
    and the output's byte count ``out_bytes``, the JAX package's layout, so
    either package finishes the other's run.  The output is fsync'd before
    the checkpoint is replaced, so a checkpoint never counts bytes that could
    be lost; a kill between the two reprocesses deterministically from the
    previous checkpoint.  An output shorter than the checkpoint says (deleted,
    or a stale ``ckpt``) restarts from block 0.

    The input is read from byte 0, as ``wiener`` reads it, and a partial
    final block is dropped, as the JAX ``stream`` drops it (``wiener`` keeps
    it with the previous block's stale tail; ROADMAP R12).
    ``crash_after_chunks`` is the fault injector: ``os._exit(137)`` (no
    flush, no atexit; a SIGKILL stand-in) after that many chunks.  kw:
    ``dtype`` (float64 by default; float32 is ``--fast``), ``device``.
    """
    import os

    from jeicyboodsp_tpu_torch.io.stream import EnhanceSession

    x = read_pcm16(inp)
    nblocks = len(x) // 512
    blocks = x[: nblocks * 512].reshape(-1, 512)
    sess = EnhanceSession(mode, dtype=dtype, device=device)

    start_block, out_bytes = 0, 0
    if ckpt and os.path.exists(ckpt):
        data = np.load(ckpt)
        block_ck, bytes_ck = int(data["block"]), int(data["out_bytes"])
        if os.path.exists(out) and os.path.getsize(out) >= bytes_ck:
            sess.restore(data)
            start_block, out_bytes = block_ck, bytes_ck

    with open(out, "r+b" if (out_bytes and os.path.exists(out)) else "wb") as f:
        f.truncate(out_bytes)
        f.seek(out_bytes)
        chunks_done = 0
        for s in range(start_block, nblocks, chunk_blocks):
            f.write(np.asarray(sess.process(blocks[s: s + chunk_blocks]), "<i2").tobytes())
            chunks_done += 1
            if ckpt and chunks_done % ckpt_every == 0:
                f.flush()
                os.fsync(f.fileno())
                tmp = ckpt + ".tmp.npz"
                sess.checkpoint(tmp, block=s + chunk_blocks, out_bytes=f.tell())
                os.replace(tmp, ckpt)
            if crash_after_chunks is not None and chunks_done >= int(crash_after_chunks):
                os._exit(137)  # fault injection: no flush, no atexit
    return out


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
    "mvdr": mvdr,
    "stream": stream_enhance,
}
