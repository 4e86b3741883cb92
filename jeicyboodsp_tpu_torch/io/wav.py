"""Sample I/O matching the reference's L0 layer (numpy; counterpart of
``jeicyboodsp_tpu/io/wav.py``).

The reference programs read a WAV by skipping exactly 44 header bytes and
streaming raw int16 PCM, or read PCM from byte 0 (the Wiener program), and
write headerless PCM; :func:`write_wav` writes a 44-byte RIFF header first.
"""

from __future__ import annotations

import struct

import numpy as np

WAV_HEADER_LEN = 44


def read_wav_ref(path: str) -> np.ndarray:
    """Read int16 samples the way the reference does: skip 44 bytes, fread shorts."""
    with open(path, "rb") as f:
        f.seek(WAV_HEADER_LEN)
        data = f.read()
    return np.frombuffer(data[: len(data) // 2 * 2], dtype="<i2").copy()


def read_pcm16(path: str) -> np.ndarray:
    """Read headerless little-endian int16 PCM."""
    with open(path, "rb") as f:
        data = f.read()
    return np.frombuffer(data[: len(data) // 2 * 2], dtype="<i2").copy()


def stale_blocks(x, n: int) -> np.ndarray:
    """int16 samples -> (T, n) blocks as the reference's fread fills its
    buffer: a partial last block keeps the previous block's stale tail
    (zeros when there is no previous block)."""
    x = np.asarray(x, np.int16)
    T, rem = divmod(len(x), n)
    blocks = x[: T * n].reshape(T, n)
    if rem:
        stale = blocks[-1][rem:] if T else np.zeros(n - rem, np.int16)
        blocks = np.concatenate([blocks, np.concatenate([x[T * n:], stale])[None]])
    return blocks


def write_pcm16(path: str, samples: np.ndarray) -> None:
    np.asarray(samples, dtype="<i2").tofile(path)


def wav_header(num_samples: int, sample_rate: int, channels: int = 1, bits: int = 16) -> bytes:
    """RIFF/WAVE header, PCM fmt 16 (WienerFilter_final.cpp:237-258 layout)."""
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    data_size = num_samples * block_align
    return struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + data_size, b"WAVE", b"fmt ", 16,
                       1, channels, sample_rate, byte_rate, block_align, bits, b"data",
                       data_size)


def write_wav(path: str, samples: np.ndarray, sample_rate: int, channels: int = 1) -> None:
    samples = np.asarray(samples, dtype="<i2")
    with open(path, "wb") as f:
        f.write(wav_header(samples.size // channels, sample_rate, channels))
        samples.tofile(f)
