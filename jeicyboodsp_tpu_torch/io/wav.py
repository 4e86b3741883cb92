"""Sample I/O matching the reference's L0 layer (numpy).

The reference programs read a WAV by skipping exactly 44 header bytes and
streaming raw int16 PCM, or read PCM from byte 0 (the Wiener program), and
write headerless PCM.
"""

from __future__ import annotations

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
