"""Host-level streaming sessions with checkpoint/resume (counterpart of
``jeicyboodsp_tpu/io/stream.py``).

The reference carries all streaming state in C ``static`` locals, so a
crashed run loses everything.  Here the state is explicit -- checkpoint =
carries + sample offset -- and each session's checkpoint keeps the JAX
package's npz keys and layouts, so it moves between the two packages:

- :class:`EnhanceSession`: the state dict of ``ops.enhance.stream_init_state``,
  saved with ``models.serialization.save_pytree``;
- :class:`GEQSession`: ``keep_in``/``keep_out`` (7, 2) int16, the native
  kernel's per-band input and output histories, oldest first;
- :class:`AECSession`: ``coeff`` and ``keep`` (and ``keep_ref`` for BNLMS),
  the native kernels' coefficients and last input (reference) samples.

The JAX package's GEQ and AEC sessions call its native C++ kernels; these run
the port's bit-exact kernels on one stream (B = 1): the GEQ through K6 in
f64 (``ops.geq.geq_apply``), NLMS through K8 (``ops.nlms.nlms_apply``),
BNLMS through its f64 FFT gate and K9 (``ops.nlms.bnlms_apply``).  Sessions
run on ``device``, a CUDA card unless the caller asks for the CPU.

While spans are recorded (``utils.metrics``), each chunk of an AEC or
enhancement session is a ``session.process`` span with the request id
(session serial, chunk number), holding ``session.chunk_in`` (copy), the
op's spans, ``session.drain`` (wait: the queued work, so that the copy
after it is the transfer alone; not after ``nlms_apply``, which leaves
nothing queued) and ``session.out`` (copy).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from jeicyboodsp_tpu_torch.models.serialization import load_pytree, save_pytree
from jeicyboodsp_tpu_torch.ops import enhance as E
from jeicyboodsp_tpu_torch.ops import geq as G
from jeicyboodsp_tpu_torch.ops import nlms as N
from jeicyboodsp_tpu_torch.utils.device import entry_device
from jeicyboodsp_tpu_torch.utils.metrics import REGISTRY

AEC_BLOCK = N.BLOCK_LEN
_SERIALS = itertools.count()  # each AEC or enhancement session's serial: its spans' request ids


def _int16(x) -> np.ndarray:
    return np.ascontiguousarray(x, np.int16)


class GEQSession:
    """Streaming compat GEQ (K6 in f64, bit-exact) with resume."""

    def __init__(self, gains_db=None, device="cuda"):
        self._dev = entry_device(device)
        self._b, self._a = G.calc_coefficients(gains_db=gains_db or G.GAINS_DB)
        self.state = G.init_state()  # the JAX op's {"xh", "yh"} (int32, on the CPU)

    @property
    def keep_in(self) -> np.ndarray:
        """(7, 2) int16: each band's input history, oldest first (band k > 0
        takes band k-1's output history)."""
        xh, yh = self.state["xh"].numpy(), self.state["yh"].numpy()
        return np.concatenate([xh[None], yh[:-1]]).astype(np.int16)

    @property
    def keep_out(self) -> np.ndarray:
        """(7, 2) int16: each band's output history, oldest first."""
        return self.state["yh"].numpy().astype(np.int16)

    def process(self, x) -> np.ndarray:
        x = _int16(x)
        if not len(x):
            return x.copy()
        y, self.state = G.geq_apply(torch.from_numpy(x).to(self._dev), self._b, self._a,
                                    self.state, dtype=torch.float64)
        return y.cpu().numpy()

    def checkpoint(self, path: str) -> None:
        np.savez(path, keep_in=self.keep_in, keep_out=self.keep_out)

    def restore(self, path: str) -> None:
        d = np.load(path)
        self.state = {"xh": torch.from_numpy(d["keep_in"][0].astype(np.int32)),
                      "yh": torch.from_numpy(d["keep_out"].astype(np.int32))}


class AECSession:
    """Streaming compat NLMS (K8) / BNLMS (K9), bit-exact, with resume."""

    def __init__(self, variant: str = "nlms", device="cuda"):
        if variant not in ("nlms", "bnlms"):
            raise ValueError(f"variant must be 'nlms' or 'bnlms', got {variant!r}")
        self.variant = variant
        self._dev = entry_device(device)
        self.state = N.nlms_init_state() if variant == "nlms" else N.bnlms_init_state()
        self._serial, self._chunks = next(_SERIALS), 0

    @property
    def coeff(self) -> np.ndarray:
        return self.state["coeff"].numpy()

    @property
    def keep(self) -> np.ndarray:
        """The last input samples, oldest first (255 for NLMS, 127 for BNLMS)."""
        return self.state["hist" if self.variant == "nlms" else "keep_in"].numpy().astype(np.int16)

    @property
    def keep_ref(self) -> np.ndarray:
        """BNLMS only: the last 127 reference samples, oldest first."""
        return self.state["keep_ref"].numpy().astype(np.int16)

    def process(self, x, ref):
        """Whole 1024-sample blocks of x (far end) and ref (near end) ->
        (est, err) int16."""
        x, ref = _int16(x), _int16(ref)
        if len(x) % AEC_BLOCK or len(x) != len(ref):
            raise ValueError(f"x and ref must be whole {AEC_BLOCK}-sample blocks of one length, "
                             f"got {len(x)} and {len(ref)}")
        if not len(x):
            return x.copy(), ref.copy()
        self._chunks += 1
        with REGISTRY.span("session.process", "stage", self._serial, self._chunks):
            with REGISTRY.span("session.chunk_in", "copy"):
                xt, rt = (torch.from_numpy(v).to(self._dev) for v in (x, ref))
            if self.variant == "nlms":  # drains its own queue before its state's copy
                est, err, self.state = N.nlms_apply(xt, rt, self.state)
            else:
                est, err, self.state = N.bnlms_apply(xt.view(-1, AEC_BLOCK),
                                                     rt.view(-1, AEC_BLOCK), self.state)
                REGISTRY.drain("session.drain", self._dev)
            with REGISTRY.span("session.out", "copy"):
                return est.reshape(-1).cpu().numpy(), err.reshape(-1).cpu().numpy()

    def checkpoint(self, path: str) -> None:
        state = {"coeff": self.coeff, "keep": self.keep}
        if self.variant != "nlms":
            state["keep_ref"] = self.keep_ref
        np.savez(path, **state)

    def restore(self, path: str) -> None:
        d = np.load(path)
        coeff = torch.from_numpy(d["coeff"].astype(np.float64))
        keep = torch.from_numpy(d["keep"].astype(np.int32))
        if self.variant == "nlms":
            self.state = {"hist": keep, "coeff": coeff}
        else:
            self.state = {"keep_in": keep, "coeff": coeff,
                          "keep_ref": torch.from_numpy(d["keep_ref"].astype(np.int32))}


class EnhanceSession:
    """Chunked Wiener / spectral-subtraction streaming with resume."""

    def __init__(self, mode: str = "wiener", dtype=None, device="cuda"):
        self._dev = entry_device(device)
        self._mode = mode
        self._dtype = dtype if dtype is not None else torch.float64
        self.state = E.stream_init_state(self._dtype, self._dev)
        self._serial, self._chunks = next(_SERIALS), 0

    def process(self, blocks) -> np.ndarray:
        """(Tc, 512) int16 in -> the written output samples out."""
        self._chunks += 1
        with REGISTRY.span("session.process", "stage", self._serial, self._chunks):
            with REGISTRY.span("session.chunk_in", "copy"):
                b = torch.from_numpy(_int16(blocks)).to(self._dev)
            out, mask, self.state = E.enhance_chunk(self.state, b, mode=self._mode,
                                                    dtype=self._dtype)
            REGISTRY.drain("session.drain", self._dev)
            with REGISTRY.span("session.out", "copy"):
                return out[mask].reshape(-1).cpu().numpy()

    def checkpoint(self, path: str, **extras) -> None:
        """Save the state's leaves (and ``extras`` beside them) to ``path``."""
        save_pytree(path, self.state, **extras)

    def restore(self, source) -> None:
        """Restore from a checkpoint path or an opened npz; a state of
        another dtype or shape than this session's raises ``ValueError``."""
        self.state = load_pytree(source, self.state)

    @property
    def sample_offset(self) -> int:
        return int(self.state["t"]) * E.BLOCK_LEN
