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
f64 (``ops.geq.geq_apply``), NLMS through K8 (``ops.nlms.nlms_apply``; on a
card, K8 itself on the state the session keeps there), BNLMS through its f64
FFT gate and K9 (``ops.nlms.bnlms_apply``).  Sessions run on ``device``, a
CUDA card unless the caller asks for the CPU.

While spans are recorded (``utils.metrics``), each chunk of an AEC or
enhancement session is a ``session.process`` span with the request id
(session serial, chunk number), holding ``session.chunk_in`` (copy; a
``stage`` on a card route that stages the chunk, whose copy from pinned
memory does not block), the op's spans (``nlms.kernel`` alone on an NLMS
session's card route), ``session.drain`` (wait: the queued work, so that the
copy after it is the transfer alone; not after ``nlms_apply``, which leaves
nothing queued) and ``session.out`` (copy).  An NLMS card session's state
crosses the bus in a ``session.state`` copy span of the same request id,
outside ``session.process`` where it is read or assigned between chunks.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from jeicyboodsp_tpu_torch.kernels import _build
from jeicyboodsp_tpu_torch.kernels import nlms as K8
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
    """Streaming compat NLMS (K8) / BNLMS (K9), bit-exact, with resume.

    ``state`` is the JAX op's dict on the CPU (NLMS: ``hist`` (255,) int32
    and ``coeff`` (256,) float64; BNLMS: ``keep_in``, ``keep_ref``,
    ``coeff``); the getter hands back copies the caller may keep or change,
    and an assignment takes a copy (None releases the state).  ``coeff``,
    ``keep``, ``checkpoint`` and ``restore`` go through them.

    An ``nlms`` session on a CUDA card keeps its state on the card instead,
    in K8's layout (:class:`_K8State`): a chunk is one copy in from pinned
    memory (x and ref as the two rows of one buffer, :class:`_Staging`), K8
    and one copy of est and err into pinned memory, which syncs; each such
    chunk counted as ``session.staged`` in ``REGISTRY``.  Its ``state``
    getter reads the card at most once a chunk served, counted as
    ``session.state_reads``.  Every other session runs ``nlms_apply`` /
    ``bnlms_apply`` on its state on the host.
    """

    def __init__(self, variant: str = "nlms", device="cuda"):
        if variant not in ("nlms", "bnlms"):
            raise ValueError(f"variant must be 'nlms' or 'bnlms', got {variant!r}")
        self.variant = variant
        self._dev = entry_device(device)
        self._serial, self._chunks = next(_SERIALS), 0
        resident = variant == "nlms" and self._dev.type == "cuda"
        self._card = _K8State(self._dev) if resident else None
        self._staging = _Staging(self._dev, card_out=True) if resident else None
        self._host = None  # the state on the host; None while only the card holds it
        self.state = N.nlms_init_state() if variant == "nlms" else N.bnlms_init_state()

    @property
    def state(self) -> dict | None:
        if self._host is None and self._card is not None:
            REGISTRY.count("session.state_reads")
            with REGISTRY.span("session.state", "copy", self._serial, self._chunks):
                self._host = self._card.read()
        return None if self._host is None else {k: v.clone() for k, v in self._host.items()}

    @state.setter
    def state(self, state: dict | None) -> None:
        if state is None:  # released, with the card's buffers: the session serves no more
            self._card = self._staging = self._host = None
        elif self._card is None:
            self._host = {k: torch.as_tensor(v).clone() for k, v in state.items()}
        else:
            with REGISTRY.span("session.state", "copy", self._serial, self._chunks):
                self._host = self._card.write(state)

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
            if self._card is not None:
                return self._process_on_card(x, ref)
            with REGISTRY.span("session.chunk_in", "copy"):
                xt, rt = (torch.from_numpy(v).to(self._dev) for v in (x, ref))
            if self.variant == "nlms":  # drains its own queue before its state's copy
                est, err, self._host = N.nlms_apply(xt, rt, self._host)
            else:
                est, err, self._host = N.bnlms_apply(xt.view(-1, AEC_BLOCK),
                                                     rt.view(-1, AEC_BLOCK), self._host)
                REGISTRY.drain("session.drain", self._dev)
            with REGISTRY.span("session.out", "copy"):
                return est.reshape(-1).cpu().numpy(), err.reshape(-1).cpu().numpy()

    def _process_on_card(self, x, ref):
        """The card route's chunk: x and ref staged as the rows of one pinned
        buffer, K8 on the resident state, est and err back as the two rows
        of another; the arrays returned are the caller's own."""
        staging = self._staging
        with REGISTRY.span("session.chunk_in", "stage"):
            rows = staging.copy_in(x, ref)
        with REGISTRY.span("nlms.kernel"):
            self._card.step(rows, staging.card_out)
        self._host = None
        REGISTRY.drain("session.drain", self._dev)
        with REGISTRY.span("session.out", "copy"):
            REGISTRY.count("session.staged")
            y = staging.copy_out(staging.card_out, 0)
        return y[:len(x)], y[len(x):]

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


class _K8State:
    """One NLMS stream's state resident on a CUDA card, in K8's layout: two
    slots that the chunks use in turn (K8 reads one and writes the other
    through its separate in and out pointers, so a chunk allocates
    nothing), each ``coef`` (256,) float64 and after it ``hist`` (255,)
    int16; and one pinned slot through which the state crosses the bus in
    one copy.  Each copy blocks, so the pinned slot is free after it."""

    HIST = K8.TAPS * 8  # hist's byte offset in a slot
    SLOT = HIST + 2 * K8.KEEP + 2  # padded to keep the next slot's coef 8-byte aligned

    def __init__(self, device):
        self._dev, self._cur = device, 0
        self._slots = torch.empty(2, self.SLOT, dtype=torch.uint8, device=device)
        self._pinned = torch.empty(self.SLOT, dtype=torch.uint8, pin_memory=True)
        self._coef = self._pinned[:self.HIST].view(torch.float64)
        self._hist = self._pinned[self.HIST:self.HIST + 2 * K8.KEEP].view(torch.int16)
        base = self._slots.data_ptr()
        self._ptrs = [(base + i * self.SLOT, base + i * self.SLOT + self.HIST) for i in (0, 1)]

    def _as_jax(self) -> dict:
        return {"hist": self._hist.to(torch.int32), "coeff": self._coef.clone()}

    def read(self) -> dict:
        """The current slot as the JAX op's dict on the CPU."""
        self._pinned.copy_(self._slots[self._cur])
        return self._as_jax()

    def write(self, state: dict) -> dict:
        """Put a JAX-layout dict into the current slot; what the slot now
        holds, as :meth:`read` would give it."""
        coeff = torch.as_tensor(state["coeff"])
        if coeff.dtype != torch.float64:
            raise ValueError(f"the state's coefficients are {coeff.dtype}, the session's float64")
        self._coef.copy_(coeff.reshape(K8.TAPS))
        self._hist.copy_(torch.as_tensor(state["hist"]).reshape(K8.KEEP))
        self._slots[self._cur].copy_(self._pinned)
        return self._as_jax()

    def step(self, rows: torch.Tensor, out: torch.Tensor) -> None:
        """Enqueue K8 over one chunk: x and ref the two rows of ``rows``,
        est and err into the two rows of ``out`` (each (2, n) int16 on the
        card), from the current slot into the other, which becomes current.
        Counted in ``K8.nlms.launches``."""
        n, xr, yr = rows.shape[1], rows.data_ptr(), out.data_ptr()
        cur = self._cur
        _build.launch("jb_nlms", self._dev, xr, xr + 2 * n, *self._ptrs[cur], yr, yr + 2 * n,
                      *self._ptrs[1 - cur], 1, n, 1)
        K8.nlms.launches += 1
        self._cur = 1 - cur


class EnhanceSession:
    """Chunked Wiener / spectral-subtraction streaming with resume.

    A chunk writes its rows whose global block index ``t + row`` is 2 or
    more (``enhance_chunk``'s mask): a suffix of the chunk, which the session
    finds from a host mirror of ``state["t"]``.  The mirror holds while
    ``state["t"]`` is the tensor the last chunk left (or the fresh state's);
    any other state -- a ``restore``, an assignment to ``state`` -- has its
    ``t`` read once, counted as ``session.t_reads`` in ``REGISTRY``.

    On a CUDA card a chunk is one copy in from pinned memory, the op, one
    copy of the written rows into pinned memory and one stream sync (each
    such chunk counted as ``session.staged``; :class:`_Staging`).  The
    returned array is a copy, the caller's own.
    """

    def __init__(self, mode: str = "wiener", dtype=None, device="cuda"):
        self._dev = entry_device(device)
        self._mode = mode
        self._dtype = dtype if dtype is not None else torch.float64
        self.state = E.stream_init_state(self._dtype, self._dev)
        self._t_leaf, self._t = self.state["t"], 0  # the mirror, and the leaf it mirrors
        self._staging = _Staging(self._dev) if self._dev.type == "cuda" else None
        self._serial, self._chunks = next(_SERIALS), 0

    def _t0(self) -> int:
        """``state["t"]``: the mirror's, or read once from a state it does
        not mirror."""
        t = self.state["t"]
        if t is not self._t_leaf:
            REGISTRY.count("session.t_reads")
            with REGISTRY.span("session.t", "copy"):
                self._t_leaf, self._t = t, int(t)
        return self._t

    def process(self, blocks) -> np.ndarray:
        """(Tc, 512) int16 in -> the written output samples out."""
        blocks = _int16(blocks)
        staging = self._staging
        self._chunks += 1
        with REGISTRY.span("session.process", "stage", self._serial, self._chunks):
            t0 = self._t0()
            with REGISTRY.span("session.chunk_in", "copy" if staging is None else "stage"):
                b = (torch.from_numpy(blocks).to(self._dev) if staging is None
                     else staging.copy_in(blocks))
            out, _, state = E.enhance_chunk(self.state, b, mode=self._mode, dtype=self._dtype)
            first = min(len(blocks), max(0, 2 - t0))
            REGISTRY.drain("session.drain", self._dev)
            with REGISTRY.span("session.out", "copy"):
                if staging is None:
                    y = out[first:].reshape(-1).numpy()
                else:
                    REGISTRY.count("session.staged")
                    y = staging.copy_out(out, first)
        self.state, self._t_leaf, self._t = state, state["t"], t0 + len(blocks)
        return y

    def checkpoint(self, path: str, **extras) -> None:
        """Save the state's leaves (and ``extras`` beside them) to ``path``."""
        save_pytree(path, self.state, **extras)

    def restore(self, source) -> None:
        """Restore from a checkpoint path or an opened npz; a state of
        another dtype or shape than this session's raises ``ValueError``."""
        self.state = load_pytree(source, self.state)

    @property
    def sample_offset(self) -> int:
        return self._t0() * E.BLOCK_LEN


class _Staging:
    """A CUDA session's int16 buffers: the chunk in pinned memory and on the
    card, and its output in pinned memory (and, with ``card_out``, a card
    buffer of the chunk's shape for the session's kernel to write it into).
    They grow to the largest chunk served; their views for the last chunk's
    shape are kept, so that a chunk of that shape makes no tensor op but
    its two copies.  Every chunk ends with the stream's sync, so the next
    may overwrite them."""

    def __init__(self, device, card_out: bool = False):
        self._dev, self._size, self.shape, self._card_out = device, 0, None, card_out

    def _fit(self, shape):
        n = math.prod(shape)
        if self.shape is None or n > self._size:
            self._size = n
            pinned = lambda: torch.empty(n, dtype=torch.int16, pin_memory=True)  # noqa: E731
            card = lambda: torch.empty(n, dtype=torch.int16, device=self._dev)  # noqa: E731
            self._bufs = (pinned(), card(), pinned()) + ((card(),) if self._card_out else ())
        self.shape = shape
        views = [b[:n].view(shape) for b in self._bufs]
        self.host_in, self.card_in, self.host_out = views[:3]
        self.card_out = views[3] if self._card_out else None
        self.in_np, self.out_np = self.host_in.numpy(), self.host_out.numpy()

    def copy_in(self, *rows: np.ndarray) -> torch.Tensor:
        """The chunk on the card: one array, or arrays of one shape as the
        rows of one, copied into pinned memory, and from there by a copy the
        stream runs in its turn."""
        shape = rows[0].shape if len(rows) == 1 else (len(rows), *rows[0].shape)
        if shape != self.shape:
            self._fit(shape)
        for dst, src in zip((self.in_np,) if len(rows) == 1 else self.in_np, rows):
            np.copyto(dst, src)
        return self.card_in.copy_(self.host_in, non_blocking=True)

    def copy_out(self, out: torch.Tensor, first: int) -> np.ndarray:
        """Rows ``first:`` of the chunk's ``out`` -> a host array of the
        caller's own: one copy and the stream's sync (the sync alone when no
        row is written)."""
        if first == len(self.out_np):
            torch.cuda.current_stream(self._dev).synchronize()
        elif first:
            self.host_out[first:].copy_(out[first:])
        else:
            self.host_out.copy_(out)  # blocking: the copy, then the stream's sync
        return self.out_np[first:].flatten()
