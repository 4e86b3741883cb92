"""The NLMS echo canceller: batches of two-track recordings through the
configuration's ``offline`` entry (``ops.nlms.nlms_apply``), live calls
through its ``live`` session (``io.stream.AECSession``).  Every session
starts from a fresh state: zero coefficients and history, in the entry's
state layout (``hist`` (B, 255) int32, ``coeff`` (B, 256) float64)."""

from __future__ import annotations

import numpy as np
import torch

from portbench import signals
from portbench.reference.nlms import KEEP, TAPS, nlms_sessions
from portbench.systems import Item, entry, given, kwargs, strata

BLOCK = 1024
CHECK_SESSIONS = 8  # sessions of each held call, or live streams, the reference follows


class System:
    def __init__(self, config, device):
        self.config, self.dev = config, torch.device(device)
        off, live = config["paths"]["offline"], config["paths"]["live"]
        self._offline, self._off_kw = entry(off["entry"]), kwargs(off["kwargs"])
        self._session, self._live_kw = entry(live["entry"]), kwargs(live["kwargs"])
        self._dtype = self._off_kw.get("dtype", torch.float64)

    # ------------------------------------------------------------ offline

    def make_items(self, traffic, gen):
        B = traffic["batch"]
        T = int(round(traffic["min_s"] * self.config["constants"]["rate_hz"] / BLOCK)) * BLOCK
        items = []
        for p in range(traffic["pool"]):
            x, r = signals.echo_streams(B, T, traffic["signal"], gen, self.dev)
            state = {"hist": torch.zeros(B, KEEP, dtype=torch.int32),
                     "coeff": torch.zeros(B, TAPS, dtype=self._dtype)}
            items.append(Item((x, r, state), B * T, f"batch {p}: {B} x {T}"))
        return items

    def call(self, item):
        return self._offline(*item.args, **self._off_kw)

    def judge_offline(self, held, seed, precision=None):
        """est, err, the coefficients and the history handed back, for
        ``CHECK_SESSIONS`` sessions of each held call, one from each stratum
        of its batch drawn from ``seed``, against the reference run from a
        fresh state; with ``precision``, the reference in that precision
        takes the program's place (the control)."""
        rng = np.random.default_rng(seed)
        picks = [strata(it.args[0].shape[0], CHECK_SESSIONS, rng) for it, _ in held]
        xs = np.concatenate([it.args[0][p].cpu().numpy() for (it, _), p in zip(held, picks)])
        rs = np.concatenate([it.args[1][p].cpu().numpy() for (it, _), p in zip(held, picks)])
        N = xs.shape[1]
        est, err, (coef,), hist = nlms_sessions(xs, rs, marks=[N])
        if precision is not None:
            ge, gr, (gc,), gh = nlms_sessions(xs, rs, np.dtype(precision).type, marks=[N])
        else:
            ge, gr, gc, gh = (np.concatenate(v) for v in zip(*[
                (o[0][p].cpu().numpy(), o[1][p].cpu().numpy(), o[2]["coeff"][p].numpy(),
                 o[2]["hist"][p].numpy().astype(np.int16)) for (_, o), p in zip(held, picks)]))
        return {"sample_mismatches": int((ge != est).sum() + (gr != err).sum()),
                "coeff_mismatches": int((gc.astype(np.float64) != coef).sum()),
                "hist_mismatches": int((gh != hist).sum())}

    # ------------------------------------------------------------ live

    def make_streams(self, traffic, n, samples, gen):
        """The calls' far and near ends, and the ``CHECK_SESSIONS`` calls the
        check follows, one from each stratum, drawn from ``gen`` before the
        window: only those keep their outputs."""
        x, r = signals.echo_streams(n, samples, traffic["signal"], gen, self.dev)
        draw = int(torch.randint(2 ** 62, (1,), generator=gen, device=self.dev))
        self._judged = strata(n, CHECK_SESSIONS, np.random.default_rng(draw))
        return {"x": x.cpu().numpy(), "r": r.cpu().numpy()}

    def open_session(self):
        return self._session(**self._live_kw, device=self.dev)

    def serve(self, session, streams, i, a, b):
        """Samples [a, b) of call i through its session.  For a call that the
        check follows: est, err and a copy of the coefficients handed back;
        None for the others, so that what a run holds stays small (held
        outputs of every call grew the heap by a gigabyte in the window)."""
        self._chunk = b - a
        est, err = session.process(streams["x"][i, a:b], streams["r"][i, a:b])
        if i not in self._judged:
            return None
        return est.copy(), err.copy(), session.state["coeff"].numpy().copy()

    def judge_live(self, streams, served, seed, precision=None):
        """The calls drawn in :meth:`make_streams`: est, err and the
        coefficients handed back after every chunk, against the reference
        over the samples each was given; with ``precision``, the reference in
        that precision takes the program's place (the control)."""
        pick = self._judged
        n = max(served[i][0] for i in pick)
        xs, rs = given(streams["x"][pick], n), given(streams["r"][pick], n)
        c = self._chunk
        marks = list(range(c, n + 1, c))
        est, err, snaps, _ = nlms_sessions(xs, rs, marks=marks)
        if precision is not None:
            e2, r2, s2, _ = nlms_sessions(xs, rs, np.dtype(precision).type, marks=marks)
        mism = cmis = missing = 0
        for row, i in enumerate(pick):
            n_given, outs = served[i]
            k = n_given // c
            if precision is not None:
                ge, gr, gc = e2[row, :n_given], r2[row, :n_given], [c[row] for c in s2[:k]]
            else:
                ge = np.concatenate([o[0] for o in outs]) if outs else np.zeros(0)
                gr = np.concatenate([o[1] for o in outs]) if outs else np.zeros(0)
                gc = [o[2] for o in outs]
            m = min(len(ge), n_given)
            missing += n_given - m
            mism += int((ge[:m] != est[row, :m]).sum() + (gr[:m] != err[row, :m]).sum())
            cmis += sum(int((c.astype(np.float64) != snaps[j][row]).sum())
                        for j, c in enumerate(gc[:k]))
            cmis += TAPS * max(0, k - len(gc))  # a chunk that handed back nothing
        return {"sample_mismatches": mism, "coeff_mismatches": cmis, "missing_samples": missing}
