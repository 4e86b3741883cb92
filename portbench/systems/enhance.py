"""The Wiener / spectral-subtraction suppressor: recordings through the
configuration's ``offline`` entry (``ops.enhance.enhance_blocks``), live
streams through its ``live`` session (``io.stream.EnhanceSession``)."""

from __future__ import annotations

import numpy as np
import torch

from portbench import signals
from portbench.reference.enhance import reference_enhance_rows
from portbench.systems import Item, entry, given, kwargs

BLOCK = 512


def _lengths(traffic, rate):
    """The pool's lengths in samples, whole blocks: ``pool`` quantiles of
    the log-uniform law on [min_s, max_s] seconds, the same for every seed."""
    lo, hi, n = traffic["min_s"], traffic["max_s"], traffic["pool"]
    secs = lo * (hi / lo) ** ((np.arange(n) + 0.5) / n)
    return [int(round(s * rate / BLOCK)) * BLOCK for s in secs]


def _snr_db(ref, got):
    ref, got = ref.to(torch.float64), got.to(torch.float64)
    err = float(((ref - got) ** 2).sum())
    sig = float((ref ** 2).sum())
    return 10 * np.log10(sig / err) if err > 0 else 999.0  # 999: no sample differs


class System:
    def __init__(self, config, device):
        self.config, self.dev = config, torch.device(device)
        self.rate = config["constants"]["rate_hz"]
        off, live = config["paths"]["offline"], config["paths"]["live"]
        self._offline, self._off_kw = entry(off["entry"]), kwargs(off["kwargs"])
        self._session, self._live_kw = entry(live["entry"]), kwargs(live["kwargs"])
        self.mode = self._off_kw.get("mode", "wiener")

    # ------------------------------------------------------------ offline

    def make_items(self, traffic, gen):
        x = signals.gated_tones(_lengths(traffic, self.rate), self.rate, traffic["signal"], gen,
                                self.dev)
        return [Item((v.view(-1, BLOCK),), len(v), f"{len(v) // BLOCK} blocks") for v in x]

    def call(self, item):
        return self._offline(*item.args, **self._off_kw)

    def judge_offline(self, held, seed, precision=None):
        """Each held call's written rows (t >= 2) and write mask against the
        reference over the same blocks, on the card; with ``precision``, the
        reference in that precision takes the program's place (the control)."""
        snr, worst, masks = [], 0, 0
        for it, (out, mask) in held:
            blocks = it.args[0]
            want = torch.arange(blocks.shape[0], device=blocks.device) >= 2
            if precision is not None:
                out, mask = None, want
                got = reference_enhance_rows(blocks, self.mode, precision)
            else:
                got = out[2:]
            ref = reference_enhance_rows(blocks, self.mode)
            snr.append(_snr_db(ref, got))
            worst = max(worst, int((ref.to(torch.int32) - got.to(torch.int32)).abs().max()))
            masks += int((mask.to(torch.bool) != want).sum())
        return {"snr_db_min": min(snr), "max_abs_lsb": worst, "mask_mismatches": masks,
                "snr_db_each": snr}

    # ------------------------------------------------------------ live

    def make_streams(self, traffic, n, samples, gen):
        x = signals.gated_tones([samples] * n, self.rate, traffic["signal"], gen, self.dev)
        return {"x": torch.stack(x).cpu().numpy()}

    def open_session(self):
        return self._session(**self._live_kw, device=self.dev)

    def serve(self, session, streams, i, a, b):
        """Samples [a, b) of stream i through its session: the written
        samples (an array, which the collector does not track)."""
        return session.process(streams["x"][i, a:b].reshape(-1, BLOCK))

    def judge_live(self, streams, served, seed, precision=None):
        """Each stream's written output so far against the reference over the
        samples it was given, on the host (PyTorch's CPU FFT, not the
        card's); with ``precision``, the reference in that precision takes
        the program's place (the control)."""
        worst, off, total, missing = 0, 0, 0, 0
        for i, (n, outs) in sorted(served.items()):
            blocks = torch.from_numpy(given(streams["x"][i], n)).view(-1, BLOCK)
            ref = reference_enhance_rows(blocks, self.mode).reshape(-1).numpy().astype(np.int64)
            if precision is not None:
                g = reference_enhance_rows(blocks, self.mode, precision).reshape(-1).numpy()
            else:
                g = np.concatenate(outs) if outs else np.zeros(0, np.int16)
            g = g.astype(np.int64)
            m = min(len(ref), len(g))
            missing += abs(len(ref) - len(g))
            d = np.abs(ref[:m] - g[:m])
            worst = max(worst, int(d.max()) if m else 0)
            off += int((d != 0).sum())
            total += len(ref)
        return {"max_abs_lsb": worst, "differing_ppm": 1e6 * off / max(total, 1),
                "missing_samples": missing}
