"""The reference contracts, checked through the port's entry points on a card
(counterpart of ``jeicyboodsp_tpu/utils/tpu_checks.py``).

The CPU tests run the kernels' plain versions; :func:`run_checks` runs the
compiled kernels on ``device`` and asserts there what those tests assert,
on the JAX function's probes (:func:`probes`: drawn from
``default_rng(1234)`` in its order, so each is byte-identical to JAX's),
against the port's float64 oracles:

- the reference GEQ through K6 bit-exact, int16 wrap stress included;
- NLMS (K8) and BNLMS (K9, the gated path included) int16-exact;
- the enhancement engines mxu3 (K4, K5), mxu8 (K2, K3), mxu8f and mxu8t
  (K14, K1) at their floors of ``config.ENGINE_FIDELITY``, and mxu1 below
  the 60 dB bar (the reason no CLI reaches it);
- the MVDR collapse within one step on under 1% of the samples;
- the int8 Toeplitz fast convolution (gemm8, gemm8hq) at its floors;
- pitch method 2's lags (K11) equal to the oracle's.

On ``device="cpu"`` the same calls take the kernels' plain versions.  On a
card every kernel launches or raises (a wrapper has no fallback), and
:func:`run_checks` raises unless each of :data:`WRAPPERS` launched.
"""

from __future__ import annotations

import numpy as np
import torch

from jeicyboodsp_tpu_torch.config import ENGINE_FIDELITY
from jeicyboodsp_tpu_torch.kernels import (
    amdf, bnlms, enhance_back_ola3, enhance_back_ola8, enhance_full8, enhance_fwd,
    enhance_fwd_int8, geq_cascade_quant, nlms, vad_flags,
)
from jeicyboodsp_tpu_torch.ops import geq as G
from jeicyboodsp_tpu_torch.ops import mvdr as MV
from jeicyboodsp_tpu_torch.ops.enhance import enhance_blocks
from jeicyboodsp_tpu_torch.ops.fastconv import fastconv_blocks_gemm_int8
from jeicyboodsp_tpu_torch.ops.features import pitch_run
from jeicyboodsp_tpu_torch.oracle import enhance as oenh
from jeicyboodsp_tpu_torch.oracle import fastconv as ofc
from jeicyboodsp_tpu_torch.oracle import geq as ogeq
from jeicyboodsp_tpu_torch.oracle import mvdr as omv
from jeicyboodsp_tpu_torch.oracle import nlms as onl
from jeicyboodsp_tpu_torch.oracle import pitch as opitch
from jeicyboodsp_tpu_torch.utils.device import entry_device

COMPAT_BAR_DB = 60.0  # the enhancement engines' compat bar, which mxu1 stays below
WRAPPERS = {  # the kernels run_checks launches on a card: their wrappers
    "K1": enhance_full8.enhance_full8,
    "K2": enhance_fwd_int8.enhance_fwd_int8,
    "K3": enhance_back_ola8.enhance_back_ola8,
    "K4": enhance_fwd.enhance_fwd,
    "K5": enhance_back_ola3.enhance_back_ola3,
    "K6": geq_cascade_quant.geq_cascade_quant,
    "K8": nlms.nlms,
    "K9": bnlms.bnlms,
    "K11": amdf.amdf,
    "K14": vad_flags.vad_flags,
}


def probes(seed=1234) -> dict:
    """The checks' int16 inputs, drawn from ``default_rng(seed)`` in the JAX
    function's order: the GEQ's wrap stress, the NLMS far end ``x`` and its
    echo ``ref`` (a 32-tap room), the enhancement probe (96 blocks), the
    MVDR pair, the fast-convolution signal (16 blocks) and the pitch signal."""
    rng = np.random.default_rng(seed)
    c16 = lambda v: np.clip(v, -32768, 32767).astype(np.int16)  # noqa: E731
    p = {"stress": rng.integers(-32768, 32768, 2048).astype(np.int16)}
    n = 2048
    p["x"] = c16(rng.normal(0, 3000, n))
    h = rng.normal(0, 0.1, 32)
    h[0] = 0.5
    p["ref"] = c16(np.convolve(p["x"].astype(np.float64), h)[:n])
    t = np.arange(96 * 512) / 16000
    speech = 5000 * np.sin(2 * np.pi * 313 * t) * (np.sin(2 * np.pi * 0.5 * t) > 0.2)
    p["probe"] = c16(speech + rng.normal(0, 20, len(t)))
    tm = np.arange(512 * 40) / 16000
    sp_m = 6000 * np.sin(2 * np.pi * 400 * tm) * (((tm > 0.12) & (tm < 0.2)) | (tm > 0.3))
    p["xl"] = c16(sp_m + rng.normal(0, 15, len(tm)))
    p["xr"] = c16(0.8 * sp_m + rng.normal(0, 15, len(tm)))
    tfc = np.arange(16 * 1024) / 16000.0
    p["xfc"] = c16(5000 * np.sin(2 * np.pi * 313 * tfc) * (np.sin(2 * np.pi * 0.5 * tfc) > 0.2)
                   + rng.normal(0, 20, len(tfc)))
    tt = np.arange(512 * 8) / 16000
    p["xp"] = c16(8000 * np.sin(2 * np.pi * 123 * tt) + rng.normal(0, 300, len(tt)))
    return p


def _snr_db(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10(np.sum(want ** 2) / max(np.sum((want - got) ** 2), 1e-30))


def run_checks(device="cuda", launches: dict | None = None) -> dict:
    """Run every check on ``device``; returns {name: bool or dB} with the JAX
    function's keys (a bool True = the contract holds) and ``all_ok``.  A
    ``launches`` dict is filled with each kernel's launches in the call."""
    dev = entry_device(device)
    before = {k: fn.launches for k, fn in WRAPPERS.items()}
    results = {}
    p = probes()
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731

    # --- GEQ through K6: bit-exact incl. wrap stress ---
    got = G.run_quant(p["stress"], device=dev)
    results["geq_quant_bit_exact"] = bool(np.array_equal(got, ogeq.run(p["stress"])))

    # --- NLMS through K8: int16-exact against the oracle ---
    x, ref = p["x"], p["ref"]
    want_e = onl.reference_nlms_blocks(x.reshape(-1, 1024), ref.reshape(-1, 1024))[0]
    est, _, _ = nlms.nlms(on(x[None]), on(ref[None]))
    results["nlms_bit_exact"] = bool(np.array_equal(est[0].cpu().numpy(), want_e.reshape(-1)))

    # --- BNLMS through K9, the gated no-update path included ---
    ref2 = np.clip(-ref.astype(np.int32), -32768, 32767).astype(np.int16)
    want = np.stack([onl.reference_bnlms_blocks(x.reshape(-1, 1024), r.reshape(-1, 1024))[0]
                     .reshape(-1) for r in (ref, ref2)])
    xb, rb = on(np.stack([x, x])), on(np.stack([ref, ref2]))
    keep = torch.zeros(2, 127, dtype=torch.int16, device=dev)
    estb, _, _ = bnlms.bnlms(xb, rb, bnlms.bnlms_gates(xb, rb, keep, keep))
    results["bnlms_bit_exact"] = bool(np.array_equal(estb.cpu().numpy(), want))

    # --- the enhancement engines against the f64 oracle, at their floors ---
    probe = p["probe"]
    want_w = oenh.run(probe, "wiener")
    for engine in ("mxu3", "mxu8", "mxu8f", "mxu8t", "mxu1"):
        out, mask = enhance_blocks(on(probe.reshape(-1, 512)), mode="wiener",
                                   dtype=torch.float32, use_assoc_scan=True, real_fft=True,
                                   resynth="ratio", fft_engine=engine)
        snr = _snr_db(want_w, out[mask].reshape(-1).cpu().numpy())
        results[f"enhance_{engine}_snr_db"] = round(float(snr), 1)
        if engine == "mxu1":
            results["mxu1_below_bar"] = bool(snr < COMPAT_BAR_DB)
        else:
            results[f"enhance_{engine}_snr_ok"] = bool(
                snr >= ENGINE_FIDELITY["enhance", engine]["floor"])

    # --- the MVDR collapse at theta = 0: one step on under 1% against the oracle ---
    want_m = omv.run(p["xl"], p["xr"]).astype(np.int64)
    got_m = MV.run_stream(p["xl"], p["xr"], dtype=torch.float32, fft_engine="mxu3",
                          device=dev).astype(np.int64)
    dm = want_m - got_m
    results["mvdr_collapse_snr_db"] = round(float(_snr_db(want_m, got_m)), 1)
    results["mvdr_collapse_lsb_exact"] = bool(np.abs(dm).max() <= 1 and (dm != 0).mean() < 0.01)

    # --- the int8 Toeplitz fast convolution, 2 and 3 terms, at their floors ---
    want_fc = ofc.run(p["xfc"])
    for name, terms in (("gemm8", 2), ("gemm8hq", 3)):
        got_fc = fastconv_blocks_gemm_int8(on(p["xfc"].reshape(-1, 1024)), terms=terms)
        snr = _snr_db(want_fc, got_fc.reshape(-1).cpu().numpy())
        results[f"fastconv_{name}_snr_db"] = round(float(snr), 1)
        results[f"fastconv_{name}_snr_ok"] = bool(
            snr >= ENGINE_FIDELITY["fastconv", name]["floor"])

    # --- pitch method 2 through K11: lags equal to the oracle's ---
    args, _, _ = pitch_run(p["xp"], 2, torch.float32, "mxu", device=dev)
    results["amdf_lags_exact"] = bool(list(args) == [a for a, _, _ in opitch.run(p["xp"], 2)])

    results["all_ok"] = all(v for v in results.values() if isinstance(v, bool))
    made = {k: fn.launches - before[k] for k, fn in WRAPPERS.items()}
    if launches is not None:
        launches.update(made)
    if dev.type == "cuda":
        idle = [k for k, n in made.items() if n == 0]
        if idle:
            raise RuntimeError(f"run_checks: kernels {idle} did not launch on {dev}")
    return results
