"""The inputs the port's tests share: signal generators, their seed and
sizes, and the limits some tests derive from JAX's readings.

Not a test module (pytest collects ``test_*.py`` only).  Imports numpy, and
torch inside the generators that make tensors, and neither jax nor the JAX
package, so the card tests can use it on a host that has no jax.  Each
generator gives the same samples for the same arguments on every run.
"""

from __future__ import annotations

import numpy as np

FS = 16000
SEED = 20260817
T_FULL = 16384  # blocks of 512 per enhancement call (8.39 M samples)
T_PROBE = 192   # blocks of the enhancement probe
GEQ_B, GEQ_T = 2048, 49152  # GEQ streams x samples (bench/all_configs.py:278)
AEC_B, AEC_T = 1024, 65536  # echo-canceller streams x samples (bench/all_configs.py:498)
TP_T = 1024     # blocks of the time-parallel BNLMS session (bench/all_configs.py:521-535)
HMM_T = 4096    # frames of the decoded utterance (bench/all_configs.py:822)
MFCC_T = 8192   # blocks of 1024 per MFCC call: 16,384 frames (bench/all_configs.py:612)
PITCH_T = 16384  # frames of 1024 at hop 512 per pitch call (bench/all_configs.py:681)
FC_T = 2048     # blocks of 1024 per fastconv call: 2041 segments of 8192 (:332)
FFT_T = 16384   # blocks of 512 per FFT-program call (bench/all_configs.py:651)
LPC_T = 8192    # LPC frames of 512 (bench/all_configs.py:794-800)

F32_RTOL = 1e-5     # K4's f32 planes against f64: of each plane's row max
SCORE_RTOL = 1e-4   # speech_classify's scores (f32 features) against the f64 reference's
# levinson f32 against reference_lpc, of each frame's largest coefficient.  JAX's f32 op on
# the LPC_T frames of lpc_signal() (jitted, CPU) reads a median frame error of 3.74e-7 and 1
# frame above 1e-2 (a tone frame whose 12x12 system is near singular; worst 0.058); the
# limits are 4x those readings, the factor tests/test_torch_lpc.py allows the port's median
# frame against JAX's.  That file reads JAX's numbers anew and holds these limits to them.
LPC_F32_JAX = (3.74e-7, 1)  # JAX's f32 levinson here: median frame error, frames above 1e-2
LPC_F32_MEDIAN, LPC_F32_LOST = 4 * LPC_F32_JAX[0], 4 * LPC_F32_JAX[1]


def make_signal(n, rng):
    """Noisy gated 313 Hz tone: speech-like on/off segments over N(0, 20) noise."""
    t = np.arange(n) / FS
    speech = 5000 * np.sin(2 * np.pi * 313 * t) * (np.sin(2 * np.pi * 0.5 * t) > 0.2)
    return np.clip(speech + rng.normal(0, 20, n), -32768, 32767).astype(np.int16)


def chain_signals():
    """The enhancement chain's probe (T_PROBE blocks) and full-size signal
    (T_FULL blocks), drawn in that order from SEED."""
    rng = np.random.default_rng(SEED)
    probe = make_signal(T_PROBE * 512, rng)
    return probe, make_signal(T_FULL * 512, rng)


def vad_threshold_rows(w2):
    """(6, 512) int16 rows at the VAD's thresholds (WienerFilter_final.cpp:
    261-296) for the f32 window half w2, s = trunc(x * w2): three whose
    truncated samples alternate in sign (ZCR 511) with sum(s^2) = 700 *
    1024 - 1, + 0, + 1, and three of tiny energy with ZCR 199, 200, 201.
    Their flags: False, False, True, True, False, False."""
    w2 = np.asarray(w2, np.float32)

    def x_for(s, i):  # the smallest |x| whose truncated windowed value is s
        sign = 1 if s > 0 else -1
        for m in range(abs(s), 4 * abs(s) + 64):
            if int(np.trunc(np.float32(sign * m) * w2[i])) == s:
                return sign * m
        raise ValueError(f"no int16 sample gives {s} at {i}")

    unit = np.array([x_for((-1) ** i, i) for i in range(512)])  # s = +1, -1, ...
    rows = []
    for e in (716799, 716800, 716801):
        rest, abc = e - 509, None  # three large samples at 0..2, units elsewhere
        for a in range(int(rest ** 0.5), 0, -1):
            for b in range(min(a, int((rest - a * a) ** 0.5)), 0, -1):
                c = int(round((rest - a * a - b * b) ** 0.5))
                if 0 < c <= b and a * a + b * b + c * c == rest:
                    abc = (a, -b, c)
                    break
            if abc:
                break
        row = unit.copy()
        row[:3] = [x_for(s, i) for i, s in enumerate(abc)]
        rows.append(row)
    for z in (199, 200, 201):
        row = np.zeros(512, np.int64)
        row[: z + 1] = unit[: z + 1]
        rows.append(row)
    return np.array(rows, np.int16)


def k4_f64_bases(device):
    """float64 (1024, 512) window-folded cos and sin bases of K4's function:
    the Hamming window with REF_PI times exp(-2 pi i n k / 1024)."""
    import torch

    from jeicyboodsp_tpu_torch.oracle.cnum import REF_PI

    n = np.arange(1024)
    ang = -2.0 * np.pi * n[:, None] * np.arange(512)[None, :] / 1024
    ham = (0.54 - 0.46 * np.cos(2.0 * REF_PI * n / 1023))[:, None]
    return tuple(torch.from_numpy(ham * f(ang)).to(device) for f in (np.cos, np.sin))


def make_geq_streams(B, T, dev):
    """(B, T) int16 audio at 48 kHz: per stream a tone (50-8050 Hz, amplitude
    up to 8000) over N(0, 500) noise; the first B/8 streams full-scale random
    int16, where the +12 dB bands overflow and wrap.  Made on ``dev`` from
    SEED."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED)
    f32 = dict(dtype=torch.float32, device=dev)
    t = torch.arange(T, **f32) / 48000.0
    f = 50.0 + 8000.0 * torch.rand(B, 1, generator=g, **f32)
    amp = 8000.0 * torch.rand(B, 1, generator=g, **f32)
    x = amp * torch.sin(2 * np.pi * f * t) + 500.0 * torch.randn(B, T, generator=g, **f32)
    x = x.clamp(-32768, 32767).to(torch.int16)
    x[: B // 8] = torch.randint(-32768, 32768, (B // 8, T), generator=g, device=dev,
                                dtype=torch.int32).to(torch.int16)
    return x


def make_aec_streams(B, T, dev):
    """(B, T) int16 far ends N(0, 3000) and near ends: the far end's echo
    (0.5 x[t] + 0.2 x[t-7] - 0.1 x[t-19]) plus N(0, 50) noise; in the last
    quarter of the streams an independent N(0, 2000) near-end talker too
    (double talk).  Made on ``dev`` from SEED."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    f32 = dict(dtype=torch.float32, device=dev)
    x = (3000.0 * torch.randn(B, T, generator=g, **f32)).clamp(-32768, 32767).round()

    def delay(v, k):
        return torch.nn.functional.pad(v, (k, 0))[:, :T]

    r = 0.5 * x + 0.2 * delay(x, 7) - 0.1 * delay(x, 19)
    r = r + 50.0 * torch.randn(B, T, generator=g, **f32)
    r[3 * B // 4:] += 2000.0 * torch.randn(B - 3 * B // 4, T, generator=g, **f32)
    return x.to(torch.int16), r.clamp(-32768, 32767).to(torch.int16)


def probe_signals():
    """The recursion pipelines' probe signals, from SEED: a GEQ probe of 8
    blocks of tone and 2 of full-scale random int16; an echo pair of 6
    blocks; and a pair whose gate stays shut (a non-negative far end against
    a non-positive near end)."""
    rng = np.random.default_rng(SEED + 2)
    n = 8 * 512
    t = np.arange(n) / 48000.0
    tone = 8000 * np.sin(2 * np.pi * 440 * t) + 4000 * np.sin(2 * np.pi * 3000 * t)
    tone = np.clip(tone + rng.normal(0, 500, n), -32768, 32767).astype(np.int16)
    geq = np.concatenate([tone, rng.integers(-32768, 32768, 2 * 512).astype(np.int16)])
    m = 6 * 1024
    x = np.clip(rng.normal(0, 3000, m), -32768, 32767).astype(np.int16)
    h = rng.normal(0, 0.1, 32)
    h[0] = 0.5
    r = np.clip(np.convolve(x.astype(np.float64), h)[:m] + rng.normal(0, 50, m),
                -32768, 32767).astype(np.int16)
    xs = np.abs(x[:3 * 1024].astype(np.int32)).clip(0, 32767).astype(np.int16)
    return geq, {"echo": (x, r), "partial": (x[:4 * 1024 + 300], r[:4 * 1024 + 500]),
                 "shut": (xs, -(xs // 2)), "empty": (x[:0], r[:0])}


def tp_inputs(dev):
    """One session of TP_T blocks: make_signal over 512 blocks tiled, and its
    echo through a random 32-tap room (lead 0.5)."""
    import torch

    rng = np.random.default_rng(SEED + 11)
    x = make_signal(512 * 1024, rng)
    h = rng.normal(0, 0.1, 32)
    h[0] = 0.5
    r = np.clip(np.convolve(x.astype(np.float64), h)[:len(x)], -32768, 32767).astype(np.int16)
    reps = -(-TP_T * 1024 // len(x))
    xt = np.tile(x, reps)[:TP_T * 1024].reshape(TP_T, 1024)
    rt = np.tile(r, reps)[:TP_T * 1024].reshape(TP_T, 1024)
    return torch.from_numpy(xt).to(dev), torch.from_numpy(rt).to(dev)


def make_stereo(n, rng):
    """Two mics: the gated 400 Hz tone of tests/test_mvdr.py (0.8x on the
    right) switching on and off as make_signal's, over N(0, 15) on each."""
    t = np.arange(n) / FS
    speech = 6000 * np.sin(2 * np.pi * 400 * t) * (np.sin(2 * np.pi * 0.5 * t) > 0.2)
    xl = np.clip(speech + rng.normal(0, 15, n), -32768, 32767).astype(np.int16)
    xr = np.clip(0.8 * speech + rng.normal(0, 15, n), -32768, 32767).astype(np.int16)
    return xl, xr


def speech_signal(n, rng, silent=None):
    """Speech-like int16 at 16 kHz: f0 gliding over 80-150 Hz with a third
    harmonic over N(0, 300); the sample range ``silent`` (start, stop) set
    to digital silence."""
    t = np.arange(n) / FS
    phase = 2 * np.pi * np.cumsum(115.0 + 35.0 * np.sin(2 * np.pi * 0.7 * t)) / FS
    x = 8000 * np.sin(phase) + 2000 * np.sin(3 * phase) + rng.normal(0, 300, n)
    x = np.clip(x, -32768, 32767).astype(np.int16)
    if silent:
        x[silent[0]:silent[1]] = 0
    return x


def class_signal(c, n, rng):
    """Class c of the classification probe: a tone at 150 Hz x 1.12^c with a
    3% vibrato and a second harmonic, amplitude-modulated, over N(0, 300)."""
    t = np.arange(n) / FS
    f0 = 150.0 * 1.12 ** c
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.03 * np.sin(2 * np.pi * 1.3 * t))) / FS
    amp = 6000 * (0.6 + 0.4 * np.sin(2 * np.pi * 2.1 * t + rng.uniform(0, 6)) ** 2)
    x = amp * (np.sin(phase) + 0.4 * np.sin(2 * phase)) + rng.normal(0, 300, n)
    return np.clip(x, -32768, 32767).astype(np.int16)


def class_models(feats):
    """Class models in the test layout from each class's float64 features:
    four contiguous quarters of the frames as the mixtures, each with its
    mean and covariance and their top-4 eigenpairs (numpy.linalg.eigh).
    Returns alphas (C, 4), means (C, 4, 12), covs (C, 4, 12, 12), eigvecs
    (C, 4, 12, 4)."""
    C = len(feats)
    alphas = np.full((C, 4), 0.25)
    means, covs, eigs = np.zeros((C, 4, 12)), np.zeros((C, 4, 12, 12)), np.zeros((C, 4, 12, 4))
    for c, f in enumerate(feats):
        q = len(f) // 4
        for k in range(4):
            seg = f[k * q:(k + 1) * q]
            vals, vecs = np.linalg.eigh(np.cov(seg.T, bias=True))
            top = np.argsort(-vals, kind="stable")[:4]
            means[c, k, :4] = seg.mean(0) @ vecs[:, top]
            covs[c, k, np.arange(4), np.arange(4)] = vals[top]
            eigs[c, k] = vecs[:, top]
    return alphas, means, covs, eigs


def synth_class(seed, n):
    """bench/all_configs.py:940-947: four separated sub-clusters, frame i in
    cluster (i // 4) % 4, so the k-means seeds land in distinct clusters."""
    r = np.random.default_rng(seed)
    center = r.normal(0, 10, 12)
    sub = center + r.normal(0, 4.0, (4, 12))
    ids = (np.arange(n) // 4) % 4
    return sub[ids] + r.normal(0, 0.5, (n, 12))


def bench_hmm(rng):
    """bench/all_configs.py:822-866: the f32 decode model (alpha 1/4, means
    N(0, 1), covariances 2 I, eigenvectors the identity's first 4 columns,
    uniform transitions) with HMM_T N(0, 1) frames; and the packed f64 HMM
    the reference binary decodes (projected means N(0, 2), variances 0.01,
    QR eigenvectors, transitions near uniform) with its observation, each
    frame near a random state's first mixture."""
    f32 = (rng.normal(0, 1.0, (HMM_T, 12)).astype(np.float32), np.full((6, 4), 0.25, np.float32),
           rng.normal(0, 1, (6, 4, 12)).astype(np.float32),
           np.broadcast_to(np.eye(12, dtype=np.float32), (6, 4, 12, 12)) * np.float32(2.0),
           np.ascontiguousarray(np.broadcast_to(np.eye(12, dtype=np.float32)[:, :4], (6, 4, 12, 4))),
           np.full((6, 6), 1.0 / 6, np.float32))
    states = []
    for _ in range(6):
        mn = np.zeros((4, 12))
        mn[:, :4] = rng.normal(0, 2, (4, 4))
        ev = np.zeros((4, 12, 4))
        for k in range(4):
            ev[k] = np.linalg.qr(rng.normal(0, 1, (12, 4)))[0]
        states.append((np.full(4, 0.25), mn, np.stack([np.eye(12) * 0.01 for _ in range(4)]), ev))
    transn = rng.dirichlet(np.ones(6), size=6) + 0.5
    transn /= transn.sum(axis=1, keepdims=True)
    seq = rng.integers(0, 6, HMM_T)
    obs = np.stack([states[s][3][0] @ states[s][1][0][:4] + rng.normal(0, 0.02, 12) for s in seq])
    # the same model's state 0 held throughout: state 0's value stays positive, so the
    # log-of-log recursion stays finite (a state 0 below 0 makes every later value NaN)
    obs0 = states[0][3][0] @ states[0][1][0][:4] + rng.normal(0, 0.02, (HMM_T, 12))
    return f32, (states, transn, obs, obs0)


def feature_inputs(dev):
    """The speech features' full-size inputs, from SEED: MFCC_T blocks of
    speech with 8192 samples of digital silence (14 whole frames, NaN
    features), as the signal and its zero-prefixed (2T + 1, 512) row view
    whose rows[:-1], rows[1:] are K10's frame halves; PITCH_T frames
    [previous block, block] of speech with a silent stretch (every lag ties:
    lag 101)."""
    import torch

    rng = np.random.default_rng(SEED + 3)
    x = speech_signal(MFCC_T * 1024, rng, silent=(300_000, 308_192))
    flat = torch.from_numpy(np.concatenate([np.zeros(512, np.int16), x])).to(dev)
    blocks = speech_signal(PITCH_T * 512, rng, silent=(1_000_000, 1_010_000)).reshape(-1, 512)
    prev = np.concatenate([np.zeros((1, 512), np.int16), blocks[:-1]])
    frames = torch.from_numpy(np.concatenate([prev, blocks], 1)).to(dev)
    return x, flat.reshape(-1, 512), frames


def transform_inputs():
    """The full-size signals of fastconv and the FFT program, from SEED: FC_T
    blocks of 1024 and FFT_T blocks of 512 of make_signal."""
    rng = np.random.default_rng(SEED + 5)
    return make_signal(FC_T * 1024, rng), make_signal(FFT_T * 512, rng)


def lpc_signal():
    """LPC_T frames' worth (hop 256) of make_signal, from SEED."""
    return make_signal(LPC_T * 256, np.random.default_rng(SEED + 9))
