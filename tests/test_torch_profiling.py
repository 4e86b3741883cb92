"""``jeicyboodsp_tpu_torch.utils.profiling`` against the JAX package's
``utils/profiling.py``: every roofline name, ``Roofline.bound()``'s keys, one
yardstick for each op whatever engine computes it, the kernels' work table
(its bytes equal to the bytes of each kernel's function: the inputs it
needs read once, a stream that frames overlap counted once, and the
outputs written once, here through the plain versions on small shapes) and
``trace``."""

import ast
import inspect
import json
import os

import numpy as np
import pytest
import torch

from jeicyboodsp_tpu.utils import profiling as JP
from jeicyboodsp_tpu_torch.utils import profiling as P

ENHANCE = ("enhance_chain_roofline", "enhance_mxu3_roofline", "enhance_mxu8_roofline",
           "enhance_mxu8t_roofline", "enhance_mxu8f_roofline")
FASTCONV = ("fastconv_roofline", "fastconv_gemm8_roofline", "fastconv_gemm8hq_roofline",
            "fastconv_gemm_roofline", "fastconv_sparse_roofline")


def _jax_roofline_names():
    tree = ast.parse(inspect.getsource(JP))
    return sorted(n.name for n in tree.body
                  if isinstance(n, ast.FunctionDef) and n.name.endswith("_roofline"))


def test_every_jax_roofline_name_exists():
    names = _jax_roofline_names()
    assert len(names) >= 22
    for name in names:
        r = getattr(P, name)()
        assert isinstance(r, P.Roofline) and r.unit in P.PEAKS, name
        assert r.flops_per_block > 0 and r.hbm_bytes_per_block > 0 and r.samples_per_block > 0
        assert getattr(P, name).__doc__, name  # each states its count


def test_bound_keys_equal_jax_s():
    want = JP.enhance_chain_roofline().bound()
    got = P.enhance_chain_roofline().bound()
    assert set(got) == set(want)
    r = P.enhance_mxu8_roofline()
    sol = r.bound()["speed_of_light_samples_per_s"]
    assert r.pct_of_roof(sol / 2) == pytest.approx(50.0)
    assert got["bottleneck"] in ("compute", "memory")


@pytest.mark.parametrize("family", [ENHANCE, FASTCONV], ids=["enhance", "fastconv"])
def test_one_yardstick_per_op(family):
    """Every engine's model of one op counts the same work; the engine picks
    only the arithmetic type."""
    work = {(getattr(P, n)().flops_per_block, getattr(P, n)().hbm_bytes_per_block,
             getattr(P, n)().samples_per_block) for n in family}
    assert len(work) == 1
    units = {n: getattr(P, n)().unit for n in family}
    assert units[family[2]] == "int8" and units[family[0]] == "f32"


def test_enhance_chain_counts_two_real_ffts():
    r = P.enhance_chain_roofline()
    assert r.flops_per_block >= 2 * 2.5 * 1024 * 10
    assert r.hbm_bytes_per_block == 2 * 512 * 2  # int16 in and out once
    assert P.enhance_chain_roofline(dtype_bytes=8).unit == "f64"


def test_peaks_are_the_h100_s():
    assert P.PEAKS["int8"] == 1979e12 and P.PEAKS["bf16"] == 989e12
    assert P.PEAKS["tf32"] == 495e12 and P.PEAKS["f32"] == 67e12 and P.PEAKS["f64"] == 34e12
    assert P.HBM_BPS == 3.35e12


KERNEL_NAMES = {f"K{i}" for i in range(1, 16)} | {"K6f32", "K8f32", "K9f32"}


def test_kernels_cover_k1_to_k14_and_the_f32_instances():
    assert set(P.KERNELS) == KERNEL_NAMES


def test_k5_and_k13_bound_by_their_bytes():
    for name, mb, ms in (("K5", 117.6, 0.0351), ("K13", 168.0, 0.0501)):
        w = P.KERNELS[name](16384)
        b_ms, by = w.bound()
        assert by == "bytes" and round(w.nbytes / 1e6, 1) == mb and round(b_ms, 4) == ms
        assert w.ops / P.PEAKS["f32"] * 1e3 < 0.01  # the function's f32 work


def test_k10_bound_by_its_operations_reading_its_stream_once():
    w = P.KERNELS["K10"](16384)
    b_ms, by = w.bound()
    assert by == "operations" and round(b_ms, 4) == 0.0082
    assert w.nbytes == 16384 * (512 * 2 + 12 * 4)  # each 512-sample half once, 12 f32 out


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _enhance_tensors(T=128):
    from jeicyboodsp_tpu_torch.kernels import enhance_back as K13
    from jeicyboodsp_tpu_torch.kernels import enhance_back_ola3 as K5
    from jeicyboodsp_tpu_torch.kernels import enhance_back_ola8 as K3
    from jeicyboodsp_tpu_torch.kernels import enhance_full8 as K1
    from jeicyboodsp_tpu_torch.kernels import enhance_fwd as K4
    from jeicyboodsp_tpu_torch.kernels import enhance_fwd_int8 as K2
    from jeicyboodsp_tpu_torch.ops import enhance as E

    rng = np.random.default_rng(5)
    blocks = torch.from_numpy(rng.integers(-3000, 3000, (T, 512)).astype(np.int16))
    C = E.enhance_constants("cpu")
    rowpack = E._latch_rowpack(E.vad_flags(blocks, torch.float32))
    consts = lambda mod: [C[k] for k in mod.CONSTS]  # noqa: E731
    f2, f4 = K2.enhance_fwd_int8(blocks, C), K4.enhance_fwd(blocks, C)
    ns, ns_n = torch.zeros(T, 512), torch.zeros(T, 1)
    back = (f4[0], f4[1], f4[2], ns, ns_n)
    out1 = K1.enhance_full8(blocks, rowpack, C, "wiener", True)
    # K5's and K13's function: a real FFT's table (K4's), not the dense bases their GEMMs read
    assert "back32" in K5.CONSTS and "back32" in K13.CONSTS
    inverse = [C["rfft"], C["u_nyq"], C["y512col"]]
    return T, {
        "K1": _nbytes(blocks, rowpack, *consts(K1), out1),
        "K2": _nbytes(blocks, *consts(K2), *f2),
        "K3": _nbytes(*back, *consts(K3), K3.enhance_back_ola8(*back, C, "wiener")),
        "K4": _nbytes(blocks, *consts(K4), *f4),
        "K5": _nbytes(*back, *inverse, K5.enhance_back_ola3(*back, C, "wiener")),
        "K13": _nbytes(*back, *inverse, *K13.enhance_back(*back, C, "wiener")),
    }


def test_enhancement_kernels_bytes_are_their_tensors():
    T, want = _enhance_tensors()
    for name, nb in want.items():
        assert P.KERNELS[name](T).nbytes == nb, name


def test_other_kernels_bytes_are_their_tensors():
    from jeicyboodsp_tpu_torch.kernels import amdf as K11
    from jeicyboodsp_tpu_torch.kernels import bnlms as K9
    from jeicyboodsp_tpu_torch.kernels import fft_four_step as K12
    from jeicyboodsp_tpu_torch.kernels import geq_cascade as K7
    from jeicyboodsp_tpu_torch.kernels import geq_cascade_quant as K6
    from jeicyboodsp_tpu_torch.kernels import mfcc_fused as K10
    from jeicyboodsp_tpu_torch.kernels import nlms as K8
    from jeicyboodsp_tpu_torch.kernels import vad_flags as K14
    from jeicyboodsp_tpu_torch.ops import enhance as E
    from jeicyboodsp_tpu_torch.ops import geq as G

    rng = np.random.default_rng(6)
    i16 = lambda *s: torch.from_numpy(rng.integers(-3000, 3000, s).astype(np.int16))  # noqa: E731
    B, T = 3, 2048
    b, a = G.geq_coefficients()
    x = i16(B, T)
    for dtype, name in ((np.float64, "K6"), (np.float32, "K6f32")):
        c = torch.from_numpy(K7.pack_coefficients(b, a, dtype))
        st = K6.init_state(B, "cpu")
        y, st2 = K6.geq_cascade_quant(x, c, st)
        assert P.KERNELS[name](B, T).nbytes == _nbytes(x, c, st, y, st2), name
    xf, c32 = x.float(), torch.from_numpy(K7.pack_coefficients(b, a))
    assert P.KERNELS["K7"](B, T).nbytes == _nbytes(xf, c32, K7.geq_cascade(xf, c32))
    r = i16(B, T)
    for dtype, name, fn in ((torch.float64, "K8", K8.nlms), (torch.float32, "K8f32", K8.nlms_f32)):
        st = K8.init_state(B, "cpu", dtype)
        est, err, st2 = fn(x, r, st)
        assert P.KERNELS[name](B, T).nbytes == _nbytes(x, r, *st, est, err, *st2), name
    keep = torch.zeros(B, 127, dtype=torch.int16)
    gates = K9.bnlms_gates(x, r, keep, keep)
    for dtype, name, fn in ((torch.float64, "K9", K9.bnlms), (torch.float32, "K9f32",
                                                              K9.bnlms_f32)):
        st = K9.init_state(B, "cpu", dtype)
        est, err, st2 = fn(x, r, gates, st)
        assert P.KERNELS[name](B, T, int(gates.sum())).nbytes == _nbytes(
            x, r, gates, *st, est, err, *st2), name
    N = 6
    stream = i16(N + 1, 512)  # frame t is [stream[t], stream[t + 1]]: the stream read once
    prev, cur = stream[:-1], stream[1:]
    assert P.KERNELS["K10"](N).nbytes == _nbytes(cur, K10.mfcc_fused(prev, cur))
    frames = torch.cat([prev, cur], 1)
    assert P.KERNELS["K11"](N, 96).nbytes == _nbytes(cur, K11.amdf(frames, 96))
    zr, zi = torch.randn(N, 512), torch.randn(N, 512)
    assert P.KERNELS["K12"](N, 512).nbytes == _nbytes(zr, zi, *K12.fft_pallas(zr, zi, 512, False))
    assert P.KERNELS["K12"](N, 512, True).nbytes == _nbytes(zr, *K12.fft_pallas(zr, None, 512,
                                                                                 True))
    blocks, w = i16(N, 512), E._vad_window(torch.device("cpu"))
    assert P.KERNELS["K14"](N).nbytes == _nbytes(blocks, w, K14.vad_flags(blocks, w))


def test_k15_bytes_are_its_tensors_and_its_chain_the_bound():
    from jeicyboodsp_tpu_torch.kernels import enhance_chunk64 as K15
    from jeicyboodsp_tpu_torch.ops import enhance as E

    Tc = 3
    blocks = torch.from_numpy(np.random.default_rng(7).integers(-3000, 3000, (Tc, 512))
                              .astype(np.int16))
    state = E.stream_init_state(torch.float64, device="cpu")
    out, mask, new = K15.enhance_chunk64(state, blocks)
    w = P.KERNELS["K15"](Tc)
    assert w.nbytes == _nbytes(blocks, *state.values(), *K15.constants(torch.device("cpu")),
                               out, mask, *new.values())
    assert w.unit == "f64" and w.chain_steps == Tc and w.chain_ms() > 100 * w.bound()[0]


def test_recursions_carry_a_chain_and_the_others_none():
    for name, args in (("K6", (2, 100)), ("K7", (2, 100)), ("K8", (2, 100)),
                       ("K9", (2, 2048, 1)), ("K15", (2,))):
        w = P.KERNELS[name](*args)
        assert w.chain_cycles == P.CHAIN_CYCLES[name] and w.chain_ms() > 0
    assert P.KERNELS["K8"](1, 100).chain_steps == 100 and P.KERNELS["K6"](1, 100).chain_steps == 112
    assert P.KERNELS["K4"](16).chain_cycles is None


def test_bound_takes_the_longer_side():
    assert P.bound(3.35e9, 0, "f32") == pytest.approx((1.0, "bytes"))
    assert P.bound(0, 67e9, "f32") == pytest.approx((1.0, "operations"))


def test_trace_writes_a_chrome_trace_naming_a_torch_op(tmp_path):
    logdir = str(tmp_path / "trace")
    with P.trace(logdir) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(ev.key == "aten::mm" for ev in prof.key_averages())
    files = sorted(os.listdir(logdir))  # the Chrome trace and the spans beside it
    assert len(files) == 2 and files[0].startswith("spans_") and files[1].startswith("trace_")
    assert files[0][len("spans_"):] == files[1][len("trace_"):] and files[1].endswith(".json")
    with open(os.path.join(logdir, files[1])) as f:
        events = json.load(f)["traceEvents"]
    assert any(ev.get("name") == "aten::mm" for ev in events)
    with open(os.path.join(logdir, files[0])) as f:
        assert json.load(f) == {"clock": "unix_ns", "spans": []}
