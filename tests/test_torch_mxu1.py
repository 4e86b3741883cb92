"""Engine ``mxu1``: the JAX package's one-pass ``Precision.DEFAULT`` matmul
DFT, in the port both operands rounded to bfloat16 and multiplied in f32
(``ops.dft.matmul``).  JAX on the CPU computes DEFAULT in full f32, so its
output is no reference here: the port's products are held bit-equal to f32
matmuls of the bf16-rounded operands, every product of the routes JAX
gives the tier takes it, the chain lands at >= 40 and < 60 dB of the oracle
on ``run_checks``' probe, and no CLI reaches it."""

import numpy as np
import pytest
import torch

from jeicyboodsp_tpu_torch.cli import main
from jeicyboodsp_tpu_torch.ops import dft as D
from jeicyboodsp_tpu_torch.ops import enhance as TE
from jeicyboodsp_tpu_torch.ops import features as TF
from jeicyboodsp_tpu_torch.ops import mvdr as TM
from jeicyboodsp_tpu_torch.oracle import enhance as oenh
from jeicyboodsp_tpu_torch.utils.gpu_checks import COMPAT_BAR_DB, probes
from jeicyboodsp_tpu_torch.utils.metrics import snr_db


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def test_products_are_f32_matmuls_of_bf16_operands():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(37, 1024, generator=g) * 3000, torch.randn(1024, 513, generator=g)
    assert torch.equal(D.matmul(a, b, "mxu1"), torch.matmul(_bf16(a), _bf16(b)))
    assert torch.equal(D.matmul(a, b, "mxu"), a @ b) and not torch.equal(a @ b, _bf16(a) @ _bf16(b))
    C, S = D._rdft_mats(1024)
    re, im = D.rdft(a, "mxu1")
    assert torch.equal(re, _bf16(a) @ _bf16(torch.from_numpy(C)))
    assert torch.equal(im, _bf16(a) @ _bf16(torch.from_numpy(S)))
    frames = torch.from_numpy(probes()["probe"][:8 * 1024].reshape(8, 1024))
    X = TE.frame_transform(frames, torch.float32, fft_engine="mxu1")
    w = frames.float() * TE.hamming_ref(1024, torch.float32)
    fwd_re, fwd_im, _, _ = TE._dft_matrices()
    assert torch.equal(X.real, _bf16(w) @ _bf16(torch.from_numpy(fwd_re)))
    assert torch.equal(X.imag, _bf16(w) @ _bf16(torch.from_numpy(fwd_im)))


def _count_tier(monkeypatch, module):
    """Count the products ``module`` makes at each tier."""
    seen = []
    real = D.matmul

    def spy(a, b, fft_engine="mxu"):
        seen.append(fft_engine)
        return real(a, b, fft_engine)

    monkeypatch.setattr(module, "matmul", spy)
    return seen


@pytest.mark.parametrize("resynth,products", [("ratio", 6), ("trig", 4)])
def test_every_chain_product_takes_the_tier(monkeypatch, resynth, products):
    """Ratio: JAX's _enhance_fast_mxu route (WC, WS, nyq, UC512, VS512,
    y512col); trig: frame_transform's two and gain_and_resynth's two."""
    seen = _count_tier(monkeypatch, TE)
    b = torch.from_numpy(probes()["probe"].reshape(-1, 512))
    out, mask = TE.enhance_blocks(b, "wiener", torch.float32, True, real_fft=True,
                                  resynth=resynth, fft_engine="mxu1")
    assert seen == ["mxu1"] * products
    ref, _ = TE.enhance_blocks(b, "wiener", torch.float32, True, real_fft=True,
                               resynth=resynth, fft_engine="mxu")
    assert not torch.equal(out, ref)


@pytest.mark.parametrize("mode", ["wiener", "specsub"])
def test_chain_below_the_bar(mode):
    probe = probes()["probe"]
    want = oenh.run(probe, mode)
    got = TE.run_stream(probe, mode, dtype=torch.float32, use_assoc_scan=True,
                        fft_engine="mxu1", device="cpu")
    full = TE.run_stream(probe, mode, dtype=torch.float32, use_assoc_scan=True,
                         fft_engine="mxu", device="cpu")
    snr = snr_db(want, got)
    print(f"{mode}: mxu1 {snr:.2f} dB, mxu {snr_db(want, full):.2f} dB")
    assert 40.0 <= snr < COMPAT_BAR_DB


def test_mvdr_and_mfcc_take_the_tier(monkeypatch):
    """JAX's precision_of reaches mfcc_frames' DFT and the spectral MVDR's
    transforms; pitch method 1 asks HIGHEST whatever the engine."""
    seen = _count_tier(monkeypatch, D)
    p = probes()
    TM.run_stream(p["xl"], p["xr"], dtype=torch.float32, fft_engine="mxu1", collapse=False,
                  device="cpu")
    assert seen and set(seen) == {"mxu1"}
    seen.clear()
    TF.mfcc_run(p["xfc"], dtype=torch.float32, fft_engine="mxu1", device="cpu")
    assert seen and set(seen) == {"mxu1"}
    seen.clear()
    TF.pitch_run(p["xp"], 1, torch.float32, "mxu1", device="cpu")
    assert seen and set(seen) == {"mxu"}


def test_no_cli_reaches_mxu1(tmp_path, capsys):
    src = tmp_path / "in.pcm"
    src.write_bytes(probes()["probe"][:4096].tobytes())
    for prog in ("wiener", "specsub"):
        with pytest.raises(SystemExit):
            main([prog, str(src), str(tmp_path / "out.pcm"), "--fast", "--engine", "mxu1",
                  "--device", "cpu"])
        assert "mxu1" in capsys.readouterr().err
