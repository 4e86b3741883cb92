"""The port's CUDA kernel against its plain PyTorch version, and the
wrapper's contract.  Imports neither jax nor the JAX package, so it runs on
a card's host that has no jax:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

The kernel tests skip, with the reason, where there is no CUDA device; the
wrapper and build tests run everywhere.
"""

import os
import stat

import numpy as np
import pytest
import torch

from chip_smoke import make_signal
from jeicyboodsp_tpu_torch.kernels import _build
from jeicyboodsp_tpu_torch.kernels import enhance_full8 as K
from jeicyboodsp_tpu_torch.ops import enhance as E
from jeicyboodsp_tpu_torch.utils.metrics import snr_db

KERNEL_VS_PLAIN_DB = 90.0


def _signal(n_blocks, seed):
    return make_signal(n_blocks * 512, np.random.default_rng(seed))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, n_blocks=512, seed=3):
    blocks = torch.from_numpy(_signal(n_blocks, seed).reshape(-1, 512)).to(device)
    rowpack = E._latch_rowpack(E.vad_flags(blocks))
    return blocks, rowpack, E.enhance_constants(device)


@pytest.mark.parametrize("hq", [True, False], ids=["mxu8f", "mxu8t"])
@pytest.mark.parametrize("mode", ["wiener", "specsub"])
def test_kernel_matches_plain(cuda, mode, hq):
    blocks, rowpack, C = _inputs(cuda)
    assert rowpack[:, 2].max() >= 0  # the probe reaches the noise latch
    before = K.enhance_full8.launches
    got, pk = K.enhance_full8(blocks, rowpack, C, mode, hq, return_planes=True)
    want, pp = K.enhance_full8_plain(blocks, rowpack, C, mode, hq, return_planes=True)
    torch.cuda.synchronize()
    assert K.enhance_full8.launches == before + 1
    for k in ("re", "im"):  # same exact int dots and f32 epilogue order
        rel = (pk[k] - pp[k]).abs().amax(1) / pp[k].abs().amax(1)
        assert rel.max().item() <= 1e-6, k
    assert snr_db(want.cpu().numpy(), got.cpu().numpy()) >= KERNEL_VS_PLAIN_DB


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_zero_bins_give_nan_rows_and_zero_output(device, request):
    """Bins with re = im = 0 before any latch make the Wiener gain 0/0 =
    NaN; the NaN row max then poisons the whole row, whose output is
    c_short(NaN) = 0 -- as in the TPU kernel, whose jnp.max propagates NaN."""
    dev = request.getfixturevalue("cuda") if device == "cuda" else torch.device("cpu")
    blocks, rowpack, C = _inputs(dev, n_blocks=64)
    C = dict(C, fscales=C["fscales"].clone(), fcrows=C["fcrows"].clone())
    C["fscales"][:, 100:110] = 0.0  # re = im = 0 on bins 100..109
    C["fcrows"][:, 100:110] = 0.0
    out = K.enhance_full8(blocks, rowpack, C, "wiener", True, emit_all=True)
    latched = (rowpack[:, 2] >= 0).nonzero()
    first_latch = int(latched[0]) if len(latched) else 64
    assert out[: first_latch + 1].eq(0).all()
    if device == "cuda":
        want = K.enhance_full8_plain(blocks, rowpack, C, "wiener", True, emit_all=True)
        assert torch.equal(out.cpu()[: first_latch + 1], want.cpu()[: first_latch + 1])


def test_kernel_emit_all_and_odd_lengths(cuda):
    """enhance_blocks pads T to a multiple of 64 and masks warm-up rows."""
    for T in (3, 65, 200):
        blocks = torch.from_numpy(_signal(T, T).reshape(-1, 512)).to(cuda)
        out, mask = E.enhance_blocks(blocks, "wiener", emit_all=True)
        out_c, mask_c = E.enhance_blocks(blocks.cpu(), "wiener", emit_all=True)
        assert out.shape == (T, 512) and mask.tolist() == mask_c.tolist()
        assert out[:1].eq(0).all()
        assert snr_db(out_c[2:].numpy(), out[2:].cpu().numpy()) >= KERNEL_VS_PLAIN_DB


def test_cpu_runs_plain_without_counting():
    blocks, rowpack, C = _inputs("cpu", n_blocks=64)
    before = K.enhance_full8.launches
    out = K.enhance_full8(blocks, rowpack, C, "wiener", True)
    assert K.enhance_full8.launches == before
    assert torch.equal(out, K.enhance_full8_plain(blocks, rowpack, C, "wiener", True))


@pytest.mark.parametrize("bad", ["dtype", "width", "rows", "rowpack", "mode", "const",
                                 "noncontig", "device"])
def test_wrapper_rejects(bad):
    blocks, rowpack, C = _inputs("cpu", n_blocks=64)
    mode = "wiener"
    if bad == "dtype":
        blocks = blocks.to(torch.int32)
    elif bad == "width":
        blocks = blocks[:, :256]
    elif bad == "rows":
        blocks, rowpack = blocks[:60], rowpack[:60]
    elif bad == "rowpack":
        rowpack = rowpack[:, :4]
    elif bad == "mode":
        mode = "mmse"
    elif bad == "const":
        C = dict(C, fwd8=C["fwd8"].to(torch.int16))
    elif bad == "noncontig":
        blocks = blocks.t().contiguous().t()
    elif bad == "device":
        blocks = blocks.to("meta")
    with pytest.raises(ValueError):
        K.enhance_full8(blocks, rowpack, C, mode)


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """No fallback: a compiler error surfaces with its stderr."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: sm_90a refused' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="sm_90a refused"):
        _build._compile(str(tmp_path / "build" / "lib.so"))
    assert not os.listdir(tmp_path / "build")


def test_library_path_keys_on_sources():
    p = _build.library_path()
    assert p.startswith(_build.BUILD) and p.endswith(".so")
    assert p == _build.library_path()
