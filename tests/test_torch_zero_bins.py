"""The enhancement engines' gain where a bin of their spectrum is exactly 0
while the noise estimate is 0 (ROADMAP P7): the Wiener gain's 0/0.

The reference computes its spectrum in float64, which has no exactly-zero
bin in a frame that holds a nonzero sample; the int8 engines' quantized
spectrum can.  The port takes gain 1 there (the bin contributes its 0, the
reference's value) and keeps the NaN of an all-zero frame, where the
reference too goes 0/0 and writes that row and the next as zeros.  The JAX
package's kernels as written zero the row instead (ROADMAP R23).

The witness: a 250 Hz tone of 3,000 gated at 0.5 Hz over N(0, 10), seed 7
(``portbench.signals.gated_tones``), whose block 2,333 gives the int8
forward an exactly-zero DC bin; the VAD calls every block speech, so the
noise estimate stays 0.  The tests take blocks 2,296-2,359 of it.  Imports
neither jax nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_zero_bins.py

The card tests skip, with the reason, where there is no CUDA device.
"""

import numpy as np
import pytest
import torch

from jeicyboodsp_tpu_torch.config import ENGINE_FIDELITY
from jeicyboodsp_tpu_torch.kernels import enhance_back as K13
from jeicyboodsp_tpu_torch.kernels import enhance_back_ola8 as K3
from jeicyboodsp_tpu_torch.kernels import enhance_full8 as K1
from jeicyboodsp_tpu_torch.kernels import enhance_fwd as K4
from jeicyboodsp_tpu_torch.kernels import enhance_fwd_int8 as K2
from jeicyboodsp_tpu_torch.ops import enhance as E
from jeicyboodsp_tpu_torch.oracle.enhance import reference_enhance
from jeicyboodsp_tpu_torch.utils.metrics import snr_db
from portbench import signals
from portbench.harness import Cell
from portbench.systems import Item
from portbench.systems.enhance import System

FIRST, ROWS, ZERO_DC = 2296, 64, 37  # the witness's blocks; block 2,333 in them
TONE = {"tone_hz": 250, "amp": 3000, "noise_sd": 10, "gate_hz": 0.5, "gate_level": 0.2}
ENGINES = ("mxu8", "mxu8f", "mxu8t", "mxu3", "mxu")
SILENT = (20, 21)  # blocks made zero: frame 21 holds no nonzero sample


@pytest.fixture(scope="module")
def witness():
    gen = torch.Generator().manual_seed(7)
    x = signals.gated_tones([20000 * 512], 16000, TONE, gen, "cpu")[0].view(-1, 512)
    return x[FIRST:FIRST + ROWS].clone()


def _run(blocks, engine, mode="wiener"):
    out, mask = E.enhance_blocks(blocks, mode, torch.float32, real_fft=True, resynth="ratio",
                                 fft_engine=engine)
    return out[mask].cpu().numpy()


def _oracle(blocks, mode="wiener"):
    return reference_enhance(blocks.reshape(-1).numpy(), mode).reshape(-1, 512)


def _zero_rows(rows):
    return [t + 2 for t in np.flatnonzero((rows == 0).all(1))]  # block numbers (rows t >= 2)


def test_the_witness_has_an_exactly_zero_bin_and_no_noise_estimate(witness):
    re, im, _ = K1.forward8_plain(witness, E.enhance_constants("cpu"))
    assert re[ZERO_DC, 0] == 0 and im[ZERO_DC, 0] == 0  # the int8 spectrum's DC bin
    assert E.vad_flags(witness, torch.float32).all()  # every block speech: ns = 0


@pytest.mark.parametrize("engine", ENGINES)
def test_witness_rows_hold_no_zero_row(witness, engine):
    """No row is zero where the oracle has none, and each engine keeps its
    floor; the 0/0 bin contributes its 0, as the oracle's nonzero bin there
    contributes next to nothing."""
    want, got = _oracle(witness), _run(witness, engine)
    assert _zero_rows(want) == [] and _zero_rows(got) == []
    assert snr_db(want, got) >= ENGINE_FIDELITY[("enhance", engine)]["floor"]


@pytest.mark.parametrize("engine", ENGINES)
def test_an_all_zero_frame_still_zeroes_its_row_and_the_next(witness, engine):
    """An all-zero frame before the latch is 0/0 in the oracle too: it
    writes that row and the next as zeros, and so does every engine."""
    blocks = witness.clone()
    blocks[list(SILENT)] = 0
    want, got = _oracle(blocks), _run(blocks, engine)
    assert _zero_rows(want) == [21, 22] == _zero_rows(got)
    assert snr_db(want, got) >= ENGINE_FIDELITY[("enhance", engine)]["floor"]


def test_frame_flags(witness):
    """The forward kernels' frame flags (plain versions): 1.0 where the
    frame [x[t-1], x[t]] holds a nonzero sample, the row pair around the
    silent blocks 0.0 only where both are silent."""
    blocks = witness.clone()
    blocks[list(SILENT)] = 0
    want = torch.ones(ROWS, 1)
    want[21] = 0.0
    assert torch.equal(K1.frame_nonzero(blocks).float()[:, None], want)
    C = E.enhance_constants("cpu")
    for fwd in (K2.enhance_fwd_int8, K4.enhance_fwd):
        outs = fwd(blocks, C)
        assert len(outs) == 7 and torch.equal(outs[6], want)


def test_the_frame_flag_decides_the_zero_bins_gain(witness):
    """K3 and K13 on the witness's planes: with the forward's frame flags
    the 0/0 bin of block 2,333 passes with gain 1 and no row is zero; with
    that row's flag cleared, as for a frame that holds no sample, its gain
    is NaN (the JAX package's kernels as written, R23, on every row), the
    row and the next are zero (K13: that row NaN), and every other row is
    the same."""
    C = E.enhance_constants("cpu")
    re, im, re_n, mag, mag_n, sp, nz = K2.enhance_fwd_int8(witness, C)
    ns, ns_n = E._noise_latch_parts(sp[:, 0] > 0.5, (mag, mag_n))
    assert nz.eq(1.0).all()
    cleared = nz.clone()
    cleared[ZERO_DC] = 0.0
    old = K3.enhance_back_ola8(re, im, re_n, ns, ns_n, cleared, C, "wiener")
    new = K3.enhance_back_ola8(re, im, re_n, ns, ns_n, nz, C, "wiener")
    assert _zero_rows(old.numpy()[2:]) == [ZERO_DC, ZERO_DC + 1]
    assert _zero_rows(new.numpy()[2:]) == []
    rows = np.ones(ROWS, bool)
    rows[[ZERO_DC, ZERO_DC + 1]] = False  # the rows the NaN reached
    assert np.array_equal(old.numpy()[rows], new.numpy()[rows])
    head, _, _ = K13.enhance_back(re, im, re_n, ns, ns_n, cleared, C, "wiener")
    assert head[ZERO_DC].isnan().all() and head.isnan().sum() == 512
    head, _, _ = K13.enhance_back(re, im, re_n, ns, ns_n, nz, C, "wiener")
    assert head.isfinite().all()


def _judge(blocks):
    """The wiener16k.files cell's offline check on the witness, under the
    configuration the cell runs: the numbers and whether each keeps its
    limit."""
    config = Cell("wiener16k.files").config
    system = System(config, "cpu")
    item = Item((blocks,), blocks.numel(), "witness")
    numbers = system.judge_offline([(item, system.call(item))], seed=7)
    return numbers, {k: (numbers[k] >= v["limit"] if v["rule"] == ">=" else numbers[k] <= v["limit"])
                     for k, v in config["checks"]["offline"].items()}


def test_the_cells_checks_catch_a_return_of_the_old_gain(witness, monkeypatch):
    """The cell's offline path (engine mxu8f) passes its checks on the
    witness; with the gain's 0/0 planted back (every frame flag cleared),
    the zeroed rows fail them."""
    numbers, ok = _judge(witness)
    assert all(ok.values()), numbers
    gain = K1.bin_gain
    monkeypatch.setattr(K1, "bin_gain", lambda re, im, ren, ns, nsn, nz, mode:
                        gain(re, im, ren, ns, nsn, torch.zeros_like(nz), mode))
    numbers, ok = _judge(witness)
    assert not all(ok.values()), numbers
    assert numbers["max_abs_lsb"] > 16


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("silent", [False, True], ids=["witness", "all_zero_frame"])
@pytest.mark.parametrize("engine", ENGINES)
def test_card_engines_on_the_witness(witness, cuda, engine, silent):
    """The kernels (K1 for mxu8f / mxu8t, K2 + K3, K4 + K5) on the card:
    the same zero rows as the oracle and as their plain versions, each
    engine at its floor."""
    blocks = witness.clone()
    if silent:
        blocks[list(SILENT)] = 0
    want, plain, got = _oracle(blocks), _run(blocks, engine), _run(blocks.to(cuda), engine)
    assert _zero_rows(got) == _zero_rows(want) == _zero_rows(plain)
    assert snr_db(want, got) >= ENGINE_FIDELITY[("enhance", engine)]["floor"]


def test_card_frame_flags_equal_the_plain_versions(witness, cuda):
    blocks = witness.clone()
    blocks[list(SILENT)] = 0
    C = E.enhance_constants(cuda)
    want = K1.frame_nonzero(blocks).float()[:, None]
    for fwd in (K2.enhance_fwd_int8, K4.enhance_fwd):
        assert torch.equal(fwd(blocks.to(cuda), C)[6].cpu(), want)
