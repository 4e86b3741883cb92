"""The port's WAV writer and pipeline dispatch against the JAX package's."""

import numpy as np
import pytest

from jeicyboodsp_tpu.io import wav as jwav
from jeicyboodsp_tpu.pipelines import registry as jreg
from jeicyboodsp_tpu_torch.io import wav as twav
from jeicyboodsp_tpu_torch.pipelines import registry as treg


@pytest.mark.parametrize("args", [(0, 16000), (1000, 16000), (77, 44100, 2), (5, 8000, 1, 8),
                                  (9, 22050, 1, 12)])
def test_wav_header_bytes_equal_jax(args):
    assert twav.wav_header(*args) == jwav.wav_header(*args)


def test_write_wav_bytes_equal_jax(tmp_path):
    x = np.random.default_rng(0).integers(-32768, 32768, 1001).astype(np.int16)
    for channels in (1, 2):
        a, b = tmp_path / f"t{channels}.wav", tmp_path / f"j{channels}.wav"
        twav.write_wav(str(a), x[: 1000], 16000, channels)
        jwav.write_wav(str(b), x[: 1000], 16000, channels)
        assert a.read_bytes() == b.read_bytes()
        np.testing.assert_array_equal(twav.read_wav_ref(str(a)), x[:1000])


def test_run_pipeline_dispatches_as_jax(tmp_path):
    assert sorted(treg.PIPELINES) == sorted(jreg.PIPELINES)
    x = np.random.default_rng(1).integers(-3000, 3000, 512 * 5).astype(np.int16)
    inp = tmp_path / "in.wav"
    twav.write_wav(str(inp), x, 48000)
    got = treg.run_pipeline("geq", str(inp), str(tmp_path / "t.pcm"), device="cpu")
    want = jreg.run_pipeline("geq", str(inp), str(tmp_path / "j.pcm"))
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "t.pcm").read_bytes() == (tmp_path / "j.pcm").read_bytes()
    with pytest.raises(KeyError):
        treg.run_pipeline("nope")
