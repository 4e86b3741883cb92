"""The port's pipeline-level fault harness (counterpart of tests/test_fault.py):
kill-and-resume equals an uninterrupted run, byte for byte.

A ``stream`` run of the port's CLI (``--device cpu``) is hard-killed
mid-stream by its fault injector (``os._exit(137)``, a SIGKILL stand-in that
skips every flush and atexit), restarted from its checkpoint twice, and the
final output must be byte-identical to a run never interrupted.  The
checkpoint keeps the JAX package's layout, so a run the JAX CLI started and
was killed in is finished by the port.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from jeicyboodsp_tpu.oracle import enhance as oenh
from jeicyboodsp_tpu_torch.cli import main
from jeicyboodsp_tpu_torch.io.wav import read_pcm16, write_pcm16
from jeicyboodsp_tpu_torch.pipelines.registry import stream_enhance

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(*args, jax=False, timeout=280):
    """The port's CLI on the CPU, or the JAX CLI (CPU backend, in its own
    process so that its x64 switch stays out of this one)."""
    pkg = "jeicyboodsp_tpu.cli" if jax else "jeicyboodsp_tpu_torch.cli"
    extra = () if jax else ("--device", "cpu")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"} if jax else None
    return subprocess.run([sys.executable, "-m", pkg, *args, *extra], cwd=ROOT, env=env,
                          capture_output=True, timeout=timeout)


def _signal(blocks=64, seed=7):
    rng = np.random.default_rng(seed)
    n = 512 * blocks
    t = np.arange(n) / 16000
    speech = 5000 * np.sin(2 * np.pi * 313 * t) * (t > 0.4)
    noise = rng.normal(0, 20, n)
    noise[: 16 * 512] *= 2.5  # a noise run long enough to latch
    return np.clip(speech + noise, -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    work = tmp_path_factory.mktemp("fault")
    x = _signal()
    write_pcm16(str(work / "in.pcm"), x)
    r = _cli("stream", str(work / "in.pcm"), str(work / "whole.pcm"), "wiener")
    assert r.returncode == 0, r.stderr.decode()[-1500:]
    return work, x, read_pcm16(str(work / "whole.pcm"))


def test_kill_and_resume_byte_identical(probe):
    work, x, whole = probe
    out, ck = str(work / "b.pcm"), str(work / "ck.npz")
    common = ("stream", str(work / "in.pcm"), out, "wiener", "--ckpt", ck, "--ckpt-every", "2")
    r1 = _cli(*common, "--crash-after", "3")
    assert r1.returncode == 137, (r1.returncode, r1.stderr.decode()[-800:])
    assert os.path.exists(ck)  # at least one checkpoint committed
    r2 = _cli(*common, "--crash-after", "3")
    assert r2.returncode == 137
    r3 = _cli(*common)
    assert r3.returncode == 0, r3.stderr.decode()[-1500:]
    np.testing.assert_array_equal(read_pcm16(out), whole)
    assert len(whole) == (len(x) // 512 - 2) * 512
    np.testing.assert_array_equal(whole, oenh.run(x, "wiener"))


@pytest.mark.parametrize("n", [0, 300])
def test_empty_and_sub_block_inputs_give_nothing(tmp_path, n):
    inp, out = str(tmp_path / "in.pcm"), str(tmp_path / "out.pcm")
    write_pcm16(inp, np.zeros(n, np.int16))
    stream_enhance(inp, out, "wiener", device="cpu")
    assert os.path.getsize(out) == 0


def test_resume_with_deleted_output_restarts_clean(probe, tmp_path):
    """A checkpoint whose output was deleted restarts from block 0: no
    zero-filled prefix."""
    work, _, whole = probe
    out, ck = str(tmp_path / "o.pcm"), str(tmp_path / "ck.npz")
    r = _cli("stream", str(work / "in.pcm"), out, "wiener", "--ckpt", ck, "--ckpt-every", "2",
             "--crash-after", "3")
    assert r.returncode == 137 and os.path.exists(ck)
    os.remove(out)
    stream_enhance(str(work / "in.pcm"), out, "wiener", ckpt=ck, device="cpu")
    np.testing.assert_array_equal(read_pcm16(out), whole)


def test_resume_in_another_precision_is_refused(probe, tmp_path):
    """A float64 checkpoint resumed under ``--fast`` (float32) raises: its
    f64 leaves beside f32 chunks would give neither run's output."""
    work, _, whole = probe
    out, ck = str(tmp_path / "o.pcm"), str(tmp_path / "ck.npz")
    stream_enhance(str(work / "in.pcm"), out, "wiener", ckpt=ck, ckpt_every=2, device="cpu")
    np.testing.assert_array_equal(read_pcm16(out), whole)
    assert os.path.exists(ck)
    with pytest.raises(ValueError, match="float64"):
        stream_enhance(str(work / "in.pcm"), out, "wiener", ckpt=ck, dtype=torch.float32,
                       device="cpu")


def test_jax_checkpoint_finished_by_the_port(probe, tmp_path):
    """The JAX CLI is killed mid-stream; the port's ``stream_enhance`` picks
    up its checkpoint and output and finishes byte-identical to the JAX
    CLI's uninterrupted run."""
    work, _, _ = probe
    inp = str(work / "in.pcm")
    jax_whole = str(tmp_path / "jax_whole.pcm")
    r = _cli("stream", inp, jax_whole, "specsub", jax=True)
    assert r.returncode == 0, r.stderr.decode()[-1500:]
    out, ck = str(tmp_path / "o.pcm"), str(tmp_path / "ck.npz")
    r = _cli("stream", inp, out, "specsub", "--ckpt", ck, "--ckpt-every", "2", "--crash-after",
             "5", jax=True)
    assert r.returncode == 137 and os.path.exists(ck), r.stderr.decode()[-800:]
    assert int(np.load(ck)["block"]) == 16  # the port resumes at block 16, not 0
    stream_enhance(inp, out, "specsub", ckpt=ck, device="cpu")
    np.testing.assert_array_equal(read_pcm16(out), read_pcm16(jax_whole))


@pytest.mark.parametrize("argv", [
    ["stream", "a", "b", "--engine", "mxu8f"],            # stream takes no engine
    ["stream", "a", "b", "--fast", "--engine", "xla"],
    ["stream", "a", "b", "loud"],                          # not a mode
    ["stream", "a"],                                       # two or three file arguments
    ["wiener", "a", "b", "--ckpt", "c.npz"],               # checkpoint flags: stream only
    ["geq", "a", "b", "--crash-after", "1"],
])
def test_cli_stream_refusals(argv):
    with pytest.raises(SystemExit) as e:
        main(argv + ["--device", "cpu"])
    assert e.value.code == 2
