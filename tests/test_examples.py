"""Every example must run as documented: `python examples/<name>.py ...`
as a plain subprocess (no install, no PYTHONPATH) on a small WAV.

This is the regression test for the class of bug where examples import
the package but the repo root is not on sys.path.
"""

import os
import subprocess
import tempfile
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))



pytestmark = pytest.mark.slow  # integration demos, not correctness gates

@pytest.fixture(scope="module")
def small_wav(tmp_path_factory):
    import crlot_tpu as ct

    path = str(tmp_path_factory.mktemp("ex") / "in.wav")
    rng = np.random.default_rng(0)
    t = np.arange(24000) / 48000.0
    x = (0.5 * np.sin(2 * np.pi * 440 * t)
         + 0.05 * rng.standard_normal(24000)).astype(np.float32)
    ct.write_wav(path, x, 48000, bits=16)
    return path


def _run(script, *args, cwd=None):
    # Run from outside the repo (the temp dir) so the example must find the
    # package on its own. The wrapper pins CPU via jax.config before handing off to the example
    # script, whatever accelerator the machine has.
    path = os.path.join(REPO, "examples", script)
    wrapper = (
        "import jax, runpy, sys; "
        "jax.config.update('jax_platforms', 'cpu'); "
        f"sys.argv = [{path!r}] + sys.argv[1:]; "
        f"runpy.run_path({path!r}, run_name='__main__')"
    )
    return subprocess.run(
        [sys.executable, "-c", wrapper, *args],
        capture_output=True, text=True, timeout=600,
        cwd=cwd or tempfile.gettempdir(),
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )


def test_denoise_example(small_wav, tmp_path):
    out = str(tmp_path / "out.wav")
    r = _run("denoise.py", small_wav, out)
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.getsize(out) > 1000


def test_fir_filter_example(small_wav, tmp_path):
    out = str(tmp_path / "out.wav")
    r = _run("fir_filter.py", small_wav, out, "--cutoff-hz", "2000")
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.getsize(out) > 1000


def test_sharded_eq_example(small_wav, tmp_path):
    out = str(tmp_path / "out.wav")
    r = _run("sharded_eq.py", small_wav, out)
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.getsize(out) > 1000


def test_time_stretch_example(small_wav, tmp_path):
    out = str(tmp_path / "out.wav")
    r = _run("time_stretch.py", small_wav, out, "--rate", "1.5")
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.getsize(out) > 1000
    r = _run("time_stretch.py", small_wav, out, "--semitones", "-5")
    assert r.returncode == 0, r.stderr[-2000:]


def test_extract_features_example(small_wav, tmp_path):
    out = str(tmp_path / "feats.npz")
    r = _run("extract_features.py", small_wav, out)
    assert r.returncode == 0, r.stderr[-2000:]
    d = np.load(out)
    assert d["mel"].shape[-1] == 64 and d["mfcc"].shape[-1] == 13
    assert np.isfinite(d["mel"]).all() and np.isfinite(d["mfcc"]).all()
    # 440 Hz tone + light noise: centroid should sit well below Nyquist.
    assert 100 < float(np.median(d["centroid"])) < 8000


def test_loudness_example(small_wav):
    r = _run("loudness.py", small_wav)
    assert r.returncode == 0, r.stderr[-2000:]
    # 440 Hz tone + light noise: A-weighting at 440 Hz is ~ -4.8 dB, so
    # the A-weighted level must sit below the unweighted one.
    line = r.stdout.strip().splitlines()[-1]
    assert "A-weighted" in line and "dBFS" in line, line


def test_analyze_example(small_wav, tmp_path):
    stems = str(tmp_path / "stems")
    r = _run("analyze.py", small_wav, "--write-stems", stems)
    assert r.returncode == 0, r.stderr[-2000:]
    out = r.stdout
    assert "tempo:" in out and "harmonic/percussive energy" in out
    # A steady 440 Hz tone in noise is overwhelmingly harmonic.
    import re
    m = re.search(r"harmonic/percussive energy: ([\d.]+)%", out)
    assert m and float(m.group(1)) > 70.0, out
    assert os.path.exists(os.path.join(stems, "harmonic.wav"))
    assert os.path.exists(os.path.join(stems, "percussive.wav"))


def test_streaming_checkpoint_example(small_wav, tmp_path):
    out = str(tmp_path / "out.npy")
    ckpt = str(tmp_path / "stream.ckpt.npz")
    r = _run("streaming_checkpoint.py", small_wav, out, "--ckpt", ckpt)
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out)
