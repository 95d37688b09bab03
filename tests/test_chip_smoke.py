"""chip_smoke.py's phases at tiny sizes on the CPU, its refusal to run
anywhere but a GPU, and (marked `gpu`) a short phase on the card."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_main_refuses_cpu(capsys):
    assert jax.devices()[0].platform == "cpu"
    assert cs.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_script_alone_fails(tmp_path):
    """Copied into a directory with nothing else of the repo, the script
    exits non-zero and prints no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_gate_raises_on_failure():
    assert cs.gate("x", 61.0, 60.0) == 61.0
    with pytest.raises(cs.GateFailed):
        cs.gate("x", 59.0, 60.0)
    with pytest.raises(cs.GateFailed):
        cs.gate("err", 2.0, 1.0, at_least=False)
    with pytest.raises(cs.GateFailed):
        cs.identical("bits", np.zeros(3), np.array([0.0, 0.0, 1e-30]))


def test_np_round_trip_reference_reconstructs():
    """The float64 reference itself: identity reconstructs to f64 noise."""
    x = np.random.default_rng(1).standard_normal(5000)
    y = cs.np_round_trip(x, 1024, 256)
    assert 10 * np.log10(np.sum(x**2) / np.sum((x - y) ** 2)) > 250


def test_phase_headline(rng, tmp_path):
    res = cs.phase_headline(rng, str(tmp_path), seconds=0.5)
    assert min(res.values()) >= 60.0
    assert (tmp_path / "headline_out_h256.wav").exists()


def test_phase_eq_fir(rng):
    res = cs.phase_eq_fir(rng, seconds=0.5)
    assert set(res) == {"band_gain", "fir63"}


def test_phase_multichannel(rng):
    res = cs.phase_multichannel(rng, channels=3, seconds=0.5)
    assert res["worst_channel_snr_db"] >= 90.0


def test_phase_resample(rng):
    res = cs.phase_resample(rng, minutes=0.02)
    assert min(res.values()) >= 100.0


def test_phase_nonlinear(rng):
    res = cs.phase_nonlinear(rng, seconds=0.5)
    assert set(res) == {"noise_gate", "spectral_subtraction"}


def test_phase_streaming_scan(rng):
    """On the CPU, AUTO is not the blocked route, so only the scan
    streamer runs, chunk for chunk equal to its one-shot."""
    res = cs.phase_streaming(rng, chunks=3, chunk=16384)
    assert res == {"scan_chunks": 2}


def test_phase_features(rng):
    res = cs.phase_features(rng, seconds=1.0)
    assert res["mel_snr_db"] >= 80.0 and res["mfcc_snr_db"] >= 80.0


def test_phase_kernels(rng):
    res = cs.phase_kernels(rng, seconds=0.5, channels=2)
    assert res["normalize_ulps"] <= 0.5


def test_phase_channel_mesh(rng):
    res = cs.phase_channel_mesh(rng, jax.devices()[:4], channels=8,
                                seconds=0.512)
    assert res["channels"] == 8
    assert res["fir63_snr_db_mesh"] >= res["fir63_snr_db_one_card"] - 0.01
    assert res["fir63_snr_db_one_card"] >= 90.0


def test_phase_time_mesh_stream(rng):
    res = cs.phase_time_mesh_stream(rng, jax.devices()[:4], channels=2,
                                    chunks=3, chunk_per_card=4096)
    assert res["chunk"] == 4 * 4096


@pytest.mark.gpu
def test_phases_on_the_card(gpu, rng, tmp_path):
    """A short run of the main path and the kernel phase on the GPU."""
    assert cs.phase_headline(rng, str(tmp_path), seconds=2.0)
    assert cs.phase_kernels(rng, seconds=2.0, channels=4)


@pytest.mark.gpu
def test_main_on_the_card_prints_device_last(gpu, tmp_path, monkeypatch):
    """The contract of the last line, with the phases stubbed out."""
    for name in ("phase_headline", "phase_eq_fir", "phase_multichannel",
                 "phase_resample", "phase_nonlinear", "phase_streaming",
                 "phase_features", "phase_kernels"):
        monkeypatch.setattr(cs, name, lambda *a, **k: {})
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cs.main(["--out", str(tmp_path)]) == 0
    last = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert last == {"ok": True, "device": {
        "platform": "gpu", "kind": gpu.device_kind,
        "count": len(jax.devices())}}
