"""chip_smoke.py's phases at tiny sizes on the CPU, and the process
set-up helpers it shares with the other entry points (device check,
compile cache).  On the card the same phases run at full size."""
import os
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from pymht_tpu.utils import runtime  # noqa: E402

TINY = dict(
    widths=(dict(T=4, L=4, M=16, A=4, radar_range=500.0),
            dict(T=8, L=2, M=32, A=8, radar_range=3000.0)),
    served=dict(chip_smoke.FULL['served'], n_targets=6, radar_range=500.0,
                n_scans=4, oracle_after=(2, 4), ipm_scans=2,
                shapes=dict(max_targets=16, max_leaves=8, max_meas=48,
                            max_ais=8, ais_per_leaf=2, window=5,
                            max_prelim=16, max_initiators=48)),
    swarm=dict(chip_smoke.FULL['swarm'], n_targets=12, radar_range=3000.0,
               n_scans=3, four_scans=2,
               shapes=dict(max_targets=16, max_leaves=4, max_meas=96,
                           max_ais=16, ais_per_leaf=2, window=4,
                           max_prelim=16, max_initiators=96,
                           radar_cand_width=8)),
)


def test_phase_kernels_tiny():
    worst = chip_smoke.phase_kernels(TINY['widths'])
    assert 0.0 <= worst <= 1.0


def test_phase_kernels_catches_a_wrong_op(monkeypatch):
    """A device op off by more than its tolerance fails phase b."""
    from pymht_tpu.ops import kalman as k
    orig = k.precalc

    def skewed(C, R, x_bar, P_bar):
        z_hat, S, S_inv, K, P_hat = orig(C, R, x_bar, P_bar)
        return z_hat, S, S_inv * 1.001, K, P_hat

    monkeypatch.setattr(k, "precalc", skewed)
    with pytest.raises(AssertionError, match="S_inv"):
        chip_smoke.phase_kernels(TINY['widths'][:1])


@pytest.mark.parametrize("four", [False, True], ids=["one", "four"])
def test_run_tiny(four, capsys):
    devices = jax.devices()
    result = chip_smoke.run(TINY, devices, "cpu (test)", four=four)
    assert result == {"ok": True,
                      "device": {"platform": "cpu",
                                 "kind": devices[0].device_kind,
                                 "count": 4 if four else len(devices)}}
    out = capsys.readouterr().out
    assert "card: cpu (test)" in out
    assert ("phase f" in out) == four and ("phase b" in out) != four


def test_main_fails_without_gpu(capsys, cache_config):
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_default_dir(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_respects_env(monkeypatch, cache_config, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_scan_coverage_one_to_one():
    from pymht_tpu.utils.metrics import scan_coverage
    truth = np.zeros((1, 2, 4))
    truth[0, 1, 0] = 5.0                 # two truths 5 m apart
    track_x = np.zeros((1, 3, 4))
    track_x[0, 1, 0] = 100.0             # one track near both, one far
    mask = np.array([[True, True, False]])
    cov, rms = scan_coverage(track_x, mask, truth)
    assert cov == 0.5 and rms == 0.0


@pytest.mark.gpu
def test_phase_kernels_full_width_on_gpu(gpu_devices):
    """Phase b at the served and swarm widths, on the card."""
    assert chip_smoke.phase_kernels(chip_smoke.FULL['widths']) <= 1.0
