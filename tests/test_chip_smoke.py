"""chip_smoke.py's phases at small sizes on the CPU, its refusal to run
without a GPU, and the compile-cache helper every entry point uses."""

import os
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs
from montecarlo_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Published exact equities against a random hand (all 1,326 villains):
# the full enumeration is a GPU job, so the CPU test takes them as given.
KNOWN_VS_RANDOM = {"AA": 0.8520, "KK": 0.8240, "AKs": 0.6704,
                   "72o": 0.3458, "32o": 0.3230}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(cs, "INTERPRET", True)


def _check(res):
    assert res["ok"], res
    return res


def test_phase_equity_small(interpret):
    res = _check(cs.phase_equity(cs.SMALL))
    assert res["sizes"]["rollouts"] == cs.SMALL["equity_rollouts"]
    assert abs(res["exact"] - 0.4587) < 1e-3  # AKs vs QQ, exact
    assert res["path"] == "xla" and "triton" in res


def test_phase_sweep_small(interpret):
    res = _check(cs.phase_sweep(cs.SMALL, exact_fn=lambda labels: {
        lab: KNOWN_VS_RANDOM[lab] for lab in labels}))
    assert set(res["xla"]["z"]) == set(cs.SWEEP_CHECKED)
    assert set(res["triton"]["z"]) == set(cs.SWEEP_CHECKED)


def test_phase_server_small():
    res = _check(cs.phase_server(cs.SMALL))
    rooms = res["rooms_on_cpu"]
    assert rooms["reference_2_clients"]["actions"] == cs.SMALL[
        "server_actions"]
    assert rooms["standard_5_bots"]["p99_ms"] > 0


def test_main_refuses_a_cpu_device(capsys):
    assert jax.devices()[0].platform == "cpu"
    assert cs.main([]) == 2
    out = capsys.readouterr()
    assert out.out == ""  # no result line without a GPU
    assert "needs a GPU" in out.err


def test_script_alone_fails(tmp_path):
    """Copied out of the repository, the script cannot import the system
    and exits non-zero without printing a result."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_z_score_and_timed():
    assert cs.z_score(0.5, 0.5, 100) == 0
    assert abs(cs.z_score(0.55, 0.5, 100) - 1.0) < 1e-12
    calls = []
    out, comp, warm = cs.timed(lambda: calls.append(1) or len(calls))
    assert out == 2 and comp >= 0 and warm >= 0


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_default_is_in_the_checkout(monkeypatch,
                                                  restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.isdir(path)


def test_compile_cache_env_var_wins(monkeypatch, tmp_path,
                                   restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", "unchanged")
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets no directory
    assert jax.config.jax_compilation_cache_dir == "unchanged"
