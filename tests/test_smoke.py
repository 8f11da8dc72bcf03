"""The GPU entry points: chip_smoke.py, bench.py and the compile cache.

The CPU tests check that both scripts refuse to run without a GPU and that
the compile-cache helper picks its directory as documented. The tests
marked ``gpu`` run the smoke-test phases themselves and skip without a GPU
(see tests/conftest.py for the command that runs them on a GPU machine).
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **extra)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.parametrize("argv", [["chip_smoke.py"],
                                  ["chip_smoke.py", "--four"],
                                  ["bench.py", "--stages", "oracle"]])
def test_scripts_refuse_cpu(argv):
    out = subprocess.run([sys.executable] + argv, cwd=REPO, env=_cpu_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_smoke_needs_the_repo(tmp_path):
    """Alone in a directory, the script fails before printing a result."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = _cpu_env()
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("cache_env", [None, "custom"])
def test_compile_cache_dir(tmp_path, cache_env):
    """Set: JAX's own variable wins and nothing else is configured.
    Unset: <checkout>/.jax_cache, derived from the package's path."""
    env = _cpu_env()
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(REPO, ".jax_cache")
    if cache_env:
        want = str(tmp_path / cache_env)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    script = ("import jax\n"
              "from lidar_slam_tpu.utils import compile_cache\n"
              "print(json.dumps([compile_cache.enable(),\n"
              "                  jax.config.jax_compilation_cache_dir]))\n")
    out = subprocess.run([sys.executable, "-c", "import json\n" + script],
                         cwd=str(tmp_path), env=dict(env, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got, cfg_dir = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == want and cfg_dir == want


def test_bench_rejects_unknown_stage():
    out = subprocess.run([sys.executable, "bench.py", "--stages", "nope"],
                         cwd=REPO, env=_cpu_env(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2 and "unknown stages" in out.stderr


# --- on the card: the same functions as the chip_smoke.py phases -----------

@pytest.mark.gpu
@pytest.mark.parametrize("size", [400, 512])
def test_gpu_edt_exact(gpu, size):
    import chip_smoke

    assert chip_smoke.check_edt(size)["exact_vs_native"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["pf", "closure"])
def test_gpu_volume_exact(gpu, case):
    import chip_smoke

    assert chip_smoke.check_volume(case)["exact"]


@pytest.mark.gpu
def test_gpu_lookup(gpu):
    import chip_smoke

    assert chip_smoke.check_lookup()["max_rel_err"] <= 1e-6


@pytest.mark.gpu
def test_gpu_pf(gpu):
    import chip_smoke

    assert chip_smoke.phase_pf()["ate_m"] < 0.10


@pytest.mark.gpu
def test_gpu_fidelity(gpu):
    import chip_smoke

    res = chip_smoke.phase_fidelity()
    assert abs(res["ate_m"] - res["oracle_ate_m"]) < 1e-3


@pytest.mark.gpu
def test_gpu_graph(gpu):
    import chip_smoke

    assert chip_smoke.phase_graph()["closures"] >= 1


@pytest.mark.gpu
def test_gpu_stream(gpu):
    import chip_smoke

    assert chip_smoke.phase_stream()["scans"] == 50
