"""Process-level contracts: the compile-cache location, one JAX process
per GPU, and the on-device smoke test refusing to run without a GPU."""

import os
import shutil
import stat
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code, env, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "VAT_NO_COMPILE_CACHE")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT, **extra)
    return env


def test_compile_cache_defaults_to_checkout():
    p = _python("import jax, video_annotator_tpu; "
                "print(jax.config.jax_compilation_cache_dir)", _env())
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == os.path.join(ROOT, ".jax_cache")


def test_compile_cache_honours_env_dir(tmp_path):
    d = str(tmp_path / "cache")
    p = _python("import jax, video_annotator_tpu; "
                "print(jax.config.jax_compilation_cache_dir)",
                _env(JAX_COMPILATION_CACHE_DIR=d))
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == d


def test_gpu_host_needs_nvidia_smi_and_no_cpu_pin(tmp_path, monkeypatch):
    from video_annotator_tpu import workflow

    smi = tmp_path / "nvidia-smi"
    smi.write_text("#!/bin/sh\n")
    smi.chmod(smi.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("JAX_PLATFORMS", "")
    assert workflow.gpu_host()
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert not workflow.gpu_host()
    monkeypatch.setenv("JAX_PLATFORMS", "")
    smi.unlink()
    assert not workflow.gpu_host()


def test_split_refuses_concurrent_renders_on_a_gpu(tmp_path, monkeypatch):
    from video_annotator_tpu import workflow

    monkeypatch.setattr(workflow, "gpu_host", lambda: True)
    with pytest.raises(ValueError, match="concurrency 1"):
        workflow.split("1234", str(tmp_path), concurrency=2)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """No GPU (or no repo beside the script): non-zero exit, no result."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    env = _env()
    if alone:
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
        env.pop("PYTHONPATH")
    p = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
