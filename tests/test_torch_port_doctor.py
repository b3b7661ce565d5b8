"""The port's environment doctor (fgvc_tpu_torch/cli/doctor.py) on the CPU,
as tests/test_doctor.py drives fgvc_tpu's: the bounded device probe
answers, the report carries the environment and the further checks (nvcc,
the kernel build directory, the optional imports), and the exit code is 0
when the device responds and 1 when it does not (no card here, so
--device cuda fails)."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _doctor(*flags):
    return subprocess.run([sys.executable, "-m", "fgvc_tpu_torch.cli.doctor", *flags],
                          capture_output=True, text=True, timeout=200, cwd=ROOT)


def test_doctor_cpu_probe_and_report():
    from fgvc_tpu_torch.cli.doctor import OPTIONAL_IMPORTS, run_checks

    r = run_checks(probe_timeout=120, device="cpu")
    assert r["ok"], r
    dev = r["checks"]["device"]
    assert dev["ok"] and dev["device"] == "cpu" and dev["matmul_ok"]
    assert dev["first_op_s"] >= 0 and dev["transfer_MBps"] > 0
    assert "k1" not in dev  # the kernel check needs a card
    assert r["env"]["torch"] and r["env"]["devices"] == "cpu"
    build = r["checks"]["kernel_build"]
    assert build["ok"] and build["note"] in ("warm", "cold (the first run builds with nvcc)")
    assert set(OPTIONAL_IMPORTS) <= set(r["checks"]) and "nvcc" in r["checks"]


def test_doctor_cli_exit_codes():
    out = _doctor("--device", "cpu", "--probe-timeout", "120", "--json")
    assert out.returncode == 0, out.stderr[-1000:]
    rep = json.loads(out.stdout)
    assert rep["ok"] and rep["checks"]["device"]["device"] == "cpu"
    # the card is the default device; without one the probe fails, so does the doctor
    out = _doctor("--probe-timeout", "120")
    assert out.returncode == 1
    assert "[FAIL] device" in out.stdout and "no CUDA device" in out.stdout


def test_doctor_probe_timeout_is_a_failure(monkeypatch):
    from fgvc_tpu_torch.cli import doctor

    r = doctor.run_checks(probe_timeout=0.01, device="cpu")
    assert not r["ok"] and "no response" in r["checks"]["device"]["error"]
    assert "env" not in r
