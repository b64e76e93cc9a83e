"""chip_smoke.py's phases at tiny sizes on the CPU, and its refusals.

On the CPU every decode route is XLA, so these check the phases' control
flow, references and tolerances, not the GPU kernel (tests/test_gpu.py and
the script itself do that on the card).
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


@pytest.fixture(scope="module")
def code():
    return cs.get_code("block_32_64")


def test_phase_decode_tiny(code):
    out = cs.phase_decode(code, batch=256, iterations=5, subset=256,
                          oracle_frames=32)
    assert set(out) == {f"block_32_64/{m}/{f}" for m in ("minsum", "sumproduct")
                        for f in ("early", "fixed")}
    assert all(r["route"] == "xla" and r["mismatch_vs_xla"] == 0
               for r in out.values())


def test_phase_receiver_tiny(code):
    rec = cs.phase_receiver(code, n_frames=2048)
    assert rec["lock"] == [17, True] and rec["n_frames"] == 2048


def test_phase_sweep_tiny(code):
    out = cs.phase_sweep(code, frames_per_device=2048)
    assert len(out) == 4


def test_phase_chain_tiny(code):
    rec = cs.phase_chain(code, n_frames=2048)
    assert rec["locked"] and rec["first_frame_sent_index"] is not None


def test_phase_multi_on_four_virtual_devices(code):
    rec = cs.phase_multi(code, jax.devices()[:4], frames_per_device=64)
    assert rec["mismatch_frames"] == 0 and rec["weights_equal"]


def test_count_band_contains_record_rate():
    lo, hi = cs._count_band((1000, 10**6), 10**5)
    assert lo < 100 < hi


def test_check_raises():
    with pytest.raises(RuntimeError, match="FAILED x"):
        cs.check(False, "x", {})


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_without_gpu():
    proc = _run([str(REPO / "chip_smoke.py")], REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "no GPU" in proc.stderr


def test_fails_alone_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
