"""Compiled kernels on the GPU (marker ``gpu``; skips without a card).

The suite's conftest pins this process to the CPU, so the card is reached
from a child process with a clean JAX configuration. The fixture asks the
child which platform JAX finds and skips unless it is a GPU. On the card:

    python -m pytest tests/test_gpu.py

The full on-card checks are chip_smoke.py's phases; this test runs phase
(a) at a 4096-frame batch: the default route (the Triton kernel) against
the XLA f32 decoder and the float64 oracle, both BP methods, both loop
forms, with chip_smoke's tolerances.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _child_env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    return env


@pytest.fixture
def gpu_child():
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        capture_output=True, text=True, env=_child_env(), timeout=300)
    platform = out.stdout.strip().splitlines()[-1] if out.stdout else "none"
    if platform != "gpu":
        pytest.skip(f"no GPU: JAX finds platform {platform!r}")
    return _child_env()


@pytest.mark.gpu
def test_compiled_kernels_match_xla_on_gpu(gpu_child):
    code = ("import sys; sys.path.insert(0, %r); import chip_smoke as cs; "
            "cs.phase_decode(cs.get_code('block_32_64'), batch=4096, "
            "oracle_frames=512)" % str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=gpu_child, timeout=1500)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
