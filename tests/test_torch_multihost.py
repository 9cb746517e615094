"""Two OS processes form one torch.distributed world (gloo, a local
coordinator, the CPU) and search one sharded index together: the port's
twin of tests/test_multihost.py. The work lives in
rabitq_tpu_torch/tools/multihost_demo.py (also runnable by hand); each
worker holds the world's merged top-k against the one-process sharded
search and prints PARITY OK. Every wait is bounded: the workers' process
group (90 s), the demo's wait on them and this test's on the demo."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_two_process_world_sharded_search_parity():
    out = subprocess.run(
        [sys.executable, "-m", "rabitq_tpu_torch.tools.multihost_demo",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert out.returncode == 0, (out.stdout, out.stderr[-2000:])
    assert out.stdout.count("PARITY OK") == 2, out.stdout
    assert "backend gloo" in out.stderr


def test_demo_defaults_to_the_card():
    """Without --device the demo asks for the card, and on a host without
    one it raises before it starts a worker."""
    import pytest
    import torch

    from rabitq_tpu_torch.tools import multihost_demo

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost_demo.run()
