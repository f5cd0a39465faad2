"""The benchmark's CPU tests: ``python -m pytest -q perfbench/tests``
from the root of the repository (``-m cuda`` for the on-card ones)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    # several test processes share the machine: a few threads each
    import torch
    torch.set_num_threads(2)


import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _own_trace_file(tmp_path, monkeypatch):
    """Each test process writes the profiler's trace to its own file."""
    from perfbench import harness
    monkeypatch.setattr(harness, "TRACE_FILE", tmp_path / "trace.json")
