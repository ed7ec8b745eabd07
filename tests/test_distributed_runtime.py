"""parallel.runtime.initialize is explicit-only: no coordinator, no
jax.distributed call; a coordinator without a process count is an error."""

import jax
import pytest

from msf_loam_tpu.parallel import runtime


def _refuse(**kwargs):
    raise AssertionError("jax.distributed.initialize must not be called")


def test_initialize_without_coordinator_is_a_noop(monkeypatch):
    for name in ("MSF_COORD", "MSF_NUM_PROCESSES", "MSF_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(jax.distributed, "initialize", _refuse)
    monkeypatch.setattr(runtime, "_initialized", False)
    assert runtime.initialize() is False


def test_initialize_with_coordinator_but_no_count_raises(monkeypatch):
    monkeypatch.setenv("MSF_COORD", "localhost:12399")
    monkeypatch.delenv("MSF_NUM_PROCESSES", raising=False)
    monkeypatch.setattr(jax.distributed, "initialize", _refuse)
    monkeypatch.setattr(runtime, "_initialized", False)
    with pytest.raises(ValueError):
        runtime.initialize()
