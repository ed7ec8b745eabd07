"""Test harness: force an 8-virtual-device CPU backend so sharding tests run
without accelerator hardware (SURVEY.md §4's 'fake backend').

A pytest plugin may import jax before this conftest runs, so the platform
is also set through ``jax.config``, which takes effect because no backend
has been initialized yet at collection time. Code that needs the GPU is
driven outside pytest (``chip_smoke.py``, ``bench.py``).
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Under ``-n N --dist loadfile`` xdist runs each file's tests on one worker,
# and hands out files with the most tests first. The full-CLI runs of
# test_nsh_bag.py take most of the suite's wall time (two 230-frame LIO
# drives of several minutes each on the CPU), so each of them is a unit of
# its own, handed out before every file.
_OWN_UNITS = ("tests/test_nsh_bag.py::test_full_cli_on_nsh_bag",
              "tests/test_nsh_bag.py::test_dropped_and_out_of_order_cli",
              "tests/test_nsh_bag.py::test_nsh_64ring_cli")


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class LongestFirst(LoadFileScheduling):
        def _split_scope(self, nodeid):
            if nodeid in _OWN_UNITS:
                return nodeid
            return super()._split_scope(nodeid)

        def _assign_work_unit(self, node):
            for unit in reversed(_OWN_UNITS):
                if unit in self.workqueue:
                    self.workqueue.move_to_end(unit, last=False)
            super()._assign_work_unit(node)

    return LongestFirst(config, log)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Release compiled executables between test modules.

    The full suite compiles hundreds of large 8-device CPU programs in one
    process; past ~150 tests the XLA:CPU compiler segfaults
    non-deterministically inside backend_compile_and_load (reproduced twice
    at different tests, never in isolation or in an ~40-test subset).
    Dropping the in-process executable cache at module boundaries bounds
    the accumulation; per-module recompiles are seconds on CPU."""
    yield
    jax.clear_caches()
