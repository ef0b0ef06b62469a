import os
import sys

_HERE = os.path.dirname(__file__)
sys.path.insert(0, os.path.join(_HERE, "..", "src"))

# Gate the optional `hypothesis` dependency: when the real package is
# missing, register the deterministic stub so test_formats still collects
# and its property tests still run (container policy: gate, don't install).
try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    if _HERE not in sys.path:
        sys.path.insert(0, _HERE)
    import _hypothesis_stub
    sys.modules["hypothesis"] = _hypothesis_stub
    sys.modules["hypothesis.strategies"] = _hypothesis_stub.strategies

import pytest

# XLA locks the host device count at first backend init, so the choice has
# to happen here, before any test module imports jax:
#  * default runs: smoke tests and benches must see exactly 1 device (the
#    dry-run and the subprocess-based tests in test_dist.py set their own
#    flags in child processes); a stray XLA_FLAGS must not leak in.
#  * `-m dist` (and friends) opt IN to 8 in-process virtual devices so
#    sharding tests can run without subprocess round-trips.
_DIST_XLA_FLAGS = "--xla_force_host_platform_device_count=8"


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "dist: multi-device / sharding tests (opt out with -m 'not dist'; "
        "in-process cases get 8 virtual CPU devices via -m dist)")
    config.addinivalue_line(
        "markers",
        "multihost: N-process jax.distributed fault-tolerance tests "
        "(subprocess-heavy; opt in with -m multihost)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the PyTorch port's kernels); skipped "
        "without one")
    markexpr = config.getoption("markexpr", "") or ""
    if "dist" in markexpr and "not dist" not in markexpr:
        os.environ["XLA_FLAGS"] = _DIST_XLA_FLAGS
    else:
        os.environ.pop("XLA_FLAGS", None)
    if "multihost" in markexpr and "not multihost" not in markexpr:
        # consumed by the skipif guard in test_multihost.py; the spawned
        # ranks themselves are configured via REPRO_* by dist_launch
        os.environ["REPRO_MULTIHOST_TESTS"] = "1"


@pytest.fixture(scope="session")
def eight_virtual_devices():
    """8 in-process virtual CPU devices for mesh tests.

    Usable only when the backend was initialized with the forced device
    count (i.e. under `-m dist`); otherwise the test is skipped rather
    than run against a 1-device mesh.
    """
    import jax

    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices — run with -m dist "
                    f"(or XLA_FLAGS={_DIST_XLA_FLAGS})")
    return jax.devices()[:8]
