"""Guards of how the suite's files reach the CPU beside its longest test.

The run's length is set by one test of the JAX reference,
``test_exactf64.py::test_sequential_scan_matches_numpy`` (81,920 eager
software-f64 adds in a row), and by the load beside it. pytest-xdist's
``--dist loadfile`` hands out whole files, largest first and ties in
collection order, so a port file with more than ten tests is handed out
before the chain's file and delays it. Each test asserts the no-op where
its condition does not apply."""

from collections import Counter

import jax

CHAIN_FILE = "test_exactf64.py"
#: port files that may hold more than ten tests: they take seconds (the
#: tests of ``test_torch_gpu.py`` skip without a card)
SHORT_PORT_FILES = {"test_torch_gpu.py", "test_torch_cli.py"}


def _sizes(request) -> Counter:
    """Collected tests per file, in collection order."""
    return Counter(item.path.name for item in request.session.items)


def test_jax_sees_eight_cpu_devices():
    assert jax.default_backend() == "cpu"
    assert jax.device_count() == 8


def test_no_slow_port_file_holds_more_than_ten_tests(request):
    sizes = _sizes(request)
    big = [
        name for name, n in sizes.items()
        if name.startswith("test_torch_") and n > 10
        and name not in SHORT_PORT_FILES
    ]
    assert big == []


def test_no_slow_port_file_is_handed_out_before_the_chain(request):
    sizes = _sizes(request)
    queue = sorted(sizes, key=lambda name: -sizes[name])  # stable
    ahead = queue[: queue.index(CHAIN_FILE)] if CHAIN_FILE in sizes else []
    slow = [
        name for name in ahead
        if name.startswith("test_torch_") and name not in SHORT_PORT_FILES
    ]
    assert slow == []
