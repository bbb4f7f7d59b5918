import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without a card")


@pytest.fixture(autouse=True)
def _one_thread():
    """The harness's CPU runs at a test's size gain nothing from threads;
    one keeps them from crowding the tests that run beside them."""
    torch = pytest.importorskip("torch")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StepClock:
    """The serving window's clock in the tests: every reading moves it 10 ms,
    so a window of a few seconds holds the same steps however loaded the
    CPU is (the engine's own stamps keep the real clock)."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self) -> float:
        self.t += 0.01
        return self.t


@pytest.fixture(autouse=True)
def _step_clock(monkeypatch):
    pytest.importorskip("torch")
    from portbench import serving

    monkeypatch.setattr(serving, "time", StepClock())
