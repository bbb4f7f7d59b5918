"""The host side of a run: the CPUs next to the cards, the set-up line, and
the collector's pauses in the window."""
import gc

import pytest

from portbench import host


def test_cpu_lists_read_and_write():
    assert host.parse_cpulist("0-3,8,10-11\n") == {0, 1, 2, 3, 8, 10, 11}
    assert host.cpulist({0, 1, 2, 3, 8, 10, 11}) == "0-3,8,10-11"
    assert host.cpulist(host.parse_cpulist("5")) == "5"
    assert host.cpulist(set()) == ""
    with pytest.raises(ValueError):
        host.parse_cpulist("3-1")


def _card(root, bus, text):
    (root / bus).mkdir(parents=True)
    (root / bus / "local_cpulist").write_text(text)


def test_card_local_lists_are_read_from_sysfs(tmp_path):
    _card(tmp_path, "0000:19:00.0", "0-3\n")
    _card(tmp_path, "0000:3b:00.0", "8-9\n")
    assert host.card_local(["0000:19:00.0"], tmp_path) == {0, 1, 2, 3}
    assert host.card_local(["0000:19:00.0", "0000:3b:00.0"], tmp_path) == {0, 1, 2, 3, 8, 9}
    # a card whose list cannot be read, or no card: unknown
    assert host.card_local(["0000:19:00.0", "0000:99:00.0"], tmp_path) is None
    assert host.card_local([], tmp_path) is None
    _card(tmp_path, "0000:5e:00.0", "garbage")
    assert host.card_local(["0000:5e:00.0"], tmp_path) is None


def _smi(monkeypatch, text):
    class Out:
        stdout = text

    monkeypatch.setattr(host.subprocess, "run", lambda *a, **k: Out())


def test_bus_ids_follow_cuda_visible_devices(monkeypatch):
    _smi(monkeypatch, "0, 00000000:19:00.0\n1, 00000000:3B:00.0\n")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert host.card_bus_ids(1) == ["0000:19:00.0"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1,0")
    assert host.card_bus_ids(2) == ["0000:3b:00.0", "0000:19:00.0"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "GPU-1234")
    assert host.card_bus_ids(1) == []


def test_a_card_without_a_bus_id_is_unknown(monkeypatch, tmp_path):
    """A virtual machine's nvidia-smi may give no bus id ([N/A])."""
    _smi(monkeypatch, "0, [N/A]\n")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(host, "PCI", tmp_path)
    assert host.card_bus_ids(1) == []
    assert "card-local unknown" in host.line(1)


def test_without_nvidia_smi_the_card_is_unknown(monkeypatch):
    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(host.subprocess, "run", missing)
    assert host.card_bus_ids(1) == []
    line = host.line(1)
    assert line.startswith("host: allowed CPUs ") and "card-local unknown" in line


def test_the_line_names_the_cards_local_cpus(monkeypatch, tmp_path):
    monkeypatch.setattr(host, "PCI", tmp_path)
    _card(tmp_path, "0000:19:00.0", "4-11")
    monkeypatch.setattr(host.os, "sched_getaffinity", lambda pid: set(range(8)))
    monkeypatch.setattr(host.os, "getloadavg", lambda: (1.0, 0.5, 0.25))
    assert host.line(1, ["0000:19:00.0"]) == (
        "host: allowed CPUs 0-7 (8), affinity as started, card-local 4-11, "
        "load average 1.00 0.50 0.25")


def test_the_gc_watch_counts_collections():
    with host.GcWatch() as w:
        gc.collect()
        gc.collect(0)
    assert w.count[2] >= 1 and w.count[0] >= 1 and w.seconds >= 0
    assert w.line().startswith("gc in window: ")
    n = sum(w.count)
    gc.collect()  # outside: not counted
    assert sum(w.count) == n
