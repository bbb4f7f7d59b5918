"""Port parity: the static analyzer (``repro_torch.analysis``: the
guarded-by, lock-order and fork-safety AST passes) against the JAX
package's.

Each fixture under ``tests/fixtures/analysis/`` trips exactly its rule
under the port's passes; the port's findings over the reference's
``core/`` and over the fixtures equal the reference's, computed in a
spawned child (``torch_jaxref``); the live gate holds the port's own
``core/`` to the root's ``ANALYSIS_BASELINE.json``; and the CLI's
``--check`` exits 0 over it.
"""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from torch_jaxref import Reference
from repro_torch.analysis import (
    RULES,
    analyze_paths,
    diff_baseline,
    load_baseline,
    write_baseline,
)
from repro_torch.analysis.__main__ import main as analysis_main

JAX = Reference()
_reference_child = JAX.fixture()

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO_ROOT, "tests", "fixtures", "analysis")
BASELINE = os.path.join(REPO_ROOT, "ANALYSIS_BASELINE.json")

_FIXTURE_RULES = [
    "GB101", "GB102", "GB103", "GB104",
    "LK201", "LK202", "LK203",
    "FS301", "FS302", "FS303",
    "AN001", "AN002",
]


def _analyze_fixture(name):
    return analyze_paths([os.path.join(FIXTURES, name)], root=REPO_ROOT)


# ------------------------------------------------------------- rule fixtures
@pytest.mark.parametrize("rule", _FIXTURE_RULES)
def test_bad_fixture_triggers_exactly_its_rule(rule):
    findings = _analyze_fixture(f"bad_{rule.lower()}.py")
    assert findings, f"fixture for {rule} produced no findings"
    assert {f.rule for f in findings} == {rule}
    assert rule in RULES


def test_good_fixture_is_clean():
    assert _analyze_fixture("good.py") == []


# ------------------------------------------------- parity with the reference
@pytest.mark.parametrize("rel", [os.path.join("src", "repro", "core"),
                                 os.path.join("src", "repro_torch", "core"),
                                 os.path.join("tests", "fixtures", "analysis")])
def test_findings_equal_reference(rel):
    """The port's passes find what the reference's find, finding for
    finding (rule, path, line, scope, message), over the reference's core,
    the port's core and every fixture."""
    ours = [f.to_dict() for f in analyze_paths([rel], root=REPO_ROOT)]
    assert ours == JAX("analysis_findings", [rel], REPO_ROOT)
    if rel.endswith("analysis"):
        assert {f["rule"] for f in ours} == set(_FIXTURE_RULES)


# ------------------------------------------------- live-tree regression gate
def test_port_core_is_clean_against_baseline():
    """With no paths the port's analyzer reads ``src/repro_torch/core``:
    no finding beyond the committed baseline (which holds none)."""
    findings = analyze_paths(None, root=REPO_ROOT)
    new, _stale = diff_baseline(findings, load_baseline(BASELINE))
    assert new == [], "new findings outside baseline:\n" + "\n".join(f.render() for f in new)


def test_default_target_is_the_ports_core(tmp_path):
    """A finding planted in a copy of the tree shows that the default
    target is ``src/repro_torch/core``, not the reference's."""
    core = tmp_path / "src" / "repro_torch" / "core"
    core.mkdir(parents=True)
    with open(os.path.join(FIXTURES, "bad_gb101.py")) as f:
        (core / "planted.py").write_text(f.read())
    findings = analyze_paths(None, root=str(tmp_path))
    assert {f.rule for f in findings} == {"GB101"}
    assert {f.path for f in findings} == {os.path.join("src", "repro_torch", "core",
                                                       "planted.py")}


def test_cli_check_exits_zero_over_the_ports_core():
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--check"],
                         cwd=REPO_ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": os.path.join(REPO_ROOT, "src")})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 new vs baseline" in out.stdout


def test_cli_check_fails_on_new_finding(tmp_path, capsys):
    bad = os.path.join(FIXTURES, "bad_gb101.py")
    rc = analysis_main([bad, "--check", "--baseline", str(tmp_path / "missing.json")])
    assert rc == 2
    assert "GB101" in capsys.readouterr().out


def test_cli_write_baseline_then_check_passes(tmp_path, capsys):
    bad = os.path.join(FIXTURES, "bad_gb101.py")
    base = str(tmp_path / "base.json")
    assert analysis_main([bad, "--write-baseline", "--baseline", base]) == 0
    assert analysis_main([bad, "--check", "--baseline", base]) == 0
    # fixed finding -> stale baseline entry is warned about, not fatal
    good = os.path.join(FIXTURES, "good.py")
    assert analysis_main([good, "--check", "--baseline", base]) == 0
    assert "stale" in capsys.readouterr().out


def test_cli_json_report_and_rules(capsys):
    bad = os.path.join(FIXTURES, "bad_lk202.py")
    assert analysis_main([bad, "--json"]) == 0
    data = json.loads(capsys.readouterr().out)
    assert data["summary"]["total"] == 1
    assert data["findings"][0]["rule"] == "LK202"
    assert analysis_main(["--rules"]) == 0
    out = capsys.readouterr().out
    assert all(rule in out for rule in RULES)


def test_baseline_round_trip(tmp_path):
    findings = _analyze_fixture("bad_gb101.py")
    path = str(tmp_path / "base.json")
    write_baseline(path, findings)
    keys = load_baseline(path)
    assert keys == {f.key() for f in findings}
    new, stale = diff_baseline(findings, keys)
    assert new == [] and stale == set()
