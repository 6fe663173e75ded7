"""PyTorch port: the Dr Hook-analogue profiler (ecrad_tpu_torch/utils/
hooks.py on its native core csrc/host/ecrhook.cc) against the JAX
package's (ecrad_tpu/utils/hooks.py on native/ecrhook.cc), on the CPU.

The same nested scopes through both modules, with ECRAD_HOOK's switch
(LHOOK) turned on, give the same names and call counts, on the native
cores and on the pure-Python accumulators; each scope's self time is at
most its total, and a parent's total at least its children's. The dumps
read back through tools/merge_hook_profiles.py. The fatal-signal
handlers replace the process's own, so they run in a child process.
"""
import glob
import json
import os
import shutil
import signal
import subprocess
import sys

import pytest
import torch

from ecrad_tpu.utils import hooks as jhooks
from ecrad_tpu.utils import native as jnative
from ecrad_tpu_torch.utils import hooks as phooks
from ecrad_tpu_torch.utils import native as pnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import merge_hook_profiles as mhp  # noqa: E402

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no C++ compiler")

# each scope's (calls, parent) in _scopes
SCOPES = {"radiation": (2, None), "gas_optics": (2, "radiation"),
          "solver": (4, "radiation"), "adding": (4, "solver"),
          "flux_sums": (6, "radiation")}


def _scopes(hooks):
    """Two calls of a nested scope sequence, with a little work in each."""
    x = torch.ones(64, 64)
    for _ in range(2):
        with hooks.hook("radiation"):
            with hooks.hook("gas_optics"):
                x = x @ x / 64.0
            for _ in range(2):
                with hooks.hook("solver"):
                    with hooks.hook("adding"):
                        x = x.cumsum(0) / 64.0
            for _ in range(3):
                with hooks.hook("flux_sums"):
                    x.sum()


def _report_rows(hooks):
    """{name: (calls, total_s, self_s)} from the native profile_report's
    columns (name calls total(s) self(s) cpu(s) maxrss(MB))."""
    lines = hooks.profile_report().splitlines()
    assert lines[0].split() == ["name", "calls", "total(s)", "self(s)",
                                "cpu(s)", "maxrss(MB)"]
    rows = {}
    for line in lines[1:]:
        name, calls, total, self_s, _, _ = line.split()
        rows[name] = (int(calls), float(total), float(self_s))
    return rows


def _run_both(monkeypatch, native_on):
    """Turn both modules' hooks on (with or without their native cores),
    run _scopes through each and return their (JAX, port) profile_rows as
    {name: calls}."""
    out = []
    for hooks, native in ((jhooks, jnative), (phooks, pnative)):
        monkeypatch.setattr(hooks, "LHOOK", True)
        if native_on:
            assert native.hook_lib() is not None
        else:
            monkeypatch.setattr(native, "hook_lib", lambda: None)
        hooks.reset_profile()
        _scopes(hooks)
        out.append({name: calls for name, calls, _ in hooks.profile_rows()})
    return out


@needs_gxx
def test_native_accounting_matches_jax(monkeypatch):
    jrows, prows = _run_both(monkeypatch, native_on=True)
    assert prows == jrows == {k: v[0] for k, v in SCOPES.items()}
    assert phooks.profile_report().splitlines()[0] == \
        jhooks.profile_report().splitlines()[0]
    for hooks in (jhooks, phooks):
        rows = _report_rows(hooks)
        assert set(rows) == set(SCOPES)
        for name, (calls, total, self_s) in rows.items():
            # the report prints 4 decimals
            assert self_s <= total + 1e-4, (name, self_s, total)
        for parent in ("radiation", "solver"):
            kids = sum(rows[k][1] for k, (_, p) in SCOPES.items()
                       if p == parent)
            assert rows[parent][1] >= kids - 1e-4 * len(SCOPES), parent
    assert pnative.hook_lib().ecr_hook_stack_depth() == 0


@needs_gxx
def test_dumps_merge_to_the_same_rows(monkeypatch, tmp_path):
    _run_both(monkeypatch, native_on=True)
    parsed = []
    for hooks, rank in ((jhooks, 0), (phooks, 1)):
        path = hooks.dump_profile(str(tmp_path / f"ecrhook.prof.{rank}"))
        wall, rows = mhp.parse_profile(path)
        assert wall == pytest.approx(sum(r[2] for r in rows), abs=1e-5)
        parsed.append((wall, rows))
    (_, jrows), (_, prows) = parsed
    assert sorted((n, c) for n, c, _ in prows) == \
        sorted((n, c) for n, c, _ in jrows)
    acc, wall = mhp.merge(parsed)
    assert wall["nproc"] == 2
    for name, (calls, _) in SCOPES.items():
        assert acc[name]["calls"] == 2 * calls and acc[name]["tasks"] == 2
    report = mhp.format_report(acc, wall, threshold_percent=0.0)
    assert "2 processes" in report and "flux_sums" in report


def test_dump_profile_names_the_file_by_rank(monkeypatch, tmp_path):
    """Without a process group the rank is 0, as the JAX package's
    process_index."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(phooks, "LHOOK", True)
    monkeypatch.setattr(pnative, "hook_lib", lambda: None)
    phooks.reset_profile()
    with phooks.hook("scope_a"):
        pass
    assert phooks.dump_profile() == "ecrhook.prof.0"
    with open(tmp_path / "ecrhook.prof.0") as f:
        assert f.readline().startswith("# ecrhook profile process=0 ")
    assert [r[:2] for r in mhp.parse_profile("ecrhook.prof.0")[1]] == [
        ("scope_a", 1)]


def test_python_accumulators_match_jax(monkeypatch):
    jrows, prows = _run_both(monkeypatch, native_on=False)
    assert prows == jrows == {k: v[0] for k, v in SCOPES.items()}
    lines = phooks.profile_report().splitlines()
    assert lines[0] == jhooks.profile_report().splitlines()[0]
    assert len(lines) == 1 + len(SCOPES)
    phooks.reset_profile()
    assert phooks.profile_rows() == []


def test_hooks_off_account_nothing(monkeypatch):
    monkeypatch.setattr(phooks, "LHOOK", False)
    phooks.reset_profile()
    _scopes(phooks)
    assert phooks.profile_rows() == []


@needs_gxx
def test_signal_handlers_dump_the_hook_stack():
    """A child enters two scopes and sends itself SIGSEGV: the native
    handler prints the active scopes innermost first, then the signal's
    default action ends the child."""
    code = (
        "import os, signal, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from ecrad_tpu_torch.utils import hooks\n"
        "assert hooks.LHOOK and hooks.install_signal_handlers()\n"
        "with hooks.hook('outer_scope'):\n"
        "    with hooks.hook('inner_scope'):\n"
        "        os.kill(os.getpid(), signal.SIGSEGV)\n")
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONFAULTHANDLER"}
    env["ECRAD_HOOK"] = "1"
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == -signal.SIGSEGV, (res.returncode, res.stderr)
    err = res.stderr
    assert "[ecrhook] caught signal" in err, err
    assert 0 <= err.index("at inner_scope") < err.index("at outer_scope")


def test_trace_holds_the_hook_spans(monkeypatch, tmp_path):
    """start_trace / stop_trace on the CPU: the trace file holds each
    hook's span, with the hooks off and on."""
    for lhook in (False, True):
        logdir = tmp_path / str(lhook)
        monkeypatch.setattr(phooks, "LHOOK", lhook)
        phooks.start_trace(str(logdir))
        with phooks.hook("traced_scope"):
            torch.ones(16).sum()
        phooks.stop_trace()
        files = glob.glob(str(logdir / "*.pt.trace.json"))
        assert len(files) == 1, files
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("name") == "traced_scope" for e in events)
    with pytest.raises(RuntimeError):
        phooks.stop_trace()
