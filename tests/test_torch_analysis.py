"""The port's tentlint (`repro_torch.analysis`): per-rule fixture pins,
suppression/baseline round trips, fingerprint stability, CLI exit codes,
the @hot_path marker and the runtime sanitizer, as the reference's
`tests/test_analysis.py` holds its own; then the port's linter against the
reference's, finding for finding, for the four rules carried over as they
are; the CUDA half of fma-hazard on a fixture project and on single lines;
torch's global generator and fused ops; name-valued twin registries; the
port's whole tree under --strict; and the chip script's lint phase
rehearsed on the CPU with the kernel libraries' loads recorded but not
built."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from repro.analysis.core import Project as RefProject
from repro.analysis.core import iter_python_files as ref_iter_python_files
from repro.analysis.core import run_rules as ref_run_rules
from repro.analysis.lint import DEFAULT_PATHS as REF_DEFAULT_PATHS
from repro.analysis.rules import default_rules as ref_default_rules
from repro_torch.analysis import hot_path, is_hot_path
from repro_torch.analysis.baseline import Baseline, apply_baseline
from repro_torch.analysis.core import Project, iter_source_files, run_rules
from repro_torch.analysis.lint import DEFAULT_BASELINE, DEFAULT_PATHS, main, run_lint
from repro_torch.analysis.rules import ALL_RULES, NoWallClock, cuda_builds, default_rules
from repro_torch.analysis.sanitize import (
    DYNAMIC_ALLOWLIST,
    SanitizerError,
    enabled,
    maybe_sanitized,
    sanitized,
)
from repro_torch.kernels import build

REPO_ROOT = Path(__file__).resolve().parents[1]
FIXTURES = REPO_ROOT / "tests" / "fixtures" / "lint"  # the reference's, read only
TORCH_FIXTURES = REPO_ROOT / "tests" / "fixtures" / "lint_torch"
# the rules the port carries over as they are, whose findings must be the
# reference linter's on the same files
CARRIED_RULES = ("no-wall-clock", "no-global-rng", "unordered-iter", "hot-path-alloc")
LIBRARIES = ("flash_attention", "ssd_scan", "kv_pack", "tent_core", "spray_sim")


def lint_fixture(name, rules=None, root=FIXTURES):
    """Lint one fixture file as if it were engine source."""
    project = Project(root, [root / name], src_prefixes=("",),
                      test_markers=("tests/",))
    return run_rules(project, default_rules(rules))


def lint_tree(root, rules):
    """Lint a fixture project (every source under `root`) as engine source."""
    project = Project(root, iter_source_files([root], root), src_prefixes=("",))
    return run_rules(project, default_rules(rules)), project


def _key(f):
    return (f.rule, f.path, f.line, f.col, f.fingerprint, f.suppressed)


# ---------------------------------------------------------------------------
# per-rule fixture pins: each violation class fails with the right rule id
# ---------------------------------------------------------------------------

class TestRuleFixtures:
    def test_no_wall_clock_flags_bad_fixture(self):
        found = lint_fixture("bad_wall_clock.py", rules=["no-wall-clock"])
        assert len(found) == 4
        assert {f.rule for f in found} == {"no-wall-clock"}
        assert all(f.active for f in found)

    def test_no_wall_clock_passes_clean_fixture(self):
        assert lint_fixture("clean_wall_clock.py",
                            rules=["no-wall-clock"]) == []

    def test_no_global_rng_flags_bad_fixture(self):
        found = lint_fixture("bad_global_rng.py", rules=["no-global-rng"])
        assert {f.rule for f in found} == {"no-global-rng"}
        assert len(found) == 6  # rand, seed, random + id/hash/time seeds
        assert sum("nondeterministic seed" in f.message for f in found) == 3

    def test_no_global_rng_passes_clean_fixture(self):
        assert lint_fixture("clean_global_rng.py",
                            rules=["no-global-rng"]) == []

    def test_fma_hazard_flags_bad_fixture(self):
        found = lint_fixture("bad_fma.py", rules=["fma-hazard"], root=TORCH_FIXTURES)
        assert {f.rule for f in found} == {"fma-hazard"}
        # torch.compile bare and called, jit.script, triton.jit, partial, jit.trace
        assert [f.line for f in found] == [11, 16, 21, 26, 31, 35]
        assert not any(f.line > 40 for f in found)  # int product unflagged

    def test_fma_hazard_passes_clean_fixture(self):
        assert lint_fixture("clean_fma.py", rules=["fma-hazard"],
                            root=TORCH_FIXTURES) == []

    def test_unordered_iter_flags_bad_fixture(self):
        found = lint_fixture("bad_unordered.py", rules=["unordered-iter"])
        assert {f.rule for f in found} == {"unordered-iter"}
        assert len(found) == 4

    def test_unordered_iter_passes_clean_fixture(self):
        assert lint_fixture("clean_unordered.py",
                            rules=["unordered-iter"]) == []

    def test_hot_path_alloc_flags_bad_fixture(self):
        found = lint_fixture("bad_hotpath.py", rules=["hot-path-alloc"])
        assert {f.rule for f in found} == {"hot-path-alloc"}
        assert len(found) == 4  # lambda, partial, comprehension, nested def

    def test_hot_path_alloc_passes_clean_fixture(self):
        assert lint_fixture("clean_hotpath.py",
                            rules=["hot-path-alloc"]) == []

    def test_twin_drift_mini_project(self):
        found, _ = lint_tree(TORCH_FIXTURES / "twinproj", ["twin-drift"])
        assert {f.rule for f in found} == {"twin-drift"}
        assert {f.path for f in found} == {"pkg/kernel.py"}
        by_msg = {f.message.split("`")[1]: f.message for f in found}
        assert set(by_msg) == {"missing", "drifted", "bare_waiver", "orphan",
                               "untested", "lonely_torch"}
        assert "no def in pkg/kernel.py or its package" in by_msg["missing"]
        assert "('x', 'alpha') != ('x', 'beta')" in by_msg["drifted"]
        assert "carries no reason" in by_msg["bare_waiver"]
        assert "no twin" in by_msg["orphan"] and "no twin" in by_msg["lonely_torch"]
        assert "no parity test" in by_msg["untested"]


# ---------------------------------------------------------------------------
# the port's own checks: torch's compilers, fused ops and global generator
# ---------------------------------------------------------------------------

class TestTorchRules:
    def test_fused_ops_flagged_in_bit_exact_modules(self):
        found = lint_fixture("core/bad_fused.py", rules=["fma-hazard"],
                             root=TORCH_FIXTURES)
        assert [f.line for f in found] == [8, 9, 10, 11, 12]
        assert [f.message.split("`")[1] for f in found] == [
            "addcmul", "lerp", "addcdiv_", "addmm", "lerp"]

    def test_fused_ops_pass_outside_bit_exact_modules(self):
        assert lint_fixture("models/clean_fused.py", rules=["fma-hazard"],
                            root=TORCH_FIXTURES) == []

    def test_torch_global_rng_flags_bad_fixture(self):
        found = lint_fixture("bad_torch_rng.py", rules=["no-global-rng"],
                             root=TORCH_FIXTURES)
        assert [f.line for f in found] == [8, 9, 10, 11, 12, 17, 18]
        assert sum("global generator" in f.message for f in found) == 5
        assert sum("nondeterministic seed" in f.message for f in found) == 2

    def test_torch_global_rng_passes_clean_fixture(self):
        assert lint_fixture("clean_torch_rng.py", rules=["no-global-rng"],
                            root=TORCH_FIXTURES) == []

    def test_kernel_registries_name_real_entries(self):
        """The port's twin registries: every key a def, every twin found,
        no pragma needed, and every waiver with its reason."""
        import importlib

        found, _, _ = run_lint(REPO_ROOT, [REPO_ROOT / p for p in DEFAULT_PATHS],
                               rules=["twin-drift"])
        assert found == []
        for lib in LIBRARIES:
            mod = importlib.import_module(f"repro_torch.kernels.{lib}.kernel")
            for key, entry in mod.__torch_twins__.items():
                twin, *reason = entry if isinstance(entry, tuple) else (entry,)
                assert callable(twin), key
                assert all(r.strip() for r in reason), key


# ---------------------------------------------------------------------------
# the port's linter against the reference's, finding for finding
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_tree():
    """The reference tree parsed by both linters, src/repro/ as source."""
    paths = [REPO_ROOT / p for p in REF_DEFAULT_PATHS if (REPO_ROOT / p).exists()]
    ref = RefProject(REPO_ROOT, ref_iter_python_files(paths, REPO_ROOT),
                     src_prefixes=("src/repro/",))
    port = Project(REPO_ROOT, iter_source_files(paths, REPO_ROOT),
                   src_prefixes=("src/repro/",))
    return ref, port


@pytest.mark.parametrize("scope", ["fixtures", "tree"])
@pytest.mark.parametrize("rule", CARRIED_RULES)
def test_carried_rules_match_the_reference(rule, scope, reference_tree):
    if scope == "fixtures":
        files = sorted(FIXTURES.rglob("*.py"))
        ref = RefProject(FIXTURES, files, src_prefixes=("",))
        port = Project(FIXTURES, files, src_prefixes=("",))
    else:
        ref, port = reference_tree
    want = [_key(f) for f in ref_run_rules(ref, ref_default_rules([rule]))]
    got = [_key(f) for f in run_rules(port, default_rules([rule]))]
    assert got == want
    if scope == "fixtures":
        assert want, f"{rule} finds nothing in the fixtures: the comparison is empty"


# ---------------------------------------------------------------------------
# fma-hazard's CUDA half: sources, headers and the flags nvcc gets
# ---------------------------------------------------------------------------

def _cuda_project(tmp_path, body, flags=()):
    """A one-library project: `k.cu` holding `body`, built with `flags`."""
    (tmp_path / "build.py").write_text(
        'NVCC_FLAGS = ("-O3",)\n\n\ndef load_library(name, sources, extra_flags=()):\n'
        "    return name\n")
    (tmp_path / "kernel.py").write_text(
        f"from .build import load_library\n\nFLAGS = {tuple(flags)!r}\n"
        'LIB = load_library("k", ["k.cu"], extra_flags=FLAGS)\n')
    (tmp_path / "k.cu").write_text(body)
    return lint_tree(tmp_path, ["fma-hazard"])


CUDA_LINES = {
    "double_product": ("double a, b, c, r; r = a * b + c;", (), 1),
    "fmad_off": ("double a, b, c, r; r = a * b + c;", ("--fmad=false",), 0),
    "rounded_by_hand": ("double a, b, c, r; r = __dadd_rn(__dmul_rn(a, b), c);", (), 0),
    "int_index": ("int pc, c; double* x; double r = x[8 * pc + c];", (), 0),
    "float_product": ("float a, b, c, r; r = a * b + c;", (), 0),
    "double_in_comment": ("// a double-buffered ring\nfloat a, b, c, r; r = a * b + c;", (), 0),
    "subtracted_cast": ("int n; float y; double r = y - (double)n * 0.5;", (), 1),
    "accumulated": ("double acc, x; acc += x * x;", (), 1),
}


@pytest.mark.parametrize("case", sorted(CUDA_LINES))
def test_cuda_line(case, tmp_path):
    line, flags, want = CUDA_LINES[case]
    found, _ = _cuda_project(tmp_path, f"__global__ void f() {{\n  {line}\n}}\n", flags)
    assert len(found) == want
    assert all(f.path == "k.cu" and f.active for f in found)


def test_cuda_pragma_suppresses(tmp_path):
    found, _ = _cuda_project(
        tmp_path, "double a, b, c, r;\nr = a * b + c;  // tentlint: disable=fma-hazard\n")
    assert [(f.line, f.suppressed) for f in found] == [(2, True)]


def test_cuda_pragma_in_string_literal_is_ignored(tmp_path):
    found, _ = _cuda_project(
        tmp_path, 'const char* s = "// tentlint: disable-file=fma-hazard";\n'
                  "double a, b, c, r;\nr = a * b + c;\n")
    assert [(f.line, f.active) for f in found] == [(3, True)]


def test_cuda_fixture_project():
    """A library built with contraction, its header, a strict library and a
    source no call builds."""
    found, project = lint_tree(TORCH_FIXTURES / "cudaproj", ["fma-hazard"])
    assert cuda_builds(project) == {
        "contracted": (("contracted.cu",), ("-O3", "-shared")),
        "strict": (("strict.cu",), ("-O3", "-shared", "--fmad=false"))}
    assert [(f.path, f.line, f.suppressed) for f in found] == [
        ("csrc/contracted.cu", 6, False), ("csrc/contracted.cu", 12, True),
        ("csrc/helpers.cuh", 3, False), ("csrc/orphan.cu", 1, False)]
    assert "`contracted` builds without --fmad=false" in found[0].message
    assert "no load_library call builds" in found[-1].message


def test_unreadable_flags_are_a_finding(tmp_path):
    (tmp_path / "kernel.py").write_text(
        "from build import load_library, make_flags\n\n"
        'LIB = load_library("k", ["k.cu"], extra_flags=make_flags())\n')
    found, project = lint_tree(tmp_path, ["fma-hazard"])
    assert [(f.path, f.line) for f in found] == [("kernel.py", 3)]
    assert cuda_builds(project) == {}


def _port_builds():
    """The five libraries as the kernel modules load them: the build
    module's flags, then each module's own."""
    from repro_torch.kernels.spray_sim import kernel as sim_kernel
    from repro_torch.kernels.tent_core import kernel as tc_kernel

    extra = {"tent_core": tc_kernel.EXTRA_FLAGS, "spray_sim": sim_kernel.EXTRA_FLAGS}
    return {name: ((f"{name}.cu",), build.NVCC_FLAGS + extra.get(name, ()))
            for name in LIBRARIES}


def test_cuda_builds_reads_the_port_s_flags():
    project = Project(REPO_ROOT, iter_source_files([REPO_ROOT / "src" / "repro_torch"],
                                                   REPO_ROOT))
    assert cuda_builds(project) == _port_builds()
    assert "--fmad=false" in cuda_builds(project)["tent_core"][1]


class _FakeLibrary:
    """Stands in for a loaded CUDA library: any symbol, any argtypes."""

    def __getattr__(self, name):
        fn = type("Symbol", (), {})()
        setattr(self, name, fn)
        return fn


@pytest.fixture
def recorded_loads(monkeypatch, tmp_path):
    """Each kernel module's `load()` through `build.load_library` with the
    compile and the dlopen stubbed: the libraries are recorded, not built."""
    import importlib

    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "_builds", {})
    monkeypatch.setattr(build, "library_path",
                        lambda name, sources, extra_flags=(): tmp_path / f"{name}.so")
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: _FakeLibrary())
    for name in LIBRARIES:
        (tmp_path / f"{name}.so").write_bytes(b"")
        mod = importlib.import_module(f"repro_torch.kernels.{name}.kernel")
        monkeypatch.setattr(mod, "_lib", None)
        mod.load()
    return build.loaded_builds()


def test_loaded_builds_record_what_the_kernel_modules_load(recorded_loads):
    assert recorded_loads == _port_builds()


def test_chip_smoke_lint_phase_rehearsed(recorded_loads, capsys):
    """chip_smoke.py's lint phase on the CPU: the strict run, the flags the
    rule reads against the loads recorded above, and the sanitized flap."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_lint", REPO_ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    res = cs.phase_lint()
    assert res["counts"] == {"active": 0, "suppressed": 2, "baselined": 0}
    assert res["stale_baseline"] == 0 and res["parse_errors"] == 0
    assert res["files"][".cu"] == 5 and res["files"][".cuh"] == 1
    assert sorted(res["libraries_compared"]) == sorted(LIBRARIES)
    assert res["sanitized"]["violations"] == []
    line = [ln for ln in capsys.readouterr().out.splitlines() if '"phase": "lint"' in ln]
    assert json.loads(line[-1])["wall_s"] == res["wall_s"]


def test_chip_smoke_lint_phase_fails_on_a_flag_difference(recorded_loads, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_lint", REPO_ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    drifted = dict(recorded_loads, tent_core=(("tent_core.cu",), build.NVCC_FLAGS))
    monkeypatch.setattr(cs, "loaded_builds", lambda: drifted)
    with pytest.raises(AssertionError, match="tentlint reads the CUDA builds"):
        cs.phase_lint()


# ---------------------------------------------------------------------------
# suppression pragmas
# ---------------------------------------------------------------------------

class TestSuppression:
    def test_line_and_file_pragmas(self):
        found = lint_fixture("suppressed.py",
                             rules=["no-wall-clock", "no-global-rng"])
        active = [f for f in found if f.active]
        suppressed = [f for f in found if f.suppressed]
        assert len(active) == 1
        assert "perf_counter" in active[0].message
        assert len(suppressed) == 2  # line pragma + disable-file pragma

    def test_pragma_in_string_literal_is_ignored(self, tmp_path):
        f = tmp_path / "strings.py"
        f.write_text(
            's = "# tentlint: disable-file=no-wall-clock"\n'
            "import time\n\n\n"
            "def g():\n    return time.time()\n")
        project = Project(tmp_path, [f], src_prefixes=("",))
        found = run_rules(project, default_rules(["no-wall-clock"]))
        assert len(found) == 1 and found[0].active


# ---------------------------------------------------------------------------
# baseline round-trip + fingerprint stability
# ---------------------------------------------------------------------------

class TestBaseline:
    def _findings(self):
        return lint_fixture("bad_wall_clock.py", rules=["no-wall-clock"])

    def test_round_trip_accepts_then_detects_staleness(self, tmp_path):
        found = self._findings()
        bl = Baseline.from_findings(found)
        path = tmp_path / "baseline.json"
        bl.save(path)
        reloaded = Baseline.load(path)
        assert reloaded.by_fp.keys() == bl.by_fp.keys()

        marked, stale = apply_baseline(found, reloaded)
        assert all(f.baselined for f in marked)
        assert not any(f.active for f in marked)
        assert stale == []

        # against a clean file every entry is stale (debt paid down)
        clean = lint_fixture("clean_wall_clock.py", rules=["no-wall-clock"])
        _, stale = apply_baseline(clean, reloaded)
        assert len(stale) == len(bl.entries)

    def test_reasons_carry_forward(self, tmp_path):
        found = self._findings()
        old = Baseline.from_findings(found)
        for e in old.entries:
            e["reason"] = "justified: " + e["rule"]
        old = Baseline(old.entries)
        new = Baseline.from_findings(found, old)
        assert all(e["reason"].startswith("justified:") for e in new.entries)

    def test_fingerprints_survive_line_drift(self, tmp_path):
        found = self._findings()
        shifted = tmp_path / "bad_wall_clock.py"  # same basename on purpose
        original = (FIXTURES / "bad_wall_clock.py").read_text()
        shifted.write_text("# pushed\n# down\n# by\n# comments\n" + original)
        project = Project(tmp_path, [shifted], src_prefixes=("",))
        drifted = run_rules(project, default_rules(["no-wall-clock"]))
        assert {f.fingerprint for f in drifted} == \
            {f.fingerprint for f in found}
        assert {f.line for f in drifted} != {f.line for f in found}

    def test_bad_version_rejected(self, tmp_path):
        p = tmp_path / "b.json"
        p.write_text(json.dumps({"version": 99, "findings": []}))
        with pytest.raises(ValueError):
            Baseline.load(p)

    def test_absent_baseline_is_empty_and_none_is_committed(self, tmp_path):
        assert Baseline.load(tmp_path / "none.json").entries == []
        assert not (REPO_ROOT / DEFAULT_BASELINE).exists()


# ---------------------------------------------------------------------------
# CLI + whole-tree gate
# ---------------------------------------------------------------------------

class TestCli:
    def test_list_rules_exits_zero(self, capsys):
        assert main(["--list-rules"]) == 0
        out = capsys.readouterr().out
        for rule in ALL_RULES:
            assert rule.id in out

    def test_unknown_rule_is_usage_error(self):
        assert main(["--rules", "no-such-rule",
                     "--root", str(FIXTURES)]) == 2

    def test_violation_file_fails(self, capsys):
        rc = main([str(FIXTURES / "bad_global_rng.py"),
                   "--root", str(FIXTURES), "--rules", "no-global-rng"])
        assert rc == 1
        assert "[no-global-rng]" in capsys.readouterr().out

    def test_json_report_written(self, tmp_path, capsys):
        out = tmp_path / "report.json"
        rc = main([str(FIXTURES / "bad_global_rng.py"),
                   "--root", str(FIXTURES), "--rules", "no-global-rng",
                   "--json", str(out)])
        assert rc == 1
        report = json.loads(out.read_text())
        assert report["counts"]["active"] == 6
        assert report["counts"]["files_scanned"] == {".py": 1, ".cu": 0, ".cuh": 0}
        assert all(f["rule"] == "no-global-rng"
                   for f in report["findings"])

    def test_write_baseline_then_strict_passes(self, tmp_path, capsys):
        bl = tmp_path / "baseline.json"
        bad = str(FIXTURES / "bad_global_rng.py")
        common = [bad, "--root", str(FIXTURES), "--rules", "no-global-rng",
                  "--baseline", str(bl)]
        assert main(common) == 1
        assert main(common + ["--write-baseline"]) == 0
        assert main(common + ["--strict"]) == 0  # all baselined, none stale

    def test_full_tree_is_clean(self, capsys):
        """The acceptance gate, in-process: the port's tree must lint clean
        under every rule with the (absent, so empty) baseline."""
        paths = [REPO_ROOT / p for p in DEFAULT_PATHS
                 if (REPO_ROOT / p).exists()]
        findings, stale, project = run_lint(
            REPO_ROOT, paths, baseline_path=REPO_ROOT / DEFAULT_BASELINE)
        assert project.errors == []
        assert stale == []
        active = [f for f in findings if f.active]
        assert active == [], "\n".join(
            f"{f.path}:{f.line}: [{f.rule}] {f.message}" for f in active)

    def test_port_tree_is_clean_under_strict(self, tmp_path, capsys):
        """`python -m repro_torch.analysis.lint --strict` on the committed
        tree: exit 0, nothing active, baselined or stale, no parse error,
        and the port's CUDA sources among the files scanned."""
        out = tmp_path / "report.json"
        assert main(["--root", str(REPO_ROOT), "--strict", "--json", str(out)]) == 0
        report = json.loads(out.read_text())
        assert report["counts"]["active"] == 0
        assert report["counts"]["baselined"] == 0
        assert report["stale_baseline"] == [] and report["parse_errors"] == []
        files = report["counts"]["files_scanned"]
        assert files[".cu"] + files[".cuh"] == 6
        assert files[".py"] + 6 == report["files_scanned"]


# ---------------------------------------------------------------------------
# @hot_path marker
# ---------------------------------------------------------------------------

class TestHotPathMarker:
    def test_identity_preserved_and_tagged(self):
        def f(x):
            return x

        tagged = hot_path(f)
        assert tagged is f  # zero-cost: no wrapper frame
        assert is_hot_path(tagged)
        assert not is_hot_path(lambda: None)

    def test_known_hot_paths_are_tagged(self):
        from repro_torch.core.calqueue import CalendarQueue
        from repro_torch.core.engine import TentEngine
        from repro_torch.core.telemetry import TelemetryStore

        assert is_hot_path(TentEngine._dispatch)
        assert is_hot_path(TentEngine._on_wire_done_many)
        assert is_hot_path(TelemetryStore.on_complete_many)
        assert is_hot_path(CalendarQueue.push)
        assert is_hot_path(CalendarQueue.pop)


# ---------------------------------------------------------------------------
# runtime sanitizer and its allowlist
# ---------------------------------------------------------------------------

def _as_port_module(stmt: str):
    """Build a zero-arg function whose frame claims to live in a
    repro_torch.* module, so the sanitizer's caller check treats it as
    engine code."""
    import random
    import time

    ns = {"__name__": "repro_torch.fake.simpath", "time": time, "np": np,
          "random": random}
    exec(f"def f():\n    return {stmt}", ns)
    return ns["f"]


class TestSanitizer:
    def test_enabled_reads_env(self, monkeypatch):
        monkeypatch.delenv("REPRO_SANITIZE", raising=False)
        assert not enabled()
        monkeypatch.setenv("REPRO_SANITIZE", "1")
        assert enabled()
        monkeypatch.setenv("REPRO_SANITIZE", "0")
        assert not enabled()

    @pytest.mark.parametrize("stmt", [
        "time.time()", "time.perf_counter()", "np.random.rand(2)",
        "np.random.seed(0)", "random.random()",
    ])
    def test_port_caller_raises(self, stmt):
        fn = _as_port_module(stmt)
        with sanitized():
            with pytest.raises(SanitizerError):
                fn()
        fn()  # outside the context the same call succeeds

    def test_non_port_caller_passes_through(self):
        import time
        with sanitized():
            assert isinstance(time.time(), float)  # this module isn't repro_torch.*
            assert np.random.default_rng(0).random() >= 0  # always fine

    def test_allowlisted_port_module_passes(self):
        import time
        ns = {"__name__": "repro_torch.training.train_loop", "time": time}
        exec("def f():\n    return time.time()", ns)
        with sanitized():
            assert isinstance(ns["f"](), float)

    def test_reentrant_and_restores(self):
        import time
        orig = time.time
        with sanitized():
            with sanitized():  # inner block must not double-patch
                assert getattr(time.time, "__tentlint_stub__", False)
            assert getattr(time.time, "__tentlint_stub__", False)
        assert time.time is orig

    def test_maybe_sanitized_off_is_noop(self, monkeypatch):
        import time
        monkeypatch.delenv("REPRO_SANITIZE", raising=False)
        with maybe_sanitized():
            assert not getattr(time.time, "__tentlint_stub__", False)

    def test_scenario_runs_under_sanitizer(self, monkeypatch):
        """One scenario through the port's runner with dynamic enforcement
        on: the whole simulated path completes without touching the wall
        clock or a global RNG, and the report is an unsanitized run's."""
        from repro_torch.scenarios import ScenarioRunner, get

        spec = get("single_rail_flap")
        monkeypatch.delenv("REPRO_SANITIZE", raising=False)
        plain = ScenarioRunner(spec).run()
        with sanitized():
            guarded = ScenarioRunner(spec).run()
        assert guarded.violations == plain.violations == []
        assert guarded.to_dict()["policies"] == plain.to_dict()["policies"]

    def test_wall_clock_allowlist_is_the_sanitizer_s(self):
        """The static rule's allowlist (paths below the source prefix) and
        the sanitizer's (module names) name the same modules."""
        as_paths = {m.split(".", 1)[1].replace(".", "/") + ".py"
                    for m in DYNAMIC_ALLOWLIST}
        assert as_paths == NoWallClock.ALLOWED_FILES
