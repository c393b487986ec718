"""``dmlcloud_tpu_torch.lint`` — the source and whole-program tiers — against
``dmlcloud_tpu.lint``, on the CPU.

(a) Parity: over every reference fixture under ``tests/lint_fixtures/`` whose
    rule the port carries and whose source names no JAX API (DML105, the
    clean DML108, DML209, DML214, DML301, DML302 and the DML501-504 project
    packages), the port's ``lint_paths`` gives the reference's
    ``(rule, file, line, col)`` list. The fixtures are read, never copied
    into the port's corpus or edited.
(b) The torch corpus (``tests/torch_lint_fixtures/``): each ``# BAD`` line of
    a bad file is flagged exactly once by its own rule, each clean file not at
    all, and each rule flags as many lines as the reference's rule does on its
    own JAX fixture.
(c) The engine's edges: suppression comments and family wildcards, the
    torch.compile contexts, ``jobs=2`` against a serial run, the incremental
    cache re-linting what the reference's re-lints, ``--fix`` on DML108, the
    ``--json`` schema, ``--list-rules``, the parse-error exit, and the IR tier
    raising ``NotImplementedError``.
(d) ``TrainingPipeline(lint=)`` on ``device="cpu"``: ``"error"`` raises before
    the runtime starts, with a verdict that does not requeue; ``"warn"``
    logs; framework stages and sourceless classes are skipped.
"""

import json
import logging
import shutil
import textwrap
from pathlib import Path

import pytest
import torch

import dmlcloud_tpu.lint as ref_lint
import dmlcloud_tpu_torch.lint as lint
from dmlcloud_tpu.lint.cli import main as ref_cli
from dmlcloud_tpu_torch.lint import LintError, lint_paths, lint_source
from dmlcloud_tpu_torch.lint.cli import main as port_cli

torch.set_num_threads(2)

REF_FIXTURES = Path(__file__).parent / "lint_fixtures"
TORCH_FIXTURES = Path(__file__).parent / "torch_lint_fixtures"

#: the reference fixtures of the ported rules that name no JAX API
NEUTRAL = ["dml105_bad.py", "dml105_clean.py", "dml108_clean.py", "dml209_bad.py", "dml209_clean.py",
           "dml214_bad.py", "dml214_clean.py", "dml301_bad.py", "dml301_clean.py", "dml302_bad.py",
           "dml302_clean.py", "dml501", "dml502", "dml503", "dml504"]
#: the torch corpus's rules (each has a bad and a clean file)
TORCH_RULES = ["DML101", "DML102", "DML104", "DML106", "DML107", "DML108", "DML209"]


def _keys(findings):
    return [(f.rule, f.path, f.line, f.col) for f in findings]


# ---------------------------------------------------------------------------
# (a) parity on the reference's neutral fixtures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NEUTRAL)
def test_neutral_reference_fixture_gives_the_references_findings(name):
    path = REF_FIXTURES / name
    assert "jax" not in "".join(p.read_text() for p in ([path] if path.is_file() else path.glob("*.py")))
    want = _keys(ref_lint.lint_paths([path]))
    got = _keys(lint_paths([path]))
    assert got == want
    assert bool(got) == (name.endswith("_bad.py") or path.is_dir())


def test_registries_hold_the_ported_families():
    assert sorted(lint.RULES) == ["DML101", "DML102", "DML104", "DML105", "DML106", "DML107", "DML108",
                                  "DML209", "DML214", "DML301", "DML302"]
    assert sorted(lint.PROJECT_RULES) == sorted(ref_lint.PROJECT_RULES) == ["DML501", "DML502", "DML503",
                                                                            "DML504"]
    assert lint.IR_RULES == {}
    # DML103 and the sharding/perf families stay out: nothing the port registers is unknown to the reference
    assert set(lint.RULES) < set(ref_lint.RULES) and "DML103" not in lint.RULES


# ---------------------------------------------------------------------------
# (b) the torch corpus
# ---------------------------------------------------------------------------

def _bad_lines(path):
    return [i + 1 for i, line in enumerate(path.read_text().splitlines()) if "# BAD" in line]


@pytest.mark.parametrize("rule_id", TORCH_RULES)
def test_torch_bad_fixture_flags_each_bad_line_once(rule_id):
    path = TORCH_FIXTURES / f"{rule_id.lower()}_bad.py"
    findings = lint_paths([path])
    assert {f.rule for f in findings} == {rule_id}
    assert sorted(f.line for f in findings) == _bad_lines(path)
    # as many as the reference's rule finds on its own JAX fixture
    want = ref_lint.lint_file(REF_FIXTURES / f"{rule_id.lower()}_bad.py", select=[rule_id])
    assert len(findings) == len(want)
    assert "jax" not in path.read_text()


@pytest.mark.parametrize("rule_id", TORCH_RULES)
def test_torch_clean_fixture_is_clean(rule_id):
    path = TORCH_FIXTURES / f"{rule_id.lower()}_clean.py"
    assert lint_paths([path]) == []
    assert "jax" not in path.read_text()


def test_every_host_read_of_dml101_fires():
    src = textwrap.dedent("""
        import numpy as np
        import torch

        class S(TrainValStage):
            def train_epoch(self):
                for batch in self.ds:
                    m = self._train_step(batch)
                    a = m["loss"].cpu()
                    b = m["loss"].numpy()
                    c = np.asarray(m["loss"])
                    d = m["loss"].detach()
                    e = m["loss"].to("cpu", non_blocking=True)

            def step(self, state, batch):
                out = state.model(batch)
                n = int(out.shape[0]) + int(batch.size(1))
                flag = bool(out.sum())
                return out.mean() * n * flag
    """)
    findings = lint_source(src)
    assert [(f.rule, f.line) for f in findings] == [("DML101", 9), ("DML101", 10), ("DML101", 11),
                                                    ("DML101", 18)]
    assert ".cpu()" in findings[0].message and "bool() of a tensor" in findings[3].message


@pytest.mark.parametrize("form", ["@torch.compile", "@torch.compile(fullgraph=True)",
                                  "@functools.partial(torch.compile, mode='max-autotune')", "call", "from-import"])
def test_every_compile_form_is_a_step_context(form):
    head = "import functools\nimport random\nimport torch\nfrom torch import compile as tc\n\n"
    if form == "call":
        body = "def f(x):\n    return x * random.random()\n\ng = torch.compile(f)\n"
    elif form == "from-import":
        body = "@tc\ndef f(x):\n    return x * random.random()\n"
    else:
        body = f"{form}\ndef f(x):\n    return x * random.random()\n"
    findings = lint_source(head + body)
    assert [(f.rule, f.context) for f in findings] == [("DML102", "f")]


# ---------------------------------------------------------------------------
# (c) the engine's edges
# ---------------------------------------------------------------------------

_SUPPRESSIBLE = textwrap.dedent("""
    import time

    class S(TrainValStage):
        def train_epoch(self):
            a = time.time(){same}
            {next_line}
            b = time.time()
            c = self.m.item()
""")


@pytest.mark.parametrize("same,next_line,file_wide,want", [
    ("", "", "", [("DML108", 6), ("DML108", 8), ("DML101", 9)]),
    ("  # dmllint: disable=DML108 -- a start stamp", "", "", [("DML108", 8), ("DML101", 9)]),
    ("", "# dmllint: disable-next-line=DML108", "", [("DML108", 6), ("DML101", 9)]),
    ("", "", "# dmllint: disable-file=DML1xx", []),
    ("  # dmllint: disable=all", "# dmllint: disable-next-line=DML1xx,DML2xx", "", [("DML101", 9)]),
    ("  # dmllint: disable=DML101", "", "# dmllint: disable-file=DML301", [("DML108", 6), ("DML108", 8),
                                                                            ("DML101", 9)]),
], ids=["none", "same-line", "next-line", "file-wildcard", "all-and-wildcards", "unrelated-ids"])
def test_suppressions_match_the_references(same, next_line, file_wide, want):
    src = _SUPPRESSIBLE.format(same=same, next_line=next_line) + file_wide + "\n"
    got = lint_source(src)
    assert sorted([(f.rule, f.line) for f in got], key=lambda x: x[1]) == want
    # the reference applies the same directives to the same lines
    ref = ref_lint.lint_source(src, select=["DML108"])
    assert [(f.rule, f.line) for f in ref] == [(r, n) for r, n in want if r == "DML108"]


def test_select_and_ignore_take_family_wildcards():
    path = TORCH_FIXTURES / "dml108_bad.py"
    assert lint_paths([path], select=["DML2xx"]) == []
    assert len(lint_paths([path], select=["DML1xx"], ignore=["DML101"])) == 5
    assert lint_paths([path], ignore=["DML108"]) == []
    assert lint.engine.expand_rule_ids(["DML5xx", "DML103", "DML6xx"]) == (
        ["DML501", "DML502", "DML503", "DML504"], ["DML103", "DML6xx"])


def test_jobs_2_equals_a_serial_run():
    paths = [TORCH_FIXTURES, REF_FIXTURES / "dml502", REF_FIXTURES / "dml214_bad.py"]
    serial = lint_paths(paths)
    assert serial and lint_paths(paths, jobs=2) == serial


def _cache_run(mod, pkg, cache):
    stats = {}
    findings = mod.lint_paths([pkg], cache=str(cache), stats=stats)
    return _keys(findings), {Path(p).name for p in stats["linted"]}, {Path(p).name for p in stats["reused"]}


def test_warm_cache_relints_what_the_references_relints(tmp_path):
    """Cold, warm, then a leaf edit and a hub edit of the DML502 package: the
    port re-lints exactly the files the reference re-lints (the changed file
    and its transitive importers) and replays the same findings."""
    plans = {}
    for name, mod in (("ref", ref_lint), ("port", lint)):
        pkg = tmp_path / name / "dml502"
        shutil.copytree(REF_FIXTURES / "dml502", pkg)
        cache = tmp_path / name / "cache.json"
        steps = [_cache_run(mod, pkg, cache), _cache_run(mod, pkg, cache)]
        for edited in ("ops.py", "_alias.py"):
            f = pkg / edited
            f.write_text(f.read_text() + "\n\ndef extra(x):\n    return x\n")
            steps.append(_cache_run(mod, pkg, cache))
        plans[name] = [(len(findings), linted, reused) for findings, linted, reused in steps]
        if name == "port":
            assert steps[1][0] == steps[0][0]  # cached findings replay
    assert plans["port"] == plans["ref"]
    cold, warm, leaf, shim = plans["port"]
    assert warm[1] == set() and warm[2] == cold[1]
    assert leaf[1] == {"ops.py", "_alias.py", "renamed.py", "writer.py", "caller.py"}
    assert shim[1] == {"_alias.py", "renamed.py"}


def _fix(cli, path, capsys):
    capsys.readouterr()
    rc = cli([str(path), "--fix", "--select", "DML108", "--json", "--no-callgraph"])
    result = json.loads(capsys.readouterr().out)
    again = cli([str(path), "--fix", "--select", "DML108", "--json", "--no-callgraph"])
    capsys.readouterr()
    return rc, again, path.read_text(), [(f["rule"], f["line"]) for f in result["findings"]]


def test_fix_rewrites_dml108_as_the_reference(tmp_path, capsys):
    # the epoch loop of the torch fixture (no compiled function, which only the port sees as a step)
    text = (TORCH_FIXTURES / "dml108_bad.py").read_text()
    text = text[:text.index("@torch.compile")]
    out = {}
    for name, cli in (("ref", ref_cli), ("port", port_cli)):
        path = tmp_path / name / "timer.py"
        path.parent.mkdir()
        path.write_text(text)
        out[name] = _fix(cli, path, capsys)
    assert out["port"] == out["ref"]
    rc, again, fixed, left = out["port"]
    assert rc == again == 1 and fixed.count("time.perf_counter()") == 2
    assert left == [("DML108", 18), ("DML108", 20)]  # the time_ns reads are a human's to fix
    # the whole torch fixture: the compiled step's time.time() is rewritten too
    path = tmp_path / "dml108_bad.py"
    shutil.copy(TORCH_FIXTURES / "dml108_bad.py", path)
    rc, again, fixed, left = _fix(port_cli, path, capsys)
    assert fixed.count("time.perf_counter()") == 3 and left == [("DML108", 18), ("DML108", 20)]
    assert lint.FIXABLE_RULES == ref_lint.FIXABLE_RULES


def test_baseline_and_fix_suppress_workflows_are_the_references(tmp_path, capsys, monkeypatch):
    """``--write-baseline``/``--baseline``, ``--fix-suppress`` and ``--changed``
    (outside a git checkout: plain ``--cache``) on a neutral program, through
    both CLIs: the same exit codes, files and remaining findings."""
    text = (REF_FIXTURES / "dml214_bad.py").read_text()
    # --changed's cache in the working directory, as the reference's is
    monkeypatch.setattr("dmlcloud_tpu_torch.lint.cli.DEFAULT_CACHE_PATH", ".dmllint_cache.json")
    out = {}
    for name, cli in (("ref", ref_cli), ("port", port_cli)):
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)
        path = work / "stage.py"  # relative paths below: the files name them alike
        path.write_text(text)
        codes = [cli(["stage.py", "--write-baseline", "base.json"]), cli(["stage.py", "--baseline", "base.json"]),
                 cli(["stage.py", "--baseline", "missing.json"])]
        with open(work / "base.json") as f:
            frozen = json.load(f)
        codes.append(cli(["stage.py", "--fix-suppress"]))
        suppressed = path.read_text()
        codes += [cli(["stage.py", "--changed"]), cli(["stage.py", "--changed"])]
        capsys.readouterr()
        out[name] = (codes, frozen, suppressed)
    assert out["port"] == out["ref"]
    codes, frozen, suppressed = out["port"]
    assert codes == [0, 0, 2, 0, 0, 0] and len(frozen["findings"]) == 4
    assert suppressed.count("# dmllint: disable=DML214 -- TODO: justify") == 4
    assert (tmp_path / "port" / ".dmllint_cache.json").is_file()


@pytest.mark.parametrize("name", ["dml214_bad.py", "dml301_clean.py"])
def test_json_schema_is_the_references(capsys, name):
    path = str(REF_FIXTURES / name)
    rc_ref = ref_cli([path, "--json"])
    ref = json.loads(capsys.readouterr().out)
    rc = port_cli([path, "--json"])
    got = json.loads(capsys.readouterr().out)
    assert rc == rc_ref and set(got) == set(ref) == {"version", "status", "files_scanned", "findings", "counts"}
    assert {k: got[k] for k in ("version", "status", "files_scanned", "counts")} == {
        k: ref[k] for k in ("version", "status", "files_scanned", "counts")}
    assert [set(f) for f in got["findings"]] == [set(f) for f in ref["findings"]]
    assert [(f["rule"], f["line"], f["col"], f["context"]) for f in got["findings"]] == [
        (f["rule"], f["line"], f["col"], f["context"]) for f in ref["findings"]]


def test_github_format_and_parse_error_exit_as_the_reference(tmp_path, capsys):
    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    for argv in ([str(broken), "--json"], [str(REF_FIXTURES / "dml302_bad.py"), "--format=github"],
                 [str(REF_FIXTURES / "dml302_clean.py")], [str(broken), "--json", "--format=text"],
                 [str(broken), "--select", "DML9xx"]):
        rc_ref = ref_cli(argv) if "--select" not in argv else None
        ref = capsys.readouterr()
        if rc_ref is None:
            rc = port_cli(argv)
            assert rc == 2 and "unknown rule id" in capsys.readouterr().err
            continue
        rc = port_cli(argv)
        got = capsys.readouterr()
        assert rc == rc_ref
        assert got.out.replace("dmlcloud_tpu_torch", "dmlcloud_tpu") == ref.out
    assert port_cli([str(broken)]) == 2


def test_list_rules_lists_the_registered_families(capsys):
    assert port_cli(["--list-rules"]) == 0
    ids = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert ids == sorted(set(lint.RULES) | set(lint.PROJECT_RULES))
    ref_cli(["--list-rules"])
    ref_lines = capsys.readouterr().out.splitlines()
    project = [line.split()[0] for line in ref_lines if line.endswith("[project]")]
    assert project == ["DML501", "DML502", "DML503", "DML504"]


def test_ir_tier_raises_naming_item_13(tmp_path):
    with pytest.raises(NotImplementedError, match="item 13"):
        lint_paths([TORCH_FIXTURES], ir=True)
    with pytest.raises(NotImplementedError, match="item 13"):
        port_cli([str(TORCH_FIXTURES), "--ir"])


def test_default_cache_lives_under_the_ports_cache_directory():
    assert Path(lint.DEFAULT_CACHE_PATH).parent == Path("~/.cache/dmlcloud_tpu_torch").expanduser()


# ---------------------------------------------------------------------------
# (d) TrainingPipeline(lint=)
# ---------------------------------------------------------------------------

def _make_bad_stage_cls():
    import dmlcloud_tpu_torch as dml

    class ItemHappyStage(dml.TrainValStage):
        def train_epoch(self):
            for batch in self.ds:
                metrics = self._train_step(batch)
                self.track_reduce("loss", metrics["loss"].item())

    return ItemHappyStage


def test_error_mode_raises_before_the_runtime_starts(tmp_path, monkeypatch):
    import dmlcloud_tpu_torch as dml
    from dmlcloud_tpu_torch.checkpoint import CheckpointDir, read_requeue_verdict
    from dmlcloud_tpu_torch.parallel import runtime

    started = []
    monkeypatch.setattr(runtime, "init_auto", lambda *a, **k: started.append(1))
    pipeline = dml.TrainingPipeline(lint="error", device="cpu")
    pipeline.append_stage(_make_bad_stage_cls()(), max_epochs=1)
    pipeline.checkpoint_dir = CheckpointDir(str(tmp_path))  # a run directory that exists: the verdict lands
    with pytest.raises(LintError, match="DML101") as exc:
        pipeline.run()
    assert started == []
    finding = exc.value.findings[0]
    assert finding.rule == "DML101" and finding.path == __file__
    # re-anchored: the line of the .item() call in this file
    assert ".item()" in Path(__file__).read_text().splitlines()[finding.line - 1]
    verdict = read_requeue_verdict(str(tmp_path))
    assert verdict["requeue"] is False and verdict["kind"] == "exception" and "LintError" in verdict["reason"]
    assert pipeline._classify_failure(exc.value)[0] is False


def test_warn_mode_logs_and_continues(caplog):
    import dmlcloud_tpu_torch as dml

    pipeline = dml.TrainingPipeline(lint="warn", device="cpu")
    pipeline.append_stage(_make_bad_stage_cls()(), max_epochs=1)
    with caplog.at_level(logging.WARNING, logger="dmlcloud_tpu_torch"):
        pipeline._lint_stages()
    assert any("DML101" in r.getMessage() for r in caplog.records)


def test_framework_clean_and_sourceless_stages_pass_error_mode():
    import dmlcloud_tpu_torch as dml
    from dmlcloud_tpu_torch.examples.train_lm import LMStage

    class FineStage(dml.TrainValStage):
        def step(self, state, batch):
            return state.model(batch).mean()

    namespace = {"dml": dml}
    exec("class Sourceless(dml.TrainValStage):\n    def train_epoch(self):\n        self.x.item()\n", namespace)
    pipeline = dml.TrainingPipeline(lint="error", device="cpu")
    for stage in (FineStage(), LMStage(), namespace["Sourceless"]()):
        pipeline.append_stage(stage, max_epochs=1)
    pipeline._lint_stages()  # no raise


def test_mode_and_unported_keywords_are_checked():
    import dmlcloud_tpu_torch as dml

    with pytest.raises(ValueError):
        dml.TrainingPipeline(lint="maybe", device="cpu")
    for kw in (dict(verify="warn"), dict(hbm_budget=16 << 30), dict(sanitize="error")):
        with pytest.raises(NotImplementedError, match="item 13"):
            dml.TrainingPipeline(device="cpu", **kw)
    with pytest.raises(ValueError):
        dml.TrainingPipeline(device="cpu", verify="maybe")
    dml.TrainingPipeline(device="cpu", sanitize="off", verify=None, hbm_budget=None)
