"""Self-lint gate of the port: ``dmlcloud_tpu_torch/`` (its ``examples/``
included) and ``scripts/torch_*.py`` satisfy the contracts the port's linter
enforces — zero findings under every ported family (DML1xx, DML209/DML214,
DML3xx, and the whole-program DML5xx pass).

One ``lint_paths`` run over all targets is shared by the asserts; a stage,
example or script that reintroduces a host sync, a wall-clock step timer or a
half-locked thread protocol fails here, on the CPU. Legitimate exceptions
carry a ``# dmllint: disable=ID -- why`` at the line.
"""

from pathlib import Path

import pytest
import torch

import dmlcloud_tpu_torch
from dmlcloud_tpu_torch.lint import PROJECT_RULES, RULES, lint_paths

torch.set_num_threads(2)

PACKAGE_DIR = Path(dmlcloud_tpu_torch.__file__).resolve().parent
REPO_ROOT = PACKAGE_DIR.parent
SCRIPTS = sorted((REPO_ROOT / "scripts").glob("torch_*.py"))


@pytest.fixture(scope="module")
def findings():
    stats: dict = {}
    found = lint_paths([PACKAGE_DIR, *SCRIPTS], stats=stats)
    return found, stats


def _report(found):
    return "\n".join(f.format() for f in found) + "\nFix the hazard or suppress it with '# dmllint: disable=ID -- why'."


@pytest.mark.parametrize("part", ["package", "examples", "scripts"])
def test_port_lints_clean(findings, part):
    found, stats = findings
    if part == "package":
        mine = [f for f in found if "/examples/" not in f.path and Path(f.path).resolve().is_relative_to(PACKAGE_DIR)]
        n = sum(1 for p in PACKAGE_DIR.rglob("*.py") if "/build/" not in str(p))
    elif part == "examples":
        mine = [f for f in found if Path(f.path).resolve().is_relative_to(PACKAGE_DIR / "examples")]
        n = len(list((PACKAGE_DIR / "examples").glob("*.py")))
    else:
        mine = [f for f in found if Path(f.path).resolve().parent == REPO_ROOT / "scripts"]
        n = len(SCRIPTS)
    assert mine == [], _report(mine)
    assert n > 0 and stats["files"] == sum(1 for p in PACKAGE_DIR.rglob("*.py")) + len(SCRIPTS)


def test_every_family_ran(findings):
    # the whole-program pass is on (callgraph=True by default) and every ported rule is registered
    assert sorted(PROJECT_RULES) == ["DML501", "DML502", "DML503", "DML504"]
    assert {r[:4] for r in RULES} == {"DML1", "DML2", "DML3"}


def test_suppressions_in_the_port_are_justified():
    """Every suppression comment in the port says why, after ``--``."""
    import io
    import tokenize

    from dmlcloud_tpu_torch.lint.engine import _DIRECTIVE

    bare, seen = [], 0
    for path in [*PACKAGE_DIR.rglob("*.py"), *SCRIPTS]:
        for tok in tokenize.generate_tokens(io.StringIO(path.read_text()).readline):
            if tok.type == tokenize.COMMENT and _DIRECTIVE.search(tok.string):
                seen += 1
                if "--" not in tok.string.split("dmllint:", 1)[1]:
                    bare.append(f"{path}:{tok.start[0]}")
    assert bare == [] and seen >= 1
