"""The repo's linter (tools/lint.py, imported, not edited) over the
port's files: the package, chip_smoke.py and the port's tests. Its own
targets (``make lint``) do not include the first two."""

import importlib.util
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _lint():
    spec = importlib.util.spec_from_file_location("repo_lint",
                                                  REPO / "tools" / "lint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FILES = {
    "package": sorted((REPO / "rabitq_tpu_torch").rglob("*.py")),
    "chip_smoke": [REPO / "chip_smoke.py"],
    "tests": sorted((REPO / "tests").glob("test_torch_*.py")),
}


@pytest.mark.parametrize("part", sorted(FILES))
def test_port_files_lint_clean(part):
    lint = _lint()
    files = FILES[part]
    assert files
    problems = [p for f in files for p in lint.check_file(f.resolve())]
    assert not problems, problems


def test_make_lint_targets_clean(capsys):
    """tools/lint.py's own targets, as ``make lint`` runs it."""
    assert _lint().main() == 0, capsys.readouterr().out
