"""Style/typing gates (reference parity: flake8/isort/mypy under tox,
/root/reference/tox.ini:2; setup.cfg:60-109).

The style gate runs always via the in-repo AST linter (tools/lint.py —
the deployment image has no third-party linter). The mypy gate runs
wherever mypy is installed (config lives in pyproject.toml) and skips
with a reason otherwise, so dev environments enforce it.
"""
import importlib.util
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGETS = ["meterelf_jax", "tests", "tools", "bench.py",
           "__graft_entry__.py", "chip_smoke.py"]


def test_lint_clean():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import lint
    finally:
        sys.path.pop(0)
    findings = lint.lint([os.path.join(REPO, t) for t in TARGETS])
    assert not findings, "\n".join(
        f"{p}:{ln}: {msg}" for (p, ln, msg) in findings)


def test_lint_signature_checks_fire(tmp_path):
    """The SIG1xx cross-module call/signature checks (the in-repo slice
    of the type gate) must actually detect arity
    violations — too many positionals, missing required args, unknown
    keywords, positional+keyword duplicates."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import lint
    finally:
        sys.path.pop(0)
    pkg = tmp_path / "meterelf_jax"
    pkg.mkdir()
    (pkg / "a.py").write_text(
        '"""a."""\ndef f(x: int, y: int = 0) -> int:\n    return x + y\n')
    (pkg / "b.py").write_text(
        '"""b."""\nfrom . import a\nfrom .a import f\n'
        "f(1, 2, 3)\na.f()\na.f(1, zz=2)\nf(1, x=1)\nf(1)\n")
    codes = sorted(m.split()[0] for _, _, m in lint.lint([str(pkg)])
                   if m.startswith("SIG"))
    assert codes == ["SIG101", "SIG102", "SIG103", "SIG104"], codes


def test_mypy_if_available():
    if importlib.util.find_spec("mypy") is None:
        pytest.skip("mypy not installed in this image (no network to add "
                    "it); the gate runs in the Dockerfile dev stage "
                    "(`docker build --target dev`) against the stack "
                    "pinned in requirements.lock "
                    "(config: pyproject.toml [tool.mypy])")
    r = subprocess.run(
        [sys.executable, "-m", "mypy", "meterelf_jax"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stdout[-4000:]
