"""In-repo style gate (reference parity: flake8/isort under tox,
/root/reference/tox.ini:2,14-18; setup.cfg:76-109).

The deployment image carries no third-party linter, so the style gate
is implemented here on the stdlib ast module and enforced by
tests/test_codequality.py. Checks:

- F401 unused imports (module scope; ``__init__`` re-exports are
  exempt when listed in ``__all__`` or imported as ``x as x``)
- ANN001/ANN201 public-API signature annotations (package code only:
  module-level public defs + public methods of public classes)
- E501 line length (< 88 columns)
- E722 bare ``except:``
- B006 mutable default arguments
- D100 missing module docstring (package code only)
- W291/W293 trailing whitespace, W191 tabs

Run directly: ``python tools/lint.py [paths...]`` — prints findings,
exits nonzero if any.
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterator, List, Tuple

MAX_LINE = 88

Finding = Tuple[str, int, str]  # (path, line, message)


def _imported_names(node: ast.AST) -> Iterator[Tuple[str, str, bool]]:
    """Yield (bound_name, lookup_key, explicit_reexport) for an import."""
    if isinstance(node, ast.Import):
        for a in node.names:
            bound = a.asname or a.name.split(".")[0]
            yield bound, bound, a.asname == a.name
    elif isinstance(node, ast.ImportFrom):
        for a in node.names:
            if a.name == "*":
                continue
            bound = a.asname or a.name
            yield bound, bound, a.asname == a.name


def _used_names(tree: ast.Module) -> set:
    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            # the root of a dotted lookup is what an import binds
            root = node
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name):
                used.add(root.id)
    return used


def _dunder_all(tree: ast.Module) -> set:
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "__all__"
                        for t in node.targets)
                and isinstance(node.value, (ast.List, ast.Tuple))):
            return {
                c.value for c in node.value.elts
                if isinstance(c, ast.Constant) and isinstance(c.value, str)
            }
    return set()


def _string_annotations(tree: ast.Module) -> set:
    """Names referenced from string annotations / docstring-only use is
    NOT tracked; keep quoted forward references alive."""
    out = set()
    for node in ast.walk(tree):
        ann = getattr(node, "annotation", None)
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            out.update(
                t for t in ann.value.replace("[", " ").replace("]", " ")
                .replace(",", " ").replace(".", " ").split())
    return out


def check_file(path: Path, *, is_package_code: bool) -> List[Finding]:
    src = path.read_text()
    findings: List[Finding] = []
    rel = str(path)

    for i, line in enumerate(src.splitlines(), 1):
        if len(line) > MAX_LINE:
            findings.append((rel, i, f"E501 line too long ({len(line)})"))
        if line != line.rstrip():
            findings.append((rel, i, "W291 trailing whitespace"))
        if "\t" in line:
            findings.append((rel, i, "W191 tab character"))

    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return findings + [(rel, e.lineno or 0, f"E999 {e.msg}")]

    if is_package_code and not (
            tree.body and isinstance(tree.body[0], ast.Expr)
            and isinstance(tree.body[0].value, ast.Constant)
            and isinstance(tree.body[0].value.value, str)):
        findings.append((rel, 1, "D100 missing module docstring"))

    used = _used_names(tree) | _string_annotations(tree)
    exported = _dunder_all(tree)
    is_init = path.name == "__init__.py"
    for node in tree.body:  # module scope only: locals are too dynamic
        for bound, key, reexport in _imported_names(node):
            if reexport or bound in exported or bound == "annotations":
                continue
            if is_init and not exported:
                continue  # bare re-export module
            if bound not in used:
                findings.append(
                    (rel, node.lineno, f"F401 unused import '{key}'"))

    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            findings.append((rel, node.lineno, "E722 bare except"))
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for d in node.args.defaults + node.args.kw_defaults:
                if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                    findings.append(
                        (rel, d.lineno,
                         f"B006 mutable default in '{node.name}'"))

    if is_package_code:
        findings.extend(_check_annotations(tree, rel))
    return findings


def _check_annotations(tree: ast.Module, rel: str) -> List[Finding]:
    """ANN001/ANN201: the PUBLIC API surface of package code must carry
    full signature annotations — module-level public functions and the
    public methods of module-level public classes (nested closures and
    underscore names are exempt). This is the typing gate that runs in
    every environment; mypy (pyproject.toml config) additionally
    type-checks wherever it is installed."""
    findings: List[Finding] = []

    def check_def(fn: ast.FunctionDef, qual: str) -> None:
        args = fn.args
        all_args = args.posonlyargs + args.args + args.kwonlyargs
        missing = [a.arg for a in all_args
                   if a.annotation is None and a.arg not in ("self", "cls")]
        if missing:
            findings.append(
                (rel, fn.lineno,
                 f"ANN001 unannotated args {missing} in '{qual}'"))
        if fn.returns is None:
            findings.append(
                (rel, fn.lineno,
                 f"ANN201 missing return annotation on '{qual}'"))

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                check_def(node, node.name)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for m in node.body:
                if (isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and not m.name.startswith("_")):
                    check_def(m, f"{node.name}.{m.name}")
    return findings


# ---- SIG1xx: cross-module call/signature consistency -----------------
#
# The closest stdlib-AST approximation of the type-correctness gate the
# reference gets from mypy: every direct call to
# a package module-level function (bare name, imported name, or
# module-alias attribute) is checked against the callee's actual
# signature — too many positionals, missing required arguments, unknown
# keywords. Dynamic dispatch (methods on instances, HOFs, *args/**kwargs
# at the call site) is skipped, never guessed.


class _Sig:
    def __init__(self, fn: ast.FunctionDef) -> None:
        a = fn.args
        self.name = fn.name
        pos = a.posonlyargs + a.args
        self.pos_names = [p.arg for p in pos]
        self.kwonly = {p.arg for p in a.kwonlyargs}
        n_def = len(a.defaults)
        self.required = {p.arg for p in pos[:len(pos) - n_def]}
        self.required |= {
            p.arg for p, d in zip(a.kwonlyargs, a.kw_defaults)
            if d is None}
        self.max_pos = len(pos)
        self.min_pos = len(pos) - n_def
        self.varargs = a.vararg is not None
        self.kwargs = a.kwarg is not None

    def check_call(self, call: ast.Call) -> "str | None":
        if any(isinstance(x, ast.Starred) for x in call.args) or any(
                kw.arg is None for kw in call.keywords):
            return None  # *args/**kwargs at the site: not checkable
        npos = len(call.args)
        kwnames = {kw.arg for kw in call.keywords}
        if npos > self.max_pos and not self.varargs:
            return (f"SIG101 '{self.name}' takes at most {self.max_pos} "
                    f"positional args, call passes {npos}")
        unknown = kwnames - set(self.pos_names) - self.kwonly
        if unknown and not self.kwargs:
            return (f"SIG102 '{self.name}' got unknown keyword(s) "
                    f"{sorted(unknown)}")
        bound = set(self.pos_names[:npos]) | kwnames
        missing = self.required - bound
        if missing:
            return (f"SIG103 '{self.name}' missing required argument(s) "
                    f"{sorted(missing)}")
        dup = kwnames & set(self.pos_names[:npos])
        if dup:
            return (f"SIG104 '{self.name}' got argument(s) {sorted(dup)} "
                    "both positionally and by keyword")
        return None


def _module_name(f: Path) -> "str | None":
    parts = list(f.parts)
    if "meterelf_jax" not in parts:
        return None
    i = parts.index("meterelf_jax")
    mod = ".".join(parts[i:])[:-3]  # strip .py
    return mod[:-9] if mod.endswith(".__init__") else mod


def _collect_signatures(files: List[Path]) -> dict:
    sigs: dict = {}
    for f in files:
        mod = _module_name(f)
        if mod is None:
            continue
        try:
            tree = ast.parse(f.read_text())
        except SyntaxError:
            continue
        for node in tree.body:
            if isinstance(node, ast.FunctionDef):
                deco = {d.id for d in node.decorator_list
                        if isinstance(d, ast.Name)}
                if not deco & {"property", "cached_property"}:
                    sigs[(mod, node.name)] = _Sig(node)
    return sigs


def _resolve_relative(mod: str, level: int, target: "str | None") -> str:
    base = mod.split(".")
    base = base[:len(base) - level]
    return ".".join(base + ([target] if target else []))


def _check_calls(tree: ast.Module, mod: str, rel: str,
                 sigs: dict) -> List[Finding]:
    # name -> ("func", module, fname) or ("mod", module)
    env: dict = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and (node.level or
                                                 (node.module or "")
                                                 .startswith("meterelf_jax")):
            src = (_resolve_relative(mod, node.level, node.module)
                   if node.level else node.module)
            for a in node.names:
                bound = a.asname or a.name
                if (src, a.name) in sigs:
                    env[bound] = ("func", src, a.name)
                else:
                    env[bound] = ("mod", f"{src}.{a.name}")
        elif isinstance(node, ast.FunctionDef):
            env[node.name] = ("func", mod, node.name)

    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        key = None
        if isinstance(fn, ast.Name) and fn.id in env:
            e = env[fn.id]
            if e[0] == "func":
                key = (e[1], e[2])
        elif (isinstance(fn, ast.Attribute)
              and isinstance(fn.value, ast.Name)
              and fn.value.id in env and env[fn.value.id][0] == "mod"):
            key = (env[fn.value.id][1], fn.attr)
        if key is not None and key in sigs:
            msg = sigs[key].check_call(node)
            if msg:
                findings.append((rel, node.lineno, msg))
    return findings


def lint(paths: List[str]) -> List[Finding]:
    findings: List[Finding] = []
    all_files: List[Path] = []
    for p in paths:
        root = Path(p)
        files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
        all_files.extend(files)
        for f in files:
            pkg = "meterelf_jax" in f.parts
            findings.extend(check_file(f, is_package_code=pkg))
    sigs = _collect_signatures(all_files)
    for f in all_files:
        mod = _module_name(f)
        if mod is None:
            continue
        try:
            tree = ast.parse(f.read_text())
        except SyntaxError:
            continue
        findings.extend(_check_calls(tree, mod, str(f), sigs))
    return findings


if __name__ == "__main__":
    targets = sys.argv[1:] or ["meterelf_jax", "tests", "tools",
                               "bench.py", "__graft_entry__.py"]
    found = lint(targets)
    for rel, line, msg in found:
        print(f"{rel}:{line}: {msg}")
    print(f"{len(found)} finding(s)")
    sys.exit(1 if found else 0)
