"""Shared infrastructure for the port's static-analysis suite.

The port's own copy of the JAX package's analysis core (same baseline
format, same finding keys, same ``# noqa: RAxxx`` convention, same exit
codes), with the repo-wide facts swapped for the port's: tensors updated
in place where JAX donates buffers, and calls whose result may live on the
card where JAX has jitted callables.

One parse per file, one repo-wide context pass, then every rule walks the
same trees. The moving parts:

- :class:`SourceFile` — parsed module + parent links + ``# noqa: RAxxx``
  suppression map;
- :class:`RepoContext` — the cross-file facts rules need (non-frozen
  dataclasses, class definitions, the in-place updaters);
- :class:`Finding` — one diagnostic, with a line-drift-stable baseline key
  (rule + path + stripped source line, so re-indenting a file does not
  invalidate the baseline);
- baseline load/save (``analysis_baseline_torch.json``) and the driver
  :func:`run_analysis`.

Rules live in :mod:`repro_torch.analysis.rules`; the CLI in ``__main__``.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Paths never analyzed by default: fixture corpora are *deliberately*
# full of findings (the analyzer's own regression tests), and tool
# droppings aren't source.
DEFAULT_EXCLUDES = ("_fixtures", "fixtures", "__pycache__", ".git",
                    "build", ".venv", ".eggs")

_NOQA_RE = re.compile(
    r"#\s*noqa(?::\s*(?P<codes>[A-Z]+[0-9]+(?:[,\s]+[A-Z]+[0-9]+)*))?",
    re.IGNORECASE)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str          # "RA001"
    path: str          # repo-relative posix path
    line: int          # 1-based
    message: str
    snippet: str       # stripped source of the flagged line

    @property
    def key(self) -> str:
        """Baseline key — stable under line insertion/deletion elsewhere
        in the file (keys on content, not line number)."""
        return f"{self.rule}::{self.path}::{self.snippet}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


class SourceFile:
    """One parsed module: tree with parent links, source lines, and the
    per-line ``# noqa`` suppression map."""

    def __init__(self, path: Path, rel: str, source: str) -> None:
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=str(path))
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child.ra_parent = node  # type: ignore[attr-defined]
        self.noqa: Dict[int, Optional[frozenset]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _NOQA_RE.search(line)
            if m:
                codes = m.group("codes")
                self.noqa[i] = (frozenset(
                    c.strip().upper() for c in re.split(r"[,\s]+", codes))
                    if codes else None)      # None = bare noqa, all rules

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def suppressed(self, rule: str, lineno: int) -> bool:
        if lineno not in self.noqa:
            return False
        codes = self.noqa[lineno]
        return codes is None or rule in codes

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(rule=rule, path=self.rel, line=line, message=message,
                       snippet=self.line_text(line))


# -------------------------------------------------------------------------
# small AST helpers shared by the rules


def spelling(node: ast.AST) -> Optional[str]:
    """Dotted spelling of a Name/Attribute chain ("x", "self.pool",
    "np.asarray"); None for anything more dynamic."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = spelling(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def keyword_value(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def call_arg(call: ast.Call, index: int, name: str) -> Optional[ast.AST]:
    """The argument bound to parameter ``name`` at position ``index``:
    positional or keyword."""
    if index < len(call.args) and not any(
            isinstance(a, ast.Starred) for a in call.args[:index + 1]):
        return call.args[index]
    return keyword_value(call, name)


def enclosing_function(node: ast.AST) -> Optional[ast.AST]:
    cur = getattr(node, "ra_parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = getattr(cur, "ra_parent", None)
    return None


def enclosing_class(node: ast.AST) -> Optional[ast.ClassDef]:
    cur = getattr(node, "ra_parent", None)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur
        cur = getattr(cur, "ra_parent", None)
    return None


def enclosing_statement(node: ast.AST) -> ast.stmt:
    """The smallest statement containing ``node``."""
    cur = node
    while not isinstance(cur, ast.stmt):
        cur = cur.ra_parent  # type: ignore[attr-defined]
    return cur


def loop_ancestors(node: ast.AST, *, stop_at: Optional[ast.AST] = None
                   ) -> List[ast.AST]:
    """For/While/comprehension ancestors of ``node`` up to (not
    including) stop_at."""
    out = []
    cur = getattr(node, "ra_parent", None)
    while cur is not None and cur is not stop_at:
        if isinstance(cur, (ast.For, ast.AsyncFor, ast.While, ast.ListComp,
                            ast.SetComp, ast.DictComp, ast.GeneratorExp)):
            out.append(cur)
        cur = getattr(cur, "ra_parent", None)
    return out


def has_decorator(fn: ast.AST, *names: str) -> bool:
    for dec in getattr(fn, "decorator_list", ()):
        target = dec.func if isinstance(dec, ast.Call) else dec
        sp = spelling(target) or ""
        if sp in names or sp.split(".")[-1] in names:
            return True
    return False


def all_params(fn: ast.AST) -> List[ast.arg]:
    a = fn.args
    return [*a.posonlyargs, *a.args, *a.kwonlyargs]


def assign_targets(stmt: ast.stmt) -> List[str]:
    """Spellings bound by an assignment statement (tuple targets
    flattened); empty for non-assignments."""
    targets: List[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    out: List[str] = []
    stack = list(targets)
    while stack:
        t = stack.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            stack.extend(t.elts)
        else:
            sp = spelling(t)
            if sp:
                out.append(sp)
    return out


def function_statements(body: Sequence[ast.stmt]) -> List[ast.stmt]:
    """Every statement of ``body`` (nested suites flattened), source
    order, excluding nested function/class bodies."""
    out: List[ast.stmt] = []

    def visit(stmts):
        for stmt in stmts:
            out.append(stmt)
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            for field in ("body", "orelse", "finalbody"):
                visit(getattr(stmt, field, []) or [])
            for handler in getattr(stmt, "handlers", []) or []:
                visit(handler.body)

    visit(body)
    return out


# -------------------------------------------------------------------------
# repo-wide context (pass 1)

# Callees that update a tree argument in place, where the JAX package
# donates it: name -> ((positional index, parameter name), ...). A binding
# taken from such an argument before the call holds the NEW values after
# it (RA001).
INPLACE_UPDATERS: Dict[str, Tuple[Tuple[int, str], ...]] = {
    "train_step": ((3, "state"),),             # training.py
    "sft_step": ((2, "state"),),
    "adamw_update": ((2, "state"), (3, "params")),   # optim/adamw.py
    "adafactor_update": ((2, "state"), (3, "params")),
    "clip_by_global_norm": ((0, "tree"),),
    "copy_into": ((0, "dst"),),                # hetero/nodes.py
    "mamba_block": ((3, "cache"),),            # models/ssm.py: conv + ssm
    # the steps make_sharded_train_step / make_sharded_sft_step build
    # (parallel/step.py), as the learner node binds them
    "step_fn": ((0, "state"),),
}
# factories whose result is an in-place step taking the state first: a
# name bound to their result joins INPLACE_UPDATERS for its file
STEP_FACTORIES = ("make_sharded_train_step", "make_sharded_sft_step",
                  "jit_train_step", "jit_sft_step")


class RepoContext:
    """Cross-file facts collected before any rule runs."""

    def __init__(self, files: Sequence[SourceFile]) -> None:
        self.plain_dataclasses: set = set()
        self.class_defs: Dict[str, Tuple[SourceFile, ast.ClassDef]] = {}
        # per file: names bound to a STEP_FACTORIES result
        self.built_steps: Dict[str, set] = {}
        for f in files:
            self._scan(f)

    def _scan(self, f: SourceFile) -> None:
        steps = self.built_steps.setdefault(f.rel, set())
        for node in ast.walk(f.tree):
            if isinstance(node, ast.ClassDef):
                self.class_defs[node.name] = (f, node)
                for dec in node.decorator_list:
                    target = dec.func if isinstance(dec, ast.Call) else dec
                    if (spelling(target) or "").split(".")[-1] != "dataclass":
                        continue
                    fz = keyword_value(dec, "frozen") \
                        if isinstance(dec, ast.Call) else None
                    if not (isinstance(fz, ast.Constant) and fz.value is True):
                        self.plain_dataclasses.add(node.name)
            elif isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and (spelling(node.value.func) or "").split(".")[-1] \
                    in STEP_FACTORIES:
                steps.update(t.split(".")[-1] for t in assign_targets(node))

    def inplace_params(self, callee: str, rel: str
                       ) -> Optional[Tuple[Tuple[int, str], ...]]:
        """The (index, name) of each argument ``callee`` updates in place,
        for a known in-place updater spelling in file ``rel``; else None."""
        base = callee.split(".")[-1]
        if base in INPLACE_UPDATERS:
            return INPLACE_UPDATERS[base]
        if base in self.built_steps.get(rel, ()):
            return ((0, "state"),)
        return None


# -------------------------------------------------------------------------
# baseline

BASELINE_VERSION = 1


def load_baseline(path: Path) -> Dict[str, int]:
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(f"{path}: unknown baseline version "
                         f"{data.get('version')!r}")
    return {str(k): int(v) for k, v in data["findings"].items()}


def save_baseline(path: Path, findings: Sequence[Finding]) -> None:
    counts: Dict[str, int] = {}
    for fd in findings:
        counts[fd.key] = counts.get(fd.key, 0) + 1
    payload = {"version": BASELINE_VERSION,
               "findings": dict(sorted(counts.items()))}
    path.write_text(json.dumps(payload, indent=1, sort_keys=False) + "\n")


def apply_baseline(findings: Sequence[Finding], baseline: Dict[str, int]
                   ) -> Tuple[List[Finding], List[str]]:
    """(new findings not covered by the baseline, stale baseline keys)."""
    remaining = dict(baseline)
    new: List[Finding] = []
    for fd in findings:
        if remaining.get(fd.key, 0) > 0:
            remaining[fd.key] -= 1
        else:
            new.append(fd)
    stale = sorted(k for k, v in remaining.items() if v > 0)
    return new, stale


# -------------------------------------------------------------------------
# driver


def collect_files(paths: Sequence[Path], *, root: Path,
                  excludes: Sequence[str] = DEFAULT_EXCLUDES
                  ) -> List[SourceFile]:
    out: List[SourceFile] = []
    seen = set()
    for p in paths:
        candidates = [p] if p.is_file() else sorted(p.rglob("*.py"))
        for c in candidates:
            if c.suffix != ".py" or c in seen:
                continue
            try:
                rel = c.relative_to(root).as_posix()
            except ValueError:
                rel = c.as_posix()
            # the parts below the root: a checkout that itself sits under
            # a directory named like an exclude is still analyzed
            if any(part in excludes for part in Path(rel).parts):
                continue
            seen.add(c)
            out.append(SourceFile(c, rel, c.read_text()))
    return out


def run_rules(files: Sequence[SourceFile],
              rules: Optional[Iterable] = None, *,
              keep_suppressed: bool = False) -> List[Finding]:
    """Every finding of ``rules`` (default: all) on ``files``, sorted;
    ``keep_suppressed`` keeps those a ``# noqa`` silences (the card's
    host-sync twin matches its sites against them)."""
    from repro_torch.analysis.rules import default_rules
    ctx = RepoContext(files)
    active = list(rules) if rules is not None else default_rules()
    findings: List[Finding] = []
    for f in files:
        for rule in active:
            for fd in rule.check(f, ctx):
                if keep_suppressed or not f.suppressed(fd.rule, fd.line):
                    findings.append(fd)
    findings.sort(key=lambda fd: (fd.path, fd.line, fd.rule))
    return findings


def run_analysis(paths: Sequence[Path], *, root: Path,
                 baseline_path: Optional[Path] = None,
                 excludes: Sequence[str] = DEFAULT_EXCLUDES,
                 select: Optional[Sequence[str]] = None
                 ) -> Tuple[List[Finding], List[str], int]:
    """Analyze ``paths``; returns (new findings, stale baseline keys,
    total findings before baselining)."""
    from repro_torch.analysis.rules import default_rules
    files = collect_files(paths, root=root, excludes=excludes)
    rules = default_rules()
    if select:
        wanted = {s.upper() for s in select}
        rules = [r for r in rules if r.code in wanted]
    findings = run_rules(files, rules)
    baseline = load_baseline(baseline_path) if baseline_path else {}
    new, stale = apply_baseline(findings, baseline)
    return new, stale, len(findings)
