"""The RA rule set in torch's terms — the port's own contracts,
machine-checked under the JAX package's rule codes, so a ``# noqa: RA003``
means the same hazard to both linters.

Each rule is one small visitor over the shared parse (see
:mod:`repro_torch.analysis.core`):

- **RA001 alias across an in-place update** — the port's optimizer and
  steps update their trees in place where JAX donates them
  (``core.INPLACE_UPDATERS``). A binding taken from such a tree before the
  call, without a copy, holds the new values after it; and a class that
  updates ``self.X`` in place must not bind ``self.X`` to a caller's tree
  uncopied (the learner's optimizer would rewrite a sampler's weights).
- **RA002 launch-key hygiene** — cache and launch-shape keys must hash by
  value (frozen dataclass / scalar / tuple): ``lru_cache`` arguments, keys
  of a bucket or build cache, the sentinel's ``record_launch`` signature;
  and what is built once (``ctypes.CDLL``, ``build.build``,
  ``torch.Generator``, streams, CUDA graphs, ``torch.compile``,
  ``dist.new_group``) must not be built per call in a hot path or loop.
- **RA003 host sync in hot paths** — ``.item()`` / ``.tolist()`` /
  ``.cpu()`` / ``.numpy()`` / ``int()`` / ``float()`` / ``bool()`` /
  ``np.asarray`` / ``.nonzero()`` / ``torch.unique`` / a host-to-card
  copy / a Python branch on a value that may live on the card, inside
  serving and training hot paths, block the host on the device;
  deliberate sync points carry a ``# noqa: RA003`` with a rationale.
  ``chip_smoke.py`` holds the rule against the card's own sync report.
- **RA004 kernel-wrapper contract** — a function that launches a kernel
  (``lib.*_launch``) passes torch's current stream, checks the return
  code through ``_raise_on``, validates its inputs before the first
  ``data_ptr()``, records the launch with ``build.count_launch``, and
  reaches the twin only under a CPU-device branch: never in an
  ``except`` / ``finally``, never around a launch or build failure.
- **RA005 unlocked cross-thread mutation** — classes handed to
  ``threading.Thread`` targets must guard every ``self`` mutation with
  ``self._lock`` (methods named ``*_locked`` assert the caller holds it).
  The JAX package's rule, unchanged.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.core import (Finding, RepoContext, SourceFile,
                                       all_params, assign_targets,
                                       call_arg, enclosing_class,
                                       enclosing_function,
                                       enclosing_statement,
                                       function_statements, has_decorator,
                                       keyword_value, loop_ancestors,
                                       spelling)

# Function names treated as serving/training hot paths by RA002/RA003
# (the JAX package's). A function of the same module that a hot function
# calls (by bare name, or as ``self.method`` of its class) is hot too.
_HOT_EXACT = {"step", "generate", "train_on", "_sampler_loop"}
_HOT_RE = re.compile(r"decode|prefill")

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _is_hot_name(fn: ast.AST) -> bool:
    """A hot path by name; a test (``test_*``) is never one."""
    name = getattr(fn, "name", "")
    if name.startswith("test_"):
        return False
    return name in _HOT_EXACT or bool(_HOT_RE.search(name))


def _nodes(f: SourceFile) -> List[ast.AST]:
    """Every node of the file's tree, in ``ast.walk`` order (one walk)."""
    cached = getattr(f, "_ra_nodes", None)
    if cached is None:
        cached = f._ra_nodes = list(ast.walk(f.tree))  # type: ignore
    return cached


def _local_defs(f: SourceFile) -> Tuple[Dict[str, List[ast.AST]],
                                        Dict[Tuple[str, str], ast.AST]]:
    """(bare-name functions by name, methods by (class, name)) of a file."""
    cached = getattr(f, "_ra_defs", None)
    if cached is not None:
        return cached
    funcs: Dict[str, List[ast.AST]] = {}
    methods: Dict[Tuple[str, str], ast.AST] = {}
    for node in _nodes(f):
        if not isinstance(node, _FUNCS):
            continue
        parent = getattr(node, "ra_parent", None)
        if isinstance(parent, ast.ClassDef):
            methods[(parent.name, node.name)] = node
        else:
            funcs.setdefault(node.name, []).append(node)
    f._ra_defs = (funcs, methods)  # type: ignore[attr-defined]
    return f._ra_defs  # type: ignore[attr-defined]


def _callees(f: SourceFile, fn: ast.AST) -> List[ast.AST]:
    """The functions of ``f`` that ``fn`` calls by bare name or as
    ``self.method`` of its own class."""
    funcs, methods = _local_defs(f)
    cls = enclosing_class(fn)
    out: List[ast.AST] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Name):
            out.extend(funcs.get(node.func.id, ()))
        elif cls is not None and isinstance(node.func, ast.Attribute) \
                and spelling(node.func.value) == "self":
            m = methods.get((cls.name, node.func.attr))
            if m is not None:
                out.append(m)
    return out


def hot_functions(f: SourceFile) -> List[ast.AST]:
    """The hot functions of a file: hot by name, or reached from one
    through same-module calls. Source order."""
    cached = getattr(f, "_ra_hot", None)
    if cached is not None:
        return cached
    hot: Set[ast.AST] = set()
    todo = [n for n in _nodes(f)
            if isinstance(n, _FUNCS) and _is_hot_name(n)]
    while todo:
        fn = todo.pop()
        if fn in hot:
            continue
        hot.add(fn)
        todo.extend(c for c in _callees(f, fn) if c not in hot)
    out = sorted(hot, key=lambda n: n.lineno)
    f._ra_hot = out  # type: ignore[attr-defined]
    return out


def hot_function_at(f: SourceFile, line: int) -> Optional[ast.AST]:
    """The innermost function of ``f`` that holds ``line``, if it is a
    hot function; else None."""
    inner = None
    for node in _nodes(f):
        if isinstance(node, _FUNCS) \
                and node.lineno <= line <= node.end_lineno \
                and (inner is None or node.lineno >= inner.lineno):
            inner = node
    return inner if inner is not None and inner in hot_functions(f) \
        else None


def _reads_in(stmt: ast.stmt, target: str) -> bool:
    """Does ``stmt`` read ``target`` (Name/Attribute load)?"""
    for node in ast.walk(stmt):
        if isinstance(node, (ast.Name, ast.Attribute)) \
                and isinstance(getattr(node, "ctx", None), ast.Load) \
                and spelling(node) == target:
            return True
    return False


class Rule:
    code = "RA000"
    name = "base"

    def check(self, f: SourceFile, ctx: RepoContext) -> Iterator[Finding]:
        raise NotImplementedError


# -------------------------------------------------------------------------
# where values live: a flow-insensitive taint of one function's names.
# DEV: may be a tensor on the card; HOSTT: a tensor on the host (a CPU
# tensor made from host data). Anything else is a host value.

DEV, HOSTT = "dev", "hostt"
_NONE: FrozenSet[str] = frozenset()

# attributes of a tensor that are host metadata
_HOST_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
               "requires_grad", "is_leaf", "grad_fn", "names"}
# tensor methods whose result is a host value (the sync methods among
# them are RA003's business)
_HOST_METHODS = {"item", "tolist", "numpy", "size", "dim", "numel",
                 "nelement", "data_ptr", "stride", "element_size",
                 "is_contiguous", "get_device", "storage_offset",
                 "untyped_storage", "is_floating_point"}
# builtins and modules whose calls give host values
_HOST_CALLS = {"int", "float", "bool", "len", "str", "repr", "range",
               "isinstance", "hasattr", "print", "enumerate", "zip",
               "sorted", "id", "hash", "type", "dict", "set", "frozenset"}
_HOST_MODULES = ("np.", "numpy.", "math.", "time.", "os.", "json.",
                 "random.", "statistics.", "dataclasses.", "itertools.",
                 "functools.", "collections.", "torch.cuda.",
                 "torch.distributed.", "dist.", "torch.backends.",
                 "torch.testing.", "torch.utils.", "torch.nn.init.")
_TORCH_HOST = {"torch.is_tensor", "torch.is_grad_enabled", "torch.device",
               "torch.get_default_dtype", "torch.manual_seed",
               "torch.Generator", "torch.finfo", "torch.iinfo",
               "torch.Size", "torch.no_grad", "torch.inference_mode",
               "torch.set_grad_enabled", "torch.is_floating_point",
               "torch.set_num_threads", "torch.get_num_threads",
               "torch.compile", "torch.dtype"}
# host data -> tensor: on the host unless a device is named
_TORCH_FROM_HOST = {"torch.as_tensor", "torch.tensor", "torch.from_numpy",
                    "torch.asarray"}
# factories that allocate on the host unless a device is named
_TORCH_FACTORIES = {"torch.zeros", "torch.ones", "torch.empty",
                    "torch.full", "torch.arange", "torch.linspace",
                    "torch.eye", "torch.rand", "torch.randn",
                    "torch.randint", "torch.randperm"}
# calls of the port that return tensors that live where their inputs do:
# the model's entry points and the kernels/ops.py dispatches
DEVICE_CALLABLES = {"forward", "decode_step", "encode", "token_logps",
                    "flash_attention", "ssd_scan", "paged_decode",
                    "paged_prefill", "paged_decode_layers",
                    "paged_prefill_layers", "fused_token_logprob",
                    "paged_attention"}
_DTYPES = {"float32", "float16", "bfloat16", "float64", "int32", "int64",
           "int8", "uint8", "bool", "float", "half", "long", "int",
           "double", "int16"}


def _is_dtype(node: ast.AST) -> bool:
    sp = spelling(node) or ""
    return sp.startswith("torch.") and sp.split(".")[-1] in _DTYPES


def _moves_to_device(call: ast.Call) -> bool:
    """``t.to(...)`` / ``t.cuda()`` naming a device (not a dtype alone),
    without ``non_blocking=True``."""
    nb = keyword_value(call, "non_blocking")
    if isinstance(nb, ast.Constant) and nb.value is True:
        return False
    if call.func.attr == "cuda":                      # type: ignore
        return True
    if keyword_value(call, "device") is not None:
        return True
    return any(not _is_dtype(a) for a in call.args)


class _Values:
    """Where each name of one function may live (DEV / HOSTT), and the
    kind of any expression in it."""

    def __init__(self, f: SourceFile, fn: ast.AST, returns) -> None:
        self.f, self.fn, self.returns = f, fn, returns
        self.cls = enclosing_class(fn)
        self.env: Dict[str, FrozenSet[str]] = {}
        stmts = function_statements(fn.body)
        for _ in range(8):
            changed = False
            for stmt in stmts:
                for name, k in self._binds(stmt):
                    old = self.env.get(name, _NONE)
                    if not k <= old:
                        self.env[name] = old | k
                        changed = True
            if not changed:
                break

    def _binds(self, stmt: ast.stmt) -> Iterator[Tuple[str, FrozenSet[str]]]:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                yield from self._bind_target(t, stmt.value)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)) \
                and stmt.value is not None:
            yield from self._bind_target(stmt.target, stmt.value)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            k = self.kinds(stmt.iter)
            for name in assign_targets(ast.Assign(targets=[stmt.target])):
                yield name, k

    def _bind_target(self, t: ast.AST, value: ast.AST
                     ) -> Iterator[Tuple[str, FrozenSet[str]]]:
        if isinstance(t, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) \
                    and len(value.elts) == len(t.elts):
                for te, ve in zip(t.elts, value.elts):
                    yield from self._bind_target(te, ve)
                return
            k = self.kinds(value)
            for te in t.elts:
                el = te.value if isinstance(te, ast.Starred) else te
                sp = spelling(el)
                if sp:
                    yield sp, k
            return
        sp = spelling(t)
        if sp:
            yield sp, self.kinds(value)

    def kinds(self, node: Optional[ast.AST]) -> FrozenSet[str]:
        if node is None:
            return _NONE
        if isinstance(node, ast.Name):
            return self.env.get(node.id, _NONE)
        if isinstance(node, ast.Attribute):
            if node.attr in _HOST_ATTRS:
                return _NONE
            sp = spelling(node)
            if sp is not None and sp in self.env:
                return self.env[sp]
            return self.kinds(node.value)
        if isinstance(node, ast.Subscript):
            return self.kinds(node.value)
        if isinstance(node, ast.Call):
            return self._call_kinds(node)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return _NONE
            return self._union([node.left, *node.comparators])
        if isinstance(node, ast.BinOp):
            return self._union([node.left, node.right])
        if isinstance(node, ast.UnaryOp):
            return _NONE if isinstance(node.op, ast.Not) \
                else self.kinds(node.operand)
        if isinstance(node, ast.BoolOp):
            return self._union(node.values)
        if isinstance(node, ast.IfExp):
            return self._union([node.body, node.orelse])
        if isinstance(node, (ast.Tuple, ast.List)):
            return self._union(node.elts)
        if isinstance(node, ast.Starred):
            return self.kinds(node.value)
        return _NONE

    def _union(self, nodes) -> FrozenSet[str]:
        out = _NONE
        for n in nodes:
            out = out | self.kinds(n)
        return out

    def _call_kinds(self, call: ast.Call) -> FrozenSet[str]:
        sp = spelling(call.func) or ""
        args = [*call.args, *(kw.value for kw in call.keywords)]
        if isinstance(call.func, ast.Attribute) and not sp.startswith(
                ("torch.", "np.", "numpy.")):
            attr = call.func.attr
            recv = self.kinds(call.func.value)
            if attr in _HOST_METHODS:
                return _NONE
            if attr == "cpu":
                return frozenset({HOSTT})
            if attr in ("to", "cuda"):
                return frozenset({DEV}) if _moves_to_device(call) else recv
            if spelling(call.func.value) == "self" and self.cls is not None:
                target = _local_defs(self.f)[1].get((self.cls.name, attr))
                if target is not None:
                    return self.returns(target) | self._union(args)
            if attr in DEVICE_CALLABLES:
                return frozenset({DEV})
            return recv | self._union(args)
        if sp in _HOST_CALLS or sp.startswith(_HOST_MODULES) \
                or sp in _TORCH_HOST:
            return _NONE
        if sp in _TORCH_FROM_HOST:
            data = self.kinds(call.args[0]) if call.args else _NONE
            if DEV in data or keyword_value(call, "device") is not None:
                return frozenset({DEV})
            return frozenset({HOSTT})
        if sp in _TORCH_FACTORIES:
            return frozenset({DEV}) if keyword_value(call, "device") \
                is not None else frozenset({HOSTT})
        if sp.startswith("torch."):
            return self._union(args) or frozenset({DEV})
        base = sp.split(".")[-1]
        if base in DEVICE_CALLABLES:
            return frozenset({DEV})
        out = self._union(args)
        if isinstance(call.func, ast.Name):
            for target in _local_defs(self.f)[0].get(call.func.id, ()):
                out = out | self.returns(target)
        return out


def _values_of(f: SourceFile, fn: ast.AST) -> _Values:
    """The memoized taint of ``fn``; a callee's return kinds resolve
    through the same memo (recursion reads as a host value)."""
    memo = f.__dict__.setdefault("_ra_values", {})
    rets = f.__dict__.setdefault("_ra_returns", {})

    def returns(target: ast.AST) -> FrozenSet[str]:
        if target in rets:
            return rets[target]
        rets[target] = _NONE                     # recursion guard
        vals = _values_of(f, target)
        out = _NONE
        for stmt in function_statements(target.body):
            if isinstance(stmt, ast.Return):
                out = out | vals.kinds(stmt.value)
        rets[target] = out
        return out

    if fn not in memo:
        memo[fn] = _Values(f, fn, returns)
    return memo[fn]


# -------------------------------------------------------------------------


# wrappers that hand back the same tensors (a view, a shallow container,
# the leaves): the result still aliases the tree
_ALIAS_CALLS = {"dict", "list", "tuple", "copy.copy", "tree_leaves",
                "np.asarray", "numpy.asarray"}
_ALIAS_METHODS = {"detach", "view", "view_as", "numpy", "values", "items",
                  "_asdict"}


def _alias_root(expr: ast.AST) -> Optional[str]:
    """The tree spelling ``expr`` aliases (``state.params["w"]`` ->
    ``state.params``), if it is a chain of attribute / subscript reads of
    a name, optionally through a non-copying wrapper; else None (a call
    that may copy)."""
    while True:
        if isinstance(expr, ast.Subscript):
            expr = expr.value
        elif isinstance(expr, ast.Call):
            sp = spelling(expr.func) or ""
            if sp in _ALIAS_CALLS and expr.args:
                expr = expr.args[0]
            elif isinstance(expr.func, ast.Attribute) \
                    and expr.func.attr in _ALIAS_METHODS:
                expr = expr.func.value
            else:
                return None
        else:
            break
    return spelling(expr)


def _after(stmt: ast.stmt, fn: ast.AST) -> List[ast.stmt]:
    """The statements of ``fn`` that can run after ``stmt`` (nested
    suites flattened, source order): the rest of each enclosing block,
    up to an unconditional return / raise / break / continue; the other
    arm of an ``if`` and the handlers of a ``try`` are left out."""
    out: List[ast.stmt] = []
    node: ast.AST = stmt
    while node is not fn:
        parent = node.ra_parent  # type: ignore[attr-defined]
        if isinstance(node, ast.ExceptHandler):
            node = parent
            continue
        block = next((b for b in (getattr(parent, "body", None),
                                  getattr(parent, "orelse", None),
                                  getattr(parent, "finalbody", None))
                      if isinstance(b, list) and node in b), [node])
        for s in block[block.index(node) + 1:]:
            out.extend(function_statements([s]))
            if isinstance(s, (ast.Return, ast.Raise, ast.Break,
                              ast.Continue)):
                return out
        node = parent
    return out


def _overlaps(a: str, b: str) -> bool:
    return a == b or a.startswith(b + ".") or b.startswith(a + ".")


class AliasAcrossInplaceUpdate(Rule):
    """RA001: a binding that aliases a tree an in-place updater rewrites
    is read after the update as if it held the old values."""

    code = "RA001"
    name = "alias-across-inplace-update"

    def check(self, f: SourceFile, ctx: RepoContext) -> Iterator[Finding]:
        yield from self._stale_aliases(f, ctx)
        yield from self._borrowed_trees(f, ctx)

    @staticmethod
    def _updated_trees(f: SourceFile, ctx: RepoContext, call: ast.Call
                       ) -> List[str]:
        callee = spelling(call.func)
        upd = ctx.inplace_params(callee, f.rel) if callee else None
        out = []
        for index, pname in upd or ():
            arg = call_arg(call, index, pname)
            root = _alias_root(arg) if arg is not None else None
            if root:
                out.append(root)
        return out

    # ---- half 1: a binding taken before the update, read after --------
    def _stale_aliases(self, f: SourceFile, ctx: RepoContext
                       ) -> Iterator[Finding]:
        for call in _nodes(f):
            if not isinstance(call, ast.Call):
                continue
            trees = self._updated_trees(f, ctx, call)
            fn = enclosing_function(call)
            if not trees or fn is None:
                continue
            stmt = enclosing_statement(call)
            stmts = function_statements(fn.body)
            try:
                idx = stmts.index(stmt)
            except ValueError:
                continue
            for tree in trees:
                for j in range(idx):
                    s = stmts[j]
                    if not isinstance(s, ast.Assign):
                        continue
                    src = _alias_root(s.value)
                    if src is None or not _overlaps(src, tree):
                        continue
                    for alias in assign_targets(s):
                        if _overlaps(alias, tree) or any(
                                alias in assign_targets(t)
                                for t in stmts[j + 1:idx + 1]):
                            continue      # the tree itself, or rebound
                        use = self._first_read(_after(stmt, fn), alias)
                        if use is not None:
                            yield f.finding(
                                self.code, use,
                                f"`{alias}` aliases `{tree}` (line "
                                f"{s.lineno}), which `{spelling(call.func)}`"
                                f" updates in place (line {call.lineno}); "
                                "read here it holds the new values — take "
                                "a copy (.clone(), copy_tree, "
                                "device_put_*(copy=True)) before the call")

    @staticmethod
    def _first_read(stmts: List[ast.stmt], target: str
                    ) -> Optional[ast.stmt]:
        for s in stmts:
            if _reads_in(s, target):
                return s
            if target in assign_targets(s):
                return None
        return None

    # ---- half 2: a class that updates self.X in place binds it uncopied
    def _borrowed_trees(self, f: SourceFile, ctx: RepoContext
                        ) -> Iterator[Finding]:
        for cls in _nodes(f):
            if not isinstance(cls, ast.ClassDef):
                continue
            updated: Dict[str, int] = {}
            for call in ast.walk(cls):
                if isinstance(call, ast.Call):
                    for tree in self._updated_trees(f, ctx, call):
                        parts = tree.split(".")
                        if parts[0] == "self" and len(parts) > 1:
                            updated.setdefault(parts[1], call.lineno)
            if not updated:
                continue
            for node in ast.walk(cls):
                if not isinstance(node, ast.Assign):
                    continue
                src = _alias_root(node.value)
                if src is None or src.split(".")[0] == "self":
                    continue
                for t in assign_targets(node):
                    parts = t.split(".")
                    if len(parts) == 2 and parts[0] == "self" \
                            and parts[1] in updated:
                        yield f.finding(
                            self.code, node,
                            f"`{t}` is bound to `{src}` without a copy, but "
                            f"`{cls.name}` updates `{t}` in place (line "
                            f"{updated[parts[1]]}): the caller's tensors "
                            "would change under it — bind a copy "
                            "(copy_tree, device_put_*(copy=True))")


# -------------------------------------------------------------------------


_UNHASHABLE_BASES = {"list", "List", "dict", "Dict", "set", "Set",
                     "bytearray", "MutableMapping", "MutableSequence",
                     "MutableSet", "ndarray", "Tensor"}
_UNHASHABLE_DISPLAYS = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                        ast.DictComp, ast.SetComp)
# receivers whose keys are cache or launch-shape keys
_KEYED_RE = re.compile(r"cache|bucket|seen", re.IGNORECASE)
# what is built once: per call in a hot path (or a loop) it is rebuilt
_BUILT_ONCE = {"ctypes.CDLL", "CDLL", "ctypes.cdll.LoadLibrary",
               "build.build", "torch.Generator", "torch.cuda.Stream",
               "torch.cuda.CUDAGraph", "torch.compile", "dist.new_group",
               "torch.distributed.new_group"}


class LaunchKeyHygiene(Rule):
    """RA002: cache and launch-shape keys must hash by value, and what is
    built once must not be built per call."""

    code = "RA002"
    name = "launch-key-hygiene"

    def check(self, f: SourceFile, ctx: RepoContext) -> Iterator[Finding]:
        yield from self._check_cached_args(f, ctx)
        yield from self._check_keys(f, ctx)
        yield from self._check_construction_sites(f)

    # ---- half 1: keys ----------------------------------------------------
    def _check_cached_args(self, f: SourceFile, ctx: RepoContext
                           ) -> Iterator[Finding]:
        for fn in _nodes(f):
            if not isinstance(fn, _FUNCS) \
                    or not has_decorator(fn, "lru_cache", "cache"):
                continue
            for p in all_params(fn):
                verdict = self._classify(p.annotation, ctx)
                if verdict is not None:
                    yield f.finding(
                        self.code, p,
                        f"argument `{p.arg}` of cached `{fn.name}` is "
                        f"annotated {verdict} — cache arguments are keys "
                        "and must hash by value (frozen dataclass / scalar "
                        "/ tuple)")

    def _check_keys(self, f: SourceFile, ctx: RepoContext
                    ) -> Iterator[Finding]:
        for node in _nodes(f):
            key: Optional[ast.AST] = None
            if isinstance(node, ast.Subscript) \
                    and _KEYED_RE.search(spelling(node.value) or ""):
                key = node.slice
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("get", "setdefault", "pop") \
                    and node.args \
                    and _KEYED_RE.search(spelling(node.func.value) or ""):
                key = node.args[0]
            elif isinstance(node, ast.Call) \
                    and (spelling(node.func) or "").split(".")[-1] \
                    == "record_launch":
                yield from self._check_signature(f, node)
            if key is None:
                continue
            verdict = self._key_verdict(key, node, ctx)
            if verdict is not None:
                yield f.finding(
                    self.code, node,
                    f"cache key is {verdict} — a key must hash by value "
                    "(declare @dataclass(frozen=True), or key on a tuple "
                    "of scalars)")

    def _key_verdict(self, key: ast.AST, node: ast.AST, ctx: RepoContext
                     ) -> Optional[str]:
        """A key of a cache-named receiver: an unhashable display, or a
        parameter annotated with an unhashable type."""
        parts = key.elts if isinstance(key, ast.Tuple) else [key]
        for part in parts:
            if isinstance(part, _UNHASHABLE_DISPLAYS):
                return f"an unhashable {type(part).__name__.lower()}"
            if isinstance(part, ast.Name):
                fn = enclosing_function(node)
                ann = next((p.annotation for p in all_params(fn)
                            if p.arg == part.id), None) if fn else None
                verdict = self._classify(ann, ctx)
                if verdict is not None:
                    return f"`{part.id}`, annotated {verdict}"
        return None

    def _check_signature(self, f: SourceFile, call: ast.Call
                         ) -> Iterator[Finding]:
        """``record_launch(kernel, route, *shape)``: the shape dims are
        the sentinel's key, host ints."""
        fn = enclosing_function(call)
        vals = _values_of(f, fn) if fn is not None else None
        for a in call.args[2:]:
            if isinstance(a, _UNHASHABLE_DISPLAYS) or (
                    vals is not None and DEV in vals.kinds(a)):
                yield f.finding(
                    self.code, a,
                    "launch-shape signature dim is not a host int — the "
                    "sentinel keys on shapes; a tensor or container here "
                    "keys on values (and a tensor syncs)")

    def _classify(self, ann: Optional[ast.AST], ctx: RepoContext
                  ) -> Optional[str]:
        """None = fine/unknown; else a description of the problem."""
        if ann is None:
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return None
        if isinstance(ann, ast.Subscript):
            base = (spelling(ann.value) or "").split(".")[-1]
            if base in ("Optional", "Union"):
                inner = ann.slice
                elts = inner.elts if isinstance(inner, ast.Tuple) else [inner]
                for el in elts:
                    v = self._classify(el, ctx)
                    if v is not None:
                        return v
                return None
            if base in _UNHASHABLE_BASES:
                return f"`{base}[...]` (unhashable)"
            return None
        if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
            for side in (ann.left, ann.right):
                v = self._classify(side, ctx)
                if v is not None:
                    return v
            return None
        base = (spelling(ann) or "").split(".")[-1]
        if not base:
            return None
        if base in _UNHASHABLE_BASES:
            return f"`{base}` (unhashable)"
        if base in ctx.plain_dataclasses:
            return (f"`{base}`, a non-frozen dataclass (declare "
                    "@dataclass(frozen=True) so it hashes by value)")
        return None

    # ---- half 2: per-call construction -----------------------------------
    def _check_construction_sites(self, f: SourceFile) -> Iterator[Finding]:
        hot = set(hot_functions(f))
        for node in _nodes(f):
            if not isinstance(node, ast.Call):
                continue
            what = spelling(node.func)
            if what not in _BUILT_ONCE:
                continue
            parent = getattr(node, "ra_parent", None)
            if isinstance(parent, _FUNCS) and node in parent.decorator_list:
                continue                # decorators run once at def time
            fn = enclosing_function(node)
            if fn is None or has_decorator(fn, "lru_cache", "cache"):
                continue                # module scope / cached builder
            if loop_ancestors(node, stop_at=fn):
                yield f.finding(
                    self.code, node,
                    f"`{what}` constructed inside a loop in `{fn.name}` — "
                    "every iteration builds a fresh one; hoist it out or "
                    "wrap the builder in functools.lru_cache")
            elif fn in hot:
                yield f.finding(
                    self.code, node,
                    f"`{what}` constructed inside hot-path function "
                    f"`{fn.name}` — build it once (module scope, "
                    "__init__, or an lru_cache'd builder)")


# -------------------------------------------------------------------------


_SYNC_CALLS = {"float", "int", "bool", "np.asarray", "np.array",
               "numpy.asarray", "numpy.array", "torch.nonzero",
               "torch.unique", "torch.masked_select",
               "torch.unique_consecutive"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "nonzero"}
_ALWAYS_SYNC = {"torch.cuda.synchronize"}


class HostSyncInHotPath(Rule):
    """RA003: host synchronization on values that may live on the card
    inside serving and training hot paths. Deliberate sync points are
    documented with a noqa or a baseline entry — that is the point: syncs
    become visible."""

    code = "RA003"
    name = "host-sync-in-hot-path"

    def check(self, f: SourceFile, ctx: RepoContext) -> Iterator[Finding]:
        for fn in hot_functions(f):
            vals = _values_of(f, fn)
            for node in _own_nodes(fn):
                hit = self._sync(node, vals)
                if hit is not None:
                    what, why = hit
                    yield f.finding(
                        self.code, self._where(node),
                        f"host sync `{what}` {why} inside hot path "
                        f"`{fn.name}` — blocks the host on the card; if "
                        "deliberate, annotate `# noqa: RA003` with a "
                        "rationale")

    @staticmethod
    def _where(node: ast.AST) -> ast.AST:
        """The line the interpreter reports while the sync runs (a frame's
        ``f_lineno``, which the card's twin reads): a branch's test, and
        for a method call the line of its ``.name``."""
        if isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)):
            return node.test
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute):
            return ast.Pass(lineno=node.func.end_lineno)
        return node

    @staticmethod
    def _sync(node: ast.AST, vals: _Values) -> Optional[Tuple[str, str]]:
        def dev(expr: ast.AST) -> Optional[str]:
            if DEV not in vals.kinds(expr):
                return None
            return ast.unparse(expr)[:40]

        if isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)):
            hit = dev(node.test)
            return ("bool(...)", f"(a branch) on device value `{hit}`") \
                if hit else None
        parent = getattr(node, "ra_parent", None)
        if getattr(parent, "test", None) is node:
            return None                 # the branch's own finding
        if isinstance(node, ast.BoolOp):
            hit = next((h for h in map(dev, node.values) if h), None)
            return ("bool(...)", f"on device value `{hit}`") if hit else None
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            hit = dev(node.operand)
            return ("not", f"on device value `{hit}`") if hit else None
        if not isinstance(node, ast.Call):
            return None
        callee = spelling(node.func) or ""
        if callee in _ALWAYS_SYNC:
            return callee, "(waits for every queued kernel)"
        if callee in _SYNC_CALLS:
            hit = next((h for h in map(dev, node.args) if h), None)
            return (callee, f"on device value `{hit}`") if hit else None
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            recv = node.func.value
            if attr in _SYNC_METHODS and not callee.startswith(
                    ("np.", "numpy.", "torch.")):
                hit = dev(recv)
                return (f".{attr}()", f"on device value `{hit}`") \
                    if hit else None
            if attr in ("to", "cuda") and _moves_to_device(node) \
                    and HOSTT in vals.kinds(recv):
                return (f".{attr}(device)", "(a host-to-card copy from "
                        f"pageable memory) of `{ast.unparse(recv)[:40]}`")
        if callee in _TORCH_FROM_HOST \
                and keyword_value(node, "device") is not None \
                and node.args and DEV not in vals.kinds(node.args[0]):
            return (callee, "(a host-to-card copy from pageable memory)")
        return None


def _own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Every node of ``fn`` outside its nested function bodies (each
    nested function is checked on its own when it is hot)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (*_FUNCS, ast.Lambda, ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


# -------------------------------------------------------------------------


def _is_launch(call: ast.AST) -> bool:
    """``lib.<kernel>_launch(...)``: a call into the kernel library."""
    return isinstance(call, ast.Call) \
        and isinstance(call.func, ast.Attribute) \
        and call.func.attr.endswith("_launch") \
        and spelling(call.func.value) == "lib"


def _is_twin(call: ast.AST) -> bool:
    """A call of a kernel's plain PyTorch twin (``*_ref``, the chunked
    log-prob)."""
    if not isinstance(call, ast.Call):
        return False
    base = (spelling(call.func) or "").split(".")[-1]
    return base.endswith("_ref") or base == "chunked_logprob"


def _is_cpu_test(test: ast.AST) -> bool:
    """``x.device.type == "cpu"`` (either side)."""
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Eq)):
        return False
    sides = [test.left, test.comparators[0]]
    return any(isinstance(s, ast.Constant) and s.value == "cpu"
               for s in sides) and any(
        (spelling(s) or "").endswith(".device.type") for s in sides)


def _is_stream(expr: ast.AST) -> bool:
    """``torch.cuda.current_stream(...).cuda_stream``."""
    return isinstance(expr, ast.Attribute) and expr.attr == "cuda_stream" \
        and isinstance(expr.value, ast.Call) \
        and spelling(expr.value.func) == "torch.cuda.current_stream"


class KernelWrapperContract(Rule):
    """RA004: a kernel launch runs on torch's current stream, raises on a
    CUDA error through ``_raise_on``, follows its input check, is counted
    with ``build.count_launch``, and the twin is reached only for a CPU
    tensor."""

    code = "RA004"
    name = "kernel-wrapper-contract"

    def check(self, f: SourceFile, ctx: RepoContext) -> Iterator[Finding]:
        launchers = sorted({enclosing_function(n) for n in _nodes(f)
                            if _is_launch(n)} - {None},
                           key=lambda fn: fn.lineno)
        for fn in launchers:
            yield from self._check_launcher(f, fn)
        if launchers or "/kernels/" in f.rel:
            yield from self._check_fallbacks(f)

    def _check_launcher(self, f: SourceFile, fn: ast.AST
                        ) -> Iterator[Finding]:
        nodes = sorted((n for n in _own_nodes(fn) if hasattr(n, "lineno")),
                       key=lambda n: (n.lineno, n.col_offset))
        streams = {t for s in function_statements(fn.body)
                   if isinstance(s, ast.Assign) and _is_stream(s.value)
                   for t in assign_targets(s)}
        for call in (n for n in nodes if _is_launch(n)):
            kernel = call.func.attr
            if not any(_is_stream(a) or spelling(a) in streams
                       for a in call.args):
                yield f.finding(
                    self.code, call,
                    f"`{kernel}` is not handed "
                    "`torch.cuda.current_stream(dev).cuda_stream`: the "
                    "kernel would run outside torch's stream order")
            stmt = enclosing_statement(call)
            errs = assign_targets(stmt) if isinstance(stmt, ast.Assign) \
                and stmt.value is call else []
            if not errs or not any(
                    isinstance(n, ast.Call)
                    and (spelling(n.func) or "").split(".")[-1] == "_raise_on"
                    and n.args and spelling(n.args[0]) in errs
                    for n in nodes):
                yield f.finding(
                    self.code, call,
                    f"the return code of `{kernel}` is not checked through "
                    "`_raise_on(err, ...)`: a failed launch must raise")
            cur = getattr(call, "ra_parent", None)
            while cur is not None and cur is not fn:
                if isinstance(cur, ast.Try):
                    yield f.finding(
                        self.code, cur,
                        f"`{kernel}` is launched inside `try:` — a CUDA "
                        "error must raise, not fall back")
                    break
                cur = getattr(cur, "ra_parent", None)
        if not any(isinstance(n, ast.Call)
                   and spelling(n.func) == "build.count_launch"
                   for n in nodes):
            yield f.finding(
                self.code, fn,
                f"`{fn.name}` launches a kernel but never records it with "
                "`build.count_launch`: the launch counts would miss it")
        first_ptr = next((n for n in nodes if isinstance(n, ast.Call)
                          and isinstance(n.func, ast.Attribute)
                          and n.func.attr == "data_ptr"), None)
        if first_ptr is not None and not any(
                self._is_input_check(n) for n in nodes
                if (n.lineno, n.col_offset)
                < (first_ptr.lineno, first_ptr.col_offset)):
            yield f.finding(
                self.code, first_ptr,
                f"`{fn.name}` reads a pointer before any input check "
                "(`_check(...)`, or an `if ...: raise`): validate device, "
                "dtype, shape and alignment before handing pointers over")
        for n in nodes:
            if _is_twin(n) and not self._under_cpu_branch(n, fn):
                yield f.finding(
                    self.code, n,
                    f"`{fn.name}` reaches the twin outside a "
                    "`.device.type == \"cpu\"` branch: the twin runs only "
                    "for a CPU tensor; a CUDA tensor launches or raises")

    @staticmethod
    def _is_input_check(node: ast.AST) -> bool:
        if isinstance(node, ast.Call):
            return (spelling(node.func) or "").split(".")[-1].startswith(
                "_check")
        return isinstance(node, ast.If) and any(
            isinstance(s, ast.Raise) for s in node.body)

    @staticmethod
    def _under_cpu_branch(node: ast.AST, fn: ast.AST) -> bool:
        child, cur = node, getattr(node, "ra_parent", None)
        while cur is not None and cur is not fn:
            if isinstance(cur, ast.If) and child in cur.body \
                    and _is_cpu_test(cur.test):
                return True
            child, cur = cur, getattr(cur, "ra_parent", None)
        return False

    def _check_fallbacks(self, f: SourceFile) -> Iterator[Finding]:
        for tr in _nodes(f):
            if not isinstance(tr, ast.Try):
                continue
            for part in [*tr.handlers, *tr.finalbody]:
                for n in ast.walk(part):
                    if _is_twin(n):
                        yield f.finding(
                            self.code, n,
                            "the twin is reached from an `except` / "
                            "`finally`: a failed launch or build must "
                            "raise, never fall back to the plain version")


# -------------------------------------------------------------------------


_MUTATOR_METHODS = {"append", "appendleft", "add", "update", "pop",
                    "popitem", "popleft", "extend", "insert", "remove",
                    "discard", "clear", "setdefault", "difference_update",
                    "intersection_update", "symmetric_difference_update"}
# attribute types that are themselves synchronized — calling into them
# from several threads is their job
_THREADSAFE_CTORS = {"Queue", "LifoQueue", "PriorityQueue", "SimpleQueue",
                     "Event", "Lock", "RLock", "Condition", "Semaphore",
                     "BoundedSemaphore", "Barrier"}


class UnlockedCrossThreadMutation(Rule):
    """RA005: classes handed to ``threading.Thread`` targets (directly or
    via annotated parameters of the target function) must guard every
    ``self`` mutation with ``with self._lock`` — methods named
    ``*_locked`` are exempt (convention: the caller holds the lock)."""

    code = "RA005"
    name = "unlocked-cross-thread-mutation"

    def check(self, f: SourceFile, ctx: RepoContext) -> Iterator[Finding]:
        shared = self._thread_shared_classes(f, ctx)
        for cls_name in sorted(shared):
            entry = ctx.class_defs.get(cls_name)
            if entry is None:
                continue
            cf, cls = entry
            if cf.rel != f.rel:
                # report in the file that *defines* the class only when
                # that file is the one being checked — avoids duplicate
                # findings when both files are in the run set. The class
                # is checked when its defining file comes through.
                if cls_name not in self._thread_shared_classes(cf, ctx):
                    yield from self._check_class(cf, cls)
                continue
            yield from self._check_class(cf, cls)

    # ---- which classes cross threads -----------------------------------
    def _thread_shared_classes(self, f: SourceFile, ctx: RepoContext
                               ) -> Set[str]:
        shared: Set[str] = set()
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            callee = (spelling(node.func) or "").split(".")[-1]
            if callee != "Thread":
                continue
            target = keyword_value(node, "target")
            if target is None and node.args:
                target = node.args[0]
            if target is None:
                continue
            sp = spelling(target) or ""
            entry_fn: Optional[ast.AST] = None
            if sp.startswith("self."):
                cls = enclosing_class(node)
                if cls is not None:
                    shared.add(cls.name)
                    entry_fn = next(
                        (m for m in cls.body
                         if isinstance(m, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))
                         and m.name == sp.split(".", 1)[1]), None)
            else:
                base = sp.split(".")[-1]
                entry_fn = next(
                    (n for n in ast.walk(f.tree)
                     if isinstance(n, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))
                     and n.name == base), None)
            if entry_fn is not None:
                for p in all_params(entry_fn):
                    ann = p.annotation
                    if isinstance(ann, ast.Constant) \
                            and isinstance(ann.value, str):
                        try:
                            ann = ast.parse(ann.value, mode="eval").body
                        except SyntaxError:
                            ann = None
                    base = (spelling(ann) or "").split(".")[-1] \
                        if ann is not None else ""
                    if base in ctx.class_defs:
                        shared.add(base)
        return shared

    # ---- per-class check ------------------------------------------------
    def _check_class(self, f: SourceFile, cls: ast.ClassDef
                     ) -> Iterator[Finding]:
        safe_attrs = self._threadsafe_attrs(cls)
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                continue
            if method.name in ("__init__", "__post_init__") \
                    or method.name.endswith("_locked"):
                continue
            for node, desc in self._mutations(method):
                attr = desc.split(".")[1] if "." in desc else desc
                if attr in safe_attrs or "lock" in attr:
                    continue
                if self._under_lock(node, method):
                    continue
                yield f.finding(
                    self.code, node,
                    f"`{cls.name}.{method.name}` mutates `{desc}` "
                    "without holding self._lock, but instances of "
                    f"`{cls.name}` cross threads (threading.Thread "
                    "target) — guard with `with self._lock:` or rename "
                    "the method `*_locked` if the caller holds it")

    @staticmethod
    def _threadsafe_attrs(cls: ast.ClassDef) -> Set[str]:
        out: Set[str] = set()
        init = next((m for m in cls.body
                     if isinstance(m, ast.FunctionDef)
                     and m.name == "__init__"), None)
        if init is None:
            return out
        for stmt in ast.walk(init):
            if not isinstance(stmt, ast.Assign):
                continue
            if not isinstance(stmt.value, ast.Call):
                continue
            ctor = (spelling(stmt.value.func) or "").split(".")[-1]
            if ctor in _THREADSAFE_CTORS:
                for t in assign_targets(stmt):
                    if t.startswith("self."):
                        out.add(t.split(".", 1)[1])
        return out

    @staticmethod
    def _mutations(method: ast.AST) -> Iterator[Tuple[ast.AST, str]]:
        for node in ast.walk(method):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    stack = [t]
                    while stack:
                        el = stack.pop()
                        if isinstance(el, (ast.Tuple, ast.List)):
                            stack.extend(el.elts)
                            continue
                        base = el
                        if isinstance(base, ast.Subscript):
                            base = base.value
                        sp = spelling(base) or ""
                        if sp.startswith("self."):
                            yield node, ".".join(sp.split(".")[:2])
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _MUTATOR_METHODS:
                sp = spelling(node.func.value) or ""
                if sp.startswith("self."):
                    yield node, ".".join(sp.split(".")[:2])

    @staticmethod
    def _under_lock(node: ast.AST, method: ast.AST) -> bool:
        cur = getattr(node, "ra_parent", None)
        while cur is not None and cur is not method:
            if isinstance(cur, (ast.With, ast.AsyncWith)):
                for item in cur.items:
                    sp = spelling(item.context_expr) or ""
                    if isinstance(item.context_expr, ast.Call):
                        sp = spelling(item.context_expr.func) or ""
                    if sp.startswith("self.") and "lock" in sp.lower():
                        return True
            cur = getattr(cur, "ra_parent", None)
        return False


# -------------------------------------------------------------------------


def default_rules() -> List[Rule]:
    return [AliasAcrossInplaceUpdate(), LaunchKeyHygiene(),
            HostSyncInHotPath(), KernelWrapperContract(),
            UnlockedCrossThreadMutation()]


RULE_DOCS: Dict[str, str] = {
    r.code: f"{r.name}: {r.__doc__.strip().splitlines()[0]}"
    for r in default_rules()
}
