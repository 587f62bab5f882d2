"""Project-specific AST lint: the port's performance invariants as rules.

PyTorch counterpart of ``repro.analysis.lint``. The port's performance story
rests on invariants that are otherwise enforced by convention only: one CUDA
graph per run signature, no host sync inside a captured region, carries
updated in place. This module checks the statically visible ones over the
source AST -- no imports, no tracing, no device -- under the JAX package's
rule names:

* ``traced-host-sync``   -- host synchronization (``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``float``/``int``/``bool`` on a non-constant,
  ``torch.cuda.synchronize``, ``torch.tensor``/``torch.as_tensor`` of host
  data, ``np.asarray``, ``time.*``, Python RNG) inside functions *reachable
  from a CUDA-graph capture*: the first argument of
  ``repro_torch.core.executor.Graphed(...)`` (or, when that argument is a
  call, the closure the called factory returns), the callables given to
  ``torch.cuda.make_graphed_callables``, and the body of a
  ``with torch.cuda.graph(...)`` block. The kernels' plain versions
  (``repro_torch.kernels.ref`` and the ``*_plain`` functions of
  ``repro_torch.kernels``) run only on the CPU, where nothing is captured,
  so the graph does not follow calls into them.
* ``mesh-via-make-mesh`` -- ``torch.distributed.device_mesh.init_device_mesh``
  / ``DeviceMesh(...)`` outside ``launch/mesh.py``. The port builds no device
  mesh on one card, so the rule guards the day one is added.
* ``registry-hooks``     -- every ``@register_protocol`` / compressor / delay
  entry of ``repro_torch.core`` implements the abstract hooks its base class
  declares (protocols must also state ``default_sigma_prime`` and
  ``coalesce_supported`` in their own class chain), and every
  ``register_solver`` entry matches the port's solver signature: a function
  ``(w_all, alpha, X, y, norms_sq, lam, n_global, sigma_prime, keys, draws,
  *, loss, num_steps)``, or a ``LocalSolver(draw, solve)`` whose ``draw``
  takes ``(keys, draws, *, n_k, num_steps, norms_sq, lam, n_global,
  sigma_prime, device)`` and whose ``solve`` takes ``(orders, w_all, alpha,
  X, y, norms_sq, lam, n_global, sigma_prime, *, loss, cells, map_error)``.
* ``typed-errors``       -- no ``except Exception`` without a re-raise under
  ``serve/`` (unless marked ``fail-fast-ok``), as in the JAX package.
* ``version-floor``      -- torch spellings that the card's torch 2.11 lacks
  and the CPU tests' torch 2.13 has (``torch.nn.functional.
  linear_cross_entropy``, ``Tensor.const_data_ptr``, ...), each confirmed
  missing on the H100 by ``hasattr``.

The JAX rules with no counterpart here, and why:

* ``pallas-scalar-index`` -- the port has no Pallas; its kernels are CUDA C++
  in ``csrc/``, outside this Python lint.
* ``jit-donation`` -- the port has no ``jax.jit`` and so no donation to
  declare; the invariant it guarded (a carry updated in place, not copied)
  is checked at run time by the ``donation-*`` contracts
  (:mod:`repro_torch.analysis.contracts`).
* ``f64-without-x64`` -- torch has no x64 flag: ``torch.float64`` is float64
  on every configuration, so nothing silently truncates.

Rules are registry entries (:func:`register_rule`): subclass :class:`Rule`,
decorate, and the rule runs in every ``python -m repro_torch analyze``.
Findings are suppressed line- or scope-wise with the JAX package's pragmas::

    x = host_value.item()        # analysis: host-ok        (this line)
    def eval_loop(...):          # analysis: ignore[traced-host-sync]
    except Exception as e:       # analysis: fail-fast-ok (why)

and pre-existing accepted findings live in the checked-in baseline
(``ANALYSIS_BASELINE_TORCH.json``, see :mod:`repro_torch.analysis.findings`).
"""

from __future__ import annotations

import ast
import pathlib
import re

from repro_torch.analysis.findings import Finding, sort_findings

# ---------------------------------------------------------------------------
# Rule registry (mirrors the protocol/compressor/delay registries).
# ---------------------------------------------------------------------------

_RULES: dict[str, type["Rule"]] = {}


def register_rule(name: str):
    """Class decorator: add a :class:`Rule` to the analyzer's registry."""

    def deco(cls: type["Rule"]) -> type["Rule"]:
        cls.rule_name = name
        _RULES[name] = cls
        return cls

    return deco


def available_rules() -> tuple[str, ...]:
    return tuple(sorted(_RULES))


def get_rule(name: str) -> type["Rule"]:
    try:
        return _RULES[name]
    except KeyError:
        raise ValueError(
            f"unknown analysis rule {name!r}; available: {available_rules()}"
        ) from None


def default_rules() -> tuple[str, ...]:
    """All registered rules except ``*-example`` entries (worked examples
    registered at test time must not police the repo)."""
    return tuple(n for n in available_rules()
                 if not n.endswith(("-example", "_example")))


class Rule:
    """One statically checkable invariant.

    Subclass, set ``description``, implement :meth:`check`, and decorate with
    :func:`register_rule`. ``check`` receives one parsed module plus the
    whole-project index (for cross-module rules) and returns raw findings;
    the entry points apply pragma suppression and baseline matching afterwards.
    """

    rule_name = "abstract"
    description = ""

    def check(self, module: "ModuleInfo",
              project: "ProjectIndex") -> list[Finding]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Parsed-module model: pragmas, imports, scoped function table.
# ---------------------------------------------------------------------------

_PRAGMA_RE = re.compile(r"#\s*analysis:\s*([a-z0-9_\-\[\],\s*]+)")
_PRAGMA_ALIASES = {"host-ok": "traced-host-sync", "fail-fast-ok": "typed-errors"}


def _parse_pragmas(lines: list[str]) -> dict[int, set[str]]:
    """line number -> suppressed rule names (``{"*"}`` suppresses all)."""
    out: dict[int, set[str]] = {}
    for i, text in enumerate(lines, start=1):
        m = _PRAGMA_RE.search(text)
        if not m:
            continue
        spec = m.group(1).strip()
        rules: set[str] = set()
        for tok in re.split(r"[\s,]+", spec):
            if not tok:
                continue
            im = re.fullmatch(r"ignore(?:\[([a-z0-9_\-,]+)\])?", tok)
            if im:
                rules |= set(im.group(1).split(",")) if im.group(1) else {"*"}
            else:
                rules.add(_PRAGMA_ALIASES.get(tok, tok))
        out[i] = rules
    return out


def _dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


class FunctionNode:
    """One ``def``, traced ``lambda`` or captured ``with`` block, with its
    scope and call edges."""

    def __init__(self, module: "ModuleInfo", node, qualname: str):
        self.module = module
        self.node = node
        self.qualname = qualname
        self.edges: set["FunctionNode"] = set()
        # local name -> closures of the factory call it was assigned from
        self.closure_aliases: dict[str, list["FunctionNode"]] = {}

    def own_statements(self):
        """Direct AST nodes of this function, nested defs excluded (they are
        their own FunctionNodes). A lambda's body belongs to the function
        that holds it, where it runs when called (``lambda: Graphed(...)``)."""
        skip = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        if isinstance(self.node, ast.Lambda):
            stack = [self.node.body]
        else:
            stack = list(self.node.body)
        while stack:
            n = stack.pop()
            yield n
            for child in ast.iter_child_nodes(n):
                if not isinstance(child, skip):
                    stack.append(child)


class ModuleInfo:
    """One parsed source file: AST + pragmas + import map + function table."""

    def __init__(self, path: pathlib.Path, source: str, relpath: str):
        self.path = path
        self.relpath = relpath
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=str(path))
        self.pragmas = _parse_pragmas(self.lines)
        self.modname = _modname_for(relpath)
        self.is_package = pathlib.PurePosixPath(relpath).stem == "__init__"
        self.imports: dict[str, str] = {}
        self.functions: dict[str, FunctionNode] = {}
        self.classes: dict[str, ast.ClassDef] = {}
        self._scope_lines: dict[str, tuple[int, int]] = {}
        self._collect_imports()
        self._collect_defs()

    # -- construction ------------------------------------------------------

    def _import_base(self, node: ast.ImportFrom) -> str | None:
        """The absolute module of a ``from`` import (relative ones resolved
        against this module's package)."""
        if not node.level:
            return node.module
        parts = self.modname.split(".")
        if not self.is_package:
            parts = parts[:-1]
        if node.level - 1 > len(parts):
            return None
        parts = parts[:len(parts) - (node.level - 1)]
        return ".".join(parts + ([node.module] if node.module else [])) or None

    def _collect_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.imports[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                base = self._import_base(node)
                if not base:
                    continue
                for a in node.names:
                    self.imports[a.asname or a.name] = f"{base}.{a.name}"

    def _collect_defs(self) -> None:
        def visit(node, prefix):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    q = f"{prefix}{child.name}"
                    self.functions[q] = FunctionNode(self, child, q)
                    self._scope_lines[q] = (child.lineno,
                                            child.end_lineno or child.lineno)
                    visit(child, f"{q}.")
                elif isinstance(child, ast.ClassDef):
                    q = f"{prefix}{child.name}"
                    self.classes[q] = child
                    self._scope_lines[q] = (child.lineno,
                                            child.end_lineno or child.lineno)
                    visit(child, f"{q}.")
                else:
                    visit(child, prefix)

        visit(self.tree, "")

    # -- helpers rules use -------------------------------------------------

    def canonical(self, node: ast.AST) -> str | None:
        """Alias-resolved dotted name of an expression (``np.asarray`` ->
        ``numpy.asarray``; a name defined at this module's top level ->
        ``<module>.<name>``), or None for non-name expressions."""
        dotted = _dotted(node)
        if dotted is None:
            return None
        head, _, rest = dotted.partition(".")
        if head in self.imports:
            head = self.imports[head]
        elif head in self.functions or head in self.classes:
            head = f"{self.modname}.{head}"
        return f"{head}.{rest}" if rest else head

    def enclosing(self, line: int) -> str:
        """Qualname of the innermost def/class containing ``line``."""
        best, best_span = "", None
        for q, (lo, hi) in self._scope_lines.items():
            if lo <= line <= hi and (best_span is None
                                     or hi - lo <= best_span):
                best, best_span = q, hi - lo
        return best

    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def suppressed(self, rule: str, line: int) -> bool:
        """Pragma on the line itself or on any enclosing def/class header."""
        check = [line]
        for q, (lo, hi) in self._scope_lines.items():
            if lo <= line <= hi:
                check.append(lo)
        for ln in check:
            rules = self.pragmas.get(ln)
            if rules and ("*" in rules or rule in rules):
                return True
        return False

    def finding(self, rule: str, line: int, message: str) -> Finding:
        return Finding(rule=rule, path=self.relpath, line=line,
                       message=message, context=self.enclosing(line),
                       snippet=self.snippet(line))


def _modname_for(relpath: str) -> str:
    p = pathlib.PurePosixPath(relpath)
    parts = list(p.with_suffix("").parts)
    if "src" in parts:
        parts = parts[parts.index("src") + 1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


# ---------------------------------------------------------------------------
# Project index: cross-module name resolution + capture reachability.
# ---------------------------------------------------------------------------

# Calls whose function-valued FIRST argument runs inside a CUDA-graph
# capture: the executor's captured run and torch's graphed callables (which
# also take a tuple of callables).
CAPTURE_CONSUMERS = frozenset({
    "repro_torch.core.executor.Graphed",
    "torch.cuda.make_graphed_callables",
    "torch.cuda.graphs.make_graphed_callables",
})
# Context managers whose ``with`` body is captured.
CAPTURE_CONTEXTS = frozenset({"torch.cuda.graph", "torch.cuda.graphs.graph"})
# The kernels' plain versions: one launch on the card, run only on the CPU.
STANDIN_MODULES = frozenset({"repro_torch.kernels.ref"})
KERNELS_PACKAGE = "repro_torch.kernels"


def _is_standin(fn: FunctionNode) -> bool:
    mod = fn.module.modname
    return mod in STANDIN_MODULES or (
        (mod == KERNELS_PACKAGE or mod.startswith(KERNELS_PACKAGE + "."))
        and fn.qualname.endswith("_plain"))


class ProjectIndex:
    """All parsed modules + the captured-code call graph over them."""

    def __init__(self, modules: list[ModuleInfo]):
        self.modules = modules
        self.by_modname = {m.modname: m for m in modules}
        self._roots: set[FunctionNode] = set()
        for module in modules:
            self._add_capture_blocks(module)
        self._build_graph()
        self._reachable = self._close_over_roots()

    # -- name resolution ---------------------------------------------------

    def _lookup(self, module: ModuleInfo, scope: str,
                dotted: str) -> tuple[ModuleInfo, str] | None:
        """(module, qualname) of the project def or class that ``dotted``
        names from ``scope``: nested defs outward, then module level, then
        project imports."""
        if "." not in dotted:
            prefix = scope
            while True:
                q = f"{prefix}.{dotted}" if prefix else dotted
                if q in module.functions or q in module.classes:
                    return module, q
                if not prefix:
                    break
                prefix = prefix.rpartition(".")[0]
            target = module.imports.get(dotted)
        else:
            head, _, rest = dotted.partition(".")
            base = module.imports.get(head)
            target = f"{base}.{rest}" if base else None
        if not target:
            return None
        mod, _, attr = target.rpartition(".")
        other = self.by_modname.get(mod)
        if other is not None and (attr in other.functions or attr in other.classes):
            return other, attr
        return None

    @staticmethod
    def _node(found) -> FunctionNode | None:
        """A looked-up def's FunctionNode; a class's ``__init__``."""
        if found is None:
            return None
        module, q = found
        return module.functions.get(f"{q}.__init__" if q in module.classes else q)

    def resolve_call(self, module: ModuleInfo, scope: str,
                     func: ast.AST) -> FunctionNode | None:
        """Resolve a call's target FunctionNode (project functions only)."""
        if isinstance(func, ast.Attribute):
            if isinstance(func.value, ast.Name) and func.value.id == "self":
                # self.method(...) inside a class's method (or a def in one).
                cls = scope
                while cls and cls not in module.classes:
                    cls = cls.rpartition(".")[0]
                return module.functions.get(f"{cls}.{func.attr}") if cls else None
            if isinstance(func.value, ast.Call):
                # Cls(...).method(...)
                dotted = _dotted(func.value.func)
                found = self._lookup(module, scope, dotted) if dotted else None
                if found is None or found[1] not in found[0].classes:
                    return None
                return found[0].functions.get(f"{found[1]}.{func.attr}")
        dotted = _dotted(func)
        return self._node(self._lookup(module, scope, dotted)) if dotted else None

    def _local_closures(self, module: ModuleInfo, scope: str,
                        name: str) -> list[FunctionNode]:
        """Closures a factory call assigned to local ``name`` returned."""
        fnode = module.functions.get(scope)
        while fnode is not None:
            found = fnode.closure_aliases.get(name)
            if found is not None:
                return found
            up = fnode.qualname.rpartition(".")[0]
            fnode = module.functions.get(up) if up else None
        return []

    @staticmethod
    def returned_closures(fn: FunctionNode) -> list[FunctionNode]:
        """The defs nested in ``fn`` that it returns by name (a factory's
        closures)."""
        out = []
        for stmt in fn.own_statements():
            if isinstance(stmt, ast.Return) and isinstance(stmt.value, ast.Name):
                nested = fn.module.functions.get(f"{fn.qualname}.{stmt.value.id}")
                if nested is not None:
                    out.append(nested)
        return out

    # -- graph construction ------------------------------------------------

    def _add_capture_blocks(self, module: ModuleInfo) -> None:
        """Each ``with torch.cuda.graph(...)`` body becomes a root node."""
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            if not any(isinstance(item.context_expr, ast.Call)
                       and module.canonical(item.context_expr.func)
                       in CAPTURE_CONTEXTS for item in node.items):
                continue
            scope = module.enclosing(node.lineno)
            q = f"{scope}.<graph:{node.lineno}>" if scope else f"<graph:{node.lineno}>"
            fn = FunctionNode(module, node, q)
            module.functions[q] = fn
            self._roots.add(fn)

    def _consumer_roots(self, module: ModuleInfo, scope: str,
                        call: ast.Call) -> list[FunctionNode]:
        """What a capture consumer's first argument runs in the capture."""
        if not call.args:
            return []
        first = call.args[0]
        args = first.elts if isinstance(first, (ast.Tuple, ast.List)) else [first]
        out: list[FunctionNode] = []
        for arg in args:
            if isinstance(arg, ast.Lambda):
                q = f"<lambda:{arg.lineno}>"
                fn = FunctionNode(module, arg, f"{scope}.{q}" if scope else q)
                module.functions.setdefault(fn.qualname, fn)
                out.append(module.functions[fn.qualname])
            elif isinstance(arg, ast.Call):
                factory = self.resolve_call(module, scope, arg.func)
                if factory is not None:
                    out.extend(self.returned_closures(factory))
            else:
                target = self.resolve_call(module, scope, arg)
                if target is not None:
                    out.append(target)
                if isinstance(arg, ast.Name):
                    out.extend(self._local_closures(module, scope, arg.id))
        return out

    def _build_graph(self) -> None:
        # Aliases first: a factory's closure alias may be used before (in
        # source order) the scope that assigns it is visited.
        for module in self.modules:
            for fn in list(module.functions.values()):
                for stmt in fn.own_statements():
                    if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
                        self._record_alias(module, fn, stmt)
        for module in self.modules:
            self._module_level_roots(module)
            done: set[str] = set()
            # A consumer's lambda argument becomes a node of its own while
            # this loop runs; it gets its edges on the next pass.
            while todo := [fn for q, fn in module.functions.items() if q not in done]:
                for fn in todo:
                    done.add(fn.qualname)
                    self._add_edges(module, fn)

    def _add_edges(self, module: ModuleInfo, fn: FunctionNode) -> None:
        scope = fn.qualname
        if isinstance(fn.node, (ast.With, ast.AsyncWith, ast.Lambda)):
            scope = module.enclosing(fn.node.lineno)
        for stmt in fn.own_statements():
            if not isinstance(stmt, ast.Call):
                continue
            if module.canonical(stmt.func) in CAPTURE_CONSUMERS:
                self._roots.update(self._consumer_roots(module, scope, stmt))
            targets = [self.resolve_call(module, scope, stmt.func)]
            if isinstance(stmt.func, ast.Name):
                targets += self._local_closures(module, scope, stmt.func.id)
            for target in targets:
                if target is not None and not _is_standin(target):
                    fn.edges.add(target)

    def _record_alias(self, module: ModuleInfo, fn: FunctionNode,
                      stmt: ast.Assign) -> None:
        """``x = factory(...)``: passing or calling ``x`` later means the
        closures ``factory`` returns."""
        factory = self.resolve_call(module, fn.qualname, stmt.value.func)
        closures = self.returned_closures(factory) if factory is not None else []
        for target in stmt.targets:
            if closures and isinstance(target, ast.Name):
                fn.closure_aliases[target.id] = closures

    def _module_level_roots(self, module: ModuleInfo) -> None:
        in_function = set()
        for fn in module.functions.values():
            if isinstance(fn.node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                lo, hi = fn.node.lineno, fn.node.end_lineno or fn.node.lineno
                in_function.add((lo, hi))

        def inside_def(line):
            return any(lo <= line <= hi for lo, hi in in_function)

        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call) or inside_def(node.lineno):
                continue
            if module.canonical(node.func) in CAPTURE_CONSUMERS:
                self._roots.update(self._consumer_roots(module, "", node))

    def _close_over_roots(self) -> set[FunctionNode]:
        seen: set[FunctionNode] = set()
        stack = list(self._roots)
        while stack:
            fn = stack.pop()
            if fn in seen:
                continue
            seen.add(fn)
            stack.extend(fn.edges)
        return seen

    def is_traced(self, fn: FunctionNode) -> bool:
        """Is ``fn`` reachable from any capture?"""
        return fn in self._reachable

    def traced_functions(self, module: ModuleInfo):
        return [fn for fn in module.functions.values() if self.is_traced(fn)]


# ---------------------------------------------------------------------------
# Rules.
# ---------------------------------------------------------------------------


@register_rule("version-floor")
class VersionFloorRule(Rule):
    """The card's torch floor: spellings the H100's torch 2.11 lacks.

    The CPU tests run on torch 2.13, the card on torch 2.11: code that uses a
    2.12+ spelling passes every CPU test and fails on the card. The table
    is the public names of the namespaces the port uses that exist in 2.13
    and that ``hasattr`` found missing on the card, less the submodules
    2.11 has but does not import with its package (``torch.fx.tensor_type``):
    ``chip_smoke.py`` ``analyze`` checks on every chip run that each is
    still missing, importing submodules first.
    """

    description = ("flags torch spellings missing from the card's torch 2.11 "
                   "(present in the CPU tests' 2.13): functions, classes "
                   "and Tensor methods probed on the H100")

    FLOOR = "2.11"
    BANNED = frozenset({
        "torch.thread_safe_generator", "torch.random.thread_safe_generator",
        "torch.nn.LinearCrossEntropyLoss", "torch.nn.LinearCrossEntropyOptions",
        "torch.nn.functional.linear_cross_entropy",
        "torch.cuda.caching_allocator_disabled", "torch.cuda.current_solver_handle",
        "torch.cuda.platform",
        "torch.distributed.all_gather_single", "torch.distributed.record_comm",
        "torch.distributed.reduce_scatter_single",
        "torch.accelerator.Graph", "torch.accelerator.empty_host_cache",
        "torch.accelerator.graphs",
        "torch.compiler.CacheInfo", "torch.compiler.get_default_backend",
        "torch.compiler.set_default_backend",
        "torch.autograd.enforce_grad_layout_policy",
        "torch.backends.cuda.blas_workspace_size",
        "torch.backends.cuda.cublas_workspace_size",
        "torch.backends.cuda.cublaslt_workspace_size",
        "torch.backends.cuda.is_ck_sdpa_available",
        "torch.func.rearrange", "torch.overrides.redispatch_function",
        "torch.optim.swap_in_optimizer_params_and_state",
        "torch.utils.checkpoint.SavedTensor",
    })
    TENSOR_METHODS = frozenset({"const_data_ptr"})

    def _message(self, name: str) -> str:
        return (f"{name} is missing from the card's torch {self.FLOOR} (the CPU "
                f"tests' torch has it); use a spelling both have")

    def check(self, module, project):
        out = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ImportFrom):
                base = module._import_base(node)
                for a in node.names:
                    if f"{base}.{a.name}" in self.BANNED:
                        out.append(module.finding(self.rule_name, node.lineno,
                                                  self._message(f"{base}.{a.name}")))
            elif isinstance(node, ast.Attribute):
                canon = module.canonical(node)
                if canon in self.BANNED:
                    out.append(module.finding(self.rule_name, node.lineno,
                                              self._message(canon)))
                elif node.attr in self.TENSOR_METHODS:
                    out.append(module.finding(self.rule_name, node.lineno,
                                              self._message(f"Tensor.{node.attr}")))
        return out


@register_rule("mesh-via-make-mesh")
class MeshRule(Rule):
    """The ROADMAP mesh rule, in torch: device meshes only in launch/mesh."""

    description = ("flags torch.distributed.device_mesh.init_device_mesh(...) / "
                   "DeviceMesh(...) outside launch/mesh.py; build meshes "
                   "there (the port runs on one card and builds none)")

    ALLOWED_IN = ("launch/mesh.py",)
    CONSTRUCTORS = {"torch.distributed.device_mesh.init_device_mesh",
                    "torch.distributed.device_mesh.DeviceMesh",
                    "torch.distributed.DeviceMesh"}

    def check(self, module, project):
        if module.relpath.endswith(self.ALLOWED_IN):
            return []
        out = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            canon = module.canonical(node.func)
            if canon in self.CONSTRUCTORS:
                out.append(module.finding(
                    self.rule_name, node.lineno,
                    f"direct {canon}(...) construction; build device meshes "
                    f"only in repro_torch/launch/mesh.py"))
        return out


@register_rule("traced-host-sync")
class TracedHostSyncRule(Rule):
    """No host synchronization inside captured code."""

    description = ("flags .item()/.tolist()/.cpu()/.numpy()/float()/int()/"
                   "bool()/torch.cuda.synchronize/torch.tensor/np.asarray/"
                   "time.*/Python RNG inside functions reachable from a "
                   "CUDA-graph capture (executor.Graphed, torch.cuda.graph, "
                   "make_graphed_callables); mark host-side-by-design lines "
                   "with `# analysis: host-ok`")

    _METHODS = {"item": ".item() forces a device->host sync",
                "tolist": ".tolist() forces a device->host sync",
                "cpu": ".cpu() copies to the host and syncs",
                "numpy": ".numpy() needs a host tensor (a device->host copy)"}
    _NUMPY = {"numpy.asarray", "numpy.array", "numpy.ascontiguousarray",
              "numpy.copyto", "numpy.save"}
    _HOST_DATA = {"torch.tensor", "torch.as_tensor"}
    _BUILTINS = {"float", "int", "bool"}
    _SCALAR_TYPES = {"float", "int", "bool"}

    def _scalar_params(self, fn: FunctionNode) -> set[str]:
        """Parameters of ``fn`` and of the defs enclosing it (a closure's
        free variables) annotated as a Python scalar (``float``, ``int``,
        ``bool``): converting one reads no tensor."""
        out: set[str] = set()
        q = fn.qualname
        while q:
            node = fn.module.functions.get(q)
            if node is not None and isinstance(node.node, (ast.FunctionDef,
                                                           ast.AsyncFunctionDef)):
                a = node.node.args
                out |= {p.arg for p in list(a.posonlyargs) + list(a.args)
                        + list(a.kwonlyargs) if isinstance(p.annotation, ast.Name)
                        and p.annotation.id in self._SCALAR_TYPES}
            q = q.rpartition(".")[0]
        return out

    def _call_finding(self, module, call, scalars=frozenset()) -> str | None:
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr in self._METHODS:
            return self._METHODS[func.attr]
        canon = module.canonical(func)
        if canon is None:
            return None
        if canon in self._NUMPY or canon.startswith("numpy.random."):
            return (f"{canon} materializes a host array inside captured code "
                    f"(keep it a tensor, or hoist it to the host side)")
        if canon == "torch.cuda.synchronize":
            return "torch.cuda.synchronize() waits for the device inside a capture"
        if canon in self._HOST_DATA:
            return (f"{canon}(...) of host data is a pageable host-to-device "
                    f"copy inside a capture (make the input before the run)")
        if canon.startswith("time."):
            return f"{canon}() reads the host clock inside captured code"
        if canon.startswith("random."):
            return (f"{canon}() draws host randomness inside captured code "
                    f"(draw before the run)")
        arg = call.args[0] if len(call.args) == 1 else None
        if canon in self._BUILTINS and arg is not None and not isinstance(
                arg, ast.Constant) and not (isinstance(arg, ast.Name) and arg.id in scalars):
            return (f"{canon}() on a tensor forces a device->host sync; keep "
                    f"it a tensor or hoist it")
        return None

    def check(self, module, project):
        out, seen = [], set()
        for fn in project.traced_functions(module):
            scalars = self._scalar_params(fn)
            for stmt in fn.own_statements():
                if not isinstance(stmt, ast.Call):
                    continue
                msg = self._call_finding(module, stmt, scalars)
                where = (stmt.lineno, stmt.col_offset)
                if msg and where not in seen:
                    seen.add(where)
                    out.append(module.finding(
                        self.rule_name, stmt.lineno,
                        f"{msg} [captured via {fn.qualname}]"))
        return out


@register_rule("registry-hooks")
class RegistryHooksRule(Rule):
    """Registered protocol/compressor/delay/solver entries implement their
    base's abstract hooks (the Protocol hook-contract docstrings)."""

    description = ("flags @register_protocol/compressor/delay classes missing "
                   "abstract hooks of their base (plus the protocol registry's "
                   "explicit extras: default_sigma_prime, coalesce_supported), "
                   "and register_solver entries off the port's solver "
                   "signature")

    # decorator canonical name ->
    #   (base module, base class, fallback hooks, extra required hooks).
    # Extras are hooks the base implements CONCRETELY (so they cannot be
    # auto-derived from NotImplementedError bodies) but that every registered
    # entry must still state in its own chain: sigma' is the safety parameter
    # of the entry's aggregation rule, and coalesce eligibility decides
    # whether the serve layer may batch the entry's runs.
    REGISTRIES = {
        "repro_torch.core.engine.register_protocol":
            ("repro_torch.core.engine", "Protocol",
             ("num_rounds", "initial_messages", "arrivals_needed",
              "process_round", "snapshot", "finalize"),
             ("default_sigma_prime", "coalesce_supported")),
        "repro_torch.core.compress.register_compressor":
            ("repro_torch.core.compress", "Compressor",
             ("compress", "compress_grouped"), ()),
        "repro_torch.core.delays.register_delay":
            ("repro_torch.core.delays", "DelayModel", ("compute_time",), ()),
    }
    SOLVER_REGISTRAR = "repro_torch.core.solvers.register_solver"
    LOCAL_SOLVER = "repro_torch.core.solvers.LocalSolver"
    # w_all, alpha, X, y, norms_sq, lam, n_global, sigma', keys, draws: the
    # port draws visit orders through a draw source, not a JAX key alone.
    SOLVER_MIN_ARGS = 10
    SOLVER_KWONLY = {"loss", "num_steps"}
    # LocalSolver(draw, solve): draw(keys, draws, *, <every keyword below>)
    # and solve(orders, w_all, alpha, X, y, norms_sq, lam, n_global,
    # sigma', *, loss, cells, map_error).
    DRAW_MIN_ARGS = 2
    DRAW_KWARGS = {"n_k", "num_steps", "norms_sq", "lam", "n_global",
                   "sigma_prime", "device"}
    SOLVE_MIN_ARGS = 9
    SOLVE_KWARGS = {"loss", "cells", "map_error"}

    # -- abstract-hook extraction ------------------------------------------

    @staticmethod
    def _is_abstract(method: ast.FunctionDef) -> bool:
        body = [s for s in method.body
                if not (isinstance(s, ast.Expr)
                        and isinstance(s.value, ast.Constant))]
        return (len(body) == 1 and isinstance(body[0], ast.Raise)
                and "NotImplementedError" in ast.dump(body[0]))

    def _abstract_hooks(self, project, base_mod, base_cls, fallback):
        module = project.by_modname.get(base_mod)
        cls = module.classes.get(base_cls) if module else None
        if cls is None:
            return tuple(fallback)
        return tuple(m.name for m in cls.body
                     if isinstance(m, ast.FunctionDef)
                     and self._is_abstract(m))

    # -- class chain walking -----------------------------------------------

    def _defined_hooks(self, project, module, cls: ast.ClassDef,
                       stop_at: str) -> set[str]:
        """Concrete method names along the base chain (project files only)."""
        defined: set[str] = set()
        seen = set()
        stack = [(module, cls)]
        while stack:
            mod, node = stack.pop()
            if (mod.modname, node.name) in seen or node.name == stop_at:
                continue
            seen.add((mod.modname, node.name))
            for m in node.body:
                if isinstance(m, ast.FunctionDef) and not self._is_abstract(m):
                    defined.add(m.name)
            for base in node.bases:
                resolved = self._resolve_class(project, mod, base)
                if resolved is not None:
                    stack.append(resolved)
        return defined

    def _resolve_class(self, project, module, base):
        dotted = _dotted(base)
        if dotted is None:
            return None
        if "." not in dotted:
            if dotted in module.classes:
                return (module, module.classes[dotted])
            target = module.imports.get(dotted)
        else:
            head, _, rest = dotted.partition(".")
            target_mod = module.imports.get(head)
            target = f"{target_mod}.{rest}" if target_mod else None
        if not target:
            return None
        mod_name, _, cls_name = target.rpartition(".")
        other = project.by_modname.get(mod_name)
        if other and cls_name in other.classes:
            return (other, other.classes[cls_name])
        return None

    # -- the check ---------------------------------------------------------

    def check(self, module, project):
        out = []
        for qual, cls in module.classes.items():
            for dec in cls.decorator_list:
                if not isinstance(dec, ast.Call):
                    continue
                canon = module.canonical(dec.func)
                reg = self.REGISTRIES.get(canon or "")
                if reg is None:
                    continue
                base_mod, base_cls, fallback, extra = reg
                required = self._abstract_hooks(project, base_mod, base_cls,
                                                fallback) + tuple(extra)
                defined = self._defined_hooks(project, module, cls, base_cls)
                missing = sorted(set(required) - defined)
                if missing:
                    out.append(module.finding(
                        self.rule_name, dec.lineno,
                        f"registered entry {qual!r} does not implement "
                        f"required hook(s) {missing} of {base_cls} (see the "
                        f"hook-contract docstring)"))
        out.extend(self._check_solvers(module, project))
        return out

    @staticmethod
    def _signature(fn: FunctionNode) -> tuple[int, set[str], bool]:
        a = fn.node.args
        return (len(a.posonlyargs) + len(a.args), {p.arg for p in a.kwonlyargs},
                a.kwarg is not None)

    def _local_solver_parts(self, module, project, scope, arg):
        """``LocalSolver(draw, solve)`` given inline or through a module-level
        name -> its (draw, solve) FunctionNodes, else None."""
        call = arg if isinstance(arg, ast.Call) else None
        if isinstance(arg, ast.Name):
            for stmt in module.tree.body:
                if (isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call)
                        and any(isinstance(t, ast.Name) and t.id == arg.id
                                for t in stmt.targets)):
                    call = stmt.value
        if (call is None or module.canonical(call.func) != self.LOCAL_SOLVER
                or len(call.args) < 2):
            return None
        return tuple(project.resolve_call(module, scope, a) for a in call.args[:2])

    def _solver_problem(self, module, project, scope, arg) -> str | None:
        parts = self._local_solver_parts(module, project, scope, arg)
        if parts is not None:
            draw, solve = parts
            problems = []
            if draw is not None:
                n_pos, kwonly, var_kw = self._signature(draw)
                if n_pos < self.DRAW_MIN_ARGS or not (
                        var_kw or self.DRAW_KWARGS <= kwonly):
                    problems.append(
                        f"draw {draw.qualname!r} must take (keys, draws, *, "
                        f"{', '.join(sorted(self.DRAW_KWARGS))})")
            if solve is not None:
                n_pos, kwonly, var_kw = self._signature(solve)
                if n_pos < self.SOLVE_MIN_ARGS or not (
                        var_kw or self.SOLVE_KWARGS <= kwonly):
                    problems.append(
                        f"solve {solve.qualname!r} must take >= "
                        f"{self.SOLVE_MIN_ARGS} positional args + keyword "
                        f"{sorted(self.SOLVE_KWARGS)}")
            return "; ".join(problems) or None
        fn = project.resolve_call(module, scope, arg)
        if fn is None or isinstance(fn.node, ast.Lambda):
            return None
        n_pos, kwonly, _ = self._signature(fn)
        if n_pos < self.SOLVER_MIN_ARGS or not self.SOLVER_KWONLY <= kwonly:
            return (f"solver {fn.qualname!r} does not match the local-solver "
                    f"signature (>= {self.SOLVER_MIN_ARGS} positional args + "
                    f"keyword-only {sorted(self.SOLVER_KWONLY)})")
        return None

    def _check_solvers(self, module, project):
        out = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            # register_solver("name")(fn) -- the call-registration form.
            if not (isinstance(node.func, ast.Call)
                    and module.canonical(node.func.func)
                    == self.SOLVER_REGISTRAR and node.args):
                continue
            problem = self._solver_problem(module, project,
                                           module.enclosing(node.lineno), node.args[0])
            if problem:
                out.append(module.finding(
                    self.rule_name, node.lineno,
                    f"{problem}; see repro_torch.core.solvers"))
        # @register_solver("name") on a def -- the decorator form.
        for fn in module.functions.values():
            if not isinstance(fn.node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for dec in fn.node.decorator_list:
                if (isinstance(dec, ast.Call)
                        and module.canonical(dec.func) == self.SOLVER_REGISTRAR):
                    n_pos, kwonly, _ = self._signature(fn)
                    if n_pos < self.SOLVER_MIN_ARGS or not self.SOLVER_KWONLY <= kwonly:
                        out.append(module.finding(
                            self.rule_name, dec.lineno,
                            f"solver {fn.qualname!r} does not match the "
                            f"local-solver signature (>= {self.SOLVER_MIN_ARGS} "
                            f"positional args + keyword-only "
                            f"{sorted(self.SOLVER_KWONLY)}); see "
                            f"repro_torch.core.solvers"))
        return out


@register_rule("typed-errors")
class TypedErrorsRule(Rule):
    """Serve-layer error discipline: no silent broad excepts.

    The serve layer's failure contract is TYPED errors delivered through
    streams and the pinned HTTP status table -- a broad ``except Exception``
    that neither re-raises nor is explicitly marked swallows a failure into
    a hang or an untyped 500. This rule flags every ``except Exception`` /
    ``except BaseException`` handler under ``serve/`` whose body contains no
    ``raise``; handlers that deliberately terminate the error path
    (delivering it to a tenant handle, mapping it to a status code,
    poisoning streams on teardown) carry ``# analysis: fail-fast-ok`` with a
    parenthesized why.
    """

    description = ("flags except Exception/BaseException without a re-raise "
                   "under serve/; convert to a typed error or mark the "
                   "handler '# analysis: fail-fast-ok (why)'")

    BROAD = ("Exception", "BaseException")

    def check(self, module, project):
        if "serve" not in module.relpath:
            return []
        out = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.ExceptHandler) or node.type is None:
                continue
            if isinstance(node.type, ast.Tuple):
                names = [_dotted(e) for e in node.type.elts]
            else:
                names = [_dotted(node.type)]
            if not any(n in self.BROAD for n in names if n):
                continue
            if any(isinstance(n, ast.Raise) for n in ast.walk(node)):
                continue
            out.append(module.finding(
                self.rule_name, node.lineno,
                f"broad except {', '.join(n for n in names if n)} swallows "
                f"the error; re-raise a typed serve error "
                f"(repro_torch.serve.recovery) or mark the handler "
                f"'# analysis: fail-fast-ok (why)'"))
        return out


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------


def _iter_py_files(paths) -> list[pathlib.Path]:
    out = []
    for p in paths:
        p = pathlib.Path(p)
        if p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            out.append(p)
    return out


def parse_project(paths, *, root: pathlib.Path | None = None) -> ProjectIndex:
    """Parse every ``*.py`` under ``paths`` into a :class:`ProjectIndex`."""
    root = pathlib.Path.cwd() if root is None else pathlib.Path(root)
    modules = []
    for path in _iter_py_files(paths):
        try:
            rel = path.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = path.as_posix()
        try:
            modules.append(ModuleInfo(path, path.read_text(), rel))
        except SyntaxError as e:
            raise SyntaxError(f"analysis cannot parse {path}: {e}") from e
    return ProjectIndex(modules)


def lint_project(project: ProjectIndex, *, rules=None) -> list[Finding]:
    """Run ``rules`` (default: every non-example registry entry) over every
    module; pragma-suppressed findings are dropped here."""
    names = default_rules() if rules is None else tuple(rules)
    instances = [get_rule(n)() for n in names]
    out = []
    for module in project.modules:
        for rule in instances:
            for f in rule.check(module, project):
                if not module.suppressed(f.rule, f.line):
                    out.append(f)
    return sort_findings(out)


def lint_paths(paths, *, root=None, rules=None) -> list[Finding]:
    """Parse + lint in one call (the CLI / CI entry)."""
    return lint_project(parse_project(paths, root=root), rules=rules)


def lint_source(source: str, *, path: str = "<snippet>",
                rules=None) -> list[Finding]:
    """Lint one in-memory snippet (the test harness entry)."""
    module = ModuleInfo(pathlib.Path(path), source, path)
    return lint_project(ProjectIndex([module]), rules=rules)
