"""Per-module facts shared by every lint rule (the torch form of
``repro/analysis/context.py``).

``ModuleContext`` parses one Python source once and precomputes what the
port's rules keep asking:

  * **import aliases** -- which local names mean ``torch`` / ``numpy`` in
    THIS module, so rules match meaning, not spelling;
  * **kernel names** -- every local name bound by an import from
    ``repro_torch.kernels`` (a kernel's ``ops`` module, its wrapper, the
    ``build`` module): a call through one launches or builds a kernel;
  * **step programs** -- local names bound by an import from
    ``repro_torch.models`` (``onerec_model``, ``tfm_model``): a call
    through one runs a model forward, the executor's step program;
  * **host scalars** -- module-level names bound to numeric literals, or to
    dicts of them (``FP8_MAX``), the Python numbers of ``core/quant.py``;
  * **sanctioned blocks** -- the lines of ``with sanctioned():`` blocks
    (``analysis.guards``), the syncs the steady-state guard allows;
  * **suppressions** -- ``# lint: allow[rule-name]`` trailing comments,
    the escape hatch for a deliberate violation (with its reason beside).

Pure stdlib ``ast``: importing this module never imports torch (the
linter runs where torch is not installed).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

_ALLOW_RE = re.compile(r"#\s*lint:\s*allow\[([\w\s,-]+)\]")
KERNELS_PACKAGE = "repro_torch.kernels"
MODELS_PACKAGE = "repro_torch.models"


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def attr_root(node: ast.AST) -> Optional[str]:
    """The leftmost Name of an attribute / call chain (``torch`` of
    ``torch.ones``, ``x`` of ``x.float().sum``)."""
    while isinstance(node, (ast.Attribute, ast.Call, ast.Subscript)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def _is_number(node: ast.AST) -> bool:
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub,
                                                              ast.UAdd)):
        node = node.operand
    return isinstance(node, ast.Constant) and \
        isinstance(node.value, (int, float)) and \
        not isinstance(node.value, bool)


class ModuleContext:
    def __init__(self, source: str, path: str):
        self.path = path.replace("\\", "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.torch_aliases: Set[str] = set()
        self.np_aliases: Set[str] = set()
        self.kernel_names: Set[str] = set()
        self.model_names: Set[str] = set()
        self._scan_imports()
        self.allows: Dict[int, Set[str]] = self._scan_allows()
        self.host_scalars, self.host_tables = self._scan_host_scalars()
        self.sanctioned_lines: Set[int] = self._scan_sanctioned()

    # -- imports --------------------------------------------------------------

    def _scan_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    name = a.asname or a.name.split(".")[0]
                    if a.name == "torch":
                        self.torch_aliases.add(name)
                    elif a.name == "numpy":
                        self.np_aliases.add(name)
                    elif a.name.startswith(KERNELS_PACKAGE) and a.asname:
                        self.kernel_names.add(a.asname)
                    elif a.name.startswith(MODELS_PACKAGE) and a.asname:
                        self.model_names.add(a.asname)
            elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                    and node.module:
                for package, names in ((KERNELS_PACKAGE, self.kernel_names),
                                       (MODELS_PACKAGE, self.model_names)):
                    for a in node.names:
                        if node.module.startswith(package) or \
                                f"{node.module}.{a.name}" == package:
                            names.add(a.asname or a.name)
        if not self.torch_aliases:
            self.torch_aliases = {"torch"}      # lint fixtures / fragments
        if not self.np_aliases:
            self.np_aliases = {"np"}

    # -- module-level host numbers --------------------------------------------

    def _scan_host_scalars(self) -> Tuple[Set[str], Set[str]]:
        scalars: Set[str] = set()
        tables: Set[str] = set()
        for stmt in self.tree.body:
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            else:
                continue
            names = [t.id for t in targets if isinstance(t, ast.Name)]
            if _is_number(value):
                scalars.update(names)
            elif isinstance(value, ast.Dict) and value.values and all(
                    _is_number(v) for v in value.values):
                tables.update(names)
        return scalars, tables

    def is_host_scalar(self, node: ast.AST, local: Set[str]) -> bool:
        """A Python number: a literal, a module-level numeric name or an
        entry of a module-level table of them, a local bound to one,
        ``float(...)`` / ``int(...)`` / ``len(...)``, or arithmetic of those."""
        if _is_number(node):
            return True
        if isinstance(node, ast.Name):
            return node.id in self.host_scalars or node.id in local
        if isinstance(node, ast.Subscript):
            return isinstance(node.value, ast.Name) and \
                node.value.id in self.host_tables
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            return node.func.id in ("float", "int", "len")
        if isinstance(node, ast.BinOp):
            return self.is_host_scalar(node.left, local) and \
                self.is_host_scalar(node.right, local)
        if isinstance(node, ast.UnaryOp):
            return self.is_host_scalar(node.operand, local)
        return False

    # -- suppressions and sanctioned blocks -----------------------------------

    def _scan_allows(self) -> Dict[int, Set[str]]:
        allows: Dict[int, Set[str]] = {}
        for i, line in enumerate(self.lines, 1):
            m = _ALLOW_RE.search(line)
            if m:
                allows[i] = {r.strip() for r in m.group(1).split(",")
                             if r.strip()}
        return allows

    def allowed(self, line: int, rule: str) -> bool:
        return rule in self.allows.get(line, ())

    def _scan_sanctioned(self) -> Set[int]:
        lines: Set[int] = set()
        for node in ast.walk(self.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            for item in node.items:
                call = item.context_expr
                d = dotted(call.func) if isinstance(call, ast.Call) else None
                if d is not None and d.split(".")[-1] == "sanctioned":
                    lines.update(range(node.lineno, node.end_lineno + 1))
        return lines

    # -- torch-rooted expressions ---------------------------------------------

    def is_torch_attr(self, node: ast.AST) -> bool:
        """True for ``torch.<...>`` attribute chains."""
        return isinstance(node, ast.Attribute) and \
            attr_root(node) in self.torch_aliases and \
            dotted(node) is not None

    def torch_calls(self, node: ast.AST) -> Iterable[ast.Call]:
        """Every ``torch.f(...)`` call in the subtree."""
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and self.is_torch_attr(sub.func):
                yield sub

    def functions(self) -> Iterable[ast.FunctionDef]:
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node

    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""
