"""The port's lint rules: the JAX linter's serving invariants in torch
form, and the port's own ground rules (ROADMAP.md).

The JAX catalog (``repro/analysis/rules.py``), rule by rule:

  * ``jnp-module-constant``  -> ``torch-module-constant``: a module-level
    tensor (``torch.tensor`` / ``zeros`` / ``ones`` / ``full`` / ``empty`` /
    ``arange`` ...) is made on the CPU at import; used with card tensors it
    is copied on every call or mixes devices.  Metadata (``torch.finfo``,
    ``iinfo``, dtypes) is not a tensor and is exempt.
  * ``donated-buffer-reuse`` -> none: eager PyTorch donates no buffer, so
    there is nothing to read after a donation.
  * ``tracer-host-branch``   -> ``tensor-host-branch``: Python ``if`` /
    ``while`` / ``assert`` / ``not`` / ``and`` / ``or`` / ``bool()`` on a
    tensor's truth value in ``layers/``, ``models/`` and ``serving/``: a
    hidden host sync on the card.
  * ``fp8-payload-arith``    -> ``fp8-payload-arith``: arithmetic on
    ``float8_e4m3fn`` / ``float8_e5m2`` payloads outside ``core/quant.py``
    and ``kernels/``.
  * ``unbucketed-jit-shape`` -> ``unbucketed-step-shape``: operands of the
    executor's step programs (model forwards) sized by a raw ``len(...)``
    instead of ``bucket_length``; fixed shapes are what a CUDA graph of
    the step needs.
  * ``hidden-host-sync``     -> ``hidden-host-sync``: ``.item()``,
    ``.tolist()``, ``.cpu()``, ``.numpy()``, ``np.asarray(t)`` and
    ``float`` / ``int`` / ``bool`` of a tensor on the serving path, outside
    an ``analysis.guards.sanctioned()`` block and lines marked
    ``# lint: allow[hidden-host-sync]``.
  * ``index-dtype-drift``    -> ``index-dtype-drift``: mixed int64 / int32
    index math in ``serving/`` that bypasses ``kv_cache.as_index`` /
    ``INDEX_DTYPE``.

The port's ground rules, the forms of the device and sync seams that XLA
keeps for the JAX package:

  * ``device-switch``        -- ``torch.cuda.is_available()`` outside
    ``device.py`` (dispatch is by the tensor's device, never by a probe);
  * ``kernel-fallback``      -- a ``try`` whose body launches (or builds) a
    kernel of ``repro_torch.kernels`` (a kernel never falls back);
  * ``host-scalar-division`` -- ``/`` by a Python number in
    ``core/quant.py``: CUDA multiplies by the reciprocal, one ulp off;
  * ``scalar-index-write``   -- a Python number written into a tensor
    through an index tensor in ``serving/`` (``t[:, idx] = -1`` copies the
    scalar from the host and syncs; ``index_fill_`` does not).

Rules are pure ``ast`` passes over a shared ``ModuleContext``; none of
them import torch.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set

from repro_torch.analysis.context import ModuleContext, attr_root, dotted
from repro_torch.analysis.findings import Finding

_FP8_ATTRS = {"float8_e4m3fn", "float8_e5m2"}
_FP8_NAMES = {"E4M3", "E5M2"}
# torch.<name>(...) calls that make a tensor
_CONSTRUCTORS = {"tensor", "as_tensor", "from_numpy", "zeros", "ones",
                 "full", "empty", "arange", "linspace", "eye", "rand",
                 "randn", "randint", "zeros_like", "ones_like", "full_like",
                 "empty_like"}
# torch.<name>(...) calls that answer on the host without a tensor
_TORCH_HOST_CALLS = {"is_tensor", "is_floating_point", "is_complex",
                     "is_storage", "finfo", "iinfo", "device", "dtype",
                     "get_default_dtype", "is_grad_enabled",
                     "is_inference_mode_enabled", "promote_types",
                     "result_type", "can_cast", "Size", "Generator",
                     "no_grad", "enable_grad", "inference_mode"}
_TORCH_HOST_NAMESPACES = {"cuda", "backends", "distributed", "jit",
                          "compiler", "utils", "autograd", "testing"}
_HOST_CONVERSIONS = {"item", "tolist", "numpy", "cpu"}
# the paths of a serve's hot path (the engine down to the layers)
_SERVING_PATH = ("serving/", "layers/", "models/", "core/quant.py")


def _walk_scope(node: ast.AST) -> Iterable[ast.AST]:
    """Walk a function body WITHOUT descending into nested function /
    class scopes (their bindings are not this scope's bindings)."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(n))


def _in_order(nodes: Iterable[ast.AST]) -> List[ast.AST]:
    return sorted((n for n in nodes if hasattr(n, "lineno")),
                  key=lambda n: (n.lineno, n.col_offset))


def _targets(node: ast.Assign) -> List[str]:
    out: List[str] = []
    for t in node.targets:
        elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
        out += [d for d in (dotted(e) for e in elts) if d]
    return out


def _is_tensor_call(ctx: ModuleContext, call: ast.Call) -> bool:
    """``torch.f(...)`` that returns a tensor (not a host-side query)."""
    d = dotted(call.func)
    if d is None or not ctx.is_torch_attr(call.func):
        return False
    parts = d.split(".")
    if len(parts) > 2 and parts[1] in _TORCH_HOST_NAMESPACES:
        return False
    return parts[-1] not in _TORCH_HOST_CALLS


def _is_host_conversion(ctx: ModuleContext, node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in _HOST_CONVERSIONS:
        return True
    if isinstance(f, ast.Name) and f.id in ("float", "int", "bool", "len"):
        return True
    return isinstance(f, ast.Attribute) and attr_root(f) in ctx.np_aliases


def produces_tensor(ctx: ModuleContext, expr: ast.AST,
                    device: Set[str]) -> bool:
    """Whether ``expr`` evaluates to a tensor: it calls ``torch``, passes
    a torch dtype to a call (``self._tensor(x, torch.int64)``,
    ``x.to(torch.int32)``), or reads a name already known to hold one;
    host conversions (``.item()``, ``np.*``, ``int()``) end the chain."""
    if _is_host_conversion(ctx, expr):
        return False
    stack = [expr]
    while stack:
        n = stack.pop()
        if _is_host_conversion(ctx, n):
            continue
        if isinstance(n, ast.Call):
            if _is_tensor_call(ctx, n):
                return True
            if any(ctx.is_torch_attr(a) for a in n.args):
                return True
        if isinstance(n, (ast.Name, ast.Attribute)) and dotted(n) in device:
            return True
        stack.extend(ast.iter_child_nodes(n))
    return False


def device_names(ctx: ModuleContext, fn: ast.AST,
                 attrs: Set[str]) -> Set[str]:
    """Names of ``fn`` bound to tensors, in source order, plus ``attrs``
    (``module_device_attrs``)."""
    names: Set[str] = set(attrs)
    for n in _in_order(_walk_scope(fn)):
        if isinstance(n, ast.Assign) and produces_tensor(ctx, n.value,
                                                         names):
            names.update(_targets(n))
        elif isinstance(n, ast.arg) and n.annotation is not None and \
                "Tensor" in (dotted(n.annotation) or ""):
            names.add(n.arg)
    return names


def module_device_attrs(ctx: ModuleContext) -> Set[str]:
    """The ``self.x`` attributes the module binds to tensors anywhere."""
    attrs: Set[str] = set()
    for n in ast.walk(ctx.tree):
        if isinstance(n, ast.Assign) and produces_tensor(ctx, n.value,
                                                         set()):
            attrs.update(t for t in _targets(n) if t.startswith("self."))
    return attrs


class Rule:
    name: str = ""
    description: str = ""
    paths: Sequence[str] = ()          # only lint paths containing one of
    exempt_paths: Sequence[str] = ()   # never lint paths containing one of

    def applies(self, ctx: ModuleContext) -> bool:
        if any(p in ctx.path for p in self.exempt_paths):
            return False
        return not self.paths or any(p in ctx.path for p in self.paths)

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, ctx: ModuleContext, node: ast.AST,
                message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(file=ctx.path, line=line,
                       col=getattr(node, "col_offset", 0), rule=self.name,
                       message=message, snippet=ctx.snippet(line))


class TorchModuleConstant(Rule):
    name = "torch-module-constant"
    description = ("module-level torch.tensor/zeros/ones/full/empty/arange"
                   "(...): made on the CPU at import; with card tensors it "
                   "is copied on every call or mixes devices")

    @staticmethod
    def _module_statements(tree: ast.Module) -> Iterable[ast.stmt]:
        stack: List[ast.stmt] = list(tree.body)
        while stack:
            stmt = stack.pop()
            yield stmt
            if isinstance(stmt, (ast.If, ast.Try, ast.With, ast.For,
                                 ast.While)):
                for field in ("body", "orelse", "finalbody", "handlers"):
                    for sub in getattr(stmt, field, []):
                        if isinstance(sub, ast.ExceptHandler):
                            stack.extend(sub.body)
                        elif isinstance(sub, ast.stmt):
                            stack.append(sub)

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for stmt in self._module_statements(ctx.tree):
            if not isinstance(stmt, (ast.Assign, ast.AnnAssign,
                                     ast.AugAssign)) or stmt.value is None:
                continue
            for call in ctx.torch_calls(stmt.value):
                d = dotted(call.func) or ""
                if d.count(".") != 1 or d.split(".")[-1] not in _CONSTRUCTORS:
                    continue
                yield self.finding(
                    ctx, stmt,
                    "module-level tensor is made on the CPU at import; "
                    "used with card tensors it is copied on every call or "
                    "mixes devices -- keep a Python value and make the "
                    "tensor on the caller's device inside the function")
                break


class TensorHostBranch(Rule):
    name = "tensor-host-branch"
    description = ("Python if/while/assert/not/and/or/bool() on a tensor's "
                   "truth value in layers/, models/, serving/ (a hidden "
                   "host sync on the card)")
    paths = ("layers/", "models/", "serving/")

    def _tensor_truth(self, ctx: ModuleContext, test: ast.AST) -> bool:
        for n in ast.walk(test):
            if isinstance(n, ast.Call) and _is_tensor_call(ctx, n):
                return True
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                    and n.func.attr in ("any", "all", "item") \
                    and attr_root(n.func) not in ctx.np_aliases:
                return True
        return False

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        seen: Set[tuple] = set()
        for node in _in_order(ast.walk(ctx.tree)):
            tests: List[ast.AST] = []
            if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
                tests = [node.test]
            elif isinstance(node, ast.UnaryOp) and isinstance(node.op,
                                                              ast.Not):
                tests = [node.operand]
            elif isinstance(node, ast.BoolOp):
                tests = list(node.values)
            elif isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Name) and node.func.id == "bool":
                tests = list(node.args)
            if not any(self._tensor_truth(ctx, t) for t in tests):
                continue
            if (node.lineno, node.col_offset) in seen or any(
                    (sub.lineno, sub.col_offset) in seen
                    for sub in ast.walk(node) if hasattr(sub, "lineno")):
                continue
            seen.add((node.lineno, node.col_offset))
            yield self.finding(
                ctx, node,
                "Python control flow on a tensor's truth value: the host "
                "waits for the card here (a hidden sync) -- keep the "
                "decision on the device (torch.where, masks) or decide on "
                "host data")


class Fp8PayloadArith(Rule):
    name = "fp8-payload-arith"
    description = ("arithmetic on fp8 e4m3 / e5m2 payloads outside the "
                   "quantize/dequantize seam (core/quant.py, kernels/)")
    exempt_paths = ("core/quant.py", "kernels/")

    @staticmethod
    def _is_fp8_ref(node: ast.AST) -> bool:
        if isinstance(node, ast.Attribute) and node.attr in _FP8_ATTRS:
            return True
        return isinstance(node, ast.Name) and node.id in _FP8_NAMES

    def _fp8_producer(self, node: ast.AST) -> bool:
        """``x.to(<fp8>)`` / ``.view(<fp8>)`` / ``.type(<fp8>)`` or
        ``cast_to_fp8(...)``."""
        if not isinstance(node, ast.Call):
            return False
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("to", "view", "type"):
            return any(self._is_fp8_ref(a) for a in node.args) or any(
                kw.arg == "dtype" and self._is_fp8_ref(kw.value)
                for kw in node.keywords)
        d = dotted(node.func)
        return bool(d) and d.split(".")[-1] == "cast_to_fp8"

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for fn in ctx.functions():
            tracked: Set[str] = set()
            for n in _in_order(_walk_scope(fn)):
                if isinstance(n, ast.Assign) and any(
                        self._fp8_producer(s) for s in ast.walk(n.value)):
                    tracked.update(_targets(n))
                if isinstance(n, (ast.BinOp, ast.AugAssign)):
                    operands = ([n.left, n.right]
                                if isinstance(n, ast.BinOp)
                                else [n.target, n.value])
                    if any(self._fp8_operand(o, tracked) for o in operands):
                        yield self.finding(
                            ctx, n,
                            "arithmetic on an fp8 payload outside "
                            "core/quant.py: fp8 is the STORAGE format -- "
                            "dequantize first (QuantizedTensor.dequantize, "
                            "the attention's _read_kv) and compute in "
                            "bf16/f32")

    def _fp8_operand(self, node: ast.AST, tracked: Set[str]) -> bool:
        if isinstance(node, (ast.Name, ast.Attribute)) and \
                dotted(node) in tracked:
            return True
        return self._fp8_producer(node)


class UnbucketedStepShape(Rule):
    name = "unbucketed-step-shape"
    description = ("operand of an executor step program (a model forward) "
                   "sized by a raw len(...): every size is a new shape, "
                   "which a CUDA graph of the step cannot take -- bucket "
                   "with bucket_length()")
    paths = ("serving/",)

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for fn in ctx.functions():
            scope = list(_walk_scope(fn))
            runs_step = any(isinstance(n, ast.Call)
                            and attr_root(n.func) in ctx.model_names
                            for n in scope)
            if not runs_step:
                continue
            for n in scope:
                if not (isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr in _CONSTRUCTORS
                        and attr_root(n.func) in (ctx.np_aliases
                                                  | ctx.torch_aliases)
                        and n.args):
                    continue
                shape = n.args[0]
                names = {dotted(s) for s in ast.walk(shape)
                         if isinstance(s, (ast.Name, ast.Attribute))}
                if any(d and "bucket" in d.split(".")[-1] for d in names):
                    continue          # routed through a bucketing helper
                if any(isinstance(s, ast.Call) and isinstance(s.func, ast.Name)
                       and s.func.id == "len" for s in ast.walk(shape)):
                    yield self.finding(
                        ctx, n,
                        "step-program operand sized by raw len(...): every "
                        "distinct size is a new shape for the step (no "
                        "CUDA graph can replay it) -- pad to a pow-2 "
                        "bucket via bucket_length()")


class HiddenHostSync(Rule):
    name = "hidden-host-sync"
    description = (".item()/.tolist()/.cpu()/.numpy()/np.asarray/float() of "
                   "a tensor on the serving path outside a sanctioned() "
                   "block (# lint: allow[hidden-host-sync])")
    paths = _SERVING_PATH

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        attrs = module_device_attrs(ctx)
        for fn in ctx.functions():
            device = device_names(ctx, fn, attrs)
            for n in _walk_scope(fn):
                if not isinstance(n, ast.Call) or \
                        n.lineno in ctx.sanctioned_lines:
                    continue
                kind = self._sync_kind(ctx, n, device)
                if kind:
                    yield self.finding(
                        ctx, n,
                        f"{kind} waits for the card and copies to the host "
                        f"on the hot path; batch the readback at a phase "
                        f"boundary inside analysis.guards.sanctioned() (or "
                        f"mark a deliberate sync with "
                        f"`# lint: allow[hidden-host-sync]` and a reason)")

    def _sync_kind(self, ctx: ModuleContext, call: ast.Call,
                   device: Set[str]) -> Optional[str]:
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr in (
                "item", "tolist", "cpu", "numpy") and not call.args \
                and attr_root(func) not in ctx.np_aliases:
            return f"`.{func.attr}()`"
        dev_arg = bool(call.args) and produces_tensor(ctx, call.args[0],
                                                      device)
        if isinstance(func, ast.Attribute) \
                and func.attr in ("asarray", "array", "ascontiguousarray") \
                and attr_root(func) in ctx.np_aliases and dev_arg:
            return f"`np.{func.attr}` of a tensor"
        if isinstance(func, ast.Name) and func.id in ("float", "int", "bool") \
                and dev_arg:
            return f"`{func.id}()` of a tensor"
        return None


class IndexDtypeDrift(Rule):
    name = "index-dtype-drift"
    description = ("mixed int64/int32 index math in a serving module; one "
                   "typed helper (serving.kv_cache.as_index, INDEX_DTYPE) "
                   "owns the page-table index dtype")
    paths = ("serving/",)

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        roots = ctx.np_aliases | ctx.torch_aliases
        for fn in ctx.functions():
            scope = list(_walk_scope(fn))
            i64 = [n for n in scope if isinstance(n, ast.Attribute)
                   and n.attr == "int64" and attr_root(n) in roots]
            has_i32 = any(isinstance(n, ast.Attribute) and n.attr == "int32"
                          and attr_root(n) in roots for n in scope)
            if i64 and has_i32:
                for n in i64:
                    yield self.finding(
                        ctx, n,
                        f"`{fn.name}` mixes int64 and int32 index dtypes: "
                        f"index math widens then casts back -- route it "
                        f"through serving.kv_cache.as_index (INDEX_DTYPE)")


class DeviceSwitch(Rule):
    name = "device-switch"
    description = ("torch.cuda.is_available() outside device.py: dispatch "
                   "is by the tensor's device, never by probing for a card")
    exempt_paths = ("device.py",)

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for n in ast.walk(ctx.tree):
            if isinstance(n, ast.Call) and ctx.is_torch_attr(n.func) and \
                    (dotted(n.func) or "").endswith("cuda.is_available"):
                yield self.finding(
                    ctx, n,
                    "torch.cuda.is_available() outside device.py: a kernel "
                    "runs by its tensor's device (plain version on the CPU, "
                    "the kernel or an error on the card), and entry points "
                    "resolve their device through device.resolve_device")


class KernelFallback(Rule):
    name = "kernel-fallback"
    description = ("a try whose body launches or builds a kernel of "
                   "repro_torch.kernels: a kernel never falls back")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        if not ctx.kernel_names:
            return
        for n in ast.walk(ctx.tree):
            if not isinstance(n, ast.Try) or not n.handlers:
                continue
            for stmt in n.body:
                call = next((c for c in ast.walk(stmt)
                             if isinstance(c, ast.Call)
                             and attr_root(c.func) in ctx.kernel_names), None)
                if call is not None:
                    yield self.finding(
                        ctx, n,
                        f"`try` around `{dotted(call.func) or 'a kernel'}`: "
                        f"a kernel that fails to build or launch must fail "
                        f"loudly, never fall back to its plain version")
                    break


class HostScalarDivision(Rule):
    name = "host-scalar-division"
    description = ("`/` by a Python number in core/quant.py or "
                   "distributed/compression.py: CUDA multiplies by the "
                   "reciprocal (one ulp off); divide by a device tensor")
    paths = ("core/quant.py", "distributed/compression.py")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        for fn in ctx.functions():
            local: Set[str] = set()
            for n in _in_order(_walk_scope(fn)):
                if isinstance(n, ast.Assign) and \
                        ctx.is_host_scalar(n.value, local):
                    local.update(t.id for t in n.targets
                                 if isinstance(t, ast.Name))
                if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Div):
                    left, right = n.left, n.right
                elif isinstance(n, ast.AugAssign) and isinstance(n.op,
                                                                 ast.Div):
                    left, right = n.target, n.value
                else:
                    continue
                if ctx.is_host_scalar(right, local) and \
                        not ctx.is_host_scalar(left, local):
                    yield self.finding(
                        ctx, n,
                        "tensor divided by a Python number: PyTorch's CUDA "
                        "division by a host scalar multiplies by its "
                        "reciprocal, one ulp off the quotient -- divide by "
                        "a device tensor (torch.full((), v, device=...))")


class ScalarIndexWrite(Rule):
    name = "scalar-index-write"
    description = ("a Python number written into a tensor through an index "
                   "tensor in serving/ (copies the scalar from the host and "
                   "syncs; use index_fill_)")
    paths = ("serving/",)

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        attrs = module_device_attrs(ctx)
        for fn in ctx.functions():
            device = device_names(ctx, fn, attrs)
            for n in _in_order(_walk_scope(fn)):
                if not isinstance(n, ast.Assign) or \
                        not ctx.is_host_scalar(n.value, set()):
                    continue
                for t in n.targets:
                    if not isinstance(t, ast.Subscript):
                        continue
                    idx = t.slice.elts if isinstance(t.slice, ast.Tuple) \
                        else [t.slice]
                    if any(not isinstance(i, (ast.Slice, ast.Constant))
                           and produces_tensor(ctx, i, device) for i in idx):
                        yield self.finding(
                            ctx, n,
                            "Python number written through an index tensor: "
                            "PyTorch copies the scalar from the host into a "
                            "tensor and syncs -- use index_fill_ (or a "
                            "device tensor value)")
                        break


ALL_RULES = (TorchModuleConstant(), TensorHostBranch(), Fp8PayloadArith(),
             UnbucketedStepShape(), HiddenHostSync(), IndexDtypeDrift(),
             DeviceSwitch(), KernelFallback(), HostScalarDivision(),
             ScalarIndexWrite())

RULES_BY_NAME: Dict[str, Rule] = {r.name: r for r in ALL_RULES}

# JAX rules with no torch form, and why (``--list-rules`` prints them)
NOT_PORTED: Dict[str, str] = {
    "donated-buffer-reuse": "eager PyTorch donates no buffer: there is "
                            "nothing to read after a donation"}
