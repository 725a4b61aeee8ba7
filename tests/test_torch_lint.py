"""The port's linter (``repro_torch.analysis``, ``repro_torch.launch.lint``):
the port-side form of ``tests/test_analysis.py``.

Each rule has a positive and a negative fixture; the baseline's match,
expiry, duplicate counts and version check; the JSON report and baseline
file against the JAX package's ``build_report`` / ``Baseline`` on the same
findings; rule selection; a loud syntax error; the shipped port tree clean
with the empty baseline; the CLI with torch and numpy blocked from import,
and a CLI smoke run.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import (ALL_RULES, NOT_PORTED, RULES_BY_NAME,
                                  Baseline, Finding, build_report,
                                  lint_paths, lint_source, select_rules)
from repro_torch.analysis.findings import REPORT_VERSION

REPO = Path(__file__).resolve().parents[1]
CLI = [sys.executable, "-m", "repro_torch.launch.lint"]
ENV_SRC = str(REPO / "src")


def _lint(src: str, path: str, rule: str):
    return [f for f in lint_source(textwrap.dedent(src), path,
                                   [RULES_BY_NAME[rule]])]


MODULE_TENSOR = """
    import torch

    SCALE = torch.tensor(0.5)          # made on the CPU at import

    def f(x):
        return x * SCALE
"""


# (rule, path, positive source, negative source)
CASES = {
    "torch-module-constant": (
        "layers/mod.py", MODULE_TENSOR,
        """
        import torch
        FP8_MAX = torch.finfo(torch.float8_e4m3fn).max
        DTYPE = torch.bfloat16
        LIMIT = 448.0

        def f(x):
            return x * torch.tensor(0.5, device=x.device)
        """),
    "tensor-host-branch": (
        "models/mod.py",
        """
        import torch

        def f(x, mask):
            if torch.any(mask):
                x = x + 1
            while mask.any():
                mask = mask[1:]
            assert torch.isfinite(x).all()
            return x if not bool(torch.all(mask)) else -x
        """,
        """
        import numpy as np
        import torch

        def f(x, mask, n):
            if x.shape[0] > 1 and torch.is_tensor(mask):
                x = torch.where(mask, x, -x)
            if np.any(np.asarray(n) > 0) or torch.cuda.is_available():
                x = x + 1
            return x
        """),
    "fp8-payload-arith": (
        "layers/mod.py",
        """
        import torch

        def f(x, scale):
            q = (x / scale).to(torch.float8_e4m3fn)
            return q * scale + x.to(dtype=torch.float8_e5m2)
        """,
        """
        import torch

        def f(x, scale):
            q = (x / scale).to(torch.float8_e4m3fn)
            return q.to(torch.float32) * scale
        """),
    "unbucketed-step-shape": (
        "serving/mod.py",
        """
        import numpy as np
        from repro_torch.models import onerec as onerec_model

        def prefill(params, reqs, cfg):
            tok = np.zeros((len(reqs), 8), np.int32)
            return onerec_model.forward(params, {"tokens": tok}, cfg)
        """,
        """
        import numpy as np
        from repro_torch.models import onerec as onerec_model

        def prefill(params, reqs, cfg):
            tok = np.zeros((bucket_length(len(reqs)), 8), np.int32)
            return onerec_model.forward(params, {"tokens": tok}, cfg)

        def host_only(reqs):
            return np.zeros((len(reqs),), np.int32)
        """),
    "hidden-host-sync": (
        "serving/mod.py",
        """
        import numpy as np
        import torch

        def step(logits):
            ids = torch.argmax(logits, dim=-1)
            first = ids[0].item()
            host = np.asarray(ids)
            best = float(torch.max(logits))
            return first, host, best, ids.cpu(), ids.tolist()
        """,
        """
        import numpy as np
        import torch
        from repro_torch.analysis.guards import sanctioned

        def step(logits, lengths):
            ids = torch.argmax(logits, dim=-1)
            with sanctioned():                  # the phase's readback
                out = ids.cpu().numpy()
            n = int(len(lengths)) + int(np.sum(lengths))
            top = ids[0].item()  # lint: allow[hidden-host-sync]
            return out, n, top, float(np.mean(out))
        """),
    "index-dtype-drift": (
        "serving/mod.py",
        """
        import numpy as np
        import torch

        def scatter(slots, pos):
            idx = torch.as_tensor(slots, dtype=torch.int64)
            return idx, np.asarray(pos, np.int32)
        """,
        """
        import numpy as np
        from repro_torch.serving.kv_cache import as_index

        def scatter(slots, pos):
            return as_index(slots), np.asarray(pos, np.int32)
        """),
    "device-switch": (
        "layers/mod.py",
        """
        import torch

        def run(x):
            if torch.cuda.is_available():
                x = x.cuda()
            return x
        """,
        """
        import torch

        def run(x):
            return x.to(resolve_device(None))
        """),
    "kernel-fallback": (
        "core/mod.py",
        """
        from repro_torch.kernels.fp8_gemm import ops as fp8_gemm_ops

        def linear(x, w, s):
            try:
                return fp8_gemm_ops.fp8_gemm(x, w, s)
            except RuntimeError:
                return x @ w
        """,
        """
        from repro_torch.kernels.fp8_gemm import ops as fp8_gemm_ops

        def linear(x, w, s, queue):
            try:
                item = queue.pop()
            except IndexError:
                item = None
            return fp8_gemm_ops.fp8_gemm(x, w, s), item
        """),
    "host-scalar-division": (
        "core/quant.py",
        """
        import torch
        FP8_MAX = {"e4m3": 448.0}
        INT8_MAX = 127.0

        def scales(amax, x, fmt):
            fmax = FP8_MAX[fmt]
            a = amax / fmax
            b = x / INT8_MAX
            x /= 2.0
            return a, b, x
        """,
        """
        import torch
        INT8_MAX = 127.0

        def scales(amax):
            imax = torch.full((), INT8_MAX, device=amax.device)
            half = INT8_MAX / 2
            return amax / imax, len(amax) / 2, half
        """),
    "scalar-index-write": (
        "serving/mod.py",
        """
        import numpy as np
        import torch

        def clear(pos, slots):
            idx = torch.as_tensor(np.asarray(slots), dtype=torch.int64)
            pos[:, idx] = -1
        """,
        """
        import numpy as np
        import torch

        def clear(pos, table, slots, n):
            idx = torch.as_tensor(np.asarray(slots), dtype=torch.int64)
            pos.index_fill_(1, idx, -1)
            pos[:, 0] = -1
            table[n] = 0
        """),
}


# host-scalar-division also holds FP8 gradient compression's scale
COMPRESSION = (
    """
    import torch
    FP8_MAX = {"e4m3": 448.0}

    def leaf_scale(gt):
        amax = torch.amax(torch.abs(gt))
        return torch.clamp(amax, min=1e-30) / FP8_MAX["e4m3"]
    """,
    """
    import torch
    FP8_MAX = {"e4m3": 448.0}

    def leaf_scale(gt):
        amax = torch.amax(torch.abs(gt))
        fmax = torch.full((), FP8_MAX["e4m3"], device=gt.device)
        return torch.clamp(amax, min=1e-30) / fmax
    """)


@pytest.mark.parametrize("case", ["positive", "negative"])
def test_host_scalar_division_holds_compression(case):
    src = COMPRESSION[case == "negative"]
    found = _lint(src, "distributed/compression.py", "host-scalar-division")
    assert len(found) == (case == "positive"), found


def test_every_rule_has_a_case():
    assert set(CASES) == set(RULES_BY_NAME)


@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_positive(rule):
    path, pos, _ = CASES[rule]
    found = _lint(pos, path, rule)
    assert found and all(f.rule == rule for f in found), found
    if rule in ("tensor-host-branch", "hidden-host-sync",
                "host-scalar-division"):
        assert len(found) >= 3, found       # each form of the pattern


@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_negative(rule):
    path, _, neg = CASES[rule]
    assert _lint(neg, path, rule) == []


@pytest.mark.parametrize("rule,elsewhere", [
    ("tensor-host-branch", "launch/mod.py"),
    ("fp8-payload-arith", "core/quant.py"),
    ("fp8-payload-arith", "kernels/fp8_gemm/ops.py"),
    ("hidden-host-sync", "launch/mod.py"),
    ("device-switch", "repro_torch/device.py"),
    ("host-scalar-division", "core/ptq.py"),
    ("scalar-index-write", "models/mod.py")])
def test_rule_scope(rule, elsewhere):
    """A rule holds only where its invariant does: the same positive
    source gives nothing outside its paths."""
    _, pos, _ = CASES[rule]
    assert _lint(pos, elsewhere, rule) == []


def test_donated_buffer_reuse_has_no_torch_form():
    assert "donated-buffer-reuse" not in RULES_BY_NAME
    assert "donated-buffer-reuse" in NOT_PORTED
    out = subprocess.run(CLI + ["--list-rules"], capture_output=True,
                         text=True, env={"PYTHONPATH": ENV_SRC},
                         check=True).stdout
    listed = [ln.split()[0] for ln in out.splitlines()]
    assert listed[:len(ALL_RULES)] == [r.name for r in ALL_RULES]
    assert "donated-buffer-reuse" not in listed
    assert "(donated-buffer-reuse)" in listed        # named as not ported


# -- baseline -----------------------------------------------------------------

def _write_fixture(tmp_path, src=MODULE_TENSOR, name="mod.py"):
    pkg = tmp_path / "layers"
    pkg.mkdir(exist_ok=True)
    (pkg / name).write_text(textwrap.dedent(src))
    return pkg


def test_baseline_match_and_expire(tmp_path):
    pkg = _write_fixture(tmp_path)
    result = lint_paths([str(pkg)], root=str(tmp_path))
    assert len(result.new) == 1 and result.failed()
    baseline = Baseline.from_findings(result.new)
    path = tmp_path / "baseline.json"
    baseline.save(str(path))
    again = lint_paths([str(pkg)], baseline=Baseline.load(str(path)),
                       root=str(tmp_path))
    assert again.new == [] and len(again.baselined) == 1
    assert not again.failed(fail_on_expired=True)
    (pkg / "mod.py").write_text("X = 1\n")              # the fix
    fixed = lint_paths([str(pkg)], baseline=Baseline.load(str(path)),
                       root=str(tmp_path))
    assert fixed.new == [] and len(fixed.expired) == 1
    assert not fixed.failed() and fixed.failed(fail_on_expired=True)


def test_baseline_counts_duplicate_lines(tmp_path):
    pkg = _write_fixture(tmp_path, "import torch\nA = torch.zeros(3)\n"
                                   "A = torch.zeros(3)\n")
    result = lint_paths([str(pkg)], root=str(tmp_path))
    assert len(result.new) == 2
    baseline = Baseline.from_findings(result.new[:1])
    assert list(baseline.entries.values()) == [1]
    split = lint_paths([str(pkg)], baseline=baseline, root=str(tmp_path))
    assert len(split.new) == 1 and len(split.baselined) == 1


@pytest.mark.parametrize("data", [{"version": 2, "entries": {}},
                                  {"version": 1, "entries": {"a::b::c": 0}}])
def test_baseline_rejects_bad_files(tmp_path, data):
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps(data))
    with pytest.raises(ValueError):
        Baseline.load(str(path))


def test_report_and_baseline_match_the_jax_schema(tmp_path):
    """The same findings through both packages' ``build_report`` and
    ``Baseline`` give the same JSON."""
    from repro.analysis import Baseline as JaxBaseline
    from repro.analysis import build_report as jax_build_report
    from repro.analysis.findings import REPORT_VERSION as JAX_VERSION
    from repro.analysis.findings import Finding as JaxFinding
    rows = [("src/a.py", 3, 4, "hidden-host-sync", "msg one", "x.item()"),
            ("src/a.py", 9, 0, "hidden-host-sync", "msg one", "x.item()"),
            ("src/b.py", 1, 0, "fp8-payload-arith", "msg two", "q * s")]
    ours = [Finding(*r) for r in rows]
    theirs = [JaxFinding(*r) for r in rows]
    assert REPORT_VERSION == JAX_VERSION
    assert build_report(ours[:2], ours[2:], [("f", "r", "s")], 7,
                        ["b", "a"]) == \
        jax_build_report(theirs[:2], theirs[2:], [("f", "r", "s")], 7,
                         ["b", "a"])
    Baseline.from_findings(ours).save(str(tmp_path / "ours.json"))
    JaxBaseline.from_findings(theirs).save(str(tmp_path / "theirs.json"))
    assert (tmp_path / "ours.json").read_text() == \
        (tmp_path / "theirs.json").read_text()
    assert Baseline.load(str(tmp_path / "theirs.json")).apply(ours)[1] \
        == ours


# -- rule selection / misc ----------------------------------------------------

def test_select_rules():
    assert [r.name for r in select_rules(None)] == \
        [r.name for r in ALL_RULES]
    assert [r.name for r in select_rules(["hidden-host-sync"])] == \
        ["hidden-host-sync"]
    with pytest.raises(KeyError, match="unknown lint rule"):
        select_rules(["donated-buffer-reuse"])


def test_syntax_error_is_loud(tmp_path):
    pkg = _write_fixture(tmp_path, "def broken(:\n")
    with pytest.raises(SyntaxError):
        lint_paths([str(pkg)], root=str(tmp_path))


# -- shipped tree + CLI -------------------------------------------------------

def test_shipped_tree_is_clean_with_empty_baseline():
    path = REPO / "src" / "repro_torch" / "analysis" / "lint_baseline.json"
    baseline = Baseline.load(str(path))
    assert baseline.entries == {}, "shipped baseline must stay empty"
    result = lint_paths([str(REPO / "src" / "repro_torch")],
                        baseline=baseline, root=str(REPO))
    assert result.files_scanned > 50
    assert result.new == [], "\n".join(str(f) for f in result.new)
    assert result.expired == []


def test_cli_runs_without_torch_or_numpy(tmp_path):
    """The CLI lints before torch is installed: it must work with torch
    and numpy blocked from import (and the package import stays light)."""
    pkg = _write_fixture(tmp_path)
    driver = textwrap.dedent(f"""
        import runpy, sys

        class _BlockHeavyDeps:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("torch", "numpy", "jax"):
                    raise ImportError(f"linter imported heavy dep {{name}}")
                return None

        sys.meta_path.insert(0, _BlockHeavyDeps())
        sys.path.insert(0, {ENV_SRC!r})
        import repro_torch.analysis
        sys.argv = ["lint", {str(pkg)!r}]
        runpy.run_module("repro_torch.launch.lint", run_name="__main__")
    """)
    proc = subprocess.run([sys.executable, "-c", driver],
                          capture_output=True, text=True)
    assert "ImportError" not in proc.stderr, proc.stderr
    assert proc.returncode == 1, proc.stderr          # the finding
    assert "torch-module-constant" in proc.stdout


def test_cli_smoke(tmp_path):
    pkg = _write_fixture(tmp_path)
    report_path = tmp_path / "report.json"
    base = str(tmp_path / "baseline.json")
    env = {"PYTHONPATH": ENV_SRC}
    proc = subprocess.run(CLI + [str(pkg), "--baseline", base, "--json",
                                 str(report_path)],
                          capture_output=True, text=True, env=env)
    assert proc.returncode == 1
    assert "torch-module-constant" in proc.stdout
    report = json.loads(report_path.read_text())
    assert report["new"] == 1 and report["version"] == REPORT_VERSION
    assert report["rules"] == sorted(r.name for r in ALL_RULES)

    # --update-baseline accepts it; the next run exits 0; a fix expires it
    subprocess.run(CLI + [str(pkg), "--baseline", base, "--update-baseline"],
                   check=True, capture_output=True, env=env)
    proc2 = subprocess.run(CLI + [str(pkg), "--baseline", base],
                           capture_output=True, text=True, env=env)
    assert proc2.returncode == 0 and "[baselined]" in proc2.stdout
    (pkg / "mod.py").write_text("X = 1\n")
    proc3 = subprocess.run(CLI + [str(pkg), "--baseline", base,
                                  "--fail-on-expired", "--rules",
                                  "torch-module-constant"],
                           capture_output=True, text=True, env=env)
    assert proc3.returncode == 1 and "expired baseline entry" in proc3.stdout
