"""The port's static analyzer on the CPU: rules, pragmas, contracts, CLI.

``repro_torch.analysis`` is the PyTorch counterpart of ``repro.analysis``.
Each port rule fires exactly on its seeded fixture's ``# VIOLATION`` lines
(tests/fixtures/analysis_torch/, linted as source and never imported, read
the way tests/test_analysis.py reads its fixtures); pragmas suppress; the
findings and the baseline behave as JAX's do on the same findings;
``typed-errors`` and ``registry-hooks`` report JAX's lines on JAX's own
fixtures; every run contract holds on the CPU under the JAX contract's
name, and each turns ``ok=False`` on a seeded violation; the CLI exits 0 on
the tree and 1 on a fixture.
"""

import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro.analysis import findings as jfindings
from repro.analysis import lint as jlint
from repro_torch import __main__ as tmain
from repro_torch.analysis import cli, contracts, lint
from repro_torch.analysis.findings import Baseline, Finding
from repro_torch.api import sweep as sweep_lib
from repro_torch.core import engine, executor

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures" / "analysis_torch"
JAX_FIXTURES = ROOT / "tests" / "fixtures" / "analysis"

_MARKER = re.compile(r"# VIOLATION")

PORT_RULES = ("mesh-via-make-mesh", "registry-hooks", "traced-host-sync", "typed-errors",
              "version-floor")
# JAX rules with no counterpart in the port (reasons in the lint docstring).
NOT_PORTED_RULES = ("pallas-scalar-index", "jit-donation", "f64-without-x64")
CONTRACTS = ("lockstep-scan-fusion", "lockstep-no-host-callbacks", "lag-scan-fusion",
             "lag-no-host-callbacks", "donation-_worker_rounds_fused",
             "donation-_lag_window_append", "donation-_server_apply_fused",
             "sweep-bucket-cache-sharing")


def marked_lines(path: pathlib.Path) -> dict[int, int]:
    """{line number: expected finding count} from the # VIOLATION markers."""
    out = {}
    for i, text in enumerate(path.read_text().splitlines(), start=1):
        n = len(_MARKER.findall(text))
        if n:
            out[i] = n
    return out


def lint_fixture(name: str, rule: str | None = None) -> list[Finding]:
    return lint.lint_paths([FIXTURES / name], root=ROOT,
                           rules=None if rule is None else [rule])


@pytest.fixture(scope="module")
def tree():
    return lint.parse_project([ROOT / "src" / "repro_torch"], root=ROOT)


# ---------------------------------------------------------------------------
# The rules.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fixture,rule", [
    ("bad_host_sync.py", "traced-host-sync"),
    ("bad_mesh.py", "mesh-via-make-mesh"),
    ("bad_registry.py", "registry-hooks"),
    ("bad_serve_typed_errors.py", "typed-errors"),
    ("bad_version_floor.py", "version-floor"),
])
def test_rule_fires_at_marked_lines(fixture, rule):
    expected = marked_lines(FIXTURES / fixture)
    assert expected, f"{fixture} lost its # VIOLATION markers"
    found = lint_fixture(fixture, rule)
    got: dict[int, int] = {}
    for f in found:
        assert f.rule == rule
        assert f.path.endswith(fixture), f.path
        got[f.line] = got.get(f.line, 0) + 1
    assert got == expected, (
        f"{fixture}: findings at {got}, markers at {expected}\n"
        + "\n".join(f.format() for f in found))


@pytest.mark.parametrize("fixture", ["bad_host_sync.py", "bad_registry.py"])
def test_all_rules_together_report_only_marked_lines(fixture):
    found = lint_fixture(fixture)
    assert {f.line for f in found} == set(marked_lines(FIXTURES / fixture))


def test_pragmas_suppress_everything():
    found = lint_fixture("ok_pragmas.py")
    assert found == [], "\n".join(f.format() for f in found)


def test_host_code_and_scalar_parameters_are_not_flagged():
    found = lint_fixture("bad_host_sync.py", "traced-host-sync")
    assert found and all(f.context != "host_report" for f in found)
    text = (FIXTURES / "bad_host_sync.py").read_text().splitlines()
    scalar = next(i for i, t in enumerate(text, 1) if "float(scale)" in t)
    assert scalar not in {f.line for f in found}


def test_rule_registry():
    rules = lint.available_rules()
    assert rules == PORT_RULES
    for name in PORT_RULES:
        assert lint.get_rule(name).description
    for name in NOT_PORTED_RULES:
        assert name in jlint.available_rules() and name not in rules
    assert set(PORT_RULES) < set(jlint.available_rules())
    assert lint.get_rule("version-floor").BANNED.isdisjoint(
        jlint.get_rule("version-floor").BANNED)
    with pytest.raises(ValueError, match="unknown analysis rule"):
        lint.get_rule("nope")


def test_example_rules_excluded_from_default_set():
    @lint.register_rule("no-print-example")
    class NoPrint(lint.Rule):
        description = "test-only"

        def check(self, module, project):
            return []

    try:
        assert "no-print-example" in lint.available_rules()
        assert "no-print-example" not in lint.default_rules()
    finally:
        del lint._RULES["no-print-example"]


def test_captured_set_of_the_tree(tree):
    """The executor's and the sweeps' run bodies (and what they call) are in
    the captured set; the kernels' plain versions and the host-side code
    around a run are not."""
    traced = {(fn.module.modname, fn.qualname) for fn in tree._reachable}
    for want in [("repro_torch.core.executor", "lockstep_body.fn"),
                 ("repro_torch.core.executor", "_run_queue.body"),
                 ("repro_torch.core.executor", "QueueRun.server"),
                 ("repro_torch.core.executor", "QueueRun.launch"),
                 ("repro_torch.core.engine", "lag_window_append"),
                 ("repro_torch.core.engine", "aggregate_masked"),
                 ("repro_torch.kernels.ops", "sdca_epoch"),
                 ("repro_torch.kernels.sdca_inner", "sdca_inner_cuda"),
                 ("repro_torch.api.sweep", "_lockstep_cells.body"),
                 ("repro_torch.api.sweep", "_lockstep_vmap_body.fn"),
                 ("repro_torch.api.sweep", "_lag_vmap_body.fn")]:
        assert want in traced, want
    for host in [("repro_torch.kernels.ref", "sdca_inner_ref"),
                 ("repro_torch.kernels.topk_filter", "topk_filter_plain"),
                 ("repro_torch.core.executor", "run_scan"),
                 ("repro_torch.core.executor", "queue_accounts"),
                 ("repro_torch.core.executor", "lockstep_draw")]:
        assert host not in traced, host
    assert any(fn.module.modname == "repro_torch.core.executor"
               and fn.qualname.startswith("Graphed._capture.<graph:") for fn in tree._roots)


def test_registry_hooks_checks_the_port_registrations(tree):
    """The rule sees every real registration (their decorators and the
    solvers' call form resolve to the registrars) and all pass."""
    rule = lint.get_rule("registry-hooks")
    seen = {}
    for module in tree.modules:
        for cls in module.classes.values():
            for dec in cls.decorator_list:
                if isinstance(dec, lint.ast.Call):
                    canon = module.canonical(dec.func)
                    if canon in rule.REGISTRIES:
                        seen[canon] = seen.get(canon, 0) + 1
    assert seen == {"repro_torch.core.engine.register_protocol": 9,
                    "repro_torch.core.compress.register_compressor": 4,
                    "repro_torch.core.delays.register_delay": 5}
    assert lint.lint_project(tree, rules=["registry-hooks"]) == []
    solvers = next(m for m in tree.modules if m.modname == "repro_torch.core.solvers")
    text = "\n".join(solvers.lines).replace(
        "def _solve_once(orders, w_all, alpha, X, y, norms_sq, lam, n_global, sigma_prime, *,\n"
        "                loss, cells=1, map_error=None)",
        "def _solve_once(orders, w_all, alpha, X, y, norms_sq, lam, n_global, sigma_prime, *,\n"
        "                loss)")
    assert text != "\n".join(solvers.lines)
    broken = lint.lint_source(text, path="src/repro_torch/core/solvers.py",
                              rules=["registry-hooks"])
    assert [f.snippet for f in broken] == ['register_solver("sdca")(SDCA)',
                                           'register_solver("importance")(IMPORTANCE)']


def test_the_tree_lints_clean_against_its_empty_baseline(tree):
    baseline = Baseline.load(ROOT / "ANALYSIS_BASELINE_TORCH.json")
    assert baseline.fingerprints == set()
    new, accepted, stale = baseline.split(lint.lint_project(tree))
    assert (new, accepted, stale) == ([], [], set()), "\n".join(f.format() for f in new)


# ---------------------------------------------------------------------------
# Port against JAX on the same inputs.
# ---------------------------------------------------------------------------


def test_findings_and_baseline_split_equal_jax(tmp_path):
    found = lint_fixture("bad_host_sync.py") + lint_fixture("bad_registry.py")
    mirror = [jfindings.Finding(**f.as_dict()) for f in found]
    assert [f.fingerprint for f in found] == [f.fingerprint for f in mirror]
    assert [f.format() for f in found] == [f.format() for f in mirror]
    assert [f.as_dict() for f in lint.sort_findings(found)] == [
        f.as_dict() for f in jfindings.sort_findings(mirror)]
    Baseline.write(tmp_path / "t.json", found[:5])
    jfindings.Baseline.write(tmp_path / "j.json", mirror[:5])
    t_doc, j_doc = (json.loads((tmp_path / n).read_text()) for n in ("t.json", "j.json"))
    assert t_doc["findings"] == j_doc["findings"]
    assert "python -m repro_torch analyze" in " ".join(t_doc["_comment"].split())
    t_split = Baseline.load(tmp_path / "t.json").split(found[3:])
    j_split = jfindings.Baseline.load(tmp_path / "j.json").split(mirror[3:])
    assert ([f.as_dict() for f in t_split[0]], [f.as_dict() for f in t_split[1]],
            t_split[2]) == ([f.as_dict() for f in j_split[0]],
                            [f.as_dict() for f in j_split[1]], j_split[2])


def test_typed_errors_matches_jax_on_its_fixture():
    path = JAX_FIXTURES / "bad_serve_typed_errors.py"
    port = lint.lint_paths([path], root=ROOT, rules=["typed-errors"])
    jax = jlint.lint_paths([path], root=ROOT, rules=["typed-errors"])
    assert [f.line for f in port] == [f.line for f in jax] == sorted(marked_lines(path))
    assert [f.fingerprint for f in port] == [f.fingerprint for f in jax]


def test_registry_hooks_matches_jax_on_its_fixture():
    path = JAX_FIXTURES / "bad_registry.py"
    text = path.read_text()
    port = lint.lint_source(text.replace("repro.", "repro_torch."), path="bad_registry.py",
                            rules=["registry-hooks"])
    jax = jlint.lint_source(text, path="bad_registry.py", rules=["registry-hooks"])
    assert [f.line for f in port] == [f.line for f in jax] == sorted(marked_lines(path))


# ---------------------------------------------------------------------------
# The run contracts.
# ---------------------------------------------------------------------------


def test_contracts_hold_on_the_cpu():
    results = contracts.run_contracts(device="cpu")
    assert tuple(sorted(r.name for r in results)) == tuple(sorted(CONTRACTS))
    jax_source = (ROOT / "src" / "repro" / "analysis" / "contracts.py").read_text()
    for r in results:
        assert r.ok, r.format()
        base = r.name.removeprefix("donation-")
        assert (base if base != r.name else r.name) in jax_source, r.name
        assert r.format().startswith(f"contract {r.name}: ok -- ")
        assert r.as_dict() == {"name": r.name, "ok": True, "detail": r.detail}


def _item_in_lockstep_round(monkeypatch):
    orig = engine.lockstep_round

    def bad(w, alpha, gamma, solve):
        w.sum().item()
        return orig(w, alpha, gamma, solve)

    monkeypatch.setattr(engine, "lockstep_round", bad)


def _mask_index_in_lag_skip(monkeypatch):
    orig = engine.lag_skip

    def bad(ref_buf, ref_len, widx, xi, dw, sent, new_residual):
        dw[dw > 0].sum()  # a boolean mask index: a data-dependent shape
        return orig(ref_buf, ref_len, widx, xi, dw, sent, new_residual)

    monkeypatch.setattr(engine, "lag_skip", bad)


def _key_per_run(monkeypatch):
    orig, runs = executor._lockstep_key, []

    def key(*args):
        runs.append(1)
        return orig(*args) + (len(runs),)

    monkeypatch.setattr(executor, "_lockstep_key", key)


def _sweep_key_per_cell_count(monkeypatch):
    orig = sweep_lib._lockstep_key

    def key(problem, method, num_cells, **kw):
        return orig(problem, method, num_cells, **kw) + (num_cells,)

    monkeypatch.setattr(sweep_lib, "_lockstep_key", key)


def _reply_out_of_place(monkeypatch):
    def bad(w_local, dw_tilde, widx):
        replies = dw_tilde.index_select(0, widx)
        w_local = w_local.index_copy(0, widx, w_local.index_select(0, widx) + replies)
        dw_tilde = dw_tilde.index_fill(0, widx, 0.0)  # rebound: the carry is a copy
        return torch.sum(replies * replies, dim=1), torch.sum(replies != 0, dim=1)

    monkeypatch.setattr(engine, "reply", bad)


def _window_out_of_place(monkeypatch):
    orig = engine.lag_window_append

    def bad(ref_buf, ref_len, widx, reply_sq):
        orig(ref_buf.clone(), ref_len.clone(), widx, reply_sq)

    monkeypatch.setattr(engine, "lag_window_append", bad)


def _aggregate_in_place(monkeypatch):
    def bad(w_server, dw_tilde, payloads, gamma):
        for payload in payloads:
            w_server.add_(gamma * payload)
        return w_server, dw_tilde

    monkeypatch.setattr(engine, "aggregate", bad)


@pytest.mark.parametrize("seed,check,broken", [
    (_item_in_lockstep_round, contracts.check_lockstep_contracts,
     "lockstep-no-host-callbacks"),
    (_mask_index_in_lag_skip, contracts.check_lag_contracts, "lag-no-host-callbacks"),
    (_key_per_run, contracts.check_lockstep_contracts, "lockstep-scan-fusion"),
    (_sweep_key_per_cell_count, contracts.check_sweep_bucket_sharing,
     "sweep-bucket-cache-sharing"),
    (_reply_out_of_place, contracts.check_engine_donation, "donation-_worker_rounds_fused"),
    (_window_out_of_place, contracts.check_engine_donation, "donation-_lag_window_append"),
    (_aggregate_in_place, contracts.check_engine_donation, "donation-_server_apply_fused"),
], ids=lambda x: getattr(x, "__name__", x))
def test_contract_fails_on_a_seeded_violation(monkeypatch, seed, check, broken):
    seed(monkeypatch)
    results = {r.name: r for r in check("cpu")}
    assert not results[broken].ok, results[broken].format()
    assert results[broken].format().startswith(f"contract {broken}: FAIL -- ")


def test_linear_launch_rule():
    ok, per = contracts._linear({"sdca_inner": 4, "topk_filter": 0},
                                {"sdca_inner": 7, "topk_filter": 0}, 3, 6, 1)
    assert ok and per == {"sdca_inner": 1, "topk_filter": 0}
    assert not contracts._linear({"sdca_inner": 4}, {"sdca_inner": 7}, 3, 6, 0)[0]
    assert not contracts._linear({"sdca_inner": 3}, {"sdca_inner": 7}, 3, 6, 0)[0]
    assert not contracts._linear({"sdca_inner": 0}, {"sdca_inner": 0}, 3, 6, 0)[0]


def test_a_raising_suite_is_a_failed_result(monkeypatch):
    def boom(device):
        raise RuntimeError("boom")

    monkeypatch.setattr(contracts, "check_engine_donation", boom)
    results = {r.name: r for r in contracts.run_contracts(device="cpu", include_lag=False)}
    assert [name for name, r in results.items() if not r.ok] == ["boom"]
    assert "RuntimeError('boom')" in results["boom"].detail
    assert "lag-scan-fusion" not in results


def test_contracts_need_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        contracts.run_contracts()


# ---------------------------------------------------------------------------
# The CLI.
# ---------------------------------------------------------------------------


def test_cli_on_the_tree_exits_zero():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch", "analyze", "--device", "cpu"],
                          capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == ("0 new finding(s), 0 baseline-accepted, 0 stale baseline "
                         "entr(ies); contracts: 8/8 ok")
    assert sum(ln.startswith("contract ") for ln in lines) == len(CONTRACTS)


def test_cli_exits_nonzero_on_a_fixture(tmp_path, capsys):
    rc = tmain.main(["analyze", "--no-contracts", "--baseline", str(tmp_path / "empty.json"),
                     "--paths", str(FIXTURES / "bad_host_sync.py")])
    assert rc == 1
    out = capsys.readouterr().out
    assert "traced-host-sync" in out and "bad_host_sync.py" in out


def test_cli_exits_zero_on_clean_input(tmp_path, capsys):
    rc = cli.main(["--no-contracts", "--baseline", str(tmp_path / "empty.json"),
                   "--paths", str(FIXTURES / "ok_pragmas.py")])
    assert rc == 0
    assert "0 new finding(s)" in capsys.readouterr().out


def test_cli_update_baseline_roundtrip(tmp_path, capsys):
    base = tmp_path / "b.json"
    args = ["--baseline", str(base), "--paths", str(FIXTURES / "bad_mesh.py"),
            "--no-contracts"]
    assert cli.main(args + ["--update-baseline"]) == 0
    capsys.readouterr()
    assert cli.main(args) == 0  # accepted now
    assert "2 baseline-accepted" in capsys.readouterr().out
    assert cli.main(args[:2] + ["--paths", str(FIXTURES / "ok_pragmas.py"),
                                "--no-contracts"]) == 0
    assert "2 stale baseline" in capsys.readouterr().out


def test_cli_json_and_rule_list(tmp_path, capsys):
    assert cli.main(["--list-rules"]) == 0
    listed = [ln.split(":")[0] for ln in capsys.readouterr().out.splitlines()]
    assert tuple(listed) == PORT_RULES
    rc = cli.main(["--json", "--no-contracts", "--baseline", str(tmp_path / "e.json"),
                   "--paths", str(FIXTURES / "bad_mesh.py")])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1 and [f["line"] for f in doc["new"]] == [9, 10]
    assert doc["contracts"] == [] and doc["stale_fingerprints"] == []


def test_readme_names_every_port_rule_and_contract():
    readme = (ROOT / "README.md").read_text()
    section = readme[readme.index("python -m repro_torch analyze"):]
    for name in PORT_RULES + NOT_PORTED_RULES + CONTRACTS:
        assert f"`{name}`" in section, name
