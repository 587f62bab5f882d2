"""The port's public API on the CPU: specs, presets, Experiment and the CLI.

Spec JSON written by ``repro`` loads in ``repro_torch`` unchanged and
serializes back to the same text, preset for preset; validation reports the
same errors; ``python -m repro_torch spec`` prints what ``python -m repro
spec`` prints, and ``run --device cpu`` runs a spec through ``Experiment``.
"""

import dataclasses
import io
import json
import os
import pathlib
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from repro import __main__ as jmain
from repro.api import presets as jpresets
from repro.api import spec as jspec
from repro_torch import __main__ as tmain
from repro_torch import api
from repro_torch.api import presets as tpresets
from repro_torch.core import baselines as tbase
from repro_torch.core.simulate import ClusterModel

ROOT = pathlib.Path(__file__).resolve().parent.parent

PRESET_CALLS = [(name, kw) for name in sorted(jpresets.PRESETS)
                for kw in ({}, {"quick": True})]


@pytest.mark.parametrize("name,kw", PRESET_CALLS, ids=lambda x: str(x))
def test_preset_json_round_trips_to_the_same_text(name, kw):
    text = jpresets.build_preset(name, **kw).to_json()
    spec = api.ExperimentSpec.from_json(text)
    assert spec.to_json() == text
    assert tpresets.build_preset(name, **kw).to_json() == text
    assert api.ExperimentSpec.from_json(text) == spec
    spec.validate()


def test_spec_validation_reports_what_jax_reports():
    base = jpresets.build_preset("fig3", quick=True).to_dict()
    bad_specs = []
    d = json.loads(json.dumps(base))
    d["methods"][0]["config"]["protocol"] = "nope"
    bad_specs.append(d)
    d = json.loads(json.dumps(base))
    d["methods"][1]["config"]["compressor"] = "zip"
    d["methods"][1]["config"]["local_solver"] = "newton"
    bad_specs.append(d)
    d = json.loads(json.dumps(base))
    d["problem"]["kind"] = "mnist"
    d["eval_every"] = 0
    d["executor"] = "warp"
    d["shard"] = "rows"
    bad_specs.append(d)
    d = json.loads(json.dumps(base))
    d["checkpoint_every"] = 2
    d["cluster"]["membership"] = [[7, 0.5, 0.1]]
    bad_specs.append(d)
    for d in bad_specs:
        with pytest.raises(ValueError) as want:
            jspec.ExperimentSpec.from_dict(d).validate()
        with pytest.raises(ValueError) as got:
            api.ExperimentSpec.from_dict(d).validate()
        assert str(got.value) == str(want.value)


def test_spec_save_load_and_lookup(tmp_path):
    spec = tpresets.build_preset("table1", quick=True)
    path = tmp_path / "s.json"
    spec.save(path)
    assert api.ExperimentSpec.load(path) == spec
    assert path.read_text() == spec.to_json() + "\n"
    assert spec.method_named("ACPD").config.protocol == "group"
    with pytest.raises(KeyError, match="no method named"):
        spec.method_named("nope")
    with pytest.raises(ValueError, match="unknown preset"):
        tpresets.build_preset("fig9")


def test_experiment_runs_each_entry_on_its_executor():
    spec = tpresets.build_preset("table1", quick=True)
    exp = api.Experiment(spec, device="cpu")
    assert exp.problem.X.device.type == "cpu"
    executors = {e.config.name: exp.session(e).executor for e in spec.methods}
    assert executors == {"CoCoA+": "scan", "ACPD": "event", "ACPD-rho=1": "event"}
    results = exp.run()
    assert set(results) == set(executors)
    direct = api.Session(exp.problem, spec.methods[0].config, spec.cluster,
                         num_outer=spec.methods[0].num_outer, seed=spec.seed,
                         eval_every=spec.eval_every, executor="event", device="cpu").run()
    assert [dataclasses.asdict(r) for r in results["CoCoA+"].records] == [
        dataclasses.asdict(r) for r in direct.records]
    assert np.array_equal(results["CoCoA+"].w, direct.w)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        api.Experiment(dataclasses.replace(spec, checkpoint_every=2), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.Experiment(spec)


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("preset", ["fig3", "zoo-pareto", "fig4b-K2", "quickstart"])
def test_cli_spec_prints_the_jax_text(preset):
    for argv in (["spec", preset], ["spec", preset, "--quick"]):
        assert _cli(tmain.main, argv) == _cli(jmain.main, argv)


def test_cli_run_on_the_cpu(tmp_path):
    spec = api.ExperimentSpec(
        name="cli", problem=api.ProblemSpec("rcv1_like", {"K": 4, "d": 256,
                                                          "n_per_worker": 32}),
        cluster=ClusterModel(4, straggler_sigma=3.0),
        methods=(api.MethodEntry(tbase.cocoa_plus(4, H=32), 4),
                 api.MethodEntry(tbase.acpd_lag(4, 256, B=2, T=3, rho_d=16, H=32), 1)),
        eval_every=2)
    path = tmp_path / "spec.json"
    spec.save(path)
    out = tmp_path / "out.json"
    rc, text, _ = _cli(tmain.main, ["run", str(path), "--device", "cpu", "--out", str(out)])
    assert rc == 0
    assert "executor=scan" in text and "stop  reason=completed" in text
    payload = json.loads(out.read_text())
    assert payload["provenance"]["device"] == "cpu"
    assert payload["provenance"]["torch_version"] == torch.__version__
    assert "jax_version" not in payload["provenance"]
    assert api.ExperimentSpec.from_dict(payload["spec"]) == spec
    res = api.Experiment(spec, device="cpu").run()
    assert payload["results"]["CoCoA+"]["records"][-1]["gap"] == res["CoCoA+"].records[-1].gap
    rc, text, _ = _cli(tmain.main, ["run", str(path), "--device", "cpu",
                                    "--checkpoint-every", "2"])
    assert rc == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _cli(tmain.main, ["run", str(path)])


@pytest.mark.parametrize("cmd,item", [("bench", "A9")])
def test_cli_names_the_roadmap_item_of_what_is_not_ported(cmd, item):
    rc, out, err = _cli(tmain.main, [cmd, "--quick"])
    assert rc != 0 and out == ""
    assert f"ROADMAP {item}" in err and "not ported" in err


def test_cli_serve_help_names_the_port_flags():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch", "serve", "--help"],
                          capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("usage: repro_torch serve")
    for flag in ("--device", "--replica-of", "--replica-id", "--batch-deadline",
                 "--fault-model", "--checkpoint-dir", "--lease-ttl"):
        assert flag in proc.stdout
