"""Stacked parameters split into periods once per stage (``models/blocks.py``
``split_periods``) on the CPU.

At the benchmark's tiny phi3-shaped and HuBERT-shaped configurations in
bfloat16, with remat on and off: the gradient tree of ``launch/steps.py``
``value_and_grad`` equals (``torch.equal``) the one taken with every period
indexed from the stacks (``select`` views, the split before), whose backward
sends back L zero-filled full-size gradients per leaf and sums them. Each
element gets one nonzero contribution either way and ``x + 0`` is exact, so
the values are equal. The autograd graph holds one ``UnbindBackward0`` per
stacked leaf and no ``SelectBackward0`` between a stacked leaf and the loss;
``blocks.STATS["stack_unbinds"]`` counts the leaves unbound, and
``tracing.summary()`` reports its growth inside a traced window only.
"""

from __future__ import annotations

import json
import pathlib
import sys
from collections import Counter

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.drivers import audio_steps, train_steps  # noqa: E402
from perfbench.inputs.audio import AudioStream  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models import blocks, train_loss  # noqa: E402
from repro_torch.models.model import model_spec  # noqa: E402
from repro_torch.models.param import (tree_flatten, tree_leaves_with_path,  # noqa: E402
                                      tree_map, tree_materialize)

CPU = torch.device("cpu")
# The benchmark tests' tiny cut of the decoder cells, on phi3's file.
TINY_DECODER = {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
                "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 256}
# The HuBERT tests' tiny encoder, in the cell's bfloat16.
TINY_HUBERT = {"name": "hubert-tiny", "source": "test", "hidden_size": 64,
               "intermediate_size": 128, "num_attention_heads": 4, "num_key_value_heads": 2,
               "head_dim": 16, "vocab_size": 256, "final_dim": 48, "logit_temp": 0.1,
               "conv_dim": [32] * 7, "conv_kernel": [10, 3, 3, 3, 3, 2, 2],
               "conv_stride": [5, 2, 2, 2, 2, 2, 2], "conv_bias": True,
               "feat_extract_norm": "layer", "do_stable_layer_norm": True,
               "num_conv_pos_embeddings": 16, "num_conv_pos_embedding_groups": 4,
               "layer_norm_eps": 1e-5, "hidden_act": "gelu", "feature_penalty": 10.0,
               "torch_dtype": "bfloat16"}
AUDIO_TRAFFIC = {"batch": 2, "seq": 40, "label_zipf": 1.1, "mask_prob": 0.8, "mask_length": 10}


def _setup(family: str, layers: int):
    """(config, parameters, batch) of the tiny cut with ``layers`` periods."""
    if family == "phi3":
        config = json.loads((ROOT / "perfbench/configs/phi3-medium-14b.json").read_text())
        config.update(TINY_DECODER, num_hidden_layers=layers)
        cfg = train_steps.model_config(config)
        g = torch.Generator().manual_seed(5)
        tokens = torch.randint(0, 256, (2, 33), generator=g)
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    else:
        config = dict(TINY_HUBERT, num_hidden_layers=layers)
        cfg = audio_steps.model_config(config)
        batch = AudioStream(config, AUDIO_TRAFFIC, 3, CPU).next_batch()
    params = tree_materialize(model_spec(cfg), torch.Generator().manual_seed(11), CPU)
    return cfg, params, batch


def _select_periods(params: dict) -> list[dict]:
    """The split before: every period indexed from the stacks."""
    _, leaf = next(tree_leaves_with_path(params))
    return [tree_map(lambda a: a[p], params) for p in range(leaf.shape[0])]


def _stacked(tree: dict) -> dict[int, str]:
    return {id(t): path for path, t in tree_leaves_with_path(tree) if path.startswith("stage")}


CASES = [(family, layers) for family in ("phi3", "hubert") for layers in (2, 5)]


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("family, layers", CASES)
def test_gradients_equal_per_period_indexing(family, layers, remat, monkeypatch):
    cfg, params, batch = _setup(family, layers)

    def loss_fn(p, b):
        return train_loss(p, b, cfg, remat=remat)

    loss, grads = value_and_grad(loss_fn, params, batch)
    monkeypatch.setattr(blocks, "split_periods", _select_periods)
    want_loss, want = value_and_grad(loss_fn, params, batch)
    assert torch.equal(loss, want_loss)
    got, want = dict(tree_leaves_with_path(grads)), dict(tree_leaves_with_path(want))
    assert set(got) == set(want)
    assert any(g.shape[0] == layers for p, g in got.items() if p.startswith("stage"))
    for path, g in want.items():
        assert got[path].dtype == g.dtype and torch.equal(got[path], g), path


def _consumers(loss: torch.Tensor, stacked: dict[int, str]) -> Counter:
    """(node name, leaf path) of every backward node of ``loss``'s graph that
    takes a stacked leaf's gradient straight to the leaf."""
    out, seen, todo = Counter(), set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for child, _ in node.next_functions:
            if id(getattr(child, "variable", None)) in stacked:
                out[node.name(), stacked[id(child.variable)]] += 1
            todo.append(child)
    return out


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("family", ["phi3", "hubert"])
def test_one_unbind_per_stacked_leaf_and_no_select(family, remat, monkeypatch):
    cfg, params, batch = _setup(family, 3)
    seen = {}
    for split in ("unbind", "select"):
        if split == "select":
            monkeypatch.setattr(blocks, "split_periods", _select_periods)
        leaves, unflatten = tree_flatten(params)
        tree = unflatten([p.detach().requires_grad_(True) for p in leaves])
        with torch.enable_grad():
            loss = train_loss(tree, batch, cfg, remat=remat)
        seen[split] = _consumers(loss, _stacked(tree))
    paths = set(_stacked(params).values())
    assert len(paths) > 5
    # Each stacked leaf's gradient comes from its one unbind and nothing else.
    assert seen["unbind"] == Counter({("UnbindBackward0", p): 1 for p in paths})
    # The walk sees the old split's graph: a select a period, no unbind.
    assert seen["select"] == Counter({("SelectBackward0", p): 3 for p in paths})


@pytest.mark.parametrize("family", ["phi3", "hubert"])
def test_stack_unbinds_count_the_stacked_leaves_of_each_stage_call(family, monkeypatch):
    cfg, params, batch = _setup(family, 3)
    calls = []
    stage_apply = blocks.stage_apply

    def counted(stage_params, *a, **kw):
        calls.append(sum(1 for _ in tree_leaves_with_path(stage_params)))
        return stage_apply(stage_params, *a, **kw)

    monkeypatch.setattr(blocks, "stage_apply", counted)
    before = blocks.STATS["stack_unbinds"]
    with torch.no_grad():
        train_loss(params, batch, cfg)
    assert calls == [len(_stacked(params))]
    assert blocks.STATS["stack_unbinds"] - before == sum(calls)
    value_and_grad(lambda p, b: train_loss(p, b, cfg), params, batch)  # remat's recompute
    assert calls == [len(_stacked(params))] * 2  # splits nothing again
    assert blocks.STATS["stack_unbinds"] - before == sum(calls)


def test_summary_reports_the_unbinds_of_its_window_only():
    cfg, params, batch = _setup("phi3", 2)
    n = len(_stacked(params))

    def forward():
        with torch.no_grad():
            train_loss(params, batch, cfg)

    with tracing.span("before"):  # the profiler is off: no window
        forward()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        with tracing.span("window"):
            forward()
    finally:
        prof.stop()
    forward()  # after the window
    s = tracing.summary()
    assert "window" in s["spans"] and "before" not in s["spans"]
    assert s["blocks"] == {"stack_unbinds": n}
    assert "launches" in s and "executor" in s
