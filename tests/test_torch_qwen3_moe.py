"""Qwen3-30B-A3B's held-experts path in the port (``HeldExpertsConfig``) on the CPU.

The port's ``train_loss`` and every leaf's gradient against the benchmark's
plain reference (``perfbench/reference/qwen3_moe.py``) at a tiny size in
float32 (d_model 64, 4 heads over 2 KV heads, 8 experts of which 2 are
held, top-2); the four shares of one layer summing to the uncut layer;
dropless routing under a router that sends every token to one held
expert; the load-balance term against transformers' formula written out
and a case worked by hand; the configuration file's mapping and counts;
the grouped products (the card's path) equal to the plain loop, forward
and backward; the counters; and the JAX package's MoE configs still on the
capacity path. Tolerances: float32 sums taken in other orders (the flash
attention's blocks, the experts' rows gathered), rtol 1e-5 on the loss and
the layer's output, 1e-4 of a leaf's scale on the gradients.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import pytest
import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.drivers.moe_steps import model_config  # noqa: E402
from perfbench.drivers.train_steps import flat  # noqa: E402
from perfbench.inputs import moe_weights  # noqa: E402
from perfbench.inputs.tokens import TokenStream  # noqa: E402
from perfbench.reference import qwen3_moe as reference  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models import blocks, moe, train_loss  # noqa: E402
from repro_torch.models.config import HeldExpertsConfig, ModelConfig  # noqa: E402
from repro_torch.models.model import model_spec  # noqa: E402
from repro_torch.models.param import num_params, tree_materialize  # noqa: E402

FILE = json.loads((ROOT / "perfbench/configs/qwen3-moe-30b-a3b.json").read_text())
TINY = dict(FILE, hidden_size=64, moe_intermediate_size=32, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, num_hidden_layers=2, num_experts=8,
            num_experts_per_tok=2, vocab_size=256, torch_dtype="float32")
SEED = 2**31 + 7_000_003


def _share(config: dict, shard: int, parallel: int = 4) -> dict:
    return dict(config, expert_parallel=parallel, expert_shard=shard)


def _batch(config: dict, seed: int, batch: int = 2, seq: int = 24) -> dict:
    vocab = moe_weights.held(config)[2]
    return TokenStream(vocab, batch, seq, 1.1, seed, torch.device("cpu")).next_batch()


def _program_loss_and_grads(config: dict, params: dict, batch: dict):
    cfg = model_config(config)
    return value_and_grad(lambda p, b: train_loss(p, b, cfg, remat=True), params, batch)


def _reference_loss_and_grads(config: dict, seed: int, batch: dict):
    P = {p: t.float().requires_grad_(True) for p, t in moe_weights.leaves(config, seed, "cpu")}
    value = reference.loss(P, batch["tokens"], batch["labels"], config)
    grads = torch.autograd.grad(value, list(P.values()))
    return value.detach(), dict(zip(P, grads))


@pytest.mark.parametrize("shard", [0, 3])
def test_loss_and_every_gradient_match_the_reference(shard):
    config = _share(TINY, shard)
    params = moe_weights.make(config, SEED, "cpu")
    batch = _batch(config, SEED + 1)
    loss, grads = _program_loss_and_grads(config, params, batch)
    want, want_grads = _reference_loss_and_grads(config, SEED, batch)
    assert float(loss) == pytest.approx(float(want), rel=1e-5)
    got = flat(grads)
    assert set(got) == set(want_grads)
    for path, w in want_grads.items():
        scale = float(w.abs().max())
        assert scale > 0, path  # every leaf, the held experts' too, takes a gradient
        assert float((got[path] - w).abs().max()) <= 1e-4 * scale, path


def test_the_four_shares_sum_to_the_uncut_layer():
    """At 8 experts, 2 held a share, top-2: the four shares' partial outputs
    of one layer add up to the reference's layer with every expert held."""
    whole = _share(TINY, 0, parallel=1)
    P = {p: t[0] for p, t in moe_weights.leaves(whole, SEED, "cpu") if p.startswith("stage0")}
    W = {p[len("stage0.pos0."):]: t for p, t in P.items()}
    x = torch.randn(40, TINY["hidden_size"], generator=torch.Generator().manual_seed(3))
    want, _, _ = reference.moe(x, W, whole)
    total = torch.zeros_like(want)
    for shard in range(4):
        cfg = model_config(_share(TINY, shard))
        held = slice(2 * shard, 2 * shard + 2)
        params = {"router": W["moe.router"], "gate": W["moe.gate"][held],
                  "up": W["moe.up"][held], "down": W["moe.down"][held]}
        out, _ = moe.moe_held(params, x[None], cfg)
        total += out[0]
    torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_a_router_skewed_to_one_held_expert_drops_nothing():
    """Every token's first choice is held expert 1 (id 3): all 40 rows are
    computed, where the capacity path's 1.25 factor would keep 16."""
    cfg = model_config(_share(TINY, 1))
    gen = torch.Generator().manual_seed(5)
    D, E_total = TINY["hidden_size"], TINY["num_experts"]
    router = torch.randn(D, E_total, generator=gen) * 0.01
    router[:, 3] = 1.0
    params = {"router": router, "gate": torch.randn(2, D, 32, generator=gen) / 8,
              "up": torch.randn(2, D, 32, generator=gen) / 8,
              "down": torch.randn(2, 32, D, generator=gen) / 6}
    x = torch.rand(40, D, generator=gen) + 0.1  # positive: expert 3's logit leads
    before = {k: int(v) for k, v in moe.STATS.items()}
    out, stats = moe.moe_held(params, x[None], cfg)
    assert stats[0, 3] == 1.0  # every token chose expert 3
    assert int(moe.STATS["largest_expert_rows"]) - before["largest_expert_rows"] == 40
    W = {"moe.router": router, "moe.gate": params["gate"], "moe.up": params["up"],
         "moe.down": params["down"]}
    want, _, top_e = reference.moe(x, W, _share(TINY, 1))
    assert bool((top_e[:, 0] == 3).all())
    torch.testing.assert_close(out[0], want, rtol=1e-5, atol=1e-6)
    assert moe.capacity(40, dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(),
                                                num_experts=8, experts_per_token=2)) < 40


def _transformers_load_balance(gate_logits: list, num_experts: int, top_k: int):
    """transformers' ``load_balancing_loss_func`` without an attention mask."""
    concatenated = torch.cat(gate_logits, dim=0)
    routing_weights = torch.softmax(concatenated, dim=-1)
    _, selected = torch.topk(routing_weights, top_k, dim=-1)
    expert_mask = F.one_hot(selected, num_experts)
    tokens_per_expert = torch.mean(expert_mask.float(), dim=0)
    router_prob_per_expert = torch.mean(routing_weights, dim=0)
    return torch.sum(tokens_per_expert * router_prob_per_expert.unsqueeze(0)) * num_experts


def test_load_balance_by_hand():
    """Two layers, two tokens, four experts, top-2. Layer 1's probabilities
    are (0.4, 0.3, 0.2, 0.1) for both tokens, layer 2's (0.1, 0.2, 0.3, 0.4):
    every expert is chosen by half the four rows once over both choices, so
    the choice shares sum to 0.5 per expert, and each expert's mean
    probability over the four rows is 0.25: 4 x 4 x 0.5 x 0.25 = 2."""
    p1 = torch.tensor([0.4, 0.3, 0.2, 0.1])
    logits = [torch.log(p1).expand(2, 4), torch.log(p1.flip(0)).expand(2, 4)]
    assert float(_transformers_load_balance(logits, 4, 2)) == pytest.approx(2.0)
    cfg = HeldExpertsConfig(num_layers=2, d_model=8, num_heads=2, num_kv_heads=1, head_dim=4,
                            d_ff=8, d_ff_expert=8, vocab_size=16, num_experts=1,
                            experts_total=4, experts_per_token=2)
    stats = torch.zeros(2, 4)
    for lg in logits:
        probs = torch.softmax(lg, -1)
        chosen = F.one_hot(torch.topk(probs, 2).indices, 4).float().sum(1).mean(0)
        stats += torch.stack([chosen, probs.mean(0)])
    assert float(moe.load_balance(stats, cfg)) == pytest.approx(2.0)


def test_load_balance_is_transformers_over_a_model():
    """The program's term from its layers' statistics equals the formula over
    the same routers' logits, recorded as the layers compute them."""
    config = _share(TINY, 2)
    cfg = model_config(config)
    params = moe_weights.make(config, SEED + 5, "cpu")
    batch = _batch(config, SEED + 6)
    seen, orig = [], moe.router_logits

    def recording(p, x):
        seen.append(orig(p, x))
        return seen[-1]

    moe.router_logits = recording
    try:
        with torch.no_grad():
            loss = train_loss(params, batch, cfg, remat=False)
            moe.router_logits = orig
            cfg0 = dataclasses.replace(cfg, load_balance_coef=0.0)
            nll = train_loss(params, batch, cfg0, remat=False)
    finally:
        moe.router_logits = orig
    want = _transformers_load_balance(seen, cfg.experts_total, cfg.experts_per_token)
    assert len(seen) == 2
    assert float(loss - nll) == pytest.approx(0.001 * float(want), rel=1e-4)


def test_configuration_file_maps_to_the_published_model():
    cfg = model_config(FILE)
    assert isinstance(cfg, HeldExpertsConfig)
    assert (cfg.num_experts, cfg.experts_total, cfg.first_expert, cfg.experts_per_token) == \
        (32, 128, 0, 8)
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
            cfg.d_ff_expert, cfg.vocab_size, cfg.num_layers) == (2048, 32, 4, 128, 768, 37984, 8)
    assert cfg.qk_norm and cfg.norm_topk_probs and cfg.rope_theta == 1e6
    assert cfg.rmsnorm_eps == 1e-6 and cfg.load_balance_coef == 0.001
    assert cfg.pdtype == cfg.cdtype == torch.bfloat16
    layer = 4 * 2048 * 4096 // 2 + 2 * 2048 * 512 + 2 * 128 + 2 * 2048 + 2048 * 128 \
        + 32 * 3 * 2048 * 768
    assert layer == 170_135_808
    assert num_params(model_spec(cfg)) == 8 * layer + 2 * 2048 * 37984 + 2048 \
        == FILE["parameters"] == 1_516_670_976
    whole = HeldExpertsConfig()  # the defaults: Qwen3-30B-A3B, every expert held
    assert num_params(model_spec(whole)) == FILE["parameters_published"] == 30_532_122_624
    assert num_params(model_spec(model_config(_share(FILE, 3)))) == FILE["parameters"]
    assert model_config(_share(FILE, 3)).first_expert == 96
    spec = {p: (tuple(s.shape), s.dtype) for p, s in flat(model_spec(cfg)).items()}
    assert spec == {p: (shape, getattr(torch, dt))
                    for p, (shape, dt) in moe_weights.shapes(FILE).items()}


@pytest.mark.parametrize("bad", [dict(first_expert=100), dict(num_experts=0),
                                 dict(experts_per_token=129),
                                 dict(load_balance="switch")])
def test_a_share_outside_the_router_is_refused(bad):
    with pytest.raises(ValueError):
        HeldExpertsConfig(**{"num_experts": 32, **bad})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_products_equal_the_plain_loop(dtype):
    """The card's path (sorted pairs, grouped GEMMs, masked rows past the held
    ones) against the CPU's loop, forward and backward, bit for bit."""
    cfg = model_config(_share(TINY, 1))
    gen = torch.Generator().manual_seed(11)
    spec = moe.moe_spec(cfg)
    params = {k: v.to(dtype).requires_grad_(True) if k != "router" else v
              for k, v in tree_materialize(spec, gen, "cpu").items()}
    xf = torch.randn(48, cfg.d_model, generator=gen).to(dtype).requires_grad_(True)
    top_e = torch.topk(torch.softmax(moe.router_logits(params, xf), -1), 2).indices
    local = top_e - cfg.first_expert
    key = torch.where((local >= 0) & (local < 2), local, 2).reshape(-1)
    counts = torch.zeros(3, dtype=torch.int64).scatter_add_(0, key, torch.ones_like(key))
    assert 0 < int(counts[:2].sum()) < key.numel()  # held and absent pairs both
    a = moe.experts_plain(params, xf, key, 2)
    order, ends, valid, rows = moe.sort_pairs(xf, key, counts, 2)
    b = moe.unsort(moe.grouped_swiglu(params, rows, ends, valid), order)
    assert torch.equal(a, b)
    assert bool((b[key == 2] == 0).all())
    leaves = [xf, params["gate"], params["up"], params["down"]]
    ga = torch.autograd.grad(a.float().square().sum(), leaves)
    gb = torch.autograd.grad(b.float().square().sum(), leaves)
    for u, v in zip(ga, gb):
        assert torch.equal(u, v)


def test_counters_reach_the_summary():
    cfg = model_config(_share(TINY, 0))
    params = moe_weights.make(_share(TINY, 0), SEED, "cpu")
    batch = _batch(TINY, SEED + 2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("train.step"), torch.no_grad():
            train_loss(params, batch, cfg, remat=False)
        with tracing.span("train.step"), torch.no_grad():
            train_loss(params, batch, cfg, remat=False)
    s = tracing.summary()
    assert s["moe"]["calls"] == 2 * 2  # two layers, two forwards
    rows = s["moe"]["held_rows"]
    assert isinstance(rows, int) and 0 < rows <= 2 * 2 * 2 * 24 * 2
    assert 0 < s["moe"]["largest_expert_rows"] <= rows
    assert {"moe.route", "moe.dispatch", "moe.experts", "moe.combine"} <= set(s["spans"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q_is_scaled_as_the_other_decoders_scale_it_with_no_copy(dtype):
    """The held config's scale, a Python float already rounded to the compute
    dtype, gives the decoders' q (scaled by a 0-dim tensor copied to the
    device) bit for bit, and opens no ``sync.attn_scale`` span. Only the JAX
    package's configs copy it (``copies_attn_scale``, which also keeps their
    gradient ungraphed on the card)."""
    from repro_torch.models import attention

    held = dataclasses.replace(model_config(_share(TINY, 0)), compute_dtype=dtype,
                               param_dtype=dtype)
    plain = ModelConfig(**{f.name: getattr(held, f.name)
                           for f in dataclasses.fields(ModelConfig)})
    assert plain.copies_attn_scale and not held.copies_attn_scale
    assert not dataclasses.replace(plain, frontend="audio_conv").copies_attn_scale
    params = tree_materialize(attention.attention_spec(held),
                              torch.Generator().manual_seed(SEED), "cpu")
    x = torch.randn(2, 24, 64, generator=torch.Generator().manual_seed(SEED + 1)).to(held.cdtype)
    positions = torch.arange(24)[None].expand(2, 24)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("train.step"):
            got = attention._project_qkv(params, x, held, positions)
    assert not any(n.startswith("sync.") for n in tracing.summary()["spans"])
    want = attention._project_qkv(params, x, plain, positions)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == held.cdtype and torch.equal(a, b)


def test_the_jax_package_s_moe_configs_keep_the_capacity_path(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the held-experts path ran for a ModelConfig")

    monkeypatch.setattr(moe, "moe_held", refuse)
    for arch in ("qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b", "jamba-1.5-large-398b"):
        cfg = get_config(arch)
        assert type(cfg) is ModelConfig
        assert moe.moe_spec(cfg)["router"].shape == (cfg.d_model, cfg.num_experts)
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    spec = model_spec(cfg)
    params = tree_materialize(spec, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.zeros(1, 8, dtype=torch.long),
             "labels": torch.zeros(1, 8, dtype=torch.long)}
    with torch.no_grad():
        assert torch.isfinite(train_loss(params, batch, cfg, remat=False))
    x = torch.randn(1, 8, cfg.d_model)
    _, _, aux = blocks.block_apply(_period0(params["stage0"]["pos0"]), cfg.layout[0], x, cfg,
                                   positions=torch.arange(8)[None])
    assert aux.dim() == 0  # the Switch term, a scalar


def _period0(tree):
    """Period 0 of a stage's stacked leaves."""
    return {k: _period0(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}
