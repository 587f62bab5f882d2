"""HuBERT's published path in the port (``frontend="audio_conv"``) on the CPU.

The port's ``train_loss`` and every leaf's gradient against the
benchmark's plain reference (``perfbench/reference/hubert.py``) at a tiny
size in float32, with GQA (4 heads over 2 KV heads, the benchmark's CPU cut)
and without; the frames-from-samples rule, the mask embedding, the
positional conv's weight norm and its dropped last frame; every existing
config unchanged by the new frontend; and, where ``transformers`` imports,
the reference's encoder against its ``HubertModel`` with the same weights.
Tolerances: float32 sums taken in other orders (the flash attention's blocks,
the convolutions as unfolded products), rtol 1e-5 on the loss, 1e-4 of a
leaf's scale on the gradients.
"""

from __future__ import annotations

import dataclasses
import math
import os
import pathlib
import statistics
import sys

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.drivers.audio_steps import model_config  # noqa: E402
from perfbench.drivers.train_steps import flat  # noqa: E402
from perfbench.inputs import hubert_weights  # noqa: E402
from perfbench.inputs.audio import AudioStream  # noqa: E402
from perfbench.inputs.weights import nest  # noqa: E402
from perfbench.reference import hubert as reference  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import config as jconfig  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import param as jparam  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models import audio, train_loss  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import param as tparam  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.model import model_spec  # noqa: E402

TINY = {"name": "hubert-tiny", "source": "test", "hidden_size": 64, "intermediate_size": 128,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "num_hidden_layers": 2, "vocab_size": 256, "final_dim": 48, "logit_temp": 0.1,
        "conv_dim": [32] * 7, "conv_kernel": [10, 3, 3, 3, 3, 2, 2],
        "conv_stride": [5, 2, 2, 2, 2, 2, 2], "conv_bias": True, "feat_extract_norm": "layer",
        "do_stable_layer_norm": True, "num_conv_pos_embeddings": 16,
        "num_conv_pos_embedding_groups": 4, "layer_norm_eps": 1e-5, "hidden_act": "gelu",
        "feature_penalty": 10.0, "torch_dtype": "float32"}
TRAFFIC = {"batch": 2, "seq": 40, "label_zipf": 1.1, "mask_prob": 0.8, "mask_length": 10}
CPU = torch.device("cpu")


def _batch(config, seed=3, **traffic):
    return AudioStream(config, dict(TRAFFIC, **traffic), seed, CPU).next_batch()


@pytest.mark.parametrize("kv", [2, 4])
def test_loss_and_every_gradient_match_the_reference(kv):
    config = dict(TINY, num_key_value_heads=kv)
    cfg = model_config(config)
    params = hubert_weights.make(config, 11, CPU)
    batch = _batch(config)
    loss, grads = value_and_grad(lambda p, b: train_loss(p, b, cfg), params, batch)
    live = {p: t.detach().clone().requires_grad_(True) for p, t in flat(params).items()}
    want = reference.loss(live, batch, config)
    want_grads = dict(zip(live, torch.autograd.grad(want, list(live.values()))))
    assert float(loss) == pytest.approx(float(want), rel=1e-5)
    got = flat(grads)
    assert set(got) == set(want_grads)
    med = statistics.median(float(g.norm()) for g in want_grads.values())
    for path, g in want_grads.items():
        scale = max(float(g.norm()), med)
        assert float((got[path] - g).norm()) <= 1e-4 * scale, path


def test_frames_from_samples():
    """S = 1 + (n - 400) // 320: the receptive field 400, the strides' product 320."""
    cfg = model_config(TINY)
    params = hubert_weights.make(TINY, 1, CPU)["frontend"]
    for n in (400, 719, 720, 1039, 1040, 400 + 320 * 39, 400 + 320 * 40 - 1, 179_920):
        feats = audio.conv_features(params, torch.randn(1, n), cfg)
        assert feats.shape == (1, 1 + (n - 400) // 320, 32), n
    assert hubert_weights.samples(TINY, 562) == 179_920
    with pytest.raises(ValueError, match="frames"):
        audio.embed_frames(params, torch.randn(2, hubert_weights.samples(TINY, 39)),
                           torch.zeros(2, 40, dtype=torch.bool), cfg)


def test_mask_embedding_replaces_the_masked_frames_only():
    cfg = model_config(TINY)
    params = hubert_weights.make(TINY, 2, CPU)
    batch = _batch(TINY)
    x, penalty = audio.embed_frames(params["frontend"], batch["waveform"], batch["mask"], cfg)
    none = torch.zeros_like(batch["mask"])
    x0, penalty0 = audio.embed_frames(params["frontend"], batch["waveform"], none, cfg)
    m = batch["mask"]
    assert m.any() and not m.all()
    assert torch.equal(x[m], params["frontend"]["mask_emb"].expand(int(m.sum()), -1))
    assert torch.equal(x[~m], x0[~m]) and torch.equal(penalty, penalty0)
    feats = audio.conv_features(params["frontend"], batch["waveform"], cfg)
    assert float(penalty) == pytest.approx(float(feats.square().mean()), rel=1e-6)


def test_positional_conv_weight_norm_and_dropped_last_frame():
    cfg = model_config(TINY)
    p = hubert_weights.make(TINY, 4, CPU)["frontend"]["pos_conv"]
    w = audio.pos_conv_weight(p)
    taps = torch.linalg.vector_norm(w, dim=(0, 1))
    assert torch.allclose(taps, p["g"].flatten(), rtol=1e-6)
    # torch's own weight norm over dim 2, on a Conv1d padded by K / 2.
    K, G = cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups
    conv = torch.nn.Conv1d(64, 64, K, padding=K // 2, groups=G)
    conv = torch.nn.utils.parametrizations.weight_norm(conv, name="weight", dim=2)
    with torch.no_grad():
        conv.parametrizations.weight.original0.copy_(p["g"])
        conv.parametrizations.weight.original1.copy_(p["v"])
        conv.bias.copy_(p["b"])
    x = torch.randn(2, 40, 64)
    with torch.no_grad():
        full = conv(x.transpose(1, 2))
        got = audio.pos_conv({"pos_conv": p}, x, cfg)
    assert full.shape[-1] == 41  # an even kernel makes one frame too many
    want = x + F.gelu(full[..., :-1]).transpose(1, 2)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    ref = reference.pos_conv({f"frontend.pos_conv.{k}": v for k, v in p.items()}, x, TINY)
    assert torch.allclose(ref, want, rtol=1e-5, atol=1e-5)


def test_positional_conv_in_bfloat16_on_the_cpu():
    """Four channels a group (the benchmark's CPU cut): within bf16 rounding
    of the float32 result (oneDNN's bf16 grouped conv is bypassed)."""
    cfg = dataclasses.replace(model_config(TINY), compute_dtype="bfloat16")
    p = hubert_weights.make(TINY, 5, CPU)["frontend"]
    x = torch.randn(2, 40, 64)
    want = audio.pos_conv(p, x, model_config(TINY)) - x
    got = audio.pos_conv({"pos_conv": {k: v.bfloat16() for k, v in p["pos_conv"].items()}},
                         x.bfloat16(), cfg).float() - x.bfloat16().float()
    assert float((got - want).norm() / want.norm()) < 2e-2


def _jax_spec(name: str) -> dict:
    flat_spec = jax.tree_util.tree_flatten_with_path(
        jmodel.model_spec(jget_config(name)), is_leaf=lambda x: isinstance(x, jparam.ParamSpec))[0]
    return {".".join(k.key for k in path): (tuple(s.shape), np.dtype(s.dtype).name, s.init)
            for path, s in flat_spec}


def _loss(cfg: ModelConfig) -> torch.Tensor:
    g = torch.Generator().manual_seed(0)
    params = tparam.tree_materialize(model_spec(cfg), g, "cpu")
    B, S = 2, 8
    batch = {"labels": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
    if cfg.frontend == "audio_stub":
        batch["frame_embeds"] = torch.randn(B, S, cfg.d_model, generator=g)
    else:
        batch["tokens"] = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = torch.randn(B, cfg.num_patch_tokens, cfg.d_model, generator=g)
    return train_loss(params, batch, cfg, remat=False)


@pytest.mark.parametrize("name", sorted(tconfigs._MODULES))
def test_every_existing_config_is_unchanged(name, monkeypatch):
    """``ModelConfig``'s fields and each config's spec, path for path, are
    the JAX package's, and at its ``reduced()`` size the loss is bit for
    bit the one the decoder's RMSNorm gives called directly: the block
    norm's choice of LayerNorm for HuBERT leaves every other config as it
    was."""
    assert ([f.name for f in dataclasses.fields(ModelConfig)]
            == [f.name for f in dataclasses.fields(jconfig.ModelConfig)])
    cfg = tget_config(name)
    spec = {p: (s.shape, str(s.dtype).removeprefix("torch."), s.init)
            for p, s in tparam.tree_leaves_with_path(model_spec(cfg))}
    assert spec == _jax_spec(name)
    small = cfg.reduced()
    got = _loss(small)
    direct = lambda params, x, c: tlayers.rmsnorm(params, x, c.rmsnorm_eps)  # noqa: E731
    monkeypatch.setattr(tblocks, "norm", direct)
    monkeypatch.setattr(tmodel, "norm", direct)
    assert torch.equal(got, _loss(small))


def test_reference_encoder_matches_transformers_hubert():
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    tr = pytest.importorskip("transformers")
    config = dict(TINY, num_key_value_heads=4)
    hf = tr.HubertModel(tr.HubertConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
        conv_dim=tuple(config["conv_dim"]), conv_kernel=tuple(config["conv_kernel"]),
        conv_stride=tuple(config["conv_stride"]), conv_bias=True, feat_extract_norm="layer",
        do_stable_layer_norm=True, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        hidden_act="gelu", feat_extract_activation="gelu", layer_norm_eps=1e-5,
        hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0,
        layerdrop=0.0, mask_time_prob=0.05)).eval()  # > 0: it holds masked_spec_embed
    P = {p: t.float() for p, t in hubert_weights.leaves(config, 7, CPU)}
    st = "stage0.pos0."
    state = {"masked_spec_embed": P["frontend.mask_emb"],
             "feature_projection.layer_norm.weight": P["frontend.feat_norm.scale"],
             "feature_projection.layer_norm.bias": P["frontend.feat_norm.bias"],
             "feature_projection.projection.weight": P["frontend.proj.w"].T,
             "feature_projection.projection.bias": P["frontend.proj.b"],
             "encoder.pos_conv_embed.conv.bias": P["frontend.pos_conv.b"],
             "encoder.pos_conv_embed.conv.parametrizations.weight.original0":
                 P["frontend.pos_conv.g"],
             "encoder.pos_conv_embed.conv.parametrizations.weight.original1":
                 P["frontend.pos_conv.v"],
             "encoder.layer_norm.weight": P["final_norm.scale"],
             "encoder.layer_norm.bias": P["final_norm.bias"]}
    for i in range(7):
        pre, hf_pre = f"frontend.conv{i}.", f"feature_extractor.conv_layers.{i}."
        state.update({hf_pre + "conv.weight": P[pre + "w"], hf_pre + "conv.bias": P[pre + "b"],
                      hf_pre + "layer_norm.weight": P[pre + "norm.scale"],
                      hf_pre + "layer_norm.bias": P[pre + "norm.bias"]})
    names = {"attention.q_proj": "attn.{}q", "attention.k_proj": "attn.{}k",
             "attention.v_proj": "attn.{}v", "attention.out_proj": "attn.{}o",
             "feed_forward.intermediate_dense": "mlp.{}1", "feed_forward.output_dense": "mlp.{}2"}
    for layer in range(2):
        hf_pre = f"encoder.layers.{layer}."
        for hf_name, ours in names.items():
            state[hf_pre + hf_name + ".weight"] = P[st + ours.format("w")][layer].T
            state[hf_pre + hf_name + ".bias"] = P[st + ours.format("b")][layer]
        for hf_name, ours in (("layer_norm", "norm1"), ("final_layer_norm", "norm2")):
            state[hf_pre + hf_name + ".weight"] = P[st + ours + ".scale"][layer]
            state[hf_pre + hf_name + ".bias"] = P[st + ours + ".bias"][layer]
    assert set(state) == set(hf.state_dict())
    hf.load_state_dict({k: v.contiguous() for k, v in state.items()})
    batch = _batch(config)
    with torch.no_grad():
        want = hf(batch["waveform"], mask_time_indices=batch["mask"]).last_hidden_state
        got, _ = reference.hidden(P, batch["waveform"], batch["mask"], config)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)
    assert math.isfinite(float(got.abs().max()))


@pytest.mark.parametrize("S, block", [(562, 562), (767, 767), (768, 512), (1024, 512)])
def test_backward_blocks_of_the_attention_layer(S, block, monkeypatch):
    """A sequence under 768 rows is one backward block (two of 512 would pad
    HuBERT's 562 frames to 1,024); a longer one keeps the JAX package's 512.
    One block and blocks of 512 give the same gradients."""
    from repro_torch.models import attention as tattention
    from repro_torch.models import flash as tflash

    seen = []
    monkeypatch.setattr(tattention, "flash_attention",
                        lambda q, k, v, spec: seen.append(spec) or q[..., 0, :])
    cfg = ModelConfig(arch_id="t", family="dense", num_layers=1, d_model=16, num_heads=1,
                      num_kv_heads=1, d_ff=32, vocab_size=8, causal=False)
    params = tparam.tree_materialize(tattention.attention_spec(cfg),
                                     torch.Generator().manual_seed(0), "cpu")
    x = torch.zeros(1, S, 16, dtype=cfg.cdtype)
    tattention.attention(params, x, cfg, positions=torch.arange(S), window=None)
    assert (seen[0].block_q, seen[0].block_k) == (block, block)
    if S != 562:
        return
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, S, 1, 1, 16, generator=g) * 0.3, torch.randn(1, S, 1, 16, generator=g),
               torch.randn(1, S, 1, 16, generator=g))
    spec = tflash.FlashSpec(causal=False, window=None, block_q=S, block_k=S, softcap=None)
    out, lse = tflash.ops.flash_attention_fwd(q, k, v, return_lse=True, causal=False, sm_scale=1.0,
                                              window=None, softcap=None)
    dout = torch.randn(out.shape, generator=g)
    one = tflash.flash_backward(q, k, v, out, lse, dout, spec)
    two = tflash.flash_backward(q, k, v, out, lse, dout, spec._replace(block_q=512, block_k=512))
    for a, b in zip(one, two):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-6)
