"""Analytic per-device HBM traffic model (the roofline memory term).

PyTorch counterpart of ``repro.launch.analytic``: the same component
inventory, term for term, so that a configuration's modeled bytes equal the
JAX package's on any mesh shape (``launch/mesh.py``'s dicts; ``{"data": 1,
"model": 1}`` is one card). What differs is the bandwidth that turns bytes
into seconds: ``memory_seconds`` defaults to the H100's 3.35 TB/s
(``hlo_analysis.HBM_BW``) where the JAX package takes a TPU v5e's.

Why a model and not a measurement: the bytes a step moves depend on fusion
and on what stays in on-chip memory, which neither the JAX package's
compiled artifact nor PyTorch's counters see; the JAX package's docstring
gives the reasoning, and this module keeps its inventory:

Per train step and device (bf16 weights/activations, f32 moments):
  weights      3 reads of the gathered per-layer weights (fwd, remat, bwd)
               + grad write/read + f32 moment read/write pairs + param rw
  activations  scan checkpoints w+r; per-layer tensor ios (qkv/mlp/ssd/moe);
               flash K/V streaming (window-aware) fwd + 2x bwd;
               chunked-CE logits w+r x fwd+bwd
  exchange     residual read/write + filtered update (when ACPD is on)
Decode: weights read once, KV/SSM cache read (+1 slot write), activations ~0.
Prefill: weights once, activations fwd-only, cache write once.
"""

from __future__ import annotations

from repro_torch.configs import InputShape
from repro_torch.launch.hlo_analysis import HBM_BW
from repro_torch.models.config import LayerSpec, ModelConfig


def _mesh_sizes(mesh_shape: dict) -> tuple[int, int, int]:
    model = mesh_shape.get("model", 1)
    data = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    return model, data, model * data


def _layer_params(cfg: ModelConfig, layer: LayerSpec) -> float:
    D, hd = cfg.d_model, cfg.resolved_head_dim
    p = 2 * D  # norms
    if layer.kind == "attn":
        p += D * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
    else:
        DI, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        p += D * (2 * DI + 2 * N + H) + DI * D + DI + 3 * H
    if layer.mlp == "dense":
        p += 3 * D * cfg.d_ff
    elif layer.mlp == "moe":
        p += D * cfg.num_experts + 3 * cfg.num_experts * D * cfg.d_ff_expert
    return float(p)


def hbm_bytes(cfg: ModelConfig, shape: InputShape, mesh_shape: dict,
              *, exchange: bool = False) -> float:
    """Modeled HBM bytes per device per step."""
    model_n, data_n, dev_n = _mesh_sizes(mesh_shape)
    B, S = shape.global_batch, shape.seq_len
    D, hd = cfg.d_model, cfg.resolved_head_dim
    KV = cfg.num_kv_heads
    bf, f32 = 2, 4

    layers = [(l, periods) for layout, periods in cfg.stages() for l in layout]
    total_params = sum(_layer_params(cfg, l) * p for l, p in layers)
    embed_params = cfg.vocab_size * D * (1 if cfg.frontend == "audio_stub" else 2)
    total_params += embed_params

    if shape.kind == "train":
        b_loc = B // data_n if B % data_n == 0 else B
        t_loc = b_loc * S
        s_loc = S // model_n if S % model_n == 0 else S  # seq-sharded stream

        # Weights: gathered per layer (sharded over model only once gathered
        # from FSDP), 3 passes; grads + moments + params f32 at 1/dev_n.
        w_gathered = total_params / model_n * bf * 3
        w_opt = total_params / dev_n * (f32 * 2 * 2 + f32 * 2 + bf * 2)

        # Activations.
        n_ckpt = sum(periods for _, periods in cfg.stages())
        a_ckpt = n_ckpt * b_loc * s_loc * D * bf * 2
        per_layer_io = 0.0
        for l, p in layers:
            io = t_loc * D * 4  # residual in/out x2 sublayers
            if l.kind == "attn":
                io += t_loc * hd * (cfg.num_heads * 2 + KV * 2)
                Lk = min(l.window or S, S) + 512 if l.window else S
                nq = -(-S // 512)
                io += b_loc * nq * min(Lk, S) * KV * hd * 2  # K+V stream
            else:
                io += t_loc * (2 * cfg.d_inner + 2 * cfg.ssm_state
                               + cfg.ssm_heads) * 2
                io += b_loc * (S / max(cfg.ssm_chunk, 1)) * cfg.ssm_heads \
                    * cfg.ssm_head_dim * cfg.ssm_state * 2  # chunk states
            if l.mlp == "dense":
                io += t_loc * cfg.d_ff / model_n * 3 * 2
            elif l.mlp == "moe":
                cap = cfg.experts_per_token * cfg.moe_capacity_factor
                io += t_loc * cap * D / model_n * 2 * 2  # dispatch+combine
                io += t_loc * cap * cfg.d_ff_expert / model_n * 3 * 2
            per_layer_io += io * p * bf
        act = (a_ckpt + per_layer_io) * 3  # fwd + remat + bwd passes
        ce = t_loc * (cfg.vocab_size / model_n) * f32 * 2 * 3 / 8  # 1/8: chunks live briefly; logits w+r per pass
        exch_b = total_params / dev_n * f32 * 4 if exchange else 0.0
        return w_gathered + w_opt + act + ce + exch_b

    if shape.kind == "prefill":
        b_loc = B // data_n if B % data_n == 0 else B
        t_loc = b_loc * S
        w = total_params / model_n * bf
        act = 0.0
        cache = 0.0
        for l, p in layers:
            io = t_loc * D * 4
            if l.kind == "attn":
                io += t_loc * hd * (cfg.num_heads * 2 + KV * 2)
                Lk = min(l.window or S, S) + 512 if l.window else S
                nq = -(-S // 512)
                io += b_loc * nq * min(Lk, S) * KV * hd * 2
                cache += b_loc * min(l.window or S, S) * KV * hd * bf
            else:
                io += t_loc * (2 * cfg.d_inner + 2 * cfg.ssm_state
                               + cfg.ssm_heads) * 2
                cache += b_loc * cfg.ssm_heads * cfg.ssm_head_dim \
                    * cfg.ssm_state * f32
            if l.mlp == "dense":
                io += t_loc * cfg.d_ff / model_n * 3 * 2
            elif l.mlp == "moe":
                cap = cfg.experts_per_token * cfg.moe_capacity_factor
                io += t_loc * cap * (D * 2 + cfg.d_ff_expert * 3) / model_n * 2
            act += io * p * bf
        ce = b_loc * (cfg.vocab_size / model_n) * f32 * 2
        return w + act + cache / dev_n * 0 + cache + ce

    # decode: weights once + cache traffic dominate.
    b_loc = B // data_n if B % data_n == 0 else B
    w = total_params / (model_n * (data_n if cfg.num_experts and
                                   cfg.d_ff_expert % data_n == 0 else 1)) * bf
    cache = 0.0
    for l, p in layers:
        if l.kind == "attn":
            s_buf = min(l.window or S, S)
            # B=1 long-context caches shard over every mesh axis.
            shard = dev_n if B == 1 else model_n
            cache += p * b_loc * (s_buf / shard if s_buf % shard == 0
                                  else s_buf) * KV * hd * bf * 2
        else:
            cache += p * b_loc * cfg.ssm_heads * cfg.ssm_head_dim \
                * cfg.ssm_state * f32 * 2 / (model_n if cfg.ssm_heads
                                             % model_n == 0 else 1)
    return w + cache


def memory_seconds(cfg: ModelConfig, shape: InputShape, mesh_shape: dict,
                   hbm_bw: float = HBM_BW, *, exchange: bool = False) -> float:
    """``hbm_bytes`` over ``hbm_bw``, by default the H100's 3.35 TB/s."""
    return hbm_bytes(cfg, shape, mesh_shape, exchange=exchange) / hbm_bw
