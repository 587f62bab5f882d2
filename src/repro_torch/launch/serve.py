"""Batched serving entry point: prefill a prompt batch, then decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
        --batch 4 --prompt-len 2048 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch pixtral-12b --reduced --device cpu

The PyTorch counterpart of ``repro.launch.serve``: weights drawn from
``--seed`` by the port's own init, prompts from the Zipf token stream, then
one prefill (every attention layer through the flash kernel on the card,
a sliding-window layer with its window; MoE and SSD layers in PyTorch) and
``gen - 1`` greedy decode steps against the KV (linear or ring) and SSD
caches. Any registered config that decodes runs (qwen3, qwen3-moe, phi3,
codeqwen, mamba2, jamba, gemma3, pixtral); hubert is encoder-only and
raises. A VLM's prompt gets a prefix of p = min(num_patch_tokens,
prompt_len // 2) patch embeddings, standard normal from ``--seed``, as the
JAX CLI draws them. It runs on the CUDA device unless ``--device cpu`` is
given, and raises when there is no card and no device was named.

The caches hold the S positions prefill returns, patches included, plus
``gen``. The JAX CLI sizes them from the text alone (``prompt_len + gen``),
which is short by p for a VLM (ROADMAP C7); the port does not copy that.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import make_token_dataset
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import decode_step, model_spec, prefill
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import tree_materialize


@dataclasses.dataclass
class Generation:
    """What :func:`generate` returns: tokens, timings and what ran."""

    tokens: np.ndarray  # (B, gen) int32: the prefill's token, then each step's
    prefill_s: float  # wall seconds of the prefill (synchronized)
    decode_s: float  # wall seconds of the gen - 1 decode steps
    prefill_flash_launches: int  # flash-kernel launches during the prefill
    decode_flash_launches: int  # ... during decode
    logits_finite: bool  # every logit of every step was finite


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def generate(params: dict, prompts, cfg: ModelConfig, gen: int, *,
             patch_embeds=None, device: str | torch.device | None = None) -> Generation:
    """Prefill ``prompts (B, plen)`` (a VLM: after ``patch_embeds (B, p,
    d_model)``) and decode greedily to ``gen`` tokens.

    The caches hold S + gen positions, S the stream prefill returns (p +
    plen). Decode step i feeds the last token with ``cache_len = S + 1 + i``,
    as the JAX package's serve loop does. ``params`` must lie on ``device``.
    """
    if not cfg.supports_decode():
        raise ValueError(f"{cfg.arch_id} is encoder-only: no decode")
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    dev = resolve_device(device)
    batch = {"tokens": torch.as_tensor(np.asarray(prompts), dtype=torch.int64, device=dev)}
    if (patch_embeds is not None) != (cfg.frontend == "vision_stub"):
        raise ValueError(f"{cfg.arch_id}: patch_embeds go with the vision frontend only, "
                         f"and it needs them")
    if patch_embeds is not None:
        batch["patch_embeds"] = torch.as_tensor(np.asarray(patch_embeds), device=dev)
    S = sum(batch[k].shape[1] for k in batch)  # the stream prefill runs

    _sync(dev)
    launches0 = ops.LAUNCHES["flash_attention_fwd"]
    t0 = time.perf_counter()
    logits, caches, plen = prefill(params, batch, cfg, max_seq=S + gen)
    finite = torch.isfinite(logits).all()
    tok = torch.argmax(logits, dim=-1)
    _sync(dev)
    t1 = time.perf_counter()
    launches1 = ops.LAUNCHES["flash_attention_fwd"]
    out = [tok]
    for i in range(gen - 1):
        logits, caches = decode_step(params, tok, caches, plen + 1 + i, cfg)
        finite &= torch.isfinite(logits).all()
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    _sync(dev)
    t2 = time.perf_counter()
    return Generation(
        tokens=torch.stack(out, dim=1).to(torch.int32).cpu().numpy(),
        prefill_s=t1 - t0, decode_s=t2 - t1,
        prefill_flash_launches=launches1 - launches0,
        decode_flash_launches=ops.LAUNCHES["flash_attention_fwd"] - launches1,
        logits_finite=bool(finite))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA device")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    params = tree_materialize(model_spec(cfg),
                              torch.Generator(device=dev).manual_seed(args.seed), dev)
    if not cfg.supports_decode():
        raise SystemExit(f"{cfg.arch_id} is encoder-only: no decode")
    stream = make_token_dataset(args.batch * args.prompt_len, cfg.vocab_size, args.seed)
    patches = None
    if cfg.frontend == "vision_stub":
        p = min(cfg.num_patch_tokens, args.prompt_len // 2)
        rng = np.random.default_rng(args.seed)
        patches = rng.standard_normal((args.batch, p, cfg.d_model)).astype(np.float32)
    res = generate(params, stream.reshape(args.batch, args.prompt_len), cfg, args.gen,
                   patch_embeds=patches, device=dev)
    steps = max(args.gen - 1, 1)
    print(f"prefill {args.batch}x{args.prompt_len} in {res.prefill_s:.2f}s; "
          f"decoded {args.gen - 1} steps in {res.decode_s:.2f}s "
          f"({res.decode_s / steps * 1e3:.0f} ms/tok) on {dev}")
    print("generated token ids (batch 0):", res.tokens[0].tolist())


if __name__ == "__main__":
    main()
