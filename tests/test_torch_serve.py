"""Port vs JAX package: the serving entry point.

``generate`` runs on the CPU at the narrow qwen3-shaped config of
``tests/test_torch_models.py`` (G = 5) on the JAX package's weights, and
must give the tokens of JAX's prefill plus greedy decode loop, the loop of
``repro.launch.serve``. Prompts come from ``make_token_dataset``, which must
be byte-identical in both packages. gemma3 (a 5 + 1 window period at
window 16, a prompt past the window so that decode runs on wrapped rings)
and pixtral (a patch prefix) run their ``reduced()`` configs; the JAX loop is
given a ``max_seq`` that holds the patches (ROADMAP C7: its CLI sizes the
caches from the text alone), as the port's ``generate`` does.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import synthetic as jsynthetic
from repro.models import model as jmodel
from repro.models import param as jparam
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.data import synthetic as tsynthetic
from repro_torch.launch import serve

ROOT = pathlib.Path(__file__).resolve().parent.parent
NARROW = dict(d_model=256, num_heads=10, num_kv_heads=2, head_dim=64, d_ff=512,
              vocab_size=512, num_layers=2, param_dtype="float32",
              compute_dtype="float32")


@pytest.mark.parametrize("n,vocab,seed", [(1000, 512, 0), (4 * 2048, 151_936, 0),
                                          (77, 32, 5)])
def test_token_dataset_is_byte_identical(n, vocab, seed):
    a = tsynthetic.make_token_dataset(n, vocab, seed)
    b = jsynthetic.make_token_dataset(n, vocab, seed)
    assert a.dtype == b.dtype == np.int32
    assert a.tobytes() == b.tobytes()


def test_generate_gives_the_jax_tokens():
    jcfg = dataclasses.replace(jget_config("qwen3-14b"), **NARROW)
    tcfg = dataclasses.replace(tget_config("qwen3-14b"), **NARROW)
    jp = jparam.tree_materialize(jmodel.model_spec(jcfg), jax.random.key(1))
    tp = convert.params_from_arrays(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    B, plen, gen = 3, 24, 5
    prompts = tsynthetic.make_token_dataset(B * plen, 512, 0).reshape(B, plen)

    logits, caches, plen = jmodel.prefill(jp, {"tokens": jnp.asarray(prompts)}, jcfg,
                                          max_seq=plen + gen)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want = [tok]
    for i in range(gen - 1):
        logits, caches = jmodel.decode_step(jp, tok, caches, jnp.int32(plen + 1 + i), jcfg)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(tok)
    want = np.stack([np.asarray(t) for t in want], axis=1)

    res = serve.generate(tp, prompts, tcfg, gen, device="cpu")
    assert res.tokens.shape == (B, gen) and res.tokens.dtype == np.int32
    np.testing.assert_array_equal(res.tokens, want)
    assert res.logits_finite
    # On the CPU the plain version runs: no kernel launch is counted.
    assert res.prefill_flash_launches == res.decode_flash_launches == 0


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-780m", "jamba-1.5-large-398b"])
def test_generate_gives_the_jax_tokens_for_moe_ssm_and_hybrid(arch):
    jcfg, tcfg = jget_config(arch).reduced(), tget_config(arch).reduced()
    jp = jparam.tree_materialize(jmodel.model_spec(jcfg), jax.random.key(4))
    tp = convert.params_from_arrays(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    B, plen, gen = 2, 16, 4
    prompts = tsynthetic.make_token_dataset(B * plen, tcfg.vocab_size, 1).reshape(B, plen)
    j_prefill = jax.jit(jmodel.prefill, static_argnames=("cfg", "max_seq"))
    j_decode = jax.jit(jmodel.decode_step, static_argnames=("cfg",))
    logits, caches, plen = j_prefill(jp, {"tokens": jnp.asarray(prompts)}, jcfg,
                                     max_seq=plen + gen)
    plen = int(plen)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want = [tok]
    for i in range(gen - 1):
        logits, caches = j_decode(jp, tok, caches, jnp.int32(plen + 1 + i), jcfg)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(tok)
    res = serve.generate(tp, prompts, tcfg, gen, device="cpu")
    np.testing.assert_array_equal(res.tokens, np.stack([np.asarray(t) for t in want], 1))
    assert res.logits_finite
    assert res.prefill_flash_launches == res.decode_flash_launches == 0


def test_cli_runs_reduced_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced", "--device", "cpu",
         "--batch", "2", "--prompt-len", "16", "--gen", "4"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "generated token ids (batch 0):" in proc.stdout


@pytest.mark.parametrize("arch", ["mamba2-780m", "qwen3-moe-30b-a3b"])
def test_cli_runs_the_moe_and_ssm_archs_reduced_on_the_cpu(arch):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                "--prompt-len", "12", "--gen", "3"])


def test_generate_without_a_device_or_a_card_raises(monkeypatch):
    cfg = tget_config("qwen3-14b").reduced()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.generate({}, np.zeros((1, 4), np.int32), cfg, 2)


def _jax_tokens(jp, jcfg, batch, S, gen):
    """JAX's prefill plus greedy decode loop at max_seq = S + gen."""
    j_prefill = jax.jit(jmodel.prefill, static_argnames=("cfg", "max_seq"))
    j_decode = jax.jit(jmodel.decode_step, static_argnames=("cfg",))
    logits, caches, plen = j_prefill(jp, batch, jcfg, max_seq=S + gen)
    assert int(plen) == S
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want = [tok]
    for i in range(gen - 1):
        logits, caches = j_decode(jp, tok, caches, jnp.int32(S + 1 + i), jcfg)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(tok)
    return np.stack([np.asarray(t) for t in want], 1)


@pytest.mark.parametrize("arch", ["gemma3-27b", "pixtral-12b"])
def test_generate_gives_the_jax_tokens_for_windows_and_patches(arch):
    jcfg, tcfg = jget_config(arch).reduced(), tget_config(arch).reduced()
    jp = jparam.tree_materialize(jmodel.model_spec(jcfg), jax.random.key(6))
    tp = convert.params_from_arrays(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    B, plen, gen = 2, 70, 6  # gemma3 reduced: window 64 < plen
    prompts = tsynthetic.make_token_dataset(B * plen, tcfg.vocab_size, 2).reshape(B, plen)
    batch, patches = {"tokens": jnp.asarray(prompts)}, None
    if tcfg.frontend == "vision_stub":
        p = min(tcfg.num_patch_tokens, plen // 2)
        patches = np.random.default_rng(2).standard_normal((B, p, tcfg.d_model)).astype(
            np.float32)
        batch["patch_embeds"] = jnp.asarray(patches)
    S = plen + (0 if patches is None else patches.shape[1])
    want = _jax_tokens(jp, jcfg, batch, S, gen)
    res = serve.generate(tp, prompts, tcfg, gen, patch_embeds=patches, device="cpu")
    np.testing.assert_array_equal(res.tokens, want)
    assert res.logits_finite
    assert res.prefill_flash_launches == res.decode_flash_launches == 0


def test_generate_refuses_encoders_and_misplaced_patches():
    hubert, pixtral = (tget_config(a).reduced() for a in ("hubert-xlarge", "pixtral-12b"))
    with pytest.raises(ValueError, match="encoder-only"):
        serve.generate({}, np.zeros((1, 4), np.int32), hubert, 2, device="cpu")
    with pytest.raises(ValueError, match="patch_embeds"):
        serve.generate({}, np.zeros((1, 4), np.int32), pixtral, 2, device="cpu")
    with pytest.raises(ValueError, match="patch_embeds"):
        serve.generate({}, np.zeros((1, 4), np.int32), tget_config("qwen3-14b").reduced(), 2,
                       patch_embeds=np.zeros((1, 2, 256), np.float32), device="cpu")
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--reduced", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["gemma3-27b", "pixtral-12b"])
def test_cli_runs_the_window_and_vision_archs_reduced_on_the_cpu(arch, capsys):
    """The CLI's prompt of 80 tokens (pixtral: after min(16, 40) patches, as
    JAX's CLI draws them) with caches that hold them all."""
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                "--prompt-len", "80", "--gen", "3"])
    assert "generated token ids (batch 0):" in capsys.readouterr().out
