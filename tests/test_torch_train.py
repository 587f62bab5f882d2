"""Port vs JAX package: the training slice on the CPU.

JAX runs on the CPU in float32 at ``codeqwen1.5-7b`` reduced (d_model 256,
4 heads over 4 KV heads, head_dim 64, d_ff 512, vocab 512, 2 layers), as
``tests/test_train_integration.py`` uses it. Weights are the JAX package's
``tree_materialize``, carried across by ``convert.params_from_arrays``, the
optimizer and exchange state by ``convert.opt_state_from_arrays`` and
``exchange_state_from_arrays``; batches come from both packages'
``TokenPipeline`` on one seed. Tolerances: the flash forward and its custom
backward against ``jax.grad`` through JAX's custom-VJP ``flash_attention``
rtol 1e-5 / atol 1e-5 (float32 sums of up to S terms in other orders, and
the port's forward is the plain softmax where JAX's is blocked); the loss
rtol 1e-5, and each gradient leaf within 2e-3 of its largest entry: the
JAX package's init rule (ROADMAP C3) draws the stacked wq and wk with std
1/sqrt(2), so the attention scores reach ~500 (std ~130) and the softmax is
saturated; a float32 ulp of such a score (6e-5) moves exp(s - lse) by that
much relative, and dq, dk and what lies upstream of them (wq, wk, norm1,
the embedding) carry it: each package's float32 gradient lies ~1e-3 of the
leaf's scale from a float64-activation run, JAX's a little further than
the port's. Five train steps: losses rtol 1e-4, the exchange's counters
equal (integers in float32: kept and participating counts, bytes) at
well-conditioned weights (see ``test_five_steps_match_jax_build_train_step``).
"""

import dataclasses
import math
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import InputShape
from repro.configs import get_config as jget_config
from repro.core import exchange as jex
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import TrainSetup as JSetup
from repro.launch.steps import build_train_step as jbuild
from repro.models import flash as jflash
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import param as jparam
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import get_config as tget_config
from repro_torch.core import exchange as tex
from repro_torch.data.pipeline import TokenPipeline as TPipeline
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import flash as tflash
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.param import tree_flatten, tree_materialize
from repro_torch.optim import optimizers as topt

ARCH = "codeqwen1.5-7b"
B, S = 8, 32


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jget_config(ARCH).reduced(), tget_config(ARCH).reduced()
    jp = jparam.tree_materialize(jmodel.model_spec(jcfg), jax.random.key(0))
    jp = jax.tree.map(np.asarray, jp)
    return jcfg, tcfg, jp


def _port_params(model):
    return convert.params_from_arrays(model[2], model[1], device="cpu")


def _batch(cfg, pipe_cls, **kw):
    return pipe_cls(cfg, B, S, seed=3, **kw).next_batch()


# ---------------------------------------------------------------------------
# Configs.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "phi3-medium-14b"])
def test_config_fields_equal_the_jax_config(arch):
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(jcfg.reduced())
    G = tcfg.num_heads // tcfg.num_kv_heads
    assert G == {"codeqwen1.5-7b": 1, "phi3-medium-14b": 4}[arch]


# ---------------------------------------------------------------------------
# The flash forward with lse, and the custom backward.
# ---------------------------------------------------------------------------


def _qkv(seed, Bq, Sq, KV, G, hd):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((Bq, Sq, KV, G, hd)) * hd**-0.5).astype(np.float32)
    k = rng.standard_normal((Bq, Sq, KV, hd)).astype(np.float32)
    v = rng.standard_normal((Bq, Sq, KV, hd)).astype(np.float32)
    cot = rng.standard_normal((Bq, Sq, KV, G, hd)).astype(np.float32)
    return q, k, v, cot


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,G,blocks", [(40, 1, (16, 16)), (40, 4, (16, 32)),
                                         (64, 4, (64, 64)), (33, 1, (32, 8))])
def test_flash_forward_and_backward_match_jax_grad(causal, Sq, G, blocks):
    q, k, v, cot = _qkv(Sq * 7 + G, 2, Sq, 2, G, 32)
    jspec = jflash.FlashSpec(causal, None, blocks[0], blocks[1], None)
    tspec = tflash.FlashSpec(causal, None, blocks[0], blocks[1], None)

    @jax.jit  # one compile for the forward and the custom VJP, not one per op
    def jout_and_grads(q_, k_, v_):
        out, vjp = jax.vjp(lambda *a: jflash.flash_attention(*a, jspec), q_, k_, v_)
        return out, vjp(jnp.asarray(cot))

    jout, jg = jout_and_grads(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    tout = tflash.flash_attention(tq, tk, tv, tspec)
    torch.autograd.backward(tout, _t(cot))
    np.testing.assert_allclose(_np(tout), np.asarray(jout), rtol=1e-5, atol=1e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_lse_matches_jax(causal):
    q, k, v, _ = _qkv(1, 2, 37, 2, 4, 16)
    jout, jlse = jflash._fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jflash.FlashSpec(causal, None, 16, 16, None))
    out, lse = ops.flash_attention_fwd(_t(q), _t(k), _t(v), causal=causal, sm_scale=1.0,
                                       return_lse=True)
    assert lse.shape == (2, 2, 4, 37) and lse.dtype == torch.float32
    np.testing.assert_allclose(_np(lse), np.asarray(jlse), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=1e-5, atol=1e-5)
    plain = ops.flash_attention_fwd(_t(q), _t(k), _t(v), causal=causal, sm_scale=1.0)
    assert torch.equal(plain, out)


def test_no_gradient_means_no_lse(monkeypatch):
    """Prefill (no grad) calls the forward exactly as serving did; a forward
    that records a gradient asks for the log-sum-exp."""
    calls = []
    real = ops.flash_attention_fwd

    def spy(*a, **kw):
        calls.append(kw.get("return_lse", False))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention_fwd", spy)
    q, k, v, _ = _qkv(2, 1, 8, 1, 1, 16)
    spec = tflash.FlashSpec(True, None, 512, 512, None)
    with torch.no_grad():
        tflash.flash_attention(_t(q), _t(k), _t(v), spec)
    tflash.flash_attention(_t(q), _t(k), _t(v), spec)  # no input needs a gradient
    tflash.flash_attention(_t(q).requires_grad_(True), _t(k), _t(v), spec)
    assert calls == [False, False, True]


def test_windows_and_softcaps_raise_naming_the_roadmap():
    """Neither raises any more: a windowed spec and a capped one (cap 1, so
    that these scores of about +-3 bend) run, their forward and gradients
    equal to JAX's custom-VJP flash with the same spec."""
    q, k, v, cot = _qkv(3, 1, 8, 1, 1, 16)
    spec = tflash.FlashSpec(True, 4, 8, 8, None)
    jspec = jflash.FlashSpec(True, 4, 8, 8, None)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = jflash.flash_attention(jq, jk, jv, jspec)
    jgrads = jax.grad(lambda *a: jnp.sum(jflash.flash_attention(*a, jspec) * cot),
                      argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = tflash.flash_attention(tq, tk, tv, spec)
    (out * _t(cot)).sum().backward()
    np.testing.assert_allclose(_np(out), np.asarray(want), rtol=1e-5, atol=1e-5)
    for t, jg in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(_np(t.grad), np.asarray(jg), rtol=1e-5, atol=1e-5)
    capped = (True, None, 8, 8, 1.0)
    want = jflash.flash_attention(jq, jk, jv, jflash.FlashSpec(*capped))
    jgrads = jax.grad(lambda *a: jnp.sum(jflash.flash_attention(*a, jflash.FlashSpec(*capped))
                                         * cot), argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = tflash.flash_attention(tq, tk, tv, tflash.FlashSpec(*capped))
    (out * _t(cot)).sum().backward()
    np.testing.assert_allclose(_np(out), np.asarray(want), rtol=1e-5, atol=1e-5)
    for t, jg in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(_np(t.grad), np.asarray(jg), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Chunked cross entropy and the training loss.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Sc,chunk", [(40, 16), (32, 512), (48, 16)])
def test_chunked_cross_entropy_value_and_gradient(model, Sc, chunk):
    jcfg, tcfg, _ = model
    rng = np.random.default_rng(Sc)
    h = rng.standard_normal((2, Sc, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 512)) * 0.05).astype(np.float32)
    labels = rng.integers(0, 512, (2, Sc)).astype(np.int32)

    def jloss(h_, w_):
        return jlayers.chunked_cross_entropy({"out": w_}, h_, jnp.asarray(labels), jcfg,
                                             chunk=chunk)

    jv, (jgh, jgw) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(jnp.asarray(h),
                                                                         jnp.asarray(w))
    th, tw = _t(h).requires_grad_(True), _t(w).requires_grad_(True)
    tv = tlayers.chunked_cross_entropy({"out": tw}, th, _t(labels).long(), tcfg, chunk=chunk)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(_np(th.grad), np.asarray(jgh), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(tw.grad), np.asarray(jgw), rtol=1e-5, atol=1e-7)
    with torch.no_grad():  # the monitored value (no gradient recorded) is the same sum
        assert float(tlayers.chunked_cross_entropy({"out": tw}, th, _t(labels).long(), tcfg,
                                                   chunk=chunk)) == float(tv)


def test_pipelines_give_the_same_batches(model):
    jb = _batch(model[0], JPipeline)
    tb = _batch(model[1], TPipeline, device="cpu")
    for key in ("tokens", "labels"):
        np.testing.assert_array_equal(_np(tb[key]), np.asarray(jb[key]))
        assert tb[key].dtype == torch.int64


@pytest.mark.parametrize("arch", ["pixtral-12b", "hubert-xlarge"])
def test_frontend_pipelines_give_the_same_batches(arch):
    """The vision batch (patches, the text cut to seq - p) and the audio batch
    (frames and labels, no tokens) equal JAX's, draw for draw, over three
    steps and after a resume, in the compute dtype (float32 and bf16)."""
    for cfg_of in (lambda c: c.reduced(), lambda c: dataclasses.replace(
            c.reduced(), compute_dtype="bfloat16")):
        jcfg, tcfg = cfg_of(jget_config(arch)), cfg_of(tget_config(arch))
        jpipe, tpipe = JPipeline(jcfg, B, S, seed=4), TPipeline(tcfg, B, S, seed=4, device="cpu")
        for _ in range(3):
            jb, tb = jpipe.next_batch(), tpipe.next_batch()
            assert sorted(jb) == sorted(tb)
            for key, want in jb.items():
                want, got = np.asarray(want), tb[key]
                assert tuple(got.shape) == want.shape, key
                if got.dtype == torch.bfloat16:
                    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                                  want.view(np.int16))
                else:
                    np.testing.assert_array_equal(_np(got), want)
        if arch == "pixtral-12b":
            p = min(tcfg.num_patch_tokens, S // 2)
            assert tb["patch_embeds"].shape == (B, p, tcfg.d_model)
            assert tb["tokens"].shape == tb["labels"].shape == (B, S - p)
        else:
            assert "tokens" not in tb and tb["frame_embeds"].shape == (B, S, tcfg.d_model)
        resumed = TPipeline(tcfg, B, S, seed=4, device="cpu")
        resumed.load_state_dict(tpipe.state_dict())
        again, jnext = resumed.next_batch(), jpipe.next_batch()
        for key in jnext:
            assert torch.equal(again[key].float(), torch.from_numpy(
                np.asarray(jnext[key]).astype(np.float32)))


@pytest.mark.parametrize("arch", ["pixtral-12b", "hubert-xlarge"])
def test_cli_trains_the_frontend_archs_on_the_cpu(arch, capsys):
    """``--arch pixtral-12b`` and ``--arch hubert-xlarge`` (reduced) through the
    CLI's ACPD setup: finite losses; a step refuses a batch whose embeddings
    lie elsewhere, whatever its leaves are."""
    ttrain.main(["--arch", arch, "--device", "cpu", "--reduced", "--steps", "2", "--batch",
                 "4", "--seq", "32", "--log-every", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert all(math.isfinite(float(ln.split("loss=")[1].split()[0])) for ln in lines[:2])
    setup = ttrain.setup_from_args(ttrain.parser().parse_args(
        ["--arch", arch, "--reduced", "--steps", "2"]))
    step = tsteps.build_train_step(setup, "cpu")
    batch = TPipeline(setup.cfg, 8, 32, device="cpu").next_batch()
    embeds = "patch_embeds" if arch == "pixtral-12b" else "frame_embeds"
    batch[embeds] = batch[embeds].to("meta")
    with pytest.raises(ValueError, match=f"{embeds} lies on meta"):
        step(None, None, None, batch)


def test_train_loss_and_gradients_match_jax(model):
    jcfg, tcfg, jp = model
    jb = _batch(jcfg, JPipeline)
    tb = _batch(tcfg, TPipeline, device="cpu")
    jv, jg = jax.jit(jax.value_and_grad(lambda p: jmodel.train_loss(p, jb, jcfg, remat=True)))(
        jax.tree.map(jnp.asarray, jp))
    tv, tg = tsteps.value_and_grad(lambda p, b: tmodel.train_loss(p, b, tcfg, remat=True),
                                   _port_params(model), tb)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    t_leaves, j_leaves = tree_flatten(tg)[0], jax.tree.leaves(jg)
    assert len(t_leaves) == len(j_leaves)
    for got, want in zip(t_leaves, j_leaves):
        want = np.asarray(want)
        assert np.abs(_np(got) - want).max() <= 2e-3 * np.abs(want).max()
    _, tg_plain = tsteps.value_and_grad(
        lambda p, b: tmodel.train_loss(p, b, tcfg, remat=False), _port_params(model), tb)
    for a, b_ in zip(tree_flatten(tg_plain)[0], t_leaves):
        # remat recomputes the same values; autograd adds them in another order
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# Train steps against JAX's build_train_step.
# ---------------------------------------------------------------------------


def _exchanges(mode):
    if mode == "plain":
        return None, None
    if mode == "dense":
        return jex.dense_config(4), tex.dense_config(4)
    kw = dict(num_groups=4, group_size=2, sync_period=3, rho=1 / 64, gamma=0.9)
    return jex.ExchangeConfig(**kw), tex.ExchangeConfig(**kw)


def _fan_in_init(jp):
    """JAX's weights with each stacked (layers, fan_in, fan_out) leaf rescaled
    to std 1/sqrt(fan_in), the std the init rule means (ROADMAP C3): the
    attention is then not saturated and both packages' gradients agree to
    ~1e-7."""
    def fix(path, a):
        if "stage" in jax.tree_util.keystr(path) and a.ndim == 3:
            return (a * np.sqrt(a.shape[0] / a.shape[1])).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(fix, jp)


_JSTEPS = {}


@pytest.mark.parametrize("mode,init", [("plain", "fan_in"), ("dense", "fan_in"),
                                       ("acpd", "fan_in"), ("acpd", "jax")])
def test_five_steps_match_jax_build_train_step(model, mode, init):
    """Five steps from the same weights and batches. At the fan-in init every
    exchange counter is equal and the gradient norm within rtol 1e-5. At
    JAX's own init (saturated attention, see the module docstring) the
    gradients of the q/k path agree only to ~1e-3, so a few of the ~50,000
    entries kept at a sparse step sit on the other side of the threshold in
    the other package: the participation and dense-step counters are equal,
    the kept bytes within 0.5 %; the losses are within rtol 1e-4 in both."""
    jcfg, tcfg, jp = model
    if init == "fan_in":
        jp = _fan_in_init(jp)
    jx, tx = _exchanges(mode)
    okw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=5)
    jsetup = JSetup(cfg=jcfg, optimizer=jopt.OptimizerConfig(**okw), exchange=jx,
                    seq_shard=False, zero1=False, fsdp=False)
    mesh = make_host_mesh()
    if mode not in _JSTEPS:  # both inits of one mode share its compiled step
        _JSTEPS[mode] = jbuild(jsetup, mesh, InputShape("t", S, B, "train"))[:2]
    jstep, shardings = _JSTEPS[mode]
    jparams = jax.tree.map(jnp.asarray, jp)
    jopt_state = jopt.init_state(jsetup.optimizer, jparams)
    jx_state = jex.init_state(jx, jparams) if jx is not None else None
    # placed as the step places its outputs, so that step 1 reuses step 0's compile
    jparams, jopt_state, jx_state = jax.device_put((jparams, jopt_state, jx_state),
                                                   shardings[:3])

    tstep = tsteps.build_train_step(
        tsteps.TrainSetup(cfg=tcfg, optimizer=topt.OptimizerConfig(**okw), exchange=tx),
        "cpu")
    tparams = convert.params_from_arrays(jp, tcfg, device="cpu")
    topt_state = convert.opt_state_from_arrays(jax.tree.map(np.asarray, jopt_state), tcfg,
                                               device="cpu")
    tx_state = (convert.exchange_state_from_arrays(jax.tree.map(np.asarray, jx_state), tcfg,
                                                   4, device="cpu")
                if jx is not None else None)
    jpipe, tpipe = JPipeline(jcfg, B, S, seed=5), TPipeline(tcfg, B, S, seed=5, device="cpu")
    with mesh:
        for _ in range(5):
            jparams, jopt_state, jx_state, jm = jstep(jparams, jopt_state, jx_state,
                                                      jpipe.next_batch())
            tparams, topt_state, tx_state, tm = tstep(tparams, topt_state, tx_state,
                                                      tpipe.next_batch())
            assert set(tm) == set(jm)
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
            exact = init == "fan_in" or float(jm["exchange/dense_step"]) == 1.0
            for k in jm:
                if k in ("exchange/participating", "exchange/dense_step") or (
                        k.startswith("exchange/") and exact):
                    assert float(tm[k]) == float(jm[k]), k
                elif k.startswith("exchange/"):
                    np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=5e-3)
            if init == "fan_in":
                np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                           rtol=1e-5)
    assert int(topt_state.step) == 5
    if mode == "acpd":
        assert float(tm["exchange/sent_fraction"]) < 0.05


def test_mesh_options_raise_naming_the_roadmap(model):
    for name in ("seq_shard", "zero1", "fsdp"):
        setup = tsteps.TrainSetup(cfg=model[1], optimizer=topt.OptimizerConfig(),
                                  exchange=None, **{name: True})
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            tsteps.build_train_step(setup, "cpu")


# ---------------------------------------------------------------------------
# Checkpoints.
# ---------------------------------------------------------------------------


def _run(step_fn, state, pipe, n):
    params, opt_state, x_state = state
    losses = []
    for _ in range(n):
        params, opt_state, x_state, m = step_fn(params, opt_state, x_state, pipe.next_batch())
        losses.append(float(m["loss"]))
    return (params, opt_state, x_state), losses


def _leaves(state):
    params, opt_state, x_state = state
    return (tree_flatten(params)[0] + tree_flatten(opt_state.mu)[0]
            + tree_flatten(opt_state.nu)[0] + tree_flatten(x_state.residual)[0]
            + [opt_state.step])


def test_checkpoint_resume_is_bit_for_bit(model, tmp_path):
    tcfg = dataclasses.replace(model[1], param_dtype="bfloat16")
    setup = tsteps.TrainSetup(cfg=tcfg, optimizer=topt.OptimizerConfig(
        learning_rate=1e-3, warmup_steps=2, total_steps=6), exchange=_exchanges("acpd")[1])
    step_fn = tsteps.build_train_step(setup, "cpu")

    def fresh():
        params = _fresh_params(tcfg)
        return (params, topt.init_state(setup.optimizer, params),
                tex.init_state(setup.exchange, params))

    whole, losses = _run(step_fn, fresh(), TPipeline(tcfg, B, S, seed=1, device="cpu"), 6)
    pipe = TPipeline(tcfg, B, S, seed=1, device="cpu")
    half, first = _run(step_fn, fresh(), pipe, 3)
    tree = {"params": half[0], "opt": half[1], "exch": half[2]}
    tckpt.save_checkpoint(tmp_path, 3, tree, extra={"step": 3, "pipeline": pipe.state_dict()})
    back, extra = tckpt.load_checkpoint(tmp_path, {"params": fresh()[0], "opt": fresh()[1],
                                                   "exch": fresh()[2]})
    pipe2 = TPipeline(tcfg, B, S, seed=1, device="cpu")
    pipe2.load_state_dict(extra["pipeline"])
    rest, second = _run(step_fn, (back["params"], back["opt"], back["exch"]), pipe2, 3)
    assert first + second == losses
    for a, b_ in zip(_leaves(rest), _leaves(whole)):
        assert a.dtype == b_.dtype and torch.equal(a, b_)
    assert tree_flatten(back["params"])[0][0].dtype == torch.bfloat16


def _fresh_params(tcfg):
    return tree_materialize(tmodel.model_spec(tcfg), torch.Generator().manual_seed(0), "cpu")


def test_checkpoint_keys_are_the_jax_keys(model, tmp_path):
    """A nested tree with the optimizer's and the exchange's NamedTuples is
    keyed leaf for leaf as the JAX package keys it, and reads back there."""
    from repro.checkpoint import checkpoint as jckpt

    jcfg, tcfg, jp = model
    jparams = jax.tree.map(jnp.asarray, jp)
    jtree = {"params": jparams,
             "opt": jopt.init_state(jopt.OptimizerConfig(name="sgd"), jparams),
             "exch": jex.init_state(jex.dense_config(2), jparams)}
    jckpt.save_checkpoint(tmp_path / "j", 1, jtree)
    params = _port_params(model)
    ttree = {"params": params, "opt": topt.init_state(topt.OptimizerConfig(name="sgd"), params),
             "exch": tex.init_state(tex.dense_config(2), params)}
    tckpt.save_checkpoint(tmp_path / "t", 1, ttree)
    keys = [np.load(tmp_path / d / "ckpt_00000001.npz").files for d in ("j", "t")]
    assert sorted(keys[0]) == sorted(keys[1])
    back, _ = jckpt.load_checkpoint(tmp_path / "t", jtree)
    for a, b_ in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))
    mine, _ = tckpt.load_checkpoint(tmp_path / "j", ttree)
    assert mine["opt"].nu is None and torch.equal(mine["opt"].step, ttree["opt"].step)
    with pytest.raises(ValueError, match="dtype mismatch"):
        tckpt.load_checkpoint(tmp_path / "t", {"params": _fresh_params(
            dataclasses.replace(tcfg, param_dtype="bfloat16"))})


def test_state_converters_refuse_other_trees(model):
    jcfg, tcfg, jp = model
    state = jopt.init_state(jopt.OptimizerConfig(), jax.tree.map(jnp.asarray, jp))
    state = jax.tree.map(np.asarray, state)
    ok = convert.opt_state_from_arrays(state, tcfg, device="cpu")
    assert ok.step.dtype == torch.int32 and ok.nu is not None
    with pytest.raises(ValueError, match="differs from model_spec"):
        convert.opt_state_from_arrays(state._replace(mu={"x": np.zeros(3, np.float32)}),
                                      tcfg, device="cpu")
    with pytest.raises(ValueError, match="want torch.float32"):
        convert.exchange_state_from_arrays(jex.ExchangeState(residual=jp), tcfg, 4,
                                           device="cpu")


# ---------------------------------------------------------------------------
# The CLI.
# ---------------------------------------------------------------------------


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", ARCH, "--device", "cpu", "--reduced", "--steps", "3", "--batch", "4",
            "--seq", "32", "--log-every", "1", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    ttrain.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines[:3]] == ["0", "1", "2"]
    assert all("loss=" in ln and "sent=" in ln for ln in lines[:3])
    assert lines[-1].startswith("done: 3 steps")
    assert all(math.isfinite(float(ln.split("loss=")[1].split()[0])) for ln in lines[:3])
    ttrain.main(argv + ["--resume", "--steps", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "resumed from step 2" and out[-1].startswith("done: 2 steps")
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        ttrain.main(["--production-mesh", "--device", "cpu"])


def test_cli_runs_as_a_module_and_needs_a_card_unless_told(monkeypatch):
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                           "--reduced", "--steps", "3", "--batch", "4", "--seq", "16"],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1].startswith("done: 3 steps")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--reduced", "--steps", "1"])


# ---------------------------------------------------------------------------
# The NaN-weight importance draw (a diverged cell of an importance batch).
# ---------------------------------------------------------------------------


def test_nan_weights_draw_uniformly_without_raising():
    from repro_torch.core.sdca import TorchDraws

    p = torch.tensor([[1.0, 3.0, 0.0, 0.0], [float("nan"), 1.0, 1.0, 1.0],
                      [float("inf"), 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]])
    draws = TorchDraws(0).choice([None] * 4, 4, 4000, p)
    assert draws.dtype == torch.int32 and draws.shape == (4, 4000)
    assert set(draws[0].tolist()) <= {0, 1}
    for row in draws[1:]:
        counts = torch.bincount(row.long(), minlength=4)
        assert counts.min() > 800  # uniform: about 1000 each


def test_nan_importance_batch_same_as_the_jax_service():
    """A NaN-poisoned cell of an ``importance`` batch (its sigma' comes from
    the NaN gamma) runs, diverges and is masked in both packages: the same
    counters and the same event types per tenant."""
    from repro import api as japi
    from repro.core import faults as jfaults
    from repro.serve import CoalescePolicy as JPolicy
    from repro.serve import ExperimentService as JService
    from repro.serve import RecoveryPolicy as JRecovery
    from repro_torch import api
    from repro_torch.core import baselines, faults
    from repro_torch.core.simulate import ClusterModel
    from repro_torch.serve import CoalescePolicy, ExperimentService, RecoveryPolicy

    K = 4
    method = baselines.cocoa_plus_solver(K, H=8, local_solver="importance")
    specs = [(f"t{i}", api.ExperimentSpec(
        name=f"s{i}", problem=api.ProblemSpec("linear_synthetic", {
            "num_workers": K, "n_per_worker": 48, "d": 256, "nnz_per_row": 12, "seed": 0,
            "lam": 1e-3}),
        cluster=ClusterModel(num_workers=K, straggler_sigma=2.0),
        methods=(api.MethodEntry(method, 3),), eval_every=1, seed=i).to_dict())
        for i in range(4)]
    runs = []
    for side in ("torch", "jax"):
        if side == "torch":
            svc = ExperimentService(
                CoalescePolicy(batch="map", shard="none", max_wait_s=0.0, max_batch=4),
                device="cpu", recovery=RecoveryPolicy(backoff_base_s=0.001),
                fault=faults.get_fault("nan_poison")(seed=3, count=1))
            load = api.ExperimentSpec.from_dict
        else:
            svc = JService(JPolicy(batch="map", shard="none", max_wait_s=0.0, max_batch=4),
                           recovery=JRecovery(backoff_base_s=0.001),
                           fault=jfaults.get_fault("nan_poison")(seed=3, count=1))
            load = japi.ExperimentSpec.from_dict
        handles = [svc.submit(t, load(d)) for t, d in specs]
        svc.drain()
        kinds = [[type(e).__name__ for e in h._queue.queue if e is not None] for h in handles]
        counters = {k: v for k, v in svc.stats().items()
                    if isinstance(v, (int, float)) and not isinstance(v, bool)}
        runs.append((kinds, counters))
    assert runs[0] == runs[1]
    assert runs[0][1]["masked_cells"] == 1 and runs[0][1]["failed"] == 1
    assert sum(k == [] for k in runs[0][0]) == 1  # only the poisoned tenant got no events
