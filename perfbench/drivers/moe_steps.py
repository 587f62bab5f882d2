"""Train steps of the port's ``build_train_step`` on a MoE decoder that holds
one chip's share of its experts.

``drivers/train_steps.py``'s ``TrainWork`` with the MoE cell's pieces in
place of the dense decoder's: the program's model configuration is a
``HeldExpertsConfig`` built from the configuration file (the experts and
the vocabulary of shard ``expert_shard`` of ``expert_parallel`` and
``vocab_parallel``), the weights come from ``inputs/moe_weights.py``, the
batches from ``inputs/tokens.py`` over the vocabulary slice, and the plain
reference is ``reference/qwen3_moe.py``. What set-up reads in the compared
steps, the window's unit, the spans of the traced run and the comparison
are ``TrainWork``'s (see its module). Set-up also keeps the program's top-k
expert ids of each layer in the first step's monitored forward; the check
counts how many of those (token, choice) pairs the reference routes
elsewhere and prints the count on standard error (no limit: a route flips
where two probabilities lie within rounding).
"""

from __future__ import annotations

import sys

import torch

from perfbench.drivers.train_steps import TrainWork, _norm, compare, flat
from perfbench.harness import derive_seed
from perfbench.inputs import moe_weights as weights_lib
from perfbench.inputs.tokens import TokenStream
from perfbench.reference import qwen3_moe as reference


def model_config(config: dict):
    from repro_torch.models.config import HeldExpertsConfig, LayerSpec

    want = {"hidden_act": "silu", "norm_topk_prob": True, "decoder_sparse_step": 1,
            "mlp_only_layers": [], "attention_bias": False, "tie_word_embeddings": False,
            "use_sliding_window": False}
    for key, value in want.items():
        if config[key] != value:
            raise ValueError(f"the port runs {key}={value!r} only, not {config[key]!r}")
    held, first, vocab = weights_lib.held(config)
    return HeldExpertsConfig(
        arch_id=config["name"], num_layers=config["num_hidden_layers"],
        d_model=config["hidden_size"], num_heads=config["num_attention_heads"],
        num_kv_heads=config["num_key_value_heads"], head_dim=config["head_dim"],
        d_ff=config["moe_intermediate_size"], d_ff_expert=config["moe_intermediate_size"],
        vocab_size=vocab, qk_norm=True, rope_theta=config["rope_theta"],
        layout=(LayerSpec(kind="attn", mlp="moe"),), num_experts=held,
        experts_total=config["num_experts"], first_expert=first,
        experts_per_token=config["num_experts_per_tok"], norm_topk_probs=True,
        param_dtype=config["torch_dtype"], compute_dtype=config["torch_dtype"],
        rmsnorm_eps=config["rms_norm_eps"], load_balance="all_layers_topk",
        load_balance_coef=config["router_aux_loss_coef"], source=config["source"])


def train_setup(config: dict, traffic: dict):
    from repro_torch.core import exchange as exch_lib
    from repro_torch.launch.steps import TrainSetup
    from repro_torch.optim.optimizers import OptimizerConfig

    o, e = traffic["optimizer"], traffic.get("exchange")
    opt = OptimizerConfig(name="adamw", schedule="cosine", **o)
    exch = None if e is None else exch_lib.ExchangeConfig(**e)
    return TrainSetup(cfg=model_config(config), optimizer=opt, exchange=exch,
                      remat=traffic["remat"])


class RouteRecorder:
    """The top-k expert ids of the program's first ``layers`` router calls,
    on the host, while on: wraps ``models/moe.py``'s ``router_logits``,
    which the layer looks up when it runs."""

    def __init__(self, layers: int, k: int):
        from repro_torch.models import moe

        self.module, self.orig = moe, moe.router_logits
        self.layers, self.k, self.routes = layers, k, []

        def recorded(params, x):
            logits = self.orig(params, x)
            if len(self.routes) < self.layers:
                self.routes.append(torch.topk(logits, self.k, dim=-1).indices.cpu())
            return logits

        moe.router_logits = recorded

    def close(self) -> list:
        self.module.router_logits = self.orig
        return self.routes


class MoeWork(TrainWork):
    def __init__(self, config, traffic, seed, device, limits):
        from repro_torch.core import exchange as exch_lib
        from repro_torch.launch.steps import build_train_step
        from repro_torch.models import model_spec
        from repro_torch.optim import optimizers

        self.config, self.traffic, self.device, self.limits = config, traffic, device, limits
        self.weight_seed, self.token_seed = derive_seed(seed, 10), derive_seed(seed, 11)
        self.setup = train_setup(config, traffic)
        spec = {p: (tuple(s.shape), s.dtype) for p, s in flat(model_spec(self.setup.cfg)).items()}
        made = {p: (shape, getattr(torch, dt)) for p, (shape, dt)
                in weights_lib.shapes(config).items()}
        if spec != made:
            raise ValueError(f"the program's parameter tree {spec} is not the benchmark's {made}")
        self.step_fn = build_train_step(self.setup, device)
        self.params = weights_lib.make(config, self.weight_seed, device)
        self.opt_state = optimizers.init_state(self.setup.optimizer, self.params)
        ex = self.setup.exchange
        self.exch_state = None if ex is None else exch_lib.init_state(ex, self.params)
        self.stream = TokenStream(weights_lib.held(config)[2], traffic["batch"],
                                  traffic["seq"], traffic["token_zipf"], self.token_seed, device)
        self.spans = None
        self.read = {"loss": [], "bytes": []}
        steady = traffic.get("steady_steps", traffic["check_steps"])
        for s in range(traffic["check_steps"]):
            if s == 0:
                recorder = RouteRecorder(config["num_hidden_layers"],
                                         config["num_experts_per_tok"])
            try:
                metrics = self._step()
            finally:
                if s == 0:
                    self.read["routes"] = recorder.close()
            self.read["loss"].append(float(metrics["loss"]))
            if ex is not None:
                self.read["bytes"].append(float(metrics["exchange/bytes_step"]))
            if s == 0:
                b1 = self.setup.optimizer.beta1
                mu = flat(self.opt_state.mu)
                self.read["grad"] = {p: _norm(t) / (1 - b1) for p, t in mu.items()}
                if ex is None:
                    self.read["values"] = {p: (t / (1 - b1)).to("cpu", copy=True)
                                          for p, t in mu.items()}
                else:
                    res = flat(self.exch_state.residual)
                    self.read["values"] = {p: t[ex.num_groups - 1].to("cpu", copy=True)
                                          for p, t in res.items()}
            if s == steady - 1:
                self._read_state()

    def _read_state(self) -> None:
        """The parameters' change so far and the residuals, per leaf."""
        params = flat(self.params)
        self.read["change"] = {p: _norm(params[p].float() - p0.float()) for p, p0
                               in weights_lib.leaves(self.config, self.weight_seed, self.device)}
        if self.setup.exchange is not None:
            self.read["residual"] = {p: _norm(t) for p, t in flat(self.exch_state.residual).items()}

    def check(self):
        want = reference.train(self.config, self.traffic, self.weight_seed, self.token_seed,
                               self.device, steps=self.traffic["check_steps"],
                               judges=[self.read.pop("values")],
                               routes=self.read.pop("routes"))
        print(f"moe routes flipped {want['flipped']} of {want['pairs']} (token, choice) pairs "
              f"in the first step's monitored forward", file=sys.stderr)
        numbers = compare(self.read, want, want["grad_dist"][0])
        limits = self.limits["limits"]
        return (self.traffic["check_steps"], 0,
                {k: (v, limits[k]) for k, v in numbers.items() if k in limits})


def setup(config, traffic, seed, device, limits):
    return MoeWork(config, traffic, seed, device, limits)
