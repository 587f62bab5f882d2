"""Train steps of the port's ``build_train_step`` on HuBERT's masked-unit loss.

``drivers/train_steps.py``'s ``TrainWork`` with HuBERT's pieces in place
of the decoder's: the program's model configuration is a
``ConvAudioConfig`` built from the configuration file, the weights come
from ``inputs/hubert_weights.py``, the batches (float32 samples, span
masks, Zipf units) from ``inputs/audio.py`` and the plain reference is
``reference/hubert.py``. What set-up reads in the compared steps, the
window's unit, the spans of the traced run and the comparison are
``TrainWork``'s (see its module). On the card the step takes each group's
gradient as a captured CUDA graph (``launch/steps.py`` ``GradGraphs``).
"""

from __future__ import annotations

import torch

from perfbench.drivers.train_steps import TrainWork, _norm, compare, flat
from perfbench.harness import derive_seed
from perfbench.inputs import hubert_weights as weights_lib
from perfbench.inputs.audio import AudioStream
from perfbench.reference import hubert as reference


def model_config(config: dict):
    from repro_torch.models.config import ConvAudioConfig, LayerSpec

    want = {"feat_extract_norm": "layer", "do_stable_layer_norm": True, "hidden_act": "gelu",
            "conv_bias": True}
    for key, value in want.items():
        if config[key] != value:
            raise ValueError(f"the port runs {key}={value!r} only, not {config[key]!r}")
    return ConvAudioConfig(
        arch_id=config["name"], family="audio", num_layers=config["num_hidden_layers"],
        d_model=config["hidden_size"], num_heads=config["num_attention_heads"],
        num_kv_heads=config["num_key_value_heads"], head_dim=config["head_dim"],
        d_ff=config["intermediate_size"], vocab_size=config["vocab_size"],
        layout=(LayerSpec(kind="attn", mlp="dense"),),
        param_dtype=config["torch_dtype"], compute_dtype=config["torch_dtype"],
        rmsnorm_eps=config["layer_norm_eps"], source=config["source"],
        conv_dim=tuple(config["conv_dim"]), conv_kernel=tuple(config["conv_kernel"]),
        conv_stride=tuple(config["conv_stride"]),
        num_conv_pos_embeddings=config["num_conv_pos_embeddings"],
        num_conv_pos_embedding_groups=config["num_conv_pos_embedding_groups"],
        final_dim=config["final_dim"], logit_temp=config["logit_temp"],
        feature_penalty=config["feature_penalty"])


def train_setup(config: dict, traffic: dict):
    from repro_torch.core import exchange as exch_lib
    from repro_torch.launch.steps import TrainSetup
    from repro_torch.optim.optimizers import OptimizerConfig

    o, e = traffic["optimizer"], traffic.get("exchange")
    opt = OptimizerConfig(name="adamw", schedule="cosine", **o)
    exch = None if e is None else exch_lib.ExchangeConfig(**e)
    return TrainSetup(cfg=model_config(config), optimizer=opt, exchange=exch,
                      remat=traffic["remat"])


class AudioWork(TrainWork):
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
        self.stream = AudioStream(config, traffic, self.token_seed, device)
        self.spans = None
        self.read = {"loss": [], "bytes": []}
        steady = traffic.get("steady_steps", traffic["check_steps"])
        for s in range(traffic["check_steps"]):
            metrics = self._step()
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
                               judges=[self.read.pop("values")])
        numbers = compare(self.read, want, want["grad_dist"][0])
        limits = self.limits["limits"]
        return self.traffic["check_steps"], 0, {k: (v, limits[k]) for k, v in numbers.items()}


def setup(config, traffic, seed, device, limits):
    return AudioWork(config, traffic, seed, device, limits)
