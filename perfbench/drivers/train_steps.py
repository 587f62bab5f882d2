"""Train steps of the port's ``build_train_step``, one after the other.

Set-up builds the program's model configuration from the configuration
file, the ``TrainSetup`` from the traffic file, the weights on the device
from the seed (``inputs/weights.py``) and the optimizer's and exchange's
state, then drives that one state through the first ``check_steps`` steps
by the window's own call, on batches that all differ (``inputs/tokens.py``),
reading after each what the check compares: the loss, the exchange's bytes,
after the first the update's norm per leaf (from AdamW's first moment) and
a host copy of one gradient (the first update itself, or where the step
exchanges the last group's residual, which that group, resting, holds as
its raw gradient), after the first ``steady_steps`` (by default all) the
parameters' change and the residuals per leaf. Later steps' values part
from the float32 reference's as training diverges, so only their bytes are
compared (an exchange's dense sync among them). Those
steps also build every kernel and warm every shape. A unit of the window is
one more step, ended on ``torch.cuda.synchronize()``. Once the window has
closed and the program's state is freed, the plain reference follows the
same steps from the same seeds and the two are compared.

The ``--trace 1`` run records CUDA events around each call of the
program's ``value_and_grad`` and ``exchange_sequential`` (module globals
that the step looks up when it runs) and names them as profiler spans.
"""

from __future__ import annotations

import contextlib
import gc
import statistics

import torch

from perfbench.harness import derive_seed
from perfbench.inputs import weights as weights_lib
from perfbench.inputs.tokens import TokenStream
from perfbench.reference import decoder as reference
from perfbench.reference.numerics import rel, worst_distance


def flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def model_config(config: dict):
    from repro_torch.models.config import LayerSpec, ModelConfig

    return ModelConfig(
        arch_id=config["name"], family="dense", num_layers=config["num_hidden_layers"],
        d_model=config["hidden_size"], num_heads=config["num_attention_heads"],
        num_kv_heads=config["num_key_value_heads"], head_dim=config["head_dim"],
        d_ff=config["intermediate_size"], vocab_size=config["vocab_size"],
        rope_theta=config["rope_theta"], rmsnorm_eps=config["rms_norm_eps"],
        layout=(LayerSpec(kind="attn", mlp="dense"),), param_dtype=config["torch_dtype"],
        compute_dtype=config["torch_dtype"], source=config["source"])


def train_setup(config: dict, traffic: dict):
    from repro_torch.core import exchange as exch_lib
    from repro_torch.launch.steps import TrainSetup
    from repro_torch.optim.optimizers import OptimizerConfig

    o, e = traffic["optimizer"], traffic.get("exchange")
    opt = OptimizerConfig(name="adamw", learning_rate=o["learning_rate"],
                          warmup_steps=o["warmup_steps"], total_steps=o["total_steps"],
                          schedule="cosine", beta1=o["beta1"], beta2=o["beta2"], eps=o["eps"],
                          weight_decay=o["weight_decay"], grad_clip=o["grad_clip"])
    exch = None if e is None else exch_lib.ExchangeConfig(
        num_groups=e["num_groups"], group_size=e["group_size"], sync_period=e["sync_period"],
        rho=e["rho"], gamma=e["gamma"], refine=e["refine"], min_leaf_size=e["min_leaf_size"],
        compressor=e["compressor"])
    return TrainSetup(cfg=model_config(config), optimizer=opt, exchange=exch,
                      remat=traffic["remat"])


class Spans:
    """CUDA-event spans around module globals of the program, while on."""

    def __init__(self):
        self.events: dict[str, list] = {}
        self.patched: list = []

    def wrap(self, module, attr: str, name: str) -> None:
        orig = getattr(module, attr)
        events = self.events.setdefault(name, [])

        def spanned(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function(f"perfbench.{name}"):
                start.record()
                out = orig(*a, **kw)
                end.record()
            events.append((start, end))
            return out

        setattr(module, attr, spanned)
        self.patched.append((module, attr, orig))

    def unwrap(self) -> dict:
        for module, attr, orig in reversed(self.patched):
            setattr(module, attr, orig)
        self.patched.clear()
        torch.cuda.synchronize()
        return {k: [s.elapsed_time(e) for s, e in v] for k, v in self.events.items()}


class TrainWork:
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
        self.stream = TokenStream(config["vocab_size"], traffic["batch"], traffic["seq"],
                                  traffic["token_zipf"], self.token_seed, device)
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

    def _step(self):
        batch = self.stream.next_batch()
        self.params, self.opt_state, self.exch_state, metrics = self.step_fn(
            self.params, self.opt_state, self.exch_state, batch)
        return metrics

    def unit(self) -> None:
        span = (torch.profiler.record_function("perfbench.step") if self.spans is not None
                else contextlib.nullcontext())
        with span:
            self._step()
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def end_to_end(self, window_s, unit_s) -> dict:
        return {"step_s": window_s / len(unit_s)}

    def trace_begin(self) -> None:
        if self.device.type != "cuda":
            return
        from repro_torch.core import exchange as exch_lib
        from repro_torch.launch import steps

        self.spans = Spans()
        self.spans.wrap(steps, "value_and_grad", "value_and_grad")
        if self.setup.exchange is not None:
            self.spans.wrap(exch_lib, "exchange_sequential", "exchange")

    def trace_end(self) -> dict:
        if self.spans is None:
            return {}
        out = self.spans.unwrap()
        self.spans = None
        return out

    def free(self) -> None:
        self.params = self.opt_state = self.exch_state = self.step_fn = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        want = reference.train(self.config, self.traffic, self.weight_seed, self.token_seed,
                               self.device, steps=self.traffic["check_steps"],
                               judges=[self.read.pop("values")])
        numbers = compare(self.read, want, want["grad_dist"][0])
        limits = self.limits["limits"]
        # A number whose readings gave it no limit is not compared (PERF.md).
        return (self.traffic["check_steps"], 0,
                {k: (v, limits[k]) for k, v in numbers.items() if k in limits})


def compare(got: dict, want: dict, grad_dist: list) -> dict:
    """The numbers of the compared steps. ``got`` holds per-leaf dicts (by
    path), ``want`` per-leaf lists in ``want["paths"]`` order, ``grad_dist``
    the distance of ``got``'s gradient from ``want``'s per leaf. Losses are
    compared over the first ``want["steady"]`` steps, bytes over all."""
    paths, steady = want["paths"], want["steady"]
    nan = lambda x: float("inf") if x != x else x  # noqa: E731
    out = {"loss_rel": nan(max(rel(g, w) for g, w
                               in zip(got["loss"][:steady], want["loss"][:steady])))}
    def gap(key, keep=None):
        """The worst leaf's gap between the two norms of ``key``."""
        pairs = [(got[key][p], r) for i, (p, r) in enumerate(zip(paths, want[key]))
                 if keep is None or keep[i]]
        return worst_distance([abs(g - r) for g, r in pairs], [r for _, r in pairs])

    out["grad_norm_gap"] = gap("grad")
    # Leaves whose reference gradient is nought to rounding move by round-off alone.
    med = statistics.median(want["grad"])
    out["change_gap"] = gap("change", [g >= 1e-3 * med for g in want["grad"]])
    # Element by element: the worst leaf's relative L2 distance.
    out["grad_rel"] = worst_distance(grad_dist, want["grad_ref"])
    if want["residual"] is not None:
        out["residual_gap"] = gap("residual")
        out["bytes_rel"] = nan(max(rel(g, w) for g, w in zip(got["bytes"], want["bytes"])))
    return out


def setup(config, traffic, seed, device, limits):
    return TrainWork(config, traffic, seed, device, limits)
